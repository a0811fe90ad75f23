// Segment-masked attention forward (K1) for ESM-2's head dims (16, 24, 32, 64,
// 128; bf16), Hopper.
//
// Replaces protein_clip_tpu/ops/attention_pallas.py::_kernel (launched by
// _attention_call). Same function: S = q.k^T in f32; a score is kept where
// seg_q == seg_k and seg_k > 0, otherwise set to f32-min (NOT -inf); f32
// softmax; P cast to bf16; P.V accumulated in f32; output bf16. A query row
// whose keys are all masked (a pad position: its own segment is <= 0)
// softmaxes to the uniform average of v over all T keys, exactly as the TPU
// kernel does (every score f32-min, exp(min - min) = 1 for each key).
// When `lse` is not null (a gradient is wanted), it also writes per
// (row, head, query) the log-sum-exp of the masked scores in base 2,
// log2(sum_k exp(s_k)) = log2(e) * logsumexp: K5 reads it as
// P = 2^(s log2(e) - lse). A pad query's is -inf (f32-min * log2(e)
// rounds there), and K5 takes its closed form instead.
//
// Bound on an H100 SXM (989 TF/s bf16, 3.35 TB/s): 4*B*NH*T^2*dh tensor-
// core FLOPs, q, k, v and o moved once (4*B*T*NH*2*dh bytes), and an exp
// per score on the special-function units (16 ex2 per clock per SM: 132
// SMs at 1.98 GHz take 0.0200 ms for the 83.9 M scores of B=16, T=512,
// NH=20, above that shape's byte bound of 0.0125 ms and FLOP bound of
// 0.0109 ms at dh 32; the exponentials do not grow with dh, the bytes and
// products do). Padded and packed rows need less: products and
// exponentials for the allowed pairs only, q and k of valid tokens only (a
// pad query's output is the column mean of v, which reads all of v: T*dh
// adds per (row, head)) and o written. At chip_smoke.py's padded (16, 512),
// dh 32, where 39% of the pairs are allowed and 56% of the tokens valid,
// that is 32.8 MB (0.0098 ms, the bound) and 0.0078 ms of exponentials;
// chip_smoke.py prints the bounds on its run's segments at each head dim.
//
// Design (attention.cuh has the layout, ring and skipping): one block per
// (row b, head h, 64 queries): a consumer warpgroup keeps its q tile in
// shared memory and one producer warp streams the k and v tiles that the
// query tile meets through a 3-stage cp.async ring. Per key tile:
//   - S = q.k^T: DH/16 wgmma m64n64k16, both operands from shared memory;
//   - the mask from the stage's key segments (-inf: a masked key weighs
//     exp(f32-min - m) = 0 either way for a query with an allowed key), the
//     online max per query (quad shuffles), and P = 2^(s log2(e) -
//     m log2(e)) with one FMA and ex2.approx per score;
//   - O = O * 2^((m_old - m) log2(e)) + bf16(P).V: P stays in registers as
//     wgmma's A operand, V is read MN-major as stored (four m64n{DH}k16).
// The row sum stays per thread until the end; O / l goes out in bf16. A
// pad query (segment <= 0) takes the closed form bf16(1/T) times the
// column sum of v, which a block with pads sums from global memory.
// What limits it now (5.6 times its bound at B=16, T=512 padded, dh 32):
// one warpgroup per block waits for each S before its softmax and for
// each P.V before the next S (no ping-pong or intra-warpgroup pipeline;
// the co-resident blocks of an SM are what overlap one tile's exponentials
// with another's products), and a block has few tiles against its fixed
// cost (segment ranges, the first tiles' latency).
//
// Built by protein_clip_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (plain C interface below).

#include "attention.cuh"

namespace {

using namespace pct_attn;

// grid (ceil(T / 64), NH, B), kThreads threads, smem_bytes<kWidth<HD>>(
// tiles_of(T)) of dynamic shared memory. q, k, v, o: (B, T, NH, HD) bf16,
// contiguous; seg: (B, T) int32; lse: (B, NH, T) f32 or null.
template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int32_t* __restrict__ seg,
                     bf16* __restrict__ o, float* __restrict__ lse, int T, int NH) {
  constexpr int DH = kWidth<HD>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages + 1];
  const Head<HD> hd(seg, T, NH);
  const int q0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31;
  const Ring<DH> ring = setup<DH>(smem_raw, bars, hd.seg_row, T,
                                  [&](uint32_t dst) { load_tile(dst, q, hd, q0, T, lane); });
  const int4 own = ring.ranges[blockIdx.x];
  const int sweep = swept_tiles(T);

  if (threadIdx.x >= kConsumers) {  // the producer warp
    cp_async_arrive(ring.ready);
    int it = 0;
    for (int j = 0; j < sweep; ++j) {
      if (!overlaps(own, ring.ranges[j])) continue;
      const uint32_t st = claim(ring, it);
      load_tile(st, k, hd, j * kTile, T, lane);
      load_tile(st + kTileBytes<DH>, v, hd, j * kTile, T, lane);
      load_vec(st + 2 * kTileBytes<DH>, hd.seg_row, 0, j * kTile, T, lane);
      fill(ring, it++);
    }
    cp_async_wait_all();
    return;
  }

  __shared__ float v_sum[DH], scratch[4 * DH];
  if (own.z) column_sum(v_sum, scratch, v, hd, T, false);  // for the pad queries
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  int row[2], sq[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + warp * 16 + g + 8 * h;
    sq[h] = row[h] < T ? hd.seg_row[row[h]] : -1;  // a pad or past T: no allowed key
  }
  float m[2] = {-INFINITY, -INFINITY};  // running max of the allowed scores
  float l[2] = {0.f, 0.f};              // this thread's part of the row sum
  float acc[DH / 2];
  bool any = false;
  take_resident(ring);

  int it = 0;
  for (int j = 0; j < sweep; ++j) {
    if (!overlaps(own, ring.ranges[j])) continue;
    const uint32_t st = take(ring, it);
    const int32_t* segk = ring.vec(it, 0);
    float p[32];
    wgmma_fence();
    scores<DH>(p, ring.resident, st);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(p);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int sk = segk[acc_col(i, tig)];
      const int h = acc_row(i);
      p[i] = (sk > 0 && sk == sq[h]) ? p[i] : -INFINITY;
      mx[h] = fmaxf(mx[h], p[i]);
    }
    float ml[2], c[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[h], quad_max(mx[h]));
      ml[h] = mn == -INFINITY ? 0.f : mn * kLog2e;
      c[h] = ex2(m[h] * kLog2e - ml[h]);  // 0 while m = -inf
      m[h] = mn;
      l[h] *= c[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = acc_row(i);
      p[i] = ex2(fmaf(p[i], kLog2e, -ml[h]));
      l[h] += p[i];
    }
    if (any) {
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[i] *= c[acc_row(i)];
    }
    accumulate<DH>(acc, p, st + kTileBytes<DH>, !any);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    any = true;
    release(ring, it++);
  }

  const float w_pad = pad_weight(T);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float sum = quad_sum(l[h]);
    const float inv = 1.f / sum;
    if (row[h] >= T) continue;
    const bool pad = sq[h] <= 0;
    bf16* out = o + hd.base + row[h] * hd.tok;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      if (8 * j >= HD) continue;  // HD 24: the tile's last 8 columns
      const int d = 8 * j + 2 * tig;
      float a0 = any ? acc[4 * j + 2 * h] * inv : 0.f;
      float a1 = any ? acc[4 * j + 2 * h + 1] * inv : 0.f;
      if (pad) {
        a0 = w_pad * v_sum[d];
        a1 = w_pad * v_sum[d + 1];
      }
      *reinterpret_cast<uint32_t*>(out + d) = pack_bf16x2(a0, a1);
    }
    if (lse != nullptr && tig == 0) {
      // round(m log2(e)) + log2(l): a query with one allowed key gets K5's
      // 2^(round(s log2(e)) - lse) = 1 exactly, as the softmax gives
      lse[hd.vec + row[h]] =
          pad ? -INFINITY : __fadd_rn(__fmul_rn(m[h], kLog2e), log2f(sum));
    }
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError(): 0
// when the launch was accepted, cudaErrorInvalidValue for a head dim the
// kernel does not take (16, 24, 32, 64 and 128 it takes). lse: null, or
// B*NH*T f32 written.
extern "C" int pct_attention_fwd(const void* q, const void* k, const void* v,
                                 const void* segments, void* out, void* lse, int B, int T,
                                 int NH, int head_dim, void* stream) {
  return by_head_dim(head_dim, [&](auto head) {
    constexpr int HD = decltype(head)::value;
    constexpr int DH = kWidth<HD>;
    static const cudaError_t allowed = allow_smem<DH>(attention_fwd_kernel<HD>);
    if (allowed != cudaSuccess) return static_cast<int>(allowed);
    const dim3 grid(tiles_of(T), NH, B);
    attention_fwd_kernel<HD><<<grid, kThreads, smem_bytes<DH>(tiles_of(T)),
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const int32_t*>(segments), static_cast<bf16*>(out),
        static_cast<float*>(lse), T, NH);
    return static_cast<int>(cudaGetLastError());
  });
}
