// Segment-masked attention forward in f32 (K1-f32) for ESM-2's head dims
// (16, 24, 32, 64, 128), Hopper.
//
// Replaces protein_clip_tpu/ops/attention_pallas.py::_kernel (launched by
// _attention_call) for f32 q, k, v, which the TPU kernel takes as it takes
// bf16 (--esm-dtype float32). Same function as K1 (attention_fwd.cu) with
// no rounding to bf16 anywhere: S = q.k^T; a score is kept where seg_q ==
// seg_k and seg_k > 0; f32 softmax; P.V; output f32. A pad query (its own
// segment <= 0, no allowed key) takes the uniform average of v over all T
// keys, f32(1/T) times v's column sum, as the TPU kernel's softmax of T
// equal scores gives. With `lse` (a gradient is wanted) it writes K1's
// statistics, the base-2 log-sum-exp of each query's masked scores (-inf
// at a pad query), which K5-f32 reads.
//
// Bound on an H100 SXM (495 TFLOP/s TF32 on the tensor cores, 3.35 TB/s):
// the products, 4*B*NH*T^2*dh FLOPs, each kept at f32 accuracy as three
// TF32 products; q, k, v and o moved once (16*B*T*NH*dh bytes). At
// t30_150M's B=16, T=512, NH=20, dh 32 dense that is 32.2 GFLOP of TF32
// (0.065 ms) against 84 MB (0.025 ms). Padded and packed rows need the
// products of their allowed pairs only (chip_smoke.py prints both on its
// run's segments).
//
// Design (attention_f32.cuh has the tiles, products and producer): one
// block per (row b, head h, 128 queries), two consumer warpgroups of 64
// queries each (the second idle where the block's second tile lies past
// T), their q tiles resident in shared memory as raw f32; the
// producer warpgroup streams the key tiles whose segment range meets
// either query tile's (attention.cuh's exact skipping), each as k split
// into a natural hi/lo tile and v turned into a transposed hi/lo tile,
// with the key segments, through a ring of up to three stages. Per stage
// and warpgroup:
//   - S = q.k^T, 3xTF32 on wgmma m64n64k8 (m64n32k8 at head dim 128), q
//     split in the consumers' registers;
//   - the mask, an online max and P = 2^(round(s log2(e)) - round(m log2(e)))
//     (a multiply that is not fused into the subtraction, and ex2.approx, a
//     score) per query across its quad;
//   - O = O * 2^(round(m_old log2(e)) - round(m log2(e))) + P.V: P split in
//     registers as wgmma's A (3xTF32, m64n{32,64}k8 into a fresh partial
//     added to O in f32).
// The row sum stays per thread until the end; O / l goes out. The rounded
// exponents make the largest score's P and every later rescale exactly 1,
// so a query with one allowed key gets l = 1; 3xTF32 would give it
// v_hi + v_lo for v, so such a query (the block counts each query's
// allowed keys, and a query always allows itself) takes O = v from global
// memory, to the bit, as the softmax gives. A pad query (segment <= 0)
// takes the closed form f32(1/T) times v's column sum, which the producer
// sums once it has filled the ring's last stage, while the consumers
// finish theirs.
// Two consumer warpgroups a block took 0.158 ms against one's 0.220 at
// (16, 512, NH 20, DH 32) padded on an H100 (the stream of k and v split
// once for 128 queries, one warpgroup's elementwise work beside the
// other's products), and 0.26 against 0.34, 0.25 against 0.33 at head
// dims 64 and 128, though two hold 168 registers a thread with up to 168
// bytes of spills (tools/probe_attention_f32.py).
// What limits it now (6.3 times its bound at that shape): the block's
// fixed work, with one 384-thread block an SM (segment ranges from global
// memory, the first stage's loads, the softmax's bookkeeping, the
// epilogue: 0.079 ms of the 0.158 with no products, loads or stores), the
// products (P.V 0.042, S 0.028: each warpgroup waits for each product
// group before its elementwise work), and the producer's loads, split and
// stores (0.030).
//
// Built by protein_clip_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (plain C interface below).

#include "attention_f32.cuh"

namespace {

using namespace pct_attn_f32;
using pct_attn::overlaps;
using pct_attn::swept_tiles;
using pct_attn::tile_ranges;

// A stage: k as a natural tile, v as a transposed one, the key segments.
template <int HD>
using FwdStage = Stage<HD, true, false, false, true, 1>;
// Consumer warpgroups a block, each over its own 64 queries: two (168
// registers a thread, the most a 384-thread block has) at every T.
constexpr int kWGS = 2;
template <int HD>
using FwdLayout = Layout<FwdStage<HD>, kWGS>;

// grid (ceil(T / (64 kWGS)), NH, B), 128 kWGS + kProducer threads,
// FwdLayout<HD>::bytes(tiles_of(T)) of dynamic shared memory. q, k, v, o:
// (B, T, NH, HD) f32, contiguous; seg: (B, T) int32; lse: (B, NH, T) f32
// or null.
template <int HD>
__global__ void __launch_bounds__(128 * kWGS + kProducer, 1)
attention_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int32_t* __restrict__ seg,
                         float* __restrict__ o, float* __restrict__ lse, int T, int NH) {
  using St = FwdStage<HD>;
  using L = FwdLayout<HD>;
  constexpr int WGS = kWGS;
  constexpr int DW = St::DW;
  constexpr int KS = St::KS;
  constexpr int S = L::kStages;
  constexpr int kConsumers = 128 * WGS;
  constexpr int kThreads = kConsumers + kProducer;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * S + 1];
  __shared__ float v_sum[DW], scratch[4 * DW];

  const Head<HD> hd(seg, T, NH);
  const int tile0 = blockIdx.x * WGS;  // the block's first query tile
  const Ring ring = carve<L, St, WGS>(smem_raw, bars);
  if (threadIdx.x >= kConsumers) {
    for (int w = 0; w < WGS; ++w) {
      load_resident<HD>(ring.resident + w * kTile * DW * 4, q, hd, (tile0 + w) * kTile, T,
                        threadIdx.x - kConsumers);
    }
  }
  tile_ranges(ring.ranges, hd.seg_row, T, kThreads);
  __syncthreads();
  int4 own[WGS];
  owned(own, ring.ranges, tile0, T);
  bool pads = false;  // a pad query in the block: v's column sum wanted
#pragma unroll
  for (int w = 0; w < WGS; ++w) pads |= own[w].z != 0;
  const int sweep = swept_tiles(T);
  const int4* ranges = ring.ranges;

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    const int p = threadIdx.x - kConsumers;
    cp_async_arrive(ring.ready);
    const uint32_t* const vec[3] = {reinterpret_cast<const uint32_t*>(hd.seg_row), nullptr,
                                    nullptr};
    auto visit = [&](int j) {
      bool any = false;
#pragma unroll
      for (int w = 0; w < WGS; ++w) any |= overlaps(own[w], ranges[j]);
      return any;
    };
    produce<HD, St, S>(k, v, vec, hd, T, sweep, visit, ring, p);
    // the pad queries' v_sum, while the consumers finish their last stages
    if (pads) {
      column_sum<HD>(v_sum, scratch, v, hd, T, false, p);
      named_barrier(2, kThreads);
    }
    cp_async_wait_all();
    return;
  }

  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 3;
  const int4 mine = own[wg];
  const uint32_t q_tile = ring.resident + wg * kTile * DW * 4;
  int row[2], sq[2], cnt[2] = {0, 0};
  own_rows(row, (tile0 + wg) * kTile);
#pragma unroll
  for (int h = 0; h < 2; ++h) sq[h] = row[h] < T ? hd.seg_row[row[h]] : -1;  // a pad or past T: no allowed key
  float m[2] = {-INFINITY, -INFINITY};  // running max of the allowed scores
  float l[2] = {0.f, 0.f};              // this thread's part of the row sum
  float acc[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) acc[i] = 0.f;
  mbar_wait(ring.ready, 0);

  int it = 0;
  for (int j = 0; j < sweep; ++j) {
    bool any = false;
#pragma unroll
    for (int w = 0; w < WGS; ++w) any |= overlaps(own[w], ranges[j]);
    if (!any) continue;  // the producer skips it too
    const bool meets = overlaps(mine, ranges[j]);
    for (int u = 0; u < St::kParts; ++u, ++it) {
      const uint32_t st = take<St, S>(ring, it);
      if (meets) {
        const int32_t* segk = stage_vec<St, S, int32_t>(ring, it, 0);
        float p[KS / 2];
        scores<DW, KS>(p, q_tile, st + St::kNatA_);
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < KS / 2; ++i) {
          const int sk = segk[acc_col(i, t)];
          const int h = acc_row(i);
          const bool ok = sk > 0 && sk == sq[h];
          cnt[h] += ok;
          p[i] = ok ? p[i] : -INFINITY;
          mx[h] = fmaxf(mx[h], p[i]);
        }
        float ml[2], c[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float mn = fmaxf(m[h], quad_max(mx[h]));
          ml[h] = mn == -INFINITY ? 0.f : __fmul_rn(mn, kLog2e);
          c[h] = ex2(__fmul_rn(m[h], kLog2e) - ml[h]);  // 0 while m = -inf
          m[h] = mn;
          l[h] *= c[h];
        }
#pragma unroll
        for (int i = 0; i < KS / 2; ++i) {
          const int h = acc_row(i);
          p[i] = ex2(__fmul_rn(p[i], kLog2e) - ml[h]);
          l[h] += p[i];
        }
#pragma unroll
        for (int i = 0; i < DW / 2; ++i) acc[i] *= c[acc_row(i)];
        accumulate<DW, KS>(acc, p, st + St::kTransB_);  // O += P . V
      }
      release<S>(ring, it);
    }
  }

  if (pads) named_barrier(2, kThreads);  // v_sum is in
  const float w_pad = __frcp_rn(static_cast<float>(T));
  float inv[2];
  bool pad[2], one[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float sum = quad_sum(l[h]);
    pad[h] = sq[h] <= 0;
    one[h] = quad_sum(static_cast<float>(cnt[h])) == 1.f;  // the query itself alone
    inv[h] = pad[h] ? 0.f : 1.f / sum;
    if (lse != nullptr && t == 0 && row[h] < T) {
      // round(m log2(e)) + log2(l): a query with one allowed key gets
      // K5-f32's 2^(round(s log2(e)) - lse) = 1 exactly, as the softmax gives
      lse[hd.vec + row[h]] = pad[h] ? -INFINITY : __fadd_rn(__fmul_rn(m[h], kLog2e), log2f(sum));
    }
  }
  store_rows<HD>(o, hd, row, T, [&](int h, int col, int i) {
    if (pad[h]) return make_float2(w_pad * v_sum[col], w_pad * v_sum[col + 1]);
    if (one[h]) return *reinterpret_cast<const float2*>(v + hd.base + row[h] * hd.tok + col);
    return make_float2(acc[i] * inv[h], acc[i + 1] * inv[h]);
  });
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError(): 0
// when the launch was accepted, cudaErrorInvalidValue for a head dim the
// kernel does not take (16, 24, 32, 64 and 128 it takes). lse: null, or
// B*NH*T f32 written.
extern "C" int pct_attention_fwd_f32(const void* q, const void* k, const void* v,
                                     const void* segments, void* out, void* lse, int B, int T,
                                     int NH, int head_dim, void* stream) {
  return pct_attn::by_head_dim(head_dim, [&](auto head) {
    constexpr int HD = decltype(head)::value;
    using L = FwdLayout<HD>;
    static const cudaError_t allowed =
        allow_smem(attention_fwd_f32_kernel<HD>, L::bytes(tiles_of(kMaxT)));
    if (allowed != cudaSuccess) return static_cast<int>(allowed);
    const dim3 grid((tiles_of(T) + kWGS - 1) / kWGS, NH, B);
    attention_fwd_f32_kernel<HD><<<grid, 128 * kWGS + kProducer, L::bytes(tiles_of(T)),
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int32_t*>(segments),
        static_cast<float*>(out), static_cast<float*>(lse), T, NH);
    return static_cast<int>(cudaGetLastError());
  });
}
