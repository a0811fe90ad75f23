// Segment-masked attention forward in f32 (K1-f32) for ESM-2's head dims
// (16, 24, 32, 64, 128), Hopper.
//
// Replaces protein_clip_tpu/ops/attention_pallas.py::_kernel (launched by
// _attention_call) for f32 q, k, v, which the TPU kernel takes as it takes
// bf16 (--esm-dtype float32). Same function as K1 (attention_fwd.cu) with
// no rounding to bf16 anywhere: S = q.k^T in f32; a score is kept where
// seg_q == seg_k and seg_k > 0; f32 softmax; P.V in f32; output f32. A pad
// query (its own segment <= 0, no allowed key) takes the uniform average of
// v over all T keys, f32(1/T) times v's column sum, as the TPU kernel's
// softmax of T equal scores gives. With `lse` (a gradient is wanted) it
// writes K1's statistics, the base-2 log-sum-exp of each query's masked
// scores (-inf at a pad query), which K5-f32 reads.
//
// Bound on an H100 SXM (495 TFLOP/s TF32 on the tensor cores, 3.35 TB/s):
// the products, 4*B*NH*T^2*dh FLOPs, each kept at f32 accuracy as three
// TF32 products (3xTF32, as K2, K3 and K4 run); q, k, v and o moved once
// (16*B*T*NH*dh bytes). At t30_150M's B=16, T=512, NH=20, dh 32 dense that
// is 32.2 GFLOP of TF32 (0.065 ms) against 84 MB (0.025 ms). This FFMA
// design's own ceiling is the products at 67 TFLOP/s f32 on the CUDA cores
// (0.160 ms), 2.5 times the bound. Padded and packed rows need the products
// of their allowed pairs only (chip_smoke.py prints both on its run's
// segments).
//
// Design (attention_f32.cuh has the tiles and products): one block of 256
// threads per (row b, head h, 64 queries), the q tile resident in shared
// memory; for each key tile whose segment range meets the query tile's
// (attention.cuh's exact skipping), the k and v tiles and the key segments
// are loaded, S = q.k^T by FFMA (each thread 4 queries x 4 keys), the mask,
// an online max and P = 2^(round(s log2(e)) - round(m log2(e))) (a multiply
// that is not fused into the subtraction, and ex2.approx, a score) per query
// across its half-warp, P to shared memory, and O = O * 2^(round(m_old
// log2(e)) - round(m log2(e))) + P.V by FFMA (4 queries x dh / 16 columns).
// The row sum stays per thread until the end; O / l goes out. The rounded
// exponents make the largest score's P and every later rescale exactly 1,
// so a query with one allowed key gets l = 1 and O = v to the bit, which
// K5-f32 needs to give its dq and dk exactly 0 (attention_bwd_f32.cu).
// What limits it: one buffer a tile (the block waits for each tile's loads;
// co-resident blocks overlap them), and shared-memory reads of about one
// for every two FFMA in the products.
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

// Dynamic shared memory of a block for rows of n tiles: the q, k and v
// tiles, P, the key segments and the tile ranges (134 KB at DH 128 and the
// longest row).
template <int DW>
constexpr int fwd_smem(int n) {
  return 4 * (3 * kTileFloats<DW> + kPFloats + kTile) + 16 * n;
}

// grid (ceil(T / 64), NH, B), kThreads threads, fwd_smem<kWidth<HD>>(
// tiles_of(T)) bytes of dynamic shared memory. q, k, v, o: (B, T, NH, HD)
// f32, contiguous; seg: (B, T) int32; lse: (B, NH, T) f32 or null.
template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int32_t* __restrict__ seg,
                         float* __restrict__ o, float* __restrict__ lse, int T, int NH) {
  constexpr int DW = kWidth<HD>;
  constexpr int NC = kCols<DW>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kTileFloats<DW>;
  float* vs = ks + kTileFloats<DW>;
  float* ps = vs + kTileFloats<DW>;
  int32_t* segk = reinterpret_cast<int32_t*>(ps + kPFloats);
  int4* ranges = reinterpret_cast<int4*>(segk + kTile);
  __shared__ float v_sum[DW], scratch[kThreads];

  const Head<HD> hd(seg, T, NH);
  const int q0 = blockIdx.x * kTile;
  tile_ranges(ranges, hd.seg_row, T, kThreads);
  load_tile<HD>(qs, q, hd, q0, T);
  __syncthreads();
  const int4 own = ranges[blockIdx.x];
  if (own.z) column_sum<HD>(v_sum, scratch, v, hd, T, false);  // for the pad queries

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  int sq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    sq[i] = r < T ? hd.seg_row[r] : -1;  // a pad or past T: no allowed key
  }
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;  // running max of the allowed scores
    l[i] = 0.f;        // this thread's part of the row sum
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }

  const int sweep = swept_tiles(T);
  for (int j = 0; j < sweep; ++j) {
    if (!overlaps(own, ranges[j])) continue;
    __syncthreads();  // the last tile's k, v and P are read
    load_tile<HD>(ks, k, hd, j * kTile, T);
    load_tile<HD>(vs, v, hd, j * kTile, T);
    load_vec(segk, hd.seg_row, j * kTile, T);
    __syncthreads();
    float s[4][4];
    score_tile<DW>(s, qs, ks, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int sk = segk[tx + 16 * jj];
        s[i][jj] = (sk > 0 && sk == sq[i]) ? s[i][jj] : -INFINITY;
        mx = fmaxf(mx, s[i][jj]);
      }
      const float mn = fmaxf(m[i], half_max(mx));
      const float ml = mn == -INFINITY ? 0.f : __fmul_rn(mn, kLog2e);
      const float c = pct_attn::ex2(__fmul_rn(m[i], kLog2e) - ml);  // 0 while m = -inf
      m[i] = mn;
      l[i] *= c;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= c;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = pct_attn::ex2(__fmul_rn(s[i][jj], kLog2e) - ml);
        l[i] += p;
        ps[(ty + 16 * i) * kPStride + tx + 16 * jj] = p;
      }
    }
    __syncwarp();
    accumulate<DW>(acc, ps, vs, tx, ty);
  }

  const float w_pad = __frcp_rn(static_cast<float>(T));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float sum = half_sum(l[i]);
    const int r = q0 + ty + 16 * i;
    if (r >= T) continue;
    const bool pad = sq[i] <= 0;
    const float inv = pad ? 0.f : 1.f / sum;
    float* out = o + hd.base + r * hd.tok;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = out_col<DW>(n, tx);
      if (col < HD) out[col] = pad ? w_pad * v_sum[col] : acc[i][n] * inv;
    }
    if (lse != nullptr && tx == 0) {
      // round(m log2(e)) + log2(l): a query with one allowed key gets
      // K5-f32's 2^(round(s log2(e)) - lse) = 1 exactly, as the softmax gives
      lse[hd.vec + r] = pad ? -INFINITY : __fadd_rn(__fmul_rn(m[i], kLog2e), log2f(sum));
    }
  }
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
    constexpr int DW = kWidth<HD>;
    static const cudaError_t allowed =
        allow_smem(attention_fwd_f32_kernel<HD>, fwd_smem<DW>(tiles_of(pct_attn::kMaxT)));
    if (allowed != cudaSuccess) return static_cast<int>(allowed);
    const dim3 grid(tiles_of(T), NH, B);
    attention_fwd_f32_kernel<HD><<<grid, kThreads, fwd_smem<DW>(tiles_of(T)),
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int32_t*>(segments),
        static_cast<float*>(out), static_cast<float*>(lse), T, NH);
    return static_cast<int>(cudaGetLastError());
  });
}
