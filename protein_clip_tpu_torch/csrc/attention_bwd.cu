// Segment-masked attention backward for ESM-2's head_dim=32 (bf16), Hopper.
//
// Replaces protein_clip_tpu/ops/attention_pallas.py::_bwd_kernel / _bwd_row
// (launched by _attention_bwd_call as the VJP of fused_attention). Same
// function, from q, k, v, dO and the segments alone: recompute P in f32
// (S = q.k^T, f32-min where seg_q != seg_k or seg_k == 0, f32 softmax over
// all T keys); dP = dO.v^T; delta = rowsum(P * dP); dS = P * (dP - delta)
// where allowed, else 0 (the re-mask: a fully padded query row has a uniform
// P of 1/T, which feeds dv but must give no dq or dk); P is cast to bf16 for
// dv and dS to bf16 for dq and dk, as the TPU kernel does; dq = dS.k,
// dk = dS^T.q, dv = P^T.dO, accumulated in f32 and written in bf16.
//
// Bound on an H100 SXM (989 TF/s bf16, 3.35 TB/s): the function needs five
// (T x T x 32) products per (row, head), 5 * 2*B*NH*T^2*32 tensor-core
// FLOPs (S, dP, dq, dk, dv), and must move q, k, v, dO in and dq, dk, dv
// out once (7 * 2*B*T*NH*32 bytes). At B=16, T=512, NH=20 that is
// 26.8 GFLOP (27.1 us) against 73.4 MB (21.9 us): bound by the operations.
//
// Design: the TPU kernel walked the query blocks of a row in order and
// carried dk and dv across them in VMEM. Blocks of a grid run in no order,
// so here each output has one owner and no sums cross blocks (no atomics:
// two runs are bit-equal). Two launches, 4 warps per block, 16 rows per
// warp, 64-row tiles streamed through shared memory, every product on the
// tensor cores (mma.sync.m16n8k16, bf16 in, f32 accumulate), scores only in
// registers:
//   1. one block per (row b, head h, 64 queries): a first sweep over the
//      key tiles keeps an online max m, sum l and sum of e^(s-m) * dP, and
//      writes m, 1/l and delta = that sum / l (f32) for its queries; a
//      second sweep recomputes P and dS and accumulates dq = dS.k.
//      m and l stay apart: in a fully padded row every score is f32-min and
//      exp(s - m) = 1 for each key, where exp(s - (m + log l)) would round
//      to 1 instead of 1/T.
//   2. one block per (row b, head h, 64 keys): loops over the query tiles,
//      recomputes P^T and dS^T from the row statistics, and accumulates dk
//      and dv for its keys in f32 registers; each is written once.
// The recompute costs four products beyond the five the function needs
// (S and dP twice in launch 1, once more in launch 2). Any T runs: rows past
// T are staged as zeros, keys past T weigh nothing, queries past T get
// P = 0. wgmma, TMA and a pipelined tile ring are later work.
//
// Built by protein_clip_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kHeadDim = 32;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlock = kWarps * 16;      // rows (queries or keys) per block and per tile
// Padded strides so a warp's fragment reads hit 32 distinct banks.
constexpr int kStride = kHeadDim + 8;    // row-major tile: [row][dim]
constexpr int kTStride = kBlock + 8;     // transposed tile: [dim][row]
constexpr float kNeg = -FLT_MAX;         // the TPU kernel's mask value, f32 min

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A(16x16, row-major) * B(16x8, col-major), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A fragments (16 rows x 32 dims, two k-steps) of rows p0 (fragment row g)
// and p1 (row g + 8); rows past T are zero.
__device__ __forceinline__ void load_a(uint32_t (&a)[2][4], const __nv_bfloat16* p0,
                                       const __nv_bfloat16* p1, bool ok0, bool ok1,
                                       int tig) {
#pragma unroll
  for (int st = 0; st < 2; ++st) {
    const int c = st * 16 + tig * 2;
    a[st][0] = ok0 ? ld_u32(p0 + c) : 0u;
    a[st][1] = ok1 ? ld_u32(p1 + c) : 0u;
    a[st][2] = ok0 ? ld_u32(p0 + c + 8) : 0u;
    a[st][3] = ok1 ? ld_u32(p1 + c + 8) : 0u;
  }
}

// Stage rows [r0, r0 + 64) of one (row, head) of a (B, T, NH, 32) tensor
// into shared memory: row-major into rm, and transposed into tr unless it
// is null. Rows past T are zero.
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ src, int64_t base,
                                      int64_t tok_stride, int r0, int T,
                                      __nv_bfloat16* rm, __nv_bfloat16* tr, int tid) {
  for (int c = tid; c < kBlock * (kHeadDim / 8); c += kThreads) {
    const int r = c >> 2;
    const int ch = c & 3;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < T) {
      val = *reinterpret_cast<const uint4*>(src + base + static_cast<int64_t>(r0 + r) * tok_stride +
                                            ch * 8);
    }
    *reinterpret_cast<uint4*>(&rm[r * kStride + ch * 8]) = val;
    if (tr != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) tr[(ch * 8 + i) * kTStride + r] = e[i];
    }
  }
}

// s[n] = A . tile^T for this warp's 16 rows against the tile's 64 rows,
// 8 n-tiles of 8; tile is row-major [row][dim].
__device__ __forceinline__ void products(float (&s)[8][4], const uint32_t (&a)[2][4],
                                         const __nv_bfloat16* tile, int g, int tig) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[n][j] = 0.f;
    const __nv_bfloat16* r = &tile[(n * 8 + g) * kStride];
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      mma_16816(s[n], a[st], ld_u32(r + st * 16 + tig * 2), ld_u32(r + st * 16 + 8 + tig * 2));
    }
  }
}

// acc (16 x 32) += bf16(x) (16 x 64, the m16n8 accumulators of products)
// . tile (64 x 32), the tile stored transposed [dim][row].
__device__ __forceinline__ void accumulate(float (&acc)[4][4], const float (&x)[8][4],
                                           const __nv_bfloat16* tt, int g, int tig) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16x2(x[2 * kk][0], x[2 * kk][1]);
    pa[1] = pack_bf16x2(x[2 * kk][2], x[2 * kk][3]);
    pa[2] = pack_bf16x2(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    pa[3] = pack_bf16x2(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const __nv_bfloat16* r = &tt[(n * 8 + g) * kTStride + kk * 16];
      mma_16816(acc[n], pa, ld_u32(r + tig * 2), ld_u32(r + 8 + tig * 2));
    }
  }
}

__device__ __forceinline__ void store_rows(__nv_bfloat16* o, int64_t base, int64_t tok_stride,
                                           int r0, int r1, bool ok0, bool ok1,
                                           const float (&acc)[4][4], int tig) {
  __nv_bfloat16* o0 = o + base + static_cast<int64_t>(r0) * tok_stride;
  __nv_bfloat16* o1 = o + base + static_cast<int64_t>(r1) * tok_stride;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int d = n * 8 + tig * 2;
    if (ok0) *reinterpret_cast<uint32_t*>(o0 + d) = pack_bf16x2(acc[n][0], acc[n][1]);
    if (ok1) *reinterpret_cast<uint32_t*>(o1 + d) = pack_bf16x2(acc[n][2], acc[n][3]);
  }
}

// Launch 1. grid (ceil(T / 64), NH, B), 128 threads. q, k, v, dout, dq:
// (B, T, NH, 32) bf16, contiguous; seg: (B, T) int32; m, inv_l, delta:
// (B, NH, T) f32, written here for launch 2.
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int32_t* __restrict__ seg,
                        const __nv_bfloat16* __restrict__ dout,
                        __nv_bfloat16* __restrict__ dq, float* __restrict__ m_out,
                        float* __restrict__ inv_l_out, float* __restrict__ delta_out,
                        int T, int NH) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBlock * kStride];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlock * kStride];
  __shared__ __align__(16) __nv_bfloat16 kt[kHeadDim * kTStride];
  __shared__ int32_t segk[kBlock];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;    // fragment row group
  const int tig = lane & 3;   // thread in group

  const int64_t tok_stride = static_cast<int64_t>(NH) * kHeadDim;
  const int64_t base = static_cast<int64_t>(blockIdx.z) * T * tok_stride +
                       static_cast<int64_t>(blockIdx.y) * kHeadDim;
  const int32_t* seg_row = seg + static_cast<int64_t>(blockIdx.z) * T;
  const int64_t stat_base = (static_cast<int64_t>(blockIdx.z) * NH + blockIdx.y) * T;

  // This thread's two query rows (fragment rows g and g + 8 of its warp).
  const int r0 = blockIdx.x * kBlock + warp * 16 + g;
  const int r1 = r0 + 8;
  const bool ok0 = r0 < T;
  const bool ok1 = r1 < T;
  const int sq0 = ok0 ? seg_row[r0] : 0;
  const int sq1 = ok1 ? seg_row[r1] : 0;

  uint32_t qa[2][4], da[2][4];
  load_a(qa, q + base + static_cast<int64_t>(r0) * tok_stride,
         q + base + static_cast<int64_t>(r1) * tok_stride, ok0, ok1, tig);
  load_a(da, dout + base + static_cast<int64_t>(r0) * tok_stride,
         dout + base + static_cast<int64_t>(r1) * tok_stride, ok0, ok1, tig);

  float s[8][4], dp[8][4];

  // Sweep 1: online max m, sum l of exp(s - m), and sum of exp(s - m) * dP.
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f;
  float d0 = 0.f, d1 = 0.f;
  for (int k0 = 0; k0 < T; k0 += kBlock) {
    __syncthreads();  // every warp is done with the previous tile
    stage(k, base, tok_stride, k0, T, ks, nullptr, tid);
    stage(v, base, tok_stride, k0, T, vs, nullptr, tid);
    if (tid < kBlock) segk[tid] = (k0 + tid < T) ? seg_row[k0 + tid] : 0;
    __syncthreads();
    products(s, qa, ks, g, tig);
    products(dp, da, vs, g, tig);

    // Mask: f32-min where the segments differ or the key is a pad/gap;
    // -inf past the end of the row, so those keys weigh nothing even in a
    // fully masked row.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = n * 8 + tig * 2 + j;
        const int sk = segk[col];
        const bool in_row = k0 + col < T;
        const float a = (sk == sq0 && sk > 0) ? s[n][j] : kNeg;
        const float b = (sk == sq1 && sk > 0) ? s[n][2 + j] : kNeg;
        s[n][j] = in_row ? a : -INFINITY;
        s[n][2 + j] = in_row ? b : -INFINITY;
        mx0 = fmaxf(mx0, s[n][j]);
        mx1 = fmaxf(mx1, s[n][2 + j]);
      }
    }
    // Each tile holds at least one in-row key, so the new max is finite.
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float c0 = expf(m0 - mn0);  // 0 on the first tile (m = -inf)
    const float c1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f, rd0 = 0.f, rd1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float e0 = expf(s[n][j] - m0);
        const float e1 = expf(s[n][2 + j] - m1);
        rs0 += e0;
        rs1 += e1;
        rd0 += e0 * dp[n][j];
        rd1 += e1 * dp[n][2 + j];
      }
    }
    l0 = l0 * c0 + quad_sum(rs0);
    l1 = l1 * c1 + quad_sum(rs1);
    d0 = d0 * c0 + quad_sum(rd0);
    d1 = d1 * c1 + quad_sum(rd1);
  }
  // l > 0: the row max contributes exp(0) = 1.
  const float il0 = 1.f / l0;
  const float il1 = 1.f / l1;
  const float delta0 = d0 * il0;
  const float delta1 = d1 * il1;
  if (tig == 0) {
    if (ok0) {
      m_out[stat_base + r0] = m0;
      inv_l_out[stat_base + r0] = il0;
      delta_out[stat_base + r0] = delta0;
    }
    if (ok1) {
      m_out[stat_base + r1] = m1;
      inv_l_out[stat_base + r1] = il1;
      delta_out[stat_base + r1] = delta1;
    }
  }

  // Sweep 2: P and dS again, dq += bf16(dS) . k.
  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
  }
  for (int k0 = 0; k0 < T; k0 += kBlock) {
    __syncthreads();
    stage(k, base, tok_stride, k0, T, ks, kt, tid);
    stage(v, base, tok_stride, k0, T, vs, nullptr, tid);
    if (tid < kBlock) segk[tid] = (k0 + tid < T) ? seg_row[k0 + tid] : 0;
    __syncthreads();
    products(s, qa, ks, g, tig);
    products(dp, da, vs, g, tig);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = n * 8 + tig * 2 + j;
        const int sk = segk[col];       // 0 past the end of the row
        const bool in_row = k0 + col < T;
        const bool al0 = sk == sq0 && sk > 0;
        const bool al1 = sk == sq1 && sk > 0;
        const float p0 = expf((in_row ? (al0 ? s[n][j] : kNeg) : -INFINITY) - m0) * il0;
        const float p1 = expf((in_row ? (al1 ? s[n][2 + j] : kNeg) : -INFINITY) - m1) * il1;
        s[n][j] = al0 ? p0 * (dp[n][j] - delta0) : 0.f;
        s[n][2 + j] = al1 ? p1 * (dp[n][2 + j] - delta1) : 0.f;
      }
    }
    accumulate(acc, s, kt, g, tig);
  }
  store_rows(dq, base, tok_stride, r0, r1, ok0, ok1, acc, tig);
}

// Launch 2. grid (ceil(T / 64), NH, B), 128 threads; each warp owns 16 keys.
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const int32_t* __restrict__ seg,
                          const __nv_bfloat16* __restrict__ dout,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                          const float* __restrict__ m_in, const float* __restrict__ inv_l_in,
                          const float* __restrict__ delta_in, int T, int NH) {
  __shared__ __align__(16) __nv_bfloat16 qs[kBlock * kStride];
  __shared__ __align__(16) __nv_bfloat16 dos[kBlock * kStride];
  __shared__ __align__(16) __nv_bfloat16 qt[kHeadDim * kTStride];
  __shared__ __align__(16) __nv_bfloat16 dot[kHeadDim * kTStride];
  __shared__ int32_t segq[kBlock];
  __shared__ float mq[kBlock];
  __shared__ float ilq[kBlock];
  __shared__ float dlq[kBlock];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;

  const int64_t tok_stride = static_cast<int64_t>(NH) * kHeadDim;
  const int64_t base = static_cast<int64_t>(blockIdx.z) * T * tok_stride +
                       static_cast<int64_t>(blockIdx.y) * kHeadDim;
  const int32_t* seg_row = seg + static_cast<int64_t>(blockIdx.z) * T;
  const int64_t stat_base = (static_cast<int64_t>(blockIdx.z) * NH + blockIdx.y) * T;

  // This thread's two key rows.
  const int r0 = blockIdx.x * kBlock + warp * 16 + g;
  const int r1 = r0 + 8;
  const bool ok0 = r0 < T;
  const bool ok1 = r1 < T;
  const int sk0 = ok0 ? seg_row[r0] : 0;
  const int sk1 = ok1 ? seg_row[r1] : 0;

  uint32_t ka[2][4], va[2][4];
  load_a(ka, k + base + static_cast<int64_t>(r0) * tok_stride,
         k + base + static_cast<int64_t>(r1) * tok_stride, ok0, ok1, tig);
  load_a(va, v + base + static_cast<int64_t>(r0) * tok_stride,
         v + base + static_cast<int64_t>(r1) * tok_stride, ok0, ok1, tig);

  float dk_acc[4][4], dv_acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[n][j] = dv_acc[n][j] = 0.f;
  }
  float s[8][4], dp[8][4];  // S^T and dP^T: keys are rows, queries columns

  for (int q0 = 0; q0 < T; q0 += kBlock) {
    __syncthreads();
    stage(q, base, tok_stride, q0, T, qs, qt, tid);
    stage(dout, base, tok_stride, q0, T, dos, dot, tid);
    if (tid < kBlock) {
      const bool in = q0 + tid < T;
      segq[tid] = in ? seg_row[q0 + tid] : 0;
      mq[tid] = in ? m_in[stat_base + q0 + tid] : 0.f;
      ilq[tid] = in ? inv_l_in[stat_base + q0 + tid] : 0.f;  // P = 0 past T
      dlq[tid] = in ? delta_in[stat_base + q0 + tid] : 0.f;
    }
    __syncthreads();
    products(s, ka, qs, g, tig);
    products(dp, va, dos, g, tig);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = n * 8 + tig * 2 + j;
        const int sq = segq[col];
        const float mm = mq[col];
        const float il = ilq[col];
        const float dl = dlq[col];
        const bool al0 = sq == sk0 && sk0 > 0;
        const bool al1 = sq == sk1 && sk1 > 0;
        // P unmasked for dv (a padded query row's uniform 1/T feeds it)
        const float p0 = expf((al0 ? s[n][j] : kNeg) - mm) * il;
        const float p1 = expf((al1 ? s[n][2 + j] : kNeg) - mm) * il;
        s[n][j] = p0;
        s[n][2 + j] = p1;
        dp[n][j] = al0 ? p0 * (dp[n][j] - dl) : 0.f;
        dp[n][2 + j] = al1 ? p1 * (dp[n][2 + j] - dl) : 0.f;
      }
    }
    accumulate(dv_acc, s, dot, g, tig);   // dv += bf16(P)^T . dO
    accumulate(dk_acc, dp, qt, g, tig);   // dk += bf16(dS)^T . q
  }
  store_rows(dk, base, tok_stride, r0, r1, ok0, ok1, dk_acc, tig);
  store_rows(dv, base, tok_stride, r0, r1, ok0, ok1, dv_acc, tig);
}

}  // namespace

// Launches both kernels on `stream` (a cudaStream_t) and returns
// cudaGetLastError(): 0 when both launches were accepted. stats: 3 * B*NH*T
// f32 of scratch (m, 1/l, delta).
extern "C" int pct_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* segments, const void* dout, void* dq, void* dk,
                                 void* dv, void* stats, int B, int T, int NH, void* stream) {
  const dim3 grid((T + kBlock - 1) / kBlock, NH, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n = static_cast<size_t>(B) * NH * T;
  float* st = static_cast<float*>(stats);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* sp = static_cast<const int32_t*>(segments);
  const auto* dp = static_cast<const __nv_bfloat16*>(dout);
  attention_bwd_dq_kernel<<<grid, kThreads, 0, s>>>(
      qp, kp, vp, sp, dp, static_cast<__nv_bfloat16*>(dq), st, st + n, st + 2 * n, T, NH);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkdv_kernel<<<grid, kThreads, 0, s>>>(
      qp, kp, vp, sp, dp, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), st,
      st + n, st + 2 * n, T, NH);
  return static_cast<int>(cudaGetLastError());
}
