// Segment-masked attention forward for ESM-2's head_dim=32 (bf16), Hopper.
//
// Replaces protein_clip_tpu/ops/attention_pallas.py::_kernel (launched by
// _attention_call). Same function: S = q.k^T in f32; a score is kept where
// seg_q == seg_k and seg_k > 0, otherwise set to f32-min (NOT -inf); f32
// softmax; P cast to bf16; P.V accumulated in f32; output bf16. A query row
// whose keys are all masked (every pad position of a padded batch) softmaxes
// to the uniform average of v over all T keys, exactly as the TPU kernel
// does: every score of that row is f32-min, exp(min - min) = 1 for each key.
//
// Bound on an H100 SXM (989 TF/s bf16, 3.35 TB/s): per launch the function
// does 4*B*NH*T^2*32 tensor-core FLOPs and must move q, k, v and o once
// (4*B*T*NH*64 bytes). At the serving shape B=16, T=512, NH=20 that is
// 10.7 GFLOP (10.9 us) against 41.9 MB (12.5 us): about 256 FLOP per byte,
// just under the card's ridge of ~295, so both limits are near. The f32 exp
// of every score (B*NH*T^2 of them) runs on the special-function units, a
// third limit that sits near the other two at this head width.
//
// Design: the TPU kernel held the whole (T, T) score tile of a row in VMEM;
// a Hopper SM has 227 KB of shared memory, so here the scores never leave
// registers. One block of 4 warps owns (row b, head h, 64 queries); each
// warp keeps its 16 query rows as mma.sync A fragments in registers for the
// whole kernel and streams 64-key tiles of k and v through shared memory
// with an online softmax (running max m and sum l, rescaled per tile), so
// any T runs (the TPU's 128 <= T <= 2048 window was a VMEM limit). q, k, v
// and o are read and written once from HBM; each k/v tile is re-read from
// L2 by the T/64 query blocks of its (row, head). Both products run on the
// tensor cores with bf16 operands and f32 accumulators
// (mma.sync.m16n8k16). The online form normalises after P.V, where the TPU
// kernel normalises P before the bf16 cast: the outputs differ by bf16
// rounding, bounded in chip_smoke.py. wgmma, TMA and a pipelined k/v ring
// are later work.
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
constexpr int kBlockQ = kWarps * 16;   // 16 query rows per warp
constexpr int kBlockK = 64;            // keys per shared-memory tile
// Row strides padded so the B-fragment reads of a warp hit 32 distinct banks.
constexpr int kKStride = kHeadDim + 8;   // k tile: [key][dim]
constexpr int kVtStride = kBlockK + 8;   // v tile, transposed: [dim][key]

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

// grid (ceil(T / 64), NH, B), 128 threads. q, k, v, o: (B, T, NH, 32) bf16,
// contiguous; seg: (B, T) int32.
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int32_t* __restrict__ seg,
                     __nv_bfloat16* __restrict__ o, int T, int NH) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * kKStride];
  __shared__ __align__(16) __nv_bfloat16 vt[kHeadDim * kVtStride];
  __shared__ int32_t segk[kBlockK];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;    // fragment row group
  const int tig = lane & 3;   // thread in group

  const int64_t tok_stride = static_cast<int64_t>(NH) * kHeadDim;
  const int64_t base = static_cast<int64_t>(blockIdx.z) * T * tok_stride +
                       static_cast<int64_t>(blockIdx.y) * kHeadDim;
  const int32_t* seg_row = seg + static_cast<int64_t>(blockIdx.z) * T;

  // This thread's two query rows (fragment rows g and g + 8 of its warp).
  const int r0 = blockIdx.x * kBlockQ + warp * 16 + g;
  const int r1 = r0 + 8;
  const bool ok0 = r0 < T;
  const bool ok1 = r1 < T;
  const int sq0 = ok0 ? seg_row[r0] : 0;
  const int sq1 = ok1 ? seg_row[r1] : 0;

  // q as A fragments for the two k-steps over head_dim (32 = 2 x 16).
  uint32_t qa[2][4];
  {
    const __nv_bfloat16* q0p = q + base + static_cast<int64_t>(r0) * tok_stride;
    const __nv_bfloat16* q1p = q + base + static_cast<int64_t>(r1) * tok_stride;
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const int c = st * 16 + tig * 2;
      qa[st][0] = ok0 ? ld_u32(q0p + c) : 0u;
      qa[st][1] = ok1 ? ld_u32(q1p + c) : 0u;
      qa[st][2] = ok0 ? ld_u32(q0p + c + 8) : 0u;
      qa[st][3] = ok1 ? ld_u32(q1p + c + 8) : 0u;
    }
  }

  const float kNeg = -FLT_MAX;  // the TPU kernel's mask value, jnp.finfo(f32).min
  float m0 = -INFINITY, m1 = -INFINITY;  // running row max
  float l0 = 0.f, l1 = 0.f;              // running row sum of exp
  float acc[4][4];                       // 16 x 32 output, 4 n-tiles of 8 dims
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
  }

  for (int k0 = 0; k0 < T; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int c = tid; c < kBlockK * (kHeadDim / 8); c += kThreads) {
      const int kr = c >> 2;
      const int ch = c & 3;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + kr < T) {
        const int64_t off = base + static_cast<int64_t>(k0 + kr) * tok_stride + ch * 8;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&ks[kr * kKStride + ch * 8]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt[(ch * 8 + i) * kVtStride + kr] = ve[i];
    }
    if (tid < kBlockK) segk[tid] = (k0 + tid < T) ? seg_row[k0 + tid] : 0;
    __syncthreads();

    // S = q . k^T for this warp's 16 rows x 64 keys: 8 n-tiles of 8 keys.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = 0.f;
      const __nv_bfloat16* kr = &ks[(n * 8 + g) * kKStride];
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        mma_16816(s[n], qa[st], ld_u32(kr + st * 16 + tig * 2),
                  ld_u32(kr + st * 16 + 8 + tig * 2));
      }
    }

    // Mask: f32-min where the segments differ or the key is a pad/gap;
    // -inf past the end of the row, so out-of-range keys weigh nothing even
    // in a fully masked row.
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

    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[n][j] = expf(s[n][j] - m0);
        s[n][2 + j] = expf(s[n][2 + j] - m1);
        rs0 += s[n][j];
        rs1 += s[n][2 + j];
      }
    }
    l0 = l0 * c0 + quad_sum(rs0);
    l1 = l1 * c1 + quad_sum(rs1);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }

    // acc += P . V: the S accumulators are the A fragments of P (bf16), four
    // k-steps of 16 keys; V comes from the transposed tile.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const __nv_bfloat16* vr = &vt[(n * 8 + g) * kVtStride + kk * 16];
        mma_16816(acc[n], pa, ld_u32(vr + tig * 2), ld_u32(vr + 8 + tig * 2));
      }
    }
  }

  // l > 0: the row max contributes exp(0) = 1.
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
  __nv_bfloat16* o0 = o + base + static_cast<int64_t>(r0) * tok_stride;
  __nv_bfloat16* o1 = o + base + static_cast<int64_t>(r1) * tok_stride;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int d = n * 8 + tig * 2;
    if (ok0) {
      *reinterpret_cast<uint32_t*>(o0 + d) = pack_bf16x2(acc[n][0] * inv0, acc[n][1] * inv0);
    }
    if (ok1) {
      *reinterpret_cast<uint32_t*>(o1 + d) = pack_bf16x2(acc[n][2] * inv1, acc[n][3] * inv1);
    }
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError():
// 0 when the launch was accepted.
extern "C" int pct_attention_fwd(const void* q, const void* k, const void* v,
                                 const void* segments, void* out, int B, int T,
                                 int NH, void* stream) {
  const dim3 grid((T + kBlockQ - 1) / kBlockQ, NH, B);
  attention_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(segments),
      static_cast<__nv_bfloat16*>(out), T, NH);
  return static_cast<int>(cudaGetLastError());
}
