// What the f32 attention kernels, K1-f32 (attention_fwd_f32.cu) and K5-f32
// (attention_bwd_f32.cu), share on Hopper (sm_90a): tiles of f32 rows in
// shared memory and the two products on the CUDA cores (FFMA), exact f32
// as the TPU package's f32 path computes them on the CPU. The bf16 kernels
// run wgmma; these do not: Hopper's TF32 wgmma reads its B operand only
// K-major, where P.V and the backward's products read B along its rows,
// and TF32 alone is not f32-exact (ROADMAP: "K1/K5 f32 on TF32 wgmma").
// From attention.cuh they take the segment logic as it is: per-tile
// segment ranges (tile_ranges), the skip predicate (overlaps), the swept
// loop's length (swept_tiles), the head's offsets (Head) and the tile
// width of head dim 24 (kWidth: 32, the last 8 columns zero-filled here).
//
// Block: 256 threads, a 16 x 16 grid, over 64 rows (queries, or keys in
// K5's dk/dv launch). Thread (tx, ty) owns rows ty + 16 i (i < 4), so the
// 16 threads of a half-warp own the same rows:
//   - score_tile: S = X . Y^T over the tile width, the thread's 4 x 4
//     scores at columns tx + 16 j, with float4 reads of both rows (a row
//     stride of DW + 4 floats keeps the 16 rows of Y on distinct banks);
//   - accumulate: acc (64 x DW) += P (64 x 64, shared) . Z (64 x DW), the
//     thread's 4 rows by DW / 16 columns, VW-wide reads of Z's rows
//     (columns tx VW + 16 VW jv + e) and float4 reads of P's rows.
// A half-warp writes its rows of P and reads them back, so only __syncwarp
// stands between the two; the tiles are swapped between __syncthreads.

#pragma once

#include "attention.cuh"

namespace pct_attn_f32 {

using pct_attn::Head;
using pct_attn::kLog2e;
using pct_attn::kTile;
using pct_attn::tiles_of;

// The tile width of head dim HD (attention.cuh's).
template <int HD>
constexpr int kWidth = pct_attn::kWidth<HD>;

constexpr int kThreads = 256;
constexpr int kPStride = kTile + 4;        // a row of P: 64 floats and 4 of padding
constexpr int kPFloats = kTile * kPStride;

// A tile of DW-wide f32 rows: the row stride and the floats of a tile.
template <int DW>
constexpr int kStride = DW + 4;
template <int DW>
constexpr int kTileFloats = kTile * kStride<DW>;

// The thread's output columns: NC = DW / 16, read VW at a time, NV reads.
template <int DW>
constexpr int kCols = DW / 16;
template <int DW>
constexpr int kVec = kCols<DW> < 4 ? kCols<DW> : 4;

template <int DW>
__device__ __forceinline__ int out_col(int n, int tx) {
  constexpr int VW = kVec<DW>;
  return tx * VW + 16 * VW * (n / VW) + n % VW;
}

__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int off = 1; off < 16; off *= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int off = 1; off < 16; off *= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float part(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The whole block: rows [t0, t0 + 64) of a (B, T, NH, HD) f32 tensor's head
// into a DW-wide tile, zeros past T and past HD.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          const Head<HD>& hd, int t0, int T) {
  constexpr int DW = kWidth<HD>;
  constexpr int kChunks = DW / 4;
  for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int ch = c % kChunks;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < T && 4 * ch < HD) {
      x = *reinterpret_cast<const float4*>(src + hd.base + (t0 + r) * hd.tok + 4 * ch);
    }
    *reinterpret_cast<float4*>(dst + r * kStride<DW> + 4 * ch) = x;
  }
}

// The whole block: entries [t0, t0 + 64) of a per-token row of 32-bit
// values (segments, or one (b, h) of a (B, NH, T) vector), zeros past T.
template <class V>
__device__ __forceinline__ void load_vec(V* dst, const V* __restrict__ src, int t0, int T) {
  if (threadIdx.x < kTile) {
    const int t = t0 + threadIdx.x;
    dst[threadIdx.x] = t < T ? src[t] : V(0);
  }
}

// s[i][j] = X[ty + 16 i] . Y[tx + 16 j], each a DW-wide row of a tile.
template <int DW>
__device__ __forceinline__ void score_tile(float (&s)[4][4], const float* X, const float* Y,
                                           int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  }
#pragma unroll 2
  for (int d = 0; d < DW; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = *reinterpret_cast<const float4*>(X + (ty + 16 * i) * kStride<DW> + d);
      y[i] = *reinterpret_cast<const float4*>(Y + (tx + 16 * i) * kStride<DW> + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(x[i].x, y[j].x, s[i][j]);
        s[i][j] = fmaf(x[i].y, y[j].y, s[i][j]);
        s[i][j] = fmaf(x[i].z, y[j].z, s[i][j]);
        s[i][j] = fmaf(x[i].w, y[j].w, s[i][j]);
      }
    }
  }
}

// acc[i][n] += sum over c < 64 of P[ty + 16 i][c] Z[c][out_col(n)].
template <int DW>
__device__ __forceinline__ void accumulate(float (&acc)[4][kCols<DW>], const float* P,
                                           const float* Z, int tx, int ty) {
  constexpr int NC = kCols<DW>;
  constexpr int VW = kVec<DW>;
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * kPStride + c);
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float* row = Z + (c + cc) * kStride<DW>;
      float z[NC];
#pragma unroll
      for (int jv = 0; jv < NC / VW; ++jv) {
        const float* at = row + tx * VW + 16 * VW * jv;
        if constexpr (VW == 4) {
          const float4 w = *reinterpret_cast<const float4*>(at);
          z[4 * jv] = w.x;
          z[4 * jv + 1] = w.y;
          z[4 * jv + 2] = w.z;
          z[4 * jv + 3] = w.w;
        } else if constexpr (VW == 2) {
          const float2 w = *reinterpret_cast<const float2*>(at);
          z[2 * jv] = w.x;
          z[2 * jv + 1] = w.y;
        } else {
          z[jv] = *at;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pi = part(p[i], cc);
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(pi, z[n], acc[i][n]);
      }
    }
  }
}

// The whole block: out[d] (d < DW) = the f32 sum over the rows t < T of a
// (B, T, NH, HD) f32 tensor's head, every row or (pads_only) those whose
// segment is <= 0: DW threads a row (columns past HD sum 0), kThreads / DW
// rows at a time, then the row groups in order. scratch: kThreads floats.
// Visible to the whole block on return.
template <int HD>
__device__ __forceinline__ void column_sum(float* out, float* scratch,
                                           const float* __restrict__ src, const Head<HD>& hd,
                                           int T, bool pads_only) {
  constexpr int DW = kWidth<HD>;
  constexpr int kGroups = kThreads / DW;
  const int d = threadIdx.x % DW;
  float acc = 0.f;
  if (d < HD) {
    for (int t = threadIdx.x / DW; t < T; t += kGroups) {
      if (pads_only && hd.seg_row[t] > 0) continue;
      acc += src[hd.base + t * hd.tok + d];
    }
  }
  scratch[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < DW) {
    float sum = 0.f;
    for (int g = 0; g < kGroups; ++g) sum += scratch[g * DW + threadIdx.x];
    out[threadIdx.x] = sum;
  }
  __syncthreads();
}

// The thread's rows of a 64 x DW accumulator out to a (B, T, NH, HD) f32
// tensor, times scale[i] (rows t >= T and columns past HD skipped).
template <int HD>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const Head<HD>& hd, int t0,
                                           int T, const float (&acc)[4][kCols<kWidth<HD>>],
                                           const float (&scale)[4], int tx, int ty) {
  constexpr int DW = kWidth<HD>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = t0 + ty + 16 * i;
    if (r >= T) continue;
    float* out = dst + hd.base + r * hd.tok;
#pragma unroll
    for (int n = 0; n < kCols<DW>; ++n) {
      const int col = out_col<DW>(n, tx);
      if (col < HD) out[col] = acc[i][n] * scale[i];
    }
  }
}

// Host: lets a kernel use `bytes` of dynamic shared memory.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace pct_attn_f32
