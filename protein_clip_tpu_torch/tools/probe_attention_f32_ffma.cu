// The f32 attention kernels the port ran before they moved to 3xTF32
// wgmma: K1-f32 and K5-f32 as exact f32 FFMA on the CUDA cores, one buffer
// a tile (what csrc/attention_fwd_f32.cu, csrc/attention_bwd_f32.cu and
// csrc/attention_f32.cuh held). Kept for tools/probe_attention_f32.py,
// which times them beside the shipped kernels in one process; nothing in
// the package loads this file. Built with -I csrc (it includes
// attention.cuh for the segment ranges, skip predicate and swept loop).
//
// Entry points: pct_probe_attention_fwd_f32_ffma and
// pct_probe_attention_bwd_f32_ffma, with the arguments of the shipped
// pct_attention_fwd_f32 and pct_attention_bwd_f32.

#include "attention.cuh"

namespace pct_attn_f32_ffma {

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

}  // namespace pct_attn_f32_ffma

using namespace pct_attn_f32_ffma;

// ---------------------------------------------------------------------------
// K1-f32 (FFMA)
// ---------------------------------------------------------------------------

namespace fwd_ffma {

using namespace pct_attn_f32_ffma;
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

}  // namespace fwd_ffma

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError(): 0
// when the launch was accepted, cudaErrorInvalidValue for a head dim the
// kernel does not take (16, 24, 32, 64 and 128 it takes). lse: null, or
// B*NH*T f32 written.
extern "C" int pct_probe_attention_fwd_f32_ffma(const void* q, const void* k, const void* v,
                                     const void* segments, void* out, void* lse, int B, int T,
                                     int NH, int head_dim, void* stream) {
  return pct_attn::by_head_dim(head_dim, [&](auto head) {
    constexpr int HD = decltype(head)::value;
    constexpr int DW = kWidth<HD>;
    static const cudaError_t allowed =
        allow_smem(fwd_ffma::attention_fwd_f32_kernel<HD>, fwd_ffma::fwd_smem<DW>(tiles_of(pct_attn::kMaxT)));
    if (allowed != cudaSuccess) return static_cast<int>(allowed);
    const dim3 grid(tiles_of(T), NH, B);
    fwd_ffma::attention_fwd_f32_kernel<HD><<<grid, kThreads, fwd_ffma::fwd_smem<DW>(tiles_of(T)),
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int32_t*>(segments),
        static_cast<float*>(out), static_cast<float*>(lse), T, NH);
    return static_cast<int>(cudaGetLastError());
  });
}

// ---------------------------------------------------------------------------
// K5-f32 (FFMA)
// ---------------------------------------------------------------------------

namespace bwd_ffma {

using namespace pct_attn_f32_ffma;
using pct_attn::overlaps;
using pct_attn::swept_tiles;
using pct_attn::tile_ranges;

// Dynamic shared memory for rows of n tiles: four tiles, one or two
// 64 x 64 products, three per-row vectors and the tile ranges (170 KB at DH
// 128 and the longest row, launch 2).
template <int DW>
constexpr int bwd_smem(int n) {
  return 4 * (4 * kTileFloats<DW> + 2 * kPFloats + 3 * kTile) + 16 * n;
}

// Launch 1. grid (ceil(T / 64), NH, B), kThreads threads. q, k, v, o,
// dout, dq: (B, T, NH, HD) f32, contiguous; seg: (B, T) int32; lse (read)
// and delta (written): (B, NH, T) f32.
template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const int32_t* __restrict__ seg,
                            const float* __restrict__ o, const float* __restrict__ dout,
                            const float* __restrict__ lse, float* __restrict__ dq,
                            float* __restrict__ delta_out, int T, int NH) {
  constexpr int DW = kWidth<HD>;
  constexpr int NC = kCols<DW>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kTileFloats<DW>;
  float* ks = dos + kTileFloats<DW>;
  float* vs = ks + kTileFloats<DW>;
  float* dss = vs + kTileFloats<DW>;
  float* delta_s = dss + 2 * kPFloats;
  int32_t* segk = reinterpret_cast<int32_t*>(delta_s + kTile);
  int4* ranges = reinterpret_cast<int4*>(segk + 2 * kTile);

  const Head<HD> hd(seg, T, NH);
  const int q0 = blockIdx.x * kTile;
  tile_ranges(ranges, hd.seg_row, T, kThreads);
  load_tile<HD>(qs, q, hd, q0, T);
  load_tile<HD>(dos, dout, hd, q0, T);
  if (threadIdx.x < kTile) {  // delta = dO . O, one FMA chain a query in score_tile's order
    const int t = q0 + threadIdx.x;
    float d = 0.f;
    if (t < T) {
      const float* orow = o + hd.base + t * hd.tok;
      const float* drow = dout + hd.base + t * hd.tok;
      for (int c = 0; c < HD; ++c) d = fmaf(drow[c], orow[c], d);
      delta_out[hd.vec + t] = d;
    }
    delta_s[threadIdx.x] = d;
  }
  __syncthreads();
  const int4 own = ranges[blockIdx.x];

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  int sq[4];
  float lse_q[4], delta[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    const bool in = r < T;
    sq[i] = in ? hd.seg_row[r] : -1;  // past T: no key
    lse_q[i] = in ? lse[hd.vec + r] : 0.f;
    delta[i] = delta_s[ty + 16 * i];
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }

  const int n_tiles = tiles_of(T);
  for (int j = 0; j < n_tiles; ++j) {
    if (!overlaps(own, ranges[j])) continue;
    __syncthreads();  // the last tile's k, v and dS are read
    load_tile<HD>(ks, k, hd, j * kTile, T);
    load_tile<HD>(vs, v, hd, j * kTile, T);
    load_vec(segk, hd.seg_row, j * kTile, T);
    __syncthreads();
    float s[4][4], dp[4][4];
    score_tile<DW>(s, qs, ks, tx, ty);    // q . k^T
    score_tile<DW>(dp, dos, vs, tx, ty);  // dO . v^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int sk = segk[tx + 16 * jj];
        const bool ok = sk > 0 && sk == sq[i];
        const float p = ok ? pct_attn::ex2(__fmul_rn(s[i][jj], kLog2e) - lse_q[i]) : 0.f;
        dss[(ty + 16 * i) * kPStride + tx + 16 * jj] = p * (dp[i][jj] - delta[i]);
      }
    }
    __syncwarp();
    accumulate<DW>(acc, dss, ks, tx, ty);  // dq += dS . k
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<HD>(dq, hd, q0, T, acc, one, tx, ty);
}

// Launch 2. grid (ceil(T / 64), NH, B), kThreads threads; the block owns 64
// keys. lse and delta: (B, NH, T) f32 from K1-f32 and launch 1.
template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const int32_t* __restrict__ seg,
                              const float* __restrict__ dout, const float* __restrict__ lse,
                              const float* __restrict__ delta, float* __restrict__ dk,
                              float* __restrict__ dv, int T, int NH) {
  constexpr int DW = kWidth<HD>;
  constexpr int NC = kCols<DW>;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kTileFloats<DW>;
  float* qs = vs + kTileFloats<DW>;
  float* dos = qs + kTileFloats<DW>;
  float* pts = dos + kTileFloats<DW>;
  float* dsts = pts + kPFloats;
  float* lse_s = dsts + kPFloats;
  float* delta_s = lse_s + kTile;
  int32_t* segq = reinterpret_cast<int32_t*>(delta_s + kTile);
  int4* ranges = reinterpret_cast<int4*>(segq + kTile);
  __shared__ float do_sum[DW], scratch[kThreads];

  const Head<HD> hd(seg, T, NH);
  const int k0 = blockIdx.x * kTile;
  tile_ranges(ranges, hd.seg_row, T, kThreads);
  load_tile<HD>(ks, k, hd, k0, T);
  load_tile<HD>(vs, v, hd, k0, T);
  __syncthreads();
  const int4 own = ranges[blockIdx.x];
  // The pad queries' part of dv, the same for every key: f32(1/T) sum dO.
  bool pads = false;
  for (int j = 0; j < tiles_of(T); ++j) pads |= ranges[j].z != 0;
  if (pads) column_sum<HD>(do_sum, scratch, dout, hd, T, true);

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  int sk[4];
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    sk[i] = r < T ? hd.seg_row[r] : 0;  // past T: allowed for no query
#pragma unroll
    for (int n = 0; n < NC; ++n) dk_acc[i][n] = dv_acc[i][n] = 0.f;
  }

  const int sweep = swept_tiles(T);
  for (int j = 0; j < sweep; ++j) {
    if (!overlaps(ranges[j], own)) continue;
    __syncthreads();  // the last tile's q, dO, P^T and dS^T are read
    load_tile<HD>(qs, q, hd, j * kTile, T);
    load_tile<HD>(dos, dout, hd, j * kTile, T);
    load_vec(segq, hd.seg_row, j * kTile, T);
    load_vec(lse_s, lse + hd.vec, j * kTile, T);
    load_vec(delta_s, delta + hd.vec, j * kTile, T);
    __syncthreads();
    float p[4][4], ds[4][4];  // P^T and dS^T: keys are rows, queries columns
    score_tile<DW>(p, ks, qs, tx, ty);    // k . q^T
    score_tile<DW>(ds, vs, dos, tx, ty);  // v . dO^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        const bool ok = sk[i] > 0 && segq[c] == sk[i];
        const float e = pct_attn::ex2(__fmul_rn(p[i][jj], kLog2e) - lse_s[c]);
        pts[(ty + 16 * i) * kPStride + c] = ok ? e : 0.f;
        dsts[(ty + 16 * i) * kPStride + c] = ok ? e * (ds[i][jj] - delta_s[c]) : 0.f;
      }
    }
    __syncwarp();
    accumulate<DW>(dv_acc, pts, dos, tx, ty);  // dv += P^T . dO
    accumulate<DW>(dk_acc, dsts, qs, tx, ty);  // dk += dS^T . q
  }
  if (pads) {
    const float w_pad = __frcp_rn(static_cast<float>(T));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int n = 0; n < NC; ++n) dv_acc[i][n] += w_pad * do_sum[out_col<DW>(n, tx)];
    }
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<HD>(dk, hd, k0, T, dk_acc, one, tx, ty);
  store_rows<HD>(dv, hd, k0, T, dv_acc, one, tx, ty);
}

}  // namespace bwd_ffma

// Launches both kernels on `stream` (a cudaStream_t) and returns
// cudaGetLastError(): 0 when both launches were accepted,
// cudaErrorInvalidValue for a head dim the kernels do not take (16, 24, 32,
// 64 and 128 they take). out: K1-f32's output; lse: its (B, NH, T)
// statistics; delta: B*NH*T f32 of scratch.
extern "C" int pct_probe_attention_bwd_f32_ffma(const void* q, const void* k, const void* v,
                                     const void* segments, const void* out, const void* dout,
                                     const void* lse, void* dq, void* dk, void* dv, void* delta,
                                     int B, int T, int NH, int head_dim, void* stream) {
  return pct_attn::by_head_dim(head_dim, [&](auto head) {
    constexpr int HD = decltype(head)::value;
    constexpr int DW = kWidth<HD>;
    const int most = bwd_ffma::bwd_smem<DW>(tiles_of(pct_attn::kMaxT));
    static const cudaError_t allowed[2] = {allow_smem(bwd_ffma::attention_bwd_dq_f32_kernel<HD>, most),
                                           allow_smem(bwd_ffma::attention_bwd_dkdv_f32_kernel<HD>, most)};
    for (const cudaError_t e : allowed) {
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const dim3 grid(tiles_of(T), NH, B);
    const int smem = bwd_ffma::bwd_smem<DW>(tiles_of(T));
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* qp = static_cast<const float*>(q);
    const auto* kp = static_cast<const float*>(k);
    const auto* vp = static_cast<const float*>(v);
    const auto* sp = static_cast<const int32_t*>(segments);
    const auto* dp = static_cast<const float*>(dout);
    const auto* lp = static_cast<const float*>(lse);
    auto* dl = static_cast<float*>(delta);
    bwd_ffma::attention_bwd_dq_f32_kernel<HD><<<grid, kThreads, smem, s>>>(
        qp, kp, vp, sp, static_cast<const float*>(out), dp, lp, static_cast<float*>(dq), dl, T,
        NH);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    bwd_ffma::attention_bwd_dkdv_f32_kernel<HD><<<grid, kThreads, smem, s>>>(
        qp, kp, vp, sp, dp, lp, dl, static_cast<float*>(dk), static_cast<float*>(dv), T, NH);
    return static_cast<int>(cudaGetLastError());
  });
}
