// K6-f32's first design, kept for tools/probe_ffn_f32.py: out = gelu(x . W
// + b) in f32 with exact f32 products by FFMA on the CUDA cores. The
// package's K6-f32 (csrc/ffn_gelu_f32.cu) runs 3xTF32 on wgmma in its
// place; this build is the yardstick it replaced.
//
// Design: a register-tiled FFMA GEMM with the epilogue on the accumulators.
// A block of 256 threads (a 16 x 16 grid) owns a BM x BN tile of the
// output, each thread BM / 16 rows by BN / 16 columns in groups of 4 (rows
// ty 4 + i + 64 g, columns tx 4 + j + 64 h), so that its reads of W's rows
// from shared memory are float4 and a quarter-warp's 8 of them are 128
// contiguous bytes. The k-loop walks H in tiles of 16: x's BM rows x 16
// (rows padded to 20 floats) and W's 16 rows x BN, as stored (MN-major),
// land in shared memory by 16-byte cp.async, two stages deep; past N and M
// the copies zero-fill. Two tiles: 128 x 128 (8 x 8 a thread), and 64 x 64
// (4 x 4) when the large tile's grid would not give every SM a block. What
// limits it: the CUDA cores (FFMA at 67 TFLOP/s, 2.46 times the 3xTF32
// bound at t30_150M's wi for 32 sequences) and one shared-memory read for
// every 16 FFMA.
//
// Built by tools/probe_ffn_f32.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (the csrc/ directory on the include path) and bound with ctypes: the
// entry point takes pct_ffn_gelu_f32's arguments.

#include <cuda_runtime.h>

#include <cstdint>

#include "gelu.cuh"
#include "hopper.cuh"

namespace {

using pct_hopper::cp_async16;
using pct_hopper::cp_async_commit;
using pct_hopper::cp_async_wait_all;
using pct_hopper::cp_async_wait_group;
using pct_hopper::smem_u32;

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kBK = 16;        // the k-depth of a tile: H % 16 == 0
constexpr int kXStride = kBK + 4;

template <int BM, int BN>
struct Tile {
  static constexpr int kTM = BM / 16;  // rows a thread
  static constexpr int kTN = BN / 16;  // columns a thread
  static constexpr int kXFloats = BM * kXStride;
  static constexpr int kStageFloats = kXFloats + kBK * BN;
  static_assert(BM % 64 == 0 && BN % 64 == 0, "threads own rows and columns in groups of 64");
};

// The thread's i-th row and j-th column of the tile.
__device__ __forceinline__ int tile_row(int i, int ty) { return (i / 4) * 64 + ty * 4 + i % 4; }
__device__ __forceinline__ int tile_col(int j, int tx) { return (j / 4) * 64 + tx * 4 + j % 4; }

__device__ __forceinline__ float part(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The whole block: k-tile t of x's rows [row0, row0 + BM) and of W's
// columns [col0, col0 + BN) into a stage, by 16-byte cp.async, zero-filled
// past N and M (M % 4 == 0, so a float4 of W is all in or all out).
template <int BM, int BN>
__device__ __forceinline__ void load_tile(float* stage, const float* __restrict__ x,
                                          const float* __restrict__ w, int N, int K, int M,
                                          int row0, int col0, int t) {
  const int k0 = t * kBK;
  for (int c = threadIdx.x; c < BM * kBK / 4; c += kThreads) {
    const int r = c / (kBK / 4), ch = c % (kBK / 4);
    const int row = row0 + r;
    const float* src = x + static_cast<int64_t>(row < N ? row : 0) * K + k0 + 4 * ch;
    cp_async16(smem_u32(stage + r * kXStride + 4 * ch), src, row < N);
  }
  float* ws = stage + Tile<BM, BN>::kXFloats;
  for (int c = threadIdx.x; c < kBK * BN / 4; c += kThreads) {
    const int r = c / (BN / 4), ch = c % (BN / 4);
    const int col = col0 + 4 * ch;
    const float* src = w + static_cast<int64_t>(k0 + r) * M + (col < M ? col : 0);
    cp_async16(smem_u32(ws + r * BN + 4 * ch), src, col < M);
  }
}

// grid (ceil(N / BM), ceil(M / BN)), kThreads threads, 2 stages of
// Tile::kStageFloats floats of static shared memory (36 KB at 128 x 128);
// two blocks an SM (128 registers a thread at 128 x 128, no spills).
template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 2)
    ffn_gelu_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ b, float* __restrict__ out, int N, int K,
                        int M, int mode) {
  using T = Tile<BM, BN>;
  __shared__ __align__(16) float smem[2 * T::kStageFloats];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;

  float acc[T::kTM][T::kTN];
#pragma unroll
  for (int i = 0; i < T::kTM; ++i) {
#pragma unroll
    for (int j = 0; j < T::kTN; ++j) acc[i][j] = 0.0f;
  }

  const int n_tiles = K / kBK;
  load_tile<BM, BN>(smem, x, w, N, K, M, row0, col0, 0);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_tile<BM, BN>(smem + ((t + 1) % 2) * T::kStageFloats, x, w, N, K, M, row0, col0,
                        t + 1);
    }
    cp_async_commit();
    cp_async_wait_group<1>();  // tile t has landed; tile t + 1 may be in flight
    __syncthreads();
    const float* xs = smem + (t % 2) * T::kStageFloats;
    const float* ws = xs + T::kXFloats;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 a[T::kTM];
#pragma unroll
      for (int i = 0; i < T::kTM; ++i) {
        a[i] = *reinterpret_cast<const float4*>(xs + tile_row(i, ty) * kXStride + kk);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float bv[T::kTN];
#pragma unroll
        for (int h = 0; h < T::kTN / 4; ++h) {
          const float4 v =
              *reinterpret_cast<const float4*>(ws + (kk + q) * BN + h * 64 + tx * 4);
          bv[4 * h] = v.x;
          bv[4 * h + 1] = v.y;
          bv[4 * h + 2] = v.z;
          bv[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < T::kTM; ++i) {
          const float av = part(a[i], q);
#pragma unroll
          for (int j = 0; j < T::kTN; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }
  cp_async_wait_all();

  // the epilogue on the accumulators: bias, gelu, float4 stores
  float bias[T::kTN];
#pragma unroll
  for (int j = 0; j < T::kTN; ++j) {
    const int col = col0 + tile_col(j, tx);
    bias[j] = col < M ? b[col] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < T::kTM; ++i) {
    const int row = row0 + tile_row(i, ty);
    if (row >= N) continue;
#pragma unroll
    for (int h = 0; h < T::kTN / 4; ++h) {
      const int col = col0 + h * 64 + tx * 4;
      if (col >= M) continue;
      float4 o;
      o.x = pct_ffn::gelu(acc[i][4 * h] + bias[4 * h], mode);
      o.y = pct_ffn::gelu(acc[i][4 * h + 1] + bias[4 * h + 1], mode);
      o.z = pct_ffn::gelu(acc[i][4 * h + 2] + bias[4 * h + 2], mode);
      o.w = pct_ffn::gelu(acc[i][4 * h + 3] + bias[4 * h + 3], mode);
      *reinterpret_cast<float4*>(out + static_cast<int64_t>(row) * M + col) = o;
    }
  }
}

template <int BM, int BN>
int launch(const float* x, const float* w, const float* b, float* out, int N, int K, int M,
           int mode, cudaStream_t stream) {
  const dim3 grid((N + BM - 1) / BM, (M + BN - 1) / BN);
  ffn_gelu_f32_kernel<BM, BN><<<grid, kThreads, 0, stream>>>(x, w, b, out, N, K, M, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, K), w (K, M), b (M,), out (N, M), f32, contiguous; the wrapper
// checks shapes (K % 16 == 0, M % 8 == 0) and alignment; mode 0 is erf, 1
// tanh. The 128 x 128 tile when its grid gives every SM of the card a
// block, else the 64 x 64 one. Launches on `stream` (a cudaStream_t) and
// returns the first CUDA error: 0 when the launch was accepted.
extern "C" int pct_probe_ffn_gelu_f32_ffma(const void* x, const void* w, const void* b,
                                           void* out, int N, int K, int M, int mode,
                                           void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(b);
  auto* of = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t large_blocks = static_cast<int64_t>((N + 127) / 128) * ((M + 127) / 128);
  if (large_blocks < sms) return launch<64, 64>(xf, wf, bf, of, N, K, M, mode, s);
  return launch<128, 128>(xf, wf, bf, of, N, K, M, mode, s);
}
