// Fused FFN input projection with its gelu in f32 (K6-f32), Hopper (sm_90a):
// out = gelu(x . W + b), f32 in and out, for ESM-2's wi under
// PCT_FFN_PALLAS=1 with --esm-dtype float32.
//
// Replaces protein_clip_tpu/ops/ffn_pallas.py::_kernel (launched by _call)
// for f32 operands, which the TPU kernel takes as it takes bf16: it runs in
// the compute dtype (out_dtype = x's). Same function and the same rounding
// points as that kernel in f32 and as the plain version
// (ops/ffn.dense_gelu_reference): the product accumulated in f32; the f32
// bias added to it (the TPU kernel's cast to the compute dtype is a no-op
// here); gelu in f32 (gelu.cuh: erff, or mode 1's tanh form); stored in
// f32. Nothing is rounded to TF32: the products are exact f32 FFMA, the
// port's f32 contract ("exact f32", as cuBLAS with TF32 off).
//
// Bound on an H100 SXM (495 TFLOP/s TF32 on the tensor cores, 3.35 TB/s):
// 2NHM FLOP, each product kept at f32 accuracy as three TF32 products
// (3xTF32, as K1-f32's and K4's bounds count them), against x, W, b read
// and out written once (4 bytes each). At t30_150M's wi for a batch of 32
// sequences (N = 10240 tokens, H = 640, M = 2560): 33.55 GFLOP, 100.7 GFLOP
// of TF32 (0.2034 ms), against 137.6 MB (0.0411 ms): operations. This FFMA
// design's own ceiling is the products at 67 TFLOP/s f32 on the CUDA cores
// (0.5008 ms), 2.46 times the bound. At 128 tokens the two bounds are close
// (about 0.0025 ms each): one sequence reads W for little work.
//
// Design: a register-tiled FFMA GEMM with the epilogue on the accumulators,
// so the f32 pre-activation never reaches device memory (the TPU kernel's
// point). A block of 256 threads (a 16 x 16 grid) owns a BM x BN tile of
// the output, each thread BM / 16 rows by BN / 16 columns in groups of 4
// (rows ty 4 + i + 64 g, columns tx 4 + j + 64 h), so that its reads of W's
// rows from shared memory are float4 and a quarter-warp's 8 of them are 128
// contiguous bytes. The k-loop walks H in tiles of 16: x's BM rows x 16
// (rows padded to 20 floats, so the two row groups a warp reads sit on
// other banks) and W's 16 rows x BN, as stored (MN-major: no transpose, the
// natural layout of an outer product), land in shared memory by 16-byte
// cp.async, two stages deep, the next tile's copies in flight while this
// one's products run; past N and M the copies zero-fill. Each thread reads
// its x rows as float4 along k (4 k-steps) and W's row as float4 along n,
// and runs 4 x (BM / 16) x (BN / 16) FFMA per k-step of 4. The bias and the
// gelu run on the accumulators, and the outputs go out as float4. Two
// tiles: 128 x 128 (8 x 8 a thread), and 64 x 64 (4 x 4) when the large
// tile's grid would not give every SM a block (N = 128 at M = 2560: 20
// blocks of 128 x 128, 80 of 64 x 64). The register cap of two blocks an
// SM (128 a thread, against 151 uncapped) lets one block's loads and
// barriers hide behind the other's products. What limits it: the CUDA cores
// (FFMA at 67 TFLOP/s, 2.46 times the 3xTF32 bound) and one shared-memory
// read for every 16 FFMA; a tensor-core design (3xTF32 wgmma, W read
// K-major) is ROADMAP's next step for this kernel.
//
// Built by protein_clip_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (plain C interface below).

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
extern "C" int pct_ffn_gelu_f32(const void* x, const void* w, const void* b, void* out, int N,
                                int K, int M, int mode, void* stream) {
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
