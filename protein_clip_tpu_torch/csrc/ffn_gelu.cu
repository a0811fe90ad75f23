// Fused FFN input projection with its gelu (K6), Hopper (sm_90a):
// out = gelu(x . W + b), bf16 in and out, for ESM-2's wi under
// PCT_FFN_PALLAS=1.
//
// Replaces protein_clip_tpu/ops/ffn_pallas.py::_kernel (launched by _call).
// Same function and the same rounding points as that kernel and as the
// eager composition it stands for (models/esm2._dense + _gelu_exact): the
// product accumulated in f32; rounded to bf16; the bf16 bias added (in f32)
// and the sum rounded to bf16 again ("cast, THEN bias"); gelu in f32; the
// result rounded to bf16. Both roundings before the gelu are kept: dropping
// either one changes the output. gelu is erf (CUDA's erff; the TPU kernel
// carried Eigen's polynomial only because Mosaic has no erf) or, for
// mode 1, 0.5 a (1 + tanh(sqrt(2/pi) (a + 0.044715 a^3))) in f32.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): 2NHM FLOP against x,
// W, b read and out written once (2 bytes each). At t30_150M's wi for a batch
// of 32 sequences (N = 10240 tokens, H = 640, M = 2560) that is 33.6 GFLOP
// (0.0339 ms) against 68.8 MB (0.0205 ms): operations. The epilogue's erff
// per output (26.2 M of them) runs on the FMA and special-function units
// beside the tensor cores.
//
// Design: csrc/mma_gemm.cuh's bf16 main loop (mma.sync m16n8k16, f32
// accumulators in registers, 128 x 128 output tile per block) and the
// epilogue on those registers, so the f32 pre-activation never reaches
// device memory: the TPU kernel's point (one pass instead of a matmul that
// writes z and an elementwise pass that reads it back). The TPU kernel split
// its tile into two sub-blocks so that Mosaic could overlap one's matmul with
// the other's epilogue; on Hopper other resident blocks give that overlap.
//
// Built by protein_clip_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (plain C interface below).

#include "mma_gemm.cuh"

namespace {

using namespace pct_gemm;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// gelu of the bf16 pre-activation a, in f32.
__device__ __forceinline__ float gelu(float a, int mode) {
  if (mode == 1) {
    const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
    const float kKappa = 0.044715f;
    const float cube = a * a * a;
    return 0.5f * a * (1.0f + tanhf(kBeta * (a + kKappa * cube)));
  }
  return a * 0.5f * (1.0f + erff(a / 1.4142135623730951f));
}

// grid (ceil(M / 128), ceil(N / 128)), 256 threads.
__global__ void __launch_bounds__(kThreads)
ffn_gelu_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ out, int N,
                int K, int M, int mode) {
  const int row0 = blockIdx.y * kBlockRows;
  const int col0 = blockIdx.x * kBlockCols;
  float acc[4][4][4];
  mainloop<BF16>(x, w, N, K, M, row0, col0, acc);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = col0 + (warp & 3) * 32 + nt * 8 + tig * 2;
    if (col >= M) continue;
    const float b0 = __bfloat162float(b[col]);
    const float b1 = __bfloat162float(b[col + 1]);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // fragment rows g and g + 8
        const int row = row0 + (warp >> 2) * 64 + mt * 16 + g + 8 * h;
        if (row >= N) continue;
        const float z0 = round_bf16(round_bf16(acc[mt][nt][2 * h]) + b0);
        const float z1 = round_bf16(round_bf16(acc[mt][nt][2 * h + 1]) + b1);
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<int64_t>(row) * M + col) =
            __floats2bfloat162_rn(gelu(z0, mode), gelu(z1, mode));
      }
    }
  }
}

}  // namespace

// x (N, K), w (K, M), b (M,), out (N, M), bf16, contiguous; the wrapper
// checks shapes (K % 16 == 0, M % 8 == 0) and alignment; mode 0 is erf, 1
// tanh. Launches on `stream` (a cudaStream_t) and returns
// cudaGetLastError(): 0 when the launch was accepted.
extern "C" int pct_ffn_gelu(const void* x, const void* w, const void* b, void* out, int N,
                            int K, int M, int mode, void* stream) {
  const dim3 grid((M + kBlockCols - 1) / kBlockCols, (N + kBlockRows - 1) / kBlockRows);
  ffn_gelu_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(out), N, K, M, mode);
  return static_cast<int>(cudaGetLastError());
}
