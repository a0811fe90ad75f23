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
// mode 1, 0.5 a (1 + tanh(sqrt(2/pi) (a + 0.044715 a^3))) in f32 (gelu.cuh,
// which K6-f32, ffn_gelu_f32.cu, shares).
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): 2NHM FLOP against x,
// W, b read and out written once (2 bytes each). At t30_150M's wi for a batch
// of 32 sequences (N = 10240 tokens, H = 640, M = 2560) that is 33.6 GFLOP
// (0.0339 ms) against 68.8 MB (0.0205 ms): operations. The epilogue's erff
// per output (26.2 M of them) runs on the FMA and special-function units
// beside the tensor cores.
//
// Design: csrc/mma_gemm.cuh's bf16 main loop (a cp.async ring of 64-deep
// k-tiles with mbarriers, a producer warpgroup, wgmma m64nBNk16 with W read
// MN-major as stored, f32 accumulators in registers) and the epilogue on
// those registers, so the f32 pre-activation never reaches device memory:
// the TPU kernel's point (one pass instead of a matmul that writes z and an
// elementwise pass that reads it back). The bf16 results are staged through
// shared memory and stored 16 bytes a thread. The TPU kernel split its tile
// into two sub-blocks so that Mosaic could overlap one's matmul with the
// other's epilogue; here the epilogue runs after the block's k-loop. What
// limits it now (PERF.md section 6): that epilogue (an erff per output)
// overlaps neither the tensor cores nor the next tile's loads, and each
// block loads its tiles from L2 on its own (no cluster multicast).
//
// Built by protein_clip_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (plain C interface below).

#include "gelu.cuh"
#include "mma_gemm.cuh"

namespace {

using namespace pct_gemm;
using pct_ffn::gelu;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// round(gelu(round(round(acc) + b))) for the pair at columns col, col + 1.
struct FfnGeluOut {
  using Out = __nv_bfloat16;
  Out* out;
  int M;
  const __nv_bfloat16* b;
  int mode;
  __device__ __forceinline__ void operator()(float a0, float a1, int col, Out& o0,
                                             Out& o1) const {
    float b0 = 0.0f, b1 = 0.0f;
    if (col < M) {  // M is even: col + 1 < M too
      b0 = __bfloat162float(b[col]);
      b1 = __bfloat162float(b[col + 1]);
    }
    o0 = __float2bfloat16_rn(gelu(round_bf16(round_bf16(a0) + b0), mode));
    o1 = __float2bfloat16_rn(gelu(round_bf16(round_bf16(a1) + b1), mode));
  }
};

}  // namespace

// x (N, K), w (K, M), b (M,), out (N, M), bf16, contiguous; the wrapper
// checks shapes (K % 16 == 0, M % 8 == 0) and alignment; mode 0 is erf, 1
// tanh. Launches on `stream` (a cudaStream_t) and returns the first CUDA
// error: 0 when the launch was accepted.
extern "C" int pct_ffn_gelu(const void* x, const void* w, const void* b, void* out, int N,
                            int K, int M, int mode, void* stream) {
  const FfnGeluOut epi{static_cast<__nv_bfloat16*>(out), M, static_cast<const __nv_bfloat16*>(b),
                     mode};
  return launch_for<BF16>(x, w, epi, N, K, M, static_cast<cudaStream_t>(stream));
}
