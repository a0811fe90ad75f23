// Fused FFN input projection with its gelu in f32 (K6-f32), Hopper (sm_90a):
// out = gelu(x . W + b), f32 in and out, for ESM-2's wi under
// PCT_FFN_PALLAS=1 with --esm-dtype float32.
//
// Replaces protein_clip_tpu/ops/ffn_pallas.py::_kernel (launched by _call)
// for f32 operands, which the TPU kernel takes as it takes bf16: it runs in
// the compute dtype (out_dtype = x's). Same function and the same rounding
// points as that kernel in f32 and as the plain version
// (ops/ffn.dense_gelu_reference): the product summed in f32; the f32 bias
// added to it (the TPU kernel's cast to the compute dtype is a no-op here);
// gelu in f32 (gelu.cuh: erff, or mode 1's tanh form); stored in f32.
//
// Products: 3xTF32 on the tensor cores, f32-accurate as K4, K2 and K3 are
// (csrc/mma_gemm.cuh's F32 operand type): each of x and W split into hi =
// tf32(v) and lo = tf32(v - hi), hi.hi + hi.lo + lo.hi summed in f32, each
// k-tile's 12 products in a fresh wgmma accumulator that an f32 add then
// takes into the sum (the tensor core's f32 adds round toward zero). Not
// exact f32: the products leave out lo.lo (2^-22 relative) and the sums run
// in another order than cuBLAS's f32 GEMM; plain TF32 (one product) is off
// by about 1e-3 relative.
//
// Bound on an H100 SXM (495 TFLOP/s TF32 on the tensor cores, 3.35 TB/s):
// 2NHM FLOP, each product as three TF32 products, against x, W, b read and
// out written once (4 bytes each). At t30_150M's wi for a batch of 32
// sequences (N = 10240 tokens, H = 640, M = 2560): 33.55 GFLOP, 100.7 GFLOP
// of TF32 (0.2034 ms), against 137.6 MB (0.0411 ms): operations. At 128
// tokens the two bounds are close (about 0.0025 ms each): one sequence reads
// W for little work.
//
// Design: csrc/mma_gemm.cuh's ring with the F32 operand type (x by TMA in
// k-tiles of 32 floats and split in the consumers' registers as wgmma's A;
// W's k-tiles loaded into the producer warpgroup's registers some tiles
// ahead, turned K-major, split and stored as the hi and lo B tiles), and
// this file's epilogue on the f32 sums, so the f32 pre-activation never
// reaches device memory (the TPU kernel's point). Two tiles (Shapes<F32>):
// 128 x 128 with two consumer warpgroups, four 48 KB stages (192 KB), and
// 64 x 32 with one, four 16 KB stages (64 KB), when the large grid would
// have fewer than kLargeMinBlocks blocks (N = 128 at M = 2560: 160 blocks
// of 64 x 32, each walking all 20 k-tiles of H = 640; 64 x 64 gave 80 and
// took 16% longer). The kernel it replaced, f32 FFMA on the CUDA cores (67
// TFLOP/s, a ceiling 2.46 times this bound), is
// tools/probe_ffn_f32_ffma.cu; tools/probe_ffn_f32.py times the two and
// the other tile shapes.
//
// Built by protein_clip_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (plain C interface below).

#include "gelu.cuh"
#include "mma_gemm.cuh"

namespace {

using namespace pct_gemm;
using pct_ffn::gelu;

// gelu(acc + b) in f32 for the pair at columns col, col + 1.
struct FfnGeluF32Out {
  using Out = float;
  Out* out;
  int M;
  const float* b;
  int mode;
  __device__ __forceinline__ void operator()(float a0, float a1, int col, Out& o0,
                                             Out& o1) const {
    float b0 = 0.0f, b1 = 0.0f;
    if (col < M) {  // M is even: col + 1 < M too
      b0 = b[col];
      b1 = b[col + 1];
    }
    o0 = gelu(a0 + b0, mode);
    o1 = gelu(a1 + b1, mode);
  }
};

}  // namespace

// x (N, K), w (K, M), b (M,), out (N, M), f32, contiguous; the wrapper
// checks shapes (K % 16 == 0, M % 8 == 0) and alignment; mode 0 is erf, 1
// tanh. Launches on `stream` (a cudaStream_t) and returns the first CUDA
// error: 0 when the launch was accepted.
extern "C" int pct_ffn_gelu_f32(const void* x, const void* w, const void* b, void* out, int N,
                                int K, int M, int mode, void* stream) {
  const FfnGeluF32Out epi{static_cast<float*>(out), M, static_cast<const float*>(b), mode};
  return launch_for<F32>(x, w, epi, N, K, M, static_cast<cudaStream_t>(stream));
}
