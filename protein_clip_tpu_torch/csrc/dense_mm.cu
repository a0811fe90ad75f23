// Dense product out = x . W on the tensor cores (P1), Hopper (sm_90a): s8 x s8
// -> s32 (exact) for the w8a8 backbone's linear layers, and bf16 x bf16 -> f32
// (the TPU probe's own baseline).
//
// Replaces tools/probe_int8_pallas.py::_mm_kernel (launched by mm): one
// dot_general per (512, 512) VMEM tile with the accumulator in out_dtype. No
// package path of the TPU package calls it (there the w8a8 layers are an XLA
// einsum); in the port every quantised linear layer (q, k, v, o, wi, wo of
// models/esm2._dense) runs through it.
//
// Bound on an H100 SXM (1979 TOP/s int8, 989 TFLOP/s bf16, 3.35 TB/s): 2NKM
// operations against x and W read once and out written once. At the probe's
// (8192, 2560, 2560) s8 that is 107.4 GOP (0.0543 ms) against 111.4 MB
// (0.0333 ms): operations. At the serving shapes the s32 output dominates
// the bytes, e.g. wi at N = 10240 tokens (10240, 640, 2560): 33.6 GOP
// (0.0170 ms) against 113.1 MB (0.0338 ms), so the kernel is bound by
// writing 4 bytes per output. Fusing the dequantisation (x scale times w
// scale, cast, bias) into the epilogue would write 2; that is a later PR.
//
// Design: csrc/mma_gemm.cuh (a cp.async ring of 128-byte k-tiles with
// mbarriers, a producer warpgroup, wgmma m64nBNk32 s8 / m64nBNk16 bf16 in
// consumer warpgroups; the s8 W tile turned K-major with byte permutes by the
// producer, the parameter tree's (in, out) layout kept) with an epilogue that
// writes the accumulators as they are, staged through shared memory into
// 16-byte coalesced stores: s32 sums of s8 products are exact, so the s8
// result equals any exact product to the bit. What limits it now (PERF.md
// section 6): each block loads its x and W tiles from L2 on its own (no
// cluster multicast), and its epilogue's 4-byte stores overlap no loads (at
// the wi shape they are 93% of the bytes); at 128 tokens each k-tile waits
// one W load, which the producer's registers prefetch a single tile ahead.
//
// Built by protein_clip_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (plain C interface below).

#include "mma_gemm.cuh"

namespace {

using namespace pct_gemm;

// The accumulators as they are.
template <class Acc>
struct DenseMmOut {
  using Out = Acc;
  Out* out;
  int M;
  __device__ __forceinline__ void operator()(Acc a0, Acc a1, int, Out& o0, Out& o1) const {
    o0 = a0;
    o1 = a1;
  }
};

template <class Op>
int run(const void* x, const void* w, void* out, int N, int K, int M, void* stream) {
  const DenseMmOut<typename Op::Acc> epi{static_cast<typename Op::Acc*>(out), M};
  return launch_for<Op>(x, w, epi, N, K, M, static_cast<cudaStream_t>(stream));
}

}  // namespace

// x (N, K), w (K, M), out (N, M), all contiguous; the wrapper checks shapes
// (K % 32 == 0, M % 8 == 0) and alignment. Launches on `stream` (a
// cudaStream_t) and returns the first CUDA error: 0 when the launch was
// accepted.
extern "C" int pct_dense_mm_s8(const void* x, const void* w, void* out, int N, int K, int M,
                               void* stream) {
  return run<S8>(x, w, out, N, K, M, stream);
}

// As pct_dense_mm_s8 in bf16 -> f32 (K % 16 == 0, M % 8 == 0).
extern "C" int pct_dense_mm_bf16(const void* x, const void* w, void* out, int N, int K, int M,
                                 void* stream) {
  return run<BF16>(x, w, out, N, K, M, stream);
}
