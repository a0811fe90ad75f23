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
// Design: csrc/mma_gemm.cuh's main loop (mma.sync m16n8k32 s8, m16n8k16 bf16;
// the s8 W tile transposed with byte permutes while it is staged, the
// parameter tree's (in, out) layout kept), and an epilogue that writes the
// accumulators as they are: s32 sums of s8 products are exact, so the s8
// result equals any exact product to the bit.
//
// Built by protein_clip_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (plain C interface below).

#include "mma_gemm.cuh"

namespace {

using namespace pct_gemm;

// grid (ceil(M / 128), ceil(N / 128)), 256 threads.
template <class Op>
__global__ void __launch_bounds__(kThreads)
dense_mm_kernel(const typename Op::Elt* __restrict__ x, const typename Op::Elt* __restrict__ w,
                typename Op::Acc* __restrict__ out, int N, int K, int M) {
  const int row0 = blockIdx.y * kBlockRows;
  const int col0 = blockIdx.x * kBlockCols;
  typename Op::Acc acc[4][4][4];
  mainloop<Op>(x, w, N, K, M, row0, col0, acc);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // fragment rows g and g + 8
      const int row = row0 + (warp >> 2) * 64 + mt * 16 + g + 8 * h;
      if (row >= N) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = col0 + (warp & 3) * 32 + nt * 8 + tig * 2;
        if (col >= M) continue;
        typename Op::Acc* p = out + static_cast<int64_t>(row) * M + col;
        p[0] = acc[mt][nt][2 * h];
        p[1] = acc[mt][nt][2 * h + 1];
      }
    }
  }
}

template <class Op>
int launch(const void* x, const void* w, void* out, int N, int K, int M, void* stream) {
  const dim3 grid((M + kBlockCols - 1) / kBlockCols, (N + kBlockRows - 1) / kBlockRows);
  dense_mm_kernel<Op><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename Op::Elt*>(x), static_cast<const typename Op::Elt*>(w),
      static_cast<typename Op::Acc*>(out), N, K, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, K), w (K, M), out (N, M), all contiguous; the wrapper checks shapes
// (K % 32 == 0, M % 8 == 0) and alignment. Launches on `stream` (a
// cudaStream_t) and returns cudaGetLastError(): 0 when the launch was
// accepted.
extern "C" int pct_dense_mm_s8(const void* x, const void* w, void* out, int N, int K, int M,
                               void* stream) {
  return launch<S8>(x, w, out, N, K, M, stream);
}

// As pct_dense_mm_s8 in bf16 -> f32 (K % 16 == 0, M % 8 == 0).
extern "C" int pct_dense_mm_bf16(const void* x, const void* w, void* out, int N, int K, int M,
                                 void* stream) {
  return launch<BF16>(x, w, out, N, K, M, stream);
}
