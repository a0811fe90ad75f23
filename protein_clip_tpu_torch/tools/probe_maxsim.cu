// A probe, not a kernel of the port: readings that tools/probe_maxsim.py
// takes beside K4 (csrc/filip_maxsim.cu) and its patched variants: the host
// time of encoding K4's two tensor maps, and the tensor core's TF32 rate for
// the products K4 issues (below).

#include "filip_maxsim.cu"

#include <chrono>

// Mean host microseconds to encode K4's two tensor maps, over iters.
extern "C" double pct_probe_encode_us(const void* ha, const void* hb, int Ba, int Bb, int TA,
                                      int TB, int D, int iters) {
  CUtensorMap a, b;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) {
    if (!pct_maxsim::token_map(&a, ha, Ba, TA, D) || !pct_maxsim::token_map(&b, hb, Bb, TB, D)) {
      return -1.0;
    }
  }
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / iters;
}

// ---------------------------------------------------------------------------
// The tensor core's TF32 rate for the products K4 issues, alone: one block
// of one warpgroup per SM (or two an SM), each issuing groups of 12 wgmma
// m64nNk8.f32.tf32.tf32 on fixed operands, one group in flight while the
// next is issued. mode 0: A from registers, N = 64 (as K4); 1: A from
// registers, N = 128; 2: A and B from shared memory, N = 64.
// ---------------------------------------------------------------------------

namespace {

using namespace pct_hopper;

__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

constexpr int kRateSmem = 33 * 1024;

__global__ void __launch_bounds__(128) wgmma_rate_kernel(int mode, int groups, float* out) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  uint32_t a[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0x3f800000u ^ ((threadIdx.x + i + j) << 13);
  }
  for (int it = 0; it < groups; ++it) {
    fence_operands(a);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      const uint64_t b = smem_desc(base + 32 * (k & 3), 16, 1024);
      if (mode == 0) {
        wgmma_tf32(reinterpret_cast<float(&)[32]>(acc), a[k & 3], b, 1);
      } else if (mode == 1) {
        wgmma_tf32_n128(acc, a[k & 3], b);
      } else {
        wgmma_tf32_ss(reinterpret_cast<float(&)[32]>(acc),
                      smem_desc(base + 16384 + 32 * (k & 3), 16, 1024), b);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(a);
  }
  wgmma_wait<0>();
  fence_operands(acc);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) s += acc[i];
  out[blockIdx.x * 128 + threadIdx.x] = s;
}

}  // namespace

// TFLOP/s of `blocks` blocks of wgmma_rate_kernel in `mode`, by CUDA events
// over a second launch (the first warms up); out holds blocks * 128 floats.
// Negative on a CUDA error.
extern "C" double pct_probe_wgmma_rate(int mode, int blocks, int groups, void* out) {
  cudaFuncSetAttribute(wgmma_rate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kRateSmem);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float ms = 0.f;
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(e0);
    wgmma_rate_kernel<<<blocks, 128, kRateSmem>>>(mode, groups, static_cast<float*>(out));
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
  }
  cudaEventElapsedTime(&ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  if (cudaGetLastError() != cudaSuccess) return -1.0;
  const double n = mode == 1 ? 128 : 64;
  return 2.0 * 64 * n * 8 * 12 * groups * blocks / (ms * 1e9);
}
