// FILIP masked token max-sim (f32), Hopper.
//
// Replaces protein_clip_tpu/ops/filip_pallas.py::_maxsim_kernel (launched by
// _maxsim_call). Same function: for every pair (i, j) of a rectangular
// (Ba, Bb) grid, the score of a-token s and b-token u is <ha[i,s], hb[j,u]> in
// f32 where ma[i,s] * mb[j,u] > 0 and f32-min otherwise;
//   oa[i,j] = sum_s clamp(max_u score) * ma[i,s] / max(sum_s ma[i,s], 1e-6)
//   ob[i,j] = sum_u clamp(max_s score) * mb[j,u] / max(sum_u mb[j,u], 1e-6)
// where clamp maps a max that stayed <= f32-min (no valid token on the
// other side) to 0 BEFORE the sum, so a candidate with an empty mask scores
// 0 and not -inf. The temperature is divided out by the caller.
//
// Bound on an H100 SXM: the function does 2*Ba*Bb*TA*TB*D FLOP and must move
// ha, hb, both masks and both outputs once (4*(Ba*TA*D + Bb*TB*D) +
// 4*(Ba*TA + Bb*TB) + 8*Ba*Bb bytes). At the scorer's shapes it is bound by
// operations: (4, 256, 128, 512) at D=128 is 17.18 GFLOP against 68 MB, and
// one full block of the ragged scorer, (64, 1024, 256, 256), is 1.10 TFLOP
// against 143 MB. Against the f32 CUDA-core peak of about 67 TFLOP/s that is
// 0.256 ms and 16.4 ms; the bytes take 0.020 ms and 0.043 ms at 3.35 TB/s.
// The scores stay f32 on the CUDA cores (FFMA): the index is f32 and /topk
// ranks by these scores, so TF32's three decimal digits would reorder
// near-ties. A redesign with 3xTF32 on the tensor cores (wgmma, 495 TFLOP/s
// TF32 dense) could approach the bytes bound.
//
// Design: the TPU kernel streamed hb[j] through VMEM in TB chunks against the
// whole of ha[i] and wrote one scalar per grid step into SMEM output rows;
// those were VMEM and Mosaic limits, not carried over. Here one block of 256
// threads owns one pair (i, j). It stages a 64-token tile of ha[i] in shared
// memory and streams hb[j] through 64-token tiles; each thread computes a
// 4 x 4 register tile of the 64 x 64 score tile with float4 shared-memory
// reads (rows padded to D + 4 floats, so the 16 b-rows of a half-warp hit
// distinct banks) and FFMA. Each thread keeps the running max of its four
// a-rows across the TB tiles; the column maxes of the whole TB live in shared
// memory (TB floats) and accumulate across the TA tiles. Tokens past TA or TB
// (any length, not only multiples of 64) are staged as zeros with mask 0, so
// they score f32-min like masked ones. The block writes oa[i,j] and ob[i,j]
// itself, with fixed-order reductions and no atomics: the result is
// deterministic.
//
// Built by protein_clip_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (plain C interface below).

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kTile = 64;        // tokens per a-tile and per b-tile
constexpr int kSide = 16;        // 16 x 16 threads, each owns a 4 x 4 score tile
constexpr int kThreads = kSide * kSide;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -FLT_MAX;  // the TPU kernel's jnp.finfo(f32).min

// Tokens [t0, t0 + 64) of one (T, D) row into a (64, D + 4) tile and their
// mask values, as floats, into mtile; tokens past T are zeros with mask 0.
__device__ __forceinline__ void stage(float* tile, float* mtile, const float* src,
                                      const int32_t* msrc, int t0, int T, int D) {
  const int d4 = D >> 2;
  const int stride = D + 4;
  for (int c = threadIdx.x; c < kTile * d4; c += kThreads) {
    const int r = c / d4;
    const int k = c - r * d4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < T) {
      v = *reinterpret_cast<const float4*>(src + static_cast<int64_t>(t0 + r) * D + 4 * k);
    }
    *reinterpret_cast<float4*>(tile + r * stride + 4 * k) = v;
  }
  if (threadIdx.x < kTile) {
    const int t = t0 + threadIdx.x;
    mtile[threadIdx.x] = t < T ? static_cast<float>(msrc[t]) : 0.f;
  }
}

// Sum over the block in a fixed order; the result is valid in thread 0.
// scratch holds kWarps floats.
__device__ __forceinline__ float block_sum(float x, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  __syncthreads();  // scratch is free
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = x;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) total += scratch[w];
  }
  return total;
}

// grid (Bb, Ba), 256 threads, dynamic shared memory as in pct_filip_maxsim.
// ha (Ba, TA, D), hb (Bb, TB, D) f32; ma (Ba, TA), mb (Bb, TB) int32;
// oa, ob (Ba, Bb) f32; all contiguous, D a multiple of 4.
__global__ void __launch_bounds__(kThreads)
filip_maxsim_kernel(const float* __restrict__ ha, const float* __restrict__ hb,
                    const int32_t* __restrict__ ma, const int32_t* __restrict__ mb,
                    float* __restrict__ oa, float* __restrict__ ob,
                    int Bb, int TA, int TB, int D) {
  extern __shared__ __align__(16) float smem[];
  const int stride = D + 4;
  float* as = smem;                        // [64][D + 4] a-tile
  float* bs = as + kTile * stride;         // [64][D + 4] b-tile
  float* red = bs + kTile * stride;        // [16][64] partial column maxes
  float* maf = red + kSide * kTile;        // [64] a-tile mask
  float* mbf = maf + kTile;                // [64] b-tile mask
  float* colmax = mbf + kTile;             // [TB] column max over all of TA

  const int tid = threadIdx.x;
  const int tx = tid & (kSide - 1);  // owns b-tokens tx + 16 c of a tile
  const int ty = tid / kSide;        // owns a-tokens ty + 16 r of a tile
  const int64_t i = blockIdx.y;
  const int64_t j = blockIdx.x;
  const float* a_src = ha + i * TA * D;
  const float* b_src = hb + j * TB * D;
  const int32_t* ma_src = ma + i * TA;
  const int32_t* mb_src = mb + j * TB;

  for (int t = tid; t < TB; t += kThreads) colmax[t] = kNeg;
  float row_part = 0.f;  // this thread's share of sum_s clamp(row max) * ma

  for (int a0 = 0; a0 < TA; a0 += kTile) {
    __syncthreads();  // readers of the previous a-tile and its mask are done
    stage(as, maf, a_src, ma_src, a0, TA, D);
    float rmax[4] = {kNeg, kNeg, kNeg, kNeg};

    for (int b0 = 0; b0 < TB; b0 += kTile) {
      __syncthreads();  // readers of the previous b-tile and of red are done
      stage(bs, mbf, b_src, mb_src, b0, TB, D);
      __syncthreads();

      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      }
      const float* ap = as + ty * stride;
      const float* bp = bs + tx * stride;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 av[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          av[r] = *reinterpret_cast<const float4*>(ap + r * kSide * stride + d);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          bv[c] = *reinterpret_cast<const float4*>(bp + c * kSide * stride + d);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[r][c] = fmaf(av[r].x, bv[c].x, acc[r][c]);
            acc[r][c] = fmaf(av[r].y, bv[c].y, acc[r][c]);
            acc[r][c] = fmaf(av[r].z, bv[c].z, acc[r][c]);
            acc[r][c] = fmaf(av[r].w, bv[c].w, acc[r][c]);
          }
        }
      }

      // Mask to f32-min, then this thread's row and column maxes.
      float cmax[4] = {kNeg, kNeg, kNeg, kNeg};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float wa = maf[ty + kSide * r];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float s = wa * mbf[tx + kSide * c] > 0.f ? acc[r][c] : kNeg;
          rmax[r] = fmaxf(rmax[r], s);
          cmax[c] = fmaxf(cmax[c], s);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) red[ty * kTile + tx + kSide * c] = cmax[c];
      __syncthreads();
      if (tid < kTile && b0 + tid < TB) {
        float m = colmax[b0 + tid];
        for (int y = 0; y < kSide; ++y) m = fmaxf(m, red[y * kTile + tid]);
        colmax[b0 + tid] = m;
      }
    }

    // Each a-row's max over all of TB: the 16 threads of a half-warp that
    // share the row (lanes differing in their low four bits) combine theirs.
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float m = rmax[r];
#pragma unroll
      for (int o = 1; o < kSide; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (tx == 0) row_part += (m <= kNeg ? 0.f : m) * maf[ty + kSide * r];
    }
  }
  __syncthreads();  // the last column-max updates are visible

  float cnt_a = 0.f;
  for (int t = tid; t < TA; t += kThreads) cnt_a += static_cast<float>(ma_src[t]);
  float col_part = 0.f;
  float cnt_b = 0.f;
  for (int t = tid; t < TB; t += kThreads) {
    const float w = static_cast<float>(mb_src[t]);
    const float m = colmax[t];
    col_part += (m <= kNeg ? 0.f : m) * w;
    cnt_b += w;
  }
  const float sum_a = block_sum(row_part, red);
  const float n_a = block_sum(cnt_a, red);
  const float sum_b = block_sum(col_part, red);
  const float n_b = block_sum(cnt_b, red);
  if (tid == 0) {
    oa[i * Bb + j] = sum_a / fmaxf(n_a, 1e-6f);
    ob[i * Bb + j] = sum_b / fmaxf(n_b, 1e-6f);
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError(): 0 when
// the launch was accepted. Needs Ba <= 65535 and the shared memory below to
// fit the block's 227 KB (the Python wrapper checks both).
extern "C" int pct_filip_maxsim(const void* ha, const void* hb, const void* mask_a,
                                const void* mask_b, void* oa, void* ob, int Ba, int Bb,
                                int TA, int TB, int D, void* stream) {
  const int smem = static_cast<int>(sizeof(float)) *
                   (2 * kTile * (D + 4) + kSide * kTile + 2 * kTile + TB);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        filip_maxsim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(Bb, Ba);
  filip_maxsim_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ha), static_cast<const float*>(hb),
      static_cast<const int32_t*>(mask_a), static_cast<const int32_t*>(mask_b),
      static_cast<float*>(oa), static_cast<float*>(ob), Bb, TA, TB, D);
  return static_cast<int>(cudaGetLastError());
}
