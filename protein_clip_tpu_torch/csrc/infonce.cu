// Symmetric InfoNCE over (B, D) f32 embeddings, forward and backward,
// Hopper: kernels K2 (single-shot) and K3 (tiled, large pools).
//
// Replaces protein_clip_tpu/ops/infonce_pallas.py: K2 = _fwd_kernel and
// _bwd_kernel (the fused_infonce custom VJP), K3 = _fwd_tiled_kernel,
// _lse_tiled_kernel and _bwd_tiled_kernel (fused_infonce_tiled). Same
// function: with logits l = X Y^T in f32 and diag_i = sum_d x_i y_i (taken
// row by row, not read off the logit tile),
//   loss = 0.5 * (sum_i (lse_r[i] - diag_i) + sum_j (lse_c[j] - diag_j)) / B
//   dL   = g / (2B) * (exp(l - lse_r) + exp(l - lse_c) - 2 I),
//   dX   = dL Y,  dY = dL^T X,
// where lse_r and lse_c are the row and column log-sum-exps of l and g the
// cotangent of the loss, read from device memory.
//
// Bound on an H100 SXM: the forward does 2*B*B*D FLOP, forward plus
// backward at least 6*B*B*D (the logits once, dX, dY); the bytes are X and
// Y read once and dX, dY written once (16*B*D). At the train step's
// (B, D) = (256, 128), forward plus backward is 50.3 MFLOP, 0.75 us against
// the f32 CUDA-core peak of about 67 TFLOP/s (the 0.5 MB take 0.16 us at
// 3.35 TB/s), and the forward alone 16.8 MFLOP, 0.25 us: far under a
// launch's latency, so at this size the kernels are bound by launch
// latency, not by the chip. K3 at (1024, 128) is 0.81 GFLOP, 12 us; at
// (4096, 128) 12.9 GFLOP, 192 us. The products stay f32 FFMA on the CUDA
// cores, as the TPU package computes them in f32: the loss is an f32
// log-sum-exp of logits up to exp(t), and the gradients feed Adam, so TF32's
// three decimal digits are not used. 3xTF32 on the tensor cores (wgmma, 495
// TFLOP/s TF32 dense) is what a redesign could reach.
//
// Design. The TPU kernels kept the whole (B, B) logits in VMEM (256 KB at
// B = 256, more than a block's 227 KB of shared memory) or carried the
// column log-sum-exp and dY across an in-order grid; neither exists here.
// The forward is a 2D grid of 64 x 64 logit tiles, one block each: it
// stages 64 rows of X and of Y in shared memory (rows padded to D + 4
// floats so float4 reads of 16 rows hit distinct banks), each of 256
// threads computes a 4 x 4 register tile with FFMA, and the block writes
// one (max, sum of exp) partial per row and per column of its tile to a
// scratch buffer, and diag for its rows if it is on the diagonal. The
// partials are combined in a fixed order (max first, then the rescaled
// sum), so the result does not depend on which block ran first and no
// float atomics are used: the loss is deterministic.
//   K2 (pools up to 256): one launch; the last block to finish (a
//     __threadfence and an atomic ticket) combines all partials and writes
//     loss, lse_r and lse_c.
//   K3 (larger pools): the tile launch, then a combine launch over blocks
//     of 256 indices, whose last block sums the per-block loss terms in
//     order.
// The backward (K2 and K3 alike: its cost is the products, not the
// combine) recomputes each logit tile from X, Y and the saved lse_r,
// lse_c. A block owns 64 rows of dX (over X's row blocks) or of dY (over
// Y's row blocks, with X and Y swapped: l^T is the same function), streams
// a range of the other side's 64-row tiles, writes each 64 x 64 dL tile to
// shared memory and accumulates dL . tile in registers in f32. The tile
// range is split over `splits` blocks so that rows x splits x 2 roles fill
// the SMs twice over (a first version walked all tiles in one block per
// row block: 16 blocks at B = 1024); each block writes its partial rows
// once, and a second launch sums the splits in a fixed order, so there are
// no atomics and the gradients are deterministic. Rows and columns past B
// are staged as zeros and masked out of every max, sum and dL.
//
// Built by protein_clip_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (plain C interface below).

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kTile = 64;         // rows of a tile on either side
constexpr int kSide = 16;         // 16 x 16 threads, each owns a 4 x 4 logit tile
constexpr int kThreads = kSide * kSide;
constexpr int kWarps = kThreads / 32;
constexpr int kDlStride = kTile + 1;
constexpr float kNeg = -FLT_MAX;

// Offsets into the forward's scratch buffer (floats), for B rows and
// nb = ceil(B / 64) tiles per side; ops/infonce.py allocates
// scratch_floats(B) = 4 * nb * B + B + ceil(B / 256).
struct Scratch {
  float* row_m;   // [nb column tiles][B] row maxima
  float* row_s;   // [nb][B] row sums of exp(l - max)
  float* col_m;   // [nb row tiles][B]
  float* col_s;   // [nb][B]
  float* diag;    // [B]
  float* part;    // [ceil(B / 256)] per-block loss terms of the K3 combine
  __device__ Scratch(float* base, int B, int nb) {
    const int64_t plane = static_cast<int64_t>(nb) * B;
    row_m = base;
    row_s = row_m + plane;
    col_m = row_s + plane;
    col_s = col_m + plane;
    diag = col_s + plane;
    part = diag + B;
  }
};

// Rows [r0, r0 + 64) of a (n, D) matrix into a (64, D + 4) tile; rows past
// n are zeros.
__device__ __forceinline__ void stage(float* tile, const float* src, int r0, int n, int D) {
  const int d4 = D >> 2;
  const int stride = D + 4;
  for (int c = threadIdx.x; c < kTile * d4; c += kThreads) {
    const int r = c / d4;
    const int k = c - r * d4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) {
      v = *reinterpret_cast<const float4*>(src + static_cast<int64_t>(r0 + r) * D + 4 * k);
    }
    *reinterpret_cast<float4*>(tile + r * stride + 4 * k) = v;
  }
}

// acc[r][c] = <as[ty + 16 r], bs[tx + 16 c]> over D, in f32 FFMA.
__device__ __forceinline__ void tile_dot(const float* as, const float* bs, int D, int ty,
                                         int tx, float acc[4][4]) {
  const int stride = D + 4;
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
    for (int r = 0; r < 4; ++r) av[r] = *reinterpret_cast<const float4*>(ap + r * kSide * stride + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = *reinterpret_cast<const float4*>(bp + c * kSide * stride + d);
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

// log sum_k s_k exp(m_k) over the n partials (m_k, s_k) at m[k * stride],
// s[k * stride], in order k = 0 .. n - 1. Reads through L2 (another block
// of this launch may have written them).
__device__ __forceinline__ float combine(const float* m, const float* s, int n, int64_t stride) {
  float mx = kNeg;
  for (int k = 0; k < n; ++k) mx = fmaxf(mx, __ldcg(m + k * stride));
  float sum = 0.f;
  for (int k = 0; k < n; ++k) sum += __ldcg(s + k * stride) * expf(__ldcg(m + k * stride) - mx);
  return mx + logf(sum);
}

// lse_r, lse_c of index i and its loss term (lse_r - diag) + (lse_c - diag).
__device__ __forceinline__ float finish_index(const Scratch& sc, int i, int B, int nb,
                                              float* lse_r, float* lse_c) {
  const float lr = combine(sc.row_m + i, sc.row_s + i, nb, B);
  const float lc = combine(sc.col_m + i, sc.col_s + i, nb, B);
  const float d = __ldcg(sc.diag + i);
  lse_r[i] = lr;
  lse_c[i] = lc;
  return (lr - d) + (lc - d);
}

// True in every thread of the block that finishes last of the launch's
// `blocks`; the caller's global writes are visible to that block.
__device__ __forceinline__ bool last_block(unsigned* ticket, unsigned blocks) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(ticket, 1u) == blocks - 1;
  __syncthreads();
  if (is_last) __threadfence();
  return is_last;
}

// grid (nb, nb): block (cb, rb) owns the logit tile of X rows [64 rb, +64)
// and Y rows [64 cb, +64). Writes the tile's row and column partials (and
// diag on the diagonal). With combine_here (K2) the last block also writes
// lse_r, lse_c and the loss.
__global__ void __launch_bounds__(kThreads)
infonce_fwd_tiles(const float* __restrict__ x, const float* __restrict__ y,
                  float* __restrict__ scratch, unsigned* __restrict__ ticket,
                  float* __restrict__ loss, float* __restrict__ lse_r,
                  float* __restrict__ lse_c, int B, int D, int combine_here) {
  extern __shared__ __align__(16) float smem[];
  const int stride = D + 4;
  float* xs = smem;                         // [64][D + 4]
  float* ys = xs + kTile * stride;          // [64][D + 4]
  float* red_m = ys + kTile * stride;       // [16][64] per-thread column maxima
  float* red_s = red_m + kSide * kTile;     // [16][64] per-thread column sums
  float* cmax = red_s + kSide * kTile;      // [64] the tile's column maxima

  const int nb = gridDim.x;
  const Scratch sc(scratch, B, nb);
  const int tid = threadIdx.x;
  const int tx = tid & (kSide - 1);  // owns columns tx + 16 c of the tile
  const int ty = tid / kSide;        // owns rows ty + 16 r
  const int cb = blockIdx.x;
  const int rb = blockIdx.y;
  const int r0 = rb * kTile;
  const int c0 = cb * kTile;

  stage(xs, x, r0, B, D);
  stage(ys, y, c0, B, D);
  __syncthreads();
  float acc[4][4];
  tile_dot(xs, ys, D, ty, tx, acc);
  bool row_ok[4], col_ok[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    row_ok[k] = r0 + ty + kSide * k < B;
    col_ok[k] = c0 + tx + kSide * k < B;
  }

  // Row partials over this tile's valid columns: the 16 threads of a
  // half-warp that share a row (lanes differing in their low four bits)
  // combine theirs. Every tile has a valid column, so m is finite.
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float m = kNeg;
#pragma unroll
    for (int c = 0; c < 4; ++c) m = col_ok[c] ? fmaxf(m, acc[r][c]) : m;
#pragma unroll
    for (int o = 1; o < kSide; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) s += col_ok[c] ? expf(acc[r][c] - m) : 0.f;
#pragma unroll
    for (int o = 1; o < kSide; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const int i = r0 + ty + kSide * r;
    if (tx == 0 && row_ok[r]) {
      sc.row_m[static_cast<int64_t>(cb) * B + i] = m;
      sc.row_s[static_cast<int64_t>(cb) * B + i] = s;
    }
  }

  // Column partials over this tile's valid rows, through shared memory:
  // the maxima first, then the sums against them.
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float m = kNeg;
#pragma unroll
    for (int r = 0; r < 4; ++r) m = row_ok[r] ? fmaxf(m, acc[r][c]) : m;
    red_m[ty * kTile + tx + kSide * c] = m;
  }
  __syncthreads();
  if (tid < kTile) {
    float m = kNeg;
    for (int k = 0; k < kSide; ++k) m = fmaxf(m, red_m[k * kTile + tid]);
    cmax[tid] = m;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float m = cmax[tx + kSide * c];
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) s += row_ok[r] ? expf(acc[r][c] - m) : 0.f;
    red_s[ty * kTile + tx + kSide * c] = s;
  }
  __syncthreads();
  if (tid < kTile && c0 + tid < B) {
    float s = 0.f;
    for (int k = 0; k < kSide; ++k) s += red_s[k * kTile + tid];
    sc.col_m[static_cast<int64_t>(rb) * B + c0 + tid] = cmax[tid];
    sc.col_s[static_cast<int64_t>(rb) * B + c0 + tid] = s;
  }

  // diag_i = sum_d x_i y_i, row by row, on the diagonal tiles.
  if (rb == cb && tid < kTile && r0 + tid < B) {
    float d = 0.f;
    for (int k = 0; k < D; ++k) d = fmaf(xs[tid * stride + k], ys[tid * stride + k], d);
    sc.diag[r0 + tid] = d;
  }

  if (!combine_here || !last_block(ticket, gridDim.x * gridDim.y)) return;
  float part = 0.f;
  for (int i = tid; i < B; i += kThreads) part += finish_index(sc, i, B, nb, lse_r, lse_c);
  const float total = block_sum(part, red_m);
  if (tid == 0) {
    *loss = 0.5f * total / static_cast<float>(B);
    *ticket = 0u;
  }
}

// K3's combine: grid ceil(B / 256), one index per thread; the last block
// sums the per-block loss terms in block order.
__global__ void __launch_bounds__(kThreads)
infonce_combine(float* __restrict__ scratch, unsigned* __restrict__ ticket,
                float* __restrict__ loss, float* __restrict__ lse_r,
                float* __restrict__ lse_c, int B, int nb) {
  __shared__ float red[kWarps];
  const Scratch sc(scratch, B, nb);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float term = i < B ? finish_index(sc, i, B, nb, lse_r, lse_c) : 0.f;
  const float total = block_sum(term, red);
  if (threadIdx.x == 0) sc.part[blockIdx.x] = total;
  if (!last_block(ticket, gridDim.x)) return;
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (unsigned k = 0; k < gridDim.x; ++k) sum += __ldcg(sc.part + k);
    *loss = 0.5f * sum / static_cast<float>(B);
    *ticket = 0u;
  }
}

// grid (nb, splits, 2): block (ab, sp, role) takes rows [64 ab, +64) of
// dX (role 0: A = X, the other side Y) or of dY (role 1: A = Y, the other
// side X) over the other side's tiles [sp * tiles_per_split, +tiles_per_split)
// and writes its sum to part[role][sp] (splits > 1, summed in order by
// infonce_bwd_reduce) or straight to dX / dY (splits == 1).
// NC = ceil(D / 64) float4 columns per thread and row.
template <int NC>
__global__ void __launch_bounds__(kThreads)
infonce_bwd(const float* __restrict__ x, const float* __restrict__ y,
            const float* __restrict__ lse_r, const float* __restrict__ lse_c,
            const float* __restrict__ g, float* __restrict__ dx, float* __restrict__ dy,
            float* __restrict__ part, int B, int D, int tiles_per_split) {
  extern __shared__ __align__(16) float smem[];
  const int stride = D + 4;
  float* as = smem;                    // [64][D + 4] this block's rows of A
  float* bs = as + kTile * stride;     // [64][D + 4] a tile of the other side
  float* dl = bs + kTile * stride;     // [64][65] the dL tile, A rows by other rows

  const bool dy_role = blockIdx.z == 1;
  const float* a = dy_role ? y : x;
  const float* b = dy_role ? x : y;
  const float* lse_a = dy_role ? lse_c : lse_r;
  const float* lse_b = dy_role ? lse_r : lse_c;
  const int splits = gridDim.y;
  float* out = splits == 1 ? (dy_role ? dy : dx)
                           : part + (static_cast<int64_t>(blockIdx.z) * splits + blockIdx.y) * B * D;

  const int tid = threadIdx.x;
  const int tx = tid & (kSide - 1);
  const int ty = tid / kSide;
  const int a0 = blockIdx.x * kTile;
  const float scale = __ldg(g) / (2.f * static_cast<float>(B));

  stage(as, a, a0, B, D);
  float la[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = a0 + ty + kSide * r;
    la[r] = i < B ? lse_a[i] : 0.f;
  }
  float4 o[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < NC; ++q) o[r][q] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int sp = static_cast<int>(blockIdx.y);
  const int b_end = min(B, (sp + 1) * tiles_per_split * kTile);
  for (int b0 = sp * tiles_per_split * kTile; b0 < b_end; b0 += kTile) {
    __syncthreads();  // readers of the previous tile and dL are done
    stage(bs, b, b0, B, D);
    __syncthreads();
    float acc[4][4];
    tile_dot(as, bs, D, ty, tx, acc);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = b0 + tx + kSide * c;
      const float lb = j < B ? lse_b[j] : 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = a0 + ty + kSide * r;
        float v = 0.f;
        if (j < B) {
          v = expf(acc[r][c] - la[r]) + expf(acc[r][c] - lb) - (i == j ? 2.f : 0.f);
          v *= scale;
        }
        dl[(ty + kSide * r) * kDlStride + tx + kSide * c] = v;
      }
    }
    __syncthreads();
    // o[r] += sum_k dL[row r][k] * bs[k] over this tile's 64 rows.
#pragma unroll 4
    for (int k = 0; k < kTile; ++k) {
      float av[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = dl[(ty + kSide * r) * kDlStride + k];
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const int col = 4 * tx + 64 * q;
        if (col < D) {
          const float4 bv = *reinterpret_cast<const float4*>(bs + k * stride + col);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            o[r][q].x = fmaf(av[r], bv.x, o[r][q].x);
            o[r][q].y = fmaf(av[r], bv.y, o[r][q].y);
            o[r][q].z = fmaf(av[r], bv.z, o[r][q].z);
            o[r][q].w = fmaf(av[r], bv.w, o[r][q].w);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = a0 + ty + kSide * r;
    if (i >= B) continue;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int col = 4 * tx + 64 * q;
      if (col < D) *reinterpret_cast<float4*>(out + static_cast<int64_t>(i) * D + col) = o[r][q];
    }
  }
}

// dX, dY = the sum over sp = 0 .. splits - 1, in that order, of
// part[role][sp]; grid (ceil(B D / 4 / 256), 2), one float4 per thread.
__global__ void __launch_bounds__(kThreads)
infonce_bwd_reduce(const float* __restrict__ part, float* __restrict__ dx,
                   float* __restrict__ dy, int B, int D, int splits) {
  const int64_t n4 = static_cast<int64_t>(B) * D / 4;
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= n4) return;
  const float4* src = reinterpret_cast<const float4*>(part) + blockIdx.y * splits * n4 + k;
  float4 acc = src[0];
  for (int sp = 1; sp < splits; ++sp) {
    const float4 v = src[sp * n4];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  reinterpret_cast<float4*>(blockIdx.y == 1 ? dy : dx)[k] = acc;
}

int fwd_smem(int D) { return static_cast<int>(sizeof(float)) * (2 * kTile * (D + 4) + 2 * kSide * kTile + kTile); }
int bwd_smem(int D) { return static_cast<int>(sizeof(float)) * (2 * kTile * (D + 4) + kTile * kDlStride); }

cudaError_t launch_fwd_tiles(const void* x, const void* y, void* scratch, void* ticket,
                             void* loss, void* lse_r, void* lse_c, int B, int D,
                             int combine_here, cudaStream_t stream) {
  const int smem = fwd_smem(D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        infonce_fwd_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int nb = (B + kTile - 1) / kTile;
  infonce_fwd_tiles<<<dim3(nb, nb), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<float*>(scratch),
      static_cast<unsigned*>(ticket), static_cast<float*>(loss), static_cast<float*>(lse_r),
      static_cast<float*>(lse_c), B, D, combine_here);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_bwd_nc(const void* x, const void* y, const void* lse_r, const void* lse_c,
                          const void* g, void* dx, void* dy, void* part, int B, int D,
                          int splits, int tiles_per_split, cudaStream_t stream) {
  const int smem = bwd_smem(D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        infonce_bwd<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int nb = (B + kTile - 1) / kTile;
  infonce_bwd<NC><<<dim3(nb, splits, 2), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(lse_r), static_cast<const float*>(lse_c),
      static_cast<const float*>(g), static_cast<float*>(dx), static_cast<float*>(dy),
      static_cast<float*>(part), B, D, tiles_per_split);
  return cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` (a cudaStream_t) and returns
// cudaGetLastError(): 0 when every launch was accepted. x, y (B, D) f32
// contiguous and 16-byte aligned, D a multiple of 4 in [4, 256], B >= 1
// (the Python wrapper checks all of it). `ticket` is one zeroed uint32,
// which the last block sets back to 0; `scratch` holds scratch_floats(B)
// floats (see Scratch); loss is one float, lse_r and lse_c B floats each.

// K2 forward: one launch.
extern "C" int pct_infonce_fwd(const void* x, const void* y, void* scratch, void* ticket,
                               void* loss, void* lse_r, void* lse_c, int B, int D,
                               void* stream) {
  return static_cast<int>(launch_fwd_tiles(x, y, scratch, ticket, loss, lse_r, lse_c, B, D, 1,
                                           static_cast<cudaStream_t>(stream)));
}

// K3 forward: the tile launch, then the combine launch.
extern "C" int pct_infonce_tiled_fwd(const void* x, const void* y, void* scratch, void* ticket,
                                     void* loss, void* lse_r, void* lse_c, int B, int D,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_fwd_tiles(x, y, scratch, ticket, loss, lse_r, lse_c, B, D, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = (B + kTile - 1) / kTile;
  infonce_combine<<<(B + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<float*>(scratch), static_cast<unsigned*>(ticket), static_cast<float*>(loss),
      static_cast<float*>(lse_r), static_cast<float*>(lse_c), B, nb);
  return static_cast<int>(cudaGetLastError());
}

// K2 and K3 backward: the split tile launch, then (splits > 1) the
// in-order reduction. g is the loss's cotangent (one float on the device);
// part holds 2 * splits * B * D floats when splits > 1, and
// splits * tiles_per_split covers ceil(B / 64) tiles.
extern "C" int pct_infonce_bwd(const void* x, const void* y, const void* lse_r,
                               const void* lse_c, const void* g, void* dx, void* dy, void* part,
                               int B, int D, int splits, int tiles_per_split, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((D + 63) / 64) {
    case 1: err = launch_bwd_nc<1>(x, y, lse_r, lse_c, g, dx, dy, part, B, D, splits, tiles_per_split, s); break;
    case 2: err = launch_bwd_nc<2>(x, y, lse_r, lse_c, g, dx, dy, part, B, D, splits, tiles_per_split, s); break;
    case 3: err = launch_bwd_nc<3>(x, y, lse_r, lse_c, g, dx, dy, part, B, D, splits, tiles_per_split, s); break;
    case 4: err = launch_bwd_nc<4>(x, y, lse_r, lse_c, g, dx, dy, part, B, D, splits, tiles_per_split, s); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t n4 = static_cast<int64_t>(B) * D / 4;
  infonce_bwd_reduce<<<dim3(static_cast<unsigned>((n4 + kThreads - 1) / kThreads), 2), kThreads,
                       0, s>>>(static_cast<const float*>(part), static_cast<float*>(dx),
                               static_cast<float*>(dy), B, D, splits);
  return static_cast<int>(cudaGetLastError());
}
