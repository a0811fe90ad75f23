// Symmetric InfoNCE over (B, D) f32 embeddings, forward and backward,
// Hopper (sm_90a): kernels K2 (one cluster, pools up to 512) and K3 (tiled,
// large pools).
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
// Bound on an H100 SXM. Forward plus backward needs the logits once, dX
// and dY: 6 B^2 D products' worth of FLOP, each kept at f32 accuracy as
// three TF32 products (18 B^2 D at 495 TFLOP/s), against X and Y read and
// dX, dY written once (16 B D bytes at 3.35 TB/s). At the train step's
// (256, 128) that is 0.000305 ms: far under a launch's latency, so K2 is
// bound by its launches and the serial chain inside its one cluster; K3 at
// (1024, 128) 0.004881 ms and at (4096, 128) 0.078093 ms, bound by the
// products. The design before this one (tools/probe_infonce_ffma.cu) ran
// f32 FFMA on the CUDA cores (a 67 TFLOP/s ceiling, 0.192312 ms at 4096),
// formed every logit tile twice in its backward (once for the dX rows, once
// for the dY rows) and summed the backward's split partials through device
// memory in a second launch.
//
// Design.
//   - Products on the tensor cores at f32 accuracy: 3xTF32 through wgmma
//     m64nNk8.f32.tf32.tf32 with A from registers. Each operand x is split
//     into hi = tf32(x) (rounded) and lo = tf32(x - hi), and hi.hi + hi.lo +
//     lo.hi accumulate in f32. TF32 wgmma takes K-major operands only, and
//     the backward's products contract over the pool, so there the
//     embedding tiles (whose D is contiguous) are fed as A from registers,
//     transposed by the fragment loads (dX^T = Y^T dL^T, dY^T = X^T dL),
//     and the dL tile is written to shared memory twice, row-major and
//     transposed, each split into hi and lo, as the B operands.
//   - f32 accuracy also in what the tensor core adds: its f32 adds round
//     toward zero, an error proportional to what it accumulates, so the
//     backward's products take the embedding rows less their tile mean, the
//     mean's part (dL's row or column sums times it) added in f32, and what
//     the tensor core accumulates stays small where the rows are alike (a
//     train step's embeddings; their gradients' sums over the rows cancel);
//     dL's
//     diagonal entries stay out of the tiles and come in once, in f32, at
//     each sum's last part (exact where they dominate dL, and a pool of one
//     gives 0). tools/probe_infonce.py reads the accuracy against float64.
//   - A block owns one 64 x 64 logit tile at a time, with two warpgroups:
//     each forms half of its columns (m64n32), both form dL, then warpgroup
//     0 makes the tile's dX part and warpgroup 1 its dY part (m64n64 per 64
//     floats of D). X rows are staged raw (split into fragments as they are
//     read, the next k-chunk's loads issued while a wgmma group runs), Y rows
//     split into hi and lo tiles (the B operand of the logits; 128-byte
//     swizzle), a window of 128 floats of D at a time (D up to 256 takes two
//     windows), zeros past B and D. diag is summed from the staging's loads.
//   - Each logit tile is formed once per backward and feeds both products.
//     The sums across blocks run in thread-block clusters of kRc x kCc
//     blocks that step through the tile grid in lockstep: the kCc blocks of
//     a cluster row sum their dX[r] parts, and the kRc blocks of a cluster
//     column their dY[c] parts, through distributed shared memory, in rank
//     order, each block a slice of D (the parts written over the Y tiles,
//     read as coalesced float4s); warpgroup 0 keeps its dX part in its
//     accumulators across the steps of one row tile and sends it at the
//     row's last step. While the exchange runs, the next tile's X and Y
//     rows are copied in (cp.async; Y over the free dL tiles).
//   - K2 (pools up to 512): one launch of one cluster over the whole logit
//     grid (at 256: 16 blocks, one tile each). The blocks' row and column
//     (max, sum of exp) partials stay in shared memory; after a cluster
//     barrier each block combines those of its rows and columns, and the
//     loss is summed in rank order. When a gradient is wanted the same
//     launch forms dL and writes dX and dY for g = 1 (the logits still in
//     registers at one tile a block); the backward only scales them by g
//     (infonce_scale). No scratch, ticket, fence or fill kernel.
//   - K3: a tile launch (one block per tile, partials to a scratch buffer,
//     two blocks an SM) and a combine launch (one cluster; the loss summed
//     in rank order) for the forward; for the backward, U x V clusters that
//     each sweep a range of row and of column super-blocks (in waves of
//     what the card holds at once; ops/infonce.py's sweep_clusters picks U
//     and V), forming each logit tile once from the saved log-sum-exps, and,
//     where U or V > 1, a reduce launch that adds the other ranges' partial
//     planes (U - 1 + V - 1 of B x D, against the old design's 2 x splits)
//     in order and scales by g.
// No float atomics; every sum runs in a fixed order: the results are
// deterministic.
// What bounds it now (PERF.md, from chip_smoke.py and tools/probe_infonce.py
// on an H100): every phase of a block's step is latency-bound with 8 warps
// an SM, and the phases run one after another. At (256, 128) K2 is one
// cluster's serial chain (staging, the logits, the partials' combine and
// the loss across the cluster, dL, the centred products, the exchange) and
// two launches. K3's backward is its sweep: the card holds 7 clusters of
// 16 blocks at once (211 KB of shared memory a block), and a step takes
// about 18 us at 4096, of which the products are about a third (logits
// 1.9, gradient products 4.4) and the exchange about half (the parts
// written and a cluster barrier 5.3, the sums 2.6); at 1024 the sweep
// runs 16 clusters of one step in three waves.
//
// Built by protein_clip_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (plain C interface below).

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "hopper.cuh"

namespace pct_infonce {

using namespace pct_hopper;

constexpr int kTile = 64;                  // rows of a logit tile on either side
constexpr int kWgs = 2;                    // warpgroups a block
constexpr int kThreads = 128 * kWgs;
constexpr int kHalf = kTile / kWgs;        // logit columns a warpgroup forms
constexpr int kWindow = 128;               // floats of D staged at once
constexpr int kChunkBytes = kTile * 128;   // one 32-float k-chunk of 64 rows: 8192
constexpr int kProducts = 3;  // TF32 products per k-step: hi.hi, hi.lo, lo.hi
constexpr int kRc = 4, kCc = 4;            // a cluster's blocks: rows x columns of tiles
constexpr int kCluster = kRc * kCc;
constexpr int kK2MaxPool = 512;            // K2's largest pool: one cluster
constexpr int kK2Tiles = kK2MaxPool / kTile;
constexpr int kK2Rows = (kK2Tiles + kRc - 1) / kRc;  // super-blocks of K2's largest pool
constexpr int kK2Cols = (kK2Tiles + kCc - 1) / kCc;
constexpr int kXStride = kWindow + 4;      // floats a staged X row: conflict-free fragments
constexpr int kCombineThreads = 512;
constexpr float kNeg = -FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;

// Byte offsets in a block's dynamic shared memory (from a 1024-aligned
// base). The tile launch uses the first kTileBytes; the cluster launch all.
constexpr int kYhi = 0;                               // Y window, hi: 4 k-chunks
constexpr int kYlo = kYhi + 4 * kChunkBytes;          // and lo
constexpr int kXs = kYlo + 4 * kChunkBytes;           // X window, raw: 64 x kXStride
constexpr int kExX = kYhi;     // dX part (64 i x window), over the Y tiles
constexpr int kExY = kYlo;     // dY part (64 j x window)
constexpr int kRed = kXs + kTile * kXStride * 4;      // reductions: kRedFloats
constexpr int kRedFloats = 2 * 2 * kTile + 8 * kHalf + kTile + 32;
constexpr int kDiag = kRed + kRedFloats * 4;          // diag of K2's diagonal tiles: kK2Rows x 64
constexpr int kTileBytes = kDiag + kTile * 4;
constexpr int kDlHi = (kDiag + kK2Rows * kTile * 4 + 1023) / 1024 * 1024;  // dL, rows i, k = j
constexpr int kDlLo = kDlHi + 2 * kChunkBytes;
constexpr int kDltHi = kDlLo + 2 * kChunkBytes;       // dL^T, rows j, k = i
constexpr int kDltLo = kDltHi + 2 * kChunkBytes;
constexpr int kLseR = kDltLo + 2 * kChunkBytes;       // lse of the rows: kK2Rows x 64
constexpr int kLseC = kLseR + kK2Rows * kTile * 4;    // of the columns: kK2Cols x 64
constexpr int kStats = kLseC + kK2Cols * kTile * 4;   // K2 partials: step x 4 x 64
constexpr int kAccX = kStats + kK2Rows * kK2Cols * 4 * kTile * 4;  // a row's dX sum (64 x window)
// The backward's centring: the tile's column means of X and Y over the
// window, their partial sums, and dL's row and column sums (partials).
constexpr int kCtr = kAccX + kTile * kWindow * 4;
constexpr int kColParts = kThreads * 4;  // a column partial per thread: one float4
constexpr int kCtrFloats = 2 * kWindow + 2 * kColParts + 2 * kTile + 4 * kTile;
constexpr int kClusterBytes = kCtr + kCtrFloats * 4;
static_assert(kTile * kWindow * 4 == 4 * kChunkBytes, "an exchange tile fits over a Y tile");
static_assert(kTile * kWindow * 4 <= 4 * kChunkBytes * 2, "a raw Y window fits over the dL tiles");
static_assert(kClusterBytes + 1024 <= 232448, "the cluster launch's shared memory");
static_assert(2 * (kTileBytes + 1024 + 1024) <= 233472, "two tile blocks an SM");

enum Mode : int { kLoss = 0, kLossGrads = 1, kSweep = 2 };

__host__ __device__ __forceinline__ int tiles_of(int B) { return (B + kTile - 1) / kTile; }

// The tiles a cross-block sum of partials runs over.
__device__ __forceinline__ int summed_tiles(int B) { return tiles_of(B); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp(a - b) as ex2((a - b) log2(e)): the difference first, so that its
// rounding is relative to it and not to a or b (the logits reach exp(t)),
// and exp(0) is exactly 1 (dL is exactly 0 where a pool of one cancels).
__device__ __forceinline__ float exp_diff(float a, float b) { return ex2((a - b) * kLog2e); }

// Lane, warp (within its warpgroup), warpgroup and thread within it.
struct Lane {
  int tid, wg, wt, w, g, t;
  __device__ Lane()
      : tid(threadIdx.x), wg(threadIdx.x >> 7), wt(threadIdx.x & 127), w((threadIdx.x >> 5) & 3),
        g((threadIdx.x & 31) >> 2), t(threadIdx.x & 3) {}
};

struct Params {
  const float* x;
  const float* y;
  const float* lse_r_in;  // kSweep: the forward's log-sum-exps
  const float* lse_c_in;
  const float* g;         // kSweep: the cotangent (one float); else unused
  float* loss;            // kLoss, kLossGrads
  float* lse_r;
  float* lse_c;
  float* dx;              // kLossGrads, kSweep
  float* dy;
  float* part;            // kSweep: (U - 1 + V - 1) planes of B x D
  float* dd;              // kLossGrads, kSweep: dL's diagonal (B floats, before g)
  int B, D, mode, U, V;
};

// ---------------------------------------------------------------------------
// Staging and products
// ---------------------------------------------------------------------------

// D's window w: its width, a multiple of 64 (zeros past D).
__device__ __forceinline__ int window_len(int D, int w) {
  const int rest = D - w * kWindow;
  return rest >= kWindow ? kWindow : (rest + 63) / 64 * 64;
}

// Staging puts the window [w0, w0 + len) of D of X rows [r0, r0 + 64) into
// xs (64 x kXStride floats, by cp.async) and of Y rows [c0, c0 + 64), split,
// into hi and lo tiles (k-chunk d / 32 of row j, 16-byte unit (d % 32) / 4
// at unit ^ (j % 8): the 128-byte swizzle); zeros past B rows and past D.
// A window's float4s: kPer a thread; 2^row_shift(len) a row.
constexpr int kPer = kTile * kWindow / 4 / kThreads;

__device__ __forceinline__ int row_shift(int len) { return len == kWindow ? 5 : 4; }

// A thread's float4s c = tid + kThreads b of a staged window share the
// column float4 tid % 2^sh and lie in rows tid / 2^sh + (kThreads / 2^sh) b:
// their sum (over b, in order) is the thread's partial of those columns'
// sums, written to col[tid]; the kThreads / 2^sh threads of a column's
// partials are combined by centres().
__device__ __forceinline__ void col_partial(float4* col, const float4 (&v)[kPer], int sh) {
  float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int b = 0; b < kPer; ++b) {
    if (threadIdx.x + b * kThreads >= (kTile << sh)) break;
    t = make_float4(t.x + v[b].x, t.y + v[b].y, t.z + v[b].z, t.w + v[b].w);
  }
  col[threadIdx.x] = t;
}

// Y's float4 c of the window as hi and lo into the split tiles.
__device__ __forceinline__ void put_y(uint32_t hi, uint32_t lo, int c, int sh, float4 v) {
  const int r = c >> sh, u = c & ((1 << sh) - 1);
  uint32_t h[4], l[4];
  split(v.x, h[0], l[0]);
  split(v.y, h[1], l[1]);
  split(v.z, h[2], l[2]);
  split(v.w, h[3], l[3]);
  const uint32_t off = (u >> 3) * kChunkBytes + r * 128 + (((u & 7) ^ (r & 7)) << 4);
  st_shared16(hi + off, h[0], h[1], h[2], h[3]);
  st_shared16(lo + off, l[0], l[1], l[2], l[3]);
}

// X's copies into xs, and (when yraw) Y's into yraw (64 x len floats,
// row-major), zero-filled; they land by cp_async_wait_all.
__device__ __forceinline__ void copy_async(float* xs, float* yraw, const float* x, const float* y,
                                           int r0, int c0, int B, int D, int w0, int len) {
  const int sh = row_shift(len);
#pragma unroll
  for (int b = 0; b < kPer; ++b) {
    const int c = threadIdx.x + b * kThreads;
    if (c >= (kTile << sh)) break;
    const int r = c >> sh, u = c & ((1 << sh) - 1), d = w0 + 4 * u;
    const bool okx = r0 + r < B && d < D;
    cp_async16(smem_u32(xs + r * kXStride + 4 * u),
               okx ? x + static_cast<int64_t>(r0 + r) * D + d : x, okx);
    if (yraw != nullptr) {
      const bool oky = c0 + r < B && d < D;
      cp_async16(smem_u32(yraw + 4 * c), oky ? y + static_cast<int64_t>(c0 + r) * D + d : y,
                 oky);
    }
  }
}

// A window staged: Y's float4s loaded into registers, all before the first
// is used. The caller fences and synchronises. With diag (a diagonal tile,
// r0 == c0: 64 floats of shared memory), the window's part of diag_i =
// sum_d x_i y_i is also formed from the same loads (X's float4s read
// again, from L2): the 2^sh lanes that hold a row's float4s sum their
// products over a fixed shuffle tree, and lane 0 of them writes the row's
// value (w0 == 0) or adds it (later windows).
__device__ __forceinline__ void stage(float* xs, uint32_t hi, uint32_t lo, const float* x,
                                      const float* y, int r0, int c0, int B, int D, int w0,
                                      int len, float* diag = nullptr, float4* ycol = nullptr) {
  copy_async(xs, nullptr, x, y, r0, c0, B, D, w0, len);
  const int sh = row_shift(len);
  float4 v[kPer];
  float dg[kPer];
#pragma unroll
  for (int b = 0; b < kPer; ++b) {
    const int c = threadIdx.x + b * kThreads;
    const int r = c >> sh, d = w0 + 4 * (c & ((1 << sh) - 1));
    const bool ok = c < (kTile << sh) && c0 + r < B && d < D;
    v[b] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) v[b] = __ldg(reinterpret_cast<const float4*>(y + static_cast<int64_t>(c0 + r) * D + d));
    dg[b] = 0.f;
    if (diag != nullptr && ok) {
      const float4 u =
          __ldg(reinterpret_cast<const float4*>(x + static_cast<int64_t>(r0 + r) * D + d));
      dg[b] = fmaf(u.w, v[b].w, fmaf(u.z, v[b].z, fmaf(u.y, v[b].y, u.x * v[b].x)));
    }
  }
#pragma unroll
  for (int b = 0; b < kPer; ++b) {
    const int c = threadIdx.x + b * kThreads;
    if (c >= (kTile << sh)) break;
    put_y(hi, lo, c, sh, v[b]);
  }
  if (ycol != nullptr) col_partial(ycol, v, sh);
  if (diag != nullptr) {
#pragma unroll
    for (int b = 0; b < kPer; ++b) {
      const int c = threadIdx.x + b * kThreads;
      float t = dg[b];
      for (int o = 1; o < (1 << sh); o <<= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
      if (c < (kTile << sh) && (c & ((1 << sh) - 1)) == 0) {
        diag[c >> sh] = w0 == 0 ? t : diag[c >> sh] + t;
      }
    }
  }
  cp_async_wait_all();
}

// The second half of a staging whose copies copy_async started with a
// yraw: once they have landed (every thread's), Y's split from yraw, and
// its column partial into ycol.
__device__ __forceinline__ void stage_from_raw(const float* yraw, uint32_t hi, uint32_t lo,
                                               int len, float4* ycol) {
  cp_async_wait_all();
  __syncthreads();
  const int sh = row_shift(len);
  float4 v[kPer];
#pragma unroll
  for (int b = 0; b < kPer; ++b) {
    const int c = threadIdx.x + b * kThreads;
    v[b] = c < (kTile << sh) ? reinterpret_cast<const float4*>(yraw)[c]
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < (kTile << sh)) put_y(hi, lo, c, sh, v[b]);
  }
  col_partial(ycol, v, sh);
}

// Float offset of element (row, d) of an exchange tile (64 rows x kWindow
// floats): 16-byte unit d / 4 at unit ^ (row % 8), so that the parts'
// scalar stores and the reduce's float4 reads both hit distinct banks.
__device__ __forceinline__ int ex_off(int row, int d) {
  return row * kWindow + ((((d >> 2) ^ row) & 7) | ((d >> 2) & ~7)) * 4 + (d & 3);
}

// acc += the kProducts TF32 products of 4 k-steps: A's fragments ah, al,
// B's hi and lo k-chunks (rows x 128 bytes, 128-byte swizzle) at bh, bl; acc
// (64 x 64, or 64 x 32 when R = 16) is overwritten when !accumulate. The
// fragments and descriptors are all defined before the group starts and the
// group is waited for (else ptxas serialises the wgmmas); job() runs while
// it does, and must not touch them.
struct Nothing {
  __device__ void operator()() const {}
};

template <int R, typename Job = Nothing>
__device__ __forceinline__ void mma_group(float (&acc)[R], uint32_t (&ah)[4][4],
                                          uint32_t (&al)[4][4], uint32_t bh, uint32_t bl,
                                          bool accumulate, Job job = Job()) {
  uint64_t dh[4], dl[4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    dh[ks] = smem_desc(bh + 32 * ks, 16, 1024);
    dl[ks] = smem_desc(bl + 32 * ks, 16, 1024);
  }
  fence_operands(dh);
  fence_operands(dl);
  fence_operands(ah);
  fence_operands(al);
  fence_operands(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if constexpr (R == 32) {
      wgmma_tf32(acc, ah[ks], dh[ks], accumulate || ks > 0);
      if (kProducts > 1) {
        wgmma_tf32(acc, ah[ks], dl[ks], 1);
        wgmma_tf32(acc, al[ks], dh[ks], 1);
      }
    } else {
      wgmma_tf32_n32(acc, ah[ks], dh[ks], accumulate || ks > 0);
      if (kProducts > 1) {
        wgmma_tf32_n32(acc, ah[ks], dl[ks], 1);
        wgmma_tf32_n32(acc, al[ks], dh[ks], 1);
      }
    }
  }
  wgmma_commit();
  job();  // loads for the next group, while this one runs
  wgmma_wait<0>();
  fence_operands(acc);
  fence_operands(ah);
  fence_operands(al);
}

// acc (64 i x 32 j: this warpgroup's half of the tile's columns) (+)= X_r .
// Y_c^T over the staged window of `len` floats. A = X rows from xs, split as
// they are read: lane (g, t) of warp w takes rows 16 w + g (+ 8), k t (+ 4)
// of each k-step; B = Y rows [32 wg, +32) of the split tiles.
__device__ __forceinline__ void logits_window(float (&acc)[16], const float* xs, uint32_t yhi,
                                              uint32_t ylo, int len, bool accumulate) {
  const Lane ln;
  const float* x0 = xs + (16 * ln.w + ln.g) * kXStride + ln.t;
  const float* x1 = x0 + 8 * kXStride;
  const uint32_t half = ln.wg * kHalf * 128;
  float raw[4][4];
  auto load = [&](int kc) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int d = 32 * kc + 8 * ks;
      raw[ks][0] = x0[d];
      raw[ks][1] = x1[d];
      raw[ks][2] = x0[d + 4];
      raw[ks][3] = x1[d + 4];
    }
  };
  load(0);
  for (int kc = 0; kc < len / 32; ++kc) {
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) split(raw[ks][e], ah[ks][e], al[ks][e]);
    }
    mma_group(acc, ah, al, yhi + kc * kChunkBytes + half, ylo + kc * kChunkBytes + half,
              accumulate || kc > 0, [&] {
                if (kc + 1 < len / 32) load(kc + 1);
              });
  }
}

// Byte offset of Y[j][d] (window floats) in the split tiles.
__device__ __forceinline__ uint32_t y_off(int j, int d) {
  return (d >> 5) * kChunkBytes + j * 128 + ((((d >> 2) & 7) ^ (j & 7)) << 4) + ((d & 3) << 2);
}

// The backward's product for D-chunk n (64 floats of the window), K = 64
// pool rows in two groups of 4 k-steps: warpgroup 0 makes acc (64 d x 64
// i) = Y_c^T[d] . dL^T, warpgroup 1 acc (64 d x 64 j) = X_r^T[d] . dL. The
// tensor core takes the embedding rows less their tile mean (cy, cx: A =
// (Y - cy)^T from Y's split tiles, or (X - cx)^T from xs, split as read),
// and the mean's part, dL's row sums (or column sums) times it, comes in
// after in f32. The tensor core's f32 adds round toward zero, an error
// proportional to what it accumulates: near a uniform softmax every row's
// sum of dL Y is nearly the same vector, so those errors would add up over
// the rows, which a train step's gradients (the heads' biases) sum; less
// the mean, what it accumulates is small. Lane (g, t) of warp w takes d =
// 64 n + 16 w + g (+ 8), pool rows 8 ks + t (+ 4).
__device__ __forceinline__ void grad_product(float (&acc)[32], const uint8_t* base,
                                             const float* xs, int n, const float* cx,
                                             const float* cy, const float* rowp,
                                             const float* colp) {
  const Lane ln;
  const int m0 = 64 * n + 16 * ln.w + ln.g;
  const uint32_t sbase = smem_u32(base);
  const float* ctr = ln.wg == 0 ? cy : cx;
  const float c0 = ctr[m0], c8 = ctr[m0 + 8];
#pragma unroll 1
  for (int kg = 0; kg < 2; ++kg) {
    uint32_t ah[4][4], al[4][4];
    if (ln.wg == 0) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int j0 = 8 * (4 * kg + ks) + ln.t;
        const int offs[4] = {static_cast<int>(y_off(j0, m0)), static_cast<int>(y_off(j0, m0 + 8)),
                             static_cast<int>(y_off(j0 + 4, m0)),
                             static_cast<int>(y_off(j0 + 4, m0 + 8))};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = *reinterpret_cast<const float*>(base + kYhi + offs[e]) +
                          *reinterpret_cast<const float*>(base + kYlo + offs[e]);
          split(v - ((e & 1) ? c8 : c0), ah[ks][e], al[ks][e]);
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const float* xr = xs + (8 * (4 * kg + ks) + ln.t) * kXStride + m0;
        split(xr[0] - c0, ah[ks][0], al[ks][0]);
        split(xr[8] - c8, ah[ks][1], al[ks][1]);
        split(xr[4 * kXStride] - c0, ah[ks][2], al[ks][2]);
        split(xr[4 * kXStride + 8] - c8, ah[ks][3], al[ks][3]);
      }
    }
    const uint32_t bh = sbase + (ln.wg == 0 ? kDlHi : kDltHi) + kg * kChunkBytes;
    const uint32_t bl = sbase + (ln.wg == 0 ? kDlLo : kDltLo) + kg * kChunkBytes;
    mma_group(acc, ah, al, bh, bl, kg > 0);
  }
  // acc[4 q + 2 h + e] is (d = m0 + 8 h, pool row 8 q + 2 t + e); dL's row
  // sums from their two halves, its column sums from their four warps, in
  // order
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int j = 8 * (k >> 2) + 2 * ln.t + (k & 1);
    const float sum = ln.wg == 0 ? rowp[j] + rowp[kTile + j]
                                 : (colp[j] + colp[kTile + j]) +
                                       (colp[2 * kTile + j] + colp[3 * kTile + j]);
    acc[k] = fmaf(sum, (k & 2) ? c8 : c0, acc[k]);
  }
}

// ---------------------------------------------------------------------------
// Reductions
// ---------------------------------------------------------------------------

// Sum over the block in a fixed order; the result is valid in thread 0.
// scratch holds 32 floats.
__device__ __forceinline__ float block_sum(float x, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  __syncthreads();  // scratch is free
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = x;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += scratch[w];
  }
  return total;
}

// The tile's row and column (max, sum of exp(l - max)) over its valid
// entries (rows < rows, columns < cols): row i's to rm[i], rs[i] (threads i
// < rows), column j's to cm[j], cs[j] (threads j < cols); nothing past them.
// Warpgroup wg holds columns [32 wg, +32): acc[4 q + 2 h + e] is row 16 w +
// g + 8 h, column 32 wg + 8 q + 2 t + e; each row's two halves are combined
// in warpgroup order. red: kRedFloats of shared memory.
__device__ __forceinline__ void tile_stats(const float (&acc)[16], int rows, int cols, float* rm,
                                           float* rs, float* cm, float* cs, float* red) {
  const Lane ln;
  float* rowp = red;                     // [2 halves][2 (m, s)][64]
  float* colp = red + 2 * 2 * kTile;     // [8 warps][32]
  float* cmx = colp + 8 * kHalf;         // [64]
  const int c0 = ln.wg * kHalf;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float m = kNeg;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int j = c0 + 8 * (k >> 1) + 2 * ln.t + (k & 1);
      if (j < cols) m = fmaxf(m, acc[4 * (k >> 1) + 2 * h + (k & 1)]);
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int j = c0 + 8 * (k >> 1) + 2 * ln.t + (k & 1);
      if (j < cols) s += exp_diff(acc[4 * (k >> 1) + 2 * h + (k & 1)], m);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (ln.t == 0) {
      const int i = 16 * ln.w + ln.g + 8 * h;
      rowp[(2 * ln.wg) * kTile + i] = m;
      rowp[(2 * ln.wg + 1) * kTile + i] = s;
    }
  }
  const bool ok0 = 16 * ln.w + ln.g < rows, ok1 = 16 * ln.w + ln.g + 8 < rows;
  float v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int a = 4 * (k >> 1) + (k & 1);
    v[k] = fmaxf(ok0 ? acc[a] : kNeg, ok1 ? acc[a + 2] : kNeg);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) v[k] = fmaxf(v[k], __shfl_xor_sync(0xffffffffu, v[k], o));
  }
  const int wall = threadIdx.x >> 5;  // the block's warp: 4 wg + w
  if (ln.g == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) colp[wall * kHalf + 8 * (k >> 1) + 2 * ln.t + (k & 1)] = v[k];
  }
  __syncthreads();
  if (ln.tid < kTile) {
    const int i = ln.tid;
    const float m0 = rowp[i], s0 = rowp[kTile + i], m1 = rowp[2 * kTile + i],
                s1 = rowp[3 * kTile + i];
    const float m = fmaxf(m0, m1);
    if (i < rows) {
      rm[i] = m;
      rs[i] = s0 * exp_diff(m0, m) + s1 * exp_diff(m1, m);
    }
  } else if (ln.tid < 2 * kTile) {
    const int j = ln.tid - kTile, b = 4 * (j / kHalf), jj = j % kHalf;
    cmx[j] = fmaxf(fmaxf(colp[b * kHalf + jj], colp[(b + 1) * kHalf + jj]),
                   fmaxf(colp[(b + 2) * kHalf + jj], colp[(b + 3) * kHalf + jj]));
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int a = 4 * (k >> 1) + (k & 1);
    const float m = cmx[c0 + 8 * (k >> 1) + 2 * ln.t + (k & 1)];
    v[k] = (ok0 ? exp_diff(acc[a], m) : 0.f) + (ok1 ? exp_diff(acc[a + 2], m) : 0.f);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  }
  __syncthreads();  // colp is read
  if (ln.g == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) colp[wall * kHalf + 8 * (k >> 1) + 2 * ln.t + (k & 1)] = v[k];
  }
  __syncthreads();
  if (ln.tid < cols) {
    const int j = ln.tid, b = 4 * (j / kHalf), jj = j % kHalf;
    cm[j] = cmx[j];
    cs[j] = (colp[b * kHalf + jj] + colp[(b + 1) * kHalf + jj]) +
            (colp[(b + 2) * kHalf + jj] + colp[(b + 3) * kHalf + jj]);
  }
  __syncthreads();  // red is free again
}

// log sum_k s_k exp(m_k) over partials (m_k, s_k), k = 0 .. n - 1, read
// through ld (a functor of k): in chunks of 8 whose loads all go out
// before the first is used, each chunk rescaling the running sum to its new
// maximum, in order.
template <typename Ld>
__device__ __forceinline__ float combine(int n, Ld ld) {
  float mx = kNeg, sum = 0.f;
  for (int k0 = 0; k0 < n; k0 += 8) {
    float2 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = k0 + e < n ? ld(k0 + e) : make_float2(kNeg, 0.f);
    float m = mx;
#pragma unroll
    for (int e = 0; e < 8; ++e) m = fmaxf(m, v[e].x);
    sum *= expf(mx - m);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += v[e].y * expf(v[e].x - m);
    mx = m;
  }
  return mx + logf(sum);
}

// The sum over the cluster's blocks, in rank order, of the float at `slot`
// in each one's shared memory; called by one whole warp, valid in lane 0.
// The lanes read the blocks at once.
__device__ __forceinline__ float rank_sum(const float* slot) {
  static_assert(kCluster <= 32, "a lane a block");
  const int lane = threadIdx.x & 31;
  const float v = lane < kCluster ? ld_cluster(cluster_addr(smem_u32(slot), lane)) : 0.f;
  float sum = 0.f;
#pragma unroll
  for (int b = 0; b < kCluster; ++b) sum += __shfl_sync(0xffffffffu, v, b);
  return sum;
}

// ---------------------------------------------------------------------------
// The cluster launch: K2 (modes kLoss, kLossGrads) and K3's backward (kSweep)
// ---------------------------------------------------------------------------

struct Block {
  const Params& p;
  uint8_t* base;
  int rank, pr, qc;  // rank in the cluster, its row and column in it
  int nb, nwin;

  __device__ float* xs() const { return reinterpret_cast<float*>(base + kXs); }
  __device__ float* red() const { return reinterpret_cast<float*>(base + kRed); }
  __device__ float* diag(int R) const {
    return reinterpret_cast<float*>(base + kDiag) + R * kTile;
  }
  __device__ float* lse_r() const { return reinterpret_cast<float*>(base + kLseR); }
  __device__ float* lse_c() const { return reinterpret_cast<float*>(base + kLseC); }
  __device__ float* stats(int s) const {
    return reinterpret_cast<float*>(base + kStats) + s * 4 * kTile;
  }
  // centring: cx, cy (kWindow each), X's and Y's column partials (a float4
  // a thread each), dL's row sums' partials (2 warpgroups x 64) and column
  // sums' (4 warps x 64)
  __device__ float* ctr() const { return reinterpret_cast<float*>(base + kCtr); }
  __device__ float4* xcol() const { return reinterpret_cast<float4*>(ctr() + 2 * kWindow); }
  __device__ float4* ycol() const { return xcol() + kThreads; }
  __device__ float* rowp() const { return ctr() + 2 * kWindow + 2 * kColParts; }
  __device__ float* colp() const { return rowp() + 2 * kTile; }

  // The tile's column means of X and of Y over the staged window, into cx
  // and cy: Y's column partials came with its staging (ycol), X's are read
  // from xs here (the same float4s a thread), and each column's partials
  // are summed in row order.
  __device__ void centres(int len) {
    const int sh = row_shift(len), per = kThreads >> sh;  // partials a column
    float4 v[kPer];
#pragma unroll
    for (int b = 0; b < kPer; ++b) {
      const int c = threadIdx.x + b * kThreads;
      const float* at = xs() + (c >> sh) * kXStride + 4 * (c & ((1 << sh) - 1));
      v[b] = c < (kTile << sh) ? *reinterpret_cast<const float4*>(at)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    col_partial(xcol(), v, sh);
    __syncthreads();
    const int u = threadIdx.x & 63, side = threadIdx.x >> 6;  // threads < 128: cx, then cy
    if (side < 2 && u < (1 << sh)) {
      const float4* col = side == 0 ? xcol() : ycol();
      float4 t = col[u];
      for (int k = 1; k < per; ++k) {
        const float4 a = col[(k << sh) + u];
        t = make_float4(t.x + a.x, t.y + a.y, t.z + a.z, t.w + a.w);
      }
      const float w = 1.f / kTile;
      reinterpret_cast<float4*>(ctr() + side * kWindow)[u] =
          make_float4(t.x * w, t.y * w, t.z * w, t.w * w);
    }
    __syncthreads();
  }

  // Every window of tile (r, c) staged in turn (the last one stays;
  // window 0 already is when `staged`), and acc = this warpgroup's half of
  // its logits.
  __device__ void logits(float (&acc)[16], int r, int c, bool staged = false,
                         float* dg = nullptr) {
    const uint32_t sb = smem_u32(base);
    for (int w = 0; w < nwin; ++w) {
      const int len = window_len(p.D, w);
      if (!(staged && w == 0)) {
        __syncthreads();  // the last readers of xs and the Y tiles are done
        stage(xs(), sb + kYhi, sb + kYlo, p.x, p.y, r * kTile, c * kTile, p.B, p.D, w * kWindow,
              len, dg, ycol());
        fence_proxy_async();  // the Y tiles' generic writes before wgmma reads them
      }
      __syncthreads();
      logits_window(acc, xs(), sb + kYhi, sb + kYlo, len, w > 0);
    }
  }

  // The summed parts of the exchange tile at byte offset `ex` of the N
  // blocks of ranks rank0 + b * stride, in that order, into rows [row0,
  // row0 + 64) and the D-slice of len / N floats from d0 of out (B x D,
  // row-major): element (i, d) of the tile is out[row0 + i][dbase + d].
  // Written when `first`, else added. At the element's last part
  // (`final`) dL's diagonal entry dd[row] comes in times the same row of
  // `other` (Y for dX, X for dY), one f32 FMA, and the sum is scaled by
  // *scale when that is not null. The warpgroup's threads take the
  // slice's float4s in row-major order (neighbours read neighbouring 16
  // bytes), half at a time; every load of a half (the parts, the old sums)
  // goes out before the first is used.
  template <int N>
  __device__ void reduce_slice(int ex, int rank0, int stride, float* out, const float* other,
                               int row0, int dbase, int d0, int len, bool first, bool final,
                               const float* scale) {
    constexpr int kMaxVec = kTile * kWindow / N / 4 / 128, kHalfVec = (kMaxVec + 1) / 2;
    static_assert(kMaxVec >= 1 && kWindow % (4 * N) == 0, "whole float4s a thread");
    const Lane ln;
    const int row4 = len / N / 4;     // float4s a row of the slice
    const int nvec = kTile * row4 / 128;
    const float s = scale != nullptr ? *scale : 1.f;
#pragma unroll 1
    for (int k0 = 0; k0 < nvec; k0 += kHalfVec) {  // in halves: fewer registers held
      float4 v[N][kHalfVec], old[kHalfVec], oth[kHalfVec];
      float dw[kHalfVec];
#pragma unroll
      for (int k = 0; k < kHalfVec; ++k) {
        if (k0 + k >= nvec) break;
        const int f = ln.wt + 128 * (k0 + k), i = f / row4, d = d0 + 4 * (f % row4);
        const uint32_t own = smem_u32(base) + ex + ex_off(i, d) * 4;
#pragma unroll
        for (int b = 0; b < N; ++b) v[b][k] = ld_cluster4(cluster_addr(own, rank0 + b * stride));
        const int64_t at = static_cast<int64_t>(row0 + i) * p.D + dbase + d;
        const bool ok = row0 + i < p.B && dbase + d < p.D;
        old[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        oth[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        dw[k] = 0.f;
        if (ok && !first) old[k] = *reinterpret_cast<const float4*>(out + at);
        if (ok && final) {
          oth[k] = __ldg(reinterpret_cast<const float4*>(other + at));
          dw[k] = p.dd[row0 + i];  // written in this launch: a coherent load
        }
      }
#pragma unroll
      for (int k = 0; k < kHalfVec; ++k) {
        if (k0 + k >= nvec) break;
        const int f = ln.wt + 128 * (k0 + k), i = f / row4, d = d0 + 4 * (f % row4);
        float4 o = v[0][k];
#pragma unroll
        for (int b = 1; b < N; ++b) {
          o = make_float4(o.x + v[b][k].x, o.y + v[b][k].y, o.z + v[b][k].z, o.w + v[b][k].w);
        }
        if (!first) {
          o = make_float4(old[k].x + o.x, old[k].y + o.y, old[k].z + o.z, old[k].w + o.w);
        }
        if (final) {
          o = make_float4(fmaf(dw[k], oth[k].x, o.x), fmaf(dw[k], oth[k].y, o.y),
                          fmaf(dw[k], oth[k].z, o.z), fmaf(dw[k], oth[k].w, o.w));
        }
        if (scale != nullptr) o = make_float4(o.x * s, o.y * s, o.z * s, o.w * s);
        if (row0 + i < p.B && dbase + d < p.D) {
          *reinterpret_cast<float4*>(out + static_cast<int64_t>(row0 + i) * p.D + dbase + d) = o;
        }
      }
    }
  }

  // One backward step on tile (r, c) whose logits are in acc (this
  // warpgroup's half) and whose window nwin - 1 is staged: dL from lr (its
  // rows' lse) and lc (its columns'), then per window the products (dX parts
  // by warpgroup 0, dY parts by warpgroup 1, every D-chunk of the window),
  // the exchange and the sums into ox (rows of dX) and oy (rows of dY).
  // With one window, warpgroup 0 sums its dX parts over the steps of one
  // row tile in shared memory (kAccX, in f32; it starts there when
  // `first_x`) and exchanges the sum only at the row's last step
  // (`last_x`); with two windows every step exchanges both, and `first_x`
  // says whether the sum in ox starts here. With one window and a next
  // tile (nr, nc >= 0), that tile's window is staged while the exchange
  // runs; returns whether it was. The tile's
  // diagonal entries of dL go to p.dd, not into the products: each sum takes
  // dL_ii times its own row in f32 at its last part (final_x, final_y), so
  // the entry that dominates dL near a uniform softmax (-1 / B) is exact,
  // and a pool of one gives exactly 0.
  __device__ bool backward(float (&acc)[16], int r, int c, const float* lr, const float* lc,
                           float inv2b, float* ox,
                           bool first_x, bool last_x, bool final_x, const float* scale_x,
                           float* oy, bool first_y, bool final_y, const float* scale_y,
                           int nr = -1, int nc = -1) {
    const Lane ln;
    const uint32_t sb = smem_u32(base);
    __syncthreads();  // the last step's readers of the dL tiles are done, lr and lc written
    float dsum[2] = {0.f, 0.f}, csum[4][2] = {};  // this thread's row and column sums of dL
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 16 * ln.w + ln.g + 8 * h, gi = r * kTile + i;
      const float la = lr[i];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t hv[2], lv[2];
        float v2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = ln.wg * kHalf + 8 * q + 2 * ln.t + e, gj = c * kTile + j;
          const float l = acc[4 * q + 2 * h + e];
          float v = 0.f;
          if (gi < p.B && gj < p.B) {
            v = (exp_diff(l, la) + exp_diff(l, lc[j])) * inv2b;
            if (gi == gj) {  // dL_ii in f32, out of the tile: the sums take it last
              p.dd[gi] = (exp_diff(l, la) + exp_diff(l, lc[j]) - 2.f) * inv2b;
              v = 0.f;
            }
          }
          v2[e] = v;
          split(v, hv[e], lv[e]);
          // dL^T: row j, k = i
          const uint32_t ot = (i >> 5) * kChunkBytes + j * 128 +
                              ((((i >> 2) & 7) ^ (j & 7)) << 4) + ((i & 3) << 2);
          *reinterpret_cast<uint32_t*>(base + kDltHi + ot) = hv[e];
          *reinterpret_cast<uint32_t*>(base + kDltLo + ot) = lv[e];
        }
        dsum[h] += v2[0] + v2[1];
        csum[q][0] += v2[0];
        csum[q][1] += v2[1];
        // dL: row i, k = j (j, j + 1 adjacent)
        const int j = ln.wg * kHalf + 8 * q + 2 * ln.t;
        const uint32_t o = (j >> 5) * kChunkBytes + i * 128 + ((((j >> 2) & 7) ^ (i & 7)) << 4) +
                           ((j & 3) << 2);
        *reinterpret_cast<uint2*>(base + kDlHi + o) = make_uint2(hv[0], hv[1]);
        *reinterpret_cast<uint2*>(base + kDlLo + o) = make_uint2(lv[0], lv[1]);
      }
    }
    {  // dL's row sums over this half's columns, column sums over this warp's rows
      float* rowp = this->rowp();  // [2 warpgroups][64]
      float* colp = this->colp();  // [4 warps][64]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float t = dsum[h];
        t += __shfl_xor_sync(0xffffffffu, t, 1);
        t += __shfl_xor_sync(0xffffffffu, t, 2);
        if (ln.t == 0) rowp[ln.wg * kTile + 16 * ln.w + ln.g + 8 * h] = t;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float t = csum[q][e];
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
          if (ln.g == 0) colp[ln.w * kTile + ln.wg * kHalf + 8 * q + 2 * ln.t + e] = t;
        }
      }
    }
    fence_proxy_async();  // the dL tiles' generic writes before wgmma reads them
    __syncthreads();

    float* ex = reinterpret_cast<float*>(base + (ln.wg == 0 ? kExX : kExY));
    const bool prefetch = nwin == 1 && nr >= 0;
    float* yraw = reinterpret_cast<float*>(base + kDlHi);
    for (int wi = nwin - 1; wi >= 0; --wi) {
      const int len = window_len(p.D, wi);
      if (wi != nwin - 1) {
        stage(xs(), sb + kYhi, sb + kYlo, p.x, p.y, r * kTile, c * kTile, p.B, p.D, wi * kWindow,
              len, nullptr, ycol());
        fence_proxy_async();
        __syncthreads();
      }
      // warpgroup 0: dX^T (d, i); 1: dY^T (d, j), a D-chunk each;
      // part[n][4 q + 2 h + e] is (d = 64 n + 16 w + g + 8 h, pool row 8 q + 2 t + e)
      float part[2][32];
      const bool summed = nwin == 1 && ln.wg == 0;  // dX over the row's steps, in kAccX
      const bool send = ln.wg == 1 || nwin > 1 || last_x;
      centres(len);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        if (n < len / 64) {
          grad_product(part[n], base, xs(), n, ctr(), ctr() + kWindow, rowp(), colp());
        }
      }
      if (summed) {  // each thread its own elements: no barrier among them
        float* sum = reinterpret_cast<float*>(base + kAccX);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          if (n >= len / 64) break;
#pragma unroll
          for (int k = 0; k < 32; ++k) {
            const int m = 64 * n + 16 * ln.w + ln.g + 8 * ((k >> 1) & 1);
            const int row = 8 * (k >> 2) + 2 * ln.t + (k & 1);
            const int at = ex_off(row, m);
            sum[at] = first_x ? part[n][k] : sum[at] + part[n][k];
          }
        }
      }
      __syncthreads();  // every product has read the staged tiles: the parts go over Y's
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        if (n >= len / 64 || !send || summed) break;
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const int m = 64 * n + 16 * ln.w + ln.g + 8 * ((k >> 1) & 1);
          const int row = 8 * (k >> 2) + 2 * ln.t + (k & 1);
          ex[ex_off(row, m)] = part[n][k];
        }
      }
      if (prefetch) {  // xs and the dL tiles are free: the next tile's copies start
        copy_async(xs(), yraw, p.x, p.y, nr * kTile, nc * kTile, p.B, p.D, 0, len);
      }
      cluster_sync();  // every block's parts are in place
      // dX[r]: the blocks of this cluster row; dY[c]: of this cluster column
      if (ln.wg == 0) {
        if (send) {
          reduce_slice<kCc>(nwin == 1 ? kAccX : kExX, pr * kCc, 1, ox, p.y, r * kTile,
                            wi * kWindow, qc * (len / kCc), len, nwin == 1 || first_x, final_x,
                            scale_x);
        }
      } else {
        reduce_slice<kRc>(kExY, qc, kCc, oy, p.x, c * kTile, wi * kWindow, pr * (len / kRc), len,
                          first_y, final_y, scale_y);
      }
      cluster_sync();  // the parts are read before anything overwrites them
    }
    if (prefetch) {
      stage_from_raw(yraw, sb + kYhi, sb + kYlo, window_len(p.D, 0), ycol());
      fence_proxy_async();  // the Y tiles' generic writes before wgmma reads them
    }
    return prefetch;
  }

  // K2's forward: every tile's partials (and diag on the diagonal tiles),
  // the combine into this block's rows' and columns' lse, the loss; then
  // (kLossGrads) the backward for g = 1.
  __device__ void k2(int nR, int nC) {
    const Lane ln;
    float acc[16];
    for (int R = 0; R < nR; ++R) {
      for (int C = 0; C < nC; ++C) {
        const int r = R * kRc + pr, c = C * kCc + qc;
        logits(acc, r, c, false, r == c ? diag(R) : nullptr);
        if (r < nb && c < nb) {
          float* st = stats(R * nC + C);
          tile_stats(acc, min(kTile, p.B - r * kTile), min(kTile, p.B - c * kTile), st, st + kTile,
                     st + 2 * kTile, st + 3 * kTile, red());
        }
      }
    }
    cluster_sync();  // every partial is in place

    // lse of this block's rows and columns, over the partials of every
    // tile in column (row) order: 64 threads a row or column super-block.
    const int nsum = summed_tiles(p.B);
    const uint32_t st0 = smem_u32(base) + kStats;
    const int i = ln.tid & 63;
    for (int k = ln.tid >> 6; k < nR + nC; k += kThreads / kTile) {
      float2 part[kK2Tiles];
      if (k < nR) {
        const int R = k;
#pragma unroll
        for (int cc = 0; cc < kK2Tiles; ++cc) {
          if (cc >= nsum) break;
          const uint32_t a = cluster_addr(st0 + ((R * nC + cc / kCc) * 4 * kTile + i) * 4,
                                          pr * kCc + cc % kCc);
          part[cc] = make_float2(ld_cluster(a), ld_cluster(a + kTile * 4));
        }
        lse_r()[R * kTile + i] = combine(nsum, [&](int cc) { return part[cc]; });
      } else {
        const int C = k - nR;
#pragma unroll
        for (int rr = 0; rr < kK2Tiles; ++rr) {
          if (rr >= nsum) break;
          const uint32_t a = cluster_addr(
              st0 + (((rr / kRc) * nC + C) * 4 * kTile + 2 * kTile + i) * 4, (rr % kRc) * kCc + qc);
          part[rr] = make_float2(ld_cluster(a), ld_cluster(a + kTile * 4));
        }
        lse_c()[C * kTile + i] = combine(nsum, [&](int rr) { return part[rr]; });
      }
    }
    __syncthreads();

    // Loss terms, and the lse out, by the blocks that hold a diagonal tile
    // (r, r): its rows' and its columns' terms.
    float term = 0.f;
    for (int R = 0; R < nR; ++R) {
      const int r = R * kRc + pr;
      if (r >= nb || r % kCc != qc) continue;
      const int gi = r * kTile + ln.tid;
      if (ln.tid < kTile && gi < p.B) {
        const float d = diag(R)[ln.tid];
        const float lr = lse_r()[R * kTile + ln.tid], lc = lse_c()[(r / kCc) * kTile + ln.tid];
        p.lse_r[gi] = lr;
        p.lse_c[gi] = lc;
        term += (lr - d) + (lc - d);
      }
    }
    float* slot = red() + kRedFloats - 1;
    const float total = block_sum(term, red());
    if (ln.tid == 0) *slot = total;
    cluster_sync();  // every block's loss term is in place
    if (rank == 0 && ln.tid < 32) {
      const float sum = rank_sum(slot);
      if (ln.tid == 0) *p.loss = 0.5f * sum / static_cast<float>(p.B);
    }
    if (p.mode != kLossGrads) return;

    const float inv2b = 0.5f / static_cast<float>(p.B);
    bool staged = false;
    for (int s = 0; s < nR * nC; ++s) {
      const int R = s / nC, C = s % nC;
      const int r = R * kRc + pr, c = C * kCc + qc;
      if (nR * nC > 1) logits(acc, r, c, staged);  // at one step the logits are still in acc
      const int sn = s + 1 < nR * nC ? s + 1 : -1;
      staged = backward(acc, r, c, lse_r() + R * kTile, lse_c() + C * kTile, inv2b, p.dx,
                        C == 0, C == nC - 1, C == nC - 1, nullptr, p.dy, R == 0, R == nR - 1,
                        nullptr,
                        sn < 0 ? -1 : (sn / nC) * kRc + pr, sn < 0 ? -1 : (sn % nC) * kCc + qc);
    }
  }

  // K3's backward: this cluster's ranges of row and column super-blocks,
  // the dX parts into plane v (v = 0: dX itself), the dY parts into plane u.
  __device__ void sweep(int nR, int nC) {
    const Lane ln;
    const int u = blockIdx.y / p.V, v = blockIdx.y % p.V;
    const int R0 = u * nR / p.U, R1 = (u + 1) * nR / p.U;
    const int C0 = v * nC / p.V, C1 = (v + 1) * nC / p.V;
    const int64_t plane = static_cast<int64_t>(p.B) * p.D;
    float* ox = v == 0 ? p.dx : p.part + (v - 1) * plane;
    float* oy = u == 0 ? p.dy : p.part + (p.V - 1 + u - 1) * plane;
    const float inv2b = 0.5f / static_cast<float>(p.B);
    const int nc_range = C1 - C0, steps = (R1 - R0) * nc_range;
    float acc[16];
    bool staged = false;
    for (int s = 0; s < steps; ++s) {
      const int R = R0 + s / nc_range, C = C0 + s % nc_range;
      const int r = R * kRc + pr, c = C * kCc + qc;
      // the tile's lse (threads < 64 its rows', < 128 its columns'), loaded
      // while its logits are formed; the last step's readers of lse_r and
      // lse_c passed backward()'s barrier after dL, and its first barrier
      // publishes the new values
      const int gk = (ln.tid < kTile ? r : c) * kTile + (ln.tid & (kTile - 1));
      const float lse = ln.tid < 2 * kTile && gk < p.B
                            ? __ldg((ln.tid < kTile ? p.lse_r_in : p.lse_c_in) + gk)
                            : 0.f;
      logits(acc, r, c, staged);
      if (ln.tid < kTile) {
        lse_r()[ln.tid] = lse;
      } else if (ln.tid < 2 * kTile) {
        lse_c()[ln.tid - kTile] = lse;
      }
      const int sn = s + 1 < steps ? s + 1 : -1;
      const bool final_x = p.V == 1 && C == C1 - 1, final_y = p.U == 1 && R == R1 - 1;
      staged = backward(acc, r, c, lse_r(), lse_c(), inv2b, ox, C == C0, C == C1 - 1,
                        final_x, final_x ? p.g : nullptr, oy, R == R0, final_y,
                        final_y ? p.g : nullptr,
                        sn < 0 ? -1 : (R0 + sn / nc_range) * kRc + pr,
                        sn < 0 ? -1 : (C0 + sn % nc_range) * kCc + qc);
    }
  }
};

// grid (kCluster, clusters), clusters of kCluster blocks along x; kThreads
// threads, kClusterBytes (+ alignment) of dynamic shared memory.
__global__ void __launch_bounds__(kThreads, 1) infonce_cluster(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const int rank = static_cast<int>(cluster_rank());
  const int nb = tiles_of(p.B);
  Block blk{p, base, rank, rank / kCc, rank % kCc, nb, (p.D + kWindow - 1) / kWindow};
  const int nR = (nb + kRc - 1) / kRc, nC = (nb + kCc - 1) / kCc;
  cluster_sync();  // every block of the cluster runs before any reads another's memory
  if (p.mode == kSweep) {
    blk.sweep(nR, nC);
  } else {
    blk.k2(nR, nC);
  }
  cluster_sync();  // no block leaves while another may read its memory
}

// ---------------------------------------------------------------------------
// K3's forward
// ---------------------------------------------------------------------------

// Offsets into the tile launch's scratch (floats), for B rows and nb tiles
// a side: scratch_floats(B) = (4 nb + 1) B.
struct Scratch {
  float* row_m;  // [nb column tiles][B] row maxima
  float* row_s;  // [nb][B] row sums of exp(l - max)
  float* col_m;  // [nb row tiles][B]
  float* col_s;  // [nb][B]
  float* diag;   // [B]
  __device__ Scratch(float* base, int B, int nb) {
    const int64_t plane = static_cast<int64_t>(nb) * B;
    row_m = base;
    row_s = row_m + plane;
    col_m = row_s + plane;
    col_s = col_m + plane;
    diag = col_s + plane;
  }
};

// grid (nb, nb): block (cb, rb) forms the logit tile of X rows [64 rb, +64)
// and Y rows [64 cb, +64) and writes its partials (and diag on the
// diagonal). kThreads threads, kTileBytes (+ alignment) of shared memory,
// two blocks an SM.
__global__ void __launch_bounds__(kThreads, 2)
infonce_tiles(const float* __restrict__ x, const float* __restrict__ y, float* __restrict__ scratch,
              int B, int D) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t sb = smem_u32(base);
  float* xs = reinterpret_cast<float*>(base + kXs);
  const int nb = gridDim.x, cb = blockIdx.x, rb = blockIdx.y;
  const Scratch sc(scratch, B, nb);
  float acc[16];
  float* dg = reinterpret_cast<float*>(base + kDiag);
  for (int w = 0; w * kWindow < D; ++w) {
    const int len = window_len(D, w);
    __syncthreads();
    stage(xs, sb + kYhi, sb + kYlo, x, y, rb * kTile, cb * kTile, B, D, w * kWindow, len,
          rb == cb ? dg : nullptr);
    fence_proxy_async();
    __syncthreads();
    logits_window(acc, xs, sb + kYhi, sb + kYlo, len, w > 0);
  }
  if (rb == cb && threadIdx.x < kTile && rb * kTile + threadIdx.x < B) {
    sc.diag[rb * kTile + threadIdx.x] = dg[threadIdx.x];  // the last window's sync published it
  }
  const int64_t ro = static_cast<int64_t>(cb) * B + rb * kTile;
  const int64_t co = static_cast<int64_t>(rb) * B + cb * kTile;
  tile_stats(acc, min(kTile, B - rb * kTile), min(kTile, B - cb * kTile), sc.row_m + ro,
             sc.row_s + ro, sc.col_m + co, sc.col_s + co, reinterpret_cast<float*>(base + kRed));
}

// One cluster of kCluster blocks of kCombineThreads: lse_r, lse_c of every
// index over the nb partials in order, and the loss, its blocks' terms
// summed in rank order.
__global__ void __launch_bounds__(kCombineThreads)
infonce_combine(float* __restrict__ scratch, float* __restrict__ loss, float* __restrict__ lse_r,
                float* __restrict__ lse_c, int B) {
  __shared__ float red[32];
  __shared__ float slot;
  const int nb = tiles_of(B);
  const Scratch sc(scratch, B, nb);
  const int nsum = summed_tiles(B);
  const int rank = static_cast<int>(cluster_rank());
  const int per = (B + kCluster - 1) / kCluster;
  float term = 0.f;
  for (int i = rank * per + threadIdx.x; i < min(B, (rank + 1) * per); i += kCombineThreads) {
    const float lr = combine(nsum, [&](int k) {
      return make_float2(sc.row_m[static_cast<int64_t>(k) * B + i],
                         sc.row_s[static_cast<int64_t>(k) * B + i]);
    });
    const float lc = combine(nsum, [&](int k) {
      return make_float2(sc.col_m[static_cast<int64_t>(k) * B + i],
                         sc.col_s[static_cast<int64_t>(k) * B + i]);
    });
    const float d = sc.diag[i];
    lse_r[i] = lr;
    lse_c[i] = lc;
    term += (lr - d) + (lc - d);
  }
  const float total = block_sum(term, red);
  if (threadIdx.x == 0) slot = total;
  cluster_sync();
  if (rank == 0 && threadIdx.x < 32) {
    const float total_sum = rank_sum(&slot);
    if (threadIdx.x == 0) *loss = 0.5f * total_sum / static_cast<float>(B);
  }
  cluster_sync();
}

// dX (side 0) and dY (side 1) = *g * (out + its n partial planes, in order,
// then dL's diagonal dd times Y for dX, X for dY); grid (ceil(B D / 4 /
// 256), 2), one float4 a thread.
__global__ void __launch_bounds__(256)
infonce_reduce(const float* __restrict__ part, const float* __restrict__ dd,
               const float* __restrict__ g, const float* __restrict__ x,
               const float* __restrict__ y, float* __restrict__ dx, float* __restrict__ dy, int B,
               int D, int U, int V) {
  const int64_t n4 = static_cast<int64_t>(B) * D / 4;
  const int64_t k = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  const bool side_y = blockIdx.y == 1;
  const int n = side_y ? U - 1 : V - 1;
  if (k >= n4 || n == 0) return;
  const float4* src = reinterpret_cast<const float4*>(part) + (side_y ? V - 1 : 0) * n4 + k;
  float4* out = reinterpret_cast<float4*>(side_y ? dy : dx) + k;
  float4 acc = *out;
  for (int s = 0; s < n; ++s) {
    const float4 v = src[s * n4];
    acc = make_float4(acc.x + v.x, acc.y + v.y, acc.z + v.z, acc.w + v.w);
  }
  const float4 o = __ldg(reinterpret_cast<const float4*>(side_y ? x : y) + k);
  const float w = __ldg(dd + 4 * k / D), s = __ldg(g);
  acc = make_float4(fmaf(w, o.x, acc.x), fmaf(w, o.y, acc.y), fmaf(w, o.z, acc.z),
                    fmaf(w, o.w, acc.w));
  *out = make_float4(acc.x * s, acc.y * s, acc.z * s, acc.w * s);
}

// out = *g * in over n4 float4s (K2's backward).
__global__ void __launch_bounds__(256)
infonce_scale(const float4* __restrict__ in, const float* __restrict__ g, float4* __restrict__ out,
              int64_t n4) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (k >= n4) return;
  const float s = __ldg(g);
  const float4 v = in[k];
  out[k] = make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

// The cluster launch's attributes: set on every call (a static would be one
// object across the libraries that hold this code, a planted-fault build
// beside the package's).
cudaError_t cluster_attributes() {
  cudaError_t err = cudaFuncSetAttribute(infonce_cluster,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(infonce_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kClusterBytes + 1024);
}

cudaLaunchConfig_t cluster_config(int clusters, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(kCluster, clusters, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kClusterBytes + 1024;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t launch_cluster(const Params& p, int clusters, cudaStream_t stream) {
  cudaError_t err = cluster_attributes();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(clusters, stream, attr);
  err = cudaLaunchKernelEx(&cfg, infonce_cluster, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace pct_infonce

using namespace pct_infonce;

// Each entry point launches on `stream` (a cudaStream_t) and returns
// cudaGetLastError(): 0 when every launch was accepted. x, y (B, D) f32
// contiguous and 16-byte aligned, D a multiple of 4 in [4, 256], B >= 1
// (the Python wrapper checks all of it); loss one float, lse_r and lse_c B
// floats each, dx and dy B x D floats each, 16-byte aligned.

// K2's forward, one cluster launch, B <= 512. With grads != 0 it also writes
// dx, dy: the gradients for a cotangent of 1 (dd: B floats of scratch).
extern "C" int pct_infonce_fwd(const void* x, const void* y, void* loss, void* lse_r, void* lse_c,
                               void* dx, void* dy, void* dd, int B, int D, int grads,
                               void* stream) {
  if (B > kK2MaxPool) return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const float*>(x), static_cast<const float*>(y), nullptr, nullptr, nullptr,
           static_cast<float*>(loss), static_cast<float*>(lse_r), static_cast<float*>(lse_c),
           static_cast<float*>(dx), static_cast<float*>(dy), nullptr, static_cast<float*>(dd),
           B, D, grads ? kLossGrads : kLoss, 1, 1};
  return static_cast<int>(launch_cluster(p, 1, static_cast<cudaStream_t>(stream)));
}

// K2's backward: out = *g * in over n floats (a multiple of 4).
extern "C" int pct_infonce_scale(const void* in, const void* g, void* out, long long n,
                                 void* stream) {
  const int64_t n4 = n / 4;
  infonce_scale<<<static_cast<unsigned>((n4 + 255) / 256), 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(static_cast<const float4*>(in),
                                                       static_cast<const float*>(g),
                                                       static_cast<float4*>(out), n4);
  return static_cast<int>(cudaGetLastError());
}

// K3's forward: the tile launch, then the combine launch. scratch holds
// (4 ceil(B / 64) + 1) B floats.
extern "C" int pct_infonce_tiled_fwd(const void* x, const void* y, void* scratch, void* loss,
                                     void* lse_r, void* lse_c, int B, int D, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(infonce_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kTileBytes + 1024);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = tiles_of(B);
  infonce_tiles<<<dim3(nb, nb), kThreads, kTileBytes + 1024, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<float*>(scratch), B,
      D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(infonce_combine, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kCombineThreads, 1, 1);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, infonce_combine, static_cast<float*>(scratch),
                           static_cast<float*>(loss), static_cast<float*>(lse_r),
                           static_cast<float*>(lse_c), B);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K2's (for a separate backward) and K3's backward: U x V clusters sweep the
// tile grid, then (U or V > 1) the reduce launch. g is the loss's
// cotangent (one float on the device); part holds (U - 1 + V - 1) B D + B
// floats (the partial planes, then dL's diagonal). U and V must not exceed
// the super-blocks a side (ceil(B / 64 / 4)), so that no range is empty.
extern "C" int pct_infonce_bwd(const void* x, const void* y, const void* lse_r, const void* lse_c,
                               const void* g, void* dx, void* dy, void* part, int B, int D, int U,
                               int V, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dd = static_cast<float*>(part) + static_cast<int64_t>(U - 1 + V - 1) * B * D;
  Params p{static_cast<const float*>(x), static_cast<const float*>(y),
           static_cast<const float*>(lse_r), static_cast<const float*>(lse_c),
           static_cast<const float*>(g), nullptr, nullptr, nullptr, static_cast<float*>(dx),
           static_cast<float*>(dy), static_cast<float*>(part), dd, B, D, kSweep, U, V};
  cudaError_t err = launch_cluster(p, U * V, s);
  if (err != cudaSuccess || (U == 1 && V == 1)) return static_cast<int>(err);
  const int64_t n4 = static_cast<int64_t>(B) * D / 4;
  infonce_reduce<<<dim3(static_cast<unsigned>((n4 + 255) / 256), 2), 256, 0, s>>>(
      static_cast<const float*>(part), dd, static_cast<const float*>(g),
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<float*>(dx),
      static_cast<float*>(dy), B, D, U, V);
  return static_cast<int>(cudaGetLastError());
}

// The clusters of the cluster launch that the current device holds at once
// (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int pct_infonce_max_clusters(int* out) {
  cudaError_t err = cluster_attributes();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(1, nullptr, attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, infonce_cluster, &cfg));
}
