// One Hopper (sm_90a) GEMM for the port's dense products: out(N, M) =
// epilogue(x(N, K) . W(K, M)), both row-major as the TPU package stores them
// (x token-major, W (in, out)). Shared by csrc/dense_mm.cu (P1: s8 x s8 ->
// s32 and bf16 x bf16 -> f32, written as they are), csrc/ffn_gelu.cu (K6:
// bf16 with a fused bias + gelu epilogue) and csrc/ffn_gelu_f32.cu (K6-f32:
// f32 as 3xTF32 products, the same epilogue in f32).
//
// Block: WGS consumer warpgroups of 64 rows each (BM = 64 WGS) and one
// producer warpgroup own a BM x BN output tile: 256 x 128 (Large), or 64 x 64
// (Small) when the large tile would put fewer than kLargeMinBlocks blocks on
// the card's 132 SMs (launch_for; PERF.md section 6 has the measurement);
// f32 has its own pair (Shapes<F32>, below). K is walked in k-tiles of 128
// bytes (64 bf16, 128 s8 or 32 f32), one 128-byte swizzle row, through a
// ring of up to 4 stages in dynamic shared memory (192 KB for Large):
//   - one producer thread fills a stage with TMA (cp.async.bulk.tensor, the
//     128-byte swizzle, zeros past N, M and K) and arms the stage's "full"
//     mbarrier with the bytes to expect; the consumers wait on it, run
//     wgmma.mma_async from shared memory into f32 or s32 accumulators in
//     registers (m64nBNk16 bf16, m64nBNk32 s8; four per k-tile), keep one
//     k-tile's wgmma group in flight, and release the stage before it on its
//     "empty" mbarrier (one arrival per consumer warp). No block-wide
//     barrier in the k-loop.
//   - the tensor maps are encoded on the host for every call (x and out
//     change with each call): cuTensorMapEncodeTiled, fetched from the
//     driver through the runtime, so nothing links -lcuda. What that costs
//     a launch is read by tools/probe_int8.py.
// Operands in shared memory (16-byte chunk q of row r at chunk q ^ (r % 8)):
//   - x (A, K-major): BM rows of 128 bytes; descriptor SBO 1024 (8-row
//     groups), a k-step advances the start by 32 bytes.
//   - bf16 W (B, MN-major, wgmma's transpose bit): W as stored, 64 k-rows of
//     128 bytes per 64-column atom (one TMA box each), atoms 8 KB apart
//     (LBO), 8-k-row groups 1 KB apart (SBO); a k-step advances 16 rows.
//   - s8 W (B, K-major: wgmma takes 8-bit operands K-major only). Every
//     producer thread loads 16 k-rows x 8 columns of W into registers (a
//     tile ahead, so the loads' latency hides behind the wait for a free
//     stage), turns them with byte permutes into 8 columns of 16 consecutive
//     k bytes, stores each as one 16-byte chunk of the K-major tile, then
//     fence.proxy.async and an arrival on the full barrier (which counts 129
//     arrivals for s8 and f32, 1 for bf16). The parameter tree keeps the TPU
//     package's (in, out) layout and W is not copied.
//   - f32 (F32: 3xTF32, for K6-f32). TF32 wgmma, like 8-bit, takes shared
//     operands K-major only, and its products keep TF32's 10 mantissa bits;
//     f32 accuracy comes from splitting each operand v into hi = tf32(v)
//     (rounded to nearest, low bits cleared) and lo = tf32(v - hi) and
//     summing hi.hi + hi.lo + lo.hi (kProducts) in f32. x is A from
//     registers: its k-tile arrives by TMA as for bf16 (32 floats a row),
//     and each consumer thread reads its m64k8 fragments with four 16-byte
//     loads a k-tile (16-byte chunk 2 t + h of rows g and g + 8), splitting
//     them as it goes. That fixes the order of k inside a k-tile: k-step ks
//     takes the tile's k = ks, 4 + ks, 8 + ks, ..., 28 + ks (fragment
//     column j holds k = 8 (j % 4) + 4 (j / 4) + ks). W is B: every
//     producer thread loads one column's k-values of a k-tile (a warp's
//     loads are 128 contiguous bytes) one or more tiles ahead into
//     registers (kAhead), splits them, and stores both tiles K-major in
//     that order, 16-byte chunk q of column n (k = 8 e + 4 (q % 2) + q /
//     2, e = 0..3) at q ^ (n % 8), then fence.proxy.async and an arrival. A stage holds
//     x's BM x 32 floats and W's hi and lo tiles of BN x 32: 48 KB at
//     128 x 128 (four stages, 192 KB), 16 KB at 64 x 32 (four, 64 KB; 24
//     KB and 96 KB at 64 x 64); at 256 x 128 it would be 64 KB (three
//     stages). Each k-tile's 12 products
//     (3 a k-step) go into a fresh wgmma accumulator that is then added to
//     the f32 sum in registers: the tensor core's own f32 adds round toward
//     zero, an error that grows with what it accumulates, so it accumulates
//     one k-tile only. Registers set the f32 tiles: a consumer thread holds
//     the sum, the k-tile's partial, 32 split fragments and 8 descriptors
//     (about 190 at BN = 128), which 256 x 128's four warpgroups cannot have
//     (at most 102 a thread at 640); at 128 x 128 the producer hands
//     registers to the two consumer warpgroups (setmaxnreg: 208 each, 88
//     for the producer, out of the launch's 168 a thread).
// Epilogue: after the k-loop the consumer warpgroups meet on a named
// barrier, apply the elementwise epilogue to their fragments, stage the
// results in the (now idle) ring with rows padded by 8 elements (conflict-
// free pair stores), and store them with 16-byte coalesced writes. It does
// not overlap the next tile's loads: that, and the L2 traffic of a tile
// loaded once per block (no cluster multicast), are what limit the kernel
// now (PERF.md section 6).
//
// Edges: the wrappers guarantee K * elt a multiple of 32 bytes (s8 K % 32,
// bf16 K % 16; f32's K % 16 gives 64), M % 8 == 0 and 16-byte aligned bases,
// so the TMA strides are multiples of 16 bytes and every 16-byte chunk of W
// and out is wholly inside or outside; chunks outside are zero in the ring
// and never stored. f32 takes any N: its row blocks run along grid.x.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace pct_gemm {

using namespace pct_hopper;

constexpr int kTileBytes = 128;  // k bytes per ring stage
constexpr int kMaxStages = 4;    // ring stages, fewer where four do not fit
constexpr int kProducer = 128;   // producer threads (the last warpgroup)
constexpr int kBlockSmem = 232448 - 1024 - 64;  // 227 KB, less the alignment slack and barriers
constexpr int kProducts = 3;  // TF32 products per k-step: hi.hi, hi.lo, lo.hi
constexpr int kPromote = 4;   // f32: k-steps a wgmma partial sums before an f32 add takes it

struct S8 {
  using Elt = int8_t;
  using Acc = int32_t;
  static constexpr int kEltBytes = 1;
};

struct BF16 {
  using Elt = __nv_bfloat16;
  using Acc = float;
  static constexpr int kEltBytes = 2;
};

// f32 operands, multiplied as 3xTF32 (K6-f32)
struct F32 {
  using Elt = float;
  using Acc = float;
  static constexpr int kEltBytes = 4;
};

// A block's shape: BN output columns, WGS consumer warpgroups of 64 rows.
template <int BN_, int WGS_>
struct Config {
  static constexpr int BN = BN_;
  static constexpr int WGS = WGS_;
};

template <class Op, class C>
struct Tile {
  static constexpr bool kSplit = Op::kEltBytes == 4;  // f32: W as tf32 hi and lo tiles
  static constexpr int kBN = C::BN;
  static constexpr int kWGS = C::WGS;
  static constexpr int kBM = 64 * C::WGS;
  static constexpr int kThreads = 128 * C::WGS + kProducer;
  static constexpr int kABytes = kBM * kTileBytes;
  // bf16: 64 k-rows x 2 BN bytes; s8: BN columns x 128 k; f32: hi and lo, BN columns x 32 k each
  static constexpr int kBBytes = (kSplit ? 2 : 1) * C::BN * kTileBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages =
      kBlockSmem / kStageBytes < kMaxStages ? kBlockSmem / kStageBytes : kMaxStages;
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + alignment slack
  // the TMA thread's, and for s8 and f32 one from each producer thread after its W stores
  static constexpr int kFullArrivals = Op::kEltBytes == 2 ? 1 : 1 + kProducer;
  // f32 row blocks along grid.x (any N); the others along grid.y
  static constexpr bool kRowsOnX = kSplit;
  // f32 with two consumer warpgroups: registers a thread after setmaxnreg,
  // which moves registers within what the block holds from its launch
  // (168 x 384 = 64512 under __launch_bounds__(384, 1)): 208 x 256 + 88 x
  // 128 = 64512 (a budget past it waits forever); 0 keeps the launch's share
  static constexpr int kConsumerRegs = kSplit && C::WGS == 2 ? 208 : 0;
  static constexpr int kProducerRegs = kSplit && C::WGS == 2 ? 88 : 0;
  static_assert(kConsumerRegs * 128 * C::WGS + kProducerRegs * kProducer <=
                    (65536 / kThreads / 8 * 8) * kThreads,
                "the budgets fit the block's registers at launch");
  static_assert(C::BN == 64 || C::BN == 128 || (kSplit && C::BN == 32),
                "BN is 64 or 128 (f32 also 32)");
  static_assert(!kSplit || C::WGS <= 2, "f32's consumer registers fit two warpgroups");
  static_assert(kStages >= 2, "two stages fit");
};

// ---------------------------------------------------------------------------
// wgmma for the GEMM's tiles (the shared primitives are in hopper.cuh)
// ---------------------------------------------------------------------------

// d = A . B + (scale_d ? d : 0), A 64 x k from shared memory (K-major), B
// k x n from shared memory (bf16: MN-major, s8: K-major); the overload picks
// n from d's size.
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(int32_t (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(int32_t (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// Producer: fills the ring
// ---------------------------------------------------------------------------

// s8 W in registers: a unit of 16 k-rows x 8 columns. A k-tile has BN units
// (8 k groups x BN / 8 column groups); producer thread tid < BN holds unit tid.
struct WUnit {
  uint2 v[16];
};

template <int BN>
__device__ __forceinline__ void load_w_s8(const uint8_t* __restrict__ w, int K, int M, int col0,
                                          int tile, int tid, WUnit& u) {
  if (tid >= BN) return;
  const int col = col0 + (tid >> 3) * 8;
  const int k0 = tile * kTileBytes + (tid & 7) * 16;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const bool ok = col < M && k0 + r < K;
    u.v[r] = ok ? *reinterpret_cast<const uint2*>(w + static_cast<int64_t>(k0 + r) * M + col)
                : make_uint2(0u, 0u);
  }
}

// The unit's 8 columns as 16 consecutive k bytes each, into the K-major B
// tile: column n's row of 128 bytes, chunk kg at kg ^ (n % 8).
template <int BN>
__device__ __forceinline__ void store_w_s8(const WUnit& u, uint32_t b_tile, int tid) {
  if (tid >= BN) return;
  const int kg = tid & 7;
  const int ng = tid >> 3;
  uint32_t col[4][8];  // [4-row group q][column j]: k = 4q..4q+3 of column j, low k first
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // columns 4h..4h+3
      const uint32_t w0 = h ? u.v[4 * q].y : u.v[4 * q].x;
      const uint32_t w1 = h ? u.v[4 * q + 1].y : u.v[4 * q + 1].x;
      const uint32_t w2 = h ? u.v[4 * q + 2].y : u.v[4 * q + 2].x;
      const uint32_t w3 = h ? u.v[4 * q + 3].y : u.v[4 * q + 3].x;
      const uint32_t lo01 = __byte_perm(w0, w1, 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
      const uint32_t lo23 = __byte_perm(w2, w3, 0x5140);
      const uint32_t hi01 = __byte_perm(w0, w1, 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
      const uint32_t hi23 = __byte_perm(w2, w3, 0x7362);
      col[q][4 * h + 0] = __byte_perm(lo01, lo23, 0x5410);
      col[q][4 * h + 1] = __byte_perm(lo01, lo23, 0x7632);
      col[q][4 * h + 2] = __byte_perm(hi01, hi23, 0x5410);
      col[q][4 * h + 3] = __byte_perm(hi01, hi23, 0x7632);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t n = ng * 8 + j;
    st_shared16(b_tile + n * kTileBytes + ((kg ^ j) << 4), col[0][j], col[1][j], col[2][j],
                col[3][j]);
  }
}

// f32 W in registers: producer thread tid holds column tid % BN of a
// k-tile, its k-values of 16-byte chunks q = (tid / BN) kChunks .. + kChunks
// - 1 of the K-major tile (chunk q holds k = 8 e + 4 (q % 2) + q / 2).
template <int BN>
struct WColF32 {
  static constexpr int kChunks = BN / 16;  // 128 threads x kChunks x 4 = 32 k x BN
  // k-tiles loaded ahead: one at 128 columns (32 floats a thread; two took
  // 20% longer on an H100 at t30_150M's wi, tools/probe_ffn_f32.py), else
  // 64 floats a thread
  static constexpr int kAhead = BN == 128 ? 1 : 256 / BN;
  float v[4 * kChunks];
};

template <int BN>
__device__ __forceinline__ void load_w_f32(const float* __restrict__ w, int K, int M, int col0,
                                           int tile, int tid, WColF32<BN>& u) {
  constexpr int kChunks = WColF32<BN>::kChunks;
  const int col = col0 + tid % BN;
  const int q0 = (tid / BN) * kChunks;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int q = q0 + c;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = tile * 32 + 8 * e + 4 * (q & 1) + (q >> 1);
      u.v[4 * c + e] = col < M && k < K ? w[static_cast<int64_t>(k) * M + col] : 0.0f;
    }
  }
}

// The column's chunks split into hi and lo, into the K-major B tiles (hi at
// b_hi, lo BN rows of 128 bytes after it): chunk q of column n at q ^ (n % 8).
template <int BN>
__device__ __forceinline__ void store_w_f32(const WColF32<BN>& u, uint32_t b_hi, int tid) {
  constexpr int kChunks = WColF32<BN>::kChunks;
  const int n = tid % BN;
  const int q0 = (tid / BN) * kChunks;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(u.v[4 * c + e], hi[e], lo[e]);
    const uint32_t off = n * kTileBytes + (((q0 + c) ^ (n & 7)) << 4);
    st_shared16(b_hi + off, hi[0], hi[1], hi[2], hi[3]);
    st_shared16(b_hi + BN * kTileBytes + off, lo[0], lo[1], lo[2], lo[3]);
  }
}

// f32: x by TMA from thread 0, W's k-tiles through every producer thread's
// registers, kAhead tiles ahead (the unrolled inner loop keeps the
// register units' indices constant).
template <class T>
__device__ __forceinline__ void produce_f32(const CUtensorMap* tmx, const float* __restrict__ w,
                                            int K, int M, int row0, int col0, int n_tiles,
                                            uint32_t ring, uint32_t full, uint32_t empty) {
  constexpr int BN = T::kBN;
  constexpr int kAhead = WColF32<BN>::kAhead;
  const int tid = threadIdx.x - 128 * T::kWGS;
  WColF32<BN> u[kAhead];
#pragma unroll
  for (int d = 0; d < kAhead; ++d) {
    if (d < n_tiles) load_w_f32<BN>(w, K, M, col0, d, tid, u[d]);
  }
  for (int t0 = 0; t0 < n_tiles; t0 += kAhead) {
#pragma unroll
    for (int d = 0; d < kAhead; ++d) {
      const int t = t0 + d;
      if (t < n_tiles) {
        const int s = t % T::kStages;
        mbar_wait(empty + 8 * s, ((t / T::kStages) & 1) ^ 1);
        const uint32_t a_tile = ring + s * T::kStageBytes;
        if (tid == 0) {
          mbar_arrive_expect(full + 8 * s, T::kABytes);
          tma_load(a_tile, tmx, t * 32, row0, full + 8 * s);  // BM rows x 32 floats
        }
        store_w_f32<BN>(u[d], a_tile + T::kABytes, tid);
        fence_proxy_async();
        mbar_arrive(full + 8 * s);
        if (t + kAhead < n_tiles) load_w_f32<BN>(w, K, M, col0, t + kAhead, tid, u[d]);
      }
    }
  }
}

// x (and bf16 W) by TMA from one thread; s8 W through every producer
// thread's registers.
template <class Op, class T>
__device__ __forceinline__ void produce(const CUtensorMap* tmx, const CUtensorMap* tmw,
                                        const uint8_t* __restrict__ w, int K, int M, int row0,
                                        int col0, int n_tiles, uint32_t ring, uint32_t full,
                                        uint32_t empty) {
  constexpr int BN = T::kBN;
  const int tid = threadIdx.x - 128 * T::kWGS;
  if (Op::kEltBytes == 2 && tid != 0) return;
  WUnit u;
  if constexpr (Op::kEltBytes == 1) load_w_s8<BN>(w, K, M, col0, 0, tid, u);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % T::kStages;
    mbar_wait(empty + 8 * s, ((t / T::kStages) & 1) ^ 1);
    const uint32_t a_tile = ring + s * T::kStageBytes;
    const uint32_t b_tile = a_tile + T::kABytes;
    const int k0 = t * (kTileBytes / Op::kEltBytes);  // first k of the tile
    if (tid == 0) {
      mbar_arrive_expect(full + 8 * s, Op::kEltBytes == 2 ? T::kStageBytes : T::kABytes);
      tma_load(a_tile, tmx, k0, row0, full + 8 * s);  // BM rows x 128 bytes
      if constexpr (Op::kEltBytes == 2) {
#pragma unroll
        for (int atom = 0; atom < BN / 64; ++atom) {  // 64 k-rows x 64 columns each
          tma_load(b_tile + atom * 8192, tmw, col0 + atom * 64, k0, full + 8 * s);
        }
      }
    }
    if constexpr (Op::kEltBytes == 1) {
      store_w_s8<BN>(u, b_tile, tid);
      fence_proxy_async();
      mbar_arrive(full + 8 * s);
      if (t + 1 < n_tiles) load_w_s8<BN>(w, K, M, col0, t + 1, tid, u);
    }
  }
}

// ---------------------------------------------------------------------------
// Consumers: wgmma on the ring
// ---------------------------------------------------------------------------

// acc = this warpgroup's 64 rows of x . W over all n_tiles k-tiles (left
// undefined when n_tiles is 0: the first wgmma overwrites it, so no other
// instruction writes the accumulators while wgmma owns them).
template <class Op, class T>
__device__ __forceinline__ void consume(int n_tiles, uint32_t ring, uint32_t full, uint32_t empty,
                                        typename Op::Acc (&acc)[T::kBN / 2]) {
  const int wg = threadIdx.x >> 7;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % T::kStages;
    mbar_wait(full + 8 * s, (t / T::kStages) & 1);
    const uint32_t a_tile = ring + s * T::kStageBytes + wg * 64 * kTileBytes;
    const uint32_t b_tile = ring + s * T::kStageBytes + T::kABytes;
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTileBytes / 32; ++ks) {  // 32 bytes of k per wgmma
      const uint64_t a = smem_desc(a_tile + ks * 32, 16, 1024);
      const uint64_t b = Op::kEltBytes == 2 ? smem_desc(b_tile + ks * 2048, 8192, 1024)
                                            : smem_desc(b_tile + ks * 32, 16, 1024);
      wgmma(acc, a, b, t > 0 || ks > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the k-tile before this one is done: release its stage
    fence_operands(acc);
    if (t > 0 && (threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * ((t - 1) % T::kStages));
  }
  wgmma_wait<0>();
  fence_operands(acc);
}

__device__ __forceinline__ float4 ld_shared_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float part_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The TF32 product of BN = 32, 64 or 128 columns.
__device__ __forceinline__ void wgmma_tf32_n(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
  wgmma_tf32_n32(d, a, b, scale_d);
}

template <int R>
__device__ __forceinline__ void wgmma_tf32_n(float (&d)[R], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
  wgmma_tf32(d, a, b, scale_d);
}

// f32: acc = this warpgroup's 64 rows of x . W over all n_tiles k-tiles, as
// 3xTF32. Per k-tile: the fragments (rows 16 w + g and + 8, 16-byte chunks
// 2 t and 2 t + 1) read and split; per kPromote k-steps, their kProducts
// products into a fresh partial (the hi.lo and lo.hi products first, then
// hi.hi), added to acc in f32 once done; the stage released after the last.
template <class T>
__device__ __forceinline__ void consume_f32(int n_tiles, uint32_t ring, uint32_t full,
                                            uint32_t empty, float (&acc)[T::kBN / 2]) {
  constexpr int BN = T::kBN;
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + g;  // the warpgroup's rows r0 and r0 + 8
  const int t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  float part[BN / 2];
  uint32_t hi[4][4], lo[4][4];
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % T::kStages;
    mbar_wait(full + 8 * s, (t / T::kStages) & 1);
    const uint32_t a_tile = ring + s * T::kStageBytes + wg * 64 * kTileBytes;
    const uint32_t b_hi = ring + s * T::kStageBytes + T::kABytes;
    const uint32_t b_lo = b_hi + BN * kTileBytes;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // fragment columns t4 (h 0) and t4 + 4 (h 1)
      const uint32_t off = ((2 * t4 + h) ^ g) << 4;  // rows r0 and r0 + 8 share r % 8 = g
      const float4 x0 = ld_shared_f4(a_tile + r0 * kTileBytes + off);
      const float4 x1 = ld_shared_f4(a_tile + (r0 + 8) * kTileBytes + off);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        split(part_of(x0, ks), hi[ks][2 * h], lo[ks][2 * h]);
        split(part_of(x1, ks), hi[ks][2 * h + 1], lo[ks][2 * h + 1]);
      }
    }
    uint64_t dh[4], dl[4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      dh[ks] = smem_desc(b_hi + 32 * ks, 16, 1024);
      dl[ks] = smem_desc(b_lo + 32 * ks, 16, 1024);
    }
#pragma unroll
    for (int k0 = 0; k0 < 4; k0 += kPromote) {
      fence_operands(dh);
      fence_operands(dl);
      fence_operands(hi);
      fence_operands(lo);
      fence_operands(part);
      wgmma_fence();
      // the small products first: only the hi.hi adds truncate at the
      // partial's full size
#pragma unroll
      for (int ks = k0; ks < k0 + kPromote; ++ks) {
        if (kProducts > 1) {
          wgmma_tf32_n(part, hi[ks], dl[ks], ks > k0);
          wgmma_tf32_n(part, lo[ks], dh[ks], 1);
        }
      }
#pragma unroll
      for (int ks = k0; ks < k0 + kPromote; ++ks) {
        wgmma_tf32_n(part, hi[ks], dh[ks], kProducts > 1 || ks > k0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(part);
      fence_operands(hi);
      fence_operands(lo);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    }
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store_pair(int32_t* p, int32_t a, int32_t b) {
  *reinterpret_cast<int2*>(p) = make_int2(a, b);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, __nv_bfloat16 a, __nv_bfloat16 b) {
  __nv_bfloat162 v;
  v.x = a;
  v.y = b;
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

// Epi: Out (the output type), out (N, M) and M, and
// operator()(acc0, acc1, col, out0, out1) for the pair at columns col and
// col + 1 (col may be past M: the pair is then never stored).
// grid (ceil(M / BN), ceil(N / BM)), or for f32 (ceil(N / BM), ceil(M /
// BN)), Tile::kThreads threads, Tile::kSmemBytes of dynamic shared memory.
template <class Op, class C, class Epi>
__global__ void __launch_bounds__(Tile<Op, C>::kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
            const typename Op::Elt* __restrict__ w, const Epi epi, int N, int K, int M) {
  using T = Tile<Op, C>;
  using Acc = typename Op::Acc;
  using Out = typename Epi::Out;
  constexpr int BN = T::kBN;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * T::kStages];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* ring_ptr = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t ring = smem_u32(ring_ptr);
  const uint32_t full = smem_u32(bars);
  const uint32_t empty = full + 8 * T::kStages;
  const int row0 = (T::kRowsOnX ? blockIdx.x : blockIdx.y) * T::kBM;
  const int col0 = (T::kRowsOnX ? blockIdx.y : blockIdx.x) * BN;
  const int n_tiles = (K * Op::kEltBytes + kTileBytes - 1) / kTileBytes;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full + 8 * s, T::kFullArrivals);
      mbar_init(empty + 8 * s, 4 * T::kWGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 128 * T::kWGS) {
    if constexpr (T::kSplit) {
      if constexpr (T::kProducerRegs > 0) setmaxnreg_dec<T::kProducerRegs>();
      produce_f32<T>(&tmx, reinterpret_cast<const float*>(w), K, M, row0, col0, n_tiles, ring,
                     full, empty);
    } else {
      produce<Op, T>(&tmx, &tmw, reinterpret_cast<const uint8_t*>(w), K, M, row0, col0, n_tiles,
                     ring, full, empty);
    }
    return;
  }
  Acc acc[BN / 2];
  if constexpr (T::kSplit) {
    if constexpr (T::kConsumerRegs > 0) setmaxnreg_inc<T::kConsumerRegs>();
    consume_f32<T>(n_tiles, ring, full, empty, acc);
  } else {
    consume<Op, T>(n_tiles, ring, full, empty, acc);
  }

  // Epilogue: fragments -> padded rows in the ring -> 16-byte stores.
  constexpr int kStride = BN + 8;  // elements; pair stores hit distinct banks
  static_assert(T::kBM * kStride * 4 <= T::kStages * T::kStageBytes, "staging fits the ring");
  named_barrier(1, 128 * T::kWGS);  // every consumer is done with the ring
  const bool any = n_tiles > 0;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  Out* stage = reinterpret_cast<Out*>(ring_ptr) + wg * 64 * kStride;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * tig;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the warp's 16
      Out o0, o1;
      epi(any ? acc[4 * j + 2 * h] : Acc(0), any ? acc[4 * j + 2 * h + 1] : Acc(0), col0 + col,
          o0, o1);
      store_pair(stage + (warp * 16 + g + 8 * h) * kStride + col, o0, o1);
    }
  }
  named_barrier(2 + wg, 128);
  constexpr int kChunk = 16 / sizeof(Out);  // elements in 16 bytes
  constexpr int kRowChunks = BN / kChunk;
  const int tid = threadIdx.x & 127;
#pragma unroll 4
  for (int c = tid; c < 64 * kRowChunks; c += 128) {
    const int r = c / kRowChunks;
    const int q = c % kRowChunks;
    const int row = row0 + wg * 64 + r;
    const int col = col0 + q * kChunk;
    if (row < N && col < M) {
      *reinterpret_cast<uint4*>(epi.out + static_cast<int64_t>(row) * M + col) =
          *reinterpret_cast<const uint4*>(stage + r * kStride + q * kChunk);
    }
  }
}

// The TMA map of a row-major (rows, cols) matrix of Op's elements, read in
// boxes of 128 bytes x box_rows with the 128-byte swizzle; false on failure.
template <class Op>
bool tensor_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * Op::kEltBytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kTileBytes / Op::kEltBytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map,
                Op::kEltBytes == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                : Op::kEltBytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                2, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Encodes the maps, sets the kernel's shared memory size and launches it on
// `stream`; returns the first CUDA error (0 when the launch was accepted;
// cudaErrorInvalidValue when a map could not be encoded).
template <class Op, class C, class Epi>
int launch(const void* x, const void* w, const Epi& epi, int N, int K, int M,
           cudaStream_t stream) {
  using T = Tile<Op, C>;
  CUtensorMap tmx, tmw;
  if (!tensor_map<Op>(&tmx, x, N, K, T::kBM)) return static_cast<int>(cudaErrorInvalidValue);
  if (Op::kEltBytes != 2) {
    tmw = tmx;  // s8 and f32 W are read through registers
  } else if (!tensor_map<Op>(&tmw, w, K, M, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = gemm_kernel<Op, C, Epi>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned col_blocks = (M + C::BN - 1) / C::BN, row_blocks = (N + T::kBM - 1) / T::kBM;
  const dim3 grid = T::kRowsOnX ? dim3(row_blocks, col_blocks) : dim3(col_blocks, row_blocks);
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      tmx, tmw, static_cast<const typename Op::Elt*>(w), epi, N, K, M);
  return static_cast<int>(cudaGetLastError());
}

// The two block shapes and the rule between them. Measured on an H100 at
// t30_150M's layer shapes (PERF.md section 6): the 64 x 64 block wins or ties
// up to 40 blocks of the 256 x 128 grid (N = 512 at M = 2560, N = 2048 at
// M = 640), the 256 x 128 block from 60 (N = 768 at M = 2560), so the large
// block needs 48.
using Small = Config<64, 1>;
using Large = Config<128, 4>;
constexpr int kLargeMinBlocks = 48;

// Each operand type's pair of block shapes. f32: 128 x 128 (two consumer
// warpgroups, the most whose registers fit) and 64 x 32 below
// kLargeMinBlocks of those: at 128 tokens it gives twice the blocks of 64 x
// 64, and on an H100 took 0.018450 ms against 0.021479 at (128, 640, 2560)
// and 0.047045 against 0.075652 at (128, 2560, 640), where 64 x 64 leaves
// 20 blocks (tools/probe_ffn_f32.py; PERF.md section 6).
template <class Op>
struct Shapes {
  using L = Large;
  using S = Small;
};

template <>
struct Shapes<F32> {
  using L = Config<128, 2>;
  using S = Config<32, 1>;
};

template <class Op, class Epi>
int launch_for(const void* x, const void* w, const Epi& epi, int N, int K, int M,
               cudaStream_t stream) {
  using C = typename Shapes<Op>::L;
  using L = Tile<Op, C>;
  const int64_t large_blocks = static_cast<int64_t>((N + L::kBM - 1) / L::kBM) *
                               ((M + C::BN - 1) / C::BN);
  if (large_blocks < kLargeMinBlocks) {
    return launch<Op, typename Shapes<Op>::S>(x, w, epi, N, K, M, stream);
  }
  return launch<Op, C>(x, w, epi, N, K, M, stream);
}

}  // namespace pct_gemm
