// What the attention kernels K1 (attention_fwd.cu) and K5 (attention_bwd.cu)
// share on Hopper (sm_90a): the block's layout and its ring of tiles, the
// per-tile segment ranges that decide which tile pairs are computed, the
// copies that fill the ring, and the wgmma shapes. The kernels are templates
// on HD, the head dim, a compile-time constant in every address and loop:
// ESM-2's 16 (t6_8M), 24 (t12_35M), 32 (t30_150M), 64 (t33_650M, t36_3B)
// and 128 (t48_15B). The layout is a template on DH = kWidth<HD>, the
// tile's width: HD, or 32 for HD 24, whose producer copies three 16-byte
// chunks a row and zero-fills the fourth, so q.k^T is unchanged, the
// products' last 8 columns come out 0, and the epilogues write 24 columns.
//
// Layout. Every tensor is (B, T, NH, HD) bf16, so one token's head is one
// row of 2 HD bytes. A tile is 64 such rows of one (row b, head h) in
// shared memory, swizzled for wgmma by the row's width: 16-byte chunk c of
// row r lies at
//   - DH 16, 32-byte rows, the 32-byte swizzle: c ^ ((r / 4) % 2);
//   - DH 32, 64-byte rows, the 64-byte swizzle: c ^ ((r / 2) % 4);
//   - DH 64, 128-byte rows, the 128-byte swizzle: c ^ (r % 8);
//   - DH 128: a 256-byte row is wider than any swizzle atom, so the tile is
//     two 64-column halves, each laid out as a DH 64 tile (chunk c of row r
//     in half c / 8 at (c % 8) ^ (r % 8)).
// wgmma reads a tile
//   - K-major (the product's depth along the row: q, k, v, dO as the A or B
//     of a score product S = X . Y^T): the descriptor's SBO is 8 rows, a
//     16-deep step advances the start by 32 bytes (at DH 128 steps 4-7 in
//     the second half);
//   - MN-major (the B of O = P . V, dq = dS . k, dv = P^T . dO,
//     dk = dS^T . q, whose depth runs over the rows), with wgmma's transpose
//     bit: SBO 8 rows, a 16-deep step advancing 16 rows, and at DH 128 the
//     LBO stepping from one 64-column half to the other.
// So no tile is transposed or copied twice: the kernels read every operand
// as the (B, T, NH, HD) layout stores it.
//
// Block: one consumer warpgroup (warps 0-3) owns 64 rows (queries, or keys
// in K5's dk/dv launch), keeps its two resident tiles for the whole block
// and walks the other side's tiles through a ring of kStages stages; one
// producer warp (warp 4) fills the ring with 16-byte cp.async (zero-filled
// past T) and arrives on the stage's "full" mbarrier when its copies land
// (cp.async.mbarrier.arrive.noinc); each consumer warp arrives on the
// stage's "empty" mbarrier when done with it. No block-wide barrier in the
// loop. The ring is filled by cp.async, not TMA: fed by TMA (four 4-D
// tensor maps a call, the same 64-byte swizzle), K5's dk/dv launch took
// 2-4% less device time at (16, 512), 2% less at (16, 192) and 9% more at
// (16, 32), the finetune chunks' short bucket, on an H100, for 0.3-0.5 us
// of host time a call to encode the maps (tools/probe_attention.py): a
// loss on the finetune step, and no gain that pays for a second fill path.
//
// Tile skipping, exact. Before the loop the block reduces every tile's
// segment ids to (smallest nonzero id, largest id, has a pad). A (query
// tile, key tile) pair can hold an allowed pair only if the id ranges meet
// (overlaps); any other pair adds exp(f32-min - m) = 0 to every valid query
// and is skipped. A pad query (segment <= 0, no allowed key) takes the
// closed form P = bf16(1/T) over all T keys, the same for every pad of a
// (row, head): K1 writes bf16(1/T) times the column sum of v there, and K5
// adds bf16(1/T) times the sum of the pads' dO to every key's dv; both sums
// are read straight from global memory (column_sum), and no tile is visited
// for them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace pct_attn {

using namespace pct_hopper;
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;                        // rows per tile
constexpr int kVecBytes = kTile * 4;             // 64 f32 or int32 per tile
constexpr int kHalfBytes = kTile * 128;          // a 64-column half of a DH 128 tile
constexpr int kStages = 3;
constexpr int kConsumers = 128;                  // one warpgroup
constexpr int kThreads = kConsumers + 32;        // and one producer warp
constexpr int kMaxT = 65536;                     // 1024 tile ranges in shared memory
constexpr float kLog2e = 1.4426950408889634f;

// The tile width of head dim HD.
template <int HD>
constexpr int kWidth = HD == 24 ? 32 : HD;

// The swizzle's period, to which the tiles align: 256, 512 or 1024 bytes.
template <int DH>
constexpr int kAlign = DH >= 64 ? 1024 : 16 * DH;

// A tile of DH columns; a stage: two tiles and three per-row vectors
// (segments, then K5's lse and delta), a multiple of kAlign.
template <int DH>
constexpr int kTileBytes = kTile * DH * 2;
template <int DH>
constexpr int kStageBytes = 2 * kTileBytes<DH> + 4 * kVecBytes;
template <int DH>
constexpr int kResidentBytes = 2 * kTileBytes<DH>;

// Dynamic shared memory of a block for rows of n tiles: 148 KB at DH 128
// and the longest row.
template <int DH>
__host__ __device__ constexpr int smem_bytes(int n) {
  static_assert(DH == 16 || DH == 32 || DH == 64 || DH == 128, "the kernels' head dims");
  static_assert(kStageBytes<DH> % kAlign<DH> == 0 && kResidentBytes<DH> % kAlign<DH> == 0,
                "swizzle period");
  return kAlign<DH> + kResidentBytes<DH> + kStages * kStageBytes<DH> + 16 * n;
}

// The tiles a row of T tokens has.
__host__ __device__ __forceinline__ int tiles_of(int T) { return T / kTile + (T % kTile != 0); }

// The tiles K1's key loop and K5's dk/dv query loop sweep (the planted
// fault's line in chip_smoke.py).
__device__ __forceinline__ int swept_tiles(int T) {
  return (T + kTile - 1) / kTile;
}

// Whether a query tile and a key tile, each as (smallest nonzero segment
// id, largest id, has a pad), can hold an allowed pair: their id ranges
// meet. An empty range is (INT_MAX, 0) and meets nothing.
__device__ __forceinline__ bool overlaps(int4 q, int4 k) {
  return q.x <= k.y && k.x <= q.y;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// The tile layout and wgmma
// ---------------------------------------------------------------------------

// Byte offset in a DH-wide tile of 16-byte chunk c of row r.
template <int DH>
__device__ __forceinline__ uint32_t chunk_offset(int r, int c) {
  if constexpr (DH == 16) {
    return r * 32 + ((c ^ ((r >> 2) & 1)) << 4);
  } else if constexpr (DH == 32) {
    return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
  } else {
    return (c >> 3) * kHalfBytes + r * 128 + (((c & 7) ^ (r & 7)) << 4);
  }
}

// K-major descriptor of a DH-wide tile at 16-deep step ks (0 .. DH/16 - 1).
template <int DH>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int ks) {
  if constexpr (DH == 16) {
    return smem_desc(tile, 16, 256, kSwizzle32);
  } else if constexpr (DH == 32) {
    return smem_desc(tile + 32 * ks, 16, 512, kSwizzle64);
  } else {
    return smem_desc(tile + (ks >> 2) * kHalfBytes + 32 * (ks & 3), 16, 1024, kSwizzle128);
  }
}

// MN-major descriptor of 16 rows (step kk, 0-3) of a tile read N columns
// wide: N = 128 spans both halves of a DH 128 tile (LBO: the half's
// stride), N = 64 one half or a DH 64 tile.
template <int N>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  if constexpr (N == 16) {
    return smem_desc(tile + 512 * kk, kTileBytes<16>, 256, kSwizzle32);
  } else if constexpr (N == 32) {
    return smem_desc(tile + 1024 * kk, kTileBytes<32>, 512, kSwizzle64);
  } else {
    return smem_desc(tile + 2048 * kk, kHalfBytes, 1024, kSwizzle128);
  }
}

// d (64 x 64) = A . B^T + (scale_d ? d : 0): A and B 64 x 16 bf16, K-major
// in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x N) = A . B + (scale_d ? d : 0) for N = 16, 32, 64, 128 (d holds
// N / 2 floats a thread): A 64 x 16 bf16 from registers (fragments as to_a
// makes them), B 16 x N bf16 MN-major in shared memory.

__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// A fragments of bf16(x) for the four 16-column steps of a 64 x 64
// accumulator: the accumulator's element (row, col) becomes the A
// operand's (row, k = col).
__device__ __forceinline__ void to_a(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16x2(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_bf16x2(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16x2(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16x2(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// acc (64 x N) = bf16(x) . tile over four 16-row steps, tile MN-major and
// read N columns wide; acc is overwritten when first is true.
template <int N>
__device__ __forceinline__ void accumulate(float (&acc)[N / 2], const float (&x)[32],
                                           uint32_t tile, bool first) {
  uint32_t a[4][4];
  to_a(x, a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, a[kk], mnmajor<N>(tile, kk), !first || kk > 0);
}

// s (64 x 64) = resident A tile . stage B tile^T (both K-major, DH deep).
template <int DH>
__device__ __forceinline__ void scores(float (&s)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) wgmma_ss(s, kmajor<DH>(a, ks), kmajor<DH>(b, ks), ks > 0);
}

// The accumulator element i of this thread: fragment row (0: g, 1: g + 8)
// and column.
__device__ __forceinline__ int acc_row(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int acc_col(int i, int tig) { return 8 * (i >> 2) + 2 * tig + (i & 1); }

// ---------------------------------------------------------------------------
// The block: its (row, head), shared memory and ring
// ---------------------------------------------------------------------------

template <int HD>
struct Head {
  int64_t base;      // element offset of (b, 0, h, 0)
  int64_t tok;       // elements between tokens: NH * HD
  int64_t vec;       // offset of (b, h, 0) in a (B, NH, T) vector
  const int32_t* seg_row;
  __device__ Head(const int32_t* seg, int T, int NH)
      : base(static_cast<int64_t>(blockIdx.z) * T * NH * HD +
             static_cast<int64_t>(blockIdx.y) * HD),
        tok(static_cast<int64_t>(NH) * HD),
        vec((static_cast<int64_t>(blockIdx.z) * NH + blockIdx.y) * T),
        seg_row(seg + static_cast<int64_t>(blockIdx.z) * T) {}
};

template <int DH>
struct Ring {
  uint32_t resident;   // two resident tiles
  uint32_t stages;     // kStages stages
  const uint8_t* stage_ptr;
  const int4* ranges;  // per tile of the row
  uint32_t full, empty, ready;

  __device__ uint32_t stage(int it) const { return stages + (it % kStages) * kStageBytes<DH>; }
  __device__ const int32_t* vec(int it, int i) const {
    return reinterpret_cast<const int32_t*>(stage_ptr + (it % kStages) * kStageBytes<DH> +
                                            2 * kTileBytes<DH> + i * kVecBytes);
  }
};

// Every warp of a block of `threads` threads: the range of each tile of a
// row of T segment ids, (smallest nonzero id, largest id, has a pad), into
// ranges[tiles_of(T)], one warp a tile. The caller syncs before reading.
__device__ __forceinline__ void tile_ranges(int4* ranges, const int32_t* seg_row, int T,
                                            int threads) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int j = warp; j < tiles_of(T); j += threads / 32) {
    int lo = INT_MAX, hi = 0, pad = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = j * kTile + lane + 32 * i;
      if (t < T) {
        const int s = seg_row[t];
        if (s > 0) {
          lo = min(lo, s);
          hi = max(hi, s);
        } else {
          pad = 1;
        }
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    pad = __reduce_or_sync(0xffffffffu, pad);
    if (lane == 0) ranges[j] = make_int4(lo, hi, pad, 0);
  }
}

// Carves the dynamic shared memory, has the producer warp start its
// resident tiles' copies (load_resident(address); their arrival on ready
// comes later), initialises the barriers (full: 32 producer arrivals;
// empty: 4 consumer warps; ready: 32) and reduces the segments of every
// tile of the row to its range, while those copies fly. Ends with the
// kernel's only block-wide barrier.
template <int DH, class LoadResident>
__device__ __forceinline__ Ring<DH> setup(uint8_t* smem_raw, uint64_t* bars,
                                          const int32_t* seg_row, int T,
                                          LoadResident load_resident) {
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + ((kAlign<DH> - (raw & (kAlign<DH> - 1))) & (kAlign<DH> - 1));
  Ring<DH> r;
  r.resident = smem_u32(base);
  r.stages = r.resident + kResidentBytes<DH>;
  r.stage_ptr = base + kResidentBytes<DH>;
  int4* ranges =
      reinterpret_cast<int4*>(base + kResidentBytes<DH> + kStages * kStageBytes<DH>);
  r.ranges = ranges;
  r.full = smem_u32(bars);
  r.empty = r.full + 8 * kStages;
  r.ready = r.empty + 8 * kStages;
  if (threadIdx.x >= kConsumers) load_resident(r.resident);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(r.full + 8 * s, 32);
      mbar_init(r.empty + 8 * s, kConsumers / 32);
    }
    mbar_init(r.ready, 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  tile_ranges(ranges, seg_row, T, kThreads);
  __syncthreads();
  return r;
}

// Producer: rows [t0, t0 + 64) of a (B, T, NH, HD) tensor into a tile,
// zeros past T (and past HD in a wider tile); DH / 8 16-byte chunks a row,
// DH / 4 per lane, neighbouring lanes on neighbouring chunks of a row.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, const Head<HD>& hd,
                                          int t0, int T, int lane) {
  constexpr int DH = kWidth<HD>;
  constexpr int kChunks = DH / 8;
#pragma unroll
  for (int i = 0; i < kChunks * kTile / 32; ++i) {
    const unsigned c = lane + 32 * i;
    const int r = c / kChunks;
    const int ch = c % kChunks;
    if constexpr (HD == DH) {
      const bool ok = t0 + r < T;
      cp_async16(dst + chunk_offset<DH>(r, ch),
                 src + hd.base + (ok ? t0 + r : 0) * hd.tok + ch * 8, ok);
    } else {
      const bool ok = t0 + r < T && 8 * ch < HD;
      cp_async16(dst + chunk_offset<DH>(r, ch),
                 src + hd.base + (ok ? (t0 + r) * hd.tok + ch * 8 : 0), ok);
    }
  }
}

// Producer: entries [t0, t0 + 64) of a per-token row of 32-bit values
// (segments, or one (b, h) of a (B, NH, T) vector), zeros past T.
__device__ __forceinline__ void load_vec(uint32_t dst, const void* src, int64_t base, int t0,
                                         int T, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int e = lane + 32 * i;
    const bool ok = t0 + e < T;
    cp_async4(dst + 4 * e, static_cast<const uint32_t*>(src) + base + (ok ? t0 + e : 0), ok);
  }
}

// Producer: the stage for the it-th visited tile, once the consumers have
// released it.
template <int DH>
__device__ __forceinline__ uint32_t claim(const Ring<DH>& r, int it) {
  mbar_wait(r.empty + 8 * (it % kStages), ((it / kStages) & 1) ^ 1);
  return r.stage(it);
}

// Producer: the stage's copies are issued; its full barrier completes when
// they land.
template <int DH>
__device__ __forceinline__ void fill(const Ring<DH>& r, int it) {
  cp_async_arrive(r.full + 8 * (it % kStages));
}

// Consumer: waits for the it-th visited tile.
template <int DH>
__device__ __forceinline__ uint32_t take(const Ring<DH>& r, int it) {
  mbar_wait(r.full + 8 * (it % kStages), (it / kStages) & 1);
  fence_proxy_async();  // cp.async's writes before wgmma's reads
  return r.stage(it);
}

// Consumer: this warp is done with the stage (its wgmma groups waited for).
template <int DH>
__device__ __forceinline__ void release(const Ring<DH>& r, int it) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(r.empty + 8 * (it % kStages));
}

// Consumer: waits for the resident tiles.
template <int DH>
__device__ __forceinline__ void take_resident(const Ring<DH>& r) {
  mbar_wait(r.ready, 0);
  fence_proxy_async();
}

// A pad query's softmax weight, 1/T rounded to bf16 as P is for P.V.
__device__ __forceinline__ float pad_weight(int T) {
  return __bfloat162float(__float2bfloat16_rn(__frcp_rn(static_cast<float>(T))));
}

// Consumer warpgroup: out[d] (d < DH = kWidth<HD>) = the f32 sum over the
// rows t < T of a (B, T, NH, HD) tensor's head, every row or (pads_only)
// those whose segment is <= 0, read straight from global memory: DH / 8
// threads a row, one 16-byte chunk each (chunks past HD sum 0), 128 /
// (DH / 8) rows at a time; then the threads of a chunk across each warp,
// then the four warps, always in the same order. scratch: 4 DH floats. out
// is visible to the whole warpgroup on return.
template <int HD>
__device__ __forceinline__ void column_sum(float* out, float* scratch, const bf16* src,
                                           const Head<HD>& hd, int T, bool pads_only) {
  constexpr int DH = kWidth<HD>;
  constexpr int kChunks = DH / 8;
  const int tid = threadIdx.x;
  const int ch = tid & (kChunks - 1);  // dims 8 ch .. 8 ch + 7
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (8 * ch < HD) {
    for (int t = tid / kChunks; t < T; t += kConsumers / kChunks) {
      if (pads_only && hd.seg_row[t] > 0) continue;
      const uint4 raw = *reinterpret_cast<const uint4*>(src + hd.base + t * hd.tok + 8 * ch);
      const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(pair[e]);
        acc[2 * e] += f.x;
        acc[2 * e + 1] += f.y;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
#pragma unroll
    for (int off = kChunks; off < 32; off *= 2) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  }
  const int lane = tid & 31;
  if (lane < kChunks) {
#pragma unroll
    for (int e = 0; e < 8; ++e) scratch[(tid >> 5) * DH + lane * 8 + e] = acc[e];
  }
  named_barrier(1, kConsumers);
  if (tid < DH) out[tid] = scratch[tid] + scratch[DH + tid] + scratch[2 * DH + tid] + scratch[3 * DH + tid];
  named_barrier(1, kConsumers);
}

// Host: lets a kernel use the dynamic shared memory of the longest row.
template <int DH, class Kernel>
inline cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<DH>(tiles_of(kMaxT)));
}

// Host: launch(std::integral_constant<int, HD>()) for head dim hd;
// cudaErrorInvalidValue for a head dim the kernels do not take.
template <class Launch>
inline int by_head_dim(int hd, Launch launch) {
  switch (hd) {
    case 16:
      return launch(std::integral_constant<int, 16>());
    case 24:
      return launch(std::integral_constant<int, 24>());
    case 32:
      return launch(std::integral_constant<int, 32>());
    case 64:
      return launch(std::integral_constant<int, 64>());
    case 128:
      return launch(std::integral_constant<int, 128>());
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace pct_attn
