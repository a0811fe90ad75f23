// What the f32 attention kernels, K1-f32 (attention_fwd_f32.cu) and K5-f32
// (attention_bwd_f32.cu), share on Hopper (sm_90a): their products as
// 3xTF32 on the tensor cores (wgmma m64nNk8 .tf32), the tiles those read,
// the producer warpgroup that fills a ring of them and the block's layout.
// From attention.cuh they take the segment logic as it is: per-tile
// segment ranges (tile_ranges), the skip predicate (overlaps), the swept
// loop's length (swept_tiles) and the head's offsets (Head), so the
// planted faults of those lines reach these kernels too.
//
// 3xTF32. TF32 wgmma keeps 10 mantissa bits of each operand; every operand
// v is split into hi = tf32(v) (rounded to nearest, low bits cleared) and
// lo = tf32(v - hi), and a product is hi.lo + lo.hi + hi.hi (kProducts), the
// two small ones first, summed in f32 by the tensor core into a fresh
// accumulator: the score products (S = q.k^T, dP = dO.v^T and their
// transposes) over the head dim, and the value products (O += P.V, dq +=
// dS.k, dk += dS^T.q, dv += P^T.dO) over a stage's keys or queries, whose
// partial is then added to the f32 sum in registers (the tensor core's own
// adds round toward zero, an error that grows with what it accumulates).
//
// Operands. TF32 wgmma reads B from shared memory K-major only (the
// product's depth along a tile row) and takes no transpose bit:
//   - A of a score product: one of the block's resident tiles (q, dO, or in
//     K5's dk/dv launch k, v), raw f32 in shared memory, read by each
//     consumer thread a 32-deep k-block at a time with four 16-byte loads
//     and split in registers (a_fragments). That fixes the depth order of
//     a k-step, as in K6-f32 (mma_gemm.cuh): k-step s of a k-block takes
//     its depths s, 4 + s, ..., 28 + s, fragment column j at depth
//     8 (j % 4) + 4 (j / 4) + s;
//   - B of a score product: the streamed rows (k, v, or q, dO) as a
//     "natural" tile, one tile row a token, its depth (the head dim) in that
//     order, split into hi and lo tiles by the producer;
//   - A of a value product: the score accumulator itself (P, dS or their
//     transposes), split in registers. A thread holds the accumulator's
//     columns 8 j + 2 t and 8 j + 2 t + 1, where the m64k8 A fragment wants
//     k = t and t + 4: so k-step j takes keys 8 j + 2 t at k = t and
//     8 j + 2 t + 1 at k = t + 4, and P never leaves the registers;
//   - B of a value product: the streamed rows turned by the producer into
//     a "transposed" tile, one tile row a head-dim column, its depth the
//     stage's tokens in that order (key 8 j + r at k = 4 (r % 2) + r / 2 of
//     k-step j), split into hi and lo.
// Every tile is K-major with the 128-byte swizzle: 32-float k-blocks of
// R rows x 128 bytes, 16-byte chunk c of row r at c ^ (r % 8) (km_offset),
// each 1024-byte aligned.
//
// Block: WGS consumer warpgroups (warps 4 w .. 4 w + 3), each over its own
// 64 rows (queries, or keys in K5's dk/dv launch), and one producer
// warpgroup, the last. The producer copies the resident tiles by
// cp.async, then for each stage that any consumer's rows meet loads the
// streamed rows into registers one stage ahead, each thread whole 16-byte
// chunks of the tiles it stores (Slab), splits and stores them, the
// stage's per-row vectors beside them, and arrives on the stage's "full"
// mbarrier; each consumer warp arrives on "empty" when its products of the
// stage are done (a warpgroup whose rows the stage does not meet skips
// it). A stage
// holds KS = 64 streamed rows (32 at head dim 128, where a 64-row stage of
// K5's dk/dv launch would not fit in shared memory), so a 64-row tile of
// the segment logic is 64 / KS stages; the ring is up to three stages deep
// (two and four took the same time within 2% on an H100,
// tools/probe_attention_f32.py). Head dims below 32 run 32 wide (zeros
// past the head dim: the products are unchanged, and the epilogues write
// the head dim's columns). Column sums of a head (the pad queries' closed
// forms) are read straight from global memory by the producer once the
// ring is filled (column_sum).

#pragma once

#include "attention.cuh"

namespace pct_attn_f32 {

using namespace pct_hopper;
using pct_attn::acc_col;
using pct_attn::acc_row;
using pct_attn::ex2;
using pct_attn::Head;
using pct_attn::kLog2e;
using pct_attn::kMaxT;
using pct_attn::kTile;
using pct_attn::quad_max;
using pct_attn::quad_sum;
using pct_attn::tiles_of;

constexpr int kProducts = 3;  // TF32 products per k-step: hi.hi, hi.lo, lo.hi
constexpr int kProducer = 128;                     // one warpgroup
constexpr int kRowBytes = 128;                     // a k-block row: 32 floats
constexpr int kBlockSmem = 232448;                 // what a block may use on an H100
constexpr int kStaticReserve = 2048;               // the kernels' static shared memory
constexpr int kMaxStages = 3;

// The tile width of head dim HD (16 and 24 run 32 wide).
template <int HD>
constexpr int kWidth = HD <= 32 ? 32 : HD;

// Streamed rows a stage holds.
template <int DW>
constexpr int kRows = DW == 128 ? 32 : 64;

__device__ __forceinline__ void st_shared4(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ float4 ld_shared_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float part(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------------------
// Tiles and products
// ---------------------------------------------------------------------------

// Byte offset of 16-byte chunk c (depths 4 c .. 4 c + 3) of row r in a
// K-major tile of R rows.
template <int R>
__device__ __forceinline__ uint32_t km_offset(int r, int c) {
  return (c >> 3) * (R * kRowBytes) + r * kRowBytes + (((c & 7) ^ (r & 7)) << 4);
}

// Descriptor of k-step s (8 deep) of a K-major tile of R rows, from row
// row0 (a multiple of 8) on.
template <int R>
__device__ __forceinline__ uint64_t km_desc(uint32_t tile, int s, int row0 = 0) {
  return smem_desc(tile + (s >> 2) * (R * kRowBytes) + row0 * kRowBytes + 32 * (s & 3), 16, 1024);
}

// The TF32 product m64nNk8 for N = 32, 64, 128 (d holds N / 2 floats).
__device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                    int scale_d) {
  wgmma_tf32_n32(d, a, b, scale_d);
}

template <int R>
__device__ __forceinline__ void mma(float (&d)[R], const uint32_t (&a)[4], uint64_t b,
                                    int scale_d) {
  wgmma_tf32(d, a, b, scale_d);
}

// This consumer thread's A fragments of k-block kb of a resident raw tile
// (rows 16 w + g and + 8 of warp w, lane 4 g + t), split: k-step s of the
// block in hi[s], lo[s].
__device__ __forceinline__ void a_fragments(uint32_t tile, int kb, uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + g;
  const uint32_t base = tile + kb * (kTile * kRowBytes);
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // fragment columns t (h 0) and t + 4 (h 1)
    const uint32_t off = ((2 * t + h) ^ g) << 4;  // rows r0 and r0 + 8 share r % 8 = g
    const float4 x0 = ld_shared_f4(base + r0 * kRowBytes + off);
    const float4 x1 = ld_shared_f4(base + (r0 + 8) * kRowBytes + off);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      split(part(x0, s), hi[s][2 * h], lo[s][2 * h]);
      split(part(x1, s), hi[s][2 * h + 1], lo[s][2 * h + 1]);
    }
  }
}

// Issues k-block kb of s (64 x N) = A . B^T: A's split fragments hi, lo
// (a_fragments), B the N rows of a stage's natural tile (hi at b_hi, lo N
// DW floats after it); the hi.lo and lo.hi products first.
template <int DW, int N>
__device__ __forceinline__ void issue_scores(float (&s)[N / 2], const uint32_t (&hi)[4][4],
                                             const uint32_t (&lo)[4][4], uint32_t b_hi, int kb) {
  const uint32_t b_lo = b_hi + N * DW * 4;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (kProducts > 1) {
      mma(s, hi[ks], km_desc<N>(b_lo, 4 * kb + ks), kb > 0 || ks > 0);
      mma(s, lo[ks], km_desc<N>(b_hi, 4 * kb + ks), 1);
    }
  }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    mma(s, hi[ks], km_desc<N>(b_hi, 4 * kb + ks), kProducts > 1 || kb > 0 || ks > 0);
  }
}

// s (64 x N) = A . B^T over the depth DW: A the consumers' 64 rows of a
// resident raw tile (a_fragments), B the N rows of a stage's natural tile.
// One k-block's 12 products a wgmma group.
template <int DW, int N>
__device__ __forceinline__ void scores(float (&s)[N / 2], uint32_t a_tile, uint32_t b_hi) {
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int kb = 0; kb < DW / 32; ++kb) {
    a_fragments(a_tile, kb, hi, lo);
    fence_operands(hi);
    fence_operands(lo);
    if (kb > 0) fence_operands(s);
    wgmma_fence();
    issue_scores<DW, N>(s, hi, lo, b_hi, kb);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);
    fence_operands(hi);
    fence_operands(lo);
  }
}

// acc (64 x DW) += X . B^T over the stage's KS rows: X the 64 x KS score
// accumulator x (its element (row, column c) is A's (row, k = c)), split
// here; B the DW rows of a stage's transposed tile (hi at b_hi, lo DW KS
// floats after it). In column chunks of at most 64, each into a fresh
// partial that is added to acc in f32.
template <int DW, int KS>
__device__ __forceinline__ void accumulate(float (&acc)[DW / 2], const float (&x)[KS / 2],
                                           uint32_t b_hi) {
  constexpr int NC = DW < 64 ? DW : 64;
  const uint32_t b_lo = b_hi + DW * KS * 4;
  uint32_t hi[KS / 8][4], lo[KS / 8][4];
#pragma unroll
  for (int j = 0; j < KS / 8; ++j) {  // keys 8 j + 2 t at k = t, 8 j + 2 t + 1 at k = t + 4
    split(x[4 * j], hi[j][0], lo[j][0]);
    split(x[4 * j + 2], hi[j][1], lo[j][1]);
    split(x[4 * j + 1], hi[j][2], lo[j][2]);
    split(x[4 * j + 3], hi[j][3], lo[j][3]);
  }
#pragma unroll
  for (int ch = 0; ch < DW / NC; ++ch) {
    float p[NC / 2];
    fence_operands(hi);
    fence_operands(lo);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KS / 8; ++j) {
      if (kProducts > 1) {
        mma(p, hi[j], km_desc<DW>(b_lo, j, NC * ch), j > 0);
        mma(p, lo[j], km_desc<DW>(b_hi, j, NC * ch), 1);
      }
    }
#pragma unroll
    for (int j = 0; j < KS / 8; ++j) {
      mma(p, hi[j], km_desc<DW>(b_hi, j, NC * ch), kProducts > 1 || j > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(p);
    fence_operands(hi);
    fence_operands(lo);
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[ch * (NC / 2) + i] += p[i];
  }
}

// ---------------------------------------------------------------------------
// The producer
// ---------------------------------------------------------------------------

// Producer thread p: rows [t0, t0 + 64) of a (B, T, NH, HD) f32 tensor's
// head into a resident raw tile by cp.async, zeros past T and past HD.
template <int HD>
__device__ __forceinline__ void load_resident(uint32_t dst, const float* __restrict__ src,
                                              const Head<HD>& hd, int t0, int T, int p) {
  constexpr int C = kWidth<HD> / 4;
  for (int f = p; f < kTile * C; f += kProducer) {
    const int r = f / C;
    const int c = f % C;
    const bool ok = t0 + r < T && 4 * c < HD;
    cp_async16(dst + km_offset<kTile>(r, c), src + (ok ? hd.base + (t0 + r) * hd.tok + 4 * c : 0),
               ok);
  }
}

// A producer thread's share of KS streamed rows of a (B, T, NH, HD) f32
// tensor, in one of two shapes, each holding whole 16-byte chunks of the
// tiles it is stored into:
//   - natural units (kNat): unit u = p + 128 i is row n = u % KS of k-block
//     kb and parity b (u / KS = 2 kb + b), its 16-byte chunks b, b + 2,
//     b + 4, b + 6 of the k-block in v[i][0..3]: element s of each makes
//     16-byte chunk 2 s + b of the natural tile's row (a_fragments' depth
//     order); a warp's lanes are 32 rows, so the swizzle spreads its
//     16-byte stores over every bank;
//   - transposed units: unit u is 16-byte chunk c of the rows 32 kk + 8 j +
//     r + 2 e (e < 4) with q = u % 8 = 2 j + r, u / 8 = C kk + c: element i
//     of each makes 16-byte chunk q of the transposed tile's row 4 c + i
//     (accumulate's key order); a warp's 8 values of q fill 8 distinct
//     chunks of a row.
template <int HD, int KS, bool kNat>
struct Slab {
  static constexpr int DW = kWidth<HD>;
  static constexpr int C = DW / 4;
  static constexpr int kUnits = (kNat ? KS * (DW / 32) * 2 : 8 * C * (KS / 32)) / kProducer;
  static_assert(kUnits >= 1, "every producer thread has a unit");
  float4 v[kUnits][4];

  // Row and 16-byte chunk of value e of unit i (thread p).
  __device__ static int row(int i, int e, int p) {
    const int u = p + kProducer * i;
    if constexpr (kNat) {
      return u % KS;
    } else {
      return 32 * ((u / 8) / C) + 8 * ((u % 8) >> 1) + (u & 1) + 2 * e;
    }
  }
  __device__ static int chunk(int i, int e, int p) {
    const int u = p + kProducer * i;
    if constexpr (kNat) {
      return 8 * ((u / KS) >> 1) + ((u / KS) & 1) + 2 * e;
    } else {
      return (u / 8) % C;
    }
  }
};

// Rows [t0, t0 + KS) into registers, zeros past T and past HD.
template <int HD, int KS, bool kNat>
__device__ __forceinline__ void load_slab(Slab<HD, KS, kNat>& s, const float* __restrict__ src,
                                          const Head<HD>& hd, int t0, int T, int p) {
  using Sl = Slab<HD, KS, kNat>;
#pragma unroll
  for (int i = 0; i < Sl::kUnits; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = Sl::row(i, e, p);
      const int c = Sl::chunk(i, e, p);
      s.v[i][e] = t0 + n < T && 4 * c < HD
                      ? *reinterpret_cast<const float4*>(src + hd.base + (t0 + n) * hd.tok + 4 * c)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// Natural units split into the natural tile (KS rows, depth DW; hi at dst,
// lo KS DW floats after it): depth 4 c + e of a row (within its k-block)
// at chunk 2 e + c % 2, element (c % 8) / 2; 16-byte stores.
template <int HD, int KS>
__device__ __forceinline__ void store_natural(const Slab<HD, KS, true>& s, uint32_t dst, int p) {
  using Sl = Slab<HD, KS, true>;
#pragma unroll
  for (int i = 0; i < Sl::kUnits; ++i) {
    const int n = Sl::row(i, 0, p);
    const int c0 = Sl::chunk(i, 0, p);  // 8 kb + b
    const uint32_t row = dst + (c0 >> 3) * (KS * kRowBytes) + n * kRowBytes;
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // chunk 2 e + b holds element e of the unit's four
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) split(part(s.v[i][k], e), hi[k], lo[k]);
      const uint32_t at = row + (((2 * e + (c0 & 1)) ^ (n & 7)) << 4);
      st_shared16(at, hi[0], hi[1], hi[2], hi[3]);
      st_shared16(at + KS * Sl::DW * 4, lo[0], lo[1], lo[2], lo[3]);
    }
  }
}

// Byte offset of key x (< KS) in row d of a transposed tile of DW rows:
// key 8 j + r of a 32-key k-block at chunk 2 j + r % 2, element r / 2.
template <int DW>
__device__ __forceinline__ uint32_t trans_offset(int d, int x) {
  const int chunk = 2 * ((x & 31) >> 3) + (x & 1);
  return (x >> 5) * (DW * kRowBytes) + d * kRowBytes + ((chunk ^ (d & 7)) << 4) + ((x & 7) >> 1) * 4;
}

// Transposed units split into the transposed tile (DW rows, one a head-dim
// column; depth the KS rows; hi at dst, lo DW KS floats after it); 16-byte
// stores.
template <int HD, int KS>
__device__ __forceinline__ void store_transposed(const Slab<HD, KS, false>& s, uint32_t dst,
                                                 int p) {
  using Sl = Slab<HD, KS, false>;
#pragma unroll
  for (int i = 0; i < Sl::kUnits; ++i) {
    const int c = Sl::chunk(i, 0, p);
    const int x = Sl::row(i, 0, p);  // the unit's first key: its chunk q, element 0
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // row 4 c + e holds element e of the unit's four keys
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) split(part(s.v[i][k], e), hi[k], lo[k]);
      const uint32_t at = dst + trans_offset<Sl::DW>(4 * c + e, x);
      st_shared16(at, hi[0], hi[1], hi[2], hi[3]);
      st_shared16(at + Sl::DW * KS * 4, lo[0], lo[1], lo[2], lo[3]);
    }
  }
}

// Natural units split into the transposed tile as well (the tensors whose
// two products read both): 4-byte stores, a warp's 32 rows into 32
// distinct words of a tile row.
template <int HD, int KS>
__device__ __forceinline__ void store_transposed(const Slab<HD, KS, true>& s, uint32_t dst,
                                                 int p) {
  using Sl = Slab<HD, KS, true>;
#pragma unroll
  for (int i = 0; i < Sl::kUnits; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int n = Sl::row(i, k, p);
      const int c = Sl::chunk(i, k, p);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t hi, lo;
        split(part(s.v[i][k], e), hi, lo);
        const uint32_t at = dst + trans_offset<Sl::DW>(4 * c + e, n);
        st_shared4(at, hi);
        st_shared4(at + Sl::DW * KS * 4, lo);
      }
    }
  }
}

// What a stage holds: the streamed tensors a and b, each as a natural
// and/or a transposed tile (hi, then lo), then kVecs per-row vectors of KS
// 32-bit values (segments, then K5's lse and delta), 256 bytes each.
template <int HD, bool kNatA, bool kTransA, bool kNatB, bool kTransB, int kVecs_>
struct Stage {
  static constexpr int DW = kWidth<HD>;
  static constexpr int KS = kRows<DW>;
  static constexpr int kParts = kTile / KS;  // stages a 64-row tile
  static constexpr int kVecs = kVecs_;
  static constexpr int kSplitBytes = 2 * KS * DW * 4;
  static constexpr int kNatA_ = 0;
  static constexpr int kTransA_ = kNatA_ + (kNatA ? kSplitBytes : 0);
  static constexpr int kNatB_ = kTransA_ + (kTransA ? kSplitBytes : 0);
  static constexpr int kTransB_ = kNatB_ + (kNatB ? kSplitBytes : 0);
  static constexpr int kVec = kTransB_ + (kTransB ? kSplitBytes : 0);
  static constexpr int kBytes = kVec + 1024;  // a multiple of the 1024-byte alignment
  static constexpr bool nat_a = kNatA, trans_a = kTransA, nat_b = kNatB, trans_b = kTransB;
};

// The block's dynamic shared memory: kResident raw 64-row tiles, the ring
// of St stages and the tile ranges of a row of n tiles, after up to 1024
// bytes of alignment.
template <class St, int kResident>
struct Layout {
  static constexpr int kResidentBytes = kResident * kTile * St::DW * 4;
  static constexpr int kFree =
      kBlockSmem - kStaticReserve - 1024 - kResidentBytes - 16 * (kMaxT / kTile);
  static constexpr int kStages = kFree / St::kBytes < kMaxStages ? kFree / St::kBytes : kMaxStages;
  static_assert(kStages >= 1, "a stage fits");
  static constexpr int bytes(int n) { return 1024 + kResidentBytes + kStages * St::kBytes + 16 * n; }
};

// The carved shared memory and barriers of a block.
struct Ring {
  uint32_t resident;    // the resident raw tiles, 64 DW floats each
  uint32_t stages;
  const uint8_t* stage_ptr;
  int4* ranges;
  uint32_t full, empty, ready;
};

// Carves the dynamic shared memory and initialises the barriers (full: the
// producer's 128 arrivals; empty: the 4 WGS consumer warps; ready: 128
// cp.async arrivals). The caller syncs the block before using either.
template <class L, class St, int WGS>
__device__ __forceinline__ Ring carve(uint8_t* smem_raw, uint64_t* bars) {
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + ((1024 - (raw & 1023)) & 1023);
  Ring r;
  r.resident = smem_u32(base);
  r.stages = r.resident + L::kResidentBytes;
  r.stage_ptr = base + L::kResidentBytes;
  r.ranges = reinterpret_cast<int4*>(base + L::kResidentBytes + L::kStages * St::kBytes);
  r.full = smem_u32(bars);
  r.empty = r.full + 8 * L::kStages;
  r.ready = r.empty + 8 * L::kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(r.full + 8 * s, kProducer);
      mbar_init(r.empty + 8 * s, 4 * WGS);
    }
    mbar_init(r.ready, kProducer);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  return r;
}

// The producer warpgroup (thread p of 128): every visited stage in order
// (the 64-row tiles j < n with visit(j), each as St::kParts stages of KS
// rows), a and b loaded one stage ahead into registers, then split and
// stored into the stage once the consumers have released it, with the
// vectors vec[v] (32-bit values per token of the row, null for none)
// beside them.
template <int HD, class St, int kStages, class Visit>
__device__ __forceinline__ void produce(const float* __restrict__ a, const float* __restrict__ b,
                                        const uint32_t* const (&vec)[3], const Head<HD>& hd,
                                        int T, int n, Visit visit, const Ring& ring, int p) {
  constexpr int KS = St::KS;
  using SlabA = Slab<HD, KS, St::nat_a>;  // a tensor read natural (and transposed) or transposed
  using SlabB = Slab<HD, KS, St::nat_b>;
  SlabA sa[2];
  SlabB sb[2];
  uint32_t vv[2][3];
  int j = 0;
  while (j < n && !visit(j)) ++j;
  int u = 0;
  auto fetch = [&](SlabA& xa, SlabB& xb, uint32_t (&xv)[3], int t0) {
    load_slab(xa, a, hd, t0, T, p);
    load_slab(xb, b, hd, t0, T, p);
#pragma unroll
    for (int v = 0; v < St::kVecs; ++v) xv[v] = p < KS && t0 + p < T ? vec[v][t0 + p] : 0u;
  };
  if (j < n) fetch(sa[0], sb[0], vv[0], j * kTile);
  int it = 0;
  while (j < n) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (j < n) {
        int j2 = j, u2 = u + 1;
        if (u2 == St::kParts) {
          u2 = 0;
          do {
            ++j2;
          } while (j2 < n && !visit(j2));
        }
        if (j2 < n) fetch(sa[x ^ 1], sb[x ^ 1], vv[x ^ 1], j2 * kTile + u2 * KS);
        const int slot = it % kStages;
        mbar_wait(ring.empty + 8 * slot, ((it / kStages) & 1) ^ 1);
        const uint32_t st = ring.stages + slot * St::kBytes;
        if constexpr (St::nat_a) store_natural(sa[x], st + St::kNatA_, p);
        if constexpr (St::trans_a) store_transposed(sa[x], st + St::kTransA_, p);
        if constexpr (St::nat_b) store_natural(sb[x], st + St::kNatB_, p);
        if constexpr (St::trans_b) store_transposed(sb[x], st + St::kTransB_, p);
        if (p < KS) {
#pragma unroll
          for (int v = 0; v < St::kVecs; ++v) st_shared4(st + St::kVec + 256 * v + 4 * p, vv[x][v]);
        }
        fence_proxy_async();  // the generic-proxy stores before the consumers' wgmma reads
        mbar_arrive(ring.full + 8 * slot);
        ++it;
        j = j2;
        u = u2;
      }
    }
  }
}

// Consumer: waits for the it-th stage; returns its shared-memory address.
template <class St, int kStages>
__device__ __forceinline__ uint32_t take(const Ring& r, int it) {
  mbar_wait(r.full + 8 * (it % kStages), (it / kStages) & 1);
  return r.stages + (it % kStages) * St::kBytes;
}

// Consumer: vector v of the it-th stage.
template <class St, int kStages, class V>
__device__ __forceinline__ const V* stage_vec(const Ring& r, int it, int v) {
  return reinterpret_cast<const V*>(r.stage_ptr + (it % kStages) * St::kBytes + St::kVec + 256 * v);
}

// Consumer: this warp is done with the it-th stage (its wgmma groups waited for).
template <int kStages>
__device__ __forceinline__ void release(const Ring& r, int it) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(r.empty + 8 * (it % kStages));
}

// The producer warpgroup (thread tid of 128), once the ring is filled:
// out[d] (d < DW) = the f32 sum over the rows t < T of a (B, T, NH, HD) f32
// tensor's head, every row or (pads_only) those whose segment is <= 0,
// read straight from global memory: DW / 4 threads a row, one 16-byte
// chunk each (chunks past HD sum 0), 128 / (DW / 4) rows at a time; then
// the threads of a chunk across each warp, then the four warps, always in
// the same order. scratch: 4 DW floats. out is visible to the warpgroup on
// return (named barrier 3, the producer's own).
template <int HD>
__device__ __forceinline__ void column_sum(float* out, float* scratch,
                                           const float* __restrict__ src, const Head<HD>& hd,
                                           int T, bool pads_only, int tid) {
  constexpr int DW = kWidth<HD>;
  constexpr int C = DW / 4;
  const int c = tid % C;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (4 * c < HD) {
#pragma unroll 4
    for (int t = tid / C; t < T; t += 128 / C) {
      if (pads_only && hd.seg_row[t] > 0) continue;
      const float4 x = *reinterpret_cast<const float4*>(src + hd.base + t * hd.tok + 4 * c);
      acc[0] += x.x;
      acc[1] += x.y;
      acc[2] += x.z;
      acc[3] += x.w;
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int off = C; off < 32; off *= 2) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  }
  const int lane = tid & 31;
  if (lane < C) {
#pragma unroll
    for (int e = 0; e < 4; ++e) scratch[(tid >> 5) * DW + 4 * lane + e] = acc[e];
  }
  named_barrier(3, kProducer);
  if (tid < DW) out[tid] = scratch[tid] + scratch[DW + tid] + scratch[2 * DW + tid] + scratch[3 * DW + tid];
  named_barrier(3, kProducer);
}

// The ranges of a block's tiles tile0 + w (w < WGS), the empty range for
// one past the row's last tile.
template <int WGS>
__device__ __forceinline__ void owned(int4 (&own)[WGS], const int4* ranges, int tile0, int T) {
#pragma unroll
  for (int w = 0; w < WGS; ++w) {
    own[w] = tile0 + w < tiles_of(T) ? ranges[tile0 + w] : make_int4(INT_MAX, 0, 0, 0);
  }
}

// Consumer: the thread's rows of its warpgroup's 64 (from r0): 16 w + g +
// 8 h for warp w of the warpgroup, lane 4 g + t.
__device__ __forceinline__ void own_rows(int (&row)[2], int r0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = r0 + ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) + 8 * h;
  }
}

// Consumer: the thread's rows (16 w + g + 8 h of its warpgroup's 64, h <
// 2) of a 64 x DW accumulator out to a (B, T, NH, HD) f32 tensor as float2
// pairs, value(h, col, acc pair) deciding what goes out (rows past T and
// columns past HD skipped).
template <int HD, class Value>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const Head<HD>& hd,
                                           const int (&row)[2], int T, Value value) {
  constexpr int DW = kWidth<HD>;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= T) continue;
    float* out = dst + hd.base + row[h] * hd.tok;
#pragma unroll
    for (int j = 0; j < DW / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col >= HD) continue;
      *reinterpret_cast<float2*>(out + col) = value(h, col, 4 * j + 2 * h);
    }
  }
}

// Host: lets a kernel use `bytes` of dynamic shared memory.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace pct_attn_f32
