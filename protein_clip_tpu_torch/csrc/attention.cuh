// What the attention kernels K1 (attention_fwd.cu) and K5 (attention_bwd.cu)
// share on Hopper (sm_90a): the block's layout and its ring of tiles, the
// per-tile segment ranges that decide which tile pairs are computed, the
// copies that fill the ring, and the two wgmma shapes.
//
// Layout. Every tensor is (B, T, NH, 32) bf16, so one token's head is one
// 64-byte row. A tile is 64 such rows of one (row b, head h), 4 KB in shared
// memory with the 64-byte swizzle (16-byte chunk c of row r at
// c ^ ((r / 2) % 4)), the layout wgmma reads as
//   - K-major (the product's depth along the row: q, k, v, dO as the A or B
//     of a score product S = X . Y^T), descriptor SBO 512 (8-row groups), a
//     16-deep step advancing the start by 32 bytes;
//   - MN-major (the B of O = P . V, dq = dS . k, dv = P^T . dO,
//     dk = dS^T . q, whose depth runs over the rows), with wgmma's transpose
//     bit: SBO 512, a 16-deep step advancing 16 rows (1024 bytes).
// So no tile is transposed or copied twice: the kernels read every operand
// as the (B, T, NH, 32) layout stores it.
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

#include "hopper.cuh"

namespace pct_attn {

using namespace pct_hopper;
using bf16 = __nv_bfloat16;

constexpr int kHeadDim = 32;
constexpr int kTile = 64;                        // rows per tile
constexpr int kTileBytes = kTile * kHeadDim * 2;  // 4096
constexpr int kVecBytes = kTile * 4;             // 64 f32 or int32 per tile
// A stage: two tiles and three per-row vectors (segments, then K5's lse and
// delta), rounded up to the 512-byte swizzle period.
constexpr int kStageBytes = 2 * kTileBytes + 4 * kVecBytes;  // 9216
constexpr int kStages = 3;
constexpr int kResidentBytes = 2 * kTileBytes;
constexpr int kConsumers = 128;                  // one warpgroup
constexpr int kThreads = kConsumers + 32;        // and one producer warp
constexpr int kMaxT = 65536;                     // 1024 tile ranges in shared memory
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kStageBytes % 512 == 0 && kResidentBytes % 512 == 0, "swizzle period");

// Dynamic shared memory of a block for rows of n tiles.
__host__ __device__ constexpr int smem_bytes(int n) {
  return 512 + kResidentBytes + kStages * kStageBytes + 16 * n;
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
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory descriptors of a tile: K-major at 16-deep step ks (0, 1),
// MN-major at 16-row step kk (0-3).
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int ks) {
  return smem_desc(tile + 32 * ks, 16, 512, kSwizzle64);
}

__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return smem_desc(tile + 1024 * kk, kTileBytes, 512, kSwizzle64);
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

// d (64 x 32) = A . B + (scale_d ? d : 0): A 64 x 16 bf16 from registers
// (fragments as to_a makes them), B 16 x 32 bf16 MN-major in shared memory.
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

// acc (64 x 32) = bf16(x) . tile over four 16-row steps, tile MN-major;
// acc is overwritten when first is true.
__device__ __forceinline__ void accumulate(float (&acc)[16], const float (&x)[32], uint32_t tile,
                                           bool first) {
  uint32_t a[4][4];
  to_a(x, a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, a[kk], mnmajor(tile, kk), !first || kk > 0);
}

// s (64 x 64) = resident A tile . stage B tile^T (both K-major, 32 deep).
__device__ __forceinline__ void scores(float (&s)[32], uint32_t a, uint32_t b) {
  wgmma_ss(s, kmajor(a, 0), kmajor(b, 0), 0);
  wgmma_ss(s, kmajor(a, 1), kmajor(b, 1), 1);
}

// The accumulator element i of this thread: fragment row (0: g, 1: g + 8)
// and column.
__device__ __forceinline__ int acc_row(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int acc_col(int i, int tig) { return 8 * (i >> 2) + 2 * tig + (i & 1); }

// ---------------------------------------------------------------------------
// The block: its (row, head), shared memory and ring
// ---------------------------------------------------------------------------

struct Head {
  int64_t base;      // element offset of (b, 0, h, 0)
  int64_t tok;       // elements between tokens: NH * 32
  int64_t vec;       // offset of (b, h, 0) in a (B, NH, T) vector
  const int32_t* seg_row;
  __device__ Head(const int32_t* seg, int T, int NH)
      : base(static_cast<int64_t>(blockIdx.z) * T * NH * kHeadDim +
             static_cast<int64_t>(blockIdx.y) * kHeadDim),
        tok(static_cast<int64_t>(NH) * kHeadDim),
        vec((static_cast<int64_t>(blockIdx.z) * NH + blockIdx.y) * T),
        seg_row(seg + static_cast<int64_t>(blockIdx.z) * T) {}
};

struct Ring {
  uint32_t resident;   // two resident tiles
  uint32_t stages;     // kStages stages
  const uint8_t* stage_ptr;
  const int4* ranges;  // per tile of the row
  uint32_t full, empty, ready;

  __device__ uint32_t stage(int it) const { return stages + (it % kStages) * kStageBytes; }
  __device__ const int32_t* vec(int it, int i) const {
    return reinterpret_cast<const int32_t*>(stage_ptr + (it % kStages) * kStageBytes +
                                            2 * kTileBytes + i * kVecBytes);
  }
};

// Carves the dynamic shared memory, has the producer warp start its
// resident tiles' copies (load_resident(address); their arrival on ready
// comes later), initialises the barriers (full: 32 producer arrivals;
// empty: 4 consumer warps; ready: 32) and reduces the segments of every
// tile of the row to its range, while those copies fly. Ends with the
// kernel's only block-wide barrier.
template <class LoadResident>
__device__ __forceinline__ Ring setup(uint8_t* smem_raw, uint64_t* bars, const int32_t* seg_row,
                                      int T, LoadResident load_resident) {
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + ((512 - (raw & 511)) & 511);
  Ring r;
  r.resident = smem_u32(base);
  r.stages = r.resident + kResidentBytes;
  r.stage_ptr = base + kResidentBytes;
  int4* ranges = reinterpret_cast<int4*>(base + kResidentBytes + kStages * kStageBytes);
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
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int j = warp; j < tiles_of(T); j += kThreads / 32) {
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
  __syncthreads();
  return r;
}

// Producer: rows [t0, t0 + 64) of a (B, T, NH, 32) tensor into a tile,
// zeros past T; 8 chunks of 16 bytes per lane.
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, const Head& hd, int t0,
                                          int T, int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = lane + 32 * i;
    const int r = c >> 2;
    const int ch = c & 3;
    const bool ok = t0 + r < T;
    const bf16* p = src + hd.base + (ok ? t0 + r : 0) * hd.tok + ch * 8;
    cp_async16(dst + r * 64 + ((ch ^ ((r >> 1) & 3)) << 4), p, ok);
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
__device__ __forceinline__ uint32_t claim(const Ring& r, int it) {
  mbar_wait(r.empty + 8 * (it % kStages), ((it / kStages) & 1) ^ 1);
  return r.stage(it);
}

// Producer: the stage's copies are issued; its full barrier completes when
// they land.
__device__ __forceinline__ void fill(const Ring& r, int it) {
  cp_async_arrive(r.full + 8 * (it % kStages));
}

// Consumer: waits for the it-th visited tile.
__device__ __forceinline__ uint32_t take(const Ring& r, int it) {
  mbar_wait(r.full + 8 * (it % kStages), (it / kStages) & 1);
  fence_proxy_async();  // cp.async's writes before wgmma's reads
  return r.stage(it);
}

// Consumer: this warp is done with the stage (its wgmma groups waited for).
__device__ __forceinline__ void release(const Ring& r, int it) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(r.empty + 8 * (it % kStages));
}

// Consumer: waits for the resident tiles.
__device__ __forceinline__ void take_resident(const Ring& r) {
  mbar_wait(r.ready, 0);
  fence_proxy_async();
}

// A pad query's softmax weight, 1/T rounded to bf16 as P is for P.V.
__device__ __forceinline__ float pad_weight(int T) {
  return __bfloat162float(__float2bfloat16_rn(__frcp_rn(static_cast<float>(T))));
}

// Consumer warpgroup: out[d] = the f32 sum over the rows t < T of a
// (B, T, NH, 32) tensor's head, every row or (pads_only) those whose
// segment is <= 0, read straight from global memory (one 16-byte chunk a
// row per thread, 32 rows at a time). scratch: 128 floats. out is visible
// to the whole warpgroup on return.
__device__ __forceinline__ void column_sum(float* out, float* scratch, const bf16* src,
                                           const Head& hd, int T, bool pads_only) {
  const int tid = threadIdx.x;
  const int ch = tid & 3;  // dims 8 ch .. 8 ch + 7
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int t = tid >> 2; t < T; t += kConsumers / 4) {
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
#pragma unroll
  for (int e = 0; e < 8; ++e) {
#pragma unroll
    for (int off = 4; off < 32; off *= 2) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  }
  const int lane = tid & 31;
  if (lane < 4) {
#pragma unroll
    for (int e = 0; e < 8; ++e) scratch[(tid >> 5) * 32 + lane * 8 + e] = acc[e];
  }
  named_barrier(1, kConsumers);
  if (tid < 32) out[tid] = scratch[tid] + scratch[32 + tid] + scratch[64 + tid] + scratch[96 + tid];
  named_barrier(1, kConsumers);
}

// Host: lets a kernel use the dynamic shared memory of the longest row.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes(tiles_of(kMaxT)));
}

}  // namespace pct_attn
