// FILIP masked token max-sim (f32), Hopper (sm_90a): kernel K4.
//
// Replaces protein_clip_tpu/ops/filip_pallas.py::_maxsim_kernel (launched by
// _maxsim_call). Same function: for every pair (i, j) of a rectangular
// (Ba, Bb) grid, the score of a-token s and b-token u is <ha[i,s], hb[j,u]>
// where ma[i,s] * mb[j,u] > 0 and f32-min otherwise;
//   oa[i,j] = sum_s clamp(max_u score) * ma[i,s] / max(sum_s ma[i,s], 1e-6)
//   ob[i,j] = sum_u clamp(max_s score) * mb[j,u] / max(sum_u mb[j,u], 1e-6)
// where clamp maps a max that stayed <= f32-min (no valid token on the
// other side) to 0 BEFORE the sum, so a candidate with an empty mask scores
// 0 and not -inf. The temperature is divided out by the caller.
//
// Bound on an H100 SXM. The function needs the products of the pairs both
// masks allow; kept at f32 accuracy on the tensor cores that is three TF32
// products per f32 product (below), 3 * 2 * D per pair at 495 TFLOP/s, and
// it must move the valid tokens, both masks and both outputs once. At the
// scorer's shapes it is bound by operations: (4, 256, 128, 512) at D=128 on
// chip_smoke.py's masks (lengths over [T/4, T]) is 12-20 GFLOP, 0.024-0.040
// ms, against 42 MB, 0.0125 ms at 3.35 TB/s. The design before this one (kept
// as tools/probe_maxsim_ffma.cu) ran f32 FFMA on the CUDA cores, whose 67
// TFLOP/s over every token pair bound it at 0.256 ms there; it read 37% of
// that, held in turn by its shared-memory reads (2 FMAs per float read).
//
// Design.
//   - 3xTF32 on wgmma (m64n64k8.f32.tf32.tf32, A from registers): each
//     operand x is split into hi = tf32(x) (rounded as cvt.rna does, low
//     bits cleared) and lo = tf32(x - hi), and hi.hi + hi.lo + lo.hi
//     accumulate in f32. /topk ranks by these scores, and TF32 alone (three
//     decimal digits) would reorder near-ties. hi must be rounded here:
//     handed the raw f32 bits, the tensor core does not read the truncated
//     value (off by up to 1e-2, tools/probe_maxsim.py).
//   - Loop order. One block per candidate j (grid Bb). Two consumer
//     warpgroups each hold one 64-token b-tile of hb[j], split into hi and
//     lo tiles in shared memory (the B operand, K-major, 128-byte swizzle;
//     one warpgroup where two do not fit, D > 128); every 64-token a-slab of
//     the pass's query rows i streams past both from L2 and each warpgroup
//     splits it into hi and lo fragments in registers (the A operand). So
//     hb is read from device memory once a pass, and each a-slab streamed
//     meets 128 b-tokens; the queries are the small side (Ba <= 64 rows of
//     a scorer block).
//   - A ring of kStages stages, each one k-chunk (32 floats of D, 64 rows,
//     8 KB, the 128-byte swizzle) of a b-tile or an a-slab in the order the
//     consumers take them, filled by one producer warp with TMA (two 3-D
//     tensor maps a call; 16-byte cp.async took 17-25% longer) and guarded
//     by full/empty mbarrier pairs: no block-wide barrier in the loop. Each
//     stage carries a header (what it holds and for which warpgroup) and,
//     on a tile's first chunk, its rows' mask values, so the consumers
//     follow the producer's schedule. An a-chunk's fragments are read with
//     conflict-free 16-byte loads (D permuted within each 32-float chunk,
//     the b-tiles' split tiles alike), the stage released at once, and the
//     next chunk's loads overlap the current wgmma group.
//   - Epilogue on the accumulator: invalid pairs become f32-min; row maxima
//     across the quad's lanes, kept per a-token and warpgroup in shared
//     memory across the b-tiles; column maxima by a butterfly over the 8
//     lanes of a column (14 shuffles) and one shared-memory reduction across
//     the 4 warps per (a-slab, b-tile), kept per b-token across the query's
//     a-slabs.
//   - Exact tile skipping: the producer leaves out every a-slab and b-tile
//     whose 64 mask values are all 0 (their scores are all f32-min: no max
//     changes); a row or column with no valid token still scores 0.
//   - A pass holds the row maxima of `group` query rows (all of them for
//     /topk and for 4 queries: one pass). A query too long for shared memory
//     is split into windows of a-slabs: the first window's pass computes
//     every a-slab for the column maxima, the others only their own. Any TA
//     and TB.
//   What holds it back (tools/probe_maxsim.py, H100): the tensor core runs
//   these m64n64k8 products at about 405 TFLOP/s with two warpgroups an SM,
//   not 495, and the epilogues, which both warpgroups reach together, leave
//   it idle. At one query (/topk) each b-tile meets only the query's few
//   a-slabs, so a block is a serial chain of b-tile fetches, splits and
//   short product runs (the products are a third of its time), and the
//   grid's time is that of the SMs that draw the longest candidates.
// The sums run in a fixed order (one thread per row, column or partial, and
// fixed trees) without atomics: the result is deterministic.
//
// Built by protein_clip_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (plain C interface below).

#include <cuda.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "hopper.cuh"

namespace pct_maxsim {

using namespace pct_hopper;

constexpr int kTile = 64;                        // tokens per a-slab and per b-tile
constexpr int kChunk = 32;                       // floats of D per stage (a 128-byte row)
constexpr int kChunkBytes = kTile * kChunk * 4;  // 8192
constexpr int kStages = 6;
constexpr int kMetaBytes = 16 + kTile * 4;       // a stage's header and its rows' masks
constexpr int kProducts = 3;  // TF32 products per k-step: hi.hi, hi.lo, lo.hi
constexpr float kNeg = -FLT_MAX;                 // the TPU kernel's jnp.finfo(f32).min
constexpr int kBlockBytes = 231424;              // a block's 227 KB, less the static barriers' 1 KB

// Consumer warpgroups: two (each holding its own b-tile against the same
// streamed a-slabs) while two b-tiles fit, D <= 128; one beyond.
__host__ __device__ constexpr int threads_of(int wgs) { return 128 * wgs + 32; }

enum Kind : int { kB = 0, kA = 1, kEnd = 2 };

struct Params {
  const float* ha;
  const float* hb;
  const int32_t* ma;
  const int32_t* mb;
  float* oa;
  float* ob;
  int Ba, Bb, TA, TB, D;
  int nc;      // k-chunks: ceil(D / 32)
  int group;   // query rows i per pass
  int window;  // a-slabs per pass whose row maxima are kept
};

// Byte offsets in the block's dynamic shared memory (from a 1024-aligned
// base): per consumer warpgroup its b-tile's hi and lo chunks; the ring and
// its stages' headers; per warpgroup the column-max scratch (two buffers of
// 4 warps x 64) and warp sums, per query row the columns' summed
// contributions, and the row maxima; per query row the row-side sum.
struct Layout {
  int nc_bytes, b, ring, meta, scr, red, ob_col, oa_acc, rowmax, bytes;
  __host__ __device__ int b_hi(int wg) const { return b + wg * 2 * nc_bytes; }
  __host__ __device__ int b_lo(int wg) const { return b_hi(wg) + nc_bytes; }
};

__host__ __device__ inline Layout layout(int wgs, int nc, int group, int window) {
  Layout l{};
  l.nc_bytes = nc * kChunkBytes;
  int o = 0;
  l.b = o;
  o += wgs * 2 * l.nc_bytes;
  l.ring = o;
  o += kStages * kChunkBytes;
  l.meta = o;
  o += kStages * kMetaBytes;
  l.scr = o;
  o += wgs * 2 * 4 * kTile * 4;
  l.red = o;
  o += wgs * 4 * 4 * 4;
  l.ob_col = o;
  o += wgs * group * kTile * 4;
  l.oa_acc = o;
  o += (group + 3) / 4 * 16;
  l.rowmax = o;
  o += wgs * group * window * kTile * 4;
  l.bytes = o + 1024;  // alignment slack
  return l;
}

__host__ __device__ inline int tiles_of(int T) { return (T + kTile - 1) / kTile; }

// ---------------------------------------------------------------------------
// Producer warp
// ---------------------------------------------------------------------------

template <int kWgs>
struct Producer {
  const Params& p;
  uint8_t* base;
  Layout L;
  uint32_t full, empty;
  int lane;
  int it = 0;

  // Lane l's mask values of tokens t0 + l and t0 + 32 + l (0 past T).
  __device__ __forceinline__ int2 masks(const int32_t* row, int t0, int T) const {
    const int a = t0 + lane, b = t0 + 32 + lane;
    return make_int2(a < T ? __ldg(row + a) : 0, b < T ? __ldg(row + b) : 0);
  }

  // Claims the next stage and fills it: the header {kind, x, y, z}, on a
  // tile's first chunk its rows' mask values, and chunk kc of tokens
  // [t0, t0 + 64) of row `row` of `map`.
  __device__ __forceinline__ void push(int4 hdr, int kc, int2 m, const CUtensorMap* map, int row,
                                       int t0) {
    const int s = it % kStages;
    mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
    int* h = reinterpret_cast<int*>(base + L.meta + s * kMetaBytes);
    float* mv = reinterpret_cast<float*>(h + 4);
    if (lane == 0) *reinterpret_cast<int4*>(h) = hdr;
    if (hdr.x != kEnd && kc == 0) {
      mv[lane] = static_cast<float>(m.x);
      mv[lane + 32] = static_cast<float>(m.y);
    }
    const uint32_t dst = smem_u32(base) + L.ring + s * kChunkBytes;
    const uint32_t bar = full + 8 * s;
    __syncwarp();  // the header and masks before lane 0's (releasing) arrival
    if (lane == 0) {
      if (hdr.x == kEnd) {
        mbar_arrive(bar);
      } else {
        mbar_arrive_expect(bar, kChunkBytes);
        tma_load_3d(dst, map, kc * kChunk, t0, row, bar);
      }
    }
    ++it;
  }

  // One round: b-tiles bts[0, n) of row j, one a warpgroup each, then every
  // nonempty a-slab of the pass's query rows against them.
  __device__ __forceinline__ void emit_round(const int (&bts)[kWgs], const int2 (&mbs)[kWgs],
                                             int n, int j, int i0, int i1, int s0, int s1,
                                             const CUtensorMap* tma, const CUtensorMap* tmb) {
#pragma unroll
    for (int wg = 0; wg < kWgs; ++wg) {
      if (wg >= n) break;
      for (int kc = 0; kc < p.nc; ++kc) {
        push(make_int4(kB, wg, bts[wg], 0), kc, mbs[wg], tmb, j, bts[wg] * kTile);
      }
    }
    for (int i = i0; i < i1; ++i) {
      const int32_t* ma_i = p.ma + static_cast<int64_t>(i) * p.TA;
      for (int sa = s0; sa < s1; ++sa) {
        const int2 mav = masks(ma_i, sa * kTile, p.TA);
        if (!__any_sync(0xffffffffu, (mav.x | mav.y) != 0)) continue;  // an empty a-slab
        for (int kc = 0; kc < p.nc; ++kc) {
          push(make_int4(kA, i - i0, sa, n), kc, mav, tma, i, sa * kTile);
        }
      }
    }
  }

  // Every pass of candidate j.
  __device__ __forceinline__ void run(int j, const CUtensorMap* tma, const CUtensorMap* tmb) {
    const int n_slabs = tiles_of(p.TA);
    const int n_btiles = tiles_of(p.TB);
    const int32_t* mb_j = p.mb + static_cast<int64_t>(j) * p.TB;
    for (int i0 = 0; i0 < p.Ba; i0 += p.group) {
      const int i1 = min(p.Ba, i0 + p.group);
      for (int w0 = 0; w0 < n_slabs; w0 += p.window) {
        // the first window's pass computes every a-slab (column maxima)
        const int s1 = w0 == 0 ? n_slabs : min(n_slabs, w0 + p.window);
        int bts[kWgs];
        int2 mbs[kWgs];
        int n = 0;
        for (int bt = 0; bt < n_btiles; ++bt) {
          const int2 mbv = masks(mb_j, bt * kTile, p.TB);
          if (!__any_sync(0xffffffffu, (mbv.x | mbv.y) != 0)) continue;  // an empty b-tile
#pragma unroll
          for (int k = 0; k < kWgs; ++k) {  // bts[n] = bt, with static indices
            if (k == n) {
              bts[k] = bt;
              mbs[k] = mbv;
            }
          }
          if (++n == kWgs) {
            emit_round(bts, mbs, n, j, i0, i1, w0, s1, tma, tmb);
            n = 0;
          }
        }
        if (n > 0) emit_round(bts, mbs, n, j, i0, i1, w0, s1, tma, tmb);
        push(make_int4(kEnd, 0, 0, 0), 0, make_int2(0, 0), tmb, 0, 0);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// Consumer warpgroups
// ---------------------------------------------------------------------------

// The sums of a, b and c over a warpgroup, in a fixed order, in each of its
// threads (named barrier `bar`). red: 16 floats.
__device__ __forceinline__ float3 wg_sum3(float a, float b, float c, float* red, int bar) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
    c += __shfl_xor_sync(0xffffffffu, c, o);
  }
  const int w = (threadIdx.x >> 5) & 3;
  named_barrier(bar, 128);  // red is free
  if ((threadIdx.x & 31) == 0) {
    red[4 * w] = a;
    red[4 * w + 1] = b;
    red[4 * w + 2] = c;
  }
  named_barrier(bar, 128);
  float3 r = make_float3(0.f, 0.f, 0.f);
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    r.x += red[4 * v];
    r.y += red[4 * v + 1];
    r.z += red[4 * v + 2];
  }
  return r;
}

__device__ __forceinline__ float clamp0(float m) { return m <= kNeg ? 0.f : m; }

// One level of the column maxima's butterfly: the lane keeps x[0, H) or
// x[H, 2H) (upper), maxed with what its partner across lane bit `xor`
// keeps of the other half, into x[0, H).
template <int H>
__device__ __forceinline__ void butterfly(float (&x)[16], bool upper, int xor_mask) {
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = upper ? x[k] : x[k + H];
    const float keep = upper ? x[k + H] : x[k];
    x[k] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, xor_mask));
  }
}

template <int kWgs>
struct Consumer {
  const Params& p;
  uint8_t* base;
  Layout L;
  uint32_t full, empty;
  int wg, tid, w, lane, g, t;
  int it = 0;
  int buf = 0;          // column-max scratch buffer
  float wb[16];         // the b-tile's mask at this thread's 16 columns
  float wbc = 0.f;      // and at column tid (tid < 64)
  float colmax = kNeg;  // column tid's max over the current query's a-slabs

  // Named barriers: 1 + wg and 3 + wg for the warpgroup, 5 for all.
  __device__ __forceinline__ void sync_wg() const { named_barrier(1 + wg, 128); }
  __device__ __forceinline__ void sync_all() const { named_barrier(5, 128 * kWgs); }

  __device__ __forceinline__ const uint8_t* take(int i) const {
    const int s = i % kStages;
    mbar_wait(full + 8 * s, (i / kStages) & 1);
    return base + L.ring + s * kChunkBytes;
  }

  __device__ __forceinline__ const int* header(int i) const {
    return reinterpret_cast<const int*>(base + L.meta + (i % kStages) * kMetaBytes);
  }

  __device__ __forceinline__ void release(int i) const {
    fence_proxy_async();  // generic reads before the next TMA write
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (i % kStages));
  }

  // The nc stages of a tile meant for the other warpgroup (the first taken).
  __device__ __forceinline__ void pass_over() {
    for (int kc = 0; kc < p.nc; ++kc) {
      if (kc > 0) take(it);
      release(it);
      ++it;
    }
  }

  // The b-tile's nc chunks (the first already taken) into this warpgroup's
  // hi and lo tiles: thread (row n, half h) turns the 16 floats of k-steps
  // 2h, 2h + 1 of every chunk, a 4 x 4 transpose of 16-byte chunks (the A
  // side's permutation of D, see load_a).
  __device__ __forceinline__ void load_b() {
    sync_wg();  // every warp's products on the last b-tile are done
    const float* mv = reinterpret_cast<const float*>(header(it) + 4);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float2 m = *reinterpret_cast<const float2*>(mv + 8 * q + 2 * t);
      wb[2 * q] = m.x;
      wb[2 * q + 1] = m.y;
    }
    if (tid < kTile) wbc = mv[tid];
    const int n = tid >> 1, h = tid & 1;
    const uint32_t hi0 = smem_u32(base) + L.b_hi(wg), lo0 = smem_u32(base) + L.b_lo(wg);
    for (int kc = 0; kc < p.nc; ++kc) {
      const uint8_t* st = kc == 0 ? base + L.ring + (it % kStages) * kChunkBytes : take(it);
      float4 x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = *reinterpret_cast<const float4*>(st + n * 128 + (((2 * e + h) ^ (n & 7)) << 4));
      }
      release(it);
      ++it;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = m == 0 ? x[e].x : m == 1 ? x[e].y : m == 2 ? x[e].z : x[e].w;
          split(v, hi[e], lo[e]);
        }
        const uint32_t off = kc * kChunkBytes + n * 128 + (((4 * h + m) ^ (n & 7)) << 4);
        st_shared16(hi0 + off, hi[0], hi[1], hi[2], hi[3]);
        st_shared16(lo0 + off, lo[0], lo[1], lo[2], lo[3]);
      }
    }
    fence_proxy_async();  // the tiles' generic writes before wgmma reads them
    sync_wg();
  }

  // Chunk `it` of an a-slab, as raw floats, and the stage released. Rows
  // 16 w + g and + 8; within each 16 floats of the chunk, thread t's
  // 16-byte chunk 2 t + h holds (k-step 2 h: k t, k t + 4; k-step 2 h + 1:
  // k t, k t + 4), so each k-step's fragment comes from two 16-byte loads
  // that hit distinct banks.
  __device__ __forceinline__ void load_a(float4 (&x)[2][2], bool taken) {
    const uint8_t* st = taken ? base + L.ring + (it % kStages) * kChunkBytes : take(it);
    const int r0 = 16 * w + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = ((2 * t + h) ^ g) << 4;  // rows r0 and r0 + 8 share r % 8 = g
      x[h][0] = *reinterpret_cast<const float4*>(st + r0 * 128 + off);
      x[h][1] = *reinterpret_cast<const float4*>(st + (r0 + 8) * 128 + off);
    }
    release(it);
    ++it;
  }

  // The chunk's fragments split into hi and lo, then its 4 k-steps'
  // products as one wgmma group: the fragments and the descriptors are all
  // defined before the group starts, and none is redefined while it runs
  // (else ptxas serialises the wgmmas).
  __device__ __forceinline__ void mma_chunk(float (&acc)[32], uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4], const float4 (&x)[2][2],
                                            int kc) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      split(x[h][0].x, hi[2 * h][0], lo[2 * h][0]);
      split(x[h][1].x, hi[2 * h][1], lo[2 * h][1]);
      split(x[h][0].y, hi[2 * h][2], lo[2 * h][2]);
      split(x[h][1].y, hi[2 * h][3], lo[2 * h][3]);
      split(x[h][0].z, hi[2 * h + 1][0], lo[2 * h + 1][0]);
      split(x[h][1].z, hi[2 * h + 1][1], lo[2 * h + 1][1]);
      split(x[h][0].w, hi[2 * h + 1][2], lo[2 * h + 1][2]);
      split(x[h][1].w, hi[2 * h + 1][3], lo[2 * h + 1][3]);
    }
    const uint32_t b_hi = smem_u32(base) + L.b_hi(wg) + kc * kChunkBytes;
    const uint32_t b_lo = smem_u32(base) + L.b_lo(wg) + kc * kChunkBytes;
    uint64_t dh[4], dl[4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      dh[ks] = smem_desc(b_hi + 32 * ks, 16, 1024);
      dl[ks] = smem_desc(b_lo + 32 * ks, 16, 1024);
    }
    fence_operands(dh);
    fence_operands(dl);
    fence_operands(hi);
    fence_operands(lo);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wgmma_tf32(acc, hi[ks], dh[ks], kc > 0 || ks > 0);
      if (kProducts > 1) {
        wgmma_tf32(acc, hi[ks], dl[ks], 1);
        wgmma_tf32(acc, lo[ks], dh[ks], 1);
      }
    }
    wgmma_commit();
  }

  // An a-slab against this warpgroup's b-tile, then its maxima: row maxima
  // into the pass's rowmax when the slab is in the window, column maxima
  // into colmax when `cols`.
  __device__ __forceinline__ void slab(int il, int sa, int w0, bool cols, float* rowmax,
                                       float* scr) {
    const float* mv = reinterpret_cast<const float*>(header(it) + 4);
    const float wa0 = mv[16 * w + g], wa1 = mv[16 * w + g + 8];
    float acc[32];
    uint32_t hi[4][4], lo[4][4];
    float4 x[2][2];
    load_a(x, true);
    for (int kc = 0; kc < p.nc; ++kc) {
      mma_chunk(acc, hi, lo, x, kc);
      if (kc + 1 < p.nc) load_a(x, false);  // the next chunk's loads while the group runs
      wgmma_wait<0>();
      fence_operands(acc);
      fence_operands(hi);  // the group read them until here
      fence_operands(lo);
    }

    // acc[4 q + 2 h + e]: row 16 w + g + 8 h, column 8 q + 2 t + e
    float v[2][16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int q = k >> 1, e = k & 1;
      v[0][k] = wa0 * wb[k] > 0.f ? acc[4 * q + e] : kNeg;
      v[1][k] = wa1 * wb[k] > 0.f ? acc[4 * q + 2 + e] : kNeg;
    }
    if (sa >= w0 && sa < w0 + p.window) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = v[h][0];
#pragma unroll
        for (int k = 1; k < 16; ++k) m = fmaxf(m, v[h][k]);
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        if (t == 0) {
          float& r = rowmax[(il * p.window + sa - w0) * kTile + 16 * w + g + 8 * h];
          r = fmaxf(r, m);
        }
      }
    }
    if (cols) {
      // Butterfly over the 8 lanes that share t (lane bits 2-4): each level
      // halves the values a lane keeps; lane (g, t) ends with columns
      // 8 rev(g) + 2 t + {0, 1}, rev reversing g's three bits.
      float x[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) x[k] = fmaxf(v[0][k], v[1][k]);
      butterfly<8>(x, g & 1, 4);
      butterfly<4>(x, (g >> 1) & 1, 8);
      butterfly<2>(x, (g >> 2) & 1, 16);
      const int rev = ((g & 1) << 2) | (g & 2) | ((g >> 2) & 1);
      float* sc = scr + buf * 4 * kTile;
      *reinterpret_cast<float2*>(sc + w * kTile + 8 * rev + 2 * t) = make_float2(x[0], x[1]);
      named_barrier(3 + wg, 128);
      if (tid < kTile) {
        colmax = fmaxf(colmax, fmaxf(fmaxf(sc[tid], sc[kTile + tid]),
                                     fmaxf(sc[2 * kTile + tid], sc[3 * kTile + tid])));
      }
      buf ^= 1;  // the next slab writes the other buffer: no second barrier
    }
  }

  // Every pass of candidate j.
  __device__ __forceinline__ void run(int j) {
    wg = threadIdx.x >> 7;
    tid = threadIdx.x & 127;
    w = tid >> 5;
    lane = tid & 31;
    g = lane >> 2;
    t = lane & 3;
    const int ng_max = p.group, win = p.window;
    float* scr = reinterpret_cast<float*>(base + L.scr) + wg * 2 * 4 * kTile;
    float* red = reinterpret_cast<float*>(base + L.red) + wg * 16;
    float* ob_all = reinterpret_cast<float*>(base + L.ob_col);
    float* ob_col = ob_all + wg * ng_max * kTile;
    float* oa_acc = reinterpret_cast<float*>(base + L.oa_acc);
    float* row_all = reinterpret_cast<float*>(base + L.rowmax);
    float* rowmax = row_all + wg * ng_max * win * kTile;
    const int n_slabs = tiles_of(p.TA);
    const int32_t* mb_j = p.mb + static_cast<int64_t>(j) * p.TB;
    float cnt_b = 0.f;
    if (wg == 0) {
      float nb = 0.f;
      for (int u = tid; u < p.TB; u += 128) nb += static_cast<float>(mb_j[u]);
      cnt_b = wg_sum3(nb, 0.f, 0.f, red, 1).x;
    }
    for (int i0 = 0; i0 < p.Ba; i0 += p.group) {
      const int ng = min(p.Ba, i0 + p.group) - i0;
      for (int w0 = 0; w0 < n_slabs; w0 += p.window) {
        const bool cols = w0 == 0;
        for (int e = tid; e < ng * win * kTile; e += 128) rowmax[e] = kNeg;
        if (cols) {
          for (int e = tid; e < ng * kTile; e += 128) ob_col[e] = 0.f;
        }
        sync_wg();
        int cur = -1;  // the query whose column maxima are in colmax
        while (true) {
          take(it);
          const int4 h = *reinterpret_cast<const int4*>(header(it));
          if (cur >= 0 && (h.x != kA || h.y != cur)) {  // its a-slabs are done on this b-tile
            if (tid < kTile) ob_col[cur * kTile + tid] += clamp0(colmax) * wbc;
            colmax = kNeg;
            cur = -1;
          }
          if (h.x == kEnd) {
            release(it);
            ++it;
            break;
          }
          if (h.x == kB) {
            if (h.y == wg) {
              load_b();
            } else {
              pass_over();
            }
          } else if (wg < h.w) {
            slab(h.y, h.z, w0, cols, rowmax, scr);
            if (cols) cur = h.y;
          } else {
            pass_over();  // a round with fewer b-tiles than warpgroups
          }
        }

        // The pass's row sums, by warpgroup 0 over every warpgroup's
        // maxima; the outputs after a query's last window.
        const int w1 = min(n_slabs, w0 + p.window);
        const bool last = w1 == n_slabs;
        sync_all();  // every row and column maximum is in place
        if (wg == 0) {
          for (int il = 0; il < ng; ++il) {
            const int i = i0 + il;
            const int32_t* ma_i = p.ma + static_cast<int64_t>(i) * p.TA;
            float part = 0.f, na = 0.f, obs = 0.f;
            for (int r = tid; r < (w1 - w0) * kTile; r += 128) {
              const int s = w0 * kTile + r;
              if (s < p.TA) {
                float m = kNeg;
#pragma unroll
                for (int k = 0; k < kWgs; ++k) {
                  m = fmaxf(m, row_all[(k * ng_max + il) * win * kTile + r]);
                }
                part += clamp0(m) * static_cast<float>(ma_i[s]);
              }
            }
            if (last) {
              for (int s = tid; s < p.TA; s += 128) na += static_cast<float>(ma_i[s]);
              if (tid < kTile) {
#pragma unroll
                for (int k = 0; k < kWgs; ++k) obs += ob_all[(k * ng_max + il) * kTile + tid];
              }
            }
            const float3 sums = wg_sum3(part, na, obs, red, 1);
            if (tid == 0) {
              const float sum_a = (cols ? 0.f : oa_acc[il]) + sums.x;
              oa_acc[il] = sum_a;
              if (last) {
                const int64_t o = static_cast<int64_t>(i) * p.Bb + j;
                p.oa[o] = sum_a / fmaxf(sums.y, 1e-6f);
                p.ob[o] = sums.z / fmaxf(cnt_b, 1e-6f);
              }
            }
          }
        }
        sync_all();  // the maxima are read before the next pass resets them
      }
    }
  }
};

// grid (Bb): block j scores candidate j against every query; threads_of(kWgs)
// threads, layout(...).bytes of dynamic shared memory. ha (Ba, TA, D), hb
// (Bb, TB, D) f32; ma (Ba, TA), mb (Bb, TB) int32; oa, ob (Ba, Bb) f32; all
// contiguous, D a multiple of 4.
template <int kWgs>
__global__ void __launch_bounds__(threads_of(kWgs))
filip_maxsim_kernel(const __grid_constant__ CUtensorMap tma, const __grid_constant__ CUtensorMap tmb,
                    const __grid_constant__ Params p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const Layout L = layout(kWgs, p.nc, p.group, p.window);
  const uint32_t full = smem_u32(bars);
  const uint32_t empty = full + 8 * kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kWgs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the kernel's only block-wide barrier
  if (threadIdx.x >= 128 * kWgs) {
    Producer<kWgs> pr{p, base, L, full, empty, static_cast<int>(threadIdx.x & 31)};
    pr.run(blockIdx.x, &tma, &tmb);
    return;
  }
  Consumer<kWgs> c{p, base, L, full, empty};
  c.run(blockIdx.x);
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

// group and window: as many whole query rows a pass as fit beside the
// b-tiles and the ring; a query too long for that is cut into windows of
// a-slabs.
inline void plan(Params& p, int wgs) {
  const int n_slabs = tiles_of(p.TA);
  const int fixed = layout(wgs, p.nc, 0, 0).bytes + 16;  // + the row sums' rounding
  auto per_row = [wgs](int window) { return wgs * (kTile * 4 + window * kTile * 4) + 4; };
  const int avail = kBlockBytes - fixed;
  if (per_row(n_slabs) <= avail) {
    p.window = n_slabs;
    p.group = avail / per_row(n_slabs) < p.Ba ? avail / per_row(n_slabs) : p.Ba;
  } else {
    p.window = (avail - per_row(0)) / (wgs * kTile * 4);
    p.group = 1;
  }
}

// The 3-D map (D, T, B) of a (B, T, D) f32 tensor in boxes of one k-chunk
// x 64 tokens, 128-byte swizzle, zeros past D and T.
inline bool token_map(CUtensorMap* map, const void* base, int B, int T, int D) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 4,
                                 static_cast<cuuint64_t>(D) * 4 * T};
  const cuuint32_t box[3] = {kChunk, kTile, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches on `stream` with kWgs consumer warpgroups; returns the first CUDA
// error (0 when the launch was accepted).
template <int kWgs>
int launch(const void* ha, const void* hb, const void* mask_a, const void* mask_b, void* oa,
           void* ob, int Ba, int Bb, int TA, int TB, int D, cudaStream_t stream) {
  Params p{static_cast<const float*>(ha), static_cast<const float*>(hb),
           static_cast<const int32_t*>(mask_a), static_cast<const int32_t*>(mask_b),
           static_cast<float*>(oa), static_cast<float*>(ob), Ba, Bb, TA, TB, D,
           (D + kChunk - 1) / kChunk, 1, 1};
  plan(p, kWgs);
  const Layout L = layout(kWgs, p.nc, p.group, p.window);
  CUtensorMap tma{}, tmb{};
  if (!(token_map(&tma, ha, Ba, TA, D) && token_map(&tmb, hb, Bb, TB, D))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Every call: a static here would be one object across every library
  // that holds this template (a planted-fault build beside the package's).
  auto kernel = filip_maxsim_kernel<kWgs>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<Bb, threads_of(kWgs), L.bytes, stream>>>(tma, tmb, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pct_maxsim

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError(): 0 when
// the launch was accepted. Any TA and TB; D a multiple of 4 up to 256 and
// 16-byte aligned contiguous tensors (the Python wrapper checks these).
extern "C" int pct_filip_maxsim(const void* ha, const void* hb, const void* mask_a,
                                const void* mask_b, void* oa, void* ob, int Ba, int Bb, int TA,
                                int TB, int D, void* stream) {
  using namespace pct_maxsim;
  const auto s = static_cast<cudaStream_t>(stream);
  // two consumer warpgroups while their two b-tiles fit (D <= 128), else one
  if (D <= 4 * kChunk) return launch<2>(ha, hb, mask_a, mask_b, oa, ob, Ba, Bb, TA, TB, D, s);
  return launch<1>(ha, hb, mask_a, mask_b, oa, ob, Ba, Bb, TA, TB, D, s);
}
