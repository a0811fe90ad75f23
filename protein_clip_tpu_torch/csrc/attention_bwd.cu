// Segment-masked attention backward (K5) for ESM-2's head dims (16, 24, 32, 64,
// 128; bf16), Hopper.
//
// Replaces protein_clip_tpu/ops/attention_pallas.py::_bwd_kernel / _bwd_row
// (launched by _attention_bwd_call as the VJP of fused_attention). Same
// function: P = softmax of the masked scores in f32 (S = q.k^T, f32-min
// where seg_q != seg_k or seg_k <= 0); dP = dO.v^T; delta = rowsum(P * dP);
// dS = P * (dP - delta) where allowed, else 0 (the re-mask: a pad query row
// has a uniform P of 1/T, which feeds dv but gives no dq or dk); P is cast
// to bf16 for dv and dS to bf16 for dq and dk, as the TPU kernel does;
// dq = dS.k, dk = dS^T.q, dv = P^T.dO, accumulated in f32, written in bf16.
// Unlike the TPU kernel it does not recompute the softmax statistics: K1's
// forward leaves lse, the base-2 log-sum-exp of each query's masked scores,
// so P = 2^(round(s log2(e)) - lse), one multiply, one subtract and one
// ex2.approx per score (a query with one allowed key gets P = 1 exactly).
//
// Bound on an H100 SXM (989 TF/s bf16, 3.35 TB/s): five (T x T x dh)
// products per (row, head) (S, dP, dq, dk, dv), 5 * 2*B*NH*T^2*dh FLOPs;
// q, k, v and dO in and dq, dk, dv out once (the function reads no
// statistics: K1's lse is the port's own); one exp per score. At B=16,
// T=512, NH=20, dh 32 dense: 26.8 GFLOP (0.0271 ms) against 73.4 MB
// (0.0219 ms) and 0.0201 ms of exponentials. Padded and packed rows need
// the products and exponentials of their allowed pairs only, q, k and v of
// valid tokens (dO of every token: the pads' feeds dv) and (pads + T)*dh
// adds per (row, head) for the pads' dv: at chip_smoke.py's padded (16,
// 512), dh 32, 59.6 MB (0.0178 ms, the bound) and 0.0078 ms of
// exponentials.
//
// Design (attention.cuh has the layout, ring and skipping). Each output has
// one owner and no sums cross blocks (no atomics: two runs are bit-equal).
// Two launches, each a consumer warpgroup over 64 rows and a producer warp
// with a 3-stage cp.async ring:
//   1. per (row b, head h, 64 queries), q and dO resident, two sweeps over
//      the key tiles the query tile meets, each computing S = q.k^T and
//      dP = dO.v^T (DH/8 wgmma m64n64k16 from shared memory) and P from lse:
//      the first sums delta = rowsum(P * dP) in f32 and writes it as scratch
//      for launch 2; the second forms dS and dq += bf16(dS).k (wgmma
//      m64n{DH}k16, dS from registers, k read MN-major as stored). Pad queries
//      get dq = 0 and visit no tile.
//   2. per (row b, head h, 64 keys), k and v resident; for each query tile
//      that meets the key tile: S^T = k.q^T, dP^T = v.dO^T, P^T from the
//      stage's lse, dv += bf16(P^T).dO and dk += bf16(dS^T).q, in f32
//      registers; then every key's dv += bf16(1/T) times the sum of the pad
//      queries' dO (their uniform P, in closed form: no tile is visited
//      for them). At DH 128 the two 64 x 128 f32 accumulators take 128
//      registers a thread beside S^T, dP^T and their A fragments: ptxas
//      fits the launch in 254 registers without spills, one block an SM.
// 9 products and 3 exponentials per computed score, against 5 and 1 that
// the function needs. delta from K1's bf16 output, rowsum(dO * O), would
// save launch 1's first sweep, but O's bf16 rounding moves delta by more
// than the rounding of dS hides: where a query has one allowed key the
// plain backward's dq and dk are exactly 0 and that form's are not, and the
// key-bias gradient (the sum of dk over tokens, which softmax makes nearly
// cancel) moves by 1.3-1.8% of max|dk| against at most 0.06% with the
// f32 sum (tests/test_torch_attention_bwd.py prints both). What limits it
// now (9.4 times its bound at B=16, T=512 padded, dh 32): the two sweeps,
// and as in K1 one warpgroup waiting for each product group before its
// elementwise work.
//
// Built by protein_clip_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (plain C interface below).

#include "attention.cuh"

namespace {

using namespace pct_attn;

// 64 rows of dq, dk or dv from an m64n{DH} accumulator, bf16, the HD
// columns of the head.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* dst, const Head<HD>& hd, const int (&row)[2],
                                           int T, const float (&acc)[kWidth<HD> / 2], bool any,
                                           int tig) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= T) continue;
    bf16* out = dst + hd.base + row[h] * hd.tok;
#pragma unroll
    for (int j = 0; j < kWidth<HD> / 8; ++j) {
      if (8 * j >= HD) continue;  // HD 24: the tile's last 8 columns
      *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * tig) =
          pack_bf16x2(any ? acc[4 * j + 2 * h] : 0.f, any ? acc[4 * j + 2 * h + 1] : 0.f);
    }
  }
}

// Launch 1. grid (ceil(T / 64), NH, B), kThreads threads. q, k, v, dout,
// dq: (B, T, NH, HD) bf16, contiguous; seg: (B, T) int32; lse (read) and
// delta (written): (B, NH, T) f32.
template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const int32_t* __restrict__ seg,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        bf16* __restrict__ dq, float* __restrict__ delta_out, int T, int NH) {
  constexpr int DH = kWidth<HD>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages + 1];
  const Head<HD> hd(seg, T, NH);
  const int q0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31;
  const Ring<DH> ring = setup<DH>(smem_raw, bars, hd.seg_row, T, [&](uint32_t dst) {
    load_tile(dst, q, hd, q0, T, lane);
    load_tile(dst + kTileBytes<DH>, dout, hd, q0, T, lane);
  });
  const int4 own = ring.ranges[blockIdx.x];
  const int n = tiles_of(T);

  if (threadIdx.x >= kConsumers) {  // the producer warp: the key tiles twice
    cp_async_arrive(ring.ready);
    int it = 0;
    for (int pass = 0; pass < 2; ++pass) {
      for (int j = 0; j < n; ++j) {
        if (!overlaps(own, ring.ranges[j])) continue;
        const uint32_t st = claim(ring, it);
        load_tile(st, k, hd, j * kTile, T, lane);
        load_tile(st + kTileBytes<DH>, v, hd, j * kTile, T, lane);
        load_vec(st + 2 * kTileBytes<DH>, hd.seg_row, 0, j * kTile, T, lane);
        fill(ring, it++);
      }
    }
    cp_async_wait_all();
    return;
  }

  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  int row[2], sq[2];
  float lse_q[2], delta[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + warp * 16 + g + 8 * h;
    const bool in = row[h] < T;
    sq[h] = in ? hd.seg_row[row[h]] : -1;  // past T: no key
    lse_q[h] = in ? lse[hd.vec + row[h]] : 0.f;
  }
  float acc[DH / 2];
  bool any = false;
  take_resident(ring);

  // Pass 0: delta = rowsum(P * dP); pass 1: dS and dq += bf16(dS) . k.
  int it = 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (int j = 0; j < n; ++j) {
      if (!overlaps(own, ring.ranges[j])) continue;
      const uint32_t st = take(ring, it);
      const int32_t* segk = ring.vec(it, 0);
      float s[32], dp[32];
      wgmma_fence();
      scores<DH>(s, ring.resident, st);                                    // q . k^T
      scores<DH>(dp, ring.resident + kTileBytes<DH>, st + kTileBytes<DH>);  // dO . v^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(s);
      fence_operands(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int sk = segk[acc_col(i, tig)];
        const int h = acc_row(i);
        const bool ok = sk > 0 && sk == sq[h];
        const float p = ok ? ex2(__fmul_rn(s[i], kLog2e) - lse_q[h]) : 0.f;
        if (pass == 0) {
          delta[h] = fmaf(p, dp[i], delta[h]);
        } else {
          s[i] = p * (dp[i] - delta[h]);  // dS, 0 where not allowed
        }
      }
      if (pass == 1) {
        accumulate<DH>(acc, s, st, !any);  // dq += bf16(dS) . k
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(acc);
        any = true;
      }
      release(ring, it++);
    }
    if (pass == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        delta[h] = quad_sum(delta[h]);
        if (row[h] < T && tig == 0) delta_out[hd.vec + row[h]] = delta[h];
      }
    }
  }
  store_rows(dq, hd, row, T, acc, any, tig);
}

// Launch 2's consumer warpgroup, once setup() has returned the ring: the
// query tiles that meet the block's 64 keys (resident k and v) against
// them, then dk and dv out: one sweep at every head dim (at HD 128, two
// sweeps of one 64-column half each took 12-19% more device time on an
// H100, PERF.md).
template <int HD>
__device__ __forceinline__ void dkdv_consume(const Ring<kWidth<HD>>& ring, const Head<HD>& hd,
                                             int4 own, int sweep, int k0,
                                             const bf16* __restrict__ dout,
                                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                                             int T) {
  constexpr int DH = kWidth<HD>;
  const int lane = threadIdx.x & 31;
  // The pad queries' part of dv, the same for every key: bf16(1/T) sum dO.
  __shared__ float do_sum[DH], scratch[4 * DH];
  bool pads = false;
  for (int j = 0; j < tiles_of(T); ++j) pads |= ring.ranges[j].z != 0;
  if (pads) column_sum(do_sum, scratch, dout, hd, T, true);
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  int row[2], sk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = k0 + warp * 16 + g + 8 * h;
    sk[h] = row[h] < T ? hd.seg_row[row[h]] : 0;  // past T: allowed for no query
  }
  float dk_acc[DH / 2], dv_acc[DH / 2];
  bool any = false;
  take_resident(ring);

  int it = 0;
  for (int j = 0; j < sweep; ++j) {
    if (!overlaps(ring.ranges[j], own)) continue;
    const uint32_t st = take(ring, it);
    const int32_t* segq = ring.vec(it, 0);
    const float* lse_q = reinterpret_cast<const float*>(ring.vec(it, 1));
    const float* delta_q = reinterpret_cast<const float*>(ring.vec(it, 2));
    float p[32], ds[32];  // P^T and dS^T: keys are rows, queries columns
    wgmma_fence();
    scores<DH>(p, ring.resident, st);                                    // k . q^T
    scores<DH>(ds, ring.resident + kTileBytes<DH>, st + kTileBytes<DH>);  // v . dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(p);
    fence_operands(ds);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = acc_col(i, tig);
      const int h = acc_row(i);
      const bool ok = sk[h] > 0 && segq[c] == sk[h];
      const float e = ex2(__fmul_rn(p[i], kLog2e) - lse_q[c]);
      p[i] = ok ? e : 0.f;
      ds[i] = ok ? e * (ds[i] - delta_q[c]) : 0.f;
    }
    uint32_t ap[4][4], ad[4][4];  // bf16(P^T) and bf16(dS^T) as A fragments
    to_a(p, ap);
    to_a(ds, ad);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // dv += bf16(P^T) . dO
      wgmma_rs(dv_acc, ap[kk], mnmajor<DH>(st + kTileBytes<DH>, kk), any || kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // dk += bf16(dS^T) . q
      wgmma_rs(dk_acc, ad[kk], mnmajor<DH>(st, kk), any || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dv_acc);
    fence_operands(dk_acc);
    any = true;
    release(ring, it++);
  }
  if (pads) {
    const float w_pad = pad_weight(T);
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) {
      const float pad_part = w_pad * do_sum[acc_col(i, tig)];
      dv_acc[i] = any ? dv_acc[i] + pad_part : pad_part;
    }
  }
  store_rows(dk, hd, row, T, dk_acc, any, tig);
  store_rows(dv, hd, row, T, dv_acc, any || pads, tig);
}

// Launch 2. grid (ceil(T / 64), NH, B), kThreads threads; the block owns 64
// keys. lse and delta: (B, NH, T) f32 from K1 and launch 1.
// No register cap: at HD 32 ptxas fits it in 127 registers, three blocks
// an SM; a cap for three (__launch_bounds__(kThreads, 3)) leaves 128 and
// makes ptxas serialise the wgmmas (C7512), 4% slower on an H100
// (tools/probe_attention.py). A change that takes it past 128 registers
// drops it to two blocks an SM: read ptxas's report.
template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const int32_t* __restrict__ seg,
                          const bf16* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ delta, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int T, int NH) {
  constexpr int DH = kWidth<HD>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages + 1];
  const Head<HD> hd(seg, T, NH);
  const int k0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31;
  const Ring<DH> ring = setup<DH>(smem_raw, bars, hd.seg_row, T, [&](uint32_t dst) {
    load_tile(dst, k, hd, k0, T, lane);
    load_tile(dst + kTileBytes<DH>, v, hd, k0, T, lane);
  });
  const int4 own = ring.ranges[blockIdx.x];
  const int sweep = swept_tiles(T);

  if (threadIdx.x >= kConsumers) {  // the producer warp
    cp_async_arrive(ring.ready);
    int it = 0;
    for (int j = 0; j < sweep; ++j) {
      if (!overlaps(ring.ranges[j], own)) continue;
      const uint32_t st = claim(ring, it);
      load_tile(st, q, hd, j * kTile, T, lane);
      load_tile(st + kTileBytes<DH>, dout, hd, j * kTile, T, lane);
      load_vec(st + 2 * kTileBytes<DH>, hd.seg_row, 0, j * kTile, T, lane);
      load_vec(st + 2 * kTileBytes<DH> + kVecBytes, lse, hd.vec, j * kTile, T, lane);
      load_vec(st + 2 * kTileBytes<DH> + 2 * kVecBytes, delta, hd.vec, j * kTile, T, lane);
      fill(ring, it++);
    }
    cp_async_wait_all();
    return;
  }

  dkdv_consume(ring, hd, own, sweep, k0, dout, dk, dv, T);
}

}  // namespace

// Launches both kernels on `stream` (a cudaStream_t) and returns
// cudaGetLastError(): 0 when both launches were accepted,
// cudaErrorInvalidValue for a head dim the kernels do not take (16, 24, 32,
// 64 and 128 they take). lse: K1's (B, NH, T) statistics; delta: B*NH*T
// f32 of scratch.
extern "C" int pct_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* segments, const void* dout, const void* lse,
                                 void* dq, void* dk, void* dv, void* delta, int B, int T, int NH,
                                 int head_dim, void* stream) {
  return by_head_dim(head_dim, [&](auto head) {
    constexpr int HD = decltype(head)::value;
    constexpr int DH = kWidth<HD>;
    static const cudaError_t allowed[2] = {allow_smem<DH>(attention_bwd_dq_kernel<HD>),
                                           allow_smem<DH>(attention_bwd_dkdv_kernel<HD>)};
    for (const cudaError_t e : allowed) {
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const dim3 grid(tiles_of(T), NH, B);
    const int smem = smem_bytes<DH>(tiles_of(T));
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* qp = static_cast<const bf16*>(q);
    const auto* kp = static_cast<const bf16*>(k);
    const auto* vp = static_cast<const bf16*>(v);
    const auto* sp = static_cast<const int32_t*>(segments);
    const auto* dp = static_cast<const bf16*>(dout);
    const auto* lp = static_cast<const float*>(lse);
    auto* dl = static_cast<float*>(delta);
    attention_bwd_dq_kernel<HD><<<grid, kThreads, smem, s>>>(
        qp, kp, vp, sp, dp, lp, static_cast<bf16*>(dq), dl, T, NH);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_bwd_dkdv_kernel<HD><<<grid, kThreads, smem, s>>>(
        qp, kp, vp, sp, dp, lp, dl, static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, NH);
    return static_cast<int>(cudaGetLastError());
  });
}
