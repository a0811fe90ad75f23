// Segment-masked attention backward in f32 (K5-f32) for ESM-2's head dims
// (16, 24, 32, 64, 128), Hopper.
//
// Replaces protein_clip_tpu/ops/attention_pallas.py::_bwd_kernel / _bwd_row
// (launched by _attention_bwd_call as the VJP of fused_attention) for f32
// q, k, v and dO. Same function as K5 (attention_bwd.cu) with no rounding
// to bf16: P = softmax of the masked scores; dP = dO.v^T;
// delta = rowsum(P * dP); dS = P * (dP - delta) where allowed, else 0 (a
// pad query row's uniform P feeds dv but gives no dq or dk); dq = dS.k,
// dk = dS^T.q, dv = P^T.dO. P comes from K1-f32's statistics,
// P = 2^(round(s log2(e)) - lse), and delta from K1-f32's output:
// rowsum(P * dP) = dO . (P.V) = dO . O, one f32 FMA chain a query.
//
// Bound on an H100 SXM (495 TFLOP/s TF32 on the tensor cores, 3.35 TB/s):
// five (T x T x dh) products per (row, head) (S, dP, dq, dk, dv),
// 10*B*NH*T^2*dh FLOPs, each as three TF32 products (3xTF32); q, k, v, O
// and dO in and dq, dk, dv out once (32*B*T*NH*dh bytes). At B=16, T=512,
// NH=20, dh 32 dense: 80.5 GFLOP of TF32 (0.163 ms) against 168 MB
// (0.050 ms). Padded and packed rows need the products of their allowed
// pairs.
//
// Design (attention_f32.cuh has the tiles, products and producer). Two
// launches, each output with one owner (no atomics: two runs are
// bit-equal), every product 3xTF32 on wgmma, WGS consumer warpgroups of
// 64 rows a block (two at head dims up to 32, one above) and a producer
// warpgroup:
//   1. per (row b, head h, 64 WGS queries), q and dO resident as raw f32:
//      delta = dO . O per query first; the producer streams each key tile
//      that meets a query tile as k natural and transposed and v natural;
//      S = q.k^T and dP = dO.v^T (the A operands split in registers), P
//      from lse, dS = P * (dP - delta) in registers and dq += dS.k (dS as
//      A, k's transposed tile as B). Pad queries get dq = 0.
//   2. per (row b, head h, 64 WGS keys), k and v resident: for each query
//      tile that meets a key tile, streamed as q and dO natural and
//      transposed with the stage's lse and delta, S^T = k.q^T and
//      dP^T = v.dO^T, P^T and dS^T in registers, dv += P^T.dO and
//      dk += dS^T.q; then every key's dv += f32(1/T) times the sum of the
//      pad queries' dO (their uniform P, in closed form), which the
//      producer sums once it has filled the ring's last stage.
// 7 products per computed score against the 5 the function needs (S and
// dP in both launches). Two consumer warpgroups a block took 0.391 ms
// against one's 0.536 at (16, 512, NH 20, DH 32) padded on an H100 (the
// streamed tiles split once for 128 rows: launch 2's producer splits four
// tiles a stage); at head dims 64 and 128 one warpgroup holds 239-242
// registers, more than a 384-thread block gives each thread.
// What limits it now (6.2 times its bound at that shape): as K1-f32, the
// blocks' fixed work with one block an SM (0.165 ms of the 0.391 with no
// products, loads or stores), the products (the value products 0.138, the
// score products 0.070: each warpgroup waits for each of its four product
// groups a stage) and the producer's loads, split and stores (0.048)
// (tools/probe_attention_f32.py).
//
// Exact zeros. A query with one allowed key (itself) has P = 1 for it and
// dq = dk = 0 in the plain version (delta = dP there). The tensor cores'
// dP and the FMA chain's delta differ in their roundings, so the kernel
// does not rely on their difference: launch 1 counts each query's allowed
// keys, as K1-f32 does, and for a query with one it writes dq = 0 and its
// delta as +inf, which launch 2 reads as dS = 0 for the whole query.
//
// Built by protein_clip_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (plain C interface below).

#include "attention_f32.cuh"

namespace {

using namespace pct_attn_f32;
using pct_attn::overlaps;
using pct_attn::swept_tiles;
using pct_attn::tile_ranges;

// Launch 1's stage: k natural and transposed, v natural, the key segments.
template <int HD>
using DqStage = Stage<HD, true, true, true, false, 1>;
// Launch 2's stage: q and dO natural and transposed; the query segments,
// lse and delta.
template <int HD>
using DkdvStage = Stage<HD, true, true, true, true, 3>;
// Consumer warpgroups a block, each over its own 64 rows: two at head dims
// up to 32 (at most 168 registers a thread), one above.
template <int HD>
constexpr int kWGS = HD <= 32 ? 2 : 1;
// Two resident tiles a warpgroup: q and dO (launch 1), k and v (launch 2).
template <int HD, int WGS>
using DqLayout = Layout<DqStage<HD>, 2 * WGS>;
template <int HD, int WGS>
using DkdvLayout = Layout<DkdvStage<HD>, 2 * WGS>;

// Launch 1. grid (ceil(T / (64 WGS)), NH, B), 128 WGS + kProducer threads. q, k,
// v, o, dout, dq: (B, T, NH, HD) f32, contiguous; seg: (B, T) int32; lse
// (read) and delta (written; +inf at a query with one allowed key):
// (B, NH, T) f32.
template <int HD, int WGS>
__global__ void __launch_bounds__(128 * WGS + kProducer, 1)
attention_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const int32_t* __restrict__ seg,
                            const float* __restrict__ o, const float* __restrict__ dout,
                            const float* __restrict__ lse, float* __restrict__ dq,
                            float* __restrict__ delta_out, int T, int NH) {
  using St = DqStage<HD>;
  using L = DqLayout<HD, WGS>;
  constexpr int DW = St::DW;
  constexpr int KS = St::KS;
  constexpr int S = L::kStages;
  constexpr int kConsumers = 128 * WGS;
  constexpr int kThreads = kConsumers + kProducer;
  constexpr int kTileBytes = kTile * DW * 4;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * S + 1];
  __shared__ float delta_s[kTile * WGS];

  const Head<HD> hd(seg, T, NH);
  const int tile0 = blockIdx.x * WGS;
  const int q0 = tile0 * kTile;  // the block's first query
  const Ring ring = carve<L, St, WGS>(smem_raw, bars);
  if (threadIdx.x >= kConsumers) {  // q and dO of warpgroup w at resident tiles 2 w, 2 w + 1
    for (int w = 0; w < WGS; ++w) {
      load_resident<HD>(ring.resident + 2 * w * kTileBytes, q, hd, q0 + w * kTile, T,
                        threadIdx.x - kConsumers);
      load_resident<HD>(ring.resident + (2 * w + 1) * kTileBytes, dout, hd, q0 + w * kTile, T,
                        threadIdx.x - kConsumers);
    }
  }
  tile_ranges(ring.ranges, hd.seg_row, T, kThreads);
  __syncthreads();
  int4 own[WGS];
  owned(own, ring.ranges, tile0, T);
  const int n = tiles_of(T);
  const int4* ranges = ring.ranges;
  auto visit = [&](int j) {
    bool any = false;
#pragma unroll
    for (int w = 0; w < WGS; ++w) any |= overlaps(own[w], ranges[j]);
    return any;
  };

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    cp_async_arrive(ring.ready);
    const uint32_t* const vec[3] = {reinterpret_cast<const uint32_t*>(hd.seg_row), nullptr,
                                    nullptr};
    produce<HD, St, S>(k, v, vec, hd, T, n, visit, ring, threadIdx.x - kConsumers);
    cp_async_wait_all();
    return;
  }

  if (threadIdx.x < kTile * WGS) {  // delta = dO . O, one FMA chain a query
    const int r = q0 + threadIdx.x;
    float d = 0.f;
    if (r < T) {
      const float* orow = o + hd.base + r * hd.tok;
      const float* drow = dout + hd.base + r * hd.tok;
      for (int c = 0; c < HD; ++c) d = fmaf(drow[c], orow[c], d);
    }
    delta_s[threadIdx.x] = d;
  }
  named_barrier(1, kConsumers);
  const int wg = threadIdx.x >> 7;
  const int4 mine = own[wg];
  const uint32_t q_tile = ring.resident + 2 * wg * kTileBytes;
  const uint32_t do_tile = q_tile + kTileBytes;
  const int t = threadIdx.x & 3;
  int row[2], sq[2];
  own_rows(row, q0 + wg * kTile);
  float lse_q[2], delta[2];
  int cnt[2] = {0, 0};  // allowed keys of each of the thread's two queries
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = row[h] < T;
    sq[h] = in ? hd.seg_row[row[h]] : -1;  // past T: no key
    lse_q[h] = in ? lse[hd.vec + row[h]] : 0.f;
    delta[h] = delta_s[row[h] - q0];
  }
  float acc[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) acc[i] = 0.f;
  mbar_wait(ring.ready, 0);

  int it = 0;
  for (int j = 0; j < n; ++j) {
    if (!visit(j)) continue;
    const bool meets = overlaps(mine, ranges[j]);
    for (int u = 0; u < St::kParts; ++u, ++it) {
      const uint32_t st = take<St, S>(ring, it);
      if (meets) {
        const int32_t* segk = stage_vec<St, S, int32_t>(ring, it, 0);
        float s[KS / 2], dp[KS / 2];
        scores<DW, KS>(s, q_tile, st + St::kNatA_);    // q . k^T, as K1-f32 computes it
        scores<DW, KS>(dp, do_tile, st + St::kNatB_);  // dO . v^T
#pragma unroll
        for (int i = 0; i < KS / 2; ++i) {
          const int sk = segk[acc_col(i, t)];
          const int h = acc_row(i);
          const bool ok = sk > 0 && sk == sq[h];
          cnt[h] += ok;
          // dS, 0 where not allowed
          dp[i] = ok ? ex2(__fmul_rn(s[i], kLog2e) - lse_q[h]) * (dp[i] - delta[h]) : 0.f;
        }
        accumulate<DW, KS>(acc, dp, st + St::kTransA_);  // dq += dS . k
      }
      release<S>(ring, it);
    }
  }
  bool one[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    one[h] = quad_sum(static_cast<float>(cnt[h])) == 1.f;  // the query itself alone
    if (t == 0 && row[h] < T) delta_out[hd.vec + row[h]] = one[h] ? INFINITY : delta[h];
  }
  store_rows<HD>(dq, hd, row, T, [&](int h, int, int i) {
    return one[h] ? make_float2(0.f, 0.f) : make_float2(acc[i], acc[i + 1]);
  });
}

// Launch 2. grid (ceil(T / (64 WGS)), NH, B), 128 WGS + kProducer threads; each
// consumer warpgroup owns 64 keys. lse and delta: (B, NH, T) f32 from
// K1-f32 and launch 1.
template <int HD, int WGS>
__global__ void __launch_bounds__(128 * WGS + kProducer, 1)
attention_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const int32_t* __restrict__ seg,
                              const float* __restrict__ dout, const float* __restrict__ lse,
                              const float* __restrict__ delta, float* __restrict__ dk,
                              float* __restrict__ dv, int T, int NH) {
  using St = DkdvStage<HD>;
  using L = DkdvLayout<HD, WGS>;
  constexpr int DW = St::DW;
  constexpr int KS = St::KS;
  constexpr int S = L::kStages;
  constexpr int kConsumers = 128 * WGS;
  constexpr int kThreads = kConsumers + kProducer;
  constexpr int kTileBytes = kTile * DW * 4;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * S + 1];
  __shared__ float do_sum[DW], scratch[4 * DW];

  const Head<HD> hd(seg, T, NH);
  const int tile0 = blockIdx.x * WGS;
  const int k0 = tile0 * kTile;  // the block's first key
  const Ring ring = carve<L, St, WGS>(smem_raw, bars);
  if (threadIdx.x >= kConsumers) {  // k and v of warpgroup w at resident tiles 2 w, 2 w + 1
    for (int w = 0; w < WGS; ++w) {
      load_resident<HD>(ring.resident + 2 * w * kTileBytes, k, hd, k0 + w * kTile, T,
                        threadIdx.x - kConsumers);
      load_resident<HD>(ring.resident + (2 * w + 1) * kTileBytes, v, hd, k0 + w * kTile, T,
                        threadIdx.x - kConsumers);
    }
  }
  tile_ranges(ring.ranges, hd.seg_row, T, kThreads);
  __syncthreads();
  int4 own[WGS];
  owned(own, ring.ranges, tile0, T);
  bool pads = false;  // a pad query in the row: the pads' dO sum wanted
  for (int j = 0; j < tiles_of(T); ++j) pads |= ring.ranges[j].z != 0;
  const int sweep = swept_tiles(T);
  const int4* ranges = ring.ranges;
  auto visit = [&](int j) {
    bool any = false;
#pragma unroll
    for (int w = 0; w < WGS; ++w) any |= overlaps(ranges[j], own[w]);
    return any;
  };

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    const int p = threadIdx.x - kConsumers;
    cp_async_arrive(ring.ready);
    const uint32_t* const vec[3] = {reinterpret_cast<const uint32_t*>(hd.seg_row),
                                    reinterpret_cast<const uint32_t*>(lse + hd.vec),
                                    reinterpret_cast<const uint32_t*>(delta + hd.vec)};
    produce<HD, St, S>(q, dout, vec, hd, T, sweep, visit, ring, p);
    // the pad queries' part of dv, the same for every key: f32(1/T) sum dO,
    // while the consumers finish their last stages
    if (pads) {
      column_sum<HD>(do_sum, scratch, dout, hd, T, true, p);
      named_barrier(2, kThreads);
    }
    cp_async_wait_all();
    return;
  }

  const int wg = threadIdx.x >> 7;
  const int4 mine = own[wg];
  const uint32_t k_tile = ring.resident + 2 * wg * kTileBytes;
  const uint32_t v_tile = k_tile + kTileBytes;
  const int t = threadIdx.x & 3;
  int row[2], sk[2];
  own_rows(row, k0 + wg * kTile);
#pragma unroll
  for (int h = 0; h < 2; ++h) sk[h] = row[h] < T ? hd.seg_row[row[h]] : 0;  // past T: no query
  float dk_acc[DW / 2], dv_acc[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  mbar_wait(ring.ready, 0);

  int it = 0;
  for (int j = 0; j < sweep; ++j) {
    if (!visit(j)) continue;
    const bool meets = overlaps(ranges[j], mine);
    for (int u = 0; u < St::kParts; ++u, ++it) {
      const uint32_t st = take<St, S>(ring, it);
      if (meets) {
        const int32_t* segq = stage_vec<St, S, int32_t>(ring, it, 0);
        const float* lse_q = stage_vec<St, S, float>(ring, it, 1);
        const float* delta_q = stage_vec<St, S, float>(ring, it, 2);
        float p[KS / 2], ds[KS / 2];  // P^T and dS^T: keys are rows, queries columns
        scores<DW, KS>(p, k_tile, st + St::kNatA_);   // k . q^T
        scores<DW, KS>(ds, v_tile, st + St::kNatB_);  // v . dO^T
#pragma unroll
        for (int i = 0; i < KS / 2; ++i) {
          const int c = acc_col(i, t);
          const int h = acc_row(i);
          const bool ok = sk[h] > 0 && segq[c] == sk[h];
          const float e = ex2(__fmul_rn(p[i], kLog2e) - lse_q[c]);
          const float dl = delta_q[c];
          p[i] = ok ? e : 0.f;
          ds[i] = ok && dl != INFINITY ? e * (ds[i] - dl) : 0.f;
        }
        accumulate<DW, KS>(dv_acc, p, st + St::kTransB_);   // dv += P^T . dO
        accumulate<DW, KS>(dk_acc, ds, st + St::kTransA_);  // dk += dS^T . q
      }
      release<S>(ring, it);
    }
  }
  if (pads) named_barrier(2, kThreads);  // do_sum is in
  const float w_pad = __frcp_rn(static_cast<float>(T));
  store_rows<HD>(dk, hd, row, T,
                 [&](int, int, int i) { return make_float2(dk_acc[i], dk_acc[i + 1]); });
  store_rows<HD>(dv, hd, row, T, [&](int, int col, int i) {
    return pads ? make_float2(dv_acc[i] + w_pad * do_sum[col], dv_acc[i + 1] + w_pad * do_sum[col + 1])
                : make_float2(dv_acc[i], dv_acc[i + 1]);
  });
}

}  // namespace

// Launches both kernels on `stream` (a cudaStream_t) and returns
// cudaGetLastError(): 0 when both launches were accepted,
// cudaErrorInvalidValue for a head dim the kernels do not take (16, 24, 32,
// 64 and 128 they take). out: K1-f32's output; lse: its (B, NH, T)
// statistics; delta: B*NH*T f32 of scratch.
extern "C" int pct_attention_bwd_f32(const void* q, const void* k, const void* v,
                                     const void* segments, const void* out, const void* dout,
                                     const void* lse, void* dq, void* dk, void* dv, void* delta,
                                     int B, int T, int NH, int head_dim, void* stream) {
  return pct_attn::by_head_dim(head_dim, [&](auto head) {
    constexpr int HD = decltype(head)::value;
    constexpr int WGS = kWGS<HD>;
    using L1 = DqLayout<HD, WGS>;
    using L2 = DkdvLayout<HD, WGS>;
    static const cudaError_t allowed[2] = {
        allow_smem(attention_bwd_dq_f32_kernel<HD, WGS>, L1::bytes(tiles_of(kMaxT))),
        allow_smem(attention_bwd_dkdv_f32_kernel<HD, WGS>, L2::bytes(tiles_of(kMaxT)))};
    for (const cudaError_t e : allowed) {
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const dim3 grid((tiles_of(T) + WGS - 1) / WGS, NH, B);
    constexpr int kThreads = 128 * WGS + kProducer;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* qp = static_cast<const float*>(q);
    const auto* kp = static_cast<const float*>(k);
    const auto* vp = static_cast<const float*>(v);
    const auto* sp = static_cast<const int32_t*>(segments);
    const auto* dp = static_cast<const float*>(dout);
    const auto* lp = static_cast<const float*>(lse);
    auto* dl = static_cast<float*>(delta);
    attention_bwd_dq_f32_kernel<HD, WGS><<<grid, kThreads, L1::bytes(tiles_of(T)), s>>>(
        qp, kp, vp, sp, static_cast<const float*>(out), dp, lp, static_cast<float*>(dq), dl, T,
        NH);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_bwd_dkdv_f32_kernel<HD, WGS><<<grid, kThreads, L2::bytes(tiles_of(T)), s>>>(
        qp, kp, vp, sp, dp, lp, dl, static_cast<float*>(dk), static_cast<float*>(dv), T, NH);
    return static_cast<int>(cudaGetLastError());
  });
}
