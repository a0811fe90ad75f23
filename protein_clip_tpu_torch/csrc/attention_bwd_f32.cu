// Segment-masked attention backward in f32 (K5-f32) for ESM-2's head dims
// (16, 24, 32, 64, 128), Hopper.
//
// Replaces protein_clip_tpu/ops/attention_pallas.py::_bwd_kernel / _bwd_row
// (launched by _attention_bwd_call as the VJP of fused_attention) for f32
// q, k, v and dO. Same function as K5 (attention_bwd.cu) with no rounding
// to bf16: P = softmax of the masked scores in f32; dP = dO.v^T;
// delta = rowsum(P * dP); dS = P * (dP - delta) where allowed, else 0 (a
// pad query row's uniform P feeds dv but gives no dq or dk); dq = dS.k,
// dk = dS^T.q, dv = P^T.dO, in f32. P comes from K1-f32's statistics,
// P = 2^(round(s log2(e)) - lse), and delta from K1-f32's output:
// rowsum(P * dP) = dO . (P.V) = dO . O, exact in f32 up to the order of
// the sums (in bf16 O's rounding made this form too coarse, attention_bwd.cu
// says why; here O is f32). delta is summed over the columns in the order
// score_tile sums dP, so a query with one allowed key, whose P is 1 and O
// is v to the bit (attention_fwd_f32.cu), gets delta = dP to the bit and
// dq = dk = 0 exactly, as the softmax's gradient is.
//
// Bound on an H100 SXM (495 TFLOP/s TF32 on the tensor cores, 3.35 TB/s):
// five (T x T x dh) products per (row, head) (S, dP, dq, dk, dv),
// 10*B*NH*T^2*dh FLOPs, each as three TF32 products (3xTF32, f32-exact);
// q, k, v, O and dO in and dq, dk, dv out once (32*B*T*NH*dh bytes). At
// B=16, T=512, NH=20, dh 32 dense: 80.5 GFLOP of TF32 (0.163 ms) against
// 168 MB (0.050 ms); this FFMA design's ceiling, the products at 67 TFLOP/s
// f32, is 0.401 ms. Padded and packed rows need the products of their
// allowed pairs.
//
// Design (attention_f32.cuh has the tiles and products). Two launches of
// 256-thread blocks, each output with one owner (no atomics: two runs are
// bit-equal):
//   1. per (row b, head h, 64 queries), q and dO tiles resident: delta =
//      dO . O per query (one thread a query), written as scratch for
//      launch 2; then for each key tile that meets the query tile, S = q.k^T
//      and dP = dO.v^T by FFMA, P from lse, dS to shared memory and
//      dq += dS.k. Pad queries get dq = 0.
//   2. per (row b, head h, 64 keys), k and v tiles resident: for each query
//      tile that meets the key tile, S^T = k.q^T and dP^T = v.dO^T, P^T and
//      dS^T from the query tile's lse and delta, dv += P^T.dO and
//      dk += dS^T.q; then every key's dv += f32(1/T) times the sum of the
//      pad queries' dO (their uniform P, in closed form).
// 7 products per computed score against the 5 the function needs (S and
// dP in both launches).
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

// Dynamic shared memory for rows of n tiles: four tiles, one or two
// 64 x 64 products, three per-row vectors and the tile ranges (170 KB at DH
// 128 and the longest row, launch 2).
template <int DW>
constexpr int bwd_smem(int n) {
  return 4 * (4 * kTileFloats<DW> + 2 * kPFloats + 3 * kTile) + 16 * n;
}

// Launch 1. grid (ceil(T / 64), NH, B), kThreads threads. q, k, v, o,
// dout, dq: (B, T, NH, HD) f32, contiguous; seg: (B, T) int32; lse (read)
// and delta (written): (B, NH, T) f32.
template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const int32_t* __restrict__ seg,
                            const float* __restrict__ o, const float* __restrict__ dout,
                            const float* __restrict__ lse, float* __restrict__ dq,
                            float* __restrict__ delta_out, int T, int NH) {
  constexpr int DW = kWidth<HD>;
  constexpr int NC = kCols<DW>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kTileFloats<DW>;
  float* ks = dos + kTileFloats<DW>;
  float* vs = ks + kTileFloats<DW>;
  float* dss = vs + kTileFloats<DW>;
  float* delta_s = dss + 2 * kPFloats;
  int32_t* segk = reinterpret_cast<int32_t*>(delta_s + kTile);
  int4* ranges = reinterpret_cast<int4*>(segk + 2 * kTile);

  const Head<HD> hd(seg, T, NH);
  const int q0 = blockIdx.x * kTile;
  tile_ranges(ranges, hd.seg_row, T, kThreads);
  load_tile<HD>(qs, q, hd, q0, T);
  load_tile<HD>(dos, dout, hd, q0, T);
  if (threadIdx.x < kTile) {  // delta = dO . O, one FMA chain a query in score_tile's order
    const int t = q0 + threadIdx.x;
    float d = 0.f;
    if (t < T) {
      const float* orow = o + hd.base + t * hd.tok;
      const float* drow = dout + hd.base + t * hd.tok;
      for (int c = 0; c < HD; ++c) d = fmaf(drow[c], orow[c], d);
      delta_out[hd.vec + t] = d;
    }
    delta_s[threadIdx.x] = d;
  }
  __syncthreads();
  const int4 own = ranges[blockIdx.x];

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  int sq[4];
  float lse_q[4], delta[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    const bool in = r < T;
    sq[i] = in ? hd.seg_row[r] : -1;  // past T: no key
    lse_q[i] = in ? lse[hd.vec + r] : 0.f;
    delta[i] = delta_s[ty + 16 * i];
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }

  const int n_tiles = tiles_of(T);
  for (int j = 0; j < n_tiles; ++j) {
    if (!overlaps(own, ranges[j])) continue;
    __syncthreads();  // the last tile's k, v and dS are read
    load_tile<HD>(ks, k, hd, j * kTile, T);
    load_tile<HD>(vs, v, hd, j * kTile, T);
    load_vec(segk, hd.seg_row, j * kTile, T);
    __syncthreads();
    float s[4][4], dp[4][4];
    score_tile<DW>(s, qs, ks, tx, ty);    // q . k^T
    score_tile<DW>(dp, dos, vs, tx, ty);  // dO . v^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int sk = segk[tx + 16 * jj];
        const bool ok = sk > 0 && sk == sq[i];
        const float p = ok ? pct_attn::ex2(__fmul_rn(s[i][jj], kLog2e) - lse_q[i]) : 0.f;
        dss[(ty + 16 * i) * kPStride + tx + 16 * jj] = p * (dp[i][jj] - delta[i]);
      }
    }
    __syncwarp();
    accumulate<DW>(acc, dss, ks, tx, ty);  // dq += dS . k
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<HD>(dq, hd, q0, T, acc, one, tx, ty);
}

// Launch 2. grid (ceil(T / 64), NH, B), kThreads threads; the block owns 64
// keys. lse and delta: (B, NH, T) f32 from K1-f32 and launch 1.
template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const int32_t* __restrict__ seg,
                              const float* __restrict__ dout, const float* __restrict__ lse,
                              const float* __restrict__ delta, float* __restrict__ dk,
                              float* __restrict__ dv, int T, int NH) {
  constexpr int DW = kWidth<HD>;
  constexpr int NC = kCols<DW>;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kTileFloats<DW>;
  float* qs = vs + kTileFloats<DW>;
  float* dos = qs + kTileFloats<DW>;
  float* pts = dos + kTileFloats<DW>;
  float* dsts = pts + kPFloats;
  float* lse_s = dsts + kPFloats;
  float* delta_s = lse_s + kTile;
  int32_t* segq = reinterpret_cast<int32_t*>(delta_s + kTile);
  int4* ranges = reinterpret_cast<int4*>(segq + kTile);
  __shared__ float do_sum[DW], scratch[kThreads];

  const Head<HD> hd(seg, T, NH);
  const int k0 = blockIdx.x * kTile;
  tile_ranges(ranges, hd.seg_row, T, kThreads);
  load_tile<HD>(ks, k, hd, k0, T);
  load_tile<HD>(vs, v, hd, k0, T);
  __syncthreads();
  const int4 own = ranges[blockIdx.x];
  // The pad queries' part of dv, the same for every key: f32(1/T) sum dO.
  bool pads = false;
  for (int j = 0; j < tiles_of(T); ++j) pads |= ranges[j].z != 0;
  if (pads) column_sum<HD>(do_sum, scratch, dout, hd, T, true);

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  int sk[4];
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    sk[i] = r < T ? hd.seg_row[r] : 0;  // past T: allowed for no query
#pragma unroll
    for (int n = 0; n < NC; ++n) dk_acc[i][n] = dv_acc[i][n] = 0.f;
  }

  const int sweep = swept_tiles(T);
  for (int j = 0; j < sweep; ++j) {
    if (!overlaps(ranges[j], own)) continue;
    __syncthreads();  // the last tile's q, dO, P^T and dS^T are read
    load_tile<HD>(qs, q, hd, j * kTile, T);
    load_tile<HD>(dos, dout, hd, j * kTile, T);
    load_vec(segq, hd.seg_row, j * kTile, T);
    load_vec(lse_s, lse + hd.vec, j * kTile, T);
    load_vec(delta_s, delta + hd.vec, j * kTile, T);
    __syncthreads();
    float p[4][4], ds[4][4];  // P^T and dS^T: keys are rows, queries columns
    score_tile<DW>(p, ks, qs, tx, ty);    // k . q^T
    score_tile<DW>(ds, vs, dos, tx, ty);  // v . dO^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        const bool ok = sk[i] > 0 && segq[c] == sk[i];
        const float e = pct_attn::ex2(__fmul_rn(p[i][jj], kLog2e) - lse_s[c]);
        pts[(ty + 16 * i) * kPStride + c] = ok ? e : 0.f;
        dsts[(ty + 16 * i) * kPStride + c] = ok ? e * (ds[i][jj] - delta_s[c]) : 0.f;
      }
    }
    __syncwarp();
    accumulate<DW>(dv_acc, pts, dos, tx, ty);  // dv += P^T . dO
    accumulate<DW>(dk_acc, dsts, qs, tx, ty);  // dk += dS^T . q
  }
  if (pads) {
    const float w_pad = __frcp_rn(static_cast<float>(T));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int n = 0; n < NC; ++n) dv_acc[i][n] += w_pad * do_sum[out_col<DW>(n, tx)];
    }
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<HD>(dk, hd, k0, T, dk_acc, one, tx, ty);
  store_rows<HD>(dv, hd, k0, T, dv_acc, one, tx, ty);
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
    constexpr int DW = kWidth<HD>;
    const int most = bwd_smem<DW>(tiles_of(pct_attn::kMaxT));
    static const cudaError_t allowed[2] = {allow_smem(attention_bwd_dq_f32_kernel<HD>, most),
                                           allow_smem(attention_bwd_dkdv_f32_kernel<HD>, most)};
    for (const cudaError_t e : allowed) {
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const dim3 grid(tiles_of(T), NH, B);
    const int smem = bwd_smem<DW>(tiles_of(T));
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* qp = static_cast<const float*>(q);
    const auto* kp = static_cast<const float*>(k);
    const auto* vp = static_cast<const float*>(v);
    const auto* sp = static_cast<const int32_t*>(segments);
    const auto* dp = static_cast<const float*>(dout);
    const auto* lp = static_cast<const float*>(lse);
    auto* dl = static_cast<float*>(delta);
    attention_bwd_dq_f32_kernel<HD><<<grid, kThreads, smem, s>>>(
        qp, kp, vp, sp, static_cast<const float*>(out), dp, lp, static_cast<float*>(dq), dl, T,
        NH);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_bwd_dkdv_f32_kernel<HD><<<grid, kThreads, smem, s>>>(
        qp, kp, vp, sp, dp, lp, dl, static_cast<float*>(dk), static_cast<float*>(dv), T, NH);
    return static_cast<int>(cudaGetLastError());
  });
}
