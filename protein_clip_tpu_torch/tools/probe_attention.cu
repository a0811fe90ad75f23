// A probe, not a kernel of the port: K5's dk/dv launch (csrc/attention_bwd.cu)
// with its ring filled by TMA instead of cp.async, so that the two routes
// are weighed on the card (protein_clip_tpu_torch/tools/probe_attention.py
// builds and runs it).
//
// The TMA route: one 4-D tensor map per (B, T, NH, 32) tensor (q, k, v,
// dO), dims (32, NH, T, B), box (32, 1, 64, 1) = one 64-row tile with the
// 64-byte swizzle that attention.cuh's tiles already have, zeros past T;
// the four maps are encoded on the host for every call, as a TMA-fed K5
// would have to (its two launches share them). The producer warp's lane 0
// expects the two tiles' bytes on the stage's full barrier and issues two
// TMA loads; the per-token vectors (segments, lse, delta) still come by
// cp.async, whose 32 arrivals complete the barrier's count. The consumers
// run K5's own dkdv_consume, so the two routes must agree to the bit.

#include "attention_bwd.cu"

#include <chrono>

namespace {

using namespace pct_attn;

struct Maps {
  CUtensorMap q, k, v, dout;
};

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Tokens [t0, t0 + 64) of the block's (row, head) into a tile; completes
// its 4096 bytes on bar.
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, int t0,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(static_cast<int>(blockIdx.y)), "r"(t0),
      "r"(static_cast<int>(blockIdx.z)), "r"(bar)
      : "memory");
}

__global__ void __launch_bounds__(kThreads)
dkdv_tma_kernel(const __grid_constant__ Maps maps, const int32_t* __restrict__ seg,
                const bf16* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
                int T, int NH) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages + 1];
  const Head hd(seg, T, NH);
  const int k0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31;
  // the resident tiles wait for the barriers: TMA completes on them
  const Ring ring = setup(smem_raw, bars, hd.seg_row, T, [](uint32_t) {});
  const int4 own = ring.ranges[blockIdx.x];
  const int sweep = swept_tiles(T);

  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (lane == 0) {
      mbar_expect(ring.ready, 2 * kTileBytes);
      tma_tile(ring.resident, &maps.k, k0, ring.ready);
      tma_tile(ring.resident + kTileBytes, &maps.v, k0, ring.ready);
    }
    cp_async_arrive(ring.ready);
    int it = 0;
    for (int j = 0; j < sweep; ++j) {
      if (!overlaps(ring.ranges[j], own)) continue;
      const uint32_t st = claim(ring, it);
      const uint32_t full = ring.full + 8 * (it % kStages);
      if (lane == 0) {
        mbar_expect(full, 2 * kTileBytes);
        tma_tile(st, &maps.q, j * kTile, full);
        tma_tile(st + kTileBytes, &maps.dout, j * kTile, full);
      }
      load_vec(st + 2 * kTileBytes, hd.seg_row, 0, j * kTile, T, lane);
      load_vec(st + 2 * kTileBytes + kVecBytes, lse, hd.vec, j * kTile, T, lane);
      load_vec(st + 2 * kTileBytes + 2 * kVecBytes, delta, hd.vec, j * kTile, T, lane);
      fill(ring, it++);
    }
    cp_async_wait_all();
    return;
  }

  dkdv_consume(ring, hd, own, sweep, k0, dout, dk, dv, T);
}

bool tile_map(CUtensorMap* map, const void* base, int B, int T, int NH) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {kHeadDim, static_cast<cuuint64_t>(NH), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t tok = static_cast<cuuint64_t>(NH) * kHeadDim * 2;
  const cuuint64_t strides[3] = {kHeadDim * 2, tok, tok * T};
  const cuuint32_t box[4] = {kHeadDim, 1, kTile, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool encode_maps(Maps* maps, const void* q, const void* k, const void* v, const void* dout,
                 int B, int T, int NH) {
  return tile_map(&maps->q, q, B, T, NH) && tile_map(&maps->k, k, B, T, NH) &&
         tile_map(&maps->v, v, B, T, NH) && tile_map(&maps->dout, dout, B, T, NH);
}

}  // namespace

// K5's launch 1 as shipped: dq, and delta for launch 2.
extern "C" int pct_probe_delta(const void* q, const void* k, const void* v, const void* segments,
                               const void* dout, const void* lse, void* dq, void* delta, int B,
                               int T, int NH, void* stream) {
  static const cudaError_t allowed = allow_smem(attention_bwd_dq_kernel);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  attention_bwd_dq_kernel<<<dim3(tiles_of(T), NH, B), kThreads, smem_bytes(tiles_of(T)),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int32_t*>(segments), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<bf16*>(dq), static_cast<float*>(delta), T, NH);
  return static_cast<int>(cudaGetLastError());
}

// K5's launch 2, its ring filled by cp.async (tma = 0: the shipped kernel)
// or by TMA (tma = 1: four tensor maps encoded first).
extern "C" int pct_probe_dkdv(int tma, const void* q, const void* k, const void* v,
                              const void* segments, const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int B, int T, int NH,
                              void* stream) {
  static const cudaError_t allowed[2] = {allow_smem(attention_bwd_dkdv_kernel),
                                         allow_smem(dkdv_tma_kernel)};
  if (allowed[tma != 0] != cudaSuccess) return static_cast<int>(allowed[tma != 0]);
  const dim3 grid(tiles_of(T), NH, B);
  const int smem = smem_bytes(tiles_of(T));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* sp = static_cast<const int32_t*>(segments);
  const auto* dp = static_cast<const bf16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dl = static_cast<const float*>(delta);
  if (tma) {
    Maps maps;
    if (!encode_maps(&maps, q, k, v, dout, B, T, NH)) return static_cast<int>(cudaErrorInvalidValue);
    dkdv_tma_kernel<<<grid, kThreads, smem, s>>>(maps, sp, dp, lp, dl, static_cast<bf16*>(dk),
                                                 static_cast<bf16*>(dv), T, NH);
  } else {
    attention_bwd_dkdv_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), sp,
        dp, lp, dl, static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, NH);
  }
  return static_cast<int>(cudaGetLastError());
}

// Mean host microseconds to encode the TMA route's four maps, over iters.
extern "C" double pct_probe_encode_us(const void* q, const void* k, const void* v,
                                      const void* dout, int B, int T, int NH, int iters) {
  Maps maps;
  const auto start = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) {
    if (!encode_maps(&maps, q, k, v, dout, B, T, NH)) return -1.0;
  }
  const std::chrono::duration<double, std::micro> took = std::chrono::steady_clock::now() - start;
  return took.count() / iters;
}
