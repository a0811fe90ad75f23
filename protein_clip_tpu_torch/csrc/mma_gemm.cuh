// One tiled tensor-core main loop for the port's dense products, Hopper
// (sm_90a): out(N, M) = x(N, K) . W(K, M), both row-major, as the TPU package
// stores them (x token-major, W (in, out)). Shared by csrc/dense_mm.cu (P1:
// s8 x s8 -> s32 and bf16 x bf16 -> f32) and csrc/ffn_gelu.cu (K6: bf16 with
// a fused bias + gelu epilogue).
//
// Block: 256 threads (8 warps as 2 x 4) own a 128 x 128 output tile; each
// warp 64 rows x 32 columns as 4 x 4 mma.sync tiles of 16 x 8, in registers
// for the whole kernel. K is walked in tiles of 64 bytes (32 bf16 or 64 s8),
// two mma k-steps of 32 bytes each (m16n8k16 bf16, m16n8k32 s8). The next
// tile's global loads are issued into registers before the current tile's
// products, so their latency hides behind the tensor cores; then the
// registers go to shared memory. One buffer, two barriers per tile. cp.async
// or TMA rings and wgmma are later work.
//
// The s8 B operand. mma.sync wants B k-contiguous ("col"), and W is stored
// (K, M), M-contiguous. ldmatrix.trans moves 16-bit elements only, so it
// cannot transpose s8. This loop transposes every W tile while staging it:
// each thread loads 4 k-rows (s8) or 2 k-rows (bf16) of 8 consecutive
// columns and rebuilds them with byte permutes into 8 words, one per
// column, each holding that column's consecutive k values, which is the B
// fragment's own layout. The cost is 8 (bf16) or 16 (s8) byte permutes per
// thread per tile, on the integer units beside the tensor cores, and no
// extra pass over W in device memory; the parameter tree keeps the TPU
// package's (in, out) layout. In 32-bit words both element types then have
// the same fragment layout (a k-step is 8 words; a thread reads words tig
// and tig + 4), so one loop serves both.
//
// Shared memory holds tiles as rows of 16 words padded to 20 (fragment reads
// hit 32 distinct banks); the W tile's word columns are XOR-swizzled by the
// column's 8-group (staging stores at most 2-way conflicts).
//
// Edges: rows past N and columns past M are staged as zeros and never
// stored; k past K is staged as zeros. The host wrapper guarantees K * elt
// is a multiple of 32 bytes (s8: K % 32 == 0, bf16: K % 16 == 0), M % 8 == 0
// and 16-byte aligned bases, so every staged chunk is wholly inside or
// outside.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace pct_gemm {

constexpr int kThreads = 256;
constexpr int kBlockRows = 128;          // of x and out
constexpr int kBlockCols = 128;          // of W and out
constexpr int kTileBytes = 64;           // k bytes per staged tile
constexpr int kTileWords = kTileBytes / 4;
constexpr int kStride = kTileWords + 4;  // padded shared row, in words

struct S8 {
  using Elt = int8_t;
  using Acc = int32_t;
  static constexpr int kEltBytes = 1;
  static constexpr int kRowsPerWord = 4;  // k values in one 32-bit word
  __device__ __forceinline__ static void mma(int32_t (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

struct BF16 {
  using Elt = __nv_bfloat16;
  using Acc = float;
  static constexpr int kEltBytes = 2;
  static constexpr int kRowsPerWord = 2;
  __device__ __forceinline__ static void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// A thread's share of one staged k tile, in registers: two 16-byte chunks of
// x, and kRowsPerWord k-rows of 8 W columns (32 bytes either way).
struct Staged {
  uint4 a[2];
  uint32_t b[8];
};

template <class Op>
__device__ __forceinline__ void load_tile(const uint8_t* __restrict__ x,
                                          const uint8_t* __restrict__ w, int N, int K,
                                          int M, int row0, int col0, int tile,
                                          Staged& s) {
  const int tid = threadIdx.x;
  const int64_t x_row_bytes = static_cast<int64_t>(K) * Op::kEltBytes;
  const int kb0 = tile * kTileBytes;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kThreads;  // 512 chunks of 16 bytes: 128 rows x 4
    const int row = row0 + (c >> 2);
    const int kb = kb0 + (c & 3) * 16;
    s.a[i] = make_uint4(0u, 0u, 0u, 0u);
    if (row < N && kb < x_row_bytes) {
      s.a[i] = *reinterpret_cast<const uint4*>(x + row * x_row_bytes + kb);
    }
  }
  // W: k group kg (kRowsPerWord rows) x column group ng (8 columns).
  const int kg = tid >> 4;
  const int ng = tid & 15;
  const int col = col0 + ng * 8;
  const int64_t w_row_bytes = static_cast<int64_t>(M) * Op::kEltBytes;
  const int k = kb0 / Op::kEltBytes + kg * Op::kRowsPerWord;
#pragma unroll
  for (int r = 0; r < Op::kRowsPerWord; ++r) {
    const bool ok = col < M && k + r < K;
    const uint8_t* p = w + (k + r) * w_row_bytes + static_cast<int64_t>(col) * Op::kEltBytes;
    if constexpr (Op::kEltBytes == 1) {  // 4 rows of 8 bytes
      const uint2 v = ok ? *reinterpret_cast<const uint2*>(p) : make_uint2(0u, 0u);
      s.b[2 * r] = v.x;
      s.b[2 * r + 1] = v.y;
    } else {                   // 2 rows of 16 bytes
      const uint4 v = ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
      s.b[4 * r] = v.x;
      s.b[4 * r + 1] = v.y;
      s.b[4 * r + 2] = v.z;
      s.b[4 * r + 3] = v.w;
    }
  }
}

// Registers to shared memory; W's 8 columns become 8 k-contiguous words.
template <class Op>
__device__ __forceinline__ void store_tile(const Staged& s, uint32_t* as, uint32_t* bs) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kThreads;
    *reinterpret_cast<uint4*>(&as[(c >> 2) * kStride + (c & 3) * 4]) = s.a[i];
  }
  uint32_t col[8];
  if constexpr (Op::kEltBytes == 1) {
    // rows r0..r3 in s.b[2r] (columns 0-3) and s.b[2r + 1] (columns 4-7);
    // column j's word is bytes (r0[j], r1[j], r2[j], r3[j]), low k first.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t w0 = s.b[h], w1 = s.b[2 + h], w2 = s.b[4 + h], w3 = s.b[6 + h];
      const uint32_t lo01 = __byte_perm(w0, w1, 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
      const uint32_t lo23 = __byte_perm(w2, w3, 0x5140);
      const uint32_t hi01 = __byte_perm(w0, w1, 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
      const uint32_t hi23 = __byte_perm(w2, w3, 0x7362);
      col[4 * h + 0] = __byte_perm(lo01, lo23, 0x5410);
      col[4 * h + 1] = __byte_perm(lo01, lo23, 0x7632);
      col[4 * h + 2] = __byte_perm(hi01, hi23, 0x5410);
      col[4 * h + 3] = __byte_perm(hi01, hi23, 0x7632);
    }
  } else {
    // rows r0 (s.b[0..3]) and r1 (s.b[4..7]); word i holds columns 2i (low
    // half) and 2i + 1; column j's word is (r0[j], r1[j]), low k first.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      col[2 * i] = __byte_perm(s.b[i], s.b[4 + i], 0x5410);
      col[2 * i + 1] = __byte_perm(s.b[i], s.b[4 + i], 0x7632);
    }
  }
  const int kg = tid >> 4;
  const int ng = tid & 15;
#pragma unroll
  for (int j = 0; j < 8; ++j) bs[(ng * 8 + j) * kStride + (kg ^ ng)] = col[j];
}

// acc[mt][nt][i]: the warp's m16 tile mt (rows warp_row*64 + mt*16 + g and
// + 8) by n8 tile nt (columns warp_col*32 + nt*8 + tig*2 and + 1), in the
// mma C layout: i = 0, 1 row g; i = 2, 3 row g + 8.
template <class Op>
__device__ __forceinline__ void mainloop(const typename Op::Elt* __restrict__ x,
                                         const typename Op::Elt* __restrict__ w, int N,
                                         int K, int M, int row0, int col0,
                                         typename Op::Acc (&acc)[4][4][4]) {
  __shared__ __align__(16) uint32_t as[kBlockRows * kStride];
  __shared__ __align__(16) uint32_t bs[kBlockCols * kStride];
  const uint8_t* xb = reinterpret_cast<const uint8_t*>(x);
  const uint8_t* wb = reinterpret_cast<const uint8_t*>(w);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int wr = (warp >> 2) * 64;  // warp's first row in the block tile
  const int wc = (warp & 3) * 32;   // warp's first column
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
    }
  }
  const int n_tiles = (K * Op::kEltBytes + kTileBytes - 1) / kTileBytes;
  Staged s;
  load_tile<Op>(xb, wb, N, K, M, row0, col0, 0, s);
  for (int t = 0; t < n_tiles; ++t) {
    store_tile<Op>(s, as, bs);
    __syncthreads();
    if (t + 1 < n_tiles) load_tile<Op>(xb, wb, N, K, M, row0, col0, t + 1, s);
#pragma unroll
    for (int ks = 0; ks < kTileWords / 8; ++ks) {
      const int c0 = ks * 8 + tig;
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const uint32_t* r = &as[(wr + mt * 16 + g) * kStride];
        a[mt][0] = r[c0];
        a[mt][1] = r[8 * kStride + c0];
        a[mt][2] = r[c0 + 4];
        a[mt][3] = r[8 * kStride + c0 + 4];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wc + nt * 8 + g;
        const int swz = n >> 3;
        const uint32_t b0 = bs[n * kStride + (c0 ^ swz)];
        const uint32_t b1 = bs[n * kStride + ((c0 + 4) ^ swz)];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) Op::mma(acc[mt][nt], a[mt], b0, b1);
      }
    }
    __syncthreads();
  }
}

}  // namespace pct_gemm
