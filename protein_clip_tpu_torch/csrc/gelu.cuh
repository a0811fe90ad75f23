// The gelu of the fused FFN kernels, K6 (ffn_gelu.cu, bf16) and K6-f32
// (ffn_gelu_f32.cu): f32 in, f32 out, in the plain version's arithmetic
// (ops/ffn._gelu_f32). Mode 0 is ESM's exact form, a 0.5 (1 + erf(a /
// sqrt(2))) with CUDA's erff (the TPU kernel carried Eigen's polynomial only
// because Mosaic has no erf); mode 1 the tanh form, 0.5 a (1 + tanh(sqrt(2 /
// pi) (a + 0.044715 a^3))).

#pragma once

namespace pct_ffn {

__device__ __forceinline__ float gelu(float a, int mode) {
  if (mode == 1) {
    const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
    const float kKappa = 0.044715f;
    const float cube = a * a * a;
    return 0.5f * a * (1.0f + tanhf(kBeta * (a + kKappa * cube)));
  }
  return a * 0.5f * (1.0f + erff(a * 0.7071067811865476f));
}

}  // namespace pct_ffn
