// Per-element QSGD and TernGrad arithmetic, shared by the dither kernels
// (csrc/dither.cu, integer levels) and the quantize+pack kernels
// (csrc/quant_pack.cu, wire bytes), so that the packed bytes decode to
// exactly the levels the level kernels write.
//
// sign is the select form (x > 0) - (x < 0), so NaN has sign 0; the float
// level converts to the integer type saturating, with NaN -> 0 (XLA's
// convert).  Every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn), in the JAX kernels' order: nvcc would otherwise contract
// (|x| * inv) * s + u into an FMA and move floor boundaries.

#pragma once

namespace tcdp {

__device__ __forceinline__ float sign_sel(float x) {
  return (x > 0.0f ? 1.0f : 0.0f) - (x < 0.0f ? 1.0f : 0.0f);
}

// int16 sign(x) * floor((|x| * inv) * s + u)
__device__ __forceinline__ short qsgd1(float x, float inv, float s, float u) {
  const float m = floorf(__fadd_rn(__fmul_rn(__fmul_rn(fabsf(x), inv), s), u));
  const float f = __fmul_rn(sign_sel(x), m);
  if (isnan(f)) return 0;
  return static_cast<short>(fminf(fmaxf(f, -32768.0f), 32767.0f));
}

// int8 sign(x) * (u < |x| * inv)
__device__ __forceinline__ signed char tern1(float x, float inv, float u) {
  return u < __fmul_rn(fabsf(x), inv) ? static_cast<signed char>(sign_sel(x)) : 0;
}

}  // namespace tcdp
