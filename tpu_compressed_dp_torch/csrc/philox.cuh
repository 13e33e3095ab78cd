// Philox4x32-10 counter-based generator, shared by the dither kernels
// (csrc/dither.cu) of tpu_compressed_dp_torch/ops/kernels.py.
//
// The TPU kernels draw from the TPU's hardware PRNG, reseeded per grid block
// with seed + program_id.  Here the stream is a pure function of (seed, element
// index): element i takes word i % 4 of Philox4x32-10 at counter i / 4, keyed
// by the 64-bit seed.  So the draws do not depend on the grid, and the plain
// PyTorch version (kernels.philox4x32_plain) reproduces them bit for bit.
//
// A uniform is the word's 24 high bits times 2^-24: an exact float32 in
// [0, 1), as _uniform_from_bits of tpu_compressed_dp/ops/kernels.py makes it.

#pragma once

#include <cstdint>

namespace tcdp {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

// Random123's philox4x32 with 10 rounds: counter (c0, c1, c2, c3), key (k0, k1).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The four words for elements 4j .. 4j+3.
__device__ __forceinline__ uint4 philox_block(long long j, unsigned long long seed) {
  const unsigned long long uj = static_cast<unsigned long long>(j);
  return philox4x32_10(make_uint4(static_cast<uint32_t>(uj), static_cast<uint32_t>(uj >> 32), 0u, 0u),
                       static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
}

__device__ __forceinline__ float uniform24(uint32_t w) {
  // w >> 8 < 2^24 converts exactly; the scale is a power of two
  return __fmul_rn(__uint2float_rn(w >> 8), 1.0f / 16777216.0f);
}

}  // namespace tcdp
