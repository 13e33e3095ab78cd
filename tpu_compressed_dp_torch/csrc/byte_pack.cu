// Byte packers of given levels for tpu_compressed_dp_torch/ops/kernels.py.
//
// Replace the Pallas TPU kernels _pack2b_kernel (pack_ternary_pallas) and
// _qsgd_pack_levels_kernel (qsgd_pack_pallas) of
// tpu_compressed_dp/ops/kernels.py, both run through _pack_bytes_call:
//   * ternary_bytes_kernel: int8 levels -> uint8[ceil(n/4)]; byte j is
//     sum_k (level_{4j+k} + 1) * 4^k over k < 4, taken in int32 and cut to
//     8 bits (the reference sums the codes in float32, exactly, and converts
//     float -> int32 -> uint8); a padded tail counts as level 0 (code 1);
//   * qsgd_bytes_kernel: int16 levels -> uint8 |level| [n] (taken in int32,
//     cut to 8 bits) and uint8[ceil(n/8)] sign bitmap, bit k of byte j set
//     iff level_{8j+k} < 0.
// The TPU kernels pack with a matmul against a place-value matrix (the
// vector unit has no byte shifts across lanes); one thread per output byte
// does it with integer arithmetic here, in a grid-stride loop.
//
// Bound: the bytes.  Ternary reads n and writes n / 4 (1.25n: 8.22 MB, 2.45 us
// at n = 6,573,120 at the 3.35 TB/s of an H100 SXM at its 700 W limit); QSGD
// reads 2n and writes n + n / 8 (3.125n: 20.5 MB, 6.13 us).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ternary_bytes_kernel(const int8_t* __restrict__ levels, long long n, uint8_t* __restrict__ out) {
  const long long nb = (n + 3) >> 2;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x; j < nb; j += stride) {
    int b = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long i = (j << 2) + k;
      const int code = (i < n ? (int)__ldg(levels + i) : 0) + 1;
      b += code * (1 << (2 * k));
    }
    out[j] = (uint8_t)b;
  }
}

__global__ void __launch_bounds__(kThreads)
qsgd_bytes_kernel(const int16_t* __restrict__ levels, long long n, uint8_t* __restrict__ mags,
                  uint8_t* __restrict__ signs) {
  const long long nb = (n + 7) >> 3;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x; j < nb; j += stride) {
    unsigned bits = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const long long i = (j << 3) + k;
      if (i < n) {
        const int l = (int)__ldg(levels + i);
        mags[i] = (uint8_t)abs(l);
        bits |= (l < 0 ? 1u : 0u) << k;
      }
    }
    signs[j] = (uint8_t)bits;
  }
}

int grid_for(long long work) {
  const long long blocks = (work + kThreads - 1) / kThreads;
  return (int)(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16);
}

}  // namespace

// out holds ceil(n / 4) bytes.  Returns the cudaError_t of the launch.
extern "C" int tcdp_pack_ternary_bytes(const int8_t* levels, long long n, uint8_t* out,
                                       void* stream) {
  if (n <= 0) return 0;
  ternary_bytes_kernel<<<grid_for((n + 3) >> 2), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      levels, n, out);
  return (int)cudaGetLastError();
}

// mags holds n bytes, signs ceil(n / 8).
extern "C" int tcdp_qsgd_pack_bytes(const int16_t* levels, long long n, uint8_t* mags,
                                    uint8_t* signs, void* stream) {
  if (n <= 0) return 0;
  qsgd_bytes_kernel<<<grid_for((n + 7) >> 3), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      levels, n, mags, signs);
  return (int)cudaGetLastError();
}
