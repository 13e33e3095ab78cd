// Fused quantize+pack for tpu_compressed_dp_torch/ops/kernels.py: dither and
// bit-pack in one pass, straight to the wire bytes.
//
// Replaces the Pallas TPU kernels _terngrad_pack_kernel and _qsgd_pack_kernel
// (_run_quant_pack: terngrad_pack, terngrad_pack_prescaled, qsgd_pack) of
// tpu_compressed_dp/ops/kernels.py:
//   * terngrad_pack_kernel: byte j packs the ternary codes level + 1 of
//     elements 4j .. 4j+3, element i at bits 2 * (i % 4); a padded tail packs
//     as code 1 (level 0), as wire.pack_ternary's zero padding does;
//   * qsgd_pack_kernel: mags[i] = |level_i| as uint8 (the int32 -> uint8
//     truncation of wire.qsgd_wire_pack), and byte j of the sign bitmap holds
//     bit (i % 8) set iff level_i < 0 for elements 8j .. 8j+7 (a level of
//     -0 is not negative).
// The levels are those of csrc/dither.cu, bit for bit: the same Philox stream
// (element i is word i % 4 at counter i / 4, philox.cuh) drawn in registers,
// and the same arithmetic (quant.cuh).  So unpacking the bytes gives exactly
// what the level kernels write, and the int8 / int16 level vector never
// reaches device memory.  inv is read from device memory.
//
// Bound: the bytes.  TernGrad reads 4n and writes n / 4 (4.25n: 27.94 MB,
// 8.34 us at n = 6,573,120 at the 3.35 TB/s of an H100 SXM at its 700 W
// limit); QSGD reads 4n and writes n + n / 8 (5.125n: 33.69 MB, 10.06 us).
// Philox's 15 integer operations per element take 2.9 us at that n at the
// SM's issue rate (33.5 T lane-operations/s).
// Design: one thread per output byte of the packed stream (4 elements for
// TernGrad, one Philox call; 8 for QSGD, two calls), a grid-stride loop,
// 16-byte loads of x and an 8-byte store of the QSGD magnitudes where the
// pointers allow it (scalar otherwise, and for the ragged tail).

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "quant.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned tcode(float x, float inv, uint32_t w) {
  return static_cast<unsigned>(tcdp::tern1(x, inv, tcdp::uniform24(w)) + 1);
}

__global__ void __launch_bounds__(kThreads)
terngrad_pack_kernel(const float* __restrict__ x, long long n, const float* __restrict__ inv_ptr,
                     unsigned long long seed, uint8_t* __restrict__ out) {
  const float inv = __ldg(inv_ptr);
  const long long nb = (n + 3) >> 2;
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < nb; j += stride) {
    const uint4 w = tcdp::philox_block(j, seed);
    const long long i = j << 2;
    unsigned b;
    if (vec && i + 3 < n) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(x) + j);
      b = tcode(v.x, inv, w.x) | (tcode(v.y, inv, w.y) << 2) | (tcode(v.z, inv, w.z) << 4) |
          (tcode(v.w, inv, w.w) << 6);
    } else {
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
      b = 0;
      for (int k = 0; k < 4; ++k) {
        b |= (i + k < n ? tcode(__ldg(x + i + k), inv, ws[k]) : 1u) << (2 * k);
      }
    }
    out[j] = static_cast<uint8_t>(b);
  }
}

__global__ void __launch_bounds__(kThreads)
qsgd_pack_kernel(const float* __restrict__ x, long long n, const float* __restrict__ inv_ptr,
                 unsigned long long seed, float s, uint8_t* __restrict__ mags,
                 uint8_t* __restrict__ signs) {
  const float inv = __ldg(inv_ptr);
  const long long nb = (n + 7) >> 3;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) & 15) | (reinterpret_cast<uintptr_t>(mags) & 7)) == 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < nb; j += stride) {
    const uint4 w0 = tcdp::philox_block(2 * j, seed);
    const uint4 w1 = tcdp::philox_block(2 * j + 1, seed);
    const uint32_t ws[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    const long long i = j << 3;
    float v[8];
    const bool full = i + 7 < n;
    if (vec && full) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(x) + 2 * j);
      const float4 b = __ldg(reinterpret_cast<const float4*>(x) + 2 * j + 1);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = i + k < n ? __ldg(x + i + k) : 0.0f;
    }
    unsigned sign = 0;
    uint8_t m[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int lv = tcdp::qsgd1(v[k], inv, s, tcdp::uniform24(ws[k]));
      m[k] = static_cast<uint8_t>(lv < 0 ? -lv : lv);
      sign |= (lv < 0 && i + k < n ? 1u : 0u) << k;
    }
    if (vec && full) {
      uint2 packed;
      packed.x = m[0] | (m[1] << 8) | (m[2] << 16) | ((uint32_t)m[3] << 24);
      packed.y = m[4] | (m[5] << 8) | (m[6] << 16) | ((uint32_t)m[7] << 24);
      reinterpret_cast<uint2*>(mags)[j] = packed;
    } else {
      for (int k = 0; k < 8 && i + k < n; ++k) mags[i + k] = m[k];
    }
    signs[j] = static_cast<uint8_t>(sign);
  }
}

int max_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        sms <= 0) {
      sms = 132;
    }
    blocks = sms * 8;
  }
  return blocks;
}

unsigned grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > max_blocks()) blocks = max_blocks();
  return static_cast<unsigned>(blocks);
}

}  // namespace

// Each entry returns the cudaError_t of its launch (0 on success).  inv points
// at one float32 in device memory; out / signs hold ceil(n / 4) / ceil(n / 8)
// bytes, mags n.

extern "C" int tcdp_terngrad_pack(const float* x, long long n, const float* inv,
                                  unsigned long long seed, uint8_t* out, void* stream) {
  if (n <= 0) return 0;
  terngrad_pack_kernel<<<grid_for((n + 3) / 4), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, inv, seed, out);
  return (int)cudaGetLastError();
}

extern "C" int tcdp_qsgd_pack(const float* x, long long n, const float* inv,
                              unsigned long long seed, int qstates, uint8_t* mags, uint8_t* signs,
                              void* stream) {
  if (n <= 0) return 0;
  qsgd_pack_kernel<<<grid_for((n + 7) / 8), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, inv, seed, static_cast<float>(qstates), mags, signs);
  return (int)cudaGetLastError();
}
