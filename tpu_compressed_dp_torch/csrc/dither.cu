// Philox uniforms and the one-pass dither quantizers for
// tpu_compressed_dp_torch/ops/kernels.py.
//
// Replaces three Pallas TPU kernels of tpu_compressed_dp/ops/kernels.py:
//   * _uniform_kernel   -> uniform_kernel:  out[i] = u_i, float32 in [0, 1)
//   * _qsgd_kernel      -> qsgd_kernel:     int16 sign(x) * floor((|x| * inv) * s + u)
//   * _terngrad_kernel  -> terngrad_kernel: int8  sign(x) * (u < |x| * inv)
// u_i is Philox4x32-10 word i % 4 at counter i / 4 under the 64-bit seed
// (philox.cuh), so the stream depends on (seed, i) only, never on the grid,
// and the quantizers draw it in registers: the dither never touches device
// memory, as on the TPU.  The per-element arithmetic (select-form sign,
// saturating conversion, no FMA contraction) is in quant.cuh, shared with the
// quantize+pack kernels.  inv is read from device memory, so the caller never
// syncs the host on the norm.
//
// Bound: bytes 4n (uniform), 6n (qsgd), 5n (terngrad); 7.85 / 11.8 / 9.81 us at
// n = 6,573,120 and 3.35 TB/s.  Philox adds 15 integer operations per element
// (10 rounds of two 32x32->64 multiplies and four xors per 4 words), 2.9 us at
// the SM's issue rate of 33.5 T lane-operations/s: below the bytes, so the
// kernels are memory-bound if the issue keeps up.  Design: one thread per
// counter, so one Philox call feeds four neighbouring elements; a grid-stride loop with
// 16-byte loads of x and 16 / 8 / 4-byte stores where the pointers allow it
// (scalar otherwise, and for the ragged tail, masked by index).

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "quant.cuh"

namespace {

using tcdp::qsgd1;
using tcdp::tern1;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
uniform_kernel(float* __restrict__ out, long long n, unsigned long long seed) {
  const long long nb = (n + 3) >> 2;
  const bool vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < nb; j += stride) {
    const uint4 w = tcdp::philox_block(j, seed);
    const float4 u = make_float4(tcdp::uniform24(w.x), tcdp::uniform24(w.y),
                                 tcdp::uniform24(w.z), tcdp::uniform24(w.w));
    const long long i = j << 2;
    if (vec && i + 3 < n) {
      reinterpret_cast<float4*>(out)[j] = u;
    } else {
      out[i] = u.x;
      if (i + 1 < n) out[i + 1] = u.y;
      if (i + 2 < n) out[i + 2] = u.z;
      if (i + 3 < n) out[i + 3] = u.w;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
qsgd_kernel(const float* __restrict__ x, long long n, const float* __restrict__ inv_ptr,
            unsigned long long seed, float s, short* __restrict__ out) {
  const float inv = __ldg(inv_ptr);
  const long long nb = (n + 3) >> 2;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) & 15) | (reinterpret_cast<uintptr_t>(out) & 7)) == 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < nb; j += stride) {
    const uint4 w = tcdp::philox_block(j, seed);
    const long long i = j << 2;
    if (vec && i + 3 < n) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(x) + j);
      reinterpret_cast<short4*>(out)[j] = make_short4(
          qsgd1(v.x, inv, s, tcdp::uniform24(w.x)), qsgd1(v.y, inv, s, tcdp::uniform24(w.y)),
          qsgd1(v.z, inv, s, tcdp::uniform24(w.z)), qsgd1(v.w, inv, s, tcdp::uniform24(w.w)));
    } else {
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
      for (int k = 0; k < 4 && i + k < n; ++k) {
        out[i + k] = qsgd1(__ldg(x + i + k), inv, s, tcdp::uniform24(ws[k]));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
terngrad_kernel(const float* __restrict__ x, long long n, const float* __restrict__ inv_ptr,
                unsigned long long seed, signed char* __restrict__ out) {
  const float inv = __ldg(inv_ptr);
  const long long nb = (n + 3) >> 2;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) & 15) | (reinterpret_cast<uintptr_t>(out) & 3)) == 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < nb; j += stride) {
    const uint4 w = tcdp::philox_block(j, seed);
    const long long i = j << 2;
    if (vec && i + 3 < n) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(x) + j);
      reinterpret_cast<char4*>(out)[j] = make_char4(
          tern1(v.x, inv, tcdp::uniform24(w.x)), tern1(v.y, inv, tcdp::uniform24(w.y)),
          tern1(v.z, inv, tcdp::uniform24(w.z)), tern1(v.w, inv, tcdp::uniform24(w.w)));
    } else {
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
      for (int k = 0; k < 4 && i + k < n; ++k) {
        out[i + k] = tern1(__ldg(x + i + k), inv, tcdp::uniform24(ws[k]));
      }
    }
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

unsigned grid_for(long long n) {
  const long long work = (n + 3) / 4;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > max_blocks()) blocks = max_blocks();
  return static_cast<unsigned>(blocks);
}

}  // namespace

// Each entry returns the cudaError_t of its launch (0 on success).  inv points
// at one float32 in device memory.

extern "C" int tcdp_uniform(float* out, long long n, unsigned long long seed, void* stream) {
  if (n <= 0) return 0;
  uniform_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(out, n, seed);
  return (int)cudaGetLastError();
}

extern "C" int tcdp_qsgd_levels(const float* x, long long n, const float* inv,
                                unsigned long long seed, int qstates, short* out, void* stream) {
  if (n <= 0) return 0;
  qsgd_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, inv, seed, static_cast<float>(qstates), out);
  return (int)cudaGetLastError();
}

extern "C" int tcdp_terngrad_levels(const float* x, long long n, const float* inv,
                                    unsigned long long seed, signed char* out, void* stream) {
  if (n <= 0) return 0;
  terngrad_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, inv, seed, out);
  return (int)cudaGetLastError();
}
