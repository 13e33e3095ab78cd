// Byte packers of given levels for tpu_compressed_dp_torch/ops/kernels.py.
//
// Replace the Pallas TPU kernels _pack2b_kernel (pack_ternary_pallas) and
// _qsgd_pack_levels_kernel (qsgd_pack_pallas) of
// tpu_compressed_dp/ops/kernels.py:1380 and :1385, both run through
// _pack_bytes_call (:1392):
//   * ternary_bytes_kernel: int8 levels -> uint8[ceil(n/4)]; byte j is
//     sum_k (level_{4j+k} + 1) * 4^k over k < 4, taken in int32 and cut to
//     8 bits (the reference sums the codes in float32, exactly, and converts
//     float -> int32 -> uint8); a padded tail counts as level 0 (code 1);
//   * qsgd_bytes_kernel: int16 levels -> uint8 |level| [n] (taken in int32,
//     cut to 8 bits: -32768 -> 0, 256 -> 0) and uint8[ceil(n/8)] sign
//     bitmap, bit k of byte j set iff level_{8j+k} < 0.
// The TPU kernels pack with a matmul against a place-value matrix (the
// vector unit has no byte shifts across lanes).  Here the ternary packer
// makes one output byte a thread, in a grid-stride loop.
//
// The QSGD packer moves 16-byte vectors: a thread packs a run of 32 levels
// with four 16-byte loads, two 16-byte magnitude stores and one 4-byte sign
// word, so a warp instruction moves 512 bytes, not the 32-64 of a byte a
// thread.  The outputs are the wrapper's (aligned); the levels may be a view
// at any element offset H (mod 8) from a 16-byte boundary: a template of the
// kernel for each H loads five aligned vectors from the boundary below the
// run and takes the run H elements in (the first and fifth vectors lie in
// 16-byte blocks that hold elements of the view, so inside its allocation).
// A ragged n's last run is packed by scalars.  One run a thread and as many
// blocks as runs need (no fixed cap of blocks an SM): every resident thread
// has 64 bytes of loads in flight.
//
// Bound: the bytes.  Ternary reads n and writes n / 4 (1.25n: 8.22 MB, 2.45 us
// at n = 6,573,120 at the 3.35 TB/s of an H100 SXM at its 700 W limit); QSGD
// reads 2n and writes n + n / 8 (3.125n: 20.5 MB, 6.13 us; 490.1 / 897.0 us
// at the LM's group sizes, 525,357,056 / 961,544,192).

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

// Elements [32t, 32t + 32) of levels, which starts H int16 past a 16-byte
// boundary: magnitudes as two 16-byte stores, signs as one 32-bit word.
template <int H>
__global__ void __launch_bounds__(kThreads)
qsgd_bytes_kernel(const int16_t* __restrict__ levels, long long n, uint8_t* __restrict__ mags,
                  uint8_t* __restrict__ signs) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long i0 = t << 5;
  if (i0 >= n) return;
  if (i0 + 32 <= n) {
    constexpr int kVecs = H ? 5 : 4;
    const uint4* src = reinterpret_cast<const uint4*>(levels - H) + (t << 2);
    uint32_t w[4 * kVecs];
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const uint4 q = __ldg(src + v);
      w[4 * v] = q.x;
      w[4 * v + 1] = q.y;
      w[4 * v + 2] = q.z;
      w[4 * v + 3] = q.w;
    }
    uint32_t m[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    uint32_t s = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int e = H + j;
      const int l = (int)(int16_t)(w[e >> 1] >> (16 * (e & 1)));
      m[j >> 2] |= ((uint32_t)abs(l) & 0xFFu) << (8 * (j & 3));
      s |= (uint32_t)(l < 0) << j;
    }
    uint4* out = reinterpret_cast<uint4*>(mags + i0);
    out[0] = make_uint4(m[0], m[1], m[2], m[3]);
    out[1] = make_uint4(m[4], m[5], m[6], m[7]);
    reinterpret_cast<uint32_t*>(signs)[t] = s;
    return;
  }
  // the ragged last run
  for (long long j = i0 >> 3; j < ((n + 7) >> 3); ++j) {
    unsigned bits = 0;
    for (int k = 0; k < 8; ++k) {
      const long long i = (j << 3) + k;
      if (i < n) {
        const int l = (int)levels[i];
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

// mags holds n bytes (16-byte aligned), signs ceil(n / 8) (4-byte aligned);
// levels may start at any element.
extern "C" int tcdp_qsgd_pack_bytes(const int16_t* levels, long long n, uint8_t* mags,
                                    uint8_t* signs, void* stream) {
  if (n <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(mags) & 15) || (reinterpret_cast<uintptr_t>(signs) & 3) ||
      (reinterpret_cast<uintptr_t>(levels) & 1))
    return (int)cudaErrorMisalignedAddress;
  const unsigned blocks = (unsigned)((((n + 31) >> 5) + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((reinterpret_cast<uintptr_t>(levels) & 15) >> 1) {
    case 0: qsgd_bytes_kernel<0><<<blocks, kThreads, 0, s>>>(levels, n, mags, signs); break;
    case 1: qsgd_bytes_kernel<1><<<blocks, kThreads, 0, s>>>(levels, n, mags, signs); break;
    case 2: qsgd_bytes_kernel<2><<<blocks, kThreads, 0, s>>>(levels, n, mags, signs); break;
    case 3: qsgd_bytes_kernel<3><<<blocks, kThreads, 0, s>>>(levels, n, mags, signs); break;
    case 4: qsgd_bytes_kernel<4><<<blocks, kThreads, 0, s>>>(levels, n, mags, signs); break;
    case 5: qsgd_bytes_kernel<5><<<blocks, kThreads, 0, s>>>(levels, n, mags, signs); break;
    case 6: qsgd_bytes_kernel<6><<<blocks, kThreads, 0, s>>>(levels, n, mags, signs); break;
    default: qsgd_bytes_kernel<7><<<blocks, kThreads, 0, s>>>(levels, n, mags, signs); break;
  }
  return (int)cudaGetLastError();
}
