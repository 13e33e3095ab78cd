// Cumulative histogram counts at 17 ascending edges, for the Top-K threshold
// search of tpu_compressed_dp_torch/ops/kernels.py.
//
// Replaces two Pallas TPU kernels of tpu_compressed_dp/ops/kernels.py:
//   * _count_ge_kernel     (one equispaced refinement round), and
//   * _count_edges_kernel  (the sampled-quantile first round).
// Both compute counts[b] = #{i < n : edges[b] <= x[i] < edges[16]} for
// b = 0..15; they differ only in where the edges come from, so the glue
// builds the 17 edges (lo + width*b and hi, or the sample quantiles) with
// fp32 tensor ops and this kernel reads them from device memory.  Computing
// lo + width*b here instead would let nvcc contract it into an FMA, and the
// bin edges would then differ by an ulp from the thresholds the glue narrows
// to, breaking the count(|g| >= t) >= keep guarantee.
//
// Bound: one read of the n fp32 inputs (4n bytes; 9.4 MB at n = 2,359,296,
// ~2.8 us at 3.35 TB/s); 17 compares per element are far below the card's
// fp32 rate.  Design: a grid-stride loop with 16-byte loads (scalar loads for
// a misaligned base and the ragged tail, masked by index, with no padding);
// 16 per-thread int counters in registers; a warp-shuffle then shared-memory
// block reduction; one atomicAdd per bin per block into the int32[16] that
// the caller zeroes.  NaN compares false against every edge, so it never
// counts; counts are exact integers up to 2^31 - 1.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBins = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void tally(float v, const float (&e)[kBins + 1],
                                      int (&c)[kBins]) {
  const int valid = v < e[kBins];
#pragma unroll
  for (int b = 0; b < kBins; ++b) c[b] += valid & (v >= e[b]);
}

__global__ void __launch_bounds__(kThreads)
count_ge_edges_kernel(const float* __restrict__ x, long long n,
                      const float* __restrict__ edges,
                      int* __restrict__ counts) {
  float e[kBins + 1];
#pragma unroll
  for (int b = 0; b <= kBins; ++b) e[b] = __ldg(edges + b);
  int c[kBins];
#pragma unroll
  for (int b = 0; b < kBins; ++b) c[b] = 0;

  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long head = 0;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const long long n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (long long i = tid; i < n4; i += stride) {
      const float4 v = __ldg(x4 + i);
      tally(v.x, e, c);
      tally(v.y, e, c);
      tally(v.z, e, c);
      tally(v.w, e, c);
    }
    head = n4 << 2;
  }
  for (long long i = head + tid; i < n; i += stride) tally(__ldg(x + i), e, c);

  __shared__ int partial[kWarps][kBins];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int b = 0; b < kBins; ++b) {
    int s = c[b];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) partial[warp][b] = s;
  }
  __syncthreads();
  if (threadIdx.x < kBins) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += partial[w][threadIdx.x];
    if (s != 0) atomicAdd(counts + threadIdx.x, s);
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

}  // namespace

// counts must hold 16 zeroed int32 on the device; edges 17 ascending fp32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int tcdp_count_ge_edges(const float* x, long long n, const float* edges,
                                   int* counts, void* stream) {
  if (n <= 0) return 0;
  const long long work = (n + 3) / 4;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > max_blocks()) blocks = max_blocks();
  count_ge_edges_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, edges, counts);
  return (int)cudaGetLastError();
}
