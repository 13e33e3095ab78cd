// Fused wire-mode select+pack for tpu_compressed_dp_torch/ops/kernels.py.
//
// Replaces the Pallas TPU kernel _select_pack_kernel and its epilogue
// _select_pack_payload (fused_select_pack) of tpu_compressed_dp/ops/kernels.py.
// Given x[n] float32 and a threshold t read from device memory, it writes the
// coordinates with |x| >= t in ascending index order into exactly `keep`
// slots: vals[keep] float32 and idx[keep] int32, slots past the survivor count
// padded with 0 / 0, plus count = the total number of survivors (int32).
// |x| >= t is the fp32 compare of the plain version: no rounding is involved.
//
// The TPU kernel left-compacts each 4096-element segment with a shift network
// (its vector unit has no cross-lane ballot), then an epilogue finds each
// payload rank's segment.  Here three launches on the caller's stream:
//   1. count_kernel, one block per 4096-element segment: survivors per
//      segment (a per-thread count, a warp shuffle, a sum over the 8 warps);
//   2. scan_kernel, one block: exclusive prefix of the nseg segment counts
//      (each thread scans a run of segments, the runs' sums are scanned in
//      shared memory), and the total into count;
//   3. scatter_kernel, one block per segment: the segment again in 16 rounds
//      of 256 elements; inside a warp __ballot_sync + __popc give each
//      survivor its rank, a scan over the 8 warps' totals places the warps;
//      a survivor whose global rank r is below keep goes to slot r.  A block
//      whose segment starts at or past keep returns at once, and every block
//      first zeroes its share of the slots [min(count, keep), keep).
// int32 ranks and indices: the wrapper refuses n > 2^31 - 1.
//
// Bound: the bytes, 4n read once and 8 keep written (26.82 MB at n =
// 6,573,120 and keep = 65,732: 8.01 us at the 3.35 TB/s of an H100 SXM at its
// 700 W limit).  This design reads x twice (8n) in three launches, so it
// reaches well under half of that (chip_smoke.py times it; PERF.md keeps the
// numbers); a one-pass decoupled look-back scan is the later step.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 4096;
constexpr int kRounds = kSeg / kThreads;
constexpr int kScanThreads = 1024;

__global__ void __launch_bounds__(kThreads)
count_kernel(const float* __restrict__ x, long long n, const float* __restrict__ t_ptr,
             int* __restrict__ seg_counts) {
  const float t = __ldg(t_ptr);
  const long long base = (long long)blockIdx.x * kSeg + threadIdx.x;
  int c = 0;
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const long long i = base + k * kThreads;
    c += (i < n && fabsf(__ldg(x + i)) >= t) ? 1 : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
  __shared__ int partial[kWarps];
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += partial[w];
    seg_counts[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ seg_counts, int nseg, int* __restrict__ seg_start,
            int* __restrict__ count) {
  const int per = (nseg + kScanThreads - 1) / kScanThreads;
  const int lo = min(nseg, (int)threadIdx.x * per);
  const int hi = min(nseg, lo + per);
  int run = 0;
  for (int s = lo; s < hi; ++s) run += seg_counts[s];
  // inclusive scan of the runs' sums: within each warp by shuffles, then
  // over the 32 warp totals
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  __shared__ int warp_sum[kScanThreads / 32];
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += v;
    }
    warp_sum[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  int start = incl - run + (warp > 0 ? warp_sum[warp - 1] : 0);
  for (int s = lo; s < hi; ++s) {
    seg_start[s] = start;
    start += seg_counts[s];
  }
  if (threadIdx.x == kScanThreads - 1) *count = warp_sum[kScanThreads / 32 - 1];
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const float* __restrict__ x, long long n, const float* __restrict__ t_ptr,
               int keep, const int* __restrict__ seg_start, const int* __restrict__ count,
               float* __restrict__ vals, int* __restrict__ idx) {
  // padding: the slots no survivor fills
  const int filled = min(__ldg(count), keep);
  for (long long s = filled + (long long)blockIdx.x * kThreads + threadIdx.x; s < keep;
       s += (long long)gridDim.x * kThreads) {
    vals[s] = 0.0f;
    idx[s] = 0;
  }
  int running = __ldg(seg_start + blockIdx.x);
  if (running >= keep) return;
  const float t = __ldg(t_ptr);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  __shared__ int warp_count[kWarps];
  const long long base = (long long)blockIdx.x * kSeg + threadIdx.x;
  for (int k = 0; k < kRounds; ++k) {
    const long long i = base + k * kThreads;
    const float v = i < n ? __ldg(x + i) : 0.0f;
    const bool m = i < n && fabsf(v) >= t;
    const unsigned ballot = __ballot_sync(0xffffffffu, m);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_count[w];
      before += w < warp ? c : 0;
      total += c;
    }
    const int r = running + before + __popc(ballot & lanes_below);
    if (m && r < keep) {
      vals[r] = v;
      idx[r] = (int)i;
    }
    running += total;
    if (running >= keep) return;  // the same value in every thread
    __syncthreads();               // warp_count is rewritten next round
  }
}

}  // namespace

// seg_counts and seg_start hold ceil(n / 4096) int32 each (scratch); count one
// int32.  keep >= 1.  Returns the cudaError_t of the launches (0 on success).
extern "C" int tcdp_select_pack(const float* x, long long n, const float* t, int keep,
                                float* vals, int* idx, int* count, int* seg_counts,
                                int* seg_start, void* stream) {
  if (n <= 0 || keep <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nseg = (int)((n + kSeg - 1) / kSeg);
  count_kernel<<<nseg, kThreads, 0, s>>>(x, n, t, seg_counts);
  scan_kernel<<<1, kScanThreads, 0, s>>>(seg_counts, nseg, seg_start, count);
  scatter_kernel<<<nseg, kThreads, 0, s>>>(x, n, t, keep, seg_start, count, vals, idx);
  return (int)cudaGetLastError();
}
