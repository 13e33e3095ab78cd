// Per-destination bucket build of the sharded wire transport, for
// tpu_compressed_dp_torch/ops/kernels.py (fused_bucket_route).
//
// Replaces the Pallas TPU kernel _bucket_route_kernel of
// tpu_compressed_dp/ops/kernels.py.  The payload (vals, idx) is ascending in
// idx, so the slots bound for destination w are the contiguous window
// [starts[w], starts[w + 1]) of it (starts is the exclusive prefix of the
// per-destination counts over W + 1 buckets; the last, the dump bucket of an
// invalid tail, belongs to no window).  Row w of the [W, cap] buckets takes
// the first min(count, cap) slots of its window, with the bucket-local index
// idx - w * shard_n; the rest of the row is value 0 and the guard index
// shard_n.  Rows stay monotone (window order is payload order).
//
// The TPU kernel DMAs each window into VMEM at its dynamic start and masks
// the tail there, one grid step per destination.  Here the window copy needs
// no staging: the grid is (ceil(cap / 256), W), one thread per bucket slot,
// reading vals[starts[w] + r] and idx[starts[w] + r] (coalesced: neighbouring
// threads read neighbouring slots of one window) and writing slot (w, r).
// Values are copied as 32-bit words, so a -0.0 stays -0.0 and a NaN keeps its
// payload, as the Pallas window copy does.
//
// Bound: bytes, 8 * (sum_w min(count_w, cap)) read + 8 * W * cap written
// (1.18 MB at full-width entire-model Top-K, W = 4: 0.35 us at 3.35 TB/s),
// far below one launch's latency; the kernel does one compare per slot.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bucket_route_kernel(const uint32_t* __restrict__ vals, const int* __restrict__ idx,
                    const int* __restrict__ starts, int cap, int shard_n,
                    uint32_t* __restrict__ bvals, int* __restrict__ bidx) {
  const int w = blockIdx.y;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= cap) return;
  const int start = __ldg(starts + w);
  const int count = min(__ldg(starts + w + 1) - start, cap);
  const long long o = (long long)w * cap + r;
  if (r < count) {
    bvals[o] = __ldg(vals + start + r);
    bidx[o] = __ldg(idx + start + r) - w * shard_n;
  } else {
    bvals[o] = 0u;  // +0.0f
    bidx[o] = shard_n;
  }
}

}  // namespace

// vals float32[k] (as 32-bit words), idx int32[k] ascending, starts
// int32[world + 1]; bvals float32[world, cap], bidx int32[world, cap].
// Returns the cudaError_t of the launch (0 on success).
extern "C" int tcdp_bucket_route(const void* vals, const int* idx, const int* starts,
                                 int world, int cap, int shard_n, void* bvals, int* bidx,
                                 void* stream) {
  if (world <= 0 || cap <= 0) return 0;
  const dim3 grid((unsigned)((cap + kThreads - 1) / kThreads), (unsigned)world);
  bucket_route_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(vals), idx, starts, cap, shard_n,
      static_cast<uint32_t*>(bvals), bidx);
  return (int)cudaGetLastError();
}
