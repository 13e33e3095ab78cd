// Threshold pack and segmented pack for tpu_compressed_dp_torch/ops/kernels.py.
//
// Replaces two Pallas TPU kernels of tpu_compressed_dp/ops/kernels.py:
//
//   * _pack_kernel (pack_by_threshold): the coordinates with |x| >= t, in
//     ascending order inside each block of rows x 128 elements (rows = 512
//     in the reference), written from the block's base row on; the bases
//     advance by ceil(block count / 128) rows; a block ships only if
//     base + its rows <= cap_rows (whole-block truncation, sticky because the
//     bases always advance); every slot not holding a shipped survivor is
//     0 / index 0; the EF residual is x except +0.0 at shipped survivors;
//     meta = (survivors shipped, survivors seen, rows up to the end of the
//     last shipped block).
//   * _seg_pack_kernel (seg_pack_by_threshold): per 4096-element segment
//     the first <= 128 survivors, left-compacted, with their global indices
//     (slots past the segment's count 0 / 0); counts = survivors per
//     segment, elig = min(counts, 128), starts = the exclusive prefix of
//     elig; the EF residual is +0.0 at the survivors that travel (rank < 128
//     in the segment and starts + rank + 1 <= keep), x elsewhere.
//
// The TPU kernels compact with what a vector unit without cross-lane
// ballots has: one-hot sums and triangular matmuls (the threshold pack) and
// a log2(4096)-round shift network (the segmented pack).  Here every block
// ranks its survivors directly: each of 1024 threads loads 4 consecutive
// elements, counts its survivors, and a block-wide exclusive scan (warp
// shuffles, then the 32 warp totals) gives each survivor its rank, so the
// value is copied, never summed.  (On NaN / Inf data and -0.0 survivors the
// TPU threshold pack's sums change payload values; a copy keeps the bits,
// and the plain PyTorch version copies too.)  Three launches on the
// caller's stream for each: per-block (per-segment) survivor counts; a
// one-block scan; the pack.  int32 ranks and indices: the wrapper refuses
// n > 2^31 - 1.
//
// Bound: the bytes.  Threshold pack: 4n read, 4n EF written, 8P payload
// written (53.2 MB at n = 6,573,120, keep = 65,732, rows 512: 15.9 us at the
// 3.35 TB/s of an H100 SXM at its 700 W limit).  Segmented pack: 4n read,
// 4n EF, 8 * 128 * nseg payload (54.2 MB at that n: 16.2 us).  This design
// reads x twice (the counts, then the pack) in three launches, and the pack
// launch serialises each block's rounds on one SM (chip_smoke.py times it;
// PERF.md keeps the numbers).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;  // pack launches: 4 consecutive elements a thread
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;
constexpr int kRound = kThreads * kPer;  // elements a block ranks per round
constexpr int kCountThreads = 256;
constexpr int kLanes = 128;
constexpr int kSeg = 4096;
constexpr int kSegCap = 128;
static_assert(kRound == kSeg, "one round of the pack covers one segment");
static_assert(kWarps == 32, "the scan's second level is one warp");

// Exclusive prefix over the block of every thread's v, and the block total
// in *total.  Every thread of the block calls it (it synchronises).
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += u;
    }
    warp_sum[lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  const int excl = incl - v + (warp > 0 ? warp_sum[warp - 1] : 0);
  *total = warp_sum[kWarps - 1];
  __syncthreads();  // warp_sum is rewritten by the next call
  return excl;
}

__device__ __forceinline__ int block_max(int v) {
  __shared__ int warp_max[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  int m = warp_max[lane];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  __syncthreads();
  return m;
}

// Survivors of [b * len, min(n, (b + 1) * len)) for block b.
__global__ void __launch_bounds__(kCountThreads)
count_kernel(const float* __restrict__ x, long long n, const float* __restrict__ t_ptr,
             long long len, int* __restrict__ counts) {
  const float t = __ldg(t_ptr);
  const long long start = (long long)blockIdx.x * len;
  const long long end = min(n, start + len);
  int c = 0;
  for (long long i = start + threadIdx.x; i < end; i += kCountThreads)
    c += fabsf(__ldg(x + i)) >= t ? 1 : 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
  __shared__ int partial[kCountThreads / 32];
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kCountThreads / 32; ++w) s += partial[w];
    counts[blockIdx.x] = s;
  }
}

// Threshold pack, one block: each block's base row, and meta.
__global__ void __launch_bounds__(kThreads)
pack_scan_kernel(const int* __restrict__ blk_counts, int nb, int cap_rows,
                 int* __restrict__ blk_base, int* __restrict__ meta) {
  const int per = (nb + kThreads - 1) / kThreads;
  const int lo = min(nb, (int)threadIdx.x * per);
  const int hi = min(nb, lo + per);
  int run = 0;
  for (int b = lo; b < hi; ++b) run += (blk_counts[b] + kLanes - 1) / kLanes;
  int total;
  int base = block_exclusive_scan(run, &total);
  int shipped = 0, seen = 0, valid_rows = 0;
  for (int b = lo; b < hi; ++b) {
    const int c = blk_counts[b], rows = (c + kLanes - 1) / kLanes;
    blk_base[b] = base;
    if ((long long)base + rows <= cap_rows) {
      shipped += c;
      valid_rows = base + rows;
    }
    seen += c;
    base += rows;
  }
  int shipped_total, seen_total;
  block_exclusive_scan(shipped, &shipped_total);
  block_exclusive_scan(seen, &seen_total);
  valid_rows = block_max(valid_rows);
  if (threadIdx.x == 0) {
    meta[0] = shipped_total;
    meta[1] = seen_total;
    meta[2] = valid_rows;
  }
}

// Threshold pack: block b ranks the survivors of source block b.
__global__ void __launch_bounds__(kThreads)
pack_kernel(const float* __restrict__ x, long long n, const float* __restrict__ t_ptr,
            long long len, int cap_rows, const int* __restrict__ blk_counts,
            const int* __restrict__ blk_base, const int* __restrict__ meta,
            float* __restrict__ vals, int* __restrict__ idx, float* __restrict__ ef) {
  const long long slots = (long long)cap_rows * kLanes;
  // the slots past the last shipped block's rows (every block a share)
  for (long long s = (long long)__ldg(meta + 2) * kLanes + (long long)blockIdx.x * kThreads +
                     threadIdx.x;
       s < slots; s += (long long)gridDim.x * kThreads) {
    vals[s] = 0.0f;
    idx[s] = 0;
  }
  const int c = __ldg(blk_counts + blockIdx.x), rows = (c + kLanes - 1) / kLanes;
  const long long base = (long long)__ldg(blk_base + blockIdx.x) * kLanes;
  const bool shipped = base / kLanes + rows <= cap_rows;
  if (!shipped && ef == nullptr) return;  // the same in every thread
  if (shipped) {
    // the unfilled lanes of the block's last row
    for (int s = c + threadIdx.x; s < rows * kLanes; s += kThreads) {
      vals[base + s] = 0.0f;
      idx[base + s] = 0;
    }
  }
  const float t = __ldg(t_ptr);
  const long long start = (long long)blockIdx.x * len;
  const long long end = min(n, start + len);
  int running = 0;
  for (long long off = start; off < end; off += kRound) {
    const long long i0 = off + (long long)threadIdx.x * kPer;
    float v[kPer];
    bool m[kPer];
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const bool in = i0 + k < end;
      v[k] = in ? __ldg(x + i0 + k) : 0.0f;
      m[k] = in && fabsf(v[k]) >= t;
      cnt += m[k] ? 1 : 0;
    }
    int total;
    int r = running + block_exclusive_scan(cnt, &total);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (i0 + k >= end) break;
      if (m[k]) {
        if (shipped) {
          vals[base + r] = v[k];
          idx[base + r] = (int)(i0 + k);
        }
        ++r;
      }
      if (ef != nullptr) ef[i0 + k] = (m[k] && shipped) ? 0.0f : v[k];
    }
    running += total;
  }
}

// Segmented pack, one block: elig = min(counts, 128) and its exclusive
// prefix.
__global__ void __launch_bounds__(kThreads)
seg_scan_kernel(const int* __restrict__ counts, int nseg, int* __restrict__ elig,
                int* __restrict__ starts) {
  const int per = (nseg + kThreads - 1) / kThreads;
  const int lo = min(nseg, (int)threadIdx.x * per);
  const int hi = min(nseg, lo + per);
  int run = 0;
  for (int s = lo; s < hi; ++s) run += min(counts[s], kSegCap);
  int total;
  int start = block_exclusive_scan(run, &total);
  for (int s = lo; s < hi; ++s) {
    const int e = min(counts[s], kSegCap);
    elig[s] = e;
    starts[s] = start;
    start += e;
  }
}

// Segmented pack: block s ranks the survivors of segment s in one round.
__global__ void __launch_bounds__(kThreads)
seg_pack_kernel(const float* __restrict__ x, long long n, const float* __restrict__ t_ptr,
                int keep, const int* __restrict__ counts, const int* __restrict__ starts,
                float* __restrict__ vals, int* __restrict__ idx, float* __restrict__ ef) {
  const long long seg = blockIdx.x;
  const int live = min(__ldg(counts + seg), kSegCap);
  if (threadIdx.x >= live && threadIdx.x < kSegCap) {
    vals[seg * kSegCap + threadIdx.x] = 0.0f;
    idx[seg * kSegCap + threadIdx.x] = 0;
  }
  const long long start = seg * kSeg;
  if (start >= n) return;  // a padding segment: the same in every thread
  const float t = __ldg(t_ptr);
  const long long i0 = start + (long long)threadIdx.x * kPer;
  float v[kPer];
  bool m[kPer];
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const bool in = i0 + k < n;
    v[k] = in ? __ldg(x + i0 + k) : 0.0f;
    m[k] = in && fabsf(v[k]) >= t;
    cnt += m[k] ? 1 : 0;
  }
  int total;
  int r = block_exclusive_scan(cnt, &total);  // 0-based rank in the segment
  const long long seg_start = __ldg(starts + seg);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (i0 + k >= n) break;
    bool sent = false;
    if (m[k]) {
      if (r < kSegCap) {
        vals[seg * kSegCap + r] = v[k];
        idx[seg * kSegCap + r] = (int)(i0 + k);
        sent = seg_start + r + 1 <= keep;
      }
      ++r;
    }
    if (ef != nullptr) ef[i0 + k] = sent ? 0.0f : v[k];
  }
}

}  // namespace

// vals and idx hold cap_rows * 128 slots; ef n floats or null; meta 3 int32;
// blk_counts and blk_base ceil(max(n, 1) / (rows * 128)) int32 each
// (scratch).  Returns the cudaError_t of the launches (0 on success).
extern "C" int tcdp_threshold_pack(const float* x, long long n, const float* t, int rows,
                                   int cap_rows, float* vals, int* idx, float* ef, int* meta,
                                   int* blk_counts, int* blk_base, void* stream) {
  if (n < 0 || rows <= 0 || cap_rows < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long len = (long long)rows * kLanes;
  const int nb = (int)(((n > 1 ? n : 1) + len - 1) / len);
  count_kernel<<<nb, kCountThreads, 0, s>>>(x, n, t, len, blk_counts);
  pack_scan_kernel<<<1, kThreads, 0, s>>>(blk_counts, nb, cap_rows, blk_base, meta);
  pack_kernel<<<nb, kThreads, 0, s>>>(x, n, t, len, cap_rows, blk_counts, blk_base, meta, vals,
                                      idx, ef);
  return (int)cudaGetLastError();
}

// vals and idx hold nseg * 128 slots (nseg >= ceil(n / 4096)); ef n floats or
// null; counts, elig and starts nseg int32 each.
extern "C" int tcdp_seg_pack(const float* x, long long n, const float* t, int keep, int nseg,
                             float* vals, int* idx, float* ef, int* counts, int* elig,
                             int* starts, void* stream) {
  if (n < 0 || nseg <= 0 || (long long)nseg * kSeg < n) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  count_kernel<<<nseg, kCountThreads, 0, s>>>(x, n, t, kSeg, counts);
  seg_scan_kernel<<<1, kThreads, 0, s>>>(counts, nseg, elig, starts);
  seg_pack_kernel<<<nseg, kThreads, 0, s>>>(x, n, t, keep, counts, starts, vals, idx, ef);
  return (int)cudaGetLastError();
}
