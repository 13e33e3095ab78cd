// Per-destination bucket build of the sharded wire transport, for
// tpu_compressed_dp_torch/ops/kernels.py (route_buckets, fused_bucket_route).
//
// Replaces the Pallas TPU kernel _bucket_route_kernel of
// tpu_compressed_dp/ops/kernels.py:1613 (fused_bucket_route, :1641).  Row w
// of the [W, cap] buckets takes the first min(count_w, cap) slots of
// destination w's window of the payload, with the bucket-local index
// idx - w * shard_n; the rest of the row is value 0 and the guard index
// shard_n.  route_buckets also writes accepted[k]: slot i went into a bucket.
//
// Precondition: the destinations are ascending over the payload.  dest_i is
// min(idx_i / shard_n, W - 1) over the valid prefix and the dump destination
// W after it (or given, for fused_bucket_route); idx ascends over the valid
// prefix, and valid is a prefix.  Then destination w's slots are the window
// [starts[w], starts[w + 1]) with starts[w] the first i with dest_i >= w,
// and accepted_i = i < starts[dest_i] + min(count, cap), an interval a row.
// The TPU kernel takes starts from a count in XLA and DMAs each window into
// VMEM, one grid step a destination.
//
// One launch a route, nothing else: the windows are found on the card.
//   * Each block serves one row w.  Warps 0 and 1 find starts[w] and
//     starts[w + 1] by a 32-ary lower-bound search over dest (derived from
//     idx and valid at each probe, so the dump tail, whose idx is not
//     ascending, never enters a search over idx): ceil(log32 k) dependent
//     loads, 4 at k = 65,732, 5 at 9.6 M.  Every block of the row repeats
//     them from L2 rather than paying a second launch.  (A 1024-ary search
//     of the whole block, 2 and 3 rounds, ran slower: 45 against 41 us at
//     the LM's 5.25 M slots; its probes' L2 traffic and divisions cost more
//     than the rounds it saved.  Two probes a lane read no faster.)
//   * The copy: a warp stages 2 x 128 bucket slots in shared memory through
//     coalesced 4-byte loads (a window starts anywhere), then each lane
//     stores 4 consecutive slots as one 16-byte vector where the flat offset
//     w * cap + r is a multiple of 4, and as scalars in the groups a row
//     shares with its neighbour (cap not a multiple of 4).  Values move as
//     32-bit words, so a -0.0 and a NaN's payload survive.  (16-byte loads
//     realigned across lanes by shuffles, 4 chunks in flight, fewer or more
//     blocks, an occupancy cap and streaming cache hints all read the same
//     or slower at the LM's sizes: the copy runs at the rate DRAM gives this
//     read/write mix, ~2.6 TB/s, as the one-slot-a-thread design before it.)
//   * accepted: the row's blocks also write accepted over the row's window
//     [starts[w], starts[w + 1]) (the last row: to k, the dump tail), 16
//     bytes a store, scalars at the window's edges.  The two index spaces
//     (W * cap bucket slots, k payload slots) share the row's two starts.
//   * The grid: W rows x enough blocks a row for the larger of its bucket
//     chunks and its share of accepted, capped at one wave of resident
//     blocks; the blocks of a row stride over its chunks.
//
// Bound: bytes.  8 * sum_w min(count_w, cap) read (the accepted windows'
// values and indices), 8 * W * cap written, k bytes of accepted written; the
// searches' probes are a few hundred words.  At 3.35 TB/s: 0.373 us at
// full-width entire-model Top-K (k = 65,732, W = 2, cap 41,083), below one
// launch; 29.8 / 54.5 us at the LM's groups at W = 2 and 4 (k = 5,253,571 /
// 9,615,442).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;  // bucket slots a warp stages at once: 32 lanes x 4
constexpr int kUnroll = 2;   // chunks a warp has in flight
constexpr unsigned kFull = 0xffffffffu;

// dest_i: given, or derived from idx and the valid prefix
struct Keys {
  const int* dest;
  const int* idx;
  const uint8_t* valid;
  int world, shard_n;
  __device__ __forceinline__ int operator()(long long i) const {
    if (dest != nullptr) return __ldg(dest + i);
    const int d = __ldg(idx + i) / shard_n;
    const bool v = valid == nullptr || __ldg(valid + i) != 0;
    return v ? min(d, world - 1) : world;
  }
};

// The first i in [0, k) with key(i) >= w (k if none), keys ascending; one
// warp, 32 probes a round.
__device__ long long warp_lower_bound(const Keys& key, long long k, int w) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = k;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const long long step = (hi - lo + 31) >> 5;
    const long long p = lo + lane * step;
    const unsigned b = __ballot_sync(kFull, p >= hi || key(p) >= w);
    if (b & 1u) return lo;  // key(lo) >= w
    const int f = b ? __ffs(b) - 1 : 32;  // the first probe at or past the answer
    const long long nlo = lo + (f - 1) * step + 1;
    if (f < 32) hi = min(lo + f * step, hi);
    lo = nlo;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
route_kernel(const uint32_t* __restrict__ vals, Keys key, int k, int cap, int bpr,
             uint32_t* __restrict__ bvals, int* __restrict__ bidx,
             uint8_t* __restrict__ accepted) {
  __shared__ long long s_start[2];
  __shared__ __align__(16) uint32_t s_v[kWarps][kUnroll * kChunk];
  __shared__ __align__(16) int s_i[kWarps][kUnroll * kChunk];
  const int w = blockIdx.x / bpr, b = blockIdx.x % bpr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int world = key.world;
  if (warp < 2) {
    const int target = w + warp;
    long long s;
    if (target == 0)
      s = 0;
    else if (target == world && key.dest == nullptr && key.valid == nullptr)
      s = k;  // every slot valid: no dump tail
    else
      s = warp_lower_bound(key, k, target);
    if (lane == 0) s_start[warp] = s;
  }
  __syncthreads();
  const long long start = s_start[0], next = s_start[1];
  const long long cnt = min(next - start, (long long)cap);
  const int local_off = w * key.shard_n;

  // the row's buckets: flat slots [row0, row0 + cap), 4-slot groups [q0, q1)
  const long long row0 = (long long)w * cap, row1 = row0 + cap;
  const long long q0 = row0 >> 2, q1 = (row1 + 3) >> 2;
  const long long nchunks = (q1 - q0 + 31) >> 5;
  const long long stride = (long long)bpr * kWarps * kUnroll;
  for (long long c = ((long long)b * kWarps + warp) * kUnroll; c < nchunks; c += stride) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int e = u * kChunk + m * 32 + lane;
        const long long r = ((q0 + (c + u) * 32) << 2) + m * 32 + lane - row0;
        uint32_t v = 0u;  // +0.0f
        int ix = key.shard_n;
        if (r >= 0 && r < cnt) {
          v = __ldg(vals + start + r);
          ix = __ldg(key.idx + start + r) - local_off;
        }
        s_v[warp][e] = v;
        s_i[warp][e] = ix;
      }
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long g = q0 + (c + u) * 32 + lane;
      if (g < q1) {
        const long long o = g << 2;
        const uint4 v4 = *reinterpret_cast<const uint4*>(&s_v[warp][u * kChunk + lane * 4]);
        const int4 i4 = *reinterpret_cast<const int4*>(&s_i[warp][u * kChunk + lane * 4]);
        if (o >= row0 && o + 4 <= row1) {
          *reinterpret_cast<uint4*>(bvals + o) = v4;
          *reinterpret_cast<int4*>(bidx + o) = i4;
        } else {  // a group this row shares with its neighbour
          const uint32_t vv[4] = {v4.x, v4.y, v4.z, v4.w};
          const int ii[4] = {i4.x, i4.y, i4.z, i4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (o + j >= row0 && o + j < row1) {
              bvals[o + j] = vv[j];
              bidx[o + j] = ii[j];
            }
          }
        }
      }
    }
    __syncwarp();
  }

  if (accepted == nullptr) return;
  // accepted over the row's window [a0, a1): 1 below start + cnt
  const long long a0 = start, a1 = w == world - 1 ? (long long)k : next, lim = start + cnt;
  if (a1 <= a0) return;
  const long long g1 = (a1 + 15) >> 4;
  for (long long g = (a0 >> 4) + (long long)b * kThreads + threadIdx.x; g < g1;
       g += (long long)bpr * kThreads) {
    const long long i0 = g << 4;
    if (i0 >= a0 && i0 + 16 <= a1) {
      uint32_t wd[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t x = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t) x |= (uint32_t)(i0 + 4 * j + t < lim) << (8 * t);
        wd[j] = x;
      }
      *reinterpret_cast<uint4*>(accepted + i0) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    } else {  // the window's edges
      for (int t = 0; t < 16; ++t) {
        const long long i = i0 + t;
        if (i >= a0 && i < a1) accepted[i] = (uint8_t)(i < lim);
      }
    }
  }
}

int resident_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, route_kernel, kThreads, 0);
    blocks = sms * per_sm > 0 ? sms * per_sm : 132;
  }
  return blocks;
}

}  // namespace

// vals float32[k] (as 32-bit words), idx int32[k]; dest int32[k] (ascending,
// W past the valid prefix) or null, then valid uint8[k] (a prefix) or null;
// bvals float32[world, cap], bidx int32[world, cap] (16-byte aligned);
// accepted uint8[k] (16-byte aligned) or null.  One launch.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int tcdp_route_buckets(const void* vals, const int* idx, const int* dest,
                                  const uint8_t* valid, int k, int world, int cap, int shard_n,
                                  void* bvals, int* bidx, uint8_t* accepted, void* stream) {
  if (world <= 0 || cap <= 0 || shard_n <= 0 || k < 0) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(bvals) | reinterpret_cast<uintptr_t>(bidx) |
       reinterpret_cast<uintptr_t>(accepted)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const long long chunks = (((long long)cap + 7) / 4 + 31) / 32;
  const long long for_copy = (chunks + kWarps * kUnroll - 1) / (kWarps * kUnroll);
  const long long for_acc = accepted ? ((long long)k / world / 16 + kThreads - 1) / kThreads : 1;
  long long bpr = for_copy > for_acc ? for_copy : for_acc;
  const long long most = resident_blocks() / world;
  bpr = bpr < most ? bpr : (most > 0 ? most : 1);
  if (bpr < 1) bpr = 1;
  Keys key{dest, idx, valid, world, shard_n};
  route_kernel<<<(unsigned)(bpr * world), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(vals), key, k, cap, (int)bpr,
      static_cast<uint32_t*>(bvals), bidx, accepted);
  return (int)cudaGetLastError();
}
