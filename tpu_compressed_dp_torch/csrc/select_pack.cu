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
// payload rank's segment.  Here one pass over x ranks the survivors across the
// whole tensor with a single-pass prefix scan with decoupled look-back
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA 2016), one block a tile:
//   * a block takes its tile from a counter, not from blockIdx, so every
//     earlier tile is already running or done and the look-back always makes
//     progress;
//   * a block's life is mostly latency (the ticket, the copy, the look-back's
//     round trips to L2), so the rate is the bytes an SM holds in flight.  A
//     thread copies kVecs 16-byte vectors to shared memory by cp.async (in
//     two groups: the first half is counted while the second arrives) and
//     loads kRegVecs more into registers: tensors from kLargeFrom elements
//     take 96 KB tiles (64 KB shared, 32 KB in registers), three blocks an
//     SM; smaller ones 64 KB tiles in shared memory alone, whose shorter life
//     suits a few tiles.  The tiles are laid from the 16-byte boundary at or
//     below x (`shift` elements before x[0]), so a misaligned view such as
//     x[1:] still loads aligned vectors; elements outside [0, n) are masked,
//     and no load leaves an aligned 16-byte chunk that holds an element of x;
//   * ranks inside the tile: each thread's survivor counts of its vectors,
//     packed a byte each, go through one shuffle scan; warp 0 scans the
//     (vector, warp) totals in index order;
//   * look-back (lookback.cuh, shared with threshold_pack.cu): warp 0
//     publishes (AGGREGATE, tile total), reads the status words of its
//     predecessors 32 at a time, adds their counts back to the nearest
//     PREFIX, and publishes (PREFIX, inclusive prefix).
//     The call's epoch, flag and count share one 64-bit word that is stored
//     and loaded whole, and no other data passes between blocks, so relaxed
//     gpu-scope atomics order all that needs ordering.  Ranks come from the
//     scan, not from the schedule: the output does not depend on timing;
//   * a survivor of rank r < keep goes to vals[r], idx[r]; a tile whose
//     exclusive prefix reaches keep writes nothing, and the last tile writes
//     count;
//   * the blocks whose ticket falls past the last tile wait for its prefix
//     and zero the slots [min(count, keep), keep) grid-stride.
//   * state: the status words persist from call to call (the caller keeps
//     one zeroed buffer a stream); a word whose epoch is not the call's reads
//     as unset.  The last block to finish resets the ticket and its own
//     counter and advances the epoch, so the next call on the stream starts
//     clean without a memset.
// A call is one launch.  A predecessor that never publishes is a fault: a
// wait traps after some ten seconds rather than hang the card.  int32 ranks
// and indices: the wrapper refuses n > 2^31 - 1.
//
// Bound: the bytes, 4n read once and 8 keep written (26.82 MB at n =
// 6,573,120 and keep = 65,732: 8.01 us at the 3.35 TB/s of an H100 SXM at its
// 700 W limit); chip_smoke.py times it and PERF.md keeps the numbers.

#include <cuda_runtime.h>

#include <cstdint>

#include "lookback.cuh"

namespace {

using namespace lookback;

// A tile's geometry: kThreads threads, each kVecs vectors in shared memory
// and kRegVecs in registers; kMinBlocks resident blocks an SM cap the
// registers.
template <int kThreads_, int kVecs_, int kRegVecs_, int kMinBlocks_>
struct Tiling {
  static constexpr int kThreads = kThreads_, kVecs = kVecs_, kRegVecs = kRegVecs_;
  static constexpr int kMinBlocks = kMinBlocks_;
  static constexpr int kAll = kVecs + kRegVecs;       // vectors a thread holds
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kTile = kThreads * kAll * 4;   // elements a tile
  static constexpr int kParts = kAll * kWarps;        // (vector, warp) counts, in index order
  static constexpr int kPartsPerLane = (kParts + 31) / 32;
  static constexpr int kPacks = (kAll + 3) / 4;       // words of packed per-vector counts
  static constexpr int kBitWords = (kAll + 7) / 8;    // words of per-vector survivor bits
  static constexpr int kSmem = kThreads * kVecs * 16;
};
using Small = Tiling<512, 8, 0, 3>;
using Large = Tiling<256, 16, 8, 3>;
constexpr long long kLargeFrom = 1 << 23;  // elements from which a tensor takes Large
constexpr int kMaxPadBlocks = 264;           // two a streaming multiprocessor of an H100

template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
select_pack_kernel(const float* __restrict__ x, long long n, int shift, int ntiles,
                   const float* __restrict__ t_ptr, int keep, float* __restrict__ vals,
                   int* __restrict__ idx, int* __restrict__ count,
                   unsigned long long* __restrict__ status, int capacity,
                   unsigned* __restrict__ ctrl) {
  constexpr int kThreads = T::kThreads, kVecs = T::kVecs, kRegVecs = T::kRegVecs;
  constexpr int kAll = T::kAll, kWarps = T::kWarps, kTile = T::kTile, kParts = T::kParts;
  constexpr int kPartsPerLane = T::kPartsPerLane, kPacks = T::kPacks;
  constexpr int kHalf = (kVecs + 1) / 2;  // vectors of the first copy group
  extern __shared__ float4 s_x[];  // the tile's first kThreads * kVecs vectors
  __shared__ int s_tile;
  __shared__ unsigned s_epoch;  // the call's (constant until its last block finishes)
  __shared__ unsigned s_part[kParts];
  __shared__ unsigned s_excl;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) take_ticket(ctrl, &s_tile, &s_epoch);
  __syncthreads();
  const int tile = s_tile;

  if (tile >= ntiles) {  // padding: the slots no survivor fills
    if (threadIdx.x == 0) {
      s_excl = (unsigned)wait_prefix(status + ntiles - 1, s_epoch);
      finish(status, capacity, ctrl, gridDim.x);
    }
    __syncthreads();
    const long long stride = (long long)(gridDim.x - ntiles) * kThreads;
    for (long long s = min((long long)s_excl, (long long)keep) +
                       (long long)(tile - ntiles) * kThreads + threadIdx.x;
         s < keep; s += stride) {
      vals[s] = 0.0f;
      idx[s] = 0;
    }
    return;
  }

  // the tile's element offsets [lo, hi) hold x[base - shift + offset]; each
  // thread copies its vectors q = k kThreads + threadIdx.x and reads back
  // only those, so its own waits are all the order the counts need
  const long long base = (long long)tile * kTile;
  const int lo = tile == 0 ? shift : 0;
  const int hi = (int)min((long long)kTile, n + shift - base);
  const float4* xa =
      reinterpret_cast<const float4*>(reinterpret_cast<uintptr_t>(x) & ~uintptr_t(15)) +
      base / 4;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int q = k * kThreads + threadIdx.x;
    if (4 * q < hi) cp_async16(s_x + q, xa + q);
    if (k == kHalf - 1 || k == kVecs - 1) asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  float4 rv[kRegVecs > 0 ? kRegVecs : 1];  // the rest of the thread's vectors
#pragma unroll
  for (int k = kVecs; k < kAll; ++k) {
    const int q = k * kThreads + threadIdx.x;
    rv[k - kVecs] = 4 * q < hi ? __ldg(xa + q) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const float t = __ldg(t_ptr);

  // bit j of nibble k % 8 of bits[k / 8]: offset 4 (k kThreads +
  // threadIdx.x) + j survives.  Byte k % 4 of packed word k / 4 holds the
  // thread's survivor count of its vector k; one shuffle scan of the packed
  // words gives the lane's offset among the warp's survivors of every vector
  // at once (a byte's sum stays at most 4 x 32)
  unsigned bits[T::kBitWords] = {}, own[kPacks] = {}, offs[kPacks];
  const bool whole = lo == 0 && hi == kTile;
#pragma unroll
  for (int k = 0; k < kAll; ++k) {
    if (k == 0 && kHalf < kVecs) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    if (k == (kHalf < kVecs ? kHalf : 0)) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    const int e = 4 * (k * kThreads + threadIdx.x);
    const float4 v = k < kVecs ? s_x[k * kThreads + threadIdx.x] : rv[k < kVecs ? 0 : k - kVecs];
    const float f[4] = {v.x, v.y, v.z, v.w};
    unsigned b = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b |= fabsf(f[j]) >= t && (whole || (e + j >= lo && e + j < hi)) ? 1u << j : 0u;
    bits[k / 8] |= b << (4 * (k % 8));
    own[k / 4] |= __popc(b) << (8 * (k % 4));
  }
#pragma unroll
  for (int p = 0; p < kPacks; ++p) offs[p] = own[p];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int p = 0; p < kPacks; ++p) {
      const unsigned u = __shfl_up_sync(0xffffffffu, offs[p], off);
      if (lane >= off) offs[p] += u;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < kAll; ++k) s_part[k * kWarps + warp] = offs[k / 4] >> (8 * (k % 4)) & 255u;
  }
#pragma unroll
  for (int p = 0; p < kPacks; ++p) offs[p] -= own[p];
  __syncthreads();

  if (warp == 0) {
    // exclusive scan of the (vector, warp) counts, each lane a run of them;
    // the tile's total goes out at once, then the look-back
    unsigned part[kPartsPerLane], run = 0;
#pragma unroll
    for (int p = 0; p < kPartsPerLane; ++p) {
      const int i = lane * kPartsPerLane + p;
      run += part[p] = i < kParts ? s_part[i] : 0u;
    }
    unsigned incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned u = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += u;
    }
    unsigned e = incl - run;
#pragma unroll
    for (int p = 0; p < kPartsPerLane; ++p) {
      const int i = lane * kPartsPerLane + p;
      if (i < kParts) s_part[i] = e;
      e += part[p];
    }
    const unsigned agg = __shfl_sync(0xffffffffu, incl, 31);
    if (lane == 0)
      store_status(status + tile,
                   (unsigned long long)tag(s_epoch, tile == 0 ? kPrefix : kAggregate) << 32 | agg);
    unsigned back[1] = {0u};
    if (tile > 0) look_back(status, tile, lane, tag(s_epoch, 0), back);
    const unsigned excl = back[0];
    if (lane == 0) {
      if (tile > 0)
        store_status(status + tile, (unsigned long long)tag(s_epoch, kPrefix) << 32 | (excl + agg));
      if (tile == ntiles - 1) *count = (int)(excl + agg);
      s_excl = excl;
    }
  }
  __syncthreads();

  const unsigned excl = s_excl;
  if (excl < (unsigned)keep) {
    const int first = (int)(base - shift);  // x index of offset 0 (-shift in tile 0)
#pragma unroll
    for (int k = 0; k < kAll; ++k) {
      const unsigned b = bits[k / 8] >> (4 * (k % 8)) & 15u;
      if (!b) continue;
      unsigned r = excl + s_part[k * kWarps + warp] + (offs[k / 4] >> (8 * (k % 4)) & 255u);
      const int q = k * kThreads + threadIdx.x;
      const float4 v = k < kVecs ? s_x[q] : rv[k < kVecs ? 0 : k - kVecs];
      for (unsigned m = b; m && r < (unsigned)keep; m &= m - 1, ++r) {
        const int j = __ffs(m) - 1;
        vals[r] = j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
        idx[r] = first + 4 * q + j;
      }
    }
  }
  // after the registers of the tile are free
  if (threadIdx.x == 0) finish(status, capacity, ctrl, gridDim.x);
}

// Tiles of the tiling `T` over n elements laid from `shift` elements before x.
template <class T>
long long tiles(long long n, int shift) {
  return (n + shift + T::kTile - 1) / T::kTile;
}

template <class T>
int launch(const float* x, long long n, int shift, const float* t, int keep, float* vals,
           int* idx, int* count, unsigned long long* state, long long capacity,
           cudaStream_t s) {
  const long long ntiles = tiles<T>(n, shift);
  if (ntiles > capacity) return (int)cudaErrorInvalidValue;
  static int configured = -1;  // the device whose kernel allows kSmem bytes
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && configured != dev) {
    err = cudaFuncSetAttribute(select_pack_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err == cudaSuccess) configured = dev;
  }
  if (err != cudaSuccess) return (int)err;
  const int npad = (int)(keep / T::kTile < kMaxPadBlocks ? keep / T::kTile + 1 : kMaxPadBlocks);
  select_pack_kernel<T><<<(int)ntiles + npad, T::kThreads, T::kSmem, s>>>(
      x, n, shift, (int)ntiles, t, keep, vals, idx, count, state, (int)capacity,
      reinterpret_cast<unsigned*>(state + capacity));
  return (int)cudaGetLastError();
}

}  // namespace

// The int64 words of state a call on n elements needs: a status word a tile
// (at the largest shift) and two words for the ticket, the finished-block
// counter and the epoch.
extern "C" int tcdp_select_pack_state_words(long long n) {
  return (int)(n >= kLargeFrom ? tiles<Large>(n, 3) : tiles<Small>(n, 3)) + 2;
}

// The tile, in elements, of a call on n elements, and the n from which the
// larger tile serves.
extern "C" int tcdp_select_pack_tile(long long n) {
  return n >= kLargeFrom ? Large::kTile : Small::kTile;
}
extern "C" int tcdp_select_pack_large_from() { return (int)kLargeFrom; }

// x: n float32, any 4-byte alignment.  state: `words` int64 words, zeroed
// before the first call and then handed to every call on the same stream,
// which leave it ready for the next (at least tcdp_select_pack_state_words(n)
// words; one buffer must not serve two streams at once).  count: one int32.
// keep >= 1.  Returns the cudaError_t of the launch (0 on success).
extern "C" int tcdp_select_pack(const float* x, long long n, const float* t, int keep,
                                float* vals, int* idx, int* count,
                                unsigned long long* state, long long words, void* stream) {
  if (n <= 0 || keep <= 0) return 0;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  if (addr & 3u) return (int)cudaErrorInvalidValue;
  const int shift = (int)((addr >> 2) & 3u);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return n >= kLargeFrom
             ? launch<Large>(x, n, shift, t, keep, vals, idx, count, state, words - 2, s)
             : launch<Small>(x, n, shift, t, keep, vals, idx, count, state, words - 2, s);
}
