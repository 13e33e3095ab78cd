// Single-pass decoupled look-back (Merrill & Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back", NVIDIA 2016) for the one-pass
// kernels of tpu_compressed_dp_torch/csrc: select_pack.cu and
// threshold_pack.cu.
//
// A call's tiles take their numbers from a ticket, not from blockIdx, so
// every earlier tile is already running or done and a look-back always makes
// progress.  Each tile publishes its aggregate, then its inclusive prefix, in
// W status words, one for each 32-bit quantity it carries (select_pack: the
// survivor count; the threshold pack: the row base and the survivor count).
// A status word holds the count in bits 0-31, the flag in 32-33 (0 unset,
// 1 AGGREGATE, 2 PREFIX) and the call's epoch in 34-63, stored and loaded
// whole by relaxed gpu-scope accesses; a word whose epoch is not the call's
// reads as unset.  A tile's W words are read as one value once all carry the
// same flag: each word's count belongs to its flag, so equal flags give the
// aggregates or the prefixes of one tile, never a mix.  No other data passes
// between tiles, so the relaxed accesses order all that needs ordering.
//
// The state is one buffer of int64 words a (device, stream), zeroed once:
// the status words from its start, and its last two words hold the ticket,
// the finished-block counter and the epoch (three uint32).  The last block of
// a call to finish clears the ticket and the counter and advances the epoch,
// so the next call on the stream starts clean without a memset.  A wait
// that outlasts kWaitLimit clock cycles (~10 s) traps rather than hang the
// card: a predecessor that never publishes is a fault.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace lookback {

constexpr unsigned kAggregate = 1, kPrefix = 2, kEpochMask = (1u << 30) - 1;
constexpr long long kWaitLimit = 20000000000ll;         // clock cycles: ~10 s
constexpr unsigned kSleepMinNs = 16, kSleepMaxNs = 256;  // back-off of a waiting warp

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The high word of a status word with `flag` in the call of `epoch`.
__device__ __forceinline__ unsigned tag(unsigned epoch, unsigned flag) {
  return (epoch & kEpochMask) << 2 | flag;
}

// The flag of status word `w` in the call whose tags start at `base` =
// tag(epoch, 0): kAggregate or kPrefix, any other value if the word is unset
// or of another call.
__device__ __forceinline__ unsigned flag(unsigned long long w, unsigned base) {
  return (unsigned)(w >> 32) - base;
}

// One thread: the call's ticket and epoch (the epoch stays constant until
// the call's last block finishes).
__device__ __forceinline__ void take_ticket(unsigned* ctrl, int* tile, unsigned* epoch) {
  *tile = (int)atomicAdd(ctrl, 1u);
  *epoch = *reinterpret_cast<volatile unsigned*>(ctrl + 2);
}

// One thread: tile `tile`'s W words, flagged `flg`.
template <int W>
__device__ __forceinline__ void publish(unsigned long long* status, int tile, unsigned epoch,
                                        unsigned flg, const unsigned (&v)[W]) {
#pragma unroll
  for (int k = 0; k < W; ++k)
    store_status(status + (long long)tile * W + k,
                 (unsigned long long)tag(epoch, flg) << 32 | v[k]);
}

// One thread: the status word at `word` once it holds a PREFIX of this call.
__device__ unsigned long long wait_prefix(const unsigned long long* word, unsigned epoch) {
  unsigned long long w = load_status(word);
  const long long t0 = clock64();
  while ((unsigned)(w >> 32) != tag(epoch, kPrefix)) {
    __nanosleep(256);
    if (clock64() - t0 > kWaitLimit) __trap();
    w = load_status(word);
  }
  return w;
}

// Whether the W words of a tile read as one value: all set, one flag.
template <int W>
__device__ __forceinline__ bool settled(const unsigned long long (&w)[W], unsigned base) {
  bool ok = flag(w[0], base) - 1 < 2u;
#pragma unroll
  for (int k = 1; k < W; ++k) ok = ok && flag(w[k], base) == flag(w[0], base);
  return ok;
}

// One warp: the exclusive prefix of `tile` > 0 in excl[W].  Each step reads
// the status words of the 32 tiles below `last`, lane 31 the nearest (a tile
// below 0 reads as an empty PREFIX), waits until every lane's tile is settled,
// and adds the counts from the nearest PREFIX up; without a PREFIX it adds
// all 32 and moves one window down.  One register (`base` = tag(epoch, 0))
// carries the epoch through the loop: select_pack's Large tiling has none to
// spare.
template <int W>
__device__ void look_back(const unsigned long long* status, int tile, int lane, unsigned base,
                          unsigned (&excl)[W]) {
#pragma unroll
  for (int k = 0; k < W; ++k) excl[k] = 0;
  for (int last = tile - 1;; last -= 32) {
    const int p = last - 31 + lane;
    unsigned long long w[W];
#pragma unroll
    for (int k = 0; k < W; ++k)
      w[k] = p < 0 ? (unsigned long long)(base + kPrefix) << 32
                   : load_status(status + (long long)p * W + k);
    if (!__all_sync(0xffffffffu, settled(w, base))) {
      const long long t0 = clock64();
      unsigned ns = kSleepMinNs;
      do {
        __nanosleep(ns);
        ns = min(2 * ns, kSleepMaxNs);
        if (clock64() - t0 > kWaitLimit) __trap();
        if (!settled(w, base)) {
#pragma unroll
          for (int k = 0; k < W; ++k) w[k] = load_status(status + (long long)p * W + k);
        }
      } while (!__all_sync(0xffffffffu, settled(w, base)));
    }
    const unsigned prefixes = __ballot_sync(0xffffffffu, flag(w[0], base) == kPrefix);
    const int stop = prefixes ? 31 - __clz(prefixes) : 0;
#pragma unroll
    for (int k = 0; k < W; ++k)
      excl[k] += __reduce_add_sync(0xffffffffu, lane >= stop ? (unsigned)w[k] : 0u);
    if (prefixes) return;
  }
}

// One thread, once its block (or, for `participants` < gridDim.x, its
// cluster) is done with the state: the last of the call's `participants` to
// get here clears the ticket and the counter and advances the epoch (on its
// wrap it clears the `capacity` status words, so no stale word can match).
__device__ void finish(unsigned long long* status, long long capacity, unsigned* ctrl,
                       unsigned participants) {
  if (atomicAdd(ctrl + 1, 1u) != participants - 1) return;
  const unsigned epoch = ctrl[2] + 1;
  if ((epoch & kEpochMask) == 0)
    for (long long i = 0; i < capacity; ++i) status[i] = 0;
  ctrl[0] = 0;
  ctrl[1] = 0;
  ctrl[2] = epoch;
}

__device__ __forceinline__ void cp_async16(const void* smem, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(const void* smem, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(src)
               : "memory");
}

}  // namespace lookback
