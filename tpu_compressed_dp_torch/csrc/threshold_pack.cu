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
// a log2(4096)-round shift network (the segmented pack).  Here both are one
// launch that reads x once, as select_pack.cu does:
//   * a block holds a tile in shared memory, copied by cp.async (16-byte
//     copies, or 4-byte ones where x is a view off a 16-byte boundary), and
//     in registers, and ranks its survivors in index order: each thread's
//     survivor counts of its vectors, packed a byte each, go through one
//     shuffle scan, and warp 0 scans the (vector, warp) parts, each 128
//     consecutive elements.  Values are copied, never summed.
//     (On NaN / Inf data and -0.0 survivors the TPU threshold pack's sums
//     change payload values; a copy keeps the bits, and the plain PyTorch
//     version copies too);
//   * the tiles of a call take their numbers from a ticket and carry their
//     prefixes to each other by the decoupled look-back of lookback.cuh;
//   * the segmented pack's tile is 4 segments (64 KB in shared memory,
//     three blocks an SM).  A segment's payload row is
//     fixed at seg * 128, so a tile writes vals, idx, counts and elig
//     without waiting; only the EF needs the exclusive prefix of elig, which
//     the tile's look-back gives (one status word: the elig total);
//   * whole-block truncation needs a source block's total count before any
//     of its survivors is placed, so the threshold pack's unit of work holds
//     whole source blocks: a cluster of 2 blocks (65,536 elements, one block
//     of the reference's 512 rows, or several whole smaller blocks; each
//     block 96 KB in shared memory and 32 KB in registers, so that 132
//     units, 8.65 M elements, fit on the card at once) totals its counts
//     over distributed shared memory; the cluster's leader looks
//     back for the row base and the survivor count before the unit (two
//     status words), decides which of the unit's source blocks ship and
//     writes meta where it is decided; each block then places its half's
//     survivors from the tile and writes the EF.  For rows > 512 a
//     source block spans several units: a count pre-pass (a second launch,
//     which reads x twice) gives each unit its source block's total and
//     the survivors before it, and the same kernel places them;
//   * the slots past the last row any source block uses are zeroed by
//     clusters whose ticket falls past the last unit, once its prefix is
//     published.
// int32 ranks and indices: the wrapper refuses n > 2^31 - 1.
//
// Bound: the bytes.  Threshold pack: 4n read, 4n EF written, 8P payload
// written (53.2 MB at n = 6,573,120, keep = 65,732, rows 512: 15.9 us at the
// 3.35 TB/s of an H100 SXM at its 700 W limit).  Segmented pack: 4n read,
// 4n EF, 8 * 128 * nseg payload (54.2 MB at that n: 16.2 us).  chip_smoke.py
// times both; PERF.md keeps the numbers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "lookback.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace lookback;

// A block's tile: kThreads threads, each kVecs vectors of 4 elements in
// shared memory and kRegVecs in registers; kMinBlocks resident blocks an SM
// cap the registers.  Vector q = k kThreads + threadIdx.x holds elements
// [4 q, 4 q + 4), so part p = k kWarps + warp (a warp's vector k) holds the
// 128 elements [128 p, 128 p + 128): the parts run in index order.
template <int kThreads_, int kVecs_, int kRegVecs_, int kMinBlocks_>
struct Tiling {
  static constexpr int kThreads = kThreads_, kVecs = kVecs_, kRegVecs = kRegVecs_;
  static constexpr int kMinBlocks = kMinBlocks_;
  static constexpr int kAll = kVecs + kRegVecs;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kTile = kThreads * kAll * 4;   // elements a block
  static constexpr int kParts = kAll * kWarps;
  static constexpr int kPartsPerLane = kParts / 32;
  static constexpr int kPacks = (kAll + 3) / 4;       // words of per-vector counts, a byte each
  static constexpr int kBitWords = (kAll + 7) / 8;    // words of per-vector survivor bits
  static constexpr int kSmem = kThreads * kVecs * 16;
  static_assert(kParts % 32 == 0, "warp 0 scans whole runs of parts");
};
// the segmented pack: 4 segments a block, 64 KB in shared memory, three
// blocks an SM
using SegTiling = Tiling<512, 8, 0, 3>;
// the threshold pack: 32,768 elements a block, 96 KB in shared memory and 16
// registers a thread, two blocks an SM; a cluster of two blocks a unit
using PackTiling = Tiling<512, 12, 4, 2>;

constexpr int kLanes = 128;
constexpr int kSeg = 4096;
constexpr int kSegCap = 128;
constexpr int kSegsPerTile = SegTiling::kTile / kSeg;
constexpr int kPartsPerSeg = kSeg / kLanes;
constexpr int kUnit = 65536;                              // elements a cluster
constexpr int kCluster = kUnit / PackTiling::kTile;
constexpr int kMaxLocal = kUnit / kLanes;                 // source blocks a unit (rows 1)
constexpr int kMaxOwn = PackTiling::kTile / kLanes + 1;   // source blocks meeting a block's part
constexpr int kMaxPadClusters = 66;
static_assert(SegTiling::kThreads == kSegsPerTile * kSegCap, "a thread a payload slot");

__device__ __forceinline__ unsigned rows_of(unsigned c) { return (c + kLanes - 1) / kLanes; }

// A thread's share of a tile past the copy to shared memory: its register
// vectors, its survivor bits (bit j of nibble k % 8 of bits[k / 8]: element
// 4 (k kThreads + threadIdx.x) + j survives) and, in byte k % 4 of
// offs[k / 4], the survivors of the lanes below it in its warp's vector k.
template <class T>
struct Held {
  float4 rv[T::kRegVecs > 0 ? T::kRegVecs : 1];
  unsigned bits[T::kBitWords];
  unsigned offs[T::kPacks];
};

template <class T>
__device__ __forceinline__ float4 vec(const float4* s_x, const Held<T>& h, int k) {
  return k < T::kVecs ? s_x[k * T::kThreads + threadIdx.x] : h.rv[k < T::kVecs ? 0 : k - T::kVecs];
}

template <class T>
__device__ __forceinline__ unsigned bits_of(const Held<T>& h, int k) {
  return h.bits[k / 8] >> (4 * (k % 8)) & 15u;
}

// x[start, start + len) to the tile: the first kVecs vectors of each thread
// to s_x by cp.async, the rest to registers.  `aligned`: x is 16-byte
// aligned (and start a multiple of 4); otherwise 4-byte copies.
template <class T>
__device__ __forceinline__ void load_tile(float4* s_x, Held<T>& h, const float* x,
                                          long long start, int len, bool aligned) {
#pragma unroll
  for (int k = 0; k < T::kAll; ++k) {
    const int q = k * T::kThreads + threadIdx.x;
    if (aligned) {
      // a ragged last vector reads past x[n - 1] inside its aligned 16 bytes
      const float4* src = reinterpret_cast<const float4*>(x + start) + q;
      if (k < T::kVecs) {
        if (4 * q < len) cp_async16(s_x + q, src);
      } else {
        h.rv[k - T::kVecs] = 4 * q < len ? __ldg(src) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    } else {
      float f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k < T::kVecs) {
          if (4 * q + j < len) cp_async4(reinterpret_cast<float*>(s_x + q) + j, x + start + 4 * q + j);
        } else {
          f[j] = 4 * q + j < len ? __ldg(x + start + 4 * q + j) : 0.0f;
        }
      }
      if (k >= T::kVecs) h.rv[k - T::kVecs] = make_float4(f[0], f[1], f[2], f[3]);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The survivors of the tile's first len elements (every thread reads back
// only the vectors it copied): h.bits and h.offs as Held says;
// s_part[p] ends as the survivors of the tile before part p,
// s_part[kParts] as the tile's total.  Every thread of the block calls it
// (it synchronises).
template <class T>
__device__ __forceinline__ void scan_tile(const float4* s_x, Held<T>& h, float t, int len,
                                          unsigned* s_part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned own[T::kPacks];
#pragma unroll
  for (int p = 0; p < T::kPacks; ++p) own[p] = 0;
#pragma unroll
  for (int w = 0; w < T::kBitWords; ++w) h.bits[w] = 0;
#pragma unroll
  for (int k = 0; k < T::kAll; ++k) {
    // the vector's elements below len
    const int valid = len - 4 * (k * T::kThreads + (int)threadIdx.x);
    const float4 v = vec(s_x, h, k);
    const float f[4] = {v.x, v.y, v.z, v.w};
    unsigned b = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) b |= fabsf(f[j]) >= t ? 1u << j : 0u;
    b &= valid >= 4 ? 15u : valid > 0 ? (1u << valid) - 1u : 0u;
    h.bits[k / 8] |= b << (4 * (k % 8));
    own[k / 4] |= __popc(b) << (8 * (k % 4));
  }
#pragma unroll
  for (int p = 0; p < T::kPacks; ++p) h.offs[p] = own[p];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int p = 0; p < T::kPacks; ++p) {
      const unsigned u = __shfl_up_sync(0xffffffffu, h.offs[p], off);
      if (lane >= off) h.offs[p] += u;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < T::kAll; ++k)
      s_part[k * T::kWarps + warp] = h.offs[k / 4] >> (8 * (k % 4)) & 255u;
  }
#pragma unroll
  for (int p = 0; p < T::kPacks; ++p) h.offs[p] -= own[p];
  __syncthreads();
  if (warp == 0) {
    unsigned part[T::kPartsPerLane], run = 0;
#pragma unroll
    for (int p = 0; p < T::kPartsPerLane; ++p) run += part[p] = s_part[lane * T::kPartsPerLane + p];
    unsigned incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned u = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += u;
    }
    unsigned e = incl - run;
#pragma unroll
    for (int p = 0; p < T::kPartsPerLane; ++p) {
      s_part[lane * T::kPartsPerLane + p] = e;
      e += part[p];
    }
    if (lane == 31) s_part[T::kParts] = incl;
  }
  __syncthreads();
}

// The tile rank of the first survivor of the thread's vector k.
template <class T>
__device__ __forceinline__ unsigned first_rank(const unsigned* s_part, const Held<T>& h, int k) {
  return s_part[k * T::kWarps + (threadIdx.x >> 5)] + (h.offs[k / 4] >> (8 * (k % 4)) & 255u);
}

// ef[i0, i0 + min(valid, 4)) = v, with element j +0.0 where bit j of zero is
// set (ef + i0 16-byte aligned).
__device__ __forceinline__ void store_ef(float* ef, long long i0, float4 v, unsigned zero,
                                         int valid) {
  if (zero & 1u) v.x = 0.0f;
  if (zero & 2u) v.y = 0.0f;
  if (zero & 4u) v.z = 0.0f;
  if (zero & 8u) v.w = 0.0f;
  if (valid >= 4) {
    *reinterpret_cast<float4*>(ef + i0) = v;
    return;
  }
  const float f[3] = {v.x, v.y, v.z};
  for (int j = 0; j < valid; ++j) ef[i0 + j] = f[j];
}

// Segmented pack: tile `tile` holds segments [4 tile, 4 tile + 4).
__global__ void __launch_bounds__(SegTiling::kThreads, SegTiling::kMinBlocks)
seg_pack_kernel(const float* __restrict__ x, long long n, bool aligned,
                const float* __restrict__ t_ptr, int keep, int nseg, float* __restrict__ vals,
                int* __restrict__ idx, float* __restrict__ ef, int* __restrict__ counts,
                int* __restrict__ elig, int* __restrict__ starts,
                unsigned long long* __restrict__ status, long long capacity,
                unsigned* __restrict__ ctrl) {
  using T = SegTiling;
  extern __shared__ float4 s_x[];
  __shared__ int s_tile;
  __shared__ unsigned s_epoch;
  __shared__ unsigned s_part[T::kParts + 1];
  __shared__ unsigned s_start[kSegsPerTile];  // each segment's start: the elig prefix
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) take_ticket(ctrl, &s_tile, &s_epoch);
  __syncthreads();
  const int tile = s_tile;
  const long long start = (long long)tile * T::kTile;
  const int len = (int)max(0ll, min((long long)T::kTile, n - start));
  Held<T> h;
  load_tile(s_x, h, x, start, len, aligned);
  scan_tile(s_x, h, __ldg(t_ptr), len, s_part);

  unsigned agg = 0;
  if (warp == 0) {  // the tile's elig total goes out at once
    const unsigned c = lane < kSegsPerTile
                           ? s_part[(lane + 1) * kPartsPerSeg] - s_part[lane * kPartsPerSeg]
                           : 0u;
    const unsigned e = min(c, (unsigned)kSegCap);
    unsigned incl = e;
#pragma unroll
    for (int off = 1; off < kSegsPerTile; off <<= 1) {
      const unsigned u = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += u;
    }
    agg = __shfl_sync(0xffffffffu, incl, kSegsPerTile - 1);
    if (lane < kSegsPerTile) s_start[lane] = incl - e;
    if (lane == 0) {
      const unsigned v[1] = {agg};
      publish(status, tile, s_epoch, tile == 0 ? kPrefix : kAggregate, v);
    }
  }
  // the payload rows, counts and elig need no other tile
  const long long seg0 = (long long)tile * kSegsPerTile;
  {
    const int g = threadIdx.x / kSegCap, s = threadIdx.x % kSegCap;
    const unsigned c = s_part[(g + 1) * kPartsPerSeg] - s_part[g * kPartsPerSeg];
    if (seg0 + g < nseg) {
      if ((unsigned)s >= c) {
        vals[(seg0 + g) * kSegCap + s] = 0.0f;
        idx[(seg0 + g) * kSegCap + s] = 0;
      }
      if (s == 0) {
        counts[seg0 + g] = (int)c;
        elig[seg0 + g] = (int)min(c, (unsigned)kSegCap);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < T::kAll; ++k) {
    const unsigned b = bits_of(h, k);
    if (!b) continue;
    const int g = k * T::kThreads * 4 / kSeg;  // the segment of the vector
    unsigned r = first_rank(s_part, h, k) - s_part[g * kPartsPerSeg];
    const int q = k * T::kThreads + threadIdx.x;
    const float4 v = vec(s_x, h, k);
    for (unsigned m = b; m && r < (unsigned)kSegCap; m &= m - 1, ++r) {
      const int j = __ffs(m) - 1;
      vals[(seg0 + g) * kSegCap + r] = j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
      idx[(seg0 + g) * kSegCap + r] = (int)(start + 4 * q + j);
    }
  }
  if (warp == 0) {
    unsigned back[1] = {0u};
    if (tile > 0) look_back(status, tile, lane, tag(s_epoch, 0), back);
    if (lane == 0 && tile > 0) {
      const unsigned v[1] = {back[0] + agg};
      publish(status, tile, s_epoch, kPrefix, v);
    }
    if (lane < kSegsPerTile) {
      s_start[lane] += back[0];
      if (seg0 + lane < nseg) starts[seg0 + lane] = (int)s_start[lane];
    }
  }
  __syncthreads();

  if (ef != nullptr) {
#pragma unroll
    for (int k = 0; k < T::kAll; ++k) {
      const int q = k * T::kThreads + threadIdx.x;
      if (4 * q >= len) break;
      const unsigned b = bits_of(h, k);
      unsigned zero = 0;
      if (b) {
        const int g = k * T::kThreads * 4 / kSeg;
        unsigned r = first_rank(s_part, h, k) - s_part[g * kPartsPerSeg];
        const long long st = s_start[g];
        for (unsigned m = b; m && r < (unsigned)kSegCap; m &= m - 1, ++r)
          if (st + r + 1 <= keep) zero |= m & (~m + 1);
      }
      store_ef(ef, start + 4 * q, vec(s_x, h, k), zero, len - 4 * q);
    }
  }
  if (threadIdx.x == 0) finish(status, capacity, ctrl, gridDim.x);
}

// The threshold pack's units.  Mode A (per >= 1): unit u holds the `per`
// whole source blocks from u * per.  Mode B (per == 0, a source block longer
// than a unit): unit u is chunk u % chunks of source block u / chunks, each
// chunk kUnit elements from the block's start, the last one shorter.
struct Geometry {
  long long n;
  long long len;    // elements a source block: rows * 128
  int per;          // source blocks a unit (mode A), 0 in mode B
  int chunks;       // units a source block (mode B), 1 in mode A
  int nb;           // source blocks
  int nunits;
  int cap_rows;
};

struct Unit {
  long long start;  // x index of the unit's first element
  int len;          // its elements
  int nloc;         // source blocks it meets
  int chunk;        // mode B: its chunk in the source block
  bool closes;      // whether a source block ends in it
};

__device__ __forceinline__ Unit unit_of(const Geometry& g, int u) {
  Unit r;
  long long cap;
  if (g.per > 0) {
    const int lo = u * g.per;
    r.nloc = min(g.per, g.nb - lo);
    r.start = lo * g.len;
    r.chunk = 0;
    r.closes = true;
    cap = (long long)r.nloc * g.len;
  } else {
    r.chunk = u % g.chunks;
    r.start = (long long)(u / g.chunks) * g.len + (long long)r.chunk * kUnit;
    r.nloc = 1;
    r.closes = r.chunk == g.chunks - 1;
    cap = min((long long)kUnit, g.len - (long long)r.chunk * kUnit);
  }
  r.len = (int)max(0ll, min(cap, g.n - r.start));
  return r;
}

// Mode B's pre-pass: the survivors of each unit, one state word each (its
// high half 0, so it never reads as a status word of any call).
__global__ void __launch_bounds__(256)
count_units_kernel(const float* __restrict__ x, const float* __restrict__ t_ptr, Geometry geo,
                   unsigned long long* __restrict__ cnt) {
  const Unit u = unit_of(geo, blockIdx.x);
  const float t = __ldg(t_ptr);
  int c = 0;
  for (int i = threadIdx.x; i < u.len; i += 256) c += fabsf(__ldg(x + u.start + i)) >= t ? 1 : 0;
  c = __reduce_add_sync(0xffffffffu, c);
  __shared__ int partial[8];
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += partial[w];
    cnt[blockIdx.x] = (unsigned)s;
  }
}

// Threshold pack: a cluster of kCluster blocks a unit, block q of the
// cluster its elements [q kTile, (q + 1) kTile).
__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(PackTiling::kThreads, PackTiling::kMinBlocks)
threshold_pack_kernel(const float* __restrict__ x, bool aligned, const float* __restrict__ t_ptr,
                      Geometry geo, float* __restrict__ vals, int* __restrict__ idx,
                      float* __restrict__ ef, int* __restrict__ meta,
                      const unsigned long long* __restrict__ pre,
                      unsigned long long* __restrict__ status,
                      long long capacity, unsigned* __restrict__ ctrl) {
  using T = PackTiling;
  extern __shared__ float4 s_x[];
  __shared__ int s_tile;
  __shared__ unsigned s_epoch;
  __shared__ unsigned s_part[T::kParts + 1];
  // the leader's: each block's survivor total, then its offset in the unit
  __shared__ unsigned s_tot[kCluster];
  // the leader's, per source block i the unit meets: the survivors of the
  // unit before its start (mode B: minus those of the block before the
  // unit), s_from[nloc] the unit's total; its base row
  __shared__ int s_from[kMaxLocal + 1];
  __shared__ unsigned s_base[kMaxLocal];
  // this block's copy for the source blocks that meet its half
  __shared__ int l_from[kMaxOwn + 1];
  __shared__ unsigned l_base[kMaxOwn];

  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool leader = q == 0;
  const unsigned participants = gridDim.x / kCluster;
  const long long slots = (long long)geo.cap_rows * kLanes;
  if (leader && threadIdx.x == 0) take_ticket(ctrl, &s_tile, &s_epoch);
  cluster.sync();
  const int tile = *cluster.map_shared_rank(&s_tile, 0);
  unsigned* lead_tot = cluster.map_shared_rank(s_tot, 0);

  if (tile >= geo.nunits) {  // padding: the slots past the last row any block uses
    if (leader && threadIdx.x == 0)
      s_tot[0] = (unsigned)wait_prefix(status + 2ll * (geo.nunits - 1), s_epoch);
    cluster.sync();
    const long long first = (long long)*lead_tot * kLanes;
    cluster.sync();  // the leader's shared memory is read
    const long long stride = (long long)(participants - geo.nunits) * kCluster * T::kThreads;
    for (long long s = first + ((long long)(tile - geo.nunits) * kCluster + q) * T::kThreads +
                       threadIdx.x;
         s < slots; s += stride) {
      vals[s] = 0.0f;
      idx[s] = 0;
    }
    if (leader && threadIdx.x == 0) finish(status, capacity, ctrl, participants);
    return;
  }

  const Unit u = unit_of(geo, tile);
  const int qstart = q * T::kTile;
  const int len = max(0, min(T::kTile, u.len - qstart));
  Held<T> h;
  load_tile(s_x, h, x, u.start + qstart, len, aligned);
  scan_tile(s_x, h, __ldg(t_ptr), len, s_part);
  int* lead_from = cluster.map_shared_rank(s_from, 0);
  if (warp == 0) {
    if (lane == 0) lead_tot[q] = s_part[T::kParts];
    if (geo.per > 0) {  // the block's rank at each source block start in its half
      for (long long i = (qstart + geo.len - 1) / geo.len + lane;
           i < u.nloc && i * geo.len < qstart + T::kTile; i += 32)
        lead_from[i] = (int)s_part[(i * geo.len - qstart) / kLanes];
    }
  }
  cluster.sync();

  if (leader && warp == 0) {
    unsigned unit_total = 0;
    if (lane == 0) {  // the blocks' totals become their offsets in the unit
#pragma unroll
      for (int b = 0; b < kCluster; ++b) {
        const unsigned c = s_tot[b];
        s_tot[b] = unit_total;
        unit_total += c;
      }
    }
    unit_total = __shfl_sync(0xffffffffu, unit_total, 0);
    __syncwarp();
    if (geo.per > 0) {
      for (int i = lane; i < u.nloc; i += 32) s_from[i] += (int)s_tot[i * geo.len / T::kTile];
      if (lane == 0) s_from[u.nloc] = (int)unit_total;
    } else {  // the source block's chunks, counted by the pre-pass
      const long long blk0 = (long long)(tile - u.chunk);
      unsigned before = 0, all = 0;
      for (int j = lane; j < geo.chunks; j += 32) {
        const unsigned c = (unsigned)__ldg(pre + blk0 + j);  // the low half
        all += c;
        before += j < u.chunk ? c : 0u;
      }
      before = __reduce_add_sync(0xffffffffu, before);
      all = __reduce_add_sync(0xffffffffu, all);
      if (lane == 0) {
        s_from[0] = -(int)before;
        s_from[1] = (int)(all - before);
      }
    }
    __syncwarp();
    // the unit's rows: each lane a run of its source blocks
    const int run_len = (u.nloc + 31) / 32;
    const int i0 = min(u.nloc, lane * run_len), i1 = min(u.nloc, i0 + run_len);
    unsigned run = 0;
    for (int i = i0; i < i1; ++i) run += rows_of((unsigned)(s_from[i + 1] - s_from[i]));
    unsigned incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    // mode B: a block's rows count in the unit that closes it
    const unsigned rows_total = __shfl_sync(0xffffffffu, incl, 31);
    const unsigned agg[2] = {u.closes ? rows_total : 0u, unit_total};
    if (lane == 0) publish(status, tile, s_epoch, tile == 0 ? kPrefix : kAggregate, agg);
    unsigned back[2] = {0u, 0u};
    if (tile > 0) look_back(status, tile, lane, tag(s_epoch, 0), back);
    if (lane == 0 && tile > 0) {
      const unsigned inc[2] = {back[0] + agg[0], back[1] + agg[1]};
      publish(status, tile, s_epoch, kPrefix, inc);
    }
    const unsigned cap = (unsigned)geo.cap_rows;
    unsigned base = back[0] + incl - run;
    for (int i = i0; i < i1; ++i) {
      const unsigned r = rows_of((unsigned)(s_from[i + 1] - s_from[i]));
      s_base[i] = base;
      // the first source block that does not ship decides the meta
      if (u.closes && base <= cap && base + r > cap) {
        meta[0] = (int)(back[1] + (unsigned)s_from[i]);
        meta[2] = (int)base;
      }
      base += r;
    }
    if (lane == 0 && tile == geo.nunits - 1) {
      meta[1] = (int)(back[1] + agg[1]);
      if (back[0] + agg[0] <= cap) {  // every block ships
        meta[0] = (int)(back[1] + agg[1]);
        meta[2] = (int)(back[0] + agg[0]);
      }
    }
  }
  cluster.sync();

  // the source blocks [ilo, ihi] meet the block's half
  const int ilo = geo.per > 0 ? (int)(qstart / geo.len) : 0;
  const int ihi = geo.per > 0 ? (int)min((long long)u.nloc - 1, (qstart + T::kTile - 1) / geo.len)
                              : 0;
  const int own = (int)threadIdx.x;
  if (own <= ihi - ilo + 1) {
    l_from[own] = lead_from[ilo + own];
    if (own <= ihi - ilo) l_base[own] = cluster.map_shared_rank(s_base, 0)[ilo + own];
  }
  const long long offset = *cluster.map_shared_rank(&s_tot[q], 0);
  cluster.sync();  // the leader's shared memory is read

  const unsigned cap = (unsigned)geo.cap_rows;
#pragma unroll
  for (int k = 0; k < T::kAll; ++k) {
    const int qv = k * T::kThreads + threadIdx.x;
    if (4 * qv >= len) break;
    const int e = qstart + 4 * qv;  // the vector's offset in the unit
    const int i = (geo.per > 0 ? (int)(e / geo.len) : 0) - ilo;
    const long long from = l_from[i];
    const unsigned c = (unsigned)(l_from[i + 1] - l_from[i]), base = l_base[i];
    const bool shipped = base + rows_of(c) <= cap;
    const unsigned b = bits_of(h, k);
    const float4 v = vec(s_x, h, k);
    if (b && shipped) {
      long long slot = (long long)base * kLanes + offset + first_rank(s_part, h, k) - from;
      for (unsigned m = b; m; m &= m - 1, ++slot) {
        const int j = __ffs(m) - 1;
        vals[slot] = j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
        idx[slot] = (int)(u.start + e + j);
      }
    }
    if (ef != nullptr) store_ef(ef, u.start + e, v, shipped ? b : 0u, len - 4 * qv);
  }
  // the slots of the source blocks that start in the half (mode B: of the
  // block the unit closes) no survivor fills: the last row's unfilled lanes
  // of a shipped block, all its rows below the payload's end if not shipped
  for (int i = ilo; i <= ihi; ++i) {
    if (geo.per > 0 ? i * geo.len < qstart : !(u.closes && leader)) continue;
    const unsigned c = (unsigned)(l_from[i - ilo + 1] - l_from[i - ilo]);
    const unsigned base = l_base[i - ilo], r = rows_of(c);
    const bool shipped = base + r <= cap;
    const long long z0 = (long long)base * kLanes + (shipped ? c : 0u);
    const long long z1 = min((long long)(base + r) * kLanes, slots);
    for (long long s = z0 + threadIdx.x; s < z1; s += T::kThreads) {
      vals[s] = 0.0f;
      idx[s] = 0;
    }
  }
  if (leader && threadIdx.x == 0) finish(status, capacity, ctrl, participants);
}

Geometry geometry(long long n, int rows, int cap_rows) {
  Geometry g;
  g.n = n;
  g.len = (long long)rows * kLanes;
  g.nb = (int)(((n > 1 ? n : 1) + g.len - 1) / g.len);
  g.per = (int)(kUnit / g.len);
  g.cap_rows = cap_rows;
  if (g.per > 0) {
    g.chunks = 1;
    g.nunits = (g.nb + g.per - 1) / g.per;
  } else {
    const long long span = g.len < (n > 1 ? n : 1) ? g.len : (n > 1 ? n : 1);
    g.chunks = (int)((span + kUnit - 1) / kUnit);
    g.nunits = g.nb * g.chunks;
  }
  return g;
}

// The state's words for mode B's unit counts.
long long count_words(const Geometry& g) { return g.per > 0 ? 0 : g.nunits; }

// Lets `kernel` take `bytes` of dynamic shared memory on the current device
// (once a device).
template <class K>
cudaError_t allow_smem(K kernel, int bytes, int* configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && *configured != dev) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) *configured = dev;
  }
  return err;
}

}  // namespace

// The int64 words of state a threshold pack of n elements at `rows` needs:
// two status words a unit, mode B's unit counts, and the two control words.
extern "C" int tcdp_threshold_pack_state_words(long long n, int rows) {
  if (n < 0 || rows <= 0) return 2;
  const Geometry g = geometry(n, rows, 0);
  return (int)(2ll * g.nunits + count_words(g) + 2);
}

// The int64 words of state a segmented pack of nseg segments needs.
extern "C" int tcdp_seg_pack_state_words(int nseg) {
  return (nseg > 0 ? (nseg + kSegsPerTile - 1) / kSegsPerTile : 0) + 2;
}

// x: n float32, 4-byte aligned; vals and idx hold cap_rows * 128 slots; ef
// n floats, 16-byte aligned, or null; meta 3 int32.  state: `words` int64
// words, zeroed before the first call and then handed to every call on the
// same stream, which leave it ready for the next (at least
// tcdp_threshold_pack_state_words(n, rows); one buffer must not serve two
// streams at once).  Returns the cudaError_t of the launches (0 on
// success).
extern "C" int tcdp_threshold_pack(const float* x, long long n, const float* t, int rows,
                                   int cap_rows, float* vals, int* idx, float* ef, int* meta,
                                   unsigned long long* state, long long words, void* stream) {
  if (n < 0 || rows <= 0 || cap_rows < 0) return (int)cudaErrorInvalidValue;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  if ((addr & 3u) || (reinterpret_cast<uintptr_t>(ef) & 15u)) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(n, rows, cap_rows);
  const long long capacity = words - 2;
  if (2ll * g.nunits + count_words(g) > capacity) return (int)cudaErrorInvalidValue;
  static int configured = -1;
  cudaError_t err = allow_smem(threshold_pack_kernel, PackTiling::kSmem, &configured);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* pre = nullptr;
  if (g.per == 0) {
    pre = state + 2ll * g.nunits;
    count_units_kernel<<<g.nunits, 256, 0, s>>>(x, t, g, pre);
  }
  const long long pad = (long long)cap_rows * kLanes / kUnit + 1;
  const int npad = (int)(pad < kMaxPadClusters ? pad : kMaxPadClusters);
  threshold_pack_kernel<<<(g.nunits + npad) * kCluster, PackTiling::kThreads, PackTiling::kSmem,
                          s>>>(
      x, (addr & 15u) == 0, t, g, vals, idx, ef, meta, pre, state, capacity,
      reinterpret_cast<unsigned*>(state + capacity));
  return (int)cudaGetLastError();
}

// vals and idx hold nseg * 128 slots (nseg >= ceil(n / 4096)); ef n floats,
// 16-byte aligned, or null; counts, elig and starts nseg int32 each; state
// as for the threshold pack, at least tcdp_seg_pack_state_words(nseg).
extern "C" int tcdp_seg_pack(const float* x, long long n, const float* t, int keep, int nseg,
                             float* vals, int* idx, float* ef, int* counts, int* elig,
                             int* starts, unsigned long long* state, long long words,
                             void* stream) {
  if (n < 0 || nseg <= 0 || (long long)nseg * kSeg < n) return (int)cudaErrorInvalidValue;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  if ((addr & 3u) || (reinterpret_cast<uintptr_t>(ef) & 15u)) return (int)cudaErrorInvalidValue;
  const int ntiles = (nseg + kSegsPerTile - 1) / kSegsPerTile;
  const long long capacity = words - 2;
  if (ntiles > capacity) return (int)cudaErrorInvalidValue;
  static int configured = -1;
  cudaError_t err = allow_smem(seg_pack_kernel, SegTiling::kSmem, &configured);
  if (err != cudaSuccess) return (int)err;
  seg_pack_kernel<<<ntiles, SegTiling::kThreads, SegTiling::kSmem,
                    static_cast<cudaStream_t>(stream)>>>(
      x, n, (addr & 15u) == 0, t, keep, nseg, vals, idx, ef, counts, elig, starts, state,
      capacity, reinterpret_cast<unsigned*>(state + capacity));
  return (int)cudaGetLastError();
}
