// One round of the histogram Top-K threshold search of
// tpu_compressed_dp_torch/ops/kernels.py, counts and narrowing together.
//
// Replaces two Pallas TPU kernels of tpu_compressed_dp/ops/kernels.py and
// the `narrow` step that follows each of them in `_topk_threshold_pallas`:
//   * _count_ge_kernel     (an equispaced refinement round), and
//   * _count_edges_kernel  (the sampled-quantile first round).
// A round counts counts[b] = #{i : e[b] <= x[i] < e[16]} for b = 0..15 and
// then narrows [lo, hi) to the bin holding the keep-th magnitude, all on the
// device: the search's state (lo, hi, above, the int32 counts, a ticket, the
// candidate buffer's length and flags; layout in the enum below, mirrored by
// kernels.py's _ST_* constants) lives in a small int32 tensor that each
// launch reads and the last block to finish rewrites.  The host launches the
// rounds back to back and never reads the state, as the JAX reference runs
// them inside one jitted fori_loop.
//
// Edges.  The sampled round reads its 17 edges (the sample quantiles) from
// device memory; a refinement round builds them from the state's lo and hi
// as lo + width * b with width = (hi - lo) / 16 and e[16] = hi, each step
// rounded on its own (__fsub_rn, __fdiv_rn, __fmul_rn, __fadd_rn): a
// contracted FMA would move an edge by an ulp off the threshold the search
// narrows to, and the count(|g| >= t) >= keep guarantee would break.
//
// Epilogue (the last block, found by __threadfence and an atomic ticket):
// total[b] = above + (float)counts[b]; b = #(total >= keep_f) - 1 clamped to
// [0, 15]; the new lo, hi and above in the same float32 op order as the
// glue's _narrow (the sampled round: lo = e[b], hi = e[b+1], above =
// counts[b+1]); then it zeroes the counts and the ticket for the next launch
// and keeps a copy of this round's counts.
//
// Candidates.  With wlo = min(e[1..15]) (= e[1] for ascending edges), an
// element adds to bins 1-15 only if it lies in the open window (wlo, e[16])
// or equals wlo; the latter lie in exactly the bins whose edge is wlo, so
// they are only counted (zeros under low sample quantiles, as in an
// embedding gradient, cost nothing more).  The sampled round also appends
// every element of the open window to a float32 candidate buffer (length on
// the device, capacity from the sample plan) and keeps its count of those
// equal to wlo.  A later round counts the candidates (plus that count, in
// the bins whose edge is wlo) instead of the whole tensor when the sampled
// round's b lay in 1-15, the buffer did not overflow, and the round's own
// [lo, hi) lies inside [wlo, e[16]]: it then counts exactly what the full
// pass would.  Each round checks this itself from the state.
//
// The first state.  search_init_kernel writes it in one launch: lo = above
// = 0 and hi = hi0 = max * 1.0000002 + 1e-30 (FLT_MAX where not finite) for
// the full-range search, or the sampled round's 17 edges (0, the 15 sample
// quantiles clamped to hi0, hi0), the glue's float32 arithmetic.
//
// Bound: one read of the source (4 bytes an element) plus the candidates
// written (4 bytes each); the work per element is what sets the pace of a
// count at 17 edges (the earlier kernel's 16 compares and adds an element
// held it to 61-63 % of HBM's rate).  Design: the common element costs four
// compares: c[0] += (x >= e[0]) & (x < e[16]), the count of x == wlo and the
// window flag; a warp ballot on each element slot stages the window's
// elements in a per-warp shared buffer, and the 15-bin tally (and the
// candidate store, one atomic a ~1,000 staged elements) runs on the staged
// elements one a lane, so its cost follows the window's population, not n.
// Each thread has the next iteration's two 16-byte loads in flight while it
// counts the current two; the whole tensor is read with streaming loads
// (__ldcs) so the candidates the sampled round writes stay in L2 for the
// rounds that read them.  Edges that put most elements in the window
// (spread quantiles of the whole range, the full-range search's first
// round) cost more than the earlier kernel's flat 16 compares.  A round
// also has a fixed cost of a few dependent L2 round trips (the state's
// words, the counts' atomics and the fence before the ticket, the
// epilogue's loads), so on a tensor of a few hundred thousand elements it
// takes longer than a flat count that only adds its counts.  NaN compares
// false against every edge and never counts; +Inf >= e[16] never counts;
// counts are exact int32.

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace {

constexpr int kBins = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = 8;                        // two float4 an iteration
constexpr int kStage = 1280;                       // staged window elements a warp
constexpr int kFlushAt = kStage - 32 * kPerLane;   // room for one more iteration
constexpr unsigned kFull = 0xffffffffu;

// the state's int32 words (floats as their bits)
enum : int {
  kLo = 0, kHi = 1, kAbove = 2, kCounts = 3, kTicket = 19, kCandLen = 20,
  kCandOk = 21, kWinLo = 22, kWinHi = 23, kCandRounds = 24, kRounds = 25,
  kCandEq = 26, kLastCounts = 32, kEdges = 64, kStateWords = 96
};

struct Args {
  const float* x;      // the magnitudes, n of them
  long long n;
  const float* edges;  // 17 edges (the sampled round) or null (from lo, hi)
  int* state;
  float* cand;         // candidate buffer or null
  long long cap;
  float keep_f;
};

// One element slot of the warp.  Bin 0 for every element; an element equal
// to wlo adds to eq (it belongs to exactly the bins whose edge is wlo); an
// element of the open window (wlo, e[16]) is staged for bins 1-15 (and, in
// the sampled round, for the candidate buffer).
__device__ __forceinline__ void count_one(float v, const float (&e)[kBins + 1], float wlo,
                                          int& c0, int& eq, float* stage, int& staged,
                                          unsigned lt) {
  const bool below = v < e[kBins];
  c0 += (v >= e[0]) & below;
  eq += (v == wlo) & below;
  const bool in = (v > wlo) & below;
  const unsigned m = __ballot_sync(kFull, in);
  if (m) {  // warp-uniform
    if (in) stage[staged + __popc(m & lt)] = v;
    staged += __popc(m);
  }
}

// The staged elements' bins 1-15, one element a lane, then (the sampled
// round) their store as candidates.
template <bool kCompact>
__device__ __forceinline__ void flush(float* stage, int& staged, const float (&e)[kBins + 1],
                                      int (&c)[kBins], int lane, const Args& a) {
  __syncwarp();
  for (int i = lane; i < staged; i += 32) {
    const float v = stage[i];
#pragma unroll
    for (int b = 1; b < kBins; ++b) c[b] += v >= e[b];
  }
  if (kCompact) {
    int base = 0;
    if (lane == 0) base = atomicAdd(a.state + kCandLen, staged);
    base = __shfl_sync(kFull, base, 0);
    for (int i = lane; i < staged; i += 32)
      if ((long long)base + i < a.cap) a.cand[base + i] = stage[i];
  }
  __syncwarp();
  staged = 0;
}

__device__ __forceinline__ float4 load4(const float4* p, bool stream) {
  return stream ? __ldcs(p) : __ldg(p);
}

// the last block's narrowing step; one thread.  Every word of the state it
// needs is loaded before the first store: each store that waited on its own
// load would stall the thread for another L2 round trip.  The sampled
// round's edges come from the registers the count used.
__device__ void epilogue(const Args& a, const float (&e)[kBins + 1], bool from_cand,
                         float wlo) {
  volatile int* st = a.state;
  int ci[kBins];
#pragma unroll
  for (int b = 0; b < kBins; ++b) ci[b] = st[kCounts + b];
  const float lo0 = __int_as_float(st[kLo]), hi0 = __int_as_float(st[kHi]);
  const float above0 = __int_as_float(st[kAbove]);
  const int rounds = st[kRounds], cand_rounds = st[kCandRounds], cand_len = st[kCandLen];
  float cf[kBins + 1];
#pragma unroll
  for (int b = 0; b < kBins; ++b) cf[b] = __int2float_rn(ci[b]);
  cf[kBins] = 0.f;
  int nb = 0;
  float lo, hi, above;
  if (a.edges) {
#pragma unroll
    for (int b = 0; b < kBins; ++b) nb += cf[b] >= a.keep_f;
    const int b = min(max(nb - 1, 0), kBins - 1);
    lo = e[0];
    hi = e[1];
    above = cf[1];
#pragma unroll
    for (int k = 1; k < kBins; ++k) {
      if (k == b) {
        lo = e[k];
        hi = e[k + 1];
        above = cf[k + 1];
      }
    }
    st[kCandOk] = a.cand != nullptr && b >= 1 && (long long)cand_len <= a.cap;
    st[kWinLo] = __float_as_int(wlo);
    st[kWinHi] = __float_as_int(e[kBins]);
  } else {
#pragma unroll
    for (int b = 0; b < kBins; ++b) nb += __fadd_rn(above0, cf[b]) >= a.keep_f;
    const int b = min(max(nb - 1, 0), kBins - 1);
    const float width = __fdiv_rn(__fsub_rn(hi0, lo0), (float)kBins);
    lo = __fadd_rn(lo0, __fmul_rn(width, (float)b));
    hi = b == kBins - 1 ? hi0 : __fadd_rn(lo0, __fmul_rn(width, (float)(b + 1)));
    above = __fadd_rn(above0, cf[b + 1]);
    if (from_cand) st[kCandRounds] = cand_rounds + 1;
  }
  st[kLo] = __float_as_int(lo);
  st[kHi] = __float_as_int(hi);
  st[kAbove] = __float_as_int(above);
  st[kRounds] = rounds + 1;
#pragma unroll
  for (int b = 0; b < kBins; ++b) {
    st[kLastCounts + b] = ci[b];
    st[kCounts + b] = 0;
  }
  st[kTicket] = 0;
}

template <bool kCompact>
__global__ void __launch_bounds__(kThreads) count_ge_edges_kernel(Args a) {
  __shared__ float stage_all[kWarps][kStage];
  __shared__ int partial[kWarps][kBins + 1];
  __shared__ int is_last;
  const int* st = a.state;

  float e[kBins + 1];
  const float* src = a.x;
  long long len = a.n;
  bool from_cand = false;
  if (a.edges) {
#pragma unroll
    for (int b = 0; b <= kBins; ++b) e[b] = __ldg(a.edges + b);
  } else {
    // every word first, in one round trip
    const float lo = __int_as_float(st[kLo]), hi = __int_as_float(st[kHi]);
    const int cand_ok = st[kCandOk], cand_len = st[kCandLen];
    const float win_lo = __int_as_float(st[kWinLo]), win_hi = __int_as_float(st[kWinHi]);
    const float width = __fdiv_rn(__fsub_rn(hi, lo), (float)kBins);
#pragma unroll
    for (int b = 0; b < kBins; ++b) e[b] = __fadd_rn(lo, __fmul_rn(width, (float)b));
    e[kBins] = hi;
    from_cand = a.cand != nullptr && cand_ok != 0 && lo >= win_lo && hi <= win_hi;
    if (from_cand) {
      src = a.cand;
      len = cand_len;
    }
  }
  float wlo = e[1];
#pragma unroll
  for (int b = 2; b < kBins; ++b) wlo = fminf(wlo, e[b]);
  const float top = e[kBins];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  float* stage = stage_all[warp];
  int c[kBins];
#pragma unroll
  for (int b = 0; b < kBins; ++b) c[b] = 0;
  int staged = 0, eq = 0;

  // a scalar head up to 16-byte alignment, a float4 body, a scalar tail
  const long long head =
      min(len, (long long)(((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) >> 2));
  const long long n4 = (len - head) >> 2;
  const long long tail = head + (n4 << 2);
  const long long gwarp = (long long)blockIdx.x * kWarps + warp;
  if (gwarp == 0) {  // at most 3 + 3 elements, one slot
    float v = __int_as_float(0x7fc00000);
    if (lane < head) v = src[lane];
    else if (lane >= 3 && tail + lane - 3 < len) v = src[tail + lane - 3];
    count_one(v, e, wlo, c[0], eq, stage, staged, lt);
  }
  const float4* x4 = reinterpret_cast<const float4*>(src + head);
  const bool stream = !from_cand;
  const float4 none = make_float4(__int_as_float(0x7fc00000), __int_as_float(0x7fc00000),
                                  __int_as_float(0x7fc00000), __int_as_float(0x7fc00000));
  const long long step = (long long)gridDim.x * kWarps * 64;
  // the next iteration's two float4 load while this one's are counted
  long long base = gwarp * 64;
  float4 v0 = base + lane < n4 ? load4(x4 + base + lane, stream) : none;
  float4 v1 = base + 32 + lane < n4 ? load4(x4 + base + 32 + lane, stream) : none;
  for (; base < n4; base += step) {
    const long long i0 = base + step + lane, i1 = i0 + 32;
    const float4 w0 = i0 < n4 ? load4(x4 + i0, stream) : none;
    const float4 w1 = i1 < n4 ? load4(x4 + i1, stream) : none;
    count_one(v0.x, e, wlo, c[0], eq, stage, staged, lt);
    count_one(v0.y, e, wlo, c[0], eq, stage, staged, lt);
    count_one(v0.z, e, wlo, c[0], eq, stage, staged, lt);
    count_one(v0.w, e, wlo, c[0], eq, stage, staged, lt);
    count_one(v1.x, e, wlo, c[0], eq, stage, staged, lt);
    count_one(v1.y, e, wlo, c[0], eq, stage, staged, lt);
    count_one(v1.z, e, wlo, c[0], eq, stage, staged, lt);
    count_one(v1.w, e, wlo, c[0], eq, stage, staged, lt);
    if (staged > kFlushAt) flush<kCompact>(stage, staged, e, c, lane, a);
    v0 = w0;
    v1 = w1;
  }
  if (staged) flush<kCompact>(stage, staged, e, c, lane, a);
  // the elements equal to wlo lie in every bin whose edge is wlo; over the
  // candidates, so do the sampled round's (counted then, not stored), where
  // the bracket reaches above them
#pragma unroll
  for (int b = 1; b < kBins; ++b)
    if (e[b] <= wlo) c[b] += eq;
  if (from_cand && blockIdx.x == 0 && threadIdx.x == 0) {
    const float ws = __int_as_float(st[kWinLo]);
    if (ws < top) {
#pragma unroll
      for (int b = 0; b < kBins; ++b)
        if (e[b] <= ws) c[b] += st[kCandEq];
    }
  }

#pragma unroll
  for (int b = 0; b <= kBins; ++b) {
    int s = b < kBins ? c[b] : eq;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFull, s, off);
    if (lane == 0) partial[warp][b] = s;
  }
  __syncthreads();
  if (threadIdx.x < kBins || (kCompact && threadIdx.x == kBins)) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += partial[w][threadIdx.x];
    // the sampled round keeps its count of elements equal to wlo
    if (s != 0) atomicAdd(a.state + (threadIdx.x < kBins ? kCounts + threadIdx.x : kCandEq), s);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(a.state + kTicket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (is_last && threadIdx.x == 0) {
    __threadfence();
    epilogue(a, e, from_cand, wlo);
  }
}

// The search's first state, written whole: lo = above = 0 and hi = hi0 (the
// full-range search), or the sampled round's 17 edges at kEdges: 0, the 15
// sample values sv[ranks[i]] clamped to hi0 where finite (hi0 where not),
// hi0.  hi0 = mx * mul + add (the glue's max * 1.0000002 + 1e-30, each step
// rounded), FLT_MAX where that is not finite.  One thread: a handful of
// scalars in place of a dozen small tensor ops.
__global__ void search_init_kernel(const float* mx, const float* sv, const long long* ranks,
                                   int* state, float mul, float add) {
  const float h = __fadd_rn(__fmul_rn(*mx, mul), add);
  const float hi0 = isfinite(h) ? h : FLT_MAX;
  for (int i = 0; i < kStateWords; ++i) state[i] = 0;
  if (sv == nullptr) {
    state[kHi] = __float_as_int(hi0);
    return;
  }
  float* e = reinterpret_cast<float*>(state + kEdges);
  e[0] = 0.f;
  for (int i = 0; i < kBins - 1; ++i) {
    const float v = sv[ranks[i]];
    e[1 + i] = isfinite(v) ? fminf(v, hi0) : hi0;
  }
  e[kBins] = hi0;
}

template <bool kCompact>
int grid_cap() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        sms <= 0)
      sms = 132;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, count_ge_edges_kernel<kCompact>,
                                                      kThreads, 0) != cudaSuccess ||
        per_sm <= 0)
      per_sm = 4;
    blocks = sms * per_sm;
  }
  return blocks;
}

template <bool kCompact>
int launch(const Args& a, cudaStream_t stream) {
  // sized for the whole tensor: a refinement round decides on the device
  // whether it counts the candidates instead, and then the blocks past
  // them find no work
  const long long per_block = (long long)kThreads * kPerLane;
  long long blocks = (a.n + per_block - 1) / per_block;
  if (blocks > grid_cap<kCompact>()) blocks = grid_cap<kCompact>();
  if (blocks < 1) blocks = 1;  // the epilogue runs even on an empty input
  count_ge_edges_kernel<kCompact><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One round.  state: kStateWords int32 on the device, as the previous round
// (or the caller, zeroed with hi set) left it.  edges: 17 float32 (the
// sampled round) or null (a refinement round from the state's lo and hi).
// cand: float32[cap] or null; with edges, the round fills it; without, the
// round may count it in place of x.  keep_f: float32 of min(keep, n).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int tcdp_count_round(const float* x, long long n, const float* edges, int* state,
                                float* cand, long long cap, float keep_f, void* stream) {
  const Args a{x, n, edges, state, cand, cap, keep_f};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return edges && cand ? launch<true>(a, s) : launch<false>(a, s);
}

// Writes the search's first state (see search_init_kernel); sv and ranks
// null for the full-range search.  Returns the launch's cudaError_t.
extern "C" int tcdp_search_init(const float* mx, const float* sv, const long long* ranks,
                                int* state, float mul, float add, void* stream) {
  search_init_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(mx, sv, ranks, state, mul,
                                                                      add);
  return (int)cudaGetLastError();
}
