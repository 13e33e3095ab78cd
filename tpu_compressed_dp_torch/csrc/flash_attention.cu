// Causal flash attention, forward and backward, for
// tpu_compressed_dp_torch/ops/flash_attention.py (flash_fwd, flash_dq,
// flash_dkv).
//
// Replaces the Pallas TPU kernels of tpu_compressed_dp/ops/flash_attention.py:
//   * tcdp_flash_fwd  <- _fwd_kernel: o = softmax(q k^T * scale, causal) v and
//     lse = m + log(l) per row, by the online-softmax recurrence over K/V
//     blocks 0..qi (the trailing, fully masked blocks are skipped);
//   * tcdp_flash_dq   <- _dq_kernel: dq = sum_j ds_j k_j with
//     p = exp(s - lse), dp = do . v, ds = p * (dp - delta) * scale;
//   * tcdp_flash_dkv  <- _dkv_kernel and _dkv_kernel_streamed: dv = p^T do,
//     dk = ds^T q over the q blocks qi >= kj.  The two TPU kernels differ only
//     in where the full-T operands wait (VMEM-resident or DMA'd from HBM per
//     q block); here every q/do block streams through shared memory, which
//     is the streamed form, so one kernel serves both.
// The TPU kernels pack lse and delta into spare lanes of the output and the
// cotangent (a Mosaic layout device); here they are plain float32 [B*H, T]
// tensors.
//
// Rounding points are the Pallas kernels': products of q, k (and p, v) in
// the input type accumulate in float32; s = dot * scale; p is rounded to v's
// type before P.V (reference :93-95); o = acc / l and dq/dk/dv are written in
// the input type; in the backward do is float32 (:124, :157) but holds the
// input type's values (the wrapper rounds the cotangent to q's type), so
// dp = do . v is a product of two input-type values; ds is rounded to the
// input type before ds . k and ds^T . q (:140-142, :172-174); and dv += p^T do
// takes p in float32, unrounded (:165-167).  Sums run in another order than
// on the TPU, so the kernels agree with the plain versions to a tolerance,
// not bitwise.
//
// Dispatch is by dtype alone, in each C entry:
//   * bfloat16 runs on the tensor cores (flash_fwd_tc_kernel,
//     flash_dq_tc_kernel, flash_dkv_tc_kernel below): a bf16 x bf16 product
//     is exact in float32, so mma.sync with float32 accumulators computes the
//     reference's products;
//   * float32 stays on the CUDA-core kernels (flash_*_kernel): the reference
//     multiplies float32 operands in float32, which TF32 tensor cores would
//     round to 10 mantissa bits.
// A failed launch returns its error; nothing falls back to the other design.
//
// Tensor-core design (bf16; mma.sync.m16n8k16 with ldmatrix and cp.async,
// the FlashAttention-2 layout; wgmma is the next step, ROADMAP item 15):
//   * one block of 4 warps per (64-row tile, batch-head); each warp owns 16
//     rows of the tile and keeps its accumulators in registers.  Tiles are
//     64 rows, so any T % 64 == 0 runs without a ragged tile;
//   * operand tiles live in shared memory as [rows][D] bf16 with each 16-byte
//     chunk XOR-swizzled by row % 8, so cp.async's 16-byte writes and
//     ldmatrix's 8-row reads are free of bank conflicts; a 2-stage ring loads
//     the next tile (cp.async) while the tensor cores work on this one;
//   * forward: Q's fragments sit in registers; K/V tiles stream.  S = Q K^T
//     (K as the col-major B operand, plain ldmatrix), scale, mask on the
//     diagonal tile only, online softmax on the accumulator rows (4 lanes
//     share a row: two xor shuffles), p rounded to bf16 in registers and
//     fed back as the A operand of O += P V (V by ldmatrix.trans), so P never
//     touches shared memory.  Grid (B*H, T/64), the longest q tiles first;
//   * dk/dv: K/V of the block's 64 k rows stay in shared memory; Q, dO and
//     their lse/delta rows stream in 64-row tiles.  The transposed products
//     S^T = K Q^T and dP^T = V dO^T leave P^T and dS^T in the accumulator
//     layout, which is the A-operand layout of dV += P^T dO and
//     dK += bf16(dS^T) Q (dO and Q by ldmatrix.trans).  Grid (B*H, T/64),
//     the k tiles that meet the most q tiles first;
//   * dq: the forward's layout with dk/dv's arithmetic.  Q, dO of the block's
//     64 q rows stay in shared memory (each warp reads only its own 16 rows),
//     lse and delta of the thread's two rows in registers; K/V tiles stream.
//     S = Q K^T and dP = dO V^T (K, V as the col-major B operand, Q and dO
//     reloaded per 16-deep step), P and dS formed on the accumulator rows,
//     dQ += bf16(dS) K with dS as the A operand (K by ldmatrix.trans).  One
//     16 x D accumulator a warp, one 64-column pass per k tile.  Grid
//     (B*H, T/64), the longest q tiles first.  A warp-wide vote skips the
//     seq_dots branches (below) on the tiles that need none: with them inline
//     on every tile, dq took 4.8 ms at (1, 32, 8192, 128) on an H100, with
//     the vote 3.3;
//   * dv's p is float32 in the reference.  One bf16 rounding of p errs by
//     ~2^-9.8 of each term, and a dv element sums ~T/2 terms of random sign,
//     which puts its error near phase 6's 2^-10 rms share; so p splits into
//     hi = bf16(p) and lo = bf16(p - hi) (p - hi is exact in float32) and
//     both go through the tensor cores into one float32 accumulator:
//     p = hi + lo to ~2^-17, five products where the reference has four;
//   * bf16(ds) is the one discontinuous rounding point: the tensor cores sum
//     the exact products of s and dp in another order than a float32 FMA
//     chain (the plain version's and the CUDA-core kernels' order), and for a
//     large ds an ulp of difference may round it to the other bf16
//     neighbour, an error of ~2^-8 |ds| |q| in one dk term (|k| in dq).
//     Where p >= 2^-8 (the concentrated rows, ~0.1 % of the terms of random
//     inputs) dq and dk/dv recompute s and dp as that chain on the CUDA cores
//     (seq_dots), so their large ds round as the plain version's do, and
//     both kernels round each large ds from the same s and dp.
//
// CUDA-core design (float32): one block of 256 threads per
// (64-row tile, batch-head); a 16 x 16 thread grid, thread (ty, tx) owning
// rows ty + 16 i (i < 4) and columns tx + 16 j of every 64-wide tile, so
// shared-memory reads are consecutive across tx (tiles widened to float32,
// row stride D + 1).  K/V (forward, dq) or Q/dO (dkv) tiles stream through
// shared memory one 64-row block at a time; per-row statistics sit in shared
// memory; the score tile is reduced by rows one warp per 8 rows.  The tiles
// take 116 KB (forward), 149 KB (dq) and 166 KB (dkv) at D = 128, above the
// 48 KB default, so each launch raises the dynamic shared-memory limit.
//
// Bound: operations.  Causal attention does 2 T^2 D B H flops forward (two
// products over half of the T x T scores), 1.5x that in dq (three) and 2x
// in dk/dv (four); at the llama3_8b shape (1, 32, 8192, 128) that is 0.55
// TFLOP forward, 0.56 ms at the bf16 tensor-core rate (989 TFLOP/s), 0.83
// ms for dq and 1.1 ms for dk/dv.  mma.sync reaches a part of that rate
// (wgmma is the only way to all of it), and each warp reads whole K/V (or
// Q/dO) tiles from shared memory for its 16 rows (32 KB per 128 mma
// forward, 56 KB per 192 in dq, 72 KB per 320 in dk/dv), so shared-memory
// bandwidth, not the tensor cores, bounds these kernels; dk/dv also holds
// 255 registers a thread (its accumulators take 128), so two blocks share
// an SM.  The float32 kernels run on the CUDA cores (67 TFLOP/s), a 16 x 16
// thread grid with 8 shared-memory loads per 16 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlk = 64;       // rows per q tile and per k/v tile
constexpr int kLs = kBlk + 1;  // row stride of a [64][64] score tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype
}

// x rounded to T and widened back (the Pallas kernels' .astype(T) operands)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// a [64][D] tile of src (contiguous rows) into dst [64][D + 1] as float32
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, float* dst) {
  for (int e = threadIdx.x; e < kBlk * D; e += kThreads) {
    dst[(e / D) * (D + 1) + (e % D)] = to_f(src[e]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int t, float scale) {
  constexpr int LD = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kBlk * LD;
  float* sv = sk + kBlk * LD;
  float* sp = sv + kBlk * LD;
  float* sm = sp + kBlk * kLs;
  float* sl = sm + kBlk;
  float* sc = sl + kBlk;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qi = gridDim.x - 1 - blockIdx.x;  // the longest rows start first
  const long long base = (long long)blockIdx.y * t;
  load_tile<T, D>(q + (base + (long long)qi * kBlk) * D, sq);
  if (threadIdx.x < kBlk) {
    sm[threadIdx.x] = kNegInf;
    sl[threadIdx.x] = 0.f;
  }
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int kj = 0; kj <= qi; ++kj) {
    __syncthreads();  // the last tile's readers are done
    load_tile<T, D>(k + (base + (long long)kj * kBlk) * D, sk);
    load_tile<T, D>(v + (base + (long long)kj * kBlk) * D, sv);
    __syncthreads();
    float s[4][4] = {};
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sq[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sk[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float x = s[i][j] * scale;
        sp[r * kLs + c] = (kj * kBlk + c > qi * kBlk + r) ? kNegInf : x;
      }
    }
    __syncthreads();
    // online softmax, one warp per 8 rows.  Column 0 of tile 0 is never
    // masked, so m is finite after the first tile and a masked score gives
    // exp(-1e30 - m) = 0; corr is 0 on the first tile, where l and acc are 0.
    for (int rr = 0; rr < 8; ++rr) {
      const int r = warp * 8 + rr;
      const float x0 = sp[r * kLs + lane], x1 = sp[r * kLs + lane + 32];
      const float m_prev = sm[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      const float sum = warp_sum(p0 + p1);
      sp[r * kLs + lane] = round_to<T>(p0);
      sp[r * kLs + lane + 32] = round_to<T>(p1);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sl[r] = sl[r] * corr + sum;
        sm[r] = m_new;
        sc[r] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = sc[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    for (int j = 0; j < kBlk; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sp[(ty + 16 * i) * kLs + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = sv[j * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }
  const long long row0 = base + (long long)qi * kBlk;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float l = sl[r];
#pragma unroll
    for (int c = 0; c < NC; ++c) o[(row0 + r) * D + tx + 16 * c] = from_f<T>(acc[i][c] / l);
  }
  if (threadIdx.x < kBlk) lse[row0 + threadIdx.x] = sm[threadIdx.x] + logf(sl[threadIdx.x]);
}

// p and ds of one (q tile, k tile) pair: s = q . k, dp = do . v over D, then
// p = exp(s * scale - lse) (0 where masked) and ds = p * (dp - delta) * scale,
// for the thread's 4 x 4 (q row, k column) entries.
template <int D>
__device__ __forceinline__ void p_ds_tile(const float* sq, const float* sdo, const float* sk,
                                          const float* sv, const float* slse,
                                          const float* sdelta, int qi, int kj, float scale,
                                          float p[4][4], float ds[4][4]) {
  constexpr int LD = D + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[4][4] = {}, dp[4][4] = {};
  for (int d = 0; d < D; ++d) {
    float a[4], g[4], b[4], w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = sq[(ty + 16 * i) * LD + d];
      g[i] = sdo[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = sk[(tx + 16 * j) * LD + d];
      w[j] = sv[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float l = slse[r], dl = sdelta[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float x = s[i][j] * scale;
      p[i][j] = (kj * kBlk + c > qi * kBlk + r) ? 0.f : expf(x - l);
      ds[i][j] = p[i][j] * (dp[i][j] - dl) * scale;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int t, float scale) {
  constexpr int LD = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + kBlk * LD;
  float* sk = sdo + kBlk * LD;
  float* sv = sk + kBlk * LD;
  float* sds = sv + kBlk * LD;
  float* slse = sds + kBlk * kLs;
  float* sdelta = slse + kBlk;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int qi = gridDim.x - 1 - blockIdx.x;
  const long long base = (long long)blockIdx.y * t;
  const long long row0 = base + (long long)qi * kBlk;
  load_tile<T, D>(q + row0 * D, sq);
  load_tile<T, D>(dout + row0 * D, sdo);
  if (threadIdx.x < kBlk) {
    slse[threadIdx.x] = lse[row0 + threadIdx.x];
    sdelta[threadIdx.x] = delta[row0 + threadIdx.x];
  }
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int kj = 0; kj <= qi; ++kj) {
    __syncthreads();
    load_tile<T, D>(k + (base + (long long)kj * kBlk) * D, sk);
    load_tile<T, D>(v + (base + (long long)kj * kBlk) * D, sv);
    __syncthreads();
    float p[4][4], ds[4][4];
    p_ds_tile<D>(sq, sdo, sk, sv, slse, sdelta, qi, kj, scale, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sds[(ty + 16 * i) * kLs + tx + 16 * j] = round_to<T>(ds[i][j]);
    __syncthreads();
    for (int j = 0; j < kBlk; ++j) {
      float g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) g[i] = sds[(ty + 16 * i) * kLs + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kk = sk[j * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(g[i], kk, acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dq[(row0 + ty + 16 * i) * D + tx + 16 * c] = from_f<T>(acc[i][c]);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                 int t, float scale) {
  constexpr int LD = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + kBlk * LD;
  float* sq = sv + kBlk * LD;
  float* sdo = sq + kBlk * LD;
  float* sp = sdo + kBlk * LD;
  float* sds = sp + kBlk * kLs;
  float* slse = sds + kBlk * kLs;
  float* sdelta = slse + kBlk;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int kj = blockIdx.x;  // k tile kj meets q tiles kj..n-1: the longest first
  const int n_q = gridDim.x;
  const long long base = (long long)blockIdx.y * t;
  const long long krow0 = base + (long long)kj * kBlk;
  load_tile<T, D>(k + krow0 * D, sk);
  load_tile<T, D>(v + krow0 * D, sv);
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int qi = kj; qi < n_q; ++qi) {
    __syncthreads();
    const long long qrow0 = base + (long long)qi * kBlk;
    load_tile<T, D>(q + qrow0 * D, sq);
    load_tile<T, D>(dout + qrow0 * D, sdo);
    if (threadIdx.x < kBlk) {
      slse[threadIdx.x] = lse[qrow0 + threadIdx.x];
      sdelta[threadIdx.x] = delta[qrow0 + threadIdx.x];
    }
    __syncthreads();
    float p[4][4], ds[4][4];
    p_ds_tile<D>(sq, sdo, sk, sv, slse, sdelta, qi, kj, scale, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = (ty + 16 * i) * kLs + tx + 16 * j;  // [q row][k column]
        sp[o] = p[i][j];
        sds[o] = round_to<T>(ds[i][j]);
      }
    __syncthreads();
    // thread's k rows ty + 16 i, output columns tx + 16 c
    for (int r = 0; r < kBlk; ++r) {
      float pp[4], dd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pp[i] = sp[r * kLs + ty + 16 * i];
        dd[i] = sds[r * kLs + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float g = sdo[r * LD + tx + 16 * c], qq = sq[r * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][c] = fmaf(pp[i], g, dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dd[i], qq, dk_acc[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const long long o = (krow0 + ty + 16 * i) * D + tx + 16 * c;
      dk[o] = from_f<T>(dk_acc[i][c]);
      dv[o] = from_f<T>(dv_acc[i][c]);
    }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync.m16n8k16, ldmatrix, cp.async
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 128;  // 4 warps, 16 tile rows each
constexpr int kRows = 64;        // rows of every tile (q, k/v, and dk/dv's q tiles)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk ch of row r in a [rows][D] bf16 tile whose
// chunks are XOR-swizzled by r % 8 (ldmatrix reads 8 rows at one chunk).
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return static_cast<uint32_t>(r * D + ((ch ^ (r & 7)) << 3)) * 2u;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a [kRows][D] tile of contiguous rows into swizzled shared memory at dst
template <int D>
__device__ __forceinline__ void cp_tile(uint32_t dst, const bf16* __restrict__ src) {
  constexpr int kPerRow = D / 8;
#pragma unroll
  for (int i = threadIdx.x; i < kRows * kPerRow; i += kTcThreads) {
    const int r = i / kPerRow, ch = i % kPerRow;
    cp_async16(dst + swz<D>(r, ch), src + (size_t)r * D + ch * 8);
  }
}

// four 8 x 8 b16 matrices; lane i gives the row address of matrix i / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 operands, float32 accumulators
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
}

// two floats rounded to bf16 (round to nearest even, as astype), x0 in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<uint32_t*>(&h);
}

// x = hi + lo + O(2^-17 |x|): hi = bf16(x), lo = bf16(x - hi), x - hi exact
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// The A operand of a 16 x 16 step (k columns 16 kk..16 kk + 15) from the
// accumulators of two 16 x 8 tiles: the accumulator layout is the A layout.
__device__ __forceinline__ void acc_to_a(const float (&c0)[4], const float (&c1)[4],
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// the A fragment of rows row0..row0 + 15, k columns 16 ks.., of a [rows][D] tile
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t as, int row0, int ks,
                                       int lane) {
  ldsm_x4(a, as + swz<D>(row0 + (lane & 15), 2 * ks + (lane >> 4)));
}

// One 16-deep step of the score products: s[16 x 16 N2] += a (16 x 16, depth
// columns 16 ks..) times B^T, B rows c0..c0 + 16 N2 - 1 of the [64][D] tile
// bs, whose rows are the columns of s (plain ldmatrix of a row-major [n][k]
// tile gives the col-major B fragment).
template <int D, int N2>
__device__ __forceinline__ void scores_step(float (&s)[2 * N2][4], const uint32_t (&a)[4],
                                            uint32_t bs, int c0, int ks, int lane) {
#pragma unroll
  for (int jp = 0; jp < N2; ++jp) {
    uint32_t b[4];
    ldsm_x4(b, bs + swz<D>(c0 + jp * 16 + (lane & 7) + ((lane >> 4) << 3),
                           2 * ks + ((lane >> 3) & 1)));
    mma16816(s[2 * jp], a, b[0], b[1]);
    mma16816(s[2 * jp + 1], a, b[2], b[3]);
  }
}

// s = rows row0..row0 + 15 of the [64][D] tile as times rows c0.. of B^T,
// A reloaded per step
template <int D, int N2>
__device__ __forceinline__ void scores(float (&s)[2 * N2][4], uint32_t as, int row0,
                                       uint32_t bs, int c0, int lane) {
  zero(s);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    load_a<D>(a, as, row0, ks, lane);
    scores_step<D, N2>(s, a, bs, c0, ks, lane);
  }
}

// acc[16 x D] += a (16 x 16, k columns 16 kk..) times rows 16 kk.. of the
// [rows][D] tile bs (ldmatrix.trans of a row-major [k][n] tile gives the
// col-major B fragment); with a2, acc += a b + a2 b on one load of b
template <int D, bool kTwo>
__device__ __forceinline__ void acc_pv(float (&acc)[D / 8][4], const uint32_t (&a)[4],
                                       const uint32_t (&a2)[4], uint32_t bs, int kk, int lane) {
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    uint32_t b[4];
    ldsm_x4_t(b, bs + swz<D>(kk * 16 + (lane & 15), 2 * dp + (lane >> 4)));
    mma16816(acc[2 * dp], a, b[0], b[1]);
    mma16816(acc[2 * dp + 1], a, b[2], b[3]);
    if (kTwo) {
      mma16816(acc[2 * dp], a2, b[0], b[1]);
      mma16816(acc[2 * dp + 1], a2, b[2], b[3]);
    }
  }
}

// rows row0..row0 + 15 of a [16 x D] accumulator (divided by l when given),
// rounded to bf16, to global rows dst[0..15] (row stride D), through the
// swizzled tile `stage` (rows row0.. of it belong to this warp alone)
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], const float* l,
                                           bf16* stage, int row0, bf16* __restrict__ dst,
                                           int lane) {
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  char* st = reinterpret_cast<char*>(stage);
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    float x0 = acc[nt][0], x1 = acc[nt][1], x2 = acc[nt][2], x3 = acc[nt][3];
    if (l) {  // o = acc / l, a true division as the reference's
      x0 /= l[0], x1 /= l[0], x2 /= l[1], x3 /= l[1];
    }
    *reinterpret_cast<uint32_t*>(st + swz<D>(row0 + g, nt) + c2 * 2) = pack_bf16(x0, x1);
    *reinterpret_cast<uint32_t*>(st + swz<D>(row0 + g + 8, nt) + c2 * 2) = pack_bf16(x2, x3);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * D / 8; i += 32) {
    const int r = i / (D / 8), ch = i % (D / 8);
    *reinterpret_cast<uint4*>(dst + (size_t)r * D + ch * 8) =
        *reinterpret_cast<const uint4*>(st + swz<D>(row0 + r, ch));
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                    int t, float scale) {
  constexpr int TILE = kRows * D, NT = D / 8;
  constexpr uint32_t TB = TILE * sizeof(bf16);  // bytes of a tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  const uint32_t sq_s = smem_u32(sq);
  const uint32_t skv = sq_s + TB;  // stage s: K at skv + 2 s TB, V at skv + (2 s + 1) TB
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;  // accumulator rows g, g + 8; columns c2, c2 + 1
  const int row0 = warp * 16;
  const int qi = gridDim.y - 1 - blockIdx.y;  // the longest rows start first
  const size_t base = (size_t)blockIdx.x * t * D;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  cp_tile<D>(sq_s, q + base + (size_t)qi * TILE);
  cp_tile<D>(skv, kb);
  cp_tile<D>(skv + TB, vb);
  cp_commit();

  uint32_t qf[D / 16][4];  // Q's A fragments, kept in registers
  float acc[NT][4];
  zero(acc);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kj = 0; kj <= qi; ++kj) {
    const uint32_t sk = skv + (kj & 1) * 2 * TB, sv = sk + TB;
    if (kj < qi) {  // the next K/V tile into the other stage
      const uint32_t nk = skv + ((kj + 1) & 1) * 2 * TB;
      cp_tile<D>(nk, kb + (size_t)(kj + 1) * TILE);
      cp_tile<D>(nk + TB, vb + (size_t)(kj + 1) * TILE);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (kj == 0) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) load_a<D>(qf[ks], sq_s, row0, ks, lane);
    }

    float s[8][4];
    zero(s);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) scores_step<D, 4>(s, qf[ks], sk, 0, ks, lane);
    // s * scale, the diagonal tile masked; column 0 of tile 0 is never
    // masked, so m is finite after the first tile, a masked score gives
    // exp(-1e30 - m) = 0 and corr is 0 on the first tile (l, acc are 0)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[j][e], scale);  // rounded as the reference's s
        if (kj == qi && j * 8 + c2 + (e & 1) > row0 + g + (e >> 1) * 8) x = kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = expf(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(__fsub_rn(s[j][e], m[e >> 1]));
        s[j][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = __fadd_rn(__fmul_rn(l[h], corr[h]), sum[h]);  // p unrounded, as the reference
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[nt][0] *= corr[0];
      acc[nt][1] *= corr[0];
      acc[nt][2] *= corr[1];
      acc[nt][3] *= corr[1];
    }
    // O += bf16(P) V, P from the registers
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      acc_to_a(s[2 * kk], s[2 * kk + 1], a);
      acc_pv<D, false>(acc, a, a, sv, kk, lane);
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }
  const size_t r_out = (size_t)qi * kRows + row0;
  store_rows<D>(acc, l, sq, row0, o + base + r_out * D, lane);
  if ((lane & 3) == 0) {
    float* lb = lse + (size_t)blockIdx.x * t + r_out + g;
    lb[0] = m[0] + logf(l[0]);
    lb[8] = m[1] + logf(l[1]);
  }
}

// Where the attention is concentrated (p >= kSeqP) dq and dk/dv recompute s
// and dp on the CUDA cores, see seq_dots.
constexpr float kSeqP = 1.f / 256.f;

// s = a[ra] . b[rb] and dp = c[ra] . d[rb] over d = 0..D-1 of four swizzled
// [rows][D] bf16 tiles, each a float32 FMA chain in index order: the order
// of the plain version's float32 products and of the CUDA-core kernels, so
// bf16(ds) rounds to the same side as theirs.  The tensor cores sum the same
// exact products in another order, and where p is large an ulp of that
// difference turns bf16(ds) to the other neighbour for a visible share of
// the terms (one bf16 ulp of a large ds is ~2^-8 |ds| |q| in dk).
template <int D>
__device__ __forceinline__ void seq_dots(const char* a, const char* b, const char* c,
                                         const char* d, int ra, int rb, float& s, float& dp) {
  s = 0.f, dp = 0.f;
#pragma unroll 1
  for (int ch = 0; ch < D / 8; ++ch) {
    const uint4 va = *reinterpret_cast<const uint4*>(a + swz<D>(ra, ch));
    const uint4 vb = *reinterpret_cast<const uint4*>(b + swz<D>(rb, ch));
    const uint4 vc = *reinterpret_cast<const uint4*>(c + swz<D>(ra, ch));
    const uint4 vd = *reinterpret_cast<const uint4*>(d + swz<D>(rb, ch));
    const uint32_t wa[4] = {va.x, va.y, va.z, va.w}, wb[4] = {vb.x, vb.y, vb.z, vb.w};
    const uint32_t wc[4] = {vc.x, vc.y, vc.z, vc.w}, wd[4] = {vd.x, vd.y, vd.z, vd.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the low half is the lower index
      s = fmaf(__uint_as_float(wa[i] << 16), __uint_as_float(wb[i] << 16), s);
      s = fmaf(__uint_as_float(wa[i] & 0xffff0000u), __uint_as_float(wb[i] & 0xffff0000u), s);
      dp = fmaf(__uint_as_float(wc[i] << 16), __uint_as_float(wd[i] << 16), dp);
      dp = fmaf(__uint_as_float(wc[i] & 0xffff0000u), __uint_as_float(wd[i] & 0xffff0000u), dp);
    }
  }
}

// dk/dv's q tile stage: Q, dO [kRows][D] at sq, sq + tile bytes; their lse,
// delta rows at sstat, sstat + kRows floats
template <int D>
__device__ __forceinline__ void load_q_stage(uint32_t sq, uint32_t sstat,
                                             const bf16* __restrict__ q,
                                             const bf16* __restrict__ dout,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta) {
  cp_tile<D>(sq, q);
  cp_tile<D>(sq + kRows * D * sizeof(bf16), dout);
  const int i = threadIdx.x;  // 16-byte chunks: lse 0..15, delta 16..31
  if (i < kRows / 4) cp_async16(sstat + 16 * i, lse + 4 * i);
  else if (i < kRows / 2) cp_async16(sstat + 16 * i, delta + 4 * (i - kRows / 4));
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int t, float scale) {
  constexpr int TILE = kRows * D, NT = D / 8;
  constexpr uint32_t TB = TILE * sizeof(bf16);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sk + TILE;
  const uint32_t sk_s = smem_u32(sk), sv_s = sk_s + TB;
  const uint32_t sqd = sv_s + TB;  // stage s: Q at sqd + 2 s TB, dO at sqd + (2 s + 1) TB
  const float* sstat = reinterpret_cast<const float*>(smem_raw + 6 * TB);  // stage s at 2 s kRows
  const uint32_t sstat_s = sk_s + 6 * TB;
  const char* gk = reinterpret_cast<const char*>(sk);
  const char* gv = reinterpret_cast<const char*>(sv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int row0 = warp * 16;  // the warp's k rows in the tile
  const int kj = blockIdx.y;   // k tile kj meets q tiles kj..n-1: the longest first
  const int n_q = t / kRows;
  const size_t base = (size_t)blockIdx.x * t * D, sbase = (size_t)blockIdx.x * t;
  cp_tile<D>(sk_s, k + base + (size_t)kj * TILE);
  cp_tile<D>(sv_s, v + base + (size_t)kj * TILE);
  load_q_stage<D>(sqd, sstat_s, q + base + (size_t)kj * TILE, dout + base + (size_t)kj * TILE,
                  lse + sbase + kj * kRows, delta + sbase + kj * kRows);
  cp_commit();

  float dka[NT][4], dva[NT][4];
  zero(dka);
  zero(dva);
  const int krow = kj * kRows + row0 + g;  // k positions krow, krow + 8

  for (int qi = kj; qi < n_q; ++qi) {
    const int st = (qi - kj) & 1;
    const uint32_t sq = sqd + st * 2 * TB, sdo = sq + TB;
    const float* slse = sstat + st * 2 * kRows;
    const float* sdelta = slse + kRows;
    if (qi + 1 < n_q) {
      const size_t off = (size_t)(qi + 1) * TILE;
      load_q_stage<D>(sqd + (st ^ 1) * 2 * TB, sstat_s + (st ^ 1) * 2 * kRows * sizeof(float),
                      q + base + off, dout + base + off, lse + sbase + (qi + 1) * kRows,
                      delta + sbase + (qi + 1) * kRows);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bool diag = qi == kj;
    const char* gq = reinterpret_cast<const char*>(smem_raw) + (sq - sk_s);  // Q, then dO

    // Two passes of 32 q columns each: P^T and dS^T of half the tile at a
    // time keep the dK/dV accumulators and the scores within the registers.
#pragma unroll 1
    for (int c0 = 0; c0 < kRows; c0 += 32) {
      // P^T = exp(K Q^T * scale - lse), 0 where the k position passes the q
      // position; s = dot * scale and s - lse round as the reference's
      float p[4][4];
      scores<D, 2>(p, sk_s, row0, sq, c0, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + j * 8 + c2 + (e & 1);
          const float x = expf(__fsub_rn(__fmul_rn(p[j][e], scale), slse[c]));
          p[j][e] = (diag && krow + (e >> 1) * 8 > qi * kRows + c) ? 0.f : x;
        }
      // dS^T = P^T (V dO^T - delta) * scale
      float ds[4][4];
      scores<D, 2>(ds, sv_s, row0, sdo, c0, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + j * 8 + c2 + (e & 1);
          if (p[j][e] >= kSeqP) {  // masked entries are 0
            float sd, dd;
            seq_dots<D>(gk, gq, gv, gq + TB, row0 + g + (e >> 1) * 8, c, sd, dd);
            p[j][e] = expf(__fsub_rn(__fmul_rn(sd, scale), slse[c]));
            ds[j][e] = dd;
          }
          ds[j][e] = p[j][e] * (ds[j][e] - sdelta[c]) * scale;
        }
      // dV += (P_hi + P_lo)^T dO (p float32, as the reference); dK += bf16(dS^T) Q
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t hi[4], lo[4], a[4];
        split_bf16(p[2 * kk][0], p[2 * kk][1], hi[0], lo[0]);
        split_bf16(p[2 * kk][2], p[2 * kk][3], hi[1], lo[1]);
        split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], hi[2], lo[2]);
        split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], hi[3], lo[3]);
        acc_pv<D, true>(dva, hi, lo, sdo, c0 / 16 + kk, lane);
        acc_to_a(ds[2 * kk], ds[2 * kk + 1], a);
        acc_pv<D, false>(dka, a, a, sq, c0 / 16 + kk, lane);
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }
  const size_t r_out = base + ((size_t)kj * kRows + row0) * D;
  store_rows<D>(dka, nullptr, sk, row0, dk + r_out, lane);
  store_rows<D>(dva, nullptr, sv, row0, dv + r_out, lane);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dq, int t, float scale) {
  constexpr int TILE = kRows * D, NT = D / 8;
  constexpr uint32_t TB = TILE * sizeof(bf16);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  const uint32_t sq_s = smem_u32(sq), sdo_s = sq_s + TB;
  const uint32_t skv = sdo_s + TB;  // stage s: K at skv + 2 s TB, V at skv + (2 s + 1) TB
  const char* gq = reinterpret_cast<const char*>(smem_raw);  // Q, dO, then the stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;  // accumulator rows g, g + 8; columns c2, c2 + 1
  const int row0 = warp * 16;                    // the warp's q rows in the tile
  const int qi = gridDim.y - 1 - blockIdx.y;     // the longest rows start first
  const size_t base = (size_t)blockIdx.x * t * D;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  cp_tile<D>(sq_s, q + base + (size_t)qi * TILE);
  cp_tile<D>(sdo_s, dout + base + (size_t)qi * TILE);
  cp_tile<D>(skv, kb);
  cp_tile<D>(skv + TB, vb);
  cp_commit();

  const size_t srow = (size_t)blockIdx.x * t + (size_t)qi * kRows + row0 + g;
  const float l[2] = {lse[srow], lse[srow + 8]};
  const float dl[2] = {delta[srow], delta[srow + 8]};
  float dqa[NT][4];
  zero(dqa);

  for (int kj = 0; kj <= qi; ++kj) {
    const uint32_t sk = skv + (kj & 1) * 2 * TB, sv = sk + TB;
    if (kj < qi) {  // the next K/V tile into the other stage
      const uint32_t nk = skv + ((kj + 1) & 1) * 2 * TB;
      cp_tile<D>(nk, kb + (size_t)(kj + 1) * TILE);
      cp_tile<D>(nk + TB, vb + (size_t)(kj + 1) * TILE);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bool diag = kj == qi;
    const char* gk = gq + (sk - sq_s);  // K, then V

    // P = exp(Q K^T * scale - lse), 0 where the k position passes the q
    // position; s = dot * scale and s - lse round as the reference's
    float p[8][4];
    scores<D, 4>(p, sq_s, row0, sk, 0, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + c2 + (e & 1);
        const float x = expf(__fsub_rn(__fmul_rn(p[j][e], scale), l[e >> 1]));
        p[j][e] = (diag && c > row0 + g + (e >> 1) * 8) ? 0.f : x;
      }
    // dS = P (dO V^T - delta) * scale, s and dp of the concentrated entries
    // as dk/dv computes them (seq_dots).  One warp-wide test first: most
    // tiles have no such entry, and their path stays free of the 32 branches.
    float ds[8][4];
    scores<D, 4>(ds, sdo_s, row0, sv, 0, lane);
    bool seq = false;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) seq |= p[j][e] >= kSeqP;  // masked entries are 0
    if (__any_sync(0xffffffffu, seq)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (p[j][e] >= kSeqP) {
            float sd, dd;
            seq_dots<D>(gq, gk, gq + TB, gk + TB, row0 + g + (e >> 1) * 8,
                        j * 8 + c2 + (e & 1), sd, dd);
            p[j][e] = expf(__fsub_rn(__fmul_rn(sd, scale), l[e >> 1]));
            ds[j][e] = dd;
          }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - dl[e >> 1]) * scale;
    // dQ += bf16(dS) K, dS from the registers
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      acc_to_a(ds[2 * kk], ds[2 * kk + 1], a);
      acc_pv<D, false>(dqa, a, a, sk, kk, lane);
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }
  // Q's rows row0.. are this warp's alone: they stage its dq rows
  store_rows<D>(dqa, nullptr, sq, row0, dq + base + ((size_t)qi * kRows + row0) * D, lane);
}

constexpr size_t tile_bytes(int d, int tiles, int score_tiles) {
  return sizeof(float) * ((size_t)tiles * kBlk * (d + 1) + (size_t)score_tiles * kBlk * kLs +
                          3 * kBlk);
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int t,
               float scale, cudaStream_t stream) {
  constexpr size_t smem = tile_bytes(D, 3, 1);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<T, D><<<dim3(t / kBlk, bh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, t, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int bh, int t, float scale, cudaStream_t stream) {
  constexpr size_t smem = tile_bytes(D, 4, 1);
  cudaError_t err = cudaFuncSetAttribute(flash_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_dq_kernel<T, D><<<dim3(t / kBlk, bh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), t, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int bh, int t, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = tile_bytes(D, 4, 2);
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_dkv_kernel<T, D><<<dim3(t / kBlk, bh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), t,
      scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                  int t, float scale, cudaStream_t stream) {
  constexpr int smem = 5 * kRows * D * sizeof(bf16);  // Q and two K/V stages
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_tc_kernel<D><<<dim3(bh, t / kRows), kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, t, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dq, int bh, int t, float scale,
                 cudaStream_t stream) {
  constexpr int smem = 6 * kRows * D * sizeof(bf16);  // Q, dO and two K/V stages
  cudaError_t err = cudaFuncSetAttribute(flash_dq_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_dq_tc_kernel<D><<<dim3(bh, t / kRows), kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), t, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dk, void* dv, int bh, int t,
                  float scale, cudaStream_t stream) {
  // K, V and two stages of Q, dO with their lse, delta rows
  constexpr int smem = 6 * kRows * D * sizeof(bf16) + 4 * kRows * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_dkv_tc_kernel<D><<<dim3(bh, t / kRows), kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), t, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int bh, int t, int d) {
  return bh <= 0 || bh > 65535 || t <= 0 || t % kBlk != 0 || (d != 64 && d != 128);
}

}  // namespace

// q, k, v, o: [bh, t, d] contiguous, bfloat16 (is_bf16 = 1: the tensor-core
// kernel) or float32 (the CUDA-core kernel); lse float32 [bh, t].  t a
// multiple of 64, d 64 or 128.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int tcdp_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                              int bh, int t, int d, int is_bf16, float scale, void* stream) {
  if (bad_shape(bh, t, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)  // the tensor cores
    return d == 64 ? launch_fwd_tc<64>(q, k, v, o, lse, bh, t, scale, s)
                   : launch_fwd_tc<128>(q, k, v, o, lse, bh, t, scale, s);
  return d == 64 ? launch_fwd<float, 64>(q, k, v, o, lse, bh, t, scale, s)
                 : launch_fwd<float, 128>(q, k, v, o, lse, bh, t, scale, s);
}

// dout and dq in the input type; lse, delta float32 [bh, t].  bf16 on the
// tensor cores, float32 on the CUDA cores.
extern "C" int tcdp_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dq, int bh, int t,
                             int d, int is_bf16, float scale, void* stream) {
  if (bad_shape(bh, t, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)  // the tensor cores
    return d == 64 ? launch_dq_tc<64>(q, k, v, dout, lse, delta, dq, bh, t, scale, s)
                   : launch_dq_tc<128>(q, k, v, dout, lse, delta, dq, bh, t, scale, s);
  return d == 64 ? launch_dq<float, 64>(q, k, v, dout, lse, delta, dq, bh, t, scale, s)
                 : launch_dq<float, 128>(q, k, v, dout, lse, delta, dq, bh, t, scale, s);
}

// dk, dv in the input type; bf16 on the tensor cores, float32 on the CUDA cores.
extern "C" int tcdp_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* delta, void* dk, void* dv, int bh,
                              int t, int d, int is_bf16, float scale, void* stream) {
  if (bad_shape(bh, t, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)  // the tensor cores
    return d == 64 ? launch_dkv_tc<64>(q, k, v, dout, lse, delta, dk, dv, bh, t, scale, s)
                   : launch_dkv_tc<128>(q, k, v, dout, lse, delta, dk, dv, bh, t, scale, s);
  return d == 64
             ? launch_dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv, bh, t, scale, s)
             : launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, bh, t, scale, s);
}
