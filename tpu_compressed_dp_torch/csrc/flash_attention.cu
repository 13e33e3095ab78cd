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
// the input type accumulate in float32 (a bf16 product is exact in float32,
// so the tiles are widened to float32 in shared memory); s = dot * scale; p is
// rounded to v's type before P.V; o = acc / l and dq/dk/dv are written in the
// input type; in the backward do is float32 (dp = do . v in float32, and
// dv += p^T do with p unrounded), and ds is rounded to the input type before
// ds . k and ds^T . q.  Sums run in another order than on the TPU, so the
// kernels agree with the plain versions to a tolerance, not bitwise.
//
// Design: one block of 256 threads per (64-row tile, batch-head); a 16 x 16
// thread grid, thread (ty, tx) owning rows ty + 16 i (i < 4) and columns
// tx + 16 j of every 64-wide tile, so shared-memory reads are consecutive
// across tx (conflict-free; tiles are stored with a row stride of D + 1).
// K/V (forward, dq) or Q/dO (dkv) tiles stream through shared memory one
// 64-row block at a time; per-row statistics (m, l, lse, delta) sit in shared
// memory; the score tile is reduced by rows one warp per 8 rows.  The tiles
// take 116 KB (forward), 149 KB (dq) and 166 KB (dkv) at D = 128, above the
// 48 KB default, so each launch raises the dynamic shared-memory limit.
//
// Bound: operations.  Causal attention does 2 T^2 D B H multiply-adds
// forward (half of the T x T products) and ~3.5x that backward; at the
// llama3_8b shape (1, 32, 8192, 128) that is 0.55 TFLOP forward, 0.56 ms at
// the bf16 tensor-core rate (989 TFLOP/s).  These kernels run on the fp32
// CUDA cores (67 TFLOP/s), with 8 shared-memory loads per 16 FMAs in the
// inner products: simple and right first; wgmma, TMA and warp specialisation
// are the way to the bound.

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

bool bad_shape(int bh, int t, int d) {
  return bh <= 0 || bh > 65535 || t <= 0 || t % kBlk != 0 || (d != 64 && d != 128);
}

}  // namespace

// q, k, v, o: [bh, t, d] contiguous, bfloat16 (is_bf16 = 1) or float32;
// lse float32 [bh, t].  t a multiple of 64, d 64 or 128.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int tcdp_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                              int bh, int t, int d, int is_bf16, float scale, void* stream) {
  if (bad_shape(bh, t, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return d == 64 ? launch_fwd<__nv_bfloat16, 64>(q, k, v, o, lse, bh, t, scale, s)
                   : launch_fwd<__nv_bfloat16, 128>(q, k, v, o, lse, bh, t, scale, s);
  return d == 64 ? launch_fwd<float, 64>(q, k, v, o, lse, bh, t, scale, s)
                 : launch_fwd<float, 128>(q, k, v, o, lse, bh, t, scale, s);
}

// dout and dq in the input type; lse, delta float32 [bh, t].
extern "C" int tcdp_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dq, int bh, int t,
                             int d, int is_bf16, float scale, void* stream) {
  if (bad_shape(bh, t, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return d == 64
               ? launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq, bh, t, scale, s)
               : launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq, bh, t, scale, s);
  return d == 64 ? launch_dq<float, 64>(q, k, v, dout, lse, delta, dq, bh, t, scale, s)
                 : launch_dq<float, 128>(q, k, v, dout, lse, delta, dq, bh, t, scale, s);
}

// dk, dv in the input type.
extern "C" int tcdp_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* delta, void* dk, void* dv, int bh,
                              int t, int d, int is_bf16, float scale, void* stream) {
  if (bad_shape(bh, t, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return d == 64 ? launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk, dv, bh, t,
                                                   scale, s)
                   : launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk, dv, bh, t,
                                                    scale, s);
  return d == 64
             ? launch_dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv, bh, t, scale, s)
             : launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, bh, t, scale, s);
}
