// Windowed causal-band attention, forward (K6) and backward (K7), with
// in-kernel index-hash weight dropout.
//
// Replaces the TPU kernels asr_chinese_e2e_tpu/ops/fused_attention.py::
// _banded_fwd_kernel and _banded_bwd_kernel (with _banded_tile,
// _keep_mask_idx, and the host-side dK/dV shift-add of _banded_bwd),
// launched through _call_banded when ASR_BANDED_WINDOW=1. Causal band w:
// query qg sees key kg when kg < n, kg <= qg and qg - kg <= w; rows with
// qg >= n are zeroed (n = the key length, the one length the JAX route
// passes). Queries come in blocks of BQ = 64 * ceil(w / 64) rows, so the
// keys of query block c lie in the window [(c-1) BQ, (c+1) BQ); the keep
// mask hashes the GLOBAL (qg, kg, seed, b*H + h), so this route drops
// exactly the weights the full-tile kernels (K1/K2) drop.
//
// What bounds it on the H100: at the streaming model's training shape
// (B=64, H=8, T<=267, D=64, w=50) a query row has at most w+1 visible keys
// of T, so the windowed kernels do about (w + 64) / T of the full tile's
// score work. Like K1/K2 this first version runs on plain f32 FMAs, one
// shared-memory load per FMA; mma/wgmma and TMA are later work.
//
// Design. Every kernel owns 64 rows per block with 4 threads per row (256
// threads), and stages 32-row tiles of the other side in shared memory, as
// K1/K2 do; shared memory does not grow with the band. A 64-row query tile
// lies inside one query block c (BQ is a multiple of 64), and the kernel
// computes its key range in place: the window of block c cut to [0, n) and
// to the band of the tile's rows, [r0 - w, r0 + 64). Key tiles outside it
// hold only masked weights, which are exactly 0, so skipping them is exact.
//  K6: two passes over the key range. Pass 1 takes each row's max and sum
//   of exp (online, over 32-key tiles; masked keys get -1e9 added, as the
//   TPU kernel does). Pass 2 recomputes the scores, forms the normalised
//   weight, applies the keep mask and accumulates (W o M) V in f32. The TPU
//   kernel rounds W o M to the value type first, because its matrix unit
//   takes bf16 operands; on f32 FMAs that rounding saves nothing, and with
//   it the bf16 output was 2.08e-2 off the f32 plain version at the
//   streaming training shape with dropout 0.1 on the H100. It writes the
//   row log-sum-exp for K7 when asked.
//  K7: the TPU kernel writes dK/dV for blocks c-1 and c per query block and
//   the host shift-adds four (B, H, T, D) arrays. Here each gradient is
//   written once, with no atomics, deterministically:
//   1. a dQ pass per 64-query tile over its key range. With dP = dO V^T and
//      dS = W o (dP o M - D), D_i = rowsum(dP o M o W), it accumulates
//      sum_j W M dP K_j, sum_j W K_j and D_i in one sweep and writes
//      dQ = scale (first - D_i second), and D_i for pass 2. D_i comes from
//      the f32 weights, not from dO . O as in K2: in the bf16 path O is
//      rounded to bf16, and that rounding put dK about 1e-2 off the f32
//      plain version at the streaming training shape on the H100;
//   2. a dK/dV pass per 64-key tile over the query rows that can see it:
//      query blocks c and c+1 of its key block c, cut to [0, n) and to the
//      band [j0, j0 + 64 + w).
//   Scores are recomputed from Q, K and K6's log-sum-exp; padded query rows
//   (qg >= n) are skipped. dS and W o M stay f32 in the bf16 path, as in
//   K2 and for the reason of K6's pass 2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int QT = 64;       // rows owned by a block
constexpr int KT = 32;       // rows of the other side staged per step
constexpr int THREADS = 256; // 4 threads per owned row
constexpr float NEG_BIAS = -1e9f;

using asr::from_f32;
using asr::keep_hash;
using asr::key_visible;
using asr::to_f32;

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return x;
}

struct Params {
  int H, T;
  float scale;
  uint32_t seed, threshold;
  float inv_keep;
  int dropout, band, bq;
};

// keep-mask factor of weight (i, j): 0 or 1/(1-rate)
__device__ __forceinline__ float keep_factor(int i, int j, uint32_t cell,
                                             const Params& p) {
  if (!p.dropout) return 1.0f;
  return keep_hash((uint32_t)i, (uint32_t)j, p.seed, cell) >= p.threshold
             ? p.inv_keep : 0.0f;
}

// keys [lo, hi) that the query tile [r0, r0 + QT) may see: the window
// [(c-1) BQ, (c+1) BQ) of its query block c = r0 / BQ, cut to [0, n), to
// the key axis and to the band of the tile's rows
__device__ __forceinline__ void key_range(int r0, int n, const Params& p,
                                          int* lo, int* hi) {
  const int c = r0 / p.bq;
  *lo = max(max((c - 1) * p.bq, 0), r0 - p.band);
  *hi = min(min((c + 1) * p.bq, n), min(r0 + QT, p.T));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
banded_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ len,
                  T* __restrict__ out, float* __restrict__ lse, Params p) {
  static_assert(D % 4 == 0, "D must be a multiple of 4");
  constexpr int DR = D / 4;  // output columns per thread
  __shared__ float Ks[KT][D + 1];
  __shared__ float Vs[KT][D];
  __shared__ float Ps[QT][KT + 1];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = threadIdx.x >> 2;
  const int r = threadIdx.x & 3;
  const int r0 = blockIdx.x * QT;
  const int i = r0 + row;
  const bool row_ok = i < p.T;
  const int n = len[b];
  const bool live = row_ok && i < n;  // rows past n are zeroed
  const uint32_t cell = (uint32_t)(b * p.H + h);
  const size_t bh = (size_t)b * p.H + h;
  const T* kb = k + bh * p.T * D;
  const T* vb = v + bh * p.T * D;

  float qr[D];
  const T* qrow = q + (bh * p.T + (row_ok ? i : 0)) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = to_f32(qrow[d]);

  int lo, hi;
  key_range(r0, n, p, &lo, &hi);
  const int n_tiles = hi > lo ? (hi - lo + KT - 1) / KT : 0;

  // pass 1: row max and sum of exp over the key range
  float m_run = -INFINITY;
  float l_run = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = lo + t * KT;
    __syncthreads();  // previous tile fully consumed
    for (int e = threadIdx.x; e < KT * D; e += THREADS) {
      const int jj = e / D;
      const int d = e - jj * D;
      Ks[jj][d] = j0 + jj < hi ? to_f32(kb[(size_t)(j0 + jj) * D + d]) : 0.0f;
    }
    __syncthreads();
    float s[KT / 4];
    float tile_max = -INFINITY;
#pragma unroll
    for (int u = 0; u < KT / 4; ++u) {
      const int jl = r + 4 * u;
      const int j = j0 + jl;
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], Ks[jl][d], acc);
      // past the range: not a key; key j0 is always in it, so the max is finite
      const float sc = j >= hi ? -INFINITY
                               : acc * p.scale +
                                     (key_visible(i, j, n, 1, p.band) ? 0.0f : NEG_BIAS);
      s[u] = sc;
      tile_max = fmaxf(tile_max, sc);
    }
    tile_max = quad_max(tile_max);
    const float m_new = fmaxf(m_run, tile_max);
    float psum = 0.0f;
#pragma unroll
    for (int u = 0; u < KT / 4; ++u) psum += expf(s[u] - m_new);
    l_run = l_run * expf(m_run - m_new) + quad_sum(psum);
    m_run = m_new;
  }

  // pass 2: normalised weights, keep mask, (W o M) V in f32
  const float inv_l = l_run > 0.0f ? 1.0f / l_run : 0.0f;
  float o[DR];
#pragma unroll
  for (int dd = 0; dd < DR; ++dd) o[dd] = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = lo + t * KT;
    __syncthreads();
    for (int e = threadIdx.x; e < KT * D; e += THREADS) {
      const int jj = e / D;
      const int d = e - jj * D;
      const bool in = j0 + jj < hi;
      Ks[jj][d] = in ? to_f32(kb[(size_t)(j0 + jj) * D + d]) : 0.0f;
      Vs[jj][d] = in ? to_f32(vb[(size_t)(j0 + jj) * D + d]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < KT / 4; ++u) {
      const int jl = r + 4 * u;
      const int j = j0 + jl;
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], Ks[jl][d], acc);
      float w = 0.0f;
      if (live && j < hi && key_visible(i, j, n, 1, p.band)) {
        w = expf(acc * p.scale - m_run) * inv_l * keep_factor(i, j, cell, p);
      }
      Ps[row][jl] = w;
    }
    __syncwarp();  // the row's four threads share Ps[row]
    for (int jl = 0; jl < KT; ++jl) {
      const float w = Ps[row][jl];
#pragma unroll
      for (int dd = 0; dd < DR; ++dd) o[dd] = fmaf(w, Vs[jl][r + 4 * dd], o[dd]);
    }
  }

  if (row_ok) {
    T* orow = out + (bh * p.T + i) * D;
#pragma unroll
    for (int dd = 0; dd < DR; ++dd) orow[r + 4 * dd] = from_f32<T>(o[dd]);
    if (lse != nullptr && r == 0)
      lse[bh * p.T + i] = l_run > 0.0f ? m_run + logf(l_run) : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
banded_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const int* __restrict__ len,
                     float* __restrict__ delta, T* __restrict__ dq, Params p) {
  constexpr int DR = D / 4;
  __shared__ float Ks[KT][D + 1];
  __shared__ float Vs[KT][D + 1];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = threadIdx.x >> 2;
  const int r = threadIdx.x & 3;
  const int r0 = blockIdx.x * QT;
  const int i = r0 + row;
  const bool row_ok = i < p.T;
  const int n = len[b];
  const bool live = row_ok && i < n;  // rows past n: W = 0, dq = 0
  const uint32_t cell = (uint32_t)(b * p.H + h);
  const size_t bh = (size_t)b * p.H + h;

  // per row: sum_j W M dP K_j, sum_j W K_j (this thread's columns) and D_i
  float qr[DR], gr[DR], acc_g[DR], acc_w[DR];
  const size_t qrow = (bh * p.T + (row_ok ? i : 0)) * D;
#pragma unroll
  for (int dd = 0; dd < DR; ++dd) {
    qr[dd] = to_f32(q[qrow + r + 4 * dd]);
    gr[dd] = to_f32(dout[qrow + r + 4 * dd]);
    acc_g[dd] = 0.0f;
    acc_w[dd] = 0.0f;
  }
  float di = 0.0f;  // the same in the row's four threads
  const float li = live ? lse[bh * p.T + i] : 0.0f;

  int lo, hi;
  key_range(r0, n, p, &lo, &hi);
  const int n_tiles = hi > lo ? (hi - lo + KT - 1) / KT : 0;
  const T* kb = k + bh * p.T * D;
  const T* vb = v + bh * p.T * D;
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = lo + t * KT;
    __syncthreads();
    for (int e = threadIdx.x; e < KT * D; e += THREADS) {
      const int jj = e / D;
      const int d = e - jj * D;
      const bool in = j0 + jj < hi;
      Ks[jj][d] = in ? to_f32(kb[(size_t)(j0 + jj) * D + d]) : 0.0f;
      Vs[jj][d] = in ? to_f32(vb[(size_t)(j0 + jj) * D + d]) : 0.0f;
    }
    __syncthreads();
    const int n_keys = min(KT, hi - j0);
    for (int jj = 0; jj < n_keys; ++jj) {
      const int j = j0 + jj;
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int dd = 0; dd < DR; ++dd) {
        s = fmaf(qr[dd], Ks[jj][r + 4 * dd], s);
        dp = fmaf(gr[dd], Vs[jj][r + 4 * dd], dp);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      if (!live || !key_visible(i, j, n, 1, p.band)) continue;
      const float w = expf(s * p.scale - li);
      const float wg = w * dp * keep_factor(i, j, cell, p);  // W o dW
      di += wg;
#pragma unroll
      for (int dd = 0; dd < DR; ++dd) {
        acc_g[dd] = fmaf(wg, Ks[jj][r + 4 * dd], acc_g[dd]);
        acc_w[dd] = fmaf(w, Ks[jj][r + 4 * dd], acc_w[dd]);
      }
    }
  }

  if (row_ok) {
    if (r == 0) delta[bh * p.T + i] = di;  // 0 on rows past n
#pragma unroll
    for (int dd = 0; dd < DR; ++dd)
      dq[qrow + r + 4 * dd] = from_f32<T>((acc_g[dd] - di * acc_w[dd]) * p.scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
banded_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const int* __restrict__ len, T* __restrict__ dk,
                       T* __restrict__ dv, Params p) {
  constexpr int DR = D / 4;
  __shared__ float Qs[KT][D + 1];
  __shared__ float Gs[KT][D + 1];  // dO rows
  __shared__ float Ls[KT];
  __shared__ float Ds[KT];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = threadIdx.x >> 2;
  const int r = threadIdx.x & 3;
  const int j0 = blockIdx.x * QT;
  const int j = j0 + row;
  const bool col_ok = j < p.T;
  const int n = len[b];
  const uint32_t cell = (uint32_t)(b * p.H + h);
  const size_t bh = (size_t)b * p.H + h;

  float kr[DR], vr[DR], dkr[DR], dvr[DR];
  const size_t krow = (bh * p.T + (col_ok ? j : 0)) * D;
#pragma unroll
  for (int dd = 0; dd < DR; ++dd) {
    kr[dd] = to_f32(k[krow + r + 4 * dd]);
    vr[dd] = to_f32(v[krow + r + 4 * dd]);
    dkr[dd] = 0.0f;
    dvr[dd] = 0.0f;
  }

  // query rows whose windows hold this key tile: query blocks c and c+1 of
  // its key block c, cut to the valid rows [0, n) and to the band
  const int c = j0 / p.bq;
  const int qlo = max(c * p.bq, j0);
  const int qhi = min(min((c + 2) * p.bq, n), min(j0 + QT + p.band, p.T));
  const int n_tiles = qhi > qlo ? (qhi - qlo + KT - 1) / KT : 0;
  const T* qb = q + bh * p.T * D;
  const T* gb = dout + bh * p.T * D;
  for (int t = 0; t < n_tiles; ++t) {
    const int i0 = qlo + t * KT;
    __syncthreads();  // previous tile fully consumed
    for (int e = threadIdx.x; e < KT * D; e += THREADS) {
      const int ii = e / D;
      const int d = e - ii * D;
      const bool in = i0 + ii < qhi;
      Qs[ii][d] = in ? to_f32(qb[(size_t)(i0 + ii) * D + d]) : 0.0f;
      Gs[ii][d] = in ? to_f32(gb[(size_t)(i0 + ii) * D + d]) : 0.0f;
    }
    if (threadIdx.x < KT) {
      const int i = i0 + threadIdx.x;
      Ls[threadIdx.x] = i < qhi ? lse[bh * p.T + i] : 0.0f;
      Ds[threadIdx.x] = i < qhi ? delta[bh * p.T + i] : 0.0f;
    }
    __syncthreads();

    const int n_rows = min(KT, qhi - i0);
    for (int ii = 0; ii < n_rows; ++ii) {
      const int i = i0 + ii;
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int dd = 0; dd < DR; ++dd) {
        s = fmaf(Qs[ii][r + 4 * dd], kr[dd], s);
        dp = fmaf(Gs[ii][r + 4 * dd], vr[dd], dp);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      if (!col_ok || !key_visible(i, j, n, 1, p.band)) continue;
      const float w = expf(s * p.scale - Ls[ii]);
      const float keep = keep_factor(i, j, cell, p);
      const float wm = w * keep;
      const float ds = w * (dp * keep - Ds[ii]);
#pragma unroll
      for (int dd = 0; dd < DR; ++dd) {
        dvr[dd] = fmaf(wm, Gs[ii][r + 4 * dd], dvr[dd]);
        dkr[dd] = fmaf(ds, Qs[ii][r + 4 * dd], dkr[dd]);
      }
    }
  }

  if (col_ok) {
#pragma unroll
    for (int dd = 0; dd < DR; ++dd) {
      dk[krow + r + 4 * dd] = from_f32<T>(dkr[dd] * p.scale);
      dv[krow + r + 4 * dd] = from_f32<T>(dvr[dd]);
    }
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const int* len,
               void* out, float* lse, int B, const Params& p,
               cudaStream_t stream) {
  dim3 grid((p.T + QT - 1) / QT, p.H, B);
  banded_fwd_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, len, (T*)out, lse, p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const int* len, float* delta, void* dq,
               void* dk, void* dv, int B, const Params& p,
               cudaStream_t stream) {
  dim3 grid((p.T + QT - 1) / QT, p.H, B);
  // the dQ pass writes delta, which the dK/dV pass reads (same stream)
  banded_bwd_dq_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, len, delta,
      (T*)dq, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  banded_bwd_dkdv_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, len,
      (T*)dk, (T*)dv, p);
  return (int)cudaGetLastError();
}

bool bad_band(int band, int bq) {
  return band < 1 || bq < band || bq % QT != 0;
}

}  // namespace

// q, k, v, out: (B, H, T, D), contiguous, bf16 (is_bf16=1) or f32; len:
// (B,) int32 on the device; lse: (B, H, T) f32 row log-sum-exp output, or
// null. band >= 1, bq = 64 * ceil(band / 64). Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a head dim without an
// instantiation or a bad band.
extern "C" int asr_banded_attention_fwd(const void* q, const void* k,
                                        const void* v, const int* len,
                                        void* out, float* lse, int B, int H,
                                        int T, int D, int is_bf16, float scale,
                                        unsigned int seed,
                                        unsigned int threshold,
                                        float keep_prob, int dropout, int band,
                                        int bq, void* stream) {
  if (bad_band(band, bq)) return (int)cudaErrorInvalidValue;
  const Params p{H, T, scale, seed, threshold, 1.0f / keep_prob, dropout, band, bq};
  cudaStream_t st = (cudaStream_t)stream;
#define ASR_BANDED_FWD_CASE(TYPE, DIM) \
  return launch_fwd<TYPE, DIM>(q, k, v, len, out, lse, B, p, st)
  if (D == 64) {
    if (is_bf16) ASR_BANDED_FWD_CASE(__nv_bfloat16, 64);
    ASR_BANDED_FWD_CASE(float, 64);
  }
  if (D == 32) {
    if (is_bf16) ASR_BANDED_FWD_CASE(__nv_bfloat16, 32);
    ASR_BANDED_FWD_CASE(float, 32);
  }
#undef ASR_BANDED_FWD_CASE
  return (int)cudaErrorInvalidValue;
}

// q, k, v, dout, dq, dk, dv: (B, H, T, D), contiguous, bf16 or f32;
// lse: (B, H, T) f32 from the forward kernel; delta: (B, H, T) f32 scratch;
// len: (B,) int32 on the device. Returns the first launch error,
// cudaErrorInvalidValue for a head dim without an instantiation or a bad
// band, or 0.
extern "C" int asr_banded_attention_bwd(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const float* lse, const int* len,
                                        float* delta, void* dq, void* dk,
                                        void* dv, int B, int H, int T,
                                        int D, int is_bf16, float scale,
                                        unsigned int seed,
                                        unsigned int threshold,
                                        float keep_prob, int dropout, int band,
                                        int bq, void* stream) {
  if (bad_band(band, bq)) return (int)cudaErrorInvalidValue;
  const Params p{H, T, scale, seed, threshold, 1.0f / keep_prob, dropout, band, bq};
  cudaStream_t st = (cudaStream_t)stream;
#define ASR_BANDED_BWD_CASE(TYPE, DIM)                                      \
  return launch_bwd<TYPE, DIM>(q, k, v, dout, lse, len, delta, dq, dk, dv, B, \
                               p, st)
  if (D == 64) {
    if (is_bf16) ASR_BANDED_BWD_CASE(__nv_bfloat16, 64);
    ASR_BANDED_BWD_CASE(float, 64);
  }
  if (D == 32) {
    if (is_bf16) ASR_BANDED_BWD_CASE(__nv_bfloat16, 32);
    ASR_BANDED_BWD_CASE(float, 32);
  }
#undef ASR_BANDED_BWD_CASE
  return (int)cudaErrorInvalidValue;
}
