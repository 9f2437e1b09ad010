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
// (B=64, H=8, T<=267, D=64, w=50, bf16) K6 moves 70.0 MB (20.9 us at 3.35
// TB/s) and K7, which reads no forward output, 122.5 MB (36.6 us); the
// products over the visible pairs are 1.56 and 3.9 GFLOP, a few us on the
// bf16 tensor cores but 23 and 58 us on f32 FMAs. So bytes bound both only
// if the products run on the tensor cores, and what is then left per
// visible element (mask, ex2, hash, hi/lo split) decides the time, as in
// K1/K2: the design visits as few elements as the band allows.
//
// bf16 inputs (banded_fwd_mma_kernel, banded_bwd_dq_mma_kernel,
// banded_bwd_dkdv_mma_kernel): mma.sync.m16n8k16 with the building blocks
// of mma.cuh, one block of 4 warps per (b, h, 64 owned rows), a warp owning
// 16 rows, its operands read once from device memory straight into A
// fragments. What the window gives and K1/K2 cannot assume:
//  - The other side of a 64-row tile is small: keys [r0 - w, r0 + 64) for
//    query rows [r0, r0 + 64), query rows [j0, j0 + 64 + w) for keys [j0,
//    j0 + 64): 64 (ceil(w / 64) + 1) rows, two 64-row tiles for w <= 64.
//    All of them are requested by cp.async up front and stay resident in
//    (dynamic) shared memory: no ring, no second staging, one
//    __syncthreads before the arithmetic. Up to 12 tiles fit (w <= 704, or
//    any band when T <= 768); the entry point refuses more.
//  - A warp's 16 rows [rw, rw + 15] see keys [rw - w, rw + 15] only:
//    ceil(w / 16) + 1 groups of 16 keys, 5 of the tile pair's 8 at w = 50
//    for every warp (and 16 keys [jw, jw + 15] are seen by the query
//    groups of [jw, jw + 15 + w]). The other groups are skipped
//    warp-uniformly: no mma, no mask, no ex2, no hash, no split for them.
//    Blocks and warps wholly past the length n write zeros and stop.
//  - In K6 and in K7's dQ pass a warp holds CHUNK = 5 groups of scores in
//    accumulators at once (40 f32 per thread and product). For w <= 64
//    that is the whole visible row: K6 takes the exact row max and one ex2
//    per element, and its online (max, sum) update runs once, from the
//    empty state; the dQ pass has D_i = rowsum(dP o M o W) before it forms
//    dS, and needs the one product dQ += dS K. Wider bands (w > 64, BQ >=
//    128) take the same code with a loop over chunks: K6 carries the
//    online update from chunk to chunk, and the dQ pass sweeps its chunks
//    twice, first for D_i. The dK/dV pass sums along no row and takes one
//    group at a time: 162 registers for three blocks per SM, where five
//    groups took 238 for two (and 67 us against 56 at the training shape).
//  - No row below n is without a key on this route (row i sees key i), so
//    a masked score is not biased by -1e9 but takes no part: -inf in K6
//    (rows at or past n end with an empty sum and give zeros), weight 0 in
//    K7, which keeps a single log-sum-exp per row. Scores are kept in units of
//    log 2 and a weight is ex2 of a plain difference.
//  K6 feeds W o M to the PV product as hi + lo bf16 fragments from the
//  accumulators (exact to 2^-17); the TPU kernel rounds W o M to bf16
//  first, which on this card measured 2.08e-2 against the 2e-2 bound. It
//  writes the row log-sum-exp for K7 when asked.
//  K7 writes each gradient once, with no atomics and no shift-add (the TPU
//  kernel writes dK/dV for blocks c-1 and c per query block and the host
//  adds four (B, H, T, D) arrays):
//   1. the dQ pass per 64-query tile: S = Q K^T and dP = dO V^T on the
//      visible groups, W from K6's log-sum-exp, D_i from the f32 weights
//      (not dO . O as in K2: the bf16 rounding of O put dK 2.41e-2 off the
//      f32 plain version), dS = W o (dP o M - D) as hi + lo fragments into
//      dQ += dS K; D_i is written for pass 2;
//   2. the dK/dV pass per 64-key tile on transposed tiles: S^T = K Q^T and
//      dP^T = V dO^T with the owned keys' K and V as A fragments, so that
//      (W o M)^T and dS^T are the A fragments of dV += (W o M)^T dO and
//      dK += dS^T Q.
//  The dropout switch is a template parameter: the streaming recipe trains
//  with dropout 0 and pays nothing for the hash.
//
// f32 inputs (banded_fwd_kernel, banded_bwd_dq_kernel,
// banded_bwd_dkdv_kernel, instantiated for float only; the 1e-4 bound)
// keep the first design on plain f32 FMAs: 64 rows per block with 4 threads
// per row (256 threads), 32-row tiles of the other side staged as f32 in
// shared memory, the tile's key range computed in place (the window of its
// query block cut to [0, n) and to the band of its rows). K6 makes two
// passes over the key range (row max and sum of exp, with -1e9 on masked
// keys as the TPU kernel does; then the normalised weights, the keep mask
// and (W o M) V in f32); K7 a dQ pass that accumulates sum_j W M dP K_j,
// sum_j W K_j and D_i in one sweep, then a dK/dV pass over the query rows
// that can see the tile; padded query rows (qg >= n) are skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

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
  int tiles;  // 64-row tiles of the other side resident per block (tensor-core kernels)
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

// -- bf16 on the tensor cores ---------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 owned rows
constexpr int GROUP = 16;         // rows of the other side per step of the second product
constexpr int CHUNK = 5;          // groups a warp holds in accumulators at once
constexpr int MAX_TILES = 12;     // resident 64-row tiles that fit a block's shared memory
// what an entry point returns, before any launch, for a window of more tiles:
// no CUDA error code is negative, and the caller reads the limit from it
constexpr int WINDOW_TOO_WIDE = -MAX_TILES;

using bf16 = __nv_bfloat16;

// 64-row tiles of the other side a block can meet: ceil(w / 64) + 1, and no
// more than the axis holds
int resident_tiles(const Params& p) {
  return min(p.bq / asr::ATT_TILE + 1, (p.T + asr::ATT_TILE - 1) / asr::ATT_TILE);
}

// zeros into rows [r0, r0 + 64) below ``limit`` of a (rows, D) array
template <int D>
__device__ __forceinline__ void zero_rows(bf16* dst, int r0, int limit, int tid) {
  constexpr int CPR = D / 8;
  for (int c = tid; c < asr::ATT_TILE * CPR; c += MMA_THREADS) {
    const int r = r0 + c / CPR;
    if (r < limit)
      *reinterpret_cast<uint4*>(dst + (size_t)r * D + (c % CPR) * 8) = make_uint4(0, 0, 0, 0);
  }
}

// tiles [t_first, t_last] of a (rows, D) array into consecutive shared tiles
template <int D>
__device__ __forceinline__ void load_tiles_async(bf16* dst, const bf16* src, int t_first,
                                                 int t_last, int limit, int tid) {
  for (int t = t_first; t <= t_last; ++t)
    asr::load_tile_async<D, MMA_THREADS>(
        dst + (t - t_first) * asr::ATT_TILE * (D + asr::ATT_PAD), src, t * asr::ATT_TILE, limit,
        tid);
}

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(MMA_THREADS)
banded_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const int* __restrict__ len,
                      bf16* __restrict__ out, float* __restrict__ lse, Params p) {
  using namespace asr;
  constexpr int LD = D + ATT_PAD;
  constexpr int KS = D / 16;
  constexpr int DN = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + p.tiles * ATT_TILE * LD;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int r0 = blockIdx.x * ATT_TILE;
  const int n = min(len[b], p.T);
  const uint32_t cell = (uint32_t)(b * p.H + h);
  const size_t bh = (size_t)b * p.H + h;
  bf16* ob = out + bh * p.T * D;
  float* lb = lse != nullptr ? lse + bh * p.T : nullptr;

  if (r0 >= n) {  // every row of the block is past the length
    zero_rows<D>(ob, r0, p.T, tid);
    if (lb != nullptr && tid < ATT_TILE && r0 + tid < p.T) lb[r0 + tid] = 0.0f;
    return;
  }
  // the keys the block's rows see lie in the tiles [t_first, t_last]
  const int t_first = max(r0 - p.band, 0) / ATT_TILE;
  const int t_last = r0 / ATT_TILE;
  const int k0 = t_first * ATT_TILE;  // the key of shared row 0
  load_tiles_async<D>(Ks, k + bh * p.T * D, t_first, t_last, n, tid);
  load_tiles_async<D>(Vs, v + bh * p.T * D, t_first, t_last, n, tid);
  cp_async_commit();

  const int rw = r0 + warp * 16;  // this warp's first row
  const bool warp_on = rw < n;    // else it has only zeros to write
  const int irow[2] = {rw + g, rw + g + 8};
  // row r sees the keys [jlo[r], jhi[r]]; a row at or past n sees none
  const int jlo[2] = {irow[0] - p.band, irow[1] - p.band};
  const int jhi[2] = {irow[0] < n ? irow[0] : -1, irow[1] < n ? irow[1] : -1};
  const float scale2 = p.scale * LOG2E;  // scores in units of log 2

  uint32_t qf[KS][4];
  if (warp_on) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) load_a_fragment<D>(qf[ks], q + bh * p.T * D, rw, n, ks, lane);
  }
  float o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};

  cp_async_wait<0>();
  __syncthreads();

  if (warp_on) {
    // the 16-key groups [g_lo, g_hi] hold every key this warp's rows see
    const int g_lo = max(rw - p.band, 0) / GROUP;
    const int g_hi = rw / GROUP;
    for (int gc = g_lo; gc <= g_hi; gc += CHUNK) {
      const int ng = min(CHUNK, g_hi - gc + 1);
      const bf16* krows = Ks + (gc * GROUP - k0) * LD;
      const bf16* vrows = Vs + (gc * GROUP - k0) * LD;
      float s[2 * CHUNK][4];
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        if (u < ng) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[2 * u][e] = s[2 * u + 1][e] = 0.0f;
          mma_rows_t<D>(s[2 * u], s[2 * u + 1], qf, krows + u * GROUP * LD, lane);
        }
      }
      // mask on the accumulators; the row max over the quad
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        if (u < ng) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = (gc + u) * GROUP + nt * 8 + 2 * t4 + (e & 1);
              const bool seen = j >= jlo[e >> 1] && j <= jhi[e >> 1];
              const float sc = seen ? s[2 * u + nt][e] * scale2 : -INFINITY;
              s[2 * u + nt][e] = sc;
              mx[e >> 1] = fmaxf(mx[e >> 1], sc);
            }
          }
        }
      }
      float corr[2], base[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
        base[r] = m_new == -INFINITY ? 0.0f : m_new;  // a row that has seen no key yet
        corr[r] = ex2(m_run[r] - base[r]);            // 0 from the empty state
        m_run[r] = m_new;
      }
      // weights, their row sum, and the keep mask
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        if (u < ng) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float w = ex2(s[2 * u + nt][e] - base[e >> 1]);
              psum[e >> 1] += w;
              if (DROPOUT) {
                const int j = (gc + u) * GROUP + nt * 8 + 2 * t4 + (e & 1);
                const uint32_t x = keep_hash((uint32_t)irow[e >> 1], (uint32_t)j, p.seed, cell);
                w = x >= p.threshold ? w * p.inv_keep : 0.0f;
              }
              s[2 * u + nt][e] = w;
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + quad_sum(psum[r]);
      if (gc != g_lo) {  // bands over 64 only: the earlier chunks' share
#pragma unroll
        for (int dn = 0; dn < DN; ++dn)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[dn][e] *= corr[e >> 1];
      }
      // O += (W o M) V, the weights as hi + lo bf16 fragments
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        if (u < ng) {
          uint32_t hi[4], lo[4];
          split_fragment(s[2 * u], s[2 * u + 1], hi, lo);
          mma_split<D>(o, hi, lo, vrows + u * GROUP * LD, lane);
        }
      }
    }
  }

  __syncthreads();  // every warp is done with K: its first rows become the output stage
  if (rw >= p.T) return;
  float norm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool live = l_run[r] > 0.0f;  // rows at or past n: zeros
    norm[r] = live ? 1.0f / l_run[r] : 0.0f;
    if (lb != nullptr && t4 == 0 && irow[r] < p.T)
      lb[irow[r]] = live ? m_run[r] * LN2 + logf(l_run[r]) : 0.0f;
  }
  store_rows<D>(o, norm, Ks + warp * 16 * LD, ob, rw, p.T, lane);
}

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(MMA_THREADS)
banded_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const int* __restrict__ len,
                         float* __restrict__ delta, bf16* __restrict__ dq, Params p) {
  using namespace asr;
  constexpr int LD = D + ATT_PAD;
  constexpr int KS = D / 16;
  constexpr int DN = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + p.tiles * ATT_TILE * LD;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int r0 = blockIdx.x * ATT_TILE;
  const int n = min(len[b], p.T);
  const uint32_t cell = (uint32_t)(b * p.H + h);
  const size_t bh = (size_t)b * p.H + h;
  bf16* dqb = dq + bh * p.T * D;
  float* db = delta + bh * p.T;

  if (r0 >= n) {  // every row of the block is past the length: W = 0, dq = 0
    zero_rows<D>(dqb, r0, p.T, tid);
    if (tid < ATT_TILE && r0 + tid < p.T) db[r0 + tid] = 0.0f;
    return;
  }
  const int t_first = max(r0 - p.band, 0) / ATT_TILE;
  const int t_last = r0 / ATT_TILE;
  const int k0 = t_first * ATT_TILE;
  load_tiles_async<D>(Ks, k + bh * p.T * D, t_first, t_last, n, tid);
  load_tiles_async<D>(Vs, v + bh * p.T * D, t_first, t_last, n, tid);
  cp_async_commit();

  const int rw = r0 + warp * 16;
  const bool warp_on = rw < n;
  const int irow[2] = {rw + g, rw + g + 8};
  const int jlo[2] = {irow[0] - p.band, irow[1] - p.band};
  const int jhi[2] = {irow[0] < n ? irow[0] : -1, irow[1] < n ? irow[1] : -1};
  const float scale2 = p.scale * LOG2E;

  // this warp's 16 query rows: Q and dO as A fragments (zeros at or past n)
  // and minus their log-sum-exp in units of log 2
  uint32_t qf[KS][4], gf[KS][4];
  float nl2[2] = {0.0f, 0.0f};
  if (warp_on) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      load_a_fragment<D>(qf[ks], q + bh * p.T * D, rw, n, ks, lane);
      load_a_fragment<D>(gf[ks], dout + bh * p.T * D, rw, n, ks, lane);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (irow[r] < n) nl2[r] = -lse[bh * p.T + irow[r]] * LOG2E;
  }
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.0f;
  float di[2] = {0.0f, 0.0f};  // D_i = rowsum(dP o M o W), from the f32 weights

  cp_async_wait<0>();
  __syncthreads();

  if (warp_on) {
    const int g_lo = max(rw - p.band, 0) / GROUP;
    const int g_hi = rw / GROUP;
    const bool one_chunk = g_hi - g_lo < CHUNK;  // bands up to 64
    float w[2 * CHUNK][4], dw[2 * CHUNK][4];
    // W into w, dW = dP o M into dw, and this thread's share of D_i, for the
    // groups [gc, gc + ng)
    auto weights = [&](int gc, int ng, bool sum_d) {
      const bf16* krows = Ks + (gc * GROUP - k0) * LD;
      const bf16* vrows = Vs + (gc * GROUP - k0) * LD;
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        if (u < ng) {  // S = Q K^T and dP = dO V^T
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w[2 * u][e] = w[2 * u + 1][e] = dw[2 * u][e] = dw[2 * u + 1][e] = 0.0f;
          mma_rows_t<D>(w[2 * u], w[2 * u + 1], qf, krows + u * GROUP * LD, lane);
          mma_rows_t<D>(dw[2 * u], dw[2 * u + 1], gf, vrows + u * GROUP * LD, lane);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              const int j = (gc + u) * GROUP + nt * 8 + 2 * t4 + (e & 1);
              const bool seen = j >= jlo[r] && j <= jhi[r];
              const float wt = seen ? ex2(fmaf(w[2 * u + nt][e], scale2, nl2[r])) : 0.0f;
              if (DROPOUT)
                dw[2 * u + nt][e] *=
                    keep_hash((uint32_t)irow[r], (uint32_t)j, p.seed, cell) >= p.threshold
                        ? p.inv_keep : 0.0f;
              w[2 * u + nt][e] = wt;
              if (sum_d) di[r] = fmaf(wt, dw[2 * u + nt][e], di[r]);
            }
          }
        }
      }
    };
    if (!one_chunk) {  // bands over 64: a first sweep for D_i
      for (int gc = g_lo; gc <= g_hi; gc += CHUNK) weights(gc, min(CHUNK, g_hi - gc + 1), true);
    }
    for (int gc = g_lo; gc <= g_hi; gc += CHUNK) {
      const int ng = min(CHUNK, g_hi - gc + 1);
      weights(gc, ng, one_chunk);
      if (gc == g_lo) {
        di[0] = quad_sum(di[0]);
        di[1] = quad_sum(di[1]);
      }
      // dQ += dS K, dS = W o (dW - D) as hi + lo
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        if (u < ng) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dw[2 * u + nt][e] = w[2 * u + nt][e] * (dw[2 * u + nt][e] - di[e >> 1]);
          uint32_t hi[4], lo[4];
          split_fragment(dw[2 * u], dw[2 * u + 1], hi, lo);
          mma_split<D>(acc, hi, lo, Ks + ((gc + u) * GROUP - k0) * LD, lane);
        }
      }
    }
  }

  __syncthreads();  // every warp is done with K: its first rows become the output stage
  if (rw >= p.T) return;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (t4 == 0 && irow[r] < p.T) db[irow[r]] = di[r];  // 0 on rows at or past n
  store_rows<D>(acc, p.scale, Ks + warp * 16 * LD, dqb, rw, p.T, lane);
}

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(MMA_THREADS)
banded_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           const int* __restrict__ len, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, Params p) {
  using namespace asr;
  constexpr int LD = D + ATT_PAD;
  constexpr int KS = D / 16;
  constexpr int DN = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + p.tiles * ATT_TILE * LD;  // dO rows
  float* Ls = reinterpret_cast<float*>(Gs + p.tiles * ATT_TILE * LD);  // -lse log2 e
  float* Ds = Ls + p.tiles * ATT_TILE;                                  // D_i

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int j0 = blockIdx.x * ATT_TILE;
  const int n = min(len[b], p.T);
  const uint32_t cell = (uint32_t)(b * p.H + h);
  const size_t bh = (size_t)b * p.H + h;
  bf16* dkb = dk + bh * p.T * D;
  bf16* dvb = dv + bh * p.T * D;

  if (j0 >= n) {  // every key of the block is past the length: no row sees it
    zero_rows<D>(dkb, j0, p.T, tid);
    zero_rows<D>(dvb, j0, p.T, tid);
    return;
  }
  // the query rows that see the block's keys lie in the tiles [t_first, t_last]
  const int t_first = j0 / ATT_TILE;
  const int t_last = min(j0 + ATT_TILE - 1 + p.band, n - 1) / ATT_TILE;
  const int i0 = t_first * ATT_TILE;  // the query row of shared row 0
  load_tiles_async<D>(Qs, q + bh * p.T * D, t_first, t_last, n, tid);
  load_tiles_async<D>(Gs, dout + bh * p.T * D, t_first, t_last, n, tid);
  cp_async_commit();
  for (int x = tid; x < (t_last - t_first + 1) * ATT_TILE; x += MMA_THREADS) {
    const bool ok = i0 + x < n;
    Ls[x] = ok ? -lse[bh * p.T + i0 + x] * LOG2E : 0.0f;
    Ds[x] = ok ? delta[bh * p.T + i0 + x] : 0.0f;
  }

  const int jw = j0 + warp * 16;  // this warp's first key
  const bool warp_on = jw < n;
  const int jrow[2] = {jw + g, jw + g + 8};
  // key r is seen by the query rows [jrow[r], ihi[r]]; a key at or past n by none
  const int ihi[2] = {jrow[0] < n ? min(jrow[0] + p.band, n - 1) : -1,
                      jrow[1] < n ? min(jrow[1] + p.band, n - 1) : -1};
  const float scale2 = p.scale * LOG2E;

  // this warp's 16 keys: K and V as A fragments, once from device memory
  uint32_t kf[KS][4], vf[KS][4];
  if (warp_on) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      load_a_fragment<D>(kf[ks], k + bh * p.T * D, jw, n, ks, lane);
      load_a_fragment<D>(vf[ks], v + bh * p.T * D, jw, n, ks, lane);
    }
  }
  float dka[DN][4], dva[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dn][e] = dva[dn][e] = 0.0f;

  cp_async_wait<0>();
  __syncthreads();

  if (warp_on) {
    // the 16-row query groups [g_lo, g_hi] hold every row that sees this warp's
    // keys; one group at a time (no sum runs along a key's column but dK and dV)
    const int g_lo = jw / GROUP;
    const int g_hi = min(jw + 15 + p.band, n - 1) / GROUP;
    for (int gq = g_lo; gq <= g_hi; ++gq) {
      const bf16* qrows = Qs + (gq * GROUP - i0) * LD;
      const bf16* grows = Gs + (gq * GROUP - i0) * LD;
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 16 queries
      float sT[2][4], dpT[2][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[0][e] = sT[1][e] = dpT[0][e] = dpT[1][e] = 0.0f;
      mma_rows_t<D>(sT[0], sT[1], kf, qrows, lane);
      mma_rows_t<D>(dpT[0], dpT[1], vf, grows, lane);
      // (W o M)^T into sT, dS^T into dpT, at each element's global (i, j)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int ii = gq * GROUP + nt * 8 + 2 * t4;  // and ii + 1
        const float2 nl2 = *reinterpret_cast<const float2*>(&Ls[ii - i0]);
        const float2 d2 = *reinterpret_cast<const float2*>(&Ds[ii - i0]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = ii + (e & 1);
          const int r = e >> 1;
          const bool seen = i >= jrow[r] && i <= ihi[r];
          const float wt = seen ? ex2(fmaf(sT[nt][e], scale2, (e & 1) ? nl2.y : nl2.x)) : 0.0f;
          float keep = 1.0f;
          if (DROPOUT)
            keep = keep_hash((uint32_t)i, (uint32_t)jrow[r], p.seed, cell) >= p.threshold
                       ? p.inv_keep : 0.0f;
          sT[nt][e] = wt * keep;
          dpT[nt][e] = wt * (dpT[nt][e] * keep - ((e & 1) ? d2.y : d2.x));
        }
      }
      // dV += (W o M)^T dO, dK += dS^T Q, each operand as hi + lo
      uint32_t whi[4], wlo[4], shi[4], slo[4];
      split_fragment(sT[0], sT[1], whi, wlo);
      split_fragment(dpT[0], dpT[1], shi, slo);
      mma_split<D>(dva, whi, wlo, grows, lane);
      mma_split<D>(dka, shi, slo, qrows, lane);
    }
  }

  __syncthreads();  // every warp is done with Q and dO: their first rows become the stages
  if (jw >= p.T) return;
  store_rows<D>(dka, p.scale, Qs + warp * 16 * LD, dkb, jw, p.T, lane);
  store_rows<D>(dva, 1.0f, Gs + warp * 16 * LD, dvb, jw, p.T, lane);
}

// dynamic shared memory over 48 KB has to be asked for, per kernel
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D, bool DROPOUT>
int launch_fwd_mma(const void* q, const void* k, const void* v, const int* len,
                   void* out, float* lse, int B, const Params& p, cudaStream_t stream) {
  if (p.tiles > MAX_TILES) return WINDOW_TOO_WIDE;
  const size_t bytes = (size_t)p.tiles * 2 * asr::ATT_TILE * (D + asr::ATT_PAD) * sizeof(bf16);
  const cudaError_t err = allow_shared(banded_fwd_mma_kernel<D, DROPOUT>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.T + asr::ATT_TILE - 1) / asr::ATT_TILE, p.H, B);
  banded_fwd_mma_kernel<D, DROPOUT><<<grid, MMA_THREADS, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, len, (bf16*)out, lse, p);
  return (int)cudaGetLastError();
}

template <int D, bool DROPOUT>
int launch_bwd_mma(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const int* len, float* delta, void* dq,
                   void* dk, void* dv, int B, const Params& p, cudaStream_t stream) {
  if (p.tiles > MAX_TILES) return WINDOW_TOO_WIDE;
  const size_t tile_bytes = (size_t)2 * asr::ATT_TILE * (D + asr::ATT_PAD) * sizeof(bf16);
  const size_t dq_bytes = p.tiles * tile_bytes;
  const size_t dkdv_bytes = p.tiles * (tile_bytes + 2 * asr::ATT_TILE * sizeof(float));
  cudaError_t err = allow_shared(banded_bwd_dq_mma_kernel<D, DROPOUT>, dq_bytes);
  if (err != cudaSuccess) return (int)err;
  err = allow_shared(banded_bwd_dkdv_mma_kernel<D, DROPOUT>, dkdv_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.T + asr::ATT_TILE - 1) / asr::ATT_TILE, p.H, B);
  // the dQ pass writes delta, which the dK/dV pass reads (same stream)
  banded_bwd_dq_mma_kernel<D, DROPOUT><<<grid, MMA_THREADS, dq_bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse, len, delta,
      (bf16*)dq, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  banded_bwd_dkdv_mma_kernel<D, DROPOUT><<<grid, MMA_THREADS, dkdv_bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse, delta, len,
      (bf16*)dk, (bf16*)dv, p);
  return (int)cudaGetLastError();
}

bool bad_band(int band, int bq) {
  return band < 1 || bq < band || bq % QT != 0;
}

}  // namespace

// q, k, v, out: (B, H, T, D), contiguous, bf16 (is_bf16=1) or f32; len:
// (B,) int32 on the device; lse: (B, H, T) f32 row log-sum-exp output, or
// null. band >= 1, bq = 64 * ceil(band / 64). bf16 runs on the tensor cores,
// f32 on FMAs. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a head dim without an instantiation or a bad
// band, or (bf16) -MAX_TILES for a window of more resident tiles than that.
#define ASR_BANDED_PARAMS                                                      \
  Params p{H, T, scale, seed, threshold, 1.0f / keep_prob, dropout, band, bq, 0}; \
  p.tiles = resident_tiles(p);                                                 \
  cudaStream_t st = (cudaStream_t)stream

extern "C" int asr_banded_attention_fwd(const void* q, const void* k,
                                        const void* v, const int* len,
                                        void* out, float* lse, int B, int H,
                                        int T, int D, int is_bf16, float scale,
                                        unsigned int seed,
                                        unsigned int threshold,
                                        float keep_prob, int dropout, int band,
                                        int bq, void* stream) {
  if (bad_band(band, bq)) return (int)cudaErrorInvalidValue;
  ASR_BANDED_PARAMS;
  // the tensor-core kernels have the dropout switch at compile time
#define ASR_BANDED_FWD_CASE(DIM)                                               \
  if (!is_bf16) return launch_fwd<float, DIM>(q, k, v, len, out, lse, B, p, st); \
  return dropout ? launch_fwd_mma<DIM, true>(q, k, v, len, out, lse, B, p, st)  \
                 : launch_fwd_mma<DIM, false>(q, k, v, len, out, lse, B, p, st)
  if (D == 64) { ASR_BANDED_FWD_CASE(64); }
  if (D == 32) { ASR_BANDED_FWD_CASE(32); }
#undef ASR_BANDED_FWD_CASE
  return (int)cudaErrorInvalidValue;
}

// q, k, v, dout, dq, dk, dv: (B, H, T, D), contiguous, bf16 or f32;
// lse: (B, H, T) f32 from the forward kernel; delta: (B, H, T) f32 scratch;
// len: (B,) int32 on the device. Returns the first launch error,
// cudaErrorInvalidValue as the forward does, or 0.
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
  ASR_BANDED_PARAMS;
#define ASR_BANDED_BWD_ARGS q, k, v, dout, lse, len, delta, dq, dk, dv, B, p, st
#define ASR_BANDED_BWD_CASE(DIM)                                               \
  if (!is_bf16) return launch_bwd<float, DIM>(ASR_BANDED_BWD_ARGS);            \
  return dropout ? launch_bwd_mma<DIM, true>(ASR_BANDED_BWD_ARGS)              \
                 : launch_bwd_mma<DIM, false>(ASR_BANDED_BWD_ARGS)
  if (D == 64) { ASR_BANDED_BWD_CASE(64); }
  if (D == 32) { ASR_BANDED_BWD_CASE(32); }
#undef ASR_BANDED_BWD_CASE
#undef ASR_BANDED_BWD_ARGS
  return (int)cudaErrorInvalidValue;
}
#undef ASR_BANDED_PARAMS
