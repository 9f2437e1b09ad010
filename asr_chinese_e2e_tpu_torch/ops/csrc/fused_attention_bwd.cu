// Fused masked attention backward with in-kernel index-hash weight dropout.
//
// Replaces the TPU kernel asr_chinese_e2e_tpu/ops/fused_attention.py::
// _bwd_kernel (launched by _vjp_bwd through _call_kernel). With W the
// masked row softmax (padded query rows zeroed), M the keep mask scaled by
// 1/(1-rate) and O = (W o M) V the forward output:
//   dV = (W o M)^T dO,  dW = (dO V^T) o M,
//   dS = W o (dW - rowsum(dW o W)),  dQ = dS K scale,  dK = dS^T Q scale.
// rowsum(dW o W) = rowsum(dO o O) (because O = (W o M) V), so the kernel
// never needs a whole score row: D_i = dO_i . O_i is precomputed per query
// row, and W is recomputed from Q, K and the row statistics that the
// forward kernel saved, the row max m_i and log-sum log l_i apart
// (W_ij = exp(s_ij - m_i) / l_i, as exp((s_ij - m_i) - log l_i), the
// scores rounded as the forward rounds them). Masks (key length,
// causal, band, rectangular) and the keep mask use global indices and the
// same hash of (i, j, seed, b*H + h) as the forward, so each tile drops
// exactly the weights the forward dropped.
// A bf16 O has lost up to 2^-9 of each value, and D with it: at the
// streaming training shape under a causal band 50 with dropout 0.1 that
// alone put dk at 2.24e-2 against the 2e-2 bound (1.08e-2 with D from f32).
// So the bf16 forward also writes what the rounding took away as a second
// bf16 array, out_lo, and D_i = dO_i . (O_i + O_lo_i): as good as from f32
// for 2 bytes per element more, and no second sweep over the keys.
//
// What bounds it on the H100, at the flagship's training shape (64, 8, 267,
// 64) bf16: q, k, v, o, dO read and dq, dk, dv written once are 8 x 17.5 MB
// = 140.0 MB, 41.8 us at 3.35 TB/s; the five products are 23.4 GFLOP, 23.6
// us at the 989 TFLOP/s of the bf16 tensor cores, but 349 us at the 67
// TFLOP/s of f32 FMAs (and this design computes S and dP in both passes:
// seven products). The TPU kernel recomputes the whole (Tq, Tk) f32 tile in
// VMEM; a block here cannot hold it (285 KB at T = 267), so the work is
// tiled, and bytes bound it only if the products run on the tensor cores.
//
// Passes on the caller's stream, deterministic, no atomics:
//  1. D_i = sum_d dO_id O_id per query row.
//  2. dQ per (b, h, 64 queries), looping over 64-key tiles of K and V.
//  3. dK, dV per (b, h, 64 keys), looping over 64-query tiles of Q and dO.
// The bf16 route fuses pass 1 into pass 2 (two launches); the f32 route
// launches all three, dK/dV before dQ.
//
// bf16 inputs (attention_bwd_dkdv_mma_kernel, attention_bwd_dq_mma_kernel):
// tensor cores through mma.sync.m16n8k16 with ldmatrix, 4 warps per block,
// a warp owning 16 of the block's 64 rows (the reasons are those of
// fused_attention_fwd.cu). The owned rows' operands (K and V, or Q and dO)
// are read once from device memory straight into A fragments in registers;
// the other side's tiles stay bf16 in shared memory (rows padded by 16
// bytes), fetched by 16-byte cp.async into a ring of two stages, with the
// tile's row statistics and D beside them in pass 3. Pass 2 computes S and dP and
// feeds dS to dQ += dS K; pass 3 computes the transposed tiles S^T = K Q^T
// and dP^T = V dO^T, so that the accumulators of (W o M)^T and dS^T are
// already the A fragments of dV += (W o M)^T dO and dK += dS^T Q.
// Mask, bias, exp, hash and the dS formula run on the accumulators at each
// element's global (i, j). W o M and dS are f32 and the mma wants bf16:
// each is split into hi + lo bf16 parts and its product made twice,
// exact to 2^-17 (one rounding costs 2^-9 of a gradient that reaches 6 at
// the training shape, where the outputs' own rounding already takes up to
// 1.56e-2 of the 2e-2 bound). Tiles of the other side are skipped where
// every weight in them is exactly 0: padded query rows; keys past the key
// length; tiles outside the causal or band window (see query_tile_range).
// Within a tile no element is tested against qn or Tk: rows past them are
// zero-filled operands, so their weights, whatever they are, add zeros.
// The per-element work left (mask compares, one ex2.approx, the hash, the
// hi/lo split) bounds both passes, as in the forward; the dropout switch is
// a template parameter. Outputs leave through shared memory as 16-byte
// stores.
//
// A query row that sees no key (a band, and the row more than the band
// past k_len) has every score at the -1e9 bias, s_ij - m_i = 0 exactly,
// and so W_ij = 1 / l_i = 1 / Tk on every key, as the TPU kernel computes
// it; from a single log-sum-exp, where f32 absorbs the log Tk, it would
// come back as 1. Such rows weigh keys past k_len too, so the dK/dV pass
// visits them from every key block (query_tile_range).
//
// f32 inputs (the float instantiations of attention_bwd_dkdv_kernel and
// attention_bwd_dq_kernel, the 1e-4 bound) keep the first design on plain
// f32 FMAs: 256 threads per 64 owned rows, four threads sharing a row, the
// other side in 32-row f32 tiles, partial dot products combined by two warp
// shuffles (the templates are instantiated for float only).
//
// Relative positions (K12, the RELPOS instantiation of both tensor-core
// passes, built into a library of its own from relpos/): the score carries
// the positional term pos[h, b, i, T - 1 - i + j] of K11
// (fused_attention_fwd.cu), which seeds the score accumulators in both
// passes as it does in the forward. The dQ pass, which holds dS_ij in
// registers, also writes its gradient, dS_ij scale, to dpos[h, b, i, T - 1
// - i + j] in bf16 (the caller zeroes dpos; tiles a block skips have dS =
// 0): the GEMMs of (q + v_bias) p^T take it from there. dpos is (H, B, T,
// 2T - 1), heads first, so that the gradient of p, a sum over the batch and
// the rows, is one batched GEMM over (B T) per head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int ROWS = 64;     // rows owned by a block (keys for dK/dV, queries for dQ)
constexpr int TILE = 32;     // rows of the other side staged per step
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

template <typename T>
__global__ void attention_bwd_dot_kernel(const T* __restrict__ out,
                                         const T* __restrict__ dout,
                                         float* __restrict__ delta, int rows,
                                         int D) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = out + (size_t)row * D;
  const T* g = dout + (size_t)row * D;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(o[d]), to_f32(g[d]), acc);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

struct Params {
  int H, Tq, Tk;
  float scale;
  uint32_t seed, threshold;
  float inv_keep;
  int dropout, causal, band;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float2* __restrict__ stats,
                          const float* __restrict__ delta,
                          const int* __restrict__ q_len,
                          const int* __restrict__ k_len, T* __restrict__ dk,
                          T* __restrict__ dv, Params p) {
  constexpr int DR = D / 4;
  __shared__ float Qs[TILE][D + 1];
  __shared__ float Gs[TILE][D + 1];  // dO rows
  __shared__ float2 Ms[TILE];  // (max, log-sum) of the tile's rows
  __shared__ float Ds[TILE];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = threadIdx.x >> 2;
  const int r = threadIdx.x & 3;
  const int j0 = blockIdx.x * ROWS;
  const int j = j0 + row;
  const bool col_ok = j < p.Tk;
  const int qn = min(q_len[b], p.Tq);
  const int kn = k_len[b];
  const uint32_t cell = (uint32_t)(b * p.H + h);
  const size_t bh = (size_t)b * p.H + h;

  float kr[DR], vr[DR], dkr[DR], dvr[DR];
  const size_t krow = (bh * p.Tk + (col_ok ? j : 0)) * D;
#pragma unroll
  for (int dd = 0; dd < DR; ++dd) {
    kr[dd] = to_f32(k[krow + r + 4 * dd]);
    vr[dd] = to_f32(v[krow + r + 4 * dd]);
    dkr[dd] = 0.0f;
    dvr[dd] = 0.0f;
  }

  // keys wholly past k_len (no causal, no band) have zero weight everywhere
  const bool dead = !p.causal && p.band == 0 && j0 >= kn;
  const int n_tiles = dead ? 0 : (qn + TILE - 1) / TILE;
  const T* qb = q + bh * p.Tq * D;
  const T* gb = dout + bh * p.Tq * D;
  for (int t = 0; t < n_tiles; ++t) {
    const int i0 = t * TILE;
    __syncthreads();  // previous tile fully consumed
    for (int e = threadIdx.x; e < TILE * D; e += THREADS) {
      const int ii = e / D;
      const int d = e - ii * D;
      const bool in = i0 + ii < qn;
      Qs[ii][d] = in ? to_f32(qb[(size_t)(i0 + ii) * D + d]) : 0.0f;
      Gs[ii][d] = in ? to_f32(gb[(size_t)(i0 + ii) * D + d]) : 0.0f;
    }
    if (threadIdx.x < TILE) {
      const int i = i0 + threadIdx.x;
      Ms[threadIdx.x] = i < qn ? stats[bh * p.Tq + i] : make_float2(0.0f, 0.0f);
      Ds[threadIdx.x] = i < qn ? delta[bh * p.Tq + i] : 0.0f;
    }
    __syncthreads();

    const int n_rows = min(TILE, qn - i0);
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
      if (!col_ok) continue;
      s = fmaf(s, p.scale, key_visible(i, j, kn, p.causal, p.band) ? 0.0f : NEG_BIAS);
      const float w = expf((s - Ms[ii].x) - Ms[ii].y);
      float keep = 1.0f;
      if (p.dropout)
        keep = keep_hash((uint32_t)i, (uint32_t)j, p.seed, cell) >= p.threshold
                   ? p.inv_keep : 0.0f;
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
__global__ void __launch_bounds__(THREADS)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float2* __restrict__ stats,
                        const float* __restrict__ delta,
                        const int* __restrict__ q_len,
                        const int* __restrict__ k_len, T* __restrict__ dq,
                        Params p) {
  constexpr int DR = D / 4;
  __shared__ float Ks[TILE][D + 1];
  __shared__ float Vs[TILE][D + 1];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = threadIdx.x >> 2;
  const int r = threadIdx.x & 3;
  const int i = blockIdx.x * ROWS + row;
  const bool row_ok = i < p.Tq;
  const int qn = q_len[b];
  const int kn = k_len[b];
  const bool active = row_ok && i < qn;  // padded query rows: W = 0, dq = 0
  const uint32_t cell = (uint32_t)(b * p.H + h);
  const size_t bh = (size_t)b * p.H + h;

  float qr[DR], gr[DR], acc[DR];
  const size_t qrow = (bh * p.Tq + (row_ok ? i : 0)) * D;
#pragma unroll
  for (int dd = 0; dd < DR; ++dd) {
    qr[dd] = to_f32(q[qrow + r + 4 * dd]);
    gr[dd] = to_f32(dout[qrow + r + 4 * dd]);
    acc[dd] = 0.0f;
  }
  const float2 mi = active ? stats[bh * p.Tq + i] : make_float2(0.0f, 0.0f);
  const float di = active ? delta[bh * p.Tq + i] : 0.0f;

  int n_tiles = (p.Tk + TILE - 1) / TILE;
  if (!p.causal && p.band == 0) n_tiles = min(n_tiles, (kn + TILE - 1) / TILE);
  if (blockIdx.x * ROWS >= qn) n_tiles = 0;  // every row of the block is padded
  const T* kb = k + bh * p.Tk * D;
  const T* vb = v + bh * p.Tk * D;
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * TILE;
    __syncthreads();
    for (int e = threadIdx.x; e < TILE * D; e += THREADS) {
      const int jj = e / D;
      const int d = e - jj * D;
      const bool in = j0 + jj < p.Tk;
      Ks[jj][d] = in ? to_f32(kb[(size_t)(j0 + jj) * D + d]) : 0.0f;
      Vs[jj][d] = in ? to_f32(vb[(size_t)(j0 + jj) * D + d]) : 0.0f;
    }
    __syncthreads();

    const int n_keys = min(TILE, p.Tk - j0);
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
      if (!active) continue;
      s = fmaf(s, p.scale, key_visible(i, j, kn, p.causal, p.band) ? 0.0f : NEG_BIAS);
      const float w = expf((s - mi.x) - mi.y);
      float keep = 1.0f;
      if (p.dropout)
        keep = keep_hash((uint32_t)i, (uint32_t)j, p.seed, cell) >= p.threshold
                   ? p.inv_keep : 0.0f;
      const float ds = w * (dp * keep - di);
#pragma unroll
      for (int dd = 0; dd < DR; ++dd) acc[dd] = fmaf(ds, Ks[jj][r + 4 * dd], acc[dd]);
    }
  }

  if (row_ok) {
#pragma unroll
    for (int dd = 0; dd < DR; ++dd) dq[qrow + r + 4 * dd] = from_f32<T>(acc[dd] * p.scale);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float2* stats, const int* q_len,
           const int* k_len, float* delta, void* dq, void* dk, void* dv,
           int B, const Params& p, cudaStream_t stream) {
  const int rows = B * p.H * p.Tq;
  attention_bwd_dot_kernel<T><<<(rows + 7) / 8, 256, 0, stream>>>(
      (const T*)out, (const T*)dout, delta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 kgrid((p.Tk + ROWS - 1) / ROWS, p.H, B);
  attention_bwd_dkdv_kernel<T, D><<<kgrid, THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, stats, delta, q_len,
      k_len, (T*)dk, (T*)dv, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 qgrid((p.Tq + ROWS - 1) / ROWS, p.H, B);
  attention_bwd_dq_kernel<T, D><<<qgrid, THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, stats, delta, q_len,
      k_len, (T*)dq, p);
  return (int)cudaGetLastError();
}

// -- bf16 on the tensor cores ---------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 owned rows

// Query tiles [lo, hi) that the key block [j0, j0 + 64) has to visit. Rows
// at or past qn weigh 0, and a masked key weighs exp(-1e9 - m_i) = 0
// exactly where row i sees a key. So a block of keys past kn has nothing to
// do, and the others only meet the rows of their window; but the rows that
// see no key (a band, rows kn + band and on) weigh every key alike, so with
// such rows every key block visits them too.
__device__ __forceinline__ void query_tile_range(int j0, int qn, int kn,
                                                 const Params& p, int& lo, int& hi) {
  int first = 0, last = qn;  // query rows [first, last)
  if (j0 >= kn) {
    last = 0;
  } else {
    const int j_last = min(j0 + asr::ATT_TILE, kn) - 1;
    if (p.causal) {
      first = j0;
    } else if (p.band > 0) {
      first = max(0, j0 - p.band);
    }
    if (p.band > 0) last = min(qn, j_last + p.band + 1);
  }
  if (p.band > 0 && qn > kn + p.band) {  // rows [kn + band, qn) see no key
    if (last == 0) first = kn + p.band;
    last = qn;
  }
  lo = first / asr::ATT_TILE;
  hi = (last + asr::ATT_TILE - 1) / asr::ATT_TILE;
}

template <int D, bool DROPOUT, bool RELPOS>
__global__ void __launch_bounds__(MMA_THREADS)
attention_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ pos,
                              const __nv_bfloat16* __restrict__ dout,
                              const float2* __restrict__ stats,
                              const float* __restrict__ delta,
                              const int* __restrict__ q_len,
                              const int* __restrict__ k_len,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, Params p) {
  using namespace asr;
  constexpr int LD = D + ATT_PAD;
  constexpr int KS = D / 16;
  constexpr int DN = D / 8;
  constexpr int NT = ATT_TILE / 8;
  __shared__ __align__(16) __nv_bfloat16 Qs[2][ATT_TILE * LD];
  __shared__ __align__(16) __nv_bfloat16 Gs[2][ATT_TILE * LD];  // dO rows
  __shared__ __align__(16) float2 Ms[2][ATT_TILE];  // (max, log-sum) of the rows
  __shared__ __align__(16) float Ds[2][ATT_TILE];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int j0 = blockIdx.x * ATT_TILE;
  const int jw = j0 + warp * 16;  // this warp's first key
  const int qn = min(q_len[b], p.Tq);
  const int kn = min(k_len[b], p.Tk);
  const uint32_t cell = (uint32_t)(b * p.H + h);
  const size_t bh = (size_t)b * p.H + h;
  const __nv_bfloat16* qb = q + bh * p.Tq * D;
  const __nv_bfloat16* gb = dout + bh * p.Tq * D;
  const float2* mb = stats + bh * p.Tq;
  const float* db = delta + bh * p.Tq;
  const float scale2 = p.scale * LOG2E;  // the forward's scores, in units of log 2
  constexpr float NEG_BIAS2 = NEG_BIAS * LOG2E;
  const bool warp_on = jw < p.Tk;
  const int jrow[2] = {jw + g, jw + g + 8};
  // key r is seen by the query rows [ilo[r], ihi[r]]: key_visible, once per key
  const Window win = attention_window(p.causal, p.band);
  const int ilo[2] = {jrow[0] - win.above, jrow[1] - win.above};
  const int ihi[2] = {jrow[0] < kn ? jrow[0] + win.below : -1,
                      jrow[1] < kn ? jrow[1] + win.below : -1};

  // this warp's 16 keys: K and V as A fragments, once from device memory
  uint32_t kf[KS][4], vf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    load_a_fragment<D>(kf[ks], k + bh * p.Tk * D, jw, p.Tk, ks, lane);
    load_a_fragment<D>(vf[ks], v + bh * p.Tk * D, jw, p.Tk, ks, lane);
  }
  float dka[DN][4], dva[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dn][e] = dva[dn][e] = 0.0f;

  int t_lo, t_hi;
  query_tile_range(j0, qn, kn, p, t_lo, t_hi);
  // RELPOS: the term of (query i, key j) is pbase[i (2 Tk - 2) + j]
  const __nv_bfloat16* pbase = nullptr;
  if constexpr (RELPOS)
    pbase = pos + ((size_t)h * gridDim.z + b) * p.Tq * (2 * (size_t)p.Tk - 1) + (p.Tk - 1);

  // Q and dO rows at or past qn are zero-filled, with their statistics and D
  auto load_tile = [&](int st, int t) {
    load_tile_async<D, MMA_THREADS>(Qs[st], qb, t * ATT_TILE, qn, tid);
    load_tile_async<D, MMA_THREADS>(Gs[st], gb, t * ATT_TILE, qn, tid);
    if (tid < ATT_TILE) {
      const int i = t * ATT_TILE + tid;
      const bool ok = i < qn;
      cp_async8(&Ms[st][tid], mb + (ok ? i : 0), ok);
      cp_async4(&Ds[st][tid], db + (ok ? i : 0), ok);
    }
  };
  if (t_lo < t_hi) load_tile(0, t_lo);
  cp_async_commit();

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    if (t + 1 < t_hi) load_tile(st ^ 1, t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    if (warp_on) {
      const int i0 = t * ATT_TILE;
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 queries per warp
      // (RELPOS: S^T on top of the positional terms, as in the forward)
      float sT[NT][4], dpT[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sT[nt][e] = dpT[nt][e] = 0.0f;
          if constexpr (RELPOS) {
            const int i = i0 + nt * 8 + 2 * t4 + (e & 1);
            const int j = jrow[e >> 1];
            if (i < p.Tq && j < p.Tk)
              sT[nt][e] = __bfloat162float(pbase[(size_t)i * (2 * p.Tk - 2) + j]);
          }
        }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int off = (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + ks * 16 +
                          ((lane >> 3) & 1) * 8;
          uint32_t f[4];
          ldmatrix_x4(f, &Qs[st][off]);
          mma_bf16(sT[2 * np], kf[ks], f[0], f[1]);
          mma_bf16(sT[2 * np + 1], kf[ks], f[2], f[3]);
          ldmatrix_x4(f, &Gs[st][off]);
          mma_bf16(dpT[2 * np], vf[ks], f[0], f[1]);
          mma_bf16(dpT[2 * np + 1], vf[ks], f[2], f[3]);
        }
      }
      // (W o M)^T into sT, dS^T into dpT, at each element's global (i, j). A
      // query row at or past qn, or a key at or past Tk, needs no test: its
      // operand rows are zeros, so whatever finite weight it gets adds 0
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ii = nt * 8 + 2 * t4 + (e & 1);
          const int i = i0 + ii;
          const int j = jrow[e >> 1];
          const bool seen = i >= ilo[e >> 1] && i <= ihi[e >> 1];
          const float s = fmaf(sT[nt][e], scale2, seen ? 0.0f : NEG_BIAS2);
          const float2 ml = Ms[st][ii];
          const float w = ex2((s - ml.x) - ml.y);
          float keep = 1.0f;
          if (DROPOUT)
            keep = keep_hash((uint32_t)i, (uint32_t)j, p.seed, cell) >= p.threshold
                       ? p.inv_keep : 0.0f;
          sT[nt][e] = w * keep;
          dpT[nt][e] = w * (dpT[nt][e] * keep - Ds[st][ii]);
        }
      }
      // dV += (W o M)^T dO, dK += dS^T Q, each operand as hi + lo
#pragma unroll
      for (int ks = 0; ks < NT / 2; ++ks) {
        uint32_t whi[4], wlo[4], shi[4], slo[4];
        split_fragment(sT, ks, whi, wlo);
        split_fragment(dpT, ks, shi, slo);
        mma_split<D>(dva, whi, wlo, &Gs[st][ks * 16 * LD], lane);
        mma_split<D>(dka, shi, slo, &Qs[st][ks * 16 * LD], lane);
      }
    }
    __syncthreads();
  }

  if (!warp_on) return;
  store_rows<D>(dka, p.scale, Qs[0] + warp * 16 * LD, dk + bh * p.Tk * D, jw, p.Tk, lane);
  store_rows<D>(dva, 1.0f, Gs[0] + warp * 16 * LD, dv + bh * p.Tk * D, jw, p.Tk, lane);
}

template <int D, bool DROPOUT, bool RELPOS>
__global__ void __launch_bounds__(MMA_THREADS)
attention_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ pos,
                            __nv_bfloat16* __restrict__ dpos,
                            const __nv_bfloat16* __restrict__ out,
                            const __nv_bfloat16* __restrict__ out_lo,
                            const __nv_bfloat16* __restrict__ dout,
                            const float2* __restrict__ stats,
                            float* __restrict__ delta,
                            const int* __restrict__ q_len,
                            const int* __restrict__ k_len,
                            __nv_bfloat16* __restrict__ dq, Params p) {
  using namespace asr;
  constexpr int LD = D + ATT_PAD;
  constexpr int KS = D / 16;
  constexpr int DN = D / 8;
  constexpr int NT = ATT_TILE / 8;
  __shared__ __align__(16) __nv_bfloat16 Ks[2][ATT_TILE * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[2][ATT_TILE * LD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int i0 = blockIdx.x * ATT_TILE;
  const int iw = i0 + warp * 16;  // this warp's first query row
  const int qn = min(q_len[b], p.Tq);
  const int kn = min(k_len[b], p.Tk);
  const uint32_t cell = (uint32_t)(b * p.H + h);
  const size_t bh = (size_t)b * p.H + h;
  const __nv_bfloat16* kb = k + bh * p.Tk * D;
  const __nv_bfloat16* vb = v + bh * p.Tk * D;
  const bool warp_on = iw < p.Tq;
  const int irow[2] = {iw + g, iw + g + 8};
  // row r sees the keys [jlo[r], jhi[r]]: key_visible, once per row
  const Window win = attention_window(p.causal, p.band);
  const int jlo[2] = {irow[0] - win.below, irow[1] - win.below};
  const int jhi[2] = {min(irow[0] + win.above, kn - 1), min(irow[1] + win.above, kn - 1)};
  const float scale2 = p.scale * LOG2E;  // the forward's scores, in units of log 2
  constexpr float NEG_BIAS2 = NEG_BIAS * LOG2E;

  // this warp's 16 query rows: Q and dO as A fragments, their statistics, and
  // D_i = dO_i . O_i summed over the same fragment layout and written for
  // the dK/dV pass, with O = out + out_lo where the forward kept what the
  // rounding of out took away (from the bf16 output alone, dq and dk lose
  // up to half the bound they are held to); rows at or past qn are padded:
  // W = 0, dq = 0
  uint32_t qf[KS][4], gf[KS][4];
  float2 ml[2];
  float di[2] = {0.0f, 0.0f};
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    load_a_fragment<D>(qf[ks], q + bh * p.Tq * D, iw, qn, ks, lane);
    load_a_fragment<D>(gf[ks], dout + bh * p.Tq * D, iw, qn, ks, lane);
    uint32_t of[4], lf[4] = {0u, 0u, 0u, 0u};
    load_a_fragment<D>(of, out + bh * p.Tq * D, iw, qn, ks, lane);
    if (out_lo != nullptr) load_a_fragment<D>(lf, out_lo + bh * p.Tq * D, iw, qn, ks, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 o2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&of[e]));
      const float2 l2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lf[e]));
      const float2 g2 =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gf[ks][e]));
      di[e & 1] = fmaf(o2.x + l2.x, g2.x, fmaf(o2.y + l2.y, g2.y, di[e & 1]));
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    di[r] += __shfl_xor_sync(0xffffffffu, di[r], 1);
    di[r] += __shfl_xor_sync(0xffffffffu, di[r], 2);
    const bool active = irow[r] < qn;
    ml[r] = active ? stats[bh * p.Tq + irow[r]] : make_float2(0.0f, 0.0f);
    if (active && t4 == 0) delta[bh * p.Tq + irow[r]] = di[r];
  }
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.0f;

  // RELPOS: row r's positional terms and their gradient at [j]
  const __nv_bfloat16* prow[2] = {nullptr, nullptr};
  __nv_bfloat16* dprow[2] = {nullptr, nullptr};
  if constexpr (RELPOS) {
    const size_t R = 2 * (size_t)p.Tk - 1;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = min(irow[r], p.Tq - 1);
      const size_t at = ((size_t)h * gridDim.z + b) * p.Tq * R + (size_t)i * R + (p.Tk - 1 - i);
      prow[r] = pos + at;
      dprow[r] = dpos + at;
    }
  }

  int t_lo = 0, t_hi = 0;  // a block of padded rows visits no tile
  if (i0 < qn)
    key_tile_range(i0, min(i0 + ATT_TILE, qn) - 1, p.Tk, kn, p.causal, p.band, t_lo, t_hi);

  auto load_tile = [&](int st, int t) {
    load_tile_async<D, MMA_THREADS>(Ks[st], kb, t * ATT_TILE, p.Tk, tid);
    load_tile_async<D, MMA_THREADS>(Vs[st], vb, t * ATT_TILE, p.Tk, tid);
  };
  if (t_lo < t_hi) load_tile(0, t_lo);
  cp_async_commit();

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    if (t + 1 < t_hi) load_tile(st ^ 1, t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    if (warp_on) {
      const int j0 = t * ATT_TILE;
      // S = Q K^T and dP = dO V^T: 16 queries x 64 keys per warp
      // (RELPOS: S on top of the positional terms, as in the forward)
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = dp[nt][e] = 0.0f;
          if constexpr (RELPOS) {
            const int j = j0 + nt * 8 + 2 * t4 + (e & 1);
            if (j < p.Tk && irow[e >> 1] < p.Tq) s[nt][e] = __bfloat162float(prow[e >> 1][j]);
          }
        }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int off = (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + ks * 16 +
                          ((lane >> 3) & 1) * 8;
          uint32_t f[4];
          ldmatrix_x4(f, &Ks[st][off]);
          mma_bf16(s[2 * np], qf[ks], f[0], f[1]);
          mma_bf16(s[2 * np + 1], qf[ks], f[2], f[3]);
          ldmatrix_x4(f, &Vs[st][off]);
          mma_bf16(dp[2 * np], gf[ks], f[0], f[1]);
          mma_bf16(dp[2 * np + 1], gf[ks], f[2], f[3]);
        }
      }
      // dS into dp, at each element's global (i, j). A query row at or past
      // qn, or a key at or past Tk, needs no test: its operand rows are zeros
      // (and D_i with them), so whatever finite weight it gets adds 0
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = irow[e >> 1];
          const int j = j0 + nt * 8 + 2 * t4 + (e & 1);
          const bool seen = j >= jlo[e >> 1] && j <= jhi[e >> 1];
          const float sc = fmaf(s[nt][e], scale2, seen ? 0.0f : NEG_BIAS2);
          const float w = ex2((sc - ml[e >> 1].x) - ml[e >> 1].y);
          float keep = 1.0f;
          if (DROPOUT)
            keep = keep_hash((uint32_t)i, (uint32_t)j, p.seed, cell) >= p.threshold
                       ? p.inv_keep : 0.0f;
          dp[nt][e] = w * (dp[nt][e] * keep - di[e >> 1]);
          if constexpr (RELPOS) {
            if (j < p.Tk && i < p.Tq) dprow[e >> 1][j] = __float2bfloat16(dp[nt][e] * p.scale);
          }
        }
      }
      // dQ += dS K, dS as hi + lo
#pragma unroll
      for (int ks = 0; ks < NT / 2; ++ks) {
        uint32_t hi[4], lo[4];
        split_fragment(dp, ks, hi, lo);
        mma_split<D>(acc, hi, lo, &Ks[st][ks * 16 * LD], lane);
      }
    }
    __syncthreads();
  }

  if (!warp_on) return;
  store_rows<D>(acc, p.scale, Ks[0] + warp * 16 * LD, dq + bh * p.Tq * D, iw, p.Tq, lane);
}

template <int D, bool DROPOUT, bool RELPOS = false>
int launch_mma(const void* q, const void* k, const void* v, const void* out,
               const void* out_lo, const void* dout, const float2* stats, const int* q_len,
               const int* k_len, float* delta, void* dq, void* dk, void* dv,
               int B, const Params& p, cudaStream_t stream, const void* pos = nullptr,
               void* dpos = nullptr) {
  using T = __nv_bfloat16;
  dim3 qgrid((p.Tq + asr::ATT_TILE - 1) / asr::ATT_TILE, p.H, B);
  attention_bwd_dq_mma_kernel<D, DROPOUT, RELPOS><<<qgrid, MMA_THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)pos, (T*)dpos, (const T*)out,
      (const T*)out_lo, (const T*)dout, stats, delta, q_len, k_len, (T*)dq, p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 kgrid((p.Tk + asr::ATT_TILE - 1) / asr::ATT_TILE, p.H, B);
  attention_bwd_dkdv_mma_kernel<D, DROPOUT, RELPOS><<<kgrid, MMA_THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)pos, (const T*)dout, stats, delta,
      q_len, k_len, (T*)dk, (T*)dv, p);
  return (int)cudaGetLastError();
}

}  // namespace

#ifndef ASR_RELPOS_ENTRY
// q, out, dout, dq: (B, H, Tq, D); k, v, dk, dv: (B, H, Tk, D); all
// contiguous, bf16 (is_bf16=1) or f32. out_lo: (B, H, Tq, D) bf16 from the
// forward kernel (what the rounding of a bf16 ``out`` took away), or null,
// and unused for f32. stats: (B, H, Tq, 2) f32 row (max, log-sum) from the
// forward kernel; delta: (B, H, Tq) f32 scratch; q_len/k_len: (B,) int32 on the
// device. bf16 runs on the tensor cores, f32 on FMAs. Returns the first
// launch error, cudaErrorInvalidValue for a head dim without an
// instantiation, or 0.
#define ASR_ATTN_BWD_PARAMS                                                   \
  const Params p{H, Tq, Tk, scale, seed, threshold, 1.0f / keep_prob,          \
                 dropout, causal, band}
#define ASR_ATTN_BWD_ARGS                                                     \
  q, k, v, out, dout, (const float2*)stats, q_len, k_len, delta, dq, dk, dv, B,  \
      p,                                                                       \
      (cudaStream_t)stream
#define ASR_ATTN_BWD_MMA_ARGS                                                 \
  q, k, v, out, out_lo, dout, (const float2*)stats, q_len, k_len, delta, dq,   \
      dk, dv, B, p,                                                            \
      (cudaStream_t)stream

extern "C" int asr_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* out, const void* out_lo,
                                 const void* dout, const float* stats,
                                 const int* q_len, const int* k_len,
                                 float* delta, void* dq,
                                 void* dk, void* dv, int B, int H, int Tq,
                                 int Tk, int D, int is_bf16, float scale,
                                 unsigned int seed, unsigned int threshold,
                                 float keep_prob, int dropout, int causal,
                                 int band, void* stream) {
  ASR_ATTN_BWD_PARAMS;
  // the tensor-core kernels have the dropout switch at compile time
  if (D == 64) {
    if (!is_bf16) return launch<float, 64>(ASR_ATTN_BWD_ARGS);
    return dropout ? launch_mma<64, true>(ASR_ATTN_BWD_MMA_ARGS)
                   : launch_mma<64, false>(ASR_ATTN_BWD_MMA_ARGS);
  }
  if (D == 32) {
    if (!is_bf16) return launch<float, 32>(ASR_ATTN_BWD_ARGS);
    return dropout ? launch_mma<32, true>(ASR_ATTN_BWD_MMA_ARGS)
                   : launch_mma<32, false>(ASR_ATTN_BWD_MMA_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}

#undef ASR_ATTN_BWD_MMA_ARGS
#undef ASR_ATTN_BWD_ARGS
#undef ASR_ATTN_BWD_PARAMS
#else
// K12: q, k, v, out, out_lo, dout, dq, dk, dv: (B, H, T, D) bf16, contiguous;
// pos: (H, B, T, 2T - 1) bf16, K11's positional terms; dpos: like pos, zeroed
// by the caller, receives their gradient; stats, delta, q_len/k_len as
// asr_attention_bwd takes them (no causal mask, no band, no weight dropout).
// Returns the first launch error, cudaErrorInvalidValue for a head dim
// without an instantiation, or 0.
extern "C" int asr_relpos_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* pos, const void* out,
                                        const void* out_lo, const void* dout,
                                        const float* stats, const int* q_len,
                                        const int* k_len, float* delta, void* dq,
                                        void* dk, void* dv, void* dpos, int B, int H,
                                        int T, int D, float scale, void* stream) {
  const Params p{H, T, T, scale, 0u, 0u, 1.0f, 0, 0, 0};
  const float2* st = (const float2*)stats;
  if (D == 64)
    return launch_mma<64, false, true>(q, k, v, out, out_lo, dout, st, q_len, k_len, delta, dq,
                                       dk, dv, B, p, (cudaStream_t)stream, pos, dpos);
  if (D == 32)
    return launch_mma<32, false, true>(q, k, v, out, out_lo, dout, st, q_len, k_len, delta, dq,
                                       dk, dv, B, p, (cudaStream_t)stream, pos, dpos);
  return (int)cudaErrorInvalidValue;
}
#endif
