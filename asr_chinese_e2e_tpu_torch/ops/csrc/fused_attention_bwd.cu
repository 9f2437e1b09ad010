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
// row, and W is recomputed from Q, K and the row log-sum-exp that the
// forward kernel saved (W_ij = exp(s_ij - lse_i)). Masks (key length,
// causal, band, rectangular) and the keep mask use global indices and the
// same hash of (i, j, seed, b*H + h) as the forward, so each tile drops
// exactly the weights the forward dropped.
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
// tile's lse and D rows beside them in pass 3. Pass 2 computes S and dP and
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
// Precondition of recomputing W from lse (both designs): every query row
// below q_len sees a key. A row that sees none (a band, and the row more
// than the band past k_len) has every score at -1e9, where f32 absorbs the
// log Tk of its log-sum-exp, so its W would come back as 1 instead of
// 1 / Tk. The wrapper (ops/fused_attention.py) refuses such lengths before
// it launches; self-attention with q_len = k_len has no such row.
//
// f32 inputs (the float instantiations of attention_bwd_dkdv_kernel and
// attention_bwd_dq_kernel, the 1e-4 bound) keep the first design on plain
// f32 FMAs: 256 threads per 64 owned rows, four threads sharing a row, the
// other side in 32-row f32 tiles, partial dot products combined by two warp
// shuffles. Their bf16 instantiations are built only under
// asr_attention_bwd_fma, for timing the two designs side by side.

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
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int* __restrict__ q_len,
                          const int* __restrict__ k_len, T* __restrict__ dk,
                          T* __restrict__ dv, Params p) {
  constexpr int DR = D / 4;
  __shared__ float Qs[TILE][D + 1];
  __shared__ float Gs[TILE][D + 1];  // dO rows
  __shared__ float Ls[TILE];
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
      Ls[threadIdx.x] = i < qn ? lse[bh * p.Tq + i] : 0.0f;
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
      s = s * p.scale + (key_visible(i, j, kn, p.causal, p.band) ? 0.0f : NEG_BIAS);
      const float w = expf(s - Ls[ii]);
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
                        const float* __restrict__ lse,
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
  const float li = active ? lse[bh * p.Tq + i] : 0.0f;
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
      s = s * p.scale + (key_visible(i, j, kn, p.causal, p.band) ? 0.0f : NEG_BIAS);
      const float w = expf(s - li);
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
           const void* dout, const float* lse, const int* q_len,
           const int* k_len, float* delta, void* dq, void* dk, void* dv,
           int B, const Params& p, cudaStream_t stream) {
  const int rows = B * p.H * p.Tq;
  attention_bwd_dot_kernel<T><<<(rows + 7) / 8, 256, 0, stream>>>(
      (const T*)out, (const T*)dout, delta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 kgrid((p.Tk + ROWS - 1) / ROWS, p.H, B);
  attention_bwd_dkdv_kernel<T, D><<<kgrid, THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, q_len,
      k_len, (T*)dk, (T*)dv, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 qgrid((p.Tq + ROWS - 1) / ROWS, p.H, B);
  attention_bwd_dq_kernel<T, D><<<qgrid, THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, q_len,
      k_len, (T*)dq, p);
  return (int)cudaGetLastError();
}

// -- bf16 on the tensor cores ---------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 owned rows

// Query tiles [lo, hi) that the key block [j0, j0 + 64) has to visit. Rows
// at or past qn weigh 0, and a masked key weighs exp(-1e9 - lse_i) = 0
// exactly because row i sees a key (the precondition above). So a block of
// keys past kn has nothing to do, and the others only meet the rows of
// their window.
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
  lo = first / asr::ATT_TILE;
  hi = (last + asr::ATT_TILE - 1) / asr::ATT_TILE;
}

// this warp's 16 rows of a 16 x D f32 result, times ``mul``, through its own
// rows of a shared tile and out as 16-byte stores; rows at or past ``limit``
// are not written
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float mul,
                                           __nv_bfloat16* stage, __nv_bfloat16* dst,
                                           int r0, int limit, int lane) {
  constexpr int LD = D + asr::ATT_PAD;
  constexpr int CPR = D / 8;
  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      *reinterpret_cast<__nv_bfloat162*>(&stage[(g + 8 * r) * LD + dn * 8 + 2 * t4]) =
          __floats2bfloat162_rn(acc[dn][2 * r] * mul, acc[dn][2 * r + 1] * mul);
    }
  }
  __syncwarp();
  for (int c = lane; c < 16 * CPR; c += 32) {
    const int r = c / CPR;
    const int cc = c - r * CPR;
    if (r0 + r < limit)
      *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * D + cc * 8) =
          *reinterpret_cast<const uint4*>(&stage[r * LD + cc * 8]);
  }
}

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(MMA_THREADS)
attention_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
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
  __shared__ __align__(16) float Ls[2][ATT_TILE];
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
  const float* lb = lse + bh * p.Tq;
  const float* db = delta + bh * p.Tq;
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

  // Q and dO rows at or past qn are zero-filled, with their lse and D
  auto load_tile = [&](int st, int t) {
    load_tile_async<D, MMA_THREADS>(Qs[st], qb, t * ATT_TILE, qn, tid);
    load_tile_async<D, MMA_THREADS>(Gs[st], gb, t * ATT_TILE, qn, tid);
    if (tid < ATT_TILE) {
      const int i = t * ATT_TILE + tid;
      const bool ok = i < qn;
      cp_async4(&Ls[st][tid], lb + (ok ? i : 0), ok);
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
      float sT[NT][4], dpT[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[nt][e] = dpT[nt][e] = 0.0f;
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
          const float s = sT[nt][e] * p.scale + (seen ? 0.0f : NEG_BIAS);
          const float w = exp_sub(s, -Ls[st][ii] * LOG2E);
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

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(MMA_THREADS)
attention_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ out,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
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

  // this warp's 16 query rows: Q and dO as A fragments, their lse, and
  // D_i = dO_i . O_i summed over the same fragment layout and written for
  // pass 3; rows at or past qn are padded: W = 0, dq = 0
  uint32_t qf[KS][4], gf[KS][4];
  float li[2], di[2] = {0.0f, 0.0f};
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    load_a_fragment<D>(qf[ks], q + bh * p.Tq * D, iw, qn, ks, lane);
    load_a_fragment<D>(gf[ks], dout + bh * p.Tq * D, iw, qn, ks, lane);
    uint32_t of[4];
    load_a_fragment<D>(of, out + bh * p.Tq * D, iw, qn, ks, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 o2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&of[e]));
      const float2 g2 =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gf[ks][e]));
      di[e & 1] = fmaf(o2.x, g2.x, fmaf(o2.y, g2.y, di[e & 1]));
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    di[r] += __shfl_xor_sync(0xffffffffu, di[r], 1);
    di[r] += __shfl_xor_sync(0xffffffffu, di[r], 2);
    const bool active = irow[r] < qn;
    li[r] = active ? -lse[bh * p.Tq + irow[r]] * LOG2E : 0.0f;  // for exp_sub
    if (active && t4 == 0) delta[bh * p.Tq + irow[r]] = di[r];
  }
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.0f;

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
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
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
          const float sc = s[nt][e] * p.scale + (seen ? 0.0f : NEG_BIAS);
          const float w = exp_sub(sc, li[e >> 1]);
          float keep = 1.0f;
          if (DROPOUT)
            keep = keep_hash((uint32_t)i, (uint32_t)j, p.seed, cell) >= p.threshold
                       ? p.inv_keep : 0.0f;
          dp[nt][e] = w * (dp[nt][e] * keep - di[e >> 1]);
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

template <int D, bool DROPOUT>
int launch_mma(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, const int* q_len,
               const int* k_len, float* delta, void* dq, void* dk, void* dv,
               int B, const Params& p, cudaStream_t stream) {
  using T = __nv_bfloat16;
  dim3 qgrid((p.Tq + asr::ATT_TILE - 1) / asr::ATT_TILE, p.H, B);
  attention_bwd_dq_mma_kernel<D, DROPOUT><<<qgrid, MMA_THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)out, (const T*)dout, lse,
      delta, q_len, k_len, (T*)dq, p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 kgrid((p.Tk + asr::ATT_TILE - 1) / asr::ATT_TILE, p.H, B);
  attention_bwd_dkdv_mma_kernel<D, DROPOUT><<<kgrid, MMA_THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, q_len,
      k_len, (T*)dk, (T*)dv, p);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out, dout, dq: (B, H, Tq, D); k, v, dk, dv: (B, H, Tk, D); all
// contiguous, bf16 (is_bf16=1) or f32. lse: (B, H, Tq) f32 from the forward
// kernel; delta: (B, H, Tq) f32 scratch; q_len/k_len: (B,) int32 on the
// device. bf16 runs on the tensor cores, f32 on FMAs. Returns the first
// launch error, cudaErrorInvalidValue for a head dim without an
// instantiation, or 0.
#define ASR_ATTN_BWD_PARAMS                                                   \
  const Params p{H, Tq, Tk, scale, seed, threshold, 1.0f / keep_prob,          \
                 dropout, causal, band}
#define ASR_ATTN_BWD_ARGS                                                     \
  q, k, v, out, dout, lse, q_len, k_len, delta, dq, dk, dv, B, p,              \
      (cudaStream_t)stream

extern "C" int asr_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* out, const void* dout,
                                 const float* lse, const int* q_len,
                                 const int* k_len, float* delta, void* dq,
                                 void* dk, void* dv, int B, int H, int Tq,
                                 int Tk, int D, int is_bf16, float scale,
                                 unsigned int seed, unsigned int threshold,
                                 float keep_prob, int dropout, int causal,
                                 int band, void* stream) {
  ASR_ATTN_BWD_PARAMS;
  // the tensor-core kernels have the dropout switch at compile time
  if (D == 64) {
    if (!is_bf16) return launch<float, 64>(ASR_ATTN_BWD_ARGS);
    return dropout ? launch_mma<64, true>(ASR_ATTN_BWD_ARGS)
                   : launch_mma<64, false>(ASR_ATTN_BWD_ARGS);
  }
  if (D == 32) {
    if (!is_bf16) return launch<float, 32>(ASR_ATTN_BWD_ARGS);
    return dropout ? launch_mma<32, true>(ASR_ATTN_BWD_ARGS)
                   : launch_mma<32, false>(ASR_ATTN_BWD_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}

// The FMA design for both input types: what bf16 calls ran before the
// tensor-core kernels. Nothing in the package calls it; it is built so that
// the two designs can be timed side by side in one process.
extern "C" int asr_attention_bwd_fma(const void* q, const void* k, const void* v,
                                     const void* out, const void* dout,
                                     const float* lse, const int* q_len,
                                     const int* k_len, float* delta, void* dq,
                                     void* dk, void* dv, int B, int H, int Tq,
                                     int Tk, int D, int is_bf16, float scale,
                                     unsigned int seed, unsigned int threshold,
                                     float keep_prob, int dropout, int causal,
                                     int band, void* stream) {
  ASR_ATTN_BWD_PARAMS;
  if (D == 64)
    return is_bf16 ? launch<__nv_bfloat16, 64>(ASR_ATTN_BWD_ARGS)
                   : launch<float, 64>(ASR_ATTN_BWD_ARGS);
  if (D == 32)
    return is_bf16 ? launch<__nv_bfloat16, 32>(ASR_ATTN_BWD_ARGS)
                   : launch<float, 32>(ASR_ATTN_BWD_ARGS);
  return (int)cudaErrorInvalidValue;
}
#undef ASR_ATTN_BWD_ARGS
#undef ASR_ATTN_BWD_PARAMS
