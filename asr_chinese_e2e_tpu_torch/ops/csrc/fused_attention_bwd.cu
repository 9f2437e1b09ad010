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
// What bounds it on the H100: the TPU kernel recomputes the whole (Tq, Tk)
// f32 tile in VMEM; here a block cannot hold it (285 KB at T = 267). At the
// flagship's training shapes (B=64, H=8, T=267, D=64) a call is ~4.7 GFMA
// over ~35 MB of q/k/v/o/dO, so it is compute-bound; this first version runs
// on plain f32 FMAs and is bound by their issue rate and the shared-memory
// loads that feed them. mma/wgmma and TMA are later work.
//
// Design: three launches on the caller's stream.
//  1. D_i = sum_d dO_id O_id, one warp per query row.
//  2. dK, dV: one block of 256 threads per (b, h, 64 keys). Four threads
//     share a key row, each holding an interleaved quarter of its k and v
//     in registers; 32-query tiles of Q and dO are staged in shared memory.
//     Per (i, j) the four partial dot products (q.k and dO.v) are combined
//     with two warp shuffles each, then every thread accumulates its quarter
//     of dK and dV. Query rows past q_len have W = 0 and are skipped.
//  3. dQ: the same layout over query rows, looping over 32-key tiles of K
//     and V; key tiles past k_len are skipped where that is exact (no
//     causal, no band, k_len >= 1).
// Two passes over the scores instead of atomics keep the result
// deterministic. All arithmetic is f32; dq, dk and dv are written in the
// input type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

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

}  // namespace

// q, out, dout, dq: (B, H, Tq, D); k, v, dk, dv: (B, H, Tk, D); all
// contiguous, bf16 (is_bf16=1) or f32. lse: (B, H, Tq) f32 from the forward
// kernel; delta: (B, H, Tq) f32 scratch; q_len/k_len: (B,) int32 on the
// device. Returns the first launch error, cudaErrorInvalidValue for a head
// dim without an instantiation, or 0.
extern "C" int asr_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* out, const void* dout,
                                 const float* lse, const int* q_len,
                                 const int* k_len, float* delta, void* dq,
                                 void* dk, void* dv, int B, int H, int Tq,
                                 int Tk, int D, int is_bf16, float scale,
                                 unsigned int seed, unsigned int threshold,
                                 float keep_prob, int dropout, int causal,
                                 int band, void* stream) {
  const Params p{H, Tq, Tk, scale, seed, threshold, 1.0f / keep_prob,
                 dropout, causal, band};
  cudaStream_t st = (cudaStream_t)stream;
#define ASR_ATTN_BWD_CASE(TYPE, DIM)                                         \
  return launch<TYPE, DIM>(q, k, v, out, dout, lse, q_len, k_len, delta, dq, \
                           dk, dv, B, p, st)
  if (D == 64) {
    if (is_bf16) ASR_ATTN_BWD_CASE(__nv_bfloat16, 64);
    ASR_ATTN_BWD_CASE(float, 64);
  }
  if (D == 32) {
    if (is_bf16) ASR_ATTN_BWD_CASE(__nv_bfloat16, 32);
    ASR_ATTN_BWD_CASE(float, 32);
  }
#undef ASR_ATTN_BWD_CASE
  return (int)cudaErrorInvalidValue;
}
