// Fused masked attention forward with in-kernel index-hash weight dropout.
//
// Replaces the TPU kernel asr_chinese_e2e_tpu/ops/fused_attention.py::
// _fwd_kernel (with _softmax_masked and _keep_mask), launched through
// _call_kernel. Per (b, h): S = Q K^T * scale, plus -1e9 where the key is
// masked (key length; optional causal, +-band or causal-band window, by
// global index), f32 row softmax, padded query rows zeroed, optional keep
// mask hashed from (i, j, seed, b*H + h) and scaled by 1/(1-rate), then
// (W o M) V. Inputs bf16 or f32, f32 accumulation, output in the input type.
//
// What bounds it on the H100: the TPU kernel keeps a whole (Tq, Tk) f32
// score tile in VMEM. A block has at most 227 KB of shared memory, and at
// the flagship's T = 267 that tile alone is 285 KB, so the kernel must be
// tiled. At serving shapes (B=8, H=8, T<=501, D=64) a call is 0.1-1 GFLOP
// over <= 4 MB of q/k/v, so it is compute- and latency-bound; this first
// version runs on plain f32 FMAs, and its limit is the shared-memory load
// throughput of the two inner products (one LDS per FMA). wgmma / mma.sync
// and TMA are later work.
//
// Design: one block of 256 threads per (b, h, tile of 64 query rows),
// flash-style. Four threads share a query row: each holds the whole q row
// in registers and scores every fourth key of a 32-key tile; the row max
// and sum are combined with two warp shuffles, and an online softmax
// carries (max, sum) across key tiles. Probabilities (times the keep mask)
// go through shared memory so that each of the four threads can accumulate
// its interleaved quarter of the D output columns. Masks and the dropout
// hash use global indices, so tiling masks and drops exactly the weights
// the untiled kernel does. Masked keys get -1e9 added (not -inf), as the
// TPU kernel does, so a row whose keys are all masked averages over Tk.
// Without causal/band, key tiles wholly past k_len are skipped: with
// k_len >= 1 (the wrapper requires it) their weights are exactly 0.
// For training, the kernel also writes each query row's log-sum-exp of
// its masked scores (``lse``, when the pointer is not null), which the
// backward kernels (fused_attention_bwd.cu) use to recompute the weights.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int QT = 64;       // query rows per block
constexpr int KT = 32;       // keys per tile
constexpr int THREADS = 256; // 4 threads per query row
constexpr float NEG_BIAS = -1e9f;

using asr::from_f32;
using asr::keep_hash;
using asr::to_f32;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ q_len,
                     const int* __restrict__ k_len, T* __restrict__ out,
                     float* __restrict__ lse,
                     int H, int Tq, int Tk, float scale, uint32_t seed,
                     uint32_t threshold, float keep_prob, int dropout,
                     int causal, int band) {
  static_assert(D % 4 == 0, "D must be a multiple of 4");
  constexpr int DR = D / 4;  // output columns per thread
  __shared__ float Ks[KT][D + 1];
  __shared__ float Vs[KT][D];
  __shared__ float Ps[QT][KT + 1];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = threadIdx.x >> 2;  // 0..63
  const int r = threadIdx.x & 3;     // quarter of the row group
  const int i = blockIdx.x * QT + row;
  const bool row_ok = i < Tq;
  const int qn = q_len[b];
  const int kn = k_len[b];
  const uint32_t cell = (uint32_t)(b * H + h);
  const size_t bh = (size_t)b * H + h;
  const T* kb = k + bh * Tk * D;
  const T* vb = v + bh * Tk * D;

  float qr[D];
  const T* qrow = q + (bh * Tq + (row_ok ? i : 0)) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = to_f32(qrow[d]);

  float o[DR];
#pragma unroll
  for (int dd = 0; dd < DR; ++dd) o[dd] = 0.0f;
  float m_run = -INFINITY;
  float l_run = 0.0f;
  const float inv_keep = 1.0f / keep_prob;

  int n_tiles = (Tk + KT - 1) / KT;
  if (!causal && band == 0) n_tiles = min(n_tiles, (kn + KT - 1) / KT);

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * KT;
    __syncthreads();  // previous tile fully consumed
    for (int e = threadIdx.x; e < KT * D; e += THREADS) {
      const int jj = e / D;
      const int d = e - jj * D;
      const bool in = j0 + jj < Tk;
      Ks[jj][d] = in ? to_f32(kb[(size_t)(j0 + jj) * D + d]) : 0.0f;
      Vs[jj][d] = in ? to_f32(vb[(size_t)(j0 + jj) * D + d]) : 0.0f;
    }
    __syncthreads();

    // scores of this thread's keys jl = r + 4*u
    float s[KT / 4];
    float tile_max = -INFINITY;
#pragma unroll
    for (int u = 0; u < KT / 4; ++u) {
      const int jl = r + 4 * u;
      const int j = j0 + jl;
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], Ks[jl][d], acc);
      float sc;
      if (j >= Tk) {
        sc = -INFINITY;  // past the key axis: not a key at all
      } else {
        const bool keep = asr::key_visible(i, j, kn, causal, band);
        sc = acc * scale + (keep ? 0.0f : NEG_BIAS);
      }
      s[u] = sc;
      tile_max = fmaxf(tile_max, sc);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m_run, tile_max);
    const float corr = expf(m_run - m_new);  // 0 on the first tile
    float psum = 0.0f;
#pragma unroll
    for (int u = 0; u < KT / 4; ++u) {
      const int jl = r + 4 * u;
      const float p = expf(s[u] - m_new);
      psum += p;
      float pk = p;
      if (dropout) {
        const uint32_t x = keep_hash((uint32_t)i, (uint32_t)(j0 + jl), seed, cell);
        pk = x >= threshold ? p * inv_keep : 0.0f;
      }
      Ps[row][jl] = pk;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_run = l_run * corr + psum;
    m_run = m_new;
    __syncwarp();  // the row's four threads share Ps[row]

#pragma unroll
    for (int dd = 0; dd < DR; ++dd) o[dd] *= corr;
    for (int jl = 0; jl < KT; ++jl) {
      const float p = Ps[row][jl];
#pragma unroll
      for (int dd = 0; dd < DR; ++dd) o[dd] = fmaf(p, Vs[jl][r + 4 * dd], o[dd]);
    }
  }

  if (row_ok) {
    const float norm = (i < qn) ? 1.0f / l_run : 0.0f;
    T* orow = out + (bh * Tq + i) * D;
#pragma unroll
    for (int dd = 0; dd < DR; ++dd) orow[r + 4 * dd] = from_f32<T>(o[dd] * norm);
    if (lse != nullptr && r == 0) lse[bh * Tq + i] = m_run + logf(l_run);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const int* q_len,
            const int* k_len, void* out, float* lse, int B, int H, int Tq,
            int Tk, float scale, uint32_t seed, uint32_t threshold, float keep_prob,
            int dropout, int causal, int band, cudaStream_t stream) {
  dim3 grid((Tq + QT - 1) / QT, H, B);
  attention_fwd_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, q_len, k_len, (T*)out, lse, H, Tq,
      Tk, scale, seed, threshold, keep_prob, dropout, causal, band);
}

}  // namespace

// q: (B, H, Tq, D), k/v: (B, H, Tk, D), out: (B, H, Tq, D), all contiguous,
// bf16 (is_bf16=1) or f32; q_len/k_len: (B,) int32 on the device; lse:
// (B, H, Tq) f32 row log-sum-exp output, or null.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a head dim without an instantiation.
extern "C" int asr_attention_fwd(const void* q, const void* k, const void* v,
                                 const int* q_len, const int* k_len, void* out,
                                 float* lse, int B, int H, int Tq, int Tk, int D,
                                 int is_bf16, float scale, unsigned int seed,
                                 unsigned int threshold, float keep_prob,
                                 int dropout, int causal, int band,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define ASR_ATTN_CASE(TYPE, DIM)                                            \
  launch<TYPE, DIM>(q, k, v, q_len, k_len, out, lse, B, H, Tq, Tk, scale,    \
                    seed, threshold, keep_prob, dropout, causal, band, st)
  if (D == 64) {
    if (is_bf16) ASR_ATTN_CASE(__nv_bfloat16, 64); else ASR_ATTN_CASE(float, 64);
  } else if (D == 32) {
    if (is_bf16) ASR_ATTN_CASE(__nv_bfloat16, 32); else ASR_ATTN_CASE(float, 32);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef ASR_ATTN_CASE
  return (int)cudaGetLastError();
}
