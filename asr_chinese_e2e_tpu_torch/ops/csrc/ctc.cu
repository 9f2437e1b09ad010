// CTC loss forward (alpha) and backward (beta, posteriors, logits gradient).
//
// Replaces the TPU kernels asr_chinese_e2e_tpu/ops/ctc_pallas.py::
// _alpha_kernel (K3, with the emission gather of _ctc_fwd and
// _loss_from_alpha) and _beta_kernel (K4, with the gamma / scatter /
// log-softmax chain of _ctc_bwd).
//
// Semantics (blank id given, log-zero BIG_NEG = -1e30 so logaddexp of two
// log-zeros stays finite): with emit[t][s] = logits[t][ext[s]] - lse[t],
//   alpha[0][s]  = emit[0][s] for s <= 1, else log-zero;
//   alpha[t][s]  = lae(alpha[t-1][s], alpha[t-1][s-1], skip[s] ?
//                  alpha[t-1][s-2]) + emit[t][s], frozen for t >= len;
//   loss         = -lae(alpha[len-1][last], last > 0 ? alpha[..][last-1]),
//                  last = 2 * label_len;
//   beta'[len-1][s] = emit at s in {last, max(last-1, 0)}, else log-zero;
//   beta'[t][s]  = lae(beta'[t+1][s], beta'[t+1][s+1], skip[s+2] ?
//                  beta'[t+1][s+2]) + emit[t][s];
//   z[t][s]      = exp(min(alpha + beta' - emit + loss, 0)), 0 for t >= len;
//   dlogits[t][c] = g * (softmax[t][c] * sum_s z[t][s] - sum_{ext[s]=c} z[t][s]),
// cast to the logits' type and zero for t >= len. The emission is a direct
// gather (exact); the TPU kernel's one-hot product was a TPU workaround.
//
// What bounds it on the H100: the recursions are sequential in T with
// ~2L+1 lanes of work per step, so they are latency-bound (one barrier per
// step); the log-sum-exp and the gradient are bandwidth-bound passes over
// the (B, T, C) logits (2 x 145 MB in bf16 at the flagship's B=64, T=267,
// C=4233).
//
// Design: K3 is two launches: a log-sum-exp pass with one block per (b, t)
// row, then one block per utterance with one thread per extended-label
// position; alpha is carried across T in shared memory (two buffers, one
// barrier per step) and each step is written to the (B, T, S) alpha table
// in device memory, which K4 reads (at T = 501 the table of one utterance
// would not fit a block's shared memory). K4 is also two launches: the
// reverse beta' recursion per utterance, which writes the posteriors z, and
// a per-(b, t) pass that scatters z into a shared-memory row of C floats
// with shared atomics and writes the gradient row in one pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr float BIG_NEG = -1e30f;
constexpr int ROW_THREADS = 256;

using asr::from_f32;
using asr::to_f32;

__device__ __forceinline__ float lae(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ float block_reduce(float x, float* red, bool is_max) {
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  __syncthreads();  // red is free
  if (lane == 0) red[warp] = x;
  __syncthreads();
  const int n_warps = blockDim.x / 32;
  x = lane < n_warps ? red[lane] : (is_max ? -INFINITY : 0.0f);
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  return x;
}

// lse[row] = log sum_c exp(logits[row][c]), one block per (b, t) row
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
ctc_lse_kernel(const T* __restrict__ logits, float* __restrict__ lse, int C) {
  __shared__ float red[32];
  const T* x = logits + (size_t)blockIdx.x * C;
  float m = -INFINITY;
  for (int c = threadIdx.x; c < C; c += blockDim.x) m = fmaxf(m, to_f32(x[c]));
  m = block_reduce(m, red, true);
  float s = 0.0f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) s += expf(to_f32(x[c]) - m);
  s = block_reduce(s, red, false);
  if (threadIdx.x == 0) lse[blockIdx.x] = m + logf(s);
}

__device__ __forceinline__ bool can_skip(const int* ext, int s, int S, int blank) {
  return s >= 2 && s < S && ext[s] != blank && ext[s] != ext[s - 2];
}

template <typename T>
__device__ __forceinline__ float emission(const T* logits, const float* lse,
                                          int row, int C, int label, bool valid) {
  return valid ? to_f32(logits[(size_t)row * C + label]) - lse[row] : BIG_NEG;
}

// K3: one block per utterance, thread s = extended-label position
template <typename T>
__global__ void ctc_alpha_kernel(const T* __restrict__ logits,
                                 const float* __restrict__ lse,
                                 const int* __restrict__ ext_all,
                                 const int* __restrict__ logit_len,
                                 const int* __restrict__ label_len,
                                 float* __restrict__ alpha,
                                 float* __restrict__ loss, int Tt, int C, int S,
                                 int blank) {
  extern __shared__ float buf[];  // two buffers of S + 2, two log-zero pads each
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool valid = s < S;
  const int* ext = ext_all + (size_t)b * S;
  const int label = valid ? ext[s] : blank;
  const bool skip = can_skip(ext, s, S, blank);
  const int len = min(logit_len[b], Tt);
  const int stride = S + 2;
  float* a = alpha + (size_t)b * Tt * S;
  const int row0 = b * Tt;

  if (s < 2) {
    buf[s] = BIG_NEG;
    buf[stride + s] = BIG_NEG;
  }
  float val = (valid && s <= 1) ? emission(logits, lse, row0, C, label, true) : BIG_NEG;
  if (valid) {
    buf[s + 2] = val;
    a[s] = val;
  }
  int cur = 0;
  for (int t = 1; t < len; ++t) {
    const float e = emission(logits, lse, row0 + t, C, label, valid);
    __syncthreads();  // step t-1 is in buffer cur
    if (valid) {
      const float* prev = buf + cur * stride;
      float stay = lae(prev[s + 2], prev[s + 1]);
      if (skip) stay = lae(stay, prev[s]);
      val = stay + e;
    }
    cur ^= 1;
    if (valid) {
      buf[cur * stride + s + 2] = val;
      a[(size_t)t * S + s] = val;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const float* fin = buf + cur * stride;
    const int last = min(2 * label_len[b], S - 1);
    const float a_last = fin[last + 2];
    const float a_prev = last > 0 ? fin[last + 1] : BIG_NEG;
    loss[b] = -lae(a_last, a_prev);
  }
}

// K4, part 1: reverse beta' recursion per utterance; writes z for t < len
template <typename T>
__global__ void ctc_beta_kernel(const T* __restrict__ logits,
                                const float* __restrict__ lse,
                                const int* __restrict__ ext_all,
                                const int* __restrict__ logit_len,
                                const int* __restrict__ label_len,
                                const float* __restrict__ alpha,
                                const float* __restrict__ loss,
                                float* __restrict__ z, int Tt, int C, int S,
                                int blank) {
  extern __shared__ float buf[];  // two buffers of S + 2, two log-zero pads each
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool valid = s < S;
  const int* ext = ext_all + (size_t)b * S;
  const int label = valid ? ext[s] : blank;
  const bool skip2 = can_skip(ext, s + 2, S, blank);  // s+2 -> s is allowed
  const int len = min(logit_len[b], Tt);
  const int last = min(2 * label_len[b], S - 1);
  const float nll = loss[b];
  const int stride = S + 2;
  const float* a = alpha + (size_t)b * Tt * S;
  float* zb = z + (size_t)b * Tt * S;
  const int row0 = b * Tt;

  if (s < 2) {
    buf[S + s] = BIG_NEG;
    buf[stride + S + s] = BIG_NEG;
  }
  int cur = 0;
  for (int t = len - 1; t >= 0; --t) {
    const float e = emission(logits, lse, row0 + t, C, label, valid);
    float val = BIG_NEG;
    if (t == len - 1) {
      if (valid && (s == last || s == max(last - 1, 0))) val = e;
    } else {
      __syncthreads();  // step t+1 is in buffer cur
      if (valid) {
        const float* next = buf + cur * stride;
        const float stay = lae(next[s], next[s + 1]);
        val = lae(stay, skip2 ? next[s + 2] : BIG_NEG) + e;
      }
      cur ^= 1;
    }
    if (valid) {
      buf[cur * stride + s] = val;
      const float gamma = a[(size_t)t * S + s] + val - e;
      zb[(size_t)t * S + s] = expf(fminf(gamma + nll, 0.0f));
    }
  }
}

// K4, part 2: one block per (b, t) row; the row of C gradients is built in
// shared memory (softmax * sum z, minus the scatter of z) and written once
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
ctc_grad_kernel(const T* __restrict__ logits, const float* __restrict__ lse,
                const int* __restrict__ ext_all, const int* __restrict__ logit_len,
                const float* __restrict__ z, const float* __restrict__ g,
                T* __restrict__ dlogits, int Tt, int C, int S) {
  extern __shared__ float grad[];  // C floats
  __shared__ float red[32];
  const int row = blockIdx.x;
  const int b = row / Tt;
  const int t = row - b * Tt;
  T* out = dlogits + (size_t)row * C;
  if (t >= logit_len[b]) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) out[c] = from_f32<T>(0.0f);
    return;
  }
  const float* zr = z + (size_t)row * S;
  const int* ext = ext_all + (size_t)b * S;
  float zs = 0.0f;
  for (int s = threadIdx.x; s < S; s += blockDim.x) zs += zr[s];
  zs = block_reduce(zs, red, false);
  const float l = lse[row];
  const T* x = logits + (size_t)row * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    grad[c] = expf(to_f32(x[c]) - l) * zs;
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x) atomicAdd(&grad[ext[s]], -zr[s]);
  __syncthreads();
  const float gb = g[b];
  for (int c = threadIdx.x; c < C; c += blockDim.x) out[c] = from_f32<T>(gb * grad[c]);
}

int recursion_threads(int S) { return ((S + 31) / 32) * 32; }

template <typename T>
int alpha_launch(const void* logits, const int* ext, const int* logit_len,
                 const int* label_len, float* lse, float* alpha, float* loss,
                 int B, int Tt, int C, int S, int blank, cudaStream_t st) {
  ctc_lse_kernel<T><<<B * Tt, ROW_THREADS, 0, st>>>((const T*)logits, lse, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 2 * (S + 2) * sizeof(float);
  ctc_alpha_kernel<T><<<B, recursion_threads(S), smem, st>>>(
      (const T*)logits, lse, ext, logit_len, label_len, alpha, loss, Tt, C, S,
      blank);
  return (int)cudaGetLastError();
}

template <typename T>
int beta_launch(const void* logits, const int* ext, const int* logit_len,
                const int* label_len, const float* lse, const float* alpha,
                const float* loss, const float* g, float* z, void* dlogits,
                int B, int Tt, int C, int S, int blank, cudaStream_t st) {
  const size_t smem = 2 * (S + 2) * sizeof(float);
  ctc_beta_kernel<T><<<B, recursion_threads(S), smem, st>>>(
      (const T*)logits, lse, ext, logit_len, label_len, alpha, loss, z, Tt, C, S,
      blank);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t row_smem = (size_t)C * sizeof(float);
  if (row_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ctc_grad_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)row_smem);
    if (err != cudaSuccess) return (int)err;
  }
  ctc_grad_kernel<T><<<B * Tt, ROW_THREADS, row_smem, st>>>(
      (const T*)logits, lse, ext, logit_len, z, g, (T*)dlogits, Tt, C, S);
  return (int)cudaGetLastError();
}

}  // namespace

// K3. logits: (B, T, C) bf16 (is_bf16=1) or f32, contiguous; ext: (B, S)
// int32 extended labels; logit_len/label_len: (B,) int32. Writes lse
// (B, T) f32, the alpha table (B, T, S) f32 (rows t < len only) and the
// loss (B,) f32. S <= 1024. Returns the first launch error or 0.
extern "C" int asr_ctc_alpha(const void* logits, const int* ext,
                             const int* logit_len, const int* label_len,
                             float* lse, float* alpha, float* loss, int B,
                             int Tt, int C, int S, int blank, int is_bf16,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S > 1024) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return alpha_launch<__nv_bfloat16>(logits, ext, logit_len, label_len, lse,
                                       alpha, loss, B, Tt, C, S, blank, st);
  return alpha_launch<float>(logits, ext, logit_len, label_len, lse, alpha,
                             loss, B, Tt, C, S, blank, st);
}

// K4. Inputs as K3, plus K3's lse, alpha and loss, and g: (B,) f32, the
// loss cotangent. z: (B, T, S) f32 scratch; dlogits: (B, T, C) in the
// logits' type. Returns the first launch error or 0.
extern "C" int asr_ctc_beta(const void* logits, const int* ext,
                            const int* logit_len, const int* label_len,
                            const float* lse, const float* alpha,
                            const float* loss, const float* g, float* z,
                            void* dlogits, int B, int Tt, int C, int S,
                            int blank, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S > 1024) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return beta_launch<__nv_bfloat16>(logits, ext, logit_len, label_len, lse,
                                      alpha, loss, g, z, dlogits, B, Tt, C, S,
                                      blank, st);
  return beta_launch<float>(logits, ext, logit_len, label_len, lse, alpha,
                            loss, g, z, dlogits, B, Tt, C, S, blank, st);
}
