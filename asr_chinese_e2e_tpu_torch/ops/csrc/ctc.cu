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
// ~2L+1 lanes of work per step, so they are latency-bound; the log-sum-exp
// and the gradient are bandwidth-bound passes over the (B, T, C) logits
// (2 x 145 MB in bf16 at the flagship's B=64, T=267, C=4233: K4 moves 293.8
// MB, 88 us at 3.35 TB/s).
//
// Design: K3 is two launches. The row pass (ctc_emission_rows_kernel) gives
// a warp to each (b, t) row and reads the row once, in 16-byte loads, with
// an online (max, sum) per lane merged by the xor butterfly; it writes the
// row's log-sum-exp and gathers the row's S emissions (L1-hot just after the
// stream) into a (B, T, S) f32 emission table, K3's scratch. The recursion
// (ctc_alpha_recursion_kernel) runs one block per utterance with one thread
// per extended-label position; alpha is carried across T in shared memory
// (two buffers, one barrier a step) and each step is written to the (B, T,
// S) alpha table in device memory, which K4 reads (at T = 501 the table of
// one utterance would not fit a block's shared memory). Each thread copies
// its own emission by cp.async eight steps ahead into a ring in shared
// memory, so no load of device memory sits in the chain from one step to
// the next, and the step is two branch-free log-add-exps. K4 is two
// launches too: the reverse beta' recursion, one block per utterance and a
// thread per state, with every load of a step copied by cp.async eight
// steps ahead, writing the posteriors z (ctc_beta_recursion_kernel); then
// the gradient rows, a warp per (b, t) row, in 16-byte loads and stores of
// the logits' type, with the label positions written again after a warp
// barrier (ctc_grad_rows_kernel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr float BIG_NEG = -1e30f;

using asr::from_f32;
using asr::to_f32;

__device__ __forceinline__ float lae(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// lae's formula on the hardware's exp2 and log2 (ex2.approx, lg2.approx),
// branch-free, 1e-7 from lae a step. bf16 logits take it: their rounding
// dwarfs the 1e-7. Over the T steps of an f32 recursion these errors
// compound (a conformer step's f32 gradient 2e-4 from the CPU's), so f32
// logits take lae, and expf / logf in the row passes (EXACT below).
__device__ __forceinline__ float lae_fast(float a, float b) {
  const float m = fmaxf(a, b);
  return m + __logf(1.0f + __expf(-fabsf(a - b)));
}

// the log-add-exp, exp and log of one design: EXACT (f32 logits) on the
// accurate expf / log1pf / logf, as the JAX package computes them; else
// (bf16 logits) on the hardware's approximate functions
template <bool EXACT>
__device__ __forceinline__ float lae_of(float a, float b) {
  return EXACT ? lae(a, b) : lae_fast(a, b);
}
template <bool EXACT>
__device__ __forceinline__ float exp_of(float x) {
  return EXACT ? expf(x) : __expf(x);
}
template <bool EXACT>
__device__ __forceinline__ float log_of(float x) {
  return EXACT ? logf(x) : __logf(x);
}

__device__ __forceinline__ bool can_skip(const int* ext, int s, int S, int blank) {
  return s >= 2 && s < S && ext[s] != blank && ext[s] != ext[s - 2];
}

// 16 bytes of T as floats, and back
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(uint4 r, float (&f)[4]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(uint4 r, float (&f)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

constexpr int ROW_DEPTH = 4;  // 16-byte loads in flight a lane

// A row's log-sum-exp by one warp, the row read once and cut as row_parts
// cuts it, ROW_DEPTH 16-byte loads a lane issued before their arithmetic
// (one row a warp, ROW_ROWS rows a block: 8 rows and 4 loads beat 16 rows,
// 8 loads and row_parts' unrolled loop, PERF.md): an online (max, sum) per
// lane, the sum rescaled when the max grows, each term 2^(x log2 e - max
// log2 e) by one fused multiply-add and one ex2, then the lanes merged by
// the xor butterfly. Every lane returns it. EXACT: each term expf(x - max),
// the sum rescaled by expf, the log by logf.
template <typename T, bool EXACT>
__device__ __forceinline__ float warp_row_lse(const T* x, int C, int lane) {
  using V = Vec16<T>;
  using asr::ex2;
  using asr::LOG2E;
  constexpr int W = V::N;
  float m = -FLT_MAX, sum = 0.0f;
  auto update = [&](const float* f, int n) {
    float mn = m;
#pragma unroll
    for (int k = 0; k < n; ++k) mn = fmaxf(mn, f[k]);
    float add = 0.0f;
    if constexpr (EXACT) {
#pragma unroll
      for (int k = 0; k < n; ++k) add += expf(f[k] - mn);
      sum = fmaf(sum, expf(m - mn), add);
    } else {
      const float nb = -mn * LOG2E;
#pragma unroll
      for (int k = 0; k < n; ++k) add += ex2(fmaf(f[k], LOG2E, nb));
      sum = fmaf(sum, ex2((m - mn) * LOG2E), add);  // exactly 1 while the max holds
    }
    m = mn;
  };
  const int mis = (int)((reinterpret_cast<uintptr_t>(x) / sizeof(T)) & (W - 1));
  const int head = min(C, (W - mis) & (W - 1));
  const int n_vec = (C - head) / W;
  for (int c = lane; c < head; c += 32) {
    const float v = to_f32(x[c]);
    update(&v, 1);
  }
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  int i = lane;
  for (; i + 32 * (ROW_DEPTH - 1) < n_vec; i += 32 * ROW_DEPTH) {
    uint4 r[ROW_DEPTH];
#pragma unroll
    for (int k = 0; k < ROW_DEPTH; ++k) r[k] = xv[i + 32 * k];
#pragma unroll
    for (int k = 0; k < ROW_DEPTH; ++k) {
      float f[W];
      V::unpack(r[k], f);
      update(f, W);
    }
  }
  for (; i < n_vec; i += 32) {
    float f[W];
    V::unpack(xv[i], f);
    update(f, W);
  }
  for (int c = head + n_vec * W + lane; c < C; c += 32) {
    const float v = to_f32(x[c]);
    update(&v, 1);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float so = __shfl_xor_sync(0xffffffffu, sum, off);
    const float mn = fmaxf(m, mo);
    sum = sum * exp_of<EXACT>(m - mn) + so * exp_of<EXACT>(mo - mn);
    m = mn;
  }
  return m + log_of<EXACT>(sum);
}

constexpr int ROW_WARPS = 8;   // one row (b, t) at a time per warp
constexpr int ROW_ROWS = 8;    // rows of one utterance per block

// K3, part 1: the row pass, ROW_ROWS rows of one utterance per block, a warp
// per row: lse[row], and for rows t < max(len, 1) the S emissions
// emit[row][s] = logits[row][ext[s]] - lse[row], the classes staged once per
// block in shared memory.
template <typename T, bool EXACT>
__global__ void __launch_bounds__(32 * ROW_WARPS)
ctc_emission_rows_kernel(const T* __restrict__ logits, const int* __restrict__ ext_all,
                         const int* __restrict__ logit_len, float* __restrict__ lse,
                         float* __restrict__ emit, int Tt, int C, int S) {
  extern __shared__ int ext[];  // S classes
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * ROW_ROWS;
  const int n = max(min(logit_len[b], Tt), 1);
  for (int s = tid; s < S; s += blockDim.x) ext[s] = ext_all[(size_t)b * S + s];
  __syncthreads();
  for (int r = warp; r < ROW_ROWS; r += ROW_WARPS) {
    const int t = t0 + r;
    if (t >= Tt) break;
    const size_t row = (size_t)b * Tt + t;
    const T* x = logits + row * C;
    const float l = warp_row_lse<T, EXACT>(x, C, lane);
    if (lane == 0) lse[row] = l;
    if (t >= n) continue;
    for (int s = lane; s < S; s += 32) emit[row * S + s] = to_f32(x[ext[s]]) - l;
  }
}

// K3, part 2: the forward recursion, one block per utterance and one thread
// per extended-label position, alpha carried in shared memory (two buffers
// of S + 2, two log-zero pads in front, one barrier a step). Each thread
// copies its own emission of step t + P by cp.async into its slot of a ring
// in shared memory, so the chain from one step to the next holds no load of
// device memory. Writes alpha for t < max(len, 1) and the loss.
template <int P, bool EXACT>
__global__ void __launch_bounds__(1024)
ctc_alpha_recursion_kernel(const float* __restrict__ emit, const int* __restrict__ ext_all,
                           const int* __restrict__ logit_len, const int* __restrict__ label_len,
                           float* __restrict__ alpha, float* __restrict__ loss, int Tt, int S,
                           int blank) {
  extern __shared__ float recur[];  // two buffers of S + 2, then P x blockDim slots
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const int nth = blockDim.x;
  const bool valid = s < S;
  const int* ext = ext_all + (size_t)b * S;
  const bool skip = can_skip(ext, s, S, blank);
  const int n = max(min(logit_len[b], Tt), 1);
  const int stride = S + 2;
  float* buf = recur;
  float* ring = recur + 2 * stride;
  const float* e_b = emit + (size_t)b * Tt * S;
  float* a = alpha + (size_t)b * Tt * S;
  auto fetch = [&](int u, int t) {
    if (t < n) asr::cp_async4(ring + u * nth + s, e_b + (size_t)t * S + (valid ? s : 0), valid);
  };
  if (s < 2) {
    buf[s] = BIG_NEG;
    buf[stride + s] = BIG_NEG;
  }
#pragma unroll
  for (int u = 0; u < P; ++u) {
    fetch(u, u);
    asr::cp_async_commit();
  }
  int cur = 0;
  for (int tt = 0; tt < n; tt += P) {
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const int t = tt + u;
      if (t >= n) break;
      asr::cp_async_wait<P - 1>();
      const float e = ring[u * nth + s];
      float val = BIG_NEG;
      if (t == 0) {
        if (s <= 1) val = e;
      } else {
        __syncthreads();  // step t-1 is in buffer cur
        const float* prev = buf + cur * stride;
        if (valid)
          val = lae_of<EXACT>(lae_of<EXACT>(prev[s + 2], prev[s + 1]), skip ? prev[s] : BIG_NEG) +
                e;
        cur ^= 1;
      }
      if (valid) {
        buf[cur * stride + s + 2] = val;
        a[(size_t)t * S + s] = val;
      }
      fetch(u, t + P);
      asr::cp_async_commit();
    }
  }
  __syncthreads();
  if (s == 0) {
    const float* fin = buf + cur * stride;
    const int last = min(2 * label_len[b], S - 1);
    const float a_last = fin[last + 2];
    const float a_prev = last > 0 ? fin[last + 1] : BIG_NEG;
    loss[b] = -lae(a_last, a_prev);
  }
}

// K4, part 1: the reverse beta' recursion, one block per utterance and
// one thread per extended-label position, beta' carried in shared memory
// (two buffers, one barrier a step). What a step reads of device memory
// (the logits' row at the thread's label, its alpha, the row's log-sum-exp)
// is copied P steps ahead by cp.async into the thread's own slots of a
// ring in shared memory, so no load of device memory sits in the chain
// from one step to the next: the parent design had two there, ~1.1 us a
// step. One warp per utterance with the states in registers and the
// neighbours by shuffles (no barrier) was measured too, on the same ring:
// a single warp issues every state's work in turn, 0.2197 ms at S = 65 and
// 2.2438 ms at S = 401 against this design's 0.1116 and 0.3446 (PERF.md).
// Writes z for t < len.
template <typename T, int P, bool EXACT>
__global__ void __launch_bounds__(1024)
ctc_beta_recursion_kernel(const T* __restrict__ logits, const float* __restrict__ lse,
                          const int* __restrict__ ext_all, const int* __restrict__ logit_len,
                          const int* __restrict__ label_len, const float* __restrict__ alpha,
                          const float* __restrict__ loss, float* __restrict__ z, int Tt, int C,
                          int S, int blank) {
  extern __shared__ float recur[];  // two buffers of S + 2, then P x 3 x blockDim slots
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const int nth = blockDim.x;
  const bool valid = s < S;
  const int* ext = ext_all + (size_t)b * S;
  const int label = valid ? ext[s] : 0;
  const bool skip2 = can_skip(ext, s + 2, S, blank);
  const int len = min(logit_len[b], Tt);
  const int last = min(2 * label_len[b], S - 1);
  const bool fin = valid && (s == last || s == max(last - 1, 0));
  const float nll = loss[b];
  const int stride = S + 2;
  float* buf = recur;
  float* ring = recur + 2 * stride;
  const size_t row0 = (size_t)b * Tt;
  const size_t n_logits = (size_t)gridDim.x * Tt * C;
  // step t into slot u: a bf16 logit as the aligned 4-byte word that holds
  // it (the wrapper checks 16-byte alignment), read directly where that word
  // would pass the end of the logits
  auto fetch = [&](int u, int t) {
    if (t < 0) return;
    const size_t row = row0 + t;
    const size_t idx = row * C + label;
    float* slot = ring + (u * 3) * nth + s;
    if constexpr (sizeof(T) == 4) {
      asr::cp_async4(slot, logits + idx, valid);
    } else if ((idx & 1) || idx + 1 < n_logits) {
      asr::cp_async4(slot, reinterpret_cast<const uint32_t*>(logits) + idx / 2, valid);
    } else {
      slot[0] = __uint_as_float(*reinterpret_cast<const unsigned short*>(logits + idx));
    }
    asr::cp_async4(slot + nth, alpha + row * S + (valid ? s : 0), valid);
    asr::cp_async4(slot + 2 * nth, lse + row, true);
  };
  if (s < 2) {
    buf[S + s] = BIG_NEG;
    buf[stride + S + s] = BIG_NEG;
  }
#pragma unroll
  for (int u = 0; u < P; ++u) {
    fetch(u, len - 1 - u);
    asr::cp_async_commit();
  }
  int cur = 0;
  for (int tt = len - 1; tt >= 0; tt -= P) {
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const int t = tt - u;
      if (t < 0) break;
      asr::cp_async_wait<P - 1>();
      const float* slot = ring + (u * 3) * nth + s;
      float x;
      if constexpr (sizeof(T) == 4) {
        x = slot[0];
      } else {
        const uint32_t w = __float_as_uint(slot[0]);
        x = __uint_as_float((((row0 + t) * C + label) & 1 ? w >> 16 : w & 0xffffu) << 16);
      }
      const float e = valid ? x - slot[2 * nth] : BIG_NEG;
      float val = BIG_NEG;
      if (t == len - 1) {
        if (fin) val = e;
      } else {
        __syncthreads();  // step t+1 is in buffer cur
        const float* next = buf + cur * stride;
        if (valid)
          val = lae_of<EXACT>(lae_of<EXACT>(next[s], next[s + 1]), skip2 ? next[s + 2] : BIG_NEG) +
                e;
        cur ^= 1;
      }
      if (valid) {
        buf[cur * stride + s] = val;
        z[(row0 + t) * S + s] = exp_of<EXACT>(fminf(slot[nth] + val - e + nll, 0.0f));
      }
      fetch(u, t - P);
      asr::cp_async_commit();
    }
  }
}

constexpr int GRAD_WARPS = 8;   // one row (b, t) at a time per warp
constexpr int GRAD_ROWS = 16;   // rows of one utterance per block
constexpr int LINK_HEAD = 1 << 16;

// a row's elements [0, C) in three parts: up to the first 16-byte boundary,
// whole 16-byte vectors, the rest; fn(i) for the scalars, vec(i) for vector i
// of the aligned part (the logits and the gradient share their alignment)
template <typename T, typename Scalar, typename Vector>
__device__ __forceinline__ void row_parts(const T* x, int C, int lane, Scalar fn, Vector vec) {
  constexpr int V = 16 / sizeof(T);
  const int mis = (int)((reinterpret_cast<uintptr_t>(x) / sizeof(T)) & (V - 1));
  const int head = min(C, (V - mis) & (V - 1));
  const int n_vec = (C - head) / V;
  for (int c = lane; c < head; c += 32) fn(c);
#pragma unroll 4
  for (int i = lane; i < n_vec; i += 32) vec(head, i);
  for (int c = head + n_vec * V + lane; c < C; c += 32) fn(c);
}

// K4, part 2: the gradient rows, GRAD_ROWS of one utterance per block, a
// warp per row. Every class gets g softmax sum(z), in 16-byte loads and
// stores; then, after the warp's barrier, the <= S label positions are
// written again with g (softmax sum(z) - the sum of their z), the
// duplicates (blank at every even s, a repeated label) summed first in the
// order of s and each value rounded to the logits' type once. Rows t >= len
// are zeros. The class of every position and the link to the next position
// of the same class are worked out once per block in shared memory; no row
// of C floats and no atomics.
//
// EXACT (f32 logits) normalises each row's z by its sum, where the label
// can be aligned (loss < 1e29): g (softmax - sum of their z / sum(z)). In
// exact arithmetic sum(z) is 1 at every t < len; in f32, z = exp(alpha +
// beta' - emit + loss) carries the ulp of terms near the loss (~1e-4 at a
// loss of ~1700, a freshly initialised model's) into every z of the row
// alike, which scales the whole gradient by as much. The normalisation
// takes that common factor out.
template <typename T, bool EXACT>
__global__ void __launch_bounds__(32 * GRAD_WARPS)
ctc_grad_rows_kernel(const T* __restrict__ logits, const float* __restrict__ lse,
                     const int* __restrict__ ext_all, const int* __restrict__ logit_len,
                     const float* __restrict__ loss, const float* __restrict__ z,
                     const float* __restrict__ g, T* __restrict__ dlogits, int Tt, int C,
                     int S) {
  using V = Vec16<T>;
  extern __shared__ int sm[];
  int* ext = sm;                                      // S classes
  int* link = sm + S;                                 // next position | LINK_HEAD
  float* zs_all = reinterpret_cast<float*>(sm + 2 * S);  // a row of z per warp
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * GRAD_ROWS;
  const int len = min(logit_len[b], Tt);
  for (int s = tid; s < S; s += blockDim.x) ext[s] = ext_all[(size_t)b * S + s];
  __syncthreads();
  for (int s = tid; s < S; s += blockDim.x) {
    const int c = ext[s];
    int head = LINK_HEAD, next = S;
    for (int s2 = 0; s2 < S; ++s2) {
      if (ext[s2] != c) continue;
      if (s2 < s) head = 0;
      if (s2 > s && next == S) next = s2;
    }
    link[s] = next | head;
  }
  __syncthreads();

  const float gb = g[b];
  const bool normalise = EXACT && loss[b] < 1e29f;
  float* zr = zs_all + warp * S;
  for (int r = warp; r < GRAD_ROWS; r += GRAD_WARPS) {
    const int t = t0 + r;
    if (t >= Tt) break;
    const size_t row = (size_t)b * Tt + t;
    const T* x = logits + row * C;
    T* out = dlogits + row * C;
    if (t >= len) {
      row_parts(x, C, lane, [&](int c) { out[c] = from_f32<T>(0.0f); },
                [&](int head, int i) {
                  reinterpret_cast<uint4*>(out + head)[i] = make_uint4(0u, 0u, 0u, 0u);
                });
      continue;
    }
    float zs = 0.0f;
    for (int s = lane; s < S; s += 32) {
      const float v = z[row * S + s];
      zr[s] = v;
      zs += v;
    }
    for (int off = 16; off > 0; off >>= 1) zs += __shfl_xor_sync(0xffffffffu, zs, off);
    // w multiplies the softmax and inv the labels' sums: (sum(z), 1), or
    // normalised (1, 1 / sum(z)), (0, 0) where every z of the row underflowed
    float w = zs, inv = 1.0f;
    if (normalise) {
      w = zs > 0.0f ? 1.0f : 0.0f;
      inv = zs > 0.0f ? 1.0f / zs : 0.0f;
    }
    const float l = lse[row];
    row_parts(
        x, C, lane,
        [&](int c) { out[c] = from_f32<T>(exp_of<EXACT>(to_f32(x[c]) - l) * w * gb); },
        [&](int head, int i) {
          float f[V::N];
          V::unpack(reinterpret_cast<const uint4*>(x + head)[i], f);
#pragma unroll
          for (int k = 0; k < V::N; ++k) f[k] = exp_of<EXACT>(f[k] - l) * w * gb;
          reinterpret_cast<uint4*>(out + head)[i] = V::pack(f);
        });
    __syncwarp();  // the row's z staged, and its class values written
    for (int s = lane; s < S; s += 32) {
      const int lk = link[s];
      if (!(lk & LINK_HEAD)) continue;
      float sum = zr[s];
      for (int n = lk & (LINK_HEAD - 1); n < S; n = link[n] & (LINK_HEAD - 1)) sum += zr[n];
      const int c = ext[s];
      out[c] = from_f32<T>((exp_of<EXACT>(to_f32(x[c]) - l) * w - sum * inv) * gb);
    }
    __syncwarp();  // zr is free for the warp's next row
  }
}

int recursion_threads(int S) { return ((S + 31) / 32) * 32; }

template <typename T, bool EXACT>
int alpha_launch(const void* logits, const int* ext, const int* logit_len,
                 const int* label_len, float* lse, float* emit, float* alpha, float* loss,
                 int B, int Tt, int C, int S, int blank, cudaStream_t st) {
  // steps fetched ahead: 8 floats a thread in the ring, which with the two
  // buffers is 41 KB at S = 1024, under the 48 KB a launch gets by default
  constexpr int P = 8;
  dim3 grid((Tt + ROW_ROWS - 1) / ROW_ROWS, B);
  ctc_emission_rows_kernel<T, EXACT><<<grid, 32 * ROW_WARPS, sizeof(int) * S, st>>>(
      (const T*)logits, ext, logit_len, lse, emit, Tt, C, S);
  int err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nth = recursion_threads(S);
  const size_t smem = sizeof(float) * (2 * (S + 2) + P * nth);
  ctc_alpha_recursion_kernel<P, EXACT><<<B, nth, smem, st>>>(emit, ext, logit_len, label_len, alpha,
                                                      loss, Tt, S, blank);
  return (int)cudaGetLastError();
}

template <typename T, bool EXACT>
int beta_launch(const void* logits, const int* ext, const int* logit_len,
                const int* label_len, const float* lse, const float* alpha,
                const float* loss, const float* g, float* z, void* dlogits,
                int B, int Tt, int C, int S, int blank, cudaStream_t st) {
  // steps fetched ahead: 8 x 3 floats a thread in the ring
  constexpr int P = 8;
  const int nth = 32 * ((S + 31) / 32);
  const size_t rec_smem = sizeof(float) * (2 * (S + 2) + P * 3 * nth);
  int err = cudaSuccess;
  if (rec_smem > 48 * 1024)
    err = cudaFuncSetAttribute(ctc_beta_recursion_kernel<T, P, EXACT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rec_smem);
  if (err != cudaSuccess) return err;
  ctc_beta_recursion_kernel<T, P, EXACT><<<B, nth, rec_smem, st>>>(
      (const T*)logits, lse, ext, logit_len, label_len, alpha, loss, z, Tt, C, S, blank);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(int) * (size_t)(2 + GRAD_WARPS) * S;
  dim3 grid((Tt + GRAD_ROWS - 1) / GRAD_ROWS, B);
  ctc_grad_rows_kernel<T, EXACT><<<grid, 32 * GRAD_WARPS, smem, st>>>(
      (const T*)logits, lse, ext, logit_len, loss, z, g, (T*)dlogits, Tt, C, S);
  return (int)cudaGetLastError();
}

}  // namespace

// The logits' type, the last int argument of both entry points: f32 logits
// take the accurate functions, bf16 logits the approximate ones.
enum CtcVariant { CTC_F32 = 0, CTC_BF16 = 1 };

// K3. logits: (B, T, C) bf16 or f32 (variant), contiguous; ext: (B, S)
// int32 extended labels; logit_len/label_len: (B,) int32; emit: (B, T, S)
// f32 scratch (the emission table). Writes lse (B, T) f32, the alpha table
// (B, T, S) f32 (rows t < len only) and the loss (B,) f32. S <= 1024.
// Returns the first launch error or 0.
extern "C" int asr_ctc_alpha(const void* logits, const int* ext,
                             const int* logit_len, const int* label_len,
                             float* lse, float* emit, float* alpha, float* loss,
                             int B, int Tt, int C, int S, int blank, int variant,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S > 1024) return (int)cudaErrorInvalidValue;
  if (variant == CTC_BF16)
    return alpha_launch<__nv_bfloat16, false>(logits, ext, logit_len, label_len, lse, emit,
                                              alpha, loss, B, Tt, C, S, blank, st);
  return alpha_launch<float, true>(logits, ext, logit_len, label_len, lse, emit, alpha,
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
                            int blank, int variant, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S > 1024) return (int)cudaErrorInvalidValue;
  if (variant == CTC_BF16)
    return beta_launch<__nv_bfloat16, false>(logits, ext, logit_len, label_len, lse,
                                             alpha, loss, g, z, dlogits, B, Tt, C, S,
                                             blank, st);
  return beta_launch<float, true>(logits, ext, logit_len, label_len, lse, alpha,
                                  loss, g, z, dlogits, B, Tt, C, S, blank, st);
}
