// The joint CTC/attention search's CTC prefix registers (K8).
//
// Replaces the lax.scan over frames of
// asr_chinese_e2e_tpu/decode/joint.py::_ctc_selected_registers (:204-262),
// which XLA compiles into one loop on the TPU: no Pallas kernel stood
// there, but written as a host loop over frames it would be about eight
// small launches a frame, 2,300 a decode step at the serving shape.
//
// Semantics (log domain, LOG_ZERO = -1e30 so the log-add-exp of two
// log-zeros stays finite; xs the CTC log-prob of the hypothesis' new token,
// bl the blank's, both read from the class-major (B*C, T) table; frame t
// valid where frame_mask[b][t]; on an invalid frame xs is log-zero and bl 0):
//   phi[t]  = r_b_g[t] if token == last, else lae(r_b_g[t], r_nb_g[t]);
//   r_nb[0] = xs[0] if the parent is empty, else log-zero; r_b[0] = log-zero;
//   r_nb[t] = lae(r_nb[t-1] + xs[t], phi[t-1] + xs[t]),
//   r_b[t]  = lae(r_b[t-1], r_nb[t-1]) + bl[t]   on a valid frame t >= 1,
//   both held from t - 1 on an invalid one.
//
// What bounds it on the H100: a chain of T steps of two log-add-exps each
// per hypothesis, independent across the B*K hypotheses (80 at the serving
// shape): latency, not bytes (the whole call moves about half a megabyte,
// 0.14 us at 3.35 TB/s). Design: one thread per hypothesis; it walks its
// token's row and the utterance's blank row of the table and its parent's
// registers in order, so each 128-byte line serves 32 steps; the loads do
// not depend on the chain, and the loop is unrolled by 8 over __restrict__
// pointers so that the compiler may issue a group's loads ahead of it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float LOG_ZERO = -1e30f;
constexpr int THREADS = 128;

__device__ __forceinline__ float lae(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__global__ void __launch_bounds__(THREADS)
ctc_prefix_registers_kernel(const float* __restrict__ lp_flat,
                            const uint8_t* __restrict__ frame_mask,
                            const float* __restrict__ r_nb_g,
                            const float* __restrict__ r_b_g,
                            const int64_t* __restrict__ token,
                            const int64_t* __restrict__ last, int empty,
                            float* __restrict__ r_nb, float* __restrict__ r_b,
                            int B, int K, int C, int T, int blank) {
  const int i = blockIdx.x * THREADS + threadIdx.x;  // hypothesis b * K + k
  if (i >= B * K) return;
  const int b = i / K;
  const int64_t tok = token[i];
  const float* xs = lp_flat + ((int64_t)b * C + tok) * T;
  const float* bl = lp_flat + ((int64_t)b * C + blank) * T;
  const uint8_t* fm = frame_mask + (int64_t)b * T;
  const float* gnb = r_nb_g + (int64_t)i * T;
  const float* gb = r_b_g + (int64_t)i * T;
  float* onb = r_nb + (int64_t)i * T;
  float* ob = r_b + (int64_t)i * T;
  const bool same = tok == last[i];

  float nb = (empty && fm[0]) ? xs[0] : LOG_ZERO;
  float bb = LOG_ZERO;
  onb[0] = nb;
  ob[0] = bb;
  float phi = same ? gb[0] : lae(gb[0], gnb[0]);
#pragma unroll 8
  for (int t = 1; t < T; ++t) {
    const float x = xs[t];
    const float nb_new = lae(nb + x, phi + x);
    const float bb_new = lae(bb, nb) + bl[t];
    if (fm[t]) {
      nb = nb_new;
      bb = bb_new;
    }
    onb[t] = nb;
    ob[t] = bb;
    phi = same ? gb[t] : lae(gb[t], gnb[t]);
  }
}

}  // namespace

// K8. lp_flat: (B*C, T) f32 class-major CTC log-probs; frame_mask: (B, T)
// bool; r_nb_g, r_b_g: (B, K, T) f32 registers of the selected parents;
// token, last: (B, K) int64; empty: the parents are the empty prefix (the
// search's first step). Writes r_nb, r_b: (B, K, T) f32. All contiguous.
// Returns the launch error or 0.
extern "C" int asr_ctc_prefix_registers(const float* lp_flat, const uint8_t* frame_mask,
                                        const float* r_nb_g, const float* r_b_g,
                                        const int64_t* token, const int64_t* last,
                                        int empty, float* r_nb, float* r_b, int B, int K,
                                        int C,
                                        int T, int blank, void* stream) {
  if (B * K == 0 || T == 0) return 0;
  const int blocks = (B * K + THREADS - 1) / THREADS;
  ctc_prefix_registers_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      lp_flat, frame_mask, r_nb_g, r_b_g, token, last, empty, r_nb, r_b, B, K, C, T, blank);
  return (int)cudaGetLastError();
}
