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
// 0.14 us at 3.35 TB/s). Design: one warp per hypothesis, a scan over
// frames. A valid frame t >= 1 is an affine map of the state (nb, bb) in the
// log semiring (+ is log-add-exp, x is +):
//   nb' = x_t nb + (phi[t-1] x_t),   bb' = bl_t nb + bl_t bb,
// so a run of frames composes into nb' = a nb + e, bb' = c nb + d bb + f
// (the entry of bb in nb' stays log-zero); an invalid frame is the
// identity. Each lane composes the maps of its contiguous chunk of about
// (T - 1) / 32 frames; the warp scans the 32 chunk maps with __shfl_up_sync
// in 5 rounds; each lane applies the scan of the lanes before it to the
// frame-0 state and replays its chunk with the plain recursion from there,
// writing every frame. The chain is about 2 T / 32 + 5 steps instead of T.
// Log-zero entries of a composed map sum several LOG_ZEROs and fall below
// -1e30; the carries are clamped at LOG_ZERO, where the plain recursion
// sits for a cell it cannot reach (a LOG_ZERO plus any finite term rounds
// back to LOG_ZERO in f32), so the replay writes what the plain recursion
// writes up to the rounding of the reassociated chunk sums.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float LOG_ZERO = -1e30f;
constexpr int WARPS = 4;  // hypotheses per block, a warp each
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float lae(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// nb' = lae(a + nb, e); bb' = lae(lae(c + nb, d + bb), f)
struct Map {
  float a, c, d, e, f;
};

__device__ __forceinline__ Map identity_map() {
  return {0.0f, LOG_ZERO, 0.0f, LOG_ZERO, LOG_ZERO};
}

// `later` applied after `earlier`
__device__ __forceinline__ Map compose(const Map& later, const Map& earlier) {
  return {later.a + earlier.a,
          lae(later.c + earlier.a, later.d + earlier.c),
          later.d + earlier.d,
          lae(later.a + earlier.e, later.e),
          lae(lae(later.c + earlier.e, later.d + earlier.f), later.f)};
}

__device__ __forceinline__ Map shfl_up(const Map& m, int off) {
  return {__shfl_up_sync(FULL, m.a, off), __shfl_up_sync(FULL, m.c, off),
          __shfl_up_sync(FULL, m.d, off), __shfl_up_sync(FULL, m.e, off),
          __shfl_up_sync(FULL, m.f, off)};
}

__global__ void __launch_bounds__(WARPS * 32)
ctc_prefix_registers_kernel(const float* __restrict__ lp_flat,
                            const uint8_t* __restrict__ frame_mask,
                            const float* __restrict__ r_nb_g,
                            const float* __restrict__ r_b_g,
                            const int64_t* __restrict__ token,
                            const int64_t* __restrict__ last, int empty,
                            float* __restrict__ r_nb, float* __restrict__ r_b,
                            int B, int K, int C, int T, int blank) {
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * WARPS + threadIdx.x / 32;  // hypothesis b * K + k
  if (i >= B * K) return;  // a whole warp: the shuffles below stay full
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

  // frames 1 .. T-1 in 32 contiguous chunks
  const int chunk = (T - 1 + 31) / 32;
  const int lo = min(1 + lane * chunk, T), hi = min(lo + chunk, T);
  Map m = identity_map();
  for (int t = lo; t < hi; ++t) {
    if (!fm[t]) continue;
    const float x = xs[t], bt = bl[t];
    const float phi = same ? gb[t - 1] : lae(gb[t - 1], gnb[t - 1]);
    m = {x + m.a, lae(bt + m.a, bt + m.c), bt + m.d, lae(x + m.e, phi + x),
         lae(bt + m.e, bt + m.f)};
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Map earlier = shfl_up(m, off);
    if (lane >= off) m = compose(m, earlier);
  }
  Map before = shfl_up(m, 1);
  if (lane == 0) before = identity_map();

  const float nb0 = (empty && fm[0]) ? xs[0] : LOG_ZERO;
  float nb = fmaxf(lae(before.a + nb0, before.e), LOG_ZERO);
  float bb = fmaxf(lae(lae(before.c + nb0, before.d + LOG_ZERO), before.f), LOG_ZERO);
  if (lane == 0) {
    onb[0] = nb0;
    ob[0] = LOG_ZERO;
  }
  for (int t = lo; t < hi; ++t) {
    const float x = xs[t];
    const float phi = same ? gb[t - 1] : lae(gb[t - 1], gnb[t - 1]);
    const float nb_new = lae(nb + x, phi + x);
    const float bb_new = lae(bb, nb) + bl[t];
    if (fm[t]) {
      nb = nb_new;
      bb = bb_new;
    }
    onb[t] = nb;
    ob[t] = bb;
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
  const int blocks = (B * K + WARPS - 1) / WARPS;
  ctc_prefix_registers_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      lp_flat, frame_mask, r_nb_g, r_b_g, token, last, empty, r_nb, r_b, B, K, C, T, blank);
  return (int)cudaGetLastError();
}
