// The rescore mode's device CTC prefix beam search (K9).
//
// Replaces the lax.scan over frames of
// asr_chinese_e2e_tpu/decode/ctc_prefix_device.py::ctc_prefix_beam_device
// (:71-228, the scan at :214), which XLA compiles into one loop on the TPU:
// no Pallas kernel stood there, but the port's plain version
// (decode/ctc_prefix_device.py::ctc_prefix_beam_reference) is a host loop
// of about 165 small launches a frame. This computes that loop step for
// step, in f32, with torch's logaddexp formula and the accurate expf / logf
// / log1pf, so that the kernel and its plain version round alike:
//
//   per frame t, per utterance b (state: K prefixes of at most L stored
//   tokens, their lengths, last tokens and (pb, pnb) log masses):
//   1. merge duplicate prefixes: the K x K equality over the stored tokens,
//      gated by `live` (logaddexp(pb, pnb) > BIG_NEG / 2); each column's
//      first equal row takes the masked log-sum-exp of its copies' masses,
//      the copies get BIG_NEG;
//   2. the frame's top P classes in torch's stable order (value descending,
//      the lower index first among equals); the blank keeps its slot with
//      the value BIG_NEG;
//   3. the stay candidate (stay_pb, stay_pnb) and the K x P extensions; a
//      token equal to the beam's last extends only its blank-ended mass, a
//      full prefix (plen >= L) does not extend;
//   4. merge before select: an extension of beam j that recreates beam i
//      (i = j + [last_i]) folds into i's stay candidate and is killed;
//   5. the stable top K of the K (P + 1) candidates; the parents' prefixes
//      are gathered and the token written at min(plen, L - 1);
//   6. past the utterance's length the carry is the merged carry.
//   At the end one more merge and a stable sort by score.
//
// What bounds it on the H100: the rows t < len of the log-probs must be read
// once, at most 39 MB at the serving shape (8, 288, 4233), 0.012 ms at
// 3.35 TB/s; everything else is a chain of dependent frames of small K x K
// and K (P + 1) steps per utterance: latency. Design, two launches:
// - a row pass, a warp per (b, t) frame row with t < len, 4 rows a block
//   (the recursion reads no row past an utterance's length): each lane keeps
//   its own stable top-P list (in shared memory, a column per lane) over the
//   classes c = lane (mod 32), which it visits in increasing order, so an
//   equal value never displaces an earlier index; then P rounds of a warp
//   arg-max by (value, index) over the lists' heads write the frame's top P
//   to (B, T, P) scratch. This does not depend on the beam, so every frame
//   runs at once, at the byte bound's pace;
// - the recursion, one block of 128 threads per utterance: the whole state in
//   shared memory (double-buffered prefixes), seven barriers a frame; the
//   frame's top P, its blank and the K gathers p(last) are loaded into
//   registers at the top of the frame, ahead of the merge that does not need
//   them. The top K is a rank count (a candidate's rank is the number of
//   candidates before it in the stable order), exact under ties.
// The wrapper holds K, P <= 32 and L <= 128.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float BIG_NEG = -1e30f;
constexpr int MAX_K = 32;
constexpr int MAX_P = 32;
constexpr int MAX_L = 128;
constexpr int ROW_WARPS = 4;
constexpr int THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;

// torch.logaddexp: a itself when both are the same infinity
__device__ __forceinline__ float lae(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// (va, ia) comes before (vb, ib) in a stable descending sort
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

__global__ void __launch_bounds__(ROW_WARPS * 32)
prefix_beam_rows_kernel(const float* __restrict__ lp, const int64_t* __restrict__ lengths,
                        int rows, int T, int C, int P, float* __restrict__ top_val,
                        int* __restrict__ top_idx) {
  __shared__ float s_val[ROW_WARPS][MAX_P][32];
  __shared__ int s_idx[ROW_WARPS][MAX_P][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROW_WARPS + warp;
  // warp-level work only below: no block barrier
  if (row >= rows || row % T >= lengths[row / T]) return;
  float(*sv)[32] = s_val[warp];
  int(*si)[32] = s_idx[warp];
  for (int q = 0; q < P; ++q) {
    sv[q][lane] = -INFINITY;
    si[q][lane] = INT_MAX;
  }
  float thr_v = -INFINITY;  // the lane's P-th entry so far
  int thr_i = INT_MAX;
  const float* x = lp + (int64_t)row * C;
#pragma unroll 4
  for (int c = lane; c < C; c += 32) {
    const float v = x[c];
    if (before(v, c, thr_v, thr_i)) {
      int q = P - 1;
      while (q > 0 && before(v, c, sv[q - 1][lane], si[q - 1][lane])) {
        sv[q][lane] = sv[q - 1][lane];
        si[q][lane] = si[q - 1][lane];
        --q;
      }
      sv[q][lane] = v;
      si[q][lane] = c;
      thr_v = sv[P - 1][lane];
      thr_i = si[P - 1][lane];
    }
  }
  // P rounds: the best head of the 32 lists; its lane (index mod 32) pops it
  int head = 0;
  for (int r = 0; r < P; ++r) {
    float bv = head < P ? sv[head][lane] : -INFINITY;
    int bi = head < P ? si[head][lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, bv, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      if (before(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (bi != INT_MAX && bi % 32 == lane) ++head;
    if (lane == 0) {
      top_val[(int64_t)row * P + r] = bv;
      top_idx[(int64_t)row * P + r] = bi;
    }
  }
}

// Shared-memory layout of the recursion, in 4-byte words.
struct Layout {
  int K, P, L, N;
  int pref, plen, last, pb, pnb;  // [2] buffers each
  int rel, mpb, mpnb, pany, plast, staypb, live, tv, ti, cscore, cpnb, sel;
  int words;
  __host__ __device__ Layout(int k, int p, int l) : K(k), P(p), L(l), N(k * (p + 1)) {
    int o = 0;
    pref = o; o += 2 * K * L;
    plen = o; o += 2 * K;
    last = o; o += 2 * K;
    pb = o; o += 2 * K;
    pnb = o; o += 2 * K;
    rel = o; o += K * K;
    mpb = o; o += K;
    mpnb = o; o += K;
    pany = o; o += K;
    plast = o; o += K;
    staypb = o; o += K;
    live = o; o += K;
    tv = o; o += P;
    ti = o; o += P;
    cscore = o; o += N;
    cpnb = o; o += N;
    sel = o; o += K;
    words = o;
  }
};

constexpr int REL_EQUAL = 1;   // same length, same stored tokens
constexpr int REL_PARENT = 2;  // row i is column j plus one token

__global__ void __launch_bounds__(THREADS)
prefix_beam_recursion_kernel(const float* __restrict__ lp,
                             const int64_t* __restrict__ lengths,
                             const float* __restrict__ top_val,
                             const int* __restrict__ top_idx,
                             int64_t* __restrict__ out_prefixes,
                             int64_t* __restrict__ out_plen,
                             float* __restrict__ out_scores, int T, int C, int K,
                             int P, int L, int blank) {
  extern __shared__ int smem[];
  const Layout lay(K, P, L);
  const int b = blockIdx.x, tid = threadIdx.x, N = lay.N, P1 = P + 1;
  // the two state buffers, w = 0 or 1
  auto pref = [&](int w) { return smem + lay.pref + w * K * L; };
  auto plen = [&](int w) { return smem + lay.plen + w * K; };
  auto last = [&](int w) { return smem + lay.last + w * K; };
  auto pb = [&](int w) { return (float*)smem + lay.pb + w * K; };
  auto pnb = [&](int w) { return (float*)smem + lay.pnb + w * K; };
  int* rel = smem + lay.rel;  // (i, j): REL_* bits
  float* mpb = (float*)smem + lay.mpb;    // merged masses
  float* mpnb = (float*)smem + lay.mpnb;
  float* pany = (float*)smem + lay.pany;  // logaddexp(merged pb, pnb)
  float* plast = (float*)smem + lay.plast;
  float* staypb = (float*)smem + lay.staypb;
  int* live = smem + lay.live;
  float* tv = (float*)smem + lay.tv;
  int* ti = smem + lay.ti;
  float* cscore = (float*)smem + lay.cscore;  // candidate j * (P + 1) + slot
  float* cpnb = (float*)smem + lay.cpnb;
  int* sel = smem + lay.sel;

  for (int q = tid; q < 2 * K * L; q += THREADS) smem[lay.pref + q] = 0;
  for (int i = tid; i < K; i += THREADS) {
    plen(0)[i] = 0;
    last(0)[i] = -1;  // empty
    pb(0)[i] = i == 0 ? 0.0f : BIG_NEG;  // only beam 0 live
    pnb(0)[i] = BIG_NEG;
  }
  __syncthreads();
  const int64_t len = lengths[b];
  int cur = 0;

  // One merge of buffer `cur` into mpb / mpnb (three barriers), as
  // decode/ctc_prefix_device.py::_merge_duplicates: the masked log-sum-exp
  // counts the unmasked entries as BIG_NEG, and a sum that is not finite
  // gives BIG_NEG. Leaves the pairs' REL_* bits in `rel` for the frame.
  auto merge = [&](int* rep) {
    for (int q = tid; q < K * K; q += THREADS) {
      const int i = q / K, j = q % K;
      const int li = plen(cur)[i], lj = plen(cur)[j];
      const int n = li == lj ? li : (li == lj + 1 ? lj : -1);
      int bits = 0;
      if (n >= 0) {
        const int* pi = pref(cur) + i * L;
        const int* pj = pref(cur) + j * L;
        int l = min(n, L) - 1;  // from the end: prefixes part there
        while (l >= 0 && pi[l] == pj[l]) --l;
        if (l < 0) bits = li == lj ? REL_EQUAL : (li > 0 ? REL_PARENT : 0);
      }
      rel[q] = bits;
    }
    if (tid < K) live[tid] = lae(pb(cur)[tid], pnb(cur)[tid]) > BIG_NEG / 2;
    __syncthreads();
    if (tid < K) {  // column j: the first row equal to it
      const int j = tid;
      int r = j;
      if (live[j]) {
        for (int i = 0; i < j; ++i) {
          if ((rel[i * K + j] & REL_EQUAL) && live[i]) {
            r = i;
            break;
          }
        }
      }
      rep[j] = r;
    }
    __syncthreads();
    if (tid < 2 * K) {  // row i's fold of pb (tid < K) or pnb
      const int i = tid % K;
      const float* x = tid < K ? pb(cur) : pnb(cur);
      float m = -INFINITY;
      for (int j = 0; j < K; ++j) m = fmaxf(m, rep[j] == i ? x[j] : BIG_NEG);
      float s = 0.0f;
      for (int j = 0; j < K; ++j) s += expf((rep[j] == i ? x[j] : BIG_NEG) - m);
      float v = m + logf(s);
      if (!isfinite(v)) v = BIG_NEG;
      (tid < K ? mpb : mpnb)[i] = rep[i] == i ? v : BIG_NEG;
    }
    __syncthreads();
  };

  int* rep = sel;  // the merge's column representatives reuse sel's words
  for (int t = 0; t < T; ++t) {
    const bool active = t < len;
    const int64_t frame = (int64_t)b * T + t;
    // this frame's loads, ahead of the merge that does not need them
    float my_plast = 0.0f, my_blank = 0.0f, my_tv = 0.0f;
    int my_ti = 0;
    if (active) {
      if (tid < K) {
        const int lt = last(cur)[tid];
        my_plast = lt < 0 ? BIG_NEG : lp[frame * C + lt];
        my_blank = lp[frame * C + blank];
      } else if (tid >= 32 && tid < 32 + P) {
        my_tv = top_val[frame * P + tid - 32];
        my_ti = top_idx[frame * P + tid - 32];
      }
    }
    merge(rep);
    if (!active) {  // frozen: the carry is the merged carry
      if (tid < K) {
        pb(cur)[tid] = mpb[tid];
        pnb(cur)[tid] = mpnb[tid];
      }
      __syncthreads();
      continue;
    }
    if (tid < K) {
      const float pa = lae(mpb[tid], mpnb[tid]);
      pany[tid] = pa;
      live[tid] = pa > BIG_NEG / 2;
      plast[tid] = my_plast;
      staypb[tid] = pa + my_blank;
    } else if (tid >= 32 && tid < 32 + P) {
      tv[tid - 32] = my_ti == blank ? BIG_NEG : my_tv;  // the blank is no extension
      ti[tid - 32] = my_ti;
    }
    __syncthreads();

    // stay candidates, with the extensions that recreate a beam folded in
    if (tid < K) {
      const int i = tid;
      const int li = last(cur)[i];
      const bool live_i = live[i];
      float m = -INFINITY;
      for (int j = 0; j < K; ++j) {
        const bool par = (rel[i * K + j] & REL_PARENT) && live_i && live[j];
        const float base = last(cur)[j] == li ? mpb[j] : pany[j];
        m = fmaxf(m, par ? base + plast[i] : BIG_NEG);
      }
      float s = 0.0f;
      for (int j = 0; j < K; ++j) {
        const bool par = (rel[i * K + j] & REL_PARENT) && live_i && live[j];
        const float base = last(cur)[j] == li ? mpb[j] : pany[j];
        s += expf((par ? base + plast[i] : BIG_NEG) - m);
      }
      float csum = m + logf(s);
      if (!isfinite(csum)) csum = BIG_NEG;
      const float stay_pnb = lae(mpnb[i] + plast[i], csum);
      cscore[i * P1] = lae(staypb[i], stay_pnb);
      cpnb[i * P1] = stay_pnb;
    }
    // extensions of beam j by the frame's p-th class
    for (int q = tid; q < K * P; q += THREADS) {
      const int j = q / P, p = q % P;
      const int tok = ti[p];
      const int lj = last(cur)[j];
      float ext = tok == lj ? mpb[j] + tv[p] : pany[j] + tv[p];
      if (plen(cur)[j] >= L) ext = BIG_NEG;  // a full prefix
      if (live[j]) {
        for (int i = 0; i < K; ++i) {
          if ((rel[i * K + j] & REL_PARENT) && live[i] && last(cur)[i] == tok) {
            ext = BIG_NEG;
            break;
          }
        }
      }
      cscore[j * P1 + 1 + p] = ext;
      cpnb[j * P1 + 1 + p] = ext;
    }
    __syncthreads();

    // the stable top K: rank = candidates before this one
    for (int c = tid; c < N; c += THREADS) {
      const float v = cscore[c];
      int rank = 0;
      for (int o = 0; o < N && rank < K; ++o) rank += before(cscore[o], o, v, c);
      if (rank < K) sel[rank] = c;
    }
    __syncthreads();

    // reorder into the other buffer
    const int nxt = cur ^ 1;
    for (int q = tid; q < K * L; q += THREADS) {
      const int r = q / L, l = q % L;
      const int c = sel[r], par = c / P1, slot = c % P1;
      int v = pref(cur)[par * L + l];
      if (slot > 0 && l == min(plen(cur)[par], L - 1)) v = ti[slot - 1];
      pref(nxt)[q] = v;
    }
    if (tid < K) {
      const int r = tid, c = sel[r], par = c / P1, slot = c % P1;
      if (slot > 0) {
        plen(nxt)[r] = plen(cur)[par] + 1;
        last(nxt)[r] = ti[slot - 1];
        pb(nxt)[r] = BIG_NEG;
        pnb(nxt)[r] = cpnb[c];
      } else {
        plen(nxt)[r] = plen(cur)[par];
        last(nxt)[r] = last(cur)[par];
        pb(nxt)[r] = staypb[par];
        pnb(nxt)[r] = cpnb[par * P1];
      }
    }
    __syncthreads();
    cur = nxt;
  }

  // the last merge, then a stable sort by score
  merge(rep);
  if (tid < K) pany[tid] = lae(mpb[tid], mpnb[tid]);
  __syncthreads();
  if (tid < K) {
    const int i = tid;
    const float v = pany[i];
    int rank = 0;
    for (int o = 0; o < K; ++o) rank += before(pany[o], o, v, i);
    const int64_t row = (int64_t)b * K + rank;
    out_plen[row] = plen(cur)[i];
    out_scores[row] = v;
    for (int l = 0; l < L; ++l) out_prefixes[row * L + l] = pref(cur)[i * L + l];
  }
}

}  // namespace

// K9. lp: (B, T, C) f32 log-probs; lengths: (B,) int64; top_val, top_idx:
// (B, T, P) f32 / int32 scratch (rows t >= len left unwritten); writes out_prefixes (B, K, L) int64,
// out_plen (B, K) int64 and out_scores (B, K) f32, best first. All
// contiguous; K, P in [1, 32], L in [1, 128], P <= C. Returns the first
// launch error or 0.
extern "C" int asr_ctc_prefix_beam(const float* lp, const int64_t* lengths, float* top_val,
                                   int* top_idx, int64_t* out_prefixes, int64_t* out_plen,
                                   float* out_scores, int B, int T, int C, int K, int P,
                                   int L, int blank, void* stream) {
  if (B == 0) return 0;
  if (K < 1 || K > MAX_K || P < 1 || P > MAX_P || P > C || L < 1 || L > MAX_L)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = B * T;
  if (rows > 0) {
    prefix_beam_rows_kernel<<<(rows + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0, s>>>(
        lp, lengths, rows, T, C, P, top_val, top_idx);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t bytes = (size_t)Layout(K, P, L).words * 4;
  cudaError_t err = cudaFuncSetAttribute(prefix_beam_recursion_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  prefix_beam_recursion_kernel<<<B, THREADS, bytes, s>>>(
      lp, lengths, top_val, top_idx, out_prefixes, out_plen, out_scores, T, C, K, P, L,
      blank);
  return (int)cudaGetLastError();
}
