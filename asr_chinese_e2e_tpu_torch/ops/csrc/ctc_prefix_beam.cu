// The rescore mode's device CTC prefix beam search (K9).
//
// Replaces the lax.scan over frames of
// asr_chinese_e2e_tpu/decode/ctc_prefix_device.py::ctc_prefix_beam_device
// (:71-228, the scan at :214), which XLA compiles into one loop on the TPU:
// no Pallas kernel stood there, but the port's plain version
// (decode/ctc_prefix_device.py::ctc_prefix_beam_reference) is a host loop
// of about 165 small launches a frame. This computes what that loop
// computes, in f32, with torch's logaddexp formula and the accurate expf /
// logf / log1pf, so that the kernel and its plain version round alike:
//
//   per frame t, per utterance b (state: K prefixes of at most L stored
//   tokens, their lengths, last tokens and (pb, pnb) log masses):
//   1. merge duplicate prefixes: each live prefix's first live equal row
//      takes the masked log-sum-exp of its copies' masses (the other K - 1
//      entries count as BIG_NEG), the copies get BIG_NEG;
//   2. the frame's top P classes in torch's stable order (value descending,
//      the lower index first among equals); the blank keeps its slot with
//      the value BIG_NEG;
//   3. the stay candidate (stay_pb, stay_pnb) and the K x P extensions; a
//      token equal to the beam's last extends only its blank-ended mass, a
//      full prefix (plen >= L) does not extend;
//   4. merge before select: an extension of beam j that recreates beam i
//      (i = j + [last_i], both live) folds into i's stay candidate and is
//      killed;
//   5. the stable top K of the K (P + 1) candidates; the parents' prefixes
//      are gathered and the token written at min(plen, L - 1);
//   6. past the utterance's length the carry is the merged carry.
//   At the end one more merge and a stable sort by score.
//
// What bounds it on the H100: the rows t < len of the log-probs must be read
// once, 13 MB at the flagship's serving batch, 0.004 ms at 3.35 TB/s; the
// real limit is the chain of frames, each a few dependent warp steps per
// utterance. Two launches:
//
// - the row pass, a block of four warps per (b, t) row with t < len: thread
//   tid visits the classes c = tid (mod 128) in increasing order, 16 loads
//   in flight, and keeps the best PMAX (P rounded up to a power of two) in a
//   sorted register list, inserting a class only ahead of the entries it
//   comes before, so an equal value never displaces a lower index; each
//   warp merges its 32 lists by P rounds of two warp reductions (the largest
//   value's 32-bit order key, then the least class index holding it), the
//   winner popping its head, and one warp merges the four warp lists the
//   same way into (B, T, P) scratch. Every frame runs at once.
// - the search, a warp per utterance, lane i holding beam i (K <= 32) in
//   registers: its length, last token, folded (pb, pnb), log p_any, its
//   liveness and the lane of its parent (the live beam it extends by one
//   token), with no block barrier. What follows from the plain loop, and
//   shapes the design (tests/test_torch_ctc_prefix_beam_kernel.py holds a
//   rehearsal of it to the plain version):
//   * live beams are distinct strings at every frame: the merge kills
//     copies, a live stay is one per beam, two live extensions that spell
//     one string would need equal parents, and an extension that spells a
//     live beam is killed (step 4). So step 1 folds each row into itself,
//     and step 4's fold has at most one term. Such a fold is exact without
//     a transcendental: x + 0 (the sum is exp(0) = 1) where x is finite and,
//     for K > 1, above BIG_NEG, else BIG_NEG. It is done at the end of the
//     frame.
//   * a live beam is at most L tokens long (a full prefix's extensions
//     are BIG_NEG, dead, and so are their children), so its stored tokens
//     are its string; only dead beams overwrite slot L - 1, and the plain
//     loop masks every pair relation by liveness. No pair at length L - 1
//     or above needs its tokens compared.
//   * the parent relation is carried from frame to frame, not recomputed
//     from the K x K x L tokens: an extension's parent is its own parent's
//     stay, if that was selected (any other copy of that string was killed
//     in step 4); a stay's is the stay of its parent's parent, if that was
//     live. The one relation that does not carry is a stay whose parent
//     string was in no beam, recreated this frame by an extension of a
//     shorter beam. A warp match on (length, last token) against the stay's
//     (length - 1, second to last token) names the candidates, and only
//     their stored tokens are compared, from the end. No other pair
//     compares tokens.
//   * the top K: the K (P + 1) candidates, index c = j (P + 1) + slot, lie
//     in contiguous blocks of ceil(K (P + 1) / 32) a lane (all 32 lanes
//     work), each packed as (order key of its value, complement of its
//     place) into 64 bits and sorted in the lane. K rounds: one warp
//     reduction of the heads' order keys, a ballot, and the lowest lane
//     holding the maximum wins (its indices are below the next lane's, so
//     ties keep the stable order) and shifts its block, with no branch.
//   * the stored tokens sit in a pool of K rows in shared memory: a
//     parent's first child keeps its row, its other children copy it, 16
//     bytes at a time and all at once, into the rows of the beams that have
//     no child, and an extension writes its token: no K x L copy a frame.
//     The next frame's top P, blank and the p(last token) of every beam it
//     can hold (the K current last tokens and the P classes of this frame)
//     are loaded a frame ahead.
//   Ties stay exact: the order keys are a bijection of the floats (-0 taken
//   as +0, the plain sort's tie), and every merge picks the lowest index
//   among equal values.
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
constexpr int ROW_WARPS = 4;  // a row's warps
constexpr int ROW_THREADS = ROW_WARPS * 32;
constexpr int ROW_CHUNK = 16;  // a thread's loads in flight
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

// a key whose unsigned order is the floats' order, -0 taken as +0; 0 is
// left for "no candidate"
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the masked log-sum-exp of decode/ctc_prefix_device.py over K entries of
// which only x is unmasked (the others count as BIG_NEG). Its terms are 0, 1
// or exp(x - m), so it is exactly x + log 1 = x + 0 where x is finite and,
// for K > 1, above BIG_NEG, and BIG_NEG elsewhere (BIG_NEG + log(K - 1 or
// K) rounds to BIG_NEG, or the sum is not finite)
__device__ __forceinline__ float fold1(float x, int K) {
  return isfinite(x) && (K == 1 || x > BIG_NEG) ? x + 0.0f : BIG_NEG;
}

// a candidate's place in its lane's stable order, as one integer: the order
// key of its value above, the complement of its slot below (the lower slot
// first among equals); 0 is "none"
__device__ __forceinline__ unsigned long long pack(float v, int slot) {
  return ((unsigned long long)order_key(v) << 32) | (unsigned)~slot;
}

// a load issued where it stands: the compiler may not sink it to its use,
// a frame later (read-only data)
__device__ __forceinline__ float load_now(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ int load_now(const int* p) {
  int v;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// One round of a merge of sorted lists: the warp's best head by (value,
// index); true in the lane that holds it. key 0: an empty list; `m` the
// largest key, 0 if every list is empty.
__device__ __forceinline__ bool warp_best(unsigned key, int idx, unsigned& m) {
  m = __reduce_max_sync(FULL, key);
  const unsigned least = __reduce_min_sync(FULL, key == m ? (unsigned)idx : UINT_MAX);
  return m != 0u && key == m && (unsigned)idx == least;
}

template <int PMAX>
__global__ void __launch_bounds__(ROW_THREADS)
prefix_beam_rows_kernel(const float* __restrict__ lp, const int64_t* __restrict__ lengths,
                        int T, int C, int P, float* __restrict__ top_val,
                        int* __restrict__ top_idx) {
  __shared__ float s_val[ROW_WARPS][MAX_P];
  __shared__ int s_idx[ROW_WARPS][MAX_P];
  const int row = blockIdx.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (row % T >= lengths[row / T]) return;  // the whole block
  float lv[PMAX];
  int li[PMAX];
#pragma unroll
  for (int q = 0; q < PMAX; ++q) {
    lv[q] = -INFINITY;
    li[q] = INT_MAX;
  }
  const float* x = lp + (int64_t)row * C;
  for (int base = tid; base < C; base += ROW_THREADS * ROW_CHUNK) {
    float v[ROW_CHUNK];
#pragma unroll
    for (int u = 0; u < ROW_CHUNK; ++u) {
      const int c = base + u * ROW_THREADS;
      v[u] = c < C ? __ldg(x + c) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < ROW_CHUNK; ++u) {
      int ci = base + u * ROW_THREADS;
      float cv = v[u];
      if (ci < C && before(cv, ci, lv[PMAX - 1], li[PMAX - 1])) {
#pragma unroll
        for (int q = 0; q < PMAX; ++q) {  // the new entry bubbles into place
          if (before(cv, ci, lv[q], li[q])) {
            const float tv = lv[q];
            const int ti = li[q];
            lv[q] = cv;
            li[q] = ci;
            cv = tv;
            ci = ti;
          }
        }
      }
    }
  }
  // the warp's top P: the winner pops its head
  for (int r = 0; r < P; ++r) {
    const unsigned key = li[0] == INT_MAX ? 0u : order_key(lv[0]);
    unsigned m;
    if (warp_best(key, li[0], m)) {
      s_val[warp][r] = lv[0];
      s_idx[warp][r] = li[0];
#pragma unroll
      for (int q = 0; q + 1 < PMAX; ++q) {
        lv[q] = lv[q + 1];
        li[q] = li[q + 1];
      }
      lv[PMAX - 1] = -INFINITY;
      li[PMAX - 1] = INT_MAX;
    } else if (m == 0u && lane == 0) {
      s_val[warp][r] = -INFINITY;
      s_idx[warp][r] = INT_MAX;
    }
  }
  __syncthreads();
  if (warp != 0) return;
  // the four warp lists, lane w < 4 holding warp w's head
  int head = 0;
  for (int r = 0; r < P; ++r) {
    const bool has = lane < ROW_WARPS && head < P && s_idx[lane][head] != INT_MAX;
    const float hv = has ? s_val[lane][head] : 0.0f;
    const int hi = has ? s_idx[lane][head] : INT_MAX;
    unsigned m;
    if (warp_best(has ? order_key(hv) : 0u, hi, m)) {
      top_val[(int64_t)row * P + r] = hv;
      top_idx[(int64_t)row * P + r] = hi;
      ++head;
    } else if (m == 0u && lane == 0) {
      top_val[(int64_t)row * P + r] = -INFINITY;
      top_idx[(int64_t)row * P + r] = INT_MAX;
    }
  }
}

// UMAX: the most candidates a lane holds, ceil(K (P + 1) / 32) or more
template <int UMAX>
__global__ void __launch_bounds__(32)
prefix_beam_recursion_kernel(const float* __restrict__ lp, const int64_t* __restrict__ lengths,
                             const float* __restrict__ top_val, const int* __restrict__ top_idx,
                             int64_t* __restrict__ out_prefixes, int64_t* __restrict__ out_plen,
                             float* __restrict__ out_scores, int T, int C, int K, int P, int L,
                             int blank) {
  __shared__ __align__(16) int s_tok[MAX_K * (MAX_L + 4)];  // K token rows, stride LS
  __shared__ float s_tv[MAX_P];         // the frame's top P, the blank's as BIG_NEG
  __shared__ int s_ti[MAX_P];
  __shared__ unsigned s_kill[MAX_K];    // beam j's killed extensions, bits over q
  __shared__ int s_stay[MAX_K];         // old beam a -> the new lane of its stay
  __shared__ int s_free[MAX_K];         // the rows of the beams with no child
  __shared__ int s_nrow[MAX_K];         // the new beams' token rows
  __shared__ int s_sel[MAX_K];          // round r's winner, a candidate index
  // every beam's numbers its candidates need
  __shared__ float s_score[MAX_K], s_mpb[MAX_K], s_pany[MAX_K];
  __shared__ int s_last[MAX_K], s_full[MAX_K];
  const int b = blockIdx.x, lane = threadIdx.x;
  const bool beam = lane < K;
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  const int64_t len = lengths[b];
  const int nfr = len < T ? (int)len : T;
  const float* rows = lp + (int64_t)b * T * C;
  const int64_t top0 = (int64_t)b * T * P;
  // a token row's stride: 16-byte rows a bank group apart
  const int LS = ((L + 3) & ~3) + 4;
  // the K (P + 1) candidates c = j (P + 1) + slot, U a lane in order:
  // lane l holds c0 = l U to c0 + U - 1
  const int P1 = P + 1, N = K * P1, U = (N + 31) / 32, c0 = lane * U;

  // lane state: beam `lane` (inert on lanes >= K)
  int plen = 0, last = -1, par = -1, row = lane;
  float mpb = fold1(lane == 0 ? 0.0f : BIG_NEG, K), mpnb = fold1(BIG_NEG, K);
  float pany = lae(mpb, mpnb);
  bool live = beam && pany > BIG_NEG / 2;
  // frame 0's inputs; every beam is empty, so p(last) is BIG_NEG
  float tv = 0.0f, pbl = 0.0f, pl = BIG_NEG;
  int ti = 0;
  if (nfr > 0) {
    tv = top_val[top0 + min(lane, P - 1)];
    ti = top_idx[top0 + min(lane, P - 1)];
    pbl = rows[blank];
  }

  for (int t = 0; t < nfr; ++t) {
    // the next frame's loads, a frame ahead of their use (the last frame
    // reads its own row again, unused)
    const int tn = t + 1 < nfr ? t + 1 : t;
    const float* nrow = rows + (int64_t)tn * C;
    const int64_t ntop0 = top0 + (int64_t)tn * P + min(lane, P - 1);
    const float ntv = load_now(top_val + ntop0);
    const int nti = load_now(top_idx + ntop0);
    const float ntop = load_now(nrow + ti);  // p(this frame's class q) at the next frame
    const float nlast_v = load_now(nrow + (last >= 0 ? last : blank));
    const float npbl = load_now(nrow + blank);
    __syncwarp();  // the last frame's readers of the shared arrays are done
    if (lane < P) {
      s_tv[lane] = ti == blank ? BIG_NEG : tv;
      s_ti[lane] = ti;
    }
    if (beam) {
      s_kill[lane] = 0u;
      s_stay[lane] = -1;
    }
    __syncwarp();

    // where my last token stands in the top P
    int pos = -1;
#pragma unroll 4
    for (int q = 0; q < P; ++q) pos = s_ti[q] == last ? q : pos;
    // the stay, with the one extension that recreates it folded in (step 4)
    const int src = par >= 0 ? par : lane;
    const float par_mpb = __shfl_sync(FULL, mpb, src);
    const float par_pany = __shfl_sync(FULL, pany, src);
    const int par_last = __shfl_sync(FULL, last, src);
    const bool par_live = __shfl_sync(FULL, (int)live, src);
    const bool member = beam && par >= 0 && live && par_live;
    const float csum =
        fold1(member ? (par_last == last ? par_mpb : par_pany) + pl : BIG_NEG, K);
    const float staypb = pany + pbl;
    const float stay_pnb = lae(mpnb + pl, csum);
    const float stay_score = lae(staypb, stay_pnb);
    if (member && pos >= 0) atomicOr(&s_kill[par], 1u << pos);

    if (beam) {
      s_score[lane] = stay_score;
      s_mpb[lane] = mpb;
      s_pany[lane] = pany;
      s_last[lane] = last;
      s_full[lane] = plen >= L;
    }
    __syncwarp();

    // my candidates' values, packed with their place in my block
    unsigned long long cand[UMAX];
    {
      int j = c0 / P1, slot = c0 - j * P1;
#pragma unroll
      for (int u = 0; u < UMAX; ++u) {
        cand[u] = 0ull;
        if (u < U && c0 + u < N) {  // the stay's value and slot q + 1's, then a select
          const int q = slot > 0 ? slot - 1 : 0;
          const float ext = s_full[j] || (s_kill[j] >> q & 1u)
                                ? BIG_NEG
                                : (s_ti[q] == s_last[j] ? s_mpb[j] : s_pany[j]) + s_tv[q];
          cand[u] = pack(slot > 0 ? ext : s_score[j], u);
        }
        if (++slot == P1) {
          slot = 0;
          ++j;
        }
      }
    }
    // sorted, best first: a pop is a shift
#pragma unroll
    for (int i = 1; i < UMAX; ++i) {
#pragma unroll
      for (int u = i; u > 0; --u) {
        const unsigned long long hi = cand[u] > cand[u - 1] ? cand[u] : cand[u - 1];
        cand[u] = cand[u] > cand[u - 1] ? cand[u - 1] : cand[u];
        cand[u - 1] = hi;
      }
    }

    // the stable top K: K rounds over the lanes' heads; the lowest lane
    // that holds the largest order key (the lowest index among equals)
    // wins, records its candidate and pops it, with no branch
    for (int r = 0; r < K; ++r) {
      const unsigned key = (unsigned)(cand[0] >> 32);
      const unsigned m = __reduce_max_sync(FULL, key);
      const bool win = lane == __ffs(__ballot_sync(FULL, key == m)) - 1;
      if (win) s_sel[r] = c0 + (int)~(unsigned)cand[0];
#pragma unroll
      for (int u = 0; u + 1 < UMAX; ++u) cand[u] = win ? cand[u + 1] : cand[u];
      cand[UMAX - 1] = win ? 0ull : cand[UMAX - 1];
    }
    __syncwarp();

    // the new beam `lane`: parent a, stay (slot 0) or extension by class slot - 1
    const int sel = beam ? s_sel[lane] : lane * P1;
    const int a = sel / P1, my_slot = sel - a * P1;
    const bool is_ext = beam && my_slot > 0;
    const int a_plen = __shfl_sync(FULL, plen, a);
    const int a_last = __shfl_sync(FULL, last, a);
    const int a_row = __shfl_sync(FULL, row, a);
    const int a_par = __shfl_sync(FULL, par, a);
    const float a_staypb = __shfl_sync(FULL, staypb, a);
    const float a_stay_pnb = __shfl_sync(FULL, stay_pnb, a);
    const float a_mpb = __shfl_sync(FULL, mpb, a);
    const float a_pany = __shfl_sync(FULL, pany, a);
    const unsigned a_kill = beam ? s_kill[a] : 0u;
    const bool a_par_live = __shfl_sync(FULL, (int)live, a_par >= 0 ? a_par : 0) && a_par >= 0;
    const float next_top = __shfl_sync(FULL, ntop, is_ext ? my_slot - 1 : 0);
    const float next_last = __shfl_sync(FULL, last >= 0 ? nlast_v : BIG_NEG, a);
    const int tok = is_ext ? s_ti[my_slot - 1] : a_last;
    // the selected candidate's pnb: the extension's score, or the stay's pnb
    float my_pnb = a_stay_pnb;
    if (is_ext) {
      const int q = my_slot - 1;
      my_pnb = a_plen >= L || (a_kill >> q & 1u) ? BIG_NEG
                                                 : (tok == a_last ? a_mpb : a_pany) + s_tv[q];
    }

    // token rows: a parent's first child keeps its row, the others take the
    // rows of the beams with no child, in order
    const unsigned has_child = __reduce_or_sync(FULL, beam ? 1u << a : 0u);
    const unsigned same = __match_any_sync(FULL, beam ? a : MAX_K + lane);
    const bool first = __ffs(same) - 1 == lane;
    const unsigned copiers = __ballot_sync(FULL, beam && !first);
    const unsigned childless = (K == 32 ? FULL : (1u << K) - 1u) & ~has_child;
    if (beam && (childless >> lane & 1u)) s_free[__popc(childless & below)] = row;
    if (beam && !is_ext) s_stay[a] = lane;
    __syncwarp();
    const int new_row = !beam ? lane : first ? a_row : s_free[__popc(copiers & below)];
    if (beam && !first) {  // 16 bytes at a time, the copiers at once
      const int4* from = (const int4*)(s_tok + a_row * LS);
      int4* to = (int4*)(s_tok + new_row * LS);
      for (int q = 0; q < (min(a_plen, L) + 3) / 4; ++q) to[q] = from[q];
    }
    __syncwarp();
    if (is_ext) s_tok[new_row * LS + min(a_plen, L - 1)] = tok;

    // the new state, folded (the next frame's merge: each row into itself)
    if (beam) {
      plen = is_ext ? a_plen + 1 : a_plen;
      last = tok;
      row = new_row;
      mpb = fold1(is_ext ? BIG_NEG : a_staypb, K);
      mpnb = fold1(my_pnb, K);
      pany = lae(mpb, mpnb);
      live = pany > BIG_NEG / 2;
      pl = is_ext ? next_top : next_last;
      s_nrow[lane] = row;
    }
    __syncwarp();
    // the parent relation, carried
    int npar = -1;
    if (is_ext)
      npar = s_stay[a];
    else if (beam && a_par_live)
      npar = s_stay[a_par];
    // a stay whose parent string was in no beam: a live extension of this
    // frame one token shorter that spells it. A match on (length, last
    // token) against mine (length - 1, second to last) names the few
    // candidates; their stored tokens are compared from the end.
    const bool seek = beam && !is_ext && !a_par_live && live && plen >= 2;
    const bool target = is_ext && live;
    const int* mine = s_tok + row * LS;
    unsigned long long want = 1ull << 63 | lane;  // matches nothing
    if (seek) want = (unsigned long long)(plen - 1) << 32 | (unsigned)mine[plen - 2];
    if (target) want = (unsigned long long)plen << 32 | (unsigned)last;
    unsigned cands = __match_any_sync(FULL, want) & __ballot_sync(FULL, target);
    for (; seek && cands && npar < 0; cands &= cands - 1u) {
      const int r = __ffs(cands) - 1;
      const int* other = s_tok + s_nrow[r] * LS;
      int q = plen - 3;
      while (q >= 0 && mine[q] == other[q]) --q;
      if (q < 0) npar = r;
    }
    par = npar;
    tv = ntv;
    ti = nti;
    pbl = npbl;
  }

  // the last merge is the identity on folded rows; a stable sort by score
  __syncwarp();
  if (beam) s_tv[lane] = pany;
  __syncwarp();
  int rank = 0;
  for (int o = 0; o < K; ++o) rank += before(s_tv[o], o, pany, lane);
  if (beam) {
    s_free[rank] = lane;
    out_plen[(int64_t)b * K + rank] = plen;
    out_scores[(int64_t)b * K + rank] = pany;
  }
  __syncwarp();
  for (int r = 0; r < K; ++r) {  // the warp writes one prefix at a time
    const int i = s_free[r];
    const int from = __shfl_sync(FULL, row, i), n = __shfl_sync(FULL, min(plen, L), i);
    int64_t* out = out_prefixes + ((int64_t)b * K + r) * L;
    for (int q = lane; q < L; q += 32) out[q] = q < n ? s_tok[from * LS + q] : 0;
  }
}

template <int PMAX>
cudaError_t launch_rows(const float* lp, const int64_t* lengths, int rows, int T, int C, int P,
                        float* top_val, int* top_idx, cudaStream_t s) {
  prefix_beam_rows_kernel<PMAX><<<rows, ROW_THREADS, 0, s>>>(lp, lengths, T, C, P, top_val,
                                                             top_idx);
  return cudaGetLastError();
}

template <int UMAX>
void launch_search(const float* lp, const int64_t* lengths, const float* top_val,
                   const int* top_idx, int64_t* out_prefixes, int64_t* out_plen,
                   float* out_scores, int B, int T, int C, int K, int P, int L, int blank,
                   cudaStream_t s) {
  prefix_beam_recursion_kernel<UMAX><<<B, 32, 0, s>>>(lp, lengths, top_val, top_idx,
                                                      out_prefixes, out_plen, out_scores, T, C,
                                                      K, P, L, blank);
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
    cudaError_t err;
    if (P <= 4)
      err = launch_rows<4>(lp, lengths, rows, T, C, P, top_val, top_idx, s);
    else if (P <= 8)
      err = launch_rows<8>(lp, lengths, rows, T, C, P, top_val, top_idx, s);
    else if (P <= 16)
      err = launch_rows<16>(lp, lengths, rows, T, C, P, top_val, top_idx, s);
    else
      err = launch_rows<32>(lp, lengths, rows, T, C, P, top_val, top_idx, s);
    if (err != cudaSuccess) return (int)err;
  }
  const int per_lane = (K * (P + 1) + 31) / 32;
  if (per_lane <= 4)
    launch_search<4>(lp, lengths, top_val, top_idx, out_prefixes, out_plen, out_scores, B, T, C,
                     K, P, L, blank, s);
  else if (per_lane <= 8)
    launch_search<8>(lp, lengths, top_val, top_idx, out_prefixes, out_plen, out_scores, B, T, C,
                     K, P, L, blank, s);
  else if (per_lane <= 16)
    launch_search<16>(lp, lengths, top_val, top_idx, out_prefixes, out_plen, out_scores, B, T,
                      C, K, P, L, blank, s);
  else
    launch_search<33>(lp, lengths, top_val, top_idx, out_prefixes, out_plen, out_scores, B, T,
                      C, K, P, L, blank, s);
  return (int)cudaGetLastError();
}
