// Fused masked attention forward with in-kernel index-hash weight dropout.
//
// Replaces the TPU kernel asr_chinese_e2e_tpu/ops/fused_attention.py::
// _fwd_kernel (with _softmax_masked and _keep_mask), launched through
// _call_kernel. Per (b, h): S = Q K^T * scale, plus -1e9 where the key is
// masked (key length; optional causal, +-band or causal-band window, by
// global index), f32 row softmax, padded query rows zeroed, optional keep
// mask hashed from (i, j, seed, b*H + h) and scaled by 1/(1-rate), then
// (W o M) V. Inputs bf16 or f32, f32 accumulation, output in the input type.
// For training, the kernel also writes each query row's log-sum-exp of its
// masked scores (``lse``, when the pointer is not null), which the backward
// kernels (fused_attention_bwd.cu) use to recompute the weights.
//
// What bounds it on the H100, at the flagship's training shape (64, 8, 267,
// 64) bf16: q, k, v read and the output written once are 4 x 17.5 MB = 70.0
// MB, 20.9 us at 3.35 TB/s; the two products are 9.3 GFLOP, 9.4 us at the
// 989 TFLOP/s of the bf16 tensor cores, but 139 us at the 67 TFLOP/s of f32
// FMAs. The TPU kernel keeps a whole (Tq, Tk) f32 score tile in VMEM; a
// block has at most 227 KB of shared memory and that tile alone is 285 KB at
// T = 267, so the kernel is tiled, flash-style, and bytes bound it only if
// the products run on the tensor cores.
//
// bf16 inputs (attention_fwd_mma_kernel): tensor cores through
// mma.sync.m16n8k16 with ldmatrix, the FlashAttention-2 layout. One block of
// 4 warps per (b, h, 64 query rows), a warp owning 16 rows: with five
// 64-row tiles per (b, h) at T = 267 a 64-row warpgroup tile of wgmma has
// nothing to amortise, and mma.sync keeps the accumulator in a layout whose
// (row, column) each thread knows, which the mask and the hash need. Q, K
// and V tiles stay bf16 in shared memory (rows padded by 16 bytes against
// bank conflicts), fetched by 16-byte cp.async into a ring of two stages,
// so the next key tile's copy overlaps this tile's products; ragged edges
// are zero-filled by the copy and masked by index. Q fragments live in
// registers. The mask, the -1e9 bias, the online (max, sum) update and the
// keep hash run on the score accumulators, each thread deriving the global
// (i, j) of the elements it holds; the row max and sum cross the four
// threads of a row by two shuffles. The weights never touch shared memory:
// the accumulators of two neighbouring 8-key tiles are the A fragment of
// the (W o M) V product. That operand must be bf16. One rounding of W o M
// costs up to 2^-9 of each weight, and with the output's own rounding
// passes the 2e-2 bound of the training shape only narrowly (the windowed
// kernel measured 2.08e-2 with it), so W o M is split into hi + lo bf16
// parts and the product made twice: exact to 2^-17, for half again as
// many mma. Key tiles wholly masked by the key length, the causal mask or
// the band are skipped where their weights are exactly 0 (mma.cuh::
// key_tile_range). The output leaves through the warp's own rows of the Q
// tile in shared memory, as 16-byte stores. With the products on the tensor
// cores, what is left per element bounds the kernel: two compares and a
// select for the mask (against key ranges computed once per row), a
// subtraction and one ex2.approx for the exponential (the scores carry the
// factor log2 e from their scaling on, so a row of masked keys only, at
// -1e9, still weighs them exactly alike), and nine integer operations for
// the hash, on an integer pipe of half the FMA rate; so the dropout switch
// is a template parameter, and the -inf of keys past Tk is applied in the
// one ragged tile only.
//
// f32 inputs (attention_fwd_kernel<float>, the 1e-4 bound) keep the first
// design on plain f32 FMAs: 256 threads per 64 query rows, four threads
// sharing a row, each holding the whole q row in registers and scoring
// every fourth key of a 32-key tile staged as f32; probabilities cross
// shared memory. Its bf16 instantiation is built only under
// asr_attention_fwd_fma, for timing the two designs side by side.
// Masked keys get -1e9 added (not -inf), as the TPU kernel does, so a row
// whose keys are all masked averages over Tk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

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

// -- bf16 on the tensor cores ---------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(MMA_THREADS)
attention_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const int* __restrict__ q_len, const int* __restrict__ k_len,
                         __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                         int H, int Tq, int Tk, float scale, uint32_t seed,
                         uint32_t threshold, float keep_prob, int causal, int band) {
  using namespace asr;
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int LD = D + ATT_PAD;  // shared row stride
  constexpr int KS = D / 16;       // k-steps over the head dim
  constexpr int DN = D / 8;        // 8-column output tiles
  constexpr int NT = ATT_TILE / 8; // 8-key score tiles
  __shared__ __align__(16) __nv_bfloat16 Qs[ATT_TILE * LD];
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
  const int qn = q_len[b];
  const int kn = min(k_len[b], Tk);
  const uint32_t cell = (uint32_t)(b * H + h);
  const size_t bh = (size_t)b * H + h;
  const __nv_bfloat16* qb = q + bh * Tq * D;
  const __nv_bfloat16* kb = k + bh * Tk * D;
  const __nv_bfloat16* vb = v + bh * Tk * D;
  const bool warp_on = i0 + warp * 16 < Tq;  // else no row of this warp exists
  const int irow[2] = {i0 + warp * 16 + g, i0 + warp * 16 + g + 8};
  const float inv_keep = 1.0f / keep_prob;
  // Scores are kept in units of log 2 (scale and bias times log2 e), so a
  // weight is ex2 of a plain difference: exact 1 where a score equals its row
  // maximum, whatever its size. A row without a visible key has every score
  // at the bias (|s scale log2 e| < 64 is absorbed) and weighs its keys alike.
  const float scale2 = scale * LOG2E;
  constexpr float NEG_BIAS2 = NEG_BIAS * LOG2E;
  // row r sees the keys [jlo[r], jhi[r]]: key_visible, once per row
  const Window win = attention_window(causal, band);
  const int jlo[2] = {irow[0] - win.below, irow[1] - win.below};
  const int jhi[2] = {min(irow[0] + win.above, kn - 1), min(irow[1] + win.above, kn - 1)};

  int t_lo, t_hi;
  key_tile_range(i0, min(i0 + ATT_TILE, Tq) - 1, Tk, kn, causal, band, t_lo, t_hi);

  load_tile_async<D, MMA_THREADS>(Qs, qb, i0, Tq, tid);
  load_tile_async<D, MMA_THREADS>(Ks[0], kb, t_lo * ATT_TILE, Tk, tid);
  load_tile_async<D, MMA_THREADS>(Vs[0], vb, t_lo * ATT_TILE, Tk, tid);
  cp_async_commit();

  uint32_t qf[KS][4];
  float o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    if (t + 1 < t_hi) {  // the next tile's copy overlaps this tile's products
      load_tile_async<D, MMA_THREADS>(Ks[st ^ 1], kb, (t + 1) * ATT_TILE, Tk, tid);
      load_tile_async<D, MMA_THREADS>(Vs[st ^ 1], vb, (t + 1) * ATT_TILE, Tk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: tile t (and Q) have landed
    __syncthreads();

    if (warp_on) {
      if (t == t_lo) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          ldmatrix_x4(qf[ks], &Qs[(warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8]);
      }
      const int j0 = t * ATT_TILE;

      // S = Q K^T: 16 rows x 64 keys per warp
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t kf[4];
          ldmatrix_x4(kf, &Ks[st][(np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + ks * 16 +
                                  ((lane >> 3) & 1) * 8]);
          mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);
        }
      }

      // mask and bias on the accumulators; row max over the quad
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + nt * 8 + 2 * t4 + (e & 1);
          const bool keep = j >= jlo[e >> 1] && j <= jhi[e >> 1];
          s[nt][e] = s[nt][e] * scale2 + (keep ? 0.0f : NEG_BIAS2);
        }
      }
      if (j0 + ATT_TILE > Tk) {  // the ragged tile: past the key axis is not a key at all
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j0 + nt * 8 + 2 * t4 + (e & 1) >= Tk) s[nt][e] = -INFINITY;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      float corr[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        corr[r] = ex2(m_run[r] - m_new);  // 0 on the first tile
        m_run[r] = m_new;
      }
      // probabilities, their row sum, and the keep mask
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(s[nt][e] - m_run[e >> 1]);
          psum[e >> 1] += p;
          if (DROPOUT) {
            const int j = j0 + nt * 8 + 2 * t4 + (e & 1);
            const uint32_t x = keep_hash((uint32_t)irow[e >> 1], (uint32_t)j, seed, cell);
            p = x >= threshold ? p * inv_keep : 0.0f;
          }
          s[nt][e] = p;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
        l_run[r] = l_run[r] * corr[r] + psum[r];
      }
#pragma unroll
      for (int dn = 0; dn < DN; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dn][e] *= corr[e >> 1];

      // O += (P o M) V, the weights as hi + lo bf16 fragments
#pragma unroll
      for (int ks = 0; ks < NT / 2; ++ks) {
        uint32_t hi[4], lo[4];
        split_fragment(s, ks, hi, lo);
        mma_split<D>(o, hi, lo, &Vs[st][ks * 16 * LD], lane);
      }
    }
    __syncthreads();  // tile t consumed before its stage is filled again
  }

  if (!warp_on) return;
  // normalise, zero the padded rows, and leave through this warp's own rows
  // of the Q tile (its fragments are in registers) as 16-byte stores
  float norm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    norm[r] = irow[r] < qn ? 1.0f / l_run[r] : 0.0f;
    if (lse != nullptr && t4 == 0 && irow[r] < Tq)
      lse[bh * Tq + irow[r]] = m_run[r] * LN2 + logf(l_run[r]);
  }
  __nv_bfloat16* stage = Qs + warp * 16 * LD;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      *reinterpret_cast<__nv_bfloat162*>(&stage[(g + 8 * r) * LD + dn * 8 + 2 * t4]) =
          __floats2bfloat162_rn(o[dn][2 * r] * norm[r], o[dn][2 * r + 1] * norm[r]);
    }
  }
  __syncwarp();
  constexpr int CPR = D / 8;
  for (int c = lane; c < 16 * CPR; c += 32) {
    const int r = c / CPR;
    const int cc = c - r * CPR;
    const int i = i0 + warp * 16 + r;
    if (i < Tq)
      *reinterpret_cast<uint4*>(out + (bh * Tq + i) * D + cc * 8) =
          *reinterpret_cast<const uint4*>(&stage[r * LD + cc * 8]);
  }
}

template <int D, bool DROPOUT>
void launch_mma(const void* q, const void* k, const void* v, const int* q_len,
                const int* k_len, void* out, float* lse, int B, int H, int Tq,
                int Tk, float scale, uint32_t seed, uint32_t threshold,
                float keep_prob, int causal, int band, cudaStream_t stream) {
  dim3 grid((Tq + asr::ATT_TILE - 1) / asr::ATT_TILE, H, B);
  attention_fwd_mma_kernel<D, DROPOUT><<<grid, MMA_THREADS, 0, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      q_len, k_len, (__nv_bfloat16*)out, lse, H, Tq, Tk, scale, seed, threshold,
      keep_prob, causal, band);
}

}  // namespace

// q: (B, H, Tq, D), k/v: (B, H, Tk, D), out: (B, H, Tq, D), all contiguous,
// bf16 (is_bf16=1) or f32; q_len/k_len: (B,) int32 on the device; lse:
// (B, H, Tq) f32 row log-sum-exp output, or null. bf16 runs on the tensor
// cores, f32 on FMAs. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a head dim without an instantiation.
#define ASR_ATTN_ARGS                                                          \
  q, k, v, q_len, k_len, out, lse, B, H, Tq, Tk, scale, seed, threshold,        \
      keep_prob, dropout, causal, band, (cudaStream_t)stream
// the tensor-core kernel has the dropout switch at compile time
#define ASR_ATTN_MMA(DIM)                                                      \
  do {                                                                         \
    if (dropout)                                                               \
      launch_mma<DIM, true>(q, k, v, q_len, k_len, out, lse, B, H, Tq, Tk,      \
                            scale, seed, threshold, keep_prob, causal, band,    \
                            (cudaStream_t)stream);                             \
    else                                                                       \
      launch_mma<DIM, false>(q, k, v, q_len, k_len, out, lse, B, H, Tq, Tk,     \
                             scale, seed, threshold, keep_prob, causal, band,   \
                             (cudaStream_t)stream);                            \
  } while (0)

extern "C" int asr_attention_fwd(const void* q, const void* k, const void* v,
                                 const int* q_len, const int* k_len, void* out,
                                 float* lse, int B, int H, int Tq, int Tk, int D,
                                 int is_bf16, float scale, unsigned int seed,
                                 unsigned int threshold, float keep_prob,
                                 int dropout, int causal, int band,
                                 void* stream) {
  if (D == 64) {
    if (is_bf16) ASR_ATTN_MMA(64); else launch<float, 64>(ASR_ATTN_ARGS);
  } else if (D == 32) {
    if (is_bf16) ASR_ATTN_MMA(32); else launch<float, 32>(ASR_ATTN_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The FMA design for both input types: what bf16 calls ran before the
// tensor-core kernel. Nothing in the package calls it; it is built so that
// the two designs can be timed side by side in one process.
extern "C" int asr_attention_fwd_fma(const void* q, const void* k, const void* v,
                                     const int* q_len, const int* k_len, void* out,
                                     float* lse, int B, int H, int Tq, int Tk, int D,
                                     int is_bf16, float scale, unsigned int seed,
                                     unsigned int threshold, float keep_prob,
                                     int dropout, int causal, int band,
                                     void* stream) {
  if (D == 64) {
    if (is_bf16) launch<__nv_bfloat16, 64>(ASR_ATTN_ARGS); else launch<float, 64>(ASR_ATTN_ARGS);
  } else if (D == 32) {
    if (is_bf16) launch<__nv_bfloat16, 32>(ASR_ATTN_ARGS); else launch<float, 32>(ASR_ATTN_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
#undef ASR_ATTN_MMA
#undef ASR_ATTN_ARGS
