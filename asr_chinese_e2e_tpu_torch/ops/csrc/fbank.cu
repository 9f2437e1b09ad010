// Fused log-mel filterbank: framing + windowed DFT + power + mel + log.
//
// Replaces the TPU kernel asr_chinese_e2e_tpu/ops/fbank_pallas.py::_kernel
// (launched by log_mel_spectrogram_pallas). Same math as the plain version
// data/features.py::log_mel_spectrogram: frame t of the reflect-padded wave
// covers samples [t*hop, t*hop + win); re/im are its dot products with the
// windowed cos / -sin bases (win x n_freq), power = re^2 + im^2, then the
// (n_freq x n_mels) mel product and log(x + 1e-20).
//
// What bounds it on the H100: the function needs a real FFT and the
// non-zero taps of the mel filters, 0.54 GFLOP at (64, 128000), against
// 49.2 MB of samples in and log-mel out: bytes, 14.7 us at 3.35 TB/s. A
// dense DFT is 17 GFLOP a product at that shape: on f32 FMAs (the first
// design) 0.26 ms at best, on the tensor cores 17 us.
//
// Design: the TPU kernel's decomposition, on mma.sync.m16n8k16. Viewed as
// rows of ``hop`` samples, frame t is rows t, t+1, ..., t+C-1 (C = ceil(win
// / hop); the last row only up to win - (C-1) hop), so re|im of a tile of 64
// frames is sum_c A_c W_c, A_c the tile's 64 consecutive rows starting c rows
// down: contiguous blocks of one staged sample tile, no frame tensor and no
// gather. The wave's reflect padding is done by the loader (an index
// reflection), so the wrapper makes no padded copy.
//  - Operands. f32 samples and basis go in as hi + lo fp16 pieces, three
//    products hi.hi + hi.lo + lo.hi, f32 accumulators. bf16 pieces (2^-17)
//    leak a strong tone's power into the quiet mel bands of speech-like
//    waves by up to 4.3e-2 of the log-mel (tests/test_torch_fbank_mma.py);
//    fp16 pieces (2^-22) stay at the plain f32 version's own rounding. fp16
//    has a small range, so each block scales its samples by the power of
//    two that puts their largest magnitude in [2^14, 2^15) (exact) and the
//    power back by its square.
//  - Samples. The tile's R = 64 + C - 1 rows are copied as f32 by cp.async,
//    all at once, then split into their fp16 pieces in shared memory.
//  - Basis. (K steps of 16 rows) x 416 columns, cos and sin interleaved
//    (column 2f = cos f, 2f + 1 = sin f) so that re and im of one bin meet in
//    one thread's accumulator pair and the power is formed in registers;
//    rows of a step past the window or past ``hop`` are zero. Built once per
//    device and configuration (ops/fbank.py), 0.4 MB a piece, streamed from
//    L2 through a ring of four shared-memory stages by cp.async, one 16-row
//    step at a time, into ldmatrix.trans B fragments, loaded one pair of n8
//    tiles ahead of the products that take them.
//  - Tiling, decided by registers: 416 columns x 64 frames of f32
//    accumulators are 208 a thread for 4 warps, so 8 warps each hold 32
//    frames x 104 columns (two m16 tiles x 13 n8 tiles, 104 accumulators,
//    215 registers in all); each basis fragment feeds two m tiles, each
//    sample fragment 13 n tiles. 64 frames a block: the basis crosses L2
//    once per 64 frames (533 MB at the training shape) and (8, 128000)
//    still gives 104 blocks.
//  - Mel by its non-zero taps. The power tile goes to shared memory (over
//    the consumed basis stages); each (frame, mel) output sums only its own
//    contiguous bins of the triangular filter, from a (first bin, count,
//    weights) table built with the basis, then takes log(x + 1e-20); only
//    the (B, T, n_mels) log-mel is written.
// Where the time goes (PERF.md, NVIDIA H100 80GB HBM3): at (64, 128000)
// ~0.2 ms in the 25 basis steps (the stream of the basis from L2, 2.8 TB/s,
// with the products at a quarter of the tensor cores' rate) and ~0.1 ms
// that one block per SM cannot hide: its prologue (samples) and epilogue
// (the mel, 0.05 ms).

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int FRAMES = 64;         // frames per block
constexpr int WARPS = 8;           // 2 frame halves x 4 column quarters
constexpr int THREADS = 32 * WARPS;
constexpr int COLS = 416;          // interleaved cos|sin columns: n_freq <= 208
constexpr int WARP_NT = 13;        // n8 tiles per warp: COLS / 4 / 8
constexpr int LDB = COLS + 8;      // basis stage row stride, halves: ldmatrix without conflicts
constexpr int STAGES = 4;          // basis steps in flight
constexpr int STAGE_HALVES = 2 * 16 * LDB;  // hi and lo rows of one 16-row step

// c += a b, (16 x 16) x (16 x 8), fp16 operands, f32 accumulators
__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Geometry {
  int S, T, pad;         // samples, frames, reflect padding on each side
  int win, hop, n_freq, n_mels;
  int W, R;              // staged row width, staged rows
  int n_steps;           // 16-row basis steps
};

// where padded-wave sample p of an utterance lies in it: reflected at
// both ends (torch's reflect padding, pad < S); -1 past the padded end
__device__ __forceinline__ int padded_index(int p, const Geometry& g) {
  if (p >= g.S + 2 * g.pad) return -1;
  int i = p - g.pad;
  if (i < 0) i = -i;
  if (i >= g.S) i = 2 * (g.S - 1) - i;
  return i;
}

__global__ void __launch_bounds__(THREADS, 1)
fbank_mma_kernel(const float* __restrict__ wave, const __half* __restrict__ basis,
                 const int* __restrict__ taps, const float* __restrict__ weights,
                 int n_taps, float* __restrict__ out, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int LDX = g.W + 8;  // sample row stride, halves
  __half* Xhi = reinterpret_cast<__half*>(smem);
  __half* Xlo = Xhi + g.R * LDX;
  __half* stages = Xlo + g.R * LDX;
  float* power = reinterpret_cast<float*>(stages);  // after the DFT, over the stages
  float* raw = reinterpret_cast<float*>(stages + STAGES * STAGE_HALVES);  // R x hop f32
  int* tab = reinterpret_cast<int*>(raw + g.R * g.hop);
  float* wts = reinterpret_cast<float*>(tab + 2 * g.n_mels + 1);
  float* red = wts + n_taps;  // WARPS floats

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * FRAMES;
  const float* x = wave + (size_t)b * g.S;
  const size_t rows_per_step = (size_t)16 * COLS;
  const __half* basis_lo = basis + (size_t)g.n_steps * rows_per_step;

  // the tile's samples, f32, all in flight at once (4-byte copies: a row of
  // the padded wave is as aligned as hop and pad make it), zero past the end
  const int n_raw = g.R * g.hop;
  for (int e = tid; e < n_raw; e += THREADS) {
    const int i = padded_index(t0 * g.hop + e, g);
    asr::cp_async4(raw + e, x + (i < 0 ? 0 : i), i >= 0);
  }
  asr::cp_async_commit();

  // one 16-row step of the basis (hi and lo) into a stage, 16-byte copies
  auto load_step = [&](int s) {
    __half* dst = stages + (s % STAGES) * STAGE_HALVES;
    const __half* hi = basis + s * rows_per_step;
    const __half* lo = basis_lo + s * rows_per_step;
    for (int c = tid; c < 2 * 16 * (COLS / 8); c += THREADS) {
      const int piece = c / (16 * (COLS / 8));
      const int rc = c - piece * 16 * (COLS / 8);
      const int r = rc / (COLS / 8);
      const int cc = rc - r * (COLS / 8);
      asr::cp_async16(dst + (piece * 16 + r) * LDB + cc * 8,
                      (piece ? lo : hi) + r * COLS + cc * 8, true);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < g.n_steps) load_step(s);
    asr::cp_async_commit();
  }

  // the tap table; then the samples' largest magnitude, and their pieces
  for (int i = tid; i < 2 * g.n_mels + 1; i += THREADS) tab[i] = taps[i];
  for (int i = tid; i < n_taps; i += THREADS) wts[i] = weights[i];
  asr::cp_async_wait<STAGES - 1>();  // the samples (the basis steps may be in flight)
  __syncthreads();
  float mx = 0.0f;
  for (int e = tid; e < n_raw; e += THREADS) mx = fmaxf(mx, fabsf(raw[e]));
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, red[w]);
  int e2;
  frexpf(mx, &e2);  // mx = m 2^e2, m in [0.5, 1); 0 for a silent tile
  // samples x 2^shift: largest in [2^14, 2^15); a power of two, so exact
  const int shift = min(max(15 - e2, -100), 100);
  const float scale = exp2f((float)shift);
  for (int r = warp; r < g.R; r += WARPS) {
    for (int c = lane; c < g.W; c += 32) {
      const float v = c < g.hop ? raw[r * g.hop + c] * scale : 0.0f;
      const __half h = __float2half_rn(v);
      Xhi[r * LDX + c] = h;
      Xlo[r * LDX + c] = __float2half_rn(v - __half2float(h));
    }
  }
  __syncthreads();  // the pieces are staged: each step reads them before its barrier

  // re|im = sum over the steps of A B: warp (frames 32 mh.., columns 104 nq..)
  const int mh = warp & 1;
  const int col0 = (warp >> 1) * (WARP_NT * 8);
  float acc[2][WARP_NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < WARP_NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  int c_off = 0, k0 = 0;  // this step's row offset and first column of a sample row
  constexpr int NP = (WARP_NT + 1) / 2;  // pairs of n8 tiles (the last pair's second is
                                         // the next quarter's: loaded, not used)
  for (int s = 0; s < g.n_steps; ++s) {
    // the samples are resident: their fragments before the step's barrier
    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int row = 32 * mh + 16 * mt + c_off + (lane & 15);
      const int col = k0 + (lane >> 4) * 8;
      asr::ldmatrix_x4(ahi[mt], Xhi + row * LDX + col);
      asr::ldmatrix_x4(alo[mt], Xlo + row * LDX + col);
    }
    asr::cp_async_wait<STAGES - 2>();
    __syncthreads();  // step s has landed, and step s - 1's stage is free
    if (s + STAGES - 1 < g.n_steps) load_step(s + STAGES - 1);
    asr::cp_async_commit();

    // B fragments one pair ahead of the products that take them
    const __half* st = stages + (s % STAGES) * STAGE_HALVES + (lane & 15) * LDB + col0 +
                       (lane >> 4) * 8;
    uint32_t bh[2][4], bl[2][4];
    asr::ldmatrix_x4_trans(bh[0], st);
    asr::ldmatrix_x4_trans(bl[0], st + 16 * LDB);
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      const int cur = np & 1;
      if (np + 1 < NP) {
        asr::ldmatrix_x4_trans(bh[cur ^ 1], st + (np + 1) * 16);
        asr::ldmatrix_x4_trans(bl[cur ^ 1], st + 16 * LDB + (np + 1) * 16);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int nt = 2 * np + h;
        if (nt < WARP_NT) {
          // the three products of one accumulator two apart
          mma_f16(acc[0][nt], ahi[0], bh[cur][2 * h], bh[cur][2 * h + 1]);
          mma_f16(acc[1][nt], ahi[1], bh[cur][2 * h], bh[cur][2 * h + 1]);
          mma_f16(acc[0][nt], ahi[0], bl[cur][2 * h], bl[cur][2 * h + 1]);
          mma_f16(acc[1][nt], ahi[1], bl[cur][2 * h], bl[cur][2 * h + 1]);
          mma_f16(acc[0][nt], alo[0], bh[cur][2 * h], bh[cur][2 * h + 1]);
          mma_f16(acc[1][nt], alo[1], bh[cur][2 * h], bh[cur][2 * h + 1]);
        }
      }
    }
    // next step: 16 columns on, or the next row offset
    k0 += 16;
    if (k0 >= g.hop || c_off * g.hop + k0 >= g.win) {
      k0 = 0;
      ++c_off;
    }
  }
  asr::cp_async_wait<0>();
  __syncthreads();  // every stage consumed: the power tile goes over them

  // power = re^2 + im^2 in registers, scaled back, into the (64, PS) tile
  const int PS = 8 * ((g.n_freq + 7) / 8) + 4;  // row stride: stores without conflicts
  const float unscale = exp2f((float)(-2 * shift));
  const int gr = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < WARP_NT; ++nt) {
      const int f = (col0 + nt * 8) / 2 + t4;
      if (f < g.n_freq) {
        const int fr = 32 * mh + 16 * mt + gr;
        const float* a = acc[mt][nt];
        power[fr * PS + f] = (a[0] * a[0] + a[1] * a[1]) * unscale;
        power[(fr + 8) * PS + f] = (a[2] * a[2] + a[3] * a[3]) * unscale;
      }
    }
  }
  __syncthreads();

  // mel by the non-zero taps (two sums a filter, for the latency), then the
  // log; a warp a frame, a lane a filter
  const int n_fr = min(FRAMES, g.T - t0);
  float* ob = out + ((size_t)b * g.T + t0) * g.n_mels;
  for (int fr = warp; fr < n_fr; fr += WARPS) {
    for (int m = lane; m < g.n_mels; m += 32) {
      const float* p = power + fr * PS + tab[m];
      const int w0 = tab[g.n_mels + m];
      const int n = tab[g.n_mels + m + 1] - w0;
      const float* w = wts + w0;
      float s0 = 0.0f, s1 = 0.0f;
      int j = 0;
      for (; j + 1 < n; j += 2) {
        s0 = fmaf(p[j], w[j], s0);
        s1 = fmaf(p[j + 1], w[j + 1], s1);
      }
      if (j < n) s0 = fmaf(p[j], w[j], s0);
      ob[fr * g.n_mels + m] = logf(s0 + s1 + 1e-20f);
    }
  }
}

}  // namespace

// wave: (B, S) f32, not padded (the kernel reflects ``pad`` samples at each
// end; 0 when not centred); basis: (2, n_steps * 16, 416) fp16 hi and lo
// pieces from ops/fbank.py; taps: (2 n_mels + 1) int32, each filter's first
// bin, then the offsets of its weights in ``weights`` (n_taps f32); out:
// (B, T, n_mels) f32. Returns cudaErrorInvalidValue for a geometry the
// kernel does not take (ops/fbank.py checks it first), else
// cudaGetLastError() after the launch.
extern "C" int asr_fbank(const float* wave, int B, int S, int T, int pad,
                         const void* basis, int n_steps, const int* taps,
                         const float* weights, int n_taps, float* out, int win,
                         int hop, int n_freq, int n_mels, void* stream) {
  Geometry g;
  g.S = S;
  g.T = T;
  g.pad = pad;
  g.win = win;
  g.hop = hop;
  g.n_freq = n_freq;
  g.n_mels = n_mels;
  g.W = 16 * ((hop + 15) / 16);
  g.R = FRAMES + (win + hop - 1) / hop - 1;  // a frame spans ceil(win / hop) rows
  g.n_steps = n_steps;
  const size_t x_bytes = 2 * sizeof(__half) * (size_t)g.R * (g.W + 8);
  const size_t stage_bytes = sizeof(__half) * (size_t)STAGES * STAGE_HALVES;
  const size_t power_bytes = sizeof(float) * (size_t)FRAMES * (8 * ((n_freq + 7) / 8) + 4);
  const size_t raw_bytes = sizeof(float) * (size_t)g.R * hop;
  const size_t smem = x_bytes + stage_bytes + raw_bytes + sizeof(int) * (2 * n_mels + 1) +
                      sizeof(float) * (n_taps + WARPS);
  if (2 * n_freq > COLS || power_bytes > stage_bytes || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fbank_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + FRAMES - 1) / FRAMES, B);
  fbank_mma_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      wave, (const __half*)basis, taps, weights, n_taps, out, g);
  return (int)cudaGetLastError();
}
