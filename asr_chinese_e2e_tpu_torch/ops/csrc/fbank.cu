// Fused log-mel filterbank: framing + windowed DFT + power + mel + log.
//
// Replaces the TPU kernel asr_chinese_e2e_tpu/ops/fbank_pallas.py::_kernel
// (launched by log_mel_spectrogram_pallas). Same math as the plain version
// data/features.py::log_mel_spectrogram: frame t of the reflect-padded wave
// covers samples [t*hop, t*hop + win); re/im are its dot products with the
// windowed cos / -sin bases (win x n_freq), power = re^2 + im^2, then the
// (n_freq x n_mels) mel product and log(x + 1e-20). Everything is f32 with
// plain FMAs: no TF32, no tensor cores.
//
// What bounds it on the H100: about 0.33 MFLOP per frame (two 400x201
// dot-product sets plus the 201x80 mel product) against 640 bytes of new
// samples and 320 bytes of output per frame, so a call at serving shapes
// (8 x 801 frames) is a few GFLOP over a few MB: it is bound by launch
// cost and by the rate at which the bases stream from L2, not by HBM.
//
// Design: one block per (utterance, tile of FT frames). The block stages
// the tile's sample window ((FT-1)*hop + win floats) in shared memory once.
// Each thread owns one frequency bin at a time and keeps FT re and FT im
// accumulators in registers, so every basis value it loads from global
// memory (L2-resident: 643 KB for both bases) is reused FT times; the
// sample reads are shared-memory broadcasts. Power goes to shared memory,
// and the mel product and log follow in the same block, so only the
// (FT, n_mels) log-mel tile is written back. The TPU kernel's hop-chunk
// decomposition and 128-lane padding exist for Mosaic and are not used.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int FT = 16;        // frames per block
constexpr int THREADS = 256;

__global__ void fbank_kernel(const float* __restrict__ wave, int S, int T,
                             const float* __restrict__ cos_b,
                             const float* __restrict__ sin_b,
                             const float* __restrict__ mel_fb,
                             float* __restrict__ out, int win, int hop,
                             int n_freq, int n_mels) {
  extern __shared__ float smem[];
  const int n_samp = (FT - 1) * hop + win;
  float* samp = smem;              // (n_samp,)
  float* power = smem + n_samp;    // (FT, n_freq)

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * FT;
  const int n_fr = min(FT, T - t0);
  const float* row = wave + (size_t)b * S + (size_t)t0 * hop;
  const int avail = S - t0 * hop;
  for (int i = threadIdx.x; i < n_samp; i += blockDim.x) {
    samp[i] = i < avail ? row[i] : 0.0f;
  }
  __syncthreads();

  for (int f = threadIdx.x; f < n_freq; f += blockDim.x) {
    float re[FT], im[FT];
#pragma unroll
    for (int fr = 0; fr < FT; ++fr) {
      re[fr] = 0.0f;
      im[fr] = 0.0f;
    }
    for (int n = 0; n < win; ++n) {
      const float c = cos_b[n * n_freq + f];
      const float s = sin_b[n * n_freq + f];
#pragma unroll
      for (int fr = 0; fr < FT; ++fr) {
        const float x = samp[fr * hop + n];
        re[fr] = fmaf(x, c, re[fr]);
        im[fr] = fmaf(x, s, im[fr]);
      }
    }
#pragma unroll
    for (int fr = 0; fr < FT; ++fr) {
      power[fr * n_freq + f] = re[fr] * re[fr] + im[fr] * im[fr];
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < n_fr * n_mels; idx += blockDim.x) {
    const int fr = idx / n_mels;
    const int m = idx - fr * n_mels;
    const float* p = power + fr * n_freq;
    float acc = 0.0f;
    for (int f = 0; f < n_freq; ++f) {
      acc = fmaf(p[f], mel_fb[f * n_mels + m], acc);
    }
    out[((size_t)b * T + t0 + fr) * n_mels + m] = logf(acc + 1e-20f);
  }
}

}  // namespace

// wave: (B, S) f32, already reflect-padded; out: (B, T, n_mels) f32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int asr_fbank(const float* wave, int B, int S, int T,
                         const float* cos_b, const float* sin_b,
                         const float* mel_fb, float* out, int win, int hop,
                         int n_freq, int n_mels, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(FT - 1) * hop + win + (size_t)FT * n_freq);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fbank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((T + FT - 1) / FT, B);
  fbank_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      wave, S, T, cos_b, sin_b, mel_fb, out, win, hop, n_freq, n_mels);
  return (int)cudaGetLastError();
}
