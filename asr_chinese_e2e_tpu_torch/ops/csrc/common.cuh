// Helpers shared by the port's kernels: bf16/f32 conversion, the index-hash
// keep mask of the attention kernels, and the attention masks by global
// index.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace asr {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// murmur3-style finalizer over (i, j, seed, cell): the TPU kernels'
// ops/fused_attention.py _keep_mask, in the natural uint32 wrap-around
// arithmetic
__device__ __forceinline__ uint32_t keep_hash(uint32_t i, uint32_t j,
                                              uint32_t seed, uint32_t cell) {
  uint32_t x = (i * 0x9E3779B9u) ^ (j * 0x85EBCA6Bu) ^
               (seed * 0xC2B2AE35u + cell * 0x27D4EB2Fu);
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// key j is visible from query i: inside the key length, and inside the
// causal / causal-band / +-band window (ops/fused_attention.py
// _softmax_masked)
__device__ __forceinline__ bool key_visible(int i, int j, int kn, int causal,
                                            int band) {
  bool keep = j < kn;
  if (causal) {
    keep = keep && (j <= i);
    if (band > 0) keep = keep && (i - j <= band);
  } else if (band > 0) {
    keep = keep && (abs(i - j) <= band);
  }
  return keep;
}

}  // namespace asr
