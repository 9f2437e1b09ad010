// Hash dropout in one pass (K10): y = x * keep * c, forward and backward.
//
// Replaces no TPU kernel: the JAX package's ConfigurableDropout(impl="hash")
// (asr_chinese_e2e_tpu/models/layers.py) is elementwise integer code that
// XLA fuses into the multiply. Written as PyTorch tensor code
// (models/layers.py::hash_keep_mask) it is about 35 launches a mask, each
// through a full-size int64 temporary, and the mask is saved for the
// backward; this kernel hashes in registers and saves nothing.
//
// Semantics, bit for bit those of x * hash_keep_mask(seed, shape, rate,
// dtype, offset) (chunk ``m`` of ``tp`` of it along dim 1 for heads split
// over a mesh):
//   g = the element's index in the global tensor (+ offset), mod 2**32;
//   h = fmix32((g * 0x9E3779B9) ^ (seed * 0xC2B2AE35)): keep_hash(g, 0,
//       seed, 0) of common.cuh, the attention kernels' hash;
//   y = from_f32(to_f32(x) * (h >= threshold ? c : 0)),
// with c the kept value 1 / (1 - rate) as the mask holds it in x's dtype:
// the product is taken in f32 and rounded once to the dtype, as torch's
// bf16 multiply does, and a dropped element is x * 0 (signed zeros, NaN and
// Inf come out as they do from the mask). The backward is the same call on
// the gradient (torch's MulBackward: grad * mask).
//
// The global index of local element l: with the heads chunked (``chunk``
// elements a row of the local tensor, ``gap`` = (tp - 1) * chunk the other
// ranks' elements between two of its rows, m * chunk folded into offset),
// g = l + (l / chunk) * gap + offset; otherwise g = l + offset.
//
// What bounds it on the H100: bytes. Each element is read once and written
// once (2 x 2 bytes in bf16; 279 MB at the fill batch's (1024, 133, 512)
// encoder activation, 0.083 ms at 3.35 TB/s) against about 15 integer
// operations. Design: 16-byte loads and stores (8 bf16 or 4 f32 a thread), a
// grid-stride loop over the vectors with the grid sized to the SMs, 64-bit
// element indices and uint32 hash arithmetic in registers, the last
// n % VEC elements by the first threads of the grid, no shared memory, one
// launch a call on the caller's stream. A misaligned x or y runs the same
// loop one element at a time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;  // 2048 threads: an SM's full residency

struct DropArgs {
  int64_t chunk;  // elements a row of the local tensor (heads chunked only)
  uint32_t gap;   // (tp - 1) * chunk mod 2**32
  uint32_t offset;
  uint32_t seed;
  uint32_t threshold;
  float c;
};

// the global index (mod 2**32) of consecutive local elements from l on
template <bool kChunked>
struct GlobalIndex {
  uint32_t g;
  int64_t r;  // l's place in its row

  __device__ __forceinline__ GlobalIndex(int64_t l, const DropArgs& a) {
    if (kChunked) {
      const int64_t q = l / a.chunk;
      r = l - q * a.chunk;
      g = (uint32_t)l + (uint32_t)q * a.gap + a.offset;
    } else {
      r = 0;
      g = (uint32_t)l + a.offset;
    }
  }

  __device__ __forceinline__ uint32_t next(const DropArgs& a) {
    const uint32_t out = g++;
    if (kChunked && ++r == a.chunk) {  // the next row starts after a gap
      r = 0;
      g += a.gap;
    }
    return out;
  }
};

template <typename T>
__device__ __forceinline__ T drop(T x, uint32_t g, const DropArgs& a) {
  const bool keep = asr::keep_hash(g, 0u, a.seed, 0u) >= a.threshold;
  return asr::from_f32<T>(__fmul_rn(asr::to_f32(x), keep ? a.c : 0.0f));
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC, bool kChunked>
__global__ void __launch_bounds__(THREADS)
    hash_dropout_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n,
                        DropArgs a) {
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t n_vec = n / VEC;
  for (int64_t v = tid; v < n_vec; v += stride) {
    Pack<T, VEC> p = reinterpret_cast<const Pack<T, VEC>*>(x)[v];
    GlobalIndex<kChunked> idx(v * VEC, a);
#pragma unroll
    for (int k = 0; k < VEC; ++k) p.v[k] = drop(p.v[k], idx.next(a), a);
    reinterpret_cast<Pack<T, VEC>*>(y)[v] = p;
  }
  const int64_t l = n_vec * VEC + tid;  // the scalar tail
  if (l < n) {
    GlobalIndex<kChunked> idx(l, a);
    y[l] = drop(x[l], idx.next(a), a);
  }
}

// the current device's SMs; 0 on a failed query, which the launch then
// reports (a grid of no blocks)
int sm_count() {
  int dev = 0, count = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  return count;
}

template <typename T, int VEC>
void launch(const T* x, T* y, int64_t n, const DropArgs& a, cudaStream_t stream) {
  const int64_t items = n / VEC > 0 ? n / VEC : n;
  const int64_t want = (items + THREADS - 1) / THREADS;
  const int64_t most = (int64_t)sm_count() * BLOCKS_PER_SM;
  const int blocks = (int)(want < most ? want : most);
  if (a.chunk > 0) {
    hash_dropout_kernel<T, VEC, true><<<blocks, THREADS, 0, stream>>>(x, y, n, a);
  } else {
    hash_dropout_kernel<T, VEC, false><<<blocks, THREADS, 0, stream>>>(x, y, n, a);
  }
}

template <typename T>
void dispatch(const void* x, void* y, int64_t n, const DropArgs& a, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  if (aligned) {
    launch<T, VEC>((const T*)x, (T*)y, n, a, stream);
  } else {
    launch<T, 1>((const T*)x, (T*)y, n, a, stream);
  }
}

}  // namespace

// x, y: n contiguous elements, bf16 (is_bf16) or f32; chunk 0 when the
// heads are not chunked. Returns the launch's cudaError_t.
extern "C" int asr_hash_dropout(const void* x, void* y, int64_t n, int is_bf16,
                                int64_t chunk, unsigned gap, unsigned offset, unsigned seed,
                                unsigned threshold, float c, void* stream) {
  if (n <= 0) return 0;
  const DropArgs a{chunk, gap, offset, seed, threshold, c};
  if (is_bf16) {
    dispatch<__nv_bfloat16>(x, y, n, a, (cudaStream_t)stream);
  } else {
    dispatch<float>(x, y, n, a, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
