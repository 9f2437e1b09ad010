// Building blocks of the tensor-core attention kernels: 16-byte asynchronous
// copies into shared memory (cp.async, zero-filling), ldmatrix fragment
// loads, the bf16 mma.sync.m16n8k16 product with f32 accumulators, the
// hi + lo split that feeds an f32 operand to it, and the key-tile range a
// block of query rows has to visit.
//
// Fragment layout of mma.m16n8k16 (lane = 4 g + t, g = 0..7, t = 0..3):
//   A (16 x 16, row):  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16 x 8, col):   b0 (k = 2t..2t+1, n = g)          b1 (k = 2t+8.., n = g)
//   C (16 x 8, f32):   c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// so the accumulators of two neighbouring 8-column tiles, packed in pairs,
// are the A fragment of the next product without leaving the registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace asr {

constexpr int ATT_TILE = 64;  // rows of a query block and of a key tile
constexpr int ATT_PAD = 8;    // bf16 of padding per shared row: ldmatrix without bank conflicts

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + ATT_TILE) of a (rows, D) bf16 array -> a shared tile with
// row stride D + ATT_PAD; rows at or past ``limit`` are zero-filled
template <int D, int THREADS>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src, int r0,
                                                int limit, int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  constexpr int LD = D + ATT_PAD;
#pragma unroll
  for (int c = tid; c < ATT_TILE * CPR; c += THREADS) {
    const int r = c / CPR;
    const int cc = c - r * CPR;
    const bool ok = r0 + r < limit;
    cp_async16(dst + r * LD + cc * 8, src + (size_t)(ok ? r0 + r : 0) * D + cc * 8, ok);
  }
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l & 7 of matrix
// l >> 3, and receives of each matrix the pair (row g, columns 2t..2t+1)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// the same, transposed: the pair (rows 2t..2t+1, column g) of each matrix
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a b, (16 x 16) x (16 x 8), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// 2^x as one ex2.approx.ftz; 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// exp(x - m) as one fused multiply-add and one ex2.approx.ftz, given
// neg_m_log2e = -m log2(e); exp(-inf) = 0. (__expf adds a range test and two
// multiplies per call to keep denormal results, which a weight does not need.)
// The rounding of neg_m_log2e is 2^-24 of it: nothing for a row maximum of
// ordinary size, but not for m = -1e9 (a row of masked keys only).
__device__ __forceinline__ float exp_sub(float x, float neg_m_log2e) {
  return ex2(fmaf(x, LOG2E, neg_m_log2e));
}

// (x, y) = hi + lo with hi = bf16(x, y) and lo = bf16((x, y) - hi), each
// packed with x in the low half: an f32 operand as two bf16 operands,
// exact to about 2^-17 of its size
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// A fragments (hi and lo) of columns [16 ks, 16 ks + 16) of a 16 x 64 f32
// accumulator tile held as eight 16 x 8 accumulators
__device__ __forceinline__ void split_fragment(const float (&acc)[8][4], int ks,
                                               uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_pair(acc[2 * ks][0], acc[2 * ks][1], hi[0], lo[0]);
  split_pair(acc[2 * ks][2], acc[2 * ks][3], hi[1], lo[1]);
  split_pair(acc[2 * ks + 1][0], acc[2 * ks + 1][1], hi[2], lo[2]);
  split_pair(acc[2 * ks + 1][2], acc[2 * ks + 1][3], hi[3], lo[3]);
}

// acc (16 x D) += (hi + lo) B, for a 16 x 16 operand given as its hi and lo
// fragments and B = rows [0, 16) of a shared tile with row stride D +
// ATT_PAD (``rows`` points at the first). All the hi products are started
// before the lo ones: the two updates of one accumulator are then D / 8
// products apart, and the second does not wait out the first's latency.
template <int D>
__device__ __forceinline__ void mma_split(float (&acc)[D / 8][4], const uint32_t (&hi)[4],
                                          const uint32_t (&lo)[4],
                                          const __nv_bfloat16* rows, int lane) {
  constexpr int LD = D + ATT_PAD;
  uint32_t f[D / 16][4];
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp)
    ldmatrix_x4_trans(f[dp], rows + (lane & 15) * LD + dp * 16 + (lane >> 4) * 8);
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    mma_bf16(acc[2 * dp], hi, f[dp][0], f[dp][1]);
    mma_bf16(acc[2 * dp + 1], hi, f[dp][2], f[dp][3]);
  }
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    mma_bf16(acc[2 * dp], lo, f[dp][0], f[dp][1]);
    mma_bf16(acc[2 * dp + 1], lo, f[dp][2], f[dp][3]);
  }
}

// A fragment of rows (r0 + g, r0 + g + 8), columns [16 ks, 16 ks + 16) of a
// (rows, D) bf16 array in device memory; rows at or past ``limit`` are zero
template <int D>
__device__ __forceinline__ void load_a_fragment(uint32_t (&a)[4], const __nv_bfloat16* src,
                                                int r0, int limit, int ks, int lane) {
  const int g = lane >> 2;
  const int c = ks * 16 + 2 * (lane & 3);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = r0 + g + 8 * (e & 1);
    const int col = c + 8 * (e >> 1);
    a[e] = r < limit ? *reinterpret_cast<const uint32_t*>(src + (size_t)r * D + col) : 0u;
  }
}

// key_visible as a range: row i sees the keys [i - below, i + above] that lie
// under the key length, so a kernel tests an element with two compares
// against bounds it computed once per row
struct Window {
  int below, above;
};

__device__ __forceinline__ Window attention_window(int causal, int band) {
  constexpr int FAR = 1 << 29;  // no limit on that side
  Window w;
  w.below = band > 0 ? band : FAR;
  w.above = causal ? 0 : (band > 0 ? band : FAR);
  return w;
}

// Key tiles [lo, hi) that query rows [i0, i_last] have to visit. A masked
// key has the score -1e9 and weighs exp(-1e9 - m) = 0 exactly in f32 as soon
// as its row sees one key, so a tile of masked keys may be skipped when
// every row of the block sees a key: always without a band (k_len >= 1, and
// key 0 is causal to every row), and with a band when i_last - band < kn.
// Otherwise a row without a visible key averages over all Tk keys, as the
// TPU kernel does, and every tile is visited.
__device__ __forceinline__ void key_tile_range(int i0, int i_last, int Tk, int kn,
                                               int causal, int band, int& lo, int& hi) {
  lo = 0;
  hi = (Tk + ATT_TILE - 1) / ATT_TILE;
  if (band > 0 && i_last > kn - 1 + band) return;
  int last = min(Tk, kn);  // one past the last visible key
  if (causal) {
    last = min(last, i_last + 1);
  } else if (band > 0) {
    last = min(last, i_last + band + 1);
  }
  if (band > 0) lo = max(0, i0 - band) / ATT_TILE;
  hi = (last + ATT_TILE - 1) / ATT_TILE;
}

}  // namespace asr
