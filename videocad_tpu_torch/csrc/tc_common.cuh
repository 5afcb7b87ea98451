// Building blocks of the bf16 tensor-core kernels (the "tc" variants of
// mhsa_short.cu, flash_attention.cu and fused_block.cu), for Hopper
// (sm_90a): ldmatrix, mma.sync.m16n8k16 by inline PTX, fragment packing,
// the dropout keep bits of a C fragment, cp.async, and the short-sequence
// attention core that K1 and K6 share (the scores of 16 query rows against
// up to 64 keys held in registers, their softmax, products with a (64, D)
// tile).
//
// Fragment layouts are the PTX ISA's for mma.m16n8k16 with bf16 operands:
// lane (g = lane / 4, t = lane % 4) holds, of a 16 x 8 C tile, the
// elements (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1), in that
// order. build.py hashes this header with every source, so an edit here
// rebuilds every library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(const __nv_bfloat16* p,
                                        uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(const __nv_bfloat16* p,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b over one 16 x 8 x 16 tile: a the A fragment (16 x 16, row
// major), (b0, b1) the B fragment (16 x 8), d the C fragment in f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 (to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The C fragments of two key tiles (16 keys) as the A fragment of a product
// over those keys, rounded to bf16.
__device__ __forceinline__ void to_a_fragment(const float (&lo)[4],
                                              const float (&hi)[4],
                                              uint32_t (&a)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Philox4x32-10 with key (seed, key_word) and counter (c0, c1, c2, c3):
// its four words. The key's second word keeps the kernel families' streams
// apart (ops/prng.py).
__device__ __forceinline__ uint4 philox(uint32_t seed, uint32_t key_word,
                                        uint32_t c0, uint32_t c1,
                                        uint32_t c2, uint32_t c3) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
  uint32_t k0 = seed, k1 = key_word;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kW0;
    k1 += kW1;
  }
  return make_uint4(c0, c1, c2, c3);
}

// keep_bits (below) with the counter words of the row this lane draws
// given by the caller: (row, batch) of row r0 + g for an even lane, of row
// r0 + g + 8 for an odd one, so that a warp's 16 rows need not share one
// batch.
template <int kTiles>
__device__ __forceinline__ uint32_t keep_bits_at(uint32_t seed,
                                                 uint32_t key_word,
                                                 uint32_t row, uint32_t batch,
                                                 uint32_t head, int c0,
                                                 int lane, int valid_cols,
                                                 uint32_t threshold) {
  static_assert(kTiles <= 8, "32 keep bits at most");
  const int t = lane & 3;
  const bool even = (t & 1) == 0;
  const int shift = even ? 0 : 2;     // the lane's keys are words 0-1 or 2-3
  uint32_t bits = 0xffffffffu;
#pragma unroll
  for (int n = 0; n < kTiles; ++n) {
    if (c0 + 8 * n >= valid_cols) break;
    const uint4 w = philox(seed, key_word,
                           (uint32_t)((c0 >> 2) + 2 * n + (t >> 1)), row,
                           head, batch);
    const uint32_t mine = (uint32_t)(w.x >= threshold) |
                          (uint32_t)(w.y >= threshold) << 1 |
                          (uint32_t)(w.z >= threshold) << 2 |
                          (uint32_t)(w.w >= threshold) << 3;
    const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
    const uint32_t upper = even ? mine : other;   // row r0 + g
    const uint32_t lower = even ? other : mine;   // row r0 + g + 8
    const uint32_t nibble =
        ((upper >> shift) & 3u) | (((lower >> shift) & 3u) << 2);
    bits = (bits & ~(0xfu << (4 * n))) | (nibble << (4 * n));
  }
  return bits;
}

// The keep bits of a warp's 16 query rows from r0 against the kTiles * 8
// keys from c0 (a multiple of 4), one per element of the C layout: bit
// 4n + e for element e of key tile n. A bit is the bit function's: word
// j % 4 of Philox4x32-10, key (seed, key_word), counter (j / 4, i, head,
// batch), kept where it is >= threshold. One Philox call per lane and key
// tile: the group of keys c0 + 8n + 4(t / 2) .. + 3 is held by lanes t and
// t ^ 1 of the quad, each for rows r0 + g and r0 + g + 8; the even lane
// draws row r0 + g, the odd one row r0 + g + 8, and they swap their four
// bits with one shuffle. Key tiles from valid_cols on keep every bit and
// cost no call.
template <int kTiles>
__device__ __forceinline__ uint32_t keep_bits(uint32_t seed,
                                              uint32_t key_word,
                                              uint32_t batch, uint32_t head,
                                              int r0, int c0, int lane,
                                              int valid_cols,
                                              uint32_t threshold) {
  const bool even = (lane & 1) == 0;
  return keep_bits_at<kTiles>(seed, key_word,
                              (uint32_t)(r0 + (lane >> 2) + (even ? 0 : 8)),
                              batch, head, c0, lane, valid_cols, threshold);
}

// 16 bytes from global to shared memory; src_bytes 0 zero-fills them.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most ``kPending`` committed groups are still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// A (64, <= 64) bf16 tile of the short-sequence attention cores (K1's tc
// kernels and K6's tc kernels): rows padded to 144 bytes, so that
// ldmatrix's eight row addresses fall on distinct banks.
constexpr int kTcStride = 72;

// s[n] += the C fragment of key tile n (keys 8n..8n+7) of A B^T, A the 16
// rows from r0 of tile a, B the rows of tile b: lane (g = lane / 4, t =
// lane % 4) holds s[n][e] at row r0 + g + 8 (e / 2), key 8n + 2t + e % 2.
// Key tiles from seq on are skipped (they stay as they were).
template <int D>
__device__ __forceinline__ void row_products(const __nv_bfloat16* a,
                                             const __nv_bfloat16* b, int r0,
                                             int lane, int seq,
                                             float (&s)[8][4]) {
  uint32_t frag[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(a + (r0 + (lane & 15)) * kTcStride + kk * 16 + (lane >> 4) * 8,
            frag[kk]);
#pragma unroll
  for (int n = 0; n < 8; n += 2) {
    if (8 * n >= seq) break;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t bf[4];
      ldsm_x4(b + (8 * n + (lane & 7) + ((lane >> 4) << 3)) * kTcStride +
                  kk * 16 + ((lane >> 3) & 1) * 8,
              bf);
      mma_bf16(s[n], frag[kk], bf[0], bf[1]);
      mma_bf16(s[n + 1], frag[kk], bf[2], bf[3]);
    }
  }
}

// acc[n] += the C fragment of output tile n (columns 8n..8n+7) of P X for
// the warp's 16 rows: p[kk] the A fragment of P's keys 16kk..16kk+15, X
// the (64, D) tile x read transposed by ldmatrix. Key steps from seq on are
// skipped.
template <int D>
__device__ __forceinline__ void times_tile(uint32_t (&p)[4][4],
                                           const __nv_bfloat16* x, int lane,
                                           int seq, float (&acc)[D / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (16 * kk >= seq) break;
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t bf[4];
      ldsm_x4_trans(x + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                            kTcStride +
                        8 * n + (lane >> 4) * 8,
                    bf);
      mma_bf16(acc[n], p[kk], bf[0], bf[1]);
      mma_bf16(acc[n + 1], p[kk], bf[2], bf[3]);
    }
  }
}

// The row softmax of the scores s (C layout, unscaled) in place: the
// weights in f32, key columns from seq on masked to weight 0.
__device__ __forceinline__ void softmax_rows(float (&s)[8][4], int lane,
                                             int seq, float scale_log2) {
  const int t = lane & 3;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (8 * n + 2 * t + (e & 1) >= seq) s[n][e] = -INFINITY;
      if (e < 2)
        m0 = fmaxf(m0, s[n][e]);
      else
        m1 = fmaxf(m1, s[n][e]);
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // exp(scale * (s - max)): the scale is positive, so the row's max of
      // the scaled scores is the scaled max.
      s[n][e] = exp2f((s[n][e] - (e < 2 ? m0 : m1)) * scale_log2);
      if (e < 2)
        l0 += s[n][e];
      else
        l1 += s[n][e];
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] *= e < 2 ? inv0 : inv1;
}

// The dropout constants of a launch, derived from the rate in the C
// entries as ops/prng.py:dropout_threshold and the wrappers compute them:
// the u32 cutoff floor(rate * 2^32) (bits below it are dropped; 0 turns
// dropout off) and the keep scale 1 / (1 - rate), both in double, rounded
// once. A rate outside [0, 1) is refused.
struct DropoutArgs {
  unsigned int threshold;
  float inv_keep;
};
inline bool bad_rate(double rate) { return !(rate >= 0.0 && rate < 1.0); }
inline DropoutArgs dropout_args(double rate) {
  const double scaled = rate * 4294967296.0;
  return {scaled >= 4294967295.0 ? 0xFFFFFFFFu : (unsigned int)scaled,
          (float)(1.0 / (1.0 - rate))};
}
// The scores' scale 1 / sqrt(head_dim), in double, rounded once.
inline float score_scale(int head_dim) {
  return (float)(1.0 / sqrt((double)head_dim));
}

}  // namespace
