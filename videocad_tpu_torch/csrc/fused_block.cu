// The ViT's two pre-LN sub-blocks, each as one fused kernel, forward and
// backward, with dropout inside the kernels, for Hopper (sm_90a).
//
// Replaces the TPU kernels of videocad_tpu/ops/fused_block.py:
//   attn_block_fwd  <- _attn_fwd  (-> pl.pallas_call, body _attn_fwd_kernel)
//   attn_block_bwd  <- _attn_bwd_vjp (body _attn_bwd_kernel)
//   mlp_block_fwd   <- _mlp_fwd   (body _mlp_fwd_kernel)
//   mlp_block_bwd   <- _mlp_bwd_vjp (body _mlp_bwd_kernel)
// They compute the same functions over x (B, T, D):
//   attention: y = x + drop1(MHSA_drop0(LN(x) Wq, LN(x) Wk, LN(x) Wv) Wo + bo)
//   MLP:       y = x + drop3(drop2(gelu(LN(x) W1 + b1)) W2 + b2), erf GELU
// with the rounding points of the Pallas bodies: LayerNorm statistics in
// f32; h = LN(x) rounded to the I/O dtype before each projection; every
// product accumulated in f32; q, k, v rounded before the score product; the
// softmax in f32; the dropped weights rounded before the product with v;
// the merged heads, the hidden layer, the masked output gradient, ds, dq,
// dk, dv and dz rounded before the products that consume them. The
// backward recomputes everything from x and redraws the masks from the
// seed: only x, the parameters and the seed live between the two.
// GELU uses erff (the Pallas body a rational approximation of erf, error
// 1.5e-7, because its compiler has none).
//
// Weights are read where PyTorch keeps them, by strides: a weight arrives
// as a (in, out) view with element strides (s_in, s_out), so nn.Linear's
// (out, in) storage is read without a transposed copy.
//
// The dropout bits. The TPU kernels seed a hardware generator per (frame,
// site). Here bits(seed, site, frame, head, row, col) is word col % 4 of
// Philox4x32-10 with key (seed, 3 + site) and counter (col / 4, row, head,
// frame); site 0 the attention weights (row = query, col = key), site 1 the
// attention branch (head 0, col < D), site 2 the hidden layer (col < F),
// site 3 the MLP branch. A function of the indices only, so forward and
// backward draw one mask whatever their grids, and key words 3..6 are used
// by no other kernel family (0, 1, 2 are taken).
// videocad_tpu_torch/ops/prng.py computes the same function in PyTorch
// integer ops for the plain versions.
//
// What bounds them on the card: operations. At the flagship's shapes (T =
// 50, D = 512, 16 heads of 64, F = 512) the attention forward does about
// 220 MFLOP a frame against 100 KB of bf16 I/O, the MLP forward 52 MFLOP,
// the backwards two to three times that with the weight gradients: far
// right of the card's ridge, so the floor is the tensor cores' rate (0.34,
// 0.94, 0.08 and 0.20 ms at 1,528 frames in bf16).
//
// Two designs. The kernels in float32 and every shape the second design
// does not take ("tile") put every product of a
// block through one routine, gemm_tile: a 64 x 64 output tile, both
// operands staged 32 deep through shared memory, one tile ahead through
// registers; bf16 tiles move as 16-byte groups onto the tensor cores
// (mma.sync m16n16k16 through nvcuda::wmma), float32 runs as f32 FMAs on a
// 4 x 4 register tile a thread. One block of 8 warps an SM (its f32 sums
// take 128 KB of shared memory), every tile's chain of load, stage,
// barrier, multiply, barrier exposed, and a softmax core in scalar f32: at
// the flagship's shapes the attention kernels ran at 2.4% and 3.9% of
// their floors.
//
// The attention sub-block's "tc" variant (bf16, heads of 64, D a multiple
// of 64: attn_fwd_tc_kernel, attn_bwd_tc_kernel) runs every product on the
// tensor cores, on operands that arrive through a ring of cp.async stages
// of 64-deep chunks (loads in flight while the tensor cores work, one
// barrier a chunk), its accumulators in registers, rounded to bf16 straight
// into shared memory:
//   * a head's q, k and v are one 64 x 192 product over D; the forward runs
//     it, and o = a Wo^T, on wgmma (a warpgroup 64 x 96 of it, both
//     operands read by the tensor cores from 128-byte-swizzled stages); the
//     backward on mma.sync m16n8k16 (csrc/tc_common.cuh), a warp 32 x 64,
//     forming da = do Wo[:, head] in the same chunks on two of its warps;
//   * the softmax core is K1's tc core (mma.sync on q, k, v, da in bf16
//     tiles, the scores and the softmax in C fragments, the keep bits of a
//     fragment in one Philox call per four keys); in the backward its
//     second pass puts dq, dk, dv and the merged head on all eight warps;
//   * the forward runs two blocks an SM (94 KB of shared memory, 128
//     registers), so that one block's barriers, loads and core overlap the
//     other's products: h and the block's merged heads go through scratch
//     rows that the block alone writes and reads back, and stay in L2; o =
//     a Wo^T is one pipelined product at the end, in passes of 192 columns,
//     its epilogue (+ bo, site-1 dropout, + x) applied to the fragments;
//   * the backward keeps h (bf16) resident, then dh (f32, 64 x D) for the
//     LayerNorm backward, one block an SM; dh = dqkv [Wq; Wk; Wv] runs in
//     passes of 256 columns;
//   * the dWo product (and the MLP's dW1, dW2) runs grad_weight_tc_kernel:
//     128 x 128 tiles of A^T B, 32 tokens a chunk through a 4-stage ring,
//     split over tokens with partials summed in a fixed order.
// What bounds them now is the chunk: each costs a barrier and a wait on
// its loads, which one block an SM cannot hide (two frames a block, with
// half the weight bytes a frame, ran slower than two blocks an SM), and
// the core, whose 16 heads a frame run one after another on four warps.
//
// The MLP sub-block's "tc" variant (bf16, D and F multiples of 64, D up to
// 512: mlp_fwd_tc_kernel, mlp_bwd_tc_kernel) works the same way on 64 rows
// of the flattened stream a tile, two blocks an SM, each walking tiles:
//   * h = LN(x) stays in shared memory as bf16 in the 128-byte swizzle
//     (swz), which wgmma reads and ldmatrix reads without bank conflicts;
//     the other operands stream 64 deep through cp.async rings;
//   * the forward runs z = h W1^T and o = a W2^T on wgmma in passes of 128
//     columns, the hidden layer a going through scratch rows that stay in
//     L2; the backward runs z and dad = do W2 on mma.sync on the same
//     chunks, then dh = dz W1, do, dz and dh (f32) going through such rows;
//   * the epilogues (GELU and its derivative, sites 2 and 3 by
//     keep_bits_at, the biases, + x) work on the accumulator fragments.
// With one block an SM (h and a, or h and do, resident) a tile's phases
// (LayerNorm, products, epilogues) ran one after another and left the SM
// idle in each other's waits; two blocks an SM overlap them at the price
// of the scratch rows' traffic through L2. The MLP's weights (1 MB in bf16)
// are read from L2 once per 64 rows by the forward and 1.5 times by the
// backward.

// What the design does where the TPU design does not carry over:
//   * Weights in persistent VMEM -> the weights stay in device memory (the
//     L2 holds all of them) and every block streams tiles of them (32 deep;
//     64 in the tc variant) through shared memory.
//   * A block owns 64 token rows: one frame (T <= 64, rows past T are
//     padding) in the attention kernels, because the softmax core needs the
//     frame whole; any 64 rows of the flattened (B*T, D) stream in the MLP
//     kernels. At B = 1 and 8 (CAD encode, a served tick) the attention
//     kernels therefore fill 1 or 8 of the 132 SMs and the MLP kernels 1 or
//     7: those launches are latency-bound, not throughput-bound.
//   * The 1,024-wide q, k, v never reach device memory: the forward loops
//     over heads, forms one head's q, k, v (T x 64 each) in shared memory,
//     runs the softmax core there (one warp per query row, as
//     mhsa_short.cu does), and adds a_h Wo[head rows] into a (64, D) f32
//     sum in shared memory (the tc variant: the merged heads to scratch
//     rows, and o = a Wo^T once at the end). That sum and h = LN(x) (64 x
//     D) do not both fit the 227 KB of a block beside the head's operands,
//     so h goes through a scratch buffer in device memory that the wrapper
//     allocates for the call (the backward emits h anyway); the block reads
//     back only what it wrote itself, after a __syncthreads().
//   * A sequential grid that carries the parameter gradients -> two passes
//     and no atomics. The backward kernels emit, in the I/O dtype, the two
//     operands of every weight-gradient product (h, dz, the hidden layer
//     and the masked output gradient for the MLP; the merged heads and the
//     masked output gradient for the attention, beside h and dqkv, which
//     the wrapper multiplies outside as the JAX wrapper does), and
//     grad_weight_kernel computes A^T B over all B*T tokens: a block owns a
//     64 x 64 output tile and a range of tokens, partials are summed in a
//     fixed order. The bias and LayerNorm gradients are column sums: each
//     block writes one partial row, sum_rows_kernel adds the rows in a
//     fixed order. Gradients therefore repeat bit for bit. The buffers live
//     only inside one backward call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "tc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 64;          // token rows a block owns
constexpr int kBN = 64;          // output columns of one product tile
constexpr int kBK = 32;          // depth of one staged tile
constexpr int kLd = kBM + 4;     // staged f32 rows: 68 keep float4 aligned
constexpr int kLdH = kBM + 8;    // staged bf16 rows: 72 keep 32-byte fragments
constexpr int kMaxD = 512;       // widest row a warp holds in registers
constexpr int kPerLane = kMaxD / 32;
constexpr int kMaxHeadDim = 64;
constexpr int kHeadLd = kMaxHeadDim + 1;   // lane j reads row j: no conflicts
constexpr int kStageFloats = 2 * kBK * kLd;   // As and Bs
constexpr int kMaxSplits = 8;
static_assert(kBM == kBN && kBM * kBK % kThreads == 0 && kThreads == 256,
              "gemm_tile stages both tiles with one index scheme and gives "
              "each of 16 x 16 threads a 4 x 4 piece");
static_assert(kBK * kLdH * 2 <= kBK * kLd * 4 &&
                  kBM * (kBK + 8) * 2 <= kBK * kLd * 4 &&
                  kBM * kLd == kStageFloats,
              "the bf16 tiles and the f32 output tile fit the staging area");

typedef long long i64;

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
  return __float2bfloat16(x);   // round to nearest even
}
// x rounded to the I/O dtype, held in f32.
template <typename T>
__device__ __forceinline__ float round_io(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Drop {
  uint32_t seed;
  uint32_t threshold;   // bits below it are dropped; 0 turns dropout off
  float inv_keep;       // 1 / (1 - rate)
};

// The four words of Philox4x32-10, key (seed, 3 + site), counter
// (group, row, head, frame).
__device__ __forceinline__ void philox4(uint32_t seed, uint32_t site,
                                        uint32_t group, uint32_t row,
                                        uint32_t head, uint32_t frame,
                                        uint32_t (&out)[4]) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
  uint32_t c0 = group, c1 = row, c2 = head, c3 = frame;
  uint32_t k0 = seed, k1 = 3u + site;
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
  out[0] = c0; out[1] = c1; out[2] = c2; out[3] = c3;
}

__device__ __forceinline__ uint32_t philox1(uint32_t seed, uint32_t site,
                                            uint32_t col, uint32_t row,
                                            uint32_t head, uint32_t frame) {
  uint32_t w[4];
  philox4(seed, site, col >> 2, row, head, frame, w);
  const uint32_t word = col & 3u;
  return word == 0u ? w[0] : word == 1u ? w[1] : word == 2u ? w[2] : w[3];
}

// keep[j] for the four columns group * 4 + j of an elementwise site.
__device__ __forceinline__ void keep4(const Drop& drop, uint32_t site,
                                      uint32_t group, uint32_t row,
                                      uint32_t frame, bool (&keep)[4]) {
  if (drop.threshold == 0u) {
    keep[0] = keep[1] = keep[2] = keep[3] = true;
    return;
  }
  uint32_t w[4];
  philox4(drop.seed, site, group, row, 0u, frame, w);
#pragma unroll
  for (int j = 0; j < 4; ++j) keep[j] = w[j] >= drop.threshold;
}

// ---------------------------------------------------------------------------
// The block-level product: acc[i][j] += sum_k A(m, k) B(k, n) for the
// thread's rows m = ty * 4 + i and columns n = tx * 4 + j of a 64 x 64 tile
// (tx = tid % 16, ty = tid / 16). A(m, k) = A[m * sam + k * sak] and
// B(k, n) = B[k * sbk + n * sbn] may lie in device or in shared memory;
// entries with m >= m_valid, n >= n_valid or k >= K count as 0. Both
// operands are staged through ``stage`` (kStageFloats floats of shared
// memory), 32 deep. Every thread of the block must call it, after a
// __syncthreads() behind whatever wrote A; it ends with a __syncthreads().
//
// bf16 operands whose layout allows 16-byte loads go to the tensor cores
// (gemm_tile_tc); everything else (float32, odd widths, unaligned views)
// runs as f32 FMAs on a 4 x 4 register tile a thread.
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

// Eight consecutive values as bf16 in one 16-byte register group. A float
// source holds bf16 values already (rounded where the Pallas body rounds),
// so the conversion is exact.
__device__ __forceinline__ uint4 load8(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint4 load8(const float* p) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  uint4 out;
  __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(&out);
  pairs[0] = __floats2bfloat162_rn(lo.x, lo.y);
  pairs[1] = __floats2bfloat162_rn(lo.z, lo.w);
  pairs[2] = __floats2bfloat162_rn(hi.x, hi.y);
  pairs[3] = __floats2bfloat162_rn(hi.z, hi.w);
  return out;
}

constexpr int kLdK = kBK + 8;   // bf16 rows of a tile kept k-contiguous: 40

// The tensor-core product. AK: A is contiguous along k, A(m, k) =
// A[m * lda + k], and is staged as [m][k] (wmma row-major A); otherwise it
// is contiguous along m, A(m, k) = A[k * lda + m], staged as [k][m]
// (col-major A). BK likewise for B(k, n) = B[n * ldb + k] (col-major B) or
// B[k * ldb + n] (row-major B). Each thread moves one 16-byte group of
// eight values of each operand a tile: row tid / 4 and depth 8 (tid % 4)
// along k, or depth tid / 8 and columns 8 (tid % 8) otherwise; the groups
// travel through registers one tile ahead of the products. Warp w owns
// rows (w / 2) * 16 and columns (w % 2) * 32 of the output as two
// 16 x 16 x 16 fragments (mma.sync through nvcuda::wmma, f32
// accumulation); at the end the tile goes through the staging area, as
// 64 x kLd floats, to the threads' 4 x 4 pieces.
template <typename TA, bool AK, bool BK>
__device__ __noinline__ void gemm_tile_tc(const TA* A, i64 lda, int m_valid,
                                          const bf16* B, i64 ldb, int n_valid,
                                          int K, float* acc, float* stage) {
  namespace wmma = nvcuda::wmma;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4, warp = tid >> 5;
  bf16* Ah = reinterpret_cast<bf16*>(stage);
  bf16* Bh = reinterpret_cast<bf16*>(stage + kBK * kLd);
  // This thread's group: (row or column, depth) of its first value.
  const int a_mn = AK ? tid >> 2 : (tid & 7) * 8;
  const int a_kk = AK ? (tid & 3) * 8 : tid >> 3;
  const int b_mn = BK ? tid >> 2 : (tid & 7) * 8;
  const int b_kk = BK ? (tid & 3) * 8 : tid >> 3;
  const TA* pa = AK ? A + a_mn * lda + a_kk : A + a_kk * lda + a_mn;
  const bf16* pb = BK ? B + b_mn * ldb + b_kk : B + b_kk * ldb + b_mn;
  const i64 a_tile = AK ? (i64)kBK : kBK * lda;
  const i64 b_tile = BK ? (i64)kBK : kBK * ldb;
  const int a_dst = AK ? a_mn * kLdK + a_kk : a_kk * kLdH + a_mn;
  const int b_dst = BK ? b_mn * kLdK + b_kk : b_kk * kLdH + b_mn;
  const bool a_row_ok = a_mn < m_valid, b_row_ok = b_mn < n_valid;
  uint4 va, vb;
  bool a_ok, b_ok;
  // A group out of range loads the operand's first group instead, so that
  // no load sits behind a branch, and is staged as zeros.
  auto fetch = [&](int k0) {
    a_ok = a_row_ok && k0 + a_kk < K;
    b_ok = b_row_ok && k0 + b_kk < K;
    vb = load8(b_ok ? pb : B);
    va = load8(a_ok ? pa : A);
    pa += a_tile;
    pb += b_tile;
  };
  const int m0 = (warp >> 1) * 16, n0 = (warp & 1) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c0, c1;
  wmma::fill_fragment(c0, 0.f);
  wmma::fill_fragment(c1, 0.f);
  using ALayout =
      typename std::conditional<AK, wmma::row_major, wmma::col_major>::type;
  using BLayout =
      typename std::conditional<BK, wmma::col_major, wmma::row_major>::type;
  constexpr int a_ld = AK ? kLdK : kLdH, b_ld = BK ? kLdK : kLdH;
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(Ah + a_dst) = a_ok ? va : zero;
    *reinterpret_cast<uint4*>(Bh + b_dst) = b_ok ? vb : zero;
    __syncthreads();
    if (k0 + kBK < K) fetch(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b0, b1;
      const bf16* at_a = AK ? Ah + m0 * kLdK + kk : Ah + kk * kLdH + m0;
      const bf16* at_b = BK ? Bh + n0 * kLdK + kk : Bh + kk * kLdH + n0;
      wmma::load_matrix_sync(a, at_a, a_ld);
      wmma::load_matrix_sync(b0, at_b, b_ld);
      wmma::load_matrix_sync(b1, at_b + (BK ? 16 * kLdK : 16), b_ld);
      wmma::mma_sync(c0, a, b0, c0);
      wmma::mma_sync(c1, a, b1, c1);
    }
    __syncthreads();
  }
  float* Cs = stage;   // 64 x kLd floats: exactly the staging area
  wmma::store_matrix_sync(Cs + m0 * kLd + n0, c0, kLd, wmma::mem_row_major);
  wmma::store_matrix_sync(Cs + m0 * kLd + n0 + 16, c1, kLd,
                          wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 c =
        *reinterpret_cast<const float4*>(&Cs[(ty * 4 + i) * kLd + tx * 4]);
    acc[i * 4 + 0] += c.x;
    acc[i * 4 + 1] += c.y;
    acc[i * 4 + 2] += c.z;
    acc[i * 4 + 3] += c.w;
  }
  __syncthreads();
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u;
}

template <typename TA, typename TB>
__device__ __forceinline__ void gemm_tile(const TA* A, i64 sam, i64 sak,
                                          int m_valid, const TB* B, i64 sbk,
                                          i64 sbn, int n_valid, int K,
                                          float (&acc)[4][4], float* As,
                                          float* Bs) {
  const bool a_k = sak == 1, b_k = sbk == 1;
  if constexpr (std::is_same<TB, bf16>::value) {
    // 16-byte groups need: a unit stride along k or along the rows, the
    // other stride and the pointer on 16-byte boundaries, and whole groups
    // (K a multiple of 8 where k is grouped, the row count where rows are).
    const i64 lda = a_k ? sam : sak, ldb = b_k ? sbn : sbk;
    const bool grouped =
        (a_k || sam == 1) && (b_k || sbn == 1) &&
        (K % 8 == 0 || !(a_k || b_k)) && lda * (i64)sizeof(TA) % 16 == 0 &&
        ldb % 8 == 0 && aligned16(A) && aligned16(B) &&
        (a_k || m_valid % 8 == 0) && (b_k || n_valid % 8 == 0);
    if (grouped) {
      if (a_k && b_k)
        gemm_tile_tc<TA, true, true>(A, lda, m_valid, B, ldb, n_valid, K,
                                     &acc[0][0], As);
      else if (a_k)
        gemm_tile_tc<TA, true, false>(A, lda, m_valid, B, ldb, n_valid, K,
                                      &acc[0][0], As);
      else if (b_k)
        gemm_tile_tc<TA, false, true>(A, lda, m_valid, B, ldb, n_valid, K,
                                      &acc[0][0], As);
      else
        gemm_tile_tc<TA, false, false>(A, lda, m_valid, B, ldb, n_valid, K,
                                       &acc[0][0], As);
      return;
    }
  }
  constexpr int kPerThread = kBM * kBK / kThreads;   // 8 entries of each tile
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  // Entry s of this thread in a staged tile. Read along k (stride 1 there):
  // depth tid % 32, row tid / 32 + 8 s. Read along the rows: row tid % 64,
  // depth tid / 64 + 4 s. Either way the address, the place in shared
  // memory and the bounds advance by a constant from one entry to the next,
  // and the address by kBK * stride from one tile to the next.
  const int a_mn = a_k ? tid >> 5 : tid & 63, a_kk = a_k ? tid & 31 : tid >> 6;
  const int b_mn = b_k ? tid >> 5 : tid & 63, b_kk = b_k ? tid & 31 : tid >> 6;
  const TA* pa = A + a_mn * sam + a_kk * sak;
  const TB* pb = B + b_kk * sbk + b_mn * sbn;
  const i64 a_step = a_k ? 8 * sam : 4 * sak, b_step = b_k ? 8 * sbn : 4 * sbk;
  const int a_mn_step = a_k ? 8 : 0, a_kk_step = a_k ? 0 : 4;
  const int b_mn_step = b_k ? 8 : 0, b_kk_step = b_k ? 0 : 4;
  // The next tiles travel through registers, as loaded: all 16 loads of a
  // thread are in flight together (an entry out of range loads the tile's
  // first element instead, so that no load sits behind a branch, and counts
  // as 0 when it is staged; nothing uses a loaded value before that), and
  // they are issued before the products of the tile at hand, which hide
  // their latency.
  TA va[kPerThread];
  TB vb[kPerThread];
  unsigned a_ok = 0u, b_ok = 0u;
  auto fetch = [&](int k0) {
    a_ok = b_ok = 0u;
#pragma unroll
    for (int s = 0; s < kPerThread; ++s) {
      const bool in_a = a_mn + s * a_mn_step < m_valid &&
                        k0 + a_kk + s * a_kk_step < K;
      const bool in_b = b_mn + s * b_mn_step < n_valid &&
                        k0 + b_kk + s * b_kk_step < K;
      va[s] = *(in_a ? pa + s * a_step : A);
      vb[s] = *(in_b ? pb + s * b_step : B);
      a_ok |= (unsigned)in_a << s;
      b_ok |= (unsigned)in_b << s;
    }
    pa += kBK * sak;
    pb += kBK * sbk;
  };
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int s = 0; s < kPerThread; ++s) {
      As[(a_kk + s * a_kk_step) * kLd + a_mn + s * a_mn_step] =
          (a_ok >> s & 1u) ? to_f32(va[s]) : 0.f;
      Bs[(b_kk + s * b_kk_step) * kLd + b_mn + s * b_mn_step] =
          (b_ok >> s & 1u) ? to_f32(vb[s]) : 0.f;
    }
    __syncthreads();
    if (k0 + kBK < K) fetch(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a =
          *reinterpret_cast<const float4*>(&As[kk * kLd + ty * 4]);
      const float4 b =
          *reinterpret_cast<const float4*>(&Bs[kk * kLd + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// ---------------------------------------------------------------------------
// Row passes: one warp owns one row of D <= 512 values, 16 to a lane; lane
// value e is column ((e / 4) * 32 + lane) * 4 + e % 4, so a lane owns whole
// groups of four columns (one Philox call each).
// ---------------------------------------------------------------------------
__device__ __forceinline__ int col_of(int e, int lane) {
  return ((e >> 2) * 32 + lane) * 4 + (e & 3);
}

template <typename T>
__device__ __forceinline__ void load_row(const T* row, int d, int lane,
                                         float (&v)[kPerLane]) {
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const int col = col_of(e, lane);
    v[e] = col < d ? to_f32(row[col]) : 0.f;
  }
}

__device__ __forceinline__ void load_param(const float* p, int d, int lane,
                                           float (&v)[kPerLane]) {
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const int col = col_of(e, lane);
    v[e] = col < d ? p[col] : 0.f;
  }
}

// x -> xhat in place (0 past d); returns rstd. The centred second moment,
// as the Pallas body's _layer_norm_f32.
__device__ __forceinline__ float normalize_row(float (&v)[kPerLane], int d,
                                               int lane, float eps) {
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) sum += v[e];
  const float mean = warp_sum(sum) / (float)d;
  float sq = 0.f;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const float centered = col_of(e, lane) < d ? v[e] - mean : 0.f;
    v[e] = centered;
    sq = fmaf(centered, centered, sq);
  }
  const float rstd = rsqrtf(warp_sum(sq) / (float)d + eps);
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) v[e] *= rstd;
  return rstd;
}

// h = LN(x) of one row, rounded to the I/O dtype, written to ``h_row``;
// leaves xhat in v and returns rstd.
template <typename T>
__device__ __forceinline__ float ln_row(const T* x_row, T* h_row,
                                        const float (&sc)[kPerLane],
                                        const float (&bi)[kPerLane], int d,
                                        int lane, float eps,
                                        float (&v)[kPerLane]) {
  load_row<T>(x_row, d, lane, v);
  const float rstd = normalize_row(v, d, lane, eps);
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const int col = col_of(e, lane);
    if (col < d)
      h_row[col] = from_f32<T>(__fadd_rn(__fmul_rn(v[e], sc[e]), bi[e]));
  }
  return rstd;
}

// do = keep ? gy / (1 - rate) : 0 for one row (elementwise site ``site``);
// writes do rounded to the I/O dtype to ``dob_row`` and adds do to ``sum``.
template <typename T>
__device__ __forceinline__ void masked_grad_row(const T* gy_row, T* dob_row,
                                                const Drop& drop,
                                                uint32_t site, uint32_t row,
                                                uint32_t frame, int d,
                                                int lane,
                                                float (&sum)[kPerLane]) {
  float gy[kPerLane];
  load_row<T>(gy_row, d, lane, gy);
#pragma unroll
  for (int c = 0; c < kPerLane / 4; ++c) {
    const int group = c * 32 + lane;
    if (group * 4 >= d) continue;
    bool keep[4];
    keep4(drop, site, (uint32_t)group, row, frame, keep);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = c * 4 + j;
      const int col = group * 4 + j;
      if (col < d) {
        const float g = drop.threshold == 0u
                            ? gy[e] : (keep[j] ? gy[e] * drop.inv_keep : 0.f);
        sum[e] += g;
        dob_row[col] = from_f32<T>(g);
      }
    }
  }
}

// The LayerNorm backward of one row: dx = gy + rstd * (dxhat - mean(dxhat) -
// xhat * mean(dxhat * xhat)), dxhat = dh * g; adds dh * xhat and dh to the
// lane's dg and dbe sums. The row's x (normalized in place), gy and dh are
// given as the lane's values (col_of's layout, 0 past d), and dx is left
// in dh; ln_bwd_row loads them from rows and stores dx.
__device__ __forceinline__ void ln_bwd_values(float (&xhat)[kPerLane],
                                              const float (&gy)[kPerLane],
                                              float (&dh)[kPerLane],
                                              const float (&sc)[kPerLane],
                                              int d, int lane, float eps,
                                              float (&dg)[kPerLane],
                                              float (&dbe)[kPerLane]) {
  const float rstd = normalize_row(xhat, d, lane, eps);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    dg[e] = fmaf(dh[e], xhat[e], dg[e]);
    dbe[e] += dh[e];
    dh[e] *= sc[e];
    s1 += dh[e];
    s2 = fmaf(dh[e], xhat[e], s2);
  }
  const float m1 = warp_sum(s1) / (float)d;
  const float m2 = warp_sum(s2) / (float)d;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e)
    dh[e] = gy[e] + rstd * (dh[e] - m1 - xhat[e] * m2);
}

template <typename T>
__device__ __forceinline__ void ln_bwd_row(const T* x_row, const T* gy_row,
                                           const float* dh_row, T* dx_row,
                                           const float (&sc)[kPerLane], int d,
                                           int lane, float eps,
                                           float (&dg)[kPerLane],
                                           float (&dbe)[kPerLane]) {
  float xhat[kPerLane], gy[kPerLane], dh[kPerLane];
  load_row<T>(x_row, d, lane, xhat);
  load_row<T>(gy_row, d, lane, gy);
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const int col = col_of(e, lane);
    dh[e] = col < d ? dh_row[col] : 0.f;
  }
  ln_bwd_values(xhat, gy, dh, sc, d, lane, eps, dg, dbe);
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const int col = col_of(e, lane);
    if (col < d) dx_row[col] = from_f32<T>(dh[e]);
  }
}

// The warps' per-lane column sums -> one row of d values in ``out``, summed
// over the warps in a fixed order through ``buf`` (kWarps * d floats of
// shared memory). Ends with a __syncthreads().
__device__ __forceinline__ void block_col_sums(const float (&sum)[kPerLane],
                                               int d, float* buf, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const int col = col_of(e, lane);
    if (col < d) buf[warp * d + col] = sum[e];
  }
  __syncthreads();
  for (int col = threadIdx.x; col < d; col += kThreads) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += buf[w * d + col];
    out[col] = total;
  }
  __syncthreads();
}

__device__ __forceinline__ float gelu(float z) {
  return 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
}
__device__ __forceinline__ float dgelu(float z) {
  const float cdf = 0.5f * (1.f + erff(z * 0.70710678118654752f));
  const float pdf = expf(-0.5f * z * z) * 0.3989422804014327f;
  return cdf + z * pdf;
}

// A weight as a (in, out) view: element (i, o) at p[i * s_in + o * s_out].
template <typename T>
struct Weight {
  const T* p;
  i64 s_in, s_out;
};

// ---------------------------------------------------------------------------
// MLP sub-block
// ---------------------------------------------------------------------------

// Shared memory of the MLP kernels, in floats: As, Bs, the hidden chunk
// (kBM x kLd), the chunk's column sums (16 x kBN; backward only) and the
// (kBM, d) f32 sum.
__host__ __device__ constexpr int mlp_shared_floats(int d) {
  return kStageFloats + kBM * kLd + 16 * kBN + kBM * d;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mlp_fwd_kernel(const T* __restrict__ x, Weight<T> w1,
               const float* __restrict__ b1, Weight<T> w2,
               const float* __restrict__ b2, const float* __restrict__ g,
               const float* __restrict__ be, T* hbuf, T* __restrict__ y,
               i64 rows, int seq, int d, int f, float eps, Drop drop) {
  extern __shared__ __align__(128) float smem[];
  float* As = smem;
  float* Bs = As + kBK * kLd;
  float* cs = Bs + kBK * kLd;            // the hidden chunk, rounded
  float* os = cs + kBM * kLd + 16 * kBN; // (kBM, d) sum of the output product

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const i64 r0 = (i64)blockIdx.x * kBM;
  const int m_valid = (int)((rows - r0) < kBM ? (rows - r0) : kBM);

  {
    float sc[kPerLane], bi[kPerLane], v[kPerLane];
    load_param(g, d, lane, sc);
    load_param(be, d, lane, bi);
    for (int i = warp; i < m_valid; i += kWarps)
      ln_row<T>(x + (r0 + i) * d, hbuf + (r0 + i) * d, sc, bi, d, lane, eps,
                v);
  }
  for (int idx = tid; idx < kBM * d; idx += kThreads) os[idx] = 0.f;
  __syncthreads();

  const T* h0 = hbuf + r0 * d;
  for (int c0 = 0; c0 < f; c0 += kBN) {
    const int f_valid = (f - c0) < kBN ? (f - c0) : kBN;
    float acc[4][4];
    zero_acc(acc);
    gemm_tile<T, T>(h0, d, 1, m_valid, w1.p + c0 * w1.s_out, w1.s_in,
                    w1.s_out, f_valid, d, acc, As, Bs);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty * 4 + i;
      const i64 r = r0 + m;
      bool keep[4];
      keep4(drop, 2u, (uint32_t)((c0 + tx * 4) >> 2), (uint32_t)(r % seq),
            (uint32_t)(r / seq), keep);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx * 4 + j;
        float a = 0.f;
        if (m < m_valid && col < f) {
          a = gelu(acc[i][j] + b1[col]);
          if (drop.threshold != 0u) a = keep[j] ? a * drop.inv_keep : 0.f;
        }
        cs[m * kLd + tx * 4 + j] = round_io<T>(a);
      }
    }
    __syncthreads();
    for (int n0 = 0; n0 < d; n0 += kBN) {
      const int n_valid = (d - n0) < kBN ? (d - n0) : kBN;
      float out[4][4];
      zero_acc(out);
      gemm_tile<float, T>(cs, kLd, 1, kBM, w2.p + c0 * w2.s_in + n0 * w2.s_out,
                          w2.s_in, w2.s_out, n_valid, f_valid, out, As, Bs);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + tx * 4 + j;
          if (col < d) os[(ty * 4 + i) * d + col] += out[i][j];
        }
    }
  }

  // y = x + drop3(o + b2); a thread finishes the entries it summed itself.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty * 4 + i;
    if (m >= m_valid) continue;
    const i64 r = r0 + m;
    for (int n0 = 0; n0 < d; n0 += kBN) {
      bool keep[4];
      keep4(drop, 3u, (uint32_t)((n0 + tx * 4) >> 2), (uint32_t)(r % seq),
            (uint32_t)(r / seq), keep);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx * 4 + j;
        if (col >= d) continue;
        float o = os[m * d + col] + b2[col];
        if (drop.threshold != 0u) o = keep[j] ? o * drop.inv_keep : 0.f;
        y[r * d + col] = from_f32<T>(to_f32(x[r * d + col]) + o);
      }
    }
  }
}

// parts: (gridDim.x, 3 d + f) f32; a block writes one row [db2 | dg | dbe |
// db1]. hbuf, dobbuf (rows, d), abbuf, dzbuf (rows, f): the operands of the
// weight-gradient products, in the I/O dtype.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlp_bwd_kernel(const T* __restrict__ x, Weight<T> w1,
               const float* __restrict__ b1, Weight<T> w2,
               const float* __restrict__ g, const float* __restrict__ be,
               const T* __restrict__ gy, T* hbuf, T* dobbuf, T* abbuf,
               T* dzbuf, T* __restrict__ dx, float* __restrict__ parts,
               i64 rows, int seq, int d, int f, float eps, Drop drop) {
  extern __shared__ __align__(128) float smem[];
  float* As = smem;
  float* Bs = As + kBK * kLd;
  float* dzs = Bs + kBK * kLd;          // the chunk's dz, rounded
  float* colsum = dzs + kBM * kLd;      // (16, kBN)
  float* dhs = colsum + 16 * kBN;       // (kBM, d) f32: dh
  float* rowbuf = As;                   // (kWarps, d): idle outside products

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const i64 r0 = (i64)blockIdx.x * kBM;
  const int m_valid = (int)((rows - r0) < kBM ? (rows - r0) : kBM);
  float* my_parts = parts + (i64)blockIdx.x * (3 * d + f);

  float sc[kPerLane];
  load_param(g, d, lane, sc);
  {
    float bi[kPerLane], v[kPerLane], sum[kPerLane];
    load_param(be, d, lane, bi);
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) sum[e] = 0.f;
    for (int i = warp; i < m_valid; i += kWarps) {
      const i64 r = r0 + i;
      ln_row<T>(x + r * d, hbuf + r * d, sc, bi, d, lane, eps, v);
      masked_grad_row<T>(gy + r * d, dobbuf + r * d, drop, 3u,
                         (uint32_t)(r % seq), (uint32_t)(r / seq), d, lane,
                         sum);
    }
    block_col_sums(sum, d, rowbuf, my_parts);            // db2
  }
  for (int idx = tid; idx < kBM * d; idx += kThreads) dhs[idx] = 0.f;
  __syncthreads();

  const T* h0 = hbuf + r0 * d;
  const T* dob0 = dobbuf + r0 * d;
  for (int c0 = 0; c0 < f; c0 += kBN) {
    const int f_valid = (f - c0) < kBN ? (f - c0) : kBN;
    float z[4][4], dad[4][4];
    zero_acc(z);
    zero_acc(dad);
    gemm_tile<T, T>(h0, d, 1, m_valid, w1.p + c0 * w1.s_out, w1.s_in,
                    w1.s_out, f_valid, d, z, As, Bs);
    // dad[n, f] = sum_d dob[n, d] W2[f, d]
    gemm_tile<T, T>(dob0, d, 1, m_valid, w2.p + c0 * w2.s_in, w2.s_out,
                    w2.s_in, f_valid, d, dad, As, Bs);
    float sums[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty * 4 + i;
      const i64 r = r0 + m;
      bool keep[4];
      keep4(drop, 2u, (uint32_t)((c0 + tx * 4) >> 2), (uint32_t)(r % seq),
            (uint32_t)(r / seq), keep);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx * 4 + j;
        float dz = 0.f;
        if (m < m_valid && col < f) {
          const float zz = z[i][j] + b1[col];
          float a = gelu(zz);
          float da = dad[i][j];
          if (drop.threshold != 0u) {
            a = keep[j] ? a * drop.inv_keep : 0.f;
            da = keep[j] ? da * drop.inv_keep : 0.f;
          }
          dz = da * dgelu(zz);
          abbuf[r * f + col] = from_f32<T>(a);
          dzbuf[r * f + col] = from_f32<T>(dz);
        }
        sums[j] += dz;
        dzs[m * kLd + tx * 4 + j] = round_io<T>(dz);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) colsum[ty * kBN + tx * 4 + j] = sums[j];
    __syncthreads();
    if (tid < f_valid) {
      float total = 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) total += colsum[r * kBN + tid];
      my_parts[3 * d + c0 + tid] = total;                // db1
    }
    // dh[n, d] += sum_f dz[n, f] W1[d, f]
    for (int n0 = 0; n0 < d; n0 += kBN) {
      const int n_valid = (d - n0) < kBN ? (d - n0) : kBN;
      float out[4][4];
      zero_acc(out);
      gemm_tile<float, T>(dzs, kLd, 1, kBM,
                          w1.p + n0 * w1.s_in + c0 * w1.s_out, w1.s_out,
                          w1.s_in, n_valid, f_valid, out, As, Bs);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + tx * 4 + j;
          if (col < d) dhs[(ty * 4 + i) * d + col] += out[i][j];
        }
    }
  }
  __syncthreads();

  float dg[kPerLane], dbe[kPerLane];
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) dg[e] = dbe[e] = 0.f;
  for (int i = warp; i < m_valid; i += kWarps) {
    const i64 r = r0 + i;
    ln_bwd_row<T>(x + r * d, gy + r * d, dhs + i * d, dx + r * d, sc, d, lane,
                  eps, dg, dbe);
  }
  block_col_sums(dg, d, rowbuf, my_parts + d);
  block_col_sums(dbe, d, rowbuf, my_parts + 2 * d);
}

// ---------------------------------------------------------------------------
// Attention sub-block
// ---------------------------------------------------------------------------

// The scaled scores of one query row against keys j0 = lane and j1 = lane +
// 32, then the row softmax. Padded key columns get weight 0.
__device__ __forceinline__ void softmax_row(const float* q_row,
                                            const float* ks, int seq,
                                            int head_dim, float scale, int j0,
                                            int j1, float* w0, float* w1) {
  float s0 = -INFINITY, s1 = -INFINITY;
  if (j0 < seq) {
    float acc = 0.f;
    for (int c = 0; c < head_dim; ++c)
      acc = fmaf(q_row[c], ks[j0 * kHeadLd + c], acc);
    s0 = acc * scale;
  }
  if (j1 < seq) {
    float acc = 0.f;
    for (int c = 0; c < head_dim; ++c)
      acc = fmaf(q_row[c], ks[j1 * kHeadLd + c], acc);
    s1 = acc * scale;
  }
  const float m = warp_max(fmaxf(s0, s1));
  const float e0 = j0 < seq ? expf(s0 - m) : 0.f;
  const float e1 = j1 < seq ? expf(s1 - m) : 0.f;
  const float sum = warp_sum(e0 + e1);
  *w0 = e0 / sum;
  *w1 = e1 / sum;
}

// One head's projection of h: dst (kBM x kHeadLd, f32) = round(h W[:, head]).
template <typename T>
__device__ __forceinline__ void project_head(const T* h0, int seq, int d,
                                             Weight<T> w, int head,
                                             int head_dim, float* dst,
                                             float* As, float* Bs) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
  zero_acc(acc);
  gemm_tile<T, T>(h0, d, 1, seq, w.p + (i64)head * head_dim * w.s_out, w.s_in,
                  w.s_out, head_dim, d, acc, As, Bs);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dst[(ty * 4 + i) * kHeadLd + tx * 4 + j] = round_io<T>(acc[i][j]);
}

// Forward shared memory in floats: As, Bs, q, k, v (kBM x kHeadLd each), the
// head's output (kBM x kLd), one row of weights per warp, the (kBM, d) sum.
__host__ __device__ constexpr int attn_fwd_shared_floats(int d) {
  return kStageFloats + 3 * kBM * kHeadLd + kBM * kLd + kWarps * kBM +
         kBM * d;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ x, Weight<T> wq, Weight<T> wk,
                Weight<T> wv, Weight<T> wo, const float* __restrict__ bo,
                const float* __restrict__ g, const float* __restrict__ be,
                T* hbuf, T* __restrict__ y, int seq, int d, int heads,
                int head_dim, float scale, float eps, Drop drop) {
  extern __shared__ __align__(128) float smem[];
  float* As = smem;
  float* Bs = As + kBK * kLd;
  float* qs = Bs + kBK * kLd;
  float* ks = qs + kBM * kHeadLd;
  float* vs = ks + kBM * kHeadLd;
  float* ahs = vs + kBM * kHeadLd;       // the head's output, rounded
  float* ps = ahs + kBM * kLd;           // (kWarps, kBM)
  float* os = ps + kWarps * kBM;         // (kBM, d)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int frame = blockIdx.x;
  const i64 r0 = (i64)frame * seq;

  {
    float sc[kPerLane], bi[kPerLane], v[kPerLane];
    load_param(g, d, lane, sc);
    load_param(be, d, lane, bi);
    for (int i = warp; i < seq; i += kWarps)
      ln_row<T>(x + (r0 + i) * d, hbuf + (r0 + i) * d, sc, bi, d, lane, eps,
                v);
  }
  for (int idx = tid; idx < kBM * d; idx += kThreads) os[idx] = 0.f;
  __syncthreads();

  const T* h0 = hbuf + r0 * d;
  const int j0 = lane, j1 = lane + 32;
  for (int head = 0; head < heads; ++head) {
    project_head<T>(h0, seq, d, wq, head, head_dim, qs, As, Bs);
    project_head<T>(h0, seq, d, wk, head, head_dim, ks, As, Bs);
    project_head<T>(h0, seq, d, wv, head, head_dim, vs, As, Bs);
    __syncthreads();
    for (int i = warp; i < seq; i += kWarps) {
      float w0, w1;
      softmax_row(qs + i * kHeadLd, ks, seq, head_dim, scale, j0, j1, &w0,
                  &w1);
      if (drop.threshold != 0u) {
        w0 = philox1(drop.seed, 0u, j0, i, head, frame) >= drop.threshold
                 ? w0 * drop.inv_keep : 0.f;
        w1 = philox1(drop.seed, 0u, j1, i, head, frame) >= drop.threshold
                 ? w1 * drop.inv_keep : 0.f;
      }
      if (j0 < seq) ps[warp * kBM + j0] = round_io<T>(w0);
      if (j1 < seq) ps[warp * kBM + j1] = round_io<T>(w1);
      __syncwarp();
      for (int c = lane; c < head_dim; c += 32) {
        float acc = 0.f;
        for (int j = 0; j < seq; ++j)
          acc = fmaf(ps[warp * kBM + j], vs[j * kHeadLd + c], acc);
        ahs[i * kLd + c] = round_io<T>(acc);
      }
      __syncwarp();
    }
    __syncthreads();
    // o += a_h Wo[head rows, :]
    for (int n0 = 0; n0 < d; n0 += kBN) {
      const int n_valid = (d - n0) < kBN ? (d - n0) : kBN;
      float out[4][4];
      zero_acc(out);
      gemm_tile<float, T>(ahs, kLd, 1, seq,
                          wo.p + (i64)head * head_dim * wo.s_in +
                              n0 * wo.s_out,
                          wo.s_in, wo.s_out, n_valid, head_dim, out, As, Bs);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + tx * 4 + j;
          if (col < d) os[(ty * 4 + i) * d + col] += out[i][j];
        }
    }
  }

  // y = x + drop1(o + bo)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty * 4 + i;
    if (m >= seq) continue;
    const i64 r = r0 + m;
    for (int n0 = 0; n0 < d; n0 += kBN) {
      bool keep[4];
      keep4(drop, 1u, (uint32_t)((n0 + tx * 4) >> 2), (uint32_t)m,
            (uint32_t)frame, keep);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx * 4 + j;
        if (col >= d) continue;
        float o = os[m * d + col] + bo[col];
        if (drop.threshold != 0u) o = keep[j] ? o * drop.inv_keep : 0.f;
        y[r * d + col] = from_f32<T>(to_f32(x[r * d + col]) + o);
      }
    }
  }
}

// Backward shared memory in floats: As, Bs, then a region that holds q, k,
// v, da (kBM x kHeadLd each) and the dropped weights and ds (kBM x kBM each)
// during the head loop and the (kBM, d) f32 dh afterwards.
__host__ __device__ constexpr int attn_bwd_shared_floats(int d) {
  const int heads_part = 4 * kBM * kHeadLd + 2 * kBM * kBM;
  return kStageFloats + (heads_part > kBM * d ? heads_part : kBM * d);
}

// parts: (gridDim.x, 3 d) f32, a block's row [dbo | dg | dbe]. hbuf, dobbuf
// (B*T, d), a2buf (B*T, inner), dqkv (B*T, 3 inner): emitted in the I/O
// dtype for the weight-gradient products.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_kernel(const T* __restrict__ x, Weight<T> wq, Weight<T> wk,
                Weight<T> wv, Weight<T> wo, const float* __restrict__ g,
                const float* __restrict__ be, const T* __restrict__ gy,
                T* hbuf, T* dobbuf, T* a2buf, T* dqkv, T* __restrict__ dx,
                float* __restrict__ parts, int seq, int d, int heads,
                int head_dim, float scale, float eps, Drop drop) {
  extern __shared__ __align__(128) float smem[];
  float* As = smem;
  float* Bs = As + kBK * kLd;
  float* qs = Bs + kBK * kLd;
  float* ks = qs + kBM * kHeadLd;
  float* vs = ks + kBM * kHeadLd;
  float* das = vs + kBM * kHeadLd;       // d(merged heads) of this head
  float* ps = das + kBM * kHeadLd;       // dropped weights, rounded
  float* dss = ps + kBM * kBM;           // ds, rounded
  float* dhs = qs;                       // (kBM, d), after the head loop
  float* rowbuf = As;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int frame = blockIdx.x;
  const i64 r0 = (i64)frame * seq;
  const int inner = heads * head_dim;
  float* my_parts = parts + (i64)frame * 3 * d;

  float sc[kPerLane];
  load_param(g, d, lane, sc);
  {
    float bi[kPerLane], v[kPerLane], sum[kPerLane];
    load_param(be, d, lane, bi);
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) sum[e] = 0.f;
    for (int i = warp; i < seq; i += kWarps) {
      const i64 r = r0 + i;
      ln_row<T>(x + r * d, hbuf + r * d, sc, bi, d, lane, eps, v);
      masked_grad_row<T>(gy + r * d, dobbuf + r * d, drop, 1u, (uint32_t)i,
                         (uint32_t)frame, d, lane, sum);
    }
    block_col_sums(sum, d, rowbuf, my_parts);            // dbo
  }

  const T* h0 = hbuf + r0 * d;
  const T* dob0 = dobbuf + r0 * d;
  const int j0 = lane, j1 = lane + 32;
  for (int head = 0; head < heads; ++head) {
    project_head<T>(h0, seq, d, wq, head, head_dim, qs, As, Bs);
    project_head<T>(h0, seq, d, wk, head, head_dim, ks, As, Bs);
    project_head<T>(h0, seq, d, wv, head, head_dim, vs, As, Bs);
    {
      // da[n, i] = sum_d dob[n, d] Wo[i, d] for this head's i
      float acc[4][4];
      zero_acc(acc);
      gemm_tile<T, T>(dob0, d, 1, seq, wo.p + (i64)head * head_dim * wo.s_in,
                      wo.s_out, wo.s_in, head_dim, d, acc, As, Bs);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          das[(ty * 4 + i) * kHeadLd + tx * 4 + j] = round_io<T>(acc[i][j]);
    }
    __syncthreads();

    // Pass 1, one warp per query row: the row of dropped weights and of
    // ds; the head's output row (for dWo) and dq.
    for (int i = warp; i < seq; i += kWarps) {
      float w0, w1;
      softmax_row(qs + i * kHeadLd, ks, seq, head_dim, scale, j0, j1, &w0,
                  &w1);
      bool keep0 = true, keep1 = true;
      if (drop.threshold != 0u) {
        keep0 = philox1(drop.seed, 0u, j0, i, head, frame) >= drop.threshold;
        keep1 = philox1(drop.seed, 0u, j1, i, head, frame) >= drop.threshold;
      }
      const float* da_row = das + i * kHeadLd;
      float dd0 = 0.f, dd1 = 0.f;
      if (j0 < seq)
        for (int c = 0; c < head_dim; ++c)
          dd0 = fmaf(da_row[c], vs[j0 * kHeadLd + c], dd0);
      if (j1 < seq)
        for (int c = 0; c < head_dim; ++c)
          dd1 = fmaf(da_row[c], vs[j1 * kHeadLd + c], dd1);
      float p0 = w0, p1 = w1, dw0 = dd0, dw1 = dd1;
      if (drop.threshold != 0u) {
        p0 = keep0 ? w0 * drop.inv_keep : 0.f;
        p1 = keep1 ? w1 * drop.inv_keep : 0.f;
        dw0 = keep0 ? dd0 * drop.inv_keep : 0.f;
        dw1 = keep1 ? dd1 * drop.inv_keep : 0.f;
      }
      const float dot = warp_sum(dw0 * w0 + dw1 * w1);
      if (j0 < seq) {
        ps[i * kBM + j0] = round_io<T>(p0);
        dss[i * kBM + j0] = round_io<T>(w0 * (dw0 - dot) * scale);
      }
      if (j1 < seq) {
        ps[i * kBM + j1] = round_io<T>(p1);
        dss[i * kBM + j1] = round_io<T>(w1 * (dw1 - dot) * scale);
      }
      __syncwarp();
      const float* p_row = ps + i * kBM;
      const float* ds_row = dss + i * kBM;
      for (int c = lane; c < head_dim; c += 32) {
        float acc_a = 0.f, acc_q = 0.f;
        for (int j = 0; j < seq; ++j) {
          acc_a = fmaf(p_row[j], vs[j * kHeadLd + c], acc_a);
          acc_q = fmaf(ds_row[j], ks[j * kHeadLd + c], acc_q);
        }
        a2buf[(r0 + i) * inner + head * head_dim + c] = from_f32<T>(acc_a);
        dqkv[(r0 + i) * 3 * inner + head * head_dim + c] = from_f32<T>(acc_q);
      }
    }
    __syncthreads();
    // Pass 2, one warp per key row: dk_j = sum_i ds_ij q_i and
    // dv_j = sum_i dropped_ij da_i.
    for (int j = warp; j < seq; j += kWarps) {
      for (int c = lane; c < head_dim; c += 32) {
        float acc_k = 0.f, acc_v = 0.f;
        for (int i = 0; i < seq; ++i) {
          acc_k = fmaf(dss[i * kBM + j], qs[i * kHeadLd + c], acc_k);
          acc_v = fmaf(ps[i * kBM + j], das[i * kHeadLd + c], acc_v);
        }
        const i64 at = (r0 + j) * 3 * inner + head * head_dim + c;
        dqkv[at + inner] = from_f32<T>(acc_k);
        dqkv[at + 2 * inner] = from_f32<T>(acc_v);
      }
    }
    __syncthreads();
  }

  // dh[n, d] = sum_i dq[n, i] Wq[d, i] + dk[n, i] Wk[d, i] + dv[n, i] Wv[d, i]
  const T* dqkv0 = dqkv + r0 * 3 * inner;
  for (int n0 = 0; n0 < d; n0 += kBN) {
    const int n_valid = (d - n0) < kBN ? (d - n0) : kBN;
    float acc[4][4];
    zero_acc(acc);
    gemm_tile<T, T>(dqkv0, 3 * inner, 1, seq, wq.p + n0 * wq.s_in, wq.s_out,
                    wq.s_in, n_valid, inner, acc, As, Bs);
    gemm_tile<T, T>(dqkv0 + inner, 3 * inner, 1, seq, wk.p + n0 * wk.s_in,
                    wk.s_out, wk.s_in, n_valid, inner, acc, As, Bs);
    gemm_tile<T, T>(dqkv0 + 2 * inner, 3 * inner, 1, seq,
                    wv.p + n0 * wv.s_in, wv.s_out, wv.s_in, n_valid, inner,
                    acc, As, Bs);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx * 4 + j;
        if (col < d) dhs[(ty * 4 + i) * d + col] = acc[i][j];
      }
  }
  __syncthreads();

  float dg[kPerLane], dbe[kPerLane];
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) dg[e] = dbe[e] = 0.f;
  for (int i = warp; i < seq; i += kWarps) {
    const i64 r = r0 + i;
    ln_bwd_row<T>(x + r * d, gy + r * d, dhs + i * d, dx + r * d, sc, d, lane,
                  eps, dg, dbe);
  }
  block_col_sums(dg, d, rowbuf, my_parts + d);
  block_col_sums(dbe, d, rowbuf, my_parts + 2 * d);
}

// ---------------------------------------------------------------------------
// The "tc" variant of the attention sub-block: bf16, heads of 64, d a
// multiple of 64 up to 512, T <= 64 (the flagship ViT: T = 50, d = 512, 16
// heads). The weights arrive as stored, (out, in) row-major: wq, wk, wv
// (inner, d), wo (d, inner).
// ---------------------------------------------------------------------------

constexpr int kTcHead = 64;                     // the head width it takes
constexpr int kTcChunk = 64;                    // depth of one staged chunk
constexpr int kTcPitchH = kMaxD + 8;            // bf16 a row of h: 1,040 bytes
constexpr int kTcPitchDh = kMaxD + 4;           // f32 a row of dh
constexpr int kTcPitchDhB = 256 + 8;            // bf16 a row of 256 columns
constexpr int kTcTileElems = kBM * kTcStride;   // a (64, 64) tile
constexpr int kTcSmem = 232448;                 // all a block may have
// The forward, two blocks an SM: two stages of 256 swizzled rows of 64
// (h's or the merged heads' 64, then 192 of the weights) on 1,024 bytes,
// and q, k, v.
constexpr int kTcFwdStageElems = 256 * 64;
constexpr int kTcFwdBytes =
    1024 + 2 * kTcFwdStageElems * 2 + 3 * kTcTileElems * 2;
// The backward, one block an SM: h (bf16) and q, k, v, da, P, ds during the
// head loop, dh (f32) after it, and a ring in what is left. A stage of the
// head loop holds 320 rows of 64 (the weights' 192, do's 64, wo's 64); one
// of the dh product a (64, 64) chunk of dqkv and a (64, 256) one of the
// weights.
constexpr int kTcHBytes = kBM * kTcPitchH * 2;
constexpr int kTcBwdHeadBytes = kTcHBytes + 6 * kTcTileElems * 2;
constexpr int kTcDhBytes = kBM * kTcPitchDh * 4;
constexpr int kTcBwdRegion =
    kTcBwdHeadBytes > kTcDhBytes ? kTcBwdHeadBytes : kTcDhBytes;
constexpr int kTcBwdRing = kTcSmem - kTcBwdRegion;
constexpr int kTcHeadStageElems = 320 * kTcStride;
constexpr int kTcDhStageElems = kTcTileElems + kBM * kTcPitchDhB;
static_assert(2 * (kTcFwdBytes + 1024) <= 233472 &&
                  kTcBwdRing >= 2 * kTcHeadStageElems * 2 &&
                  kTcBwdRing >= 2 * kTcDhStageElems * 2 &&
                  kTcBwdRing >= kWarps * kMaxD * 4 && kTcBwdRegion % 16 == 0,
              "two forward blocks fit an SM; the backward's rings and "
              "block_col_sums' buffer fit beside what stays resident");

// Rows [0, rows) of a chunk of kGroups 16-byte groups a row, row r from
// src + r * ld, into dst (pitch elements a row) by cp.async; rows from
// valid_rows on and groups from valid_groups on are zero-filled.
template <int kGroups>
__device__ __forceinline__ void stage_chunk(bf16* dst, int pitch,
                                            const bf16* src, i64 ld,
                                            int rows, int valid_rows,
                                            int valid_groups) {
  for (int idx = threadIdx.x; idx < rows * kGroups; idx += kThreads) {
    const int r = idx / kGroups, c = idx % kGroups;
    const bool ok = r < valid_rows && c < valid_groups;
    cp_async16(dst + r * pitch + c * 8, ok ? src + r * ld + c * 8 : src,
               ok ? 16 : 0);
  }
}

// A ring of kStages chunks in flight: issue(c, stage) starts the loads of
// chunk c, step(c, stage) consumes it once every thread's loads of it have
// landed. Chunk c + kStages - 1 is issued after the barrier that ends
// everyone's step c - 1, into the stage that step read. Ends with every
// load done and a barrier. Every thread of the block calls it. ring_start
// issues the first kStages - 1 chunks and ring_steps runs the rest, so that
// a kernel can do other work while the first loads are in flight; run_ring
// does both.
template <int kStages, int kStageElems, typename Issue>
__device__ __forceinline__ void ring_start(bf16* ring, int total,
                                           Issue issue) {
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < total) issue(c, ring + c * kStageElems);
    cp_async_commit();
  }
}

template <int kStages, int kStageElems, typename Issue, typename Step>
__device__ __forceinline__ void ring_steps(bf16* ring, int total, Issue issue,
                                           Step step) {
  for (int c = 0; c < total; ++c) {
    cp_async_wait<kStages - 2>();
    // What cp.async wrote (generic proxy) may be read by wgmma (async
    // proxy) once the barrier has published it.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int next = c + kStages - 1;
    if (next < total) issue(next, ring + (next % kStages) * kStageElems);
    cp_async_commit();
    step(c, ring + (c % kStages) * kStageElems);
  }
  cp_async_wait<0>();
  __syncthreads();
}

template <int kStages, int kStageElems, typename Issue, typename Step>
__device__ __forceinline__ void run_ring(bf16* ring, int total, Issue issue,
                                         Step step) {
  ring_start<kStages, kStageElems>(ring, total, issue);
  ring_steps<kStages, kStageElems>(ring, total, issue, step);
}

// acc[i][j] += the C fragments of the warp's (16 MT, 8 NT) piece, rows
// m0.. and columns n0.., of A B over one kDepth-deep chunk in shared
// memory. A is [m][k] (pitch pa) or, with AKRow, [k][m]; B is [n][k] (pitch
// pb) or, with BKRow, [k][n]; ldmatrix (.trans for the [k][.] layouts)
// gives the fragments, as K1's core reads its tiles.
template <int kDepth, int MT, int NT, bool AKRow, bool BKRow>
__device__ __forceinline__ void mma_chunk(const bf16* A, int pa, int m0,
                                          const bf16* B, int pb, int n0,
                                          int lane, float (&acc)[MT][NT][4]) {
  static_assert(NT % 2 == 0, "B fragments come two n-tiles at a time");
#pragma unroll
  for (int kk = 0; kk < kDepth; kk += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m = m0 + 16 * i;
      if (AKRow)
        ldsm_x4_trans(A + (kk + (lane & 7) + ((lane >> 4) << 3)) * pa + m +
                          ((lane >> 3) & 1) * 8,
                      a[i]);
      else
        ldsm_x4(A + (m + (lane & 15)) * pa + kk + (lane >> 4) * 8, a[i]);
    }
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      const int n = n0 + 8 * j;
      uint32_t b[4];
      if (BKRow)
        ldsm_x4_trans(B + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * pb + n +
                          (lane >> 4) * 8,
                      b);
      else
        ldsm_x4(B + (n + (lane & 7) + ((lane >> 4) << 3)) * pb + kk +
                    ((lane >> 3) & 1) * 8,
                b);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_bf16(acc[i][j], a[i], b[0], b[1]);
        mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
      }
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_frags(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// The C fragments of a warp's 16 rows from r0 (columns 8n..8n+7 in acc[n])
// rounded to bf16 and stored to rows r0.. of dst, rows ld apart; rows from
// seq on are not written.
template <int NT>
__device__ __forceinline__ void store_frag_rows(const float (&acc)[NT][4],
                                                bf16* dst, i64 ld, int r0,
                                                int seq, int lane) {
  const int gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    bf16* at = dst + 8 * n + 2 * t;
    if (r0 + gr < seq)
      *reinterpret_cast<uint32_t*>(at + (r0 + gr) * ld) =
          pack_bf16(acc[n][0], acc[n][1]);
    if (r0 + gr + 8 < seq)
      *reinterpret_cast<uint32_t*>(at + (r0 + gr + 8) * ld) =
          pack_bf16(acc[n][2], acc[n][3]);
  }
}

// A warp's (16 MT, 8 NT) piece of C fragments, rows m0.. and columns n0..,
// rounded to bf16 into (64, 64) tiles that follow each other from ``tiles``
// (column c goes to tile c / 64).
template <int MT, int NT>
__device__ __forceinline__ void frags_to_tiles(const float (&acc)[MT][NT][4],
                                               bf16* tiles, int m0, int n0,
                                               int lane) {
  const int gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = m0 + 16 * i + gr, col = n0 + 8 * j;
      bf16* at = tiles + (col >> 6) * kTcTileElems + row * kTcStride +
                 (col & 63) + 2 * t;
      *reinterpret_cast<uint32_t*>(at) = pack_bf16(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<uint32_t*>(at + 8 * kTcStride) =
          pack_bf16(acc[i][j][2], acc[i][j][3]);
    }
}

// h = LN(x) of the frame's rows into hs (bf16, rows of kTcPitchH); rows seq
// to 63 are zeros. Warp-per-row, as the present kernels.
__device__ __forceinline__ void ln_rows_to_shared(const bf16* x, bf16* hs,
                                                  const float* g,
                                                  const float* be, int seq,
                                                  int d, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float sc[kPerLane], bi[kPerLane], v[kPerLane];
  load_param(g, d, lane, sc);
  load_param(be, d, lane, bi);
  for (int i = warp; i < kBM; i += kWarps) {
    if (i < seq) {
      ln_row<bf16>(x + (i64)i * d, hs + i * kTcPitchH, sc, bi, d, lane, eps,
                   v);
    } else {
      for (int col = lane * 8; col < d; col += 256)
        *reinterpret_cast<uint4*>(hs + i * kTcPitchH + col) =
            make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// One head's q, k, v chunk of the weights: rows head * 64.. of wq, wk, wv
// (64 each, columns k0..k0+63) as the stage's 192 rows [n][k].
__device__ __forceinline__ void stage_qkv_weights(bf16* st, const bf16* wq,
                                                  const bf16* wk,
                                                  const bf16* wv, int head,
                                                  int k0, int d) {
  const i64 at = (i64)head * kTcHead * d + k0;
  stage_chunk<8>(st, kTcStride, wq + at, d, 64, 64, 8);
  stage_chunk<8>(st + 64 * kTcStride, kTcStride, wk + at, d, 64, 64, 8);
  stage_chunk<8>(st + 128 * kTcStride, kTcStride, wv + at, d, 64, 64, 8);
}

// The dropout multipliers of site 0 applied to the weights of a warp's 16
// query rows from r0: kept weights times 1 / (1 - rate), dropped ones 0.
__device__ __forceinline__ uint32_t attention_keep(const Drop& drop,
                                                   uint32_t frame,
                                                   uint32_t head, int r0,
                                                   int lane, int seq) {
  return drop.threshold != 0u
             ? keep_bits<8>(drop.seed, 3u, frame, head, r0, 0, lane, seq,
                            drop.threshold)
             : 0xffffffffu;
}

// ---- Hopper's warpgroup MMA (wgmma), for the forward's products ----
// An operand chunk is R rows of 64 bf16 (128 bytes), starting on 1,024
// bytes, in the 128-byte swizzle that wgmma reads: the 16-byte group c of
// row r sits at group c ^ (r % 8).

// Rows [0, rows) of such a chunk, row r from src + r * ld, by cp.async;
// rows from valid_rows on are zero-filled.
__device__ __forceinline__ void stage_swizzled(bf16* dst, const bf16* src,
                                               i64 ld, int rows,
                                               int valid_rows) {
  for (int idx = threadIdx.x; idx < rows * 8; idx += kThreads) {
    const int r = idx >> 3, c = idx & 7;
    const bool ok = r < valid_rows;
    cp_async16(dst + r * 64 + ((c ^ (r & 7)) << 3),
               ok ? src + r * ld + c * 8 : src, ok ? 16 : 0);
  }
}

// The descriptor of a K-major chunk: start address, a leading byte offset
// of 1 (unused in this swizzle), 1,024 bytes from one 8-row group to the
// next, 128-byte swizzle. A 16-deep step further along k adds 32 bytes,
// 2 in the start address's 16-byte units.
__device__ __forceinline__ uint64_t wgmma_desc(const bf16* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// Keeps the compiler from moving accesses to the accumulators across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A B^T for a warpgroup: A 64 x 16 and B 96 x 16, both K-major in
// shared memory. Thread (warp w of the warpgroup, lane g * 4 + t) holds
// d[4 j + e] at row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2: the C
// fragments of mma.sync for 12 tiles of 8 columns.
__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[48], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

// acc (a warpgroup's 64 x 96) += A B^T over one 64-deep chunk: A the
// stage's 64 rows, B 96 rows from b.
__device__ __forceinline__ void wgmma_chunk(float (&acc)[48], const bf16* a,
                                            const bf16* b) {
  // cp.async wrote the chunk through the generic proxy; wgmma reads it
  // through the async one.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  fence_operands(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  const uint64_t da = wgmma_desc(a), db = wgmma_desc(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n96k16(acc, da + 2 * kk, db + 2 * kk);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operands(acc);
}

// d += A B^T for a warpgroup: A 64 x 16 and B 64 x 16, both K-major in
// shared memory; d in the C fragment layout of wgmma_m64n96k16, for 8
// tiles of 8 columns.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// acc (a warpgroup's 64 x 64) += A B^T over one 64-deep chunk: A 64 rows
// from a, B 64 rows from b (the MLP's tc forward).
__device__ __forceinline__ void wgmma_chunk(float (&acc)[32], const bf16* a,
                                            const bf16* b) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  fence_operands(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  const uint64_t da = wgmma_desc(a), db = wgmma_desc(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16(acc, da + 2 * kk, db + 2 * kk);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operands(acc);
}

// Warp w < 4 of the forward: query rows 16 w.. of one head, K1's tc core
// (csrc/mhsa_short.cu): the weights, dropped at site 0 and rounded, times
// v; the merged head's rows, rounded, to dst (rows ld apart).
__device__ __forceinline__ void core_fwd(const bf16* qs, const bf16* ks,
                                         const bf16* vs, bf16* dst, i64 ld,
                                         int seq, uint32_t frame,
                                         uint32_t head, int warp, int lane,
                                         float scale_log2, const Drop& drop) {
  const int r0 = 16 * warp;
  if (r0 >= seq) return;
  float s[8][4] = {};
  row_products<kTcHead>(qs, ks, r0, lane, seq, s);
  softmax_rows(s, lane, seq, scale_log2);
  const uint32_t keep = attention_keep(drop, frame, head, r0, lane, seq);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[n][e] = (keep >> (4 * n + e)) & 1u ? s[n][e] * drop.inv_keep : 0.f;
  uint32_t p[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) to_a_fragment(s[2 * kk], s[2 * kk + 1], p[kk]);
  float acc[8][4] = {};
  times_tile<kTcHead>(p, vs, lane, seq, acc);
  store_frag_rows<8>(acc, dst, ld, r0, seq, lane);
}

// y = x + drop1(o + bo) for a warp's (16 MT, 48) piece of o, rows m0.. and
// columns c0.. of the frame (a multiple of 16; columns from d on are
// skipped, d being a multiple of 64).
template <int MT>
__device__ __forceinline__ void output_epilogue(const float (&out)[MT][6][4],
                                                const bf16* x,
                                                const float* bo, bf16* y,
                                                int seq, int d, int c0,
                                                int m0, uint32_t frame,
                                                int lane, const Drop& drop) {
  if (c0 >= d) return;
  const int gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int rb = m0 + 16 * i;
    const uint32_t keep =
        drop.threshold != 0u
            ? keep_bits<6>(drop.seed, 4u, frame, 0u, rb, c0, lane, d,
                           drop.threshold)
            : 0xffffffffu;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int col = c0 + 8 * j + 2 * t;
      if (c0 + 8 * j >= d) break;
      const float b0 = bo[col], b1 = bo[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rb + gr + 8 * h;
        if (row >= seq) continue;
        float o0 = out[i][j][2 * h] + b0, o1 = out[i][j][2 * h + 1] + b1;
        if (drop.threshold != 0u) {
          o0 = (keep >> (4 * j + 2 * h)) & 1u ? o0 * drop.inv_keep : 0.f;
          o1 = (keep >> (4 * j + 2 * h + 1)) & 1u ? o1 * drop.inv_keep : 0.f;
        }
        const i64 at = (i64)row * d + col;
        const __nv_bfloat162 xv =
            *reinterpret_cast<const __nv_bfloat162*>(x + at);
        *reinterpret_cast<uint32_t*>(y + at) =
            pack_bf16(__low2float(xv) + o0, __high2float(xv) + o1);
      }
    }
  }
}

// The forward, two blocks an SM (kTcFwdBytes of shared memory, at most 128
// registers a thread), so that one block's loads, barriers and core overlap
// the other's products; the products on wgmma, a warpgroup a half of the
// columns. A block walks the frames blockIdx.x, + gridDim.x, ...; h goes
// through hbuf (B*T, d) and abuf holds (gridDim.x, 64, inner): a block's
// merged heads. A block reads back only what it wrote, so both stay in L2.
__global__ void __launch_bounds__(kThreads, 2)
attn_fwd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wq,
                   const bf16* __restrict__ wk, const bf16* __restrict__ wv,
                   const bf16* __restrict__ wo, const float* __restrict__ bo,
                   const float* __restrict__ g, const float* __restrict__ be,
                   bf16* hbuf, bf16* abuf, bf16* __restrict__ y, int batch,
                   int seq, int d, int heads, float scale_log2, float eps,
                   Drop drop) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* ring = reinterpret_cast<bf16*>(
      tc_smem + ((1024u - (smem_addr(tc_smem) & 1023u)) & 1023u));
  bf16* qs = ring + 2 * kTcFwdStageElems;   // then ks, vs
  bf16* ks = qs + kTcTileElems;
  bf16* vs = ks + kTcTileElems;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = 16 * (warp & 3), n0 = 96 * (warp >> 2);
  const int inner = heads * kTcHead;
  const int kc = d / kTcChunk, ki = inner / kTcChunk;
  bf16* a0 = abuf + (i64)blockIdx.x * kBM * inner;

  for (int frame = blockIdx.x; frame < batch; frame += gridDim.x) {
    const i64 r0 = (i64)frame * seq;
    bf16* h0 = hbuf + r0 * d;
    {
      float sc[kPerLane], bi[kPerLane], v[kPerLane];
      load_param(g, d, lane, sc);
      load_param(be, d, lane, bi);
      for (int i = warp; i < seq; i += kWarps)
        ln_row<bf16>(x + (r0 + i) * d, h0 + (i64)i * d, sc, bi, d, lane, eps,
                     v);
    }
    __syncthreads();   // h is read back by other threads' copies

    // Per head: [q | k | v] (64 x 192) = h [Wq; Wk; Wv]_head^T over d in
    // chunks of 64 (stage rows 0-63 h, 64-255 the weights' rows), then the
    // core on warps 0-3; the merged head to a0.
    for (int head = 0; head < heads; ++head) {
      float acc[1][12][4];
      zero_frags(acc);
      float (&flat)[48] = reinterpret_cast<float (&)[48]>(acc);
      run_ring<2, kTcFwdStageElems>(
          ring, kc,
          [&](int c, bf16* st) {
            const i64 at = (i64)head * kTcHead * d + c * kTcChunk;
            stage_swizzled(st, h0 + c * kTcChunk, d, 64, seq);
            stage_swizzled(st + 64 * 64, wq + at, d, 64, 64);
            stage_swizzled(st + 128 * 64, wk + at, d, 64, 64);
            stage_swizzled(st + 192 * 64, wv + at, d, 64, 64);
          },
          [&](int, const bf16* st) {
            wgmma_chunk(flat, st, st + (64 + n0) * 64);
          });
      frags_to_tiles(acc, qs, m0, n0, lane);
      __syncthreads();
      if (warp < 4)
        core_fwd(qs, ks, vs, a0 + head * kTcHead, inner, seq, frame, head,
                 warp, lane, scale_log2, drop);
    }
    __syncthreads();   // the merged heads are read back by other threads

    // o = a Wo^T in passes of 192 columns over inner, in chunks of 64: stage
    // rows 0-63 the merged heads, 64-255 the rows of wo.
    for (int p0 = 0; p0 < d; p0 += 192) {
      float out[1][12][4];
      zero_frags(out);
      float (&flat)[48] = reinterpret_cast<float (&)[48]>(out);
      run_ring<2, kTcFwdStageElems>(
          ring, ki,
          [&](int c, bf16* st) {
            stage_swizzled(st, a0 + c * kTcChunk, inner, 64, seq);
            stage_swizzled(st + 64 * 64, wo + (i64)p0 * inner + c * kTcChunk,
                           inner, 192, d - p0);
          },
          [&](int, const bf16* st) {
            wgmma_chunk(flat, st, st + (64 + n0) * 64);
          });
      // The warp's 96 columns as two pieces of 48.
      typedef const float(Piece)[1][6][4];
      output_epilogue(reinterpret_cast<Piece&>(out[0][0]), x + r0 * d, bo,
                      y + r0 * d, seq, d, p0 + n0, m0, frame, lane, drop);
      output_epilogue(reinterpret_cast<Piece&>(out[0][6]), x + r0 * d, bo,
                      y + r0 * d, seq, d, p0 + n0 + 48, m0, frame, lane,
                      drop);
    }
  }
}

// acc[n] += the C fragment of output tile n of A^T X for the 16 columns j0..
// of A, a (64, 64) tile whose rows are the sum's index (from seq on
// skipped), and X a (64, 64) tile: both read transposed by ldmatrix, as
// K1's backward reads P and ds.
__device__ __forceinline__ void transposed_products(const bf16* a,
                                                    const bf16* x, int j0,
                                                    int lane, int seq,
                                                    float (&acc)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (16 * kk >= seq) break;
    uint32_t af[4];
    ldsm_x4_trans(a + (16 * kk + (lane & 7) + ((lane >> 4) << 3)) * kTcStride +
                      j0 + ((lane >> 3) & 1) * 8,
                  af);
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t bf[4];
      ldsm_x4_trans(x + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                            kTcStride +
                        8 * n + (lane >> 4) * 8,
                    bf);
      mma_bf16(acc[n], af, bf[0], bf[1]);
      mma_bf16(acc[n + 1], af, bf[2], bf[3]);
    }
  }
}

// The A fragments of rows r0.. of a (64, 64) tile, as P V's.
__device__ __forceinline__ void row_fragments(const bf16* tile, int r0,
                                              int lane, uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldsm_x4(tile + (r0 + (lane & 15)) * kTcStride + kk * 16 + (lane >> 4) * 8,
            a[kk]);
}

// The backward's core of one head, K1's tc backward (csrc/mhsa_short.cu)
// with da for g. Pass 1, warp w < 4, query rows 16 w..: the weights, the
// mask, dP = da v^T and ds; the dropped weights and ds go to shared memory
// as bf16. Pass 2, rows 16 (w % 4)..: dq = ds k and dk = ds^T q on warps
// 0-3, dv = P^T da and the merged head's a = P v on warps 4-7. dq, dk, dv
// go to the head's columns of dqkv (rows ld3 apart), a to a2 (rows inner
// apart).
__device__ __forceinline__ void core_bwd(const bf16* qs, const bf16* ks,
                                         const bf16* vs, const bf16* das,
                                         bf16* ps, bf16* dss, bf16* dqkv,
                                         i64 ld3, int inner, bf16* a2,
                                         int seq, uint32_t frame,
                                         uint32_t head, int warp, int lane,
                                         float scale, float scale_log2,
                                         const Drop& drop) {
  const int gr = lane >> 2, t = lane & 3;
  if (warp < 4 && 16 * warp < seq) {
    const int r0 = 16 * warp;
    float w[8][4] = {};
    row_products<kTcHead>(qs, ks, r0, lane, seq, w);
    softmax_rows(w, lane, seq, scale_log2);
    const uint32_t keep = attention_keep(drop, frame, head, r0, lane, seq);
    float dw[8][4] = {};
    row_products<kTcHead>(das, vs, r0, lane, seq, dw);   // d_dropped
    float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dw[n][e] = (keep >> (4 * n + e)) & 1u ? dw[n][e] * drop.inv_keep : 0.f;
        if (e < 2)
          dot0 += dw[n][e] * w[n][e];
        else
          dot1 += dw[n][e] * w[n][e];
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      dot0 += __shfl_xor_sync(0xffffffffu, dot0, off);
      dot1 += __shfl_xor_sync(0xffffffffu, dot1, off);
    }
    // Padded query rows get zero dropped weights and ds, so that they add
    // nothing to dv, dk and a; padded key columns have w = 0, hence ds = 0.
    const bool upper = r0 + gr < seq, lower = r0 + gr + 8 < seq;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float pv[4], dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool row_ok = e < 2 ? upper : lower;
        const bool kept = (keep >> (4 * n + e)) & 1u;
        pv[e] = row_ok && kept ? w[n][e] * drop.inv_keep : 0.f;
        dsv[e] = row_ok ? w[n][e] * (dw[n][e] - (e < 2 ? dot0 : dot1)) * scale
                        : 0.f;
      }
      bf16* at = ps + (r0 + gr) * kTcStride + 8 * n + 2 * t;
      *reinterpret_cast<uint32_t*>(at) = pack_bf16(pv[0], pv[1]);
      *reinterpret_cast<uint32_t*>(at + 8 * kTcStride) =
          pack_bf16(pv[2], pv[3]);
      at = dss + (r0 + gr) * kTcStride + 8 * n + 2 * t;
      *reinterpret_cast<uint32_t*>(at) = pack_bf16(dsv[0], dsv[1]);
      *reinterpret_cast<uint32_t*>(at + 8 * kTcStride) =
          pack_bf16(dsv[2], dsv[3]);
    }
  }
  __syncthreads();
  const int j0 = 16 * (warp & 3);
  if (j0 >= seq) return;
  const bool ds_warp = warp < 4;
  const bf16* rows = ds_warp ? dss : ps;
  uint32_t frag[4][4];
  row_fragments(rows, j0, lane, frag);
  float acc[8][4] = {};
  times_tile<kTcHead>(frag, ds_warp ? ks : vs, lane, seq, acc);  // dq, a
  store_frag_rows<8>(acc, ds_warp ? dqkv : a2, ds_warp ? ld3 : inner, j0,
                     seq, lane);
  float acc_t[8][4] = {};
  transposed_products(rows, ds_warp ? qs : das, j0, lane, seq, acc_t);
  store_frag_rows<8>(acc_t, dqkv + (ds_warp ? inner : 2 * inner), ld3, j0,
                     seq, lane);                                 // dk, dv
}

// The backward of one frame a block. parts: (batch, 3 d) f32, a block's row
// [dbo | dg | dbe]; hbuf, dobbuf (B*T, d), a2buf (B*T, inner), dqkv (B*T, 3
// inner) emitted for the weight-gradient products.
__global__ void __launch_bounds__(kThreads)
attn_bwd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wq,
                   const bf16* __restrict__ wk, const bf16* __restrict__ wv,
                   const bf16* __restrict__ wo, const float* __restrict__ g,
                   const float* __restrict__ be, const bf16* __restrict__ gy,
                   bf16* hbuf, bf16* dobbuf, bf16* a2buf, bf16* dqkv,
                   bf16* __restrict__ dx, float* __restrict__ parts, int seq,
                   int d, int heads, float scale_log2, float eps, Drop drop) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* hs = reinterpret_cast<bf16*>(tc_smem);
  bf16* qs = hs + kBM * kTcPitchH;   // then ks, vs, das, ps, dss
  bf16* ks = qs + kTcTileElems;
  bf16* vs = ks + kTcTileElems;
  bf16* das = vs + kTcTileElems;
  bf16* ps = das + kTcTileElems;
  bf16* dss = ps + kTcTileElems;
  float* dhs = reinterpret_cast<float*>(tc_smem);   // after the head loop
  bf16* ring = reinterpret_cast<bf16*>(tc_smem + kTcBwdRegion);
  float* rowbuf = reinterpret_cast<float*>(ring);   // outside the rings

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = 32 * (warp >> 2), wn = warp & 3;
  const int frame = blockIdx.x;
  const i64 r0 = (i64)frame * seq;
  const int inner = heads * kTcHead;
  const int kc = d / kTcChunk, ki = inner / kTcChunk;
  const i64 ld3 = 3LL * inner;
  float* my_parts = parts + (i64)frame * 3 * d;

  ln_rows_to_shared(x + r0 * d, hs, g, be, seq, d, eps);
  {
    // do = drop1's mask on gy, rounded, to dobbuf; dbo's partial row.
    float sum[kPerLane];
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) sum[e] = 0.f;
    for (int i = warp; i < seq; i += kWarps)
      masked_grad_row<bf16>(gy + (r0 + i) * d, dobbuf + (r0 + i) * d, drop,
                            1u, (uint32_t)i, (uint32_t)frame, d, lane, sum);
    block_col_sums(sum, d, rowbuf, my_parts);   // ends with a barrier
  }
  for (int idx = threadIdx.x; idx < seq * (d / 8); idx += kThreads) {
    const int i = idx / (d / 8), c = idx % (d / 8);
    *reinterpret_cast<uint4*>(hbuf + (r0 + i) * d + c * 8) =
        *reinterpret_cast<const uint4*>(hs + i * kTcPitchH + c * 8);
  }

  // Per head, in chunks of 64 over d: warps 0-5 form [q | k | v] (64 x 192,
  // a warp 32 x 64) from h, warps 6-7 da (64 x 64) = do Wo[:, head] from
  // do; stage rows 0-191 hold the weights' rows [n][k], 192-255 do's
  // [m][k], 256-319 wo's [k][n]. Then the core.
  const bool qkv_warp = warp < 6;
  const int pm = qkv_warp ? 32 * (warp / 3) : 32 * (warp - 6);
  const int pn = qkv_warp ? 64 * (warp % 3) : 0;
  float acc[2][8][4];
  zero_frags(acc);
  run_ring<2, kTcHeadStageElems>(
      ring, heads * kc,
      [&](int c, bf16* st) {
        const int head = c / kc, k0 = (c % kc) * kTcChunk;
        stage_qkv_weights(st, wq, wk, wv, head, k0, d);
        stage_chunk<8>(st + 192 * kTcStride, kTcStride, dobbuf + r0 * d + k0,
                       d, 64, seq, 8);
        stage_chunk<8>(st + 256 * kTcStride, kTcStride,
                       wo + (i64)k0 * inner + head * kTcHead, inner, 64, 64,
                       8);
      },
      [&](int c, const bf16* st) {
        const int head = c / kc, j = c % kc;
        if (qkv_warp)
          mma_chunk<kTcChunk, 2, 8, false, false>(
              hs + j * kTcChunk, kTcPitchH, pm, st, kTcStride, pn, lane, acc);
        else
          mma_chunk<kTcChunk, 2, 8, false, true>(
              st + 192 * kTcStride, kTcStride, pm, st + 256 * kTcStride,
              kTcStride, 0, lane, acc);
        if (j != kc - 1) return;
        frags_to_tiles(acc, qkv_warp ? qs : das, pm, pn, lane);
        zero_frags(acc);
        __syncthreads();
        core_bwd(qs, ks, vs, das, ps, dss, dqkv + r0 * ld3 + head * kTcHead,
                 ld3, inner, a2buf + r0 * inner + head * kTcHead, seq, frame,
                 head, warp, lane, 0.125f, scale_log2, drop);
      });

  // dh (64 x d, f32) = dq Wq + dk Wk + dv Wv in passes of 256 columns over
  // 3 inner, in chunks of 64: stage rows 0-63 dqkv's [m][k], then 64 rows
  // of the weights [k][n], kTcPitchDh2 elements apart.
  const int kq = 3 * ki;
  float out[2][8][4];
  zero_frags(out);
  run_ring<2, kTcDhStageElems>(
      ring, (d + 255) / 256 * kq,
      [&](int c, bf16* st) {
        const int n0 = (c / kq) * 256, j = c % kq;
        const bf16* w = j < ki ? wq : j < 2 * ki ? wk : wv;
        stage_chunk<8>(st, kTcStride, dqkv + r0 * ld3 + j * kTcChunk, ld3,
                       64, seq, 8);
        stage_chunk<32>(st + kTcTileElems, kTcPitchDhB,
                        w + (i64)(j % ki) * kTcChunk * d + n0, d, 64, 64,
                        (d - n0) / 8);
      },
      [&](int c, const bf16* st) {
        const int j = c % kq;
        mma_chunk<kTcChunk, 2, 8, false, true>(st, kTcStride, m0,
                                               st + kTcTileElems, kTcPitchDhB,
                                               64 * wn, lane, out);
        if (j != kq - 1) return;
        const int c0 = (c / kq) * 256 + 64 * wn;
        if (c0 < d) {
          const int gr = lane >> 2, t = lane & 3;
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              float* at = dhs + (m0 + 16 * i + gr) * kTcPitchDh + c0 +
                          8 * jj + 2 * t;
              *reinterpret_cast<float2*>(at) =
                  make_float2(out[i][jj][0], out[i][jj][1]);
              *reinterpret_cast<float2*>(at + 8 * kTcPitchDh) =
                  make_float2(out[i][jj][2], out[i][jj][3]);
            }
        }
        zero_frags(out);
      });

  float sc[kPerLane], dg[kPerLane], dbe[kPerLane];
  load_param(g, d, lane, sc);
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) dg[e] = dbe[e] = 0.f;
  for (int i = warp; i < seq; i += kWarps) {
    const i64 r = r0 + i;
    ln_bwd_row<bf16>(x + r * d, gy + r * d, dhs + i * kTcPitchDh, dx + r * d,
                     sc, d, lane, eps, dg, dbe);
  }
  block_col_sums(dg, d, rowbuf, my_parts + d);
  block_col_sums(dbe, d, rowbuf, my_parts + 2 * d);
}

// ---------------------------------------------------------------------------
// The "tc" variant of the MLP sub-block: bf16, d and f multiples of 64, d
// up to 512 (the flagship ViT: d = f = 512). The weights arrive as stored, (out,
// in) row-major: w1 (f, d), w2 (d, f). A tile is 64 rows of the flattened
// (B*T, d) stream; operands in shared memory are (64, 64) chunks in the
// 128-byte swizzle that wgmma reads and ldmatrix reads without bank
// conflicts.
// ---------------------------------------------------------------------------

constexpr int kSwzChunk = 64 * 64;                          // 8 KB of bf16
constexpr int kMlpRowsBytes = kMaxD / 64 * kSwzChunk * 2;   // 64 rows of d
// The forward, two blocks an SM: h resident, a ring of three stages of 128
// weight rows 64 deep for z = h W1^T, then one of four stages of a's 64
// rows and 128 weight rows for o = a W2^T over both regions.
constexpr int kMlpPass = 128;
constexpr int kMlpHStageElems = kMlpPass * 64;
constexpr int kMlpOStageElems = kSwzChunk + kMlpPass * 64;
constexpr int kMlpFwdBytes = 1024 + kMlpRowsBytes + 3 * kMlpHStageElems * 2;
// The backward, two blocks an SM: h resident; a ring of two stages of
// phase A (W1's (64, 64) chunk [n][k], W2's [k][n], do's [m][k]), then one
// of four stages of phase B (dz's (64, 64) [m][k], W1's (64, 128) [k][n])
// over both regions; db1's partial sums of one 64-column chunk.
constexpr int kMlpStageElems = 3 * kSwzChunk;
constexpr int kMlpBwdBytes =
    128 + kMlpRowsBytes + 2 * kMlpStageElems * 2 + 2 * 64 * 4;
static_assert(2 * (kMlpFwdBytes + 1024) <= 233472 &&
                  4 * kMlpOStageElems * 2 <=
                      kMlpRowsBytes + 3 * kMlpHStageElems * 2 &&
                  2 * (kMlpBwdBytes + 1024) <= 233472 &&
                  4 * kMlpStageElems * 2 <=
                      kMlpRowsBytes + 2 * kMlpStageElems * 2 &&
                  kWarps * kMaxD * 4 <= kMlpRowsBytes,
              "two blocks of either kernel fit an SM; each kernel's second "
              "ring fits the region of h and the first ring; block_col_sums' "
              "buffer fits h's place");

// p moved up to the next multiple of ``align`` bytes (a power of 2) of the
// shared address space.
template <unsigned kAlign>
__device__ __forceinline__ unsigned char* aligned(unsigned char* p) {
  return p + ((kAlign - (smem_addr(p) & (kAlign - 1u))) & (kAlign - 1u));
}

// Element (row, col) of an operand kept as chunks of 64 columns, ``chunk``
// elements apart, rows of 128 bytes in stage_swizzled's layout: the 16-byte
// group c of row r at group c ^ (r % 8).
__device__ __forceinline__ int swz(int row, int col, int chunk) {
  return (col >> 6) * chunk + row * 64 +
         ((((col >> 3) & 7) ^ (row & 7)) << 3) + (col & 7);
}

constexpr int kGroups = kPerLane / 4;   // a lane's groups of four columns

// Row i of a bf16 tensor (rows d apart) as the lane's values (col_of's
// layout, 0 past d): load_row's, a lane's four columns in one 8-byte load,
// which d a multiple of 4 and an aligned tensor allow.
__device__ __forceinline__ void row_values(const bf16* rows, int i, int d,
                                           int lane, float (&v)[kPerLane]) {
#pragma unroll
  for (int c = 0; c < kGroups; ++c) {
    const int col = (32 * c + lane) * 4;
    uint2 u = make_uint2(0u, 0u);
    if (col < d) u = *reinterpret_cast<const uint2*>(rows + i * d + col);
    const __nv_bfloat162* two = reinterpret_cast<const __nv_bfloat162*>(&u);
    v[4 * c] = __low2float(two[0]);
    v[4 * c + 1] = __high2float(two[0]);
    v[4 * c + 2] = __low2float(two[1]);
    v[4 * c + 3] = __high2float(two[1]);
  }
}

__device__ __forceinline__ uint2 pack4(const float* v) {
  return make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

// h = LN(x) of a tile's rows (``valid`` of its 64, d apart from x; the
// others zeros), rounded to bf16 as ln_row rounds it, into hs (swizzled
// chunks) and, where hout is given, to hout's rows. Warp per row.
__device__ __forceinline__ void mlp_ln_rows(const bf16* x, bf16* hs,
                                            bf16* hout, const float* g,
                                            const float* be, int valid, int d,
                                            float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float sc[kPerLane], bi[kPerLane];
  load_param(g, d, lane, sc);
  load_param(be, d, lane, bi);
  for (int i = warp; i < kBM; i += kWarps) {
    float v[kPerLane];
    if (i < valid) {
      row_values(x, i, d, lane, v);
      normalize_row(v, d, lane, eps);
#pragma unroll
      for (int e = 0; e < kPerLane; ++e)
        v[e] = __fadd_rn(__fmul_rn(v[e], sc[e]), bi[e]);
    } else {
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < kGroups; ++c) {
      const int col = (32 * c + lane) * 4;
      if (col >= d) continue;
      const uint2 packed = pack4(v + 4 * c);
      *reinterpret_cast<uint2*>(hs + swz(i, col, kSwzChunk)) = packed;
      if (hout != nullptr && i < valid)
        *reinterpret_cast<uint2*>(hout + (i64)i * d + col) = packed;
    }
  }
}

// do = drop3's mask on gy for the block's rows from r0 (absolute; ``valid``
// of them), as masked_grad_row computes it, rounded to bf16 into dobbuf's
// rows; the f32 values are added to the lane's column sums. Warp per row.
__device__ __forceinline__ void mlp_masked_rows(const bf16* gy, bf16* dobbuf,
                                                i64 r0, int valid, int seq,
                                                int d, const Drop& drop,
                                                float (&sum)[kPerLane]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < valid; i += kWarps) {
    const i64 r = r0 + i;
    const uint32_t row = (uint32_t)(r % seq), frame = (uint32_t)(r / seq);
    float v[kPerLane];
    row_values(gy, i, d, lane, v);
#pragma unroll
    for (int c = 0; c < kGroups; ++c) {
      const int group = 32 * c + lane, col = group * 4;
      if (col >= d) continue;
      if (drop.threshold != 0u) {
        bool keep[4];
        keep4(drop, 3u, (uint32_t)group, row, frame, keep);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[4 * c + e] = keep[e] ? v[4 * c + e] * drop.inv_keep : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[4 * c + e] += v[4 * c + e];
      *reinterpret_cast<uint2*>(dobbuf + (i64)i * d + col) = pack4(v + 4 * c);
    }
  }
}

// The counter words (row % seq, row / seq) of the row that a lane draws
// in keep_bits_at for a warp's 16 rows from rb, absolute rows of the
// flattened stream (which may span two frames).
__device__ __forceinline__ uint2 drawn_row(i64 rb, int lane, int seq) {
  const i64 r = rb + (lane >> 2) + ((lane & 1) ? 8 : 0);
  return make_uint2((uint32_t)(r % seq), (uint32_t)(r / seq));
}

// The keep bits (keep_bits' layout) of elementwise site ``site`` for a
// warp's 16 rows, ``drawn`` the lane's drawn_row, against the kTiles * 8
// columns from c0.
template <int kTiles>
__device__ __forceinline__ uint32_t mlp_keep_bits(const Drop& drop,
                                                  uint32_t site, uint2 drawn,
                                                  int c0, int lane,
                                                  int width) {
  if (drop.threshold == 0u) return 0xffffffffu;
  return keep_bits_at<kTiles>(drop.seed, 3u + site, drawn.x, drawn.y, 0u, c0,
                              lane, width, drop.threshold);
}

// a = drop2(gelu(z + b1)) of a warpgroup warp's (16, 64) piece of z (rows
// wr.. of the block, ``drawn`` the lane's drawn_row; columns n0.., a
// multiple of 64 below f), rounded to bf16 into the block's scratch rows
// of a (rows f apart).
__device__ __forceinline__ void hidden_epilogue(const float (&z)[32],
                                                bf16* a0, const float* b1,
                                                uint2 drawn, int wr, int n0,
                                                int f, int lane,
                                                const Drop& drop) {
  const int gr = lane >> 2, t = lane & 3;
  // Every load before the first store, which the compiler cannot move
  // loads across.
  float2 bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    bias[j] = *reinterpret_cast<const float2*>(b1 + n0 + 8 * j + 2 * t);
  const uint32_t keep = mlp_keep_bits<8>(drop, 2u, drawn, n0, lane, f);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    const float bias0 = bias[j].x, bias1 = bias[j].y;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = 4 * j + 2 * h;
      float a_0 = gelu(z[at] + bias0), a_1 = gelu(z[at + 1] + bias1);
      if (drop.threshold != 0u) {
        a_0 = (keep >> at) & 1u ? a_0 * drop.inv_keep : 0.f;
        a_1 = (keep >> (at + 1)) & 1u ? a_1 * drop.inv_keep : 0.f;
      }
      *reinterpret_cast<uint32_t*>(a0 + (wr + gr + 8 * h) * f + col) =
          pack_bf16(a_0, a_1);
    }
  }
}

// y = x + drop3(o + b2) of a warpgroup warp's (16, 64) piece of o (rows
// rb.., absolute, ``drawn`` the lane's drawn_row; columns n0.., a multiple
// of 64 below d); rows from ``rows`` on are skipped.
__device__ __forceinline__ void mlp_output_epilogue(const float (&o)[32],
                                                    const bf16* x,
                                                    const float* b2, bf16* y,
                                                    i64 rb, uint2 drawn,
                                                    i64 rows, int n0, int d,
                                                    int lane,
                                                    const Drop& drop) {
  const int gr = lane >> 2, t = lane & 3;
  // Every load before the first store, which the compiler cannot move
  // loads across.
  float2 bias[8];
  __nv_bfloat162 xv[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    bias[j] = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const i64 r = rb + gr + 8 * h;
      xv[j][h] = r < rows ? *reinterpret_cast<const __nv_bfloat162*>(
                                x + r * d + col)
                          : __floats2bfloat162_rn(0.f, 0.f);
    }
  }
  const uint32_t keep = mlp_keep_bits<8>(drop, 3u, drawn, n0, lane, d);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const i64 r = rb + gr + 8 * h;
      if (r >= rows) continue;
      const int at = 4 * j + 2 * h;
      float o0 = o[at] + bias[j].x, o1 = o[at + 1] + bias[j].y;
      if (drop.threshold != 0u) {
        o0 = (keep >> at) & 1u ? o0 * drop.inv_keep : 0.f;
        o1 = (keep >> (at + 1)) & 1u ? o1 * drop.inv_keep : 0.f;
      }
      *reinterpret_cast<uint32_t*>(y + r * d + col) = pack_bf16(
          __low2float(xv[j][h]) + o0, __high2float(xv[j][h]) + o1);
    }
  }
}

// y = x + drop3(drop2(gelu(LN(x) W1^T + b1)) W2^T + b2), two blocks an SM
// (kMlpFwdBytes of shared memory, at most 128 registers a thread), so that
// one block's loads, barriers, LayerNorm and epilogues overlap the other's
// products. A block walks the 64-row tiles blockIdx.x, + gridDim.x, ...
// For each: h = LN(x) in shared memory as bf16; z = h W1^T on wgmma in
// passes of 128 columns of f, a warpgroup 64 of them, W1's chunks through a
// three-stage ring; each pass's epilogue (+ b1, GELU, site 2, bf16) writes
// a to the block's scratch rows of abuf (gridDim.x * 64, f), which only
// the block reads back and which stay in L2; o = a W2^T in passes of 128
// columns of d over a four-stage ring of a's and W2's chunks in h's and the
// first ring's place, each pass ending in + b2, site 3 and + x into y.
__global__ void __launch_bounds__(kThreads, 2)
mlp_fwd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                  const float* __restrict__ b1, const bf16* __restrict__ w2,
                  const float* __restrict__ b2, const float* __restrict__ g,
                  const float* __restrict__ be, bf16* abuf,
                  bf16* __restrict__ y, i64 rows, int seq, int d, int f,
                  float eps, Drop drop) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* hs = reinterpret_cast<bf16*>(aligned<1024>(tc_smem));
  bf16* ring = hs + kMlpRowsBytes / 2;   // z's ring; o's ring starts at hs
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2, wr = 16 * (warp & 3);
  const int kd = d / 64, kf = f / 64;
  const int nz = (f + kMlpPass - 1) / kMlpPass * kd;
  const int no = (d + kMlpPass - 1) / kMlpPass * kf;
  bf16* a0 = abuf + (i64)blockIdx.x * kBM * f;
  const i64 tiles = (rows + kBM - 1) / kBM;
  for (i64 tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const i64 r0 = tile * kBM;
    const int valid = (int)(rows - r0 < kBM ? rows - r0 : kBM);
    const uint2 drawn = drawn_row(r0 + wr, lane, seq);
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    auto issue_z = [&](int c, bf16* st) {
      const int p = c / kd * kMlpPass;
      stage_swizzled(st, w1 + (i64)p * d + (c % kd) * 64, d, kMlpPass, f - p);
    };
    ring_start<3, kMlpHStageElems>(ring, nz, issue_z);
    mlp_ln_rows(x + r0 * d, hs, nullptr, g, be, valid, d, eps);
    ring_steps<3, kMlpHStageElems>(
        ring, nz, issue_z, [&](int c, const bf16* st) {
          const int k = c % kd, n0 = c / kd * kMlpPass + 64 * wg;
          if (n0 < f)   // uniform in a warpgroup
            wgmma_chunk(acc, hs + k * kSwzChunk, st + 64 * wg * 64);
          if (k != kd - 1) return;
          if (n0 < f)
            hidden_epilogue(acc, a0, b1, drawn, wr, n0, f, lane, drop);
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        });
    // The block's rows of a, written above, are read back after the
    // barrier that ended the ring.
    run_ring<4, kMlpOStageElems>(
        hs, no,
        [&](int c, bf16* st) {
          const int p = c / kf * kMlpPass, k0 = (c % kf) * 64;
          stage_swizzled(st, a0 + k0, f, 64, 64);
          stage_swizzled(st + kSwzChunk, w2 + (i64)p * f + k0, f, kMlpPass,
                         d - p);
        },
        [&](int c, const bf16* st) {
          const int n0 = c / kf * kMlpPass + 64 * wg;
          if (n0 < d)
            wgmma_chunk(acc, st, st + kSwzChunk + 64 * wg * 64);
          if (c % kf != kf - 1) return;
          if (n0 < d)
            mlp_output_epilogue(acc, x, b2, y, r0 + wr, drawn, rows, n0, d,
                                lane, drop);
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        });
  }
}

// mma_chunk over one 64-deep chunk of operands in swz's layout: A [m][k]
// (one chunk); B [n][k] (one chunk of as many rows as it has) or, with
// BKRow, [k][n] (64 rows, chunks of 64 columns kSwzChunk apart).
template <int MT, int NT, bool BKRow>
__device__ __forceinline__ void mma_swz(const bf16* A, int m0, const bf16* B,
                                        int n0, int lane,
                                        float (&acc)[MT][NT][4]) {
  static_assert(NT % 2 == 0, "B fragments come two n-tiles at a time");
#pragma unroll
  for (int kk = 0; kk < 64; kk += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      ldsm_x4(A + swz(m0 + 16 * i + (lane & 15), kk + (lane >> 4) * 8,
                      kSwzChunk),
              a[i]);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      const int n = n0 + 8 * j;
      uint32_t b[4];
      if (BKRow)
        ldsm_x4_trans(B + swz(kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                              n + (lane >> 4) * 8, kSwzChunk),
                      b);
      else
        ldsm_x4(B + swz(n + (lane & 7) + ((lane >> 4) << 3),
                        kk + ((lane >> 3) & 1) * 8, kSwzChunk),
                b);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_bf16(acc[i][j], a[i], b[0], b[1]);
        mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
      }
    }
  }
}

// On a warp's (32, 8 NT) piece of z and dad (rows wr.. of the block, r0
// its first row's absolute index, ``drawn`` the lane's drawn_row of each
// 16; columns n0..): a = drop2(gelu(z + b1)), da =
// drop2's mask on dad, dz = da gelu'(z + b1), as mlp_bwd_kernel forms
// them; a and dz rounded to abbuf and dzbuf for the rows below ``valid``,
// whose f32 dz is added to cs[j][e] (column n0 + 8 j + 2 t + e).
template <int NT>
__device__ __forceinline__ void dz_epilogue(const float (&z)[2][NT][4],
                                            const float (&dad)[2][NT][4],
                                            const float* b1, bf16* abbuf,
                                            bf16* dzbuf, i64 r0, int wr,
                                            const uint2 (&drawn)[2],
                                            int valid, int n0, int f,
                                            int lane, const Drop& drop,
                                            float (&cs)[NT][2]) {
  const int gr = lane >> 2, t = lane & 3;
  // Every load before the first store, which the compiler cannot move
  // loads across.
  float2 biases[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    biases[j] = *reinterpret_cast<const float2*>(b1 + n0 + 8 * j + 2 * t);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rb = wr + 16 * i;
    const uint32_t keep = mlp_keep_bits<NT>(drop, 2u, drawn[i], n0, lane, f);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      const float bias[2] = {biases[j].x, biases[j].y};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rb + gr + 8 * h;
        if (row >= valid) continue;
        float a[2], dz[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float zz = z[i][j][2 * h + e] + bias[e];
          float da = dad[i][j][2 * h + e];
          a[e] = gelu(zz);
          if (drop.threshold != 0u) {
            const bool kept = (keep >> (4 * j + 2 * h + e)) & 1u;
            a[e] = kept ? a[e] * drop.inv_keep : 0.f;
            da = kept ? da * drop.inv_keep : 0.f;
          }
          dz[e] = da * dgelu(zz);
          cs[j][e] += dz[e];
        }
        const i64 at = (r0 + row) * f + col;
        *reinterpret_cast<uint32_t*>(abbuf + at) = pack_bf16(a[0], a[1]);
        *reinterpret_cast<uint32_t*>(dzbuf + at) = pack_bf16(dz[0], dz[1]);
      }
    }
  }
}

// The backward, two blocks an SM (kMlpBwdBytes of shared memory, at most
// 128 registers a thread), on mma.sync, in mlp_bwd_kernel's order of work.
// A block walks the 64-row tiles blockIdx.x, + gridDim.x, ... For each:
// h = LN(x) stays in shared memory as bf16, do goes to dobbuf (and db2's
// partial row); phase A walks f in chunks of 64 columns, each over d in
// 64-deep chunks of a ring (W1's [n][k], W2's [k][n] and do's [m][k], read
// back from dobbuf): z = h W1^T and dad = do W2, a warp 32 x 16 of each;
// then a, dz and db1's partial on the fragments, a and dz to abbuf and
// dzbuf; phase B: dh = dz W1 in passes of 128 columns over f, dz read back
// from dzbuf, a warp 32 x 32, in f32 to the block's scratch rows of dhbuf
// (gridDim.x * 64, d); then the LayerNorm backward, warp per row. What the
// block reads back it wrote itself, and stays in L2. parts: (tiles, 3 d +
// f) f32, a tile's row [db2 | dg | dbe | db1], each summed in a fixed
// order.
__global__ void __launch_bounds__(kThreads, 2)
mlp_bwd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                  const float* __restrict__ b1, const bf16* __restrict__ w2,
                  const float* __restrict__ g, const float* __restrict__ be,
                  const bf16* __restrict__ gy, bf16* hbuf, bf16* dobbuf,
                  bf16* abbuf, bf16* dzbuf, float* dhbuf,
                  bf16* __restrict__ dx, float* __restrict__ parts, i64 rows,
                  int seq, int d, int f, float eps, Drop drop) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  unsigned char* base = aligned<128>(tc_smem);
  bf16* hs = reinterpret_cast<bf16*>(base);
  bf16* ring = hs + kMlpRowsBytes / 2;   // phase A's; phase B's starts at hs
  float* rowbuf = reinterpret_cast<float*>(base);   // outside the phases
  float* colsum = reinterpret_cast<float*>(ring + 2 * kMlpStageElems);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3, gr = lane >> 2, t = lane & 3;
  const int kd = d / 64, kf = f / 64;
  float* dh0 = dhbuf + (i64)blockIdx.x * kBM * d;
  const i64 tiles = (rows + kBM - 1) / kBM;
  for (i64 tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const i64 r0 = tile * kBM;
    const int valid = (int)(rows - r0 < kBM ? rows - r0 : kBM);
    float* my_parts = parts + tile * (3 * d + f);
    const uint2 drawn[2] = {drawn_row(r0 + 32 * wm, lane, seq),
                            drawn_row(r0 + 32 * wm + 16, lane, seq)};

    {
      float sum[kPerLane];
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) sum[e] = 0.f;
      mlp_masked_rows(gy + r0 * d, dobbuf + r0 * d, r0, valid, seq, d, drop,
                      sum);
      block_col_sums(sum, d, rowbuf, my_parts);   // db2; ends with a barrier
    }
    mlp_ln_rows(x + r0 * d, hs, hbuf + r0 * d, g, be, valid, d, eps);
    // do's rows, written above, are read back after the ring's first
    // barrier.

    float z[2][2][4], dad[2][2][4];
    zero_frags(z);
    zero_frags(dad);
    run_ring<2, kMlpStageElems>(
        ring, kf * kd,
        [&](int c, bf16* st) {
          const int fc = c / kd * 64, k0 = (c % kd) * 64;
          stage_swizzled(st, w1 + (i64)fc * d + k0, d, 64, 64);
          stage_swizzled(st + kSwzChunk, w2 + (i64)k0 * f + fc, f, 64, 64);
          stage_swizzled(st + 2 * kSwzChunk, dobbuf + r0 * d + k0, d, 64,
                         valid);
        },
        [&](int c, const bf16* st) {
          const int fc = c / kd * 64, k = c % kd;
          mma_swz<2, 2, false>(hs + k * kSwzChunk, 32 * wm, st, 16 * wn,
                               lane, z);
          mma_swz<2, 2, true>(st + 2 * kSwzChunk, 32 * wm, st + kSwzChunk,
                              16 * wn, lane, dad);
          if (k != kd - 1) return;
          float cs[2][2] = {};
          dz_epilogue(z, dad, b1, abbuf, dzbuf, r0, 32 * wm, drawn, valid,
                      fc + 16 * wn, f, lane, drop, cs);
          // db1: the warp's 32 rows, then the block's two halves.
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
#pragma unroll
              for (int off = 4; off < 32; off <<= 1)
                cs[j][e] += __shfl_xor_sync(0xffffffffu, cs[j][e], off);
              if (lane < 4)
                colsum[wm * 64 + 16 * wn + 8 * j + 2 * t + e] = cs[j][e];
            }
          __syncthreads();
          const int col = threadIdx.x;
          if (col < 64)
            my_parts[3 * d + fc + col] = colsum[col] + colsum[64 + col];
          zero_frags(z);
          zero_frags(dad);
        });

    // dz's rows, written above, are read back after the ring's barrier.
    float acc[2][4][4];
    zero_frags(acc);
    run_ring<4, kMlpStageElems>(
        hs, (d + 127) / 128 * kf,
        [&](int c, bf16* st) {
          const int n0 = c / kf * 128, k0 = (c % kf) * 64;
          stage_swizzled(st, dzbuf + r0 * f + k0, f, 64, valid);
#pragma unroll
          for (int s = 0; s < 2; ++s)
            if (n0 + 64 * s < d)
              stage_swizzled(st + (1 + s) * kSwzChunk,
                             w1 + (i64)k0 * d + n0 + 64 * s, d, 64, 64);
        },
        [&](int c, const bf16* st) {
          const int n0 = c / kf * 128 + 32 * wn;
          if (n0 < d)
            mma_swz<2, 4, true>(st, 32 * wm, st + kSwzChunk, 32 * wn, lane,
                                acc);
          if (c % kf != kf - 1) return;
          if (n0 < d) {
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int row = 32 * wm + 16 * i + gr + 8 * h;
                  *reinterpret_cast<float2*>(dh0 + row * d + n0 + 8 * j +
                                             2 * t) =
                      make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
                }
          }
          zero_frags(acc);
        });

    // dh's rows, written above, are read back after the ring's barrier.
    float dg[kPerLane], dbe[kPerLane];
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) dg[e] = dbe[e] = 0.f;
    for (int i = warp; i < valid; i += kWarps) {
      float sc[kPerLane], xhat[kPerLane], gyv[kPerLane], dh[kPerLane];
      load_param(g, d, lane, sc);   // per row: fewer registers held

      row_values(x + r0 * d, i, d, lane, xhat);
      row_values(gy + r0 * d, i, d, lane, gyv);
#pragma unroll
      for (int c = 0; c < kGroups; ++c) {
        const int col = (32 * c + lane) * 4;
        const float4 v =
            col < d ? *reinterpret_cast<const float4*>(dh0 + i * d + col)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
        dh[4 * c] = v.x;
        dh[4 * c + 1] = v.y;
        dh[4 * c + 2] = v.z;
        dh[4 * c + 3] = v.w;
      }
      ln_bwd_values(xhat, gyv, dh, sc, d, lane, eps, dg, dbe);
#pragma unroll
      for (int c = 0; c < kGroups; ++c) {
        const int col = (32 * c + lane) * 4;
        if (col < d)
          *reinterpret_cast<uint2*>(dx + (r0 + i) * d + col) =
              pack4(dh + 4 * c);
      }
    }
    block_col_sums(dg, d, rowbuf, my_parts + d);
    block_col_sums(dbe, d, rowbuf, my_parts + 2 * d);
  }
}

// ---------------------------------------------------------------------------
// The second pass: weight gradients and the sums of the partial rows
// ---------------------------------------------------------------------------

// C(m, n) = sum over the block's rows r of A[r, m] B[r, n]; A (rows, M) and
// B (rows, N) row-major with row strides lda, ldb. grid (N tiles, M tiles,
// splits): split s owns rows [s * per, (s + 1) * per). With one split the
// tile goes to c (element strides scm, scn); otherwise to partial
// (splits, M, N), which sum_partials_kernel adds up.
template <typename T>
__global__ void __launch_bounds__(kThreads)
grad_weight_kernel(const T* A, i64 lda, const T* B, i64 ldb, float* c,
                   i64 scm, i64 scn, float* partial, int M, int N, i64 rows,
                   i64 per) {
  __shared__ __align__(128) float stage[kStageFloats];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const i64 first = (i64)blockIdx.z * per;
  i64 count = rows - first;
  if (count > per) count = per;
  float acc[4][4];
  zero_acc(acc);
  if (count > 0)
    gemm_tile<T, T>(A + first * lda + m0, 1, lda, M - m0 < kBM ? M - m0 : kBM,
                    B + first * ldb + n0, ldb, 1, N - n0 < kBN ? N - n0 : kBN,
                    (int)count, acc, stage, stage + kBK * kLd);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m >= M || n >= N) continue;
      if (gridDim.z == 1) c[m * scm + n * scn] = acc[i][j];
      else partial[((i64)blockIdx.z * M + m) * N + n] = acc[i][j];
    }
}

__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partial, int splits, int M,
                    int N, float* __restrict__ c, i64 scm, i64 scn) {
  const i64 idx = (i64)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (i64)M * N) return;
  float total = 0.f;
  for (int s = 0; s < splits; ++s) total += partial[(i64)s * M * N + idx];
  c[(idx / N) * scm + (idx % N) * scn] = total;
}

// out[col] = sum over p of parts[p, col], in a fixed order; a block of
// (32, 32) threads owns 32 columns.
__global__ void __launch_bounds__(1024)
sum_rows_kernel(const float* __restrict__ parts, int nparts, int width,
                float* __restrict__ out) {
  __shared__ float tile[32][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (col < width)
    for (int p = threadIdx.y; p < nparts; p += 32)
      acc += parts[(i64)p * width + col];
  tile[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && col < width) {
    float total = 0.f;
#pragma unroll
    for (int r = 0; r < 32; ++r) total += tile[r][threadIdx.x];
    out[col] = total;
  }
}

// The weight-gradient product on the tensor cores (bf16 operands whose rows
// take 16-byte groups): C (M x N) = A^T B over the rows of a split, A
// (rows, M) and B (rows, N) row-major. A block owns a 128 x 128 tile of C,
// a warp 64 x 32 of it; the rows stream 32 at a time through a ring of four
// cp.async stages, both operands [k][.] and read transposed by ldmatrix.
// Partials are written and summed as grad_weight_kernel's.
constexpr int kGwTile = 128;
constexpr int kGwDepth = 32;
constexpr int kGwPitch = kGwTile + 8;
constexpr int kGwStages = 4;
constexpr int kGwStageElems = 2 * kGwDepth * kGwPitch;
constexpr int kGwBytes = kGwStages * kGwStageElems * 2;
static_assert(kBK == kGwDepth, "a split starts on a chunk of the ring");

__global__ void __launch_bounds__(kThreads)
grad_weight_tc_kernel(const bf16* A, i64 lda, const bf16* B, i64 ldb,
                      float* c, i64 scm, i64 scn, float* partial, int M,
                      int N, i64 rows, i64 per) {
  extern __shared__ __align__(128) unsigned char gw_smem[];
  bf16* ring = reinterpret_cast<bf16*>(gw_smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = 64 * (warp >> 2), wn = 32 * (warp & 3);
  const int n0 = blockIdx.x * kGwTile, m0 = blockIdx.y * kGwTile;
  const i64 first = (i64)blockIdx.z * per;
  i64 count = rows - first;
  if (count > per) count = per;
  const int chunks = count > 0 ? (int)((count + kGwDepth - 1) / kGwDepth) : 0;
  float acc[4][4][4];
  zero_frags(acc);
  run_ring<kGwStages, kGwStageElems>(
      ring, chunks,
      [&](int k, bf16* st) {
        const i64 r = first + (i64)k * kGwDepth;
        const i64 left = count - (i64)k * kGwDepth;
        const int valid = left < kGwDepth ? (int)left : kGwDepth;
        stage_chunk<16>(st, kGwPitch, A + r * lda + m0, lda, kGwDepth, valid,
                        (M - m0) / 8);
        stage_chunk<16>(st + kGwDepth * kGwPitch, kGwPitch, B + r * ldb + n0,
                        ldb, kGwDepth, valid, (N - n0) / 8);
      },
      [&](int, const bf16* st) {
        mma_chunk<kGwDepth, 4, 4, true, true>(st, kGwPitch, wm,
                                              st + kGwDepth * kGwPitch,
                                              kGwPitch, wn, lane, acc);
      });
  const int gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + 16 * i + gr + 8 * (e >> 1);
        const int n = n0 + wn + 8 * j + 2 * t + (e & 1);
        if (m >= M || n >= N) continue;
        if (gridDim.z == 1) c[m * scm + n * scn] = acc[i][j][e];
        else partial[((i64)blockIdx.z * M + m) * N + n] = acc[i][j][e];
      }
}

inline int splits_for(i64 rows) {
  const i64 want = rows / 2048;
  return (int)(want < 1 ? 1 : want > kMaxSplits ? kMaxSplits : want);
}

// dW (M x N, element strides scm, scn) = A^T B over ``rows`` rows.
template <typename T>
int launch_grad_weight(const void* A, i64 lda, const void* B, i64 ldb,
                       void* c, i64 scm, i64 scn, float* partial, int M,
                       int N, i64 rows, cudaStream_t s) {
  const int splits = splits_for(rows);
  // A multiple of the staged depth, so that every split starts on a
  // 16-byte boundary of its operands.
  const i64 per = ((rows + splits - 1) / splits + kBK - 1) / kBK * kBK;
  bool tc = false;
  if constexpr (std::is_same<T, bf16>::value)
    tc = lda % 8 == 0 && ldb % 8 == 0 && M % 8 == 0 && N % 8 == 0 &&
         (reinterpret_cast<uintptr_t>(A) & 15u) == 0 &&
         (reinterpret_cast<uintptr_t>(B) & 15u) == 0;
  if (tc) {
    cudaError_t set = cudaFuncSetAttribute(
        grad_weight_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kGwBytes);
    if (set != cudaSuccess) return (int)set;
    const dim3 grid((N + kGwTile - 1) / kGwTile, (M + kGwTile - 1) / kGwTile,
                    splits);
    grad_weight_tc_kernel<<<grid, kThreads, kGwBytes, s>>>(
        static_cast<const bf16*>(A), lda, static_cast<const bf16*>(B), ldb,
        static_cast<float*>(c), scm, scn, partial, M, N, rows, per);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
    grad_weight_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(A), lda, static_cast<const T*>(B), ldb,
        static_cast<float*>(c), scm, scn, partial, M, N, rows, per);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const i64 cells = (i64)M * N;
  sum_partials_kernel<<<(unsigned)((cells + kThreads - 1) / kThreads),
                        kThreads, 0, s>>>(partial, splits, M, N,
                                          static_cast<float*>(c), scm, scn);
  return (int)cudaGetLastError();
}

int launch_sum_rows(const float* parts, int nparts, int width, float* out,
                    cudaStream_t s) {
  sum_rows_kernel<<<(width + 31) / 32, dim3(32, 32), 0, s>>>(parts, nparts,
                                                             width, out);
  return (int)cudaGetLastError();
}

template <typename K>
int allow_shared(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

bool bad_attn(i64 batch, int seq, int d, int heads, int head_dim) {
  return batch < 1 || batch > 0x7fffffffLL || seq < 1 || seq > kBM || d < 1 ||
         d > kMaxD || heads < 1 || head_dim < 1 || head_dim > kMaxHeadDim;
}

bool bad_mlp(i64 rows, int seq, int d, int f) {
  return rows < 1 || (rows + kBM - 1) / kBM > 0x7fffffffLL || seq < 1 ||
         d < 1 || d > kMaxD || f < 1;
}

template <typename T>
Weight<T> weight(const void* p, i64 s_in, i64 s_out) {
  return Weight<T>{static_cast<const T*>(p), s_in, s_out};
}

template <typename T>
int run_mlp_fwd(const void* x, const void* w1, const i64* s1, const void* b1,
                const void* w2, const i64* s2, const void* b2, const void* g,
                const void* be, void* hbuf, void* y, i64 rows, int seq, int d,
                int f, float eps, Drop drop, cudaStream_t s) {
  const int bytes = mlp_shared_floats(d) * (int)sizeof(float);
  int err = allow_shared(mlp_fwd_kernel<T>, bytes);
  if (err != 0) return err;
  const unsigned blocks = (unsigned)((rows + kBM - 1) / kBM);
  mlp_fwd_kernel<T><<<blocks, kThreads, bytes, s>>>(
      static_cast<const T*>(x), weight<T>(w1, s1[0], s1[1]),
      static_cast<const float*>(b1), weight<T>(w2, s2[0], s2[1]),
      static_cast<const float*>(b2), static_cast<const float*>(g),
      static_cast<const float*>(be), static_cast<T*>(hbuf),
      static_cast<T*>(y), rows, seq, d, f, eps, drop);
  return (int)cudaGetLastError();
}

// The MLP backward's second pass, after its kernel: the sums of the
// partial rows into small, dW1 (d, f) = h^T dz and dW2 (f, d) = a^T do.
template <typename T>
int mlp_bwd_sums(const void* hbuf, const void* dobbuf, const void* abbuf,
                 const void* dzbuf, void* dw1, const i64* sd1, void* dw2,
                 const i64* sd2, void* small, float* work, i64 rows, int d,
                 int f, cudaStream_t s) {
  const int blocks = (int)((rows + kBM - 1) / kBM);
  const int width = 3 * d + f;
  float* partial = work + (i64)blocks * width;
  int err = launch_sum_rows(work, blocks, width, static_cast<float*>(small),
                            s);
  if (err != 0) return err;
  err = launch_grad_weight<T>(hbuf, d, dzbuf, f, dw1, sd1[0], sd1[1], partial,
                              d, f, rows, s);
  if (err != 0) return err;
  return launch_grad_weight<T>(abbuf, f, dobbuf, d, dw2, sd2[0], sd2[1],
                               partial, f, d, rows, s);
}

template <typename T>
int run_mlp_bwd(const void* x, const void* w1, const i64* s1, const void* b1,
                const void* w2, const i64* s2, const void* g, const void* be,
                const void* gy, void* hbuf, void* dobbuf, void* abbuf,
                void* dzbuf, void* dx, void* dw1, const i64* sd1, void* dw2,
                const i64* sd2, void* small, float* work, i64 rows, int seq,
                int d, int f, float eps, Drop drop, cudaStream_t s) {
  const int bytes = mlp_shared_floats(d) * (int)sizeof(float);
  int err = allow_shared(mlp_bwd_kernel<T>, bytes);
  if (err != 0) return err;
  const int blocks = (int)((rows + kBM - 1) / kBM);
  mlp_bwd_kernel<T><<<blocks, kThreads, bytes, s>>>(
      static_cast<const T*>(x), weight<T>(w1, s1[0], s1[1]),
      static_cast<const float*>(b1), weight<T>(w2, s2[0], s2[1]),
      static_cast<const float*>(g), static_cast<const float*>(be),
      static_cast<const T*>(gy), static_cast<T*>(hbuf),
      static_cast<T*>(dobbuf), static_cast<T*>(abbuf), static_cast<T*>(dzbuf),
      static_cast<T*>(dx), work, rows, seq, d, f, eps, drop);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return mlp_bwd_sums<T>(hbuf, dobbuf, abbuf, dzbuf, dw1, sd1, dw2, sd2,
                         small, work, rows, d, f, s);
}

template <typename T>
int run_attn_fwd(const void* x, const void* const* w, const i64* strides,
                 const void* bo, const void* g, const void* be, void* hbuf,
                 void* y, int batch, int seq, int d, int heads, int head_dim,
                 float scale, float eps, Drop drop, cudaStream_t s) {
  const int bytes = attn_fwd_shared_floats(d) * (int)sizeof(float);
  int err = allow_shared(attn_fwd_kernel<T>, bytes);
  if (err != 0) return err;
  attn_fwd_kernel<T><<<batch, kThreads, bytes, s>>>(
      static_cast<const T*>(x), weight<T>(w[0], strides[0], strides[1]),
      weight<T>(w[1], strides[2], strides[3]),
      weight<T>(w[2], strides[4], strides[5]),
      weight<T>(w[3], strides[6], strides[7]), static_cast<const float*>(bo),
      static_cast<const float*>(g), static_cast<const float*>(be),
      static_cast<T*>(hbuf), static_cast<T*>(y), seq, d, heads, head_dim,
      scale, eps, drop);
  return (int)cudaGetLastError();
}

template <typename T>
int run_attn_bwd(const void* x, const void* const* w, const i64* strides,
                 const void* g, const void* be, const void* gy, void* hbuf,
                 void* dobbuf, void* a2buf, void* dqkv, void* dx, void* dwo,
                 const i64* sdo, void* small, float* work, int batch, int seq,
                 int d, int heads, int head_dim, float scale, float eps,
                 Drop drop, cudaStream_t s) {
  const int bytes = attn_bwd_shared_floats(d) * (int)sizeof(float);
  int err = allow_shared(attn_bwd_kernel<T>, bytes);
  if (err != 0) return err;
  const int inner = heads * head_dim;
  const i64 rows = (i64)batch * seq;
  float* parts = work;
  float* partial = work + (i64)batch * 3 * d;
  attn_bwd_kernel<T><<<batch, kThreads, bytes, s>>>(
      static_cast<const T*>(x), weight<T>(w[0], strides[0], strides[1]),
      weight<T>(w[1], strides[2], strides[3]),
      weight<T>(w[2], strides[4], strides[5]),
      weight<T>(w[3], strides[6], strides[7]), static_cast<const float*>(g),
      static_cast<const float*>(be), static_cast<const T*>(gy),
      static_cast<T*>(hbuf), static_cast<T*>(dobbuf), static_cast<T*>(a2buf),
      static_cast<T*>(dqkv), static_cast<T*>(dx), parts, seq, d, heads,
      head_dim, scale, eps, drop);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = launch_sum_rows(parts, batch, 3 * d, static_cast<float*>(small), s);
  if (err != 0) return err;
  // dWo (inner, d) = a2^T do
  return launch_grad_weight<T>(a2buf, inner, dobbuf, d, dwo, sdo[0], sdo[1],
                               partial, inner, d, rows, s);
}

// What the tc variant takes beyond bad_attn: heads of 64, d a multiple of
// 64 (up to 512), the bf16 dtype (checked by the entries).
bool bad_tc(int d, int head_dim) {
  return head_dim != kTcHead || d % kTcChunk != 0;
}

// scale * log2(e) for the softmax's exp2f: scale = 1 / sqrt(64).
constexpr float kTcScaleLog2 = 0.125f * 1.4426950408889634f;

int run_attn_tc_fwd(const void* x, const void* const* w, const void* bo,
                    const void* g, const void* be, void* hbuf, void* abuf,
                    void* y, int batch, int seq, int d, int heads, int slots,
                    float eps, Drop drop, cudaStream_t s) {
  int err = allow_shared(attn_fwd_tc_kernel, kTcFwdBytes);
  if (err != 0) return err;
  attn_fwd_tc_kernel<<<slots, kThreads, kTcFwdBytes, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w[0]),
      static_cast<const bf16*>(w[1]), static_cast<const bf16*>(w[2]),
      static_cast<const bf16*>(w[3]), static_cast<const float*>(bo),
      static_cast<const float*>(g), static_cast<const float*>(be),
      static_cast<bf16*>(hbuf), static_cast<bf16*>(abuf),
      static_cast<bf16*>(y), batch, seq, d, heads, kTcScaleLog2, eps, drop);
  return (int)cudaGetLastError();
}

int run_attn_tc_bwd(const void* x, const void* const* w, const void* g,
                    const void* be, const void* gy, void* hbuf, void* dobbuf,
                    void* a2buf, void* dqkv, void* dx, void* dwo,
                    const i64* sdo, void* small, float* work, int batch,
                    int seq, int d, int heads, float eps, Drop drop,
                    cudaStream_t s) {
  int err = allow_shared(attn_bwd_tc_kernel, kTcSmem);
  if (err != 0) return err;
  const int inner = heads * kTcHead;
  const i64 rows = (i64)batch * seq;
  float* parts = work;
  float* partial = work + (i64)batch * 3 * d;
  attn_bwd_tc_kernel<<<batch, kThreads, kTcSmem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w[0]),
      static_cast<const bf16*>(w[1]), static_cast<const bf16*>(w[2]),
      static_cast<const bf16*>(w[3]), static_cast<const float*>(g),
      static_cast<const float*>(be), static_cast<const bf16*>(gy),
      static_cast<bf16*>(hbuf), static_cast<bf16*>(dobbuf),
      static_cast<bf16*>(a2buf), static_cast<bf16*>(dqkv),
      static_cast<bf16*>(dx), parts, seq, d, heads, kTcScaleLog2, eps, drop);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = launch_sum_rows(parts, batch, 3 * d, static_cast<float*>(small), s);
  if (err != 0) return err;
  // dWo (inner, d) = a2^T do
  return launch_grad_weight<bf16>(a2buf, inner, dobbuf, d, dwo, sdo[0],
                                  sdo[1], partial, inner, d, rows, s);
}

// What the MLP's tc variant takes beyond bad_mlp: d and f multiples of
// 64 (the bf16 dtype is checked by the entries).
bool bad_mlp_tc(int d, int f) { return d % 64 != 0 || f % 64 != 0; }

int run_mlp_tc_fwd(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* g,
                   const void* be, void* abuf, void* y, i64 rows, int seq,
                   int d, int f, int slots, float eps, Drop drop,
                   cudaStream_t s) {
  int err = allow_shared(mlp_fwd_tc_kernel, kMlpFwdBytes);
  if (err != 0) return err;
  mlp_fwd_tc_kernel<<<slots, kThreads, kMlpFwdBytes, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(g),
      static_cast<const float*>(be), static_cast<bf16*>(abuf),
      static_cast<bf16*>(y), rows, seq, d, f, eps, drop);
  return (int)cudaGetLastError();
}

int run_mlp_tc_bwd(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* g, const void* be,
                   const void* gy, void* hbuf, void* dobbuf, void* abbuf,
                   void* dzbuf, void* dhbuf, void* dx, void* dw1,
                   const i64* sd1, void* dw2, const i64* sd2, void* small,
                   float* work, i64 rows, int seq, int d, int f, int slots,
                   float eps, Drop drop, cudaStream_t s) {
  int err = allow_shared(mlp_bwd_tc_kernel, kMlpBwdBytes);
  if (err != 0) return err;
  mlp_bwd_tc_kernel<<<slots, kThreads, kMlpBwdBytes, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(g), static_cast<const float*>(be),
      static_cast<const bf16*>(gy), static_cast<bf16*>(hbuf),
      static_cast<bf16*>(dobbuf), static_cast<bf16*>(abbuf),
      static_cast<bf16*>(dzbuf), static_cast<float*>(dhbuf),
      static_cast<bf16*>(dx), work, rows, seq, d, f, eps, drop);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return mlp_bwd_sums<bf16>(hbuf, dobbuf, abbuf, dzbuf, dw1, sd1, dw2, sd2,
                            small, work, rows, d, f, s);
}

}  // namespace

// Conventions of every entry: dtype 0 = float32, 1 = bfloat16 for x, y, gy,
// dx, the weights and the scratch buffers; biases, LayerNorm parameters and
// every parameter gradient are float32. x, y, gy, dx and the scratch buffers
// are contiguous; a weight is given as a pointer and two element strides
// (s_in, s_out) of its (in, out) view. ``threshold`` is the u32 dropout
// cutoff (0 turns dropout off), ``inv_keep`` 1 / (1 - rate). Launches go to
// ``stream`` and do not synchronise. Returns the first CUDA error, 0 for
// none, cudaErrorInvalidValue for a shape or dtype the kernels do not take
// (T > 64, D > 512, a head wider than 64).

// Floats of f32 workspace that mlp_block_bwd needs.
extern "C" long long mlp_block_bwd_workspace(long long rows, int d, int f) {
  if (rows < 1) return 0;
  const long long blocks = (rows + kBM - 1) / kBM;
  const int splits = splits_for(rows);
  return blocks * (3LL * d + f) + (splits > 1 ? (long long)splits * d * f : 0);
}

// Floats of f32 workspace that attn_block_bwd needs.
extern "C" long long attn_block_bwd_workspace(long long batch, int seq, int d,
                                              int inner) {
  if (batch < 1) return 0;
  const int splits = splits_for(batch * seq);
  return batch * 3LL * d + (splits > 1 ? (long long)splits * inner * d : 0);
}

// y = x + drop3(drop2(gelu(LN(x) W1 + b1)) W2 + b2) over x (rows, d), rows =
// B * seq; hbuf: (rows, d) scratch.
extern "C" int mlp_block_fwd(const void* x, const void* w1, long long s1_in,
                             long long s1_out, const void* b1, const void* w2,
                             long long s2_in, long long s2_out, const void* b2,
                             const void* g, const void* be, void* hbuf,
                             void* y, long long rows, int seq, int d, int f,
                             float eps, int dtype, unsigned int seed,
                             unsigned int threshold, float inv_keep,
                             void* stream) {
  if (bad_mlp(rows, seq, d, f)) return (int)cudaErrorInvalidValue;
  const i64 s1[2] = {s1_in, s1_out}, s2[2] = {s2_in, s2_out};
  const Drop drop{seed, threshold, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_mlp_fwd<float>(x, w1, s1, b1, w2, s2, b2, g, be, hbuf, y, rows,
                              seq, d, f, eps, drop, s);
  if (dtype == 1)
    return run_mlp_fwd<__nv_bfloat16>(x, w1, s1, b1, w2, s2, b2, g, be, hbuf,
                                      y, rows, seq, d, f, eps, drop, s);
  return (int)cudaErrorInvalidValue;
}

// The MLP backward: dx, dW1 (strides sd1), dW2 (strides sd2) and small =
// [db2 (d) | dLN scale (d) | dLN bias (d) | db1 (f)]. hbuf, dobbuf: (rows, d)
// scratch; abbuf, dzbuf: (rows, f) scratch; work: mlp_block_bwd_workspace
// floats.
extern "C" int mlp_block_bwd(
    const void* x, const void* w1, long long s1_in, long long s1_out,
    const void* b1, const void* w2, long long s2_in, long long s2_out,
    const void* g, const void* be, const void* gy, void* hbuf, void* dobbuf,
    void* abbuf, void* dzbuf, void* dx, void* dw1, long long sd1_in,
    long long sd1_out, void* dw2, long long sd2_in, long long sd2_out,
    void* small, void* work, long long rows, int seq, int d, int f, float eps,
    int dtype, unsigned int seed, unsigned int threshold, float inv_keep,
    void* stream) {
  if (bad_mlp(rows, seq, d, f)) return (int)cudaErrorInvalidValue;
  const i64 s1[2] = {s1_in, s1_out}, s2[2] = {s2_in, s2_out};
  const i64 sd1[2] = {sd1_in, sd1_out}, sd2[2] = {sd2_in, sd2_out};
  const Drop drop{seed, threshold, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  if (dtype == 0)
    return run_mlp_bwd<float>(x, w1, s1, b1, w2, s2, g, be, gy, hbuf, dobbuf,
                              abbuf, dzbuf, dx, dw1, sd1, dw2, sd2, small, w,
                              rows, seq, d, f, eps, drop, s);
  if (dtype == 1)
    return run_mlp_bwd<__nv_bfloat16>(x, w1, s1, b1, w2, s2, g, be, gy, hbuf,
                                      dobbuf, abbuf, dzbuf, dx, dw1, sd1, dw2,
                                      sd2, small, w, rows, seq, d, f, eps,
                                      drop, s);
  return (int)cudaErrorInvalidValue;
}

// y = x + drop1(MHSA_drop0(LN(x) Wq, LN(x) Wk, LN(x) Wv) Wo + bo) over x
// (batch, seq, d). weights: the four pointers wq, wk, wv, wo; strides: their
// eight element strides (in, out each). hbuf: (batch * seq, d) scratch.
extern "C" int attn_block_fwd(const void* x, const void* const* weights,
                              const long long* strides, const void* bo,
                              const void* g, const void* be, void* hbuf,
                              void* y, int batch, int seq, int d, int heads,
                              int head_dim, float scale, float eps, int dtype,
                              unsigned int seed, unsigned int threshold,
                              float inv_keep, void* stream) {
  if (bad_attn(batch, seq, d, heads, head_dim))
    return (int)cudaErrorInvalidValue;
  const Drop drop{seed, threshold, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_attn_fwd<float>(x, weights, strides, bo, g, be, hbuf, y, batch,
                               seq, d, heads, head_dim, scale, eps, drop, s);
  if (dtype == 1)
    return run_attn_fwd<__nv_bfloat16>(x, weights, strides, bo, g, be, hbuf, y,
                                       batch, seq, d, heads, head_dim, scale,
                                       eps, drop, s);
  return (int)cudaErrorInvalidValue;
}

// The attention backward: dx, dWo (strides sdo_in, sdo_out), small = [dbo |
// dLN scale | dLN bias] (3 d), and the emitted h (hbuf) and dqkv (batch * seq,
// 3 * heads * head_dim) whose product the caller takes for dWq, dWk, dWv.
// dobbuf: (batch * seq, d) scratch; a2buf: (batch * seq, inner) scratch;
// work: attn_block_bwd_workspace floats.
extern "C" int attn_block_bwd(
    const void* x, const void* const* weights, const long long* strides,
    const void* g, const void* be, const void* gy, void* hbuf, void* dobbuf,
    void* a2buf, void* dqkv, void* dx, void* dwo, long long sdo_in,
    long long sdo_out, void* small, void* work, int batch, int seq, int d,
    int heads, int head_dim, float scale, float eps, int dtype,
    unsigned int seed, unsigned int threshold, float inv_keep, void* stream) {
  if (bad_attn(batch, seq, d, heads, head_dim))
    return (int)cudaErrorInvalidValue;
  const i64 sdo[2] = {sdo_in, sdo_out};
  const Drop drop{seed, threshold, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  if (dtype == 0)
    return run_attn_bwd<float>(x, weights, strides, g, be, gy, hbuf, dobbuf,
                               a2buf, dqkv, dx, dwo, sdo, small, w, batch, seq,
                               d, heads, head_dim, scale, eps, drop, s);
  if (dtype == 1)
    return run_attn_bwd<__nv_bfloat16>(x, weights, strides, g, be, gy, hbuf,
                                       dobbuf, a2buf, dqkv, dx, dwo, sdo,
                                       small, w, batch, seq, d, heads,
                                       head_dim, scale, eps, drop, s);
  return (int)cudaErrorInvalidValue;
}

// The tc variant of attn_block_fwd: bfloat16 only (dtype 1), heads of 64,
// d a multiple of 64 up to 512, seq <= 64; scale 1 / 8. weights: wq, wk, wv
// (heads * 64, d) and wo (d, heads * 64), each contiguous as stored (out,
// in). hbuf: (batch * seq, d) scratch; abuf: (slots * 64, heads * 64)
// scratch; ``slots`` blocks (1 to batch) walk the frames.
extern "C" int attn_block_tc_fwd(const void* x, const void* const* weights,
                                 const void* bo, const void* g,
                                 const void* be, void* hbuf, void* abuf,
                                 void* y,
                                 int batch, int seq, int d, int heads,
                                 int slots, float eps, int dtype,
                                 unsigned int seed, unsigned int threshold,
                                 float inv_keep, void* stream) {
  if (bad_attn(batch, seq, d, heads, kTcHead) || bad_tc(d, kTcHead) ||
      dtype != 1 || slots < 1 || slots > batch)
    return (int)cudaErrorInvalidValue;
  return run_attn_tc_fwd(x, weights, bo, g, be, hbuf, abuf, y, batch, seq, d,
                         heads, slots, eps, Drop{seed, threshold, inv_keep},
                         static_cast<cudaStream_t>(stream));
}

// The tc variant of attn_block_bwd, under the conditions of
// attn_block_tc_fwd, the weights given as there; the other arguments as
// attn_block_bwd's.
extern "C" int attn_block_tc_bwd(
    const void* x, const void* const* weights, const void* g, const void* be,
    const void* gy, void* hbuf, void* dobbuf, void* a2buf, void* dqkv,
    void* dx, void* dwo, long long sdo_in, long long sdo_out, void* small,
    void* work, int batch, int seq, int d, int heads, float eps, int dtype,
    unsigned int seed, unsigned int threshold, float inv_keep, void* stream) {
  if (bad_attn(batch, seq, d, heads, kTcHead) || bad_tc(d, kTcHead) ||
      dtype != 1)
    return (int)cudaErrorInvalidValue;
  const i64 sdo[2] = {sdo_in, sdo_out};
  return run_attn_tc_bwd(x, weights, g, be, gy, hbuf, dobbuf, a2buf, dqkv, dx,
                         dwo, sdo, small, static_cast<float*>(work), batch,
                         seq, d, heads, eps, Drop{seed, threshold, inv_keep},
                         static_cast<cudaStream_t>(stream));
}

// The tc variant of mlp_block_fwd: bfloat16 only (dtype 1), d and f
// multiples of 64, d up to 512. w1 (f, d) and w2 (d, f), each
// contiguous as stored (out, in). abuf: (slots * 64, f) scratch; ``slots``
// blocks (1 to the number of 64-row tiles) walk the tiles.
extern "C" int mlp_block_tc_fwd(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2,
                                const void* g, const void* be, void* abuf,
                                void* y, long long rows, int seq, int d,
                                int f, int slots, float eps, int dtype,
                                unsigned int seed, unsigned int threshold,
                                float inv_keep, void* stream) {
  if (bad_mlp(rows, seq, d, f) || bad_mlp_tc(d, f) || dtype != 1 ||
      slots < 1 || slots > (rows + kBM - 1) / kBM)
    return (int)cudaErrorInvalidValue;
  return run_mlp_tc_fwd(x, w1, b1, w2, b2, g, be, abuf, y, rows, seq, d, f,
                        slots, eps, Drop{seed, threshold, inv_keep},
                        static_cast<cudaStream_t>(stream));
}

// The tc variant of mlp_block_bwd, under the conditions of
// mlp_block_tc_fwd, the weights given as there; dhbuf: (slots * 64, d)
// f32 scratch, ``slots`` as for mlp_block_tc_fwd; the other arguments as
// mlp_block_bwd's.
extern "C" int mlp_block_tc_bwd(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* g, const void* be, const void* gy, void* hbuf, void* dobbuf,
    void* abbuf, void* dzbuf, void* dhbuf, void* dx, void* dw1,
    long long sd1_in, long long sd1_out, void* dw2, long long sd2_in,
    long long sd2_out, void* small, void* work, long long rows, int seq,
    int d, int f, int slots, float eps, int dtype, unsigned int seed,
    unsigned int threshold, float inv_keep, void* stream) {
  if (bad_mlp(rows, seq, d, f) || bad_mlp_tc(d, f) || dtype != 1 ||
      slots < 1 || slots > (rows + kBM - 1) / kBM)
    return (int)cudaErrorInvalidValue;
  const i64 sd1[2] = {sd1_in, sd1_out}, sd2[2] = {sd2_in, sd2_out};
  return run_mlp_tc_bwd(x, w1, b1, w2, g, be, gy, hbuf, dobbuf, abbuf, dzbuf,
                        dhbuf, dx, dw1, sd1, dw2, sd2, small,
                        static_cast<float*>(work), rows, seq, d, f, slots,
                        eps, Drop{seed, threshold, inv_keep},
                        static_cast<cudaStream_t>(stream));
}
