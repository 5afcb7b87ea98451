// Flash attention for the decoder: the forward, the dQ and the dK/dV
// kernels, with the mask computed from indices and dropout on the attention
// weights inside the kernels, for Hopper (sm_90a).
//
// Replaces the TPU kernels videocad_tpu/ops/attention.py:_flash_kernel
// (flash_attention -> _flash_forward -> pl.pallas_call), :_dq_kernel and
// :_dkv_kernel (_flash_backward -> pl.pallas_call, twice). They compute:
//   out = dropout(softmax(q k^T / sqrt(D), mask)) v, q (B, T, H, D) and
//   k, v (B, S, H, D); key tiles stream through the running (max m,
//   denominator l) recurrence, a masked score being -1e30; dropout
//   multiplies the unnormalised weights p by keep / (1 - rate) while l sums
//   the undropped p; out = acc / l and the row's logsumexp lse = m + log(l)
//   are all the forward leaves behind.
//   Backward: w = mask ? exp(s - lse) : 0, dw = (g v^T) * drop,
//   delta = rowsum(g * out), ds = w * (dw - delta), dq = ds k / sqrt(D),
//   dk = ds^T q / sqrt(D), dv = (w * drop)^T g.
// A query row whose mask admits no key is out of contract: its output is
// undefined here as on the TPU.
//
// What differs from the TPU version, and why. There the heads are folded
// by a transpose, T and S padded to block multiples and the mask shipped
// as an int8 (T, S) tensor, each an XLA fusion; in eager PyTorch each
// would be a copy kernel. Here a block reads its head's D columns out of
// the (B, T, H, D) tensors by strides, the tails of T and S are predicated
// (rows beyond T are computed on zeros and never stored, keys beyond S
// count as masked), and the two masks the model builds arrive as a mode
// and a window: the kernel computes col <= row && col > row - window
// itself and visits only the tiles that hold an admitted pair (with a
// window of 10, a block of 16 or 32 rows touches two or three key tiles of
// 32, not six).
// Skipping a tile equals masking it: a wholly masked first tile gives
// p = exp(0) = 1 that the next tile's alpha = exp(-1e30 - m) = 0 wipes
// out, and an admitted pair always exists in contract. An arbitrary (T, S)
// byte mask is read as it is, every tile visited. delta, which XLA fuses
// outside the TPU kernels, is computed by the dQ kernel (each block owns
// its rows' g and out) and handed to the dK/dV kernel through a (B, H, T)
// buffer: the dQ kernel runs first on the stream. No kernel uses atomics:
// every output element has one owner, so the gradients repeat bit for bit.
//
// The dropout bits. The TPU kernels seed a hardware generator per (batch *
// head, 8-row chunk, key chunk). Here bits(seed, b, h, i, j) is word j % 4
// of Philox4x32-10 with key (seed, 2) and counter (j / 4, i, h, b): a
// function of the seed and the absolute indices only, so the three kernels
// of both variants draw one mask whatever their tiling, and
// videocad_tpu_torch/ops/prng.py computes the same function in PyTorch
// integer ops for the plain versions. The key's second word keeps these
// streams apart from the short-sequence attention's (0) and the standalone
// dropout's (1).
//
// What bounds them on the card. At the flagship's decoder shape (B * H =
// 32, T = S = 191, D = 256, bf16) the forward moves 4 tensors of 3.1 MB
// (3.7 us at 3.35 TB/s) and, causal, does 4 D flops over each of the
// 18,336 admitted (query, key) pairs of a head: 0.60 GFLOP in all, 0.6 us
// at the tensor cores' 989 TFLOP/s. Memory traffic is the floor; what
// these small grids (192 blocks) really pay is latency: each block's chain
// of tile loads and dependent products.
//
// Two variants, picked by the wrapper (ops/attention.py:_kernel_variant)
// from the dtype and the head width alone:
//
// "scalar" (flash_attention_fwd, _dq, _dkv; kernels flash_*_scalar_kernel):
// float32, and bf16 heads whose width is not a multiple of 16; any D up to
// 256. One block of 8 warps per (16 rows it owns, batch * head); the block
// keeps its own rows and one streamed tile of 32 rows in shared memory as
// f32 (84-103 KB at D = 256, two blocks an SM); a warp owns two rows: in
// the score phase each lane takes one of the tile's 32 rows and forms its
// dot products with the warp's two rows over D, then the lane owns output
// columns lane, lane + 32, ... Scalar f32 FMAs fed from shared memory
// (three shared loads for every two FMAs in the score loops, a load of a
// tile row and a weight for each FMA pair in the products that follow),
// one Philox call per element with three of its four words thrown away,
// bf16 staged as f32 by 2-byte loads, and ten shuffles a row per tile:
// about 4 TFLOP/s on the admitted pairs, 2.5-2.9% of the roofline at the
// decoder's shape. Float32 stays here: on the tensor cores it would be
// TF32, three decimal digits, where the float32 path is held to 2e-5.
//
// "tc" (flash_attention_tc_fwd, _tc_dq, _tc_dkv): bf16 with D a multiple
// of 16 from 16 to 256, any T and S, all three mask modes. Every product
// runs on the tensor cores through mma.sync.m16n8k16 (bf16 in, f32
// accumulate; the building blocks are csrc/tc_common.cuh's, shared with
// mhsa_short.cu), operands by ldmatrix (.trans for the products whose
// B operand is a tile's rows: P V, ds K, and the dK/dV kernel's P^T g and
// ds^T q), tiles by 16-byte cp.async, double-buffered, in rows padded by 16
// bytes (528 bytes at D = 256) so that ldmatrix's eight row addresses fall
// on distinct banks. D is rounded up to a bucket of 64, 128 or 256 columns
// (three instantiations a kernel), the columns beyond D staged as zeros
// and never stored.
//   - Forward and dQ: a warp owns 16 query rows, a block 2 warps at D >
//     128 (32 rows: 192 blocks at the decoder's 6 row tiles x 32 heads,
//     against 96 with 4 warps, under the 132 SMs) and 4 below; key tiles
//     of 32 keys at D > 128, 64 below. Q's (and g's) fragments come by
//     ldmatrix per 16-column step: held in registers, a 16 x 256 Q would
//     cost 64 more a lane. S = Q K^T stays in C fragments; the mask comes
//     from each element's (row, key); the row max takes two quad shuffles
//     a tile, l is kept as a partial sum a lane and reduced at the end;
//     the accumulator (D / 2 f32 a lane, 128 at D = 256) is rescaled by
//     alpha; p, times keep / (1 - rate), becomes the A fragment of P V in
//     place. Row tiles run heaviest first (the causal bottom rows).
//   - dQ recomputes S and dP = g V^T per key tile on the tensor cores,
//     w = exp(s scale - lse) and the keep bits, ds = w (dw - delta) as an A
//     fragment, dq += ds K. delta = rowsum(g out) is computed up front, two
//     lanes a row.
//   - dK/dV: a block of 4 warps owns 32 keys (64 at D <= 64) and streams
//     query tiles of as many rows. One warp's dK and dV accumulators for
//     16 keys at D = 256 would be 2 x 128 f32 a lane, beyond 255
//     registers, so the block splits each tile into two phases. Phase A:
//     the warps tile the (queries x keys) block (16 queries x 16 keys a
//     warp at D > 64; x 64 keys at D <= 64, taken 16 at a time), compute S
//     and dP, w, the keep bits, w * drop and ds, and leave the last two in
//     shared memory as bf16. Phase B: each warp owns a slice of the output
//     columns (64 of 256) for all 32 keys (at D <= 64: 16 keys, all
//     columns) and accumulates dV += (w drop)^T g and dK += ds^T q, both
//     operands by ldmatrix.trans: 128 f32 accumulators a lane at D = 256.
//     Every output element has one owner.
//   - Dropout: one Philox call per (row, group of four keys): lanes 2c and
//     2c + 1 of a quad hold the two halves of one group for rows r and
//     r + 8; the even lane draws row r, the odd lane row r + 8, and they
//     swap their four keep bits with one shuffle.
//   - Rounding: P (dropped) and ds are rounded to bf16 before P V, ds K,
//     (w drop)^T g and ds^T q. The TPU kernels' _dot (precision=None) lets
//     the MXU run its native bf16 passes on the f32 operands, so they round
//     at the same places; the port's plain versions keep f32 there, and the
//     tests' bf16 limits carry a term for it (2^-9 of the output's largest
//     entry forward, 2^-7 for the gradients).
//
// What a later version could still do: wgmma with a warpgroup of 64 query
// rows (its B operand straight from shared memory, so no ldmatrix of K and
// V), TMA loads with an mbarrier ring and a producer warp, the dK/dV
// kernel's P and ds kept in registers by a transposed product, and dQ and
// dK/dV fused into one pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 2;               // rows (or keys) a warp owns
constexpr int kOwn = kWarps * kRows;   // rows (or keys) a block owns: 16
constexpr int kTile = 32;              // rows of a streamed tile: one a lane
constexpr int kMaxHeadDim = 256;
constexpr float kMasked = -1e30f;
constexpr uint32_t kKeyWord = 2u;      // Philox key word of this family

enum MaskMode { kMaskNone = 0, kMaskBand = 1, kMaskTensor = 2 };

struct Shape {
  int q_len, kv_len, heads, head_dim;
  int mask_mode, window;        // window: col > row - window (kMaskBand)
  const uint8_t* mask;          // (q_len, kv_len) bytes (kMaskTensor)
  float scale;
  uint32_t seed, threshold;     // threshold 0: no dropout
  float inv_keep;
};

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
  return __float2bfloat16(x);  // round to nearest even
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

// Word j % 4 of Philox4x32-10, key (seed, 2), counter (j / 4, i, h, b).
__device__ __forceinline__ uint32_t dropout_bits(uint32_t seed, uint32_t b,
                                                 uint32_t h, uint32_t i,
                                                 uint32_t j) {
  const uint4 w = philox(seed, kKeyWord, j >> 2, i, h, b);
  const uint32_t word = j & 3u;
  return word == 0u ? w.x : word == 1u ? w.y : word == 2u ? w.z : w.w;
}

// May query ``row`` attend key ``col``? Rows beyond T and keys beyond S
// count as masked.
__device__ __forceinline__ bool admitted(const Shape& sh, int row, int col) {
  if (row >= sh.q_len || col >= sh.kv_len) return false;
  if (sh.mask_mode == kMaskBand) return col <= row && col > row - sh.window;
  if (sh.mask_mode == kMaskTensor)
    return sh.mask[(long long)row * sh.kv_len + col] != 0;
  return true;
}

// The key tiles [first, last] (of ``tile`` keys) that hold a pair admitted
// to some of the query rows [row0, row0 + rows).
__device__ __forceinline__ void key_tiles(const Shape& sh, int row0, int rows,
                                          int tile, int* first, int* last) {
  int lo = 0, hi = sh.kv_len - 1;
  if (sh.mask_mode == kMaskBand) {
    const int last_row = min(row0 + rows, sh.q_len) - 1;
    lo = row0 >= sh.window ? row0 - sh.window + 1 : 0;
    hi = min(hi, last_row);
  }
  *first = lo / tile;
  *last = hi < lo ? *first - 1 : hi / tile;
}

// The query tiles [first, last] (of ``tile`` rows) that hold a pair
// admitted to some of the keys [col0, col0 + keys).
__device__ __forceinline__ void query_tiles(const Shape& sh, int col0,
                                            int keys, int tile, int* first,
                                            int* last) {
  int lo = 0, hi = sh.q_len - 1;
  if (sh.mask_mode == kMaskBand) {
    const int last_col = min(col0 + keys, sh.kv_len) - 1;
    lo = col0;
    hi = min(hi, last_col + sh.window - 1);   // window <= 2^30: no overflow
  }
  *first = lo / tile;
  *last = hi < lo ? *first - 1 : hi / tile;
}

// ---------------------------------------------------------------------
// The "scalar" variant.

// Copy ``rows`` rows of one head (D columns at ``src``, ``row_stride``
// elements apart) into shared memory as f32 times ``factor``, ``dst_stride``
// floats apart; rows at or beyond ``valid`` become zeros.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int dst_stride,
                                          const T* __restrict__ src,
                                          long long row_stride, int rows,
                                          int valid, int head_dim,
                                          float factor) {
  for (int idx = threadIdx.x; idx < rows * head_dim; idx += kThreads) {
    const int r = idx / head_dim;
    const int d = idx - r * head_dim;
    dst[r * dst_stride + d] =
        r < valid ? to_f32(src[r * row_stride + d]) * factor : 0.f;
  }
}

// Where batch * head ``bh`` starts in a (B, L, H, D) tensor, in elements.
__device__ __forceinline__ long long head_base(const Shape& sh, int bh,
                                               int len) {
  const int b = bh / sh.heads;
  const int h = bh - b * sh.heads;
  return ((long long)b * len * sh.heads + h) * sh.head_dim;
}

// ---------------------------------------------------------------------
// Forward. Shared memory, in floats: q (kOwn, D) scaled, the key tile
// (kTile, D + 1), the value tile (kTile, D), p (kOwn, kTile).
__host__ __device__ constexpr int fwd_shared_floats(int d) {
  return kOwn * d + kTile * (d + 1) + kTile * d + kOwn * kTile;
}

template <typename T, int kChunks>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_scalar_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Shape sh) {
  extern __shared__ float shared[];
  const int D = sh.head_dim;
  const int ks = D + 1;
  float* qs = shared;
  float* kt = qs + kOwn * D;
  float* vt = kt + kTile * ks;
  float* ps = vt + kTile * D;

  const int bh = blockIdx.y;
  const int b = bh / sh.heads;
  const int h = bh - b * sh.heads;
  const int row0 = blockIdx.x * kOwn;
  const long long row_stride = (long long)sh.heads * D;
  const long long q_base = head_base(sh, bh, sh.q_len);
  const long long kv_base = head_base(sh, bh, sh.kv_len);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  load_rows(qs, D, q + q_base + row0 * row_stride, row_stride, kOwn,
            sh.q_len - row0, D, sh.scale);

  float acc[kRows][kChunks];
  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) acc[r][c] = 0.f;
  }

  int first, last;
  key_tiles(sh, row0, kOwn, kTile, &first, &last);
  for (int tile = first; tile <= last; ++tile) {
    const int col0 = tile * kTile;
    __syncthreads();   // the previous tile is consumed (and q is loaded)
    load_rows(kt, ks, k + kv_base + col0 * row_stride, row_stride, kTile,
              sh.kv_len - col0, D, 1.f);
    load_rows(vt, D, v + kv_base + col0 * row_stride, row_stride, kTile,
              sh.kv_len - col0, D, 1.f);
    __syncthreads();

    // Scores of the warp's rows against key col0 + lane.
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* k_row = kt + lane * ks;
    for (int d = 0; d < D; ++d) {
      const float kv = k_row[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        s[r] = fmaf(qs[(warp * kRows + r) * D + d], kv, s[r]);
    }
    const int col = col0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + warp * kRows + r;
      const bool ok = admitted(sh, row, col);
      const float sv = ok ? s[r] : kMasked;
      const float m_new = fmaxf(m[r], warp_max(sv));
      float p = expf(sv - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
      if (sh.threshold != 0u && ok)
        p = dropout_bits(sh.seed, b, h, row, col) >= sh.threshold
                ? p * sh.inv_keep
                : 0.f;
      ps[(warp * kRows + r) * kTile + lane] = p;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();

    // acc += p v: the lane owns columns lane, lane + 32, ...
    for (int j = 0; j < kTile; ++j) {
      float p[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        p[r] = ps[(warp * kRows + r) * kTile + j];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int d = c * 32 + lane;
        if (d < D) {
          const float vv = vt[j * D + d];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[r][c] = fmaf(p[r], vv, acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + warp * kRows + r;
    if (row >= sh.q_len) continue;
    const float l_safe = fmaxf(l[r], 1e-20f);
    const float inv = 1.f / l_safe;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = c * 32 + lane;
      if (d < D)
        o[q_base + row * row_stride + d] = from_f32<T>(acc[r][c] * inv);
    }
    if (lane == 0) lse[(long long)bh * sh.q_len + row] = m[r] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------
// dQ (and delta). Shared memory, in floats: q scaled and g (kOwn, D) each,
// the key and value tiles (kTile, D + 1) each, ds (kOwn, kTile).
__host__ __device__ constexpr int dq_shared_floats(int d) {
  return 2 * kOwn * d + 2 * kTile * (d + 1) + kOwn * kTile;
}

template <typename T, int kChunks>
__global__ void __launch_bounds__(kThreads, 2)
flash_dq_scalar_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ g,
                const T* __restrict__ o, const float* __restrict__ lse,
                T* __restrict__ dq, float* __restrict__ delta, Shape sh) {
  extern __shared__ float shared[];
  const int D = sh.head_dim;
  const int ks = D + 1;
  float* qs = shared;
  float* gs = qs + kOwn * D;
  float* kt = gs + kOwn * D;
  float* vt = kt + kTile * ks;
  float* dss = vt + kTile * ks;

  const int bh = blockIdx.y;
  const int b = bh / sh.heads;
  const int h = bh - b * sh.heads;
  const int row0 = blockIdx.x * kOwn;
  const long long row_stride = (long long)sh.heads * D;
  const long long q_base = head_base(sh, bh, sh.q_len);
  const long long kv_base = head_base(sh, bh, sh.kv_len);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  load_rows(qs, D, q + q_base + row0 * row_stride, row_stride, kOwn,
            sh.q_len - row0, D, sh.scale);
  load_rows(gs, D, g + q_base + row0 * row_stride, row_stride, kOwn,
            sh.q_len - row0, D, 1.f);
  __syncthreads();

  // The rows' lse, and delta = rowsum(g * out), which the dK/dV kernel
  // reads later.
  float acc[kRows][kChunks];
  float row_lse[kRows], row_delta[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + warp * kRows + r;
    float part = 0.f;
    row_lse[r] = 0.f;
    if (row < sh.q_len) {
      row_lse[r] = lse[(long long)bh * sh.q_len + row];
      for (int d = lane; d < D; d += 32)
        part = fmaf(gs[(warp * kRows + r) * D + d],
                    to_f32(o[q_base + row * row_stride + d]), part);
    }
    row_delta[r] = warp_sum(part);
    if (lane == 0 && row < sh.q_len)
      delta[(long long)bh * sh.q_len + row] = row_delta[r];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) acc[r][c] = 0.f;
  }

  int first, last;
  key_tiles(sh, row0, kOwn, kTile, &first, &last);
  for (int tile = first; tile <= last; ++tile) {
    const int col0 = tile * kTile;
    if (tile != first) __syncthreads();   // the previous tile is consumed
    load_rows(kt, ks, k + kv_base + col0 * row_stride, row_stride, kTile,
              sh.kv_len - col0, D, 1.f);
    load_rows(vt, ks, v + kv_base + col0 * row_stride, row_stride, kTile,
              sh.kv_len - col0, D, 1.f);
    __syncthreads();

    // s = q . k and dwd = g . v of the warp's rows against key col0 + lane.
    float s[kRows], dwd[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dwd[r] = 0.f;
    const float* k_row = kt + lane * ks;
    const float* v_row = vt + lane * ks;
    for (int d = 0; d < D; ++d) {
      const float kv = k_row[d];
      const float vv = v_row[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s[r] = fmaf(qs[(warp * kRows + r) * D + d], kv, s[r]);
        dwd[r] = fmaf(gs[(warp * kRows + r) * D + d], vv, dwd[r]);
      }
    }
    const int col = col0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + warp * kRows + r;
      float ds = 0.f;
      if (admitted(sh, row, col)) {
        const float w = expf(s[r] - row_lse[r]);
        float dw = dwd[r];
        if (sh.threshold != 0u)
          dw = dropout_bits(sh.seed, b, h, row, col) >= sh.threshold
                   ? dw * sh.inv_keep
                   : 0.f;
        ds = w * (dw - row_delta[r]);
      }
      dss[(warp * kRows + r) * kTile + lane] = ds;
    }
    __syncwarp();

    // acc += ds k
    for (int j = 0; j < kTile; ++j) {
      float ds[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        ds[r] = dss[(warp * kRows + r) * kTile + j];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int d = c * 32 + lane;
        if (d < D) {
          const float kv = kt[j * ks + d];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[r][c] = fmaf(ds[r], kv, acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + warp * kRows + r;
    if (row >= sh.q_len) continue;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = c * 32 + lane;
      if (d < D)
        dq[q_base + row * row_stride + d] = from_f32<T>(acc[r][c] * sh.scale);
    }
  }
}

// ---------------------------------------------------------------------
// dK and dV. The block owns kOwn keys and streams tiles of kTile query
// rows. Shared memory, in floats: k and v (kOwn, D) each, the q (scaled)
// and g tiles (kTile, D + 1) each, w * drop and ds (kOwn, kTile) each.
__host__ __device__ constexpr int dkv_shared_floats(int d) {
  return 2 * kOwn * d + 2 * kTile * (d + 1) + 2 * kOwn * kTile;
}

template <typename T, int kChunks>
__global__ void __launch_bounds__(kThreads, 2)
flash_dkv_scalar_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ g,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, Shape sh) {
  extern __shared__ float shared[];
  const int D = sh.head_dim;
  const int ts = D + 1;
  float* kk = shared;
  float* vv = kk + kOwn * D;
  float* qt = vv + kOwn * D;
  float* gt = qt + kTile * ts;
  float* wds = gt + kTile * ts;
  float* dss = wds + kOwn * kTile;

  const int bh = blockIdx.y;
  const int b = bh / sh.heads;
  const int h = bh - b * sh.heads;
  const int col0 = blockIdx.x * kOwn;
  const long long row_stride = (long long)sh.heads * D;
  const long long q_base = head_base(sh, bh, sh.q_len);
  const long long kv_base = head_base(sh, bh, sh.kv_len);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  load_rows(kk, D, k + kv_base + col0 * row_stride, row_stride, kOwn,
            sh.kv_len - col0, D, 1.f);
  load_rows(vv, D, v + kv_base + col0 * row_stride, row_stride, kOwn,
            sh.kv_len - col0, D, 1.f);

  float acc_k[kRows][kChunks], acc_v[kRows][kChunks];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kChunks; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  int first, last;
  query_tiles(sh, col0, kOwn, kTile, &first, &last);
  for (int tile = first; tile <= last; ++tile) {
    const int row0 = tile * kTile;
    __syncthreads();   // the previous tile is consumed (and k, v are loaded)
    load_rows(qt, ts, q + q_base + row0 * row_stride, row_stride, kTile,
              sh.q_len - row0, D, sh.scale);
    load_rows(gt, ts, g + q_base + row0 * row_stride, row_stride, kTile,
              sh.q_len - row0, D, 1.f);
    __syncthreads();

    // s = q . k and dwd = g . v of query row0 + lane against the warp's
    // keys.
    float s[kRows], dwd[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dwd[r] = 0.f;
    const float* q_row = qt + lane * ts;
    const float* g_row = gt + lane * ts;
    for (int d = 0; d < D; ++d) {
      const float qv = q_row[d];
      const float gv = g_row[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s[r] = fmaf(qv, kk[(warp * kRows + r) * D + d], s[r]);
        dwd[r] = fmaf(gv, vv[(warp * kRows + r) * D + d], dwd[r]);
      }
    }
    const int row = row0 + lane;
    float row_lse = 0.f, row_delta = 0.f;
    if (row < sh.q_len) {
      row_lse = lse[(long long)bh * sh.q_len + row];
      row_delta = delta[(long long)bh * sh.q_len + row];
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int col = col0 + warp * kRows + r;
      float wd = 0.f, ds = 0.f;
      if (admitted(sh, row, col)) {
        const float w = expf(s[r] - row_lse);
        float drop = 1.f;
        if (sh.threshold != 0u)
          drop = dropout_bits(sh.seed, b, h, row, col) >= sh.threshold
                     ? sh.inv_keep
                     : 0.f;
        wd = w * drop;
        ds = w * (dwd[r] * drop - row_delta);
      }
      wds[(warp * kRows + r) * kTile + lane] = wd;
      dss[(warp * kRows + r) * kTile + lane] = ds;
    }
    __syncwarp();

    // acc_v += wd^T g and acc_k += ds^T q over the tile's rows.
    for (int i = 0; i < kTile; ++i) {
      float wd[kRows], ds[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        wd[r] = wds[(warp * kRows + r) * kTile + i];
        ds[r] = dss[(warp * kRows + r) * kTile + i];
      }
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int d = c * 32 + lane;
        if (d < D) {
          const float gv = gt[i * ts + d];
          const float qv = qt[i * ts + d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc_v[r][c] = fmaf(wd[r], gv, acc_v[r][c]);
            acc_k[r][c] = fmaf(ds[r], qv, acc_k[r][c]);
          }
        }
      }
    }
  }

  // q was scaled on the way in, so dk already carries 1/sqrt(D).
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int col = col0 + warp * kRows + r;
    if (col >= sh.kv_len) continue;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = c * 32 + lane;
      if (d < D) {
        dk[kv_base + col * row_stride + d] = from_f32<T>(acc_k[r][c]);
        dv[kv_base + col * row_stride + d] = from_f32<T>(acc_v[r][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------
// The "tc" variant: bf16 on the tensor cores.

// The tiles of a head-width bucket: kDMax columns (64, 128 or 256) staged
// a row, D up to kDMax.
template <int kDMax>
struct Tc {
  static constexpr int kStride = kDMax + 8;            // bf16 a staged row
  static constexpr int kWarps = kDMax > 128 ? 2 : 4;   // forward and dQ
  static constexpr int kRows = kWarps * 16;            // query rows a block
  static constexpr int kKeys = kDMax > 128 ? 32 : 64;  // keys a streamed tile
  // dK/dV: the keys a block owns, the query rows a streamed tile, and how
  // the product phase spreads its 4 warps over keys and columns.
  static constexpr int kOwnKeys = kDMax > 64 ? 32 : 64;
  static constexpr int kQRows = kOwnKeys;
  static constexpr int kKeySplit = kDMax > 64 ? 1 : 4;
  static constexpr int kColSplit = 4 / kKeySplit;
  static constexpr int kPStride = kOwnKeys + 8;        // bf16 a row of P, ds
};
constexpr int kDkvWarps = 4;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int kDMax>
constexpr int fwd_tc_bytes() {
  using C = Tc<kDMax>;
  return (C::kRows + 4 * C::kKeys) * C::kStride * 2;   // q; k, v twice
}

template <int kDMax>
constexpr int dq_tc_bytes() {
  using C = Tc<kDMax>;
  return (2 * C::kRows + 4 * C::kKeys) * C::kStride * 2;   // q, g; k, v twice
}

template <int kDMax>
constexpr int dkv_tc_bytes() {
  using C = Tc<kDMax>;
  // k, v; q, g twice; w * drop and ds.
  return (2 * C::kOwnKeys + 4 * C::kQRows) * C::kStride * 2 +
         2 * C::kQRows * C::kPStride * 2;
}

// Rows [0, rows) from ``src`` (row_stride elements apart) into a staged
// tile, kDMax columns, 16 bytes a cp.async by threads tid, tid + threads,
// ...; rows from ``valid`` on and columns from ``head_dim`` on are
// zero-filled (their copies read nothing at ``fallback``, a valid address).
template <int kDMax>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* tile,
                                           const __nv_bfloat16* src,
                                           const __nv_bfloat16* fallback,
                                           long long row_stride, int rows,
                                           int valid, int head_dim, int tid,
                                           int threads) {
  constexpr int kChunks = kDMax / 8;
  for (int idx = tid; idx < rows * kChunks; idx += threads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const bool inside = r < valid && c * 8 < head_dim;
    cp_async16(tile + r * Tc<kDMax>::kStride + c * 8,
               inside ? src + r * row_stride + c * 8 : fallback,
               inside ? 16 : 0);
  }
}

// Rows [0, rows) of a staged tile out to ``dst`` (rows row_stride elements
// apart), 16 bytes a store; rows from ``valid`` on and columns from
// ``head_dim`` on are not written.
template <int kDMax>
__device__ __forceinline__ void write_rows(const __nv_bfloat16* tile,
                                           __nv_bfloat16* dst,
                                           long long row_stride, int rows,
                                           int valid, int head_dim, int tid,
                                           int threads) {
  constexpr int kChunks = kDMax / 8;
  for (int idx = tid; idx < rows * kChunks; idx += threads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    if (r < valid && c * 8 < head_dim)
      *reinterpret_cast<uint4*>(dst + r * row_stride + c * 8) =
          *reinterpret_cast<const uint4*>(tile + r * Tc<kDMax>::kStride +
                                          c * 8);
  }
}

// The C fragments of 16 rows x 8 kN columns, times f_up (rows 0-7) or
// f_lo (rows 8-15), into a staged tile from ``at`` as bf16.
template <int kN, int kStride>
__device__ __forceinline__ void stage_fragments(const float (&c)[kN][4],
                                                float f_up, float f_lo,
                                                __nv_bfloat16* at, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    __nv_bfloat16* p = at + g * kStride + 8 * n + 2 * t;
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(c[n][0] * f_up,
                                                c[n][1] * f_up);
    *reinterpret_cast<uint32_t*>(p + 8 * kStride) =
        pack_bf16(c[n][2] * f_lo, c[n][3] * f_lo);
  }
}

// s[n] += the C fragments of A B^T for one warp over kDMax columns: A the
// 16 staged rows from ``a``, B the 8 kN staged rows from ``b`` (key tile n:
// rows 8n..8n+7). A's fragment comes by ldmatrix per 16-column step.
template <int kDMax, int kN>
__device__ __forceinline__ void products_abt(const __nv_bfloat16* a,
                                             const __nv_bfloat16* b, int lane,
                                             float (&s)[kN][4]) {
  constexpr int kS = Tc<kDMax>::kStride;
#pragma unroll
  for (int kk = 0; kk < kDMax / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(a + (lane & 15) * kS + kk * 16 + (lane >> 4) * 8, af);
#pragma unroll
    for (int n = 0; n < kN; n += 2) {
      uint32_t bf[4];
      ldsm_x4(b + (8 * n + (lane & 7) + ((lane >> 4) << 3)) * kS + kk * 16 +
                  ((lane >> 3) & 1) * 8,
              bf);
      mma_bf16(s[n], af, bf[0], bf[1]);
      mma_bf16(s[n + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[n] += the C fragments of P X for one warp: p[kk] the A fragment of
// P's columns 16kk..16kk+15, X the staged rows from ``x`` (one a column of
// P) read transposed by ldmatrix, output columns 8n.. of X.
template <int kStride, int kK, int kNOut>
__device__ __forceinline__ void products_px(const uint32_t (&p)[kK][4],
                                            const __nv_bfloat16* x, int lane,
                                            float (&acc)[kNOut][4]) {
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
    for (int n = 0; n < kNOut; n += 2) {
      uint32_t bf[4];
      ldsm_x4_trans(x + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                            kStride +
                        8 * n + (lane >> 4) * 8,
                    bf);
      mma_bf16(acc[n], p[kk], bf[0], bf[1]);
      mma_bf16(acc[n + 1], p[kk], bf[2], bf[3]);
    }
  }
}

template <int kDMax>
__global__ void __launch_bounds__(Tc<kDMax>::kWarps * 32)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    Shape sh) {
  using C = Tc<kDMax>;
  constexpr int kS = C::kStride, kN = C::kKeys / 8;
  constexpr int kThreadsTc = C::kWarps * 32;
  extern __shared__ __align__(16) unsigned char tc_shared[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tc_shared);
  __nv_bfloat16* kt = qs + C::kRows * kS;        // two buffers
  __nv_bfloat16* vt = kt + 2 * C::kKeys * kS;    // two buffers

  const int bh = blockIdx.y;
  const int b = bh / sh.heads;
  const int h = bh - b * sh.heads;
  // The heaviest causal rows (the last) first.
  const int row0 = (gridDim.x - 1 - blockIdx.x) * C::kRows;
  const int D = sh.head_dim;
  const long long rs = (long long)sh.heads * D;
  const long long q_base = head_base(sh, bh, sh.q_len);
  const __nv_bfloat16* qh = q + q_base;
  const __nv_bfloat16* kh = k + head_base(sh, bh, sh.kv_len);
  const __nv_bfloat16* vh = v + head_base(sh, bh, sh.kv_len);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = row0 + warp * 16;

  stage_rows<kDMax>(qs, qh + row0 * rs, qh, rs, C::kRows, sh.q_len - row0, D,
                    tid, kThreadsTc);
  cp_async_commit();
  int first, last;
  key_tiles(sh, row0, C::kRows, C::kKeys, &first, &last);
  auto stage_kv = [&](int tile, int buf) {
    const int col0 = tile * C::kKeys;
    stage_rows<kDMax>(kt + buf * C::kKeys * kS, kh + col0 * rs, kh, rs,
                      C::kKeys, sh.kv_len - col0, D, tid, kThreadsTc);
    stage_rows<kDMax>(vt + buf * C::kKeys * kS, vh + col0 * rs, vh, rs,
                      C::kKeys, sh.kv_len - col0, D, tid, kThreadsTc);
    cp_async_commit();
  };
  if (first <= last) stage_kv(first, 0);

  const float scale_log2 = sh.scale * kLog2e;
  const __nv_bfloat16* q_warp = qs + warp * 16 * kS;
  float acc[kDMax / 8][4] = {};
  // Per lane: the running max of rows r0 + g (up) and r0 + g + 8 (lo) in
  // the log2 domain, and the lane's part of their denominators.
  float m_up = kMasked, m_lo = kMasked, l_up = 0.f, l_lo = 0.f;
  for (int tile = first; tile <= last; ++tile) {
    const int buf = (tile - first) & 1;
    __syncthreads();   // every warp is done with the other buffer
    if (tile < last) {
      stage_kv(tile + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // this tile (and q) is in shared memory
    const __nv_bfloat16* ks = kt + buf * C::kKeys * kS;
    const __nv_bfloat16* vs = vt + buf * C::kKeys * kS;
    const int col0 = tile * C::kKeys;

    float s[kN][4] = {};
    products_abt<kDMax, kN>(q_warp, ks, lane, s);
    float mx_up = kMasked, mx_lo = kMasked;
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + ((e >> 1) << 3);
        const int col = col0 + 8 * n + 2 * t + (e & 1);
        s[n][e] = admitted(sh, row, col) ? s[n][e] * scale_log2 : kMasked;
        if (e < 2)
          mx_up = fmaxf(mx_up, s[n][e]);
        else
          mx_lo = fmaxf(mx_lo, s[n][e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_up = fmaxf(mx_up, __shfl_xor_sync(0xffffffffu, mx_up, off));
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    }
    const float new_up = fmaxf(m_up, mx_up), new_lo = fmaxf(m_lo, mx_lo);
    const float alpha_up = exp2f(m_up - new_up);
    const float alpha_lo = exp2f(m_lo - new_lo);
    m_up = new_up;
    m_lo = new_lo;
    float sum_up = 0.f, sum_lo = 0.f;
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - (e < 2 ? m_up : m_lo));
        if (e < 2)
          sum_up += s[n][e];
        else
          sum_lo += s[n][e];
      }
    l_up = l_up * alpha_up + sum_up;   // the undropped p
    l_lo = l_lo * alpha_lo + sum_lo;
    if (sh.threshold != 0u) {
      const uint32_t keep = keep_bits<kN>(sh.seed, kKeyWord, b, h, r0, col0,
                                          lane, sh.kv_len, sh.threshold);
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = (keep >> (4 * n + e)) & 1u ? s[n][e] * sh.inv_keep : 0.f;
    }
    // p (dropped) rounded to bf16 as the A fragments of P V, in place.
    uint32_t p[kN / 2][4];
#pragma unroll
    for (int kk = 0; kk < kN / 2; ++kk)
      to_a_fragment(s[2 * kk], s[2 * kk + 1], p[kk]);
#pragma unroll
    for (int n = 0; n < kDMax / 8; ++n) {
      acc[n][0] *= alpha_up;
      acc[n][1] *= alpha_up;
      acc[n][2] *= alpha_lo;
      acc[n][3] *= alpha_lo;
    }
    products_px<kS, kN / 2, kDMax / 8>(p, vs, lane, acc);
  }
  cp_async_wait<0>();   // a block without key tiles still has q in flight

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_up += __shfl_xor_sync(0xffffffffu, l_up, off);
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
  }
  l_up = fmaxf(l_up, 1e-20f);
  l_lo = fmaxf(l_lo, 1e-20f);
  // The warp's q rows are read by no one now: they stage its output.
  __nv_bfloat16* staging = qs + warp * 16 * kS;
  __syncwarp();
  stage_fragments<kDMax / 8, kS>(acc, 1.f / l_up, 1.f / l_lo, staging, lane);
  __syncwarp();
  write_rows<kDMax>(staging, o + q_base + r0 * rs, rs, 16, sh.q_len - r0, D,
                    lane, 32);
  if (t == 0) {
    float* row_lse = lse + (long long)bh * sh.q_len + r0 + g;
    if (r0 + g < sh.q_len) row_lse[0] = (m_up + log2f(l_up)) * kLn2;
    if (r0 + g + 8 < sh.q_len) row_lse[8] = (m_lo + log2f(l_lo)) * kLn2;
  }
}

template <int kDMax>
__global__ void __launch_bounds__(Tc<kDMax>::kWarps * 32)
flash_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ g,
                   const __nv_bfloat16* __restrict__ o,
                   const float* __restrict__ lse,
                   __nv_bfloat16* __restrict__ dq, float* __restrict__ delta,
                   Shape sh) {
  using C = Tc<kDMax>;
  constexpr int kS = C::kStride, kN = C::kKeys / 8;
  constexpr int kThreadsTc = C::kWarps * 32;
  extern __shared__ __align__(16) unsigned char tc_shared[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tc_shared);
  __nv_bfloat16* gs = qs + C::kRows * kS;
  __nv_bfloat16* kt = gs + C::kRows * kS;        // two buffers
  __nv_bfloat16* vt = kt + 2 * C::kKeys * kS;    // two buffers

  const int bh = blockIdx.y;
  const int b = bh / sh.heads;
  const int h = bh - b * sh.heads;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * C::kRows;
  const int D = sh.head_dim;
  const long long rs = (long long)sh.heads * D;
  const long long q_base = head_base(sh, bh, sh.q_len);
  const __nv_bfloat16* qh = q + q_base;
  const __nv_bfloat16* gh = g + q_base;
  const __nv_bfloat16* kh = k + head_base(sh, bh, sh.kv_len);
  const __nv_bfloat16* vh = v + head_base(sh, bh, sh.kv_len);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int r0 = row0 + warp * 16;

  stage_rows<kDMax>(qs, qh + row0 * rs, qh, rs, C::kRows, sh.q_len - row0, D,
                    tid, kThreadsTc);
  stage_rows<kDMax>(gs, gh + row0 * rs, gh, rs, C::kRows, sh.q_len - row0, D,
                    tid, kThreadsTc);
  cp_async_commit();
  int first, last;
  key_tiles(sh, row0, C::kRows, C::kKeys, &first, &last);
  auto stage_kv = [&](int tile, int buf) {
    const int col0 = tile * C::kKeys;
    stage_rows<kDMax>(kt + buf * C::kKeys * kS, kh + col0 * rs, kh, rs,
                      C::kKeys, sh.kv_len - col0, D, tid, kThreadsTc);
    stage_rows<kDMax>(vt + buf * C::kKeys * kS, vh + col0 * rs, vh, rs,
                      C::kKeys, sh.kv_len - col0, D, tid, kThreadsTc);
    cp_async_commit();
  };
  if (first <= last) stage_kv(first, 0);

  // delta = rowsum(g * out) of the warp's rows, two lanes a row, from
  // device memory while the tiles load; written out for the dK/dV kernel.
  const float* lse_bh = lse + (long long)bh * sh.q_len;
  float part = 0.f;
  {
    const int row = r0 + (lane >> 1);
    if (row < sh.q_len) {
      const __nv_bfloat16* g_row = gh + row * rs;
      const __nv_bfloat16* o_row = o + q_base + row * rs;
#pragma unroll 4
      for (int c = lane & 1; c < D / 8; c += 2) {
        const uint4 gv = *reinterpret_cast<const uint4*>(g_row + c * 8);
        const uint4 ov = *reinterpret_cast<const uint4*>(o_row + c * 8);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 gf = __bfloat1622float2(g2[i]);
          const float2 of = __bfloat1622float2(o2[i]);
          part = fmaf(gf.x, of.x, part);
          part = fmaf(gf.y, of.y, part);
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if ((lane & 1) == 0 && row < sh.q_len)
      delta[(long long)bh * sh.q_len + row] = part;
  }
  // Of the lane's C-layout rows r0 + gr (up) and r0 + gr + 8 (lo): delta,
  // and lse in the log2 domain.
  const float delta_up = __shfl_sync(0xffffffffu, part, 2 * gr);
  const float delta_lo = __shfl_sync(0xffffffffu, part, 2 * gr + 16);
  const float lse_up = r0 + gr < sh.q_len ? lse_bh[r0 + gr] * kLog2e : 0.f;
  const float lse_lo =
      r0 + gr + 8 < sh.q_len ? lse_bh[r0 + gr + 8] * kLog2e : 0.f;

  const float scale_log2 = sh.scale * kLog2e;
  const __nv_bfloat16* q_warp = qs + warp * 16 * kS;
  const __nv_bfloat16* g_warp = gs + warp * 16 * kS;
  float acc[kDMax / 8][4] = {};
  for (int tile = first; tile <= last; ++tile) {
    const int buf = (tile - first) & 1;
    __syncthreads();   // every warp is done with the other buffer
    if (tile < last) {
      stage_kv(tile + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // this tile (and q, g) is in shared memory
    const __nv_bfloat16* ks = kt + buf * C::kKeys * kS;
    const __nv_bfloat16* vs = vt + buf * C::kKeys * kS;
    const int col0 = tile * C::kKeys;

    // w = exp(s scale - lse) where admitted, in place of s.
    float w[kN][4] = {};
    products_abt<kDMax, kN>(q_warp, ks, lane, w);
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + gr + ((e >> 1) << 3);
        const int col = col0 + 8 * n + 2 * t + (e & 1);
        w[n][e] = admitted(sh, row, col)
                      ? exp2f(w[n][e] * scale_log2 - (e < 2 ? lse_up : lse_lo))
                      : 0.f;
      }
    float dp[kN][4] = {};
    products_abt<kDMax, kN>(g_warp, vs, lane, dp);   // g v^T
    const uint32_t keep =
        sh.threshold != 0u
            ? keep_bits<kN>(sh.seed, kKeyWord, b, h, r0, col0, lane,
                            sh.kv_len, sh.threshold)
            : 0xffffffffu;
    // ds = w (dw - delta) (inv_keep is 1 without dropout), rounded to bf16
    // as the A fragments of ds K.
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dw =
            (keep >> (4 * n + e)) & 1u ? dp[n][e] * sh.inv_keep : 0.f;
        w[n][e] *= dw - (e < 2 ? delta_up : delta_lo);
      }
    uint32_t ds[kN / 2][4];
#pragma unroll
    for (int kk = 0; kk < kN / 2; ++kk)
      to_a_fragment(w[2 * kk], w[2 * kk + 1], ds[kk]);
    products_px<kS, kN / 2, kDMax / 8>(ds, ks, lane, acc);
  }
  cp_async_wait<0>();

  // The warp's q rows are read by no one now: they stage dq.
  __nv_bfloat16* staging = qs + warp * 16 * kS;
  __syncwarp();
  stage_fragments<kDMax / 8, kS>(acc, sh.scale, sh.scale, staging, lane);
  __syncwarp();
  write_rows<kDMax>(staging, dq + q_base + r0 * rs, rs, 16, sh.q_len - r0, D,
                    lane, 32);
}

template <int kDMax>
__global__ void __launch_bounds__(kDkvWarps * 32)
flash_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, Shape sh) {
  using C = Tc<kDMax>;
  constexpr int kS = C::kStride, kP = C::kPStride;
  constexpr int kThreadsTc = kDkvWarps * 32;
  // Phase A: a warp scores 16 queries against kAKeys keys.
  constexpr int kQGroups = C::kQRows / 16;
  constexpr int kAKeys = C::kOwnKeys * kQGroups / kDkvWarps;
  // Phase B: a warp owns kBKeys keys x kBCols output columns.
  constexpr int kBKeys = C::kOwnKeys / C::kKeySplit;
  constexpr int kBM = kBKeys / 16;
  constexpr int kBCols = kDMax / C::kColSplit;
  constexpr int kBN = kBCols / 8;
  static_assert(kAKeys % 16 == 0 && kBN % 2 == 0 && kBM >= 1,
                "tile shapes");
  extern __shared__ __align__(16) unsigned char tc_shared[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(tc_shared);
  __nv_bfloat16* vs = ks + C::kOwnKeys * kS;
  __nv_bfloat16* qt = vs + C::kOwnKeys * kS;     // two buffers
  __nv_bfloat16* gt = qt + 2 * C::kQRows * kS;   // two buffers
  __nv_bfloat16* ps = gt + 2 * C::kQRows * kS;   // w * drop (queries, keys)
  __nv_bfloat16* dss = ps + C::kQRows * kP;      // ds (queries, keys)

  const int bh = blockIdx.y;
  const int b = bh / sh.heads;
  const int h = bh - b * sh.heads;
  const int col0 = blockIdx.x * C::kOwnKeys;   // the first are the heaviest
  const int D = sh.head_dim;
  const long long rs = (long long)sh.heads * D;
  const long long q_base = head_base(sh, bh, sh.q_len);
  const long long kv_base = head_base(sh, bh, sh.kv_len);
  const __nv_bfloat16* qh = q + q_base;
  const __nv_bfloat16* gh = g + q_base;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int qg = warp % kQGroups, kg = warp / kQGroups;      // phase A
  const int kb = warp % C::kKeySplit, cs = warp / C::kKeySplit;   // phase B

  stage_rows<kDMax>(ks, k + kv_base + col0 * rs, k + kv_base, rs,
                    C::kOwnKeys, sh.kv_len - col0, D, tid, kThreadsTc);
  stage_rows<kDMax>(vs, v + kv_base + col0 * rs, v + kv_base, rs,
                    C::kOwnKeys, sh.kv_len - col0, D, tid, kThreadsTc);
  cp_async_commit();
  int first, last;
  query_tiles(sh, col0, C::kOwnKeys, C::kQRows, &first, &last);
  auto stage_qg = [&](int tile, int buf) {
    const int row0 = tile * C::kQRows;
    stage_rows<kDMax>(qt + buf * C::kQRows * kS, qh + row0 * rs, qh, rs,
                      C::kQRows, sh.q_len - row0, D, tid, kThreadsTc);
    stage_rows<kDMax>(gt + buf * C::kQRows * kS, gh + row0 * rs, gh, rs,
                      C::kQRows, sh.q_len - row0, D, tid, kThreadsTc);
    cp_async_commit();
  };
  if (first <= last) stage_qg(first, 0);

  const float scale_log2 = sh.scale * kLog2e;
  const float* lse_bh = lse + (long long)bh * sh.q_len;
  const float* delta_bh = delta + (long long)bh * sh.q_len;
  const int ca = col0 + kg * kAKeys;   // phase A: the warp's first key
  float acc_k[kBM][kBN][4] = {}, acc_v[kBM][kBN][4] = {};
  for (int tile = first; tile <= last; ++tile) {
    const int buf = (tile - first) & 1;
    const int ra = tile * C::kQRows + qg * 16;   // phase A: its first query
    // The rows' lse (log2 domain) and delta, loaded ahead of the products.
    const bool up_in = ra + gr < sh.q_len, lo_in = ra + gr + 8 < sh.q_len;
    const float lse_up = up_in ? lse_bh[ra + gr] * kLog2e : 0.f;
    const float lse_lo = lo_in ? lse_bh[ra + gr + 8] * kLog2e : 0.f;
    const float delta_up = up_in ? delta_bh[ra + gr] : 0.f;
    const float delta_lo = lo_in ? delta_bh[ra + gr + 8] : 0.f;
    __syncthreads();   // every warp is done with the other buffer, P and ds
    if (tile < last) {
      stage_qg(tile + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // this tile (and k, v) is in shared memory
    const __nv_bfloat16* q_tile = qt + buf * C::kQRows * kS;
    const __nv_bfloat16* g_tile = gt + buf * C::kQRows * kS;

    // Phase A: w, w * drop and ds of the warp's 16 queries x kAKeys keys,
    // 16 keys at a time (so that S and dP take 16 registers a lane beside
    // the accumulators).
#pragma unroll 1
    for (int c = 0; c < kAKeys; c += 16) {
      float w[2][4] = {}, dp[2][4] = {};
      products_abt<kDMax, 2>(q_tile + qg * 16 * kS,
                             ks + (kg * kAKeys + c) * kS, lane, w);
      products_abt<kDMax, 2>(g_tile + qg * 16 * kS,
                             vs + (kg * kAKeys + c) * kS, lane, dp);
      const uint32_t keep =
          sh.threshold != 0u
              ? keep_bits<2>(sh.seed, kKeyWord, b, h, ra, ca + c, lane,
                             sh.kv_len, sh.threshold)
              : 0xffffffffu;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float pv[4], dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = ra + gr + ((e >> 1) << 3);
          const int col = ca + c + 8 * n + 2 * t + (e & 1);
          const float wv =
              admitted(sh, row, col)
                  ? exp2f(w[n][e] * scale_log2 - (e < 2 ? lse_up : lse_lo))
                  : 0.f;
          const float drop = (keep >> (4 * n + e)) & 1u ? sh.inv_keep : 0.f;
          pv[e] = wv * drop;
          dsv[e] = wv * (dp[n][e] * drop - (e < 2 ? delta_up : delta_lo));
        }
        const int at = (qg * 16 + gr) * kP + kg * kAKeys + c + 8 * n + 2 * t;
        *reinterpret_cast<uint32_t*>(ps + at) = pack_bf16(pv[0], pv[1]);
        *reinterpret_cast<uint32_t*>(ps + at + 8 * kP) =
            pack_bf16(pv[2], pv[3]);
        *reinterpret_cast<uint32_t*>(dss + at) = pack_bf16(dsv[0], dsv[1]);
        *reinterpret_cast<uint32_t*>(dss + at + 8 * kP) =
            pack_bf16(dsv[2], dsv[3]);
      }
    }
    __syncthreads();   // P and ds of the whole block are in shared memory

    // Phase B: dv += (w drop)^T g and dk += ds^T q over the tile's
    // queries; P^T and ds^T are P and ds read transposed.
#pragma unroll
    for (int kk = 0; kk < C::kQRows / 16; ++kk) {
      uint32_t a_p[kBM][4], a_ds[kBM][4];
#pragma unroll
      for (int m = 0; m < kBM; ++m) {
        const int at = (16 * kk + (lane & 7) + ((lane >> 4) << 3)) * kP +
                       kb * kBKeys + 16 * m + ((lane >> 3) & 1) * 8;
        ldsm_x4_trans(ps + at, a_p[m]);
        ldsm_x4_trans(dss + at, a_ds[m]);
      }
#pragma unroll
      for (int n = 0; n < kBN; n += 2) {
        const int bt = (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kS +
                       cs * kBCols + 8 * n + (lane >> 4) * 8;
        uint32_t bf[4];
        ldsm_x4_trans(g_tile + bt, bf);
#pragma unroll
        for (int m = 0; m < kBM; ++m) {
          mma_bf16(acc_v[m][n], a_p[m], bf[0], bf[1]);
          mma_bf16(acc_v[m][n + 1], a_p[m], bf[2], bf[3]);
        }
        ldsm_x4_trans(q_tile + bt, bf);
#pragma unroll
        for (int m = 0; m < kBM; ++m) {
          mma_bf16(acc_k[m][n], a_ds[m], bf[0], bf[1]);
          mma_bf16(acc_k[m][n + 1], a_ds[m], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();   // a block without query tiles still has k, v
  __syncthreads();      // in flight, and k and v are read by no one now

  // k and v stage dk (times the scale: q was not scaled) and dv.
#pragma unroll
  for (int m = 0; m < kBM; ++m) {
    const int at = (kb * kBKeys + 16 * m) * kS + cs * kBCols;
    stage_fragments<kBN, kS>(acc_k[m], sh.scale, sh.scale, ks + at, lane);
    stage_fragments<kBN, kS>(acc_v[m], 1.f, 1.f, vs + at, lane);
  }
  __syncthreads();
  write_rows<kDMax>(ks, dk + kv_base + col0 * rs, rs, C::kOwnKeys,
                    sh.kv_len - col0, D, tid, kThreadsTc);
  write_rows<kDMax>(vs, dv + kv_base + col0 * rs, rs, C::kOwnKeys,
                    sh.kv_len - col0, D, tid, kThreadsTc);
}

// ---------------------------------------------------------------------

bool bad_shape(int batch, int q_len, int kv_len, int heads, int head_dim,
               int mask_mode, int window, const void* mask) {
  return batch < 1 || q_len < 1 || kv_len < 1 || heads < 1 || head_dim < 1 ||
         head_dim > kMaxHeadDim || (long long)batch * heads > 65535LL ||
         mask_mode < kMaskNone || mask_mode > kMaskTensor ||
         (mask_mode == kMaskBand && (window < 1 || window > (1 << 30))) ||
         (mask_mode == kMaskTensor && mask == nullptr);
}

// What the tc variant takes beyond that: bf16 and D a multiple of 16 (and
// 16-byte aligned tensors, which the wrapper sees to).
bool bad_tc(int dtype, int head_dim) {
  return dtype != 1 || head_dim % 16 != 0;
}

// Opt in to ``bytes`` of dynamic shared memory (above the 48 KB a block
// gets by default) and report a refusal.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

dim3 grid_for(int owned_len, int owned, int batch, int heads) {
  return dim3((unsigned)((owned_len + owned - 1) / owned),
              (unsigned)(batch * heads));
}

template <typename T, int kChunks>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int batch, const Shape& sh, cudaStream_t stream) {
  const int bytes = fwd_shared_floats(sh.head_dim) * (int)sizeof(float);
  cudaError_t err = allow_shared(flash_fwd_scalar_kernel<T, kChunks>, bytes);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_scalar_kernel<T, kChunks>
      <<<grid_for(sh.q_len, kOwn, batch, sh.heads), kThreads, bytes,
         stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v), static_cast<T*>(o), lse, sh);
  return (int)cudaGetLastError();
}

template <typename T, int kChunks>
int launch_dq(const void* q, const void* k, const void* v, const void* g,
              const void* o, const float* lse, void* dq, float* delta,
              int batch, const Shape& sh, cudaStream_t stream) {
  const int bytes = dq_shared_floats(sh.head_dim) * (int)sizeof(float);
  cudaError_t err = allow_shared(flash_dq_scalar_kernel<T, kChunks>, bytes);
  if (err != cudaSuccess) return (int)err;
  flash_dq_scalar_kernel<T, kChunks>
      <<<grid_for(sh.q_len, kOwn, batch, sh.heads), kThreads, bytes,
         stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v), static_cast<const T*>(g),
                   static_cast<const T*>(o), lse, static_cast<T*>(dq), delta,
                   sh);
  return (int)cudaGetLastError();
}

template <typename T, int kChunks>
int launch_dkv(const void* q, const void* k, const void* v, const void* g,
               const float* lse, const float* delta, void* dk, void* dv,
               int batch, const Shape& sh, cudaStream_t stream) {
  const int bytes = dkv_shared_floats(sh.head_dim) * (int)sizeof(float);
  cudaError_t err = allow_shared(flash_dkv_scalar_kernel<T, kChunks>, bytes);
  if (err != cudaSuccess) return (int)err;
  flash_dkv_scalar_kernel<T, kChunks>
      <<<grid_for(sh.kv_len, kOwn, batch, sh.heads), kThreads, bytes,
         stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v), static_cast<const T*>(g), lse,
                   delta, static_cast<T*>(dk), static_cast<T*>(dv), sh);
  return (int)cudaGetLastError();
}

using bf16 = __nv_bfloat16;

template <int kDMax>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o,
                  float* lse, int batch, const Shape& sh,
                  cudaStream_t stream) {
  using C = Tc<kDMax>;
  constexpr int bytes = fwd_tc_bytes<kDMax>();
  cudaError_t err = allow_shared(flash_fwd_tc_kernel<kDMax>, bytes);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_tc_kernel<kDMax>
      <<<grid_for(sh.q_len, C::kRows, batch, sh.heads), C::kWarps * 32,
         bytes, stream>>>(static_cast<const bf16*>(q),
                          static_cast<const bf16*>(k),
                          static_cast<const bf16*>(v), static_cast<bf16*>(o),
                          lse, sh);
  return (int)cudaGetLastError();
}

template <int kDMax>
int launch_dq_tc(const void* q, const void* k, const void* v, const void* g,
                 const void* o, const float* lse, void* dq, float* delta,
                 int batch, const Shape& sh, cudaStream_t stream) {
  using C = Tc<kDMax>;
  constexpr int bytes = dq_tc_bytes<kDMax>();
  cudaError_t err = allow_shared(flash_dq_tc_kernel<kDMax>, bytes);
  if (err != cudaSuccess) return (int)err;
  flash_dq_tc_kernel<kDMax>
      <<<grid_for(sh.q_len, C::kRows, batch, sh.heads), C::kWarps * 32,
         bytes, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(g),
          static_cast<const bf16*>(o), lse, static_cast<bf16*>(dq), delta,
          sh);
  return (int)cudaGetLastError();
}

template <int kDMax>
int launch_dkv_tc(const void* q, const void* k, const void* v, const void* g,
                  const float* lse, const float* delta, void* dk, void* dv,
                  int batch, const Shape& sh, cudaStream_t stream) {
  using C = Tc<kDMax>;
  constexpr int bytes = dkv_tc_bytes<kDMax>();
  cudaError_t err = allow_shared(flash_dkv_tc_kernel<kDMax>, bytes);
  if (err != cudaSuccess) return (int)err;
  flash_dkv_tc_kernel<kDMax>
      <<<grid_for(sh.kv_len, C::kOwnKeys, batch, sh.heads), kDkvWarps * 32,
         bytes, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(g), lse,
          delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sh);
  return (int)cudaGetLastError();
}

// The launch's shape and constants; the dropout's and the scores' scale
// derived from ``rate`` and head_dim (tc_common.cuh).
Shape make_shape(const void* mask, int q_len, int kv_len, int heads,
                 int head_dim, int mask_mode, int window, unsigned int seed,
                 double rate) {
  const DropoutArgs drop = dropout_args(rate);
  Shape sh;
  sh.q_len = q_len;
  sh.kv_len = kv_len;
  sh.heads = heads;
  sh.head_dim = head_dim;
  sh.mask_mode = mask_mode;
  sh.window = window;
  sh.mask = static_cast<const uint8_t*>(mask);
  sh.scale = score_scale(head_dim);
  sh.seed = seed;
  sh.threshold = drop.threshold;
  sh.inv_keep = drop.inv_keep;
  return sh;
}

}  // namespace

// The scalar variant's instantiation: the I/O dtype (0 = float32, 1 =
// bfloat16) and the columns a lane owns (2 chunks of 32 for D <= 64, 8 for
// D <= 256).
#define FLASH_DISPATCH(LAUNCH, ...)                                        \
  do {                                                                     \
    if (dtype == 0)                                                        \
      return head_dim <= 64 ? LAUNCH<float, 2>(__VA_ARGS__)                \
                            : LAUNCH<float, 8>(__VA_ARGS__);               \
    if (dtype == 1)                                                        \
      return head_dim <= 64 ? LAUNCH<__nv_bfloat16, 2>(__VA_ARGS__)        \
                            : LAUNCH<__nv_bfloat16, 8>(__VA_ARGS__);       \
    return (int)cudaErrorInvalidValue;                                     \
  } while (0)

// The tc variant's instantiation: the head width's bucket.
#define FLASH_TC_DISPATCH(LAUNCH, ...)                                     \
  do {                                                                     \
    if (head_dim <= 64) return LAUNCH<64>(__VA_ARGS__);                    \
    if (head_dim <= 128) return LAUNCH<128>(__VA_ARGS__);                  \
    return LAUNCH<256>(__VA_ARGS__);                                       \
  } while (0)

// All tensors are contiguous on the current device: q, g, o, dq (batch,
// q_len, heads, head_dim); k, v, dk, dv (batch, kv_len, heads, head_dim);
// lse, delta (batch, heads, q_len) float32. mask_mode: 0 none, 1 band
// (col <= row && col > row - window; a window of 2^30 is the causal mask),
// 2 a (q_len, kv_len) byte tensor at ``mask`` (non-zero = attend).
// ``rate`` is the dropout rate in [0, 1) (0 turns dropout off): the entry
// derives the kernels' u32 cutoff and keep scale from it, and the scores'
// scale 1 / sqrt(head_dim). The launch goes to ``stream`` and does not
// synchronise. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape or rate the kernels do not take).
// These three entries launch the scalar variant.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, const void* mask,
                                   int batch, int q_len, int kv_len, int heads,
                                   int head_dim, int dtype, int mask_mode,
                                   int window, unsigned int seed, double rate,
                                   void* stream) {
  if (bad_shape(batch, q_len, kv_len, heads, head_dim, mask_mode, window,
                mask) ||
      bad_rate(rate))
    return (int)cudaErrorInvalidValue;
  const Shape sh = make_shape(mask, q_len, kv_len, heads, head_dim,
                              mask_mode, window, seed, rate);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_fwd, q, k, v, o, static_cast<float*>(lse), batch, sh,
                 s);
}

// dq, and delta = rowsum(g * o) for flash_attention_dkv, which must follow
// on the same stream.
extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* g, const void* o, const void* lse,
                                  void* dq, void* delta, const void* mask,
                                  int batch, int q_len, int kv_len, int heads,
                                  int head_dim, int dtype, int mask_mode,
                                  int window, unsigned int seed, double rate,
                                  void* stream) {
  if (bad_shape(batch, q_len, kv_len, heads, head_dim, mask_mode, window,
                mask) ||
      bad_rate(rate))
    return (int)cudaErrorInvalidValue;
  const Shape sh = make_shape(mask, q_len, kv_len, heads, head_dim,
                              mask_mode, window, seed, rate);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dq, q, k, v, g, o, static_cast<const float*>(lse), dq,
                 static_cast<float*>(delta), batch, sh, s);
}

extern "C" int flash_attention_dkv(const void* q, const void* k, const void* v,
                                   const void* g, const void* lse,
                                   const void* delta, void* dk, void* dv,
                                   const void* mask, int batch, int q_len,
                                   int kv_len, int heads, int head_dim,
                                   int dtype, int mask_mode, int window,
                                   unsigned int seed, double rate,
                                   void* stream) {
  if (bad_shape(batch, q_len, kv_len, heads, head_dim, mask_mode, window,
                mask) ||
      bad_rate(rate))
    return (int)cudaErrorInvalidValue;
  const Shape sh = make_shape(mask, q_len, kv_len, heads, head_dim,
                              mask_mode, window, seed, rate);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dkv, q, k, v, g, static_cast<const float*>(lse),
                 static_cast<const float*>(delta), dk, dv, batch, sh, s);
}

// The tc variant's three entries: the same arguments, bf16 only (dtype
// must be 1) with head_dim a multiple of 16 and every pointer but the
// mask's 16-byte aligned.
extern "C" int flash_attention_tc_fwd(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      const void* mask, int batch, int q_len,
                                      int kv_len, int heads, int head_dim,
                                      int dtype, int mask_mode, int window,
                                      unsigned int seed, double rate,
                                      void* stream) {
  if (bad_shape(batch, q_len, kv_len, heads, head_dim, mask_mode, window,
                mask) ||
      bad_tc(dtype, head_dim) || bad_rate(rate))
    return (int)cudaErrorInvalidValue;
  const Shape sh = make_shape(mask, q_len, kv_len, heads, head_dim,
                              mask_mode, window, seed, rate);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_TC_DISPATCH(launch_fwd_tc, q, k, v, o, static_cast<float*>(lse),
                    batch, sh, s);
}

extern "C" int flash_attention_tc_dq(const void* q, const void* k,
                                     const void* v, const void* g,
                                     const void* o, const void* lse, void* dq,
                                     void* delta, const void* mask, int batch,
                                     int q_len, int kv_len, int heads,
                                     int head_dim, int dtype, int mask_mode,
                                     int window, unsigned int seed, double rate,
                                     void* stream) {
  if (bad_shape(batch, q_len, kv_len, heads, head_dim, mask_mode, window,
                mask) ||
      bad_tc(dtype, head_dim) || bad_rate(rate))
    return (int)cudaErrorInvalidValue;
  const Shape sh = make_shape(mask, q_len, kv_len, heads, head_dim,
                              mask_mode, window, seed, rate);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_TC_DISPATCH(launch_dq_tc, q, k, v, g, o,
                    static_cast<const float*>(lse), dq,
                    static_cast<float*>(delta), batch, sh, s);
}

extern "C" int flash_attention_tc_dkv(const void* q, const void* k,
                                      const void* v, const void* g,
                                      const void* lse, const void* delta,
                                      void* dk, void* dv, const void* mask,
                                      int batch, int q_len, int kv_len,
                                      int heads, int head_dim, int dtype,
                                      int mask_mode, int window,
                                      unsigned int seed, double rate,
                                      void* stream) {
  if (bad_shape(batch, q_len, kv_len, heads, head_dim, mask_mode, window,
                mask) ||
      bad_tc(dtype, head_dim) || bad_rate(rate))
    return (int)cudaErrorInvalidValue;
  const Shape sh = make_shape(mask, q_len, kv_len, heads, head_dim,
                              mask_mode, window, seed, rate);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_TC_DISPATCH(launch_dkv_tc, q, k, v, g,
                    static_cast<const float*>(lse),
                    static_cast<const float*>(delta), dk, dv, batch, sh, s);
}
