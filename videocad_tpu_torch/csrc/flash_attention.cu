// Flash attention for the decoder: the forward, the dQ and the dK/dV
// kernels, with the mask computed from indices and dropout on the attention
// weights inside the kernels, for Hopper (sm_90a).
//
// Replaces the TPU kernels videocad_tpu/ops/attention.py:_flash_kernel
// (flash_attention -> _flash_forward -> pl.pallas_call), :_dq_kernel and
// :_dkv_kernel (_flash_backward -> pl.pallas_call, twice). They compute the
// same functions, in float32 whatever the I/O dtype:
//   out = dropout(softmax(q k^T / sqrt(D), mask)) v, q (B, T, H, D) and
//   k, v (B, S, H, D); q is scaled by 1/sqrt(D) first; key tiles stream
//   through the running (max m, denominator l) recurrence, a masked score
//   being -1e30; dropout multiplies the unnormalised weights p by
//   keep / (1 - rate) while l sums the undropped p; out = acc / l and the
//   row's logsumexp lse = m + log(l) are all the forward leaves behind.
//   Backward: w = mask ? exp(s - lse) : 0, dw = (g v^T) * drop,
//   delta = rowsum(g * out), ds = w * (dw - delta), dq = ds k / sqrt(D),
//   dk = ds^T (q / sqrt(D)), dv = (w * drop)^T g.
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
// window of 10 a block of 16 rows touches one or two key tiles of 32, not
// six). Skipping a tile equals masking it: a wholly masked first tile
// gives p = exp(0) = 1 that the next tile's alpha = exp(-1e30 - m) = 0
// wipes out, and an admitted pair always exists in contract. An arbitrary
// (T, S) byte mask is read as it is, every tile visited. delta, which XLA
// fuses outside the TPU kernels, is computed by the dQ kernel (each block
// owns its rows' g and reads their out once) and handed to the dK/dV
// kernel through a (B, H, T) buffer: the dQ kernel runs first on the
// stream.
//
// The dropout bits. The TPU kernels seed a hardware generator per (batch *
// head, 8-row chunk, key chunk). Here bits(seed, b, h, i, j) is word j % 4
// of Philox4x32-10 with key (seed, 2) and counter (j / 4, i, h, b): a
// function of the seed and the absolute indices only, so the three kernels
// draw one mask whatever their tiling, and
// videocad_tpu_torch/ops/prng.py computes the same function in PyTorch
// integer ops for the plain versions. The key's second word keeps these
// streams apart from the short-sequence attention's (0) and the standalone
// dropout's (1).
//
// What bounds them on the card. At the flagship's decoder shape (B * H =
// 32, T = S = 191, D = 256, bf16) the forward moves 4 tensors of 3.1 MB
// (3.7 us at 3.35 TB/s) and does 4 T S D = 37 MFLOP a head dense, 1.2
// GFLOP in all: 96 flops per byte, below the card's bf16 ridge of 295, so
// memory traffic is the floor. These simple kernels sit far above it,
// bound by how fast an SM starts scalar f32 FMAs fed from shared memory
// (three shared loads for two FMAs in the score loop). Tile skipping is
// what they do about the work itself: causal halves it, the band of 10
// cuts it to a sixth.
//
// Design. One block of 8 warps per (16 rows it owns, batch * head): 12 x 32
// = 384 blocks at the train step for 132 SMs, 96 at B = 2. A block keeps
// its own rows (q, and g in the dQ kernel; k and v in the dK/dV kernel,
// which owns 16 keys and streams 32 query rows at a time) and one streamed
// tile of 32 rows in shared memory as f32 (84-103 KB at D = 256, opted in
// per launch, two blocks an SM). A warp owns two of the block's rows: in
// the score phase each lane takes one of the tile's 32 rows and computes
// its dot products with the warp's two rows over D (the tile's rows are
// padded by one word so that 32 lanes hit 32 banks), the row reductions
// are warp shuffles, and the products that follow (p v, ds k, wd^T g,
// ds^T q) run with the lane owning output columns lane, lane + 32, ...:
// 2 x 8 accumulators a thread at D = 256, kept in registers across the
// tiles. Since a warp reads back only the scores it wrote itself, the
// block synchronises only around the tile loads. Every output element has
// one owner: no atomics, so the gradients repeat bit for bit. Head widths
// 1 to 256 are taken (two instantiations: up to 64 and up to 256 columns);
// wider heads are refused. Tensor-core math (mma.sync / wgmma), TMA loads
// and a fused dQ + dK/dV pass are the later steps to make them fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 2;               // rows (or keys) a warp owns
constexpr int kOwn = kWarps * kRows;   // rows (or keys) a block owns: 16
constexpr int kTile = 32;              // rows of a streamed tile: one a lane
constexpr int kMaxHeadDim = 256;
constexpr float kMasked = -1e30f;

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
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
  uint32_t c0 = j >> 2, c1 = i, c2 = h, c3 = b;
  uint32_t k0 = seed, k1 = 2u;
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
  const uint32_t word = j & 3u;
  return word == 0u ? c0 : word == 1u ? c1 : word == 2u ? c2 : c3;
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

// The key tiles [first, last] that hold a pair admitted to some of the
// query rows [row0, row0 + kOwn).
__device__ __forceinline__ void key_tiles(const Shape& sh, int row0,
                                          int* first, int* last) {
  int lo = 0, hi = sh.kv_len - 1;
  if (sh.mask_mode == kMaskBand) {
    const int last_row = min(row0 + kOwn, sh.q_len) - 1;
    lo = row0 >= sh.window ? row0 - sh.window + 1 : 0;
    hi = min(hi, last_row);
  }
  *first = lo / kTile;
  *last = hi < lo ? *first - 1 : hi / kTile;
}

// The query tiles [first, last] that hold a pair admitted to some of the
// keys [col0, col0 + kOwn).
__device__ __forceinline__ void query_tiles(const Shape& sh, int col0,
                                            int* first, int* last) {
  int lo = 0, hi = sh.q_len - 1;
  if (sh.mask_mode == kMaskBand) {
    const int last_col = min(col0 + kOwn, sh.kv_len) - 1;
    lo = col0;
    hi = min(hi, last_col + sh.window - 1);   // window <= 2^30: no overflow
  }
  *first = lo / kTile;
  *last = hi < lo ? *first - 1 : hi / kTile;
}

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
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
  key_tiles(sh, row0, &first, &last);
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
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
  key_tiles(sh, row0, &first, &last);
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
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
  query_tiles(sh, col0, &first, &last);
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

bool bad_shape(int batch, int q_len, int kv_len, int heads, int head_dim,
               int mask_mode, int window, const void* mask) {
  return batch < 1 || q_len < 1 || kv_len < 1 || heads < 1 || head_dim < 1 ||
         head_dim > kMaxHeadDim || (long long)batch * heads > 65535LL ||
         mask_mode < kMaskNone || mask_mode > kMaskTensor ||
         (mask_mode == kMaskBand && (window < 1 || window > (1 << 30))) ||
         (mask_mode == kMaskTensor && mask == nullptr);
}

// Opt in to ``floats`` of dynamic shared memory (above the 48 KB a block
// gets by default) and report a refusal.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int floats) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              floats * (int)sizeof(float));
}

dim3 grid_for(int owned_len, int batch, int heads) {
  return dim3((unsigned)((owned_len + kOwn - 1) / kOwn),
              (unsigned)(batch * heads));
}

template <typename T, int kChunks>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int batch, const Shape& sh, cudaStream_t stream) {
  const int floats = fwd_shared_floats(sh.head_dim);
  cudaError_t err = allow_shared(flash_fwd_kernel<T, kChunks>, floats);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<T, kChunks>
      <<<grid_for(sh.q_len, batch, sh.heads), kThreads,
         floats * sizeof(float), stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), lse, sh);
  return (int)cudaGetLastError();
}

template <typename T, int kChunks>
int launch_dq(const void* q, const void* k, const void* v, const void* g,
              const void* o, const float* lse, void* dq, float* delta,
              int batch, const Shape& sh, cudaStream_t stream) {
  const int floats = dq_shared_floats(sh.head_dim);
  cudaError_t err = allow_shared(flash_dq_kernel<T, kChunks>, floats);
  if (err != cudaSuccess) return (int)err;
  flash_dq_kernel<T, kChunks>
      <<<grid_for(sh.q_len, batch, sh.heads), kThreads,
         floats * sizeof(float), stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(g),
          static_cast<const T*>(o), lse, static_cast<T*>(dq), delta, sh);
  return (int)cudaGetLastError();
}

template <typename T, int kChunks>
int launch_dkv(const void* q, const void* k, const void* v, const void* g,
               const float* lse, const float* delta, void* dk, void* dv,
               int batch, const Shape& sh, cudaStream_t stream) {
  const int floats = dkv_shared_floats(sh.head_dim);
  cudaError_t err = allow_shared(flash_dkv_kernel<T, kChunks>, floats);
  if (err != cudaSuccess) return (int)err;
  flash_dkv_kernel<T, kChunks>
      <<<grid_for(sh.kv_len, batch, sh.heads), kThreads,
         floats * sizeof(float), stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
          static_cast<T*>(dk), static_cast<T*>(dv), sh);
  return (int)cudaGetLastError();
}

Shape make_shape(const void* mask, int q_len, int kv_len, int heads,
                 int head_dim, float scale, int mask_mode, int window,
                 unsigned int seed, unsigned int threshold, float inv_keep) {
  Shape sh;
  sh.q_len = q_len;
  sh.kv_len = kv_len;
  sh.heads = heads;
  sh.head_dim = head_dim;
  sh.mask_mode = mask_mode;
  sh.window = window;
  sh.mask = static_cast<const uint8_t*>(mask);
  sh.scale = scale;
  sh.seed = seed;
  sh.threshold = threshold;
  sh.inv_keep = inv_keep;
  return sh;
}

}  // namespace

// Pick the instantiation: the I/O dtype (0 = float32, 1 = bfloat16) and
// the columns a lane owns (2 chunks of 32 for D <= 64, 8 for D <= 256).
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

// All tensors are contiguous on the current device: q, g, o, dq (batch,
// q_len, heads, head_dim); k, v, dk, dv (batch, kv_len, heads, head_dim);
// lse, delta (batch, heads, q_len) float32. mask_mode: 0 none, 1 band
// (col <= row && col > row - window; a window of 2^30 is the causal mask),
// 2 a (q_len, kv_len) byte tensor at ``mask`` (non-zero = attend).
// ``threshold`` is the u32 dropout cutoff (bits below it are dropped; 0
// turns dropout off), ``inv_keep`` is 1 / (1 - rate). The launch goes to
// ``stream`` and does not synchronise. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape the kernels do not take).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   const void* mask, int batch, int q_len,
                                   int kv_len, int heads, int head_dim,
                                   float scale, int dtype, int mask_mode,
                                   int window, unsigned int seed,
                                   unsigned int threshold, float inv_keep,
                                   void* stream) {
  if (bad_shape(batch, q_len, kv_len, heads, head_dim, mask_mode, window,
                mask))
    return (int)cudaErrorInvalidValue;
  const Shape sh = make_shape(mask, q_len, kv_len, heads, head_dim, scale,
                              mask_mode, window, seed, threshold, inv_keep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_fwd, q, k, v, o, static_cast<float*>(lse), batch, sh,
                 s);
}

// dq, and delta = rowsum(g * o) for flash_attention_dkv, which must follow
// on the same stream.
extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* g, const void* o,
                                  const void* lse, void* dq, void* delta,
                                  const void* mask, int batch, int q_len,
                                  int kv_len, int heads, int head_dim,
                                  float scale, int dtype, int mask_mode,
                                  int window, unsigned int seed,
                                  unsigned int threshold, float inv_keep,
                                  void* stream) {
  if (bad_shape(batch, q_len, kv_len, heads, head_dim, mask_mode, window,
                mask))
    return (int)cudaErrorInvalidValue;
  const Shape sh = make_shape(mask, q_len, kv_len, heads, head_dim, scale,
                              mask_mode, window, seed, threshold, inv_keep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dq, q, k, v, g, o, static_cast<const float*>(lse), dq,
                 static_cast<float*>(delta), batch, sh, s);
}

extern "C" int flash_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* g,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, const void* mask,
                                   int batch, int q_len, int kv_len, int heads,
                                   int head_dim, float scale, int dtype,
                                   int mask_mode, int window,
                                   unsigned int seed, unsigned int threshold,
                                   float inv_keep, void* stream) {
  if (bad_shape(batch, q_len, kv_len, heads, head_dim, mask_mode, window,
                mask))
    return (int)cudaErrorInvalidValue;
  const Shape sh = make_shape(mask, q_len, kv_len, heads, head_dim, scale,
                              mask_mode, window, seed, threshold, inv_keep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dkv, q, k, v, g, static_cast<const float*>(lse),
                 static_cast<const float*>(delta), dk, dv, batch, sh, s);
}
