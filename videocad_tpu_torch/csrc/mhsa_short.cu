// Fused bidirectional multi-head self-attention for short sequences: the
// forward and the backward of the ViT's attention core, with dropout on the
// attention weights inside the kernels, for Hopper (sm_90a).
//
// Replaces the TPU kernels videocad_tpu/ops/fused_attention.py:_fwd_kernel
// (mhsa_short -> _mhsa_fwd -> pl.pallas_call) and :_bwd_kernel (_mhsa_bwd
// -> pl.pallas_call). They compute the same functions:
//   q, k, v arrive as (B, T, H*D), the layout the projections produce;
//   scores = q k^T accumulated in f32, times 1/sqrt(D);
//   a row softmax in f32 gives the weights;
//   dropout: a weight is kept where its 32 random bits are >= a u32
//   threshold, and kept weights are scaled by 1/(1 - rate), in f32;
//   the dropped weights are rounded to the I/O dtype before the P V
//   product; P V accumulated in f32; the output is written in the I/O
//   dtype, back in (B, T, H*D).
// The backward recomputes the weights and redraws the same mask from the
// seed, so only q, k, v and the seed are kept between the two, and emits
// dq, dk, dv in one launch:
//   dv = dropped^T g (dropped rounded to the I/O dtype), d_dropped = g v^T,
//   dw = keep ? d_dropped / (1 - rate) : 0,
//   ds = weights * (dw - rowsum(dw * weights)) * scale, rounded to the I/O
//   dtype, dq = ds k, dk = ds^T q; every product accumulates in f32.
// No masking: the ViT is bidirectional.
//
// The dropout bits. The TPU kernels seed a hardware generator per batch
// row. Here bits(seed, b, h, i, j) is word j % 4 of Philox4x32-10 with key
// (seed, 0) and counter (j / 4, i, h, b): a function of the seed and the
// four indices only, so forward and backward draw the same mask whatever
// their grids, blocks and thread-to-element maps.
// videocad_tpu_torch/ops/prng.py computes the same function in PyTorch
// integer ops for the plain versions.
//
// What bounds them on the card: per head the forward does about 4*T*T*D
// flops against 4*T*D*2 bytes of bf16 I/O (q, k, v in, o out), about T/2 =
// 25 flops per byte at the flagship's T = 50, D = 64; the backward does
// 10*T*T*D flops against 7*T*D*2 bytes, about 36 flops per byte. Both are
// far below the card's ridge (about 295 flops per byte in bf16), so the
// floor is memory traffic: at the train step's 1,528 frames 0.187 ms for
// the forward and 0.327 ms for the backward at 3.35 TB/s.
//
// Two variants, picked by the wrapper (ops/fused_attention.py:
// _kernel_variant) from the dtype and the shape alone:
//
// "scalar" (mhsa_short_fwd, mhsa_short_bwd): float32, and any D up to 64.
// One block per (frame, head) stages the head's operands in shared memory
// as f32 and runs scalar FMAs: one warp per query row, each lane holding
// the scores of keys lane and lane + 32, then one output column per lane.
// Its inner loops issue two 4-byte shared-memory loads per FMA; an SM
// serves one 32-word wavefront a clock, so an SM does at most 16 FMA a
// clock, about 7.4 TFLOP/s over 132 SMs at 1.75 GHz. The first versions
// ran bf16 this way too and sat on that ceiling (7.6 TFLOP/s forward, 6.2
// backward at 1,528 frames: 8.5% and 5.1% of the memory bound), with one
// Philox call per element (three of its four words thrown away), bf16
// operands widened to f32 in shared memory (78 KB a block in the
// backward) and 2-byte loads. Float32 stays here: on the tensor cores it
// would be TF32, three decimal digits, where the float32 path is held to
// 1e-5.
//
// "tc" (mhsa_short_tc_fwd, mhsa_short_tc_bwd): bfloat16 with D a multiple
// of 16 up to 64, T <= 64 (the flagship: T = 50, D = 64). Every product
// runs on the tensor cores through mma.sync.m16n8k16 (bf16 in, f32
// accumulate), whose fragment layouts the PTX ISA specifies, so the scores
// never leave registers (ldmatrix, mma.sync, the fragment packing, the
// keep bits and the core's row_products, softmax_rows and times_tile are
// csrc/tc_common.cuh's, shared with flash_attention.cu and fused_block.cu):
//   - one block of four warps per (frame, head); q, k, v (and g) come into
//     shared memory as bf16 by 16-byte cp.async, rows padded to 144 bytes
//     so that ldmatrix's eight row addresses fall on distinct banks; rows T
//     up to the next multiple of 16 are zero-filled;
//   - a warp owns 16 query rows (T padded to 64: four warps); S = Q K^T is
//     8 key tiles of 8 by D/16 k-steps, Q's and K's fragments by ldmatrix;
//     a lane holds its two rows' scores of 16 keys, so the row max and sum
//     are two shuffles within the quad, and no online softmax is needed:
//     the weights are normalised, dropped and rounded to bf16 exactly where
//     the plain version rounds, and the C fragments of S become the A
//     fragments of P V in place (V through ldmatrix.trans);
//   - dropout: one Philox call per (row, group of four keys). Lanes 2c and
//     2c + 1 of a quad hold the two halves of one group for rows r and
//     r + 8: the even lane draws row r, the odd lane row r + 8, and they
//     swap their four keep bits with one shuffle;
//   - the backward's first pass (a warp per 16 query rows) recomputes S and
//     the weights, redraws the mask, computes dP = g V^T, dw, the row dot
//     and ds on registers, dq = ds K (K through ldmatrix.trans), and leaves
//     the dropped weights and ds in shared memory as bf16; after one
//     barrier its second pass (a warp per 16 key rows) computes
//     dv = P^T g and dk = ds^T q with both operands through ldmatrix.trans.
//     No atomics: gradients repeat bit for bit;
//   - outputs go out in 16-byte stores through the warp's own rows of a
//     tile it no longer reads (dq, whose tiles are still read, in 4-byte
//     stores); padded query rows and key rows are never written.
// One (frame, head) per block keeps a block at 27 KB (forward) and 54 KB
// (backward) of shared memory and 128 threads, so several blocks share an
// SM and one block's loads overlap another's products; two heads a block
// would only halve the number of blocks.
//
// What a later version could still do: wgmma with one warpgroup a head (64
// rows, which is T padded exactly), TMA loads, and several heads per
// persistent block so that one head's loads overlap the next one's math.
//
// Past T = 64 (the GenCAD CAD encoder: T = 65) both variants have a second,
// wide instantiation up to T = 128, at the end of this file; the kernels
// above are the T <= 64 ones.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tc_common.cuh"

namespace {

constexpr int kMaxSeq = 64;    // T padded to 64: two key columns per lane
constexpr int kMaxHeadDim = 64;
constexpr int kWarps = 4;      // forward
constexpr int kBwdWarps = 8;   // backward
// Operand rows padded by one word: lane j reads row j, so a stride of 65
// words puts the 32 lanes of a warp on 32 different banks.
constexpr int kRowStride = kMaxHeadDim + 1;

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
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
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

// Word j % 4 of Philox4x32-10, key (seed, 0), counter (j / 4, i, h, b).
__device__ __forceinline__ uint32_t dropout_bits(uint32_t seed, uint32_t b,
                                                 uint32_t h, uint32_t i,
                                                 uint32_t j) {
  const uint4 w = philox(seed, 0u, j >> 2, i, h, b);
  const uint32_t word = j & 3u;
  return word == 0u ? w.x : word == 1u ? w.y : word == 2u ? w.z : w.w;
}

// The scaled scores of one query row against keys j0 = lane and j1 =
// lane + 32, then the row softmax. Padded key columns get weight 0.
__device__ __forceinline__ void softmax_row(const float* __restrict__ q_row,
                                            const float* __restrict__ ks,
                                            int seq, int head_dim,
                                            float scale, int j0, int j1,
                                            float* w0, float* w1) {
  float s0 = -INFINITY;
  float s1 = -INFINITY;
  if (j0 < seq) {
    float acc = 0.f;
    for (int d = 0; d < head_dim; ++d)
      acc = fmaf(q_row[d], ks[j0 * kRowStride + d], acc);
    s0 = acc * scale;
  }
  if (j1 < seq) {
    float acc = 0.f;
    for (int d = 0; d < head_dim; ++d)
      acc = fmaf(q_row[d], ks[j1 * kRowStride + d], acc);
    s1 = acc * scale;
  }
  const float m = warp_max(fmaxf(s0, s1));
  const float e0 = j0 < seq ? expf(s0 - m) : 0.f;
  const float e1 = j1 < seq ? expf(s1 - m) : 0.f;
  const float sum = warp_sum(e0 + e1);
  *w0 = e0 / sum;
  *w1 = e1 / sum;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
mhsa_short_fwd_scalar_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ o,
                             int seq, int heads, int head_dim, float scale,
                             uint32_t seed, uint32_t threshold,
                             float inv_keep) {
  __shared__ float ks[kMaxSeq * kRowStride];
  __shared__ float vs[kMaxSeq][kMaxHeadDim];
  __shared__ float qs[kWarps][kMaxHeadDim];
  __shared__ float ps[kWarps][kMaxSeq];

  const int frame = blockIdx.x / heads;
  const int head = blockIdx.x - frame * heads;
  const long long row_stride = (long long)heads * head_dim;
  const long long base =
      (long long)frame * seq * row_stride + (long long)head * head_dim;

  for (int idx = threadIdx.x; idx < seq * head_dim; idx += blockDim.x) {
    const int t = idx / head_dim;
    const int d = idx - t * head_dim;
    const long long off = base + t * row_stride + d;
    ks[t * kRowStride + d] = to_f32(k[off]);
    vs[t][d] = to_f32(v[off]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j0 = lane;
  const int j1 = lane + 32;
  for (int i = warp; i < seq; i += kWarps) {
    const long long row = base + i * row_stride;
    for (int d = lane; d < head_dim; d += 32) qs[warp][d] = to_f32(q[row + d]);
    __syncwarp();

    float w0, w1;
    softmax_row(qs[warp], ks, seq, head_dim, scale, j0, j1, &w0, &w1);
    if (threshold != 0u) {
      w0 = dropout_bits(seed, frame, head, i, j0) >= threshold ? w0 * inv_keep
                                                                : 0.f;
      w1 = dropout_bits(seed, frame, head, i, j1) >= threshold ? w1 * inv_keep
                                                                : 0.f;
    }
    // The weights drop to the I/O dtype before the P V product, as the TPU
    // kernel and the JAX reference path do.
    if (j0 < seq) ps[warp][j0] = round_io<T>(w0);
    if (j1 < seq) ps[warp][j1] = round_io<T>(w1);
    __syncwarp();

    for (int d = lane; d < head_dim; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < seq; ++j) acc = fmaf(ps[warp][j], vs[j][d], acc);
      o[row + d] = from_f32<T>(acc);
    }
    __syncwarp();  // qs and ps are rewritten by this warp's next row
  }
}

// Dynamic shared memory of the backward, in floats: q, k, v, g as
// (seq, kRowStride) and the dropped weights and ds as (seq, kMaxSeq).
__host__ __device__ constexpr int bwd_shared_floats(int seq) {
  return seq * (4 * kRowStride + 2 * kMaxSeq);
}

template <typename T>
__global__ void __launch_bounds__(kBwdWarps * 32)
mhsa_short_bwd_scalar_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ g, T* __restrict__ dq,
                             T* __restrict__ dk, T* __restrict__ dv, int seq,
                             int heads, int head_dim, float scale,
                             uint32_t seed, uint32_t threshold,
                             float inv_keep) {
  extern __shared__ float shared[];
  float* qs = shared;
  float* ks = qs + seq * kRowStride;
  float* vs = ks + seq * kRowStride;
  float* gs = vs + seq * kRowStride;
  float* ps = gs + seq * kRowStride;   // dropped weights, I/O-rounded
  float* dss = ps + seq * kMaxSeq;     // ds, I/O-rounded

  const int frame = blockIdx.x / heads;
  const int head = blockIdx.x - frame * heads;
  const long long row_stride = (long long)heads * head_dim;
  const long long base =
      (long long)frame * seq * row_stride + (long long)head * head_dim;

  for (int idx = threadIdx.x; idx < seq * head_dim; idx += blockDim.x) {
    const int t = idx / head_dim;
    const int d = idx - t * head_dim;
    const long long off = base + t * row_stride + d;
    qs[t * kRowStride + d] = to_f32(q[off]);
    ks[t * kRowStride + d] = to_f32(k[off]);
    vs[t * kRowStride + d] = to_f32(v[off]);
    gs[t * kRowStride + d] = to_f32(g[off]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j0 = lane;
  const int j1 = lane + 32;

  // Pass 1, one warp per query row: the row of dropped weights and of ds,
  // and dq.
  for (int i = warp; i < seq; i += kBwdWarps) {
    float w0, w1;
    softmax_row(qs + i * kRowStride, ks, seq, head_dim, scale, j0, j1, &w0,
                &w1);
    bool keep0 = true, keep1 = true;
    if (threshold != 0u) {
      keep0 = dropout_bits(seed, frame, head, i, j0) >= threshold;
      keep1 = dropout_bits(seed, frame, head, i, j1) >= threshold;
    }
    // d_dropped = g_i . v_j
    const float* g_row = gs + i * kRowStride;
    float dd0 = 0.f, dd1 = 0.f;
    if (j0 < seq)
      for (int d = 0; d < head_dim; ++d)
        dd0 = fmaf(g_row[d], vs[j0 * kRowStride + d], dd0);
    if (j1 < seq)
      for (int d = 0; d < head_dim; ++d)
        dd1 = fmaf(g_row[d], vs[j1 * kRowStride + d], dd1);
    float p0 = w0, p1 = w1, dw0 = dd0, dw1 = dd1;
    if (threshold != 0u) {
      p0 = keep0 ? w0 * inv_keep : 0.f;
      p1 = keep1 ? w1 * inv_keep : 0.f;
      dw0 = keep0 ? dd0 * inv_keep : 0.f;
      dw1 = keep1 ? dd1 * inv_keep : 0.f;
    }
    // Padded key columns have w = 0, so they add nothing here and get
    // ds = 0.
    const float dot = warp_sum(dw0 * w0 + dw1 * w1);
    if (j0 < seq) {
      ps[i * kMaxSeq + j0] = round_io<T>(p0);
      dss[i * kMaxSeq + j0] = round_io<T>(w0 * (dw0 - dot) * scale);
    }
    if (j1 < seq) {
      ps[i * kMaxSeq + j1] = round_io<T>(p1);
      dss[i * kMaxSeq + j1] = round_io<T>(w1 * (dw1 - dot) * scale);
    }
    __syncwarp();
    // dq_i = ds_i k
    const float* ds_row = dss + i * kMaxSeq;
    for (int d = lane; d < head_dim; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < seq; ++j)
        acc = fmaf(ds_row[j], ks[j * kRowStride + d], acc);
      dq[base + i * row_stride + d] = from_f32<T>(acc);
    }
  }
  __syncthreads();

  // Pass 2, one warp per key row: dv_j = sum_i dropped_ij g_i and
  // dk_j = sum_i ds_ij q_i.
  for (int j = warp; j < seq; j += kBwdWarps) {
    for (int d = lane; d < head_dim; d += 32) {
      float acc_v = 0.f, acc_k = 0.f;
      for (int i = 0; i < seq; ++i) {
        acc_v = fmaf(ps[i * kMaxSeq + j], gs[i * kRowStride + d], acc_v);
        acc_k = fmaf(dss[i * kMaxSeq + j], qs[i * kRowStride + d], acc_k);
      }
      dv[base + j * row_stride + d] = from_f32<T>(acc_v);
      dk[base + j * row_stride + d] = from_f32<T>(acc_k);
    }
  }
}

bool bad_shape(int batch, int seq, int heads, int head_dim) {
  return batch < 1 || seq < 1 || seq > kMaxSeq || heads < 1 || head_dim < 1 ||
         head_dim > kMaxHeadDim || (long long)batch * heads > 0x7fffffffLL;
}

template <typename T>
int launch_bwd_scalar(const void* q, const void* k, const void* v,
                      const void* g, void* dq, void* dk, void* dv, int batch,
                      int seq, int heads, int head_dim, float scale,
                      uint32_t seed, uint32_t threshold, float inv_keep,
                      cudaStream_t stream) {
  const int bytes = bwd_shared_floats(seq) * (int)sizeof(float);
  // Above the 48 KB a block gets by default: opt in, and report a refusal.
  cudaError_t err = cudaFuncSetAttribute(
      mhsa_short_bwd_scalar_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  mhsa_short_bwd_scalar_kernel<T>
      <<<dim3((unsigned)(batch * heads)), dim3(kBwdWarps * 32), bytes,
         stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v), static_cast<const T*>(g),
                   static_cast<T*>(dq), static_cast<T*>(dk),
                   static_cast<T*>(dv), seq, heads, head_dim, scale, seed,
                   threshold, inv_keep);
  return (int)cudaGetLastError();
}

// ---- The "tc" variant: bf16 on the tensor cores (mma.sync.m16n8k16) ----

constexpr int kTcWarps = 4;                   // 16 query rows each
constexpr int kTcTile = kMaxSeq * kTcStride;  // bf16 a (64, D) tile
constexpr int kTcBwdBytes = 6 * kTcTile * 2;  // q, k, v, g, dropped, ds

// Rows [0, seq) of one head's (T, D) slice of a (B, T, H*D) tensor (src at
// row 0, rows row_stride apart) into a (64, kTcStride) tile, 16 bytes a
// cp.async; rows seq..rows-1 are zero-filled (rows: seq rounded up to 16).
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* src, int seq,
                                          int rows, long long row_stride) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    const bool inside = r < seq;
    const __nv_bfloat16* from = src + (inside ? r * row_stride + c * 8 : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(tile + r * kTcStride + c * 8)),
                 "l"(from), "r"(inside ? 16 : 0));
  }
}

__device__ __forceinline__ void wait_loads() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// acc (C layout, the warp's 16 rows) into rows 0..15 of a staging tile as
// bf16.
template <int D>
__device__ __forceinline__ void stage_rows(float (&acc)[D / 8][4],
                                           __nv_bfloat16* tile, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    __nv_bfloat16* at = tile + g * kTcStride + 8 * n + 2 * t;
    *reinterpret_cast<uint32_t*>(at) = pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(at + 8 * kTcStride) =
        pack_bf16(acc[n][2], acc[n][3]);
  }
}

// Rows 0..15 of a staging tile out to rows r0.. (those below seq) of the
// head's slice, 16 bytes a store.
template <int D>
__device__ __forceinline__ void store_rows(const __nv_bfloat16* tile,
                                           __nv_bfloat16* dst, int r0,
                                           int seq, long long row_stride,
                                           int lane) {
  constexpr int kChunks = D / 8;
  __syncwarp();
  for (int idx = lane; idx < 16 * kChunks; idx += 32) {
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    if (r0 + r < seq)
      *reinterpret_cast<uint4*>(dst + (r0 + r) * row_stride + c * 8) =
          *reinterpret_cast<const uint4*>(tile + r * kTcStride + c * 8);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcWarps * 32)
mhsa_short_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o, int seq, int heads,
                         float scale_log2, uint32_t seed, uint32_t threshold,
                         float inv_keep) {
  __shared__ __align__(16) unsigned char tiles[3 * kTcTile * 2];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tiles);
  __nv_bfloat16* ks = qs + kTcTile;
  __nv_bfloat16* vs = ks + kTcTile;

  const int frame = blockIdx.x / heads;
  const int head = blockIdx.x - frame * heads;
  const long long row_stride = (long long)heads * D;
  const long long base =
      (long long)frame * seq * row_stride + (long long)head * D;
  const int rows = (seq + 15) & ~15;
  load_tile<D>(qs, q + base, seq, rows, row_stride);
  load_tile<D>(ks, k + base, seq, rows, row_stride);
  load_tile<D>(vs, v + base, seq, rows, row_stride);
  wait_loads();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * 16;
  if (r0 >= seq) return;   // padding rows only; no barrier follows

  float s[8][4] = {};
  row_products<D>(qs, ks, r0, lane, seq, s);
  softmax_rows(s, lane, seq, scale_log2);
  const uint32_t keep =
      threshold != 0u
          ? keep_bits<8>(seed, 0u, frame, head, r0, 0, lane, seq,
                         threshold)
          : 0xffffffffu;
  // Dropped (inv_keep is 1 without dropout) and rounded to bf16 where the
  // plain version rounds, as the A fragments of P V.
  uint32_t p[4][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[n][e] = (keep >> (4 * n + e)) & 1u ? s[n][e] * inv_keep : 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    to_a_fragment(s[2 * kk], s[2 * kk + 1], p[kk]);

  float acc[D / 8][4] = {};
  times_tile<D>(p, vs, lane, seq, acc);
  // The warp's q rows are read by no one now: they stage its output.
  __nv_bfloat16* staging = qs + r0 * kTcStride;
  stage_rows<D>(acc, staging, lane);
  store_rows<D>(staging, o + base, r0, seq, row_stride, lane);
}

template <int D>
__global__ void __launch_bounds__(kTcWarps * 32)
mhsa_short_bwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ g,
                         __nv_bfloat16* __restrict__ dq,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int seq, int heads,
                         float scale, float scale_log2, uint32_t seed,
                         uint32_t threshold, float inv_keep) {
  extern __shared__ __align__(16) unsigned char tc_shared[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tc_shared);
  __nv_bfloat16* ks = qs + kTcTile;
  __nv_bfloat16* vs = ks + kTcTile;
  __nv_bfloat16* gs = vs + kTcTile;
  __nv_bfloat16* ps = gs + kTcTile;    // dropped weights (query rows, keys)
  __nv_bfloat16* dss = ps + kTcTile;   // ds (query rows, keys)

  const int frame = blockIdx.x / heads;
  const int head = blockIdx.x - frame * heads;
  const long long row_stride = (long long)heads * D;
  const long long base =
      (long long)frame * seq * row_stride + (long long)head * D;
  const int rows = (seq + 15) & ~15;
  load_tile<D>(qs, q + base, seq, rows, row_stride);
  load_tile<D>(ks, k + base, seq, rows, row_stride);
  load_tile<D>(vs, v + base, seq, rows, row_stride);
  load_tile<D>(gs, g + base, seq, rows, row_stride);
  wait_loads();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  const bool active = r0 < seq;

  // Pass 1, a warp per 16 query rows: the weights, the mask, dP, ds, dq.
  if (active) {
    float w[8][4] = {};
    row_products<D>(qs, ks, r0, lane, seq, w);
    softmax_rows(w, lane, seq, scale_log2);
    const uint32_t keep =
        threshold != 0u
            ? keep_bits<8>(seed, 0u, frame, head, r0, 0, lane, seq,
                         threshold)
            : 0xffffffffu;
    float dw[8][4] = {};
    row_products<D>(gs, vs, r0, lane, seq, dw);   // d_dropped = g v^T
    float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dw[n][e] = (keep >> (4 * n + e)) & 1u ? dw[n][e] * inv_keep : 0.f;
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
    // nothing to dv and dk. Padded key columns have w = 0, hence ds = 0.
    const bool upper = r0 + gr < seq, lower = r0 + gr + 8 < seq;
    uint32_t ds_frag[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float pv[4], dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool row_ok = e < 2 ? upper : lower;
        const bool kept = (keep >> (4 * n + e)) & 1u;
        pv[e] = row_ok && kept ? w[n][e] * inv_keep : 0.f;
        dsv[e] = row_ok ? w[n][e] * (dw[n][e] - (e < 2 ? dot0 : dot1)) *
                              scale
                        : 0.f;
      }
      __nv_bfloat16* at = ps + (r0 + gr) * kTcStride + 8 * n + 2 * t;
      *reinterpret_cast<uint32_t*>(at) = pack_bf16(pv[0], pv[1]);
      *reinterpret_cast<uint32_t*>(at + 8 * kTcStride) =
          pack_bf16(pv[2], pv[3]);
      at = dss + (r0 + gr) * kTcStride + 8 * n + 2 * t;
      const uint32_t ds_upper = pack_bf16(dsv[0], dsv[1]);
      const uint32_t ds_lower = pack_bf16(dsv[2], dsv[3]);
      *reinterpret_cast<uint32_t*>(at) = ds_upper;
      *reinterpret_cast<uint32_t*>(at + 8 * kTcStride) = ds_lower;
      // As to_a_fragment lays out key tiles n & ~1 and n | 1.
      ds_frag[n >> 1][(n & 1) * 2] = ds_upper;
      ds_frag[n >> 1][(n & 1) * 2 + 1] = ds_lower;
    }
    float acc[D / 8][4] = {};
    times_tile<D>(ds_frag, ks, lane, seq, acc);   // dq = ds k
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      __nv_bfloat16* at = dq + base + 8 * n + 2 * t;
      if (upper)
        *reinterpret_cast<uint32_t*>(at + (r0 + gr) * row_stride) =
            pack_bf16(acc[n][0], acc[n][1]);
      if (lower)
        *reinterpret_cast<uint32_t*>(at + (r0 + gr + 8) * row_stride) =
            pack_bf16(acc[n][2], acc[n][3]);
    }
  }
  __syncthreads();

  // Pass 2, a warp per 16 key rows j from r0: dv = P^T g, dk = ds^T q.
  if (active) {
    float acc_v[D / 8][4] = {}, acc_k[D / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {   // query rows 16kk..16kk+15
      if (16 * kk >= seq) break;
      // The A fragments of P^T and ds^T: P and ds read transposed.
      const int at = (16 * kk + (lane & 7) + ((lane >> 4) << 3)) * kTcStride +
                     r0 + ((lane >> 3) & 1) * 8;
      uint32_t a_p[4], a_ds[4];
      ldsm_x4_trans(ps + at, a_p);
      ldsm_x4_trans(dss + at, a_ds);
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        const int bt = (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                           kTcStride +
                       8 * n + (lane >> 4) * 8;
        uint32_t bf[4];
        ldsm_x4_trans(gs + bt, bf);
        mma_bf16(acc_v[n], a_p, bf[0], bf[1]);
        mma_bf16(acc_v[n + 1], a_p, bf[2], bf[3]);
        ldsm_x4_trans(qs + bt, bf);
        mma_bf16(acc_k[n], a_ds, bf[0], bf[1]);
        mma_bf16(acc_k[n + 1], a_ds, bf[2], bf[3]);
      }
    }
    // k and v are read by no one in this pass: their rows r0.. stage dk
    // and dv.
    stage_rows<D>(acc_k, ks + r0 * kTcStride, lane);
    stage_rows<D>(acc_v, vs + r0 * kTcStride, lane);
    store_rows<D>(ks + r0 * kTcStride, dk + base, r0, seq, row_stride, lane);
    store_rows<D>(vs + r0 * kTcStride, dv + base, r0, seq, row_stride, lane);
  }
}

template <int D>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o,
                  int batch, int seq, int heads, float scale, uint32_t seed,
                  uint32_t threshold, float inv_keep, cudaStream_t stream) {
  mhsa_short_fwd_tc_kernel<D>
      <<<dim3((unsigned)(batch * heads)), dim3(kTcWarps * 32), 0, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<__nv_bfloat16*>(o), seq, heads,
          scale * 1.4426950408889634f, seed, threshold, inv_keep);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd_tc(const void* q, const void* k, const void* v, const void* g,
                  void* dq, void* dk, void* dv, int batch, int seq, int heads,
                  float scale, uint32_t seed, uint32_t threshold,
                  float inv_keep, cudaStream_t stream) {
  // Above the 48 KB a block gets by default: opt in, and report a refusal.
  cudaError_t err = cudaFuncSetAttribute(
      mhsa_short_bwd_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kTcBwdBytes);
  if (err != cudaSuccess) return (int)err;
  mhsa_short_bwd_tc_kernel<D>
      <<<dim3((unsigned)(batch * heads)), dim3(kTcWarps * 32), kTcBwdBytes,
         stream>>>(static_cast<const __nv_bfloat16*>(q),
                   static_cast<const __nv_bfloat16*>(k),
                   static_cast<const __nv_bfloat16*>(v),
                   static_cast<const __nv_bfloat16*>(g),
                   static_cast<__nv_bfloat16*>(dq),
                   static_cast<__nv_bfloat16*>(dk),
                   static_cast<__nv_bfloat16*>(dv), seq, heads, scale,
                   scale * 1.4426950408889634f, seed, threshold, inv_keep);
  return (int)cudaGetLastError();
}

// What the tc variant takes: bf16, D in {16, 32, 48, 64}, and 16-byte
// aligned rows (D a multiple of 8 and the base pointers, which the
// wrapper checks).
bool bad_tc(int dtype, int head_dim) {
  return dtype != 1 || head_dim % 16 != 0;
}

// ---- The wide instantiation: 64 < T <= 128, both variants ----
//
// The kernels above stay as they are for T <= 64 (the ViT at 224^2: T =
// 50). The GenCAD CAD encoder (a 256^2 edge image, patch 32) gives T = 65,
// which these take. The math, the rounding points, the mask (word j % 4 of
// Philox4x32-10, key (seed, 0), counter (j / 4, i, h, b): absolute indices,
// whatever the padding or the warp count) and what is written are those of
// the T <= 64 kernels; no atomics, and padded rows are never written.
//   - scalar: a warp per query row, each lane holding the scores of four
//     keys (lane + 32c); the operands in dynamic shared memory sized by T.
//     The backward keeps one (T, T) buffer, not two: a pass over the query
//     rows writes ds and dq, a pass over the key rows dk, a second pass
//     over the query rows recomputes the weights and writes the dropped
//     ones into the same buffer, and a last pass over the key rows dv. At
//     T = 128 that is 194 KB where two buffers would pass the card's 227.
//   - tc: T padded to a multiple of 16 (rows), one warp per 16 query rows,
//     one block per (frame, head). It is bound by memory traffic like the
//     T <= 64 kernels (at T = 65, B = 1,528, 16 heads of 64: 0.243 ms
//     forward, 0.425 backward at 3.35 TB/s), and what kept it from that
//     was latency, not work: few warps an SM, each waiting for its loads.
//     So:
//     * the kernels are instantiated on the number NT of 8-key tiles, 8 NT
//       = rows (NT = 10, 12, 14, 16 for T in 65..128, and 8 for T <= 64;
//       wide_key_tiles picks it from T): a lane holds its two rows' scores
//       of 8 NT keys, 40 floats at T = 65, not the 64 + 64 of two fixed
//       halves; a block is NT / 2 warps, and __launch_bounds__ says so,
//       with as many blocks an SM as shared memory allows for a minimum
//       (wide_min_blocks), so that registers do not cut occupancy further;
//     * the backward's first pass holds only the weights across the keys:
//       dP = g v^T is formed a pair of key tiles at a time, once for the
//       row dot rowsum(dw * w) and once more (the same products in the
//       same order, so the same bits) for ds and the dropped weights, which
//       go to shared memory as bf16 and, for ds, stay as the A fragments
//       of dq = ds k;
//     * the mask is drawn by the whole block into shared memory, one
//       Philox call for each real (query, group of four keys), where each
//       warp drawing its own 16 rows made 1,440 calls at T = 65 for 1,105
//       real ones (Philox's integer products bound the kernels at rate
//       0.1, PERF.md);
//     * loads overlap work: the mask, which needs no data, is drawn while
//       the block's cp.async loads are in flight, and they come in two
//       groups, q and k first, whose scores and softmax run while v (and
//       g) land; other blocks on the SM compute while one waits. A
//       persistent grid that walks several units a block and loads the
//       next behind this one's products was tried: it held a third fewer
//       blocks an SM (two stages of shared memory) and lost (PERF.md, PR
//       17).
//     The backward's dropped weights and ds live in (8 NT, 8 NT + 8) bf16
//     tiles: 16 bytes of padding a row keep ldmatrix's row addresses on
//     distinct banks.
// Both variants opt in to their dynamic shared memory (scalar 68 KB
// forward, up to 194 KB backward; tc 28-58 KB forward, 55-144 KB
// backward) on the launching device at every launch.

constexpr int kWideSeq = 128;   // T padded to 128: four key columns a lane
constexpr int kWideCols = kWideSeq / 32;
constexpr int kWideWarps = 8;   // the scalar backward's

__host__ __device__ constexpr int wide_fwd_shared_floats(int seq) {
  return seq * (kRowStride + kMaxHeadDim) + kWarps * (kMaxHeadDim + kWideSeq);
}

__host__ __device__ constexpr int wide_bwd_shared_floats(int seq) {
  return seq * (4 * kRowStride + seq);
}

// The scaled scores of one query row against keys lane + 32c, c < 4, then
// the row softmax. Padded key columns get weight 0.
__device__ __forceinline__ void softmax_row_wide(
    const float* __restrict__ q_row, const float* __restrict__ ks, int seq,
    int head_dim, float scale, int lane, float (&w)[kWideCols]) {
  float m = -INFINITY;
#pragma unroll
  for (int c = 0; c < kWideCols; ++c) {
    const int j = lane + 32 * c;
    w[c] = -INFINITY;
    if (j < seq) {
      float acc = 0.f;
      for (int d = 0; d < head_dim; ++d)
        acc = fmaf(q_row[d], ks[j * kRowStride + d], acc);
      w[c] = acc * scale;
    }
    m = fmaxf(m, w[c]);
  }
  m = warp_max(m);
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kWideCols; ++c) {
    w[c] = lane + 32 * c < seq ? expf(w[c] - m) : 0.f;
    sum += w[c];
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int c = 0; c < kWideCols; ++c) w[c] /= sum;
}

// Rows [0, seq) of one head's (seq, head_dim) slice of a (B, T, H*D)
// tensor (src at row 0, rows row_stride apart) into a (seq, stride) f32
// tile.
template <typename T>
__device__ __forceinline__ void load_rows_f32(float* tile, int stride,
                                              const T* __restrict__ src,
                                              int seq, int head_dim,
                                              long long row_stride) {
  for (int idx = threadIdx.x; idx < seq * head_dim; idx += blockDim.x) {
    const int t = idx / head_dim;
    const int d = idx - t * head_dim;
    tile[t * stride + d] = to_f32(src[t * row_stride + d]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
mhsa_short_fwd_scalar_wide_kernel(const T* __restrict__ q,
                                  const T* __restrict__ k,
                                  const T* __restrict__ v,
                                  T* __restrict__ o, int seq, int heads,
                                  int head_dim, float scale, uint32_t seed,
                                  uint32_t threshold, float inv_keep) {
  extern __shared__ float wide_shared[];
  float* ks = wide_shared;                     // (seq, kRowStride)
  float* vs = ks + seq * kRowStride;           // (seq, kMaxHeadDim)
  float* qs = vs + seq * kMaxHeadDim;          // (kWarps, kMaxHeadDim)
  float* ps = qs + kWarps * kMaxHeadDim;       // (kWarps, kWideSeq)

  const int frame = blockIdx.x / heads;
  const int head = blockIdx.x - frame * heads;
  const long long row_stride = (long long)heads * head_dim;
  const long long base =
      (long long)frame * seq * row_stride + (long long)head * head_dim;
  load_rows_f32(ks, kRowStride, k + base, seq, head_dim, row_stride);
  load_rows_f32(vs, kMaxHeadDim, v + base, seq, head_dim, row_stride);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* q_row = qs + warp * kMaxHeadDim;
  float* p_row = ps + warp * kWideSeq;
  for (int i = warp; i < seq; i += kWarps) {
    const long long row = base + i * row_stride;
    for (int d = lane; d < head_dim; d += 32) q_row[d] = to_f32(q[row + d]);
    __syncwarp();

    float w[kWideCols];
    softmax_row_wide(q_row, ks, seq, head_dim, scale, lane, w);
#pragma unroll
    for (int c = 0; c < kWideCols; ++c) {
      const int j = lane + 32 * c;
      if (threshold != 0u)
        w[c] = dropout_bits(seed, frame, head, i, j) >= threshold
                   ? w[c] * inv_keep
                   : 0.f;
      // Rounded to the I/O dtype before the P V product.
      if (j < seq) p_row[j] = round_io<T>(w[c]);
    }
    __syncwarp();

    for (int d = lane; d < head_dim; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < seq; ++j) acc = fmaf(p_row[j], vs[j * kMaxHeadDim + d],
                                               acc);
      o[row + d] = from_f32<T>(acc);
    }
    __syncwarp();  // q_row and p_row are rewritten by this warp's next row
  }
}

// One pass of the wide scalar backward over the key rows: out_j = sum_i
// buf_ij src_i, a warp per key row j, a lane per column.
template <typename T>
__device__ __forceinline__ void wide_key_rows(const float* __restrict__ buf,
                                              const float* __restrict__ src,
                                              T* __restrict__ out, int seq,
                                              int head_dim, long long base,
                                              long long row_stride, int warp,
                                              int lane) {
  for (int j = warp; j < seq; j += kWideWarps)
    for (int d = lane; d < head_dim; d += 32) {
      float acc = 0.f;
      for (int i = 0; i < seq; ++i)
        acc = fmaf(buf[i * seq + j], src[i * kRowStride + d], acc);
      out[base + j * row_stride + d] = from_f32<T>(acc);
    }
}

template <typename T>
__global__ void __launch_bounds__(kWideWarps * 32)
mhsa_short_bwd_scalar_wide_kernel(const T* __restrict__ q,
                                  const T* __restrict__ k,
                                  const T* __restrict__ v,
                                  const T* __restrict__ g,
                                  T* __restrict__ dq, T* __restrict__ dk,
                                  T* __restrict__ dv, int seq, int heads,
                                  int head_dim, float scale, uint32_t seed,
                                  uint32_t threshold, float inv_keep) {
  extern __shared__ float wide_shared[];
  float* qs = wide_shared;
  float* ks = qs + seq * kRowStride;
  float* vs = ks + seq * kRowStride;
  float* gs = vs + seq * kRowStride;
  float* buf = gs + seq * kRowStride;   // (seq, seq): ds, then the dropped

  const int frame = blockIdx.x / heads;
  const int head = blockIdx.x - frame * heads;
  const long long row_stride = (long long)heads * head_dim;
  const long long base =
      (long long)frame * seq * row_stride + (long long)head * head_dim;
  load_rows_f32(qs, kRowStride, q + base, seq, head_dim, row_stride);
  load_rows_f32(ks, kRowStride, k + base, seq, head_dim, row_stride);
  load_rows_f32(vs, kRowStride, v + base, seq, head_dim, row_stride);
  load_rows_f32(gs, kRowStride, g + base, seq, head_dim, row_stride);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // Pass 1, a warp per query row: the row of ds (I/O-rounded), and dq.
  for (int i = warp; i < seq; i += kWideWarps) {
    float w[kWideCols];
    softmax_row_wide(qs + i * kRowStride, ks, seq, head_dim, scale, lane, w);
    const float* g_row = gs + i * kRowStride;
    float dw[kWideCols];
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < kWideCols; ++c) {
      const int j = lane + 32 * c;
      float dd = 0.f;   // d_dropped = g_i . v_j
      if (j < seq)
        for (int d = 0; d < head_dim; ++d)
          dd = fmaf(g_row[d], vs[j * kRowStride + d], dd);
      dw[c] = dd;
      if (threshold != 0u)
        dw[c] = dropout_bits(seed, frame, head, i, j) >= threshold
                    ? dd * inv_keep
                    : 0.f;
      // Padded key columns have w = 0: they add nothing, get ds = 0.
      dot += dw[c] * w[c];
    }
    dot = warp_sum(dot);
    float* ds_row = buf + i * seq;
#pragma unroll
    for (int c = 0; c < kWideCols; ++c) {
      const int j = lane + 32 * c;
      if (j < seq) ds_row[j] = round_io<T>(w[c] * (dw[c] - dot) * scale);
    }
    __syncwarp();
    for (int d = lane; d < head_dim; d += 32) {   // dq_i = ds_i k
      float acc = 0.f;
      for (int j = 0; j < seq; ++j)
        acc = fmaf(ds_row[j], ks[j * kRowStride + d], acc);
      dq[base + i * row_stride + d] = from_f32<T>(acc);
    }
  }
  __syncthreads();
  // Pass 2: dk_j = sum_i ds_ij q_i.
  wide_key_rows<T>(buf, qs, dk, seq, head_dim, base, row_stride, warp, lane);
  __syncthreads();
  // Pass 3, a warp per query row: the weights again, dropped and
  // I/O-rounded, over ds.
  for (int i = warp; i < seq; i += kWideWarps) {
    float w[kWideCols];
    softmax_row_wide(qs + i * kRowStride, ks, seq, head_dim, scale, lane, w);
#pragma unroll
    for (int c = 0; c < kWideCols; ++c) {
      const int j = lane + 32 * c;
      if (threshold != 0u)
        w[c] = dropout_bits(seed, frame, head, i, j) >= threshold
                   ? w[c] * inv_keep
                   : 0.f;
      if (j < seq) buf[i * seq + j] = round_io<T>(w[c]);
    }
  }
  __syncthreads();
  // Pass 4: dv_j = sum_i dropped_ij g_i.
  wide_key_rows<T>(buf, gs, dv, seq, head_dim, base, row_stride, warp, lane);
}

bool bad_wide_shape(int batch, int seq, int heads, int head_dim) {
  return batch < 1 || seq < 1 || seq > kWideSeq || heads < 1 ||
         head_dim < 1 || head_dim > kMaxHeadDim ||
         (long long)batch * heads > 0x7fffffffLL;
}

// Opt in to ``bytes`` of dynamic shared memory on the current device (the
// attribute is the device's own), launch, and report a refusal.
template <typename Kernel, typename... Args>
int launch_shared(Kernel kernel, dim3 grid, dim3 block, int bytes,
                  cudaStream_t stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, block, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd_scalar_wide(const void* q, const void* k, const void* v,
                           void* o, int batch, int seq, int heads,
                           int head_dim, float scale, uint32_t seed,
                           uint32_t threshold, float inv_keep,
                           cudaStream_t stream) {
  return launch_shared(
      mhsa_short_fwd_scalar_wide_kernel<T>, dim3((unsigned)(batch * heads)),
      dim3(kWarps * 32), wide_fwd_shared_floats(seq) * (int)sizeof(float),
      stream, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seq, heads, head_dim,
      scale, seed, threshold, inv_keep);
}

template <typename T>
int launch_bwd_scalar_wide(const void* q, const void* k, const void* v,
                           const void* g, void* dq, void* dk, void* dv,
                           int batch, int seq, int heads, int head_dim,
                           float scale, uint32_t seed, uint32_t threshold,
                           float inv_keep, cudaStream_t stream) {
  return launch_shared(
      mhsa_short_bwd_scalar_wide_kernel<T>, dim3((unsigned)(batch * heads)),
      dim3(kWideWarps * 32),
      wide_bwd_shared_floats(seq) * (int)sizeof(float), stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), seq,
      heads, head_dim, scale, seed, threshold, inv_keep);
}

// T padded to a multiple of 16: the rows of a wide tc unit's tiles.
__host__ __device__ constexpr int wide_rows(int seq) {
  return (seq + 15) & ~15;
}

// ---- The wide tc kernels ----

// The 8-key tiles a wide tc instantiation holds for ``seq`` keys: seq
// rounded up to 16, over 8, and 8 at the least (the wide entries take seq
// <= 64 too). mhsa_short_tc_wide_info reports it.
__host__ __device__ constexpr int wide_key_tiles(int seq) {
  return seq <= 64 ? 8 : wide_rows(seq) / 8;
}

// The shared memory of instantiation NT, whose tiles hold 8 NT rows: q, k,
// v (and g) as (8 NT, kTcStride) bf16; in the backward also the dropped
// weights and ds as (8 NT, 8 NT + 8): 16 bytes of padding a row keep
// ldmatrix's row addresses on distinct banks; last the mask, a byte for
// each of 8 NT rows and 2 NT groups of four keys.
__host__ __device__ constexpr int wide_tc_tile(int nt) {
  return 8 * nt * kTcStride;
}
__host__ __device__ constexpr int wide_tc_pstride(int nt) {
  return 8 * nt + 8;
}
__host__ __device__ constexpr int wide_tc_mask_bytes(int nt) {
  return 8 * nt * 2 * nt;
}
__host__ __device__ constexpr int wide_tc_fwd_bytes(int nt) {
  return 3 * wide_tc_tile(nt) * 2 + wide_tc_mask_bytes(nt);
}
__host__ __device__ constexpr int wide_tc_bwd_bytes(int nt) {
  return (4 * wide_tc_tile(nt) + 2 * 8 * nt * wide_tc_pstride(nt)) * 2 +
         wide_tc_mask_bytes(nt);
}
// The minimum-blocks hint of __launch_bounds__ for blocks of NT / 2 warps
// and ``bytes`` of shared memory: as many as an SM holds by shared memory
// (228 KB, of which the runtime keeps 1 KB a block), but no more than 20
// warps an SM. A scheduler's quarter of the register file (16,384) then
// holds its five warps at 96 registers a thread or more: the forward at NT
// = 10 takes 78 and the backward 122, without spills (PERF.md, PR 17).
__host__ __device__ constexpr int wide_min_blocks(int nt, int bytes) {
  return 233472 / (bytes + 1024) < 20 / (nt / 2) ? 233472 / (bytes + 1024)
                                                 : 20 / (nt / 2);
}

// The unit's mask, drawn by the whole block: one Philox call for each
// (query row i < seq, group c of four keys < seq) and no call for padding,
// spread evenly over the threads (a warp drawing its own 16 rows would
// draw 16 at T = 65, where one is real). Byte i * 2 NT + c holds the keep
// bits of keys 4c..4c+3 of row i (bit j % 4). Bytes of padding rows and
// groups are not written: what they select is never stored.
template <int NT>
__device__ __forceinline__ void draw_mask(uint8_t* mask, uint32_t seed,
                                          int frame, int head, int seq,
                                          uint32_t threshold) {
  const int groups = (seq + 3) >> 2;
  const int step_rows = blockDim.x / groups;
  const int step_groups = blockDim.x - step_rows * groups;
  int row = threadIdx.x / groups;
  int group = threadIdx.x - row * groups;
  for (int idx = threadIdx.x; idx < seq * groups; idx += blockDim.x) {
    const uint4 w = philox(seed, 0u, group, row, head, frame);
    mask[row * 2 * NT + group] =
        (uint8_t)((w.x >= threshold) | (w.y >= threshold) << 1 |
                  (w.z >= threshold) << 2 | (w.w >= threshold) << 3);
    group += step_groups;
    row += step_rows;
    if (group >= groups) {
      group -= groups;
      ++row;
    }
  }
}

// The keep bits of the warp's 16 rows from r0 against keys 0..8 NT - 1
// from the block's mask, in keep_bits' layout: bit 4 (n % 8) + e of word
// n / 8 for element e of key tile n.
template <int NT>
__device__ __forceinline__ void read_mask(uint32_t (&keep)[2],
                                          const uint8_t* mask, int r0,
                                          int lane) {
  const int t = lane & 3;
  const int shift = (t & 1) * 2;   // the lane's two keys of a group
  const uint8_t* upper = mask + (r0 + (lane >> 2)) * 2 * NT + (t >> 1);
  const uint8_t* lower = upper + 8 * 2 * NT;
  keep[0] = keep[1] = 0u;
#pragma unroll
  for (int n = 0; n < NT; ++n)
    keep[n >> 3] |= (((upper[2 * n] >> shift) & 3u) |
                     (((lower[2 * n] >> shift) & 3u) << 2))
                    << (4 * (n & 7));
}

__device__ __forceinline__ bool is_kept(const uint32_t (&keep)[2], int n,
                                        int e) {
  return (keep[n >> 3] >> (4 * (n & 7) + e)) & 1u;
}

template <int D, int NT>
__global__ void __launch_bounds__(NT * 16,
                                  wide_min_blocks(NT, wide_tc_fwd_bytes(NT)))
mhsa_short_fwd_tc_wide_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              __nv_bfloat16* __restrict__ o, int seq,
                              int heads, float scale_log2, uint32_t seed,
                              uint32_t threshold, float inv_keep) {
  extern __shared__ __align__(16) unsigned char tc_wide_shared[];
  constexpr int kTile = wide_tc_tile(NT);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tc_wide_shared);
  __nv_bfloat16* ks = qs + kTile;
  __nv_bfloat16* vs = ks + kTile;
  uint8_t* mask = reinterpret_cast<uint8_t*>(vs + kTile);

  const int frame = blockIdx.x / heads;
  const int head = blockIdx.x - frame * heads;
  const long long row_stride = (long long)heads * D;
  const long long base =
      (long long)frame * seq * row_stride + (long long)head * D;
  const int rows = wide_rows(seq);
  // Two groups: the scores need q and k, only P V needs v.
  load_tile<D>(qs, q + base, seq, rows, row_stride);
  load_tile<D>(ks, k + base, seq, rows, row_stride);
  cp_async_commit();
  load_tile<D>(vs, v + base, seq, rows, row_stride);
  cp_async_commit();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * 16;   // the warp's 16 query rows
  const bool active = r0 < seq;
  // The mask needs no data: it is drawn while the loads are in flight.
  if (threshold != 0u)
    draw_mask<NT>(mask, seed, frame, head, seq, threshold);
  cp_async_wait<1>();
  __syncthreads();
  float s[NT][4] = {};
  uint32_t keep[2] = {0xffffffffu, 0xffffffffu};
  if (active) {
    if (threshold != 0u) read_mask<NT>(keep, mask, r0, lane);
    row_products<D>(qs, ks, r0, lane, seq, s);
    softmax_rows(s, lane, seq, scale_log2);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!active) return;   // padding rows only; no barrier follows
  // Dropped (inv_keep is 1 without dropout) and rounded to bf16 where the
  // plain version rounds, as the A fragments of P V.
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[n][e] = is_kept(keep, n, e) ? s[n][e] * inv_keep : 0.f;
  uint32_t p[NT / 2][4];
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk)
    to_a_fragment(s[2 * kk], s[2 * kk + 1], p[kk]);
  float acc[D / 8][4] = {};
  times_tile<D>(p, vs, lane, seq, acc);
  // The warp's q rows are read by no one now: they stage its output.
  __nv_bfloat16* staging = qs + r0 * kTcStride;
  stage_rows<D>(acc, staging, lane);
  store_rows<D>(staging, o + base, r0, seq, row_stride, lane);
}

template <int D, int NT>
__global__ void __launch_bounds__(NT * 16,
                                  wide_min_blocks(NT, wide_tc_bwd_bytes(NT)))
mhsa_short_bwd_tc_wide_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ g,
                              __nv_bfloat16* __restrict__ dq,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int seq,
                              int heads, float scale, float scale_log2,
                              uint32_t seed, uint32_t threshold,
                              float inv_keep) {
  extern __shared__ __align__(16) unsigned char tc_wide_shared[];
  constexpr int kTile = wide_tc_tile(NT);
  constexpr int kP = wide_tc_pstride(NT);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tc_wide_shared);
  __nv_bfloat16* ks = qs + kTile;
  __nv_bfloat16* vs = ks + kTile;
  __nv_bfloat16* gs = vs + kTile;
  __nv_bfloat16* ps = gs + kTile;         // dropped (query, key)
  __nv_bfloat16* dss = ps + 8 * NT * kP;  // ds (query, key)
  uint8_t* mask = reinterpret_cast<uint8_t*>(dss + 8 * NT * kP);

  const int frame = blockIdx.x / heads;
  const int head = blockIdx.x - frame * heads;
  const long long row_stride = (long long)heads * D;
  const long long base =
      (long long)frame * seq * row_stride + (long long)head * D;
  const int rows = wide_rows(seq);
  // Two groups: the weights need q and k, dP = g v^T the other two.
  load_tile<D>(qs, q + base, seq, rows, row_stride);
  load_tile<D>(ks, k + base, seq, rows, row_stride);
  cp_async_commit();
  load_tile<D>(vs, v + base, seq, rows, row_stride);
  load_tile<D>(gs, g + base, seq, rows, row_stride);
  cp_async_commit();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;   // the warp's 16 query rows, then key rows
  const bool active = r0 < seq;
  // The mask needs no data: it is drawn while the loads are in flight.
  if (threshold != 0u)
    draw_mask<NT>(mask, seed, frame, head, seq, threshold);
  cp_async_wait<1>();
  __syncthreads();

  // Pass 1, a warp per 16 query rows: the weights, dP, ds, dq. Only the
  // weights stay in registers across the keys: dP = g v^T is computed a
  // pair of key tiles at a time, once for the row dot and again, the same
  // products in the same order, for ds.
  float w[NT][4] = {};
  uint32_t keep[2] = {0xffffffffu, 0xffffffffu};
  if (active) {
    if (threshold != 0u) read_mask<NT>(keep, mask, r0, lane);
    row_products<D>(qs, ks, r0, lane, seq, w);
    softmax_rows(w, lane, seq, scale_log2);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (active) {
    uint32_t gfrag[D / 16][4];
    a_fragments<D>(gs, r0, lane, gfrag);
    float dot0 = 0.f, dot1 = 0.f;   // rowsum(dw * w), rows r0 + gr (+ 8)
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      if (8 * n >= seq) break;   // the rest have w = 0
      float d[2][4] = {};
      pair_products<D>(gfrag, vs, n, lane, d[0], d[1]);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dw =
              is_kept(keep, n + m, e) ? d[m][e] * inv_keep : 0.f;
          if (e < 2)
            dot0 += dw * w[n + m][e];
          else
            dot1 += dw * w[n + m][e];
        }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      dot0 += __shfl_xor_sync(0xffffffffu, dot0, off);
      dot1 += __shfl_xor_sync(0xffffffffu, dot1, off);
    }
    // Padded query rows get zero dropped weights and ds, so that they add
    // nothing to dv and dk. Padded key columns have w = 0, hence ds = 0.
    const bool upper = r0 + gr < seq, lower = r0 + gr + 8 < seq;
    uint32_t ds_frag[NT / 2][4];
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      if (8 * n >= seq) break;   // times_tile stops at the same key
      float d[2][4] = {};
      pair_products<D>(gfrag, vs, n, lane, d[0], d[1]);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        float pv[4], dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool row_ok = e < 2 ? upper : lower;
          const bool keep_e = is_kept(keep, n + m, e);
          const float dw = keep_e ? d[m][e] * inv_keep : 0.f;
          pv[e] = row_ok && keep_e ? w[n + m][e] * inv_keep : 0.f;
          dsv[e] = row_ok ? w[n + m][e] * (dw - (e < 2 ? dot0 : dot1)) *
                                scale
                          : 0.f;
        }
        const uint32_t ds_upper = pack_bf16(dsv[0], dsv[1]);
        const uint32_t ds_lower = pack_bf16(dsv[2], dsv[3]);
        // As to_a_fragment lays out key tiles n and n + 1.
        ds_frag[n >> 1][2 * m] = ds_upper;
        ds_frag[n >> 1][2 * m + 1] = ds_lower;
        const int at = (r0 + gr) * kP + 8 * (n + m) + 2 * t;
        *reinterpret_cast<uint32_t*>(ps + at) = pack_bf16(pv[0], pv[1]);
        *reinterpret_cast<uint32_t*>(ps + at + 8 * kP) =
            pack_bf16(pv[2], pv[3]);
        *reinterpret_cast<uint32_t*>(dss + at) = ds_upper;
        *reinterpret_cast<uint32_t*>(dss + at + 8 * kP) = ds_lower;
      }
    }
    float acc[D / 8][4] = {};
    times_tile<D>(ds_frag, ks, lane, seq, acc);   // dq = ds k
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      __nv_bfloat16* at = dq + base + 8 * n + 2 * t;
      if (upper)
        *reinterpret_cast<uint32_t*>(at + (r0 + gr) * row_stride) =
            pack_bf16(acc[n][0], acc[n][1]);
      if (lower)
        *reinterpret_cast<uint32_t*>(at + (r0 + gr + 8) * row_stride) =
            pack_bf16(acc[n][2], acc[n][3]);
    }
  }
  __syncthreads();
  if (!active) return;   // no barrier follows

  // Pass 2, a warp per 16 key rows j from r0: dv = P^T g, dk = ds^T q.
  float acc_v[D / 8][4] = {}, acc_k[D / 8][4] = {};
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {   // query rows 16kk..16kk+15
    if (16 * kk >= seq) break;
    // The A fragments of P^T and ds^T: P and ds read transposed.
    const int at = (16 * kk + (lane & 7) + ((lane >> 4) << 3)) * kP + r0 +
                   ((lane >> 3) & 1) * 8;
    uint32_t a_p[4], a_ds[4];
    ldsm_x4_trans(ps + at, a_p);
    ldsm_x4_trans(dss + at, a_ds);
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      const int bt =
          (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kTcStride + 8 * n +
          (lane >> 4) * 8;
      uint32_t bf[4];
      ldsm_x4_trans(gs + bt, bf);
      mma_bf16(acc_v[n], a_p, bf[0], bf[1]);
      mma_bf16(acc_v[n + 1], a_p, bf[2], bf[3]);
      ldsm_x4_trans(qs + bt, bf);
      mma_bf16(acc_k[n], a_ds, bf[0], bf[1]);
      mma_bf16(acc_k[n + 1], a_ds, bf[2], bf[3]);
    }
  }
  // k and v are read by no one in this pass: their rows r0.. stage dk and
  // dv.
  stage_rows<D>(acc_k, ks + r0 * kTcStride, lane);
  stage_rows<D>(acc_v, vs + r0 * kTcStride, lane);
  store_rows<D>(ks + r0 * kTcStride, dk + base, r0, seq, row_stride, lane);
  store_rows<D>(vs + r0 * kTcStride, dv + base, r0, seq, row_stride, lane);
}

template <int D, int NT>
int launch_fwd_tc_wide(const void* q, const void* k, const void* v, void* o,
                       int batch, int seq, int heads, float scale,
                       uint32_t seed, uint32_t threshold, float inv_keep,
                       cudaStream_t stream) {
  return launch_shared(
      mhsa_short_fwd_tc_wide_kernel<D, NT>, dim3((unsigned)(batch * heads)),
      dim3(NT * 16), wide_tc_fwd_bytes(NT), stream,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      seq, heads, scale * 1.4426950408889634f, seed, threshold, inv_keep);
}

template <int D, int NT>
int launch_bwd_tc_wide(const void* q, const void* k, const void* v,
                       const void* g, void* dq, void* dk, void* dv, int batch,
                       int seq, int heads, float scale, uint32_t seed,
                       uint32_t threshold, float inv_keep,
                       cudaStream_t stream) {
  return launch_shared(
      mhsa_short_bwd_tc_wide_kernel<D, NT>, dim3((unsigned)(batch * heads)),
      dim3(NT * 16), wide_tc_bwd_bytes(NT), stream,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(dq),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), seq,
      heads, scale, scale * 1.4426950408889634f, seed, threshold, inv_keep);
}

// Calls f(D, NT) as std::integral_constant values for the wide tc
// instantiation that takes ``seq`` keys of width ``head_dim``: NT =
// wide_key_tiles(seq), one of 8, 10, 12, 14, 16.
template <int D, typename F>
int with_key_tiles(int seq, F&& f) {
  const std::integral_constant<int, D> d;
  switch (wide_key_tiles(seq)) {
    case 8:
      return f(d, std::integral_constant<int, 8>());
    case 10:
      return f(d, std::integral_constant<int, 10>());
    case 12:
      return f(d, std::integral_constant<int, 12>());
    case 14:
      return f(d, std::integral_constant<int, 14>());
    default:
      return f(d, std::integral_constant<int, 16>());
  }
}

template <typename F>
int with_tc_wide(int seq, int head_dim, F&& f) {
  switch (head_dim) {
    case 16:
      return with_key_tiles<16>(seq, f);
    case 32:
      return with_key_tiles<32>(seq, f);
    case 48:
      return with_key_tiles<48>(seq, f);
    default:
      return with_key_tiles<64>(seq, f);
  }
}

// What the runtime reports of ``kernel``, launched as blocks of ``threads``
// with ``bytes`` of dynamic shared memory, on the current device: out[0]
// ``tiles``, out[1] ``threads``, out[2] registers a thread, out[3]
// ``bytes``, out[4] local memory a thread (spills among it), out[5] the
// blocks an SM holds at once.
template <typename Kernel>
int kernel_info(Kernel kernel, int tiles, int threads, int bytes, int* out) {
  cudaFuncAttributes attr;
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, bytes);
  if (err != cudaSuccess) return (int)err;
  const int info[] = {tiles, threads, attr.numRegs, bytes,
                      (int)attr.localSizeBytes, blocks};
  for (int i = 0; i < 6; ++i) out[i] = info[i];
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. All tensors are contiguous (batch, seq,
// heads * head_dim) on the current device; the launch goes to ``stream``
// and does not synchronise. ``rate`` is the dropout rate in [0, 1) (0
// turns dropout off); the entry derives the kernels' u32 cutoff and keep
// scale from it (dropout_args), and the scores' scale 1 / sqrt(head_dim).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape or rate the kernel does not take).
extern "C" int mhsa_short_fwd(const void* q, const void* k, const void* v,
                              void* o, int batch, int seq, int heads,
                              int head_dim, int dtype, unsigned int seed,
                              double rate, void* stream) {
  if (bad_shape(batch, seq, heads, head_dim) || bad_rate(rate))
    return (int)cudaErrorInvalidValue;
  const DropoutArgs drop = dropout_args(rate);
  const float scale = score_scale(head_dim);
  const dim3 grid((unsigned)(batch * heads));
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    mhsa_short_fwd_scalar_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), seq, heads,
        head_dim, scale, seed, drop.threshold, drop.inv_keep);
  } else if (dtype == 1) {
    mhsa_short_fwd_scalar_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        seq, heads, head_dim, scale, seed, drop.threshold, drop.inv_keep);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The backward: q, k, v and the output's gradient g in, dq, dk, dv out, all
// of one shape and dtype; seed and rate as the forward got them.
extern "C" int mhsa_short_bwd(const void* q, const void* k, const void* v,
                              const void* g, void* dq, void* dk, void* dv,
                              int batch, int seq, int heads, int head_dim,
                              int dtype, unsigned int seed, double rate,
                              void* stream) {
  if (bad_shape(batch, seq, heads, head_dim) || bad_rate(rate))
    return (int)cudaErrorInvalidValue;
  const DropoutArgs drop = dropout_args(rate);
  const float scale = score_scale(head_dim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd_scalar<float>(q, k, v, g, dq, dk, dv, batch, seq, heads,
                                    head_dim, scale, seed, drop.threshold,
                                    drop.inv_keep, s);
  if (dtype == 1)
    return launch_bwd_scalar<__nv_bfloat16>(
        q, k, v, g, dq, dk, dv, batch, seq, heads, head_dim, scale, seed,
        drop.threshold, drop.inv_keep, s);
  return (int)cudaErrorInvalidValue;
}

// The tc variant, bf16 only (dtype must be 1) with head_dim a multiple of
// 16 up to 64, and every pointer 16-byte aligned; otherwise as
// mhsa_short_fwd.
extern "C" int mhsa_short_tc_fwd(const void* q, const void* k, const void* v,
                                 void* o, int batch, int seq, int heads,
                                 int head_dim, int dtype, unsigned int seed,
                                 double rate, void* stream) {
  if (bad_shape(batch, seq, heads, head_dim) || bad_tc(dtype, head_dim) ||
      bad_rate(rate))
    return (int)cudaErrorInvalidValue;
  const DropoutArgs drop = dropout_args(rate);
  const float scale = score_scale(head_dim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch_fwd_tc<16>(q, k, v, o, batch, seq, heads, scale, seed,
                               drop.threshold, drop.inv_keep, s);
    case 32:
      return launch_fwd_tc<32>(q, k, v, o, batch, seq, heads, scale, seed,
                               drop.threshold, drop.inv_keep, s);
    case 48:
      return launch_fwd_tc<48>(q, k, v, o, batch, seq, heads, scale, seed,
                               drop.threshold, drop.inv_keep, s);
    default:
      return launch_fwd_tc<64>(q, k, v, o, batch, seq, heads, scale, seed,
                               drop.threshold, drop.inv_keep, s);
  }
}

// The tc variant of the backward, under the same conditions.
extern "C" int mhsa_short_tc_bwd(const void* q, const void* k, const void* v,
                                 const void* g, void* dq, void* dk, void* dv,
                                 int batch, int seq, int heads, int head_dim,
                                 int dtype, unsigned int seed, double rate,
                                 void* stream) {
  if (bad_shape(batch, seq, heads, head_dim) || bad_tc(dtype, head_dim) ||
      bad_rate(rate))
    return (int)cudaErrorInvalidValue;
  const DropoutArgs drop = dropout_args(rate);
  const float scale = score_scale(head_dim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch_bwd_tc<16>(q, k, v, g, dq, dk, dv, batch, seq, heads,
                               scale, seed, drop.threshold, drop.inv_keep, s);
    case 32:
      return launch_bwd_tc<32>(q, k, v, g, dq, dk, dv, batch, seq, heads,
                               scale, seed, drop.threshold, drop.inv_keep, s);
    case 48:
      return launch_bwd_tc<48>(q, k, v, g, dq, dk, dv, batch, seq, heads,
                               scale, seed, drop.threshold, drop.inv_keep, s);
    default:
      return launch_bwd_tc<64>(q, k, v, g, dq, dk, dv, batch, seq, heads,
                               scale, seed, drop.threshold, drop.inv_keep, s);
  }
}

// The wide instantiation (1 <= seq <= 128; the wrapper takes it for
// 64 < seq), scalar: float32 or bfloat16, any head_dim up to 64; otherwise
// as mhsa_short_fwd.
extern "C" int mhsa_short_wide_fwd(const void* q, const void* k,
                                   const void* v, void* o, int batch,
                                   int seq, int heads, int head_dim,
                                   int dtype, unsigned int seed, double rate,
                                   void* stream) {
  if (bad_wide_shape(batch, seq, heads, head_dim) || bad_rate(rate))
    return (int)cudaErrorInvalidValue;
  const DropoutArgs drop = dropout_args(rate);
  const float scale = score_scale(head_dim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd_scalar_wide<float>(q, k, v, o, batch, seq, heads,
                                         head_dim, scale, seed,
                                         drop.threshold, drop.inv_keep, s);
  if (dtype == 1)
    return launch_fwd_scalar_wide<__nv_bfloat16>(
        q, k, v, o, batch, seq, heads, head_dim, scale, seed, drop.threshold,
        drop.inv_keep, s);
  return (int)cudaErrorInvalidValue;
}

// The wide scalar backward, under the same conditions.
extern "C" int mhsa_short_wide_bwd(const void* q, const void* k,
                                   const void* v, const void* g, void* dq,
                                   void* dk, void* dv, int batch, int seq,
                                   int heads, int head_dim, int dtype,
                                   unsigned int seed, double rate,
                                   void* stream) {
  if (bad_wide_shape(batch, seq, heads, head_dim) || bad_rate(rate))
    return (int)cudaErrorInvalidValue;
  const DropoutArgs drop = dropout_args(rate);
  const float scale = score_scale(head_dim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd_scalar_wide<float>(q, k, v, g, dq, dk, dv, batch, seq,
                                         heads, head_dim, scale, seed,
                                         drop.threshold, drop.inv_keep, s);
  if (dtype == 1)
    return launch_bwd_scalar_wide<__nv_bfloat16>(
        q, k, v, g, dq, dk, dv, batch, seq, heads, head_dim, scale, seed,
        drop.threshold, drop.inv_keep, s);
  return (int)cudaErrorInvalidValue;
}

// The wide instantiation of the tc variant: bf16, head_dim a multiple of 16
// up to 64, 1 <= seq <= 128, every pointer 16-byte aligned. The kernels'
// instantiation is picked from seq (wide_key_tiles).
extern "C" int mhsa_short_tc_wide_fwd(const void* q, const void* k,
                                      const void* v, void* o, int batch,
                                      int seq, int heads, int head_dim,
                                      int dtype, unsigned int seed,
                                      double rate, void* stream) {
  if (bad_wide_shape(batch, seq, heads, head_dim) ||
      bad_tc(dtype, head_dim) || bad_rate(rate))
    return (int)cudaErrorInvalidValue;
  const DropoutArgs drop = dropout_args(rate);
  const float scale = score_scale(head_dim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_tc_wide(seq, head_dim, [&](auto d, auto nt) {
    return launch_fwd_tc_wide<decltype(d)::value, decltype(nt)::value>(
        q, k, v, o, batch, seq, heads, scale, seed, drop.threshold,
        drop.inv_keep, s);
  });
}

// The wide tc backward, under the same conditions.
extern "C" int mhsa_short_tc_wide_bwd(const void* q, const void* k,
                                      const void* v, const void* g, void* dq,
                                      void* dk, void* dv, int batch, int seq,
                                      int heads, int head_dim, int dtype,
                                      unsigned int seed, double rate,
                                      void* stream) {
  if (bad_wide_shape(batch, seq, heads, head_dim) ||
      bad_tc(dtype, head_dim) || bad_rate(rate))
    return (int)cudaErrorInvalidValue;
  const DropoutArgs drop = dropout_args(rate);
  const float scale = score_scale(head_dim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_tc_wide(seq, head_dim, [&](auto d, auto nt) {
    return launch_bwd_tc_wide<decltype(d)::value, decltype(nt)::value>(
        q, k, v, g, dq, dk, dv, batch, seq, heads, scale, seed,
        drop.threshold, drop.inv_keep, s);
  });
}

// What the runtime reports of the wide tc kernel (the forward, or the
// backward where ``backward`` is not 0) that the entries above launch for
// ``seq`` keys of width ``head_dim``, on the current device; out[0..5] as
// kernel_info fills them, out[0] the key tiles wide_key_tiles picks.
// Launches nothing.
extern "C" int mhsa_short_tc_wide_info(int seq, int head_dim, int backward,
                                       int* out) {
  if (bad_wide_shape(1, seq, 1, head_dim) || bad_tc(1, head_dim))
    return (int)cudaErrorInvalidValue;
  return with_tc_wide(seq, head_dim, [&](auto d, auto nt) {
    constexpr int D = decltype(d)::value, NT = decltype(nt)::value;
    return backward ? kernel_info(mhsa_short_bwd_tc_wide_kernel<D, NT>, NT,
                                  NT * 16, wide_tc_bwd_bytes(NT), out)
                    : kernel_info(mhsa_short_fwd_tc_wide_kernel<D, NT>, NT,
                                  NT * 16, wide_tc_fwd_bytes(NT), out);
  });
}
