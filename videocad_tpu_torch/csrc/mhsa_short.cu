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
// their grids and blocks. videocad_tpu_torch/ops/prng.py computes the same
// function in PyTorch integer ops for the plain versions.
//
// What bounds them on the card: per head the forward does about 4*T*T*D
// flops against 4*T*D*2 bytes of bf16 I/O (q, k, v in, o out), about T/2 =
// 25 flops per byte at the flagship's T = 50, D = 64; the backward does
// 10*T*T*D flops against 7*T*D*2 bytes, about 36 flops per byte. Both are
// below the card's ridge (about 295 flops per byte in bf16), so the floor
// is memory traffic: at the train step's 1,528 frames 0.19 ms for the
// forward and 0.33 ms for the backward at 3.35 TB/s. These simple kernels
// are bound well above that by the issue rate of their scalar f32 math
// (two shared-memory loads per FMA) and, with dropout, of the integer
// multiplies of Philox.
//
// What the design does about it: one thread block per (frame, head) owns
// its head wholly. It keeps the head's operands in shared memory as f32
// for the whole computation, so the (T, T) scores, weights and ds never
// touch device memory, every input is read once and every output written
// once, by strided accesses to the head's D columns of the (B, T, H*D)
// tensors (no transpose outside the kernel), and dq, dk and dv need no
// atomics. One warp owns one query row at a time: each lane holds the
// scores of keys lane and lane + 32 (T <= 64, so T is padded to 64 and the
// padded key columns are excluded from the softmax and get zero weight
// and zero ds; padded query rows are never computed or written), the row
// reductions are warp shuffles, and the products that follow run one
// output column per lane. The backward's second pass (dv and dk, which sum
// over query rows) runs one warp per key row over the (T, T) dropped
// weights and ds that the first pass left in shared memory. Its operands
// take 78 KB at T = 50, D = 64, over the 48 KB a block gets by default, so
// the launch opts in to more dynamic shared memory. Tensor-core math
// (mma.sync / wgmma), several heads per block and sharing one Philox call
// among the four lanes that need its words are the later steps to make
// them fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
  uint32_t c0 = j >> 2, c1 = i, c2 = h, c3 = b;
  uint32_t k0 = seed, k1 = 0u;
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
mhsa_short_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int seq,
                      int heads, int head_dim, float scale, uint32_t seed,
                      uint32_t threshold, float inv_keep) {
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
mhsa_short_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ g,
                      T* __restrict__ dq, T* __restrict__ dk,
                      T* __restrict__ dv, int seq, int heads, int head_dim,
                      float scale, uint32_t seed, uint32_t threshold,
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
int launch_bwd(const void* q, const void* k, const void* v, const void* g,
               void* dq, void* dk, void* dv, int batch, int seq, int heads,
               int head_dim, float scale, uint32_t seed, uint32_t threshold,
               float inv_keep, cudaStream_t stream) {
  const int bytes = bwd_shared_floats(seq) * (int)sizeof(float);
  // Above the 48 KB a block gets by default: opt in, and report a refusal.
  cudaError_t err = cudaFuncSetAttribute(
      mhsa_short_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  mhsa_short_bwd_kernel<T>
      <<<dim3((unsigned)(batch * heads)), dim3(kBwdWarps * 32), bytes,
         stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v), static_cast<const T*>(g),
                   static_cast<T*>(dq), static_cast<T*>(dk),
                   static_cast<T*>(dv), seq, heads, head_dim, scale, seed,
                   threshold, inv_keep);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. All tensors are contiguous (batch, seq,
// heads * head_dim) on the current device; the launch goes to ``stream``
// and does not synchronise. ``threshold`` is the u32 dropout cutoff (bits
// below it are dropped; 0 turns dropout off) and ``inv_keep`` is
// 1 / (1 - rate). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int mhsa_short_fwd(const void* q, const void* k, const void* v,
                              void* o, int batch, int seq, int heads,
                              int head_dim, float scale, int dtype,
                              unsigned int seed, unsigned int threshold,
                              float inv_keep, void* stream) {
  if (bad_shape(batch, seq, heads, head_dim))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(batch * heads));
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    mhsa_short_fwd_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), seq, heads,
        head_dim, scale, seed, threshold, inv_keep);
  } else if (dtype == 1) {
    mhsa_short_fwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        seq, heads, head_dim, scale, seed, threshold, inv_keep);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The backward: q, k, v and the output's gradient g in, dq, dk, dv out, all
// of one shape and dtype; seed, threshold and inv_keep as the forward got
// them.
extern "C" int mhsa_short_bwd(const void* q, const void* k, const void* v,
                              const void* g, void* dq, void* dk, void* dv,
                              int batch, int seq, int heads, int head_dim,
                              float scale, int dtype, unsigned int seed,
                              unsigned int threshold, float inv_keep,
                              void* stream) {
  if (bad_shape(batch, seq, heads, head_dim))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(q, k, v, g, dq, dk, dv, batch, seq, heads,
                             head_dim, scale, seed, threshold, inv_keep, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(q, k, v, g, dq, dk, dv, batch, seq,
                                     heads, head_dim, scale, seed, threshold,
                                     inv_keep, s);
  return (int)cudaErrorInvalidValue;
}
