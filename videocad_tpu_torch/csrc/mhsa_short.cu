// Fused bidirectional multi-head self-attention for short sequences: the
// forward of the ViT's attention core, for Hopper (sm_90a).
//
// Replaces the TPU kernel videocad_tpu/ops/fused_attention.py:_fwd_kernel
// (reached through mhsa_short -> _mhsa_fwd -> pl.pallas_call). It computes
// the same function:
//   q, k, v arrive as (B, T, H*D), the layout the projections produce;
//   scores = q k^T accumulated in f32, times 1/sqrt(D);
//   a row softmax in f32;
//   the weights are rounded to the I/O dtype before the P V product;
//   P V accumulated in f32; the output is written in the I/O dtype, back
//   in (B, T, H*D).
// No masking (the ViT is bidirectional) and no dropout (inference only;
// the backward and in-kernel dropout come with the training slices).
//
// What bounds it on the card: per head it does about 4*T*T*D flops
// against 4*T*D*2 bytes of bf16 I/O (q, k, v in, o out), i.e. about T/2 =
// 25 flops per byte at the flagship's T = 50, D = 64. At the serving batch
// (B = 1 to 8 frames, 16 to 128 heads) the whole call is a few hundred KB
// and is bound by latency; at the rollout's B*T = 1,496 frames (24k heads,
// 613 MB of bf16 I/O, 15 GFLOP) the floor is about 0.18 ms of memory
// traffic at 3.35 TB/s, and this simple kernel is bound well above it by
// the issue rate of its scalar f32 math (two shared-memory loads per FMA).
//
// What the design does about it: one thread block per (frame, head) keeps
// each head's K and V in shared memory (as f32) for the whole softmax, so
// the (T, T) scores and weights never touch device memory, and q, k, v and
// o are each read or written exactly once, by strided reads of the head's
// D columns straight from the (B, T, H*D) tensors: no transpose outside
// the kernel. One warp owns one query row at a time: each lane holds the
// scores of keys lane and lane + 32 (T <= 64, so T is padded to 64 and the
// padded key columns are excluded from the softmax), the row max and sum
// are warp shuffles, and the P V product runs one output column per lane.
// Tensor-core math (mma.sync / wgmma) and several heads per block are the
// later steps to make it fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxSeq = 64;    // T padded to 64: two key columns per lane
constexpr int kMaxHeadDim = 64;
constexpr int kWarps = 4;

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

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
mhsa_short_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int seq,
                      int heads, int head_dim, float scale) {
  // K rows padded by one column: lane j reads row j, so a stride of
  // 65 words puts the 32 lanes of a warp on 32 different banks.
  __shared__ float ks[kMaxSeq][kMaxHeadDim + 1];
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
    ks[t][d] = to_f32(k[off]);
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

    float s0 = -INFINITY;
    float s1 = -INFINITY;
    if (j0 < seq) {
      float acc = 0.f;
      for (int d = 0; d < head_dim; ++d) acc = fmaf(qs[warp][d], ks[j0][d], acc);
      s0 = acc * scale;
    }
    if (j1 < seq) {
      float acc = 0.f;
      for (int d = 0; d < head_dim; ++d) acc = fmaf(qs[warp][d], ks[j1][d], acc);
      s1 = acc * scale;
    }
    const float m = warp_max(fmaxf(s0, s1));
    const float e0 = j0 < seq ? expf(s0 - m) : 0.f;
    const float e1 = j1 < seq ? expf(s1 - m) : 0.f;
    const float sum = warp_sum(e0 + e1);
    // The weights drop to the I/O dtype before the P V product, as the TPU
    // kernel and the JAX reference path do.
    if (j0 < seq) ps[warp][j0] = to_f32(from_f32<T>(e0 / sum));
    if (j1 < seq) ps[warp][j1] = to_f32(from_f32<T>(e1 / sum));
    __syncwarp();

    for (int d = lane; d < head_dim; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < seq; ++j) acc = fmaf(ps[warp][j], vs[j][d], acc);
      o[row + d] = from_f32<T>(acc);
    }
    __syncwarp();  // qs and ps are rewritten by this warp's next row
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. All four tensors are contiguous
// (batch, seq, heads * head_dim) on the current device; the launch goes to
// ``stream`` and does not synchronise. Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int mhsa_short_fwd(const void* q, const void* k, const void* v,
                              void* o, int batch, int seq, int heads,
                              int head_dim, float scale, int dtype,
                              void* stream) {
  if (batch < 1 || seq < 1 || seq > kMaxSeq || heads < 1 || head_dim < 1 ||
      head_dim > kMaxHeadDim || (long long)batch * heads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(batch * heads));
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    mhsa_short_fwd_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), seq, heads,
        head_dim, scale);
  } else if (dtype == 1) {
    mhsa_short_fwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        seq, heads, head_dim, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
