// Standalone elementwise dropout with counter-based bits, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel videocad_tpu/ops/dropout.py:_dropout_kernel
// (hw_dropout -> _dropout_pallas -> pl.pallas_call). It computes the same
// function: y = bits >= threshold ? x * 1/(1 - rate) : 0, with a u32
// threshold (P(drop) == rate exactly), the product taken in f32 and rounded
// once to the I/O dtype, and no mask stored: the backward is this kernel
// run on the cotangent with the same seed.
//
// The bits. The TPU kernel seeds a hardware generator per grid step, so its
// mask depends on how the tensor was cut into blocks. Here the bits of flat
// element e are word e % 4 of Philox4x32-10 with key (seed, 1) and counter
// (low 32 bits of e / 4, high 32 bits of e / 4, 0, 0): a function of the
// seed and the element's row-major index only, so the mask is the same for
// every grid, the mask of a tensor's flat prefix is the prefix of its mask,
// and the backward redraws the forward's mask from the seed alone. The key's
// second word keeps these streams apart from the attention kernels', which
// use key (seed, 0) (csrc/mhsa_short.cu).
// videocad_tpu_torch/ops/prng.py:elementwise_bits computes the same
// function in PyTorch integer ops for the plain version.
//
// What bounds it on the card: bytes, nominally. One read and one write per
// element: 156 MB for the ViT's (1,528, 50, 512) bf16 token tensor, 0.047 ms
// at 3.35 TB/s. Philox costs about 40 integer multiplies per four elements,
// which this simple kernel does not hide behind the loads.
//
// What the design does about it: one thread per four neighbouring elements,
// so one Philox call serves four elements, read and written as one 8-byte
// (bf16) or 16-byte (f32) access with neighbouring threads on neighbouring
// addresses; a grid-stride loop over the groups; a ragged tail or unaligned
// pointers take scalar accesses in the same kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

// Philox4x32-10, key (seed, 1), counter (group low, group high, 0, 0).
__device__ __forceinline__ void philox_group(uint32_t seed,
                                             unsigned long long group,
                                             uint32_t (&out)[4]) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
  uint32_t c0 = (uint32_t)group, c1 = (uint32_t)(group >> 32);
  uint32_t c2 = 0u, c3 = 0u;
  uint32_t k0 = seed, k1 = 1u;
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);   // round to nearest even
}

// Four elements as one aligned access.
struct alignas(8) Bf16x4 { __nv_bfloat16 v[4]; };
struct alignas(16) F32x4 { float v[4]; };
template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = F32x4; };
template <> struct Vec4<__nv_bfloat16> { using type = Bf16x4; };

template <typename T>
__global__ void __launch_bounds__(kThreads)
hw_dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                  bool vector_ok, uint32_t seed, uint32_t threshold,
                  float inv_keep) {
  using V = typename Vec4<T>::type;
  const long long groups = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long group = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       group < groups; group += stride) {
    uint32_t bits[4];
    philox_group(seed, (unsigned long long)group, bits);
    const long long base = 4 * group;
    if (vector_ok && base + 4 <= n) {
      const V in = *reinterpret_cast<const V*>(x + base);
      V out;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        from_f32(bits[i] >= threshold ? __fmul_rn(to_f32(in.v[i]), inv_keep)
                                      : 0.f,
                 &out.v[i]);
      *reinterpret_cast<V*>(y + base) = out;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (base + i < n)
          from_f32(bits[i] >= threshold
                       ? __fmul_rn(to_f32(x[base + i]), inv_keep)
                       : 0.f,
                   y + base + i);
    }
  }
}

}  // namespace

// x, y: contiguous, n elements of dtype 0 = float32 or 1 = bfloat16, on the
// current device, not overlapping. The launch goes to ``stream`` and does not
// synchronise. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a size or dtype it does not take.
extern "C" int hw_dropout(const void* x, void* y, long long n, int dtype,
                          unsigned int seed, unsigned int threshold,
                          float inv_keep, void* stream) {
  if (n < 1 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long groups = (n + 3) / 4;
  const long long want = (groups + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
  const uintptr_t align = dtype == 1 ? 8 : 16;
  const bool vector_ok = reinterpret_cast<uintptr_t>(x) % align == 0 &&
                         reinterpret_cast<uintptr_t>(y) % align == 0;
  if (dtype == 1) {
    hw_dropout_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        n, vector_ok, seed, threshold, inv_keep);
  } else {
    hw_dropout_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, vector_ok,
        seed, threshold, inv_keep);
  }
  return (int)cudaGetLastError();
}
