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
// What bounds it on the card: bytes, if the integer work hides under them.
// One read and one write per element: 156 MB for the ViT's (1,528, 50, 512)
// bf16 token tensor, 0.047 ms at 3.35 TB/s. Philox4x32-10 costs ten rounds
// of two 32 x 32 -> 64-bit multiplies per four elements: for those 39 M
// elements about as long as the bytes take. The first version gave each
// thread one group of four elements an iteration, an 8-byte access and then
// ten dependent rounds, so the loads and the multiplies barely overlapped
// (71% of the bound).
//
// What the design does about it: every access is 16 bytes (one uint4:
// eight bf16 elements and two Philox counters, or four float32 elements and
// one), neighbouring threads on neighbouring addresses, and the grid has
// one thread for each 16-byte unit. A thread issues its load before its
// first Philox round, and at 28-32 registers a thread the SM holds enough
// warps that some are always loading while others multiply. Measured on an
// H100 at (1,528, 50, 512) bf16 (CUDA events, PERF.md section 6):
// 0.0557-0.0565 ms, where a persistent grid of resident blocks walking the
// tensor took 0.0644 with 4 units a thread and 0.063-0.066 with the next
// iteration's loads issued before the current one's rounds, and 2 or 4
// units a thread in the full grid no less than 0.0563. Where the pointers
// are not 16-byte aligned, and for the ragged tail past the last whole
// unit, the same kernel takes one Philox call per group of four elements
// and scalar accesses; the bits of an element depend on its index only, so
// the two paths draw one mask.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Philox4x32-10, key (seed, 1), counter (group low, group high, 0, 0).
__device__ __forceinline__ void philox_group(uint32_t seed,
                                             unsigned long long group,
                                             uint32_t* out) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
  uint32_t c0 = (uint32_t)group, c1 = (uint32_t)(group >> 32);
  uint32_t c2 = 0u, c3 = 0u;
  uint32_t k0 = seed, k1 = 1u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const unsigned long long p0 = (unsigned long long)kM0 * c0;
    const unsigned long long p1 = (unsigned long long)kM1 * c2;
    c0 = (uint32_t)(p1 >> 32) ^ c1 ^ k0;
    c1 = (uint32_t)p1;
    c2 = (uint32_t)(p0 >> 32) ^ c3 ^ k1;
    c3 = (uint32_t)p0;
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

// One 16-byte unit: its elements as f32, and back.
template <typename T> struct Unit;
template <> struct Unit<float> {
  static constexpr int kElems = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};
template <> struct Unit<__nv_bfloat16> {
  static constexpr int kElems = 8;
  // Element 2i is the low half of word i (little-endian pairs).
  static __device__ __forceinline__ void unpack(const uint4& r, float* v) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // round to nearest even
      const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Unit ``unit`` of the flat tensor (elements unit * kElems onwards).
template <typename T>
__device__ __forceinline__ uint4 drop_unit(const uint4& raw, long long unit,
                                           uint32_t seed, uint32_t threshold,
                                           float inv_keep) {
  constexpr int kElems = Unit<T>::kElems;
  float v[kElems];
  uint32_t bits[kElems];
  Unit<T>::unpack(raw, v);
#pragma unroll
  for (int g = 0; g < kElems / 4; ++g)
    philox_group(seed, (unsigned long long)unit * (kElems / 4) + g,
                 bits + 4 * g);
#pragma unroll
  for (int i = 0; i < kElems; ++i)
    v[i] = bits[i] >= threshold ? __fmul_rn(v[i], inv_keep) : 0.f;
  return Unit<T>::pack(v);
}

// Thread t of the grid owns unit t where the pointers are 16-byte
// aligned (after the last whole unit, the groups of four that are left, one
// a thread), or group t of four elements where they are not.
template <typename T>
__global__ void __launch_bounds__(kThreads)
hw_dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                  bool vector_ok, uint32_t seed, uint32_t threshold,
                  float inv_keep) {
  constexpr int kElems = Unit<T>::kElems;
  const long long thread = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long group = thread;
  if (vector_ok) {
    const long long units = n / kElems;
    if (thread < units) {
      reinterpret_cast<uint4*>(y)[thread] = drop_unit<T>(
          __ldg(reinterpret_cast<const uint4*>(x) + thread), thread, seed,
          threshold, inv_keep);
      return;
    }
    group = units * (kElems / 4) + (thread - units);
  }
  // Scalar accesses, one Philox call per group of four elements.
  if (4 * group >= n) return;
  uint32_t bits[4];
  philox_group(seed, (unsigned long long)group, bits);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long e = 4 * group + i;
    if (e < n)
      from_f32(bits[i] >= threshold ? __fmul_rn(to_f32(x[e]), inv_keep)
                                    : 0.f,
               y + e);
  }
}

template <typename T>
int launch(const void* x, void* y, long long n, unsigned seed, double rate,
           cudaStream_t s) {
  const bool vector_ok = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(y) % 16 == 0;
  // A thread for each whole unit and each group of four after them, or
  // for each group of four.
  constexpr int kElems = Unit<T>::kElems;
  const long long units = vector_ok ? n / kElems : 0;
  const long long threads = units + (n - units * kElems + 3) / 4;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  // The threshold and scale exactly as ops/prng.py:dropout_threshold and
  // ops/dropout.py compute them: floor(rate * 2^32) and 1 / (1 - rate) in
  // double, rounded once to float.
  const double scaled = rate * 4294967296.0;
  const uint32_t threshold =
      scaled >= 4294967295.0 ? 0xFFFFFFFFu : (uint32_t)scaled;
  const float inv_keep = (float)(1.0 / (1.0 - rate));
  hw_dropout_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, vector_ok, seed,
      threshold, inv_keep);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: contiguous, n elements of dtype 0 = float32 or 1 = bfloat16, on the
// current device, not overlapping; rate in [0, 1). The launch goes to
// ``stream`` and does not synchronise. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a size, dtype or rate it does not
// take.
extern "C" int hw_dropout(const void* x, void* y, long long n, int dtype,
                          unsigned int seed, double rate, void* stream) {
  if (n < 1 || (dtype != 0 && dtype != 1) || !(rate >= 0.0 && rate < 1.0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(x, y, n, seed, rate, s)
                    : launch<float>(x, y, n, seed, rate, s);
}
