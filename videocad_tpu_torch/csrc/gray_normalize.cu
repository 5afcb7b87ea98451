// uint8 frames -> normalized grayscale in one pass, with an optional
// bilinear resize, for Hopper (sm_90a).
//
// Replaces the TPU kernels videocad_tpu/ops/preprocess.py:_gray_kernel and
// :_gray_resize_kernel (grayscale_normalize_pallas -> pl.pallas_call).
// They compute the same functions:
//   gray = (x0 * w0 + x1 * w1) + x2 * w2 over the three stored channels in
//   their stored order (the positional luma weights), in f32;
//   gray_normalize:        out = gray / 127.5 - 1;
//   gray_resize_normalize: the half-pixel bilinear resize of gray to
//   (OH, OW) first, rows blended before columns, as the TPU kernel's
//   rh @ gray then . rw^T does, then the same normalization.
// (N, H, W, 3) u8 in, (N, H', W', 1) f32 out.
//
// What bounds them on the card: bytes. 3 bytes in and 4 out per pixel and
// a handful of flops: at the train step's 1,536 frames of 224 x 224 that
// is 231 MB in and 308 MB out, 0.16 ms at 3.35 TB/s.
//
// What the design does about it: gray_normalize gives each thread four
// neighbouring pixels, read as three 32-bit words and written as one
// 16-byte store, so a warp's loads and stores are contiguous; the sum uses
// separate multiplies and adds (no FMA contraction) in the plain PyTorch
// version's order, so the two agree to the last bit of gray. The resize
// kernel does not multiply by the dense (OH, H) and (OW, W) interpolation
// matrices as the TPU's matrix unit does: each output pixel has at most
// two taps per axis, which the wrapper passes in as small arrays made from
// the same code that builds the plain version's matrices, so a thread
// grays the four source pixels of each of its outputs and blends them. A
// thread owns four neighbouring outputs of a row and reads that row's taps
// once; the source pixels neighbouring outputs share come from L1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float gray_of(float x0, float x1, float x2,
                                         float w0, float w1, float w2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x0, w0), __fmul_rn(x1, w1)),
                   __fmul_rn(x2, w2));
}

__device__ __forceinline__ float normalize(float gray) {
  return __fsub_rn(__fdiv_rn(gray, 127.5f), 1.0f);
}

// One thread per pixel: for a tail, or for pointers that are not aligned
// for the vector path.
__global__ void __launch_bounds__(kThreads)
gray_normalize_scalar_kernel(const uint8_t* __restrict__ in,
                             float* __restrict__ out, long long first,
                             long long pixels, float w0, float w1, float w2) {
  const long long p =
      first + (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pixels) return;
  const uint8_t* px = in + 3 * p;
  out[p] = normalize(gray_of(px[0], px[1], px[2], w0, w1, w2));
}

// One thread per four pixels: 12 bytes in as three words, 16 bytes out.
__global__ void __launch_bounds__(kThreads)
gray_normalize_vec4_kernel(const uint32_t* __restrict__ in,
                           float4* __restrict__ out, long long groups,
                           float w0, float w1, float w2) {
  const long long gidx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gidx >= groups) return;
  const uint32_t a = in[3 * gidx], b = in[3 * gidx + 1], c = in[3 * gidx + 2];
  // Little-endian bytes: a = x0 y0 z0 x1, b = y1 z1 x2 y2, c = z2 x3 y3 z3.
  float4 r;
  r.x = normalize(gray_of(a & 0xff, (a >> 8) & 0xff, (a >> 16) & 0xff, w0, w1,
                          w2));
  r.y = normalize(gray_of(a >> 24, b & 0xff, (b >> 8) & 0xff, w0, w1, w2));
  r.z = normalize(gray_of((b >> 16) & 0xff, b >> 24, c & 0xff, w0, w1, w2));
  r.w = normalize(gray_of((c >> 8) & 0xff, (c >> 16) & 0xff, c >> 24, w0, w1,
                          w2));
  out[gidx] = r;
}

// kResizeOut neighbouring output pixels of one output row a thread. Row
// taps (lo, hi, weight of lo, weight of hi) for each output row, column
// taps likewise; where both taps land on one source line (a clamped edge)
// hi == lo and its weight is 0. The thread reads its row's taps and source
// rows once for all its outputs; the source pixels that neighbouring
// outputs share come from L1.
constexpr int kResizeOut = 4;

__global__ void __launch_bounds__(kThreads)
gray_resize_normalize_kernel(const uint8_t* __restrict__ in,
                             float* __restrict__ out, int n, int h, int w,
                             int oh, int ow, const int* __restrict__ row_lo,
                             const int* __restrict__ row_hi,
                             const float* __restrict__ row_wlo,
                             const float* __restrict__ row_whi,
                             const int* __restrict__ col_lo,
                             const int* __restrict__ col_hi,
                             const float* __restrict__ col_wlo,
                             const float* __restrict__ col_whi, float w0,
                             float w1, float w2) {
  const int groups = (ow + kResizeOut - 1) / kResizeOut;   // a row's
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * oh * groups) return;
  const int first = (int)(idx % groups) * kResizeOut;
  const long long row = idx / groups;                      // image * oh + oy
  const int oy = (int)(row % oh);
  const uint8_t* img = in + row / oh * (long long)h * w * 3;
  const uint8_t* top = img + (long long)row_lo[oy] * w * 3;
  const uint8_t* bot = img + (long long)row_hi[oy] * w * 3;
  const float a0 = row_wlo[oy], a1 = row_whi[oy];
  float* dst = out + row * ow;
#pragma unroll
  for (int i = 0; i < kResizeOut; ++i) {
    const int ox = first + i;
    if (ox >= ow) break;
    const uint8_t* p00 = top + col_lo[ox] * 3;
    const uint8_t* p01 = top + col_hi[ox] * 3;
    const uint8_t* p10 = bot + col_lo[ox] * 3;
    const uint8_t* p11 = bot + col_hi[ox] * 3;
    const float b0 = col_wlo[ox], b1 = col_whi[ox];
    const float g00 = gray_of(p00[0], p00[1], p00[2], w0, w1, w2);
    const float g01 = gray_of(p01[0], p01[1], p01[2], w0, w1, w2);
    const float g10 = gray_of(p10[0], p10[1], p10[2], w0, w1, w2);
    const float g11 = gray_of(p11[0], p11[1], p11[2], w0, w1, w2);
    // Rows first (rh @ gray), then columns (. rw^T).
    const float left = fmaf(a1, g10, __fmul_rn(a0, g00));
    const float right = fmaf(a1, g11, __fmul_rn(a0, g01));
    dst[ox] = normalize(fmaf(b1, right, __fmul_rn(b0, left)));
  }
}

}  // namespace

// in: contiguous (pixels, 3) u8; out: contiguous (pixels,) f32, both on the
// current device. The launches go to ``stream`` and do not synchronise.
// Returns cudaGetLastError() after the launches.
extern "C" int gray_normalize(const void* in, void* out, long long pixels,
                              float w0, float w1, float w2, void* stream) {
  if (pixels < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(in) % 4 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const long long groups = aligned ? pixels / 4 : 0;
  if ((groups + kThreads - 1) / kThreads > 0x7fffffffLL ||
      (pixels + kThreads - 1) / kThreads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (groups > 0) {
    gray_normalize_vec4_kernel<<<(unsigned)((groups + kThreads - 1) / kThreads),
                                 kThreads, 0, s>>>(
        static_cast<const uint32_t*>(in), static_cast<float4*>(out), groups,
        w0, w1, w2);
  }
  const long long rest = pixels - 4 * groups;
  if (rest > 0) {
    gray_normalize_scalar_kernel<<<(unsigned)((rest + kThreads - 1) / kThreads),
                                   kThreads, 0, s>>>(
        static_cast<const uint8_t*>(in), static_cast<float*>(out), 4 * groups,
        pixels, w0, w1, w2);
  }
  return (int)cudaGetLastError();
}

// in: contiguous (n, h, w, 3) u8; out: contiguous (n, oh, ow) f32; the tap
// arrays hold oh (rows) and ow (columns) entries on the same device.
extern "C" int gray_resize_normalize(
    const void* in, void* out, int n, int h, int w, int oh, int ow,
    const void* row_lo, const void* row_hi, const void* row_wlo,
    const void* row_whi, const void* col_lo, const void* col_hi,
    const void* col_wlo, const void* col_whi, float w0, float w1, float w2,
    void* stream) {
  if (n < 1 || h < 1 || w < 1 || oh < 1 || ow < 1)
    return (int)cudaErrorInvalidValue;
  const long long threads =
      (long long)n * oh * ((ow + kResizeOut - 1) / kResizeOut);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gray_resize_normalize_kernel<<<(unsigned)blocks, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<float*>(out), n, h, w, oh,
      ow, static_cast<const int*>(row_lo), static_cast<const int*>(row_hi),
      static_cast<const float*>(row_wlo), static_cast<const float*>(row_whi),
      static_cast<const int*>(col_lo), static_cast<const int*>(col_hi),
      static_cast<const float*>(col_wlo), static_cast<const float*>(col_whi),
      w0, w1, w2);
  return (int)cudaGetLastError();
}
