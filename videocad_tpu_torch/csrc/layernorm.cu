// Row LayerNorm, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels videocad_tpu/ops/layernorm.py:_fwd_kernel
// (layer_norm -> _ln_fwd -> pl.pallas_call) and :_bwd_kernel (_ln_bwd ->
// pl.pallas_call). They compute the same functions over x (rows, d):
//   forward:  mean = sum(x) / d; centered = x - mean;
//             var = sum(centered^2) / d (the centred second moment, not
//             E[x^2] - mean^2); norm = centered * rsqrt(var + eps);
//             y = norm * scale + bias, all in f32, rounded once to the I/O
//             dtype;
//   backward: the statistics are recomputed from x (only x and scale are
//             kept between the two); gs = g * scale;
//             dx = rstd * (gs - mean(gs) - norm * mean(gs * norm));
//             dscale = sum over rows of g * norm, dbias = sum over rows of
//             g, both f32 (d,).
// x, y, g and dx are float32 or bfloat16; scale, bias, dscale and dbias are
// always float32.
//
// What bounds them on the card: bytes. The forward reads x and writes y,
// the backward reads x and g and writes dx, a few dozen flops per element:
// at the train step's 76,400 x 512 bf16 rows that is 156 MB and 235 MB,
// 0.047 ms and 0.070 ms at 3.35 TB/s. A call at the CAD encoder's 400 rows
// moves 0.8 MB: there the host's work around the launch bounds it
// (ops/layernorm.py keeps that path short).
//
// The forward. The first version held every row as 32 f32 values a lane
// (the widest row, d = 1,024), so at d = 512 bf16 half of each lane's
// registers were zeros that were loaded, summed and kept; and each warp
// walked the rows one at a time, its loads, two shuffle reductions and
// store one after the other: 51% of the bound at d = 512, 74% at 1,024.
// Now the width is a template parameter: the flagship's widths (512 and
// 1,024, bf16 and float32) have instantiations of their exact width, with
// no predicated column, a generic one serves every other d <= 1,024 on the
// 16-byte grid, and a scalar one the widths off it or an unaligned x. A
// lane keeps its chunks as loaded (eight bf16 values in four registers) and
// widens them in each of its three passes. A warp owns R rows, 4-8 KB of
// x (R = 4 at d = 512 and 1,024 bf16, 2 at 512 float32, 1 at 1,024
// float32): it issues all their loads, and scale's and bias's, before it
// reduces the first, and runs their R shuffle reductions interleaved. The
// grid has one warp for every R rows, so the SM's scheduler keeps starting
// warps, and their loads, while others reduce and store. Measured on an
// H100 at 76,400 x 512 bf16 (CUDA events, PERF.md section 6): this
// takes 0.0554 ms where a persistent grid of resident blocks walking the
// rows took 0.0611-0.0640 (R = 1 to 8), the same with the next rows' loads
// issued before the current rows' reductions 0.0611-0.0622, and a per-warp
// ring of 4 rows in shared memory fed by cp.async 0.0611-0.0625; in the
// full grid 1, 2 and 8 rows a warp 0.0920, 0.0598 and 0.0563. At 1,024
// bf16, 4 rows a warp 0.1062 and 2 rows 0.1106. The statistics are f32:
// the mean, then the centred second moment, rsqrt(var + eps); y = norm *
// scale + bias with separately rounded products and sums, rounded once to
// the I/O dtype.
//
// The backward: one warp owns one row at a time and holds it in registers
// as f32 (up to 32 values per lane, so d <= 1,024), read by 16-byte loads
// with neighbouring lanes on neighbouring addresses, so every x and g is
// read once and every dx written once, and the two row reductions are warp
// shuffles over registers. Warps walk the rows with a grid stride. Where
// the TPU kernel carries dscale and dbias partials per 1,024-row block
// through a sequential grid, here each lane sums the columns it owns over
// all the rows its warp visits, the block's warps are combined through
// shared memory, each block writes one (d,) partial, and a second small
// kernel sums the (blocks, d) partials per column. Two passes and no
// atomics: the sums are taken in a fixed order, so dscale and dbias are the
// same in every run. A width that is not a multiple of the 16-byte vector,
// or a pointer that is not aligned for it, takes the same kernels with one
// element per load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPerLane = 32;              // row values a lane holds
constexpr int kMaxD = 32 * kPerLane;      // 1,024
constexpr int kBwdMaxBlocks = 132 * 4;    // also the rows of the partials

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Lane ``lane`` holds, as its value e, column (c * 32 + lane) * VEC + v
// with c = e / VEC, v = e % VEC: VEC neighbouring columns per load.
template <int VEC>
__device__ __forceinline__ int col_of(int e, int lane) {
  return ((e / VEC) * 32 + lane) * VEC + (e % VEC);
}

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 raw = *reinterpret_cast<const float4*>(p);
  out[0] = raw.x; out[1] = raw.y; out[2] = raw.z; out[3] = raw.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store_vec(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* in) {
  uint4 raw;
  __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)   // round to nearest even, as XLA's convert
    pairs[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}
__device__ __forceinline__ float load_one(const float* p) { return *p; }
__device__ __forceinline__ float load_one(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_one(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// A row of d values into registers as f32; columns past d read as 0.
template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int d,
                                         int lane, float (&x)[kPerLane]) {
#pragma unroll
  for (int c = 0; c < kPerLane / VEC; ++c) {
    const int col = (c * 32 + lane) * VEC;
    if (col < d) {
      if constexpr (VEC == 1) {
        x[c] = load_one(row + col);
      } else {
        load_vec(row + col, &x[c * VEC]);
      }
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) x[c * VEC + v] = 0.f;
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_row(T* __restrict__ row, int d, int lane,
                                          const float (&x)[kPerLane]) {
#pragma unroll
  for (int c = 0; c < kPerLane / VEC; ++c) {
    const int col = (c * 32 + lane) * VEC;
    if (col < d) {
      if constexpr (VEC == 1) {
        store_one(row + col, x[c]);
      } else {
        store_vec(row + col, &x[c * VEC]);
      }
    }
  }
}

// x -> norm in place (0 in the columns past d); returns rstd.
template <int VEC>
__device__ __forceinline__ float normalize_row(float (&x)[kPerLane], int d,
                                               int lane, float eps) {
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) sum += x[e];
  const float mean = warp_sum(sum) / (float)d;
  float sq = 0.f;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const float centered = col_of<VEC>(e, lane) < d ? x[e] - mean : 0.f;
    x[e] = centered;
    sq = fmaf(centered, centered, sq);
  }
  const float rstd = rsqrtf(warp_sum(sq) / (float)d + eps);
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) x[e] *= rstd;
  return rstd;
}

template <int VEC, int N>
__device__ __forceinline__ void load_param(const float* __restrict__ p, int d,
                                           int lane, float (&out)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const int col = col_of<VEC>(e, lane);
    out[e] = col < d ? p[col] : 0.f;
  }
}

// The forward's row storage: a lane keeps what it loaded as it came from
// memory (a 16-byte chunk of VEC values, or one value when VEC is 1) and
// widens it to f32 in each of the three passes over the row, so a bf16 row
// takes half the registers of its f32 values.
template <typename T, int VEC> struct Chunk {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const T* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ Raw zero() {
    return make_uint4(0, 0, 0, 0);
  }
  static __device__ __forceinline__ void widen(const Raw& r, float* v) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
    if constexpr (VEC == 8) {      // bf16: element 2i is word i's low half
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = __uint_as_float(w[i]);
    }
  }
  static __device__ __forceinline__ void store(T* p, const float* v) {
    store_vec(p, v);
  }
};
template <typename T> struct Chunk<T, 1> {
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ Raw zero() { return Raw(0.f); }
  static __device__ __forceinline__ void widen(const Raw& r, float* v) {
    v[0] = load_one(&r);
  }
  static __device__ __forceinline__ void store(T* p, const float* v) {
    store_one(p, v[0]);
  }
};

// R sums of a warp at once: the R butterflies interleave.
template <int R>
__device__ __forceinline__ void warp_sums(float (&s)[R]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
}

// A lane owns NV chunks of VEC columns of each row, chunk c at columns
// (c * 32 + lane) * VEC onwards. EXACT: d == 32 * NV * VEC, so no column is
// past d and no access is predicated. Rows ``first`` to ``first + R - 1``
// (those below ``rows``) into ``raw``, zeros elsewhere.
template <typename T, int VEC, int NV, int R, bool EXACT>
__device__ __forceinline__ void load_rows(
    const T* __restrict__ x, long long first, long long rows, int d, int lane,
    typename Chunk<T, VEC>::Raw (&raw)[R][NV]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int col = (c * 32 + lane) * VEC;
      raw[r][c] = first + r < rows && (EXACT || col < d)
                      ? Chunk<T, VEC>::load(x + (first + r) * d + col)
                      : Chunk<T, VEC>::zero();
    }
}

// The R rows of ``raw`` normalised, scaled, shifted and stored: the R
// rows' shuffle reductions interleave.
template <typename T, int VEC, int NV, int R, bool EXACT>
__device__ __forceinline__ void norm_rows(
    const typename Chunk<T, VEC>::Raw (&raw)[R][NV], long long first,
    long long rows, int d, int lane, float eps, const float* sc,
    const float* bi, T* __restrict__ y) {
  using C = Chunk<T, VEC>;
  float mean[R], rstd[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      float v[VEC];
      C::widen(raw[r][c], v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) sum += v[i];
    }
    mean[r] = sum;
  }
  warp_sums<R>(mean);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    mean[r] /= (float)d;
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      float v[VEC];
      C::widen(raw[r][c], v);
      if (EXACT || (c * 32 + lane) * VEC < d)
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float centered = v[i] - mean[r];
          sq = fmaf(centered, centered, sq);
        }
    }
    rstd[r] = sq;
  }
  warp_sums<R>(rstd);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    rstd[r] = rsqrtf(rstd[r] / (float)d + eps);
    if (first + r >= rows) continue;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int col = (c * 32 + lane) * VEC;
      if (!EXACT && col >= d) continue;
      float v[VEC];
      C::widen(raw[r][c], v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float norm = (v[i] - mean[r]) * rstd[r];
        v[i] = __fadd_rn(__fmul_rn(norm, sc[c * VEC + i]), bi[c * VEC + i]);
      }
      C::store(y + (first + r) * d + col, v);
    }
  }
}

// Warp w of the grid owns rows w * R to w * R + R - 1: it loads scale,
// bias and all its rows before it reduces the first.
template <typename T, int VEC, int NV, int R, bool EXACT>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ y,
                      long long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long first =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * R;
  if (first >= rows) return;            // the whole warp
  float sc[NV * VEC], bi[NV * VEC];
  load_param<VEC>(scale, d, lane, sc);
  load_param<VEC>(bias, d, lane, bi);
  typename Chunk<T, VEC>::Raw raw[R][NV];
  load_rows<T, VEC, NV, R, EXACT>(x, first, rows, d, lane, raw);
  norm_rows<T, VEC, NV, R, EXACT>(raw, first, rows, d, lane, eps, sc, bi, y);
}

// parts: (2, gridDim.x, d) f32; block b writes its dscale partial to
// parts[0][b] and its dbias partial to parts[1][b].
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const T* __restrict__ g, T* __restrict__ dx,
                      float* __restrict__ parts, long long rows, int d,
                      float eps) {
  __shared__ float part[2][kWarps][kMaxD];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long first = (long long)blockIdx.x * kWarps + warp;
  const long long stride = (long long)gridDim.x * kWarps;
  float sc[kPerLane], dsc[kPerLane], dbi[kPerLane];
  load_param<VEC>(scale, d, lane, sc);
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) dsc[e] = dbi[e] = 0.f;

  for (long long row = first; row < rows; row += stride) {
    float norm[kPerLane], gs[kPerLane];
    load_row<T, VEC>(x + row * d, d, lane, norm);
    load_row<T, VEC>(g + row * d, d, lane, gs);
    const float rstd = normalize_row<VEC>(norm, d, lane, eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      dbi[e] += gs[e];
      dsc[e] = fmaf(gs[e], norm[e], dsc[e]);
      gs[e] *= sc[e];
      s1 += gs[e];
      s2 = fmaf(gs[e], norm[e], s2);
    }
    const float m1 = warp_sum(s1) / (float)d;
    const float m2 = warp_sum(s2) / (float)d;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e)
      gs[e] = rstd * (gs[e] - m1 - norm[e] * m2);
    store_row<T, VEC>(dx + row * d, d, lane, gs);
  }

#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const int col = col_of<VEC>(e, lane);
    if (col < d) {
      part[0][warp][col] = dsc[e];
      part[1][warp][col] = dbi[e];
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < d; col += kThreads) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += part[0][w][col];
      b += part[1][w][col];
    }
    parts[(long long)blockIdx.x * d + col] = a;
    parts[((long long)gridDim.x + blockIdx.x) * d + col] = b;
  }
}

// Sums the (2, nparts, d) partials over nparts: blockIdx.y 0 -> dscale,
// 1 -> dbias; a block of (32, 8) threads owns 32 columns.
__global__ void __launch_bounds__(256)
layer_norm_param_grad_kernel(const float* __restrict__ parts,
                             float* __restrict__ dscale,
                             float* __restrict__ dbias, int nparts, int d) {
  __shared__ float tile[8][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const float* src = parts + (long long)blockIdx.y * nparts * d;
  float acc = 0.f;
  if (col < d)
    for (int p = threadIdx.y; p < nparts; p += 8)
      acc += src[(long long)p * d + col];
  tile[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && col < d) {
    float total = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) total += tile[r][threadIdx.x];
    (blockIdx.y == 0 ? dscale : dbias)[col] = total;
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

inline int blocks_for(long long rows, int cap) {
  const long long want = (rows + kWarps - 1) / kWarps;
  return (int)(want < cap ? want : cap);
}

template <typename T, int VEC, int NV, int R, bool EXACT>
int launch_fwd(const void* x, const void* scale, const void* bias, void* y,
               long long rows, int d, float eps, cudaStream_t s) {
  const long long blocks = (rows + kWarps * R - 1) / (kWarps * R);
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  layer_norm_fwd_kernel<T, VEC, NV, R, EXACT><<<(unsigned)blocks, kThreads, 0,
                                                s>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(y), rows, d, eps);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_bwd(const void* x, const void* scale, const void* g, void* dx,
               void* parts, long long rows, int d, float eps,
               cudaStream_t s) {
  layer_norm_bwd_kernel<T, VEC><<<blocks_for(rows, kBwdMaxBlocks), kThreads, 0,
                                  s>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const T*>(g), static_cast<T*>(dx),
      static_cast<float*>(parts), rows, d, eps);
  return (int)cudaGetLastError();
}

// The forward's instantiations, indexed by variant code:
// ops/layernorm.py:FWD_VARIANTS names them in this order and
// forward_variant picks one. <dtype, VEC columns a chunk, NV chunks a lane,
// R rows a warp at a time, exact width>.
using FwdLaunch = int (*)(const void*, const void*, const void*, void*,
                          long long, int, float, cudaStream_t);
constexpr FwdLaunch kFwdVariants[] = {
    launch_fwd<float, 1, 32, 1, false>,          // 0 float32/scalar
    launch_fwd<float, 4, 8, 1, false>,           // 1 float32/vector
    launch_fwd<float, 4, 4, 2, true>,            // 2 float32/512
    launch_fwd<float, 4, 8, 1, true>,            // 3 float32/1024
    launch_fwd<__nv_bfloat16, 1, 32, 1, false>,  // 4 bfloat16/scalar
    launch_fwd<__nv_bfloat16, 8, 4, 2, false>,   // 5 bfloat16/vector
    launch_fwd<__nv_bfloat16, 8, 2, 4, true>,    // 6 bfloat16/512
    launch_fwd<__nv_bfloat16, 8, 4, 4, true>,    // 7 bfloat16/1024
};

}  // namespace

// The rows of the (2, blocks, d) f32 scratch that layer_norm_bwd needs.
extern "C" int layer_norm_bwd_blocks(long long rows) {
  return rows < 1 ? 0 : blocks_for(rows, kBwdMaxBlocks);
}

// x, y: contiguous (rows, d) of the variant's dtype; scale, bias:
// contiguous (d,) float32; all on the current device. ``variant``: an
// index of kFwdVariants. "scalar" takes any d <= 1,024 and any alignment;
// "vector" a d on the 16-byte grid (a multiple of 4 float32 or 8 bfloat16
// values) and 16-byte aligned x and y; "512" and "1024" that width only.
// The launch goes to ``stream`` and does not synchronise. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// or variant it does not take.
extern "C" int layer_norm_fwd(const void* x, const void* scale,
                              const void* bias, void* y, long long rows,
                              int d, float eps, int variant, void* stream) {
  if (rows < 1 || d < 1 || d > kMaxD || variant < 0 || variant > 7)
    return (int)cudaErrorInvalidValue;
  const int kind = variant % 4;          // scalar, vector, 512, 1024
  const int vec = variant >= 4 ? 8 : 4;
  if ((kind != 0 && !(aligned16(x) && aligned16(y) && d % vec == 0)) ||
      (kind == 2 && d != 512) || (kind == 3 && d != 1024))
    return (int)cudaErrorInvalidValue;
  return kFwdVariants[variant](x, scale, bias, y, rows, d, eps,
                               static_cast<cudaStream_t>(stream));
}

// x, g, dx: contiguous (rows, d) of ``dtype``; scale, dscale, dbias: (d,)
// float32; parts: (2, layer_norm_bwd_blocks(rows), d) float32 scratch. Two
// launches on ``stream``: the row pass, then the sum of the partials.
extern "C" int layer_norm_bwd(const void* x, const void* scale, const void* g,
                              void* dx, void* dscale, void* dbias, void* parts,
                              long long rows, int d, float eps, int dtype,
                              void* stream) {
  if (rows < 1 || d < 1 || d > kMaxD || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(x) && aligned16(g) && aligned16(dx);
  int err;
  if (dtype == 1) {
    err = (vec && d % 8 == 0)
              ? launch_bwd<__nv_bfloat16, 8>(x, scale, g, dx, parts, rows, d,
                                             eps, s)
              : launch_bwd<__nv_bfloat16, 1>(x, scale, g, dx, parts, rows, d,
                                             eps, s);
  } else {
    err = (vec && d % 4 == 0)
              ? launch_bwd<float, 4>(x, scale, g, dx, parts, rows, d, eps, s)
              : launch_bwd<float, 1>(x, scale, g, dx, parts, rows, d, eps, s);
  }
  if (err != 0) return err;
  layer_norm_param_grad_kernel<<<dim3((d + 31) / 32, 2), dim3(32, 8), 0, s>>>(
      static_cast<const float*>(parts), static_cast<float*>(dscale),
      static_cast<float*>(dbias), blocks_for(rows, kBwdMaxBlocks), d);
  return (int)cudaGetLastError();
}
