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
// The backward. The first version held every row as 32 f32 values a lane
// in five row-wide arrays (scale, the two column sums, norm and gs: 160
// values live whatever d was, half of them predicated zeros at d = 512),
// kept 32 KB of static shared memory a block, walked one row at a time
// with four dependent shuffle reductions (mean, variance, mean(gs),
// mean(gs * norm)) and capped the grid at 528 blocks: 47% of the bound at
// 76,400 x 512 bf16. Now it takes the forward's pieces: the same eight
// instantiations (kBwdVariants), exact widths unpredicated, a lane keeps
// its chunks of x and g as loaded, a warp loads R rows of both before it
// reduces the first, and two butterflies a group, each over 2R sums at
// once: the sums of x and of gs = g * scale, then of centered^2 and of
// gs * centered (mean(gs * norm) = rstd * mean(gs * centered)). A block's
// warps walk its rows R at a time; each warp adds its rows' g * norm and g
// into its own (2, d) f32 column sums in shared memory (sized to d), and at
// the end the block's warps are added in a fixed order into one (2, d)
// partial a block. A second kernel sums the partials, a block a group of
// columns, its lanes over the partial rows in order. No atomics: dscale
// and dbias are the same bits in every run on one card model (the blocks,
// and so the order of the sums, follow the card's SM count and occupancy).
//
// How the rows are cut was measured on an H100 (cli/ln_bwd_sweep.py
// rebuilds copies of this file with the table kBwdVariants rewritten;
// PERF.md section 6). Blocks of a fixed 32-256 rows lost to one wave: the
// grid that leaves a second, partial wave of long blocks idles most SMs at
// its end. So bf16 splits the rows evenly over one wave of as many blocks
// as the SMs hold at once (bwd_plan asks the runtime), and a warp loads its
// next rows before it reduces the current. float32, whose rows are twice
// the bytes, did better with blocks of 64 rows over many waves, which the
// scheduler balances across SMs. The compiler keeps what each pass derives
// (the widened rows, g * scale, x - mean) for the next: 160-245 registers
// at 4-8 KB of rows a warp, so 8 warps an SM; capping them at 128 or 168
// spilled and lost 1.15-2.2x, and an empty asm that made it recompute them
// did not lower the count. A call too small to give every warp of a full
// grid R rows (the CAD encoder's 400 rows) takes instantiations of one row
// a warp over more blocks: there a warp's instructions, not the bytes,
// bound the call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 1024;               // a warp's row in registers
constexpr int kSumWarps = 8;              // the partials' sum: a block

// Lane ``lane`` holds, as its value e, column (c * 32 + lane) * VEC + v
// with c = e / VEC, v = e % VEC: VEC neighbouring columns per load.
template <int VEC>
__device__ __forceinline__ int col_of(int e, int lane) {
  return ((e / VEC) * 32 + lane) * VEC + (e % VEC);
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

template <int VEC, int N>
__device__ __forceinline__ void load_param(const float* __restrict__ p, int d,
                                           int lane, float (&out)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const int col = col_of<VEC>(e, lane);
    out[e] = col < d ? p[col] : 0.f;
  }
}

// The row storage of both kernels: a lane keeps what it loaded as it came
// from memory (a 16-byte chunk of VEC values, or one value when VEC is 1)
// and widens it to f32 in each of the three passes over the row, so a bf16
// row takes half the registers of its f32 values.
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

// ``v`` added into the VEC floats at ``p`` (16-byte aligned when VEC is a
// multiple of 4).
template <int VEC>
__device__ __forceinline__ void add_columns(float* p, const float* v) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j) {
      float4 a = reinterpret_cast<float4*>(p)[j];
      a.x += v[4 * j];
      a.y += v[4 * j + 1];
      a.z += v[4 * j + 2];
      a.w += v[4 * j + 3];
      reinterpret_cast<float4*>(p)[j] = a;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] += v[i];
  }
}

// The backward of the R rows in ``xr`` and ``gr`` (rows past ``end`` are
// zeros and store nothing): dx stored, and the rows' g * norm and g added
// into the warp's column sums ``acc`` (dscale's at acc[col], dbias's at
// acc[d + col]). Two butterflies of 2R sums each.
template <typename T, int VEC, int NV, int R, bool EXACT>
__device__ __forceinline__ void bwd_rows(
    const typename Chunk<T, VEC>::Raw (&xr)[R][NV],
    const typename Chunk<T, VEC>::Raw (&gr)[R][NV], long long first,
    long long end, int d, int lane, float eps, const float* sc,
    float* __restrict__ acc, T* __restrict__ dx) {
  using C = Chunk<T, VEC>;
  float s[2 * R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float sx = 0.f, sg = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      float v[VEC], w[VEC];
      C::widen(xr[r][c], v);
      C::widen(gr[r][c], w);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        sx += v[i];
        sg += __fmul_rn(w[i], sc[c * VEC + i]);
      }
    }
    s[2 * r] = sx;
    s[2 * r + 1] = sg;
  }
  warp_sums<2 * R>(s);
  float mean[R], m1[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    mean[r] = s[2 * r] / (float)d;
    m1[r] = s[2 * r + 1] / (float)d;
    float sq = 0.f, sgc = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      float v[VEC], w[VEC];
      C::widen(xr[r][c], v);
      C::widen(gr[r][c], w);
      if (EXACT || (c * 32 + lane) * VEC < d)
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float centered = v[i] - mean[r];
          sq = fmaf(centered, centered, sq);
          sgc = fmaf(__fmul_rn(w[i], sc[c * VEC + i]), centered, sgc);
        }
    }
    s[2 * r] = sq;
    s[2 * r + 1] = sgc;
  }
  warp_sums<2 * R>(s);
  float rstd[R], m2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    rstd[r] = rsqrtf(s[2 * r] / (float)d + eps);
    m2[r] = s[2 * r + 1] / (float)d * rstd[r];
  }
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int col = (c * 32 + lane) * VEC;
    if (!EXACT && col >= d) continue;
    float dsc[VEC], dbi[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) dsc[i] = dbi[i] = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float v[VEC], w[VEC];
      C::widen(xr[r][c], v);
      C::widen(gr[r][c], w);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float norm = (v[i] - mean[r]) * rstd[r];
        const float gs = __fmul_rn(w[i], sc[c * VEC + i]);
        dsc[i] = fmaf(w[i], norm, dsc[i]);
        dbi[i] += w[i];
        v[i] = rstd[r] * (gs - m1[r] - norm * m2[r]);
      }
      if (first + r < end) C::store(dx + (first + r) * d + col, v);
    }
    add_columns<VEC>(acc + col, dsc);
    add_columns<VEC>(acc + d + col, dbi);
  }
}

// Block b owns rows b * block_rows to (b + 1) * block_rows - 1; its warp w
// takes the R rows at w * R, then those W * R further, and so on. The
// block writes its dscale partial to parts[0][b] and its dbias partial to
// parts[1][b] ((2, gridDim.x, d) f32). Dynamic shared memory: the warps'
// column sums, W * 2 * d floats.
template <typename T, int VEC, int NV, int R, bool EXACT, int W, bool PF>
__global__ void __launch_bounds__(W * 32)
layer_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const T* __restrict__ g, T* __restrict__ dx,
                      float* __restrict__ parts, long long rows, int d,
                      float eps, int block_rows) {
  extern __shared__ float4 sums4[];
  float* sums = reinterpret_cast<float*>(sums4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* acc = sums + warp * 2 * d;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int col = (c * 32 + lane) * VEC;
    if (EXACT || col < d)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[col + i] = acc[d + col + i] = 0.f;
  }
  float sc[NV * VEC];
  load_param<VEC>(scale, d, lane, sc);
  const long long start = (long long)blockIdx.x * block_rows;
  const long long end = rows < start + block_rows ? rows : start + block_rows;
  using Raw = typename Chunk<T, VEC>::Raw;
  if constexpr (PF) {
    // The next group's rows are loaded before this group's are reduced.
    long long first = start + warp * R;
    Raw xr[R][NV], gr[R][NV];
    load_rows<T, VEC, NV, R, EXACT>(x, first, end, d, lane, xr);
    load_rows<T, VEC, NV, R, EXACT>(g, first, end, d, lane, gr);
    while (first < end) {
      const long long next = first + W * R;
      Raw xn[R][NV], gn[R][NV];
      load_rows<T, VEC, NV, R, EXACT>(x, next, end, d, lane, xn);
      load_rows<T, VEC, NV, R, EXACT>(g, next, end, d, lane, gn);
      bwd_rows<T, VEC, NV, R, EXACT>(xr, gr, first, end, d, lane, eps, sc,
                                     acc, dx);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          xr[r][c] = xn[r][c];
          gr[r][c] = gn[r][c];
        }
      first = next;
    }
  } else {
    for (long long first = start + warp * R; first < end; first += W * R) {
      Raw xr[R][NV], gr[R][NV];
      load_rows<T, VEC, NV, R, EXACT>(x, first, end, d, lane, xr);
      load_rows<T, VEC, NV, R, EXACT>(g, first, end, d, lane, gr);
      bwd_rows<T, VEC, NV, R, EXACT>(xr, gr, first, end, d, lane, eps, sc,
                                     acc, dx);
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < d; col += W * 32) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      a += sums[w * 2 * d + col];
      b += sums[w * 2 * d + d + col];
    }
    parts[(long long)blockIdx.x * d + col] = a;
    parts[((long long)gridDim.x + blockIdx.x) * d + col] = b;
  }
}

// Sums the (2, nparts, d) partials over nparts into params (2, d):
// blockIdx.y 0 -> dscale, 1 -> dbias. Block b owns the VEC columns from b *
// VEC on; lane l of warp w adds partial rows w * 32 + l, then kSumWarps *
// 32 further, and so on, in order; the lanes' sums meet in a butterfly,
// the warps' in shared memory in warp order.
template <int VEC>
__global__ void __launch_bounds__(kSumWarps * 32)
layer_norm_param_grad_kernel(const float* __restrict__ parts,
                             float* __restrict__ params, int nparts, int d) {
  __shared__ float warp_total[kSumWarps][VEC];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * VEC;
  const float* src = parts + (long long)blockIdx.y * nparts * d + col;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int p = threadIdx.x; p < nparts; p += kSumWarps * 32) {
    if constexpr (VEC == 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + (long long)p * d);
      acc[0] += v.x;
      acc[1] += v.y;
      acc[2] += v.z;
      acc[3] += v.w;
    } else {
      acc[0] += src[(long long)p * d];
    }
  }
  warp_sums<VEC>(acc);
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < VEC; ++i) warp_total[warp][i] = acc[i];
  __syncthreads();
  if (threadIdx.x < VEC) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kSumWarps; ++w) total += warp_total[w][threadIdx.x];
    params[blockIdx.y * d + col + threadIdx.x] = total;
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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

template <typename T, int VEC, int NV, int R, bool EXACT, int W, bool PF>
int launch_bwd(const void* x, const void* scale, const void* g, void* dx,
               void* parts, long long rows, int d, float eps, int block_rows,
               cudaStream_t s) {
  const long long blocks = (rows + block_rows - 1) / block_rows;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  layer_norm_bwd_kernel<T, VEC, NV, R, EXACT, W, PF>
      <<<(unsigned)blocks, W * 32, W * 2 * d * sizeof(float), s>>>(
          static_cast<const T*>(x), static_cast<const float*>(scale),
          static_cast<const T*>(g), static_cast<T*>(dx),
          static_cast<float*>(parts), rows, d, eps, block_rows);
  return (int)cudaGetLastError();
}

// The blocks of the instantiation that one SM of the current device holds
// at once at width d (registers and shared memory), asked of the runtime
// once a device and width; 0 if it cannot tell. Above the default 48 KB of
// shared memory (8 warps at d > 768) the kernel is first allowed the most
// it needs, on that device: a function's attributes are the device's.
constexpr int kMaxDevices = 8;   // the devices whose answers are kept
template <typename T, int VEC, int NV, int R, bool EXACT, int W, bool PF>
int bwd_blocks_per_sm(int d) {
  static int known[kMaxDevices][kMaxD + 1];
  int dev = 0;
  if (cudaGetDevice(&dev) != 0) return 0;
  int* slot = dev >= 0 && dev < kMaxDevices ? &known[dev][d] : nullptr;
  if (slot && *slot) return *slot;
  const auto kernel = layer_norm_bwd_kernel<T, VEC, NV, R, EXACT, W, PF>;
  const int bytes = W * 2 * d * (int)sizeof(float);
  if (bytes > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           W * 2 * kMaxD * (int)sizeof(float)) != 0)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, W * 32,
                                                    bytes) != 0)
    return 0;
  if (slot) *slot = n;
  return n;
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

// The backward's instantiations, in the forward's order (ops/layernorm.py:
// BWD_VARIANTS, backward_variant), as the H100 measured them best
// (cli/ln_bwd_sweep.py, PERF.md section 6): bfloat16 one wave of blocks
// whose warps load ahead (8 warps at 512, 4 at 1,024); float32 blocks of
// 64 rows, 8 warps that load ahead. BWD(dtype, VEC columns a chunk, NV
// chunks a lane, R rows a warp at a time, exact width, W warps a block,
// PF: a warp loads its next rows before it reduces the current, CAP: the
// most rows a block owns, 0 for one wave of blocks; see bwd_plan).
struct BwdKernel {
  int (*launch)(const void*, const void*, const void*, void*, void*,
                long long, int, float, int, cudaStream_t);
  int (*blocks_per_sm)(int);
  int warp_rows;     // R
  int warps;         // W
  int cap;           // CAP
};
template <typename T, int VEC, int NV, int R, bool EXACT, int W, bool PF>
constexpr BwdKernel bwd_kernel(int cap) {
  return {launch_bwd<T, VEC, NV, R, EXACT, W, PF>,
          bwd_blocks_per_sm<T, VEC, NV, R, EXACT, W, PF>, R, W, cap};
}
#define BWD(T, VEC, NV, R, EXACT, W, PF, CAP) \
  bwd_kernel<T, VEC, NV, R, EXACT, W, PF>(CAP)
using bf16 = __nv_bfloat16;
constexpr BwdKernel kBwdVariants[] = {
    BWD(float, 1, 32, 1, false, 4, false, 64),  // 0 float32/scalar
    BWD(float, 4, 8, 1, false, 8, true, 64),    // 1 float32/vector
    BWD(float, 4, 4, 2, true, 8, true, 64),     // 2 float32/512
    BWD(float, 4, 8, 1, true, 8, true, 64),     // 3 float32/1024
    BWD(bf16, 1, 32, 1, false, 4, false, 0),    // 4 bfloat16/scalar
    BWD(bf16, 8, 4, 2, false, 4, false, 0),     // 5 bfloat16/vector
    BWD(bf16, 8, 2, 2, true, 8, true, 0),       // 6 bfloat16/512
    BWD(bf16, 8, 4, 1, true, 4, true, 0),       // 7 bfloat16/1024
};
// The same with one row a warp, for calls too small to give every warp of
// a full grid R rows: there a warp's instructions, not the bytes, bound a
// call (the CAD encoder's 400 rows).
constexpr BwdKernel kBwdSmall[] = {
    BWD(float, 1, 32, 1, false, 4, false, 0),
    BWD(float, 4, 8, 1, false, 4, false, 0),
    BWD(float, 4, 4, 1, true, 4, false, 0),
    BWD(float, 4, 8, 1, true, 4, false, 0),
    BWD(bf16, 1, 32, 1, false, 4, false, 0),
    BWD(bf16, 8, 4, 1, false, 4, false, 0),
    BWD(bf16, 8, 2, 1, true, 4, false, 0),
    BWD(bf16, 8, 4, 1, true, 4, false, 0),
};
#undef BWD

// The SMs of the current device, asked once a device.
inline int device_sms() {
  static int known[kMaxDevices];
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != 0) return 0;
  if (dev >= 0 && dev < kMaxDevices && known[dev]) return known[dev];
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != 0)
    return 0;
  if (dev >= 0 && dev < kMaxDevices) known[dev] = n;
  return n;
}

// How a call of ``rows`` rows of width d runs. A full grid is as many
// blocks as the SMs hold at once. With CAP 0 the rows are split evenly over
// one full grid, each share rounded up to the block's rows at a time, so
// that no block starts after another has finished; with CAP > 0 a block
// owns up to CAP rows and the scheduler balances many waves. Where the rows
// do not give every warp of a full grid R of them, the instantiation with
// one row a warp (kBwdSmall), over one full grid or fewer blocks.
// block_rows is 0 where the runtime cannot say what an SM holds.
struct BwdPlan {
  const BwdKernel* kernel;
  int block_rows;
};
inline BwdPlan bwd_plan(long long rows, int d, int variant) {
  const BwdKernel* kernel = &kBwdVariants[variant];
  const int sms = device_sms();
  long long grid = (long long)sms * kernel->blocks_per_sm(d);
  if (rows < grid * kernel->warps * kernel->warp_rows) {
    kernel = &kBwdSmall[variant];
    grid = (long long)sms * kernel->blocks_per_sm(d);
  }
  if (grid < 1) return {kernel, 0};
  const int unit = kernel->warps * kernel->warp_rows;
  const long long share = (rows + grid - 1) / grid;
  long long block_rows = (share + unit - 1) / unit * unit;
  if (kernel->cap > 0 && block_rows > kernel->cap)
    block_rows = (kernel->cap + unit - 1) / unit * unit;
  return {kernel, (int)block_rows};
}

// Whether instantiation ``variant`` (of either table) takes rows of width d
// at pointers that are all 16-byte aligned or not: "scalar" any d <=
// 1,024 and any alignment; "vector" a d on the 16-byte grid (a multiple of
// 4 float32 or 8 bfloat16 values) and aligned pointers; "512" and "1024"
// that width only.
inline bool takes(int variant, int d, bool aligned) {
  if (d < 1 || d > kMaxD || variant < 0 || variant > 7) return false;
  const int kind = variant % 4;          // scalar, vector, 512, 1024
  const int vec = variant >= 4 ? 8 : 4;
  return kind == 0 || (aligned && d % vec == 0 &&
                        (kind == 1 || d == 512 * (kind - 1)));
}

}  // namespace

// The rows of the (2, blocks, d) f32 scratch that layer_norm_bwd needs for
// ``rows`` rows of width d in instantiation ``variant``; 0 for a shape it
// does not take or where the runtime cannot say.
extern "C" int layer_norm_bwd_blocks(long long rows, int d, int variant) {
  if (rows < 1 || !takes(variant, d, true)) return 0;
  const int block_rows = bwd_plan(rows, d, variant).block_rows;
  return block_rows < 1 ? 0 : (int)((rows + block_rows - 1) / block_rows);
}

// x, y: contiguous (rows, d) of the variant's dtype; scale, bias:
// contiguous (d,) float32; all on the current device. ``variant``: an
// index of kFwdVariants (see ``takes``). The launch goes to ``stream`` and
// does not synchronise. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape or variant it does not take.
extern "C" int layer_norm_fwd(const void* x, const void* scale,
                              const void* bias, void* y, long long rows,
                              int d, float eps, int variant, void* stream) {
  if (rows < 1 || !takes(variant, d, aligned16(x) && aligned16(y)))
    return (int)cudaErrorInvalidValue;
  return kFwdVariants[variant](x, scale, bias, y, rows, d, eps,
                               static_cast<cudaStream_t>(stream));
}

// x, g, dx: contiguous (rows, d) of the variant's dtype; scale: (d,)
// float32; params: (2, d) float32, dscale then dbias; parts: (2, nparts,
// d) float32 scratch, nparts = layer_norm_bwd_blocks(rows, d, variant)
// (cudaErrorInvalidValue for another). ``variant``: an index of
// kBwdVariants, taken as by layer_norm_fwd with x, g and dx for its
// pointers. Two launches on ``stream``: the row pass, then the sum of its
// partials.
extern "C" int layer_norm_bwd(const void* x, const void* scale, const void* g,
                              void* dx, void* params, void* parts,
                              int nparts, long long rows, int d, float eps,
                              int variant, void* stream) {
  if (rows < 1 ||
      !takes(variant, d, aligned16(x) && aligned16(g) && aligned16(dx)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdPlan plan = bwd_plan(rows, d, variant);
  if (plan.block_rows < 1 ||
      nparts != (rows + plan.block_rows - 1) / plan.block_rows)
    return (int)cudaErrorInvalidValue;     // a scratch of another plan
  const int err = plan.kernel->launch(x, scale, g, dx, parts, rows, d, eps,
                                      plan.block_rows, s);
  if (err != 0) return err;
  const float* p = static_cast<const float*>(parts);
  float* out = static_cast<float*>(params);
  if (d % 4 == 0)
    layer_norm_param_grad_kernel<4>
        <<<dim3(d / 4, 2), kSumWarps * 32, 0, s>>>(p, out, nparts, d);
  else
    layer_norm_param_grad_kernel<1>
        <<<dim3(d, 2), kSumWarps * 32, 0, s>>>(p, out, nparts, d);
  return (int)cudaGetLastError();
}
