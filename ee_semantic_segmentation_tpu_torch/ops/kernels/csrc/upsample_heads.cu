// Fused bilinear-upsample eval heads for Hopper (sm_90a), plain C interface.
//
// Replaces the three TPU (Pallas) kernels of the eval path:
//   A  ee_semantic_segmentation_tpu/ops/pallas/upsample_argmax.py:
//      upsample_argmax_confusion (_up_argmax_conf_kernel)
//      -> up_argmax_conf_kernel: bilinear upsample + argmax + per-class
//         TP/FP/FN over the rows n < count; only (3, C) counts leave.
//   B  ee_semantic_segmentation_tpu/ops/pallas/upsample_argmax.py:
//      upsample_entropy_argmax (_up_ent_argmax_kernel)
//      -> up_ent_argmax_kernel + ent_finalize_kernel: the same upsample and
//         argmax, plus each image's mean softmax entropy / log C.
//   C  ee_semantic_segmentation_tpu/ops/pallas/upsample_argmax.py:
//      upsample_argmax (its Pallas body at upsample_argmax.py:105)
//      -> up_argmax_map_kernel: the same upsample and argmax, the (N, H, W)
//         int32 label map only (the similarity gates read label maps).
//
// Design.  The separable resize up_c = Wh @ X_c @ Ww^T has at most two
// nonzero taps per output row and column (bilinear, upsampling), so the host
// passes each row's and column's (i0, i1, w0, w1) taken from the same weight
// matrices the JAX kernel uses (_resize_matrix_np).  Every kernel
// interpolates over rows first, then over columns: the JAX association (t1 =
// Wh @ X, then t1 @ Ww^T).  FP32 FFMA only, no tensor cores: the JAX kernel
// pins full f32 so argmax near-ties stay stable.  The argmax keeps the first
// maximum (strict >), like jnp.argmax.
//   B takes one block per (image, band of 4 output rows, output columns:
//     all of them where they fit).  The block first forms its band's row
//     interpolation once, t[r][x][c] for its rows and the low-res columns
//     they reach, into shared memory (21.5 KB at the flagship shape),
//     reading each distinct low-res row of the band once as contiguous w*C
//     runs of the NHWC input (16-byte loads and stores where aligned).
//     Each thread then takes groups of 4 consecutive output pixels of a
//     row.  Where the 4 share their column taps (always at the flagship's
//     8x: taps change every 8 columns, between groups), one walk over the
//     classes serves all 4: each class's two taps are read from shared
//     memory once (a warp's ~17 distinct low-res columns are broadcasts,
//     conflict-free for odd C) and interpolated per pixel; a first pass
//     takes the first maximum, a second the entropy log z - s/z with z =
//     sum 2^d, s = sum 2^d d, d = (v - max) log2(e): one ex2.approx (SFU)
//     per class and pixel.  Nothing is kept per class, so every C takes
//     the same two passes (no register limit on C).  Other groups walk
//     pixel by pixel.  The 4 labels leave as one 16-byte store where W % 4
//     == 0.  Each block writes its entropy sum (fixed order) to an (N,
//     tiles) scratch; a second kernel sums each row in double in a fixed
//     order, so the result is deterministic.
//   C takes B's tiling, staging and group walk (label_band) with the
//     argmax pass alone (pixels_argmax, which B's first pass is): no labels
//     in, no counts, no entropy, one kernel.  Its maps equal B's bit for
//     bit.  The walk keeps nothing per class, but a band of one output row
//     has to fit shared memory: above ~9,700 classes (3-6 low-res columns,
//     227 KB) no tiling does, and the entry point refuses the call.
//   A takes B's tiling, staging and grouped walk over the rows n < count,
//     with the argmax pass alone (pixels_argmax, which B's first pass is).
//     Each group reads its 4 labels as one 16-byte load where W % 4 == 0
//     (scalar loads otherwise) and forms TP (label == argmax), FP (the
//     argmax's class, when the label is another class or void: outside
//     [0, C), VOC's 255 included) and FN (the label's class, when it is a
//     class).  Each pixel adds its one or two counts to a per-block shared
//     int32 [3][C] histogram with shared integer atomicAdds.  On a trained
//     model most of a warp's 128 pixels share one key (TP of the
//     background), and those same-address integer atomics cost no more than
//     scattered ones (PERF.md: the same time on both laws); merging the keys
//     first, in the thread and across the warp (__match_any_sync,
//     __reduce_add_sync), made the kernel 2.7x as slow on uniform logits
//     and 1.4x on a trained model's.  One global atomicAdd
//     per nonzero bin and block into an int32 (3, C) buffer: integer atomics
//     make the counts exact and deterministic (f32 sums stop being exact
//     above 2^24 pixels per class).
//
// Bound at the flagship shape (N=16, h=w=64, C=21, H=W=512; H100 SXM,
// 3.35 TB/s, 67 TFLOP/s f32), estimated from the shapes:
//   A reads 5.5 MB of f32 logits and 16.8 MB of int32 labels: ~6.7 us of
//     memory; ~4.2 M pixels x (84 FMA + 21 compares): ~6-8 us of FP32.
//     Bound ~8 us.
//   B reads 5.5 MB and writes 16.8 MB of label maps: ~6.7 us of memory;
//     21 exp and 1 log per pixel are 92 M SFU operations, ~22 us at 16 a
//     clock per SM (132 SMs, 1.98 GHz): the SFU bounds it.
//   C reads 5.5 MB and writes 16.8 MB of label maps: ~6.7 us of memory, the
//     same ~6-8 us of FP32 as A.  Staged, a group of 4 pixels reads 2 C
//     values from shared memory and each pixel issues ~5 C instructions
//     (column step, compare, two selects): more time than the bytes take.
// The measured times sit beside these in PERF.md.

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Kernels B's, C's and A's tiling: a block takes one (image, band of th
// output rows, tile of tw output columns).  Its rows interpolated,
// t[r][x][c] = wr0 * X[r0][x][c] + wr1 * X[r1][x][c] for the band's th
// output rows and the span of low-res columns its tw output columns reach,
// live in dynamic shared memory (th * span * C floats), followed by `extra`
// bytes (A's [3][C] counts; none for B and C).  tw = W where that fits
// kStageBytes (the flagship: th = 4, span = w = 64, C = 21: 21.5 KB), else
// th, then tw, is halved; the whole card's shared memory is the last
// resort, and where not even th = 1 and tw = 4 fit it, there is no tiling.
constexpr int kBandRows = 4;
constexpr int kEntThreads = 256;
constexpr int kStageBytes = 96 * 1024;
constexpr int kMaxStageBytes = 227 * 1024;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

struct EntTiling {
  int th, tw, span, bands, ctiles;
};

// The most low-res columns that tw consecutive output columns reach: their
// taps lie within floor(sample) and floor(sample) + 1 of sample(x) = (x +
// 0.5) w / W - 0.5, so within floor((tw - 1) w / W) + 3 columns.
int tile_span(int w, int W, int tw) {
  if (tw >= W) return w;
  const long long span = (long long)(tw - 1) * w / W + 3;
  return span < w ? (int)span : w;
}

int ent_tiling(int w, int C, int H, int W, int extra, EntTiling* t) {
  if (H < 1 || W < 1 || w < 1 || C < 1) return 0;
  const int budgets[2] = {kStageBytes, kMaxStageBytes};
  for (int budget : budgets)
    for (int tw = W;; tw = tw >= W ? 1 << (31 - __builtin_clz((unsigned)W - 1u)) : tw / 2) {
      for (int th = kBandRows; th >= 1; th /= 2) {
        const int span = tile_span(w, W, tw);
        if ((long long)th * span * C * 4 + extra <= budget) {
          *t = EntTiling{th, tw, span, (H + th - 1) / th, (W + tw - 1) / tw};
          return 1;
        }
      }
      if (tw <= 4) break;
    }
  return 0;
}

// V consecutive values of a run as float32: one 16-byte load (float, V = 4),
// one 8-byte load (bfloat16, V = 4) or one scalar load (V = 1).
template <int V>
__device__ __forceinline__ void load_run(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void load_run(const __nv_bfloat16* p, float* v) {
  if constexpr (V == 4) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = __low2float(lo); v[1] = __high2float(lo); v[2] = __low2float(hi); v[3] = __high2float(hi);
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

template <int V>
__device__ __forceinline__ void store_run(float* p, const float* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// The band's rows interpolated into shared memory: for each of its `rows`
// output rows, the `run` = span * C contiguous values of low-res columns
// [lx0, lx0 + span) of its two tap rows, t = wr0 * X0 + wr1 * X1 (rows
// first; the column step v = wc0 * t0 + wc1 * t1 follows in pixels_argmax).
// The tap rows of consecutive output rows do not decrease, so a thread
// keeps the last two low-res rows it read (lo, hi) and reads each distinct
// row of the band once: 2-3 rows for 4 output rows at the flagship's 8x.
// 16-byte loads and stores where the runs are aligned.  Kernels B, C and A
// stage so.
template <typename T, int V>
__device__ __forceinline__ void stage_columns(const T* img, int w, int C, int lx0,
                                              const int2* __restrict__ row_idx,
                                              const float2* __restrict__ row_w, int rows,
                                              int j, float* t, int run) {
  int i_lo = -1, i_hi = -1;
  float lo[V], hi[V];
  for (int r = 0; r < rows; ++r) {
    const int2 ri = row_idx[r];
    const float2 rw = row_w[r];
    if (ri.x != i_lo) {
      if (ri.x == i_hi) {
#pragma unroll
        for (int u = 0; u < V; ++u) lo[u] = hi[u];
      } else {
        load_run<V>(img + ((size_t)ri.x * w + lx0) * C + j, lo);
      }
      i_lo = ri.x;
    }
    if (ri.y != i_hi) {
      if (ri.y == i_lo) {
#pragma unroll
        for (int u = 0; u < V; ++u) hi[u] = lo[u];
      } else {
        load_run<V>(img + ((size_t)ri.y * w + lx0) * C + j, hi);
      }
      i_hi = ri.y;
    }
    float o[V];
#pragma unroll
    for (int u = 0; u < V; ++u) o[u] = rw.x * lo[u] + rw.y * hi[u];
    store_run<V>(t + r * run + j, o);
  }
}

template <typename T>
__device__ __forceinline__ void stage_band_rows(
    const T* img, int w, int C, const int2* __restrict__ row_idx,
    const float2* __restrict__ row_w, int rows, int lx0, int run, float* t) {
  const bool vec = (w * C) % 4 == 0 && (lx0 * C) % 4 == 0 && run % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(img) % (4 * sizeof(T)) == 0;
  if (vec) {
    for (int j = 4 * threadIdx.x; j < run; j += 4 * kEntThreads)
      stage_columns<T, 4>(img, w, C, lx0, row_idx, row_w, rows, j, t, run);
  } else {
    for (int j = threadIdx.x; j < run; j += kEntThreads)
      stage_columns<T, 1>(img, w, C, lx0, row_idx, row_w, rows, j, t, run);
  }
}

// ex2.approx.ftz: one SFU operation (relative error ~2^-22; below 2^-126, 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// NP output pixels that share their two row-interpolated taps a and b (C
// values each; at the flagship's 8x, the 4 pixels of an aligned group do),
// with column weights wc0[p], wc1[p]: v = wc0 * a + wc1 * b (columns
// after rows, the JAX association), and each pixel's first maximum (strict
// >, like jnp.argmax) into m[p] and its class into best[p].  One walk over
// the classes reads a and b once for all NP pixels.  Kernels A, B and C.
template <int NP>
__device__ __forceinline__ void pixels_argmax(const float* a, const float* b, const float* wc0,
                                              const float* wc1, int C, float* m, int* best) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    m[p] = wc0[p] * a[0] + wc1[p] * b[0];
    best[p] = 0;
  }
  for (int k = 1; k < C; ++k) {
    const float x = a[k], y = b[k];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const float v = wc0[p] * x + wc1[p] * y;
      if (v > m[p]) {
        m[p] = v;
        best[p] = k;
      }
    }
  }
}

// Pass 1 of kernel B: pixels_argmax into arg[p].  Pass 2: the softmax
// entropy log z - s / z with z = sum 2^d, s = sum 2^d d, d = (v - max)
// log2(e) formed as (wc0 log2e) a + ((wc1 log2e) b - max log2e), so ln z -
// ln 2 s / z: one ex2.approx (SFU) a class.  Each pass reads a and b once
// for all NP pixels; nothing is kept per class, so any C takes the same two
// passes.  Returns the NP entropies' sum.
template <int NP>
__device__ __forceinline__ float pixels_entropy_argmax(const float* a, const float* b,
                                                       const float* wc0, const float* wc1, int C,
                                                       int* arg) {
  float m[NP], w0[NP], w1[NP], nm[NP], z[NP], s[NP];
  int best[NP];
  pixels_argmax<NP>(a, b, wc0, wc1, C, m, best);
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    w0[p] = wc0[p] * kLog2e;
    w1[p] = wc1[p] * kLog2e;
    nm[p] = -m[p] * kLog2e;
    z[p] = s[p] = 0.f;
  }
  for (int k = 0; k < C; ++k) {
    const float x = a[k], y = b[k];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const float d = __fmaf_rn(w0[p], x, __fmaf_rn(w1[p], y, nm[p]));
      const float e = fast_exp2(d);
      z[p] += e;
      s[p] = __fmaf_rn(e, d, s[p]);
    }
  }
  float ent = 0.f;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    arg[p] = best[p];
    ent += kLn2 * (log2f(z[p]) - __fdividef(s[p], z[p]));
  }
  return ent;
}

// The labels of NP pixels that share their taps into lab[p]: pixels_argmax
// for C; B (kEnt) takes pixels_entropy_argmax and adds the entropies to ent.
template <int NP, bool kEnt>
__device__ __forceinline__ void pixels_labels(const float* a, const float* b, const float* wc0,
                                              const float* wc1, int C, int* lab, float& ent) {
  if constexpr (kEnt) {
    ent += pixels_entropy_argmax<NP>(a, b, wc0, wc1, C, lab);
  } else {
    float m[NP];
    pixels_argmax<NP>(a, b, wc0, wc1, C, m, lab);
  }
}

// Kernels B's and C's walk over a staged band (rows output rows from y0,
// cols output columns from x0; t_s holds `run` values a row from low-res
// column lx0): each thread takes groups of 4 consecutive output pixels of a
// row (a warp 128 pixels: ~17 low-res columns, each a broadcast read from
// shared memory).  Where the 4 share their column taps one walk over the
// classes serves all 4, else each pixel walks alone.  The 4 labels leave as
// one 16-byte store where W % 4 == 0.  Returns the thread's entropy sum,
// taken in a fixed order (B, kEnt; 0 for C).
template <bool kEnt>
__device__ __forceinline__ float label_band(const float* t_s, const int2* col_idx,
                                           const float2* col_w, int C, int W, int y0, int x0,
                                           int rows, int cols, int lx0, int run, int* lab_img) {
  float ent = 0.f;
  const int gw = (cols + 3) / 4;  // groups of 4 output columns a row
  for (int g = threadIdx.x; g < rows * gw; g += kEntThreads) {
    const int r = g / gw;
    const int xg = x0 + 4 * (g - r * gw);
    const int nx = min(4, x0 + cols - xg);  // pixels in the group
    const float* t_row = t_s + r * run;
    const int2 c0 = col_idx[xg], c3 = col_idx[xg + nx - 1];
    int lab[4] = {0, 0, 0, 0};
    if (nx == 4 && c0.x == c3.x && c0.y == c3.y) {  // one pair of taps for all 4
      float w0[4], w1[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 cw = col_w[xg + j];
        w0[j] = cw.x;
        w1[j] = cw.y;
      }
      pixels_labels<4, kEnt>(t_row + (c0.x - lx0) * C, t_row + (c0.y - lx0) * C, w0, w1, C, lab,
                             ent);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < nx) {
          const int2 ci = col_idx[xg + j];
          const float2 cw = col_w[xg + j];
          pixels_labels<1, kEnt>(t_row + (ci.x - lx0) * C, t_row + (ci.y - lx0) * C, &cw.x,
                                 &cw.y, C, &lab[j], ent);
        }
    }
    int* dst = lab_img + (size_t)(y0 + r) * W + xg;
    if (W % 4 == 0) {  // then x0, cols and xg are multiples of 4 too
      *reinterpret_cast<int4*>(dst) = make_int4(lab[0], lab[1], lab[2], lab[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < nx) dst[j] = lab[j];
    }
  }
  return ent;
}

// Kernel B, first pass.  Grid: N * bands * ctiles blocks (ent_tiling); block
// i takes tile i % (bands * ctiles) of image i / (bands * ctiles), band-major.
// It stages its rows and labels them (label_band); the block's entropy sum,
// in a fixed order, goes to partial[image, tile].
template <typename T>
__global__ void __launch_bounds__(kEntThreads) up_ent_argmax_kernel(
    const T* __restrict__ logits,
    const int2* __restrict__ row_idx, const float2* __restrict__ row_w,
    const int2* __restrict__ col_idx, const float2* __restrict__ col_w,
    int h, int w, int C, int H, int W, EntTiling tl,
    int* __restrict__ labels_out, float* __restrict__ partial) {
  extern __shared__ __align__(16) float t_s[];  // [rows][run]
  const int tiles = tl.bands * tl.ctiles;
  const int n = blockIdx.x / tiles;
  const int tile = blockIdx.x - n * tiles;
  const int band = tile / tl.ctiles;
  const int y0 = band * tl.th, x0 = (tile - band * tl.ctiles) * tl.tw;
  const int rows = min(tl.th, H - y0), cols = min(tl.tw, W - x0);
  const int lx0 = col_idx[x0].x;
  const int run = (col_idx[x0 + cols - 1].y - lx0 + 1) * C;  // <= span * C
  stage_band_rows(logits + (size_t)n * h * w * C, w, C, row_idx + y0, row_w + y0, rows, lx0, run,
                  t_s);
  __syncthreads();

  float ent = label_band<true>(t_s, col_idx, col_w, C, W, y0, x0, rows, cols, lx0, run,
                               labels_out + (size_t)n * H * W);
  // fixed-order block sum: warp shuffles, then the first warp
  __shared__ float warp_part[kEntThreads / 32];
  ent = warp_sum(ent);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = ent;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < kEntThreads / 32 ? warp_part[threadIdx.x] : 0.f;
    v = warp_sum(v);
    if (threadIdx.x == 0) partial[(size_t)n * tiles + tile] = v;
  }
}

// Kernel B, second pass: one block per image sums its row of partials in a
// fixed order (in double) and scales by 1 / (H * W * log C).
__global__ void __launch_bounds__(THREADS) ent_finalize_kernel(
    const float* __restrict__ partial, int blocks_per_img, float inv_norm,
    float* __restrict__ ent_out) {
  const int n = blockIdx.x;
  double acc = 0.0;
  for (int i = threadIdx.x; i < blocks_per_img; i += THREADS)
    acc += partial[(size_t)n * blocks_per_img + i];
  __shared__ double warp_part[THREADS / 32];
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    double v = threadIdx.x < THREADS / 32 ? warp_part[threadIdx.x] : 0.0;
    v = warp_sum(v);
    if (threadIdx.x == 0) ent_out[n] = (float)(v * (double)inv_norm);
  }
}

// Kernel C.  Grid: N * bands * ctiles blocks (ent_tiling), band-major, as
// B's.  A block stages its rows and labels them (label_band with the argmax
// pass alone).
template <typename T>
__global__ void __launch_bounds__(kEntThreads) up_argmax_map_kernel(
    const T* __restrict__ logits,
    const int2* __restrict__ row_idx, const float2* __restrict__ row_w,
    const int2* __restrict__ col_idx, const float2* __restrict__ col_w,
    int h, int w, int C, int H, int W, EntTiling tl, int* __restrict__ labels_out) {
  extern __shared__ __align__(16) float t_s[];  // [rows][run]
  const int tiles = tl.bands * tl.ctiles;
  const int n = blockIdx.x / tiles;
  const int tile = blockIdx.x - n * tiles;
  const int band = tile / tl.ctiles;
  const int y0 = band * tl.th, x0 = (tile - band * tl.ctiles) * tl.tw;
  const int rows = min(tl.th, H - y0), cols = min(tl.tw, W - x0);
  const int lx0 = col_idx[x0].x;
  const int run = (col_idx[x0 + cols - 1].y - lx0 + 1) * C;  // <= span * C
  logits += (size_t)n * h * w * C;  // this image
  stage_band_rows(logits, w, C, row_idx + y0, row_w + y0, rows, lx0, run, t_s);
  __syncthreads();
  label_band<false>(t_s, col_idx, col_w, C, W, y0, x0, rows, cols, lx0, run,
                    labels_out + (size_t)n * H * W);
}

// Kernel A.  Grid: count * bands * ctiles blocks (ent_tiling with the counts'
// 12 C bytes); block i takes tile i % (bands * ctiles) of image i / (bands *
// ctiles), band-major, as B does: rows n >= count get no block.  It stages
// its rows, then each thread takes groups of 4 consecutive output pixels of
// a row and their labels (one 16-byte load where lvec: W % 4 == 0 and the
// labels 16-byte aligned) and counts each pixel with one or two shared
// atomicAdds.
template <typename T>
__global__ void __launch_bounds__(kEntThreads) up_argmax_conf_kernel(
    const T* __restrict__ logits, const int* __restrict__ labels,
    const int2* __restrict__ row_idx, const float2* __restrict__ row_w,
    const int2* __restrict__ col_idx, const float2* __restrict__ col_w,
    int h, int w, int C, int H, int W, EntTiling tl, int lvec, int* __restrict__ counts) {
  extern __shared__ __align__(16) float t_s[];  // [rows][run], then [3][C] int32
  int* hist = reinterpret_cast<int*>(t_s + tl.th * tl.span * C);  // TP, FP, FN
  for (int i = threadIdx.x; i < 3 * C; i += kEntThreads) hist[i] = 0;
  const int tiles = tl.bands * tl.ctiles;
  const int n = blockIdx.x / tiles;
  const int tile = blockIdx.x - n * tiles;
  const int band = tile / tl.ctiles;
  const int y0 = band * tl.th, x0 = (tile - band * tl.ctiles) * tl.tw;
  const int rows = min(tl.th, H - y0), cols = min(tl.tw, W - x0);
  const int lx0 = col_idx[x0].x;
  const int run = (col_idx[x0 + cols - 1].y - lx0 + 1) * C;  // <= span * C
  const T* img = logits + (size_t)n * h * w * C;
  stage_band_rows(img, w, C, row_idx + y0, row_w + y0, rows, lx0, run, t_s);
  __syncthreads();

  const int gw = (cols + 3) / 4;  // groups of 4 output columns a row
  const int groups = rows * gw;
  const int* lab_img = labels + (size_t)n * H * W;
  for (int g = threadIdx.x; g < groups; g += kEntThreads) {
    const int r = g / gw;
    const int xg = x0 + 4 * (g - r * gw);
    const int nx = min(4, x0 + cols - xg);  // pixels in the group
    const int* src = lab_img + (size_t)(y0 + r) * W + xg;
    int truth[4];
    if (lvec) {  // then nx == 4
      const int4 q = __ldg(reinterpret_cast<const int4*>(src));
      truth[0] = q.x; truth[1] = q.y; truth[2] = q.z; truth[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) truth[j] = j < nx ? __ldg(src + j) : -1;
    }
    const float* t_row = t_s + r * run;
    const int2 c0 = col_idx[xg], c3 = col_idx[xg + nx - 1];
    float m[4];
    int pred[4] = {0, 0, 0, 0};
    if (c0.x == c3.x && c0.y == c3.y && nx == 4) {  // one pair of taps for all 4
      float w0[4], w1[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 cw = col_w[xg + j];
        w0[j] = cw.x;
        w1[j] = cw.y;
      }
      pixels_argmax<4>(t_row + (c0.x - lx0) * C, t_row + (c0.y - lx0) * C, w0, w1, C, m, pred);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < nx) {
          const int2 ci = col_idx[xg + j];
          const float2 cw = col_w[xg + j];
          pixels_argmax<1>(t_row + (ci.x - lx0) * C, t_row + (ci.y - lx0) * C, &cw.x, &cw.y, C,
                           &m[j], &pred[j]);
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nx) {
        const int p = pred[j], t = truth[j];
        if (t == p) {
          atomicAdd(&hist[p], 1);                                // TP
        } else {
          atomicAdd(&hist[C + p], 1);                            // FP: truth is another class or void
          if (t >= 0 && t < C) atomicAdd(&hist[2 * C + t], 1);  // FN
        }
      }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * C; i += kEntThreads)
    if (hist[i]) atomicAdd(&counts[i], hist[i]);
}

}  // namespace

extern "C" {

int ee_threads_per_block() { return THREADS; }

const char* ee_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// logits (N, h, w, C) f32 or bf16 (is_bf16), tap tables (H, 2) / (W, 2)
// int32 + f32, labels (N, H, W) int32, counts (3, C) int32 zeroed by the
// caller.  Rows n >= count are skipped.  Returns cudaGetLastError().
int ee_upsample_argmax_confusion(
    const void* logits, int is_bf16,
    const void* row_idx, const void* row_w, const void* col_idx, const void* col_w,
    const void* labels, int count, int h, int w, int C, int H, int W, void* counts, void* stream) {
  EntTiling tl;
  const int extra = 3 * C * (int)sizeof(int);
  if (count < 1 || h < 1 || !ent_tiling(w, C, H, W, extra, &tl)) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)tl.bands * tl.ctiles;
  if (tiles * count > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)tl.th * tl.span * C * sizeof(float) + extra;
  const int lvec = W % 4 == 0 && reinterpret_cast<uintptr_t>(labels) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (is_bf16) {
    err = cudaFuncSetAttribute(up_argmax_conf_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    up_argmax_conf_kernel<__nv_bfloat16><<<(unsigned)(tiles * count), kEntThreads, smem, s>>>(
        (const __nv_bfloat16*)logits, (const int*)labels, (const int2*)row_idx,
        (const float2*)row_w, (const int2*)col_idx, (const float2*)col_w,
        h, w, C, H, W, tl, lvec, (int*)counts);
  } else {
    err = cudaFuncSetAttribute(up_argmax_conf_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    up_argmax_conf_kernel<float><<<(unsigned)(tiles * count), kEntThreads, smem, s>>>(
        (const float*)logits, (const int*)labels, (const int2*)row_idx,
        (const float2*)row_w, (const int2*)col_idx, (const float2*)col_w,
        h, w, C, H, W, tl, lvec, (int*)counts);
  }
  return (int)cudaGetLastError();
}

// logits (N, h, w, C) f32 or bf16 -> labels_out (N, H, W) int32.  Returns
// cudaErrorInvalidValue where no tiling fits shared memory
// (ee_ent_partials_per_image is 0), else cudaGetLastError().
int ee_upsample_argmax(
    const void* logits, int is_bf16,
    const void* row_idx, const void* row_w, const void* col_idx, const void* col_w,
    int N, int h, int w, int C, int H, int W, void* labels_out, void* stream) {
  EntTiling tl;
  if (N < 1 || h < 1 || !ent_tiling(w, C, H, W, 0, &tl)) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)tl.bands * tl.ctiles;
  if (tiles * N > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)tl.th * tl.span * C * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (is_bf16) {
    err = cudaFuncSetAttribute(up_argmax_map_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    up_argmax_map_kernel<__nv_bfloat16><<<(unsigned)(tiles * N), kEntThreads, smem, s>>>(
        (const __nv_bfloat16*)logits, (const int2*)row_idx, (const float2*)row_w,
        (const int2*)col_idx, (const float2*)col_w, h, w, C, H, W, tl, (int*)labels_out);
  } else {
    err = cudaFuncSetAttribute(up_argmax_map_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    up_argmax_map_kernel<float><<<(unsigned)(tiles * N), kEntThreads, smem, s>>>(
        (const float*)logits, (const int2*)row_idx, (const float2*)row_w,
        (const int2*)col_idx, (const float2*)col_w, h, w, C, H, W, tl, (int*)labels_out);
  }
  return (int)cudaGetLastError();
}

// Partials a image of ee_upsample_entropy_argmax (its tiles, and C's), 0 if
// no tiling fits shared memory.
int ee_ent_partials_per_image(int h, int w, int C, int H, int W) {
  EntTiling t;
  return h >= 1 && ent_tiling(w, C, H, W, 0, &t) ? t.bands * t.ctiles : 0;
}

// logits (N, h, w, C) -> labels_out (N, H, W) int32, ent_out (N,) f32;
// partial is (N, ee_ent_partials_per_image(h, w, C, H, W)) f32 scratch.
// Returns cudaGetLastError() after both launches.
int ee_upsample_entropy_argmax(
    const void* logits, int is_bf16,
    const void* row_idx, const void* row_w, const void* col_idx, const void* col_w,
    int N, int h, int w, int C, int H, int W, float inv_norm,
    void* labels_out, void* partial, void* ent_out, void* stream) {
  EntTiling tl;
  if (N < 1 || h < 1 || !ent_tiling(w, C, H, W, 0, &tl)) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)tl.bands * tl.ctiles;
  if (tiles * N > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)tl.th * tl.span * C * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (is_bf16) {
    err = cudaFuncSetAttribute(up_ent_argmax_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    up_ent_argmax_kernel<__nv_bfloat16><<<(unsigned)(tiles * N), kEntThreads, smem, s>>>(
        (const __nv_bfloat16*)logits, (const int2*)row_idx, (const float2*)row_w,
        (const int2*)col_idx, (const float2*)col_w, h, w, C, H, W, tl,
        (int*)labels_out, (float*)partial);
  } else {
    err = cudaFuncSetAttribute(up_ent_argmax_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    up_ent_argmax_kernel<float><<<(unsigned)(tiles * N), kEntThreads, smem, s>>>(
        (const float*)logits, (const int2*)row_idx, (const float2*)row_w,
        (const int2*)col_idx, (const float2*)col_w, h, w, C, H, W, tl,
        (int*)labels_out, (float*)partial);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ent_finalize_kernel<<<N, THREADS, 0, s>>>((const float*)partial, (int)tiles, inv_norm,
                                            (float*)ent_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
