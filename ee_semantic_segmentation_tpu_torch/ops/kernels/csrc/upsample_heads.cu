// Fused bilinear-upsample eval heads for Hopper (sm_90a), plain C interface.
//
// Replaces the two TPU (Pallas) kernels of the eval path:
//   A  ee_semantic_segmentation_tpu/ops/pallas/upsample_argmax.py:
//      upsample_argmax_confusion (_up_argmax_conf_kernel)
//      -> up_argmax_conf_kernel: bilinear upsample + argmax + per-class
//         TP/FP/FN over the rows n < count; only (3, C) counts leave.
//   B  ee_semantic_segmentation_tpu/ops/pallas/upsample_argmax.py:
//      upsample_entropy_argmax (_up_ent_argmax_kernel)
//      -> up_ent_argmax_kernel + ent_finalize_kernel: the same upsample and
//         argmax, plus each image's mean softmax entropy / log C.
//   C  ee_semantic_segmentation_tpu/ops/pallas/upsample_argmax.py:
//      upsample_argmax (_up_argmax_kernel)
//      -> up_argmax_kernel: the same upsample and argmax, the (N, H, W)
//         int32 label map only (the similarity gates read label maps).
//
// Design.  One thread per output pixel.  The separable resize
// up_c = Wh @ X_c @ Ww^T has at most two nonzero taps per output row and
// column (bilinear, upsampling), so the host passes each row's and column's
// (i0, i1, w0, w1) taken from the same weight matrices the JAX kernel uses
// (_resize_matrix_np) and a thread reads the 2x2 low-res taps of every
// class.  It interpolates over rows first, then over columns: the JAX
// association (t1 = Wh @ X, then t1 @ Ww^T).  FP32 FFMA only, no tensor
// cores: the JAX kernel pins full f32 so argmax near-ties stay stable.  The
// argmax keeps the first maximum (strict >), like jnp.argmax.
//   A counts into a per-block shared int32 [3][C] histogram, then one global
//     atomicAdd per bin and block into an int32 (3, C) buffer: integer
//     atomics make the counts exact and deterministic (f32 sums stop being
//     exact above 2^24 pixels per class).
//   C writes the label and nothing else.
//   B keeps the C upsampled values in registers (C <= 32; larger C takes a
//     second pass that recomputes them), takes m = max, z = sum e^(v-m),
//     s = sum e^(v-m)(v-m) and the pixel entropy log z - s/z.  Each block
//     writes its sum to an (N, blocks) scratch; a second kernel reduces each
//     row in a fixed order, so the result is deterministic.
//
// Bound at the flagship shape (N=16, h=w=64, C=21, H=W=512; H100 SXM,
// 3.35 TB/s, 67 TFLOP/s f32), estimated from the shapes:
//   A reads 5.5 MB of f32 logits and 16.8 MB of int32 labels: ~6.7 us of
//     memory; ~4.2 M pixels x (84 FMA + 21 compares): ~6-8 us of FP32.
//     Bound ~8 us.
//   B reads 5.5 MB and writes 16.8 MB of label maps; 21 exp per pixel is
//     88 M SFU operations, ~20 us: the SFU bounds it.
//   C reads 5.5 MB and writes 16.8 MB of label maps: ~6.7 us of memory, the
//     same ~6-8 us of FP32 as A.
// The measured times sit beside these in PERF.md.  Making either fast
// (staging the (C, h, w) block in shared memory, vectorised label loads) is
// later work; this version is simple and right first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_REG_C = 32;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The 2x2 low-res taps of one output pixel, for every class.
template <typename T>
struct PixelTaps {
  const T* r0c0;
  const T* r0c1;
  const T* r1c0;
  const T* r1c1;
  float wr0, wr1, wc0, wc1;

  __device__ __forceinline__ float value(int k) const {
    const float t0 = wr0 * to_f32(r0c0[k]) + wr1 * to_f32(r1c0[k]);  // rows first
    const float t1 = wr0 * to_f32(r0c1[k]) + wr1 * to_f32(r1c1[k]);
    return wc0 * t0 + wc1 * t1;                                       // then columns
  }
};

template <typename T>
__device__ __forceinline__ PixelTaps<T> pixel_taps(
    const T* img, int p, int w, int C, int W,
    const int2* __restrict__ row_idx, const float2* __restrict__ row_w,
    const int2* __restrict__ col_idx, const float2* __restrict__ col_w) {
  const int oy = p / W;
  const int ox = p - oy * W;
  const int2 ri = row_idx[oy];
  const int2 ci = col_idx[ox];
  const float2 rw = row_w[oy];
  const float2 cw = col_w[ox];
  PixelTaps<T> t;
  t.r0c0 = img + ((size_t)ri.x * w + ci.x) * C;
  t.r0c1 = img + ((size_t)ri.x * w + ci.y) * C;
  t.r1c0 = img + ((size_t)ri.y * w + ci.x) * C;
  t.r1c1 = img + ((size_t)ri.y * w + ci.y) * C;
  t.wr0 = rw.x;
  t.wr1 = rw.y;
  t.wc0 = cw.x;
  t.wc1 = cw.y;
  return t;
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

// The first maximum of the C upsampled values (strict >, like jnp.argmax).
template <typename T>
__device__ __forceinline__ int taps_argmax(const PixelTaps<T>& taps, int C) {
  float best = taps.value(0);
  int pred = 0;
  for (int k = 1; k < C; ++k) {
    const float v = taps.value(k);
    if (v > best) {
      best = v;
      pred = k;
    }
  }
  return pred;
}

// Kernel A.  Grid: count * blocks_per_img blocks; block b covers pixels
// [THREADS * (b % blocks_per_img), +THREADS) of image b / blocks_per_img.
// Rows n >= count get no block at all.
template <typename T>
__global__ void __launch_bounds__(THREADS) up_argmax_conf_kernel(
    const T* __restrict__ logits, const int* __restrict__ labels,
    const int2* __restrict__ row_idx, const float2* __restrict__ row_w,
    const int2* __restrict__ col_idx, const float2* __restrict__ col_w,
    int h, int w, int C, int H, int W, int blocks_per_img, int* __restrict__ counts) {
  extern __shared__ int hist[];  // [3][C]: TP, FP, FN
  for (int i = threadIdx.x; i < 3 * C; i += THREADS) hist[i] = 0;
  __syncthreads();

  const int n = blockIdx.x / blocks_per_img;
  const int p = (blockIdx.x - n * blocks_per_img) * THREADS + threadIdx.x;
  const int HW = H * W;
  if (p < HW) {
    const PixelTaps<T> taps = pixel_taps(logits + (size_t)n * h * w * C, p, w, C, W,
                                         row_idx, row_w, col_idx, col_w);
    const int pred = taps_argmax(taps, C);
    const int lab = labels[(size_t)n * HW + p];
    if (lab == pred) {
      atomicAdd(&hist[pred], 1);                          // TP
    } else {
      atomicAdd(&hist[C + pred], 1);                      // FP: truth is another class or void
      if (lab >= 0 && lab < C) atomicAdd(&hist[2 * C + lab], 1);  // FN
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * C; i += THREADS)
    if (hist[i]) atomicAdd(&counts[i], hist[i]);
}

// Kernel C.  Same grid layout as A over all N rows.
template <typename T>
__global__ void __launch_bounds__(THREADS) up_argmax_kernel(
    const T* __restrict__ logits,
    const int2* __restrict__ row_idx, const float2* __restrict__ row_w,
    const int2* __restrict__ col_idx, const float2* __restrict__ col_w,
    int h, int w, int C, int H, int W, int blocks_per_img, int* __restrict__ labels_out) {
  const int n = blockIdx.x / blocks_per_img;
  const int p = (blockIdx.x - n * blocks_per_img) * THREADS + threadIdx.x;
  const int HW = H * W;
  if (p >= HW) return;
  const PixelTaps<T> taps = pixel_taps(logits + (size_t)n * h * w * C, p, w, C, W,
                                       row_idx, row_w, col_idx, col_w);
  labels_out[(size_t)n * HW + p] = taps_argmax(taps, C);
}

// Kernel B, first pass.  Same grid layout as A over all N rows.
template <typename T>
__global__ void __launch_bounds__(THREADS) up_ent_argmax_kernel(
    const T* __restrict__ logits,
    const int2* __restrict__ row_idx, const float2* __restrict__ row_w,
    const int2* __restrict__ col_idx, const float2* __restrict__ col_w,
    int h, int w, int C, int H, int W, int blocks_per_img,
    int* __restrict__ labels_out, float* __restrict__ partial) {
  const int n = blockIdx.x / blocks_per_img;
  const int blk = blockIdx.x - n * blocks_per_img;
  const int p = blk * THREADS + threadIdx.x;
  const int HW = H * W;
  float ent = 0.f;
  if (p < HW) {
    const PixelTaps<T> taps = pixel_taps(logits + (size_t)n * h * w * C, p, w, C, W,
                                         row_idx, row_w, col_idx, col_w);
    float m, z = 0.f, s = 0.f;
    int arg = 0;
    if (C <= MAX_REG_C) {
      float v[MAX_REG_C];
#pragma unroll
      for (int k = 0; k < MAX_REG_C; ++k)
        if (k < C) v[k] = taps.value(k);
      m = v[0];
#pragma unroll
      for (int k = 1; k < MAX_REG_C; ++k)
        if (k < C && v[k] > m) {
          m = v[k];
          arg = k;
        }
#pragma unroll
      for (int k = 0; k < MAX_REG_C; ++k)
        if (k < C) {
          const float d = v[k] - m;
          const float e = expf(d);
          z += e;
          s += e * d;
        }
    } else {  // too many classes for registers: recompute in a second pass
      m = taps.value(0);
      for (int k = 1; k < C; ++k) {
        const float v = taps.value(k);
        if (v > m) {
          m = v;
          arg = k;
        }
      }
      for (int k = 0; k < C; ++k) {
        const float d = taps.value(k) - m;
        const float e = expf(d);
        z += e;
        s += e * d;
      }
    }
    labels_out[(size_t)n * HW + p] = arg;
    ent = logf(z) - s / z;
  }
  // fixed-order block sum: warp shuffles, then the first warp
  __shared__ float warp_part[THREADS / 32];
  ent = warp_sum(ent);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = ent;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < THREADS / 32 ? warp_part[threadIdx.x] : 0.f;
    v = warp_sum(v);
    if (threadIdx.x == 0) partial[(size_t)n * blocks_per_img + blk] = v;
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

int grid_blocks(int rows, int H, int W, int* blocks_per_img) {
  const long long bpi = ((long long)H * W + THREADS - 1) / THREADS;
  const long long total = bpi * rows;
  if (total <= 0 || total > 0x7fffffffLL) return 0;
  *blocks_per_img = (int)bpi;
  return (int)total;
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
  int bpi = 0;
  const int blocks = grid_blocks(count, H, W, &bpi);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = 3 * (size_t)C * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    up_argmax_conf_kernel<__nv_bfloat16><<<blocks, THREADS, smem, s>>>(
        (const __nv_bfloat16*)logits, (const int*)labels, (const int2*)row_idx,
        (const float2*)row_w, (const int2*)col_idx, (const float2*)col_w,
        h, w, C, H, W, bpi, (int*)counts);
  } else {
    up_argmax_conf_kernel<float><<<blocks, THREADS, smem, s>>>(
        (const float*)logits, (const int*)labels, (const int2*)row_idx,
        (const float2*)row_w, (const int2*)col_idx, (const float2*)col_w,
        h, w, C, H, W, bpi, (int*)counts);
  }
  return (int)cudaGetLastError();
}

// logits (N, h, w, C) f32 or bf16 -> labels_out (N, H, W) int32.  Returns
// cudaGetLastError().
int ee_upsample_argmax(
    const void* logits, int is_bf16,
    const void* row_idx, const void* row_w, const void* col_idx, const void* col_w,
    int N, int h, int w, int C, int H, int W, void* labels_out, void* stream) {
  int bpi = 0;
  const int blocks = grid_blocks(N, H, W, &bpi);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    up_argmax_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        (const __nv_bfloat16*)logits, (const int2*)row_idx, (const float2*)row_w,
        (const int2*)col_idx, (const float2*)col_w, h, w, C, H, W, bpi, (int*)labels_out);
  } else {
    up_argmax_kernel<float><<<blocks, THREADS, 0, s>>>(
        (const float*)logits, (const int2*)row_idx, (const float2*)row_w,
        (const int2*)col_idx, (const float2*)col_w, h, w, C, H, W, bpi, (int*)labels_out);
  }
  return (int)cudaGetLastError();
}

// logits (N, h, w, C) -> labels_out (N, H, W) int32, ent_out (N,) f32;
// partial is (N, ceil(H*W / THREADS)) f32 scratch.  Returns
// cudaGetLastError() after both launches.
int ee_upsample_entropy_argmax(
    const void* logits, int is_bf16,
    const void* row_idx, const void* row_w, const void* col_idx, const void* col_w,
    int N, int h, int w, int C, int H, int W, float inv_norm,
    void* labels_out, void* partial, void* ent_out, void* stream) {
  int bpi = 0;
  const int blocks = grid_blocks(N, H, W, &bpi);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    up_ent_argmax_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        (const __nv_bfloat16*)logits, (const int2*)row_idx, (const float2*)row_w,
        (const int2*)col_idx, (const float2*)col_w, h, w, C, H, W, bpi,
        (int*)labels_out, (float*)partial);
  } else {
    up_ent_argmax_kernel<float><<<blocks, THREADS, 0, s>>>(
        (const float*)logits, (const int2*)row_idx, (const float2*)row_w,
        (const int2*)col_idx, (const float2*)col_w, h, w, C, H, W, bpi,
        (int*)labels_out, (float*)partial);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ent_finalize_kernel<<<N, THREADS, 0, s>>>((const float*)partial, bpi, inv_norm,
                                            (float*)ent_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
