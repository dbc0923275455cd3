// Sort-free histogram Lovász kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the two TPU (Pallas) kernels of ops/pallas/hist_kernel.py:
//   E  hist2d_weighted_pallas (_hist_kernel)
//      -> hist_kernel + hist_finalize_kernel: per row, four histograms over
//         `bins` uniform-width descending error buckets: pixel count, fg
//         count, error sum, fg error sum.  The forward of the -G Lovász.
//   F  table_lookup_pallas (_lookup_kernel)
//      -> lookup_kernel: per pixel, the fg or bg entry of its row's
//         (2, bins) table at the pixel's bucket, 0 on void.  The backward.
//
// Bucket of an error e in a row with (emax, inv_w): trunc(clip((emax - e) *
// inv_w, 0, bins - 1)), in float32 with explicit round-to-nearest subtract
// and multiply (no FMA contraction), the expression of the JAX package and
// of the plain PyTorch versions: the bucket ids are equal bit for bit.  A
// slot is void when e <= -1e29 (void pixels carry -1e30).
//
// Design.  The TPU kernel is a one-hot matrix product on the MXU with
// per-chunk (4 * bins) partials summed in XLA; on Hopper a histogram is a
// scatter into shared memory.
//   E  A block takes one (row, range of `chunk` pixels); `chunk` is at
//      least 64 * bins, so a block's histogram is small beside the pixels it
//      read.  It keeps int32 counts (n, f) and float32 sums (S, Sf) in
//      dynamic shared memory (16 * bins bytes: 128 KB at bins 8192, above
//      the 48 KB default, hence the opt-in), then adds its nonzero buckets
//      to the row's global histogram with one atomic each: int32 counts
//      (exact and deterministic) and float32 sums (their order, and so their
//      last bits, change from run to run).  A second kernel writes the
//      counts as float32 beside the sums.  No (rows, chunks, 4, bins)
//      partials are written.
//   F  A block stages its row's (2, bins) table in shared memory once and
//      walks `chunk` pixels.  The output is tab * valid, as in the plain
//      version, so signed zeros agree too.
// Bound (H100 SXM, 3.35 TB/s): E reads 4 bytes of error and 1 of fg per
// pixel, F those and writes 4: at 63 rows of 2^22, ~0.39 and ~0.71 ms.
// Shared-memory atomics on a few hot buckets contend (many equal errors
// land in one bucket); warp-aggregated updates are later work.

#include <cuda_runtime.h>

namespace {

constexpr int HIST_THREADS = 512;
constexpr int LOOKUP_THREADS = 256;
constexpr float VALID_THRESH = -1e29f;
constexpr int MAX_BINS = 8192;  // E: 16 * 8192 bytes of shared memory

__device__ __forceinline__ int bucket_id(float e, float emax, float inv_w, int bins) {
  float t = __fmul_rn(__fsub_rn(emax, e), inv_w);
  t = fminf(fmaxf(t, 0.f), (float)(bins - 1));
  return (int)t;
}

// Kernel E, first pass.  Grid (rows, blocks per row).
__global__ void __launch_bounds__(HIST_THREADS) hist_kernel(
    const float* __restrict__ err, const unsigned char* __restrict__ fg,
    const float* __restrict__ emax, const float* __restrict__ inv_w,
    long long P, int bins, long long chunk,
    int* __restrict__ counts, float* __restrict__ out) {
  extern __shared__ int smem[];
  int* s_n = smem;
  int* s_f = s_n + bins;
  float* s_S = reinterpret_cast<float*>(s_f + bins);
  float* s_Sf = s_S + bins;
  for (int i = threadIdx.x; i < 4 * bins; i += HIST_THREADS) smem[i] = 0;  // 0.0f is all-zero bits
  __syncthreads();

  const long long row = blockIdx.x;
  const float em = emax[row];
  const float iw = inv_w[row];
  const float* e_row = err + row * P;
  const unsigned char* f_row = fg + row * P;
  const long long start = (long long)blockIdx.y * chunk;
  const long long end = start + chunk < P ? start + chunk : P;
  for (long long p = start + threadIdx.x; p < end; p += HIST_THREADS) {
    const float e = e_row[p];
    if (!(e > VALID_THRESH)) continue;
    const int b = bucket_id(e, em, iw, bins);
    atomicAdd(&s_n[b], 1);
    atomicAdd(&s_S[b], e);
    if (f_row[p]) {
      atomicAdd(&s_f[b], 1);
      atomicAdd(&s_Sf[b], e);
    }
  }
  __syncthreads();

  int* c_row = counts + row * 2 * bins;
  float* o_row = out + row * 4 * bins;
  for (int i = threadIdx.x; i < bins; i += HIST_THREADS) {
    const int n = s_n[i];
    if (n == 0) continue;  // f, S and Sf are then empty too
    atomicAdd(&c_row[i], n);
    atomicAdd(&o_row[2 * bins + i], s_S[i]);
    const int f = s_f[i];
    if (f) {
      atomicAdd(&c_row[bins + i], f);
      atomicAdd(&o_row[3 * bins + i], s_Sf[i]);
    }
  }
}

// Kernel E, second pass: out[r, 0:2, :] = float(counts[r, 0:2, :]).
__global__ void hist_finalize_kernel(const int* __restrict__ counts, long long n_counts,
                                     int bins, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_counts) return;
  const long long row = i / (2 * bins);
  out[row * 4 * bins + (i - row * 2 * bins)] = (float)counts[i];
}

// Kernel F.  Grid (rows, blocks per row).
__global__ void __launch_bounds__(LOOKUP_THREADS) lookup_kernel(
    const float* __restrict__ err, const unsigned char* __restrict__ fg,
    const float* __restrict__ emax, const float* __restrict__ inv_w,
    const float* __restrict__ tables, long long P, int bins, long long chunk,
    float* __restrict__ out) {
  extern __shared__ float tab[];  // [2][bins]: fg weights, then bg weights
  const long long row = blockIdx.x;
  const float* t_row = tables + row * 2 * bins;
  for (int i = threadIdx.x; i < 2 * bins; i += LOOKUP_THREADS) tab[i] = t_row[i];
  __syncthreads();

  const float em = emax[row];
  const float iw = inv_w[row];
  const float* e_row = err + row * P;
  const unsigned char* f_row = fg + row * P;
  float* o_row = out + row * P;
  const long long start = (long long)blockIdx.y * chunk;
  const long long end = start + chunk < P ? start + chunk : P;
  for (long long p = start + threadIdx.x; p < end; p += LOOKUP_THREADS) {
    const float e = e_row[p];
    const float valid = e > VALID_THRESH ? 1.f : 0.f;
    const int b = bucket_id(e, em, iw, bins);
    o_row[p] = tab[f_row[p] ? b : bins + b] * valid;
  }
}

int grid_of(long long rows, long long P, long long chunk, dim3* grid) {
  const long long per_row = (P + chunk - 1) / chunk;
  if (rows <= 0 || P <= 0 || rows > 0x7fffffffLL || per_row > 65535) return 0;
  *grid = dim3((unsigned)rows, (unsigned)per_row);
  return 1;
}

}  // namespace

extern "C" {

int ee_hist_max_bins() { return MAX_BINS; }

// errors (rows, P) f32, fg (rows, P) uint8 (nonzero = foreground), emax and
// inv_w (rows,) f32.  counts (rows, 2, bins) int32 and out (rows, 4, bins)
// f32 must be zeroed by the caller.  Returns cudaGetLastError() after both
// launches.
int ee_hist2d_weighted(const void* errors, const void* fg, const void* emax,
                       const void* inv_w, long long rows, long long P, int bins,
                       long long chunk, void* counts, void* out, void* stream) {
  dim3 grid;
  if (bins < 1 || bins > MAX_BINS || chunk < 1 || !grid_of(rows, P, chunk, &grid))
    return (int)cudaErrorInvalidValue;
  const size_t smem = 16 * (size_t)bins;
  cudaError_t err = cudaFuncSetAttribute(hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  hist_kernel<<<grid, HIST_THREADS, smem, s>>>(
      (const float*)errors, (const unsigned char*)fg, (const float*)emax, (const float*)inv_w,
      P, bins, chunk, (int*)counts, (float*)out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n_counts = rows * 2 * bins;
  const long long blocks = (n_counts + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  hist_finalize_kernel<<<(unsigned)blocks, 256, 0, s>>>((const int*)counts, n_counts, bins,
                                                        (float*)out);
  return (int)cudaGetLastError();
}

// errors, fg, emax, inv_w as above; tables (rows, 2, bins) f32 -> out
// (rows, P) f32.  Returns cudaGetLastError().
int ee_table_lookup(const void* errors, const void* fg, const void* emax, const void* inv_w,
                    const void* tables, long long rows, long long P, int bins, long long chunk,
                    void* out, void* stream) {
  dim3 grid;
  if (bins < 1 || bins > MAX_BINS || chunk < 1 || !grid_of(rows, P, chunk, &grid))
    return (int)cudaErrorInvalidValue;
  const size_t smem = 8 * (size_t)bins;
  cudaError_t err = cudaFuncSetAttribute(lookup_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  lookup_kernel<<<grid, LOOKUP_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)errors, (const unsigned char*)fg, (const float*)emax, (const float*)inv_w,
      (const float*)tables, P, bins, chunk, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
