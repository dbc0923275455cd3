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
//   E  A block takes one (row, range of `chunk` pixels, 64 * bins <= chunk
//      < 2^20) with 16-byte error and 4-byte fg loads where 4 | P.  Each
//      key (the bucket of a foreground pixel, or bins + the bucket of a
//      background one) has a count, an integer sum and a float sum in
//      dynamic shared memory (24 * bins bytes: 192 KB at bins 8192, hence
//      the opt-in).  An error whose bucket's fixed-point scale (a power of
//      two, from the bucket's upper edge) puts it in [2^16, 2^24) adds its
//      rounded scaled value to the integer sum (rounding <= 2^-17 of the
//      error); any other (tiny, zero, negative or outside its bucket) adds
//      to the float sum.  So a valid pixel costs two 32-bit integer atomics
//      (a count and a sum; a carry out of the sum's low word costs a third
//      now and then).  A shared float (or 64-bit) atomicAdd is a
//      compare-and-swap loop on sm_90 (ATOMS.CAST.SPIN): on a row whose
//      pixels crowd one bucket, as a trained model's do, those loops retry,
//      and a kernel with float sums in shared memory takes 17.4 ms at 63 x
//      2^22 where it takes 1.18 on uniform errors (one H100 80GB HBM3 at
//      700 W, PERF.md).  The four pixels of one load that share a key
//      go to shared memory as one set of atomics.  The block then adds its
//      nonempty keys to the row's totals with global atomics (counts and
//      integer sums exact, float sums in the atomics' order), and a second
//      kernel forms [n, f, S, Sf] per bucket, each sum its integer part over
//      the scale plus its float part in double, rounded once: the sums come
//      out within ~1e-7 of a float64 sum, where a float32 sum of a crowded
//      bucket (millions of errors) drifts by ~1e-4.
//   F  A block stages its row's (2, bins) table in shared memory once and
//      walks `chunk` pixels.  The output is tab * valid, as in the plain
//      version, so signed zeros agree too.
// Bound (H100 SXM, 3.35 TB/s): E reads 4 bytes of error and 1 of fg per
// pixel, F those and writes 4: at 63 rows of 2^22, ~0.39 and ~0.71 ms.  On
// one H100 80GB HBM3 at 700 W (PERF.md): E 0.667 ms on uniform errors,
// 0.662 and 0.754 on clustered ones; F 0.876 ms.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int HIST_THREADS = 512;
constexpr int LOOKUP_THREADS = 256;
constexpr float VALID_THRESH = -1e29f;
constexpr int MAX_BINS = 8192;  // E: 24 * 8192 bytes of shared memory

__device__ __forceinline__ int bucket_id(float e, float emax, float inv_w, int bins) {
  float t = __fmul_rn(__fsub_rn(emax, e), inv_w);
  t = fminf(fmaxf(t, 0.f), (float)(bins - 1));
  return (int)t;
}

// Fixed-point scale of bucket b: 2^(24 - x) with hi < 2^x, where hi =
// (emax - b * w) (1 + 2^-10) bounds the bucket's errors from above (w =
// 1 / inv_w; the margin covers the bucket ids' rounding); 0 when hi is
// not a positive normal float of at least 2^-103.  An error e of the bucket
// with 2^16 <= e * scale < 2^24 adds rint(e * scale) to the bucket's
// integer sum (relative rounding <= 2^-17 per error); any other error goes
// to its float sum.  Kernel and finalize compute it alike.
__device__ __forceinline__ float fix_scale(float emax, float w, int b) {
  const float hi = __fmul_rn(__fmaf_rn(-(float)b, w, emax), 1.0009765625f);
  const int biased = (int)((__float_as_uint(hi) >> 23) & 0xffu);  // x = biased - 126
  if (!(hi > 0.f) || biased == 0 || biased == 0xff || biased < 23) return 0.f;
  return __uint_as_float((unsigned)(127 + 24 + 126 - biased) << 23);
}

constexpr float kFixLo = 65536.f, kFixHi = 16777216.f;
constexpr unsigned kCountMask = (1u << 20) - 1;  // a key's word: count | carries << 20
constexpr unsigned kCarryOne = 1u << 20;

// A block's histogram in shared memory, per key (a bucket for a foreground
// pixel, bins + bucket otherwise): word = count | (carries out of lo) << 20,
// lo = the low 32 bits of the integer sum, fsum = the float sum.  chunk <
// 2^20 pixels a block keeps the count below 2^20 and the integer sum (< 2^24
// a pixel) below 2^44, so the carries below 2^12.  Only 32-bit integer
// atomics touch word and lo: on sm_90 a shared float or 64-bit atomicAdd
// is a compare-and-swap loop, which a crowded bucket makes retry.
struct BlockHist {
  unsigned* word;
  unsigned* lo;
  float* fsum;

  // n pixels of key k, their integer parts adding to u, float parts to f
  __device__ __forceinline__ void add(int k, unsigned n, unsigned u, float f) const {
    atomicAdd(&word[k], n);
    if (u) {
      const unsigned old = atomicAdd(&lo[k], u);
      if (old + u < old) atomicAdd(&word[k], kCarryOne);
    }
    if (f != 0.f) atomicAdd(&fsum[k], f);
  }
};

// The pixels of one load of a thread (four where vec) that share a key,
// added up before they reach shared memory: on a trained model's row most
// pixels share one bucket.
struct Run {
  int key = -1;
  unsigned n = 0, u = 0;  // u < 4 * 2^24
  float f = 0.f;
};

struct HistRow {
  BlockHist h;
  float em, iw, w;
  int bins;

  __device__ __forceinline__ void push(Run& r, float e, bool is_fg) const {
    if (!(e > VALID_THRESH)) return;
    const int b = bucket_id(e, em, iw, bins);
    const int key = is_fg ? b : bins + b;
    const float q = __fmul_rn(e, fix_scale(em, w, b));
    const bool fixed = q >= kFixLo && q < kFixHi;
    const unsigned u = fixed ? __float2uint_rn(q) : 0u;
    const float f = fixed ? 0.f : e;
    if (key != r.key) {
      flush(r);
      r.key = key;
      r.n = r.u = 0;
      r.f = 0.f;
    }
    ++r.n;
    r.u += u;
    r.f += f;
  }

  __device__ __forceinline__ void flush(const Run& r) const {
    if (r.n) h.add(r.key, r.n, r.u, r.f);
  }
};

// Kernel E, first pass.  Grid (rows, blocks per row), chunk < 2^20 pixels
// a block.
__global__ void __launch_bounds__(HIST_THREADS) hist_kernel(
    const float* __restrict__ err, const unsigned char* __restrict__ fg,
    const float* __restrict__ emax, const float* __restrict__ inv_w,
    long long P, int bins, long long chunk, int vec,
    unsigned long long* __restrict__ g_fix, int* __restrict__ g_cnt,
    float* __restrict__ g_fsum) {
  extern __shared__ unsigned s_hist[];  // [3][2 * bins]: word, lo, fsum
  const BlockHist h{s_hist, s_hist + 2 * bins, reinterpret_cast<float*>(s_hist + 4 * bins)};
  for (int i = threadIdx.x; i < 6 * bins; i += HIST_THREADS) s_hist[i] = 0;  // 0.0f too
  __syncthreads();

  const long long row = blockIdx.x;
  const float iw = inv_w[row];
  const HistRow px{h, emax[row], iw, 1.f / iw, bins};
  const float* e_row = err + row * P;
  const unsigned char* f_row = fg + row * P;
  const long long start = (long long)blockIdx.y * chunk;
  const long long end = start + chunk < P ? start + chunk : P;
  if (vec) {  // 4 | P and 4 | chunk: 16-byte error loads, 4-byte fg loads
    const float4* e4 = reinterpret_cast<const float4*>(e_row + start);
    const unsigned* f4 = reinterpret_cast<const unsigned*>(f_row + start);
    const int n4 = int((end - start) / 4);
    for (int v = threadIdx.x; v < n4; v += HIST_THREADS) {
      const float4 e = e4[v];
      const unsigned f = f4[v];
      Run r;
      px.push(r, e.x, f & 0xffu);
      px.push(r, e.y, (f >> 8) & 0xffu);
      px.push(r, e.z, (f >> 16) & 0xffu);
      px.push(r, e.w, f >> 24);
      px.flush(r);
    }
  } else {
    for (long long p = start + threadIdx.x; p < end; p += HIST_THREADS) {
      Run r;
      px.push(r, e_row[p], f_row[p]);
      px.flush(r);
    }
  }
  __syncthreads();

  // the block's nonempty keys to the row's totals: counts and integer sums
  // exact (integer atomics), float sums in the atomics' order
  const long long o = row * 2 * bins;
  for (int i = threadIdx.x; i < 2 * bins; i += HIST_THREADS) {
    const unsigned wd = h.word[i];
    if ((wd & kCountMask) == 0) continue;
    atomicAdd(&g_cnt[o + i], (int)(wd & kCountMask));
    const unsigned long long fix = (unsigned long long)(wd >> 20) << 32 | h.lo[i];
    if (fix) atomicAdd(&g_fix[o + i], fix);
    if (h.fsum[i] != 0.f) atomicAdd(&g_fsum[o + i], h.fsum[i]);
  }
}

// Kernel E, second pass, one thread per (row, bucket): out[r, :, b] =
// [n, f, S, Sf] from the foreground and background keys' totals, each sum
// its integer part over the bucket's scale plus its float part, in double,
// rounded once.
__global__ void hist_finalize_kernel(const unsigned long long* __restrict__ g_fix,
                                     const int* __restrict__ g_cnt,
                                     const float* __restrict__ g_fsum,
                                     const float* __restrict__ emax,
                                     const float* __restrict__ inv_w, long long rows, int bins,
                                     float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * bins) return;
  const long long row = i / bins;
  const int b = int(i - row * bins);
  const float scale = fix_scale(emax[row], 1.f / inv_w[row], b);
  const long long kf = row * 2 * bins + b, kb = kf + bins;
  const double fix_f = g_fix[kf] ? (double)g_fix[kf] / scale : 0.0;
  const double fix_b = g_fix[kb] ? (double)g_fix[kb] / scale : 0.0;
  const double s_f = fix_f + (double)g_fsum[kf];
  const double s_b = fix_b + (double)g_fsum[kb];
  float* o = out + row * 4 * bins + b;
  o[0] = (float)(g_cnt[kf] + g_cnt[kb]);
  o[bins] = (float)g_cnt[kf];
  o[2 * bins] = (float)(s_f + s_b);
  o[3 * bins] = (float)s_f;
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

// int32 words of the scratch that ee_hist2d_weighted needs for rows of
// `bins` buckets: per (row, fg/bg, bucket) an integer sum, a count and a
// float sum.
long long ee_hist_scratch_words(long long rows, int bins) { return rows * 2 * bins * 4; }

// errors (rows, P) f32, fg (rows, P) uint8 (nonzero = foreground), emax and
// inv_w (rows,) f32 -> out (rows, 4, bins) f32.  chunk: pixels a block, a
// multiple of 4 below 2^20.  scratch holds ee_hist_scratch_words(rows, bins)
// int32.  Returns the first launch error.
int ee_hist2d_weighted(const void* errors, const void* fg, const void* emax,
                       const void* inv_w, long long rows, long long P, int bins,
                       long long chunk, void* scratch, void* out, void* stream) {
  dim3 grid;
  if (bins < 1 || bins > MAX_BINS || chunk < 4 || chunk % 4 || chunk >= (1LL << 20) ||
      !grid_of(rows, P, chunk, &grid))
    return (int)cudaErrorInvalidValue;
  const size_t smem = 24 * (size_t)bins;  // 12 bytes a key
  cudaError_t err = cudaFuncSetAttribute(hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const long long keys = rows * 2 * bins;
  auto* g_fix = static_cast<unsigned long long*>(scratch);
  auto* g_cnt = reinterpret_cast<int*>(g_fix + keys);
  auto* g_fsum = reinterpret_cast<float*>(g_cnt + keys);
  if ((err = cudaMemsetAsync(scratch, 0, (size_t)keys * 16, s)) != cudaSuccess) return (int)err;
  const int vec = P % 4 == 0 && reinterpret_cast<uintptr_t>(errors) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(fg) % 4 == 0;
  hist_kernel<<<grid, HIST_THREADS, smem, s>>>(
      (const float*)errors, (const unsigned char*)fg, (const float*)emax, (const float*)inv_w,
      P, bins, chunk, vec, g_fix, g_cnt, g_fsum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (rows * bins + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  hist_finalize_kernel<<<(unsigned)blocks, 256, 0, s>>>(g_fix, g_cnt, g_fsum, (const float*)emax,
                                                        (const float*)inv_w, rows, bins,
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
