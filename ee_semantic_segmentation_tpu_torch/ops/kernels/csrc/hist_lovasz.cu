// Sort-free histogram Lovász kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the two TPU (Pallas) kernels of ops/pallas/hist_kernel.py:
//   E  hist2d_weighted_pallas (_hist_kernel)
//      -> hist_kernel + hist_finalize_kernel: per row, four histograms over
//         `bins` uniform-width descending error buckets: pixel count, fg
//         count, error sum, fg error sum.  The forward of the -G Lovász.
//   F  table_lookup_pallas (_lookup_kernel)
//      -> lookup_wide_kernel: per pixel, the fg or bg entry of its row's
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
//   E  A block takes one (row, range of `chunk` pixels, 64 * nb <= chunk
//      < 2^20, nb = min(bins, 8192)) with 16-byte error and 4-byte fg loads
//      where 4 | P.  Each key (the bucket of a foreground pixel, or nb + the
//      bucket of a background one) has a count, an integer sum and a float
//      sum in dynamic shared memory (24 * nb bytes: 192 KB at 8192, hence
//      the opt-in).  Above 8192 bins the grid also runs over ranges of
//      8192 buckets: a block keeps the keys of its range [lo, lo + 8192)
//      only and skips its chunk's other pixels, so the shared layout, the
//      chunk (sized by the range, not by bins) and the count words stay as
//      they are; each range reads the errors once more (bins / 8192 reads
//      in all; the TPU kernel's one-hot product grows with bins too).  An error whose bucket's fixed-point scale (a power of
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
//   F  Blocks of 1024 threads walk tiles of kLookupTile pixels; each thread
//      takes 4 consecutive pixels a step (one 16-byte error load, one 4-byte
//      fg load, one 16-byte store where 4 | P and the pointers align; scalar
//      otherwise), kLookupTile / (4 * 1024) = 2 steps in flight: ~40 KB of
//      loads in flight a block, where the memory rate needs ~15 KB an SM.  Up
//      to 16384 bins a persistent grid (as many blocks as the occupancy
//      calculator fits on the SMs at once) lets block b walk the contiguous
//      tiles [b T / G, (b + 1) T / G) of the row-major order, and the block
//      stages a row's table in shared memory when its walk reaches that row:
//      at 63 rows of 2^22 and 16384 bins about 132 + 63 stagings of 128 KB,
//      where one block a chunk of the row made 2016 with nothing to overlap
//      them.  Above 16384 bins the table (8 B a bucket) outgrows a block's
//      shared memory and is read through the read-only path (__ldg), one block
//      a tile: the blocks start in row-major order, so those in flight work on
//      one or two rows and their tables (2^19 bytes a row at 65536 bins) stay
//      in L2; a random table read costs a 32-byte L2 sector, and there F takes
//      about 2.3x its bound on uniform errors (PERF.md). The output is tab *
//      valid, as in the plain version, so signed zeros agree too.
// Above 2^24 bins float32 cannot name bucket bins - 1 (bins - 1 rounds to
// bins), so the paths above 8192 (E) and 16384 (F) clamp the bucket id to
// bins - 1 after the conversion, which changes nothing below 2^24; the
// C entry points take bins up to 2^30 (one row's output and scratch are
// then 48 GB), and the plain versions index out of range above 2^24.
// Bound (H100 SXM, 3.35 TB/s): E reads 4 bytes of error and 1 of fg per
// pixel, F those and writes 4: at 63 rows of 2^22, ~0.39 and ~0.71 ms.  On
// one H100 80GB HBM3 at 700 W (PERF.md): E 0.666 ms on uniform errors,
// 0.662 and 0.754 on clustered ones; F ~0.85 ms at 1024 and 16384 bins on
// every law.  The times at every bin count stand in PERF.md beside their
// bounds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int HIST_THREADS = 512;
// Above kRangeBins a block's 192 KB of shared memory leaves one block an SM:
// it takes 1024 threads, each with 4 loads in flight
constexpr int kRangedThreads = 1024;
constexpr int kWideThreads = 1024;       // F's threads a block
constexpr int kLookupTile = 8192;        // pixels a tile: 2 steps of 4 pixels a thread
constexpr float VALID_THRESH = -1e29f;
constexpr int kRangeBins = 8192;         // E: buckets a block keeps, 24 B each in shared memory
constexpr int kStagedLookupBins = 16384;  // F: stages its (2, bins) table up to here, 8 B a bucket
constexpr long long kMaxBins = 1LL << 30;

__device__ __forceinline__ int bucket_id(float e, float emax, float inv_w, int bins) {
  float t = __fmul_rn(__fsub_rn(emax, e), inv_w);
  t = fminf(fmaxf(t, 0.f), (float)(bins - 1));
  return (int)t;
}

// bucket_id for any bins up to 2^30: above 2^24, (float)(bins - 1) rounds
// up to bins, so the id is clamped once more in integers.
__device__ __forceinline__ int bucket_id_wide(float e, float emax, float inv_w, int bins) {
  return min(bucket_id(e, emax, inv_w, bins), bins - 1);
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

// kRanged: the block keeps the buckets [lo, lo + kRangeBins) of its row's
// bins only (bins > kRangeBins), their keys b - lo and kRangeBins + b - lo.
template <bool kRanged>
struct HistRow {
  BlockHist h;
  float em, iw, w;
  int bins;
  int lo;

  __device__ __forceinline__ void push(Run& r, float e, bool is_fg) const {
    if (!(e > VALID_THRESH)) return;
    int b, key;
    if constexpr (kRanged) {
      b = bucket_id_wide(e, em, iw, bins);
      if ((unsigned)(b - lo) >= (unsigned)kRangeBins) return;  // another block's range
      key = is_fg ? b - lo : kRangeBins + b - lo;
    } else {
      b = bucket_id(e, em, iw, bins);
      key = is_fg ? b : bins + b;
    }
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

  // the four pixels of one 16-byte error load and 4-byte fg load
  __device__ __forceinline__ void push4(const float4& e, unsigned f) const {
    Run r;
    push(r, e.x, f & 0xffu);
    push(r, e.y, (f >> 8) & 0xffu);
    push(r, e.z, (f >> 16) & 0xffu);
    push(r, e.w, f >> 24);
    flush(r);
  }
};

// Kernel E, first pass.  Grid (rows, blocks per row), chunk < 2^20 pixels
// a block; kRanged (bins > kRangeBins): grid (rows * bins / kRangeBins,
// blocks per row), block x taking range x % (bins / kRangeBins) of row
// x / (bins / kRangeBins).
template <bool kRanged>
__global__ void __launch_bounds__(kRanged ? kRangedThreads : HIST_THREADS) hist_kernel(
    const float* __restrict__ err, const unsigned char* __restrict__ fg,
    const float* __restrict__ emax, const float* __restrict__ inv_w,
    long long P, int bins, long long chunk, int vec,
    unsigned long long* __restrict__ g_fix, int* __restrict__ g_cnt,
    float* __restrict__ g_fsum) {
  constexpr int T = kRanged ? kRangedThreads : HIST_THREADS;
  const int nb = kRanged ? kRangeBins : bins;  // the block's buckets
  extern __shared__ unsigned s_hist[];  // [3][2 * nb]: word, lo, fsum
  const BlockHist h{s_hist, s_hist + 2 * nb, reinterpret_cast<float*>(s_hist + 4 * nb)};
  for (int i = threadIdx.x; i < 6 * nb; i += T) s_hist[i] = 0;  // 0.0f too
  __syncthreads();

  const int ranges = kRanged ? bins / kRangeBins : 1;
  const long long row = kRanged ? blockIdx.x / ranges : blockIdx.x;
  const int lo = kRanged ? int(blockIdx.x - row * ranges) * kRangeBins : 0;
  const float iw = inv_w[row];
  const HistRow<kRanged> px{h, emax[row], iw, 1.f / iw, bins, lo};
  const float* e_row = err + row * P;
  const unsigned char* f_row = fg + row * P;
  const long long start = (long long)blockIdx.y * chunk;
  const long long end = start + chunk < P ? start + chunk : P;
  if (vec) {  // 4 | P and 4 | chunk: 16-byte error loads, 4-byte fg loads
    const float4* e4 = reinterpret_cast<const float4*>(e_row + start);
    const unsigned* f4 = reinterpret_cast<const unsigned*>(f_row + start);
    const int n4 = int((end - start) / 4);
    int v = threadIdx.x;
    if constexpr (kRanged) {  // 4 loads in flight a thread
      for (; v + 3 * T < n4; v += 4 * T) {
        float4 e[4];
        unsigned f[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          e[u] = e4[v + u * T];
          f[u] = f4[v + u * T];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) px.push4(e[u], f[u]);
      }
    }
    for (; v < n4; v += T) {
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
    for (long long p = start + threadIdx.x; p < end; p += T) {
      Run r;
      px.push(r, e_row[p], f_row[p]);
      px.flush(r);
    }
  }
  __syncthreads();

  // the block's nonempty keys to the row's totals: counts and integer sums
  // exact (integer atomics), float sums in the atomics' order
  const long long o = row * 2 * bins;
  for (int i = threadIdx.x; i < 2 * nb; i += T) {
    const unsigned wd = h.word[i];
    if ((wd & kCountMask) == 0) continue;
    // the row's key of block key i: fg buckets first, then bg ones
    const long long k = o + (kRanged ? (i < nb ? lo + i : bins + lo + (i - nb)) : i);
    atomicAdd(&g_cnt[k], (int)(wd & kCountMask));
    const unsigned long long fix = (unsigned long long)(wd >> 20) << 32 | h.lo[i];
    if (fix) atomicAdd(&g_fix[k], fix);
    if (h.fsum[i] != 0.f) atomicAdd(&g_fsum[k], h.fsum[i]);
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
  const long long B = bins;
  float* o = out + row * 4 * B + b;
  o[0] = (float)(g_cnt[kf] + g_cnt[kb]);
  o[B] = (float)g_cnt[kf];
  o[2 * B] = (float)(s_f + s_b);
  o[3 * B] = (float)s_f;
}

// One pixel's weight from its row's table (shared memory where kStaged, else
// read through __ldg).
template <bool kStaged>
struct LookupRow {
  const float* tab;
  float em, iw;
  int bins;

  __device__ __forceinline__ float operator()(float e, unsigned is_fg) const {
    const float valid = e > VALID_THRESH ? 1.f : 0.f;
    if constexpr (kStaged) {
      const int b = bucket_id(e, em, iw, bins);
      return tab[is_fg ? b : bins + b] * valid;
    } else {
      const int b = bucket_id_wide(e, em, iw, bins);
      return __ldg(&tab[is_fg ? b : bins + b]) * valid;
    }
  }
};

// Kernel F: G blocks over the T = rows * ceil(P / kLookupTile) tiles in
// row-major order, block b taking the contiguous tiles [b T / G, (b + 1) T /
// G).  kStaged (bins <= kStagedLookupBins; G as many blocks as fit the SMs):
// a block stages a row's table when its walk reaches that row.
// Otherwise (G = T: a tile a block) it reads the table from L2.  vec: 4 | P
// and aligned pointers (16-byte error loads and stores, 4-byte fg loads).
template <bool kStaged>
__global__ void __launch_bounds__(kWideThreads) lookup_wide_kernel(
    const float* __restrict__ err, const unsigned char* __restrict__ fg,
    const float* __restrict__ emax, const float* __restrict__ inv_w,
    const float* __restrict__ tables, long long rows, long long P, int bins, int vec,
    float* __restrict__ out) {
  constexpr int kSteps = kLookupTile / (4 * kWideThreads);  // 4-pixel steps a thread a tile
  extern __shared__ __align__(16) float s_tab[];  // kStaged: [2][bins]
  const long long per_row = (P + kLookupTile - 1) / kLookupTile;
  const long long tiles = rows * per_row;
  const long long t_end = (blockIdx.x + 1LL) * tiles / gridDim.x;
  long long staged_row = -1;
  for (long long t = blockIdx.x * tiles / gridDim.x; t < t_end; ++t) {
    const long long row = t / per_row;
    const float* t_row = tables + row * 2 * bins;
    if constexpr (kStaged) {
      if (row != staged_row) {  // the same in every thread of the block
        __syncthreads();        // every thread is done with the last row's table
        const int n4 = vec && bins % 2 == 0 ? bins / 2 : 0;  // 16-byte loads of the table
        for (int i = threadIdx.x; i < n4; i += kWideThreads)
          reinterpret_cast<float4*>(s_tab)[i] = __ldg(reinterpret_cast<const float4*>(t_row) + i);
        for (int i = 4 * n4 + threadIdx.x; i < 2 * bins; i += kWideThreads)
          s_tab[i] = __ldg(t_row + i);
        __syncthreads();
        staged_row = row;
      }
    }
    const LookupRow<kStaged> look{kStaged ? s_tab : t_row, emax[row], inv_w[row], bins};
    const long long start = (t - row * per_row) * kLookupTile;
    const long long n = start + kLookupTile < P ? kLookupTile : P - start;
    const float* e_row = err + row * P + start;
    const unsigned char* f_row = fg + row * P + start;
    float* o_row = out + row * P + start;
    if (vec) {  // n is a multiple of 4
      const int n4 = int(n / 4);
      float4 e[kSteps];
      unsigned f[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int v = threadIdx.x + u * kWideThreads;
        if (v < n4) {
          e[u] = __ldg(reinterpret_cast<const float4*>(e_row) + v);
          f[u] = __ldg(reinterpret_cast<const unsigned*>(f_row) + v);
        }
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int v = threadIdx.x + u * kWideThreads;
        if (v < n4)
          reinterpret_cast<float4*>(o_row)[v] =
              make_float4(look(e[u].x, f[u] & 0xffu), look(e[u].y, (f[u] >> 8) & 0xffu),
                          look(e[u].z, (f[u] >> 16) & 0xffu), look(e[u].w, f[u] >> 24));
      }
    } else {
      for (int p = threadIdx.x; p < n; p += kWideThreads) o_row[p] = look(e_row[p], f_row[p]);
    }
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

// The most buckets one block of kernel E keeps (a range): above it E takes
// the buckets in ranges of this many.
int ee_hist_range_bins() { return kRangeBins; }

// int32 words of the scratch that ee_hist2d_weighted needs for rows of
// `bins` buckets: per (row, fg/bg, bucket) an integer sum, a count and a
// float sum.
long long ee_hist_scratch_words(long long rows, long long bins) { return rows * 2 * bins * 4; }

// errors (rows, P) f32, fg (rows, P) uint8 (nonzero = foreground), emax and
// inv_w (rows,) f32 -> out (rows, 4, bins) f32; bins up to 2^30, a multiple
// of ee_hist_range_bins() above it.  chunk: pixels a block, a multiple of 4
// below 2^20.  scratch holds ee_hist_scratch_words(rows, bins) int32.
// Returns the first launch error.
int ee_hist2d_weighted(const void* errors, const void* fg, const void* emax,
                       const void* inv_w, long long rows, long long P, long long bins,
                       long long chunk, void* scratch, void* out, void* stream) {
  dim3 grid;
  const bool ranged = bins > kRangeBins;
  const long long ranges = ranged ? bins / kRangeBins : 1;
  if (bins < 1 || bins > kMaxBins || (ranged && bins % kRangeBins) || chunk < 4 || chunk % 4 ||
      chunk >= (1LL << 20) || rows > 0x7fffffffLL || !grid_of(rows * ranges, P, chunk, &grid))
    return (int)cudaErrorInvalidValue;
  const size_t smem = 24 * (size_t)(ranged ? kRangeBins : bins);  // 12 bytes a key
  auto* kernel = ranged ? hist_kernel<true> : hist_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  kernel<<<grid, ranged ? kRangedThreads : HIST_THREADS, smem, s>>>(
      (const float*)errors, (const unsigned char*)fg, (const float*)emax, (const float*)inv_w,
      P, (int)bins, chunk, vec, g_fix, g_cnt, g_fsum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (rows * bins + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  hist_finalize_kernel<<<(unsigned)blocks, 256, 0, s>>>(g_fix, g_cnt, g_fsum, (const float*)emax,
                                                        (const float*)inv_w, rows, (int)bins,
                                                        (float*)out);
  return (int)cudaGetLastError();
}

// errors, fg, emax, inv_w as above; tables (rows, 2, bins) f32 -> out
// (rows, P) f32; bins up to 2^30.  Returns cudaGetLastError().
int ee_table_lookup(const void* errors, const void* fg, const void* emax, const void* inv_w,
                    const void* tables, long long rows, long long P, long long bins,
                    void* out, void* stream) {
  if (bins < 1 || bins > kMaxBins || rows <= 0 || P <= 0 || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  const bool staged = bins <= kStagedLookupBins;
  const size_t smem = staged ? 8 * (size_t)bins : 0;
  auto* kernel = staged ? lookup_wide_kernel<true> : lookup_wide_kernel<false>;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  const long long tiles = rows * ((P + kLookupTile - 1) / kLookupTile);
  long long blocks = tiles;  // from L2: one block a tile, dispatched in row-major order
  if (staged) {  // a persistent grid, as many blocks as fit the SMs at once
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWideThreads,
                                                             smem)) != cudaSuccess)
      return (int)err;
    blocks = tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm;
  }
  const int vec = P % 4 == 0 && reinterpret_cast<uintptr_t>(errors) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(fg) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(tables) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kWideThreads, smem, s>>>(
      (const float*)errors, (const unsigned char*)fg, (const float*)emax, (const float*)inv_w,
      (const float*)tables, rows, P, (int)bins, vec, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
