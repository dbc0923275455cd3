// Per-row key-value sort and its inverse permutation scatter for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU (Pallas) kernel of the training path:
//   D  ee_semantic_segmentation_tpu/ops/pallas/sort_kernel.py:293
//      sort_pallas (_sort_kernel / bitonic_sort_2d, _merge_kernel /
//      bitonic_merge_2d, chunk loop _sort_chunked): each row of (B, P) keys in
//      ascending order, one 32-bit payload following its key.  The Lovász
//      loss calls it twice per step on the TPU: the forward sorts the negated
//      errors with a packed (position, fg, valid) payload, the backward
//      unsorts the gradient by sorting on the saved positions.  Here the
//      forward calls ee_sort_rows and the backward ee_unsort_rows, a
//      permutation scatter: the positions are a permutation of 0..P-1, so
//      the sort on them has exactly one answer, out[r, perm[r, i]] = vals[r, i].
//
// ee_sort_rows: a stable LSD radix sort of each row, 8-bit digits, 4 passes,
// ping-pong between the (B, P) outputs and a (B, P) scratch the wrapper
// allocates: input -> scratch -> output -> scratch -> output.
//   * Digits come from an order-preserving uint32 image of the key: a
//     float32 key first has -0.0 made +0.0 and every NaN made one quiet NaN
//     (so it sorts last), then all bits flipped if its sign is set, else
//     only the sign bit; an int32 key has its sign bit flipped.  The passes
//     move the key's raw bits, so the sorted keys are the input's own bits.
//     Being stable, the result equals torch.sort(stable=True) + gather bit
//     for bit, keys and payloads (with NaN keys, the CPU's: torch.sort on
//     CUDA sorts a NaN whose sign bit is set first), and needs no padding:
//     any P >= 1.
//   * A row is cut into tiles of kTile = 4096 elements.  Each pass is four
//     launches: radix_hist_kernel counts the tile's digits (shared-memory
//     histogram, one atomic per key); radix_scan_tiles /
//     radix_scan_segs_kernel turn the (row, tile, digit) counts into each
//     (tile, digit)'s offset in the row (an exclusive scan over tiles per
//     digit in segments of kSegTiles tiles, then over segments and digits);
//     radix_scatter_kernel reloads the tile (16-byte loads where 4 | P and
//     the pointers are aligned), ranks it stably in shared memory (each warp
//     owns 512 consecutive elements and ranks 32 at a time with a ballot
//     match of the digit and per-warp digit counters), orders it by digit
//     through a 16-bit index per element, and writes each digit's run with
//     consecutive threads to consecutive addresses of the output row.
// ee_unsort_rows: a two-pass scatter through a staging copy bucketed by the
// destination.  Bucket b of a row is window b of the output row, the
// destinations [b * W, b * W + W) with W = 2^14: a permutation sends exactly
// min(W, P - b * W) elements there, so its staging segment is known ahead
// and no counting pass is needed.
//   * unsort_partition_kernel, one block per tile of 2^14 consecutive
//     (perm, vals) (16-byte loads where 4 | P): counts the tile per bucket
//     in shared memory, reserves a run in each nonempty bucket's segment
//     with one global atomic on a (row, bucket) cursor, orders the tile by
//     bucket in shared memory, and writes each run (the value and its 16-bit
//     offset in the window) with one warp per bucket to consecutive slots.
//   * unsort_place_kernel, one block per (row, bucket): reads its segment,
//     stores each value at its offset in a 64 KB shared-memory window, and
//     writes the window to the output with 16-byte stores where 4 | P.
//   The order within a bucket is the atomics' and does not matter, so the
//   result is deterministic.  Indices outside [0, P) are dropped; a run is
//   cut at its segment's end, so repeated indices cannot write past it.
//   Rows of more than 4096 windows (P > 2^26) take unsort_kernel, a
//   one-pass scatter (16-byte loads, one 4-byte store per element).
// 64-bit row offsets (B * P reaches 2^28 at the flagship); P < 2^31.  Every
// launch is on the caller's stream.
//
// Bound: bytes.  A sort has to read each key and payload once and write each
// once: B * P * 16 bytes, 4.2 GB for the flagship's 63 rows of 2^22, 1.26 ms
// at 3.35 TB/s; the digit work is integer and far below the card's rate.
// The radix design moves the keys and payloads 4 times (16 bytes per
// element each pass) and reads the keys once more per pass for the
// histograms: 80 bytes per element, 5x the bound, against the bitonic
// network's ~25 device-memory round trips at 2^22 that it replaces.  The
// (row, tile, digit) counts add 1 KB per tile per pass.  What the design
// does about the rest: the histograms take one shared atomic per key (a
// pass costs about its key read), the scatter keeps only ranks in
// registers (three blocks an SM), and its writes come out in runs of
// ~16 consecutive elements per digit and tile.  The unsort has to read 8
// bytes and write 4 per element: 0.95 ms at the flagship.  A one-pass
// scatter moves just that, but as random 4-byte stores of one L2 sector
// each, and their rate held it at 6.34 ms (one H100 80GB HBM3 at 700 W,
// PERF.md).  The two passes move twice the bytes, 24 per element (pass 1
// reads 8 and writes 6, pass 2 reads 6 and writes 4), all of them in
// coalesced runs (~64 elements a (tile, bucket) at 2^22): 2.51 ms at 63 x
// 2^22 and 2.32 at 1008 x 2^18 on the same card, pass 1 1.6 ms and pass 2
// 0.9 (PERF.md §6 for the windows and tiles tried).  Scratch: B * P * 6
// bytes of staging and B * ceil(P / W) cursors.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBits = 8;
constexpr int kRadix = 1 << kBits;        // digits per pass
constexpr int kPasses = 32 / kBits;
constexpr int kThreads = 256;             // = kRadix: one thread per digit in the scans
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                // elements per thread
constexpr int kTile = kThreads * kItems;  // 4096 elements per tile
constexpr int kWarpSpan = 32 * kItems;    // consecutive elements one warp ranks
constexpr int kSegTiles = 64;             // tiles per segment of the tile scan
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxGridY = 65535;
// the unsort: windows of the output row, the partition's tiles
constexpr int kUnsortLogW = 14;
constexpr int kUnsortW = 1 << kUnsortLogW;  // elements of a window (64 KB)
constexpr int kUnsortMaxBuckets = 4096;     // windows a row may have in the two-pass unsort
constexpr int kPartThreads = 512;
constexpr int kPartItems = 32;              // elements per thread of the partition
constexpr int kPartTile = kPartThreads * kPartItems;
constexpr int kPlaceThreads = 512;

static_assert(kThreads == kRadix, "the per-digit steps take one thread per digit");

template <bool kFloat>
__device__ __forceinline__ uint32_t ordered(uint32_t u) {
  if (kFloat) {
    if ((u & 0x7FFFFFFFu) > 0x7F800000u) u = 0x7FC00000u;  // every NaN: one, sorts last
    else if (u == 0x80000000u) u = 0u;                       // -0.0 ties with +0.0
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  return u ^ 0x80000000u;
}

template <bool kFloat>
__device__ __forceinline__ uint32_t digit_of(uint32_t u, int shift) {
  return (ordered<kFloat>(u) >> shift) & (kRadix - 1);
}

// The lanes whose digit d equals this lane's, among the lanes with `in`
// set: __match_any_sync built from one ballot per digit bit, as CUB's
// MatchAny does (the native match made the scatter slower on the H100).
// Every lane of the warp calls it.
__device__ __forceinline__ unsigned match_digit(uint32_t d, bool in) {
  unsigned peers = __ballot_sync(kFull, in);
#pragma unroll
  for (int b = 0; b < kBits; ++b) {
    const unsigned ones = __ballot_sync(kFull, (d >> b) & 1u);
    peers &= ((d >> b) & 1u) ? ones : ~ones;
  }
  return peers;
}

// Add one key to a shared histogram.  One atomic per key: aggregating a
// warp's equal digits first (a match, then one atomic per digit) made the
// histogram pass several times slower on the H100, even on the Lovász
// keys' skewed top byte.
template <bool kFloat>
__device__ __forceinline__ void count_digit(int* hist, uint32_t u, int shift) {
  atomicAdd(&hist[digit_of<kFloat>(u, shift)], 1);
}

// Exclusive sum of v over the block's threads, in thread order.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[w] = x;
  __syncthreads();
  int below = 0;
  for (int i = 0; i < w; ++i) below += warp_sums[i];
  __syncthreads();
  return below + x - v;
}

// Digit counts of one tile: counts[(row * nt + t) * kRadix + d].
template <bool kFloat>
__global__ void __launch_bounds__(kThreads)
radix_hist_kernel(const uint32_t* __restrict__ key, long long P, int nt, int shift, int vec,
                  int* __restrict__ counts) {
  __shared__ int hist[kRadix];
  const long long row = blockIdx.x / nt;
  const int t = blockIdx.x % nt;
  const long long base = (long long)t * kTile;
  const int n = int(P - base < kTile ? P - base : kTile);
  const uint32_t* k = key + row * P + base;
  hist[threadIdx.x] = 0;
  __syncthreads();
  if (vec) {  // 4 | P: n is a multiple of 4
#pragma unroll
    for (int i = 0; i < kItems / 4; ++i) {
      const int e = 4 * (int(threadIdx.x) + i * kThreads);
      if (e < n) {
        const uint4 q = *reinterpret_cast<const uint4*>(k + e);
        count_digit<kFloat>(hist, q.x, shift);
        count_digit<kFloat>(hist, q.y, shift);
        count_digit<kFloat>(hist, q.z, shift);
        count_digit<kFloat>(hist, q.w, shift);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int e = int(threadIdx.x) + i * kThreads;
      if (e < n) count_digit<kFloat>(hist, k[e], shift);
    }
  }
  __syncthreads();
  counts[((long long)row * nt + t) * kRadix + threadIdx.x] = hist[threadIdx.x];
}

// Per (row, segment of kSegTiles tiles), thread d: the exclusive sum of
// digit d's counts over the segment's tiles, in place, and the segment's
// total, seg[(row * S + s) * kRadix + d].
__global__ void __launch_bounds__(kThreads)
radix_scan_tiles_kernel(int* __restrict__ counts, int nt, int S, int* __restrict__ seg) {
  const long long row = blockIdx.x / S;
  const int s = blockIdx.x % S;
  const int t0 = s * kSegTiles;
  const int t1 = t0 + kSegTiles < nt ? t0 + kSegTiles : nt;
  int* c = counts + (row * nt) * kRadix + threadIdx.x;
  int run = 0;
#pragma unroll 8
  for (int t = t0; t < t1; ++t) {
    const int v = c[(long long)t * kRadix];
    c[(long long)t * kRadix] = run;
    run += v;
  }
  seg[(row * S + s) * kRadix + threadIdx.x] = run;
}

// Per row, thread d: each segment's totals become the row offset of the
// segment's first digit-d element (digits below d, then digit d in the
// earlier segments).
__global__ void __launch_bounds__(kThreads)
radix_scan_segs_kernel(int* __restrict__ seg, int S) {
  __shared__ int warp_sums[kWarps];
  int* c = seg + (long long)blockIdx.x * S * kRadix + threadIdx.x;
  int run = 0;
  for (int s = 0; s < S; ++s) {
    const int v = c[s * kRadix];
    c[s * kRadix] = run;
    run += v;
  }
  const int below = block_exclusive_scan(run, warp_sums);
  for (int s = 0; s < S; ++s) c[s * kRadix] += below;
}

// One pass over one tile: stable rank by digit, reorder in shared memory,
// write each digit's run to its place in the output row.  Registers hold
// only the ranks: the reorder goes through a 16-bit index per element, and
// the keys and payloads stay where the load put them.
template <bool kFloat>
__global__ void __launch_bounds__(kThreads)
radix_scatter_kernel(const uint32_t* __restrict__ key_in, const uint32_t* __restrict__ pay_in,
                     long long P, int nt, int S, int shift, int vec,
                     const int* __restrict__ counts, const int* __restrict__ seg,
                     uint32_t* __restrict__ key_out, uint32_t* __restrict__ pay_out) {
  __shared__ __align__(16) uint32_t sk[kTile];
  __shared__ __align__(16) uint32_t sp[kTile];
  __shared__ uint16_t order[kTile];            // tile position -> element, by (digit, rank)
  __shared__ uint16_t wcount[kWarps][kRadix];  // per-warp digit counts, then offsets
  __shared__ int dstart[kRadix];               // tile position of digit d's first element
  __shared__ int dest[kRadix];                 // row position of tile position 0 for digit d
  __shared__ int warp_sums[kWarps];
  const long long row = blockIdx.x / nt;
  const int t = blockIdx.x % nt;
  const long long base = (long long)t * kTile;
  const int n = int(P - base < kTile ? P - base : kTile);
  const uint32_t* ki = key_in + row * P + base;
  const uint32_t* pi = pay_in + row * P + base;

  // 1. the tile to shared memory
  if (vec) {
    for (int v = threadIdx.x; 4 * v < n; v += kThreads) {
      reinterpret_cast<uint4*>(sk)[v] = *reinterpret_cast<const uint4*>(ki + 4 * v);
      reinterpret_cast<uint4*>(sp)[v] = *reinterpret_cast<const uint4*>(pi + 4 * v);
    }
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads) {
      sk[e] = ki[e];
      sp[e] = pi[e];
    }
  }
  for (int i = threadIdx.x; i < kWarps * kRadix; i += kThreads) (&wcount[0][0])[i] = 0;
  __syncthreads();

  // 2. stable rank within each warp's span: 32 consecutive elements a step,
  // in order; peers with the same digit rank by lane, and the highest of
  // them advances the warp's counter for that digit
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  int r[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int e = w * kWarpSpan + j * 32 + lane;
    const bool in = e < n;
    const uint32_t d = digit_of<kFloat>(in ? sk[e] : 0u, shift);
    const unsigned peers = match_digit(d, in);
    const int before = in ? wcount[w][d] : 0;
    __syncwarp();
    if (in && lane == 31 - __clz(peers)) wcount[w][d] = uint16_t(before + __popc(peers));
    __syncwarp();
    r[j] = before + __popc(peers & lanes_below);
  }
  __syncthreads();

  // 3. thread d: the warps' offsets within digit d, the tile position of
  // digit d's run, and where that run goes in the row
  {
    const int d = threadIdx.x;
    int run = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const int c = wcount[i][d];
      wcount[i][d] = uint16_t(run);
      run += c;
    }
    const int start = block_exclusive_scan(run, warp_sums);
    dstart[d] = start;
    dest[d] = seg[(row * S + t / kSegTiles) * kRadix + d] +
              counts[((long long)row * nt + t) * kRadix + d] - start;
  }
  __syncthreads();

  // 4. the tile's order by (digit, rank)
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int e = w * kWarpSpan + j * 32 + lane;
    if (e < n) {
      const uint32_t d = digit_of<kFloat>(sk[e], shift);
      order[dstart[d] + wcount[w][d] + r[j]] = uint16_t(e);
    }
  }
  __syncthreads();

  // 5. consecutive threads write consecutive addresses of each digit's run
  uint32_t* ko = key_out + row * P;
  uint32_t* po = pay_out + row * P;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int e = order[i];
    const uint32_t u = sk[e];
    const long long o = (long long)dest[digit_of<kFloat>(u, shift)] + i;
    ko[o] = u;
    po[o] = sp[e];
  }
}

__device__ __forceinline__ void put(uint32_t* out, long long P, uint32_t q, uint32_t v) {
  if (q < P) out[q] = v;  // as uint32, a negative index is >= 2^31 > P
}

// The one-pass scatter, for rows of more than kUnsortMaxBuckets windows:
// out[r, perm[r, i]] = vals[r, i] over one tile of rows row0 + blockIdx.y.
__global__ void __launch_bounds__(kThreads)
unsort_kernel(const uint32_t* __restrict__ perm, const uint32_t* __restrict__ vals, long long P,
              long long row0, int vec, uint32_t* __restrict__ out) {
  const long long row = row0 + blockIdx.y;
  const long long base = (long long)blockIdx.x * kTile;
  const uint32_t* pr = perm + row * P;
  const uint32_t* vr = vals + row * P;
  uint32_t* o = out + row * P;
  if (vec) {
#pragma unroll
    for (int i = 0; i < kItems / 4; ++i) {
      const long long e = base + 4 * (threadIdx.x + i * kThreads);
      if (e < P) {
        const uint4 q = *reinterpret_cast<const uint4*>(pr + e);
        const uint4 v = *reinterpret_cast<const uint4*>(vr + e);
        put(o, P, q.x, v.x);
        put(o, P, q.y, v.y);
        put(o, P, q.z, v.z);
        put(o, P, q.w, v.w);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long e = base + threadIdx.x + i * kThreads;
      if (e < P) put(o, P, pr[e], vr[e]);
    }
  }
}

// Tile position of item i of this thread: 16-byte groups of four where
// vec, else one element every kPartThreads.
__device__ __forceinline__ int part_pos(int i, int vec) {
  return vec ? 4 * (int(threadIdx.x) + (i >> 2) * kPartThreads) + (i & 3)
             : int(threadIdx.x) + i * kPartThreads;
}

// Unsort pass 1 over one tile of kPartTile consecutive elements of a row.
// Bucket b holds the elements whose destination lies in window b, perm >>
// kUnsortLogW.  The block counts its tile per bucket, reserves a run of
// that many slots in each bucket's staging segment [b * W, b * W + W) with
// one global atomic on the (row, bucket) cursor, orders the tile by bucket
// in shared memory, and writes each bucket's run (value, and offset inside
// the window) to consecutive staging slots, one warp per bucket.  Within a
// bucket the order is the shared atomics' and does not matter: pass 2
// places each value by its offset.  A destination outside [0, P) is
// dropped; a run is cut at its segment's end, so repeated destinations
// cannot write past it.
__global__ void __launch_bounds__(kPartThreads)
unsort_partition_kernel(const uint32_t* __restrict__ perm, const uint32_t* __restrict__ vals,
                        long long P, int nt, int nb, int vec, int* __restrict__ cursors,
                        uint32_t* __restrict__ st_val, uint16_t* __restrict__ st_off) {
  extern __shared__ __align__(16) unsigned char part_smem[];
  uint32_t* s_val = reinterpret_cast<uint32_t*>(part_smem);     // the tile by bucket
  uint16_t* s_off = reinterpret_cast<uint16_t*>(s_val + kPartTile);
  int* s_start = reinterpret_cast<int*>(s_off + kPartTile);   // bucket b's first tile position
  int* s_end = s_start + nb;  // its count, then its fill cursor, then its end
  int* s_dst = s_end + nb;    // staging slot of tile position 0 for bucket b
  __shared__ int warp_sums[kPartThreads / 32];
  const long long row = blockIdx.x / nt;
  const long long base = (long long)(blockIdx.x % nt) * kPartTile;
  const int n = int(P - base < kPartTile ? P - base : kPartTile);
  const uint32_t* pr = perm + row * P + base;
  const uint32_t* vr = vals + row * P + base;
  for (int b = threadIdx.x; b < nb; b += kPartThreads) s_end[b] = 0;

  // 1. the destinations in registers (~0u: none), counted per bucket
  uint32_t q[kPartItems];
  if (vec) {  // 4 | P: n is a multiple of 4
#pragma unroll
    for (int i = 0; i < kPartItems; i += 4) {
      const int e = part_pos(i, 1);
      const uint4 v = e < n ? *reinterpret_cast<const uint4*>(pr + e) : make_uint4(~0u, ~0u, ~0u, ~0u);
      q[i] = v.x, q[i + 1] = v.y, q[i + 2] = v.z, q[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPartItems; ++i) {
      const int e = part_pos(i, 0);
      q[i] = e < n ? pr[e] : ~0u;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPartItems; ++i) {
    if (q[i] >= P) q[i] = ~0u;  // as uint32, a negative index is >= 2^31 > P
    else atomicAdd(&s_end[q[i] >> kUnsortLogW], 1);
  }
  __syncthreads();

  // 2. each thread scans a run of consecutive buckets; a nonempty bucket
  // reserves its run in the staging segment
  {
    const int per = (nb + kPartThreads - 1) / kPartThreads;
    const int b0 = int(threadIdx.x) * per;
    const int b1 = b0 + per < nb ? b0 + per : nb;
    int run = 0;
    for (int b = b0; b < b1; ++b) run += s_end[b];
    run = block_exclusive_scan(run, warp_sums);
    int* cur = cursors + row * nb;
    for (int b = b0; b < b1; ++b) {
      const int c = s_end[b];
      if (c) s_dst[b] = b * kUnsortW + atomicAdd(&cur[b], c) - run;
      s_start[b] = run;
      s_end[b] = run;
      run += c;
    }
  }
  __syncthreads();

  // 3. the tile ordered by bucket, with each value's offset in its window
  if (vec) {
#pragma unroll
    for (int i = 0; i < kPartItems; i += 4) {
      const int e = part_pos(i, 1);
      if (e < n) {
        const uint4 v = *reinterpret_cast<const uint4*>(vr + e);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (q[i + k] == ~0u) continue;
          const int pos = atomicAdd(&s_end[q[i + k] >> kUnsortLogW], 1);
          s_val[pos] = w[k];
          s_off[pos] = uint16_t(q[i + k] & (kUnsortW - 1));
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPartItems; ++i) {
      if (q[i] == ~0u) continue;
      const int pos = atomicAdd(&s_end[q[i] >> kUnsortLogW], 1);
      s_val[pos] = vr[part_pos(i, 0)];
      s_off[pos] = uint16_t(q[i] & (kUnsortW - 1));
    }
  }
  __syncthreads();

  // 4. one warp per bucket writes its run to consecutive staging slots
  const int lane = threadIdx.x & 31;
  uint32_t* sv = st_val + row * P;
  uint16_t* so = st_off + row * P;
  for (int b = threadIdx.x >> 5; b < nb; b += kPartThreads / 32) {
    const int s = s_start[b], e = s_end[b];
    if (s == e) continue;
    const long long dst = s_dst[b];
    const long long lim = (long long)(b + 1) * kUnsortW < P ? (long long)(b + 1) * kUnsortW : P;
    for (int i = s + lane; i < e; i += 32) {
      const long long d = dst + i;
      if (d < lim) {
        sv[d] = s_val[i];
        so[d] = s_off[i];
      }
    }
  }
}

// Unsort pass 2, one block per (row, bucket): the bucket's staged values go
// to their offsets in a shared-memory window, and the window goes to the
// output with consecutive (16-byte where vec) stores.
__global__ void __launch_bounds__(kPlaceThreads)
unsort_place_kernel(const int* __restrict__ cursors, const uint32_t* __restrict__ st_val,
                    const uint16_t* __restrict__ st_off, long long P, int nb, int vec,
                    uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t win[];  // kUnsortW
  const long long row = blockIdx.x / nb;
  const long long lo = (long long)(blockIdx.x % nb) * kUnsortW;
  const int size = int(P - lo < kUnsortW ? P - lo : kUnsortW);
  const int n = cursors[blockIdx.x] < size ? cursors[blockIdx.x] : size;
  const long long base = row * P + lo;
  for (int k = threadIdx.x; k < n; k += kPlaceThreads) win[st_off[base + k]] = st_val[base + k];
  __syncthreads();
  uint32_t* o = out + base;
  if (vec) {  // 4 | P: size is a multiple of 4 and o 16-byte aligned
    for (int k = threadIdx.x; 4 * k < size; k += kPlaceThreads)
      reinterpret_cast<uint4*>(o)[k] = reinterpret_cast<const uint4*>(win)[k];
  } else {
    for (int k = threadIdx.x; k < size; k += kPlaceThreads) o[k] = win[k];
  }
}

bool aligned(const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; }

long long tiles_per_row(long long P) { return (P + kTile - 1) / kTile; }
long long unsort_buckets(long long P) { return (P + kUnsortW - 1) / kUnsortW; }
bool unsort_two_pass(long long P) { return unsort_buckets(P) <= kUnsortMaxBuckets; }
long long segs_per_row(long long P) { return (tiles_per_row(P) + kSegTiles - 1) / kSegTiles; }

template <bool kFloat>
int sort_passes(const uint32_t* ki, const uint32_t* pi, long long B, long long P, uint32_t* ko,
                uint32_t* po, uint32_t* sk, uint32_t* sp, int* counts, int* seg,
                cudaStream_t st) {
  const int nt = int(tiles_per_row(P)), S = int(segs_per_row(P));
  const unsigned tiles = unsigned(B * nt);
  const bool vec4 = P % 4 == 0;
  const uint32_t* src_k = ki;
  const uint32_t* src_p = pi;
  cudaError_t err;
  for (int pass = 0; pass < kPasses; ++pass) {
    uint32_t* dst_k = pass % 2 == 0 ? sk : ko;  // ends in the outputs
    uint32_t* dst_p = pass % 2 == 0 ? sp : po;
    const int shift = pass * kBits;
    const int vec = vec4 && aligned(src_k) && aligned(src_p);
    radix_hist_kernel<kFloat><<<tiles, kThreads, 0, st>>>(src_k, P, nt, shift, vec, counts);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    radix_scan_tiles_kernel<<<unsigned(B * S), kThreads, 0, st>>>(counts, nt, S, seg);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    radix_scan_segs_kernel<<<unsigned(B), kThreads, 0, st>>>(seg, S);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    radix_scatter_kernel<kFloat><<<tiles, kThreads, 0, st>>>(src_k, src_p, P, nt, S, shift, vec,
                                                             counts, seg, dst_k, dst_p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    src_k = dst_k;
    src_p = dst_p;
  }
  return 0;
}

}  // namespace

extern "C" {

// int32 words of the (row, tile, digit) counts and (row, segment, digit)
// offsets that ee_sort_rows needs as `aux` for B rows of P.
long long ee_sort_aux_words(long long B, long long P) {
  return B * (tiles_per_row(P) + segs_per_row(P)) * kRadix;
}

// Sort each of the B rows of P keys (key_is_float: float32, else int32)
// ascending and stably, the 32-bit payload following its key.  Outputs,
// scr_key and scr_pay are (B, P); aux holds ee_sort_aux_words(B, P) int32.
// Returns the first launch error.
int ee_sort_rows(const void* key_in, const void* pay_in, int key_is_float, long long B,
                 long long P, void* key_out, void* pay_out, void* scr_key, void* scr_pay,
                 void* aux, void* stream) {
  if (B <= 0 || P <= 0) return 0;
  if (P >= (1LL << 31)) return cudaErrorInvalidValue;
  auto* ki = static_cast<const uint32_t*>(key_in);
  auto* pi = static_cast<const uint32_t*>(pay_in);
  auto* ko = static_cast<uint32_t*>(key_out);
  auto* po = static_cast<uint32_t*>(pay_out);
  auto* sk = static_cast<uint32_t*>(scr_key);
  auto* sp = static_cast<uint32_t*>(scr_pay);
  int* counts = static_cast<int*>(aux);
  int* seg = counts + B * tiles_per_row(P) * kRadix;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return key_is_float ? sort_passes<true>(ki, pi, B, P, ko, po, sk, sp, counts, seg, st)
                      : sort_passes<false>(ki, pi, B, P, ko, po, sk, sp, counts, seg, st);
}

// Elements of a window of the two-pass unsort (its buckets' size).
int ee_unsort_window() { return kUnsortW; }

// int32 words of the scratch that ee_unsort_rows needs for B rows of P: the
// (row, bucket) cursors, then the staged values and their 16-bit offsets;
// 0 for rows that take the one-pass scatter.
long long ee_unsort_scratch_words(long long B, long long P) {
  if (B <= 0 || P <= 0 || !unsort_two_pass(P)) return 0;
  return B * unsort_buckets(P) + B * P + (B * P + 1) / 2;
}

// out[r, perm[r, i]] = vals[r, i] for (B, P) int32 perm whose rows are
// permutations of 0..P-1 and 32-bit vals; indices outside [0, P) are
// dropped.  scratch holds ee_unsort_scratch_words(B, P) int32.  Returns the
// first launch error.
int ee_unsort_rows(const void* perm, const void* vals, long long B, long long P, void* out,
                   void* scratch, void* stream) {
  if (B <= 0 || P <= 0) return 0;
  if (P >= (1LL << 31)) return cudaErrorInvalidValue;
  auto* pr = static_cast<const uint32_t*>(perm);
  auto* vr = static_cast<const uint32_t*>(vals);
  auto* o = static_cast<uint32_t*>(out);
  const int vec = P % 4 == 0 && aligned(pr) && aligned(vr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!unsort_two_pass(P)) {
    for (long long row0 = 0; row0 < B; row0 += kMaxGridY) {
      const unsigned rows = unsigned(B - row0 < kMaxGridY ? B - row0 : kMaxGridY);
      unsort_kernel<<<dim3(unsigned(tiles_per_row(P)), rows), kThreads, 0, st>>>(pr, vr, P, row0,
                                                                                 vec, o);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    return 0;
  }
  const int nb = int(unsort_buckets(P));
  const long long nt = (P + kPartTile - 1) / kPartTile;
  if (B * nt >= (1LL << 31) || B * nb >= (1LL << 31)) return cudaErrorInvalidValue;
  int* cursors = static_cast<int*>(scratch);
  auto* st_val = reinterpret_cast<uint32_t*>(cursors + B * nb);
  auto* st_off = reinterpret_cast<uint16_t*>(st_val + B * P);
  if ((err = cudaMemsetAsync(cursors, 0, size_t(B * nb) * sizeof(int), st)) != cudaSuccess)
    return err;
  const int part_smem = kPartTile * 6 + 3 * nb * int(sizeof(int));
  if ((err = cudaFuncSetAttribute(unsort_partition_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, part_smem)) !=
      cudaSuccess)
    return err;
  unsort_partition_kernel<<<unsigned(B * nt), kPartThreads, part_smem, st>>>(
      pr, vr, P, int(nt), nb, vec, cursors, st_val, st_off);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int place_smem = kUnsortW * int(sizeof(uint32_t));
  if ((err = cudaFuncSetAttribute(unsort_place_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, place_smem)) !=
      cudaSuccess)
    return err;
  unsort_place_kernel<<<unsigned(B * nb), kPlaceThreads, place_smem, st>>>(
      cursors, st_val, st_off, P, nb, P % 4 == 0 && aligned(o), o);
  return cudaGetLastError();
}

}  // extern "C"
