// Per-row key-value sort for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU (Pallas) kernel of the training path:
//   D  ee_semantic_segmentation_tpu/ops/pallas/sort_kernel.py:293
//      sort_pallas (_sort_kernel / bitonic_sort_2d, _merge_kernel /
//      bitonic_merge_2d, chunk loop _sort_chunked): each row of (B, P) keys in
//      ascending order, one 32-bit payload following its key.  The Lovász
//      loss calls it twice per step: the forward sorts the negated errors
//      with a packed (position, fg, valid) payload, the backward unsorts the
//      gradient by sorting on the saved positions.
//
// Design: a bitonic network, like the JAX kernel, on a power-of-two row of
// N >= P elements (the tail padded with keys that sort last).
//   * Keys are compared as uint32 in an order-preserving map: a float32 key
//     with its sign set has all bits flipped, else only the sign bit (NaNs
//     first become one quiet NaN, so they sort last as in torch.sort); an
//     int32 key has its sign bit flipped.  The padding key is 0xFFFFFFFF.
//     One comparison serves both key types, and int32 position keys stay
//     exact at every P.  The map is applied on the first load and undone on
//     the last store, so it costs no pass of its own.
//   * sort_tiles_kernel: one block sorts a tile of T = 2^13 elements (key and
//     payload, 64 KB of dynamic shared memory) through stages 1..13 of the
//     network.  Each compare-exchange takes its direction from bit s of the
//     element's index in the whole row, so tiles come out in the alternating
//     order the later stages need.  Shared memory holds the tile in padded
//     slots (one pad word per 32); the network's levels run up to four at a
//     time in registers; tiles move to and from device memory in 16-byte
//     accesses (4-byte ones for rows whose P is not a multiple of 4).
//   * For each stage s > 13, the distances d >= T run in device memory,
//     up to four of them per merge_passes_kernel launch: a thread loads the
//     16 elements those four distances pair among themselves (coalesced
//     across the warp), orders them in registers, and stores them back.
//     Then the distances below T run in merge_tiles_kernel, one
//     shared-memory block per tile.
//   * The kernel that ends the network writes the (B, P) outputs with the
//     key map undone; the others write a (B, N) scratch the wrapper
//     allocates.  A row of at most T elements is one sort_tiles_kernel.
// Grid: one block per tile of every row, flattened into x (rows x tiles per
// row), 64-bit offsets (B * N reaches 2^28 at the flagship).  Every launch
// is on the caller's stream.
//
// Bound: bytes.  A sort has to read each key and payload once and write each
// once: B * P * 16 bytes, 4.2 GB for the flagship's 63 rows of 2^22, 1.26 ms
// at 3.35 TB/s; the compares (~log2(N)^2 / 4 per element) are integer work
// far below the card's rate.  Every pass over device memory moves all
// those bytes again: at P = 2^22, after the tile sort, the network has 45
// distances >= T and 9 tile merges.  What the design does about it: the
// first 13 stages (91 of the 253 distances at 2^22) and the 13 smallest
// distances of every later stage stay in shared memory, and the 45 larger
// distances run as 15 register passes.  A radix sort or a multi-way merge
// that moves the row a few times only is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLogTile = 13;        // T = 8192 elements per shared-memory tile
constexpr int kTileThreads = 512;   // T / 16 groups of 16 elements
constexpr int kPassThreads = 256;
constexpr int kMaxLevels = 4;       // network levels per register pass: 16 elements
constexpr uint32_t kPadKey = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t to_ordered(uint32_t u, int key_is_float) {
  if (key_is_float) {
    if ((u & 0x7FFFFFFFu) > 0x7F800000u) u = 0x7FC00000u;  // one NaN, sorts last
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  return u ^ 0x80000000u;
}

__device__ __forceinline__ uint32_t from_ordered(uint32_t u, int key_is_float) {
  if (key_is_float) return (u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u;
  return u ^ 0x80000000u;
}

// Shared-memory slot of tile element i: one pad word per 32, so that the
// strided groups of a register pass fall in distinct banks.
__device__ __forceinline__ int slot(int i) { return i + (i >> 5); }

// Order (ka, pa), (kb, pb) ascending, or descending when desc.
__device__ __forceinline__ void order_pair(uint32_t& ka, uint32_t& kb, uint32_t& pa,
                                           uint32_t& pb, bool desc) {
  if (desc ? (ka < kb) : (ka > kb)) {
    uint32_t t = ka; ka = kb; kb = t;
    t = pa; pa = pb; pb = t;
  }
}

// The L network levels at distances 2^(L-1) .. 1 of a group's 2^L elements
// held in registers (element m of the group at distance m * 2^j_lo in the
// row), all in one direction.
template <int L>
__device__ __forceinline__ void order_group(uint32_t (&k)[1 << L], uint32_t (&p)[1 << L],
                                            bool desc) {
#pragma unroll
  for (int l = L - 1; l >= 0; --l) {
#pragma unroll
    for (int m = 0; m < (1 << L); ++m) {
      if (!(m & (1 << l))) order_pair(k[m], k[m + (1 << l)], p[m], p[m + (1 << l)], desc);
    }
  }
}

// Levels j_lo + L - 1 .. j_lo of stage s on a shared-memory tile, one
// round trip: each group {i0 + m * 2^j_lo} goes to registers and back.  The
// direction is bit s of the element's index in the row, rbase + i, the same
// for the whole group since s > j_lo + L - 1.
template <int L>
__device__ __forceinline__ void tile_passes(uint32_t* sk, uint32_t* sp, int T, int j_lo, int s,
                                            long long rbase) {
  constexpr int M = 1 << L;
  const int d = 1 << j_lo;
  for (int q = threadIdx.x; q < (T >> L); q += blockDim.x) {
    const int i0 = ((q >> j_lo) << (j_lo + L)) | (q & (d - 1));
    const bool desc = ((rbase + i0) >> s) & 1;
    uint32_t k[M], p[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      k[m] = sk[slot(i0 + m * d)];
      p[m] = sp[slot(i0 + m * d)];
    }
    order_group<L>(k, p, desc);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      sk[slot(i0 + m * d)] = k[m];
      sp[slot(i0 + m * d)] = p[m];
    }
  }
}

// Levels j_top .. 0 of stage s on a shared-memory tile, up to kMaxLevels
// per round trip.
__device__ __forceinline__ void tile_levels(uint32_t* sk, uint32_t* sp, int T, int j_top, int s,
                                            long long rbase) {
  for (int j = j_top; j >= 0;) {
    const int L = j + 1 < kMaxLevels ? j + 1 : kMaxLevels;
    const int j_lo = j - L + 1;
    switch (L) {
      case 1: tile_passes<1>(sk, sp, T, j_lo, s, rbase); break;
      case 2: tile_passes<2>(sk, sp, T, j_lo, s, rbase); break;
      case 3: tile_passes<3>(sk, sp, T, j_lo, s, rbase); break;
      default: tile_passes<4>(sk, sp, T, j_lo, s, rbase); break;
    }
    __syncthreads();
    j = j_lo - 1;
  }
}

// Four consecutive tile elements (i a multiple of 4: four consecutive
// slots) between registers and shared memory.
__device__ __forceinline__ uint4 get4(const uint32_t* s, int i) {
  const int o = slot(i);
  return make_uint4(s[o], s[o + 1], s[o + 2], s[o + 3]);
}

__device__ __forceinline__ void put4(uint32_t* s, int i, uint4 u) {
  const int o = slot(i);
  s[o] = u.x; s[o + 1] = u.y; s[o + 2] = u.z; s[o + 3] = u.w;
}

// Where a tile goes after its last pass: to the (B, N) scratch, or, when it
// ends the network, to the (B, P) outputs with the key map undone.  Device
// memory moves in 16-byte accesses: always for the scratch (T = 2^13
// there), for the outputs when vec (4 | P, 16-byte aligned tensors).
__device__ __forceinline__ void store_tile(const uint32_t* sk, const uint32_t* sp, int T,
                                           long long tile, long long row, long long rbase,
                                           long long P, int key_is_float, int final_out,
                                           bool vec, uint32_t* scr_key, uint32_t* scr_pay,
                                           uint32_t* out_key, uint32_t* out_pay) {
  if (final_out && vec) {
    uint32_t* ok = out_key + row * P;
    uint32_t* op = out_pay + row * P;
    for (int v = threadIdx.x; v < T / 4; v += blockDim.x) {
      const long long g = rbase + 4 * v;
      if (g < P) {
        const uint4 k = get4(sk, 4 * v);
        *reinterpret_cast<uint4*>(ok + g) =
            make_uint4(from_ordered(k.x, key_is_float), from_ordered(k.y, key_is_float),
                       from_ordered(k.z, key_is_float), from_ordered(k.w, key_is_float));
        *reinterpret_cast<uint4*>(op + g) = get4(sp, 4 * v);
      }
    }
  } else if (final_out) {
    uint32_t* ok = out_key + row * P;
    uint32_t* op = out_pay + row * P;
    for (int l = threadIdx.x; l < T; l += blockDim.x) {
      const long long g = rbase + l;
      if (g < P) {
        ok[g] = from_ordered(sk[slot(l)], key_is_float);
        op[g] = sp[slot(l)];
      }
    }
  } else {
    uint4* tk = reinterpret_cast<uint4*>(scr_key + tile * T);
    uint4* tp = reinterpret_cast<uint4*>(scr_pay + tile * T);
    for (int v = threadIdx.x; v < T / 4; v += blockDim.x) {
      tk[v] = get4(sk, 4 * v);
      tp[v] = get4(sp, 4 * v);
    }
  }
}

// Stages 1..log2T of the network on each tile, from the (B, P) inputs.
__global__ void __launch_bounds__(kTileThreads)
sort_tiles_kernel(const uint32_t* __restrict__ key_in, const uint32_t* __restrict__ pay_in,
                  int key_is_float, long long P, int log2N, int log2T, int final_out, int vec,
                  uint32_t* scr_key, uint32_t* scr_pay, uint32_t* out_key, uint32_t* out_pay) {
  extern __shared__ uint32_t smem[];
  const int T = 1 << log2T;
  uint32_t* sk = smem;
  uint32_t* sp = smem + slot(T);
  const long long tile = blockIdx.x;
  const int shift = log2N - log2T;
  const long long row = tile >> shift;
  const long long rbase = (tile & ((1LL << shift) - 1)) << log2T;
  const uint32_t* kin = key_in + row * P;
  const uint32_t* pin = pay_in + row * P;
  if (vec) {  // 4 | P: a quad is all real or all padding
    for (int v = threadIdx.x; v < T / 4; v += blockDim.x) {
      const long long g = rbase + 4 * v;
      uint4 k = make_uint4(kPadKey, kPadKey, kPadKey, kPadKey), p = make_uint4(0u, 0u, 0u, 0u);
      if (g < P) {
        k = *reinterpret_cast<const uint4*>(kin + g);
        p = *reinterpret_cast<const uint4*>(pin + g);
        k = make_uint4(to_ordered(k.x, key_is_float), to_ordered(k.y, key_is_float),
                       to_ordered(k.z, key_is_float), to_ordered(k.w, key_is_float));
      }
      put4(sk, 4 * v, k);
      put4(sp, 4 * v, p);
    }
  } else {
    for (int l = threadIdx.x; l < T; l += blockDim.x) {
      const long long g = rbase + l;
      const bool real = g < P;
      sk[slot(l)] = real ? to_ordered(kin[g], key_is_float) : kPadKey;
      sp[slot(l)] = real ? pin[g] : 0u;
    }
  }
  __syncthreads();
  for (int s = 1; s <= log2T; ++s) tile_levels(sk, sp, T, s - 1, s, rbase);
  store_tile(sk, sp, T, tile, row, rbase, P, key_is_float, final_out, vec, scr_key, scr_pay,
             out_key, out_pay);
}

// Distances 2^(log2T - 1) .. 1 of stage s > log2T on each tile of the scratch.
__global__ void __launch_bounds__(kTileThreads)
merge_tiles_kernel(int key_is_float, long long P, int log2N, int log2T, int s, int final_out,
                   int vec, uint32_t* scr_key, uint32_t* scr_pay, uint32_t* out_key,
                   uint32_t* out_pay) {
  extern __shared__ uint32_t smem[];
  const int T = 1 << log2T;
  uint32_t* sk = smem;
  uint32_t* sp = smem + slot(T);
  const long long tile = blockIdx.x;
  const int shift = log2N - log2T;
  const long long row = tile >> shift;
  const long long rbase = (tile & ((1LL << shift) - 1)) << log2T;
  const uint4* tk = reinterpret_cast<const uint4*>(scr_key + tile * T);
  const uint4* tp = reinterpret_cast<const uint4*>(scr_pay + tile * T);
  for (int v = threadIdx.x; v < T / 4; v += blockDim.x) {
    put4(sk, 4 * v, tk[v]);
    put4(sp, 4 * v, tp[v]);
  }
  __syncthreads();
  tile_levels(sk, sp, T, log2T - 1, s, rbase);
  store_tile(sk, sp, T, tile, row, rbase, P, key_is_float, final_out, vec, scr_key, scr_pay,
             out_key, out_pay);
}

// Levels j_lo + L - 1 .. j_lo (distances >= T) of stage s over the (B, N)
// scratch, in place and in one launch: each thread loads the 2^L elements
// {i0 + m * 2^j_lo} those levels pair among themselves, coalesced across the
// warp, orders them in registers and stores them back.
template <int L>
__global__ void __launch_bounds__(kPassThreads)
merge_passes_kernel(uint32_t* __restrict__ key, uint32_t* __restrict__ pay, int log2N, int s,
                    int j_lo, long long n_groups) {
  constexpr int M = 1 << L;
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= n_groups) return;
  const int log2g = log2N - L;  // groups per row: N / 2^L
  const long long row = t >> log2g;
  const long long g = t & ((1LL << log2g) - 1);
  const long long i0 = ((g >> j_lo) << (j_lo + L)) | (g & ((1LL << j_lo) - 1));
  const bool desc = (i0 >> s) & 1;
  const long long d = 1LL << j_lo;
  uint32_t* kr = key + (row << log2N) + i0;
  uint32_t* pr = pay + (row << log2N) + i0;
  uint32_t k[M], p[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    k[m] = kr[m * d];
    p[m] = pr[m * d];
  }
  order_group<L>(k, p, desc);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    kr[m * d] = k[m];
    pr[m * d] = p[m];
  }
}

}  // namespace

extern "C" {

int ee_sort_log2_tile() { return kLogTile; }

// Sort each of the B rows of P keys (key_is_float: float32, else int32)
// ascending, the 32-bit payload following its key.  Outputs are (B, P);
// scr_key / scr_pay are (B, N) with N the next power of two >= P, needed
// (and read) only when N > 2^kLogTile.  Returns the first launch error.
int ee_sort_rows(const void* key_in, const void* pay_in, int key_is_float, long long B,
                 long long P, void* key_out, void* pay_out, void* scr_key, void* scr_pay,
                 void* stream) {
  if (B <= 0 || P <= 0) return 0;
  int log2N = 0;
  while ((1LL << log2N) < P) ++log2N;
  const int log2T = log2N < kLogTile ? log2N : kLogTile;
  const int T = 1 << log2T;
  const size_t smem = size_t(T + (T >> 5)) * 2 * sizeof(uint32_t);  // padded slots
  const int threads = T / 2 < 1 ? 1 : (T / 2 < kTileThreads ? T / 2 : kTileThreads);
  const long long n_tiles = B << (log2N - log2T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int max_smem = ((1 << kLogTile) + (1 << (kLogTile - 5))) * 2 * int(sizeof(uint32_t));
  if ((err = cudaFuncSetAttribute(sort_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  max_smem)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(merge_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  max_smem)) != cudaSuccess)
    return err;

  auto* ki = static_cast<const uint32_t*>(key_in);
  auto* pi = static_cast<const uint32_t*>(pay_in);
  auto* ko = static_cast<uint32_t*>(key_out);
  auto* po = static_cast<uint32_t*>(pay_out);
  auto* sk = static_cast<uint32_t*>(scr_key);
  auto* sp = static_cast<uint32_t*>(scr_pay);

  const int single = log2N == log2T;
  const auto aligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  const int vec = P % 4 == 0 && aligned(ki) && aligned(pi) && aligned(ko) && aligned(po);
  sort_tiles_kernel<<<unsigned(n_tiles), threads, smem, st>>>(ki, pi, key_is_float, P, log2N, log2T,
                                                    single, vec, sk, sp, ko, po);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (single) return 0;

  for (int s = log2T + 1; s <= log2N; ++s) {
    // distances 2^(s-1) .. T, up to kMaxLevels of them per launch
    for (int j = s - 1; j >= log2T;) {
      const int L = j - log2T + 1 < kMaxLevels ? j - log2T + 1 : kMaxLevels;
      const int j_lo = j - L + 1;
      const long long n_groups = (B << log2N) >> L;
      const unsigned blocks = unsigned((n_groups + kPassThreads - 1) / kPassThreads);
      switch (L) {
        case 1: merge_passes_kernel<1><<<blocks, kPassThreads, 0, st>>>(sk, sp, log2N, s, j_lo, n_groups); break;
        case 2: merge_passes_kernel<2><<<blocks, kPassThreads, 0, st>>>(sk, sp, log2N, s, j_lo, n_groups); break;
        case 3: merge_passes_kernel<3><<<blocks, kPassThreads, 0, st>>>(sk, sp, log2N, s, j_lo, n_groups); break;
        default: merge_passes_kernel<4><<<blocks, kPassThreads, 0, st>>>(sk, sp, log2N, s, j_lo, n_groups); break;
      }
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      j = j_lo - 1;
    }
    merge_tiles_kernel<<<unsigned(n_tiles), threads, smem, st>>>(key_is_float, P, log2N, log2T, s,
                                                       s == log2N, vec, sk, sp, ko, po);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return 0;
}

}  // extern "C"
