// Tracked crop scoring of a particle cloud, for Hopper (sm_90a): at one
// uniform scale, or over K scale buckets on a mip pyramid.
//
// Replaces: top_down_renderer_tpu/filter/pallas_score.py::_kernel (launched
// by _run_kernel) with its `sel` (tracked) epilogue, as called by
// pallas_score.py for one uniform scale (make_score_tracked) and by
// filter/multiscale.py's make_score_tracked_multi for K buckets.  The TPU
// kernel sorts the particles into shift groups of 16, DMAs an int8 crop of
// the map around every particle and contracts it on the MXU with the
// group's 16-column M (the stencil -> pixel one-hot folded through the
// rolled-scan circulant), keeping each particle's own column.  On Hopper a
// 16-column product that keeps one column would waste 15/16 of the tensor
// work, so none of that layout is carried over.  The contract:
//
//   cost = sum_{t,r,c} 0.01 w_c scan_c[(t+s) % Th, r] * map_c(cell)
//   norm = sum_{t,r} (sum_c scan_c)[(t+s) % Th, r] * known(cell)
//   kf   = sum known / (Th R)
//
// for particle p at its own shift s, cell (t, r) at centre + off[t, r]
// (zero outside the map or the bucket's pyramid level).  (The theta search
// over 40 shifts is csrc/crop_score_init.cu, on tensor cores.)
//
// Bound on an H100: the gather from L2.  The Th*R = 2,500 stencil cells
// land on far fewer distinct pixels (1,577 at f = 1; 197-489 per bucket at
// mo 12), and the score reads only C + 1 of the packed map's 8 channels.
// The design reads each distinct pixel once, from the compact map (C
// classes and the known channel in CP = 2, 4 or 8 floats: one 16-byte load
// at C <= 3):
//   - crop_fold_kernel folds each offset table to its distinct pixels,
//     row-major, with the CSR of each pixel's stencil cells, the result of
//     crop_score.fold_offsets in one launch (one block per table: a stable
//     radix sort of each cell's index in the table's bounding box, then a
//     block scan; bound by the latency of its barrier-separated steps, see
//     the kernel);
//   - the wrapper orders the particles by group = bucket * Th + shift
//     (crop_order_kernel, one launch: the keys, a stable radix sort and
//     the permutation; with the hi/lo M the group above the Morton code
//     of the centre's tile, with the single-plane M the group alone);
//     block i of the tracked kernel takes sorted rows
//     [i kTile, (i + 1) kTile) and walks them run by run, one group a run;
//   - for each run the block folds the weights of its shift into W[u] = (C
//     cost weights, one norm weight, the cell count) in shared memory, each
//     pixel's cells summed in the CSR's order, from scan tables staged once
//     a block: no atomics, so a call repeats bit for bit;
//   - each warp scores one particle at a time: its lanes take consecutive
//     distinct pixels (neighbours along a map row, so the loads coalesce),
//     C + 2 FMAs a pixel, then a fixed butterfly sum, and the row goes back
//     to its particle through the sort's permutation.
// kf is an integer count of known cells times 1/(Th R), exact as in the
// plain version.  The gather's loads, and the instructions around each (a
// bounds test, a 64-bit address, C + 3 shared-memory loads), bound it, not
// L2's bytes (PERF.md §6).  So each shift group's rows go in the order of
// their centres' positions (crop_score.tracked_order: a block's rows lie
// close together, and their windows meet in L1); a row whose stencil lies
// inside its level reads pixel u at its base plus u's offset with no
// bounds check, and a warp scores two such rows at once, each pixel's
// offset and weights read once for both (crop_tracked.cuh).
//
// The tracked kernel's body lives in crop_tracked.cuh, which
// csrc/crop_ablate.cu includes too, to time it with stages knocked out.
//
// The nibble-packed map (TDR_MAP_INT4=1; the same TPU kernel's `i4`
// configuration, pallas_score.py's int4 layout): crop_tracked_i4_kernel is
// the same body reading the code map, (pixels, CP/2) bytes, each channel a
// 4-bit (even) or 3-bit (odd) code.  A lane loads its pixel's CP/2 bytes in
// one load (2 bytes at C = 3, where the float map takes a 16-byte one) and
// turns each code into code * qinv in float32 with a byte permute and one
// FMA (load_codes): the dequantized map's values, on which the fold, the
// weights and the per-shift sums are the float kernel's.  The gather's
// bytes fall 8x at C = 3, but not its loads, which with their latency
// and the instructions around them bound it (PERF.md §6).  So the code
// map, 2 MB at 1024^2 and C = 3, is small enough to stage by the block:
// the wrapper orders each shift group's rows by position
// (crop_score.tracked_order), and each block copies the box of its rows'
// windows into shared memory by 1-D bulk copies where it fits (a 100 px
// cloud at f = 1: ~7 KB a block of 64 rows), s_pix and the weights at the
// fold's own largest npix to leave it room at two blocks an SM, and
// gathers from there; a block whose box does not fit gathers from L2, as
// before.  Rows whose stencil lies inside the level skip the bounds check,
// and a warp scores two of them at once (crop_tracked.cuh, Window).
//
// The single-plane M (TDR_M_HILO=0; the same TPU kernel's `lokf`
// configuration, one int8 plane of M per (variant, column), the kf column's
// residual kept beside it).  The TPU kernel's tracked variants are groups
// of 16 shifts, each column one shift, so its scales are per (bucket,
// shift) for cost and norm and per bucket for kf; rounding a folded weight
// needs its column's amax over every pixel first.  So the wrapper launches
// crop_lokf_weights_kernel once (the weights pass: each (bucket, shift)
// group's fold of every distinct pixel, the cells' coefficients in bf16
// times qinv (the map quantization's) summed in float64, exact, so the pass
// and the plain version agree bit for bit whatever their order; each
// column's amax and its scale; then every pixel's integers round(bf16(sum)
// / s) into a table (K*Th, C + 3, P) int16 and the scales (K, Th, 4)),
// then crop_tracked_lokf_kernel, which folds nothing: for each run it
// copies its group's integers and scales into shared memory by 1-D bulk
// copies on an mbarrier, the next run's copy in flight while the warps
// gather, and dequantizes them in crop_score.tracked_lokf_weights' float32
// operations (crop_tracked.cuh, lokf_dequant).  The gather and the FMAs are
// the hi/lo kernel's; on the code map the weights apply to the codes
// themselves.  Each group is folded and rounded once a call, not once in
// every block that holds one of its runs (hundreds of blocks a group on a
// clustered cloud, whose blocks share a handful of shifts); no block does
// float64 arithmetic or a division.

// Contract (equal to the plain versions in filter/crop_score.py and
// filter/multiscale.py up to float summation order): the compact map is
// (pixels, CP) float32, classes in channels [0, C), known in channel C;
// centers are (cy, cx) int32, pixel offsets (dy, dx) int32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "crop_tracked.cuh"

namespace {

constexpr int kFoldThreads = 1024;  // one block per offset table
constexpr int kFoldWarps = kFoldThreads / 32;
constexpr int kFoldCells = 16384;  // Th*R at most
constexpr int kDigitBits = 8;      // the widest radix digit
// shared memory of a fold block: two buffers of the cells in their
// current order and each cell's rank (12 bytes a cell), then the counts
// of every warp by digit, a row of kBins + 1 a warp (the pad spreads a
// warp's digits over the banks); 229,504 bytes at kFoldCells, of the
// 232,448 a block may have
constexpr int kBins = 1 << kDigitBits;
constexpr size_t kHistBytes = (size_t)kFoldWarps * (kBins + 1) * sizeof(int);
constexpr int kPad = 1 << 29;  // (dy, dx) of a padding pixel: PAD_PIX

// v's bits 0-15 moved to the even bit positions 0-30 (bit i to bit 2i)
__device__ __forceinline__ unsigned spread_bits(unsigned v) {
  v &= 0xffffu;
  v = (v | (v << 8)) & 0x00ff00ffu;
  v = (v | (v << 4)) & 0x0f0f0f0fu;
  v = (v | (v << 2)) & 0x33333333u;
  v = (v | (v << 1)) & 0x55555555u;
  return v;
}

// The row order (crop_score.order_rows): one cooperative launch that
// gives the crop kernels' rows their order.  It replaces no TPU kernel:
// the JAX wrapper sorts the particles by group itself, with a stable
// counting sort (pallas_score.py::_counting_pos, _group_layout), which the
// port had swapped for torch.sort; here it is a kernel of its own.
//
// Each row's 32-bit key is the group key in the bits from kshift up and,
// below it, the Morton code of its centre's tile, min(max(centre, 0), hi)
// >> tbits, the tile row's bits at the odd positions and its column's at
// the even ones (crop_score.order_keys_plain; kshift 0: the group key
// alone, and no centres are read).  The kernel writes the keys sorted
// stably (as signed int32: the sign bit is flipped for the digits), the
// permutation, int32 or int64 as the caller's crop kernel reads it, and,
// with K > 0 groups, row_start (K + 1) int64: the first row of each group
// and N, torch.searchsorted's answer on the sorted keys.  Stability makes
// the permutation unique, so the result equals torch.sort's bit for bit.
//
// Design: a stable LSD radix sort of 8-bit digits, in one persistent
// launch of as many blocks as the card holds at once (at most one a tile
// of kOrderTile rows; a block walks tiles blockIdx.x + j gridDim.x), with
// grid barriers between its steps:
//   1. the key pass computes every key in registers and counts, per
//      block in shared memory and then by atomics into this call's
//      counters, the digits of all four passes at once and the rows of
//      each group (order-free sums: no rank depends on the atomics'
//      order);
//   2. after a grid barrier every block turns the counts into each
//      digit's first slot (the four passes' scans at once, a digit a
//      thread) and drops each pass whose
//      digit is one value for every row (a pass that would move nothing:
//      at K = 1 the group's bits and the Morton code's unused top bits,
//      one or two of the four); block 0 writes row_start from the groups'
//      counts;
//   3. each remaining pass, a tile at a time: each warp ranks its 64
//      rows, 32 at a time in row order, against its own row of counts,
//      the lanes of one digit found by one ballot a digit bit (the fold
//      kernel's way); the digit's counts are summed over the warps; the
//      tile publishes its count of each digit and looks back over the
//      tiles before it for its first slot (a decoupled look-back, as
//      csrc/fill_rows.cu's, kLookBack status words of one digit in flight
//      a round); the rows are staged in shared memory in digit order, and
//      written from there, each digit's run to consecutive slots (key and
//      row index in one 8-byte word, to the other of two buffers of N in
//      L2, or, in the last pass, the outputs).  A grid barrier ends each
//      pass but the last.
// Status words hold (epoch, pass, state) beside the count, so words of an
// earlier pass or call read as unpublished; the counters come in two sets
// by the epoch's parity, and each call zeroes the set of the next one, so
// nothing is reset between calls on the stream.  Every spin (the grid
// barrier's, the look-back's) traps after about ten seconds (tma.cuh,
// trap_if_stuck), so a broken call fails its launch rather than hang.
//
// Bound on an H100: bytes, each key and centre read once and the sorted
// keys, the permutation and row_start written once (28 bytes a row with
// int64 groups and perm: 2.9 MB, 0.86 us at 102,400 rows).  The kernel is
// bound instead by the latency of its chain of steps, about 7 us a pass
// at 102,400 rows (tests/time_torch_order.py: ranking 2, the digit sums
// and look-back 3, the staged write 1, the grid barrier 1; PERF.md §6).
// The grid barriers take about a sixth of it, so the sort was not moved
// into one thread-block cluster's distributed shared memory to trade them
// for cluster barriers.  Of the shapes measured, 1,024 threads of two
// rows each (a short ranking chain a warp, 32 warps to hide it) lose to
// none by more than 3 %: 256 threads of eight take 27 % longer, 1,024 of
// one (100 tiles: a longer look-back) 16 % longer with two passes and
// 46 % at 2^20 rows; a window of 16 status words 4 % longer than 8.
constexpr int kOrderThreads = 1024;
constexpr int kOrderItems = 2;  // rows a thread ranks in a tile
constexpr int kOrderWarps = kOrderThreads / 32;
constexpr int kOrderTile = kOrderThreads * kOrderItems;  // 2,048 rows
constexpr int kRadix = 256;                              // 8-bit digits
constexpr int kDigitGroups = kOrderThreads / kRadix;  // threads a digit
constexpr int kOrderPasses = 4;                       // of 32-bit keys
constexpr int kMaxStartGroups = 1024;  // K of row_start at most
constexpr int kLookBack = 8;  // a digit's status words in flight a round
// a call's counters: every pass's digit counts, then the groups' (bin 0
// the negative keys, bin g + 1 group g, the groups from K - 1 up in bin
// K), then the grid barrier's; two sets, by the epoch's parity
constexpr int kOrderBins = kOrderPasses * kRadix;
constexpr int kOrderBarrier = kOrderBins + kMaxStartGroups + 1;
constexpr int kOrderCounters = kOrderBarrier + 1;  // 2,050: even
// a block's shared words that serve, in turn, the groups' counts (key
// pass), the warps' digit counts and the tile's rows in digit order
constexpr int kOrderShared = kOrderWarps * kRadix > 2 * kOrderTile
                                 ? kOrderWarps * kRadix
                                 : 2 * kOrderTile;
constexpr unsigned kAggregate = 1, kInclusive = 2;
static_assert(kOrderThreads % kRadix == 0 && kOrderWarps % kDigitGroups == 0,
              "a digit's warps split evenly over its threads");
static_assert(kOrderShared >= kMaxStartGroups + 1, "the groups' counts fit");

template <typename KeyT>
__device__ __forceinline__ unsigned order_key(const KeyT* __restrict__ key,
                                              const int2* __restrict__ ctr,
                                              int i, int kshift, int tbits,
                                              int hi) {
  unsigned k = (unsigned)__ldg(key + i) << kshift;  // the int32 cast's bits
  if (kshift) {
    const int2 c = __ldg(ctr + i);
    const unsigned ty = (unsigned)min(max(c.x, 0), hi) >> tbits;
    const unsigned tx = (unsigned)min(max(c.y, 0), hi) >> tbits;
    k |= (spread_bits(ty) << 1) | spread_bits(tx);
  }
  return k;
}

__device__ __forceinline__ unsigned order_digit(unsigned k, int p) {
  return ((k ^ 0x80000000u) >> (8 * p)) & 0xffu;
}

// Add one for each lane of `live` (the calling lanes) to hist[d]: one
// atomic for the warp where all its lanes share d (a digit above the keys'
// varying bits), else one a lane.
__device__ __forceinline__ void count_digit(unsigned* hist, unsigned d,
                                            unsigned live, int lane) {
  if (__reduce_min_sync(live, d) == __reduce_max_sync(live, d)) {
    if (lane == __ffs(live) - 1) atomicAdd(hist + d, (unsigned)__popc(live));
  } else {
    atomicAdd(hist + d, 1u);
  }
}

// The exclusive sum of v over the block's threads, in thread order, and
// the total.
__device__ __forceinline__ unsigned order_scan(unsigned v, unsigned* s_scan,
                                               unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_scan[warp] = x;
  __syncthreads();
  unsigned w = lane < kOrderWarps ? s_scan[lane] : 0u;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, w, o);
    if (lane >= o) w += y;
  }
  *total = __shfl_sync(0xffffffffu, w, 31);
  const unsigned below = __shfl_sync(0xffffffffu, w, warp) - s_scan[warp];
  __syncthreads();
  return below + x - v;
}

__device__ __forceinline__ unsigned long long order_load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

// A status word: the high half (tag << 2 | state), tag = epoch << 2 |
// pass; the low half the count.
__device__ __forceinline__ void order_store_status(unsigned long long* p,
                                                   unsigned tag,
                                                   unsigned state,
                                                   unsigned count) {
  const unsigned long long v =
      ((unsigned long long)(tag << 2 | state) << 32) | count;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ bool order_published(unsigned long long w,
                                                unsigned tag) {
  const unsigned hi = (unsigned)(w >> 32);
  return hi >> 2 == tag && (hi & 3u) != 0;
}

// The rows of digit d in the tiles before `tile` (>= 1), by their status
// words, nearest first, kLookBack of them loaded at once: counts until
// the nearest inclusive prefix (tile 0 publishes one at once).
__device__ unsigned order_look_back(const unsigned long long* status,
                                    int tile, int d, unsigned tag) {
  unsigned sum = 0;
  for (int pred = tile - 1;; pred -= kLookBack) {
    unsigned long long w[kLookBack];
#pragma unroll
    for (int k = 0; k < kLookBack; ++k)
      w[k] = pred - k >= 0
                 ? order_load_status(status + (size_t)(pred - k) * kRadix + d)
                 : 0ull;
#pragma unroll
    for (int k = 0; k < kLookBack; ++k) {
      if (pred - k < 0) return sum;  // not reached: tile 0 is inclusive
      unsigned long long v = w[k];
      if (!order_published(v, tag)) {
        const long long t0 = clock64();
        do {
          __nanosleep(20);
          trap_if_stuck(t0);
          v = order_load_status(status + (size_t)(pred - k) * kRadix + d);
        } while (!order_published(v, tag));
      }
      sum += (unsigned)v;
      if (((unsigned)(v >> 32) & 3u) == kInclusive) return sum;
    }
  }
}

// All blocks of the cooperative grid arrive; the count reaches `target`
// (the grid's size times the barriers passed) once they have.  Writes
// before it are seen after it (fence, then a relaxed add; an acquire
// load); the wait traps after about ten seconds.
__device__ __forceinline__ void grid_barrier(unsigned* count,
                                             unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    unsigned seen;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(seen) : "l"(count) : "memory");
    if (seen < target) {
      const long long t0 = clock64();
      do {
        __nanosleep(32);
        trap_if_stuck(t0);
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                     : "=r"(seen) : "l"(count) : "memory");
      } while (seen < target);
    }
  }
  __syncthreads();
}

// The row order (see above).  scratch: the two sets of counters
// (kOrderCounters words each, set epoch & 1 this call's, zero when it
// starts), then the status words ((tiles, kRadix) 64-bit), zero when
// first used and never anything else; pairs: two buffers of N (key, row)
// words, no initial contents.
template <typename KeyT, typename IdxT>
__global__ void __launch_bounds__(kOrderThreads)
    crop_order_kernel(const KeyT* __restrict__ key,
                      const int2* __restrict__ ctr, int N, int kshift,
                      int tbits, int hi, int K, int* __restrict__ skey,
                      IdxT* __restrict__ perm,
                      long long* __restrict__ row_start, unsigned* scratch,
                      unsigned long long* pairs, unsigned epoch) {
  // the block's digit counts in the key pass, then each pass's first slot
  // of each digit
  __shared__ unsigned s_digit[kOrderBins];
  __shared__ unsigned long long s_big[kOrderShared / 2];
  __shared__ unsigned s_part[kDigitGroups][kRadix];  // a digit's warp sums
  __shared__ unsigned s_local[kRadix];  // a digit's first row in the tile
  __shared__ unsigned s_slot[kRadix];   // ... and its first slot
  __shared__ unsigned s_scan[kOrderWarps];
  __shared__ unsigned s_first[kOrderPasses][kOrderWarps];  // step 2's sums
  __shared__ unsigned s_flat;  // the passes whose digit is one value
  unsigned* s_group = reinterpret_cast<unsigned*>(s_big);  // key pass
  unsigned* s_warp = reinterpret_cast<unsigned*>(s_big);  // (warp, digit)
  unsigned long long* s_rows = s_big;  // the tile's rows in digit order
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tiles = (N + kOrderTile - 1) / kOrderTile;
  unsigned* counters = scratch + (epoch & 1) * kOrderCounters;
  unsigned* next = scratch + (~epoch & 1) * kOrderCounters;
  unsigned long long* status =
      reinterpret_cast<unsigned long long*>(scratch + 2 * kOrderCounters);

  // 1. the key pass: every pass's digit counts and the groups' counts
  for (int e = t; e < kOrderBins; e += kOrderThreads) s_digit[e] = 0;
  for (int e = t; e <= K; e += kOrderThreads) s_group[e] = 0;
  if (t == 0) s_flat = 0;
  for (int e = blockIdx.x * kOrderThreads + t; e < kOrderCounters;
       e += gridDim.x * kOrderThreads)
    next[e] = 0;  // the next call's set (the last call's, done)
  __syncthreads();
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kOrderTile + warp * 32 * kOrderItems + lane;
    unsigned k[kOrderItems];
#pragma unroll
    for (int j = 0; j < kOrderItems; ++j)  // every load in flight first
      if (row0 + j * 32 < N)
        k[j] = order_key(key, ctr, row0 + j * 32, kshift, tbits, hi);
#pragma unroll
    for (int j = 0; j < kOrderItems; ++j) {
      const int i = row0 + j * 32;
      const unsigned live = __ballot_sync(0xffffffffu, i < N);
      if (i < N) {
#pragma unroll
        for (int p = 0; p < kOrderPasses; ++p)
          count_digit(s_digit + p * kRadix, order_digit(k[j], p), live, lane);
        if (K) {
          const int g = (int)k[j] >> kshift;
          count_digit(s_group, g < 0 ? 0 : min(g, K - 1) + 1, live, lane);
        }
      }
    }
  }
  __syncthreads();
  for (int e = t; e < kOrderBins; e += kOrderThreads)
    if (s_digit[e]) atomicAdd(counters + e, s_digit[e]);
  for (int e = t; e <= K; e += kOrderThreads)
    if (s_group[e]) atomicAdd(counters + kOrderBins + e, s_group[e]);
  grid_barrier(counters + kOrderBarrier, gridDim.x);

  // 2. each digit's first slot (the four passes' scans at once, digit t
  // on thread t), the passes whose digit varies, row_start
  unsigned c[kOrderPasses], x[kOrderPasses];
#pragma unroll
  for (int p = 0; p < kOrderPasses; ++p) {
    c[p] = t < kRadix ? __ldcg(counters + p * kRadix + t) : 0u;
    if (t < kRadix && c[p] == (unsigned)N) atomicOr(&s_flat, 1u << p);
    x[p] = c[p];
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int p = 0; p < kOrderPasses; ++p) {
      const unsigned y = __shfl_up_sync(0xffffffffu, x[p], o);
      if (lane >= o) x[p] += y;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int p = 0; p < kOrderPasses; ++p) s_first[p][warp] = x[p];
  }
  __syncthreads();
  if (t < kRadix) {
#pragma unroll
    for (int p = 0; p < kOrderPasses; ++p) {
      unsigned below = 0;
      for (int w = 0; w < warp; ++w) below += s_first[p][w];
      s_digit[p * kRadix + t] = below + x[p] - c[p];
    }
  }
  int npass = 0;
  unsigned passes = 0;  // their indices, two bits each
  for (int p = 0; p < kOrderPasses; ++p)
    if (!(s_flat >> p & 1)) passes |= p << (2 * npass++);
  if (!npass) npass = 1;  // one digit value throughout: pass 0 keeps order
  if (K && blockIdx.x == 0) {  // row_start[b] = the rows of groups < b
    unsigned carry = 0;
    for (int b0 = 0; b0 < K; b0 += kOrderThreads) {
      const int b = b0 + t;
      const unsigned c = b < K ? __ldcg(counters + kOrderBins + b) : 0u;
      unsigned total;
      const unsigned below = order_scan(c, s_scan, &total);
      if (b < K) row_start[b] = carry + below + c;
      carry += total;
    }
    if (t == 0) row_start[K] = N;
  }

  // 3. the passes
  const int d = t & (kRadix - 1), h = t / kRadix;  // a digit's thread
  constexpr int kPer = kOrderWarps / kDigitGroups;  // its warps
  for (int q = 0; q < npass; ++q) {
    const int p = passes >> (2 * q) & 3;
    const bool last = q == npass - 1;
    const unsigned long long* src = pairs + (size_t)((q - 1) & 1) * N;
    unsigned long long* dst = pairs + (size_t)(q & 1) * N;
    const unsigned tag = epoch << 2 | q;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row0 = tile * kOrderTile + warp * 32 * kOrderItems + lane;
      unsigned long long pr[kOrderItems];  // (key, row)
#pragma unroll
      for (int j = 0; j < kOrderItems; ++j) {
        const int i = row0 + j * 32;
        if (i < N)
          pr[j] = q == 0 ? (unsigned long long)(unsigned)i << 32 |
                               order_key(key, ctr, i, kshift, tbits, hi)
                         : __ldcg(src + i);  // other blocks wrote it
      }
      for (int e = lane; e < kRadix; e += 32) s_warp[warp * kRadix + e] = 0;
      __syncwarp();
      unsigned rank[kOrderItems];
#pragma unroll
      for (int j = 0; j < kOrderItems; ++j) {
        const int i = row0 + j * 32;
        const unsigned live = __ballot_sync(0xffffffffu, i < N);
        if (i < N) {
          const unsigned dig = order_digit((unsigned)pr[j], p);
          unsigned peers = live;
#pragma unroll
          for (int bit = 0; bit < 8; ++bit) {
            const unsigned ones = __ballot_sync(live, dig >> bit & 1);
            peers &= (dig >> bit & 1) ? ones : ~ones;
          }
          const int leader = __ffs(peers) - 1;
          unsigned before = 0;
          if (lane == leader) {
            before = s_warp[warp * kRadix + dig];
            s_warp[warp * kRadix + dig] = before + __popc(peers);
          }
          rank[j] = __shfl_sync(live, before, leader) +
                    __popc(peers & ((1u << lane) - 1));
        }
        __syncwarp();
      }
      __syncthreads();
      // digit d over warps [h kPer, (h + 1) kPer): each warp's first rank
      // in the digit, then the tile's count of it
      unsigned run = 0;
#pragma unroll
      for (int w = h * kPer; w < (h + 1) * kPer; ++w) {
        const unsigned v = s_warp[w * kRadix + d];
        s_warp[w * kRadix + d] = run;
        run += v;
      }
      s_part[h][d] = run;
      __syncthreads();
      unsigned below = 0, count = 0;
#pragma unroll
      for (int g = 0; g < kDigitGroups; ++g) {
        const unsigned v = s_part[g][d];
        below += g < h ? v : 0u;
        count += v;
      }
      if (h) {
#pragma unroll
        for (int w = h * kPer; w < (h + 1) * kPer; ++w)
          s_warp[w * kRadix + d] += below;
      }
      unsigned long long* st = status + (size_t)tile * kRadix + d;
      if (t < kRadix)
        order_store_status(st, tag, tile ? kAggregate : kInclusive, count);
      unsigned total;
      const unsigned local = order_scan(t < kRadix ? count : 0u, s_scan,
                                        &total);
      if (t < kRadix) {
        unsigned prior = 0;
        if (tile) {
          prior = order_look_back(status, tile, d, tag);
          order_store_status(st, tag, kInclusive, prior + count);
        }
        s_local[d] = local;
        s_slot[d] = s_digit[p * kRadix + d] + prior;
      }
      __syncthreads();
      unsigned at[kOrderItems];  // each row's place in the tile
#pragma unroll
      for (int j = 0; j < kOrderItems; ++j) {
        if (row0 + j * 32 < N) {
          const unsigned dig = order_digit((unsigned)pr[j], p);
          at[j] = s_local[dig] + s_warp[warp * kRadix + dig] + rank[j];
        }
      }
      __syncthreads();  // s_warp's words become s_rows'
#pragma unroll
      for (int j = 0; j < kOrderItems; ++j)
        if (row0 + j * 32 < N) s_rows[at[j]] = pr[j];
      __syncthreads();
      const int rows = min(kOrderTile, N - tile * kOrderTile);
      for (int r = t; r < rows; r += kOrderThreads) {  // runs coalesce
        const unsigned long long v = s_rows[r];
        const unsigned dig = order_digit((unsigned)v, p);
        const unsigned slot = s_slot[dig] + (r - s_local[dig]);
        if (last) {
          skey[slot] = (int)(unsigned)v;
          perm[slot] = (IdxT)(unsigned)(v >> 32);
        } else {
          dst[slot] = v;
        }
      }
      __syncthreads();  // s_big, s_local and s_slot are the next tile's
    }
    if (!last) grid_barrier(counters + kOrderBarrier, gridDim.x * (q + 2));
  }
}

// The tracked kernel: its body (crop_tracked.cuh) with every stage on, its
// keys' group from bit kshift up (tracked_body).
template <int C>
__global__ void __launch_bounds__(kThreads, 2)
    crop_tracked_kernel(const float* __restrict__ map,  // (pixels, CP)
                        const int4* __restrict__ table, int H, int W,
                        const float* __restrict__ scan,  // (C, Th*R)
                        const float* __restrict__ cw,    // (C)
                        const int2* __restrict__ pix,    // (K, P) dy, dx
                        const int* __restrict__ npix,    // (K)
                        const int* __restrict__ order,   // (K*Th*R)
                        const int* __restrict__ seg,     // (K*P + 1)
                        int Th, int R, int P,
                        const int* __restrict__ skey,        // (N)
                        const long long* __restrict__ perm,  // (N)
                        const int2* __restrict__ centers,    // (N) cy, cx
                        int N, float inv_tr, float* __restrict__ out,
                        int kshift) {
  __shared__ Window window;  // the rows' centres and the bucket's extent
  tracked_body<C, kFull>(map, table, H, W, scan, cw, pix, npix, order, seg,
                         Th, R, P, skey, perm, centers, N, inv_tr, out,
                         nullptr, nullptr, nullptr, &window, kshift);
}

// The same body on the code map (pixels, CP/2) with its qinv (8), each
// block's window of codes staged in shared memory where it fits (Window):
// K buckets, the code buffer's pixels, the keys' group shift, the window's
// budget and the launch's dynamic shared memory (tracked_body).
template <int C>
__global__ void __launch_bounds__(kThreads, 2)
    crop_tracked_i4_kernel(const unsigned char* __restrict__ codes,
                           const float* __restrict__ qinv,
                           const int4* __restrict__ table, int H, int W,
                           const float* __restrict__ scan,
                           const float* __restrict__ cw,
                           const int2* __restrict__ pix,
                           const int* __restrict__ npix,
                           const int* __restrict__ order,
                           const int* __restrict__ seg, int Th, int R, int P,
                           const int* __restrict__ skey,
                           const long long* __restrict__ perm,
                           const int2* __restrict__ centers, int N,
                           float inv_tr, float* __restrict__ out, int K,
                           int pixels, int kshift, int budget, int smem) {
  __shared__ Window window;
  tracked_body<C, kFull, true>(codes, table, H, W, scan, cw, pix, npix, order,
                               seg, Th, R, P, skey, perm, centers, N, inv_tr,
                               out, qinv, nullptr, nullptr, &window, kshift,
                               K, pixels, budget, smem);
}

// The same body with the single-plane M: qinv (8) the map quantization's,
// wtab (K*Th, C + 3, P) int16 and scales (K, Th, 4) from
// crop_lokf_weights_kernel; the float map (pixels, CP) or, with I4, the
// code map (pixels, CP/2).
template <int C, bool I4>
__global__ void __launch_bounds__(kThreads, 2)
    crop_tracked_lokf_kernel(const MapElem<I4>* __restrict__ map,
                             const float* __restrict__ qinv,
                             const short* __restrict__ wtab,
                             const float* __restrict__ scales,
                             const int4* __restrict__ table, int H, int W,
                             const int2* __restrict__ pix,
                             const int* __restrict__ npix, int Th, int P,
                             const int* __restrict__ skey,
                             const long long* __restrict__ perm,
                             const int2* __restrict__ centers, int N,
                             float inv_tr, float* __restrict__ out) {
  tracked_body<C, kFull, I4, true>(map, table, H, W, nullptr, nullptr, pix,
                                   npix, nullptr, nullptr, Th, 1, P, skey,
                                   perm, centers, N, inv_tr, out, qinv,
                                   scales, wtab);
}

// -- the weights pass's arithmetic (crop_score.tracked_lokf) --------------
// x rounded to bf16 and back
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A scan cell's coefficient as the JAX package's M build rounds it: the
// cell's value (0.01 w_c scan_c, or the class sum) times the channel's
// qinv in float32, rounded to bf16.
__device__ __forceinline__ float lokf_coef(float v, float q) {
  return bf16r(__fmul_rn(v, q));
}

// round(x / s) half to even, clipped to +-127: an integer of the plane
__device__ __forceinline__ float lokf_q(float x, float s) {
  return fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f);
}

// A column's scale from the amax of its sums: max(amax (1 + 2^-8), 1e-30)
// / 127 (crop_score.lokf_scale)
__device__ __forceinline__ float lokf_scale(float amax) {
  return __fdiv_rn(fmaxf(__fmul_rn(amax, 1.00390625f), 1e-30f), 127.f);
}

// The amax of one pixel's entries in the cost, norm and kf columns (m[0],
// m[1], m[2]), from its per-channel sums y (C classes), yn and yk: the
// entries themselves on the float map; on the code map the e-dot
// identity's pairs, y_even - y_odd / 16 and y_odd / 16, the known channel
// C in its pair with a zero partner.
template <int C, bool I4>
__device__ __forceinline__ void lokf_amax(const float (&y)[C], float yn,
                                          float yk, float (&m)[3]) {
  if constexpr (I4) {
#pragma unroll
    for (int ch = 0; ch < C; ch += 2) {
      const float b = __fmul_rn(ch + 1 < C ? y[ch + 1] : 0.f, 0.0625f);
      m[0] = fmaxf(m[0], fmaxf(fabsf(__fsub_rn(y[ch], b)), fabsf(b)));
    }
    constexpr float kDiv = C % 2 ? 0.0625f : 1.f;  // known channel odd
    m[1] = fmaxf(m[1], fabsf(__fmul_rn(yn, kDiv)));
    m[2] = fmaxf(m[2], fabsf(__fmul_rn(yk, kDiv)));
  } else {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) m[0] = fmaxf(m[0], fabsf(y[ch]));
    m[1] = fmaxf(m[1], fabsf(yn));
    m[2] = fmaxf(m[2], fabsf(yk));
  }
}

// One pixel's integers q (C + 3) under the single-plane M from its
// per-channel sums y (C classes), yn and yk and its group's scales sc =
// (cost, norm, kf, kf residual): each entry rounded to its integer of the
// plane, the kf entry's residual to q_lo in units of sc.w.  On the float
// map they are the plane's own; on the code map they weigh the codes
// themselves: q_e + q_b on an even channel, 16 q_b on an odd one (the known
// channel: its own plane when even, 16 q_b when odd, kf and q_lo alike).
// crop_score.tracked_lokf's integers, in the same float32 operations.
template <int C, bool I4>
__device__ __forceinline__ void lokf_ints(const float (&y)[C], float yn,
                                          float yk, float4 sc,
                                          float (&q)[C + 3]) {
  if constexpr (I4) {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      if (ch % 2 == 0) {
        const float b = __fmul_rn(ch + 1 < C ? y[ch + 1] : 0.f, 0.0625f);
        q[ch] = lokf_q(bf16r(__fsub_rn(y[ch], b)), sc.x) +
                lokf_q(bf16r(b), sc.x);
      } else {
        q[ch] = 16.f * lokf_q(bf16r(__fmul_rn(y[ch], 0.0625f)), sc.x);
      }
    }
    constexpr float kDiv = C % 2 ? 0.0625f : 1.f;
    constexpr float kMul = C % 2 ? 16.f : 1.f;
    q[C] = kMul * lokf_q(bf16r(__fmul_rn(yn, kDiv)), sc.y);
    const float tk = bf16r(__fmul_rn(yk, kDiv));
    const float qk = lokf_q(tk, sc.z);
    q[C + 1] = kMul * qk;
    q[C + 2] = kMul * lokf_q(__fsub_rn(tk, __fmul_rn(qk, sc.z)), sc.w);
  } else {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) q[ch] = lokf_q(bf16r(y[ch]), sc.x);
    q[C] = lokf_q(bf16r(yn), sc.y);
    const float tk = bf16r(yk);
    const float qk = lokf_q(tk, sc.z);
    q[C + 1] = qk;
    q[C + 2] = lokf_q(__fsub_rn(tk, __fmul_rn(qk, sc.z)), sc.w);
  }
}

constexpr int kPassThreads = 512;
constexpr int kLight = 64;  // cells of a pixel one pass thread sums alone

// Shared memory of a weights-pass block: each pixel's float32 sums (C + 1,
// P), the bucket's cells in the CSR's order (Th*R int) and its segment
// starts (P + 1 int), both relative to the bucket, and the coefficients
// (C + 1, Th*R) in bf16 (exact: they are bf16 values).
template <int C>
size_t pass_smem_bytes(int TR, int P) {
  return (size_t)(C + 1) * P * sizeof(float) + (size_t)TR * sizeof(int) +
         (size_t)(P + 1) * sizeof(int) +
         (size_t)(C + 1) * TR * sizeof(__nv_bfloat16);
}

// The weights pass: block (s, b) takes group b Th + s.  It stages the
// bucket's coefficients (lokf_coef: 0.01 w_c scan_c and the class sum
// times qinv of the channel, in bf16), its cells and its segment starts,
// then folds every distinct pixel (and the padding up to 8, whose empty
// cells give zeros): the coefficients of its cells at scan cell (i + s R)
// mod Th R summed in float64, rounded once to float32 and kept in shared
// memory.  Thread t owns pixels t, t + kPassThreads, ...: it sums one of
// at most kLight cells alone; a heavier one (the stencil's centre: 100-220
// cells at the crop buckets) its warp sums, the lanes over the cells and a
// butterfly over the lanes (float64 sums of bf16 values are exact, so
// both give the sequential sum's bits).  Then the amax of each column
// (lokf_amax) over the block, one barrier, each thread reducing the warps'
// maxima to the same four scales (lokf_scale; the residual's s_kf / 254),
// and each owner its pixels' C + 3 integers (lokf_ints) into wtab[b Th +
// s] (C + 3, P), the scales into scales[b, s].  No atomics: every sum and
// max in a fixed order.
//
// Bound: the table it writes ((C + 3) 2 bytes per pixel and shift; 1.9 MB,
// 0.6 us at HBM rate at K = 1, C = 3, Th = 100, 1,577 pixels) more than
// its (C + 1) float64 adds per cell and shift.  What it takes is latency:
// the staging, then the longest pixel's sums (hence the warps on the heavy
// pixels) and one barrier.  One group a block measured faster than blocks
// of several shifts that stage once for them (more blocks hide each
// other's latency), and than reading the scan and the CSR unstaged
// (tests/time_torch_lokf_pass.py times kLight's and kPassThreads' choices).
template <int C, bool I4>
__global__ void __launch_bounds__(kPassThreads, 2)
    crop_lokf_weights_kernel(const float* __restrict__ scan,
                             const float* __restrict__ cw,
                             const float* __restrict__ qinv,
                             const int* __restrict__ npix,
                             const int* __restrict__ order,
                             const int* __restrict__ seg, int Th, int R,
                             int P, short* __restrict__ wtab,
                             float* __restrict__ scales) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_max[kPassThreads / 32][3];
  const int s = blockIdx.x, b = blockIdx.y;
  const int TR = Th * R, cell0 = b * TR, sR = s * R;
  float* s_sum = reinterpret_cast<float*>(smem);
  int* s_cell = reinterpret_cast<int*>(s_sum + (size_t)(C + 1) * P);
  int* s_seg = s_cell + TR;
  __nv_bfloat16* s_coef = reinterpret_cast<__nv_bfloat16*>(s_seg + P + 1);
  float wq[C + 1], cwc[C];
#pragma unroll
  for (int ch = 0; ch <= C; ++ch) wq[ch] = __ldg(qinv + ch);
#pragma unroll
  for (int ch = 0; ch < C; ++ch) cwc[ch] = 0.01f * __ldg(cw + ch);
  const float kf_coef = lokf_coef(1.f, wq[C]);
  const int u8 = min((npix[b] + 7) & ~7, P);
  for (int i = threadIdx.x; i < TR; i += kPassThreads) {
    float sum = 0.f;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const float v = __ldg(scan + ch * TR + i);
      s_coef[ch * TR + i] =
          __float2bfloat16_rn(lokf_coef(__fmul_rn(v, cwc[ch]), wq[ch]));
      sum = ch ? sum + v : v;
    }
    s_coef[C * TR + i] = __float2bfloat16_rn(lokf_coef(sum, wq[C]));
    s_cell[i] = __ldg(order + cell0 + i) - cell0;
  }
  for (int u = threadIdx.x; u <= u8; u += kPassThreads)
    s_seg[u] = __ldg(seg + (size_t)b * P + u) - cell0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the float64 sums of one pixel's cells q0, q0 + step, ... below hi
  auto sums = [&](int q0, int hi, int step, double (&wc)[C], double& wn) {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) wc[ch] = 0.0;
    wn = 0.0;
    for (int q = q0; q < hi; q += step) {
      int j = s_cell[q] + sR;
      if (j >= TR) j -= TR;
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        wc[ch] += (double)__bfloat162float(s_coef[ch * TR + j]);
      wn += (double)__bfloat162float(s_coef[C * TR + j]);
    }
  };
  // pixel u's kf entry: its count of cells times the kf cell's coefficient
  auto kf_sum = [&](int u) {
    return __double2float_rn((double)(s_seg[u + 1] - s_seg[u]) * kf_coef);
  };
  // pixel u's sums rounded once to float32, kept, and taken into the amax
  auto keep = [&](int u, const double (&wc)[C], double wn, float (&m)[3]) {
    float y[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      y[ch] = __double2float_rn(wc[ch]);
      s_sum[ch * P + u] = y[ch];
    }
    const float yn = __double2float_rn(wn);
    s_sum[C * P + u] = yn;
    lokf_amax<C, I4>(y, yn, kf_sum(u), m);
  };
  float m[3] = {0.f, 0.f, 0.f};
  for (int base = warp * 32; base < u8; base += kPassThreads) {
    const int u = base + lane;
    const int lo = u < u8 ? s_seg[u] : 0, hi = u < u8 ? s_seg[u + 1] : 0;
    double wc[C], wn;
    if (hi - lo <= kLight) {
      sums(lo, hi, 1, wc, wn);
      if (u < u8) keep(u, wc, wn, m);
    }
    for (unsigned heavy = __ballot_sync(0xffffffffu, hi - lo > kLight);
         heavy; heavy &= heavy - 1) {
      const int v = __ffs(heavy) - 1;  // the owner's lane
      sums(__shfl_sync(0xffffffffu, lo, v) + lane,
           __shfl_sync(0xffffffffu, hi, v), 32, wc, wn);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int ch = 0; ch < C; ++ch)
          wc[ch] += __shfl_xor_sync(0xffffffffu, wc[ch], o);
        wn += __shfl_xor_sync(0xffffffffu, wn, o);
      }
      if (lane == v) keep(u, wc, wn, m);
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m[k] = fmaxf(m[k], __shfl_xor_sync(0xffffffffu, m[k], o));
    if (lane == 0) s_max[warp][k] = m[k];
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kPassThreads / 32; ++w)
#pragma unroll
    for (int k = 0; k < 3; ++k) m[k] = fmaxf(m[k], s_max[w][k]);
  float4 sc;
  sc.x = lokf_scale(m[0]);
  sc.y = lokf_scale(m[1]);
  sc.z = lokf_scale(m[2]);
  sc.w = __fdiv_rn(sc.z, 254.f);
  const int g = b * Th + s;
  if (threadIdx.x == 0) reinterpret_cast<float4*>(scales)[g] = sc;
  short* wg = wtab + (size_t)g * (C + 3) * P;
  for (int u = threadIdx.x; u < u8; u += kPassThreads) {
    float y[C], q[C + 3];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) y[ch] = s_sum[ch * P + u];
    lokf_ints<C, I4>(y, s_sum[C * P + u], kf_sum(u), sc, q);
#pragma unroll
    for (int e = 0; e < C + 3; ++e) wg[(size_t)e * P + u] = (short)q[e];
  }
}

// Exclusive prefix sum of one int a thread over a block of kFoldThreads,
// with one barrier: every warp scans the warp totals itself.  *total gets
// the block's sum.  Every thread must call it, and s_warp must not be
// written again before the next barrier.
__device__ __forceinline__ int block_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int w = lane < kFoldWarps ? s_warp[lane] : 0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, w, o);
    if (lane >= o) w += y;
  }
  *total = __shfl_sync(0xffffffffu, w, 31);
  return __shfl_sync(0xffffffffu, w, warp) - s_warp[warp] + x - v;
}

// Block b folds offset table b (off (K, Th*R) int2).  Writes pix (K, P)
// (PAD_PIX after the table's npix[b] pixels), npix (K), order (K*Th*R, the
// flat cells b*Th*R + i by pixel, then cell) and seg (K*P + 1): what
// crop_score.fold_offsets returns, bit for bit.
//
// What bounds it: not bytes (~60 KB at Th*R = 2,500, 0.00002 ms at HBM
// rate) but latency.  One block on one SM walks a chain of steps, each
// ended by a barrier, and its 32 warps share the SM's four schedulers, so
// every step costs a few hundred cycles even where it does little work.
// The design keeps the chain short: 2 + 4 barriers a radix pass (10 at
// the crop stencils' 12-bit boxes), where the bitonic sort of 64-bit (dy,
// dx, cell) keys before it took ~90; and its loops run over the cells a
// warp has, not unrolled over the largest table.
//   1. One block reduction finds the table's box [ymin, ymax] x [xmin,
//      xmax]; a cell's key is its row-major index in the box, (dy - ymin)
//      bw + (dx - xmin), in the order of (dy, dx), with only
//      ceil(log2(box)) bits: 12 at the crop buckets' mo <= 24, up to 44 at
//      offsets of 2^21.
//   2. A stable LSD radix sort of the cell indices by that key, in shared
//      memory, the digits spread evenly over ceil(bits / 8) passes (none
//      when every cell lies on one pixel).  A pass: each warp ranks its
//      own run of cells, 32 at a time, against its own row of counts (no
//      atomics), the lanes of one digit found by one ballot a digit bit
//      (__match_any_sync was slower); one block scan over (digit, warp)
//      turns the counts into each warp's first slot for each digit; each
//      cell goes to its slot in the other buffer.  Cells enter in
//      increasing order and every pass is stable, so each pixel's cells
//      come out in increasing order: the CSR needs nothing more.  The
//      offsets are re-read through the read-only cache rather than moved.
//   3. One block scan numbers the distinct pixels (each thread takes a
//      run of sorted cells), then the writes.
__global__ void __launch_bounds__(kFoldThreads)
    crop_fold_kernel(const int2* __restrict__ off, int K, int TR, int P,
                     int2* __restrict__ pix, int* __restrict__ npix,
                     int* __restrict__ order, int* __restrict__ seg) {
  extern __shared__ __align__(16) int s_fold[];
  int* s_src = s_fold;          // (TR) cells in the current order
  int* s_dst = s_fold + TR;     // (TR) cells in the next
  int* s_rank = s_fold + 2 * TR;  // (TR) warp rank << kDigitBits | digit
  int* s_hist = s_fold + 3 * TR;  // (warp, digit) at warp * (nb + 1) + digit
  __shared__ int4 s_box[kFoldWarps];
  __shared__ int s_warp[kFoldWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const int2* o = off + (size_t)b * TR;

  // 1. the box: (ymin, ymax, xmin, xmax)
  const int4 none = make_int4(INT_MAX, INT_MIN, INT_MAX, INT_MIN);
  int4 box = none;
  for (int i = threadIdx.x; i < TR; i += kFoldThreads) {
    const int2 d = __ldg(o + i);
    box = make_int4(min(box.x, d.x), max(box.y, d.x), min(box.z, d.y),
                    max(box.w, d.y));
  }
  box = make_int4(__reduce_min_sync(0xffffffffu, box.x),
                  __reduce_max_sync(0xffffffffu, box.y),
                  __reduce_min_sync(0xffffffffu, box.z),
                  __reduce_max_sync(0xffffffffu, box.w));
  if (lane == 0) s_box[warp] = box;
  __syncthreads();
  box = lane < kFoldWarps ? s_box[lane] : none;
  const int ymin = __reduce_min_sync(0xffffffffu, box.x);
  const int xmin = __reduce_min_sync(0xffffffffu, box.z);
  const unsigned long long bw =
      (unsigned long long)(__reduce_max_sync(0xffffffffu, box.w) - xmin) + 1;
  const unsigned long long area =
      ((unsigned long long)(__reduce_max_sync(0xffffffffu, box.y) - ymin) +
       1) * bw;
  const int bits = area > 1 ? 64 - __clzll(area - 1) : 0;
  const int passes = (bits + kDigitBits - 1) / kDigitBits;
  const int dbits = passes ? (bits + passes - 1) / passes : 0;
  const int nb = 1 << dbits;  // bins of a digit
  const unsigned mask = nb - 1;
  // warp w ranks cells [w nch 32, (w + 1) nch 32) of the current order
  const int nch = (TR + kFoldThreads - 1) / kFoldThreads;
  const int w0 = warp * nch * 32, w1 = min(w0 + nch * 32, TR);
  int* hist = s_hist + warp * (nb + 1);

  // 2. the radix passes
  for (int p = 0, shift = 0; p < passes; ++p, shift += dbits) {
    for (int d = lane; d < nb; d += 32) hist[d] = 0;
    __syncwarp();
    for (int c0 = w0; c0 < w1; c0 += 32) {  // a chunk of 32 cells
      const int i = c0 + lane;
      const unsigned live = __ballot_sync(0xffffffffu, i < w1);
      if (i < w1) {
        const int2 d = __ldg(o + (p ? s_src[i] : i));
        const unsigned long long key =
            (unsigned long long)(d.x - ymin) * bw + (unsigned)(d.y - xmin);
        const int dig = (int)((key >> shift) & mask);
        unsigned peers = live;
        for (int bit = 0; bit < dbits; ++bit) {
          const unsigned ones = __ballot_sync(live, dig >> bit & 1);
          peers &= (dig >> bit & 1) ? ones : ~ones;
        }
        const int leader = __ffs(peers) - 1;
        int before = 0;
        if (lane == leader) {
          before = hist[dig];
          hist[dig] = before + __popc(peers);
        }
        before = __shfl_sync(live, before, leader) +
                 __popc(peers & ((1u << lane) - 1));
        s_rank[i] = before << kDigitBits | dig;
      }
      __syncwarp();
    }
    __syncthreads();
    // counts -> first slots, in (digit, warp) order: thread t takes
    // entries [t per, (t + 1) per)
    const int n = nb * kFoldWarps;
    const int per = (n + kFoldThreads - 1) / kFoldThreads;
    int sum = 0;
    for (int q = 0; q < per; ++q) {
      const int e = threadIdx.x * per + q;
      if (e < n) sum += s_hist[(e % kFoldWarps) * (nb + 1) + e / kFoldWarps];
    }
    int total;
    int run = block_scan(sum, s_warp, &total);
    for (int q = 0; q < per; ++q) {
      const int e = threadIdx.x * per + q;
      if (e < n) {
        int* h = s_hist + (e % kFoldWarps) * (nb + 1) + e / kFoldWarps;
        const int c = *h;
        *h = run;
        run += c;
      }
    }
    __syncthreads();
    for (int i = w0 + lane; i < w1; i += 32) {
      const int r = s_rank[i];
      s_dst[hist[r & (kBins - 1)] + (r >> kDigitBits)] = p ? s_src[i] : i;
    }
    int* t = s_src;
    s_src = s_dst;
    s_dst = t;
    __syncthreads();
  }

  // 3. number the distinct pixels: thread t takes sorted cells [t nch,
  // (t + 1) nch)
  const int i0 = min((int)threadIdx.x * nch, TR), i1 = min(i0 + nch, TR);
  unsigned long long fresh = 0;
  int nfresh = 0;
  int2 prev = make_int2(kPad, kPad);  // no offset reaches it
  if (i0 > 0 && i0 < i1)
    prev = __ldg(o + (passes ? s_src[i0 - 1] : i0 - 1));
  for (int i = i0; i < i1; ++i) {
    const int2 d = __ldg(o + (passes ? s_src[i] : i));
    if (d.x != prev.x || d.y != prev.y) {
      fresh |= 1ull << (i - i0);
      ++nfresh;
    }
    prev = d;
  }
  int count;
  int u = block_scan(nfresh, s_warp, &count);
  const int base = b * TR;
  for (int i = i0; i < i1; ++i) {
    if (fresh >> (i - i0) & 1) {
      pix[(size_t)b * P + u] = __ldg(o + (passes ? s_src[i] : i));
      seg[(size_t)b * P + u] = base + i;
      ++u;
    }
  }
  for (int i = threadIdx.x; i < TR; i += kFoldThreads)
    order[base + i] = base + (passes ? s_src[i] : i);
  for (int v = count + threadIdx.x; v < P; v += kFoldThreads) {
    pix[(size_t)b * P + v] = make_int2(kPad, kPad);
    seg[(size_t)b * P + v] = base + TR;
  }
  if (threadIdx.x == 0) {
    npix[b] = count;
    if (b == K - 1) seg[(size_t)K * P] = K * TR;
  }
}

// Dynamic shared memory of a code kernel block that stages windows: up to
// kTwoBlockSmem where the block's layout at stride P fits it (two blocks an
// SM, each beside its static Window and the 1 KB the SM reserves a block),
// else up to kOneBlockSmem (crop_score.TRACKED_SMEM_TWO, _ONE).
constexpr size_t kTwoBlockSmem = 111 * 1024;
constexpr size_t kOneBlockSmem = 225 * 1024;

// The code kernel's launch: the layout at stride P (its tight layout fits
// in it whatever the fold's npix), and with a budget the bytes up to its
// occupancy's share for the window (crop_score.tracked_launch_smem).
template <int C>
size_t window_smem(int TR, int P, int budget) {
  const size_t fixed = smem_bytes<C>(TR, P);
  if (budget <= 0) return fixed;
  const size_t lim = fixed <= kTwoBlockSmem ? kTwoBlockSmem : kOneBlockSmem;
  return std::max(fixed, std::min(fixed + (size_t)budget, lim));
}

// Launch the tracked kernel on the float map (qinv null) or, with I4, on
// the code map and its qinv (K buckets, the buffer's pixels and the
// window's budget: crop_tracked_i4_kernel); kshift: the keys' group shift.
template <int C, bool I4>
cudaError_t launch(const void* map, const float* qinv, const int* table,
                   int H, int W, const float* scan, const float* cw,
                   const int* pix, const int* npix, const int* order,
                   const int* seg, int Th, int R, int P, const int* skey,
                   const long long* perm, const int* centers, int N,
                   float inv_tr, float* out, cudaStream_t stream, int K = 1,
                   int pixels = 0, int kshift = 0, int budget = 0) {
  // the smem opt-in, set once per device and raised with the table size;
  // callers launch from one host thread
  static int ready_dev = -1;
  static size_t ready_smem = 0;
  const size_t smem = I4 ? window_smem<C>(Th * R, P, budget)
                         : smem_bytes<C>(Th * R, P);
  const dim3 grid((N + kTile - 1) / kTile);
  const auto* tbl = reinterpret_cast<const int4*>(table);
  const auto* px = reinterpret_cast<const int2*>(pix);
  const auto* ctr = reinterpret_cast<const int2*>(centers);
  cudaError_t err;
  if constexpr (I4) {
    auto kern = crop_tracked_i4_kernel<C>;
    err = opt_in_smem(kern, smem, &ready_dev, &ready_smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const unsigned char*>(map), qinv, tbl, H, W, scan, cw, px,
        npix, order, seg, Th, R, P, skey, perm, ctr, N, inv_tr, out, K,
        pixels, kshift, budget, (int)smem);
  } else {
    auto kern = crop_tracked_kernel<C>;
    err = opt_in_smem(kern, smem, &ready_dev, &ready_smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(map), tbl, H, W, scan, cw, px, npix, order,
        seg, Th, R, P, skey, perm, ctr, N, inv_tr, out, kshift);
  }
  return cudaGetLastError();
}

// Launch the single-plane tracked kernel.
template <int C, bool I4>
cudaError_t launch_lokf(const void* map, const float* qinv, const short* wtab,
                        const float* scales, const int* table, int H, int W,
                        const int* pix, const int* npix, int Th, int P,
                        const int* skey, const long long* perm,
                        const int* centers, int N, float inv_tr, float* out,
                        cudaStream_t stream) {
  static int ready_dev = -1;
  static size_t ready_smem = 0;
  const size_t smem = lokf_smem_bytes<C>(P);
  auto kern = crop_tracked_lokf_kernel<C, I4>;
  const cudaError_t err = opt_in_smem(kern, smem, &ready_dev, &ready_smem);
  if (err != cudaSuccess) return err;
  kern<<<(N + kTile - 1) / kTile, kThreads, smem, stream>>>(
      static_cast<const MapElem<I4>*>(map), qinv, wtab, scales,
      reinterpret_cast<const int4*>(table), H, W,
      reinterpret_cast<const int2*>(pix), npix, Th, P, skey, perm,
      reinterpret_cast<const int2*>(centers), N, inv_tr, out);
  return cudaGetLastError();
}

// Launch the weights pass: one block a (shift, bucket).
template <int C, bool I4>
cudaError_t launch_pass(const float* scan, const float* cw, const float* qinv,
                        const int* npix, const int* order, const int* seg,
                        int K, int Th, int R, int P, short* wtab,
                        float* scales, cudaStream_t stream) {
  static int ready_dev = -1;
  static size_t ready_smem = 0;
  const size_t smem = pass_smem_bytes<C>(Th * R, P);
  auto kern = crop_lokf_weights_kernel<C, I4>;
  const cudaError_t err = opt_in_smem(kern, smem, &ready_dev, &ready_smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(Th, K), kPassThreads, smem, stream>>>(
      scan, cw, qinv, npix, order, seg, Th, R, P, wtab, scales);
  return cudaGetLastError();
}

// f(std::integral_constant<int, C>) for the class count C in 1..7.
template <typename F>
int by_classes(int C, F&& f) {
  switch (C) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each returns the CUDA error of
// its launch (0 on success); none allocates or synchronises.

// off (K, Th*R) int2 offset tables, TR = Th*R <= kFoldCells = 16,384 (the
// bitonic kernel before it took as many, its 64-bit keys filling 128 KB of
// shared memory), offsets |d| < 2^21, P >= TR; out holds
// pix (K, P) int2, seg (K*P + 1), order (K*Th*R) and npix (K), int32, back
// to back.
extern "C" int tdr_crop_fold(const int* off, int K, int TR, int P, int* out,
                             void* stream) {
  static int ready_dev = -1;
  static size_t ready_smem = 0;
  if (K < 1 || TR < 1 || TR > kFoldCells || P < TR)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)TR * 3 * sizeof(int) + kHistBytes;
  const cudaError_t err =
      opt_in_smem(crop_fold_kernel, smem, &ready_dev, &ready_smem);
  if (err != cudaSuccess) return (int)err;
  int2* pix = reinterpret_cast<int2*>(out);
  int* seg = out + (size_t)2 * K * P;
  int* order = seg + (size_t)K * P + 1;
  int* npix = order + (size_t)K * TR;
  crop_fold_kernel<<<K, kFoldThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int2*>(off), K, TR, P, pix, npix, order, seg);
  return (int)cudaGetLastError();
}

namespace {

// The row order, one cooperative launch of crop_order_kernel<KeyT, IdxT>
// over as many blocks as the card holds at once (asked once a device), at
// most one a tile.
template <typename KeyT, typename IdxT>
int launch_order(const void* key, const int* ctr, int N, int kshift,
                 int tbits, int hi, int K, int* skey, void* perm,
                 long long* row_start, unsigned* scratch, void* pairs,
                 unsigned epoch, cudaStream_t stream) {
  static int ready_dev = -1, resident = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != ready_dev) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, crop_order_kernel<KeyT, IdxT>, kOrderThreads, 0);
    if (err != cudaSuccess) return (int)err;
    resident = sms * per_sm;
    ready_dev = dev;
  }
  const int tiles = (N + kOrderTile - 1) / kOrderTile;
  const int grid = std::min(std::max(tiles, 1), resident);
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const KeyT* k = static_cast<const KeyT*>(key);
  const int2* c = reinterpret_cast<const int2*>(ctr);
  IdxT* pm = static_cast<IdxT*>(perm);
  unsigned long long* pr = static_cast<unsigned long long*>(pairs);
  void* args[] = {(void*)&k, (void*)&c, &N,         &kshift,
                  &tbits,    &hi,       &K,         &skey,
                  &pm,       &row_start, &scratch,  &pr,
                  &epoch};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(crop_order_kernel<KeyT, IdxT>),
      dim3(grid), dim3(kOrderThreads), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The row order (crop_score.order_rows).  key (N) group keys of key_bytes
// 4 (int32) or 8 (int64); ctr (N) int2 centres (cy, cx), read only where
// kshift > 0 (null allowed at 0); kshift and tbits as
// crop_score.order_bits gives them (kshift even, <= 30; the tiles fit 15
// bits), hi = 2^(kshift / 2 + tbits) - 1; K groups of row_start (0: none,
// row_start null; at most kMaxStartGroups).  Writes skey (N) int32, perm
// (N) of perm_bytes 4 (int32) or 8 (int64) and row_start (K + 1) int64.
// scratch: scratch_words 32-bit words (crop_score.order_scratch_words(N)
// or more) that hold nothing but this kernel's counters and status words,
// zero when first used; pairs: 2 N 8-byte words, 8-byte aligned; epoch in
// [1, 2^28), each call on the scratch the next (a call whose launch
// failed leaves it unused).
extern "C" int tdr_crop_order(const void* key, int key_bytes, const int* ctr,
                              int N, int kshift, int tbits, int hi, int K,
                              int* skey, void* perm, int perm_bytes,
                              long long* row_start, unsigned* scratch,
                              long long scratch_words, void* pairs,
                              unsigned epoch, void* stream) {
  const long long tiles = ((long long)N + kOrderTile - 1) / kOrderTile;
  if (N < 0 || N > (1 << 30) || (N && (!key || !skey || !perm || !pairs)) ||
      (key_bytes != 4 && key_bytes != 8) ||
      (perm_bytes != 4 && perm_bytes != 8) || kshift < 0 || kshift > 30 ||
      (kshift && N && !ctr) || tbits < 0 || tbits > 30 || hi < 0 ||
      (hi >> tbits) >= (1 << 16) || K < 0 || K > kMaxStartGroups ||
      (K && !row_start) || !scratch || epoch == 0 || epoch >= (1u << 28) ||
      scratch_words < 2LL * kOrderCounters + 2 * tiles * kRadix ||
      reinterpret_cast<uintptr_t>(pairs) % 8)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_bytes == 4 && perm_bytes == 4)
    return launch_order<int, int>(key, ctr, N, kshift, tbits, hi, K, skey,
                                  perm, row_start, scratch, pairs, epoch, s);
  if (key_bytes == 4)
    return launch_order<int, long long>(key, ctr, N, kshift, tbits, hi, K,
                                        skey, perm, row_start, scratch,
                                        pairs, epoch, s);
  if (perm_bytes == 4)
    return launch_order<long long, int>(key, ctr, N, kshift, tbits, hi, K,
                                        skey, perm, row_start, scratch,
                                        pairs, epoch, s);
  return launch_order<long long, long long>(key, ctr, N, kshift, tbits, hi,
                                            K, skey, perm, row_start,
                                            scratch, pairs, epoch, s);
}

// map: the compact (H, W, CP) map; scan (C, Th, R) and cw (C): the scan
// and the class weights; pix, npix, order, seg, P: tdr_crop_fold's output;
// skey (N) int32, perm (N) int64: the particles' sorted keys, each row's
// group (shift at one scale) in its bits from kshift (0..30) up and its
// place in the group's position order below (crop_score.tracked_order;
// kshift 0: the group keys sorted stably, tracked_rows), and the sort's
// permutation; centers (N) int2 (cy, cx); out (N, 3).  The rows' order
// changes no bit of any particle's output.
extern "C" int tdr_crop_score_tracked(
    const float* map, int H, int W, int C, const float* scan,
    const float* cw, const int* pix, const int* npix, const int* order,
    const int* seg, int Th, int R, int P, const int* skey,
    const long long* perm, const int* centers, int N, float inv_tr,
    float* out, int kshift, void* stream) {
  if (kshift < 0 || kshift > 30) return (int)cudaErrorInvalidValue;
  return by_classes(C, [&](auto cc) {
    return (int)launch<decltype(cc)::value, false>(
        map, nullptr, nullptr, H, W, scan, cw, pix, npix, order, seg, Th, R,
        P, skey, perm, centers, N, inv_tr, out,
        static_cast<cudaStream_t>(stream), 1, 0, kshift);
  });
}

// K buckets: compact pyramid (pixels, CP) with table (K, 4) of (pixel
// offset, H, W, -) per bucket; the keys' groups are bucket * Th + shift.
extern "C" int tdr_crop_score_multi_tracked(
    const float* pyramid, const int* table, int K, int C, const float* scan,
    const float* cw, const int* pix, const int* npix, const int* order,
    const int* seg, int Th, int R, int P, const int* skey,
    const long long* perm, const int* centers, int N, float inv_tr,
    float* out, int kshift, void* stream) {
  if (K < 1 || K > kMaxBuckets || kshift < 0 || kshift > 30)
    return (int)cudaErrorInvalidValue;
  return by_classes(C, [&](auto cc) {
    return (int)launch<decltype(cc)::value, false>(
        pyramid, nullptr, table, 0, 0, scan, cw, pix, npix, order, seg, Th, R,
        P, skey, perm, centers, N, inv_tr, out,
        static_cast<cudaStream_t>(stream), K, 0, kshift);
  });
}

namespace {

// The code entry points' launch: the codes' base 16-byte aligned where a
// window may be staged (its rows are copied from 16-byte boundaries),
// kshift in 0..30.
int tracked_i4(const unsigned char* codes, const float* qinv,
               const int* table, int K, int H, int W, int pixels, int C,
               const float* scan, const float* cw, const int* pix,
               const int* npix, const int* order, const int* seg, int Th,
               int R, int P, const int* skey, const long long* perm,
               const int* centers, int N, float inv_tr, float* out,
               int kshift, int budget, void* stream) {
  if (K < 1 || K > kMaxBuckets || kshift < 0 || kshift > 30 || pixels < 0 ||
      (budget > 0 && reinterpret_cast<uintptr_t>(codes) % 16))
    return (int)cudaErrorInvalidValue;
  return by_classes(C, [&](auto cc) {
    return (int)launch<decltype(cc)::value, true>(
        codes, qinv, table, H, W, scan, cw, pix, npix, order, seg, Th, R, P,
        skey, perm, centers, N, inv_tr, out,
        static_cast<cudaStream_t>(stream), K, pixels, kshift, budget);
  });
}

}  // namespace

// The nibble-packed map: codes (pixels, CP/2) uint8 and qinv (8) float32 in
// place of the compact map, everything else as tdr_crop_score_tracked but
// the keys and two arguments after out: skey holds each row's group in its
// bits from kshift up (crop_score.tracked_order), and budget is the most
// bytes of shared memory a block's window of codes may take (0: no block
// stages one; a 16-byte aligned code map where it is not 0).
extern "C" int tdr_crop_score_tracked_i4(
    const unsigned char* codes, const float* qinv, int H, int W, int C,
    const float* scan, const float* cw, const int* pix, const int* npix,
    const int* order, const int* seg, int Th, int R, int P, const int* skey,
    const long long* perm, const int* centers, int N, float inv_tr,
    float* out, int kshift, int budget, void* stream) {
  return tracked_i4(codes, qinv, nullptr, 1, H, W, H * W, C, scan, cw, pix,
                    npix, order, seg, Th, R, P, skey, perm, centers, N,
                    inv_tr, out, kshift, budget, stream);
}

// ... and as tdr_crop_score_multi_tracked on the code pyramid of `pixels`
// pixels.
extern "C" int tdr_crop_score_multi_tracked_i4(
    const unsigned char* codes, const float* qinv, const int* table, int K,
    int pixels, int C, const float* scan, const float* cw, const int* pix,
    const int* npix, const int* order, const int* seg, int Th, int R, int P,
    const int* skey, const long long* perm, const int* centers, int N,
    float inv_tr, float* out, int kshift, int budget, void* stream) {
  return tracked_i4(codes, qinv, table, K, 0, 0, pixels, C, scan, cw, pix,
                    npix, order, seg, Th, R, P, skey, perm, centers, N,
                    inv_tr, out, kshift, budget, stream);
}

// The single-plane M (TDR_M_HILO=0).  tdr_crop_lokf_weights: the weights
// pass, from the scan (C, Th, R), the class weights, qinv (8) of the map
// quantization, I4 (the code map's table: 0 or 1) and tdr_crop_fold's
// npix, order, seg and P (a multiple of 8), into wtab (K*Th, C + 3, P)
// int16 (each group's first npix[b] entries of a row rounded up to 8
// written, the rest not) and scales (K, Th, 4).  The tracked entry points
// then take the map (or codes), qinv, wtab and scales, then H, W (or the
// table and K), C, pix, npix, Th, P, the sorted keys, perm, centers, N,
// inv_tr and out.
extern "C" int tdr_crop_lokf_weights(const float* scan, const float* cw,
                                     const float* qinv, int C, int I4,
                                     const int* npix, const int* order,
                                     const int* seg, int K, int Th, int R,
                                     int P, short* wtab, float* scales,
                                     void* stream) {
  if (K < 1 || K > kMaxBuckets || Th < 1 || R < 1 || P % 8 || P < Th * R)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  return by_classes(C, [&](auto cc) {
    constexpr int kC = decltype(cc)::value;
    return (int)(I4 ? launch_pass<kC, true>(scan, cw, qinv, npix, order, seg,
                                            K, Th, R, P, wtab, scales, st)
                    : launch_pass<kC, false>(scan, cw, qinv, npix, order,
                                             seg, K, Th, R, P, wtab, scales,
                                             st));
  });
}

namespace {

// The single-plane tracked entry points' launch, uniform (table null) and
// K-bucket.
template <bool I4>
int tracked_lokf(const void* map, const float* qinv, const short* wtab,
                 const float* scales, const int* table, int K, int H, int W,
                 int C, const int* pix, const int* npix, int Th, int P,
                 const int* skey, const long long* perm, const int* centers,
                 int N, float inv_tr, float* out, void* stream) {
  if (K < 1 || K > kMaxBuckets || P % 8) return (int)cudaErrorInvalidValue;
  return by_classes(C, [&](auto cc) {
    return (int)launch_lokf<decltype(cc)::value, I4>(
        map, qinv, wtab, scales, table, H, W, pix, npix, Th, P, skey, perm,
        centers, N, inv_tr, out, static_cast<cudaStream_t>(stream));
  });
}

}  // namespace

extern "C" int tdr_crop_score_tracked_lokf(
    const float* map, const float* qinv, const short* wtab,
    const float* scales, int H, int W, int C, const int* pix,
    const int* npix, int Th, int P, const int* skey, const long long* perm,
    const int* centers, int N, float inv_tr, float* out, void* stream) {
  return tracked_lokf<false>(map, qinv, wtab, scales, nullptr, 1, H, W, C,
                             pix, npix, Th, P, skey, perm, centers, N, inv_tr,
                             out, stream);
}

extern "C" int tdr_crop_score_multi_tracked_lokf(
    const float* pyramid, const float* qinv, const short* wtab,
    const float* scales, const int* table, int K, int C, const int* pix,
    const int* npix, int Th, int P, const int* skey, const long long* perm,
    const int* centers, int N, float inv_tr, float* out, void* stream) {
  return tracked_lokf<false>(pyramid, qinv, wtab, scales, table, K, 0, 0, C,
                             pix, npix, Th, P, skey, perm, centers, N, inv_tr,
                             out, stream);
}

extern "C" int tdr_crop_score_tracked_i4_lokf(
    const unsigned char* codes, const float* qinv, const short* wtab,
    const float* scales, int H, int W, int C, const int* pix,
    const int* npix, int Th, int P, const int* skey, const long long* perm,
    const int* centers, int N, float inv_tr, float* out, void* stream) {
  return tracked_lokf<true>(codes, qinv, wtab, scales, nullptr, 1, H, W, C,
                            pix, npix, Th, P, skey, perm, centers, N, inv_tr,
                            out, stream);
}

extern "C" int tdr_crop_score_multi_tracked_i4_lokf(
    const unsigned char* codes, const float* qinv, const short* wtab,
    const float* scales, const int* table, int K, int C, const int* pix,
    const int* npix, int Th, int P, const int* skey, const long long* perm,
    const int* centers, int N, float inv_tr, float* out, void* stream) {
  return tracked_lokf<true>(codes, qinv, wtab, scales, table, K, 0, 0, C,
                            pix, npix, Th, P, skey, perm, centers, N, inv_tr,
                            out, stream);
}
