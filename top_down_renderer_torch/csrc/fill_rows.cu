// Forward fill of resampled particle rows, for Hopper (sm_90a).
//
// Replaces: top_down_renderer_tpu/filter/resample.py::_fill_kernel (launched
// by _fill_rows), the fill behind TDR_RESAMPLE=pallas.  Given rows0 (N, 8)
// float32 and valid0 (N,) bool with slot 0 valid, it writes
//
//   out[i] = rows0[max{j <= i : valid0[j]}]
//
// (row 0 where no slot up to i is valid, as when slot 0 is pinned).  The TPU
// kernel walks (8, L) lane blocks on its sequential grid, carrying the last
// row in scratch memory from one grid step to the next.  On the card the
// blocks run in parallel, so the carry becomes a scan across blocks.
//
// Design: one pass over tiles of 1024 slots (100 blocks at 102,400 rows),
// with a decoupled look-back for the carry.  A block takes its tile from an
// atomic ticket, so tiles start in order and a block only ever waits on a
// tile whose block is already running: no deadlock whatever the scheduler
// does.  Within the tile each thread runs over 4 consecutive slots, warp
// shuffles and then the 8 warp totals give every slot the last valid index
// in the tile up to it, and the tile's aggregate (its last valid index, or
// -1).  The block publishes that aggregate at once, then its first warp
// reads the status words of the 32 tiles before it at a time: the nearest
// tile that has a valid slot, or that has published its inclusive prefix,
// decides the carry, since valid indices grow with the tile.  The block then
// publishes its inclusive prefix and copies its rows, two 16-byte words a
// row, consecutive threads on consecutive words.
//
// Why one pass and not two launches (per-tile aggregates, then a fill that
// reduces the aggregates before it): the second launch would read the flags
// again and pay a second launch, and its per-block reduction over all
// earlier tiles grows with the square of the tile count at 2^22 rows.
//
// Status words, 64 bits each: the high half (epoch << 2 | state), state 1 =
// aggregate, 2 = inclusive prefix; the low half the index.  Each call gets a
// new epoch from its wrapper, so words of an earlier call read as not yet
// published and the array never needs a reset on the stream.  The ticket
// lives in the first word and returns to 0 when the last tile is drawn
// (atomicInc wraps at the tile count).  Rows are copied, never summed, so the
// result is exact; max is order-free and idempotent, so it repeats bit for
// bit whatever order the look-back sees.
//
// A status word that never shows this call's epoch (a broken wrapper, or a
// scratch array shared by two streams) would leave the look-back spinning:
// its wait traps after about ten seconds (tma.cuh's trap_if_stuck), so the
// launch fails instead of hanging the card.
//
// Bound on an H100: bytes, 65 per slot (a 32-byte row read and written, one
// flag), 6.7 MB at 102,400 slots, 2.0 us at 3.35 TB/s; 273 MB, 81 us, at
// 2^22 slots.

#include <cuda_runtime.h>

#include "tma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;  // consecutive slots per thread
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kWords = 2 * kTile / kThreads;  // 16-byte words per thread
constexpr unsigned kAggregate = 1, kInclusive = 2;

__device__ __forceinline__ int warp_max_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = max(v, u);
  }
  return v;
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned epoch, unsigned state,
                                             int value) {
  const unsigned long long v =
      ((unsigned long long)((epoch << 2) | state) << 32) | (unsigned)value;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// Whether status word w holds this call's aggregate or inclusive prefix.
__device__ __forceinline__ bool published(unsigned long long w,
                                          unsigned epoch) {
  return (unsigned)(w >> 32) >> 2 == epoch && ((unsigned)(w >> 32) & 3u) != 0;
}

// The carry of `tile` >= 1: the last valid index before it (-1 if none), by
// warp-wide windows of its 32 predecessors, nearest first.  Called by one
// full warp.
__device__ int look_back(const unsigned long long* status, int tile,
                         unsigned epoch, int lane) {
  for (int pred = tile - 1;; pred -= 32) {
    const int t = pred - lane;
    int value = -1;
    bool inclusive = true;  // before tile 0: nothing
    if (t >= 0) {
      unsigned long long w = load_status(&status[t]);
      if (!published(w, epoch)) {
        const long long t0 = clock64();
        do {
          __nanosleep(20);
          trap_if_stuck(t0);
          w = load_status(&status[t]);
        } while (!published(w, epoch));
      }
      value = (int)(unsigned)w;
      inclusive = ((unsigned)(w >> 32) & 3u) == kInclusive;
    }
    const unsigned decided =
        __ballot_sync(0xffffffffu, inclusive || value >= 0);
    if (decided) return __shfl_sync(0xffffffffu, value, __ffs(decided) - 1);
  }
}

__global__ void __launch_bounds__(kThreads)
    fill_rows_kernel(const float4* __restrict__ rows0,  // (N, 2) float4
                     const unsigned char* __restrict__ valid0, int N,
                     float4* __restrict__ out,
                     unsigned long long* __restrict__ status,  // (tiles,)
                     unsigned* __restrict__ ticket, unsigned epoch,
                     unsigned num_tiles) {
  __shared__ int s_src[kTile];
  __shared__ int s_warp[kWarps];
  __shared__ int s_tile, s_carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = (int)atomicInc(ticket, num_tiles - 1);
  __syncthreads();
  const int tile = s_tile;
  const int base = tile * kTile;

  // the last valid slot up to each of the thread's slots, within the thread
  const int i0 = base + threadIdx.x * kItems;
  int last[kItems];
  int run = -1;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = i0 + k;
    if (i < N && valid0[i]) run = i;
    last[k] = run;
  }
  const int incl = warp_max_scan(run, lane);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();

  if (warp == 0) {
    int wv = warp_max_scan(lane < kWarps ? s_warp[lane] : -1, lane);
    if (lane < kWarps) s_warp[lane] = wv;  // inclusive over the warps
    const int aggregate = __shfl_sync(0xffffffffu, wv, kWarps - 1);
    int carry = -1;
    if (tile > 0) {
      if (lane == 0)
        store_status(&status[tile], epoch, kAggregate, aggregate);
      carry = look_back(status, tile, epoch, lane);
    }
    if (lane == 0) {
      store_status(&status[tile], epoch, kInclusive, max(carry, aggregate));
      s_carry = carry;
    }
  }
  __syncthreads();

  int prev = s_carry;
  if (warp > 0) prev = max(prev, s_warp[warp - 1]);
  const int up = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane > 0) prev = max(prev, up);
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    s_src[threadIdx.x * kItems + k] = max(0, max(prev, last[k]));
  __syncthreads();

  // the copy: all loads of the thread in flight, then the stores
  const int n_words = 2 * min(kTile, N - base);
  float4 v[kWords];
#pragma unroll
  for (int u = 0; u < kWords; ++u) {
    const int j = threadIdx.x + u * kThreads;
    if (j < n_words) v[u] = rows0[2 * (size_t)s_src[j >> 1] + (j & 1)];
  }
#pragma unroll
  for (int u = 0; u < kWords; ++u) {
    const int j = threadIdx.x + u * kThreads;
    if (j < n_words) out[2 * (size_t)base + j] = v[u];
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes): returns the CUDA error of its
// launch (0 on success); neither allocates nor synchronises.  scratch holds
// 1 + ceil(N / 1024) 64-bit words, zero when first used: the ticket, then the
// tiles' status words.  epoch is in [1, 2^30) and differs from that of every
// earlier call on the same scratch.
extern "C" int tdr_fill_rows(const float* rows0, const unsigned char* valid0,
                             int N, float* out, unsigned long long* scratch,
                             unsigned epoch, void* stream) {
  if (N < 1 || epoch == 0 || epoch >= (1u << 30))
    return (int)cudaErrorInvalidValue;
  const unsigned tiles = (unsigned)((N + kTile - 1) / kTile);
  fill_rows_kernel<<<tiles, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(rows0), valid0, N,
      reinterpret_cast<float4*>(out), scratch + 1,
      reinterpret_cast<unsigned*>(scratch), epoch, tiles);
  return (int)cudaGetLastError();
}
