// Window gather probe for Hopper (sm_90a): copy or sum n rectangular
// windows of a stacked row-major map, one fetch geometry at a time, to
// measure the card's window-gather rate from L2 and from HBM.
//
// Replaces the TPU's DMA probes, each a Pallas kernel that fetches map
// windows with make_async_copy: tests/probe_dma_unaligned.py::_kernel (8-row
// copies at unaligned row starts), probe_dma_align.py::kern (a 64-row slice
// over an alignment sweep, summed), probe_dma2.py::kern1 (a slice of a
// stacked map at a dynamic stack index, summed), probe_dma_fold.py::
// _kernel_a / _kernel_fold / _kernel_db (102,400 crops of 56 rows x 640 B:
// one strided fetch each, from the 8-row-folded map in 1 or 2 slices, and
// double-buffered across tiles), probe_int8.py's probe_dma kernel (an int8
// slice at y0 = 3 ymul) and its rotate kernel (a byte row rotated by rx*8:
// here a window of the row laid out twice).  A TPU DMA descriptor has
// alignment rules; a Hopper load has only its width, so the questions
// become: what do unaligned starts cost, and what rate does a gather of
// short rows reach from L2 and from HBM, with plain loads and staged into
// shared memory by TMA.
//
// Geometries (the window is rows x cols elements at (k, y, x) of the
// (S, H, W) map):
//   0 strided  one warp a window.  A window whose start, row pitch, row
//              length (and, for a copy, output offset) are all multiples of
//              16 bytes is read in 16-byte loads; any other window in the
//              aligned 16-byte words that cover each row: a sum masks the
//              bytes outside the window, a copy shifts them into place with
//              __funnelshift_r (two words per output word);
//   1 folded1  the same on the 8-row-folded map (probes/window.fold_rows),
//              one slice of 8 folded rows a window;
//   2 folded2  two slices, 16 folded rows;
//   3 async    windows staged in shared memory by TMA: a tensor map over
//              the (S H, W E) bytes of the map, one elected producer thread
//              issuing cp.async.bulk.tensor.2d boxes (at most 256 bytes
//              wide, so a 640-B row takes 256 + 256 + 128) into a ring of up
//              to 6 window stages, each with a full mbarrier (expecting the
//              window's bytes) and an empty one; a group of 5 consumer warps
//              owns each stage, sums or copies its windows from shared
//              memory with 16-byte reads, adds its warps' sums over a
//              barrier of the group alone and arrives on the empty barrier,
//              so the loop has no block barrier.  Blocks are persistent and
//              stride over the windows.  A box must start on 16 bytes (one
//              at another start is an illegal instruction on an H100), and
//              TMA reads boxes that start on 32 bytes faster, so a window at
//              any byte is staged from the 32-byte boundary below it, up to
//              31 bytes wider, and the consumer masks (sum) or shifts (copy)
//              the bytes into place; a last box is rounded up to 16 bytes.
//              Only the row pitch must be a multiple of 16 bytes (TMA's
//              strides).
// Outputs: 0 copy, (n, rows, cols) elements; 1 sum, one exact sum per
// window: int32 for int8 (dp4a), float32 for bf16 (summed in float64,
// exact for windows whose values span under 53 - log2(rows cols) bits, as
// every probe's do, then rounded once).  With the sum, reads and not
// writes set the time.
//
// Bound: the bytes read.  The function must read each map byte that a
// window covers once; the windows read rows*cols*elem bytes each, many of
// them again from L2, whose rate NVIDIA does not publish: the measured
// rate is the finding (probes/__main__.py prints both).

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "tma.cuh"

namespace {

constexpr int kWarpThreads = 256;  // 8 windows a block (one per warp)
constexpr int kGroup = 5;          // async: consumer warps a stage
constexpr int kGroupThreads = 32 * kGroup;
constexpr int kPart = (kGroup + 1) & ~1;  // a stage's partial sums, padded
// async: window stages; six groups and the producer warp are 992 threads
constexpr int kMaxStages = (1024 - 32) / kGroupThreads;
// a TMA box: at most 256 elements a dimension (map bytes across, rows down)
constexpr int kBoxMax = 256;
constexpr int kSmemLimit = 232448;  // 227 KB of dynamic shared memory

enum : int { kStrided = 0, kFolded1 = 1, kFolded2 = 2, kAsync = 3 };
enum : int { kCopy = 0, kSum = 1 };

// The accumulator of a window's sum: int for int8, double for bf16.
template <int E>
struct Acc {
  using T = typename std::conditional<E == 1, int, double>::type;
};

__device__ __forceinline__ double bf16_lo(uint32_t w) {
  return (double)__uint_as_float(w << 16);
}
__device__ __forceinline__ double bf16_hi(uint32_t w) {
  return (double)__uint_as_float(w & 0xffff0000u);
}

// Add the elements of one 32-bit word to acc.
template <int E>
__device__ __forceinline__ void add_word(uint32_t w,
                                         typename Acc<E>::T& acc) {
  if constexpr (E == 1) {
    acc = __dp4a((int)w, 0x01010101, acc);
  } else {
    acc += bf16_lo(w);
    acc += bf16_hi(w);
  }
}

template <int E>
__device__ __forceinline__ void add_words(const uint4& v,
                                          typename Acc<E>::T& acc) {
  add_word<E>(v.x, acc);
  add_word<E>(v.y, acc);
  add_word<E>(v.z, acc);
  add_word<E>(v.w, acc);
}

// The bytes [b0, b1) of a 32-bit word (b0, b1 clamped to 0..4), others 0.
__device__ __forceinline__ uint32_t keep(uint32_t w, int b0, int b1) {
  b0 = max(0, min(4, b0));
  b1 = max(0, min(4, b1));
  const uint32_t hi = b1 >= 4 ? 0xffffffffu : (1u << (8 * b1)) - 1;
  const uint32_t lo = b0 >= 4 ? 0xffffffffu : (1u << (8 * b0)) - 1;
  return w & hi & ~lo;
}

// The bytes [b0, b1) of a 16-byte word, others 0.
__device__ __forceinline__ uint4 keep(uint4 v, int b0, int b1) {
  return make_uint4(keep(v.x, b0, b1), keep(v.y, b0 - 4, b1 - 4),
                    keep(v.z, b0 - 8, b1 - 8), keep(v.w, b0 - 12, b1 - 12));
}

// Bytes [s, s + 16) of the 32 bytes lo:hi (s in 0..15).
__device__ __forceinline__ uint4 shift_bytes(const uint4& lo, const uint4& hi,
                                             int s) {
  uint32_t a0, a1, a2, a3, a4;
  switch (s >> 2) {
    case 0: a0 = lo.x; a1 = lo.y; a2 = lo.z; a3 = lo.w; a4 = hi.x; break;
    case 1: a0 = lo.y; a1 = lo.z; a2 = lo.w; a3 = hi.x; a4 = hi.y; break;
    case 2: a0 = lo.z; a1 = lo.w; a2 = hi.x; a3 = hi.y; a4 = hi.z; break;
    default: a0 = lo.w; a1 = hi.x; a2 = hi.y; a3 = hi.z; a4 = hi.w; break;
  }
  const int b = 8 * (s & 3);
  return make_uint4(__funnelshift_r(a0, a1, b), __funnelshift_r(a1, a2, b),
                    __funnelshift_r(a2, a3, b), __funnelshift_r(a3, a4, b));
}

// n bytes (n < 16, or an unaligned destination) of v to dst.
__device__ __forceinline__ void store_bytes(unsigned char* dst, const uint4& v,
                                            int n) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (b < n) dst[b] = (unsigned char)(w[b >> 2] >> (8 * (b & 3)));
}

// A warp's pass over one window of `rows` rows of L bytes, `pitch` bytes
// apart, every offset a multiple of 16: unit i of the window (row i /
// (L / 16)) on lane i % 32, so that every lane has work whatever the row
// length, four loads in flight a lane.
template <int E, int OUT, int ROWS>
__device__ __forceinline__ void warp_window(const unsigned char* src,
                                            size_t pitch, int rows, int L,
                                            unsigned char* dst,
                                            typename Acc<E>::T& acc) {
  if constexpr (ROWS > 0) rows = ROWS;
  const int units = L / 16;
  const int total = rows * units;
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int i = lane; i < total; i += 32) {
    const int r = i / units, c = i - r * units;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(
        src + r * pitch + (size_t)c * 16));
    if constexpr (OUT == kCopy)
      *reinterpret_cast<uint4*>(dst + (size_t)r * L + (size_t)c * 16) = v;
    else
      add_words<E>(v, acc);
  }
}

// The same pass for a window at any byte, every load an aligned 16-byte
// word.  A sum over rows that start s bytes past a 16-byte boundary (a row
// pitch of a multiple of 16) reads the words wholly inside the window as
// an aligned window (warp_window), then each row's first and last word
// masked to the window's bytes; with any other pitch every word is masked.
// A copy reads, for each 16 bytes of output, the one or two words that
// hold them and shifts them into place.  (The last word of a row may reach
// up to 15 bytes past the row; the map starts 16-byte aligned, and the
// allocation covers whole 16-byte words.)
template <int E, int OUT, int ROWS>
__device__ __forceinline__ void warp_window_any(const unsigned char* src,
                                                size_t pitch, int rows, int L,
                                                unsigned char* dst,
                                                typename Acc<E>::T& acc) {
  if constexpr (ROWS > 0) rows = ROWS;
  const int lane = threadIdx.x & 31;
  if constexpr (OUT == kSum) {
    const int s = (int)(reinterpret_cast<uintptr_t>(src) & 15);
    if ((pitch & 15) == 0) {
      const int first = s ? 1 : 0, end = (s + L) >> 4;  // whole words
      if (end > first)
        warp_window<E, kSum, ROWS>(src - s + 16 * first, pitch, rows,
                                   16 * (end - first), nullptr, acc);
      // the edge words: word 0 (if s > 0) and word `end` (if s + L is not
      // a multiple of 16) of each row
      for (int e = lane; e < 2 * rows; e += 32) {
        const int r = e >> 1, c = e & 1 ? end : 0;
        if ((e & 1) ? ((s + L) & 15) == 0 || (s && !end) : s == 0) continue;
        const int lo = 16 * c - s;
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(
                                  src - s + r * pitch) + c);
        add_words<E>(keep(v, -lo, L - lo), acc);
      }
      return;
    }
    const int words = (L + 30) >> 4;
    for (int i = lane; i < rows * words; i += 32) {
      const int r = i / words, c = i - r * words;
      const unsigned char* a = src + r * pitch;
      const int sr = (int)(reinterpret_cast<uintptr_t>(a) & 15);
      const int lo = 16 * c - sr;
      if (lo < L)
        add_words<E>(keep(__ldg(reinterpret_cast<const uint4*>(a - sr) + c),
                          -lo, L - lo),
                     acc);
    }
  } else {
    const int chunks = (L + 15) >> 4;
#pragma unroll 4
    for (int i = lane; i < rows * chunks; i += 32) {
      const int r = i / chunks, c = i - r * chunks;
      const unsigned char* a = src + r * pitch + 16 * c;
      const int s = (int)(reinterpret_cast<uintptr_t>(a) & 15);
      const int n = min(16, L - 16 * c);
      const uint4* w = reinterpret_cast<const uint4*>(a - s);
      uint4 v = __ldg(w);
      if (s)
        v = shift_bytes(v, s + n > 16 ? __ldg(w + 1) : make_uint4(0, 0, 0, 0),
                        s);
      unsigned char* d = dst + (size_t)r * L + 16 * c;
      if (n == 16 && (reinterpret_cast<uintptr_t>(d) & 15) == 0)
        *reinterpret_cast<uint4*>(d) = v;
      else
        store_bytes(d, v, n);
    }
  }
}

template <typename T>
__device__ __forceinline__ T warp_total(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int E>
__device__ __forceinline__ void write_sum(void* out, int w,
                                          typename Acc<E>::T s) {
  if constexpr (E == 1) {
    static_cast<int*>(out)[w] = s;
  } else {
    static_cast<float*>(out)[w] = (float)s;
  }
}

// One warp a window; ROWS > 0 fixes the window's rows (the folded slices).
template <int E, int OUT, int ROWS>
__global__ void __launch_bounds__(kWarpThreads)
    probe_window_kernel(const unsigned char* __restrict__ src, int H,
                        int W, const int* __restrict__ origins, int n,
                        int rows, int cols, void* __restrict__ out) {
  const int w = blockIdx.x * (kWarpThreads / 32) + (threadIdx.x >> 5);
  if (w >= n) return;
  const int k = origins[3 * w], y = origins[3 * w + 1],
            x = origins[3 * w + 2];
  const size_t pitch = (size_t)W * E;
  const int L = cols * E;
  const size_t start = (((size_t)k * H + y) * W + x) * E;
  const size_t dst0 = OUT == kCopy ? (size_t)w * rows * L : 0;
  unsigned char* dst = OUT == kCopy ? static_cast<unsigned char*>(out) + dst0
                                    : nullptr;
  typename Acc<E>::T acc = 0;
  const unsigned char* s = src + start;
  if (((start | pitch | (size_t)L | dst0) & 15) == 0)
    warp_window<E, OUT, ROWS>(s, pitch, rows, L, dst, acc);
  else
    warp_window_any<E, OUT, ROWS>(s, pitch, rows, L, dst, acc);
  if constexpr (OUT == kSum) {
    acc = warp_total(acc);
    if ((threadIdx.x & 31) == 0) write_sum<E>(out, w, acc);
  }
}

// -- the async geometry: windows staged by TMA ------------------------------
// A stage holds one window as the boxes of its staged rows: a window
// whose start x lies s bytes past a kAlign-byte boundary is staged from x -
// s, s + L bytes a row rounded up to 16, and the consumer skips the first
// s.  A staged row is nfull boxes kBoxMax wide and a last one `tail`
// bytes wide; box b sits at b * full_bytes of the stage, rows x width
// bytes, its start on 128 bytes.  Layout `a` stages aligned windows (L
// bytes a row), layout `u` any other (L + kAlign - E).  Host and device
// agree on this layout (probes/window.py::tma_boxes).
constexpr int kAlign = 32;  // bytes a staged row starts on

struct Layout {
  int nfull;  // boxes kBoxMax bytes wide
  int tail;   // bytes of the last box (a multiple of 16)
};

static_assert(kBoxMax / 16 <= kGroupThreads,
              "a group reads a box row's 16-byte chunks in one pass");

struct Boxes {
  Layout a, u;
  int full_bytes;  // bytes a full box takes in a stage (128-aligned)
  int stage_bytes;
  int stages;
};

inline int round128(int b) { return (b + 127) & ~127; }

Layout layout_of(int bytes) {
  const int w = (bytes + 15) & ~15;
  const int nfull = (w - 1) / kBoxMax;
  return Layout{nfull, w - kBoxMax * nfull};
}

Boxes boxes_of(int rows, int cols, int E) {
  Boxes bx;
  bx.a = layout_of(cols * E);
  bx.u = layout_of(cols * E + kAlign - E);
  bx.full_bytes = round128(rows * kBoxMax);
  bx.stage_bytes = 0;
  for (const Layout& l : {bx.a, bx.u})
    bx.stage_bytes = std::max(
        bx.stage_bytes, l.nfull * bx.full_bytes + round128(rows * l.tail));
  bx.stages = std::min(kMaxStages,
                       (kSmemLimit - 512) / std::max(1, bx.stage_bytes));
  return bx;
}

// Warp kGroup S produces (S = stages): window i of this block (w =
// blockIdx + i grid) goes to stage i % S, its lead s into lead[i % S].  The producer
// warp reads 32 windows' origins at a time, one a lane, and its lane 0
// issues their boxes.  Group c of kGroup consumer warps takes the windows
// of stage c: they read it together, add their partial sums in shared
// memory over a barrier of the group alone, and release the stage.

template <int E, int OUT>
__global__ void __launch_bounds__(1024)
    probe_window_tma_kernel(__grid_constant__ const CUtensorMap full_map,
                            __grid_constant__ const CUtensorMap tail_a,
                            __grid_constant__ const CUtensorMap tail_u,
                            int H, const int* __restrict__ origins, int n,
                            int rows, int cols, Boxes bx,
                            void* __restrict__ out) {
  using T = typename Acc<E>::T;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  const int S = bx.stages, G = gridDim.x;
  // after the stages: the partial sums [S][kPart] (kPart even, so the
  // barriers after them lie on 8 bytes), the barriers, the leads.  (Padding
  // the sums' count at run time instead measured 25 % slower:
  // probes/variants.py, `padded_at_run_time`.)
  T* part = reinterpret_cast<T*>(smem + S * bx.stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(part + S * kPart);
  uint64_t* empty = full + S;
  int* lead = reinterpret_cast<int*>(empty + S);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kGroup * S) {  // the producer
    int i = 0;
    for (int base = blockIdx.x; base < n; base += 32 * G) {
      const int mine = base + lane * G;
      int k = 0, y = 0, x = 0;
      if (mine < n) {
        k = origins[3 * mine];
        y = origins[3 * mine + 1];
        x = origins[3 * mine + 2];
      }
      const int count = min(32, (n - base + G - 1) / G);
      for (int j = 0; j < count; ++j, ++i) {
        const int wk = __shfl_sync(0xffffffffu, k, j);
        const int wy = __shfl_sync(0xffffffffu, y, j);
        const int wx = __shfl_sync(0xffffffffu, x, j);
        if (lane == 0) {
          const int s = i % S;
          mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
          const int ls = wx * E & (kAlign - 1);  // bytes before the window
          const Layout l = ls ? bx.u : bx.a;
          const int x0 = wx * E - ls, line = wk * H + wy;
          unsigned char* st = smem + s * bx.stage_bytes;
          lead[s] = ls;
          mbar_expect(&full[s], rows * (l.nfull * kBoxMax + l.tail));
          for (int b = 0; b < l.nfull; ++b)
            tma_load(st + b * bx.full_bytes, &full_map, x0 + kBoxMax * b,
                     line, &full[s]);
          tma_load(st + l.nfull * bx.full_bytes, ls ? &tail_u : &tail_a,
                   x0 + kBoxMax * l.nfull, line, &full[s]);
        }
        __syncwarp();
      }
    }
    return;
  }

  // consumer group `grp`: windows i = grp, grp + S, ... of this block; the
  // window's row is bytes [s, s + L) of its staged row
  const int grp = warp / kGroup, gt = threadIdx.x - grp * kGroupThreads;
  const int L = cols * E;
  const unsigned char* st = smem + grp * bx.stage_bytes;
  int i = grp;
  for (int w = blockIdx.x + grp * G; w < n; w += S * G, i += S) {
    mbar_wait(&full[grp], (i / S) & 1);
    const int s = lead[grp];
    const Layout l = s ? bx.u : bx.a;
    if constexpr (OUT == kSum) {
      // box b's C 16-byte chunks a row: thread gt reads column gt % C of
      // rows gt / C, gt / C + step, ...; a column wholly inside the window
      // is summed as it is, one across its edge masked, one outside skipped
      T acc = 0;
      for (int b = 0; b <= l.nfull; ++b) {
        const int C = (b < l.nfull ? kBoxMax : l.tail) >> 4;
        const int step = kGroupThreads / C;
        if (gt >= step * C) continue;
        const int c = gt % C;
        const int o = kBoxMax * b + 16 * c - s;  // the row's byte here
        if (o + 16 <= 0 || o >= L) continue;
        const uint4* col =
            reinterpret_cast<const uint4*>(st + b * bx.full_bytes) + c;
        if (o >= 0 && o + 16 <= L) {
#pragma unroll 4
          for (int r = gt / C; r < rows; r += step)
            add_words<E>(col[r * C], acc);
        } else {
          const uint4 m = keep(make_uint4(~0u, ~0u, ~0u, ~0u), -o, L - o);
#pragma unroll 4
          for (int r = gt / C; r < rows; r += step) {
            const uint4 v = col[r * C];
            add_words<E>(make_uint4(v.x & m.x, v.y & m.y, v.z & m.z,
                                    v.w & m.w),
                         acc);
          }
        }
      }
      acc = warp_total(acc);
      if (lane == 0) part[grp * kPart + warp % kGroup] = acc;
    } else {
      // staged chunk q (16 bytes) of row r
      auto chunk = [&](int r, int q) {
        const int b = q / (kBoxMax / 16);
        const int c = q - b * (kBoxMax / 16);
        const int bw = b < l.nfull ? kBoxMax : l.tail;
        return *reinterpret_cast<const uint4*>(st + b * bx.full_bytes +
                                               r * bw + 16 * c);
      };
      const int chunks = (L + 15) >> 4, sq = s >> 4, sb = s & 15;
      for (int u = gt; u < rows * chunks; u += kGroupThreads) {
        const int r = u / chunks, j = u - r * chunks;
        const int n16 = min(16, L - 16 * j);
        uint4 v = chunk(r, j + sq);
        if (sb)
          v = shift_bytes(v, sb + n16 > 16 ? chunk(r, j + sq + 1)
                                           : make_uint4(0, 0, 0, 0), sb);
        unsigned char* d = static_cast<unsigned char*>(out) +
                           ((size_t)w * rows + r) * L + 16 * j;
        if (n16 == 16 && (reinterpret_cast<uintptr_t>(d) & 15) == 0)
          *reinterpret_cast<uint4*>(d) = v;
        else
          store_bytes(d, v, n16);
      }
    }
    // the group's barrier (named barrier 1 + grp): every read of the stage
    // is done and every partial sum written
    asm volatile("bar.sync %0, %1;" ::"r"(1 + grp), "r"(kGroupThreads)
                 : "memory");
    if (gt == 0) {
      if constexpr (OUT == kSum) {
        T total = 0;
        for (int q = 0; q < kGroup; ++q) total += part[grp * kPart + q];
        write_sum<E>(out, w, total);
      }
      mbar_arrive(&empty[grp]);
    }
  }
}

// The (S H, W E) bytes of the map, in boxes of `rows` x
// `bytes` bytes, no swizzle.
CUresult encode_map(CUtensorMap* map, const void* src, int lines, int W,
                    int E, int rows, int bytes) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)W * E, (cuuint64_t)lines};
  const cuuint64_t strides[1] = {(cuuint64_t)W * E};
  const cuuint32_t box[2] = {(cuuint32_t)bytes, (cuuint32_t)rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(src),
            dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int E, int OUT>
int launch_async(const void* src, int S, int H, int W, const int* origins,
                 int n, int rows, int cols, void* out, cudaStream_t stream) {
  static int ready_dev = -1, sms = 0;
  static size_t ready_smem = 0;
  const Boxes bx = boxes_of(rows, cols, E);
  if (bx.stages < 1 || rows > kBoxMax) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)bx.stages * bx.stage_bytes +
                      (sizeof(typename Acc<E>::T) * kPart + 20) * bx.stages +
                      128;
  auto kern = probe_window_tma_kernel<E, OUT>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != ready_dev || smem > ready_smem) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    ready_dev = dev;
    ready_smem = smem;
  }
  const int threads = kGroupThreads * bx.stages + 32;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap fm, ta, tu;
  CUresult res = encode_map(&fm, src, S * H, W, E, rows, kBoxMax);
  if (res == CUDA_SUCCESS)
    res = encode_map(&ta, src, S * H, W, E, rows, bx.a.tail);
  if (res == CUDA_SUCCESS)
    res = encode_map(&tu, src, S * H, W, E, rows, bx.u.tail);
  if (res != CUDA_SUCCESS) return kEncodeFailed + (int)res;
  const int grid = std::min(n, std::max(1, per_sm) * sms);
  kern<<<grid, threads, smem, stream>>>(fm, ta, tu, H, origins, n, rows, cols,
                                        bx, out);
  return (int)cudaGetLastError();
}

template <int E, int OUT>
int launch(const void* src, int S, int H, int W, const int* origins, int n,
           int rows, int cols, int geometry, void* out, cudaStream_t stream) {
  if (geometry == kAsync)
    return launch_async<E, OUT>(src, S, H, W, origins, n, rows, cols, out,
                                stream);
  const unsigned char* s = static_cast<const unsigned char*>(src);
  const int blocks = (n + kWarpThreads / 32 - 1) / (kWarpThreads / 32);
  if (geometry == kFolded1)
    probe_window_kernel<E, OUT, 8><<<blocks, kWarpThreads, 0, stream>>>(
        s, H, W, origins, n, rows, cols, out);
  else if (geometry == kFolded2)
    probe_window_kernel<E, OUT, 16><<<blocks, kWarpThreads, 0, stream>>>(
        s, H, W, origins, n, rows, cols, out);
  else
    probe_window_kernel<E, OUT, 0><<<blocks, kWarpThreads, 0, stream>>>(
        s, H, W, origins, n, rows, cols, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes); returns the CUDA error of its
// launch, or 1000 + the CUresult of cuTensorMapEncodeTiled when a tensor
// map cannot be encoded.  src: the (S, H, W) map, 16-byte aligned, elem bytes an element
// (1 int8, 2 bf16); origins (n, 3) int32 (stack index, row, column), every
// window inside the map; geometry and out_mode as above; out (n, rows,
// cols) elements for a copy, (n,) int32 (int8) or float32 (bf16) for a sum.
// The folded geometries take rows = 8 and 16; the async one needs a row
// pitch of a multiple of 16 bytes, rows <= 256 and two window stages in
// shared memory (probes/window.py checks all of this).
extern "C" int tdr_probe_window_gather(const void* src, int S, int H, int W,
                                       int elem, const int* origins, int n,
                                       int rows, int cols, int geometry,
                                       int out_mode, void* out,
                                       void* stream) {
  if (n < 1 || rows < 1 || cols < 1 || geometry < kStrided ||
      geometry > kAsync || (geometry == kFolded1 && rows != 8) ||
      (geometry == kFolded2 && rows != 16) ||
      (geometry == kAsync && (W * elem) % 16))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem == 1 && out_mode == kCopy)
    return launch<1, kCopy>(src, S, H, W, origins, n, rows, cols, geometry,
                            out, s);
  if (elem == 1 && out_mode == kSum)
    return launch<1, kSum>(src, S, H, W, origins, n, rows, cols, geometry,
                           out, s);
  if (elem == 2 && out_mode == kCopy)
    return launch<2, kCopy>(src, S, H, W, origins, n, rows, cols, geometry,
                            out, s);
  if (elem == 2 && out_mode == kSum)
    return launch<2, kSum>(src, S, H, W, origins, n, rows, cols, geometry,
                           out, s);
  return (int)cudaErrorInvalidValue;
}
