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
// short rows reach from L2 and from HBM.
//
// Geometries (the window is rows x cols elements at (k, y, x) of the
// (S, H, W) map; one warp a window unless said otherwise):
//   0 strided  each row read along its bytes with the widest load (16, 8,
//              4, 2 or 1 B) that the window's start, the row pitch, the
//              row length (and, for a copy, the output's offsets) allow;
//   1 folded1  the same on the 8-row-folded map (probes/window.fold_rows),
//              one slice of 8 folded rows a window;
//   2 folded2  two slices, 16 folded rows;
//   3 async    the strided windows of a block fetched with 16-byte
//              cp.async copies into shared memory, double-buffered across
//              the block's windows (the next window's copies in flight
//              while the block reads the last).
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

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarpThreads = 256;  // 8 windows a block (one per warp)
constexpr int kAsyncThreads = 128;
constexpr int kAsyncWindows = 8;  // windows a block of the async geometry

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

// One unit of WD bytes: load it, add it to acc or store it to dst.
template <int E, int OUT, int WD>
__device__ __forceinline__ void unit(const unsigned char* src,
                                     unsigned char* dst,
                                     typename Acc<E>::T& acc) {
  if constexpr (WD == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
    if constexpr (OUT == kCopy) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      add_word<E>(v.x, acc); add_word<E>(v.y, acc);
      add_word<E>(v.z, acc); add_word<E>(v.w, acc);
    }
  } else if constexpr (WD == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
    if constexpr (OUT == kCopy) {
      *reinterpret_cast<uint2*>(dst) = v;
    } else {
      add_word<E>(v.x, acc); add_word<E>(v.y, acc);
    }
  } else if constexpr (WD == 4) {
    const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(src));
    if constexpr (OUT == kCopy) {
      *reinterpret_cast<uint32_t*>(dst) = v;
    } else {
      add_word<E>(v, acc);
    }
  } else if constexpr (WD == 2) {
    const unsigned short v =
        __ldg(reinterpret_cast<const unsigned short*>(src));
    if constexpr (OUT == kCopy) {
      *reinterpret_cast<unsigned short*>(dst) = v;
    } else if constexpr (E == 1) {
      acc += (int)(signed char)(v & 0xff) + (int)(signed char)(v >> 8);
    } else {
      acc += bf16_lo(v);
    }
  } else {
    const unsigned char v = __ldg(src);
    if constexpr (OUT == kCopy) {
      *dst = v;
    } else {
      acc += (int)(signed char)v;  // only int8 has 1-byte units
    }
  }
}

// A warp's pass over one window of `rows` rows of L bytes, `pitch` bytes
// apart, in units of WD bytes: unit i of the window (row i / (L / WD)) on
// lane i % 32, so that every lane has work whatever the row length, four
// loads in flight a lane.
template <int E, int OUT, int WD, int ROWS>
__device__ __forceinline__ void warp_window(const unsigned char* src,
                                            size_t pitch, int rows, int L,
                                            unsigned char* dst,
                                            typename Acc<E>::T& acc) {
  if constexpr (ROWS > 0) rows = ROWS;
  const int units = L / WD;
  const int total = rows * units;
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int i = lane; i < total; i += 32) {
    const int r = i / units, c = i - r * units;
    unit<E, OUT, WD>(src + r * pitch + (size_t)c * WD,
                     dst + (size_t)r * L + (size_t)c * WD, acc);
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
  // the widest unit that divides every offset of the window
  const size_t align = start | pitch | (size_t)L | dst0 | 16;
  const int wd = (int)(align & (~align + 1));
  typename Acc<E>::T acc = 0;
  const unsigned char* s = src + start;
  switch (wd) {
    case 16: warp_window<E, OUT, 16, ROWS>(s, pitch, rows, L, dst, acc); break;
    case 8: warp_window<E, OUT, 8, ROWS>(s, pitch, rows, L, dst, acc); break;
    case 4: warp_window<E, OUT, 4, ROWS>(s, pitch, rows, L, dst, acc); break;
    case 2: warp_window<E, OUT, 2, ROWS>(s, pitch, rows, L, dst, acc); break;
    default:
      if constexpr (E == 1)
        warp_window<E, OUT, 1, ROWS>(s, pitch, rows, L, dst, acc);
  }
  if constexpr (OUT == kSum) {
    acc = warp_total(acc);
    if ((threadIdx.x & 31) == 0) write_sum<E>(out, w, acc);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// The async geometry: block b takes windows [b kAsyncWindows, ...); window
// i + 1's 16-byte copies fly while the block reads window i from shared
// memory (two stages of rows * L bytes).  Every offset is a multiple of 16.
template <int E, int OUT>
__global__ void __launch_bounds__(kAsyncThreads)
    probe_window_async_kernel(const unsigned char* __restrict__ src, int H,
                              int W, const int* __restrict__ origins, int n,
                              int rows, int cols, void* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char stage[];
  __shared__ typename Acc<E>::T s_part[kAsyncThreads / 32];
  const size_t pitch = (size_t)W * E;
  const int L = cols * E;
  const int units = L / 16;
  const int total = rows * units;
  const int bytes = rows * L;
  const int first = blockIdx.x * kAsyncWindows;
  const int last = min(n, first + kAsyncWindows);
  const int tid = threadIdx.x;

  auto issue = [&](int w, int st) {
    const int k = origins[3 * w], y = origins[3 * w + 1],
              x = origins[3 * w + 2];
    const unsigned char* g = src + (((size_t)k * H + y) * W + x) * E;
    unsigned char* sm = stage + (size_t)st * bytes;
    for (int i = tid; i < total; i += kAsyncThreads) {
      const int r = i / units, c = i - r * units;
      cp_async16(sm + r * L + c * 16, g + r * pitch + (size_t)c * 16);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  if (first < last) issue(first, 0);
  for (int w = first; w < last; ++w) {
    const int st = (w - first) & 1;
    if (w + 1 < last) {
      issue(w + 1, st ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const unsigned char* sm = stage + (size_t)st * bytes;
    if constexpr (OUT == kCopy) {
      unsigned char* dst = static_cast<unsigned char*>(out) + (size_t)w * bytes;
      for (int i = tid; i < bytes / 16; i += kAsyncThreads)
        reinterpret_cast<uint4*>(dst)[i] =
            reinterpret_cast<const uint4*>(sm)[i];
    } else {
      typename Acc<E>::T acc = 0;
      for (int i = tid; i < bytes / 16; i += kAsyncThreads) {
        const uint4 v = reinterpret_cast<const uint4*>(sm)[i];
        add_word<E>(v.x, acc); add_word<E>(v.y, acc);
        add_word<E>(v.z, acc); add_word<E>(v.w, acc);
      }
      acc = warp_total(acc);
      if ((tid & 31) == 0) s_part[tid >> 5] = acc;
      __syncthreads();
      if (tid == 0) {
        typename Acc<E>::T s = 0;
        for (int q = 0; q < kAsyncThreads / 32; ++q) s += s_part[q];
        write_sum<E>(out, w, s);
      }
    }
    __syncthreads();  // stage st is free for window w + 2
  }
}

template <int E, int OUT>
cudaError_t launch(const void* src, int H, int W, const int* origins, int n,
                   int rows, int cols, int geometry, void* out,
                   cudaStream_t stream) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  if (geometry == kAsync) {
    static int ready_dev = -1;
    static size_t ready_smem = 0;
    const size_t smem = (size_t)2 * rows * cols * E;
    auto kern = probe_window_async_kernel<E, OUT>;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev != ready_dev || smem > ready_smem) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      ready_dev = dev;
      ready_smem = smem;
    }
    kern<<<(n + kAsyncWindows - 1) / kAsyncWindows, kAsyncThreads, smem,
           stream>>>(s, H, W, origins, n, rows, cols, out);
    return cudaGetLastError();
  }
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
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes); returns the CUDA error of its
// launch.  src: the (S, H, W) map, elem bytes an element (1 int8, 2 bf16);
// origins (n, 3) int32 (stack index, row, column), every window inside the
// map; geometry and out_mode as above; out (n, rows, cols) elements for a
// copy, (n,) int32 (int8) or float32 (bf16) for a sum.  The folded
// geometries take rows = 8 and 16; the async one needs every offset and
// rows * cols * elem a multiple of 16 bytes and 2 rows * cols * elem <= 227
// KB (probes/window.py checks all of this).
extern "C" int tdr_probe_window_gather(const void* src, int S, int H, int W,
                                       int elem, const int* origins, int n,
                                       int rows, int cols, int geometry,
                                       int out_mode, void* out,
                                       void* stream) {
  (void)S;
  if (n < 1 || rows < 1 || cols < 1 || geometry < kStrided ||
      geometry > kAsync || (geometry == kFolded1 && rows != 8) ||
      (geometry == kFolded2 && rows != 16))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem == 1 && out_mode == kCopy)
    return (int)launch<1, kCopy>(src, H, W, origins, n, rows, cols,
                                 geometry, out, s);
  if (elem == 1 && out_mode == kSum)
    return (int)launch<1, kSum>(src, H, W, origins, n, rows, cols, geometry,
                                out, s);
  if (elem == 2 && out_mode == kCopy)
    return (int)launch<2, kCopy>(src, H, W, origins, n, rows, cols,
                                 geometry, out, s);
  if (elem == 2 && out_mode == kSum)
    return (int)launch<2, kSum>(src, H, W, origins, n, rows, cols, geometry,
                                out, s);
  return (int)cudaErrorInvalidValue;
}
