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
//     row-major, with the CSR of each pixel's stencil cells (one block per
//     table: a bitonic sort of (dy, dx, cell) keys in shared memory, then a
//     block scan), the result of crop_score.fold_offsets in one launch;
//   - the wrapper sorts the particles by group = bucket * Th + shift (one
//     stable device sort); block i of the tracked kernel takes sorted rows
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
// plain version.
//
// The tracked kernel's body lives in crop_tracked.cuh, which
// csrc/crop_ablate.cu includes too, to time it with stages knocked out.
//
// Contract (equal to the plain versions in filter/crop_score.py and
// filter/multiscale.py up to float summation order): the compact map is
// (pixels, CP) float32, classes in channels [0, C), known in channel C;
// centers are (cy, cx) int32, pixel offsets (dy, dx) int32.

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "crop_tracked.cuh"

namespace {

constexpr int kFoldThreads = 1024;  // one block per offset table
constexpr int kPad = 1 << 29;       // (dy, dx) of a padding pixel: PAD_PIX
constexpr int kCellBits = 20;       // cells per table < 2^20

// The tracked kernel: its body (crop_tracked.cuh) with every stage on.
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
                        int N, float inv_tr, float* __restrict__ out) {
  tracked_body<C, kFull>(map, table, H, W, scan, cw, pix, npix, order, seg,
                         Th, R, P, skey, perm, centers, N, inv_tr, out);
}

// Exclusive prefix sum of one int per thread over a block of kFoldThreads;
// *total gets the block's sum.  Every thread must call it.
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
  if (warp == 0) {
    int w = s_warp[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  const int excl = (warp ? s_warp[warp - 1] : 0) + x - v;
  *total = s_warp[31];
  __syncthreads();  // s_warp is reused by the next call
  return excl;
}

// Block b folds offset table b (off (K, Th*R) int2): the keys (dy, dx,
// cell) sorted in shared memory (bitonic, n2 = Th*R rounded up to a power
// of two), then each new pixel numbered by a block scan.  Writes pix (K, P)
// (PAD_PIX after the table's npix[b] pixels), npix (K), order (K*Th*R, the
// flat cells b*Th*R + i by pixel, then cell) and seg (K*P + 1): what
// crop_score.fold_offsets returns.
__global__ void __launch_bounds__(kFoldThreads)
    crop_fold_kernel(const int2* __restrict__ off, int K, int TR, int P,
                     int n2, int2* __restrict__ pix, int* __restrict__ npix,
                     int* __restrict__ order, int* __restrict__ seg) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(smem);
  __shared__ int s_warp[32];
  const int b = blockIdx.x;
  const int2* o = off + (size_t)b * TR;
  for (int i = threadIdx.x; i < n2; i += kFoldThreads) {
    unsigned long long k = ~0ull;  // padding sorts last
    if (i < TR) {
      const int2 d = o[i];
      k = ((unsigned long long)(unsigned)(d.x + (1 << 21)) << 42) |
          ((unsigned long long)(unsigned)(d.y + (1 << 21)) << kCellBits) |
          (unsigned long long)i;
    }
    s_key[i] = k;
  }
  __syncthreads();
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n2; i += kFoldThreads) {
        const int ij = i ^ j;
        if (ij > i) {
          const unsigned long long a = s_key[i], c = s_key[ij];
          if ((a > c) == ((i & k) == 0)) {
            s_key[i] = c;
            s_key[ij] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  int count = 0;  // pixels numbered so far
  const int base = b * TR;
  for (int r = 0; r < TR; r += kFoldThreads) {
    const int i = r + threadIdx.x;
    int fresh = 0;
    unsigned long long k = 0;
    if (i < TR) {
      k = s_key[i];
      fresh = i == 0 || (k >> kCellBits) != (s_key[i - 1] >> kCellBits);
    }
    int total;
    const int u = count + block_scan(fresh, s_warp, &total);
    if (i < TR) {
      const int cell = (int)(k & ((1u << kCellBits) - 1));
      order[base + i] = base + cell;
      if (fresh) {
        pix[(size_t)b * P + u] = o[cell];
        seg[(size_t)b * P + u] = base + i;
      }
    }
    count += total;
  }
  for (int u = count + threadIdx.x; u < P; u += kFoldThreads) {
    pix[(size_t)b * P + u] = make_int2(kPad, kPad);
    seg[(size_t)b * P + u] = base + TR;
  }
  if (threadIdx.x == 0) {
    npix[b] = count;
    if (b == K - 1) seg[(size_t)K * P] = K * TR;
  }
}

template <int C>
cudaError_t launch(const float* map, const int* table, int H, int W,
                   const float* scan, const float* cw, const int* pix,
                   const int* npix, const int* order, const int* seg, int Th,
                   int R, int P, const int* skey, const long long* perm,
                   const int* centers, int N, float inv_tr, float* out,
                   cudaStream_t stream) {
  // the smem opt-in, set once per device and raised with the table size;
  // callers launch from one host thread
  static int ready_dev = -1;
  static size_t ready_smem = 0;
  auto kern = crop_tracked_kernel<C>;
  const size_t smem = smem_bytes<C>(Th * R, P);
  cudaError_t err = opt_in_smem(kern, smem, &ready_dev, &ready_smem);
  if (err != cudaSuccess) return err;
  kern<<<(N + kTile - 1) / kTile, kThreads, smem, stream>>>(
      map, reinterpret_cast<const int4*>(table), H, W, scan, cw,
      reinterpret_cast<const int2*>(pix), npix, order, seg, Th, R, P, skey,
      perm, reinterpret_cast<const int2*>(centers), N, inv_tr, out);
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

// off (K, Th*R) int2 offset tables, TR = Th*R < 2^20, P >= TR; out holds
// pix (K, P) int2, seg (K*P + 1), order (K*Th*R) and npix (K), int32, back
// to back.
extern "C" int tdr_crop_fold(const int* off, int K, int TR, int P, int* out,
                             void* stream) {
  static int ready_dev = -1;
  static size_t ready_smem = 0;
  if (K < 1 || TR < 1 || TR >= (1 << kCellBits) || P < TR)
    return (int)cudaErrorInvalidValue;
  int n2 = 1;
  while (n2 < TR) n2 <<= 1;
  const size_t smem = (size_t)n2 * sizeof(unsigned long long);
  const cudaError_t err =
      opt_in_smem(crop_fold_kernel, smem, &ready_dev, &ready_smem);
  if (err != cudaSuccess) return (int)err;
  int2* pix = reinterpret_cast<int2*>(out);
  int* seg = out + (size_t)2 * K * P;
  int* order = seg + (size_t)K * P + 1;
  int* npix = order + (size_t)K * TR;
  crop_fold_kernel<<<K, kFoldThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int2*>(off), K, TR, P, n2, pix, npix, order,
      seg);
  return (int)cudaGetLastError();
}

// map: the compact (H, W, CP) map; scan (C, Th, R) and cw (C): the scan
// and the class weights; pix, npix, order, seg, P: tdr_crop_fold's output;
// skey (N) int32, perm (N) int64: the particles' group keys (shift at one
// scale) sorted stably, and the sort's permutation; centers (N) int2 (cy, cx);
// out (N, 3).
extern "C" int tdr_crop_score_tracked(
    const float* map, int H, int W, int C, const float* scan,
    const float* cw, const int* pix, const int* npix, const int* order,
    const int* seg, int Th, int R, int P, const int* skey,
    const long long* perm, const int* centers, int N, float inv_tr,
    float* out, void* stream) {
  return by_classes(C, [&](auto cc) {
    return (int)launch<decltype(cc)::value>(
        map, nullptr, H, W, scan, cw, pix, npix, order, seg, Th, R, P, skey,
        perm, centers, N, inv_tr, out, static_cast<cudaStream_t>(stream));
  });
}

// K buckets: compact pyramid (pixels, CP) with table (K, 4) of (pixel
// offset, H, W, -) per bucket; the group keys are bucket * Th + shift.
extern "C" int tdr_crop_score_multi_tracked(
    const float* pyramid, const int* table, int K, int C, const float* scan,
    const float* cw, const int* pix, const int* npix, const int* order,
    const int* seg, int Th, int R, int P, const int* skey,
    const long long* perm, const int* centers, int N, float inv_tr,
    float* out, void* stream) {
  if (K < 1 || K > kMaxBuckets) return (int)cudaErrorInvalidValue;
  return by_classes(C, [&](auto cc) {
    return (int)launch<decltype(cc)::value>(
        pyramid, table, 0, 0, scan, cw, pix, npix, order, seg, Th, R, P,
        skey, perm, centers, N, inv_tr, out,
        static_cast<cudaStream_t>(stream));
  });
}
