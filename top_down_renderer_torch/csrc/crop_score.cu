// Tracked crop scoring of a particle cloud, for Hopper (sm_90a): at one
// uniform scale, or over K scale buckets on a mip pyramid.
//
// Replaces: top_down_renderer_tpu/filter/pallas_score.py::_kernel (launched
// by _run_kernel) with its `sel` (tracked) epilogue, as called by
// pallas_score.py for one uniform scale and by filter/multiscale.py's
// make_score_tracked_multi for K buckets.  The TPU kernel DMAs an int8 crop
// of the map around every particle and contracts it with a hi/lo int8 table
// M (the stencil -> pixel one-hot folded through the rolled-scan circulant)
// on the MXU; the multi variant picks a per-bucket M and a pyramid row
// offset per tile.  Here nothing of that layout is carried over: a warp
// walks the Th*R stencil cells of one particle, reads each cell's 8 packed
// channels (two 16-byte loads of the float32 map), and folds them with the
// weighted scan held in shared memory at the particle's own shift s:
//
//   cost = sum_{t,r,c} 0.01 w_c scan_c[(t+s) % Th, r] * map_c(cell)
//   norm = sum_{t,r} (sum_c scan_c)[(t+s) % Th, r] * known(cell)
//   kf   = sum known / (Th R)
//
// (The theta search over 40 shifts is csrc/crop_score_init.cu, on tensor
// cores.)
//
// Uniform scale: every particle shares the offsets off = round(stencil * f),
// staged in shared memory.  K buckets: particle p in bucket b reads bucket
// b's offsets (a (K, Th*R) int2 table, at most 240 KB, read through __ldg
// from L2 so that shared memory holds only the scan tables) on bucket b's
// pyramid level, whose pixel offset, H and W come from a (K, 4) table.  The
// bounds test is against that level's own H and W: a window that leaves its
// level reads zeros and never another level's pixels.
//
// Bound on an H100: a gather: Th*R random 32-byte pixel reads per particle
// (80 KB at 100x25), from a map that fits the 50 MB L2 (1024^2 x 8 x 4 B =
// 32 MB; the 1/2/4/8 pyramid 42.5 MB), against 7 FMAs per cell.  The
// design: the weighted scan and the scan's class sum live in shared memory,
// laid out class-major so the 32 lanes of a warp, which hold 32 consecutive
// cells, read 32 consecutive words; a grid of at most a few blocks per SM
// walks the particles so the shared tables are staged once per block.
//
// Contract (equal to the plain versions in filter/crop_score.py and
// filter/multiscale.py up to float summation order): maps are (H, W, 8)
// float32 with class distances in channels [0, C) and the known indicator in
// channel C; samples outside the map (level) read 0.  centers are (cy, cx)
// int32, off (dy, dx) int32, shifts in any integer range (reduced mod Th).

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxBuckets = 12;

__device__ __forceinline__ int pmod(int a, int m) {
  const int r = a % m;  // C++ % truncates; shifts may be negative
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Offsets staged in shared memory (uniform scale) or read from L2 (buckets).
struct SharedOff {
  const int2* p;
  __device__ __forceinline__ int2 operator()(int i) const { return p[i]; }
};
struct GlobalOff {
  const int2* __restrict__ p;
  __device__ __forceinline__ int2 operator()(int i) const {
    return __ldg(p + i);
  }
};

// The scan tables every crop kernel stages: the weighted scan (C, Th*R) and
// the class sum (Th*R).
template <int C>
__device__ __forceinline__ void stage_scan(float* s_ws, float* s_ss,
                                           const float* __restrict__ wscan,
                                           const float* __restrict__ ssum,
                                           int TR) {
  for (int i = threadIdx.x; i < TR; i += kThreads) s_ss[i] = ssum[i];
  for (int i = threadIdx.x; i < C * TR; i += kThreads) s_ws[i] = wscan[i];
}

// One particle, scored by one warp: the lane-strided walk over the Th*R
// cells of its window centred at ctr on `map` (H, W) at shift `own` * R,
// the warp sums, and lane 0's (cost, norm, kf) into o3.
template <int C, typename Off>
__device__ __forceinline__ void score_particle(
    const float* __restrict__ map, int H, int W, Off off, int2 ctr,
    const float* s_ws, const float* s_ss, int own, int TR, float inv_tr,
    int lane, float* __restrict__ o3) {
  float acc_c = 0.f, acc_n = 0.f, acc_k = 0.f;

  for (int i = lane; i < TR; i += 32) {
    const int2 o = off(i);
    const int y = ctr.x + o.x;
    const int x = ctr.y + o.y;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if ((unsigned)y < (unsigned)H && (unsigned)x < (unsigned)W) {
      const float4* px =
          reinterpret_cast<const float4*>(map + ((size_t)y * W + x) * 8);
      const float4 a = __ldg(px);
      const float4 b = __ldg(px + 1);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
    const float known = v[C];
    acc_k += known;
    int j = i + own;
    if (j >= TR) j -= TR;
    float a = 0.f;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) a = fmaf(s_ws[ch * TR + j], v[ch], a);
    acc_c += a;
    acc_n = fmaf(s_ss[j], known, acc_n);
  }

  acc_c = warp_sum(acc_c);
  acc_n = warp_sum(acc_n);
  const float kf = warp_sum(acc_k) * inv_tr;
  if (lane != 0) return;
  o3[0] = acc_c;
  o3[1] = acc_n;
  o3[2] = kf;
}

// shifts[p] is particle p's own shift.  Two blocks per SM: at most 128
// registers a thread.
template <int C>
__global__ void __launch_bounds__(kThreads, 2)
    crop_score_kernel(const float* __restrict__ map, int H, int W,
                      const float* __restrict__ wscan,  // (C, Th*R)
                      const float* __restrict__ ssum,   // (Th*R)
                      const int2* __restrict__ off,     // (Th*R) dy, dx
                      int Th, int R,
                      const int2* __restrict__ centers,  // (N) cy, cx
                      const int* __restrict__ shifts, int N,
                      float inv_tr, float* __restrict__ out) {  // (N, 3)
  extern __shared__ __align__(16) unsigned char smem[];
  const int TR = Th * R;
  int2* s_off = reinterpret_cast<int2*>(smem);
  float* s_ws = reinterpret_cast<float*>(s_off + TR);
  float* s_ss = s_ws + C * TR;

  for (int i = threadIdx.x; i < TR; i += kThreads) s_off[i] = off[i];
  stage_scan<C>(s_ws, s_ss, wscan, ssum, TR);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int p = blockIdx.x * kWarps + (threadIdx.x >> 5); p < N;
       p += gridDim.x * kWarps) {
    score_particle<C>(map, H, W, SharedOff{s_off}, centers[p], s_ws, s_ss,
                      pmod(shifts[p], Th) * R, TR, inv_tr, lane,
                      out + (size_t)p * 3);
  }
}

// K buckets: particle p reads bucket[p]'s offsets on bucket[p]'s level.
template <int C>
__global__ void __launch_bounds__(kThreads, 2)
    crop_score_multi_kernel(const float* __restrict__ pyramid,
                            const int4* __restrict__ table,  // (K) off,H,W,-
                            int K,
                            const float* __restrict__ wscan,
                            const float* __restrict__ ssum,
                            const int2* __restrict__ off,  // (K, Th*R)
                            int Th, int R,
                            const int* __restrict__ bucket,    // (N)
                            const int2* __restrict__ centers,  // (N)
                            const int* __restrict__ shifts, int N,
                            float inv_tr, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int4 s_tab[kMaxBuckets];
  const int TR = Th * R;
  float* s_ws = reinterpret_cast<float*>(smem);
  float* s_ss = s_ws + C * TR;

  for (int k = threadIdx.x; k < K; k += kThreads) s_tab[k] = table[k];
  stage_scan<C>(s_ws, s_ss, wscan, ssum, TR);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int p = blockIdx.x * kWarps + (threadIdx.x >> 5); p < N;
       p += gridDim.x * kWarps) {
    const int b = bucket[p];
    const int4 lv = s_tab[b];
    score_particle<C>(pyramid + (size_t)lv.x * 8, lv.y, lv.z,
                      GlobalOff{off + (size_t)b * TR}, centers[p], s_ws, s_ss,
                      pmod(shifts[p], Th) * R, TR, inv_tr, lane,
                      out + (size_t)p * 3);
  }
}

// The smem opt-in and the resident-block cap depend only on the device and
// the table size: set and query them once per (device, smem), not on every
// launch.  Callers launch from one host thread.
struct LaunchCache {
  int dev = -1;
  size_t smem = 0;
  int cap = 0;
};

template <typename Kern>
cudaError_t grid_size(Kern kern, size_t smem, int N, LaunchCache& cache,
                      int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != cache.dev || smem != cache.smem) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache.dev = dev;
    cache.smem = smem;
    cache.cap = per_sm * sms;
  }
  const int want = (N + kWarps - 1) / kWarps;
  *blocks = want < cache.cap ? want : cache.cap;
  return cudaSuccess;
}

template <int C>
cudaError_t launch(const float* map, int H, int W, const float* wscan,
                   const float* ssum, const int* off, int Th, int R,
                   const int* centers, const int* shifts, int N,
                   float inv_tr, float* out, cudaStream_t stream) {
  static LaunchCache cache;
  auto kern = crop_score_kernel<C>;
  const size_t TR = (size_t)Th * R;
  const size_t smem = TR * (sizeof(int2) + (C + 1) * sizeof(float));
  int blocks = 0;
  cudaError_t err = grid_size(kern, smem, N, cache, &blocks);
  if (err != cudaSuccess) return err;
  kern<<<blocks, kThreads, smem, stream>>>(
      map, H, W, wscan, ssum, reinterpret_cast<const int2*>(off), Th, R,
      reinterpret_cast<const int2*>(centers), shifts, N, inv_tr, out);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_multi(const float* pyramid, const int* table, int K,
                         const float* wscan, const float* ssum,
                         const int* off, int Th, int R, const int* bucket,
                         const int* centers, const int* shifts, int N,
                         float inv_tr, float* out, cudaStream_t stream) {
  static LaunchCache cache;
  auto kern = crop_score_multi_kernel<C>;
  const size_t smem = (size_t)Th * R * (C + 1) * sizeof(float);
  int blocks = 0;
  cudaError_t err = grid_size(kern, smem, N, cache, &blocks);
  if (err != cudaSuccess) return err;
  kern<<<blocks, kThreads, smem, stream>>>(
      pyramid, reinterpret_cast<const int4*>(table), K, wscan, ssum,
      reinterpret_cast<const int2*>(off), Th, R, bucket,
      reinterpret_cast<const int2*>(centers), shifts, N, inv_tr, out);
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
extern "C" int tdr_crop_score_tracked(const float* map, int H, int W, int C,
                                      const float* wscan, const float* ssum,
                                      const int* off, int Th, int R,
                                      const int* centers, const int* shifts,
                                      int N, float inv_tr, float* out,
                                      void* stream) {
  return by_classes(C, [&](auto cc) {
    return (int)launch<decltype(cc)::value>(
        map, H, W, wscan, ssum, off, Th, R, centers, shifts, N, inv_tr, out,
        static_cast<cudaStream_t>(stream));
  });
}

extern "C" int tdr_crop_score_multi_tracked(
    const float* pyramid, const int* table, int K, int C, const float* wscan,
    const float* ssum, const int* off, int Th, int R, const int* bucket,
    const int* centers, const int* shifts, int N, float inv_tr, float* out,
    void* stream) {
  if (K < 1 || K > kMaxBuckets) return (int)cudaErrorInvalidValue;
  return by_classes(C, [&](auto cc) {
    return (int)launch_multi<decltype(cc)::value>(
        pyramid, table, K, wscan, ssum, off, Th, R, bucket, centers, shifts,
        N, inv_tr, out, static_cast<cudaStream_t>(stream));
  });
}
