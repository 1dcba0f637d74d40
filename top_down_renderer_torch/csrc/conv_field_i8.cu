// The int8 conv cost field of the clustered cloud, for Hopper (sm_90a).
//
// Replaces: top_down_renderer_tpu/filter/conv_score.py::
// cost_field_s2d_split_i8 (TDR_CONV_INT8=1), an XLA contraction, not a
// Pallas kernel: the int8 map (per-channel codes, quantize_channels) against
// the conv kernel's columns quantized to hi/lo int8 pairs, summed in int32,
// dequantized in float32.  For the centre (y, x) of a (region, region) block
// whose top-left centre is (oy, ox) on the padded map:
//
//   acc[s, p, y, x] = sum_{dy, dx, c} codes[oy - dr/2 + y + dy,
//                                           ox - dc/2 + x + dx, c]
//                                     * ints[s, p, c, dy, dx]
//   field[s, y, x] = fma(f32(acc[s, 0]), s_hi[s], f32(acc[s, 1]) * s_lo[s])
//
// s < S_out = 2 W + 1 (W costs, W norms, the kf count), p = 0 (hi), 1 (lo).
// The epilogue's rounding is the compiled reference's: XLA contracts its
// a_hi s_hi + a_lo s_lo into an FMA of the hi product
// (conv_score.fma_f32, tests/test_torch_conv_int8.py).
//
// Range: codes are at most 126 in magnitude and the integers at most 127,
// so a sum over the dr dc CP taps (98 x 98 x 8 = 76,832 at mo 48, CP 8; the
// stencil's Th R cells reach fewer) stays below 76,832 x 126 x 127 =
// 1.23e9 < 2^31: the int32 sums, and any partial sums of them, are exact,
// and so equal the plain version's bit for bit, in any order.
//
// Formulation: an implicit GEMM on the tensor cores, M = region^2 centres,
// K = dr x dcp x CP taps in the order (dy, dx, c), N = 2 S_out columns in
// the order (s, p), so that a column's hi and lo land in one thread's pair
// of accumulators.  dx runs to dcp, dc rounded up to 32 / CP, so that a
// k32 chunk of a centre's A row is 32 contiguous bytes of one window row
// ((hp, wp, CP) codes: a pixel's channels contiguous); the columns past dc
// hold zero integers.  No im2col in device memory: a block stages its
// centres' map window in shared memory once and reads every A fragment of
// every tap from it.
//
// Block: 128 threads (4 warps) own 8 rows x 16 columns of centres and one
// group of 72 columns (9 n8 tiles; W = 16 has one group, 32 two, 64 four).
// Warp w holds rows 2w, 2w + 1 (two m16 tiles: 16 centres of a row each)
// against the 9 tiles: 72 int32 accumulators a thread.  The integers come in
// the fragment order of mma.m16n8k32 (the wrapper's b_fragments): per k32
// chunk and tile, a lane's two B registers are 8 contiguous bytes, so a
// chunk of a group is one run of 2,304 bytes, staged by cp.async in a ring of
// kStages buffers of kChunks chunks.  The product is
// mma.sync.m16n8k32.s32.s8.s8.s32 (IMMA).
//
// Against the first design (one block a tile running every chunk, 2 chunks
// a stage, 3 stages: 0.096 ms at region 128, mo 24, W 16; this one 0.054
// ms, tests/time_torch_conv_i8.py on an H100 at 700 W), a ring of 4 stages
// of 4 chunks and two choices:
// - Only the chunks with a nonzero integer run (the stencil is a disc: about
//   half of the dense taps are zero there).  The wrapper flags them per
//   group; each block lists them in shared memory (a warp's ballots), so the
//   list costs no launch.
// - The listed chunks split over `splits` blocks a tile
//   (tdr_conv_field_i8_splits: as many as one wave holds), so that a small region still
//   puts several blocks on each SM to hide the products' and the ring's
//   latency.  With one split the block writes the field; with more, each
//   writes its int32 partial sums and conv_field_i8_sum_kernel adds them
//   (exact: integers) and writes the field.  More splits than a wave holds
//   lost (3 a tile 0.054 ms, 5 0.073 at region 128).
//
// Bound on an H100: operations, 2 region^2 K N at 1,979 TOP/s int8 (21.6 G
// at region 128, mo 24, CP 4, W 16 on the dense K and N: 0.011 ms; on the
// taps with a nonzero integer less); the bytes (the window, the integers,
// the field) are 2.6 MB there, 0.8 us.  wgmma fed by TMA is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileY = 8;   // centre rows a block
constexpr int kTileX = 16;  // centre columns a block (one m16 tile a row)
constexpr int kNt = 9;      // n8 tiles a block: a group of 72 columns
constexpr int kCols = kNt * 8;
constexpr int kChunkBytes = kNt * 32 * 8;  // B of one k32 chunk, one group
constexpr int kChunks = 4;  // chunks a stage
constexpr int kStages = 4;
constexpr int kStageBytes = kChunks * kChunkBytes;
constexpr int kMaxChunks = 2560;  // dr dcp CP / 32 at mo 48, CP 8: 2,450

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a,
                                       const uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ float dequant(int hi, int lo, float s_hi,
                                         float s_lo) {
  return __fmaf_rn(__int2float_rn(hi), s_hi,
                   __fmul_rn(__int2float_rn(lo), s_lo));
}

// The window's row pitch in bytes: (16 + dcp - 1) pixels, 16-byte aligned.
__host__ __device__ inline int window_pitch(int dcp, int cp) {
  return ((kTileX + dcp - 1) * cp + 15) / 16 * 16;
}

__host__ __device__ inline int window_bytes(int dr, int dcp, int cp) {
  return (kTileY + dr - 1) * window_pitch(dcp, cp);
}

// The chunk list of a group: the indices of the chunks flagged nonzero, in
// order (warp 0, a ballot a 32 chunks); returns their count.
__device__ int list_chunks(const bool* __restrict__ nonzero, int nchunk,
                           short* list, int* count) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n = 0;
    for (int base = 0; base < nchunk; base += 32) {
      const bool f = base + lane < nchunk && nonzero[base + lane];
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) list[n + __popc(m & ((1u << lane) - 1))] =
          static_cast<short>(base + lane);
      n += __popc(m);
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  return *count;
}

template <int CP>
__global__ void __launch_bounds__(kThreads)
conv_field_i8_kernel(const int8_t* __restrict__ codes, int hp, int wp,
                     const uint2* __restrict__ bfrag,
                     const bool* __restrict__ nonzero,
                     const float* __restrict__ scales,
                     const long long* __restrict__ origin, int dr, int dc,
                     int dcp, int region, int s_out, int splits,
                     float* __restrict__ out, int* __restrict__ sums,
                     int* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ short list[kMaxChunks];
  __shared__ int listed;
  const int pitch = window_pitch(dcp, CP);
  unsigned char* win = smem;
  unsigned char* ring = smem + window_bytes(dr, dcp, CP);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cpr = dcp * CP / 32;  // k32 chunks a window row
  const int nchunk = dr * cpr;
  const int group = blockIdx.z / splits, split = blockIdx.z % splits;
  // chunk nchunk of each group is all zeros: a stage's tail computes on it
  const unsigned char* bsrc = reinterpret_cast<const unsigned char*>(
      bfrag + static_cast<size_t>(group) * (nchunk + 1) * (kChunkBytes / 8));

  const int count = list_chunks(nonzero + group * nchunk, nchunk, list,
                                &listed);
  const int lo = static_cast<int>(static_cast<long long>(count) * split /
                                  splits);
  const int hi = static_cast<int>(static_cast<long long>(count) *
                                  (split + 1) / splits);
  const int nstage = (hi - lo + kChunks - 1) / kChunks;
  auto chunk_at = [&](int i) { return i < hi ? int(list[i]) : nchunk; };

  auto load_stage = [&](int st) {
    if (st < nstage) {
      unsigned char* dst = ring + (st % kStages) * kStageBytes;
#pragma unroll
      for (int cc = 0; cc < kChunks; ++cc) {
        const unsigned char* src =
            bsrc + static_cast<size_t>(chunk_at(lo + st * kChunks + cc)) *
                       kChunkBytes;
        for (int i = tid * 16; i < kChunkBytes; i += kThreads * 16)
          cp_async16(dst + cc * kChunkBytes + i, src + i);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) load_stage(st);

  // the block's map window, (8 + dr - 1) rows of (16 + dcp - 1) pixels, in
  // 4-byte words (a word never straddles a pixel: CP is 4 or 8); pixels off
  // the padded map read as zero codes
  const int y0 = static_cast<int>(origin[0]) - dr / 2 + blockIdx.y * kTileY;
  const int x0 = static_cast<int>(origin[1]) - dc / 2 + blockIdx.x * kTileX;
  const int row_words = (kTileX + dcp - 1) * CP / 4;
  const int rows = kTileY + dr - 1;
  for (int i = tid; i < rows * row_words; i += kThreads) {
    const int r = i / row_words, w = i - r * row_words;
    const int y = y0 + r, x = x0 + w * 4 / CP;
    unsigned v = 0;
    if (y >= 0 && y < hp && x >= 0 && x < wp)
      v = __ldg(reinterpret_cast<const unsigned*>(
          codes + (static_cast<size_t>(y) * wp + x) * CP + w * 4 % CP));
    *reinterpret_cast<unsigned*>(win + r * pitch + w * 4) = v;
  }

  int acc[2][kNt][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][n][j] = 0;

  for (int st = 0; st < nstage; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage st landed for all; stage st - 1 is consumed
    load_stage(st + kStages - 1);
    const unsigned char* bst = ring + (st % kStages) * kStageBytes;
#pragma unroll
    for (int cc = 0; cc < kChunks; ++cc) {
      // the zero chunk past the list reads the window at tap row 0
      const int kc = min(chunk_at(lo + st * kChunks + cc), nchunk - 1);
      const int dy = kc / cpr;
      const int kk = (kc - dy * cpr) * 32;
      unsigned a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        // A row = centre column x of tile row 2 warp + m; its k32 slice is
        // window row (row + dy), bytes x CP + kk .. + 32
        const unsigned char* base =
            win + (warp * 2 + m + dy) * pitch + kk + t * 4;
        a[m][0] = *reinterpret_cast<const unsigned*>(base + g * CP);
        a[m][1] = *reinterpret_cast<const unsigned*>(base + (g + 8) * CP);
        a[m][2] = *reinterpret_cast<const unsigned*>(base + g * CP + 16);
        a[m][3] =
            *reinterpret_cast<const unsigned*>(base + (g + 8) * CP + 16);
      }
      const uint2* bc =
          reinterpret_cast<const uint2*>(bst + cc * kChunkBytes) + lane;
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
        const uint2 b = bc[n * 32];
        mma_s8(acc[0][n], a[0], b);
        mma_s8(acc[1][n], a[1], b);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: accumulators j = 0, 1 are centre column g, j = 2, 3 column
  // g + 8, each pair (hi, lo) of output column s
  const size_t plane = static_cast<size_t>(region) * region;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int y = blockIdx.y * kTileY + warp * 2 + m;
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      const int col = group * kCols + n * 8 + 2 * t;  // the hi column
      const int s = col / 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = blockIdx.x * kTileX + g + 8 * h;
        const int hi_sum = acc[m][n][2 * h], lo_sum = acc[m][n][2 * h + 1];
        const size_t at = static_cast<size_t>(y) * region + x;
        if (splits > 1) {  // every column of the group, pads included
          int* p = partial + static_cast<size_t>(split) *
                                 (gridDim.z / splits) * kCols * plane;
          p[col * plane + at] = hi_sum;
          p[(col + 1) * plane + at] = lo_sum;
          continue;
        }
        if (s >= s_out) continue;
        out[s * plane + at] =
            dequant(hi_sum, lo_sum, scales[2 * s], scales[2 * s + 1]);
        if (sums != nullptr) {
          sums[col * plane + at] = hi_sum;
          sums[(col + 1) * plane + at] = lo_sum;
        }
      }
    }
  }
}

// The splits' partial sums (splits, groups * 72, region^2) added in order
// and dequantized: one thread a (column s, centre).
__global__ void __launch_bounds__(256)
conv_field_i8_sum_kernel(const int* __restrict__ partial, int splits,
                         int cols, const float* __restrict__ scales,
                         int plane, int s_out, float* __restrict__ out,
                         int* __restrict__ sums) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(s_out) * plane) return;
  const int s = static_cast<int>(i / plane);
  const int at = static_cast<int>(i - static_cast<long long>(s) * plane);
  int hi = 0, lo = 0;
  for (int k = 0; k < splits; ++k) {
    const int* p = partial + static_cast<size_t>(k) * cols * plane;
    hi += p[static_cast<size_t>(2 * s) * plane + at];
    lo += p[static_cast<size_t>(2 * s + 1) * plane + at];
  }
  out[i] = dequant(hi, lo, scales[2 * s], scales[2 * s + 1]);
  if (sums != nullptr) {
    sums[static_cast<size_t>(2 * s) * plane + at] = hi;
    sums[static_cast<size_t>(2 * s + 1) * plane + at] = lo;
  }
}

// The kernel of a CP with the dynamic shared memory of a shape allowed:
// the function, the bytes and the error (cudaErrorInvalidValue for a CP
// it has no instance of).
struct Configured {
  const void* fn;
  int smem;
  cudaError_t err;
};

Configured configure(int cp, int dr, int dcp) {
  const void* fn = nullptr;
  if (cp == 4) fn = reinterpret_cast<const void*>(conv_field_i8_kernel<4>);
  if (cp == 8) fn = reinterpret_cast<const void*>(conv_field_i8_kernel<8>);
  const int smem = window_bytes(dr, dcp, cp) + kStages * kStageBytes;
  if (fn == nullptr) return {fn, smem, cudaErrorInvalidValue};
  return {fn, smem,
          cudaFuncSetAttribute(
              fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)};
}

template <int CP>
int launch(const void* codes, int hp, int wp, const void* bfrag,
           const void* nonzero, const void* scales, const void* origin,
           int dr, int dc, int dcp, int region, int s_out, int groups,
           int splits, void* out, void* sums, void* partial,
           cudaStream_t stream) {
  const Configured k = configure(CP, dr, dcp);
  if (k.err != cudaSuccess) return static_cast<int>(k.err);
  const dim3 grid(region / kTileX, region / kTileY, groups * splits);
  conv_field_i8_kernel<CP><<<grid, kThreads, k.smem, stream>>>(
      static_cast<const int8_t*>(codes), hp, wp,
      static_cast<const uint2*>(bfrag), static_cast<const bool*>(nonzero),
      static_cast<const float*>(scales),
      static_cast<const long long*>(origin), dr, dc, dcp, region, s_out,
      splits, static_cast<float*>(out), static_cast<int*>(sums),
      static_cast<int*>(partial));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int plane = region * region;
  const long long n = static_cast<long long>(s_out) * plane;
  conv_field_i8_sum_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                             stream>>>(
      static_cast<const int*>(partial), splits, groups * kCols,
      static_cast<const float*>(scales), plane, s_out,
      static_cast<float*>(out), static_cast<int*>(sums));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// codes (hp, wp, CP) int8; bfrag (groups, dr dcp CP / 32 + 1, 9, 32) uint2
// (conv_score.b_fragments: the last chunk of each group zeros); nonzero
// (groups, dr dcp CP / 32) bool, a chunk's flag; scales (S_out, 2) float32;
// origin (2,) int64 on the card; out (S_out, region, region) float32; sums
// (2 S_out, region, region) int32 or null; partial (splits, groups *
// 72, region, region) int32 scratch where splits > 1, else null.  region a
// multiple of 16, dcp CP a multiple of 32.
int tdr_conv_field_i8(const void* codes, int hp, int wp, int cp,
                      const void* bfrag, const void* nonzero,
                      const void* scales, const void* origin, int dr, int dc,
                      int dcp, int region, int s_out, int groups, int splits,
                      void* out, void* sums, void* partial, void* stream) {
  if (region % kTileX || (dcp * cp) % 32 || dcp < dc ||
      groups * kCols < 2 * s_out || dr * dcp * cp / 32 > kMaxChunks ||
      splits < 1 || (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cp == 4)
    return launch<4>(codes, hp, wp, bfrag, nonzero, scales, origin, dr, dc,
                     dcp, region, s_out, groups, splits, out, sums, partial,
                     s);
  if (cp == 8)
    return launch<8>(codes, hp, wp, bfrag, nonzero, scales, origin, dr, dc,
                     dcp, region, s_out, groups, splits, out, sums, partial,
                     s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The blocks a tile of centres splits its chunks over: as many as one wave
// of the card holds (the occupancy calculator's blocks an SM, for this
// shape's shared memory, times the SMs), at most 8 and at least 1.
int tdr_conv_field_i8_splits(int cp, int dr, int dcp, int region, int groups,
                             int* splits) {
  const Configured k = configure(cp, dr, dcp);
  if (k.err != cudaSuccess) return static_cast<int>(k.err);
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, k.fn, kThreads, k.smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (region / kTileX) * (region / kTileY) * groups;
  const int fit = sms * per_sm / tiles;
  *splits = fit < 1 ? 1 : (fit > 8 ? 8 : fit);
  return 0;
}

}  // extern "C"
