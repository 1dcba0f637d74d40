// Theta search of a particle cloud on Hopper's tensor cores (sm_90a): at one
// uniform scale, or over K scale buckets on a mip pyramid.
//
// Replaces: top_down_renderer_tpu/filter/pallas_score.py::_kernel with its
// `sel_init` epilogue (make_score_init(sel=True), run by _run_kernel) and
// the K-bucket theta search of filter/multiscale.py::make_score_init_multi.
// Like the TPU kernel it computes the search as a matrix product per tile
// of particles:
//
//   acc[p, n] = sum_{q, ch} window_p[q, ch] * M[(q, ch), n]
//
// q runs over the distinct pixel offsets (dy, dx) the stencil reaches, ch
// over the map's C classes and its known channel, padded to CP = 2, 4 or 8
// channels.  M (filter/crop_score.py::init_m) folds the stencil's
// nearest-neighbour one-hot into the rolled-scan circulant columns at the S
// search shifts: column 2k is cost(k), column 2k + 1 norm(k), column 80 the
// count of stencil cells on the pixel (on its known channel), so
// kf = acc[p, 80] / (Th R).  K buckets: each bucket has its own M (its own
// offsets) and its own pyramid level; the wrapper sorts the particles by
// bucket, so that every tile of 192 rows lies in one bucket.
//
// Work: the dense product runs 2 x K x 88 x 3 bf16 tensor FLOPs per particle
// (the three split products below), K = CP x the distinct pixels (about
// 6,300 at f = 1 and C = 3); of M's 88 columns a pixel holds only C S + S + 1
// nonzero entries (161 at C = 3, S = 40), so more than half of that work
// multiplies zeros.  Each particle also gathers K x 4 bytes of window from
// the L2-resident compact map.
// The design:
//   - a block scores a tile of 192 particles: three warpgroups, one m64
//     wgmma tile each, so every chunk of M read from L2 serves 192 rows (the
//     previous design read the scan tables once per particle);
//   - M streams in chunks of 32 K rows: a chunk's bf16 hi plane, lo plane
//     and pixel offsets lie back to back in global memory, in wgmma's
//     K-major no-swizzle core-matrix order, and one bulk copy (TMA,
//     cp.async.bulk) per chunk fills a ring of kStages shared-memory stages,
//     each with its mbarrier;
//   - A comes straight into registers (wgmma's RS form): each thread gathers
//     the float2 pairs of its fragment rows with plain loads, which a window
//     outside its map or level replaces by zeros, and splits them into bf16
//     hi and lo; the loads of the next chunk are in flight while the tensor
//     cores work on this one;
//   - acc = A_hi B_hi + A_hi B_lo + A_lo B_hi in fp32: the split keeps about
//     2^-16 of each product, where one bf16 pass (2^-9) or TF32 (truncation)
//     could not hold the plain version's rel 1e-4; known and the cell counts
//     are small integers, exact in bf16, so kf is exact;
//   - the tensor cores round their fp32 sums toward zero, and over the ~1,200
//     accumulation steps of a whole window that bias reached 6e-5 of the
//     cost (measured on an H100); so each chunk's six products go into a
//     fresh partial sum, which the threads add to their fp32 accumulators
//     with round-to-nearest, the promotion of DeepSeek-V3's fp8 GEMMs;
//   - the epilogue divides, gates (NaN and kf < 0.5 -> FLT_MAX) and takes the
//     first argmin across the four lanes that hold a row, and writes (best
//     cost, k, kf) to the particle's own row.  Costs within kTieRel of the
//     row's minimum count as ties and go to the first shift (the contract
//     in filter/crop_score.py, TIE_REL there): on a window
//     of constant map values (open terrain beyond the distance cut-off)
//     all 40 costs are equal in exact arithmetic, the plain version's
//     float32 sums come out exactly equal (first argmin 0), and this
//     kernel's, summed in another order, differ by a few 1e-7.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarpgroups = 3;  // one m64 tile each
constexpr int kThreads = kWarpgroups * 128;
constexpr int kTile = kWarpgroups * 64;  // particles per block
constexpr int kCols = 88;    // M columns: 40 (cost, norm) pairs, kf, padding
constexpr int kKfCol = 80;
constexpr int kAcc = kCols / 2;  // accumulator floats per thread
constexpr int kChunk = 32;       // K rows per stage: two k16 steps
constexpr int kPlane = kChunk * kCols * 2;  // bytes of one bf16 plane
constexpr int kLbo = (kCols / 8) * 128;  // bytes between core matrices in K
constexpr int kSbo = 128;                // ... and in N
constexpr int kStages = 8;
constexpr int kMaxSearch = 40;
constexpr int kMaxBuckets = 12;
constexpr int kFarOut = -(1 << 30);  // centre of a row past the tile's end
constexpr float kTieRel = 1.0f / (1 << 20);  // ~1e-6: the sums' precision

static_assert(kKfCol == 2 * kMaxSearch, "kf follows the 40 pairs");

// One chunk of M as the wrapper lays it out: hi plane, lo plane, then the
// (dy, dx) int2 offsets of its kChunk / CP pixels.
template <int CP>
struct Chunk {
  static constexpr int kPix = kChunk / CP;
  static constexpr int kBytes = 2 * kPlane + kPix * 8;
  static_assert(kBytes % 16 == 0, "bulk copies move multiples of 16 bytes");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// One bulk copy of `bytes` from global memory into shared memory, counted
// on `bar` (one arrival that expects the bytes).
__device__ __forceinline__ void load_chunk(void* dst, const void* src,
                                           int bytes, uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// wgmma descriptor of a K-major bf16 operand without swizzle: start address,
// leading (K) and stride (N) byte offsets between 8 x 16-byte core matrices.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(kLbo >> 4) << 16) | ((uint64_t)(kSbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving accesses of wgmma's registers across the
// fences and waits (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 88 fp32, this thread's 44) = A (64 x 16 bf16, registers) * B,
// plus d itself unless `fresh`.
__device__ __forceinline__ void mma(float (&d)[kAcc], const uint32_t (&a)[4],
                                    uint64_t b, bool fresh = false) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %49, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n88k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43}, {%44, %45, %46, %47}, %48, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(fresh ? 0 : 1));
}

// (hi, lo) bf16 pairs of two window values: hi = bf16(v), lo = bf16(v - hi).
__device__ __forceinline__ void split(float2 v, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v.x - hf.x, v.y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Block i scores tile i of the bucket-sorted rows.  sched holds row_start
// (K + 1), tile_start (K + 1) and each bucket's chunk count (K); rows are
// positions in the sorted order, perm maps them to particles (null: the
// identity).  Level b of the map is table[b] = (pixel offset, H, W, -), or
// (0, H, W) when table is null.
template <int CP>
__global__ void __launch_bounds__(kThreads, 1)
    crop_init_kernel(const float* __restrict__ map,    // (pixels, CP)
                     const int4* __restrict__ table, int H, int W,
                     const unsigned char* __restrict__ m,  // (K, cap, Chunk)
                     const int* __restrict__ sched, int K, int chunk_cap,
                     const int* __restrict__ perm,
                     const int2* __restrict__ centers,  // (N) cy, cx
                     int S, float inv_tr, float* __restrict__ out) {
  using Ch = Chunk<CP>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages];

  const int* row_start = sched;
  const int* tile_start = sched + K + 1;
  const int tile = blockIdx.x;
  if (tile >= tile_start[K]) return;
  int b = 0;
  while (tile >= tile_start[b + 1]) ++b;
  const int row0 = row_start[b] + (tile - tile_start[b]) * kTile;
  const int row_end = row_start[b + 1];
  const int nchunks = sched[2 * (K + 1) + b];
  const int4 lv = table ? table[b] : make_int4(0, H, W, 0);
  const unsigned char* mb = m + (size_t)b * chunk_cap * Ch::kBytes;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // first row of this thread's warp: warpgroup, then warp within it; the
  // thread holds rows g and g + 8 of the warp's 16
  const int wrow = row0 + (tid >> 7) * 64 + ((tid >> 5) & 3) * 16;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < kStages && s < nchunks; ++s)
      load_chunk(smem + s * Ch::kBytes, mb + (size_t)s * Ch::kBytes,
                 Ch::kBytes, &full[s]);
  }
  __syncwarp();

  int cy[2], cx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wrow + g + 8 * h;
    cy[h] = cx[h] = kFarOut;
    if (row < row_end) {
      const int2 c = centers[perm ? perm[row] : row];
      cy[h] = c.x;
      cx[h] = c.y;
    }
  }

  // window values of one chunk: [k16 step][column half][row half]; column
  // half 0 holds fragment columns 2t, 2t + 1, half 1 those + 8
  float2 av[2][2][2];
  auto load_a = [&](int s) {
    const int2* pix =
        reinterpret_cast<const int2*>(smem + s * Ch::kBytes + 2 * kPlane);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int k = ks * 16 + hf * 8 + 2 * t;  // K row within the chunk
        const int2 o = pix[k / CP];
        const int ch = k % CP;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int y = cy[h] + o.x;
          const int x = cx[h] + o.y;
          float2 v = make_float2(0.f, 0.f);
          if ((unsigned)y < (unsigned)lv.y && (unsigned)x < (unsigned)lv.z)
            v = __ldg(reinterpret_cast<const float2*>(
                map + ((size_t)lv.x + (size_t)y * lv.z + x) * CP + ch));
          av[ks][hf][h] = v;
        }
      }
    }
  };

  float acc[kAcc], part[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = part[i] = 0.f;
  // A fragments [k16 step][register]: registers 0-3 hold (row g, cols
  // 2t..), (row g + 8, cols 2t..), (row g, cols 2t + 8..), (row g + 8, ...)
  uint32_t ahi[2][4], alo[2][4];

  if (nchunks > 0) {
    mbar_wait(&full[0], 0);
    load_a(0);
  }
  for (int kc = 0; kc < nchunks; ++kc) {
    const int s = kc % kStages;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          split(av[ks][hf][h], ahi[ks][2 * hf + h], alo[ks][2 * hf + h]);

    pin(part);
    wg_fence();
    const uint32_t hi = smem_addr(smem + s * Ch::kBytes);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const uint64_t bh = desc(hi + ks * 2 * kLbo);
      const uint64_t bl = desc(hi + kPlane + ks * 2 * kLbo);
      mma(part, ahi[ks], bh, ks == 0);
      mma(part, ahi[ks], bl);
      mma(part, alo[ks], bh);
    }
    wg_commit();
    if (kc + 1 < nchunks) {  // the next chunk's window, while the MMAs run
      const int s1 = (kc + 1) % kStages;
      mbar_wait(&full[s1], ((kc + 1) / kStages) & 1);
      load_a(s1);
    }
    wg_wait_all();
    pin(part);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      pin(ahi[ks]);
      pin(alo[ks]);
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] += part[i];
    __syncthreads();  // every warpgroup is done with stage s
    if (tid == 0 && kc + kStages < nchunks)
      load_chunk(smem + s * Ch::kBytes,
                 mb + (size_t)(kc + kStages) * Ch::kBytes, Ch::kBytes,
                 &full[s]);
    __syncwarp();
  }

  // epilogue: accumulator 4j + 2h (+1) holds column 8j + 2t (+1) of row
  // g + 8h, i.e. cost (norm) of shift k = 4j + t; column 80 (j 10, t 0)
  // the count of known stencil cells
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float cnt =
        __shfl_sync(0xffffffffu, acc[4 * (kKfCol / 8) + 2 * h], lane & ~3);
    const float kf = cnt * inv_tr;
    float c[kMaxSearch / 4];
    float lo = __int_as_float(0x7f800000);  // +inf
#pragma unroll
    for (int j = 0; j < kMaxSearch / 4; ++j) {
      c[j] = acc[4 * j + 2 * h] / acc[4 * j + 2 * h + 1];
      if (isnan(c[j]) || kf < 0.5f) c[j] = FLT_MAX;
      if (4 * j + t < S) lo = fminf(lo, c[j]);
    }
    // the row's minimum over the quad, then the first shift within
    // kTieRel of it
#pragma unroll
    for (int o = 1; o < 4; o <<= 1)
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    // (no slack once the minimum is FLT_MAX: it never admits +inf)
    const float tie = lo < FLT_MAX ? lo + kTieRel * fabsf(lo) : lo;
    float best = lo;
    int bk = kMaxSearch;
#pragma unroll
    for (int j = kMaxSearch / 4 - 1; j >= 0; --j) {
      if (4 * j + t < S && c[j] <= tie) {
        best = c[j];
        bk = 4 * j + t;
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int ok = __shfl_xor_sync(0xffffffffu, bk, o);
      if (ok < bk) {
        best = ob;
        bk = ok;
      }
    }
    const int row = wrow + g + 8 * h;
    if (t == 0 && row < row_end) {
      float* o3 = out + (size_t)(perm ? perm[row] : row) * 3;
      o3[0] = best;
      o3[1] = (float)bk;
      o3[2] = kf;
    }
  }
}

template <int CP>
cudaError_t launch(const float* map, const int* table, int H, int W, int K,
                   const void* m, const int* sched, int chunk_cap,
                   const int* perm, const int* centers, int N, int S,
                   float inv_tr, float* out, cudaStream_t stream) {
  static int ready_dev = -1;  // the smem opt-in is set once per device
  auto kern = crop_init_kernel<CP>;
  const int smem = kStages * Chunk<CP>::kBytes;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != ready_dev) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ready_dev = dev;
  }
  // sum_b ceil(n_b / kTile) <= N / kTile + K tiles; blocks past the last
  // tile return at once
  kern<<<N / kTile + K, kThreads, smem, stream>>>(
      map, reinterpret_cast<const int4*>(table), H, W,
      static_cast<const unsigned char*>(m), sched, K, chunk_cap, perm,
      reinterpret_cast<const int2*>(centers), S, inv_tr, out);
  return cudaGetLastError();
}

int by_channels(int CP, const float* map, const int* table, int H, int W,
                int K, const void* m, const int* sched, int chunk_cap,
                const int* perm, const int* centers, int N, int S,
                float inv_tr, float* out, void* stream) {
  if (S < 1 || S > kMaxSearch || K < 1 || K > kMaxBuckets)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (CP) {
    case 2:
      return (int)launch<2>(map, table, H, W, K, m, sched, chunk_cap, perm,
                            centers, N, S, inv_tr, out, st);
    case 4:
      return (int)launch<4>(map, table, H, W, K, m, sched, chunk_cap, perm,
                            centers, N, S, inv_tr, out, st);
    case 8:
      return (int)launch<8>(map, table, H, W, K, m, sched, chunk_cap, perm,
                            centers, N, S, inv_tr, out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each returns the CUDA error of
// its launch (0 on success); none allocates or synchronises.  map: the
// compact (H, W, CP) map; m, sched, chunk_cap: init_operands' records and
// schedule (filter/crop_score.py); centers (N) int2 (cy, cx); out (N, 3).
extern "C" int tdr_crop_score_init(const float* map, int H, int W, int CP,
                                   const void* m, const int* sched,
                                   int chunk_cap, const int* centers, int N,
                                   int S, float inv_tr, float* out,
                                   void* stream) {
  return by_channels(CP, map, nullptr, H, W, 1, m, sched, chunk_cap, nullptr,
                     centers, N, S, inv_tr, out, stream);
}

// K buckets: pyramid (pixels, CP) with table (K, 4) of (pixel offset, H, W,
// -) per bucket; perm (N) the particles in bucket order.
extern "C" int tdr_crop_score_multi_init(const float* pyramid,
                                         const int* table, int K, int CP,
                                         const void* m, const int* sched,
                                         int chunk_cap, const int* perm,
                                         const int* centers, int N, int S,
                                         float inv_tr, float* out,
                                         void* stream) {
  return by_channels(CP, pyramid, table, 0, 0, K, m, sched, chunk_cap, perm,
                     centers, N, S, inv_tr, out, stream);
}
