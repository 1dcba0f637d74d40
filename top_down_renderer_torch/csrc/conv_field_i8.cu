// The int8 conv cost field of the clustered cloud, for Hopper (sm_90a): one
// kernel quantizes the float conv kernel and lays its integers out for the
// GEMM, a second computes the field on wgmma fed by TMA.
//
// Replaces: top_down_renderer_tpu/filter/conv_score.py::
// cost_field_s2d_split_i8 (TDR_CONV_INT8=1), an XLA contraction, not a
// Pallas kernel: the int8 map (per-channel codes, quantize_channels) against
// the conv kernel's columns quantized to hi/lo int8 pairs (:588-606), summed
// in int32, dequantized in float32.  For the centre (y, x) of a (region,
// region) block whose top-left centre is (oy, ox) on the padded map:
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
// so a sum over the dr dc CP taps (98 x 98 x 8 = 76,832 at mo 48, CP 8)
// stays below 76,832 x 126 x 127 = 1.23e9 < 2^31: the int32 sums, and any
// partial sums of them, are exact, and so equal the plain version's bit for
// bit, in any order.
//
// The GEMM: M = region^2 centres, K = dr x dcp x CP taps in the order (dy,
// dx, c), N = 2 S_out columns in the order n = 2 s + p.  dx runs to dcp, dc
// rounded up to 32 / CP, so that a k32 chunk of a centre's A row is 32
// contiguous bytes of one window row ((hp, wp, CP) codes: a pixel's
// channels contiguous); the columns past dc hold zero integers.  The
// columns go in groups of NP, the least width wgmma takes for .s8 (8, 16,
// 24, then multiples of 16 to 256) that holds 2 S_out, in as few groups as
// 256 allows: W 16 one group of 80 (66 columns), W 32 one of 144 (130), W
// 64 two of 144 (258).  conv_score.I8_COLUMNS lists them.
//
// 1. conv_quant_i8_kernel (tdr_conv_quant_i8): exactly
//    conv_score.quantize_conv_kernel, then the layout: kq = kernel qinv[c];
//    amax = max(max |kq|, 1e-30) a column; s_hi = amax f32(1/127), s_lo =
//    amax f32(1/32258); hi = clip(rint(kq / s_hi), -127, 127); lo =
//    clip(rint(fma(kernel, qinv, -hi s_hi) / s_lo), -127, 127) (the
//    reference's quantization, cost_field_s2d_split_i8 :588-606).  Every
//    product, division and FMA is an _rn intrinsic, so that nvcc's
//    contraction of products and sums into FMAs (its default) changes no
//    bit; the one FMA is the one XLA contracted.  Out: B, a chunk's NP rows
//    of 32 bytes (K-major, each row in the 32-byte swizzle that wgmma
//    reads: the layout the field kernel's TMA copies as it is), a flag a
//    chunk (1 where an integer of it is not zero) and the scales.
//    Bound: bytes, the float kernel and qinv read once and the integers
//    (2 S_out CP dr dc bytes, without B's padding), flags and scales
//    written once (D's cell: 1.32 MB + 0.66 MB, 0.59 us at 3.35 TB/s);
//    floor: a one-element fill, 1.0 us.
//    Where the time went (the first design, stamped by
//    tests/time_torch_conv_quant.py): a block a slice of a column for its
//    max (at D's cell 99 slices on 350 blocks), a grid barrier, then a
//    block a chunk re-reading its values from L2 or device memory, one
//    dependent load a value: on an H100 SXM at 700 W 12.6 us at D's cell,
//    the rounding 5.3 of it; 145 us at the largest shape (S_out 129, CP 8,
//    mo 48: 39.6 MB, read twice).  This design takes 8.1 and 78 us there
//    (at D's cell 2.3 until its copies are issued, the grid barrier 1.3,
//    the group's maxima 1.6, the rounding 1.2): one cooperative launch of
//    one block an SM, a group's chunks split evenly over sms / groups
//    blocks, each block's chunks read once:
//    - staged in shared memory as [chunk][column][32 values of K] (B's row
//      order, so an item's 4 values are one float4), a warp copying 32
//      consecutive floats of a plane's (s, c) run (the block's chunks
//      cover one contiguous run of each plane: a row's last chunk ends at
//      dc, where the next row starts) by 4-byte cp.async.  A plane's run
//      starts anywhere (tap rows are dc floats), so no 16-byte copy, 1-D
//      bulk copy or tap-row TMA box applies;
//    - the chunks past the shared memory (only the largest shape has
//      them) read for their max before the barrier and copied in again,
//      from L2, after it, a shared memory's worth at a time;
//    - the block's column maxima (a max of |kq| per item, then of a
//      column's lanes, then an integer atomicMax on the bits in shared
//      memory: exact and order-free) written to `partial`, the one grid
//      barrier, a column's maxima over its group's blocks read by 16
//      lanes at once; no run-time division in an inner loop (CP is a
//      template argument);
//    - a product of zero skips the two divisions (its integers are 0, as
//      the divisions give; 5,366 of D's 10,000 taps have no nonzero
//      integer), and a whole number becomes its byte by one add of
//      1.5 2^23.
//    tests/time_torch_conv_quant.py stamps the phases at the "stamp:"
//    lines.
//    No float atomics: a max and an OR, the same bits in any order.
//
// 2. conv_field_i8_kernel (tdr_conv_field_i8): a block owns 8 rows x 16
//    columns of centres and one column group, and runs
//    - one producer warp (an elected lane): the block's window of codes,
//      (8 + dr - 1) rows of the (hp, wp, CP) map, by one TMA box of a 3-D
//      tensor map over its 16-byte groups, from the group at or below the
//      block's first pixel (TMA's coordinates and strides are whole 16-byte
//      groups: ConvMap pads the codes' row pitch to a multiple of 16 bytes,
//      and the wrapper refuses codes whose pitch is not); TMA's
//      out-of-bounds zero fill stands for the map's edges.  Then B: one box
//      a listed chunk, its NP x 32 bytes as NP / 4 rows of 128, into a
//      ring of kStages stages of kChunks chunks on full/empty mbarriers.
//      Only the chunks flagged nonzero are listed (warp 0's ballots over
//      flags all threads stage) and fetched;
//    - two consumer warpgroups, each an m64 tile of 4 centre rows x 16
//      (warp w the 16 centres of row w, as wgmma's A fragment puts rows 16 w
//      .. 16 w + 15), issuing wgmma.mma_async m64nNPk32 .s32.s8.s8 with A
//      from registers (each thread reads its four A words a chunk from the
//      window by ld.shared) and B from the ring by descriptor.  A stage's
//      chunks are one commit group, and the next stage's A words are read
//      while it runs (two groups in flight).  The loop is kept short, since
//      with a few warps a scheduler its dependent bookkeeping sets the pace
//      (a division and generic loads a chunk cost more than the products):
//      each listed chunk's window offset is computed once by the lister,
//      and the loop is unrolled over the ring's four slots, whose offsets
//      are then compile-time.
//    The listed chunks of a tile split over `splits` blocks (one wave of the
//    card, tdr_conv_field_i8_splits), a cluster of `splits` blocks along z:
//    each puts its accumulators in its shared memory, and after a cluster
//    barrier each adds its share of the cluster's through distributed
//    shared memory (int32: exact) and writes it, so the split costs no
//    second kernel and no partial sums in device memory.
//    Bound on an H100: operations, 2 region^2 K N at 1,979 TOP/s int8 (D's
//    cell, region 128, mo 24, CP 4, W 16: 0.0051 ms on the 4,634 taps with
//    a nonzero integer, 0.0109 dense); the bytes (window, integers, field)
//    are 2.6 MB there, 0.8 us.
//
// The ring's offsets are compile-time (NP, kChunks, kStages): the window
// probe's variants (probes/variants.py) lose 28 % with barrier offsets
// computed at run time.  A wait that outlasts about ten seconds traps
// (tma.cuh), so a broken pipeline fails its launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kConsumers = 2;  // warpgroups, an m64 tile (4 centre rows)
                               // each
constexpr int kConsumerThreads = kConsumers * 128;
constexpr int kThreads = kConsumerThreads + 32;  // + the producer warp
constexpr int kProducer = kConsumers * 4;         // the producer's warp
constexpr int kTileY = 4 * kConsumers;  // centre rows a block
constexpr int kTileX = 16;              // centre columns a block
constexpr int kChunks = 4;  // k32 chunks a ring stage and a commit group
constexpr int kStages = 4;
constexpr int kMaxChunks = 2560;  // dr dcp CP / 32 at mo 48, CP 8: 2,450
constexpr int kMaxSplits = 8;     // a portable cluster
constexpr int kQuantThreads = 1024;  // the quantizer's block, one an SM
constexpr int kQuantMaxChunks = 64;  // chunks a quantizer block takes

// The byte offset that the 32-byte swizzle adds to (XORs into) a K-major
// row of 32 bytes: its 16-byte halves swap where (row >> 2) is odd.
__device__ __forceinline__ int swizzle32(int row) {
  return ((row >> 2) & 1) << 4;
}

template <int NP>
struct Ring {
  static constexpr int kChunkBytes = NP * 32;  // NP rows of 32 bytes of K
  static constexpr int kBytes = kStages * kChunks * kChunkBytes;
  // the block's accumulators, [index][thread], for the cluster's sums
  static constexpr int kReduceBytes = NP / 2 * kConsumerThreads * 4;
};

// The window box: rows and 16-byte groups (conv_score.i8_window).  A row
// starts up to 15 bytes before the block's first pixel.
__host__ __device__ inline int window_rows(int dr) { return kTileY + dr - 1; }
__host__ __device__ inline int window_groups(int dcp, int cp) {
  return ((kTileX + dcp - 1) * cp + 15) / 16 + 1;
}

template <int NP>
__host__ __device__ inline int field_smem(int dr, int dcp, int cp) {
  const int main = Ring<NP>::kBytes +
                   window_rows(dr) * window_groups(dcp, cp) * 16;
  const int body = main > Ring<NP>::kReduceBytes ? main
                                                 : Ring<NP>::kReduceBytes;
  return 1024 + body + (2 * kStages + 1) * 8;  // alignment, barriers
}

__device__ __forceinline__ float dequant(int hi, int lo, float s_hi,
                                         float s_lo) {
  return __fmaf_rn(__int2float_rn(hi), s_hi,
                   __fmul_rn(__int2float_rn(lo), s_lo));
}

// A 32-bit word of shared memory at address `addr`.
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// wgmma descriptor of a K-major operand of 32-byte rows in the 32-byte
// swizzle that the tensor map writes: start address, leading byte offset
// unused (1), 256 bytes between 8-row groups, layout type 3 (32B).  The
// buffer starts on 256 bytes.
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(256 >> 4) << 32) | (3ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of wgmma's accumulators across
// the fences and waits (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void pin(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define TDR_R4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define TDR_R8(i) TDR_R4(i), TDR_R4(i + 4)
#define TDR_A4 "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3])

// d (64 x NP int32, this thread's NP / 2) += A (64 x 32 s8, registers) B^T
// (NP x 32 s8, shared memory): the RS form.
template <int NP>
__device__ __forceinline__ void wgmma_rs(int (&d)[NP / 2],
                                         const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<80>(int (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p;\n}\n"
      : TDR_R8(0), TDR_R8(8), TDR_R8(16), TDR_R8(24), TDR_R8(32)
      : TDR_A4, "l"(b));
}

template <>
__device__ __forceinline__ void wgmma_rs<144>(int (&d)[72],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71}, "
      "{%72, %73, %74, %75}, %76, p;\n}\n"
      : TDR_R8(0), TDR_R8(8), TDR_R8(16), TDR_R8(24), TDR_R8(32),
        TDR_R8(40), TDR_R8(48), TDR_R8(56), TDR_R8(64)
      : TDR_A4, "l"(b));
}

#undef TDR_A4
#undef TDR_R8
#undef TDR_R4

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// The int32 at `p` in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ int ld_cluster(const int* p, int rank) {
  uint32_t remote;
  int v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_addr(p)), "r"(rank));
  asm volatile("ld.shared::cluster.u32 %0, [%1];"
               : "=r"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// The chunk list of a group: the indices of the chunks flagged nonzero, in
// order, and each one's byte offset in the window (its tap row dy times the
// pitch, plus 32 bytes a chunk of the row); returns their count.  Every
// thread stages the flags (16 bytes each, in parallel), then warp 0 lists
// them (a ballot a 32 chunks).
__device__ int list_chunks(const unsigned char* __restrict__ nonzero,
                           int nchunk, int cpr, int pitch,
                           unsigned char* flags, short* list, int* off,
                           int* count) {
  for (int i = threadIdx.x * 16; i < nchunk; i += blockDim.x * 16) {
    if (i + 16 <= nchunk &&
        (reinterpret_cast<uintptr_t>(nonzero + i) & 15) == 0) {
      *reinterpret_cast<uint4*>(flags + i) =
          *reinterpret_cast<const uint4*>(nonzero + i);
    } else {
      for (int j = i; j < min(i + 16, nchunk); ++j) flags[j] = nonzero[j];
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n = 0;
    for (int base = 0; base < nchunk; base += 32) {
      const int kc = base + lane;
      const bool f = kc < nchunk && flags[kc];
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) {
        const int at = n + __popc(m & ((1u << lane) - 1));
        const int dy = kc / cpr;
        list[at] = static_cast<short>(kc);
        off[at] = dy * pitch + (kc - dy * cpr) * 32;
      }
      n += __popc(m);
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  return *count;
}

__device__ __forceinline__ int floor_div16(int v) {
  return v >= 0 ? v / 16 : -((15 - v) / 16);
}

// A consumer thread's view of the pipeline: the ring's barriers and the
// descriptor of its first chunk, its split's chunks as window offsets, and
// its row of the window.
template <int NP>
struct Consumer {
  uint64_t* full;
  uint64_t* empty;
  uint64_t desc;      // wgmma descriptor of the ring's first chunk
  const int* off;     // this split's chunks: byte offsets in the window
  int n;              // their count
  uint32_t wrow;      // the window row of the thread's centres, at its A
                      // bytes (shared address)
  int lane;

  // chunk i's A words: a0 (row g, bytes 4 t .. 4 t + 3 of the k32 slice),
  // a1 (row g + 8), a2 and a3 the same 16 bytes on
  template <int CP>
  __device__ __forceinline__ void load_a(int i, uint32_t (&a)[4]) const {
    const uint32_t p = wrow + off[i];
    a[0] = lds32(p);
    a[1] = lds32(p + 8 * CP);
    a[2] = lds32(p + 16);
    a[3] = lds32(p + 8 * CP + 16);
  }

  template <int CP>
  __device__ __forceinline__ void load_stage(
      int st, uint32_t (&a)[kChunks][4]) const {
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      if (st * kChunks + c < n)
        this->template load_a<CP>(st * kChunks + c, a[c]);
  }

  // stage st (in ring slot SLOT, compile-time): one commit group of its
  // chunks' wgmma from registers a; then, once stage st - 1's group is
  // done, its slot released and stage st + 1's A words read into `next`
  // (stage st - 1's registers) while this group runs
  template <int CP, int SLOT>
  __device__ __forceinline__ void stage(
      int (&acc)[NP / 2], int st, int parity,
      const uint32_t (&a)[kChunks][4], uint32_t (&next)[kChunks][4]) const {
    mbar_wait(&full[SLOT], parity);
    wg_fence();
    pin(acc);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (st * kChunks + c >= n) break;
      wgmma_rs<NP>(acc, a[c],
                   desc + (((SLOT * kChunks + c) * Ring<NP>::kChunkBytes) >>
                           4));
    }
    wg_commit();
    wg_wait<1>();
    pin(acc);
    if (st > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(SLOT + kStages - 1) % kStages]);
    }
    this->template load_stage<CP>(st + 1, next);
  }
};

// Two blocks an SM where the accumulators allow (N 80: at most 96
// registers a thread, so that two blocks' 18 warps fit the four schedulers'
// register files), one with N 144.
template <int CP, int NP>
__global__ void __launch_bounds__(kThreads, NP == 80 ? 2 : 1)
conv_field_i8_kernel(const __grid_constant__ CUtensorMap tm_codes,
                     const __grid_constant__ CUtensorMap tm_b,
                     const unsigned char* __restrict__ nonzero,
                     const float* __restrict__ scales,
                     const long long* __restrict__ origin, int dr, int dc,
                     int dcp, int region, int s_out, int splits,
                     float* __restrict__ out, int* __restrict__ sums) {
  using R = Ring<NP>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ short list[kMaxChunks];
  __shared__ int list_off[kMaxChunks];
  __shared__ __align__(16) unsigned char flags[kMaxChunks];
  __shared__ int listed;
  // the ring's stages on 256 bytes (the 32-byte swizzle's period)
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int rows = window_rows(dr), pitch = window_groups(dcp, CP) * 16;
  unsigned char* ring = smem;
  unsigned char* win = smem + R::kBytes;
  const int body = max(R::kBytes + rows * pitch, R::kReduceBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + body);
  uint64_t* empty = full + kStages;
  uint64_t* win_full = empty + kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cpr = dcp * CP / 32;  // k32 chunks a window row
  const int nchunk = dr * cpr;
  const int group = blockIdx.z / splits, split = blockIdx.z % splits;

  const int y0 = static_cast<int>(origin[0]) - dr / 2 + blockIdx.y * kTileY;
  const int x0 = static_cast<int>(origin[1]) - dc / 2 + blockIdx.x * kTileX;
  const int xg = floor_div16(x0 * CP);  // the window's first 16-byte group
  const int xs = x0 * CP - 16 * xg;     // the first pixel's byte in it
  if (tid == kProducer * 32) {  // the barriers, and the window's box at once
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival a consumer warp
    }
    mbar_init(win_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(win_full, rows * pitch);
    tma_load_3d(win, &tm_codes, 0, xg, y0, win_full);
  }
  const int count = list_chunks(nonzero + group * nchunk, nchunk, cpr, pitch,
                                flags, list, list_off, &listed);
  // (its block barriers publish the barriers' init)
  const int lo = static_cast<int>(static_cast<long long>(count) * split /
                                  splits);
  const int n = static_cast<int>(static_cast<long long>(count) *
                                 (split + 1) / splits) - lo;

  int acc[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc[i] = 0;
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;

  if (warp == kProducer) {
    if (lane == 0) {
      for (int st = 0; st * kChunks < n; ++st) {
        const int slot = st % kStages;
        mbar_wait(&empty[slot], ((st / kStages) & 1) ^ 1);
        const int nv = min(kChunks, n - st * kChunks);
        mbar_expect(&full[slot], nv * R::kChunkBytes);
        for (int c = 0; c < nv; ++c)
          tma_load(ring + (slot * kChunks + c) * R::kChunkBytes, &tm_b, 0,
                   (group * nchunk + list[lo + st * kChunks + c]) * (NP / 4),
                   &full[slot]);
      }
    }
    __syncwarp();
  } else {
    // warp w of warpgroup wg: centre row 4 wg + w of the block, A rows
    // 16 w .. 16 w + 15 of its warpgroup's tile (centre columns 0 .. 15)
    const Consumer<NP> k{
        full, empty, desc_sw32(smem_addr(ring)), list_off + lo, n,
        smem_addr(win + (wg * 4 + w) * pitch + xs + 4 * t + g * CP), lane};
    mbar_wait(win_full, 0);  // also where no chunk is listed: the window's
                             // bytes land before the ring is reused
    uint32_t a0[kChunks][4], a1[kChunks][4];
    const int nstage = (n + kChunks - 1) / kChunks;
    k.template load_stage<CP>(0, a0);
    // the stages in turns of the ring, so that each slot's offsets are
    // compile-time
    static_assert(kStages == 4, "the turn below is unrolled for 4 slots");
    for (int st = 0, parity = 0; st < nstage; st += kStages, parity ^= 1) {
      k.template stage<CP, 0>(acc, st, parity, a0, a1);
      if (st + 1 >= nstage) break;
      k.template stage<CP, 1>(acc, st + 1, parity, a1, a0);
      if (st + 2 >= nstage) break;
      k.template stage<CP, 2>(acc, st + 2, parity, a0, a1);
      if (st + 3 >= nstage) break;
      k.template stage<CP, 3>(acc, st + 3, parity, a1, a0);
    }
    wg_wait<0>();
    pin(acc);
  }

  // the epilogue: pair p = 2 j + h of a consumer thread, its accumulators
  // 2 p (hi) and 2 p + 1 (lo), is row g + 8 h of its warp's 16 (centre
  // column g + 8 h) and columns 8 j + 2 t, + 1 of the group (hi and lo of s)
  const size_t plane = static_cast<size_t>(region) * region;
  const int y = blockIdx.y * kTileY + wg * 4 + w;
  auto put = [&](int p, int hi, int lo_sum) {
    const int col = group * NP + 8 * (p >> 1) + 2 * t, s = col >> 1;
    if (s >= s_out) return;
    const size_t at = static_cast<size_t>(y) * region + blockIdx.x * kTileX +
                      g + 8 * (p & 1);
    out[s * plane + at] = dequant(hi, lo_sum, scales[2 * s],
                                  scales[2 * s + 1]);
    if (sums != nullptr) {
      sums[col * plane + at] = hi;
      sums[(col + 1) * plane + at] = lo_sum;
    }
  };
  if (splits == 1) {
    if (warp < kProducer) {
#pragma unroll
      for (int p = 0; p < NP / 4; ++p) put(p, acc[2 * p], acc[2 * p + 1]);
    }
    return;
  }
  // the cluster's sums: the ring (and window) is free once every consumer
  // is past its products
  int* red = reinterpret_cast<int*>(smem);
  if (warp < kProducer) {
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumerThreads) : "memory");
#pragma unroll
    for (int j = 0; j < NP / 2; ++j) red[j * kConsumerThreads + tid] = acc[j];
  }
  cluster_sync();
  if (warp < kProducer) {
    const int p0 = NP / 4 * split / splits, p1 = NP / 4 * (split + 1) / splits;
    for (int p = p0; p < p1; ++p) {
      int hi = 0, lo_sum = 0;
      for (int k = 0; k < splits; ++k) {
        hi += ld_cluster(red + 2 * p * kConsumerThreads + tid, k);
        lo_sum += ld_cluster(red + (2 * p + 1) * kConsumerThreads + tid, k);
      }
      put(p, hi, lo_sum);
    }
  }
  cluster_sync();  // no block leaves while another reads its sums
}

// The quantization and the layout (see the note at the top).  kernel
// (S_out, CP, dr, dc) float32; qinv (>= CP) float32; partial (groups,
// NP / 2, per_group) float32 scratch, each block's column maxima; b
// (groups, nchunk, NP, 32) int8; nonzero (groups, nchunk) uint8; scales
// (S_out, 2) float32.  Block bg of group g takes the group's chunks [c0,
// c0 + nb), per_group blocks a group.  Its shared memory holds
// `staged_cap` chunks as [chunk][column][32 values of K] (B's row order;
// a tap column past dc is never read), each chunk kChunkWords floats.
template <int CP, int NP>
struct Quant {
  static constexpr int kP = 32 / CP;  // tap columns (dx) a chunk
  static constexpr int kCols = NP / 2;
  static constexpr int kItems = kCols * 8;  // (column, word) items a chunk
  // a staged chunk, 4 floats over its columns' (fewer bank conflicts
  // where a warp's copies span chunks)
  static constexpr int kChunkWords = kCols * 32 + 4;
};

// A (column ss, word w4) item's four values, k = 32 chunk + 4 w4 + j: the
// CP channels of tap column w4 (CP 4), or channels 4 (w4 & 1) + j of tap
// column w4 / 2 (CP 8); q the item's j-th value's qinv.
template <int CP>
__device__ __forceinline__ int item_px(int w4) {
  return CP == 4 ? w4 : w4 >> 1;
}
template <int CP>
__device__ __forceinline__ float item_q(const float (&q)[CP], int w4, int j) {
  if constexpr (CP == 4) {
    return q[j];
  } else {
    return (w4 & 1) ? q[4 + j] : q[j];
  }
}

// q[c] for a c known only at run time, in registers
template <int CP>
__device__ __forceinline__ float pick_q(const float (&q)[CP], int c) {
  float r = q[0];
#pragma unroll
  for (int j = 1; j < CP; ++j) r = c == j ? q[j] : r;
  return r;
}

// A block's chunks [ka, kb) cover one run of each plane (s, c) of the
// kernel, [chunk_off[ka], chunk_off[kb - 1] + chunk_px[kb - 1]): a row's
// last chunk ends at dc, where the next row starts.  Returns its length.
__device__ __forceinline__ int run_len(const int* chunk_off,
                                       const int* chunk_px, int ka, int kb) {
  return chunk_off[kb - 1] + chunk_px[kb - 1] - chunk_off[ka];
}

// Chunks [ka, kb) of the block into shared-memory slots 0.., a warp 32
// consecutive floats of a plane's run at a time (128 bytes), by 4-byte
// cp.async: a plane's run starts anywhere, so no 16-byte copy, bulk copy
// or TMA box applies.  run_dst maps a run position to its slot's word; the
// caller synchronises the block before (the slots' readers are done) and
// waits for the copies.
template <int CP, int NP>
__device__ __forceinline__ void stage_chunks(
    float* staged, int* run_dst, const float* __restrict__ kg, int taps,
    int cols, int ka, int kb, const int* chunk_off, const int* chunk_px) {
  using Q = Quant<CP, NP>;
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < (kb - ka) * Q::kP; i += kQuantThreads) {
    const int k = ka + i / Q::kP, px = i & (Q::kP - 1);
    if (px < chunk_px[k])
      run_dst[chunk_off[k] - chunk_off[ka] + px] =
          (k - ka) * Q::kChunkWords + px * CP;
  }
  __syncthreads();
  const int len = run_len(chunk_off, chunk_px, ka, kb);
  const int segs = (len + 31) / 32, off = chunk_off[ka];
  for (int u = tid >> 5; u < cols * CP * segs; u += kQuantThreads / 32) {
    const int plane = u / segs, pos = (u - plane * segs) * 32 + lane;
    if (pos < len) {
      const float* src = kg + static_cast<size_t>(plane) * taps + off + pos;
      float* dst = staged + run_dst[pos] + (plane / CP) * 32 +
                   (plane & (CP - 1));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_addr(dst)),
                   "l"(src));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The exact int8 of x, a whole number in [-127, 127], as a byte:
// 1.5 2^23 + x is exact, and its low byte is x's two's complement.
__device__ __forceinline__ uint32_t byte_of(float x) {
  return __float_as_uint(__fadd_rn(x, 12582912.0f)) & 0xffu;
}

template <int CP, int NP>
__global__ void __launch_bounds__(kQuantThreads)
conv_quant_i8_kernel(const float* __restrict__ kernel,
                     const float* __restrict__ qinv, int s_out, int dr,
                     int dc, int cpr, int per_group, int staged_cap,
                     float hi_recip, float lo_recip,
                     float* __restrict__ partial, int8_t* __restrict__ b,
                     unsigned char* __restrict__ nonzero,
                     float* __restrict__ scales) {
  using Q = Quant<CP, NP>;
  constexpr int kCols = Q::kCols, kItems = Q::kItems;
  extern __shared__ float4 staged4[];  // [chunk][column][32 values of K]
  float* staged = reinterpret_cast<float*>(staged4);
  __shared__ int chunk_off[kQuantMaxChunks];  // dy dc + kx kP in a plane
  __shared__ int chunk_px[kQuantMaxChunks];   // its tap columns < dc
  __shared__ int chunk_nz[kQuantMaxChunks];
  __shared__ int run_dst[kQuantMaxChunks * 8];
  __shared__ unsigned col_max[kCols];  // the bits of the max |kq| >= 0
  __shared__ float col_scale[2][kCols];
  const int tid = threadIdx.x, lane = tid & 31;
  const int nchunk = dr * cpr, taps = dr * dc;
  const int g = blockIdx.x / per_group, bg = blockIdx.x - g * per_group;
  // bg nchunk < 2^31: per_group <= the SMs, nchunk <= kQuantMaxChunks
  // per_group (the launcher's checks)
  const int c0 = bg * nchunk / per_group;
  const int nb = (bg + 1) * nchunk / per_group - c0;
  const int n_staged = min(nb, staged_cap);
  const int cols = min(kCols, s_out - g * kCols);  // the group's columns
  const float* kg = kernel + static_cast<size_t>(g) * kCols * CP * taps;
  // stamp: start
  if (tid < nb) {
    const int chunk = c0 + tid, dy = chunk / cpr, kx = chunk - dy * cpr;
    chunk_off[tid] = dy * dc + kx * Q::kP;
    chunk_px[tid] = min(Q::kP, dc - kx * Q::kP);
    chunk_nz[tid] = 0;
  }
  if (tid < kCols) col_max[tid] = 0u;
  float q[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) q[c] = __ldg(qinv + c);
  __syncthreads();
  // 1. the chunks shared memory holds
  stage_chunks<CP, NP>(staged, run_dst, kg, taps, cols, 0, n_staged,
                       chunk_off, chunk_px);
  // stamp: copies issued
  // 2. the column maxima of the chunks it does not hold, read while the
  // copies land: a warp 32 consecutive floats of a plane's run, 8 such
  // units at a time; a unit's max, then the block's (an integer max of
  // the bits of non-negative floats: exact, in any order)
  if (n_staged < nb) {
    const int len = run_len(chunk_off, chunk_px, n_staged, nb);
    const int segs = (len + 31) / 32, off = chunk_off[n_staged];
    for (int u0 = (tid >> 5) * 8; u0 < cols * CP * segs;
         u0 += kQuantThreads / 4) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int plane = (u0 + j) / segs;
        const int pos = (u0 + j - plane * segs) * 32 + lane;
        v[j] = 0.0f;
        if (plane < cols * CP && pos < len)
          v[j] = fabsf(__fmul_rn(
              __ldg(kg + static_cast<size_t>(plane) * taps + off + pos),
              pick_q<CP>(q, plane & (CP - 1))));
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float m = v[j];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        const int plane = (u0 + j) / segs;
        if (lane == 0 && plane < cols * CP)
          atomicMax(&col_max[plane / CP], __float_as_uint(m));
      }
    }
  }
  // stamp: unstaged max
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  // stamp: copies landed
  // 3. the held chunks' maxima: an item's 4 values, then its column's 8
  // words' (lanes)
  for (int base = 0; base < n_staged * kItems; base += kQuantThreads) {
    const int i = base + tid, k = i / kItems, r = i - k * kItems;
    const int ss = r >> 3, w4 = r & 7;
    float m = 0.0f;
    if (i < n_staged * kItems && ss < cols &&
        item_px<CP>(w4) < chunk_px[k]) {
      const float4 v = staged4[(k * Q::kChunkWords + ss * 32) / 4 + w4];
      const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        m = fmaxf(m, fabsf(__fmul_rn(a[j], item_q<CP>(q, w4, j))));
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (w4 == 0 && i < n_staged * kItems && ss < cols)
      atomicMax(&col_max[ss], __float_as_uint(m));
  }
  __syncthreads();
  if (tid < cols)
    partial[static_cast<size_t>(g * kCols + tid) * per_group + bg] =
        __uint_as_float(col_max[tid]);
  // stamp: block maxima
  cg::this_grid().sync();
  // stamp: grid barrier
  // 4. a column's maximum over its group's blocks (16 lanes a column, 9
  // reads each in flight at once), amax = max(., 1e-30) and the scales
  for (int s0 = 0; s0 < cols; s0 += kQuantThreads / 16) {
    const int s = s0 + (tid >> 4);
    float m = 0.0f;
    if (s < cols) {
      const float* p =
          partial + static_cast<size_t>(g * kCols + s) * per_group;
      for (int kb0 = tid & 15; kb0 < per_group; kb0 += 16 * 9) {
#pragma unroll
        for (int r = 0; r < 9; ++r)
          if (kb0 + 16 * r < per_group)
            m = fmaxf(m, __ldcg(p + kb0 + 16 * r));
      }
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((tid & 15) == 0 && s < cols) {
      const float amax = fmaxf(m, 1e-30f);
      col_scale[0][s] = __fmul_rn(amax, hi_recip);
      col_scale[1][s] = __fmul_rn(amax, lo_recip);
      if (bg == 0) {
        scales[2 * (g * kCols + s)] = col_scale[0][s];
        scales[2 * (g * kCols + s) + 1] = col_scale[1][s];
      }
    }
  }
  __syncthreads();
  // stamp: scales
  // 5. B from the held chunks, then from the others a shared memory's
  // worth at a time (copied in again, from L2): an item's 4 bytes of its
  // column's hi row and lo row (zeros past the group's columns and past
  // dc), pre-swizzled, and the chunk's flag.  A zero product skips the
  // divisions: its integers are 0, as the divisions give.
  for (int ka = 0; ka < nb; ka += staged_cap) {
    const int n = min(staged_cap, nb - ka);
    if (ka > 0) {
      // stamp: a batch rounded
      __syncthreads();  // the slots' readers are done
      stage_chunks<CP, NP>(staged, run_dst, kg, taps, cols, ka, ka + n,
                           chunk_off, chunk_px);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      // stamp: copied in again
    }
    for (int i = tid; i < n * kItems; i += kQuantThreads) {
      const int k = i / kItems, r = i - k * kItems;
      const int ss = r >> 3, w4 = r & 7;
      uint32_t hi4 = 0, lo4 = 0;
      if (ss < cols && item_px<CP>(w4) < chunk_px[ka + k]) {
        const float4 v4 = staged4[(k * Q::kChunkWords + ss * 32) / 4 + w4];
        const float a[4] = {v4.x, v4.y, v4.z, v4.w};
        const float s_hi = col_scale[0][ss], s_lo = col_scale[1][ss];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float qj = item_q<CP>(q, w4, j), kq = __fmul_rn(a[j], qj);
          if (kq != 0.0f) {
            const float h = fminf(
                fmaxf(rintf(__fdiv_rn(kq, s_hi)), -127.0f), 127.0f);
            const float res = __fmaf_rn(a[j], qj, -__fmul_rn(h, s_hi));
            hi4 |= byte_of(h) << (8 * j);
            if (res != 0.0f)
              lo4 |= byte_of(fminf(
                         fmaxf(rintf(__fdiv_rn(res, s_lo)), -127.0f), 127.0f))
                     << (8 * j);
          }
        }
      }
      // rows 2 ss (hi) and 2 ss + 1 (lo), pre-swizzled: a row's 16-byte
      // halves swap where (row >> 2) is odd
      const int row = 2 * ss;
      int8_t* out =
          b + (static_cast<size_t>(g * nchunk + c0 + ka + k) * NP + row) * 32;
      *reinterpret_cast<uint32_t*>(out + ((w4 * 4) ^ swizzle32(row))) = hi4;
      *reinterpret_cast<uint32_t*>(out + 32 +
                                   ((w4 * 4) ^ swizzle32(row + 1))) = lo4;
      if (hi4 | lo4) chunk_nz[ka + k] = 1;  // every writer writes 1
    }
  }
  // stamp: rounded
  __syncthreads();
  if (tid < nb) nonzero[g * nchunk + c0 + tid] = chunk_nz[tid] != 0;
  // stamp: flags
}

// codes (3-D: 16-byte groups of the rows, rows): boxes of the window
CUresult encode_codes(CUtensorMap* map, const void* codes, int hp, int pitch,
                      int rows, int groups16) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {16, (cuuint64_t)(pitch / 16), (cuuint64_t)hp};
  const cuuint64_t strides[2] = {16, (cuuint64_t)pitch};
  const cuuint32_t box[3] = {16, (cuuint32_t)groups16, (cuuint32_t)rows};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(codes),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// B as rows of 128 bytes: a box a chunk, its NP x 32 bytes (pre-swizzled
// by the quantizer) as NP / 4 rows of 128, copied as they are
CUresult encode_b(CUtensorMap* map, const void* b, int chunks, int np) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {128, (cuuint64_t)chunks * (np / 4)};
  const cuuint64_t strides[1] = {128};
  const cuuint32_t box[2] = {128, (cuuint32_t)(np / 4)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(b),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The kernel of a (CP, NP), or null where it has no instance.
const void* field_fn(int cp, int np) {
  if (cp == 4 && np == 80)
    return reinterpret_cast<const void*>(conv_field_i8_kernel<4, 80>);
  if (cp == 4 && np == 144)
    return reinterpret_cast<const void*>(conv_field_i8_kernel<4, 144>);
  if (cp == 8 && np == 80)
    return reinterpret_cast<const void*>(conv_field_i8_kernel<8, 80>);
  if (cp == 8 && np == 144)
    return reinterpret_cast<const void*>(conv_field_i8_kernel<8, 144>);
  return nullptr;
}

int field_smem_of(int np, int dr, int dcp, int cp) {
  return np == 80 ? field_smem<80>(dr, dcp, cp) : field_smem<144>(dr, dcp, cp);
}

template <int CP, int NP>
int launch_field(const void* codes, int hp, int pitch, const void* b,
                 const void* nonzero, const void* scales, const void* origin,
                 int dr, int dc, int dcp, int region, int s_out, int groups,
                 int splits, void* out, void* sums, cudaStream_t stream) {
  auto kern = conv_field_i8_kernel<CP, NP>;
  const int smem = field_smem<NP>(dr, dcp, CP);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tm_codes, tm_b;
  CUresult res = encode_codes(&tm_codes, codes, hp, pitch, window_rows(dr),
                              window_groups(dcp, CP));
  if (res == CUDA_SUCCESS)
    res = encode_b(&tm_b, b, groups * dr * (dcp * CP / 32), NP);
  if (res != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(res);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(region / kTileX, region / kTileY, groups * splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(
      &cfg, kern, tm_codes, tm_b, static_cast<const unsigned char*>(nonzero),
      static_cast<const float*>(scales),
      static_cast<const long long*>(origin), dr, dc, dcp, region, s_out,
      splits, static_cast<float*>(out), static_cast<int*>(sums));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The quantizer of a (CP, NP), one cooperative launch (see
// tdr_conv_quant_i8).
template <int CP, int NP>
int launch_quant(const void* kernel, const void* qinv, int s_out, int dr,
                 int dc, int dcp, int groups, float hi_recip, float lo_recip,
                 void* partial, long long partial_len, void* b,
                 void* nonzero, void* scales, cudaStream_t stream) {
  auto kern = conv_quant_i8_kernel<CP, NP>;
  constexpr int kChunkBytes = Quant<CP, NP>::kChunkWords * 4;
  // a device's SMs and the most dynamic shared memory a block can take,
  // asked once a device; the blocks an SM holds, asked again where the
  // shared memory changes
  static int ready_dev = -1, sms = 0, smem_max = 0;
  static int occ_smem = -1, per_sm = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != ready_dev) {
    cudaFuncAttributes attr;
    int optin = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);
    if (err == cudaSuccess) {
      smem_max = optin - static_cast<int>(attr.sharedSizeBytes);
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    ready_dev = dev;
    occ_smem = -1;
  }
  // a group's chunks over sms / groups blocks, the first of each block's
  // chunks staged up to the shared memory a block can take
  const int cpr = dcp * CP / 32, nchunk = dr * cpr;
  int per_group = sms / groups;
  per_group = per_group < 1 ? 1 : (per_group > nchunk ? nchunk : per_group);
  const int most = (nchunk + per_group - 1) / per_group;
  const int grid = groups * per_group;
  if (most > kQuantMaxChunks || partial_len < 1LL * grid * (NP / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int staged_cap =
      most < smem_max / kChunkBytes ? most : smem_max / kChunkBytes;
  const int smem = staged_cap * kChunkBytes;
  if (smem != occ_smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kQuantThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    occ_smem = smem;
  }
  if (grid > sms * per_sm)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const float* k = static_cast<const float*>(kernel);
  const float* qv = static_cast<const float*>(qinv);
  float* part = static_cast<float*>(partial);
  int8_t* b8 = static_cast<int8_t*>(b);
  unsigned char* nz = static_cast<unsigned char*>(nonzero);
  float* sc = static_cast<float*>(scales);
  void* args[] = {(void*)&k,    (void*)&qv, &s_out,      &dr,
                  &dc,          (void*)&cpr, &per_group, (void*)&staged_cap,
                  &hi_recip,    &lo_recip,  &part,       &b8,
                  &nz,          &sc};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                    dim3(grid), dim3(kQuantThreads), args,
                                    smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The quantization and layout, one cooperative launch.  kernel (S_out, CP,
// dr, dc) float32 contiguous; qinv (>= CP,) float32; partial float32
// scratch of partial_len values, NP / 2 a block (a launch whose blocks it
// does not hold is refused; one block a chunk at most, groups dr dcp CP /
// 32 blocks, always does); b (groups, dr dcp CP / 32, np, 32) int8, each
// row of 32 bytes pre-swizzled (swizzle32); nonzero (groups, dr dcp CP /
// 32) uint8; scales (S_out, 2) float32; hi_recip, lo_recip f32(1/127),
// f32(1/32258).  CP 4 or 8, np 80 or 144 (conv_score.I8_COLUMNS).
int tdr_conv_quant_i8(const void* kernel, const void* qinv, int s_out, int cp,
                      int dr, int dc, int dcp, int groups, int np,
                      float hi_recip, float lo_recip, void* partial,
                      long long partial_len, void* b, void* nonzero,
                      void* scales, void* stream) {
  if ((cp != 4 && cp != 8) || (np != 80 && np != 144) || (dcp * cp) % 32 ||
      dcp < dc || dcp - dc >= 32 / cp || dc < 1 || dr < 1 || s_out < 1 ||
      groups * np < 2 * s_out || (groups - 1) * np >= 2 * s_out)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TDR_QUANT(CP, NP)                                                  \
  if (cp == CP && np == NP)                                                \
    return launch_quant<CP, NP>(kernel, qinv, s_out, dr, dc, dcp, groups,  \
                                hi_recip, lo_recip, partial, partial_len,  \
                                b, nonzero, scales, s);
  TDR_QUANT(4, 80)
  TDR_QUANT(4, 144)
  TDR_QUANT(8, 80)
  TDR_QUANT(8, 144)
#undef TDR_QUANT
  return static_cast<int>(cudaErrorInvalidValue);
}

// The field.  codes (hp, wp, CP) int8 with a row pitch of `pitch` bytes (a
// multiple of 16) on a 16-byte aligned base; b, nonzero, scales as
// tdr_conv_quant_i8 writes them (np 80 or 144); origin (2,) int64 on the
// card; out (S_out, region, region) float32; sums (2 S_out, region, region)
// int32 or null; win_groups the window's 16-byte groups a row
// (conv_score.i8_window: checked against the kernel's); region a multiple
// of 16; splits 1 to 8 (the blocks of a cluster that share a tile's
// chunks).  Returns the CUDA error, or 1000 + the CUresult of a tensor map's
// encoding.
int tdr_conv_field_i8(const void* codes, int hp, int wp, int pitch, int cp,
                      const void* b, const void* nonzero, const void* scales,
                      const void* origin, int dr, int dc, int dcp, int region,
                      int s_out, int groups, int np, int splits,
                      int win_groups, void* out, void* sums, void* stream) {
  if (region % kTileX || region < kTileX || (cp != 4 && cp != 8) ||
      (dcp * cp) % 32 || dcp < dc || pitch % 16 || pitch < wp * cp ||
      reinterpret_cast<uintptr_t>(codes) % 16 || groups * np < 2 * s_out ||
      dr * dcp * cp / 32 > kMaxChunks || splits < 1 || splits > kMaxSplits ||
      win_groups != window_groups(dcp, cp) || field_fn(cp, np) == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TDR_FIELD(CP, NP)                                                    \
  if (cp == CP && np == NP)                                                  \
    return launch_field<CP, NP>(codes, hp, pitch, b, nonzero, scales, origin, \
                                dr, dc, dcp, region, s_out, groups, splits,  \
                                out, sums, s);
  TDR_FIELD(4, 80)
  TDR_FIELD(4, 144)
  TDR_FIELD(8, 80)
  TDR_FIELD(8, 144)
#undef TDR_FIELD
  return static_cast<int>(cudaErrorInvalidValue);
}

// The blocks (a cluster along z) a tile of centres splits its chunks over:
// as many as one wave of the card holds (the occupancy calculator's blocks
// an SM, for this shape's shared memory, times the SMs, over the tiles), at
// most 8 and at least 1, and no more than lets every tile's cluster be
// resident at once (cudaOccupancyMaxActiveClusters).
int tdr_conv_field_i8_splits(int cp, int np, int dr, int dcp, int region,
                             int groups, int* splits) {
  const void* fn = field_fn(cp, np);
  if (fn == nullptr || region < kTileX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = field_smem_of(np, dr, dcp, cp);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                        smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (region / kTileX) * (region / kTileY) * groups;
  const int fit = sms * per_sm / tiles;
  int sp = fit < 1 ? 1 : (fit > kMaxSplits ? kMaxSplits : fit);
  // fewer where the tiles' clusters do not all fit at once (a cluster's
  // blocks share a GPC)
  for (; sp > 1; --sp) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(region / kTileX, region / kTileY, groups * sp);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = sp;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters >= tiles) break;
  }
  *splits = sp;
  return 0;
}

}  // extern "C"
