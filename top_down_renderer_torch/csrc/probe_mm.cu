// Matrix product probe for Hopper (sm_90a): C = A B^T on the tensor cores,
// in int8 (s32 sums) or bf16 (f32 sums), to put the card's int8 product
// beside its bf16 one at the theta search's work shape.
//
// Replaces the TPU's matrix-unit probes: tests/probe_int8_mm.py::_kernel
// (int8 x int8^T -> int32), probe_int8.py's convert-and-matmul kernel (int8
// crops converted to bf16 times a bf16 M, f32 sums) and probe_dma2.py::kern2
// (each 8-row block of x times the M block that a prefetched index picks).
// On Hopper the index is read by the block that uses it, and the int8 ->
// bf16 conversion happens in registers.
//
// Bound: at the theta search's shape (A 102,400 x 4,096, B 128 x 4,096) the
// product is 107 G operations, 0.054 ms at 1,979 TOP/s int8 and 0.109 ms at
// 989 TFLOP/s bf16, but A's bytes take longer still (0.125 and 0.250 ms at
// 3.35 TB/s): the shape is bound by its bytes, so the design keeps enough of
// A in flight to hold the memory busy.
//
// Two routes; probes/mm.py::plan names them by shape.
//
// Dense (A types s8, bf16, s8_to_bf16): wgmma fed by TMA.
//   - A (M, K) and B (N, K) are K-major, as 8-bit wgmma requires.  Each
//     comes in through a 2-D tensor map with the 128-byte swizzle, in boxes
//     of 128 rows x 128 bytes of K, by cp.async.bulk.tensor into a ring of
//     stages, each with a full and an empty mbarrier.  The converted route
//     takes two B boxes a stage (128 K of bf16 is 256 bytes a row).
//   - One producer warp (one elected lane) keeps the ring full; two
//     consumer warpgroups each compute 64 rows of a 128 x 128 tile of C
//     with wgmma.mma_async at m64n128k32 .s32.s8.s8 or m64n128k16
//     .f32.bf16.bf16, both operands from shared memory.  The converted
//     route reads its int8 A from the stage into registers, converts it to
//     bf16 exactly (a magic-number float, no I2F) and issues the RS form of
//     wgmma (A from registers): it moves int8's bytes at bf16's product.
//     It reads the next stage's A words while the tensor cores work on
//     this one.
//   - The grid is persistent: min(items, SMs) blocks stride over the work
//     items, so one tile's epilogue overlaps the next tile's loads.  The
//     first `whole` tiles are an item each; the rest (the tiles of a last,
//     partial wave, or every tile of a shape too small to fill the card)
//     are split over K into `splits` items each.
//   - TMA fills rows past M and N and a K tail with zeros, so any M and N
//     work, and K need only fill whole 64-byte slabs.
//   - Split K: split s of a tile writes its partial 128 x 128 tile to a
//     scratch block, and a second kernel sums the blocks in split order,
//     so the result is the same bits on every run.
//   The tensor maps are encoded on the host with cuTensorMapEncodeTiled,
//   reached through cudaGetDriverEntryPoint (no -lcuda).
//
// Select (probe_dma2.py::kern2): a B block per 8-row block of A does not fit
// wgmma's 64-row tiles, so it keeps its mma.sync body: a block computes a
// 128 x 128 tile with 8 warps (2 x 4, each 64 x 32: 4 x 4 fragments),
// stepping through K in slabs of 64 bytes a row through a 3-stage ring of
// cp.async copies, rows swizzled by 16-byte chunk for ldmatrix; a block
// takes one 8-row block of A and the B block select[i].

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "tma.cuh"

namespace {

// A's type: int8, bf16, or int8 converted to bf16 on the way in
enum : int { kS8 = 0, kBf16 = 1, kS8ToBf16 = 2 };

// -- the select route: mma.sync ---------------------------------------------
constexpr int kBM = 128, kBN = 128;
constexpr int kSlab = 64;  // bytes of a row of A or B per stage
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kStageBytes = (kBM + kBN) * kSlab;

// the byte offset of 16-byte chunk c of row r in a tile of 64-byte rows
__device__ __forceinline__ int swz(int r, int c) {
  return r * kSlab + ((c ^ ((r >> 1) & 3)) << 4);
}

// 16 bytes global -> shared; zeros where `valid` is false
__device__ __forceinline__ void cp16(void* smem, const void* gmem,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma(const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1, int (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1, float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 bits of an int8 (exact: |v| <= 128 needs 8 significant bits)
__device__ __forceinline__ uint32_t bf16_bits(int v) {
  return __float_as_uint((float)v) >> 16;
}

// C (M, N) = A (M, K) B_g (N, K)^T, the 8-row block i of A times B block
// select[i].  AT: A's type.  C is int32 (int8 A) or float32.
template <int AT>
__global__ void __launch_bounds__(kThreads)
    probe_mm_kernel(const unsigned char* __restrict__ A,
                    const unsigned char* __restrict__ B,
                    const int* __restrict__ select, int M, int N, int K,
                    void* __restrict__ Cout) {
  using Acc = typename std::conditional<AT == kS8, int, float>::type;
  constexpr int kEb = AT == kS8 ? 1 : 2;      // bytes an element in smem
  constexpr int kAeb = AT == kBf16 ? 2 : 1;  // bytes an element of A
  constexpr int kSlabK = kSlab / kEb;         // K elements a stage
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int row0 = blockIdx.y * 8;
  const int rows = min(8, M - row0);
  const int col0 = blockIdx.x * kBN;
  const size_t a_pitch = (size_t)K * kAeb, b_pitch = (size_t)K * kEb;
  const unsigned char* Bg = B + (size_t)select[blockIdx.y] * N * b_pitch;
  const int ktiles = K / kSlabK;

  auto load = [&](int st, int kt) {
    unsigned char* sa = smem + st * kStageBytes;
    unsigned char* sb = sa + kBM * kSlab;
    // B: 128 rows x 4 chunks
    for (int q = tid; q < kBN * 4; q += kThreads) {
      const int r = q >> 2, c = q & 3;
      const bool ok = col0 + r < N;
      cp16(sb + swz(r, c),
           ok ? Bg + (size_t)(col0 + r) * b_pitch + (size_t)kt * kSlab + c * 16
              : Bg,
           ok);
    }
    if constexpr (AT != kS8ToBf16) {
      for (int q = tid; q < kBM * 4; q += kThreads) {
        const int r = q >> 2, c = q & 3;
        const bool ok = r < rows;
        cp16(sa + swz(r, c),
             ok ? A + (size_t)(row0 + r) * a_pitch + (size_t)kt * kSlab +
                      c * 16
                : A,
             ok);
      }
    } else {
      // 128 rows x 2 chunks of 16 int8, each 32 bytes of bf16 in smem
      for (int q = tid; q < kBM * 2; q += kThreads) {
        const int r = q >> 1, h = q & 1;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (r < rows)
          v = __ldg(reinterpret_cast<const uint4*>(
              A + (size_t)(row0 + r) * a_pitch + (size_t)kt * kSlabK +
              h * 16));
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
        uint32_t o[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int b0 = (signed char)(w[j] & 0xff),
                    b1 = (signed char)((w[j] >> 8) & 0xff),
                    b2 = (signed char)((w[j] >> 16) & 0xff),
                    b3 = (signed char)(w[j] >> 24);
          o[2 * j] = bf16_bits(b0) | (bf16_bits(b1) << 16);
          o[2 * j + 1] = bf16_bits(b2) | (bf16_bits(b3) << 16);
        }
        *reinterpret_cast<uint4*>(sa + swz(r, 2 * h)) =
            make_uint4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<uint4*>(sa + swz(r, 2 * h + 1)) =
            make_uint4(o[4], o[5], o[6], o[7]);
      }
    }
  };

  Acc acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();
    const int nk = kt + kStages - 1;
    if (nk < ktiles) load(nk % kStages, nk);
    asm volatile("cp.async.commit_group;\n" ::);

    const unsigned char* sa = smem + (kt % kStages) * kStageBytes;
    const unsigned char* sb = sa + kBM * kSlab;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {  // two 32-byte k-steps a slab
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4(sa + swz(wm * 64 + mt * 16 + (lane & 15), 2 * ks + (lane >> 4)),
                af[mt]);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4(sb + swz(wn * 32 + np * 16 + ((lane >> 4) << 3) + (lane & 7),
                         2 * ks + ((lane >> 3) & 1)),
                bf[np]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma(af[mt], bf[nt >> 1][2 * (nt & 1)],
                      bf[nt >> 1][2 * (nt & 1) + 1], acc[mt][nt]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wm * 64 + mt * 16 + gid + (e >> 1) * 8;
        const int c = col0 + wn * 32 + nt * 8 + tig * 2 + (e & 1);
        if (r < rows && c < N)
          static_cast<Acc*>(Cout)[(size_t)(row0 + r) * N + c] = acc[mt][nt][e];
      }
}

template <int AT>
cudaError_t launch_select(const void* a, const void* b, const int* select,
                          int M, int N, int K, void* c, cudaStream_t stream) {
  static int ready_dev = -1;
  constexpr size_t smem = (size_t)kStages * kStageBytes;
  auto kern = probe_mm_kernel<AT>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != ready_dev) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    ready_dev = dev;
  }
  const dim3 grid((N + kBN - 1) / kBN, M / 8);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const unsigned char*>(a),
      static_cast<const unsigned char*>(b), select, M, N, K, c);
  return cudaGetLastError();
}

// -- the dense routes: wgmma fed by TMA -------------------------------------
constexpr int kBox = 128;                   // rows, and bytes of K, a box
constexpr int kBoxBytes = kBox * kBox;      // 16 KB
constexpr int kConsumers = 2;               // warpgroups, 64 rows of C each
constexpr int kDenseThreads = kConsumers * 128 + 32;  // + the producer warp
constexpr int kAcc = 64;                    // accumulators a thread (N 128)

template <int AT>
struct Dense {
  using Acc = typename std::conditional<AT == kS8, int, float>::type;
  // K elements a stage (one A box of 128 bytes a row)
  static constexpr int kK = AT == kBf16 ? 64 : 128;
  static constexpr int kBBoxes = AT == kS8ToBf16 ? 2 : 1;
  static constexpr int kSteps = 4;  // wgmma k steps a stage (SS routes)
  static constexpr int kStageBytes = kBoxBytes * (1 + kBBoxes);
  static constexpr int kStages = AT == kS8ToBf16 ? 4 : 6;
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
};

// wgmma descriptor of a K-major operand in the 128-byte swizzle that the
// tensor maps write: start address, leading byte offset unused (1), 1,024
// bytes between 8-row groups, layout type 1 (128B).  The box must start on
// 1,024 bytes; a k step within it adds its byte offset to the start.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
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
__device__ __forceinline__ void pin(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define TDR_ACC64                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "    \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "     \
  "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "     \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "     \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "     \
  "%62, %63}"
#define TDR_D4(C, i) \
  "+" C(d[i]), "+" C(d[i + 1]), "+" C(d[i + 2]), "+" C(d[i + 3])
#define TDR_D16(C, i) \
  TDR_D4(C, i), TDR_D4(C, i + 4), TDR_D4(C, i + 8), TDR_D4(C, i + 12)
#define TDR_D64(C) \
  TDR_D16(C, 0), TDR_D16(C, 16), TDR_D16(C, 32), TDR_D16(C, 48)

// d (64 x 128, this thread's 64) += A (64 x 32 int8) B^T, both from smem
__device__ __forceinline__ void wgmma(int (&d)[kAcc], uint64_t a,
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " TDR_ACC64
      ", %64, %65, p;\n}\n"
      : TDR_D64("r")
      : "l"(a), "l"(b));
}

// d += A (64 x 16 bf16) B^T, both from smem
__device__ __forceinline__ void wgmma(float (&d)[kAcc], uint64_t a,
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TDR_ACC64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : TDR_D64("f")
      : "l"(a), "l"(b));
}

// d += A (64 x 16 bf16, registers) B^T (smem): the RS form
__device__ __forceinline__ void wgmma(float (&d)[kAcc],
                                      const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TDR_ACC64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : TDR_D64("f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

#undef TDR_D64
#undef TDR_D16
#undef TDR_D4
#undef TDR_ACC64

// Two int8 of a 32-bit word (bytes 2 h and 2 h + 1) as a bf16 pair, exactly:
// b ^ 0x80 as the low byte of 2^23's float is 2^23 + 128 + b; subtracting
// gives b, whose float's upper half is its bf16.
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t w, int h) {
  const uint32_t x = w ^ 0x80808080u;
  const float f0 =
      __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440 | (2 * h))) -
      8388736.f;
  const float f1 =
      __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7441 | (2 * h))) -
      8388736.f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// Work item i: tile i, all of K, for i < whole; past them, tile whole + j
// / splits, K split s = j % splits (j = i - whole), which covers the K
// stages [s per, min(kb, (s + 1) per)) and writes block s tail + (tile -
// whole) of the scratch.
struct Item {
  int m0, n0, kb0, kb1, block;  // block -1: the tile goes to C
};

__device__ __forceinline__ Item item_of(int i, int ntn, int whole,
                                        int splits, int tail, int kb) {
  if (i < whole)
    return Item{(i / ntn) * kBox, (i % ntn) * kBox, 0, kb, -1};
  const int j = i - whole, t = j / splits, s = j - t * splits;
  const int tile = whole + t, per = (kb + splits - 1) / splits;
  return Item{(tile / ntn) * kBox, (tile % ntn) * kBox, s * per,
              min(kb, (s + 1) * per), s * tail + t};
}

// C (M, N) = A (M, K) B (N, K)^T: the first `whole` tiles into C, the
// others' K splits into 128 x 128 blocks of `scratch`.
template <int AT>
__global__ void __launch_bounds__(kDenseThreads, 1)
    probe_mm_wgmma_kernel(__grid_constant__ const CUtensorMap tmA,
                          __grid_constant__ const CUtensorMap tmB, int M,
                          int N, int K, int whole, int splits,
                          void* __restrict__ C, void* __restrict__ scratch) {
  using D = Dense<AT>;
  using Acc = typename D::Acc;
  extern __shared__ unsigned char smem_raw[];
  // stage buffers on 1,024 bytes, as the 128-byte swizzle needs
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + D::kStages *
                                               D::kStageBytes);
  uint64_t* empty = full + D::kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ntm = (M + kBox - 1) / kBox, ntn = (N + kBox - 1) / kBox;
  const int kb = (K + D::kK - 1) / D::kK;
  const int tail = ntm * ntn - whole;
  const int items = whole + tail * splits;

  if (tid == 0) {
    for (int s = 0; s < D::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers * 4) {  // the producer warp
    if (lane == 0) {
      int stage = 0, phase = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const Item it = item_of(i, ntn, whole, splits, tail, kb);
        for (int k = it.kb0; k < it.kb1; ++k) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * D::kStageBytes;
          mbar_expect(&full[stage], D::kStageBytes);
          tma_load(st, &tmA, k * D::kK, it.m0, &full[stage]);
#pragma unroll
          for (int h = 0; h < D::kBBoxes; ++h)
            tma_load(st + (1 + h) * kBoxBytes, &tmB, k * D::kK + h * 64,
                     it.n0, &full[stage]);
          if (++stage == D::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg computes rows 64 wg .. 64 wg + 63 of the tile
  const int wg = warp >> 2, q = warp & 3, g = lane >> 2, t = lane & 3;
  // the converted route's A words of a stage for this thread: rows r0 and
  // r0 + 8 of its warpgroup's 64 (r0 % 8 == g), in k16 step j (one swizzled
  // 16-byte chunk) the word holding columns 2t, 2t + 1 (word t / 2, half
  // t % 2) and the one holding 2t + 8, 2t + 9 (word 2 + t / 2)
  const int r0 = wg * 64 + q * 16 + g;
  uint32_t raw[8][4];
  auto load_raw = [&](const unsigned char* st) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = ((j ^ g) << 4) + 4 * (t >> 1);
      const uint32_t* lo =
          reinterpret_cast<const uint32_t*>(st + r0 * kBox + c);
      const uint32_t* hi =
          reinterpret_cast<const uint32_t*>(st + (r0 + 8) * kBox + c);
      raw[j][0] = lo[0];
      raw[j][1] = hi[0];
      raw[j][2] = lo[2];
      raw[j][3] = hi[2];
    }
  };
  int stage = 0, phase = 0;
  bool ready = false;  // raw holds the words of `stage`
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const Item it = item_of(i, ntn, whole, splits, tail, kb);
    Acc acc[kAcc];
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[j] = 0;
    for (int k = it.kb0; k < it.kb1; ++k) {
      unsigned char* st = smem + stage * D::kStageBytes;
      const uint32_t b_addr = smem_addr(st + kBoxBytes);
      int next = stage + 1, next_phase = phase;
      if (next == D::kStages) {
        next = 0;
        next_phase ^= 1;
      }
      if constexpr (AT != kS8ToBf16) {
        mbar_wait(&full[stage], phase);
        const uint32_t a_addr = smem_addr(st) + wg * 64 * kBox;
        wg_fence();
        pin(acc);
#pragma unroll
        for (int j = 0; j < D::kSteps; ++j)  // 32 bytes of K a step
          wgmma(acc, desc_sw128(a_addr + 32 * j), desc_sw128(b_addr + 32 * j));
        wg_commit();
        wg_wait_all();
        pin(acc);
      } else {
        if (!ready) {
          mbar_wait(&full[stage], phase);
          load_raw(st);
        }
        uint32_t a[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) a[j][e] = s8x2_to_bf16x2(raw[j][e], t & 1);
        // ping-pong: a warpgroup issues its products once the other has
        // issued its own for the stage before (named barrier 1 + wg), then
        // lets the other go (2 - wg), so that one converts while the
        // other's products run (warpgroup 0 goes first)
        if (wg == 1 || k > it.kb0 || i != (int)blockIdx.x)
          asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");
        wg_fence();
        pin(acc);
#pragma unroll
        for (int j = 0; j < 8; ++j)  // B: 32 bytes at 32 (j % 4) of box j / 4
          wgmma(acc, a[j], desc_sw128(b_addr + (j >> 2) * kBoxBytes +
                                      32 * (j & 3)));
        wg_commit();
        asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg) : "memory");
        // the next stage's A words (this item's or the next one's) while
        // the tensor cores work on this one
        ready = k + 1 < it.kb1 || i + (int)gridDim.x < items;
        if (ready) {
          mbar_wait(&full[next], next_phase);
          load_raw(smem + next * D::kStageBytes);
        }
        wg_wait_all();
        pin(acc);
#pragma unroll
        for (int j = 0; j < 8; ++j) pin(a[j]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      stage = next;
      phase = next_phase;
    }

    // accumulator 4j + 2h + e holds row g + 8h of the warp's 16, column
    // 8j + 2t + e; a tile goes to C (rows and columns past M and N
    // dropped), a split to its whole 128 x 128 block
    Acc* o = static_cast<Acc*>(C) + (size_t)it.m0 * N + it.n0;
    int ld = N, rows = M - it.m0, cols = N - it.n0;
    if (it.block >= 0) {
      o = static_cast<Acc*>(scratch) + (size_t)it.block * kBox * kBox;
      ld = rows = cols = kBox;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wg * 64 + q * 16 + g + 8 * h;
      if (row >= rows) continue;
      Acc* orow = o + (size_t)row * ld;
#pragma unroll
      for (int j = 0; j < kAcc / 4; ++j) {
        const int col = 8 * j + 2 * t;
        if ((ld & 1) == 0) {
          if (col < cols) {
            if constexpr (AT == kS8)
              *reinterpret_cast<int2*>(orow + col) =
                  make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            else
              *reinterpret_cast<float2*>(orow + col) =
                  make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        } else {
          if (col < cols) orow[col] = acc[4 * j + 2 * h];
          if (col + 1 < cols) orow[col + 1] = acc[4 * j + 2 * h + 1];
        }
      }
    }
  }
}

// C's elements of the split tiles (tile whole + t): the sum of their
// scratch blocks s tail + t in split order
template <typename Acc>
__global__ void probe_mm_reduce_kernel(const Acc* __restrict__ scratch,
                                       int M, int N, int whole, int tail,
                                       int splits, Acc* __restrict__ C) {
  const int ntn = (N + kBox - 1) / kBox;
  const size_t count = (size_t)tail * kBox * kBox;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    const int t = (int)(i / (kBox * kBox)), e = (int)(i % (kBox * kBox));
    const int tile = whole + t;
    const int row = (tile / ntn) * kBox + e / kBox;
    const int col = (tile % ntn) * kBox + e % kBox;
    if (row >= M || col >= N) continue;
    Acc s = scratch[i];
    for (int p = 1; p < splits; ++p) s += scratch[(size_t)p * count + i];
    C[(size_t)row * N + col] = s;
  }
}

// A (rows, K) K-major operand, boxes of 128 rows x 128 bytes, 128-B swizzle
CUresult encode_operand(CUtensorMap* map, const void* base, int rows, int K,
                        int elem) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * elem};
  const cuuint32_t box[2] = {(cuuint32_t)(kBox / elem), (cuuint32_t)kBox};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map,
            elem == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            2, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int AT>
int launch_dense(const void* a, const void* b, int M, int N, int K,
                 int whole, int splits, void* scratch, void* c,
                 cudaStream_t stream) {
  using D = Dense<AT>;
  using Acc = typename D::Acc;
  static int ready_dev = -1, sms = 0;
  auto kern = probe_mm_wgmma_kernel<AT>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != ready_dev) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, D::kSmem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    ready_dev = dev;
  }
  CUtensorMap ta, tb;
  CUresult res = encode_operand(&ta, a, M, K, AT == kBf16 ? 2 : 1);
  if (res == CUDA_SUCCESS) res = encode_operand(&tb, b, N, K, AT == kS8 ? 1 : 2);
  if (res != CUDA_SUCCESS) return kEncodeFailed + (int)res;
  const int tail = ((M + kBox - 1) / kBox) * ((N + kBox - 1) / kBox) - whole;
  const int items = whole + tail * splits;
  kern<<<std::min(items, sms), kDenseThreads, D::kSmem, stream>>>(
      ta, tb, M, N, K, whole, splits, c, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess || tail == 0) return (int)err;
  const size_t count = (size_t)tail * kBox * kBox;
  const int blocks = (int)std::min<size_t>((count + 255) / 256, (size_t)sms * 8);
  probe_mm_reduce_kernel<Acc><<<blocks, 256, 0, stream>>>(
      static_cast<const Acc*>(scratch), M, N, whole, tail, splits,
      static_cast<Acc*>(c));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes); returns the CUDA error of its
// launch, or 1000 + the CUresult of cuTensorMapEncodeTiled when a tensor
// map cannot be encoded.  a_type 0: A (M, K) int8, B int8, C int32; 1: A bf16, B bf16, C
// float32; 2: A int8 converted to bf16, B bf16, C float32.  With select (M /
// 8 int32, M a multiple of 8; the select route) B is (G, N, K) row-major and
// the 8-row block i of A takes B block select[i]; else (the dense routes) B
// is (N, K), the first `whole` 128 x 128 tiles of C (row-major tile order)
// are computed whole and each other tile in split_k splits of K, and
// scratch holds split_k x (tiles - whole) blocks of 128 x 128 elements of
// C's type.  K fills 64-byte slabs: a multiple of 64 (int8) or 32 (bf16 and
// the converted int8); A and B start 16-byte aligned.
extern "C" int tdr_probe_mm(const void* a, const void* b, const int* select,
                            int M, int N, int K, int a_type, int whole,
                            int split_k, void* scratch, void* c,
                            void* stream) {
  const int slab_k = a_type == kS8 ? kSlab : kSlab / 2;
  const int tiles = ((M + kBox - 1) / kBox) * ((N + kBox - 1) / kBox);
  if (M < 1 || N < 1 || K < slab_k || K % slab_k || (select && M % 8) ||
      a_type < kS8 || a_type > kS8ToBf16 || split_k < 1 || whole < 0 ||
      whole > tiles || (select && (split_k != 1 || whole != tiles)) ||
      (whole < tiles && !scratch))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (select) {
    switch (a_type) {
      case kS8:
        return (int)launch_select<kS8>(a, b, select, M, N, K, c, s);
      case kBf16:
        return (int)launch_select<kBf16>(a, b, select, M, N, K, c, s);
      default:
        return (int)launch_select<kS8ToBf16>(a, b, select, M, N, K, c, s);
    }
  }
  const int kb = (K + (a_type == kBf16 ? 63 : 127)) / (a_type == kBf16 ? 64
                                                                       : 128);
  if (split_k > kb) return (int)cudaErrorInvalidValue;
  switch (a_type) {
    case kS8:
      return launch_dense<kS8>(a, b, M, N, K, whole, split_k, scratch, c, s);
    case kBf16:
      return launch_dense<kBf16>(a, b, M, N, K, whole, split_k, scratch, c,
                                 s);
    default:
      return launch_dense<kS8ToBf16>(a, b, M, N, K, whole, split_k, scratch,
                                     c, s);
  }
}
