// Matrix product probe for Hopper (sm_90a): C = A B^T on the tensor cores
// with mma.sync, in int8 (s32 sums) or bf16 (f32 sums), to put the card's
// int8 product beside its bf16 one at the theta search's work shape.
//
// Replaces the TPU's matrix-unit probes: tests/probe_int8_mm.py::_kernel
// (int8 x int8^T -> int32), probe_int8.py's convert-and-matmul kernel (int8
// crops converted to bf16 times a bf16 M, f32 sums) and probe_dma2.py::kern2
// (each 8-row block of x times the M block that a prefetched index picks).
// On Hopper the index is read by the block that uses it, and the int8 ->
// bf16 conversion happens in registers on the way to shared memory.
//
// Design: a block computes a 128 x 128 tile of C with 8 warps (2 x 4, each
// 64 x 32: 4 x 4 fragments), stepping through K in slabs of 64 bytes a row
// (64 int8 or 32 bf16) through a 3-stage ring of cp.async copies in shared
// memory, rows swizzled by 16-byte chunk so that ldmatrix reads them
// without bank conflicts.  In bytes the m16n8k32 s8 and the m16n8k16 bf16
// fragments have one layout, so one ldmatrix path feeds both.  Rows of A
// and B beyond M and N read as zeros, so any M and N work (row 13's 48
// rows); K must fill whole slabs.  With `select`, a block takes one 8-row
// block of A and the B block select[i] (rows 8-127 of its tile are zeros).
//
// Bound: at the theta search's shape (A 102,400 x 4,096, B 128 x 4,096)
// the product is 107 G operations, 0.054 ms at 1,979 TOP/s int8 and 0.109
// ms at 989 TFLOP/s bf16, but A's bytes take longer still (0.125 and 0.250
// ms at 3.35 TB/s): the shape is bound by its bytes.  mma.sync reaches
// below wgmma's rate; torch._int_mm and torch.matmul are the yardsticks.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBM = 128, kBN = 128;
constexpr int kSlab = 64;  // bytes of a row of A or B per stage
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kStageBytes = (kBM + kBN) * kSlab;

// A's type: int8, bf16, or int8 converted to bf16 on the way in
enum : int { kS8 = 0, kBf16 = 1, kS8ToBf16 = 2 };

// the byte offset of 16-byte chunk c of row r in a tile of 64-byte rows
__device__ __forceinline__ int swz(int r, int c) {
  return r * kSlab + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
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

// C (M, N) = A (M, K) B_g (N, K)^T.  AT: A's type; SEL: B block per 8-row
// block of A (select).  C is int32 (int8 A) or float32.
template <int AT, bool SEL>
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
  const int row0 = SEL ? blockIdx.y * 8 : blockIdx.y * kBM;
  const int rows = min(SEL ? 8 : kBM, M - row0);
  const int col0 = blockIdx.x * kBN;
  const size_t a_pitch = (size_t)K * kAeb, b_pitch = (size_t)K * kEb;
  const unsigned char* Bg =
      B + (SEL ? (size_t)select[blockIdx.y] * N * b_pitch : 0);
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

template <int AT, bool SEL>
cudaError_t launch(const void* a, const void* b, const int* select, int M,
                   int N, int K, void* c, cudaStream_t stream) {
  static int ready_dev = -1;
  constexpr size_t smem = (size_t)kStages * kStageBytes;
  auto kern = probe_mm_kernel<AT, SEL>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != ready_dev) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    ready_dev = dev;
  }
  const dim3 grid((N + kBN - 1) / kBN, SEL ? M / 8 : (M + kBM - 1) / kBM);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const unsigned char*>(a),
      static_cast<const unsigned char*>(b), select, M, N, K,
      c);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes); returns the CUDA error of its
// launch.  a_type 0: A (M, K) int8, B int8, C int32; 1: A bf16, B bf16, C
// float32; 2: A int8 converted to bf16, B bf16, C float32.  B is (G, N, K)
// row-major: with select (M / 8 int32, M a multiple of 8) the 8-row block i
// of A takes B block select[i], else G = 1.  K fills 64-byte slabs: a
// multiple of 64 (int8) or 32 (bf16 and the converted int8); the rows of A
// and B start 16-byte aligned.
extern "C" int tdr_probe_mm(const void* a, const void* b, const int* select,
                            int M, int N, int K, int a_type, void* c,
                            void* stream) {
  const int slab_k = a_type == kS8 ? kSlab : kSlab / 2;
  if (M < 1 || N < 1 || K < slab_k || K % slab_k || (select && M % 8) ||
      a_type < kS8 || a_type > kS8ToBf16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TDR_MM_CASE(AT)                                                    \
  case AT:                                                                 \
    return (int)(select ? launch<AT, true>(a, b, select, M, N, K, c, s)    \
                        : launch<AT, false>(a, b, select, M, N, K, c, s));
  switch (a_type) {
    TDR_MM_CASE(kS8)
    TDR_MM_CASE(kBf16)
    TDR_MM_CASE(kS8ToBf16)
  }
#undef TDR_MM_CASE
  return (int)cudaErrorInvalidValue;
}
