// The theta search's body, shared by csrc/crop_score_init.cu (the production
// kernel, every stage on) and csrc/crop_ablate_init.cu (the same body with
// stages knocked out, to split its time).  Included by both; one copy of the
// code, so that the ablation measures the kernel the filter runs.  What the
// kernel computes and why it is laid out so: see crop_score_init.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "tma.cuh"

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

// The stages a body runs (crop_ablate_init.cu's variants; the production
// kernel is kFull).  A knocked-out stage leaves a result that still depends
// on what stays, so that nvcc cannot drop the stages kept:
//   kOnePlane    A_hi B_hi only: one product a k16 step, not three;
//   kNoGather    no window gather: each row reads one pixel, its centre
//                clamped into its level, once, and every chunk splits and
//                multiplies those values (the ring and the three products
//                stay);
//   kGatherOnly  the ring, the gather and the split, no wgmma: each thread
//                sums its fragments' hi values (into the even columns) and
//                hi + lo (into the odd ones);
//   kRingOnly    the bulk copies and mbarrier waits of the M ring alone:
//                each thread sums |dy| and |dx| of every chunk's first
//                pixel (even and odd columns), no gather and no product;
//   kNoPromote   the six products of a chunk go straight into the fp32
//                accumulators, with no fresh partial sum.
enum : int {
  kFull = 0,
  kOnePlane = 1,
  kNoGather = 2,
  kGatherOnly = 3,
  kRingOnly = 4,
  kNoPromote = 5,
};

// One chunk of M as the wrapper lays it out: hi plane, lo plane, then the
// (dy, dx) int2 offsets of its kChunk / CP pixels.  NP = 1: the single-plane
// M's one plane of integers, then the pixels.
template <int CP, int NP = 2>
struct Chunk {
  static constexpr int kPix = kChunk / CP;
  static constexpr int kPixOff = NP * kPlane;  // bytes before the pixels
  static constexpr int kBytes = kPixOff + kPix * 8;
  static_assert(kBytes % 16 == 0, "bulk copies move multiples of 16 bytes");
};

// Shared memory of the M ring: kStages chunks.
template <int CP, int NP = 2>
constexpr int kRingBytes = kStages * Chunk<CP, NP>::kBytes;

// -- the window route (WIN: every theta search, crop_init_kernel,
// crop_init_i4_kernel and crop_init_lokf_kernel on either map, and the
// ablation's variants that gather, but its `checked`) -------------------------
// A block scores 192 rows of one bucket, which the wrapper orders by the
// position of their centres (crop_score.init_order), so that a warp's rows
// lie close together and their loads hit L1; every row reads the same pixel
// offsets around its own centre.  A warp whose rows' windows all lie in
// their level (each centre plus the bucket's extent, the least and greatest
// dy, dx of its distinct pixels, crop_score.fold_extent; a vote of its
// lanes, so that no branch of the gather splits a warp and the loop keeps
// its wgmma descriptors in uniform registers) reads each pixel at its row's
// base in the level plus the pixel's offset, computed once a chunk at the
// level's row bytes and shared by the thread's two rows, with no bounds
// check.  The other warps, and every bucket's last chunk (its padding
// pixels lie outside every map), keep the checked gather, zeros outside the
// level.  The values loaded, and so every product, are those of the checked
// gather.

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

__device__ __forceinline__ float2 unpack(uint32_t bf2) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bf2));
}

// The code map's A operand (I4).  Its window values are the codes
// themselves, 0-15, exact in bf16, so A needs no lo plane; qinv is folded
// into M's rows by the wrapper (crop_score.fold_qinv).  A thread's four
// fragment pairs of a row (K columns 16 ks + 8 hf + 2t + {0, 1}) hold whole
// pixels: the wrapper permutes each chunk's K rows (crop_score.
// code_chunk_order) so that pair j = 2 ks + hf is chunk row 8t + 2j + {0,
// 1}, i.e. byte j % NB of the chunk's pixel t * (4 / NB) + j / NB, NB =
// CP / 2 code bytes a pixel.  So a thread loads 8 / CP naturally aligned
// words of NB bytes a row (one 4-byte word at CP = 8, two 2-byte words at
// CP = 4) where the float map takes four float2 loads.
template <int CP>
struct Codes {
  static constexpr int kNb = CP / 2;      // code bytes a pixel
  static constexpr int kLoads = 8 / CP;  // pixels a thread loads a row
};

template <int NB>
__device__ __forceinline__ uint32_t load_code_word(const unsigned char* p) {
  if constexpr (NB == 1) {
    return __ldg(p);
  } else if constexpr (NB == 2) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

// bf16x2 (low nibble, high nibble) of a code byte: 0x4300 | n is bf16 128 +
// n, less 128 it is n, exactly.
__device__ __forceinline__ uint32_t code_pair_bf16(uint32_t byte) {
  const uint32_t biased = ((byte * 0x1001u) & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 v = __hsub2(
      *reinterpret_cast<const __nv_bfloat162*>(&biased),
      __floats2bfloat162_rn(128.f, 128.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Block i scores tile i of the bucket-sorted rows.  sched holds row_start
// (K + 1), tile_start (K + 1) and each bucket's chunk count (K); rows are
// positions in the sorted order, perm maps them to particles (null: the
// identity).  Level b of the map is table[b] = (pixel offset, H, W, -), or
// (0, H, W) when table is null.  RAW picks the raw-row epilogue, V the
// stages (kFull: all).  I4: the map is the code map (pixels, CP/2), M the
// code layout's (qinv folded in, chunks permuted; see Codes), and kq the
// known channel's code for a known pixel (15 or 7): the kf column sums
// codes times cell counts, kq times the float map's count.  Only the whole
// body (kFull) reads codes.
//
// ONE: the single-plane M (TDR_M_HILO=0; crop_score.init_m_lokf).  Each
// record holds one plane of integers, exact in bf16, and scales (K, 88)
// the columns' scales: the epilogue multiplies each column's sum by its
// scale before anything else reads it, and takes kf as columns 80 and 81
// (the kf column's residual) scaled and added.  The float map's window is
// multiplied by 1 / qinv[channel] (qinv: the int8 map quantization's, the
// row multipliers M's integers were rounded under) before its bf16 split,
// so that B holds the bare integers: A_hi B + A_lo B, two products a k16
// step; on the codes, exact themselves, A B, one.  kq is not read.
//
// WIN: the window route (above), ext (K) each bucket's extent (dy min,
// dy max, dx min, dx max).
template <int CP, bool RAW, int V, bool I4 = false, bool ONE = false,
          bool WIN = false>
__device__ __forceinline__ void init_body(
    const std::conditional_t<I4, unsigned char, float>* __restrict__ map,
    const int4* __restrict__ table, int H, int W,
    const unsigned char* __restrict__ m,  // (K, cap, Chunk)
    const int* __restrict__ sched, int K, int chunk_cap,
    const int* __restrict__ perm,
    const int2* __restrict__ centers,  // (N) cy, cx
    int S, float inv_tr, float* __restrict__ out, float kq = 1.f,
    const float* __restrict__ scales = nullptr,
    const float* __restrict__ qinv = nullptr,
    const int4* __restrict__ ext = nullptr) {
  static_assert(!I4 || V == kFull, "only the whole body reads codes");
  static_assert(!ONE || V == kFull, "only the whole body takes one plane");
  constexpr bool kGather = V != kNoGather && V != kRingOnly;
  static_assert(!WIN || kGather, "the window route is a gather's");
  constexpr bool kProduct = V != kGatherOnly && V != kRingOnly;
  constexpr bool kPromote = V != kNoPromote;
  // A's lo plane: the float map's split (not the codes, exact)
  constexpr bool kALo = !I4 && V != kOnePlane;
  // B's lo plane: the hi/lo M's
  constexpr bool kBLo = !ONE && V != kOnePlane;
  using Ch = Chunk<CP, ONE ? 1 : 2>;
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

  // WIN: whether every row of this warp lies in its level with its whole
  // window (a vote), the level's row bytes, and the thread's rows' bases
  [[maybe_unused]] bool inside = false;
  [[maybe_unused]] int rb = 0;
  [[maybe_unused]] const unsigned char* gb[2] = {nullptr, nullptr};
  if constexpr (WIN) {
    constexpr int E = I4 ? CP / 2 : CP * 4;  // bytes a pixel
    const int4 e = ext[b];
    const unsigned char* level =
        reinterpret_cast<const unsigned char*>(map) + (size_t)lv.x * E;
    rb = lv.z * E;
    inside = true;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool in = cy[h] + e.x >= 0 && cy[h] + e.y < lv.y &&
                      cx[h] + e.z >= 0 && cx[h] + e.w < lv.z;
      inside = inside && in;
      if (in) gb[h] = level + ((long long)cy[h] * lv.z + cx[h]) * E;
    }
    inside = __all_sync(0xffffffffu, inside);
  }

  // window values of one chunk: [k16 step][column half][row half]; column
  // half 0 holds fragment columns 2t, 2t + 1, half 1 those + 8
  float2 av[2][2][2];
  // I4: the code words of this thread's pixels, [row half][load]
  [[maybe_unused]] uint32_t words[2][Codes<CP>::kLoads];
  // ONE on the float map: 1 / qinv of this thread's two channels, 2t % CP
  // and the next (every fragment column of the thread has them), applied
  // at the split, so that the next chunk's loads stay in flight while the
  // products run
  [[maybe_unused]] float2 rq = make_float2(1.f, 1.f);
  if constexpr (ONE && !I4) {
    const int ch = (2 * t) % CP;
    rq = make_float2(__frcp_rn(__ldg(qinv + ch)),
                     __frcp_rn(__ldg(qinv + ch + 1)));
  }
  // WIN: the gather of two inside rows, no bounds check: each pixel's
  // offset at the level's row bytes once a chunk, then a load a row
  [[maybe_unused]] auto gather_inside = [&](const int2* pix) {
    if constexpr (I4) {
      constexpr int kNb = Codes<CP>::kNb, kLoads = Codes<CP>::kLoads;
#pragma unroll
      for (int l = 0; l < kLoads; ++l) {
        const int2 o = pix[t * kLoads + l];
        const int off = o.x * rb + o.y * kNb;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          words[h][l] = load_code_word<kNb>(gb[h] + off);
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int k = ks * 16 + hf * 8 + 2 * t;  // K row within the chunk
          const int2 o = pix[k / CP];
          const int off = o.x * rb + (o.y * CP + k % CP) * 4;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            av[ks][hf][h] =
                __ldg(reinterpret_cast<const float2*>(gb[h] + off));
        }
      }
    }
  };
  // the window values of chunk kc, on stage s
  auto load_a = [&](int s, [[maybe_unused]] int kc = 0) {
    const int2* pix =
        reinterpret_cast<const int2*>(smem + s * Ch::kBytes + Ch::kPixOff);
    if constexpr (WIN) {  // every pixel real but in the bucket's last chunk
      if (inside && kc + 1 < nchunks) {
        gather_inside(pix);
        return;
      }
    }
    if constexpr (I4) {
      constexpr int kNb = Codes<CP>::kNb, kLoads = Codes<CP>::kLoads;
#pragma unroll
      for (int l = 0; l < kLoads; ++l) {
        const int2 o = pix[t * kLoads + l];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int y = cy[h] + o.x;
          const int x = cx[h] + o.y;
          uint32_t w = 0;
          if ((unsigned)y < (unsigned)lv.y && (unsigned)x < (unsigned)lv.z)
            w = load_code_word<kNb>(
                map + ((size_t)lv.x + (size_t)y * lv.z + x) * kNb);
          words[h][l] = w;
        }
      }
    } else {
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
    }
  };
  if constexpr (V == kNoGather) {  // the centre pixel's channels, once
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int y = min(max(cy[h], 0), lv.y - 1);
      const int x = min(max(cx[h], 0), lv.z - 1);
      const float* p = map + ((size_t)lv.x + (size_t)y * lv.z + x) * CP;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          av[ks][hf][h] = __ldg(reinterpret_cast<const float2*>(
              p + (ks * 16 + hf * 8 + 2 * t) % CP));
    }
  }

  float acc[kAcc], part[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = part[i] = 0.f;
  // the products' target: a fresh partial sum a chunk, or the accumulators
  float(&d)[kAcc] = kPromote ? part : acc;
  // A fragments [k16 step][register]: registers 0-3 hold (row g, cols
  // 2t..), (row g + 8, cols 2t..), (row g, cols 2t + 8..), (row g + 8, ...)
  uint32_t ahi[2][4], alo[2][4];
  // what kGatherOnly and kRingOnly keep: [row half] sums for the even and
  // the odd columns
  float even[2] = {0.f, 0.f}, odd[2] = {0.f, 0.f};

  if (nchunks > 0) {
    mbar_wait(&full[0], 0);
    if constexpr (kGather) load_a(0);
  }
  for (int kc = 0; kc < nchunks; ++kc) {
    const int s = kc % kStages;
    if constexpr (V == kNoGather) {  // split the same values again
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            asm volatile("" : "+f"(av[ks][hf][h].x), "+f"(av[ks][hf][h].y));
    }
    if constexpr (I4) {  // pair j = 2 ks + hf: byte j % NB of load j / NB
      constexpr int kNb = Codes<CP>::kNb;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = 2 * ks + hf;
            ahi[ks][2 * hf + h] = code_pair_bf16(
                (words[h][j / kNb] >> (8 * (j % kNb))) & 0xFFu);
          }
    } else if constexpr (ONE) {  // the window times 1 / qinv, at the split
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 v = av[ks][hf][h];
            split(make_float2(__fmul_rn(v.x, rq.x), __fmul_rn(v.y, rq.y)),
                  ahi[ks][2 * hf + h], alo[ks][2 * hf + h]);
          }
    } else if constexpr (V != kRingOnly) {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            split(av[ks][hf][h], ahi[ks][2 * hf + h], alo[ks][2 * hf + h]);
    }
    if constexpr (V == kGatherOnly) {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 x = unpack(ahi[ks][r]);
          const float2 y = unpack(alo[ks][r]);
          even[r & 1] += x.x + x.y;
          odd[r & 1] += (x.x + y.x) + (x.y + y.y);
        }
    }
    if constexpr (V == kRingOnly) {
      const int2 p0 =
          *reinterpret_cast<const int2*>(smem + s * Ch::kBytes + Ch::kPixOff);
      even[0] += (float)abs(p0.x);
      odd[0] += (float)abs(p0.y);
    }

    if constexpr (kProduct) {
      pin(d);
      wg_fence();
      const uint32_t hi = smem_addr(smem + s * Ch::kBytes);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const uint64_t bh = desc(hi + ks * 2 * kLbo);
        const uint64_t bl = desc(hi + kPlane + ks * 2 * kLbo);
        mma(d, ahi[ks], bh, kPromote && ks == 0);
        if constexpr (kBLo) mma(d, ahi[ks], bl);
        if constexpr (kALo) mma(d, alo[ks], bh);
      }
      wg_commit();
    }
    if (kc + 1 < nchunks) {  // the next chunk's window, while the MMAs run
      const int s1 = (kc + 1) % kStages;
      mbar_wait(&full[s1], ((kc + 1) / kStages) & 1);
      if constexpr (kGather) load_a(s1, kc + 1);
    }
    if constexpr (kProduct) {
      wg_wait_all();
      pin(d);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        pin(ahi[ks]);
        if constexpr (kALo) pin(alo[ks]);
      }
      if constexpr (kPromote) {
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc[i] += part[i];
      }
    }
    __syncthreads();  // every warpgroup is done with stage s
    if (tid == 0 && kc + kStages < nchunks)
      load_chunk(smem + s * Ch::kBytes,
                 mb + (size_t)(kc + kStages) * Ch::kBytes, Ch::kBytes,
                 &full[s]);
    __syncwarp();
  }
  if constexpr (!kProduct) {  // the kept sums in the product's columns
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[4 * j + 2 * h] = even[V == kRingOnly ? 0 : h];
        acc[4 * j + 2 * h + 1] = odd[V == kRingOnly ? 0 : h];
      }
  }

  // epilogue: accumulator 4j + 2h (+1) holds column 8j + 2t (+1) of row
  // g + 8h, i.e. cost (norm) of shift k = 4j + t; column 80 (j 10, t 0)
  // the count of known stencil cells
  if constexpr (ONE) {  // each column's sum times its scale; kf = 80 + 81
    const float* sc = scales + (size_t)b * kCols + 2 * t;
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j) {
      const float2 s2 = *reinterpret_cast<const float2*>(sc + 8 * j);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[4 * j + 2 * h] = __fmul_rn(acc[4 * j + 2 * h], s2.x);
        acc[4 * j + 2 * h + 1] = __fmul_rn(acc[4 * j + 2 * h + 1], s2.y);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      acc[4 * (kKfCol / 8) + 2 * h] = __fadd_rn(
          acc[4 * (kKfCol / 8) + 2 * h], acc[4 * (kKfCol / 8) + 2 * h + 1]);
  }
  if constexpr (RAW) {
    const int width = 2 * S + 1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wrow + g + 8 * h;
      if (row >= row_end) continue;
      float* o = out + (size_t)(perm ? perm[row] : row) * width;
#pragma unroll
      for (int j = 0; j < kMaxSearch / 4; ++j) {
        const int k = 4 * j + t;
        if (k < S) {
          o[2 * k] = acc[4 * j + 2 * h];
          o[2 * k + 1] = acc[4 * j + 2 * h + 1];
        }
      }
      if (t == 0) {
        float cnt = acc[4 * (kKfCol / 8) + 2 * h];
        if constexpr (I4 && !ONE) cnt = cnt / kq;  // exact, as below
        o[2 * S] = cnt;
      }
    }
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float cnt =
        __shfl_sync(0xffffffffu, acc[4 * (kKfCol / 8) + 2 * h], lane & ~3);
    if constexpr (I4 && !ONE) cnt = cnt / kq;  // exact: kq times a count
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

// Launch `kern`, a kernel on init_body<CP, ...>, over the tiles of N
// particles in K buckets with `smem` bytes of dynamic shared memory (at
// least kRingBytes<CP>), opting in to them once per device (*ready_dev: the
// device it was set for).  `extra` follows `out` in the kernel's arguments
// (the code map's known code kq, the single plane's scales and qinv, the
// window route's extents).
template <typename Kernel, typename Map, typename... Extra>
cudaError_t launch_tiles(Kernel kern, int* ready_dev, int smem,
                         const Map* map, const int* table, int H, int W,
                         int K, const void* m, const int* sched,
                         int chunk_cap, const int* perm, const int* centers,
                         int N, int S, float inv_tr, float* out,
                         cudaStream_t stream, Extra... extra) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != *ready_dev) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    *ready_dev = dev;
  }
  // sum_b ceil(n_b / kTile) <= N / kTile + K tiles; blocks past the last
  // tile return at once
  kern<<<N / kTile + K, kThreads, smem, stream>>>(
      map, reinterpret_cast<const int4*>(table), H, W,
      static_cast<const unsigned char*>(m), sched, K, chunk_cap, perm,
      reinterpret_cast<const int2*>(centers), S, inv_tr, out, extra...);
  return cudaGetLastError();
}

// The arguments every entry point checks: 1..40 shifts, 1..12 buckets.
inline bool valid_search(int S, int K) {
  return S >= 1 && S <= kMaxSearch && K >= 1 && K <= kMaxBuckets;
}

}  // namespace
