// The tracked crop kernel's body, shared by csrc/crop_score.cu (the
// production kernel, every stage on) and csrc/crop_ablate.cu (the same body
// with stages knocked out, to split its time).  Included by both; one copy
// of the code, so that the ablation measures the kernel the filter runs.
// What the kernel computes and why it is laid out so: see crop_score.cu.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "tma.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;  // particles per block: TRACKED_TILE
constexpr int kMaxBuckets = 12;
// slabs of the weights table in a single-plane block's ring: one keeps two
// blocks an SM at the crop stencils' Th*R = 2,500, where two take a third
// more shared memory and leave one, and measured slower; the next run's
// copy overlaps the current run's gather either way
// (tests/time_torch_tracked.py --slabs 2 builds the other ring)
constexpr int kSlabs = 1;

// The stages a body runs (crop_ablate.cu's variants; the production kernel
// is kFull).  A knocked-out stage leaves an output that still depends on
// what stays, so that nvcc cannot drop the stages kept:
//   kNoFold      the weights and pixels are folded for the block's first run
//                only and reused for every later run;
//   kNoGather    each lane reads one pixel, the particle's centre clamped
//                into its level, in place of its own (the FMAs stay, the
//                scattered loads go);
//   kGatherOnly  the pixels are summed without weights (no weight fold);
//   kFoldOnly    the weights are folded per run, and each particle writes
//                one folded pixel's weights (no pixel loop);
//   kChecked     every stage, but every row through the bounds-checked
//                loop, one row a warp (no unchecked loop, no pairs): the
//                loop the float kernel ran before its rows went inside.
enum : int {
  kFull = 0,
  kNoFold = 1,
  kNoGather = 2,
  kGatherOnly = 3,
  kFoldOnly = 4,
  kChecked = 5,
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// channels per pixel of the compact map at C classes (channel_pad)
template <int C>
struct Pixel {
  static constexpr int CP = C + 1 <= 2 ? 2 : (C + 1 <= 4 ? 4 : 8);
};

template <int CP>
__device__ __forceinline__ void load_pixel(const float* p, float (&v)[CP]) {
  if constexpr (CP == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = a.x; v[1] = a.y;
  } else {
    const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int h = 0; h < CP / 4; ++h) {
      const float4 a = __ldg(q + h);
      v[4 * h] = a.x; v[4 * h + 1] = a.y; v[4 * h + 2] = a.z;
      v[4 * h + 3] = a.w;
    }
  }
}

// The pixel's values from the code map (crop_score.compact_codes): its CP/2
// bytes in one load, byte j holding channel 2j in its low nibble and 2j + 1
// in its high one.  A byte permute puts code c into the mantissa of 2^23,
// x = 2^23 + c, and fma(x, q, -2^23 q) rounds c * q once: each channel's
// code times its qinv in float32, the value crop_score.dequantize_int4
// gives the plain version, in two instructions without the conversion
// unit.  The float kernel's arithmetic follows on those values.  STAGED:
// p points into a window staged in shared memory (a plain load), else
// into the map (a load through the read-only cache).
template <int C, int CP, bool STAGED = false>
__device__ __forceinline__ void load_codes(const unsigned char* p,
                                           const float (&q)[CP],
                                           const float (&nq)[CP],
                                           float (&v)[CP]) {
  unsigned w;
  if constexpr (STAGED) {
    if constexpr (CP == 2)
      w = *p;
    else if constexpr (CP == 4)
      w = *reinterpret_cast<const unsigned short*>(p);
    else
      w = *reinterpret_cast<const unsigned int*>(p);
  } else if constexpr (CP == 2) {
    w = __ldg(p);
  } else if constexpr (CP == 4) {
    w = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    w = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  // the even channels' codes, byte by byte, and the odd ones'
  const unsigned lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
#pragma unroll
  for (int ch = 0; ch <= C; ++ch)
    v[ch] = fmaf(__int_as_float(__byte_perm(ch % 2 ? hi : lo, 0x4B000000u,
                                            0x7650u | (ch / 2))),
                 q[ch], nq[ch]);
}

// -- the rows' centres and the code map's window ---------------------------
// The hi/lo bodies (crop_tracked_kernel, crop_tracked_i4_kernel and the
// ablation) keep their block's rows' centres and the bucket's extent here:
// a row whose centre +- the extent lies in its level is inside, and skips
// the bounds check.  The code kernel also stages a window here.
// A block of the code kernel scores its rows of one bucket from a window of
// the bucket's level staged in shared memory: the box of the rows' centres
// +- the extent of the bucket's distinct pixels, clipped to the level, each
// of its rows one 1-D bulk copy from the 16-byte boundary at or below the
// row's first byte to the one at or above its last.  Row i of the box
// starts at byte c0 + i pitch of the window, c0 its first byte's place in
// its 16-byte word, and pitch = (W bytes) mod 16 plus a multiple of 16 at
// least its bytes + 30: each row keeps its skew within its 16 bytes, no two
// rows' copies meet, and pixel (y, x) lies at c0 + (y - y0) pitch + (x -
// x0) E, linear in y and x.  Where the window takes more than the bytes the
// block has for it (cap), or the last row's rounded end would pass the code
// buffer's end, the block gathers from L2 as before: a route chosen per
// block and bucket by the window's size, the same in
// crop_score.tracked_windows (the plain rule).  The wrapper orders each
// group's rows by position (crop_score.tracked_order), so that a block's
// rows lie close together and its window is small.
struct __align__(16) Window {
  int4 ext[kWarps];  // each warp's (dy min, dy max, dx min, dx max)
  int2 ctr[kTile];   // the block's rows' centres
  uint64_t bar;      // the copies' mbarrier
  int4 e;            // the bucket's extent, as ext
  // the current bucket's window: its first row and column, c0, pitch, and
  // its route
  int y0, x0, c0, pitch, staged;
};

// The stride of the pixel offsets and weights in shared memory: the
// largest bucket's distinct pixels rounded up to 8 (the table in global
// memory keeps its stride P).
__device__ __forceinline__ int tight_stride(const int* npix, int K) {
  int m = 0;
  for (int b = 0; b < K; ++b) m = max(m, __ldg(npix + b));
  return (m + 7) & ~7;
}

// Warp 0 of a block: the window of bucket b for the block's rows from run0
// of that bucket (their keys in s_key are groups b Th + shift, the rows of
// the next bucket from group (b + 1) Th up) on level lv = (pixel offset, H,
// W, -) of the code map (pixels of E bytes, `pixels` of them, 16-byte
// aligned), the extents in win->ext; where it fits cap bytes, its rows'
// bulk copies into dst on win->bar (one arrival that expects their bytes).
// Lane 0 records the extent and the window in win.
template <int E>
__device__ void stage_window(Window* win, const int* s_key, int run0,
                             int rows, int Th, int b, int4 lv,
                             const unsigned char* map, int pixels,
                             unsigned char* dst, int cap) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int4 c = make_int4(INT_MAX, INT_MIN, INT_MAX, INT_MIN);
  for (int r = run0 + lane; r < rows && s_key[r] < (b + 1) * Th; r += 32) {
    const int2 p = win->ctr[r];
    c = make_int4(min(c.x, p.x), max(c.y, p.x), min(c.z, p.y), max(c.w, p.y));
  }
  int4 e = lane < kWarps ? win->ext[lane]
                         : make_int4(INT_MAX, INT_MIN, INT_MAX, INT_MIN);
  e = make_int4(__reduce_min_sync(full, e.x), __reduce_max_sync(full, e.y),
                __reduce_min_sync(full, e.z), __reduce_max_sync(full, e.w));
  // in 64 bits: centres and offsets may lie far off the level
  using ll = long long;
  const ll y0 = max((ll)__reduce_min_sync(full, c.x) + e.x, 0LL);
  const ll y1 = min((ll)__reduce_max_sync(full, c.y) + e.y, (ll)lv.y - 1);
  const ll x0 = max((ll)__reduce_min_sync(full, c.z) + e.z, 0LL);
  const ll x1 = min((ll)__reduce_max_sync(full, c.w) + e.w, (ll)lv.z - 1);
  const ll span = (x1 - x0 + 1) * E;
  const ll first = ((ll)lv.x + y0 * lv.z + x0) * E;  // byte (y0, x0)
  const int c0 = (int)(first & 15);
  const int pitch = (int)(((span + 45) & ~15LL) + ((ll)lv.z * E & 15));
  int staged = 0;
  if (cap > 0 && y0 <= y1 && x0 <= x1) {
    const ll last = ((ll)lv.x + y1 * lv.z + x1 + 1) * E;
    staged = (y1 - y0 + 1) * pitch + 16 <= cap &&
             ((last + 15) & ~15LL) <= (ll)pixels * E;
  }
  if (staged) {
    const int n = (int)(y1 - y0 + 1);
    const ll row = (ll)lv.z * E;
    int bytes = 0;
    for (int i = lane; i < n; i += 32) {
      const ll s = first + i * row;
      bytes += (int)(((s + span + 15) & ~15LL) - (s & ~15LL));
    }
    bytes = __reduce_add_sync(full, bytes);
    if (lane == 0) mbar_expect(&win->bar, bytes);
    __syncwarp();
    for (int i = lane; i < n; i += 32) {
      const ll s = first + i * row;
      const ll a0 = s & ~15LL;
      bulk_copy(dst + ((c0 + i * pitch) & ~15), map + a0,
                (int)(((s + span + 15) & ~15LL) - a0), &win->bar);
    }
  }
  if (lane == 0) {
    win->e = e;
    win->y0 = (int)y0;
    win->x0 = (int)x0;
    win->c0 = c0;
    win->pitch = pitch;
    win->staged = staged;
  }
}

// -- the single-plane M (TDR_M_HILO=0; crop_score.tracked_lokf) -----------
// One pixel's weights w (C + 2) from its integers q (lokf_ints) and its
// group's scales sc: the float map's (q s) / qinv[ch] for its values (rq
// = 1 / qinv), the code map's q s for its codes; the kf weight q_kf s_kf +
// q_lo s_lo (times rq[C] on the float map).  crop_score.tracked_lokf_weights
// in the same float32 operations.
template <int C, bool I4>
__device__ __forceinline__ void lokf_dequant(const float (&q)[C + 3],
                                             float4 sc,
                                             const float (&rq)[C + 1],
                                             float (&w)[C + 2]) {
#pragma unroll
  for (int ch = 0; ch < C; ++ch)
    w[ch] = I4 ? __fmul_rn(q[ch], sc.x)
               : __fmul_rn(__fmul_rn(q[ch], sc.x), rq[ch]);
  w[C] = I4 ? __fmul_rn(q[C], sc.y) : __fmul_rn(__fmul_rn(q[C], sc.y), rq[C]);
  const float k = __fadd_rn(__fmul_rn(q[C + 1], sc.z),
                            __fmul_rn(q[C + 2], sc.w));
  w[C + 1] = I4 ? k : __fmul_rn(k, rq[C]);
}

// Copy group g's slab of the weights table wtab (groups, C + 3, P) int16
// into shared memory at dst (C + 3, P), each row's first u8 entries (its
// bucket's distinct pixels rounded up to 8: whole 16-byte bulk copies),
// and its scales (float4) into *sc, on one arrival of mbarrier bar that
// expects all their bytes.
template <int C>
__device__ __forceinline__ void fetch_group(const short* wtab,
                                            const float* scales, int g,
                                            int P, int u8, short* dst,
                                            float4* sc, uint64_t* bar) {
  const int bytes = u8 * (int)sizeof(short);
  mbar_expect(bar, (C + 3) * bytes + (int)sizeof(float4));
  const short* src = wtab + (size_t)g * (C + 3) * P;
#pragma unroll
  for (int e = 0; e < C + 3; ++e)
    bulk_copy(dst + e * P, src + (size_t)e * P, bytes, bar);
  bulk_copy(sc, scales + 4 * (size_t)g, (int)sizeof(float4), bar);
}

// The element of the map a body reads: float32 channels, or with I4 the
// nibble-packed codes (CP/2 bytes a pixel).
template <bool I4>
using MapElem = std::conditional_t<I4, unsigned char, float>;

// Dynamic shared memory of a block: the group's pixel offsets (P int2), its
// folded weights (C + 2, P) and the scan tables (C + 1, Th*R).  The code
// kernel lays the same out at its tight stride (tight_stride, <= P) and
// takes the bytes past them, to the end of its launch's shared memory, for
// its window.
template <int C>
size_t smem_bytes(int TR, int P) {
  return (size_t)P * sizeof(int2) + (size_t)(C + 2) * P * sizeof(float) +
         (size_t)(C + 1) * TR * sizeof(float);
}

// ... and of a single-plane block: the pixel offsets and weights, then in
// place of the scan tables kSlabs slabs of the weights table, each (C + 3,
// P) int16 with its group's scales (float4), and their mbarriers.
template <int C>
size_t lokf_smem_bytes(int P) {
  return (size_t)P * sizeof(int2) + (size_t)(C + 2) * P * sizeof(float) +
         (size_t)kSlabs * ((C + 3) * P * sizeof(short) + sizeof(float4) +
                           sizeof(uint64_t));
}

// Block i scores sorted rows [i kTile, (i + 1) kTile): skey[row] is the
// group bucket * Th + shift of particle perm[row].  pix (K, P): bucket b's
// npix[b] distinct offsets; order (K*Th*R) and seg (K*P + 1): the cells
// b*Th*R + i on slot b*P + u are order[seg[b*P+u] .. seg[b*P+u+1]).  Level
// b of the map is table[b] = (pixel offset, H, W, -), or (0, H, W) when
// table is null.  V picks the stages (kFull: all).  I4: the map is the code
// map (pixels, CP/2) and qinv (8) its dequantization multipliers
// (load_codes); only the whole body (kFull) reads codes.
//
// LOKF: the single-plane M (TDR_M_HILO=0).  qinv (8) is the map
// quantization's (the int8 map's for the float map, the codes' for the code
// map), wtab (K*Th, C + 3, P) int16 each group's integers and scales (K,
// Th, 4) its scales, both from the weights pass (crop_score.tracked_table).
// No scan, cw, order or seg: a run's weights are not folded but copied,
// its group's slab by bulk copies into a ring of kSlabs slabs on one
// mbarrier each, the next runs' copies in flight while the warps gather,
// and dequantized into the weights (lokf_dequant); s_pix is reloaded only
// where the bucket changes.  The code map's codes are weighed as they are
// (q = 1 in load_codes), not dequantized.
//
// Without LOKF (the hi/lo M, on either map): skey holds the group in its
// bits from kshift up and the row's place in the group's position order
// below (crop_score.tracked_order; kshift 0: tracked_rows' keys); s_key
// keeps the group, win->ctr the rows' centres.  At each bucket change the
// block loads the bucket's pixel offsets and their extent (win->e); a row
// whose centre +- the extent lies in its level reads pixel u at its own
// base plus u's offset with no bounds check, and a warp scores two such
// rows at once, each pixel's offset and weights read once for both;
// every other row takes the checked loop.  Each row's sums run in the
// same order on either route, so the output is the checked loop's bit for
// bit.
// (kChecked and kFoldOnly keep the checked loop for every row.)
//
// I4 without LOKF (crop_tracked_i4_kernel) also stages the code map's
// window (Window, stage_window).  s_pix and the weights take the stride
// tight_stride(npix, K), and the window the bytes from the end of the scan
// tables to smem_size, at most budget (0: every block gathers from L2).
// At each bucket change warp 0 stages the window (its copies start before
// the fold, which hides them), and the block waits for them after the
// fold; the lanes then read each pixel's codes from the window, under the
// same level bounds check.  The codes read, and so the arithmetic and the
// output, are those of the gather from L2.
template <int C, int V, bool I4 = false, bool LOKF = false>
__device__ __forceinline__ void tracked_body(
    const MapElem<I4>* __restrict__ map,  // (pixels, CP) or (pixels, CP/2)
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
    int N, float inv_tr, float* __restrict__ out,
    const float* __restrict__ qinv = nullptr,
    const float* __restrict__ scales = nullptr,
    const short* __restrict__ wtab = nullptr, Window* win = nullptr,
    int kshift = 0, int K = 1, int pixels = 0, int budget = 0,
    int smem_size = 0) {
  constexpr int CP = Pixel<C>::CP;
  constexpr int kPixelElems = I4 ? CP / 2 : CP;  // map elements a pixel
  static_assert(!I4 || V == kFull, "only the whole body reads codes");
  static_assert(!LOKF || V == kFull, "only the whole body has one plane");
  constexpr bool kWeights = V != kGatherOnly;  // folds the weights
  // the unchecked loop for rows inside their level
  constexpr bool kInside = !LOKF && V != kChecked && V != kFoldOnly;
  constexpr bool kWin = I4 && !LOKF;  // stages windows of codes
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_key[kTile];
  const int TR = Th * R;
  // the stride of s_pix and s_w
  int SP = P;
  if constexpr (kWin) SP = tight_stride(npix, K);
  int2* s_pix = reinterpret_cast<int2*>(smem);
  float* s_w = reinterpret_cast<float*>(s_pix + SP);
  float* s_ws = s_w + (C + 2) * SP;
  float* s_ss = s_ws + C * TR;
  // kWin: the window, 16-byte aligned after the scan tables, and its bytes
  [[maybe_unused]] unsigned char* s_win = nullptr;
  [[maybe_unused]] int cap = 0;
  if constexpr (kWin) {
    const int woff =
        (int)(reinterpret_cast<unsigned char*>(s_ss + TR) - smem + 15) & ~15;
    s_win = smem + woff;
    cap = max(0, min(budget, smem_size - woff));
  }
  // LOKF: the slabs of the weights table where the scan tables would be,
  // then their scales and mbarriers
  [[maybe_unused]] short* s_slab = reinterpret_cast<short*>(s_ws);
  [[maybe_unused]] float4* s_sc =
      reinterpret_cast<float4*>(s_slab + (size_t)kSlabs * (C + 3) * P);
  [[maybe_unused]] uint64_t* s_bar =
      reinterpret_cast<uint64_t*>(s_sc + kSlabs);

  const int row0 = blockIdx.x * kTile;
  const int rows = min(kTile, N - row0);
  // LOKF: the copy of group g's slab into slab i (fetch_group)
  [[maybe_unused]] auto fetch = [&](int g, int i) {
    fetch_group<C>(wtab, scales, g, P, (npix[g / Th] + 7) & ~7,
                   s_slab + (size_t)i * (C + 3) * P, s_sc + i, s_bar + i);
  };
  if constexpr (LOKF) {  // the first run's copy starts while the keys stage
    if (threadIdx.x == 0) {
      for (int i = 0; i < kSlabs; ++i) mbar_init(s_bar + i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      fetch(skey[row0], 0);
    }
  }
  if constexpr (kWin) {
    if (threadIdx.x == 0) {
      mbar_init(&win->bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  // the weighted scan 0.01 w_c scan_c and its class sum, in class order
  // (as crop_score's plain version computes them)
  if constexpr (kWeights && !LOKF) {
    for (int i = threadIdx.x; i < TR; i += kThreads) {
      float sum = 0.f;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        const float v = scan[ch * TR + i];
        s_ws[ch * TR + i] = v * (0.01f * cw[ch]);
        sum = ch ? sum + v : v;
      }
      s_ss[i] = sum;
    }
  }
  if constexpr (kInside) {  // the groups, and the rows' centres
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      s_key[r] = skey[row0 + r] >> kshift;
      win->ctr[r] = centers[perm[row0 + r]];
    }
  } else if constexpr (!LOKF) {
    for (int r = threadIdx.x; r < rows; r += kThreads)
      s_key[r] = skey[row0 + r] >> kshift;
  } else {
    for (int r = threadIdx.x; r < rows; r += kThreads)
      s_key[r] = skey[row0 + r];
  }
  __syncthreads();
  // LOKF, thread 0: the first sorted row of the next run to copy (the end of
  // the run of one key that starts at row r: run_end(r)); the first kSlabs
  // runs' copies start here
  [[maybe_unused]] auto run_end = [&](int r) {
    const int g = s_key[r];
    while (++r < rows && s_key[r] == g) {
    }
    return r;
  };
  [[maybe_unused]] int next = 0;
  if constexpr (LOKF) {
    if (threadIdx.x == 0) {
      next = run_end(0);
      for (int i = 1; i < kSlabs && next < rows; ++i) {
        fetch(s_key[next], i);
        next = run_end(next);
      }
    }
  }

  const int lane = threadIdx.x & 31;
  // I4: the channels' multipliers, and -2^23 times them (exact)
  [[maybe_unused]] float q[CP], nq[CP];
  if constexpr (I4) {
#pragma unroll
    for (int ch = 0; ch <= C; ++ch) {
      q[ch] = LOKF ? 1.f : __ldg(qinv + ch);  // LOKF: the codes as they are
      nq[ch] = -8388608.0f * q[ch];
    }
  }
  // LOKF: 1 / qinv of the float map's channels
  [[maybe_unused]] float rq[C + 1];
  if constexpr (LOKF) {
#pragma unroll
    for (int ch = 0; ch <= C; ++ch) rq[ch] = __frcp_rn(__ldg(qinv + ch));
  }
  int U = 0;  // distinct pixels of the folded group
  // LOKF, kInside: the bucket whose pixels s_pix holds
  [[maybe_unused]] int pb = -1;
  [[maybe_unused]] int nst = 0;  // kWin: the windows staged and waited for
  for (int run0 = 0, nrun = 0; run0 < rows; ++nrun) {
    const int g = s_key[run0];
    int run1 = run0 + 1;
    while (run1 < rows && s_key[run1] == g) ++run1;
    const int b = g / Th;
    if constexpr (LOKF) {  // run nrun's slab i, and its copy's phase
      const int i = nrun % kSlabs;
      mbar_wait(s_bar + i, (nrun / kSlabs) & 1);
      U = npix[b];
      const short* sq = s_slab + (size_t)i * (C + 3) * P;
      const float4 sc = s_sc[i];
      for (int u = threadIdx.x; u < U; u += kThreads) {
        float qi[C + 3], w[C + 2];
#pragma unroll
        for (int e = 0; e < C + 3; ++e) qi[e] = sq[e * P + u];
        lokf_dequant<C, I4>(qi, sc, rq, w);
#pragma unroll
        for (int ch = 0; ch < C + 2; ++ch) s_w[ch * P + u] = w[ch];
        if (b != pb) s_pix[u] = pix[(size_t)b * P + u];
      }
      pb = b;
      __syncthreads();  // the weights are in, and slab i is free
      if (threadIdx.x == 0 && next < rows) {
        fetch(s_key[next], i);
        next = run_end(next);
      }
    } else if (V != kNoFold || run0 == 0) {
      const int sR = (g - b * Th) * R;
      U = npix[b];
      [[maybe_unused]] const bool fresh = kInside && b != pb;
      if constexpr (kInside) {
        if (fresh) {  // the bucket's pixels and their extent, its window
          int4 e = make_int4(INT_MAX, INT_MIN, INT_MAX, INT_MIN);
          for (int u = threadIdx.x; u < U; u += kThreads) {
            const int2 o = pix[(size_t)b * P + u];
            s_pix[u] = o;
            e = make_int4(min(e.x, o.x), max(e.y, o.x), min(e.z, o.y),
                          max(e.w, o.y));
          }
          const unsigned full = 0xffffffffu;
          e = make_int4(__reduce_min_sync(full, e.x),
                        __reduce_max_sync(full, e.y),
                        __reduce_min_sync(full, e.z),
                        __reduce_max_sync(full, e.w));
          if (lane == 0) win->ext[threadIdx.x >> 5] = e;
          // barrier 1: the other warps hand their extents to warp 0 and go
          // on to the fold; warp 0 waits for them, and records the block's
          // extent (and, on the code map, stages the window)
          if (threadIdx.x < 32) {
            asm volatile("bar.sync 1, %0;" ::"r"(kThreads) : "memory");
            if constexpr (kWin) {
              stage_window<kPixelElems>(
                  win, s_key, run0, rows, Th, b,
                  table ? table[b] : make_int4(0, H, W, 0), map, pixels,
                  s_win, cap);
            } else {
              e = lane < kWarps ? win->ext[lane]
                                : make_int4(INT_MAX, INT_MIN, INT_MAX,
                                            INT_MIN);
              e = make_int4(__reduce_min_sync(full, e.x),
                            __reduce_max_sync(full, e.y),
                            __reduce_min_sync(full, e.z),
                            __reduce_max_sync(full, e.w));
              if (lane == 0) win->e = e;
            }
          } else {
            asm volatile("bar.arrive 1, %0;" ::"r"(kThreads) : "memory");
          }
          pb = b;
        }
      }
      const int* sb = seg + (size_t)b * P;
      const int cell0 = b * TR;
      for (int u = threadIdx.x; u < U; u += kThreads) {
        if constexpr (kWeights) {
          float wc[C];
#pragma unroll
          for (int ch = 0; ch < C; ++ch) wc[ch] = 0.f;
          float wn = 0.f;
          const int lo = sb[u], hi = sb[u + 1];
          for (int q = lo; q < hi; ++q) {
            int j = order[q] - cell0 + sR;
            if (j >= TR) j -= TR;
#pragma unroll
            for (int ch = 0; ch < C; ++ch) wc[ch] += s_ws[ch * TR + j];
            wn += s_ss[j];
          }
#pragma unroll
          for (int ch = 0; ch < C; ++ch) s_w[ch * SP + u] = wc[ch];
          s_w[C * SP + u] = wn;
          s_w[(C + 1) * SP + u] = (float)(hi - lo);
        }
        if constexpr (!kInside) s_pix[u] = pix[(size_t)b * P + u];
      }
      __syncthreads();
      if constexpr (kWin) {
        if (fresh && win->staged) mbar_wait(&win->bar, nst++ & 1);
      }
    }

    const int4 lv = table ? table[b] : make_int4(0, H, W, 0);
    const MapElem<I4>* level = map + (size_t)lv.x * kPixelElems;
    if constexpr (kInside) {
      // the run's rows, each pixel's values from the map or, on the code
      // map, its codes from the window (on_window) or from L2 (the float
      // kernel's FMAs and sums on them), each row's in the same order.  A
      // row whose every pixel lies in the level (inside: its centre +- the
      // bucket's extent) reads pixel u at its own base plus u's offset,
      // with no bounds check; a warp takes its rows r and r + kWarps
      // together where both are inside, each pixel's offset and weights
      // loaded once for the two.
      const int4 e = win->e;
      const int y0 = win->y0, x0 = win->x0, c0 = win->c0;
      const int pitch = win->pitch;
      auto score = [&](auto on_window) {
        constexpr bool kStaged = decltype(on_window)::value;
        using Elem = const MapElem<I4>;
        // the elements from one row of the source to the next
        const int rb = kStaged ? pitch : lv.z * kPixelElems;
        auto load = [&](Elem* at, float (&v)[CP]) {
          if constexpr (!I4)
            load_pixel<CP>(at, v);
          else if constexpr (kStaged)
            load_codes<C, CP, true>(at, q, nq, v);
          else
            load_codes<C, CP>(at, q, nq, v);
        };
        // pixel u's values v weighed into row acc (cost, norm, kf); with
        // kGatherOnly summed unweighed
        auto weigh = [&](const float (&w)[C + 2], const float (&v)[CP],
                         float (&acc)[3]) {
          float a = 0.f;
          if constexpr (kWeights) {
#pragma unroll
            for (int ch = 0; ch < C; ++ch) a = fmaf(w[ch], v[ch], a);
            acc[0] += a;
            acc[1] = fmaf(w[C], v[C], acc[1]);
            acc[2] = fmaf(w[C + 1], v[C], acc[2]);
          } else {
#pragma unroll
            for (int ch = 0; ch < C; ++ch) a += v[ch];
            acc[0] += a;
            acc[1] += v[C];
            acc[2] += v[C];
          }
        };
        auto weights = [&](int u, float (&w)[C + 2]) {
          if constexpr (kWeights) {
#pragma unroll
            for (int ch = 0; ch < C + 2; ++ch) w[ch] = s_w[ch * SP + u];
          }
        };
        auto inside = [&](int r) {
          const int2 ctr = win->ctr[r];
          return ctr.x + e.x >= 0 && ctr.x + e.y < lv.y &&
                 ctr.y + e.z >= 0 && ctr.y + e.w < lv.z;
        };
        // the pixel row r reads at offset 0: its centre or, with kNoGather,
        // its centre clamped into the level (the one pixel it reads)
        auto origin = [&](int r) {
          const int2 ctr = win->ctr[r];
          if constexpr (V == kNoGather)
            return make_int2(min(max(ctr.x, 0), lv.y - 1),
                             min(max(ctr.y, 0), lv.z - 1));
          else
            return ctr;
        };
        auto finish = [&](int r, float (&acc)[3]) {
          acc[0] = warp_sum(acc[0]);
          acc[1] = warp_sum(acc[1]);
          acc[2] = warp_sum(acc[2]);
          if (lane == 0) {
            float* o3 = out + (size_t)perm[row0 + r] * 3;
            o3[0] = acc[0];
            o3[1] = acc[1];
            o3[2] = acc[2] * inv_tr;
          }
        };
        // NR rows rr, every one inside
        auto inside_rows = [&](auto nr, const int* rr) {
          constexpr int NR = decltype(nr)::value;
          Elem* base[NR];
          float acc[NR][3];
#pragma unroll
          for (int i = 0; i < NR; ++i) {
            const int2 ctr = origin(rr[i]);
            base[i] = kStaged ? reinterpret_cast<Elem*>(
                                    s_win + c0 + (ctr.x - y0) * pitch +
                                    (ctr.y - x0) * kPixelElems)
                              : level + ((long long)ctr.x * lv.z + ctr.y) *
                                            kPixelElems;
            acc[i][0] = acc[i][1] = acc[i][2] = 0.f;
          }
          auto pixel = [&](int u) {
            int off = 0;
            if constexpr (V != kNoGather) {
              const int2 o = s_pix[u];
              off = o.x * rb + o.y * kPixelElems;
            }
            float w[C + 2];
            weights(u, w);
#pragma unroll
            for (int i = 0; i < NR; ++i) {
              float v[CP];
              load(base[i] + off, v);
              weigh(w, v, acc[i]);
            }
          };
          if constexpr (NR == 1) {
#pragma unroll 4
            for (int u = lane; u < U; u += 32) pixel(u);
          } else {
#pragma unroll 2
            for (int u = lane; u < U; u += 32) pixel(u);
          }
#pragma unroll
          for (int i = 0; i < NR; ++i) finish(rr[i], acc[i]);
        };
        // row r, inside or not: zero outside the level
        auto one_row = [&](int r) {
          if (inside(r)) {
            const int rr[1] = {r};
            inside_rows(std::integral_constant<int, 1>{}, rr);
            return;
          }
          const int2 ctr = origin(r);
          float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll 4
          for (int u = lane; u < U; u += 32) {
            float v[CP];
#pragma unroll
            for (int ch = 0; ch < CP; ++ch) v[ch] = 0.f;
            if constexpr (V == kNoGather) {
              load(level + ((size_t)ctr.x * lv.z + ctr.y) * kPixelElems, v);
            } else {
              const int2 o = s_pix[u];
              const int y = ctr.x + o.x;
              const int x = ctr.y + o.y;
              if ((unsigned)y < (unsigned)lv.y &&
                  (unsigned)x < (unsigned)lv.z)
                load(kStaged ? reinterpret_cast<Elem*>(
                                   s_win + c0 + (y - y0) * pitch +
                                   (x - x0) * kPixelElems)
                             : level + ((size_t)y * lv.z + x) * kPixelElems,
                     v);
            }
            float w[C + 2];
            weights(u, w);
            weigh(w, v, acc);
          }
          finish(r, acc);
        };
        for (int r = run0 + (threadIdx.x >> 5); r < run1; r += 2 * kWarps) {
          const int r2 = r + kWarps;
          if (r2 < run1 && inside(r) && inside(r2)) {
            const int rr[2] = {r, r2};
            inside_rows(std::integral_constant<int, 2>{}, rr);
          } else {
            one_row(r);
            if (r2 < run1) one_row(r2);
          }
        }
      };
      if constexpr (kWin) {
        if (win->staged)
          score(std::true_type{});
        else
          score(std::false_type{});
      } else {
        score(std::false_type{});
      }
    } else {
      for (int r = run0 + (threadIdx.x >> 5); r < run1; r += kWarps) {
        const long long p = perm[row0 + r];
        float acc_c = 0.f, acc_n = 0.f, acc_k = 0.f;
        if constexpr (V == kFoldOnly) {
          if (U > 0) {
            const int u = (row0 + r) % U;
            acc_c = s_w[u];
            acc_n = s_w[C * SP + u];
            acc_k = s_w[(C + 1) * SP + u];
          }
        } else {
          // every stage (LOKF, kChecked): each pixel under the bounds check
          const int2 ctr = centers[p];
#pragma unroll 4
          for (int u = lane; u < U; u += 32) {
            float v[CP];
#pragma unroll
            for (int ch = 0; ch < CP; ++ch) v[ch] = 0.f;
            const int2 o = s_pix[u];
            const int y = ctr.x + o.x;
            const int x = ctr.y + o.y;
            if ((unsigned)y < (unsigned)lv.y && (unsigned)x < (unsigned)lv.z) {
              if constexpr (I4)
                load_codes<C, CP>(
                    level + ((size_t)y * lv.z + x) * kPixelElems, q, nq, v);
              else
                load_pixel<CP>(level + ((size_t)y * lv.z + x) * CP, v);
            }
            float a = 0.f;
#pragma unroll
            for (int ch = 0; ch < C; ++ch)
              a = fmaf(s_w[ch * SP + u], v[ch], a);
            acc_c += a;
            acc_n = fmaf(s_w[C * SP + u], v[C], acc_n);
            acc_k = fmaf(s_w[(C + 1) * SP + u], v[C], acc_k);
          }
          acc_c = warp_sum(acc_c);
          acc_n = warp_sum(acc_n);
          acc_k = warp_sum(acc_k);
        }
        if (lane == 0) {
          float* o3 = out + (size_t)p * 3;
          o3[0] = acc_c;
          o3[1] = acc_n;
          o3[2] = acc_k * inv_tr;
        }
      }
    }
    __syncthreads();  // every warp is done with this run's weights
    run0 = run1;
  }
}

// Raise kern's dynamic shared memory opt-in to smem, once per device and
// size (ready_dev, ready_smem: the caller's record for this kernel, set
// from one host thread).
template <typename Kern>
cudaError_t opt_in_smem(Kern kern, size_t smem, int* ready_dev,
                        size_t* ready_smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != *ready_dev || smem > *ready_smem) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    *ready_dev = dev;
    *ready_smem = smem;
  }
  return cudaSuccess;
}

}  // namespace
