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
//     row-major, with the CSR of each pixel's stencil cells, the result of
//     crop_score.fold_offsets in one launch (one block per table: a stable
//     radix sort of each cell's index in the table's bounding box, then a
//     block scan; bound by the latency of its barrier-separated steps, see
//     the kernel);
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
// The nibble-packed map (TDR_MAP_INT4=1; the same TPU kernel's `i4`
// configuration, pallas_score.py's int4 layout): crop_tracked_i4_kernel is
// the same body reading the code map, (pixels, CP/2) bytes, each channel a
// 4-bit (even) or 3-bit (odd) code.  A lane loads its pixel's CP/2 bytes in
// one load (2 bytes at C = 3, where the float map takes a 16-byte one) and
// turns each code into code * qinv in float32 with a byte permute and one
// FMA (load_codes): the dequantized map's values, on which the fold, the
// weights and the per-shift sums are the float kernel's.  The gather's
// bytes fall 8x at C = 3, but not its loads, which with their latency
// bound it (PERF.md §6).
//
// The single-plane M (TDR_M_HILO=0; the same TPU kernel's `lokf`
// configuration, one int8 plane of M per (variant, column), the kf column's
// residual kept beside it).  The TPU kernel's tracked variants are groups
// of 16 shifts, each column one shift, so its scales are per (bucket,
// shift) for cost and norm and per bucket for kf; rounding a folded weight
// needs its column's amax over every pixel first.  So the wrapper launches
// crop_lokf_scales_kernel once (one block a (shift, bucket): the fold of
// every pixel at that shift, a block max, the four scales), then
// crop_tracked_lokf_kernel, the tracked body with its fold rounding each
// weight as the plane does (crop_tracked.cuh, lokf_weights): the cells'
// coefficients in bf16 times qinv (the map quantization's), summed in
// float64 (exact, so both kernels and the plain version agree bit for bit
// on the sums whatever their order), each column's integers round(bf16(sum)
// / s).  The gather and the FMAs are the hi/lo kernel's; on the code map
// the weights apply to the codes themselves.
//
// Contract (equal to the plain versions in filter/crop_score.py and
// filter/multiscale.py up to float summation order): the compact map is
// (pixels, CP) float32, classes in channels [0, C), known in channel C;
// centers are (cy, cx) int32, pixel offsets (dy, dx) int32.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <type_traits>

#include "crop_tracked.cuh"

namespace {

constexpr int kFoldThreads = 1024;  // one block per offset table
constexpr int kFoldWarps = kFoldThreads / 32;
constexpr int kFoldCells = 16384;  // Th*R at most
constexpr int kDigitBits = 8;      // the widest radix digit
// shared memory of a fold block: two buffers of the cells in their
// current order and each cell's rank (12 bytes a cell), then the counts
// of every warp by digit, a row of kBins + 1 a warp (the pad spreads a
// warp's digits over the banks); 229,504 bytes at kFoldCells, of the
// 232,448 a block may have
constexpr int kBins = 1 << kDigitBits;
constexpr size_t kHistBytes = (size_t)kFoldWarps * (kBins + 1) * sizeof(int);
constexpr int kPad = 1 << 29;  // (dy, dx) of a padding pixel: PAD_PIX

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

// The same body on the code map (pixels, CP/2) with its qinv (8).
template <int C>
__global__ void __launch_bounds__(kThreads, 2)
    crop_tracked_i4_kernel(const unsigned char* __restrict__ codes,
                           const float* __restrict__ qinv,
                           const int4* __restrict__ table, int H, int W,
                           const float* __restrict__ scan,
                           const float* __restrict__ cw,
                           const int2* __restrict__ pix,
                           const int* __restrict__ npix,
                           const int* __restrict__ order,
                           const int* __restrict__ seg, int Th, int R, int P,
                           const int* __restrict__ skey,
                           const long long* __restrict__ perm,
                           const int2* __restrict__ centers, int N,
                           float inv_tr, float* __restrict__ out) {
  tracked_body<C, kFull, true>(codes, table, H, W, scan, cw, pix, npix, order,
                               seg, Th, R, P, skey, perm, centers, N, inv_tr,
                               out, qinv);
}

// The same body with the single-plane M: qinv (8) the map quantization's,
// scales (K, Th, 4) from crop_lokf_scales_kernel; the float map (pixels,
// CP) or, with I4, the code map (pixels, CP/2).
template <int C, bool I4>
__global__ void __launch_bounds__(kThreads, 2)
    crop_tracked_lokf_kernel(const MapElem<I4>* __restrict__ map,
                             const float* __restrict__ qinv,
                             const float* __restrict__ scales,
                             const int4* __restrict__ table, int H, int W,
                             const float* __restrict__ scan,
                             const float* __restrict__ cw,
                             const int2* __restrict__ pix,
                             const int* __restrict__ npix,
                             const int* __restrict__ order,
                             const int* __restrict__ seg, int Th, int R,
                             int P, const int* __restrict__ skey,
                             const long long* __restrict__ perm,
                             const int2* __restrict__ centers, int N,
                             float inv_tr, float* __restrict__ out) {
  tracked_body<C, kFull, I4, true>(map, table, H, W, scan, cw, pix, npix,
                                   order, seg, Th, R, P, skey, perm, centers,
                                   N, inv_tr, out, qinv, scales);
}

constexpr int kScaleThreads = 256;

// Block (s, b) writes the single-plane scales of bucket b at shift s,
// out[b, s] = (cost, norm, kf, kf residual): it folds every distinct pixel
// of the bucket at shift s as the tracked kernel's fold does (the same
// bf16 coefficients, read from the scan in global memory, summed in
// float64), takes the amax of each column's entries over the pixels
// (lokf_amax) and its scale (lokf_scale; the residual's s_kf / 254).  One
// launch for all K * Th groups; its work is the fold's (K Th R Th cells),
// tiny beside the tracked kernel's gather.
template <int C, bool I4>
__global__ void __launch_bounds__(kScaleThreads)
    crop_lokf_scales_kernel(const float* __restrict__ scan,
                            const float* __restrict__ cw,
                            const float* __restrict__ qinv,
                            const int* __restrict__ npix,
                            const int* __restrict__ order,
                            const int* __restrict__ seg, int Th, int R,
                            int P, float* __restrict__ out) {
  __shared__ float s_max[kScaleThreads / 32][3];
  const int s = blockIdx.x, b = blockIdx.y;
  const int TR = Th * R, sR = s * R, cell0 = b * TR;
  float wq[C + 1], cwc[C];
#pragma unroll
  for (int ch = 0; ch <= C; ++ch) wq[ch] = __ldg(qinv + ch);
#pragma unroll
  for (int ch = 0; ch < C; ++ch) cwc[ch] = 0.01f * __ldg(cw + ch);
  const float kf_coef = lokf_coef(1.f, wq[C]);
  float m[3] = {0.f, 0.f, 0.f};
  const int U = npix[b];
  const int* sb = seg + (size_t)b * P;
  for (int u = threadIdx.x; u < U; u += kScaleThreads) {
    double wc[C], wn = 0.0;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) wc[ch] = 0.0;
    const int lo = sb[u], hi = sb[u + 1];
    for (int q = lo; q < hi; ++q) {
      int j = order[q] - cell0 + sR;
      if (j >= TR) j -= TR;
      float sum = 0.f;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        const float v = __ldg(scan + ch * TR + j);
        wc[ch] += (double)lokf_coef(__fmul_rn(v, cwc[ch]), wq[ch]);
        sum = ch ? sum + v : v;
      }
      wn += (double)lokf_coef(sum, wq[C]);
    }
    float y[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) y[ch] = __double2float_rn(wc[ch]);
    lokf_amax<C, I4>(y, __double2float_rn(wn),
                     __double2float_rn((double)(hi - lo) * kf_coef), m);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m[k] = fmaxf(m[k], __shfl_xor_sync(0xffffffffu, m[k], o));
    if (lane == 0) s_max[warp][k] = m[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kScaleThreads / 32; ++w)
#pragma unroll
      for (int k = 0; k < 3; ++k) m[k] = fmaxf(m[k], s_max[w][k]);
    float4 r;
    r.x = lokf_scale(m[0]);
    r.y = lokf_scale(m[1]);
    r.z = lokf_scale(m[2]);
    r.w = __fdiv_rn(r.z, 254.f);
    reinterpret_cast<float4*>(out)[(size_t)b * Th + s] = r;
  }
}

// Exclusive prefix sum of one int a thread over a block of kFoldThreads,
// with one barrier: every warp scans the warp totals itself.  *total gets
// the block's sum.  Every thread must call it, and s_warp must not be
// written again before the next barrier.
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
  int w = lane < kFoldWarps ? s_warp[lane] : 0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, w, o);
    if (lane >= o) w += y;
  }
  *total = __shfl_sync(0xffffffffu, w, 31);
  return __shfl_sync(0xffffffffu, w, warp) - s_warp[warp] + x - v;
}

// Block b folds offset table b (off (K, Th*R) int2).  Writes pix (K, P)
// (PAD_PIX after the table's npix[b] pixels), npix (K), order (K*Th*R, the
// flat cells b*Th*R + i by pixel, then cell) and seg (K*P + 1): what
// crop_score.fold_offsets returns, bit for bit.
//
// What bounds it: not bytes (~60 KB at Th*R = 2,500, 0.00002 ms at HBM
// rate) but latency.  One block on one SM walks a chain of steps, each
// ended by a barrier, and its 32 warps share the SM's four schedulers, so
// every step costs a few hundred cycles even where it does little work.
// The design keeps the chain short: 2 + 4 barriers a radix pass (10 at
// the crop stencils' 12-bit boxes), where the bitonic sort of 64-bit (dy,
// dx, cell) keys before it took ~90; and its loops run over the cells a
// warp has, not unrolled over the largest table.
//   1. One block reduction finds the table's box [ymin, ymax] x [xmin,
//      xmax]; a cell's key is its row-major index in the box, (dy - ymin)
//      bw + (dx - xmin), in the order of (dy, dx), with only
//      ceil(log2(box)) bits: 12 at the crop buckets' mo <= 24, up to 44 at
//      offsets of 2^21.
//   2. A stable LSD radix sort of the cell indices by that key, in shared
//      memory, the digits spread evenly over ceil(bits / 8) passes (none
//      when every cell lies on one pixel).  A pass: each warp ranks its
//      own run of cells, 32 at a time, against its own row of counts (no
//      atomics), the lanes of one digit found by one ballot a digit bit
//      (__match_any_sync was slower); one block scan over (digit, warp)
//      turns the counts into each warp's first slot for each digit; each
//      cell goes to its slot in the other buffer.  Cells enter in
//      increasing order and every pass is stable, so each pixel's cells
//      come out in increasing order: the CSR needs nothing more.  The
//      offsets are re-read through the read-only cache rather than moved.
//   3. One block scan numbers the distinct pixels (each thread takes a
//      run of sorted cells), then the writes.
__global__ void __launch_bounds__(kFoldThreads)
    crop_fold_kernel(const int2* __restrict__ off, int K, int TR, int P,
                     int2* __restrict__ pix, int* __restrict__ npix,
                     int* __restrict__ order, int* __restrict__ seg) {
  extern __shared__ __align__(16) int s_fold[];
  int* s_src = s_fold;          // (TR) cells in the current order
  int* s_dst = s_fold + TR;     // (TR) cells in the next
  int* s_rank = s_fold + 2 * TR;  // (TR) warp rank << kDigitBits | digit
  int* s_hist = s_fold + 3 * TR;  // (warp, digit) at warp * (nb + 1) + digit
  __shared__ int4 s_box[kFoldWarps];
  __shared__ int s_warp[kFoldWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const int2* o = off + (size_t)b * TR;

  // 1. the box: (ymin, ymax, xmin, xmax)
  const int4 none = make_int4(INT_MAX, INT_MIN, INT_MAX, INT_MIN);
  int4 box = none;
  for (int i = threadIdx.x; i < TR; i += kFoldThreads) {
    const int2 d = __ldg(o + i);
    box = make_int4(min(box.x, d.x), max(box.y, d.x), min(box.z, d.y),
                    max(box.w, d.y));
  }
  box = make_int4(__reduce_min_sync(0xffffffffu, box.x),
                  __reduce_max_sync(0xffffffffu, box.y),
                  __reduce_min_sync(0xffffffffu, box.z),
                  __reduce_max_sync(0xffffffffu, box.w));
  if (lane == 0) s_box[warp] = box;
  __syncthreads();
  box = lane < kFoldWarps ? s_box[lane] : none;
  const int ymin = __reduce_min_sync(0xffffffffu, box.x);
  const int xmin = __reduce_min_sync(0xffffffffu, box.z);
  const unsigned long long bw =
      (unsigned long long)(__reduce_max_sync(0xffffffffu, box.w) - xmin) + 1;
  const unsigned long long area =
      ((unsigned long long)(__reduce_max_sync(0xffffffffu, box.y) - ymin) +
       1) * bw;
  const int bits = area > 1 ? 64 - __clzll(area - 1) : 0;
  const int passes = (bits + kDigitBits - 1) / kDigitBits;
  const int dbits = passes ? (bits + passes - 1) / passes : 0;
  const int nb = 1 << dbits;  // bins of a digit
  const unsigned mask = nb - 1;
  // warp w ranks cells [w nch 32, (w + 1) nch 32) of the current order
  const int nch = (TR + kFoldThreads - 1) / kFoldThreads;
  const int w0 = warp * nch * 32, w1 = min(w0 + nch * 32, TR);
  int* hist = s_hist + warp * (nb + 1);

  // 2. the radix passes
  for (int p = 0, shift = 0; p < passes; ++p, shift += dbits) {
    for (int d = lane; d < nb; d += 32) hist[d] = 0;
    __syncwarp();
    for (int c0 = w0; c0 < w1; c0 += 32) {  // a chunk of 32 cells
      const int i = c0 + lane;
      const unsigned live = __ballot_sync(0xffffffffu, i < w1);
      if (i < w1) {
        const int2 d = __ldg(o + (p ? s_src[i] : i));
        const unsigned long long key =
            (unsigned long long)(d.x - ymin) * bw + (unsigned)(d.y - xmin);
        const int dig = (int)((key >> shift) & mask);
        unsigned peers = live;
        for (int bit = 0; bit < dbits; ++bit) {
          const unsigned ones = __ballot_sync(live, dig >> bit & 1);
          peers &= (dig >> bit & 1) ? ones : ~ones;
        }
        const int leader = __ffs(peers) - 1;
        int before = 0;
        if (lane == leader) {
          before = hist[dig];
          hist[dig] = before + __popc(peers);
        }
        before = __shfl_sync(live, before, leader) +
                 __popc(peers & ((1u << lane) - 1));
        s_rank[i] = before << kDigitBits | dig;
      }
      __syncwarp();
    }
    __syncthreads();
    // counts -> first slots, in (digit, warp) order: thread t takes
    // entries [t per, (t + 1) per)
    const int n = nb * kFoldWarps;
    const int per = (n + kFoldThreads - 1) / kFoldThreads;
    int sum = 0;
    for (int q = 0; q < per; ++q) {
      const int e = threadIdx.x * per + q;
      if (e < n) sum += s_hist[(e % kFoldWarps) * (nb + 1) + e / kFoldWarps];
    }
    int total;
    int run = block_scan(sum, s_warp, &total);
    for (int q = 0; q < per; ++q) {
      const int e = threadIdx.x * per + q;
      if (e < n) {
        int* h = s_hist + (e % kFoldWarps) * (nb + 1) + e / kFoldWarps;
        const int c = *h;
        *h = run;
        run += c;
      }
    }
    __syncthreads();
    for (int i = w0 + lane; i < w1; i += 32) {
      const int r = s_rank[i];
      s_dst[hist[r & (kBins - 1)] + (r >> kDigitBits)] = p ? s_src[i] : i;
    }
    int* t = s_src;
    s_src = s_dst;
    s_dst = t;
    __syncthreads();
  }

  // 3. number the distinct pixels: thread t takes sorted cells [t nch,
  // (t + 1) nch)
  const int i0 = min((int)threadIdx.x * nch, TR), i1 = min(i0 + nch, TR);
  unsigned long long fresh = 0;
  int nfresh = 0;
  int2 prev = make_int2(kPad, kPad);  // no offset reaches it
  if (i0 > 0 && i0 < i1)
    prev = __ldg(o + (passes ? s_src[i0 - 1] : i0 - 1));
  for (int i = i0; i < i1; ++i) {
    const int2 d = __ldg(o + (passes ? s_src[i] : i));
    if (d.x != prev.x || d.y != prev.y) {
      fresh |= 1ull << (i - i0);
      ++nfresh;
    }
    prev = d;
  }
  int count;
  int u = block_scan(nfresh, s_warp, &count);
  const int base = b * TR;
  for (int i = i0; i < i1; ++i) {
    if (fresh >> (i - i0) & 1) {
      pix[(size_t)b * P + u] = __ldg(o + (passes ? s_src[i] : i));
      seg[(size_t)b * P + u] = base + i;
      ++u;
    }
  }
  for (int i = threadIdx.x; i < TR; i += kFoldThreads)
    order[base + i] = base + (passes ? s_src[i] : i);
  for (int v = count + threadIdx.x; v < P; v += kFoldThreads) {
    pix[(size_t)b * P + v] = make_int2(kPad, kPad);
    seg[(size_t)b * P + v] = base + TR;
  }
  if (threadIdx.x == 0) {
    npix[b] = count;
    if (b == K - 1) seg[(size_t)K * P] = K * TR;
  }
}

// Launch the tracked kernel on the float map (qinv null) or, with I4, on
// the code map and its qinv; with LOKF the single-plane M's (qinv the map
// quantization's, scales (K, Th, 4)).
template <int C, bool I4, bool LOKF = false>
cudaError_t launch(const void* map, const float* qinv, const int* table,
                   int H, int W, const float* scan, const float* cw,
                   const int* pix, const int* npix, const int* order,
                   const int* seg, int Th, int R, int P, const int* skey,
                   const long long* perm, const int* centers, int N,
                   float inv_tr, float* out, cudaStream_t stream,
                   const float* scales = nullptr) {
  // the smem opt-in, set once per device and raised with the table size;
  // callers launch from one host thread
  static int ready_dev = -1;
  static size_t ready_smem = 0;
  const size_t smem = smem_bytes<C>(Th * R, P);
  const dim3 grid((N + kTile - 1) / kTile);
  const auto* tbl = reinterpret_cast<const int4*>(table);
  const auto* px = reinterpret_cast<const int2*>(pix);
  const auto* ctr = reinterpret_cast<const int2*>(centers);
  cudaError_t err;
  if constexpr (LOKF) {
    auto kern = crop_tracked_lokf_kernel<C, I4>;
    err = opt_in_smem(kern, smem, &ready_dev, &ready_smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const MapElem<I4>*>(map), qinv, scales, tbl, H, W, scan,
        cw, px, npix, order, seg, Th, R, P, skey, perm, ctr, N, inv_tr, out);
  } else if constexpr (I4) {
    auto kern = crop_tracked_i4_kernel<C>;
    err = opt_in_smem(kern, smem, &ready_dev, &ready_smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const unsigned char*>(map), qinv, tbl, H, W, scan, cw, px,
        npix, order, seg, Th, R, P, skey, perm, ctr, N, inv_tr, out);
  } else {
    auto kern = crop_tracked_kernel<C>;
    err = opt_in_smem(kern, smem, &ready_dev, &ready_smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(map), tbl, H, W, scan, cw, px, npix, order,
        seg, Th, R, P, skey, perm, ctr, N, inv_tr, out);
  }
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

// off (K, Th*R) int2 offset tables, TR = Th*R <= kFoldCells = 16,384 (the
// bitonic kernel before it took as many, its 64-bit keys filling 128 KB of
// shared memory), offsets |d| < 2^21, P >= TR; out holds
// pix (K, P) int2, seg (K*P + 1), order (K*Th*R) and npix (K), int32, back
// to back.
extern "C" int tdr_crop_fold(const int* off, int K, int TR, int P, int* out,
                             void* stream) {
  static int ready_dev = -1;
  static size_t ready_smem = 0;
  if (K < 1 || TR < 1 || TR > kFoldCells || P < TR)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)TR * 3 * sizeof(int) + kHistBytes;
  const cudaError_t err =
      opt_in_smem(crop_fold_kernel, smem, &ready_dev, &ready_smem);
  if (err != cudaSuccess) return (int)err;
  int2* pix = reinterpret_cast<int2*>(out);
  int* seg = out + (size_t)2 * K * P;
  int* order = seg + (size_t)K * P + 1;
  int* npix = order + (size_t)K * TR;
  crop_fold_kernel<<<K, kFoldThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int2*>(off), K, TR, P, pix, npix, order, seg);
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
    return (int)launch<decltype(cc)::value, false>(
        map, nullptr, nullptr, H, W, scan, cw, pix, npix, order, seg, Th, R,
        P, skey, perm, centers, N, inv_tr, out,
        static_cast<cudaStream_t>(stream));
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
    return (int)launch<decltype(cc)::value, false>(
        pyramid, nullptr, table, 0, 0, scan, cw, pix, npix, order, seg, Th, R,
        P, skey, perm, centers, N, inv_tr, out,
        static_cast<cudaStream_t>(stream));
  });
}

// The nibble-packed map: codes (pixels, CP/2) uint8 and qinv (8) float32 in
// place of the compact map, everything else as tdr_crop_score_tracked.
extern "C" int tdr_crop_score_tracked_i4(
    const unsigned char* codes, const float* qinv, int H, int W, int C,
    const float* scan, const float* cw, const int* pix, const int* npix,
    const int* order, const int* seg, int Th, int R, int P, const int* skey,
    const long long* perm, const int* centers, int N, float inv_tr,
    float* out, void* stream) {
  return by_classes(C, [&](auto cc) {
    return (int)launch<decltype(cc)::value, true>(
        codes, qinv, nullptr, H, W, scan, cw, pix, npix, order, seg, Th, R,
        P, skey, perm, centers, N, inv_tr, out,
        static_cast<cudaStream_t>(stream));
  });
}

// ... and as tdr_crop_score_multi_tracked on the code pyramid.
extern "C" int tdr_crop_score_multi_tracked_i4(
    const unsigned char* codes, const float* qinv, const int* table, int K,
    int C, const float* scan, const float* cw, const int* pix,
    const int* npix, const int* order, const int* seg, int Th, int R, int P,
    const int* skey, const long long* perm, const int* centers, int N,
    float inv_tr, float* out, void* stream) {
  if (K < 1 || K > kMaxBuckets) return (int)cudaErrorInvalidValue;
  return by_classes(C, [&](auto cc) {
    return (int)launch<decltype(cc)::value, true>(
        codes, qinv, table, 0, 0, scan, cw, pix, npix, order, seg, Th, R, P,
        skey, perm, centers, N, inv_tr, out,
        static_cast<cudaStream_t>(stream));
  });
}

// The single-plane M (TDR_M_HILO=0).  tdr_crop_lokf_scales: the scales
// (K, Th, 4) of every (bucket, shift) into out, from the scan (C, Th, R),
// the class weights, qinv (8) of the map quantization, I4 (the code map's
// table: 0 or 1) and tdr_crop_fold's npix, order, seg and P.  The tracked
// entry points then take the map (or codes), qinv and those scales, then
// the hi/lo float entry points' arguments from H (table) on.
extern "C" int tdr_crop_lokf_scales(const float* scan, const float* cw,
                                    const float* qinv, int C, int I4,
                                    const int* npix, const int* order,
                                    const int* seg, int K, int Th, int R,
                                    int P, float* out, void* stream) {
  if (K < 1 || K > kMaxBuckets || Th < 1 || R < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Th, K);
  const auto st = static_cast<cudaStream_t>(stream);
  return by_classes(C, [&](auto cc) {
    constexpr int kC = decltype(cc)::value;
    if (I4)
      crop_lokf_scales_kernel<kC, true><<<grid, kScaleThreads, 0, st>>>(
          scan, cw, qinv, npix, order, seg, Th, R, P, out);
    else
      crop_lokf_scales_kernel<kC, false><<<grid, kScaleThreads, 0, st>>>(
          scan, cw, qinv, npix, order, seg, Th, R, P, out);
    return (int)cudaGetLastError();
  });
}

namespace {

// The single-plane tracked entry points' launch, uniform (table null) and
// K-bucket.
template <bool I4>
int tracked_lokf(const void* map, const float* qinv, const float* scales,
                 const int* table, int K, int H, int W, int C,
                 const float* scan, const float* cw, const int* pix,
                 const int* npix, const int* order, const int* seg, int Th,
                 int R, int P, const int* skey, const long long* perm,
                 const int* centers, int N, float inv_tr, float* out,
                 void* stream) {
  if (K < 1 || K > kMaxBuckets) return (int)cudaErrorInvalidValue;
  return by_classes(C, [&](auto cc) {
    return (int)launch<decltype(cc)::value, I4, true>(
        map, qinv, table, H, W, scan, cw, pix, npix, order, seg, Th, R, P,
        skey, perm, centers, N, inv_tr, out,
        static_cast<cudaStream_t>(stream), scales);
  });
}

}  // namespace

extern "C" int tdr_crop_score_tracked_lokf(
    const float* map, const float* qinv, const float* scales, int H, int W,
    int C, const float* scan, const float* cw, const int* pix,
    const int* npix, const int* order, const int* seg, int Th, int R, int P,
    const int* skey, const long long* perm, const int* centers, int N,
    float inv_tr, float* out, void* stream) {
  return tracked_lokf<false>(map, qinv, scales, nullptr, 1, H, W, C, scan,
                             cw, pix, npix, order, seg, Th, R, P, skey, perm,
                             centers, N, inv_tr, out, stream);
}

extern "C" int tdr_crop_score_multi_tracked_lokf(
    const float* pyramid, const float* qinv, const float* scales,
    const int* table, int K, int C, const float* scan, const float* cw,
    const int* pix, const int* npix, const int* order, const int* seg,
    int Th, int R, int P, const int* skey, const long long* perm,
    const int* centers, int N, float inv_tr, float* out, void* stream) {
  return tracked_lokf<false>(pyramid, qinv, scales, table, K, 0, 0, C, scan,
                             cw, pix, npix, order, seg, Th, R, P, skey, perm,
                             centers, N, inv_tr, out, stream);
}

extern "C" int tdr_crop_score_tracked_i4_lokf(
    const unsigned char* codes, const float* qinv, const float* scales,
    int H, int W, int C, const float* scan, const float* cw, const int* pix,
    const int* npix, const int* order, const int* seg, int Th, int R, int P,
    const int* skey, const long long* perm, const int* centers, int N,
    float inv_tr, float* out, void* stream) {
  return tracked_lokf<true>(codes, qinv, scales, nullptr, 1, H, W, C, scan,
                            cw, pix, npix, order, seg, Th, R, P, skey, perm,
                            centers, N, inv_tr, out, stream);
}

extern "C" int tdr_crop_score_multi_tracked_i4_lokf(
    const unsigned char* codes, const float* qinv, const float* scales,
    const int* table, int K, int C, const float* scan, const float* cw,
    const int* pix, const int* npix, const int* order, const int* seg,
    int Th, int R, int P, const int* skey, const long long* perm,
    const int* centers, int N, float inv_tr, float* out, void* stream) {
  return tracked_lokf<true>(codes, qinv, scales, table, K, 0, 0, C, scan,
                            cw, pix, npix, order, seg, Th, R, P, skey, perm,
                            centers, N, inv_tr, out, stream);
}
