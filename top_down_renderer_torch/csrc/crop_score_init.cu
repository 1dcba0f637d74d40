// Theta search of a particle cloud on Hopper's tensor cores (sm_90a): at one
// uniform scale, or over K scale buckets on a mip pyramid.
//
// Replaces: top_down_renderer_tpu/filter/pallas_score.py::_kernel with its
// `sel_init` epilogue (make_score_init(sel=True), run by _run_kernel) and
// the K-bucket theta search of filter/multiscale.py::make_score_init_multi,
// and the same kernel's raw-row epilogue (sel_init = 0: make_score_init and
// make_score_init_multi with sel=False, the multi-device init step's).
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

// The nibble-packed map (TDR_MAP_INT4=1; the same TPU kernel's `i4`
// configuration): crop_init_i4_kernel is the same body on the code map,
// (pixels, CP/2) bytes.  What bounds the float kernel is its window gather's
// load count and latency (K4, PERF.md), not its bytes, so the design cuts
// loads and arithmetic, not only bytes:
//   - A is the codes themselves, 0-15, exact in bf16: no lo plane and no
//     split, and two products a k16 step (A B_hi + A B_lo) where the float
//     map takes three; M's rows carry qinv (crop_score.fold_qinv, before
//     its hi/lo split), so acc is the dequantized map's sum to ~2^-16;
//   - the wrapper permutes each chunk's K rows so that a thread's fragment
//     pairs of a row are whole pixels: it loads one naturally aligned word
//     of CP/2 bytes a pixel, 8/CP words a row (2 at CP = 4, 1 at CP = 8)
//     where the float map takes 4 float2 loads, and turns each byte into
//     its bf16 pair with three integer and bf16 instructions;
//   - the kf column keeps M's cell counts, so it sums kq x the count on a
//     known pixel (the known channel's code, 15 or 7, for a {0, 1} mask):
//     the epilogue divides by kq, exactly, and kf is the float map's.
// (The first design, a byte load a pair dequantized into the float
// kernel's split and three products, ran 1.22-1.33 ms against the float
// kernel's 1.00-1.05 on an H100 at 700 W, 102,400 particles spread over a
// 1024^2 3-class map: PERF.md §6.)
//
// The single-plane M (TDR_M_HILO=0; the same TPU kernel's `lokf`
// configuration, _run_kernel's single int8 plane of M per (variant,
// column), only the kf column's residual kept in column 81):
// crop_init_lokf_kernel is the same body with one B plane.  Its records hold
// the integers of crop_score.init_m_lokf (|q| <= 127 on the float map, <=
// 2,032 on the codes, exact in bf16) and one scale a column (K, 88):
//   - no B_lo product: the float map's window is multiplied by 1 / qinv (the
//     int8 map quantization's row multipliers, under which the integers were
//     rounded) and split into bf16 hi and lo, A_hi B + A_lo B, two products
//     a k16 step where the hi/lo M takes three; the codes are exact, A B,
//     one product where the hi/lo code kernel takes two;
//   - a record is one plane and the pixels (6,144 bytes at CP = 2 where the
//     hi/lo record takes 11,776), and so is the ring;
//   - the epilogue multiplies every column's fp32 sum by its scale first,
//     and kf is columns 80 and 81 scaled and added (the kf < 0.5 gate reads
//     that sum, as JAX's reads its kfc).
//
// The window route (every theta search: crop_init_kernel, and
// crop_init_i4_kernel and crop_init_lokf_kernel on the float and the code
// map; csrc/crop_init.cuh).  The gather, not the products, sets these
// kernels' pace, and within it the instructions around each load (a bounds
// check and a 64-bit address a pair), not L2's bytes: fewer bytes a load
// did not help (the code map), nor did one B plane less (the single plane),
// and K4 (csrc/crop_ablate_init.cu) put the float hi/lo kernel's gather
// ahead of its products.  So the wrapper orders each bucket's rows by the
// Morton code of their centres' tiles (crop_score.init_order: one launch
// of the order kernel, the keys, their stable sort, the permutation and
// each bucket's first row), so that a warp's 16 rows lie
// close together and their loads hit L1, and a warp whose rows' windows
// all lie in their level (a vote, on ext: each bucket's extent,
// crop_score.fold_extent) gathers without a bounds check, each row's base
// once and each pixel's offset once a chunk, shared by the thread's two
// rows.  Each row's product and argmin are its own, so no bit of the
// output changes.  A box of each block's rows staged in shared memory by
// bulk copies measured slower than this gather from L2 through L1, and an
// mbarrier a ring stage slower than the block barrier (PERF.md §6), and so
// did two chunks of code words in flight in the code map's single-plane
// kernel (chunk kc + 2's loads issued before chunk kc's product): every
// global load of the loop signals one scoreboard, and the first use of a
// loaded word waits for all of them, so the second chunk was waited for
// with the first while its loads delayed the product.  Every entry point
// takes perm (the uniform ones too) and ext, and refuses either null.
//
// The body (crop_init_kernel's stages, its constants and helpers) lives in
// csrc/crop_init.cuh, shared with the ablation (csrc/crop_ablate_init.cu);
// its mbarrier waits trap after about ten seconds (csrc/tma.cuh), so a
// broken ring fails its launch instead of hanging the card.

#include <cuda_runtime.h>

#include "crop_init.cuh"

namespace {

// The float map's theta search with the hi/lo M, on the window route: the
// rows in position order, ext (K) the buckets' extents.
template <int CP, bool RAW>
__global__ void __launch_bounds__(kThreads, 1)
    crop_init_kernel(const float* __restrict__ map,
                     const int4* __restrict__ table, int H, int W,
                     const unsigned char* __restrict__ m,
                     const int* __restrict__ sched, int K, int chunk_cap,
                     const int* __restrict__ perm,
                     const int2* __restrict__ centers, int S, float inv_tr,
                     float* __restrict__ out, const int4* __restrict__ ext) {
  init_body<CP, RAW, kFull, false, false, true>(
      map, table, H, W, m, sched, K, chunk_cap, perm, centers, S, inv_tr,
      out, 1.f, nullptr, nullptr, ext);
}

// The same body on the code map (pixels, CP/2), kq the known code, on the
// window route: the rows in position order, ext (K) the buckets' extents.
template <int CP, bool RAW>
__global__ void __launch_bounds__(kThreads, 1)
    crop_init_i4_kernel(const unsigned char* __restrict__ codes,
                        const int4* __restrict__ table, int H, int W,
                        const unsigned char* __restrict__ m,
                        const int* __restrict__ sched, int K, int chunk_cap,
                        const int* __restrict__ perm,
                        const int2* __restrict__ centers, int S, float inv_tr,
                        float* __restrict__ out, float kq,
                        const int4* __restrict__ ext) {
  init_body<CP, RAW, kFull, true, false, true>(
      codes, table, H, W, m, sched, K, chunk_cap, perm, centers, S, inv_tr,
      out, kq, nullptr, nullptr, ext);
}

// The single-plane M's body on the window route (ext, as
// crop_init_i4_kernel's), on the float map (qinv: its int8 quantization's
// row multipliers) or, with I4, on the code map (qinv not read); scales
// (K, 88) the columns' scales.
template <int CP, bool RAW, bool I4>
__global__ void __launch_bounds__(kThreads, 1)
    crop_init_lokf_kernel(
        const std::conditional_t<I4, unsigned char, float>* __restrict__ map,
        const int4* __restrict__ table, int H, int W,
        const unsigned char* __restrict__ m, const int* __restrict__ sched,
        int K, int chunk_cap, const int* __restrict__ perm,
        const int2* __restrict__ centers, int S, float inv_tr,
        float* __restrict__ out, const float* __restrict__ scales,
        const float* __restrict__ qinv, const int4* __restrict__ ext) {
  init_body<CP, RAW, kFull, I4, true, true>(map, table, H, W, m, sched, K,
                                            chunk_cap, perm, centers, S,
                                            inv_tr, out, 1.f, scales, qinv,
                                            ext);
}

// Launch the theta search on the float map or, with I4, on the code map
// (kq: its known code); with ONE the single-plane M's (scales, qinv).  Each
// takes the window route (ext).
template <int CP, bool RAW, bool I4, bool ONE = false>
cudaError_t launch(const void* map, float kq, const int* table,
                   int H, int W, int K, const void* m, const int* sched,
                   int chunk_cap, const int* perm, const int* centers, int N,
                   int S, float inv_tr, float* out, cudaStream_t stream,
                   const float* scales = nullptr,
                   const float* qinv = nullptr, const int* ext = nullptr) {
  static int ready_dev = -1;  // the smem opt-in is set once per device
  using Map = std::conditional_t<I4, unsigned char, float>;
  const auto* ext4 = reinterpret_cast<const int4*>(ext);
  if constexpr (ONE)
    return launch_tiles(crop_init_lokf_kernel<CP, RAW, I4>, &ready_dev,
                        kRingBytes<CP, 1>, static_cast<const Map*>(map),
                        table, H, W, K, m, sched, chunk_cap, perm, centers, N,
                        S, inv_tr, out, stream, scales, qinv, ext4);
  else if constexpr (I4)
    return launch_tiles(crop_init_i4_kernel<CP, RAW>, &ready_dev,
                        kRingBytes<CP>, static_cast<const unsigned char*>(map),
                        table, H, W, K, m, sched, chunk_cap, perm, centers, N,
                        S, inv_tr, out, stream, kq, ext4);
  else
    return launch_tiles(crop_init_kernel<CP, RAW>, &ready_dev, kRingBytes<CP>,
                        static_cast<const float*>(map), table, H, W, K, m,
                        sched, chunk_cap, perm, centers, N, S, inv_tr, out,
                        stream, ext4);
}

template <bool RAW, bool I4 = false, bool ONE = false>
int by_channels(int CP, const void* map, const int* table, int H, int W,
                int K, const void* m, const int* sched, int chunk_cap,
                const int* perm, const int* centers, int N, int S,
                float inv_tr, float* out, void* stream,
                float kq = 1.f, const float* scales = nullptr,
                const float* qinv = nullptr, const int* ext = nullptr) {
  if (!valid_search(S, K)) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (CP) {
    case 2:
      return (int)launch<2, RAW, I4, ONE>(map, kq, table, H, W, K, m, sched,
                                          chunk_cap, perm, centers, N, S,
                                          inv_tr, out, st, scales, qinv,
                                          ext);
    case 4:
      return (int)launch<4, RAW, I4, ONE>(map, kq, table, H, W, K, m, sched,
                                          chunk_cap, perm, centers, N, S,
                                          inv_tr, out, st, scales, qinv,
                                          ext);
    case 8:
      return (int)launch<8, RAW, I4, ONE>(map, kq, table, H, W, K, m, sched,
                                          chunk_cap, perm, centers, N, S,
                                          inv_tr, out, st, scales, qinv,
                                          ext);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each returns the CUDA error of
// its launch (0 on success); none allocates or synchronises.  map: the
// compact (H, W, CP) map; m, sched, chunk_cap: init_operands' records and
// schedule (filter/crop_score.py); perm (N) the particles in position order
// (crop_score.init_order); centers (N) int2 (cy, cx); out (N, 3), or
// (N, 2S + 1) for the raw-row entry points (*_raw); after out ext (K, 4)
// int32 each bucket's extent (crop_score.fold_extent).  A null perm or ext
// is refused.
extern "C" int tdr_crop_score_init(const float* map, int H, int W, int CP,
                                   const void* m, const int* sched,
                                   int chunk_cap, const int* perm,
                                   const int* centers, int N, int S,
                                   float inv_tr, float* out, const int* ext,
                                   void* stream) {
  if (!perm || !ext) return (int)cudaErrorInvalidValue;
  return by_channels<false>(CP, map, nullptr, H, W, 1, m, sched, chunk_cap,
                            perm, centers, N, S, inv_tr, out, stream, 1.f,
                            nullptr, nullptr, ext);
}

extern "C" int tdr_crop_score_init_raw(const float* map, int H, int W, int CP,
                                       const void* m, const int* sched,
                                       int chunk_cap, const int* perm,
                                       const int* centers, int N, int S,
                                       float inv_tr, float* out,
                                       const int* ext, void* stream) {
  if (!perm || !ext) return (int)cudaErrorInvalidValue;
  return by_channels<true>(CP, map, nullptr, H, W, 1, m, sched, chunk_cap,
                           perm, centers, N, S, inv_tr, out, stream, 1.f,
                           nullptr, nullptr, ext);
}

// K buckets: pyramid (pixels, CP) with table (K, 4) of (pixel offset, H, W,
// -) per bucket; perm (N) the particles in bucket order, each bucket's by
// position.
extern "C" int tdr_crop_score_multi_init(const float* pyramid,
                                         const int* table, int K, int CP,
                                         const void* m, const int* sched,
                                         int chunk_cap, const int* perm,
                                         const int* centers, int N, int S,
                                         float inv_tr, float* out,
                                         const int* ext, void* stream) {
  if (!perm || !ext) return (int)cudaErrorInvalidValue;
  return by_channels<false>(CP, pyramid, table, 0, 0, K, m, sched, chunk_cap,
                            perm, centers, N, S, inv_tr, out, stream, 1.f,
                            nullptr, nullptr, ext);
}

extern "C" int tdr_crop_score_multi_init_raw(const float* pyramid,
                                             const int* table, int K, int CP,
                                             const void* m, const int* sched,
                                             int chunk_cap, const int* perm,
                                             const int* centers, int N, int S,
                                             float inv_tr, float* out,
                                             const int* ext, void* stream) {
  if (!perm || !ext) return (int)cudaErrorInvalidValue;
  return by_channels<true>(CP, pyramid, table, 0, 0, K, m, sched, chunk_cap,
                           perm, centers, N, S, inv_tr, out, stream, 1.f,
                           nullptr, nullptr, ext);
}

// The nibble-packed map: codes (pixels, CP/2) uint8 and kq, the known
// channel's code (15 or 7), in place of the compact map; m, sched and
// chunk_cap the code layout's records (crop_score.init_records with qinv);
// everything else as the float entry points.
extern "C" int tdr_crop_score_init_i4(const unsigned char* codes, float kq,
                                      int H, int W, int CP, const void* m,
                                      const int* sched, int chunk_cap,
                                      const int* perm, const int* centers,
                                      int N, int S, float inv_tr, float* out,
                                      const int* ext, void* stream) {
  if (!perm || !ext) return (int)cudaErrorInvalidValue;
  return by_channels<false, true>(CP, codes, nullptr, H, W, 1, m, sched,
                                  chunk_cap, perm, centers, N, S, inv_tr,
                                  out, stream, kq, nullptr, nullptr, ext);
}

extern "C" int tdr_crop_score_init_raw_i4(
    const unsigned char* codes, float kq, int H, int W, int CP, const void* m,
    const int* sched, int chunk_cap, const int* perm, const int* centers,
    int N, int S, float inv_tr, float* out, const int* ext, void* stream) {
  if (!perm || !ext) return (int)cudaErrorInvalidValue;
  return by_channels<true, true>(CP, codes, nullptr, H, W, 1, m, sched,
                                 chunk_cap, perm, centers, N, S, inv_tr, out,
                                 stream, kq, nullptr, nullptr, ext);
}

extern "C" int tdr_crop_score_multi_init_i4(
    const unsigned char* codes, float kq, const int* table, int K, int CP,
    const void* m, const int* sched, int chunk_cap, const int* perm,
    const int* centers, int N, int S, float inv_tr, float* out,
    const int* ext, void* stream) {
  if (!perm || !ext) return (int)cudaErrorInvalidValue;
  return by_channels<false, true>(CP, codes, table, 0, 0, K, m, sched,
                                  chunk_cap, perm, centers, N, S, inv_tr, out,
                                  stream, kq, nullptr, nullptr, ext);
}

extern "C" int tdr_crop_score_multi_init_raw_i4(
    const unsigned char* codes, float kq, const int* table, int K, int CP,
    const void* m, const int* sched, int chunk_cap, const int* perm,
    const int* centers, int N, int S, float inv_tr, float* out,
    const int* ext, void* stream) {
  if (!perm || !ext) return (int)cudaErrorInvalidValue;
  return by_channels<true, true>(CP, codes, table, 0, 0, K, m, sched,
                                 chunk_cap, perm, centers, N, S, inv_tr, out,
                                 stream, kq, nullptr, nullptr, ext);
}

// The single-plane M (TDR_M_HILO=0): the float entry points with qinv (8,
// the int8 map quantization's) after the map and the columns' scales (K, 88)
// after the records m (crop_score.init_records with m_hilo=False: one plane
// a record); perm and ext as the code map's hi/lo entry points.  The code
// map's entry points (_i4_lokf) take no qinv.
extern "C" int tdr_crop_score_init_lokf(
    const float* map, const float* qinv, int H, int W, int CP, const void* m,
    const float* scales, const int* sched, int chunk_cap, const int* perm,
    const int* centers, int N, int S, float inv_tr, float* out,
    const int* ext, void* stream) {
  if (!perm || !ext) return (int)cudaErrorInvalidValue;
  return by_channels<false, false, true>(CP, map, nullptr, H, W, 1, m, sched,
                                         chunk_cap, perm, centers, N, S,
                                         inv_tr, out, stream, 1.f, scales,
                                         qinv, ext);
}

extern "C" int tdr_crop_score_init_raw_lokf(
    const float* map, const float* qinv, int H, int W, int CP, const void* m,
    const float* scales, const int* sched, int chunk_cap, const int* perm,
    const int* centers, int N, int S, float inv_tr, float* out,
    const int* ext, void* stream) {
  if (!perm || !ext) return (int)cudaErrorInvalidValue;
  return by_channels<true, false, true>(CP, map, nullptr, H, W, 1, m, sched,
                                        chunk_cap, perm, centers, N, S,
                                        inv_tr, out, stream, 1.f, scales,
                                        qinv, ext);
}

extern "C" int tdr_crop_score_multi_init_lokf(
    const float* pyramid, const float* qinv, const int* table, int K, int CP,
    const void* m, const float* scales, const int* sched, int chunk_cap,
    const int* perm, const int* centers, int N, int S, float inv_tr,
    float* out, const int* ext, void* stream) {
  if (!perm || !ext) return (int)cudaErrorInvalidValue;
  return by_channels<false, false, true>(CP, pyramid, table, 0, 0, K, m,
                                         sched, chunk_cap, perm, centers, N,
                                         S, inv_tr, out, stream, 1.f, scales,
                                         qinv, ext);
}

extern "C" int tdr_crop_score_multi_init_raw_lokf(
    const float* pyramid, const float* qinv, const int* table, int K, int CP,
    const void* m, const float* scales, const int* sched, int chunk_cap,
    const int* perm, const int* centers, int N, int S, float inv_tr,
    float* out, const int* ext, void* stream) {
  if (!perm || !ext) return (int)cudaErrorInvalidValue;
  return by_channels<true, false, true>(CP, pyramid, table, 0, 0, K, m,
                                        sched, chunk_cap, perm, centers, N, S,
                                        inv_tr, out, stream, 1.f, scales,
                                        qinv, ext);
}

extern "C" int tdr_crop_score_init_i4_lokf(
    const unsigned char* codes, int H, int W, int CP, const void* m,
    const float* scales, const int* sched, int chunk_cap, const int* perm,
    const int* centers, int N, int S, float inv_tr, float* out,
    const int* ext, void* stream) {
  if (!perm || !ext) return (int)cudaErrorInvalidValue;
  return by_channels<false, true, true>(CP, codes, nullptr, H, W, 1, m, sched,
                                        chunk_cap, perm, centers, N, S,
                                        inv_tr, out, stream, 1.f, scales,
                                        nullptr, ext);
}

extern "C" int tdr_crop_score_init_raw_i4_lokf(
    const unsigned char* codes, int H, int W, int CP, const void* m,
    const float* scales, const int* sched, int chunk_cap, const int* perm,
    const int* centers, int N, int S, float inv_tr, float* out,
    const int* ext, void* stream) {
  if (!perm || !ext) return (int)cudaErrorInvalidValue;
  return by_channels<true, true, true>(CP, codes, nullptr, H, W, 1, m, sched,
                                       chunk_cap, perm, centers, N, S,
                                       inv_tr, out, stream, 1.f, scales,
                                       nullptr, ext);
}

extern "C" int tdr_crop_score_multi_init_i4_lokf(
    const unsigned char* codes, const int* table, int K, int CP,
    const void* m, const float* scales, const int* sched, int chunk_cap,
    const int* perm, const int* centers, int N, int S, float inv_tr,
    float* out, const int* ext, void* stream) {
  if (!perm || !ext) return (int)cudaErrorInvalidValue;
  return by_channels<false, true, true>(CP, codes, table, 0, 0, K, m, sched,
                                        chunk_cap, perm, centers, N, S,
                                        inv_tr, out, stream, 1.f, scales,
                                        nullptr, ext);
}

extern "C" int tdr_crop_score_multi_init_raw_i4_lokf(
    const unsigned char* codes, const int* table, int K, int CP,
    const void* m, const float* scales, const int* sched, int chunk_cap,
    const int* perm, const int* centers, int N, int S, float inv_tr,
    float* out, const int* ext, void* stream) {
  if (!perm || !ext) return (int)cudaErrorInvalidValue;
  return by_channels<true, true, true>(CP, codes, table, 0, 0, K, m, sched,
                                       chunk_cap, perm, centers, N, S, inv_tr,
                                       out, stream, 1.f, scales, nullptr,
                                       ext);
}
