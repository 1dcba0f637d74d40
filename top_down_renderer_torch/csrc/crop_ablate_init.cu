// The theta search with stages knocked out, for Hopper (sm_90a): an ablation
// that splits the wgmma theta search's time between its window gather, its
// three hi/lo products, its M ring, its per-chunk promotion and its
// epilogue.
//
// Replaces: tests/exp_crop_ablate.py::_kernel in its theta-search
// configuration (ABL_S_COLS = 128: the "(40 | 40 | kf) = 81 -> 128 cols" of
// top_down_renderer_tpu/filter/pallas_score.py:29, 256 for the int8 hi/lo
// planes), the TPU clone whose full_bf16, mm_only and dma_only cases test
// whether the 256-column init is bound by streaming the product.  The TPU
// stages have no counterpart here (Mosaic's DMA, lane rotate and 128-lane
// trim), so the variants knock out the port's own: the body is
// csrc/crop_init.cuh, the one the production kernel (csrc/crop_score_init.cu,
// crop_init_kernel) runs, and crop_ablate_init_kernel<CP, RAW, V>
// instantiates it with the stages of variant V:
//   0 full         every stage: the production kernel, bit for bit
//                  (tdr_crop_score_init[_raw], tdr_crop_score_multi_init[_raw]);
//   1 one_plane    A_hi B_hi only, one product a k16 step, not three (the
//                  TPU's full_bf16: one bf16 plane);
//   2 no_gather    the ring, the split and the three products on one pixel a
//                  row, its centre clamped into its level, read once and
//                  split again every chunk (the TPU's mm_only: a resident
//                  crop, no DMA);
//   3 gather_only  the ring, the window gather and the hi/lo split; each
//                  thread sums its fragments, hi into the even columns and
//                  hi + lo into the odd ones, no wgmma (the TPU's dma_only);
//   4 ring_only    the bulk copies and mbarrier waits of the M ring, each
//                  chunk's first pixel |dy| summed into the even columns and
//                  |dx| into the odd ones; no gather, no product (what
//                  moving the operands costs alone, flat_only's role);
//   5 no_promote   the six products of a chunk straight into the fp32
//                  accumulators, no fresh partial sum (Hopper's own stage:
//                  the tensor cores' truncating sums, crop_score_init.cu);
//   6 checked      every stage, every warp through the bounds-checked
//                  gather (the window route off): full's output bit for
//                  bit (the production kernel before its warps inside
//                  their level went unchecked).
// The variants that gather (full, one_plane, gather_only, no_promote) run
// the production kernel's window route (csrc/crop_init.cuh): a warp whose
// rows' windows lie in their level gathers without bounds checks.  The rows
// come in the order the caller gives them (perm, the uniform entry's too):
// by position (crop_score.init_order, as the production wrapper orders
// them) or in the particles' order (bucket-major, stable), so that the
// order's share of the time can be measured too; `checked` in the
// particles' order is the production kernel as it was before either.
// Each variant then runs the production epilogue on its columns (argmin, or
// raw rows), so its output depends on what it keeps; probes/crop_ablate.py
// holds a plain version of each.
//
// Every variant runs one block an SM, as full does by its registers (~150 a
// thread): a variant that keeps fewer registers would otherwise fit two
// and overlap twice the memory traffic, which full never does.  So each
// launch asks for kOneBlockSmem of dynamic shared memory, more than half
// of an SM's, and tdr_crop_ablate_init_blocks reports the blocks an SM
// that leaves (the occupancy calculator's figure).
//
// Bound (probes/__main__.py's ablate_init): the bytes the function needs,
// the compact map and M read once and the rows written, against the tensor
// work each variant keeps (full, no_gather and no_promote the three split
// products of M's nonzero entries, one_plane a third of it, none for
// gather_only and ring_only).  The bytes gather_only re-reads as windows
// and ring_only as M once a tile come from L2 and are reported beside it.
// Instantiated at CP = 4 and 8 (C = 3 and 6, the class counts of the
// repo's maps).

#include <cuda_runtime.h>

#include "crop_init.cuh"

namespace {

// Dynamic shared memory of every ablation launch: over half of Hopper's
// 228 KB an SM (less 1 KB reserved a block), so no SM holds two blocks.
constexpr int kOneBlockSmem = 116 * 1024;
static_assert(kOneBlockSmem >= kRingBytes<4> &&
                  kOneBlockSmem >= kRingBytes<8>,
              "the ring fits the pinned shared memory");

// Variant 6: the whole body (kFull) on the checked gather.
constexpr int kChecked = 6;

template <int CP, bool RAW, int V>
__global__ void __launch_bounds__(kThreads, 1)
    crop_ablate_init_kernel(const float* __restrict__ map,
                            const int4* __restrict__ table, int H, int W,
                            const unsigned char* __restrict__ m,
                            const int* __restrict__ sched, int K,
                            int chunk_cap, const int* __restrict__ perm,
                            const int2* __restrict__ centers, int S,
                            float inv_tr, float* __restrict__ out,
                            const int4* __restrict__ ext) {
  constexpr int kBody = V == kChecked ? kFull : V;  // its stages
  constexpr bool kWin =
      V != kChecked && V != kNoGather && V != kRingOnly;  // a gather's
  init_body<CP, RAW, kBody, false, false, kWin>(
      map, table, H, W, m, sched, K, chunk_cap, perm, centers, S, inv_tr,
      out, 1.f, nullptr, nullptr, ext);
}

using Kernel = decltype(&crop_ablate_init_kernel<4, false, kFull>);

template <int CP, bool RAW>
Kernel by_variant(int variant) {
  switch (variant) {
    case kFull: return crop_ablate_init_kernel<CP, RAW, kFull>;
    case kOnePlane: return crop_ablate_init_kernel<CP, RAW, kOnePlane>;
    case kNoGather: return crop_ablate_init_kernel<CP, RAW, kNoGather>;
    case kGatherOnly: return crop_ablate_init_kernel<CP, RAW, kGatherOnly>;
    case kRingOnly: return crop_ablate_init_kernel<CP, RAW, kRingOnly>;
    case kNoPromote: return crop_ablate_init_kernel<CP, RAW, kNoPromote>;
    case kChecked: return crop_ablate_init_kernel<CP, RAW, kChecked>;
    default: return nullptr;
  }
}

// The kernel of (variant, CP, raw); null where none is built.
Kernel kernel_of(int variant, int CP, int raw) {
  switch (CP) {
    case 4: return raw ? by_variant<4, true>(variant)
                       : by_variant<4, false>(variant);
    case 8: return raw ? by_variant<8, true>(variant)
                       : by_variant<8, false>(variant);
    default: return nullptr;
  }
}

int launch(int variant, int CP, int raw, const float* map, const int* table,
           int H, int W, int K, const void* m, const int* sched,
           int chunk_cap, const int* perm, const int* centers, int N, int S,
           float inv_tr, float* out, const int* ext, void* stream) {
  const Kernel kern = kernel_of(variant, CP, raw);
  if (kern == nullptr || !valid_search(S, K) || !perm || !ext)
    return (int)cudaErrorInvalidValue;
  int opt_in = -1;  // no state kept: every launch sets its opt-in
  return (int)launch_tiles(kern, &opt_in, kOneBlockSmem, map, table, H, W,
                           K, m, sched, chunk_cap, perm, centers, N, S,
                           inv_tr, out, static_cast<cudaStream_t>(stream),
                           reinterpret_cast<const int4*>(ext));
}

}  // namespace

// Plain C entry points (loaded with ctypes); each returns the CUDA error of
// its launch.  variant 0-6 as above; the other arguments are those of
// tdr_crop_score_init and tdr_crop_score_multi_init (perm and ext refused
// null), with CP in {4, 8}, then raw: 0 for (best, k, kf) rows, 1 for the
// raw rows.
extern "C" int tdr_crop_ablate_init(int variant, const float* map, int H,
                                    int W, int CP, const void* m,
                                    const int* sched, int chunk_cap,
                                    const int* perm, const int* centers,
                                    int N, int S, float inv_tr, float* out,
                                    const int* ext, int raw, void* stream) {
  return launch(variant, CP, raw, map, nullptr, H, W, 1, m, sched, chunk_cap,
                perm, centers, N, S, inv_tr, out, ext, stream);
}

extern "C" int tdr_crop_ablate_multi_init(int variant, const float* pyramid,
                                          const int* table, int K, int CP,
                                          const void* m, const int* sched,
                                          int chunk_cap, const int* perm,
                                          const int* centers, int N, int S,
                                          float inv_tr, float* out,
                                          const int* ext, int raw,
                                          void* stream) {
  return launch(variant, CP, raw, pyramid, table, 0, 0, K, m, sched,
                chunk_cap, perm, centers, N, S, inv_tr, out, ext, stream);
}

// *blocks = the blocks of (variant, CP, raw) an SM holds at once with the
// launches' shared memory; returns the CUDA error of the query.
extern "C" int tdr_crop_ablate_init_blocks(int variant, int CP, int raw,
                                           int* blocks) {
  const Kernel kern = kernel_of(variant, CP, raw);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kOneBlockSmem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kern, kThreads, kOneBlockSmem);
}
