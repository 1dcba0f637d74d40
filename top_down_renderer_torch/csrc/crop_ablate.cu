// The tracked crop kernel with stages knocked out, for Hopper (sm_90a): an
// ablation that splits the kernel's time between the per-run weight fold,
// the pixel gather and the FMAs.
//
// Replaces: tests/exp_crop_ablate.py::_kernel (the TPU crop kernel cloned
// at mo 24 and P_TILE 64 with its DMA, lane roll and matmul knocked out one
// at a time).  The TPU stages have no counterpart here, so the variants knock
// out the port's own: the body is csrc/crop_tracked.cuh, the one the
// production kernel (csrc/crop_score.cu, crop_tracked_kernel) runs, and
// crop_ablate_kernel<C, V> instantiates it with the stages of variant V:
//   0 full         every stage: the production kernel, bit for bit
//   1 no_fold      weights and pixels folded for a block's first run only
//   2 no_gather    each lane reads the particle's centre pixel, not its own
//   3 gather_only  the pixels summed without weights, no weight fold
//   4 fold_only    the per-run fold, no pixel loop
//   5 checked      every stage, every row through the bounds-checked loop
//                  one row a warp (the production kernel before its rows
//                  inside the level went unchecked, two a warp)
// Variants 0-3 run the production kernel's loop: rows inside their level
// unchecked, two a warp.  Each variant's output depends on what it keeps
// (crop_tracked.cuh), and probes/crop_ablate.py holds a plain version of
// each.  The rows come in the order the caller sorted them: by group and
// position (crop_score.tracked_order, as the production wrapper sorts
// them) or by group alone (kshift 0, tracked_rows), so that the order's
// share can be timed too.
//
// Bound: as the tracked kernel's, less the stages knocked out (the FMAs of
// 2 (C + 1) float32 FLOPs per distinct pixel and particle, or the compact
// map's bytes read once); what each variant measures is the time of the
// stages it keeps.  Instantiated at C = 3 and 6, the class counts of the
// repo's maps.

#include <cuda_runtime.h>

#include <cstddef>

#include "crop_tracked.cuh"

namespace {

template <int C, int V>
__global__ void __launch_bounds__(kThreads, 2)
    crop_ablate_kernel(const float* __restrict__ map,
                       const int4* __restrict__ table, int H, int W,
                       const float* __restrict__ scan,
                       const float* __restrict__ cw,
                       const int2* __restrict__ pix,
                       const int* __restrict__ npix,
                       const int* __restrict__ order,
                       const int* __restrict__ seg, int Th, int R, int P,
                       const int* __restrict__ skey,
                       const long long* __restrict__ perm,
                       const int2* __restrict__ centers, int N, float inv_tr,
                       float* __restrict__ out, int kshift) {
  __shared__ Window window;  // the rows' centres and the bucket's extent
  tracked_body<C, V>(map, table, H, W, scan, cw, pix, npix, order, seg, Th,
                     R, P, skey, perm, centers, N, inv_tr, out, nullptr,
                     nullptr, nullptr, &window, kshift);
}

template <int C, int V>
cudaError_t launch(const float* map, const int* table, int H, int W,
                   const float* scan, const float* cw, const int* pix,
                   const int* npix, const int* order, const int* seg, int Th,
                   int R, int P, const int* skey, const long long* perm,
                   const int* centers, int N, float inv_tr, float* out,
                   int kshift, cudaStream_t stream) {
  static int ready_dev = -1;
  static size_t ready_smem = 0;
  auto kern = crop_ablate_kernel<C, V>;
  const size_t smem = smem_bytes<C>(Th * R, P);
  cudaError_t err = opt_in_smem(kern, smem, &ready_dev, &ready_smem);
  if (err != cudaSuccess) return err;
  kern<<<(N + kTile - 1) / kTile, kThreads, smem, stream>>>(
      map, reinterpret_cast<const int4*>(table), H, W, scan, cw,
      reinterpret_cast<const int2*>(pix), npix, order, seg, Th, R, P, skey,
      perm, reinterpret_cast<const int2*>(centers), N, inv_tr, out, kshift);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_variant(int variant, const float* map, const int* table,
                           int H, int W, const float* scan, const float* cw,
                           const int* pix, const int* npix, const int* order,
                           const int* seg, int Th, int R, int P,
                           const int* skey, const long long* perm,
                           const int* centers, int N, float inv_tr,
                           float* out, int kshift, cudaStream_t stream) {
#define TDR_ABLATE_CASE(V)                                                 \
  case V:                                                                  \
    return launch<C, V>(map, table, H, W, scan, cw, pix, npix, order, seg, \
                        Th, R, P, skey, perm, centers, N, inv_tr, out,     \
                        kshift, stream);
  switch (variant) {
    TDR_ABLATE_CASE(kFull)
    TDR_ABLATE_CASE(kNoFold)
    TDR_ABLATE_CASE(kNoGather)
    TDR_ABLATE_CASE(kGatherOnly)
    TDR_ABLATE_CASE(kFoldOnly)
    TDR_ABLATE_CASE(kChecked)
    default: return cudaErrorInvalidValue;
  }
#undef TDR_ABLATE_CASE
}

}  // namespace

// Plain C entry point (loaded with ctypes); returns the CUDA error of its
// launch.  variant 0-5 as above; the other arguments are those of
// tdr_crop_score_tracked (table null: one map of H x W) or of
// tdr_crop_score_multi_tracked (table (K, 4): the buckets' levels; H, W
// unused), with C in {3, 6}, kshift (0..30) after out.
extern "C" int tdr_crop_ablate(int variant, const float* map,
                               const int* table, int K, int H, int W, int C,
                               const float* scan, const float* cw,
                               const int* pix, const int* npix,
                               const int* order, const int* seg, int Th,
                               int R, int P, const int* skey,
                               const long long* perm, const int* centers,
                               int N, float inv_tr, float* out, int kshift,
                               void* stream) {
  if ((table && (K < 1 || K > kMaxBuckets)) || kshift < 0 || kshift > 30)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 3:
      return (int)launch_variant<3>(variant, map, table, H, W, scan, cw, pix,
                                    npix, order, seg, Th, R, P, skey, perm,
                                    centers, N, inv_tr, out, kshift, s);
    case 6:
      return (int)launch_variant<6>(variant, map, table, H, W, scan, cw, pix,
                                    npix, order, seg, Th, R, P, skey, perm,
                                    centers, N, inv_tr, out, kshift, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
