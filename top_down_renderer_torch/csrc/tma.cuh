// TMA and mbarrier helpers of the kernels that stage operands in shared
// memory (csrc/probe_mm.cu, csrc/probe_window.cu, the theta search's
// csrc/crop_init.cuh, the tracked body's csrc/crop_tracked.cuh and
// csrc/conv_field_i8.cu): shared-memory addresses, bounded mbarrier waits
// and arrivals, 1-D bulk copies, 2-D and 3-D tensor-map loads, and
// cuTensorMapEncodeTiled reached through cudaGetDriverEntryPoint, so that
// no library links -lcuda.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Clock cycles a spin on a barrier or a flag may last before it traps:
// about ten seconds at the H100's 1.98 GHz.  A broken pipeline then fails
// its launch rather than hang the card.
constexpr long long kSpinTrapCycles = 20000000000LL;

__device__ __forceinline__ void trap_if_stuck(long long t0) {
  if (clock64() - t0 > kSpinTrapCycles) __trap();
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of `parity` to complete.  The fast path is one
// try_wait; only a wait that has to spin reads the clock, and it traps
// after kSpinTrapCycles.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) trap_if_stuck(t0);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// One 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global memory into shared memory, its bytes counted on
// `bar`; the arrival that expects them is the caller's (mbar_expect).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One bulk copy of `bytes` from global memory into shared memory, counted
// on `bar` (one arrival that expects the bytes).
__device__ __forceinline__ void load_chunk(void* dst, const void* src,
                                           int bytes, uint64_t* bar) {
  mbar_expect(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}

// One TMA box at element coordinates (x, y) of a 2-D tensor map into
// shared memory, counted on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}

// One TMA box at element coordinates (x, y, z) of a 3-D tensor map.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int x, int y, int z,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z),
      "r"(smem_addr(bar))
      : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, or null where the installed CUDA has none
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int kEncodeFailed = 1000;  // + the CUresult of an encode

}  // namespace
