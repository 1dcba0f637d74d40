"""Where the row-order kernel's time goes, on the card.

Builds the row order (crop_order_kernel in csrc/crop_score.cu, the
section from spread_bits to the tracked kernel) of the checkout at ROOT
once per variant, with its block size, rows a thread and look-back window
set from the command line, and with a %globaltimer stamp written by each
block's thread 0 at every step boundary: the key pass, the counts' flush
and the first grid barrier, the digits' first slots, then for each pass
(its first tile) the ranking, the digit sums and look-back, the staged
write and the grid barrier.  Each variant runs on 102,400 rows of
tests/torch_parity.py's order cases "shifts" (100 groups, four passes),
"one_group" (three) and "keys_alone" (two), and on 2^20 rows of
"shifts"; each result is held to crop_score.order_rows_plain bit for bit
first.  Prints one JSON line a (variant, case): the kernel's time by CUDA
events over 100 launches, and each stamp's latest block, relative to the
earliest start, as the median of five stamped launches (ns).  First, one
line with the registers, stack and local bytes a thread of each
crop_order_kernel instantiation in ROOT's own crop_score library (cuobjdump
--dump-resource-usage; local bytes are spills).

    python tests/time_torch_order.py [--variant THREADS,ITEMS,LOOKBACK ...] [ROOT]

(default variants: the production constants, then 1024,2,16, 1024,1,8,
512,4,8 and 256,8,16).  The stamps cost a store a step; compare variants
within one run.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

PHASES = ("key pass", "flush and barrier", "digit slots")
PASS_PHASES = ("rank", "sums and look-back", "staged write", "barrier")
CASES = (("shifts", 102_400), ("one_group", 102_400),
         ("keys_alone", 102_400), ("shifts", 1 << 20))

HEAD = '''#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>
#include "tma.cuh"
namespace {
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
'''
TAIL = '''
int grid_for(int N) {
  int sms = 0, per_sm = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, crop_order_kernel<long long, long long>, kOrderThreads, 0);
  const int tiles = (N + kOrderTile - 1) / kOrderTile;
  return std::min(std::max(tiles, 1), sms * per_sm);
}
}  // namespace
extern "C" int stamped_order(const void* key, const int* ctr, int N,
                             int kshift, int tbits, int hi, int* skey,
                             long long* perm, unsigned* scratch,
                             void* pairs, unsigned epoch,
                             unsigned long long* stamps, void* stream) {
  int grid = grid_for(N), K = 0;
  const long long* k = static_cast<const long long*>(key);
  const int2* c = reinterpret_cast<const int2*>(ctr);
  long long* rs = nullptr;
  unsigned long long* pr = static_cast<unsigned long long*>(pairs);
  void* args[] = {(void*)&k, (void*)&c, &N,   &kshift,  &tbits,
                  &hi,       &K,        &skey, &perm,   &rs,
                  &scratch,  &pr,       &epoch, &stamps};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(crop_order_kernel<long long, long long>),
      dim3(grid), dim3(kOrderThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
extern "C" int stamped_grid(int N) { return grid_for(N); }
extern "C" int stamped_tile() { return kOrderTile; }
'''
STAMP = ("if (stamps && threadIdx.x == 0 && ns < 24) "
         "stamps[blockIdx.x * 24 + ns++] = gtime();")


def stamped_source(root: str) -> str:
    """The order section of ROOT's crop_score.cu with its constants made
    macros and a stamp at each step boundary."""
    src = open(os.path.join(root, "top_down_renderer_torch", "csrc",
                            "crop_score.cu")).read()
    body = src[src.index("// v's bits 0-15 moved to the even bit"):
               src.index("// The tracked kernel: its body")]
    subs = [
        (r"constexpr int kOrderThreads = \d+;",
         "constexpr int kOrderThreads = THREADS;"),
        (r"constexpr int kOrderItems = \d+;",
         "constexpr int kOrderItems = ITEMS;"),
        (r"constexpr int kLookBack = \d+;",
         "constexpr int kLookBack = LOOKBACK;"),
        (r"unsigned long long\* pairs, unsigned epoch\) \{\n",
         "unsigned long long* pairs, unsigned epoch, "
         "unsigned long long* stamps) {\n  int ns = 0;\n  STAMP\n"),
        (r"(\n  __syncthreads\(\);\n)(  for \(int e = t; e < kOrderBins; "
         r"e \+= kOrderThreads\)\n    if \(s_digit\[e\]\))",
         r"\1  STAMP\n\2"),
        (r"(  grid_barrier\(counters \+ kOrderBarrier, gridDim\.x\);\n)",
         r"\1  STAMP\n"),
        (r"(  // 3\. the passes\n)", r"  STAMP\n\1"),
        (r"(      __syncthreads\(\);\n)(      // digit d over warps)",
         r"\1      if (tile == blockIdx.x) STAMP\n\2"),
        (r"(        s_slot\[d\] = [^\n]*\n      \}\n      __syncthreads\(\);"
         r"\n)", r"\1      if (tile == blockIdx.x) STAMP\n"),
        (r"(      __syncthreads\(\);  // s_big[^\n]*\n)(    \}\n    if "
         r"\(!last\) grid_barrier\([^\n]*\n)",
         r"\1      if (tile == blockIdx.x) STAMP\n\2    STAMP\n"),
    ]
    for pat, rep in subs:
        body, n = re.subn(pat, rep, body)
        if n != 1:
            raise RuntimeError(f"the order kernel's source changed: {pat!r} "
                               f"matched {n} times")
    return HEAD + body.replace("STAMP\n", STAMP + "\n") + TAIL


def build(root: str, variant, workdir: str):
    from top_down_renderer_torch import kernels

    threads, items, lookback = variant
    src = os.path.join(workdir, "order_stamped.cu")
    with open(src, "w") as f:
        f.write(stamped_source(root))
    lib = os.path.join(workdir, f"order_{threads}_{items}_{lookback}.so")
    csrc = os.path.join(root, "top_down_renderer_torch", "csrc")
    proc = subprocess.run(
        [kernels.find_nvcc(), *kernels.NVCC_FLAGS, f"-I{csrc}",
         f"-DTHREADS={threads}", f"-DITEMS={items}",
         f"-DLOOKBACK={lookback}", "-Xptxas", "-v", "-o", lib, src],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr[-4000:]}")
    spill = [ln.strip() for ln in proc.stderr.splitlines()
             if "spill" in ln or "registers" in ln][:2]
    so = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    so.stamped_order.argtypes = [p, p, i, i, i, i, p, p, p, p,
                                 ctypes.c_uint, p, p]
    return so, spill


def production_resources() -> dict:
    """{instantiation: {"REG", "STACK", "LOCAL"}} of crop_order_kernel in
    the crop_score library that kernels.build makes."""
    from top_down_renderer_torch import kernels

    tool = os.path.join(os.path.dirname(kernels.find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "--dump-resource-usage",
                          str(kernels.build("crop_score"))],
                         capture_output=True, text=True, check=True).stdout
    found, fn = {}, None
    for line in out.splitlines():
        if "Function " in line:
            fn = re.search(r"crop_order_kernelI(\w+?)EEv", line)
        elif fn and "REG:" in line:
            found[fn.group(1)] = {k: int(m.group(1)) if m else None
                                  for k, m in ((k, re.search(rf"{k}:(\d+)",
                                                             line))
                                               for k in ("REG", "STACK",
                                                         "LOCAL"))}
            fn = None
    return found


def run(so, case: str, n: int) -> dict:
    import numpy as np
    import torch

    from top_down_renderer_torch.filter import crop_score as cs
    from torch_parity import order_case

    dev = torch.device("cuda")
    key, ctr, groups, extent = order_case(case, n)
    tkey = torch.as_tensor(key, device=dev)
    tctr = None if ctr is None else torch.as_tensor(ctr, device=dev)
    kshift, tbits = (0, 0) if ctr is None else cs.order_bits(groups, extent)
    hi = (1 << (kshift // 2 + tbits)) - 1
    tiles = -(-n // so.stamped_tile())
    scratch = torch.zeros(2 * cs.ORDER_COUNTERS + 2 * 256 * tiles,
                          dtype=torch.int32, device=dev)
    pairs = torch.empty(2 * n, dtype=torch.int64, device=dev)
    skey = torch.empty(n, dtype=torch.int32, device=dev)
    perm = torch.empty(n, dtype=torch.int64, device=dev)
    grid = so.stamped_grid(n)
    stamps = torch.zeros(grid * 24, dtype=torch.int64, device=dev)
    epoch = [0]

    def call(st=None):
        epoch[0] += 1
        err = so.stamped_order(
            tkey.data_ptr(), None if tctr is None else tctr.data_ptr(), n,
            kshift, tbits, hi, skey.data_ptr(), perm.data_ptr(),
            scratch.data_ptr(), pairs.data_ptr(), epoch[0],
            None if st is None else st.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"stamped_order: CUDA error {err}")

    want = cs.order_rows_plain(tkey, tctr, groups or 0, extent)
    call()
    if not (torch.equal(skey, want[0]) and torch.equal(perm, want[1])):
        raise RuntimeError(f"{case}: the stamped kernel's order differs")
    for _ in range(5):
        call()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(100):
        call()
    b.record()
    torch.cuda.synchronize()
    rows = []
    for _ in range(5):
        stamps.zero_()
        call(stamps)
        torch.cuda.synchronize()
        s = stamps.view(grid, 24).cpu().numpy()
        s = s[:, :int((s[0] > 0).sum())]
        rows.append(s.max(0) - s[:, 0].min())
    med = np.median(np.stack(rows), 0).astype(int).tolist()
    names = list(PHASES) + [f"pass {q} {ph}"  # no barrier after the last
                            for q in range((len(med) - 4) // 4)
                            for ph in PASS_PHASES]
    return {"case": case, "rows": n, "grid": grid, "kshift": kshift,
            "events_us": a.elapsed_time(b) / 100 * 1e3,
            "stamps_ns": dict(zip(names, med[1:]))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("root", nargs="?", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import torch

    import chip_smoke as smoke
    from top_down_renderer_torch.filter import crop_score as cs

    if not torch.cuda.is_available():
        print("time_torch_order: no CUDA device", file=sys.stderr)
        return 1
    src = stamped_source(root)
    prod = tuple(int(re.search(rf"constexpr int {k} = (\d+);", open(
        os.path.join(root, "top_down_renderer_torch", "csrc",
                     "crop_score.cu")).read()).group(1))
        for k in ("kOrderThreads", "kOrderItems", "kLookBack"))
    assert src and cs.ORDER_TILE == prod[0] * prod[1]
    variants = [tuple(int(x) for x in v.split(",")) for v in args.variant]
    variants = variants or [prod, (1024, 2, 16), (1024, 1, 8), (512, 4, 8),
                            (256, 8, 16)]
    card = smoke.card_name_and_limit()
    print(json.dumps({"card": card, "crop_order_kernel": (
        production_resources())}), flush=True)
    with tempfile.TemporaryDirectory() as work:
        for v in variants:
            so, regs = build(root, v, work)
            for case, n in CASES:
                print(json.dumps({"variant": v, "production": v == prod,
                                  "card": card, "ptxas": regs,
                                  **run(so, case, n)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
