"""Where the int8 conv quantizer's time goes, on the card.

Builds the quantizer of the checkout at ROOT (conv_quant_i8_kernel in
csrc/conv_field_i8.cu: a copy of the whole source, with a variant's
constexpr ints set) once per variant, with a %globaltimer stamp
written by each block's thread 0 at every phase boundary, and runs it
through ROOT's own wrapper (conv_score.quantize_i8, its library swapped
for the stamped one).  Two designs are known, told apart by their source:

- "slices" (the first design): stage 1's loads (one item a block: the
  max |kq| of a slice of a column), its block reduction, the grid
  barrier, stage 2's read of the column maxima, its first value load,
  the rounding and stores of its items, the chunk's flag (each for the
  block's last unit);
- "chunks" (the current one): the staged chunks' copies issued, the max
  of the chunks read from device memory (those the block's shared memory
  does not hold), the copies landed, the staged chunks' max and the
  block's maxima written, the grid barrier, the group's maxima reduced
  and the scales, the rounding and stores, the flags; where the chunks a
  block takes outnumber those its shared memory holds, the end of the
  last batch but one and the last batch's copies landed.

Each stamp's latest block (and the latest block's start), relative to the
earliest block's start, is the median of five stamped launches (ns).
Beside it: the kernel's device time a call under torch.profiler (20
calls after 3), the wrapper's host
time a call (median of 200 calls, no synchronisation), the grid, and
each launch's B, flags and scales held to quantize_conv_kernel laid out
by i8_layout bit for bit.  Cases: D's clustered conv cell (W 16, C 3: CP
4, mo 24: S_out 33, a 1.32 MB kernel) and the largest shape the int8
field takes (W 64, C 6: CP 8, mo 48: S_out 129, two column groups, 39.6
MB), or those given.  First, one line with the registers, stack and
local bytes of every conv_quant_i8_kernel instantiation in ROOT's own
library (cuobjdump --dump-resource-usage; local bytes are spills), and
ptxas's line for each stamped build.

    python tests/time_torch_conv_quant.py [--case WW,C,MO ...]
        [--variant NAME=VALUE[,NAME=VALUE] ...] [ROOT]

A variant sets constexpr ints of the source (for example
kQuantThreads=512), or cluster=N: the grid barrier replaced by a cluster
of N blocks a group (CLUSTER_SUBS); the default is the production source
alone.  The
stamps cost a store a phase; compare variants within one run.
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
import time

CASES = ((16, 3, 24), (64, 6, 48))
SLOTS = 16  # stamps a block

HEAD = r'''
__device__ unsigned long long* g_stamps;
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// a stamp once v has arrived (the timer is read after the load returns)
__device__ __forceinline__ unsigned long long gtime_after(float v) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) : "f"(v));
  return t;
}
#define STAMP(i) \
  if (g_stamps && threadIdx.x == 0) g_stamps[blockIdx.x * 16 + (i)] = gtime();
#define STAMPV(i, v) \
  if (g_stamps && threadIdx.x == 0) \
    g_stamps[blockIdx.x * 16 + (i)] = gtime_after(v);
'''
TAIL = r'''
extern "C" int stamped_set(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, &p, sizeof(p)));
}
'''

# design -> (a string only its source holds, its phases, the substitutions
# (pattern, replacement, count) that place the stamps)
DESIGNS = {
    "slices": ("kQuantSlice", (
        "stage 1 loads", "stage 1 block reduction", "grid barrier",
        "stage 2 maxima read", "stage 2 first value load",
        "rounding and stores", "flag"), [
        (r"(const int tid = threadIdx\.x, lane = tid & 31, warp = tid >> "
         r"5;\n)", r"\1  STAMP(0)\n", 1),
        (r"(qinv\[e / taps\]\)\)\);\n)", r"\1    STAMPV(1, m)\n", 1),
        (r"(partial\[it\] = fmaxf\(part\[0\], m\);\n    \}\n    "
         r"__syncthreads\(\);\n)", r"\1    STAMP(2)\n", 1),
        (r"(cg::this_grid\(\)\.sync\(\);\n)", r"\1  STAMP(3)\n", 1),
        (r"(      __syncthreads\(\);\n      scaled = grp;\n)",
         r"\1      STAMP(4)\n", 1),
        (r"(          const float q = qinv\[c\];\n)",
         r"\1          if (i == tid && j == 0) STAMPV(5, v)\n", 1),
        (r"(\n)(    any = __syncthreads_or\(any\);\n)",
         r"\1    STAMP(6)\n\2", 1),
        (r"(    if \(tid == 0\) nonzero\[u\] = any != 0;\n)",
         r"\1    STAMP(7)\n", 1),
    ]),
    "chunks": ("kQuantMaxChunks", (
        "copies issued", "max of chunks from device memory",
        "copies landed", "staged max and block maxima",
        "grid barrier", "group maxima and scales", "rounding and stores",
        "flags", "a batch rounded (the last before the last)",
        "copied in again (the last batch)"), [
        (r"(  // stamp: start\n)", r"\1  STAMP(0)\n", 1),
        (r"(  // stamp: copies issued\n)", r"\1  STAMP(1)\n", 1),
        (r"(  // stamp: unstaged max\n)", r"\1  STAMP(2)\n", 1),
        (r"(  // stamp: copies landed\n)", r"\1  STAMP(3)\n", 1),
        (r"(  // stamp: block maxima\n)", r"\1  STAMP(4)\n", 1),
        (r"(  // stamp: grid barrier\n)", r"\1  STAMP(5)\n", 1),
        (r"(  // stamp: scales\n)", r"\1  STAMP(6)\n", 1),
        (r"(  // stamp: rounded\n)", r"\1  STAMP(7)\n", 1),
        (r"(  // stamp: flags\n)", r"\1  STAMP(8)\n", 1),
        (r"(      // stamp: a batch rounded\n)", r"\1      STAMP(9)\n", 1),
        (r"(      // stamp: copied in again\n)", r"\1      STAMP(10)\n", 1),
    ]),
}


def source_path(root: str) -> str:
    return os.path.join(root, "top_down_renderer_torch", "csrc",
                        "conv_field_i8.cu")


def design_of(src: str) -> str:
    found = [k for k, (mark, _, _) in DESIGNS.items() if mark in src]
    if len(found) != 1:
        raise RuntimeError(f"the quantizer's design is not known: {found}")
    return found[0]


def stamped_source(root: str, consts: dict, cluster: int = 0) -> tuple:
    """(design, ROOT's conv_field_i8.cu with stamps at its quantizer's
    phase boundaries, `consts` set, and with cluster > 0 the cluster
    variant)."""
    src = open(source_path(root)).read()
    design = design_of(src)
    if cluster:
        if design != "chunks":
            raise RuntimeError("the cluster variant is of the chunks design")
        src = cluster_source(src, cluster)
    for pat, rep, count in DESIGNS[design][2]:
        src, n = re.subn(pat, rep, src)
        if n != count:
            raise RuntimeError(f"the quantizer's source changed: {pat!r} "
                               f"matched {n} times")
    for name, value in consts.items():
        src, n = re.subn(rf"constexpr int {name} = [^;]+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"no constexpr int {name} in the source")
    head = '#include "tma.cuh"\n'
    return design, src.replace(head, head + HEAD, 1) + TAIL


# The "chunks" design with its grid barrier replaced by a cluster's: a
# group's chunks over the `CLUSTER` blocks of one cluster (non-portable
# above 8), each block's column maxima read by the others through
# distributed shared memory, no grid barrier and no partial maxima in
# device memory.  It applies where a group's chunks fit the cluster's
# shared memory (D's cell: 1.32 MB over 8 or 16 blocks).
CLUSTER_SUBS = [
    (r"  __syncthreads\(\);\n  if \(tid < cols\)\n    partial\[.*?"
     r"  __syncthreads\(\);\n  // stamp: scales\n", r"""  __syncthreads();
  // stamp: block maxima
  cluster_sync();
  // stamp: grid barrier
  if (tid < cols) {
    unsigned m = 0u;
    for (int r = 0; r < per_group; ++r)
      m = max(m, static_cast<unsigned>(ld_cluster(
                     reinterpret_cast<const int*>(&col_max[tid]), r)));
    const float amax = fmaxf(__uint_as_float(m), 1e-30f);
    col_scale[0][tid] = __fmul_rn(amax, hi_recip);
    col_scale[1][tid] = __fmul_rn(amax, lo_recip);
    if (bg == 0) {
      scales[2 * (g * kCols + tid)] = col_scale[0][tid];
      scales[2 * (g * kCols + tid) + 1] = col_scale[1][tid];
    }
  }
  cluster_sync();  // every block's maxima read
  // stamp: scales
""", 1),
    (r"  int per_group = sms / groups;", r"  int per_group = CLUSTER;", 1),
    (r"  err = cudaLaunchCooperativeKernel\(reinterpret_cast<const void\*>"
     r"\(kern\),\n.*?smem, stream\);\n", r"""  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kQuantThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = per_group;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kern),
                            args);
""", 1),
]


def cluster_source(src: str, cluster: int) -> str:
    for pat, rep, count in CLUSTER_SUBS:
        src, n = re.subn(pat, rep, src, flags=re.S)
        if n != count:
            raise RuntimeError(f"the quantizer's source changed: {pat!r} "
                               f"matched {n} times")
    return src.replace("CLUSTER;", f"{cluster};", 1)


def build(root: str, consts: dict, workdir: str, tag: str):
    from top_down_renderer_torch import kernels

    consts = dict(consts)
    design, text = stamped_source(root, consts,
                                  int(consts.pop("cluster", 0)))
    src = os.path.join(workdir, f"quant_{tag}.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(workdir, f"quant_{tag}.so")
    csrc = os.path.dirname(source_path(root))
    proc = subprocess.run(
        [kernels.find_nvcc(), *kernels.NVCC_FLAGS, f"-I{csrc}", "-Xptxas",
         "-v", "-o", lib, src], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr[-4000:]}")
    lines = proc.stderr.splitlines()
    ptxas = [" | ".join(x.strip() for x in lines[i + 1 : i + 4])
             for i, ln in enumerate(lines)
             if "Compiling entry function" in ln
             and "conv_quant_i8_kernel" in ln]
    so = ctypes.CDLL(lib)
    for fn, argtypes in kernels._SIGNATURES["conv_field_i8"].items():
        f = getattr(so, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    so.stamped_set.argtypes = [ctypes.c_void_p]
    return design, so, ptxas


def production_resources() -> dict:
    """{instantiation: {"REG", "STACK", "SHARED", "LOCAL"}} of
    conv_quant_i8_kernel in the conv_field_i8 library kernels.build
    makes."""
    from top_down_renderer_torch import kernels

    tool = os.path.join(os.path.dirname(kernels.find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "--dump-resource-usage",
                          str(kernels.build("conv_field_i8"))],
                         capture_output=True, text=True, check=True).stdout
    found, fn = {}, None
    for line in out.splitlines():
        if "Function " in line:
            fn = re.search(r"(conv_quant_i8_kernel\w*)", line)
        elif fn and "REG:" in line:
            found[fn.group(1)] = {
                k: int(m.group(1)) if m else None
                for k, m in ((k, re.search(rf"{k}:(\d+)", line))
                             for k in ("REG", "STACK", "SHARED", "LOCAL"))}
            fn = None
    return found


def quant_case(ww: int, c: int, mo: int, dev):
    """The tracked conv kernel (S_out = 2 W + 1, CP, dr, dc) of a random
    scan at the bucket's f, and the int8 map's qinv, of a random 256^2 map
    of c classes (seed 0)."""
    import numpy as np
    import torch

    from top_down_renderer_torch.filter import conv_score
    from top_down_renderer_torch.filter import crop_score as cs
    from top_down_renderer_torch.maps.polar import polar_stencil

    rng = np.random.default_rng(0)
    hw = 256
    packed = np.zeros((hw, hw, 8), np.float32)
    packed[..., :c] = rng.random((hw, hw, c)) * 50
    packed[..., c] = rng.random((hw, hw)) < 0.9
    cmap = conv_score.ConvMap(cs.compact_map(torch.as_tensor(
        packed, device=dev), c), int8=True)
    scan = torch.as_tensor((rng.random((c, 100, 25)) * 3).astype(
        np.float32), device=dev)
    cw = torch.as_tensor(rng.random(c).astype(np.float32) + 0.5, device=dev)
    sten = torch.as_tensor(polar_stencil(100, 25), device=dev)
    kernel = conv_score.build_conv_kernel(scan, cw, sten, mo / 24.0, mo,
                                          "tracked", window_w=ww, s0=95)
    return kernel, cmap.qinv


def run(so, design: str, case) -> dict:
    import numpy as np
    import torch

    from top_down_renderer_torch import kernels
    from top_down_renderer_torch.filter import conv_score

    dev = torch.device("cuda")
    kernel, qinv = quant_case(*case, dev)
    ints, ref_scales = conv_score.quantize_conv_kernel(kernel, qinv)
    ref_b, ref_nz = conv_score.i8_layout(ints)
    stamps = torch.zeros(4096 * SLOTS, dtype=torch.int64, device=dev)
    orig = kernels.load
    kernels.load = lambda name: so if name == "conv_field_i8" else orig(name)
    try:
        def call():
            return conv_score.quantize_i8(kernel, qinv)

        def held(out) -> None:
            b, nz, sc = out
            if not (torch.equal(b, ref_b) and torch.equal(nz, ref_nz)
                    and torch.equal(sc.view(torch.int32),
                                    ref_scales.view(torch.int32))):
                raise RuntimeError(f"{case}: the stamped quantizer differs "
                                   "from its plain version")

        so.stamped_set(None)
        held(call())
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        kernel_us = sum(e.device_time_total for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and "conv_quant_i8" in e.key) / 20
        host = []
        for _ in range(200):
            t0 = time.perf_counter()
            call()
            host.append(time.perf_counter() - t0)
            if len(host) % 50 == 0:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        so.stamped_set(ctypes.c_void_p(stamps.data_ptr()))
        rows = []
        for _ in range(5):
            stamps.zero_()
            out = call()
            torch.cuda.synchronize()
            held(out)
            s = stamps.view(-1, SLOTS).cpu().numpy()
            s = s[s[:, 0] > 0]
            start = s[:, 0].min()
            rows.append([int(s[:, 0].max() - start)] + [
                int(s[:, i].max() - start) if (s[:, i] > 0).any() else -1
                for i in range(1, SLOTS)])
        so.stamped_set(None)
    finally:
        kernels.load = orig
    grid = len(s)
    med = np.median(np.array(rows), 0).astype(int).tolist()
    names = ("latest block start",) + DESIGNS[design][1]
    return {"case": {"ww": case[0], "classes": case[1], "mo": case[2],
                     "s_out": int(kernel.shape[0]), "cp": int(kernel.shape[1]),
                     "kernel_mb": kernel.numel() * 4 / 1e6},
            "grid": grid, "kernel_us": kernel_us,
            "wrapper_host_us": float(np.median(host)) * 1e6,
            "stamps_ns": dict(zip(names, med[: len(names)]))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", action="append", default=[],
                    help="WW,C,MO: window W, classes, conv bucket mo")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=VALUE[,NAME=VALUE]: constexpr ints to set")
    ap.add_argument("root", nargs="?", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import torch

    if not torch.cuda.is_available():
        print("time_torch_conv_quant: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke

    cases = [tuple(int(x) for x in c.split(",")) for c in args.case] or CASES
    variants = [dict(kv.split("=") for kv in v.split(","))
                for v in args.variant] or [{}]
    card = smoke.card_name_and_limit()
    print(json.dumps({"card": card, "root": root,
                      "conv_quant_i8_kernel": production_resources()}),
          flush=True)
    with tempfile.TemporaryDirectory() as work:
        for i, v in enumerate(variants):
            design, so, ptxas = build(root, v, work, str(i))
            for case in cases:
                print(json.dumps({"design": design, "variant": v,
                                  "card": card, "ptxas": ptxas,
                                  **run(so, design, case)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
