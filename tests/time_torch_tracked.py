"""Device time of a crop kernel on the card: the tracked kernel
(csrc/crop_score.cu, crop_tracked_kernel), the theta search
(csrc/crop_score_init.cu, crop_init_kernel), uniform and K-bucket, or
the offset fold both read (csrc/crop_score.cu, crop_fold_kernel).

Times the kernel of the checkout at ROOT:

  tracked  the clustered cell: 102,400 particles in a 100 px square of a
           1024^2 3-class map, thetas in a 0.15 rad band; the K-bucket
           cell: the spread cloud below over the 10 scale hypotheses' K
           buckets at res 0.5, with a theta each; the same clustered cloud
           on a 6-class map (C = 6, 8 channels a pixel: the city's class
           count); and the spread cloud over the 3-class map at scale 1,
           with a theta each;
  init     a spread cloud of 102,400 particles over the 1024^2 3-class
           map, the same cloud over the 10 scale hypotheses' K buckets
           at res 0.5, a cloud clustered to 100 px (as the tracked
           cell's) and the spread cloud on a 6-class map (C = 6, 8
           channels a pixel);
  fold     the offset tables of those two: the stencil's at f = 1 (K =
           1, Th*R = 2,500) and the K = 12 buckets'; beside them the
           fold's floor, a one-element fill under the same profiler;

each at f = 1 (1,577 distinct stencil pixels), class weights (0.1, 1.5,
3.0): five rounds of 20 launches under torch.profiler after 3 warm-up
calls (chip_smoke.kernel_ms of the checkout at ROOT).  Each round's result
must equal the first call's bit for bit (the fold's four int32 outputs
back to back), and its SHA-256 is printed, so
that two checkouts' results can be compared too.

The tree to time is ROOT (default: this checkout); running it for two
checkouts on one machine, in turns (parent, change, change, parent),
compares them.  --int4 times the tracked or theta-search kernels on the
nibble-packed code map of the same map (TDR_MAP_INT4=1: the CropMap and
the pyramid made with int4=True; crop_tracked_i4_kernel, crop_init_i4_kernel)
beside the float ones.  --lokf times the kernels with the single-plane M
(TDR_M_HILO=0: the CropMap and the pyramid made with m_hilo=False;
crop_tracked_lokf_kernel, crop_init_lokf_kernel), on the float map or,
with --int4, on the codes (checkouts that have the single-plane M).  The
theta searches' cells also give the registers, stack and local bytes a
thread of each instantiation of the kernel timed (cuobjdump
--dump-resource-usage), the float kernel's (no --int4 or --lokf) also
those of its ablation's (K4, crop_ablate_init_kernel).  A
single-plane tracked call makes two launches, a pass over every (bucket,
shift) first (the scales pass, or the weights pass, whichever ROOT has)
and the kernel: each tracked cell then also gives their sum a call
("with_pass_ms").  --slabs N times ROOT's kernels built with N slabs of
the weights table in the single-plane ring (csrc/crop_tracked.cuh's
kSlabs replaced in a copy of the sources, built by nvcc into a temporary
directory; checkouts that have it); --one-block times them with the code
tracked kernel at one block an SM whatever its layout, its window taking
the rest of the SM's shared memory (kTwoBlockSmem set to 0 in the copy).
The code tracked kernel (--int4
without --lokf) of a checkout that stages windows of codes
(crop_score.WINDOW_BUDGET) is also timed at budget 0, every block's
gather from L2, whose result must equal the staged call's bit for bit
(its SHA-256 printed beside it), and each cell gives the share of its
windows, and of their rows, that the plain rule stages
(crop_score.launch_windows).  Each cell also gives its wrapper's host
time (median of 20 synchronised calls, chip_smoke.median_ms).  The float
tracked cells (--kernel tracked without --int4 or --lokf) also give the
share of rows inside their level and of rows scored two a warp
(tests/torch_parity.tracked_pairs, where ROOT has it), and the registers,
stack and local bytes a thread of each instantiation of the tracked
kernel:

    python tests/time_torch_tracked.py [--kernel tracked|init|fold] [--int4] [--lokf] [--slabs N] [--one-block] [ROOT]
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--kernel", choices=("tracked", "init", "fold"),
                default="tracked")
ap.add_argument("--int4", action="store_true",
                help="the code kernels on the nibble-packed map")
ap.add_argument("--lokf", action="store_true",
                help="the kernels with the single-plane M (TDR_M_HILO=0)")
ap.add_argument("--slabs", type=int, choices=(1, 2),
                help="slabs in the single-plane tracked kernel's ring")
ap.add_argument("--one-block", action="store_true",
                help="the code tracked kernel at one block an SM")
ap.add_argument("root", nargs="?", default=os.path.join(
    os.path.dirname(os.path.abspath(__file__)), ".."))
ARGS = ap.parse_args()
ROOT = os.path.abspath(ARGS.root)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
import torch_parity as parity  # noqa: E402
from top_down_renderer_torch.filter import crop_score as cs  # noqa: E402
from top_down_renderer_torch.filter import multiscale as ms  # noqa: E402
from top_down_renderer_torch.maps.polar import polar_stencil  # noqa: E402
from top_down_renderer_torch.testing import synthetic_setup  # noqa: E402


def use_build(source: str, old: str, new: str, tmp: str) -> None:
    """Load ROOT's crop_score library from a build with `old` replaced by
    `new` in csrc/<source>: the sources copied into tmp, the line
    replaced, built by nvcc."""
    from top_down_renderer_torch import kernels

    if old not in (kernels.CSRC / source).read_text():
        raise SystemExit(f"{ROOT}'s {source} has no {old!r}")
    for f in kernels.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, tmp)
    copy = Path(tmp, source)
    copy.write_text(copy.read_text().replace(old, new))
    lib = Path(tmp, "libcrop_score.so")
    subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib),
                    str(Path(tmp, "crop_score.cu"))], check=True)
    build = kernels.build
    kernels.build = lambda name: lib if name == "crop_score" else build(name)


def registers(name: str, kernel: str, spills: bool = False) -> dict:
    """{"kernel<template arguments>": registers a thread} of each
    instantiation of `kernel` in ROOT's library `name`, from cuobjdump
    --dump-resource-usage; with spills, {...: {"REG": n, "STACK": bytes,
    "LOCAL": bytes}} (local memory a thread: spills, where it is not 0)."""
    from top_down_renderer_torch import kernels

    tool = Path(kernels.find_nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "--dump-resource-usage",
                          str(kernels.build(name))], capture_output=True,
                         text=True, check=True).stdout
    # the mangled template arguments: Li4E an int, Lb0E / Lb1E a bool
    mangled = re.compile(rf"\d{kernel}I((?:L[ib]\d+E)+)E")
    found, fn = {}, None
    for line in out.splitlines():
        if "Function " in line:
            fn = mangled.search(line)
        elif fn and "REG:" in line:
            args = re.findall(r"L([ib])(\d+)E", fn.group(1))
            key = ", ".join(v if t == "i" else ("false", "true")[int(v)]
                            for t, v in args)
            use = {k: (int(m.group(1)) if m else None) for k, m in (
                (k, re.search(rf"{k}:(\d+)", line))
                for k in ("REG", "STACK", "LOCAL"))}
            found[f"{kernel}<{key}>"] = use if spills else use["REG"]
            fn = None
    return found


def use_slabs(n: int, tmp: str) -> None:
    """ROOT's kernels with n slabs in the single-plane ring (kSlabs), and
    crop_score.LOKF_SLABS set to match (its shared-memory check)."""
    if not hasattr(cs, "LOKF_SLABS"):
        raise SystemExit(f"{ROOT} has no ring of slabs")
    use_build("crop_tracked.cuh", "constexpr int kSlabs = 1;",
              f"constexpr int kSlabs = {n};", tmp)
    cs.LOKF_SLABS = n


def use_one_block(tmp: str) -> None:
    """ROOT's code tracked kernel at one block an SM, whatever its layout:
    its launch up to kOneBlockSmem (no kTwoBlockSmem), the window's bytes
    those past its tight layout, and crop_score.TRACKED_SMEM_TWO set to
    match (the plain rule's share)."""
    if not hasattr(cs, "TRACKED_SMEM_TWO"):
        raise SystemExit(f"{ROOT} stages no windows of codes")
    use_build("crop_score.cu", "constexpr size_t kTwoBlockSmem = 111 * 1024;",
              "constexpr size_t kTwoBlockSmem = 0;", tmp)
    cs.TRACKED_SMEM_TWO = 0


N = 102_400
ROUNDS = 5
SUFFIX = "_i4" if ARGS.int4 else ""
CW = np.asarray([0.1, 1.5, 3.0], np.float32)
CW6 = np.asarray([0.1, 1.5, 3.0, 0.7, 1.1, 2.0], np.float32)


def crop_map(packed):
    """The CropMap of `packed`: its codes with --int4, the single-plane M
    with --lokf (a parent checkout without the options is called as it
    was)."""
    if ARGS.lokf:
        return cs.CropMap(packed, int4=ARGS.int4, m_hilo=False)
    return cs.CropMap(packed, int4=True) if ARGS.int4 else cs.CropMap(packed)


def symbols(kernel, n, raw=None):
    """The profiler names of the tracked (raw None) or theta-search kernel
    the options pick, in either of the demangler's spellings."""
    if not ARGS.lokf:
        args = f"{n}" if raw is None else f"{n}, {{}}"
        return tuple(f"crop_{kernel}{SUFFIX}_kernel<" + args.format(b) + ">"
                     for b in ("false", "(bool)0"))
    flags = ((ARGS.int4,) if raw is None else (raw, ARGS.int4))
    return tuple(f"crop_{kernel}_lokf_kernel<{n}, " + ", ".join(
        sp[f] for f in flags) + ">" for sp in (
            {True: "true", False: "false"}, {True: "(bool)1", False: "(bool)0"}))


# the pass a single-plane tracked call launches before its kernel, by the
# names it has had, on the map the options pick
PASS_SYMBOLS = tuple(f"crop_lokf_{n}_kernel<3, {flag}>"
                     for n in ("scales", "weights")
                     for flag in (("true", "(bool)1") if ARGS.int4
                                  else ("false", "(bool)0")))


def pyramid(packed, levels):
    """The pyramid of `packed` at `levels` the options pick."""
    if ARGS.lokf:
        return ms.build_pyramid_maps(packed, levels, ARGS.int4, m_hilo=False)
    return (ms.build_pyramid_maps(packed, levels, int4=True) if ARGS.int4
            else ms.build_pyramid_maps(packed, levels))


def hypotheses():
    """The 10 scale hypotheses at res 0.5: (hyp, slots, bucket levels,
    level per bucket)."""
    hyp = (10.0 ** (np.arange(10) / 10.0)).astype(np.float32)
    _, slots, mips = ms.plan_buckets(hyp, 25, 0.5, 10.0)
    levels = tuple(sorted(set(mips)))
    return hyp, slots, levels, tuple(levels.index(m) for m in mips)


def uniform_cell(dev, c, cw, **kw):
    """(maps, score_tracked's arguments after maps) of a 1024^2 c-class
    world at f = 1, its cloud shaped by synthetic_setup's kw."""
    d = synthetic_setup(N, h=1024, w=1024, c=c, **kw)
    p = d["state"]["particles"]
    t = [torch.as_tensor(v, device=dev) for v in (
        d["stencil"], d["scan"], cw, p["init_px"], p["theta"])]
    return crop_map(torch.as_tensor(d["packed"], device=dev)), (c, *t, 1.0)


def pairs(maps, args) -> dict:
    """The share of a uniform float tracked launch's rows inside their
    level and of those scored two a warp (torch_parity.tracked_pairs)."""
    _, fold, ctr, key = cs._tracked_inputs(maps, *args, 1.0)
    th = args[2].shape[1]
    skey, perm, kshift = cs.tracked_order(key, ctr, th, 1024)
    table = torch.tensor([[0, 1024, 1024, 0]], dtype=torch.int32,
                         device=ctr.device)
    inside, paired, _ = parity.tracked_pairs(skey, perm, ctr, kshift, th,
                                             table, fold)
    return {"inside": float(inside.float().mean()),
            "paired": float(paired.float().mean())}


def tracked_cells(dev):
    """{label: (the kernel's wrapper call, its profiler symbols, the
    windows its blocks stage where ROOT's code kernel stages them, else
    None, and the float kernel's pairs share where ROOT has it, else
    None)}."""
    clustered = dict(cluster=(462, 462, 100), theta_spread=(0.7, 0.075))
    maps, args = uniform_cell(dev, 3, CW, **clustered)
    maps6, args6 = uniform_cell(dev, 6, CW6, **clustered)
    maps_s, args_s = uniform_cell(dev, 3, CW)
    t = args[1:-1]  # the clustered cell's arguments between C and f
    spread = synthetic_setup(N, h=1024, w=1024, c=3)
    q = spread["state"]["particles"]
    hyp, slots, levels, bmi = hypotheses()
    packed = torch.as_tensor(spread["packed"], device=dev)
    multi = (pyramid(packed, levels), 3, *[torch.as_tensor(v, device=dev)
                                          for v in (
        spread["stencil"], spread["scan"], CW, q["init_px"], q["theta"],
        np.resize(hyp, N), slots)], bmi, 0.5)
    windows = {"clustered": None, "buckets": None}
    if ARGS.int4 and not ARGS.lokf and hasattr(cs, "launch_windows"):
        _, fold, ctr, key = cs._tracked_inputs(maps, 3, *t, 1.0, 1.0)
        windows["clustered"] = cs.launch_windows(maps, None, 1024, 1024, 3,
                                                 t[1], fold, ctr, key)
        _, table, fold, ctr, key = ms._tracked_inputs(*multi, 1.0)
        windows["buckets"] = cs.launch_windows(multi[0], table, 0, 0, 3,
                                               multi[3], fold, ctr, key)
    share = {"c6": None, "spread": None}
    if not (ARGS.int4 or ARGS.lokf) and hasattr(parity, "tracked_pairs"):
        share = {"clustered": pairs(maps, args), "c6": pairs(maps6, args6),
                 "spread": pairs(maps_s, args_s)}
    cells = {"clustered": (lambda: cs.score_tracked(maps, *args),
                           symbols("tracked", 3), windows["clustered"],
                           share.get("clustered")),
             "buckets": (lambda: ms.score_tracked_multi(*multi),
                         symbols("tracked", 3), windows["buckets"], None)}
    if not (ARGS.int4 or ARGS.lokf):  # the float kernel's own cells
        cells["c6"] = (lambda: cs.score_tracked(maps6, *args6),
                       symbols("tracked", 6), None, share["c6"])
        cells["spread"] = (lambda: cs.score_tracked(maps_s, *args_s),
                           symbols("tracked", 3), None, share["spread"])
    return cells


def init_cells(dev):
    """{label: (the theta search's wrapper call, its profiler symbols)}:
    the spread cell (chip_smoke D), the K-bucket one (D2), a cloud
    clustered to 100 px and the spread cloud on a 6-class map."""
    d = synthetic_setup(N, h=1024, w=1024, c=3)
    t = [torch.as_tensor(v, device=dev) for v in (
        d["packed"], d["stencil"], d["scan"], CW,
        d["state"]["particles"]["init_px"])]
    maps = crop_map(t[0])
    hyp, slots, levels, bmi = hypotheses()
    multi = (pyramid(t[0], levels), 3, *t[1:],
             torch.as_tensor(np.resize(hyp, N), device=dev),
             torch.as_tensor(slots, device=dev), bmi, 0.5)
    clustered = torch.as_tensor(synthetic_setup(
        N, h=1024, w=1024, c=3, cluster=(462, 462, 100))["state"][
            "particles"]["init_px"], device=dev)
    d6 = synthetic_setup(N, h=1024, w=1024, c=6)
    t6 = [torch.as_tensor(v, device=dev) for v in (
        d6["packed"], d6["stencil"], d6["scan"], CW6,
        d6["state"]["particles"]["init_px"])]
    maps6 = crop_map(t6[0])
    uniform = (maps, 3, *t[1:], 1.0)
    cells = {
        "uniform": (uniform, cs.score_init_sel, 4),
        "buckets": (multi, ms.score_init_multi_sel, 4),
        "clustered": ((maps, 3, *t[1:4], clustered, 1.0), cs.score_init_sel,
                      4),
        "c6": ((maps6, 6, *t6[1:], 1.0), cs.score_init_sel, 8),
    }
    return {label: ((lambda fn=fn, args=args: fn(*args)),
                    symbols("init", cp, raw=False))
            for label, (args, fn, cp) in cells.items()}


def fold_cells(dev):
    sten = torch.as_tensor(polar_stencil(100, 25), device=dev)
    hyp = (10.0 ** (np.arange(10) / 10.0)).astype(np.float32)
    _, slots, mips = ms.plan_buckets(hyp, 25, 0.5, 10.0)
    one = cs.crop_offsets(sten, 1.0)[None]
    multi = ms.bucket_offsets(
        sten, torch.as_tensor(slots, device=dev), 0.5,
        torch.as_tensor(mips, dtype=torch.float32, device=dev))
    cell = torch.zeros(1, dtype=torch.int32, device=dev)
    return {"uniform": (lambda: cs.fold_pixels(one), ("crop_fold_kernel",)),
            "buckets": (lambda: cs.fold_pixels(multi), ("crop_fold_kernel",)),
            "floor": (lambda: (cell.fill_(7),), ("FillFunctor",))}


@contextlib.contextmanager
def budget_zero():
    """ROOT's code tracked kernel with no window staged: every block's
    gather from L2."""
    budget = cs.WINDOW_BUDGET
    cs.WINDOW_BUDGET = 0
    try:
        yield
    finally:
        cs.WINDOW_BUDGET = budget


def rows(out):
    if ARGS.kernel == "fold":  # int32 buffers of several shapes
        return torch.cat([o.reshape(-1) for o in out]).cpu()
    return torch.stack([o.float() for o in out]).cpu()


def main() -> int:
    if not torch.cuda.is_available():
        print("time_torch_tracked: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    slab_dir = tempfile.TemporaryDirectory()  # a variant build, if any
    if ARGS.slabs is not None:
        use_slabs(ARGS.slabs, slab_dir.name)
    if ARGS.one_block:
        use_one_block(slab_dir.name)
    cells = {"tracked": tracked_cells, "init": init_cells,
             "fold": fold_cells}[ARGS.kernel](dev)
    if (ARGS.int4 or ARGS.lokf) and ARGS.kernel == "fold":
        raise SystemExit("--int4 and --lokf time the tracked or init kernels")
    result = {"root": ROOT, "kernel": ARGS.kernel, "int4": ARGS.int4,
              "lokf": ARGS.lokf, "slabs": getattr(cs, "LOKF_SLABS", None),
              "one_block": ARGS.one_block,
              "card": smoke.card_name_and_limit()}
    both = ARGS.lokf and ARGS.kernel == "tracked"
    for label, (run, symbols, *extra) in cells.items():
        windows, share = (extra + [None, None])[:2]
        first = rows(run())
        times, with_pass, on_l2 = [], [], []
        for _ in range(ROUNDS):
            # (ms, profiles taken) where ROOT's kernel_ms reports its tries
            ms_ = smoke.kernel_ms(run, symbols)
            times.append(ms_[0] if isinstance(ms_, tuple) else ms_)
            if both:
                ms_ = smoke.kernel_ms(run, symbols + PASS_SYMBOLS,
                                      per_call=2)
                with_pass.append(ms_[0] if isinstance(ms_, tuple) else ms_)
            if windows is not None:
                with budget_zero():
                    on_l2.append(smoke.kernel_ms(run, symbols)[0])
                    if not torch.equal(rows(run()).view(torch.int32),
                                       first.view(torch.int32)):
                        raise RuntimeError(f"the {label} kernel at budget "
                                           "0 differs from its staged call")
            if not torch.equal(rows(run()).view(torch.int32),
                               first.view(torch.int32)):
                raise RuntimeError(f"the {label} kernel does not repeat")
        result[label] = {
            "kernel_ms": times, "median_ms": float(np.median(times)),
            "sha256": hashlib.sha256(first.numpy().tobytes()).hexdigest(),
            "wrapper_ms": smoke.median_ms(run),
        }
        if both:
            result[label].update(with_pass_ms=with_pass,
                                 with_pass_median_ms=float(
                                     np.median(with_pass)))
        if windows is not None:
            result[label].update(
                staged=cs.staged_share(windows),
                windows=int(windows["staged"].numel()),
                budget0_ms=on_l2, budget0_median_ms=float(np.median(on_l2)))
        if share is not None:
            result[label].update(rows=share)
    if ARGS.kernel == "tracked" and not (ARGS.int4 or ARGS.lokf):
        result["registers"] = registers("crop_score", "crop_tracked_kernel",
                                        spills=True)
    if ARGS.kernel == "init":
        result["registers"] = registers(
            "crop_score_init", "crop_init_lokf_kernel" if ARGS.lokf
            else f"crop_init{SUFFIX}_kernel", spills=True)
        if not (ARGS.int4 or ARGS.lokf):  # K4, the float kernel's body
            result["ablate_registers"] = registers(
                "crop_ablate_init", "crop_ablate_init_kernel", spills=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
