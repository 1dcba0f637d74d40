"""On-card smoke run of the PyTorch/CUDA port (top_down_renderer_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  A. build the CUDA sources in csrc/ (one nvcc each, all started
     together), time it, and count the tensor-core (HGMMA) instructions
     in the theta-search library's SASS with the toolkit's cuobjdump
     (fails without the tool or without the instructions);
  B. the uniform crop kernels against their plain PyTorch versions on
     the same card tensors at the slice's shapes: 102,400 particles, a
     1024^2 map with 6 classes (8 packed channels), Th x R = 100 x 25,
     f = 1.0 and 0.5, edge and far-out centres included; each tracked
     kernel also runs twice on the same inputs and must return the same
     bits (here and wherever a kernel is held against its plain version),
     and the tracked kernels' offset fold (one launch) must equal
     crop_score.fold_offsets (here, in B2 and in D); the theta search's
     raw rows (its raw-row epilogue) against score_init_raw_plain: kf bit
     for bit, nums and dens within rel 1e-4, and select_init_cost of the
     kernel's rows the argmin of the theta-search kernel on >= 99.9 %;
  B2. the K-bucket crop kernels against their plain versions on the
     same map with the 10 init hypotheses 10^{k/10} at res 0.5 (the
     levels the dispatch picks), and per bucket against the uniform
     kernel on that bucket's mip level; the K-bucket raw rows as in B;
     the fill kernel against its plain version;
  C. the known-scale main path through the public entry points: the
     consumer drive (2,048 particles, 30 scans, must converge) and 20
     updates of 102,400 particles on a 1024^2 map from a spread init;
     each update must run the scorer its plan names: a crop kernel
     launch on the crop path, a conv cost field (cuDNN, counted in
     conv_score.CALLS) and no crop launch on the conv path, which the
     dispatch takes once the alive box fits a conv region;
  C2. the unknown-scale main path at fixed_scale -1 on the same world:
     20 updates of 102,400 particles with the robot standing, each of
     which must launch a K-bucket kernel (theta search first) and none
     the exact step; 20 with the robot driving, where every update the
     dispatch plans on the K-bucket path must launch its kernel and the
     exact step may run only where the plan falls to it; then the
     unknown-scale consumer drive (2,048 particles, 30 scans), which
     must find the scale;
  C3. 10 updates of 102,400 particles with TDR_RESAMPLE=pallas: each
     must launch the fill kernel, whose rows must equal the gather
     path's bit for bit on the same weights and shift;
  C4. the conv path: 20 known-scale updates of 102,400 particles on the
     clustered cloud of D (100 px, a 0.15 rad theta band), driving; each
     must take the conv path (one cost field, no crop launch), and a
     second run from the same state and generator seed must end in the
     same state bit for bit;
  D. each kernel's own device time (20 launches under torch.profiler,
     after 3 warm-up calls), and median host-clock times (3 warm-up, 20
     timed, synchronised) of its wrapper, its plain version, the PyTorch
     call that computes the same function where there is one, and one
     whole ParticleFilter.update, with the card's clocks before and after,
     at 102,400 particles on the 1024^2 map: theta search on a spread
     cloud, tracked on a cloud clustered to 100 px, the unknown-scale
     update from the 10 hypotheses (theta search, and tracked once each
     particle has a theta), the host part of its dispatch, the fill on
     C3's last state and on 2^22 random rows, and the offset fold on the
     clustered cell's offsets; on the clustered cloud also the conv cost
     field alone (CUDA events) and the conv update beside the crop
     update; on those same 3-class inputs each crop kernel
     is held against its plain version as in B; the tracked kernel also
     runs on the spread cloud (tiles over all 100 shifts); the lines of
     the crop kernels give the distinct pixels of their stencil (per
     bucket on the K-bucket path), the pixels each particle reads;
     the raw-row kernels on the theta searches' inputs;
  M1. the multi-device filter (ParticleFilter(mesh=...)) on a world-1
     NCCL mesh on the card, 102,400 particles on the 1024^2 map: (a) ten
     unknown-scale updates standing (the K-bucket theta search through
     the raw-row kernel, then tracked), (b) five updates of C4's
     clustered cloud on the row-sharded conv step, (c) one known-scale
     update of a spread cloud, which plans crop and so runs the sharded
     exact step, as the reference's mesh does; each held against the
     single-device filter from the same state with the same draws
     (max_likelihood rtol 1e-4, atol 1e-5), each update's plan and
     launches checked, the dispatch keys equal to the plans; then the
     mesh update against the single-device one by host clock, (a)'s theta
     search and (b)'s conv update;
  M2. the same three on two ranks over gloo on the one card (two
     processes; collectives through host memory), held against M1 at the
     same tolerance (their times are not the card's mesh times);
  E. one JSON line of kernel results with each kernel's bound on the
     work its inputs need (the crop kernels per distinct stencil pixel:
     the theta searches on the nonzero entries of M on bf16 tensor cores,
     the tracked kernels on float32 outside them), each crop kernel's
     bound also on the per-cell basis of earlier runs (2 (C + 1) FLOPs
     per stencil cell, float32, the packed map read once), the largest
     relative error of each theta search against its plain version, the
     card's name and power limit, and the final {"ok": true, "device":
     ...} line.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from drive_consumer_torch import (  # noqa: E402
    SCALE_GT,
    drive,
    drive_unknown_scale,
    make_filter,
)
from spawn_ranks import run_ranks  # noqa: E402
from top_down_renderer_torch import kernels  # noqa: E402
from top_down_renderer_torch.filter import conv_score  # noqa: E402
from top_down_renderer_torch.filter import crop_score as cs  # noqa: E402
from top_down_renderer_torch.filter import filter as filter_mod  # noqa: E402
from top_down_renderer_torch.filter import gmm as gmm_mod  # noqa: E402
from top_down_renderer_torch.filter import multiscale as ms  # noqa: E402
from top_down_renderer_torch.filter import resample as rs  # noqa: E402
from top_down_renderer_torch.filter.scoring import (  # noqa: E402
    rotation_shift,
    shift_mask,
)
from top_down_renderer_torch.parallel import sharding  # noqa: E402
from top_down_renderer_torch.render.semantic import (  # noqa: E402
    render_semantic_polar,
)
from top_down_renderer_torch.testing import synthetic_setup  # noqa: E402
from top_down_renderer_torch.utils.convert import (  # noqa: E402
    filter_state_from_numpy,
)
from util_synthetic import generate_scan_points, make_world  # noqa: E402

CROP_SRC = "top_down_renderer_torch/csrc/crop_score.cu"
INIT_SRC = "top_down_renderer_torch/csrc/crop_score_init.cu"
FILL_SRC = "top_down_renderer_torch/csrc/fill_rows.cu"
# the kernels' names in a profile, at the drive map's 3 classes (the two
# theta searches are one kernel at CP = 4 channels, their raw-row epilogue
# another, the two tracked kernels one at C = 3); a bool template argument
# in either of the demangler's spellings
_ARGMIN = ("crop_init_kernel<4, false>", "crop_init_kernel<4, (bool)0>")
_RAW = ("crop_init_kernel<4, true>", "crop_init_kernel<4, (bool)1>")
SYMBOLS = {
    "crop_fold": ("crop_fold_kernel",),
    "crop_score_tracked": ("crop_tracked_kernel<3>",),
    "crop_score_init": _ARGMIN,
    "crop_score_multi_tracked": ("crop_tracked_kernel<3>",),
    "crop_score_multi_init": _ARGMIN,
    "crop_score_init_raw": _RAW,
    "crop_score_multi_init_raw": _RAW,
    "fill_rows": ("fill_rows_kernel",),
}
# name -> (source, the TPU kernel it replaces)
KERNELS = {
    # the tracked kernels' offset fold, launched by both tracked wrappers
    "crop_fold": (CROP_SRC, "top_down_renderer_tpu/filter/pallas_score.py:693"),
    "crop_score_tracked": (
        CROP_SRC, "top_down_renderer_tpu/filter/pallas_score.py:693"),
    "crop_score_init": (
        INIT_SRC, "top_down_renderer_tpu/filter/pallas_score.py:693"),
    "crop_score_multi_tracked": (
        CROP_SRC, "top_down_renderer_tpu/filter/multiscale.py:444"),
    "crop_score_multi_init": (
        INIT_SRC, "top_down_renderer_tpu/filter/multiscale.py:363"),
    # the raw-row epilogue (sel_init = 0) of the same kernel: the uniform
    # one is on no path of the reference (its parity surface), the
    # K-bucket one is the multi-device init step's
    "crop_score_init_raw": (
        INIT_SRC, "top_down_renderer_tpu/filter/pallas_score.py:693"),
    "crop_score_multi_init_raw": (
        INIT_SRC, "top_down_renderer_tpu/filter/multiscale.py:363"),
    "fill_rows": (FILL_SRC, "top_down_renderer_tpu/filter/resample.py:116"),
}
RAW = ("crop_score_init_raw", "crop_score_multi_init_raw")
INIT = ("crop_score_init", "crop_score_multi_init") + RAW
# published H100 SXM peaks (dense): float32 outside the tensor cores, bf16
# on them, HBM
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
N = 102_400
HW = 1024
C = 6
RES = 0.5  # range m/bin: f = scale 2 * 0.5 = 1.0, mip 1
REL_TOL = 1e-4  # float32 sums of ~15,000 positive terms in two orders
ML_RTOL, ML_ATOL = 1e-4, 1e-5  # max_likelihood, mesh against one device
M_MULTI = 10  # M's unknown-scale updates
M_CONV = 5  # M's conv updates


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def smi(query: str) -> str:
    """nvidia-smi's reading of `query` for card 0."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def card_name_and_limit() -> str:
    return smi("name,power.limit")


def log_clocks(label: str) -> None:
    log(f"[{label}] SM clock, its maximum, power draw, temperature: "
        + smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu"))


def log_tensor_core_sass(name: str) -> None:
    """Count the HGMMA (wgmma) instructions in the SASS of csrc/<name>.cu's
    library, with the toolkit's cuobjdump; a build without them, or a
    toolkit without the tool, fails."""
    tool = os.path.join(os.path.dirname(kernels.find_nvcc()), "cuobjdump")
    check(os.path.isfile(tool), f"no cuobjdump beside nvcc: {name}'s SASS "
          "cannot be read")
    sass = subprocess.run([tool, "-sass", str(kernels.build(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    lines = [ln.strip() for ln in sass.splitlines() if "HGMMA" in ln]
    check(lines, f"no HGMMA instruction in {name}'s SASS")
    log(f"[A] {name}: {len(lines)} HGMMA instructions in its SASS, e.g. "
        f"{lines[0]}")


def max_rel(ref: torch.Tensor, got: torch.Tensor) -> float:
    return float(((got - ref).abs() / ref.abs().clamp(min=1e-9)).max())


def same_bits(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def compare(label, errs, names, tracked, init, need_gated=False) -> None:
    """A tracked and a theta-search kernel against their plain versions:
    tracked / init are (kernel call, plain call) without arguments, names
    their kernels'.  The tracked kernel runs twice and must return the
    same bits.  Folds the largest |err| of each into errs["abs"], and the
    theta search's largest relative error into errs["rel"]."""
    num, den, kf = tracked[0]()
    again = tracked[0]()
    rnum, rden, rkf = tracked[1]()
    torch.cuda.synchronize()
    check(same_bits((num, den, kf), again),
          f"{label}: the tracked kernel does not repeat bit for bit")
    check(torch.equal(kf, rkf), f"{label}: tracked kf differs")
    ok = rkf >= 0.5
    if need_gated:
        check(0 < int(ok.sum()) < ok.numel(),
              f"{label}: no kf-gated particles")
    for a, b, name in ((num, rnum, "cost"), (den, rden, "norm")):
        rel = max_rel(b[ok], a[ok])
        check(rel <= REL_TOL, f"{label}: tracked {name} rel {rel}")
        errs["abs"][names[0]] = max(errs["abs"][names[0]],
                                    float((a - b)[ok].abs().max()))
    cost = torch.where(kf < 0.5, torch.nan, num / den)
    rcost = torch.where(rkf < 0.5, torch.nan, rnum / rden)
    check(torch.equal(cost.isnan(), rcost.isnan()), f"{label}: NaN pattern")

    best, k, kf = init[0]()
    rbest, rk, rkf = init[1]()
    torch.cuda.synchronize()
    check(torch.equal(kf, rkf), f"{label}: init kf differs")
    same_k = float((k == rk).float().mean())
    check(same_k >= 0.999, f"{label}: init argmin agrees on {same_k:.5f}")
    fin = (best < cs.FLT_MAX) & (rbest < cs.FLT_MAX)
    check(torch.equal(best < cs.FLT_MAX, rbest < cs.FLT_MAX),
          f"{label}: init FLT_MAX pattern")
    rel = max_rel(rbest[fin], best[fin])
    check(rel <= REL_TOL, f"{label}: init best rel {rel}")
    errs["rel"][names[1]] = max(errs["rel"][names[1]], rel)
    errs["abs"][names[1]] = max(errs["abs"][names[1]],
                                float((best - rbest)[fin].abs().max()))
    log(f"[{label}] tracked (repeats bit for bit) and init agree (init "
        f"argmin same on "
        f"{same_k:.5f}, init best rel {rel:.3e}, kf-gated "
        f"{int((~ok).sum())})")


def compare_raw(label, errs, name, raw, plain, sel) -> None:
    """A raw-row kernel against its plain version (calls without
    arguments): kf bit for bit, nums and dens within REL_TOL where kf >=
    0.5, and select_init_cost of the kernel's rows the theta-search
    kernel's argmin (`sel`) on >= 99.9 % of the rows.  Folds the largest
    |err| and relative error into errs."""
    nums, dens, kf = raw()
    rnums, rdens, rkf = plain()
    best, k, _ = sel()
    torch.cuda.synchronize()
    check(torch.equal(kf, rkf), f"{label}: raw kf differs")
    ok = rkf >= 0.5
    rel = 0.0
    for a, b, what in ((nums, rnums, "num"), (dens, rdens, "den")):
        r = max_rel(b[ok], a[ok])
        check(r <= REL_TOL, f"{label}: raw {what} rel {r}")
        rel = max(rel, r)
        errs["abs"][name] = max(errs["abs"][name],
                                float((a - b)[ok].abs().max()))
    errs["rel"][name] = max(errs["rel"][name], rel)
    rbest, theta = filter_mod._raw_theta((nums, dens, kf), nums.shape[1])
    rk = torch.round(theta * (nums.shape[1] / (2 * math.pi))).long()
    same_k = float((rk == k).float().mean())
    check(same_k >= 0.999, f"{label}: select_init_cost of the raw rows "
          f"agrees with the argmin kernel on {same_k:.5f}")
    log(f"[{label}] raw rows agree (num/den rel {rel:.3e}, kf bit for bit, "
        f"argmin same as the theta-search kernel on {same_k:.5f})")


def check_fold(label, off) -> None:
    """The fold kernel against fold_offsets on the same offsets: equal."""
    got = cs.fold_pixels(off)
    want = cs.fold_offsets(off)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"{label}: the fold kernel differs from fold_offsets")
    log(f"[{label}] fold kernel equals fold_offsets: distinct pixels "
        f"{got[1].tolist()}")


def crop_pair(args, theta, f):
    """(tracked, init) kernel/plain call pairs of the uniform crop path;
    args[0] is the map's CropMap, as the filter passes it."""
    maps, rest = args[0], args[1:]
    return (
        (lambda: cs.score_tracked(maps, *rest, theta, f),
         lambda: cs.score_tracked_plain(maps.packed, *rest, theta, f)),
        (lambda: cs.score_init_sel(maps, *rest, f),
         lambda: cs.score_init_sel_plain(maps.packed, *rest, f)),
    )


def multi_pair(args, theta, scale, slots, bmi):
    """(tracked, init) kernel/plain call pairs of the K-bucket path."""
    return (
        (lambda: ms.score_tracked_multi(*args, theta, scale, slots, bmi, RES),
         lambda: ms.score_tracked_multi_plain(*args, theta, scale, slots,
                                              bmi, RES)),
        (lambda: ms.score_init_multi_sel(*args, scale, slots, bmi, RES),
         lambda: ms.score_init_multi_sel_plain(*args, scale, slots, bmi,
                                               RES)),
    )


CROP = ("crop_score_tracked", "crop_score_init")
MULTI = ("crop_score_multi_tracked", "crop_score_multi_init")
FOLD = ("crop_fold",)  # launched by both tracked wrappers


def phase_b(dev, errs):
    """Kernel vs plain at the slice's shapes on a 6-class map."""
    d = synthetic_setup(N, h=HW, w=HW, c=C, seed=1)
    d["packed"][:200, :300, C] = 0.0  # unknown block: kf < 0.5 there
    rng = np.random.default_rng(1)
    centers = (rng.random((N, 2)) * HW).astype(np.float32)
    centers[:6] = [[0, 0], [HW - 1, 5], [3, HW - 2], [100, 150],
                   [-400, 10], [HW + 900, HW + 900]]  # edges, far out
    t = {k: torch.as_tensor(d[k], device=dev)
         for k in ("packed", "stencil", "scan")}
    cw = torch.ones(C, device=dev)
    ctr = torch.as_tensor(centers, device=dev)
    theta = torch.as_tensor(d["state"]["particles"]["theta"], device=dev)
    args = (cs.CropMap(t["packed"]), C, t["stencil"], t["scan"], cw, ctr)
    for f in (1.0, 0.5):
        check_fold(f"B f={f}", cs.crop_offsets(t["stencil"], f)[None])
        compare(f"B C={C} f={f}", errs, CROP, *crop_pair(args, theta, f),
                need_gated=True)
        compare_raw(f"B raw C={C} f={f}", errs, RAW[0], *raw_triple(args, f))
    errs["abs"]["crop_fold"] = 0.0
    init_ms = median_ms(lambda: cs.score_init_sel(*args, 1.0))
    log(f"[B] theta-search kernel at C={C}, f=1.0: {init_ms:.4f} ms")
    torch.cuda.synchronize()
    return args, theta


def raw_triple(args, f):
    """(raw kernel, plain, argmin kernel) calls of the uniform theta
    search; args[0] is the map's CropMap."""
    maps, rest = args[0], args[1:]
    return (lambda: cs.score_init_raw(maps, *rest, f),
            lambda: cs.score_init_raw_plain(maps.packed, *rest, f),
            lambda: cs.score_init_sel(maps, *rest, f))


def multi_raw_triple(args, scale, slots, bmi):
    """(raw kernel, plain, argmin kernel) calls of the K-bucket theta
    search."""
    return (lambda: ms.score_init_multi_raw(*args, scale, slots, bmi, RES),
            lambda: ms.score_init_multi_raw_plain(*args, scale, slots, bmi,
                                                  RES),
            lambda: ms.score_init_multi_sel(*args, scale, slots, bmi, RES))


def init_plan():
    """The dispatch's plan for the 10 init hypotheses at res RES:
    (hypotheses, slots, levels, bucket -> level)."""
    hyp = (10.0 ** (np.arange(10) / 10.0)).astype(np.float32)
    plan = ms.plan_buckets(hyp, 25, RES, 10.0)
    check(not isinstance(plan, str), plan)
    _, slots, mips = plan
    levels = tuple(sorted(set(mips)))
    return hyp, slots, levels, tuple(levels.index(m) for m in mips)


def phase_b2(dev, errs, b_args, theta):
    """The K-bucket kernels against their plain versions, and per bucket
    against the uniform kernel on the bucket's level; the fill kernel
    against its plain version."""
    maps, _, sten, scan, cw, ctr = b_args
    hyp, slots, levels, bmi = init_plan()
    pyr = ms.build_pyramid_maps(maps.packed, levels)
    log(f"[B2] slots {np.round(slots, 4).tolist()}, levels {levels}, "
        f"bucket -> level {bmi}, pyramid {pyr.flat.numel() * 4 / 2**20:.1f}"
        " MiB")
    scale = torch.as_tensor(np.tile(hyp, N // 10), device=dev)
    ctr = ctr.clone()
    # windows that cross a level's edge: particles 6-9 score on the
    # coarsest levels, at centres just beyond the map's sides
    ctr[6:10] = torch.tensor([[HW + 40.0, 500.0], [500.0, HW + 90.0],
                              [-60.0, 300.0], [300.0, -50.0]], device=dev)
    slots_t = torch.as_tensor(slots, device=dev)
    mips_t, _ = pyr.bucket_tables(bmi)
    check_fold("B2", ms.bucket_offsets(sten, slots_t, RES, mips_t))
    args = (pyr, C, sten, scan, cw, ctr)
    compare("B2 multi", errs, MULTI,
            *multi_pair(args, theta, scale, slots_t, bmi), need_gated=True)
    compare_raw("B2 multi raw", errs, RAW[1],
                *multi_raw_triple(args, scale, slots_t, bmi))

    tr = ms.score_tracked_multi(*args, theta, scale, slots_t, bmi, RES)
    ini = ms.score_init_multi_sel(*args, scale, slots_t, bmi, RES)
    bucket = ms.assign_buckets(scale, slots_t)
    f_eff = slots_t * torch.tensor(RES, device=dev) / mips_t
    for b in range(len(slots)):
        sel = bucket == b
        if not bool(sel.any()):
            continue
        level = pyr.level_map(bmi[b])
        mres = float(levels[bmi[b]])
        u_args = (level, C, sten, scan, cw, ctr[sel])
        u_tr = cs.score_tracked(cs.CropMap(level), *u_args[1:], theta[sel],
                                f_eff[b], mres)
        u_in = cs.score_init_sel(cs.CropMap(level), *u_args[1:], f_eff[b],
                                 40, mres)
        torch.cuda.synchronize()
        label = f"B2 bucket {b} (mip {levels[bmi[b]]})"
        check(torch.equal(u_tr[2], tr[2][sel]), f"{label}: kf differs")
        ok = u_tr[2] >= 0.5
        for i, name in ((0, "cost"), (1, "norm")):
            rel = max_rel(u_tr[i][ok], tr[i][sel][ok])
            check(rel <= REL_TOL, f"{label}: tracked {name} rel {rel}")
        fin = u_in[0] < cs.FLT_MAX
        check(torch.equal(fin, ini[0][sel] < cs.FLT_MAX),
              f"{label}: FLT_MAX pattern")
        rel = max_rel(u_in[0][fin], ini[0][sel][fin])
        check(rel <= REL_TOL, f"{label}: init best rel {rel}")
        check(float((u_in[1] == ini[1][sel]).float().mean()) >= 0.999,
              f"{label}: init argmin")
    log(f"[B2] every bucket equals the uniform kernel on its level")

    rng = np.random.default_rng(2)
    rows = torch.as_tensor(rng.random((N, 8)).astype(np.float32), device=dev)
    w = rng.exponential(1.0, N).astype(np.float32)
    w[rng.random(N) < 0.5] = 0.0
    w = torch.as_tensor(w / w.sum(), device=dev)
    starts = rs._segment_starts(rows, w, torch.tensor(N, device=dev),
                                torch.tensor(N, device=dev),
                                torch.tensor(0.37, device=dev))
    sparse = torch.zeros(N - 5, dtype=torch.bool, device=dev)
    sparse[[0, 5, N // 5, N * 9 // 10]] = True  # runs across many tiles
    for r0, v0 in (starts, (rows[: N - 5].contiguous(), sparse)):
        got, ref = rs.fill_rows(r0, v0), rs.fill_rows_plain(r0, v0)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), "fill kernel differs from plain")
    errs["abs"]["fill_rows"] = 0.0
    log("[B2] fill kernel equals its plain version bit for bit")


def big_filter(dev, **params):
    """102,400 particles on a 1024^2 class-map world, spread init."""
    world = make_world(HW, HW)
    pf, _ = make_filter(dev, N, seed=0, world=world, **params)
    check(pf.n_max == N, f"n_max {pf.n_max}")
    return pf, world


def scan_at(world, i, dev, move=True):
    """Scan i of a robot driving 1.5 m per scan (or standing still) at
    scale 2 along the drive world's road."""
    gt = np.array([60.0 + 3.0 * i * move, 105.0], np.float32)
    pts = generate_scan_points(world, gt, 0.0, SCALE_GT, 25.0, 8192, seed=i)
    return render_semantic_polar(
        torch.as_tensor(pts, device=dev), np.arange(256), RES,
        2 * math.pi / 100, 3, 100, 25,
    )


def conv_calls() -> int:
    return conv_score.CALLS["cost_field"]


class PlanLog:
    """Records the plan of every known-scale update of every
    ParticleFilter while it is open (a wrapper of _fast_mode)."""

    def __enter__(self):
        self.plans = []
        self._orig = orig = filter_mod.ParticleFilter._fast_mode

        def planned(pf, res):
            self.plans.append(orig(pf, res))
            return self.plans[-1]

        filter_mod.ParticleFilter._fast_mode = planned
        return self.plans

    def __exit__(self, *exc):
        filter_mod.ParticleFilter._fast_mode = self._orig


def check_paths(label, plans, crop, conv) -> None:
    """Each update ran the scorer its plan names: crop launches per
    update `crop`, conv cost fields per update `conv`."""
    check(len(plans) == len(crop) == len(conv),
          f"{label}: {len(plans)} plans for {len(crop)} updates")
    for i, (p, k, c) in enumerate(zip(plans, crop, conv)):
        want = (k == 0 and c >= 1) if p.path == "conv" else (k >= 1 and c == 0)
        check(want, f"{label}: update {i} planned {p.path} ({p.mode}) "
              f"launched {k} crop kernels and {c} cost fields")
    log(f"[{label}] paths per update: "
        + " ".join(f"{p.path}/{p.mode}/r{p.region}/w{p.ww}" for p in plans))


def run_updates(pf, world, dev, steps, names, move=True):
    """`steps` updates (with a propagate before each when the robot
    moves); returns the launches of `names` per update (and a last column
    of the conv cost fields) and the mean likelihood."""
    per = []
    for i in range(steps):
        before = [kernels.LAUNCHES[k] for k in names] + [conv_calls()]
        if move:
            pf.propagate([1.5, 0.0], 0.0)
        pf.update(scan_at(world, i, dev, move), RES)
        now = [kernels.LAUNCHES[k] for k in names] + [conv_calls()]
        per.append([a - b for a, b in zip(now, before)])
    torch.cuda.synchronize()
    ml, cov = pf.pose_stats()
    check(np.all(np.isfinite(ml)) and np.all(np.isfinite(cov)),
          "non-finite pose statistics")
    check(0 < pf.num_particles() <= N, "particle count out of range")
    return np.asarray(per), ml


def phase_c(dev):
    counts = [(0, conv_calls())]

    def on_step(i, pf):
        counts.append((sum(kernels.LAUNCHES[k] for k in CROP), conv_calls()))

    with PlanLog() as plans:
        err, cov_xx, _ = drive(dev, 2048, 30, res=1.0, on_step=on_step,
                               log=lambda *_: None)
    log(f"[C] consumer drive (2048 particles; crop at mip 2, then conv): "
        f"err {err:.3f} px, cov_xx {cov_xx:.3f}")
    check(err < 8.0 and cov_xx < 400.0, "consumer drive did not converge")
    crop, conv = np.diff(np.asarray(counts), axis=0).T
    check_paths("C drive", plans, crop, conv)

    pf, world = big_filter(dev)
    with PlanLog() as plans:
        per, ml = run_updates(pf, world, dev, 20, CROP)
    check_paths("C 102,400", plans, per[:, :-1].sum(1), per[:, -1])
    log(f"[C] 20 updates at {N} particles on {HW}^2: n_active "
        f"{pf.num_particles()}, ml {np.round(ml, 3).tolist()}")
    return pf, world


def multi_run(dev, world, move):
    """20 unknown-scale updates at 102,400 particles from a spread init:
    (the dispatch's plan of each update, the updates that ran the exact
    step, the multi launches (tracked, init) of each update)."""
    pf, _ = make_filter(dev, N, seed=0, world=world, fixed_scale=-1.0)
    exact, plans = [], []
    step_fn, multi_mode = pf._update_fn, pf._multi_mode

    def exact_step(*a, **kw):
        exact.append(len(plans) - 1)
        return step_fn(*a, **kw)

    def planned(res):
        plans.append(multi_mode(res))
        return plans[-1]

    pf._update_fn, pf._multi_mode = exact_step, planned
    try:
        per, ml = run_updates(pf, world, dev, 20, MULTI, move)
    finally:
        pf._update_fn, pf._multi_mode = step_fn, multi_mode
    label = "C2 moving" if move else "C2 standing"
    per = per[:, :-1]  # no conv cost field under an unknown scale
    for i, (plan, (t, n)) in enumerate(zip(plans, per)):
        log(f"[{label}] update {i}: " + (
            "exact gather" if plan is None else
            f"{plan.mode}, K {plan.kp}, mo {plan.mo}, levels {plan.levels}")
            + f"; launches tracked {t}, init {n}")
    check(len(plans) == 20, f"{len(plans)} multi dispatches for 20 updates")
    check(pf.scale() < 0, "the scale froze without a caller")
    log(f"[{label}] 20 unknown-scale updates at {N} particles: n_active "
        f"{pf.num_particles()}, ml {np.round(ml, 3).tolist()}")
    return plans, exact, per


def phase_c2(dev, world):
    """The unknown-scale main path at 102,400 particles, then the
    unknown-scale consumer drive.

    Standing still, the scales stay on the 10 hypotheses: every update
    must launch a K-bucket kernel (theta search first, tracked after) and
    none the exact step.  Driving, the 2 %/scan scale diffusion can spread
    102,400 scales past 12 clusters even at rtol 0.08; the dispatch then
    falls to the exact step, as the reference's does on the same scales
    (tests/test_torch_multiscale.py holds the plans equal).  Every other
    update must launch a K-bucket kernel."""
    # (tracked, init) launches of each mode
    expect = {"init": [0, 1], "tracked": [1, 0], "mixed": [1, 1]}
    plans, exact, per = multi_run(dev, world, move=False)
    check(all(p is not None for p in plans) and not exact,
          f"standing: the exact step ran on updates {exact}")
    check(plans[0].mode == "init"
          and all(p.mode == "tracked" for p in plans[1:]),
          f"standing: modes {[p.mode for p in plans]}")
    check(all(per[i].tolist() == expect[p.mode] for i, p in enumerate(plans)),
          f"standing: launches per update {per.tolist()}")

    plans, exact, per = multi_run(dev, world, move=True)
    fell = [i for i, p in enumerate(plans) if p is None]
    check(exact == fell,
          f"moving: the exact step ran on {exact}, planned on {fell}")
    check(all(per[i].tolist() == expect[p.mode]
              for i, p in enumerate(plans) if p is not None),
          f"moving: launches per update {per.tolist()}")
    log(f"[C2 moving] the exact step ran on updates {fell} (scales past "
        f"the clustering ladder); a K-bucket kernel on the other "
        f"{20 - len(fell)}")

    ml, cov, drv = drive_unknown_scale(dev)
    log(f"[C2] unknown-scale drive (2048 particles, 30 scans): scale "
        f"{ml[3]:.4f}, cov[3,3] {cov[3, 3]:.5f}, frozen at "
        f"{drv.scale():.4f}")
    check(abs(ml[3] - SCALE_GT) / SCALE_GT < 0.1, f"scale {ml[3]}")
    check(cov[3, 3] < 0.1, f"cov[3,3] {cov[3, 3]}")
    if drv.scale() > 0:
        check(abs(drv.scale() - SCALE_GT) / SCALE_GT < 0.1,
              f"frozen scale {drv.scale()}")


def phase_c3(dev, world):
    """10 updates with TDR_RESAMPLE=pallas; every resample is checked
    against the gather on the same weights and shift."""
    pf, _ = make_filter(dev, N, seed=0, world=world)
    resample = filter_mod.systematic_resample

    def checked(p, w, n_new, n_act, shift=None, generator=None):
        if shift is None:
            shift = torch.rand((), generator=generator, device=w.device)
        out = resample(p, w, n_new, n_act, shift=shift)
        ref = resample(p, w, n_new, n_act, shift=shift, via="gather")
        check(torch.equal(rs.pack_fields(out), rs.pack_fields(ref))
              and torch.equal(out.alive, ref.alive),
              "fill rows differ from the gather's")
        return out

    os.environ["TDR_RESAMPLE"] = "pallas"
    filter_mod.systematic_resample = checked
    try:
        per, _ = run_updates(pf, world, dev, 10, ("fill_rows",))
    finally:
        filter_mod.systematic_resample = resample
        del os.environ["TDR_RESAMPLE"]
    check((per[:, 0] >= 1).all(), f"updates without a fill launch: {per}")
    log(f"[C3] 10 updates with the fill: rows equal the gather's")
    return pf


def clustered_state(dev):
    """bench.py's cloud: 102,400 particles in a 100 px square at the map's
    centre, thetas in a 0.15 rad band around 0.7, at step 1 (no GMM
    refit), with the shift mask of its thetas, as an update leaves it."""
    d = synthetic_setup(N, h=HW, w=HW, c=3, cluster=(HW // 2, HW // 2, 100),
                        theta_spread=(0.7, 0.15))
    st = filter_state_from_numpy(d["state"], dev).replace(step=1)
    p = st.particles
    return st.replace(smask=shift_mask(rotation_shift(p.theta, 100), p.alive,
                                       100))


def phase_c4(dev, pf, world):
    """The conv path: 20 driving updates from the clustered cloud, twice
    from the same state and generator seed."""
    start = clustered_state(dev)
    finals = []
    for run in range(2):
        pf.state, pf._all_have_init = start, True
        pf.generator.manual_seed(7)
        with PlanLog() as plans:
            per, ml = run_updates(pf, world, dev, 20, CROP)
        check(all(p.path == "conv" for p in plans),
              f"C4: updates off the conv path: {[p.path for p in plans]}")
        check_paths(f"C4 run {run}", plans, per[:, :-1].sum(1), per[:, -1])
        finals.append(pf.state)
    a, b = (rs.pack_fields(st.particles) for st in finals)
    check(torch.equal(a.view(torch.int32), b.view(torch.int32))
          and torch.equal(finals[0].particles.alive, finals[1].particles.alive)
          and torch.equal(finals[0].particles.weight.view(torch.int32),
                          finals[1].particles.weight.view(torch.int32)),
          "C4: two runs from the same state differ")
    log(f"[C4] 20 conv updates at {N} particles, twice: the same state bit "
        f"for bit; n_active {pf.num_particles()}, ml "
        f"{np.round(ml, 3).tolist()}")


def device_us(evt) -> float:
    """A profiler event's own device time in microseconds."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def kernel_ms(fn, symbols, runs: int = 20) -> float:
    """The kernel's own device time per launch: `runs` calls of fn (its
    wrapper) under torch.profiler, the mean over the device events whose
    name holds one of `symbols` (the profiler may miss a short one)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and any(sym in e.key for sym in symbols)]
    seen = sum(e.count for e in events)
    check(0 < seen <= runs, f"the profiler saw {seen} launches of "
          f"{symbols} in {runs} calls")
    return sum(device_us(e) for e in events) / seen / 1e3


def median_ms(fn, warmup=3, runs=20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops: float, moved: float, peak: float = PEAK_F32_FLOPS):
    """(bound ms, what bounds it): the larger of the operations over
    `peak` (default: float32 outside the tensor cores) and the bytes over
    the HBM rate."""
    t_ops = ops / peak * 1e3
    t_bytes = moved / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def crop_bound(maps, c, tr, shifts, inputs):
    """The per-cell basis of earlier runs: each search shift costs C + 1
    FMAs per stencil cell (cost, norm); the packed map and the
    per-particle inputs are read once, (N, 3) written."""
    n = inputs[0].shape[0]
    return bound(2.0 * (c + 1) * tr * shifts * n,
                 nbytes(maps, *inputs) + n * 12)


def pixel_bound(compact, c, npix, counts, inputs):
    """The tracked kernels on the work their inputs need: C + 1 FMAs
    (cost, norm) per distinct stencil pixel of the particle's bucket
    (npix (K,) distinct pixels, counts (K,) particles per bucket), float32
    outside the tensor cores; the compact map and the per-particle inputs
    read once, (N, 3) written."""
    n = int(counts.sum())
    ops = 2.0 * (c + 1) * float((counts.double().cpu()
                                 * npix.double().cpu()).sum())
    return bound(ops, nbytes(compact, *inputs) + n * 12)


def tc_bound(compact, c, shifts, npix, counts, inputs, out_floats=3):
    """The theta search on bf16 tensor cores, counting the products the
    inputs need, not the dense ones the kernel runs: M has C S + S + 1
    nonzero entries per distinct pixel (S cost columns on each class
    channel; S norm columns and the kf column on the known channel), and
    each costs three split products of 2 FLOPs per particle of its bucket
    (npix (K,) distinct pixels, counts (K,) particles per bucket); the
    compact map, M's nonzero hi and lo entries and the per-particle
    inputs read once, (N, out_floats) float32 written: 3 for the argmin,
    2 S + 1 for the raw rows."""
    nnz = (c * shifts + shifts + 1) * npix.double().cpu()
    n = int(counts.sum())
    ops = 6.0 * float((counts.double().cpu() * nnz).sum())
    moved = (nbytes(compact, *inputs) + float(nnz.sum()) * 4
             + n * 4 * out_floats)
    return bound(ops, moved, PEAK_BF16_FLOPS)


def timed(name, kernel, plain, library=None):
    """The kernel's own device time (ms), its wrapper's, its plain
    version's and the library call's (host clock, synchronised)."""
    return dict(ms=kernel_ms(kernel, SYMBOLS[name]),
                wrapper_ms=median_ms(kernel), plain_ms=median_ms(plain),
                library_ms=None if library is None else median_ms(library))


def phase_d(dev, pf, world, errs):
    """Times of the known-scale cells, and kernel vs plain on the cells'
    own inputs (the 3-class drive map)."""
    scan = scan_at(world, 0, dev)
    cw = torch.tensor([0.1, 1.5, 3.0], device=dev)
    cmap = pf._get_map(1)
    maps = cmap.packed
    sten = pf._device_consts()[1]  # the filter's own: its fold is kept
    tr = sten.shape[0] * sten.shape[1]
    f = SCALE_GT * RES  # a host number, as the filter passes it
    one = torch.tensor([N])  # every particle in the one bucket
    out = {}

    # timed updates start at step 1: the GMM refit (every 10th update)
    # is timed on its own below
    pf.initialize_particles()  # spread cloud, no theta prior
    spread = pf.state.replace(step=1)
    ctr = spread.particles.pose_px()
    args = (cmap, 3, sten, scan, cw, ctr)

    def init_update():
        pf.state = spread
        pf._all_have_init = False
        pf.update(scan, RES)

    pair = crop_pair(args, spread.particles.theta, f)
    npix = cs.fold_offsets(cs.crop_offsets(sten, f)[None])[1]
    out["crop_score_init"] = dict(
        timed("crop_score_init", *pair[1]),
        update_ms=median_ms(init_update),
        bound=tc_bound(cmap.compact(3), 3, 40, npix, one, (ctr,)),
        bound_f32=crop_bound(maps, 3, tr, 40, (ctr,)),
        # the tracked kernel on the spread cloud: its tiles spread over
        # all Th shifts, each folding the weights of its own
        tracked_spread_ms=kernel_ms(pair[0][0],
                                    SYMBOLS["crop_score_tracked"]),
        pixels=int(npix[0]),
    )
    compare("D spread, C=3", errs, CROP, *pair)
    raw = raw_triple(args, f)
    out["crop_score_init_raw"] = dict(
        timed("crop_score_init_raw", *raw[:2]),
        bound=tc_bound(cmap.compact(3), 3, 40, npix, one, (ctr,), 81),
        bound_f32=crop_bound(maps, 3, tr, 40, (ctr,)),
        pixels=int(npix[0]),
    )
    compare_raw("D spread raw, C=3", errs, RAW[0], *raw)

    clustered = clustered_state(dev)
    ctr = clustered.particles.pose_px()
    theta = clustered.particles.theta
    args = (cmap, 3, sten, scan, cw, ctr)

    def tracked_update():
        """The crop update of the clustered cloud: its conv region
        withheld from the dispatch."""
        pf.state = clustered
        pf._all_have_init = True
        pf._conv_region = lambda mo: None
        try:
            pf.update(scan, RES)
        finally:
            del pf._conv_region

    pair = crop_pair(args, theta, f)
    off = cs.crop_offsets(sten, f)[None]
    check_fold("D", off)
    pix_bytes = nbytes(*cs.fold_pixels(off))
    out["crop_fold"] = dict(
        timed("crop_fold", lambda: cs.fold_pixels(off),
              lambda: cs.fold_offsets(off)),
        bound=bound(0.0, nbytes(off) + pix_bytes),
    )
    out["crop_score_tracked"] = dict(
        timed("crop_score_tracked", *pair[0]),
        update_ms=median_ms(tracked_update),
        bound=pixel_bound(cmap.compact(3), 3, npix, one, (ctr, theta)),
        bound_cells=crop_bound(maps, 3, tr, 1, (ctr, theta)),
        pixels=int(npix[0]),
    )
    compare("D clustered, C=3", errs, CROP, *pair)
    gmm_ms = median_ms(lambda: gmm_mod.compute_gmm(
        clustered.particles, clustered.n_active, clustered.gmm.k))
    log(f"[D] GMM refit (every {pf.gmm_every}th update): {gmm_ms:.4f} ms")
    return out, conv_times(pf, clustered, scan, cw, sten, f)


def events_ms(fn, runs: int = 20) -> float:
    """Device time per call of fn by CUDA events around `runs` calls,
    after 3 warm-up calls: every kernel the call launches, and the gaps
    between them."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(runs):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / runs


def conv_times(pf, clustered, scan, cw, sten, f):
    """The conv path on the clustered cloud: its plan, the cost field
    alone (CUDA events; the block cut and the cuDNN convolution) with its
    bound (float32 FMAs outside the tensor cores, TF32 off; the block and
    the kernel read once, the field written once), the kernel build, and
    the conv update beside the crop update of phase D (host clock)."""
    pf.state, pf._all_have_init = clustered, True
    plan = pf._fast_mode(RES)
    check(plan.path == "conv", f"the clustered cloud plans {plan}")
    cmap = pf._get_conv_map()
    kernel = conv_score.build_conv_kernel(scan, cw, sten, f, plan.mo,
                                          "tracked", window_w=plan.ww,
                                          s0=plan.s0)
    pose = clustered.particles.pose_px()
    origin = torch.round(pose.flip(-1)).to(torch.int64).amin(0) + cmap.pad
    s_out, cp, dr, dc = kernel.shape
    field = conv_score.cost_field(cmap.padded, kernel, origin, plan.mo,
                                  plan.region)
    ops = 2.0 * plan.region**2 * dr * dc * cp * s_out
    moved = (nbytes(kernel, field)
             + (plan.region + dr - 1) * (plan.region + dc - 1) * cp * 4)

    def conv_update():
        pf.state, pf._all_have_init = clustered, True
        pf._snap = None  # the host snapshot of a new state is read afresh
        pf.update(scan, RES)

    calls = conv_calls()
    conv_update()
    check(conv_calls() == calls + 1, "the conv update made no cost field")
    return dict(
        plan=plan,
        field_ms=events_ms(lambda: conv_score.cost_field(
            cmap.padded, kernel, origin, plan.mo, plan.region)),
        build_ms=events_ms(lambda: conv_score.build_conv_kernel(
            scan, cw, sten, f, plan.mo, "tracked", window_w=plan.ww,
            s0=plan.s0)),
        bound=bound(ops, moved),
        flops=ops,
        update_ms=median_ms(conv_update),
    )


def phase_d2(dev, world, errs):
    """Times of the unknown-scale cells, at 102,400 particles from the 10
    scale hypotheses (a fresh spread init): the first update (theta
    search), and the same population with a theta each (tracked); their
    kernels against the plain versions on the same inputs."""
    pf, _ = make_filter(dev, N, seed=0, world=world, fixed_scale=-1.0)
    scan = scan_at(world, 0, dev)
    cw = torch.tensor([0.1, 1.5, 3.0], device=dev)
    sten = torch.as_tensor(pf.map.stencil, device=dev)
    tr = sten.shape[0] * sten.shape[1]
    out = {}
    fresh = pf.state.replace(step=1)  # step 1: no GMM refit
    p = fresh.particles
    with_theta = fresh.replace(particles=p.replace(
        have_init=torch.ones_like(p.have_init)))
    cells = (("crop_score_multi_init", fresh, False),
             ("crop_score_multi_tracked", with_theta, True))
    for name, state, have in cells:
        pf.state, pf._all_have_init = state, have
        plan = pf._multi_mode(RES)
        check(plan is not None, f"{name}: the cell falls to the exact step")
        host_ms = median_ms(lambda: pf._multi_mode(RES))
        pyr = pf._get_pyramid_maps(plan.levels)
        p = state.particles
        slots = torch.as_tensor(plan.slots, device=dev)
        pair = multi_pair(pair_args(pyr, sten, scan, cw, p), p.theta,
                          p.scale, slots, plan.bmi)

        def update():
            pf.state, pf._all_have_init = state, have
            pf.update(scan, RES)

        tracked = name == MULTI[0]
        inputs = (p.pose_px(), p.scale) + ((p.theta,) if tracked else ())
        mips, _ = pyr.bucket_tables(plan.bmi)
        npix = cs.fold_offsets(ms.bucket_offsets(sten, slots, RES, mips))[1]
        counts = torch.bincount(ms.assign_buckets(p.scale, slots).long(),
                                minlength=len(slots))
        cells = crop_bound(pyr.flat, 3, tr, 1 if tracked else 40, inputs)
        out[name] = dict(
            timed(name, *pair[0 if tracked else 1]),
            update_ms=median_ms(update),
            host_ms=host_ms,
            pixels=npix.tolist(),
        )
        if tracked:
            out[name].update(
                bound=pixel_bound(pyr.compact(3), 3, npix, counts, inputs),
                bound_cells=cells)
        else:
            out[name].update(
                bound=tc_bound(pyr.compact(3), 3, 40, npix, counts, inputs),
                bound_f32=cells)
        log(f"[D2] {name}: {plan.mode}, K {plan.kp}, mo {plan.mo}, levels "
            f"{plan.levels}; host part of the dispatch {host_ms:.4f} ms")
        compare(f"D2 {plan.mode}, C=3", errs, MULTI, *pair)
        if not tracked:
            raw = multi_raw_triple(pair_args(pyr, sten, scan, cw, p), p.scale,
                                   slots, plan.bmi)
            out[RAW[1]] = dict(
                timed(RAW[1], *raw[:2]),
                bound=tc_bound(pyr.compact(3), 3, 40, npix, counts, inputs,
                               81),
                bound_f32=cells,
                pixels=npix.tolist(),
            )
            compare_raw("D2 raw, C=3", errs, RAW[1], *raw)
    return out


def pair_args(pyr, sten, scan, cw, p):
    return (pyr, 3, sten, scan, cw, p.pose_px())


def fill_times(rows0, valid0):
    """The fill's times (timed) and bound on rows0, valid0, after a check
    that the kernel equals its plain version and repeats bit for bit."""
    got, again = rs.fill_rows(rows0, valid0), rs.fill_rows(rows0, valid0)
    ref = rs.fill_rows_plain(rows0, valid0)
    torch.cuda.synchronize()
    check(torch.equal(got, ref) and torch.equal(got.view(torch.int32),
                                                again.view(torch.int32)),
          f"the fill at {rows0.shape[0]} rows differs or does not repeat")
    idx = torch.where(valid0, torch.arange(rows0.shape[0],
                                           device=rows0.device), 0)
    return dict(
        timed("fill_rows", lambda: rs.fill_rows(rows0, valid0),
              lambda: rs.fill_rows_plain(rows0, valid0),
              lambda: rows0.index_select(0, torch.cummax(idx, 0).values)),
        bound=bound(0.0, nbytes(rows0, valid0) + rows0.numel() * 4),
    )


def phase_d3(dev, pf):
    """The fill's times on the resample inputs of C3's last state, and on
    2^22 random rows (about 30 % of the slots valid), where the launch no
    longer hides the bytes."""
    p = pf.state.particles
    n_act = pf.state.n_active
    rng = np.random.default_rng(3)
    w = torch.as_tensor(rng.exponential(1.0, N).astype(np.float32),
                        device=dev)
    w = torch.where(p.alive, w, 0.0)
    w = w / w.sum()
    rows0, valid0 = rs._segment_starts(rs.pack_fields(p), w, n_act, n_act,
                                       torch.tensor(0.37, device=dev))
    out = fill_times(rows0, valid0)
    n = 2**22
    big = fill_times(torch.rand((n, 8), device=dev),
                     torch.rand(n, device=dev) < 0.3)
    out.update({f"{k}_2p22": big[k] for k in ("ms", "wrapper_ms", "plain_ms",
                                                "library_ms")})
    out["bound_2p22"] = big["bound"]
    return {"fill_rows": out}


def launch_counts(names):
    return np.asarray([kernels.LAUNCHES[k] for k in names] + [conv_calls()])


def drive_standing(pf, world, dev, steps, names):
    """`steps` updates with the robot standing (no motion pending): the
    max_likelihood after each, the launches of `names` (and a last column
    of conv cost fields) per update, and the plans."""
    mls, per = [], []
    with PlanLog() as plans:
        for i in range(steps):
            before = launch_counts(names)
            pf.update(scan_at(world, i, dev, move=False), RES)
            per.append(launch_counts(names) - before)
            mls.append(pf.max_likelihood())
    return np.stack(mls), np.stack(per), plans


M_NAMES = ("crop_score_multi_init_raw", "crop_score_multi_tracked",
           "crop_score_multi_init", "crop_score_init", "crop_score_tracked")


def mesh_drives(dev, world, mesh):
    """M's three drives on filters over `mesh` (None: one device), at
    102,400 particles on the drive world: (a) M_MULTI unknown-scale
    updates from the 10 hypotheses; (b) M_CONV updates of the clustered
    cloud, generator seeded 7; (c) one update of a fresh known-scale
    spread cloud, on one device forced to the exact step.  No motion is
    pending anywhere, so both run the same draws.  Returns per drive the
    max_likelihoods, plans, dispatch keys and launches per update (of
    M_NAMES, then conv cost fields), and the filters with their start
    states under "pf"."""
    out, pfs = {}, {}
    pf, _ = make_filter(dev, N, seed=0, world=world, fixed_scale=-1.0,
                        mesh=mesh)
    pfs["multi"] = (pf, pf.state)
    ml, per, plans = drive_standing(pf, world, dev, M_MULTI, M_NAMES)
    out["multi"] = dict(
        ml=ml, launches=per, keys=sorted(pf._sharded_fns, key=repr),
        plans=[None if p is None else (p.mode, p.kp, p.bmi, p.mo)
               for p in plans])

    pf, _ = make_filter(dev, N, seed=0, world=world, mesh=mesh)
    start = clustered_state(dev)
    pf.state = start if mesh is None else sharding.shard_filter_state(
        start, mesh)
    pf._all_have_init = True
    pf.generator.manual_seed(7)
    pfs["conv"] = (pf, pf.state)
    ml, per, plans = drive_standing(pf, world, dev, M_CONV, M_NAMES)
    out["conv"] = dict(
        ml=ml, launches=per, keys=sorted(pf._sharded_fns, key=repr),
        plans=[(p.mode, p.mo, p.region, p.ww, p.path) for p in plans])

    pf, _ = make_filter(dev, N, seed=0, world=world, mesh=mesh)
    exact, step_fn = [], pf._update_fn

    def exact_step(*a, **kw):
        exact.append(1)
        return step_fn(*a, **kw)

    pf._update_fn = exact_step
    if mesh is None:
        pf._fast_mode = lambda res: None
    ml, per, plans = drive_standing(pf, world, dev, 1, M_NAMES)
    out["exact"] = dict(
        ml=ml, launches=per, keys=sorted(pf._sharded_fns, key=repr),
        exact=len(exact),
        plans=[None if p is None else (p.mode, p.mo, p.path) for p in plans])
    out["pf"] = pfs
    return out


def check_mesh_plans(label, got, n_ranks) -> None:
    """The mesh's plans, keys and launches per update as the reference's
    _update_sharded would dispatch them."""
    a = got["multi"]
    check([p[0] for p in a["plans"]] == ["init"] + ["tracked"] * (M_MULTI - 1),
          f"{label} (a): plans {a['plans']}")
    check(a["keys"] == sorted({("multi",) + p for p in a["plans"]}, key=repr),
          f"{label} (a): keys {a['keys']} for plans {a['plans']}")
    raw, tracked = a["launches"][:, 0], a["launches"][:, 1]
    check(raw[0] == 1 and not raw[1:].any() and tracked[0] == 0
          and (tracked[1:] == 1).all() and not a["launches"][:, 2:].any(),
          f"{label} (a): launches per update {a['launches'].tolist()}")
    b = got["conv"]
    keys = set()
    for mode, mo, region, ww, path in b["plans"]:
        check(path == "conv", f"{label} (b): plans {b['plans']}")
        s_out = 2 * ww + 1 if mode == "tracked" else 81
        keys.add((mode, mo, region, ww, conv_score.s2d_gate(mo, s_out), 0))
    check(b["keys"] == sorted(keys, key=repr),
          f"{label} (b): keys {b['keys']} for plans {b['plans']}")
    check(not b["launches"][:, :-1].any() and (b["launches"][:, -1] == 1).all(),
          f"{label} (b): launches per update {b['launches'].tolist()}")
    c = got["exact"]
    check(c["plans"][0][2] == "crop" and c["keys"] == [] and c["exact"] == 1
          and not c["launches"].any(),
          f"{label} (c): plan {c['plans']}, keys {c['keys']}, exact steps "
          f"{c['exact']}, launches {c['launches'].tolist()}")
    log(f"[{label}] {n_ranks} rank(s): (a) {[p[0] for p in a['plans']]}, K "
        f"{a['plans'][0][1]}, mo {a['plans'][0][3]}; (b) "
        f"{b['plans'][0]}; (c) {c['plans'][0]} -> the sharded exact step")


def check_close(label, got, ref) -> None:
    for drive in ("multi", "conv", "exact"):
        a, b = got[drive]["ml"], ref[drive]["ml"]
        ok = np.allclose(a, b, rtol=ML_RTOL, atol=ML_ATOL)
        check(ok, f"{label} ({drive}): max_likelihood {a.tolist()} against "
              f"{b.tolist()}")
        log(f"[{label}] {drive}: max_likelihood within rtol {ML_RTOL}, atol "
            f"{ML_ATOL} over {len(a)} update(s), largest |diff| "
            f"{float(np.abs(a - b).max()):.3e}")


def mesh_update_times(world, dev, mesh_pfs, single_pfs):
    """Host-clock median of the world-1 mesh update against the
    single-device one, from the same state: (a)'s theta search (its start
    at step 1, no GMM refit) and (b)'s conv update."""
    scan = scan_at(world, 0, dev, move=False)
    out = {}
    for drive, have in (("multi", False), ("conv", True)):
        for which, pfs in (("mesh", mesh_pfs), ("single", single_pfs)):
            pf, start = pfs[drive]
            start = start.replace(step=1)

            def update(pf=pf, start=start, have=have):
                pf.state, pf._all_have_init = start, have
                pf._snap = None  # the snapshot of a new state is read afresh
                pf.update(scan, RES)

            out[f"{drive}_{which}_ms"] = median_ms(update)
    return out


def m2_rank(rank, world_size):
    """One of M2's two ranks: the three drives on a gloo mesh over the one
    card (spawn_ranks.run_ranks' target)."""
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    torch.ones(1, device=dev)  # the card is this rank's current device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = sharding.make_mesh(world_size, device_type="cuda")
    t0 = time.perf_counter()
    out = mesh_drives(dev, make_world(HW, HW), mesh)
    del out["pf"]
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_m(dev, world, read_launches):
    """M1 on a world-1 NCCL mesh in this process, then M2 on two ranks
    over gloo; returns the mesh update times."""
    store = tempfile.mkdtemp(dir=kernels.BUILD_DIR)
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(store, "m1"), 1), rank=0, world_size=1, device_id=dev)
    try:
        mesh = sharding.make_mesh(1)
        kernels.reset_launch_counts()
        calls = conv_calls()
        m1 = mesh_drives(dev, world, mesh)
        check(conv_calls() - calls == M_CONV,
              "M1: not one cost field per conv update")
        read_launches("M1", ("crop_score_multi_init_raw",
                             "crop_score_multi_tracked", "crop_fold"))
        check_mesh_plans("M1", m1, 1)
        single = mesh_drives(dev, world, None)
        kernels.reset_launch_counts()
        check_close("M1 vs one device", m1, single)
        times = mesh_update_times(world, dev, m1["pf"], single["pf"])
        del m1["pf"], single["pf"]
        t0 = time.perf_counter()
        m2 = run_ranks(m2_rank, 2, os.path.join(store, "m2"),
                       timeout=300.0)
        log(f"[M2] two ranks over gloo on the card: {time.perf_counter() - t0:.1f}"
            f" s (their drives {m2[0]['seconds']:.1f} s)")
        for r, got in enumerate(m2):
            check_mesh_plans(f"M2 rank {r}", got, 2)
            check_close(f"M2 rank {r} vs M1", got, m1)
        for drive in ("multi", "conv", "exact"):
            check(m2[0][drive]["plans"] == m2[1][drive]["plans"],
                  f"M2 ({drive}): the ranks planned differently")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 plain matmuls
    torch.backends.cudnn.allow_tf32 = False
    name_limit = card_name_and_limit()
    log(f"[0] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; {name_limit}")

    t0 = time.perf_counter()
    ready = kernels.build_all()
    log(f"[A] built {', '.join(f'{k}.cu in {v:.2f} s' for k, v in ready.items())}"
        f" (wall {time.perf_counter() - t0:.2f} s, in parallel)")
    log_tensor_core_sass("crop_score_init")

    errs = {"abs": dict.fromkeys(KERNELS, 0.0), "rel": dict.fromkeys(INIT, 0.0)}
    b_args, b_theta = phase_b(dev, errs)
    phase_b2(dev, errs, b_args, b_theta)
    del b_args, b_theta

    # each path runs with the counts set to 0 just before it and read
    # just after: its own kernels (`names`) must have launched.  Every
    # kernel's count is read after every path and summed over the paths,
    # so that each kernel's `launches` below is a sum of counts read (the
    # uniform raw-row kernel is on no path: its reads are all 0)
    launches = {}

    def read_launches(label, names):
        got = {k: kernels.LAUNCHES[k] for k in KERNELS}
        log(f"[{label}] launches on its path: {got}")
        check(all(got[k] > 0 for k in names), got)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        kernels.reset_launch_counts()

    kernels.reset_launch_counts()
    pf, world = phase_c(dev)
    read_launches("C", CROP + FOLD)
    phase_c2(dev, world)
    read_launches("C2", MULTI + FOLD)
    pf_fill = phase_c3(dev, world)
    read_launches("C3", ("fill_rows",))

    kernels.reset_launch_counts()
    calls = conv_calls()
    phase_c4(dev, pf, world)
    check(conv_calls() - calls == 40, "C4: not one cost field per update")
    check(not any(kernels.LAUNCHES[k] for k in CROP),
          f"C4: crop launches {kernels.LAUNCHES}")
    log(f"[C4] conv cost fields on its path: {conv_calls() - calls}")
    read_launches("C4", ())

    log_clocks("D start")
    times, conv = phase_d(dev, pf, world, errs)
    times.update(phase_d2(dev, world, errs))
    times.update(phase_d3(dev, pf_fill))
    log_clocks("D end")
    mesh_times = phase_m(dev, world, read_launches)
    log(f"[D] world-1 mesh update against the single-device update (host "
        f"clock, median of 20; {N} particles, {HW}^2 map): K-bucket theta "
        f"search {mesh_times['multi_mesh_ms']:.4f} against "
        f"{mesh_times['multi_single_ms']:.4f} ms, conv "
        f"{mesh_times['conv_mesh_ms']:.4f} against "
        f"{mesh_times['conv_single_ms']:.4f} ms on {name_limit}")
    for name, t in times.items():
        extra = "".join(f", {k} {t[k]:.4f} ms"
                        for k in ("update_ms", "host_ms") if k in t)
        if "pixels" in t:
            extra += f", distinct pixels {t['pixels']}"
        if "bound_f32" in t:
            extra += (f", bound on float32 outside the tensor cores "
                      f"{t['bound_f32'][0]:.4f} ms, largest rel err vs "
                      f"plain {errs['rel'][name]:.3e}")
        if "bound_cells" in t:
            extra += (f", bound per stencil cell (the earlier basis) "
                      f"{t['bound_cells'][0]:.4f} ms")
        if "tracked_spread_ms" in t:
            extra += (f", the tracked kernel on the spread cloud "
                      f"{t['tracked_spread_ms']:.4f} ms")
        if "ms_2p22" in t:
            extra += (f"; at 2^22 rows: kernel {t['ms_2p22']:.4f} ms (with "
                      f"its wrapper {t['wrapper_ms_2p22']:.4f} ms), plain "
                      f"{t['plain_ms_2p22']:.4f} ms, bound "
                      f"{t['bound_2p22'][0]:.4f} ms, cummax + index_select "
                      f"{t['library_ms_2p22']:.4f} ms")
        if t["library_ms"] is not None:
            extra += f", library_ms {t['library_ms']:.4f} ms"
        log(f"[D] {name}: kernel {t['ms']:.4f} ms (with its wrapper "
            f"{t['wrapper_ms']:.4f} ms), plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms "
            f"({t['bound'][1]}){extra} ({N} particles, {HW}^2 map) on "
            f"{name_limit}")
    p = conv["plan"]
    log(f"[D] conv path on the clustered cloud (region {p.region}, mo "
        f"{p.mo}, window {p.ww} at {p.s0}): cost field {conv['field_ms']:.4f}"
        f" ms (CUDA events; {conv['flops']:.3e} FLOPs, bound "
        f"{conv['bound'][0]:.4f} ms, {conv['bound'][1]}), kernel build "
        f"{conv['build_ms']:.4f} ms, conv update {conv['update_ms']:.4f} ms "
        f"against the crop update {times['crop_score_tracked']['update_ms']:.4f}"
        f" ms ({N} particles, {HW}^2 map) on {name_limit}")

    result = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": KERNELS[name][0],
            "replaces": KERNELS[name][1],
            "launches": launches[name],
            "max_abs_err": errs["abs"][name],
            "ms": times[name]["ms"],
            "plain_ms": times[name]["plain_ms"],
            "bound_ms": times[name]["bound"][0],
            "bound_by": times[name]["bound"][1],
            "library_ms": times[name]["library_ms"],
            **({"bound_f32_ms": times[name]["bound_f32"][0],
                "max_rel_err": errs["rel"][name]} if name in INIT else {}),
            **({"bound_cells_ms": times[name]["bound_cells"][0]}
               if "bound_cells" in times[name] else {}),
            **({k: times[name][k] for k in ("ms_2p22", "plain_ms_2p22",
                                            "library_ms_2p22")}
               | {"bound_ms_2p22": times[name]["bound_2p22"][0]}
               if "ms_2p22" in times[name] else {}),
        }
        for name in KERNELS
    ]}
    print(json.dumps(result))
    print(name_limit)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
