"""The probe path: every hardware probe and the crop ablation on the card.

    python -m top_down_renderer_torch.probes \
        [window|mm|ablate|ablate_init|all]
        [--seed 0] [--n 102400] [--device cuda]

builds each probe's inputs from --seed with numpy at the TPU probes'
shapes, runs its kernel and its plain version on the same tensors, checks
them (a failed check raises), and prints one JSON line a probe: what it
replaces, how it was checked, and on the card the kernel's device time
(torch.profiler, 20 launches after 3), the plain version's and the
library call's (CUDA events), the wrapper's (host clock, median of 20
calls each synchronised: it encodes the TMA tensor maps), the route the
kernel took, the bytes and operations of the work, the
bound (the larger of the operations over the card's peak for their type
and the bytes over 3.35 TB/s), the share of it the kernel reached, the
effective rate, and the card's name and power limit.  On the CPU
(--device cpu, the tests) the kernels' plain versions run, the checks
hold them to their definitions, and no time is measured.

  window  K1 (csrc/probe_window.cu): the TPU's DMA probes' windows,
          held bit for bit (a copy beside advanced indexing of the strided
          view); then 102,400 windows of 56 x 640 B on a map of 1,280 x
          10,240 B (13 MB, inside the 50 MB L2) and of 8,192 x 10,240 B (84
          MB), summed, in each geometry, and strided and async at any row
          and byte;
  mm      K2 (csrc/probe_mm.cu): the TPU's matrix-unit probes (row 13's
          48 x 64 x 35,840 with split K, converted and in bf16), then the
          theta search's work shape (A 102,400 x 4,096, B 128 x 4,096) in
          int8, int8 converted to bf16 and bf16, each beside the one
          PyTorch call of it where there is one: torch._int_mm and
          torch.matmul (timed here, never called by the port); a split-K
          product must repeat bit for bit;
  ablate  K3 (csrc/crop_ablate.cu): the tracked crop kernel's variants on
          a 1024^2 6-class map at 102,400 particles, spread, clustered and
          over K buckets, each with its rows in both orders (position, the
          production wrapper's, and key); `full` held bit for bit to the
          production kernel in both, `checked` to `full`.
  ablate_init
          K4 (csrc/crop_ablate_init.cu): the theta search's variants
          (probes/crop_ablate.py's INIT_VARIANTS) at 102,400 particles on a
          1024^2 map, a 3-class and a 6-class spread cloud and the 3-class
          cloud over K buckets, each with its rows in both orders
          (INIT_ORDERS: position, the production wrappers', and the
          particles'); `full` and `checked` held bit for bit to the
          production kernel, argmin and raw rows, with the production
          kernel's time
          and its wrapper split into inputs, M build and launch; every
          variant at one block an SM, as full; beside the bound the bytes
          each re-reads from L2 (l2_bytes) at K1's L2 window rate.
Every record's profile_tries says how many profiles its kernel time took
(kernel_ms).
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch

from top_down_renderer_torch import kernels
from top_down_renderer_torch.filter import crop_score as cs
from top_down_renderer_torch.filter import multiscale as ms
from top_down_renderer_torch.probes import crop_ablate as ca
from top_down_renderer_torch.probes import mm
from top_down_renderer_torch.probes import window as wg
from top_down_renderer_torch.testing import synthetic_setup

N = 102_400
# published H100 SXM peaks (dense)
PEAK_HBM_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
REL_TOL = 1e-4  # float32 sums of nonnegative terms in two orders
RUNS = 20
DR, DC = 56, 640  # a crop at mo 24: rows x bytes (probe_dma_fold.py)
FOLD_COLS = wg.FOLD * DC  # a folded slice's bytes: 5,120
L2_ROWS, HBM_ROWS, MAP_BYTES = 1280, 8192, 10240
THETA_K, THETA_N = 4096, 128  # the theta search's work shape (with N rows)
# K1's window rate from L2 on an H100 (the folded1 windows of the 13 MB
# map, probe window): a reading set beside the bytes a kernel re-reads from
# L2, not a bound
L2_WINDOW_BYTES = 8.2e12
SYMBOLS = {"probe_window_gather": "probe_window",
           "probe_mm": "probe_mm_",  # the product, and a split-K sum
           "crop_ablate": "crop_ablate_kernel",
           "crop_ablate_init": "crop_ablate_init_kernel",
           "crop_score_tracked": "crop_tracked_kernel<",
           "crop_score_init": "crop_init_kernel<"}  # uniform and K-bucket


class ProbeError(RuntimeError):
    """A kernel disagrees with its plain version."""


def check(cond, msg: str) -> None:
    if not cond:
        raise ProbeError(msg)


def card(dev) -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_us(evt) -> float:
    """A profiler event's own device time in microseconds."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def kernel_ms(fn, symbols, runs: int = RUNS, per_call: int = 1,
              tries: int = 3):
    """(ms, profiles taken): the kernel's own device time per launch,
    `runs` calls of fn under torch.profiler after 3 to warm up, the mean
    over the device events whose name holds `symbols` (a name, or a tuple
    of its spellings).  With per_call > 1 a call launches that many
    kernels of those names (a product and its split-K sum), and the time
    is their sum a call.  A profile whose trace holds no such event (the
    profiler's device trace came back empty) is taken again, up to
    `tries` in all; the second number says how many it took, so that a
    retry stays in the records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    symbols = (symbols,) if isinstance(symbols, str) else tuple(symbols)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and any(sym in e.key for sym in symbols)]
        seen = sum(e.count for e in events)
        if seen:
            break
        print(f"[probes] profile {attempt + 1} saw no launch of "
              f"{symbols}", file=sys.stderr, flush=True)
    check(0 < seen <= runs * per_call, f"the profiler saw {seen} launches "
          f"of {symbols} in {runs} calls")
    return sum(device_us(e) for e in events) / seen * per_call / 1e3, \
        attempt + 1


def wrapper_ms(fn, runs: int = RUNS) -> float:
    """Host time of one call of fn and a synchronise, median of `runs`
    after 3 to warm up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def events_ms(fn, runs: int = RUNS) -> float:
    """Device time per call of fn by CUDA events around `runs` calls,
    after 3 to warm up: every kernel the call launches, and the gaps
    between them."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def bound(ops: float, peak: float, moved: float):
    """(ms, what bounds it): the larger of ops over `peak` and the bytes
    moved over the HBM rate."""
    t_ops = ops / peak * 1e3
    t_bytes = moved / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def once(dev, fn):
    """(fn(), its device time in ms by CUDA events), or (fn(), None) on
    the CPU: the plain versions are timed on the call that checks the
    kernel, once."""
    if dev.type != "cuda":
        return fn(), None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def timing(dev, kernel_name, fn, plain_ms, library=None, per_call=1):
    """{kernel_ms, profile_tries, plain_ms, library_ms, wrapper_ms}: the
    kernel under torch.profiler (per_call kernels a call, kernel_ms, and
    the profiles it took), the library call by CUDA events, the wrapper by
    host clock; None on the CPU.  The timing loops' launches are left out
    of kernels.LAUNCHES, which so counts the probe path's own: one launch a
    probe, the one its check holds."""
    if dev.type != "cuda":
        return dict(kernel_ms=None, profile_tries=None, plain_ms=None,
                    library_ms=None, wrapper_ms=None)
    counts = dict(kernels.LAUNCHES)
    ms, tries = kernel_ms(fn, SYMBOLS[kernel_name], per_call=per_call)
    out = dict(kernel_ms=ms, profile_tries=tries, plain_ms=plain_ms,
               library_ms=None if library is None else events_ms(library),
               wrapper_ms=wrapper_ms(fn))
    kernels.LAUNCHES.update(counts)
    return out


def uncounted(fn):
    """fn(), its kernel launches left out of kernels.LAUNCHES: a probe's
    comparison with the production kernel is no launch of the probe
    path."""
    counts = dict(kernels.LAUNCHES)
    out = fn()
    kernels.LAUNCHES.update(counts)
    return out


def _rng(seed: int, salt: int):
    return np.random.default_rng([seed, salt])


def _record(name, kernel, replaces, checked, err=0.0, **extra):
    return dict(probe=name, kernel=kernel, replaces=replaces,
                checked=checked, max_abs_err=float(err), **extra)


def _rated(rec, dev, t, work, ops, peak, moved, unit):
    """rec with the times t, the bound of (ops, moved) and the kernel's
    effective rate: `work` units (bytes or operations) per second, in
    T/s, and its share of the bound."""
    ms_, by = bound(ops, peak, moved)
    rec.update(t, bound_ms=ms_, bound_by=by, ops=ops, bytes=moved)
    if t["kernel_ms"] is not None:
        rec["share_of_bound"] = ms_ / t["kernel_ms"]
        rec[f"effective_{unit}"] = work / t["kernel_ms"] / 1e9
    return rec


# -- K1: the window gather ---------------------------------------------------
def _equal_windows(label, src, origins, rows, cols, geometry, out):
    got = wg.window_gather(src, origins, rows, cols, geometry=geometry,
                           out=out)
    ref = wg.window_gather_plain(src, origins, rows, cols, out)
    check(torch.equal(got, ref), f"{label}: the {geometry} {out} differs "
          "from its plain version")
    return got


def _timed_window(rec, dev, src, o, rows, cols, geometry, out):
    """rec with the time of one gather (checked first against its plain
    version, which is timed on that call), its bound (the covered map
    bytes read once, the origins read and the result written once) and
    its window bytes' rate."""
    def run():
        return wg.window_gather(src, o, rows, cols, geometry=geometry,
                                out=out)

    want, plain_ms = once(dev, lambda: wg.window_gather_plain(
        src, o, rows, cols, out))
    got = run()
    check(torch.equal(got, want), f"{rec['probe']}: the {geometry} {out} "
          "differs from its plain version")
    library = ((lambda: wg._windows(src, o, rows, cols)) if out == "copy"
               else None)
    rec["route"] = geometry
    t = timing(dev, "probe_window_gather", run, plain_ms, library)
    es = src.element_size()
    window_bytes = o.shape[0] * rows * cols * es
    moved = (wg.covered_bytes(src.shape, o, rows, cols, es) + o.numel() * 4
             + got.numel() * got.element_size())
    rec.update(window_bytes=window_bytes,
               bound_windows_ms=window_bytes / PEAK_HBM_BYTES * 1e3)
    return _rated(rec, dev, t, window_bytes, 0.0, PEAK_F32_FLOPS, moved,
                  "tbps")


def window_parity(dev, seed: int):
    """The TPU DMA probes' own windows, each held bit for bit; the last
    call of each probe is timed."""
    recs = []
    rng = _rng(seed, 1)
    starts = torch.tensor([0, 1, 3, 7, 9, 17, 30, 101])
    o = torch.stack([0 * starts, starts, 0 * starts], 1).int().to(dev)
    for dtype in (torch.int8, torch.bfloat16):  # probe_dma_unaligned
        src = torch.as_tensor(rng.integers(-127, 128, (1, 256, 1024)),
                              dtype=torch.float32).to(dev, dtype)
        _equal_windows("unaligned", src, o, 8, 1024, "async", "copy")
        recs.append(_timed_window(_record(
            f"dma_unaligned/{str(dtype)[6:]}", "probe_window_gather",
            "tests/probe_dma_unaligned.py:26",
            "8-row copies at row starts 0-101, strided (timed) and async, "
            "bit for bit"), dev, src, o, 8, 1024, "strided", "copy"))
    src = torch.as_tensor(rng.random((1, 256, 1024)), dtype=torch.float32
                          ).to(dev, torch.bfloat16)  # probe_dma_align
    for ymul, xmul in ((8, 128), (1, 128), (8, 1), (16, 256)):
        o = torch.tensor([[0, 3 * ymul, xmul]], dtype=torch.int32, device=dev)
        for geometry in ("strided", "async"):
            _equal_windows("align", src, o, 64, 512, geometry, "sum")
    recs.append(_timed_window(_record(
        "dma_align", "probe_window_gather", "tests/probe_dma_align.py:13",
        "64 x 512 bf16 sums at y0 = 3 ymul, x0 = xmul over 5 alignments "
        "(the last, 3, 1, timed), strided and async, bit for bit"), dev, src,
        torch.tensor([[0, 3, 1]], dtype=torch.int32, device=dev), 64, 512,
        "strided", "sum"))
    src = (torch.arange(8 * 128 * 1024) % 1000).reshape(8, 128, 1024).to(
        dev, torch.bfloat16)  # probe_dma2 kern1
    recs.append(_timed_window(_record(
        "dma2_stack", "probe_window_gather", "tests/probe_dma2.py:14",
        "a 64 x 512 bf16 sum at stack index 3, bit for bit"), dev, src,
        torch.tensor([[3, 16, 128]], dtype=torch.int32, device=dev), 64,
        512, "strided", "sum"))
    src = torch.as_tensor(rng.integers(-128, 128, (1, 256, 2048)),
                          dtype=torch.int8, device=dev)  # probe_int8 dma
    o = torch.tensor([[0, 24, 128], [0, 96, 128]], dtype=torch.int32,
                     device=dev)
    got = _equal_windows("int8 dma", src, o, DR, DC, "strided", "copy")
    check(torch.equal(got[1], src[0, 96:96 + DR, 128:128 + DC]),
          "int8 dma: the window at y0 = 96 is not the map's slice")
    _equal_windows("int8 dma", src, o, DR, DC, "async", "copy")
    recs.append(_timed_window(_record(
        "int8_dma", "probe_window_gather", "tests/probe_int8.py:42",
        "56 x 640 int8 copies at y0 = 24, 96, strided (timed) and async, "
        "bit for bit"), dev, src, o,
        DR, DC, "strided", "copy"))
    blk = torch.as_tensor(rng.integers(-128, 128, (DR, DC)),
                          dtype=torch.int8, device=dev)  # probe_int8 rotate
    twice = torch.cat([blk, blk], 1)[None].contiguous()
    o = torch.tensor([[0, 0, rx * 8] for rx in (0, 3, 11)],
                     dtype=torch.int32, device=dev)
    got = _equal_windows("rotate", twice, o, DR, DC, "strided", "copy")
    for i, rx in enumerate((0, 3, 11)):
        check(torch.equal(got[i], torch.roll(blk, -rx * 8, 1)),
              f"rotate rx={rx}: not torch.roll")
    _equal_windows("rotate", twice, o, DR, DC, "async", "copy")
    recs.append(_timed_window(_record(
        "int8_rotate", "probe_window_gather", "tests/probe_int8.py:93",
        "a 56 x 640 int8 block rotated by rx*8 B (rx 0, 3, 11) as a window "
        "of the block laid out twice, equal to torch.roll (strided, timed; "
        "async)"), dev, twice, o,
        DR, DC, "strided", "copy"))
    return recs


def _origins(rng, n, rows_max, cols_max, ystep, xstep):
    """n (0, y, x) with y a multiple of ystep in [0, rows_max], x of xstep
    in [0, cols_max]."""
    y = rng.integers(0, rows_max // ystep + 1, n) * ystep
    x = rng.integers(0, cols_max // xstep + 1, n) * xstep
    return torch.as_tensor(np.stack([np.zeros(n, np.int64), y, x], 1),
                           dtype=torch.int32)


def window_cases(seed: int, n: int, map_rows: int):
    """The timed windows on a map of map_rows x 10,240 B: (label,
    geometry, replaces, map layout, origins, rows, cols) with the TPU
    probe's origins (rows at multiples of 8, columns of 128 B), and the
    strided and async gathers at any row and byte (the same origins)."""
    rng = _rng(seed, map_rows)
    h, w = map_rows, MAP_BYTES
    fh, fw = h // wg.FOLD, wg.FOLD * w
    aligned = _origins(rng, n, h - DR, w - DC, 8, 128)
    fold = "tests/probe_dma_fold.py:59"
    folded = (_origins(rng, n, fh - 8, fw - FOLD_COLS, 8, 128),
              _origins(rng, n, fh - 16, fw - FOLD_COLS, 8, 128))
    anywhere = _origins(rng, n, h - DR, w - DC, 1, 1)
    return [
        ("strided", "strided", "tests/probe_dma_fold.py:41", "rows",
         aligned, DR, DC),
        ("folded1", "folded1", fold, "folded", folded[0], 8, FOLD_COLS),
        ("folded2", "folded2", fold, "folded", folded[1], 16, FOLD_COLS),
        ("async", "async", "tests/probe_dma_fold.py:77", "rows", aligned,
         DR, DC),
        ("strided_unaligned", "strided", "tests/probe_dma_unaligned.py:26",
         "rows", anywhere, DR, DC),
        ("async_unaligned", "async", "tests/probe_dma_unaligned.py:26",
         "rows", anywhere, DR, DC),
    ]


def window_rates(dev, seed: int, n: int, map_rows: int, where: str):
    """n windows summed on a map of map_rows x 10,240 B (module
    docstring), each geometry held bit for bit to the plain version and
    timed on the card."""
    rng = _rng(seed, 2 + map_rows)
    src = torch.as_tensor(rng.integers(-100, 100, (1, map_rows, MAP_BYTES),
                                       dtype=np.int8), device=dev)
    layouts = {"rows": src, "folded": wg.fold_rows(src)}
    recs = []
    for label, geometry, replaces, layout, o, rows, cols in window_cases(
            seed, n, map_rows):
        rec = _record(f"window/{where}/{label}", "probe_window_gather",
                      replaces, "int32 sums bit for bit",
                      map_bytes=src.numel())
        recs.append(_timed_window(rec, dev, layouts[layout], o.to(dev), rows,
                                  cols, geometry, "sum"))
    return recs


def run_window(dev, seed: int = 0, n: int = N):
    """The DMA probes' windows, then n windows on the L2 and HBM maps."""
    return (window_parity(dev, seed)
            + window_rates(dev, seed, n, L2_ROWS, "l2")
            + window_rates(dev, seed, n, HBM_ROWS, "hbm"))


# -- K2: the matrix products -------------------------------------------------
def _close(label, got, ref, scale):
    err = float((got.double() - ref.double()).abs().max())
    worst = float(((got.double() - ref.double()).abs() / scale.clamp(
        min=1e-30)).max())
    check(worst <= mm.MM_TOL, f"{label}: |err| / sum|a b| = {worst:.3e}")
    return err


def _timed_mm(rec, dev, run, plain, peak, scale=None, library=None):
    """rec with the time of one product (checked first against its plain
    version, timed on that call: bit for bit, or within MM_TOL of
    scale()), its route and split of K (mm.plan), its bound (2 M N K
    operations at `peak`; A, the B blocks and C moved once) and its rate.
    A product with split K must repeat bit for bit."""
    want, plain_ms = once(dev, plain)
    got = run()
    if scale is None:
        check(torch.equal(got, want), f"{rec['probe']}: differs from the "
              "plain version")
    else:
        rec["max_abs_err"] = _close(rec["probe"], got, want, scale())
    route, split_k = rec.pop("plan")
    rec.update(route=route, split_k=split_k)
    if split_k > 1:
        check(torch.equal(run(), got), f"{rec['probe']}: the split-K "
              "product does not repeat bit for bit")
    t = timing(dev, "probe_mm", run, plain_ms, library,
               per_call=2 if split_k > 1 else 1)
    ops, moved = rec.pop("work")
    return _rated(rec, dev, t, ops, ops, peak, moved, "tops")


def _work(a, b, out_cols):
    """(2 M N K, bytes of a, b and the float32 / int32 result)."""
    m, k = a.shape
    return (2.0 * m * out_cols * k, a.numel() * a.element_size()
            + b.numel() * b.element_size() + m * out_cols * 4)


def _plan(a, b, select=None):
    """mm.plan of the product a b^T as mm_s8 / mm_bf16 launch it."""
    a_type = ("s8" if b.dtype == torch.int8 else
              "s8_to_bf16" if a.dtype == torch.int8 else "bf16")
    return mm.plan(a.shape[0], b.shape[-2], a.shape[1], a_type,
                   select is not None)


def run_mm(dev, seed: int = 0, m: int = N):
    """The matrix-unit probes' own products (row 13's shape also with bf16
    A), then the theta search's work shape with m rows in int8, int8
    converted to bf16, and bf16."""
    rng = _rng(seed, 3)
    recs = []
    a = torch.as_tensor(rng.integers(-127, 128, (128, 1024)), dtype=torch.int8,
                        device=dev)  # probe_int8_mm
    b = torch.as_tensor(rng.integers(-127, 128, (64, 1024)), dtype=torch.int8,
                        device=dev)
    recs.append(_timed_mm(
        _record("int8_mm", "probe_mm", "tests/probe_int8_mm.py:17",
                "int32 bit for bit", work=_work(a, b, 64), plan=_plan(a, b)),
        dev, lambda: mm.mm_s8(a, b), lambda: mm.mm_s8_plain(a, b),
        PEAK_INT8_OPS, library=lambda: torch._int_mm(a, b.T)))

    x = torch.ones((32, 256), dtype=torch.bfloat16, device=dev)  # kern2
    blocks = (torch.arange(4.0)[:, None, None] * torch.ones(128, 256)).to(
        dev, torch.bfloat16)
    sel = torch.tensor([2, 0, 3, 1], dtype=torch.int32, device=dev)
    got = mm.mm_bf16(x, blocks, select=sel)
    want = (sel.repeat_interleave(8).float() * 256)[:, None].expand(32, 128)
    check(torch.equal(got, want), "select: each 8-row block is not its "
          "block's value times 256")
    recs.append(_timed_mm(
        _record("dma2_select", "probe_mm", "tests/probe_dma2.py:46",
                "bit for bit (exact sums of ones times block values)",
                work=_work(x, blocks, 128), plan=_plan(x, blocks, sel)), dev,
        lambda: mm.mm_bf16(x, blocks, select=sel),
        lambda: mm.mm_bf16_plain(x, blocks, sel), PEAK_BF16_FLOPS))

    crop = torch.as_tensor(rng.integers(0, 127, (48, DR * DC)),
                           dtype=torch.int8, device=dev)  # probe_int8
    mb = torch.as_tensor(rng.random((64, DR * DC)) - 0.5,
                         dtype=torch.float32).to(dev, torch.bfloat16)
    crop_bf = crop.to(torch.bfloat16)  # exact
    recs.append(_timed_mm(
        _record("int8_convert_mm", "probe_mm", "tests/probe_int8.py:136",
                f"|err| <= {mm.MM_TOL} sum|a b|; split K bit for bit twice",
                work=_work(crop, mb, 64), plan=_plan(crop, mb)),
        dev, lambda: mm.mm_bf16(crop, mb), lambda: mm.mm_bf16_plain(crop, mb),
        PEAK_BF16_FLOPS, lambda: mm.abs_products(crop, mb),
        lambda: torch.matmul(crop_bf, mb.T)))
    recs.append(_timed_mm(
        _record("int8_convert_mm/bf16", "probe_mm", "tests/probe_int8.py:136",
                f"|err| <= {mm.MM_TOL} sum|a b|; split K bit for bit twice",
                work=_work(crop_bf, mb, 64), plan=_plan(crop_bf, mb)),
        dev, lambda: mm.mm_bf16(crop_bf, mb),
        lambda: mm.mm_bf16_plain(crop_bf, mb), PEAK_BF16_FLOPS,
        lambda: mm.abs_products(crop_bf, mb),
        lambda: torch.matmul(crop_bf, mb.T)))

    # the theta search's work shape, in int8, int8 converted to bf16, bf16
    a8 = torch.as_tensor(rng.integers(-127, 128, (m, THETA_K), dtype=np.int8),
                         device=dev)
    b8 = torch.as_tensor(rng.integers(-127, 128, (THETA_N, THETA_K),
                                      dtype=np.int8), device=dev)
    recs.append(_timed_mm(
        _record("theta_shape/s8", "probe_mm", "tests/probe_int8_mm.py:17",
                "int32 bit for bit", work=_work(a8, b8, THETA_N),
                plan=_plan(a8, b8)), dev,
        lambda: mm.mm_s8(a8, b8), lambda: mm.mm_s8_plain(a8, b8),
        PEAK_INT8_OPS, library=lambda: torch._int_mm(a8, b8.T)))
    # the same integers in bf16 (exact), B scaled to [-1, 1)
    bb = (b8.float() / 128).to(torch.bfloat16)
    recs.append(_timed_mm(
        _record("theta_shape/s8_to_bf16", "probe_mm",
                "tests/probe_int8.py:136", f"|err| <= {mm.MM_TOL} sum|a b|",
                work=_work(a8, bb, THETA_N), plan=_plan(a8, bb)), dev,
        lambda: mm.mm_bf16(a8, bb), lambda: mm.mm_bf16_plain(a8, bb),
        PEAK_BF16_FLOPS, lambda: mm.abs_products(a8, bb)))
    ab = (a8.float() / 128).to(torch.bfloat16)
    del a8, b8
    recs.append(_timed_mm(
        _record("theta_shape/bf16", "probe_mm", "tests/probe_int8.py:136",
                f"|err| <= {mm.MM_TOL} sum|a b|", work=_work(ab, bb, THETA_N),
                plan=_plan(ab, bb)),
        dev, lambda: mm.mm_bf16(ab, bb), lambda: mm.mm_bf16_plain(ab, bb),
        PEAK_BF16_FLOPS, lambda: mm.abs_products(ab, bb),
        lambda: torch.matmul(ab, bb.T)))
    return recs


# -- K3: the crop ablation ---------------------------------------------------
def ablate_cases(dev, seed: int = 0, n: int = N):
    """[(label, production scorer, ablation, plain, args)] at the TPU
    ablation's shapes: 1024^2 map, 6 classes, f = 1; a spread cloud (the
    TPU clone's random thetas), a clustered one (100 px, a 0.15 rad band)
    and the spread cloud over the 10 scale hypotheses' K buckets at res
    0.5."""
    cases = []
    for label, kw in (("spread", {}),
                      ("clustered", dict(cluster=(462, 462, 100),
                                         theta_spread=(0.7, 0.075)))):
        d = synthetic_setup(n, h=1024, w=1024, c=6, seed=seed, **kw)
        p = d["state"]["particles"]
        t = [torch.as_tensor(v, device=dev) for v in (
            d["packed"], d["stencil"], d["scan"], np.ones(6, np.float32),
            p["init_px"], p["theta"])]
        args = (cs.CropMap(t[0]), 6, *t[1:5], t[5], 1.0)
        cases.append((label, cs.score_tracked, ca.crop_ablate,
                      ca.crop_ablate_plain, args))
    hyp = (10.0 ** (np.arange(10) / 10.0)).astype(np.float32)
    plan = ms.plan_buckets(hyp, 25, 0.5, 10.0)
    check(not isinstance(plan, str), f"no bucket plan: {plan}")
    _, slots, mips = plan
    levels = tuple(sorted(set(mips)))
    maps, c, sten, scan, cw, ctr, theta, _ = cases[0][4]
    args = (ms.build_pyramid_maps(maps.packed, levels), c, sten, scan, cw,
            ctr, theta, torch.as_tensor(np.resize(hyp, n), device=dev),
            torch.as_tensor(slots, device=dev),
            tuple(levels.index(m) for m in mips), 0.5)
    cases.append(("buckets", ms.score_tracked_multi, ca.crop_ablate_multi,
                  ca.crop_ablate_multi_plain, args))
    return cases


def _max_rel(got, ref) -> float:
    return max(float(((g.double() - r.double()).abs()
                      / r.double().abs().clamp(min=1e-30)).max())
               for g, r in zip(got, ref))


def _ablate_work(args, multi: bool):
    """(particles, distinct pixels summed over particles, folded runs,
    cells a fold, classes, input bytes) of a case's kernel inputs."""
    if multi:
        pyr, c, sten, scan, cw, ctr, theta, scale, slots, bmi, res = args
        compact, table, fold, cr, key = ms._tracked_inputs(
            pyr, c, sten, scan, cw, ctr, theta, scale, slots, bmi, res, 1.0)
        inputs = (ctr.numel() + theta.numel() + scale.numel()) * 4
    else:
        maps, c, sten, scan, cw, ctr, theta, f = args
        compact, fold, cr, key = cs._tracked_inputs(
            maps, c, sten, scan, cw, ctr, theta, f, 1.0)
        inputs = ctr.numel() * 4 + theta.numel() * 4
    th, r = scan.shape[1:]
    skey, _ = cs.tracked_rows(key)
    npix = fold[1].long()
    pixels = float(npix[skey.long() // th].sum())
    rows = torch.arange(skey.shape[0], device=skey.device)
    fresh = torch.ones_like(skey, dtype=torch.bool)
    fresh[1:] = skey[1:] != skey[:-1]
    runs = float((fresh | (rows % cs.TRACKED_TILE == 0)).sum())
    return (skey.shape[0], pixels, runs, th * r, c,
            compact.numel() * 4 + inputs)


def _ablate_bound(variant, work):
    """The least time of what a variant keeps (crop_ablate.cu): float32
    FMAs (2 FLOPs, C + 1 of them a pixel) or adds (1 FLOP) per distinct
    pixel and particle, or C + 1 adds per cell of each folded run; the
    compact map and the inputs read once, (N, 3) written."""
    n, pixels, runs, cells, c, inputs = work
    ops = {"full": 2 * (c + 1) * pixels, "no_fold": 2 * (c + 1) * pixels,
           "checked": 2 * (c + 1) * pixels,
           "no_gather": 2 * (c + 1) * pixels,
           "gather_only": (c + 1) * pixels,
           "fold_only": (c + 1) * cells * runs}[variant]
    return ops, inputs + n * 12


def run_ablate(dev, seed: int = 0, n: int = N, cases=None):
    """Every variant of each case (ablate_cases, or the caller's) with its
    rows in each order (crop_ablate.ORDERS; records of the "key" order
    named "<probe> key"): `full` bit for bit against the production
    kernel and, as chip_smoke holds that kernel, against its plain
    version, and `checked` bit for bit against `full`; the others against
    their plain versions at REL_TOL."""
    recs = []
    for label, production, ablate, plain, args in (
            cases or ablate_cases(dev, seed, n)):
        multi = production is ms.score_tracked_multi
        work = _ablate_work(args, multi)
        prod = uncounted(lambda: production(*args))
        for order, variant in itertools.product(ca.ORDERS, ca.VARIANTS):
            def run(variant=variant, order=order):
                return ablate(variant, *args, order=order)

            def ref(variant=variant, order=order):
                return plain(variant, *args, order=order)

            want, plain_ms = once(dev, ref)
            got = run()
            rel = _max_rel(got, want)
            name = f"ablate/{label}/{variant}" + (
                "" if order == "position" else " key")
            if variant in ("full", "checked"):  # and so checked is full
                check(all(_same_bits(g, p) for g, p in zip(got, prod)),
                      f"{name}: differs from the production kernel")
                # as chip_smoke holds the tracked kernel: kf equal, cost
                # and norm where kf >= 0.5
                ok = want[2] >= 0.5
                rel = _max_rel([g[ok] for g in got[:2]],
                               [w[ok] for w in want[:2]])
                check(torch.equal(got[2], want[2]) and rel <= REL_TOL,
                      f"{name}: rel {rel:.3e} from the plain version")
            else:
                check(rel <= REL_TOL, f"{name}: rel {rel:.3e} from its plain "
                      "version")
            t = timing(dev, "crop_ablate", run, plain_ms)
            ops, moved = _ablate_bound(variant, work)
            rec = _record(name, "crop_ablate",
                          "tests/exp_crop_ablate.py:39",
                          "bit for bit to the production kernel"
                          if variant in ("full", "checked") else
                          f"rel <= {REL_TOL} to its plain version",
                          float(max((g - w).abs().max() for g, w in
                                    zip(got, want))),
                          particles=work[0], pixels_per_particle=work[1]
                          / work[0], runs=work[2], max_rel_err=rel,
                          order=order)
            if (variant, order) == ("full", "position") and \
                    dev.type == "cuda":
                prod_t = timing(dev, "crop_score_tracked",
                                lambda: production(*args), None)
                rec.update(production_ms=prod_t["kernel_ms"],
                           production_tries=prod_t["profile_tries"])
            recs.append(_rated(rec, dev, t, ops, ops, PEAK_F32_FLOPS, moved,
                               "tflops"))
    return recs


# -- K4: the theta search's ablation ------------------------------------------
def ablate_init_cases(dev, seed: int = 0, n: int = N):
    """[(label, multi, args)] of the theta search's ablation: a spread
    cloud on a 1024^2 3-class map (class weights 0.1, 1.5, 3.0; scale 2,
    f = 1), the TPU clone's 6-class spread cloud (ablate_cases': c, Th, R =
    6, 100, 25) and the 3-class cloud over the 10 scale hypotheses' K
    buckets at res 0.5.  args: score_init_sel's (uniform) or
    score_init_multi_sel's (multi) arguments."""
    cases = []
    for c, cw in ((3, [0.1, 1.5, 3.0]), (6, [1.0] * 6)):
        d = synthetic_setup(n, h=1024, w=1024, c=c, seed=seed)
        t = [torch.as_tensor(v, device=dev) for v in (
            d["packed"], d["stencil"], d["scan"],
            np.asarray(cw, np.float32), d["state"]["particles"]["init_px"])]
        cases.append((f"spread C={c}", False,
                      (cs.CropMap(t[0]), c, *t[1:], 1.0)))
    hyp = (10.0 ** (np.arange(10) / 10.0)).astype(np.float32)
    plan = ms.plan_buckets(hyp, 25, 0.5, 10.0)
    check(not isinstance(plan, str), f"no bucket plan: {plan}")
    _, slots, mips = plan
    levels = tuple(sorted(set(mips)))
    maps, c, sten, scan, cw, ctr, _ = cases[0][2]
    cases.append(("buckets C=3", True, (
        ms.build_pyramid_maps(maps.packed, levels), c, sten, scan, cw, ctr,
        torch.as_tensor(np.resize(hyp, n), device=dev),
        torch.as_tensor(slots, device=dev),
        tuple(levels.index(m) for m in mips), 0.5)))
    return cases


def _init_fns(multi: bool):
    """(production argmin, production raw, ablation, plain, inputs) of the
    uniform or the K-bucket theta search."""
    if multi:
        return (ms.score_init_multi_sel, ms.score_init_multi_raw,
                ca.crop_ablate_multi_init, ca.crop_ablate_multi_init_plain,
                ms.init_inputs)
    return (cs.score_init_sel, cs.score_init_raw, ca.crop_ablate_init,
            ca.crop_ablate_init_plain, cs.init_inputs)


def _init_work(args, multi: bool) -> dict:
    """What the theta search's inputs need: particles per bucket, distinct
    pixels per bucket, M's chunks per bucket and a chunk's bytes, the
    tiles of each bucket, classes, and the bytes of the compact map and
    the per-particle inputs."""
    if multi:
        pyr, c, sten, scan, cw, ctr, scale, slots, bmi, res = args
        bucket, off, _, _ = ms._prepare(pyr, sten, ctr, scale, slots, bmi,
                                        res, 1.0)
        compact = pyr.compact(c)
        counts = torch.bincount(bucket.long(), minlength=len(bmi))
        inputs = (ctr.numel() + scale.numel()) * 4
    else:
        maps, c, sten, scan, cw, ctr, f = args
        off = cs.crop_offsets(sten, f)[None]
        compact = maps.compact(c)
        counts = torch.tensor([ctr.shape[0]])
        inputs = ctr.numel() * 4
    cp = cs.channel_pad(c)
    npix = cs.fold_offsets(off)[1].long().cpu()
    counts = counts.long().cpu()
    return dict(counts=counts, npix=npix,
                nchunk=(npix * cp + cs.K_CHUNK - 1) // cs.K_CHUNK,
                chunk_bytes=2 * cs.K_CHUNK * cs.M_COLS * 2
                + cs.K_CHUNK // cp * 8,
                tiles=(counts + cs.INIT_TILE - 1) // cs.INIT_TILE, c=c,
                cp=cp, inputs=compact.numel() * 4 + inputs)


def _init_bound(variant: str, work: dict, shifts: int = cs.MAX_SEARCH):
    """(ops, peak, bytes moved, bytes re-read from L2) of what a
    theta-search variant keeps (crop_ablate_init.cu).  The bound is the
    function's: the compact map, the per-particle inputs and M's nonzero hi
    and lo entries read once and (N, 3) written, against the three split
    products of those entries (C S cost columns on the class channels, S
    norm columns and the kf column on the known one, chip_smoke.tc_bound's
    count) on bf16 tensor cores for full, no_gather and no_promote, a third
    of it for one_plane and none for gather_only and ring_only.  Beside it,
    the bytes the kernel re-reads, which come from L2: M's records once a
    tile (every variant) and, where it gathers, each particle's window (its
    distinct pixels times CP float32 channels)."""
    counts, npix, c = work["counts"].double(), work["npix"].double(), \
        work["c"]
    nnz = (c * shifts + shifts + 1) * npix
    moved = work["inputs"] + float(nnz.sum()) * 4 + float(counts.sum()) * 12
    dense = 6.0 * float((counts * nnz).sum())
    ops = {"one_plane": dense / 3, "gather_only": 0.0,
           "ring_only": 0.0}.get(variant, dense)
    reread = float((work["tiles"] * work["nchunk"]).sum()) * \
        work["chunk_bytes"]
    if variant not in ("no_gather", "ring_only"):
        reread += float((counts * npix).sum()) * work["cp"] * 4
    return ops, PEAK_BF16_FLOPS, moved, reread


def _close_rows(label, got, got_raw, want, want_raw):
    """A theta-search variant's rows against its plain version's
    (crop_ablate.py's module docstring): kf within REL_TOL everywhere;
    the raw nums and dens within REL_TOL where the plain kf >= 0.5; the
    FLT_MAX pattern of best equal (rows whose plain kf lies within
    REL_TOL of the 0.5 gate left out), finite bests within REL_TOL; and k
    a near-argmin: the plain cost at the kernel's k within REL_TOL of the
    plain minimum.  Returns (largest |err| of best, nums and dens, the
    largest relative error)."""
    best, k, kf = got
    wbest, _, wkf = want
    nums, dens, rkf = got_raw
    wnums, wdens, wrkf = want_raw
    rel = _max_rel([kf, rkf], [wkf, wrkf])
    check(rel <= REL_TOL, f"{label}: kf rel {rel:.3e}")
    ok = wrkf >= 0.5
    if bool(ok.any()):
        r = _max_rel([nums[ok], dens[ok]], [wnums[ok], wdens[ok]])
        check(r <= REL_TOL, f"{label}: raw rows rel {r:.3e}")
        rel = max(rel, r)
    sure = (wkf - 0.5).abs() > REL_TOL * 0.5
    capped = best >= cs.FLT_MAX
    check(torch.equal(capped[sure], (wbest >= cs.FLT_MAX)[sure]),
          f"{label}: FLT_MAX pattern")
    fin = sure & ~capped & torch.isfinite(best)
    if bool(fin.any()):
        r = _max_rel([best[fin]], [wbest[fin]])
        check(r <= REL_TOL, f"{label}: best rel {r:.3e}")
        rel = max(rel, r)
    inf = sure & ~capped & ~torch.isfinite(best)
    check(torch.equal(best[inf], wbest[inf]), f"{label}: non-finite bests")
    s = wnums.shape[1]
    check(bool(((k >= 0) & (k < s)).all()), f"{label}: k out of range")
    c = torch.where(torch.isnan(wnums / wdens) | (wrkf[:, None] < 0.5),
                    cs.FLT_MAX, wnums / wdens)
    at_k = c.gather(1, k[:, None].clamp(0, s - 1))[:, 0]
    low = c.min(1).values
    near = at_k <= low + REL_TOL * low.abs()
    check(bool(near[sure].all()), f"{label}: k is no near-argmin on "
          f"{int((~near[sure]).sum())} rows")
    err = max(float((g.double() - w.double())[ok].abs().max())
              if bool(ok.any()) else 0.0
              for g, w in ((nums, wnums), (dens, wdens)))
    if bool(fin.any()):
        err = max(err, float((best - wbest)[fin].abs().max()))
    return err, rel


def _same_bits(a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _split_wrapper(dev, multi: bool, args) -> dict:
    """The full variant's wrapper time split (host clock, median of RUNS,
    each call synchronised): the operands' checks and inputs
    (init_inputs), the M build (crop_score.init_records) and the launch
    with its rows (crop_ablate.launch_ablate_init) on records built
    beforehand; {} on the CPU."""
    if dev.type != "cuda":
        return {}
    counts = dict(kernels.LAUNCHES)
    inputs_fn = _init_fns(multi)[4]
    inputs = inputs_fn(*args)
    scan, cw, fold, rows, nrot = (inputs[i] for i in (5, 6, 7, 10, 11))
    records = cs.init_records(scan, cw, fold, rows, nrot)
    split = dict(
        inputs_ms=wrapper_ms(lambda: inputs_fn(*args)),
        m_build_ms=wrapper_ms(lambda: cs.init_records(scan, cw, fold, rows,
                                                      nrot)),
        launch_ms=wrapper_ms(lambda: ca.launch_ablate_init(
            "full", inputs, records=records)))
    kernels.LAUNCHES.update(counts)
    return split


# K4's whole grid: every variant in each row order
INIT_GRID = tuple(itertools.product(ca.INIT_ORDERS, ca.INIT_VARIANTS))


def run_ablate_init(dev, seed: int = 0, n: int = N, cases=None,
                    grid=INIT_GRID):
    """Each (order, variant) of `grid` (every theta-search variant in each
    row order, crop_ablate.INIT_ORDERS; records of the "particles" order
    named "<probe> particles") on each case (ablate_init_cases, or the
    caller's [(label, multi, args)]), argmin and raw rows: `full` and
    `checked` bit for bit against the production kernel
    (tdr_crop_score[_multi]_init and its raw rows), every variant against
    its plain version (_close_rows).  The argmin rows are timed; `full` in
    position order also with the production kernel alone and its wrapper
    split (_split_wrapper).  On the card every variant must run one block
    an SM, as full does (blocks_per_sm)."""
    recs = []
    for label, multi, args in cases or ablate_init_cases(dev, seed, n):
        prod, prod_raw, ablate, plain, _ = _init_fns(multi)
        work = _init_work(args, multi)
        want_prod = uncounted(lambda: (prod(*args), prod_raw(*args)))
        plains = {}  # variant: its plain rows, which no order changes
        for order, variant in grid:
            def run(variant=variant, order=order):
                return ablate(variant, *args, order=order)

            if variant not in plains:
                plains[variant] = (*once(dev, lambda: plain(variant, *args)),
                                   plain(variant, *args, raw=True))
            want, plain_ms, want_raw = plains[variant]
            got = run()
            got_raw = ablate(variant, *args, raw=True, order=order)
            name = f"ablate_init/{label}/{variant}" + (
                "" if order == "position" else " particles")
            err, rel = _close_rows(name, got, got_raw, want, want_raw)
            exact = variant in ("full", "checked")
            if exact:
                check(all(_same_bits(g, p) for g, p in zip(
                    (*got, *got_raw), (*want_prod[0], *want_prod[1]))),
                      f"{name}: differs from the production kernel")
            t = timing(dev, "crop_ablate_init", run, plain_ms)
            ops, peak, moved, reread = _init_bound(variant, work)
            rec = _record(
                name, "crop_ablate_init", "tests/exp_crop_ablate.py:39",
                ("bit for bit to the production kernel (argmin and raw "
                 "rows); " if exact else "")
                + f"rel <= {REL_TOL} to its plain version, k a near-argmin",
                err, particles=int(work["counts"].sum()),
                buckets=len(work["counts"]),
                pixels=work["npix"].tolist(), max_rel_err=rel,
                l2_bytes=reread,
                l2_window_rate_ms=reread / L2_WINDOW_BYTES * 1e3,
                order=order)
            if dev.type == "cuda":
                rec["blocks_per_sm"] = ca.blocks_per_sm(variant, work["c"])
                check(rec["blocks_per_sm"] == 1, f"{name}: "
                      f"{rec['blocks_per_sm']} blocks an SM, not full's one")
            if (variant, order) == ("full", "position") and \
                    dev.type == "cuda":
                prod_t = timing(dev, "crop_score_init",
                                lambda: prod(*args), None)
                rec.update(production_ms=prod_t["kernel_ms"],
                           production_tries=prod_t["profile_tries"],
                           **_split_wrapper(dev, multi, args))
            unit = "tflops" if ops else "tbps"
            recs.append(_rated(rec, dev, t, ops or reread, ops, peak, moved,
                               unit))
    return recs


PROBES = {"window": run_window, "mm": run_mm, "ablate": run_ablate,
          "ablate_init": run_ablate_init}


def run(which: str, dev, seed: int = 0, n: int = N):
    """The records of probe `which` (or "all") on dev."""
    names = list(PROBES) if which == "all" else [which]
    recs = []
    for name in names:
        t0 = time.perf_counter()
        got = PROBES[name](dev, seed, n)
        print(f"[probes] {name}: {len(got)} probes checked in "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
        recs += got
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", nargs="?", default="all",
                    choices=[*PROBES, "all"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=N,
                    help="windows, rows of the product, particles")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu: plain versions, no times")
    args = ap.parse_args(argv)
    dev = kernels.default_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    name = card(dev)
    for rec in run(args.probe, dev, args.seed, args.n):
        print(json.dumps(dict(rec, card=name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
