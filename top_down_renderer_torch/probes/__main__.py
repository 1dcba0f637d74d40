"""The probe path: every hardware probe and the crop ablation on the card.

    python -m top_down_renderer_torch.probes [window|mm|ablate|all]
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
          over K buckets; `full` held bit for bit to the production kernel.
"""

from __future__ import annotations

import argparse
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
SYMBOLS = {"probe_window_gather": "probe_window",
           "probe_mm": "probe_mm_",  # the product, and a split-K sum
           "crop_ablate": "crop_ablate_kernel",
           "crop_score_tracked": "crop_tracked_kernel<"}


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
              tries: int = 3) -> float:
    """The kernel's own device time per launch: `runs` calls of fn under
    torch.profiler after 3 to warm up, the mean over the device events
    whose name holds `symbols` (a name, or a tuple of its spellings).
    With per_call > 1 a call launches that many kernels of those names
    (a product and its split-K sum), and the time is their sum a call.  A
    profile whose trace holds no such event (the profiler's device trace
    came back empty) is taken again, up to `tries` in all."""
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
    return sum(device_us(e) for e in events) / seen * per_call / 1e3


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
    """{kernel_ms, plain_ms, library_ms, wrapper_ms}: the kernel under
    torch.profiler (per_call kernels a call, kernel_ms), the library call
    by CUDA events, the wrapper by host clock; None on the CPU.  The
    timing loops' launches are left out of kernels.LAUNCHES, which so
    counts the probe path's own: one launch a probe, the one its check
    holds."""
    if dev.type != "cuda":
        return dict(kernel_ms=None, plain_ms=None, library_ms=None,
                    wrapper_ms=None)
    counts = dict(kernels.LAUNCHES)
    out = dict(kernel_ms=kernel_ms(fn, SYMBOLS[kernel_name],
                                   per_call=per_call),
               plain_ms=plain_ms,
               library_ms=None if library is None else events_ms(library),
               wrapper_ms=wrapper_ms(fn))
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
           "no_gather": 2 * (c + 1) * pixels,
           "gather_only": (c + 1) * pixels,
           "fold_only": (c + 1) * cells * runs}[variant]
    return ops, inputs + n * 12


def run_ablate(dev, seed: int = 0, n: int = N, cases=None):
    """Every variant of each case (ablate_cases, or the caller's):
    `full` bit for bit against the production kernel and, as chip_smoke
    holds that kernel, against its plain version; the others against
    their plain versions at REL_TOL."""
    recs = []
    for label, production, ablate, plain, args in (
            cases or ablate_cases(dev, seed, n)):
        multi = production is ms.score_tracked_multi
        work = _ablate_work(args, multi)
        prod = production(*args)
        for variant in ca.VARIANTS:
            def run(variant=variant):
                return ablate(variant, *args)

            def ref(variant=variant):
                return plain(variant, *args)

            want, plain_ms = once(dev, ref)
            got = run()
            rel = _max_rel(got, want)
            if variant == "full":
                check(all(torch.equal(g.view(torch.int32), p.view(torch.int32))
                          for g, p in zip(got, prod)),
                      f"{label}: full differs from the production kernel")
                # as chip_smoke holds the tracked kernel: kf equal, cost
                # and norm where kf >= 0.5
                ok = want[2] >= 0.5
                rel = _max_rel([g[ok] for g in got[:2]],
                               [w[ok] for w in want[:2]])
                check(torch.equal(got[2], want[2]) and rel <= REL_TOL,
                      f"{label}: full rel {rel:.3e} from the plain version")
            else:
                check(rel <= REL_TOL, f"{label} {variant}: rel {rel:.3e} "
                      "from its plain version")
            t = timing(dev, "crop_ablate", run, plain_ms)
            ops, moved = _ablate_bound(variant, work)
            rec = _record(f"ablate/{label}/{variant}", "crop_ablate",
                          "tests/exp_crop_ablate.py:39",
                          "bit for bit to the production kernel"
                          if variant == "full" else
                          f"rel <= {REL_TOL} to its plain version",
                          float(max((g - w).abs().max() for g, w in
                                    zip(got, want))),
                          particles=work[0], pixels_per_particle=work[1]
                          / work[0], runs=work[2], max_rel_err=rel)
            if variant == "full" and dev.type == "cuda":
                rec["production_ms"] = timing(
                    dev, "crop_score_tracked", lambda: production(*args),
                    None)["kernel_ms"]
            recs.append(_rated(rec, dev, t, ops, ops, PEAK_F32_FLOPS, moved,
                               "tflops"))
    return recs


PROBES = {"window": run_window, "mm": run_mm, "ablate": run_ablate}


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
