"""Design ablations of the probe kernels K1 and K2 on the card.

    python -m top_down_renderer_torch.probes.variants [--n 102400]

builds csrc/probe_window.cu and csrc/probe_mm.cu again with one design
choice changed (a text substitution on the source, into _build/variants/)
and times each variant beside the shipped kernel, by torch.profiler as
`python -m top_down_renderer_torch.probes` does, printing one JSON line a
case with the card's name and power limit:

  window  the async geometry, n windows of 56 x 640 B summed on the 13 MB
          and the 84 MB map, aligned and at any row and byte (the probe's
          own origins), each variant checked bit for bit:
            stage_only     the consumers read nothing: TMA's staging alone
                           (its sums are not checked);
            padded_at_run_time  the barriers placed after the partial
                           sums by an offset rounded up at run time
                           (shipped: a compile-time padded stride; the
                           same addresses at 6 stages);
            align16/128    a window at any byte staged from the 16- or
                           128-byte boundary below it (shipped: 32);
            group4/6       4 or 6 consumer warps a stage, so 6 or 5
                           stages (shipped: 5 warps, 6 stages);
            any_byte_box   boxes started at the window's own byte (TMA
                           takes 16-byte starts): one gather at x = 8 in
                           a child process, which must fail;
  mm      the theta shape's products (A 102,400 x 4,096): the converted
          route with its two warpgroups in lockstep (shipped: ping-pong),
          and each dense route at 101,376 rows (six whole waves of 132
          tiles, nothing split) beside 102,400.

A measurement tool: the package never calls it.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
from unittest import mock

import numpy as np
import torch

from top_down_renderer_torch import kernels
from top_down_renderer_torch.probes import __main__ as P
from top_down_renderer_torch.probes import mm
from top_down_renderer_torch.probes import window as wg

OUT_DIR = kernels.BUILD_DIR / "variants"
_SUM_BODY = ("    if constexpr (OUT == kSum) {\n"
             "      // box b's C 16-byte chunks a row")
_BARRIER = "    // the group's barrier"
WINDOW = {
    "shipped": [],
    "stage_only": [((_SUM_BODY, _BARRIER),
                    "    (void)l;\n    if (OUT == kSum && lane == 0) "
                    "part[grp * kPart + warp % kGroup] = 0;\n")],
    "padded_at_run_time": [(
        "reinterpret_cast<uint64_t*>(part + S * kPart);",
        "reinterpret_cast<uint64_t*>(part + ((S * kGroup + 1) & ~1));")],
    "align16": [("constexpr int kAlign = 32;", "constexpr int kAlign = 16;")],
    "align128": [("constexpr int kAlign = 32;",
                  "constexpr int kAlign = 128;")],
    "group4": [("constexpr int kGroup = 5;", "constexpr int kGroup = 4;")],
    "group6": [("constexpr int kGroup = 5;", "constexpr int kGroup = 6;")],
}
ANY_BYTE_BOX = [("constexpr int kAlign = 32;", "constexpr int kAlign = 1;")]
LOCKSTEP = [('          asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : '
             '"memory");', "          ;"),
            ('        asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg) : '
             '"memory");', "")]


def _substitute(src: str, subs) -> str:
    """src with each (old, new) replaced; old may be a (start, end) pair
    of markers: the text from start up to (not into) end."""
    for old, new in subs:
        if isinstance(old, tuple):
            i, j = src.index(old[0]), src.index(old[1])
            src = src[:i] + new + src[j:]
        else:
            if old not in src:
                raise ValueError(f"no {old!r} in the source")
            src = src.replace(old, new)
    return src


def build_variant(name: str, tag: str, subs) -> ctypes.CDLL:
    """csrc/<name>.cu with `subs`, built as kernels.build builds it."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = OUT_DIR / f"{name}_{tag}.cu"
    src.write_text(_substitute((kernels.CSRC / f"{name}.cu").read_text(),
                               subs))
    lib = OUT_DIR / f"lib{name}_{tag}.so"
    proc = subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-I",
                           str(kernels.CSRC), "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src.name}:\n"
                           f"{proc.stderr[-4000:]}")
    out = ctypes.CDLL(str(lib))
    for fn, argtypes in kernels._SIGNATURES[name].items():
        f = getattr(out, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return out


@contextlib.contextmanager
def using(name: str, lib):
    """kernels.launch calls of csrc/<name>.cu go to lib meanwhile."""
    load = kernels.load
    with mock.patch.object(kernels, "load",
                           lambda n: lib if n == name else load(n)):
        yield


def window_variants(dev, n: int, card: str):
    libs = {tag: build_variant("probe_window", tag, subs)
            for tag, subs in WINDOW.items()}
    for map_rows, where in ((P.L2_ROWS, "l2"), (P.HBM_ROWS, "hbm")):
        rng = P._rng(0, 2 + map_rows)
        src = torch.as_tensor(rng.integers(-100, 100, (1, map_rows,
                                                       P.MAP_BYTES),
                                           dtype=np.int8), device=dev)
        cases = {c[0]: c for c in P.window_cases(0, n, map_rows)}
        for label in ("async", "async_unaligned"):
            _, geometry, _, _, o, rows, cols = cases[label]
            o = o.to(dev)
            want = wg.window_gather_plain(src, o, rows, cols, "sum")
            for tag, lib in libs.items():
                def run():
                    return wg.window_gather(src, o, rows, cols,
                                            geometry=geometry, out="sum")

                with using("probe_window", lib):
                    same = torch.equal(run(), want)
                    P.check(same or tag == "stage_only",
                            f"{tag} {label}: differs from the plain version")
                    ms, tries = P.kernel_ms(
                        run, P.SYMBOLS["probe_window_gather"])
                yield dict(variant=tag, case=f"window/{where}/{label}",
                           kernel_ms=ms, profile_tries=tries,
                           checked=tag != "stage_only",
                           effective_tbps=n * rows * cols / ms / 1e9,
                           card=card)


def any_byte_child() -> int:
    """One async gather at x = 8 through ANY_BYTE_BOX: 0 if it ran."""
    dev = torch.device("cuda")
    lib = build_variant("probe_window", "any_byte_box", ANY_BYTE_BOX)
    src = torch.zeros((1, 64, 1024), dtype=torch.int8, device=dev)
    o = torch.tensor([[0, 0, 8]], dtype=torch.int32, device=dev)
    with using("probe_window", lib):
        wg.window_gather(src, o, 8, 256, geometry="async", out="sum")
    torch.cuda.synchronize()
    return 0


def any_byte_box(card: str):
    proc = subprocess.run([sys.executable, "-m",
                           "top_down_renderer_torch.probes.variants",
                           "--child"],
                          capture_output=True, text=True, timeout=300)
    err = [ln for ln in proc.stderr.splitlines() if "Error" in ln]
    return dict(variant="any_byte_box", case="window/async x=8",
                child_rc=proc.returncode,
                error=err[-1] if err else None, card=card)


def mm_variants(dev, card: str):
    lockstep = build_variant("probe_mm", "lockstep", LOCKSTEP)
    rng = P._rng(0, 3)
    for m in (P.N, 6 * mm.SMS * mm.TILE):
        a8 = torch.as_tensor(rng.integers(-127, 128, (m, P.THETA_K),
                                          dtype=np.int8), device=dev)
        b8 = torch.as_tensor(rng.integers(-127, 128, (P.THETA_N, P.THETA_K),
                                          dtype=np.int8), device=dev)
        bb = (b8.float() / 128).to(torch.bfloat16)
        ab = (a8.float() / 128).to(torch.bfloat16)
        runs = [("s8", None, lambda: mm.mm_s8(a8, b8)),
                ("s8_to_bf16", None, lambda: mm.mm_bf16(a8, bb)),
                ("bf16", None, lambda: mm.mm_bf16(ab, bb))]
        if m == P.N:
            runs.insert(2, ("s8_to_bf16", lockstep, lambda: mm.mm_bf16(a8,
                                                                       bb)))
        for a_type, lib, run in runs:
            split = mm.plan(m, P.THETA_N, P.THETA_K, a_type, False)[1]
            with (using("probe_mm", lib) if lib else contextlib.nullcontext()):
                got = run()
                a = a8 if a_type != "bf16" else ab
                b = b8 if a_type == "s8" else bb
                if a_type == "s8":
                    P.check(torch.equal(got, mm.mm_s8_plain(a, b)),
                            "s8 differs from the plain version")
                else:
                    P._close(a_type, got, mm.mm_bf16_plain(a, b),
                             mm.abs_products(a, b))
                ms, tries = P.kernel_ms(run, P.SYMBOLS["probe_mm"],
                                        per_call=2 if split > 1 else 1)
            yield dict(variant="lockstep" if lib else "shipped",
                       case=f"theta_shape/{a_type}", rows=m, split_k=split,
                       kernel_ms=ms, profile_tries=tries, card=card)
        del a8, b8, ab, bb


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=P.N, help="windows")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return any_byte_child()
    dev = kernels.default_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = P.card(dev)
    for rec in window_variants(dev, args.n, card):
        print(json.dumps(rec), flush=True)
    child = any_byte_box(card)
    print(json.dumps(child), flush=True)
    P.check(child["child_rc"] != 0, "a TMA box at byte 8 ran: the 16-byte "
            "start rule does not hold on this card")
    for rec in mm_variants(dev, card):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
