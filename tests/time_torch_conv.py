"""Host-clock times of the conv update and of its parts, on the card.

Builds chip_smoke.py's 102,400-particle filter (1024^2 class-map world,
res 0.5, fixed scale 2) and its cloud clustered to 100 px with a 0.15 rad
theta band (the conv cell: region 128, mo 24, a window of 16 shifts), and
times, in ROUNDS rounds of turns (default 3), the median of 20
synchronised updates from the same state (step 1: no GMM refit) on each path: the crop path
(the conv region withheld from the dispatch), the conv path reading its
host snapshot afresh (as the update of a state no update made does), and
the conv path with the state's snapshot copy made, as the update that
made it leaves it, and that update with the int8 field (a filter made
with conv_int8=True, TDR_CONV_INT8=1), and the quartiles over the rounds
of the int8 update's median less the float32 one's (both with the
snapshot kept, one after the other in each round).  Then the medians of 20
synchronised calls of the conv update's parts: the snapshot read, the
dispatch's plan with the snapshot kept, the kernel build, the cost field,
the whole conv scorer; the int8 field's parts: the kernel's quantization
and its layout by their plain versions, the quantizer kernel, the field
kernel alone (on the quantizer's outputs) and with its quantization (the
two launches), the int8 conv scorer; and
beside them the crop path's tracked scorer.

    python tests/time_torch_conv.py [ROUNDS]
"""

from __future__ import annotations

import os
import sys
import time

_here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_here))
sys.path.insert(0, _here)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from top_down_renderer_torch.filter import conv_score  # noqa: E402
from top_down_renderer_torch.filter import crop_score as cs  # noqa: E402
from top_down_renderer_torch.filter import filter as ft  # noqa: E402


def median_ms(fn, runs=20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        print("time_torch_conv: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = smoke.card_name_and_limit()
    pf, world = smoke.big_filter(dev)
    pf8, _ = smoke.big_filter(dev, conv_int8=True)
    scan = smoke.scan_at(world, 0, dev)
    clustered = smoke.clustered_state(dev)
    sten = pf._device_consts()[1]
    cw = torch.tensor([0.1, 1.5, 3.0], device=dev)
    f = smoke.SCALE_GT * smoke.RES

    def update(path, fresh=True, filt=pf):
        def run():
            smoke.as_updated(filt, clustered, True)
            if fresh:
                filt._snap = None
            if path == "crop":
                filt._conv_region = lambda mo: None
            try:
                filt.update(scan, smoke.RES)
            finally:
                filt.__dict__.pop("_conv_region", None)
        return run

    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    diffs = []
    for rnd in range(rounds):
        got = {}
        for label, fn in (("crop update", update("crop")),
                          ("conv update, snapshot read afresh",
                           update("conv")),
                          ("conv update, snapshot kept",
                           update("conv", fresh=False)),
                          ("conv update, int8 field, snapshot kept",
                           update("conv", fresh=False, filt=pf8))):
            got[label] = median_ms(fn)
            print(f"round {rnd}: {label}: {got[label]:.4f} ms")
        diffs.append(got["conv update, int8 field, snapshot kept"]
                     - got["conv update, snapshot kept"])
    q1, q2, q3 = np.percentile(diffs, [25, 50, 75])
    print(f"int8 less float32 conv update over {rounds} rounds: quartiles "
          f"{q1:.4f} / {q2:.4f} / {q3:.4f} ms, range {min(diffs):.4f} to "
          f"{max(diffs):.4f} ms, {sum(d < 0 for d in diffs)} rounds below 0")

    pf.state, pf._all_have_init = clustered, True
    plan = pf._fast_mode(smoke.RES)
    print(f"plan: {plan}")
    p = clustered.particles
    cmap = pf._get_conv_map()
    kernel = conv_score.build_conv_kernel(scan, cw, sten, f, plan.mo,
                                          "tracked", window_w=plan.ww,
                                          s0=plan.s0)
    origin = torch.round(p.pose_px().flip(-1)).to(torch.int64).amin(0) + 64
    scorer = conv_score.make_conv_scorer(plan.mo, plan.region, "tracked",
                                         window_w=plan.ww)
    scorer8 = conv_score.make_conv_scorer(plan.mo, plan.region, "tracked",
                                          window_w=plan.ww, conv_int8=True)
    cmap8 = pf8._get_conv_map()
    ints = conv_score.quantize_conv_kernel(kernel, cmap8.qinv)[0]
    laid = conv_score.quantize_i8(kernel, cmap8.qinv)
    parts = {
        "snapshot read": lambda: ft._snapshot_vec(clustered).cpu(),
        "plan, snapshot kept": lambda: pf._fast_mode(smoke.RES),
        "kernel build": lambda: conv_score.build_conv_kernel(
            scan, cw, sten, f, plan.mo, "tracked", window_w=plan.ww,
            s0=plan.s0),
        "cost field": lambda: conv_score.cost_field(
            cmap.padded, kernel, origin, plan.mo, plan.region),
        "conv scorer": lambda: scorer(cmap, sten, scan, cw, p.pose_px(),
                                      p.theta, f, p.alive, plan.s0),
        "int8 quantizer, plain": lambda: conv_score.quantize_conv_kernel(
            kernel, cmap8.qinv),
        "int8 layout, plain": lambda: conv_score.i8_layout(ints),
        "int8 quantizer kernel": lambda: conv_score.quantize_i8(
            kernel, cmap8.qinv),
        "int8 field kernel alone": lambda: conv_score.launch_field_i8(
            cmap8.codes, *laid, origin, plan.mo, plan.region,
            ints.shape[0]),
        "int8 cost field, two launches": lambda: conv_score.conv_field_i8(
            cmap8.codes, cmap8.qinv, kernel, origin, plan.mo, plan.region),
        "int8 conv scorer": lambda: scorer8(cmap8, sten, scan, cw,
                                            p.pose_px(), p.theta, f,
                                            p.alive, plan.s0),
        "crop tracked scorer": lambda: cs.score_tracked(
            pf._get_map(1), 3, sten, scan, cw, p.pose_px(), p.theta, f),
    }
    for label, fn in parts.items():
        print(f"part: {label}: {median_ms(fn):.4f} ms")
    print(f"({smoke.N} particles, {smoke.HW}^2 map) on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
