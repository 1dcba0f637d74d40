"""Host-clock A/B of the float tracked path, or of the float theta search
(--path init), of two checkouts on the card, in paired rounds.

Each round runs OLD, NEW, NEW, OLD, one process each (OLD the parent, NEW
by default this checkout), and each process times at 102,400 particles,
on the host's clock, synchronised, for the tracked path:

  wrapper_c3  crop_score.score_tracked on the clustered cell of
              tests/time_torch_tracked.py (1024^2 3-class map, the cloud
              in a 100 px square, thetas in a 0.15 rad band, f = 1);
  wrapper_c6  the same cloud on a 6-class map (the city's class count);
  update_d    chip_smoke D's tracked ParticleFilter.update, as
              tests/time_torch_update.py times it fresh (1024^2 world,
              res 0.5, the cloud clustered to 100 px, the conv region
              withheld);
  update_n1   a tracked update of chip_smoke N1's node (city.png, 1536^2,
              6 classes): the city drive's first SCANS scans replayed
              through the node, then the last of their updates that ran
              the crop path's tracked kernel alone and refit no GMM
              (pf.gmm_every), repeated from the state it started from
              (the conv region withheld).

Each is the median of RUNS calls after 5 warm-up calls, and each timed
update must launch the tracked kernel and no theta search or conv field
(kernels.LAUNCHES).  Each update also gives the host time of
crop_score.score_tracked inside it (not synchronised, median over the
same calls: "_scorer_ms"), the tracked kernel's device time in it
(chip_smoke.kernel_ms: "_kernel_ms") and, for N1, its plan (chip_smoke's
PlanLog).  Each checkout also gives the host time (not synchronised,
median of ORDER_RUNS calls taken in turns, the queue drained before each)
of the tracked wrapper's two row orders on the clustered C = 3 cell's
keys: tracked_rows (the single-plane M's) and tracked_order
("order_host_us"), and their device time under torch.profiler (every
device activity of DEVICE_RUNS calls, a call's sum, with the activities
a call and their names: "order_device_us"), whatever launches they make
(a key kernel and torch.sort's kernels before crop_score.order_rows, its
one launch since).

For the theta search (--path init, crop_init_kernel: the float map with
the hi/lo M):

  wrapper_c3  crop_score.score_init_sel on the spread cell of
              tests/time_torch_tracked.py --kernel init (1024^2 3-class
              map, f = 1);
  wrapper_c6  the spread cloud on a 6-class map;
  update_d    chip_smoke D's crop-init spread update (a fresh spread
              init of a 1024^2 world's filter, res 0.5, no particle with
              a theta yet), which must launch the theta search and no
              tracked kernel or conv field;

with the update's scorer (crop_score.score_init_sel, "_scorer") and
kernel ("_kernel") as above, and the host and device time of its rows on
the C = 3 cell's centres (order_host_us, order_device_us, as above):
init_order at one bucket, at 12 buckets (each centre's bucket its row
mod 12: the K-bucket form, with row_start from a searchsorted before
crop_score.order_rows), and tracked_order at one bucket ("sort").

Each process prints one JSON line; last comes the summary: for each
metric the medians of OLD's and of NEW's processes, and for each round
NEW's two medians' mean less OLD's, and over the rounds their median,
least and greatest; and OLD's and NEW's order_host_us and
order_device_us (medians over their processes):

    python tests/time_torch_tracked_host.py [--path tracked|init] [--rounds R] OLD_ROOT [NEW_ROOT]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

RUNS = 50
ORDER_RUNS = 200
DEVICE_RUNS = 50
SCANS = 60
METRICS = {"tracked": ("wrapper_c3", "wrapper_c6", "update_d", "update_n1",
                        "update_d_scorer", "update_n1_scorer",
                        "update_d_kernel", "update_n1_kernel"),
           "init": ("wrapper_c3", "wrapper_c6", "update_d",
                    "update_d_scorer", "update_d_kernel")}


def child(root: str) -> dict:
    """The tracked path's medians (ms) of the checkout at root."""
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import time

    import numpy as np
    import torch

    import chip_smoke as smoke
    import city_drive_torch as city_drive
    from top_down_renderer_torch import kernels
    from top_down_renderer_torch.filter import crop_score as cs
    from top_down_renderer_torch.testing import synthetic_setup
    from top_down_renderer_torch.utils.convert import filter_state_from_numpy

    dev = torch.device("cuda")
    kernels.build_all()
    out = {"root": root, "card": smoke.card_name_and_limit()}

    def median(fn):
        return smoke.median_ms(fn, warmup=5, runs=RUNS)

    cw = {3: [0.1, 1.5, 3.0], 6: [0.1, 1.5, 3.0, 0.7, 1.1, 2.0]}
    for c in (3, 6):
        d = synthetic_setup(smoke.N, h=1024, w=1024, c=c,
                            cluster=(462, 462, 100),
                            theta_spread=(0.7, 0.075))
        p = d["state"]["particles"]
        args = [torch.as_tensor(v, device=dev) for v in (
            d["stencil"], d["scan"], np.asarray(cw[c], np.float32),
            p["init_px"], p["theta"])]
        maps = cs.CropMap(torch.as_tensor(d["packed"], device=dev))
        out[f"wrapper_c{c}"] = median(
            lambda: cs.score_tracked(maps, c, *args, 1.0))
        if c == 3:
            out.update(order_times(
                cs, *cs._tracked_inputs(maps, c, *args, 1.0, 1.0)[2:],
                args[1].shape[1], 1024))

    def tracked_alone(fn):
        """fn() once; whether it launched the tracked kernel and no
        theta search or conv field."""
        before, conv = dict(kernels.LAUNCHES), smoke.conv_calls()
        fn()
        d = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        return (d["crop_score_tracked"] >= 1 and d["crop_score_init"] == 0
                and smoke.conv_calls() == conv)

    scorer, host = cs.score_tracked, []

    def timed_scorer(*args, **kw):
        t0 = time.perf_counter()
        got = scorer(*args, **kw)
        host.append((time.perf_counter() - t0) * 1e3)
        return got

    def timed_update(label, fn):
        if not tracked_alone(fn):
            raise RuntimeError(f"{label}: not the tracked kernel alone")
        cs.score_tracked = timed_scorer
        host.clear()
        out[label] = median(fn)
        out[f"{label}_scorer"] = float(np.median(host[-RUNS:]))
        cs.score_tracked = scorer
        ms = smoke.kernel_ms(fn, ("crop_tracked_kernel<",))
        out[f"{label}_kernel"] = ms[0] if isinstance(ms, tuple) else ms
        if not tracked_alone(fn):
            raise RuntimeError(f"{label}: not the tracked kernel alone")

    pf, world = smoke.big_filter(dev)
    scan = smoke.scan_at(world, 0, dev)
    d = synthetic_setup(smoke.N, h=smoke.HW, w=smoke.HW, c=3,
                        cluster=(smoke.HW // 2, smoke.HW // 2, 100),
                        theta_spread=(0.7, 0.15))
    clustered = filter_state_from_numpy(d["state"], dev).replace(step=1)
    pf._conv_region = lambda mo: None

    def update_d():
        pf.state, pf._all_have_init = clustered, True
        pf.update(scan, smoke.RES)

    timed_update("update_d", update_d)
    del pf, world

    maps, traj, psi = city_drive.city_world()
    bag = city_drive.make_bag(maps, traj, psi, SCANS)
    node = city_drive.make_node(particles=smoke.N, device=dev)
    node.warmup()
    pf, seen = node.filter, []
    update = pf.update

    def recorded(scan, res):
        start = (pf.state, pf._all_have_init, scan.clone(), res)
        refit = int(pf.state.step) % pf.gmm_every == 0
        alone = tracked_alone(lambda: update(scan, res))
        seen.append((len(seen), start if alone and not refit else None))

    pf.update = recorded
    city_drive.run(node, bag, traj)
    del pf.update  # the instance attribute: the method again
    i, start = max((u for u in seen if u[1] is not None),
                   key=lambda u: u[0])
    state, init, n1_scan, res = start
    pf._conv_region = lambda mo: None

    def update_n1():
        pf.state, pf._all_have_init = state, init
        pf.update(n1_scan, res)

    timed_update("update_n1", update_n1)
    with smoke.PlanLog() as plans:
        update_n1()
    out["n1_update_index"] = i
    out["n1_plan"] = f"{plans[-1].path}/{plans[-1].mode}/mip{plans[-1].mip}"
    torch.cuda.synchronize()
    return out


def init_child(root: str) -> dict:
    """The theta search's medians (ms) of the checkout at root."""
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import time

    import numpy as np
    import torch

    import chip_smoke as smoke
    from top_down_renderer_torch import kernels
    from top_down_renderer_torch.filter import crop_score as cs
    from top_down_renderer_torch.testing import synthetic_setup

    dev = torch.device("cuda")
    kernels.build_all()
    out = {"root": root, "card": smoke.card_name_and_limit()}

    def median(fn):
        return smoke.median_ms(fn, warmup=5, runs=RUNS)

    cw = {3: [0.1, 1.5, 3.0], 6: [0.1, 1.5, 3.0, 0.7, 1.1, 2.0]}
    for c in (3, 6):
        d = synthetic_setup(smoke.N, h=1024, w=1024, c=c)
        args = [torch.as_tensor(v, device=dev) for v in (
            d["stencil"], d["scan"], np.asarray(cw[c], np.float32),
            d["state"]["particles"]["init_px"])]
        maps = cs.CropMap(torch.as_tensor(d["packed"], device=dev))
        out[f"wrapper_c{c}"] = median(
            lambda: cs.score_init_sel(maps, c, *args, 1.0))
        if c == 3:
            ctr = cs.crop_centers(args[3], 1.0).contiguous()
            zeros = torch.zeros(ctr.shape[0], dtype=torch.int64, device=dev)
            k12 = torch.arange(ctr.shape[0], device=dev) % 12
            fns = {"init_order": lambda: cs.init_order(zeros, ctr, 1, 1024),
                   "init_order_k12": lambda: cs.init_order(k12, ctr, 12,
                                                           1024),
                   "sort": lambda: cs.tracked_order(zeros, ctr, 1, 1024)}
            out["order_host_us"] = host_us(fns)
            out["order_device_us"] = device_us_a_call(fns)

    def init_alone(fn):
        """fn() once; whether it launched the theta search and no
        tracked kernel or conv field."""
        before, conv = dict(kernels.LAUNCHES), smoke.conv_calls()
        fn()
        d = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        return (d["crop_score_init"] >= 1 and d["crop_score_tracked"] == 0
                and smoke.conv_calls() == conv)

    scorer, host = cs.score_init_sel, []

    def timed_scorer(*args, **kw):
        t0 = time.perf_counter()
        got = scorer(*args, **kw)
        host.append((time.perf_counter() - t0) * 1e3)
        return got

    pf, world = smoke.big_filter(dev)
    scan = smoke.scan_at(world, 0, dev)
    pf.initialize_particles()  # spread cloud, no theta prior
    spread = pf.state.replace(step=1)

    def update_d():
        smoke.as_updated(pf, spread, False)
        pf.update(scan, smoke.RES)

    if not init_alone(update_d):
        raise RuntimeError("update_d: not the theta search alone")
    cs.score_init_sel = timed_scorer
    out["update_d"] = median(update_d)
    out["update_d_scorer"] = float(np.median(host[-RUNS:]))
    cs.score_init_sel = scorer
    ms = smoke.kernel_ms(update_d, ("crop_init_kernel<",))
    out["update_d_kernel"] = ms[0] if isinstance(ms, tuple) else ms
    if not init_alone(update_d):
        raise RuntimeError("update_d: not the theta search alone")
    torch.cuda.synchronize()
    return out


def order_times(cs, ctr, key, groups: int, extent: int) -> dict:
    """{"order_host_us": {row order: host us a call}, "order_device_us":
    {row order: device_us_a_call's}} (module docstring)."""
    fns = {"rows": lambda: cs.tracked_rows(key),
           "order": lambda: cs.tracked_order(key, ctr, groups, extent)}
    return {"order_host_us": host_us(fns),
            "order_device_us": device_us_a_call(fns)}


def device_us_a_call(fns: dict) -> dict:
    """{name: {"us": the device time of a call of fns[name], "activities":
    the device activities a call (kernels, copies, fills), "names": their
    names}}: the sums over DEVICE_RUNS calls under torch.profiler, after 5
    to warm up, over the calls; a profile with no device activity (an
    empty device trace) is taken again, up to three in all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from top_down_renderer_torch.probes.__main__ import device_us

    out = {}
    for k, fn in fns.items():
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(DEVICE_RUNS):
                    fn()
                torch.cuda.synchronize()
            ev = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
            if ev:
                break
        out[k] = {"us": sum(device_us(e) for e in ev) / DEVICE_RUNS,
                  "activities": sum(e.count for e in ev) / DEVICE_RUNS,
                  "names": sorted(e.key for e in ev)}
    return out


def host_us(fns: dict) -> dict:
    """{name: host us a call of fns[name]}: the median of ORDER_RUNS calls
    taken in turns, the queue drained before each (not synchronised
    after)."""
    import time

    import numpy as np
    import torch

    host = {k: [] for k in fns}
    for i in range(ORDER_RUNS + 5):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            if i >= 5:
                host[k].append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return {k: float(np.median(v)) for k, v in host.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=tuple(METRICS), default="tracked")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("old", nargs="?")
    ap.add_argument("new", nargs="?", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    args = ap.parse_args()
    if args.child:
        import torch

        if not torch.cuda.is_available():
            print("time_torch_tracked_host: no CUDA device", file=sys.stderr)
            return 1
        print(json.dumps((init_child if args.path == "init" else child)(
            args.child)))
        return 0
    if args.old is None:
        ap.error("OLD_ROOT is required")
    old, new = os.path.abspath(args.old), os.path.abspath(args.new)
    runs = {old: [], new: []}
    for r in range(args.rounds):
        for root in (old, new, new, old):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--path",
                 args.path, "--child", root], capture_output=True, text=True)
            if proc.returncode != 0:
                sys.stderr.write(proc.stdout + proc.stderr)
                return proc.returncode
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            got["round"] = r
            print(json.dumps(got), flush=True)
            runs[root].append(got)
    summary = {"old": old, "new": new, "path": args.path,
               "rounds": args.rounds, "card": runs[new][0]["card"]}
    for m in METRICS[args.path]:
        diffs = [(runs[new][2 * r][m] + runs[new][2 * r + 1][m]) / 2
                 - (runs[old][2 * r][m] + runs[old][2 * r + 1][m]) / 2
                 for r in range(args.rounds)]
        summary[m] = {
            "old_ms": [x[m] for x in runs[old]],
            "new_ms": [x[m] for x in runs[new]],
            "old_median_ms": statistics.median(x[m] for x in runs[old]),
            "new_median_ms": statistics.median(x[m] for x in runs[new]),
            "new_less_old_ms": diffs,
            "median_ms": statistics.median(diffs),
            "least_ms": min(diffs), "greatest_ms": max(diffs)}
    for side, root in (("old", old), ("new", new)):
        if "order_host_us" not in runs[root][0]:
            continue
        summary[f"order_host_us_{side}"] = {
            k: statistics.median(x["order_host_us"][k] for x in runs[root])
            for k in runs[root][0]["order_host_us"]}
        summary[f"order_device_us_{side}"] = {
            k: {"us": statistics.median(x["order_device_us"][k]["us"]
                                        for x in runs[root]),
                "activities": runs[root][0]["order_device_us"][k][
                    "activities"],
                "names": runs[root][0]["order_device_us"][k]["names"]}
            for k in runs[root][0]["order_device_us"]}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
