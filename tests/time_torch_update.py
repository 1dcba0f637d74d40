"""Host-clock time of the port's tracked ParticleFilter.update, on the card.

Builds chip_smoke.py's 102,400-particle filter (1024^2 class-map world,
res 0.5, fixed scale 2) and its cloud clustered to 100 px, and times 20
tracked updates on the crop path (the dispatch's conv region withheld,
where the tree has one) from the same state (step 1: no GMM refit): the
median of
the whole update (synchronised) and of the tracked scorer's host part
inside it (crop_score.score_tracked, not synchronised).  It times them
three times in the one process: first fresh, then after what chip_smoke's
phase D runs before it times the update (the tracked wrapper under
torch.profiler, then its plain version), to show what that order does to
the reading.  Then it runs one more update under torch.cuda's sync debug
mode, which warns at each synchronising call, and prints the host-side
operator table of 10 updates under torch.profiler.

The tree to time is ROOT (default: this checkout); running it from two
checkouts on one machine, one after the other, compares them:

    python tests/time_torch_update.py [ROOT]
"""

from __future__ import annotations

import os
import sys
import time
import warnings

ROOT = os.path.abspath(
    sys.argv[1] if len(sys.argv) > 1
    else os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from top_down_renderer_torch import kernels  # noqa: E402
from top_down_renderer_torch.filter import crop_score as cs  # noqa: E402
from top_down_renderer_torch.testing import synthetic_setup  # noqa: E402
from top_down_renderer_torch.utils.convert import (  # noqa: E402
    filter_state_from_numpy,
)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_torch_update: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(smoke.card_name_and_limit())
    kernels.build_all()
    pf, world = smoke.big_filter(dev)
    scan = smoke.scan_at(world, 0, dev)
    d = synthetic_setup(smoke.N, h=smoke.HW, w=smoke.HW, c=3,
                        cluster=(smoke.HW // 2, smoke.HW // 2, 100),
                        theta_spread=(0.7, 0.15))
    clustered = filter_state_from_numpy(d["state"], dev).replace(step=1)
    pf._conv_region = lambda mo: None  # the crop path's tracked update

    def update():
        pf.state, pf._all_have_init = clustered, True
        pf.update(scan, smoke.RES)

    scorer, host = cs.score_tracked, []

    def timed_scorer(*args, **kw):
        t0 = time.perf_counter()
        out = scorer(*args, **kw)
        host.append(time.perf_counter() - t0)
        return out

    cs.score_tracked = timed_scorer

    def median_update(label):
        torch.cuda.synchronize()
        host.clear()
        walls = []
        for _ in range(20):
            t0 = time.perf_counter()
            update()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(f"{ROOT}: tracked update {label}: {np.median(walls) * 1e3:.4f}"
              f" ms, its scorer's host part {np.median(host) * 1e3:.4f} ms "
              f"(medians of 20, {smoke.N} particles)")

    for _ in range(5):
        update()
    median_update("fresh")
    p = clustered.particles
    args = (pf._get_map(1), 3, pf._device_consts()[1], scan,
            torch.tensor([0.1, 1.5, 3.0], device=dev), p.pose_px())
    kernel, plain = smoke.crop_pair(args, p.theta,
                                    smoke.SCALE_GT * smoke.RES)[0]
    smoke.kernel_ms(kernel, smoke.SYMBOLS["crop_score_tracked"])
    median_update("after the wrapper under torch.profiler")
    smoke.median_ms(plain, warmup=0, runs=3)
    median_update("after the plain version too")

    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")
    update()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode(0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            update()
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=25))
    return 0


if __name__ == "__main__":
    sys.exit(main())
