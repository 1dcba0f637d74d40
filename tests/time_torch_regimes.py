"""Host-clock time of the port's single-device ParticleFilter.update in the
five regimes of tests/profile_torch_step.py, on the card, and the count
of top-level host operators in each.

Builds chip_smoke.py's 102,400-particle filters (1024^2 class-map world,
res 0.5): at fixed scale 2 the theta search on a spread cloud (crop at
mip 1), and the cloud clustered to 100 px tracked on the conv path and
(its conv region withheld) on the crop path; at an unknown scale the
K-bucket theta search from the 10 hypotheses and the K-bucket tracked
update.  Each update starts from the same state (step 1: no GMM refit)
and reads its host snapshot afresh.  Prints per regime the median of 20
synchronised updates after 3 warm-up ones, and the top-level aten
operators per update of 5 updates under torch.profiler (host only); the
last line is all of it as one JSON object.

The tree to time is ROOT (default: this checkout); running it for two
checkouts in turns in one call (parent, change, change, parent) compares
them:

    python tests/time_torch_regimes.py [ROOT]
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.abspath(
    sys.argv[1] if len(sys.argv) > 1
    else os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from top_down_renderer_torch import kernels  # noqa: E402


def measure(pf, state, have_init, scan) -> dict:
    def update():
        pf.state = state
        pf._all_have_init = have_init
        pf._snap = None
        pf.update(scan, smoke.RES)

    ms = smoke.median_ms(update)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            update()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CPU
           and e.cpu_parent is None and e.name.startswith("aten::")]
    return {"ms": ms, "ops": len(ops) / 5}


def main() -> int:
    if not torch.cuda.is_available():
        print("time_torch_regimes: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    name_limit = smoke.card_name_and_limit()
    kernels.build_all()
    pf, world = smoke.big_filter(dev)
    scan = smoke.scan_at(world, 0, dev)
    clustered = smoke.clustered_state(dev)
    out = {"root": ROOT, "card": name_limit}
    out["init_spread"] = measure(pf, pf.state.replace(step=1), False, scan)
    out["tracked_clustered_conv"] = measure(pf, clustered, True, scan)
    pf._conv_region = lambda mo: None
    out["tracked_clustered_crop"] = measure(pf, clustered, True, scan)
    del pf._conv_region
    pf, _ = smoke.make_filter(dev, smoke.N, seed=0, world=world,
                              fixed_scale=-1.0)
    fresh = pf.state.replace(step=1)
    p = fresh.particles
    with_theta = fresh.replace(particles=p.replace(
        have_init=torch.ones_like(p.have_init)))
    out["multi_init"] = measure(pf, fresh, False, scan)
    out["multi_tracked"] = measure(pf, with_theta, True, scan)
    for k, v in out.items():
        if isinstance(v, dict):
            print(f"[{k}] {v['ms']:.4f} ms/update (host clock, median of "
                  f"20), {v['ops']:.0f} top-level operators per update "
                  f"({smoke.N} particles, {smoke.HW}^2 map) on {name_limit}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
