"""Where the time of one ParticleFilter.update goes, on the card.

Builds the 102,400-particle filters of chip_smoke.py (1024^2 class-map
world, res 0.5) and profiles 10 updates in each of five regimes with
torch.profiler: at fixed scale 2, theta search on a spread cloud (crop at
mip 1), and tracked on chip_smoke's cloud clustered to 100 px, on the
conv path the dispatch plans there and on the crop path (the conv region
withheld); at an unknown scale (the K-bucket crop path), theta search on
the 10 scale hypotheses of a fresh spread init, and tracked on the same
population once each particle has a theta.  Each update starts from the
same state (step 1: no GMM refit), as the update that made it leaves
the filter (chip_smoke.as_updated: its snapshot copy made).  Prints,
per regime, the
wall time per update, the device busy share (device kernel time over
wall time), the count of top-level operators per update and their host
time, and the top kernels by device time; writes the full tables
and chrome traces to --out (default profile_out/).

Usage (on a machine with a CUDA card):
    python tests/profile_torch_step.py [--out DIR]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

_here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_here))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as smoke  # noqa: E402

STEPS = 10


def profile_regime(name, pf, state, have_init, scan, out_dir):
    def update():
        smoke.as_updated(pf, state, have_init)
        pf.update(scan, smoke.RES)

    for _ in range(3):
        update()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            update()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: aten ops also carry the device time of the kernels
    # they launch, which would count it twice
    events = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and smoke.device_us(e) > 0
    ]
    dev_ms = sum(smoke.device_us(e) for e in events) / 1e3
    events.sort(key=smoke.device_us, reverse=True)
    # the host's side: the operators the update calls itself, not those
    # they call in turn
    tops = [e for e in prof.events() if e.device_type == DeviceType.CPU
            and e.cpu_parent is None and e.name.startswith("aten::")]
    print(f"[{name}] {wall_ms / STEPS:.4f} ms/update wall, device busy "
          f"{dev_ms / STEPS:.4f} ms/update ({100 * dev_ms / wall_ms:.1f}%); "
          f"{len(tops) / STEPS:.0f} top-level operators per update, "
          f"{sum(e.cpu_time_total for e in tops) / 1e3 / STEPS:.4f} ms of "
          f"host time in them")
    for e in events[:12]:
        print(f"[{name}]   {smoke.device_us(e) / 1e3 / STEPS:9.4f} ms/update "
              f"x{e.count // STEPS:<4d} {e.key[:90]}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=60))
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    print(smoke.card_name_and_limit())
    pf, world = smoke.big_filter(dev)
    scan = smoke.scan_at(world, 0, dev)
    spread = pf.state.replace(step=1)
    clustered = smoke.clustered_state(dev)
    profile_regime("init_spread", pf, spread, False, scan, args.out)
    profile_regime("tracked_clustered_conv", pf, clustered, True, scan,
                   args.out)
    pf._conv_region = lambda mo: None
    profile_regime("tracked_clustered_crop", pf, clustered, True, scan,
                   args.out)
    del pf._conv_region
    pf, _ = smoke.make_filter(dev, smoke.N, seed=0, world=world,
                              fixed_scale=-1.0)
    fresh = pf.state.replace(step=1)
    p = fresh.particles
    with_theta = fresh.replace(particles=p.replace(
        have_init=torch.ones_like(p.have_init)))
    profile_regime("multi_init", pf, fresh, False, scan, args.out)
    profile_regime("multi_tracked", pf, with_theta, True, scan, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
