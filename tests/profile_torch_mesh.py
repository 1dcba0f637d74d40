"""Where the time of a world-1 mesh update goes, beside the single-device
update, on the card.

Builds chip_smoke.py's phase M1 cells at 102,400 particles on the 1024^2
world: the unknown-scale theta search from the 10 hypotheses (a fresh
spread init), and the conv update of the clustered cloud, each on a
ParticleFilter over a world-1 NCCL mesh and on a single-device one, from
the same state (step 1: no GMM refit).  Times each update by host clock
(median of 20, synchronised) in turns, mesh, single, single, mesh; then
profiles 10 updates of each with torch.profiler and prints, per update,
the wall time, the kernels' device time, the count of top-level host
operators and their host time, and the top host operators by host time
(the collectives among them); writes the full tables to --out.

Usage (on a machine with a CUDA card):
    python tests/profile_torch_mesh.py [--out DIR]
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import tempfile
import time

_here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_here))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from top_down_renderer_torch import kernels  # noqa: E402
from top_down_renderer_torch.parallel import sharding  # noqa: E402

STEPS = 10


def updater(pf, state, have, scan):
    def update():
        pf.state, pf._all_have_init = state, have
        pf._snap = None  # the snapshot of a new state is read afresh
        pf.update(scan, smoke.RES)

    return update


def host_profile(name, update, out_dir):
    for _ in range(3):
        update()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            update()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_ms = sum(smoke.device_us(e) for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / 1e3
    tops = [e for e in prof.events() if e.device_type == DeviceType.CPU
            and e.cpu_parent is None]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in tops:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.cpu_time_total / 1e3
    print(f"[{name}] {wall_ms / STEPS:.4f} ms/update wall, kernels "
          f"{dev_ms / STEPS:.4f} ms/update on the device; {len(tops) / STEPS:.0f}"
          f" top-level host operators per update, "
          f"{sum(v[1] for v in by_name.values()) / STEPS:.4f} ms of host "
          f"time in them")
    for op, (count, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:14]:
        print(f"[{name}]   {ms / STEPS:8.4f} ms/update x{count / STEPS:<5.1f} "
              f"{op[:80]}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"mesh_{name}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                          row_limit=60))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_mesh: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    print(smoke.card_name_and_limit())
    kernels.build_all()
    store = tempfile.mkdtemp(dir=kernels.BUILD_DIR)
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(store, "pg"), 1), rank=0, world_size=1, device_id=dev)
    try:
        mesh = sharding.make_mesh(1)
        world = smoke.make_world(smoke.HW, smoke.HW)
        scan = smoke.scan_at(world, 0, dev, move=False)
        cells = {}
        for which, m in (("mesh", mesh), ("single", None)):
            pf, _ = smoke.make_filter(dev, smoke.N, seed=0, world=world,
                                      fixed_scale=-1.0, mesh=m)
            cells[f"multi_init_{which}"] = updater(
                pf, pf.state.replace(step=1), False, scan)
            pf, _ = smoke.make_filter(dev, smoke.N, seed=0, world=world,
                                      mesh=m)
            start = smoke.clustered_state(dev)
            if m is not None:
                start = sharding.shard_filter_state(start, m)
            cells[f"conv_{which}"] = updater(pf, start, True, scan)
        for cell in ("multi_init", "conv"):
            times = {}
            for which in ("mesh", "single", "single", "mesh"):
                times.setdefault(which, []).append(
                    smoke.median_ms(cells[f"{cell}_{which}"]))
            print(f"[{cell}] update, host clock, median of 20 (two rounds): "
                  f"mesh {times['mesh']}, single {times['single']} ms")
        for name, update in cells.items():
            host_profile(name, update, args.out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
