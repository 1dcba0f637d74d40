"""Count the host's blocking reads of the card per ParticleFilter.update
followed by pose_stats(), in the port checked out at ROOT.

    python tests/count_torch_syncs.py [ROOT] [--updates N]

ROOT defaults to this checkout; give it another (a parent commit
unpacked with git archive) to compare two trees in one call, in turns.
The filter holds 102,400 particles at a known scale on the city world
of benchmarks/city_bag.py (make_city(1536, 1536, 0), built from its class
maps, so that a tree without a PNG reader builds it too); each update
takes the next scan of the city drive (tests/city_drive_torch.py),
rendered at a range scale of 4 m a bin, with the drive's odometry as the
motion.  A blocking read is a synchronising call that torch.cuda's sync
debug mode reports (a read to the host, or a copy from pageable memory)
or a wait on the filter's snapshot copy (its snapshot_reads, where the
tree has them).  Prints the reads per update, by site, and the plans,
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import warnings

_here = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=os.path.dirname(_here))
    ap.add_argument("--updates", type=int, default=30)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, _here)
    import city_drive_torch as city_drive  # this checkout's world and bag

    # the package of ROOT, not this checkout's
    for name in [m for m in sys.modules
                 if m.startswith("top_down_renderer_torch")]:
        del sys.modules[name]
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from top_down_renderer_torch import FilterParams, MapParams
    from top_down_renderer_torch.filter.filter import ParticleFilter
    from top_down_renderer_torch.maps.map import TopDownMap
    from top_down_renderer_torch.render.semantic import render_semantic_polar
    import top_down_renderer_torch as pkg

    if os.path.dirname(os.path.dirname(pkg.__file__)) != root:
        raise RuntimeError(f"imported {pkg.__file__}, not the package of "
                           f"{root}")
    if not torch.cuda.is_available():
        print("count_torch_syncs: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    maps, traj, psi = city_drive.city_world()
    bag = city_drive.make_bag(maps, traj, psi, args.updates)
    cc = city_drive.class_config()
    tdm = TopDownMap(MapParams(num_classes=6), device=dev, class_maps=maps)
    tdm.sample_pts_polar(100, 25)
    fp = FilterParams(fixed_scale=city_drive.SCALE,
                      class_weights=cc.class_weights().tolist(),
                      **city_drive.OVERRIDES)
    pf = ParticleFilter(102_400, tdm, fp, seed=0, device=dev)
    res = 4.0
    lut = torch.as_tensor(cc.flatten_lut(), device=dev)
    plans, sites, per_update = [], {}, []
    fast_mode = pf._fast_mode

    def planned(r):
        plans.append(fast_mode(r))
        return plans[-1]

    pf._fast_mode = planned
    reads0 = getattr(pf, "snapshot_reads", 0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(args.updates):
            pts = torch.as_tensor(bag.scan(i), device=dev)
            scan = render_semantic_polar(pts, lut, torch.full(
                (), res, device=dev), torch.full(
                (), 2 * math.pi / 100, device=dev), 6, 100, 25)
            if i:
                d = bag.prior_pos[i] - bag.prior_pos[i - 1]
                yaw = [2 * math.atan2(q[2], q[3])
                       for q in bag.prior_quat[i - 1:i + 1]]
                c, s = math.cos(-yaw[0]), math.sin(-yaw[0])
                pf.propagate(np.array([c * d[0] - s * d[1],
                                       s * d[0] + c * d[1]], np.float32),
                             yaw[1] - yaw[0])
            torch.cuda.synchronize()
            n0, r0 = len(caught), getattr(pf, "snapshot_reads", 0)
            torch.cuda.set_sync_debug_mode("warn")
            pf.update(scan, res)
            pf.pose_stats()
            torch.cuda.set_sync_debug_mode("default")
            new = [w for w in caught[n0:]
                   if "synchronizing CUDA operation" in str(w.message)]
            for w in new:
                site = f"{os.path.relpath(w.filename, root)}:{w.lineno}"
                sites[site] = sites.get(site, 0) + 1
            per_update.append(len(new) + getattr(pf, "snapshot_reads", 0)
                              - r0)
    snap = getattr(pf, "snapshot_reads", 0) - reads0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[{root}] blocking reads per update + pose_stats over "
          f"{args.updates} updates: mean {np.mean(per_update):.2f}, first "
          f"{per_update[:3]}, after {np.mean(per_update[3:]):.2f}; snapshot "
          f"reads {snap}; plans "
          + " ".join("exact" if p is None else f"{p.path}/{p.mode}/mip{p.mip}"
                     for p in plans[:6]) + " ...")
    print(f"[{root}] sites: " + "; ".join(
        f"{k} x{v}" for k, v in sorted(sites.items(), key=lambda kv: -kv[1])))
    print(f"[{root}] on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
