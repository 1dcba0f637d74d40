"""Consumer drive through the PyTorch port (top_down_renderer_torch).

The flow of tests/drive_consumer.py, on the port's public entry points:
a class-map world (tests/util_synthetic.make_world) -> TopDownMap ->
ParticleFilter at fixed scale 2 -> per scan: render_semantic_polar,
propagate, update -> mean_likelihood / compute_mean_cov, then optionally
a dynamic-map swap (update_map with a shifted centre).  At res 1 the
dispatch runs the theta search with the crop kernel on a mip-2 map, then,
once the alive cloud fits a conv region, the conv path (conv bucket mo
48) on the full-resolution map, as the reference's dispatch does.

Pass criterion (the canonical drive's): err < 8 px and cov_xx < 400
after the scans, err < 10 px after a swap.

drive_unknown_scale() is the unknown-scale counterpart of
tests/test_scale_estimation.py: fixed_scale -1, so the filter starts
from the 10 scale hypotheses and the dispatch runs the K-bucket crop
path, with the node's freeze trigger applied by the caller.  Pass
criterion: the scale estimate within 10 % of 2.0 and cov[3, 3] < 0.1.

Usage: python tests/drive_consumer_torch.py [--device cuda]
       [--particles N] [--steps N] [--res R] [--swap N]
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time

_here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _here)
sys.path.insert(0, os.path.dirname(_here))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from top_down_renderer_torch import FilterParams, MapParams  # noqa: E402
from top_down_renderer_torch.filter.filter import ParticleFilter  # noqa: E402
from top_down_renderer_torch.maps.map import TopDownMap  # noqa: E402
from top_down_renderer_torch.render.semantic import (  # noqa: E402
    render_semantic_polar,
)
from util_synthetic import generate_scan_points, make_world, rot2d  # noqa: E402

SCALE_GT = 2.0
PSI_GT = 0.7
START = (60.0, 105.0)


def make_filter(device="cpu", particles=2048, seed=0, world=None, mesh=None,
                **params):
    """(ParticleFilter, world) on the drive's map and filter settings;
    `params` override the FilterParams; `mesh` shards the filter."""
    world = make_world() if world is None else world
    tdm = TopDownMap(
        MapParams(map_path="", num_classes=3), device=device,
        class_maps=world,
    )
    assert 1 in tdm.get_classes_at_point(START), "road missing"
    tdm.sample_pts_polar(100, 25)
    fp = FilterParams(
        pos_cov=0.1,
        theta_cov=math.pi / 100,
        regularization=0.02,
        fixed_scale=SCALE_GT,
        class_weights=[0.1, 1.5, 3.0],
        force_on_map=True,
    )
    fp = dataclasses.replace(fp, **params)
    return ParticleFilter(particles, tdm, fp, seed=seed, chunk_size=512,
                          device=device, mesh=mesh), world


def drive(
    device="cpu", particles=2048, steps=30, res=1.0, seed=0, swap_steps=0,
    on_step=None, log=print,
):
    """Run the drive; returns (err px, cov_xx) after the main scans and,
    with swap_steps > 0, the err after the dynamic-map swap.
    on_step(i, pf) runs after every update."""
    pf, world = make_filter(device, particles, seed)
    flut = np.arange(256, dtype=np.int32)
    ang_res = 2 * math.pi / 100
    gt = np.array(START, np.float32)
    frame_delta = np.zeros(2, np.float32)

    def step(i):
        nonlocal gt
        pts = generate_scan_points(
            world, gt, PSI_GT, SCALE_GT, max_range_m=25.0, n_pad=8192,
            seed=i,
        )
        scan = render_semantic_polar(
            torch.as_tensor(pts, device=pf.device), flut, res, ang_res, 3,
            100, 25,
        )
        trans = np.array([1.5, 0.0], np.float32)
        t0 = time.perf_counter()
        pf.propagate(trans, 0.0)
        pf.update(scan, res)
        if on_step is not None:
            on_step(i, pf)
        gt = gt + (rot2d(PSI_GT) @ trans) * SCALE_GT
        ml = pf.mean_likelihood()
        cov = pf.compute_mean_cov()
        err = float(np.linalg.norm(ml[:2] - (gt + frame_delta)))
        log(f"[drive] step {i:3d}  err {err:7.2f} px  cov_xx "
            f"{cov[0, 0]:9.1f}  wall {time.perf_counter() - t0:6.3f} s")
        return err, float(cov[0, 0])

    for i in range(steps):
        err, cov_xx = step(i)
    if swap_steps <= 0:
        return err, cov_xx, None
    ind = np.zeros(world.shape[1:], np.uint8)
    ind[world[1] == 0] = 1
    ind[world[2] == 0] = 2
    delta = np.array([24, 16])  # (dx, dy) px
    pf.update_map(np.roll(ind, (delta[1], delta[0]), (0, 1))[::-1], delta)
    frame_delta += delta.astype(np.float32)
    for i in range(swap_steps):
        err_swap, _ = step(steps + i)
    return err, cov_xx, err_swap


def drive_unknown_scale(device="cpu", particles=2048, steps=30, seed=0):
    """The unknown-scale drive; returns (mean_likelihood, mean_cov, the
    filter).  Each scan: propagate, update, then the node's scale-freeze
    trigger (cov[3, 3] < 0.003 * ml[3])."""
    pf, world = make_filter(
        device, particles, seed, fixed_scale=-1.0, init_pos_px_x=64.0,
        init_pos_px_y=104.0, init_pos_px_cov=10.0,
    )
    flut = np.arange(256, dtype=np.int32)
    gt = np.array(START, np.float32)
    trans = np.array([1.5, 0.0], np.float32)
    for i in range(steps):
        pts = generate_scan_points(
            world, gt, PSI_GT, SCALE_GT, 25.0, 8192, seed=i
        )
        scan = render_semantic_polar(
            torch.as_tensor(pts, device=pf.device), flut, 1.0,
            2 * math.pi / 100, 3, 100, 25,
        )
        pf.propagate(trans, 0.0)
        pf.update(scan, 1.0)
        gt = gt + (rot2d(PSI_GT) @ trans) * SCALE_GT
        ml, cov = pf.pose_stats()
        if cov[3, 3] < 0.003 * ml[3] and pf.scale() < 0:
            pf.freeze_scale()
    ml, cov = pf.pose_stats()
    return ml, cov, pf


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--particles", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--res", type=float, default=1.0)
    ap.add_argument("--swap", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    err, cov_xx, err_swap = drive(
        args.device, args.particles, args.steps, args.res, args.seed,
        args.swap,
    )
    ok = err < 8.0 and cov_xx < 400.0
    print(f"[drive] converged: err {err:.2f} px, cov_xx {cov_xx:.1f}")
    if err_swap is not None:
        ok = ok and err_swap < 10.0
        print(f"[drive] post-swap: err {err_swap:.2f} px")
    print(f"[drive] {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
