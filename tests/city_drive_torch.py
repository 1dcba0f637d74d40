"""The city drive of benchmarks/city_bag.py through the port's node.

The world, the drive and the scans come from city_bag.py's numpy
functions (make_city, make_drive, scan_at; seed 0, realism off, 900
steps of 8 m/s x 0.2 s at 2 px/m on a 1536^2 map, as its main() makes
them): the odometry priors, the GPS and then the scans are drawn in
make_bag's order from one generator, and packed into the port's Bag.
city_bag.make_bag itself imports the reference package, which this
module never does.  The node is benchmarks/bench_loc.py's: its class
config, map config and filter overrides, with RuntimeParams(
use_motion_prior=True).

The published poses are compared with the true trajectory: the node
publishes (ml - map_center) / scale in metres, and with the default
svg origin that is the map-pixel pose over 2 px/m, the frame of
traj_px / 2.

    python tests/city_drive_torch.py [--device cpu] [--particles N]
        [--scans N] [--window PX] [--unknown-scale]

replays the first N scans and prints the mean error of the published
poses against the true trajectory, the first converged scan and the
per-scan times, with the device they ran on.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import struct
import sys
import time
import zlib

_here = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(_here)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))

import numpy as np  # noqa: E402

import city_bag  # noqa: E402
from top_down_renderer_torch import (  # noqa: E402
    Bag,
    ClassConfig,
    MapConfig,
    RuntimeParams,
    TopDownRenderNode,
    replay,
)
from top_down_renderer_torch.io.replay import EARTH_R  # noqa: E402

HW = 1536
STEPS = 900
DT = 0.2
SPEED = 8.0  # m/s
SCALE = 2.0  # px/m
PNG = os.path.join(ROOT, "benchmarks", "data", "city.png")
# benchmarks/bench_loc.py's filter overrides
OVERRIDES = dict(regularization=0.02, pos_cov=0.1, force_on_map=True)


def class_config() -> ClassConfig:
    """bench_loc.py's six-class config (terrain, road, building,
    vegetation, water, parking)."""
    color_lut = np.full((256, 3), 255, np.uint8)
    for i, col in enumerate(city_bag.CLASS_COLORS):
        color_lut[i] = col
    n = len(city_bag.CLASS_NAMES)
    return ClassConfig(
        color_lut=color_lut,
        class_to_flattened=list(range(n)),
        flattened_to_class=list(range(n)),
        exclusivity=[True] * n,
        loc_weight=[0.1, 1.0, 2.5, 1.5, 2.0, 2.0],
    )


def city_world(seed: int = 0):
    """(class maps (6, H, W), traj_px (STEPS, 2), psi (STEPS,))."""
    maps, ys, xs = city_bag.make_city(HW, HW, seed)
    traj, psi = city_bag.make_drive(ys, xs, STEPS, SPEED * DT * SCALE, seed)
    return maps, traj, psi


def make_bag(maps, traj_px, psi, n_scans: int, seed: int = 0,
             odom_pos_noise=0.03, odom_yaw_noise=0.002, gps_noise_m=2.0,
             origin_latlon=(39.95, -75.16), max_range_m=50.0,
             n_pad=8192) -> Bag:
    """city_bag.make_bag's draws for the whole trajectory (priors, then
    GPS, then the scans in order), keeping its first n_scans steps."""
    rng = np.random.default_rng(seed + 1)
    t = np.arange(len(traj_px)) * DT
    world_m = traj_px / SCALE
    prior = np.zeros((len(t), 3))
    prior_psi = np.zeros(len(t))
    acc = np.zeros(2)
    acc_psi = 0.0
    for i in range(len(t)):
        if i:
            acc += (world_m[i] - world_m[i - 1]) + (
                rng.standard_normal(2) * odom_pos_noise)
            acc_psi += (psi[i] - psi[i - 1]) + (
                rng.standard_normal() * odom_yaw_noise)
        prior[i, :2] = acc
        prior_psi[i] = psi[0] + acc_psi
    quat = np.stack([np.zeros(len(t)), np.zeros(len(t)),
                     np.sin(prior_psi / 2), np.cos(prior_psi / 2)], axis=1)
    gps_m = world_m + rng.standard_normal(world_m.shape) * gps_noise_m
    lat0, lon0 = origin_latlon
    lat = lat0 + np.degrees(gps_m[:, 1] / EARTH_R)
    lon = lon0 + np.degrees(
        gps_m[:, 0] / (EARTH_R * math.cos(math.radians(lat0))))
    scans = [city_bag.scan_at(maps, traj_px[i], psi[i], SCALE, max_range_m,
                              n_pad, rng) for i in range(n_scans)]
    k = slice(0, n_scans)
    return Bag(
        scan_stamps=t[k],
        scan_points=np.concatenate(scans),
        scan_offsets=np.arange(n_scans + 1) * n_pad,
        prior_stamps=t[k],
        prior_pos=prior[k],
        prior_quat=quat[k],
        gps_stamps=t[k],
        gps_latlon=np.stack([lat, lon], axis=1)[k],
    )


def crop(maps, traj_px, scans: slice, window: int):
    """A window x window crop of the world around the positions of
    `scans`, and the trajectory in its pixels."""
    lo = np.floor(traj_px[scans].min(0)).astype(int)
    hi = np.ceil(traj_px[scans].max(0)).astype(int)
    x0, y0 = np.clip((lo + hi) // 2 - window // 2, 0, HW - window)
    return (np.ascontiguousarray(maps[:, y0:y0 + window, x0:x0 + window]),
            traj_px - np.array([x0, y0], np.float64))


def write_world_png(maps, path: str) -> None:
    """The world as city_bag.save_world_png draws it (class colours in its
    back-to-front order, image rows top-down), written without PIL: an
    8-bit RGB PNG, every scanline unfiltered."""
    h, w = maps.shape[1:]
    img = np.zeros((h, w, 3), np.uint8)
    img[...] = city_bag.CLASS_COLORS[0]
    for cls in (0, 3, 4, 5, 2, 1):
        img[maps[cls, ::-1] == 0] = city_bag.CLASS_COLORS[cls]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 3)], 1)

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + chunk(b"IEND", b""))


def make_node(png=PNG, particles=2048, device=None, seed=0,
              unknown_scale=False, init=None, **runtime) -> TopDownRenderNode:
    """The node on the world's PNG; `init` adds filter overrides (an
    initial pose prior)."""
    overrides = dict(OVERRIDES, **(init or {}))
    if unknown_scale:
        overrides["fixed_scale"] = -1.0
    return TopDownRenderNode(
        class_config(), MapConfig(raster_path=png, resolution=SCALE),
        RuntimeParams(particle_count=particles, use_motion_prior=True,
                      **runtime),
        filter_overrides=overrides, seed=seed, device=device,
    )


def pose_errors(node, poses, traj_px) -> np.ndarray:
    """Each published pose's distance (m) from the true position at its
    scan, in the node's map frame: x from map_center[0], y from the map
    height less map_center[1] (publishPoseEst's frame)."""
    if not poses:
        return np.zeros(0)
    i = np.rint(np.array([p.stamp for p in poses]) / DT).astype(int)
    est = np.array([p.position[:2] for p in poses])
    img_h = (node.background_img.shape[0] if node.background_img is not None
             else node.map.size()[1])
    origin = np.array([node.map_center[0], img_h - node.map_center[1]])
    return np.linalg.norm(est - (traj_px[i] - origin) / SCALE, axis=1)


def run(node, bag, traj_px, on_scan=None, **replay_kw):
    """replay() with each scan's node timings; returns (record, errors of
    the published poses in m, per-scan timing dicts)."""
    times = []
    orig = node.take_step

    def timed(stamp, points, prior):
        orig(stamp, points, prior)
        times.append(dict(node.timing))
        if on_scan is not None:
            on_scan(node)

    node.take_step = timed
    try:
        rec = replay(node, bag, **replay_kw)
    finally:
        node.take_step = orig
    return rec, pose_errors(node, rec["poses"], traj_px), times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--particles", type=int, default=102_400)
    ap.add_argument("--scans", type=int, default=300)
    ap.add_argument("--window", type=int, default=0,
                    help="crop the world to this many px around the drive "
                    "(0: the whole map, loaded from benchmarks/data/city.png)")
    ap.add_argument("--unknown-scale", action="store_true")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    import torch

    torch.set_num_threads(args.threads)
    maps, traj, psi = city_world()
    png = PNG
    if args.window:
        import tempfile

        maps, traj = crop(maps, traj, slice(0, args.scans), args.window)
        png = os.path.join(tempfile.mkdtemp(), "city_window.png")
        write_world_png(maps, png)
    bag = make_bag(maps, traj, psi, args.scans)
    t0 = time.perf_counter()
    node = make_node(png, args.particles, args.device,
                     unknown_scale=args.unknown_scale)
    rec, errs, times = run(node, bag, traj)
    wall = time.perf_counter() - t0
    device = (torch.cuda.get_device_name(0) if node.device.type == "cuda"
              else "cpu")
    first = rec["first_converged_stamp"]
    out = {
        "device": device,
        "particles": node.filter.n_max,
        "scans": rec["n_scans"],
        "window": args.window,
        "unknown_scale": args.unknown_scale,
        "first_converged_scan": (None if first is None
                                 else int(round(first / DT))),
        "poses": len(rec["poses"]),
        "mean_error_m": float(errs.mean()) if errs.size else None,
        "max_error_m": float(errs.max()) if errs.size else None,
        "final_scale": rec["final_scale"],
        "median_ms": {k: float(np.median([t[k] for t in times]))
                      for k in ("render_ms", "filter_ms", "publish_ms")},
        "wall_s": wall,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
