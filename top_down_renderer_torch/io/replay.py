"""Recorded-sequence replay and the closed-loop benchmark harnesses
(counterpart of io/replay.py).

The reference's operator scripts: benchmark_loc.py (replay a recording,
compare the published pose_est with GPS after the first convergence,
repeat N runs, :43-96), benchmark_conv.py (sweep start offsets and stop
200 poses after convergence: time and distance to converge, :52-83) and
get_dist.py (GPS path length over the first 70 s, :59-71).

The transport is an npz "bag" instead of ROS: scans are a ragged point
store (points + offsets), priors and GPS timestamped arrays.  Its layout
is the reference package's, so a bag saved by either package loads in
the other.  The node under test is the port's TopDownRenderNode.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from top_down_renderer_torch.runtime.node import (
    PoseStamped,
    TopDownRenderNode,
)

EARTH_R = 6371e3


@dataclasses.dataclass
class Bag:
    """A recorded drive: semantic scans + motion priors + optional GPS."""

    scan_stamps: np.ndarray  # (T,)
    scan_points: np.ndarray  # (total, 4) x y z class
    scan_offsets: np.ndarray  # (T+1,)
    prior_stamps: np.ndarray  # (Tp,)
    prior_pos: np.ndarray  # (Tp, 3)
    prior_quat: np.ndarray  # (Tp, 4) x y z w
    gps_stamps: Optional[np.ndarray] = None  # (Tg,)
    gps_latlon: Optional[np.ndarray] = None  # (Tg, 2) deg

    def scan(self, i: int) -> np.ndarray:
        return self.scan_points[
            self.scan_offsets[i] : self.scan_offsets[i + 1]
        ]

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            **{
                f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None
            },
        )

    @staticmethod
    def load(path: str) -> "Bag":
        data = np.load(path)
        kw = {k: data[k] for k in data.files}
        return Bag(**kw)


def gps_to_meters(
    latlon: np.ndarray, origin: Optional[np.ndarray] = None
) -> np.ndarray:
    """Equirectangular lat/lon -> local meters (the small-area scaling the
    reference harness applies, benchmark_loc.py:20-33)."""
    latlon = np.asarray(latlon, np.float64)
    if origin is None:
        origin = latlon[0]
    lat0 = math.radians(float(origin[0]))
    dlat = np.radians(latlon[:, 0] - origin[0])
    dlon = np.radians(latlon[:, 1] - origin[1])
    return np.stack(
        [dlon * math.cos(lat0) * EARTH_R, dlat * EARTH_R], axis=-1
    )


def integrate_gps_distance(
    bag: Bag, t_start: float, duration: float = 70.0
) -> float:
    """GPS path length over [t_start, t_start+duration]
    (get_dist.py:59-71)."""
    if bag.gps_stamps is None:
        return 0.0
    sel = (bag.gps_stamps >= t_start) & (
        bag.gps_stamps <= t_start + duration
    )
    xy = gps_to_meters(bag.gps_latlon)[sel]
    if len(xy) < 2:
        return 0.0
    return float(np.sum(np.linalg.norm(np.diff(xy, axis=0), axis=1)))


def replay(
    node: TopDownRenderNode,
    bag: Bag,
    start_offset: float = 0.0,
    stop_after_converged_poses: Optional[int] = None,
    max_scans: Optional[int] = None,
) -> Dict:
    """Drive the node through the bag.  Returns the run record:
    pose_est list, convergence stamp, per-step timing."""
    poses: List = []
    node.on("pose_est", poses.append)
    scales: List = []  # published scale estimates (unknown-scale runs)
    node.on("scale", scales.append)

    t0 = float(bag.scan_stamps[0]) + start_offset
    first_converged: Optional[float] = None
    n_scans = 0
    pi = 0
    for i in range(len(bag.scan_stamps)):
        stamp = float(bag.scan_stamps[i])
        if stamp < t0:
            continue
        # deliver priors up to this stamp in arrival order
        while (
            pi < len(bag.prior_stamps)
            and bag.prior_stamps[pi] <= stamp
        ):
            node.motion_prior_callback(
                PoseStamped(
                    stamp=float(bag.prior_stamps[pi]),
                    position=bag.prior_pos[pi],
                    orientation=bag.prior_quat[pi],
                )
            )
            pi += 1
        node.pc_callback(stamp, bag.scan(i))
        n_scans += 1
        if node.is_converged and first_converged is None:
            first_converged = stamp
        if (
            stop_after_converged_poses is not None
            and first_converged is not None
            and len(poses) >= stop_after_converged_poses
        ):
            break
        if max_scans is not None and n_scans >= max_scans:
            break
    return {
        "poses": poses,
        "scales": scales,
        "final_scale": float(node.filter.scale()),
        "first_converged_stamp": first_converged,
        "n_scans": n_scans,
        "start_stamp": t0,
    }


def _interp_gps(bag: Bag, stamps: np.ndarray) -> np.ndarray:
    xy = gps_to_meters(bag.gps_latlon)
    return np.stack(
        [
            np.interp(stamps, bag.gps_stamps, xy[:, 0]),
            np.interp(stamps, bag.gps_stamps, xy[:, 1]),
        ],
        axis=-1,
    )


def benchmark_loc(
    make_node, bag: Bag, runs: int = 5, verbose: bool = False,
    **replay_kw
) -> Dict:
    """Localization-accuracy benchmark (benchmark_loc.py:43-96): repeat
    runs, compare post-convergence pose_est to interpolated GPS.
    make_node: factory returning a fresh TopDownRenderNode per run."""
    import time as _time

    all_runs = []
    for r in range(runs):
        node = make_node(r)
        _t0 = _time.perf_counter()
        rec = replay(node, bag, **replay_kw)
        if verbose:
            print(
                f"[benchmark_loc] run {r}: {rec['n_scans']} scans in "
                f"{_time.perf_counter() - _t0:.0f}s, converged at "
                f"{rec['first_converged_stamp']}", flush=True,
            )
        errs = []
        if bag.gps_stamps is not None and rec["poses"]:
            stamps = np.array([p.stamp for p in rec["poses"]])
            est = np.array([p.position[:2] for p in rec["poses"]])
            gps = _interp_gps(bag, stamps)
            gps = gps - gps[0] + est[0]  # align first published pose
            errs = np.linalg.norm(est - gps, axis=1)
        all_runs.append({**rec, "errors": np.asarray(errs)})
    cat = np.concatenate(
        [r["errors"] for r in all_runs if len(r["errors"])]
        or [np.zeros(0)]
    )
    return {
        "runs": all_runs,
        "mean_error_m": float(cat.mean()) if cat.size else float("nan"),
        "median_error_m": (
            float(np.median(cat)) if cat.size else float("nan")
        ),
    }


def benchmark_conv(
    make_node,
    bag: Bag,
    offsets=None,
    poses_after: int = 200,
    max_scans: Optional[int] = None,
    verbose: bool = False,
) -> Dict:
    """Convergence benchmark (benchmark_conv.py:52-83): sweep start
    offsets, measure time + GPS distance until first convergence."""
    import time as _time

    if offsets is None:
        span = float(bag.scan_stamps[-1] - bag.scan_stamps[0])
        offsets = np.arange(0.0, max(span - 30.0, 1.0), 30.0)
    results = []
    for k, off in enumerate(offsets):
        node = make_node(k)
        _t0 = _time.perf_counter()
        rec = replay(
            node,
            bag,
            start_offset=float(off),
            stop_after_converged_poses=poses_after,
            max_scans=max_scans,
        )
        if verbose:
            print(
                f"[benchmark_conv] offset {off}: {rec['n_scans']} scans "
                f"in {_time.perf_counter() - _t0:.0f}s, converged at "
                f"{rec['first_converged_stamp']}", flush=True,
            )
        conv_t = rec["first_converged_stamp"]
        entry = {
            "offset": float(off),
            "converged": conv_t is not None,
            "time_to_converge_s": (
                conv_t - rec["start_stamp"] if conv_t is not None else None
            ),
            "dist_to_converge_m": (
                integrate_gps_distance(
                    bag, rec["start_stamp"],
                    conv_t - rec["start_stamp"],
                )
                if conv_t is not None
                else None
            ),
        }
        results.append(entry)
    times = [
        r["time_to_converge_s"] for r in results if r["converged"]
    ]
    return {
        "sweeps": results,
        "convergence_rate": (
            sum(r["converged"] for r in results) / max(len(results), 1)
        ),
        "mean_time_to_converge_s": (
            float(np.mean(times)) if times else float("nan")
        ),
    }
