"""Survey preprocessing: a recording -> photogrammetry (OpenDroneMap)
inputs (the counterpart of scripts/preproc_survey.py, numpy only).

    python -m top_down_renderer_torch.tools.preproc_survey \\
        --frames frames_dir --gps gps.csv --out out_dir \\
        [--min-alt 20] [--min-spacing 5]

Keeps the GPS fixes at or above --min-alt, then each <stamp>.jpg frame of
--frames (in name order) whose nearest fix lies within 0.5 s and at least
--min-spacing metres (equirectangular, from the first kept fix) from the
last kept frame's; copies the kept frames to out_dir/images and writes
out_dir/geo.txt (EPSG:4326: name, lon, lat, alt).  gps.csv rows are
stamp, lat, lon, alt; blank lines and lines starting with # are skipped.
"""

from __future__ import annotations

import argparse
import csv
import os
import shutil
import sys
from typing import List, Optional

import numpy as np

EARTH_RADIUS_M = 6371e3
MAX_STAMP_GAP_S = 0.5  # a frame's nearest fix must lie this close


def load_gps_csv(path: str) -> np.ndarray:
    """(N, 4) float64: stamp, lat, lon, alt."""
    rows = []
    with open(path) as f:
        for r in csv.reader(f):
            if not r or r[0].startswith("#"):
                continue
            rows.append([float(v) for v in r[:4]])
    return np.asarray(rows)


def equirect_xy(latlon: np.ndarray, origin) -> np.ndarray:
    """(N, 2) metres east and north of origin (lat, lon)."""
    lat0 = np.radians(origin[0])
    return np.stack(
        [
            np.radians(latlon[:, 1] - origin[1]) * np.cos(lat0)
            * EARTH_RADIUS_M,
            np.radians(latlon[:, 0] - origin[0]) * EARTH_RADIUS_M,
        ],
        axis=-1,
    )


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", required=True,
                    help="dir of <stamp>.jpg frames")
    ap.add_argument("--gps", required=True, help="gps.csv")
    ap.add_argument("--out", required=True)
    ap.add_argument("--min-alt", type=float, default=20.0,
                    help="keep fixes at or above this altitude")
    ap.add_argument("--min-spacing", type=float, default=5.0,
                    help="min distance between kept frames (m)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    gps = load_gps_csv(args.gps)
    gps = gps[gps[:, 3] >= args.min_alt] if len(gps) else gps
    if len(gps) == 0:
        print("no GPS fixes above altitude filter", file=sys.stderr)
        return 1
    xy = equirect_xy(gps[:, 1:3], gps[0, 1:3])

    os.makedirs(os.path.join(args.out, "images"), exist_ok=True)
    geo_lines = ["EPSG:4326"]
    last_xy = None
    kept = 0
    frames = sorted(
        f for f in os.listdir(args.frames) if f.lower().endswith(".jpg")
    )
    for fname in frames:
        stamp = float(os.path.splitext(fname)[0])
        i = int(np.argmin(np.abs(gps[:, 0] - stamp)))
        if abs(gps[i, 0] - stamp) > MAX_STAMP_GAP_S:
            continue
        if last_xy is not None and np.linalg.norm(
            xy[i] - last_xy
        ) < args.min_spacing:
            continue
        last_xy = xy[i]
        shutil.copy(
            os.path.join(args.frames, fname),
            os.path.join(args.out, "images", fname),
        )
        geo_lines.append(
            f"{fname} {gps[i, 2]:.8f} {gps[i, 1]:.8f} {gps[i, 3]:.2f}"
        )
        kept += 1

    with open(os.path.join(args.out, "geo.txt"), "w") as f:
        f.write("\n".join(geo_lines) + "\n")
    print(f"kept {kept} frames -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
