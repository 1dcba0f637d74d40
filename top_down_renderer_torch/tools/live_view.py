"""Live or offline view of a replay through the port's node (the
counterpart of scripts/live_view.py, the reference's matplotlib viewer):
for each step of a bag replay, the scan's argmax semantic image and the
particle overlay on the map.

    python -m top_down_renderer_torch.tools.live_view --bag bag.npz \\
        --map world.png --classes classes.yaml --scale 2.0 \\
        [--out frames_dir] [--particles 4096] [--device cuda]

With --out each map update writes frames_dir/frame_NNNNN.png (the port's
PNG writer; no matplotlib or Pillow): the scan image on the left and the
overlay on the right, flipped upside down as the reference viewer shows
it, both from the top edge on black (side_by_side).  Without --out the
frames go to a matplotlib window, and matplotlib must be importable: the
viewer raises where it is not.  The node runs on the card unless --device
says otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bag", required=True)
    ap.add_argument("--map", required=True, help="color raster map png")
    ap.add_argument("--classes", required=True, help="classes yaml")
    ap.add_argument("--scale", type=float, required=True, help="px/m")
    ap.add_argument("--out", default="", help="save frames instead of UI")
    ap.add_argument("--particles", type=int, default=4096)
    ap.add_argument("--device", default=None,
                    help="the node's device (the card by default)")
    return ap.parse_args(argv)


def side_by_side(scan_img: Optional[np.ndarray],
                 map_img: np.ndarray) -> np.ndarray:
    """(H, W1 + W2, 3) uint8: the scan image (none before the first scan)
    and the map overlay flipped upside down, from the top edge on black."""
    right = map_img[::-1]
    left = (np.zeros((0, 0, 3), np.uint8) if scan_img is None
            else scan_img)
    h = max(left.shape[0], right.shape[0])
    out = np.zeros((h, left.shape[1] + right.shape[1], 3), np.uint8)
    out[: left.shape[0], : left.shape[1]] = left
    out[: right.shape[0], left.shape[1]:] = right
    return out


def build_node(args: argparse.Namespace):
    """The node of the reference viewer: the map from --map (also its
    background), particles and the motion prior as there."""
    from top_down_renderer_torch.config import (
        ClassConfig,
        MapConfig,
        RuntimeParams,
    )
    from top_down_renderer_torch.maps.png import read_png_rgb
    from top_down_renderer_torch.runtime.node import TopDownRenderNode

    cc = ClassConfig.from_yaml(args.classes)
    mc = MapConfig(raster_path=args.map, viz_path=args.map,
                   resolution=args.scale)
    node = TopDownRenderNode(
        cc, mc, RuntimeParams(particle_count=args.particles,
                              use_motion_prior=True),
        device=args.device,
    )
    node.background_img = read_png_rgb(args.map)
    return node


def _window():
    """A matplotlib figure of two panels; raises where matplotlib is
    absent rather than falling back to frames."""
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise RuntimeError(
            "live_view without --out draws with matplotlib, which is not "
            "installed; pass --out DIR to write the frames as PNG files"
        ) from e
    fig, axes = plt.subplots(1, 2, figsize=(12, 6))
    return plt, axes


def run(node, args: argparse.Namespace) -> int:
    """Replay --bag through node, one frame a map update; returns the
    number of frames."""
    from top_down_renderer_torch.io import Bag, replay
    from top_down_renderer_torch.maps.png import write_png

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    else:
        plt, axes = _window()
    last = {"scan": None, "frames": 0}

    def on_scan(img):
        last["scan"] = img
        if not args.out:
            axes[0].clear()
            axes[0].imshow(img)
            axes[0].set_title("polar scan (argmax)")

    def on_map(img):
        if img is None:
            return
        if args.out:
            write_png(os.path.join(args.out,
                                   f"frame_{last['frames']:05d}.png"),
                      side_by_side(last["scan"], img))
        else:
            axes[1].clear()
            axes[1].imshow(img[::-1])
            axes[1].set_title(f"particles (n={node.filter.num_particles()})")
            plt.pause(0.01)
        last["frames"] += 1

    node.on("scan", on_scan)
    node.on("map_viz", on_map)
    replay(node, Bag.load(args.bag))
    return last["frames"]


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    frames = run(build_node(args), args)
    print("done;", frames, "frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
