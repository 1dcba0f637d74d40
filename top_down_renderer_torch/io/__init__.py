"""Recorded drives and the replay harnesses (io/replay.py), and the
sensor point types (io/points.py)."""

from top_down_renderer_torch.io.replay import (
    Bag,
    benchmark_conv,
    benchmark_loc,
    gps_to_meters,
    integrate_gps_distance,
    replay,
)

__all__ = [
    "Bag",
    "benchmark_conv",
    "benchmark_loc",
    "gps_to_meters",
    "integrate_gps_distance",
    "replay",
]
