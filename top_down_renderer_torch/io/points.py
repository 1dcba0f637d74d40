"""Sensor point types (counterpart of io/points.py, numpy only).

The reference's PCL point registrations (point_os1.h,
point_xyz_class_normal.h) as numpy structured dtypes, and converters to
the package's (P, 4) float32 [x, y, z, class] array (the class rides in
the intensity field, scan_renderer.cpp:72).
"""

from __future__ import annotations

import numpy as np

# Ouster OS1 point layout (point_os1.h:6-33)
POINT_OS1_DTYPE = np.dtype(
    {
        "names": [
            "x", "y", "z", "intensity", "t", "reflectivity",
            "ring", "noise", "range",
        ],
        "formats": [
            "<f4", "<f4", "<f4", "<f4", "<u4", "<u2", "<u1", "<u2",
            "<u4",
        ],
        "offsets": [0, 4, 8, 16, 20, 24, 26, 28, 32],
        "itemsize": 48,
    }
)

# XYZ + packed RGB class + normal (point_xyz_class_normal.h:6-23)
POINT_XYZ_CLASS_NORMAL_DTYPE = np.dtype(
    {
        "names": ["x", "y", "z", "rgb", "normal_x", "normal_y",
                  "normal_z"],
        "formats": ["<f4"] * 3 + ["<f4"] + ["<f4"] * 3,
        "offsets": [0, 4, 8, 16, 32, 36, 40],
        "itemsize": 48,
    }
)

# plain PointXYZI (the live subscriber's type, top_down_render.h PointType)
POINT_XYZI_DTYPE = np.dtype(
    {
        "names": ["x", "y", "z", "intensity"],
        "formats": ["<f4"] * 4,
        "offsets": [0, 4, 8, 16],
        "itemsize": 32,
    }
)


def structured_to_xyzc(
    cloud: np.ndarray, class_field: str = "intensity"
) -> np.ndarray:
    """Structured cloud -> (P, 4) float32 [x, y, z, class]."""
    out = np.zeros((cloud.size, 4), np.float32)
    flat = cloud.reshape(-1)
    out[:, 0] = flat["x"]
    out[:, 1] = flat["y"]
    out[:, 2] = flat["z"]
    out[:, 3] = flat[class_field]
    return out


def pad_points(points: np.ndarray, n_pad: int) -> np.ndarray:
    """Pad/truncate to a static shape; zeros are the renderer's invalid
    sentinel (x==0 && y==0)."""
    out = np.zeros((n_pad, 4), np.float32)
    n = min(len(points), n_pad)
    out[:n] = points[:n]
    return out
