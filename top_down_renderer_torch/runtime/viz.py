"""Filter visualization (counterpart of runtime/viz.py, numpy only).

ParticleFilter::visualize (particle_filter.cpp:373-423): per-particle
heading arrows (particles out of the image clamped to its border as
green dots), GMM covariance ellipses at 2x the eigen axes with heading
arrows, and the max-likelihood arrow.  Drawn with cv2 when it imports,
else a numpy fallback marks the particle pixels only.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False


def draw_filter(
    img_rgb: np.ndarray,
    ml_states: np.ndarray,
    gmm_means: Optional[np.ndarray] = None,
    gmm_covs: Optional[np.ndarray] = None,
    ml_state: Optional[np.ndarray] = None,
    max_particles_drawn: int = 5000,
) -> np.ndarray:
    """img_rgb: (H, W, 3); ml_states: (N, >=3) x_px, y_px (y-up), theta.

    Returns the annotated image (image coords, y down)."""
    img = img_rgb.copy()
    h, w = img.shape[:2]
    if len(ml_states) > max_particles_drawn:
        ml_states = ml_states[
            :: len(ml_states) // max_particles_drawn + 1
        ]

    if not _HAS_CV2:
        xs = np.clip(ml_states[:, 0].astype(int), 0, w - 1)
        ys = np.clip(h - 1 - ml_states[:, 1].astype(int), 0, h - 1)
        img[ys, xs] = (255, 0, 0)
        return img

    red, blue, green = (255, 0, 0), (0, 0, 255), (0, 255, 0)
    for x, y, th in ml_states[:, :3]:
        px, py = float(x), float(h - y)
        if px < 0 or px > w or py < 0 or py > h:
            # out of bounds: green dot clamped to the border (:379-383)
            p = (
                int(np.clip(px, 5, w - 5)),
                int(np.clip(py, 5, h - 5)),
            )
            cv2.circle(img, p, 2, green, -1)
        else:
            d = (math.cos(th) * 5, -math.sin(th) * 5)
            cv2.arrowedLine(
                img,
                (int(px - d[0]), int(py - d[1])),
                (int(px + d[0]), int(py + d[1])),
                red,
                2,
                cv2.LINE_AA,
                0,
                0.3,
            )

    if gmm_means is not None and gmm_covs is not None:
        for mean, cov in zip(gmm_means, gmm_covs):
            pos_cov = cov[:2, :2]
            evals, evecs = np.linalg.eigh(pos_cov)
            if np.any(evals < 0):
                break  # :397 - we better be PSD
            maj = evecs[:, 0]
            angle = math.atan2(-maj[1], maj[0])
            center = (int(mean[0]), int(h - mean[1]))
            axes = (
                int(2 * math.sqrt(max(evals[0], 0))),
                int(2 * math.sqrt(max(evals[1], 0))),
            )
            cv2.ellipse(
                img, center, axes, math.degrees(angle), 0, 360,
                blue, 2,
            )
            d = (math.cos(mean[2]) * 5, -math.sin(mean[2]) * 5)
            cv2.arrowedLine(
                img,
                (int(center[0] - d[0]), int(center[1] - d[1])),
                (int(center[0] + d[0]), int(center[1] + d[1])),
                blue,
                2,
                cv2.LINE_AA,
                0,
                0.3,
            )

    if ml_state is not None:
        x, y, th = ml_state[:3]
        pt = (int(x), int(h - y))
        d = (math.cos(th) * 5, -math.sin(th) * 5)
        cv2.arrowedLine(
            img,
            (int(pt[0] - d[0]), int(pt[1] - d[1])),
            (int(pt[0] + d[0]), int(pt[1] + d[1])),
            blue,
            2,
            cv2.LINE_AA,
            0,
            0.3,
        )
    return img


def draw_gt_arrow(img_rgb: np.ndarray, gt_pose: np.ndarray,
                  map_center: np.ndarray) -> np.ndarray:
    """Ground-truth pose arrow (updateFilter, top_down_render.cpp:433-439)."""
    img = img_rgb
    if not _HAS_CV2:
        return img
    front = gt_pose[:2, :2] @ np.array([2.0, 0.0])
    rot = (front[0], -front[1])
    pos = (gt_pose[0, 2], -gt_pose[1, 2])
    c = (int(map_center[0] + pos[0]), int(map_center[1] + pos[1]))
    cv2.arrowedLine(
        img,
        (int(c[0] - rot[0]), int(c[1] - rot[1])),
        (int(c[0] + rot[0]), int(c[1] + rot[1])),
        (0, 255, 0),
        2,
        cv2.LINE_AA,
        0,
        0.3,
    )
    return img
