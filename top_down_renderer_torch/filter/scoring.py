"""Exact particle scoring (counterpart of filter/scoring.py).

For a particle with polar window (dist_c[t, r], known[t, r]) and a polar
scan (C, Th, R), the cost at rotation shift s is

  cost(s) = sum_c 0.01 * w_c * sum_{t,r} scan_c[(t+s) % Th, r] * dist_c[t, r]
  norm(s) = sum_{t,r} (sum_c scan_c)[(t+s) % Th, r] * known[t, r]

and cost(s) / norm(s) is NaN where the known fraction is < 0.5.  The
rotation axis is shared by every particle, so a rolled-scan circulant
turns all particles x all shifts into one matmul.

The shift tables follow the reference's compiled step exactly: there,
XLA turns `theta * Th / (2 pi)` into one multiply by the float32
constant Th * f32(1 / 2 pi), and folds the search grid k * (2 pi / n)
back to the exact rational k * Th / n, both rounded half to even.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def build_circulants(
    scan: torch.Tensor, class_weights: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cost_circ (Th*R*C, Th), norm_circ (Th*R, Th)) from a scan
    (C, Th, R): cost_circ[(t, r, c), s] = 0.01 w_c scan_c[(t+s) % Th, r]
    and norm_circ[(t, r), s] = (sum_c scan_c)[(t+s) % Th, r]."""
    th = scan.shape[1]
    return circulants_at_shifts(
        scan, class_weights, torch.arange(th, device=scan.device)
    )


def class_sum(scan: torch.Tensor) -> torch.Tensor:
    """(Th, R) sum over the scan's classes, added in class order as the
    reference's compiled reduction does (bit-equal norms)."""
    total = scan[0]
    for c in range(1, scan.shape[0]):
        total = total + scan[c]
    return total


def circulants_at_shifts(
    scan: torch.Tensor, class_weights: torch.Tensor, shifts: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Circulant columns at the given shifts only (each in [0, Th)):
    (cost_sel (Th*R*C, S), norm_sel (Th*R, S))."""
    c, th, r = scan.shape
    wscan = scan * (0.01 * class_weights)[:, None, None]
    idx = (
        torch.arange(th, device=scan.device)[:, None]
        + shifts.to(scan.device).long()[None, :]
    ) % th  # (Th, S)
    g = wscan[:, idx, :]  # (C, Th, S, R)
    cost_sel = g.permute(1, 3, 0, 2).reshape(th * r * c, -1)
    norm_sel = class_sum(scan)[idx, :].permute(0, 2, 1).reshape(th * r, -1)
    return cost_sel, norm_sel


def gather_windows(
    packed_map: torch.Tensor,
    num_classes: int,
    iy: torch.Tensor,
    ix: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-neighbour samples of the packed map at integer pixel
    coordinates (P, TR): (dists (P, TR*C), known (P, TR)), with dist 0 /
    known 0 outside the map."""
    h, w, c_pad = packed_map.shape
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    lin = torch.clamp(iy, 0, h - 1) * w + torch.clamp(ix, 0, w - 1)
    g = packed_map.reshape(h * w, c_pad)[lin.long()]  # (P, TR, C_pad)
    g = torch.where(valid[..., None], g, 0.0)
    p = iy.shape[0]
    return g[..., :num_classes].reshape(p, -1), g[..., num_classes]


def known_fraction(known: torch.Tensor) -> torch.Tensor:
    """Mean of `known` over its last axis, as the reference computes it:
    the count times the float32 reciprocal of the cell count."""
    inv = float(np.float32(1.0) / np.float32(known.shape[-1]))
    return known.sum(-1) * inv


def score_all_rotations(
    packed_map: torch.Tensor,
    stencil: torch.Tensor,
    scan: torch.Tensor,
    class_weights: torch.Tensor,
    center_px: torch.Tensor,
    scale: torch.Tensor,
    res,
    num_classes: int,
    map_resolution: float = 1.0,
    chunk_size: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every particle against every rotation shift.

    packed_map (H, W, C_pad); stencil (Th, R, 2) offsets (dy, dx) per
    unit of scale * res; center_px (N, 2) pixel pose (x, y); scale (N,);
    res the range resolution.  Returns (costs (N, Th), NaN where the
    known fraction is < 0.5; known_frac (N,)).  Samples are taken at
    round(center / map_resolution + offset * scale * res)."""
    th, r, _ = stencil.shape
    cost_circ, norm_circ = build_circulants(scan, class_weights)
    sten = stencil.reshape(th * r, 2)
    inv_mres = float(np.float32(1.0) / np.float32(map_resolution))
    f_all = scale * torch.as_tensor(
        res, dtype=torch.float32, device=scale.device
    )
    costs, kfs = [], []
    for lo in range(0, center_px.shape[0], chunk_size):
        ctr = center_px[lo : lo + chunk_size]
        f = f_all[lo : lo + chunk_size, None]
        iy = torch.round(sten[None, :, 0] * f + ctr[:, None, 1] * inv_mres)
        ix = torch.round(sten[None, :, 1] * f + ctr[:, None, 0] * inv_mres)
        dists, known = gather_windows(
            packed_map,
            num_classes,
            iy.clamp(-2**30, 2**30).to(torch.int64),
            ix.clamp(-2**30, 2**30).to(torch.int64),
        )
        c = (dists @ cost_circ) / (known @ norm_circ)
        kf = known_fraction(known)
        costs.append(torch.where(kf[:, None] < 0.5, torch.nan, c))
        kfs.append(kf)
    return torch.cat(costs), torch.cat(kfs)


def rotation_shift(theta: torch.Tensor, theta_bins: int) -> torch.Tensor:
    """Rotation -> row-shift count in [0, Th): round half to even of
    theta * f32(Th * f32(1 / 2 pi))."""
    inv_2pi = np.float32(1.0) / np.float32(2.0 * math.pi)
    c = float(np.float32(np.float32(theta_bins) * inv_2pi))
    s = torch.round(theta.to(torch.float32) * c).to(torch.int64)
    return torch.remainder(s, theta_bins)


def search_shifts(theta_bins: int, num_rot: int, device=None) -> torch.Tensor:
    """Row shifts of the uninitialised-theta search grid
    t_k = k * 2 pi / num_rot: round half to even of k * Th / num_rot,
    in float64, made on `device` (no copy from the host)."""
    k = torch.arange(num_rot, dtype=torch.float64, device=device)
    return torch.round(k * theta_bins / num_rot).to(torch.int64) % theta_bins


def shift_mask(
    shifts: torch.Tensor, alive: torch.Tensor, theta_bins: int
) -> torch.Tensor:
    """(theta_bins,) bool: shifts occupied by alive particles."""
    hits = torch.zeros(theta_bins + 1, dtype=torch.int32, device=shifts.device)
    idx = torch.where(alive, shifts.long(), theta_bins)
    hits.index_fill_(0, idx, 1)
    return hits[:theta_bins] > 0
