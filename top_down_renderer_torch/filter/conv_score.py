"""Convolutional grid scoring: the clustered-particle fast path
(counterpart of filter/conv_score.py).

After convergence the cloud occupies a small region of the map.  There,
evaluating the cost at every integer centre of the region is cheaper than
per-particle work: the stencil folded through the circulant columns of the
scan is a convolution kernel K, and

    field[s, y, x] = sum_{c, dy, dx} K[s, c, dy, dx] * map[c, y + dy, x + dx]

is one convolution over the region (output channels: the costs at the
shifts, their norms, the known count).  Each particle then reads its row
of the field at its rounded centre.  The samples are those of the crop
path: nearest neighbour at round(centre / map_resolution) +
round(offset * f).

The reference runs this on XLA (conv_general_dilated, or an im2col
matmul), not in a Pallas kernel, so the port runs it on cuDNN through
torch.nn.functional.conv2d.  Its arithmetic follows the reference's:
both operands rounded to bf16, products and sums in float32.  The map is
the compact one (the C + 1 channels the score reads, crop_score.
compact_map) with a MAP_PAD border of zeros, rounded to bf16 and kept
in float32; the kernel's taps are bf16 values kept in float32.  The
convolution runs in float32 with TF32 off, so each product of two bf16
values is exact and only the order of the float32 sums differs from the
reference's.  A bf16 convolution would round every output to 8 bits.

CALLS counts the cost fields computed ("cost_field"): the path launches
no kernel of this package, so kernels.LAUNCHES does not see it.

Only the direct formulation is ported: the reference's space-to-depth
fold, its kf split and its int8 variant exist for the TPU's 128-lane
tiling (ROADMAP, "Not to port").
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from top_down_renderer_torch.filter.crop_score import channel_pad, crop_offsets
from top_down_renderer_torch.filter.scoring import (
    circulants_at_shifts,
    rotation_shift,
    search_shifts,
)

# output-region buckets (cost-field height and width in px)
REGION_BUCKETS = (64, 128, 192, 256)
MAP_PAD = 64  # the reference's zero border around the map (MAP_PAD)

CALLS = {"cost_field": 0}


def conv_dims(mo: int):
    """Kernel extent (rows, cols) for max stencil offset mo: the conv
    slides at 1 px, so it needs no alignment margin."""
    d = 2 * mo + 2
    return d, d


def pick_region(extent: int) -> int | None:
    """The smallest region bucket covering `extent` px, or None."""
    for b in REGION_BUCKETS:
        if extent <= b:
            return b
    return None


def _windowed_cost_norm(scan, class_weights, s0, ww):
    """Cost and norm circulant columns (Th*R*C, ww), (Th*R, ww) of the
    consecutive circular shift window [s0, s0 + ww)."""
    th = scan.shape[1]
    shifts = (s0 + torch.arange(ww, device=scan.device)) % th
    return circulants_at_shifts(scan, class_weights, shifts)


def _searched_cost_norm(scan, class_weights, num_rot):
    """Cost and norm circulant columns at the num_rot search shifts
    (scoring.search_shifts: the compiled reference step's tie rounding)."""
    th = scan.shape[1]
    return circulants_at_shifts(
        scan, class_weights, search_shifts(th, num_rot, scan.device)
    )


def build_conv_kernel(
    scan: torch.Tensor,
    class_weights: torch.Tensor,
    stencil: torch.Tensor,
    f,
    mo: int,
    mode: str,
    num_rot: int = 40,
    window_w: int = 100,
    s0=0,
) -> torch.Tensor:
    """(S_out, CP, dr, dc) float32 conv kernel (OIHW) of bf16 values.

    tracked: the circular shift window [s0, s0 + window_w), S_out =
      2 window_w + 1: [0, W) costs | [W, 2W) norms | [2W] kf count.
    init: the num_rot search shifts, S_out = 2 num_rot + 1, alike.
    Channels < C carry the cost columns, channel C (the known indicator)
    the norms and the count.  Each stencil cell's coefficients are rounded
    to bf16 and added onto its tap (round(offset * f) + the kernel's
    centre) in float64, an order-free and exact sum, then rounded to bf16:
    the reference's one-hot product, whose float32 sums of a few bf16
    values are exact too."""
    c, th, r = scan.shape
    tr = th * r
    cp = channel_pad(c)
    dr, dc = conv_dims(mo)
    off = crop_offsets(stencil, f).long()
    tap = (off[:, 0] + dr // 2) * dc + (off[:, 1] + dc // 2)
    if mode == "tracked":
        cost, norm = _windowed_cost_norm(scan, class_weights, s0, window_w)
    else:
        cost, norm = _searched_cost_norm(scan, class_weights, num_rot)
    n = cost.shape[1]
    s_out = 2 * n + 1
    feat = torch.cat([cost.reshape(tr, c * n), norm,
                      torch.ones((tr, 1), device=scan.device)], 1)
    acc = torch.zeros((dr * dc, feat.shape[1]), dtype=torch.float64,
                      device=scan.device)
    acc.index_add_(0, tap, feat.to(torch.bfloat16).double())
    k = torch.zeros((dr * dc, cp, s_out), dtype=torch.float32,
                    device=scan.device)
    k[:, :c, :n] = acc[:, : c * n].view(-1, c, n)
    k[:, c, n : 2 * n] = acc[:, c * n : c * n + n]
    k[:, c, 2 * n] = acc[:, -1]
    k = k.to(torch.bfloat16).to(torch.float32)
    return k.permute(2, 1, 0).reshape(s_out, cp, dr, dc).contiguous()


class ConvMap:
    """The conv path's map operand: the compact map (H, W, CP)
    (crop_score.compact_map) with a border of `pad` zeros, rounded to bf16
    and kept in float32, laid out (1, CP, hp, wp).  hp = H + 2 pad and
    wp = W + 2 pad, as the reference's padded map."""

    def __init__(self, compact: torch.Tensor, pad: int = MAP_PAD):
        h, w = compact.shape[:2]
        self.padded = F.pad(
            compact.permute(2, 0, 1), (pad, pad, pad, pad)
        ).to(torch.bfloat16).to(torch.float32)[None].contiguous()
        self.hp, self.wp, self.pad = h + 2 * pad, w + 2 * pad, pad


def cost_field(
    padded: torch.Tensor,
    kernel: torch.Tensor,
    origin_yx: torch.Tensor,
    mo: int,
    region: int,
) -> torch.Tensor:
    """The cost field over a (region, region) block of centres whose
    top-left centre is origin_yx (padded coordinates, a (2,) integer
    tensor: the block is cut on the device, with no host read).  Returns
    (S_out, region, region) float32: field[:, y, x] belongs to the centre
    at padded (origin_y + y, origin_x + x).  cuDNN runs it in float32,
    TF32 off, with a deterministic algorithm."""
    dr, dc = conv_dims(mo)
    dev = padded.device
    rows = origin_yx[0] - dr // 2 + torch.arange(region + dr - 1, device=dev)
    cols = origin_yx[1] - dc // 2 + torch.arange(region + dc - 1, device=dev)
    block = padded.index_select(2, rows).index_select(3, cols)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        out = F.conv2d(block, kernel)
    CALLS["cost_field"] += 1
    return out[0]


def make_conv_scorer(
    mo: int,
    region: int,
    mode: str,
    num_rot: int = 40,
    map_resolution: float = 1.0,
    window_w: int = 100,
):
    """Returns score(cmap: ConvMap, stencil, scan, class_weights,
    center_px, theta, f, alive, s0=0) for the clustered regime:

      tracked -> (cost, norm, kf) (N,) at each particle's own shift,
                 read from the window [s0, s0 + window_w)
      init    -> (costs, norms (N, num_rot), kf (N,)) at the search shifts

    The region's origin is the least rounded centre over the ALIVE
    particles (dead slots are stale resample leftovers anywhere on the
    map), clamped so that the block fits the padded map.  The caller plans
    the region so that every alive centre falls inside it; a straggler is
    clamped to the region's edge and scored there.  A shift outside the
    window is clamped to its edge the same way."""
    if mode not in ("tracked", "init"):
        raise ValueError(f"unknown conv mode {mode!r}")
    dr, dc = conv_dims(mo)

    def score(cmap: ConvMap, stencil, scan, class_weights, center_px,
              theta, f, alive, s0=0):
        th, r = stencil.shape[:2]
        dev = center_px.device
        mres = torch.tensor(map_resolution, dtype=torch.float32, device=dev)
        cy = torch.round(center_px[:, 1] / mres).to(torch.int64) + cmap.pad
        cx = torch.round(center_px[:, 0] / mres).to(torch.int64) + cmap.pad
        big = 1 << 30
        oy = torch.where(alive, cy, big).min().clamp(
            dr // 2, cmap.hp - (region + dr - 1) + dr // 2)
        ox = torch.where(alive, cx, big).min().clamp(
            dc // 2, cmap.wp - (region + dc - 1) + dc // 2)
        iy = (cy - oy).clamp(0, region - 1)
        ix = (cx - ox).clamp(0, region - 1)
        kernel = build_conv_kernel(scan, class_weights, stencil, f, mo,
                                   mode, num_rot, window_w, s0)
        field = cost_field(cmap.padded, kernel, torch.stack([oy, ox]), mo,
                           region).reshape(kernel.shape[0], -1)
        cell = iy * region + ix
        # kf: the count times f32(1 / (Th R)), as the reference's compiled
        # division by a constant
        inv_tr = float(np.float32(1.0) / np.float32(th * r))
        if mode == "tracked":
            s = rotation_shift(theta, th)
            local = ((s - s0) % th).clamp(0, window_w - 1)
            return (field[local, cell], field[window_w + local, cell],
                    field[2 * window_w, cell] * inv_tr)
        rows = field[:, cell]
        return (rows[:num_rot].T, rows[num_rot : 2 * num_rot].T,
                rows[2 * num_rot] * inv_tr)

    return score
