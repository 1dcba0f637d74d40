"""Unknown-scale crop scoring over K scale buckets (counterpart of
filter/multiscale.py).

Until the scale freezes, the particle scales stay clustered around a few
discrete values: the reference's 10 init hypotheses 10^{k/10}, diffused
by at most 2 % per step.  The host clusters the alive scales into
K <= MAX_BUCKETS slots and picks a mip level per slot.  Each particle p
in bucket b (its nearest slot in log space) is then scored like the
uniform crop path (filter/crop_score.py) with its bucket's offsets and
its bucket's level:

  off_b    = round(stencil * f_eff_b),  f_eff_b = slot_b * res / mip_b
  centre_p = round(center_px_p / (map_resolution * mip_b))  (a division)
  sample   = level_b[centre_p + off_b]  (zero outside level_b)

pose_px uses each particle's own continuous scale; only the offsets use
the bucket's slot, so the scales themselves are never quantised.

The pyramid keeps the float32 packed levels dist[::m, ::m] back to back
in one (P, 8) tensor with a host table of (pixel offset, H, W) per level.
A window that leaves its own level reads zeros there, never another
level's pixels.  None of the TPU layout is carried over (int8
quantisation, y-shifted copies, padding, nibble packing).

Three scorers, each a wrapper with a public plain version beside it:
  score_tracked_multi   -> (cost, norm, kf) at each particle's own shift
  score_init_multi_sel  -> (best_cost, k, kf) over the search shifts,
                           with the uniform path's select (NaN and
                           kf < 0.5 -> FLT_MAX, first argmin)
  score_init_multi_raw  -> (nums, dens, kf) at the search shifts: the raw
                           rows, which the multi-device step selects from
On CPU tensors the wrapper runs the plain version; on CUDA it launches
its kernel (csrc/crop_score.cu tracked, csrc/crop_score_init.cu for the
theta search) and counts it in kernels.LAUNCHES; any other device
raises.  Both kernels are the uniform path's, with one fold of the
offsets per bucket (crop_score.fold_pixels over the (K, Th*R) offsets)
read on the bucket's level of the compact pyramid (PyramidMaps.compact).
The theta search is the tensor-core product with one M per bucket
(crop_score.init_m); its wrapper sorts the particles by bucket (a stable
torch.sort), so that each tile of the kernel lies in one bucket.  The
tracked wrapper sorts them by bucket * Th + shift, so that each tile
lies in one bucket at one shift.  Both kernels write each row back to
its particle.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from top_down_renderer_torch import kernels
from top_down_renderer_torch.filter import crop_score as cs
from top_down_renderer_torch.filter.scoring import (
    circulants_at_shifts,
    known_fraction,
    rotation_shift,
    search_shifts,
)

MAX_BUCKETS = 12
SCALE_RTOL = 0.02  # max |scale - slot| / slot within a bucket
# clustering tolerance ladder: 2 %/step diffusion spreads the surviving
# hypotheses into a continuum that exceeds MAX_BUCKETS at the base rtol;
# coarser slots (quantisation error rtol * (range_bins - 1) px) keep the
# population off the exact gather
RTOL_LADDER = (SCALE_RTOL, 0.04, 0.08)
MO_MULTI = 12  # coarse crop bucket (wide scale posterior)
MO_MULTI_FINE = 24  # fine crop bucket (sharpened posterior)
# p2/p98 scale spread at or below which the fine bucket scores: two
# adjacent hypotheses (10^{1/10} = 1.26 apart) plus diffusion margin
MULTI_FINE_SPREAD = 1.60
K_SIZES = (2, 4, 8, MAX_BUCKETS)  # bucket counts the dispatch pads to
MAX_MIP = 64


def multi_mo(scale_spread: float = float("inf")) -> int:
    """Crop bucket of the multi path, adaptive in the width of the scale
    posterior (p2/p98 ratio of the alive scales): MO_MULTI_FINE once it
    is at most MULTI_FINE_SPREAD, else MO_MULTI.  TDR_MULTI_MO=12|24
    forces one value.  The port's kernel needs no crop buffer, so mo
    only sets fmax = mo / (range_bins - 1) and with it each slot's mip."""
    v = os.environ.get("TDR_MULTI_MO", "")
    if v:
        v = int(v)
        if v not in (MO_MULTI, MO_MULTI_FINE):
            raise ValueError(f"TDR_MULTI_MO must be 12 or 24, got {v}")
        return v
    return MO_MULTI_FINE if scale_spread <= MULTI_FINE_SPREAD else MO_MULTI


def cluster_scales(
    scales: np.ndarray, rtol: float = SCALE_RTOL,
    max_buckets: int = MAX_BUCKETS,
) -> Optional[np.ndarray]:
    """Greedy 1-D clustering of the positive scales in log space: (K,)
    float32 slot values (geometric bucket centres) with every input
    within rtol of its nearest slot, or None if that needs more than
    max_buckets slots."""
    u = np.unique(scales[scales > 0])
    if u.size == 0:
        return None
    logs = np.log(u)
    width = np.log1p(rtol) * 2.0  # cluster span so centre err <= rtol
    slots = []
    start = logs[0]
    for i in range(1, len(logs) + 1):
        if i == len(logs) or logs[i] - start > width:
            slots.append(0.5 * (start + logs[i - 1]))
            if i < len(logs):
                start = logs[i]
            if len(slots) > max_buckets:
                return None
    return np.exp(np.asarray(slots, np.float64)).astype(np.float32)


def mip_for_f(f: float, fmax: float = 1.0) -> Optional[int]:
    """Smallest power-of-2 mip with f / mip <= fmax, or None if even
    mip 64 leaves it above."""
    m = 1
    while f / m > fmax:
        if m >= MAX_MIP:
            return None
        m *= 2
    return m


def bucket_mips(
    slots: np.ndarray, rtol: float, mo: int, range_bins: int, res: float,
    gate_hi: float,
) -> Optional[Tuple[int, ...]]:
    """The mip of every slot, against fmax = mo / (range_bins - 1) with
    the slot's rtol spread beyond the base rtol inflated in; None when a
    live slot saturates even mip 64.  A saturating slot whose particles
    all lie past the weight gate (slot * (1 - rtol) > gate_hi, so their
    weights are zeroed whatever their cost) is clamped in place to the
    largest scale mip 64 covers, instead of dropping the update to the
    exact gather."""
    fmax = mo / max(range_bins - 1, 1)
    infl = (1.0 + rtol) / (1.0 + SCALE_RTOL)
    s_cap = fmax * MAX_MIP / (infl * res)
    mips = []
    for i, s in enumerate(slots):
        m = mip_for_f(float(s) * infl * res, fmax)
        if m is None:
            if float(s) * (1.0 - rtol) <= gate_hi:
                return None
            slots[i] = s_cap
            m = MAX_MIP
        mips.append(m)
    return tuple(mips)


def _pad_slots(slots: np.ndarray) -> np.ndarray:
    """Slots padded with copies of the last one to the next of K_SIZES,
    so that buckets dying off do not change the bucket count at every
    update.  A padded copy never wins assign_buckets' argmin."""
    kp = next(x for x in K_SIZES if len(slots) <= x)
    return np.concatenate(
        [slots, np.full(kp - len(slots), slots[-1], np.float32)]
    )


def plan_buckets(scales: np.ndarray, range_bins: int, res: float,
                 gate_hi: float):
    """The host plan of one unknown-scale update from the alive scales:
    (mo, slots (kp,) float32, mips (kp,)), or a str that says why the
    exact gather has to score it instead."""
    # rtol ladder: a diffused population overflows MAX_BUCKETS at the
    # base rtol; coarser slots beat the fall to the exact gather
    for rtol in RTOL_LADDER:
        slots = cluster_scales(scales, rtol=rtol)
        if slots is not None:
            break
    else:
        return (
            "alive scales form a continuum (> %d clusters even at rtol "
            "%.2g)" % (MAX_BUCKETS, RTOL_LADDER[-1])
        )
    slots = _pad_slots(slots)
    # robust p2/p98 spread: a lone straggler at a dead hypothesis must not
    # hold the population at the coarse precision
    lo, hi = np.percentile(scales, [2.0, 98.0])
    mo = multi_mo(float(hi / max(lo, 1e-20)))
    mips = bucket_mips(slots, rtol, mo, range_bins, res, gate_hi)
    if mips is None:
        return "a scale bucket saturates even the mip-64 pyramid level"
    return mo, slots, mips


# -- the pyramid -------------------------------------------------------------
class PyramidMaps(cs.CropMap):
    """Packed float32 levels dist[::m, ::m] for m in `mips`, back to back
    in `flat` (P, 8); `levels[l]` = (pixel offset, H, W) of level l.
    compact(num_classes) (P, CP) is both kernels' operand."""

    def __init__(self, flat: torch.Tensor, mips, levels):
        super().__init__(flat)
        self.mips = tuple(mips)
        self.levels = tuple(levels)
        self._tables = {}

    @property
    def flat(self) -> torch.Tensor:
        return self.packed

    def level_map(self, l: int) -> torch.Tensor:
        """Level l as an (H, W, 8) view of `flat`."""
        off, h, w = self.levels[l]
        return self.flat[off : off + h * w].view(h, w, self.flat.shape[1])

    def bucket_tables(self, bucket_level: Sequence[int]):
        """(mips (K,) float32, table (K, 4) int32 of (pixel offset, H, W,
        0)) of each bucket's level, on the pyramid's device, cached."""
        key = tuple(bucket_level)
        if key not in self._tables:
            dev = self.flat.device
            self._tables[key] = (
                torch.tensor([float(self.mips[l]) for l in key],
                             dtype=torch.float32, device=dev),
                torch.tensor([self.levels[l] + (0,) for l in key],
                             dtype=torch.int32, device=dev),
            )
        return self._tables[key]


def build_pyramid_maps(packed: torch.Tensor, mips) -> PyramidMaps:
    """(H, W, 8) float32 packed map -> its pyramid over `mips`."""
    parts, levels, off = [], [], 0
    for m in mips:
        lv = packed[::m, ::m]
        h, w = lv.shape[:2]
        parts.append(lv.reshape(h * w, packed.shape[2]))
        levels.append((off, h, w))
        off += h * w
    return PyramidMaps(torch.cat(parts).contiguous(), mips, levels)


def assign_buckets(scale: torch.Tensor, slot_vals: torch.Tensor) -> torch.Tensor:
    """(N,) int32 nearest slot in log space (first one on a tie)."""
    d = torch.abs(
        torch.log(torch.clamp(scale, min=1e-20))[:, None]
        - torch.log(slot_vals)[None, :]
    )
    return torch.argmin(d, dim=1).to(torch.int32)


def bucket_offsets(stencil, slot_vals, res, mips) -> torch.Tensor:
    """(K, Th*R, 2) int32 offsets (dy, dx) = round(stencil * f_eff_b),
    f_eff = slot_vals * res / mips, in float32."""
    dev = slot_vals.device
    res = torch.as_tensor(res, dtype=torch.float32, device=dev)
    f_eff = slot_vals.to(torch.float32) * res / mips
    sten = stencil.reshape(-1, 2).to(device=dev, dtype=torch.float32)
    return torch.round(sten[None] * f_eff[:, None, None]).to(torch.int32)


def pyramid_centers(center_px, bucket, mips, map_resolution: float):
    """(N, 2) int32 (cy, cx) = round(center / (map_resolution * mip_b)),
    a true float32 division; centres beyond +-2^20 px (or NaN) are
    pinned there, outside every level."""
    d = (mips * map_resolution)[bucket.long()]
    c = torch.round(center_px.to(torch.float32).flip(-1) / d[:, None])
    c = torch.nan_to_num(c, nan=-(2.0**20)).clamp(-(2.0**20), 2.0**20)
    return c.to(torch.int32)


def bucket_rows(bucket: torch.Tensor, k: int):
    """Bucket-major rows for the theta-search kernel, whose tiles each lie
    in one bucket: (perm (N,) int32, the particles in stable bucket order;
    row_start (K + 1,) int64, bucket b's first row, and N).  Device ops of
    fixed size only: no host read."""
    sorted_bucket, perm = torch.sort(bucket, stable=True)
    row_start = torch.searchsorted(
        sorted_bucket,
        torch.arange(k + 1, dtype=torch.int32, device=bucket.device),
    )
    return perm.to(torch.int32), row_start


def _prepare(pyr, stencil, center_px, scale, slot_vals, bucket_level, res,
             map_resolution):
    """(bucket (N,) int32, offsets (K, TR, 2), centres (N, 2), table
    (K, 4)) on the pyramid's device."""
    mips, table = pyr.bucket_tables(bucket_level)
    slot_vals = slot_vals.to(device=mips.device, dtype=torch.float32)
    bucket = assign_buckets(scale, slot_vals)
    off = bucket_offsets(stencil, slot_vals, res, mips)
    ctr = pyramid_centers(center_px, bucket, mips, map_resolution)
    return bucket, off, ctr, table


# -- plain version -----------------------------------------------------------
def multi_scores_raw(
    pyr: PyramidMaps, num_classes: int, stencil, scan, class_weights,
    center_px, scale, slot_vals, bucket_level, res, shifts,
    map_resolution: float = 1.0, chunk_size: int = 4096,
):
    """Raw rows (num (N, S), den (N, S), kf (N,)) at the given shifts:
    each particle's window gathered from its bucket's level, then one
    matmul against the circulant columns."""
    bucket, off, ctr, table = _prepare(
        pyr, stencil, center_px, scale, slot_vals, bucket_level, res,
        map_resolution,
    )
    table = table.long()
    cost_sel, norm_sel = circulants_at_shifts(scan, class_weights, shifts)
    nums, dens, kfs = [], [], []
    for lo in range(0, ctr.shape[0], chunk_size):
        b = bucket[lo : lo + chunk_size].long()
        o = off[b]  # (P, TR, 2)
        c = ctr[lo : lo + chunk_size]
        iy = c[:, None, 0] + o[..., 0]
        ix = c[:, None, 1] + o[..., 1]
        base, h, w = (table[b, k, None] for k in range(3))
        valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        lin = (
            base
            + torch.minimum(torch.clamp(iy, min=0), h - 1) * w
            + torch.minimum(torch.clamp(ix, min=0), w - 1)
        )
        g = torch.where(valid[..., None], pyr.flat[lin], 0.0)
        dists = g[..., :num_classes].reshape(g.shape[0], -1)
        known = g[..., num_classes]
        nums.append(dists @ cost_sel)
        dens.append(known @ norm_sel)
        kfs.append(known_fraction(known))
    return torch.cat(nums), torch.cat(dens), torch.cat(kfs)


def score_init_multi_raw_plain(
    pyr, num_classes, stencil, scan, class_weights, center_px, scale,
    slot_vals, bucket_level, res, num_rot: int = 40,
    map_resolution: float = 1.0,
):
    """(nums (N, num_rot), dens (N, num_rot), kf (N,)) at the search
    shifts: the parity surface of the theta-search flavour."""
    ssh = search_shifts(scan.shape[1], num_rot, scan.device)
    return multi_scores_raw(
        pyr, num_classes, stencil, scan, class_weights, center_px, scale,
        slot_vals, bucket_level, res, ssh, map_resolution,
    )


def score_tracked_multi_plain(
    pyr, num_classes, stencil, scan, class_weights, center_px, theta,
    scale, slot_vals, bucket_level, res, map_resolution: float = 1.0,
):
    """Plain version of the tracked flavour: (cost, norm, kf) (N,)."""
    th = scan.shape[1]
    nums, dens, kf = multi_scores_raw(
        pyr, num_classes, stencil, scan, class_weights, center_px, scale,
        slot_vals, bucket_level, res, torch.arange(th, device=scan.device),
        map_resolution,
    )
    s = rotation_shift(theta, th).to(nums.device)[:, None]
    return nums.gather(1, s)[:, 0], dens.gather(1, s)[:, 0], kf


def score_init_multi_sel_plain(
    pyr, num_classes, stencil, scan, class_weights, center_px, scale,
    slot_vals, bucket_level, res, num_rot: int = 40,
    map_resolution: float = 1.0,
):
    """Plain version of the theta-search flavour: (best_cost, k, kf)."""
    nums, dens, kf = score_init_multi_raw_plain(
        pyr, num_classes, stencil, scan, class_weights, center_px, scale,
        slot_vals, bucket_level, res, num_rot, map_resolution,
    )
    best, k = cs.select_best(nums, dens, kf)
    return best, k, kf


# -- wrapper ----------------------------------------------------------------
def _check_buckets(pyr, stencil, scan, class_weights, center_px, scale,
                   slot_vals, bucket_level, num_classes, num_rot=None):
    """The checks both K-bucket wrappers share: (K, C, Th, R)."""
    flat = pyr.flat
    dev = flat.device
    k = len(bucket_level)
    if not 1 <= k <= MAX_BUCKETS:
        raise ValueError(f"the kernel takes 1..{MAX_BUCKETS} buckets, got {k}")
    cs._require(flat, "pyramid", (flat.shape[0], cs.C_PAD), torch.float32,
                dev, contiguous=True)
    if flat.numel() >= 2**31:
        raise ValueError("pyramid too large for 32-bit indexing")
    n = center_px.shape[0]
    cs._require(scale, "scale", (n,), torch.float32, dev)
    cs._require(slot_vals, "slot_vals", (k,), torch.float32, dev)
    return (k,) + cs.check_operands(num_classes, stencil, scan,
                                    class_weights, center_px, dev, num_rot)


def _tracked_inputs(pyr, num_classes, stencil, scan, class_weights,
                    center_px, theta, scale, slot_vals, bucket_level, res,
                    map_resolution):
    """Check the tracked kernel's operands and derive its inputs on their
    device: (compact pyramid, table (K, 4), the fold of the offsets (K,
    Th*R, 2) (crop_score.fold_pixels), centres (N, 2), group keys bucket *
    Th + shift (N,))."""
    dev = pyr.flat.device
    _check_buckets(pyr, stencil, scan, class_weights, center_px, scale,
                   slot_vals, bucket_level, num_classes)
    th = cs.check_tracked(num_classes, stencil, scan, class_weights,
                          center_px, theta, dev)[1]
    compact = pyr.compact(num_classes)
    bucket, off, ctr, table = _prepare(
        pyr, stencil, center_px, scale, slot_vals, bucket_level, res,
        map_resolution,
    )
    key = bucket * th + rotation_shift(theta, th)
    return compact, table, cs.fold_pixels(off), ctr.contiguous(), key


def score_tracked_multi(
    pyr, num_classes, stencil, scan, class_weights, center_px, theta,
    scale, slot_vals, bucket_level, res, map_resolution: float = 1.0,
):
    """Tracked flavour over K buckets: (cost, norm, kf) (N,) at each
    particle's own rotation shift."""
    if not kernels.on_card(pyr.flat.device, "crop scorer"):
        return score_tracked_multi_plain(
            pyr, num_classes, stencil, scan, class_weights, center_px,
            theta, scale, slot_vals, bucket_level, res, map_resolution,
        )
    compact, table, fold, ctr, key = _tracked_inputs(
        pyr, num_classes, stencil, scan, class_weights, center_px, theta,
        scale, slot_vals, bucket_level, res, map_resolution,
    )
    return cs.launch_tracked(
        "crop_score_multi_tracked", compact, table, 0, 0, num_classes, scan,
        class_weights, fold, ctr, key,
    )


def _score_init_multi(name, pyr, num_classes, stencil, scan, class_weights,
                      center_px, scale, slot_vals, bucket_level, res,
                      num_rot, map_resolution):
    """Check the K-bucket theta search's operands on the card and launch
    `name` (crop_score.launch_init) over the bucket-major rows."""
    k = _check_buckets(pyr, stencil, scan, class_weights, center_px, scale,
                       slot_vals, bucket_level, num_classes, num_rot)[0]
    compact = pyr.compact(num_classes)
    bucket, off, ctr, table = _prepare(
        pyr, stencil, center_px, scale, slot_vals, bucket_level, res,
        map_resolution,
    )
    perm, row_start = bucket_rows(bucket, k)
    return cs.launch_init(
        name, compact, table, 0, 0, num_classes, scan, class_weights,
        cs.fold_pixels(off), ctr.contiguous(), perm, row_start, num_rot,
    )


def score_init_multi_sel(
    pyr, num_classes, stencil, scan, class_weights, center_px, scale,
    slot_vals, bucket_level, res, num_rot: int = 40,
    map_resolution: float = 1.0,
):
    """Theta-search flavour over K buckets: (best_cost, k (int64), kf)."""
    if not kernels.on_card(pyr.flat.device, "crop scorer"):
        return score_init_multi_sel_plain(
            pyr, num_classes, stencil, scan, class_weights, center_px,
            scale, slot_vals, bucket_level, res, num_rot, map_resolution,
        )
    return _score_init_multi(
        "crop_score_multi_init", pyr, num_classes, stencil, scan,
        class_weights, center_px, scale, slot_vals, bucket_level, res,
        num_rot, map_resolution,
    )


def score_init_multi_raw(
    pyr, num_classes, stencil, scan, class_weights, center_px, scale,
    slot_vals, bucket_level, res, num_rot: int = 40,
    map_resolution: float = 1.0,
):
    """The K-bucket theta search's raw rows, score_init_multi_raw_plain's
    contract: (nums, dens (N, num_rot), kf (N,)), nothing divided or gated;
    a window off its level reads zeros.  On the card the tensor-core
    product of score_init_multi_sel with the raw-row epilogue
    ("crop_score_multi_init_raw"): the multi-device init step's scorer."""
    if not kernels.on_card(pyr.flat.device, "crop scorer"):
        return score_init_multi_raw_plain(
            pyr, num_classes, stencil, scan, class_weights, center_px,
            scale, slot_vals, bucket_level, res, num_rot, map_resolution,
        )
    return _score_init_multi(
        "crop_score_multi_init_raw", pyr, num_classes, stencil, scan,
        class_weights, center_px, scale, slot_vals, bucket_level, res,
        num_rot, map_resolution,
    )
