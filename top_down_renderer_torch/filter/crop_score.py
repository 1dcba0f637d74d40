"""Crop scoring for a uniform particle scale: host side, plain version and
the wrappers of the CUDA kernels (counterpart of filter/pallas_score.py).

With one scale for every particle, the stencil's pixel offsets
off = round(stencil * f), f = scale * res / mip, are shared, and the
sample of stencil cell (t, r) for a particle centred at (cx, cy) is

  map[round(cy / mres) + off_y, round(cx / mres) + off_x, :]

(zero outside the map), mres = map_resolution * mip.  Against these
samples a particle's cost, norm and known fraction at shift s are those
of filter/scoring.py.  On integer centres this picks the same pixels as
the exact path; on float centres it can differ from round(c + d * f) by
one pixel, the reference crop kernel's documented NN granularity.

Three entry points:
  score_tracked   -> (cost, norm, kf) at each particle's own shift
  score_init_sel  -> (best_cost, k, kf) over the num_rot search shifts:
                     cost / norm, NaN -> FLT_MAX, FLT_MAX where
                     kf < 0.5, first argmin k (best_theta = k 2 pi / n)
  score_init_raw  -> (nums, dens, kf) at the search shifts, the raw rows
                     the multi-device step selects from (select_init_cost)

Ties in the theta search.  The plain version takes the exact first
argmin of its float32 costs.  The kernel takes the first shift whose
cost lies within TIE_REL (2^-20) relative of the row's minimum, and
returns that shift's cost.  Costs equal in exact arithmetic (a window of
constant map values; shifts a half turn apart on a road's centre line)
come out of both versions' sums, taken in other orders, up to a few
1e-7 apart: the kernel sends them to the first shift, the plain version to
whichever of its sums is smaller.  Either way best_cost agrees within
rel 1e-4, and k differs only between such near ties.

Each takes CPU or CUDA tensors.  On CUDA it launches its kernel
(csrc/crop_score.cu for the tracked flavour, csrc/crop_score_init.cu for
the theta search) and counts it in kernels.LAUNCHES; on the CPU it runs
the plain version (score_tracked_plain / score_init_sel_plain: a gather
of the shared-offset windows and a matmul against circulant columns),
which is public and also runs on CUDA tensors, for comparisons.  Any
other device raises.

The theta-search kernel is a product on the tensor cores: each
particle's window of distinct stencil pixels (compact_map: the C + 1
channels the score reads) times a matrix M that folds the stencil's
one-hot into the circulant columns (init_m), with both operands split
into bf16 hi and lo parts (split_bf16, init_operands).  init_m is plain
PyTorch and public, so that the CPU tests hold window @ M to the plain
version.

The tracked kernel, on CUDA cores, reads each particle's distinct
stencil pixels once, from the same compact map, and weighs them with the
stencil folded for the particle's own shift: per pixel, the cost weights
of its C classes, the norm weight and the count of its cells.  The
wrapper sorts the particles by shift (bucket * Th + shift over K
buckets), so that a block of the kernel folds the weights once for each
run of one shift among its rows (tracked_rows).  The fold of the offsets
to distinct pixels and their cells, which both kernels read, is a kernel
of its own (fold_pixels, one launch; fold_offsets is its plain version),
and a CropMap keeps the last fold for a scale f given as a number, so the
filter folds its stencil once per map and scale.  tracked_weights and
folded_scores are the tracked kernel's computation in plain PyTorch, for
the CPU tests.

Both wrappers take the map as a CropMap: the packed map at one mip level
with its compact copy, made once and kept beside it.

The crop-size buckets and the mip fallback are kept in the host dispatch
(filter/filter.py) so that both packages score the same map at the same
state; neither kernel needs a crop buffer.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from top_down_renderer_torch import kernels
from top_down_renderer_torch.kernels import ptr
from top_down_renderer_torch.filter.scoring import (
    circulants_at_shifts,
    class_sum,
    gather_windows,
    known_fraction,
    rotation_shift,
    search_shifts,
)

FLT_MAX = float(np.finfo(np.float32).max)
C_PAD = 8  # channels of the packed map
MAX_SEARCH = 40  # search shifts of the init kernel: columns 0-79 of M
SMEM_LIMIT = 227 * 1024  # dynamic shared memory a Hopper block may use
M_COLS = 88  # columns of M: (cost, norm) at 2k, 2k + 1; kf count; padding
KF_COL = 2 * MAX_SEARCH
K_CHUNK = 32  # rows of M per pipeline stage of the init kernel
TIE_REL = 2.0**-20  # the init kernel's tie window (kTieRel)
INIT_TILE = 192  # particles per block of the init kernel
TRACKED_TILE = 64  # sorted rows per block of the tracked kernel (kTile)
PAD_PIX = 2**29  # (dy, dx) of a padding pixel: outside every map
_KEY_BITS = 22  # bits per offset in fold_offsets' sort key

# crop-size buckets keyed by the max stencil pixel offset mo
_MO_BUCKETS = (12, 24)
# the conv path's (filter/conv_score.py): its kernel has no crop buffer to
# bound, so it covers larger range scales (its size grows with mo^2)
_MO_BUCKETS_CONV = (12, 24, 36, 48)

def pick_crop_size(
    f: float, range_bins: int, buckets=_MO_BUCKETS
) -> int | None:
    """Smallest max-offset bucket covering scale*res = f, or None."""
    max_off = int(np.ceil((range_bins - 1) * float(f)))
    for mo in buckets:
        if max_off <= mo:
            return mo
    return None


def mip_map(dist: torch.Tensor, mip: int) -> torch.Tensor:
    """The mip-strided subsample the dispatch scores against at mip > 1."""
    return dist[::mip, ::mip].contiguous() if mip > 1 else dist


def crop_offsets(stencil: torch.Tensor, f) -> torch.Tensor:
    """(Th*R, 2) int32 shared pixel offsets (dy, dx) = round(stencil*f),
    computed in float32."""
    sten = stencil.reshape(-1, 2).to(torch.float32)
    f = torch.as_tensor(f, dtype=torch.float32, device=sten.device)
    return torch.round(sten * f).to(torch.int32)


def crop_centers(center_px: torch.Tensor, map_resolution: float) -> torch.Tensor:
    """(N, 2) int32 (cy, cx) = round(center / map_resolution).  Centres
    beyond +-2^20 px (or NaN) are pinned there: every sample of such a
    window lies outside any map."""
    inv = float(np.float32(1.0) / np.float32(map_resolution))
    c = torch.round(center_px.to(torch.float32).flip(-1) * inv)
    c = torch.nan_to_num(c, nan=-(2.0**20)).clamp(-(2.0**20), 2.0**20)
    return c.to(torch.int32)


# -- plain version ---------------------------------------------------------
def crop_scores_raw(
    packed_map: torch.Tensor,
    num_classes: int,
    stencil: torch.Tensor,
    scan: torch.Tensor,
    class_weights: torch.Tensor,
    center_px: torch.Tensor,
    f,
    shifts: torch.Tensor,
    map_resolution: float = 1.0,
    chunk_size: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw rows (num (N, S), den (N, S), kf (N,)) at the given shifts."""
    off = crop_offsets(stencil, f).to(packed_map.device)
    ctr = crop_centers(center_px, map_resolution).to(packed_map.device)
    cost_sel, norm_sel = circulants_at_shifts(scan, class_weights, shifts)
    nums, dens, kfs = [], [], []
    for lo in range(0, ctr.shape[0], chunk_size):
        c = ctr[lo : lo + chunk_size]
        iy = c[:, None, 0] + off[None, :, 0]
        ix = c[:, None, 1] + off[None, :, 1]
        dists, known = gather_windows(packed_map, num_classes, iy, ix)
        nums.append(dists @ cost_sel)
        dens.append(known @ norm_sel)
        kfs.append(known_fraction(known))
    return torch.cat(nums), torch.cat(dens), torch.cat(kfs)


def score_init_raw_plain(
    packed_map, num_classes, stencil, scan, class_weights, center_px, f,
    num_rot: int = 40, map_resolution: float = 1.0, chunk_size: int = 4096,
):
    """(nums (N, num_rot), dens (N, num_rot), kf (N,)) at the search
    shifts: the parity surface of the theta-search flavour."""
    ssh = search_shifts(scan.shape[1], num_rot, scan.device)
    return crop_scores_raw(
        packed_map, num_classes, stencil, scan, class_weights, center_px,
        f, ssh, map_resolution, chunk_size,
    )


def select_best(
    nums: torch.Tensor, dens: torch.Tensor, kf: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_cost, k): cost = num/den, NaN -> FLT_MAX, FLT_MAX where
    kf < 0.5, then the first argmin."""
    c = nums / dens
    c = torch.where(torch.isnan(c) | (kf[:, None] < 0.5), FLT_MAX, c)
    best, k = torch.min(c, dim=1)
    return best, k


def score_tracked_plain(
    packed_map, num_classes, stencil, scan, class_weights, center_px,
    theta, f, map_resolution: float = 1.0, chunk_size: int = 4096,
):
    """Plain version of the tracked flavour: (cost, norm, kf) (N,)."""
    th = scan.shape[1]
    nums, dens, kf = crop_scores_raw(
        packed_map, num_classes, stencil, scan, class_weights, center_px,
        f, torch.arange(th, device=scan.device), map_resolution,
        chunk_size,
    )
    s = rotation_shift(theta, th).to(nums.device)[:, None]
    return nums.gather(1, s)[:, 0], dens.gather(1, s)[:, 0], kf


def score_init_sel_plain(
    packed_map, num_classes, stencil, scan, class_weights, center_px, f,
    num_rot: int = 40, map_resolution: float = 1.0, chunk_size: int = 4096,
):
    """Plain version of the theta-search flavour: (best_cost, k, kf)."""
    nums, dens, kf = score_init_raw_plain(
        packed_map, num_classes, stencil, scan, class_weights, center_px,
        f, num_rot, map_resolution, chunk_size,
    )
    best, k = select_best(nums, dens, kf)
    return best, k, kf


# -- wrapper ----------------------------------------------------------------
def _require(t, name: str, shape, dtype, device, contiguous=False) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_operands(num_classes, stencil, scan, class_weights, center_px,
                   dev, num_rot=None):
    """The checks every crop kernel's wrapper shares (and the theta
    search's num_rot): (C, Th, R)."""
    c, th, r = scan.shape
    if not 1 <= num_classes < C_PAD or c != num_classes:
        raise ValueError(
            f"the kernel takes 1..{C_PAD - 1} classes matching the scan; "
            f"got num_classes={num_classes}, scan {tuple(scan.shape)}"
        )
    if num_rot is not None and not 1 <= num_rot <= MAX_SEARCH:
        raise ValueError(f"num_rot must be in 1..{MAX_SEARCH}, got {num_rot}")
    _require(stencil, "stencil", (th, r, 2), torch.float32, dev)
    _require(scan, "scan", (c, th, r), torch.float32, dev)
    _require(class_weights, "class_weights", (c,), torch.float32, dev)
    _require(center_px, "center_px", (center_px.shape[0], 2), torch.float32,
             dev)
    return c, th, r


def check_tracked(num_classes, stencil, scan, class_weights, center_px,
                  theta, dev):
    """The checks both tracked wrappers share: the crop operands, the
    block's shared memory (tracked_smem) and theta: (C, Th, R)."""
    c, th, r = check_operands(num_classes, stencil, scan, class_weights,
                              center_px, dev)
    smem = tracked_smem(c, th * r)
    if smem > SMEM_LIMIT:
        raise ValueError(f"scan window needs {smem} B of shared memory")
    _require(theta, "theta", (center_px.shape[0],), torch.float32, dev)
    return c, th, r


def _tracked_inputs(maps, num_classes, stencil, scan, class_weights,
                    center_px, theta, f, map_resolution):
    """Check the tracked kernel's operands and derive its inputs on their
    device: (compact map, the stencil's fold at f (CropMap.fold), centres
    (N, 2), shifts (N,))."""
    packed = maps.packed
    dev = packed.device
    h, w = packed.shape[:2]
    _require(packed, "packed_map", (h, w, C_PAD), torch.float32, dev)
    th = check_tracked(num_classes, stencil, scan, class_weights,
                       center_px, theta, dev)[1]
    compact = maps.compact(num_classes)
    if compact.numel() >= 2**31:
        raise ValueError("map too large for 32-bit indexing")
    return (compact, maps.fold(stencil, f),
            crop_centers(center_px, map_resolution).contiguous(),
            rotation_shift(theta, th))


def score_tracked(
    maps, num_classes, stencil, scan, class_weights, center_px, theta, f,
    map_resolution: float = 1.0,
):
    """Tracked flavour: (cost, norm, kf) (N,) at each particle's own
    rotation shift on maps.packed (a CropMap); cost/norm is the
    particle's cost.  f as a number lets maps keep the stencil's fold
    (CropMap.fold)."""
    if not kernels.on_card(maps.packed.device, "crop scorer"):
        return score_tracked_plain(
            maps.packed, num_classes, stencil, scan, class_weights,
            center_px, theta, f, map_resolution,
        )
    compact, fold, ctr, shift = _tracked_inputs(
        maps, num_classes, stencil, scan, class_weights, center_px, theta,
        f, map_resolution,
    )
    h, w = maps.packed.shape[:2]
    return launch_tracked("crop_score_tracked", compact, None, h, w,
                          num_classes, scan, class_weights, fold, ctr, shift)


# -- the tracked kernel's operands ---------------------------------------
def tracked_smem(num_classes: int, tr: int) -> int:
    """Bytes of shared memory of a tracked kernel block: the pixel offsets
    (P int2), the folded weights (C + 2, P) and the scan tables (C + 1,
    Th*R) float32, P = Th*R rounded up to 16 (fold_offsets)."""
    cap = -(-tr // 16) * 16
    return cap * 8 + (num_classes + 2) * cap * 4 + (num_classes + 1) * tr * 4


def tracked_rows(key: torch.Tensor):
    """The particles in stable order of their group keys (bucket * Th +
    shift): (sorted keys int32, perm int64) (N,).  Block i of the tracked
    kernel takes sorted rows [i T, (i + 1) T), T = TRACKED_TILE, and
    scores each run of one key among them with that group's folded
    weights; row j's result goes to particle perm[j].  One device sort of
    32-bit keys (half the radix passes of 64-bit ones), no host read."""
    return torch.sort(key.to(torch.int32), stable=True)


def fold_pixels(off: torch.Tensor):
    """The distinct pixels of the offset tables off (K, Th*R, 2) int32 and
    the CSR of their cells: (pix, npix, order, seg), as fold_offsets
    returns them.  On the card one launch of the fold kernel
    (csrc/crop_score.cu, counted as "crop_fold") writes them into one
    buffer; on the CPU it is fold_offsets itself."""
    k, tr = off.shape[:2]
    if not kernels.on_card(off.device, "offset fold"):
        return fold_offsets(off)
    _require(off, "off", (k, tr, 2), torch.int32, off.device,
             contiguous=True)
    cap = -(-tr // 16) * 16
    buf = torch.empty(3 * k * cap + 1 + k * tr + k, dtype=torch.int32,
                      device=off.device)
    kernels.launch("crop_score", "tdr_crop_fold", ptr(off), k, tr, cap,
                   ptr(buf))
    kernels.LAUNCHES["crop_fold"] += 1
    seg = buf[2 * k * cap : 3 * k * cap + 1]
    order = buf[3 * k * cap + 1 : 3 * k * cap + 1 + k * tr]
    return buf[: 2 * k * cap].view(k, cap, 2), buf[-k:], order, seg


def launch_tracked(name: str, maps, table, h: int, w: int, num_classes: int,
                   scan, class_weights, fold, ctr, key):
    """Sort the particles by group key (bucket * Th + shift) and launch
    the tracked kernel `name` (kernels.LAUNCHES key; entry tdr_<name>)
    over the compact map `maps` (table: the K buckets' levels, or None at
    a uniform scale) with the K offset tables' fold (fold_pixels).
    Returns (cost, norm, kf) (N,)."""
    th, r = scan.shape[1:]
    n = ctr.shape[0]
    out = torch.empty((n, 3), dtype=torch.float32, device=ctr.device)
    if n:
        pix, npix, order, seg = fold
        skey, perm = tracked_rows(key)
        inv_tr = float(np.float32(1.0) / np.float32(th * r))
        # kept alive until the asynchronous launch has read them
        scan, class_weights = scan.contiguous(), class_weights.contiguous()
        if table is None:
            head = (ptr(maps), h, w)
        else:
            head = (ptr(maps), ptr(table), table.shape[0])
        kernels.launch(
            "crop_score", f"tdr_{name}", *head, num_classes, ptr(scan),
            ptr(class_weights), ptr(pix), ptr(npix), ptr(order), ptr(seg),
            th, r, pix.shape[1], ptr(skey), ptr(perm), ptr(ctr), n,
            ctypes.c_float(inv_tr), ptr(out),
        )
        kernels.LAUNCHES[name] += 1
    return out[:, 0], out[:, 1], out[:, 2]


def cell_slots(seg: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) int64: the slot of each position of a CSR with segment starts
    seg, n = seg[-1] entries."""
    pos = torch.arange(n, device=seg.device)
    return torch.searchsorted(seg.long(), pos, right=True) - 1


def tracked_weights(scan, class_weights, order, seg):
    """The tracked kernel's folded weights at every shift, in plain
    PyTorch: (K, Th, P, C + 2) float32 over fold_offsets' CSR (order, seg)
    of K offset tables.  w[b, s, u] holds, for pixel u of table b at shift
    s, the sums over the pixel's cells i of the weighted scan 0.01 w_c
    scan_c (C cost weights) and of its class sum (the norm weight) at scan
    cell (i + s R) mod Th R, and the count of those cells (the kf weight);
    summed in float64, so that their order does not change the result."""
    c, th, r = scan.shape
    tr = th * r
    nslot = seg.shape[0] - 1
    k = order.shape[0] // tr
    dev = scan.device
    wscan = (scan * (0.01 * class_weights)[:, None, None]).reshape(c, tr)
    feat = torch.cat([wscan.T, class_sum(scan).reshape(tr, 1),
                      torch.ones((tr, 1), device=dev)], 1).double()
    slot = cell_slots(seg, order.shape[0])
    cell = order.long() % tr
    w = torch.zeros((th, nslot, c + 2), dtype=torch.float32, device=dev)
    for s in range(th):
        acc = torch.zeros((nslot, c + 2), dtype=torch.float64, device=dev)
        w[s] = acc.index_add_(0, slot, feat[(cell + s * r) % tr]).float()
    return w.view(th, k, nslot // k, c + 2).transpose(0, 1)


def folded_scores(compact, table, ctr, pix, w, bucket, shift,
                  num_classes: int):
    """The tracked kernel's product in plain PyTorch: (cost, norm, kf)
    (N,).  Particle p in bucket b = bucket[p] at shift s = shift[p] reads
    its window a of b's distinct pixels, ctr[p] + pix[b], on the compact
    map (compact (pixels, CP); level b at table[b] = (pixel offset, H, W,
    -), zero outside it) and weighs it with w[b, s] (tracked_weights):
    cost = sum_u sum_{c<C} w[u, c] a[u, c], norm = sum_u w[u, C] a[u, C],
    kf = sum_u w[u, C + 1] a[u, C] / (Th R), an exact count."""
    c = num_classes
    b = bucket.long()
    lv = table.long()[b]
    base, h, wd = lv[:, 0:1], lv[:, 1:2], lv[:, 2:3]
    iy = ctr[:, None, 0].long() + pix[b][..., 0]
    ix = ctr[:, None, 1].long() + pix[b][..., 1]
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < wd)
    lin = base + torch.minimum(iy.clamp(min=0), h - 1) * wd + torch.minimum(
        ix.clamp(min=0), wd - 1)
    a = torch.where(valid[..., None], compact[lin], 0.0)
    ws = w[b, shift.long()]
    tr = float(ws[0, :, c + 1].sum())
    inv = float(np.float32(1.0) / np.float32(tr))
    return ((a[..., :c] * ws[..., :c]).sum((1, 2)),
            (a[..., c] * ws[..., c]).sum(1),
            (a[..., c] * ws[..., c + 1]).sum(1) * inv)


# -- the theta-search kernel's operands ----------------------------------
def channel_pad(num_classes: int) -> int:
    """CP, the channels per pixel of the compact map: C + 1 (the classes
    and the known indicator) rounded up to 2, 4 or 8."""
    return next(cp for cp in (2, 4, 8) if num_classes + 1 <= cp)


def compact_map(packed: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(..., CP) float32: the packed map's C class distances and its known
    channel, zeros above; the theta-search kernel's A operand (half the
    bytes of the 8-channel packed map at C <= 3)."""
    cp = channel_pad(num_classes)
    out = torch.zeros(packed.shape[:-1] + (cp,), dtype=torch.float32,
                      device=packed.device)
    out[..., : num_classes + 1] = packed[..., : num_classes + 1]
    return out


class CropMap:
    """A packed (..., 8) float32 map and its compact copies: the crop
    kernels' operands.  compact(num_classes) is made on first use and
    kept, so a map's owner makes it once per map version; fold(stencil,
    f) keeps the last stencil fold at a host scale f."""

    def __init__(self, packed: torch.Tensor):
        self.packed = packed
        self._compact = {}
        self._fold = None  # (stencil, f, fold)

    def compact(self, num_classes: int) -> torch.Tensor:
        """compact_map(packed, num_classes), made once."""
        if num_classes not in self._compact:
            self._compact[num_classes] = compact_map(self.packed,
                                                     num_classes)
        return self._compact[num_classes]

    def fold(self, stencil: torch.Tensor, f):
        """fold_pixels(crop_offsets(stencil, f)[None]): the stencil's
        distinct pixels at f and the CSR of their cells.  For a number f
        the last fold is kept and returned again for the same stencil
        tensor and f; a tensor f is folded on every call, since comparing
        it would read it to the host."""
        if isinstance(f, torch.Tensor):
            return fold_pixels(crop_offsets(stencil, f)[None])
        f = float(f)
        if (self._fold is None or self._fold[0] is not stencil
                or self._fold[1] != f):
            self._fold = (stencil, f,
                          fold_pixels(crop_offsets(stencil, f)[None]))
        return self._fold[2]


def fold_offsets(off: torch.Tensor):
    """The distinct pixels of K offset tables off (K, Th*R, 2) and the
    cells on each, in plain PyTorch (the fold kernel's plain version):
    (pix (K, P, 2), npix (K,), order (K*Th*R,), seg (K*P + 1,)), all
    int32.  pix[b, :npix[b]] are bucket b's distinct (dy, dx) in row-major
    order, PAD_PIX after.  order and seg are the cells by slot b*P + u (a
    CSR): the cells on slot q, as flat indices b*Th*R + i, are
    order[seg[q]:seg[q + 1]] in increasing order, none on a padding slot.
    P is Th*R rounded up to 16 (whole kernel chunks at any CP).  Fixed
    sizes only: no host read."""
    k, tr = off.shape[:2]
    cap = -(-tr // 16) * 16
    dev = off.device
    half = 2 ** (_KEY_BITS - 1)
    o = off.to(torch.int64) + half
    b = torch.arange(k, device=dev)[:, None]
    key = (((b << _KEY_BITS) + o[..., 0]) << _KEY_BITS) + o[..., 1]
    skey, order = torch.sort(key.reshape(-1), stable=True)
    new = torch.ones_like(skey, dtype=torch.bool)
    new[1:] = skey[1:] != skey[:-1]
    seg = (torch.cumsum(new, 0) - 1).view(k, tr)  # buckets never share
    local = seg - seg[:, :1]
    sorted_slot = (b * cap + local).reshape(-1)
    pix = torch.full((k * cap, 2), PAD_PIX, dtype=torch.int32, device=dev)
    pix[sorted_slot] = off.reshape(-1, 2)[order]  # duplicates write alike
    starts = torch.searchsorted(
        sorted_slot, torch.arange(k * cap + 1, device=dev), out_int32=True
    )
    return (pix.view(k, cap, 2), (local[:, -1] + 1).to(torch.int32),
            order.to(torch.int32), starts)


def init_m(scan, class_weights, order, seg, num_rot: int = 40):
    """The theta search as a matrix: m (K, P*CP, M_COLS) float32 over the
    CSR (order, seg) of K offset tables' fold (fold_pixels; K = 1 at a
    uniform scale), whose pixels pix (K, P, 2) it multiplies.  Row q*CP +
    ch of m[b] is pixel pix[b, q], channel ch; for each search shift k,
    column 2k holds the cost and 2k + 1 the norm circulant summed over the
    stencil cells on that pixel, column KF_COL the count of those cells
    (known channel).  So for a window w[q, ch] of the compact map at
    centre + pix[b, q]: (w @ m[b])[2k] = num(k), [2k + 1] = den(k),
    [KF_COL] * 1/(Th R) = kf.  The sums are taken in float64, so that
    their order (index_add_ on the card) does not change the result."""
    c, th, r = scan.shape
    cp = channel_pad(c)
    tr = th * r
    k = order.shape[0] // tr
    cap = (seg.shape[0] - 1) // k
    ssh = search_shifts(th, num_rot, scan.device)
    cost_sel, norm_sel = circulants_at_shifts(scan, class_weights, ssh)
    s = num_rot
    feat = torch.cat([cost_sel.reshape(tr, c * s), norm_sel,
                      torch.ones((tr, 1), device=scan.device)], 1).double()
    acc = torch.zeros((k * cap, feat.shape[1]), dtype=torch.float64,
                      device=scan.device)
    acc.index_add_(0, cell_slots(seg, order.shape[0]),
                   feat[order.long() % tr])
    m = torch.zeros((k * cap, cp, M_COLS), dtype=torch.float32,
                    device=scan.device)
    m[:, :c, 0 : 2 * s : 2] = acc[:, : c * s].view(-1, c, s)
    m[:, c, 1 : 2 * s : 2] = acc[:, c * s : c * s + s]
    m[:, c, KF_COL] = acc[:, -1]
    return m.view(k, cap * cp, M_COLS)


def split_bf16(x: torch.Tensor):
    """(hi, lo) bf16 with hi = bf16(x), lo = bf16(x - hi), both rounded
    to nearest even: hi + lo keeps about 16 bits of x."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.to(torch.float32)).to(torch.bfloat16)


def init_operands(pix, npix, m):
    """M as the init kernel streams it: (records (K, chunks, words) int16,
    nchunk (K,) int64).  A record is one chunk of K_CHUNK rows of M: its
    bf16 hi plane, its lo plane (each in wgmma's K-major core-matrix
    order: 8 columns x 8 rows blocks of 128 bytes, N-block fastest), then
    the int32 (dy, dx) of its K_CHUNK / CP pixels.  nchunk[b] counts the
    chunks that hold bucket b's npix[b] pixels."""
    k, rows, ncol = m.shape
    cp = rows // pix.shape[1]
    nch = rows // K_CHUNK

    def plane(x):  # (k, rows, ncol) -> chunk, k block, n block, n, k
        x = x.view(k, nch, K_CHUNK // 8, 8, ncol // 8, 8)
        return x.permute(0, 1, 2, 4, 5, 3).reshape(k, nch, -1)

    hi, lo = split_bf16(m)
    pixels = pix.reshape(k, nch, -1).view(torch.int16)
    rec = torch.cat([plane(hi).view(torch.int16), plane(lo).view(torch.int16),
                     pixels], 2).contiguous()
    return rec, (npix.long() * cp + K_CHUNK - 1) // K_CHUNK


def init_schedule(row_start: torch.Tensor, nchunk: torch.Tensor):
    """The init kernel's schedule (int32): row_start (K + 1), the first
    tile of each bucket and the total (K + 1), nchunk (K).  Block i takes
    tile i: bucket b with tile_start[b] <= i < tile_start[b + 1], rows
    row_start[b] + (i - tile_start[b]) * INIT_TILE onward, at most up to
    row_start[b + 1].  At most N // INIT_TILE + K tiles."""
    tiles = (row_start[1:] - row_start[:-1] + INIT_TILE - 1) // INIT_TILE
    tile_start = torch.cat([tiles.new_zeros(1), torch.cumsum(tiles, 0)])
    return torch.cat([row_start, tile_start, nchunk]).to(torch.int32)


def launch_init(name: str, maps, table, h: int, w: int, num_classes: int,
                scan, class_weights, fold, ctr, perm, row_start,
                num_rot: int):
    """Build M over the K offset tables' fold (fold_pixels), schedule the
    tiles and launch the theta-search kernel `name` (kernels.LAUNCHES key;
    entry tdr_<name>) over the compact map `maps` (table: the K buckets'
    levels, or None at a uniform scale).  row_start (K + 1,) int64: the
    first row of each bucket in perm's order, and N.  Returns (best, k,
    kf) (N,); a name ending in "_raw" launches the raw-row epilogue and
    returns (nums, dens (N, num_rot), kf (N,)): the sums as they are, kf the
    known count times f32(1 / (Th R))."""
    th, r = scan.shape[1:]
    n = ctr.shape[0]
    raw = name.endswith("_raw")
    width = 2 * num_rot + 1 if raw else 3
    out = torch.empty((n, width), dtype=torch.float32, device=ctr.device)
    inv_tr = float(np.float32(1.0) / np.float32(th * r))
    if n:
        pix, npix, order, seg = fold
        m = init_m(scan, class_weights, order, seg, num_rot)
        rec, nchunk = init_operands(pix, npix, m)
        sched = init_schedule(row_start, nchunk)
        cp = channel_pad(num_classes)
        if table is None:
            args = (ptr(maps), h, w, cp)
        else:
            args = (ptr(maps), ptr(table), table.shape[0], cp)
        args += (ptr(rec), ptr(sched), rec.shape[1])
        if perm is not None:
            args += (ptr(perm),)
        kernels.launch("crop_score_init", f"tdr_{name}", *args, ptr(ctr), n,
                       num_rot, ctypes.c_float(inv_tr), ptr(out))
        kernels.LAUNCHES[name] += 1
    if raw:
        s = 2 * num_rot
        return out[:, 0:s:2], out[:, 1:s:2], out[:, s] * inv_tr
    return out[:, 0], out[:, 1].to(torch.int64), out[:, 2]


def _score_init(name, maps, num_classes, stencil, scan, class_weights,
                center_px, f, num_rot, map_resolution):
    """Check the theta search's operands on the card and launch `name`
    (launch_init) at one uniform scale."""
    packed_map = maps.packed
    dev = packed_map.device
    h, w = packed_map.shape[:2]
    _require(packed_map, "packed_map", (h, w, C_PAD), torch.float32, dev)
    check_operands(num_classes, stencil, scan, class_weights, center_px,
                   dev, num_rot)
    compact = maps.compact(num_classes)
    if compact.numel() >= 2**31:
        raise ValueError("map too large for 32-bit indexing")
    rows = torch.zeros(2, dtype=torch.int64, device=dev)
    rows[1] = center_px.shape[0]
    return launch_init(
        name, compact, None, h, w, num_classes, scan, class_weights,
        maps.fold(stencil, f),
        crop_centers(center_px, map_resolution).contiguous(), None, rows,
        num_rot,
    )


def score_init_sel(
    maps: CropMap, num_classes, stencil, scan, class_weights, center_px, f,
    num_rot: int = 40, map_resolution: float = 1.0,
):
    """Theta-search flavour: (best_cost, k (int64), kf) (N,) on
    maps.packed; ties as in the module's docstring.  f as a number lets
    maps keep the stencil's fold (CropMap.fold)."""
    if not kernels.on_card(maps.packed.device, "crop scorer"):
        return score_init_sel_plain(
            maps.packed, num_classes, stencil, scan, class_weights,
            center_px, f, num_rot, map_resolution,
        )
    return _score_init("crop_score_init", maps, num_classes, stencil, scan,
                       class_weights, center_px, f, num_rot, map_resolution)


def score_init_raw(
    maps: CropMap, num_classes, stencil, scan, class_weights, center_px, f,
    num_rot: int = 40, map_resolution: float = 1.0,
):
    """The theta search's raw rows, score_init_raw_plain's contract: (nums,
    dens (N, num_rot), kf (N,)) at the search shifts, nothing divided or
    gated.  A window off the map reads zeros, so a particle centred far
    off it has a row of zeros, as the reference zeroes its out-of-range
    rows.  On the card the same tensor-core product as score_init_sel
    with the raw-row epilogue ("crop_score_init_raw")."""
    if not kernels.on_card(maps.packed.device, "crop scorer"):
        return score_init_raw_plain(
            maps.packed, num_classes, stencil, scan, class_weights,
            center_px, f, num_rot, map_resolution,
        )
    return _score_init("crop_score_init_raw", maps, num_classes, stencil,
                       scan, class_weights, center_px, f, num_rot,
                       map_resolution)
