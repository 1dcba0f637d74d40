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
run of one shift among its rows, and with the hi/lo M each shift's rows
by the position of their centres (tracked_order; with the single-plane
M by shift alone, tracked_rows): a row whose stencil lies inside its level
reads its pixels without a bounds check, two such rows a warp.  The fold
of the offsets to distinct pixels and their cells, which both kernels
read, is a kernel of its own (fold_pixels, one launch; fold_offsets is
its plain version), and a CropMap keeps the last fold for a scale f
given as a number, so the filter folds its stencil once per map and
scale.  tracked_weights and folded_scores are the tracked kernel's
computation in plain PyTorch, for the CPU tests.

Both wrappers take the map as a CropMap: the packed map at one mip level
with its compact copy, made once and kept beside it.

The nibble-packed map (TDR_MAP_INT4=1, the JAX package's
pallas_score.map_int4).  A CropMap made with int4=True (the filter's
map_int4, or TDR_MAP_INT4=1 when the filter is made with None) scores
the map quantized as the JAX package's quantize_channels_int4 quantizes
it: per
channel amax over the packed map, 15 levels on even channels and 7 on
odd ones, codes = round(v * qmax / amax) clipped to [0, qmax], and
dequantized as code * qinv, qinv = amax / qmax.  The known channel's
{0, 1} comes back exact on either parity, so kf is the float map's.  Its
kernels read the compact code map (codes(num_classes): (..., CP/2) uint8,
byte j holding channel 2j in its low nibble and 2j + 1 in its high one,
2 bytes a pixel at C = 3 where the float compact map takes 16), each
pixel's bytes in one load, and are counted under the float kernels'
names with "_i4" appended.  The tracked one turns each code into code *
qinv in float32 (one rounding, as dequantize_int4) and runs the float
kernel's arithmetic on it; the theta search multiplies the codes, exact
in bf16, by M with qinv folded into its rows (fold_qinv; its chunks'
rows reordered so that each thread loads whole pixels,
code_chunk_order), two products a step where the float map takes three.
The plain versions score dequantize_int4 of the same codes
(CropMap.plain): kernel and plain version differ in the order of their
float32 sums (and, in the theta search, where qinv enters; rel 1e-4),
kf bit for bit.  The conv path's map (CropMap.compact) stays float32 either
way, as the JAX conv field reads the unquantized map.  The tracked code
kernel (with the hi/lo M) takes its rows in tracked_order, as the float
one does, and each block stages its window of codes in shared memory
where it fits (WINDOW_BUDGET, tracked_window_cap); tracked_windows is
the rule in plain PyTorch.
Every theta search, on either map and with either M (below), takes its
rows in init_order, each bucket's by the position of their centres, and
a warp whose rows' windows all lie in their level (fold_extent) gathers
without bounds checks.  All three orders (tracked_order, tracked_rows,
init_order) are order_rows: on the card one launch of the order kernel,
which computes the keys, sorts them stably and writes the permutation in
the index type the crop kernel reads and, for init_order, each bucket's
first row (order_rows_plain, a torch.sort and a searchsorted, is its
plain version).

The single-plane M (TDR_M_HILO=0, the JAX package's pallas_score.m_hilo()
off).  The JAX kernel contracts its int8 map against M quantized per
(variant, column) to int8: by default a hi and a lo plane (~16 bits of M,
which the port's float M keeps); with a CropMap made with m_hilo=False (the
filter's m_hilo, or TDR_M_HILO=0 when the filter is made with None) one
plane, only the kf column keeping a lo residual in the structurally zero
column KF_COL + 1 (the "lokf" scheme).  That is a different function (cost
off by ~0.5 %), which the port computes as JAX does (quantize_lokf): each
stencil cell's coefficient times the qinv of JAX's map quantization
(m_qinv: int8_qinv for the float map, the code map's qinv) rounded to
bf16, summed per pixel (exactly, in float64), the column's amax times (1 +
2^-8) / 127 its scale s, the integers round(bf16(sum) / s) clipped to
+-127.  On the code map the table holds the e-dot identity's rows (Me -
Mo/16 | Mo/16), whose integers come back as weights q_e + q_b on the even
channel's code and 16 q_b on the odd one.  The theta search takes one B
plane of those integers (two products a k16 step on the float map, the
window times 1/qinv split into bf16 hi and lo; one on the codes) and
scales each column in its epilogue (init_m_lokf's scales).  The tracked
kernel's weights come from one launch of the weights pass first
(tracked_table): every (bucket, shift)'s integers (K, Th, C + 3, P) int16,
rounded the same way, and its scales (K, Th, 4); the kernel copies each
run's slab of them into shared memory and dequantizes it
(tracked_lokf_weights' arithmetic).  Their entry points carry "_lokf" last;
the plain versions take m_hilo=False and score the dequantized
single-plane M.

The crop-size buckets and the mip fallback are kept in the host dispatch
(filter/filter.py) so that both packages score the same map at the same
state; neither kernel needs a crop buffer.
"""

from __future__ import annotations

import ctypes
import os
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
# slabs of the weights table in a single-plane tracked block's ring
# (csrc/crop_tracked.cuh's kSlabs)
LOKF_SLABS = 1
# dynamic shared memory of a code tracked block that stages windows: up to
# the first where its layout at stride P fits it (two blocks an SM), else
# up to the second (csrc/crop_score.cu's kTwoBlockSmem, kOneBlockSmem)
TRACKED_SMEM_TWO = 111 * 1024
TRACKED_SMEM_ONE = 225 * 1024
# the most bytes a code tracked block's window of codes may take, read by
# launch_tracked at each call: all its shared memory leaves (0 sends every
# block's gather to L2, as the tests and chip_smoke do to compare routes)
WINDOW_BUDGET = SMEM_LIMIT
PAD_PIX = 2**29  # (dy, dx) of a padding pixel: outside every map
_KEY_BITS = 22  # bits per offset in fold_offsets' sort key

# crop-size buckets keyed by the max stencil pixel offset mo
_MO_BUCKETS = (12, 24)
# the conv path's (filter/conv_score.py): its kernel has no crop buffer to
# bound, so it covers larger range scales (its size grows with mo^2)
_MO_BUCKETS_CONV = (12, 24, 36, 48)

# quantize_channels_int4's levels: 15 on even channels, 7 on odd ones (the
# JAX kernel keeps each packed byte <= 127 for its e-dot contraction)
I4_QMAX = (15.0, 7.0) * (C_PAD // 2)


def map_int4() -> bool:
    """TDR_MAP_INT4=1: a ParticleFilter made with map_int4=None scores the
    nibble-packed map (the JAX package's pallas_score.map_int4)."""
    return os.environ.get("TDR_MAP_INT4", "0") == "1"


def m_hilo() -> bool:
    """TDR_M_HILO (default 1): a ParticleFilter made with m_hilo=None
    scores M's hi/lo pair, or with TDR_M_HILO=0 its single plane (the
    JAX package's pallas_score.m_hilo)."""
    return os.environ.get("TDR_M_HILO", "1") == "1"


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


def _uniform_lokf(packed_map, num_classes, stencil, center_px, f,
                  map_resolution, qinv):
    """A uniform map as the single-plane plain versions take it: (compact
    (H*W, CP), table (1, 4), centres (N, 2), bucket (N,) zeros, the fold
    of the offsets at f, qinv: int8_qinv of the map where None)."""
    h, w = packed_map.shape[:2]
    dev = packed_map.device
    ctr = crop_centers(center_px, map_resolution).to(dev)
    fold = fold_offsets(crop_offsets(stencil, f).to(dev)[None])
    qinv = int8_qinv(packed_map) if qinv is None else qinv
    return (compact_map(packed_map, num_classes).reshape(h * w, -1),
            torch.tensor([[0, h, w, 0]], dtype=torch.int32, device=dev), ctr,
            torch.zeros(ctr.shape[0], dtype=torch.int32, device=dev), fold,
            qinv)


def score_init_raw_plain(
    packed_map, num_classes, stencil, scan, class_weights, center_px, f,
    num_rot: int = 40, map_resolution: float = 1.0, chunk_size: int = 4096,
    m_hilo: bool = True, qinv=None, int4: bool = False,
):
    """(nums (N, num_rot), dens (N, num_rot), kf (N,)) at the search
    shifts: the parity surface of the theta-search flavour.  m_hilo=False:
    the single-plane M's (lokf_init_rows; qinv the map quantization's,
    int8_qinv(packed_map) when None; int4: the code map's table, packed_map
    then its dequantized codes)."""
    if not m_hilo:
        compact, table, ctr, bucket, fold, qinv = _uniform_lokf(
            packed_map, num_classes, stencil, center_px, f, map_resolution,
            qinv)
        return lokf_init_rows(compact, table, ctr, bucket, fold, scan,
                              class_weights, num_rot, qinv, int4,
                              num_classes, chunk_size)
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
    m_hilo: bool = True, qinv=None, int4: bool = False,
):
    """Plain version of the tracked flavour: (cost, norm, kf) (N,).
    m_hilo=False: the single-plane M's (lokf_tracked_scores; qinv and int4
    as score_init_raw_plain's)."""
    th = scan.shape[1]
    if not m_hilo:
        compact, table, ctr, bucket, fold, qinv = _uniform_lokf(
            packed_map, num_classes, stencil, center_px, f, map_resolution,
            qinv)
        return lokf_tracked_scores(
            compact, table, ctr, bucket, rotation_shift(theta, th).to(
                ctr.device), fold, scan, class_weights, qinv, int4,
            num_classes, chunk_size)
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
    m_hilo: bool = True, qinv=None, int4: bool = False,
):
    """Plain version of the theta-search flavour: (best_cost, k, kf)."""
    nums, dens, kf = score_init_raw_plain(
        packed_map, num_classes, stencil, scan, class_weights, center_px,
        f, num_rot, map_resolution, chunk_size, m_hilo, qinv, int4,
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
                  theta, dev, m_hilo: bool = True):
    """The checks both tracked wrappers share: the crop operands, the
    block's shared memory (tracked_smem; with the single-plane M,
    m_hilo False, its kernel's and its weights pass's) and theta: (C, Th,
    R)."""
    c, th, r = check_operands(num_classes, stencil, scan, class_weights,
                              center_px, dev)
    smem = tracked_smem(c, th * r, 0 if m_hilo else LOKF_SLABS)
    if smem > SMEM_LIMIT:
        raise ValueError(f"scan window needs {smem} B of shared memory")
    _require(theta, "theta", (center_px.shape[0],), torch.float32, dev)
    return c, th, r


def _tracked_inputs(maps, num_classes, stencil, scan, class_weights,
                    center_px, theta, f, map_resolution):
    """Check the tracked kernel's operands and derive its inputs on their
    device: (the map operand (CropMap.operand: the compact map, or the code
    map of a nibble-packed one), the stencil's fold at f (CropMap.fold),
    centres (N, 2), shifts (N,))."""
    packed = maps.packed
    dev = packed.device
    h, w = packed.shape[:2]
    _require(packed, "packed_map", (h, w, C_PAD), torch.float32, dev)
    th = check_tracked(num_classes, stencil, scan, class_weights,
                       center_px, theta, dev, maps.m_hilo)[1]
    operand = maps.operand(num_classes)
    if operand.numel() >= 2**31:
        raise ValueError("map too large for 32-bit indexing")
    return (operand, maps.fold(stencil, f),
            crop_centers(center_px, map_resolution).contiguous(),
            rotation_shift(theta, th))


def score_tracked(
    maps, num_classes, stencil, scan, class_weights, center_px, theta, f,
    map_resolution: float = 1.0,
):
    """Tracked flavour: (cost, norm, kf) (N,) at each particle's own
    rotation shift on maps (a CropMap: its packed map, or its codes where
    maps.int4, "crop_score_tracked_i4" on the card); cost/norm is the
    particle's cost.  f as a number lets maps keep the stencil's fold
    (CropMap.fold)."""
    if not kernels.on_card(maps.packed.device, "crop scorer"):
        return score_tracked_plain(
            maps.plain(num_classes).packed, num_classes, stencil, scan,
            class_weights, center_px, theta, f, map_resolution,
            **maps.plain_m(),
        )
    _, fold, ctr, shift = _tracked_inputs(
        maps, num_classes, stencil, scan, class_weights, center_px, theta,
        f, map_resolution,
    )
    h, w = maps.packed.shape[:2]
    return launch_tracked("crop_score_tracked", maps, None, h, w,
                          num_classes, scan, class_weights, fold, ctr, shift)


# -- the tracked kernel's operands ---------------------------------------
def tracked_smem(num_classes: int, tr: int, slabs: int = 0,
                 npix: int | None = None) -> int:
    """Bytes of shared memory of a tracked kernel block: the pixel offsets
    (S int2), the folded weights (C + 2, S) and the scan tables (C + 1,
    Th*R) float32 at the stride S = P, Th*R rounded up to 16 (fold_offsets):
    110,336 at C = 3, Th*R = 2,500.  npix, the fold's largest count of
    distinct pixels: the code kernel's tight layout, S = npix rounded up to
    8 (84,352 at npix 1,577; 53,888 at 489), whose end rounded up to 16 is
    where its window starts (tracked_window_cap).  slabs > 0: the
    single-plane kernel's, `slabs` slabs of the weights table (C + 3, P)
    int16, each with its scales and mbarrier, in place of the scan tables,
    or its weights pass's block where that takes more: the sums (C + 1, P)
    float32, the cells and segment starts (Th*R + P + 1 int32) and the
    coefficients (C + 1, Th*R) bf16."""
    c = num_classes
    cap = -(-tr // 16) * 16
    stride = cap if npix is None else -(-npix // 8) * 8
    head = stride * 8 + (c + 2) * stride * 4
    if not slabs:
        return head + (c + 1) * tr * 4
    return max(head + slabs * ((c + 3) * cap * 2 + 24),
               (c + 1) * cap * 4 + (tr + cap + 1) * 4 + (c + 1) * tr * 2)


def tracked_launch_smem(num_classes: int, tr: int, budget: int) -> int:
    """Dynamic shared memory of a launch of the code tracked kernel
    (csrc/crop_score.cu, window_smem): its layout at stride P
    (tracked_smem), and with a budget the bytes up to TRACKED_SMEM_TWO
    where that layout fits it (two blocks an SM), else up to
    TRACKED_SMEM_ONE, at most the budget more."""
    fixed = tracked_smem(num_classes, tr)
    if budget <= 0:
        return fixed
    lim = TRACKED_SMEM_TWO if fixed <= TRACKED_SMEM_TWO else TRACKED_SMEM_ONE
    return max(fixed, min(fixed + budget, lim))


def tracked_window_cap(num_classes: int, tr: int, npix: int,
                       budget: int) -> int:
    """The bytes a code tracked block has for its window of codes: those
    of its launch (tracked_launch_smem) past its tight layout at the fold's
    largest npix (tracked_smem, rounded up to 16), at most the budget:
    29,312 at C = 3, Th*R = 2,500 and npix 1,577 (two blocks an SM);
    59,776 at npix 489; 97,040 at C = 6, npix 1,577 (one block an SM);
    0 at budget 0."""
    start = -(-tracked_smem(num_classes, tr, npix=npix) // 16) * 16
    return max(0, min(budget,
                      tracked_launch_smem(num_classes, tr, budget) - start))


def tracked_rows(key: torch.Tensor):
    """The particles in stable order of their group keys (bucket * Th +
    shift): (sorted keys int32, perm int64) (N,).  Block i of the tracked
    kernel takes sorted rows [i T, (i + 1) T), T = TRACKED_TILE, and
    scores each run of one key among them with that group's folded
    weights; row j's result goes to particle perm[j].  order_rows with
    kshift 0 and no Morton bits: one launch of the order kernel on the
    card, no host read."""
    return order_rows(key, None, 0, 0)[:2]


def order_bits(groups: int, extent: int):
    """(kshift, tbits) of tracked_order for `groups` groups on levels of at
    most `extent` pixels a side: the group in the bits of a non-negative
    int32 from kshift up, and the kshift = 2a bits below it the Morton
    code of the centre's tile, 2^tbits pixels a side, so that 2^a tiles
    a side cover the extent."""
    kshift = 2 * ((31 - max(1, (groups - 1).bit_length())) // 2)
    return kshift, max(0, (extent - 1).bit_length() - kshift // 2)


def tracked_order(key: torch.Tensor, ctr: torch.Tensor, groups: int,
                  extent: int):
    """The hi/lo tracked kernels' rows: the particles in stable order of
    their group keys (bucket * Th + shift < groups) and, within a group,
    of the Morton code of their centre's tile on its level (ctr (N, 2)
    int32 (cy, cx), clamped into the tiles; extent bounds the levels'
    sides; order_bits), so that a block's rows lie close together (their
    windows meet in L1, and the code kernel's staged window is small).
    Returns (sorted keys int32: the group in the bits from kshift up, the
    Morton code below; perm int64, kshift): order_rows, one launch on the
    card; tracked_order_plain is its numpy twin.  Each particle's score is
    its own: the order changes no bit of the output."""
    return order_rows(key, ctr, groups, extent)[:3]


ORDER_TILE = 2048  # rows a tile of the order kernel (kOrderTile)
ORDER_COUNTERS = 2050  # 32-bit words of one set of its counters
ORDER_MAX_GROUPS = 1024  # groups of row_start at most (kMaxStartGroups)
_ORDER_EPOCHS = 2**28  # its status words hold epochs below this
# (device index, stream) -> [scratch int32, last epoch]
_order_scratch = {}


def order_scratch_words(n: int) -> int:
    """The order kernel's scratch for n rows, in 32-bit words: two sets of
    counters and a 64-bit status word a (tile, digit).  It holds nothing
    else, so a word of an earlier call never reads as this call's."""
    return 2 * ORDER_COUNTERS + 2 * 256 * -(-n // ORDER_TILE)


def _order_status(dev: torch.device, stream, n: int):
    """The order kernel's scratch on this device and stream, [tensor, last
    epoch]: zeroed once when made (or grown, or when the epochs run out);
    the caller takes the next epoch and records it once its launch went
    out, so that status words and counters of earlier calls read as
    unpublished and nothing is reset between calls."""
    key = (dev.index, stream.cuda_stream)
    ent = _order_scratch.get(key)
    words = order_scratch_words(n)
    if ent is None or ent[0].numel() < words or ent[1] + 1 >= _ORDER_EPOCHS:
        ent = [torch.zeros(words, dtype=torch.int32, device=dev), 0]
        _order_scratch[key] = ent
    return ent


def order_rows(key: torch.Tensor, ctr, groups: int, extent: int, *,
               index_dtype=torch.int64, starts: bool = False):
    """The crop kernels' row order: the particles in stable order of their
    keys, each group key (N,) int32 or int64 in the bits from kshift up
    and, below it, the Morton code of the centre's tile (ctr (N, 2) int32
    (cy, cx); order_bits(groups, extent) gives kshift and the tiles;
    order_keys_plain), or with ctr None the group keys alone as int32
    (kshift 0).  Returns (sorted keys (N,) int32, perm (N,) index_dtype
    (int64 for the tracked kernels, int32 for the theta searches), kshift,
    row_start): with starts, row_start (groups + 1,) int64 is each group's
    first row and N (groups <= ORDER_MAX_GROUPS), else None.

    On the card one allocation and one launch of the order kernel
    (csrc/crop_score.cu, crop_order_kernel, counted as "crop_order"): the
    keys, a stable radix sort of them and the groups' first rows, bit for
    bit order_rows_plain's; on the CPU order_rows_plain itself."""
    dev = key.device
    if not kernels.on_card(dev, "row order"):
        return order_rows_plain(key, ctr, groups, extent,
                                index_dtype=index_dtype, starts=starts)
    n = key.shape[0]
    if key.dtype not in (torch.int32, torch.int64) or key.shape != (n,):
        raise TypeError("the group keys must be an (N,) int32 or int64")
    if index_dtype not in (torch.int32, torch.int64):
        raise TypeError(f"no row order with {index_dtype} indices")
    if starts and not 1 <= groups <= ORDER_MAX_GROUPS:
        raise ValueError(f"row_start of {groups} groups is out of range")
    key = key.contiguous()
    kshift, tbits = (0, 0) if ctr is None else order_bits(groups, extent)
    if ctr is not None:
        _require(ctr, "ctr", (n, 2), torch.int32, dev, contiguous=True)
    k = groups if starts else 0
    wide = index_dtype == torch.int64
    # one buffer of int32 words: row_start (int64), the kernel's two
    # buffers of n (key, row) pairs, perm, the sorted keys
    sizes = (2 * (k + 1) if starts else 0, 4 * n, (2 if wide else 1) * n, n)
    row_start, pairs, perm, skey = torch.empty(
        sum(sizes), dtype=torch.int32, device=dev).split(sizes)
    row_start = row_start.view(torch.int64) if starts else None
    perm = perm.view(torch.int64) if wide else perm
    stream = torch.cuda.current_stream(dev)
    status = _order_status(dev, stream, n)
    scratch, epoch = status[0], status[1] + 1
    kernels.launch(
        "crop_score", "tdr_crop_order", ptr(key), key.element_size(),
        None if ctr is None else ptr(ctr), n, kshift, tbits,
        (1 << (kshift // 2 + tbits)) - 1, k, ptr(skey), ptr(perm),
        perm.element_size(), ptr(row_start) if starts else None,
        ptr(scratch), scratch.numel(), ptr(pairs), ctypes.c_uint(epoch),
        stream=stream)
    status[1] = epoch
    kernels.LAUNCHES["crop_order"] += 1
    return skey, perm, kshift, row_start


def order_rows_plain(key, ctr, groups: int, extent: int, *,
                     index_dtype=torch.int64, starts: bool = False):
    """order_rows in eager PyTorch: order_keys_plain's keys (the group keys
    as int32 where ctr is None), one stable sort, and with starts
    searchsorted of each group's first key, then N."""
    if ctr is None:
        kshift, keys = 0, key.to(torch.int32)
    else:
        kshift, tbits = order_bits(groups, extent)
        keys = order_keys_plain(key, ctr, kshift, tbits)
    skey, perm = torch.sort(keys, stable=True)
    row_start = None
    if starts:  # group g's first key, g < groups: (groups - 1) << kshift
        first = torch.arange(groups, dtype=torch.int32,  # fits an int32
                             device=key.device) << kshift
        row_start = torch.cat([torch.searchsorted(skey, first),
                               first.new_full((1,), skey.shape[0]).long()])
    return skey, perm.to(index_dtype), kshift, row_start


def order_keys_plain(key, ctr, kshift: int, tbits: int) -> torch.Tensor:
    """order_rows' keys before the sort, (N,) int32, in eager PyTorch: the
    group keys (N,) shifted to the bits from kshift up, and below them
    the Morton code of the centre's tile (ctr (N, 2) int32 (cy, cx),
    clamped into the tiles, >> tbits), its bits interleaved one by one
    (the row's at the odd positions)."""
    tile = ctr.clamp(0, (1 << (kshift // 2 + tbits)) - 1) >> tbits
    out = key.to(torch.int32) << kshift
    for i in range(kshift // 2):
        out |= ((tile[:, 0] >> i) & 1) << (2 * i + 1)
        out |= ((tile[:, 1] >> i) & 1) << (2 * i)
    return out


def tracked_order_plain(key, ctr, groups: int, extent: int):
    """tracked_order in numpy, by a lexicographic sort of (group, Morton
    code of the centre's tile, particle) with the bits interleaved one by
    one: (sorted keys int32, perm int64, kshift)."""
    key = np.asarray(key, np.int64)
    ctr = np.asarray(ctr, np.int64)
    kshift, tbits = order_bits(groups, extent)
    a = kshift // 2
    tile = np.clip(ctr, 0, (1 << (a + tbits)) - 1) >> tbits
    morton = np.zeros(len(key), np.int64)
    for i in range(a):
        morton |= ((tile[:, 0] >> i) & 1) << (2 * i + 1)
        morton |= ((tile[:, 1] >> i) & 1) << (2 * i)
    perm = np.lexsort((np.arange(len(key)), morton, key))
    return ((key[perm] << kshift) | morton[perm]).astype(np.int32), perm, \
        kshift


def tracked_windows(skey, perm, ctr, kshift: int, th: int, levels, fold,
                    pixels: int, elem: int, cap: int) -> dict:
    """The code tracked kernel's window rule, in plain PyTorch: for each
    block (TRACKED_TILE sorted rows) and bucket among its rows, the box of
    their centres (ctr (N, 2), the particles') +- the extent of the
    bucket's distinct pixels (fold's pix[:npix]), clipped to its level
    (levels (K, 4): pixel offset, H, W, -), and whether the block stages it
    (csrc/crop_tracked.cuh, stage_window): the box is not empty, its rows
    at the pitch (its columns' elem bytes + 30 rounded up to 16, plus the
    level's row bytes mod 16) and 16 bytes more take at most cap bytes
    (tracked_window_cap), and the 16-byte word of the code buffer (pixels
    of elem bytes) that holds its last byte lies in the buffer.  Returns
    {block, bucket, rows (the block's rows of the bucket), y0, y1, x0, x1
    (empty where y0 > y1 or x0 > x1), pitch, bytes, staged}, tensors of
    one entry a window, in order."""
    pix, npix = fold[0].long(), fold[1].long()
    k = pix.shape[0]
    n = skey.shape[0]
    bucket = (skey.long() >> kshift) // th
    seg = torch.arange(n, device=skey.device) // TRACKED_TILE * k + bucket
    ids, inv, rows = torch.unique_consecutive(seg, return_inverse=True,
                                              return_counts=True)
    c = ctr.long()[perm]
    big = 1 << 40

    def reduce(v, how):
        init = big if how == "amin" else -big
        return torch.full(ids.shape, init, dtype=torch.long,
                          device=v.device).scatter_reduce(0, inv, v, how)

    live = torch.arange(pix.shape[1], device=pix.device) < npix[:, None]
    lo = torch.where(live[..., None], pix, big).amin(1)[ids % k]
    hi = torch.where(live[..., None], pix, -big).amax(1)[ids % k]
    lv = levels.long()[ids % k]
    y0 = (reduce(c[:, 0], "amin") + lo[:, 0]).clamp(min=0)
    y1 = torch.minimum(reduce(c[:, 0], "amax") + hi[:, 0], lv[:, 1] - 1)
    x0 = (reduce(c[:, 1], "amin") + lo[:, 1]).clamp(min=0)
    x1 = torch.minimum(reduce(c[:, 1], "amax") + hi[:, 1], lv[:, 2] - 1)
    some = (y0 <= y1) & (x0 <= x1)
    pitch = ((x1 - x0 + 1) * elem + 45) // 16 * 16 + lv[:, 2] * elem % 16
    need = (y1 - y0 + 1) * pitch + 16
    last = (lv[:, 0] + y1 * lv[:, 2] + x1 + 1) * elem
    staged = (some & (cap > 0) & (need <= cap)
              & ((last + 15) // 16 * 16 <= pixels * elem))
    return {"block": ids // k, "bucket": ids % k, "rows": rows, "y0": y0,
            "y1": y1, "x0": x0, "x1": x1, "pitch": pitch,
            "bytes": torch.where(some, need, 0), "staged": staged}


def staged_share(windows: dict):
    """(the share of tracked_windows' windows staged, the share of the
    rows they hold)."""
    staged = windows["staged"]
    if not staged.numel():
        return 0.0, 0.0
    rows = windows["rows"]
    return (float(staged.float().mean()),
            float(rows[staged].sum() / rows.sum()))


def fold_pixels(off: torch.Tensor):
    """The distinct pixels of the offset tables off (K, Th*R, 2) int32 and
    the CSR of their cells: (pix, npix, order, seg), as fold_offsets
    returns them.  On the card one launch of the fold kernel
    (csrc/crop_score.cu, counted as "crop_fold"; one block a table, a
    stable radix sort of the cells by their index in the table's box,
    Th*R <= 16,384) writes them into one buffer, bit for bit
    fold_offsets'; on the CPU it is fold_offsets itself."""
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


def check_map_operand(int4: bool, operand, qinv, num_classes: int) -> None:
    """The map operand a crop entry point takes: a code entry ("..._i4",
    int4) the code map (..., CP/2) uint8 with qinv (8,) float32, a float
    entry the compact map (..., CP) float32 and no qinv; both contiguous.
    A float map given to a code entry, or codes to a float entry, raise."""
    cp = channel_pad(num_classes)
    kind = "a code" if int4 else "a float"
    want = (torch.uint8, cp // 2) if int4 else (torch.float32, cp)
    if (operand.dtype, operand.shape[-1]) != want:
        raise TypeError(
            f"{kind} entry takes a map of {want[1]} {want[0]} a pixel, got "
            f"{operand.shape[-1]} {operand.dtype}")
    if not operand.is_contiguous():
        raise ValueError(f"{kind} entry's map operand must be contiguous")
    if int4:
        _require(qinv, "qinv", (C_PAD,), torch.float32, operand.device,
                 contiguous=True)
    elif qinv is not None:
        raise TypeError("a float entry takes no qinv: its map is float32")


def entry_name(base: str, maps, raw: bool = False) -> str:
    """The crop entry point `base` takes for maps (a CropMap or
    PyramidMaps): "<base>[_raw][_i4][_lokf]", "_i4" on a nibble-packed
    map, "_lokf" with the single-plane M (maps.m_hilo False); its
    kernels.LAUNCHES key and, as tdr_<name>, its C entry."""
    return base + "_raw" * raw + "_i4" * maps.int4 + "_lokf" * (
        not maps.m_hilo)


def map_operand(maps, num_classes: int):
    """(operand, qinv) the crop kernels read for maps (a CropMap or
    PyramidMaps): its code map and qinv where maps.int4, else its compact
    map and None; checked (check_map_operand)."""
    operand = maps.operand(num_classes)
    qinv = maps.qinv if maps.int4 else None
    check_map_operand(maps.int4, operand, qinv, num_classes)
    if not maps.m_hilo:
        _require(maps.m_qinv, "m_qinv", (C_PAD,), torch.float32,
                 operand.device, contiguous=True)
    return operand, qinv


def launch_tracked(base: str, maps, table, h: int, w: int, num_classes: int,
                   scan, class_weights, fold, ctr, key):
    """Sort the particles by group key (bucket * Th + shift) and launch
    the tracked kernel entry_name(base, maps) over maps' operand
    (map_operand: the compact map, or the code map with its qinv; table:
    the K buckets' levels, or None at a uniform scale) with the K offset
    tables' fold (fold_pixels).  With the single-plane M (maps.m_hilo
    False) the kernel takes maps.m_qinv and the weights table and scales
    of every (bucket, shift) (tracked_table, one launch before it) in
    place of the scan, the class weights and the CSR.  With the hi/lo M
    the rows go in tracked_order (each group's by position), and the
    kernel takes the keys' group shift: a row inside its level skips the
    bounds check, two a warp.  On the code map the kernel also stages each
    block's window of codes in shared memory where it fits, at most
    WINDOW_BUDGET bytes (read at each call; 0: no block does).  Returns
    (cost, norm, kf) (N,)."""
    name = entry_name(base, maps)
    operand, qinv = map_operand(maps, num_classes)
    th, r = scan.shape[1:]
    n = ctr.shape[0]
    out = torch.empty((n, 3), dtype=torch.float32, device=ctr.device)
    if n:
        pix, npix, order, seg = fold
        window = maps.int4 and maps.m_hilo
        tail = ()
        if maps.m_hilo:  # the rows by position, and the keys' group shift
            skey, perm, kshift = tracked_order(key, ctr, pix.shape[0] * th,
                                               _level_extent(maps, h, w))
            tail = (kshift,)
        else:
            skey, perm = tracked_rows(key)
        if window:  # the code kernel's budget
            budget = int(WINDOW_BUDGET)
            if budget and operand.data_ptr() % 16:
                raise ValueError("a code map whose window is staged must "
                                 "start on a 16-byte boundary")
            tail += (budget,)
        inv_tr = float(np.float32(1.0) / np.float32(th * r))
        # kept alive until the asynchronous launch has read them
        scan, class_weights = scan.contiguous(), class_weights.contiguous()
        level = (h, w) if table is None else (ptr(table), table.shape[0])
        if window and table is not None:  # the code pyramid's pixels
            level += (operand.shape[0],)
        rows = (ptr(skey), ptr(perm), ptr(ctr), n, ctypes.c_float(inv_tr),
                ptr(out), *tail)
        if maps.m_hilo:
            head = (ptr(operand),) + ((ptr(qinv),) if maps.int4 else ())
            args = (*head, *level, num_classes, ptr(scan),
                    ptr(class_weights), ptr(pix), ptr(npix), ptr(order),
                    ptr(seg), th, r, pix.shape[1], *rows)
        else:  # the weights table and scales of every shift
            wtab, scales = tracked_table(scan, class_weights, maps.m_qinv,
                                         fold, num_classes, maps.int4)
            args = (ptr(operand), ptr(maps.m_qinv), ptr(wtab), ptr(scales),
                    *level, num_classes, ptr(pix), ptr(npix), th,
                    pix.shape[1], *rows)
        kernels.launch("crop_score", f"tdr_{name}", *args)
        kernels.LAUNCHES[name] += 1
    return out[:, 0], out[:, 1], out[:, 2]


def _level_extent(maps, h: int, w: int) -> int:
    """The longest side of maps' levels: h, w of a CropMap, or a
    pyramid's largest level."""
    levels = getattr(maps, "levels", ((0, h, w),))
    return max(max(lv[1:]) for lv in levels)


def launch_windows(maps, table, h: int, w: int, num_classes: int, scan,
                   fold, ctr, key, budget=None) -> dict:
    """The windows a code tracked launch (launch_tracked's arguments, on a
    code map with the hi/lo M) stages at `budget` (default WINDOW_BUDGET):
    tracked_windows on its rows in tracked_order, at the bytes its blocks
    have (tracked_window_cap).  Reads the fold's npix to the host."""
    pix, npix = fold[:2]
    th, r = scan.shape[1:]
    operand = maps.operand(num_classes)
    skey, perm, kshift = tracked_order(key, ctr, pix.shape[0] * th,
                                       _level_extent(maps, h, w))
    if table is None:
        table = torch.tensor([[0, h, w, 0]], dtype=torch.int32,
                             device=ctr.device)
    budget = int(WINDOW_BUDGET if budget is None else budget)
    cap = tracked_window_cap(num_classes, th * r, int(npix.max()), budget)
    flat = operand.reshape(-1, operand.shape[-1])
    return tracked_windows(skey, perm, ctr, kshift, th, table, fold,
                           flat.shape[0], flat.shape[1], cap)


def tracked_table(scan, class_weights, qinv, fold, num_classes: int,
                  int4: bool):
    """The single-plane tracked weights of every (bucket, shift): (table
    (K, Th, C + 3, P) int16, scales (K, Th, 4) float32), tracked_lokf's
    integers and scales (qinv the map quantization's, int4 the code map's
    table) with each group's C + 3 rows of P pixels contiguous, the slab
    the tracked kernel copies.  On the card one launch of the weights pass
    (csrc/crop_score.cu, counted as "crop_lokf_weights": each group folded
    once, float64 sums, its amax, scales and integers), which writes each
    row's first npix[b] entries rounded up to 8 (zeros past npix[b]) and
    leaves the rest of the row unwritten; on the CPU tracked_lokf itself,
    every entry written."""
    pix, npix, order, seg = fold
    c, th, r = scan.shape
    k, cap = pix.shape[:2]
    if not kernels.on_card(scan.device, "weights pass"):
        w, s = tracked_lokf(tracked_weights(scan, class_weights, order, seg,
                                            qinv), int4, c)
        return w.transpose(-1, -2).to(torch.int16).contiguous(), s
    _require(qinv, "qinv", (C_PAD,), torch.float32, scan.device,
             contiguous=True)
    scan, class_weights = scan.contiguous(), class_weights.contiguous()
    table = torch.empty((k, th, c + 3, cap), dtype=torch.int16,
                        device=scan.device)
    scales = torch.empty((k, th, 4), dtype=torch.float32, device=scan.device)
    kernels.launch("crop_score", "tdr_crop_lokf_weights", ptr(scan),
                   ptr(class_weights), ptr(qinv), c, int(int4), ptr(npix),
                   ptr(order), ptr(seg), k, th, r, cap, ptr(table),
                   ptr(scales))
    kernels.LAUNCHES["crop_lokf_weights"] += 1
    return table, scales


def tracked_scales(scan, class_weights, qinv, fold, num_classes: int,
                   int4: bool) -> torch.Tensor:
    """(K, Th, 4) float32: the single-plane tracked weights' scales of
    every (bucket, shift), tracked_table's (one launch of the weights pass
    on the card; tracked_lokf's on the CPU)."""
    return tracked_table(scan, class_weights, qinv, fold, num_classes,
                         int4)[1]


def cell_slots(seg: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) int64: the slot of each position of a CSR with segment starts
    seg, n = seg[-1] entries."""
    pos = torch.arange(n, device=seg.device)
    return torch.searchsorted(seg.long(), pos, right=True) - 1


def tracked_weights(scan, class_weights, order, seg, qinv=None):
    """The tracked kernel's folded weights at every shift, in plain
    PyTorch: (K, Th, P, C + 2) float32 over fold_offsets' CSR (order, seg)
    of K offset tables.  w[b, s, u] holds, for pixel u of table b at shift
    s, the sums over the pixel's cells i of the weighted scan 0.01 w_c
    scan_c (C cost weights) and of its class sum (the norm weight) at scan
    cell (i + s R) mod Th R, and the count of those cells (the kf weight);
    summed in float64, so that their order does not change the result.
    With qinv (the single-plane M, tracked_lokf) each cell's value is first
    multiplied by qinv of its channel (qinv[C] for the norm and the count)
    and rounded to bf16, as the JAX package's M build rounds it."""
    c, th, r = scan.shape
    tr = th * r
    nslot = seg.shape[0] - 1
    k = order.shape[0] // tr
    dev = scan.device
    wscan = (scan * (0.01 * class_weights)[:, None, None]).reshape(c, tr)
    feat = torch.cat([wscan.T, class_sum(scan).reshape(tr, 1),
                      torch.ones((tr, 1), device=dev)], 1)
    if qinv is not None:
        mult = torch.cat([qinv[:c], qinv[c:c + 1].expand(2)])
        feat = (feat * mult).to(torch.bfloat16)
    feat = feat.double()
    slot = cell_slots(seg, order.shape[0])
    cell = order.long() % tr
    w = torch.zeros((th, nslot, c + 2), dtype=torch.float32, device=dev)
    for s in range(th):
        acc = torch.zeros((nslot, c + 2), dtype=torch.float64, device=dev)
        w[s] = acc.index_add_(0, slot, feat[(cell + s * r) % tr]).float()
    return w.view(th, k, nslot // k, c + 2).transpose(0, 1)


def folded_scores(compact, table, ctr, pix, w, bucket, shift,
                  num_classes: int, inv_tr=None):
    """The tracked kernel's product in plain PyTorch: (cost, norm, kf)
    (N,).  Particle p in bucket b = bucket[p] at shift s = shift[p] reads
    its window a of b's distinct pixels, ctr[p] + pix[b], on the compact
    map (compact (pixels, CP); level b at table[b] = (pixel offset, H, W,
    -), zero outside it; pixel_windows) and weighs it with w[b, s]
    (tracked_weights): cost = sum_u sum_{c<C} w[u, c] a[u, c], norm =
    sum_u w[u, C] a[u, C], kf = sum_u w[u, C + 1] a[u, C] inv_tr, inv_tr
    1 / (Th R) from the exact count of cells when None."""
    c = num_classes
    a = pixel_windows(compact, table, bucket, ctr, pix)
    ws = w[bucket.long(), shift.long()]
    if inv_tr is None:
        tr = float(ws[0, :, c + 1].sum())
        inv_tr = float(np.float32(1.0) / np.float32(tr))
    return ((a[..., :c] * ws[..., :c]).sum((1, 2)),
            (a[..., c] * ws[..., c]).sum(1),
            (a[..., c] * ws[..., c + 1]).sum(1) * inv_tr)


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


def quantize_channels_int4(packed: torch.Tensor):
    """(..., 8) float32 -> (bytes (..., 4) uint8, qinv (8,) float32): the
    JAX package's quantize_channels_int4 in the same float32 operations.
    Per channel amax over the whole map, at least 1e-6; codes v =
    round(packed * (qmax / amax)) (half to even) clipped to [0, qmax],
    qmax 15 on even channels and 7 on odd ones; byte j = v[2j] | v[2j + 1]
    << 4; qinv = amax / qmax."""
    p32 = packed.to(torch.float32)
    amax = torch.clamp(p32.reshape(-1, p32.shape[-1]).amax(0), min=1e-6)
    qmax = torch.tensor(I4_QMAX, dtype=torch.float32, device=packed.device)
    v = torch.minimum(torch.round(p32 * (qmax / amax)).clamp(min=0.0), qmax)
    v = v.to(torch.uint8)
    return v[..., 0::2] | (v[..., 1::2] << 4), amax / qmax


def compact_codes(byte: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(..., CP/2) uint8: the first CP/2 bytes of quantize_channels_int4's
    bytes, the C + 1 channels the score reads (compact_map's channels),
    the nibbles of the channels above them zeroed."""
    keep = num_classes + 1
    nb = (keep + 1) // 2  # the bytes that hold a channel kept
    out = torch.zeros(byte.shape[:-1] + (channel_pad(num_classes) // 2,),
                      dtype=torch.uint8, device=byte.device)
    out[..., :nb] = byte[..., :nb]
    if keep % 2:
        out[..., nb - 1] &= 0x0F
    return out


def dequantize_int4(codes: torch.Tensor, qinv: torch.Tensor,
                    num_classes: int) -> torch.Tensor:
    """(..., 8) float32 packed map of the code map `codes` (..., CP/2):
    channel ch <= C is code * qinv[ch] in float32, the channels above
    zero; what the plain versions score for a nibble-packed map."""
    shifts = torch.tensor([0, 4], dtype=torch.uint8, device=codes.device)
    nib = ((codes[..., None] >> shifts) & 0x0F).flatten(-2)
    keep = num_classes + 1
    out = torch.zeros(codes.shape[:-1] + (C_PAD,), dtype=torch.float32,
                      device=codes.device)
    out[..., :keep] = nib[..., :keep].to(torch.float32) * qinv[:keep]
    return out


class CropMap:
    """A packed (..., 8) float32 map and its compact copies: the crop
    kernels' operands.  compact(num_classes) is made on first use and
    kept, so a map's owner makes it once per map version; fold(stencil,
    f) keeps the last stencil fold at a host scale f.

    int4: score the nibble-packed map (the module's docstring; the
    filter's map_int4, which reads TDR_MAP_INT4 when None).  Such a map
    quantizes its own packed map on first use (quantize_channels_int4, or
    `quantized`, its (bytes, qinv) made elsewhere: the pyramid's, from
    the full-resolution map) and keeps codes(num_classes) and
    plain(num_classes); compact() stays the float32 map.

    m_hilo: the crop kernels' M, the hi/lo pair (True) or the single plane
    (False; the module's docstring, the filter's m_hilo), whose integers
    m_qinv decides: the code map's qinv, or int8_qinv of the float map
    (made on first use from this map, or given: the pyramid's, from the
    full-resolution map)."""

    def __init__(self, packed: torch.Tensor, int4: bool = False,
                 quantized=None, m_hilo: bool = True, m_qinv=None):
        self.packed = packed
        self.int4 = bool(int4)
        self.m_hilo = bool(m_hilo)
        self._compact = {}
        self._codes = {}
        self._plain = {}
        self._quantized = quantized  # (bytes (..., 4), qinv (8,))
        self._m_qinv = m_qinv  # int8_qinv of the float map
        self._fold = None  # (stencil, f, fold)

    def compact(self, num_classes: int) -> torch.Tensor:
        """compact_map(packed, num_classes), made once."""
        if num_classes not in self._compact:
            self._compact[num_classes] = compact_map(self.packed,
                                                     num_classes)
        return self._compact[num_classes]

    def quantized(self):
        """(bytes, qinv) of quantize_channels_int4, made once; only a
        nibble-packed map has them."""
        if not self.int4:
            raise ValueError("a float32 CropMap has no codes (int4=False)")
        if self._quantized is None:
            self._quantized = quantize_channels_int4(self.packed)
        return self._quantized

    @property
    def qinv(self) -> torch.Tensor:
        """(8,) float32: code * qinv[ch] is channel ch's value."""
        return self.quantized()[1]

    @property
    def m_qinv(self) -> torch.Tensor:
        """(8,) float32: the qinv the JAX package folds into M's rows for
        this map, which decides the single-plane M's integers: the code
        map's qinv, or int8_qinv of the float map, made once."""
        if self.int4:
            return self.qinv
        if self._m_qinv is None:
            self._m_qinv = int8_qinv(self.packed)
        return self._m_qinv

    def plain_m(self) -> dict:
        """The M arguments of the plain versions for this map: m_hilo,
        and for the single plane the qinv and table that decide it."""
        if self.m_hilo:
            return {}
        return {"m_hilo": False, "qinv": self.m_qinv, "int4": self.int4}

    def codes(self, num_classes: int) -> torch.Tensor:
        """compact_codes of the map's bytes, made once."""
        if num_classes not in self._codes:
            self._codes[num_classes] = compact_codes(self.quantized()[0],
                                                     num_classes)
        return self._codes[num_classes]

    def operand(self, num_classes: int) -> torch.Tensor:
        """The map the kernels read: codes or the compact map."""
        return (self.codes(num_classes) if self.int4
                else self.compact(num_classes))

    def _dequantized(self, num_classes: int) -> torch.Tensor:
        if num_classes not in self._plain:
            self._plain[num_classes] = dequantize_int4(
                self.codes(num_classes), self.qinv, num_classes)
        return self._plain[num_classes]

    def plain(self, num_classes: int) -> "CropMap":
        """The map the plain versions score: this map, or for a
        nibble-packed one a float32 CropMap of its dequantized codes."""
        if not self.int4:
            return self
        return CropMap(self._dequantized(num_classes), int4=False)

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


def init_m(scan, class_weights, order, seg, num_rot: int = 40, qinv=None):
    """The theta search as a matrix: m (K, P*CP, M_COLS) float32 over the
    CSR (order, seg) of K offset tables' fold (fold_pixels; K = 1 at a
    uniform scale), whose pixels pix (K, P, 2) it multiplies.  Row q*CP +
    ch of m[b] is pixel pix[b, q], channel ch; for each search shift k,
    column 2k holds the cost and 2k + 1 the norm circulant summed over the
    stencil cells on that pixel, column KF_COL the count of those cells
    (known channel).  So for a window w[q, ch] of the compact map at
    centre + pix[b, q]: (w @ m[b])[2k] = num(k), [2k + 1] = den(k),
    [KF_COL] * 1/(Th R) = kf.  The sums are taken in float64, so that
    their order (index_add_ on the card) does not change the result.  With
    qinv (init_m_lokf) each cell's coefficient is first multiplied by qinv
    of its row's channel and rounded to bf16 (the JAX package's M build)."""
    c, th, r = scan.shape
    cp = channel_pad(c)
    tr = th * r
    k = order.shape[0] // tr
    cap = (seg.shape[0] - 1) // k
    ssh = search_shifts(th, num_rot, scan.device)
    cost_sel, norm_sel = circulants_at_shifts(scan, class_weights, ssh)
    s = num_rot
    feat = torch.cat([cost_sel.reshape(tr, c * s), norm_sel,
                      torch.ones((tr, 1), device=scan.device)], 1)
    if qinv is not None:
        mult = torch.cat([qinv[:c].repeat_interleave(s),
                          qinv[c:c + 1].expand(s + 1)])
        feat = (feat * mult).to(torch.bfloat16)
    feat = feat.double()
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


def known_code(num_classes: int) -> int:
    """The code of a known pixel on the known channel C: its qmax, 15 on an
    even channel and 7 on an odd one (the mask's 1 quantized)."""
    return int(I4_QMAX[num_classes])


def fold_qinv(m, qinv, num_classes: int):
    """M of the code map's theta search: init_m's rows of channel ch times
    qinv[ch], so that the codes themselves are its A operand; the kf
    column keeps its cell counts, so that it sums known_code times the
    count of known cells, which the kernel divides out exactly (kf then is
    the float map's for a known mask of 0 and 1)."""
    cp = channel_pad(num_classes)
    scale = qinv[:cp].repeat(m.shape[1] // cp)  # row q CP + ch: qinv[ch]
    out = m * scale[None, :, None]
    out[..., KF_COL] = m[..., KF_COL]
    return out


# -- the single-plane M (TDR_M_HILO=0) ------------------------------------
LOKF_INFLATE = 1.0 + 2.0**-8  # amax's cover of the bf16 table rounding
LOKF_LO = 254.0  # the kf residual's scale: s / 254


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded as IEEE division (the JAX package's, and the
    kernels' __fdiv_rn): PyTorch multiplies a CUDA tensor by the
    reciprocal of a Python number, which can be one ulp off."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def int8_qinv(packed: torch.Tensor) -> torch.Tensor:
    """(8,) float32: the qinv of the JAX package's quantize_channels (its
    int8 crop map), per channel max |v| over the map, at least 1e-6, over
    126; what JAX folds into M's rows for the float map, and so what
    decides the single-plane M's integers."""
    p32 = packed.to(torch.float32)
    amax = torch.clamp(p32.reshape(-1, p32.shape[-1]).abs().amax(0),
                       min=1e-6)
    return true_div(amax, 126.0)


def lokf_scale(amax: torch.Tensor) -> torch.Tensor:
    """A column's scale from the amax of its float32 sums: max(amax (1 +
    2^-8), 1e-30) / 127, in float32 as the JAX package's _run_kernel."""
    return true_div(torch.clamp(amax * LOKF_INFLATE, min=1e-30), 127.0)


def lokf_planes(y: torch.Tensor, int4: bool) -> torch.Tensor:
    """The table entries JAX quantizes for per-pixel sums y (..., CP,
    cols): y itself (1, ..., CP, cols) for the float map; for the code map
    the e-dot identity's planes (2, ..., CP/2, cols), y_even - y_odd / 16
    and y_odd / 16 (_build_base_t_i4)."""
    if not int4:
        return y[None]
    odd = y[..., 1::2, :] / 16.0
    return torch.stack([y[..., 0::2, :] - odd, odd])


def quantize_lokf(y: torch.Tensor, int4: bool, kf_col: int):
    """The single-plane quantization of per-pixel sums y (B..., P, CP,
    cols), one scale a (B..., column) (the JAX package's _run_kernel with
    lokf): (w (B..., P, CP, cols) float32, integer-valued, s (B..., cols)
    float32).  Each column's scale is lokf_scale of the amax of its table
    entries (lokf_planes) and its integers round(bf16(entry) / s) (half to
    even) clipped to +-127; column kf_col + 1 (zero in y) takes the kf
    column's residual bf16(entry) - q s in units of s / 254, its scale
    s / 254.  The float map's integers are the weights of its channels;
    the code map's come back as q_e + q_b on the even channel and 16 q_b
    on the odd one (|w| <= 254 and 2,032, integers exact in bf16), so that
    codes e, o give e q_e + (e + 16 o) q_b, JAX's product."""
    shape = y.shape
    y = y.reshape((-1,) + tuple(shape[-3:]))
    t = lokf_planes(y, int4)  # (planes, B, P, CP or CP/2, cols)
    s = lokf_scale(t.abs().amax(dim=(0, 2, 3)))  # (B, cols)
    tb = t.to(torch.bfloat16).to(torch.float32)
    q = torch.clamp(torch.round(tb / s[None, :, None, None]), -127.0, 127.0)
    s_kf = s[None, :, None, None, kf_col]
    s_lo = true_div(s[:, kf_col], LOKF_LO)
    res = tb[..., kf_col] - q[..., kf_col] * s_kf
    q[..., kf_col + 1] = torch.clamp(
        torch.round(res / s_lo[None, :, None, None]), -127.0, 127.0)
    s = s.clone()
    s[:, kf_col + 1] = s_lo
    if int4:
        q = torch.stack([q[0] + q[1], 16.0 * q[1]], -2).flatten(-3, -2)
    else:
        q = q[0]
    return q.reshape(shape), s.reshape(tuple(shape[:-3]) + (shape[-1],))


def init_m_lokf(scan, class_weights, order, seg, num_rot: int, qinv,
                int4: bool):
    """The theta search's single-plane M over the CSR (order, seg) of K
    offset tables' fold: (w (K, P*CP, M_COLS) integers, scales (K, M_COLS)),
    init_m's layout and sums (the cells' coefficients times qinv in bf16,
    init_m with qinv) quantized by quantize_lokf, the kf residual in column
    KF_COL + 1.  w[b] * scales[b] / qinv[row channel] is the dequantized M
    the plain version scores."""
    y = init_m(scan, class_weights, order, seg, num_rot, qinv=qinv)
    k, rows, cols = y.shape
    cp = channel_pad(scan.shape[0])
    w, s = quantize_lokf(y.view(k, rows // cp, cp, cols), int4, KF_COL)
    return w.view(k, rows, cols), s


def tracked_lokf(y, int4: bool, num_classes: int):
    """The tracked kernel's single-plane weights from tracked_weights(...,
    qinv)'s sums y (K, Th, P, C + 2): (w (K, Th, P, C + 3) integers: the C
    cost weights, the norm weight, the kf weight and its residual's; scales
    (K, Th, 4) float32 of the same four columns).  Each (bucket, shift) is
    one JAX column group: the cost weights of the C classes share one scale
    (the amax over the pixels and classes), the norm weight another, the kf
    weight a third, its residual s_kf / 254 the fourth.  The code map's cost
    weights are q_e + q_b and 16 q_b by channel parity; its norm and kf
    weights sit on the known channel alone (on an odd known channel the
    partner's q_e = -q_b cancel exactly)."""
    c = num_classes
    cp = channel_pad(c)
    z = y.new_zeros(tuple(y.shape[:-1]) + (cp, 4))
    z[..., :c, 0] = y[..., :c]
    z[..., c, 1] = y[..., c]
    z[..., c, 2] = y[..., c + 1]
    w, s = quantize_lokf(z, int4, 2)
    return torch.cat([w[..., :c, 0], w[..., c, 1:]], -1), s


def tracked_lokf_weights(w, s, rq, num_classes: int):
    """The dequantized weights (K, Th, P, C + 2) of tracked_lokf's (w
    (K, Th, P, C + 3), s (K, Th, 4)) for a map whose values are v: cost
    (w_c s_cost) rq[c], norm (w s_norm) rq[C], kf (q s_kf + q_lo s_lo)
    rq[C], in float32 in this order, as the tracked kernel computes them
    (rq = 1 / qinv on the float map; ones on the code map, whose kernel
    weighs the codes themselves)."""
    c = num_classes
    sx = s[..., None, :]
    cost = w[..., :c] * sx[..., 0:1] * rq[:c]
    norm = w[..., c] * sx[..., 1] * rq[c]
    kf = (w[..., c + 1] * sx[..., 2] + w[..., c + 2] * sx[..., 3]) * rq[c]
    return torch.cat([cost, norm[..., None], kf[..., None]], -1)


def pixel_windows(flat, table, bucket, ctr, pix):
    """(n, P, CP): particle p's window of its bucket's distinct pixels
    ctr[p] + pix[bucket[p]] on the flat compact map (pixels, CP), level
    b at table[b] = (pixel offset, H, W, -), zero outside it."""
    b = bucket.long()
    lv = table.long()[b]
    base, h, wd = lv[:, 0:1], lv[:, 1:2], lv[:, 2:3]
    pb = pix.long()[b]
    iy = ctr[:, None, 0].long() + pb[..., 0]
    ix = ctr[:, None, 1].long() + pb[..., 1]
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < wd)
    lin = base + torch.minimum(iy.clamp(min=0), h - 1) * wd + torch.minimum(
        ix.clamp(min=0), wd - 1)
    return torch.where(valid[..., None], flat[lin], 0.0)


def lokf_tracked_scores(compact, table, ctr, bucket, shift, fold, scan,
                        class_weights, qinv, int4: bool, num_classes: int,
                        chunk_size: int = 4096):
    """The single-plane tracked flavour in plain PyTorch: (cost, norm, kf)
    (N,) of the windows on compact (pixels, CP) (levels `table`, particle
    p in bucket[p] at shift[p], centres ctr) weighed by the dequantized
    single-plane weights (tracked_weights with qinv, tracked_lokf,
    tracked_lokf_weights with rq = 1 / qinv); kf the sum times f32(1 /
    (Th R)).  For the code map, compact holds the dequantized codes."""
    c = num_classes
    pix, _, order, seg = fold
    th, r = scan.shape[1:]
    w, s = tracked_lokf(tracked_weights(scan, class_weights, order, seg,
                                        qinv), int4, c)
    ws = tracked_lokf_weights(w, s, 1.0 / qinv, c)
    inv_tr = float(np.float32(1.0) / np.float32(th * r))
    out = []
    for lo in range(0, ctr.shape[0], chunk_size):
        sl = slice(lo, lo + chunk_size)
        out.append(torch.stack(folded_scores(
            compact, table, ctr[sl], pix, ws, bucket[sl], shift[sl], c,
            inv_tr), 1))
    if not out:
        z = torch.zeros(0, device=ctr.device)
        return z, z, z
    out = torch.cat(out)
    return out[:, 0], out[:, 1], out[:, 2]


def lokf_init_rows(compact, table, ctr, bucket, fold, scan, class_weights,
                   num_rot: int, qinv, int4: bool, num_classes: int,
                   chunk_size: int = 4096):
    """The single-plane theta search's raw rows in plain PyTorch: (nums,
    dens (N, num_rot), kf (N,)), each particle's window on compact
    (pixels, CP) (pixel_windows) times its bucket's dequantized M in
    float64: init_m_lokf's (w s[col]) / qinv[row channel] (rq = 1 / qinv
    in float32); kf the sum of columns KF_COL and KF_COL + 1 times f32(1 /
    (Th R))."""
    pix, _, order, seg = fold
    th, r = scan.shape[1:]
    w, s = init_m_lokf(scan, class_weights, order, seg, num_rot, qinv, int4)
    cp = channel_pad(num_classes)
    rq = (1.0 / qinv[:cp]).repeat(w.shape[1] // cp)
    m = ((w * s[:, None, :]) * rq[None, :, None]).double()
    acc = torch.zeros((ctr.shape[0], M_COLS), dtype=torch.float64,
                      device=ctr.device)
    for b in range(m.shape[0]):
        rows = torch.nonzero(bucket == b)[:, 0]
        for lo in range(0, rows.shape[0], chunk_size):
            sl = rows[lo : lo + chunk_size]
            a = pixel_windows(compact, table, bucket[sl], ctr[sl], pix)
            acc[sl] = a.reshape(a.shape[0], -1).double() @ m[b]
    acc = acc.float()
    inv_tr = float(np.float32(1.0) / np.float32(th * r))
    s2 = 2 * num_rot
    return (acc[:, 0:s2:2], acc[:, 1:s2:2],
            (acc[:, KF_COL] + acc[:, KF_COL + 1]) * inv_tr)


def code_chunk_order() -> torch.Tensor:
    """(K_CHUNK,) int64: the rows of a chunk of M (pixel * CP + channel) in
    the order the code map's theta search takes them.  Fragment column c =
    16 ks + 8 hf + 2 t + e holds row 8 t + 2 (2 ks + hf) + e: a thread's
    four pairs of a row are rows 8 t .. 8 t + 7, whole pixels of the
    chunk, which it loads as 8 / CP naturally aligned words of CP / 2 code
    bytes each (csrc/crop_init.cuh Codes), at any CP."""
    c = np.arange(K_CHUNK)
    ks, hf, t, e = c // 16, (c // 8) % 2, (c % 8) // 2, c % 2
    return torch.as_tensor(8 * t + 2 * (2 * ks + hf) + e)


def init_operands(pix, npix, m, chunk_order=None, planes: int = 2):
    """M as the init kernel streams it: (records (K, chunks, words) int16,
    nchunk (K,) int64).  A record is one chunk of K_CHUNK rows of M: its
    bf16 hi plane, its lo plane (each in wgmma's K-major core-matrix
    order: 8 columns x 8 rows blocks of 128 bytes, N-block fastest), then
    the int32 (dy, dx) of its K_CHUNK / CP pixels.  nchunk[b] counts the
    chunks that hold bucket b's npix[b] pixels.  chunk_order
    (code_chunk_order) permutes each chunk's rows for the code map.
    planes=1: one plane, bf16(m) (the single-plane M's integers, exact),
    then the pixels."""
    k, rows, ncol = m.shape
    cp = rows // pix.shape[1]
    nch = rows // K_CHUNK
    if chunk_order is not None:
        m = m.view(k, nch, K_CHUNK, ncol)[:, :, chunk_order.to(m.device)]
        m = m.reshape(k, rows, ncol)

    def plane(x):  # (k, rows, ncol) -> chunk, k block, n block, n, k
        x = x.view(k, nch, K_CHUNK // 8, 8, ncol // 8, 8)
        return x.permute(0, 1, 2, 4, 5, 3).reshape(k, nch, -1)

    parts = split_bf16(m) if planes == 2 else (m.to(torch.bfloat16),)
    pixels = pix.reshape(k, nch, -1).view(torch.int16)
    rec = torch.cat([plane(x).view(torch.int16) for x in parts] + [pixels],
                    2).contiguous()
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


def init_window(maps) -> bool:
    """Whether the theta search on maps (a CropMap or PyramidMaps) takes
    the window route (csrc/crop_init.cuh): every configuration does, the
    float map with the hi/lo M (crop_init_kernel), the code map with it
    (crop_init_i4_kernel) and either map with the single-plane M
    (crop_init_lokf_kernel).  Its rows go in init_order and its entries
    take the fold's extents (fold_extent) after out."""
    return True


def init_extent(pix: torch.Tensor, npix: torch.Tensor) -> torch.Tensor:
    """(K, 4) int32: each bucket's extent, the least and greatest dy and
    dx of its npix[b] distinct pixels pix[b] (fold_pixels'), as (dy min,
    dy max, dx min, dx max).  Device ops of fixed size: no host read."""
    big = 1 << 30
    live = (torch.arange(pix.shape[1], device=pix.device)
            < npix[:, None])[..., None]
    lo = torch.where(live, pix, big).amin(1)
    hi = torch.where(live, pix, -big).amax(1)
    return torch.stack([lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1]],
                       1).to(torch.int32).contiguous()


_FOLD_EXTENT = [None, None]  # the last fold's pix, its init_extent


def fold_extent(fold) -> torch.Tensor:
    """init_extent of a fold (fold_pixels'), kept for the last fold: a
    fold that CropMap.fold returns again gives its extents without a
    launch."""
    if _FOLD_EXTENT[0] is not fold[0]:
        _FOLD_EXTENT[:] = fold[0], init_extent(*fold[:2])
    return _FOLD_EXTENT[1]


def init_order(bucket: torch.Tensor, ctr: torch.Tensor, k: int,
               extent: int):
    """The window-route theta search's rows: the particles in stable order
    of their bucket (< k) and, within a bucket, of the Morton code of
    their centre's tile on its level (tracked_order with the bucket as the
    group; extent bounds the levels' sides), so that a warp's 16 rows lie
    close together and their loads hit L1.  Returns (perm (N,) int32,
    row_start (K + 1,) int64: bucket b's first row, and N), as bucket_rows
    returns them: order_rows, one launch on the card, no host read; each
    row's result is its own, so the order changes no bit of the output."""
    _, perm, _, row_start = order_rows(bucket, ctr, k, extent,
                                       index_dtype=torch.int32, starts=True)
    return perm, row_start


def init_records(scan, class_weights, fold, row_start, num_rot: int,
                 qinv=None, m_hilo: bool = True, int4: bool = False):
    """The theta search's M build: (records, schedule) of init_operands and
    init_schedule, M built by init_m over the K offset tables' fold
    (fold_pixels) for the buckets that start at row_start; with qinv, the
    code map's M (fold_qinv, code_chunk_order).  m_hilo=False: the
    single-plane M (init_m_lokf; qinv the map quantization's, int4 the code
    map's table, its chunks' rows in code_chunk_order), one plane a record,
    and its column scales (K, M_COLS) third."""
    pix, npix, order, seg = fold
    if not m_hilo:
        w, scales = init_m_lokf(scan, class_weights, order, seg, num_rot,
                                qinv, int4)
        rec, nchunk = init_operands(
            pix, npix, w, code_chunk_order() if int4 else None, planes=1)
        return rec, init_schedule(row_start, nchunk), scales.contiguous()
    m = init_m(scan, class_weights, order, seg, num_rot)
    chunk_order = None
    if qinv is not None:
        c = scan.shape[0]
        m = fold_qinv(m, qinv, c)
        chunk_order = code_chunk_order()
    rec, nchunk = init_operands(pix, npix, m, chunk_order)
    return rec, init_schedule(row_start, nchunk)


def record_args(maps) -> dict:
    """init_records' M arguments for maps: the code map's qinv (or None)
    for the hi/lo M, the map quantization's qinv and the table for the
    single-plane one."""
    if maps.m_hilo:
        return {"qinv": maps.qinv if maps.int4 else None}
    return {"qinv": maps.m_qinv, "m_hilo": False, "int4": maps.int4}


def map_head(maps, num_classes: int) -> tuple:
    """The theta-search entry's arguments between the map operand and H
    (or the table): the known code of a code map (hi/lo M), qinv of a
    float map with the single-plane M (its window is scaled by 1 / qinv),
    else none."""
    if maps.int4 and maps.m_hilo:
        return (ctypes.c_float(known_code(num_classes)),)
    if not maps.int4 and not maps.m_hilo:
        return (ptr(maps.m_qinv),)
    return ()


def init_args(operand, head: tuple, table, h: int, w: int, num_classes: int,
              rec, sched, ctr, perm, num_rot: int, inv_tr: float, out, ext,
              scales=None) -> tuple:
    """The theta-search entry points' arguments before the stream:
    tdr_crop_score_init's (table None) or tdr_crop_score_multi_init's over
    the map operand, `head` (map_head) after it, and with scales (the
    single-plane M's) the "_lokf" twins', the scales after the records;
    perm (init_order's), and ext (fold_extent) after out."""
    cp = channel_pad(num_classes)
    args = (ptr(operand),) + head
    if table is None:
        args += (h, w, cp)
    else:
        args += (ptr(table), table.shape[0], cp)
    args += (ptr(rec),)
    if scales is not None:
        args += (ptr(scales),)
    return args + (ptr(sched), rec.shape[1], ptr(perm), ptr(ctr),
                   ctr.shape[0], num_rot, ctypes.c_float(inv_tr), ptr(out),
                   ptr(ext))


def launch_init(base: str, inputs: tuple, raw: bool = False):
    """Build M over the K offset tables' fold (fold_pixels), schedule the
    tiles and launch the theta-search kernel entry_name(base, maps, raw)
    over `inputs` (init_inputs': maps first, a CropMap or PyramidMaps
    whose operand the kernel reads, map_operand; table: the K buckets'
    levels, or None at a uniform scale; row_start (K + 1,) int64: the
    first row of each bucket in perm's order, and N).  Returns init_rows'
    rows, the raw ones where raw."""
    name = entry_name(base, inputs[0], raw)

    def launch(args):
        kernels.launch("crop_score_init", f"tdr_{name}", *args)
        kernels.LAUNCHES[name] += 1

    return init_rows(launch, inputs, raw)


def init_rows(launch, inputs: tuple, raw: bool, records=None):
    """launch(args) on init_args over `inputs` (maps, table, h, w,
    num_classes, scan, class_weights, fold, ctr, perm, row_start, num_rot:
    init_inputs') and `records` (init_records', built from the inputs when
    None), and the rows it writes: (best, k, kf) (N,), or with raw (nums,
    dens (N, num_rot), kf (N,)): the sums as they are, kf the known count
    times f32(1 / (Th R)).  The production kernels' launch and the
    ablation's (probes/crop_ablate.py) share it; every entry takes the
    fold's extents after out (the window route, init_window)."""
    (maps, table, h, w, num_classes, scan, class_weights, fold, ctr, perm,
     row_start, num_rot) = inputs
    operand, _ = map_operand(maps, num_classes)
    th, r = scan.shape[1:]
    n = ctr.shape[0]
    width = 2 * num_rot + 1 if raw else 3
    out = torch.empty((n, width), dtype=torch.float32, device=ctr.device)
    inv_tr = float(np.float32(1.0) / np.float32(th * r))
    if n:
        if records is None:
            records = init_records(scan, class_weights, fold, row_start,
                                   num_rot, **record_args(maps))
        launch(init_args(operand, map_head(maps, num_classes), table, h, w,
                         num_classes, *records[:2], ctr, perm, num_rot,
                         inv_tr, out, fold_extent(fold), *records[2:]))
    if raw:
        s = 2 * num_rot
        return out[:, 0:s:2], out[:, 1:s:2], out[:, s] * inv_tr
    return out[:, 0], out[:, 1].to(torch.int64), out[:, 2]


def init_inputs(maps, num_classes, stencil, scan, class_weights, center_px,
                f, num_rot: int = 40, map_resolution: float = 1.0) -> tuple:
    """Check the theta search's operands on the card and derive launch_init's
    inputs at one uniform scale, maps first (its operand checked for
    32-bit indexing), the rows in init_order (the window route,
    init_window)."""
    packed_map = maps.packed
    dev = packed_map.device
    h, w = packed_map.shape[:2]
    _require(packed_map, "packed_map", (h, w, C_PAD), torch.float32, dev)
    check_operands(num_classes, stencil, scan, class_weights, center_px,
                   dev, num_rot)
    operand = maps.operand(num_classes)
    if operand.numel() >= 2**31:
        raise ValueError("map too large for 32-bit indexing")
    ctr = crop_centers(center_px, map_resolution).contiguous()
    perm, rows = init_order(  # the rows by position
        torch.zeros(ctr.shape[0], dtype=torch.int64, device=dev), ctr, 1,
        max(h, w))
    return (maps, None, h, w, num_classes, scan, class_weights,
            maps.fold(stencil, f), ctr, perm, rows, num_rot)


def score_init_sel(
    maps: CropMap, num_classes, stencil, scan, class_weights, center_px, f,
    num_rot: int = 40, map_resolution: float = 1.0,
):
    """Theta-search flavour: (best_cost, k (int64), kf) (N,) on maps (its
    codes where maps.int4: "crop_score_init_i4"); ties as in the module's
    docstring.  f as a number lets maps keep the stencil's fold
    (CropMap.fold)."""
    if not kernels.on_card(maps.packed.device, "crop scorer"):
        return score_init_sel_plain(
            maps.plain(num_classes).packed, num_classes, stencil, scan,
            class_weights, center_px, f, num_rot, map_resolution,
            **maps.plain_m(),
        )
    return launch_init("crop_score_init", init_inputs(
        maps, num_classes, stencil, scan, class_weights, center_px, f,
        num_rot, map_resolution))


def score_init_raw(
    maps: CropMap, num_classes, stencil, scan, class_weights, center_px, f,
    num_rot: int = 40, map_resolution: float = 1.0,
):
    """The theta search's raw rows, score_init_raw_plain's contract: (nums,
    dens (N, num_rot), kf (N,)) at the search shifts, nothing divided or
    gated.  A window off the map reads zeros, so a particle centred far
    off it has a row of zeros, as the reference zeroes its out-of-range
    rows.  On the card the same tensor-core product as score_init_sel
    with the raw-row epilogue ("crop_score_init_raw", or
    "crop_score_init_raw_i4" on the codes where maps.int4)."""
    if not kernels.on_card(maps.packed.device, "crop scorer"):
        return score_init_raw_plain(
            maps.plain(num_classes).packed, num_classes, stencil, scan,
            class_weights, center_px, f, num_rot, map_resolution,
            **maps.plain_m(),
        )
    return launch_init("crop_score_init", init_inputs(
        maps, num_classes, stencil, scan, class_weights, center_px, f,
        num_rot, map_resolution), raw=True)
