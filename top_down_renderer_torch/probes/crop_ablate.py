"""The crop kernels with stages knocked out (the counterparts of
tests/exp_crop_ablate.py in its two configurations, ABL_S_COLS 64 and
128).

K3, the tracked kernel (kernel csrc/crop_ablate.cu, whose body is the
production kernel's, csrc/crop_tracked.cuh):

  crop_ablate(variant, maps, ...)         the arguments of
                                          filter/crop_score.score_tracked
  crop_ablate_multi(variant, pyr, ...)    those of
                                          filter/multiscale.score_tracked_multi

Both return (cost, norm, kf) (N,) as the production wrappers do, for the
variants (VARIANTS):
  full         every stage: equal to the production kernel bit for bit;
               its plain version is the production's plain version
  no_fold      each block folds the weights and pixels of its first run
               (its first group bucket * Th + shift in sorted order) and
               scores every later run with them, on the run's own level
  no_gather    each particle reads one pixel, its centre clamped into its
               level, for every slot: cost = sum_u sum_c w[u, c] v_c
  gather_only  the pixels summed without weights: cost = sum_u sum_c
               a[u, c], norm = sum_u a[u, C], kf = norm / (Th R)
  fold_only    the per-run fold and no pixel loop: particle at sorted row
               j writes slot u = j % U of its group's folded weights: (cost
               weight of class 0, norm weight, count / (Th R))
  checked      every stage, every row through the bounds-checked loop one
               row a warp (no row skips the check, no warp takes two):
               full's output bit for bit, its plain version full's
The first four run the production kernel's loop (a row inside its level
unchecked, two such rows a warp).  Each takes order= (ORDERS): "position"
(the default), the rows as the production wrapper sorts them
(crop_score.tracked_order: each shift group's by the position of their
centres), or "key", by group alone (tracked_rows), so that the order's
share of the time can be measured too; "checked" under "key" is the
production kernel as it was before its rows went in position order.
Only no_fold and fold_only depend on the order (a block's rows).
On CPU tensors each runs its plain version (crop_ablate_plain,
crop_ablate_multi_plain; public, any device); on CUDA tensors it launches
the kernel (C = 3 or 6), counted in kernels.LAUNCHES["crop_ablate"].
The plain versions of the knocked-out variants sum in float64 over the
fold's CSR (crop_score.tracked_weights) and agree with the kernel within
float32 summation order.

K4, the theta search (kernel csrc/crop_ablate_init.cu, whose body is the
production kernel's, csrc/crop_init.cuh):

  crop_ablate_init(variant, maps, ...)        the arguments of
                                              crop_score.score_init_sel
  crop_ablate_multi_init(variant, pyr, ...)   those of
                                              multiscale.score_init_multi_sel

Each takes raw=False for (best, k, kf) (N,) rows, as score_init_sel, or
raw=True for (nums, dens (N, num_rot), kf (N,)), as score_init_raw, and
builds M, its records and the schedule with the production wrappers' code
(crop_score.init_rows).  Each particle's window w (its P distinct pixels
times CP channels of the compact map, zero off its level) meets M (init_m)
as acc = A @ B over M's 88 columns, then the production epilogue; the
variants (INIT_VARIANTS):
  full         every stage: A = w, B = M, the kernel's three hi/lo products
               with a fresh partial sum a chunk; equal to the production
               kernel bit for bit, its plain version the production's
  one_plane    A_hi B_hi only: A = bf16(w), B = bf16(M)
  no_gather    A = the particle's centre pixel (clamped into its level)
               for every pixel of the window, B = M
  gather_only  no product: column n sums the window's K rows r with
               (r % 8) // 2 == (n % 8) // 2 (the rows a thread holds), hi =
               bf16(w) into the even columns and hi + lo (split_bf16) into
               the odd ones
  ring_only    no window and no product: every row of a bucket has the sum
               of |dy| of each chunk's first pixel (K_CHUNK / CP pixels a
               chunk) in the even columns and of |dx| in the odd ones
  no_promote   the products summed straight into the fp32 accumulators:
               acc = w @ M, as full, in another rounding
  checked      every stage, every warp through the bounds-checked gather
               (no warp skips the check): full's output bit for bit, its
               plain version full's
The gathering variants but checked (full, one_plane, gather_only,
no_promote) run the production kernel's window route (a warp whose rows'
windows lie in their level gathers unchecked).  Each takes order=
(INIT_ORDERS): "position" (the default), the rows as the production
wrappers order them (crop_score.init_order: each bucket's by the position
of their centres), or "particles", each bucket's in the particles' order
(multiscale.bucket_rows; the identity at a uniform scale), so that the
order's share of the time can be measured too; "checked" under
"particles" is the production kernel as it was before either.  Each row's
result is its own, so no variant's output depends on the order.
On CPU tensors each runs its plain version (crop_ablate_init_plain,
crop_ablate_multi_init_plain; public, any device: acc in float64, then the
epilogue in float32, the first argmin of select_best); on CUDA tensors it
launches the kernel (C = 3 or 6), counted in
kernels.LAUNCHES["crop_ablate_init"].  The kernel takes the first shift
within TIE_REL of the row's minimum, so where the costs tie (no_gather's
window of one pixel gives every shift the same cost in exact arithmetic)
its k is a near-argmin of the plain costs, not their first argmin.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from top_down_renderer_torch import kernels
from top_down_renderer_torch.filter import crop_score as cs
from top_down_renderer_torch.filter import multiscale as ms
from top_down_renderer_torch.filter.scoring import rotation_shift
from top_down_renderer_torch.kernels import ptr

VARIANTS = ("full", "no_fold", "no_gather", "gather_only", "fold_only",
            "checked")
ORDERS = ("position", "key")  # K3's row orders
INIT_VARIANTS = ("full", "one_plane", "no_gather", "gather_only",
                 "ring_only", "no_promote", "checked")
INIT_ORDERS = ("position", "particles")  # K4's row orders
CLASSES = (3, 6)  # the class counts the kernels are built for
_CHUNK = 4096  # particles a chunk of the plain version


def ablation_rows(order: str, key, ctr, groups: int, extent: int):
    """The sorted rows of a K3 launch: (keys int32, perm int64, the keys'
    group shift): crop_score.tracked_order's, as the production wrapper
    sorts them ("position"), or tracked_rows' at shift 0 ("key")."""
    if order == "position":
        return cs.tracked_order(key, ctr, groups, extent)
    return (*cs.tracked_rows(key), 0)


def _launch(variant, compact, table, h, w, num_classes, scan, class_weights,
            fold, ctr, key, order, extent):
    """Sort the particles in `order` (ablation_rows; extent: the levels'
    longest side) and launch variant `variant` of the ablation kernel."""
    if num_classes not in CLASSES:
        raise ValueError(f"the ablation kernel is built for C in {CLASSES}")
    th, r = scan.shape[1:]
    n = ctr.shape[0]
    out = torch.empty((n, 3), dtype=torch.float32, device=ctr.device)
    if n:
        pix, npix, cells, seg = fold
        skey, perm, kshift = ablation_rows(order, key, ctr,
                                           pix.shape[0] * th, extent)
        inv_tr = float(np.float32(1.0) / np.float32(th * r))
        scan, class_weights = scan.contiguous(), class_weights.contiguous()
        kernels.launch(
            "crop_ablate", "tdr_crop_ablate", VARIANTS.index(variant),
            ptr(compact), None if table is None else ptr(table),
            0 if table is None else table.shape[0], h, w, num_classes,
            ptr(scan), ptr(class_weights), ptr(pix), ptr(npix), ptr(cells),
            ptr(seg), th, r, pix.shape[1], ptr(skey), ptr(perm), ptr(ctr), n,
            ctypes.c_float(inv_tr), ptr(out), kshift,
        )
        kernels.LAUNCHES["crop_ablate"] += 1
    return out[:, 0], out[:, 1], out[:, 2]


def _variant(variant: str, order: str = "position") -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant}")
    if order not in ORDERS:
        raise ValueError(f"order must be one of {ORDERS}, got {order}")


def _float_map(maps) -> None:
    """The ablations are built on the float32 map's hi/lo bodies only."""
    if maps.int4:
        raise ValueError("the crop ablations take a float32 map (int4=False)")
    if not maps.m_hilo:
        raise ValueError("the crop ablations take the hi/lo M (m_hilo=True)")


def crop_ablate(variant, maps, num_classes, stencil, scan, class_weights,
                center_px, theta, f, map_resolution: float = 1.0,
                order: str = "position"):
    """Variant `variant` of the uniform tracked kernel on maps (a
    CropMap), with score_tracked's arguments, its rows in `order`."""
    _variant(variant, order)
    _float_map(maps)
    if not kernels.on_card(maps.packed.device, "crop ablation"):
        return crop_ablate_plain(variant, maps, num_classes, stencil, scan,
                                 class_weights, center_px, theta, f,
                                 map_resolution, order)
    compact, fold, ctr, shift = cs._tracked_inputs(
        maps, num_classes, stencil, scan, class_weights, center_px, theta,
        f, map_resolution)
    h, w = maps.packed.shape[:2]
    return _launch(variant, compact, None, h, w, num_classes, scan,
                   class_weights, fold, ctr, shift, order,
                   cs._level_extent(maps, h, w))


def crop_ablate_multi(variant, pyr, num_classes, stencil, scan,
                      class_weights, center_px, theta, scale, slot_vals,
                      bucket_level, res, map_resolution: float = 1.0,
                      order: str = "position"):
    """Variant `variant` of the K-bucket tracked kernel, with
    score_tracked_multi's arguments, its rows in `order`."""
    _variant(variant, order)
    _float_map(pyr)
    if not kernels.on_card(pyr.flat.device, "crop ablation"):
        return crop_ablate_multi_plain(
            variant, pyr, num_classes, stencil, scan, class_weights,
            center_px, theta, scale, slot_vals, bucket_level, res,
            map_resolution, order)
    compact, table, fold, ctr, key = ms._tracked_inputs(
        pyr, num_classes, stencil, scan, class_weights, center_px, theta,
        scale, slot_vals, bucket_level, res, map_resolution)
    return _launch(variant, compact, table, 0, 0, num_classes, scan,
                   class_weights, fold, ctr, key, order,
                   cs._level_extent(pyr, 0, 0))


# -- plain versions ----------------------------------------------------------
def crop_ablate_plain(variant, maps, num_classes, stencil, scan,
                      class_weights, center_px, theta, f,
                      map_resolution: float = 1.0, order: str = "position"):
    """Plain version of crop_ablate (any device)."""
    _variant(variant, order)
    packed = maps.packed
    if variant in ("full", "checked"):
        return cs.score_tracked_plain(packed, num_classes, stencil, scan,
                                      class_weights, center_px, theta, f,
                                      map_resolution)
    h, w = packed.shape[:2]
    table = torch.tensor([[0, h, w, 0]], dtype=torch.int32,
                         device=packed.device)
    compact = cs.compact_map(packed, num_classes).reshape(h * w, -1)
    fold = cs.fold_offsets(cs.crop_offsets(stencil, f)[None])
    ctr = cs.crop_centers(center_px, map_resolution).to(packed.device)
    key = rotation_shift(theta, scan.shape[1]).to(packed.device)
    return ablated_scores(variant, compact, table, fold, ctr, key, scan,
                          class_weights, num_classes, order, max(h, w))


def crop_ablate_multi_plain(variant, pyr, num_classes, stencil, scan,
                            class_weights, center_px, theta, scale,
                            slot_vals, bucket_level, res,
                            map_resolution: float = 1.0,
                            order: str = "position"):
    """Plain version of crop_ablate_multi (any device)."""
    _variant(variant, order)
    if variant in ("full", "checked"):
        return ms.score_tracked_multi_plain(
            pyr, num_classes, stencil, scan, class_weights, center_px, theta,
            scale, slot_vals, bucket_level, res, map_resolution)
    bucket, off, ctr, table = ms._prepare(
        pyr, stencil, center_px, scale, slot_vals, bucket_level, res,
        map_resolution)
    th = scan.shape[1]
    key = bucket * th + rotation_shift(theta, th).to(bucket.device)
    return ablated_scores(variant, cs.compact_map(pyr.flat, num_classes),
                          table, cs.fold_offsets(off), ctr, key, scan,
                          class_weights, num_classes, order,
                          cs._level_extent(pyr, 0, 0))


def ablated_scores(variant, compact, table, fold, ctr, key, scan,
                   class_weights, num_classes: int, order: str,
                   extent: int):
    """The knocked-out variants' (cost, norm, kf) (N,) in plain PyTorch:
    compact (pixels, CP); table (K, 4) of each bucket's level (pixel
    offset, H, W, -); fold: fold_offsets of the K offset tables; ctr (N, 2)
    (cy, cx) on the particle's level; key (N,) bucket * Th + shift.  The
    rows go in `order` (ablation_rows; extent: the levels' longest side),
    TRACKED_TILE to a block, as the kernel takes them."""
    c = num_classes
    th, r = scan.shape[1:]
    dev = compact.device
    pix, npix, cells, seg = fold
    w = cs.tracked_weights(scan, class_weights, cells, seg).double()
    skey, perm, kshift = ablation_rows(order, key, ctr, pix.shape[0] * th,
                                       extent)
    n = skey.shape[0]
    rows = torch.arange(n, device=dev)
    group = skey.long() >> kshift
    lv = table.long()[group // th]  # each row's own level
    if variant == "no_fold":  # the weights of the block's first run
        group = group[rows // cs.TRACKED_TILE * cs.TRACKED_TILE]
    bw, sw = group // th, group % th
    nslot = npix.long()[bw]
    inv_tr = float(np.float32(1.0) / np.float32(th * r))
    out = torch.empty((n, 3), dtype=torch.float64, device=dev)
    if variant == "fold_only":
        u = rows % nslot.clamp(min=1)
        ws = w[bw, sw, u]
        out[:, 0], out[:, 1], out[:, 2] = ws[:, 0], ws[:, c], ws[:, c + 1]
        out[:, 2] *= inv_tr
    else:
        c_rows = ctr.long()[perm]
        for lo in range(0, n, _CHUNK):
            sl = slice(lo, lo + _CHUNK)
            out[sl] = _chunk(variant, compact, lv[sl], c_rows[sl],
                             pix.long()[bw[sl]], nslot[sl], w[bw[sl], sw[sl]],
                             c, inv_tr)
    res = torch.empty_like(out)
    res[perm] = out
    res = res.float()
    return res[:, 0], res[:, 1], res[:, 2]


def _chunk(variant, compact, lv, ctr, pix, nslot, ws, c: int, inv_tr):
    """(cost, norm, kf) (n, 3) float64 of a chunk of sorted rows: lv (n,
    4) levels, ctr (n, 2), pix (n, P, 2) their groups' pixels, nslot (n,)
    their counts, ws (n, P, C + 2) their weights."""
    base, h, wd = lv[:, 0:1], lv[:, 1:2], lv[:, 2:3]
    live = torch.arange(pix.shape[1], device=pix.device) < nslot[:, None]
    if variant == "no_gather":
        cy = torch.minimum(ctr[:, 0:1].clamp(min=0), h - 1)
        cx = torch.minimum(ctr[:, 1:2].clamp(min=0), wd - 1)
        a = compact[base + cy * wd + cx].double().expand(-1, pix.shape[1], -1)
        valid = live
    else:
        iy = ctr[:, None, 0] + pix[..., 0]
        ix = ctr[:, None, 1] + pix[..., 1]
        valid = live & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < wd)
        lin = base + torch.minimum(iy.clamp(min=0), h - 1) * wd + \
            torch.minimum(ix.clamp(min=0), wd - 1)
        a = compact[lin].double()
    a = torch.where(valid[..., None], a, 0.0)
    if variant == "gather_only":
        norm = a[..., c].sum(1)
        return torch.stack([a[..., :c].sum((1, 2)), norm, norm * inv_tr], 1)
    return torch.stack([(a[..., :c] * ws[..., :c]).sum((1, 2)),
                        (a[..., c] * ws[..., c]).sum(1),
                        (a[..., c] * ws[..., c + 1]).sum(1) * inv_tr], 1)


# -- K4: the theta search ------------------------------------------------------
def _init_variant(variant: str, num_classes: int,
                  order: str = "position") -> None:
    if variant not in INIT_VARIANTS:
        raise ValueError(f"variant must be one of {INIT_VARIANTS}, got "
                         f"{variant}")
    if order not in INIT_ORDERS:
        raise ValueError(f"order must be one of {INIT_ORDERS}, got {order}")
    if num_classes not in CLASSES:
        raise ValueError(f"the theta-search ablation is built for C in "
                         f"{CLASSES}, got {num_classes}")


def init_ablation_rows(order: str, inputs: tuple) -> tuple:
    """init_inputs' `inputs` (their rows in init_order) with the rows in
    `order`: as they are ("position"), or each bucket's in the particles'
    order ("particles": multiscale.bucket_rows of each row's bucket, the
    identity at a uniform scale).  row_start stays: each bucket keeps its
    rows."""
    if order == "position":
        return inputs
    perm, row_start = inputs[9], inputs[10]
    row = torch.arange(perm.shape[0], device=perm.device)
    bucket = torch.empty_like(perm)
    bucket[perm.long()] = (torch.searchsorted(row_start, row, right=True)
                           - 1).to(torch.int32)
    return (inputs[:9] + ms.bucket_rows(bucket, row_start.shape[0] - 1)
            + inputs[11:])


def launch_ablate_init(variant, inputs, raw: bool = False, records=None,
                       order: str = "position"):
    """Variant `variant` of the theta search on `inputs` (init_inputs'),
    its rows in `order` (init_ablation_rows), launched as
    crop_score.init_rows launches the production kernel (records:
    init_records', or None to build them)."""
    multi = inputs[1] is not None  # a table of bucket levels
    fn = "tdr_crop_ablate_multi_init" if multi else "tdr_crop_ablate_init"

    def launch(args):
        kernels.launch("crop_ablate_init", fn, INIT_VARIANTS.index(variant),
                       *args, int(raw))
        kernels.LAUNCHES["crop_ablate_init"] += 1

    return cs.init_rows(launch, init_ablation_rows(order, inputs), raw,
                        records)


def blocks_per_sm(variant: str, num_classes: int, raw: bool = False) -> int:
    """The blocks of a theta-search variant an SM holds at once, at the
    shared memory its launches ask for (the CUDA occupancy calculator's
    figure; crop_ablate_init.cu pins every variant to one)."""
    _init_variant(variant, num_classes)
    blocks = ctypes.c_int(0)
    err = kernels.load("crop_ablate_init").tdr_crop_ablate_init_blocks(
        INIT_VARIANTS.index(variant), cs.channel_pad(num_classes), int(raw),
        ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"tdr_crop_ablate_init_blocks: CUDA error {err}")
    return blocks.value


def crop_ablate_init(variant, maps, num_classes, stencil, scan,
                     class_weights, center_px, f, num_rot: int = 40,
                     map_resolution: float = 1.0, raw: bool = False,
                     order: str = "position"):
    """Variant `variant` of the uniform theta search on maps (a CropMap),
    with score_init_sel's arguments, its rows in `order`; raw=True
    returns score_init_raw's rows."""
    _init_variant(variant, num_classes, order)
    _float_map(maps)
    if not kernels.on_card(maps.packed.device, "theta-search ablation"):
        return crop_ablate_init_plain(variant, maps, num_classes, stencil,
                                      scan, class_weights, center_px, f,
                                      num_rot, map_resolution, raw, order)
    return launch_ablate_init(variant, cs.init_inputs(
        maps, num_classes, stencil, scan, class_weights, center_px, f,
        num_rot, map_resolution), raw, order=order)


def crop_ablate_multi_init(variant, pyr, num_classes, stencil, scan,
                           class_weights, center_px, scale, slot_vals,
                           bucket_level, res, num_rot: int = 40,
                           map_resolution: float = 1.0, raw: bool = False,
                           order: str = "position"):
    """Variant `variant` of the K-bucket theta search, with
    score_init_multi_sel's arguments, its rows in `order`; raw=True
    returns score_init_multi_raw's rows."""
    _init_variant(variant, num_classes, order)
    _float_map(pyr)
    if not kernels.on_card(pyr.flat.device, "theta-search ablation"):
        return crop_ablate_multi_init_plain(
            variant, pyr, num_classes, stencil, scan, class_weights,
            center_px, scale, slot_vals, bucket_level, res, num_rot,
            map_resolution, raw, order)
    return launch_ablate_init(variant, ms.init_inputs(
        pyr, num_classes, stencil, scan, class_weights, center_px, scale,
        slot_vals, bucket_level, res, num_rot, map_resolution), raw,
        order=order)


def crop_ablate_init_plain(variant, maps, num_classes, stencil, scan,
                           class_weights, center_px, f, num_rot: int = 40,
                           map_resolution: float = 1.0, raw: bool = False,
                           order: str = "position"):
    """Plain version of crop_ablate_init (any device; each row's result
    is its own, so the order changes none)."""
    _init_variant(variant, num_classes, order)
    packed = maps.packed
    if variant in ("full", "checked"):
        fn = cs.score_init_raw_plain if raw else cs.score_init_sel_plain
        return fn(packed, num_classes, stencil, scan, class_weights,
                  center_px, f, num_rot, map_resolution)
    dev = packed.device
    h, w = packed.shape[:2]
    table = torch.tensor([[0, h, w, 0]], dtype=torch.int32, device=dev)
    compact = cs.compact_map(packed, num_classes).reshape(h * w, -1)
    fold = cs.fold_offsets(cs.crop_offsets(stencil, f)[None].to(dev))
    ctr = cs.crop_centers(center_px, map_resolution).to(dev)
    bucket = torch.zeros(ctr.shape[0], dtype=torch.int32, device=dev)
    return ablated_init_rows(variant, compact, table, fold, ctr, bucket,
                             scan, class_weights, num_rot, raw)


def crop_ablate_multi_init_plain(variant, pyr, num_classes, stencil, scan,
                                 class_weights, center_px, scale, slot_vals,
                                 bucket_level, res, num_rot: int = 40,
                                 map_resolution: float = 1.0,
                                 raw: bool = False, order: str = "position"):
    """Plain version of crop_ablate_multi_init (any device; the order
    changes no row)."""
    _init_variant(variant, num_classes, order)
    if variant in ("full", "checked"):
        fn = (ms.score_init_multi_raw_plain if raw
              else ms.score_init_multi_sel_plain)
        return fn(pyr, num_classes, stencil, scan, class_weights, center_px,
                  scale, slot_vals, bucket_level, res, num_rot,
                  map_resolution)
    bucket, off, ctr, table = ms._prepare(
        pyr, stencil, center_px, scale, slot_vals, bucket_level, res,
        map_resolution)
    return ablated_init_rows(variant, cs.compact_map(pyr.flat, num_classes),
                             table, cs.fold_offsets(off), ctr, bucket, scan,
                             class_weights, num_rot, raw)


def ablated_init_rows(variant, compact, table, fold, ctr, bucket, scan,
                      class_weights, num_rot: int, raw: bool):
    """The theta-search variants' rows in plain PyTorch (module docstring):
    compact (pixels, CP); table (K, 4) of each bucket's level (pixel offset,
    H, W, -); fold: fold_offsets of the K offset tables; ctr (N, 2) (cy, cx)
    on the particle's level; bucket (N,).  acc in float64, then the
    production epilogue in float32."""
    pix, npix, order, seg = fold
    th, r = scan.shape[1:]
    m = cs.init_m(scan, class_weights, order, seg, num_rot)
    n = ctr.shape[0]
    acc = torch.zeros((n, cs.M_COLS), dtype=torch.float64,
                      device=compact.device)
    bucket = bucket.long()
    for b, lv in enumerate(table.long().tolist()):
        rows = torch.nonzero(bucket == b)[:, 0]
        for lo in range(0, rows.shape[0], _CHUNK):
            idx = rows[lo:lo + _CHUNK]
            acc[idx] = _init_acc(variant, compact, lv, pix[b].long(),
                                 int(npix[b]), m[b], ctr[idx].long())
    s = 2 * num_rot
    inv_tr = float(np.float32(1.0) / np.float32(th * r))
    nums, dens = acc[:, 0:s:2].float(), acc[:, 1:s:2].float()
    kf = acc[:, cs.KF_COL].float() * inv_tr
    if raw:
        return nums, dens, kf
    return (*cs.select_best(nums, dens, kf), kf)


def _init_acc(variant, compact, lv, pix, npix: int, m, ctr):
    """acc (n, M_COLS) float64 of n particles of one bucket: lv its level
    (pixel offset, H, W, -), pix (P, 2) its pixels, npix how many are
    real, m (P*CP, M_COLS) float32 its M, ctr (n, 2) the centres."""
    base, h, w = lv[:3]
    cp = compact.shape[1]
    dev = compact.device
    cols = torch.arange(cs.M_COLS, device=dev)
    if variant == "ring_only":
        per = cs.K_CHUNK // cp
        nch = (npix * cp + cs.K_CHUNK - 1) // cs.K_CHUNK
        dy, dx = pix[0:nch * per:per].abs().double().sum(0)
        row = torch.where(cols % 2 == 0, dy, dx)
        return row.expand(ctr.shape[0], -1)
    if variant == "no_gather":
        cy = ctr[:, 0].clamp(0, h - 1)
        cx = ctr[:, 1].clamp(0, w - 1)
        v = compact[base + cy * w + cx].double()  # (n, CP)
        return v @ m.double().view(-1, cp, cs.M_COLS).sum(0)
    iy = ctr[:, None, 0] + pix[None, :, 0]
    ix = ctr[:, None, 1] + pix[None, :, 1]
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    lin = base + iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    a = torch.where(valid[..., None], compact[lin], 0.0).reshape(
        ctr.shape[0], -1)  # (n, P*CP) float32
    if variant == "one_plane":
        return (cs.split_bf16(a)[0].double()
                @ cs.split_bf16(m)[0].double())
    if variant == "gather_only":
        hi, lo = (x.double() for x in cs.split_bf16(a))
        quad = (torch.arange(a.shape[1], device=dev) % 8) // 2
        onehot = (quad[:, None] == torch.arange(4, device=dev)).double()
        even, odd = hi @ onehot, (hi + lo) @ onehot  # (n, 4)
        q = (cols % 8) // 2
        return torch.where(cols % 2 == 0, even[:, q], odd[:, q])
    return a.double() @ m.double()  # no_promote
