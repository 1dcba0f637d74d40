"""The tracked crop kernel with stages knocked out (the counterpart of
tests/exp_crop_ablate.py; kernel csrc/crop_ablate.cu, whose body is the
production kernel's, csrc/crop_tracked.cuh).

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
On CPU tensors each runs its plain version (crop_ablate_plain,
crop_ablate_multi_plain; public, any device); on CUDA tensors it launches
the kernel (C = 3 or 6), counted in kernels.LAUNCHES["crop_ablate"].
The plain versions of the knocked-out variants sum in float64 over the
fold's CSR (crop_score.tracked_weights) and agree with the kernel within
float32 summation order.
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

VARIANTS = ("full", "no_fold", "no_gather", "gather_only", "fold_only")
CLASSES = (3, 6)  # the class counts the kernel is built for
_CHUNK = 4096  # particles a chunk of the plain version


def _launch(variant, compact, table, h, w, num_classes, scan, class_weights,
            fold, ctr, key):
    """Sort the particles by group key as crop_score.launch_tracked does
    and launch variant `variant` of the ablation kernel."""
    if num_classes not in CLASSES:
        raise ValueError(f"the ablation kernel is built for C in {CLASSES}")
    th, r = scan.shape[1:]
    n = ctr.shape[0]
    out = torch.empty((n, 3), dtype=torch.float32, device=ctr.device)
    if n:
        pix, npix, order, seg = fold
        skey, perm = cs.tracked_rows(key)
        inv_tr = float(np.float32(1.0) / np.float32(th * r))
        scan, class_weights = scan.contiguous(), class_weights.contiguous()
        kernels.launch(
            "crop_ablate", "tdr_crop_ablate", VARIANTS.index(variant),
            ptr(compact), None if table is None else ptr(table),
            0 if table is None else table.shape[0], h, w, num_classes,
            ptr(scan), ptr(class_weights), ptr(pix), ptr(npix), ptr(order),
            ptr(seg), th, r, pix.shape[1], ptr(skey), ptr(perm), ptr(ctr), n,
            ctypes.c_float(inv_tr), ptr(out),
        )
        kernels.LAUNCHES["crop_ablate"] += 1
    return out[:, 0], out[:, 1], out[:, 2]


def _variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant}")


def crop_ablate(variant, maps, num_classes, stencil, scan, class_weights,
                center_px, theta, f, map_resolution: float = 1.0):
    """Variant `variant` of the uniform tracked kernel on maps (a
    CropMap), with score_tracked's arguments."""
    _variant(variant)
    if not kernels.on_card(maps.packed.device, "crop ablation"):
        return crop_ablate_plain(variant, maps, num_classes, stencil, scan,
                                 class_weights, center_px, theta, f,
                                 map_resolution)
    compact, fold, ctr, shift = cs._tracked_inputs(
        maps, num_classes, stencil, scan, class_weights, center_px, theta,
        f, map_resolution)
    h, w = maps.packed.shape[:2]
    return _launch(variant, compact, None, h, w, num_classes, scan,
                   class_weights, fold, ctr, shift)


def crop_ablate_multi(variant, pyr, num_classes, stencil, scan,
                      class_weights, center_px, theta, scale, slot_vals,
                      bucket_level, res, map_resolution: float = 1.0):
    """Variant `variant` of the K-bucket tracked kernel, with
    score_tracked_multi's arguments."""
    _variant(variant)
    if not kernels.on_card(pyr.flat.device, "crop ablation"):
        return crop_ablate_multi_plain(
            variant, pyr, num_classes, stencil, scan, class_weights,
            center_px, theta, scale, slot_vals, bucket_level, res,
            map_resolution)
    compact, table, fold, ctr, key = ms._tracked_inputs(
        pyr, num_classes, stencil, scan, class_weights, center_px, theta,
        scale, slot_vals, bucket_level, res, map_resolution)
    return _launch(variant, compact, table, 0, 0, num_classes, scan,
                   class_weights, fold, ctr, key)


# -- plain versions ----------------------------------------------------------
def crop_ablate_plain(variant, maps, num_classes, stencil, scan,
                      class_weights, center_px, theta, f,
                      map_resolution: float = 1.0):
    """Plain version of crop_ablate (any device)."""
    _variant(variant)
    packed = maps.packed
    if variant == "full":
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
                          class_weights, num_classes)


def crop_ablate_multi_plain(variant, pyr, num_classes, stencil, scan,
                            class_weights, center_px, theta, scale,
                            slot_vals, bucket_level, res,
                            map_resolution: float = 1.0):
    """Plain version of crop_ablate_multi (any device)."""
    _variant(variant)
    if variant == "full":
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
                          class_weights, num_classes)


def ablated_scores(variant, compact, table, fold, ctr, key, scan,
                   class_weights, num_classes: int):
    """The knocked-out variants' (cost, norm, kf) (N,) in plain PyTorch:
    compact (pixels, CP); table (K, 4) of each bucket's level (pixel
    offset, H, W, -); fold: fold_offsets of the K offset tables; ctr (N, 2)
    (cy, cx) on the particle's level; key (N,) bucket * Th + shift.  The
    rows go in crop_score.tracked_rows' order, TRACKED_TILE to a block,
    as the kernel takes them."""
    c = num_classes
    th, r = scan.shape[1:]
    dev = compact.device
    pix, npix, order, seg = fold
    w = cs.tracked_weights(scan, class_weights, order, seg).double()
    skey, perm = cs.tracked_rows(key)
    n = skey.shape[0]
    rows = torch.arange(n, device=dev)
    group = skey.long()
    if variant == "no_fold":  # the weights of the block's first run
        group = group[rows // cs.TRACKED_TILE * cs.TRACKED_TILE]
    bw, sw = group // th, group % th
    lv = table.long()[skey.long() // th]  # each row's own level
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
