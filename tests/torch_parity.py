"""Helpers shared by the port's parity tests (tests/test_torch_*.py).

Both packages get the same numpy inputs; JAX pytrees come back as nested
dicts of numpy arrays, the format of top_down_renderer_torch.utils.convert.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def to_numpy_tree(obj):
    """A reference pytree (flax dataclass) -> nested dict of numpy arrays;
    the PRNG key, which has no counterpart in the port, is left out."""
    if dataclasses.is_dataclass(obj):
        return {
            f.name: to_numpy_tree(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if f.name != "key"
        }
    if obj is None or isinstance(obj, (int, float, bool)):
        return obj
    return np.asarray(obj)


def np_(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else (
        np.asarray(t)
    )


def assert_rel(ref, got, tol, label=""):
    """max |got - ref| / max(|ref|, 1e-9) <= tol, NaN patterns equal."""
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape, (label, ref.shape, got.shape)
    nan = np.isnan(ref)
    np.testing.assert_array_equal(nan, np.isnan(got), err_msg=label)
    r, g = ref[~nan], got[~nan]
    if r.size == 0:
        return
    rel = np.abs(r - g) / np.maximum(np.abs(r), 1e-9)
    assert rel.max() <= tol, f"{label}: max rel {rel.max():.3g} > {tol}"


def tracked_pairs(skey, perm, ctr, kshift: int, th: int, levels, fold):
    """The hi/lo tracked kernels' row loop (csrc/crop_tracked.cuh) in plain
    PyTorch, on rows sorted as crop_score.tracked_order sorts them (skey,
    perm, kshift; ctr (N, 2) the particles' centres; levels (K, 4): each
    bucket's pixel offset, H, W, -; fold: fold_pixels' pix and npix
    first).  A row is inside where its centre +- its bucket's extent
    (init_extent) lies in its level; a block's run of one group takes its
    rows t = 0, 1, ... in order, and a warp scores rows t and t + 16 (t mod
    32 < 16) together where both are inside.  Returns (inside, paired)
    (N,) bool and each row's run (N,) int64, in the sorted rows' order:
    the shares of rows the card tests and tests/time_torch_tracked.py
    read."""
    from top_down_renderer_torch.filter.crop_score import (
        TRACKED_TILE,
        init_extent,
    )

    n = skey.shape[0]
    dev = skey.device
    group = skey.long() >> kshift
    bucket = group // th
    ext = init_extent(*fold[:2]).long()[bucket]
    lv = levels.long()[bucket]
    c = ctr.long()[perm]
    inside = ((c[:, 0] + ext[:, 0] >= 0) & (c[:, 0] + ext[:, 1] < lv[:, 1])
              & (c[:, 1] + ext[:, 2] >= 0) & (c[:, 1] + ext[:, 3] < lv[:, 2]))
    rows = torch.arange(n, device=dev)
    start = rows % TRACKED_TILE == 0
    start[1:] |= group[1:] != group[:-1]
    run = torch.cumsum(start.long(), 0) - 1
    run0 = torch.nonzero(start).reshape(-1)
    run1 = torch.cat([run0[1:], run0.new_full((1,), n)])
    t = rows - run0[run]
    half = 16  # the warps of a block (kWarps)
    first = t % (2 * half) < half
    partner = torch.where(first, rows + half, rows - half)
    there = torch.where(first, partner < run1[run], True)
    paired = inside & there & inside[partner.clamp(0, max(n - 1, 0))]
    return inside, paired, run
