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


# the row order's cases (crop_score.order_rows): name -> (groups, extent,
# kind); groups None orders by the group keys alone (kshift 0, no
# centres, tracked_rows').  kshift 30, 30, 26, 24, 20, 16, 10, 0.
ORDER_CASES = {
    "one_group": (1, 1024, "random"),
    "two_groups_one_empty": (2, 1 << 20, "empty"),
    "k12_half_empty": (12, 1536, "empty"),
    "shifts": (100, 1024, "random"),
    "g2000": (2000, 1536, "random"),
    "g16384": (1 << 14, 300, "random"),
    "g2p20": (1 << 20, 64, "random"),
    "every_key_equal": (5, 96, "equal"),
    "keys_alone": (None, 0, "random"),
}
ORDER_SIZES = (0, 1, 31, 4_097, 102_400)


def order_case(name: str, n: int, seed: int = 0):
    """(key (n,) int64, ctr (n, 2) int32 or None, groups, extent) of
    ORDER_CASES[name]: keys in [0, groups) (1,200 groups for the keys
    alone), the odd groups empty for "empty", one group and one centre
    for "equal"; centres from -extent to 2 extent (off both edges of the
    levels), the first two at the int32 range's ends."""
    groups, extent, kind = ORDER_CASES[name]
    rng = np.random.default_rng(seed + n)
    if kind == "equal":
        key = np.full(n, groups - 1, np.int64)
        ctr = np.full((n, 2), 7, np.int64)
    else:
        key = rng.integers(0, groups or 1200, n)
        if kind == "empty":
            key = key // 2 * 2
        ctr = rng.integers(-extent, 2 * extent + 1, (n, 2))
        ctr[:2] = np.array([[-2**31, 2**31 - 1], [2**31 - 1, -1]])[:n]
    return key, None if groups is None else ctr.astype(np.int32), groups, \
        extent


def order_rows_numpy(key, ctr, groups, extent):
    """crop_score.order_rows' result in numpy: (sorted keys int32, perm
    int64, kshift, row_start int64 or None): tracked_order_plain's keys
    and perm (with ctr None, a stable argsort of the keys as int32,
    kshift 0), and where groups <= ORDER_MAX_GROUPS each group's first row
    by np.searchsorted of its first key, then N."""
    from top_down_renderer_torch.filter import crop_score as cs

    key = np.asarray(key)
    if ctr is None:
        k32 = key.astype(np.int32)
        perm = np.argsort(k32, kind="stable").astype(np.int64)
        skey, kshift = k32[perm], 0
    else:
        skey, perm, kshift = cs.tracked_order_plain(key, ctr, groups, extent)
    starts = None
    if groups is not None and groups <= cs.ORDER_MAX_GROUPS:
        first = np.arange(groups, dtype=np.int64) << kshift
        starts = np.concatenate([np.searchsorted(skey, first),
                                 [len(key)]]).astype(np.int64)
    return skey, perm, kshift, starts
