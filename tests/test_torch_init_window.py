"""The theta searches' window route on the CPU: crop_init_kernel (the
float map with the hi/lo M), crop_init_i4_kernel (the code map with it)
and crop_init_lokf_kernel on the float and on the code map (the
single-plane M), csrc/crop_init.cuh: every theta search.

The kernels run only on the card (tests/test_torch_cuda.py, marked cuda:
each entry bit for bit in the particles' order, and against its plain
version).  Here the wrapper's part is held: the rows' order
(crop_score.init_order, the code tracked kernel's tracked_order with the
bucket as the group, against its numpy twin tracked_order_plain), which
init_inputs takes for every configuration; the buckets'
extents (crop_score.init_extent, kept with the fold by fold_extent), on
which a warp votes that its rows' windows lie in their level (every pixel
such a row reads lies in it, over centres, K buckets and levels); and the
unchecked gather, each pixel at its row's base plus its offset at the
level's row bytes for a warp that votes so, the checked one for the
others, against pixel_windows, bit for bit.  The theta search's result on
the CPU under the new order is held to JAX's by the existing tests of
test_torch_crop_score.py, test_torch_multiscale.py, test_torch_int4.py
and test_torch_lokf.py.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from top_down_renderer_torch.filter import crop_score as cs
from top_down_renderer_torch.filter import multiscale as ms
from top_down_renderer_torch.maps.polar import polar_stencil

from torch_parity import (
    ORDER_CASES,
    ORDER_SIZES,
    np_,
    order_case,
    order_rows_numpy,
)

torch.set_num_threads(2)

TH, R = 100, 25
KINDS = {"hilo": {"int4": False, "m_hilo": True},
         "i4": {"int4": True, "m_hilo": True},
         "lokf": {"int4": False, "m_hilo": False},
         "i4_lokf": {"int4": True, "m_hilo": False}}


SLOTS = (0.5, 1.0, 2.0)  # the K = 3 buckets' scales, on mips 1, 2, 4


def _case(where, kind, c, seed=0, h=72, w=88, n=700):
    """init_inputs of a theta search on a (h, w) c-class map (kind: a key
    of KINDS, or the CropMap arguments), uniform at f = 0.5 or over K = 3
    buckets (SLOTS), and each particle's bucket: centres in a 10 px
    corner cluster, spread, at the edges and far out."""
    rng = np.random.default_rng(seed)
    packed = np.zeros((h, w, 8), np.float32)
    packed[..., :c] = rng.random((h, w, c)) * 50
    packed[..., c] = (rng.random((h, w)) < 0.9).astype(np.float32)
    centers = np.concatenate([
        rng.uniform(0, 10, (n // 2, 2)),
        rng.uniform(-10, max(h, w) + 10, (n - n // 2 - 4, 2)),
        [[0.0, 0.0], [w - 1.0, h - 1.0], [-400.0, 20.0], [30.0, 900.0]],
    ]).astype(np.float32)
    scan = torch.as_tensor((rng.random((c, TH, R)) * 3).astype(np.float32))
    cw = torch.as_tensor((0.5 + rng.random(c)).astype(np.float32))
    sten = torch.as_tensor(polar_stencil(TH, R))
    ctr = torch.as_tensor(centers)
    kw = KINDS[kind] if isinstance(kind, str) else kind
    if where == "uniform":
        maps = cs.CropMap(torch.as_tensor(packed), **kw)
        return (cs.init_inputs(maps, c, sten, scan, cw, ctr, 0.5),
                torch.zeros(n, dtype=torch.int32))
    pyr = ms.build_pyramid_maps(torch.as_tensor(packed), (1, 2, 4), **kw)
    scale = torch.as_tensor(np.resize(np.float32(SLOTS), n))
    slots = torch.tensor(SLOTS)
    return (ms.init_inputs(pyr, c, sten, scan, cw, ctr, scale, slots,
                           (0, 1, 2), 1.0),
            ms.assign_buckets(scale, slots))


def _levels(inputs):
    """The inputs' levels (K, 4) and the map buffer: (levels, flat bytes
    (pixels, elem) uint8)."""
    maps, table, h, w, c = inputs[:5]
    if table is None:
        table = torch.tensor([[0, h, w, 0]], dtype=torch.int32)
    operand = maps.operand(c)
    flat = operand.reshape(-1, operand.shape[-1])
    return table, np_(flat).view(np.uint8).reshape(flat.shape[0], -1)


def _groups(row_start, size):
    """Each sorted row's group of `size` rows from its bucket's first row
    (the kernel's tiles at INIT_TILE, its warps at 16) and its bucket."""
    rs = np_(row_start).astype(np.int64)
    row = np.arange(rs[-1])
    bucket = np.searchsorted(rs, row, side="right") - 1
    tiles = -(-(rs[1:] - rs[:-1]) // size)
    first = np.concatenate([[0], np.cumsum(tiles)])
    return first[bucket] + (row - rs[bucket]) // size, bucket


def _inside(ctr, ext, lv):
    """Whether each centre's window (ctr (n, 2) + the extent ext (4,))
    lies in the level lv (pixel offset, H, W, -)."""
    return ((ctr[:, 0] + ext[0] >= 0) & (ctr[:, 0] + ext[1] < lv[1])
            & (ctr[:, 1] + ext[2] >= 0) & (ctr[:, 1] + ext[3] < lv[2]))


@pytest.mark.parametrize("where", ["uniform", "buckets"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_init_order_is_tracked_order_plain_by_bucket(where, kind):
    """The window route's rows (init_inputs, init_order) are
    tracked_order_plain's with the bucket as the group, bit for bit:
    bucket-major, each bucket's by the Morton code of its centres' tiles;
    row_start bounds each bucket's rows; every tile of INIT_TILE rows
    lies in one bucket."""
    inputs, bucket = _case(where, kind, 3)
    assert cs.init_window(inputs[0])
    ctr, perm, row_start = inputs[8], inputs[9], inputs[10]
    assert perm.dtype == torch.int32 and row_start.dtype == torch.int64
    k = row_start.shape[0] - 1
    extent = max(inputs[2:4]) if where == "uniform" else cs._level_extent(
        inputs[0], 0, 0)
    _, pperm, _ = cs.tracked_order_plain(np_(bucket), np_(ctr), k, extent)
    np.testing.assert_array_equal(np_(perm), pperm)
    np.testing.assert_array_equal(
        np_(row_start), np.concatenate([[0], np.cumsum(np.bincount(
            np_(bucket), minlength=k))]))
    assert k == (1 if where == "uniform" else len(set(np_(bucket).tolist())))
    tile, _ = _groups(row_start, cs.INIT_TILE)
    sorted_bucket = np_(bucket)[np_(perm)]
    for t in np.unique(tile):
        assert len(set(sorted_bucket[tile == t].tolist())) == 1
    assert np.bincount(tile).max() <= cs.INIT_TILE


STARTS_CASES = [c for c, (g, _, _) in ORDER_CASES.items()
                if g is not None and g <= cs.ORDER_MAX_GROUPS]


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", ORDER_SIZES)
@pytest.mark.parametrize("case", STARTS_CASES)
def test_order_rows_plain_starts_are_searchsorted(case, n, index_dtype):
    """order_rows on the CPU with the groups' first rows (init_order's
    form): perm in either index type and row_start (K + 1,) int64 equal
    order_rows_numpy's (tracked_order_plain, np.searchsorted of each
    group's first key, then N) bit for bit: K = 1, 2, 12 and 100 groups,
    empty ones among them, every key equal, N = 0 to 102,400, centres off
    both edges; row_start is also each group's count summed; init_order
    returns the int32 form."""
    key, ctr, groups, extent = order_case(case, n)
    skey, perm, kshift, starts = order_rows_numpy(key, ctr, groups, extent)
    np.testing.assert_array_equal(starts, np.concatenate(
        [[0], np.cumsum(np.bincount(key, minlength=groups))]))
    tkey, tctr = torch.as_tensor(key), torch.as_tensor(ctr)
    got = cs.order_rows(tkey, tctr, groups, extent, index_dtype=index_dtype,
                        starts=True)
    assert got[1].dtype == index_dtype and got[3].dtype == torch.int64
    assert got[2] == kshift
    np.testing.assert_array_equal(np_(got[0]), skey)
    np.testing.assert_array_equal(np_(got[1]), perm)
    np.testing.assert_array_equal(np_(got[3]), starts)
    if index_dtype == torch.int32:
        want = cs.init_order(tkey, tctr, groups, extent)
        assert torch.equal(want[0], got[1]) and torch.equal(want[1], got[3])


@pytest.mark.parametrize("where", ["uniform", "buckets"])
def test_every_theta_search_takes_the_window_route(where):
    """Every configuration's theta search is on the window route, the
    float map with the hi/lo M too: its init_inputs' rows are
    init_order's (perm and row_start), no longer the particles' order
    (bucket_rows'), and their extents are the fold's."""
    for kind in KINDS:
        assert cs.init_window(_case(where, kind, 3, n=40)[0][0])
    inputs, bucket = _case(where, "hilo", 3)
    ctr, perm, row_start = inputs[8], inputs[9], inputs[10]
    k = row_start.shape[0] - 1
    extent = max(inputs[2:4]) if where == "uniform" else cs._level_extent(
        inputs[0], 0, 0)
    want = cs.init_order(bucket, ctr, k, extent)
    assert torch.equal(perm, want[0]) and torch.equal(row_start, want[1])
    assert not torch.equal(perm, ms.bucket_rows(bucket, k)[0])
    np.testing.assert_array_equal(np_(row_start), np_(ms.bucket_rows(
        bucket, k)[1]))


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_init_extent_covers_every_pixel_an_inside_row_reads(data):
    """init_extent is each bucket's least and greatest dy, dx of its
    distinct pixels (padding pixels left out), and a row whose window
    (centre + the extent) lies in its level reads only pixels of the
    level: K = 1-3 buckets on levels back to back from any pixel, centres
    spread, clustered, at the edges and far out."""
    k = data.draw(st.integers(1, 3))
    seed = data.draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    levels, off = [], int(rng.integers(0, 8))
    for _ in range(k):
        h, w = (int(v) for v in rng.integers(1, 41, 2))
        levels.append((off, h, w, 0))
        off += h * w + int(rng.integers(0, 6))
    p = 8
    pix = torch.full((k, p, 2), cs.PAD_PIX, dtype=torch.int32)
    npix = torch.as_tensor(rng.integers(1, p + 1, k).astype(np.int32))
    for b in range(k):
        pix[b, : npix[b]] = torch.as_tensor(
            rng.integers(-12, 13, (int(npix[b]), 2)).astype(np.int32))
    ext = np_(cs.init_extent(pix, npix)).astype(np.int64)
    n = int(rng.integers(1, 500))
    ctr = rng.integers(-20, 61, (n, 2))
    ctr[rng.random(n) < 0.3] = rng.integers(0, 6, 2)  # a cluster
    ctr[rng.random(n) < 0.02] = [-(2**20), 2**20]  # far out
    bucket = rng.integers(0, k, n)
    for b in range(k):
        d = np_(pix).astype(np.int64)[b, : npix[b]]
        assert tuple(ext[b]) == (d[:, 0].min(), d[:, 0].max(),
                                 d[:, 1].min(), d[:, 1].max())
        c = ctr[bucket == b]
        lv = levels[b]
        inside = _inside(c, ext[b], lv)
        y = c[:, None, 0] + d[:, 0]
        x = c[:, None, 1] + d[:, 1]
        read = (y >= 0) & (y < lv[1]) & (x >= 0) & (x < lv[2])
        assert read[inside].all()


@pytest.mark.parametrize("where,kind,c", [
    ("uniform", "i4", 3), ("uniform", "lokf", 3), ("uniform", "lokf", 1),
    ("uniform", "i4", 6), ("buckets", "i4", 3), ("buckets", "lokf", 6),
    ("buckets", "i4", 1), ("uniform", "i4_lokf", 3), ("buckets", "i4_lokf", 3),
    ("uniform", "hilo", 3), ("buckets", "hilo", 6), ("uniform", "hilo", 1),
])
def test_init_unchecked_gather_equals_pixel_windows(where, kind, c):
    """Each row's pixels as the kernel reads them (a warp of 16 sorted rows
    of one bucket whose windows all lie in their level: at the row's base
    in the level plus each pixel's offset dy (row bytes) + dx E, no check;
    the other warps at each in-level pixel's place, zeros outside) equal
    pixel_windows' gather of the map buffer bit for bit, on the code and
    the float map, at the edges and far out; some warps take each
    gather."""
    inputs, _ = _case(where, kind, c, h=144, w=160, n=3000)
    levels, buf = _levels(inputs)
    elem = buf.shape[1]
    pix, npix = inputs[7][:2]
    ctr, perm, row_start = inputs[8], inputs[9], inputs[10]
    ext = np_(cs.fold_extent(inputs[7])).astype(np.int64)
    warp, bucket = _groups(row_start, 16)
    p = np_(perm).astype(np.int64)
    cc = np_(ctr).astype(np.int64)[p]
    lv = np_(levels).astype(np.int64)[bucket]
    inside = _inside(cc, ext[bucket].T, lv.T)
    # a warp's vote: all 16 of its rows (a short warp's missing rows lie
    # far out)
    votes = np.bincount(warp, inside) == 16
    inside = votes[warp]
    assert inside.any() and not inside.all()
    flat = buf.reshape(-1)
    got = []
    for b in np.unique(bucket):
        rows = bucket == b
        d = np_(pix).astype(np.int64)[b, : npix[b]]
        y = cc[rows, None, 0] + d[:, 0]
        x = cc[rows, None, 1] + d[:, 1]
        lb = lv[rows][0]
        read = (y >= 0) & (y < lb[1]) & (x >= 0) & (x < lb[2])
        base = (lb[0] + cc[rows, 0] * lb[2] + cc[rows, 1]) * elem
        at = np.where(inside[rows, None],
                      base[:, None] + d[:, 0] * lb[2] * elem + d[:, 1] * elem,
                      (lb[0] + y * lb[2] + x) * elem)
        assert (at[inside[rows]] >= 0).all()
        take = inside[rows, None] | read
        idx = np.where(take, at, 0)[..., None] + np.arange(elem)
        vals = np.where(take[..., None], flat[idx], 0)
        want = cs.pixel_windows(torch.as_tensor(buf), levels,
                                torch.full((int(rows.sum()),), int(b)),
                                ctr[perm[torch.as_tensor(rows)].long()],
                                pix)[:, : npix[b]]
        np.testing.assert_array_equal(vals, np_(want).astype(np.uint8))
        got.append(len(vals))
    assert sum(got) == len(p)


def test_fold_extent_is_kept_for_its_fold():
    """fold_extent gives the fold's init_extent, the same tensor again for
    the fold that CropMap.fold keeps (no launch a call), and a new one for
    a new fold."""
    maps = cs.CropMap(torch.zeros((40, 50, 8)), int4=False, m_hilo=False)
    sten = torch.as_tensor(polar_stencil(TH, R))
    fold = maps.fold(sten, 0.5)
    first = cs.fold_extent(fold)
    assert torch.equal(first, cs.init_extent(*fold[:2]))
    assert maps.fold(sten, 0.5) is fold
    assert cs.fold_extent(maps.fold(sten, 0.5)) is first
    other = maps.fold(sten, 1.5)
    wider = cs.fold_extent(other)
    assert torch.equal(wider, cs.init_extent(*other[:2]))
    assert (wider[0, 1::2] > first[0, 1::2]).all()
