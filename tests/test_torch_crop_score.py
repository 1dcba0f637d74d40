"""Port parity of the crop scorer (filter/crop_score.py, counterpart of
filter/pallas_score.py).

On integer centres the port's shared-offset sampling picks exactly the
exact path's pixels, so its costs equal the JAX exact scorer up to float
summation order (rel <= 1e-4).  On float centres it follows the JAX
crop kernel's sampling, run here in interpret mode, within that
kernel's own bounds (its map and M are int8-quantized).  The CUDA
kernel itself is compared with the plain version in
tests/test_torch_cuda.py, which imports no JAX so that it runs on the
card.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from top_down_renderer_tpu.filter import pallas_score as ps
from top_down_renderer_tpu.filter.filter import select_init_cost as sel_j
from top_down_renderer_tpu.filter.scoring import (
    rotation_shift as rotation_shift_j,
    score_all_rotations,
    search_shifts as search_shifts_j,
)
from top_down_renderer_torch import kernels
from top_down_renderer_torch.filter import crop_score as cs
from top_down_renderer_torch.filter import multiscale as ms
from top_down_renderer_torch.filter.filter import select_init_cost
from top_down_renderer_torch.filter.scoring import rotation_shift
from top_down_renderer_torch.maps.polar import polar_stencil

from test_pallas_interpret import _check, _centers
from torch_parity import (
    ORDER_CASES,
    ORDER_SIZES,
    assert_rel,
    np_,
    order_case,
    order_rows_numpy,
)

torch.set_num_threads(2)

H = W = 160
C = 3
TH, R = 100, 25
F = 0.5  # -> mo bucket 12
N = 256


def _world(seed=3, h=H, w=W):
    rng = np.random.default_rng(seed)
    packed = np.zeros((h, w, 8), np.float32)
    packed[..., :C] = rng.random((h, w, C)) * 50
    packed[..., C] = (rng.random((h, w)) < 0.9).astype(np.float32)
    scan = (rng.random((C, TH, R)) * 3).astype(np.float32)
    return packed, scan, rng


CW = np.asarray([1.0, 2.0, 0.5], np.float32)
STENCIL = polar_stencil(TH, R)

# the shift tables as the reference's compiled step derives them
SSH = np.asarray(jax.jit(lambda: search_shifts_j(TH, 40))())


def _shifts_j(thetas):
    return np.asarray(
        jax.jit(lambda t: rotation_shift_j(t, TH))(jnp.asarray(thetas))
    )


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _exact_j(packed, scan, centers, f, mres=1.0):
    costs, kf = score_all_rotations(
        jnp.asarray(packed), jnp.asarray(STENCIL), jnp.asarray(scan),
        jnp.asarray(CW), jnp.asarray(centers),
        jnp.full(len(centers), 1.0, jnp.float32), jnp.asarray(f, jnp.float32),
        num_classes=C, map_resolution=mres, chunk_size=len(centers),
    )
    return np.asarray(costs), np.asarray(kf)


def _ratio(num, den):
    with np.errstate(invalid="ignore", divide="ignore"):
        return np_(num) / np_(den)


def _tracked_cost(num, den, kf):
    num, den, kf = np_(num), np_(den), np_(kf)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(kf < 0.5, np.nan, num / den)


def _init_costs(nums, dens, kf):
    nums, dens, kf = np_(nums), np_(dens), np_(kf)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(kf[:, None] < 0.5, np.nan, nums / dens)


@pytest.fixture(scope="module")
def world():
    packed, scan, rng = _world()
    centers = _centers(rng)  # integer: residual grid, edges, far, random
    thetas = (rng.random(N) * 2 * np.pi).astype(np.float32)
    costs_e, kf_e = _exact_j(packed, scan, centers, F)
    return packed, scan, centers, thetas, costs_e, kf_e


@pytest.mark.parametrize("mode", ["tracked", "init"])
def test_integer_centres_equal_exact(world, mode):
    packed, scan, centers, thetas, costs_e, kf_e = world
    args = _t(packed, STENCIL, scan, CW, centers)
    if mode == "tracked":
        num, den, kf = cs.score_tracked_plain(
            args[0], C, *args[1:], torch.as_tensor(thetas), F
        )
        ref = costs_e[np.arange(N), _shifts_j(thetas)]
        got = _tracked_cost(num, den, kf)
    else:
        nums, dens, kf = cs.score_init_raw_plain(args[0], C, *args[1:], F)
        ref = costs_e[:, SSH]
        got = _init_costs(nums, dens, kf)
    np.testing.assert_array_equal(np_(kf), kf_e)
    ok = kf_e >= 0.5
    assert ok.sum() > 200 and (~ok).sum() >= 2  # edges / far-out covered
    assert_rel(ref[ok], got[ok], 1e-4, mode)
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(got))


@pytest.fixture(scope="module")
def float_world():
    packed, scan, rng = _world(5)
    centers = _centers(rng)
    centers[:128] += rng.uniform(-0.5, 0.5, (128, 2)).astype(np.float32)
    centers[135:] += rng.uniform(-0.5, 0.5, (N - 135, 2)).astype(np.float32)
    thetas = (rng.random(N) * 2 * np.pi).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ps, "tracked_p_tile", lambda mo, **kw: 16)
        mp.setattr(ps, "init_p_tile", lambda mo, **kw: 16)
        maps = ps.build_padded_maps(jnp.asarray(packed))
        jargs = (maps, jnp.asarray(STENCIL), jnp.asarray(scan),
                 jnp.asarray(CW), jnp.asarray(centers))
        mo = ps.pick_crop_size(F, R)
        tracked = ps.score_tracked_fast_mo(
            *jargs, jnp.asarray(thetas), F, mo, interpret=True
        )
        raw = ps.score_init_fast_mo(*jargs, F, mo, interpret=True)
        sel = ps.score_init_sel_mo(*jargs, F, mo, interpret=True)
    ref = {
        k: tuple(np.asarray(a) for a in v)
        for k, v in (("tracked", tracked), ("raw", raw), ("sel", sel))
    }
    return packed, scan, centers, thetas, ref


def test_float_centres_tracked_vs_jax_kernel(float_world):
    packed, scan, centers, thetas, ref = float_world
    args = _t(packed, STENCIL, scan, CW, centers)
    num, den, kf = cs.score_tracked(
        cs.CropMap(args[0]), C, *args[1:], torch.as_tensor(thetas), F
    )
    rn, rd, rkf = ref["tracked"]
    _check(_ratio(rn, rd), _ratio(num, den), rkf, np_(kf), "tracked")


def test_float_centres_init_vs_jax_kernel(float_world):
    packed, scan, centers, thetas, ref = float_world
    args = _t(packed, STENCIL, scan, CW, centers)
    nums, dens, kf = cs.score_init_raw_plain(args[0], C, *args[1:], F)
    rn, rd, rkf = ref["raw"]
    for j in range(0, 40, 3):
        _check(
            _ratio(rn[:, j], rd[:, j]), _ratio(nums[:, j], dens[:, j]), rkf,
            np_(kf), f"init shift {j}",
        )
    best, k, kf2 = cs.score_init_sel(cs.CropMap(args[0]), C, *args[1:], F)
    rbest, rtheta, rkf2 = ref["sel"]
    got_theta = np_(k).astype(np.float32) * np.float32(2 * math.pi / 40)
    finite = rbest < cs.FLT_MAX
    np.testing.assert_array_equal(np_(best) < cs.FLT_MAX, finite)
    _check(rbest[finite], np_(best)[finite], rkf2[finite],
           np_(kf2)[finite], "sel_init best")
    assert np.mean(np.isclose(got_theta, rtheta)[finite]) > 0.9


@pytest.fixture(scope="module")
def mip_world():
    """test_mip_crop_parity's setup: 320^2 map, mip 4, f = 4 -> f/mip = 1
    (bucket 24), centres on multiples of the mip."""
    mip, f = 4, 4.0
    rng = np.random.default_rng(11)
    packed = np.zeros((320, 320, 8), np.float32)
    packed[..., :C] = rng.random((320, 320, C)) * 50
    packed[..., C] = (rng.random((320, 320)) < 0.9).astype(np.float32)
    scan = (rng.random((C, TH, R)) * 3).astype(np.float32)
    n = 128
    xs, ys = np.meshgrid(np.arange(16), np.arange(7))
    grid = np.stack([120.0 + mip * xs.ravel(), 120.0 + mip * ys.ravel()], -1)
    rnd = mip * rng.integers(8, (320 - 32) // mip, (n - len(grid), 2))
    centers = np.concatenate([grid, rnd]).astype(np.float32)
    return packed, scan, centers, mip, f


def test_mip4_equals_exact_on_the_mip_map(mip_world):
    packed, scan, centers, mip, f = mip_world
    dist_mip = cs.mip_map(torch.as_tensor(packed), mip)
    nums, dens, kf = cs.score_init_raw_plain(
        dist_mip, C, *_t(STENCIL, scan, CW, centers), f / mip,
        map_resolution=float(mip),
    )
    costs_e, kf_e = _exact_j(
        packed[::mip, ::mip], scan, centers, f / mip, float(mip)
    )
    ref = costs_e[:, SSH]
    np.testing.assert_array_equal(np_(kf), kf_e)
    assert_rel(ref, _init_costs(nums, dens, kf), 1e-4, "mip4 vs exact")


def test_mip4_vs_jax_kernel(mip_world, monkeypatch):
    packed, scan, centers, mip, f = mip_world
    monkeypatch.setattr(ps, "init_p_tile", lambda mo, **kw: 16)
    maps = ps.build_padded_maps(jnp.asarray(packed[::mip, ::mip]))
    rn, rd, rkf = (np.asarray(a) for a in ps.score_init_fast_mo(
        maps, jnp.asarray(STENCIL), jnp.asarray(scan), jnp.asarray(CW),
        jnp.asarray(centers), f / mip, ps.pick_crop_size(f / mip, R),
        map_resolution=float(mip), interpret=True,
    ))
    nums, dens, kf = cs.score_init_raw_plain(
        cs.mip_map(torch.as_tensor(packed), mip), C,
        *_t(STENCIL, scan, CW, centers), f / mip,
        map_resolution=float(mip),
    )
    kf_b = np.broadcast_to(np_(kf)[:, None], rn.shape)
    rkf_b = np.broadcast_to(rkf[:, None], rn.shape)
    _check(_ratio(rn, rd).ravel(), _ratio(nums, dens).ravel(),
           rkf_b.ravel(), kf_b.ravel(), "mip4")


@pytest.mark.parametrize("case", ["random", "zero_scan", "unknown_block"])
def test_sel_init_equals_raw_rows_through_select(case):
    """score_init_sel == its raw rows fed through select_init_cost (both
    packages' versions), NaN rows and the kf < 0.5 gate included."""
    packed, scan, rng = _world(9, 96, 96)
    if case == "zero_scan":
        scan[:] = 0.0  # every cost 0/0 = NaN -> (FLT_MAX, k 0)
    if case == "unknown_block":
        packed[20:70, 20:70, C] = 0.0  # kf < 0.5 inside the block
    centers = rng.uniform(-10, 106, (200, 2)).astype(np.float32)
    args = _t(packed, STENCIL, scan, CW, centers)
    best, k, kf = cs.score_init_sel(cs.CropMap(args[0]), C, *args[1:],
                                    0.5)
    nums, dens, kf_raw = cs.score_init_raw_plain(args[0], C, *args[1:], 0.5)
    costs = _init_costs(nums, dens, kf_raw)
    ref_cost, ref_theta = select_init_cost(torch.as_tensor(costs), 40)
    jcost, jtheta = sel_j(jnp.asarray(costs), 40)
    np.testing.assert_array_equal(np_(kf), np_(kf_raw))
    np.testing.assert_array_equal(np_(best), np_(ref_cost))
    np.testing.assert_array_equal(np_(best), np.asarray(jcost))
    theta = np_(k).astype(np.float32) * np.float32(2 * math.pi / 40)
    np.testing.assert_array_equal(theta, np_(ref_theta))
    np.testing.assert_allclose(theta, np.asarray(jtheta), rtol=0, atol=1e-6)
    if case != "random":
        assert (np_(best) == cs.FLT_MAX).any() and (np_(k) == 0).any()


def test_cpu_wrapper_runs_plain_version_and_counts_nothing(world):
    packed, scan, centers, thetas, _, _ = world
    args = _t(packed, STENCIL, scan, CW, centers)
    kernels.reset_launch_counts()
    got = cs.score_tracked(cs.CropMap(args[0]), C, *args[1:],
                           torch.as_tensor(thetas), F)
    ref = cs.score_tracked_plain(
        args[0], C, *args[1:], torch.as_tensor(thetas), F
    )
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np_(a), np_(b))
    assert sum(kernels.LAUNCHES.values()) == 0


@pytest.mark.parametrize("fn", ["score_tracked", "score_init_sel"])
def test_wrapper_raises_off_cpu_and_cuda(fn):
    meta = cs.CropMap(torch.zeros((16, 16, 8), device="meta"))
    args = [meta, C] + [torch.zeros(s, device="meta") for s in
                        ((TH, R, 2), (C, TH, R), (C,), (4, 2))]
    extra = [torch.zeros(4, device="meta")] if fn == "score_tracked" else []
    with pytest.raises(ValueError, match="no crop scorer"):
        getattr(cs, fn)(*args, *extra, 0.5)


def test_crop_map_makes_its_compact_copy_once():
    """A CropMap keeps compact(num_classes) beside its packed map: made on
    first use as compact_map, then the same tensor on every call."""
    packed, _, _ = _world(4, 32, 32)
    maps = cs.CropMap(torch.as_tensor(packed))
    a = maps.compact(C)
    assert maps.compact(C) is a
    np.testing.assert_array_equal(np_(a), np_(cs.compact_map(maps.packed, C)))
    assert maps.compact(1).shape == (32, 32, 2)


def test_offsets_and_centres_follow_reference_rounding():
    """round(stencil * f) in float32 and round(center / mres): the same
    integers as the reference crop kernel's _stencil_pix / _origins."""
    for f in (0.5, 1.0, 0.37, 0.96):
        off = np_(cs.crop_offsets(torch.as_tensor(STENCIL), f))
        ref = np.round(STENCIL.reshape(-1, 2) * np.float32(f)).astype(np.int32)
        np.testing.assert_array_equal(off, ref)
    c = np.array([[2.5, 3.5], [-0.5, 7.49], [1e12, -1e12], [np.nan, 4]],
                 np.float32)
    got = np_(cs.crop_centers(torch.as_tensor(c), 1.0))
    np.testing.assert_array_equal(got[:2], [[4, 2], [7, -0]])
    assert (np.abs(got[2:]).max(1) >= 2**20).all()


def test_kernel_operand_checks():
    """What the CUDA wrapper accepts, checked on CPU tensors: strided
    particle views (the resample's unpacked rows) and a strided packed map
    are fine (the kernel reads the compact copy), a wrong dtype, channel
    count or class count is refused."""
    packed, scan, rng = _world(4, 32, 32)
    rows = torch.as_tensor(rng.random((64, 8)).astype(np.float32)) * 30
    m, sten, sc, cw = _t(packed, STENCIL, scan, CW)
    for mm in (m, m.transpose(0, 1)):
        maps = cs.CropMap(mm)
        compact, fold, ctr, shift = cs._tracked_inputs(
            maps, C, sten, sc, cw, rows[:, 0:2], rows[:, 2], 0.5, 1.0)
        assert compact is maps.compact(C) and compact.shape == (32, 32, 4)
        assert fold is maps.fold(sten, 0.5)
        assert fold[0].shape == (1, -(-TH * R // 16) * 16, 2)
        assert ctr.shape == (64, 2)
        assert fold[0].dtype == ctr.dtype == torch.int32
        assert ctr.is_contiguous() and shift.shape == (64,)
        assert (shift >= 0).all() and (shift < TH).all()
    bad = [
        (m.double(), C, sc, rows[:, 2]),  # dtype
        (m[..., :4].contiguous(), C, sc, rows[:, 2]),  # channels != 8
        (m, 4, sc, rows[:, 2]),  # classes != scan classes
        (m, 8, torch.ones((8, TH, R)), rows[:, 2]),  # known channel 8
        (m, C, sc, rows[:5, 2]),  # one theta per particle
    ]
    for mm, cc, ss, th in bad:
        with pytest.raises((ValueError, TypeError)):
            cs._tracked_inputs(cs.CropMap(mm), cc, sten, ss,
                               torch.ones(ss.shape[0]), rows[:, 0:2], th,
                               0.5, 1.0)


# -- the tracked kernel's folded product -----------------------------------
def _folded(packed, c, sten, scan, cw, centers, thetas, f, rows=None):
    """The tracked kernel's computation in plain PyTorch at one uniform
    scale: the offsets folded to their distinct pixels, the weights at
    every shift, each particle's window of those pixels on the compact
    map.  rows "position": over the rows in tracked_order (the kernel's,
    each shift's by position), each row's result put back on its
    particle."""
    pix, _, order, seg = cs.fold_offsets(cs.crop_offsets(sten, f)[None])
    w = cs.tracked_weights(scan, cw, order, seg)
    h, wd = packed.shape[:2]
    ctr = cs.crop_centers(centers, 1.0)
    shift = rotation_shift(thetas, scan.shape[1])
    perm = torch.arange(len(ctr))
    if rows == "position":
        perm = cs.tracked_order(shift, ctr, scan.shape[1], max(h, wd))[1]
    got = cs.folded_scores(
        cs.compact_map(packed, c).reshape(h * wd, -1),
        torch.tensor([[0, h, wd, 0]]), ctr[perm], pix, w,
        torch.zeros(len(ctr), dtype=torch.int32), shift[perm], c)
    back = torch.empty((3, len(ctr)), dtype=got[0].dtype)
    back[:, perm] = torch.stack(got)
    return tuple(back)


@pytest.mark.parametrize("c,f", [(1, 1.0), (3, 0.5), (3, 1.0), (6, 0.37),
                                 (7, 1.0)])
def test_folded_product_equals_tracked_plain(c, f):
    """fold_offsets, tracked_weights and folded_scores (the tracked
    kernel's fold and product) equal the plain version: rel 1e-5, kf
    bit-equal; every shift, thetas negative and over two turns, windows
    across the map's edges and far outside it."""
    rng = np.random.default_rng(int(f * 100) + c)
    packed = np.zeros((64, 80, 8), np.float32)
    packed[..., :c] = rng.random((64, 80, c)) * 50
    packed[..., c] = (rng.random((64, 80)) < 0.9).astype(np.float32)
    scan = (rng.random((c, TH, R)) * 3).astype(np.float32)
    centers = rng.uniform(-20, 100, (160, 2)).astype(np.float32)
    centers[:3] = [[0.0, 0.0], [79.0, 63.0], [-500.0, 30.0]]
    thetas = (rng.random(160) * 4 * np.pi - np.pi).astype(np.float32)
    thetas[:TH] = np.arange(TH) * np.float32(2 * math.pi / TH) - 2 * math.pi
    cw = (0.5 + rng.random(c)).astype(np.float32)
    args = _t(packed, STENCIL, scan, cw, centers, thetas)
    assert len(set(rotation_shift(args[5], TH).tolist())) == TH
    cost, norm, kf = cs.score_tracked_plain(args[0], c, *args[1:], f)
    got = _folded(args[0], c, *args[1:], f)
    np.testing.assert_array_equal(np_(got[2]), np_(kf))
    assert_rel(np_(cost), np_(got[0]), 1e-5, "cost")
    assert_rel(np_(norm), np_(got[1]), 1e-5, "norm")
    assert (np_(kf) == 0).any() and (np_(kf) > 0.5).any()


@pytest.mark.parametrize("rows", [None, "position"])
def test_folded_product_holds_the_jax_tracked_kernel_bounds(float_world,
                                                             rows):
    """The tracked kernel's fold against the JAX tracked kernel
    (interpret mode) on float centres, within
    test_float_centres_tracked_vs_jax_kernel's bounds: in the particles'
    order, and over tracked_order's rows (the kernel's) put back on the
    particles."""
    packed, scan, centers, thetas, ref = float_world
    args = _t(packed, STENCIL, scan, CW, centers, thetas)
    num, den, kf = _folded(args[0], C, *args[1:], F, rows)
    rn, rd, rkf = ref["tracked"]
    _check(_ratio(rn, rd), _ratio(num, den), rkf, np_(kf), "folded tracked")


@pytest.mark.parametrize("fs", [(1.0,), (0.5, 1.0, 0.37, 0.96)])
def test_fold_csr_covers_every_cell_once_in_order(fs):
    """fold_offsets' CSR: every cell of every table on exactly one slot,
    the slot of its own pixel in its own table, the cells of a slot in
    increasing order, none on a padding slot; cell_slots reads the slot
    of each CSR entry."""
    off = cs.crop_offsets(torch.as_tensor(STENCIL),
                          torch.tensor(fs)[:, None, None])
    pix, npix, order, seg = cs.fold_offsets(off)
    k, cap = pix.shape[:2]
    tr = TH * R
    for t in (pix, npix, order, seg):
        assert t.dtype == torch.int32
    slots = np_(cs.cell_slots(seg, k * tr))
    order, seg = np_(order), np_(seg).astype(np.int64)
    assert seg[0] == 0 and seg[-1] == k * tr
    counts = np.diff(seg)
    assert (counts >= 0).all()
    np.testing.assert_array_equal(np.sort(order), np.arange(k * tr))
    on = np.repeat(np.arange(k * cap), counts)  # slot of each CSR entry
    np.testing.assert_array_equal(slots, on)
    np.testing.assert_array_equal(on // cap, order // tr)
    assert (np.diff(order)[on[1:] == on[:-1]] > 0).all()
    np.testing.assert_array_equal(np_(pix).reshape(-1, 2)[on],
                                  np_(off).reshape(-1, 2)[order])
    per = counts.reshape(k, cap)
    for b in range(k):
        assert (per[b, : int(npix[b])] > 0).all()
        assert (per[b, int(npix[b]):] == 0).all()


def _fold_numpy(off):
    """fold_offsets' result by another route, in numpy: per table the
    distinct rows of np.unique (row-major), and the cells by a stable
    argsort of np.unique's inverse; P = Th*R rounded up to 16."""
    k, tr = off.shape[:2]
    cap = -(-tr // 16) * 16
    pix = np.full((k, cap, 2), cs.PAD_PIX, np.int64)
    npix = np.zeros(k, np.int64)
    order = np.zeros(k * tr, np.int64)
    counts = np.zeros((k, cap), np.int64)
    for b in range(k):
        uniq, inv = np.unique(off[b], axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        npix[b] = len(uniq)
        pix[b, : len(uniq)] = uniq
        order[b * tr : (b + 1) * tr] = b * tr + np.argsort(inv, kind="stable")
        counts[b, : len(uniq)] = np.bincount(inv)
    seg = np.concatenate([[0], np.cumsum(counts.reshape(-1))])
    return pix, npix, order, seg


def _d2_offsets():
    """The K = 12 offset tables of chip_smoke D2's buckets: the 10 scale
    hypotheses 10^(k/10) at res 0.5."""
    hyp = (10.0 ** (np.arange(10) / 10.0)).astype(np.float32)
    _, slots, mips = ms.plan_buckets(hyp, R, 0.5, 10.0)
    return ms.bucket_offsets(torch.as_tensor(STENCIL), torch.as_tensor(slots),
                             0.5, torch.as_tensor(mips, dtype=torch.float32))


@pytest.mark.parametrize("case", [
    "k1_f1", "k1_f0.01", "k1_f40", "k1_f80000", "k1_negative", "k1_one_cell",
    "k12_d2", "k12_f0.01", "k12_f40",
])
def test_fold_offsets_equals_numpy_unique(case):
    """fold_offsets, the fold kernel's yardstick on the card, equals a
    numpy fold (_fold_numpy) exactly: one table and twelve (D2's
    buckets; 12 scales from 0.01 and from 40), every cell on one pixel
    (f = 0.01), boxes 1,921 px and ~4e6 px a side (f = 40, 80,000),
    every offset negative, a table of one cell."""
    sten = torch.as_tensor(STENCIL)
    grow = torch.tensor(10.0 ** (np.arange(12) / 10.0), dtype=torch.float32)
    off = {
        "k1_f1": lambda: cs.crop_offsets(sten, 1.0)[None],
        "k1_f0.01": lambda: cs.crop_offsets(sten, 0.01)[None],
        "k1_f40": lambda: cs.crop_offsets(sten, 40.0)[None],
        "k1_f80000": lambda: cs.crop_offsets(sten, 80_000.0)[None],
        "k1_negative": lambda: cs.crop_offsets(sten, 1.0)[None] - 5000,
        "k1_one_cell": lambda: cs.crop_offsets(sten[:1, 1:2], 3.0)[None],
        "k12_d2": _d2_offsets,
        "k12_f0.01": lambda: cs.crop_offsets(sten, 0.01 * grow[:, None, None]),
        "k12_f40": lambda: cs.crop_offsets(sten, 40.0 * grow[:, None, None]),
    }[case]()
    want = _fold_numpy(np_(off).astype(np.int64))
    got = cs.fold_offsets(off)
    for a, b, name in zip(got, want, ("pix", "npix", "order", "seg")):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(np_(a), b, err_msg=name)


def _walk_tracked_rows(skey, n):
    """The tracked kernel's walk: block i takes sorted rows [i T, (i + 1)
    T), T = TRACKED_TILE, and splits them into runs of one key, each
    scored with its own weight fold; returns (key, rows) per run."""
    runs = []
    for row0 in range(0, n, cs.TRACKED_TILE):
        rows = np.arange(row0, min(row0 + cs.TRACKED_TILE, n))
        for part in np.split(rows, np.flatnonzero(np.diff(skey[rows])) + 1):
            runs.append((int(skey[part[0]]), part))
    return runs


@pytest.mark.parametrize("case", ["one", "one_group", "all_shifts",
                                  "1200_groups"])
def test_tracked_schedule_covers_every_row_once(case):
    """tracked_rows' order, walked as the tracked kernel walks it: each
    particle in exactly one run, a run holds one group, and the weights
    are folded at most N / TRACKED_TILE + (groups present) times: 1
    particle, one group only, all Th shifts, 1,200 groups of which most
    are empty."""
    rng = np.random.default_rng(7)
    key = {
        "one": np.array([37]),
        "one_group": np.full(300, 5),
        "all_shifts": np.concatenate([np.arange(TH),
                                      rng.integers(0, TH, 4000)]),
        "1200_groups": rng.choice([0, 5, 64, 65, 299, 1199], 3000),
    }[case]
    skey, perm = (np_(x) for x in cs.tracked_rows(torch.as_tensor(key)))
    assert skey.dtype == np.int32 and perm.dtype == np.int64
    seen = np.zeros(len(key), int)
    runs = _walk_tracked_rows(skey, len(key))
    for g, rows in runs:
        assert (key[perm[rows]] == g).all()
        seen[perm[rows]] += 1
    assert (seen == 1).all()
    assert len(runs) <= -(-len(key) // cs.TRACKED_TILE) + len(set(key)) - 1


def test_fold_pixels_on_the_cpu_is_fold_offsets():
    """fold_pixels, the fold kernel's wrapper, runs fold_offsets on CPU
    tensors and returns its (pix, npix, order, seg) as int32."""
    off = cs.crop_offsets(torch.as_tensor(STENCIL),
                          torch.tensor([0.5, 1.0])[:, None, None])
    kernels.reset_launch_counts()
    got = cs.fold_pixels(off)
    pix, npix, order, seg = cs.fold_offsets(off)
    for a, b in zip(got, (pix, npix, order, seg)):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(np_(a), np_(b))
    assert sum(kernels.LAUNCHES.values()) == 0


@pytest.mark.parametrize("groups,extent", [
    (100, 1024), (1200, 1536), (2, 1 << 20), (1 << 20, 64), (250, 96),
])
def test_order_keys_on_the_cpu_interleave_the_tile_bits(groups, extent):
    """order_rows, the order kernel's wrapper, runs order_rows_plain on
    CPU tensors (no launch counted), and its sorted keys are
    tracked_order_plain's bit by bit interleave (numpy) of the clamped
    tiles under the group: every tile coordinate of both axes, centres at
    the int32 range's ends and off the levels; kshift from 10 to 30."""
    kshift, tbits = cs.order_bits(groups, extent)
    rng = np.random.default_rng(groups)
    tiles = np.arange(1 << (kshift // 2), dtype=np.int64) << tbits
    ctr = np.concatenate([
        np.stack([tiles, tiles[::-1]], 1),
        [[-2**31, 2**31 - 1], [2**31 - 1, -1]],
        rng.integers(-extent, 2 * extent, (500, 2))]).astype(np.int32)
    key = rng.integers(0, groups, len(ctr))
    kernels.reset_launch_counts()
    got, _, shift, _ = cs.order_rows(torch.as_tensor(key),
                                     torch.as_tensor(ctr), groups, extent)
    assert got.dtype == torch.int32 and sum(kernels.LAUNCHES.values()) == 0
    assert shift == kshift
    want, perm, _ = cs.tracked_order_plain(key, ctr, groups, extent)
    np.testing.assert_array_equal(np_(got), want)
    np.testing.assert_array_equal(
        np_(cs.order_keys_plain(torch.as_tensor(key), torch.as_tensor(ctr),
                                kshift, tbits))[perm], want)


@pytest.mark.parametrize("key_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", ORDER_SIZES)
@pytest.mark.parametrize("case", list(ORDER_CASES))
def test_order_rows_plain_is_tracked_order_plain(case, n, key_dtype):
    """order_rows on the CPU (order_rows_plain: the keys, torch.sort,
    searchsorted), the tracked kernels' form (perm int64, no starts),
    equals order_rows_numpy (tracked_order_plain, or a stable argsort of
    the keys alone) bit for bit: N = 0 to 102,400, kshift 0 to 30 (the
    keys alone: tracked_rows, no centres), every key and centre equal,
    buckets left empty, centres off both edges and at the int32 range's
    ends, int32 and int64 group keys; no launch counted.  tracked_order
    and tracked_rows return its parts."""
    key, ctr, groups, extent = order_case(case, n)
    skey, perm, kshift, _ = order_rows_numpy(key, ctr, groups, extent)
    tkey = torch.as_tensor(key).to(key_dtype)
    tctr = None if ctr is None else torch.as_tensor(ctr)
    kernels.reset_launch_counts()
    got = cs.order_rows(tkey, tctr, groups or 0, extent)
    assert sum(kernels.LAUNCHES.values()) == 0
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int64
    assert got[2] == kshift and got[3] is None
    np.testing.assert_array_equal(np_(got[0]), skey)
    np.testing.assert_array_equal(np_(got[1]), perm)
    short = (cs.tracked_rows(tkey) if ctr is None
             else cs.tracked_order(tkey, tctr, groups, extent))
    for a, b in zip(short, got):
        assert a == b if isinstance(a, int) else torch.equal(a, b)


def test_tracked_rows_put_rows_back():
    """tracked_rows' perm is a stable group-major order of the particles,
    and writing row j's result to perm[j] (as the tracked kernel does)
    puts every result back on its own particle."""
    rng = np.random.default_rng(8)
    key = rng.integers(0, 1200, 5000)
    vals = rng.random(5000)
    skey, perm = (np_(x) for x in cs.tracked_rows(torch.as_tensor(key)))
    np.testing.assert_array_equal(np.sort(perm), np.arange(5000))
    np.testing.assert_array_equal(skey, key[perm])
    assert (np.diff(skey) >= 0).all()
    assert (np.diff(perm)[np.diff(skey) == 0] > 0).all()  # stable
    rows = vals[perm]  # row j scores particle perm[j]
    back = np.empty(5000)
    back[perm] = rows
    np.testing.assert_array_equal(back, vals)


# -- the theta-search kernel's product --------------------------------------
def _window_rows(compact, ctr, pix, npix, m, level=None):
    """The kernel's product in float32: each particle's window at its
    centre + pix[:npix] on the compact map (zero outside `level` = (pixel
    offset, H, W), default the whole (H, W, CP) map) times M."""
    cp = compact.shape[-1]
    flat = compact.reshape(-1, cp)
    base, h, w = level if level else (0,) + tuple(compact.shape[:2])
    q = int(npix)
    iy = ctr[:, None, 0] + pix[None, :q, 0]
    ix = ctr[:, None, 1] + pix[None, :q, 1]
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    lin = base + iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    a = torch.where(valid[..., None], flat[lin.long()], 0.0)
    return a.reshape(len(ctr), -1), m[: q * cp]


def _split_product(a, m):
    """The kernel's arithmetic: A_hi B_hi + A_hi B_lo + A_lo B_hi over bf16
    hi/lo splits of both operands, summed in float64."""
    ah, al = (x.double() for x in cs.split_bf16(a))
    bh, bl = (x.double() for x in cs.split_bf16(m))
    return (ah @ bh + ah @ bl + al @ bh).float()


def _rows_of(acc, num_rot, tr):
    inv = np.float32(1.0) / np.float32(tr)
    return (acc[:, 0 : 2 * num_rot : 2], acc[:, 1 : 2 * num_rot : 2],
            acc[:, cs.KF_COL] * float(inv))


@pytest.mark.parametrize("num_rot", [7, 40])
@pytest.mark.parametrize("c", [1, 3, 6])
@pytest.mark.parametrize("f", [1.0, 0.5, 0.37])
def test_init_m_window_product_equals_raw_rows(f, c, num_rot):
    """window @ M (crop_score.init_m, float32) is the plain version's raw
    rows (rel 1e-5, kf bit-equal), windows across the map's edges and
    far outside it included; the padding columns stay 0."""
    rng = np.random.default_rng(int(f * 100) + c)
    packed = np.zeros((64, 80, 8), np.float32)
    packed[..., :c] = rng.random((64, 80, c)) * 50
    packed[..., c] = (rng.random((64, 80)) < 0.9).astype(np.float32)
    scan = (rng.random((c, TH, R)) * 3).astype(np.float32)
    centers = rng.uniform(-20, 100, (96, 2)).astype(np.float32)
    centers[:3] = [[0.0, 0.0], [79.0, 63.0], [-500.0, 30.0]]
    cw = (0.5 + rng.random(c)).astype(np.float32)
    m_, sten, sc, cwt, ctr_px = _t(packed, STENCIL, scan, cw, centers)
    nums, dens, kf = cs.score_init_raw_plain(m_, c, sten, sc, cwt, ctr_px,
                                             f, num_rot)
    pix, npix, order, seg = cs.fold_pixels(cs.crop_offsets(sten, f)[None])
    m = cs.init_m(sc, cwt, order, seg, num_rot)
    off = np_(cs.crop_offsets(sten, f))
    distinct = np.unique(off, axis=0)
    assert int(npix[0]) == len(distinct)
    np.testing.assert_array_equal(np_(pix[0, : len(distinct)]), distinct)
    assert (np_(pix[0, len(distinct):]) == cs.PAD_PIX).all()
    a, mm = _window_rows(cs.compact_map(m_, c),
                         cs.crop_centers(ctr_px, 1.0), pix[0], npix[0], m[0])
    acc = a @ mm
    got = _rows_of(acc, num_rot, TH * R)
    assert_rel(np_(nums), np_(got[0]), 1e-5, "num")
    assert_rel(np_(dens), np_(got[1]), 1e-5, "den")
    np.testing.assert_array_equal(np_(got[2]), np_(kf))
    pad = np.ones(cs.M_COLS, bool)
    pad[: 2 * num_rot] = pad[cs.KF_COL] = False
    assert not np_(m)[..., pad].any()


def test_init_operands_lay_out_m_in_core_matrix_chunks():
    """init_operands' records, decoded as the kernel reads them: chunk c,
    plane element (k, n) at ((k // 8) * 11 + n // 8) * 64 + (n % 8) * 8
    + k % 8, then the chunk's pixel offsets."""
    rng = np.random.default_rng(2)
    c = 6
    scan = torch.as_tensor((rng.random((c, TH, R)) * 3).astype(np.float32))
    off = cs.crop_offsets(torch.as_tensor(STENCIL), torch.tensor(
        [[[0.5]], [[1.0]]]))  # two buckets
    pix, npix, order, seg = cs.fold_pixels(off)
    m = cs.init_m(scan, torch.ones(c), order, seg, 40)
    rec, nchunk = cs.init_operands(pix, npix, m)
    cp = cs.channel_pad(c)
    ppc = cs.K_CHUNK // cp
    np.testing.assert_array_equal(np_(nchunk), -(-np_(npix) * cp // 32))
    plane = cs.K_CHUNK * cs.M_COLS
    assert rec.shape == (2, m.shape[1] // 32, 2 * plane + 4 * ppc)
    hi, lo = (x.view(torch.int16) for x in cs.split_bf16(m))
    k, n = np.meshgrid(np.arange(32), np.arange(cs.M_COLS), indexing="ij")
    at = ((k // 8) * 11 + n // 8) * 64 + (n % 8) * 8 + k % 8
    for b in range(2):
        for ch in (0, 7, int(nchunk[b]) - 1):
            r = rec[b, ch]
            rows = slice(32 * ch, 32 * ch + 32)
            np.testing.assert_array_equal(np_(r[at]), np_(hi[b, rows]))
            np.testing.assert_array_equal(np_(r[plane + at]),
                                          np_(lo[b, rows]))
            np.testing.assert_array_equal(
                np_(r[2 * plane:].view(torch.int32)).reshape(ppc, 2),
                np_(pix[b, ppc * ch : ppc * ch + ppc]))


def test_init_schedule_covers_every_row_once():
    """The kernel's block -> (bucket, rows) walk over init_schedule: each
    sorted row in exactly one tile of its own bucket, within
    N // INIT_TILE + K blocks; empty buckets and a bucket of one particle
    included."""
    t = cs.INIT_TILE
    counts = np.array([0, 1, t - 1, t, t + 1, 0, 3000, 2 * t - 1], np.int64)
    k, n = len(counts), int(counts.sum())
    row_start = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]))
    sched = np_(cs.init_schedule(row_start, torch.arange(k) + 1))
    rs, ts, nch = sched[: k + 1], sched[k + 1 : 2 * k + 2], sched[2 * k + 2:]
    np.testing.assert_array_equal(nch, np.arange(k) + 1)
    seen = np.zeros(n, int)
    for tile in range(n // cs.INIT_TILE + k):
        if tile >= ts[k]:
            continue
        b = 0
        while tile >= ts[b + 1]:
            b += 1
        row0 = rs[b] + (tile - ts[b]) * cs.INIT_TILE
        rows = np.arange(row0, min(row0 + cs.INIT_TILE, rs[b + 1]))
        assert len(rows) and (rows >= rs[b]).all()
        seen[rows] += 1
    assert (seen == 1).all()


def test_split_arithmetic_holds_the_jax_kernel_bounds(float_world):
    """The kernel's bf16 hi/lo arithmetic, emulated on the CPU, selects
    against the JAX theta search (interpret mode, compiled) within that
    kernel's bounds, and within rel 1e-4 of the plain version."""
    packed, scan, centers, _, ref = float_world
    args = _t(packed, STENCIL, scan, CW, centers)
    pix, npix, order, seg = cs.fold_pixels(cs.crop_offsets(args[1], F)[None])
    m = cs.init_m(args[2], args[3], order, seg, 40)
    a, mm = _window_rows(cs.compact_map(args[0], C),
                         cs.crop_centers(args[4], 1.0), pix[0], npix[0],
                         m[0])
    nums, dens, kf = _rows_of(_split_product(a, mm), 40, TH * R)
    best, k = cs.select_best(nums, dens, kf)
    rbest, rtheta, rkf = ref["sel"]
    finite = rbest < cs.FLT_MAX
    np.testing.assert_array_equal(np_(best) < cs.FLT_MAX, finite)
    _check(rbest[finite], np_(best)[finite], rkf[finite], np_(kf)[finite],
           "split sel_init best")
    theta = np_(k).astype(np.float32) * np.float32(2 * math.pi / 40)
    assert np.mean(np.isclose(theta, rtheta)[finite]) > 0.9
    pbest, pk, pkf = cs.score_init_sel_plain(args[0], C, *args[1:], F)
    np.testing.assert_array_equal(np_(kf), np_(pkf))
    fin = np_(pbest) < cs.FLT_MAX
    assert_rel(np_(pbest)[fin], np_(best)[fin], 1e-4, "split vs plain")
    assert np.mean(np_(k) == np_(pk)) >= 0.999


def test_init_operand_checks():
    """What the theta-search wrappers refuse, checked on CPU tensors:
    more shifts than M's 40 column pairs, classes that do not match the
    scan or leave no known channel, a wrong dtype."""
    packed, scan, rng = _world(4, 32, 32)
    rows = torch.as_tensor(rng.random((64, 2)).astype(np.float32)) * 30
    _, sten, sc, cw = _t(packed, STENCIL, scan, CW)
    cpu = torch.device("cpu")
    assert cs.check_operands(C, sten, sc, cw, rows, cpu, 40) == (C, TH, R)
    for args in ((C, sten, sc, cw, rows, cpu, 41),
                 (C, sten, sc, cw, rows, cpu, 0),
                 (4, sten, sc, cw, rows, cpu, 40),
                 (8, sten, torch.ones((8, TH, R)), torch.ones(8), rows, cpu,
                  40),
                 (C, sten, sc.double(), cw, rows, cpu, 40)):
        with pytest.raises((ValueError, TypeError)):
            cs.check_operands(*args)
    assert [cs.channel_pad(c) for c in range(1, 8)] == [2, 4, 4, 8, 8, 8, 8]


def test_crop_map_keeps_the_fold_of_a_host_scale():
    """CropMap.fold returns the kept fold again for the same stencil
    tensor and number f, folds anew for another f or stencil, and on
    every call for a tensor f; each is fold_offsets of the offsets."""
    maps = cs.CropMap(torch.zeros((8, 8, 8)))
    sten = torch.as_tensor(STENCIL)
    first = maps.fold(sten, 0.5)
    assert maps.fold(sten, np.float32(0.5)) is first
    for f in (1.0, torch.tensor(1.0)):
        got = maps.fold(sten, f)
        assert got is not first
        for a, b in zip(got, cs.fold_offsets(cs.crop_offsets(sten, 1.0)[None])):
            np.testing.assert_array_equal(np_(a), np_(b))
    assert maps.fold(sten, torch.tensor(1.0)) is not maps.fold(
        sten, torch.tensor(1.0))
    assert maps.fold(sten.clone(), 1.0) is not maps.fold(sten, 1.0)
    for a, b in zip(first, cs.fold_offsets(cs.crop_offsets(sten, 0.5)[None])):
        np.testing.assert_array_equal(np_(a), np_(b))
