"""The CUDA kernels (uniform and K-bucket crop scoring, with the theta
searches' raw-row epilogue, and the forward fill) against their plain
versions, and the conv path (cuDNN) against a float64
convolution and against the CPU, on the card.

These tests need a CUDA device and skip without one.  The file imports
no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(tests/conftest.py imports JAX, hence --noconftest there).
"""

import dataclasses

import numpy as np
import pytest
import torch

from top_down_renderer_torch import kernels
from top_down_renderer_torch.filter import conv_score as cs_conv
from top_down_renderer_torch.filter import crop_score as cs
from top_down_renderer_torch.filter import filter as ft
from top_down_renderer_torch.filter import multiscale as ms
from top_down_renderer_torch.filter import resample as res_t
from top_down_renderer_torch.maps.polar import polar_stencil
from top_down_renderer_torch.testing import synthetic_setup
from top_down_renderer_torch.utils.convert import filter_state_from_numpy

from torch_parity import assert_rel, np_

TH, R = 100, 25
N = 256
H = W = 160


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _world(dev, c, seed, n=N):
    """Map, scan and n centres: map edges, far out, the residual grid,
    then random float centres; thetas over two turns, negative
    included."""
    rng = np.random.default_rng(seed)
    packed = np.zeros((H, W, 8), np.float32)
    packed[..., :c] = rng.random((H, W, c)) * 50
    packed[..., c] = (rng.random((H, W)) < 0.9).astype(np.float32)
    packed[:40, :40, c] = 0.0  # kf < 0.5 there
    scan = (rng.random((c, TH, R)) * 3).astype(np.float32)
    xs, ys = np.meshgrid(np.arange(16), np.arange(8))
    grid = np.stack([40.0 + xs.ravel(), 40.0 + ys.ravel()], -1)
    edges = [[1, 80], [W - 2, 80], [80, 1], [80, H - 2], [2, 2]]
    far = [[-300.0, 80.0], [80.0, H + 300.0]]
    rnd = rng.uniform(-2, H + 2, (max(n - 135, 0), 2))
    centers = np.concatenate([edges, far, grid, rnd])[:n].astype(np.float32)
    thetas = (rng.random(n) * 4 * np.pi - np.pi).astype(np.float32)
    cw = (0.5 + rng.random(c)).astype(np.float32)
    return [torch.as_tensor(a, device=dev) for a in
            (packed, polar_stencil(TH, R), scan, cw, centers, thetas)]


def _every_shift(thetas):
    """The last TH thetas set to every shift 0..TH-1, a turn below zero."""
    n = min(len(thetas), TH)
    thetas[-n:] = (torch.arange(n, device=thetas.device)
                   * (2 * np.pi / TH) - 2 * np.pi)
    return thetas


def _same_bits(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def _check_tracked(got, ref, n):
    np.testing.assert_array_equal(np_(got[2]), np_(ref[2]))
    ok = np_(ref[2]) >= 0.5
    if n > 7:  # edges and far-out centres come first
        assert 0 < ok.sum() < n
    for a, b, name in ((got[0], ref[0], "cost"), (got[1], ref[1], "norm")):
        assert_rel(np_(b)[ok], np_(a)[ok], 1e-4, name)
    cost = np.where(np_(got[2]) < 0.5, np.nan, np_(got[0]) / np_(got[1]))
    rcost = np.where(np_(ref[2]) < 0.5, np.nan, np_(ref[0]) / np_(ref[1]))
    np.testing.assert_array_equal(np.isnan(cost), np.isnan(rcost))


@pytest.mark.cuda
@pytest.mark.parametrize("th,r,fs", [
    (TH, R, (1.0,)), (TH, R, (0.5,)), (TH, R, (0.37, 0.5, 1.0)),
    (64, 20, (0.05, 2.0)), (100, 50, (1.0,)), (7, 3, (1.0,)),
])
def test_fold_kernel_matches_fold_offsets(dev, th, r, fs):
    """The fold kernel (one block per offset table, a bitonic sort in
    shared memory) returns fold_offsets' distinct pixels and cell CSR
    exactly: one and three tables, 21 to 5,000 cells (sorts of 32 to
    8,192 keys), offsets near zero and out to 99 px."""
    sten = torch.as_tensor(polar_stencil(th, r), device=dev)
    off = cs.crop_offsets(sten, torch.tensor(fs, device=dev)[:, None, None])
    before = kernels.LAUNCHES["crop_fold"]
    got = cs.fold_pixels(off)
    pix, npix, order, seg = cs.fold_offsets(off)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["crop_fold"] == before + 1
    for a, b in zip(got, (pix, npix, order, seg)):
        assert a.dtype == torch.int32
        assert torch.equal(a, b.to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("c,f,n", [
    (3, 0.5, N), (3, 1.0, N), (6, 1.0, N), (7, 0.37, N),
    (1, 1.0, 1), (2, 0.5, 127), (4, 1.0, 129), (5, 0.5, 193),
    (3, 1.0, 102_400), (7, 0.5, 102_400), (1, 0.5, 102_400),
])
def test_tracked_kernel_matches_plain(dev, c, f, n):
    """The tracked kernel against its plain version: 1 to 7 classes, mo
    12 and 24 (f 0.5 and 1.0), tile edges (1, 127, 129, 193 and 102,400
    particles), every shift (thetas negative and over two turns), centres
    at the edges and far out; a second call returns the same bits."""
    packed, sten, scan, cw, centers, thetas = _world(dev, c, 1, n)
    thetas = _every_shift(thetas)
    maps = cs.CropMap(packed)
    before = kernels.LAUNCHES["crop_score_tracked"]
    got = cs.score_tracked(maps, c, sten, scan, cw, centers, thetas, f)
    again = cs.score_tracked(maps, c, sten, scan, cw, centers, thetas, f)
    ref = cs.score_tracked_plain(packed, c, sten, scan, cw, centers,
                                 thetas, f)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["crop_score_tracked"] == before + 2
    assert _same_bits(got, again)
    _check_tracked(got, ref, n)


@pytest.mark.cuda
def test_crop_map_folds_the_stencil_once_per_host_scale(dev):
    """With f as a number the CropMap keeps the stencil's fold: two
    tracked calls and a theta search launch the fold kernel once, and
    score as with f as a card tensor, which is folded on every call."""
    packed, sten, scan, cw, centers, thetas = _world(dev, 3, 4)
    maps = cs.CropMap(packed)
    before = kernels.LAUNCHES["crop_fold"]
    got = [cs.score_tracked(maps, 3, sten, scan, cw, centers, thetas, 0.5)
           for _ in range(2)]
    best = cs.score_init_sel(maps, 3, sten, scan, cw, centers, 0.5)
    assert kernels.LAUNCHES["crop_fold"] == before + 1
    f = torch.tensor(0.5, device=dev)
    ref = cs.score_tracked(maps, 3, sten, scan, cw, centers, thetas, f)
    rbest = cs.score_init_sel(maps, 3, sten, scan, cw, centers, f)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["crop_fold"] == before + 3
    assert _same_bits(got[0], got[1]) and _same_bits(got[0], ref)
    assert torch.equal(best[1], rbest[1]) and torch.equal(best[2], rbest[2])
    assert_rel(np_(rbest[0]), np_(best[0]), 1e-6, "best cost")


@pytest.mark.cuda
@pytest.mark.parametrize("c,f,num_rot,n", [
    (3, 0.5, 40, N), (3, 1.0, 40, N), (6, 1.0, 40, N), (7, 0.37, 17, N),
    (1, 1.0, 40, 1), (1, 0.5, 7, 127), (3, 1.0, 1, 129), (7, 1.0, 7, 129),
    (6, 0.5, 40, 127), (3, 0.5, 40, 193), (3, 1.0, 40, 102_400),
    (7, 0.5, 1, 102_400),
])
def test_init_kernel_matches_plain(dev, c, f, num_rot, n):
    """The tensor-core theta search at the edges of a warpgroup's 64 rows
    and a block's 192 (1, 127, 129, 193 and 102,400 particles), mo 12 and
    24 (f 0.5 and 1.0), 1 to 40 shifts, 1 to 7 classes, centres at the
    edges and far out."""
    packed, sten, scan, cw, centers, _ = _world(dev, c, 2, n)
    before = kernels.LAUNCHES["crop_score_init"]
    best, k, kf = cs.score_init_sel(cs.CropMap(packed), c, sten, scan, cw,
                                    centers, f, num_rot)
    rbest, rk, rkf = cs.score_init_sel_plain(packed, c, sten, scan, cw,
                                             centers, f, num_rot)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["crop_score_init"] == before + 1
    np.testing.assert_array_equal(np_(kf), np_(rkf))
    np.testing.assert_array_equal(np_(best) == cs.FLT_MAX,
                                  np_(rbest) == cs.FLT_MAX)
    assert np.mean(np_(k) == np_(rk)) >= 0.99
    fin = np_(rbest) < cs.FLT_MAX
    assert_rel(np_(rbest)[fin], np_(best)[fin], 1e-4, "best cost")


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_cannot_take(dev):
    packed, sten, scan, cw, centers, thetas = _world(dev, 3, 3)
    big = torch.ones((7, 300, 100), device=dev)  # 1.2 MB of shared memory
    with pytest.raises(ValueError, match="shared memory"):
        cs.score_tracked(cs.CropMap(torch.zeros((H, W, 8), device=dev)), 7,
                         torch.zeros((300, 100, 2), device=dev), big,
                         torch.ones(7, device=dev), centers[:4],
                         torch.zeros(4, device=dev), 0.5)
    with pytest.raises(ValueError, match="num_rot"):
        cs.score_init_sel(cs.CropMap(packed), 3, sten, scan, cw, centers,
                          0.5, 41)
    with pytest.raises(ValueError, match="is on"):
        cs.score_tracked(cs.CropMap(packed), 3, sten.cpu(), scan, cw, centers,
                         thetas, 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["tracked", "init", "mixed"])
def test_crop_step_on_card_matches_cpu(dev, mode):
    """One whole crop update on the card (kernel) against the same update
    on the CPU (plain version), with the same resample shift."""
    d = synthetic_setup(512, h=128, w=128, seed=5)
    d["state"]["particles"]["have_init"][:] = (
        np.arange(512) % 3 == 0 if mode == "mixed" else mode == "tracked"
    )
    step = ft.make_update_step_fast(d["params"], 3, 1.0, 100, 512, mode,
                                    gmm_every=1)
    outs = []
    for device in ("cpu", dev):
        maps, *args = [torch.as_tensor(d[k], device=device)
                       for k in ("packed", "map_size", "stencil", "scan")]
        st = filter_state_from_numpy(d["state"], device)
        outs.append(step(st, cs.CropMap(maps), *args, 0.5, shift=0.25))
    cpu, gpu = outs
    assert int(gpu.n_active) == int(cpu.n_active)
    rows_c = np_(torch.cat(
        [cpu.particles.init_px, cpu.particles.theta[:, None]], 1))
    rows_g = np_(torch.cat(
        [gpu.particles.init_px, gpu.particles.theta[:, None]], 1))
    assert np.mean(np.all(rows_c == rows_g, axis=1)) >= 0.99
    assert_rel(np_(cpu.ml_state), np_(gpu.ml_state), 1e-5, "ml_state")


def _multi_world(dev, c, k, seed, n=N, single=False, mo=ms.MO_MULTI):
    """The uniform world's map as a pyramid, with K buckets: K = 1 one
    scale 0.5 at res 1, K = 2 test_multiscale's (scales 0.5 and 1.0 at res
    1, mips 1 and 2), K = 10 the reference's init hypotheses 10^{k/10} at
    res 0.5 with the mips the dispatch gives them at crop bucket mo.
    Scales sit within 2 % of their slot; `single` leaves bucket 0 one
    particle."""
    packed, sten, scan, cw, centers, thetas = _world(dev, c, seed, n)
    if k <= 2:
        slots, res = np.array([0.5, 1.0][:k], np.float32), 1.0
    else:
        slots = (10.0 ** (np.arange(10) / 10.0)).astype(np.float32)
        res = 0.5
    mips = ms.bucket_mips(slots.copy(), ms.SCALE_RTOL, mo, R, res, 10.0)
    levels = tuple(sorted(set(mips)))
    bmi = tuple(levels.index(m) for m in mips)
    rng = np.random.default_rng(seed)
    pick = rng.integers(1 if single and k > 1 else 0, k, n)
    if single:
        pick[n // 2] = 0
    scale = slots[pick] * (1.0 + 0.02 * (rng.random(n) - 0.5))
    pyr = ms.build_pyramid_maps(packed, levels)
    return (pyr, c, sten, scan, cw, centers), thetas, (
        torch.as_tensor(scale.astype(np.float32), device=dev),
        torch.as_tensor(slots, device=dev), bmi, res)


@pytest.mark.cuda
@pytest.mark.parametrize("c,k,n,single,mo", [
    (3, 2, N, False, 12), (6, 2, N, False, 12), (7, 2, N, False, 12),
    (3, 10, N, False, 12), (6, 10, N, False, 12), (7, 10, N, False, 12),
    (1, 1, 1, False, 12), (2, 1, 127, False, 24), (4, 2, 129, True, 12),
    (5, 10, 193, True, 24), (3, 10, 102_400, False, 12),
    (7, 12, 102_400, True, 24), (1, 10, 102_400, True, 12),
])
def test_multi_tracked_kernel_matches_plain(dev, c, k, n, single, mo):
    """The K-bucket tracked kernel against its plain version: 1 to 7
    classes, K = 1, 2, 10 and 12 (10 hypotheses and two padded copies of
    the last, as the dispatch pads them), mo 12 and 24, a bucket (and so
    a group) of one particle, every shift, windows across a level's edges
    and far out; a second call returns the same bits."""
    kk = min(k, 10)
    args, thetas, tail = _multi_world(dev, c, kk, 4, n, single, mo)
    if k > kk:  # padded slots: copies of the last, never nearest
        scale, slots, bmi, res = tail
        slots = torch.cat([slots, slots[-1:].repeat(k - kk)])
        tail = (scale, slots, bmi + (bmi[-1],) * (k - kk), res)
    thetas = _every_shift(thetas)
    before = kernels.LAUNCHES["crop_score_multi_tracked"]
    got = ms.score_tracked_multi(*args, thetas, *tail)
    again = ms.score_tracked_multi(*args, thetas, *tail)
    ref = ms.score_tracked_multi_plain(*args, thetas, *tail)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["crop_score_multi_tracked"] == before + 2
    assert _same_bits(got, again)
    _check_tracked(got, ref, n)


@pytest.mark.cuda
@pytest.mark.parametrize("c,k,n,num_rot,single", [
    (3, 2, N, 40, False), (6, 2, N, 40, False), (7, 2, N, 40, False),
    (3, 10, N, 40, False), (6, 10, N, 40, False), (7, 10, N, 40, False),
    (1, 2, 1, 40, True), (3, 10, 129, 7, True), (7, 2, 127, 1, True),
    (1, 10, 102_400, 40, True), (3, 10, 102_400, 40, False),
])
def test_multi_init_kernel_matches_plain(dev, c, k, n, num_rot, single):
    """The K-bucket theta search, tiles per bucket: tile edges, 1 to 40
    shifts, a bucket of one particle, windows across a level's edge."""
    args, _, tail = _multi_world(dev, c, k, 5, n, single)
    before = kernels.LAUNCHES["crop_score_multi_init"]
    best, kk, kf = ms.score_init_multi_sel(*args, *tail, num_rot)
    rbest, rk, rkf = ms.score_init_multi_sel_plain(*args, *tail, num_rot)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["crop_score_multi_init"] == before + 1
    np.testing.assert_array_equal(np_(kf), np_(rkf))
    np.testing.assert_array_equal(np_(best) == cs.FLT_MAX,
                                  np_(rbest) == cs.FLT_MAX)
    assert np.mean(np_(kk) == np_(rk)) >= 0.99
    fin = np_(rbest) < cs.FLT_MAX
    assert_rel(np_(rbest)[fin], np_(best)[fin], 1e-4, "best cost")


def _check_raw(got, ref, sel, num_rot, far=()):
    """Raw rows (nums, dens, kf) against their plain version: kf bit-equal,
    nums and dens within rel 1e-4 where kf >= 0.5, the rows of far-out
    centres zero in both, and select_init_cost of the kernel's rows the
    theta-search kernel's argmin `sel` (best, k, kf) on 99 % of them."""
    nums, dens, kf = got
    rnums, rdens, rkf = ref
    assert nums.shape == dens.shape == (len(kf), num_rot)
    np.testing.assert_array_equal(np_(kf), np_(rkf))
    ok = np_(rkf) >= 0.5
    for a, b, name in ((nums, rnums, "num"), (dens, rdens, "den")):
        assert np.isfinite(np_(a)).all()
        assert_rel(np_(b)[ok], np_(a)[ok], 1e-4, name)
        for i in far:
            assert not np_(a)[i].any() and not np_(b)[i].any(), (name, i)
    best, theta = ft._raw_theta(got, num_rot)
    k = torch.round(theta * (num_rot / (2 * np.pi))).long()
    assert np.mean(np_(k) == np_(sel[1])) >= 0.99
    np.testing.assert_array_equal(np_(best) == cs.FLT_MAX,
                                  np_(sel[0]) == cs.FLT_MAX)
    fin = np_(sel[0]) < cs.FLT_MAX
    assert_rel(np_(sel[0])[fin], np_(best)[fin], 1e-4, "best cost")


@pytest.mark.cuda
@pytest.mark.parametrize("c,f,num_rot,n", [
    (3, 0.5, 40, N), (6, 1.0, 40, N), (7, 0.37, 17, N), (1, 1.0, 40, 1),
    (3, 1.0, 7, 129), (6, 0.5, 40, 193), (3, 1.0, 40, 102_400),
])
def test_init_raw_kernel_matches_plain(dev, c, f, num_rot, n):
    """The theta search's raw-row epilogue against score_init_raw_plain:
    tile edges, 1 to 40 shifts, 1 to 7 classes, centres at the map's edges
    and far out (rows of zeros), kf-gated windows."""
    packed, sten, scan, cw, centers, _ = _world(dev, c, 2, n)
    maps = cs.CropMap(packed)
    before = kernels.LAUNCHES["crop_score_init_raw"]
    got = cs.score_init_raw(maps, c, sten, scan, cw, centers, f, num_rot)
    ref = cs.score_init_raw_plain(packed, c, sten, scan, cw, centers, f,
                                  num_rot)
    sel = cs.score_init_sel(maps, c, sten, scan, cw, centers, f, num_rot)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["crop_score_init_raw"] == before + 1
    _check_raw(got, ref, sel, num_rot, far=[i for i in (5, 6) if i < n])


@pytest.mark.cuda
@pytest.mark.parametrize("c,k,n,num_rot,single", [
    (3, 2, N, 40, False), (6, 10, N, 40, False), (7, 2, N, 17, False),
    (1, 2, 1, 40, True), (3, 10, 129, 7, True), (3, 10, 102_400, 40, False),
])
def test_multi_init_raw_kernel_matches_plain(dev, c, k, n, num_rot, single):
    """The K-bucket theta search's raw-row epilogue against
    score_init_multi_raw_plain: each row back at its particle through the
    bucket sort, windows across a level's edge and far out, a bucket of one
    particle."""
    args, _, tail = _multi_world(dev, c, k, 5, n, single)
    before = kernels.LAUNCHES["crop_score_multi_init_raw"]
    got = ms.score_init_multi_raw(*args, *tail, num_rot)
    ref = ms.score_init_multi_raw_plain(*args, *tail, num_rot)
    sel = ms.score_init_multi_sel(*args, *tail, num_rot)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["crop_score_multi_init_raw"] == before + 1
    _check_raw(got, ref, sel, num_rot, far=[i for i in (5, 6) if i < n])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["tracked", "init", "mixed"])
def test_multi_step_on_card_matches_cpu(dev, mode):
    """One whole unknown-scale update on the card (multi kernels) against
    the same update on the CPU (plain versions), same resample shift."""
    d = synthetic_setup(512, h=128, w=128, seed=6)
    p = d["state"]["particles"]
    p["have_init"][:] = (
        np.arange(512) % 3 == 0 if mode == "mixed" else mode == "tracked"
    )
    slots = np.array([1.0, 2.0], np.float32)
    p["scale"][:] = slots[np.arange(512) % 2]
    params = dataclasses.replace(d["params"], fixed_scale=-1.0)
    step = ft.make_update_step_multiscale(params, 3, 1.0, 100, 512, mode,
                                          (0, 1), gmm_every=1)
    outs = []
    for device in ("cpu", dev):
        args = [torch.as_tensor(d[k], device=device)
                for k in ("packed", "map_size", "stencil", "scan")]
        pyr = ms.build_pyramid_maps(args[0], (1, 2))
        st = filter_state_from_numpy(d["state"], device)
        outs.append(step(st, pyr, *args[1:], 0.5,
                         torch.as_tensor(slots, device=device), shift=0.25))
    cpu, gpu = outs
    assert int(gpu.n_active) == int(cpu.n_active)
    rows_c = np_(res_t.pack_fields(cpu.particles))
    rows_g = np_(res_t.pack_fields(gpu.particles))
    assert np.mean(np.all(rows_c == rows_g, axis=1)) >= 0.99
    assert_rel(np_(cpu.ml_state), np_(gpu.ml_state), 1e-5, "ml_state")


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["all", "slot0", "random"])
@pytest.mark.parametrize("n", [1, 700, res_t.FILL_TILE + 1, 102_400, 2**22])
def test_fill_kernel_matches_plain(dev, n, pattern):
    """Bit-equal rows: one slot, within a tile, one over a tile boundary,
    102,400 (100 tiles) and 2^22 (4,096 tiles); every slot valid, only
    slot 0 (its row carries over every tile: the longest look-back) or a
    random 1-50 %.  Two calls give the same bits."""
    rng = np.random.default_rng(n)
    rows0 = torch.as_tensor(rng.random((n, 8)).astype(np.float32),
                            device=dev)
    density = {"all": 1.0, "slot0": 0.0, "random": rng.uniform(0.01, 0.5)}
    valid0 = torch.as_tensor(rng.random(n) < density[pattern], device=dev)
    valid0[0] = True
    before = kernels.LAUNCHES["fill_rows"]
    got = res_t.fill_rows(rows0, valid0)
    again = res_t.fill_rows(rows0, valid0)
    ref = res_t.fill_rows_plain(rows0, valid0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fill_rows"] == before + 2
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))


@pytest.mark.cuda
def test_resample_via_fill_on_card_equals_gather(dev):
    d = synthetic_setup(4096, h=128, w=128, seed=7)
    p = filter_state_from_numpy(d["state"], dev).particles
    w = np.random.default_rng(1).exponential(1.0, 4096).astype(np.float32)
    w[::3] = 0.0
    args = (p, torch.as_tensor(w / w.sum(), device=dev),
            torch.tensor(3000, device=dev), torch.tensor(4096, device=dev))
    a = res_t.systematic_resample(*args, shift=0.41, via="gather")
    b = res_t.systematic_resample(*args, shift=0.41, via="pallas")
    assert torch.equal(res_t.pack_fields(a), res_t.pack_fields(b))
    assert torch.equal(a.alive, b.alive)


@pytest.mark.cuda
def test_resample_indices_repeat_on_card(dev):
    """The resample scans its weights in a fixed order, so on the card the
    same weights give the same source indices on every call."""
    n = 102_400
    w = np.random.default_rng(0).exponential(1.0, n).astype(np.float32)
    w = torch.as_tensor(w / w.sum(), device=dev)
    np.testing.assert_allclose(
        np_(res_t._cumsum_fixed_order(w)),
        np.cumsum(np_(w).astype(np.float64)), rtol=0, atol=1e-5,
    )
    args = (w, torch.tensor(n // 2, device=dev), torch.tensor(n, device=dev),
            torch.tensor(0.37, device=dev))
    ref = res_t._systematic_indices(*args)
    for _ in range(20):
        assert torch.equal(res_t._systematic_indices(*args), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("multi", [False, True])
def test_init_kernel_ties_go_to_the_first_shift(dev, multi):
    """On windows of constant map values (open terrain beyond the distance
    cut-off) the 40 costs are equal in exact arithmetic, and both versions'
    float32 sums differ only by rounding.  The kernel resolves costs
    within 2^-20 of the minimum to the first shift: shift 0 here, with
    the plain version's minimum cost."""
    packed, sten, scan, cw, centers, _ = _world(dev, 3, 6)
    packed[:] = torch.tensor([0.0, 50.0, 50.0, 1.0, 0, 0, 0, 0], device=dev)
    inside = centers[(centers >= 30).all(1) & (centers <= H - 30).all(1)]
    args = (packed, 3, sten, scan, cw, inside)
    if multi:
        pyr = ms.build_pyramid_maps(packed, (1, 2))
        tail = (torch.full((len(inside),), 0.5, device=dev),
                torch.tensor([0.5, 1.0], device=dev), (0, 1), 1.0)
        got = ms.score_init_multi_sel(pyr, *args[1:], *tail)
        nums, dens, _ = ms.score_init_multi_raw_plain(pyr, *args[1:], *tail)
        ref = ms.score_init_multi_sel_plain(pyr, *args[1:], *tail)
    else:
        got = cs.score_init_sel(cs.CropMap(packed), *args[1:], 0.5)
        nums, dens, _ = cs.score_init_raw_plain(*args, 0.5)
        ref = cs.score_init_sel_plain(*args, 0.5)
    torch.cuda.synchronize()
    costs = np_(nums / dens)
    assert (costs.max(1) / costs.min(1) - 1 < 1e-6).all()  # ties
    assert (np_(got[1]) == 0).all()
    assert_rel(np_(ref[0]), np_(got[0]), 1e-4, "best cost")


def _half_turn_tiles(dev, c, seed, tiles=16, half=13):
    """A map of tiles 2 half + 1 px wide, each reading the same at
    (dy, dx) and (-dy, -dx) from its centre, with random values; returns
    the map and the tiles' centres (x, y)."""
    s = 2 * half + 1
    rng = np.random.default_rng(seed)
    a = rng.random((tiles, tiles, s, s, c)).astype(np.float32) * 25
    a = a + a[:, :, ::-1, ::-1]
    packed = np.zeros((tiles * s, tiles * s, 8), np.float32)
    packed[..., :c] = a.transpose(0, 2, 1, 3, 4).reshape(tiles * s,
                                                         tiles * s, c)
    packed[..., c] = 1.0
    mid = np.arange(tiles, dtype=np.float32) * s + half
    centers = np.stack(np.meshgrid(mid, mid), -1).reshape(-1, 2)
    return (torch.as_tensor(packed, device=dev),
            torch.as_tensor(centers, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("multi", [False, True])
def test_init_kernel_near_ties_go_to_the_first_shift(dev, multi):
    """Particles at the centres of half-turn symmetric windows (as on a
    road's centre line): shifts k and k + 20 have equal costs in exact
    arithmetic, with varying map values, and the sums of both versions,
    taken in other orders, differ by a few 1e-7.  The plain version takes
    whichever of the pair its float32 sums make smaller; the kernel takes
    the first (its tie window TIE_REL): the plain version's shift modulo
    the half turn, with a cost within rel 1e-4."""
    c, half = 3, 20
    packed, centers = _half_turn_tiles(dev, c, 8)
    rng = np.random.default_rng(8)
    scan = torch.as_tensor((rng.random((c, TH, R)) * 3).astype(np.float32),
                           device=dev)
    sten = torch.as_tensor(polar_stencil(TH, R), device=dev)
    cw = torch.tensor([0.5, 1.0, 1.5], device=dev)
    args = (c, sten, scan, cw, centers)
    if multi:
        pyr = ms.build_pyramid_maps(packed, (1, 2))
        tail = (torch.full((len(centers),), 0.5, device=dev),
                torch.tensor([0.5, 1.0], device=dev), (0, 1), 1.0)
        got = ms.score_init_multi_sel(pyr, *args, *tail)
        nums, dens, _ = ms.score_init_multi_raw_plain(pyr, *args, *tail)
        ref = ms.score_init_multi_sel_plain(pyr, *args, *tail)
    else:
        got = cs.score_init_sel(cs.CropMap(packed), *args, 0.5)
        nums, dens, _ = cs.score_init_raw_plain(packed, *args, 0.5)
        ref = cs.score_init_sel_plain(packed, *args, 0.5)
    torch.cuda.synchronize()
    costs = np_(nums / dens)
    pair = np.abs(costs[:, half:] / costs[:, :half] - 1)
    assert pair.max() < 1e-5  # near ties, a half turn apart
    assert (np_(ref[1]) >= half).any()  # where the two rules part
    k = np_(got[1])
    assert (k < half).all()
    # where one pair wins by more than the sums' error, it is the plain
    # version's
    pairs = np.sort(costs[:, :half], 1)
    apart = pairs[:, 1] / pairs[:, 0] - 1 > 1e-4
    assert apart.mean() > 0.9
    np.testing.assert_array_equal(k[apart], np_(ref[1])[apart] % half)
    assert_rel(np_(ref[0]), np_(got[0]), 1e-4, "best cost")


@pytest.mark.cuda
@pytest.mark.parametrize("mode,ww", [("tracked", 16), ("tracked", 100),
                                     ("init", 100)])
def test_conv_cost_field_matches_float64(dev, mode, ww):
    """The cost field (cuDNN, float32, TF32 off) against a float64
    convolution of the same bf16-rounded operands on the card: cost and
    norm columns within rel 1e-5 (float32 sums of 10,000 nonnegative
    products), the kf column an exact count; a second call is
    bit-equal."""
    packed, sten, scan, cw, _, _ = _world(dev, 3, 9)
    cmap = cs_conv.ConvMap(cs.compact_map(packed, 3))
    kernel = cs_conv.build_conv_kernel(scan, cw, sten, 1.0, 24, mode,
                                       window_w=ww, s0=95)
    origin = torch.tensor([90, 100], device=dev)
    before = cs_conv.CALLS["cost_field"]
    got = cs_conv.cost_field(cmap.padded, kernel, origin, 24, 64)
    again = cs_conv.cost_field(cmap.padded, kernel, origin, 24, 64)
    assert cs_conv.CALLS["cost_field"] == before + 2
    block = cmap.padded[:, :, 65:178, 75:188]  # origin - 25, 64 + 49 px
    ref = torch.nn.functional.conv2d(block.double(), kernel.double())[0]
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (kernel.shape[0], 64, 64)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert torch.equal(got[-1].double(), ref[-1])
    main = ref[:-1]
    assert float(main.min()) >= 0.0 and float(main.max()) > 0.0
    rel = ((got[:-1].double() - main).abs() / main.abs().clamp(min=1e-9))
    assert float(rel.max()) <= 1e-5, float(rel.max())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["tracked", "init", "mixed"])
def test_conv_step_on_card_matches_cpu(dev, mode):
    """One whole conv update of a clustered cloud on the card against the
    same update on the CPU, with the same resample shift."""
    d = synthetic_setup(512, h=128, w=128, seed=5, cluster=(30, 40, 60))
    d["state"]["particles"]["have_init"][:] = (
        np.arange(512) % 3 == 0 if mode == "mixed" else mode == "tracked"
    )
    step = ft.make_update_step_fast(d["params"], 3, 1.0, 100, 512, mode,
                                    gmm_every=1, path="conv", mo=24,
                                    region=64, window_w=100)
    outs = []
    for device in ("cpu", dev):
        maps, *args = [torch.as_tensor(d[k], device=device)
                       for k in ("packed", "map_size", "stencil", "scan")]
        st = filter_state_from_numpy(d["state"], device)
        outs.append(step(st, cs_conv.ConvMap(cs.compact_map(maps, 3)),
                         *args, 0.5, 2.0, 0, shift=0.25))
    cpu, gpu = outs
    assert int(gpu.n_active) == int(cpu.n_active)
    rows_c = np_(torch.cat(
        [cpu.particles.init_px, cpu.particles.theta[:, None]], 1))
    rows_g = np_(torch.cat(
        [gpu.particles.init_px, gpu.particles.theta[:, None]], 1))
    assert np.mean(np.all(rows_c == rows_g, axis=1)) >= 0.99
    assert_rel(np_(cpu.ml_state), np_(gpu.ml_state), 1e-5, "ml_state")
