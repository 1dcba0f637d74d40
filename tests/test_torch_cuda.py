"""The CUDA kernels (uniform and K-bucket crop scoring, with the theta
searches' raw-row epilogue, the forward fill, and the probes: the window
gather at any byte, the tensor-core products on every route and split,
the crop ablations of the tracked kernel and the theta search), and the
crop kernels on the nibble-packed code map (TDR_MAP_INT4=1) and with the
single-plane M (TDR_M_HILO=0), against their plain versions, the conv path (cuDNN) against a float64
convolution and against the CPU, its int8 field (TDR_CONV_INT8=1: the
quantizer kernel and the field kernel) against their plain versions and
against the CPU, the node (its plans, publish and
snapshot copy, the PNG map), the SVG rasteriser and the refinement's
count sweep against the CPU, on the card.

These tests need a CUDA device and skip without one.  The file imports
no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(tests/conftest.py imports JAX, hence --noconftest there).
"""

import ctypes
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
from top_down_renderer_torch.probes import __main__ as probes
from top_down_renderer_torch.probes import crop_ablate as ca
from top_down_renderer_torch.probes import mm
from top_down_renderer_torch.probes import window as wg
from top_down_renderer_torch.testing import synthetic_setup
from top_down_renderer_torch.utils.convert import filter_state_from_numpy

from torch_parity import (
    ORDER_CASES,
    ORDER_SIZES,
    assert_rel,
    np_,
    order_case,
    order_rows_numpy,
    tracked_pairs,
)

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


def _fold_tables(dev, th, r, fs):
    """(K, th*r, 2) offset tables of the polar stencil: one a scale in
    fs, or a named case: "negative" (f = 1 moved 5,000 px up and left,
    every offset negative), "D2" (the K = 12 tables of chip_smoke D2's
    buckets: the 10 scale hypotheses at res 0.5)."""
    sten = torch.as_tensor(polar_stencil(th, r), device=dev)
    if fs == "negative":
        return cs.crop_offsets(sten, 1.0)[None] - 5000
    if fs == "D2":
        hyp = (10.0 ** (np.arange(10) / 10.0)).astype(np.float32)
        _, slots, mips = ms.plan_buckets(hyp, r, 0.5, 10.0)
        return ms.bucket_offsets(
            sten, torch.as_tensor(slots, device=dev), 0.5,
            torch.as_tensor(mips, dtype=torch.float32, device=dev))
    return cs.crop_offsets(sten, torch.tensor(fs, device=dev)[:, None, None])


@pytest.mark.cuda
@pytest.mark.parametrize("th,r,fs", [
    (TH, R, (1.0,)), (TH, R, (0.5,)), (TH, R, (0.37, 0.5, 1.0)),
    (64, 20, (0.05, 2.0)), (100, 50, (1.0,)), (7, 3, (1.0,)),
    (TH, R, (0.01,)), (TH, R, (40.0, 80_000.0)), (TH, R, "negative"),
    (TH, R, "D2"), (1, 1, (1.0,)), (64, 16, (1.0,)), (128, 32, (0.5,)),
    (128, 128, (1.0,)),
])
def test_fold_kernel_matches_fold_offsets(dev, th, r, fs):
    """The fold kernel (one block per offset table, a stable radix sort
    of each cell's index in the table's bounding box) returns
    fold_offsets' distinct pixels and cell CSR exactly, and a second
    call the same bits: one, three and twelve tables (D2's buckets), 1
    to 16,384 cells (2^10, 2^12 and 2^14 exactly), offsets near zero and
    out to 127 px, every cell on one pixel (no radix pass), boxes of
    1,921 and 4e6 px a side (3 and 6 passes), every offset negative."""
    off = _fold_tables(dev, th, r, fs)
    before = kernels.LAUNCHES["crop_fold"]
    got = cs.fold_pixels(off)
    again = cs.fold_pixels(off)
    pix, npix, order, seg = cs.fold_offsets(off)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["crop_fold"] == before + 2
    for a, a2, b in zip(got, again, (pix, npix, order, seg)):
        assert a.dtype == torch.int32
        assert torch.equal(a, b.to(torch.int32))
        assert torch.equal(a2, a)


@pytest.mark.cuda
@pytest.mark.parametrize("n", ORDER_SIZES + (1 << 20,))
@pytest.mark.parametrize("case", list(ORDER_CASES))
def test_order_kernel_matches_order_keys_plain(dev, case, n):
    """The order kernel (one launch a call, "crop_order") against
    order_rows_plain (order_keys_plain, torch.sort, searchsorted) on the
    same card tensors, bit for bit: sorted keys, perm in both index types
    and, where the groups allow it, row_start; N = 0 to 2^20, kshift 0 to
    30 (the keys alone: tracked_rows, no centres), every key and centre
    equal, buckets left empty, centres off both edges and at the int32
    range's ends, int32 and int64 group keys; up to 4,097 rows also
    against order_rows_numpy (tracked_order_plain).  Twice in a row on
    the same inputs, bit for bit (each call a new epoch of the scratch)."""
    key, ctr, groups, extent = order_case(case, n)
    tctr = None if ctr is None else torch.as_tensor(ctr, device=dev)
    want = order_rows_numpy(key, ctr, groups, extent) if n <= 4_097 else None
    starts = groups is not None and groups <= cs.ORDER_MAX_GROUPS
    for key_dtype, index_dtype in ((torch.int64, torch.int64),
                                   (torch.int32, torch.int32)):
        tkey = torch.as_tensor(key, device=dev).to(key_dtype)
        plain = cs.order_rows_plain(tkey, tctr, groups or 0, extent,
                                    index_dtype=index_dtype, starts=starts)
        before = kernels.LAUNCHES["crop_order"]
        got = cs.order_rows(tkey, tctr, groups or 0, extent,
                            index_dtype=index_dtype, starts=starts)
        again = cs.order_rows(tkey, tctr, groups or 0, extent,
                              index_dtype=index_dtype, starts=starts)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["crop_order"] == before + 2
        assert got[1].dtype == index_dtype and got[2] == plain[2]
        for a, b, c in zip(got, again, plain):
            if isinstance(a, torch.Tensor):
                assert a.dtype == c.dtype and torch.equal(a, c)
                assert torch.equal(b, a)
        assert (got[3] is None) == (not starts)
        if want is not None:
            np.testing.assert_array_equal(np_(got[0]), want[0])
            np.testing.assert_array_equal(np_(got[1]), want[1])
            if starts:
                np.testing.assert_array_equal(np_(got[3]), want[3])


@pytest.mark.cuda
def test_order_rows_refuses_what_the_kernel_cannot_take(dev):
    """order_rows on the card raises, and launches nothing, for float
    keys, keys of another shape, an index type other than int32 and
    int64, row_start of more groups than the kernel counts, and centres
    of the wrong type; a launch its entry refuses (kshift 31) raises
    too."""
    key = torch.zeros(64, dtype=torch.int64, device=dev)
    ctr = torch.zeros((64, 2), dtype=torch.int32, device=dev)
    before = kernels.LAUNCHES["crop_order"]
    for kw, err in (({"key": key.float()}, TypeError),
                    ({"key": key[:, None]}, TypeError),
                    ({"index_dtype": torch.int16}, TypeError),
                    ({"groups": cs.ORDER_MAX_GROUPS + 1, "starts": True},
                     ValueError),
                    ({"ctr": ctr.long()}, TypeError)):
        args = {"key": key, "ctr": ctr, "groups": 12, "extent": 64} | kw
        with pytest.raises(err):
            cs.order_rows(args.pop("key"), args.pop("ctr"), args.pop("groups"),
                          args.pop("extent"), **args)
    assert kernels.LAUNCHES["crop_order"] == before
    skey, perm, _, _ = cs.order_rows(key, ctr, 12, 64)
    scratch = cs._order_status(dev, torch.cuda.current_stream(), 64)[0]
    pairs = torch.empty(128, dtype=torch.int64, device=dev)
    with pytest.raises(RuntimeError, match="tdr_crop_order"):
        kernels.launch("crop_score", "tdr_crop_order", kernels.ptr(key), 8,
                       kernels.ptr(ctr), 64, 31, 0, 0, 0, kernels.ptr(skey),
                       kernels.ptr(perm), 8, None, kernels.ptr(scratch),
                       scratch.numel(), kernels.ptr(pairs), ctypes.c_uint(1))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["tracked_rows", "tracked_order",
                                  "init_order", "init_order_k12"])
def test_order_is_one_launch(dev, form):
    """Each order a crop wrapper takes is one device activity a call under
    torch.profiler, the order kernel's (no sort, fill, copy or search
    kernel beside it), and one "crop_order" launch, at 102,400 rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    key, ctr, _, _ = order_case("shifts", 102_400)
    tkey = torch.as_tensor(key, device=dev)
    tctr = torch.as_tensor(ctr, device=dev)
    b12, zeros = tkey % 12, torch.zeros_like(tkey)
    fn = {"tracked_rows": lambda: cs.tracked_rows(tkey),
          "tracked_order": lambda: cs.tracked_order(tkey, tctr, 100, 1024),
          "init_order": lambda: cs.init_order(zeros, tctr, 1, 1024),
          "init_order_k12": lambda: cs.init_order(b12, tctr, 12, 1024)}[form]
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # an empty device trace is taken again
        before = kernels.LAUNCHES["crop_order"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        assert kernels.LAUNCHES["crop_order"] == before + 5
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        if events:
            break
    names = {e.key: e.count for e in events}
    assert len(names) == 1, names
    ((name, count),) = names.items()
    assert "crop_order_kernel" in name and count == 5, names


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


def _multi_world(dev, c, k, seed, n=N, single=False, mo=ms.MO_MULTI,
                 int4=False, m_hilo=True):
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
    pyr = ms.build_pyramid_maps(packed, levels, int4, m_hilo)
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


def _by_key(monkeypatch):
    """Sort the hi/lo tracked kernels' rows by group alone (tracked_rows'
    order, kshift 0) in place of tracked_order."""
    monkeypatch.setattr(cs, "tracked_order", lambda key, ctr, groups, extent:
                        (*cs.tracked_rows(key), 0))


def _odd_run(centers, thetas, seed):
    """_clustered's cloud (most rows inside and paired) with 37 of its
    clustered rows on shift 7: at most two runs of one block each, so one
    run with an odd count of inside rows."""
    centers, thetas = _clustered(centers, thetas, seed)
    thetas[7:44] = 7 * (2 * np.pi / TH)
    return centers, thetas


def _pairs(maps, args, f):
    """tracked_pairs of a uniform float launch's rows: (inside, paired,
    run)."""
    c, sten, scan, cw, centers, thetas = args
    _, fold, ctr, key = cs._tracked_inputs(maps, c, sten, scan, cw, centers,
                                           thetas, f, 1.0)
    skey, perm, kshift = cs.tracked_order(key, ctr, TH, max(H, W))
    table = torch.tensor([[0, H, W, 0]], dtype=torch.int32, device=ctr.device)
    return tracked_pairs(skey, perm, ctr, kshift, TH, table, fold)


@pytest.mark.cuda
@pytest.mark.parametrize("c,f,n,clustered", [
    (3, 1.0, N, False), (6, 1.0, N, False), (3, 0.5, N, False),
    (6, 0.5, N, False), (3, 1.0, N, True), (6, 1.0, N, True),
    (3, 0.5, 193, True), (6, 0.5, N, True), (3, 1.0, 102_400, True),
    (6, 1.0, 102_400, True), (3, 1.0, 102_400, False),
])
def test_tracked_kernel_pairs_inside_rows(dev, c, f, n, clustered,
                                          monkeypatch):
    """The float tracked kernel with its rows in position order (a row
    inside its level unchecked, two such rows a warp) against its plain
    version as test_tracked_kernel_matches_plain holds it: C = 3 and 6, f
    = 1 and 0.5, every shift, edges and far out; spread clouds, and
    clustered ones where most rows pair and a group of 37 rows leaves a
    run with an odd count of inside rows.  Its rows in tracked_rows'
    order (kshift 0) give the same bits."""
    packed, sten, scan, cw, centers, thetas = _world(dev, c, 17, n)
    thetas = _every_shift(thetas)
    if clustered:
        centers, thetas = _odd_run(centers, thetas, 17)
    maps = cs.CropMap(packed)
    args = (c, sten, scan, cw, centers, thetas)
    before = kernels.LAUNCHES["crop_score_tracked"]
    got = cs.score_tracked(maps, *args, f)
    inside, paired, run = _pairs(maps, args, f)
    _by_key(monkeypatch)
    by_key = cs.score_tracked(maps, *args, f)
    ref = cs.score_tracked_plain(packed, *args, f)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["crop_score_tracked"] == before + 2
    assert _same_bits(got, by_key)
    _check_tracked(got, ref, n)
    assert bool(inside.any()) and not bool(inside.all())
    if clustered:
        odd = torch.bincount(run, inside.long()) % 2 == 1
        assert float(paired.float().mean()) > 0.5 and bool(odd.any())


@pytest.mark.cuda
@pytest.mark.parametrize("c,k,n,clustered", [
    (3, 10, N, False), (6, 2, N, False), (3, 2, N, True),
    (6, 10, 102_400, True), (3, 10, 102_400, False),
])
def test_multi_tracked_kernel_same_bits_in_both_row_orders(
        dev, c, k, n, clustered, monkeypatch):
    """The K-bucket float tracked kernel with its rows in position order
    against its plain version, and with its rows in tracked_rows' order
    (kshift 0): the same bits."""
    args, thetas, tail = _multi_world(dev, c, k, 18, n)
    thetas = _every_shift(thetas)
    if clustered:
        args = (*args[:5], _odd_run(args[5], thetas, 18)[0])
    got = ms.score_tracked_multi(*args, thetas, *tail)
    _by_key(monkeypatch)
    by_key = ms.score_tracked_multi(*args, thetas, *tail)
    ref = ms.score_tracked_multi_plain(*args, thetas, *tail)
    torch.cuda.synchronize()
    assert _same_bits(got, by_key)
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


def _conv_i8_kernel(dev, c, ww, mo, seed):
    """The int8 ConvMap of _world's map of c classes and the tracked conv
    kernel of its scan at the bucket's f, window [95, 95 + W)."""
    packed, sten, scan, cw, _, _ = _world(dev, c, seed)
    cmap = cs_conv.ConvMap(cs.compact_map(packed, c), int8=True)
    kernel = cs_conv.build_conv_kernel(scan, cw, sten, mo / 24.0, mo,
                                       "tracked", window_w=ww, s0=95)
    return packed, cmap, kernel


@pytest.mark.cuda
@pytest.mark.parametrize("c,ww,mo,zeros", [
    (3, 16, 24, False), (3, 32, 12, False), (6, 64, 24, False),
    (6, 32, 48, False), (3, 16, 36, False), (6, 16, 12, False),
    # the largest: two groups, CP 8, 39.6 MB, more chunks than a block's
    # shared memory holds; the smallest W 64 kernel
    (6, 64, 48, False), (3, 64, 12, False),
    # an all-zero column (amax clamped to 1e-30) and whole zero chunks
    (6, 64, 24, True)])
def test_conv_quant_i8_kernel_matches_plain(dev, c, ww, mo, zeros):
    """The quantize-and-layout kernel (one launch, counted) against its
    plain version on the card (quantize_conv_kernel laid out by
    i8_layout) and on the CPU: B, the chunk flags and the scales bit for
    bit, twice."""
    packed, cmap, kernel = _conv_i8_kernel(dev, c, ww, mo, 13)
    if zeros:
        kernel[5] = 0.0  # a cost column of group 0
        kernel[100] = 0.0  # a norm column of group 1
        kernel[:, :, 3:9] = 0.0  # tap rows 3-8: their chunks are zero
    before = kernels.LAUNCHES["conv_quant_i8"]
    b, nonzero, scales = cs_conv.quantize_i8(kernel, cmap.qinv)
    b2, nonzero2, scales2 = cs_conv.quantize_i8(kernel, cmap.qinv)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv_quant_i8"] == before + 2
    ints, ref_scales = cs_conv.quantize_conv_kernel(kernel, cmap.qinv)
    ref_b, ref_nonzero = cs_conv.i8_layout(ints)
    cpu = cs_conv.quantize_i8(kernel.cpu(), cmap.qinv.cpu())
    assert torch.equal(b, ref_b) and torch.equal(b.cpu(), cpu[0])
    assert torch.equal(nonzero, ref_nonzero)
    assert torch.equal(nonzero.cpu(), cpu[1])
    assert torch.equal(scales.view(torch.int32), ref_scales.view(torch.int32))
    assert torch.equal(scales.cpu().view(torch.int32),
                       cpu[2].view(torch.int32))
    assert torch.equal(b2, b) and torch.equal(nonzero2, nonzero)
    assert torch.equal(scales2.view(torch.int32), scales.view(torch.int32))
    assert 0 < int(nonzero.sum()) < nonzero.numel()
    if zeros:
        cpr = nonzero.shape[1] // kernel.shape[2]
        assert not nonzero[:, 3 * cpr : 9 * cpr].any()
        assert not ints[[5, 100]].any()
        assert float(scales[5, 0]) == float(np.float32(1e-30) * np.float32(
            1.0 / 127.0))


def _field_on_ints(codes, ints, scales, origin, mo, region, sums=False,
                   splits=None):
    """The field kernel alone on integers quantized before, laid out by
    the plain layout: (field, sums or None)."""
    return cs_conv.launch_field_i8(codes, *cs_conv.i8_layout(ints), scales,
                                   origin, mo, region, ints.shape[0], sums,
                                   splits)


@pytest.mark.cuda
@pytest.mark.parametrize("c,ww,mo,region,edge", [
    (3, 16, 24, 128, None), (3, 32, 12, 64, "low"), (6, 64, 24, 64, "high"),
    (6, 32, 48, 64, None), (3, 16, 36, 128, "high"),
])
def test_conv_field_i8_kernel_matches_plain(dev, c, ww, mo, region, edge):
    """The int8 conv field's kernel against its plain version on the card:
    the int32 sums and the field bit for bit, and a second launch on the
    same inputs bit for bit; each launch counted; the chunks split over 1
    and 3 blocks a tile (a cluster) as well; on the integers quantized
    before (laid out by i8_layout) and by the quantizer kernel
    (conv_field_i8).  The codes and the quantized kernel on the card equal
    the CPU's."""
    packed, cmap, kernel = _conv_i8_kernel(dev, c, ww, mo, 11)
    ints, scales = cs_conv.quantize_conv_kernel(kernel, cmap.qinv)
    cpu_map = cs_conv.ConvMap(cs.compact_map(packed.cpu(), c), int8=True)
    cpu_ints, cpu_scales = cs_conv.quantize_conv_kernel(kernel.cpu(),
                                                        cpu_map.qinv)
    assert torch.equal(cmap.codes.cpu(), cpu_map.codes)
    assert torch.equal(cmap.qinv.cpu(), cpu_map.qinv)
    assert torch.equal(ints.cpu(), cpu_ints)
    assert torch.equal(scales.cpu(), cpu_scales)
    dr, dc = cs_conv.conv_dims(mo)
    origin = {None: (90, 100), "low": (dr // 2, dc // 2),
              "high": (cmap.hp - (region + dr - 1) + dr // 2,
                       cmap.wp - (region + dc - 1) + dc // 2)}[edge]
    origin = torch.tensor(origin, device=dev)
    args = (cmap.codes, ints, scales, origin, mo, region)
    before = kernels.LAUNCHES["conv_field_i8"]
    got, sums = _field_on_ints(*args, sums=True)
    again, _ = _field_on_ints(*args)
    ref, ref_sums = cs_conv.cost_field_i8_plain(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv_field_i8"] == before + 2
    assert got.shape == (2 * ww + 1, region, region)
    assert torch.equal(sums, ref_sums)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    quantized = (cmap.codes, cmap.qinv, kernel, origin, mo, region)
    for splits in (None, 1, 3):
        for field, split_sums in (
                _field_on_ints(*args, sums=True, splits=splits),
                cs_conv.conv_field_i8(*quantized, sums=True, splits=splits)):
            torch.cuda.synchronize()
            assert torch.equal(split_sums, ref_sums), splits
            assert torch.equal(field.view(torch.int32),
                               ref.view(torch.int32)), splits


@pytest.mark.cuda
def test_conv_field_i8_wrapper_refuses_what_the_kernel_cannot_take(dev):
    packed, sten, scan, cw, _, _ = _world(dev, 3, 12)
    cmap = cs_conv.ConvMap(cs.compact_map(packed, 3), int8=True)
    kernel = cs_conv.build_conv_kernel(scan, cw, sten, 0.5, 12, "tracked",
                                       window_w=16)
    ints, scales = cs_conv.quantize_conv_kernel(kernel, cmap.qinv)
    origin = torch.tensor([60, 60], device=dev)
    with pytest.raises(ValueError):
        _field_on_ints(cmap.codes, ints, scales, origin, 12, 40)
    with pytest.raises(ValueError):
        _field_on_ints(cmap.codes.float(), ints, scales, origin, 12, 64)
    with pytest.raises(ValueError):
        _field_on_ints(cmap.codes, ints, scales, origin, 24, 64)
    with pytest.raises(ValueError):
        _field_on_ints(cmap.codes, ints, scales.double(), origin, 12, 64)
    # rows that are not whole 16-byte groups (TMA's strides)
    odd = cmap.codes[:, 1:].contiguous()
    assert odd.stride(0) % 16
    with pytest.raises(ValueError):
        _field_on_ints(odd, ints, scales, origin, 12, 64)
    # the field on integers quantized before is the CPU's way in only
    with pytest.raises(ValueError):
        cs_conv.cost_field_i8(cmap.codes, ints, scales, origin, 12, 64)
    # W 48: 194 columns, a width the kernel has no instance of
    # (conv_score.I8_COLUMNS)
    wide = cs_conv.build_conv_kernel(scan, cw, sten, 0.5, 12, "tracked",
                                     window_w=48)
    with pytest.raises(ValueError):
        cs_conv.conv_field_i8(cmap.codes, cmap.qinv, wide, origin, 12, 64)
    with pytest.raises(ValueError):
        cs_conv.quantize_i8(kernel.double(), cmap.qinv)


@pytest.mark.cuda
def test_int8_conv_update_launches_each_kernel_once(dev, monkeypatch):
    """A conv-tracked update on the int8 route launches the quantizer
    kernel once and the field kernel once, and calls no eager quantizer or
    layout (both replaced by functions that raise); the int8 field with
    its quantization synchronises nothing (sync debug mode "error")."""
    d = synthetic_setup(512, h=128, w=128, seed=5, cluster=(30, 40, 60))
    d["state"]["particles"]["have_init"][:] = True
    step = ft.make_update_step_fast(d["params"], 3, 1.0, 100, 512,
                                    "tracked", gmm_every=1, path="conv",
                                    mo=24, region=64, window_w=16,
                                    conv_int8=True)
    maps, *args = [torch.as_tensor(d[k], device=dev)
                   for k in ("packed", "map_size", "stencil", "scan")]
    cmap = cs_conv.ConvMap(cs.compact_map(maps, 3), int8=True)
    kernel = cs_conv.build_conv_kernel(args[2], torch.ones(3, device=dev),
                                       args[1], 1.0, 24, "tracked",
                                       window_w=16, s0=90)
    origin = torch.tensor([70, 70], device=dev)
    cs_conv.conv_field_i8(cmap.codes, cmap.qinv, kernel, origin, 24, 64)
    torch.cuda.synchronize()

    def eager(*a, **k):
        raise AssertionError("an eager quantization or layout call")

    monkeypatch.setattr(cs_conv, "quantize_conv_kernel", eager)
    monkeypatch.setattr(cs_conv, "i8_layout", eager)
    before = dict(kernels.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        cs_conv.conv_field_i8(cmap.codes, cmap.qinv, kernel, origin, 24, 64)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    st = filter_state_from_numpy(d["state"], dev)
    step(st, cmap, *args, 0.5, 2.0, 90, shift=0.25)
    torch.cuda.synchronize()
    got = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    assert got == {k: 2 * (k in ("conv_quant_i8", "conv_field_i8"))
                   for k in before}, got


@pytest.mark.cuda
@pytest.mark.parametrize("ww", [16, 32])
def test_int8_conv_step_on_card_matches_cpu(dev, ww):
    """One whole tracked conv update with the int8 field on the card
    against the same update on the CPU (its plain version), with the same
    resample shift: the fields are equal bit for bit, so the weights are
    too up to the step's other float32 sums."""
    d = synthetic_setup(512, h=128, w=128, seed=5, cluster=(30, 40, 60))
    d["state"]["particles"]["have_init"][:] = True
    step = ft.make_update_step_fast(d["params"], 3, 1.0, 100, 512,
                                    "tracked", gmm_every=1, path="conv",
                                    mo=24, region=64, window_w=ww,
                                    conv_int8=True)
    outs = []
    before = kernels.LAUNCHES["conv_field_i8"]
    before_q = kernels.LAUNCHES["conv_quant_i8"]
    for device in ("cpu", dev):
        maps, *args = [torch.as_tensor(d[k], device=device)
                       for k in ("packed", "map_size", "stencil", "scan")]
        st = filter_state_from_numpy(d["state"], device)
        outs.append(step(st, cs_conv.ConvMap(cs.compact_map(maps, 3),
                                             int8=True),
                         *args, 0.5, 2.0, 90, shift=0.25))
    assert kernels.LAUNCHES["conv_field_i8"] == before + 1
    assert kernels.LAUNCHES["conv_quant_i8"] == before_q + 1
    cpu, gpu = outs
    assert int(gpu.n_active) == int(cpu.n_active)
    rows_c = np_(torch.cat(
        [cpu.particles.init_px, cpu.particles.theta[:, None]], 1))
    rows_g = np_(torch.cat(
        [gpu.particles.init_px, gpu.particles.theta[:, None]], 1))
    assert np.mean(np.all(rows_c == rows_g, axis=1)) >= 0.99
    assert_rel(np_(cpu.ml_state), np_(gpu.ml_state), 1e-5, "ml_state")


# -- the node ------------------------------------------------------------
def _city_node_world(scans=6):
    """A 256^2 window of the city world around the drive's first scans,
    its PNG, the bag of those scans, and an initial pose prior."""
    import math
    import os
    import tempfile

    import city_drive_torch as city

    maps, traj, psi = city.city_world()
    maps, traj = city.crop(maps, traj, slice(0, scans), 256)
    png = os.path.join(tempfile.mkdtemp(), "city_window.png")
    city.write_world_png(maps, png)
    init = dict(init_pos_px_x=float(traj[0][0]),
                init_pos_px_y=float(traj[0][1]), init_pos_px_cov=15.0,
                init_pos_deg_theta=math.degrees(psi[0]), init_pos_deg_cov=15.0)
    return city, png, city.make_bag(maps, traj, psi, scans), traj, init


@pytest.mark.cuda
def test_node_scans_on_card_plan_and_publish_as_on_cpu(dev):
    """A few node scans on the card plan the same steps as on the CPU and
    publish the same pose within a few pixels (the draws differ: each
    device has its own generator)."""
    city, png, bag, traj, init = _city_node_world()
    runs = []
    for device in ("cpu", dev):
        node = city.make_node(png, 1024, device, init=init)
        plans = []
        fast_mode = node.filter._fast_mode

        def planned(res, fast_mode=fast_mode, plans=plans):
            plans.append(fast_mode(res))
            return plans[-1]

        node.filter._fast_mode = planned
        rec, errs, _ = city.run(node, bag, traj)
        runs.append(([(p.path, p.mode, p.mip) for p in plans],
                     node.filter.publish_stats(), errs))
    (plans_c, stats_c, errs_c), (plans_g, stats_g, errs_g) = runs
    assert plans_g == plans_c
    assert np.all(np.isfinite(stats_g[1])) and stats_g[2] > 0
    assert np.linalg.norm(stats_g[0][:2] - stats_c[0][:2]) < 3.0
    assert errs_g.size and errs_g.mean() < 2.0 and errs_c.mean() < 2.0


@pytest.mark.cuda
def test_nowait_publish_makes_no_sync(dev):
    """publish_stats(block=False) never synchronises; the next update's
    copy lands in the other pinned buffer, so the last snapshot read stays
    as it was; publish_stats' arrays are the caller's own."""
    city, png, bag, traj, init = _city_node_world(3)
    node = city.make_node(png, 1024, dev, init=init)
    pf = node.filter
    held = pf.publish_stats()
    kept = [np.copy(a) for a in held]
    raw = pf._host_snapshot()
    raw_copy = raw.copy()
    scan = torch.rand((6, 100, 25), device=dev)
    pf.update(scan, 4.0)
    torch.cuda.synchronize()  # the update's copy has landed
    np.testing.assert_array_equal(raw, raw_copy)
    for _ in range(3):
        pf.update(scan, 4.0)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = pf.publish_stats(block=False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert got is not None
    for a, b in zip(held, kept):
        np.testing.assert_array_equal(a, b)
    torch.cuda.synchronize()
    fresh = pf.publish_stats(block=True)
    np.testing.assert_array_equal(pf.publish_stats(block=False)[0], fresh[0])
    assert pf.snapshot_copies == 5


@pytest.mark.cuda
def test_png_map_on_card_equals_cpu(dev):
    """TopDownMap from benchmarks/data/city.png on the card: the class maps
    of the CPU's, and its distances within float32 rounding."""
    import city_drive_torch as city
    from top_down_renderer_torch import MapParams
    from top_down_renderer_torch.maps.map import TopDownMap

    cc = city.class_config()
    params = MapParams(map_path=city.PNG, num_classes=6,
                       flatten_lut=cc.flatten_lut(), class_config=cc)
    cpu, gpu = TopDownMap(params, device="cpu"), TopDownMap(params)
    assert gpu.grid.dist.device.type == "cuda"
    np.testing.assert_array_equal(gpu.class_maps_binary,
                                  cpu.class_maps_binary)
    np.testing.assert_allclose(np_(gpu.grid.dist), np_(cpu.grid.dist),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(np_(gpu.grid.road_ok), np_(cpu.grid.road_ok))


def _rect_run_world():
    """A 96 x 80 world of class rectangles and slanted polygons."""
    rng = np.random.default_rng(4)
    polys = [[], [], []]
    for _ in range(40):
        x, y = rng.integers(-8, 96, 2)
        w, h = rng.integers(1, 30, 2)
        polys[rng.integers(0, 3)].append(np.array(
            [[x, y], [x + w, y], [x + w, y + h], [x, y + h]], np.float32))
    for _ in range(10):
        n = rng.integers(3, 9)
        polys[rng.integers(0, 3)].append(
            rng.uniform(-10, 100, (n, 2)).astype(np.float32))
    return polys


@pytest.mark.cuda
@pytest.mark.parametrize("res", [1.0, 2.0])
def test_rasterize_on_card_equals_cpu(dev, res):
    from top_down_renderer_torch.maps import rasterize

    polys = _rect_run_world()
    args = (polys, (96.0, 80.0), res, (0, 1))
    got = rasterize.rasterize_map(*args, device=dev)
    want = rasterize.rasterize_map(*args, device="cpu")
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)
    again = rasterize.rasterize_map(*args, device=dev)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_accumulate_counts_on_card_equals_cpu(dev):
    from top_down_renderer_torch.tools.refine import accumulate_counts

    rng = np.random.default_rng(5)
    n = 200_000
    pts = np.stack([rng.uniform(-20, 200, n), rng.uniform(-20, 150, n),
                    rng.standard_normal(n)], -1).astype(np.float32)
    pts[:3, 0] = [1e10, -1e10, 3e9]
    cls = rng.integers(-1, 8, n).astype(np.int32)
    args = (1.0, (4.0, -2.0), 6, 128, 160)
    got = accumulate_counts(torch.as_tensor(pts, device=dev),
                            torch.as_tensor(cls, device=dev), *args)
    want = accumulate_counts(torch.as_tensor(pts), torch.as_tensor(cls),
                             *args)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", list(wg.GEOMETRIES))
def test_window_kernel_matches_plain(dev, geometry):
    """The window gather in each geometry, copy and sum, against its plain
    version: 256 crops of 56 x 640 B (8 x 5,120 B slices folded) at rows
    of 8 and columns of 128 B, and at any row and byte (strided, async)."""
    rng = np.random.default_rng(6)
    src = torch.as_tensor(rng.integers(-100, 100, (1, 128, 2048),
                                       dtype=np.int8), device=dev)
    n = 256
    if geometry.startswith("folded"):
        m, rows, cols = wg.fold_rows(src), 8 * int(geometry[-1]), 5120
    else:
        m, rows, cols = src, 56, 640
    starts = [(8, 128)] + ([(1, 1)] if geometry in ("strided", "async")
                           else [])
    for ys, xs in starts:
        o = np.stack([np.zeros(n, np.int64),
                      rng.integers(0, (m.shape[1] - rows) // ys + 1, n) * ys,
                      rng.integers(0, (m.shape[2] - cols) // xs + 1, n) * xs],
                     1)
        o = torch.as_tensor(o, dtype=torch.int32, device=dev)
        for out in ("copy", "sum"):
            got = wg.window_gather(m, o, rows, cols, geometry=geometry,
                                   out=out)
            assert torch.equal(got, wg.window_gather_plain(m, o, rows, cols,
                                                           out))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("geometry", ["strided", "async"])
def test_window_gather_at_any_byte_and_width(dev, dtype, geometry):
    """Windows at any row and byte whose rows are not whole 16-byte words
    (so the async tail box and the strided edge words carry bytes outside
    the window), windows ending at the map's last byte, and a row pitch
    that is not a multiple of 16 bytes (strided only): copies and sums bit
    for bit."""
    rng = np.random.default_rng(7)
    src = torch.as_tensor(rng.integers(-100, 100, (2, 96, 1024)),
                          dtype=torch.float32).to(dev, dtype)
    maps = [src]
    if geometry == "strided":
        maps.append(src[:, :, :1004].contiguous())
    for m in maps:
        w = m.shape[2]
        # (64, 600): five async stages of int8, an odd count
        for rows, cols in ((56, 640), (8, 300), (3, 17), (1, 1), (64, 512),
                           (64, 600)):
            n = 300
            o = np.stack([rng.integers(0, 2, n),
                          rng.integers(0, 96 - rows + 1, n),
                          rng.integers(0, w - cols + 1, n)], 1)
            o[:4, 2] = w - cols  # the map's right edge
            o = torch.as_tensor(o, dtype=torch.int32, device=dev)
            for out in ("copy", "sum"):
                got = wg.window_gather(m, o, rows, cols, geometry=geometry,
                                       out=out)
                assert torch.equal(got, wg.window_gather_plain(m, o, rows,
                                                               cols, out))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 4096, 35_840])
@pytest.mark.parametrize("a_type", ["s8", "bf16", "s8_to_bf16"])
def test_dense_products_match_plain(dev, a_type, k):
    """Each dense route (wgmma fed by TMA, K split where mm.plan says) at M
    in {48, 200, 4,096} and N in {64, 88, 128}: s8 bit for bit, bf16 and
    the converted int8 within MM_TOL of sum |a b|."""
    rng = np.random.default_rng(k)
    for m in (48, 200, 4096):
        for n in (64, 88, 128):
            a8 = torch.as_tensor(rng.integers(-127, 128, (m, k),
                                              dtype=np.int8), device=dev)
            if a_type == "s8":
                b = torch.as_tensor(rng.integers(-127, 128, (n, k),
                                                 dtype=np.int8), device=dev)
                assert torch.equal(mm.mm_s8(a8, b), mm.mm_s8_plain(a8, b))
                continue
            b = torch.as_tensor(rng.random((n, k)) - 0.5,
                                dtype=torch.float32).to(dev, torch.bfloat16)
            a = a8 if a_type == "s8_to_bf16" else (a8.float() / 128).to(
                torch.bfloat16)
            got = mm.mm_bf16(a, b)
            err = (got.double() - mm.mm_bf16_plain(a, b).double()).abs()
            assert float((err / mm.abs_products(a, b)).max()) <= mm.MM_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("a_type", ["s8", "bf16", "s8_to_bf16"])
def test_split_k_repeats_bit_for_bit(dev, a_type):
    """Split K (row 13's shape, all of it split; and the theta shape's
    last wave) sums its splits in a fixed order: two launches return the
    same bits."""
    rng = np.random.default_rng(3)
    for m, n, k in ((48, 64, 35_840), (102_400, 128, 4096)):
        assert mm.plan(m, n, k, a_type, False)[1] > 1
        a8 = torch.as_tensor(rng.integers(-127, 128, (m, k), dtype=np.int8),
                             device=dev)
        if a_type == "s8":
            b = torch.as_tensor(rng.integers(-127, 128, (n, k),
                                             dtype=np.int8), device=dev)
            run = lambda: mm.mm_s8(a8, b)  # noqa: E731
        else:
            b = torch.as_tensor(rng.random((n, k)) - 0.5,
                                dtype=torch.float32).to(dev, torch.bfloat16)
            a = a8 if a_type == "s8_to_bf16" else a8.to(torch.bfloat16)
            run = lambda: mm.mm_bf16(a, b)  # noqa: E731
        first = run()
        assert torch.equal(first.view(torch.int32), run().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("order", ca.INIT_ORDERS)
@pytest.mark.parametrize("variant", ca.INIT_VARIANTS)
@pytest.mark.parametrize("multi,c,n", [
    (False, 3, N), (False, 6, 193), (True, 3, N), (True, 6, 129),
])
def test_init_ablation_matches_plain(dev, variant, order, multi, c, n):
    """Each variant of the theta search's ablation (K4), its rows in each
    order, against its plain version, argmin and raw rows (probes'
    _close_rows: rel 1e-4, k a near-argmin), on the uniform world (map
    edges, far-out centres, kf-gated windows, tile edges) and over K = 10
    buckets; `full` and `checked` also against the production kernel bit
    for bit."""
    if multi:
        args, _, tail = _multi_world(dev, c, 10, 5, n)
        args += tail
        fn, plain = ca.crop_ablate_multi_init, ca.crop_ablate_multi_init_plain
        prod = (ms.score_init_multi_sel, ms.score_init_multi_raw)
    else:
        packed, sten, scan, cw, centers, _ = _world(dev, c, 2, n)
        args = (cs.CropMap(packed), c, sten, scan, cw, centers, 1.0)
        fn, plain = ca.crop_ablate_init, ca.crop_ablate_init_plain
        prod = (cs.score_init_sel, cs.score_init_raw)
    before = kernels.LAUNCHES["crop_ablate_init"]
    got = fn(variant, *args, order=order)
    raw = fn(variant, *args, raw=True, order=order)
    want, want_raw = plain(variant, *args), plain(variant, *args, raw=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["crop_ablate_init"] == before + 2
    probes._close_rows(variant, got, raw, want, want_raw)
    if variant in ("full", "checked"):
        for g, w in zip((*got, *raw), (*prod[0](*args), *prod[1](*args))):
            assert probes._same_bits(g, w)


@pytest.mark.cuda
def test_init_ablation_runs_one_block_an_sm(dev):
    """Every variant of the theta search's ablation, at both class counts,
    argmin and raw, holds one block an SM at the shared memory its launches
    ask for, as full does by its registers."""
    for variant in ca.INIT_VARIANTS:
        for c in ca.CLASSES:
            for raw in (False, True):
                assert ca.blocks_per_sm(variant, c, raw) == 1, (variant, c,
                                                                raw)


@pytest.mark.cuda
def test_probe_path_on_the_card(dev):
    """Every probe at small sizes, each kernel held to its plain version
    by probes.__main__'s checks (a failed check raises)."""
    recs = (probes.window_parity(dev, 0)
            + probes.window_rates(dev, 0, 256, 256, "small")
            + probes.run_mm(dev, 0, 256)
            + probes.run_ablate(dev, 0, 4096)
            + probes.run_ablate_init(dev, 0, 4096))
    assert all(r["kernel_ms"] > 0 and r["profile_tries"] >= 1
               for r in recs)


# -- the crop kernels on the nibble-packed code map (TDR_MAP_INT4=1) -------
def _launched(name, before):
    """The launches of `name` and of its float twin since `before`."""
    float_name = name.removesuffix("_i4")
    return (kernels.LAUNCHES[name] - before[name],
            kernels.LAUNCHES[float_name] - before[float_name])


def _clustered(centers, thetas, seed):
    """The centres past the edges and far-out ones (the first 7) in a 24 px
    square at (100, 100), on three shifts: blocks whose window of codes
    fits shared memory."""
    rng = np.random.default_rng(seed)
    n = len(centers) - 7
    if n > 0:
        centers[7:] = torch.as_tensor(
            rng.uniform(88, 112, (n, 2)).astype(np.float32),
            device=centers.device)
        thetas[7:] = torch.as_tensor(
            (rng.integers(0, 3, n) * (2 * np.pi / TH)).astype(np.float32),
            device=thetas.device)
    return centers, thetas


def _staged(windows) -> float:
    """The share of a code tracked launch's windows the plain rule stages
    (crop_score.launch_windows)."""
    return cs.staged_share(windows)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("c,f,n,clustered", [
    (3, 0.5, N, False), (6, 1.0, N, False), (1, 1.0, 1, False),
    (2, 0.5, 127, False), (7, 0.37, 193, False), (3, 1.0, 102_400, False),
    (6, 1.0, 102_400, False), (3, 1.0, N, True), (1, 0.5, 193, True),
    (3, 1.0, 102_400, True), (6, 1.0, 102_400, True),
])
def test_i4_tracked_kernel_matches_plain(dev, c, f, n, clustered,
                                         monkeypatch):
    """The tracked kernel on the code map against its plain version (the
    float plain version on the dequantized map): 1 to 7 classes (1, 2 and
    4 code bytes a pixel), tile edges, every shift, edges and far out, and
    clustered clouds whose blocks stage their windows of codes; a second
    call the same bits, and a call at budget 0 (every block's gather from
    L2) the same bits too; no float tracked launch."""
    packed, sten, scan, cw, centers, thetas = _world(dev, c, 11, n)
    thetas = _every_shift(thetas)
    if clustered:
        centers, thetas = _clustered(centers, thetas, 11)
    maps = cs.CropMap(packed, int4=True)
    assert maps.codes(c).shape == (H, W, cs.channel_pad(c) // 2)
    before = dict(kernels.LAUNCHES)
    got = cs.score_tracked(maps, c, sten, scan, cw, centers, thetas, f)
    again = cs.score_tracked(maps, c, sten, scan, cw, centers, thetas, f)
    monkeypatch.setattr(cs, "WINDOW_BUDGET", 0)
    on_l2 = cs.score_tracked(maps, c, sten, scan, cw, centers, thetas, f)
    ref = cs.score_tracked_plain(maps.plain(c).packed, c, sten, scan, cw,
                                 centers, thetas, f)
    torch.cuda.synchronize()
    assert _launched("crop_score_tracked_i4", before) == (3, 0)
    assert _same_bits(got, again)
    assert _same_bits(got, on_l2)
    _check_tracked(got, ref, n)
    _, fold, ctr, key = cs._tracked_inputs(maps, c, sten, scan, cw, centers,
                                           thetas, f, 1.0)
    staged = _staged(cs.launch_windows(maps, None, H, W, c, scan, fold, ctr,
                                       key, cs.SMEM_LIMIT))
    assert staged > 0.5 if clustered else staged >= 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("c,f,num_rot,n", [
    (3, 0.5, 40, N), (6, 1.0, 40, N), (1, 1.0, 40, 1), (7, 0.37, 17, 129),
    (2, 0.5, 7, 193), (3, 1.0, 40, 102_400), (6, 1.0, 40, 102_400),
])
def test_i4_init_kernels_match_plain(dev, c, f, num_rot, n):
    """The theta search on the code map, argmin and raw rows, against
    their plain versions on the dequantized map: kf bit for bit, costs
    and raw rows within rel 1e-4, the argmin on 99 %; no float launch."""
    packed, sten, scan, cw, centers, _ = _world(dev, c, 12, n)
    maps = cs.CropMap(packed, int4=True)
    plain = maps.plain(c).packed
    before = dict(kernels.LAUNCHES)
    best, k, kf = cs.score_init_sel(maps, c, sten, scan, cw, centers, f,
                                    num_rot)
    raw = cs.score_init_raw(maps, c, sten, scan, cw, centers, f, num_rot)
    rbest, rk, rkf = cs.score_init_sel_plain(plain, c, sten, scan, cw,
                                             centers, f, num_rot)
    rraw = cs.score_init_raw_plain(plain, c, sten, scan, cw, centers, f,
                                   num_rot)
    torch.cuda.synchronize()
    assert _launched("crop_score_init_i4", before) == (1, 0)
    assert _launched("crop_score_init_raw_i4", before) == (1, 0)
    np.testing.assert_array_equal(np_(kf), np_(rkf))
    np.testing.assert_array_equal(np_(best) == cs.FLT_MAX,
                                  np_(rbest) == cs.FLT_MAX)
    assert np.mean(np_(k) == np_(rk)) >= 0.99
    fin = np_(rbest) < cs.FLT_MAX
    assert_rel(np_(rbest)[fin], np_(best)[fin], 1e-4, "best cost")
    _check_raw(raw, rraw, (best, k, kf), num_rot,
               far=[i for i in (5, 6) if i < n])


@pytest.mark.cuda
@pytest.mark.parametrize("c,k,n,single,mo,clustered", [
    (3, 2, N, False, 12, False), (6, 10, N, False, 12, False),
    (1, 1, 1, False, 12, False), (5, 10, 193, True, 24, False),
    (3, 10, 102_400, False, 12, False), (3, 2, N, False, 12, True),
    (3, 10, 102_400, False, 12, True), (6, 10, 102_400, True, 24, True),
])
def test_i4_multi_tracked_kernel_matches_plain(dev, c, k, n, single, mo,
                                               clustered, monkeypatch):
    """The K-bucket tracked kernel on the code pyramid against its plain
    version on the dequantized pyramid, spread and clustered (blocks
    that stage their windows, on every level); a second call the same
    bits, and a call at budget 0 (every gather from L2) too."""
    args, thetas, tail = _multi_world(dev, c, k, 13, n, single, mo,
                                      int4=True)
    thetas = _every_shift(thetas)
    if clustered:
        args = (*args[:5], _clustered(args[5], thetas, 13)[0])
    pyr = args[0]
    before = dict(kernels.LAUNCHES)
    got = ms.score_tracked_multi(*args, thetas, *tail)
    again = ms.score_tracked_multi(*args, thetas, *tail)
    monkeypatch.setattr(cs, "WINDOW_BUDGET", 0)
    on_l2 = ms.score_tracked_multi(*args, thetas, *tail)
    ref = ms.score_tracked_multi_plain(pyr.plain(c), *args[1:], thetas,
                                       *tail)
    torch.cuda.synchronize()
    assert _launched("crop_score_multi_tracked_i4", before) == (3, 0)
    assert _same_bits(got, again)
    assert _same_bits(got, on_l2)
    _check_tracked(got, ref, n)
    _, table, fold, ctr, key = ms._tracked_inputs(pyr, *args[1:], thetas,
                                                  *tail, 1.0)
    staged = _staged(cs.launch_windows(pyr, table, 0, 0, c, args[3], fold,
                                       ctr, key, cs.SMEM_LIMIT))
    assert staged > 0.5 if clustered else staged >= 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("c,k,n,num_rot,single", [
    (3, 2, N, 40, False), (6, 10, N, 40, False), (1, 2, 1, 40, True),
    (3, 10, 129, 7, True), (3, 10, 102_400, 40, False),
])
def test_i4_multi_init_kernels_match_plain(dev, c, k, n, num_rot, single):
    """The K-bucket theta search on the code pyramid, argmin and raw rows,
    against their plain versions on the dequantized pyramid."""
    args, _, tail = _multi_world(dev, c, k, 14, n, single, int4=True)
    plain = (args[0].plain(c),) + args[1:]
    before = dict(kernels.LAUNCHES)
    best, kk, kf = ms.score_init_multi_sel(*args, *tail, num_rot)
    raw = ms.score_init_multi_raw(*args, *tail, num_rot)
    rbest, rk, rkf = ms.score_init_multi_sel_plain(*plain, *tail, num_rot)
    rraw = ms.score_init_multi_raw_plain(*plain, *tail, num_rot)
    torch.cuda.synchronize()
    assert _launched("crop_score_multi_init_i4", before) == (1, 0)
    assert _launched("crop_score_multi_init_raw_i4", before) == (1, 0)
    np.testing.assert_array_equal(np_(kf), np_(rkf))
    np.testing.assert_array_equal(np_(best) == cs.FLT_MAX,
                                  np_(rbest) == cs.FLT_MAX)
    assert np.mean(np_(kk) == np_(rk)) >= 0.99
    fin = np_(rbest) < cs.FLT_MAX
    assert_rel(np_(rbest)[fin], np_(best)[fin], 1e-4, "best cost")
    _check_raw(raw, rraw, (best, kk, kf), num_rot,
               far=[i for i in (5, 6) if i < n])


@pytest.mark.cuda
def test_i4_entries_refuse_the_other_map(dev):
    """A code entry point refuses the float compact map and a float one
    the codes, before any launch: maps whose operand is the other
    format's."""
    packed, sten, scan, cw, centers, thetas = _world(dev, 3, 3)
    code_map, float_map = (cs.CropMap(packed, int4=i4)
                           for i4 in (True, False))
    code_map._codes[3] = float_map.compact(3)
    float_map._compact[3] = cs.CropMap(packed, int4=True).codes(3)
    fold, ctr = code_map.fold(sten, 0.5), cs.crop_centers(centers, 1.0)
    key = torch.zeros(len(ctr), dtype=torch.int32, device=dev)
    before = dict(kernels.LAUNCHES)
    for maps in (code_map, float_map):
        with pytest.raises(TypeError):
            cs.launch_tracked("crop_score_tracked", maps, None, H, W, 3,
                              scan, cw, fold, ctr, key)
    assert dict(kernels.LAUNCHES) == before


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["tracked", "init", "mixed"])
def test_i4_crop_step_on_card_matches_cpu(dev, mode):
    """One whole crop update on the code map on the card (code kernels)
    against the same update on the CPU (plain versions on the dequantized
    map), with the same resample shift."""
    d = synthetic_setup(512, h=128, w=128, seed=5)
    d["state"]["particles"]["have_init"][:] = (
        np.arange(512) % 3 == 0 if mode == "mixed" else mode == "tracked"
    )
    step = ft.make_update_step_fast(d["params"], 3, 1.0, 100, 512, mode,
                                    gmm_every=1)
    outs = []
    before = dict(kernels.LAUNCHES)
    for device in ("cpu", dev):
        maps, *args = [torch.as_tensor(d[k], device=device)
                       for k in ("packed", "map_size", "stencil", "scan")]
        st = filter_state_from_numpy(d["state"], device)
        outs.append(step(st, cs.CropMap(maps, int4=True), *args, 0.5,
                         shift=0.25))
    for name in ("crop_score_tracked", "crop_score_init"):
        ran = mode in ("mixed", name.removeprefix("crop_score_"))
        assert _launched(name + "_i4", before) == (int(ran), 0)
    cpu, gpu = outs
    assert int(gpu.n_active) == int(cpu.n_active)
    rows_c = np_(torch.cat(
        [cpu.particles.init_px, cpu.particles.theta[:, None]], 1))
    rows_g = np_(torch.cat(
        [gpu.particles.init_px, gpu.particles.theta[:, None]], 1))
    assert np.mean(np.all(rows_c == rows_g, axis=1)) >= 0.99
    assert_rel(np_(cpu.ml_state), np_(gpu.ml_state), 1e-5, "ml_state")


# -- the crop kernels with the single-plane M (TDR_M_HILO=0) --------------
def _lokf_launched(name, before):
    """The launches of the single-plane entry `name` and of its hi/lo
    twin since `before`."""
    twin = name.removesuffix("_lokf")
    return (kernels.LAUNCHES[name] - before[name],
            kernels.LAUNCHES[twin] - before[twin])


def _lokf_ok(rkf):
    """The rows whose kf lies clear of the gate: the single-plane kf is
    the count to ~1e-7, which the kernel and the plain version sum in
    other orders, so a row at kf = 0.5 exactly may fall either side."""
    return np.abs(np_(rkf) - 0.5) > 1e-6


def _check_tracked_lokf(got, ref, n):
    """_check_tracked with the single plane's kf: within 1e-6, not bit for
    bit, and the gate's pattern compared off the gate."""
    assert np.abs(np_(got[2]) - np_(ref[2])).max(initial=0.0) <= 1e-6
    clear = _lokf_ok(ref[2])
    ok = (np_(ref[2]) >= 0.5) & clear
    if n > 7:
        assert 0 < ok.sum() < n
    for a, b, name in ((got[0], ref[0], "cost"), (got[1], ref[1], "norm")):
        assert_rel(np_(b)[ok], np_(a)[ok], 1e-4, name)
    np.testing.assert_array_equal((np_(got[2]) < 0.5)[clear],
                                  (np_(ref[2]) < 0.5)[clear])


def _near_ties(k, rk, rraw, rel=1e-4):
    """Every row whose argmin k differs from the plain version's rk is a
    near tie of the plain rows (nums, dens): the plain cost at k within
    rel of the plain cost at rk."""
    bad = np.flatnonzero(np_(k) != np_(rk))
    cost = np_(rraw[0]).astype(np.float64) / np_(rraw[1]).astype(np.float64)
    at_k, at_rk = cost[bad, np_(k)[bad]], cost[bad, np_(rk)[bad]]
    assert np.all(np.abs(at_k - at_rk) <= rel * np.abs(at_rk)), (
        bad, at_k, at_rk)


def _check_init_lokf(got, ref, raw, rraw, num_rot, near_ties=False):
    """The single-plane theta search's argmin and raw rows against their
    plain versions: kf within 1e-6, the FLT_MAX pattern off the gate, best
    costs and raw rows within rel 1e-4, the argmin on 99 % (near_ties:
    every row whose argmin differs a near tie of the plain rows)."""
    (best, k, kf), (rbest, rk, rkf) = got, ref
    clear = _lokf_ok(rkf)
    assert np.abs(np_(kf) - np_(rkf)).max(initial=0.0) <= 1e-6
    assert np.abs(np_(raw[2]) - np_(rraw[2])).max(initial=0.0) <= 1e-6
    np.testing.assert_array_equal((np_(best) == cs.FLT_MAX)[clear],
                                  (np_(rbest) == cs.FLT_MAX)[clear])
    if near_ties:
        _near_ties(k, rk, rraw)
    else:
        assert np.mean(np_(k) == np_(rk)) >= 0.99
    fin = (np_(rbest) < cs.FLT_MAX) & (np_(best) < cs.FLT_MAX)
    assert_rel(np_(rbest)[fin], np_(best)[fin], 1e-4, "best cost")
    ok = (np_(rraw[2]) >= 0.5) & clear
    for a, b, name in ((raw[0], rraw[0], "num"), (raw[1], rraw[1], "den")):
        assert a.shape == (len(kf), num_rot)
        assert_rel(np_(b)[ok], np_(a)[ok], 1e-4, name)


@pytest.mark.cuda
@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("c,f,n", [
    (3, 0.5, N), (6, 1.0, N), (1, 1.0, 1), (2, 0.5, 127), (7, 0.37, 193),
    (3, 1.0, 102_400),
])
def test_lokf_tracked_kernel_matches_plain(dev, c, f, n, int4):
    """The tracked kernel with the single-plane M, on the float and the
    code map, against its plain version (the dequantized single-plane
    weights): 1 to 7 classes, tile edges, every shift, edges and far out;
    the weights pass first (one launch), a second call the same bits, no
    hi/lo launch."""
    packed, sten, scan, cw, centers, thetas = _world(dev, c, 21, n)
    thetas = _every_shift(thetas)
    maps = cs.CropMap(packed, int4=int4, m_hilo=False)
    name = "crop_score_tracked" + "_i4" * int4 + "_lokf"
    before = dict(kernels.LAUNCHES)
    got = cs.score_tracked(maps, c, sten, scan, cw, centers, thetas, f)
    again = cs.score_tracked(maps, c, sten, scan, cw, centers, thetas, f)
    ref = cs.score_tracked_plain(maps.plain(c).packed, c, sten, scan, cw,
                                 centers, thetas, f, **maps.plain_m())
    torch.cuda.synchronize()
    assert _lokf_launched(name, before) == (2, 0)
    assert kernels.LAUNCHES["crop_lokf_weights"] == before[
        "crop_lokf_weights"] + 2
    assert _same_bits(got, again)
    _check_tracked_lokf(got, ref, n)


@pytest.mark.cuda
@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("c,k", [(3, 1), (6, 10), (1, 2), (7, 12)])
def test_lokf_scales_kernel_equals_tracked_lokf(dev, c, k, int4):
    """The weights pass against crop_score.tracked_lokf on the same fold,
    bit for bit: its scales, and its integer table (K, Th, C + 3, P) int16
    on each bucket's npix[b] pixels rounded up to 8 (zeros past npix[b]);
    K = 1 to 12 tables, 1 to 7 classes; tracked_scales the same scales."""
    _, sten, scan, cw, _, _ = _world(dev, c, 22, 8)
    off = _fold_tables(dev, TH, R, "D2" if k > 2 else [0.5, 1.0][:k])[:k]
    fold = cs.fold_pixels(off.contiguous())
    qinv = torch.as_tensor(np.random.default_rng(c).random(8).astype(
        np.float32) + 0.01, device=dev)
    before = kernels.LAUNCHES["crop_lokf_weights"]
    table, got = cs.tracked_table(scan, cw, qinv, fold, c, int4)
    scales = cs.tracked_scales(scan, cw, qinv, fold, c, int4)
    w, want = cs.tracked_lokf(cs.tracked_weights(scan, cw, fold[2], fold[3],
                                                 qinv), int4, c)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["crop_lokf_weights"] == before + 2
    assert got.shape == (off.shape[0], TH, 4)
    assert torch.equal(got, want) and torch.equal(scales, want)
    assert table.shape == (off.shape[0], TH, c + 3, fold[0].shape[1])
    assert table.dtype == torch.int16
    want_q = w.transpose(-1, -2).to(torch.int16)
    for b, u in enumerate(fold[1].tolist()):
        u8 = -(-u // 8) * 8
        assert torch.equal(table[b, ..., :u8], want_q[b, ..., :u8])


@pytest.mark.cuda
@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("c,f,num_rot,n", [
    (3, 0.5, 40, N), (6, 1.0, 40, N), (1, 1.0, 40, 1), (7, 0.37, 17, 129),
    (2, 0.5, 7, 193), (3, 1.0, 40, 102_400),
])
def test_lokf_init_kernels_match_plain(dev, c, f, num_rot, n, int4):
    """The theta search with the single-plane M, argmin and raw rows, on
    the float and the code map, against their plain versions; no hi/lo
    launch."""
    packed, sten, scan, cw, centers, _ = _world(dev, c, 23, n)
    maps = cs.CropMap(packed, int4=int4, m_hilo=False)
    plain, pm = maps.plain(c).packed, maps.plain_m()
    args = (c, sten, scan, cw, centers, f, num_rot)
    before = dict(kernels.LAUNCHES)
    got = cs.score_init_sel(maps, *args)
    raw = cs.score_init_raw(maps, *args)
    ref = cs.score_init_sel_plain(plain, *args, **pm)
    rraw = cs.score_init_raw_plain(plain, *args, **pm)
    torch.cuda.synchronize()
    for base in ("crop_score_init", "crop_score_init_raw"):
        assert _lokf_launched(base + "_i4" * int4 + "_lokf", before) == (1, 0)
    _check_init_lokf(got, ref, raw, rraw, num_rot)


@pytest.mark.cuda
@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("c,k,n,single,mo", [
    (3, 2, N, False, 12), (6, 10, N, False, 12), (1, 1, 1, False, 12),
    (5, 10, 193, True, 24), (3, 10, 102_400, False, 12),
])
def test_lokf_multi_tracked_kernel_matches_plain(dev, c, k, n, single, mo,
                                                 int4):
    """The K-bucket tracked kernel with the single-plane M (one scale a
    (bucket, shift)) against its plain version; a second call the same
    bits."""
    args, thetas, tail = _multi_world(dev, c, k, 24, n, single, mo,
                                      int4=int4, m_hilo=False)
    thetas = _every_shift(thetas)
    pyr = args[0]
    name = "crop_score_multi_tracked" + "_i4" * int4 + "_lokf"
    before = dict(kernels.LAUNCHES)
    got = ms.score_tracked_multi(*args, thetas, *tail)
    again = ms.score_tracked_multi(*args, thetas, *tail)
    ref = ms.score_tracked_multi_plain(pyr.plain(c), *args[1:], thetas,
                                       *tail, **pyr.plain_m())
    torch.cuda.synchronize()
    assert _lokf_launched(name, before) == (2, 0)
    assert _same_bits(got, again)
    _check_tracked_lokf(got, ref, n)


@pytest.mark.cuda
@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("c,k,n,num_rot,single", [
    (3, 2, N, 40, False), (6, 10, N, 40, False), (1, 2, 1, 40, True),
    (3, 10, 129, 7, True), (3, 10, 102_400, 40, False),
])
def test_lokf_multi_init_kernels_match_plain(dev, c, k, n, num_rot, single,
                                             int4):
    """The K-bucket theta search with the single-plane M (one M and one
    row of scales a bucket), argmin and raw rows, against their plain
    versions."""
    args, _, tail = _multi_world(dev, c, k, 25, n, single, int4=int4,
                                 m_hilo=False)
    pyr = args[0]
    plain = (pyr.plain(c),) + args[1:]
    before = dict(kernels.LAUNCHES)
    got = ms.score_init_multi_sel(*args, *tail, num_rot)
    raw = ms.score_init_multi_raw(*args, *tail, num_rot)
    ref = ms.score_init_multi_sel_plain(*plain, *tail, num_rot,
                                        **pyr.plain_m())
    rraw = ms.score_init_multi_raw_plain(*plain, *tail, num_rot,
                                         **pyr.plain_m())
    torch.cuda.synchronize()
    for base in ("crop_score_multi_init", "crop_score_multi_init_raw"):
        assert _lokf_launched(base + "_i4" * int4 + "_lokf", before) == (1, 0)
    _check_init_lokf(got, ref, raw, rraw, num_rot)


@pytest.mark.cuda
@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("mode", ["tracked", "init", "mixed"])
def test_lokf_crop_step_on_card_matches_cpu(dev, mode, int4):
    """One whole crop update with the single-plane M on the card (its
    "_lokf" kernels, no hi/lo one) against the same update on the CPU
    (its plain versions), with the same resample shift."""
    d = synthetic_setup(512, h=128, w=128, seed=6)
    d["state"]["particles"]["have_init"][:] = (
        np.arange(512) % 3 == 0 if mode == "mixed" else mode == "tracked"
    )
    step = ft.make_update_step_fast(d["params"], 3, 1.0, 100, 512, mode,
                                    gmm_every=1)
    outs = []
    before = dict(kernels.LAUNCHES)
    for device in ("cpu", dev):
        maps, *args = [torch.as_tensor(d[k], device=device)
                       for k in ("packed", "map_size", "stencil", "scan")]
        st = filter_state_from_numpy(d["state"], device)
        outs.append(step(st, cs.CropMap(maps, int4=int4, m_hilo=False),
                         *args, 0.5, shift=0.25))
    for base in ("crop_score_tracked", "crop_score_init"):
        ran = mode in ("mixed", base.removeprefix("crop_score_"))
        name = base + "_i4" * int4 + "_lokf"
        assert _lokf_launched(name, before) == (int(ran), 0)
    cpu, gpu = outs
    assert int(gpu.n_active) == int(cpu.n_active)
    rows_c = np_(torch.cat(
        [cpu.particles.init_px, cpu.particles.theta[:, None]], 1))
    rows_g = np_(torch.cat(
        [gpu.particles.init_px, gpu.particles.theta[:, None]], 1))
    assert np.mean(np.all(rows_c == rows_g, axis=1)) >= 0.99
    assert_rel(np_(cpu.ml_state), np_(gpu.ml_state), 1e-5, "ml_state")


# -- the theta searches' window route (crop_init_i4_kernel, and
# crop_init_lokf_kernel on the float and the code map) ----------------------
def _init_cloud(centers, cloud, seed):
    """The centres of a window-route case: `spread` as _world gives them,
    `clustered` all but the first 7 (edges and far out) in a 24 px square
    at (100, 100), `edge` all but the first 7 within 4 px of the map's
    sides, inside and past them (rows whose window crosses the level's
    edge)."""
    rng = np.random.default_rng(seed)
    n = len(centers) - 7
    if n <= 0 or cloud == "spread":
        return centers
    if cloud == "clustered":
        pts = rng.uniform(88, 112, (n, 2))
    else:
        side = rng.integers(0, 4, n)
        along = rng.uniform(0, W, n)
        depth = rng.uniform(-4, 4, n)
        pts = np.stack([np.where(side < 2, along, np.where(side == 2, depth,
                                                            W - 1 + depth)),
                        np.where(side >= 2, along, np.where(side == 0, depth,
                                                             H - 1 + depth))],
                       -1)
    centers[7:] = torch.as_tensor(pts.astype(np.float32),
                                  device=centers.device)
    return centers


WINDOW_KINDS = ("hilo", "i4", "lokf", "i4_lokf")


def _window_maps(kind):
    """The CropMap arguments of a window-route kind: the float map with the
    hi/lo M ("hilo"), the code map with it ("i4"), the float map with the
    single-plane M ("lokf") or the code map with it ("i4_lokf")."""
    return {"int4": kind in ("i4", "i4_lokf"),
            "m_hilo": kind in ("hilo", "i4")}


def _init_sha(outs) -> str:
    """One SHA-256 of the argmin and raw rows a theta search wrote."""
    import hashlib

    h = hashlib.sha256()
    for part in outs:
        for t in part:
            h.update(np_(t.float().contiguous()).tobytes())
    return h.hexdigest()


def _check_window_init(kind, got, ref, num_rot=40):
    """A window-route theta search's argmin and raw rows against their plain
    versions, within the bounds each kind has always been held to, every
    row whose argmin differs a near tie of the plain rows (_near_ties: a
    clustered cloud's rows share their near ties)."""
    if kind in ("lokf", "i4_lokf"):  # the single-plane M
        _check_init_lokf(got[0], ref[0], got[1], ref[1], num_rot,
                         near_ties=True)
        return
    (best, k, kf), (rbest, rk, rkf) = got[0], ref[0]
    np.testing.assert_array_equal(np_(kf), np_(rkf))
    np.testing.assert_array_equal(np_(best) == cs.FLT_MAX,
                                  np_(rbest) == cs.FLT_MAX)
    _near_ties(k, rk, ref[1])
    fin = np_(rbest) < cs.FLT_MAX
    assert_rel(np_(rbest)[fin], np_(best)[fin], 1e-4, "best cost")
    _check_raw(got[1], ref[1], got[0], num_rot, far=[
        i for i in (5, 6) if i < len(kf)])


def _both_orders(base, inputs):
    """A window-route theta search's argmin and raw rows on inputs (in
    init_order) and on the same inputs with each bucket's rows in the
    particles' order (crop_ablate.init_ablation_rows: other warps, other
    votes, the same rows)."""
    other = ca.init_ablation_rows("particles", inputs)
    return ((cs.launch_init(base, inputs), cs.launch_init(base, inputs, True)),
            (cs.launch_init(base, other), cs.launch_init(base, other, True)))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", WINDOW_KINDS)
@pytest.mark.parametrize("cloud", ["spread", "clustered", "edge"])
@pytest.mark.parametrize("c,f,n", [
    (3, 1.0, N), (6, 1.0, N), (3, 1.5, N), (6, 1.5, 193), (3, 1.0, 102_400),
])
def test_init_window_route_equals_particle_order(dev, kind, cloud, c, f, n):
    """The uniform theta search on the window route (rows by position, an
    unchecked gather for each warp whose rows lie in their level), argmin
    and raw rows: the same bits with the rows in the particles' order, and
    within the plain version's bounds."""
    packed, sten, scan, cw, centers, _ = _world(dev, c, 31, n)
    centers = _init_cloud(centers, cloud, 31)
    maps = cs.CropMap(packed, **_window_maps(kind))
    args = (maps, c, sten, scan, cw, centers, f)
    name = cs.entry_name("crop_score_init", maps)
    before = dict(kernels.LAUNCHES)
    got, ordered = _both_orders("crop_score_init", cs.init_inputs(*args))
    plain = (maps.plain(c).packed, *args[1:])
    ref = (cs.score_init_sel_plain(*plain, **maps.plain_m()),
           cs.score_init_raw_plain(*plain, **maps.plain_m()))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] - before[name] == 2
    raw = cs.entry_name("crop_score_init", maps, raw=True)
    assert kernels.LAUNCHES[raw] - before[raw] == 2
    assert _init_sha(got) == _init_sha(ordered)
    _check_window_init(kind, got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", WINDOW_KINDS)
@pytest.mark.parametrize("cloud", ["spread", "clustered", "edge"])
@pytest.mark.parametrize("c,k,n", [(3, 10, N), (6, 2, N), (3, 10, 102_400)])
def test_multi_init_window_route_equals_particle_order(dev, kind, cloud, c,
                                                       k, n):
    """The K-bucket theta search on the window route, argmin and raw rows:
    the same bits with each bucket's rows in the particles' order, within
    the plain version's bounds."""
    args, _, tail = _multi_world(dev, c, k, 32, n, **_window_maps(kind))
    args = (*args[:5], _init_cloud(args[5], cloud, 32))
    pyr = args[0]
    before = dict(kernels.LAUNCHES)
    got, ordered = _both_orders("crop_score_multi_init",
                                ms.init_inputs(*args, *tail))
    plain = (pyr.plain(c),) + args[1:]
    ref = (ms.score_init_multi_sel_plain(*plain, *tail, **pyr.plain_m()),
           ms.score_init_multi_raw_plain(*plain, *tail, **pyr.plain_m()))
    torch.cuda.synchronize()
    name = cs.entry_name("crop_score_multi_init", pyr)
    assert kernels.LAUNCHES[name] - before[name] == 2
    assert _init_sha(got) == _init_sha(ordered)
    _check_window_init(kind, got, ref)
