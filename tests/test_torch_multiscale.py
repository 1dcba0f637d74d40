"""Port parity of the unknown-scale K-bucket path
(filter/multiscale.py and ParticleFilter._multi_mode).

The host functions and the dispatch's plan are numpy in both packages
and must agree exactly.  The port's plain scorers are held to the JAX
multi kernel (interpret mode, as tests/test_multiscale.py runs it) within
the bounds of tests/test_pallas_interpret.py (its pyramid is int8), and,
per bucket, to the port's own uniform scorer on that bucket's level
(rel <= 1e-4).  The CUDA kernels are compared with these plain versions
in tests/test_torch_cuda.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from top_down_renderer_tpu.config import FilterParams, MapParams
from top_down_renderer_tpu.filter import multiscale as ms_j
from top_down_renderer_tpu.filter import pallas_score as ps
from top_down_renderer_tpu.filter import resample as res_j
from top_down_renderer_tpu.filter.filter import ParticleFilter as PFJ
from top_down_renderer_tpu.maps.map import TopDownMap as TDMJ
from top_down_renderer_tpu.maps.map import build_grid as build_grid_j
from top_down_renderer_torch.filter import crop_score as cs
from top_down_renderer_torch.filter import multiscale as ms
from top_down_renderer_torch.filter.filter import MultiDispatch
from top_down_renderer_torch.filter.filter import ParticleFilter as PFT
from top_down_renderer_torch.filter.resample import pack_fields
from top_down_renderer_torch.filter.scoring import rotation_shift
from top_down_renderer_torch.maps.map import TopDownMap
from top_down_renderer_torch.maps.polar import polar_stencil

from test_multiscale import C, MO, _world
from test_pallas_interpret import _check
from torch_parity import assert_rel, np_

torch.set_num_threads(2)

SLOTS = np.array([0.5, 1.0], np.float32)  # res 1: mip 1 and mip 2, f 0.5
MIPS = (1, 2)
BMI = (0, 1)


# -- host functions -----------------------------------------------------
def test_cluster_scales_and_mip_for_f_equal_jax():
    rng = np.random.default_rng(0)
    hyp = 10.0 ** (np.arange(8) / 10.0)
    cases = [
        (np.repeat(10.0 ** (np.arange(10) / 10.0), 100).astype(np.float32),
         ms.SCALE_RTOL),
        ((np.repeat(hyp, 200) * (1.0 + rng.standard_normal(1600) * 0.005))
         .astype(np.float32), 0.03),
        ((10.0 ** np.random.default_rng(1).uniform(0, 1, 5000))
         .astype(np.float32), ms.SCALE_RTOL),
        (np.array([-1.0, 0.0], np.float32), ms.SCALE_RTOL),
    ]
    for scales, rtol in cases:
        a = ms_j.cluster_scales(scales, rtol=rtol)
        b = ms.cluster_scales(scales, rtol=rtol)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    for f in (0.3, 0.5, 0.51, 1.0, 3.97, 31.9, 32.1, 64.0, 64.5, 200.0):
        for fmax in (0.5, 1.0):
            assert ms.mip_for_f(f, fmax) == ms_j.mip_for_f(f, fmax), (f, fmax)
    for name in ("MAX_BUCKETS", "SCALE_RTOL", "RTOL_LADDER", "MO_MULTI",
                 "MO_MULTI_FINE", "MULTI_FINE_SPREAD"):
        assert getattr(ms, name) == getattr(ms_j, name), name


def test_multi_mo_equals_jax(monkeypatch):
    monkeypatch.delenv("TDR_MULTI_MO", raising=False)
    for spread in (float("inf"), 7.94, 1.61, 1.6, 1.15):
        assert ms.multi_mo(spread) == ms_j.multi_mo(spread), spread
    for v in ("12", "24"):
        monkeypatch.setenv("TDR_MULTI_MO", v)
        assert ms.multi_mo(100.0) == ms_j.multi_mo(100.0) == int(v)
        assert ms.multi_mo(1.0) == ms_j.multi_mo(1.0) == int(v)


# -- the dispatch's plan ------------------------------------------------
def _filters(n=640):
    """JAX and port filters at an unknown scale on test_multiscale's 96^2
    three-class world, from the same seed."""
    maps_bin = np.ones((C, 96, 96), np.float32)
    maps_bin[1, 44:52, :] = 0.0
    mp = MapParams(map_path="", num_classes=C, resolution=1.0)
    tdm_j = TDMJ(mp)
    tdm_j.grid = build_grid_j(maps_bin, 1.0, 50.0)
    tdm_j.class_maps_binary = maps_bin
    tdm_j.have_map = True
    tdm_j.sample_pts_polar(100, 25)
    tdm_t = TopDownMap(mp, device="cpu", class_maps=maps_bin)
    tdm_t.sample_pts_polar(100, 25)
    kw = dict(fixed_scale=-1.0, class_weights=[0.5] + [1.5] * (C - 1))
    pf_j = PFJ(n, tdm_j, FilterParams(**kw), seed=0, chunk_size=64,
               use_fast=True)
    pf_t = PFT(n, tdm_t, FilterParams(**kw), seed=0, chunk_size=64)
    return pf_j, pf_t


def _set_scales(pf_j, pf_t, scales):
    scales = np.asarray(scales, np.float32)
    pf_j.state = pf_j.state.replace(particles=pf_j.state.particles.replace(
        scale=jnp.asarray(scales)))
    pf_t.state = pf_t.state.replace(particles=pf_t.state.particles.replace(
        scale=torch.as_tensor(scales)))


def _blob(n, rng, centre, half):
    return centre * np.exp(rng.uniform(-half, half, n))


@pytest.mark.parametrize("case", ["init", "blob", "wide", "gate_dead",
                                  "saturating", "continuum"])
def test_multi_mode_plan_equals_jax(case, monkeypatch):
    monkeypatch.delenv("TDR_MULTI_MO", raising=False)
    pf_j, pf_t = _filters()
    n = pf_t.n_max
    np.testing.assert_array_equal(
        pf_t.state.particles.init_px.numpy(),
        np.asarray(pf_j.state.particles.init_px),
    )
    np.testing.assert_array_equal(
        pf_t.state.particles.scale.numpy(),
        np.asarray(pf_j.state.particles.scale),
    )
    res = 1.0
    rng = np.random.default_rng(5)
    if case != "init":
        pf_j._all_have_init = pf_t._all_have_init = True
    if case == "blob":  # test_multiscale: one diffused blob, fine mo
        _set_scales(pf_j, pf_t, _blob(n, rng, 1.05, 0.08))
    elif case == "wide":  # a ladder rung past the base rtol, coarse mo
        _set_scales(pf_j, pf_t, _blob(n, rng, 2.0, 0.35))
    elif case == "gate_dead":  # test_dispatch: outliers past the gate,
        s = np.full(n, 2.0, np.float32)  # over 2 %: the coarse mo
        s[: n // 20] = 50.0
        _set_scales(pf_j, pf_t, s)
    elif case == "saturating":  # a live slot beyond mip 64
        s = np.full(n, 1.0, np.float32)
        s[: n // 20] = 8.0
        _set_scales(pf_j, pf_t, s)
        res = 8.0
    elif case == "continuum":
        _set_scales(pf_j, pf_t, 10.0 ** rng.uniform(0, 1, n))
    ref = pf_j._multi_mode(res)
    got = pf_t._multi_mode(res)
    if case in ("saturating", "continuum"):
        assert ref is None and got is None
        assert pf_t._slow_reason == pf_j._slow_reason.replace(
            "exact-gather", "exact gather")
        return
    assert isinstance(got, MultiDispatch)
    mode, mo, _, tag, slots, levels, bmi, kp = ref
    assert tag == "multi"
    assert (got.mode, got.mo, got.levels, got.bmi, got.kp) == (
        mode, mo, levels, bmi, kp)
    np.testing.assert_array_equal(got.slots, slots)
    if case == "init":
        assert mode == "init" and kp == 12
    if case == "gate_dead":
        assert got.slots.max() < 50.0


# -- the scorers --------------------------------------------------------
@pytest.fixture(scope="module")
def world():
    """test_multiscale's setup: 256^2 world, n = 96 integer centres, two
    buckets (scale 0.5 at mip 1, 1.0 at mip 2, res 1), with the JAX multi
    kernel's outputs in interpret mode."""
    packed, stencil, scan, cw, rng = _world()
    n = 96
    centers = rng.integers(48, 200, (n, 2)).astype(np.float32)
    scale = np.where(rng.random(n) < 0.5, 0.5, 1.0).astype(np.float32)
    thetas = (np.random.default_rng(9).random(n) * 2 * np.pi).astype(
        np.float32)
    pyr = ms_j.build_pyramid_maps(jnp.asarray(packed), MIPS)
    jargs = (pyr, jnp.asarray(stencil), jnp.asarray(scan), cw,
             jnp.asarray(centers))
    tail = (jnp.asarray(scale), jnp.asarray(SLOTS),
            jnp.asarray(1.0, jnp.float32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ps, "init_p_tile", lambda mo, **kw: 16)
        mp.setattr(ps, "tracked_p_tile", lambda mo, **kw: 16)
        raw = ms_j.make_score_init_multi(2, BMI, interpret=True, mo=MO)(
            *jargs, *tail)
        sel = ms_j.make_score_init_multi(
            2, BMI, interpret=True, mo=MO, sel=True)(*jargs, *tail)
        tracked = ms_j.make_score_tracked_multi(
            2, BMI, interpret=True, mo=MO)(*jargs, jnp.asarray(thetas), *tail)
    ref = {k: tuple(np.asarray(a) for a in v)
           for k, v in (("raw", raw), ("sel", sel), ("tracked", tracked))}
    t = {k: torch.as_tensor(v) for k, v in (
        ("packed", packed), ("stencil", stencil), ("scan", scan),
        ("cw", np.array(cw)), ("centers", centers), ("scale", scale),
        ("thetas", thetas), ("slots", SLOTS))}
    t["pyr"] = ms.build_pyramid_maps(t["packed"], MIPS)
    return t, ref


def _args(t):
    return (t["pyr"], C, t["stencil"], t["scan"], t["cw"], t["centers"])


def _ratio(num, den):
    with np.errstate(invalid="ignore", divide="ignore"):
        return np_(num) / np_(den)


def test_plain_init_rows_vs_jax_kernel(world):
    t, ref = world
    nums, dens, kf = ms.score_init_multi_raw_plain(
        *_args(t), t["scale"], t["slots"], BMI, 1.0)
    rn, rd, rkf = ref["raw"]
    for j in range(0, 40, 3):
        _check(_ratio(rn[:, j], rd[:, j]), _ratio(nums[:, j], dens[:, j]),
               rkf, np_(kf), f"init shift {j}")


def test_plain_init_sel_vs_jax_kernel(world):
    t, ref = world
    best, k, kf = ms.score_init_multi_sel(
        *_args(t), t["scale"], t["slots"], BMI, 1.0)
    rbest, rtheta, rkf = ref["sel"]
    finite = rbest < cs.FLT_MAX
    np.testing.assert_array_equal(np_(best) < cs.FLT_MAX, finite)
    _check(rbest[finite], np_(best)[finite], rkf[finite], np_(kf)[finite],
           "sel_init best")
    # where the argmins differ, the shifts are a near tie under the int8
    # quantisation: the port's cost at JAX's argmin is within _check's
    # mean bound (2e-2) of its own best
    nums, dens, _ = ms.score_init_multi_raw_plain(
        *_args(t), t["scale"], t["slots"], BMI, 1.0)
    costs = _ratio(nums, dens)
    k_j = np.round(rtheta / np.float32(2 * math.pi / 40)).astype(int)
    rows = np.flatnonzero(finite)
    at_j = costs[rows, k_j[rows]]
    rel = np.abs(at_j - np_(best)[rows]) / np_(best)[rows]
    assert np.mean(np_(k)[rows] == k_j[rows]) > 0.85
    assert rel.max() < 2e-2, rel.max()


def test_plain_tracked_vs_jax_kernel(world):
    t, ref = world
    num, den, kf = ms.score_tracked_multi(
        *_args(t), t["thetas"], t["scale"], t["slots"], BMI, 1.0)
    rn, rd, rkf = ref["tracked"]
    _check(_ratio(rn, rd), _ratio(num, den), rkf, np_(kf), "tracked")


def test_each_bucket_equals_the_uniform_scorer_on_its_level(world):
    """Per bucket, the multi plain version is the uniform plain version
    on mip_map(dist, mip_b) at f_eff_b (rel <= 1e-4, kf equal)."""
    t, _ = world
    nums, dens, kf = ms.score_init_multi_raw_plain(
        *_args(t), t["scale"], t["slots"], BMI, 1.0)
    cost, norm, kf_t = ms.score_tracked_multi_plain(
        *_args(t), t["thetas"], t["scale"], t["slots"], BMI, 1.0)
    bucket = np_(ms.assign_buckets(t["scale"], t["slots"]))
    for b, (mip, sv) in enumerate(zip(MIPS, SLOTS)):
        sel = bucket == b
        assert sel.sum() > 20
        f_eff = np.float32(sv) / np.float32(mip)
        level = cs.mip_map(t["packed"], mip)
        assert torch.equal(level, t["pyr"].level_map(b))
        u_args = (level, C, t["stencil"], t["scan"], t["cw"],
                  t["centers"][sel])
        un, ud, ukf = cs.score_init_raw_plain(*u_args, f_eff,
                                              map_resolution=float(mip))
        np.testing.assert_array_equal(np_(kf)[sel], np_(ukf))
        assert_rel(np_(un), np_(nums)[sel], 1e-4, f"bucket {b} init num")
        assert_rel(np_(ud), np_(dens)[sel], 1e-4, f"bucket {b} init den")
        tn, td, tkf = cs.score_tracked_plain(
            *u_args, t["thetas"][sel], f_eff, map_resolution=float(mip))
        np.testing.assert_array_equal(np_(kf_t)[sel], np_(tkf))
        assert_rel(np_(tn), np_(cost)[sel], 1e-4, f"bucket {b} cost")
        assert_rel(np_(td), np_(norm)[sel], 1e-4, f"bucket {b} norm")


def test_level_bounds_read_zeros_not_the_next_level():
    """test_multiscale's level-bounds case: a mip-2 window above the map
    scores kf 0.  On a hand-made pyramid whose level 0 is all known and
    level 1 all unknown, windows that cross level 1's edges (whose rows
    sit right after level 0's in the flat tensor) still score kf 0."""
    packed, stencil, scan, cw, _ = _world()
    sten, sc, cwt = (torch.as_tensor(a) for a in (stencil, scan,
                                                  np.array(cw)))
    pyr = ms.build_pyramid_maps(torch.as_tensor(packed), MIPS)
    bad = torch.tensor([[64.0, -100.0], [64.0, 64.0]])
    scl = torch.tensor([1.0, 1.0])  # both bucket 1 (mip 2)
    _, _, kf = ms.score_init_multi_raw_plain(
        pyr, C, sten, sc, cwt, bad, scl, torch.as_tensor(SLOTS), BMI, 1.0)
    assert np_(kf)[0] == 0.0 and np_(kf)[1] > 0.5

    h = 64
    flat = torch.zeros((h * h + (h // 2) ** 2, 8))
    flat[: h * h, C] = 1.0  # level 0 known everywhere, level 1 nowhere
    hand = ms.PyramidMaps(flat, MIPS, ((0, h, h), (h * h, h // 2, h // 2)))
    edge = torch.tensor([[40.0, -6.0], [40.0, 66.0], [-6.0, 40.0],
                         [66.0, 40.0], [40.0, 40.0]])
    for scale, want in ((1.0, 0.0), (0.5, None)):
        _, _, kf = ms.score_init_multi_raw_plain(
            hand, C, sten, sc, cwt, edge, torch.full((5,), scale),
            torch.as_tensor(SLOTS), BMI, 1.0)
        if want is None:  # level 0: partly outside, but known inside
            assert (np_(kf) > 0).all()
        else:
            assert (np_(kf) == want).all(), np_(kf)


def test_kernel_operand_checks(world):
    """What the CUDA wrapper derives and refuses, checked on CPU tensors."""
    t, _ = world
    th = t["thetas"]
    got = ms._tracked_inputs(*_args(t), th, t["scale"], t["slots"], BMI,
                             1.0, 1.0)
    compact, table, fold, ctr, key = got
    assert compact is t["pyr"].compact(C)
    assert compact.shape == (256 * 256 + 128 * 128, 4)
    pix = fold[0]
    assert table.dtype == pix.dtype == ctr.dtype == torch.int32
    assert tuple(pix.shape) == (2, 2512, 2) and tuple(table.shape) == (2, 4)
    assert all(x.is_contiguous() for x in (table, pix, ctr))
    assert table.tolist() == [[0, 256, 256, 0], [65536, 128, 128, 0]]
    bucket = ms.assign_buckets(t["scale"], t["slots"]).long()
    assert torch.equal(key, bucket * 100 + rotation_shift(th, 100))
    with pytest.raises(ValueError, match="buckets"):
        ms._tracked_inputs(*_args(t), th, t["scale"], torch.ones(13),
                           tuple(range(13)), 1.0, 1.0)
    with pytest.raises((ValueError, TypeError)):
        ms._tracked_inputs(*_args(t), th, t["scale"].double(), t["slots"],
                           BMI, 1.0, 1.0)
    with pytest.raises(ValueError, match="theta"):
        ms._tracked_inputs(*_args(t), th[:3], t["scale"], t["slots"], BMI,
                           1.0, 1.0)


@pytest.mark.parametrize("fn", ["score_tracked_multi", "score_init_multi_sel"])
def test_wrapper_raises_off_cpu_and_cuda(fn):
    pyr = ms.PyramidMaps(torch.zeros((16, 8), device="meta"), (1,),
                         ((0, 4, 4),))
    args = [pyr, C] + [torch.zeros(s, device="meta") for s in
                       ((100, 25, 2), (C, 100, 25), (C,), (4, 2))]
    extra = [torch.zeros(4, device="meta")] if "tracked" in fn else []
    with pytest.raises(ValueError, match="no crop scorer"):
        getattr(ms, fn)(*args, *extra, torch.ones(4), torch.ones(1), (0,),
                        1.0)


def test_offsets_and_centres_follow_reference_rounding():
    """round(stencil * slot * res / mip) in float32, and the centre a true
    division by map_resolution * mip, as the reference's compiled scorer
    computes them."""
    sten = torch.as_tensor(_world()[1])
    slots = torch.tensor([1.0, 1.2589, 3.1623, 7.9433])
    mips = torch.tensor([1.0, 2.0, 8.0, 16.0])
    for res in (0.5, 1.0, 0.37):
        got = np_(ms.bucket_offsets(sten, slots, res, mips))
        f = (np_(slots) * np.float32(res) / np_(mips)).astype(np.float32)
        ref = np.round(np_(sten).reshape(1, -1, 2) * f[:, None, None])
        np.testing.assert_array_equal(got, ref.astype(np.int32))
    c = torch.tensor([[2.5, 3.5], [-0.5, 7.49], [1e12, -1e12], [np.nan, 4],
                      [12.0, 6.0]])
    b = torch.tensor([0, 0, 1, 2, 1], dtype=torch.int32)
    got = np_(ms.pyramid_centers(c, b, torch.tensor([1.0, 2.0, 4.0]), 0.3))
    d = np.float32(0.3) * np.array([1.0, 1.0, 2.0, 4.0, 2.0], np.float32)
    want = np.round(np_(c)[:, ::-1] / d[:, None])
    np.testing.assert_array_equal(got[[0, 1, 4]], want[[0, 1, 4]])
    assert (np.abs(got[2:4]).max(1) >= 2**20).all()


# -- one whole step -----------------------------------------------------
STEP_N = 128
STEP_SLOTS = np.array([1.0, 2.0], np.float32)  # res 0.5: mip 1 and 2, f 0.5


def _theta_flips_are_near_ties(out_j, out_t, st_t, scorer_args):
    """Rows of the two resampled sets that differ only in theta, where
    the reference's theta-search argmin (hi/lo int8 M table) and the
    port's (float32) are a near tie: the port's cost at the reference's
    shift lies within 2e-2 (the mean bound of test_pallas_interpret's
    _check) of its own best.  Returns the mask of such rows."""
    rows_j = np.asarray(res_j.pack_fields(out_j.particles))
    rows_t = np_(pack_fields(out_t.particles))
    other = np.ones(8, bool)
    other[4] = False  # theta
    flip = np.all(rows_j[:, other] == rows_t[:, other], axis=1) & (
        rows_j[:, 4] != rows_t[:, 4])
    if not flip.any():
        return flip
    nums, dens, _ = ms.score_init_multi_raw_plain(*scorer_args)
    costs = _ratio(nums, dens)
    best = np.nanmin(costs, axis=1)
    src_rows = np_(pack_fields(st_t.particles))[:, :4]
    step = np.float32(2 * math.pi / 40)
    for i in np.flatnonzero(flip):
        src = np.flatnonzero(np.all(src_rows == rows_t[i, :4], axis=1))
        assert src.size == 1, f"row {i}: no single source particle"
        s = src[0]
        k_j = int(np.round(rows_j[i, 4] / step))
        rel = abs(costs[s, k_j] - best[s]) / best[s]
        assert rel < 2e-2, f"row {i}: reference shift {k_j} rel {rel}"
    return flip


@pytest.mark.parametrize("mode", ["init", "tracked", "mixed"])
def test_multi_step_matches_jax(mode):
    """One make_update_step_multiscale step, port (plain scorers) against
    JAX (interpret mode), on the same state, map and resample shift.  The
    map's distances are integers up to 126, which the reference's int8
    map stores exactly; its M table is still hi/lo quantised.  As in the
    uniform whole-step test 1 % of the resampled rows may differ, beyond
    the rows whose theta-search argmin differs on a near tie (each such
    particle's copies all carry its theta)."""
    import __graft_entry__ as ge
    from test_torch_filter import _compare_states, _resample_shift
    from top_down_renderer_tpu.filter import filter as fj
    from top_down_renderer_torch.filter import filter as ft
    from top_down_renderer_torch.testing import synthetic_setup
    from top_down_renderer_torch.utils.convert import filter_state_from_numpy

    st_j, *_, params = ge._synthetic_setup(STEP_N, seed=3)
    d = synthetic_setup(STEP_N, seed=3)
    np.testing.assert_array_equal(d["state"]["particles"]["init_px"],
                                  np.asarray(st_j.particles.init_px))
    rng = np.random.default_rng(4)
    packed = d["packed"]
    packed[..., :C] = np.round(packed[..., :C] * (126.0 / 50.0))
    packed[0, 0, :C] = 126.0
    scale = STEP_SLOTS[rng.integers(0, 2, st_j.particles.n_max)]
    have = np.full(len(scale), mode != "init")
    if mode == "mixed":
        have = np.arange(len(scale)) % 3 == 0
    d["state"]["particles"]["scale"][:] = scale
    d["state"]["particles"]["have_init"][:] = have
    st_j = st_j.replace(particles=st_j.particles.replace(
        scale=jnp.asarray(scale), have_init=jnp.asarray(have)))
    params = FilterParams(**{**params.__dict__, "fixed_scale": -1.0})
    n = st_j.particles.n_max
    res = 0.5
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ps, "init_p_tile", lambda mo, **kw: 16)
        mp.setattr(ps, "tracked_p_tile", lambda mo, **kw: 16)
        step_j = fj.make_update_step_multiscale(
            params, C, 1.0, 100, n, mode, 2, BMI, mo=MO, gmm_every=1,
            interpret=True,
        )
        out_j = step_j(
            st_j, ms_j.build_pyramid_maps(jnp.asarray(packed), MIPS),
            jnp.asarray(d["map_size"]), jnp.asarray(d["stencil"]),
            jnp.asarray(d["scan"]), jnp.float32(res),
            jnp.asarray(STEP_SLOTS),
        )
    step_t = ft.make_update_step_multiscale(params, C, 1.0, 100, n, mode,
                                            BMI, gmm_every=1)
    t = {k: torch.as_tensor(d[k]) for k in ("map_size", "stencil", "scan")}
    st_t = filter_state_from_numpy(d["state"])
    pyr = ms.build_pyramid_maps(torch.as_tensor(packed), MIPS)
    out_t = step_t(
        st_t, pyr, t["map_size"], t["stencil"], t["scan"], res,
        torch.as_tensor(STEP_SLOTS), shift=_resample_shift(st_j),
    )
    _compare_states(out_j, out_t, rows_frac=0.0)
    p = st_t.particles
    flip = _theta_flips_are_near_ties(out_j, out_t, st_t, (
        pyr, C, t["stencil"], t["scan"], ft._pad_class_weights(params, C),
        p.pose_px(), p.scale, torch.as_tensor(STEP_SLOTS), BMI, res))
    if mode == "tracked":
        assert not flip.any()
    rows_j = np.asarray(res_j.pack_fields(out_j.particles))
    rows_t = np_(pack_fields(out_t.particles))
    same = np.all(rows_j == rows_t, axis=1) | flip
    assert same.mean() >= 0.99, f"{same.mean():.3f} rows identical"


# -- the theta-search kernel's product, per bucket -----------------------
def _bucket_rows_product(pyr, c, sten, scan, cw, ctr_px, scale, slots, bmi,
                         res, num_rot, split):
    """The K-bucket kernel's arithmetic on the CPU: each particle's window
    on its bucket's level, times its bucket's M (float32, or the bf16
    hi/lo split when `split`), in the kernel's bucket-major row order;
    returns (num, den, kf) in particle order."""
    from test_torch_crop_score import _rows_of, _split_product, _window_rows

    bucket, off, ctr, table = ms._prepare(pyr, sten, ctr_px, scale, slots,
                                          bmi, res, 1.0)
    pix, npix, order, seg = cs.fold_pixels(off)
    m = cs.init_m(scan, cw, order, seg, num_rot)
    perm, row_start = ms.bucket_rows(bucket, len(bmi))
    acc = torch.zeros((len(ctr), cs.M_COLS))
    for b in range(len(bmi)):
        rows = perm[row_start[b] : row_start[b + 1]].long()
        assert (bucket[rows] == b).all()
        a, mm = _window_rows(pyr.compact(c), ctr[rows], pix[b], npix[b],
                             m[b], level=tuple(table[b, :3].tolist()))
        acc[rows] = _split_product(a, mm) if split else a @ mm
    return _rows_of(acc, num_rot, scan.shape[1] * scan.shape[2])


def _bucket_case(k, c):
    """K = 2 (mips 1 and 2) or the 10 init hypotheses on the levels the
    dispatch gives them, with windows across a level's edges and outside
    it, and a bucket of one particle: (pyr, tensors (stencil, scan, cw,
    centres, scale, slots), bmi, res, rng)."""
    rng = np.random.default_rng(10 * k + c)
    packed = np.zeros((96, 112, 8), np.float32)
    packed[..., :c] = rng.random((96, 112, c)) * 50
    packed[..., c] = (rng.random((96, 112)) < 0.9).astype(np.float32)
    scan = (rng.random((c, 100, 25)) * 3).astype(np.float32)
    if k == 2:
        slots, res = SLOTS, 1.0
    else:
        slots, res = (10.0 ** (np.arange(10) / 10.0)).astype(np.float32), 0.5
    mips = ms.bucket_mips(slots.copy(), ms.SCALE_RTOL, ms.MO_MULTI, 25, res,
                          10.0)
    levels = tuple(sorted(set(mips)))
    bmi = tuple(levels.index(mm) for mm in mips)
    n = 120
    pick = np.concatenate([[0], rng.integers(1, k, n - 1)])  # bucket 0: one
    scale = (slots[pick] * (1 + 0.02 * (rng.random(n) - 0.5))).astype(
        np.float32)
    centers = rng.uniform(-30, 140, (n, 2)).astype(np.float32)
    centers[1:5] = [[0.0, 0.0], [111.0, 95.0], [-400.0, 30.0],
                    [30.0, 500.0]]
    cw = (0.5 + rng.random(c)).astype(np.float32)
    pyr = ms.build_pyramid_maps(torch.as_tensor(packed), levels)
    t = [torch.as_tensor(a) for a in (polar_stencil(100, 25), scan, cw,
                                      centers, scale, slots)]
    return pyr, t, bmi, res, rng


@pytest.mark.parametrize("c", [1, 3, 6])
@pytest.mark.parametrize("num_rot", [7, 40])
@pytest.mark.parametrize("k", [2, 10])
def test_init_m_per_bucket_equals_raw_rows(k, num_rot, c):
    """Per bucket, window @ M_b (float32) is the plain version's raw rows
    (rel 1e-5, kf bit-equal): K = 2 (mips 1 and 2) and the 10 init
    hypotheses on the levels the dispatch gives them, windows across a
    level's edges and outside it included, and a bucket of one particle."""
    pyr, t, bmi, res, _ = _bucket_case(k, c)
    args = (pyr, c, *t[:4], t[4], t[5], bmi, res, num_rot)
    nums, dens, kf = ms.score_init_multi_raw_plain(*args)
    assert int((ms.assign_buckets(t[4], t[5]) == 0).sum()) == 1
    got = _bucket_rows_product(pyr, c, *t, bmi, res, num_rot, split=False)
    assert_rel(np_(nums), np_(got[0]), 1e-5, "num")
    assert_rel(np_(dens), np_(got[1]), 1e-5, "den")
    np.testing.assert_array_equal(np_(got[2]), np_(kf))
    assert (np_(kf) == 0).any() and (np_(kf) > 0.5).any()


def test_bucket_rows_are_stable_and_bucket_major():
    bucket = torch.tensor([3, 0, 3, 1, 0, 3, 3], dtype=torch.int32)
    perm, row_start = ms.bucket_rows(bucket, 5)
    assert perm.dtype == torch.int32
    assert perm.tolist() == [1, 4, 3, 0, 2, 5, 6]
    assert row_start.tolist() == [0, 2, 3, 3, 7, 7]


def test_split_arithmetic_holds_the_jax_kernel_bounds(world):
    """The K-bucket kernel's bf16 hi/lo arithmetic, emulated on the CPU,
    against the JAX multi theta search (interpret mode, compiled) within
    its bounds, and within rel 1e-4 of the plain version."""
    t, ref = world
    nums, dens, kf = _bucket_rows_product(
        t["pyr"], C, t["stencil"], t["scan"], t["cw"], t["centers"],
        t["scale"], t["slots"], BMI, 1.0, 40, split=True)
    best, k = cs.select_best(nums, dens, kf)
    rbest, _, rkf = ref["sel"]
    finite = rbest < cs.FLT_MAX
    np.testing.assert_array_equal(np_(best) < cs.FLT_MAX, finite)
    _check(rbest[finite], np_(best)[finite], rkf[finite], np_(kf)[finite],
           "split sel_init best")
    pbest, pk, pkf = ms.score_init_multi_sel_plain(
        *_args(t), t["scale"], t["slots"], BMI, 1.0)
    np.testing.assert_array_equal(np_(kf), np_(pkf))
    fin = np_(pbest) < cs.FLT_MAX
    assert_rel(np_(pbest)[fin], np_(best)[fin], 1e-4, "split vs plain")
    assert np.mean(np_(k) == np_(pk)) >= 0.999


# -- the tracked kernel's folded product, per bucket ----------------------
def _folded_multi(pyr, c, sten, scan, cw, ctr_px, thetas, scale, slots, bmi,
                  res):
    """The K-bucket tracked kernel's computation in plain PyTorch: the
    offsets folded per bucket, the weights at every shift, each particle's
    window of its bucket's distinct pixels on its level of the compact
    pyramid."""
    bucket, off, ctr, table = ms._prepare(pyr, sten, ctr_px, scale, slots,
                                          bmi, res, 1.0)
    pix, _, order, seg = cs.fold_offsets(off)
    w = cs.tracked_weights(scan, cw, order, seg)
    return cs.folded_scores(pyr.compact(c), table, ctr, pix, w, bucket,
                            rotation_shift(thetas, scan.shape[1]), c)


@pytest.mark.parametrize("c", [1, 3, 6])
@pytest.mark.parametrize("k", [2, 10])
def test_folded_product_per_bucket_equals_tracked_plain(k, c):
    """The tracked kernel's fold per bucket (fold_offsets, tracked_weights,
    folded_scores) is the plain version (rel 1e-5, kf bit-equal), at
    every shift (thetas negative and over two turns), on both bucket
    sets of _bucket_case."""
    pyr, t, bmi, res, rng = _bucket_case(k, c)
    n = len(t[3])
    thetas = torch.as_tensor(
        (rng.random(n) * 4 * np.pi - np.pi).astype(np.float32))
    thetas[:100] = torch.arange(100) * (2 * math.pi / 100) - 2 * math.pi
    assert len(set(rotation_shift(thetas, 100).tolist())) == 100
    cost, norm, kf = ms.score_tracked_multi_plain(
        pyr, c, *t[:4], thetas, t[4], t[5], bmi, res)
    got = _folded_multi(pyr, c, *t[:4], thetas, t[4], t[5], bmi, res)
    np.testing.assert_array_equal(np_(got[2]), np_(kf))
    assert_rel(np_(cost), np_(got[0]), 1e-5, "cost")
    assert_rel(np_(norm), np_(got[1]), 1e-5, "norm")
    assert (np_(kf) == 0).any() and (np_(kf) > 0.5).any()


def test_folded_product_holds_the_jax_tracked_kernel_bounds(world):
    """The K-bucket tracked kernel's fold against the JAX multi tracked
    kernel (interpret mode) within test_plain_tracked_vs_jax_kernel's
    bounds."""
    t, ref = world
    num, den, kf = _folded_multi(*_args(t), t["thetas"], t["scale"],
                                 t["slots"], BMI, 1.0)
    rn, rd, rkf = ref["tracked"]
    _check(_ratio(rn, rd), _ratio(num, den), rkf, np_(kf), "folded tracked")
