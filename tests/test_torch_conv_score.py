"""Port parity of the conv fast path (filter/conv_score.py, the conv step
of filter/filter.py and the conv branch of ParticleFilter._fast_mode).

Each test feeds the same numpy inputs from a seed to the JAX function,
jitted (the shift tables round as in the compiled step), and to the port
on the CPU.

- The scorers against JAX's make_conv_scorer at its default formulation
  (the space-to-depth fold, with the kf split where it applies): both
  round the map and the kernel to bf16 and add float32 products, in other
  orders, so cost and norm agree within rel 1e-4 and kf, an integer
  count over Th R, is equal.
- The scorers against the port's exact step, with the bounds of
  tests/test_conv_score.py (rtol 3e-3, atol 1e-5: bf16 operands).
- The host plan (_shift_window, _fast_mode) equal to JAX's.
- One whole conv step per mode against JAX's, within the tolerances of
  the crop step's test in tests/test_torch_filter.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from top_down_renderer_tpu.config import FilterParams, MapParams
from top_down_renderer_tpu.filter import conv_score as cs_j
from top_down_renderer_tpu.filter import filter as fj
from top_down_renderer_tpu.filter import pallas_score as ps
from top_down_renderer_tpu.filter.filter import ParticleFilter as PFJ
from top_down_renderer_tpu.maps.map import TopDownMap as TDMJ
from top_down_renderer_tpu.maps.map import build_grid as build_grid_j
from top_down_renderer_torch.filter import conv_score as cs
from top_down_renderer_torch.filter import crop_score
from top_down_renderer_torch.filter import filter as ft
from top_down_renderer_torch.filter.scoring import (
    rotation_shift,
    score_all_rotations,
    search_shifts,
)
from top_down_renderer_torch.maps.map import TopDownMap
from top_down_renderer_torch.maps.polar import polar_stencil
from top_down_renderer_torch.utils.convert import filter_state_from_numpy

from test_torch_filter import _compare_states, _setups
from torch_parity import assert_rel, np_
from util_synthetic import make_world

torch.set_num_threads(2)

TH, R, C = 100, 25, 3
F1 = 1.0  # scale * res: conv bucket mo 24, a 50 x 50 kernel


def _inputs(seed=0, h=256, w=256, n=512, band=None, dead=16):
    """Map (8 packed channels, an unknown tenth and an unknown block),
    stencil, scan, class weights, n float centres in a 60 px box, thetas
    (in a band of +-band around 1 rad, else over a turn) and an alive
    mask whose last `dead` slots are dead, far from the cloud."""
    rng = np.random.default_rng(seed)
    packed = np.zeros((h, w, 8), np.float32)
    packed[..., :C] = rng.random((h, w, C)) * 50
    packed[..., C] = (rng.random((h, w)) < 0.9).astype(np.float32)
    packed[110:200, 80:130, C] = 0.0  # kf < 0.5 on the left of the cloud
    scan = (rng.random((C, TH, R)) * 3).astype(np.float32)
    cw = np.array([1.0, 2.0, 0.5], np.float32)
    centers = (np.array([100.0, 120.0]) + rng.random((n, 2)) * 60).astype(
        np.float32)
    if band is None:
        thetas = rng.random(n) * 2 * np.pi
    else:
        thetas = 1.0 + (rng.random(n) - 0.5) * 2 * band
    alive = np.arange(n) < n - dead
    centers[n - dead :] = [5.0, 7.0]
    return dict(packed=packed, stencil=polar_stencil(TH, R), scan=scan,
                cw=cw, centers=centers, thetas=thetas.astype(np.float32),
                alive=alive)


@pytest.fixture
def compiled_search_shifts(monkeypatch):
    """The reference's conv theta search takes its shifts from an eager
    call of scoring.search_shifts.  On the TPU that equals the compiled
    step's; on the CPU eager JAX rounds two .5 ties (k = 17, 19: shifts
    43 and 47 against 42 and 48) the other way.  The port follows the
    compiled step (ROADMAP Queue 3, "Rounding ties"), so the reference's
    conv scorer gets the compiled shifts here."""
    from top_down_renderer_tpu.filter import scoring as sc_j

    compiled = jax.jit(sc_j.search_shifts, static_argnums=(0, 1))
    eager = np.asarray(sc_j.search_shifts(TH, 40))
    want = np.asarray(compiled(TH, 40))
    assert list(np.nonzero(eager != want)[0]) == [17, 19]
    np.testing.assert_array_equal(np_(search_shifts(TH, 40)), want)
    # a constant: inside the reference's compile-time evaluation a jitted
    # call would run op by op, eagerly, again
    monkeypatch.setattr(sc_j, "search_shifts",
                        lambda th, n: want if (th, n) == (TH, 40) else None)


def _jax_scores(d, mo, region, mode, ww=100, s0=0):
    maps = ps.build_padded_maps(jnp.asarray(d["packed"]))
    scorer = cs_j.make_conv_scorer(mo, region, mode, window_w=ww)

    @jax.jit
    def run(p3, p4, sten, scan, cw, ctr, theta, alive):
        return scorer(p3, p4, maps.pad, sten, scan, cw, ctr, theta, F1,
                      alive, s0)

    out = run(maps.padded3d, maps.padded4d, *(jnp.asarray(d[k]) for k in (
        "stencil", "scan", "cw", "centers", "thetas", "alive")))
    return [np.asarray(x) for x in out]


def _port_scores(d, mo, region, mode, ww=100, s0=0):
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    scorer = cs.make_conv_scorer(mo, region, mode, window_w=ww)
    before = cs.CALLS["cost_field"]
    out = scorer(cs.ConvMap(crop_score.compact_map(t["packed"], C)), t["stencil"],
                 t["scan"], t["cw"], t["centers"], t["thetas"], F1,
                 t["alive"], s0)
    assert cs.CALLS["cost_field"] == before + 1
    return [np_(x) for x in out]


@pytest.mark.parametrize("mode,ww,s0", [
    ("tracked", 16, 95),   # the kf-split fold, a window across shift 0
    ("tracked", 32, 7),
    ("tracked", 100, 0),   # the full window: the combined fold
    ("init", 100, 0),
])
def test_conv_scorer_matches_jax(mode, ww, s0, compiled_search_shifts):
    d = _inputs(seed=1, band=0.3 if ww < 100 else None)
    mo = ps.pick_crop_size(F1, R, ps._MO_BUCKETS_CONV)
    assert mo == crop_score.pick_crop_size(
        F1, R, crop_score._MO_BUCKETS_CONV) == 24
    ref = _jax_scores(d, mo, 64, mode, ww, s0)
    got = _port_scores(d, mo, 64, mode, ww, s0)
    kf = ref[2]
    np.testing.assert_array_equal(got[2], kf)
    alive = d["alive"]
    assert 0 < (kf[alive] < 0.5).sum() < alive.sum()
    for i, name in ((0, "cost"), (1, "norm")):
        assert got[i].shape == ref[i].shape
        assert_rel(ref[i][alive], got[i][alive], 1e-4, name)


@pytest.mark.parametrize("mode", ["tracked", "init"])
def test_conv_scorer_matches_the_port_exact_step(mode):
    """The bounds of tests/test_conv_score.py::test_conv_*_matches_exact,
    against the port's exact gather on integer f and centres."""
    d = _inputs(seed=2, dead=0)
    d["centers"] = np.round(d["centers"])
    got = _port_scores(d, 24, 64, mode)
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    n = len(d["centers"])
    costs_e, kf_e = score_all_rotations(
        t["packed"], t["stencil"], t["scan"], t["cw"], t["centers"],
        torch.full((n,), 2.0), 0.5, num_classes=C, chunk_size=n,
    )
    costs_e = np_(costs_e)
    if mode == "tracked":
        s = np_(rotation_shift(t["thetas"], TH))
        ref = costs_e[np.arange(n), s]
        np.testing.assert_array_equal(got[2] < 0.5, np.isnan(ref))
    else:
        ref = costs_e[:, np_(search_shifts(TH, 40))]
    with np.errstate(divide="ignore", invalid="ignore"):
        cost = got[0] / got[1]
    m = ~np.isnan(ref)
    assert m.any() and not m.all()
    np.testing.assert_allclose(cost[m], ref[m], rtol=3e-3, atol=1e-5)
    np.testing.assert_allclose(got[2], np_(kf_e), atol=1e-5)


def test_region_origin_ignores_dead_particles():
    d = _inputs(seed=3, n=64, dead=0)
    a = _port_scores(d, 24, 64, "tracked")
    d["centers"][0] = (5.0, 5.0)  # a dead outlier must not move the region
    d["alive"][0] = False
    b = _port_scores(d, 24, 64, "tracked")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x[1:], y[1:])


def test_conv_kernel_sums_the_cells_of_each_tap():
    """Each tap holds the bf16 sum of its stencil cells' bf16
    coefficients; the kf channel counts the cells exactly."""
    d = _inputs(seed=4)
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    k = cs.build_conv_kernel(t["scan"], t["cw"], t["stencil"], F1, 24,
                             "tracked", window_w=16, s0=3)
    assert k.shape == (33, 4, 50, 50) and k.dtype == torch.float32
    assert torch.equal(k, k.to(torch.bfloat16).float())
    off = crop_score.crop_offsets(t["stencil"], F1).long() + 25
    counts = torch.zeros(50, 50).index_put_(
        (off[:, 0], off[:, 1]), torch.ones(TH * R), accumulate=True)
    assert torch.equal(k[32, C], counts)
    assert float(k[:, C + 1 :].abs().sum()) == 0.0
    assert float(k[:16, C].abs().sum()) == 0.0  # costs on the classes only


# -- the host plan --------------------------------------------------------
def _filters(world, **kw):
    """JAX and port filters with the same initial cloud on `world`."""
    params = dict(fixed_scale=2.0, regularization=0.02,
                  class_weights=[0.1, 1.5, 3.0])
    params.update(kw)
    mp = MapParams(map_path="", num_classes=3)
    tdm_j = TDMJ(mp)
    tdm_j.class_maps_binary = world
    tdm_j.grid = build_grid_j(world)
    tdm_j.have_map = True
    tdm_j.sample_pts_polar(100, 25)
    tdm_t = TopDownMap(mp, device="cpu", class_maps=world)
    tdm_t.sample_pts_polar(100, 25)
    pf_j = PFJ(512, tdm_j, FilterParams(**params), seed=3, use_fast=True)
    pf_t = ft.ParticleFilter(512, tdm_t, FilterParams(**params), seed=3)
    np.testing.assert_array_equal(
        pf_t.state.particles.init_px.numpy(),
        np.asarray(pf_j.state.particles.init_px))
    np.testing.assert_array_equal(pf_t.state.bbox.numpy(),
                                  np.asarray(pf_j.state.bbox))
    return pf_j, pf_t


def _set_smask(pf_j, pf_t, shifts):
    sm = np.zeros(TH, bool)
    sm[shifts] = True
    pf_j.state = pf_j.state.replace(smask=jnp.asarray(sm))
    pf_t.state = pf_t.state.replace(smask=torch.as_tensor(sm))


@pytest.mark.parametrize("case", ["narrow", "wraparound", "turn", "spread",
                                  "noise"])
def test_shift_window_matches_jax(case):
    """The four cases of tests/test_dispatch.py, and a long step's theta
    noise margin; propagate() accumulates the turn and the distance."""
    pf_j, pf_t = _filters(make_world())
    shifts = {"narrow": [10, 11, 12, 13], "wraparound": [97, 98, 99, 0, 1, 2],
              "turn": [50], "spread": list(range(0, 100, 3)),
              "noise": [30, 33]}[case]
    _set_smask(pf_j, pf_t, shifts)
    if case in ("turn", "noise"):
        trans, omega = ([0.5, 0.2], 0.6) if case == "turn" else ([6.0, 0], 0)
        for pf in (pf_j, pf_t):
            pf.propagate(trans, omega)
            pf.propagate(trans, omega)
        assert pf_t._last_omega == pf_j._last_omega
        assert pf_t._last_dist_m == pf_j._last_dist_m
    got = pf_t._shift_window()
    assert got == pf_j._shift_window()
    s0, ww = got
    covered = {(s0 + j) % TH for j in range(ww)}
    assert set(shifts) <= covered
    assert ww == {"narrow": 16, "wraparound": 16, "turn": 64, "spread": 100,
                  "noise": 64}[case]


@pytest.mark.parametrize("cloud,have_init", [
    ("tight", False), ("tight", True), ("tight", "mixed"),
    ("wide", True), ("small_map", True),
])
def test_fast_mode_plans_conv_as_jax(cloud, have_init, monkeypatch):
    """Clustered clouds: the conv branch's region, bucket and window, and
    where the region or the kernel does not fit, the crop plan; equal to
    JAX's plan field by field, from one packed host read."""
    if cloud == "small_map":  # 24 x 24 px of road: the padded map is 152
        world = np.ones((3, 24, 24), np.float32)
        world[1] = 0.0
        pf_j, pf_t = _filters(world, init_pos_px_x=12.0, init_pos_px_y=12.0,
                              init_pos_px_cov=4.0)
    else:
        theta = {"init_pos_deg_theta": 40.0} if have_init else {}
        pf_j, pf_t = _filters(
            make_world(), init_pos_px_x=128.0, init_pos_px_y=105.0,
            init_pos_px_cov=5.0 if cloud == "tight" else 150.0, **theta)
    if have_init == "mixed":
        have = np.arange(pf_t.n_max) % 2 == 0
        pf_j.state = pf_j.state.replace(particles=pf_j.state.particles.replace(
            have_init=jnp.asarray(have)))
        pf_t.state = pf_t.state.replace(particles=pf_t.state.particles.replace(
            have_init=torch.as_tensor(have)))
    elif have_init:
        _set_smask(pf_j, pf_t, [10, 11, 12])
    reads = []
    snapshot = ft._snapshot_vec
    monkeypatch.setattr(ft, "_snapshot_vec",
                        lambda st, *psum: reads.append(1)
                        or snapshot(st, *psum))
    paths = set()
    for res in (0.25, 0.5, 0.75, 1.0, 2.0):
        ref = pf_j._fast_mode(res)
        got = pf_t._fast_mode(res)
        assert isinstance(got, ft.FastDispatch)
        assert tuple(got) == tuple(ref), res
        paths.add(got.path)
        if got.path == "conv":
            dr, dc = cs.conv_dims(got.mo)
            g = pf_t.map.grid
            assert got.region + dr - 1 <= g.height + 2 * cs.MAP_PAD
            assert got.region + dc - 1 <= g.width + 2 * cs.MAP_PAD
    assert len(reads) == 1  # one packed read for every plan of this state
    want = {"tight": {"conv", "crop"}, "wide": {"crop"},
            "small_map": {"conv", "crop"}}[cloud]
    assert paths == want


# -- one whole step --------------------------------------------------------
@pytest.mark.parametrize("mode,s0,ww", [("tracked", 90, 16),
                                        ("tracked", 0, 100),
                                        ("init", 0, 100),
                                        ("mixed", 0, 100)])
def test_conv_step_matches_jax(mode, s0, ww, compiled_search_shifts):
    """One conv update of a clustered cloud (60 px, region 64) in both
    packages, with no motion and the reference's resample draw handed to
    the port."""
    st_j, d, params = _setups(mode != "init", cluster=True)
    n = st_j.particles.n_max
    if mode == "mixed":
        have = np.arange(n) % 3 == 0
        d["state"]["particles"]["have_init"][:] = have
        st_j = st_j.replace(particles=st_j.particles.replace(
            have_init=jnp.asarray(have)))
    res = 0.5  # f = 1: conv bucket 24
    step_j = fj.make_update_step_fast(
        params, 3, 1.0, TH, n, mode, mo=24, gmm_every=1, path="conv",
        region=64, window_w=ww)
    packed, mss, sten, scan = (d[k] for k in ("packed", "map_size",
                                              "stencil", "scan"))
    # the fused conv step splits the key for its propagate first
    shift_key = jax.random.split(st_j.key)[0]
    _, k_rs, _ = jax.random.split(shift_key, 3)
    shift = float(jax.random.uniform(k_rs))
    out_j = step_j(st_j, ps.build_padded_maps(jnp.asarray(packed)),
                   jnp.asarray(mss), jnp.asarray(sten), jnp.asarray(scan),
                   jnp.float32(res), s0=s0)

    step_t = ft.make_update_step_fast(
        params, 3, 1.0, TH, n, mode, gmm_every=1, path="conv", mo=24,
        region=64, window_w=ww)
    before = cs.CALLS["cost_field"]
    out_t = step_t(filter_state_from_numpy(d["state"]),
                   cs.ConvMap(crop_score.compact_map(torch.as_tensor(packed),
                                                     3)),
                   *(torch.as_tensor(a) for a in (mss, sten, scan)), res,
                   params.fixed_scale, s0, shift=shift)
    assert cs.CALLS["cost_field"] == before + (2 if mode == "mixed" else 1)
    _compare_states(out_j, out_t)
