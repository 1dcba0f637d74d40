"""The port's slice through its public entry points: the consumer drive
(TopDownMap -> ParticleFilter -> render_semantic_polar -> propagate /
update -> mean_likelihood / compute_mean_cov) on the CPU, where the crop
steps run their plain versions, at a known and at an unknown scale, and
the host dispatch against the JAX ParticleFilter's."""

import logging

import numpy as np
import pytest
import torch

from top_down_renderer_tpu.config import FilterParams, MapParams
from top_down_renderer_tpu.filter.filter import ParticleFilter as PFJ
from top_down_renderer_tpu.maps.map import TopDownMap as TDMJ
from top_down_renderer_tpu.maps.map import build_grid as build_grid_j
from top_down_renderer_torch import kernels
from top_down_renderer_torch.filter import conv_score, crop_score
from top_down_renderer_torch.filter import multiscale as ms
from top_down_renderer_torch.filter.filter import ParticleFilter
from top_down_renderer_torch.maps.map import TopDownMap

from drive_consumer_torch import SCALE_GT, drive, drive_unknown_scale
from util_synthetic import make_world

torch.set_num_threads(2)


def test_consumer_drive_converges_on_crop_mip2(monkeypatch):
    """2048 particles, fixed scale 2, res 1 -> f = 2: the spread cloud's
    theta search on the crop path at mip 2, then, once the alive box fits
    a conv region, the conv cost field at full resolution (conv bucket mo
    48), as the reference's dispatch plans it; every update runs the path
    its plan names (plain versions on the CPU, no kernel launch)."""
    calls = {"tracked": 0, "init": 0}
    dispatch = []
    for name, flavour in (("score_tracked_plain", "tracked"),
                          ("score_init_sel_plain", "init")):
        orig = getattr(crop_score, name)

        def counted(*a, _orig=orig, _flavour=flavour, **kw):
            calls[_flavour] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(crop_score, name, counted)
    orig_mode = ParticleFilter._fast_mode

    def recorded(self, res):
        out = orig_mode(self, res)
        dispatch.append(out)
        return out

    monkeypatch.setattr(ParticleFilter, "_fast_mode", recorded)
    seen = []

    def on_step(i, pf):
        seen.append((dict(calls), conv_score.CALLS["cost_field"]))

    steps = 30
    prev = ({"tracked": 0, "init": 0}, conv_score.CALLS["cost_field"])
    err, cov_xx, err_swap = drive(
        "cpu", 2048, steps, res=1.0, swap_steps=6, on_step=on_step,
        log=lambda *_: None,
    )
    assert err < 8.0 and cov_xx < 400.0, (err, cov_xx)
    assert err_swap < 10.0, err_swap
    assert len(dispatch) == steps + 6
    assert dispatch[0][:4] == ("init", 24, 2.0, "crop")
    assert dispatch[0].mip == 2
    first_conv = [d.path for d in dispatch].index("conv")
    assert 1 <= first_conv <= 5, [d.path for d in dispatch]
    for d in dispatch[1:first_conv]:
        assert (d.mode, d.mo, d.path, d.mip) == ("tracked", 24, "crop", 2)
    for d in dispatch[first_conv:]:
        assert (d.mode, d.mo, d.path, d.mip) == ("tracked", 48, "conv", 1)
        assert d.region in conv_score.REGION_BUCKETS
        assert d.ww in (16, 32, 64, 100)
    assert dispatch[-1].region == 64 and dispatch[-1].ww <= 32
    # each update ran the scorer its plan names, once
    for d, now in zip(dispatch, seen):
        assert now[1] - prev[1] == (d.path == "conv")
        assert now[0]["tracked"] - prev[0]["tracked"] == (
            d.path == "crop" and d.mode == "tracked")
        assert now[0]["init"] - prev[0]["init"] == (d.mode == "init")
        prev = now
    assert sum(kernels.LAUNCHES.values()) == 0


def _pair(scale, have_init):
    """JAX and port filters on one 384^2 world whose road spans more than
    the largest conv region, so a fresh cloud is spread."""
    world = make_world(384, 384)
    kw = dict(
        fixed_scale=scale, regularization=0.02, force_on_map=True,
        class_weights=[0.1, 1.5, 3.0],
    )
    if have_init:
        kw.update(init_pos_deg_theta=40.0)
    mp = MapParams(map_path="", num_classes=3)
    tdm_j = TDMJ(mp)
    tdm_j.class_maps_binary = world
    tdm_j.grid = build_grid_j(world)
    tdm_j.have_map = True
    tdm_j.sample_pts_polar(100, 25)
    tdm_t = TopDownMap(mp, device="cpu", class_maps=world)
    tdm_t.sample_pts_polar(100, 25)
    pf_j = PFJ(1024, tdm_j, FilterParams(**kw), seed=1, use_fast=True)
    pf_t = ParticleFilter(1024, tdm_t, FilterParams(**kw), seed=1)
    return pf_j, pf_t


@pytest.mark.parametrize("have_init", [False, True, "mixed"])
def test_fast_mode_matches_jax_on_spread_clouds(have_init):
    pf_j, pf_t = _pair(2.0, have_init is True)
    np.testing.assert_array_equal(
        pf_t.state.particles.init_px.numpy(),
        np.asarray(pf_j.state.particles.init_px),
    )
    if have_init == "mixed":
        have = np.arange(pf_t.n_max) % 2 == 0
        pf_j.state = pf_j.state.replace(particles=pf_j.state.particles.replace(
            have_init=np.asarray(have)))
        pf_t.state = pf_t.state.replace(particles=pf_t.state.particles.replace(
            have_init=torch.as_tensor(have)))
    for res in (0.25, 0.5, 1.0, 2.0, 4.0, 40.0):
        fj = pf_j._fast_mode(res)
        ft = pf_t._fast_mode(res)
        if fj is None:
            assert ft is None, res
            continue
        assert fj[3] == "crop", (res, fj)  # spread: no conv region
        assert tuple(ft) == tuple(fj), res


def test_unknown_scale_runs_the_multi_path_and_logs_nothing(caplog,
                                                            monkeypatch):
    """Under an unknown scale every update goes through the K-bucket
    scorers (plain versions on the CPU): theta search first, tracked
    after; the exact step never runs and nothing is logged."""
    world = make_world(128, 128)
    tdm = TopDownMap(MapParams(map_path="", num_classes=3), device="cpu",
                     class_maps=world)
    tdm.sample_pts_polar(100, 25)
    pf = ParticleFilter(
        200, tdm, FilterParams(fixed_scale=-1.0, regularization=0.02), seed=0
    )
    assert pf.num_particles() == 200
    calls = []
    for name in ("score_tracked_multi_plain", "score_init_multi_sel_plain"):
        orig = getattr(ms, name)

        def counted(*a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(*a, **kw)

        monkeypatch.setattr(ms, name, counted)

    def no_exact(*a, **kw):
        raise AssertionError("the exact step ran")

    pf._update_fn = no_exact
    scan = torch.rand((3, 100, 25), generator=torch.Generator().manual_seed(0))
    with caplog.at_level(logging.WARNING):
        for _ in range(2):
            pf.propagate([1.0, 0.0], 0.05)
            pf.update(scan, 0.5)
    assert not caplog.records, [r.getMessage() for r in caplog.records]
    assert calls == ["score_init_multi_sel_plain", "score_tracked_multi_plain"]
    assert pf.state.step == 2 and pf.scale() == -1.0
    ml = pf.mean_likelihood()
    assert np.all(np.isfinite(ml)) and ml.shape == (4,)
    pf.freeze_scale()
    assert pf.scale() > 0 and pf._fast_mode(0.5) is not None
    means, covs = pf.get_gmm()
    assert means.shape[1] == 3 and covs.shape[1:] == (3, 3)


def test_unknown_scale_drive_finds_the_scale():
    """The port's counterpart of tests/test_scale_estimation.py, with its
    assertions: 2048 particles from the 10 scale hypotheses, 30 scans,
    the node's freeze trigger applied by the caller."""
    ml, cov, pf = drive_unknown_scale("cpu")
    assert abs(ml[3] - SCALE_GT) / SCALE_GT < 0.1, ml[3]
    assert cov[3, 3] < 0.1
    if pf.scale() > 0:
        assert abs(pf.scale() - SCALE_GT) / SCALE_GT < 0.1
        s = pf.state.particles.scale.numpy()
        assert np.allclose(s, s[0])


def test_filter_queries_and_dynamic_map():
    world = make_world(128, 128)
    mp = MapParams(map_path="", num_classes=3)
    # no map yet: the filter waits for update_map
    tdm = TopDownMap(mp, device="cpu")
    pf = ParticleFilter(256, tdm, FilterParams(fixed_scale=2.0), seed=0)
    assert pf.state is None and pf.num_particles() == 0
    ind = np.zeros(world.shape[1:], np.uint8)
    ind[world[1] == 0] = 1
    ind[world[2] == 0] = 2
    pf.update_map(ind[::-1], (0, 0))
    assert pf.num_particles() == 256
    before = pf.state.particles.init_px.clone()
    pf.update_map(np.roll(ind, (3, 5), (0, 1))[::-1], (5, 3))
    np.testing.assert_allclose(
        (pf.state.particles.init_px - before).numpy(),
        np.broadcast_to([5.0, 3.0], before.shape), atol=1e-4,
    )
    ml, cov = pf.pose_stats()
    np.testing.assert_allclose(ml, pf.mean_likelihood(), rtol=1e-6)
    np.testing.assert_allclose(cov, pf.compute_mean_cov(), rtol=1e-5)
    assert pf.max_likelihood().shape == (4,)
    assert pf.scale() == 2.0
