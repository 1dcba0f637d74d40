"""Port parity of the filter pieces and of one whole update step, with
the reference's random draws (propagate noise, resample shift) computed
from its PRNG key and handed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from top_down_renderer_tpu.config import FilterParams
from top_down_renderer_tpu.core.grids import Particles as ParticlesJ
from top_down_renderer_tpu.filter import filter as fj
from top_down_renderer_tpu.filter import gmm as gmm_j
from top_down_renderer_tpu.filter import particles as part_j
from top_down_renderer_tpu.filter import resample as res_j
from top_down_renderer_tpu.filter import stats as stats_j
from top_down_renderer_torch.filter import crop_score as cs
from top_down_renderer_torch.filter import filter as ft
from top_down_renderer_torch.filter import gmm as gmm_t
from top_down_renderer_torch.filter import particles as part_t
from top_down_renderer_torch.filter import resample as res_t
from top_down_renderer_torch.filter import stats as stats_t
from top_down_renderer_torch.filter.resample import pack_fields
from top_down_renderer_torch.testing import synthetic_setup
from top_down_renderer_torch.utils.convert import (
    filter_state_from_numpy,
    filter_state_to_numpy,
    gmm_from_numpy,
    particles_from_numpy,
)

from torch_parity import assert_rel, np_, to_numpy_tree

torch.set_num_threads(2)


def _cloud(n=300, seed=0, clusters=3):
    """Numpy particle fields: a few clusters with varied thetas/scales,
    some dead slots at the end."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(20, 200, (clusters, 2))
    lab = rng.integers(0, clusters, n)
    pos = centers[lab] + rng.standard_normal((n, 2)) * 6
    alive = np.arange(n) < n - 20
    return {
        "init_px": pos.astype(np.float32),
        "d_m": (rng.standard_normal((n, 2)) * 0.5).astype(np.float32),
        "theta": rng.uniform(-4, 4, n).astype(np.float32),
        "scale": rng.uniform(1.5, 2.5, n).astype(np.float32),
        "have_init": rng.random(n) < 0.5,
        "weight": np.full(n, 1.0 / n, np.float32),
        "last_dist": rng.uniform(0, 0.3, n).astype(np.float32),
        "alive": alive,
    }


def _both(fields):
    pj = ParticlesJ(**{k: jnp.asarray(v) for k, v in fields.items()})
    return pj, particles_from_numpy(fields)


@pytest.mark.parametrize("frozen,dist", [(True, None), (False, None),
                                         (False, 2.5)])
def test_propagate_with_injected_noise(frozen, dist):
    pj, pt = _both(_cloud())
    params = FilterParams(pos_cov=0.3, theta_cov=0.05)
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(key, (pj.n_max, 4)))
    trans = np.array([1.5, -0.4], np.float32)
    kw_j = {} if dist is None else {"dist": jnp.float32(dist)}
    out_j = part_j.propagate(
        pj, key, jnp.asarray(trans), jnp.float32(0.1), params,
        jnp.asarray(frozen), **kw_j
    )
    out_t = part_t.propagate(
        pt, trans, 0.1, params, torch.tensor(frozen), dist=dist,
        noise=torch.as_tensor(noise),
    )
    for name in ("d_m", "theta", "scale", "last_dist"):
        assert_rel(np.asarray(getattr(out_j, name)),
                   np_(getattr(out_t, name)), 1e-5, name)


def test_propagate_draws_from_the_generator():
    _, pt = _both(_cloud())
    params = FilterParams()
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = part_t.propagate(pt, [1.0, 0.0], 0.0, params, False, generator=g1)
    b = part_t.propagate(pt, [1.0, 0.0], 0.0, params, False, generator=g2)
    np.testing.assert_array_equal(np_(a.d_m), np_(b.d_m))
    assert not np.array_equal(np_(a.d_m), np_(pt.d_m))


@pytest.mark.parametrize("fixed_scale,force", [(2.0, True), (-1.0, True),
                                               (2.0, False)])
def test_weight_from_cost(fixed_scale, force):
    fields = _cloud()
    fields["init_px"][:10] = [-5.0, 10.0]  # off the map
    fields["scale"][10:20] = 20.0  # outside the scale range
    pj, pt = _both(fields)
    rng = np.random.default_rng(1)
    cost = rng.uniform(0, 3, pj.n_max).astype(np.float32)
    cost[30:40] = np.nan
    params = FilterParams(fixed_scale=fixed_scale, force_on_map=force)
    mss = np.array([180.0, 190.0], np.float32)
    ref = fj.weight_from_cost(jnp.asarray(cost), pj, params, jnp.asarray(mss))
    got = ft.weight_from_cost(
        torch.as_tensor(cost), pt, params, torch.as_tensor(mss)
    )
    assert_rel(np.asarray(ref), np_(got), 1e-5)


@pytest.mark.parametrize("case", ["nan_repair", "all_nan", "zero_sum",
                                  "dead_slots"])
def test_postprocess_weights(case):
    rng = np.random.default_rng(2)
    n = 200
    w = rng.uniform(0.1, 2.0, n).astype(np.float32)
    alive = np.ones(n, bool)
    last = rng.uniform(0, 0.4, n).astype(np.float32)
    if case == "nan_repair":
        w[::7] = np.nan
    elif case == "all_nan":
        w[:] = np.nan
    elif case == "zero_sum":
        w[:] = 0.0
    else:
        alive[150:] = False
        w[160:170] = np.nan
    n_act = int(alive.sum())
    ref = fj.postprocess_weights(
        jnp.asarray(w), jnp.asarray(last), jnp.asarray(alive),
        jnp.int32(n_act),
    )
    got = ft.postprocess_weights(
        torch.as_tensor(w), torch.as_tensor(last), torch.as_tensor(alive),
        torch.tensor(n_act, dtype=torch.int32),
    )
    assert_rel(np.asarray(ref), np_(got), 1e-5)


def test_select_init_cost():
    rng = np.random.default_rng(3)
    c = rng.uniform(0, 5, (50, 40)).astype(np.float32)
    c[:5] = np.nan  # all-NaN rows -> (FLT_MAX, 0)
    c[5:10, ::2] = np.nan
    c[10, :] = c[10, 7]  # ties keep the first
    rb, rt = fj.select_init_cost(jnp.asarray(c), 40)
    gb, gt = ft.select_init_cost(torch.as_tensor(c), 40)
    np.testing.assert_array_equal(np_(gb), np.asarray(rb))
    assert_rel(np.asarray(rt), np_(gt), 1e-5)
    assert (np_(gb)[:5] == ft.FLT_MAX).all() and (np_(gt)[:5] == 0).all()


@pytest.mark.parametrize("seed,n_new,n_old", [(0, 300, 300), (1, 180, 280),
                                              (2, 300, 250)])
def test_systematic_indices_equal(seed, n_new, n_old):
    rng = np.random.default_rng(seed)
    w = rng.exponential(1.0, 300).astype(np.float32)
    w[n_old:] = 0.0
    w /= w.sum()
    for shift in (0.0, 0.37, 0.999):
        args = (n_new, n_old, shift)
        ref = res_j._systematic_indices(
            jnp.asarray(w), jnp.int32(n_new), jnp.int32(n_old),
            jnp.float32(shift),
        )
        got = res_t._systematic_indices(
            torch.as_tensor(w), torch.tensor(n_new), torch.tensor(n_old),
            torch.tensor(shift, dtype=torch.float32),
        )
        np.testing.assert_array_equal(np_(got), np.asarray(ref), str(args))


@pytest.mark.parametrize("n", [300, 1024, 1025, 5000])
def test_cumsum_fixed_order(n):
    """The resample's fixed-order scan is a cumsum: bit-equal to torch's
    within one row, float64-close across rows."""
    w = np.random.default_rng(n).exponential(1.0, n).astype(np.float32)
    w /= w.sum()
    got = res_t._cumsum_fixed_order(torch.as_tensor(w))
    assert got.shape == (n,) and got.dtype == torch.float32
    if n <= res_t._SCAN_ROW:
        assert torch.equal(got, torch.cumsum(torch.as_tensor(w), 0))
    np.testing.assert_allclose(
        np_(got), np.cumsum(w.astype(np.float64)), rtol=0, atol=1e-6
    )


@pytest.mark.parametrize("prev_k,clusters", [(1, 3), (3, 3), (8, 1)])
def test_compute_gmm_and_particle_count(prev_k, clusters):
    pj, pt = _both(_cloud(2000, seed=4, clusters=clusters))
    n_act = 1980
    ref = gmm_j.compute_gmm(
        pj, jnp.int32(n_act), jnp.int32(prev_k), jax.random.PRNGKey(0)
    )
    got = gmm_t.compute_gmm(
        pt, torch.tensor(n_act, dtype=torch.int32),
        torch.tensor(prev_k, dtype=torch.int32),
    )
    assert int(got.k) == int(ref.k)
    k = int(ref.k)
    assert_rel(np.asarray(ref.means)[:k], np_(got.means)[:k], 1e-3, "means")
    assert_rel(np.asarray(ref.covs)[:k], np_(got.covs)[:k], 1e-3, "covs")
    n_ref = gmm_j.adaptive_particle_count(ref, jnp.int32(n_act), 4000)
    n_got = gmm_t.adaptive_particle_count(
        gmm_from_numpy(to_numpy_tree(ref)), torch.tensor(n_act), 4000
    )
    assert int(n_got) == int(n_ref)


def test_pose_stats():
    pj, pt = _both(_cloud(seed=6))
    n_act = 280
    mj, cj = stats_j.pose_stats(pj, jnp.int32(n_act))
    mt, ct = stats_t.pose_stats(pt, torch.tensor(n_act))
    assert_rel(np.asarray(mj), np_(mt), 1e-5, "mean")
    assert_rel(np.asarray(cj), np_(ct), 1e-5, "cov")
    ml = np.array([100.0, 90.0, 0.3, 2.0], np.float32)
    assert_rel(
        np.asarray(stats_j.compute_cov(pj, jnp.asarray(ml), jnp.int32(n_act))),
        np_(stats_t.compute_cov(pt, torch.as_tensor(ml), torch.tensor(n_act))),
        1e-5, "cov about ml",
    )


# -- one whole step ------------------------------------------------------
N = 512
HW = 128


def _setups(have_init, cluster, integer=False):
    """The same synthetic state in both packages (the numpy twin must
    draw exactly the reference's numbers)."""
    kw = dict(h=HW, w=HW, seed=3,
              cluster=(30, 40, 60) if cluster else None)
    st_j, packed, mss, sten, scan, _res, params = ge._synthetic_setup(N, **kw)
    d = synthetic_setup(N, **kw)
    np.testing.assert_array_equal(d["packed"], np.asarray(packed))
    np.testing.assert_array_equal(d["scan"], np.asarray(scan))
    pos = d["state"]["particles"]["init_px"]
    np.testing.assert_array_equal(pos, np.asarray(st_j.particles.init_px))
    np.testing.assert_array_equal(
        d["state"]["bbox"], np.asarray(st_j.bbox)
    )
    if integer:
        pos[:] = np.round(pos)
    d["state"]["particles"]["have_init"][:] = have_init
    st_j = st_j.replace(
        particles=st_j.particles.replace(
            init_px=jnp.asarray(pos),
            have_init=jnp.full(N, have_init),
        )
    )
    return st_j, d, params


def _resample_shift(state_j):
    _, k_rs, _ = jax.random.split(state_j.key, 3)
    return float(jax.random.uniform(k_rs))


def _compare_states(out_j, out_t, rows_frac=0.99):
    assert int(out_t.n_active) == int(out_j.n_active)
    assert out_t.step == int(out_j.step)
    assert_rel(np.asarray(out_j.particles.weight),
               np_(out_t.particles.weight), 1e-4, "weights")
    np.testing.assert_array_equal(np_(out_t.ml_state),
                                  np.asarray(out_j.ml_state))
    rows_j = np.asarray(res_j.pack_fields(out_j.particles))
    rows_t = np_(pack_fields(out_t.particles))
    same = np.all(rows_j == rows_t, axis=1)
    assert same.mean() >= rows_frac, f"{same.mean():.3f} rows identical"
    np.testing.assert_array_equal(np_(out_t.particles.alive),
                                  np.asarray(out_j.particles.alive))
    np.testing.assert_array_equal(np_(out_t.smask), np.asarray(out_j.smask))


def _pre_resample_weights_j(st_j, packed, mss, sten, scan, res, params):
    """The reference step's weights before its resample, compiled as in
    the step (the shift tables round as in compiled code)."""

    @jax.jit
    def weights(st_j, packed, mss, sten, scan, res):
        p = st_j.particles
        costs, _ = fj.score_all_rotations(
            packed, sten, scan, fj._pad_class_weights(params, 3),
            p.pose_px(), p.scale, res, num_classes=3, chunk_size=N,
        )
        w_raw, new_theta, _ = fj.compute_weights(costs, p, params, mss, 100)
        return fj.postprocess_weights(
            w_raw, p.last_dist, p.alive, st_j.n_active
        ), new_theta

    w, theta = weights(st_j, packed, mss, sten, scan, res)
    return np.asarray(w), np.asarray(theta)


@pytest.mark.parametrize("have_init,cluster", [(True, False), (False, False),
                                               (True, True)])
def test_exact_step_matches_jax(have_init, cluster):
    st_j, d, params = _setups(have_init, cluster)
    packed, sten, scan = (jnp.asarray(d[k]) for k in
                          ("packed", "stencil", "scan"))
    mss = jnp.asarray(d["map_size"])
    res = jnp.float32(1.0)
    step_j = fj.make_update_step(params, 3, 1.0, 100, N, gmm_every=1,
                                 chunk_size=N)
    out_j = step_j(st_j, packed, mss, sten, scan, res)

    st_t = filter_state_from_numpy(d["state"])
    step_t = ft.make_update_step(params, 3, 1.0, 100, N, gmm_every=1,
                                 chunk_size=N)
    t = [torch.as_tensor(d[k]) for k in ("packed", "map_size", "stencil",
                                         "scan")]
    out_t = step_t(st_t, t[0], t[1], t[2], t[3], 1.0,
                   shift=_resample_shift(st_j))
    _compare_states(out_j, out_t)
    assert_rel(np.asarray(out_j.gmm.means)[: int(out_j.gmm.k)],
               np_(out_t.gmm.means)[: int(out_t.gmm.k)], 1e-3, "gmm")

    # the weights the resample consumed
    w_j, theta_j = _pre_resample_weights_j(st_j, packed, mss, sten, scan,
                                           res, params)
    p = st_t.particles
    costs, _ = ft.score_all_rotations(
        t[0], t[2], t[3], torch.ones(3), p.pose_px(), p.scale, 1.0, 3,
    )
    w_raw, theta_t, _ = ft.compute_weights(costs, p, params, t[1], 100)
    w_t = ft.postprocess_weights(w_raw, p.last_dist, p.alive, st_t.n_active)
    assert_rel(w_j, np_(w_t), 1e-4, "pre-resample weights")
    assert_rel(theta_j, np_(theta_t), 1e-6, "theta")


@pytest.mark.parametrize("mode", ["tracked", "init", "mixed"])
def test_crop_step_on_integer_centres_matches_jax_exact(mode):
    """The crop step samples exactly the exact path's pixels on integer,
    noise-free centres, so it is held to the JAX exact step."""
    st_j, d, params = _setups(mode != "init", cluster=False, integer=True)
    if mode == "mixed":
        have = np.arange(N) % 3 == 0
        d["state"]["particles"]["have_init"][:] = have
        st_j = st_j.replace(particles=st_j.particles.replace(
            have_init=jnp.asarray(have)))
    res = 0.5  # f = scale * res = 1.0: the reference's crop bucket 24
    step_j = fj.make_update_step(params, 3, 1.0, 100, N, gmm_every=1,
                                 chunk_size=N)
    out_j = step_j(st_j, *(jnp.asarray(d[k]) for k in
                           ("packed", "map_size", "stencil", "scan")),
                   jnp.float32(res))
    st_t = filter_state_from_numpy(d["state"])
    step_t = ft.make_update_step_fast(params, 3, 1.0, 100, N, mode,
                                      gmm_every=1)
    maps, *rest = (torch.as_tensor(d[k]) for k in
                   ("packed", "map_size", "stencil", "scan"))
    out_t = step_t(st_t, cs.CropMap(maps), *rest, res,
                   shift=_resample_shift(st_j))
    _compare_states(out_j, out_t)


def test_state_round_trip():
    st_j, d, _ = _setups(True, True)
    tree = to_numpy_tree(st_j)
    back = filter_state_to_numpy(filter_state_from_numpy(tree))
    for k in ("n_active", "frozen_scale", "ml_state", "bbox", "smask"):
        np.testing.assert_array_equal(back[k], tree[k], k)
    for k, v in tree["particles"].items():
        np.testing.assert_array_equal(back["particles"][k], v, k)
    for k, v in tree["gmm"].items():
        np.testing.assert_array_equal(back["gmm"][k], v, k)
    assert back["step"] == int(tree["step"])


@pytest.mark.parametrize("mode,mip", [("tracked", 1), ("init", 1),
                                      ("mixed", 2)])
def test_crop_step_with_host_scale_equals_the_card_scale(mode, mip):
    """Given the dispatch's host scale, the crop step computes f in the
    same float32 steps as from particle 0's scale on the card, so the
    step's result is the same bit for bit."""
    _, d, params = _setups(mode != "init", cluster=False, integer=True)
    if mode == "mixed":
        d["state"]["particles"]["have_init"][:] = np.arange(N) % 3 == 0
    step_t = ft.make_update_step_fast(params, 3, 1.0, 100, N, mode,
                                      gmm_every=1, mip=mip)
    packed, *rest = (torch.as_tensor(d[k]) for k in
                     ("packed", "map_size", "stencil", "scan"))
    maps = cs.CropMap(cs.mip_map(packed, mip))
    outs = [filter_state_to_numpy(step_t(
        filter_state_from_numpy(d["state"]), maps, *rest, 0.5, *scale,
        shift=0.25)) for scale in ((), (params.fixed_scale,))]
    for k, v in outs[0]["particles"].items():
        np.testing.assert_array_equal(outs[1]["particles"][k], v, k)
    for k in ("n_active", "ml_state", "bbox", "smask"):
        np.testing.assert_array_equal(outs[1][k], outs[0][k], k)


# -- the ParticleFilter's snapshot, publish queries, reinit and warmup ----
def _filters(fixed_scale=2.0, n=512, hw=128, seed=0):
    """A reference and a port ParticleFilter on the same world (their
    initial clouds are the same numpy draws)."""
    from top_down_renderer_tpu.config import MapParams as MapParamsJ
    from top_down_renderer_tpu.maps import map as map_j
    from top_down_renderer_torch import FilterParams as FilterParamsT
    from top_down_renderer_torch import MapParams as MapParamsT
    from top_down_renderer_torch.maps import map as map_t
    from util_synthetic import make_world

    world = make_world(hw, hw)
    tdm_j = map_j.TopDownMap(MapParamsJ(map_path="", num_classes=3))
    tdm_j.class_maps_binary = world
    tdm_j.grid = map_j.build_grid(world)
    tdm_j.have_map = True
    tdm_t = map_t.TopDownMap(MapParamsT(map_path="", num_classes=3),
                             device="cpu", class_maps=world)
    kw = dict(pos_cov=0.1, regularization=0.02, fixed_scale=fixed_scale,
              class_weights=[0.1, 1.5, 3.0], force_on_map=True)
    for tdm in (tdm_j, tdm_t):
        tdm.sample_pts_polar(100, 25)
    pf_j = fj.ParticleFilter(n, tdm_j, FilterParams(**kw), seed=seed,
                             chunk_size=256)
    pf_t = ft.ParticleFilter(n, tdm_t, FilterParamsT(**kw), seed=seed,
                             chunk_size=256)
    np.testing.assert_array_equal(np_(pf_t.state.particles.init_px),
                                  np.asarray(pf_j.state.particles.init_px))
    return pf_j, pf_t, world


def _carry(pf_j, pf_t, edit):
    """Edit the reference's state in numpy and give both filters the
    result (filter_state_from_numpy on the port's side)."""
    tree = to_numpy_tree(pf_j.state)
    tree["particles"] = {k: np.array(v) for k, v in tree["particles"].items()}
    edit(tree["particles"], np.random.default_rng(4))
    pj = pf_j.state.particles
    pf_j.state = pf_j.state.replace(particles=pj.replace(**{
        k: jnp.asarray(v) for k, v in tree["particles"].items()}))
    pf_t.state = filter_state_from_numpy(tree, "cpu")
    pf_t._all_have_init = pf_j._all_have_init = bool(
        tree["particles"]["have_init"][tree["particles"]["alive"]].all())


def _spread(p, rng):
    """Dead rows, some displacement, thetas, half the cloud with one."""
    n = len(p["alive"])
    p["alive"][rng.random(n) < 0.2] = False
    p["d_m"][:] = rng.standard_normal((n, 2)).astype(np.float32)
    p["theta"][:] = rng.uniform(-3, 3, n).astype(np.float32)
    p["have_init"][:] = rng.random(n) < 0.5


def test_reinitialize_fraction_equals_reference():
    """Bit-equal to the reference's for the same state and seed: which
    rows are redrawn, their positions, thetas, displacements and
    have_init, the bounding box and the all-ones shift mask."""
    pf_j, pf_t, _ = _filters()
    _carry(pf_j, pf_t, _spread)
    for frac, seed in ((0.3, 11), (0.05, None)):
        pf_j.reinitialize_fraction(frac, seed=seed)
        pf_t.reinitialize_fraction(frac, seed=seed)
        tj, tt = to_numpy_tree(pf_j.state), filter_state_to_numpy(pf_t.state)
        for k in ("init_px", "d_m", "theta", "have_init", "alive", "scale"):
            np.testing.assert_array_equal(tt["particles"][k],
                                          tj["particles"][k], k)
        np.testing.assert_array_equal(tt["bbox"], tj["bbox"])
        np.testing.assert_array_equal(tt["smask"], tj["smask"])
        assert not pf_t._all_have_init and pf_t._crop_mode() == "mixed"
    before = pf_t.state
    pf_t.reinitialize_fraction(0.0)
    assert pf_t.state is before


def test_compute_cov_and_publish_stats_equal_reference():
    """compute_cov (about the max-likelihood state) and publish_stats
    (mean likelihood, mean covariance, n_active from the snapshot) equal
    the reference's within rel 1e-5 on one state."""
    pf_j, pf_t, _ = _filters(fixed_scale=-1.0)
    _carry(pf_j, pf_t, _spread)
    ml = np.asarray(pf_j.state.particles.ml_state())[7]
    pf_j.state = pf_j.state.replace(ml_state=jnp.asarray(ml))
    pf_t.state = pf_t.state.replace(ml_state=torch.tensor(ml))
    ref, got = pf_j.compute_cov(), pf_t.compute_cov()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    for block in (True, False):
        sj, st = pf_j.publish_stats(block=True), pf_t.publish_stats(block)
        for a, b in zip(st[:2], sj[:2]):
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * np.abs(b).max())
        assert st[2] == sj[2]
    np.testing.assert_array_equal(pf_t.pose_stats()[0], st[0])
    assert pf_t.is_scale_frozen is False and pf_j.is_scale_frozen is False


def test_publish_stats_block_and_nowait():
    """As the reference's test_async_publish_uses_completed_snapshot: no
    snapshot before the first read; blocking reads give the current
    state's values; nowait gives the freshest snapshot on the host, which
    on the CPU (a synchronous copy) is the update's own, and after a
    state no update made (reinitialize_fraction) the last one read."""
    _, pf, _ = _filters(fixed_scale=1.0, n=64)
    assert pf.publish_stats(block=False) is None
    assert pf.pose_stats_nowait() is None
    pre = pf.publish_stats(block=True)
    scan = np.random.default_rng(21).random((3, 100, 25)).astype(np.float32)
    pf.update(scan, 1.0)
    post = pf.publish_stats(block=False)
    assert not np.allclose(post[0], pre[0])
    for a, b in zip(post, pf.publish_stats(block=True)):
        np.testing.assert_array_equal(a, b)
    ml, cov = stats_t.pose_stats(pf.state.particles, pf.state.n_active)
    np.testing.assert_array_equal(post[0], np_(ml).astype(np.float64))
    np.testing.assert_array_equal(post[1], np_(cov).astype(np.float64))
    pf.reinitialize_fraction(0.5, seed=3)
    stale = pf.publish_stats(block=False)
    np.testing.assert_array_equal(stale[0], post[0])
    fresh = pf.publish_stats(block=True)
    assert not np.allclose(fresh[0], post[0])
    np.testing.assert_array_equal(pf.pose_stats_nowait()[0], fresh[0])


def test_one_snapshot_copy_per_update():
    """Every update starts one snapshot copy; n_active_host, the dispatch,
    pose_stats and publish_stats read it and make none of their own: one
    update plus one publish is one copy."""
    _, pf, _ = _filters(fixed_scale=2.0, n=256)
    rng = np.random.default_rng(2)
    pf.publish_stats()
    copies = pf.snapshot_copies
    assert copies == 1
    for i in range(4):
        pf.propagate(np.array([1.0, 0.0], np.float32), 0.05)
        pf.update(rng.random((3, 100, 25)).astype(np.float32), 1.0)
        assert pf.snapshot_copies == copies + 1
        assert pf.n_active_host() == int(pf.state.n_active)
        pf.pose_stats()
        pf.publish_stats(block=True)
        pf.publish_stats(block=False)
        assert pf.snapshot_copies == copies + 1
        copies += 1
    assert pf.snapshot_reads == 0  # no copy from a card to wait for


def _cache_keys(pf):
    maps = {k: (sorted(v._compact), v._fold) if isinstance(v, cs.CropMap)
            else v for k, v in pf._maps_cache.items()}
    return (sorted(pf._fast_fns, key=repr), sorted(pf._pyramid_cache),
            sorted(maps, key=repr),
            {k: (v[0], None if v[1] is None else (v[1][0], v[1][1]))
             for k, v in maps.items() if isinstance(v, tuple)})


@pytest.mark.parametrize("fixed_scale,res", [(2.0, 1.0), (2.0, 4.0),
                                             (-1.0, 1.0)])
def test_warmup_leaves_nothing_for_the_first_update_to_build(fixed_scale,
                                                             res):
    """After warmup(res) the first update adds no step function and no
    map cache entry (CropMap, its compact map and stencil fold, ConvMap,
    pyramid), and warmup changed neither the state nor the draws."""
    _, pf, _ = _filters(fixed_scale=fixed_scale, n=512)
    state, gen = pf.state, pf.generator.get_state()
    pf.warmup(res)
    assert pf.state is state
    assert torch.equal(pf.generator.get_state(), gen)
    keys = _cache_keys(pf)
    assert keys[0], "warmup made no step function"
    folds = {k: v._fold for k, v in pf._maps_cache.items()
             if isinstance(v, cs.CropMap)}
    pf.update(np.random.default_rng(0).random((3, 100, 25)).astype(
        np.float32), res)
    assert _cache_keys(pf) == keys
    for k, fold in folds.items():
        assert pf._maps_cache[k]._fold is fold, k
