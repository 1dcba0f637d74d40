"""The port's multi-device filter (top_down_renderer_torch/parallel/,
ParticleFilter(mesh=...)) on two CPU ranks over gloo, against the
reference's mesh (make_mesh(2) over tests/conftest.py's virtual CPU
devices, its crop kernel interpreted as tests/test_sharding.py runs it)
and against the port on one device.

The ranks run tests/torch_mesh_ranks.py's scenarios, started by
tests/spawn_ranks.py's run_ranks with a FileStore rendezvous under the
test's temporary directory and a join timeout of their own: a hung rank
fails its test, not the suite.  They run while the reference does.  The
same seeds build the same inputs on every rank, in the reference and in
the single-device port; the reference's resample shifts are fed to the
port where a result depends on them."""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as scen
from spawn_ranks import run_ranks
from top_down_renderer_torch.config import FilterParams, MapParams
from top_down_renderer_torch.filter import conv_score
from top_down_renderer_torch.filter.filter import ParticleFilter
from top_down_renderer_torch.maps.map import TopDownMap
from top_down_renderer_torch.parallel import make_mesh

RTOL, ATOL = 1e-4, 1e-5  # tests/test_sharding.py's max_likelihood bounds
JOIN_S = 120.0

torch.set_num_threads(2)


def _ranks(tmp_path_factory, target, *args, world=2):
    """Start `world` ranks of torch_mesh_ranks.<target>(rank, world,
    *args); returns the future of their results."""
    work = tmp_path_factory.mktemp(target)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(run_ranks, getattr(scen, target), world, work,
                         args=args, timeout=JOIN_S)
    pool.shutdown(wait=False)
    return future


def _jax_mesh(n=2):
    if jax.device_count() < n:
        pytest.skip(f"needs {n} virtual devices")
    from top_down_renderer_tpu.parallel.sharding import make_mesh as mesh_j

    return mesh_j(n)


def _keys(fns) -> list:
    return sorted(fns, key=repr)


# -- (a) the sharded exact step ------------------------------------------
@pytest.fixture(scope="module")
def exact(tmp_path_factory):
    """The reference's sharded exact step (zero motion) and the port's on
    two ranks and on one device, fed the reference's resample shift."""
    import __graft_entry__ as ge
    from top_down_renderer_tpu.parallel.sharding import (
        make_sharded_step,
        shard_filter_state,
    )

    mesh = _jax_mesh()
    n = 512
    state, packed, map_size, stencil, scan, res, params = (
        ge._synthetic_setup(n, h=64, w=64, seed=3))
    # the step's draw: key, k_prop, k_rs, k_gmm = split(state.key, 4)
    shift = float(jax.random.uniform(jax.random.split(state.key, 4)[2]))
    ranks = _ranks(tmp_path_factory, "exact_step_rank", shift)
    step = make_sharded_step(mesh, params, num_classes=3, map_resolution=1.0,
                             theta_bins=100, n_max=n, chunk_size=128)
    out_j = step(shard_filter_state(state, mesh), packed, map_size, stencil,
                 scan, res, jnp.zeros(5, jnp.float32))
    return out_j, ranks.result(), scen.exact_step(None, shift)


def test_sharded_exact_step_matches_jax(exact):
    out_j, ranks, _ = exact
    got = ranks[0]
    assert abs(got["weight"].sum() - 1.0) < 1e-4
    n_active = got["n_active"]
    assert n_active == int(out_j.n_active)
    assert got["alive"][:n_active].all() and not got["alive"][n_active:].any()
    # every resampled row comes from the original set
    as_rows = lambda a: a.round(4).view([("x", "f4"), ("y", "f4")])  # noqa
    assert np.isin(as_rows(got["init_px"][got["alive"]]),
                   as_rows(got["src"])).all()
    np.testing.assert_allclose(got["ml"], np.asarray(out_j.ml_state),
                               rtol=RTOL)
    np.testing.assert_array_equal(got["smask"], np.asarray(out_j.smask))
    same = np.all(got["init_px"] == np.asarray(out_j.particles.init_px), 1)
    assert same.mean() >= 0.99, f"{same.mean():.3f} rows identical"


def test_sharded_exact_step_matches_one_device(exact):
    _, ranks, single = exact
    for got in ranks:
        for k in ("ml", "smask", "bbox", "alive"):
            np.testing.assert_array_equal(got[k], single[k], err_msg=k)
        assert got["n_active"] == single["n_active"]
        np.testing.assert_allclose(got["weight"], single["weight"],
                                   rtol=RTOL, atol=1e-9)
        np.testing.assert_array_equal(got["init_px"], single["init_px"])


# -- (b) ParticleFilter(mesh=...) under an unknown scale -----------------
@pytest.fixture(scope="module")
def unknown(tmp_path_factory):
    """tests/test_sharding.py's multi case on the reference's mesh (crop
    kernel interpreted, small tiles), its resample shifts recorded, and the
    port's on two ranks and on one device fed those shifts."""
    from test_sharding import _mini_world_pf_unknown_scale
    from top_down_renderer_tpu.filter import pallas_score as ps

    mesh = _jax_mesh()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ps, "init_p_tile", lambda mo, **kw: 16)
        mp.setattr(ps, "tracked_p_tile", lambda mo, **kw: 16)
        pf_j = _mini_world_pf_unknown_scale(mesh=mesh, seed=11)
        # each mesh multi step draws key, k_rs, k_gmm = split(key, 3)
        key, shifts = pf_j.state.key, []
        for _ in range(2):
            key, k_rs, _ = jax.random.split(key, 3)
            shifts.append(float(jax.random.uniform(k_rs)))
        ranks = _ranks(tmp_path_factory, "unknown_scale_rank", 11, shifts)
        rng = np.random.default_rng(5)
        mls = []
        for shift in shifts:
            scan = jnp.asarray(rng.random((3, 100, 25)).astype(np.float32))
            k_rs = jax.random.split(pf_j.state.key, 3)[1]
            assert float(jax.random.uniform(k_rs)) == shift
            pf_j.update(scan, 1.0)
            mls.append(pf_j.max_likelihood())
    ref = {"ml": np.stack(mls), "keys": _keys(pf_j._sharded_fns),
           "n_active": int(pf_j.state.n_active)}
    return ref, ranks.result(), scen.unknown_scale(None, 11, shifts)


def test_mesh_multi_path_matches_jax(unknown):
    """The init then tracked K-bucket steps on the mesh: the reference's
    dispatch keys, and its max_likelihood after each update."""
    ref, ranks, _ = unknown
    assert [k[:2] for k in ref["keys"]] == [("multi", "init"),
                                            ("multi", "tracked")]
    for got in ranks:
        assert got["keys"] == ref["keys"]
        np.testing.assert_allclose(got["ml"], ref["ml"], rtol=RTOL,
                                   atol=ATOL)
        assert got["n_active"] == ref["n_active"]


def test_mesh_multi_path_matches_one_device(unknown):
    _, ranks, single = unknown
    assert single["keys"] == []  # one device: no sharded step
    for got in ranks:
        np.testing.assert_allclose(got["ml"], single["ml"], rtol=RTOL,
                                   atol=ATOL)
        assert got["n_active"] == single["n_active"]
        np.testing.assert_array_equal(got["alive"], single["alive"])
        np.testing.assert_allclose(got["mean"], single["mean"], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got["cov"], single["cov"], rtol=1e-3,
                                   atol=1e-3)
        np.testing.assert_allclose(got["frozen"], single["frozen"],
                                   rtol=1e-6)


# -- (c) the row-sharded conv step ---------------------------------------
@pytest.fixture(scope="module", params=[("s2d", 2), ("direct", 3)],
                ids=lambda v: v[0])
def conv(request, tmp_path_factory):
    """tests/test_sharding.py's conv cases: the reference's mesh takes its
    s2d fold, or (K4_MAX_BYTES = 0) its direct conv; the port runs its
    direct conv on both, planned under the reference's key."""
    from test_sharding import _mini_world_pf
    from top_down_renderer_tpu.filter import conv_score as cs_j

    branch, scan_seed = request.param
    direct = branch == "direct"
    mesh = _jax_mesh()
    ranks = _ranks(tmp_path_factory, "conv_rank", 7, direct, scan_seed)
    with pytest.MonkeyPatch.context() as mp:
        if branch == "direct":
            mp.setattr(cs_j, "K4_MAX_BYTES", 0)
        pf_j = _mini_world_pf(mesh=mesh, seed=7)
        scan = np.random.default_rng(scan_seed).random((3, 100, 25))
        pf_j.propagate(np.array([1.0, 0.0], np.float32), 0.0)
        pf_j.update(jnp.asarray(scan.astype(np.float32)), 1.0)
    ref = {"ml": pf_j.max_likelihood()[None], "keys": _keys(pf_j._sharded_fns)}
    return branch, ref, ranks.result(), scen.conv(None, 7, direct, scan_seed)


def test_mesh_conv_path_matches_jax(conv):
    branch, ref, ranks, _ = conv
    assert len(ref["keys"]) == 1
    assert ref["keys"][0][4] is (branch == "s2d")
    for got in ranks:
        assert got["keys"] == ref["keys"]
        np.testing.assert_allclose(got["ml"], ref["ml"], rtol=RTOL,
                                   atol=ATOL)
        assert abs(got["weight"].sum() - 1.0) < 1e-4
        n = got["n_active"]
        assert got["alive"][:n].all() and not got["alive"][n:].any()


def test_mesh_conv_path_matches_one_device(conv):
    _, _, ranks, single = conv
    # the scenario put the s2d gate back after its run
    assert conv_score.K4_MAX_BYTES == 256 * 2**20
    assert [p[3] for p in single["plans"]] == ["conv"]
    for got in ranks:
        np.testing.assert_allclose(got["ml"], single["ml"], rtol=RTOL,
                                   atol=ATOL)
        assert got["n_active"] == single["n_active"]
        np.testing.assert_allclose(got["weight"], single["weight"],
                                   rtol=RTOL, atol=1e-9)


def test_mesh_direct_conv_on_uneven_rows_runs_the_exact_step(
        tmp_path_factory, monkeypatch):
    """Three ranks, the reference's s2d gate closed: the region's rows do
    not split over the mesh, so the reference's mesh runs its sharded
    exact step, and so does the port's (no sharded fast step), on n_max
    padded from 64 to 66."""
    from test_sharding import _mini_world_pf
    from top_down_renderer_tpu.filter import conv_score as cs_j

    monkeypatch.setattr(cs_j, "K4_MAX_BYTES", 0)
    mesh = _jax_mesh(3)
    ranks = _ranks(tmp_path_factory, "conv_rank", 7, True, 3, world=3)
    pf_j = _mini_world_pf(mesh=mesh, seed=7)
    scan = np.random.default_rng(3).random((3, 100, 25))
    pf_j.propagate(np.array([1.0, 0.0], np.float32), 0.0)
    pf_j.update(jnp.asarray(scan.astype(np.float32)), 1.0)
    assert pf_j.n_max == 66 and not pf_j._sharded_fns
    ranks = ranks.result()
    for got in ranks:
        assert got["plans"] == ranks[0]["plans"]
        assert got["plans"][0][3] == "conv" and got["keys"] == []
        assert len(got["alive"]) == 66
        np.testing.assert_allclose(got["ml"], pf_j.max_likelihood()[None],
                                   rtol=RTOL, atol=ATOL)
        assert got["n_active"] == int(pf_j.state.n_active)


# -- (e) every rank plans the same step ----------------------------------
def test_ranks_plan_alike(unknown, conv):
    """Each rank's dispatch plans every update as the other rank and the
    single-device port do, from values that are the same on every rank."""
    for _, ranks, single in (unknown, conv[1:]):
        assert ranks[0]["plans"] == ranks[1]["plans"] == single["plans"]
        assert ranks[0]["keys"] == ranks[1]["keys"]
        np.testing.assert_array_equal(ranks[0]["ml"], ranks[1]["ml"])


# -- mesh set-up ----------------------------------------------------------
def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="default process group"):
        make_mesh(device_type="cpu")


class _Mesh:
    """A stand-in mesh for the constructor's checks."""

    def __init__(self, size, device_type):
        self._size, self.device_type = size, device_type

    def size(self):
        return self._size


@pytest.mark.parametrize("n, size, want", [(100, 3, 102), (64, 2, 64)])
def test_mesh_pads_particles_to_a_multiple(n, size, want, monkeypatch):
    """n_max is padded to the chunk, then to a mesh multiple; a map on
    another device than the mesh's raises."""
    world = scen.mini_world()
    tdm = TopDownMap(MapParams(map_path="", num_classes=3), device="cpu",
                     class_maps=world)
    tdm.have_map = False  # no initial cloud: the checks alone
    from top_down_renderer_torch.parallel import sharding

    monkeypatch.setattr(sharding, "Collectives", lambda mesh: type(
        "C", (), {"rank": 0, "psum": staticmethod(lambda t: t)})())
    pf = ParticleFilter(n, tdm, FilterParams(fixed_scale=1.0), chunk_size=n,
                        mesh=_Mesh(size, "cpu"))
    assert pf.n_max == want
    with pytest.raises(ValueError, match="mesh on cuda"):
        ParticleFilter(n, tdm, FilterParams(fixed_scale=1.0), chunk_size=n,
                       mesh=_Mesh(size, "cuda"))
