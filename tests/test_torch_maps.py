"""Port parity: polar stencil, truncated EDT, build_grid, TopDownMap
queries and the semantic renderers against the JAX package."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import distance_transform_edt

from top_down_renderer_tpu.config import ClassConfig, MapParams
from top_down_renderer_tpu.maps.edt import compute_dists as dists_jax
from top_down_renderer_tpu.maps.edt import edt as edt_jax
from top_down_renderer_tpu.maps import map as map_j
from top_down_renderer_tpu.maps.polar import polar_stencil as polar_j
from top_down_renderer_tpu.render import semantic as sem_j
from top_down_renderer_torch.maps import edt as edt_t
from top_down_renderer_torch.maps import map as map_t
from top_down_renderer_torch.maps.polar import polar_stencil as polar_t
from top_down_renderer_torch.render import semantic as sem_t

from top_down_renderer_torch.utils.convert import grid_from_numpy, grid_to_numpy
from torch_parity import np_, to_numpy_tree
from util_synthetic import make_world

torch.set_num_threads(2)


@pytest.mark.parametrize(
    "th,r,ang,mres", [(100, 25, None, 1.0), (100, 50, None, 1.0),
                      (64, 20, 0.05, 0.5)]
)
def test_polar_stencil_equal(th, r, ang, mres):
    np.testing.assert_array_equal(
        polar_t(th, r, ang, mres), polar_j(th, r, ang, mres)
    )


@pytest.mark.parametrize("seed,trunc", [(0, 50), (1, 50), (2, 7)])
def test_edt_matches_jax_and_scipy(seed, trunc):
    rng = np.random.default_rng(seed)
    present = rng.random((64, 96)) < 0.03
    present[3, 5] = True
    ours = np_(edt_t.edt(torch.as_tensor(present), trunc))
    ref_j = np.asarray(edt_jax(jnp.asarray(present), trunc_px=trunc))
    oracle = np.minimum(distance_transform_edt(~present), float(trunc))
    # The port is exact in any process: every step before the square root
    # is integer arithmetic in float32 (row indices, their cummax, squares
    # and sums below 2 T^2), and torch's sqrt rounds correctly.
    np.testing.assert_allclose(ours, oracle, rtol=0, atol=1e-5)
    # The reference is exact in a fresh process too, but not in every one:
    # in a whole-suite run its compiled edt differed from the port on
    # 48.5 % of the pixels, by up to rel 3.0e-4, the size of a 12-bit
    # reciprocal square-root estimate's error (at most 1.5 * 2^-12 =
    # 3.7e-4), which the port's exact arithmetic cannot make.  So JAX is
    # held to that bound against scipy, and the port is held to JAX
    # through scipy: within 1e-5 + JAX's own error there.
    err_j = np.abs(ref_j - oracle)
    assert (err_j <= 3.7e-4 * oracle + 1e-5).all()


@pytest.mark.parametrize("resolution,trunc_m", [(1.0, 50.0), (2.0, 20.0)])
def test_compute_dists_matches_jax_and_scipy(resolution, trunc_m):
    """Scale by resolution, truncation, and zero on unknown cells."""
    maps = _class_maps(5, 3, 40, 56)
    maps[:, :6, :6] = 1.0  # no class there: unknown
    d_t, m_t = edt_t.compute_dists(torch.as_tensor(maps), resolution, trunc_m)
    d_j, m_j = dists_jax(jnp.asarray(maps), resolution, trunc_m)
    np.testing.assert_array_equal(np_(m_t), np.asarray(m_j))
    np.testing.assert_allclose(np_(d_t), np.asarray(d_j), rtol=0, atol=1e-5)
    for i in range(3):
        ref = np.minimum(
            distance_transform_edt(maps[i] != 0) * resolution, trunc_m
        )
        ref[np.asarray(m_j) == 1] = 0.0
        np.testing.assert_allclose(np_(d_t)[i], ref, atol=1e-3)


def _class_maps(seed=3, c=4, h=48, w=64):
    rng = np.random.default_rng(seed)
    maps = np.ones((c, h, w), np.float32)
    for i in range(c):
        y, x = rng.integers(0, h - 8, 2)
        maps[i, y : y + 8, x : x + 6] = 0.0
        maps[i, rng.integers(0, h, 6), rng.integers(0, w, 6)] = 0.0
    return maps


@pytest.mark.parametrize("resolution", [1.0, 2.0])
def test_build_grid_matches_jax(resolution):
    maps = _class_maps()
    g_t = map_t.build_grid(maps, resolution=resolution, trunc_m=30.0,
                           device="cpu")
    g_j = map_j.build_grid(maps, resolution=resolution, trunc_m=30.0)
    for name in ("dist", "geo_dist"):
        np.testing.assert_allclose(
            np_(getattr(g_t, name)), np.asarray(getattr(g_j, name)),
            rtol=1e-5, atol=1e-5, err_msg=name,
        )
    for name in ("mask", "road_ok", "map_center"):
        np.testing.assert_array_equal(
            np_(getattr(g_t, name)), np.asarray(getattr(g_j, name)), name
        )
    assert g_t.num_classes == g_j.num_classes
    assert g_t.resolution == g_j.resolution
    # the reference grid carried into the port and back
    tree = to_numpy_tree(g_j)
    g_c = grid_from_numpy(tree)
    back = grid_to_numpy(g_c)
    for name in ("dist", "geo_dist", "mask", "road_ok", "map_center"):
        np.testing.assert_array_equal(back[name], tree[name], name)
        assert getattr(g_c, name).dtype == getattr(g_t, name).dtype, name
    assert (g_c.resolution, g_c.num_classes) == (g_j.resolution, g_j.num_classes)


def test_topdownmap_queries_match_jax():
    world = make_world(96, 128)
    params = MapParams(map_path="", num_classes=3)
    tdm_t = map_t.TopDownMap(params, device="cpu", class_maps=world)
    tdm_j = map_j.TopDownMap(params)
    tdm_j.class_maps_binary = world
    tdm_j.grid = map_j.build_grid(world)
    tdm_j.have_map = True
    assert tdm_t.have_map
    pts = [(60, 105), (0, 0), (127.5, 95.2), (-0.5, 3), (-3, 10),
           (1e6, 5), (5, -1e6), (64.2, 30.9)]
    for p in pts:
        assert tdm_t.get_classes_at_point(p) == tdm_j.get_classes_at_point(
            p
        ), p
    assert tdm_t.grid.dist.shape[:2] == tdm_j.grid.dist.shape[:2]
    tdm_t.sample_pts_polar(100, 25)
    tdm_j.sample_pts_polar(100, 25)
    np.testing.assert_array_equal(tdm_t.stencil, tdm_j.stencil)


def test_colour_raster_and_update_map_match_jax(tmp_path):
    from PIL import Image

    world = make_world(64, 80)
    ind = np.zeros(world.shape[1:], np.uint8)
    ind[world[1] == 0] = 1
    ind[world[2] == 0] = 2
    colors = np.array([(0, 100, 0), (128, 128, 128), (170, 40, 40)], np.uint8)
    png = str(tmp_path / "map.png")
    Image.fromarray(colors[ind[::-1]]).save(png)
    lut = np.full((256, 3), 255, np.uint8)
    lut[:3] = colors
    cc = ClassConfig(lut, [0, 1, 2], [0, 1, 2], [True, True, False],
                     [0.1, 1.5, 3.0])
    params = MapParams(map_path=png, num_classes=3, class_config=cc)
    tdm_t = map_t.TopDownMap(params, device="cpu")
    tdm_j = map_j.TopDownMap(params)
    np.testing.assert_array_equal(
        tdm_t.class_maps_binary, tdm_j.class_maps_binary
    )
    np.testing.assert_allclose(
        np_(tdm_t.grid.dist), np.asarray(tdm_j.grid.dist), atol=1e-5
    )
    rolled = np.roll(ind, (5, 7), (0, 1))[::-1]
    tdm_t.update_map(rolled, (7, 5))
    tdm_j.update_map(rolled, (7, 5))
    np.testing.assert_allclose(
        np_(tdm_t.grid.dist), np.asarray(tdm_j.grid.dist), atol=1e-5
    )
    np.testing.assert_array_equal(
        np_(tdm_t.grid.map_center), np.asarray(tdm_j.grid.map_center)
    )


def _points(seed=0, n=4000):
    rng = np.random.default_rng(seed)
    pts = np.zeros((n, 4), np.float32)
    pts[:, :2] = rng.uniform(-40, 40, (n, 2))
    pts[:, 2] = rng.standard_normal(n)
    pts[:, 3] = rng.integers(0, 6, n)
    pts[:50, :2] = 0.0  # padding sentinel
    pts[50:60, :2] = rng.uniform(500, 900, (10, 2))  # out of range
    pts[60:70, 3] = 255  # raw class the LUT drops
    pts[70:80, 3] = -4  # negative raw class (clipped to 0)
    # exact bin ties: r / res = k + 0.5 and theta / ang_res = k + 0.5
    pts[80:90, 0] = 0.0
    pts[80:90, 1] = np.arange(10) + 0.5
    ang = (np.arange(10) + 0.5) * np.float32(2 * math.pi / 100)
    pts[90:100, 0] = 10 * np.sin(ang)
    pts[90:100, 1] = 10 * np.cos(ang)
    return pts


def _lut():
    lut = -np.ones(256, np.int32)
    lut[:5] = [0, 1, 2, -1, 1]  # raw 3 dropped, raw 4 folds onto 1
    return lut


@pytest.mark.parametrize("res", [1.0, 0.5, 0.3])
def test_render_polar_equal(res):
    pts, lut = _points(), _lut()
    ang_res = 2 * math.pi / 100
    got = sem_t.render_semantic_polar(pts, lut, res, ang_res, 3, 100, 25)
    ref = sem_j.render_semantic_polar(
        jnp.asarray(pts), jnp.asarray(lut), res, ang_res, 3, 100, 25
    )
    np.testing.assert_array_equal(np_(got), np.asarray(ref))
    assert np_(got).sum() > 0


@pytest.mark.parametrize("res", [1.0, 0.25])
def test_render_cartesian_equal(res):
    pts, lut = _points(1), _lut()
    got = sem_t.render_semantic_cartesian(pts, lut, res, 3, 64, 48)
    ref = sem_j.render_semantic_cartesian(
        jnp.asarray(pts), jnp.asarray(lut), res, 3, 64, 48
    )
    np.testing.assert_array_equal(np_(got), np.asarray(ref))
    assert np_(got).sum() > 0


def test_the_card_is_the_default_device(monkeypatch):
    """With no device, TopDownMap and build_grid use the card and a
    ParticleFilter follows its map; with no card they raise, never falling
    back to the CPU.  device="cpu" builds on the CPU."""
    from top_down_renderer_torch import config as cfg_t
    from top_down_renderer_torch.filter.filter import ParticleFilter
    from top_down_renderer_torch.kernels import default_device

    world = make_world(64, 64)
    params = cfg_t.MapParams(map_path="", num_classes=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: map_t.TopDownMap(params, class_maps=world),
                  lambda: map_t.TopDownMap(params),
                  lambda: map_t.build_grid(world)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    tdm = map_t.TopDownMap(params, device="cpu", class_maps=world)
    assert tdm.device == tdm.grid.dist.device == torch.device("cpu")
    assert map_t.build_grid(world, device="cpu").dist.device.type == "cpu"
    pf = ParticleFilter(64, tdm, cfg_t.FilterParams(fixed_scale=2.0))
    assert pf.device == pf.state.particles.theta.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device() == torch.device("cuda")
    assert default_device("cpu") == torch.device("cpu")


def _maps_both(h=96, w=128, resolution=1.0, center=(0, 0)):
    """The same world in both packages' TopDownMap, polar stencil 100 x
    25."""
    world = make_world(h, w)
    params = MapParams(map_path="", num_classes=3, resolution=resolution)
    tdm_t = map_t.TopDownMap(params, device="cpu", class_maps=world)
    tdm_t._set_class_maps(world, center)
    tdm_j = map_j.TopDownMap(params)
    tdm_j.class_maps_binary = world
    # one grid: the port's distances (the two EDTs may differ by an ulp)
    tdm_j.grid = map_j.build_grid(world, resolution=resolution,
                                  map_center=center).replace(
        dist=jnp.asarray(np_(tdm_t.grid.dist)),
        geo_dist=jnp.asarray(np_(tdm_t.grid.geo_dist)))
    tdm_j.have_map = True
    for tdm in (tdm_t, tdm_j):
        tdm.sample_pts_polar(100, 25)
    return tdm_t, tdm_j


# centres inside, on the edge, half outside and far outside the map, as
# floats, numpy floats and exact halves
_CENTRES = [(60.0, 105.0), (0.0, 0.0), (127.5, 95.5), (np.float64(64.25),
            np.float64(30.5)), (-10.0, 50.0), (500.0, -400.0)]


@pytest.mark.parametrize("resolution", [1.0, 2.0])
def test_local_maps_equal(resolution):
    """get_local_map (polar), get_local_geo_map and
    get_local_map_cartesian equal the reference's on one grid, with
    size() and map_center()."""
    tdm_t, tdm_j = _maps_both(resolution=resolution, center=(7, -3))
    np.testing.assert_array_equal(tdm_t.size(), tdm_j.size())
    np.testing.assert_array_equal(tdm_t.map_center(), tdm_j.map_center())
    for c in _CENTRES:
        for scale, res in ((2.0, 1.0), (1.0, 0.5), (3.3, 0.7)):
            for name in ("get_local_map", "get_local_geo_map"):
                got = getattr(tdm_t, name)(c, scale, res)
                ref = getattr(tdm_j, name)(c, scale, res)
                for a, b in zip(got if isinstance(got, tuple) else [got],
                                ref if isinstance(ref, tuple) else [ref]):
                    assert a.dtype == b.dtype and a.shape == b.shape
                    np.testing.assert_array_equal(a, b, (name, c))
        for rot in (0.0, 0.3, math.pi / 2, -2.0):
            got = tdm_t.get_local_map_cartesian(c, rot, 1.0, 21, 31)
            ref = tdm_j.get_local_map_cartesian(c, rot, 1.0, 21, 31)
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a, b, (c, rot))


def test_cartesian_local_map_identity_and_rotation():
    """The reference's own checks (tests/test_runtime_extras.py) on the
    port: rot 0, res 1 is a slice of the distance field; rot pi/2 is its
    transpose flipped; far out of the map, dist 0 and mask 1."""
    tdm, _ = _maps_both(256, 256)
    h = w = 21
    center = (60.0, 105.0)
    dists, mask = tdm.get_local_map_cartesian(center, 0.0, 1.0, h, w)
    full = np_(tdm.grid.dist)
    y0, x0 = int(center[1]) - h // 2, int(center[0]) - w // 2
    np.testing.assert_allclose(
        dists, np.moveaxis(full[y0:y0 + h, x0:x0 + w, :3], -1, 0), atol=1e-5)
    assert mask.sum() == 0
    d0, _ = tdm.get_local_map_cartesian((128, 128), 0.0, 1.0, 31, 31)
    d90, _ = tdm.get_local_map_cartesian((128, 128), np.pi / 2, 1.0, 31, 31)
    np.testing.assert_allclose(d90[1], np.flipud(d0[1]).T, atol=1e-4)
    d_o, m_o = tdm.get_local_map_cartesian((-500, -500), 0.0, 1.0, 5, 5)
    assert np.all(d_o == 0) and np.all(m_o == 1)
