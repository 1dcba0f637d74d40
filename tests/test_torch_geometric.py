"""The geometric renders (render/geometric.py) against the reference's
compiled ones, count for count: padding points at (0, 0), exact rounding
halves, vertical steps (infinite slopes) and repeated points (0 / 0),
points beyond the grid."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from top_down_renderer_tpu.render import geometric as geo_j
from top_down_renderer_torch.render import geometric as geo_t

from torch_parity import np_

torch.set_num_threads(2)


def _points(seed, n=3000):
    rng = np.random.default_rng(seed)
    pts = np.zeros((n, 4), np.float32)
    pts[:, :2] = rng.uniform(-40, 40, (n, 2))
    pts[:, 2] = rng.standard_normal(n) * 1.5
    pts[:40, :2] = 0.0  # padding
    pts[40:50, :2] = rng.uniform(300, 900, (10, 2))  # beyond the range bins
    # exact halves: r / res = k + 0.5 on the +y axis (theta 0), and
    # theta / ang_res = k + 0.5 at r = 10
    pts[50:60, 0] = 0.0
    pts[50:60, 1] = np.arange(10) + 0.5
    ang = (np.arange(10) + 0.5) * np.float32(2 * math.pi / 100)
    pts[60:70, 0] = 10 * np.sin(ang)
    pts[60:70, 1] = 10 * np.cos(ang)
    # vertical steps: a wall of points at one (x, y), z stepping up, and
    # repeated points (slope 0 / 0)
    pts[70:90, :2] = [3.0, 17.0]
    pts[70:90, 2] = np.repeat(np.arange(10, dtype=np.float32), 2)
    pts[90:100] = pts[90]
    # ground ramps along a few bins: consecutive points far apart, flat
    r = np.linspace(2, 30, 60, dtype=np.float32)
    pts[100:160, 0] = 0.0
    pts[100:160, 1] = -r
    pts[100:160, 2] = 0.01 * r
    return pts


@pytest.mark.parametrize("seed,res,th,rb", [(0, 1.0, 100, 25),
                                            (1, 0.5, 100, 25),
                                            (2, 0.3, 64, 40),
                                            (3, 4.0, 100, 25)])
def test_polar_equals_reference(seed, res, th, rb):
    pts = _points(seed)
    ang = 2 * math.pi / th
    ref = np.asarray(geo_j.render_geometric_polar(
        jnp.asarray(pts), res, ang, th, rb))
    got = geo_t.render_geometric_polar(pts, res, ang, th, rb)
    np.testing.assert_array_equal(np_(got), ref)
    # the 0-dim tensor scales the node passes give the same counts
    got_t = geo_t.render_geometric_polar(
        torch.as_tensor(pts), torch.tensor(res), torch.tensor(ang), th, rb)
    np.testing.assert_array_equal(np_(got_t), ref)
    assert ref[0].sum() > 0 and ref[1].sum() > 0


def _cloud(seed, hc=24, wc=40):
    rng = np.random.default_rng(seed)
    cloud = np.zeros((hc, wc, 3), np.float32)
    # rings of rising range up each column, rough terrain, walls
    r = np.linspace(1.0, 30.0, hc, dtype=np.float32)[:, None]
    az = np.linspace(-math.pi, math.pi, wc, dtype=np.float32)[None, :]
    cloud[..., 0] = r * np.cos(az)
    cloud[..., 1] = r * np.sin(az)
    cloud[..., 2] = rng.standard_normal((hc, wc)) * 0.05
    cloud[10:14, ::3, 2] += np.arange(4, dtype=np.float32)[:, None] * 3
    cloud[rng.random((hc, wc)) < 0.15, :2] = 0.0  # invalid returns
    cloud[5, :, :2] = cloud[4, :, :2]  # repeated points
    cloud[0, 0, :2] = [0.5, 0.5]  # an exact half at res 1
    return cloud


@pytest.mark.parametrize("seed,res,w,h,k", [(0, 1.0, 64, 48, 64),
                                            (1, 0.25, 80, 60, 16),
                                            (2, 0.5, 32, 32, 64)])
def test_cartesian_equals_reference(seed, res, w, h, k):
    cloud = _cloud(seed)
    ref = np.asarray(jax.jit(
        geo_j.render_geometric_cartesian,
        static_argnames=("width", "height", "max_interp"),
    )(jnp.asarray(cloud), res, width=w, height=h, max_interp=k))
    got = geo_t.render_geometric_cartesian(cloud, res, w, h, k)
    np.testing.assert_array_equal(np_(got), ref)
    assert ref[0].sum() > 0 and ref[1].sum() > 0
