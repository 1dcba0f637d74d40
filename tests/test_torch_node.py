"""The port's node (runtime/node.py) and replay (io/replay.py) against the
reference's: the pairing buffers, the grid-map payload, publish_pose_est
on one filter state, the visualizations, a replay of the city drive from
a pose prior, bags across packages, and the node on a two-rank mesh."""

import dataclasses
import math
import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import city_drive_torch as city
import top_down_renderer_torch as tdr_t
import torch_mesh_ranks
from top_down_renderer_tpu import config as cfg_j
from top_down_renderer_tpu.io import Bag as BagJ
from top_down_renderer_tpu.io import gps_to_meters as gps_j
from top_down_renderer_tpu.io import replay as replay_j
from top_down_renderer_tpu.runtime import node as node_j
from top_down_renderer_torch.io import Bag as BagT
from top_down_renderer_torch.io import gps_to_meters as gps_t
from top_down_renderer_torch.runtime import node as node_t
from top_down_renderer_torch.utils.convert import (
    filter_state_from_numpy,
    filter_state_to_numpy,
)

from spawn_ranks import run_ranks
from torch_parity import to_numpy_tree

torch.set_num_threads(2)


def _class_config(cfg):
    lut = np.full((256, 3), 255, np.uint8)
    lut[:3] = [(0, 100, 0), (255, 0, 0), (0, 0, 255)]
    return cfg.ClassConfig(color_lut=lut, class_to_flattened=[0, 1, 2],
                           flattened_to_class=[0, 1, 2],
                           exclusivity=[True] * 3, loc_weight=[1.0] * 3)


def _payload(stamp=1.0, rows=96, cols=96):
    mat = np.zeros((rows, cols), np.float32)
    mat[:, 40:48] = 1.0  # a road band along the matrix rows
    mat[10:20, 60:70] = 2.0
    mat[0, 0] = np.nan  # an unseen cell -> 255
    return {"stamp": stamp, "layers": ["semantics", "elevation"],
            "data": {"semantics": mat}, "pose_x": 0.0, "pose_y": 0.0,
            "length_x": float(cols), "length_y": float(rows)}


def _nodes(fixed_scale=1.0, payload=True, **runtime):
    """The reference's node and the port's (on the CPU) on one dynamic map
    from a grid-map payload."""
    out = []
    for cfg, mod, kw in ((cfg_j, node_j, {}), (tdr_t, node_t,
                                               {"device": "cpu"})):
        node = mod.TopDownRenderNode(
            _class_config(cfg), cfg.MapConfig(dynamic=True, resolution=1.0),
            cfg.RuntimeParams(particle_count=64, **runtime),
            filter_overrides={"fixed_scale": fixed_scale}, **kw)
        if payload:
            node.aerial_map_grid_callback(_payload())
        out.append(node)
    return out


def _record_steps(node):
    calls = []
    node.take_step = lambda stamp, pts, prior: calls.append(
        (stamp, None if prior is None else prior.stamp, float(pts[0, 0])))
    return calls


def test_pairing_buffers():
    """Scan first and prior first, several priors before their scan, a
    scan that replaces an unpaired one, and no motion prior at all: the
    same steps with the same priors as the reference's node."""
    def prior(mod, t):
        return mod.PoseStamped(stamp=t, position=np.array([t, 0.0, 0.0]),
                               orientation=np.array([0.0, 0.0, 0.0, 1.0]))

    for use_prior in (True, False):
        runs = []
        for node, mod in zip(_nodes(payload=False,
                                    use_motion_prior=use_prior),
                             (node_j, node_t)):
            calls = _record_steps(node)
            pts = lambda t: np.full((4, 4), t, np.float32)  # noqa: E731
            node.motion_prior_callback(prior(mod, 1.0))  # prior first
            node.pc_callback(1.0, pts(1.0))
            node.pc_callback(2.0, pts(2.0))  # scan first
            node.motion_prior_callback(prior(mod, 2.0))
            node.motion_prior_callback(prior(mod, 3.0))  # two priors
            node.motion_prior_callback(prior(mod, 4.0))
            node.pc_callback(4.0, pts(4.0))
            node.pc_callback(5.0, pts(5.0))  # replaced before its prior
            node.pc_callback(6.0, pts(6.0))
            node.motion_prior_callback(prior(mod, 6.0))
            node.motion_prior_callback(prior(mod, 7.0))
            runs.append((calls, [p.stamp for p in node.motion_prior_buf],
                         node.last_pc is None,
                         node.last_prior_pose.tolist()))
        assert runs[1] == runs[0]
        if use_prior:
            assert [c[:2] for c in runs[1][0]] == [(1.0, 1.0), (2.0, 2.0),
                                                  (4.0, 4.0), (6.0, 6.0)]
            assert runs[1][1] == [7.0]


def test_grid_map_payload_end_to_end():
    """As the reference's test_grid_map_payload_end_to_end: the payload
    (toImage, rotation) feeds update_map and the deferred particle init;
    stale, empty and semantics-less payloads are ignored."""
    ref, node = _nodes(payload=False)
    assert not node.map.have_map and node.filter.state is None
    for n in (ref, node):
        n.aerial_map_grid_callback(_payload())
    assert node.map.have_map and node.filter.num_particles() > 0
    assert node.filter.num_particles() == ref.filter.num_particles()
    np.testing.assert_array_equal(node.map.class_maps_binary,
                                  ref.map.class_maps_binary)
    np.testing.assert_array_equal(node.map_center, ref.map_center)
    np.testing.assert_array_equal(node.background_img, ref.background_img)
    y_map = 96 - 1 - 44
    assert 1 in node.map.get_classes_at_point((50, y_map))
    assert 1 not in node.map.get_classes_at_point((50, y_map - 30))
    ver = node.filter._map_version
    for bad in (dict(stamp=0.5), dict(stamp=2.0, length_x=0.0),
                dict(stamp=3.0, layers=["elevation"])):
        node.aerial_map_grid_callback({**_payload(), **bad})
    assert node.filter._map_version == ver


def _set_state(ref, node, edit, seed):
    """Edit the reference node's filter state in numpy; give both nodes
    the result."""
    tree = to_numpy_tree(ref.filter.state)
    p = {k: np.array(v) for k, v in tree["particles"].items()}
    edit(p, np.random.default_rng(seed))
    tree["particles"] = p
    st = ref.filter.state
    ref.filter.state = st.replace(particles=st.particles.replace(
        **{k: jnp.asarray(v) for k, v in p.items()}))
    node.filter.state = filter_state_from_numpy(tree, "cpu")


def test_publish_pose_est_equals_reference():
    """publish_pose_est on the same filter states (unknown scale): the
    range-scale sequence, the scale freeze and its value, the convergence
    gate, and each published pose and 6x6 covariance within rel 1e-5."""
    ref, node = _nodes(fixed_scale=-1.0)
    topics = []
    for n in (ref, node):
        got = {"pose_est": [], "scale": [], "map_transform": []}
        for k, v in got.items():
            n.on(k, v.append)
        topics.append(got)

    def spread(p, rng):
        pass

    def cluster(p, rng):
        n = len(p["alive"])
        p["init_px"][:] = [50.0, 44.0] + rng.standard_normal((n, 2)) * 2.0
        p["d_m"][:] = 0.0
        p["theta"][:] = 0.3 + rng.standard_normal(n) * 0.01

    def scales_apart(p, rng):
        cluster(p, rng)
        p["scale"][:] = rng.uniform(1.0, 3.0, len(p["scale"]))

    def scales_together(p, rng):
        cluster(p, rng)
        p["scale"][:] = 2.0 * (1.0 + 5e-4 * rng.standard_normal(
            len(p["scale"])))

    def moved(p, rng):
        p["init_px"][:] += [3.0, -2.0]

    for i, edit in enumerate((spread, scales_apart, scales_together,
                              moved)):
        _set_state(ref, node, edit, seed=i)
        ref.publish_pose_est(float(i))
        node.publish_pose_est(float(i))
        assert node.current_range_scale == ref.current_range_scale, i
        assert node.is_converged == ref.is_converged, i
        assert node.filter.is_scale_frozen == ref.filter.is_scale_frozen, i
        assert node.filter.scale() == pytest.approx(ref.filter.scale(),
                                                    rel=1e-6), i
    assert ref.filter.is_scale_frozen and ref.is_converged
    poses_j, poses_t = topics[0]["pose_est"], topics[1]["pose_est"]
    assert len(poses_t) == len(poses_j) == 2
    for a, b in zip(poses_t, poses_j):
        assert (a.stamp, a.frame_id) == (b.stamp, b.frame_id)
        for k in ("position", "orientation", "covariance"):
            va, vb = getattr(a, k), getattr(b, k)
            np.testing.assert_allclose(va, vb, rtol=1e-5,
                                       atol=1e-5 * np.abs(vb).max(), err_msg=k)
    np.testing.assert_allclose(topics[1]["scale"], topics[0]["scale"],
                               rtol=1e-6)
    assert len(topics[1]["map_transform"]) == len(topics[0]["map_transform"])
    for a, b in zip(topics[1]["map_transform"], topics[0]["map_transform"]):
        np.testing.assert_allclose(a["translation"], b["translation"],
                                   rtol=1e-6)


def test_visualizations_equal_reference():
    """visualize_scan, visualize_analog and visualize_map (particles, GMM
    and max-likelihood arrows on the background map) as the reference
    draws them; publish_local_map publishes its window."""
    ref, node = _nodes()
    scan = np.random.default_rng(3).integers(0, 3, (3, 100, 25)).astype(
        np.float32)
    np.testing.assert_array_equal(node.visualize_scan(scan),
                                  ref.visualize_scan(scan))
    field = np.array([[0.0, 25.0], [50.0, 100.0]])
    np.testing.assert_array_equal(node.visualize_analog(field, 50.0),
                                  ref.visualize_analog(field, 50.0))
    _set_state(ref, node, lambda p, rng: None, 0)
    np.testing.assert_array_equal(node.visualize_map(), ref.visualize_map())
    shown = []
    node.on("scan", shown.append)
    img = node.publish_local_map(21, 31, (50.0, 40.0), 1.0)
    assert img.shape == (21, 31, 3) and shown[0] is img


def _city_window(scans, window=256):
    maps, traj, psi = city.city_world()
    maps, traj = city.crop(maps, traj, slice(0, scans), window)
    png = os.path.join(tempfile.mkdtemp(), "city_window.png")
    city.write_world_png(maps, png)
    init = dict(init_pos_px_x=float(traj[0][0]),
                init_pos_px_y=float(traj[0][1]), init_pos_px_cov=15.0,
                init_pos_deg_theta=math.degrees(psi[0]), init_pos_deg_cov=15.0)
    return png, city.make_bag(maps, traj, psi, scans), traj, init


def test_city_replay_converges_as_reference():
    """40 scans of the city drive in a 256^2 window, from a pose prior,
    1,024 particles: the port's node converges as the reference's does,
    and the published poses lie within 2 m of the true trajectory on
    average in both (the draws differ: the mean errors within 1 m)."""
    png, bag, traj, init = _city_window(40)
    node = city.make_node(png, 1024, "cpu", init=init)
    rec_t, errs_t, times = city.run(node, bag, traj)
    cc = city.class_config()
    ref = node_j.TopDownRenderNode(
        cfg_j.ClassConfig(cc.color_lut, cc.class_to_flattened,
                          cc.flattened_to_class, cc.exclusivity,
                          cc.loc_weight),
        cfg_j.MapConfig(raster_path=png, resolution=city.SCALE),
        cfg_j.RuntimeParams(particle_count=1024, use_motion_prior=True),
        filter_overrides=dict(city.OVERRIDES, **init), seed=0)
    bag_j = BagJ(**dataclasses.asdict(bag))
    rec_j = replay_j(ref, bag_j)
    errs_j = city.pose_errors(ref, rec_j["poses"], traj)
    for rec in (rec_t, rec_j):
        assert rec["first_converged_stamp"] is not None
        assert rec["first_converged_stamp"] < 10 * city.DT
        assert rec["n_scans"] == 40 and rec["final_scale"] == city.SCALE
    assert abs(len(rec_t["poses"]) - len(rec_j["poses"])) <= 3
    assert errs_t.mean() < 2.0 and errs_j.mean() < 2.0
    assert abs(errs_t.mean() - errs_j.mean()) < 1.0
    assert set(times[0]) == {"render_ms", "filter_ms", "publish_ms"}


def test_bags_load_across_packages(tmp_path):
    """A bag saved by either package loads in the other, field for field,
    with and without GPS."""
    rng = np.random.default_rng(0)
    fields = dict(
        scan_stamps=np.arange(3) * 0.2,
        scan_points=rng.standard_normal((12, 4)).astype(np.float32),
        scan_offsets=np.array([0, 4, 8, 12]),
        prior_stamps=np.arange(3) * 0.2,
        prior_pos=rng.standard_normal((3, 3)),
        prior_quat=rng.standard_normal((3, 4)),
    )
    gps = dict(gps_stamps=np.arange(3) * 0.2,
               gps_latlon=rng.standard_normal((3, 2)))
    for extra in ({}, gps):
        for src, dst in ((BagJ, BagT), (BagT, BagJ)):
            path = str(tmp_path / f"{src.__module__}{len(extra)}.npz")
            src(**fields, **extra).save(path)
            back = dst.load(path)
            for k, v in {**fields, **extra}.items():
                np.testing.assert_array_equal(getattr(back, k), v, k)
            assert back.gps_stamps is None if not extra else True
            np.testing.assert_array_equal(back.scan(1),
                                          fields["scan_points"][4:8])
    np.testing.assert_array_equal(gps_t(gps["gps_latlon"]),
                                  gps_j(gps["gps_latlon"]))


def test_node_on_a_two_rank_mesh_publishes_one_pose(tmp_path):
    """RuntimeParams(mesh_devices=2) on two gloo ranks: the filter is
    sharded over the ranks, both publish the same poses, and
    reinitialize_fraction redraws the rows the one-device filter redraws
    from the same whole state."""
    png, bag, traj, init = _city_window(6)
    bag_path = str(tmp_path / "bag.npz")
    bag.save(bag_path)
    out = run_ranks(torch_mesh_ranks.node_rank, 2, tmp_path / "ranks",
                    args=(png, bag_path, init), timeout=240.0)
    assert out[0]["mesh"] == out[1]["mesh"] == 2
    assert len(out[0]["poses"]) > 0
    assert len(out[0]["poses"]) == len(out[1]["poses"])
    for a, b in zip(out[0]["poses"], out[1]["poses"]):
        np.testing.assert_array_equal(a, b)
    one = city.make_node(png, 512, "cpu", init=init).filter
    one.state = filter_state_from_numpy(out[0]["before"], "cpu")
    one.reinitialize_fraction(0.1, seed=3)
    for r in (0, 1):
        for k, v in filter_state_to_numpy(one.state)["particles"].items():
            np.testing.assert_array_equal(out[r]["after"]["particles"][k], v,
                                          k)
        for k in ("bbox", "smask"):
            np.testing.assert_array_equal(out[r]["after"][k],
                                          filter_state_to_numpy(one.state)[k])

