"""Scenarios of the port's multi-device filter, for
tests/test_torch_sharding.py.  Each scenario builds its inputs from seeds,
so that every rank, the single-device port and the reference build the
same ones; run(..., mesh=None) runs it on one device, and the *_rank
functions are the targets of spawn_ranks.run_ranks (a gloo group over
CPU processes).  Results are numpy values.  Imports no JAX."""

from __future__ import annotations

import numpy as np
import torch

from top_down_renderer_torch.config import FilterParams, MapParams
from top_down_renderer_torch.filter import conv_score
from top_down_renderer_torch.filter.filter import ParticleFilter
from top_down_renderer_torch.maps.map import TopDownMap
from top_down_renderer_torch.parallel import sharding
from top_down_renderer_torch.testing import synthetic_setup
from top_down_renderer_torch.utils.convert import filter_state_from_numpy


def mini_world(c: int = 3) -> np.ndarray:
    """tests/test_sharding.py's 96^2 world: a road row band and a block."""
    maps_bin = np.ones((c, 96, 96), np.float32)
    maps_bin[1, 44:52, :] = 0.0
    maps_bin[2, 30:38, 60:68] = 0.0
    return maps_bin


def mini_pf(mesh, known_scale: bool, n: int, seed: int, pos_cov=0.0,
            theta_cov=0.0, device="cpu") -> ParticleFilter:
    """The port's twin of tests/test_sharding.py's _mini_world_pf (known
    scale 1, a theta prior) and _mini_world_pf_unknown_scale."""
    c = 3
    tdm = TopDownMap(MapParams(map_path="", num_classes=c, resolution=1.0),
                     device=device, class_maps=mini_world(c))
    tdm.sample_pts_polar(100, 25)
    if known_scale:
        params = FilterParams(
            fixed_scale=1.0, class_weights=[0.5] + [1.5] * (c - 1),
            force_on_map=True, init_pos_px_x=40.0, init_pos_px_y=48.0,
            init_pos_px_cov=6.0, init_pos_deg_theta=0.0,
            init_pos_deg_cov=5.0, pos_cov=pos_cov, theta_cov=theta_cov,
        )
    else:
        params = FilterParams(
            fixed_scale=-1.0, class_weights=[0.5] + [1.5] * (c - 1),
            force_on_map=True, init_pos_px_x=48.0, init_pos_px_y=48.0,
            init_pos_px_cov=6.0, init_pos_deg_theta=float("inf"),
            pos_cov=pos_cov, theta_cov=theta_cov,
        )
    return ParticleFilter(n, tdm, params, seed=seed, chunk_size=n,
                          mesh=mesh)


def feed_shifts(pf: ParticleFilter, shifts) -> None:
    """Hand the resample shifts `shifts`, in turn, to every exact or
    K-bucket step the filter runs from now on (in place of its
    generator's draws)."""
    it = iter(shifts)

    def fed(fn):
        return lambda *a, **kw: fn(*a, **{**kw, "shift": next(it)})

    for name in ("_get_multi_fn", "_get_sharded_multi_fn"):
        get = getattr(pf, name)
        setattr(pf, name, lambda *a, _get=get, **kw: fed(_get(*a, **kw)))
    pf._update_fn = fed(pf._update_fn)


def record_plans(pf: ParticleFilter) -> list:
    """The dispatch's plan of every update from now on, as plain values."""
    plans = []
    plan = pf._fast_mode

    def recorded(res):
        out = plan(res)
        plans.append(None if out is None else tuple(
            v.tolist() if isinstance(v, np.ndarray) else v for v in out))
        return out

    pf._fast_mode = recorded
    return plans


def _filter_result(pf: ParticleFilter, mls, plans) -> dict:
    p = pf.state.particles
    if pf.mesh is not None:
        p = sharding.gather_particles(p, pf._comm)
    return {
        "ml": np.stack(mls), "plans": plans,
        "keys": sorted(pf._sharded_fns, key=repr),
        "n_active": pf.n_active_host(),
        "weight": p.weight.numpy(), "alive": p.alive.numpy(),
        "mean": pf.mean_likelihood(), "cov": pf.compute_mean_cov(),
        "m_hilo": pf.m_hilo,
    }


def unknown_scale(mesh=None, seed=11, shifts=None) -> dict:
    """tests/test_sharding.py's multi-path case: two updates of 128
    particles under an unknown scale, no motion (the theta search, then
    tracked), on scans from default_rng(5); then the scale frozen at the
    geometric mean ("frozen")."""
    pf = mini_pf(mesh, known_scale=False, n=128, seed=seed)
    if shifts is not None:
        feed_shifts(pf, shifts)
    plans = record_plans(pf)
    rng = np.random.default_rng(5)
    mls = []
    for _ in range(2):
        pf.update(torch.as_tensor(rng.random((3, 100, 25)).astype(
            np.float32)), 1.0)
        mls.append(pf.max_likelihood())
    out = _filter_result(pf, mls, plans)
    pf.freeze_scale()
    out["frozen"] = pf.scale()
    return out


def conv(mesh=None, seed=7, direct=False, scan_seed=2) -> dict:
    """tests/test_sharding.py's conv-path case: one update of 64 particles
    at a known scale after a propagate of 1 m, no motion noise; `direct`
    closes the reference's s2d gate (its K4_MAX_BYTES = 0) for the run,
    and puts it back after."""
    gate = conv_score.K4_MAX_BYTES
    conv_score.K4_MAX_BYTES = 0 if direct else gate
    try:
        pf = mini_pf(mesh, known_scale=True, n=64, seed=seed)
        plans = record_plans(pf)
        scan = np.random.default_rng(scan_seed).random((3, 100, 25))
        pf.propagate(np.array([1.0, 0.0], np.float32), 0.0)
        pf.update(torch.as_tensor(scan.astype(np.float32)), 1.0)
        return _filter_result(pf, [pf.max_likelihood()], plans)
    finally:
        conv_score.K4_MAX_BYTES = gate


def exact_step(mesh=None, shift=0.5, n=512, seed=3) -> dict:
    """tests/test_sharding.py's sharded exact step on synthetic_setup's
    state (64^2 map, chunk 128), zero motion, the given resample shift."""
    d = synthetic_setup(n, h=64, w=64, seed=seed)
    state = filter_state_from_numpy(d["state"], "cpu")
    t = {k: torch.as_tensor(d[k]) for k in ("packed", "map_size", "stencil",
                                            "scan")}
    args = (t["packed"], t["map_size"], t["stencil"], t["scan"], 1.0)
    if mesh is None:
        from top_down_renderer_torch.filter.filter import make_update_step

        step = make_update_step(d["params"], 3, 1.0, 100, n, chunk_size=128)
        out = step(state, *args, shift=shift)
        p = out.particles
    else:
        step = sharding.make_sharded_step(mesh, d["params"], 3, 1.0, 100, n,
                                          chunk_size=128)
        out = step(sharding.shard_filter_state(state, mesh), *args,
                   shift=shift)
        p = sharding.gather_particles(out.particles,
                                      sharding.Collectives(mesh))
    return {"ml": out.ml_state.numpy(), "n_active": int(out.n_active),
            "init_px": p.init_px.numpy(), "weight": p.weight.numpy(),
            "alive": p.alive.numpy(), "smask": out.smask.numpy(),
            "bbox": out.bbox.numpy(), "src": d["state"]["particles"]["init_px"]}


def _on_mesh(scenario, *args):
    return scenario(sharding.make_mesh(device_type="cpu"), *args)


def unknown_scale_rank(rank, world, seed, shifts):
    return _on_mesh(unknown_scale, seed, shifts)


def conv_rank(rank, world, seed, direct, scan_seed):
    return _on_mesh(conv, seed, direct, scan_seed)


def exact_step_rank(rank, world, shift):
    return _on_mesh(exact_step, shift)


def node_rank(rank, world, png, bag_path, init):
    """The city-window node (tests/city_drive_torch.py) with
    RuntimeParams(mesh_devices=world) on the CPU, replaying the bag at
    bag_path: the number of ranks its filter is sharded over, the
    position and covariance of each pose it published, and its whole
    state (gathered) before and after reinitialize_fraction(0.1, 3)."""
    import city_drive_torch as city
    from top_down_renderer_torch import Bag, replay
    from top_down_renderer_torch.utils.convert import filter_state_to_numpy

    node = city.make_node(png, 512, "cpu", init=init, mesh_devices=world)
    rec = replay(node, Bag.load(bag_path))
    pf = node.filter

    def whole():
        return filter_state_to_numpy(pf.state.replace(
            particles=sharding.gather_particles(pf.state.particles,
                                                pf._comm)))

    before = whole()
    pf.reinitialize_fraction(0.1, seed=3)
    return {"mesh": pf.mesh.size(),
            "poses": [np.concatenate([p.position, p.covariance.ravel()])
                      for p in rec["poses"]],
            "before": before, "after": whole()}
