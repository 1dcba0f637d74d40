"""Multi-device scaling: the particle axis over the ranks of a process
group (counterpart of parallel/sharding.py).

One process per rank, as torchrun starts them; the caller initialises the
default process group (NCCL on the card, gloo on the CPU) and make_mesh
wraps it in a 1-D DeviceMesh named "data".  Rank r holds particle rows
[r n_local, (r + 1) n_local) of an n_max = n_dev n_local cloud; every other
field of the FilterState (counts, the freeze, ml_state, the GMM, the step,
the bounding box and the shift mask) is replicated.  Per update:

  propagate / score        no communication: each rank scores its rows
                           (the exact gather, the K-bucket crop kernels, or
                           its rows of the conv cost field)
  conv cost field          the field's ROWS are sharded: each rank convolves
                           its share of the region, one all-gather assembles
                           it; the region's origin is the all-reduced MIN of
                           the alive centres; reads are local
  weight statistics        all_reduce(SUM), the scalars of one stage in one
                           vector (postprocess_weights' psum)
  systematic resample      ONE all-gather of the packed (n_local, 10) rows;
                           every rank computes ml_state, the adaptive count,
                           the source indices and the periodic GMM from the
                           gathered copy, then takes its own slice
  bbox, shift mask         all_reduce(MIN) of (min, -max); all_reduce(SUM)
                           of the local masks

Random draws: the resample shift comes from a generator that is the same
on every rank (each rank draws the same number); the propagate noise from
one seeded by (seed, rank) (rank_seed).  Every step also takes `shift=` and
`noise=`, so that a test can feed the reference's draws.

Collectives (Collectives): on NCCL the tensors stay on the card; gloo moves
tensors through host memory, so a CUDA tensor on a gloo group (two ranks
on one card, which NCCL refuses) is copied to the host, reduced or
gathered there, and copied back.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from top_down_renderer_torch.config import FilterParams
from top_down_renderer_torch.core.grids import FilterState, Particles
from top_down_renderer_torch.filter import conv_score as cs
from top_down_renderer_torch.filter import gmm as gmm_mod
from top_down_renderer_torch.filter import multiscale as ms
from top_down_renderer_torch.filter import particles as particles_mod
from top_down_renderer_torch.filter.filter import (
    _pad_class_weights,
    _raw_theta,
    _select_flavour,
    compute_weights,
    pose_bbox,
    postprocess_weights,
    weight_from_cost,
)
from top_down_renderer_torch.filter.resample import (
    _systematic_indices,
    pack_fields,
    unpack_fields,
)
from top_down_renderer_torch.filter.scoring import (
    rotation_shift,
    score_all_rotations,
    shift_mask,
)

AXIS = "data"


def make_mesh(n: int | None = None, device_type: str | None = None) -> DeviceMesh:
    """A 1-D DeviceMesh named "data" over every rank of the initialised
    default process group.  n, if given, must be its world size (one
    process per rank).  device_type: "cuda" (the default: each rank's
    tensors live on its current card) or "cpu"."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh wraps the default process group: initialise it "
            "first (torchrun, or torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"a mesh of {n} ranks needs world size {n}, the "
                         f"process group has {world}")
    device_type = device_type or "cuda"
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"no mesh on device type {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs a CUDA device; pass "
                           "device_type=\"cpu\" for a CPU mesh")
    return DeviceMesh(device_type, list(range(world)),
                      mesh_dim_names=(AXIS,))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on the mesh: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s propagate noise: distinct per rank, the
    same for the same (seed, rank)."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


class Collectives:
    """The collectives of the sharded steps over the mesh's "data" group.
    Each returns a new tensor on the input's device and leaves its input
    as it was.  On a gloo group a CUDA tensor goes through host memory
    (gloo's collectives are host collectives)."""

    def __init__(self, mesh: DeviceMesh):
        self.group = mesh.get_group(AXIS)
        self.rank = mesh.get_local_rank(AXIS)
        self.size = mesh.size()
        self._staged = dist.get_backend(self.group) == "gloo"

    def _buffer(self, t: torch.Tensor) -> torch.Tensor:
        if self._staged and t.is_cuda:
            return t.detach().cpu()
        return t.detach().clone()

    def _reduce(self, ts, op):
        """ts reduced over the ranks, in ONE all_reduce of their values
        laid end to end (they share a dtype): one tensor for one, else a
        tuple."""
        buf = self._buffer(torch.cat([t.reshape(-1) for t in ts]))
        dist.all_reduce(buf, op, group=self.group)
        out = tuple(v.to(t.device).reshape(t.shape) for v, t in
                    zip(buf.split([t.numel() for t in ts]), ts))
        return out if len(out) > 1 else out[0]

    def psum(self, *ts: torch.Tensor):
        """The sum over the ranks of each argument (stats.local's
        signature)."""
        return self._reduce(ts, dist.ReduceOp.SUM)

    def pmin(self, *ts: torch.Tensor):
        return self._reduce(ts, dist.ReduceOp.MIN)

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's t, concatenated along dim in rank order."""
        src = self._buffer(t.contiguous())
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts, dim).to(t.device)


def shard_filter_state(state: FilterState, mesh: DeviceMesh) -> FilterState:
    """This rank's share of a whole FilterState, on its mesh device: its
    rows of every particle field, every other field replicated."""
    rank, size = mesh.get_local_rank(AXIS), mesh.size()
    n = state.particles.n_max
    if n % size:
        raise ValueError(f"{n} particles do not split over {size} ranks")
    lo, hi = rank * (n // size), (rank + 1) * (n // size)
    p = state.particles
    rows = Particles(**{f.name: getattr(p, f.name)[lo:hi].clone()
                        for f in dataclasses.fields(Particles)})
    return state.replace(particles=rows).to(mesh_device(mesh))


def gather_particles(p: Particles, comm: Collectives) -> Particles:
    """The whole particle set on every rank: its 10 fields ride one
    all-gather of (n_local, 10) rows."""
    g = comm.gather(torch.cat([pack_fields(p), p.weight[:, None],
                               p.alive.to(torch.float32)[:, None]], 1))
    return unpack_fields(g[:, :8], g[:, 8], g[:, 9] > 0.5)


def _sharded_tail(
    state: FilterState,
    p: Particles,
    w_raw: torch.Tensor,
    comm: Collectives,
    n_max: int,
    k_max: int,
    gmm_every: int,
    theta_bins: int,
    shift=None,
    generator=None,
) -> FilterState:
    """filter.update_tail over the shards: the weight statistics summed
    over ranks, one all-gather of the packed rows, the resample, adaptive
    count and GMM from the gathered copy on every rank, the bbox and smask
    reduced.  `shift` replaces the resample's draw from `generator`, which
    must draw alike on every rank."""
    dev = w_raw.device
    w = postprocess_weights(w_raw, p.last_dist, p.alive, state.n_active,
                            psum=comm.psum)
    g = gather_particles(p.replace(weight=w), comm)
    rows = pack_fields(g)
    # the max-weight particle's state BEFORE resampling
    ml_state = g.ml_state()[torch.argmax(g.weight)]
    n_new = gmm_mod.adaptive_particle_count(state.gmm, state.n_active, n_max)
    if shift is None:
        shift = torch.rand((), generator=generator, device=dev)
    shift = torch.as_tensor(shift, dtype=torch.float32, device=dev)
    j_all = _systematic_indices(g.weight, n_new, state.n_active, shift)
    n_local = p.n_max
    lo = comm.rank * n_local
    alive = torch.arange(lo, lo + n_local, device=dev) < n_new
    w_one = 1.0 / torch.clamp(n_new, min=1)
    new_p = unpack_fields(rows[j_all[lo : lo + n_local]],
                          torch.where(alive, w_one, 0.0).to(torch.float32),
                          alive)
    new_gmm = state.gmm
    if state.step % gmm_every == 0:
        # over the whole resampled set, rebuilt from the gathered copy
        full_alive = torch.arange(n_max, device=dev) < n_new
        full = unpack_fields(
            rows[j_all],
            torch.where(full_alive, w_one, 0.0).to(torch.float32),
            full_alive,
        )
        new_gmm = gmm_mod.compute_gmm(full, n_new, state.gmm.k, k_max=k_max)
    bb = pose_bbox(new_p)
    least = comm.pmin(torch.cat([bb[:2], -bb[2:]]))
    smask = shift_mask(rotation_shift(new_p.theta, theta_bins), new_p.alive,
                       theta_bins)
    return state.replace(
        particles=new_p,
        n_active=n_new,
        ml_state=ml_state,
        gmm=new_gmm,
        step=state.step + 1,
        bbox=torch.cat([least[:2], -least[2:]]),
        smask=comm.psum(smask.to(torch.int32)) > 0,
    )


def _propagate(state, params, motion, noise, noise_generator):
    """The fused propagate of a pending motion (tx, ty, omega, dist) on
    this rank's rows, or the state as it is without one."""
    if motion is None:
        return state
    motion = np.asarray(motion, np.float32)
    return state.replace(particles=particles_mod.propagate(
        state.particles, motion[:2], motion[2], params, state.scale_frozen,
        dist=motion[3], noise=noise, generator=noise_generator,
    ))


def _local_rows(mesh: DeviceMesh, n_max: int) -> int:
    n_dev = mesh.size()
    if n_max % n_dev:
        raise ValueError(f"n_max {n_max} must be divisible by the mesh size "
                         f"{n_dev}")
    return n_max // n_dev


def make_sharded_step(
    mesh: DeviceMesh,
    params: FilterParams,
    num_classes: int,
    map_resolution: float,
    theta_bins: int,
    n_max: int,
    k_max: int = 8,
    gmm_every: int = 1,
    chunk_size: int = 2048,
):
    """The multi-device exact-gather step with its fused propagate:
    step(state, packed_map, map_size_scaled, stencil, scan, res,
    motion=None, shift=None, generator=None, noise=None,
    noise_generator=None) on this rank's share of the state.  motion (4,)
    tx, ty, omega, dist propagates first (noise (n_local, 4) or drawn from
    noise_generator); none leaves the particles as they are."""
    comm = Collectives(mesh)
    local_chunk = math.gcd(_local_rows(mesh, n_max), chunk_size)
    class_weights = _pad_class_weights(params, num_classes)

    def step(state, packed_map, map_size_scaled, stencil, scan, res,
             motion=None, shift=None, generator=None, noise=None,
             noise_generator=None) -> FilterState:
        state = _propagate(state, params, motion, noise, noise_generator)
        p = state.particles
        costs_all, _ = score_all_rotations(
            packed_map, stencil, scan, class_weights.to(scan.device),
            p.pose_px(), p.scale, res, num_classes=num_classes,
            map_resolution=map_resolution, chunk_size=local_chunk,
        )
        w_raw, new_theta, have_init = compute_weights(
            costs_all, p, params, map_size_scaled, theta_bins)
        p = p.replace(theta=new_theta, have_init=have_init)
        return _sharded_tail(state, p, w_raw, comm, n_max, k_max, gmm_every,
                             theta_bins, shift, generator)

    return step


def _scored(score, params, comm, n_max, k_max, gmm_every, theta_bins):
    """step(state, maps, map_size_scaled, stencil, scan, res, *extra,
    motion=None, shift=None, generator=None, noise=None,
    noise_generator=None) around score(particles, maps, stencil, scan, res,
    *extra) -> (cost, theta): the fused propagate, the weights, then the
    sharded tail."""

    def step(state, maps, map_size_scaled, stencil, scan, res, *extra,
             motion=None, shift=None, generator=None, noise=None,
             noise_generator=None) -> FilterState:
        state = _propagate(state, params, motion, noise, noise_generator)
        cost, new_theta = score(state.particles, maps, stencil, scan, res,
                                *extra)
        p = state.particles.replace(
            theta=new_theta,
            have_init=torch.ones_like(state.particles.have_init),
        )
        w_raw = weight_from_cost(cost, p, params, map_size_scaled)
        return _sharded_tail(state, p, w_raw, comm, n_max, k_max, gmm_every,
                             theta_bins, shift, generator)

    return step


def make_sharded_step_multi(
    mesh: DeviceMesh,
    params: FilterParams,
    num_classes: int,
    map_resolution: float,
    theta_bins: int,
    n_max: int,
    mode: str,  # "tracked" | "init" | "mixed"
    bucket_level,
    k_max: int = 8,
    gmm_every: int = 1,
):
    """The multi-device unknown-scale step: each rank scores its rows
    with the K-bucket crop kernels against the replicated pyramid
    (filter/multiscale.py), the theta search through its raw rows
    (score_init_multi_raw) and select_init_cost, as the reference's mesh
    step does.  step(state, pyr, map_size_scaled, stencil, scan, res,
    slot_vals, shift=None, generator=None); the dispatch applies the
    pending propagate before it plans, so the step takes no motion."""
    if mode not in ("tracked", "init", "mixed"):
        raise ValueError(f"unknown crop mode {mode!r}")
    _local_rows(mesh, n_max)
    class_weights = _pad_class_weights(params, num_classes)
    num_rot = params.num_rot_search

    def score(p, pyr, stencil, scan, res, slot_vals):
        args = (pyr, num_classes, stencil, scan,
                class_weights.to(scan.device), p.pose_px())
        return _select_flavour(
            mode, p,
            lambda: ms.score_tracked_multi(
                *args, p.theta, p.scale, slot_vals, bucket_level, res,
                map_resolution),
            lambda: _raw_theta(ms.score_init_multi_raw(
                *args, p.scale, slot_vals, bucket_level, res, num_rot,
                map_resolution), num_rot),
        )

    return _scored(score, params, Collectives(mesh), n_max, k_max,
                   gmm_every, theta_bins)


def make_sharded_step_fast(
    mesh: DeviceMesh,
    params: FilterParams,
    num_classes: int,
    map_resolution: float,
    theta_bins: int,
    n_max: int,
    mode: str,  # "tracked" | "init" | "mixed"
    mo: int = 24,
    region: int = 128,
    window_w: int = 100,
    k_max: int = 8,
    gmm_every: int = 1,
):
    """The multi-device conv cost-field step (the clustered regime) with its
    fused propagate: each rank convolves ceil(region / n_dev) rows of the
    region's field (conv_score.cost_field's rows), one all-gather assembles
    it, and each rank reads its particles' rows of it.  The origin is the
    least alive centre over all ranks.  "mixed" runs both column sets in
    one conv (the kernels concatenated).  step(state, cmap, map_size_scaled,
    stencil, scan, res, scale, s0, motion=None, shift=None, generator=None,
    noise=None, noise_generator=None): scale is the uniform particle scale
    on the host, cmap a conv_score.ConvMap."""
    if mode not in ("tracked", "init", "mixed"):
        raise ValueError(f"unknown conv mode {mode!r}")
    _local_rows(mesh, n_max)
    comm = Collectives(mesh)
    class_weights = _pad_class_weights(params, num_classes)
    num_rot = params.num_rot_search
    flavours = [fl for fl in ("tracked", "init") if mode in (fl, "mixed")]
    rows_per = -(-region // comm.size)

    def score(p, cmap, stencil, scan, res, scale, s0):
        th, r = stencil.shape[:2]
        f = float(np.float32(scale) * np.float32(res))
        cw = class_weights.to(scan.device)
        cy, cx = cs.conv_centres(p.pose_px(), map_resolution, cmap.pad)
        oy, ox = cs.clamp_origin(*comm.pmin(*cs.alive_min(cy, cx, p.alive)),
                                 cmap, mo, region)
        cell = ((cy - oy).clamp(0, region - 1) * region
                + (cx - ox).clamp(0, region - 1))
        kernels = [cs.build_conv_kernel(scan, cw, stencil, f, mo, fl,
                                        num_rot, window_w, s0)
                   for fl in flavours]
        kernel = torch.cat(kernels)
        part = cs.cost_field(cmap.padded, kernel, torch.stack([oy, ox]), mo,
                             region,
                             rows=(comm.rank * rows_per, rows_per))
        field = comm.gather(part, dim=1)[:, :region].reshape(
            kernel.shape[0], -1)
        cols = dict(zip(flavours, field.split([k.shape[0] for k in kernels])))

        def read(fl):
            return cs.read_scores(cols[fl], cell, p.theta, fl, num_rot,
                                  window_w, s0, th, r)

        return _select_flavour(mode, p, lambda: read("tracked"),
                               lambda: _raw_theta(read("init"), num_rot))

    return _scored(score, params, comm, n_max, k_max, gmm_every, theta_bins)
