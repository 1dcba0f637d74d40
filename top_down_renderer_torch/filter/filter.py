"""The particle filter step and its host dispatch (counterpart of
filter/filter.py).

One update: score (exact gather, the crop kernel at a uniform scale, the
conv cost field over a clustered cloud's region at a uniform scale, or
the K-bucket crop kernel under an unknown scale) -> per-particle tracked
/ theta-search cost -> weight 1/(cost + reg) with the force-on-map and
scale-range gates -> NaN repair and distance regularisation -> adaptive
particle count from the GMM -> systematic resample -> periodic GMM
refresh.

The step functions are plain functions of a FilterState.  Their random
draws (the resample shift here, the motion noise in particles.propagate)
come from a torch.Generator or are passed in by the caller, which is how
the tests feed both packages the same numbers.
"""

from __future__ import annotations

import functools
import logging
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from top_down_renderer_torch.config import FilterParams
from top_down_renderer_torch.core.grids import FilterState, Particles
from top_down_renderer_torch.filter import conv_score
from top_down_renderer_torch.filter import crop_score
from top_down_renderer_torch.filter import gmm as gmm_mod
from top_down_renderer_torch.filter import multiscale as ms
from top_down_renderer_torch.filter import particles as particles_mod
from top_down_renderer_torch.filter import stats as stats_mod
from top_down_renderer_torch.filter.resample import systematic_resample
from top_down_renderer_torch.filter.scoring import (
    rotation_shift,
    score_all_rotations,
    search_shifts,
    shift_mask,
)

FLT_MAX = float(np.finfo(np.float32).max)

logger = logging.getLogger(__name__)


def weight_from_cost(
    cost: torch.Tensor,
    particles: Particles,
    params: FilterParams,
    map_size_scaled: torch.Tensor,
) -> torch.Tensor:
    """cost -> raw weight 1/(cost + regularization), zeroed off the map
    (force_on_map) and, under unknown scale, outside the scale range."""
    weight = 1.0 / (cost + params.regularization)
    if params.force_on_map:
        center = particles.pose_px()
        off = (
            (center[:, 0] < 0)
            | (center[:, 1] < 0)
            | (center[:, 0] > map_size_scaled[0])
            | (center[:, 1] > map_size_scaled[1])
        )
        weight = torch.where(off, 0.0, weight)
    if params.fixed_scale < 0:
        bad_scale = (particles.scale < 10.0**params.scale_log_min) | (
            particles.scale > 10.0**params.scale_log_max
        )
        weight = torch.where(bad_scale, 0.0, weight)
    return weight


def select_init_cost(
    cost_search: torch.Tensor, num_rot: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Theta-search argmin: NaN never beats FLT_MAX, so an all-unknown
    window keeps (FLT_MAX, theta 0).  Returns (best_cost, best_theta)."""
    c = torch.where(torch.isnan(cost_search), FLT_MAX, cost_search)
    best_cost, k_best = torch.min(c, dim=1)
    return best_cost, k_best.to(torch.float32) * (2.0 * math.pi / num_rot)


def compute_weights(
    costs_all: torch.Tensor,
    particles: Particles,
    params: FilterParams,
    map_size_scaled: torch.Tensor,
    theta_bins: int,
):
    """Per-particle cost (own rotation if have_init, else the search
    argmin) -> (weight_raw, new_theta, have_init all True)."""
    s_tracked = rotation_shift(particles.theta, theta_bins)
    cost_tracked = costs_all.gather(1, s_tracked[:, None])[:, 0]
    ssh = search_shifts(theta_bins, params.num_rot_search, costs_all.device)
    best_cost, best_theta = select_init_cost(
        costs_all[:, ssh], params.num_rot_search
    )
    have = particles.have_init
    cost = torch.where(have, cost_tracked, best_cost)
    new_theta = torch.where(have, particles.theta, best_theta)
    weight = weight_from_cost(cost, particles, params, map_size_scaled)
    return weight, new_theta, torch.ones_like(have)


def postprocess_weights(
    weight_raw: torch.Tensor,
    last_dist: torch.Tensor,
    alive: torch.Tensor,
    n_active: torch.Tensor,
    psum=stats_mod.local,
) -> torch.Tensor:
    """NaN repair to (mean - bottom stddev), normalisation, and the
    distance regularisation toward uniform.  `psum` sums each stage's
    statistics over the shards of a sharded particle set
    (stats_mod.local: one set on one device)."""
    isnan = torch.isnan(weight_raw)
    valid = alive & ~isnan
    total, num_valid = psum(torch.where(valid, weight_raw, 0.0).sum(),
                            valid.to(torch.float32).sum())
    mean = total / torch.clamp(num_valid, min=1.0)
    under = valid & (weight_raw < mean)
    num_under, bot_sq = psum(
        under.to(torch.float32).sum(),
        torch.where(under, (weight_raw - mean) ** 2, 0.0).sum(),
    )
    bot_var = bot_sq / torch.clamp(num_under, min=1.0)
    degenerate = (total == 0) | (num_under < 1)
    repaired = torch.where(
        alive & isnan, mean - torch.sqrt(bot_var), weight_raw
    )
    w = torch.where(degenerate, 1.0, repaired)
    w = torch.where(alive, w, 0.0)
    w = w / psum(w.sum())
    d = torch.clamp(last_dist * 5.0, max=1.0)
    na = torch.clamp(torch.as_tensor(n_active).to(torch.float32), min=1.0)
    w = torch.where(alive, d * w + (1.0 - d) / na, 0.0)
    return w / psum(w.sum())


def pose_bbox(p: Particles) -> torch.Tensor:
    """(4,) min_x, min_y, max_x, max_y over alive particles."""
    pose = p.pose_px()
    alive = p.alive[:, None]
    mn = torch.where(alive, pose, 1e30).amin(0)
    mx = torch.where(alive, pose, -1e30).amax(0)
    return torch.cat([mn, mx])


def update_tail(
    state: FilterState,
    p: Particles,
    w_raw: torch.Tensor,
    n_max: int,
    k_max: int,
    gmm_every: int,
    theta_bins: int = 100,
    shift=None,
    generator: Optional[torch.Generator] = None,
) -> FilterState:
    """Post-scoring pipeline shared by every scoring path.  `shift`
    replaces the resample's uniform draw from `generator`."""
    w = postprocess_weights(w_raw, p.last_dist, p.alive, state.n_active)
    # the max-weight particle's state BEFORE resampling
    ml_state = p.ml_state()[torch.argmax(w)]
    n_new = gmm_mod.adaptive_particle_count(state.gmm, state.n_active, n_max)
    new_particles = systematic_resample(
        p, w, n_new, state.n_active, shift=shift, generator=generator
    )
    new_gmm = state.gmm
    if state.step % gmm_every == 0:
        new_gmm = gmm_mod.compute_gmm(
            new_particles, n_new, state.gmm.k, k_max=k_max
        )
    smask = shift_mask(
        rotation_shift(new_particles.theta, theta_bins),
        new_particles.alive,
        theta_bins,
    )
    return state.replace(
        particles=new_particles,
        n_active=n_new,
        ml_state=ml_state,
        gmm=new_gmm,
        step=state.step + 1,
        bbox=pose_bbox(new_particles),
        smask=smask,
    )


def _pad_class_weights(params: FilterParams, num_classes: int) -> torch.Tensor:
    cw = np.asarray(params.class_weights, dtype=np.float32)
    if cw.size < num_classes:
        cw = np.concatenate([cw, np.ones(num_classes - cw.size, np.float32)])
    return torch.as_tensor(cw[:num_classes])


def make_update_step(
    params: FilterParams,
    grid_num_classes: int,
    map_resolution: float,
    theta_bins: int,
    n_max: int,
    k_max: int = 8,
    gmm_every: int = 1,
    chunk_size: int = 2048,
):
    """The exact-gather update step: update(state, packed_map,
    map_size_scaled, stencil, scan, res, shift=None, generator=None)."""
    class_weights = _pad_class_weights(params, grid_num_classes)

    def update(
        state, packed_map, map_size_scaled, stencil, scan, res,
        shift=None, generator=None,
    ) -> FilterState:
        p = state.particles
        costs_all, _ = score_all_rotations(
            packed_map, stencil, scan, class_weights.to(scan.device),
            p.pose_px(), p.scale, res, num_classes=grid_num_classes,
            map_resolution=map_resolution, chunk_size=chunk_size,
        )
        w_raw, new_theta, have_init = compute_weights(
            costs_all, p, params, map_size_scaled, theta_bins
        )
        p = p.replace(theta=new_theta, have_init=have_init)
        return update_tail(
            state, p, w_raw, n_max, k_max, gmm_every, theta_bins,
            shift, generator,
        )

    return update


def _search_theta(sel, num_rot: int):
    """(best_cost, best_theta) from a crop theta search's (best, k, kf)."""
    best, k, _ = sel
    return best, k.to(torch.float32) * (2.0 * math.pi / num_rot)


def _raw_theta(raw, num_rot: int):
    """(best_cost, best_theta) from a theta search's raw rows (nums, dens
    (N, num_rot), kf): cost = num / den, NaN where kf < 0.5, then
    select_init_cost."""
    nums, dens, kf = raw
    costs = torch.where(kf[:, None] < 0.5, torch.nan, nums / dens)
    return select_init_cost(costs, num_rot)


def _select_flavour(mode: str, p: Particles, tracked, init):
    """(cost, theta) of one fast flavour: tracked() -> (num, den, kf) at
    each particle's own rotation, init() -> (best_cost, best_theta) of the
    theta search; "mixed" runs both with the exact path's per-particle
    select."""
    if mode != "init":
        num, den, kf = tracked()
        cost_t = torch.where(kf < 0.5, torch.nan, num / den)
        if mode == "tracked":
            return cost_t, p.theta
    best, theta_i = init()
    if mode == "init":
        return best, theta_i
    have = p.have_init
    return torch.where(have, cost_t, best), torch.where(have, p.theta, theta_i)


def _scored_step(score, params, n_max, k_max, gmm_every, theta_bins):
    """update(state, maps, map_size_scaled, stencil, scan, res, *extra,
    shift=None, generator=None) around score(particles, maps, stencil,
    scan, res, *extra) -> (cost, theta): weights, then the shared tail."""

    def update(
        state, maps, map_size_scaled, stencil, scan, res, *extra,
        shift=None, generator=None,
    ) -> FilterState:
        cost, new_theta = score(
            state.particles, maps, stencil, scan, res, *extra
        )
        p = state.particles.replace(
            theta=new_theta,
            have_init=torch.ones_like(state.particles.have_init),
        )
        w_raw = weight_from_cost(cost, p, params, map_size_scaled)
        return update_tail(
            state, p, w_raw, n_max, k_max, gmm_every, theta_bins,
            shift, generator,
        )

    return update


def make_update_step_fast(
    params: FilterParams,
    grid_num_classes: int,
    map_resolution: float,
    theta_bins: int,
    n_max: int,
    mode: str,  # "tracked" | "init" | "mixed"
    k_max: int = 8,
    gmm_every: int = 1,
    mip: int = 1,
    path: str = "crop",  # "crop" | "conv"
    mo: int = 24,
    region: int = 128,
    window_w: int = 100,
):
    """The fast update step for a uniform particle scale:
    update(state, maps, map_size_scaled, stencil, scan, res, scale=None,
    s0=0, shift=None, generator=None), where `scale`, if given, is the
    particles' scale on the host (else particle 0's is read on the card).
    mode "tracked" scores each particle at its own rotation, "init" runs
    the theta search, "mixed" both with the exact path's per-particle
    select.

    path "crop": the crop kernels, any spatial spread; `maps` is a
    crop_score.CropMap of the packed map at this mip level
    (crop_score.mip_map).  At mip > 1 the kernel sees f / mip at
    resolution map_resolution * mip: an NN granularity of mip px.

    path "conv": the conv cost field over a (region, region) block of
    centres (conv_score), for a clustered cloud; `maps` is a
    conv_score.ConvMap, mo the conv kernel's bucket, and the tracked
    flavour reads the shift window [s0, s0 + window_w).  The theta search
    feeds its (N, num_rot) costs, gated where kf < 0.5, to
    select_init_cost."""
    if mode not in ("tracked", "init", "mixed"):
        raise ValueError(f"unknown crop mode {mode!r}")
    if path not in ("crop", "conv") or (path == "conv" and mip != 1):
        raise ValueError(f"no fast path {path!r} at mip {mip}")
    class_weights = _pad_class_weights(params, grid_num_classes)
    num_rot = params.num_rot_search
    mres = map_resolution * mip
    if path == "conv":
        conv = {
            flavour: conv_score.make_conv_scorer(
                mo, region, flavour, num_rot, map_resolution, window_w)
            for flavour in ("tracked", "init")
            if mode in (flavour, "mixed")
        }

    def score(p: Particles, maps, stencil, scan, res, scale=None, s0=0):
        # the dispatch's host scale, every particle's at a fixed or frozen
        # scale, gives f in the same float32 steps as particle 0's on the
        # card, and lets a CropMap keep the stencil's fold (CropMap.fold)
        if scale is None:
            f = p.scale[0] * torch.as_tensor(
                res, dtype=torch.float32, device=scan.device
            ) / mip
        else:
            f = float(np.float32(scale) * np.float32(res) / np.float32(mip))
        cw = class_weights.to(scan.device)
        if path == "conv":
            args = (maps, stencil, scan, cw, p.pose_px(), p.theta, f,
                    p.alive)

            return _select_flavour(
                mode, p, lambda: conv["tracked"](*args, s0),
                lambda: _raw_theta(conv["init"](*args), num_rot))
        args = (grid_num_classes, stencil, scan, cw, p.pose_px())
        return _select_flavour(
            mode, p,
            lambda: crop_score.score_tracked(maps, *args, p.theta, f, mres),
            lambda: _search_theta(crop_score.score_init_sel(
                maps, *args, f, num_rot, mres), num_rot),
        )

    return _scored_step(score, params, n_max, k_max, gmm_every, theta_bins)


def make_update_step_multiscale(
    params: FilterParams,
    grid_num_classes: int,
    map_resolution: float,
    theta_bins: int,
    n_max: int,
    mode: str,  # "tracked" | "init" | "mixed"
    bucket_level: Tuple[int, ...],
    k_max: int = 8,
    gmm_every: int = 1,
):
    """The update step under an unknown scale: every particle scored by
    the K-bucket crop kernel (filter/multiscale.py) against its own
    bucket's offsets on its own pyramid level.
    update(state, pyr, map_size_scaled, stencil, scan, res, slot_vals,
    shift=None, generator=None): slot_vals (K,) are the bucket scales,
    bucket_level[b] bucket b's level in pyr.  Modes as in
    make_update_step_fast."""
    if mode not in ("tracked", "init", "mixed"):
        raise ValueError(f"unknown crop mode {mode!r}")
    class_weights = _pad_class_weights(params, grid_num_classes)
    num_rot = params.num_rot_search

    def score(p: Particles, pyr, stencil, scan, res, slot_vals):
        args = (pyr, grid_num_classes, stencil, scan,
                class_weights.to(scan.device), p.pose_px())
        return _select_flavour(
            mode, p,
            lambda: ms.score_tracked_multi(
                *args, p.theta, p.scale, slot_vals, bucket_level, res,
                map_resolution,
            ),
            lambda: _search_theta(ms.score_init_multi_sel(
                *args, p.scale, slot_vals, bucket_level, res, num_rot,
                map_resolution,
            ), num_rot),
        )

    return _scored_step(score, params, n_max, k_max, gmm_every, theta_bins)


class FastDispatch(NamedTuple):
    """The host plan of one known-scale update (ParticleFilter._fast_mode),
    in the reference's field order: mode, the crop or conv bucket mo, the
    host scale, path ("crop" | "conv"), the conv region, the tracked
    shift window [s0, s0 + ww), and the crop path's mip level."""

    mode: str
    mo: int
    scale: float
    path: str
    region: int
    s0: int
    ww: int
    mip: int


# the packed host snapshot's layout (_snapshot_vec)
_SNAP_BBOX = slice(0, 4)
_SNAP_NACT = 4
_SNAP_ML = slice(5, 9)
_SNAP_COV = slice(9, 25)
_SNAP_SMASK = slice(25, None)


def _snapshot_vec(state: FilterState, psum=stats_mod.local) -> torch.Tensor:
    """The small per-update values the host dispatch reads, in one float32
    vector, so that one copy to the host brings them all: bbox[4],
    n_active, mean-likelihood state[4], mean covariance[16],
    smask[Th].  psum: as in stats_mod, for a sharded state."""
    ml, cov = stats_mod.pose_stats(state.particles, state.n_active, psum)
    return torch.cat([
        state.bbox.to(torch.float32).reshape(4),
        torch.as_tensor(state.n_active).to(torch.float32).reshape(1),
        ml.to(torch.float32).reshape(4),
        cov.to(torch.float32).reshape(16),
        state.smask.to(torch.float32).reshape(-1),
    ])


class MultiDispatch(NamedTuple):
    """The host plan of one unknown-scale update (ParticleFilter._multi_mode):
    mode, crop bucket mo, slot values (kp,) float32, pyramid levels (mips),
    each bucket's level index, and the padded bucket count kp."""

    mode: str
    mo: int
    slots: np.ndarray
    levels: Tuple[int, ...]
    bmi: Tuple[int, ...]
    kp: int


class ParticleFilter:
    """Host-facing filter with the reference ParticleFilter API.

    Every tensor lives on `device` (default: the map's).  Random draws
    come from one torch.Generator on that device, seeded with `seed`;
    the initial cloud comes from numpy's generator with the same seed,
    as in the reference package.

    Dispatch per update: at a known scale (fixed or frozen) the conv cost
    field scores a cloud whose alive bounding box fits a conv region (and
    whose block fits the padded map), else the crop kernel scores it, on a
    mip of the map when scale * res exceeds the crop buckets; at an
    unknown scale the K-bucket crop kernel scores it on a mip pyramid
    (_multi_mode).  The exact step runs only where the reference also
    falls back: no crop bucket even at mip 32, alive scales beyond the
    clustering ladder, or a live scale bucket beyond mip 64.

    mesh: a 1-D DeviceMesh (parallel.sharding.make_mesh) shards the
    particle axis over the ranks of the process group, one process per
    rank: each rank builds the same filter and calls the same methods in
    the same order.  n_max is padded to a multiple of the mesh size, and
    `state` holds this rank's rows of the particles (every other field
    replicated).  Every rank plans each update from values that are the
    same on every rank, so all issue the same collectives: the dispatch
    runs the K-bucket step (unknown scale) or the row-sharded conv cost
    field (a clustered cloud, where the reference's mesh runs one), and
    otherwise the sharded exact step, whose fused propagate takes the
    pending motion (parallel/sharding.py).  The resample shift comes from
    `generator`, seeded alike on every rank; the propagate noise from one
    seeded by (seed, rank).  The queries return the global answer on every
    rank."""

    def __init__(
        self,
        n_max: int,
        tdmap,  # maps.map.TopDownMap
        params: FilterParams,
        seed: int = 0,
        theta_bins: int = 100,
        gmm_every: int = 10,
        chunk_size: int = 2048,
        device=None,
        mesh=None,
    ):
        chunk_size = min(chunk_size, n_max)
        n_max = -(-n_max // chunk_size) * chunk_size
        self.mesh = mesh
        if mesh is not None:
            # a mesh-size multiple too, so that the rows shard evenly
            n_max = -(-n_max // mesh.size()) * mesh.size()
        self.n_max = n_max
        self.map = tdmap
        self.params = params
        self.theta_bins = theta_bins
        self.chunk_size = chunk_size
        self.gmm_every = gmm_every
        self.seed = seed
        self.device = torch.device(device) if device else tdmap.device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        # the sum of per-particle statistics over the shards of the state
        self._psum = stats_mod.local
        self._sharded_fns = {}
        if mesh is not None:
            from top_down_renderer_torch.parallel import sharding

            if self.device.type != mesh.device_type:
                raise ValueError(f"the map is on {self.device}, the mesh on "
                                 f"{mesh.device_type}")
            self._comm = sharding.Collectives(mesh)
            self._psum = self._comm.psum
            self._noise_generator = torch.Generator(device=self.device)
            self._noise_generator.manual_seed(
                sharding.rank_seed(seed, self._comm.rank))
        self.state: Optional[FilterState] = None
        self._update_fn = None
        self._fast_fns = {}
        self._maps_cache = {}
        self._pyramid_cache = {}
        self._map_version = 0
        self._consts = None
        self._pending_motion = None
        self._all_have_init = False
        self._scale_frozen_host = False
        self._frozen_scale_cache = -1.0
        self._slow_reason = None
        self._snap = None  # (state, its _snapshot_vec on the host)
        # rotation and distance since the last update, for _shift_window
        self._last_omega = 0.0
        self._last_dist_m = 0.0
        self._last_map_center = np.zeros(2, dtype=np.int64)
        if tdmap.have_map:
            self.initialize_particles()

    # -- lifecycle -----------------------------------------------------
    def initialize_particles(self) -> None:
        """Initial cloud (metric init position converted to px first)."""
        params = self.params
        g = self.map.grid
        map_size_scaled = (
            np.array([g.width, g.height], dtype=np.float32)
            * self.map.resolution
        )
        if params.fixed_scale >= 0 and math.isfinite(params.init_pos_m_x):
            center = g.map_center.cpu().numpy()
            px = params.init_pos_m_x * params.fixed_scale + center[0]
            py = params.init_pos_m_y * params.fixed_scale + center[1]
            if not (0 <= px < g.width and 0 <= py < g.height):
                print("[tdr-torch] No map received for input loc")
                return
            near_road = any(
                1 in self.map.get_classes_at_point((px + dx, py + dy))
                for dx in range(-4, 5)
                for dy in range(-4, 5)
            )
            if not near_road:
                print("[tdr-torch] No road in map at init location")
                return
            params.init_pos_px_x = float(px)
            params.init_pos_px_y = float(py)

        self._all_have_init = False
        parts, n_active = particles_mod.initialize_particles(
            self.n_max,
            g.road_ok.cpu().numpy(),
            map_size_scaled,
            self.map.resolution,
            params,
            seed=self.seed,
            device=self.device,
        )
        frozen = params.fixed_scale >= 0
        self._scale_frozen_host = frozen
        self._frozen_scale_cache = params.fixed_scale if frozen else -1.0
        n_act = torch.tensor(n_active, dtype=torch.int32, device=self.device)
        self.state = FilterState(
            particles=parts,
            n_active=n_act,
            scale_frozen=torch.tensor(frozen, device=self.device),
            frozen_scale=torch.tensor(
                params.fixed_scale if frozen else -1.0,
                dtype=torch.float32,
                device=self.device,
            ),
            ml_state=parts.ml_state()[0],
            gmm=gmm_mod.compute_gmm(
                parts, n_act, torch.tensor(1, device=self.device)
            ),
            step=0,
            bbox=pose_bbox(parts),
            smask=shift_mask(
                rotation_shift(parts.theta, self.theta_bins),
                parts.alive,
                self.theta_bins,
            ),
        )
        if self.mesh is None:
            make = make_update_step
        else:
            from top_down_renderer_torch.parallel import sharding

            self.state = sharding.shard_filter_state(self.state, self.mesh)
            make = functools.partial(sharding.make_sharded_step, self.mesh)
        self._update_fn = make(
            params,
            g.num_classes,
            self.map.resolution,
            self.theta_bins,
            self.n_max,
            gmm_every=self.gmm_every,
            chunk_size=self.chunk_size,
        )

    # -- step ----------------------------------------------------------
    def propagate(self, trans, omega) -> None:
        """Record a body-frame motion; applied at the next update().
        Successive calls compose: the new translation is rotated by the
        accumulated omega, omegas and noise-scaling distances add."""
        if self.state is None:
            return
        t = np.asarray(trans, dtype=np.float64).reshape(-1)
        d = float(np.hypot(t[0], t[1]))
        self._last_omega += float(omega)
        self._last_dist_m += d
        t2 = np.asarray(trans, np.float32).reshape(2)
        if self._pending_motion is None:
            self._pending_motion = (t2, float(omega), d)
        else:
            t0, o0, d0 = self._pending_motion
            c, s = math.cos(o0), math.sin(o0)
            t_rot = np.asarray(
                [c * t2[0] - s * t2[1], s * t2[0] + c * t2[1]], np.float32
            )
            self._pending_motion = (t0 + t_rot, o0 + float(omega), d0 + d)

    def _pop_motion(self):
        """The pending motion (4,) tx, ty, omega, dist, cleared, or None."""
        if self._pending_motion is None:
            return None
        trans, omega, dist = self._pending_motion
        self._pending_motion = None
        return np.asarray([trans[0], trans[1], omega, dist], np.float32)

    def _apply_pending_motion(self) -> None:
        """Propagate the pending motion now, with noise from the filter's
        generator (under a mesh: this rank's)."""
        motion = self._pop_motion()
        if motion is None:
            return
        parts = particles_mod.propagate(
            self.state.particles,
            motion[:2],
            motion[2],
            self.params,
            self.state.scale_frozen,
            dist=motion[3],
            generator=(self.generator if self.mesh is None
                       else self._noise_generator),
        )
        self.state = self.state.replace(particles=parts)

    def _slow_path(self, reason: str):
        if reason != self._slow_reason:
            self._slow_reason = reason
            logger.warning("scoring with the exact gather: %s", reason)
        return None

    def _crop_mode(self) -> str:
        """tracked if every alive particle has a theta, init if none has,
        else mixed."""
        if self._all_have_init:
            return "tracked"
        p = self.state.particles
        if self.mesh is None:
            have = p.have_init[p.alive]
            if bool(have.all()):
                return "tracked"
            return "init" if not bool(have.any()) else "mixed"
        # under a mesh: the counts over every rank, in one collective
        with_theta, without = self._psum(torch.stack([
            (p.alive & p.have_init).sum(), (p.alive & ~p.have_init).sum()
        ])).tolist()
        if not without:
            return "tracked"
        return "init" if not with_theta else "mixed"

    def _host_snapshot(self) -> np.ndarray:
        """The current state's _snapshot_vec on the host (layout _SNAP_*):
        one copy from the card per state, kept for further reads."""
        if self._snap is None or self._snap[0] is not self.state:
            self._snap = (self.state, _snapshot_vec(
                self.state, self._psum).cpu().numpy())
        return self._snap[1]

    def _alive_scales(self) -> np.ndarray:
        """The alive particles' scales on the host (under a mesh: every
        rank's, gathered, in rank order)."""
        p = self.state.particles
        if self.mesh is None:
            return p.scale[p.alive].cpu().numpy()
        g = self._comm.gather(torch.stack(
            [p.scale, p.alive.to(torch.float32)], 1)).cpu().numpy()
        return g[g[:, 1] > 0.5, 0]

    def _conv_region(self, mo: int):
        """The conv region bucket of the alive bounding box, or None where
        it fits no bucket or the conv block (region + kernel - 1) does not
        fit the map with its MAP_PAD border."""
        snap = self._host_snapshot()
        if snap[_SNAP_NACT] <= 0:
            return None
        bb = snap[_SNAP_BBOX] / self.map.resolution
        extent = int(np.ceil(max(bb[2] - bb[0], bb[3] - bb[1]))) + 2
        region = conv_score.pick_region(extent)
        dr, dc = conv_score.conv_dims(mo)
        g = self.map.grid
        if region is None or (
            region + dr - 1 > g.height + 2 * conv_score.MAP_PAD
            or region + dc - 1 > g.width + 2 * conv_score.MAP_PAD
        ):
            return None
        return region

    def _shift_window(self):
        """Smallest circular shift window (s0, ww) covering the live shifts
        (the state's smask), padded for this step's rotation and 3 sigma
        of its theta noise, bucketed to {16, 32, 64, theta_bins}."""
        th = self.theta_bins
        present = np.nonzero(self._host_snapshot()[_SNAP_SMASK] > 0.5)[0]
        if len(present) == 0 or len(present) == th:
            return 0, th
        # the largest circular gap between consecutive live shifts
        gaps = np.diff(np.concatenate([present, [present[0] + th]]))
        gi = int(np.argmax(gaps))
        span = th - int(gaps[gi])  # the covered arc, bins - 1
        start = int(present[(gi + 1) % len(present)])
        noise3 = 3.0 * self.params.theta_cov * self._last_dist_m
        margin = int(np.ceil(abs(self._last_omega) * th / (2 * np.pi))) + max(
            3, int(np.ceil(noise3 * th / (2 * np.pi))))
        need = span + 1 + 2 * margin
        for ww in (16, 32, 64):
            if need <= ww:
                return int((start - margin - (ww - need) // 2) % th), ww
        return 0, th

    def _fast_mode(self, res: float):
        """Host dispatch: a FastDispatch for the conv or crop step, a
        MultiDispatch for the K-bucket step (unknown scale), or None for
        the exact step.  The conv branch reads the state's bounding box
        and smask to the host in one packed read (_host_snapshot)."""
        if self.params.fixed_scale > 0:
            scale = self.params.fixed_scale
        elif self._scale_frozen_host:
            scale = self._frozen_scale_cache
        else:
            return self._multi_mode(res)
        mode = self._crop_mode()
        range_bins = self.map.stencil.shape[1]
        mo_conv = crop_score.pick_crop_size(
            scale * res, range_bins, crop_score._MO_BUCKETS_CONV)
        region = None if mo_conv is None else self._conv_region(mo_conv)
        if region is not None:
            # mixed: the smask predates the partial reinit, whose fresh
            # thetas are not in it, so the window is the full one
            s0, ww = (0, self.theta_bins) if mode == "mixed" else (
                self._shift_window())
            self._slow_reason = None
            return FastDispatch(mode, mo_conv, scale, "conv", region, s0, ww,
                                1)
        for mip in (1, 2, 4, 8, 16, 32):
            mo = crop_score.pick_crop_size(scale * res / mip, range_bins)
            if mo is not None:
                self._slow_reason = None
                return FastDispatch(mode, mo, scale, "crop", 0, 0,
                                    self.theta_bins, mip)
        return self._slow_path(
            "scale*res=%.3g exceeds every crop bucket even at mip 32"
            % (scale * res)
        )

    def _multi_mode(self, res: float):
        """Unknown-scale dispatch: cluster the alive scales into at most
        MAX_BUCKETS slots and plan the K-bucket step (MultiDispatch), or
        None for the exact step.  The pending motion is applied first:
        its 2 %/step scale diffusion must be in the scales clustered.
        Copies the alive scales to the host."""
        self._apply_pending_motion()
        mode = self._crop_mode()
        scales = self._alive_scales()
        if scales.size == 0:
            return self._slow_path("no alive particles with scale > 0")
        plan = ms.plan_buckets(
            scales, self.map.stencil.shape[1], res,
            10.0**self.params.scale_log_max,
        )
        if isinstance(plan, str):
            return self._slow_path(plan)
        mo, slots, mips = plan
        levels = tuple(sorted(set(mips)))
        self._slow_reason = None
        return MultiDispatch(
            mode, mo, slots, levels, tuple(levels.index(m) for m in mips),
            len(slots),
        )

    def _get_pyramid_maps(self, levels) -> ms.PyramidMaps:
        key = (self._map_version, tuple(levels))
        if key not in self._pyramid_cache:
            self._pyramid_cache[key] = ms.build_pyramid_maps(
                self.map.grid.dist.to(self.device), levels
            )
        return self._pyramid_cache[key]

    def _get_multi_fn(self, mode: str, bmi: Tuple[int, ...]):
        key = ("multi", mode, bmi)
        if key not in self._fast_fns:
            self._fast_fns[key] = make_update_step_multiscale(
                self.params,
                self.map.grid.num_classes,
                self.map.resolution,
                self.theta_bins,
                self.n_max,
                mode,
                bmi,
                gmm_every=self.gmm_every,
            )
        return self._fast_fns[key]

    def _get_map(self, mip: int) -> crop_score.CropMap:
        """The packed map at this mip level with its compact copy, per
        map version."""
        key = (self._map_version, mip)
        if key not in self._maps_cache:
            self._maps_cache[key] = crop_score.CropMap(crop_score.mip_map(
                self.map.grid.dist.to(self.device), mip
            ))
        return self._maps_cache[key]

    def _get_conv_map(self) -> conv_score.ConvMap:
        """The conv path's padded compact map, per map version."""
        key = (self._map_version, "conv")
        if key not in self._maps_cache:
            self._maps_cache[key] = conv_score.ConvMap(
                self._get_map(1).compact(self.map.grid.num_classes))
        return self._maps_cache[key]

    def _get_fast_fn(self, mode: str, mo: int, path: str = "crop",
                     region: int = 0, window_w: int = 100, mip: int = 1):
        key = (mode, mo, path, region, window_w, mip)
        if key not in self._fast_fns:
            self._fast_fns[key] = make_update_step_fast(
                self.params,
                self.map.grid.num_classes,
                self.map.resolution,
                self.theta_bins,
                self.n_max,
                mode,
                gmm_every=self.gmm_every,
                mip=mip,
                path=path,
                mo=mo,
                region=region,
                window_w=window_w,
            )
        return self._fast_fns[key]

    def _device_consts(self):
        """(map_size_scaled, stencil) on the device, per map version."""
        if self._consts is None or self._consts[0] != self._map_version:
            g = self.map.grid
            mss = torch.tensor(
                [g.width, g.height], dtype=torch.float32, device=self.device
            ) * self.map.resolution
            sten = torch.as_tensor(self.map.stencil, device=self.device)
            self._consts = (self._map_version, mss, sten)
        return self._consts[1], self._consts[2]

    def _get_sharded_fast_fn(self, mode: str, mo: int, region: int,
                             window_w: int, use_s2d: bool):
        """The sharded conv step, cached under the reference's key (its
        use_s2d names the reference's formulation; the port's is direct)."""
        key = (mode, mo, region, window_w, use_s2d, self._map_version)
        if key not in self._sharded_fns:
            from top_down_renderer_torch.parallel import sharding

            self._sharded_fns[key] = sharding.make_sharded_step_fast(
                self.mesh, self.params, self.map.grid.num_classes,
                self.map.resolution, self.theta_bins, self.n_max, mode,
                mo=mo, region=region, window_w=window_w,
                gmm_every=self.gmm_every,
            )
        return self._sharded_fns[key]

    def _get_sharded_multi_fn(self, mode: str, kp: int, bmi, mo: int):
        """The sharded K-bucket step, cached under the reference's key."""
        key = ("multi", mode, kp, bmi, mo)
        if key not in self._sharded_fns:
            from top_down_renderer_torch.parallel import sharding

            self._sharded_fns[key] = sharding.make_sharded_step_multi(
                self.mesh, self.params, self.map.grid.num_classes,
                self.map.resolution, self.theta_bins, self.n_max, mode, bmi,
                gmm_every=self.gmm_every,
            )
        return self._sharded_fns[key]

    def _update_sharded(self, scan, res, map_size_scaled, stencil) -> None:
        """The mesh's update, planned as the reference's _update_sharded
        plans it: the K-bucket step for a multi plan (its pending motion
        applied while planning), the row-sharded conv step for a conv plan
        where the reference's mesh runs one (its s2d fold, or its direct
        conv when the region's rows split evenly over the ranks), else the
        sharded exact step; the conv and exact steps take the pending
        motion in their fused propagate."""
        fast = self._fast_mode(float(res))
        motion = self._pop_motion()
        draws = dict(generator=self.generator,
                     noise_generator=self._noise_generator)
        if isinstance(fast, MultiDispatch):
            self.state = self._get_sharded_multi_fn(
                fast.mode, fast.kp, fast.bmi, fast.mo,
            )(
                self.state, self._get_pyramid_maps(fast.levels),
                map_size_scaled, stencil, scan, res,
                torch.as_tensor(fast.slots, device=self.device),
                generator=self.generator,
            )
            return
        if fast is not None and fast.path == "conv":
            num_rot = self.params.num_rot_search
            s_out = {"tracked": 2 * fast.ww + 1, "init": 2 * num_rot + 1,
                     "mixed": 2 * fast.ww + 2 * num_rot + 2}[fast.mode]
            use_s2d = conv_score.s2d_gate(fast.mo, s_out)
            if use_s2d or fast.region % self.mesh.size() == 0:
                self.state = self._get_sharded_fast_fn(
                    fast.mode, fast.mo, fast.region, fast.ww, use_s2d,
                )(
                    self.state, self._get_conv_map(), map_size_scaled,
                    stencil, scan, res, fast.scale, fast.s0, motion=motion,
                    **draws,
                )
                return
        self.state = self._update_fn(
            self.state, self.map.grid.dist.to(self.device), map_size_scaled,
            stencil, scan, res, motion=motion, **draws,
        )

    def update(self, scan, res) -> None:
        """scan: (C, Theta, R) polar semantic render; res: range m/bin."""
        if self.state is None or self.n_active_host() == 0:
            return
        map_size_scaled, stencil = self._device_consts()
        scan = torch.as_tensor(scan, dtype=torch.float32, device=self.device)
        if self.mesh is not None:
            self._update_sharded(scan, res, map_size_scaled, stencil)
            self._all_have_init = True
            self._last_omega = 0.0
            self._last_dist_m = 0.0
            return
        fast = self._fast_mode(float(res))
        self._apply_pending_motion()  # done already on the multi branch
        if fast is None:
            self.state = self._update_fn(
                self.state, self.map.grid.dist.to(self.device),
                map_size_scaled, stencil, scan, res,
                generator=self.generator,
            )
        elif isinstance(fast, MultiDispatch):
            slots = torch.as_tensor(fast.slots, device=self.device)
            self.state = self._get_multi_fn(fast.mode, fast.bmi)(
                self.state, self._get_pyramid_maps(fast.levels),
                map_size_scaled, stencil, scan, res, slots,
                generator=self.generator,
            )
        elif fast.path == "conv":
            self.state = self._get_fast_fn(
                fast.mode, fast.mo, "conv", fast.region, fast.ww,
            )(
                self.state, self._get_conv_map(), map_size_scaled, stencil,
                scan, res, fast.scale, fast.s0, generator=self.generator,
            )
        else:
            self.state = self._get_fast_fn(
                fast.mode, fast.mo, mip=fast.mip,
            )(
                self.state, self._get_map(fast.mip), map_size_scaled,
                stencil, scan, res, fast.scale, generator=self.generator,
            )
        # every scoring path sets have_init for all particles
        self._all_have_init = True
        self._last_omega = 0.0
        self._last_dist_m = 0.0

    # -- queries -------------------------------------------------------
    def n_active_host(self) -> int:
        return int(self.state.n_active)

    def num_particles(self) -> int:
        return self.n_active_host() if self.state is not None else 0

    def mean_likelihood(self) -> np.ndarray:
        return stats_mod.mean_likelihood(
            self.state.particles, self.state.n_active, self._psum
        ).cpu().numpy()

    def compute_mean_cov(self) -> np.ndarray:
        return stats_mod.compute_mean_cov(
            self.state.particles, self.state.n_active, self._psum
        ).cpu().numpy()

    def pose_stats(self):
        """(mean_likelihood (4,), mean_cov (4, 4)) as float64 numpy."""
        ml, cov = stats_mod.pose_stats(
            self.state.particles, self.state.n_active, self._psum
        )
        return (
            ml.cpu().numpy().astype(np.float64),
            cov.cpu().numpy().astype(np.float64),
        )

    def max_likelihood(self) -> np.ndarray:
        return self.state.ml_state.cpu().numpy()

    def get_gmm(self):
        g = self.state.gmm
        k = int(g.k)
        return g.means[:k].cpu().numpy(), g.covs[:k].cpu().numpy()

    def freeze_scale(self) -> None:
        """Lock every particle to the geometric-mean scale."""
        if self.state is None or self._scale_frozen_host:
            return
        p = self.state.particles
        m = p.alive.cpu().numpy().astype(np.float64)
        logs = np.where(
            m > 0, np.log(np.maximum(p.scale.cpu().numpy(), 1e-30)), 0.0
        )
        total, count = self._psum(torch.tensor(
            [logs.sum(), m.sum()], dtype=torch.float64, device=self.device
        )).tolist()
        geo_mean = float(np.exp(total / max(count, 1.0)))
        self.state = self.state.replace(
            particles=p.replace(scale=torch.full_like(p.scale, geo_mean)),
            scale_frozen=torch.tensor(True, device=self.device),
            frozen_scale=torch.tensor(
                geo_mean, dtype=torch.float32, device=self.device
            ),
        )
        self._scale_frozen_host = True
        self._frozen_scale_cache = geo_mean
        print(f"[tdr-torch] scale converged and locked to {geo_mean}")

    def scale(self) -> float:
        if self.params.fixed_scale > 0:
            return self.params.fixed_scale
        if self.state is not None and self._scale_frozen_host:
            return self._frozen_scale_cache
        return -1.0

    # -- dynamic map ---------------------------------------------------
    def update_map(self, ind_img, map_center) -> None:
        """New map from a class index image; particles shift with the
        map centre."""
        self.map.update_map(ind_img, map_center)
        self._map_version += 1
        self._maps_cache.clear()
        self._pyramid_cache.clear()
        delta = np.asarray(map_center) - self._last_map_center
        if self.state is not None:
            p = self.state.particles
            shift = torch.as_tensor(
                delta, dtype=torch.float32, device=self.device
            )
            self.state = self.state.replace(
                particles=p.replace(init_px=p.init_px + shift[None, :])
            )
        self._last_map_center = np.asarray(map_center, dtype=np.int64)
        if self.state is None or self.n_active_host() == 0:
            self.initialize_particles()
