"""Posterior statistics over the alive particles (counterpart of
filter/stats.py): unweighted means and covariances of the mlState
(x_px, y_px, theta, scale), theta handled circularly.

Each takes `psum`, which sums its arguments, tensors of per-particle sums,
over every shard of a particle set sharded over ranks
(parallel/sharding.py); the default, one set on one device, returns them
as they are."""

from __future__ import annotations

import torch

from top_down_renderer_torch.core.geometry import wrap_angle
from top_down_renderer_torch.core.grids import Particles


def local(*sums: torch.Tensor):
    """The psum of a particle set on one device: the sums themselves (one
    tensor for one argument, else a tuple)."""
    return sums if len(sums) > 1 else sums[0]


def mean_likelihood(particles: Particles, n_active, psum=local) -> torch.Tensor:
    """(4,) mean over alive particles; theta is atan2(mean sin, mean cos)."""
    ml = particles.ml_state()
    m = particles.alive.to(torch.float32)
    cnt = torch.clamp(torch.as_tensor(n_active).to(torch.float32), min=1.0)
    total, cos_t, sin_t = psum(
        (ml * m[:, None]).sum(0),
        (torch.cos(ml[:, 2]) * m).sum(),
        (torch.sin(ml[:, 2]) * m).sum(),
    )
    mean = total / cnt
    cos_s, sin_s = cos_t / cnt, sin_t / cnt
    return torch.cat([mean[:2], torch.atan2(sin_s, cos_s)[None], mean[3:]])


def _cov_around(particles: Particles, center, n_active, psum) -> torch.Tensor:
    d = particles.ml_state() - center[None, :]
    d = torch.cat([d[:, :2], wrap_angle(d[:, 2:3]), d[:, 3:]], dim=1)
    d = d * particles.alive.to(torch.float32)[:, None]
    na = torch.as_tensor(n_active).to(torch.float32)
    return psum(d.T @ d) / torch.clamp(na - 1.0, min=1.0)


def compute_mean_cov(particles: Particles, n_active, psum=local) -> torch.Tensor:
    """4x4 covariance about the mean-likelihood state."""
    return _cov_around(
        particles, mean_likelihood(particles, n_active, psum), n_active, psum
    )


def pose_stats(particles: Particles, n_active, psum=local):
    """(mean_likelihood (4,), mean_cov (4, 4))."""
    mean = mean_likelihood(particles, n_active, psum)
    return mean, _cov_around(particles, mean, n_active, psum)


def compute_cov(particles: Particles, ml_state, n_active,
                psum=local) -> torch.Tensor:
    """4x4 covariance about the max-likelihood particle state."""
    return _cov_around(particles, ml_state, n_active, psum)
