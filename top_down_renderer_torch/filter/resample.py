"""Systematic (low-variance) resampling (counterpart of
filter/resample.py).

Samples u_i = (i + shift) / n_new with one shared shift in [0, 1);
output slot i takes the first source j with cumsum(w)[j] > u_i, clamped
to the last alive source.  All N slots are computed; slots >= n_new are
marked dead.  Dead sources carry weight 0, so they are never selected.

Two formulations of the selected rows, chosen as in the reference by
TDR_RESAMPLE (resample_via) or by systematic_resample(via=...):
  gather  (default) source indices by a forward max-scan, then one row
          gather;
  pallas  each selected source's row scattered at its segment start,
          then the forward fill of csrc/fill_rows.cu (fill_rows; its
          plain version on CPU tensors).
Both give the same rows, bit for bit.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from top_down_renderer_torch import kernels
from top_down_renderer_torch.kernels import ptr
from top_down_renderer_torch.core.grids import Particles

VIAS = ("gather", "pallas")


def resample_via() -> str:
    """TDR_RESAMPLE=gather|pallas: the default formulation of the
    selected rows (the reference's scatter formulation is not ported)."""
    return os.environ.get("TDR_RESAMPLE", "gather")

_SCAN_ROW = 1024  # elements per row of the fixed-order cumsum


def _cumsum_fixed_order(w: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum of a 1-D tensor, added in the same order on every
    run.  CUDA scans a 1-D float tensor with a decoupled look-back whose
    association varies between runs, and the resample turns one flipped
    slot boundary into a different cloud.  Each row of a 2-D view is
    scanned by one block in a fixed order, and so are the row totals (at
    least two rows, so that neither scan is 1-D)."""
    n = w.shape[0]
    rows = max(2, -(-n // _SCAN_ROW))
    part = torch.cumsum(
        torch.nn.functional.pad(w, (0, rows * _SCAN_ROW - n)).view(
            rows, _SCAN_ROW
        ),
        1,
    )
    prev = torch.cat([torch.zeros_like(part[:1, -1]), part[:-1, -1]])
    offs = torch.cumsum(torch.stack([prev, torch.zeros_like(prev)]), 1)[0]
    return (part + offs[:, None]).reshape(-1)[:n]


def _systematic_indices(
    weights: torch.Tensor,
    n_new: torch.Tensor,
    n_active_old: torch.Tensor,
    shift,
) -> torch.Tensor:
    """Source index per output slot, from per-source output counts: the
    first output of source j is slot F[j-1], F[j] = #{i : u_i < csum[j]};
    segment starts are scattered and forward-filled with a cummax."""
    n = weights.shape[0]
    dev = weights.device
    csum = _cumsum_fixed_order(weights)
    nn = torch.clamp(n_new, min=1).to(torch.float32)
    f = torch.clamp(torch.ceil(csum * nn - shift), min=0.0)
    f = torch.minimum(f, nn).to(torch.int64)
    f_prev = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), f[:-1]])
    src = torch.arange(n, device=dev)
    # sources with no output go to the spare slot n, dropped below
    pos = torch.where(f > f_prev, f_prev, n)
    seg = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    seg = seg.scatter_reduce(0, pos, src, reduce="amax")[:n]
    j = torch.cummax(seg, 0).values
    return torch.minimum(j, torch.clamp(n_active_old.long() - 1, min=0))


def _segment_starts(
    packed: torch.Tensor,
    weights: torch.Tensor,
    n_new: torch.Tensor,
    n_active_old: torch.Tensor,
    shift,
):
    """(rows0 (N, 8), valid0 (N,)): each selected source's row at its
    first output slot.  Slot 0 is pinned valid: it is a segment start
    whenever any source is selected, and takes packed[0] otherwise (the
    degenerate all-zero weights), as the gather path's zero-based scan
    does."""
    n = weights.shape[0]
    dev = weights.device
    csum = _cumsum_fixed_order(weights)
    nn = torch.clamp(n_new, min=1).to(torch.float32)
    f = torch.clamp(torch.ceil(csum * nn - shift), min=0.0)
    f = torch.minimum(f, nn).to(torch.int64)
    f_prev = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), f[:-1]])
    src = torch.arange(n, device=dev)
    has = (f > f_prev) & (src < torch.clamp(n_active_old, min=1))
    pos = torch.where(has, f_prev, n)  # empty sources to the spare slot n
    rows0 = torch.zeros((n + 1, packed.shape[1]), dtype=packed.dtype,
                        device=dev)
    rows0[pos] = packed
    valid0 = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    valid0[pos] = True
    rows0, valid0 = rows0[:n], valid0[:n]
    rows0[0] = torch.where(valid0[0], rows0[0], packed[0])
    valid0[0] = True
    return rows0, valid0


def fill_rows_plain(rows0: torch.Tensor, valid0: torch.Tensor) -> torch.Tensor:
    """out[i] = rows0[max{j <= i : valid0[j]}] (row 0 if none): the index
    of the last valid slot by a cummax, then one row gather."""
    idx = torch.arange(rows0.shape[0], device=rows0.device)
    src = torch.cummax(torch.where(valid0, idx, 0), 0).values
    return rows0.index_select(0, src)


FILL_TILE = 1024  # slots per block of the fill kernel (kTile)
_EPOCHS = 2**30  # the kernel's status words hold epochs below this
# (device index, stream) -> [scratch (1 + tiles,) int64, last epoch]
_fill_scratch = {}


def _fill_status(dev: torch.device, tiles: int):
    """The fill kernel's scratch on this device and stream, and a fresh
    epoch for it.  The scratch is zeroed once when made (or grown, or when
    the epochs run out); every call after that gets the next epoch, so the
    status words of earlier calls read as unpublished and nothing is reset
    between calls."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    ent = _fill_scratch.get(key)
    if ent is None or ent[0].numel() < 1 + tiles or ent[1] + 1 >= _EPOCHS:
        ent = [torch.zeros(1 + tiles, dtype=torch.int64, device=dev), 0]
        _fill_scratch[key] = ent
    ent[1] += 1
    return ent[0], ent[1]


def fill_rows(rows0: torch.Tensor, valid0: torch.Tensor) -> torch.Tensor:
    """The forward fill of fill_rows_plain: on CPU tensors the plain
    version, on CUDA the kernel of csrc/fill_rows.cu (one pass over tiles
    of FILL_TILE slots with a decoupled look-back); any other device
    raises."""
    dev = rows0.device
    if not kernels.on_card(dev, "forward fill"):
        return fill_rows_plain(rows0, valid0)
    n = rows0.shape[0]
    if (rows0.dtype != torch.float32 or tuple(rows0.shape) != (n, 8)
            or not rows0.is_contiguous() or rows0.data_ptr() % 16):
        raise ValueError("rows0 must be a contiguous, aligned (N, 8) float32")
    if (valid0.dtype != torch.bool or tuple(valid0.shape) != (n,)
            or valid0.device != dev or not valid0.is_contiguous()):
        raise ValueError("valid0 must be a contiguous (N,) bool beside rows0")
    if not 1 <= n < 2**31 // 8:
        raise ValueError(f"fill of {n} rows is out of range")
    out = torch.empty_like(rows0)
    scratch, epoch = _fill_status(dev, -(-n // FILL_TILE))
    kernels.launch("fill_rows", "tdr_fill_rows", ptr(rows0), ptr(valid0), n,
                   ptr(out), ptr(scratch), ctypes.c_uint(epoch))
    kernels.LAUNCHES["fill_rows"] += 1
    return out


def pack_fields(p: Particles) -> torch.Tensor:
    """(N, 8) f32: init_px | d_m | theta | scale | last_dist | have_init."""
    return torch.cat(
        [
            p.init_px,
            p.d_m,
            p.theta[:, None],
            p.scale[:, None],
            p.last_dist[:, None],
            p.have_init.to(torch.float32)[:, None],
        ],
        dim=1,
    )


def unpack_fields(
    g: torch.Tensor, weight: torch.Tensor, alive: torch.Tensor
) -> Particles:
    return Particles(
        init_px=g[:, 0:2],
        d_m=g[:, 2:4],
        theta=g[:, 4],
        scale=g[:, 5],
        have_init=g[:, 7] > 0.5,
        weight=weight,
        last_dist=g[:, 6],
        alive=alive,
    )


def systematic_resample(
    particles: Particles,
    weights: torch.Tensor,
    n_new: torch.Tensor,
    n_active_old: torch.Tensor,
    shift=None,
    generator: Optional[torch.Generator] = None,
    via: Optional[str] = None,
) -> Particles:
    """The resampled set with n_new alive particles.  `shift` in [0, 1)
    replaces the uniform draw from `generator`; `via` ("gather" or
    "pallas") overrides resample_via()."""
    via = via or resample_via()
    if via not in VIAS:
        raise ValueError(f"resample via must be one of {VIAS}, got {via!r}")
    n = particles.n_max
    dev = weights.device
    if shift is None:
        shift = torch.rand((), generator=generator, device=dev)
    shift = torch.as_tensor(shift, dtype=torch.float32, device=dev)
    alive = torch.arange(n, device=dev) < n_new
    w_new = torch.where(alive, 1.0 / torch.clamp(n_new, min=1), 0.0)
    packed = pack_fields(particles)
    if via == "pallas":
        g = fill_rows(
            *_segment_starts(packed, weights, n_new, n_active_old, shift)
        )
    else:
        g = packed[_systematic_indices(weights, n_new, n_active_old, shift)]
    return unpack_fields(g, w_new.to(torch.float32), alive)
