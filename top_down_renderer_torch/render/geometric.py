"""Geometric (slope-based) top-down scan rasterizers (counterpart of
render/geometric.py).

The reference walks each theta bin (far to near) or each column of an
organised cloud with a "last point was a high gradient" carry.  After a
point that carry equals (slope > 1) for that point, so the walk is
data-parallel: an obstacle at i where slope_i > 1, ground at i where
slope_i < 0.3 and not slope_{i-1} > 1, the slopes taken between
consecutive points of one bin or column.  The ground spans become a
difference array and a cumsum (polar) or a bounded fan-out of line steps
(Cartesian).

Every event that is dropped (padding, out of the grid) is masked out
before the scatter-add: torch indexing raises on out-of-range indices
and wraps negative ones, where the reference's scatter drops them.
Scales come as 0-dim tensors on the points' device (semantic._as_scalar),
so a changing range scale costs no host round trip.
"""

from __future__ import annotations

import torch

from top_down_renderer_torch.render.semantic import _as_scalar, _histogram


def _prev(a: torch.Tensor, same: torch.Tensor, fill) -> torch.Tensor:
    """a of the previous point where `same`, else fill."""
    return torch.where(same, torch.roll(a, 1), fill)


def render_geometric_polar(
    points,
    res,
    ang_res,
    theta_bins: int = 100,
    range_bins: int = 25,
) -> torch.Tensor:
    """Polar geometric render -> (2, theta_bins, range_bins) f32 on the
    points' device: channel 0 ground coverage, channel 1 vertical
    obstacles."""
    points = torch.as_tensor(points, dtype=torch.float32)
    dev = points.device
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    valid = ~((x == 0) & (y == 0))
    theta = torch.atan2(x, y)
    r = torch.sqrt(x * x + y * y)
    theta_ind = torch.clamp(
        torch.round(theta / _as_scalar(ang_res, points)).to(torch.int32)
        + theta_bins // 2,
        0,
        theta_bins - 1,
    )
    theta_ind = torch.where(valid, theta_ind, theta_bins)  # invalid last

    # by (theta_ind ascending, r descending), ties in input order: two
    # stable sorts, the secondary key first
    o1 = torch.sort(-r, stable=True).indices
    order = o1[torch.sort(theta_ind[o1], stable=True).indices]
    xs, ys, zs, rs = x[order], y[order], z[order], r[order]
    tb, vs = theta_ind[order], valid[order]
    r_ind = torch.round(rs / _as_scalar(res, points)).to(torch.int32)

    # the previous point of the same bin, else the walk's origin (0, 0, 0)
    same = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                      (tb[1:] == tb[:-1]) & vs[:-1]])
    dx, dy = xs - _prev(xs, same, 0.0), ys - _prev(ys, same, 0.0)
    dist = torch.sqrt(dx * dx + dy * dy)
    slope = torch.abs(zs - _prev(zs, same, 0.0)) / dist  # IEEE inf / nan
    prev_r_ind = _prev(r_ind, same, 0)
    last_high_grad = same & (_prev(slope, same, 0.0) > 1.0)

    obstacle = vs & (slope > 1.0) & (r_ind >= 0) & (r_ind < range_bins)
    ground = vs & (slope < 0.3) & ~last_high_grad
    img1 = _histogram(tb * range_bins + r_ind, obstacle,
                      theta_bins * range_bins, dev)

    # ground span [prev_r_ind, r_ind] clipped below range_bins: +1 at its
    # start, -1 past its end, then a cumsum along r
    end = torch.clamp(r_ind, max=range_bins - 1)
    span = ground & (prev_r_ind <= end) & (prev_r_ind < range_bins)
    row = tb * (range_bins + 1)
    size = theta_bins * (range_bins + 1)
    diff = (_histogram(row + prev_r_ind, span, size, dev)
            - _histogram(row + end + 1, span, size, dev))
    img0 = torch.cumsum(diff.reshape(theta_bins, range_bins + 1), 1)
    return torch.stack([img0[:, :range_bins],
                        img1.reshape(theta_bins, range_bins)])


def render_geometric_cartesian(
    cloud,
    res,
    width: int,
    height: int,
    max_interp: int = 64,
) -> torch.Tensor:
    """Cartesian geometric render of an organised cloud (H_c, W_c, 3) xyz,
    (0, 0, z) marking invalid points -> (2, height, width) f32.  Walks up
    each column, classifying the slope between consecutive valid points;
    a ground point draws the 2D line from the previous point's cell (the
    image centre for the first) in ceil(|diff|) steps, at most
    max_interp."""
    cloud = torch.as_tensor(cloud, dtype=torch.float32)
    dev = cloud.device
    hc, wc, _ = cloud.shape
    x, y, z = cloud[..., 0], cloud[..., 1], cloud[..., 2]
    valid = ~((x == 0) & (y == 0))
    res_t = _as_scalar(res, cloud)
    x_ind = torch.round(x / res_t).to(torch.int32) + width // 2
    y_ind = torch.round(y / res_t).to(torch.int32) + height // 2

    # the row of the previous valid point in each column
    rows = torch.arange(hc, dtype=torch.int32, device=dev)[:, None].expand(
        hc, wc)
    prev_row = torch.cummax(torch.where(valid, rows, -1), 0).values
    prev_row = torch.cat([
        torch.full((1, wc), -1, dtype=torch.int32, device=dev),
        prev_row[:-1]])
    has_prev = prev_row >= 0
    pr = torch.clamp(prev_row, 0, hc - 1).long()

    def gather(a, fill):
        return torch.where(has_prev, torch.gather(a, 0, pr), fill)

    dx0, dy0 = x - gather(x, 0.0), y - gather(y, 0.0)
    dist = torch.sqrt(dx0 * dx0 + dy0 * dy0)
    slope = torch.abs(z - gather(z, 0.0)) / dist
    last_high_grad = has_prev & (gather(slope, 0.0) > 1.0)
    in_img = (x_ind >= 0) & (x_ind < width) & (y_ind >= 0) & (y_ind < height)
    obstacle = valid & (slope > 1.0) & in_img
    ground = valid & (slope < 0.3) & ~last_high_grad
    size = height * width
    img1 = _histogram((y_ind * width + x_ind).reshape(-1),
                      obstacle.reshape(-1), size, dev)

    # line steps k / |diff| for k = 0 .. ceil(|diff|) - 1
    plx, ply = gather(x_ind, width // 2), gather(y_ind, height // 2)
    dx = (x_ind - plx).to(torch.float32)
    dy = (y_ind - ply).to(torch.float32)
    norm = torch.sqrt(dx * dx + dy * dy)
    n_steps = torch.where(norm > 0, torch.ceil(norm).to(torch.int32), 1)
    n_steps = torch.clamp(n_steps, max=max_interp)
    k = torch.arange(max_interp, dtype=torch.float32, device=dev)
    frac = k / torch.clamp(norm, min=1e-20)[..., None]
    ix = torch.round(plx[..., None] + frac * dx[..., None]).to(torch.int32)
    iy = torch.round(ply[..., None] + frac * dy[..., None]).to(torch.int32)
    step_ok = (
        ground[..., None]
        & (k < n_steps[..., None])
        & (ix >= 0) & (ix < width) & (iy >= 0) & (iy < height)
    )
    img0 = _histogram((iy * width + ix).reshape(-1), step_ok.reshape(-1),
                      size, dev)
    return torch.stack([img0.reshape(height, width),
                        img1.reshape(height, width)])
