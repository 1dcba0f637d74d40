"""Host-facing semantic map (counterpart of maps/map.py).

A TopDownMap is built from binary class maps ((C, H, W), 0 inside a
class, 1 outside) or from a colour raster (an 8-bit RGB or RGBA PNG,
decoded by maps/png.py and mapped through the ClassConfig colour LUT).
The distance transform runs on the map's device, and the packed (H, W, 8)
scoring tensor stays there: class distances in channels [0, C), the
known-space indicator in channel C, zero padding above.  The local-window
queries index on the host and gather on the map's device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import math

import numpy as np
import torch

from top_down_renderer_torch.config import MapParams
from top_down_renderer_torch.kernels import default_device
from top_down_renderer_torch.core.grids import SemanticMapGrid
from top_down_renderer_torch.maps.edt import compute_dists
from top_down_renderer_torch.maps.png import read_png_rgb
from top_down_renderer_torch.maps.polar import polar_stencil


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_grid(
    class_maps_binary,
    resolution: float = 1.0,
    trunc_m: float = 50.0,
    num_geo_from: int = 3,
    map_center: Tuple[int, int] = (0, 0),
    device=None,
) -> SemanticMapGrid:
    """SemanticMapGrid on `device` (default: the card; without one this
    raises) from binary class maps (C, H, W)."""
    cm = torch.as_tensor(
        np.asarray(class_maps_binary, dtype=np.float32),
        device=default_device(device),
    )
    c, h, w = cm.shape

    # geometric 2-channel map: channel 1 is 0 where an elevated class
    # (index >= num_geo_from) is present
    geo1 = (1.0 - cm[num_geo_from:]).sum(0) if c > num_geo_from else (
        torch.zeros((h, w), device=cm.device)
    )
    geo1 = 1.0 - torch.clamp(geo1, max=1.0)
    geo_binary = torch.stack([1.0 - geo1, geo1])

    dists, mask = compute_dists(cm, resolution=resolution, trunc_m=trunc_m)
    geo_dists, _ = compute_dists(
        geo_binary, resolution=resolution, trunc_m=trunc_m
    )

    c_pad = _round_up(c + 1, 8)
    packed = torch.zeros((h, w, c_pad), dtype=torch.float32, device=cm.device)
    packed[..., :c] = dists.permute(1, 2, 0)
    packed[..., c] = 1.0 - mask.to(torch.float32)

    # a point is on the road when the road channel's distance is < 1
    # (unknown cells have distance 0 and count as road, as in the
    # reference)
    road_ok = dists[1] < 1.0 if c > 1 else dists[0] < 1.0

    return SemanticMapGrid(
        dist=packed,
        geo_dist=geo_dists.permute(1, 2, 0).contiguous(),
        mask=mask,
        road_ok=road_ok,
        map_center=torch.tensor(
            map_center, dtype=torch.int32, device=cm.device
        ),
        resolution=float(resolution),
        num_classes=int(c),
    )


def class_maps_from_index_image(
    ind_img: np.ndarray,
    flatten_lut: np.ndarray,
    num_classes: int,
    resolution: float = 1.0,
) -> np.ndarray:
    """(C, h, w) binary class maps, bottom-up (row 0 at the bottom), from
    a raw class index image in image coordinates (row 0 at the top)."""
    img_h, img_w = ind_img.shape
    h = int(img_h / resolution)
    w = int(img_w / resolution)
    yi = np.arange(h)
    xi = np.arange(w)
    src_r = np.maximum(img_h - (yi * resolution).astype(np.int64) - 1, 0)
    src_c = np.minimum((xi * resolution).astype(np.int64), img_w - 1)
    raw = ind_img[src_r[:, None], src_c[None, :]]
    flat = flatten_lut[raw]  # (h, w), -1 for unused classes
    maps = np.ones((num_classes, h, w), dtype=np.float32)
    for cls in range(num_classes):
        maps[cls][flat == cls] = 0.0
    return maps


class TopDownMap:
    """Semantic map with its polar stencil.

    Built from `class_maps` (binary, (C, H, W)) when given, else from
    params.map_path when it names a colour raster (PNG).  With neither, the
    map waits for update_map().  Everything lives on `device`, by
    default the card; without one that raises (pass device="cpu")."""

    def __init__(
        self, params: MapParams, device=None, class_maps=None
    ):
        self.params = params
        self.device = default_device(device)
        self.have_map = False
        self.grid: Optional[SemanticMapGrid] = None
        self.class_maps_binary: Optional[np.ndarray] = None
        self.sample_pts_polar(theta_bins=100, range_bins=50)

        path = params.map_path
        if class_maps is not None:
            maps = np.asarray(class_maps, dtype=np.float32)
        elif not path:
            return
        elif path.endswith(".png"):
            maps = self._load_color_raster(path)
        else:
            raise NotImplementedError(
                f"{path}: only colour rasters (8-bit RGB or RGBA PNG) load "
                "in this package; SVG maps and raster directories are not "
                "ported"
            )
        self._set_class_maps(maps)
        self.have_map = True

    def _set_class_maps(self, maps: np.ndarray, map_center=(0, 0)) -> None:
        self.class_maps_binary = maps
        self.grid = build_grid(
            maps,
            resolution=self.params.resolution,
            trunc_m=self.params.dist_trunc_m,
            map_center=map_center,
            device=self.device,
        )

    def _flatten_lut(self) -> np.ndarray:
        if self.params.flatten_lut is not None:
            return np.asarray(self.params.flatten_lut)
        cc = self.params.class_config
        return cc.flatten_lut() if cc else np.arange(256)

    def _load_color_raster(self, path: str) -> np.ndarray:
        cc = self.params.class_config
        if cc is None:
            raise ValueError("raster loading requires class_config")
        img = read_png_rgb(path)
        return class_maps_from_index_image(
            cc.color_to_ind(img),
            self._flatten_lut(),
            self.params.num_classes,
            self.params.resolution,
        )

    # -- queries -------------------------------------------------------
    def size(self) -> np.ndarray:
        """(width, height) px; zeros before a map arrives."""
        if self.grid is None:
            return np.zeros(2, dtype=np.int64)
        return np.array([self.grid.width, self.grid.height], dtype=np.int64)

    def map_center(self) -> np.ndarray:
        """The map centre (px) the grid was built with; (0, 0) before a
        map arrives."""
        if self.grid is None:
            return np.zeros(2, dtype=np.int32)
        return self.grid.map_center.cpu().numpy()

    @property
    def num_classes(self) -> int:
        return self.params.num_classes

    @property
    def resolution(self) -> float:
        return self.params.resolution

    def get_classes_at_point(self, xy_px: Sequence[float]) -> List[int]:
        """Classes whose distance at the point is < 1 (getClassesAtPoint);
        [] outside the map."""
        if self.grid is None:
            return []
        x = int(float(xy_px[0]) / self.params.resolution)
        y = int(float(xy_px[1]) / self.params.resolution)
        if not (0 <= x < self.grid.width and 0 <= y < self.grid.height):
            return []
        vals = self.grid.dist[y, x, : self.num_classes].cpu().numpy()
        return [int(c) for c in np.nonzero(vals < 1.0)[0]]

    def update_map(
        self, ind_img: np.ndarray, map_center: Sequence[int]
    ) -> None:
        """Replace the map from a raw class index image (image coords)."""
        maps = class_maps_from_index_image(
            np.asarray(ind_img),
            self._flatten_lut(),
            self.params.num_classes,
            self.params.resolution,
        )
        self._set_class_maps(
            maps, (int(map_center[0]), int(map_center[1]))
        )
        # as in the reference, a map whose road channel says "road
        # everywhere" does not count as received
        if np.any(maps[1] != 0):
            self.have_map = True

    def sample_pts_polar(
        self, theta_bins: int, range_bins: int, ang_res: float | None = None
    ) -> None:
        self.stencil = polar_stencil(
            theta_bins, range_bins, ang_res, self.params.resolution
        )

    # -- local windows (host indices, a gather on the map's device) -----
    def _gather(self, field: torch.Tensor, rows: np.ndarray,
                cols: np.ndarray):
        """(valid, field[rows, cols] with clamped indices) on the host."""
        g = self.grid
        valid = (rows >= 0) & (rows < g.height) & (cols >= 0) & (
            cols < g.width)
        idx = (np.clip(rows, 0, g.height - 1) * g.width
               + np.clip(cols, 0, g.width - 1))
        flat = field.reshape(g.height * g.width, -1)
        vals = flat[torch.as_tensor(idx.reshape(-1), device=flat.device)]
        return valid, vals.cpu().numpy().reshape(idx.shape + (-1,))

    def _polar_indices(self, center_xy_px, scale: float, res: float):
        pts = self.stencil * (scale * res)
        rows = np.rint(
            pts[..., 0] + center_xy_px[1] / self.params.resolution
        ).astype(np.int64)
        cols = np.rint(
            pts[..., 1] + center_xy_px[0] / self.params.resolution
        ).astype(np.int64)
        return rows, cols

    def get_local_map(
        self, center_xy_px: Sequence[float], scale: float, res: float
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The polar window at a centre: (dists (C, Th, R), mask (Th, R))
        as numpy, nearest-neighbour; out of the map dist 0 and mask 1 (as
        TopDownMapPolar::getLocalMap)."""
        valid, packed = self._gather(
            self.grid.dist, *self._polar_indices(center_xy_px, scale, res))
        c = self.num_classes
        dists = np.where(valid[..., None], packed[..., :c], 0.0)
        mask = 1.0 - np.where(valid, packed[..., c], 0.0)
        return np.moveaxis(dists, -1, 0), mask

    def get_local_map_cartesian(
        self,
        center_xy_px: Sequence[float],
        rot: float,
        res: float,
        h: int,
        w: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """An (h, w) grid of samples spaced `res`, centred on the centre
        and rotated by `rot` (TopDownMap::getLocalMap): (dists (C, h, w),
        mask (h, w)) as numpy; out of the map dist 0 and mask 1."""
        yy = res * (np.arange(h) - (h - 1) / 2.0)
        xx = res * (np.arange(w) - (w - 1) / 2.0)
        py, px = np.meshgrid(yy, xx, indexing="ij")
        c, s = math.cos(rot), math.sin(rot)
        rows = np.rint(
            c * py - s * px + center_xy_px[1] / self.params.resolution
        ).astype(np.int64)
        cols = np.rint(
            s * py + c * px + center_xy_px[0] / self.params.resolution
        ).astype(np.int64)
        valid, packed = self._gather(self.grid.dist, rows, cols)
        nc = self.num_classes
        dists = np.where(valid[..., None], packed[..., :nc], 0.0)
        mask = np.where(valid, 1.0 - packed[..., nc], 1.0)
        return np.moveaxis(dists, -1, 0), mask

    def get_local_geo_map(
        self, center_xy_px: Sequence[float], scale: float, res: float
    ) -> np.ndarray:
        """The polar window of the geometric (ground, elevated) distances,
        (2, Th, R) as numpy, 0 out of the map
        (TopDownMapPolar::getLocalGeoMap)."""
        valid, geo = self._gather(
            self.grid.geo_dist,
            *self._polar_indices(center_xy_px, scale, res))
        return np.moveaxis(np.where(valid[..., None], geo, 0.0), -1, 0)
