"""The localization node (counterpart of runtime/node.py): the reference's
TopDownRender node without ROS.

Messages are plain dataclasses and topics registered callbacks.  The node
drives the map, the renderers and the filter through the reference's
state machine (top_down_render.cpp):

  - scan / motion-prior pairing on equal stamps (pcCallback,
    motionPriorCallback, :452-503);
  - takeStep: render the scan, the pose delta from the priors,
    propagate and update, publish (:505-572);
  - publishPoseEst: mean and covariance, the adaptive range scale, the
    scale-freeze trigger, the convergence gate, the pose with its 6x6
    covariance in the map frame (:331-411);
  - dynamic aerial-map ingestion (aerialMapCallback, :574-593), the
    ground-truth pose for visualization (:595-611), and the semantic
    scan visualization by per-cell argmax (:275-305).

Everything runs on the node's device, the card unless the caller passes
device="cpu".  A scan's points go to the card in one copy from pinned
memory that does not wait for the card, and the range scale, which
changes every scan, goes to the renders as a 0-dim tensor, so that a scan
costs no host round trip before the filter's own.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from top_down_renderer_torch.config import (
    ClassConfig,
    FilterParams,
    MapConfig,
    MapParams,
    RuntimeParams,
)
from top_down_renderer_torch.filter.filter import ParticleFilter
from top_down_renderer_torch.kernels import default_device
from top_down_renderer_torch.maps.map import TopDownMap
from top_down_renderer_torch.maps.png import read_png_rgb
from top_down_renderer_torch.render.geometric import render_geometric_polar
from top_down_renderer_torch.render.semantic import render_semantic_polar


@dataclasses.dataclass
class PoseStamped:
    stamp: float
    position: np.ndarray  # (3,)
    orientation: np.ndarray  # (4,) quaternion x, y, z, w

    def yaw(self) -> float:
        x, y, z, w = self.orientation
        # rotate unit X and project (top_down_render.cpp:417-420,604-606)
        fx = 1 - 2 * (y * y + z * z)
        fy = 2 * (x * y + z * w)
        return math.atan2(fy, fx)

    def matrix(self) -> np.ndarray:
        x, y, z, w = self.orientation
        rot = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w),
                 1 - 2 * (x * x + y * y)],
            ]
        )
        m = np.eye(4)
        m[:3, :3] = rot
        m[:3, 3] = self.position
        return m


@dataclasses.dataclass
class PoseWithCovariance:
    stamp: float
    frame_id: str
    position: np.ndarray  # (3,)
    orientation: np.ndarray  # (4,) x, y, z, w
    covariance: np.ndarray  # (6, 6)


class TopDownRenderNode:
    """The node: wires map, renderers and filter, and owns the
    convergence state machine and the input pairing buffers.

    runtime.mesh_devices > 0 shards the filter over the ranks of the
    default process group (parallel.make_mesh), which the caller has
    initialised; every rank builds the same node and feeds it the same
    messages."""

    def __init__(
        self,
        class_config: ClassConfig,
        map_config: MapConfig,
        runtime: Optional[RuntimeParams] = None,
        filter_overrides: Optional[dict] = None,
        *,
        seed: int = 0,
        device=None,
    ):
        self.rt = runtime or RuntimeParams()
        self.class_config = class_config
        self.map_config = map_config
        self.seed = seed
        self.device = default_device(device)

        # outputs (topic equivalents; top_down_render.cpp:21-27)
        self.callbacks: Dict[str, List[Callable]] = {
            "pose_est": [],
            "scale": [],
            "map_viz": [],
            "scan": [],
            "geo_scan": [],
            "map_transform": [],
        }

        # filter params (getFilterParams, top_down_render.cpp:192-244)
        fp = FilterParams()
        fp.fixed_scale = map_config.resolution
        fp.class_weights = class_config.class_weights().tolist()
        for k, v in (filter_overrides or {}).items():
            setattr(fp, k, v)
        self.filter_params = fp

        # map params (getTopDownMapParams, :161-190)
        map_path = ""
        if not map_config.dynamic:
            map_path = map_config.svg_path or map_config.raster_path
        self.map_params = MapParams(
            map_path=map_path,
            num_classes=class_config.num_classes,
            resolution=1.0,
            flatten_lut=class_config.flatten_lut(),
            exclusive_classes=class_config.exclusive_classes(),
            class_config=class_config,
        )

        self.flatten_lut = torch.as_tensor(class_config.flatten_lut(),
                                           device=self.device)
        self.unflatten_lut = class_config.unflatten_lut()
        self._ang_res = torch.full((), 2 * math.pi / self.rt.theta_bins,
                                   dtype=torch.float32, device=self.device)

        # state machine (top_down_render.h:77-110)
        self.current_range_scale = self.rt.range_scale_max
        self.is_converged = False
        self.published_pose = False
        self.last_prior_pose: Optional[np.ndarray] = None  # 4x4
        self.gt_pose = np.eye(3)  # 2D affine for viz
        self.motion_prior_buf: List[PoseStamped] = []
        self.last_pc: Optional[Tuple[float, np.ndarray]] = None
        self.last_map_stamp = -math.inf
        self.background_img: Optional[np.ndarray] = None

        # background viz map + init-pos flip (top_down_render.cpp:93-114)
        if not map_config.dynamic and map_config.viz_path:
            try:
                self.background_img = read_png_rgb(map_config.viz_path)
            except (OSError, ValueError) as e:
                print(f"[tdr-torch] no background map: {e}")
        if self.background_img is not None and fp.init_pos_px_y > 0:
            # image-coordinate convention for the pixel init prior (:99-103)
            fp.init_pos_px_y = self.background_img.shape[0] - fp.init_pos_px_y
        if fp.fixed_scale > 0:
            self.map_pub_scale = self.rt.map_pub_resolution / fp.fixed_scale
        else:
            self.map_pub_scale = 1.0
        img_h = (self.background_img.shape[0]
                 if self.background_img is not None else 0)
        self.map_center = np.array(
            [self.rt.svg_origin_x, img_h - self.rt.svg_origin_y],
            dtype=np.float64,
        )

        # build the stack (initialize(), top_down_render.cpp:81-117)
        self.map = TopDownMap(self.map_params, device=self.device)
        self.map.sample_pts_polar(self.rt.theta_bins, self.rt.range_bins)
        mesh = None
        if self.rt.mesh_devices > 0:
            from top_down_renderer_torch.parallel import make_mesh

            mesh = make_mesh(self.rt.mesh_devices, self.device.type)
        self.filter = ParticleFilter(
            self.rt.particle_count,
            self.map,
            fp,
            seed=seed,
            theta_bins=self.rt.theta_bins,
            gmm_every=self.rt.gmm_every,
            device=self.device,
            mesh=mesh,
        )
        self.timing: Dict[str, float] = {}
        if self.background_img is not None:
            self._publish("map_viz", self._scaled_viz(self.background_img))

    def warmup(self) -> None:
        """The filter's warmup at the node's starting range scale (builds
        and loads the kernels, fills the map caches) before the first
        scan."""
        self.filter.warmup(self.current_range_scale)

    def _scaled_viz(self, img: np.ndarray) -> np.ndarray:
        """Resize published map images by map_pub_scale
        (top_down_render.cpp:105-112, 441-444); unscaled without cv2."""
        if self.map_pub_scale == 1.0:
            return img
        try:
            import cv2
        except ImportError:
            return img
        return cv2.resize(
            img,
            (int(img.shape[1] * self.map_pub_scale),
             int(img.shape[0] * self.map_pub_scale)),
        )

    # ------------------------------------------------------------------
    # pub/sub shim
    # ------------------------------------------------------------------
    def on(self, topic: str, cb: Callable) -> None:
        self.callbacks[topic].append(cb)

    def _publish(self, topic: str, msg) -> None:
        for cb in self.callbacks[topic]:
            cb(msg)

    # ------------------------------------------------------------------
    # input callbacks (pairing semantics of top_down_render.cpp:452-503)
    # ------------------------------------------------------------------
    def pc_callback(self, stamp: float, points: np.ndarray) -> None:
        """points: (P, 4) x, y, z, raw class id (the PointXYZI intensity
        convention)."""
        if not self.rt.use_motion_prior:
            self.take_step(stamp, points, None)
            return
        for i in range(len(self.motion_prior_buf) - 1, -1, -1):
            if self.motion_prior_buf[i].stamp == stamp:
                prior = self.motion_prior_buf[i]
                self.take_step(stamp, points, prior)
                del self.motion_prior_buf[: i + 1]
                self.last_pc = None
                return
        # prior not yet here: buffer of size 1 (panos assumption, :470-475)
        self.last_pc = (stamp, points)

    def motion_prior_callback(self, prior: PoseStamped) -> None:
        if not self.published_pose and self.filter.num_particles() > 0:
            self.publish_pose_est(prior.stamp)
        if self.last_prior_pose is None:
            self.last_prior_pose = prior.matrix()
        if self.rt.use_motion_prior:
            if self.last_pc is not None and self.last_pc[0] == prior.stamp:
                stamp, points = self.last_pc
                self.take_step(stamp, points, prior)
                self.last_pc = None
            else:
                self.motion_prior_buf.append(prior)

    def gt_pose_callback(self, pose: PoseStamped) -> None:
        """Project to 2D for visualization (top_down_render.cpp:595-611)."""
        theta = pose.yaw()
        self.gt_pose = np.array(
            [
                [math.cos(theta), -math.sin(theta), pose.position[0]],
                [math.sin(theta), math.cos(theta), pose.position[1]],
                [0, 0, 1],
            ]
        )

    def aerial_map_grid_callback(self, grid_map: dict) -> None:
        """A raw grid_map payload -> class-index image -> dynamic map
        ingestion: the GridMapComp::toImage and cv::rotate steps the
        reference runs before its aerialMapCallback body
        (top_down_render.cpp:574-593).

        grid_map keys (grid_map_msgs/GridMap field names):
          stamp: float seconds
          layers: list[str] - must contain "semantics"
          data: {layer: (rows, cols) float array} - grid_map matrix
                convention: row 0 / col 0 at the +x/+y map corner,
                values are raw class indices (NaN = unknown -> 255)
          pose_x, pose_y: map-frame position of the grid center (m)
          length_x, length_y: grid extent (m)
        """
        stamp = float(grid_map.get("stamp", 0.0))
        if (
            grid_map.get("length_x", 1.0) <= 0
            or grid_map.get("length_y", 1.0) <= 0
        ):
            return  # empty map (top_down_render.cpp:576)
        if "semantics" not in grid_map.get("layers", []):
            return
        mat = np.asarray(grid_map["data"]["semantics"], np.float64)
        # toImage {"semantics", "", "char"}: float class ids -> uint8,
        # NaN (unseen cells) -> 255 (the LUT's unknown slot)
        img = np.where(np.isfinite(mat), mat, 255.0).astype(np.uint8)
        # the grid_map matrix x-axis (rows, +x) points opposite the
        # image y-axis; ROTATE_90_CLOCKWISE (top_down_render.cpp:583)
        ind_img = np.ascontiguousarray(np.rot90(img, k=-1))
        pose_xy = np.array([float(grid_map.get("pose_x", 0.0)),
                            float(grid_map.get("pose_y", 0.0))])
        self.aerial_map_callback(stamp, ind_img, pose_xy)

    def aerial_map_callback(
        self, stamp: float, ind_img: np.ndarray, pose_xy: np.ndarray
    ) -> None:
        """Dynamic map ingestion (aerialMapCallback, :574-593).
        ind_img: raw class-index image (image coords)."""
        if stamp <= self.last_map_stamp or ind_img.size == 0:
            return
        scale = max(self.filter.scale(), 0.0)
        center = -np.asarray(pose_xy, dtype=np.float64) * scale
        center += np.array([ind_img.shape[1] / 2, ind_img.shape[0] / 2])
        self.map_center = np.array(
            [center[0], ind_img.shape[0] - center[1]]
        )
        self.background_img = self.class_config.ind_to_color(ind_img)
        self.filter.update_map(ind_img, center.astype(int))
        self.last_map_stamp = stamp

    # ------------------------------------------------------------------
    # main step (takeStep, :505-572)
    # ------------------------------------------------------------------
    def _upload(self, points: np.ndarray) -> torch.Tensor:
        """The scan's points as float32 on the node's device; to the card
        from pinned memory, in a copy that does not wait for the card."""
        pts = torch.from_numpy(np.ascontiguousarray(points, np.float32))
        if self.device.type != "cuda":
            return pts.to(self.device)
        return pts.pin_memory().to(self.device, non_blocking=True)

    def take_step(
        self,
        stamp: float,
        points: np.ndarray,
        motion_prior: Optional[PoseStamped],
    ) -> None:
        if not self.map.have_map:
            print("[tdr-torch] No map received yet")
            return
        t0 = time.perf_counter()
        res = torch.full((), self.current_range_scale, dtype=torch.float32,
                         device=self.device)
        pts = self._upload(points)
        scan = render_semantic_polar(
            pts,
            self.flatten_lut,
            res,
            self._ang_res,
            self.class_config.num_classes,
            self.rt.theta_bins,
            self.rt.range_bins,
        )
        # the geometric render is computed for parity and scores nothing,
        # as in the reference (top_down_render.cpp:540)
        geo = render_geometric_polar(
            pts, res, self._ang_res, self.rt.theta_bins, self.rt.range_bins,
        )
        # the visualization topics read the renders back: only for a
        # subscriber (ROS drops unsubscribed topics before serialization,
        # top_down_render.cpp:543-544)
        if self.callbacks["scan"]:
            self._publish("scan", self.visualize_scan(scan.cpu().numpy()))
        if self.callbacks["geo_scan"]:
            self._publish("geo_scan", geo.cpu().numpy())
        self.timing["render_ms"] = (time.perf_counter() - t0) * 1e3

        # delta pose from prior (:550-556)
        prior_mat = (
            motion_prior.matrix() if motion_prior is not None else np.eye(4)
        )
        if self.last_prior_pose is None:
            delta = np.eye(4)
        else:
            delta = np.linalg.inv(self.last_prior_pose) @ prior_mat
        self.last_prior_pose = prior_mat

        t1 = time.perf_counter()
        self.update_filter(scan, delta)
        t2 = time.perf_counter()
        self.timing["filter_ms"] = (t2 - t1) * 1e3
        self.publish_pose_est(stamp)
        self.timing["publish_ms"] = (time.perf_counter() - t2) * 1e3

    def update_filter(self, scan, delta_pose: np.ndarray) -> None:
        """updateFilter (:413-449): project the 3D prior to 2D."""
        trans = delta_pose[:2, 3]
        proj = delta_pose[:3, :3] @ np.array([1.0, 0, 0])
        omega = math.atan2(proj[1], proj[0])
        self.filter.propagate(trans.astype(np.float32), omega)
        self.filter.update(scan, self.current_range_scale)
        if self.callbacks["map_viz"]:
            self._publish("map_viz", self.visualize_map())

    # ------------------------------------------------------------------
    # pose publishing + convergence machine (publishPoseEst, :331-411)
    # ------------------------------------------------------------------
    def publish_pose_est(self, stamp: float) -> None:
        if self.filter.state is None:
            return
        # one snapshot read for the whole publish.  async_publish takes the
        # freshest snapshot on the host (at most one scan stale) and never
        # waits for the card; the default waits, so that the published
        # pose reflects this scan
        stats = self.filter.publish_stats(block=not self.rt.async_publish)
        if stats is None:
            return
        ml, cov, n_active = stats
        scale = self.filter.scale()
        scale_2 = scale * scale if scale > 0 else 1.0

        # adaptive range scale (:336-345)
        if (
            max(cov[0, 0], cov[1, 1]) / scale_2
            > self.rt.target_uncertainty_m**2
            and self.current_range_scale < self.rt.range_scale_max
        ):
            self.current_range_scale += 0.05
        elif self.current_range_scale > self.rt.range_scale_min:
            self.current_range_scale -= 0.02

        if n_active < 1:
            return

        # scale freeze trigger (:356-360)
        if cov[3, 3] < 0.003 * ml[3] and not self.filter.is_scale_frozen:
            print(f"[tdr-torch] Fixed Scale: {ml[3]}")
            self.filter.freeze_scale()

        # convergence gate (:363-365)
        if (
            cov[0, 0] / scale_2 < 40
            and cov[1, 1] / scale_2 < 40
            and cov[2, 2] < 0.5
            and self.filter.scale() > 0
        ):
            self.is_converged = True

        if self.is_converged:
            scale = self.filter.scale()
            self._publish("scale", scale)
            img_h = (
                self.background_img.shape[0]
                if self.background_img is not None
                else self.map.size()[1]
            )
            cf = self.rt.conf_factor
            cf2 = cf * cf
            c = np.zeros((6, 6))
            c[0, 0] = cov[0, 0] / scale_2 / cf2
            c[0, 1] = cov[0, 1] / scale_2 / cf2
            c[0, 5] = cov[0, 2] / scale / cf
            c[1, 0] = cov[1, 0] / scale_2 / cf2
            c[1, 1] = cov[1, 1] / scale_2 / cf2
            c[1, 5] = cov[1, 2] / scale / cf
            c[5, 0] = cov[2, 0] / scale / cf
            c[5, 1] = cov[2, 1] / scale / cf
            c[5, 5] = cov[2, 2] / cf2
            pose = PoseWithCovariance(
                stamp=stamp,
                frame_id=self.rt.map_frame,
                position=np.array(
                    [
                        (ml[0] - self.map_center[0]) / scale,
                        (ml[1] - (img_h - self.map_center[1])) / scale,
                        2.0,
                    ]
                ),
                orientation=np.array(
                    [0, 0, math.sin(ml[2] / 2), math.cos(ml[2] / 2)]
                ),
                covariance=c,
            )
            self._publish("pose_est", pose)
            self.published_pose = True

        # map visualization transform (:402-410)
        if self.background_img is not None and scale > 0:
            h, w = self.background_img.shape[:2]
            self._publish(
                "map_transform",
                {
                    "frame_id": self.rt.map_frame,
                    "child_frame_id": self.rt.map_viz_frame,
                    "translation": np.array(
                        [
                            (w / 2 - self.map_center[0]) / scale,
                            -(h / 2 - self.map_center[1]) / scale,
                            -2.0,
                        ]
                    ),
                },
            )

    # ------------------------------------------------------------------
    # visualization (visualize, :275-305; filter viz via numpy)
    # ------------------------------------------------------------------
    def visualize_scan(self, classes: np.ndarray) -> np.ndarray:
        """Per-cell argmax semantic image -> RGB (visualize, :275-305):
        cells where all classes tie are 'unknown' (255)."""
        best = np.argmax(classes, axis=0)
        allsame = np.all(classes == classes[0:1], axis=0)
        raw = self.unflatten_lut[best].astype(np.uint8)
        raw[allsame] = 255
        return self.class_config.ind_to_color(raw)

    def visualize_analog(
        self, cls_img: np.ndarray, scale: float
    ) -> np.ndarray:
        """Grayscale visualization of a single analog field
        (visualizeAnalog, top_down_render.cpp:266-273)."""
        g = np.clip(cls_img * (255.0 / scale), 0, 255).astype(np.uint8)
        return np.stack([g, g, g], axis=-1)

    def publish_local_map(
        self, h: int, w: int, center, res: float, cls: int = 1
    ) -> np.ndarray:
        """Debug local-map render (publishLocalMap,
        top_down_render.cpp:308-329): rotated Cartesian window of one
        class's distance field as a grayscale image."""
        dists, _mask = self.map.get_local_map_cartesian(
            center, 0.0, res, h, w
        )
        img = self.visualize_analog(dists[cls], 50.0)
        self._publish("scan", img)
        return img

    def visualize_map(self) -> Optional[np.ndarray]:
        """Particle / GMM / ML overlay on the background map
        (ParticleFilter::visualize, particle_filter.cpp:373-423), plus
        the gt arrow (top_down_render.cpp:433-439).  Under a mesh every
        rank draws the whole cloud."""
        from top_down_renderer_torch.runtime.viz import (
            draw_filter,
            draw_gt_arrow,
        )

        if self.background_img is None:
            return None
        p = self.filter.state.particles
        if self.filter.mesh is not None:
            from top_down_renderer_torch.parallel import sharding

            p = sharding.gather_particles(p, self.filter._comm)
        alive = p.alive.cpu().numpy()
        ml_states = p.ml_state().cpu().numpy()[alive]
        means, covs = self.filter.get_gmm()
        img = draw_filter(
            self.background_img,
            ml_states,
            means,
            covs,
            self.filter.max_likelihood(),
        )
        return self._scaled_viz(
            draw_gt_arrow(img, self.gt_pose, self.map_center)
        )
