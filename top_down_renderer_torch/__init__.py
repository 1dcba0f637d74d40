"""tdr-torch: PyTorch/CUDA port of the tdr-tpu localization framework.

Global Monte-Carlo localization of a ground robot against an aerial
semantic map from semantically-labelled LiDAR scans, written in PyTorch
for one NVIDIA H100.  The JAX package `top_down_renderer_tpu` is the
reference; this package mirrors its layout so each module's counterpart
is easy to find:

  core/      tensor dataclasses (map grid, particles, filter state)
  maps/      polar stencil, truncated EDT, PNG reader, TopDownMap
  render/    scan -> polar / Cartesian semantic and geometric histograms
  filter/    propagate / score / resample / stats / GMM, and the
             ParticleFilter host dispatch
  kernels/   nvcc build + ctypes loading of the CUDA sources in csrc/
  parallel/  the filter sharded over the ranks of a process group
  runtime/   the localization node (TopDownRenderNode) and its viz
  io/        recorded drives (Bag), replay and the accuracy harnesses
  utils/     state conversion to and from dicts of numpy arrays

Parameters are the reference package's numpy-only config classes, in
the port's own copy (`config.py`); nothing here imports JAX or the JAX
package.  Maps, and with them filters and nodes, live on the card unless
the caller passes device="cpu".
"""

__version__ = "0.1.0"

from top_down_renderer_torch.config import (
    ClassConfig,
    FilterParams,
    MapConfig,
    MapParams,
    RuntimeParams,
)
from top_down_renderer_torch.io.replay import Bag, replay
from top_down_renderer_torch.runtime.node import (
    PoseWithCovariance,
    TopDownRenderNode,
)

__all__ = [
    "Bag",
    "ClassConfig",
    "FilterParams",
    "MapConfig",
    "MapParams",
    "PoseWithCovariance",
    "RuntimeParams",
    "TopDownRenderNode",
    "replay",
]
