"""tdr-torch: PyTorch/CUDA port of the tdr-tpu localization framework.

Global Monte-Carlo localization of a ground robot against an aerial
semantic map from semantically-labelled LiDAR scans, written in PyTorch
for one NVIDIA H100.  The JAX package `top_down_renderer_tpu` is the
reference; this package mirrors its layout so each module's counterpart
is easy to find:

  core/      tensor dataclasses (map grid, particles, filter state)
  maps/      polar stencil, truncated EDT, TopDownMap
  render/    scan -> polar / Cartesian semantic histograms
  filter/    propagate / score / resample / stats / GMM, and the
             ParticleFilter host dispatch
  kernels/   nvcc build + ctypes loading of the CUDA sources in csrc/
  utils/     state conversion to and from dicts of numpy arrays

Parameters are the reference package's numpy-only config classes, in
the port's own copy (`config.py`); nothing here imports JAX or the JAX
package.  Maps, and with them filters, live on the card unless the
caller passes device="cpu".
"""

__version__ = "0.1.0"

from top_down_renderer_torch.config import (
    ClassConfig,
    FilterParams,
    MapParams,
    RuntimeParams,
)

__all__ = [
    "ClassConfig",
    "FilterParams",
    "MapParams",
    "RuntimeParams",
]
