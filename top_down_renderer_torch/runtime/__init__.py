"""The localization node (runtime/node.py) and its visualization
(runtime/viz.py)."""

from top_down_renderer_torch.runtime.node import (
    PoseWithCovariance,
    TopDownRenderNode,
)

__all__ = ["PoseWithCovariance", "TopDownRenderNode"]
