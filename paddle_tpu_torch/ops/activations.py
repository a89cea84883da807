"""Activation ops (mirrors ``paddle_tpu/ops/activations.py``: ``relu`` at
:19, whose gradient at 0 is 0 as ``jax.nn.relu``'s; ``gelu`` at :46 —
exact erf form unless ``approximate`` is set)."""

import torch
import torch.nn.functional as F

from .registry import register_op


@register_op("relu", inputs=["X"], outputs=["Out"])
def relu(ctx, attrs, X):
    return torch.relu(X)


@register_op("gelu", inputs=["X"], outputs=["Out"])
def gelu(ctx, attrs, X):
    approx = "tanh" if attrs.get("approximate", False) else "none"
    return F.gelu(X, approximate=approx)
