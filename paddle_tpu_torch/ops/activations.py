"""Activation ops (mirrors ``paddle_tpu/ops/activations.py``: ``gelu`` at
:46 — exact erf form unless ``approximate`` is set)."""

import torch.nn.functional as F

from .registry import register_op


@register_op("gelu", inputs=["X"], outputs=["Out"])
def gelu(ctx, attrs, X):
    approx = "tanh" if attrs.get("approximate", False) else "none"
    return F.gelu(X, approximate=approx)
