"""Miscellaneous ops (mirrors ``paddle_tpu/ops/misc.py``; so far
``tree_conv`` :153, which the dygraph ``TreeConv`` dispatches; the rest is
ROADMAP.md Queue A item 9)."""

import torch

from .registry import register_op


@register_op("tree_conv", inputs=["NodesVector", "EdgeSet", "Filter"],
             outputs=["Out"])
def tree_conv(ctx, attrs, NodesVector, EdgeSet, Filter):
    """Tree-based convolution (``tree_conv_op.h``, the continuous binary
    tree form): each node mixes itself, the sum of its children and its
    parent through the three slices of the [D, H, 3] filter, then tanh.
    NodesVector [B, N, D]; EdgeSet [B, E, 2] (parent, child) pairs, padded
    with (0, 0): a self-loop marks padding and adds nothing."""
    b, n, d = NodesVector.shape
    edges = EdgeSet.long()
    parent, child = edges[..., 0], edges[..., 1]
    real = (parent != child).to(NodesVector.dtype).reshape(-1, 1)
    base = (torch.arange(b, device=edges.device) * n)[:, None]
    flat = NodesVector.reshape(b * n, d)
    par, chi = (parent + base).reshape(-1), (child + base).reshape(-1)
    up = torch.zeros_like(flat).index_add(0, par, flat[chi] * real)
    down = torch.zeros_like(flat).index_add(0, chi, flat[par] * real)
    out = (NodesVector @ Filter[..., 0]
           + up.reshape(b, n, d) @ Filter[..., 1]
           + down.reshape(b, n, d) @ Filter[..., 2])
    return torch.tanh(out)
