"""Matmul / elementwise ops (mirrors ``paddle_tpu/ops/math.py``: ``mul``
at :23, ``matmul``, ``elementwise_add``).  The products stay
``torch.matmul`` (cuBLAS), as the reference left them to XLA; with TF32
off (set by the Executor on a CUDA place) f32 products run in full f32.
"""

import math as _math

import torch

from .common import fluid_broadcast
from .registry import register_op


def _matmul(x, y):
    if x.dtype in (torch.bfloat16, torch.float16) or \
            y.dtype in (torch.bfloat16, torch.float16):
        # f32 accumulation of low-precision products, as the reference's
        # preferred_element_type=float32
        return torch.matmul(x.float(), y.float()).to(
            torch.promote_types(x.dtype, y.dtype))
    return torch.matmul(x, y)


@register_op("mul", inputs=["X", "Y"], outputs=["Out"])
def mul(ctx, attrs, X, Y):
    xd = int(attrs.get("x_num_col_dims", 1))
    yd = int(attrs.get("y_num_col_dims", 1))
    xs, ys = tuple(X.shape), tuple(Y.shape)
    xm = X.reshape(_math.prod(xs[:xd]), -1)
    ym = Y.reshape(_math.prod(ys[:yd]), -1)
    return _matmul(xm, ym).reshape(xs[:xd] + ys[yd:])


@register_op("matmul", inputs=["X", "Y"], outputs=["Out"])
def matmul(ctx, attrs, X, Y):
    x, y = X, Y
    if attrs.get("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = _matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return out


@register_op("elementwise_add", inputs=["X", "Y"], outputs=["Out"])
def elementwise_add(ctx, attrs, X, Y):
    x, y = fluid_broadcast(X, Y, attrs.get("axis", -1))
    return torch.add(x, y)
