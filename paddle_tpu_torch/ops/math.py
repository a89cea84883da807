"""Matmul / elementwise / reduction ops (mirrors ``paddle_tpu/ops/math.py``:
``mul`` at :23, ``matmul``, ``elementwise_add/sub/mul/div`` :66-68,
``reduce_sum`` :98, ``cumsum`` :145).  The products stay
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


def _elementwise(name, fn):
    @register_op(name, inputs=["X", "Y"], outputs=["Out"])
    def _op(ctx, attrs, X, Y):
        x, y = fluid_broadcast(X, Y, attrs.get("axis", -1))
        return fn(x, y)

    return _op


elementwise_add = _elementwise("elementwise_add", torch.add)
elementwise_sub = _elementwise("elementwise_sub", torch.sub)
elementwise_mul = _elementwise("elementwise_mul", torch.mul)
elementwise_div = _elementwise("elementwise_div", torch.div)


@register_op("reduce_sum", inputs=["X"], outputs=["Out"])
def reduce_sum(ctx, attrs, X):
    if attrs.get("reduce_all", False):
        out = X.sum()
    else:
        dim = attrs.get("dim", [0])
        dim = [dim] if isinstance(dim, int) else list(dim)
        out = X.sum(dim=tuple(d % X.dim() for d in dim),
                    keepdim=bool(attrs.get("keep_dim", False)))
    # the reference reduces to shape [1], not []
    return out.reshape(1) if out.dim() == 0 else out


@register_op("cumsum", inputs=["X"], outputs=["Out"])
def cumsum(ctx, attrs, X):
    axis = attrs.get("axis", -1)
    x = X
    if attrs.get("flatten", False):
        x, axis = x.reshape(-1), 0
    if attrs.get("reverse", False):
        out = torch.flip(torch.cumsum(torch.flip(x, (axis,)), axis), (axis,))
    else:
        out = torch.cumsum(x, axis)
    out = out.to(x.dtype)  # integer cumsum stays in the input's type
    if attrs.get("exclusive", False):
        out = out - x
    return out


@register_op("scale", inputs=["X"], outputs=["Out"])
def scale(ctx, attrs, X):
    s = float(attrs.get("scale", 1.0))
    b = float(attrs.get("bias", 0.0))
    if attrs.get("bias_after_scale", True):
        return X * s + b
    return (X + b) * s
