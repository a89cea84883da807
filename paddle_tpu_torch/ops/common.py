"""Shared helpers for op lowerings (mirrors ``paddle_tpu/ops/common.py``)."""

import torch

from .. import core


def resolve_dtype(attr_dtype):
    """Resolve a dtype attr (str / numpy / VarType enum int) to a
    ``torch.dtype``.  Unlike the reference (JAX without x64), 64-bit
    integer types keep their width."""
    return core.torch_dtype(attr_dtype)


def fluid_broadcast(x, y, axis):
    """Fluid elementwise broadcast: align y's dims to x's starting at
    ``axis`` (default -1 = trailing alignment, i.e. numpy)."""
    xnd, ynd = x.dim(), y.dim()
    if xnd == ynd or ynd == 0:
        return x, y
    if xnd > ynd:
        if axis is None or axis == -1:
            axis = xnd - ynd
        new_shape = (1,) * axis + tuple(y.shape) + (1,) * (xnd - axis - ynd)
        return x, torch.reshape(y, new_shape)
    if axis is None or axis == -1:
        axis = ynd - xnd
    new_shape = (1,) * axis + tuple(x.shape) + (1,) * (ynd - axis - xnd)
    return torch.reshape(x, new_shape), y
