"""Shared helpers for op lowerings (mirrors ``paddle_tpu/ops/common.py``)."""

import torch

from .. import core


def resolve_dtype(attr_dtype):
    """Resolve a dtype attr (str / numpy / VarType enum int) to a
    ``torch.dtype``.  Unlike the reference (JAX without x64), 64-bit
    integer types keep their width."""
    return core.torch_dtype(attr_dtype)


def scalar_like(value, x):
    """``value`` rounded to ``x``'s floating dtype, as the reference's
    ``jnp.asarray(value, x.dtype)``: a bf16 op scales by the bf16 scalar
    (PyTorch would otherwise apply the scalar in float32)."""
    if x.is_floating_point() and x.dtype != torch.float32:
        return float(torch.tensor(float(value), dtype=x.dtype))
    return value


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


def flatten_concat(xs, dtype=None):
    """Pack a list of tensors into one flat stream (the bucketed-collective
    layout), optionally casting each segment (``ops/common.py:51``)."""
    return torch.cat([x.reshape(-1).to(dtype) if dtype is not None
                      else x.reshape(-1) for x in xs])


def split_like(flat, refs, cast=True):
    """Unpack a flat stream into segments shaped (and, with ``cast``,
    typed) like ``refs``: the inverse of :func:`flatten_concat`
    (``ops/common.py:60``)."""
    outs = []
    off = 0
    for r in refs:
        n = r.numel()
        seg = flat[off:off + n].reshape(r.shape)
        outs.append(seg.to(r.dtype) if cast else seg)
        off += n
    return outs
