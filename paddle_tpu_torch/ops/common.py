"""Shared helpers for op lowerings (mirrors ``paddle_tpu/ops/common.py``)."""

import math

import torch

from .. import core
from .cuda import dropout as _drop


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


def device_bits(seed, shape, device, lane=0):
    """uint32 bits (as int64) in ``shape``, drawn on ``device`` with no
    host read: the card generator (``card_bits``) at each flat position,
    ``lane`` naming an independent stream of the same seed.  ``seed`` is
    a host int or a :class:`~.cuda.dropout.StepSeed`
    (:meth:`LoweringContext.step_seed`: the run's step on the device, so a
    step replayed from a CUDA graph draws anew)."""
    n = math.prod(int(d) for d in shape)
    rows = torch.arange(n, dtype=torch.int64, device=device)
    return _drop.card_bits(_drop.seed_u32(seed), lane, rows, 0).reshape(
        tuple(shape))


def uniform_of_bits(bits):
    """float32 uniforms in (0, 1) from uint32 bits: the top 23 bits as
    ``(b + 0.5) / 2**23``, so every value is exact in float32 and lies in
    [2**-24, 1 - 2**-24] (24 bits would round the top code's ``b + 0.5``
    up to 1.0), and noise built on it stays finite."""
    return ((bits >> 9).to(torch.float32) + 0.5) * (1.0 / 8388608.0)


def gumbel_of_bits(bits):
    """Standard Gumbel noise ``-log(-log(u))`` from uint32 bits: the
    sampling ops' Gumbel-max draw."""
    return -torch.log(-torch.log(uniform_of_bits(bits)))


def device_uniform(seed, shape, device, lane=0):
    """float32 uniforms in (0, 1) in ``shape``: :func:`uniform_of_bits`
    of :func:`device_bits`."""
    return uniform_of_bits(device_bits(seed, shape, device, lane))


def device_normal(seed, shape, device):
    """float32 standard normals by Box-Muller over two uniform lanes."""
    u1 = device_uniform(seed, shape, device, 0)
    u2 = device_uniform(seed, shape, device, 1)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
