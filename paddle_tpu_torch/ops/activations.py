"""Activation ops (mirrors ``paddle_tpu/ops/activations.py``: ``relu`` at
:19, whose gradient at 0 is 0 as ``jax.nn.relu``'s; the unary math ops
the learning-rate schedules and the regularizers build, ``exp`` :23,
``log`` :24, ``sqrt`` :25, ``square`` :28, ``ceil`` / ``floor`` :32-33, ``cos`` :35, ``sign`` :42,
and ``sigmoid`` :20 / ``tanh`` :22, the dygraph layers' ``act`` and the
GRU unit's gates, each one PyTorch call; ``gelu`` at :46 — exact erf form unless
``approximate`` is set)."""

import math

import torch
import torch.nn.functional as F

from .common import scalar_like
from .registry import register_op


@register_op("relu", inputs=["X"], outputs=["Out"])
def relu(ctx, attrs, X):
    return torch.relu(X)


def _unary(name, fn):
    @register_op(name, inputs=["X"], outputs=["Out"])
    def _op(ctx, attrs, X, _fn=fn):
        return _fn(X)

    return _op


exp = _unary("exp", torch.exp)
log = _unary("log", torch.log)
sqrt = _unary("sqrt", torch.sqrt)
square = _unary("square", torch.square)
ceil = _unary("ceil", torch.ceil)
floor = _unary("floor", torch.floor)
cos = _unary("cos", torch.cos)
sign = _unary("sign", torch.sign)
sigmoid = _unary("sigmoid", torch.sigmoid)
tanh = _unary("tanh", torch.tanh)


class _GeluErfLowp(torch.autograd.Function):
    """``jax.nn.gelu(x, approximate=False)`` in x's low-precision dtype,
    op by op, each op rounded to that dtype as the reference's are:
    ``a = 0.5 x``, ``z = -x * c`` (c = sqrt(1/2) in x's dtype),
    ``e = erfc(z)``, ``out = a * e``; and its gradient as ``jax.vjp``
    takes it through those ops (erfc's derivative is ``C * (g * exp(-z²))``
    with C = -2/sqrt(pi) in x's dtype, lax's jvp rule)."""

    @staticmethod
    def forward(ctx, x):
        a = 0.5 * x
        z = -x * scalar_like(math.sqrt(0.5), x)
        e = torch.erfc(z)
        ctx.save_for_backward(a, z, e)
        return a * e

    @staticmethod
    def backward(ctx, g):
        a, z, e = ctx.saved_tensors
        d_a = g * e
        d_e = a * g
        d_z = (scalar_like(-2.0 / math.sqrt(math.pi), z) * d_e) \
            * torch.exp(-(z * z))
        return 0.5 * d_a - d_z * scalar_like(math.sqrt(0.5), z)


@register_op("gelu", inputs=["X"], outputs=["Out"])
def gelu(ctx, attrs, X):
    """float32: ``F.gelu``.  bf16/f16 (the AMP path): ``jax.nn.gelu``'s
    formula op by op in the input's dtype, its constants rounded to that
    dtype, as the reference computes it (PyTorch's own gelu would
    compute in float32 and round once): the erf form through
    :class:`_GeluErfLowp`, the tanh form through autograd."""
    approx = bool(attrs.get("approximate", False))
    if X.dtype not in (torch.bfloat16, torch.float16):
        return F.gelu(X, approximate="tanh" if approx else "none")
    if approx:
        c = scalar_like(math.sqrt(2.0 / math.pi), X)
        inner = c * (X + scalar_like(0.044715, X) * X ** 3)
        return X * (0.5 * (1.0 + torch.tanh(inner)))
    return _GeluErfLowp.apply(X)
