"""Activation ops (mirrors ``paddle_tpu/ops/activations.py``, all of it:
the ``_unary`` table :4-45 — ``relu`` :19, whose gradient at 0 is 0 as
``jax.nn.relu``'s, ``sigmoid`` :20, ``logsigmoid`` :21, ``tanh`` :22,
``exp`` / ``log`` / ``sqrt`` / ``rsqrt`` :23-26, ``abs`` :27, ``square``
:28, ``reciprocal`` :29, ``softplus`` / ``softsign`` :30-31, ``ceil`` /
``floor`` / ``round`` :32-34 (half to even in both), ``cos`` / ``sin`` /
``acos`` / ``asin`` / ``atan`` :35-39, ``tanh_shrink`` :40, ``relu6`` :41,
``sign`` :42, ``erf`` :43; ``gelu`` :46 — exact erf form unless
``approximate`` is set; then the activations with attrs, each with the
reference's defaults: ``leaky_relu`` :51 (alpha 0.02), ``elu`` :57,
``hard_sigmoid`` :62, ``hard_swish`` :69, ``swish`` :77, ``brelu`` :83,
``soft_relu`` :88, ``stanh`` :94, ``thresholded_relu`` :101,
``hard_shrink`` :107, ``softshrink`` :113).  A scalar attr meets a
low-precision input as the reference's ``jnp.asarray(v, X.dtype)`` does,
rounded to the input's dtype first (:func:`scalar_like`)."""

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


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0), with no linear cut-off
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


exp = _unary("exp", torch.exp)
log = _unary("log", torch.log)
sqrt = _unary("sqrt", torch.sqrt)
square = _unary("square", torch.square)
ceil = _unary("ceil", torch.ceil)
floor = _unary("floor", torch.floor)
cos = _unary("cos", torch.cos)
sign = _unary("sign", torch.sign)
tanh = _unary("tanh", torch.tanh)
logsigmoid = _unary("logsigmoid", F.logsigmoid)
rsqrt = _unary("rsqrt", torch.rsqrt)
_unary("abs", torch.abs)
reciprocal = _unary("reciprocal", torch.reciprocal)
softplus = _unary("softplus", _softplus)
softsign = _unary("softsign", F.softsign)
_unary("round", torch.round)
sin = _unary("sin", torch.sin)
acos = _unary("acos", torch.acos)
asin = _unary("asin", torch.asin)
atan = _unary("atan", torch.atan)
tanh_shrink = _unary("tanh_shrink", lambda x: x - torch.tanh(x))
relu6 = _unary("relu6", lambda x: torch.clamp(x, 0.0, 6.0))
erf = _unary("erf", torch.erf)


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


@register_op("leaky_relu", inputs=["X"], outputs=["Out"])
def leaky_relu(ctx, attrs, X):
    alpha = scalar_like(attrs.get("alpha", 0.02), X)
    return torch.where(X >= 0, X, alpha * X)


@register_op("elu", inputs=["X"], outputs=["Out"])
def elu(ctx, attrs, X):
    return F.elu(X, alpha=float(attrs.get("alpha", 1.0)))


@register_op("hard_sigmoid", inputs=["X"], outputs=["Out"])
def hard_sigmoid(ctx, attrs, X):
    slope = scalar_like(attrs.get("slope", 0.2), X)
    offset = scalar_like(attrs.get("offset", 0.5), X)
    return torch.clamp(slope * X + offset, 0.0, 1.0)


@register_op("hard_swish", inputs=["X"], outputs=["Out"])
def hard_swish(ctx, attrs, X):
    threshold = attrs.get("threshold", 6.0)
    s = scalar_like(attrs.get("scale", 6.0), X)
    offset = scalar_like(attrs.get("offset", 3.0), X)
    return X * torch.clamp(X + offset, 0.0, threshold) / s


class _SigmoidLowp(torch.autograd.Function):
    """``jax.nn.sigmoid`` of a bf16/f16 tensor as XLA computes it, ``1 /
    (1 + exp(-x))`` op by op in that dtype, and its gradient as
    ``lax.logistic``'s jvp, ``g * (y * (1 - y))``, each op rounded
    (PyTorch's own sigmoid and its backward round once)."""

    @staticmethod
    def forward(ctx, x):
        y = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1 - y))


def _sigmoid(x):
    if x.dtype in (torch.bfloat16, torch.float16):
        return _SigmoidLowp.apply(x)
    return torch.sigmoid(x)


sigmoid = _unary("sigmoid", _sigmoid)


@register_op("swish", inputs=["X"], outputs=["Out"])
def swish(ctx, attrs, X):
    beta = scalar_like(attrs.get("beta", 1.0), X)
    return X * _sigmoid(beta * X)


@register_op("brelu", inputs=["X"], outputs=["Out"])
def brelu(ctx, attrs, X):
    return torch.clamp(X, attrs.get("t_min", 0.0), attrs.get("t_max", 24.0))


@register_op("soft_relu", inputs=["X"], outputs=["Out"])
def soft_relu(ctx, attrs, X):
    t = attrs.get("threshold", 40.0)
    return torch.log1p(torch.exp(torch.clamp(X, -t, t)))


@register_op("stanh", inputs=["X"], outputs=["Out"])
def stanh(ctx, attrs, X):
    a = scalar_like(attrs.get("scale_a", 0.67), X)
    b = scalar_like(attrs.get("scale_b", 1.7159), X)
    return b * torch.tanh(a * X)


@register_op("thresholded_relu", inputs=["X"], outputs=["Out"])
def thresholded_relu(ctx, attrs, X):
    t = attrs.get("threshold", 1.0)
    return torch.where(X > t, X, torch.zeros_like(X))


@register_op("hard_shrink", inputs=["X"], outputs=["Out"])
def hard_shrink(ctx, attrs, X):
    t = attrs.get("threshold", 0.5)
    return torch.where(torch.abs(X) > t, X, torch.zeros_like(X))


@register_op("softshrink", inputs=["X"], outputs=["Out"])
def softshrink(ctx, attrs, X):
    lam = attrs.get("lambda", 0.5)
    zero = torch.zeros_like(X)
    return torch.where(X > lam, X - lam,
                       torch.where(X < -lam, X + lam, zero))
