"""Optimizer update ops (mirrors ``paddle_tpu/ops/optimizer_ops.py``:
``sgd`` :22, ``momentum`` :28-43, ``adam`` :46-77, ``lars_momentum`` :202-225,
``lamb`` :228-260, the multi-tensor ``fused_sgd`` :347-363 and
``fused_adam`` :366-435).

The reference's ops return new values that the jitted step binds to the
same names, and the step donates the old buffers.  Here every update is
declared in place (``register_op(..., in_place=...)``): it writes
ParamOut into Param and the moments, the velocity and the beta powers
into their inputs (``ops/cuda/optimizer.py``: one hand-written kernel a
parameter, or one multi-tensor kernel for a fused op), so the executor's
captured step copies no state back and the eager path leaves the
resident tensors where they are.  The fused ops' contracts are the
reference's: duplicable slots, one LearningRate, and each member's bias
correction from its own beta powers; the port updates the members where
they lie instead of through a flat concatenation.

``lamb`` and ``lars_momentum`` are the reference's XLA fusions written
as PyTorch ops on the device (their trust ratios' norms included, never
read on the host), their results copied into the resident tensors; a
hand-written kernel for them waits for a benchmark (ROADMAP.md,
Queue B)."""

import torch

from .cuda import optimizer as _opt
from .registry import register_op

_ADAM_IN_PLACE = {"ParamOut": "Param", "Moment1Out": "Moment1",
                  "Moment2Out": "Moment2", "Beta1PowOut": "Beta1Pow",
                  "Beta2PowOut": "Beta2Pow"}


def _adam_attrs(attrs):
    return (attrs.get("beta1", 0.9), attrs.get("beta2", 0.999),
            attrs.get("epsilon", 1e-8))


@register_op("sgd", inputs=["Param", "Grad", "LearningRate"],
             outputs=["ParamOut"], no_grad=True,
             in_place={"ParamOut": "Param"})
def sgd(ctx, attrs, Param, Grad, LearningRate):
    return _opt.sgd_(Param, Grad, LearningRate)


@register_op("momentum", inputs=["Param", "Grad", "Velocity", "LearningRate"],
             outputs=["ParamOut", "VelocityOut"], no_grad=True,
             in_place={"ParamOut": "Param", "VelocityOut": "Velocity"})
def momentum(ctx, attrs, Param, Grad, Velocity, LearningRate):
    """``v = mu * v + g``; Nesterov ``p -= (g + mu * v) * lr``, else
    ``p -= lr * v``."""
    p, v = _opt.momentum_(Param, Grad, Velocity, LearningRate,
                          attrs.get("mu", 0.9),
                          attrs.get("use_nesterov", False))
    return {"ParamOut": p, "VelocityOut": v}


@register_op("adam",
             inputs=["Param", "Grad", "LearningRate", "Moment1", "Moment2",
                     "Beta1Pow", "Beta2Pow"],
             outputs=["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
                      "Beta2PowOut"],
             no_grad=True, in_place=_ADAM_IN_PLACE)
def adam(ctx, attrs, Param, Grad, LearningRate, Moment1, Moment2, Beta1Pow,
         Beta2Pow):
    """Beta{1,2}Pow hold beta^t when this op reads them (init beta,
    advanced after use): the reference's bias correction."""
    return _opt.adam_(Param, Grad, LearningRate, Moment1, Moment2, Beta1Pow,
                      Beta2Pow, *_adam_attrs(attrs))


@register_op("fused_sgd", inputs=["Param*", "Grad*", "LearningRate"],
             outputs=["ParamOut*"], no_grad=True,
             in_place={"ParamOut": "Param"})
def fused_sgd(ctx, attrs, Param, Grad, LearningRate):
    """Every member's SGD update, bit for bit the per-parameter op's."""
    return {"ParamOut": _opt.multi_sgd_(Param, Grad, LearningRate)}


@register_op("fused_adam",
             inputs=["Param*", "Grad*", "LearningRate", "Moment1*",
                     "Moment2*", "Beta1Pow*", "Beta2Pow*"],
             outputs=["ParamOut*", "Moment1Out*", "Moment2Out*",
                      "Beta1PowOut*", "Beta2PowOut*"],
             no_grad=True, in_place=_ADAM_IN_PLACE)
def fused_adam(ctx, attrs, Param, Grad, LearningRate, Moment1, Moment2,
               Beta1Pow, Beta2Pow):
    """Every member's Adam update, each with its own beta powers, bit for
    bit the per-parameter op's."""
    outs = _opt.multi_adam_(Param, Grad, LearningRate, Moment1, Moment2,
                            Beta1Pow, Beta2Pow, *_adam_attrs(attrs))
    return dict(zip(("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
                     "Beta2PowOut"), outs))


def _lr(LearningRate):
    return LearningRate.reshape(()).float()


def _norm(x):
    return torch.sqrt(torch.sum(torch.square(x)))


def _write(dsts, srcs):
    """Each result copied into its resident tensor, in its dtype."""
    for d, s in zip(dsts, srcs):
        d.copy_(s.reshape(d.shape))
    return dsts


@register_op("lars_momentum",
             inputs=["Param", "Grad", "Velocity", "LearningRate"],
             outputs=["ParamOut", "VelocityOut"], no_grad=True,
             in_place={"ParamOut": "Param", "VelocityOut": "Velocity"})
def lars_momentum(ctx, attrs, Param, Grad, Velocity, LearningRate):
    """``local_lr = lr * coeff * |p| / (|g| + decay * |p| + 1e-12)``
    (``lr`` where either norm is 0); ``v = mu * v + local_lr * (g +
    decay * p)``; ``p -= v``."""
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 0.001)
    decay = attrs.get("lars_weight_decay", 0.0005)
    lr = _lr(LearningRate)
    p32, g32 = Param.float(), Grad.float()
    p_norm, g_norm = _norm(p32), _norm(g32)
    local_lr = torch.where(
        (p_norm > 0) & (g_norm > 0),
        lr * coeff * p_norm / (g_norm + decay * p_norm + 1e-12), lr)
    v = mu * Velocity.float() + local_lr * (g32 + decay * p32)
    p, v_out = _write((Param, Velocity), (p32 - v, v))
    return {"ParamOut": p, "VelocityOut": v_out}


@register_op("lamb",
             inputs=["Param", "Grad", "LearningRate", "Moment1", "Moment2",
                     "Beta1Pow", "Beta2Pow"],
             outputs=["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
                      "Beta2PowOut"],
             no_grad=True, in_place=_ADAM_IN_PLACE)
def lamb(ctx, attrs, Param, Grad, LearningRate, Moment1, Moment2, Beta1Pow,
         Beta2Pow):
    """Adam's moments with bias correction, ``update = m1_hat /
    (sqrt(m2_hat) + eps) + weight_decay * p``, and ``p -= lr * ratio *
    update`` with the trust ratio ``|p| / |update|`` (1 where either is
    0), all in float32."""
    beta1 = attrs.get("beta1", 0.9)
    beta2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    lr = _lr(LearningRate)
    p32, g32 = Param.float(), Grad.float()
    b1p = Beta1Pow.reshape(()).float()
    b2p = Beta2Pow.reshape(()).float()
    m1 = beta1 * Moment1.float() + (1 - beta1) * g32
    m2 = beta2 * Moment2.float() + (1 - beta2) * torch.square(g32)
    update = (m1 / (1 - b1p)) / (torch.sqrt(m2 / (1 - b2p)) + eps) \
        + wd * p32
    w_norm, u_norm = _norm(p32), _norm(update)
    ratio = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                        torch.ones_like(w_norm))
    outs = _write((Param, Moment1, Moment2, Beta1Pow, Beta2Pow),
                  (p32 - lr * ratio * update, m1, m2, b1p * beta1,
                   b2p * beta2))
    return dict(zip(("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
                     "Beta2PowOut"), outs))
