"""Optimizer update ops (mirrors ``paddle_tpu/ops/optimizer_ops.py``:
``sgd`` :22, ``momentum`` :28-43, ``adam`` :46-77, ``lars_momentum`` :202-225,
``lamb`` :228-260, the multi-tensor ``fused_sgd`` :347-363 and
``fused_adam`` :366-435; ``adamax`` :86, ``adagrad`` :104,
``decayed_adagrad`` :117, ``adadelta`` :131, ``rmsprop`` :151, ``ftrl``
:181, ``average_accumulates`` :274, ``proximal_gd`` :315 and
``proximal_adagrad`` :331).

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

``lamb``, ``lars_momentum`` and the nine other updates (``adamax``,
``adagrad``, ``decayed_adagrad``, ``adadelta``, ``rmsprop``, ``ftrl``,
``average_accumulates``, ``proximal_gd``, ``proximal_adagrad``) are the
reference's XLA fusions written as PyTorch ops on the device (LAMB's and
LARS's norms included, never read on the host), their results copied
into the resident tensors; a hand-written kernel for them waits for a
benchmark (ROADMAP.md, Queue B).  ``average_accumulates`` keeps its
counters on the device and its fold and window restart as
``torch.where`` selects, as the reference's ``jnp.where``: no host read,
so a step with it stays capturable.  ``proximal_gd`` and
``proximal_adagrad`` return bare tensors, as the reference's do; the
registry maps them to ``ParamOut`` and ``MomentOut`` in order."""

import torch

from .common import scalar_like
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
    """Each result copied into its resident tensor, in its dtype (a
    result that is its resident tensor is left as it is)."""
    for d, s in zip(dsts, srcs):
        if s is not d:
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


def _lr_as(LearningRate, Param):
    """The rate as a scalar of the parameter's dtype, as the reference's
    ``_lr(LearningRate, Param.dtype)``."""
    return LearningRate.reshape(()).to(Param.dtype)


@register_op("adamax",
             inputs=["Param", "Grad", "LearningRate", "Moment", "InfNorm",
                     "Beta1Pow"],
             outputs=["ParamOut", "MomentOut", "InfNormOut"], no_grad=True,
             in_place={"ParamOut": "Param", "MomentOut": "Moment",
                       "InfNormOut": "InfNorm"})
def adamax(ctx, attrs, Param, Grad, LearningRate, Moment, InfNorm, Beta1Pow):
    """``m = b1 m + (1 - b1) g``, ``u = max(b2 u, |g| + eps)``, ``p -= lr
    / (1 - b1^t) * m / u``; ``Beta1Pow`` is read, and advanced by the
    optimizer's ``scale`` op after it."""
    beta1 = attrs.get("beta1", 0.9)
    beta2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr = _lr_as(LearningRate, Param)
    m = beta1 * Moment + (1 - beta1) * Grad
    inf = torch.maximum(beta2 * InfNorm, torch.abs(Grad) + eps)
    b1p = Beta1Pow.reshape(()).to(Param.dtype)
    p = Param - (lr / (1 - b1p)) * (m / inf)
    return dict(zip(("ParamOut", "MomentOut", "InfNormOut"),
                    _write((Param, Moment, InfNorm), (p, m, inf))))


@register_op("adagrad", inputs=["Param", "Grad", "Moment", "LearningRate"],
             outputs=["ParamOut", "MomentOut"], no_grad=True,
             in_place={"ParamOut": "Param", "MomentOut": "Moment"})
def adagrad(ctx, attrs, Param, Grad, Moment, LearningRate):
    """``m += g^2``; ``p -= lr * g / (sqrt(m) + eps)``."""
    eps = attrs.get("epsilon", 1e-6)
    m = Moment + torch.square(Grad)
    p = Param - _lr_as(LearningRate, Param) * Grad / (torch.sqrt(m) + eps)
    return dict(zip(("ParamOut", "MomentOut"),
                    _write((Param, Moment), (p, m))))


@register_op("decayed_adagrad",
             inputs=["Param", "Grad", "Moment", "LearningRate"],
             outputs=["ParamOut", "MomentOut"], no_grad=True,
             in_place={"ParamOut": "Param", "MomentOut": "Moment"})
def decayed_adagrad(ctx, attrs, Param, Grad, Moment, LearningRate):
    """``m = decay m + (1 - decay) g^2``; ``p -= lr * g / (sqrt(m) +
    eps)``."""
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    m = decay * Moment + (1 - decay) * torch.square(Grad)
    p = Param - _lr_as(LearningRate, Param) * Grad / (torch.sqrt(m) + eps)
    return dict(zip(("ParamOut", "MomentOut"),
                    _write((Param, Moment), (p, m))))


@register_op("adadelta",
             inputs=["Param", "Grad", "AvgSquaredGrad", "AvgSquaredUpdate"],
             outputs=["ParamOut", "AvgSquaredGradOut",
                      "AvgSquaredUpdateOut"], no_grad=True,
             in_place={"ParamOut": "Param",
                       "AvgSquaredGradOut": "AvgSquaredGrad",
                       "AvgSquaredUpdateOut": "AvgSquaredUpdate"})
def adadelta(ctx, attrs, Param, Grad, AvgSquaredGrad, AvgSquaredUpdate):
    """No learning rate: ``g2 = rho g2 + (1 - rho) g^2``, ``d = -sqrt((u2
    + eps) / (g2 + eps)) g``, ``u2 = rho u2 + (1 - rho) d^2``, ``p +=
    d``."""
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    asg = rho * AvgSquaredGrad + (1 - rho) * torch.square(Grad)
    update = -torch.sqrt((AvgSquaredUpdate + eps) / (asg + eps)) * Grad
    asu = rho * AvgSquaredUpdate + (1 - rho) * torch.square(update)
    outs = _write((Param, AvgSquaredGrad, AvgSquaredUpdate),
                  (Param + update, asg, asu))
    return dict(zip(("ParamOut", "AvgSquaredGradOut",
                     "AvgSquaredUpdateOut"), outs))


@register_op("rmsprop",
             inputs=["Param", "Grad", "MeanSquare", "MeanGrad", "Moment",
                     "LearningRate"],
             outputs=["ParamOut", "MomentOut", "MeanSquareOut",
                      "MeanGradOut"], no_grad=True,
             in_place={"ParamOut": "Param", "MomentOut": "Moment",
                       "MeanSquareOut": "MeanSquare",
                       "MeanGradOut": "MeanGrad"})
def rmsprop(ctx, attrs, Param, Grad, MeanSquare, MeanGrad, Moment,
            LearningRate):
    """``ms = decay ms + (1 - decay) g^2``; centered, ``mg = decay mg +
    (1 - decay) g`` and the denominator ``ms - mg^2 + eps``, else ``ms +
    eps`` (``mg`` unchanged); ``mom = momentum mom + lr g /
    sqrt(denominator)``; ``p -= mom``."""
    eps = attrs.get("epsilon", 1e-10)
    decay = attrs.get("decay", 0.9)
    mom_coef = attrs.get("momentum", 0.0)
    lr = _lr_as(LearningRate, Param)
    ms = decay * MeanSquare + (1 - decay) * torch.square(Grad)
    if attrs.get("centered", False):
        mg = decay * MeanGrad + (1 - decay) * Grad
        denom = ms - torch.square(mg) + eps
    else:
        mg = MeanGrad
        denom = ms + eps
    mom = mom_coef * Moment + lr * Grad / torch.sqrt(denom)
    outs = _write((Param, Moment, MeanSquare, MeanGrad),
                  (Param - mom, mom, ms, mg))
    return dict(zip(("ParamOut", "MomentOut", "MeanSquareOut",
                     "MeanGradOut"), outs))


@register_op("ftrl",
             inputs=["Param", "SquaredAccumulator", "LinearAccumulator",
                     "Grad", "LearningRate"],
             outputs=["ParamOut", "SquaredAccumOut", "LinearAccumOut"],
             no_grad=True,
             in_place={"ParamOut": "Param",
                       "SquaredAccumOut": "SquaredAccumulator",
                       "LinearAccumOut": "LinearAccumulator"})
def ftrl(ctx, attrs, Param, SquaredAccumulator, LinearAccumulator, Grad,
         LearningRate):
    """FTRL-proximal: ``n' = n + g^2``; ``sigma = (n'^-k - n^-k) / lr``
    with ``k = lr_power`` (square roots at -0.5); ``z += g - sigma p``;
    ``p = (l1 sign(z) - z) / (l2 + n'^-k / lr)`` where ``|z| > l1``, else
    0 (``l1``, ``l2`` each plus 1e-10)."""
    l1 = attrs.get("l1", 0.0) + 1e-10
    l2 = attrs.get("l2", 0.0) + 1e-10
    lr_power = attrs.get("lr_power", -0.5)
    lr = _lr_as(LearningRate, Param)
    sq = SquaredAccumulator
    new_sq = sq + torch.square(Grad)
    if lr_power == -0.5:
        new_root = torch.sqrt(new_sq)
        sigma = (new_root - torch.sqrt(sq)) / lr
    else:
        new_root = new_sq ** (-lr_power)
        sigma = (new_root - sq ** (-lr_power)) / lr
    linear = LinearAccumulator + Grad - sigma * Param
    x = l2 + new_root / lr
    pre_shrink = (l1 * torch.sign(linear) - linear) / x
    p = torch.where(torch.abs(linear) > l1, pre_shrink,
                    torch.zeros_like(Param))
    outs = _write((Param, SquaredAccumulator, LinearAccumulator),
                  (p, new_sq, linear))
    return dict(zip(("ParamOut", "SquaredAccumOut", "LinearAccumOut"), outs))


# the fold period of the three-tier sums (the reference's
# ``kMaxNumAccumulates``, average_accumulates_op.h)
K_MAX_NUM_ACCUMULATES = 16384


@register_op("average_accumulates",
             inputs=["param", "in_sum_1", "in_sum_2", "in_sum_3",
                     "in_num_accumulates", "in_old_num_accumulates",
                     "in_num_updates"],
             outputs=["out_sum_1", "out_sum_2", "out_sum_3",
                      "out_num_accumulates", "out_old_num_accumulates",
                      "out_num_updates"], no_grad=True,
             in_place={"out_sum_1": "in_sum_1", "out_sum_2": "in_sum_2",
                       "out_sum_3": "in_sum_3",
                       "out_num_accumulates": "in_num_accumulates",
                       "out_old_num_accumulates": "in_old_num_accumulates",
                       "out_num_updates": "in_num_updates"})
def average_accumulates(ctx, attrs, param, in_sum_1, in_sum_2, in_sum_3,
                        in_num_accumulates, in_old_num_accumulates,
                        in_num_updates):
    """ModelAverage's sliding-window sums: ``sum_1 += param``; every
    16384th update folds ``sum_1`` into ``sum_2``; once ``num_accumulates``
    reaches ``min_average_window`` and ``min(max_average_window,
    num_updates * average_window)`` the window restarts (``sum_3 = sum_1
    + sum_2``, the old count kept).  The counters stay on the device and
    both branches are selects."""
    avg_window = float(attrs.get("average_window", 0.0))
    max_w = int(attrs.get("max_average_window", 10000))
    min_w = int(attrs.get("min_average_window", 10000))
    nu = in_num_updates + 1
    na = in_num_accumulates + 1
    s1 = in_sum_1 + param.to(in_sum_1.dtype)
    fold = (nu % K_MAX_NUM_ACCUMULATES) == 0
    s2 = torch.where(fold, in_sum_2 + s1, in_sum_2)
    s1 = torch.where(fold, torch.zeros_like(s1), s1)
    window = torch.clamp(nu.float() * avg_window, max=float(max_w))
    restart = (na >= min_w) & (na.float() >= window)
    s3 = torch.where(restart, s1 + s2, in_sum_3)
    s1 = torch.where(restart, torch.zeros_like(s1), s1)
    s2 = torch.where(restart, torch.zeros_like(s2), s2)
    ona = torch.where(restart, na, in_old_num_accumulates)
    na = torch.where(restart, torch.zeros_like(na), na)
    outs = _write((in_sum_1, in_sum_2, in_sum_3, in_num_accumulates,
                   in_old_num_accumulates, in_num_updates),
                  (s1, s2, s3, na, ona, nu))
    return dict(zip(("out_sum_1", "out_sum_2", "out_sum_3",
                     "out_num_accumulates", "out_old_num_accumulates",
                     "out_num_updates"), outs))


def _shrink(prox, lr, l1, l2):
    """The proximal step: soft threshold ``lr * l1``, decay ``1 / (1 +
    lr * l2)``."""
    shrink = torch.clamp(torch.abs(prox) - lr * l1, min=0.0)
    return torch.sign(prox) * shrink / (1.0 + lr * l2)


@register_op("proximal_gd", inputs=["Param", "Grad", "LearningRate"],
             outputs=["ParamOut"], no_grad=True,
             in_place={"ParamOut": "Param"})
def proximal_gd(ctx, attrs, Param, Grad, LearningRate):
    """``prox = p - lr g``, then the shrinkage with ``l1`` and ``l2``."""
    lr = _lr_as(LearningRate, Param)
    l1 = scalar_like(attrs.get("l1", 0.0), Param)
    l2 = scalar_like(attrs.get("l2", 0.0), Param)
    p = _shrink(Param - lr * Grad, lr, l1, l2)
    return _write((Param,), (p,))[0]


@register_op("proximal_adagrad",
             inputs=["Param", "Moment", "Grad", "LearningRate"],
             outputs=["ParamOut", "MomentOut"], no_grad=True,
             in_place={"ParamOut": "Param", "MomentOut": "Moment"})
def proximal_adagrad(ctx, attrs, Param, Moment, Grad, LearningRate):
    """``m += g^2``; the gradient step with the adaptive rate ``lr /
    sqrt(m)``, the shrinkage with the plain ``lr``."""
    lr = _lr_as(LearningRate, Param)
    l1 = scalar_like(attrs.get("l1", 0.0), Param)
    l2 = scalar_like(attrs.get("l2", 0.0), Param)
    m = Moment + Grad * Grad
    p = _shrink(Param - (lr / torch.sqrt(m)) * Grad, lr, l1, l2)
    return tuple(_write((Param, Moment), (p, m)))
