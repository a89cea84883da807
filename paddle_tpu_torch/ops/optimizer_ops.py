"""Optimizer update ops (mirrors ``paddle_tpu/ops/optimizer_ops.py``:
``sgd`` :22, ``momentum`` :28-43, ``adam`` :46-77).  Plain PyTorch; each op returns new
tensors that the executor binds to the parameter's and accumulators'
names, since it never updates a scope value in place.  The reference's
multi-tensor ``fused_adam`` rewrite is rejected at BERT scale by its own
cost model (``static_analysis/fusion.py:50-56``) and is not ported."""

import torch

from .registry import register_op


def _lr(LearningRate, dtype):
    return LearningRate.reshape(()).to(dtype)


@register_op("sgd", inputs=["Param", "Grad", "LearningRate"],
             outputs=["ParamOut"], no_grad=True)
def sgd(ctx, attrs, Param, Grad, LearningRate):
    return Param - _lr(LearningRate, Param.dtype) * Grad.to(Param.dtype)


@register_op("momentum", inputs=["Param", "Grad", "Velocity", "LearningRate"],
             outputs=["ParamOut", "VelocityOut"], no_grad=True)
def momentum(ctx, attrs, Param, Grad, Velocity, LearningRate):
    """``v = mu * v + g``; Nesterov ``p -= (g + mu * v) * lr``, else
    ``p -= lr * v``."""
    mu = float(attrs.get("mu", 0.9))
    lr = _lr(LearningRate, Param.dtype)
    g = Grad.to(Param.dtype)
    v = mu * Velocity + g
    if attrs.get("use_nesterov", False):
        p = Param - (g + mu * v) * lr
    else:
        p = Param - lr * v
    return {"ParamOut": p, "VelocityOut": v}


@register_op("adam",
             inputs=["Param", "Grad", "LearningRate", "Moment1", "Moment2",
                     "Beta1Pow", "Beta2Pow"],
             outputs=["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
                      "Beta2PowOut"],
             no_grad=True)
def adam(ctx, attrs, Param, Grad, LearningRate, Moment1, Moment2, Beta1Pow,
         Beta2Pow):
    beta1 = attrs.get("beta1", 0.9)
    beta2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr = _lr(LearningRate, torch.float32)
    g = Grad.float()
    m1n = beta1 * Moment1.float() + (1 - beta1) * g
    m2n = beta2 * Moment2.float() + (1 - beta2) * torch.square(g)
    b1p = Beta1Pow.reshape(()).float()
    b2p = Beta2Pow.reshape(()).float()
    # Beta{1,2}Pow hold beta^t when this op reads them (init beta, advanced
    # after use): the reference's bias correction
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    p = Param.float() - lr_t * m1n / (torch.sqrt(m2n) + eps)
    return {"ParamOut": p.to(Param.dtype),
            "Moment1Out": m1n.to(Moment1.dtype),
            "Moment2Out": m2n.to(Moment2.dtype),
            "Beta1PowOut": (b1p * beta1).reshape(Beta1Pow.shape)
            .to(Beta1Pow.dtype),
            "Beta2PowOut": (b2p * beta2).reshape(Beta2Pow.shape)
            .to(Beta2Pow.dtype)}
