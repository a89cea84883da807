"""Optimizer update ops (mirrors ``paddle_tpu/ops/optimizer_ops.py``:
``sgd`` :22, ``momentum`` :28-43, ``adam`` :46-77, the multi-tensor
``fused_sgd`` :347-363 and ``fused_adam`` :366-435).

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
they lie instead of through a flat concatenation."""

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
