"""Weight-decay regularizers appended as grad ops (mirrors
``paddle_tpu/regularizer.py``: ``L2DecayRegularizer`` :15,
``L1DecayRegularizer`` :31, ``append_regularization_ops`` :56).  A
parameter's own regularizer (``ParamAttr(regularizer=...)``) wins over
the optimizer's; the decay term is added to the gradient by a ``sum``
op before the update."""

from . import unique_name
from .framework import Parameter

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    """``coeff * param``."""

    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = block.create_var(
            name=unique_name.generate(param.name + ".l2decay"),
            shape=param.shape, dtype=param.dtype)
        block.append_op(type="scale", inputs={"X": [param]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._regularization_coeff,
                               "op_role": "optimize"})
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    """``coeff * sign(param)``."""

    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        sign = block.create_var(
            name=unique_name.generate(param.name + ".sign"),
            shape=param.shape, dtype=param.dtype)
        block.append_op(type="sign", inputs={"X": [param]},
                        outputs={"Out": [sign]},
                        attrs={"op_role": "optimize"})
        decay = block.create_var(
            name=unique_name.generate(param.name + ".l1decay"),
            shape=param.shape, dtype=param.dtype)
        block.append_op(type="scale", inputs={"X": [sign]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._regularization_coeff,
                               "op_role": "optimize"})
        return decay


def append_regularization_ops(parameters_and_grads, regularization=None):
    """``grad + decay(param)`` for each regularized parameter."""
    params_and_grads = []
    for param, grad in parameters_and_grads:
        if grad is None:
            params_and_grads.append((param, grad))
            continue
        term = None
        block = grad.block
        if isinstance(param, Parameter) and param.regularizer is not None:
            term = param.regularizer(param, grad, block)
        elif regularization is not None:
            term = regularization(param, grad, block)
        if term is None:
            params_and_grads.append((param, grad))
            continue
        new_grad = block.create_var(
            name=unique_name.generate(grad.name + ".reg"),
            shape=grad.shape, dtype=grad.dtype)
        block.append_op(type="sum", inputs={"X": [grad, term]},
                        outputs={"Out": [new_grad]},
                        attrs={"op_role": "optimize"})
        params_and_grads.append((param, new_grad))
    return params_and_grads


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
