"""Op-wrapping layers (mirrors ``paddle_tpu/layers/ops.py``, all of it:
the unary generator :18 and its 35 activations :31-63 and :146-148
(``acos`` / ``asin`` / ``atan``), each passing its keyword attrs to its
op; ``leaky_relu`` :66 (alpha 0.02), ``pow`` :76, ``scale`` :86, the
logical ops :100-129, ``cumsum`` :137, ``uniform_random`` :153)."""

from ..layer_helper import LayerHelper

__all__ = [
    "exp", "tanh", "sqrt", "rsqrt", "abs", "ceil", "floor", "cos", "sin",
    "acos", "asin", "atan",
    "round", "reciprocal", "square", "softplus", "softsign", "logsigmoid",
    "sigmoid", "relu6", "pow", "stanh", "hard_sigmoid", "swish",
    "thresholded_relu", "hard_shrink", "softshrink", "elu", "gelu", "erf",
    "brelu", "soft_relu", "leaky_relu", "log", "scale", "hard_swish",
    "sign", "tanh_shrink", "cumsum", "uniform_random",
    "logical_and", "logical_or", "logical_xor", "logical_not",
]


def _generate_unary(op_type):
    def func(x, name=None, **kwargs):
        helper = LayerHelper(op_type, **locals())
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(
            type=op_type, inputs={"X": [x]}, outputs={"Out": [out]},
            attrs={k: v for k, v in kwargs.items() if v is not None})
        return out

    func.__name__ = op_type
    return func


exp = _generate_unary("exp")
tanh = _generate_unary("tanh")
sqrt = _generate_unary("sqrt")
rsqrt = _generate_unary("rsqrt")
abs = _generate_unary("abs")
ceil = _generate_unary("ceil")
floor = _generate_unary("floor")
cos = _generate_unary("cos")
sin = _generate_unary("sin")
round = _generate_unary("round")
reciprocal = _generate_unary("reciprocal")
square = _generate_unary("square")
softplus = _generate_unary("softplus")
softsign = _generate_unary("softsign")
logsigmoid = _generate_unary("logsigmoid")
sigmoid = _generate_unary("sigmoid")
relu6 = _generate_unary("relu6")
stanh = _generate_unary("stanh")
hard_sigmoid = _generate_unary("hard_sigmoid")
swish = _generate_unary("swish")
thresholded_relu = _generate_unary("thresholded_relu")
hard_shrink = _generate_unary("hard_shrink")
softshrink = _generate_unary("softshrink")
elu = _generate_unary("elu")
gelu = _generate_unary("gelu")
erf = _generate_unary("erf")
brelu = _generate_unary("brelu")
soft_relu = _generate_unary("soft_relu")
log = _generate_unary("log")
sign = _generate_unary("sign")
tanh_shrink = _generate_unary("tanh_shrink")
hard_swish = _generate_unary("hard_swish")
acos = _generate_unary("acos")
asin = _generate_unary("asin")
atan = _generate_unary("atan")


def leaky_relu(x, alpha=0.02, name=None):
    helper = LayerHelper("leaky_relu", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="leaky_relu", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"alpha": alpha})
    return out


def pow(x, factor=1.0, name=None):
    helper = LayerHelper("pow", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="pow", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"factor": float(factor)})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def _generate_binary_logical(op_type):
    def func(x, y, out=None, name=None):
        helper = LayerHelper(op_type, **locals())
        if out is None:
            out = helper.create_variable_for_type_inference("bool")
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]})
        return out

    func.__name__ = op_type
    return func


logical_and = _generate_binary_logical("logical_and")
logical_or = _generate_binary_logical("logical_or")
logical_xor = _generate_binary_logical("logical_xor")


def logical_not(x, out=None, name=None):
    helper = LayerHelper("logical_not", **locals())
    if out is None:
        out = helper.create_variable_for_type_inference("bool")
    helper.append_op(type="logical_not", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def cumsum(x, axis=None, exclusive=None, reverse=None):
    helper = LayerHelper("cumsum", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    attrs = {}
    if axis is not None:
        attrs["axis"] = int(axis)
    if exclusive is not None:
        attrs["exclusive"] = bool(exclusive)
    if reverse is not None:
        attrs["reverse"] = bool(reverse)
    helper.append_op(type="cumsum", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random", **locals())
    out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op(
        type="uniform_random", inputs={}, outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": dtype, "min": float(min),
               "max": float(max), "seed": int(seed)})
    return out
