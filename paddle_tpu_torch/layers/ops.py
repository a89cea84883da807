"""Op-wrapping layers (mirrors ``paddle_tpu/layers/ops.py``: the unary
generator :18 for ``exp`` :31, ``tanh`` :33, ``sqrt`` :34, ``ceil`` /
``floor`` :36-37, ``cos`` :38, ``square`` :43, ``log`` :60, ``sigmoid`` :47, ``gelu`` :56, ``sign``
:60; ``pow`` :76, ``scale`` :86, the logical ops :100-129, ``cumsum``
:137)."""

from ..layer_helper import LayerHelper

__all__ = ["exp", "tanh", "sigmoid", "sqrt", "ceil", "floor", "cos",
           "sign", "gelu", "log", "square", "pow", "scale", "logical_and", "logical_or",
           "logical_xor", "logical_not", "cumsum"]


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
sigmoid = _generate_unary("sigmoid")
sqrt = _generate_unary("sqrt")
ceil = _generate_unary("ceil")
floor = _generate_unary("floor")
cos = _generate_unary("cos")
gelu = _generate_unary("gelu")
sign = _generate_unary("sign")
log = _generate_unary("log")
square = _generate_unary("square")


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
