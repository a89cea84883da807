"""Op-wrapping layers (mirrors ``paddle_tpu/layers/ops.py``: the unary
generator :18 for ``gelu`` :56, ``cumsum`` :137)."""

from ..layer_helper import LayerHelper

__all__ = ["gelu", "cumsum"]


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


gelu = _generate_unary("gelu")


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
