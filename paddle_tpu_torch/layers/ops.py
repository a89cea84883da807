"""Op-wrapping layers (mirrors ``paddle_tpu/layers/ops.py``: ``cumsum``
:137)."""

from ..layer_helper import LayerHelper

__all__ = ["cumsum"]


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
