"""Operator overloads of ``Variable`` (mirrors
``paddle_tpu/layers/math_op_patch.py``): ``x + 2.0``, ``x * y``,
``step < 10.0``.  A Python scalar on the right of ``+``, ``-``, ``*`` or
``/`` becomes one ``scale`` op; any other scalar operand a ``[1]``
``fill_constant``.  The learning-rate schedules are written with
them."""

from ..framework import Variable
from ..layer_helper import LayerHelper

_SCALAR_SHORTCUTS = {
    "elementwise_add": lambda s: {"scale": 1.0, "bias": float(s)},
    "elementwise_sub": lambda s: {"scale": 1.0, "bias": -float(s)},
    "elementwise_mul": lambda s: {"scale": float(s), "bias": 0.0},
}


def binary_op(x, other, op_type, reverse=False):
    """``x <op> other`` (``other <op> x`` with ``reverse``)."""
    helper = LayerHelper(op_type)
    if not isinstance(other, Variable):
        s = float(other)
        if not reverse and op_type in _SCALAR_SHORTCUTS:
            out = helper.create_variable_for_type_inference(x.dtype)
            helper.append_op(type="scale", inputs={"X": [x]},
                             outputs={"Out": [out]},
                             attrs=_SCALAR_SHORTCUTS[op_type](s))
            return out
        if not reverse and op_type == "elementwise_div":
            out = helper.create_variable_for_type_inference(x.dtype)
            helper.append_op(type="scale", inputs={"X": [x]},
                             outputs={"Out": [out]},
                             attrs={"scale": 1.0 / s, "bias": 0.0})
            return out
        from .tensor import fill_constant

        other = fill_constant([1], x.dtype, s)
    a, b = (other, x) if reverse else (x, other)
    out = helper.create_variable_for_type_inference(
        a.dtype if isinstance(a, Variable) else b.dtype)
    helper.append_op(type=op_type, inputs={"X": [a], "Y": [b]},
                     outputs={"Out": [out]}, attrs={"axis": -1})
    return out
