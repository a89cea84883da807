"""Tensor-creation layers (mirrors ``paddle_tpu/layers/tensor.py``
``fill_constant`` :111)."""

from ..layer_helper import LayerHelper

__all__ = ["fill_constant"]


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant", **locals())
    if out is None:
        out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="fill_constant", outputs={"Out": [out]},
        attrs={"shape": [int(s) for s in shape], "dtype": dtype,
               "value": float(value)},
        stop_gradient=True)
    out.stop_gradient = True
    return out
