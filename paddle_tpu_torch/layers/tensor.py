"""Tensor-creation layers (mirrors ``paddle_tpu/layers/tensor.py``
``fill_constant`` :111, ``fill_constant_batch_size_like`` :129)."""

from ..layer_helper import LayerHelper

__all__ = ["fill_constant", "fill_constant_batch_size_like"]


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


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    """A constant whose ``output_dim_idx`` dim is ``input``'s
    ``input_dim_idx`` dim (the batch) at run time."""
    helper = LayerHelper("fill_constant_batch_size_like", **locals())
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="fill_constant_batch_size_like", inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={"shape": [int(s) for s in shape], "dtype": dtype,
               "value": float(value), "input_dim_idx": input_dim_idx,
               "output_dim_idx": output_dim_idx},
        stop_gradient=True)
    out.stop_gradient = True
    return out
