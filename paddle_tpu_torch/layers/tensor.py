"""Tensor layers (mirrors ``paddle_tpu/layers/tensor.py``: ``cast`` :54,
``concat`` :69, ``assign`` :84, ``fill_constant`` :111,
``fill_constant_batch_size_like`` :129, ``range`` :202,
``tensor_array_to_tensor`` :298)."""

import numpy as np

from .. import core
from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = ["cast", "concat", "assign", "fill_constant",
           "fill_constant_batch_size_like", "range",
           "tensor_array_to_tensor"]


def cast(x, dtype):
    helper = LayerHelper("cast", **locals())
    dtype = core.convert_np_dtype_to_dtype_(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", **locals())
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="concat", inputs={"X": list(input)},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def assign(input, output=None):
    """Copy a Variable (``assign``) or a numpy array (``assign_value``,
    the array in the op's attrs) into ``output``, a new var by
    default."""
    helper = LayerHelper("assign", **locals())
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op(type="assign", inputs={"X": [input]},
                         outputs={"Out": [output]})
    elif isinstance(input, np.ndarray):
        if output is None:
            output = helper.create_variable_for_type_inference(
                str(input.dtype))
        helper.append_op(
            type="assign_value", outputs={"Out": [output]},
            attrs={"shape": list(input.shape), "dtype": str(input.dtype),
                   "values": input})
    else:
        raise TypeError("assign expects Variable or ndarray")
    return output


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


def range(start, end, step, dtype):
    """``arange``: python-scalar bounds become static attrs (the output
    length is then known at build time); Variable bounds are inputs."""
    helper = LayerHelper("range", **locals())
    attrs = {"dtype": dtype}
    inputs = {}
    for key, val in (("start", start), ("end", end), ("step", step)):
        if isinstance(val, Variable):
            inputs[key.capitalize()] = [val]
        else:
            attrs[key] = float(val)
    out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op(type="range", inputs=inputs, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def tensor_array_to_tensor(input, axis=1, name=None):
    """A tensor array's rows concatenated along ``axis``, and each row's
    size along it."""
    helper = LayerHelper("tensor_array_to_tensor")
    out = helper.create_variable_for_type_inference(input.dtype)
    idx = helper.create_variable_for_type_inference("int32", True)
    helper.append_op(type="tensor_array_to_tensor", inputs={"X": [input]},
                     outputs={"Out": [out], "OutIndex": [idx]},
                     attrs={"axis": int(axis)})
    return out, idx
