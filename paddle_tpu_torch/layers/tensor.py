"""Tensor layers (mirrors ``paddle_tpu/layers/tensor.py``: ``cast`` :54,
``concat`` :69, ``assign`` :84, ``fill_constant`` :111,
``fill_constant_batch_size_like`` :129, ``range`` :202,
``tensor_array_to_tensor`` :298, ``sums`` :75, ``ones`` / ``zeros`` /
``ones_like`` / ``zeros_like`` :150-176; ``create_tensor`` :37,
``create_global_var`` :44, ``has_inf`` / ``has_nan`` / ``isfinite``
:180-199, ``linspace`` :220, ``diag`` :244, ``reverse`` :285)."""

import numpy as np

from .. import core
from ..framework import Variable
from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper

__all__ = ["cast", "concat", "assign", "fill_constant",
           "fill_constant_batch_size_like", "range",
           "tensor_array_to_tensor", "create_parameter", "sums", "ones",
           "zeros", "ones_like", "zeros_like", "create_tensor",
           "create_global_var", "has_inf", "has_nan", "isfinite",
           "linspace", "diag", "reverse"]


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


def sums(input, out=None):
    helper = LayerHelper("sum", **locals())
    if out is None:
        out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="sum", inputs={"X": list(input)},
                     outputs={"Out": [out]})
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


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def _fill_like(x, value, out):
    helper = LayerHelper("fill_any_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="fill_any_like", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"value": value, "dtype": -1})
    return out


def ones_like(x, out=None):
    return _fill_like(x, 1.0, out)


def zeros_like(x, out=None):
    return _fill_like(x, 0.0, out)


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


def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """reference tensor.py create_parameter: a raw trainable parameter."""
    from ..param_attr import ParamAttr

    helper = LayerHelper("create_parameter")
    a = ParamAttr._to_attr(attr)
    if name is not None and a.name is None:
        a.name = name
    if default_initializer is not None:
        a._set_default_initializer(default_initializer)
    return helper.create_parameter(a, list(shape), dtype, is_bias=is_bias)


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", **locals())
    return helper.create_variable(name=helper.name, dtype=dtype,
                                  persistable=persistable)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A global var filled with ``value`` by the startup program."""
    helper = LayerHelper("global_var", **locals())
    var = helper.create_global_variable(dtype=dtype, shape=shape,
                                        persistable=persistable)
    helper.set_variable_initializer(var, ConstantInitializer(value))
    return var


def _bool_test(op_type, x):
    helper = LayerHelper(op_type, x=x)
    out = helper.create_variable_for_type_inference("bool", True)
    helper.append_op(type=op_type, inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def has_inf(x):
    return _bool_test("isinf", x)


def has_nan(x):
    return _bool_test("isnan", x)


def isfinite(x):
    return _bool_test("isfinite", x)


def linspace(start, stop, num, dtype):
    """Start and Stop as 1-element tensors (made from python numbers);
    a python ``num`` is the ``num`` attr, a Variable the ``Num`` input
    (read on the host at run time)."""
    helper = LayerHelper("linspace", **locals())
    start_t = start if isinstance(start, Variable) else fill_constant(
        [1], dtype, float(start))
    stop_t = stop if isinstance(stop, Variable) else fill_constant(
        [1], dtype, float(stop))
    inputs = {"Start": [start_t], "Stop": [stop_t]}
    attrs = {}
    if isinstance(num, Variable):
        inputs["Num"] = [num]
    else:
        attrs["num"] = int(num)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="linspace", inputs=inputs,
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def diag(diagonal):
    """A square matrix from a 1-D diagonal; a numpy diagonal becomes a
    constant (``assign``)."""
    if isinstance(diagonal, np.ndarray):
        return assign(np.diag(diagonal))
    helper = LayerHelper("diag", **locals())
    out = helper.create_variable_for_type_inference(diagonal.dtype)
    helper.append_op(type="diag", inputs={"Diagonal": [diagonal]},
                     outputs={"Out": [out]})
    return out


def reverse(x, axis):
    helper = LayerHelper("reverse")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="reverse", inputs={"X": [x]}, outputs={"Out": [out]},
        attrs={"axis": [axis] if isinstance(axis, int) else list(axis)})
    return out
