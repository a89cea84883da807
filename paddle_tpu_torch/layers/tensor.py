"""Tensor layers (mirrors ``paddle_tpu/layers/tensor.py``: ``cast`` :54,
``assign`` :84, ``fill_constant`` :111, ``fill_constant_batch_size_like``
:129, ``range`` :202)."""

from .. import core
from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = ["cast", "assign", "fill_constant",
           "fill_constant_batch_size_like", "range"]


def cast(x, dtype):
    helper = LayerHelper("cast", **locals())
    dtype = core.convert_np_dtype_to_dtype_(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    return out


def assign(input, output=None):
    """Copy a Variable into ``output`` (a new var by default).  The
    reference's numpy-array form (``assign_value``) is not ported yet
    (ROADMAP.md, Queue A item 5)."""
    if not isinstance(input, Variable):
        raise NotImplementedError(
            "assign of a %s needs the assign_value op, which is not ported "
            "yet (ROADMAP.md, Queue A item 5); pass a Variable"
            % type(input).__name__)
    helper = LayerHelper("assign", **locals())
    if output is None:
        output = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="assign", inputs={"X": [input]},
                     outputs={"Out": [output]})
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
