"""3-D convolution and pooling, the sequence convolution and the
deformable layers of the third wave of ``layers.nn`` (mirrors
``paddle_tpu/layers/nn_extra2.py``: ``conv3d`` :433, ``conv3d_transpose``
:464, ``pool3d`` :500, ``sequence_conv`` :588, ``deformable_conv`` :705,
``deformable_roi_pooling`` :739) and ``host_embedding`` :77-116, the
lookup into a host-resident table (:mod:`..host_table`).  Each appends
the reference's op type, slots and attrs."""

from ..framework import default_main_program
from ..layer_helper import LayerHelper
from .nn import _pair
from .nn_extra import _simple

__all__ = ["conv3d", "conv3d_transpose", "pool3d", "sequence_conv",
           "deformable_conv", "deformable_roi_pooling", "host_embedding"]


def _triple(v):
    return _pair(v, 3)


def conv3d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=None, param_attr=None, bias_attr=None,
           use_cudnn=True, act=None, name=None):
    """NCDHW convolution; the filter is [C_out, C_in / groups, kd, kh,
    kw]."""
    helper = LayerHelper("conv3d", **locals())
    dtype = helper.input_dtype()
    g = groups or 1
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[num_filters, input.shape[1] // g] + _triple(filter_size),
        dtype=dtype, is_bias=False)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv3d", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={"strides": _triple(stride), "paddings": _triple(padding),
               "dilations": _triple(dilation), "groups": g})
    pre_act = helper.append_bias_op(out, dim_start=1)
    return helper.append_activation(pre_act)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    """NCDHW transposed convolution; the filter is [C_in, num_filters,
    kd, kh, kw], as the reference declares it."""
    helper = LayerHelper("conv3d_transpose", **locals())
    dtype = helper.input_dtype()
    if filter_size is None:
        raise NotImplementedError(
            "conv3d_transpose: pass filter_size explicitly "
            "(output_size-only inference is not implemented)")
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[input.shape[1], num_filters] + _triple(filter_size),
        dtype=dtype, is_bias=False)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv3d_transpose", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={"strides": _triple(stride), "paddings": _triple(padding),
               "dilations": _triple(dilation), "groups": groups or 1})
    pre_act = helper.append_bias_op(out, dim_start=1)
    return helper.append_activation(pre_act)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True):
    return _simple(
        "pool3d", {"X": input},
        {"pooling_type": pool_type, "ksize": _triple(pool_size),
         "strides": _triple(pool_stride), "paddings": _triple(pool_padding),
         "global_pooling": global_pooling, "exclusive": exclusive})


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, padding_start=None, bias_attr=None,
                  param_attr=None, act=None, name=None, seq_len=None):
    """Context-window convolution of a padded [B, T, D] batch (and its
    ``seq_len``): the filter is [filter_size · D, num_filters]."""
    helper = LayerHelper("sequence_conv", **locals())
    dtype = helper.input_dtype()
    d = input.shape[-1]
    w = helper.create_parameter(
        attr=helper.param_attr, shape=[filter_size * d, num_filters],
        dtype=dtype, is_bias=False)
    start = (-int(filter_size // 2) if padding_start is None
             else int(padding_start))
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [input], "Filter": [w]}
    if seq_len is not None:
        inputs["SeqLen"] = [seq_len]
    helper.append_op(
        type="sequence_conv", inputs=inputs, outputs={"Out": [out]},
        attrs={"contextLength": int(filter_size), "contextStart": start,
               "contextStride": int(filter_stride)})
    pre_act = helper.append_bias_op(out, dim_start=2)
    return helper.append_activation(pre_act)


def deformable_conv(input, offset, mask, num_filters, filter_size,
                    stride=1, padding=0, dilation=1, groups=None,
                    deformable_groups=None, im2col_step=None,
                    param_attr=None, bias_attr=None, modulated=True,
                    name=None):
    """Deformable convolution v2 (modulated by ``mask``; v1 with
    ``mask=None``); the filter is [num_filters, C_in / groups, kh, kw]."""
    helper = LayerHelper("deformable_conv", **locals())
    dtype = helper.input_dtype()
    g = groups or 1
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[num_filters, input.shape[1] // g] + _pair(filter_size),
        dtype=dtype, is_bias=False)
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Offset": [offset], "Filter": [w]}
    if modulated and mask is not None:
        inputs["Mask"] = [mask]
    helper.append_op(
        type="deformable_conv", inputs=inputs, outputs={"Output": [out]},
        attrs={"strides": _pair(stride), "paddings": _pair(padding),
               "dilations": _pair(dilation), "groups": g,
               "deformable_groups": deformable_groups or 1})
    pre_act = helper.append_bias_op(out, dim_start=1)
    return helper.append_activation(pre_act)


def deformable_roi_pooling(input, rois, trans, no_trans=False,
                           spatial_scale=1.0, group_size=(1, 1),
                           pooled_height=1, pooled_width=1, part_size=None,
                           sample_per_part=1, trans_std=0.1,
                           position_sensitive=True, name=None):
    out_dim = input.shape[1] // (pooled_height * pooled_width) \
        if position_sensitive else input.shape[1]
    out, _ = _simple(
        "deformable_psroi_pooling",
        {"Input": input, "ROIs": rois,
         "Trans": None if no_trans else trans},
        {"spatial_scale": float(spatial_scale),
         "pooled_height": int(pooled_height),
         "pooled_width": int(pooled_width),
         "output_dim": int(out_dim), "trans_std": float(trans_std),
         "sample_per_part": int(sample_per_part),
         "no_trans": bool(no_trans)},
        outs=("Output", "TopCount"))
    return out


def host_embedding(input, size, name, lr=0.1, optimizer="sgd",
                   dtype="float32", initializer=None, seed=0):
    """A lookup into a host-resident table ``name`` of ``size=[rows,
    dim]`` (:mod:`paddle_tpu_torch.host_table`), which the card never
    holds.  Returns the slab var ``<name>@SLAB@<ids>`` ([ids..., dim]),
    an ``is_data`` var the executor fills with the batch's rows before
    each step; it fetches the slab's gradient and the table applies it
    with its own rule (``sgd`` or ``adagrad``) and ``lr`` on a host
    thread.  ``input`` must be a data var fed directly (the rows are
    gathered from its value before the step), in the top-level block."""
    from .. import host_table

    rows, dim = int(size[0]), int(size[1])
    host_table.get_or_create(name, rows, dim, dtype=dtype, lr=lr,
                             optimizer=optimizer, initializer=initializer,
                             seed=seed)
    block = default_main_program().current_block()
    if block.idx != 0:
        raise ValueError("host_embedding must sit in the top-level block "
                         "(the prefetch runs around the whole step)")
    slab_name = "%s@SLAB@%s" % (name, input.name)
    slab = block.create_var(name=slab_name,
                            shape=list(input.shape) + [dim], dtype=dtype,
                            stop_gradient=False, is_data=True)
    prog = block.program
    if not hasattr(prog, "_host_tables"):
        prog._host_tables = []
    prog._host_tables.append(
        {"table": name, "ids": input.name, "slab": slab_name})
    return slab
