"""3-D convolution and pooling, the sequence convolution and the
deformable layers of the third wave of ``layers.nn`` (mirrors
``paddle_tpu/layers/nn_extra2.py``: ``conv3d`` :433, ``conv3d_transpose``
:464, ``pool3d`` :500, ``sequence_conv`` :588, ``deformable_conv`` :705,
``deformable_roi_pooling`` :739), ``host_embedding`` :77-116, the
lookup into a host-resident table (:mod:`..host_table`), and the
everyday layers ``gru_unit`` :50, ``nce`` :352, ``hsigmoid`` :384,
``sampled_softmax_with_cross_entropy`` :415 and ``tree_conv`` :677.
Each appends the reference's op type, slots and attrs.  Two go past
the reference, which raises or ignores there: ``hsigmoid`` takes a
custom tree (``path_table`` / ``path_code``), and
``sampled_softmax_with_cross_entropy`` takes customized samples."""

from ..framework import default_main_program
from ..layer_helper import LayerHelper
from .nn import _pair
from .nn_extra import _simple

__all__ = ["conv3d", "conv3d_transpose", "pool3d", "sequence_conv",
           "deformable_conv", "deformable_roi_pooling", "host_embedding",
           "gru_unit", "nce", "hsigmoid",
           "sampled_softmax_with_cross_entropy", "tree_conv"]


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


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid",
             origin_mode=False):
    """One GRU step; ``size`` is 3 D."""
    helper = LayerHelper("gru_unit", **locals())
    d = size // 3
    w = helper.create_parameter(attr=helper.param_attr, shape=[d, 3 * d],
                                dtype=input.dtype, is_bias=False)
    inputs = {"Input": [input], "HiddenPrev": [hidden], "Weight": [w]}
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(
            attr=helper.bias_attr, shape=[1, 3 * d], dtype=input.dtype,
            is_bias=True)]
    gate = helper.create_variable_for_type_inference(input.dtype, True)
    rhp = helper.create_variable_for_type_inference(input.dtype, True)
    hid = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="gru_unit", inputs=inputs,
        outputs={"Gate": [gate], "ResetHiddenPrev": [rhp], "Hidden": [hid]},
        attrs={"activation": activation, "gate_activation": gate_activation,
               "origin_mode": origin_mode})
    return hid, rhp, gate


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=10, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False):
    helper = LayerHelper("nce", **locals())
    dim = input.shape[-1]
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[num_total_classes, dim],
                                dtype=input.dtype, is_bias=False)
    inputs = {"Input": [input], "Label": [label], "Weight": [w]}
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(
            attr=helper.bias_attr, shape=[num_total_classes, 1],
            dtype=input.dtype, is_bias=True)]
    if sample_weight is not None:
        inputs["SampleWeight"] = [sample_weight]
    cost = helper.create_variable_for_type_inference(input.dtype)
    sl = helper.create_variable_for_type_inference(input.dtype, True)
    slab = helper.create_variable_for_type_inference("int64", True)
    helper.append_op(
        type="nce", inputs=inputs,
        outputs={"Cost": [cost], "SampleLogits": [sl],
                 "SampleLabels": [slab]},
        attrs={"num_total_classes": int(num_total_classes),
               "num_neg_samples": int(num_neg_samples),
               "sampler": {"uniform": 0, "log_uniform": 1}.get(sampler, 0),
               "seed": seed})
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None, path_table=None, path_code=None, is_custom=False,
             is_sparse=False):
    """The default tree's W is [num_classes - 1, D]; a custom tree
    (``is_custom``, with ``path_table`` / ``path_code`` [N, L]) has
    ``num_classes`` nodes, as the reference framework's."""
    custom = is_custom or path_table is not None
    if custom and (path_table is None or path_code is None):
        raise ValueError("hsigmoid with a custom tree needs path_table "
                         "and path_code")
    helper = LayerHelper("hierarchical_sigmoid", **locals())
    rows = num_classes if custom else num_classes - 1
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[rows, input.shape[-1]],
                                dtype=input.dtype, is_bias=False)
    inputs = {"X": [input], "W": [w], "Label": [label]}
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(
            attr=helper.bias_attr, shape=[rows, 1], dtype=input.dtype,
            is_bias=True)]
    if custom:
        inputs["PathTable"] = [path_table]
        inputs["PathCode"] = [path_code]
    out = helper.create_variable_for_type_inference(input.dtype)
    pre = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op(type="hierarchical_sigmoid", inputs=inputs,
                     outputs={"Out": [out], "PreOut": [pre]},
                     attrs={"num_classes": int(num_classes)})
    return out


def sampled_softmax_with_cross_entropy(logits, label, num_samples,
                                       num_true=1,
                                       remove_accidental_hits=True,
                                       use_customized_samples=False,
                                       customized_samples=None,
                                       customized_probabilities=None,
                                       seed=0):
    """The loss [N, 1]; with ``use_customized_samples`` each row's
    samples (its label first) and their probabilities replace the
    log-uniform draw."""
    inputs = {"Logits": logits, "Label": label}
    attrs = {"num_samples": int(num_samples), "seed": seed}
    if not remove_accidental_hits:
        attrs["remove_accidental_hits"] = False
    if use_customized_samples:
        inputs["CustomizedSamples"] = customized_samples
        inputs["CustomizedProbabilities"] = customized_probabilities
        attrs["use_customized_samples"] = True
    _, loss = _simple("sampled_softmax_with_cross_entropy", inputs, attrs,
                      outs=("Softmax", "Loss"))
    return loss


def tree_conv(nodes_vector, edge_set, output_size, num_filters=1,
              max_depth=2, act="tanh", param_attr=None, bias_attr=None,
              name=None):
    helper = LayerHelper("tree_conv", **locals())
    dtype = helper.input_dtype("nodes_vector")
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[nodes_vector.shape[-1], output_size, 3], dtype=dtype,
        is_bias=False)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="tree_conv",
        inputs={"NodesVector": [nodes_vector], "EdgeSet": [edge_set],
                "Filter": [w]},
        outputs={"Out": [out]}, attrs={"max_depth": int(max_depth)})
    return out
