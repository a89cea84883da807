"""Neural-network layers used by the BERT encoder and its eval head
(mirrors ``paddle_tpu/layers/nn.py``: ``fc`` :87, ``embedding`` :124,
``layer_norm`` :342, ``dropout`` :408, ``softmax`` :427,
``cross_entropy`` :447, ``softmax_with_cross_entropy`` :459,
``log_softmax`` :437, ``reduce_sum`` / ``reduce_mean`` / ``reduce_max``
:574-582, ``matmul`` :594, ``split`` :703, ``expand`` :785,
``elementwise_add/sub/mul/div`` :637-650, ``elementwise_max/min/pow`` :653-661, ``reshape`` :665,
``transpose`` :678, ``squeeze``/``unsqueeze`` :724-748, ``slice`` :795,
``gather`` :806, ``clip`` / ``clip_by_norm`` :901-918, ``where`` :1050,
``one_hot`` :838, ``fused_dropout_add_ln`` :1084,
``fused_multihead_attention`` :1113; for ResNet ``conv2d`` :169,
``pool2d`` :260, ``batch_norm`` :284, ``mean`` :549, ``topk`` :848,
``relu`` :936, ``pad`` :973, and ``space_to_depth`` from
``layers/nn_extra.py:260``; for the vision models ``conv2d_transpose``
:226, ``group_norm`` :374, ``image_resize`` :995, ``resize_bilinear``
:1036 and ``resize_nearest`` :1043; the everyday tensor layers
``sigmoid_cross_entropy_with_logits`` :480, ``reduce_min`` /
``reduce_prod`` :586-590, ``mul`` :610, ``flatten`` :750, ``stack``
:763, ``unstack`` :773, ``argmax`` / ``argmin`` / ``argsort``
:860-887); the everyday layers of this slice ``depthwise_conv2d``
:218, ``smooth_l1`` :504, ``huber_loss`` :522, ``label_smooth`` :535,
``gather_nd`` :816, ``scatter`` :826, ``shape`` :892, ``l2_normalize``
:921, ``prelu`` :943, ``pad2d`` :983, ``lod_reset`` :1065 (``leaky_relu``
:963 is ``layers/ops.py``'s).
Each layer appends the same op types, slots and attrs as the reference,
so the two packages build the same program."""

import numpy as np

from ..framework import Variable
from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["fc", "embedding", "layer_norm", "dropout", "softmax",
           "square_error_cost",
           "log_softmax", "cross_entropy", "softmax_with_cross_entropy",
           "reduce_sum", "reduce_mean", "reduce_max", "reduce_all",
           "reduce_any", "matmul", "split", "expand",
           "elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_div", "elementwise_max", "elementwise_min",
           "elementwise_pow", "reshape", "transpose", "squeeze", "unsqueeze",
           "slice", "gather", "clip", "clip_by_norm", "where", "one_hot", "fused_dropout_add_ln",
           "fused_multihead_attention", "conv2d", "pool2d", "batch_norm",
           "mean", "topk", "relu", "pad", "space_to_depth",
           "conv2d_transpose", "group_norm", "image_resize",
           "resize_bilinear", "resize_nearest",
           "sigmoid_cross_entropy_with_logits", "reduce_min", "reduce_prod",
           "mul", "flatten", "stack", "unstack", "argmax", "argmin",
           "argsort", "depthwise_conv2d", "smooth_l1", "huber_loss",
           "label_smooth", "gather_nd", "scatter", "shape", "l2_normalize",
           "prelu", "pad2d", "lod_reset"]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """mul per input (+ sum) + bias + activation."""
    helper = LayerHelper("fc", **locals())
    dtype = helper.input_dtype()
    mul_results = []
    for input_var, p_attr in helper.iter_inputs_and_params():
        param_shape = [int(np.prod([abs(d) for d in
                                    input_var.shape[num_flatten_dims:]]))
                       ] + [size]
        w = helper.create_parameter(attr=p_attr, shape=param_shape,
                                    dtype=dtype, is_bias=False)
        tmp = helper.create_variable_for_type_inference(dtype)
        helper.append_op(
            type="mul", inputs={"X": [input_var], "Y": [w]},
            outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """Embedding lookup → ``lookup_table``; a negative ``padding_idx``
    counts from the end of the table."""
    helper = LayerHelper("embedding", **locals())
    w = helper.create_parameter(attr=helper.param_attr, shape=size,
                                dtype=dtype, is_bias=False)
    tmp = helper.create_variable_for_type_inference(dtype)
    padding_idx = (-1 if padding_idx is None
                   else padding_idx if padding_idx >= 0
                   else size[0] + padding_idx)
    helper.append_op(
        type="lookup_table", inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [tmp]},
        attrs={"is_sparse": is_sparse, "is_distributed": is_distributed,
               "padding_idx": padding_idx})
    return tmp


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", **locals())
    dtype = input.dtype
    param_shape = [int(np.prod([abs(d) for d in
                                input.shape[begin_norm_axis:]]))]
    inputs = {"X": [input]}
    if scale:
        inputs["Scale"] = [helper.create_parameter(
            attr=helper.param_attr, shape=param_shape, dtype="float32",
            default_initializer=ConstantInitializer(1.0))]
    if shift:
        inputs["Bias"] = [helper.create_parameter(
            attr=helper.bias_attr, shape=param_shape, dtype="float32",
            is_bias=True)]
    out = helper.create_variable_for_type_inference(dtype)
    mean = helper.create_variable_for_type_inference("float32", True)
    var = helper.create_variable_for_type_inference("float32", True)
    helper.append_op(
        type="layer_norm", inputs=inputs,
        outputs={"Y": [out], "Mean": [mean], "Variance": [var]},
        attrs={"begin_norm_axis": begin_norm_axis, "epsilon": epsilon})
    return helper.append_activation(out)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference("uint8", True)
    helper.append_op(
        type="dropout", inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "seed": seed if seed is not None else 0,
               "dropout_implementation": dropout_implementation})
    return out


def softmax(input, use_cudnn=False, name=None, axis=-1):
    helper = LayerHelper("softmax", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="softmax", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="matmul", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y,
               "alpha": float(alpha)})
    return out


def log_softmax(input, axis=-1, name=None):
    helper = LayerHelper("log_softmax", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="log_softmax", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="cross_entropy", inputs={"X": [input], "Label": [label]},
        outputs={"Y": [out]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    helper = LayerHelper("softmax_with_cross_entropy", **locals())
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Softmax": [softmax_out], "Loss": [loss]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index,
               "axis": axis})
    if return_softmax:
        return loss, softmax_out
    return loss


def _reduce(op_type, input, dim, keep_dim, name):
    helper = LayerHelper(op_type, input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if dim is not None and not isinstance(dim, (list, tuple)):
        dim = [dim]
    helper.append_op(
        type=op_type, inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"dim": dim if dim is not None else [0], "keep_dim": keep_dim,
               "reduce_all": dim is None})
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_prod", input, dim, keep_dim, name)


def _reduce_logical(op_type, input, dim, keep_dim):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference("bool", True)
    helper.append_op(
        type=op_type, inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"dim": dim if dim is not None else [], "keep_dim": keep_dim,
               "reduce_all": dim is None})
    return out


def reduce_all(input, dim=None, keep_dim=False, name=None):
    """Logical AND over ``dim`` (every axis when None), a bool var (the
    reference's ``layers/nn_extra.py:521``)."""
    return _reduce_logical("reduce_all", input, dim, keep_dim)


def reduce_any(input, dim=None, keep_dim=False, name=None):
    return _reduce_logical("reduce_any", input, dim, keep_dim)


def _elementwise(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_max", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_min", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_pow", x, y, axis, act, name)


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes),
                            "starts": [int(s) for s in starts],
                            "ends": [int(e) for e in ends]})
    return out


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="clip", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"min": float(min), "max": float(max)})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="clip_by_norm", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"max_norm": float(max_norm)})
    return out


def where(condition, x=None, y=None):
    helper = LayerHelper("where", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="where",
                     inputs={"Condition": [condition], "X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape2", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op(type="reshape2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"shape": [int(s) for s in shape]})
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op(type="transpose2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": list(perm)})
    return out


def _shape_op(op_type, input, axes):
    helper = LayerHelper(op_type, input=input)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op(type=op_type, inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axes": list(axes)})
    return out


def squeeze(input, axes, name=None):
    return _shape_op("squeeze2", input, axes)


def unsqueeze(input, axes, name=None):
    return _shape_op("unsqueeze2", input, axes)


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", **locals())
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        num = num_or_sections
        attrs = {"num": num, "axis": dim, "sections": []}
    else:
        num = len(num_or_sections)
        attrs = {"num": 0, "axis": dim,
                 "sections": [int(s) for s in num_or_sections]}
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(num)]
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs}, attrs=attrs)
    return outs


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="expand", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"expand_times": [int(t) for t in expand_times]})
    return out


def gather(input, index, overwrite=True):
    helper = LayerHelper("gather", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="gather", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def one_hot(input, depth, allow_out_of_range=False):
    helper = LayerHelper("one_hot", **locals())
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="one_hot", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"depth": depth})
    return out


def fused_dropout_add_ln(x, residual, dropout_prob=0.0, epsilon=1e-5,
                         param_attr=None, bias_attr=None, name=None):
    """``layer_norm(residual + dropout(x))`` over the last axis as one op
    (the fused LN kernel on the GPU); its [D] scale/bias parameters match
    ``layer_norm(begin_norm_axis=ndim-1)``'s."""
    helper = LayerHelper("fused_dropout_add_ln", **locals())
    d = x.shape[-1]
    scale = helper.create_parameter(
        attr=helper.param_attr, shape=[d], dtype="float32",
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(attr=helper.bias_attr, shape=[d],
                                   dtype="float32", is_bias=True)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="fused_dropout_add_ln",
        inputs={"X": [x], "Residual": [residual], "Scale": [scale],
                "Bias": [bias]},
        outputs={"Out": [out]},
        attrs={"dropout_prob": float(dropout_prob),
               "epsilon": float(epsilon)})
    return out


def fused_multihead_attention(q, k, v, bias=None, causal=False, scale=None,
                              dropout_rate=0.0, name=None):
    """Multi-head attention over [B, H, T, Dh] tensors as one op (the
    flash-attention kernel on the GPU); ``bias`` is an additive key bias
    [B, Tk] or [B,1,1,Tk]."""
    helper = LayerHelper("fused_multihead_attention", **locals())
    out = helper.create_variable_for_type_inference(q.dtype)
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if bias is not None:
        inputs["BiasQK"] = [bias]
    attrs = {"causal": bool(causal)}
    if dropout_rate:
        attrs["dropout_rate"] = float(dropout_rate)
    if scale is not None:
        attrs["scale"] = float(scale)
    helper.append_op(type="fused_multihead_attention", inputs=inputs,
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    return [int(v)] * n


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    """``conv2d`` (``depthwise_conv2d`` when every channel is its own
    group); the filter is OIHW in either layout, initialised from
    Normal(0, sqrt(2 / fan_in)); the bias is per output channel."""
    helper = LayerHelper("conv2d", **locals())
    dtype = input.dtype
    groups = groups or 1
    num_channels = input.shape[1] if data_format == "NCHW" \
        else input.shape[-1]
    filter_size = _pair(filter_size)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    fan_in = (num_channels // groups) * filter_size[0] * filter_size[1]
    w = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=NormalInitializer(0.0, (2.0 / fan_in) ** 0.5))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    op_type = ("depthwise_conv2d"
               if groups == num_channels and num_filters % num_channels == 0
               else "conv2d")
    helper.append_op(
        type=op_type, inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": _pair(stride), "paddings": _pair(padding),
               "dilations": _pair(dilation), "groups": groups,
               "data_format": data_format})
    if data_format == "NCHW":
        pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    else:
        nd = len(input.shape)
        pre_act = helper.append_bias_op(pre_bias, dim_start=nd - 1,
                                        dim_end=nd)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True, data_format="NCHW"):
    helper = LayerHelper("pool2d", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": _pair(pool_size),
               "strides": _pair(pool_stride),
               "paddings": _pair(pool_padding),
               "global_pooling": global_pooling, "ceil_mode": ceil_mode,
               "exclusive": exclusive, "data_format": data_format})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=False,
               use_global_stats=False):
    """Scale and Bias parameters, and the persistable, untrained moving
    Mean and Variance, which the op's MeanOut and VarianceOut write
    back."""
    helper = LayerHelper("batch_norm", **locals())
    dtype = input.dtype
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(
        attr=helper.param_attr, shape=[c], dtype="float32",
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(attr=helper.bias_attr, shape=[c],
                                   dtype="float32", is_bias=True)
    mean = helper.create_parameter(
        attr=ParamAttr(name=moving_mean_name, trainable=False), shape=[c],
        dtype="float32", default_initializer=ConstantInitializer(0.0))
    variance = helper.create_parameter(
        attr=ParamAttr(name=moving_variance_name, trainable=False),
        shape=[c], dtype="float32",
        default_initializer=ConstantInitializer(1.0))
    mean.stop_gradient = True
    variance.stop_gradient = True
    out = helper.create_variable_for_type_inference(dtype)
    saved_mean = helper.create_variable_for_type_inference("float32", True)
    saved_var = helper.create_variable_for_type_inference("float32", True)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "is_test": is_test, "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(out)


def mean(x, name=None):
    helper = LayerHelper("mean", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", **locals())
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": int(k)})
    return values, indices


def relu(x, name=None):
    helper = LayerHelper("relu", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="relu", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="pad", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"paddings": list(paddings),
                            "pad_value": float(pad_value)})
    return out


def space_to_depth(x, blocksize, name=None):
    helper = LayerHelper("space_to_depth")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="space_to_depth", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"blocksize": int(blocksize)})
    return out


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    """NCHW transposed convolution; the filter is [C_in, C_out / groups,
    kh, kw], the bias per output channel."""
    helper = LayerHelper("conv2d_transpose", **locals())
    dtype = input.dtype
    groups = groups or 1
    if filter_size is None:
        raise ValueError("filter_size required (output_size inference TBD)")
    filter_shape = [input.shape[1], num_filters // groups] \
        + _pair(filter_size)
    w = helper.create_parameter(attr=helper.param_attr, shape=filter_shape,
                                dtype=dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv2d_transpose", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": _pair(stride), "paddings": _pair(padding),
               "dilations": _pair(dilation), "groups": groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    """Group normalization over the channels of an NCHW tensor; Scale
    (ones) and Bias unless their attr is False."""
    if data_layout != "NCHW":
        raise ValueError("group_norm supports data_layout='NCHW' only, "
                         "got %r" % (data_layout,))
    helper = LayerHelper("group_norm", **locals())
    c = int(input.shape[1])
    inputs = {"X": [input]}
    if param_attr is not False:
        inputs["Scale"] = [helper.create_parameter(
            attr=helper.param_attr, shape=[c], dtype="float32",
            default_initializer=ConstantInitializer(1.0))]
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(
            attr=helper.bias_attr, shape=[c], dtype="float32",
            is_bias=True)]
    out = helper.create_variable_for_type_inference(input.dtype)
    mean = helper.create_variable_for_type_inference("float32", True)
    var = helper.create_variable_for_type_inference("float32", True)
    helper.append_op(
        type="group_norm", inputs=inputs,
        outputs={"Y": [out], "Mean": [mean], "Variance": [var]},
        attrs={"groups": int(groups), "epsilon": float(epsilon)})
    return helper.append_activation(out)


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR", actual_shape=None, align_corners=True,
                 align_mode=1):
    """Resize NCHW images to a static ``out_shape`` (or ``scale`` times
    the input's), as the reference's: a tensor-valued size is refused."""
    resample = str(resample).upper()
    if resample not in ("BILINEAR", "NEAREST"):
        raise ValueError(
            "image_resize resample must be 'BILINEAR' or 'NEAREST', got %r"
            % (resample,))
    if actual_shape is not None or isinstance(out_shape, Variable):
        raise ValueError(
            "image_resize needs a static out_shape (list/tuple of ints); "
            "a tensor-valued out_shape/actual_shape would make the "
            "output shape dynamic")
    h, w = int(input.shape[2]), int(input.shape[3])
    if out_shape is not None:
        if len(out_shape) != 2:
            raise ValueError("out_shape must be [out_h, out_w]")
        oh, ow = int(out_shape[0]), int(out_shape[1])
    elif scale is not None:
        oh, ow = int(h * float(scale)), int(w * float(scale))
    else:
        raise ValueError("one of out_shape and scale must be set")
    helper = LayerHelper("image_resize", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="bilinear_interp" if resample == "BILINEAR"
        else "nearest_interp",
        inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"out_h": oh, "out_w": ow,
               "align_corners": bool(align_corners),
               "align_mode": int(align_mode)})
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None,
                    actual_shape=None, align_corners=True, align_mode=1):
    return image_resize(input, out_shape, scale, name, "BILINEAR",
                        actual_shape, align_corners, align_mode)


def resize_nearest(input, out_shape=None, scale=None, name=None,
                   actual_shape=None, align_corners=True):
    return image_resize(input, out_shape, scale, name, "NEAREST",
                        actual_shape, align_corners)


def square_error_cost(input, label):
    """reference nn.py square_error_cost → square_error_cost op."""
    helper = LayerHelper("square_error_cost", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="square_error_cost",
        inputs={"X": [input], "Y": [label]},
        outputs={"Out": [out]},
    )
    return out


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None,
                                      normalize=False):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="sigmoid_cross_entropy_with_logits",
        inputs={"X": [x], "Label": [label]}, outputs={"Out": [out]},
        attrs={"ignore_index": ignore_index, "normalize": normalize})
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="mul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten2", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op(type="flatten2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": axis})
    return out


def stack(x, axis=0):
    helper = LayerHelper("stack", **locals())
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op(type="stack", inputs={"X": list(x)},
                     outputs={"Y": [out]}, attrs={"axis": axis})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack", **locals())
    if num is None:
        num = x.shape[axis]
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in range(num)]
    helper.append_op(type="unstack", inputs={"X": [x]}, outputs={"Y": outs},
                     attrs={"axis": axis, "num": num})
    return outs


def _arg(op_type, x, axis):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type=op_type, inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def argmax(x, axis=0):
    return _arg("arg_max", x, axis)


def argmin(x, axis=0):
    return _arg("arg_min", x, axis)


def argsort(input, axis=-1, name=None):
    helper = LayerHelper("argsort", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    ids = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="argsort", inputs={"X": [input]},
                     outputs={"Out": [out], "Indices": [ids]},
                     attrs={"axis": axis})
    return out, ids


def depthwise_conv2d(input, num_filters, filter_size, **kwargs):
    groups = (input.shape[1] if kwargs.get("data_format", "NCHW") == "NCHW"
              else input.shape[-1])
    return conv2d(input, num_filters, filter_size, groups=groups, **kwargs)


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1_loss", **locals())
    diff = helper.create_variable_for_type_inference(x.dtype, True)
    loss = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    helper.append_op(type="smooth_l1_loss", inputs=inputs,
                     outputs={"Diff": [diff], "Out": [loss]},
                     attrs={"sigma": sigma if sigma is not None else 1.0})
    return loss


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss", **locals())
    residual = helper.create_variable_for_type_inference(input.dtype, True)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="huber_loss", inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out], "Residual": [residual]},
                     attrs={"delta": delta})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    helper = LayerHelper("label_smooth", **locals())
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [label]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist]
    helper.append_op(type="label_smooth", inputs=inputs,
                     outputs={"Out": [out]},
                     attrs={"epsilon": float(epsilon)})
    return out


def gather_nd(input, index, name=None):
    helper = LayerHelper("gather_nd", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="gather_nd",
                     inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def scatter(input, index, updates, name=None, overwrite=True):
    helper = LayerHelper("scatter", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="scatter",
        inputs={"X": [input], "Ids": [index], "Updates": [updates]},
        outputs={"Out": [out]}, attrs={"overwrite": overwrite})
    return out


def shape(input):
    helper = LayerHelper("shape", **locals())
    out = helper.create_variable_for_type_inference("int32", True)
    helper.append_op(type="shape", inputs={"Input": [input]},
                     outputs={"Out": [out]})
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    """``x / sqrt(sum(x^2, axis) + epsilon)``, composed of the
    reference's ops in its order."""
    from . import ops as _ops
    from .tensor import fill_constant

    s = reduce_sum(elementwise_mul(x, x), dim=axis, keep_dim=True)
    norm = _ops.sqrt(elementwise_add(s, fill_constant([1], s.dtype,
                                                      epsilon)))
    return elementwise_div(x, norm)


def prelu(x, mode, param_attr=None, name=None):
    helper = LayerHelper("prelu", **locals())
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [x.shape[1]]
    else:
        alpha_shape = list(x.shape[1:])
    alpha = helper.create_parameter(
        attr=helper.param_attr, shape=alpha_shape, dtype="float32",
        is_bias=False, default_initializer=ConstantInitializer(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="prelu", inputs={"X": [x], "Alpha": [alpha]},
                     outputs={"Out": [out]}, attrs={"mode": mode})
    return out


def pad2d(input, paddings=[0, 0, 0, 0], mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    helper = LayerHelper("pad2d", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="pad2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"paddings": list(paddings), "mode": mode,
               "pad_value": float(pad_value), "data_format": data_format})
    return out


def lod_reset(x, y=None, target_lod=None):
    helper = LayerHelper("lod_reset", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x]}
    if y is not None:
        inputs["Y"] = [y]
    helper.append_op(type="lod_reset", inputs=inputs, outputs={"Out": [out]},
                     attrs={"target_lod": target_lod or []})
    return out
