"""Neural-network layers used by the BERT encoder and its eval head
(mirrors ``paddle_tpu/layers/nn.py``: ``fc`` :87, ``embedding`` :124,
``layer_norm`` :342, ``dropout`` :408, ``softmax`` :427,
``softmax_with_cross_entropy`` :459, ``reduce_sum`` :574, ``matmul``
:594, ``elementwise_add/sub/mul/div`` :637-650, ``reshape`` :665,
``transpose`` :678, ``squeeze``/``unsqueeze`` :724-748, ``gather`` :806,
``one_hot`` :838, ``fused_dropout_add_ln`` :1084,
``fused_multihead_attention`` :1113; for ResNet ``conv2d`` :169,
``pool2d`` :260, ``batch_norm`` :284, ``mean`` :549, ``topk`` :848,
``relu`` :936, ``pad`` :973, and ``space_to_depth`` from
``layers/nn_extra.py:260``).
Each layer appends the same op types, slots and attrs as the reference,
so the two packages build the same program."""

import numpy as np

from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["fc", "embedding", "layer_norm", "dropout", "softmax",
           "softmax_with_cross_entropy", "reduce_sum", "matmul",
           "elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_div", "reshape", "transpose", "squeeze", "unsqueeze",
           "gather", "one_hot", "fused_dropout_add_ln",
           "fused_multihead_attention", "conv2d", "pool2d", "batch_norm",
           "mean", "topk", "relu", "pad", "space_to_depth"]


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


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper("reduce_sum", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    if dim is not None and not isinstance(dim, (list, tuple)):
        dim = [dim]
    helper.append_op(
        type="reduce_sum", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"dim": dim if dim is not None else [0], "keep_dim": keep_dim,
               "reduce_all": dim is None})
    return out


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
