"""Vision layers of the second wave of ``layers.nn`` (mirrors
``paddle_tpu/layers/nn_extra.py``: ``maxout`` :60, ``crop`` :72,
``pad_constant_like`` :88, ``random_crop`` :94, ``lrn`` :239,
``pixel_shuffle`` :249, ``shuffle_channel`` :255, ``temporal_shift``
:265, ``affine_channel`` :272, ``fsp_matrix`` :279, ``grid_sampler``
:284, ``affine_grid`` :296, ``roi_pool`` :311, ``psroi_pool`` :324,
``unfold`` :335, ``sum`` :478, ``image_resize_short`` :484), and its
everyday layers: ``selu`` :55, ``multiplex`` :65, ``sampling_id`` :102,
``uniform_random_batch_size_like`` :108,
``gaussian_random_batch_size_like`` :120, ``gaussian_random`` :132,
``add_position_encoding`` :143, ``hash`` :149, ``data_norm`` :157,
``spectral_norm`` :193, ``row_conv`` :222, the losses :352-394 and
``bilinear_tensor_product`` :403, the compositions ``dice_loss`` :426,
``npair_loss`` :447 and ``rank`` :471, ``im2sequence`` :547.  Each
appends the reference's op type, slots and attrs; the ops are
``ops/vision.py``'s, ``ops/nn.py``'s and ``ops/losses.py``'s."""

from ..framework import Variable
from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from .nn import _pair, image_resize

__all__ = [
    "maxout", "crop", "pad_constant_like", "random_crop", "lrn",
    "pixel_shuffle", "shuffle_channel", "temporal_shift", "affine_channel",
    "fsp_matrix", "grid_sampler", "affine_grid", "roi_pool", "psroi_pool",
    "unfold", "image_resize_short", "elementwise_mod",
    "elementwise_floordiv", "sum",
    "selu", "multiplex", "sampling_id", "uniform_random_batch_size_like",
    "gaussian_random_batch_size_like", "gaussian_random",
    "add_position_encoding", "hash", "data_norm", "spectral_norm",
    "row_conv", "log_loss", "kldiv_loss", "rank_loss", "margin_rank_loss",
    "bpr_loss", "teacher_student_sigmoid_loss", "mean_iou",
    "bilinear_tensor_product", "dice_loss", "npair_loss", "rank",
    "im2sequence",
]


def _simple(op_type, inputs, attrs=None, out_dtype=None, outs=("Out",),
            stop_gradient=False):
    """One op of ``op_type`` on ``inputs`` (absent ones dropped), one new
    var per output slot in ``outs``, typed like the first input."""
    helper = LayerHelper(op_type)
    dtype = out_dtype
    if dtype is None:
        for v in inputs.values():
            vs = v if isinstance(v, (list, tuple)) else [v]
            if vs and isinstance(vs[0], Variable):
                dtype = vs[0].dtype
                break
    outputs, ret = {}, []
    for slot in outs:
        ov = helper.create_variable_for_type_inference(dtype, stop_gradient)
        outputs[slot] = [ov]
        ret.append(ov)
    helper.append_op(
        type=op_type,
        inputs={k: (list(v) if isinstance(v, (list, tuple)) else [v])
                for k, v in inputs.items() if v is not None},
        outputs=outputs, attrs=attrs or {})
    return ret[0] if len(ret) == 1 else tuple(ret)


def maxout(x, groups, name=None):
    return _simple("maxout", {"X": x}, {"groups": groups})


def crop(x, shape=None, offsets=None, name=None):
    """A static ``shape`` or a template variable ``Y``; static offsets or
    an ``Offsets`` variable."""
    attrs = {}
    ins = {"X": x}
    if isinstance(shape, Variable):
        ins["Y"] = shape
    else:
        attrs["shape"] = [int(s) for s in shape]
    if isinstance(offsets, Variable):
        ins["Offsets"] = offsets
    elif offsets is not None:
        attrs["offsets"] = [int(o) for o in offsets]
    return _simple("crop", ins, attrs)


def pad_constant_like(x, y, pad_value=0.0, name=None):
    return _simple("pad_constant_like", {"X": x, "Y": y},
                   {"pad_value": float(pad_value)})


def random_crop(x, shape, seed=None):
    """``seed``, as in the reference, is not passed on: the op draws from
    its own generator (``ops/vision.py``)."""
    out, _ = _simple("random_crop", {"X": x},
                     {"shape": [int(s) for s in shape]},
                     outs=("Out", "SeedOut"))
    return out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    out, _ = _simple("lrn", {"X": input},
                     {"n": n, "k": k, "alpha": alpha, "beta": beta},
                     outs=("Out", "MidOut"))
    return out


def pixel_shuffle(x, upscale_factor):
    return _simple("pixel_shuffle", {"X": x},
                   {"upscale_factor": int(upscale_factor)})


def shuffle_channel(x, group, name=None):
    return _simple("shuffle_channel", {"X": x}, {"group": int(group)})


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    return _simple("temporal_shift", {"X": x},
                   {"seg_num": int(seg_num),
                    "shift_ratio": float(shift_ratio)})


def affine_channel(x, scale=None, bias=None, data_layout="NCHW", name=None):
    return _simple("affine_channel", {"X": x, "Scale": scale, "Bias": bias},
                   {"data_layout": data_layout})


def fsp_matrix(x, y):
    return _simple("fsp", {"X": x, "Y": y})


def grid_sampler(x, grid, name=None):
    helper = LayerHelper("grid_sampler", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="grid_sampler", inputs={"X": [x], "Grid": [grid]},
                     outputs={"Output": [out]})
    return out


def affine_grid(theta, out_shape, name=None):
    if isinstance(out_shape, Variable):
        raise NotImplementedError(
            "affine_grid needs a static out_shape (a python list): a "
            "variable would make the output shape dynamic")
    helper = LayerHelper("affine_grid", **locals())
    out = helper.create_variable_for_type_inference(theta.dtype)
    helper.append_op(type="affine_grid", inputs={"Theta": [theta]},
                     outputs={"Output": [out]},
                     attrs={"output_shape": [int(s) for s in out_shape]})
    return out


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0, rois_lod=None):
    """``rois`` [R, 5] with the batch index first, or [R, 4] with
    ``rois_lod`` (image 0 without it)."""
    out, _ = _simple(
        "roi_pool", {"X": input, "ROIs": rois, "RoisLod": rois_lod},
        {"pooled_height": int(pooled_height),
         "pooled_width": int(pooled_width),
         "spatial_scale": float(spatial_scale)},
        outs=("Out", "Argmax"))
    return out


def psroi_pool(input, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, name=None):
    return _simple(
        "psroi_pool", {"X": input, "ROIs": rois},
        {"output_channels": int(output_channels),
         "spatial_scale": float(spatial_scale),
         "pooled_height": int(pooled_height),
         "pooled_width": int(pooled_width)})


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    pads = _pair(paddings)
    if len(pads) == 2:
        pads = pads + pads
    return _simple(
        "unfold", {"X": x},
        {"kernel_sizes": _pair(kernel_sizes), "strides": _pair(strides),
         "paddings": pads, "dilations": _pair(dilations)},
        outs=("Y",))


def sum(x):
    """The ``sum`` op over a list of Variables (or one)."""
    return _simple("sum", {"X": list(x) if isinstance(x, (list, tuple))
                           else [x]})


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """Resize so the shorter side is ``out_short_len``, keeping the
    aspect ratio (the input's H and W must be static)."""
    h, w = input.shape[2], input.shape[3]
    scale = float(out_short_len) / float(min(h, w))
    out_shape = [int(round(h * scale)), int(round(w * scale))]
    return image_resize(input, out_shape=out_shape, resample=resample)


def elementwise_mod(x, y, axis=-1, act=None, name=None):
    """reference nn.py elementwise_mod op"""
    return _simple("elementwise_mod", {"X": x, "Y": y}, {"axis": axis})


def elementwise_floordiv(x, y, axis=-1, act=None, name=None):
    """reference nn.py elementwise_floordiv op"""
    return _simple("elementwise_floordiv", {"X": x, "Y": y}, {"axis": axis})


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return _simple("selu", {"X": x}, {"scale": scale, "alpha": alpha})


def multiplex(inputs, index):
    return _simple("multiplex", {"X": list(inputs), "Ids": index})


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="float32"):
    return _simple("sampling_id", {"X": x}, {"seed": seed},
                   out_dtype="int64", stop_gradient=True)


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    return _simple(
        "uniform_random_batch_size_like", {"Input": input},
        {"shape": [int(s) for s in shape], "input_dim_idx": input_dim_idx,
         "output_dim_idx": output_dim_idx, "min": min, "max": max,
         "seed": seed, "dtype": dtype},
        out_dtype=dtype, stop_gradient=True)


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    return _simple(
        "gaussian_random_batch_size_like", {"Input": input},
        {"shape": [int(s) for s in shape], "input_dim_idx": input_dim_idx,
         "output_dim_idx": output_dim_idx, "mean": mean, "std": std,
         "seed": seed, "dtype": dtype},
        out_dtype=dtype, stop_gradient=True)


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    return _simple(
        "gaussian_random", {},
        {"shape": [int(s) for s in shape], "mean": mean, "std": std,
         "seed": seed, "dtype": dtype},
        out_dtype=dtype, stop_gradient=True)


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    return _simple("add_position_encoding", {"X": input},
                   {"alpha": float(alpha), "beta": float(beta)})


def hash(input, hash_size, num_hash=1, name=None):
    """The reference's uint32 mix (not XXH64), bit for bit."""
    return _simple("hash", {"X": input},
                   {"mod_by": int(hash_size), "num_hash": int(num_hash)},
                   out_dtype="int64", stop_gradient=True)


def data_norm(input, act=None, epsilon=1e-05, param_attr=None,
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=False):
    """Per-feature shift and scale from persistable batch statistics
    (size 1e4, sum 0, square sum 1e4 at the start, as the reference's)."""
    helper = LayerHelper("data_norm", **locals())
    dtype = helper.input_dtype()
    c = input.shape[-1]
    stat_attr = ParamAttr._to_attr(param_attr)

    def stat(name_suffix, value):
        attr = ParamAttr(
            name=(stat_attr.name + name_suffix) if stat_attr.name else None,
            initializer=ConstantInitializer(value), trainable=True)
        return helper.create_parameter(attr=attr, shape=[c], dtype=dtype,
                                       is_bias=False)

    batch_size = stat(".batch_size", 1e4)
    batch_sum = stat(".batch_sum", 0.0)
    batch_square_sum = stat(".batch_square_sum", 1e4)
    y = helper.create_variable_for_type_inference(dtype)
    means = helper.create_variable_for_type_inference(dtype, True)
    scales = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op(
        type="data_norm",
        inputs={"X": [input], "BatchSize": [batch_size],
                "BatchSum": [batch_sum],
                "BatchSquareSum": [batch_square_sum]},
        outputs={"Y": [y], "Means": [means], "Scales": [scales]},
        attrs={"epsilon": epsilon, "data_layout": data_layout})
    return helper.append_activation(y)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """The power iteration's U and V are persistable, untrained
    parameters drawn N(0, 1)."""
    helper = LayerHelper("spectral_norm", **locals())
    dtype = weight.dtype
    h = weight.shape[dim]
    w = 1
    for i, s in enumerate(weight.shape):
        if i != dim:
            w *= s

    def vec(n):
        p = helper.create_parameter(
            attr=ParamAttr(initializer=NormalInitializer(0.0, 1.0),
                           trainable=False),
            shape=[n], dtype=dtype, is_bias=False)
        p.stop_gradient = True
        return p

    u, v = vec(h), vec(w)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="spectral_norm",
        inputs={"Weight": [weight], "U": [u], "V": [v]},
        outputs={"Out": [out]},
        attrs={"dim": dim, "power_iters": power_iters, "eps": eps})
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):
    helper = LayerHelper("row_conv", **locals())
    dtype = helper.input_dtype()
    filter_param = helper.create_parameter(
        attr=helper.param_attr,
        shape=[future_context_size + 1, input.shape[-1]], dtype=dtype,
        is_bias=False)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="row_conv",
                     inputs={"X": [input], "Filter": [filter_param]},
                     outputs={"Out": [out]})
    return helper.append_activation(out)


def log_loss(input, label, epsilon=1e-4, name=None):
    return _simple("log_loss", {"Predicted": input, "Labels": label},
                   {"epsilon": float(epsilon)}, outs=("Loss",))


def kldiv_loss(x, target, reduction="mean", name=None):
    return _simple("kldiv_loss", {"X": x, "Target": target},
                   {"reduction": reduction}, outs=("Loss",))


def rank_loss(label, left, right, name=None):
    return _simple("rank_loss",
                   {"Label": label, "Left": left, "Right": right})


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    out, _ = _simple("margin_rank_loss",
                     {"Label": label, "X1": left, "X2": right},
                     {"margin": float(margin)}, outs=("Out", "Activated"))
    return out


def bpr_loss(input, label, name=None):
    return _simple("bpr_loss", {"X": input, "Label": label}, outs=("Y",))


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    return _simple("teacher_student_sigmoid_loss",
                   {"X": input, "Label": label},
                   {"soft_max_up_bound": soft_max_up_bound,
                    "soft_max_lower_bound": soft_max_lower_bound},
                   outs=("Y",))


def mean_iou(input, label, num_classes):
    return _simple("mean_iou", {"Predictions": input, "Labels": label},
                   {"num_classes": int(num_classes)}, out_dtype="float32",
                   outs=("OutMeanIou", "OutWrong", "OutCorrect"),
                   stop_gradient=True)


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    helper = LayerHelper("bilinear_tensor_product", **locals())
    dtype = helper.input_dtype("x")
    w = helper.create_parameter(
        attr=helper.param_attr, shape=[size, x.shape[1], y.shape[1]],
        dtype=dtype, is_bias=False)
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [x], "Y": [y], "Weight": [w]}
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(
            attr=helper.bias_attr, shape=[1, size], dtype=dtype,
            is_bias=True)]
    helper.append_op(type="bilinear_tensor_product", inputs=inputs,
                     outputs={"Out": [out]})
    return helper.append_activation(out)


def dice_loss(input, label, epsilon=1e-5):
    """``1 - 2 |x . y| / (|x| + |y| + eps)`` of the one-hot label,
    averaged over the batch (a composition, as the reference's)."""
    from . import nn as _nn
    from . import ops as _ops

    label = _nn.one_hot(label, depth=input.shape[-1])
    reduce_dims = list(range(1, len(input.shape)))
    inse = _nn.reduce_sum(_nn.elementwise_mul(input, label), dim=reduce_dims)
    dice_denominator = _nn.elementwise_add(
        _nn.reduce_sum(input, dim=reduce_dims),
        _nn.reduce_sum(label, dim=reduce_dims))
    dice_score = _ops.scale(
        _nn.elementwise_div(
            _ops.scale(inse, scale=2.0),
            _ops.scale(dice_denominator, scale=1.0, bias=epsilon)),
        scale=-1.0, bias=1.0)
    return _nn.reduce_mean(dice_score)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """Cross entropy of the anchor-positive similarities by rows and by
    columns against the label matching, plus L2 on the embeddings (a
    composition, as the reference's)."""
    from . import nn as _nn
    from . import ops as _ops

    batch = anchor.shape[0]
    sim = _nn.matmul(anchor, positive, transpose_y=True)
    lab = _nn.one_hot(labels, depth=batch)
    ce_row = _nn.reduce_mean(_nn.softmax_with_cross_entropy(
        sim, lab, soft_label=True))
    ce_col = _nn.reduce_mean(_nn.softmax_with_cross_entropy(
        _nn.transpose(sim, perm=[1, 0]), lab, soft_label=True))
    l2 = _ops.scale(
        _nn.reduce_mean(_nn.elementwise_add(
            _nn.reduce_sum(_ops.square(anchor), dim=[1]),
            _nn.reduce_sum(_ops.square(positive), dim=[1]))),
        scale=float(l2_reg))
    return _nn.elementwise_add(
        _ops.scale(_nn.elementwise_add(ce_row, ce_col), 0.5), l2)


def rank(input):
    """The static rank as a constant int32 tensor."""
    from . import tensor as _tensor

    return _tensor.fill_constant([1], "int32", len(input.shape))


def im2sequence(input, filter_size=1, stride=1, padding=0,
                input_image_size=None, out_stride=1, name=None):
    def pair(v):
        return [int(v), int(v)] if isinstance(v, int) else [int(a) for a in v]

    pads = pair(padding)
    if len(pads) == 2:
        pads = pads + pads
    return _simple("im2sequence", {"X": input},
                   {"kernels": pair(filter_size), "strides": pair(stride),
                    "paddings": pads})
