"""Vision layers of the second wave of ``layers.nn`` (mirrors
``paddle_tpu/layers/nn_extra.py``: ``maxout`` :60, ``crop`` :72,
``pad_constant_like`` :88, ``random_crop`` :94, ``lrn`` :239,
``pixel_shuffle`` :249, ``shuffle_channel`` :255, ``temporal_shift``
:265, ``affine_channel`` :272, ``fsp_matrix`` :279, ``grid_sampler``
:284, ``affine_grid`` :296, ``roi_pool`` :311, ``psroi_pool`` :324,
``unfold`` :335, ``sum`` :478, ``image_resize_short`` :484).  Each appends the
reference's op type, slots and attrs; the ops are ``ops/vision.py``'s."""

from ..framework import Variable
from ..layer_helper import LayerHelper
from .nn import _pair, image_resize

__all__ = [
    "maxout", "crop", "pad_constant_like", "random_crop", "lrn",
    "pixel_shuffle", "shuffle_channel", "temporal_shift", "affine_channel",
    "fsp_matrix", "grid_sampler", "affine_grid", "roi_pool", "psroi_pool",
    "unfold", "image_resize_short", "elementwise_mod",
    "elementwise_floordiv", "sum",
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
