"""The standalone ``fc`` op (mirrors ``paddle_tpu/ops/extra.py:477``),
emitted by the inference ``fc_fuse_pass``, ``diag`` (:67), the
control-flow layers' ``is_empty`` (:72) and ``print`` (:327), ``max_sequence_len`` (:566),
and the image resizes ``bilinear_interp`` / ``nearest_interp``
(``_interp`` :260, :313-325)."""

import math as _math

import torch

from .math import _matmul
from .registry import register_op


@register_op("fc", inputs=["Input", "W", "Bias"], outputs=["Out"])
def fc_op(ctx, attrs, Input, W, Bias):
    in_num_col_dims = int(attrs.get("in_num_col_dims", 1))
    shape = tuple(Input.shape)
    x = Input.reshape(_math.prod(shape[:in_num_col_dims]), -1)
    out = _matmul(x, W)
    if Bias is not None:
        out = out + Bias.reshape(1, -1)
    return out.reshape(shape[:in_num_col_dims] + (W.shape[1],))


@register_op("diag", inputs=["Diagonal"], outputs=["Out"], no_grad=True)
def diag(ctx, attrs, Diagonal):
    """The square matrix with Diagonal (flattened) on its diagonal."""
    return torch.diag(Diagonal.reshape(-1))


@register_op("is_empty", inputs=["X"], outputs=["Out"], no_grad=True)
def is_empty(ctx, attrs, X):
    """``[X.numel() == 0]``: a shape fact, filled on the device."""
    return torch.full((1,), X.numel() == 0, dtype=torch.bool,
                      device=X.device)


@register_op("print", inputs=["In"], outputs=["Out"], capturable=False)
def print_op(ctx, attrs, In):
    """Print ``message`` and the tensor's values on the host (the
    reference's ``jax.debug.print``); the output is a copy of ``In``.
    Reading the values waits for the device, so the op is not
    capturable and shape inference prints nothing."""
    if In.device.type != "meta":
        print(attrs.get("message", "") + str(In.detach().cpu().numpy()),
              flush=True)
    return In.clone()


@register_op("max_sequence_len", inputs=["RankTable"], outputs=["Out"],
             no_grad=True)
def max_sequence_len(ctx, attrs, RankTable):
    """The longest length of a rank table, or of a lengths tensor (the
    padded form's rank table), [1] int64."""
    lengths = getattr(RankTable, "lengths", RankTable)
    return lengths.max().reshape(1).to(torch.int64)


def _interp(attrs, X, method):
    """The reference's semantics (interpolate_op.h): the ratio is
    (in-1)/(out-1) with ``align_corners``, else in/out; bilinear with
    ``align_mode`` 0 and no corner alignment samples at half-pixel
    sources (clamped at 0), else at ``ratio * k``; nearest rounds with
    ``align_corners`` and truncates without."""
    shape = attrs.get("out_shape") or [int(attrs.get("out_h")),
                                       int(attrs.get("out_w"))]
    oh, ow = int(shape[0]), int(shape[1])
    align = bool(attrs.get("align_corners", True))
    amode = int(attrs.get("align_mode", 1))
    h, w = X.shape[2], X.shape[3]
    dev = X.device

    def ratio(in_len, out_len):
        if out_len <= 1:
            return 0.0
        return ((in_len - 1) / (out_len - 1)) if align else in_len / out_len

    if method == "nearest":
        def near_idx(in_len, out_len):
            j = torch.arange(out_len, dtype=torch.float32, device=dev) \
                * ratio(in_len, out_len)
            j = j + 0.5 if align else j
            return torch.clamp(j.to(torch.int32), 0, in_len - 1).long()

        return X[:, :, near_idx(h, oh)][:, :, :, near_idx(w, ow)]

    half_pixel = amode == 0 and not align

    def src(in_len, out_len):
        j = torch.arange(out_len, dtype=torch.float32, device=dev)
        r = ratio(in_len, out_len)
        if half_pixel:
            return torch.clamp(r * (j + 0.5) - 0.5, min=0.0)
        return r * j

    fy, fx = src(h, oh), src(w, ow)
    y0 = torch.clamp(torch.floor(fy).to(torch.int32), 0, h - 1)
    x0 = torch.clamp(torch.floor(fx).to(torch.int32), 0, w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    dy = (fy - y0)[None, None, :, None]
    dx = (fx - x0)[None, None, None, :]

    def g(yy, xx):
        return X[:, :, yy.long()][:, :, :, xx.long()]

    top = g(y0, x0) * (1 - dx) + g(y0, x1) * dx
    bot = g(y1, x0) * (1 - dx) + g(y1, x1) * dx
    return top * (1 - dy) + bot * dy


@register_op("bilinear_interp", inputs=["X", "OutSize"], outputs=["Out"])
def bilinear_interp(ctx, attrs, X, OutSize):
    """interpolate_op.cc's bilinear registration (the size is the attrs';
    ``OutSize`` is not read, as in the reference)."""
    return _interp(attrs, X, "bilinear")


@register_op("nearest_interp", inputs=["X", "OutSize"], outputs=["Out"])
def nearest_interp(ctx, attrs, X, OutSize):
    """interpolate_op.cc's nearest registration."""
    return _interp(attrs, X, "nearest")
