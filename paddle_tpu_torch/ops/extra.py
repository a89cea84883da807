"""The standalone ``fc`` op (mirrors ``paddle_tpu/ops/extra.py:477``),
emitted by the inference ``fc_fuse_pass``."""

import math as _math

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
