"""The standalone ``fc`` op (mirrors ``paddle_tpu/ops/extra.py:477``),
emitted by the inference ``fc_fuse_pass``, the control-flow layers'
``is_empty`` (:72) and ``print`` (:327), and ``max_sequence_len``
(:566)."""

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
