"""Sequence ops on padded batches (mirrors ``paddle_tpu/ops/sequence.py``;
so far ``sequence_mask`` :126, which the NMT and stacked-LSTM models
use, and ``sequence_conv`` :174, which the dygraph ``SequenceConv``
dispatches; the rest is ROADMAP.md Queue A item 9).  A sequence batch is
a padded [B, T, D] tensor with an optional ``SeqLen`` [B], the
reference's stand-in for LoD offsets."""

import torch
import torch.nn.functional as F

from .common import resolve_dtype
from .registry import register_op


@register_op("sequence_mask", inputs=["X"], outputs=["Y"], no_grad=True)
def sequence_mask(ctx, attrs, X):
    """``Y[b, t] = t < X[b]`` for ``t < maxlen``, in ``out_dtype``; the
    static ``maxlen`` attr is required, as in the reference."""
    maxlen = int(attrs.get("maxlen", -1))
    if maxlen < 0:
        raise ValueError("sequence_mask needs a static maxlen attr (an "
                         "output shape read from the lengths would be a "
                         "host read)")
    lens = X.reshape(-1)
    mask = torch.arange(maxlen, device=X.device)[None, :] < lens[:, None]
    return mask.to(resolve_dtype(attrs.get("out_dtype", "int64")))


@register_op("sequence_conv", inputs=["X", "Filter", "SeqLen"],
             outputs=["Out"])
def sequence_conv(ctx, attrs, X, Filter, SeqLen):
    """Context-window convolution (``sequence_conv_op.h`` with
    ``math/context_project.h``): each step concatenates ``contextLength``
    rows from ``contextStart`` on and multiplies the [ctx * D, M] filter;
    rows past a sequence's length, and outside it, contribute zeros."""
    ctx_len = int(attrs.get("contextLength", 3))
    ctx_start = int(attrs.get("contextStart", -1))
    t = X.shape[1]
    x = X
    if SeqLen is not None:
        keep = torch.arange(t, device=X.device)[None, :] \
            < SeqLen.reshape(-1, 1).long()
        x = torch.where(keep[:, :, None], X, torch.zeros_like(X))
    cols = []
    for i in range(ctx_len):
        off = ctx_start + i
        if off < 0:
            cols.append(F.pad(x[:, :t + off], (0, 0, -off, 0)))
        elif off > 0:
            cols.append(F.pad(x[:, off:], (0, 0, 0, off)))
        else:
            cols.append(x)
    return torch.cat(cols, dim=2) @ Filter
