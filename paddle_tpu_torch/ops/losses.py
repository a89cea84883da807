"""Loss-family ops (mirrors ``paddle_tpu/ops/losses.py``; so far
``bilinear_tensor_product`` :119, which the dygraph
``BilinearTensorProduct`` dispatches; the rest is ROADMAP.md Queue A
item 9)."""

import torch

from .registry import register_op


@register_op("bilinear_tensor_product", inputs=["X", "Y", "Weight", "Bias"],
             outputs=["Out"])
def bilinear_tensor_product(ctx, attrs, X, Y, Weight, Bias):
    """``out[b, k] = x[b] W[k] y[b]^T (+ bias)``
    (``bilinear_tensor_product_op.h``); W is [K, dx, dy]."""
    out = torch.einsum("bi,kij,bj->bk", X, Weight, Y)
    if Bias is not None:
        out = out + Bias.reshape(1, -1)
    return out
