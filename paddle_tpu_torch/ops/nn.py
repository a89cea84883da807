"""Neural-network ops of the BERT serving path (mirrors
``paddle_tpu/ops/nn.py``: softmax, dropout, lookup_table/embedding
:138-152, layer_norm :182, fused_multihead_attention :523,
fused_dropout_add_ln :555, fused_embedding_gather :674).

The three ``fused_*`` ops route to the hand-written CUDA kernels under
:mod:`paddle_tpu_torch.ops.cuda`; the unfused ops are plain PyTorch.
Dropout inside the fused kernels comes with the training slice: a fused
op asked for a rate > 0 in train mode raises ``NotImplementedError``.
"""

import torch

from .cuda.embedding import embedding_gather_fwd
from .cuda.flash_attention import flash_attention
from .cuda.fused_ln import fused_dropout_add_ln_fwd
from .registry import register_op


@register_op("softmax", inputs=["X"], outputs=["Out"])
def softmax(ctx, attrs, X):
    axis = int(attrs.get("axis", -1))
    # f32 internals for low-precision inputs, as the reference
    return torch.softmax(X.float(), dim=axis).to(X.dtype)


@register_op("dropout", inputs=["X"], outputs=["Out", "Mask"],
             stateful_outputs=("Mask",))
def dropout(ctx, attrs, X):
    p = float(attrs.get("dropout_prob", 0.5))
    is_test = attrs.get("is_test", False) or ctx.mode == "infer"
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if is_test:
        out = X if impl == "upscale_in_train" else X * (1.0 - p)
        return {"Out": out, "Mask": torch.ones_like(X, dtype=torch.uint8)}
    keep = torch.rand(X.shape, generator=ctx.rng(X.device),
                      device=X.device) >= p
    if impl == "upscale_in_train":
        scale = 1.0 / (1.0 - p) if p < 1.0 else 0.0
        out = torch.where(keep, X * scale, torch.zeros_like(X))
    else:
        out = torch.where(keep, X, torch.zeros_like(X))
    return {"Out": out, "Mask": keep.to(torch.uint8)}


def _flat_ids(Ids):
    if Ids.dim() > 1 and Ids.shape[-1] == 1:
        Ids = Ids[..., 0]
    return Ids


def _lookup(W, Ids, padding_idx):
    ids = _flat_ids(Ids).long()
    v = W.shape[0]
    out = W[ids.clamp(0, v - 1)]
    if out.is_floating_point():
        # jnp.take's fill mode: ids >= V read NaN rows
        out = torch.where((ids >= v)[..., None],
                          torch.full_like(out, float("nan")), out)
    if padding_idx is not None and padding_idx != -1:
        out = torch.where((ids == padding_idx)[..., None],
                          torch.zeros_like(out), out)
    return out


@register_op("lookup_table", inputs=["W", "Ids"], outputs=["Out"])
def lookup_table(ctx, attrs, W, Ids):
    return _lookup(W, Ids, attrs.get("padding_idx", -1))


@register_op("embedding", inputs=["W", "Ids"], outputs=["Out"])
def embedding(ctx, attrs, W, Ids):
    return _lookup(W, Ids, attrs.get("padding_idx", -1))


@register_op("layer_norm", inputs=["X", "Scale", "Bias"],
             outputs=["Y", "Mean", "Variance"],
             stateful_outputs=("Mean", "Variance"))
def layer_norm(ctx, attrs, X, Scale, Bias):
    begin = int(attrs.get("begin_norm_axis", 1))
    eps = attrs.get("epsilon", 1e-5)
    dims = tuple(range(begin, X.dim()))
    x32 = X.float()
    mean = x32.mean(dim=dims, keepdim=True)
    # the two-pass variance, as the reference
    var = torch.square(x32 - mean).mean(dim=dims, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    bshape = (1,) * begin + tuple(X.shape[begin:])
    if Scale is not None:
        y = y * Scale.float().reshape(bshape)
    if Bias is not None:
        y = y + Bias.float().reshape(bshape)
    return {"Y": y.to(X.dtype), "Mean": mean.reshape(-1),
            "Variance": var.reshape(-1)}


def _serving_rate(ctx, attrs, key, op):
    rate = float(attrs.get(key, 0.0) or 0.0)
    if attrs.get("is_test") or ctx.mode == "infer":
        return 0.0
    if rate > 0.0:
        raise NotImplementedError(
            "%s with %s=%g in train mode needs in-kernel dropout, which "
            "comes with the training slice (ROADMAP.md); run the program "
            "cloned with for_test=True, or at rate 0" % (op, key, rate))
    return 0.0


@register_op("fused_multihead_attention", inputs=["Q", "K", "V", "BiasQK"],
             outputs=["Out"])
def fused_multihead_attention(ctx, attrs, Q, K, V, BiasQK=None):
    """Q,K,V [B,H,T,Dh]; BiasQK an additive key bias [B,Tk] or
    [B,1,1,Tk] → the flash-attention kernel."""
    _serving_rate(ctx, attrs, "dropout_rate", "fused_multihead_attention")
    scale = attrs.get("scale", None)
    bias = None
    if BiasQK is not None:
        bias = BiasQK.reshape(BiasQK.shape[0], BiasQK.shape[-1]).float() \
            .contiguous()
    return flash_attention(Q, K, V, bias=bias,
                           causal=bool(attrs.get("causal", False)),
                           sm_scale=None if scale is None else float(scale))


@register_op("fused_dropout_add_ln", inputs=["X", "Residual", "Scale", "Bias"],
             outputs=["Out"])
def fused_dropout_add_ln(ctx, attrs, X, Residual, Scale, Bias):
    """``layer_norm(residual + dropout(x))`` over the last axis → the
    fused LN kernel on ``[N, D]`` rows."""
    _serving_rate(ctx, attrs, "dropout_prob", "fused_dropout_add_ln")
    shape = X.shape
    d = shape[-1]
    out = fused_dropout_add_ln_fwd(
        X.reshape(-1, d).contiguous(), Residual.reshape(-1, d).contiguous(),
        Scale, Bias, eps=float(attrs.get("epsilon", 1e-5)))
    return out.reshape(shape)


@register_op("fused_embedding_gather", inputs=["W", "Ids"], outputs=["Out"])
def fused_embedding_gather(ctx, attrs, W, Ids):
    """``lookup_table`` semantics through the embedding gather kernel."""
    ids = _flat_ids(Ids)
    out = embedding_gather_fwd(W, ids.reshape(-1).contiguous(),
                               attrs.get("padding_idx", -1))
    return out.reshape(tuple(ids.shape) + (W.shape[1],))
