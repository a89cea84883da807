"""Neural-network ops of BERT serving and pretraining (mirrors
``paddle_tpu/ops/nn.py``: softmax_with_cross_entropy :62, softmax,
dropout, lookup_table/embedding :138-152, layer_norm :182,
fused_multihead_attention :523, fused_dropout_add_ln :555,
fused_bias_act :582, fused_embedding_gather :674).

The three kernel-backed ``fused_*`` ops route to the hand-written CUDA
kernels under :mod:`paddle_tpu_torch.ops.cuda`, whose autograd functions
carry their backward kernels; the other ops are plain PyTorch.  A fused
op that drops draws its seed per step and per op from ``ctx.rng``, as
the reference does (:542-547, :569-574), and runs at rate 0 under
``is_test`` or in shape inference.
"""

import torch

from .common import fluid_broadcast
from .cuda import dropout as _drop
from .cuda.embedding import embedding_gather
from .cuda.flash_attention import flash_attention
from .cuda.fused_ln import fused_dropout_add_ln as _fused_ln
from .registry import get_op_def, register_op


def _step_seed(ctx):
    """A seed in [0, 2**31 - 1) for this op in this step."""
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=ctx.rng()))


@register_op("softmax_with_cross_entropy", inputs=["Logits", "Label"],
             outputs=["Softmax", "Loss"], stateful_outputs=("Softmax",))
def softmax_with_cross_entropy(ctx, attrs, Logits, Label):
    axis = int(attrs.get("axis", -1)) % Logits.dim()
    ignore_index = int(attrs.get("ignore_index", -100))
    in_dtype = Logits.dtype
    x = Logits.float() if in_dtype == torch.bfloat16 else Logits
    log_softmax = x - torch.logsumexp(x, dim=axis, keepdim=True)
    if attrs.get("soft_label", False):
        loss = -(Label * log_softmax).sum(dim=axis, keepdim=True)
    else:
        lab = Label
        if lab.shape[axis] == 1:
            lab = lab.squeeze(axis)
        lab = lab.long().unsqueeze(axis)
        loss = -torch.gather(log_softmax, axis, lab.clamp(min=0))
        loss = torch.where(lab == ignore_index, torch.zeros_like(loss), loss)
    return {"Softmax": torch.exp(log_softmax.detach()).to(in_dtype),
            "Loss": loss}


@register_op("softmax", inputs=["X"], outputs=["Out"])
def softmax(ctx, attrs, X):
    axis = int(attrs.get("axis", -1))
    # f32 internals for low-precision inputs, as the reference
    return torch.softmax(X.float(), dim=axis).to(X.dtype)


@register_op("dropout", inputs=["X"], outputs=["Out", "Mask"],
             stateful_outputs=("Mask",))
def dropout(ctx, attrs, X):
    """The keep mask comes from the card generator of the fused kernels
    (:mod:`.cuda.dropout`, b = 0 over the rows of the last axis), seeded
    per step and per op, so it is the same on every device; the
    reference draws it with ``jax.random``."""
    p = float(attrs.get("dropout_prob", 0.5))
    is_test = attrs.get("is_test", False) or ctx.mode == "infer"
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if is_test:
        out = X if impl == "upscale_in_train" else X * (1.0 - p)
        return {"Out": out, "Mask": torch.ones_like(X, dtype=torch.uint8)}
    seed = _step_seed(ctx)
    if attrs.get("seed", 0):  # a user seed pins the stream, folded in
        seed = (seed * 1000003 + int(attrs["seed"])) % (2 ** 31 - 1)
    keep = _drop.row_keep_mask(seed, p, tuple(X.shape), X.device,
                               debug=False)
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


def _train_rate(ctx, attrs, key):
    """The fused op's dropout rate in this run: 0 under ``is_test`` and
    in shape inference."""
    if attrs.get("is_test") or ctx.mode != "train":
        return 0.0
    return float(attrs.get(key, 0.0) or 0.0)


@register_op("fused_multihead_attention", inputs=["Q", "K", "V", "BiasQK"],
             outputs=["Out"])
def fused_multihead_attention(ctx, attrs, Q, K, V, BiasQK=None):
    """Q,K,V [B,H,T,Dh]; BiasQK an additive key bias [B,Tk] or
    [B,1,1,Tk] (no gradient) → the flash-attention kernels."""
    rate = _train_rate(ctx, attrs, "dropout_rate")
    scale = attrs.get("scale", None)
    return flash_attention(Q, K, V, bias=BiasQK,
                           causal=bool(attrs.get("causal", False)),
                           sm_scale=None if scale is None else float(scale),
                           dropout_rate=rate,
                           dropout_seed=_step_seed(ctx) if rate else None)


@register_op("fused_dropout_add_ln", inputs=["X", "Residual", "Scale", "Bias"],
             outputs=["Out"])
def fused_dropout_add_ln(ctx, attrs, X, Residual, Scale, Bias):
    """``layer_norm(residual + dropout(x))`` over the last axis → the
    fused LN kernels on ``[N, D]`` rows."""
    rate = _train_rate(ctx, attrs, "dropout_prob")
    shape = X.shape
    d = shape[-1]
    out = _fused_ln(X.reshape(-1, d).contiguous(),
                    Residual.reshape(-1, d).contiguous(), Scale, Bias,
                    dropout_rate=rate, eps=float(attrs.get("epsilon", 1e-5)),
                    seed=_step_seed(ctx) if rate else None)
    return out.reshape(shape)


@register_op("fused_bias_act", inputs=["X", "Bias"], outputs=["Out"])
def fused_bias_act(ctx, attrs, X, Bias):
    """``act(x + bias)`` as one op, the fusion pipeline's rewrite of the
    fc bias + activation tail: the same broadcast add and the same
    registered activation as the unfused pair."""
    x, b = fluid_broadcast(X, Bias, attrs.get("axis", -1))
    act = get_op_def(attrs.get("act_type", "relu"))
    return act.fn(ctx, dict(attrs), torch.add(x, b))


@register_op("fused_embedding_gather", inputs=["W", "Ids"], outputs=["Out"])
def fused_embedding_gather(ctx, attrs, W, Ids):
    """``lookup_table`` semantics through the embedding gather kernel,
    with the scatter-add gradient."""
    ids = _flat_ids(Ids)
    out = embedding_gather(W, ids.reshape(-1).contiguous(),
                           attrs.get("padding_idx", -1))
    return out.reshape(tuple(ids.shape) + (W.shape[1],))
