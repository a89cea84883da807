"""Neural-network ops of BERT serving and pretraining and of ResNet
training (mirrors ``paddle_tpu/ops/nn.py``: softmax_with_cross_entropy
:62, softmax, dropout, lookup_table/embedding :138-152, one_hot :167,
layer_norm :182, batch_norm :220, conv2d/depthwise_conv2d (``_conv_nd``
:290, :323-330), pool2d (``_pool_nd`` :372, :435), accuracy :440,
fused_multihead_attention :523, fused_dropout_add_ln :555,
fused_bias_act :582, fused_conv_bn_act :598, fused_embedding_gather
:674).

The four kernel-backed ``fused_*`` ops route to the hand-written CUDA
kernels under :mod:`paddle_tpu_torch.ops.cuda`, whose autograd functions
carry their backward kernels; the other ops are plain PyTorch.  The
convolutions and pooling windows stay PyTorch calls (cuDNN on the GPU),
as the reference leaves them to XLA.  A fused op that drops draws its
seed per step and per op from ``ctx.rng``, as the reference does
(:542-547, :569-574), and runs at rate 0 under ``is_test`` or in shape
inference.
"""

import torch
import torch.nn.functional as F

from .common import fluid_broadcast
from .cuda import dropout as _drop
from .cuda.conv_bn_act import ACTS as _EPILOGUE_ACTS
from .cuda.conv_bn_act import bn_act_epilogue
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
        # the reference's take_along_axis reads NaN for a label >= C
        # (its fill mode) and class 0 for a negative one; clamping both
        # ends keeps the gather in range (an out-of-range index is a
        # device-side assert on CUDA), and the masks put back what the
        # reference gives: NaN, then 0 for ignore_index
        classes = log_softmax.shape[axis]
        picked = torch.gather(log_softmax, axis,
                              lab.clamp(0, classes - 1))
        picked = torch.where(lab >= classes,
                             torch.full_like(picked, float("nan")), picked)
        loss = torch.where(lab == ignore_index, torch.zeros_like(picked),
                           -picked)
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


@register_op("one_hot", inputs=["X"], outputs=["Out"], no_grad=True)
def one_hot(ctx, attrs, X):
    """float32 one-hot over ``depth``; a trailing dim of 1 is the id
    column.  Ids outside [0, depth) give a row of zeros, as
    ``jax.nn.one_hot``."""
    depth = int(attrs["depth"])
    ids = _flat_ids(X).long()
    cols = torch.arange(depth, device=ids.device)
    return (ids[..., None] == cols).to(torch.float32)


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


def _batch_stats(x32, reduce_dims):
    """The reference's single-pass batch statistics (:236-244): the mean
    and the clamped ``max(E[x^2] - E[x]^2, 0)`` variance, float32."""
    bm = x32.mean(dim=reduce_dims)
    bv = torch.clamp(torch.square(x32).mean(dim=reduce_dims)
                     - torch.square(bm), min=0.0)
    return bm, bv


def _running(stat, batch, momentum):
    """``stat * momentum + batch * (1 - momentum)``, outside the tape (the
    reference's stop_gradient): a stateful output takes no gradient."""
    return stat * momentum + batch.detach() * (1 - momentum)


@register_op(
    "batch_norm",
    inputs=["X", "Scale", "Bias", "Mean", "Variance"],
    outputs=["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"],
    stateful_outputs=("MeanOut", "VarianceOut", "SavedMean",
                      "SavedVariance"))
def batch_norm(ctx, attrs, X, Scale, Bias, Mean, Variance):
    """Training uses the batch's statistics and moves the running ones
    (MeanOut/VarianceOut, the same vars as Mean/Variance) by
    ``momentum``; SavedVariance holds rstd, as the reference's (:248)."""
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    is_test = attrs.get("is_test", False) \
        or attrs.get("use_global_stats", False)
    layout = attrs.get("data_layout", "NCHW")
    c_axis = 1 if layout == "NCHW" else X.dim() - 1
    reduce_dims = tuple(i for i in range(X.dim()) if i != c_axis)
    bshape = tuple(X.shape[i] if i == c_axis else 1 for i in range(X.dim()))
    x32 = X.float()
    if is_test:
        use_mean, use_var = Mean, Variance
        mean_out, var_out = Mean, Variance
        saved_mean, saved_var = Mean, Variance
    else:
        bm, bv = _batch_stats(x32, reduce_dims)
        use_mean, use_var = bm, bv
        mean_out = _running(Mean, bm, momentum)
        var_out = _running(Variance, bv, momentum)
        saved_mean = bm.detach()
        saved_var = torch.rsqrt(bv.detach() + eps)
    y = (x32 - use_mean.reshape(bshape)) * torch.rsqrt(
        use_var.reshape(bshape) + eps)
    y = y * Scale.reshape(bshape) + Bias.reshape(bshape)
    return {"Y": y.to(X.dtype), "MeanOut": mean_out,
            "VarianceOut": var_out, "SavedMean": saved_mean,
            "SavedVariance": saved_var}


def _same_pads(spatial, ksize, strides, dilations):
    """XLA's 'SAME' padding: output ceil(in / stride), the odd cell at
    the high end."""
    pads = []
    for n, k, s, d in zip(spatial, ksize, strides, dilations):
        total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _conv_padding(paddings, spatial, ksize, strides, dilations):
    """The reference's padding attr (:262-270) as (lo, hi) pairs."""
    if isinstance(paddings, str):
        if paddings.upper() == "VALID":
            return [(0, 0)] * len(ksize)
        return _same_pads(spatial, ksize, strides, dilations)
    if len(paddings) == len(ksize):
        return [(int(p), int(p)) for p in paddings]
    return [(int(paddings[2 * i]), int(paddings[2 * i + 1]))
            for i in range(len(ksize))]


def _conv2d(attrs, Input, Filter):
    """``_conv_nd`` for 2-D convolutions.  The filter stays OIHW.  A
    channels-last input goes to ``F.conv2d`` as its NCHW-shaped view
    (``permute``, no copy) with the filter in channels_last memory, so
    cuDNN runs an NHWC algorithm and the output permuted back is a
    contiguous NHWC tensor."""
    strides = [int(s) for s in attrs.get("strides", [1, 1])]
    dilations = [int(d) for d in attrs.get("dilations", [1, 1])]
    groups = int(attrs.get("groups", 1) or 1)
    channels_last = attrs.get("data_format", "NCHW") not in (
        "NCHW", "AnyLayout")
    x, w = Input, Filter
    if channels_last:
        x = x.permute(0, 3, 1, 2)
        w = w.contiguous(memory_format=torch.channels_last)
    pads = _conv_padding(attrs.get("paddings", [0, 0]), tuple(x.shape[2:]),
                         tuple(w.shape[2:]), strides, dilations)
    if all(lo == hi for lo, hi in pads):
        padding = [lo for lo, _ in pads]
    else:
        x = F.pad(x, [p for pair in reversed(pads) for p in pair])
        padding = 0
    out = F.conv2d(x, w, None, strides, padding, dilations, groups)
    if channels_last:
        out = out.permute(0, 2, 3, 1)
    return out.to(torch.promote_types(Input.dtype, Filter.dtype))


@register_op("conv2d", inputs=["Input", "Filter"], outputs=["Output"])
def conv2d(ctx, attrs, Input, Filter):
    return _conv2d(attrs, Input, Filter)


@register_op("depthwise_conv2d", inputs=["Input", "Filter"],
             outputs=["Output"])
def depthwise_conv2d(ctx, attrs, Input, Filter):
    return _conv2d(attrs, Input, Filter)


@register_op("pool2d", inputs=["X"], outputs=["Out"])
def pool2d(ctx, attrs, X):
    """``_pool_nd`` for 2-D: global and adaptive windows as the
    reference's; max pooling pads with -inf; average pooling sums in
    float32 and, when ``exclusive`` and padded, divides by the count of
    real cells."""
    ptype = attrs.get("pooling_type", "max")
    ksize = [int(k) for k in attrs.get("ksize", [2, 2])]
    strides = [int(s) for s in attrs.get("strides", [2, 2])]
    paddings = [int(p) for p in attrs.get("paddings", [0, 0])]
    exclusive = attrs.get("exclusive", True)
    adaptive = attrs.get("adaptive", False)
    # the conv lowering's predicate: anything not NC* is channels-last
    channels_last = attrs.get("data_format", "NCHW") not in (
        "NCHW", "NCDHW", "AnyLayout")
    x = X.permute(0, 3, 1, 2) if channels_last else X
    spatial = list(x.shape[2:])
    if attrs.get("global_pooling", False) or (adaptive and ksize == [1, 1]):
        ksize, strides, paddings = spatial, [1, 1], [0, 0]
    elif adaptive:
        ksize = [s // k for s, k in zip(spatial, ksize)]
        strides, paddings = list(ksize), [0, 0]
    if any(2 * p > k for p, k in zip(paddings, ksize)):
        out = _pool2d_wide_pad(x, ptype, ksize, strides, paddings,
                               exclusive)
    elif ptype == "max":
        out = F.max_pool2d(x, ksize, strides, paddings)
    else:
        out = F.avg_pool2d(x.float(), ksize, strides, paddings,
                           count_include_pad=not (exclusive
                                                  and any(paddings)))
        out = out.to(X.dtype)
    return out.permute(0, 2, 3, 1) if channels_last else out


def _pool2d_wide_pad(x, ptype, ksize, strides, paddings, exclusive):
    """Pooling of an NCHW ``x`` whose padding exceeds half the window,
    which ``F.max_pool2d`` / ``F.avg_pool2d`` refuse and the reference's
    ``reduce_window`` takes: pad explicitly, then pool unpadded.  Max
    pads with -inf (the least integer for integer inputs); average sums
    in float32 over zero padding and divides by the window (inclusive)
    or by the count of real cells under it (exclusive)."""
    pad = (paddings[1], paddings[1], paddings[0], paddings[0])
    if ptype == "max":
        low = (float("-inf") if x.is_floating_point()
               else torch.iinfo(x.dtype).min)
        return F.max_pool2d(F.pad(x, pad, value=low), ksize, strides)
    s = F.avg_pool2d(F.pad(x.float(), pad), ksize, strides,
                     divisor_override=1)
    if exclusive:
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=torch.float32,
                          device=x.device)
        cnt = F.avg_pool2d(F.pad(ones, pad), ksize, strides,
                           divisor_override=1)
        out = s / cnt
    else:
        out = s / float(ksize[0] * ksize[1])
    return out.to(x.dtype)


@register_op("accuracy", inputs=["Out", "Indices", "Label"],
             outputs=["Accuracy", "Correct", "Total"], no_grad=True)
def accuracy(ctx, attrs, Out, Indices, Label):
    lab = Label
    if lab.dim() > 1 and lab.shape[-1] == 1:
        lab = lab[..., 0]
    hit = (Indices == lab[:, None].to(Indices.dtype)).any(dim=1)
    correct = hit.long().sum()
    total = torch.full((), lab.shape[0], dtype=torch.int64,
                       device=Indices.device)
    return {"Accuracy": (correct / total).float().reshape(1),
            "Correct": correct.reshape(1), "Total": total.reshape(1)}


@register_op(
    "fused_conv_bn_act",
    inputs=["Input", "Filter", "Scale", "Bias", "Mean", "Variance"],
    outputs=["Out", "MeanOut", "VarianceOut"],
    stateful_outputs=("MeanOut", "VarianceOut"))
def fused_conv_bn_act(ctx, attrs, Input, Filter, Scale, Bias, Mean,
                      Variance):
    """conv2d → batch_norm → activation as one op.  The conv is the same
    lowering as the unfused op's and the statistics the same single-pass
    form as ``batch_norm``'s (torch reductions); the normalize + affine +
    act epilogue is the K4 kernel (``ops/cuda/conv_bn_act.py``) on a
    channels-last output with act identity or relu, and otherwise the
    unfused float sequence followed by the registered activation.  The
    kernel's gradient reaches the conv output through autograd, directly
    and through the statistics.  On the GPU the NHWC output must be
    contiguous as cuDNN wrote it: a copy would double the epilogue's
    traffic, so that raises."""
    conv = _conv2d(attrs, Input, Filter)
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    is_test = attrs.get("is_test", False) \
        or attrs.get("use_global_stats", False)
    layout = attrs.get("data_layout", attrs.get("data_format", "NCHW"))
    if layout == "AnyLayout":
        layout = "NCHW"
    c_axis = 1 if layout == "NCHW" else conv.dim() - 1
    reduce_dims = tuple(i for i in range(conv.dim()) if i != c_axis)
    x32 = conv.float()
    if is_test:
        use_mean, use_var = Mean, Variance
        mean_out, var_out = Mean, Variance
    else:
        use_mean, use_var = _batch_stats(x32, reduce_dims)
        mean_out = _running(Mean, use_mean, momentum)
        var_out = _running(Variance, use_var, momentum)
    act = attrs.get("act_type", "") or "identity"
    channels = conv.shape[c_axis]
    if c_axis == conv.dim() - 1 and act in _EPILOGUE_ACTS:
        if conv.device.type == "cuda" and not conv.is_contiguous():
            raise RuntimeError(
                "fused_conv_bn_act: the NHWC conv output %s with strides %s "
                "is not contiguous; the epilogue kernel reads it as [R, C] "
                "in place" % (tuple(conv.shape), conv.stride()))
        rstd = torch.rsqrt(use_var.float() + eps)
        y = bn_act_epilogue(conv.reshape(-1, channels), Scale, Bias,
                            use_mean, rstd, act).reshape(conv.shape)
    else:
        bshape = tuple(channels if i == c_axis else 1
                       for i in range(conv.dim()))
        y = (x32 - use_mean.reshape(bshape)) * torch.rsqrt(
            use_var.reshape(bshape) + eps)
        y = y * Scale.reshape(bshape) + Bias.reshape(bshape)
        y = y.to(conv.dtype)
        if act != "identity":
            y = get_op_def(act).fn(ctx, dict(attrs), y)
    return {"Out": y, "MeanOut": mean_out, "VarianceOut": var_out}
