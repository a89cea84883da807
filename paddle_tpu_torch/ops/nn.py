"""Neural-network ops of BERT serving and pretraining and of ResNet
training (mirrors ``paddle_tpu/ops/nn.py``: cross_entropy :43,
softmax_with_cross_entropy :62, softmax, dropout,
lookup_table/embedding :138-152, one_hot :167,
layer_norm :182, batch_norm :220, conv2d/depthwise_conv2d (``_conv_nd``
:290, :323-330), pool2d (``_pool_nd`` :372, :435), accuracy :440,
fused_multihead_attention :523, fused_dropout_add_ln :555,
sigmoid_cross_entropy_with_logits :473,
fused_bias_act :582, fused_conv_bn_act :598, fused_embedding_gather
:674; the dygraph layers' conv3d :333, conv2d_transpose :338, prelu :511,
spectral_norm :805, row_conv :837, nce :872, conv3d_transpose :968,
pool3d :997, group_norm :1003, sync_batch_norm :1029; the everyday
ops: lookup_table_v2 :145 and lookup_sparse_table :155, the dense
table's plain lookup, one_hot_v2 :176, huber_loss :456, smooth_l1_loss
:487, label_smooth :503, selu :687, multiplex :695, sampling_id :705,
uniform_random_batch_size_like / gaussian_random_batch_size_like
:715-742, add_position_encoding :745, hash :766, data_norm :791,
hierarchical_sigmoid :910, sampled_softmax_with_cross_entropy :942).

Random ops.  ``sampling_id``, the two ``*_batch_size_like`` draws and
the negatives of ``nce`` and of the sampled softmax are drawn on the
device from the run's step seed (``ctx.step_seed``), so a program
holding them is captured whole and every step, eager or replayed, draws
anew.  As in the reference, the negatives' ``seed`` attr is folded into
that per-step draw and the other three ignore theirs.  The packages draw
different numbers; only their distributions agree.

Synchronized batch norm.  In the reference's data parallel the batch
statistics are always global (GSPMD reduces them over the sharded
batch), and ``sync_batch_norm`` is ``batch_norm`` under another name.
The port's ranks each hold their own rows, so where the statistics must
be global (``sync_batch_norm`` with ring 0 bound; ``batch_norm`` and
``fused_conv_bn_act`` under a world-N data-parallel runner, which sets
``ctx.sync_stats``) each rank sums its rows per channel (Σx, Σx², count)
and one allreduce of that [3, C] block gives every rank the global mean
and ``max(E[x²] - E[x]², 0)`` variance.  The allreduce's gradient is the
allreduce of the gradient (:class:`_GroupSum`), so the backward sums the
two per-channel gradient sums over the ranks before the elementwise
pass; for ``fused_conv_bn_act`` that sum lies between the K4 backward
kernel, which gives the gradients at the mean and rstd, and the conv
output's gradient.

The four kernel-backed ``fused_*`` ops route to the hand-written CUDA
kernels under :mod:`paddle_tpu_torch.ops.cuda`, whose autograd functions
carry their backward kernels; the other ops are plain PyTorch.  The
convolutions (2-D, 3-D and transposed) and pooling windows stay PyTorch
calls (cuDNN on the GPU), as the reference leaves them to XLA.  An op that drops takes its seed
from the device, per step and per op (``ctx.step_seed``: the run's step
tensor and the op's salt), as the reference folds its traced step key
(:542-547, :569-574), and runs at rate 0 under ``is_test`` or in shape
inference.
"""

import math as _math

import torch
import torch.nn.functional as F

from .common import (device_bits, device_normal, device_uniform,
                     fluid_broadcast, gumbel_of_bits, resolve_dtype,
                     scalar_like)
from .cuda import dropout as _drop
from .cuda.conv_bn_act import ACTS as _EPILOGUE_ACTS
from .cuda.conv_bn_act import bn_act_epilogue
from .cuda.embedding import embedding_gather
from .cuda.flash_attention import flash_attention
from .cuda.fused_ln import fused_dropout_add_ln as _fused_ln
from .registry import get_op_def, register_op


@register_op("cross_entropy", inputs=["X", "Label"], outputs=["Y"])
def cross_entropy(ctx, attrs, X, Label):
    """``-log(p + 1e-12)`` of the label's probability (``soft_label``:
    ``-sum(label * log(p + 1e-12))``), 0 at ``ignore_index``; a negative
    label reads class 0 and a label >= C reads NaN, as the reference's
    ``take_along_axis``."""
    eps = 1e-12
    if attrs.get("soft_label", False):
        return -torch.sum(Label * torch.log(X + eps), dim=-1, keepdim=True)
    lab = Label[..., 0] if Label.shape[-1] == 1 else Label
    lab = lab.long()
    classes = X.shape[-1]
    picked = torch.gather(X, -1, lab.clamp(0, classes - 1)[..., None])[
        ..., 0]
    picked = torch.where(lab >= classes,
                         torch.full_like(picked, float("nan")), picked)
    loss = -torch.log(picked + eps)
    ignore = int(attrs.get("ignore_index", -100))
    loss = torch.where(lab == ignore, torch.zeros_like(loss), loss)
    return loss[..., None]


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


@register_op("log_softmax", inputs=["X"], outputs=["Out"])
def log_softmax(ctx, attrs, X):
    return torch.log_softmax(X, dim=int(attrs.get("axis", -1)))


@register_op("dropout", inputs=["X"], outputs=["Out", "Mask"],
             stateful_outputs=("Mask",))
def dropout(ctx, attrs, X):
    """The keep mask comes from the card generator of the fused kernels
    (:mod:`.cuda.dropout`, b = 0 over the rows of the last axis), seeded
    from the device per step and per op (a user ``seed`` attr folded
    into the salt), so it is the same on every device; the reference
    draws it with ``jax.random``."""
    p = float(attrs.get("dropout_prob", 0.5))
    is_test = attrs.get("is_test", False) or ctx.mode == "infer"
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if is_test:
        out = X if impl == "upscale_in_train" \
            else X * scalar_like(1.0 - p, X)
        return {"Out": out, "Mask": torch.ones_like(X, dtype=torch.uint8)}
    seed = ctx.step_seed(fold=int(attrs.get("seed", 0) or 0))
    keep = _drop.row_keep_mask(seed, p, tuple(X.shape), X.device,
                               debug=False)
    if impl == "upscale_in_train":
        scale = 1.0 / (1.0 - p) if p < 1.0 else 0.0
        out = torch.where(keep, X * scalar_like(scale, X),
                          torch.zeros_like(X))
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


@register_op("lookup_table_v2", inputs=["W", "Ids"], outputs=["Out"])
def lookup_table_v2(ctx, attrs, W, Ids):
    """v2's ids carry no trailing 1; the lookup is ``lookup_table``'s (a
    trailing 1 is still squeezed, as the reference's ``_lookup`` does)."""
    return _lookup(W, Ids, attrs.get("padding_idx", -1))


@register_op("embedding", inputs=["W", "Ids"], outputs=["Out"])
def embedding(ctx, attrs, W, Ids):
    return _lookup(W, Ids, attrs.get("padding_idx", -1))


@register_op("lookup_sparse_table", inputs=["W", "Ids"], outputs=["Out"])
def lookup_sparse_table(ctx, attrs, W, Ids):
    """The parameter server's auto-grown table: on a dense table every
    row already exists, so it is the plain lookup (the reference's
    reading, ``auto_grown_table`` / ``is_test`` unread)."""
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


@register_op("one_hot_v2", inputs=["X"], outputs=["Out"], no_grad=True)
def one_hot_v2(ctx, attrs, X):
    """float32 one-hot over ``depth`` of every id (no trailing-1 squeeze);
    an id outside [0, depth) gives a row of zeros."""
    cols = torch.arange(int(attrs["depth"]), device=X.device)
    return (X.long()[..., None] == cols).to(torch.float32)


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
                           dropout_seed=ctx.step_seed() if rate else None)


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
                    seed=ctx.step_seed() if rate else None)
    return out.reshape(shape)


@register_op("square_error_cost", inputs=["X", "Y"], outputs=["Out"])
def square_error_cost(ctx, attrs, X, Y):
    """``(X - Y)²`` elementwise (the reference's :468)."""
    return torch.square(X - Y)


@register_op("sigmoid_cross_entropy_with_logits", inputs=["X", "Label"],
             outputs=["Out"])
def sigmoid_cross_entropy_with_logits(ctx, attrs, X, Label):
    """The reference's stable form, ``max(x, 0) - x * z + log1p(exp(-|x|))``,
    zero where the label is ``ignore_index``; ``normalize`` divides by the
    count of the other labels (at least 1)."""
    ignore = attrs.get("ignore_index", -100)
    loss = torch.clamp(X, min=0) - X * Label \
        + torch.log1p(torch.exp(-torch.abs(X)))
    ignored = Label == ignore
    loss = torch.where(ignored, torch.zeros_like(loss), loss)
    if attrs.get("normalize", False):
        loss = loss / torch.clamp((~ignored).to(loss.dtype).sum(), min=1.0)
    return loss


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


class _GroupSum(torch.autograd.Function):
    """The sum over a process group, whose gradient is the sum over the
    group of the gradients (every rank's loss reads the sum)."""

    @staticmethod
    def forward(fctx, x, group):
        from . import comm

        fctx.group = group
        return comm.all_reduce_sum(x.contiguous(), group)

    @staticmethod
    def backward(fctx, g):
        from . import comm

        return comm.all_reduce_sum(g.contiguous(), fctx.group), None


def _batch_stats(x32, reduce_dims, group=None):
    """The reference's single-pass batch statistics (:236-244): the mean
    and the clamped ``max(E[x^2] - E[x]^2, 0)`` variance, float32; over
    every rank of ``group`` when one is given."""
    if group is None:
        bm = x32.mean(dim=reduce_dims)
        bv = torch.clamp(torch.square(x32).mean(dim=reduce_dims)
                         - torch.square(bm), min=0.0)
        return bm, bv
    s1 = x32.sum(dim=reduce_dims)
    count = torch.full_like(s1, float(x32.numel() // s1.numel()))
    total = _GroupSum.apply(
        torch.stack([s1, torch.square(x32).sum(dim=reduce_dims), count]),
        group)
    bm = total[0] / total[2]
    bv = torch.clamp(total[1] / total[2] - torch.square(bm), min=0.0)
    return bm, bv


def _stats_group(ctx, op_type):
    """The group a batch norm's statistics are summed over, or None."""
    if op_type == "sync_batch_norm":
        return ctx.rings.get(0)
    return getattr(ctx, "sync_stats", None)


def _running(stat, batch, momentum):
    """``stat * momentum + batch * (1 - momentum)`` written into ``stat``
    (declared in place), outside the tape (the reference's
    stop_gradient): a stateful output takes no gradient."""
    with torch.no_grad():
        stat.copy_(stat * momentum + batch.detach() * (1 - momentum))
    return stat


@register_op(
    "batch_norm",
    inputs=["X", "Scale", "Bias", "Mean", "Variance"],
    outputs=["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"],
    stateful_outputs=("MeanOut", "VarianceOut", "SavedMean",
                      "SavedVariance"),
    in_place={"MeanOut": "Mean", "VarianceOut": "Variance"})
def batch_norm(ctx, attrs, X, Scale, Bias, Mean, Variance,
               _op_type="batch_norm"):
    """Training uses the batch's statistics and moves the running ones
    (MeanOut/VarianceOut, the same vars as Mean/Variance) by
    ``momentum``; SavedVariance holds rstd, as the reference's (:248).
    The statistics are global where the module docstring says."""
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
        bm, bv = _batch_stats(x32, reduce_dims, _stats_group(ctx, _op_type))
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


@register_op(
    "sync_batch_norm",
    inputs=["X", "Scale", "Bias", "Mean", "Variance"],
    outputs=["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"],
    stateful_outputs=("MeanOut", "VarianceOut", "SavedMean",
                      "SavedVariance"),
    in_place={"MeanOut": "Mean", "VarianceOut": "Variance"},
    capturable=False)
def sync_batch_norm(ctx, attrs, X, Scale, Bias, Mean, Variance):
    """Cross-rank batch norm (``sync_batch_norm_op.cu``): ``batch_norm``
    with its statistics summed over ring 0's group when one is bound
    (the reference's :1029 is the plain lowering: its statistics are
    already global)."""
    return batch_norm(ctx, attrs, X, Scale, Bias, Mean, Variance,
                      _op_type="sync_batch_norm")


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


_NCHW_LAYOUTS = {2: ("NCHW", "AnyLayout"), 3: ("NCDHW", "AnyLayout", "NCHW")}


def _conv_nd(attrs, Input, Filter):
    """``_conv_nd`` for 2-D and 3-D convolutions (the filter's rank says
    which).  The filter stays OI(D)HW.  A channels-last input goes to
    ``F.conv2d`` / ``F.conv3d`` as its NC*-shaped view (``permute``, no
    copy) with the filter in channels_last memory, so cuDNN runs a
    channels-last algorithm and the output permuted back is a contiguous
    channels-last tensor."""
    nd = Filter.dim() - 2
    strides = [int(s) for s in attrs.get("strides", [1] * nd)]
    dilations = [int(d) for d in attrs.get("dilations", [1] * nd)]
    groups = int(attrs.get("groups", 1) or 1)
    channels_last = attrs.get("data_format", "NCHW") not in _NCHW_LAYOUTS[nd]
    x, w = Input, Filter
    if channels_last:
        x = x.permute(0, nd + 1, *range(1, nd + 1))
        w = w.contiguous(memory_format=torch.channels_last if nd == 2
                         else torch.channels_last_3d)
    pads = _conv_padding(attrs.get("paddings", [0] * nd), tuple(x.shape[2:]),
                         tuple(w.shape[2:]), strides, dilations)
    if all(lo == hi for lo, hi in pads):
        padding = [lo for lo, _ in pads]
    else:
        x = F.pad(x, [p for pair in reversed(pads) for p in pair])
        padding = 0
    conv = F.conv2d if nd == 2 else F.conv3d
    out = conv(x, w, None, strides, padding, dilations, groups)
    if channels_last:
        out = out.permute(0, *range(2, nd + 2), 1)
    return out.to(torch.promote_types(Input.dtype, Filter.dtype))


@register_op("conv2d", inputs=["Input", "Filter"], outputs=["Output"])
def conv2d(ctx, attrs, Input, Filter):
    return _conv_nd(attrs, Input, Filter)


@register_op("depthwise_conv2d", inputs=["Input", "Filter"],
             outputs=["Output"])
def depthwise_conv2d(ctx, attrs, Input, Filter):
    return _conv_nd(attrs, Input, Filter)


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


@register_op("pool3d", inputs=["X"], outputs=["Out"])
def pool3d(ctx, attrs, X):
    """NCDHW (or channels-last) 3-D pooling, the reference's ``_pool_nd``
    for 3-D (:372, :997): global and adaptive windows as ``pool2d``'s;
    the padding is explicit (-inf for max, zeros for average), average
    sums in float32 and divides by the window, or, when ``exclusive`` and
    padded, by the count of real cells under it."""
    ptype = attrs.get("pooling_type", "max")
    ksize = [int(k) for k in attrs.get("ksize", [2, 2, 2])]
    strides = [int(s) for s in attrs.get("strides", [2, 2, 2])]
    paddings = [int(p) for p in attrs.get("paddings", [0, 0, 0])]
    exclusive = attrs.get("exclusive", True)
    adaptive = attrs.get("adaptive", False)
    channels_last = attrs.get("data_format", "NCHW") not in (
        "NCHW", "NCDHW", "AnyLayout")
    x = X.permute(0, 4, 1, 2, 3) if channels_last else X
    spatial = list(x.shape[2:])
    if attrs.get("global_pooling", False) or (adaptive
                                              and ksize == [1, 1, 1]):
        ksize, strides, paddings = spatial, [1, 1, 1], [0, 0, 0]
    elif adaptive:
        ksize = [s // k for s, k in zip(spatial, ksize)]
        strides, paddings = list(ksize), [0, 0, 0]
    pad = [p for p in reversed(paddings) for _ in range(2)]
    if ptype == "max":
        low = (float("-inf") if x.is_floating_point()
               else torch.iinfo(x.dtype).min)
        out = F.max_pool3d(F.pad(x, pad, value=low), ksize, strides)
    else:
        s = F.avg_pool3d(F.pad(x.float(), pad), ksize, strides,
                         divisor_override=1)
        if exclusive and any(paddings):
            ones = torch.ones((1, 1) + tuple(spatial), dtype=torch.float32,
                              device=x.device)
            out = s / F.avg_pool3d(F.pad(ones, pad), ksize, strides,
                                   divisor_override=1)
        else:
            out = s / float(_math.prod(ksize))
        out = out.to(X.dtype)
    return out.permute(0, 2, 3, 4, 1) if channels_last else out


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
    stateful_outputs=("MeanOut", "VarianceOut"),
    in_place={"MeanOut": "Mean", "VarianceOut": "Variance"})
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
    conv = _conv_nd(attrs, Input, Filter)
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
        use_mean, use_var = _batch_stats(
            x32, reduce_dims, _stats_group(ctx, "fused_conv_bn_act"))
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


@register_op("conv3d", inputs=["Input", "Filter"], outputs=["Output"])
def conv3d(ctx, attrs, Input, Filter):
    return _conv_nd(attrs, Input, Filter)


def _transpose_pads(paddings, ksize, strides, dilations):
    """(lo, hi) of each spatial dim to crop from (or, negative, to add to)
    the full transposed convolution, whose length is ``(in - 1) * s + d
    (k - 1) + 1``: the reference's padding attr, symmetric ints, pairs, or
    jax's ``'SAME'`` / ``'VALID'`` (their input-side pads ``A``, ``B`` of
    the fractionally strided conv give ``d (k - 1) - A`` and ``- B``)."""
    dks = [d * (int(k) - 1) + 1 for k, d in zip(ksize, dilations)]
    if isinstance(paddings, str):
        pads = []
        for dk, s in zip(dks, strides):
            if paddings.upper() == "SAME":
                total = dk + s - 2
                lo = dk - 1 if s > dk - 1 else -(-total // 2)
            else:  # VALID
                total = dk + s - 2 + max(dk - s, 0)
                lo = dk - 1
            pads.append((dk - 1 - lo, dk - 1 - (total - lo)))
        return pads
    if len(paddings) == len(ksize):
        return [(int(p), int(p)) for p in paddings]
    return [(int(paddings[2 * i]), int(paddings[2 * i + 1]))
            for i in range(len(ksize))]


def _conv_transpose(attrs, Input, Filter):
    """NC(D)HW transposed convolution (``conv_transpose_op.cc``); the
    filter is [C_in, C_out / groups, *k], the layout of
    ``F.conv_transpose2d`` / ``3d``, and the output has ``C_out`` =
    filter dim 1 times ``groups`` channels.  Symmetric non-negative
    padding goes to the library call; other padding crops or zero-pads
    the unpadded result."""
    nd = Filter.dim() - 2
    strides = [int(s) for s in attrs.get("strides", [1] * nd)]
    dilations = [int(d) for d in attrs.get("dilations", [1] * nd)]
    groups = int(attrs.get("groups", 1) or 1)
    pads = _transpose_pads(attrs.get("paddings", [0] * nd),
                           tuple(Filter.shape[2:]), strides, dilations)
    fn = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
    if all(lo == hi and lo >= 0 for lo, hi in pads):
        return fn(Input, Filter, None, strides, [lo for lo, _ in pads], 0,
                  groups, dilations)
    out = fn(Input, Filter, None, strides, 0, 0, groups, dilations)
    grow = [max(-p, 0) for pair in reversed(pads) for p in pair]
    if any(grow):
        out = F.pad(out, grow)
    index = [slice(None), slice(None)]
    for i, (lo, hi) in enumerate(pads):
        n = out.shape[2 + i]
        index.append(slice(max(lo, 0), n - max(hi, 0)))
    return out[tuple(index)]


@register_op("conv2d_transpose", inputs=["Input", "Filter"],
             outputs=["Output"])
def conv2d_transpose(ctx, attrs, Input, Filter):
    return _conv_transpose(attrs, Input, Filter)


@register_op("conv3d_transpose", inputs=["Input", "Filter"],
             outputs=["Output"])
def conv3d_transpose(ctx, attrs, Input, Filter):
    return _conv_transpose(attrs, Input, Filter)


@register_op("prelu", inputs=["X", "Alpha"], outputs=["Out"])
def prelu(ctx, attrs, X, Alpha):
    """``x`` where ``x >= 0``, else ``alpha * x``: one alpha (``all``),
    one a channel, or one an element of a sample (``element``)."""
    mode = attrs.get("mode", "all")
    if mode == "all":
        a = Alpha.reshape(())
    elif mode == "channel":
        a = Alpha.reshape((1, -1) + (1,) * (X.dim() - 2))
    else:
        a = Alpha.reshape((1,) + tuple(X.shape[1:]))
    return torch.where(X >= 0, X, a * X)


@register_op("spectral_norm", inputs=["Weight", "U", "V"], outputs=["Out"])
def spectral_norm(ctx, attrs, Weight, U, V):
    """Power-iteration spectral normalization (``spectral_norm_op.h``):
    ``power_iters`` times ``v = W^T u / (|.| + eps)``, ``u = W v / (|.| +
    eps)``; ``sigma = u^T W v``; ``W / sigma``, with ``dim`` the height
    axis.  The iterated ``u`` and ``v`` take no gradient."""
    dim = int(attrs.get("dim", 0))
    power_iters = int(attrs.get("power_iters", 1))
    eps = float(attrs.get("eps", 1e-12))
    w = Weight
    perm = None
    if dim != 0:
        perm = [dim] + [i for i in range(w.dim()) if i != dim]
        w = w.permute(perm)
    h = w.shape[0]
    mat = w.reshape(h, -1)
    u = U.reshape(h)
    v = V.reshape(-1)
    with torch.no_grad():
        for _ in range(power_iters):
            v = mat.T @ u
            v = v / (torch.linalg.vector_norm(v) + eps)
            u = mat @ v
            u = u / (torch.linalg.vector_norm(u) + eps)
    sigma = u @ (mat @ v)
    out = w / sigma
    if perm is not None:
        out = out.permute([perm.index(i) for i in range(len(perm))])
    return out


@register_op("row_conv", inputs=["X", "Filter"], outputs=["Out"])
def row_conv(ctx, attrs, X, Filter):
    """Lookahead row convolution (``row_conv_op.cc``) of a padded
    [B, T, D] input with a [K, D] filter: ``out[t] = sum_{i < K, t + i <
    T} x[t + i] * w[i]``."""
    out = X * Filter[0]
    for i in range(1, Filter.shape[0]):
        shifted = F.pad(X[:, i:, :], (0, 0, 0, i))
        out = out + shifted * Filter[i]
    return out


def _sampler_logq(sampler, ids, n):
    """log q(id) under the negative sampler (``nce_op.h``): 0 uniform, 1
    log-uniform (Zipf, ``q(c) = log((c + 2) / (c + 1)) / log(n + 1)``)."""
    if sampler == 1:
        ids_f = ids.to(torch.float32)
        q = torch.log((ids_f + 2.0) / (ids_f + 1.0)) / _math.log(n + 1.0)
        return torch.log(torch.clamp(q, min=1e-20))
    return torch.full(tuple(ids.shape), -_math.log(float(n)),
                      device=ids.device)


def _draw_negatives(ctx, sampler, k, n, seed=0, device=None):
    """``k`` negative class ids in [0, n), shared across the batch (the
    negatives of ``nce`` and of the sampled softmax): drawn on ``device``
    (the run's by default) from the op's step seed with a ``seed`` attr
    folded in, as the reference folds it into its per-step key, so every
    rank draws the same ones and every step new ones; uniform (sampler
    0) or log-uniform by the inverse CDF ``exp(u log(n + 1)) - 1``."""
    seed = ctx.step_seed(fold=int(seed or 0))
    device = ctx.device if device is None else device
    if sampler == 1:
        u = device_uniform(seed, (k,), device)
        ids = torch.exp(u * _math.log(n + 1.0)) - 1.0
        return torch.clamp(ids.to(torch.int64), 0, n - 1)
    return device_bits(seed, (k,), device) % n


@register_op("nce", inputs=["Input", "Label", "Weight", "Bias",
                            "SampleWeight"],
             outputs=["Cost", "SampleLogits", "SampleLabels"],
             stateful_outputs=("SampleLogits", "SampleLabels"))
def nce(ctx, attrs, Input, Label, Weight, Bias, SampleWeight):
    """Noise-contrastive estimation (``nce_op.h``): the binary logistic
    loss of the true class against ``k`` sampled noise classes, each
    logit corrected by ``log(k q)``; the negatives are drawn on the
    device a step (:func:`_draw_negatives`)."""
    k = int(attrs.get("num_neg_samples", 10))
    n = int(attrs.get("num_total_classes"))
    sampler = int(attrs.get("sampler", 0))
    b = Input.shape[0]
    lbl = Label.reshape(b, -1)[:, 0].long()
    neg = _draw_negatives(ctx, sampler, k, n, attrs.get("seed", 0),
                          Input.device)
    s_true = (Input * Weight[lbl]).sum(dim=1, keepdim=True)
    if Bias is not None:
        s_true = s_true + Bias.reshape(-1)[lbl][:, None]
    s_neg = Input @ Weight[neg].T
    if Bias is not None:
        s_neg = s_neg + Bias.reshape(-1)[neg][None, :]
    log_k = _math.log(float(k))
    adj_true = s_true - (log_k + _sampler_logq(sampler, lbl, n))[:, None]
    adj_neg = s_neg - (log_k + _sampler_logq(sampler, neg, n))[None, :]
    # -log sigma(true) - sum log(1 - sigma(neg)), as softplus
    cost = F.softplus(-adj_true)[:, 0] + F.softplus(adj_neg).sum(dim=1)
    if SampleWeight is not None:
        cost = cost * SampleWeight.reshape(-1)
    labels = torch.cat([lbl[:, None], neg[None, :].expand(b, k)], dim=1)
    return {"Cost": cost[:, None],
            "SampleLogits": torch.cat([s_true, s_neg], dim=1).detach(),
            "SampleLabels": labels}


@register_op("group_norm", inputs=["X", "Scale", "Bias"],
             outputs=["Y", "Mean", "Variance"],
             stateful_outputs=("Mean", "Variance"))
def group_norm(ctx, attrs, X, Scale, Bias):
    """Group normalization (``group_norm_op.cc``) of an NC* input: the
    statistics of each (sample, group) in float32, single pass
    ``max(E[x^2] - E[x]^2, 0)`` as ``batch_norm``'s."""
    g = int(attrs.get("groups", 1))
    eps = float(attrs.get("epsilon", 1e-5))
    n, c = X.shape[0], X.shape[1]
    xg = X.reshape((n, g, c // g) + tuple(X.shape[2:])).float()
    dims = tuple(range(2, xg.dim()))
    mean = xg.mean(dim=dims, keepdim=True)
    var = torch.clamp(torch.square(xg).mean(dim=dims, keepdim=True)
                      - torch.square(mean), min=0.0)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(X.shape)
    shape = (1, c) + (1,) * (X.dim() - 2)
    if Scale is not None:
        y = y * Scale.reshape(shape).float()
    if Bias is not None:
        y = y + Bias.reshape(shape).float()
    return {"Y": y.to(X.dtype), "Mean": mean.reshape(n, g).detach(),
            "Variance": var.reshape(n, g).detach()}


@register_op("huber_loss", inputs=["X", "Y"], outputs=["Out", "Residual"],
             stateful_outputs=("Residual",))
def huber_loss(ctx, attrs, X, Y):
    """``0.5 r^2`` where ``|r| <= delta``, else ``delta (|r| - delta /
    2)``, with ``r = Y - X``."""
    delta = attrs.get("delta", 1.0)
    r = Y - X
    ar = torch.abs(r)
    loss = torch.where(ar <= delta, 0.5 * torch.square(r),
                       delta * (ar - 0.5 * delta))
    return {"Out": loss, "Residual": r.detach()}


@register_op("smooth_l1_loss",
             inputs=["X", "Y", "InsideWeight", "OutsideWeight"],
             outputs=["Diff", "Out"], stateful_outputs=("Diff",))
def smooth_l1_loss(ctx, attrs, X, Y, InsideWeight, OutsideWeight):
    """Per row, the sum of ``0.5 sigma^2 d^2`` where ``|d| < 1 /
    sigma^2``, else ``|d| - 0.5 / sigma^2``, with ``d = (X - Y) *
    InsideWeight`` and each term times OutsideWeight."""
    sigma = attrs.get("sigma", 1.0)
    s2 = sigma * sigma
    d = X - Y
    if InsideWeight is not None:
        d = d * InsideWeight
    ad = torch.abs(d)
    loss = torch.where(ad < 1.0 / s2, 0.5 * s2 * torch.square(d),
                       ad - 0.5 / s2)
    if OutsideWeight is not None:
        loss = loss * OutsideWeight
    loss = loss.reshape(loss.shape[0], -1).sum(dim=1, keepdim=True)
    return {"Diff": d.detach(), "Out": loss}


@register_op("label_smooth", inputs=["X", "PriorDist"], outputs=["Out"])
def label_smooth(ctx, attrs, X, PriorDist):
    """``(1 - eps) X + eps PriorDist``, or ``+ eps / C`` without a prior."""
    eps = attrs.get("epsilon", 0.0)
    if PriorDist is not None:
        return (1 - eps) * X + eps * PriorDist
    return (1 - eps) * X + eps / X.shape[-1]


@register_op("selu", inputs=["X"], outputs=["Out"])
def selu(ctx, attrs, X):
    """``scale * (x if x > 0 else alpha (e^x - 1))`` (``selu_op.cc``)."""
    scale = float(attrs.get("scale", 1.0507009873554805))
    alpha = float(attrs.get("alpha", 1.6732632423543772))
    return scale * torch.where(X > 0, X, alpha * (torch.exp(X) - 1.0))


@register_op("multiplex", inputs=["X*", "Ids"], outputs=["Out"])
def multiplex(ctx, attrs, X, Ids):
    """Row i of candidate ``Ids[i]`` (``multiplex_op.cc``)."""
    stacked = torch.stack(list(X), dim=0)
    ids = Ids.reshape(-1).long()
    return stacked[ids, torch.arange(stacked.shape[1], device=ids.device)]


@register_op("sampling_id", inputs=["X"], outputs=["Out"], no_grad=True)
def sampling_id(ctx, attrs, X):
    """One column a row, drawn with the row's probabilities: the argmax
    of ``log(max(p, 1e-38))`` plus Gumbel noise drawn on the device
    (the reference's ``jax.random.categorical``, which ignores the
    ``seed`` attr: so does this)."""
    g = gumbel_of_bits(device_bits(ctx.step_seed(), tuple(X.shape),
                                   X.device))
    logits = torch.log(torch.clamp(X.float(), min=1e-38))
    return torch.argmax(logits + g, dim=-1)


def _batch_size_like_shape(attrs, Input):
    shape = [int(s) for s in attrs["shape"]]
    shape[int(attrs.get("output_dim_idx", 0))] = \
        Input.shape[int(attrs.get("input_dim_idx", 0))]
    return tuple(shape)


@register_op("uniform_random_batch_size_like", inputs=["Input"],
             outputs=["Out"], no_grad=True)
def uniform_random_batch_size_like(ctx, attrs, Input):
    """U(min, max) in ``shape`` with one dim taken from Input, drawn on
    the device a step; the ``seed`` attr is ignored, as in the
    reference."""
    shape = _batch_size_like_shape(attrs, Input)
    lo = float(attrs.get("min", -1.0))
    hi = float(attrs.get("max", 1.0))
    u = device_uniform(ctx.step_seed(), shape, Input.device)
    return (lo + (hi - lo) * u).to(resolve_dtype(attrs.get("dtype", 5)))


@register_op("gaussian_random_batch_size_like", inputs=["Input"],
             outputs=["Out"], no_grad=True)
def gaussian_random_batch_size_like(ctx, attrs, Input):
    """N(mean, std) in ``shape`` with one dim taken from Input, drawn on
    the device a step; the ``seed`` attr is ignored, as in the
    reference."""
    shape = _batch_size_like_shape(attrs, Input)
    z = device_normal(ctx.step_seed(), shape, Input.device)
    out = float(attrs.get("mean", 0.0)) + float(attrs.get("std", 1.0)) * z
    return out.to(resolve_dtype(attrs.get("dtype", 5)))


@register_op("add_position_encoding", inputs=["X"], outputs=["Out"])
def add_position_encoding(ctx, attrs, X):
    """``alpha x + beta PE`` with ``PE[j, k] = sin(j / 10000^(k / (half -
    1)))`` for k < half and the cosine after it; an odd last column
    adds nothing, as the reference defines it."""
    alpha = float(attrs.get("alpha", 1.0))
    beta = float(attrs.get("beta", 1.0))
    _, t, d = X.shape
    half = d // 2
    j = torch.arange(t, dtype=torch.float32, device=X.device)[:, None]
    k = torch.arange(half, dtype=torch.float32, device=X.device)[None, :]
    val = j / torch.pow(10000.0, k / max(half - 1, 1))
    parts = [torch.sin(val), torch.cos(val)]
    if d % 2:
        parts.append(torch.zeros((t, 1), dtype=torch.float32,
                                 device=X.device))
    pe = torch.cat(parts, dim=1)
    return alpha * X + beta * pe[None, :, :].to(X.dtype)


@register_op("hash", inputs=["X"], outputs=["Out"], no_grad=True)
def hash_op(ctx, attrs, X):
    """``num_hash`` hashes of each id row mod ``mod_by``: the reference's
    mix in uint32 arithmetic, bit for bit (int64 here, each product
    masked to 32 bits by ``_mul32``); a 2-D X gives [N, num_hash, 1]."""
    mask = _drop.MASK32
    num_hash = int(attrs.get("num_hash", 1))
    mod_by = int(attrs.get("mod_by", 1))
    x = X.long() & mask
    outs = []
    for seed in range(num_hash):
        h = torch.full(tuple(x.shape[:-1]), (0x9E3779B9 * (seed + 1)) & mask,
                       dtype=torch.int64, device=X.device)
        for i in range(x.shape[-1]):
            v = _drop._mul32(x[..., i], 0x85EBCA6B)
            v = v ^ (v >> 13)
            v = _drop._mul32(v, 0xC2B2AE35)
            h = _drop._mul32(h ^ v, 0x01000193)
        outs.append(h % mod_by)
    out = torch.stack(outs, dim=-1)
    return out[..., None] if X.dim() == 2 else out


@register_op("data_norm", inputs=["X", "BatchSize", "BatchSum",
                                  "BatchSquareSum"],
             outputs=["Y", "Means", "Scales"],
             stateful_outputs=("Means", "Scales"))
def data_norm(ctx, attrs, X, BatchSize, BatchSum, BatchSquareSum):
    """CTR feature normalization (``data_norm_op.cc``): ``means = sum /
    size``, ``scales = sqrt(size / square_sum)``, ``y = (x - means) *
    scales``; the statistics are persistable parameters."""
    means = BatchSum / BatchSize
    scales = torch.sqrt(BatchSize / BatchSquareSum)
    y = (X - means[None, :]) * scales[None, :]
    return {"Y": y, "Means": means.detach(), "Scales": scales.detach()}


@register_op("hierarchical_sigmoid",
             inputs=["X", "W", "Label", "Bias", "PathTable", "PathCode"],
             outputs=["Out", "PreOut"], stateful_outputs=("PreOut",))
def hierarchical_sigmoid(ctx, attrs, X, W, Label, Bias, PathTable=None,
                         PathCode=None):
    """Hierarchical sigmoid (``hierarchical_sigmoid_op.h``): the sum over
    a class's path of the logistic loss of ``x . w_node + b_node``
    against the path's bit.  The default tree is the complete binary
    SimpleCode (class c's code is ``c + num_classes``; node j is
    ``(code >> (j + 1)) - 1``, bit ``(code >> j) & 1``, for j below the
    code's bit length less one); a custom tree gives each row its nodes
    (``PathTable``, -1 past the end) and bits (``PathCode``)."""
    b = X.shape[0]
    if PathTable is not None:
        idx = PathTable.reshape(b, -1).long()
        bits = PathCode.reshape(b, -1).to(X.dtype)
        valid = idx >= 0
        idx = idx.clamp(min=0)
    else:
        n = int(attrs.get("num_classes"))
        code = Label.reshape(b).long() + n
        max_len = int(_math.ceil(_math.log2(2 * n)))
        js = torch.arange(max_len, device=X.device)
        length = ((code[:, None] >> (js + 1)[None, :]) > 0).sum(dim=1)
        idx = ((code[:, None] >> (js + 1)[None, :]) - 1).clamp(
            0, W.shape[0] - 1)
        bits = ((code[:, None] >> js[None, :]) & 1).to(X.dtype)
        valid = js[None, :] < length[:, None]
    pre = (X[:, None, :] * W[idx]).sum(dim=-1)
    if Bias is not None:
        pre = pre + Bias.reshape(-1)[idx]
    term = torch.logaddexp(torch.zeros_like(pre), pre) - bits * pre
    loss = torch.where(valid, term, torch.zeros_like(term)).sum(dim=1)
    return {"Out": loss[:, None],
            "PreOut": torch.zeros(tuple(idx.shape), dtype=torch.float32,
                                  device=X.device)}


@register_op("sampled_softmax_with_cross_entropy",
             inputs=["Logits", "Label", "CustomizedSamples",
                     "CustomizedProbabilities"],
             outputs=["Softmax", "Loss"], stateful_outputs=("Softmax",))
def sampled_softmax_with_cross_entropy(ctx, attrs, Logits, Label,
                                       CustomizedSamples=None,
                                       CustomizedProbabilities=None):
    """Softmax cross entropy over the true class and ``num_samples``
    sampled ones, each logit less ``log q`` of its class (the reference's
    fused form of ``sample_logits`` + softmax).  The negatives are drawn
    log-uniform on the device a step (:func:`_draw_negatives`), or, with ``use_customized_samples``, are
    each row's ``CustomizedSamples`` (true label first) with their
    probabilities.  A sampled class equal to the label is masked out
    (``remove_accidental_hits``)."""
    b, c = Logits.shape
    lbl = Label.reshape(b).long()
    if attrs.get("use_customized_samples", False):
        samples = CustomizedSamples.reshape(b, -1).long()
        z = torch.gather(Logits, 1, samples) \
            - torch.log(CustomizedProbabilities.reshape(b, -1).to(
                Logits.dtype))
        adj_true, adj_neg = z[:, :1], z[:, 1:]
        hit = samples[:, 1:] == lbl[:, None]
    else:
        neg = _draw_negatives(ctx, 1, int(attrs.get("num_samples", 10)), c,
                              attrs.get("seed", 0), Logits.device)
        s_true = torch.gather(Logits, 1, lbl[:, None])
        adj_true = s_true - _sampler_logq(1, lbl, c)[:, None]
        adj_neg = Logits[:, neg] - _sampler_logq(1, neg, c)[None, :]
        hit = neg[None, :] == lbl[:, None]
    if attrs.get("remove_accidental_hits", True):
        adj_neg = torch.where(hit, torch.full_like(adj_neg, -1e30), adj_neg)
    logp = torch.log_softmax(torch.cat([adj_true, adj_neg], dim=1), dim=1)
    return {"Loss": -logp[:, :1], "Softmax": torch.exp(logp).detach()}
