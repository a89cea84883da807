"""Loss-family ops (mirrors ``paddle_tpu/ops/losses.py``, all of it:
``log_loss`` :13, ``kldiv_loss`` :21, ``rank_loss`` :37,
``margin_rank_loss`` :45, ``bpr_loss`` :55, ``teacher_student_sigmoid_loss``
:70, ``mean_iou`` :92 and ``bilinear_tensor_product`` :119).  The class
counts of ``mean_iou`` are scatter-adds into zeros on the device, not
``bincount`` (whose CUDA form reads the largest id on the host)."""

import torch

from .registry import register_op


def _softplus(x):
    """``log(1 + e^x)`` as ``jnp.logaddexp(0, x)``."""
    return torch.logaddexp(torch.zeros_like(x), x)


@register_op("log_loss", inputs=["Predicted", "Labels"], outputs=["Loss"])
def log_loss(ctx, attrs, Predicted, Labels):
    """``-y log(p + eps) - (1 - y) log(1 - p + eps)``."""
    eps = float(attrs.get("epsilon", 1e-4))
    p, y = Predicted, Labels
    return -y * torch.log(p + eps) - (1.0 - y) * torch.log(1.0 - p + eps)


@register_op("kldiv_loss", inputs=["X", "Target"], outputs=["Loss"])
def kldiv_loss(ctx, attrs, X, Target):
    """``target (log target - x)`` where target > 0, reduced by
    ``reduction`` (none, sum, batchmean, mean); x is a log-probability."""
    red = attrs.get("reduction", "mean")
    t = Target
    loss = torch.where(t > 0, t * (torch.log(torch.clamp(t, min=1e-38)) - X),
                       torch.zeros_like(X))
    if red == "none":
        return loss
    if red == "sum":
        return loss.sum()
    if red == "batchmean":
        return loss.sum() / X.shape[0]
    return loss.mean()


@register_op("rank_loss", inputs=["Label", "Left", "Right"], outputs=["Out"])
def rank_loss(ctx, attrs, Label, Left, Right):
    """RankNet's pairwise loss ``log(1 + e^o) - label o``, ``o = left -
    right``."""
    o = Left - Right
    return _softplus(o) - Label * o


@register_op("margin_rank_loss", inputs=["Label", "X1", "X2"],
             outputs=["Out", "Activated"], stateful_outputs=("Activated",))
def margin_rank_loss(ctx, attrs, Label, X1, X2):
    """``max(0, -label (x1 - x2) + margin)``."""
    raw = -Label * (X1 - X2) + float(attrs.get("margin", 0.0))
    return {"Out": torch.clamp(raw, min=0.0),
            "Activated": (raw > 0).to(X1.dtype)}


@register_op("bpr_loss", inputs=["X", "Label"], outputs=["Y"])
def bpr_loss(ctx, attrs, X, Label):
    """Bayesian personalized ranking: per row, the mean over the other
    classes j of ``log(1 + e^(x_j - x_y))`` (the sum over all j less the
    label's own ``log 2``)."""
    b, c = X.shape
    pos = torch.gather(X, 1, Label.reshape(b, 1).long())
    terms = _softplus(X - pos).sum(dim=1, keepdim=True)
    own = _softplus(torch.zeros((b, 1), dtype=X.dtype, device=X.device))
    return (terms - own) / (c - 1)


@register_op("teacher_student_sigmoid_loss", inputs=["X", "Label"],
             outputs=["Y"])
def teacher_student_sigmoid_loss(ctx, attrs, X, Label):
    """The CTR distillation loss: the label codes a click and an optional
    teacher score z' (< -1: no z', no click; [-1, 0): no z', click;
    [0, 1): z' = label, no click; >= 1: z' = label - 1, click)."""
    x, lbl = X, Label
    soft = torch.log1p(torch.exp(-torch.abs(x)))
    relu = torch.clamp(x, min=0.0)
    sce = relu + soft
    sce1 = sce - x
    t_clk0 = sce + relu - x * lbl + soft
    t_clk1 = sce1 + relu - x * (lbl - 1.0) + soft
    return torch.where(lbl < -1.0, sce,
                       torch.where(lbl < 0.0, sce1,
                                   torch.where(lbl < 1.0, t_clk0, t_clk1)))


def _counts(ids, n, device, weight=None):
    """How often each of 0..n-1 occurs in ``ids`` (negatives count as 0
    and ids >= n are dropped, as ``jnp.bincount(length=n)``)."""
    ids = torch.clamp(ids, min=0)
    keep = ids < n
    w = keep.to(torch.float32) if weight is None \
        else torch.where(keep, weight, torch.zeros_like(weight))
    return torch.zeros((n,), dtype=torch.float32, device=device).index_add_(
        0, torch.clamp(ids, max=n - 1), w)


@register_op("mean_iou", inputs=["Predictions", "Labels"],
             outputs=["OutMeanIou", "OutWrong", "OutCorrect"], no_grad=True)
def mean_iou(ctx, attrs, Predictions, Labels):
    """Mean over the classes present of ``correct / (predicted + labelled
    - correct)``; also each class's wrong and correct counts."""
    n = int(attrs["num_classes"])
    pred = Predictions.reshape(-1).long()
    lab = Labels.reshape(-1).long()
    dev = pred.device
    pred_cnt = _counts(pred, n, dev)
    lab_cnt = _counts(lab, n, dev)
    correct = _counts(pred, n, dev, (pred == lab).to(torch.float32))
    union = pred_cnt + lab_cnt - correct
    present = union > 0
    iou = torch.where(present, correct / torch.clamp(union, min=1.0),
                      torch.zeros_like(union))
    denom = torch.clamp(present.to(torch.float32).sum(), min=1.0)
    wrong = (pred_cnt + lab_cnt - 2.0 * correct).to(torch.int32)
    return {"OutMeanIou": iou.sum() / denom, "OutWrong": wrong,
            "OutCorrect": correct.to(torch.int32)}


@register_op("bilinear_tensor_product", inputs=["X", "Y", "Weight", "Bias"],
             outputs=["Out"])
def bilinear_tensor_product(ctx, attrs, X, Y, Weight, Bias):
    """``out[b, k] = x[b] W[k] y[b]^T (+ bias)``
    (``bilinear_tensor_product_op.h``); W is [K, dx, dy]."""
    out = torch.einsum("bi,kij,bj->bk", X, Weight, Y)
    if Bias is not None:
        out = out + Bias.reshape(1, -1)
    return out
