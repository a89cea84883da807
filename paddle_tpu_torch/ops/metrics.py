"""In-graph metric ops (mirrors ``paddle_tpu/ops/metrics.py``, all of it:
``auc`` :21, ``precision_recall`` :100 with ``_metrics_from_states``
:79, ``positive_negative_pair`` :141).  The bucket statistics flow through the op (``StatPos`` in,
``StatPosOut`` out, the same var), as in the reference; histograms are
``index_add_`` on the device, so the op reads nothing on the host."""

import torch

from .registry import register_op


@register_op("auc", inputs=["Predict", "Label", "StatPos", "StatNeg"],
             outputs=["AUC", "StatPosOut", "StatNegOut"], no_grad=True)
def auc(ctx, attrs, Predict, Label, StatPos, StatNeg):
    """Streaming AUC (auc_op.h:27): Predict [N, 2] (column 1 read) or
    [N, 1], Label [N, 1] in {0, 1}; StatPos / StatNeg [1, T+1] bucket
    counts accumulated globally when ``slide_steps`` is 0, else a
    [slide_steps, T+1] window of per-step counts.  The area is the
    trapezoid sum over the buckets from the highest threshold down."""
    num_thresholds = int(attrs.get("num_thresholds", (2 ** 12) - 1))
    slide_steps = int(attrs.get("slide_steps", 1))
    nb = num_thresholds + 1
    pred = Predict[:, 1] if Predict.shape[1] > 1 else Predict[:, 0]
    lab = Label.reshape(-1).to(torch.bool)
    idx = torch.clamp((pred * num_thresholds).to(torch.int32), 0,
                      num_thresholds).long()
    w_pos = lab.to(StatPos.dtype)
    hist_pos = torch.zeros((nb,), dtype=StatPos.dtype,
                           device=Predict.device).index_add_(0, idx, w_pos)
    hist_neg = torch.zeros((nb,), dtype=StatNeg.dtype,
                           device=Predict.device).index_add_(0, idx,
                                                             1 - w_pos)
    if slide_steps == 0:
        pos_out = StatPos + hist_pos[None, :]
        neg_out = StatNeg + hist_neg[None, :]
        stat_pos, stat_neg = pos_out[0], neg_out[0]
    else:
        pos_out = torch.cat([StatPos[1:], hist_pos[None, :]], dim=0)
        neg_out = torch.cat([StatNeg[1:], hist_neg[None, :]], dim=0)
        stat_pos, stat_neg = pos_out.sum(dim=0), neg_out.sum(dim=0)
    pos_rev = stat_pos.flip(0).float()
    neg_rev = stat_neg.flip(0).float()
    tot_pos = torch.cumsum(pos_rev, 0)
    tot_neg = torch.cumsum(neg_rev, 0)
    area = (torch.abs(tot_neg - (tot_neg - neg_rev))
            * (tot_pos + (tot_pos - pos_rev)) / 2.0).sum()
    denom = tot_pos[-1] * tot_neg[-1]
    auc_val = torch.where(denom > 0, area / torch.clamp(denom, min=1.0),
                          torch.zeros_like(area))
    return auc_val.reshape(1), pos_out, neg_out


def _calc_precision(tp, fp):
    has = (tp > 0) | (fp > 0)
    return torch.where(has, tp / torch.clamp(tp + fp, min=1e-38),
                       torch.ones_like(tp))


def _calc_recall(tp, fn):
    has = (tp > 0) | (fn > 0)
    return torch.where(has, tp / torch.clamp(tp + fn, min=1e-38),
                       torch.ones_like(tp))


def _calc_f1(p, r):
    has = (p > 0) | (r > 0)
    return torch.where(has, 2 * p * r / torch.clamp(p + r, min=1e-38),
                       torch.zeros_like(p))


def _metrics_from_states(states):
    """[C, 4] (TP, FP, TN, FN) → [macro P, R, F1, micro P, R, F1]."""
    tp, fp, fn = states[:, 0], states[:, 1], states[:, 3]
    macro_p = _calc_precision(tp, fp).mean()
    macro_r = _calc_recall(tp, fn).mean()
    ttp, tfp, tfn = tp.sum(), fp.sum(), fn.sum()
    micro_p = _calc_precision(ttp, tfp)
    micro_r = _calc_recall(ttp, tfn)
    return torch.stack([macro_p, macro_r, _calc_f1(macro_p, macro_r),
                        micro_p, micro_r, _calc_f1(micro_p, micro_r)])


@register_op("precision_recall",
             inputs=["MaxProbs", "Indices", "Labels", "Weights",
                     "StatesInfo"],
             outputs=["BatchMetrics", "AccumMetrics", "AccumStatesInfo"],
             no_grad=True)
def precision_recall(ctx, attrs, MaxProbs, Indices, Labels, Weights,
                     StatesInfo):
    """Multi-class streaming precision and recall
    (``precision_recall_op.h``): the batch's per-class (TP, FP, TN, FN)
    weighted counts, added to the running ``StatesInfo`` [C, 4]; each
    set's macro and micro P, R, F1."""
    c = int(attrs["class_number"])
    ids = Indices.reshape(-1).long()
    labels = Labels.reshape(-1).long()
    w = Weights.reshape(-1).float() if Weights is not None \
        else torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
    classes = torch.arange(c, device=ids.device)
    onehot_id = (ids[:, None] == classes).float()
    onehot_lab = (labels[:, None] == classes).float()
    correct = ids == labels
    zero = torch.zeros_like(w)
    hit_w = torch.where(correct, w, zero)[:, None]
    miss_w = torch.where(correct, zero, w)[:, None]
    tp = (hit_w * onehot_id).sum(dim=0)
    fp = (miss_w * onehot_id).sum(dim=0)
    fn = (miss_w * onehot_lab).sum(dim=0)
    tn = w.sum() - tp - fp - fn
    batch = torch.stack([tp, fp, tn, fn], dim=1)
    accum = batch + StatesInfo.float() if StatesInfo is not None else batch
    return (_metrics_from_states(batch), _metrics_from_states(accum),
            accum)


@register_op("positive_negative_pair",
             inputs=["Score", "Label", "QueryID", "AccumulatePositivePair",
                     "AccumulateNegativePair", "AccumulateNeutralPair",
                     "Weight"],
             outputs=["PositivePair", "NegativePair", "NeutralPair"],
             no_grad=True)
def positive_negative_pair(ctx, attrs, Score, Label, QueryID,
                           AccumulatePositivePair=None,
                           AccumulateNegativePair=None,
                           AccumulateNeutralPair=None, Weight=None):
    """Ranking pairs within each query (``positive_negative_pair_op.cc``):
    a pair of differing labels is positive when the scores order it as
    the labels do, else negative, and also neutral on a score tie (the
    reference kernel counts a tie in both); a pair weighs the mean of
    its two weights.  One dense [B, B] pair matrix on the device."""
    col = int(attrs.get("column", 0))
    s = Score[:, col].float()
    lab = Label.reshape(-1).float()
    q = QueryID.reshape(-1)
    b = s.shape[0]
    w = Weight.reshape(-1).float() if Weight is not None \
        else torch.ones((b,), dtype=torch.float32, device=s.device)
    ar = torch.arange(b, device=s.device)
    pair = (q[:, None] == q[None, :]) & (ar[:, None] < ar[None, :]) \
        & (lab[:, None] != lab[None, :])
    pw = (w[:, None] + w[None, :]) * 0.5
    ds = s[:, None] - s[None, :]
    agree = ds * (lab[:, None] - lab[None, :]) > 0
    zero = torch.zeros_like(pw)
    pos = torch.where(pair & agree, pw, zero).sum()
    neg = torch.where(pair & ~agree, pw, zero).sum()
    neu = torch.where(pair & (ds == 0.0), pw, zero).sum()
    if AccumulatePositivePair is not None:
        pos = pos + AccumulatePositivePair.reshape(())
    if AccumulateNegativePair is not None:
        neg = neg + AccumulateNegativePair.reshape(())
    if AccumulateNeutralPair is not None:
        neu = neu + AccumulateNeutralPair.reshape(())
    return {"PositivePair": pos.reshape(1), "NegativePair": neg.reshape(1),
            "NeutralPair": neu.reshape(1)}
