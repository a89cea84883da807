"""In-graph metric ops (mirrors ``paddle_tpu/ops/metrics.py``: ``auc``
:21).  The bucket statistics flow through the op (``StatPos`` in,
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
