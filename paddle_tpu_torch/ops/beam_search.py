"""Beam search ops on dense beams (mirrors ``paddle_tpu/ops/beam_search.py``:
``beam_search`` :36 and ``beam_search_decode`` :92).

Beams are a dense [B, K] layout (batch × beam), not LoD offsets: a step
is one choice of the K best of the [B, K·V] candidates, on the device.
As in the reference, a beam that has emitted ``end_id`` keeps exactly
one candidate, ``end_id`` again at its unchanged score, and the first
step starts from ``pre_scores = [0, -1e9, ...]`` per row, so the K
identical start beams collapse onto beam 0.  The parent of each chosen
beam is returned explicitly (``parent_idx``), and ``beam_search_decode``
walks the parents back from the last step.

Ties: ``jax.lax.top_k`` puts the lower index first among equal values,
and ``torch.topk`` promises no order among them on CUDA; the K best are
taken from a stable descending sort instead, which keeps equal values in
index order.  The ids are int32, as the reference's."""

import torch

from .registry import register_op

NEG_INF = -1e9


def top_k_lower_index_first(x, k):
    """The ``k`` largest of each row of ``x`` and their indices, equal
    values in index order (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@register_op("beam_search", inputs=["pre_ids", "pre_scores", "ids", "scores"],
             outputs=["selected_ids", "selected_scores", "parent_idx"],
             no_grad=True)
def beam_search(ctx, attrs, pre_ids, pre_scores, ids, scores):
    """One expansion step.  pre_ids [B, K]: each beam's last token
    (``end_id``: finished); pre_scores [B, K]: each beam's total;
    scores [B, K, V]: this step's log-probs (added to pre_scores when
    ``is_accumulated`` is False) or totals; ids: an optional [B, K, V]
    table of the candidates' tokens (default 0..V-1) →
    selected_ids, selected_scores, parent_idx, each [B, beam_size]."""
    beam_size = int(attrs["beam_size"])
    end_id = int(attrs["end_id"])
    batch, k, v = scores.shape
    pre_ids = pre_ids.reshape(batch, k)
    pre_scores = pre_scores.reshape(batch, k).to(scores.dtype)
    cand = scores if attrs.get("is_accumulated", True) \
        else pre_scores[:, :, None] + scores
    finished = pre_ids == end_id
    # a finished beam: only its end_id column stays, at its frozen score
    vocab = torch.arange(v, device=scores.device)[None, None, :]
    frozen = torch.where(vocab == end_id, pre_scores[:, :, None],
                         torch.full((), NEG_INF, dtype=scores.dtype,
                                    device=scores.device))
    cand = torch.where(finished[:, :, None], frozen, cand)
    top_scores, top_idx = top_k_lower_index_first(
        cand.reshape(batch, k * v), beam_size)
    parent = torch.div(top_idx, v, rounding_mode="floor")
    token = top_idx - parent * v
    if ids is not None:
        token = ids.reshape(batch, k * v).long().gather(1, top_idx)
        # a choice from a finished beam is its frozen end candidate: it
        # emits end_id, not the table's entry, and stays finished
        token = torch.where(finished.gather(1, parent),
                            torch.full_like(token, end_id), token)
    return token.to(torch.int32), top_scores, parent.to(torch.int32)


@register_op("beam_search_decode", inputs=["Ids", "Scores", "ParentIdx"],
             outputs=["SentenceIds", "SentenceScores"], no_grad=True)
def beam_search_decode(ctx, attrs, Ids, Scores, ParentIdx):
    """The sentences of the final beams, walked back through the parents
    (``beam_search_decode_op.cc``).  Ids / Scores / ParentIdx: tensor
    arrays written once a step, buffers [T, B, K] →
    SentenceIds [B, K, T] (the positions after a sentence's first
    ``end_id``, and the steps never written, hold ``end_id``) and
    SentenceScores [B, K] (each final beam's total).  The number of
    steps written stays on the device."""
    end_id = int(attrs["end_id"])
    ids_buf, parents_buf = Ids.buffer, ParentIdx.buffer
    length = Ids.length
    steps, batch, k = ids_buf.shape
    cur = torch.arange(k, device=ids_buf.device).expand(batch, k)
    end = torch.full((batch, k), end_id, dtype=torch.long,
                     device=ids_buf.device)
    toks = []
    for t in range(steps - 1, -1, -1):
        valid = length > t
        tok = ids_buf[t].long().gather(1, cur)
        par = parents_buf[t].long().gather(1, cur)
        toks.append(torch.where(valid, tok, end))
        cur = torch.where(valid, par, cur)
    sent = torch.stack(toks[::-1], dim=-1)  # [B, K, T]
    last = (length.long() - 1).clamp(0, steps - 1).reshape(1)
    final_scores = Scores.buffer.index_select(0, last)[0]
    is_end = (sent == end_id).to(torch.int32)
    after_end = torch.cumsum(is_end, dim=-1) - is_end > 0
    sent = torch.where(after_end, torch.full_like(sent, end_id), sent)
    return sent.to(torch.int32), final_scores
