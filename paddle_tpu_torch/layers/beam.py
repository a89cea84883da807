"""Beam-search layers (mirrors ``paddle_tpu/layers/beam.py``:
``beam_search`` :11 and ``beam_search_decode`` :45), over the dense
[B, K] beams of ``ops/beam_search.py``."""

from ..layer_helper import LayerHelper

__all__ = ["beam_search", "beam_search_decode"]


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=False):
    """One expansion step over dense [B, K] beams; ``scores`` is
    [B, K, V] (``is_accumulated=False``: this step's log-probs, added to
    ``pre_scores``) → (selected_ids, selected_scores[, parent_idx]), each
    [B, K]."""
    helper = LayerHelper("beam_search", **locals())
    sel_ids = helper.create_variable_for_type_inference("int32")
    sel_scores = helper.create_variable_for_type_inference(scores.dtype)
    parent_idx = helper.create_variable_for_type_inference("int32")
    inputs = {"pre_ids": [pre_ids], "pre_scores": [pre_scores],
              "scores": [scores]}
    if ids is not None:
        inputs["ids"] = [ids]
    helper.append_op(
        type="beam_search", inputs=inputs,
        outputs={"selected_ids": [sel_ids],
                 "selected_scores": [sel_scores],
                 "parent_idx": [parent_idx]},
        attrs={"beam_size": int(beam_size), "end_id": int(end_id),
               "level": int(level), "is_accumulated": bool(is_accumulated)})
    for v in (sel_ids, sel_scores, parent_idx):
        v.stop_gradient = True
    if return_parent_idx:
        return sel_ids, sel_scores, parent_idx
    return sel_ids, sel_scores


def beam_search_decode(ids, scores, parent_idx, beam_size, end_id, name=None):
    """The sentences of the beams recorded in the tensor arrays ``ids``,
    ``scores`` and ``parent_idx`` (one write a step) → (sentence_ids
    [B, K, T], sentence_scores [B, K])."""
    helper = LayerHelper("beam_search_decode", **locals())
    sent_ids = helper.create_variable_for_type_inference("int32")
    sent_scores = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        type="beam_search_decode",
        inputs={"Ids": [ids], "Scores": [scores], "ParentIdx": [parent_idx]},
        outputs={"SentenceIds": [sent_ids], "SentenceScores": [sent_scores]},
        attrs={"beam_size": int(beam_size), "end_id": int(end_id)})
    sent_ids.stop_gradient = True
    sent_scores.stop_gradient = True
    return sent_ids, sent_scores
