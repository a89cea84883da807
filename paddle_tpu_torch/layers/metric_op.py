"""In-graph metric layers (mirrors ``paddle_tpu/layers/metric_op.py``:
``accuracy`` :9).  ``auc`` is not ported yet (ROADMAP.md)."""

from ..layer_helper import LayerHelper

__all__ = ["accuracy"]


def accuracy(input, label, k=1, correct=None, total=None):
    """top_k of ``input``, then the share of rows whose label is among
    the k (``Accuracy``, with the ``Correct`` and ``Total`` counts)."""
    helper = LayerHelper("accuracy", **locals())
    topk_out = helper.create_variable_for_type_inference(input.dtype)
    topk_indices = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [topk_out], "Indices": [topk_indices]},
                     attrs={"k": k})
    acc_out = helper.create_variable_for_type_inference("float32", True)
    if correct is None:
        correct = helper.create_variable_for_type_inference("int64", True)
    if total is None:
        total = helper.create_variable_for_type_inference("int64", True)
    helper.append_op(
        type="accuracy",
        inputs={"Out": [topk_out], "Indices": [topk_indices],
                "Label": [label]},
        outputs={"Accuracy": [acc_out], "Correct": [correct],
                 "Total": [total]})
    return acc_out
