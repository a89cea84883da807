"""In-graph metric layers (mirrors ``paddle_tpu/layers/metric_op.py``:
``accuracy`` :9, ``auc`` :34)."""

from ..layer_helper import LayerHelper

__all__ = ["accuracy", "auc"]


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


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """Streaming AUC: returns ``(global_auc, batch_auc, [batch_stat_pos,
    batch_stat_neg, stat_pos, stat_neg])``.  The int64 statistics are
    persistable accumulators that each ``auc`` op reads and writes back
    to the same var (``StatPos`` in, ``StatPosOut`` out)."""
    from ..initializer import ConstantInitializer

    helper = LayerHelper("auc", **locals())
    auc_out = helper.create_variable_for_type_inference("float32", True)
    batch_auc_out = helper.create_variable_for_type_inference("float32", True)
    slide = max(int(slide_steps), 1)
    batch_stat_pos = helper.create_global_variable(
        persistable=True, dtype="int64", shape=[slide, num_thresholds + 1])
    batch_stat_neg = helper.create_global_variable(
        persistable=True, dtype="int64", shape=[slide, num_thresholds + 1])
    stat_pos = helper.create_global_variable(
        persistable=True, dtype="int64", shape=[1, num_thresholds + 1])
    stat_neg = helper.create_global_variable(
        persistable=True, dtype="int64", shape=[1, num_thresholds + 1])
    for var in [batch_stat_pos, batch_stat_neg, stat_pos, stat_neg]:
        helper.set_variable_initializer(var, ConstantInitializer(0.0))
    helper.append_op(
        type="auc",
        inputs={"Predict": [input], "Label": [label],
                "StatPos": [batch_stat_pos], "StatNeg": [batch_stat_neg]},
        attrs={"curve": curve, "num_thresholds": num_thresholds,
               "slide_steps": int(slide_steps)},
        outputs={"AUC": [batch_auc_out], "StatPosOut": [batch_stat_pos],
                 "StatNegOut": [batch_stat_neg]})
    helper.append_op(
        type="auc",
        inputs={"Predict": [input], "Label": [label],
                "StatPos": [stat_pos], "StatNeg": [stat_neg]},
        attrs={"curve": curve, "num_thresholds": num_thresholds,
               "slide_steps": 0},
        outputs={"AUC": [auc_out], "StatPosOut": [stat_pos],
                 "StatNegOut": [stat_neg]})
    return (auc_out, batch_auc_out,
            [batch_stat_pos, batch_stat_neg, stat_pos, stat_neg])
