"""Sequence layers over padded batches (mirrors
``paddle_tpu/layers/sequence.py``: ``sequence_mask`` :128,
``dynamic_lstm`` :160 and ``dynamic_gru`` :210; the other sequence
layers are ROADMAP.md Queue A item 9).  A sequence batch is a padded
[B, T, ...] tensor with an optional ``seq_len`` [B], the reference's
stand-in for LoD offsets; without it every row is full length."""

from ..layer_helper import LayerHelper

__all__ = ["sequence_mask", "dynamic_lstm", "dynamic_gru"]


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", **locals())
    out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op(
        type="sequence_mask", inputs={"X": [x]}, outputs={"Y": [out]},
        attrs={"maxlen": int(maxlen) if maxlen else -1, "out_dtype": dtype})
    return out


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None,
                 seq_len=None):
    """LSTM over a padded [B, T, 4*hidden] projected input; ``size`` is
    4 * hidden.  ``use_peepholes`` defaults to True, as in the
    reference: the bias is then [1, 7*hidden], its trailing 3*hidden the
    W_ic, W_fc, W_oc peephole weights."""
    assert size % 4 == 0
    hidden = size // 4
    if use_peepholes and bias_attr is False:
        raise ValueError(
            "dynamic_lstm(use_peepholes=True) — the reference default — "
            "stores the W_ic/W_fc/W_oc peephole weights in the bias; "
            "bias_attr must not be False (or pass use_peepholes=False)")
    helper = LayerHelper("dynamic_lstm", **locals())
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[hidden, 4 * hidden], dtype=dtype)
    bias = helper.create_parameter(
        attr=helper.bias_attr,
        shape=[1, 7 * hidden if use_peepholes else 4 * hidden],
        dtype=dtype, is_bias=True)
    hidden_out = helper.create_variable_for_type_inference(dtype)
    cell_out = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    if seq_len is not None:
        inputs["SeqLen"] = [seq_len]
    helper.append_op(
        type="dynamic_lstm", inputs=inputs,
        outputs={"Hidden": [hidden_out], "Cell": [cell_out]},
        attrs={"use_peepholes": bool(use_peepholes),
               "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation})
    return hidden_out, cell_out


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, name=None,
                seq_len=None):
    """GRU over a padded [B, T, 3*size] projected input."""
    helper = LayerHelper("dynamic_gru", **locals())
    dtype = input.dtype
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=[1, 3 * size], dtype=dtype,
        is_bias=True)
    hidden_out = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if seq_len is not None:
        inputs["SeqLen"] = [seq_len]
    helper.append_op(
        type="dynamic_gru", inputs=inputs, outputs={"Hidden": [hidden_out]},
        attrs={"is_reverse": is_reverse, "gate_activation": gate_activation,
               "activation": candidate_activation})
    return hidden_out
