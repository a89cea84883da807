"""Recurrent ops (mirrors ``paddle_tpu/ops/rnn.py``: ``lstm`` :40,
``dynamic_lstm`` :116, ``gru`` :125, ``dynamic_gru`` :173, ``lstm_unit``
:178 and ``gru_unit`` :192; ``dynamic_lstmp`` and the fused variants are
ROADMAP.md Queue A item 9).

A sequence is a padded [B, T, ...] batch with an optional ``SeqLen``
[B]; a row at ``t >= length`` keeps its previous state.  The recurrence
is a loop over the T steps in plain torch ops that follows the
reference's lowering formula for formula (its ``lax.scan`` step), so it
computes the reference's function: the GRU applies its reset gate to
``h`` before the candidate's product (cuDNN's GRU applies it after),
and the LSTM's gates are in the order i, f, c, o with the peepholes in
a [1, 7D] bias.  The reference has no Pallas kernel for them; their
gradients come from the generic grad path, autograd through the loop."""

import torch

from .registry import register_op

_ACT = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
}
# the reference op's integer activation codes
_ACT_CODES = {0: "identity", 1: "sigmoid", 2: "tanh", 3: "relu"}


def _act(attrs, key, default_code, default_name):
    a = attrs.get(key, default_code)
    if isinstance(a, int):
        return _ACT[_ACT_CODES.get(a, default_name)]
    return _ACT[a]


def _time_major(Input, SeqLen, is_reverse):
    """``Input`` [B, T, ...] as [T, B, ...], and the [T, B] mask ``t <
    length`` (None without ``SeqLen``), both reversed in time with
    ``is_reverse``."""
    x = Input.movedim(1, 0)
    mask = None
    if SeqLen is not None:
        mask = torch.arange(x.shape[0], device=x.device)[:, None] \
            < SeqLen.reshape(-1)[None, :]
    if is_reverse:
        x = x.flip(0)
        mask = None if mask is None else mask.flip(0)
    return x, mask


def _batch_major(steps, is_reverse):
    out = torch.stack(steps)
    return (out.flip(0) if is_reverse else out).movedim(0, 1)


@register_op("lstm", inputs=["Input", "H0", "C0", "Weight", "Bias", "SeqLen"],
             outputs=["Hidden", "Cell"])
def lstm(ctx, attrs, Input, H0, C0, Weight, Bias, SeqLen):
    """Input [B, T, 4D], the gates' input projection (the fc outside the
    op, as in the reference); Weight [D, 4D], the recurrent weights; Bias
    [1, 4D], or [1, 7D] with ``use_peepholes``: the trailing 3D are
    [W_ic, W_fc, W_oc], c_prev feeding the i and f gates and the new cell
    the o gate, before their activations.  Gate order i, f, c, o."""
    d = Input.shape[2] // 4
    gate_act = _ACT[attrs.get("gate_activation", "sigmoid")]
    cell_act = _ACT[attrs.get("cell_activation", "tanh")]
    cand_act = _ACT[attrs.get("candidate_activation", "tanh")]
    is_reverse = attrs.get("is_reverse", False)
    peep = bool(attrs.get("use_peepholes", False))
    if peep and (Bias is None or Bias.numel() < 7 * d):
        raise ValueError(
            "lstm with use_peepholes=True needs a [1, 7*hidden] Bias "
            "([b_i b_f b_c b_o, W_ic, W_fc, W_oc]); got %r"
            % (None if Bias is None else tuple(Bias.shape),))
    if Bias is not None:
        flat = Bias.reshape(-1)
        bias = flat[:4 * d].reshape(1, -1)
        if peep:
            w_ic, w_fc, w_oc = (flat[k * d:(k + 1) * d].reshape(1, -1)
                                for k in (4, 5, 6))
    batch = Input.shape[0]
    h = H0 if H0 is not None else Input.new_zeros((batch, d))
    c = C0 if C0 is not None else Input.new_zeros((batch, d))
    x, mask = _time_major(Input, SeqLen, is_reverse)
    hs, cs = [], []
    for t in range(x.shape[0]):
        gates = x[t] + h @ Weight
        if Bias is not None:
            gates = gates + bias
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        if peep:
            i = i + c * w_ic
            f = f + c * w_fc
        i, f = gate_act(i), gate_act(f)
        c_new = f * c + i * cand_act(g)
        if peep:
            o = o + c_new * w_oc
        h_new = gate_act(o) * cell_act(c_new)
        if mask is not None:
            keep = mask[t][:, None]
            h_new = torch.where(keep, h_new, h)
            c_new = torch.where(keep, c_new, c)
        h, c = h_new, c_new
        hs.append(h)
        cs.append(c)
    return {"Hidden": _batch_major(hs, is_reverse),
            "Cell": _batch_major(cs, is_reverse)}


@register_op("dynamic_lstm",
             inputs=["Input", "H0", "C0", "Weight", "Bias", "SeqLen"],
             outputs=["Hidden", "Cell"])
def dynamic_lstm(ctx, attrs, Input, H0, C0, Weight, Bias, SeqLen):
    return lstm(ctx, attrs, Input, H0, C0, Weight, Bias, SeqLen)


@register_op("gru", inputs=["Input", "H0", "Weight", "Bias", "SeqLen"],
             outputs=["Hidden"])
def gru(ctx, attrs, Input, H0, Weight, Bias, SeqLen):
    """Input [B, T, 3D], the input projection; Weight [D, 3D], the first
    2D columns the update and reset gates, the last D the candidate
    (``gru_op.cc``'s layout); ``c = act(x_c + (r * h) W_c)``,
    ``h = u h + (1 - u) c``."""
    d = Input.shape[2] // 3
    gate_act = _ACT[attrs.get("gate_activation", "sigmoid")]
    cand_act = _ACT[attrs.get("activation", "tanh")]
    is_reverse = attrs.get("is_reverse", False)
    h = H0 if H0 is not None else Input.new_zeros((Input.shape[0], d))
    x, mask = _time_major(Input, SeqLen, is_reverse)
    w_gate, w_cand = Weight[:, :2 * d], Weight[:, 2 * d:]
    hs = []
    for t in range(x.shape[0]):
        xt = x[t] if Bias is None else x[t] + Bias.reshape(1, -1)
        u, r = torch.chunk(gate_act(xt[:, :2 * d] + h @ w_gate), 2, dim=-1)
        c = cand_act(xt[:, 2 * d:] + (r * h) @ w_cand)
        h_new = u * h + (1.0 - u) * c
        if mask is not None:
            h_new = torch.where(mask[t][:, None], h_new, h)
        h = h_new
        hs.append(h)
    return {"Hidden": _batch_major(hs, is_reverse)}


@register_op("dynamic_gru", inputs=["Input", "H0", "Weight", "Bias", "SeqLen"],
             outputs=["Hidden"])
def dynamic_gru(ctx, attrs, Input, H0, Weight, Bias, SeqLen):
    return gru(ctx, attrs, Input, H0, Weight, Bias, SeqLen)


@register_op("lstm_unit", inputs=["X", "C_prev"], outputs=["C", "H"])
def lstm_unit(ctx, attrs, X, C_prev):
    """One LSTM step on the projected gates (``lstm_unit_op.h``): X [B, 4D]
    in the order i, f, o, g; ``c = sigm(f + forget_bias) c_prev +
    sigm(i) tanh(g)``, ``h = sigm(o) tanh(c)``."""
    fb = float(attrs.get("forget_bias", 0.0))
    d = C_prev.shape[-1]
    i = torch.sigmoid(X[:, :d])
    f = torch.sigmoid(X[:, d:2 * d] + fb)
    o = torch.sigmoid(X[:, 2 * d:3 * d])
    g = torch.tanh(X[:, 3 * d:])
    c = f * C_prev + i * g
    return {"C": c, "H": o * torch.tanh(c)}


@register_op("gru_unit", inputs=["Input", "HiddenPrev", "Weight", "Bias"],
             outputs=["Gate", "ResetHiddenPrev", "Hidden"],
             stateful_outputs=("Gate", "ResetHiddenPrev"))
def gru_unit(ctx, attrs, Input, HiddenPrev, Weight, Bias):
    """One GRU cell step (``gru_unit_op.h``): Input [B, 3D] pre-projected;
    Weight [D, 3D], the first 2D columns update and reset, the last D the
    candidate; ``h = u c + (1 - u) h_prev`` (``origin_mode`` flips the
    mix)."""
    d = HiddenPrev.shape[-1]
    g = Input if Bias is None else Input + Bias.reshape(1, -1)
    gate_act = _act(attrs, "gate_activation", 1, "sigmoid")
    cand_act = _act(attrs, "activation", 2, "tanh")
    ur = gate_act(g[:, :2 * d] + HiddenPrev @ Weight[:, :2 * d])
    u, r = ur[:, :d], ur[:, d:]
    rhp = r * HiddenPrev
    c = cand_act(g[:, 2 * d:] + rhp @ Weight[:, 2 * d:])
    if attrs.get("origin_mode", False):
        h = c + u * (HiddenPrev - c)
    else:
        h = u * c + (1.0 - u) * HiddenPrev
    return {"Gate": torch.cat([u, r, c], dim=1).detach(),
            "ResetHiddenPrev": rhp.detach(), "Hidden": h}
