"""Recurrent ops (mirrors ``paddle_tpu/ops/rnn.py``; so far ``gru_unit``
:192, the one step the dygraph ``GRUUnit`` dispatches).  The whole-sequence
``lstm`` / ``gru`` / ``dynamic_lstmp`` ops are ROADMAP.md Queue A item 9."""

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
