"""Comparison ops and ``where`` (mirrors ``paddle_tpu/ops/compare.py``:
the six comparisons :10-24 with the fluid broadcast and no gradient,
``where`` :49).  The comparisons write ``bool`` tensors; the
learning-rate schedules build them on the step counter, so they stay on
the device."""

import torch

from .common import fluid_broadcast
from .registry import register_op


def _compare(name, fn):
    @register_op(name, inputs=["X", "Y"], outputs=["Out"], no_grad=True)
    def _op(ctx, attrs, X, Y, _fn=fn):
        x, y = fluid_broadcast(X, Y, attrs.get("axis", -1))
        return _fn(x, y)

    return _op


less_than = _compare("less_than", torch.lt)
less_equal = _compare("less_equal", torch.le)
greater_than = _compare("greater_than", torch.gt)
greater_equal = _compare("greater_equal", torch.ge)
equal = _compare("equal", torch.eq)
not_equal = _compare("not_equal", torch.ne)


@register_op("where", inputs=["Condition", "X", "Y"], outputs=["Out"])
def where(ctx, attrs, Condition, X, Y):
    return torch.where(Condition, X, Y)
