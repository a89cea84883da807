"""Control-flow layers (mirrors ``paddle_tpu/layers/control_flow.py``):
only ``increment`` (:45) so far, which the decode programs use on a
``[1]`` counter.  ``While``, the comparisons and the tensor arrays come
with the decode loop (ROADMAP.md, Queue A item 5)."""

from ..layer_helper import LayerHelper

__all__ = ["increment"]


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment", **locals())
    out = x if in_place else \
        helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out
