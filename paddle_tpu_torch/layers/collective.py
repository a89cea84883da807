"""Program-level collective layers (mirrors
``paddle_tpu/layers/collective.py``: ``_allreduce``, ``_broadcast``,
``_c_allgather``, ``_c_reducescatter``; the reference Fluid's
``python/paddle/fluid/layers/collective.py``).

Each appends one collective op of ring 0 (or ``ring_id``); the op
exchanges over the ring's ``torch.distributed`` group when one is bound
and is the identity otherwise (``ops/collective.py``)."""

from ..layer_helper import LayerHelper

__all__ = ["_allreduce", "_broadcast", "_c_allgather", "_c_reducescatter"]


def _allreduce(x, out=None, reduce_type="sum", sync_mode=False):
    helper = LayerHelper("allreduce", **locals())
    if out is None:
        out = x
    helper.append_op(
        type="c_allreduce_" + reduce_type,
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"ring_id": 0, "use_calc_stream": not sync_mode},
    )
    return out


def _broadcast(x, root, sync_mode=False):
    helper = LayerHelper("broadcast", **locals())
    helper.append_op(
        type="c_broadcast",
        inputs={"X": [x]},
        outputs={"Out": [x]},
        attrs={"root": root, "ring_id": 0, "use_calc_stream": not sync_mode},
    )
    return x


def _c_allgather(x, nranks, ring_id=0, use_calc_stream=False):
    helper = LayerHelper("c_allgather", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="c_allgather",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"nranks": nranks, "ring_id": ring_id,
               "use_calc_stream": use_calc_stream},
    )
    return out


def _c_reducescatter(x, nranks, ring_id=0, use_calc_stream=False):
    helper = LayerHelper("c_reducescatter", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="c_reducescatter",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"nranks": nranks, "ring_id": ring_id,
               "use_calc_stream": use_calc_stream},
    )
    return out
