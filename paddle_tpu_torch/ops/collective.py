"""Collective ops of data-parallel training (mirrors
``paddle_tpu/ops/collective.py``: ``c_allreduce_sum``,
``c_fused_allreduce_sum``, ``c_allreduce_quant``, ``c_gen_nccl_id``,
``c_comm_init``).

The reference runs these under ``shard_map`` over a named mesh axis
(``ctx.collective_axis``) and as the identity under plain jit, where
GSPMD already reduced the values.  Here a ring is a
``torch.distributed`` process group: the startup program's
``c_comm_init`` binds ring ``ring_id`` to the caller's initialised
default group in ``ctx.rings`` (the executor keeps the table on the
scope), and every collective op of that ring exchanges over it.  A ring
with no group, a program whose startup never ran ``c_comm_init``, is
the identity, as the reference's GSPMD path is (:134-135), ``pre_scale``
skipped with it.  ``c_comm_init`` raises when no default group is
initialised or when the group's world size or rank differs from the
op's ``nranks`` / ``rank``, so a misbound process never trains alone.

Averaging rides on the collective as ``pre_scale`` (1/nranks), applied
to the flat bucket in its own dtype before the exchange.  The dense ops
sum with ``all_reduce``; ``c_allreduce_quant`` runs
:func:`paddle_tpu_torch.quant.quantized_allreduce` on the K7 kernels.
Every op here talks to other processes (and a gloo payload crosses
host memory), so none is capturable in a CUDA graph: a transpiled
program runs eagerly.  Not ported (ROADMAP.md, Queue A 7):
``hier_groups``, the ``c_allreduce_start`` / ``c_allreduce_wait`` pair
and the other collectives.
"""

import logging

import torch

from . import comm
from .common import flatten_concat, split_like
from .registry import register_op

_log = logging.getLogger(__name__)


def _group(ctx, attrs):
    if attrs.get("hier_groups"):
        raise NotImplementedError(
            "collective hier_groups=%r: hierarchical allreduce is not "
            "ported yet (ROADMAP.md, Queue A item 7: data parallel)"
            % attrs["hier_groups"])
    return ctx.rings.get(int(attrs.get("ring_id", 0)))


def _pre_scale(x, attrs):
    s = attrs.get("pre_scale")
    if s:
        x = x * torch.tensor(s, dtype=x.dtype, device=x.device)
    return x


@register_op("c_allreduce_sum", inputs=["X"], outputs=["Out"],
             no_grad=True, capturable=False)
def c_allreduce_sum(ctx, attrs, X):
    group = _group(ctx, attrs)
    if group is None:
        return X
    return comm.all_reduce_sum(_pre_scale(X, attrs), group)


@register_op("c_fused_allreduce_sum", inputs=["X*"], outputs=["Out*"],
             no_grad=True, capturable=False)
def c_fused_allreduce_sum(ctx, attrs, X):
    """A bucket of same-(ring, dtype) grads flattened into one buffer,
    one allreduce, split back: elementwise the same sums as one
    ``c_allreduce_sum`` per member."""
    group = _group(ctx, attrs)
    if group is None:
        return {"Out": list(X)}
    flat = comm.all_reduce_sum(_pre_scale(flatten_concat(X), attrs), group)
    return {"Out": split_like(flat, X, cast=False)}


@register_op("c_allreduce_quant", inputs=["X*"], outputs=["Out*"],
             no_grad=True, capturable=False)
def c_allreduce_quant(ctx, attrs, X):
    """The bucket as ``c_fused_allreduce_sum`` flattens it, exchanged in
    int8 blocks (:func:`~paddle_tpu_torch.quant.quantized_allreduce`):
    two K7 quantize and two K7 dequantize launches per bucket."""
    from ..quant.collective import quantized_allreduce

    group = _group(ctx, attrs)
    if group is None:
        return {"Out": list(X)}
    flat = _pre_scale(flatten_concat(X), attrs)
    flat = quantized_allreduce(flat, group,
                               block=attrs.get("quant_block") or None)
    return {"Out": split_like(flat, X, cast=False)}


@register_op("c_gen_nccl_id", inputs=[], outputs=["Out"], no_grad=True,
             capturable=False)
def c_gen_nccl_id(ctx, attrs):
    # the group's rendezvous is the caller's init_process_group
    return torch.zeros((1,), dtype=torch.int32, device=ctx.device)


@register_op("c_comm_init", inputs=["X"], outputs=[], no_grad=True,
             capturable=False)
def c_comm_init(ctx, attrs, X):
    """Bind ring ``ring_id`` to the default process group, after checking
    that it is the group the program was transpiled for."""
    if ctx.mode == "infer":
        return {}
    import torch.distributed as dist

    ring = int(attrs.get("ring_id", 0))
    nranks, rank = int(attrs.get("nranks", 1)), int(attrs.get("rank", 0))
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "c_comm_init (ring %d, rank %d of %d): no torch.distributed "
            "process group is initialised; call "
            "torch.distributed.init_process_group(backend, init_method, "
            "world_size=%d, rank=%d) before running the startup program"
            % (ring, rank, nranks, nranks, rank))
    group = dist.group.WORLD
    world, me = dist.get_world_size(group), dist.get_rank(group)
    if (world, me) != (nranks, rank):
        raise RuntimeError(
            "c_comm_init (ring %d): the program was transpiled for rank %d "
            "of %d, but the default process group is rank %d of %d"
            % (ring, rank, nranks, me, world))
    if ctx.device.type == "cuda" and dist.get_backend(group) == "gloo":
        _log.info("ring %d: gloo group on %s; collective payloads are "
                  "staged through pinned host memory", ring, ctx.device)
    ctx.rings[ring] = group
    return {}
