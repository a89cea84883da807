"""Collective ops (mirrors ``paddle_tpu/ops/collective.py``, all of it:
``c_allreduce_{sum,max,min,prod}``, ``allreduce``,
``c_fused_allreduce_sum``, ``c_allreduce_quant``, ``c_allreduce_start``
/ ``c_allreduce_wait``, ``c_hier_reducescatter`` / ``c_hier_allgather``,
``c_broadcast`` / ``broadcast``, ``c_allgather``, ``c_reducescatter``,
``c_sync_calc_stream`` / ``c_sync_comm_stream``, ``c_gen_nccl_id``,
``c_comm_init``, ``all_to_all``, ``ppermute``, ``send_v2`` /
``recv_v2``).

The reference runs these under ``shard_map`` over a named mesh axis
(``ctx.collective_axis``) and as the identity under plain jit, where
GSPMD already reduced the values.  Here a ring is a
``torch.distributed`` process group: the startup program's
``c_comm_init`` (or the data-parallel runner, ``parallel/__init__.py``)
binds ring ``ring_id`` to the caller's initialised default group in
``ctx.rings`` (the executor keeps the table on the scope), and every
collective op of that ring exchanges over it.  A ring with no group, a
program whose startup never ran ``c_comm_init``, is the identity, as the
reference's GSPMD path is (:134-135), ``pre_scale`` skipped with it.
``c_comm_init`` raises when no default group is initialised or when the
group's world size or rank differs from the op's ``nranks`` / ``rank``,
so a misbound process never trains alone.

Averaging rides on the collective as ``pre_scale`` (1/nranks), applied
to the flat bucket in its own dtype before the exchange.  The dense ops
sum with ``all_reduce``; ``c_allreduce_quant`` runs
:func:`paddle_tpu_torch.quant.quantized_allreduce` on the K7 kernels.

The overlap pair.  ``c_allreduce_start`` flattens and scales its bucket
as ``c_fused_allreduce_sum`` does and starts the sum with
``async_op=True`` (with ``attrs["quant"]``, the int8 exchange, which is
several collectives and runs to its end here); the handle waits in
``ctx.pending`` under the op's ``overlap_bucket`` until
``c_allreduce_wait`` of the same bucket takes it and splits the sum
back.  The pair computes the fused op's bits, so ``PADDLE_TPU_OVERLAP=0``
changes nothing but the schedule (the reference's :165-176).  The
executor waits out whatever a failed step left pending
(:func:`drain_pending`).

The hierarchy triple (rings 5 and 6 of ``static_analysis/hierarchy.py``)
runs over subgroups of ring 0's group: ``c_hier_reducescatter`` sums
within each slice of ``hier_chips`` consecutive ranks (``all_to_all`` of
the padded bucket's chunks, summed in ascending rank order), the cross
hop (``hier_groups="cross"``) sums each chunk across slices
(``all_gather`` in the group of ranks at one position, ascending slice
order, the reference's ``_cross_slice_sum``), and ``c_hier_allgather``
gathers the chunks back within the slice and splits the members.  The
subgroups come from ``dist.new_group``, made once per (group, slice
layout) on every rank in the same order.  With no group the triple is
the identity, as the reference's GSPMD path.

Every op here talks to other processes (and a gloo payload crosses
host memory), so none is capturable in a CUDA graph: a program with one
runs eagerly.  ``send_v2`` / ``recv_v2`` are the reference's structural
markers of a pipeline stage boundary (a no-op and a zero tensor of the
declared shape); ``all_to_all`` and ``ppermute`` keep the reference's
global-view infer function (``Out`` is ``X``'s shape and dtype).
"""

import logging

import torch
import torch.distributed as dist

from . import comm
from .common import flatten_concat, split_like
from .registry import register_op

_log = logging.getLogger(__name__)

# rings of the hierarchical decomposition (static_analysis/hierarchy.py)
# exchange over subgroups of the data-parallel ring's group
_HIER_RINGS = (5, 6)


def _group(ctx, attrs):
    ring = int(attrs.get("ring_id", 0) or 0)
    group = ctx.rings.get(ring)
    if group is None and ring in _HIER_RINGS:
        group = ctx.rings.get(0)
    return group


def _pre_scale(x, attrs):
    s = attrs.get("pre_scale")
    if s:
        x = x * torch.tensor(s, dtype=x.dtype, device=x.device)
    return x


_SUBGROUPS = {}


def _ranks(group):
    return dist.get_process_group_ranks(group)


def _hier_groups(group, chips):
    """``(this rank's slice group, its cross-slice group)`` for ``group``
    cut into slices of ``chips`` consecutive ranks, the reference's
    ``_slice_groups`` / ``_cross_groups`` (:25-43).  Every rank of
    ``group`` makes every subgroup, in the same order, once."""
    ranks = _ranks(group)
    n = len(ranks)
    c = max(min(int(chips), n), 1)
    key = (tuple(ranks), c)
    hit = _SUBGROUPS.get(key)
    if hit is None:
        s = n // c
        slices = [dist.new_group([ranks[si * c + i] for i in range(c)])
                  for si in range(s)]
        cross = [dist.new_group([ranks[i + si * c] for si in range(s)])
                 for i in range(c)]
        hit = _SUBGROUPS[key] = (slices, cross)
    me = ranks.index(dist.get_rank())
    return hit[0][me // c], hit[1][me % c]


def _cross_group(group, attrs):
    """The group of ranks at this rank's slice position across slices,
    for a cross hop of ``comm_nranks`` slices."""
    n = len(_ranks(group))
    s = int(attrs.get("comm_nranks") or attrs.get("hier_slices") or 1)
    s = max(min(s, n), 1)
    return _hier_groups(group, max(n // s, 1))[1]


def _cross_slice_sum(x, group, attrs):
    """The sum across slices: every slice's value gathered, then added
    in ascending slice order (the same bits on every member)."""
    g = comm.all_gather(x, _cross_group(group, attrs))
    acc = g[0]
    for si in range(1, g.shape[0]):
        acc = acc + g[si]
    return acc


def _allreduce(name, op):
    @register_op(name, inputs=["X"], outputs=["Out"], no_grad=True,
                 capturable=False)
    def _op(ctx, attrs, X, _op=op):
        group = _group(ctx, attrs)
        if group is None:
            return X
        X = _pre_scale(X, attrs)
        if attrs.get("hier_groups") == "cross":
            return _cross_slice_sum(X, group, attrs)
        if _op is None:
            return comm.all_reduce_sum(X, group)
        return comm.all_reduce(X, group, _op)

    return _op


c_allreduce_sum = _allreduce("c_allreduce_sum", None)
c_allreduce_max = _allreduce("c_allreduce_max", dist.ReduceOp.MAX)
c_allreduce_min = _allreduce("c_allreduce_min", dist.ReduceOp.MIN)
c_allreduce_prod = _allreduce("c_allreduce_prod", dist.ReduceOp.PRODUCT)
allreduce = _allreduce("allreduce", None)


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


def _quantized(flat, group, attrs):
    # through the module, so a probe that wraps quantized_allreduce sees
    # every bucket
    from ..quant import collective as _qc

    return _qc.quantized_allreduce(flat, group,
                                   block=attrs.get("quant_block") or None)


def _cross_slice_quant(flat, group, attrs):
    """The cross hop of a quantized bucket: int8 payload and scales
    gathered across slices, each dequantized and added in ascending
    slice order (the reference's :131-149)."""
    from ..quant.blockwise import block_dequantize, block_quantize

    q, scales = block_quantize(flat, block=attrs.get("quant_block") or None)
    cross = _cross_group(group, attrs)
    gq = comm.all_gather(q, cross)
    gs = comm.all_gather(scales, cross)
    acc = None
    for si in range(gq.shape[0]):
        d = block_dequantize(gq[si], gs[si], size=flat.numel(),
                             dtype=flat.dtype)
        acc = d if acc is None else acc + d
    return acc


@register_op("c_allreduce_quant", inputs=["X*"], outputs=["Out*"],
             no_grad=True, capturable=False)
def c_allreduce_quant(ctx, attrs, X):
    """The bucket as ``c_fused_allreduce_sum`` flattens it, exchanged in
    int8 blocks (:func:`~paddle_tpu_torch.quant.quantized_allreduce`):
    two K7 quantize and two K7 dequantize launches per bucket.  As the
    cross hop of a hierarchical decomposition, one quantize and a
    dequantize per slice."""
    group = _group(ctx, attrs)
    if group is None:
        return {"Out": list(X)}
    flat = _pre_scale(flatten_concat(X), attrs)
    if attrs.get("hier_groups") == "cross":
        flat = _cross_slice_quant(flat, group, attrs)
    else:
        flat = _quantized(flat, group, attrs)
    return {"Out": split_like(flat, X, cast=False)}


class _Done:
    """A quantized bucket's sum, computed when its start ran."""

    def __init__(self, value):
        self._value = value

    def wait(self):
        return self._value


def _pending(ctx):
    pending = getattr(ctx, "pending", None)
    if pending is None:
        pending = ctx.pending = {}
    return pending


def drain_pending(ctx):
    """Wait out every exchange a step started and did not wait for (a
    step that failed between a start and its wait), so no work is left
    in flight on the group."""
    pending = getattr(ctx, "pending", None) or {}
    while pending:
        _, handle = pending.popitem()
        try:
            handle.wait()
        except Exception:  # noqa: BLE001 - the step's own error wins
            _log.exception("a pending collective failed while draining")


@register_op("c_allreduce_start", inputs=["X*"], outputs=["Out*"],
             no_grad=True, capturable=False)
def c_allreduce_start(ctx, attrs, X):
    """The async half of a bucketed allreduce: flatten and scale as the
    fused op does, then start the exchange (dense) or run it (``quant``)
    and leave the handle under ``overlap_bucket`` for the wait."""
    group = _group(ctx, attrs)
    if group is None:
        return {"Out": list(X)}
    bucket = attrs.get("overlap_bucket")
    pending = _pending(ctx)
    if bucket in pending:
        raise RuntimeError(
            "c_allreduce_start: bucket %r is already in flight (a start "
            "without its wait)" % (bucket,))
    flat = _pre_scale(flatten_concat(X), attrs)
    if attrs.get("quant"):
        pending[bucket] = _Done(_quantized(flat, group, attrs))
    else:
        pending[bucket] = comm.all_reduce_start(flat, group)
    return {"Out": list(X)}


@register_op("c_allreduce_wait", inputs=["X*"], outputs=["Out*"],
             no_grad=True, capturable=False)
def c_allreduce_wait(ctx, attrs, X):
    """Wait for the bucket's exchange and split the sum back into its
    members; the identity when the ring has no group."""
    if _group(ctx, attrs) is None:
        return {"Out": list(X)}
    bucket = attrs.get("overlap_bucket")
    handle = _pending(ctx).pop(bucket, None)
    if handle is None:
        raise RuntimeError(
            "c_allreduce_wait: no c_allreduce_start of bucket %r ran "
            "before it in this step" % (bucket,))
    return {"Out": split_like(handle.wait(), X, cast=False)}


@register_op("c_hier_reducescatter", inputs=["X*"], outputs=["Out"],
             no_grad=True, capturable=False)
def c_hier_reducescatter(ctx, attrs, X):
    """Intra-slice half of a hierarchical allreduce: flatten the bucket,
    apply ``pre_scale``, pad to a multiple of ``hier_chips`` and sum
    within the slice, each rank keeping its chunk.  With no group: the
    padded flat buffer, unscaled (the net-identity triple)."""
    group = _group(ctx, attrs)
    flat = flatten_concat(X)
    c = int(attrs.get("hier_chips", 1))
    total = flat.numel()
    pad = -(-total // c) * c - total
    if group is None:
        return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat
    flat = _pre_scale(flat, attrs)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    slice_group = _hier_groups(group, c)[0]
    got = comm.all_to_all(flat.view(c, -1), slice_group)
    acc = got[0]
    for i in range(1, got.shape[0]):  # ascending rank order
        acc = acc + got[i]
    return acc


@register_op("c_hier_allgather", inputs=["X*"], outputs=["Out*"],
             no_grad=True, capturable=False)
def c_hier_allgather(ctx, attrs, X):
    """Intra-slice gather-back: the chunks of the slice gathered in rank
    order, the pad trimmed, the members split to ``member_shapes``."""
    group = _group(ctx, attrs)
    flat = X[0]
    if group is not None:
        c = int(attrs.get("hier_chips", 1))
        slice_group = _hier_groups(group, c)[0]
        flat = comm.all_gather(flat, slice_group).reshape(-1)
    total = int(attrs.get("hier_total", flat.numel()))
    if flat.numel() < total:
        # shape inference replays the op on the chunk's recorded shape:
        # pad so the splits type-check (every run arrives with >= total)
        flat = torch.cat([flat, flat.new_zeros(total - flat.numel())])
    flat = flat[:total]
    outs, off = [], 0
    for sh in attrs.get("member_shapes", ()):
        shape = tuple(int(d) for d in sh)
        k = 1
        for d in shape:
            k *= d
        outs.append(flat[off:off + k].reshape(shape))
        off += k
    return {"Out": outs}


@register_op("c_broadcast", inputs=["X"], outputs=["Out"], no_grad=True,
             capturable=False)
def c_broadcast(ctx, attrs, X):
    group = _group(ctx, attrs)
    if group is None:
        return X
    return comm.broadcast(X, group, int(attrs.get("root", 0)))


@register_op("broadcast", inputs=["X"], outputs=["Out"], no_grad=True,
             capturable=False)
def broadcast(ctx, attrs, X):
    return c_broadcast(ctx, attrs, X)


@register_op("c_allgather", inputs=["X"], outputs=["Out"], no_grad=True,
             capturable=False)
def c_allgather(ctx, attrs, X):
    """Every rank's ``X`` concatenated along dim 0 in rank order."""
    group = _group(ctx, attrs)
    if group is None:
        return X
    g = comm.all_gather(X, group)
    return g.reshape((-1,) + tuple(X.shape[1:]))


@register_op("c_reducescatter", inputs=["X"], outputs=["Out"],
             no_grad=True, capturable=False)
def c_reducescatter(ctx, attrs, X):
    """The group's sum of ``X``, each rank keeping its dim-0 chunk (the
    reference's tiled ``psum_scatter``), summed in ascending rank
    order."""
    group = _group(ctx, attrs)
    if group is None:
        return X
    n = dist.get_world_size(group)
    got = comm.all_to_all(X.reshape((n, -1) + tuple(X.shape[1:])), group)
    acc = got[0]
    for i in range(1, n):
        acc = acc + got[i]
    return acc


@register_op("c_sync_calc_stream", inputs=["X"], outputs=["Out"],
             no_grad=True)
def c_sync_calc_stream(ctx, attrs, X):
    return X  # the ops run in stream order


@register_op("c_sync_comm_stream", inputs=["X"], outputs=["Out"],
             no_grad=True)
def c_sync_comm_stream(ctx, attrs, X):
    return X


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


# ---------------------------------------------------------------------------
# reshard / p2p collectives (the reference's :333-413): in the IR these
# carry global shapes; with a group they run the real exchange
# ---------------------------------------------------------------------------

def _identity_infer(op, block):
    """Out shape/dtype = X shape/dtype (global-view reshard ops)."""
    src = block._find_var_recursive(op.inputs["X"][0])
    for n in op.outputs.get("Out", []):
        v = block._find_var_recursive(n)
        if v is not None and src is not None:
            v.shape = src.shape
            v.dtype = src.dtype


@register_op("all_to_all", inputs=["X"], outputs=["Out"], no_grad=True,
             infer_shape=_identity_infer, capturable=False)
def all_to_all(ctx, attrs, X):
    """``X`` split into n chunks along ``split_axis``, chunk p sent to
    rank p, the received chunks concatenated along ``concat_axis`` in
    rank order (``lax.all_to_all(..., tiled=True)``)."""
    group = _group(ctx, attrs)
    if group is None:
        return X
    n = dist.get_world_size(group)
    split = int(attrs.get("split_axis", 0)) % X.dim()
    concat = int(attrs.get("concat_axis", 0)) % X.dim()
    chunks = torch.stack(torch.chunk(X, n, dim=split))
    got = comm.all_to_all(chunks, group)
    return torch.cat(list(got.unbind(0)), dim=concat)


@register_op("ppermute", inputs=["X"], outputs=["Out"], no_grad=True,
             infer_shape=_identity_infer, capturable=False)
def ppermute(ctx, attrs, X):
    """Each rank's ``X`` sent along ``perm`` ((source, destination)
    pairs; default the ring i → i+1); a rank no pair reaches gets zeros,
    as ``lax.ppermute``."""
    group = _group(ctx, attrs)
    if group is None:
        return X
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    perm = [tuple(int(v) for v in p) for p in attrs.get("perm", [])] \
        or [(i, (i + 1) % n) for i in range(n)]
    g = comm.all_gather(X, group)
    for src, dst in perm:
        if dst == me:
            return g[src]
    return torch.zeros_like(X)


def _send_infer(op, block):
    pass  # no outputs


@register_op("send_v2", inputs=["X"], outputs=[], no_grad=True,
             infer_shape=_send_infer)
def send_v2(ctx, attrs, X):
    # the structural marker of a pipeline stage boundary, as the
    # reference's (its runnable pipeline is one program across stages)
    return {}


def _recv_infer(op, block):
    for n in op.outputs.get("Out", []):
        v = block._find_var_recursive(n)
        if v is not None:
            if op.attrs.get("out_shape") is not None:
                v.shape = tuple(op.attrs["out_shape"])
            if op.attrs.get("dtype") is not None:
                from ..core import convert_np_dtype_to_dtype_

                v.dtype = convert_np_dtype_to_dtype_(op.attrs["dtype"])


@register_op("recv_v2", inputs=[], outputs=["Out"], no_grad=True,
             infer_shape=_recv_infer)
def recv_v2(ctx, attrs, X=None):
    from ..core import torch_dtype

    shape = tuple(max(int(d), 1) for d in attrs.get("out_shape", (1,)))
    return torch.zeros(shape, dtype=torch_dtype(attrs.get("dtype",
                                                          "float32")),
                       device=ctx.device)
