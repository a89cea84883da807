"""Sub-block ops and tensor arrays (mirrors
``paddle_tpu/ops/control_flow.py``: ``SUB_BLOCK_OPS`` :22, the array
capacity :26-27, ``_carry_analysis`` :41, ``sub_block_external_reads``
:65, ``while`` :112-153, ``recompute_block`` :155-181,
``conditional_block`` :183-203, ``while_grad`` :232-346, ``recurrent``
(``_seq_lengths``, ``_make_step``, ``_run_recurrent``) :349-440,
``recurrent_grad`` :442-498, ``recompute_block_grad`` :500-537,
``conditional_block_grad`` :540-583, the array ops :588-621 and
:713-728, ``split_lod_tensor`` / ``merge_lod_tensor`` :623-648, the LoD
rank-table ops :650-711).

A sub-block op is not a registered lowering: the executor hands it, with
its block, to :func:`run_sub_block_op`, which runs the sub-block's ops
through the executor's own op loop (``run_block(sub_block, env,
replay)``; ``replay``: every in-place op writes a copy).

``while``.  The reference lowers the loop to one ``lax.while_loop``.
Here the trips are driven from the host, as the reference's C++
``while_op.cc`` drives them: the 1-element condition is read once
before each trip (a host read, so a sync on the card).  A trip runs the
body into an environment of its own; after the last trip the loop-carried
names (written in the body and read in it before the write, or alive
before the loop, and the condition) go back to the caller's environment,
the body's temporaries do not.  The executor may hand in a runner
(``ctx.loops``) that replays the body from a captured CUDA graph
(``executor._LoopBody``); without one, or inside another loop, or while
a grad op runs the loop again, every trip runs op by op.  The forward
records its trip count in ``ctx.trip_counts`` for the grad.

``while_grad`` starts from the pre-loop snapshots the ``While`` layer
took (``snapshot_vars`` / ``snapshot_pres``), runs the trips the forward
took again (at most ``max_trip_count`` when it is set, as the
reference's bounded scan) under ``torch.enable_grad()`` with every
in-place op writing a copy, and calls ``torch.autograd.grad`` once: the
gradients of the pre-loop values (``StateIn@GRAD``) and of the captured
outer vars, the parameters the body reads (``Captured@GRAD``).  No probe
pass is needed: the host loop knows its trip count.

``recompute_block`` runs its region on the ``Captured`` values in an
environment of its own, with no autograd graph, and puts back into the
caller's environment only the outputs in ``live`` (the names a later op
outside the region, the fetch list or the scope needs).  Its grad runs
the region again from the same values, as ``while_grad`` runs its trips:
the same ops with the same op ids in the same step, so each dropping op
draws the mask of its first run, and an in-place op writes a copy, so
the region's state is written once a step.

``recurrent`` (StaticRNN, and DynamicRNN with ``time_major=False`` and a
``sequence_length`` input) runs its step block once per time step of its
sequence inputs, a static count (the padded T: no host read), each step
in an environment of its own that starts from the caller's, with the
states and the step's slices bound.  DynamicRNN's mask ``t < length`` is
built on the device: a row at ``t >= length`` keeps its previous state
and its step outputs are zero.  The outputs are the step outputs stacked
along time.  ``recurrent_grad`` runs the T steps again under
``torch.enable_grad()`` and calls ``torch.autograd.grad`` once, with
respect to the sequence inputs, the initial states and the captured
outer vars (the parameters the step reads).  Nothing goes through the
host between steps, so a step holding a ``recurrent`` and its grad
captures whole in one CUDA graph.

``conditional_block`` reads its predicate on the host and runs the block
only when it is true; the branch not taken writes nothing.  Its grad
runs the taken branch again under autograd; an untaken branch gives zero
gradients, as the reference's ``lax.cond`` vjp.

A tensor array (the reference's LoDTensorArray) is a :class:`TensorArray`:
a fixed-capacity buffer ``[capacity, ...]`` (``ARRAY_CAPACITY_ATTR``,
default 128) and a device length.  ``write_to_array`` writes its row in
place, so a loop's array is written once a trip; rows past the last
write keep their zero fill."""

import torch

from .registry import EMPTY_VAR_NAME, register_op

__all__ = ["SUB_BLOCK_OPS", "ARRAY_CAPACITY_ATTR", "DEFAULT_ARRAY_CAPACITY",
           "TensorArray", "RankTable", "sub_block_external_reads",
           "while_carries", "run_sub_block_op", "host_true"]

SUB_BLOCK_OPS = ("while", "conditional_block", "recurrent",
                 "recurrent_grad", "conditional_block_grad", "while_grad",
                 "recompute_block", "recompute_block_grad")

ARRAY_CAPACITY_ATTR = "tensor_array_capacity"
DEFAULT_ARRAY_CAPACITY = 128


def _named(n):
    return bool(n) and n != EMPTY_VAR_NAME


def sub_block_external_reads(sub_block, exclude=()):
    """Names read by the sub-block before any write (closure captures)."""
    written = set(exclude)
    reads = []
    for op in sub_block.ops:
        for n in op.input_arg_names:
            if _named(n) and n not in written and n not in reads:
                reads.append(n)
        written.update(op.output_arg_names)
    return reads


def _block_carry_sets(sub_block):
    """(names written, in order of first write; names read before their
    first write)."""
    written_order, written, read_first = [], set(), set()
    for op in sub_block.ops:
        for n in op.input_arg_names:
            if _named(n) and n not in written:
                read_first.add(n)
        for n in op.output_arg_names:
            if _named(n) and n not in written:
                written.add(n)
                written_order.append(n)
    return written_order, read_first


def while_carries(sub_block, env, cond_name):
    """The loop-carried names of a ``while`` body run on ``env``: the
    names it writes that it reads before the write or that hold a value
    before the loop, then the condition (the reference's
    ``_carry_analysis``)."""
    written, read_first = _block_carry_sets(sub_block)
    carried = [n for n in written if n in read_first or n in env]
    if cond_name not in carried:
        carried.append(cond_name)
    return carried


def host_true(t):
    """The truth of a 1-element condition, read on the host."""
    return bool(t.reshape(()).item())


class TensorArray:
    """A tensor array: ``buffer`` ``[capacity, ...]`` and ``length``, a
    ``[]`` int32 tensor on the buffer's device.  ``clone`` and ``copy_``
    act on both, so the executor handles an array as it does a tensor."""

    __slots__ = ("buffer", "length")

    def __init__(self, buffer, length):
        self.buffer = buffer
        self.length = length

    @property
    def shape(self):
        return self.buffer.shape

    @property
    def dtype(self):
        return self.buffer.dtype

    @property
    def device(self):
        return self.buffer.device

    def clone(self):
        return TensorArray(self.buffer.clone(), self.length.clone())

    def copy_(self, other):
        self.buffer.copy_(other.buffer)
        self.length.copy_(other.length)
        return self

    def untyped_storage(self):
        return self.buffer.untyped_storage()

    def is_floating_point(self):
        return self.buffer.is_floating_point()


class RankTable:
    """A LoD rank table in its padded form: the [B] sequence ``lengths``
    and ``order``, the rows by descending length (ties by row)."""

    __slots__ = ("lengths", "order")

    def __init__(self, lengths, order):
        self.lengths = lengths
        self.order = order


def run_sub_block_op(op, block, env, ctx, run_block, live):
    """Run the sub-block op ``op`` of ``block`` on ``env``;
    ``run_block(sub_block, env, replay)`` runs a block's ops into an
    environment (``replay``: in-place ops write copies)."""
    sub_block = block.program.block(op.attrs["sub_block"])
    if op.type == "recompute_block":
        region = {n: env[n] for n in op.input("Captured") if _named(n)}
        run_block(sub_block, region, False)
        for n in op.output("Out"):
            if n in live and n in region:
                env[n] = region[n]
    elif op.type == "recompute_block_grad":
        _run_recompute_grad(op, sub_block, env, run_block)
    elif op.type == "while":
        _run_while(op, block, sub_block, env, ctx, run_block)
    elif op.type == "while_grad":
        _run_while_grad(op, sub_block, env, ctx, run_block)
    elif op.type == "conditional_block":
        _run_conditional(op, sub_block, env, run_block)
    elif op.type == "conditional_block_grad":
        _run_conditional_grad(op, sub_block, env, run_block)
    elif op.type == "recurrent":
        _run_recurrent(op, sub_block, env, run_block)
    elif op.type == "recurrent_grad":
        _run_recurrent_grad(op, sub_block, env, run_block)
    else:
        raise NotImplementedError("sub-block op %r" % op.type)


def _run_while(op, block, sub_block, env, ctx, run_block):
    cond_name = op.input("Condition")[0]
    carried = while_carries(sub_block, env, cond_name)
    missing = [n for n in carried if n not in env]
    if missing:
        raise RuntimeError("while op: loop-carried vars %s have no initial "
                           "value before the loop" % missing)
    body = dict(env)
    runner = ctx.loops
    nested = ctx.loop_depth > 0 or torch.is_grad_enabled()
    ctx.loop_depth += 1
    try:
        if runner is not None and not nested:
            record = runner.run(op, block, sub_block, body, carried,
                                cond_name, ctx, run_block)
        else:
            trips = reads = 0
            while True:
                reads += 1
                if not host_true(body[cond_name]):
                    break
                run_block(sub_block, body, False)
                trips += 1
            record = {"trips": trips, "cond_reads": reads,
                      "eager_trips": trips, "mode": "eager",
                      "reason": "inside another loop or a grad op"
                      if nested else "no loop runner: op by op"}
    finally:
        ctx.loop_depth -= 1
    for n in carried:
        env[n] = body[n]
    ctx.trip_counts[sub_block.idx] = record["trips"]
    if not nested:
        record["op"] = op.attrs.get("__op_id__")
        ctx.loop_runs.append(record)


def _leaf(v):
    return v.detach().requires_grad_()


def _zeros_like(v):
    return torch.zeros(v.shape, device=v.device,
                       dtype=v.dtype if v.is_floating_point()
                       else torch.float32)


def _grads(outs, cots, wrt):
    """``torch.autograd.grad`` of ``outs`` (cotangents ``cots``) with
    respect to the tensors of ``wrt`` (a dict), None where unused."""
    keys = list(wrt)
    grads = [None] * len(keys)
    if outs and keys:
        grads = torch.autograd.grad(outs, [wrt[k] for k in keys], cots,
                                    allow_unused=True)
    return dict(zip(keys, grads))


def _cotangents(op, region, env):
    """The op's outputs that ``region`` computed with a gradient path, and
    their gradients from ``env``."""
    outs, cots = [], []
    for n, g in zip(op.input("Out"), op.input("Out@GRAD")):
        y = region.get(n)
        if _named(g) and g in env and isinstance(y, torch.Tensor) \
                and y.requires_grad:
            outs.append(y)
            cots.append(env[g].to(y.dtype))
    return outs, cots


def _run_while_grad(op, sub_block, env, ctx, run_block):
    cond_name = op.input("Condition")[0]
    pre_of = dict(zip(op.attrs.get("snapshot_vars", []),
                      op.attrs.get("snapshot_pres", [])))
    written, read_first = _block_carry_sets(sub_block)
    carried = [n for n in written if n in read_first or n in pre_of]
    if cond_name not in carried:
        carried.append(cond_name)
    out_names = op.input("Out")
    state_grads = dict(zip(out_names, op.output("StateIn@GRAD")))
    cap, gcap = op.input("Captured"), op.output("Captured@GRAD")

    region, leaves, init = dict(env), {}, {}
    for n in carried:
        pre = pre_of.get(n)
        if pre is not None and pre in env:
            v = env[pre]
        elif n in env:
            v = env[n]  # no value before the loop: the body made it
        else:
            raise RuntimeError("while_grad: no pre-loop value for carried "
                               "var %r" % n)
        init[n] = v
        if _named(state_grads.get(n)) and isinstance(v, torch.Tensor) \
                and v.is_floating_point():
            v = leaves[("state", n)] = _leaf(v)
        region[n] = v
    for n, g in zip(cap, gcap):
        v = env[n]
        if _named(g) and isinstance(v, torch.Tensor) \
                and v.is_floating_point():
            region[n] = leaves[("cap", n)] = _leaf(v)

    limit = ctx.trip_counts.get(sub_block.idx)
    bound = int(op.attrs.get("max_trip_count") or 0)
    if bound:
        limit = bound if limit is None else min(limit, bound)
    trips = 0
    ctx.loop_depth += 1
    try:
        with torch.enable_grad():
            while (limit is None or trips < limit) \
                    and host_true(region[cond_name]):
                run_block(sub_block, region, True)
                trips += 1
    finally:
        ctx.loop_depth -= 1
    outs, cots = _cotangents(op, region, env)
    got = _grads(outs, cots, leaves)
    for n, g in state_grads.items():
        if _named(g) and n in init:
            grad = got.get(("state", n))
            env[g] = _zeros_like(init[n]) if grad is None else grad
    for n, g in zip(cap, gcap):
        if _named(g):
            grad = got.get(("cap", n))
            env[g] = _zeros_like(env[n]) if grad is None else grad


def _run_conditional(op, sub_block, env, run_block):
    if not host_true(env[op.input("Cond")[0]]):
        return  # the branch not taken writes nothing
    written, read_first = _block_carry_sets(sub_block)
    outs = [n for n in written if n in env] \
        or [n for n in written if n in read_first]
    branch = dict(env)
    run_block(sub_block, branch, False)
    for n in outs:
        env[n] = branch[n]


def _run_conditional_grad(op, sub_block, env, run_block):
    cap, gcap = op.input("Captured"), op.output("Captured@GRAD")
    leaves = {}
    if host_true(env[op.input("Cond")[0]]):
        region = dict(env)
        for n, g in zip(cap, gcap):
            v = env[n]
            if _named(g) and isinstance(v, torch.Tensor) \
                    and v.is_floating_point():
                region[n] = leaves[n] = _leaf(v)
        with torch.enable_grad():
            run_block(sub_block, region, True)
        got = _grads(*_cotangents(op, region, env), leaves)
    else:
        got = {}  # the untaken branch: its outputs do not depend on X
    for n, g in zip(cap, gcap):
        if _named(g):
            grad = got.get(n)
            env[g] = _zeros_like(env[n]) if grad is None else grad


def _run_recompute_grad(op, sub_block, env, run_block):
    cap = op.input("Captured")
    gcap = op.output("Captured@GRAD")
    region, leaves = {}, {}
    for i, n in enumerate(cap):
        v = env[n]
        if i < len(gcap) and _named(gcap[i]) and v.is_floating_point():
            v = leaves[i] = _leaf(v)
        region[n] = v
    with torch.enable_grad():
        run_block(sub_block, region, True)
    got = _grads(*_cotangents(op, region, env), leaves)
    for i, name in enumerate(gcap):
        if not _named(name):
            continue
        g = got.get(i)
        env[name] = _zeros_like(env[cap[i]]) if g is None else g


def _seq_lengths(env, op):
    """The [B] lengths of a DynamicRNN (its ``sequence_length`` input), or
    None for a StaticRNN."""
    names = op.inputs.get("sequence_length", [])
    if not names or not _named(names[0]):
        return None
    return env[names[0]].reshape(-1)


def _time_mask(op, env, steps, device):
    """[T, B] bool, ``t < length``, on the device; None without lengths."""
    lengths = _seq_lengths(env, op)
    if lengths is None:
        return None
    return torch.arange(steps, device=device)[:, None] \
        < lengths.to(device)[None, :]


def _run_steps(op, sub_block, env, run_block, xs, carry, caps, again):
    """The step block over the time-major sequences ``xs`` from the
    states ``carry`` → (the final states, each step output stacked along
    time), each step in an environment of its own (the caller's, with
    ``caps`` over it)."""
    step_inputs = op.attrs["step_input_names"]
    state_names = op.attrs["state_names"]
    state_out_names = op.attrs["state_out_names"]
    step_output_names = op.attrs["step_output_names"]
    steps = xs[0].shape[0] if xs else int(op.attrs.get("max_len", 0))
    device = xs[0].device if xs else carry[0].device
    mask = _time_mask(op, env, steps, device)
    ys = [[] for _ in step_output_names]
    for t in range(steps):
        e = dict(env)
        e.update(caps)
        e.update(zip(state_names, carry))
        e.update((n, x[t]) for n, x in zip(step_inputs, xs))
        run_block(sub_block, e, again)
        new = [e[n] for n in state_out_names]
        outs = [e[n] for n in step_output_names]
        if mask is not None:
            # rows at t >= length keep their state; their outputs are 0
            def keep(v, m=mask[t]):
                return m.reshape((-1,) + (1,) * (v.dim() - 1))

            new = [torch.where(keep(nv), nv, ov)
                   for nv, ov in zip(new, carry)]
            outs = [torch.where(keep(y), y, torch.zeros_like(y))
                    for y in outs]
        carry = new
        for acc, y in zip(ys, outs):
            acc.append(y)
    return carry, [torch.stack(acc) for acc in ys]


def _run_recurrent(op, sub_block, env, run_block):
    time_major = op.attrs.get("time_major", True)
    xs = [env[n] for n in op.input("inputs")]
    if not time_major:
        xs = [x.movedim(1, 0) for x in xs]  # [B, T, ...] -> [T, B, ...]
    carry = [env[n] for n in op.input("initial_states")]
    # in-place ops of the step write copies: each step reads the caller's
    # values as they were, as the reference's scan does
    final, stacked = _run_steps(op, sub_block, env, run_block, xs, carry,
                                {}, True)
    for n, v in zip(op.output("outputs"), stacked):
        env[n] = v if time_major else v.movedim(0, 1)
    for n, v in zip(op.outputs.get("final_states", []), final):
        env[n] = v


def _run_recurrent_grad(op, sub_block, env, run_block):
    time_major = op.attrs.get("time_major", True)
    leaves = {}

    def values(slot):
        """The slot's values, a leaf for each with a gradient to give."""
        grads = dict(zip(op.input(slot), op.outputs.get(slot + "@GRAD", ())))
        vals = []
        for n in op.input(slot):
            v = env[n]
            if _named(grads.get(n)) and v.is_floating_point():
                v = leaves[(slot, n)] = _leaf(v)
            vals.append(v)
        return vals

    xs = values("inputs")
    carry = values("initial_states")
    caps = dict(zip(op.input("Captured"), values("Captured")))
    with torch.enable_grad():
        if not time_major:
            xs = [x.movedim(1, 0) for x in xs]
        _, stacked = _run_steps(op, sub_block, env, run_block, xs, carry,
                                caps, True)
        if not time_major:
            stacked = [y.movedim(0, 1) for y in stacked]
    outs, cots = [], []
    for y, g in zip(stacked, op.input("outputs@GRAD")):
        if _named(g) and g in env and y.requires_grad:
            outs.append(y)
            cots.append(env[g].to(y.dtype))
    got = _grads(outs, cots, leaves)
    for slot in ("inputs", "initial_states", "Captured"):
        for n, g in zip(op.input(slot), op.outputs.get(slot + "@GRAD", ())):
            if _named(g):
                grad = got.get((slot, n))
                env[g] = _zeros_like(env[n]) if grad is None else grad


# ---------------------------------------------------------------------------
# Tensor arrays (the reference's LoDTensorArray ops)
# ---------------------------------------------------------------------------

def _no_infer(op, block):
    pass


def _index(I, capacity):
    """The row ``I`` names, clamped into the buffer as the reference's
    ``dynamic_update_index_in_dim`` clamps it: a [1] int64 device
    index."""
    return I.reshape(1).long().clamp(0, capacity - 1)


@register_op("write_to_array", inputs=["X", "I", "Array"], outputs=["Out"],
             no_grad=True, infer_shape=_no_infer, in_place={"Out": "Array"})
def write_to_array(ctx, attrs, X, I, Array):
    """Row ``I`` of the array := ``X``, its length ``max(length, I + 1)``;
    the first write (no ``Array``) makes a zero buffer of the op's
    capacity.  Written in place: a loop writes its array once a trip."""
    if Array is None:
        cap = int(attrs.get(ARRAY_CAPACITY_ATTR, DEFAULT_ARRAY_CAPACITY))
        Array = TensorArray(
            torch.zeros((cap,) + tuple(X.shape), dtype=X.dtype,
                        device=X.device),
            torch.zeros((), dtype=torch.int32, device=X.device))
    buf = Array.buffer
    buf.index_copy_(0, _index(I, buf.shape[0]),
                    X.to(buf.dtype).unsqueeze(0))
    Array.length.copy_(torch.maximum(
        Array.length, I.reshape(()).to(torch.int32) + 1))
    return Array


@register_op("read_from_array", inputs=["X", "I"], outputs=["Out"],
             no_grad=True, infer_shape=_no_infer)
def read_from_array(ctx, attrs, X, I):
    buf = X.buffer
    return buf.index_select(0, _index(I, buf.shape[0])).squeeze(0)


@register_op("lod_array_length", inputs=["X"], outputs=["Out"], no_grad=True,
             infer_shape=_no_infer)
def lod_array_length(ctx, attrs, X):
    return X.length.reshape(1).clone()


@register_op("tensor_array_to_tensor", inputs=["X"],
             outputs=["Out", "OutIndex"], infer_shape=_no_infer,
             stateful_outputs=("OutIndex",))
def tensor_array_to_tensor(ctx, attrs, X):
    """The whole buffer, its rows concatenated along ``axis`` (0: the
    rows stacked), and each row's size along it (``OutIndex``)."""
    buf = X.buffer
    k = buf.shape[0]
    axis = int(attrs.get("axis", 1)) % max(buf.dim() - 1, 1)
    if axis == 0:
        out = buf.reshape((-1,) + tuple(buf.shape[2:]))
    else:
        out = torch.cat(buf.unbind(0), dim=axis)
    size = buf.shape[axis + 1] if buf.dim() > 1 else 1
    return {"Out": out,
            "OutIndex": torch.full((k,), size, dtype=torch.int32,
                                   device=buf.device)}


@register_op("split_lod_tensor", inputs=["X", "Mask"],
             outputs=["OutTrue", "OutFalse"])
def split_lod_tensor(ctx, attrs, X, Mask):
    """Both halves keep the whole batch, as the reference's static-shape
    form: the rows are chosen at ``merge_lod_tensor``."""
    return {"OutTrue": X, "OutFalse": X}


@register_op("merge_lod_tensor", inputs=["InTrue", "InFalse", "Mask", "X"],
             outputs=["Out"])
def merge_lod_tensor(ctx, attrs, InTrue, InFalse, Mask, X):
    """Row by row, ``InTrue`` where ``Mask`` holds, else ``InFalse``."""
    m = Mask
    if m.dim() < InTrue.dim():
        m = m.reshape(tuple(m.shape) + (1,) * (InTrue.dim() - m.dim()))
    elif m.dim() > InTrue.dim():
        m = m.reshape(tuple(m.shape[:InTrue.dim()]))
    return torch.where(m.bool(), InTrue, InFalse)


# ---------------------------------------------------------------------------
# LoD rank tables, in their padded form (the reference's :650-711)
# ---------------------------------------------------------------------------


@register_op("lod_rank_table", inputs=["X"], outputs=["Out"], no_grad=True,
             infer_shape=_no_infer)
def lod_rank_table(ctx, attrs, X):
    """The rank table of a padded batch: ``X`` is its [B] lengths (a [B,
    T, ...] batch: every row T long), and the rows by descending length,
    ties by row, as the reference's stable sort."""
    if X.dim() <= 1:
        lengths = X.reshape(-1)
    else:
        lengths = torch.full((X.shape[0],), X.shape[1], dtype=torch.int32,
                             device=X.device)
    order = torch.argsort(-lengths.to(torch.int32), stable=True)
    return RankTable(lengths, order)


@register_op("max_sequence_len2", inputs=["RankTable"], outputs=["Out"],
             no_grad=True, infer_shape=_no_infer)
def max_sequence_len2(ctx, attrs, RankTable):
    """The longest length, [1] int64 (the reference's is int32: jax
    without x64)."""
    return RankTable.lengths.max().reshape(1).to(torch.int64)


@register_op("lod_tensor_to_array", inputs=["X", "RankTable"],
             outputs=["Out"], infer_shape=_no_infer)
def lod_tensor_to_array(ctx, attrs, X, RankTable):
    """A padded [B, T, ...] batch as an array of its T time steps: the
    time-major copy is the buffer (written arrays must not alias X)."""
    buf = X.movedim(1, 0).clone(memory_format=torch.contiguous_format)
    return TensorArray(buf, torch.tensor(buf.shape[0], dtype=torch.int32,
                                         device=X.device))


@register_op("array_to_lod_tensor", inputs=["X", "RankTable"],
             outputs=["Out"], infer_shape=_no_infer)
def array_to_lod_tensor(ctx, attrs, X, RankTable):
    """The array's rows stacked batch-major, [B, T, ...]."""
    return X.buffer.movedim(0, 1)


@register_op("shrink_rnn_memory", inputs=["X", "RankTable", "I"],
             outputs=["Out"], infer_shape=_no_infer)
def shrink_rnn_memory(ctx, attrs, X, RankTable, I):
    """The identity: a padded batch keeps every row, and the recurrence's
    mask, not the batch's size, ends a finished sequence."""
    return X


@register_op("reorder_lod_tensor_by_rank", inputs=["X", "RankTable"],
             outputs=["Out"], infer_shape=_no_infer)
def reorder_lod_tensor_by_rank(ctx, attrs, X, RankTable):
    """The rows of ``X`` in the rank table's order."""
    return X.index_select(0, RankTable.order)
