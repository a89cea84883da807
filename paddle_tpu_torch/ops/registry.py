"""Op registry: op type → PyTorch lowering.

Mirrors ``paddle_tpu/ops/registry.py`` (``register_op``,
``LoweringContext``, ``call_op``, ``infer_output_structs``, ``has_op`` /
``get_op_def`` :113-131, the generic grad op :214-295).  One registered
function per op is the op's kernel: a plain function on tensors, or a
call into a hand-written CUDA kernel's wrapper.  Shape inference runs
that same function on ``device="meta"`` tensors, where PyTorch computes
shapes and dtypes without touching data (:func:`infer_output_structs`,
replacing the reference's ``jax.eval_shape``).

Grad ops.  The reference derives ``<type>_grad`` with ``jax.vjp`` over
the forward lowering, which recomputes the forward and relies on XLA to
CSE the copy away.  An eager executor has no CSE, so here the grad op
never recomputes: the executor runs each forward op that has a grad twin
through :func:`call_op_taped`, which makes its differentiable inputs
fresh leaves (``detach().requires_grad_()``, so one autograd graph
covers exactly that op) under ``torch.enable_grad()`` and keeps the
graph in ``ctx.tape`` under the op's id; the generic ``<type>_grad``
(:func:`_make_generic_grad_def`) takes that entry and calls
``torch.autograd.grad`` on it with the output gradients.  Kernel launches
stay inside ``torch.autograd.Function``\\ s on plain tensors.  A grad op
whose forward left no tape entry raises.

In-place ops.  An op is a function of its inputs and never writes one,
with one declared exception: ``register_op(..., in_place={out_slot:
in_slot})`` says the op writes its ``out_slot`` result into the tensor
of ``in_slot`` and returns that tensor (the KV-cache writes of
``ops/decode.py``).  The executor honours the declaration
(``executor.py``); no other op may write an input.

Capturable ops.  The executor replays a program's step from a captured
CUDA graph only when every op of it is capturable: it reads no device
value on the host, allocates nothing whose shape depends on device
values, draws no host random number per run, and talks to no other
process.  ``register_op(..., capturable=...)`` declares it, True by
default; a callable ``capturable(attrs, inputs)`` decides per op from
its attrs and its bound input slots (``OpDef.is_capturable``).

Dropout seeds.  A dropping op takes its seed from the device:
:meth:`LoweringContext.step_seed` pairs the run's step tensor with the
op's salt (``ops/cuda/dropout.py`` ``op_salt``, a pure function of the
program seed, the op's id and the draw), and the kernels derive the seed
from both (``step_seed`` there and in ``csrc/dropout.cuh``), so a
replayed step draws new masks.
"""

import numpy as np
import torch

from .. import core
from .cuda import dropout as _drop

__all__ = [
    "register_op",
    "get_op_def",
    "has_op",
    "OpDef",
    "OpNotRegistered",
    "LoweringContext",
    "call_op",
    "infer_shapes",
    "infer_output_structs",
    "EMPTY_VAR_NAME",
]

EMPTY_VAR_NAME = "@EMPTY@"

_OP_REGISTRY = {}

_SHAPE_SENTINELS = (100003, 100019, 100043, 100057, 100069, 100103, 100109)


class OpNotRegistered(KeyError):
    pass


def _parse_slots(slots):
    """'X' plain, 'X*' duplicable (list-valued slot)."""
    out = []
    for s in slots or []:
        if s.endswith("*"):
            out.append((s[:-1], True))
        else:
            out.append((s, False))
    return out


def _kwarg_name(slot):
    return slot.replace("@GRAD", "_grad").replace("@", "_")


class OpDef:
    def __init__(self, type, fn, inputs, outputs, no_grad=False,
                 infer_shape=None, stateful_outputs=(), in_place=None,
                 capturable=True):
        self.type = type
        self.capturable = capturable
        self.fn = fn
        self.inputs = _parse_slots(inputs)
        self.outputs = _parse_slots(outputs)
        self.no_grad = no_grad
        self.custom_infer_shape = infer_shape
        self.stateful_outputs = set(stateful_outputs)
        self.in_place = dict(in_place or {})

    @property
    def input_slot_names(self):
        return [s for s, _ in self.inputs]

    @property
    def output_slot_names(self):
        return [s for s, _ in self.outputs]

    def is_capturable(self, attrs, inputs):
        """Whether a CUDA graph may capture this op with these attrs;
        ``inputs`` maps its input slots to the bound var names."""
        if callable(self.capturable):
            return bool(self.capturable(attrs, inputs))
        return bool(self.capturable)


def register_op(type, inputs, outputs, no_grad=False, infer_shape=None,
                stateful_outputs=(), in_place=None, capturable=True):
    """Decorator: register ``fn(ctx, attrs, **slots)`` as the lowering of
    ``type``.  Slot kwargs are tensors (lists for duplicable slots, None
    for absent optional slots).  Return a single tensor (one output
    slot), a tuple in declared output order, or a dict slot→tensor.
    ``in_place`` (``{out_slot: in_slot}``) declares a grad-free op that
    writes its result into that input's tensor.  ``capturable`` (a bool,
    or ``capturable(attrs, inputs)``) says whether a CUDA graph may
    capture the op."""

    if in_place and not no_grad:
        raise ValueError("op %r: an in-place op must be no_grad" % type)

    def deco(fn):
        _OP_REGISTRY[type] = OpDef(type, fn, inputs, outputs, no_grad=no_grad,
                                   infer_shape=infer_shape,
                                   stateful_outputs=stateful_outputs,
                                   in_place=in_place, capturable=capturable)
        return fn

    return deco


def has_op(type):
    if type in _OP_REGISTRY:
        return True
    return type.endswith("_grad") and type[:-len("_grad")] in _OP_REGISTRY


def get_op_def(type):
    d = _OP_REGISTRY.get(type)
    if d is not None:
        return d
    if type.endswith("_grad"):
        base = _OP_REGISTRY.get(type[:-len("_grad")])
        if base is not None:
            d = _OP_REGISTRY[type] = _make_generic_grad_def(base)
            return d
    raise OpNotRegistered(type)


class LoweringContext:
    """Per-run state threaded through op functions.

    ``device`` is where creation ops allocate.  ``mode`` is ``"train"``
    or ``"infer"`` (shape inference).  ``step`` is the run's step on the
    device, a 1-element int64 tensor set once per run (the executor's;
    a zero tensor when none is given): dropout draws
    :meth:`step_seed` from it, so a run replayed from a CUDA graph draws
    new masks.  Host RNG: every host random draw (the initialisers) gets
    its own ``torch.Generator`` seeded from (``seed``, op id, draw
    index), so a draw does not depend on op order and a fixed
    ``random_seed`` reproduces across builds, as in the reference.
    ``tape`` maps a forward op's id to its autograd graph until its grad
    op consumes it (:func:`call_op_taped`).  ``program_seed`` is the
    program's ``random_seed`` alone, for draws that must replay across
    runs (the decode sampling ops).  ``rings`` maps a collective op's
    ``ring_id`` to its ``torch.distributed`` group (the reference's
    ``collective_axis``): the startup program's ``c_comm_init`` binds a
    ring there, and a collective op whose ring has no group exchanges
    nothing (``ops/collective.py``)."""

    def __init__(self, seed=0, mode="train", device=None, program_seed=0,
                 rings=None, step=None):
        self.seed = int(seed or 0)
        self._step = step
        self.program_seed = int(program_seed or 0)
        self.mode = mode
        self.device = torch.device("cpu") if device is None else device
        self.rings = {} if rings is None else rings
        self.tape = {}
        self._op_id = 0
        self._rng_count = 0

    def set_op(self, op_id):
        self._op_id = int(op_id)
        self._rng_count = 0

    @property
    def step(self):
        if self._step is None:
            self._step = torch.zeros((1,), dtype=torch.int64,
                                     device=self.device)
        return self._step

    def step_seed(self, fold=0):
        """The device-side seed of the next draw of the current op: the
        run's step and the draw's salt (``_drop.op_salt``, with ``fold``,
        a user's ``seed`` attr, mixed in when non-zero)."""
        salt = _drop.op_salt(self.program_seed, self._op_id, self._rng_count)
        self._rng_count += 1
        if fold:
            salt = _drop.op_salt(salt, fold, 0)
        return _drop.StepSeed(self.step, salt)

    def rng(self, device="cpu"):
        """A fresh host generator for the next draw of the current op."""
        mix = (self.seed * 1000003 + self._op_id) * 7919 + self._rng_count
        self._rng_count += 1
        g = torch.Generator(device=device)
        g.manual_seed(mix % (2 ** 63 - 1))
        return g


def _normalize_result(opdef, res):
    if isinstance(res, dict):
        named = res
    elif isinstance(res, tuple):
        named = {s: v for (s, _), v in zip(opdef.outputs, res)}
    else:
        named = {opdef.outputs[0][0]: res}
    out = {}
    for slot, _dup in opdef.outputs:
        v = named.get(slot)
        if v is None:
            continue
        out[slot] = list(v) if isinstance(v, (list, tuple)) else [v]
    return out


def call_op(opdef, ctx, ins, attrs, op_id=0):
    """Invoke an op lowering.  ``ins``: {slot: [tensor-or-None]}."""
    ctx.set_op(op_id)
    kwargs = {}
    for slot, dup in opdef.inputs:
        vals = ins.get(slot) or []
        if dup:
            kwargs[_kwarg_name(slot)] = list(vals)
        else:
            kwargs[_kwarg_name(slot)] = vals[0] if vals else None
    res = opdef.fn(ctx, dict(attrs), **kwargs)
    return _normalize_result(opdef, res)


def _differentiable(t):
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def call_op_taped(opdef, ctx, ins, attrs, op_id, wanted):
    """Run a forward op whose grad op will follow, keeping its autograd
    graph in ``ctx.tape[op_id]``.  ``wanted`` is ``{slot: {index}}``, the
    input positions the grad op writes a gradient for; the floating ones
    become leaves.  Returns detached outputs."""
    leaves = {}
    for slot, vals in ins.items():
        want = wanted.get(slot, ())
        leaves[slot] = [v.detach().requires_grad_()
                        if i in want and _differentiable(v) else v
                        for i, v in enumerate(vals)]
    with torch.enable_grad():
        outs = call_op(opdef, ctx, leaves, attrs, op_id=op_id)
    ctx.tape[op_id] = (leaves, outs, wanted)
    return {slot: [v.detach() if isinstance(v, torch.Tensor) else v
                   for v in vals] for slot, vals in outs.items()}


def _make_generic_grad_def(fwd_def):
    """``<type>_grad`` of a registered forward: inputs are the forward's
    inputs, outputs and output gradients, outputs the input gradients, as
    the reference's (:214-295).  It differentiates the forward's taped
    graph; zeros go to wanted slots with no gradient path (unused or
    integer inputs), and stateful outputs take no cotangent."""
    grad_inputs = [s + ("*" if dup else "") for s, dup in fwd_def.inputs]
    for slot, dup in fwd_def.outputs:
        grad_inputs.append(slot + ("*" if dup else ""))
        grad_inputs.append(slot + "@GRAD" + ("*" if dup else ""))
    grad_outputs = [s + "@GRAD" + ("*" if dup else "")
                    for s, dup in fwd_def.inputs]

    def grad_fn(ctx, attrs, **kwargs):
        fwd_id = attrs.get("__fwd_op_id__", attrs.get("__op_id__", 0))
        entry = ctx.tape.pop(fwd_id, None)
        if entry is None:
            raise RuntimeError(
                "%s_grad: forward op %s left no autograd tape in this run; "
                "a grad op differentiates the graph its forward recorded "
                "(the executor tapes every forward op with a grad twin) "
                "and never recomputes the forward"
                % (fwd_def.type, fwd_id))
        leaves, primal, wanted = entry
        outs, cots = [], []
        for slot, dup in fwd_def.outputs:
            if slot in fwd_def.stateful_outputs:
                continue
            g = kwargs.get(_kwarg_name(slot + "@GRAD"))
            if g is None:
                continue
            for p, gi in zip(primal.get(slot, ()), g if dup else [g]):
                if gi is None or p is None or not p.requires_grad:
                    continue
                outs.append(p)
                cots.append(gi.to(p.dtype))
        wrt = [t for vals in leaves.values() for t in vals
               if isinstance(t, torch.Tensor) and t.requires_grad]
        grads = [None] * len(wrt)
        if outs and wrt:
            grads = torch.autograd.grad(outs, wrt, cots, allow_unused=True)
        by_leaf = {id(t): g for t, g in zip(wrt, grads)}
        result = {}
        for slot, vals in leaves.items():
            want = wanted.get(slot, ())
            gs = []
            for i, t in enumerate(vals):
                g = by_leaf.get(id(t))
                if i not in want or t is None:
                    g = None
                elif g is None:  # no gradient path, or an integer input
                    g = torch.zeros(t.shape, device=t.device,
                                    dtype=t.dtype if _differentiable(t)
                                    else torch.float32)
                gs.append(g)
            result[slot + "@GRAD"] = gs
        return result

    return OpDef(fwd_def.type + "_grad", grad_fn, grad_inputs, grad_outputs,
                 no_grad=True)


def infer_shapes(op, block):
    """Record inferred output shapes/dtypes on the op's output vars."""
    opdef = get_op_def(op.type)
    if opdef.custom_infer_shape is not None:
        opdef.custom_infer_shape(op, block)
        return
    inferred = infer_output_structs(op, block)
    if inferred is None:
        return
    for n, (shape, dtype) in inferred.items():
        var = block._find_var_recursive(n)
        if var is None:
            continue
        var.shape = shape
        var.dtype = dtype


def infer_output_structs(op, block):
    """Run the op's lowering on meta tensors shaped like the recorded
    input metadata; return ``{out_var_name: (shape, dtype_str)}`` with
    sentinel dims mapped back to -1, or None when the op is not
    inferable this way."""
    opdef = get_op_def(op.type)
    if opdef.custom_infer_shape is not None:
        return None
    ins = {}
    used_sentinel = False
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            if n == EMPTY_VAR_NAME:
                vals.append(None)
                continue
            var = block._find_var_recursive(n)
            if var is None or var.shape is None:
                return None
            shape = []
            for i, d in enumerate(var.shape):
                if d is None or d < 0:
                    shape.append(_SHAPE_SENTINELS[i % len(_SHAPE_SENTINELS)])
                    used_sentinel = True
                else:
                    shape.append(int(d))
            vals.append(torch.empty(shape, dtype=core.torch_dtype(var.dtype),
                                    device="meta"))
        ins[slot] = vals
    ctx = LoweringContext(mode="infer", device=torch.device("meta"))
    try:
        outs = call_op(opdef, ctx, ins, op.attrs,
                       op_id=op.attrs.get("__op_id__", 0))
    except Exception:
        if used_sentinel:
            return None  # sentinel arithmetic broke the lowering
        raise
    sent = set(_SHAPE_SENTINELS)
    out = {}
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        for n, t in zip(names, vals):
            if t is None or n == EMPTY_VAR_NAME:
                continue
            shape = tuple(-1 if int(d) in sent else int(d) for d in t.shape)
            out[n] = (shape, core.convert_np_dtype_to_dtype_(t.dtype))
    return out


def np_to_torch(value, device):
    """Host value → tensor on ``device`` (int64 stays int64).  A numpy
    array is copied, also onto the CPU: a compiled step updates its
    read-write state in place, which must never write into the caller's
    array."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).astype(np.int32))
        return (t << 16).view(torch.float32).to(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, order="C")).to(device)
