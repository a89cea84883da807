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
"""

import numpy as np
import torch

from .. import core

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
                 infer_shape=None, stateful_outputs=()):
        self.type = type
        self.fn = fn
        self.inputs = _parse_slots(inputs)
        self.outputs = _parse_slots(outputs)
        self.no_grad = no_grad
        self.custom_infer_shape = infer_shape
        self.stateful_outputs = set(stateful_outputs)

    @property
    def input_slot_names(self):
        return [s for s, _ in self.inputs]

    @property
    def output_slot_names(self):
        return [s for s, _ in self.outputs]


def register_op(type, inputs, outputs, no_grad=False, infer_shape=None,
                stateful_outputs=()):
    """Decorator: register ``fn(ctx, attrs, **slots)`` as the lowering of
    ``type``.  Slot kwargs are tensors (lists for duplicable slots, None
    for absent optional slots).  Return a single tensor (one output
    slot), a tuple in declared output order, or a dict slot→tensor."""

    def deco(fn):
        _OP_REGISTRY[type] = OpDef(type, fn, inputs, outputs, no_grad=no_grad,
                                   infer_shape=infer_shape,
                                   stateful_outputs=stateful_outputs)
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
    or ``"infer"`` (shape inference).  RNG: every random draw gets its
    own ``torch.Generator`` seeded from (program seed, op id, draw
    index), so a draw does not depend on op order and a fixed
    ``random_seed`` reproduces across builds, as in the reference.
    ``tape`` maps a forward op's id to its autograd graph until its grad
    op consumes it (:func:`call_op_taped`)."""

    def __init__(self, seed=0, mode="train", device=None):
        self.seed = int(seed or 0)
        self.mode = mode
        self.device = torch.device("cpu") if device is None else device
        self.tape = {}
        self._op_id = 0
        self._rng_count = 0

    def set_op(self, op_id):
        self._op_id = int(op_id)
        self._rng_count = 0

    def rng(self, device="cpu"):
        """A fresh generator for the next draw of the current op."""
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
    """Host value → tensor on ``device`` (int64 stays int64)."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).astype(np.int32))
        return (t << 16).view(torch.float32).to(torch.bfloat16).to(device)
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # torch tensors over read-only memory
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)
