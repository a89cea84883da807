"""Op registry: op type → PyTorch lowering.

Mirrors ``paddle_tpu/ops/registry.py`` (``register_op``,
``LoweringContext``, ``call_op``, ``infer_output_structs``).  One
registered function per op is the op's kernel: a plain function on
tensors, or a call into a hand-written CUDA kernel's wrapper.  Shape
inference runs that same function on ``device="meta"`` tensors, where
PyTorch computes shapes and dtypes without touching data
(:func:`infer_output_structs`, replacing the reference's
``jax.eval_shape``).  The generic ``jax.vjp``-derived grad ops wait for
the training slice (ROADMAP.md).
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
    return type in _OP_REGISTRY


def get_op_def(type):
    d = _OP_REGISTRY.get(type)
    if d is None:
        raise OpNotRegistered(type)
    return d


class LoweringContext:
    """Per-run state threaded through op functions.

    ``device`` is where creation ops allocate.  ``mode`` is ``"train"``
    or ``"infer"`` (shape inference).  RNG: every random draw gets its
    own ``torch.Generator`` seeded from (program seed, op id, draw
    index), so a draw does not depend on op order and a fixed
    ``random_seed`` reproduces across builds, as in the reference."""

    def __init__(self, seed=0, mode="train", device=None):
        self.seed = int(seed or 0)
        self.mode = mode
        self.device = torch.device("cpu") if device is None else device
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
