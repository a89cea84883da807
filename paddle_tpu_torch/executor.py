"""Executor: runs a Program's global block op by op on a torch device.

Mirrors ``paddle_tpu/executor.py`` (``Scope``, ``scope_guard``,
``global_scope``, ``_check_feed_shapes`` :1050, ``Executor.run`` :1093).
The reference lowers the whole block into one jitted jax function; here
the block is interpreted eagerly, op by op, into an environment of
tensors on the place's device (compare the reference's
``_run_ops_into_env`` :999).  A training program's grad ops
differentiate the autograd graphs their forward ops recorded in the
same run (``ops/registry.py``); the graphs are dropped when ``run``
returns.  PyTorch launches CUDA kernels
asynchronously, so ``run`` returns once the step is enqueued and the
fetches decide when to wait: numpy arrays after one batched sync
(``return_numpy=True``) or lazy :class:`FetchHandle`\\ s.

Data parallelism follows the reference's collective mode: one process
per rank runs the transpiled program, and its collective ops exchange
over the ``torch.distributed`` group that the startup program's
``c_comm_init`` bound in the scope (``ops/collective.py``).

Persistable outputs are written back to the scope; a scope value is
never updated in place, with one declared exception: an op registered
with ``in_place={out_slot: in_slot}`` (the four KV-cache writes of
``ops/decode.py``) writes into its input's tensor, so a decode step
updates the resident cache rows it touches instead of copying the cache.
Where the program sends such an op's result to a var other than the
input's, the op gets a copy of the input and the resident tensor stays
as it was.  There is no jit cache, scan or sharding; a CUDA
graph of the step comes in a later slice (ROADMAP.md).  On a CUDA place
the executor turns TF32 off for float32 products
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), so they run in full float32 as on
the CPU.
"""

import contextlib
import threading

import torch

from . import core
from . import pipeline as _pipeline
from .framework import Variable, default_main_program
from .ops import registry as op_registry
from .ops.registry import EMPTY_VAR_NAME, np_to_torch
from .pipeline import FetchHandle

__all__ = ["Executor", "Scope", "global_scope", "scope_guard",
           "FetchHandle"]


class Scope:
    """name → tensor map with the reference's parent-chain lookup.
    ``rings`` holds the collective rings a startup program's
    ``c_comm_init`` bound in this scope (ring id → process group,
    ``ops/collective.py``)."""

    def __init__(self, parent=None):
        self.vars = {}
        self.parent = parent
        self.rings = {}
        self._kids = []

    def new_scope(self):
        kid = Scope(parent=self)
        self._kids.append(kid)
        return kid

    def drop_kids(self):
        self._kids = []

    def local_var_names(self):
        return list(self.vars)

    def _owner_of(self, name):
        s = self
        while s is not None:
            if name in s.vars:
                return s
            s = s.parent
        return self

    def get(self, name):
        s = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        return None

    def has(self, name):
        s = self
        while s is not None:
            if name in s.vars:
                return True
            s = s.parent
        return False

    def set(self, name, value):
        self._owner_of(name).vars[name] = value


_global_scope = Scope()


class _ScopeStack(threading.local):
    """Per-thread scope stack rooted at the shared global scope, so
    predictors serving from different threads never resolve each other's
    private scopes."""

    def __init__(self):
        self.frames = [_global_scope]


_scope_stack = _ScopeStack()


def global_scope():
    return _scope_stack.frames[-1]


@contextlib.contextmanager
def scope_guard(scope):
    _scope_stack.frames.append(scope)
    try:
        yield
    finally:
        _scope_stack.frames.pop()


def _check_feed_shapes(program, feed_vals):
    """Validate fed arrays against declared ``layers.data`` shapes: a
    rank-equal feed whose static dim disagrees raises a ValueError naming
    the var (``-1`` dims accept anything; a builder's ``feed_hint`` is
    appended)."""
    block = program.global_block()
    for name, value in feed_vals.items():
        var = block.vars.get(name)
        if var is None or not getattr(var, "need_check_feed", False):
            continue
        declared = var.shape
        got = tuple(getattr(value, "shape", ()))
        if declared is None or len(declared) != len(got):
            continue
        for d_decl, d_got in zip(declared, got):
            if d_decl >= 0 and d_decl != d_got:
                hint = getattr(var, "feed_hint", None)
                raise ValueError(
                    "feed %r has shape %s but the data layer declares %s "
                    "(dim %d != %d)%s"
                    % (name, got, tuple(declared), d_got, d_decl,
                       ("\n" + hint) if hint else ""))


def _grad_twins(block):
    """``{forward op id: {input slot: {index}}}``: the forward ops that a
    grad op of ``block`` differentiates, with the input positions it
    writes gradients for."""
    wanted = {}
    for op in block.ops:
        fwd_id = op.attrs.get("__fwd_op_id__")
        if fwd_id is None:
            continue
        slots = wanted.setdefault(fwd_id, {})
        for slot, names in op.outputs.items():
            if slot.endswith("@GRAD"):
                slots.setdefault(slot[:-len("@GRAD")], set()).update(
                    i for i, n in enumerate(names)
                    if n and n != EMPTY_VAR_NAME)
    return wanted


def _run_ops_into_env(block, env, ctx):
    """Run every op of ``block`` on the tensors in ``env`` (name →
    tensor), adding each op's outputs.  Call it under ``torch.no_grad()``:
    a forward op that a grad op of the block differentiates records its
    autograd graph on ``ctx.tape`` (``registry.call_op_taped``), every
    other op (grad, optimizer, ops without a twin) runs without one."""
    twins = _grad_twins(block)
    for op in block.ops:
        if op.type in ("feed", "fetch"):
            continue
        opdef = op_registry.get_op_def(op.type)
        ins = {}
        for slot, names in op.inputs.items():
            vals = []
            for n in names:
                if not n or n == EMPTY_VAR_NAME:
                    vals.append(None)
                    continue
                if n not in env:
                    raise RuntimeError(
                        "op %s reads %r, which is neither fed, produced by "
                        "an earlier op, nor in the scope" % (op.type, n))
                vals.append(env[n])
            ins[slot] = vals
        for out_slot, in_slot in opdef.in_place.items():
            if op.outputs.get(out_slot) != op.inputs.get(in_slot):
                ins[in_slot] = [None if v is None else v.clone()
                                for v in ins[in_slot]]
        op_id = op.attrs.get("__fwd_op_id__", op.attrs.get("__op_id__", 0))
        if "__fwd_op_id__" not in op.attrs and op_id in twins:
            outs = op_registry.call_op_taped(opdef, ctx, ins, op.attrs,
                                             op_id, twins[op_id])
        else:
            outs = op_registry.call_op(opdef, ctx, ins, op.attrs,
                                       op_id=op_id)
        for slot, names in op.outputs.items():
            for n, v in zip(names, outs.get(slot, ())):
                if n and n != EMPTY_VAR_NAME and v is not None:
                    env[n] = v
    return env


class Executor:
    """``Executor(place).run(program, feed, fetch_list)``.  The place
    defaults to ``CUDAPlace(0)``; pass ``CPUPlace()`` for the CPU.  A CUDA
    place raises at construction when no CUDA device is available."""

    def __init__(self, place=None):
        self.place = place if place is not None else core.CUDAPlace(0)
        self.device = core.as_torch_device(self.place)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self._step = 0

    def close(self):
        pass

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name="feed", fetch_var_name="fetch", scope=None,
            return_numpy=True, use_program_cache=True, use_prune=False,
            verify=False):
        if verify:
            raise NotImplementedError(
                "Executor.run(verify=True) needs the static-analysis "
                "verifier, which is not ported yet (ROADMAP.md, Queue A "
                "item 3: static-analysis gates); pass verify=False")
        from .static_analysis import fusion as _fusion

        if program is None:
            program = default_main_program()
        if scope is None:
            scope = global_scope()
        feed = feed or {}
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        program, _report = _fusion.resolve_fused_program(
            program, targets=fetch_names)

        feed_vals = {}
        for name, value in feed.items():
            if isinstance(value, FetchHandle):
                value = value.device_value
            feed_vals[name] = np_to_torch(value, self.device)
        _check_feed_shapes(program, feed_vals)

        block = program.global_block()
        env = {}
        for op in block.ops:
            for n in op.input_arg_names:
                if n in env or n in feed_vals or not scope.has(n):
                    continue
                val = scope.get(n)
                if val is None:
                    continue
                if not isinstance(val, torch.Tensor) \
                        or val.device != self.device:
                    val = np_to_torch(val, self.device)
                    scope.set(n, val)  # keep it resident on this device
                env[n] = val
        env.update(feed_vals)
        ctx = op_registry.LoweringContext(
            seed=(program.random_seed or 0) * 1000003 + self._step,
            mode="train", device=self.device,
            program_seed=program.random_seed or 0,
            rings=scope.rings)
        self._step += 1
        with torch.no_grad():
            _run_ops_into_env(block, env, ctx)
        ctx.tape.clear()  # graphs of forwards whose grads were not run
        for v in block.vars.values():
            if v.persistable and not v.is_data and v.name in env:
                scope.set(v.name, env[v.name])
        fetches = []
        for n in fetch_names:
            if n not in env and not scope.has(n):
                raise RuntimeError("fetch target %r was not produced by the "
                                   "program and is not in the scope" % n)
            fetches.append(env[n] if n in env else scope.get(n))
        if return_numpy:
            return _pipeline.host_values(fetches)
        return [v if isinstance(v, FetchHandle) else FetchHandle(v)
                for v in fetches]
