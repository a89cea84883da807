"""Executor: runs a Program's global block on a torch device, as one
captured CUDA graph per (program, feeds) from the second call on.

Mirrors ``paddle_tpu/executor.py`` (``Scope``, ``scope_guard``,
``global_scope``, ``_check_feed_shapes`` :1050, ``_analyze_block`` :449,
``_CompiledBlock`` :535, ``Executor.run`` :1093 with its cache key
:1241-1285).  The reference lowers the whole block into one jitted jax
function and caches it; here the counterpart of that function is the
block's step captured in a CUDA graph:

1. ``_analyze_block`` finds, once per cache entry, the scope vars the
   step reads, split into the read-write persistables (``rw_names``,
   the reference's donated params), the read-only ones (``ro_names``)
   and the persistables it writes without reading (``fresh_persist``);
2. the entry (:class:`_CompiledBlock`) is cached in ``Executor._cache``
   under the reference's key: ``(id(program), program._version,
   id(scope), feed names/shapes/dtypes, fetch names, fusion
   signature)``;
3. the first call for a key runs eagerly, op by op (the warm-up: the
   kernel library is built, cuDNN and cuBLAS set up, the decode kernels'
   row counters made), on the executor's side stream; the second call
   captures the step in ``torch.cuda.graph`` on that stream (one memory
   pool per executor, shared by its graphs) and replays it; later calls
   copy the feeds into the entry's static input tensors, fill the step
   tensor and ``replay()``;
4. the step goes in as a device tensor (``LoweringContext.step``), as
   the reference passes its rng key (:1292): every dropout mask is drawn
   from it in the kernels, so a replay draws new masks.

A program with an op that is not capturable (``register_op(...,
capturable=...)``: host sampling, a tensor-bounded ``range``, the
collectives, the host random initialisers) runs eagerly on every call,
decided at analysis; a capture that fails raises.  While
``FLAGS_check_nan_inf`` is set every call runs eagerly and checks each
op's floating outputs (``core.set_flags``); the flags that change what
runs (``core.flags_key``) are part of the cache key.  ``last_run_mode``
(``"eager"``, ``"capture"`` or ``"graph"``) and ``last_run_reason`` say
what the last call did.  On the CPU there is no graph: from the second
call the entry's step runs directly on its static inputs, through the
same bookkeeping.  ``use_program_cache=False`` runs eagerly, as the
reference's uncached path.

Loops.  A ``while`` or ``conditional_block`` reads its condition on the
host, so a program that holds one runs its ops eagerly; a ``while`` body
is a cache entry of its own (:class:`_LoopBody`, keyed by the program,
the body's block, the scope and what the body reads): its first trip
runs op by op, its second is captured in a CUDA graph on the bound
inputs, and every later trip, in this run and later ones, replays it
after one read of the condition (``ops/control_flow.py``).
``last_loops`` holds a record of each loop run (trips, condition reads,
how the body ran and why) and ``last_run_reason`` sums them up.

State.  A captured step reads the scope tensors it was captured with,
so parameters, optimizer moments and batch-norm statistics keep their
addresses (the counterpart of the reference's ``donate_argnums=(1,)``).
An op registered with ``in_place={out_slot: in_slot}`` writes the
resident tensor itself: the optimizer updates (``ops/optimizer_ops.py``),
batch norm's running statistics and the KV-cache writes of
``ops/decode.py``.  Any other new read-write value is copied into its
tensor at the end of the step (``resident.copy_(new)``;
``_CompiledBlock.copy_backs`` counts them: 0 on the training paths).  An
in-place write of a tensor that a later grad op's forward read raises,
naming the op and the var (``_run_ops_into_env``).  Before a replay the
scope values the graph reads are checked to be the tensors it was
captured with, once the scope's generation (``Scope.generation``, moved
by every write to the scope or a parent) differs from the one recorded
at the last check; a value replaced since (``scope.set``, a load, a
convert) of the same shape and dtype is copied into the captured tensor,
which goes back into the scope, and any other change drops the entry, so
the graph never reads a stale or freed tensor.
Fetches and fresh persistables are cloned out of the graph's memory
after each replay, so a lazy :class:`FetchHandle` keeps its value.  A
replay calls no kernel wrapper: the kernel launches it runs are counted
from the captured graph's own kernel nodes, read through libcuda once
after the capture (``ops/cuda/_lib.py`` ``graph_kernel_nodes``).

The eager path interprets the block op by op into an environment of
tensors (the reference's ``_run_ops_into_env`` :999) and writes every
persistable output back to the scope as a new tensor, except the
declared in-place writes, which update the resident cache rows they
touch; where the program sends such an op's result to a var other than
the input's, the op gets a copy of the input.  A training program's grad
ops differentiate the autograd graphs their forward ops recorded in the
same step (``ops/registry.py``), in the eager run and in the captured
one alike.  PyTorch launches CUDA work asynchronously, so ``run``
returns once the step is enqueued and the fetches decide when to wait:
numpy arrays after one batched sync (``return_numpy=True``) or lazy
:class:`FetchHandle`\\ s.

Data parallelism follows the reference's collective mode: one process
per rank runs the transpiled program, and its collective ops exchange
over the ``torch.distributed`` group that the startup program's
``c_comm_init`` bound in the scope (``ops/collective.py``); such a
program runs eagerly.  On a CUDA place the executor turns TF32 off for
float32 products (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), so they run in full float32 as on
the CPU, and turns off cuBLAS's bf16 reduction of split-K partials
(``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``,
on by default), so a bf16 product accumulates in float32 to the end, as
the reference's ``preferred_element_type=float32``.

Telemetry (the reference's hooks, :1258-1343): every cache key lookup is
``record_jit_cache`` (a hit when the key has an entry).  The port's
analog of the reference's lower-and-jit on a cache miss is a key's first
call, eager (the warm-up), and its second, which captures the CUDA graph:
the ``executor.compile`` span (attribute ``phase``: ``"warm-up"``,
``"capture"``, or ``"uncached"`` under ``use_program_cache=False``)
covers that whole call, capture, instantiation and first replay
included, and ``record_compile`` gets its wall time.  Every call is an
``executor.step`` span (sampled by ``sample_step``: always inside a
trace, 1 in ``PADDLE_TPU_TRACE_SAMPLE`` standalone) around an
``executor.dispatch`` span (``span_if_traced``) that ends once the step
is enqueued, and ``record_step`` gets the call's wall time, its
dispatch time and the entry's drift key.  At a key's first call the
cost model prices the program and the drift monitor registers the
prediction, with the collective schedule (``_register_compile_telemetry``,
the reference's :239-270; host work once per key, skipped with telemetry
off).  With the profiler on (:mod:`.profiler`), a key's compile calls
are ``executor.lower_and_jit`` events and every call an ``executor.run``
event (:1279, :1298).  All of it is host time: nothing waits on the
device.

A fusion clone that a newer clone of the same program and fetch set
replaces (a new flash threshold, an autotune or drift write, a
mutation) has its cache entries dropped with their graphs, so the graphs
an executor holds stay bounded while the autotune state moves.
"""

import contextlib
import threading
import time

import numpy as np
import torch

from . import core
from . import pipeline as _pipeline
from . import profiler as _prof
from .framework import Variable, default_main_program
from .observability import runtime as _obs
from .observability import tracing as _tr
from .ops import control_flow as _cf
from .ops import registry as op_registry
from .ops.cuda import _lib as _kernels
from .ops.registry import EMPTY_VAR_NAME, np_to_torch
from .pipeline import FetchHandle

__all__ = ["Executor", "Scope", "global_scope", "scope_guard",
           "FetchHandle"]

_NO_EVENT = contextlib.nullcontext()


class _Vars(dict):
    """A scope's name → value map: every write or removal bumps the
    scope's generation."""

    def __init__(self, scope):
        super().__init__()
        self._scope = scope

    def __setitem__(self, name, value):
        self._scope._gen += 1
        super().__setitem__(name, value)

    def __delitem__(self, name):
        self._scope._gen += 1
        super().__delitem__(name)

    def _bumped(name):
        def method(self, *args, **kwargs):
            self._scope._gen += 1
            return getattr(dict, name)(self, *args, **kwargs)
        return method

    pop = _bumped("pop")
    popitem = _bumped("popitem")
    clear = _bumped("clear")
    update = _bumped("update")
    setdefault = _bumped("setdefault")
    del _bumped


class Scope:
    """name → tensor map with the reference's parent-chain lookup.
    ``rings`` holds the collective rings a startup program's
    ``c_comm_init`` bound in this scope (ring id → process group,
    ``ops/collective.py``).  :attr:`generation` changes whenever a value
    that :meth:`get` can return does: a write to this scope's or a
    parent's ``vars``."""

    def __init__(self, parent=None):
        self._gen = 0
        self.vars = _Vars(self)
        self.parent = parent
        self.rings = {}
        self._kids = []

    @property
    def generation(self):
        """The sum of the write counters up the parent chain; each only
        grows, so any write on the chain moves it."""
        gen, s = 0, self
        while s is not None:
            gen += s._gen
            s = s.parent
        return gen

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
        """Bind ``name``; setting the value it already holds changes
        nothing, not even the generation."""
        owner = self._owner_of(name)
        if name not in owner.vars or owner.vars[name] is not value:
            owner.vars[name] = value


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


def _check_finite(op, names, vals):
    """``FLAGS_check_nan_inf``: raise on the first floating output of
    ``op`` that holds a NaN or an Inf (one host read per output)."""
    for n, v in zip(names, vals):
        if isinstance(v, torch.Tensor) and v.is_floating_point() \
                and not bool(torch.isfinite(v).all()):
            raise FloatingPointError(
                "FLAGS_check_nan_inf: op %s (id %s) wrote NaN or Inf into "
                "%r" % (op.type, op.attrs.get("__op_id__"), n))


def _region_live(block, fetch_names):
    """The names a recompute region of ``block`` may leave in the
    environment: those an op of ``block`` reads (a region's grad op reads
    its ``Captured`` inputs and output gradients, not its outputs, which
    it computes again), the fetches, and the persistables."""
    live = set(fetch_names)
    for op in block.ops:
        for slot, names in op.inputs.items():
            if op.type == "recompute_block_grad" and slot == "Out":
                continue
            live.update(names)
    live.update(n for n, v in block.vars.items() if v.persistable)
    return live


def _run_ops_into_env(block, env, ctx, check_nan_inf=False, fetch_names=(),
                      replay=False):
    """Run every op of ``block`` on the tensors in ``env`` (name →
    tensor), adding each op's outputs.  Call it under ``torch.no_grad()``:
    a forward op that a grad op of the block differentiates records its
    autograd graph on ``ctx.tape`` (``registry.call_op_taped``), every
    other op (grad, optimizer, ops without a twin) runs without one.  A
    sub-block op (a recompute region and its grad) runs its block through
    this same loop (``ops/control_flow.py``); a region leaves in ``env``
    only what a later op, ``fetch_names`` or the scope reads.

    An op that writes an input in place (``register_op(...,
    in_place=...)``, the optimizer updates and the KV-cache writes) may
    not write a tensor that a taped forward or a region whose grad op has
    not run yet read: autograd saved it, or the region reads it again,
    for that grad op.  Such an op raises, naming itself and the var,
    before it writes.  With ``replay`` (a region's second run) every
    in-place op writes a copy.  With ``check_nan_inf`` every op's
    floating outputs are checked (``_check_finite``)."""
    twins = _grad_twins(block)
    pending = {}  # taped forward op id -> the var names it read
    live = None
    dead = _dead_snapshots(block, fetch_names)

    def run_block(sub_block, sub_env, again):
        return _run_ops_into_env(sub_block, sub_env, ctx, check_nan_inf,
                                 live, replay or again)

    for op in block.ops:
        if op.type in ("feed", "fetch"):
            continue
        if dead and op.type == "assign" and set(op.output_arg_names) <= dead:
            continue  # a while's snapshot that no grad op reads
        if op.type in _cf.SUB_BLOCK_OPS:
            if live is None:
                live = _region_live(block, fetch_names)
            op_id = op.attrs.get("__op_id__")
            if op.type.endswith("_grad"):
                pending.pop(op.attrs.get("__fwd_op_id__"), None)
            elif op_id in twins:
                pending[op_id] = set(op.input_arg_names)
            _cf.run_sub_block_op(op, block, env, ctx, run_block, live)
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
            if replay or op.outputs.get(out_slot) != op.inputs.get(in_slot):
                ins[in_slot] = [None if v is None else v.clone()
                                for v in ins.get(in_slot, ())]
                continue
            for n in op.inputs.get(in_slot, ()):
                for fwd_id, read in pending.items():
                    if n in read:
                        raise RuntimeError(
                            "op %s writes %r in place, but the grad op of "
                            "forward op %s runs after it and needs the "
                            "value that op read; put every grad op before "
                            "the updates (append_backward, then the "
                            "optimizer)" % (op.type, n, fwd_id))
        fwd_of = op.attrs.get("__fwd_op_id__")
        op_id = op.attrs.get("__fwd_op_id__", op.attrs.get("__op_id__", 0))
        if fwd_of is None and op_id in twins:
            outs = op_registry.call_op_taped(opdef, ctx, ins, op.attrs,
                                             op_id, twins[op_id])
            pending[op_id] = set(op.input_arg_names)
        else:
            outs = op_registry.call_op(opdef, ctx, ins, op.attrs,
                                       op_id=op_id)
            pending.pop(fwd_of, None)
        for slot, names in op.outputs.items():
            vals = outs.get(slot, ())
            if check_nan_inf:
                _check_finite(op, names, vals)
            for n, v in zip(names, vals):
                if n and n != EMPTY_VAR_NAME and v is not None:
                    env[n] = v
    return env


def _dead_snapshots(block, fetch_names=()):
    """The pre-loop snapshots (``assign`` into a ``while``'s
    ``snapshot_pres``) of ``block`` that no ``while_grad`` of it reads:
    the executor skips them, as XLA drops them in the reference."""
    made, read = set(), set()
    for op in block.ops:
        if op.type == "while":
            made.update(op.attrs.get("snapshot_pres", ()))
        elif op.type == "while_grad":
            read.update(op.attrs.get("snapshot_pres", ()))
    return made - read - set(fetch_names)


# ops the reference runs host-side around its jitted step (:275)
_HOST_SIDE_OPS = ("feed", "fetch", "save", "load", "save_combine",
                  "load_combine")


def _analyze_block(block, feed_names, fetch_names):
    """SSA analysis (the reference's, :449): (external scope reads,
    written names, written persistables)."""
    defined = set(feed_names)
    ext_reads = []
    written = []
    for op in block.ops:
        if op.type in _HOST_SIDE_OPS:
            continue
        for n in op.input_arg_names:
            if n and n != EMPTY_VAR_NAME and n not in defined:
                if n not in ext_reads:
                    ext_reads.append(n)
        for n in op.output_arg_names:
            if n and n != EMPTY_VAR_NAME:
                defined.add(n)
                written.append(n)
    for n in fetch_names:
        if n not in defined and n not in ext_reads:
            ext_reads.append(n)
    persist_written = []
    for n in written:
        v = block._find_var_recursive(n)
        if v is not None and v.persistable and n not in persist_written:
            persist_written.append(n)
    return ext_reads, written, persist_written


# sub-block ops that read a condition on the host
_HOST_BRANCH_OPS = ("while", "while_grad", "conditional_block",
                    "conditional_block_grad")


def _ops_with_regions(block, sub_block_ops=False):
    """The ops of ``block`` and of the sub-blocks its ops run; the
    sub-block ops themselves too with ``sub_block_ops``."""
    for op in block.ops:
        if op.type in _cf.SUB_BLOCK_OPS:
            if sub_block_ops:
                yield op
            yield from _ops_with_regions(
                block.program.block(op.attrs["sub_block"]), sub_block_ops)
        else:
            yield op


def _eager_reason(block):
    """Why ``block`` cannot be captured in a CUDA graph (its first op,
    or first op of a region, that is not capturable, or its first loop
    or branch, whose condition is read on the host), or None."""
    for op in _ops_with_regions(block, sub_block_ops=True):
        if op.type in _HOST_SIDE_OPS:
            continue
        if op.type in _HOST_BRANCH_OPS:
            return "op %r (%s) reads its condition on the host" % (
                op.type, (op.input("Condition") or op.input("Cond"))[:1])
        if op.type in _cf.SUB_BLOCK_OPS:
            continue
        if not op_registry.get_op_def(op.type).is_capturable(op.attrs,
                                                             op.inputs):
            return "op %r (%s) is not capturable" % (
                op.type, op.output_arg_names[:1] or op.input_arg_names[:1])
    return None


def _in_place_writes(block):
    """Names the block's ops write in place (``register_op(...,
    in_place=...)`` with the output slot naming the input var)."""
    names = set()
    for op in _ops_with_regions(block):
        if op.type in ("feed", "fetch"):
            continue
        for out_slot, in_slot in op_registry.get_op_def(
                op.type).in_place.items():
            if op.outputs.get(out_slot) == op.inputs.get(in_slot):
                names.update(op.inputs.get(in_slot, ()))
    return names


def _storage(t):
    return (t.device, t.untyped_storage().data_ptr())


def _host_value(value):
    """A feed as given: a tensor, or a numpy array."""
    if isinstance(value, FetchHandle):
        value = value.device_value
    if isinstance(value, (torch.Tensor, np.ndarray)):
        return value
    return np.asarray(value)


def _sig(v):
    """What a cache key holds of a value: shape, dtype and device type
    (of a tensor array's buffer)."""
    if isinstance(v, _cf.TensorArray):
        return ("array", tuple(v.buffer.shape), v.buffer.dtype,
                v.buffer.device.type)
    return (tuple(v.shape), v.dtype, v.device.type)


def _same_memory(a, b):
    if isinstance(a, _cf.TensorArray):
        return _same_memory(a.buffer, b.buffer) \
            and _same_memory(a.length, b.length)
    return a.device == b.device and a.data_ptr() == b.data_ptr() \
        and a.stride() == b.stride()


def _copy_back(resident, env, names, error):
    """Copy the new value in ``env`` of each of ``names`` into its
    resident tensor (``resident[name]``) → the names copied, sorted.  A
    name unwritten, or written in place, needs no copy; a new value of
    another shape or dtype raises ``error % (name, old sig, new sig)``.
    A value in another resident's memory is taken first, so the order of
    the copies cannot matter."""
    news = {}
    for n in names:
        new, old = env.get(n), resident.get(n)
        if new is None or old is None or new is old:
            continue
        if _sig(new) != _sig(old):
            raise RuntimeError(error % (n, _sig(old), _sig(new)))
        news[n] = new
    held = {_storage(t) for t in resident.values()}
    for n, new in news.items():
        if _storage(new) in held:
            news[n] = new.clone()
    for n, new in news.items():
        resident[n].copy_(new)
    return sorted(news)


def _replay(entry):
    """Replay ``entry``'s captured graph, counting its kernel nodes."""
    entry.graph.replay()
    _kernels.count_replay(entry.kernel_nodes)


class _CompiledBlock:
    """One cache entry: the block's analysis and, from its second call,
    the captured step (the reference's ``_CompiledBlock``).  ``reads``
    are the scope tensors the step reads (read-write and read-only),
    ``feeds`` its static inputs, ``step`` its step tensor; ``fetches``
    and ``fresh`` are its outputs inside the graph's memory.
    ``captured`` counts the kernel launches that the wrappers recorded
    into the graph and ``kernel_nodes`` the graph's kernel nodes by
    kernel, as libcuda lists them; a replay runs the latter.
    ``copy_backs`` is the number of new read-write values the step copies
    into their resident tensors (0 when every state write is declared in
    place) and ``copy_back_names`` names them.  ``generation`` is the
    scope's generation when the bound tensors were last checked against
    it (:meth:`rebind`)."""

    def __init__(self, program, feed_names, fetch_names):
        self.program = program  # holds id(program) for the key's life
        self.block = program.global_block()
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        ext_reads, _written, persist_written = _analyze_block(
            self.block, feed_names, fetch_names)
        self.rw_names = [n for n in ext_reads if n in persist_written]
        self.ro_names = [n for n in ext_reads if n not in persist_written]
        self.fresh_persist = [n for n in persist_written
                              if n not in self.rw_names]
        self.eager_reason = _eager_reason(self.block)
        self.calls = 0
        self.drift_key = None
        self.graph = None
        self.reads = None
        self.feeds = None
        self.staging = {}
        self.feed_done = None
        self.step = None
        self.fetches = None
        self.fresh = None
        self.captured = {}
        self.kernel_nodes = {}
        self.copy_back_names = []
        self.generation = None

    @property
    def copy_backs(self):
        return len(self.copy_back_names)

    def bind(self, scope, feed_vals, device):
        """Fix the step's inputs: the scope tensors it reads (a read-write
        one that shares memory with another read is replaced by a copy,
        so copying its new value back changes nothing else) and static
        copies of the feeds."""
        rw = set(self.rw_names)
        reads, seen = {}, set()
        for n in self.ro_names + self.rw_names:
            val = scope.get(n) if scope.has(n) else None
            if val is None:
                continue
            if not isinstance(val, torch.Tensor) or val.device != device:
                val = np_to_torch(val, device)
                scope.set(n, val)
            if n in rw and _storage(val) in seen:
                val = val.clone()
                scope.set(n, val)
            seen.add(_storage(val))
            reads[n] = val
        self.reads = reads
        self.generation = scope.generation
        self.feeds = {n: v.clone() for n, v in feed_vals.items()}
        if device.type == "cuda":
            self.staging = {n: torch.empty(v.shape, dtype=v.dtype,
                                           pin_memory=True)
                            for n, v in self.feeds.items()}

    def trace(self, ctx):
        """The step on the bound inputs: every op, then each new
        read-write value copied into its resident tensor.  Returns the
        fetches and the fresh persistables."""
        env = dict(self.reads)
        env.update(self.feeds)
        with torch.no_grad():
            _run_ops_into_env(self.block, env, ctx,
                              fetch_names=self.fetch_names)
            ctx.tape.clear()
            self.copy_back_names = _copy_back(
                self.reads, env, self.rw_names,
                "%r changes from %s to %s in the step; a captured step "
                "keeps each state var's shape and dtype (run with "
                "use_program_cache=False)")
        missing = [n for n in self.fetch_names if n not in env]
        if missing:
            raise RuntimeError("fetch target %r was not produced by the "
                               "program and is not in the scope"
                               % missing[0])
        fetches = [env[n] for n in self.fetch_names]
        fresh = {n: env[n] for n in self.fresh_persist if n in env}
        return fetches, fresh

    def rebind(self, scope):
        """True when every scope value the step reads is its bound tensor,
        after copying into it any value of the same shape and dtype that
        replaced it; False when one changed otherwise.  Nothing is walked
        while the scope's generation is the one recorded after the last
        check: no value it can return has been replaced since."""
        if scope.generation == self.generation:
            return True
        for n, t in self.reads.items():
            cur = scope.get(n)
            if cur is t:
                continue
            if cur is None:
                return False
            if not isinstance(cur, torch.Tensor):
                cur = np_to_torch(cur, torch.device("cpu"))
            if cur.shape != t.shape or cur.dtype != t.dtype:
                return False
            if cur.device != t.device or cur.data_ptr() != t.data_ptr() \
                    or cur.stride() != t.stride():
                t.copy_(cur)
            scope.set(n, t)
        self.generation = scope.generation
        return True

    def stage(self, feed):
        """Copy this call's feeds into the static inputs: host arrays
        through pinned buffers, waiting only for the previous copies out
        of them; tensors (feeds already staged on the device) directly,
        with no wait."""
        pinned = bool(self.staging) and any(
            not isinstance(v, torch.Tensor) for v in feed.values())
        if pinned and self.feed_done is not None:
            self.feed_done.synchronize()
        for n, value in feed.items():
            dst = self.feeds[n]
            if not isinstance(value, torch.Tensor):
                value = np_to_torch(value, torch.device("cpu"))
                buf = self.staging.get(n)
                if buf is not None:
                    buf.copy_(value)
                    value = buf
            dst.copy_(value, non_blocking=True)
        if pinned:
            self.feed_done = torch.cuda.Event()
            self.feed_done.record()


class _LoopBody:
    """One cache entry of a ``while`` body: the body's block, its
    loop-carried names (``carried``, the condition among them) and the
    names it only reads (``reads``: parameters, limits, the values made
    before the loop).  Its first trip runs op by op on the executor's
    side stream (the warm-up; a carry that changes shape or dtype in it
    keeps the body eager); its second binds the body's inputs
    (``bound``: a copy of each carry, which the body owns from then on,
    and the read values as they are) and captures the trip in a CUDA
    graph (on the CPU: runs it on the bound values), with each new
    carry value copied into its bound tensor at the end of the trip
    (``copy_back_names``; the in-place writes, the KV caches, the
    counters and the arrays, need none); every later trip replays it.
    The body owns a copy of each carry and of each read that is not the
    scope's own tensor (a feed, a value made before the loop), and reads
    the scope's tensors (``borrowed``: the parameters) where they are.
    A later run of the loop first copies into the body's copies the
    values of this run that differ from them (the limits, a new feed),
    never into a tensor of the caller's, and reads them from there; a
    borrowed read that the scope no longer holds makes the body bind
    anew and capture again.  ``step`` is the step
    tensor the body's sampling and dropout read.  A body with an op
    that is not capturable runs every trip op by op
    (``eager_reason``)."""

    def __init__(self, sub_block, carried, reads):
        self.sub_block = sub_block
        self.carried = list(carried)
        self.reads = list(reads)
        self.eager_reason = _eager_reason(sub_block)
        self.warm = False
        self.bound = None
        self.borrowed = ()
        self.step = None
        self.graph = None
        self.captured = {}
        self.kernel_nodes = {}
        self.copy_back_names = []
        self.calls = 0

    @property
    def copy_backs(self):
        return len(self.copy_back_names)

    def rebind(self, env):
        """Bind this run's values → False, binding nothing, when a
        borrowed read is not this run's value.  Each value that is not
        its bound tensor is copied into the body's own copy, and the
        bound tensor goes into ``env``."""
        if any(env[n] is not self.bound[n] for n in self.borrowed):
            return False
        for n in self.carried + self.reads:
            v, t = env[n], self.bound[n]
            if v is not t:
                if not _same_memory(v, t):
                    t.copy_(v)
                env[n] = t
        return True

    def bind(self, env, scope):
        """Fix the body's inputs: its own copy of each carry and of each
        read that is not ``scope``'s tensor of that name, the scope's
        tensor itself for the others."""
        self.borrowed = tuple(n for n in self.reads
                              if scope.has(n) and scope.get(n) is env[n])
        self.bound = {n: env[n] if n in self.borrowed else env[n].clone()
                      for n in self.carried + self.reads}
        env.update(self.bound)

    def trip(self, run_block):
        """One trip on the bound values, the carries' new values copied
        into their bound tensors."""
        e = dict(self.bound)
        run_block(self.sub_block, e, False)
        self.copy_back_names = _copy_back(
            self.bound, e, self.carried,
            "while body: %r changes from %s to %s in a trip; a captured "
            "body keeps each carry's shape and dtype")


class _Loops:
    """The runner of the ``while`` bodies of one eager run
    (``ctx.loops``): their :class:`_LoopBody` entries live in the
    executor's cache, under the key of the program, its version, the
    body's block, the scope, the shapes and dtypes of what the body
    reads, and the flags.  ``statics`` holds the ids of the bound
    tensors the run's loops left in the environment (a fetch of one is
    returned as a copy, since the next run writes it)."""

    def __init__(self, exe, scope):
        self.exe = exe
        self.scope = scope
        self.statics = set()

    def run(self, op, block, sub_block, env, carried, cond_name, ctx,
            run_block):
        """Run the loop on ``env`` (the body's environment, ``carried``
        bound in it when the loop ends) → the run's record."""
        exe = self.exe
        reads = [n for n in _cf.sub_block_external_reads(sub_block)
                 if n not in carried and n in env]
        program = block.program
        key = (id(program), program._version, "while", sub_block.idx,
               id(self.scope),
               tuple((n, _sig(env[n])) for n in carried + reads),
               core.flags_key())
        entry = exe._cache.get(key)
        if entry is None:
            entry = exe._cache[key] = _LoopBody(sub_block, carried, reads)
        entry.calls += 1
        rec = {"trips": 0, "cond_reads": 0, "eager_trips": 0,
               "captured_trips": 0, "replayed_trips": 0,
               "start_s": time.perf_counter()}
        outer_step = ctx.step
        if entry.step is None:
            entry.step = outer_step.clone()
        else:
            entry.step.copy_(outer_step)
        ctx._step = entry.step
        try:
            if entry.bound is not None and not entry.rebind(env):
                entry.bound = entry.graph = None  # binds anew below
            while True:
                rec["cond_reads"] += 1
                if not _cf.host_true(env[cond_name]):
                    break
                if entry.eager_reason is not None or not entry.warm:
                    self._eager_trip(entry, env, run_block)
                    rec["eager_trips"] += 1
                elif entry.bound is None:
                    entry.bind(env, self.scope)
                    try:
                        self._capture(entry, run_block)
                    except BaseException:
                        entry.bound = None  # the next run binds anew
                        raise
                    rec["captured_trips"] += 1
                else:
                    self._replay(entry, run_block)
                    rec["replayed_trips"] += 1
                rec["trips"] += 1
        finally:
            ctx._step = outer_step
        if entry.bound is not None:
            self.statics.update(id(entry.bound[n]) for n in entry.carried)
        rec["copy_backs"] = list(entry.copy_back_names)
        rec["wall_ms"] = (time.perf_counter() - rec["start_s"]) * 1000.0
        if entry.eager_reason is not None:
            rec["mode"] = "eager"
            rec["reason"] = "the body's " + entry.eager_reason
        elif exe.device.type == "cuda":
            rec["mode"] = "graph"
            rec["reason"] = "trips replayed from the body's CUDA graph"
        else:
            rec["mode"] = "graph"
            rec["reason"] = "no CUDA graph on %s: the body ran on its " \
                "bound tensors" % exe.device
        return rec

    def _eager_trip(self, entry, env, run_block):
        """A trip op by op: the warm-up on the side stream (a carry that
        changes shape or dtype keeps the body eager), or every trip of
        a body that cannot be captured."""
        exe = self.exe
        before = {n: _sig(env[n]) for n in entry.carried}
        if entry.eager_reason is None and exe.device.type == "cuda":
            cur = torch.cuda.current_stream(exe.device)
            side = exe._side_stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                run_block(entry.sub_block, env, False)
            cur.wait_stream(side)
        else:
            run_block(entry.sub_block, env, False)
        if entry.eager_reason is None:
            entry.warm = True
            for n in entry.carried:
                if _sig(env[n]) != before[n]:
                    entry.eager_reason = (
                        "carry %r changes from %s to %s in a trip"
                        % (n, before[n], _sig(env[n])))
                    break

    def _capture(self, entry, run_block):
        """The body's trip captured, then replayed (on the CPU: the trip
        run on the bound values, which every later trip does again)."""
        if self.exe.device.type != "cuda":
            entry.trip(run_block)
            return
        self.exe._capture_graph(entry, lambda: entry.trip(run_block))
        _replay(entry)

    def _replay(self, entry, run_block):
        if self.exe.device.type != "cuda":  # no graph: run the trip itself
            entry.trip(run_block)
            return
        _replay(entry)


def _register_compile_telemetry(entry, program, feed, fetch_names):
    """At a key's first call (the reference's :239-270): the cost model's
    prediction of ``program`` registered with the drift monitor, and the
    program's collective schedule installed as per-ring gauges.  Telemetry
    never breaks a run: analysis that fails leaves the entry without a
    drift key; skipped with telemetry off."""
    from .observability.metrics import telemetry_enabled

    entry.drift_key = None
    if not telemetry_enabled():
        return
    from .observability import drift as _drift
    from .static_analysis.distributed import extract_collective_schedule

    batch = None
    for v in feed.values():
        shape = getattr(v, "shape", None)
        if shape:
            batch = int(shape[0])
            break
    key = _drift.monitor().register_program(
        program, batch_size=batch, targets=fetch_names)
    entry.drift_key = key
    if key is not None:
        try:
            schedule = extract_collective_schedule(program, batch_size=batch)
        except Exception:  # noqa: BLE001 - telemetry never breaks a run
            return
        _obs.set_collective_schedule(schedule, drift_key=key)


class Executor:
    """``Executor(place).run(program, feed, fetch_list)``.  The place
    defaults to ``CUDAPlace(0)``; pass ``CPUPlace()`` for the CPU.  A CUDA
    place raises at construction when no CUDA device is available."""

    def __init__(self, place=None):
        self.place = place if place is not None else core.CUDAPlace(0)
        self.device = core.as_torch_device(self.place)
        if self.device.type == "cuda":
            core.full_float32_products()
        self._step = 0
        self._cache = {}
        # (id(source program), fetch names) → id of the program its
        # last call ran (the fusion clone, or the program itself)
        self._resolved = {}
        self._lock = threading.RLock()
        self._stream = None
        self._pool = None
        self.last_run_mode = None
        self.last_run_reason = None
        self.last_loops = []

    def close(self):
        with self._lock:
            self._cache.clear()
            self._resolved.clear()

    @property
    def graph_count(self):
        """Captured CUDA graphs held by this executor's cache."""
        return sum(1 for e in self._cache.values() if e.graph is not None)

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name="feed", fetch_var_name="fetch", scope=None,
            return_numpy=True, use_program_cache=True, use_prune=False,
            verify=False):
        from .static_analysis import fusion as _fusion

        if program is None:
            program = default_main_program()
        if verify:
            # the reference's debug hook (executor.py:1114-1130): the
            # whole battery over the program before the step; it changes
            # neither what the step computes nor how it runs
            from .static_analysis import assert_valid

            assert_valid(
                program,
                targets=[v.name if isinstance(v, Variable) else str(v)
                         for v in (fetch_list or [])],
                header="Executor.run(verify=True): program failed "
                       "verification:")
        if scope is None:
            scope = global_scope()
        self.last_loops = []
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        source = program
        program, _report = _fusion.resolve_fused_program(
            program, targets=fetch_names)
        feed = {n: _host_value(v) for n, v in (feed or {}).items()}
        _check_feed_shapes(program, feed)
        if not use_program_cache:
            _obs.record_jit_cache(False)
            return self._step_call(
                lambda: (lambda: self._run_eager(
                    program, scope, feed, fetch_names,
                    "use_program_cache=False"), "uncached", None),
                return_numpy, lock=False)
        if core.get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"]:
            return self._step_call(
                lambda: (lambda: self._run_eager(
                    program, scope, feed, fetch_names,
                    "FLAGS_check_nan_inf: every op's outputs are checked, "
                    "which a captured graph cannot stop at"), None, None),
                return_numpy, lock=False)
        key = (id(program), program._version, id(scope),
               # a staged tensor and a host array of one dtype share a key
               tuple((n, tuple(v.shape), str(v.dtype).replace("torch.", ""))
                     for n, v in sorted(feed.items())),
               tuple(fetch_names), getattr(program, "_fusion_sig", None),
               core.flags_key())
        return self._step_call(
            lambda: self._choose(key, source, program, scope, feed,
                                 fetch_names),
            return_numpy)

    def _choose(self, key, source, program, scope, feed, fetch_names):
        """Under the lock: the cache entry of ``key`` and what this call
        of it runs, as ``(dispatch, compile_phase, drift_key)``."""
        slot = (id(source), tuple(sorted(fetch_names)))
        prev = self._resolved.get(slot)
        if prev is not None and prev != id(program):
            # a newer clone of this program replaced ``prev``: its
            # entries, and the graphs they hold, are not run again
            for k in [k for k in self._cache if k[0] == prev]:
                del self._cache[k]
        self._resolved[slot] = id(program)
        entry = self._cache.get(key)
        if entry is not None and entry.reads is not None \
                and not entry.rebind(scope):
            entry = None  # a scope var changed shape or dtype
        _obs.record_jit_cache(entry is not None)
        if entry is None:
            entry = self._cache[key] = _CompiledBlock(
                program, list(feed), fetch_names)
            _register_compile_telemetry(entry, program, feed, fetch_names)
        entry.calls += 1
        if entry.eager_reason is not None:
            return (lambda: self._run_eager(program, scope, feed, fetch_names,
                                            entry.eager_reason, loops=True),
                    "warm-up" if entry.calls == 1 else None,
                    entry.drift_key)
        if entry.calls == 1:
            return (lambda: self._warm_up(program, scope, feed, fetch_names),
                    "warm-up", entry.drift_key)
        return (lambda: self._run_compiled(entry, program, scope, feed),
                "capture" if entry.reads is None else None, entry.drift_key)

    def _step_call(self, choose, return_numpy, lock=True):
        """One step with the reference's telemetry.  ``choose()`` returns
        ``(dispatch, compile_phase, drift_key)``: ``dispatch()`` enqueues
        the step and returns its fetches, ``compile_phase`` names a call
        that is its key's compile (module docstring), ``drift_key`` is
        the entry's drift monitor key.  With ``lock`` both run under the
        executor's lock; the fetches are read after it."""
        cur_step = self._step
        t_step = time.perf_counter()
        step_span = (_tr.span("executor.step", step=cur_step)
                     if _tr.sample_step(cur_step) else _tr.NULL_SPAN)
        if step_span.recording:
            for ring, shape in _obs.collective_step_shape().items():
                step_span.set_attr(ring, shape)
        with step_span, _prof.record_event("executor.run"):
            with self._lock if lock else contextlib.nullcontext():
                dispatch, compile_phase, drift_key = choose()
                compile_span = (_tr.span("executor.compile", step=cur_step,
                                         phase=compile_phase)
                                if compile_phase is not None
                                else contextlib.nullcontext())
                compile_event = (_prof.record_event("executor.lower_and_jit")
                                 if compile_phase is not None else _NO_EVENT)
                with compile_span, compile_event:
                    with _tr.span_if_traced("executor.dispatch"):
                        fetches = dispatch()
            dispatch_ms = (time.perf_counter() - t_step) * 1000.0
            if compile_phase is not None:
                _obs.record_compile(dispatch_ms)
            result = self._finish(fetches, return_numpy)
        _obs.record_step("executor", cur_step,
                         (time.perf_counter() - t_step) * 1000.0,
                         dispatch_ms=dispatch_ms, drift_key=drift_key)
        return result

    def _run_compiled(self, entry, program, scope, feed):
        """The second call of a key (capture) or a later one (replay);
        returns the fetches, cloned out of the graph's memory."""
        step = self._next_step()
        if entry.reads is None:
            fetches, fresh = self._capture(entry, program, scope, feed, step)
        else:
            fetches, fresh = self._replay(entry, program, scope, feed, step)
        fetches = [t.clone() for t in fetches]
        for n, t in fresh.items():
            if not entry.block.vars[n].is_data:
                scope.set(n, t.clone())
        # the fresh values are no read of this entry's
        entry.generation = scope.generation
        return fetches

    def _next_step(self):
        step = self._step
        self._step += 1
        return step

    def _context(self, program, scope, step, step_tensor):
        return op_registry.LoweringContext(
            seed=(program.random_seed or 0) * 1000003 + step,
            mode="train", device=self.device,
            program_seed=program.random_seed or 0, rings=scope.rings,
            step=step_tensor)

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _capture_graph(self, entry, fn):
        """Capture ``fn()`` on the side stream into a CUDA graph in the
        executor's pool and instantiate it → what ``fn`` returned.  Sets
        ``entry.graph``, ``entry.captured`` (the launches the wrappers
        recorded into it, by kernel) and ``entry.kernel_nodes`` (its
        kernel nodes by kernel, as libcuda lists them)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = _kernels.launch_counts_by_source()["captured"]
        # keep_graph: the graph's nodes stay readable after capture
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, pool=self._pool,
                              stream=self._side_stream(),
                              capture_error_mode="thread_local"):
            out = fn()
        graph.instantiate()
        after = _kernels.launch_counts_by_source()["captured"]
        entry.captured = {k: after[k] - before[k] for k in after
                          if after[k] != before[k]}
        entry.kernel_nodes = _kernels.graph_kernel_nodes(graph)
        entry.graph = graph
        return out

    def _warm_up(self, program, scope, feed, fetch_names):
        """The first call for a key: eager, on the side stream that the
        capture will use, so everything made on first use is made for
        it."""
        reason = "warm-up: the first call for this key"
        if self.device.type != "cuda":
            return self._run_eager(program, scope, feed, fetch_names, reason)
        cur = torch.cuda.current_stream(self.device)
        side = self._side_stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self._run_eager(program, scope, feed, fetch_names, reason)
        cur.wait_stream(side)
        return out

    def _capture(self, entry, program, scope, feed, step):
        """The second call for a key: bind the step's inputs, capture it
        (on the CPU: run it) and replay it."""
        feed_vals = {n: np_to_torch(v, self.device) for n, v in feed.items()}
        entry.bind(scope, feed_vals, self.device)
        entry.step = torch.full((1,), step, dtype=torch.int64,
                                device=self.device)
        ctx = self._context(program, scope, step, entry.step)
        if self.device.type != "cuda":
            fetches, fresh = entry.trace(ctx)
            self.last_run_mode = "capture"
            self.last_run_reason = "no CUDA graph on %s: the step ran " \
                "on its static inputs" % self.device
        else:
            entry.fetches, entry.fresh = self._capture_graph(
                entry, lambda: entry.trace(ctx))
            _replay(entry)
            fetches, fresh = entry.fetches, entry.fresh
            self.last_run_mode = "capture"
            self.last_run_reason = "captured the step, then replayed it"
        return fetches, fresh

    def _replay(self, entry, program, scope, feed, step):
        entry.stage(feed)
        entry.step.fill_(step)
        if entry.graph is None:  # the CPU: run the step itself
            fetches, fresh = entry.trace(
                self._context(program, scope, step, entry.step))
            self.last_run_mode = "graph"
            self.last_run_reason = "no CUDA graph on %s: the step ran " \
                "on its static inputs" % self.device
            return fetches, fresh
        _replay(entry)
        self.last_run_mode = "graph"
        self.last_run_reason = "replayed the captured step"
        return entry.fetches, entry.fresh

    def _run_eager(self, program, scope, feed, fetch_names, reason,
                   loops=False):
        """The block op by op, its persistable outputs written back to the
        scope (the in-place updates leave the resident tensors there); the
        fetches.  A fetch that is a scope tensor is returned as a copy,
        since later steps update the scope's tensors in place, and a fed
        tensor that an op writes in place is copied first, so a caller's
        (or a feed cache's) tensor is never written.  With ``loops`` a
        ``while`` body runs through the cached :class:`_LoopBody` entries
        (from its second trip as a CUDA graph); ``last_loops`` then holds
        one record a loop run and ``last_run_reason`` sums them up."""
        self.last_run_mode, self.last_run_reason = "eager", reason
        block = program.global_block()
        written = _in_place_writes(block)
        feed_vals = {}
        for n, v in feed.items():
            t = np_to_torch(v, self.device)
            if n in written and t is v:
                t = t.clone()
            feed_vals[n] = t
        env = {}
        for op in _ops_with_regions(block, sub_block_ops=True):
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
        step = self._next_step()
        ctx = self._context(program, scope, step, torch.full(
            (1,), step, dtype=torch.int64, device=self.device))
        if loops:
            ctx.loops = _Loops(self, scope)
        check = core.get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"]
        try:
            with torch.no_grad():
                _run_ops_into_env(block, env, ctx, check_nan_inf=bool(check),
                                  fetch_names=fetch_names)
        finally:
            ctx.tape.clear()  # graphs of forwards whose grads were not run
        self.last_loops = ctx.loop_runs
        for rec in ctx.loop_runs:
            self.last_run_reason += (
                "; while op %s: %d trips (%d eager, %d captured, %d "
                "replayed), %d condition reads, body %s: %s"
                % (rec["op"], rec["trips"], rec["eager_trips"],
                   rec.get("captured_trips", 0),
                   rec.get("replayed_trips", 0), rec["cond_reads"],
                   rec["mode"], rec["reason"]))
        for v in block.vars.values():
            if v.persistable and not v.is_data and v.name in env:
                scope.set(v.name, env[v.name])
        fetches = []
        for n in fetch_names:
            if n not in env and not scope.has(n):
                raise RuntimeError("fetch target %r was not produced by the "
                                   "program and is not in the scope" % n)
            fetches.append(env[n] if n in env else scope.get(n))
        state = {id(scope.get(n)) for n in fetch_names if scope.has(n)}
        if ctx.loops is not None:
            state |= ctx.loops.statics
        return [t.clone() if id(t) in state else t for t in fetches]

    @staticmethod
    def _finish(fetches, return_numpy):
        if return_numpy:
            return _pipeline.host_values(fetches)
        return [v if isinstance(v, FetchHandle) else FetchHandle(v)
                for v in fetches]
