"""Graph-construction core: Program ⊃ Block ⊃ {Variable, Operator}.

Mirrors ``paddle_tpu/framework.py`` with the same IR, attrs and clone
semantics, so the same model-builder code builds the same program in
both packages.  Shape/dtype inference for an appended op runs the op's
registered PyTorch lowering on ``device="meta"`` tensors (no data, no
compute), with -1 dims replaced by sentinel primes exactly as the
reference replaces them for ``jax.eval_shape``
(:data:`_SHAPE_SENTINELS`).
"""

import contextlib
import itertools

import numpy as np

from . import core
from . import unique_name

_op_id_counter = itertools.count(1)

__all__ = [
    "Program",
    "Block",
    "Operator",
    "Variable",
    "Parameter",
    "default_main_program",
    "default_startup_program",
    "switch_main_program",
    "switch_startup_program",
    "program_guard",
    "name_scope",
    "cpu_places",
    "cuda_places",
    "tpu_places",
    "device_places",
    "CLONE_VAR_MARKS",
]

GRAD_VAR_SUFFIX = "@GRAD"

# Sentinel dims standing in for -1 (batch) dims during meta-tensor shape
# inference; any output dim equal to a sentinel maps back to -1.  Recorded
# static shapes are graph-construction metadata only — execution always
# runs on the concrete feed shapes.
_SHAPE_SENTINELS = (100003, 100019, 100043, 100057, 100069, 100103, 100109)


def grad_var_name(name):
    return name + GRAD_VAR_SUFFIX


_name_scope_stack = []


@contextlib.contextmanager
def name_scope(prefix=None):
    _name_scope_stack.append(prefix or "")
    try:
        yield
    finally:
        _name_scope_stack.pop()


class Variable:
    """A tensor-valued symbolic variable in a Block."""

    def __init__(
        self,
        block,
        name=None,
        shape=None,
        dtype="float32",
        lod_level=0,
        persistable=False,
        stop_gradient=False,
        is_data=False,
        type=core.VarDesc.VarType.LOD_TENSOR,
        need_check_feed=False,
        **kwargs,
    ):
        self.block = block
        if name is None:
            name = unique_name.generate("_generated_var")
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = core.convert_np_dtype_to_dtype_(dtype) if dtype is not None else None
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.type = type
        self.need_check_feed = need_check_feed
        self.feed_hint = None
        self.op = None

    def numpy_dtype(self):
        if self.dtype == "bfloat16":
            import ml_dtypes

            return ml_dtypes.bfloat16
        return np.dtype(self.dtype)

    def torch_dtype(self):
        return core.torch_dtype(self.dtype)

    @property
    def grad_name(self):
        return grad_var_name(self.name)

    def __str__(self):
        return "Variable(name=%s, shape=%s, dtype=%s, persistable=%s)" % (
            self.name, self.shape, self.dtype, self.persistable)

    __repr__ = __str__


class Parameter(Variable):
    """A persistable, trainable Variable."""

    def __init__(self, block, shape, dtype, **kwargs):
        self.trainable = kwargs.pop("trainable", True)
        self.optimize_attr = kwargs.pop("optimize_attr", {"learning_rate": 1.0})
        self.regularizer = kwargs.pop("regularizer", None)
        self.gradient_clip_attr = kwargs.pop("gradient_clip_attr", None)
        self.do_model_average = kwargs.pop("do_model_average", None)
        self.is_distributed = kwargs.pop("is_distributed", False)
        self.shard_spec = kwargs.pop("shard_spec", None)
        super().__init__(block, shape=shape, dtype=dtype, persistable=True,
                         **kwargs)
        self.stop_gradient = False


class Operator:
    """One node in a Block: type + named input/output slots (each a list
    of var names) + attrs."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.attrs = dict(attrs) if attrs else {}

        def _canon(slots):
            out = {}
            for slot, vs in (slots or {}).items():
                if vs is None:
                    continue
                if not isinstance(vs, (list, tuple)):
                    vs = [vs]
                out[slot] = [v.name if isinstance(v, Variable) else v for v in vs]
            return out

        self.inputs = _canon(inputs)
        self.outputs = _canon(outputs)
        # per-program op ids: unique within the program (RNG seeding) yet
        # reproducible across separate builds of the same graph
        program = block.program if block is not None else None
        if program is None:
            self.attrs.setdefault("__op_id__", next(_op_id_counter))
        elif "__op_id__" in self.attrs:
            program._note_op_id(self.attrs["__op_id__"])
        else:
            self.attrs["__op_id__"] = program._next_op_id()
        if _name_scope_stack:
            self.attrs.setdefault("op_namescope", "/".join(_name_scope_stack))

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    @property
    def output_arg_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    def input_names(self):
        return list(self.inputs)

    def output_names(self):
        return list(self.outputs)

    def has_attr(self, name):
        return name in self.attrs

    def attr(self, name):
        return self.attrs.get(name)

    def _set_attr(self, name, val):
        self.attrs[name] = val
        self.block.program._bump_version()

    def __repr__(self):
        return "Operator(%s: %s -> %s)" % (self.type, self.inputs, self.outputs)


class Block:
    """An ordered op list plus a var table, with a parent link."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}
        self.ops = []

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    def create_var(self, **kwargs):
        name = kwargs.get("name")
        if name is not None and name in self.vars:
            return self.vars[name]
        v = Variable(self, **kwargs)
        self.vars[v.name] = v
        self.program._bump_version()
        return v

    def create_parameter(self, **kwargs):
        # parameters always live in block 0
        global_block = self.program.global_block()
        prev = global_block.vars.get(kwargs.get("name"))
        p = Parameter(global_block, **kwargs)
        if getattr(p, "shard_spec", None) is None:
            p.shard_spec = getattr(prev, "shard_spec", None)
        global_block.vars[p.name] = p
        self.program._bump_version()
        return p

    def var(self, name):
        v = self.vars.get(name)
        if v is None:
            raise ValueError("Variable %r not found in block %d" % (name, self.idx))
        return v

    def has_var(self, name):
        return name in self.vars

    def _find_var_recursive(self, name):
        b = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent_block
        return None

    def var_recursive(self, name):
        v = self._find_var_recursive(name)
        if v is None:
            raise ValueError("Variable %r not found (recursive)" % name)
        return v

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type=None, inputs=None, outputs=None, attrs=None,
                  stop_gradient=False):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump_version()
        self._infer_shapes(op)
        for slot_vs in op.outputs.values():
            for name in slot_vs:
                v = self._find_var_recursive(name)
                if v is not None:
                    v.op = op
                    if stop_gradient:
                        v.stop_gradient = True
        return op

    def _insert_op(self, index, type=None, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        self.program._bump_version()
        self._infer_shapes(op)
        return op

    def _prepend_op(self, **kwargs):
        return self._insert_op(0, **kwargs)

    def _remove_op(self, index):
        del self.ops[index]
        self.program._bump_version()

    def _infer_shapes(self, op):
        """Static shape/dtype inference: the op's lowering on meta
        tensors (replaces the reference's ``jax.eval_shape``)."""
        if op.type.endswith("_grad") or op.type in ("feed", "fetch"):
            return
        from .ops import registry

        try:
            registry.infer_shapes(op, self)
        except registry.OpNotRegistered:
            pass

    def __repr__(self):
        return "Block(idx=%d, ops=%d, vars=%d)" % (
            self.idx, len(self.ops), len(self.vars))


# per-var attrs Program.clone() must preserve (execution semantics
# depend on them); the same roster as the reference package
CLONE_VAR_MARKS = ("need_check_feed", "feed_hint",
                   "_is_optimizer_state", "_is_distributed",
                   "shard_spec")


# program-level marks clone() preserves (the reference's
# CLONE_PROGRAM_MARKS, as far as the port reads them): the gradient
# allreduce's bucket cap and quantization mark.  Deliberately not
# _num_trainers / _trainer_id, which place one worker in a topology; the
# fusion pipeline carries those to its resolved clone itself.
CLONE_PROGRAM_MARKS = ("_allreduce_bucket_mb", "_quant_buckets")


class Program:
    """A list of Blocks; block 0 is the global block.  Data-parallel
    marks, read with ``getattr`` and unset by default as in the
    reference: ``_num_trainers`` (ranks), ``_allreduce_bucket_mb`` (the
    bucket cap of the fusion ``allreduce`` family) and
    ``_quant_buckets`` (``{"min_bytes": …}``, the int8 exchange's
    engagement threshold)."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self._seed = 0
        self._version = 0
        self._current_role = "forward"
        self.random_seed = 0
        self._is_start_up_program = False
        self._last_op_id = 0

    def _next_op_id(self):
        self._last_op_id += 1
        return self._last_op_id

    def _note_op_id(self, op_id):
        self._last_op_id = max(self._last_op_id, int(op_id))

    def _bump_version(self):
        self._version += 1

    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def block(self, idx):
        return self.blocks[idx]

    @property
    def num_blocks(self):
        return len(self.blocks)

    def _create_block(self, parent_idx=None):
        parent = self.current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent_idx=parent)
        self.blocks.append(b)
        self.current_block_idx = b.idx
        self._bump_version()
        return b

    def _rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def all_parameters(self):
        return self.global_block().all_parameters()

    def to_string(self, throw_on_error=True, with_details=False):
        import json as _json

        from .proto import program_to_dict

        return _json.dumps(program_to_dict(self), indent=2)

    @staticmethod
    def parse_from_string(s):
        import json as _json

        from .proto import program_from_dict

        return program_from_dict(_json.loads(s))

    def clone(self, for_test=False):
        """Deep-copy the program.  With for_test=True, drop the
        backward/optimize tail and flip is_test on dropout/norm-style
        ops (the reference's ``Program.clone``)."""
        p = Program()
        p.random_seed = self.random_seed
        for mark in CLONE_PROGRAM_MARKS:
            if hasattr(self, mark):
                setattr(p, mark, getattr(self, mark))
        p.blocks = [Block(p, b.idx, b.parent_idx) for b in self.blocks]
        for b, nb in zip(self.blocks, p.blocks):
            for name, v in b.vars.items():
                if isinstance(v, Parameter):
                    nv = Parameter(
                        nb, shape=v.shape, dtype=v.dtype, name=v.name,
                        trainable=v.trainable, optimize_attr=v.optimize_attr,
                        regularizer=v.regularizer,
                        stop_gradient=v.stop_gradient,
                    )
                    nv.shard_spec = getattr(v, "shard_spec", None)
                else:
                    nv = Variable(
                        nb, name=v.name, shape=v.shape, dtype=v.dtype,
                        lod_level=v.lod_level, persistable=v.persistable,
                        stop_gradient=v.stop_gradient, is_data=v.is_data,
                        type=v.type,
                    )
                for mark in CLONE_VAR_MARKS:
                    if hasattr(v, mark):
                        setattr(nv, mark, getattr(v, mark))
                nb.vars[name] = nv
            for op in b.ops:
                if for_test and b.idx == 0 and op.attrs.get(
                        "op_role") in ("backward", "optimize", "lr_sched"):
                    continue
                no = Operator(
                    nb, op.type,
                    {k: list(v) for k, v in op.inputs.items()},
                    {k: list(v) for k, v in op.outputs.items()},
                    dict(op.attrs),
                )
                if for_test and ("is_test" in no.attrs or op.type in (
                        "dropout", "batch_norm", "layer_norm",
                        "fused_multihead_attention",
                        "fused_dropout_add_ln", "fused_conv_bn_act")):
                    no.attrs["is_test"] = True
                nb.ops.append(no)
        p.current_block_idx = 0
        p._bump_version()
        return p

    def _prune(self, feeded_var_names, targets):
        """Prune block 0 to the subgraph producing ``targets`` from
        ``feeded_var_names``; returns a pruned clone."""
        p = self.clone()
        b = p.global_block()
        target_names = set(
            t.name if isinstance(t, Variable) else t for t in targets)
        feeds = set(feeded_var_names)
        needed = set(target_names)
        keep = []
        for op in reversed(b.ops):
            if needed & set(op.output_arg_names):
                keep.append(op)
                for n in op.input_arg_names:
                    if n not in feeds:
                        needed.add(n)
        b.ops = list(reversed(keep))
        referenced = set(feeds) | target_names
        for op in b.ops:
            referenced.update(op.input_arg_names)
            referenced.update(op.output_arg_names)
        b.vars = {n: v for n, v in b.vars.items() if n in referenced}
        p._bump_version()
        return p

    def __repr__(self):
        return "Program(blocks=%d, version=%d)" % (len(self.blocks), self._version)


_main_program_ = Program()
_startup_program_ = Program()
_startup_program_._is_start_up_program = True


def default_main_program():
    return _main_program_


def default_startup_program():
    return _startup_program_


def switch_main_program(program):
    global _main_program_
    old = _main_program_
    _main_program_ = program
    return old


def switch_startup_program(program):
    global _startup_program_
    old = _startup_program_
    _startup_program_ = program
    return old


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)


def cpu_places(device_count=None):
    return [core.CPUPlace(i) for i in range(device_count or 1)]


def cuda_places(device_ids=None):
    import torch

    if device_ids is None:
        device_ids = range(torch.cuda.device_count())
    return [core.CUDAPlace(i) for i in device_ids]


tpu_places = cuda_places


def device_places(device_ids=None):
    return cuda_places(device_ids)
