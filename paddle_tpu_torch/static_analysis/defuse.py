"""Def-use graph over ``Program ⊃ Block ⊃ Operator`` (mirrors
``paddle_tpu/static_analysis/defuse.py``, all of it, with a private copy
of ``paddle_tpu/ops/control_flow.py``'s ``sub_block_external_reads`` :65:
the port has no control-flow ops, so sub-blocks only appear in programs
exported by the reference package).

The reference gets this structure for free from ``ir::Graph`` (every var is
a node wired producer→consumer, ``paddle/fluid/framework/ir/graph.cc``); our
IR keeps ops as flat per-block lists with string-named slots, so the checks
need an explicit walk.  The walker descends into ``attrs["sub_block"]``
bodies (``while`` / ``conditional_block`` / ``recurrent`` /
``recompute_block``) in program order, threading the set of names defined so
far — a use inside a loop body of a var defined in the parent *after* the
loop op is still a use-before-def.

Grad twins (``while_grad`` …) share the forward's ``sub_block`` attr but
re-run it with their own declared inputs, so the walk does NOT descend
into them a second time.
"""

__all__ = ["VarSite", "DefUseGraph", "build_def_use",
           "sub_block_reads_recursive", "sub_block_writes_recursive",
           "resolve_sub_block", "SUB_BLOCK_DESCENT_OPS"]

# forward control-flow ops whose sub-block the walker descends into
SUB_BLOCK_DESCENT_OPS = ("while", "conditional_block", "recurrent",
                         "recompute_block")

from ..ops.registry import EMPTY_VAR_NAME


class VarSite:
    """One def or use of a var name: (block_idx, op_idx, op)."""

    __slots__ = ("block_idx", "op_idx", "op")

    def __init__(self, block_idx, op_idx, op):
        self.block_idx = block_idx
        self.op_idx = op_idx
        self.op = op

    def __repr__(self):
        return "VarSite(block=%d, op=%d, %s)" % (
            self.block_idx, self.op_idx, self.op.type)


def resolve_sub_block(program, op, host_block_idx=None):
    """The single policy for following an op's ``attrs["sub_block"]``:
    returns the sub-Block, or None when the attr is absent, non-int,
    out of range, or self-referential (malformed programs — the
    verifier's sub-block-index check reports those; walkers must
    degrade, not crash).  Callers layer their own descent-op filters
    and visited sets on top."""
    idx = op.attrs.get("sub_block")
    if not isinstance(idx, int) or not 0 <= idx < program.num_blocks:
        return None
    if host_block_idx is not None and idx == host_block_idx:
        return None
    return program.block(idx)


def _machinery_defined_names(op):
    """Names a control-flow op's runtime machinery binds inside its
    sub-block before any sub-block op runs (they have no producing op):
    the recurrent op's per-step input/state slices."""
    if op.type == "recurrent":
        return (list(op.attrs.get("step_input_names", []))
                + list(op.attrs.get("state_names", [])))
    return []


def _external_reads(sub_block, exclude=()):
    """Names ``sub_block`` reads before any of its ops writes them (one
    level)."""
    written = set(exclude)
    reads = []
    for op in sub_block.ops:
        for n in op.input_arg_names:
            if n and n != EMPTY_VAR_NAME and n not in written \
                    and n not in reads:
                reads.append(n)
        written.update(op.output_arg_names)
    return reads


def sub_block_reads_recursive(program, sub_block, exclude=(), _visited=None):
    """All names a sub-block reads before writing, including reads of
    nested sub-blocks (:func:`_external_reads` is one level;
    a conditional_block nested in a while body also captures closure
    vars that never appear on any op's input slots).  ``_visited`` guards
    against sub_block-attr cycles in malformed programs — a cycle here
    must degrade to partial reads, not a RecursionError (the verifier's
    sub-block-index check reports the cycle itself)."""
    if _visited is None:
        _visited = set()
    if sub_block.idx in _visited:
        return []
    _visited.add(sub_block.idx)
    reads = _external_reads(sub_block, exclude)
    written = set(exclude)
    for op in sub_block.ops:
        if op.type in SUB_BLOCK_DESCENT_OPS:
            inner = resolve_sub_block(program, op)
            if inner is not None and inner.idx not in _visited:
                inner_exclude = set(_machinery_defined_names(op))
                for n in sub_block_reads_recursive(program, inner,
                                                   inner_exclude, _visited):
                    if n not in written and n not in reads:
                        reads.append(n)
        written.update(op.output_arg_names)
    return reads


def sub_block_writes_recursive(program, sub_block, _visited=None):
    """All names a sub-block writes, including writes of nested
    sub-blocks — the closure-write twin of
    :func:`sub_block_reads_recursive` (the overlap scheduler's liveness
    pass needs the last DEF of a bucket member, and a while body
    updating a grad is a def no output slot of the host op shows).
    Same cycle guard: a malformed sub_block-attr cycle degrades to
    partial writes instead of a RecursionError."""
    if _visited is None:
        _visited = set()
    if sub_block.idx in _visited:
        return set()
    _visited.add(sub_block.idx)
    writes = set()
    for op in sub_block.ops:
        writes.update(n for n in op.output_arg_names
                      if n and n != EMPTY_VAR_NAME)
        if op.type in SUB_BLOCK_DESCENT_OPS:
            inner = resolve_sub_block(program, op)
            if inner is not None:
                writes |= sub_block_writes_recursive(program, inner,
                                                     _visited)
    return writes


class DefUseGraph:
    """Def/use sites per var name, in program (execution) order.

    ``defs[name]`` / ``uses[name]``: ordered lists of :class:`VarSite`.
    ``order``: flat list of (block_idx, op_idx, op) in walk order.
    ``machinery_defined``: names bound by control-flow machinery rather
    than a producing op (recurrent step inputs / states).
    ``walked_blocks``: block indices the walker visited — blocks NOT in
    this set are orphaned (no surviving control-flow op references them).
    """

    def __init__(self, program):
        self.program = program
        self.defs = {}
        self.uses = {}
        self.order = []
        self.machinery_defined = set()
        self.walked_blocks = set()
        self._walk(program.global_block())

    def _note(self, table, name, site):
        if not name or name == EMPTY_VAR_NAME:
            return
        table.setdefault(name, []).append(site)

    def _walk(self, block):
        if block.idx in self.walked_blocks:
            return  # defensive: a sub_block attr cycle must not recurse
        self.walked_blocks.add(block.idx)
        for op_idx, op in enumerate(block.ops):
            site = VarSite(block.idx, op_idx, op)
            self.order.append((block.idx, op_idx, op))
            for n in op.input_arg_names:
                self._note(self.uses, n, site)
            if op.type in SUB_BLOCK_DESCENT_OPS:
                inner = resolve_sub_block(self.program, op)
                if inner is not None:
                    self.machinery_defined.update(_machinery_defined_names(op))
                    self._walk(inner)
            for n in op.output_arg_names:
                self._note(self.defs, n, site)

    # ---- queries ----
    def producers(self, name):
        return list(self.defs.get(name, []))

    def consumers(self, name):
        return list(self.uses.get(name, []))

    def is_produced(self, name):
        return name in self.defs or name in self.machinery_defined


def build_def_use(program):
    return DefUseGraph(program)
