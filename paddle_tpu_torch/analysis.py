"""Inference analysis pass pipeline (mirrors ``paddle_tpu/analysis.py``).

``PassBuilder`` with the same ``DEFAULT`` pipeline (``conv_bn_fuse_pass``,
``fc_fuse_pass``, ``dead_code_elimination_pass``) and the ``Analyzer``
that runs it.  The reference brackets every pass with ``verify_pass``;
the verifier is not ported yet (ROADMAP.md), so ``Analyzer.run`` runs
unverified and raises ``NotImplementedError`` when ``verify=True`` is
asked for, rather than skipping the check silently."""

__all__ = ["register_pass", "get_pass", "PassBuilder", "Analyzer",
           "fc_fuse_pass", "dead_code_elimination_pass",
           "conv_bn_fuse_pass"]

_PASSES = {}


def register_pass(name):
    def deco(fn):
        _PASSES[name] = fn
        return fn

    return deco


def get_pass(name):
    return _PASSES[name]


@register_pass("conv_bn_fuse_pass")
def conv_bn_fuse_pass(program, scope=None, targets=None):
    """Fold batch-norm statistics into conv weights (a numeric rewrite of
    the weights in ``scope``)."""
    from .inference import fuse_conv_bn

    if scope is None:
        from .executor import global_scope

        scope = global_scope()
    fuse_conv_bn(program, scope)
    return program


@register_pass("fc_fuse_pass")
def fc_fuse_pass(program, scope=None, targets=None):
    """mul + elementwise_add(bias) → one fc op, when the mul output has
    exactly one consumer (the add) and the add's Y is a 1-D persistable
    bias broadcast over the last dim.  The consumer map is rebuilt after
    every fusion, and sub-block reads count as consumers."""
    from .framework import Operator
    from .static_analysis.defuse import (resolve_sub_block,
                                         sub_block_reads_recursive)

    block = program.global_block()
    closure_reads = {}
    for o in block.ops:
        sub = resolve_sub_block(program, o, host_block_idx=block.idx)
        if sub is not None:
            closure_reads[id(o)] = sub_block_reads_recursive(program, sub)

    def build_consumers():
        consumers = {}
        for o in block.ops:
            for n in o.input_arg_names:
                consumers.setdefault(n, []).append(o)
            for n in closure_reads.get(id(o), ()):
                consumers.setdefault(n, []).append(o)
        return consumers

    consumers = build_consumers()
    fused = 0
    i = 0
    while i < len(block.ops):
        op = block.ops[i]
        if op.type != "mul" or int(op.attrs.get("y_num_col_dims", 1)) != 1:
            i += 1
            continue
        out = op.outputs["Out"][0]
        if targets and out in targets:
            i += 1
            continue
        cons = consumers.get(out, [])
        if len(cons) != 1 or cons[0].type != "elementwise_add":
            i += 1
            continue
        add = cons[0]
        if add.inputs.get("X", [None])[0] != out:
            i += 1
            continue
        axis = int(add.attrs.get("axis", -1))
        if axis not in (-1, int(op.attrs.get("x_num_col_dims", 1))):
            i += 1
            continue
        bias_name = add.inputs.get("Y", [None])[0]
        bias_var = block._find_var_recursive(bias_name)
        if bias_var is None or not bias_var.persistable \
                or len(bias_var.shape or ()) != 1:
            i += 1
            continue
        j = block.ops.index(add)
        if j <= i:
            i += 1
            continue
        block.ops[i] = Operator(
            block, "fc",
            {"Input": list(op.inputs["X"]), "W": list(op.inputs["Y"]),
             "Bias": [bias_name]},
            {"Out": list(add.outputs["Out"])},
            {"in_num_col_dims": int(op.attrs.get("x_num_col_dims", 1))},
        )
        del block.ops[j]
        fused += 1
        consumers = build_consumers()
        i += 1
    if fused:
        program._bump_version()
    return program


@register_pass("dead_code_elimination_pass")
def dead_code_elimination_pass(program, scope=None, targets=None):
    """Remove ops whose outputs never reach the targets; ops writing a
    persistable var, and sub-block reads of kept ops, stay live."""
    if not targets:
        return program
    from .static_analysis.defuse import (resolve_sub_block,
                                         sub_block_reads_recursive)

    block = program.global_block()
    needed = set(targets)
    keep = []
    for op in reversed(block.ops):
        outs = set(op.output_arg_names)
        writes_persistable = any(
            (v := block._find_var_recursive(n)) is not None and v.persistable
            for n in outs)
        if outs & needed or writes_persistable or op.type in (
                "feed", "fetch", "print"):
            keep.append(op)
            needed.update(op.input_arg_names)
            sub = resolve_sub_block(program, op, host_block_idx=block.idx)
            if sub is not None:
                needed.update(sub_block_reads_recursive(program, sub))
    if len(keep) != len(block.ops):
        block.ops[:] = list(reversed(keep))
        program._bump_version()
    return program


class PassBuilder:
    """Mutable pass pipeline (reference paddle_pass_builder.h)."""

    DEFAULT = ["conv_bn_fuse_pass", "fc_fuse_pass",
               "dead_code_elimination_pass"]

    def __init__(self, passes=None):
        self._passes = list(passes if passes is not None else self.DEFAULT)

    def all_passes(self):
        return list(self._passes)

    def append_pass(self, name):
        self._passes.append(name)

    def delete_pass(self, name):
        self._passes = [p for p in self._passes if p != name]

    def insert_pass(self, idx, name):
        self._passes.insert(idx, name)


class Analyzer:
    """Run the configured pipeline over a program."""

    def __init__(self, pass_builder=None):
        self._builder = pass_builder or PassBuilder()

    def run(self, program, scope=None, targets=None, verify=False):
        if verify:
            raise NotImplementedError(
                "Analyzer.run(verify=True) brackets every pass with the "
                "static-analysis verifier, which is not ported yet "
                "(ROADMAP.md, Queue A item 3: static-analysis gates); pass "
                "verify=False")
        for name in self._builder.all_passes():
            program = get_pass(name)(program, scope=scope, targets=targets)
        return program
