"""Private copies of the two def/use helpers the ported passes call
(mirrors ``paddle_tpu/static_analysis/defuse.py``: ``resolve_sub_block``
:43, ``sub_block_reads_recursive`` :68, and
``paddle_tpu/ops/control_flow.py``'s ``sub_block_external_reads`` :65).
The port has no control-flow ops yet, so these only matter for programs
exported by the reference package with sub-blocks; they let the passes
refuse to fuse a var a sub-block reads, as the reference does."""

from ..ops.registry import EMPTY_VAR_NAME

SUB_BLOCK_DESCENT_OPS = ("while", "conditional_block", "recurrent",
                         "recompute_block")


def resolve_sub_block(program, op, host_block_idx=None):
    """The Block ``op.attrs["sub_block"]`` names, or None when absent,
    out of range, or self-referential."""
    idx = op.attrs.get("sub_block")
    if not isinstance(idx, int) or not 0 <= idx < program.num_blocks:
        return None
    if host_block_idx is not None and idx == host_block_idx:
        return None
    return program.block(idx)


def _machinery_defined_names(op):
    if op.type == "recurrent":
        return (list(op.attrs.get("step_input_names", []))
                + list(op.attrs.get("state_names", [])))
    return []


def _external_reads(sub_block, exclude=()):
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
    """All names a sub-block reads before writing, nested sub-blocks
    included; a sub_block cycle degrades to partial reads."""
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
                for n in sub_block_reads_recursive(
                        program, inner, set(_machinery_defined_names(op)),
                        _visited):
                    if n not in written and n not in reads:
                        reads.append(n)
        written.update(op.output_arg_names)
    return reads
