"""Sub-block ops (mirrors ``paddle_tpu/ops/control_flow.py``:
``SUB_BLOCK_OPS`` :22, ``sub_block_external_reads`` :65, the
``recompute_block`` forward :155-181 and ``recompute_block_grad``
:500-537).  Only the recompute region is ported; ``while``,
``conditional_block`` and ``recurrent`` come with the decode loop
(ROADMAP.md, Queue A item 5).

A sub-block op is not a registered lowering: the executor hands it, with
its block, to :func:`run_sub_block_op`, which runs the sub-block's ops
through the executor's own op loop (``run_block(sub_block, env)``).

``recompute_block`` runs its region on the ``Captured`` values in an
environment of its own, with no autograd graph, and puts back into the
caller's environment only the outputs in ``live`` (the names a later op
outside the region, the fetch list or the scope needs): everything else
the region made is freed when the op returns.  ``recompute_block_grad``
runs the region again from the same ``Captured`` values, the
differentiable ones made leaves, under ``torch.enable_grad()``, and
calls ``torch.autograd.grad`` once on the outputs that have a gradient.
Both runs go through the same ops with the same op ids in the same step,
so each dropping op draws the same mask in both (``ctx.set_op`` resets
the op's draw count); an op that writes an input in place works on a copy
in the second run, so the region's state is written once a step."""

import torch

from .registry import EMPTY_VAR_NAME

__all__ = ["SUB_BLOCK_OPS", "sub_block_external_reads", "run_sub_block_op"]

SUB_BLOCK_OPS = ("while", "conditional_block", "recurrent",
                 "recurrent_grad", "conditional_block_grad", "while_grad",
                 "recompute_block", "recompute_block_grad")


def sub_block_external_reads(sub_block, exclude=()):
    """Names read by the sub-block before any write (closure captures)."""
    written = set(exclude)
    reads = []
    for op in sub_block.ops:
        for n in op.input_arg_names:
            if n and n != EMPTY_VAR_NAME and n not in written \
                    and n not in reads:
                reads.append(n)
        written.update(op.output_arg_names)
    return reads


def run_sub_block_op(op, block, env, ctx, run_block, live):
    """Run the sub-block op ``op`` of ``block`` on ``env``;
    ``run_block(sub_block, env, replay)`` runs a block's ops into an
    environment (``replay``: in-place ops write copies)."""
    if op.type not in ("recompute_block", "recompute_block_grad"):
        raise NotImplementedError(
            "the %r op is not ported yet (ROADMAP.md, Queue A item 5: "
            "while, conditional_block and their grads)" % op.type)
    sub_block = block.program.block(op.attrs["sub_block"])
    if op.type == "recompute_block":
        region = {n: env[n] for n in op.input("Captured")
                  if n and n != EMPTY_VAR_NAME}
        run_block(sub_block, region, False)
        for n in op.output("Out"):
            if n in live and n in region:
                env[n] = region[n]
        return
    _run_recompute_grad(op, sub_block, env, run_block)


def _run_recompute_grad(op, sub_block, env, run_block):
    cap = op.input("Captured")
    gcap = op.output("Captured@GRAD")
    region, leaves = {}, {}
    for i, n in enumerate(cap):
        v = env[n]
        if i < len(gcap) and gcap[i] and gcap[i] != EMPTY_VAR_NAME \
                and v.is_floating_point():
            v = leaves[i] = v.detach().requires_grad_()
        region[n] = v
    with torch.enable_grad():
        run_block(sub_block, region, True)
    outs, cots = [], []
    for n, g in zip(op.input("Out"), op.input("Out@GRAD")):
        y = region.get(n)
        if g and g != EMPTY_VAR_NAME and g in env and y is not None \
                and y.requires_grad:
            outs.append(y)
            cots.append(env[g].to(y.dtype))
    wrt = list(leaves.values())
    grads = [None] * len(wrt)
    if outs and wrt:
        grads = torch.autograd.grad(outs, wrt, cots, allow_unused=True)
    got = dict(zip(leaves, grads))
    for i, name in enumerate(gcap):
        if not name or name == EMPTY_VAR_NAME:
            continue
        g = got.get(i)
        if g is None:  # no gradient path, or an integer input
            v = env[cap[i]]
            g = torch.zeros(v.shape, device=v.device,
                            dtype=v.dtype if v.is_floating_point()
                            else torch.float32)
        env[name] = g
