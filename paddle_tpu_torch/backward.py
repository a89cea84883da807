"""Program-level reverse-mode autodiff.

Mirrors ``paddle_tpu/backward.py``: :func:`append_backward` (:318-371)
walks the op list in reverse and appends one ``<type>_grad`` op per
forward op (``_GradEngine`` :65-214), inserts ``sum`` ops where a var's
gradient fans in from several consumers (:79-101), seeds the loss
gradient with a ``fill_constant`` of 1 (:341-350), and prunes branches
with no gradient path.  The grad program is the reference's, op for op;
each grad op is the registry's generic ``<type>_grad``, which
differentiates the autograd graph its forward recorded in the same run
(``ops/registry.py``).  A sub-block op (``while``, ``conditional_block``,
``recurrent``, a ``recompute_block`` region) gets one ``<type>_grad`` op
(``_backprop_sub_block_op`` :218-316): it reads the op's inputs, its
``Captured`` outer vars (the names its block reads before writing them
that resolve outside it: the parameters it uses among them), its outputs
and their gradients, and writes ``Captured@GRAD``; a ``while``'s also
writes ``StateIn@GRAD``, the gradients of its loop-state vars' pre-loop
values, which then flow on to the ops before the loop, and a
``recurrent``'s ``inputs@GRAD`` and ``initial_states@GRAD``, those of
its sequence inputs and initial states (its step inputs and states are
not captured vars).
``checkpoints`` is accepted and unused, as in the reference (:319):
regions come from ``layers.recompute()`` or
``optimizer.rewrite_program_recompute``.
"""

from . import unique_name
from .framework import Parameter, Variable, grad_var_name
from .ops import control_flow as cf_ops
from .ops import registry as op_registry

__all__ = ["append_backward", "gradients", "calc_gradient"]

_SUB_BLOCK_OPS = ("while", "conditional_block", "recurrent",
                  "recompute_block")


def _find_op_path(block, targets):
    """Indices of ops contributing to ``targets``."""
    needed = {t.name if isinstance(t, Variable) else t for t in targets}
    path = []
    for idx in range(len(block.ops) - 1, -1, -1):
        op = block.ops[idx]
        if needed & set(op.output_arg_names):
            path.append(idx)
            needed.update(op.input_arg_names)
    path.reverse()
    return path


def _var_can_have_grad(block, name, no_grad_set):
    if name in no_grad_set or not name or name == op_registry.EMPTY_VAR_NAME:
        return False
    v = block._find_var_recursive(name)
    if v is None or v.stop_gradient:
        return False
    return v.dtype is None or v.dtype in ("float16", "float32", "float64",
                                          "bfloat16")


def _create_grad_var(block, fwd_name, grad_name):
    """The grad var takes its forward var's shape and dtype (grad ops
    have no shape inference of their own)."""
    fwd = block._find_var_recursive(fwd_name)
    if block.has_var(grad_name):
        return block.var(grad_name)
    return block.create_var(
        name=grad_name, shape=fwd.shape if fwd is not None else None,
        dtype=fwd.dtype if fwd is not None else "float32",
        persistable=False, stop_gradient=False)


class _GradEngine:
    """Reverse accumulation over one block."""

    def __init__(self, block, no_grad_set):
        self.block = block
        self.no_grad_set = set(no_grad_set or [])
        self.pending = {}   # forward var → grad var names still to sum
        self.resolved = {}  # forward var → its one (summed) grad var

    def seed(self, var_name, grad_name):
        self.pending.setdefault(var_name, []).append(grad_name)

    def resolve(self, var_name):
        """Sum the pending grads of ``var_name`` into one var."""
        if var_name in self.resolved:
            return self.resolved[var_name]
        plist = self.pending.get(var_name)
        if not plist:
            return None
        if len(plist) == 1:
            g = plist[0]
        else:
            g = grad_var_name(var_name)
            if g in plist:  # the canonical name is one producer's
                g = unique_name.generate(grad_var_name(var_name) + "@SUM")
            _create_grad_var(self.block, var_name, g)
            self.block.append_op(type="sum", inputs={"X": list(plist)},
                                 outputs={"Out": [g]},
                                 attrs={"op_role": "backward"})
        self.resolved[var_name] = g
        return g

    def new_grad_name(self, var_name):
        base = grad_var_name(var_name)
        if not self.pending.get(var_name) and not self.block.has_var(base):
            return base
        return unique_name.generate(base + "@RENAME")

    def backprop_op(self, op):
        """Append the grad op of ``op``; True if one was appended."""
        if op.type in _SUB_BLOCK_OPS:
            return self._backprop_sub_block_op(op)
        try:
            opdef = op_registry.get_op_def(op.type)
        except op_registry.OpNotRegistered:
            return False
        if opdef.no_grad:
            return False

        out_grads = {}
        for slot, names in op.outputs.items():
            if slot in opdef.stateful_outputs:
                continue
            gnames = [self.resolve(y) or op_registry.EMPTY_VAR_NAME
                      for y in names]
            if any(g != op_registry.EMPTY_VAR_NAME for g in gnames):
                out_grads[slot + "@GRAD"] = gnames
        if not out_grads:
            return False

        # a var bound to several input slots gets a distinct grad name
        # per slot, or the later slot's grad would overwrite the first
        in_grads = {}
        used = set()
        for slot, names in op.inputs.items():
            gnames = []
            for x in names:
                if _var_can_have_grad(self.block, x, self.no_grad_set):
                    gn = self.new_grad_name(x)
                    while gn in used:
                        gn = unique_name.generate(grad_var_name(x)
                                                  + "@RENAME")
                    used.add(gn)
                    gnames.append(gn)
                else:
                    gnames.append(op_registry.EMPTY_VAR_NAME)
            if any(g != op_registry.EMPTY_VAR_NAME for g in gnames):
                in_grads[slot + "@GRAD"] = gnames
        if not in_grads:
            return False

        inputs = {slot: list(names) for slot, names in op.inputs.items()}
        inputs.update({slot: list(names)
                       for slot, names in op.outputs.items()})
        inputs.update(out_grads)
        attrs = dict(op.attrs)
        attrs["__fwd_op_id__"] = op.attrs.get("__op_id__", 0)
        attrs["op_role"] = "backward"
        attrs.pop("__op_id__", None)
        for slot, gnames in in_grads.items():
            for fwd_name, gn in zip(op.inputs.get(slot[:-len("@GRAD")], []),
                                    gnames):
                if gn != op_registry.EMPTY_VAR_NAME:
                    _create_grad_var(self.block, fwd_name, gn)
        self.block.append_op(type=op.type + "_grad", inputs=inputs,
                             outputs=in_grads, attrs=attrs)
        for slot, names in op.inputs.items():
            for x, g in zip(names, in_grads.get(slot + "@GRAD", ())):
                if g != op_registry.EMPTY_VAR_NAME:
                    self.pending.setdefault(x, []).append(g)
        return True

    def _grad_names(self, names, targets):
        """A new grad name for each of ``names`` that can have one
        (EMPTY otherwise), each added to ``targets`` with its var."""
        out = []
        for x in names:
            if _var_can_have_grad(self.block, x, self.no_grad_set):
                gn = self.new_grad_name(x)
                out.append(gn)
                targets.append((x, gn))
            else:
                out.append(op_registry.EMPTY_VAR_NAME)
        return out

    def _backprop_sub_block_op(self, op):
        """The ``<type>_grad`` op of a ``while``, ``conditional_block``,
        ``recurrent`` or ``recompute_block`` (the reference's
        :218-316)."""
        out_slot = "outputs" if op.type == "recurrent" else "Out"
        out_names = op.outputs.get(out_slot, [])
        gnames = [self.resolve(y) or op_registry.EMPTY_VAR_NAME
                  for y in out_names]
        if all(g == op_registry.EMPTY_VAR_NAME for g in gnames):
            return False
        sub_block = self.block.program.block(op.attrs["sub_block"])
        # a while's loop-state vars take their grads through StateIn@GRAD
        # (of their pre-loop values), a recurrent's step inputs and
        # states through inputs@GRAD and initial_states@GRAD, not as
        # captured vars
        exclude = set(out_names) if op.type == "while" else set()
        if op.type == "recurrent":
            exclude.update(op.attrs.get("step_input_names", []))
            exclude.update(op.attrs.get("state_names", []))
        captured = [n for n in cf_ops.sub_block_external_reads(sub_block,
                                                               exclude)
                    if self.block._find_var_recursive(n) is not None]
        inputs = {k: list(v) for k, v in op.inputs.items()}
        inputs["Captured"] = captured
        inputs[out_slot] = list(out_names)
        inputs[out_slot + "@GRAD"] = gnames
        outputs, targets = {}, []
        if op.type == "while":
            # the grads resolved above are of the post-loop values; the
            # ones seeded below are of the pre-loop values, for the ops
            # before the loop
            for x in out_names:
                self.resolved.pop(x, None)
                self.pending[x] = []
            gouts = self._grad_names(out_names, targets)
            if any(g != op_registry.EMPTY_VAR_NAME for g in gouts):
                outputs["StateIn@GRAD"] = gouts
        for slot in (("inputs", "initial_states")
                     if op.type == "recurrent" else ()):
            gouts = self._grad_names(op.inputs.get(slot, []), targets)
            if any(g != op_registry.EMPTY_VAR_NAME for g in gouts):
                outputs[slot + "@GRAD"] = gouts
        outputs["Captured@GRAD"] = self._grad_names(captured, targets)
        if not targets:
            return False
        attrs = dict(op.attrs)
        attrs["__fwd_op_id__"] = op.attrs.get("__op_id__", 0)
        attrs["op_role"] = "backward"
        attrs.pop("__op_id__", None)
        for fwd_name, gn in targets:
            _create_grad_var(self.block, fwd_name, gn)
        self.block.append_op(type=op.type + "_grad", inputs=inputs,
                             outputs=outputs, attrs=attrs)
        for fwd_name, gn in targets:
            self.pending.setdefault(fwd_name, []).append(gn)
        return True


def _seed_grad(block, target):
    """d(target)/d(target) = 1 as a ``fill_constant`` grad var."""
    shape = list(target.shape or (1,))
    g = block.create_var(name=grad_var_name(target.name), shape=shape,
                         dtype=target.dtype, persistable=False)
    block.append_op(type="fill_constant", outputs={"Out": [g]},
                    attrs={"shape": shape, "value": 1.0,
                           "dtype": target.dtype, "op_role": "backward"})
    return g.name


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Append the grad ops of ``loss``; returns ``[(param, grad_var)]``."""
    if not isinstance(loss, Variable):
        raise TypeError("append_backward takes the loss Variable")
    block = loss.block
    program = block.program
    no_grad = set(no_grad_set or [])
    no_grad.update(v.name for v in block.vars.values()
                   if v.stop_gradient and not isinstance(v, Parameter))

    op_path = _find_op_path(block, [loss])
    engine = _GradEngine(block, no_grad)
    engine.seed(loss.name, _seed_grad(block, loss))
    for idx in reversed(op_path):
        engine.backprop_op(block.ops[idx])

    if parameter_list is not None:
        params = [program.global_block().var(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = [p for p in program.all_parameters() if p.trainable]
    params_grads = []
    for p in params:
        g = engine.resolve(p.name)
        if g is not None:
            params_grads.append((p, block.var(g)))
    return params_grads


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Grads of ``targets`` with respect to ``inputs`` (None where there
    is no path)."""
    if isinstance(targets, Variable):
        targets = [targets]
    if isinstance(inputs, Variable):
        inputs = [inputs]
    if isinstance(target_gradients, Variable):
        target_gradients = [target_gradients]
    block = targets[0].block
    engine = _GradEngine(block, no_grad_set)
    op_path = _find_op_path(block, targets)
    for i, t in enumerate(targets):
        tg = target_gradients[i] if target_gradients else None
        engine.seed(t.name, tg.name if tg is not None
                    else _seed_grad(block, t))
    for idx in reversed(op_path):
        engine.backprop_op(block.ops[idx])
    outs = []
    for x in inputs:
        g = engine.resolve(x.name)
        outs.append(block.var(g) if g is not None else None)
    return outs


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    return calc_gradient(targets, inputs, target_gradients, no_grad_set)
