"""Eager autograd tape (mirrors ``paddle_tpu/dygraph/tape.py``:
``TapeEntry``, ``Tape`` with ``record`` / ``trace`` / ``all_parameters``
and ``backward`` :70, the tape stack).

The reference records (op, inputs, outputs, attrs) per eager op and its
``backward`` replays each op's vjp-derived grad rule in reverse.  Here an
eager op runs under ``torch.enable_grad()`` on tensors that carry
``requires_grad`` (``varbase.eager_op``), so PyTorch's autograd records
the same graph while the op runs; the tape keeps the VarBases each op
read and wrote, as the reference's entries do.  :meth:`Tape.backward` is
one ``torch.autograd.grad`` from the root over every VarBase the tape saw
that takes a gradient, intermediates included, so ``gradient()`` of an
intermediate works as in the reference.  Without ``retain_graph`` the
graph is freed and every recorded output becomes a leaf
(:meth:`VarBase._cut`): a later backward stops there, as the reference's
cleared tape does.

A tape also holds the device its guard placed it on (``guard(place)``):
parameters and ``to_variable`` values are made there."""

import torch

__all__ = ["Tape", "TapeEntry", "current_tape", "push_tape", "pop_tape"]


class TapeEntry:
    __slots__ = ("opdef", "attrs", "op_id", "in_vars", "out_vars")

    def __init__(self, opdef, attrs, op_id, in_vars, out_vars):
        self.opdef = opdef
        self.attrs = attrs
        self.op_id = op_id
        self.in_vars = in_vars    # {slot: [VarBase|None]}
        self.out_vars = out_vars  # {slot: [VarBase]}


class Tape:
    def __init__(self, device=None):
        self.entries = []
        self.paused = False  # set by dygraph.no_grad()
        self.device = device

    def record(self, entry):
        if not self.paused:
            self.entries.append(entry)

    # ---- the reference's imperative.Tracer surface ----
    def trace(self, entry):
        self.record(entry)

    trace_op = trace

    def trace_var(self, name, var):
        return var

    def all_parameters(self):
        """Persistable VarBases seen on the tape."""
        seen, out = set(), []
        for e in self.entries:
            for vars_ in e.in_vars.values():
                for v in vars_:
                    if (v is not None and v.persistable
                            and id(v) not in seen):
                        seen.add(id(v))
                        out.append(v)
        return out

    def train_mode(self):
        self.paused = False

    def eval_mode(self):
        self.paused = True

    def _seen(self, root):
        seen = {}
        for e in self.entries:
            for group in (e.in_vars, e.out_vars):
                for vars_ in group.values():
                    for v in vars_:
                        if v is not None:
                            seen[id(v)] = v
        seen[id(root)] = root
        return list(seen.values())

    def backward(self, root, retain_graph=False):
        """Gradients of ``root`` (seeded with ones) deposited on every
        VarBase the tape saw whose ``stop_gradient`` is False, added to
        what they held; the graph freed and the tape cleared unless
        ``retain_graph``."""
        seen = self._seen(root)
        wrt = [v for v in seen
               if not v.stop_gradient and v._value.requires_grad]
        if root._value.requires_grad and wrt:
            grads = torch.autograd.grad(
                [root._value], [v._value for v in wrt],
                [torch.ones_like(root._value)], retain_graph=retain_graph,
                allow_unused=True)
        else:  # nothing recorded reaches the root: it alone gets ones
            wrt = [root] if not root.stop_gradient else []
            grads = [torch.ones_like(root._value)] * len(wrt)
        got = {id(v): g for v, g in zip(wrt, grads) if g is not None}
        # as the reference's replay: an op that the backward reached gives
        # each of its float inputs a gradient, zeros where none flows
        for e in self.entries:
            if not any(id(v) in got for vs in e.out_vars.values()
                       for v in vs):
                continue
            for vs in e.in_vars.values():
                for v in vs:
                    if v is not None and id(v) not in got \
                            and not v.stop_gradient \
                            and v._value.requires_grad:
                        got[id(v)] = torch.zeros_like(v._value)
        by_id = {id(v): v for v in seen}
        with torch.no_grad():
            for vid, g in got.items():
                v = by_id[vid]
                v._grad = g if v._grad is None else v._grad + g
        if not retain_graph:
            for e in self.entries:
                for vars_ in e.out_vars.values():
                    for v in vars_:
                        v._cut()
            self.entries.clear()


_tape_stack = []


def current_tape():
    return _tape_stack[-1] if _tape_stack else None


def push_tape(tape=None):
    t = tape or Tape()
    _tape_stack.append(t)
    return t


def pop_tape():
    return _tape_stack.pop()
