"""Eager variable (mirrors ``paddle_tpu/dygraph/varbase.py``: ``VarBase``
:14 with ``backward`` :61 and the operator sugar :89-112, ``eager_op``
:122, ``to_variable_value``) — a torch tensor, a gradient slot and the
tape's bookkeeping.

A VarBase's tensor carries ``requires_grad`` when its ``stop_gradient``
is False, so the eager ops record the autograd graph the tape's backward
differentiates (``tape.py``).  An op runs through the same registry as
the static graph (``ops/registry.call_op``), so every registered op is
dygraph-capable, and each eager op gets an id of its own: a dropping op
draws a new mask per call from ``ctx.step_seed``, as the reference folds
the op id into its key (``paddle_tpu/ops/registry.py:173``)."""

import itertools

import numpy as np
import torch

from .. import core
from ..ops import registry as op_registry
from .tape import TapeEntry, current_tape

__all__ = ["VarBase", "eager_op", "to_variable_value", "current_device"]

_eager_op_ids = itertools.count(1)
# the eager ops' step on each device (every op's salt is its own id)
_eager_steps = {}


def current_device():
    """The innermost guard's device; outside any guard the card (which
    raises where there is none)."""
    tape = current_tape()
    if tape is not None and tape.device is not None:
        return tape.device
    return core.CUDAPlace(0).torch_device()


def _host_copy(t):
    t = t.detach()
    return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()


def _as_tensor(value, device):
    if isinstance(value, torch.Tensor):
        return value
    return op_registry.np_to_torch(np.asarray(value), device)


class VarBase:
    def __init__(self, value, name=None, stop_gradient=False,
                 persistable=False, trainable=True):
        t = _as_tensor(value, current_device())
        if t.requires_grad and t.grad_fn is None:
            t = t.detach()  # a caller's leaf: never flip its flag
        self._value = t
        self.name = name or "eager_var"
        self.persistable = persistable
        self.trainable = trainable
        self._grad = None
        self.stop_gradient = stop_gradient

    @classmethod
    def _wrap(cls, t, name, stop_gradient=False):
        """An op's output: ``t`` as it came from autograd."""
        v = cls.__new__(cls)
        v._value = t
        v.name = name
        v.persistable = False
        v.trainable = True
        v._grad = None
        v._stop_gradient = stop_gradient
        return v

    # ---- stop_gradient drives the tensor's requires_grad ----
    @property
    def stop_gradient(self):
        return self._stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, value):
        self._stop_gradient = bool(value)
        t = self._value
        if not t.is_floating_point():
            return
        if t.grad_fn is None:
            t.requires_grad_(not self._stop_gradient)
        elif self._stop_gradient:
            self._value = t.detach()

    def _cut(self):
        """Make this VarBase's tensor a leaf (the graph behind it freed)."""
        t = self._value
        if t.grad_fn is not None:
            self._value = t.detach().requires_grad_(not self._stop_gradient)

    # ---- the reference VarBase surface ----
    def numpy(self):
        """A host copy (never a view of a CPU tensor that an in-place
        update would change under the caller)."""
        return _host_copy(self._value)

    @property
    def value(self):
        return self._value

    @property
    def shape(self):
        return tuple(self._value.shape)

    @property
    def dtype(self):
        return core.convert_np_dtype_to_dtype_(self._value.dtype)

    @property
    def gradient_value(self):
        return self._grad

    def gradient(self):
        return None if self._grad is None else _host_copy(self._grad)

    def clear_gradient(self):
        self._grad = None

    def set_value(self, value):
        """Write ``value`` into this VarBase's tensor in place (a value
        that is the tensor itself, as an in-place update returns, is left
        as it is); a value of another shape replaces the tensor."""
        if isinstance(value, VarBase):
            value = value._value
        if value is self._value:
            return
        src = _as_tensor(value, self._value.device)
        if tuple(src.shape) != tuple(self._value.shape):
            self._value = src.detach().to(self._value.device).clone()
            self.stop_gradient = self._stop_gradient
            return
        with torch.no_grad():
            self._value.copy_(src)

    def detach(self):
        return VarBase._wrap(self._value.detach(), self.name + ".detached",
                             stop_gradient=True)

    def backward(self, retain_graph=False):
        tape = current_tape()
        if tape is None:
            raise RuntimeError(
                "backward() outside dygraph.guard() — no tape is recording")
        tape.backward(self, retain_graph=retain_graph)

    def __repr__(self):
        return "VarBase(%s, shape=%s)" % (self.name, self.shape)

    # ---- operator sugar (eager) ----
    def _binary(self, other, op_type, reverse=False):
        if not isinstance(other, VarBase):
            other = VarBase._wrap(
                torch.tensor(other, dtype=self._value.dtype,
                             device=self._value.device),
                "eager_var", stop_gradient=True)
        a, b = (other, self) if reverse else (self, other)
        return eager_op(op_type, {"X": [a], "Y": [b]}, {"axis": -1})[0]

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __rsub__(self, other):
        return self._binary(other, "elementwise_sub", reverse=True)

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")


def to_variable_value(v):
    if isinstance(v, VarBase):
        return v._value
    return v


def _step(device):
    step = _eager_steps.get(device)
    if step is None:
        step = _eager_steps[device] = torch.zeros(
            (1,), dtype=torch.int64, device=device)
    return step


def _output(t, ins, opdef, slot, dygraph):
    """An op's output tensor as a VarBase.  A stateful output (batch
    norm's statistics, a dropout mask) takes no gradient.  In dygraph mode
    a floating output that no recorded input reaches (made under
    ``no_grad``, or from inputs that stop the gradient) becomes a leaf
    that takes one, as the reference deposits a gradient on every op
    output a later recorded op reads; an output that is one of the op's
    inputs is wrapped as a view of it."""
    name = "%s.%s" % (opdef.type, slot)
    if not isinstance(t, torch.Tensor):
        return VarBase._wrap(torch.zeros(1), name, stop_gradient=True)
    if slot in opdef.stateful_outputs:
        return VarBase._wrap(t, name, stop_gradient=True)
    if any(t is i for i in ins):
        t = t.view_as(t) if t.requires_grad else t.detach()
    if dygraph and t.is_floating_point() and t.grad_fn is None:
        t.requires_grad_(True)
    return VarBase._wrap(t, name)


def eager_op(op_type, in_vars, attrs=None, n_outs=None):
    """Dispatch one op eagerly and record it on the tape.  ``in_vars``:
    ``{slot: [VarBase|tensor|array|None]}``.  Returns the list of output
    VarBases in the op's declared slot order."""
    opdef = op_registry.get_op_def(op_type)
    attrs = dict(attrs or {})
    op_id = next(_eager_op_ids)
    tape = current_tape()
    ins, in_vb, flat_in = {}, {}, []
    for slot, vs in in_vars.items():
        vals, vbs = [], []
        for v in vs:
            vbs.append(v if isinstance(v, VarBase) else None)
            if isinstance(v, VarBase):
                v = v._value
            elif v is not None:
                v = _as_tensor(v, current_device())
            vals.append(v)
            if v is not None:
                flat_in.append(v)
        ins[slot] = vals
        in_vb[slot] = vbs
    # the op runs where its data lies
    device = flat_in[0].device if flat_in else current_device()
    record = tape is not None and not tape.paused and not opdef.no_grad
    ctx = op_registry.LoweringContext(mode="train", device=device,
                                      step=_step(device))
    with torch.enable_grad() if record else torch.no_grad():
        outs = op_registry.call_op(opdef, ctx, ins, attrs, op_id=op_id)
    out_vb, flat_out = {}, []
    for slot, _dup in opdef.outputs:
        vbs = [_output(t, flat_in, opdef, slot, tape is not None)
               for t in outs.get(slot, ())]
        out_vb[slot] = vbs
        flat_out.extend(vbs)
    if record:
        tape.record(TapeEntry(opdef, attrs, op_id, in_vb, out_vb))
    return flat_out
