"""Dygraph mode plumbing (mirrors ``paddle_tpu/dygraph/base.py``:
``enabled``, ``enable_dygraph``, ``disable_dygraph``, ``guard`` :36,
``no_grad`` :45, ``to_variable`` :60).

``guard(place)`` opens a tape on ``place``'s device: the card when no
place is given, which raises where there is none, and the CPU for
``guard(fluid.CPUPlace())``.  On the card float32 products run in full
float32, as the executor runs them there.  Guards nest; the innermost one's device is
where parameters and ``to_variable`` values are made.  ``no_grad`` stops
the tape recording while ops still run."""

import contextlib

import numpy as np

from .. import core
from .. import framework
from .tape import Tape, current_tape, pop_tape, push_tape

__all__ = ["guard", "enabled", "to_variable", "enable_dygraph",
           "disable_dygraph", "no_grad"]


def enabled():
    return framework.in_dygraph_mode()


def enable_dygraph(place=None):
    device = core.as_torch_device(place)
    if device.type == "cuda":
        core.full_float32_products()  # as a CUDA place's executor
    framework._dygraph_tracer_ = push_tape(Tape(device))


def disable_dygraph():
    """Exit the innermost dygraph scope, restoring the enclosing one (so
    nested guards compose and no tape leaks on the stack)."""
    if framework.in_dygraph_mode():
        pop_tape()
    framework._dygraph_tracer_ = current_tape()


@contextlib.contextmanager
def guard(place=None):
    enable_dygraph(place)
    try:
        yield
    finally:
        disable_dygraph()


@contextlib.contextmanager
def no_grad():
    """Suspend gradient recording while staying in dygraph mode: eager
    dispatch still works, the tape ignores ops executed in the scope."""
    tape = framework._dygraph_tracer_
    prev = tape.paused if tape is not None else False
    if tape is not None:
        tape.paused = True
    try:
        yield
    finally:
        if tape is not None:
            tape.paused = prev


def to_variable(value, block=None, name=None):
    from .varbase import VarBase

    if not framework.in_dygraph_mode():
        raise RuntimeError("to_variable requires dygraph mode (use guard())")
    if isinstance(value, VarBase):
        return value
    return VarBase(np.asarray(value), name=name, stop_gradient=True)
