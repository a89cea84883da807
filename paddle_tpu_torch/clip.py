"""Gradient clipping appended as graph ops (mirrors
``paddle_tpu/clip.py``: ``ErrorClipByValue`` :19, ``GradientClipByValue``
:40, ``GradientClipByNorm`` :66, ``GradientClipByGlobalNorm`` :90,
``per_call_gradient_clip`` :179, ``set_gradient_clip`` :199,
``append_gradient_clip_ops`` :205).  The global norm is ``sqrt`` of the
``sum`` of each gradient's ``squared_l2_norm``, and every gradient is
multiplied by ``clip_norm / max(norm, clip_norm)``: all on the device, no
value read on the host, so a clipped step is captured whole.  A clip set
for the program (``set_gradient_clip`` or ``minimize(grad_clip=)``)
wins over the parameters' own ``gradient_clip_attr``."""

import contextlib

from . import unique_name
from .framework import default_main_program

__all__ = ["GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "set_gradient_clip",
           "ErrorClipByValue", "append_gradient_clip_ops",
           "per_call_gradient_clip", "error_clip_callback"]


class BaseErrorClipAttr:
    pass


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max


def error_clip_callback(block, context):
    """The reference's backward callback, which appends nothing."""


class BaseGradientClipAttr:
    def _process(self, params_grads):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _process(self, params_grads):
        return params_grads


class GradientClipByValue(BaseGradientClipAttr):
    """Each gradient clamped to ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _process(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            o = g.block.create_var(
                name=unique_name.generate(g.name + ".clip"),
                shape=g.shape, dtype=g.dtype)
            g.block.append_op(type="clip", inputs={"X": [g]},
                              outputs={"Out": [o]},
                              attrs={"min": self.min, "max": self.max,
                                     "op_role": "optimize"})
            out.append((p, o))
        return out


class GradientClipByNorm(BaseGradientClipAttr):
    """Each gradient scaled to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _process(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            o = g.block.create_var(
                name=unique_name.generate(g.name + ".clipnorm"),
                shape=g.shape, dtype=g.dtype)
            g.block.append_op(type="clip_by_norm", inputs={"X": [g]},
                              outputs={"Out": [o]},
                              attrs={"max_norm": self.clip_norm,
                                     "op_role": "optimize"})
            out.append((p, o))
        return out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Every gradient times ``clip_norm / max(global_norm, clip_norm)``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _process(self, params_grads):
        live = [(p, g) for p, g in params_grads if g is not None]
        if not live:
            return params_grads
        block = live[0][1].block

        def var(prefix):
            return block.create_var(name=unique_name.generate(prefix),
                                    shape=[1], dtype="float32")

        def op(type, inputs, out, **attrs):
            attrs["op_role"] = "optimize"
            block.append_op(type=type, inputs=inputs,
                            outputs={"Out": [out]}, attrs=attrs)
            return out

        sq_norms = [op("squared_l2_norm", {"X": [g]}, var(g.name + ".sq"))
                    for _, g in live]
        total = op("sum", {"X": sq_norms}, var("global_norm_sq"))
        gnorm = op("sqrt", {"X": [total]}, var("global_norm"))
        clipc = op("fill_constant", {}, var("clip_norm_const"), shape=[1],
                   dtype="float32", value=self.clip_norm)
        denom = op("elementwise_max", {"X": [gnorm], "Y": [clipc]},
                   var("clip_denom"))
        scale = op("elementwise_div", {"X": [clipc], "Y": [denom]},
                   var("clip_scale"))
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            o = g.block.create_var(
                name=unique_name.generate(g.name + ".gclip"),
                shape=g.shape, dtype=g.dtype)
            g.block.append_op(type="elementwise_mul",
                              inputs={"X": [g], "Y": [scale]},
                              outputs={"Out": [o]},
                              attrs={"op_role": "optimize"})
            out.append((p, o))
        return out


_clip_attr = {}  # id(program) -> its clip attribute


@contextlib.contextmanager
def per_call_gradient_clip(program, clip):
    """``clip`` registered for ``program`` while ``minimize(grad_clip=)``
    appends its ops; a ``set_gradient_clip`` registration is restored on
    exit."""
    if clip is None:
        yield
        return
    pid = id(program)
    prev = _clip_attr.get(pid)
    _clip_attr[pid] = clip
    try:
        yield
    finally:
        if prev is None:
            _clip_attr.pop(pid, None)
        else:
            _clip_attr[pid] = prev


def set_gradient_clip(clip, param_list=None, program=None):
    if program is None:
        program = default_main_program()
    _clip_attr[id(program)] = clip


def append_gradient_clip_ops(params_grads):
    """The program's clip on every pair, else each parameter's own
    ``gradient_clip_attr`` on its pair."""
    if not params_grads:
        return params_grads
    program = params_grads[0][0].block.program
    clip = _clip_attr.get(id(program))
    per_param = [getattr(p, "gradient_clip_attr", None)
                 for p, _ in params_grads]
    if clip is None and not any(per_param):
        return params_grads
    if clip is not None:
        return clip._process(params_grads)
    out = []
    for (p, g), attr in zip(params_grads, per_param):
        if attr is None or g is None:
            out.append((p, g))
        else:
            out.extend(attr._process([(p, g)]))
    return out
