"""Gradient clipping, as far as ``Optimizer.apply_gradients`` needs it
without clipping (mirrors ``paddle_tpu/clip.py``:
``append_gradient_clip_ops`` :205, ``set_gradient_clip`` :199,
``per_call_gradient_clip`` :179).  The clip attributes themselves
(``GradientClipByValue``/``ByNorm``/``ByGlobalNorm``) are not ported yet:
a program asking for one raises (ROADMAP.md, Queue A)."""

import contextlib

__all__ = ["set_gradient_clip", "append_gradient_clip_ops",
           "per_call_gradient_clip"]

_NOT_PORTED = ("gradient clipping is not ported yet (ROADMAP.md, Queue A: "
               "clipping and regularizers)")


def set_gradient_clip(clip, param_list=None, program=None):
    raise NotImplementedError(_NOT_PORTED)


@contextlib.contextmanager
def per_call_gradient_clip(program, clip):
    """``minimize(grad_clip=...)``: only ``None`` is supported."""
    if clip is not None:
        raise NotImplementedError(_NOT_PORTED)
    yield


def append_gradient_clip_ops(params_grads):
    """The no-clip path: ``params_grads`` unchanged; a parameter with a
    clip attribute raises."""
    for p, _g in params_grads:
        if getattr(p, "gradient_clip_attr", None) is not None:
            raise NotImplementedError(
                "parameter %r has a gradient clip attribute: %s"
                % (p.name, _NOT_PORTED))
    return params_grads
