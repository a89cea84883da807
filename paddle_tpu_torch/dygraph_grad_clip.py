"""Dygraph gradient clipping (mirrors ``paddle_tpu/dygraph_grad_clip.py``:
``GradClipByValue``, ``GradClipByNorm``, ``GradClipByGlobalNorm``).  The
same math as the graph-path clip classes: the optimizer's eager
``minimize(grad_clip=...)`` applies them
(``Optimizer._dygraph_clip_grads``)."""

from .clip import (GradientClipByGlobalNorm, GradientClipByNorm,
                   GradientClipByValue)

__all__ = ["GradClipByValue", "GradClipByNorm", "GradClipByGlobalNorm"]


class GradClipByValue(GradientClipByValue):
    pass


class GradClipByNorm(GradientClipByNorm):
    pass


class GradClipByGlobalNorm(GradientClipByGlobalNorm):
    pass
