"""Contrib surface (mirrors ``paddle_tpu/contrib/__init__.py``).  Ported
so far: :mod:`.mixed_precision`, the bf16 AMP rewrite, and
:mod:`.extend_optimizer`, decoupled weight decay.  The rest of the
reference's contrib package (slim, the diagnostics, the fused layers,
the decoder DSL) is not ported yet (ROADMAP.md)."""

from . import extend_optimizer
from . import mixed_precision
from .extend_optimizer import extend_with_decoupled_weight_decay

__all__ = ["mixed_precision", "extend_optimizer",
           "extend_with_decoupled_weight_decay"]
