"""Contrib surface (mirrors ``paddle_tpu/contrib/__init__.py``).  Ported
so far: :mod:`.mixed_precision`, the bf16 AMP rewrite.  The rest of the
reference's contrib package (slim, extend_optimizer, the diagnostics,
the fused layers, the decoder DSL) is not ported yet (ROADMAP.md)."""

from . import mixed_precision

__all__ = ["mixed_precision"]
