"""Contrib surface (mirrors ``paddle_tpu/contrib/__init__.py``).  Ported
so far: :mod:`.mixed_precision`, the bf16 AMP rewrite,
:mod:`.extend_optimizer`, decoupled weight decay, and :mod:`.decoder`,
the seq2seq decoder DSL (``InitState``, ``StateCell``,
``TrainingDecoder``, ``BeamSearchDecoder``).  The rest of the
reference's contrib package (slim, the diagnostics, the fused layers,
reader and utils) is not ported yet (ROADMAP.md)."""

from . import decoder
from . import extend_optimizer
from . import mixed_precision
from .decoder import (BeamSearchDecoder, InitState, StateCell,
                      TrainingDecoder)
from .extend_optimizer import extend_with_decoupled_weight_decay

__all__ = ["mixed_precision", "extend_optimizer",
           "extend_with_decoupled_weight_decay", "decoder",
           "InitState", "StateCell", "TrainingDecoder",
           "BeamSearchDecoder"]
