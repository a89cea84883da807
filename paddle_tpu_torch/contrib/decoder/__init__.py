"""Decoder DSL (mirrors ``paddle_tpu/contrib/decoder/__init__.py``)."""

from .beam_search_decoder import (BeamSearchDecoder, InitState,  # noqa: F401
                                  StateCell, TrainingDecoder)

__all__ = ["InitState", "StateCell", "TrainingDecoder",
           "BeamSearchDecoder"]
