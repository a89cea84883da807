"""bf16 automatic mixed precision (mirrors
``paddle_tpu/contrib/mixed_precision/__init__.py``)."""

from . import fp16_lists
from .decorator import OptimizerWithMixedPrecision, decorate, rewrite_program_bf16
from .fp16_lists import AutoMixedPrecisionLists

__all__ = ["decorate", "OptimizerWithMixedPrecision", "rewrite_program_bf16",
           "fp16_lists", "AutoMixedPrecisionLists"]
