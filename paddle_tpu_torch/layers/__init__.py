"""Layers DSL (mirrors ``paddle_tpu/layers/``): the layers the BERT
encoder, its eval head and its pretraining head use.  The rest of the
reference's layers are queued in ROADMAP.md."""

from . import io  # noqa: F401
from . import nn  # noqa: F401
from . import ops  # noqa: F401
from . import tensor  # noqa: F401
from .io import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403

__all__ = io.__all__ + nn.__all__ + ops.__all__ + tensor.__all__
