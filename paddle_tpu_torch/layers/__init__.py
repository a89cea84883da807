"""Layers DSL (mirrors ``paddle_tpu/layers/``): the layers the BERT
encoder, its eval head, its pretraining head, the GPT decode programs
and ResNet training use.  The rest of the reference's layers are queued
in ROADMAP.md."""

from . import control_flow  # noqa: F401
from . import decode  # noqa: F401
from . import io  # noqa: F401
from . import metric_op  # noqa: F401
from . import nn  # noqa: F401
from . import ops  # noqa: F401
from . import tensor  # noqa: F401
from .control_flow import *  # noqa: F401,F403
from .decode import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403

__all__ = (control_flow.__all__ + decode.__all__ + io.__all__
           + metric_op.__all__ + nn.__all__ + ops.__all__ + tensor.__all__)
