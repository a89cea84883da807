"""Layers DSL (mirrors ``paddle_tpu/layers/``): the layers the BERT
encoder, its eval head, its pretraining head, the GPT decode programs,
ResNet training, SE-ResNeXt, VGG and ``nets``, and the NMT and
stacked-LSTM models use (the recurrent layers, the sequence layers and
beam search among them), the collective layers (``collective``), the
vision layers (``nn_extra``,
``nn_extra2``), the
learning-rate schedules, the recompute regions and the Variable operator
overloads (``math_op_patch``).  The rest of the reference's layers are
queued in ROADMAP.md."""

from . import beam  # noqa: F401
from . import collective  # noqa: F401
from . import control_flow  # noqa: F401
from . import decode  # noqa: F401
from . import io  # noqa: F401
from . import learning_rate_scheduler  # noqa: F401
from . import math_op_patch  # noqa: F401
from . import metric_op  # noqa: F401
from . import nn  # noqa: F401
from . import nn_extra  # noqa: F401
from . import nn_extra2  # noqa: F401
from . import ops  # noqa: F401
from . import sequence  # noqa: F401
from . import tensor  # noqa: F401
from .beam import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .decode import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .nn_extra import *  # noqa: F401,F403
from .nn_extra2 import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403

__all__ = (beam.__all__ + control_flow.__all__ + decode.__all__
           + io.__all__ + learning_rate_scheduler.__all__
           + metric_op.__all__ + nn.__all__ + nn_extra.__all__
           + nn_extra2.__all__ + ops.__all__
           + sequence.__all__ + tensor.__all__)
