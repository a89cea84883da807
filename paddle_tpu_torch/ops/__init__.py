"""Op lowerings (mirrors ``paddle_tpu/ops/``).  Importing this package
registers every op of the ported slices."""

from . import registry  # noqa: F401
from . import basic  # noqa: F401
from . import math  # noqa: F401
from . import tensor_manip  # noqa: F401
from . import activations  # noqa: F401
from . import compare  # noqa: F401
from . import control_flow  # noqa: F401
from . import extra  # noqa: F401
from . import nn  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import decode  # noqa: F401
from . import vision  # noqa: F401
from . import collective  # noqa: F401
