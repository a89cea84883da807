"""Fleet (mirrors ``paddle_tpu/incubate/fleet/``): the role makers and
the collective fleet; ``parameter_server`` is not ported (ROADMAP.md,
Queue A item 9)."""

from . import base
from . import collective

__all__ = ["base", "collective"]
