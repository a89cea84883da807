"""Transpilers (mirrors ``paddle_tpu/transpiler/``): the collective
mode's ``GradAllReduce`` so far; the parameter-server
``DistributeTranspiler`` and the other collective modes are in
ROADMAP.md (Queue A item 7)."""

from . import collective
from .collective import Collective, GradAllReduce, ensure_comm_ring

__all__ = ["collective", "Collective", "GradAllReduce", "ensure_comm_ring"]
