"""Incubating APIs (mirrors ``paddle_tpu/incubate/``): the collective
fleet and the MultiSlot data generators.  The parameter-server fleet
waits for the distributed lookup tables (ROADMAP.md, Queue A item 9)."""

from . import data_generator
from . import fleet

__all__ = ["data_generator", "fleet"]
