"""Incubating APIs (mirrors ``paddle_tpu/incubate/``): the collective
fleet.  The parameter-server fleet and the data generators wait for the
distributed lookup tables (ROADMAP.md, Queue A item 9)."""

from . import fleet

__all__ = ["fleet"]
