"""Canned datasets (mirrors ``paddle_tpu/datasets/``: ``common`` and
``mnist`` so far; the reference's ``python/paddle/dataset/``).  Each
dataset reads a local file when it is in the data home
(``PADDLE_TPU_DATA_HOME``) and otherwise serves the reference's
deterministic synthetic surrogate, with the real data's sample shapes,
dtypes and label ranges.  The other datasets (cifar, uci_housing, imdb,
...) are queued in ROADMAP.md."""

from . import common  # noqa: F401
from . import mnist  # noqa: F401

__all__ = ["common", "mnist"]
