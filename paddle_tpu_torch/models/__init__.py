"""Model builders (mirrors ``paddle_tpu/models/``): BERT so far; the
others are queued in ROADMAP.md."""

from . import bert  # noqa: F401
