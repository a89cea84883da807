"""Model builders (mirrors ``paddle_tpu/models/`` and
``examples/gpt_small.py``): BERT and the GPT decoder so far; the others
are queued in ROADMAP.md."""

from . import bert  # noqa: F401
from . import gpt  # noqa: F401
