"""Model builders (mirrors ``paddle_tpu/models/`` and
``examples/gpt_small.py``): BERT, the GPT decoder and ResNet so far; the
others are queued in ROADMAP.md."""

from . import bert  # noqa: F401
from . import gpt  # noqa: F401
from . import resnet  # noqa: F401
