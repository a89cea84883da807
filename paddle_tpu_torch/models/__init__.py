"""Model builders (mirrors ``paddle_tpu/models/`` and
``examples/gpt_small.py``): BERT, the GPT decoder, ResNet, the GRU
encoder-decoder NMT with beam search and the stacked dynamic LSTM so
far; the others are queued in ROADMAP.md."""

from . import bert  # noqa: F401
from . import gpt  # noqa: F401
from . import machine_translation  # noqa: F401
from . import resnet  # noqa: F401
from . import stacked_dynamic_lstm  # noqa: F401
