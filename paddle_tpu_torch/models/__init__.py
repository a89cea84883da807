"""Model builders (mirrors ``paddle_tpu/models/`` and
``examples/gpt_small.py``): BERT, the GPT decoder, ResNet, SE-ResNeXt,
VGG-16, the GRU encoder-decoder NMT with beam search, the stacked
dynamic LSTM, the CTR models (DeepFM, Wide&Deep) and MNIST: every model
family of the reference."""

from . import bert  # noqa: F401
from . import ctr  # noqa: F401
from . import gpt  # noqa: F401
from . import machine_translation  # noqa: F401
from . import mnist  # noqa: F401
from . import resnet  # noqa: F401
from . import se_resnext  # noqa: F401
from . import stacked_dynamic_lstm  # noqa: F401
from . import vgg  # noqa: F401
