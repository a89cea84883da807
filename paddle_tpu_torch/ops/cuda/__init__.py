"""Hand-written CUDA kernels for Hopper, one module per kernel (the
counterpart of ``paddle_tpu/ops/pallas/``).  Each module holds the
kernel's wrapper and its plain PyTorch version; ``_lib`` builds the
library from ``paddle_tpu_torch/csrc`` at first use and keeps the
launch counts."""

from ._lib import KERNELS, launch_counts, reset_launch_counts  # noqa: F401
