"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The same Fluid-style static-graph API (``Program`` built by the layers
DSL, ``Executor``, ``backward.append_backward``, ``optimizer.Adam`` /
``SGD``, ``io.save_inference_model``, ``inference.AnalysisPredictor``,
``serving.PredictorServer``), run by PyTorch on an NVIDIA GPU.  The
reference package's Pallas TPU kernels become kernels
written by hand for Hopper under ``csrc/`` (built with ``nvcc`` at first
use, bound with ``ctypes``: :mod:`paddle_tpu_torch.ops.cuda`).  Entry
points run on the GPU (``CUDAPlace(0)``) unless the caller asks for the
CPU (``CPUPlace()``, ``AnalysisConfig.disable_gpu()``); on the CPU each
kernel's plain PyTorch version runs instead.  ``TPUPlace`` is an alias
of ``CUDAPlace`` so scripts written for the reference still run.

This package imports nothing of ``jax`` or ``paddle_tpu``.  What is
ported so far, and what is queued, is in ROADMAP.md.
"""

from . import core
from . import unique_name
from .framework import (
    Program, Block, Operator, Variable, Parameter, program_guard,
    name_scope, default_main_program, default_startup_program,
    switch_main_program, switch_startup_program, cpu_places, cuda_places,
    tpu_places, device_places)
from .core import CPUPlace, CUDAPlace, TPUPlace
from .param_attr import ParamAttr, WeightNormParamAttr
from . import initializer
from . import ops
from . import layers
from . import backward
from . import clip
from . import regularizer
from . import optimizer
from .backward import append_backward, gradients
from .executor import Executor, Scope, global_scope, scope_guard
from . import pipeline
from . import io
from . import analysis
from . import inference
from . import static_analysis
from . import serving
from . import models
from . import convert
from . import quant
from . import transpiler

__all__ = [
    "Program", "Block", "Operator", "Variable", "Parameter",
    "program_guard", "name_scope", "default_main_program",
    "default_startup_program", "switch_main_program",
    "switch_startup_program", "cpu_places", "cuda_places", "tpu_places",
    "device_places", "CPUPlace", "CUDAPlace", "TPUPlace", "ParamAttr",
    "WeightNormParamAttr", "Executor", "Scope", "global_scope",
    "scope_guard", "core", "unique_name", "initializer", "ops", "layers",
    "pipeline", "io", "analysis", "inference", "static_analysis",
    "serving", "models", "convert", "backward", "clip", "regularizer",
    "optimizer", "append_backward", "gradients", "quant", "transpiler",
]
