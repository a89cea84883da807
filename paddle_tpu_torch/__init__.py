"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The same Fluid-style API: the static graph (``Program`` built by the layers
DSL, ``Executor``, ``backward.append_backward``, ``optimizer.Adam`` /
``SGD``, ``io.save_inference_model``, ``inference.AnalysisPredictor``,
``serving.PredictorServer``), the imperative mode (``dygraph``) and the
data path (``DatasetFactory`` datasets with ``Executor.train_from_dataset``,
host-resident tables, ``PyReader`` / ``DataLoader``, ``DataFeeder``,
``fluid.batch`` and the reader decorators, ``datasets.mnist``), run by
PyTorch on an NVIDIA GPU.  The reference package's Pallas TPU kernels become kernels
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
from . import average
from .framework import (
    Program, Block, Operator, Variable, Parameter, program_guard,
    name_scope, default_main_program, default_startup_program,
    switch_main_program, switch_startup_program, cpu_places, cuda_places,
    tpu_places, device_places, in_dygraph_mode)
from .core import CPUPlace, CUDAPlace, TPUPlace, set_flags, get_flags
from .param_attr import ParamAttr, WeightNormParamAttr
from . import initializer
from . import ops
from . import layers
from . import backward
from . import clip
from . import regularizer
from . import optimizer
from .backward import append_backward, gradients
from .clip import (GradientClipByGlobalNorm, GradientClipByNorm,
                   GradientClipByValue)
from .executor import Executor, Scope, global_scope, scope_guard
from .compiler import BuildStrategy, CompiledProgram, ExecutionStrategy
from . import pipeline
from . import io
from . import analysis
from . import inference
from . import static_analysis
from .static_analysis import analyze_program, verify_program
from . import serving
from . import nets
from . import models
from . import convert
from . import quant
from . import transpiler
from .transpiler import DistributeTranspiler, DistributeTranspilerConfig
from . import parallel
from .parallel import ParallelExecutor
from . import incubate
from . import contrib
from . import profiler
from . import autotune
from . import resilience
from . import dygraph
from . import dygraph_grad_clip
from .dygraph.base import enable_dygraph, disable_dygraph
from . import trainer_desc
from . import device_worker
from . import native
from . import recordio_writer
from . import reader_decorators
from . import reader
from . import host_table
from . import datasets
from .data_feeder import DataFeeder
from .data_feed_desc import DataFeedDesc
from .dataset import DatasetFactory
from .lod_tensor import (LoDTensor, LoDTensorArray, create_lod_tensor,
                         create_random_int_lodtensor)
from .reader import DataLoader, PyReader
from .reader_decorators import batch

__all__ = [
    "Program", "Block", "Operator", "Variable", "Parameter",
    "program_guard", "name_scope", "default_main_program",
    "default_startup_program", "switch_main_program",
    "switch_startup_program", "cpu_places", "cuda_places", "tpu_places",
    "device_places", "CPUPlace", "CUDAPlace", "TPUPlace", "set_flags",
    "get_flags", "ParamAttr",
    "WeightNormParamAttr", "Executor", "Scope", "global_scope",
    "scope_guard", "CompiledProgram", "BuildStrategy", "ExecutionStrategy",
    "ParallelExecutor", "DistributeTranspiler",
    "DistributeTranspilerConfig", "parallel", "incubate", "core",
    "unique_name", "initializer", "ops", "layers",
    "pipeline", "io", "analysis", "inference", "static_analysis",
    "serving", "nets", "models", "convert", "backward", "clip", "regularizer",
    "optimizer", "append_backward", "gradients", "quant", "transpiler",
    "contrib", "profiler", "autotune", "verify_program", "analyze_program",
    "average", "resilience", "dygraph", "dygraph_grad_clip",
    "in_dygraph_mode", "enable_dygraph", "disable_dygraph",
    "GradientClipByGlobalNorm", "GradientClipByNorm", "GradientClipByValue",
    "trainer_desc", "device_worker", "native", "recordio_writer",
    "reader_decorators", "reader", "host_table", "datasets", "DataFeeder",
    "DataFeedDesc", "DatasetFactory", "LoDTensor", "LoDTensorArray",
    "create_lod_tensor", "create_random_int_lodtensor", "DataLoader",
    "PyReader", "batch",
]
