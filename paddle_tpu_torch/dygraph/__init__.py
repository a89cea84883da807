"""Imperative (dygraph) front end (mirrors ``paddle_tpu/dygraph/``).

Ops dispatch at once through the same registry the static graph uses,
on the innermost ``guard(place)``'s device (the card by default); a tape
records what they read and wrote and ``backward`` differentiates the
autograd graph they built, so the op surface is the same in both
modes."""

from .base import (guard, enabled, to_variable, enable_dygraph,
                   disable_dygraph, no_grad)
from .varbase import VarBase
from .layers import Layer
from . import nn
from .nn import (Linear, FC, Conv2D, Pool2D, BatchNorm, Embedding,
                 LayerNorm, Dropout, Conv3D, Conv2DTranspose,
                 Conv3DTranspose, GRUUnit, PRelu, BilinearTensorProduct,
                 SequenceConv, RowConv, GroupNorm, SpectralNorm, TreeConv,
                 NCE)
from .parallel import DataParallel, ParallelEnv, prepare_context
from .checkpoint import save_dygraph, load_dygraph
from .learning_rate_scheduler import (
    LearningRateDecay, PiecewiseDecay, NaturalExpDecay, ExponentialDecay,
    InverseTimeDecay, PolynomialDecay, CosineDecay, NoamDecay)
from .tape import Tape as Tracer  # the reference's imperative.Tracer role


class BackwardStrategy:
    """The reference's ``dygraph.BackwardStrategy``: its one knob,
    ``sort_sum_gradient``, orders fan-in gradient sums; autograd already
    sums them in a fixed order, so the flag is accepted and inert."""

    def __init__(self):
        self.sort_sum_gradient = False


# both naming generations of the reference's dygraph/checkpoint.py
save_persistables = save_dygraph
load_persistables = load_dygraph


def start_gperf_profiler():
    """The reference's gperftools hook, on the port's profiler."""
    from .. import profiler as _prof

    _prof.start_profiler("All")


def stop_gperf_profiler():
    from .. import profiler as _prof

    _prof.stop_profiler()


__all__ = [
    "guard", "enabled", "to_variable", "enable_dygraph", "disable_dygraph",
    "no_grad", "VarBase", "Layer", "nn", "Linear", "FC", "Conv2D",
    "Pool2D", "BatchNorm", "Embedding", "LayerNorm", "Dropout",
    "Conv3D", "Conv2DTranspose", "Conv3DTranspose", "GRUUnit", "PRelu",
    "BilinearTensorProduct", "SequenceConv", "RowConv", "GroupNorm",
    "SpectralNorm", "TreeConv", "NCE",
    "DataParallel", "ParallelEnv", "prepare_context",
    "save_dygraph", "load_dygraph",
    "LearningRateDecay", "PiecewiseDecay", "NaturalExpDecay",
    "ExponentialDecay", "InverseTimeDecay", "PolynomialDecay",
    "CosineDecay", "NoamDecay", "Tracer", "BackwardStrategy",
    "save_persistables", "load_persistables",
    "start_gperf_profiler", "stop_gperf_profiler",
]
