"""Transpilers (mirrors ``paddle_tpu/transpiler/``): the collective
modes (``GradAllReduce``, ``LocalSGD``, ``GeoSGD``, ``AsyncSGD``) and
the ``DistributeTranspiler`` routes to them; its parameter-server mode
waits for the distributed lookup tables (ROADMAP.md, Queue A item 9)."""

from . import collective
from .collective import (AsyncSGD, Collective, GeoSGD, GradAllReduce,
                         LocalSGD, ensure_comm_ring)
from .distribute_transpiler import (DistributeTranspiler,
                                    DistributeTranspilerConfig)

__all__ = ["collective", "Collective", "GradAllReduce", "LocalSGD",
           "GeoSGD", "AsyncSGD", "ensure_comm_ring", "DistributeTranspiler",
           "DistributeTranspilerConfig", "memory_optimize",
           "release_memory"]


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0, skip_grads=False):
    """The legacy var-reuse pass (reference
    memory_optimization_transpiler.py): a recorded no-op, as in the
    reference; PyTorch's caching allocator reuses the buffers."""
    return None


def release_memory(input_program, skip_opt_set=None):
    return None
