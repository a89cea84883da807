"""DistributeTranspiler, its collective modes (mirrors
``paddle_tpu/transpiler/distribute_transpiler.py``: the reference
Fluid's ``python/paddle/fluid/transpiler/distribute_transpiler.py:377``).

- ``nccl2`` records the trainer topology on the program
  (``_trainer_id``, ``_num_trainers``); the program stays local and the
  data-parallel runner (``CompiledProgram.with_data_parallel``,
  ``parallel/__init__.py``) exchanges its gradients at its world size.
- ``grad_allreduce`` / ``collective`` insert the ``c_allreduce_sum`` ops
  (:class:`~.collective.GradAllReduce`), ``local_sgd`` the delta
  averaging (:class:`~.collective.LocalSGD`), and ``geo_sgd_mode`` the
  gated delta averaging (:class:`~.collective.GeoSGD`), as the
  reference does (:106-205).
- ``pserver`` (the reference's default), its ``sync_mode=False``
  AsyncSGD route and ``mode="auto"`` raise ``NotImplementedError``: they
  need the distributed lookup tables and the planner's search
  (ROADMAP.md, Queue A item 9).
"""

import numpy as np

from ..framework import default_main_program, default_startup_program

__all__ = ["DistributeTranspiler", "DistributeTranspilerConfig",
           "slice_variable"]

_QUEUE_A9 = ("needs the distributed lookup tables and the auto-parallel "
             "planner, which are not ported (ROADMAP.md, Queue A item 9)")


class DistributeTranspilerConfig:
    """reference distribute_transpiler.py:131"""

    slice_var_up = True
    split_method = None
    min_block_size = 8192
    enable_dc_asgd = False
    sync_mode = True
    runtime_split_send_recv = False
    geo_sgd_mode = False
    geo_sgd_need_push_nums = 100
    mode = "pserver"
    print_log = False
    wait_port = True
    collective_mode = None
    auto = False


def slice_variable(var_list, slice_count, min_block_size=8192):
    """Param slicing plan (reference distribute_transpiler.py:85)."""
    blocks = []
    for var in var_list:
        split_count = slice_count
        var_numel = int(np.prod(var.shape))
        max_pserver_count = int(var_numel / min_block_size)
        if max_pserver_count == 0:
            max_pserver_count = 1
        if max_pserver_count < slice_count:
            split_count = max_pserver_count
        block_size = int((var_numel + split_count - 1) / split_count)
        if len(var.shape) >= 2:
            dim1 = int(np.prod(var.shape[1:]))
            remains = block_size % dim1
            if remains != 0:
                block_size += dim1 - remains
        split_count = int((var_numel + block_size - 1) / block_size)
        for block_id in range(split_count):
            curr_block_size = min(block_size,
                                  var_numel - (block_id * block_size))
            blocks.append("%s:%d:%d" % (var.name, block_id, curr_block_size))
    return blocks


class DistributeTranspiler:
    def __init__(self, config=None):
        self.config = config or DistributeTranspilerConfig()
        self.trainer_id = 0
        self.trainers = 1
        self.endpoints = []

    def transpile(self, trainer_id, program=None, pservers="127.0.0.1:6174",
                  trainers=1, sync_mode=True, startup_program=None,
                  current_endpoint="127.0.0.1:6174"):
        program = program or default_main_program()
        startup_program = startup_program or default_startup_program()
        self.trainer_id = trainer_id
        mode = getattr(self.config, "mode", "pserver")
        if isinstance(trainers, str):
            self.endpoints = trainers.split(",")
            self.trainers = len(self.endpoints)
        else:
            self.trainers = int(trainers)
        if mode == "auto" or getattr(self.config, "auto", False):
            raise NotImplementedError(
                "DistributeTranspiler mode='auto' (the planner-routed "
                "transpile) " + _QUEUE_A9)
        if getattr(self.config, "geo_sgd_mode", False):
            from .collective import GeoSGD

            program._trainer_id = trainer_id
            program._num_trainers = self.trainers
            GeoSGD(need_push_nums=getattr(
                self.config, "geo_sgd_need_push_nums", 100)).transpile(
                program=program, startup_program=startup_program,
                rank=trainer_id, nranks=self.trainers,
            )
            return
        if mode == "pserver":
            raise NotImplementedError(
                "DistributeTranspiler mode='pserver'%s "
                % ("" if sync_mode and getattr(self.config, "sync_mode",
                                               True)
                   else " with sync_mode=False (AsyncSGD)") + _QUEUE_A9
                + "; the collective modes (nccl2, grad_allreduce, "
                "collective, local_sgd, geo_sgd_mode) run")
        if mode in ("nccl2", "grad_allreduce", "collective", "local_sgd"):
            program._trainer_id = trainer_id
            program._num_trainers = self.trainers
            if mode == "local_sgd":
                from .collective import LocalSGD

                LocalSGD().transpile(
                    program=program, startup_program=startup_program,
                    rank=trainer_id, nranks=self.trainers,
                )
            elif mode in ("grad_allreduce", "collective"):
                from .collective import GradAllReduce

                GradAllReduce().transpile(
                    program=program, startup_program=startup_program,
                    rank=trainer_id, nranks=self.trainers,
                )
            return
        raise ValueError(
            "unknown transpiler mode %r: supported are pserver, nccl2, "
            "grad_allreduce, collective, local_sgd" % (mode,)
        )

    def get_trainer_program(self, wait_port=True):
        return default_main_program()

    def get_pserver_program(self, endpoint):
        raise NotImplementedError("pserver programs " + _QUEUE_A9)

    def get_pserver_programs(self, endpoint):
        raise NotImplementedError("pserver programs " + _QUEUE_A9)

    def get_startup_program(self, endpoint, pserver_program=None,
                            startup_program=None):
        raise NotImplementedError("pserver startup programs " + _QUEUE_A9)
