"""Collective fleet (mirrors
``paddle_tpu/incubate/fleet/collective/__init__.py``:21-217; the
reference Fluid's ``incubate/fleet/collective/__init__.py``: :135
Collective fleet, :262 CollectiveOptimizer).

``fleet.init(role_maker, init_method=None)`` reads the role and, for
more than one worker, initialises the default ``torch.distributed``
process group (``fleet_base.init_process_group``);
``CollectiveOptimizer.minimize`` runs the wrapped optimizer (recompute
inside AMP, as the reference wraps them), applies ``use_local_sgd``
(:class:`~paddle_tpu_torch.transpiler.collective.LocalSGD`) and records
the trainer count and index on the program for the data-parallel runner
(``CompiledProgram.with_data_parallel``), which exchanges the gradients.
``DistributedStrategy.auto=True`` needs the planner's search (ROADMAP.md,
Queue A item 9) and raises.  The parameter-server fleet is item 9's.
"""

import datetime
import os

from .... import io as fluid_io
from ..base.fleet_base import DistributedOptimizer, Fleet, Mode

__all__ = ["fleet", "Collective", "CollectiveOptimizer",
           "DistributedStrategy"]


class DistributedStrategy:
    """reference fleet/collective/__init__.py:25 + BuildStrategy knobs"""

    def __init__(self):
        from ....compiler import BuildStrategy, ExecutionStrategy

        self.exec_strategy = ExecutionStrategy()
        self.build_strategy = BuildStrategy()
        self.use_amp = False
        self.amp_loss_scaling = 2 ** 15
        self.use_recompute = False
        self.recompute_checkpoints = []
        self.use_local_sgd = False
        self.mode = "collective"
        self.collective_mode = "grad_allreduce"
        self.nccl_comm_num = 1
        self.auto = False


class Collective(Fleet):
    def __init__(self):
        super().__init__(Mode.COLLECTIVE)
        self._local_ip = 0

    def init(self, role_maker=None, init_method=None):
        super().init(role_maker, init_method=init_method)
        self._init_process_group()

    def init_worker(self):
        pass

    def barrier_worker(self, timeout=None):
        """All-worker rendezvous with a bounded wait (env
        ``PADDLE_TPU_BARRIER_TIMEOUT_S``, default 600): a peer that died
        surfaces as :class:`~paddle_tpu_torch.resilience.watchdog.
        WorkerLostError` instead of an unbounded hang."""
        import torch.distributed as dist

        if self.worker_num() <= 1 or not dist.is_initialized():
            return
        from ....resilience.watchdog import WorkerLostError

        if timeout is None:
            timeout = float(os.environ.get(
                "PADDLE_TPU_BARRIER_TIMEOUT_S", "600"))
        try:
            if dist.get_backend() == "gloo":
                dist.monitored_barrier(
                    timeout=datetime.timedelta(seconds=timeout))
            else:
                dist.barrier()
        except RuntimeError as e:
            raise WorkerLostError("fleet worker barrier: %s" % e) from e

    def init_server(self, model_dir=None):
        raise NotImplementedError(
            "Collective fleet has no servers; all members are workers"
        )

    def run_server(self):
        raise NotImplementedError(
            "Collective fleet has no servers; all members are workers"
        )

    def stop_worker(self):
        pass

    def distributed_optimizer(self, optimizer, strategy=None):
        self._optimizer = CollectiveOptimizer(optimizer, strategy)
        self._optimizer._fleet = self
        return self._optimizer

    def save_inference_model(self, executor, dirname, feeded_var_names=None,
                             target_vars=None, main_program=None,
                             export_for_deployment=True):
        return fluid_io.save_inference_model(
            dirname, feeded_var_names, target_vars, executor, main_program,
        )

    def save_persistables(self, executor, dirname, main_program=None,
                          filename=None):
        return fluid_io.save_persistables(executor, dirname, main_program,
                                          filename)


fleet = Collective()


class CollectiveOptimizer(DistributedOptimizer):
    """reference :262 — wraps a regular optimizer; after minimize, the
    program carries the trainer topology for the runner."""

    def __init__(self, optimizer, strategy=None):
        super().__init__(optimizer, strategy or DistributedStrategy())
        self._fleet = None

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return self._optimizer.backward(
            loss, startup_program, parameter_list, no_grad_set, callbacks
        )

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        if self._strategy and getattr(self._strategy, "auto", False):
            raise NotImplementedError(
                "DistributedStrategy.auto=True needs the auto-parallel "
                "planner's search, which is not ported (ROADMAP.md, "
                "Queue A item 9)")
        # the wrapper chain is built per call; recompute sits inner and
        # AMP outermost, so the bf16 rewrite scans the flat graph before
        # segments move into recompute_block sub-blocks
        opt = self._optimizer
        if self._strategy and getattr(self._strategy, "use_recompute",
                                      False):
            cps = getattr(self._strategy, "recompute_checkpoints",
                          None) or []
            if not cps:
                raise ValueError(
                    "DistributedStrategy.use_recompute needs "
                    "recompute_checkpoints (the segment-boundary vars); "
                    "alternatively build regions with "
                    "fluid.layers.recompute()")
            from ....optimizer import RecomputeOptimizer

            opt = RecomputeOptimizer(opt)
            opt._set_checkpoints(cps)
        if self._strategy and getattr(self._strategy, "use_amp", False):
            from ....contrib import mixed_precision

            opt = mixed_precision.decorate(
                opt,
                init_loss_scaling=float(getattr(
                    self._strategy, "amp_loss_scaling", 2 ** 15)))
        ops, params_grads = opt.minimize(
            loss, startup_program, parameter_list, no_grad_set
        )
        program = loss.block.program
        if self._fleet is not None:
            program._num_trainers = self._fleet.worker_num()
            program._trainer_id = self._fleet.worker_index()
        if self._strategy and getattr(self._strategy, "use_local_sgd",
                                      False):
            from ....framework import default_startup_program
            from ....transpiler.collective import LocalSGD

            LocalSGD().transpile(
                program=program,
                startup_program=startup_program
                or default_startup_program(),
                rank=getattr(program, "_trainer_id", 0),
                nranks=getattr(program, "_num_trainers", 1),
            )
        return ops, params_grads

    def main_program(self):
        from ....framework import default_main_program

        return default_main_program()
