"""Fleet base (mirrors ``paddle_tpu/incubate/fleet/base/fleet_base.py``;
the reference Fluid's ``incubate/fleet/base/fleet_base.py``).

Where the reference starts JAX's coordination service
(``init_jax_distributed``, :13-45, :97-118), ``Fleet.init`` initialises
the default ``torch.distributed`` process group for a job of more than
one worker (:func:`init_process_group`): NCCL when every rank has a card
of its own, gloo otherwise (ranks that share a card, or the CPU).  The
rendezvous is ``init_method`` when given (the tests pass a ``file://``
store), else ``tcp://`` + ``PADDLE_COORDINATOR_ADDRESS`` or the first
trainer endpoint, as the reference picks its coordinator.
"""

import abc
import os

__all__ = ["Fleet", "DistributedOptimizer", "Mode", "init_process_group"]


def _backend(num_processes):
    import torch

    if torch.cuda.is_available() \
            and torch.cuda.device_count() >= num_processes:
        return "nccl"
    return "gloo"


def init_process_group(init_method, num_processes, process_id,
                       backend=None):
    """Initialise the default process group (rank ``process_id`` of
    ``num_processes``) unless one is; → the backend.  With NCCL the rank
    takes the card of its index first."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() != num_processes \
                or dist.get_rank() != process_id:
            raise RuntimeError(
                "a torch.distributed group is already initialised as rank "
                "%d of %d, but the fleet's role is rank %d of %d"
                % (dist.get_rank(), dist.get_world_size(), process_id,
                   num_processes))
        return dist.get_backend()
    backend = backend or _backend(num_processes)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return backend


class Mode:
    TRANSPILER = 1
    PSLIB = 2
    COLLECTIVE = 3


class Fleet(abc.ABC):
    def __init__(self, mode):
        self._is_initialized = False
        self._mode = mode
        self._optimizer = None
        self._role_maker = None
        self._executor = None
        self._init_method = None

    def is_first_worker(self):
        return self._role_maker.is_first_worker()

    def worker_index(self):
        return self._role_maker.worker_index()

    def worker_num(self):
        return self._role_maker.worker_num()

    def is_worker(self):
        return self._role_maker.is_worker()

    def server_num(self):
        return self._role_maker.server_num()

    def server_index(self):
        return self._role_maker.server_index()

    def is_server(self):
        return self._role_maker.is_server()

    def worker_endpoints(self, to_string=False):
        eps = self._role_maker.get_trainer_endpoints()
        return ",".join(eps) if to_string else eps

    def server_endpoints(self, to_string=False):
        eps = self._role_maker.get_pserver_endpoints()
        return ",".join(eps) if to_string else eps

    def split_files(self, files):
        """Shard a filelist across workers (reference fleet_base.py
        split_files) — the data side of multi-worker DP."""
        trainer_id = self.worker_index()
        trainers = self.worker_num()
        return files[trainer_id::trainers]

    def init(self, role_maker=None, init_method=None):
        from .role_maker import PaddleCloudRoleMaker

        self._role_maker = role_maker or PaddleCloudRoleMaker()
        self._role_maker.generate_role()
        self._init_method = init_method
        self._is_initialized = True

    def _init_process_group(self):
        """Initialise the default process group when the role maker
        reports more than one worker; nothing for one."""
        n = self.worker_num()
        if n <= 1:
            return None
        method = self._init_method
        if method is None:
            coord = os.environ.get("PADDLE_COORDINATOR_ADDRESS")
            if coord is None:
                eps = self.worker_endpoints()
                coord = eps[0] if eps else None
            if coord is None:
                raise RuntimeError(
                    "fleet.init: %d workers but no rendezvous: pass "
                    "init_method=, or set PADDLE_COORDINATOR_ADDRESS or "
                    "PADDLE_TRAINER_ENDPOINTS" % n)
            method = "tcp://" + coord
        return init_process_group(method, n, self.worker_index())

    @abc.abstractmethod
    def init_worker(self):
        pass

    @abc.abstractmethod
    def init_server(self, model_dir=None):
        pass

    @abc.abstractmethod
    def run_server(self):
        pass

    @abc.abstractmethod
    def stop_worker(self):
        pass

    @abc.abstractmethod
    def distributed_optimizer(self, optimizer, strategy=None):
        pass

    @abc.abstractmethod
    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None,
                             export_for_deployment=True):
        pass

    @abc.abstractmethod
    def save_persistables(self, executor, dirname, main_program=None):
        pass


class DistributedOptimizer(abc.ABC):
    def __init__(self, optimizer, strategy=None):
        self._optimizer = optimizer
        self._strategy = strategy

    @abc.abstractmethod
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        pass

    @abc.abstractmethod
    def apply_gradients(self, params_grads):
        pass

    @abc.abstractmethod
    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        pass
