"""Dygraph data parallel (mirrors ``paddle_tpu/dygraph/parallel.py``:
``ParallelEnv`` reading the ``PADDLE_*`` variables, ``prepare_context``,
``DataParallel`` with ``scale_loss`` and ``apply_collective_grads``).

``prepare_context`` starts a ``torch.distributed`` group where the
reference starts ``jax.distributed``: at more than one rank with
endpoints, rank 0's endpoint is the rendezvous (``tcp://``), over NCCL
where there is a card and gloo otherwise.  ``DataParallel`` is transparent
at one rank; the reference's multi-process gradient exchange is not
written yet, so ``apply_collective_grads`` raises at more than one, as
the reference's does."""

import os

from .layers import Layer

__all__ = ["DataParallel", "ParallelEnv", "prepare_context", "Env"]


class ParallelEnv:
    def __init__(self):
        self._nranks = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self._local_rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._trainer_endpoints = [e for e in eps.split(",") if e]
        self._current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def nranks(self):
        return self._nranks

    @property
    def local_rank(self):
        return self._local_rank

    @property
    def dev_id(self):
        return self._local_rank

    @property
    def current_endpoint(self):
        return self._current_endpoint

    @property
    def trainer_endpoints(self):
        return self._trainer_endpoints


Env = ParallelEnv


def prepare_context(strategy=None):
    env = ParallelEnv()
    if env.nranks > 1 and env.trainer_endpoints:
        # without endpoints there is no rendezvous to dial: single-host
        # local testing skips the bootstrap, as the reference does
        import torch
        import torch.distributed as dist

        if not dist.is_initialized():
            dist.init_process_group(
                "nccl" if torch.cuda.is_available() else "gloo",
                init_method="tcp://" + env.trainer_endpoints[0],
                world_size=env.nranks, rank=env.local_rank)
    return strategy


class DataParallel(Layer):
    def __init__(self, layers, strategy=None):
        super().__init__()
        self._layers = layers
        self._env = ParallelEnv()

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        if self._env.nranks <= 1:
            return loss
        return loss * (1.0 / self._env.nranks)

    def apply_collective_grads(self):
        if self._env.nranks <= 1:
            return
        raise NotImplementedError(
            "multi-process dygraph grad allreduce lands with the "
            "multi-host batch; use the static-graph data-parallel path "
            "(transpiler.GradAllReduce) for multi-card training")

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_dict(self, *a, **k):
        return self._layers.set_dict(*a, **k)

    load_dict = set_dict
