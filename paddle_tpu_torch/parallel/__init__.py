"""Data-parallel execution and parallel planning (mirrors
``paddle_tpu/parallel/``: ``SPMDRunner`` and ``ParallelExecutor`` of
``parallel/__init__.py``:51-246, and the planner's
:class:`~.planner.ClusterSpec` with the two helpers the static-analysis
checks read; the search, pipeline, MoE, ring attention and Ulysses wait,
ROADMAP.md Queue A item 9).

How ranks map.  The reference's data parallel is one process that jits
the program over a mesh with the batch sharded (:31-49, :95-125); its
counterpart here is the reference's own multi-process branch (:112-125)
run the way Fluid's ``multi_devices_graph_pass`` runs it: one process
per rank of the default ``torch.distributed`` group, each feeding its
LOCAL rows, the gradients exchanged by collective ops in the program.
At world N > 1 the runner resolves a clone of the program with
``GradAllReduce`` applied at ``nranks = N`` (``pre_scale`` from
``gradient_scale_strategy``: ``CoeffNumDevice`` 1/N, ``One`` 1,
``Customized`` warns and takes 1/N) and binds ring 0 to the default
group itself, so the startup program needs no ``c_comm_init`` and
``exe.run(startup)`` stays as users write it; the fusion pipeline then
buckets the exchange (``c_fused_allreduce_sum`` / ``c_allreduce_quant``),
the hierarchy pass decomposes it where a ``ClusterSpec`` topology says
the ring spans slices, and the overlap pass splits the buckets into
start/wait pairs.  The clone carries ``_sync_batch_stats``, so
``batch_norm`` and ``fused_conv_bn_act`` sum their statistics over the
ranks (``ops/nn.py``), as GSPMD does in the reference.  A fetch of
``loss_name`` is the mean of the ranks' values (the mean loss of the
global batch when every rank feeds as many rows); every other fetch is
this rank's own.  With no group, or a group of one, the runner is the
executor plus the strategy's knobs.  NCCL takes one rank a device: ranks
that share a card run a gloo group (payloads staged through pinned host
memory), which checks the path and is not a collective's speed.

ZeRO-1 (``BuildStrategy.shard_optimizer_state`` or the program stamp
``_shard_optimizer_state``, :64-73).  At world N the param-shaped
optimizer accumulators whose dim 0 N divides (the reference's
:738-745) are kept as this rank's dim-0 rows: in the clone each such
update op reads ``slice`` row views of its parameter and gradient (the
update kernels write the parameter's rows in place through the view)
and a ``c_allgather`` rebuilds the whole parameter after it.  The
elementwise rules shard (``_ZERO1_RULES``); a rule that reads a whole
parameter's norm (LAMB, LARS) keeps its accumulators whole.  The
scope's ``shards`` records each sharded accumulator, so
``io.save_persistables`` writes it whole; a whole accumulator found in
the scope (after startup or a load) is cut to this rank's rows at the
next step.  The multi-tensor optimizer fusion is off under ZeRO-1, as
the reference's (:607-610, :806-809).  At world 1 ZeRO-1 is the
identity.

Telemetry as the reference's runner: a ``spmd.step`` span around a
``spmd.dispatch`` span, ``record_jit_cache`` / ``record_compile`` and
``record_step("spmd", ...)``, under the reference's cache key.  None of
the collective ops is capturable, so a world-N step runs eagerly.
"""

import time as _time

import numpy as np
import torch

from ..framework import Variable, default_main_program
from ..observability import runtime as _obs
from ..observability import tracing as _tr
from .planner import ClusterSpec, quant_bucket_mark, resolve_cluster_spec

__all__ = ["ParallelExecutor", "SPMDRunner", "ClusterSpec",
           "quant_bucket_mark", "resolve_cluster_spec", "world"]

# update rules whose every element depends only on that element of the
# parameter, gradient and accumulators: a rank can update its rows alone
_ZERO1_RULES = frozenset(("adam", "adamw", "momentum", "adamax",
                          "adagrad", "decayed_adagrad", "adadelta",
                          "rmsprop", "ftrl", "sgd"))


_EXCHANGE_OPS = frozenset(("c_allreduce_sum", "c_fused_allreduce_sum",
                           "c_allreduce_quant", "c_allreduce_start"))


def world():
    """``(world size, rank, group)`` of the default ``torch.distributed``
    group; ``(1, 0, None)`` when none is initialised."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0, None
    return dist.get_world_size(), dist.get_rank(), dist.group.WORLD


def _scale_for(build_strategy, nranks):
    """The gradients' ``pre_scale`` under ``gradient_scale_strategy``."""
    from ..compiler import BuildStrategy

    gss = getattr(build_strategy, "gradient_scale_strategy",
                  BuildStrategy.GradientScaleStrategy.CoeffNumDevice)
    if gss == BuildStrategy.GradientScaleStrategy.One:
        return 1.0
    return 1.0 / nranks


def _shard_rule_ops(program, nranks, rank):
    """ZeRO-1 on a clone: each update op of ``_ZERO1_RULES`` whose
    param-shaped accumulators dim 0 ``nranks`` divides reads row views
    of its parameter and gradient and writes the parameter's rows; a
    ``c_allgather`` rebuilds the parameter.  → {accumulator: (full dim
    0, first row)}."""
    from ..framework import Operator

    block = program.global_block()
    sharded = {}
    new_ops = []
    for op in block.ops:
        if op.type not in _ZERO1_RULES \
                or op.attrs.get("op_role") != "optimize" \
                or not op.input("Param") or not op.input("Grad"):
            new_ops.append(op)
            continue
        p = op.input("Param")[0]
        g = op.input("Grad")[0]
        pv = block._find_var_recursive(p)
        shape = list(pv.shape or [])
        accs = []
        for slot, names in op.inputs.items():
            for n in names:
                v = block._find_var_recursive(n)
                if v is not None and getattr(v, "_is_optimizer_state",
                                             False) \
                        and list(v.shape or []) == shape:
                    accs.append(n)
        if not accs or not shape or shape[0] % nranks:
            new_ops.append(op)
            continue
        rows = shape[0] // nranks
        r0 = rank * rows
        views = {}
        for n in (p, g):
            view = n + "@ZERO1_ROWS"
            v = block._find_var_recursive(n)
            block.create_var(name=view, shape=[rows] + shape[1:],
                             dtype=v.dtype)
            new_ops.append(Operator(
                block, "slice", {"Input": [n]}, {"Out": [view]},
                {"axes": [0], "starts": [r0], "ends": [r0 + rows],
                 "op_role": "optimize"}))
            views[n] = view
        for n in accs:
            block._find_var_recursive(n).shape = [rows] + shape[1:]
            sharded[n] = (shape[0], r0)

        def rename(slots):
            return {k: [views.get(n, n) for n in names]
                    for k, names in slots.items()}

        op.inputs = rename(op.inputs)
        op.outputs = rename(op.outputs)
        new_ops.append(op)
        new_ops.append(Operator(
            block, "c_allgather", {"X": [views[p]]}, {"Out": [p]},
            {"nranks": nranks, "ring_id": 0, "op_role": "optimize"}))
    block.ops = new_ops
    program._bump_version()
    return sharded


class SPMDRunner:
    """The runner behind ``CompiledProgram.with_data_parallel`` (and its
    accumulation / iterations / ZeRO-1 knobs)."""

    def __init__(self, program, build_strategy=None, places=None,
                 data_parallel=True, exec_strategy=None):
        self.program = program
        self.build_strategy = build_strategy
        tp = int(getattr(build_strategy, "tensor_parallel_degree", 1) or 1)
        if tp > 1:
            raise NotImplementedError(
                "BuildStrategy.tensor_parallel_degree=%d: tensor "
                "parallelism (the reference's own extension) is not "
                "ported (ROADMAP.md, Queue A item 7)" % tp)
        if places:
            n = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            if len(places) > n and any(
                    getattr(p, "_kind", "cuda") == "cuda" for p in places):
                raise ValueError(
                    "with_data_parallel(places=...) names %d places but "
                    "%d CUDA device(s) are visible" % (len(places), n))
        self.places = places
        self.data_parallel = bool(data_parallel)
        self.accumulate_steps = int(
            getattr(build_strategy, "batch_merge_repeat", 1) or 1)
        self.iters_per_run = int(
            getattr(exec_strategy, "num_iteration_per_run", 1) or 1)
        if self.accumulate_steps > 1 and self.iters_per_run > 1:
            raise ValueError(
                "num_iteration_per_run cannot combine with "
                "batch_merge_repeat: both wrap the step in a scan")
        # either source enables ZeRO-1: the BuildStrategy flag or the
        # program stamp (to disable a stamped program's sharding, clear
        # the stamp, as in the reference)
        self.shard_opt_state = bool(
            getattr(build_strategy, "shard_optimizer_state", False)
            or getattr(program, "_shard_optimizer_state", False))
        self.loss_name = None
        self._last_fusion_report = None
        self._cache = {}
        self._clones = {}

    def _config(self):
        from ..static_analysis import fusion as _fusion

        config = _fusion.FusionConfig.from_build_strategy(
            self.build_strategy)
        if self.shard_opt_state:
            config.fuse_optimizer = False
        return config

    def _dp_program(self, nranks, rank):
        """The world-N clone of the program: ``GradAllReduce`` at
        ``nranks``, ZeRO-1's row updates when on, the statistics mark.
        Cached by (program, version, world, rank)."""
        from ..compiler import BuildStrategy, CompiledProgram
        from ..framework import Program
        from ..static_analysis import fusion as _fusion
        from ..transpiler.collective import GradAllReduce

        key = (id(self.program), self.program._version, nranks, rank)
        hit = self._clones.get(key)
        if hit is not None:
            return hit
        bs = self.build_strategy or BuildStrategy()
        if bs.gradient_scale_strategy \
                == BuildStrategy.GradientScaleStrategy.Customized:
            CompiledProgram._warn_inert_knobs(bs)
        clone = self.program.clone()
        for mark in _fusion._PROGRAM_MARKS:
            if hasattr(self.program, mark):
                setattr(clone, mark, getattr(self.program, mark))
        if not any(op.type in _EXCHANGE_OPS
                   for op in clone.global_block().ops):
            # a program its user transpiled (GradAllReduce, LocalSGD, ...)
            # keeps its own exchange
            GradAllReduce().transpile(program=clone,
                                      startup_program=Program(),
                                      rank=rank, nranks=nranks)
        scale = _scale_for(bs, nranks)
        for op in clone.global_block().ops:
            if op.type == "c_allreduce_sum" and "pre_scale" in op.attrs:
                op.attrs["pre_scale"] = scale
        clone._num_trainers = nranks
        clone._trainer_id = rank
        clone._sync_batch_stats = True
        sharded = (_shard_rule_ops(clone, nranks, rank)
                   if self.shard_opt_state else {})
        for k in [k for k in self._clones if k[0] == key[0]]:
            del self._clones[k]
        hit = self._clones[key] = (clone, sharded)
        return hit

    @staticmethod
    def _shard_scope(scope, sharded, nranks, group):
        """Each sharded accumulator as this rank's rows: a whole one
        (after startup or a load) is cut; the scope's ``shards`` records
        it for ``io.save_vars``."""
        from ..ops.registry import np_to_torch

        for n, (full, r0) in sharded.items():
            owner = scope._owner_of(n)
            val = owner.vars.get(n)
            if val is None:
                continue
            rows = full // nranks
            if val.shape[0] == full:
                if not isinstance(val, torch.Tensor):
                    val = np_to_torch(val, torch.device("cpu"))
                owner.vars[n] = val[r0:r0 + rows].clone()
            owner.shards[n] = (full, r0, group)

    def run(self, executor, feed, fetch_list, scope, return_numpy):
        from ..executor import global_scope
        from ..ops import comm
        from ..pipeline import FetchHandle, host_values
        from ..static_analysis import fusion as _fusion

        if scope is None:
            scope = global_scope()
        feed = feed or {}
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        nranks, rank, group = world() if self.data_parallel \
            else (1, 0, None)
        config = self._config()
        if nranks > 1:
            program, sharded = self._dp_program(nranks, rank)
            scope.rings[0] = group
            if sharded:
                self._shard_scope(scope, sharded, nranks, group)
        else:
            program = self.program
        resolved, self._last_fusion_report = \
            _fusion.resolve_fused_program(program, config=config,
                                          targets=fetch_names)
        sig = tuple((n, tuple(np.shape(v)), str(getattr(v, "dtype", "")))
                    for n, v in sorted(feed.items()))
        key_tuple = (id(resolved), resolved._version, id(scope), sig,
                     tuple(fetch_names), False,
                     getattr(resolved, "_fusion_sig", None))
        hit = key_tuple in self._cache
        _obs.record_jit_cache(hit, runner="spmd")
        cur_step = executor._step
        t_step = _time.perf_counter()
        step_span = (_tr.span("spmd.step", step=cur_step)
                     if _tr.sample_step(cur_step) else _tr.NULL_SPAN)
        if step_span.recording:
            for ring, shape in _obs.collective_step_shape().items():
                step_span.set_attr(ring, shape)
        with step_span:
            with _tr.span_if_traced("spmd.dispatch"):
                out = executor.run(
                    resolved, feed=feed, fetch_list=fetch_names,
                    scope=scope, return_numpy=False,
                    _fusion_config=config,
                    _accumulate=self.accumulate_steps,
                    _iters=self.iters_per_run)
            dispatch_ms = (_time.perf_counter() - t_step) * 1000.0
            if not hit:
                self._cache[key_tuple] = True
                _obs.record_compile(dispatch_ms, runner="spmd")
            vals = [h.device_value for h in out]
            if nranks > 1 and self.loss_name in fetch_names:
                i = fetch_names.index(self.loss_name)
                loss = vals[i]
                vals[i] = comm.all_reduce_sum(
                    loss * torch.tensor(1.0 / nranks, dtype=loss.dtype,
                                        device=loss.device), group)
            result = host_values(vals) if return_numpy \
                else [FetchHandle(v) for v in vals]
        _obs.record_step("spmd", cur_step,
                         (_time.perf_counter() - t_step) * 1000.0,
                         dispatch_ms=dispatch_ms)
        return result


class ParallelExecutor:
    """Reference-API shim (``python/paddle/fluid/parallel_executor.py``)
    over the runner."""

    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None):
        from .. import core
        from ..executor import Executor, global_scope

        self._program = main_program or default_main_program()
        self._scope = scope or global_scope()
        self._runner = SPMDRunner(self._program, build_strategy,
                                  exec_strategy=exec_strategy)
        self._runner.loss_name = loss_name
        self._exe = Executor(core.CUDAPlace(0) if use_cuda
                             else core.CPUPlace())

    @property
    def device_count(self):
        return world()[0]

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        feed = feed if feed is not None else feed_dict
        return self._runner.run(self._exe, feed, fetch_list, self._scope,
                                return_numpy)

    def drop_local_exe_scopes(self):
        """reference ParallelExecutor.drop_local_exe_scopes: the runner's
        cached state is its clones and cache records, which this drops."""
        self._runner._cache.clear()
        self._runner._clones.clear()
