"""CompiledProgram with its build and execution strategies (mirrors
``paddle_tpu/compiler.py``; the reference Fluid's
``python/paddle/fluid/compiler.py`` and ``details/build_strategy.h:36``).

Every knob of ``BuildStrategy`` and ``ExecutionStrategy`` is here with
the reference's default.  ``CompiledProgram(main)`` with no data
parallelism, accumulation or iterations goes straight to
``Executor.run`` with the fusion config the strategy's ``fuse_*`` knobs
give (the reference's fast path, :198-222): the same step, the same
cache entry and CUDA graph replays as a plain ``Executor.run`` when the
knobs are at their defaults.  Otherwise the step runs through the
data-parallel runner (:class:`paddle_tpu_torch.parallel.SPMDRunner`):
one process per rank of the default ``torch.distributed`` group, each
fed its own rows, the gradients exchanged by the collective ops the
runner's ``GradAllReduce`` clone carries; with no group (world 1) the
runner is the executor plus the strategy's knobs
(``num_iteration_per_run``, ``batch_merge_repeat``,
``shard_optimizer_state``).

Where the reference's knobs meant XLA-specific things the port keeps
their meaning for the port's runner: ``sync_batch_norm`` needs no
setting (a world-N runner always sums batch norm's statistics over the
ranks, as GSPMD does in the reference), ``remat`` warns as there,
``reduce_strategy=Reduce`` and ``GradientScaleStrategy.Customized``
warn and proceed with all-reduce and 1/N averaging, and
``tensor_parallel_degree > 1`` raises (ROADMAP.md, Queue A item 7).
"""

__all__ = ["CompiledProgram", "BuildStrategy", "ExecutionStrategy"]


class BuildStrategy:
    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = (
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        )
        self.memory_optimize = False
        self.enable_inplace = True  # buffer donation
        # the fuse_* knobs drive the cost-guided fusion pass
        # pipeline (static_analysis/fusion.py), the realization of
        # the reference's fuse_all_reduce_op_pass /
        # fuse_elewise_add_act_pass / fuse_optimizer_ops_pass:
        #   fuse_all_reduce_ops      -> bucketed gradient allreduce
        #                               (PADDLE_TPU_ALLREDUCE_BUCKET_MB)
        #   fuse_elewise_add_act_ops -> fused_bias_act +
        #                               fused_dropout_add_ln rewrites
        #   fuse_all_optimizer_ops   -> multi-tensor fused_adam/fused_sgd
        #                               (cost-gated: BERT-scale groups
        #                               are rejected, see the r04 A/B)
        # PADDLE_TPU_FUSION=0 kills the whole pipeline;
        # CompiledProgram.fusion_report() shows what fired and why not.
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = True
        self.fuse_all_optimizer_ops = True
        # pattern families beyond the reference's flags: attention
        # subgraph -> the K1 flash kernels (gated on the measured
        # engagement threshold), softmax+cross_entropy -> one
        # numerically-stable op
        self.fuse_attention = True
        self.fuse_softmax_xent = True
        # reference fuse_bn_act_ops, extended to ride the conv too:
        # conv2d -> batch_norm -> (act) becomes one fused_conv_bn_act
        # (the K4 epilogue kernels); lookup_table/embedding on device
        # tables dispatch to the K3 gather kernel.  Both gates weigh
        # predicted deltas by the autotune calibration factors
        # (paddle_tpu_torch.autotune) when a sweep recorded them.
        self.fuse_bn_act_ops = True
        self.fuse_embedding_gather = True
        self.enable_sequential_execution = False
        self.remove_unnecessary_lock = True
        self.num_trainers = 1
        self.trainer_id = 0
        self.trainers_endpoints = []
        # a world-N runner always sums batch norm's statistics over the
        # ranks (ops/nn.py), as the reference's GSPMD does: the knob is
        # kept for API parity
        self.sync_batch_norm = False
        self.nccl_comm_num = 1
        self.use_hierarchical_allreduce = False
        # the reference's extensions
        # remat: the reference honours it in pipeline stages and ring
        # attention; the executor path warns (pick recompute regions at
        # the model level)
        self.remat = False
        # ZeRO-1: each rank keeps its dim-0 rows of every param-shaped
        # optimizer accumulator (Adam moments etc.) whose dim 0 the world
        # size divides; optimizer memory drops by the world size
        # (parallel/__init__.py)
        self.shard_optimizer_state = False
        self.donate_params = True
        # microbatch gradient accumulation (reference
        # ir/multi_batch_merge_pass.cc "repeat"): split the batch into k
        # microbatches, run fwd+bwd on each accumulating grads, apply the
        # optimizer once on the average (executor._accumulated_step)
        self.batch_merge_repeat = 1
        # tensor parallelism (the reference's own extension): not
        # ported, > 1 raises (ROADMAP.md, Queue A item 7)
        self.tensor_parallel_degree = 1


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 1
        self.num_iteration_per_run = 1
        self.use_thread_barrier = False


class CompiledProgram:
    def __init__(self, program_or_graph, build_strategy=None):
        self._program = program_or_graph
        self._build_strategy = build_strategy or BuildStrategy()
        self._is_data_parallel = False
        self._loss_name = None
        self._exec_strategy = None
        self._places = None
        self._share_vars_from = None
        self._parallel_runner = None
        self._last_fusion_report = None
        self._last_fusion_key = None

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        self._is_data_parallel = True
        self._loss_name = loss_name
        if build_strategy is not None:
            self._build_strategy = build_strategy
        self._warn_inert_knobs(self._build_strategy)
        self._exec_strategy = exec_strategy or ExecutionStrategy()
        self._places = places
        self._share_vars_from = share_vars_from
        return self

    @staticmethod
    def _warn_inert_knobs(bs):
        """A user porting reference code must not get silently different
        behavior: warn for knobs this backend does not honor."""
        import warnings

        if bs.reduce_strategy != BuildStrategy.ReduceStrategy.AllReduce:
            warnings.warn(
                "BuildStrategy.reduce_strategy=Reduce has no TPU "
                "equivalent: GSPMD always emits fused all-reduce over ICI; "
                "proceeding with AllReduce semantics", stacklevel=3)
        if (bs.gradient_scale_strategy
                == BuildStrategy.GradientScaleStrategy.Customized):
            warnings.warn(
                "GradientScaleStrategy.Customized is not supported: scale "
                "the loss explicitly in the program instead "
                "(reference multi_devices_graph_pass ScaleLossGrad)",
                stacklevel=3)
        if getattr(bs, "remat", False):
            warnings.warn(
                "BuildStrategy.remat applies to pipeline stages "
                "(PipelineOptimizer) and ring attention only; for the "
                "plain executor pick recompute boundaries at the model "
                "level with `with fluid.layers.recompute():`",
                stacklevel=3)

    def with_inference_optimize(self, config):
        # as the reference: the inference program is clone(for_test)
        self._program = self._program.clone(for_test=True)
        return self

    @property
    def program(self):
        return self._program

    def fusion_report(self):
        """The fusion pipeline's outcome for this program under this
        BuildStrategy: applied rewrites with op coordinates and
        predicted deltas, plus matched-but-skipped patterns with the
        cost-model reason.  Resolves the fused program on demand if no
        run has happened yet (fetch-target protection then defaults to
        'nothing fetched')."""
        from .static_analysis import fusion as _fusion

        if self._parallel_runner is not None \
                and self._parallel_runner._last_fusion_report is not None:
            return self._parallel_runner._last_fusion_report
        if self._last_fusion_report is not None:
            return self._last_fusion_report
        _, report = _fusion.resolve_fused_program(
            self._program,
            config=_fusion.FusionConfig.from_build_strategy(
                self._build_strategy))
        return report

    def _run(self, executor, feed, fetch_list, scope, return_numpy):
        accum = getattr(self._build_strategy, "batch_merge_repeat", 1) or 1
        iters = int(getattr(self._exec_strategy, "num_iteration_per_run",
                            1) or 1) if self._exec_strategy else 1
        if not self._is_data_parallel and accum <= 1 and iters <= 1:
            # hand the BuildStrategy-derived fusion config to the
            # executor so the fuse_* flags are honored on the plain path
            # too — including when every pass no-ops (the executor must
            # not fall back to the default config and re-enable families
            # the strategy disabled)
            from .framework import Variable
            from .static_analysis import fusion as _fusion

            config = _fusion.FusionConfig.from_build_strategy(
                self._build_strategy)
            targets = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
            # refresh the report only when its resolve key changes —
            # steady-state steps skip the (cached) resolve entirely
            key = (config.signature(self._program), self._program._version,
                   tuple(sorted(set(targets))))
            if key != self._last_fusion_key:
                _, self._last_fusion_report = _fusion.resolve_fused_program(
                    self._program, config=config, targets=targets)
                self._last_fusion_key = key
            return executor.run(
                self._program, feed=feed, fetch_list=fetch_list,
                scope=scope, return_numpy=return_numpy,
                use_program_cache=True, _fusion_config=config,
            )
        from .parallel import SPMDRunner

        if self._parallel_runner is None:
            self._parallel_runner = SPMDRunner(
                self._program, self._build_strategy, self._places,
                data_parallel=self._is_data_parallel,
                exec_strategy=self._exec_strategy,
            )
            self._parallel_runner.loss_name = self._loss_name
        return self._parallel_runner.run(
            executor, feed, fetch_list, scope, return_numpy
        )
