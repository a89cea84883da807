"""Inference stack: analysis passes + predictor API (mirrors
``paddle_tpu/inference.py``: ``fuse_conv_bn`` :37, ``AnalysisConfig``
:168, ``AnalysisPredictor`` :205, ``create_paddle_predictor`` :379).

The predictor places on ``cuda:0`` unless the config asks for the CPU
with :meth:`AnalysisConfig.disable_gpu` (the reference Fluid API name);
asking for the GPU where CUDA is unavailable raises.  ``run`` returns
numpy arrays after one batched sync; ``run_async`` returns lazy
``FetchHandle``\\ s; ``run_batches`` (reference :297) streams batches
through :class:`~paddle_tpu_torch.pipeline.DeviceFeedPipeline` with a
window of un-synced steps, behind the concurrency gate of
:mod:`.static_analysis.concurrency` when ``verify=True``.
:meth:`AnalysisConfig.enable_bf16` rewrites the analysed program to bf16
(:mod:`.contrib.mixed_precision`)."""

import os

import numpy as np

from . import io as fluid_io
from .core import CPUPlace, CUDAPlace
from .executor import Executor, Scope, scope_guard
from .ops.registry import np_to_torch
from .pipeline import host_values

__all__ = ["AnalysisConfig", "AnalysisPredictor", "create_paddle_predictor",
           "fuse_conv_bn"]


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


def fuse_conv_bn(program, scope, eps_default=1e-5):
    """Fold inference-mode batch_norm into the preceding conv2d:
    W' = W * gamma / sqrt(var + eps) per output channel and
    b' = beta - mean * gamma / sqrt(var + eps), the bn op replaced by an
    elementwise_add of b' (or folded into an existing conv bias add).
    Returns the number of folded pairs."""
    block = program.global_block()
    producers = {}
    read_count = {}
    for i, op in enumerate(block.ops):
        for name in op.input_arg_names:
            read_count[name] = read_count.get(name, 0) + 1
        for name in op.output_arg_names:
            producers[name] = (i, op)

    def get(name):
        return host_values([scope.get(name)])[0]

    def put(name, arr, like=None):
        dev = getattr(like, "device", None) or "cpu"
        scope.set(name, np_to_torch(np.ascontiguousarray(arr), dev))

    fused = 0
    i = 0
    while i < len(block.ops):
        op = block.ops[i]
        if op.type != "batch_norm" or not (
                op.attrs.get("is_test") or op.attrs.get("use_global_stats")):
            i += 1
            continue
        x_name = op.inputs["X"][0]
        if read_count.get(x_name, 0) != 1:
            i += 1
            continue
        prod = producers.get(x_name)
        conv_op = bias_add_op = None
        if prod is not None and prod[1].type in ("conv2d",
                                                 "depthwise_conv2d"):
            conv_op = prod[1]
        elif (prod is not None and prod[1].type == "elementwise_add"
              and prod[1].attrs.get("axis", -1) == 1):
            add_x = prod[1].inputs["X"][0]
            up = producers.get(add_x)
            if (up is not None
                    and up[1].type in ("conv2d", "depthwise_conv2d")
                    and read_count.get(add_x, 0) == 1):
                conv_op = up[1]
                bias_add_op = prod[1]
        if conv_op is None:
            i += 1
            continue
        conv_fmt = conv_op.attrs.get("data_format", "NCHW")
        bn_fmt = op.attrs.get("data_layout", "NCHW")
        if conv_fmt != bn_fmt or conv_fmt not in ("NCHW", "NHWC"):
            i += 1
            continue
        channels_last = conv_fmt == "NHWC"
        if channels_last and bias_add_op is not None:
            i += 1
            continue
        w_shared = read_count.get(conv_op.inputs["Filter"][0], 0) != 1
        b_shared = (bias_add_op is not None
                    and read_count.get(bias_add_op.inputs["Y"][0], 0) != 1)
        if w_shared or b_shared:
            i += 1
            continue
        scale, bias, mean, var = (get(op.inputs[s][0]) for s in
                                  ("Scale", "Bias", "Mean", "Variance"))
        eps = float(op.attrs.get("epsilon", eps_default))
        gamma_over_std = scale / np.sqrt(var + eps)
        w_name = conv_op.inputs["Filter"][0]
        w_old = scope.get(w_name)
        put(w_name, (get(w_name) * gamma_over_std[:, None, None, None])
            .astype(np.float32), w_old)
        y_name = op.outputs["Y"][0]
        if bias_add_op is not None:
            cb_name = bias_add_op.inputs["Y"][0]
            cb_old = scope.get(cb_name)
            cb = get(cb_name)
            b_new = ((cb.reshape(-1) - mean) * gamma_over_std + bias)
            put(cb_name, b_new.astype(np.float32).reshape(cb.shape), cb_old)
            bias_add_op.outputs["Out"] = [y_name]
            block._remove_op(i)
        else:
            b_new = (bias - mean * gamma_over_std).astype(np.float32)
            bias_var_name = y_name + ".fused_bn_bias"
            bias_var = block.create_var(
                name=bias_var_name, shape=(b_new.shape[0],),
                dtype="float32", persistable=True)
            bias_var.stop_gradient = True
            put(bias_var_name, b_new, w_old)
            block._remove_op(i)
            block._insert_op(
                i, type="elementwise_add",
                inputs={"X": [x_name], "Y": [bias_var_name]},
                outputs={"Out": [y_name]},
                attrs={"axis": -1 if channels_last else 1})
            i += 1
        fused += 1
    if fused:
        program._bump_version()
    return fused


class AnalysisConfig:
    """Model path, the GPU/CPU switch, IR optimisation and the pass
    pipeline (reference ``api/paddle_analysis_config.h`` subset)."""

    def __init__(self, model_dir=None, prog_file=None, params_file=None):
        from .analysis import PassBuilder

        self.model_dir = model_dir
        self.prog_file = prog_file
        self.params_file = params_file
        self._ir_optim = True
        self._use_gpu = True
        self._bf16 = False
        self._pass_builder = PassBuilder()

    def disable_gpu(self):
        """Run on the CPU (the kernels' plain versions)."""
        self._use_gpu = False

    def use_gpu(self):
        return self._use_gpu

    def switch_ir_optim(self, flag=True):
        self._ir_optim = bool(flag)

    def ir_optim(self):
        return self._ir_optim

    def enable_bf16(self, flag=True):
        """Rewrite the loaded program to bf16 after the analysis passes:
        rewriting first would put float32 casts between each conv and
        its (black-listed) batch_norm and defeat the conv + bn fold."""
        self._bf16 = bool(flag)

    def bf16_enabled(self):
        return self._bf16

    def pass_builder(self):
        return self._pass_builder


class AnalysisPredictor:
    """Load → analyze → run, with a private scope."""

    def __init__(self, config):
        self._config = config
        self._scope = Scope()
        self._place = CUDAPlace(0) if config.use_gpu() else CPUPlace()
        self._exe = Executor(self._place)
        model_dir = config.model_dir
        prog_file, params_file = config.prog_file, config.params_file
        if model_dir is None:
            if prog_file is None:
                raise ValueError("AnalysisConfig needs model_dir or prog_file")
            model_dir = os.path.dirname(os.path.abspath(prog_file))
            prog_file = os.path.basename(prog_file)
            if params_file is not None:
                params_file = os.path.basename(params_file)
        with scope_guard(self._scope):
            program, feed_names, fetch_vars = fluid_io.load_inference_model(
                model_dir, self._exe, model_filename=prog_file,
                params_filename=params_file)
            if config.ir_optim():
                from .analysis import Analyzer

                program = Analyzer(config.pass_builder()).run(
                    program, scope=self._scope,
                    targets=[v.name for v in fetch_vars])
            if config.bf16_enabled():
                from .contrib.mixed_precision import rewrite_program_bf16

                rewrite_program_bf16(program)
        self._program = program
        self._feed_names = feed_names
        self._fetch_vars = fetch_vars

    @property
    def place(self):
        return self._place

    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return [v.name for v in self._fetch_vars]

    @property
    def program(self):
        return self._program

    def run(self, inputs, return_numpy=True):
        """``inputs``: arrays in ``get_input_names()`` order, or a dict.
        Returns numpy arrays (one batched sync), or lazy handles with
        ``return_numpy=False``."""
        feed = self._as_feed(inputs)
        with scope_guard(self._scope):
            outs = self._exe.run(self._program, feed=feed,
                                 fetch_list=self._fetch_vars,
                                 return_numpy=return_numpy)
        return list(outs)

    def _as_feed(self, inputs):
        if isinstance(inputs, dict):
            return dict(inputs)
        inputs = _as_list(inputs)
        if len(inputs) != len(self._feed_names):
            raise ValueError("expected %d inputs (%s), got %d" % (
                len(self._feed_names), self._feed_names, len(inputs)))
        return dict(zip(self._feed_names, inputs))

    def run_async(self, inputs):
        """Dispatch one batch without waiting: lazy ``FetchHandle``\\ s."""
        return self.run(inputs, return_numpy=False)

    def run_batches(self, batches, max_in_flight=2, return_numpy=True,
                    verify=False, request_ids=None):
        """Streamed serving loop: a generator yielding one result list per
        input batch, keeping up to ``max_in_flight`` dispatched batches'
        results un-synced while a background thread stages upcoming feeds
        on the device (:class:`~paddle_tpu_torch.pipeline.DeviceFeedPipeline`,
        on this predictor's place).

        ``max_in_flight`` is the latency-vs-throughput knob: 1 is the
        synchronous loop, 2-4 overlap host preparation and copies with
        device compute.  With ``return_numpy=False`` the generator yields
        un-synced handles and never blocks on results.

        ``verify=True`` gates entry on the static concurrency analyzer:
        the program the executor will run (its fused twin included) is
        race-checked at this in-flight depth and certified free of
        host-sync points; a finding raises ``VerifyError`` naming the op,
        before any batch is dispatched.

        Every batch is validated against the program's ``need_check_feed``
        declarations as it is staged, so a malformed feed raises a
        ``ValueError`` naming the batch — by the matching entry of
        ``request_ids`` when given."""
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1, got %d"
                             % max_in_flight)
        # the serving-path marks: strict-sync promotion + the in-flight
        # depth the race checks assume for this program from now on
        self._program._serving_hot_loop = True
        self._program._max_in_flight = max(
            max_in_flight,
            int(getattr(self._program, "_max_in_flight", 1) or 1))
        if verify:
            from .static_analysis.concurrency import verify_async_hot_path

            verify_async_hot_path(
                self._program,
                targets=[v.name for v in self._fetch_vars],
                max_in_flight=max_in_flight, label="serving hot loop")
        if request_ids is not None:
            request_ids = list(request_ids)
        return self._run_batches(batches, max_in_flight, return_numpy,
                                 request_ids)

    def _run_batches(self, batches, max_in_flight, return_numpy,
                     request_ids=None):
        import collections

        from . import pipeline as pl
        from .executor import _check_feed_shapes

        def feeds():
            for i, b in enumerate(batches):
                rid = None
                if request_ids is not None and i < len(request_ids):
                    rid = request_ids[i]
                try:
                    feed = self._as_feed(b)
                    _check_feed_shapes(self._program, feed)
                except ValueError as exc:
                    who = ("request %r (batch #%d)" % (rid, i)
                           if rid is not None else "batch #%d" % i)
                    raise ValueError("%s: %s" % (who, exc)) from None
                yield feed

        def finish(handles):
            return pl.materialize(handles) if return_numpy else handles

        inflight = collections.deque()
        for feed in pl.DeviceFeedPipeline(feeds, depth=max_in_flight,
                                          place=self._exe.device):
            inflight.append(self.run_async(feed))
            if len(inflight) >= max_in_flight:
                yield finish(inflight.popleft())
        while inflight:
            yield finish(inflight.popleft())


def create_paddle_predictor(config):
    return AnalysisPredictor(config)
