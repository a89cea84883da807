"""The port's verifier battery against the reference's.

The same program-building code runs in ``paddle_tpu`` and
``paddle_tpu_torch`` (each with its unique-name counter reset), and the
two packages' ``static_analysis`` must agree exactly:

* every registered check (the reference's 24, then the 4 concurrency
  checks), in the same order, each on a fixture built the same way in
  both packages: the diagnostics are equal field by field (check,
  severity, message, block/op coordinates, op type, op id, var names,
  hint);
* the battery on the five main paths' programs at test size — bert-tiny
  pretraining (float32 and bf16 AMP, whose 12 ERROR ``shape-dtype-drift``
  findings both packages report), the bert-tiny serving program, a
  narrow GPT decode engine's ring and paged step and prefill programs,
  ResNet-18 NHWC at 64x64 and two ``GradAllReduce`` workers of bert-tiny;
* ``interpret_program`` and ``estimate_cost`` on those programs (per-op
  shapes, dtypes, shardings, FLOPs and bytes exactly; priced times to
  1e-9 relative under the same explicit hardware numbers), the workers'
  collective schedules and deadlock proofs, and the overlap and
  hierarchy passes' output programs, op by op.

It also holds the entry points: ``Executor.run(verify=True)``,
``Analyzer.run`` resolving verification from ``PADDLE_TPU_VERIFY_PASSES``,
the fusion bracket (on in the tests, ``conftest.py``), ``Program.lint`` /
``Program.analyze`` and ``tools.lint_program``'s exit codes.  Nothing
here runs a step, so the reference needs no Pallas kernel.
"""

import copy
import json
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import analysis as janalysis
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.serving import DecodeEngine as JDecodeEngine
from paddle_tpu.serving import GenerationConfig as JGenerationConfig
from paddle_tpu.static_analysis import checks as jchecks
from paddle_tpu.static_analysis import cost as jcost
from paddle_tpu.static_analysis import distributed as jdist
from paddle_tpu.static_analysis import fusion as jfusion
from paddle_tpu.static_analysis import hierarchy as jhier
from paddle_tpu.static_analysis import interp as jinterp
from paddle_tpu.static_analysis import overlap as joverlap
from paddle_tpu.static_analysis import verifier as jverifier
from paddle_tpu.transpiler.collective import GradAllReduce as JGradAllReduce

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import analysis as tanalysis
from paddle_tpu_torch import proto as tproto
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.serving import DecodeEngine as TDecodeEngine
from paddle_tpu_torch.serving import GenerationConfig as TGenerationConfig
from paddle_tpu_torch.static_analysis import checks as tchecks
from paddle_tpu_torch.static_analysis import cost as tcost
from paddle_tpu_torch.static_analysis import distributed as tdist
from paddle_tpu_torch.static_analysis import fusion as tfusion
from paddle_tpu_torch.static_analysis import hierarchy as thier
from paddle_tpu_torch.static_analysis import interp as tinterp
from paddle_tpu_torch.static_analysis import overlap as toverlap
from paddle_tpu_torch.static_analysis import verifier as tverifier
from paddle_tpu_torch.tools import lint_program as tlint
from paddle_tpu_torch.transpiler import GradAllReduce as TGradAllReduce

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import gpt_small  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

J = types.SimpleNamespace(
    fluid=jfluid, bert=jbert, resnet=jresnet, GradAllReduce=JGradAllReduce,
    DecodeEngine=JDecodeEngine, GenerationConfig=JGenerationConfig,
    Adapter=gpt_small.DecodeAdapter, gpt=gpt_small, verifier=jverifier,
    interp=jinterp, cost=jcost, dist=jdist, fusion=jfusion,
    overlap=joverlap, hier=jhier, analysis=janalysis, checks=jchecks)
T = types.SimpleNamespace(
    fluid=tfluid, bert=tbert, resnet=tresnet, GradAllReduce=TGradAllReduce,
    DecodeEngine=TDecodeEngine, GenerationConfig=TGenerationConfig,
    Adapter=tgpt.DecodeAdapter, gpt=tgpt, verifier=tverifier,
    interp=tinterp, cost=tcost, dist=tdist, fusion=tfusion,
    overlap=toverlap, hier=thier, analysis=tanalysis, checks=tchecks)

# the hardware numbers both packages price with in the parity tests, so
# neither package's defaults (a TPU chip, an H100) decide a comparison
HW = {"peak_tflops": 100.0, "hbm_gbps": 1200.0, "ici_gbps": 100.0,
      "launch_us": 5.0}
SPEC = dict(HW, chips=2, hbm_gb=16.0)
PRICE_RTOL = 1e-9


def _dicts(diags):
    return [d.to_dict() for d in diags]


# The reference's texts that name its own backend, tools or passes the
# port does not run, each with the port's text in its place; every other
# word of a diagnostic is the reference's.
PORT_TEXTS = [
    (r"\(paddle_tpu\.autotune\.sweep\)", "(paddle_tpu_torch.autotune.sweep)"),
    (r"the Pallas row-DMA gather is ineligible and XLA's take is already "
     r"optimal for this shape",
     "the gate keeps the plain gather (K3, csrc/embedding.cu, is fused "
     "only for 128-aligned rows)"),
    (r" \(XLA's unblocked attention is faster there, r05 sweep; "
     r"PADDLE_TPU_FLASH_MIN_T re-decides\)",
     " (PADDLE_TPU_FLASH_MIN_T re-decides)"),
    (r"unset PADDLE_TPU_QUANT to let the planner price int8 exchange for "
     r"this bucket",
     "unset PADDLE_TPU_QUANT and set PADDLE_TPU_QUANT_MIN_BYTES to "
     "exchange this bucket in int8 (the planner that prices it is not "
     "ported: ROADMAP.md, Queue A item 9)"),
    (r"run parallel\.auto_transpile \(the quant axis prices it\) or set "
     r"PADDLE_TPU_QUANT_MIN_BYTES",
     "set PADDLE_TPU_QUANT_MIN_BYTES (the planner that prices the quant "
     "axis is not ported: ROADMAP.md, Queue A item 9)"),
    (r"so analyze --plan can price", "so this check can price"),
    (r"re-run parallel\.auto_transpile if the topology or model changed "
     r"since the plan was stamped",
     "re-plan if the topology or model changed since the plan was "
     "stamped (the planner is not ported: ROADMAP.md, Queue A item 9)"),
    (r"unset PADDLE_TPU_HIERARCHY to let resolve_fused_program decompose "
     r"the exchange",
     "static_analysis.hierarchy.apply_hierarchy_pass decomposes the "
     "exchange; the port's fusion resolve does not run it yet "
     "(ROADMAP.md, Queue A item 7)"),
    (r"unset PADDLE_TPU_OVERLAP to let the pass hide the wire under "
     r"(\d+) ops of compute",
     "static_analysis.overlap.apply_overlap_pass hides the wire under "
     "\\1 ops of compute; the port's fusion resolve does not run it yet "
     "(ROADMAP.md, Queue A item 7), so unsetting PADDLE_TPU_OVERLAP "
     "alone changes nothing"),
    (r"derives <type>_grad via jax\.vjp\)", "derives <type>_grad via "
     "autograd)"),
    (r"\(per-token recompile \+ host sync on TPU\)",
     "(an eager warm-up and a new graph capture per token)"),
]
# words of the reference's backend and tools that no port text may carry
_REFERENCE_WORDS = re.compile(
    r"paddle_tpu\.|XLA|Pallas|\bTPU\b|jax|auto_transpile|analyze --plan")


def _as_port(dicts):
    """The reference's diagnostics as dicts, with PORT_TEXTS applied to
    their message and hint."""
    for d in dicts:
        for field in ("message", "hint"):
            for pattern, port in PORT_TEXTS:
                if d.get(field):
                    d[field] = re.sub(pattern, port, d[field])
    return dicts


def _assert_port_texts(dicts):
    for d in dicts:
        for field in ("message", "hint"):
            assert not _REFERENCE_WORDS.search(d.get(field) or ""), d


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_registry_is_the_reference_s_in_its_order():
    assert list(tchecks.all_checks()) == list(jchecks.all_checks())
    assert len(tchecks.all_checks()) == 28


# ---------------------------------------------------------------------------
# one fixture per check, built the same way in both packages
# ---------------------------------------------------------------------------


def _raw(block, type, ins=None, outs=None, attrs=None, fl=None):
    """Append an op without shape inference (types the port does not
    register, or metadata a rewrite would leave)."""
    op = fl.framework.Operator(block, type, ins or {}, outs or {},
                               attrs or {})
    block.ops.append(op)
    block.program._bump_version()
    return op


def _fresh(fl):
    fl.unique_name.switch()
    main = fl.Program()
    return main, main.global_block()


def _fill(fl, block, name):
    return _raw(block, "fill_constant", {}, {"Out": [name]},
                {"shape": [2], "dtype": "float32", "value": 1.0}, fl=fl)


def fx_use_before_def(fl):
    main, b = _fresh(fl)
    b.create_var(name="x", shape=[4, 8], dtype="float32")
    b.create_var(name="y", shape=[4, 8], dtype="float32")
    _raw(b, "scale", {"X": ["x"]}, {"Out": ["y"]}, {"scale": 2.0}, fl=fl)
    _raw(b, "scale", {"X": ["ghost"]}, {"Out": ["y"]}, {}, fl=fl)
    return dict(program=main, targets=["y"])


def fx_double_write(fl):
    main, b = _fresh(fl)
    b.create_var(name="t", shape=[2], dtype="float32")
    b.create_var(name="p", shape=[2], dtype="float32", persistable=True)
    for n in ("t", "t", "p", "p"):
        _fill(fl, b, n)
    return dict(program=main, targets=["t"])


def fx_shape_dtype_drift(fl):
    """Two ops whose output metadata a rewrite changed without
    re-inferring: a dtype (ERROR) and a static shape (WARNING)."""
    main, b = _fresh(fl)
    b.create_var(name="x", shape=[4, 8], dtype="float32", is_data=True)
    for n, s in (("y", 2.0), ("z", 3.0)):
        b.create_var(name=n, dtype="float32")
        b.append_op(type="scale", inputs={"X": ["x"]}, outputs={"Out": [n]},
                    attrs={"scale": s})
    b.var("y").dtype = "bfloat16"
    b.var("z").shape = (4, 9)
    return dict(program=main, targets=["y", "z"])


def fx_orphaned_fetch(fl):
    main, b = _fresh(fl)
    b.create_var(name="never", shape=[2], dtype="float32")
    b.create_var(name="t", shape=[2], dtype="float32")
    _fill(fl, b, "t")
    return dict(program=main, targets=["t", "never", "missing"])


def fx_sub_block_index(fl):
    main, b = _fresh(fl)
    b.create_var(name="t", shape=[2], dtype="float32")
    _raw(b, "scale", {"X": ["t"]}, {"Out": ["t"]}, {"sub_block": 7}, fl=fl)
    _raw(b, "scale", {"X": ["t"]}, {"Out": ["t"]}, {"sub_block": 0}, fl=fl)
    return dict(program=main, targets=["t"])


def fx_collective_ring(fl):
    main, b = _fresh(fl)
    b.create_var(name="g", shape=[4], dtype="float32")
    _raw(b, "c_gen_nccl_id", {}, {}, {"ring_id": 0}, fl=fl)
    _raw(b, "c_allreduce_sum", {"X": ["g"]}, {"Out": ["g"]}, {}, fl=fl)
    _raw(b, "c_allreduce_sum", {"X": ["g"]}, {"Out": ["g"]},
         {"ring_id": 3}, fl=fl)
    _raw(b, "send_v2", {"X": ["g"]}, {}, {"ring_id": 0}, fl=fl)
    return dict(program=main, targets=["g"])


def fx_unreferenced_op(fl):
    main, b = _fresh(fl)
    b.create_var(name="x", shape=[2], dtype="float32", is_data=True)
    for n in ("dead", "live"):
        b.create_var(name=n, shape=[2], dtype="float32")
        _raw(b, "scale", {"X": ["x"]}, {"Out": [n]}, {}, fl=fl)
    return dict(program=main, targets=["live"])


def _train_program(fl, startup=None):
    """SGD updates its parameters in place; the program fetches one of
    them and overwrites a fed var."""
    fl.unique_name.switch()
    main = fl.Program()
    startup = startup if startup is not None else fl.Program()
    with fl.program_guard(main, startup):
        x = fl.layers.data("x", shape=[4], dtype="float32")
        y = fl.layers.fc(x, size=3, param_attr=fl.ParamAttr(name="w"))
        loss = fl.layers.reduce_sum(y)
        fl.optimizer.SGD(0.1).minimize(loss)
        fl.layers.assign(fl.layers.relu(x), output=x)
    return main, [loss.name, "w"]


def fx_resilience_finite_guard(fl):
    main, targets = _train_program(fl)
    return dict(program=main, targets=targets)


def fx_executor_host_sync_in_loop(fl):
    main, targets = _train_program(fl)
    _raw(main.global_block(), "save", {"X": ["w"]}, {},
         {"file_path": "never_written"}, fl=fl)
    return dict(program=main, targets=targets)


def fx_peak_memory_over_budget(fl):
    main, b = _fresh(fl)
    b.create_var(name="big", shape=[256, 256], dtype="float32",
                 persistable=True)
    b.create_var(name="h", shape=[256, 256], dtype="float32")
    _raw(b, "scale", {"X": ["big"]}, {"Out": ["h"]}, {}, fl=fl)
    main._hbm_budget = "64K"
    return dict(program=main, targets=["h"])


def _worker(fl, width):
    main, b = _fresh(fl)
    b.create_var(name="g", shape=[4, width], dtype="float32")
    _raw(b, "c_allreduce_sum", {"X": ["g"]}, {"Out": ["g"]},
         {"ring_id": 0}, fl=fl)
    _raw(b, "c_allreduce_sum", {"X": ["g"]}, {"Out": ["g"]},
         {"ring_id": 0}, fl=fl)
    main._num_trainers = 2
    return main


def fx_collective_schedule_divergence(fl):
    workers = [_worker(fl, 4), _worker(fl, 8)]
    return dict(program=workers[0], targets=["g"], workers=workers)


def fx_degenerate_sharding(fl):
    main, b = _fresh(fl)
    for name, rows in (("thin", 2), ("ragged", 6)):
        v = b.create_var(name=name, shape=[rows, 8], dtype="float32",
                         persistable=True)
        v.shard_spec = {0: "model"}
        b.create_var(name=name + "_out", shape=[rows, 8], dtype="float32")
        _raw(b, "scale", {"X": [name]}, {"Out": [name + "_out"]}, {}, fl=fl)
    main._num_trainers = 4
    return dict(program=main, targets=["thin_out", "ragged_out"])


def fx_oversized_replicated_persistable(fl):
    main, b = _fresh(fl)
    b.create_var(name="table", shape=[64, 64], dtype="float32",
                 persistable=True)
    b.create_var(name="h", shape=[64, 64], dtype="float32")
    _raw(b, "scale", {"X": ["table"]}, {"Out": ["h"]}, {}, fl=fl)
    main._num_trainers = 2
    return dict(program=main, targets=["h"],
                env={"PADDLE_TPU_REPLICATED_BUDGET": "1K"})


def fx_fused_op_missing_grad(fl):
    main, b = _fresh(fl)
    b.create_parameter(name="w", shape=[2, 4, 8], dtype="float32")
    for n, shape in (("cache", [2, 4, 16, 8]), ("cur", [2]),
                     ("h", [2, 4, 8]), ("y", [2, 4, 8]),
                     ("y@GRAD", [2, 4, 8]), ("h@GRAD", [2, 4, 8])):
        b.create_var(name=n, shape=shape,
                     dtype="int32" if n == "cur" else "float32")
    _raw(b, "flash_decode_attention",
         {"Q": ["w"], "KCache": ["cache"], "VCache": ["cache"],
          "Cursor": ["cur"]}, {"Out": ["h"]}, {}, fl=fl)
    fwd = _raw(b, "scale", {"X": ["h"]}, {"Out": ["y"]}, {}, fl=fl)
    _raw(b, "scale_grad", {"Out@GRAD": ["y@GRAD"]}, {"X@GRAD": ["h@GRAD"]},
         {"__fwd_op_id__": fwd.attrs["__op_id__"], "op_role": "backward"},
         fl=fl)
    return dict(program=main, targets=["y"])


def fx_fusible_pattern_not_fused(fl):
    fl.unique_name.switch()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        ids = fl.layers.data("ids", shape=[8, 1], dtype="int64")
        emb = fl.layers.embedding(ids, size=[100, 64])
        out = fl.layers.fc(emb, size=16, num_flatten_dims=2, act="relu")
    return dict(program=main, targets=[out.name])


def fx_fusible_pattern_not_fused_off(fl):
    spec = fx_fusible_pattern_not_fused(fl)
    spec["env"] = {"PADDLE_TPU_FUSION": "0"}
    return spec


def _grad_buckets(fl, nranks, spec=None):
    main, b = _fresh(fl)
    for i in range(3):
        b.create_var(name="g%d" % i, shape=[1024, 1024], dtype="float32")
        _raw(b, "c_allreduce_sum", {"X": ["g%d" % i]}, {"Out": ["g%d" % i]},
             {"ring_id": 0, "pre_scale": 1.0 / nranks}, fl=fl)
    main._num_trainers = nranks
    if spec is not None:
        main._cluster_spec = spec
    return main


def fx_quantizable_bucket_not_quantized(fl):
    return dict(program=_grad_buckets(fl, 2, json.dumps(SPEC)),
                targets=["g0"], checks=["quantizable-bucket-not-quantized"])


def fx_collective_crosses_slow_tier(fl):
    # alone: without a spec the quant advisory prices at each package's
    # default chip
    return dict(program=_grad_buckets(fl, 4), targets=["g0"],
                checks=["collective-crosses-slow-tier"])


def _pairs(fl):
    main, b = _fresh(fl)
    b.create_var(name="g", shape=[4], dtype="float32")
    for t, bucket in (("c_allreduce_start", 0), ("c_allreduce_wait", 1),
                      ("c_allreduce_start", 2), ("c_allreduce_wait", 2),
                      ("c_allreduce_wait", 2)):
        _raw(b, t, {"X": ["g"]}, {"Out": ["g"]},
             {"ring_id": 0, "overlap_bucket": bucket}, fl=fl)
    return dict(program=main, targets=["g"])


def _overlap_program(fl):
    """Two gradients, their fused bucket right after the last of them,
    three ops of other work, then the updates."""
    main, b = _fresh(fl)
    for n in ("x", "g0", "g1", "a", "c", "d", "p0", "p1", "lr"):
        b.create_var(name=n, shape=[1] if n == "lr" else [4],
                     dtype="float32",
                     persistable=n.startswith("p") or n == "lr",
                     is_data=n == "x")
    _raw(b, "scale", {"X": ["x"]}, {"Out": ["g0"]}, {}, fl=fl)
    _raw(b, "scale", {"X": ["x"]}, {"Out": ["g1"]}, {}, fl=fl)
    _raw(b, "c_fused_allreduce_sum", {"X": ["g0", "g1"]},
         {"Out": ["g0", "g1"]}, {"ring_id": 0, "op_role": "backward"},
         fl=fl)
    for src, dst in (("x", "a"), ("a", "c"), ("c", "d")):
        _raw(b, "scale", {"X": [src]}, {"Out": [dst]}, {}, fl=fl)
    for p, g in (("p0", "g0"), ("p1", "g1")):
        _raw(b, "sgd", {"Param": [p], "Grad": [g], "LearningRate": ["lr"]},
             {"ParamOut": [p]}, {"op_role": "optimize"}, fl=fl)
    main._num_trainers = 2
    return main


def fx_overlap_opportunity_unexploited(fl):
    return dict(program=_overlap_program(fl), targets=["d"],
                env={"PADDLE_TPU_OVERLAP": "0"})


def fx_manual_plan_suboptimal(fl):
    return dict(program=_grad_buckets(fl, 2), targets=["g0"],
                checks=["manual-plan-suboptimal"])


def fx_decode_shape_unbucketed(fl):
    main, b = _fresh(fl)
    for n in ("k", "k_step", "cond"):
        b.create_var(name=n, shape=[1, 2, 4, 8], dtype="float32")
    sub = main._create_block()
    sub.create_var(name="k_new", shape=[1, 2, 5, 8], dtype="float32")
    _raw(sub, "concat", {"X": ["k", "k_step"]}, {"Out": ["k_new"]},
         {"axis": 2}, fl=fl)
    _raw(sub, "assign", {"X": ["k_new"]}, {"Out": ["k"]}, {}, fl=fl)
    _raw(sub, "concat", {"X": ["k", "k_step"]}, {"Out": ["k"]},
         {"axis": 2}, fl=fl)
    main._rollback()
    _raw(b, "while", {"X": ["k", "k_step"], "Condition": ["cond"]},
         {"Out": ["k"]}, {"sub_block": sub.idx}, fl=fl)
    # alone: the port registers no concat op to re-infer
    return dict(program=main, targets=["k"],
                checks=["decode-shape-unbucketed"])


def fx_decode_cache_unpaged(fl):
    fl.unique_name.switch()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        cache = main.global_block().create_var(
            name="kcache", shape=[8, 12, 1024, 64], dtype="float32",
            persistable=True)
        x = fl.layers.data("x", shape=[8, 12, 1, 64], dtype="float32",
                           append_batch_size=False)
        cur = fl.layers.data("cur", shape=[8], dtype="int32",
                             append_batch_size=False)
        fl.layers.kv_cache_write(cache, x, cur, per_row=True)
    return dict(program=main, targets=[cache.name])


def fx_race_inflight_write(fl):
    main, targets = _train_program(fl)
    return dict(program=main, targets=targets, max_in_flight=2)


def fx_donated_buffer_live_read(fl):
    spec = fx_race_inflight_write(fl)
    spec["checks"] = ["donated-buffer-live-read"]
    return spec


def _counter(fl):
    main, b = _fresh(fl)
    b.create_var(name="requests_seen", shape=[1], dtype="float32",
                 persistable=True)
    _raw(b, "increment", {"X": ["requests_seen"]},
         {"Out": ["requests_seen"]}, {"step": 1.0}, fl=fl)
    return main


def fx_scope_overlap(fl):
    return dict(program=_counter(fl), targets=["requests_seen"],
                coresident=[("other", _counter(fl))])


def fx_sync_in_hot_loop(fl):
    spec = fx_executor_host_sync_in_loop(fl)
    spec["certify_zero_sync"] = True
    return spec


FIXTURES = {
    "use-before-def": fx_use_before_def,
    "double-write": fx_double_write,
    "shape-dtype-drift": fx_shape_dtype_drift,
    "orphaned-fetch": fx_orphaned_fetch,
    "sub-block-index": fx_sub_block_index,
    "collective-ring": fx_collective_ring,
    "unreferenced-op": fx_unreferenced_op,
    "resilience-finite-guard": fx_resilience_finite_guard,
    "executor-host-sync-in-loop": fx_executor_host_sync_in_loop,
    "peak-memory-over-budget": fx_peak_memory_over_budget,
    "collective-schedule-divergence": fx_collective_schedule_divergence,
    "degenerate-sharding": fx_degenerate_sharding,
    "oversized-replicated-persistable": fx_oversized_replicated_persistable,
    "fused-op-missing-grad": fx_fused_op_missing_grad,
    "fusible-pattern-not-fused": fx_fusible_pattern_not_fused,
    "quantizable-bucket-not-quantized": fx_quantizable_bucket_not_quantized,
    "collective-crosses-slow-tier": fx_collective_crosses_slow_tier,
    "collective-start-without-wait": _pairs,
    "wait-without-start": _pairs,
    "double-wait": _pairs,
    "overlap-opportunity-unexploited": fx_overlap_opportunity_unexploited,
    "manual-plan-suboptimal": fx_manual_plan_suboptimal,
    "decode-shape-unbucketed": fx_decode_shape_unbucketed,
    "decode-cache-unpaged": fx_decode_cache_unpaged,
    "race-inflight-write": fx_race_inflight_write,
    "donated-buffer-live-read": fx_donated_buffer_live_read,
    "scope-overlap": fx_scope_overlap,
    "sync-in-hot-loop": fx_sync_in_hot_loop,
}
def fx_fusible_pattern_below_the_gate(fl):
    fl.unique_name.switch()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        ids = fl.layers.data("ids", shape=[8, 1], dtype="int64")
        out = fl.layers.embedding(ids, size=[100, 128])
    return dict(program=main, targets=[out.name],
                env={"PADDLE_TPU_EMBED_FUSE_MIN_BYTES": str(1 << 30)})


def fx_quant_disabled(fl):
    spec = fx_quantizable_bucket_not_quantized(fl)
    spec["env"] = {"PADDLE_TPU_QUANT": "0"}
    return spec


def _two_slices(fl, mark=None):
    main = _grad_buckets(fl, 4, json.dumps(dict(SPEC, chips=4, slices=2)))
    if mark is not None:
        main._hierarchy = mark
    return dict(program=main, targets=["g0"],
                checks=["collective-crosses-slow-tier"])


def fx_hierarchy_disabled(fl):
    return dict(_two_slices(fl), env={"PADDLE_TPU_HIERARCHY": "0"})


def fx_hierarchy_pinned_flat(fl):
    return _two_slices(fl, mark=False)


# further fixtures where a check has another reason or hint
EXTRA = {"fusible-pattern-not-fused (PADDLE_TPU_FUSION=0)":
         ("fusible-pattern-not-fused", fx_fusible_pattern_not_fused_off),
         "fusible-pattern-not-fused (below the gate)":
         ("fusible-pattern-not-fused", fx_fusible_pattern_below_the_gate),
         "quantizable-bucket-not-quantized (PADDLE_TPU_QUANT=0)":
         ("quantizable-bucket-not-quantized", fx_quant_disabled),
         "collective-crosses-slow-tier (PADDLE_TPU_HIERARCHY=0)":
         ("collective-crosses-slow-tier", fx_hierarchy_disabled),
         "collective-crosses-slow-tier (flat plan mark)":
         ("collective-crosses-slow-tier", fx_hierarchy_pinned_flat)}


def _run_fixture(P, build, monkeypatch):
    spec = build(P.fluid)
    with monkeypatch.context() as m:
        for k, v in spec.get("env", {}).items():
            m.setenv(k, v)
        return P.verifier.verify_program(
            spec["program"], targets=spec["targets"],
            checks=spec.get("checks"), workers=spec.get("workers"),
            max_in_flight=spec.get("max_in_flight"),
            coresident=spec.get("coresident"),
            certify_zero_sync=spec.get("certify_zero_sync", False))


def test_every_check_has_a_fixture():
    assert sorted(FIXTURES) == sorted(tchecks.all_checks())


@pytest.mark.parametrize("case", sorted(FIXTURES) + sorted(EXTRA))
def test_check_fixture_gives_the_reference_diagnostics(case, monkeypatch):
    check, build = EXTRA.get(case, (case, FIXTURES.get(case)))
    want = _as_port(_dicts(_run_fixture(J, build, monkeypatch)))
    got = _dicts(_run_fixture(T, build, monkeypatch))
    assert got == want
    _assert_port_texts(got)
    if check == "manual-plan-suboptimal":
        assert not [d for d in got if d["check"] == check]
    else:
        assert [d for d in got if d["check"] == check], check


def test_lowering_that_rejects_its_inputs_is_an_error_in_both():
    """A rewrite that wires an op to incompatible inputs: both packages
    report it at the same op; the message carries each framework's own
    exception text after the reference's prefix."""
    found = []
    for P in (J, T):
        main, b = _fresh(P.fluid)
        for n, shape in (("a", [4, 8]), ("c", [3, 5]), ("o", [4, 5])):
            b.create_var(name=n, shape=shape, dtype="float32",
                         is_data=n != "o")
        _raw(b, "matmul", {"X": ["a"], "Y": ["c"]}, {"Out": ["o"]}, {},
             fl=P.fluid)
        [d] = P.verifier.verify_program(main, targets=["o"],
                                        checks=["shape-dtype-drift"])
        found.append(d.to_dict())
    for d in found:
        assert d["severity"] == "ERROR"
        assert d["message"].startswith(
            "the op's lowering rejects the recorded input metadata (")
        msg = d.pop("message")
        assert msg
    assert found[1] == found[0]


def test_manual_plan_check_raises_with_a_cluster_spec():
    """Silent without a cluster spec, as in the reference; with one, the
    port cannot run the planner's search and says so."""
    prog = _grad_buckets(tfluid, 2)
    assert tverifier.verify_program(
        prog, checks=["manual-plan-suboptimal"]) == []
    prog._cluster_spec = json.dumps(SPEC)
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        tverifier.verify_program(prog, checks=["manual-plan-suboptimal"])
    prog._cluster_spec = "{not json"
    [d] = tverifier.verify_program(prog, checks=["manual-plan-suboptimal"])
    assert d.message.startswith("cluster spec '{not json' is unusable")


# ---------------------------------------------------------------------------
# the five main paths at test size
# ---------------------------------------------------------------------------


def _bert_train(P, amp):
    P.fluid.unique_name.switch()
    main, _startup, _feeds, loss = P.bert.build_pretrain(
        P.bert.BERT_TINY, seq_len=64, amp=amp)
    return [(main, [loss.name])]


def _bert_serving(P):
    T_ = 64
    cfg = copy.copy(P.bert.BERT_TINY)
    cfg.fuse_attn = "auto"
    P.fluid.unique_name.switch()
    main, startup = P.fluid.Program(), P.fluid.Program()
    with P.fluid.program_guard(main, startup):
        ids = P.fluid.layers.data("input_ids", shape=[T_], dtype="int64")
        tt = P.fluid.layers.data("token_type_ids", shape=[T_],
                                 dtype="int64")
        mask = P.fluid.layers.data("attn_mask_bias", shape=[1, 1, T_],
                                   dtype="float32")
        hidden = P.bert.encoder(ids, tt, mask, cfg, T_)
    return [(main.clone(for_test=True), [hidden.name])]


def _resnet(P):
    f = P.fluid
    main, startup = f.Program(), f.Program()
    with f.unique_name.guard(), f.program_guard(main, startup):
        img = f.layers.data("img", shape=[64, 64, 3], dtype="float32")
        label = f.layers.data("label", shape=[1], dtype="int64")
        logits = P.resnet.resnet_imagenet(img, 1000, 18, False, "NHWC",
                                          "conv7")
        loss = f.layers.mean(
            f.layers.softmax_with_cross_entropy(logits, label))
        f.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                             use_nesterov=True).minimize(loss)
    return [(main, [loss.name])]


def _dp_workers(P, nranks=2):
    out = []
    for rank in range(nranks):
        cfg = copy.copy(P.bert.BERT_TINY)
        cfg.dropout = cfg.attn_dropout = 0.0
        with P.fluid.unique_name.guard():
            main, startup, _f, loss = P.bert.build_pretrain(
                cfg, seq_len=32, lr=1e-3)
        P.GradAllReduce().transpile(program=main, startup_program=startup,
                                    rank=rank, nranks=nranks)
        main._num_trainers = nranks
        main._allreduce_bucket_mb = 0.25
        out.append((main, [loss.name]))
    return out


def _decode(P, paged):
    cfg = P.gpt.GPTConfig(vocab=128, hidden=64, layers=2, heads=4,
                          max_len=64)
    eng = P.DecodeEngine(
        P.Adapter(cfg, seed=3), slots=2, prompt_buckets=(8, 16),
        config=P.GenerationConfig(max_new_tokens=6),
        place=P.fluid.CPUPlace(), name="gen", auto_start=False,
        paged=paged, block_len=16)
    progs = [(eng._step_prog, [eng._step_fetch])] + [
        (m, [f]) for _, (m, f) in sorted(eng._prefill.items())]
    eng.close()
    return progs


def _decode_loop(P):
    """The one-program generation: the prefill, then a ``while`` whose
    body is a decode step (``build_program``, with an eos)."""
    cfg = P.gpt.GPTConfig(vocab=128, hidden=64, layers=2, heads=4,
                          max_len=64)
    with P.fluid.unique_name.guard():
        main, _s, _f, tokens, gen_len = P.gpt.build_program(
            cfg, 2, 8, 4, eos_id=5)
    return [(main, [tokens.name, gen_len.name])]


def _while_grad(P):
    """A bounded ``while`` over an fc, then a ``cond``, trained with SGD:
    the structural checks walk both sub-blocks and their grad ops."""
    f = P.fluid
    main, startup = f.Program(), f.Program()
    with f.unique_name.guard(), f.program_guard(main, startup):
        x = f.layers.data("x", shape=[2, 4], dtype="float32",
                          append_batch_size=False)
        y = f.layers.assign(x)
        i = f.layers.fill_constant([1], "int32", 0)
        limit = f.layers.fill_constant([1], "int32", 3)
        cond = f.layers.less_than(i, limit)
        loop = f.layers.While(cond, max_trip_count=4)
        with loop.block():
            f.layers.assign(f.layers.fc(y, size=4, act="tanh"), output=y)
            f.layers.increment(i, value=1, in_place=True)
            f.layers.less_than(i, limit, cond=cond)
        z = f.layers.cond(f.layers.reduce_any(cond),
                          lambda: f.layers.scale(y, 2.0),
                          lambda: f.layers.scale(y, 0.5))
        loss = f.layers.mean(z)
        f.optimizer.SGD(0.1).minimize(loss)
    return [(main, [loss.name])]


PATHS = {
    "decode_loop": _decode_loop,
    "while_grad": _while_grad,
    "bert_train": lambda P: _bert_train(P, False),
    "bert_train_amp": lambda P: _bert_train(P, True),
    "bert_serving": _bert_serving,
    "resnet18_nhwc": _resnet,
    "dp_workers": _dp_workers,
    "decode_ring": lambda P: _decode(P, False),
    "decode_paged": lambda P: _decode(P, True),
}


@pytest.fixture(scope="module")
def paths():
    """Every path's programs, built once per package."""
    return {name: (build(J), build(T)) for name, build in PATHS.items()}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_main_path_programs_give_the_reference_diagnostics(paths, path):
    jprogs, tprogs = paths[path]
    jworkers = [p for p, _ in jprogs] if path == "dp_workers" else None
    tworkers = [p for p, _ in tprogs] if path == "dp_workers" else None
    for (jp, jt), (tp, tt) in zip(jprogs, tprogs):
        want = _as_port(_dicts(jverifier.verify_program(
            jp, targets=jt, workers=jworkers)))
        got = _dicts(tverifier.verify_program(tp, targets=tt,
                                              workers=tworkers))
        assert got == want
        _assert_port_texts(got)
        assert not [d for d in got if d["severity"] == "ERROR"] \
            or path == "bert_train_amp"


def test_amp_program_drift_is_the_reference_s(paths):
    """The bf16 rewrite retypes vars the lowerings still produce in
    float32 (and one the other way): 12 ERROR ``shape-dtype-drift`` in
    both packages, so ``Executor.run(verify=True)`` raises in both
    before any step runs, naming the check."""
    (jp, jt), = paths["bert_train_amp"][0]
    (tp, tt), = paths["bert_train_amp"][1]
    errors = []
    for P, prog, targets in ((J, jp, jt), (T, tp, tt)):
        errs = [d.to_dict() for d in P.verifier.verify_program(
            prog, targets=targets) if d.severity >= 3]
        errors.append(errs)
        exe = P.fluid.Executor(P.fluid.CPUPlace())
        with pytest.raises(P.verifier.VerifyError,
                           match="shape-dtype-drift"):
            exe.run(prog, feed={}, fetch_list=targets, verify=True)
    assert errors[1] == errors[0]
    assert len(errors[1]) == 12
    assert {e["check"] for e in errors[1]} == {"shape-dtype-drift"}


def _records(result):
    return [(r.block_idx, r.op_idx, r.op.type,
             [(v.name, v.shape, v.dtype, v.persistable, repr(v.sharding))
              for v in r.ins],
             [(v.name, v.shape, v.dtype, v.persistable, repr(v.sharding))
              for v in r.outs]) for r in result.records]


def _as_jax_records(tprog, jprog):
    """The port's program as the reference records it: the reference's
    JAX runs with 64-bit types off, so an op whose lowering makes int64
    values records int32 there (BERT's MLM position arithmetic:
    ``fill_constant_batch_size_like``, ``cumsum`` and the adds after
    them); the port computes int64.  A clone of the port's program with
    those inferred vars retyped int32, and their names."""
    clone = tprog.clone()
    for attr in ("_num_trainers", "_allreduce_bucket_mb"):
        if hasattr(tprog, attr):
            setattr(clone, attr, getattr(tprog, attr))
    jvars = jprog.global_block().vars
    retyped = []
    for name, v in clone.global_block().vars.items():
        jv = jvars.get(name)
        if jv is not None and str(v.dtype) == "int64" \
                and str(jv.dtype) == "int32" \
                and not (v.persistable or v.is_data):
            v.dtype = "int32"
            retyped.append(name)
    return clone, retyped


@pytest.mark.parametrize("path", ["bert_train", "bert_train_amp",
                                  "decode_ring", "decode_paged",
                                  "resnet18_nhwc", "dp_workers"])
def test_interp_and_cost_match_the_reference(paths, path):
    jprogs, tprogs = paths[path]
    for (jp, jt), (tp, tt) in zip(jprogs, tprogs):
        tp, retyped = _as_jax_records(tp, jp)
        assert len(retyped) <= (8 if path.startswith(("bert", "dp")) else 0)
        ji = jinterp.interpret_program(jp)
        ti = tinterp.interpret_program(tp)
        assert _records(ti) == _records(ji)
        jc = jcost.estimate_cost(jp, interp=ji, targets=jt)
        tc = tcost.estimate_cost(tp, interp=ti, targets=tt)
        assert [c.to_dict() for c in tc.op_costs] == \
            [c.to_dict() for c in jc.op_costs]
        assert tc.to_dict() == jc.to_dict()
        jprice = jcost.price_plan(jc, calibration=1.0, **HW).to_dict()
        tprice = tcost.price_plan(tc, calibration=1.0, **HW).to_dict()
        assert sorted(tprice) == sorted(jprice)
        for k, v in jprice.items():
            if isinstance(v, float):
                assert tprice[k] == pytest.approx(v, rel=PRICE_RTOL), k
            else:
                assert tprice[k] == v, k


def test_worker_schedules_and_deadlock_proof(paths):
    jprogs, tprogs = paths["dp_workers"]
    js = [jdist.extract_collective_schedule(p, worker=w)
          for w, (p, _) in enumerate(jprogs)]
    ts = [tdist.extract_collective_schedule(p, worker=w)
          for w, (p, _) in enumerate(tprogs)]
    flat = lambda s: {str(r): [e.to_dict() for e in evs]  # noqa: E731
                      for r, evs in s.items()}
    assert [flat(s) for s in ts] == [flat(s) for s in js]
    assert sum(len(evs) for evs in ts[0].values()) > 10
    jproof, jdiags = jdist.prove_deadlock_free([p for p, _ in jprogs])
    tproof, tdiags = tdist.prove_deadlock_free([p for p, _ in tprogs])
    assert [flat(s) for s in tproof] == [flat(s) for s in jproof]
    assert _dicts(tdiags) == _dicts(jdiags) == []
    # a reordered worker diverges in both
    for P, progs in ((J, jprogs), (T, tprogs)):
        bad = progs[1][0].clone()
        ops = bad.global_block().ops
        idx = [i for i, op in enumerate(ops) if op.type == "c_allreduce_sum"]
        ops[idx[0]], ops[idx[-1]] = ops[idx[-1]], ops[idx[0]]
        _, diags = P.dist.prove_deadlock_free([progs[0][0], bad])
        assert diags and diags[0].check == "collective-schedule-divergence"


def _ops(program):
    """Ops without their ids: the fused ops' ids follow the order in
    which each package's matchers build candidates."""
    return [(op.type, op.inputs, op.outputs,
             {k: v for k, v in op.attrs.items()
              if k not in ("op_namescope", "__op_id__", "__fwd_op_id__")})
            for op in program.global_block().ops]


def _fused_worker(P, progs):
    main, targets = progs[0]
    clone = main.clone()
    for mark in ("_num_trainers", "_allreduce_bucket_mb"):
        setattr(clone, mark, getattr(main, mark))
    P.fusion.apply_fusion_passes(clone, targets=targets, verify=False)
    return clone, targets


def test_overlap_and_hierarchy_passes_rewrite_like_the_reference(paths):
    jprogs, tprogs = paths["dp_workers"]
    out = []
    for P, progs in ((J, jprogs), (T, tprogs)):
        prog, targets = _fused_worker(P, progs)
        ov = P.overlap.apply_overlap_pass(prog, targets=targets)
        out.append((_ops(prog), [(d.bucket, d.status, d.window_ops)
                                 for d in ov.decisions]))
        prog, targets = _fused_worker(P, progs)
        prog._num_trainers = 4
        prog._cluster_spec = json.dumps(dict(SPEC, chips=4, slices=2))
        applied = P.hier.apply_hierarchy_pass(prog, targets=targets)
        out.append((_ops(prog), bool(applied)))
    assert out[2] == out[0]
    assert out[3] == out[1]
    assert any(t == "c_allreduce_start" for t, *_ in out[2][0])
    assert out[3][1] and any(t == "c_hier_reducescatter"
                             for t, *_ in out[3][0])


def test_port_dp_program_reports_its_unsplit_buckets(paths):
    """The reference's resolve splits the DP program's buckets into
    start/wait pairs; the port's does not run the overlap pass yet
    (ROADMAP.md, Queue A item 7), so its resolved program keeps them
    fused and the advisory says so."""
    found = []
    for P, progs in ((J, paths["dp_workers"][0]),
                     (T, paths["dp_workers"][1])):
        main, targets = progs[0]
        fused, _report = P.fusion.resolve_fused_program(main,
                                                        targets=targets)
        found.append([d.message for d in P.verifier.verify_program(
            fused, targets=targets,
            checks=["overlap-opportunity-unexploited"])])
        types_ = {op.type for op in fused.global_block().ops}
        assert ("c_allreduce_start" in types_) == (P is J)
    assert found[0] == []
    assert found[1] and all("runs synchronous" in m for m in found[1])


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _dangling(fl):
    main, b = _fresh(fl)
    b.create_var(name="x", shape=[2], dtype="float32", is_data=True)
    b.create_var(name="y", shape=[2], dtype="float32")
    _raw(b, "scale", {"X": ["ghost"]}, {"Out": ["y"]}, {}, fl=fl)
    return main


def test_entry_points_verify(monkeypatch):
    prog, targets = _train_program(tfluid)
    assert _dicts(prog.lint(targets=targets)) == _dicts(
        tverifier.verify_program(prog, targets=targets))
    report = prog.analyze(targets=targets, concurrency=True)
    assert report.cost.total_flops > 0 and report.concurrency is not None
    assert {d.check for d in report.diagnostics} >= {
        "race-inflight-write", "donated-buffer-live-read"}
    assert tfluid.verify_program is tverifier.verify_program
    with pytest.raises(tverifier.VerifyError, match="use-before-def"):
        tverifier.assert_valid(_dangling(tfluid))
    exe = tfluid.Executor(tfluid.CPUPlace())
    with pytest.raises(tverifier.VerifyError,
                       match="Executor.run\\(verify=True\\)"):
        exe.run(_dangling(tfluid), feed={"x": np.ones(2, "float32")},
                fetch_list=["y"], verify=True)


def test_verify_true_changes_nothing_the_step_computes():
    """The same program run with and without verification gives the
    same results bit for bit, and its cached step still replays."""
    runs = []
    for verify in (False, True):
        startup = tfluid.Program()
        prog, targets = _train_program(tfluid, startup)
        prog.random_seed = startup.random_seed = 1
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        got = [exe.run(prog, feed={"x": np.full((2, 4), i + 1.0, "float32")},
                       fetch_list=targets, scope=scope, verify=verify)
               for i in range(3)]
        runs.append((got, exe.last_run_mode))
    for a, b in zip(runs[0][0], runs[1][0]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert runs[1][1] == runs[0][1] == "graph"


def test_analyzer_resolves_verification_from_the_env(monkeypatch):
    for P in (J, T):
        monkeypatch.setenv("PADDLE_TPU_VERIFY_PASSES", "0")
        prog = _dangling(P.fluid)
        assert P.analysis.Analyzer().run(prog) is prog
        monkeypatch.setenv("PADDLE_TPU_VERIFY_PASSES", "1")
        with pytest.raises(P.verifier.VerifyError,
                           match="before analysis pipeline"):
            P.analysis.Analyzer().run(_dangling(P.fluid))
        monkeypatch.delenv("PADDLE_TPU_VERIFY_PASSES")
        assert P.analysis.Analyzer().run(_dangling(P.fluid))
        with pytest.raises(P.verifier.VerifyError):
            P.analysis.Analyzer().run(_dangling(P.fluid), verify=True)


def test_fusion_bracket_names_a_family_that_introduces_an_error(
        monkeypatch):
    """A family whose rewrite leaves a dangling read fails its bracket;
    the same program with the finding already there does not."""
    def bad_family(view, report, dry_run=False):
        for i, op in enumerate(view.block.ops):
            if op.type == "relu" and op.inputs["X"] != ["ghost_input"]:
                op.inputs["X"] = ["ghost_input"]
                view.refresh()
                return {"replacements": {}, "removals": set(),
                        "rewrite": tfusion.FusionRewrite("bad", "relu",
                                                         [i])}
        return None

    monkeypatch.setattr(tfusion, "_FAMILIES",
                        (("bad", "fuse_elewise", bad_family),))
    prog, targets = _train_program(tfluid)
    with pytest.raises(tverifier.VerifyError, match="after fuse_bad_pass"):
        tfusion.apply_fusion_passes(prog, targets=targets, verify=True)
    prog, targets = _train_program(tfluid)
    report = tfusion.apply_fusion_passes(prog, targets=targets,
                                         verify=False)
    assert report.counts() == {"bad": 1}


def _unfused_attention(fl):
    fl.unique_name.switch()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        q = fl.layers.data("q", shape=[2, 8, 16], dtype="float32")
        k = fl.layers.data("k", shape=[2, 8, 16], dtype="float32")
        v = fl.layers.data("v", shape=[2, 8, 16], dtype="float32")
        bias = fl.layers.data("bias", shape=[1, 1, 8], dtype="float32")
        s = fl.layers.elementwise_add(
            fl.layers.matmul(q, k, transpose_y=True, alpha=0.25), bias)
        out = fl.layers.matmul(fl.layers.softmax(s), v)
    return main, out.name


@pytest.mark.parametrize("min_t", ["1", "512"])
def test_attention_chain_advisory_is_the_reference_s(monkeypatch, min_t):
    """The scan runs the attention rewrite's matcher and gates: above the
    threshold the chain would be rewritten (no advisory, an applied
    rewrite in the dry run), below it the advisory names the gate, in
    both packages alike."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_T", min_t)
    got = {}
    for P in (J, T):
        main, out = _unfused_attention(P.fluid)
        diags = _dicts(P.verifier.verify_program(
            main, targets=[out], checks=["fusible-pattern-not-fused"]))
        got[P is T] = (diags, P.fusion.scan_fusible_patterns(
            main, targets=[out]).counts())
    assert got[True][0] == _as_port(got[False][0])
    assert got[True][1] == got[False][1]
    if min_t == "1":
        assert got[True][1] == {"attention": 1} and not got[True][0]
    else:
        assert "below the flash engagement threshold 512" \
            in got[True][0][0]["message"]


def test_fusion_bracket_tolerates_the_amp_drift(paths):
    """The AMP program arrives with ERROR drift: the baseline-aware
    bracket passes it, as the reference's does."""
    (tp, tt), = paths["bert_train_amp"][1]
    fused, report = tfusion.resolve_fused_program(tp, targets=tt)
    assert report.counts()


def test_fusion_bracket_runs_a_dp_worker_with_a_cluster_spec(monkeypatch):
    """With ``PADDLE_TPU_CLUSTER_SPEC`` set, an explicit verification of a
    transpiled worker raises for the unported planner comparison, but
    the ERROR-only fusion bracket skips that advisory check (the
    reference's yields a WARNING at most), so the worker still resolves
    and the spec still reaches the topology checks."""
    monkeypatch.setenv("PADDLE_TPU_CLUSTER_SPEC", json.dumps(SPEC))
    for prog, targets in _dp_workers(T):
        with pytest.raises(NotImplementedError, match="Queue A item 9"):
            tverifier.verify_program(prog, targets=targets)
        tverifier.verify_program(prog, targets=targets,
                                 exclude=["manual-plan-suboptimal"])
        fused, report = tfusion.resolve_fused_program(prog, targets=targets)
        assert fused is not prog and report.counts()


def _export(tmp_path):
    tfluid.unique_name.switch()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4], dtype="float32")
        y = tfluid.layers.fc(x, size=3, act="relu")
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        d = str(tmp_path / "model")
        tfluid.io.save_inference_model(d, ["x"], [y], exe,
                                       main_program=main)
    return d


def test_lint_program_exit_codes(tmp_path, capsys):
    """0 below the gate, 1 at or above it, 2 when nothing loads; the
    same diagnostics as ``verify_program`` on the loaded program."""
    d = _export(tmp_path)
    assert tlint.main([d]) == 0
    capsys.readouterr()
    assert tlint.main([d, "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["schema"] == 2
    info = str(tmp_path / "info.json")
    tproto.save_program(fx_unreferenced_op(tfluid)["program"], info)
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.lint_program",
         "--program-json", info, "--json", "--fail-on", "info"],
        capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    diags = json.loads(out.stdout)["diagnostics"]
    assert out.returncode == 1 and diags, out.stderr
    assert {x["check"] for x in diags} == {"unreferenced-op"}
    assert tlint.main(["--program-json", info]) == 0
    assert tlint.main(["--program-json", info, "--fail-on", "INFO",
                       "--exclude", "unreferenced-op"]) == 0
    assert tlint.main([str(tmp_path / "absent")]) == 2
