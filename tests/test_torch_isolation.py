"""The PyTorch port stands alone: it imports neither ``jax`` nor
``paddle_tpu`` (the observability layer with the drift monitor, the
profiler, the autotune cache, the concurrency proofs, the verifier's
battery with the abstract interpreter, cost model, schedule prover,
overlap and hierarchy passes and the planner's cluster spec, the serving,
lint, analyze, monitor and trace CLIs, the watchdog, the other
optimizers with the moving averages, decoupled weight decay and
``WeightedAverage`` included, the dygraph mode with its layers' ops, and
the control flow: ``While`` with its gradient, ``cond``, the tensor
arrays and the single-program GPT generation, and the recurrent models:
the NMT trainers and beam-search translation and the stacked dynamic
LSTM, with the beam-search ops and layers; the speculative decoder, the
seq2seq decoder DSL, SE-ResNeXt, VGG, ``nets`` and the vision ops; the
data-parallel runner behind ``CompiledProgram`` with ZeRO-1 and
iterations per run, the collective transpilers and layers, the
collective fleet and the quantized-collective chaos drill; the CTR
data path: datasets, ``train_from_dataset``, host-resident tables, the
native parsers, the readers and ``DataFeeder``, the data generators,
``datasets`` and the CTR and MNIST models), its entry points run on the GPU
unless the caller asks for the CPU, and what it has not ported yet
raises rather than being skipped silently."""

import os
import re
import subprocess
import sys

import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import analysis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKER = r"""
import sys


class _Block:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "paddle_tpu"):
            raise ImportError("blocked import of %r" % name)
        return None


sys.meta_path.insert(0, _Block())
import numpy as np
import paddle_tpu_torch as fluid
from paddle_tpu_torch.models import bert  # noqa: F401
from paddle_tpu_torch.models import gpt  # noqa: F401
from paddle_tpu_torch.models import resnet
import paddle_tpu_torch.serving  # noqa: F401
import paddle_tpu_torch.observability as obs
from paddle_tpu_torch.static_analysis import concurrency
from paddle_tpu_torch.static_analysis import (analyze, checks, cost,
                                              distributed, hierarchy,
                                              interp, overlap, verifier)
from paddle_tpu_torch.parallel import planner
from paddle_tpu_torch.tools import diag_cli, lint_program  # noqa: F401
from paddle_tpu_torch.tools import analyze_program, serve  # noqa: F401
from paddle_tpu_torch import autotune, profiler
from paddle_tpu_torch.observability import drift
from paddle_tpu_torch.tools import monitor, trace
from paddle_tpu_torch import average, resilience
from paddle_tpu_torch.contrib import extend_optimizer
from paddle_tpu_torch import dygraph as dg
from paddle_tpu_torch.dygraph.varbase import eager_op

main, startup = fluid.Program(), fluid.Program()
with fluid.program_guard(main, startup):
    x = fluid.layers.data("x", shape=[4], dtype="float32")
    y = fluid.layers.fc(x, size=3, act="gelu")
    loss = fluid.layers.reduce_sum(y)
    fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
scope = fluid.Scope()
with fluid.scope_guard(scope):
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    out, l0 = exe.run(main, feed={"x": np.ones((2, 4), "float32")},
                      fetch_list=[y, loss])
    l1 = exe.run(main, feed={"x": np.ones((2, 4), "float32")},
                 fetch_list=[loss])[0]
assert out.shape == (2, 3), out.shape
assert l1[0] < l0[0], (l0, l1)
assert concurrency.certify_zero_sync(main).ok
assert len(checks.all_checks()) == 28
diags = verifier.verify_program(main, targets=[loss.name])
assert not [d for d in diags if d.severity >= 3], diags
report = main.analyze(targets=[loss.name], workers=[main])
assert report.cost.total_flops > 0 and interp.interpret_program(main).records
assert distributed.prove_deadlock_free([main, main])[1] == []
assert cost.price_plan(report.cost).step_ms > 0
assert planner.ClusterSpec().hbm_gb == cost.H100_HBM_GB
assert overlap.apply_overlap_pass(main).applied == []
assert not hierarchy.apply_hierarchy_pass(main)
assert analyze.analyze_program(main).ok
assert obs.registry().get("steps_total", runner="executor").value == 3
assert drift.monitor().ratios()["step_ms"] > 0
assert autotune.decide_threshold({128: (2.0, 1.0), 512: (1.0, 2.0)}) == 512
assert autotune.backend() == "cpu"
profiler.start_profiler(state="CPU")
with profiler.record_event("iso"):
    pass
profiler.stop_profiler(profile_path=None)
assert profiler.host_event_stats()["iso"]["calls"] == 1
assert "paddle_tpu_steps_total" in obs.export_prometheus()
rmain, rstart, _, rloss, racc = resnet.build(depth=8, data_format="NHWC")
with fluid.scope_guard(fluid.Scope()):
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(rstart)
    rl, ra = exe.run(rmain, feed={
        "img": np.ones((2, 32, 32, 3), "float32"),
        "label": np.zeros((2, 1), "int64")}, fetch_list=[rloss, racc])
assert np.isfinite(rl).all() and ra.shape == (1,), (rl, ra)
import os
import tempfile

hb_dir = tempfile.mkdtemp()
main, startup = fluid.Program(), fluid.Program()
with fluid.program_guard(main, startup):
    x = fluid.layers.data("x", shape=[4], dtype="float32")
    y = fluid.layers.fc(x, size=3, param_attr=fluid.ParamAttr(
        name="w_avg", do_model_average=True))
    loss = fluid.layers.reduce_sum(y)
    extend_optimizer.extend_with_decoupled_weight_decay(
        fluid.optimizer.Adamax)(weight_decay=0.01,
                                learning_rate=0.01).minimize(loss)
    ema = fluid.optimizer.ExponentialMovingAverage(0.9)
    ema.update()
    avg = fluid.optimizer.ModelAverage(1.0, min_average_window=2,
                                       max_average_window=3)
with fluid.scope_guard(fluid.Scope()):
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    with resilience.HeartbeatWriter(hb_dir, rank=0, interval=0.05):
        for _ in range(3):
            exe.run(main, feed={"x": np.ones((2, 4), "float32")},
                    fetch_list=[loss])
    with ema.apply(exe), avg.apply(exe):
        pass
status = monitor.collect_status(hb_dir)
assert status["ranks"]["0"]["done"], status
assert monitor.check_alert(status, "alive_ranks<1")[0] == 0
assert trace.group_traces([]) == {}
w = average.WeightedAverage()
w.add(1.0, 1)
assert w.eval() == 1.0

import torch
import torch.distributed as dist
from paddle_tpu_torch import quant
from paddle_tpu_torch.transpiler import GradAllReduce

q, s = quant.block_quantize(torch.linspace(-1, 1, 1000))
assert q.dtype == torch.int8 and s.numel() == 4
back = quant.block_dequantize(q, s, size=1000)
assert float((back - torch.linspace(-1, 1, 1000)).abs().max()) <= float(
    s.max()) / 2
main, startup = fluid.Program(), fluid.Program()
with fluid.program_guard(main, startup):
    x = fluid.layers.data("x", shape=[4], dtype="float32")
    loss = fluid.layers.reduce_sum(fluid.layers.fc(x, size=3))
    fluid.optimizer.SGD(0.1).minimize(loss)
GradAllReduce().transpile(program=main, startup_program=startup, rank=0,
                          nranks=1)
main._quant_buckets = {"min_bytes": 1}
dist.init_process_group("gloo", init_method="file://" + os.path.join(
    tempfile.mkdtemp(), "store"), rank=0, world_size=1)
try:
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        assert scope.rings == {0: dist.group.WORLD}
        exe.run(main, feed={"x": np.ones((2, 4), "float32")},
                fetch_list=[loss])
finally:
    dist.destroy_process_group()
with dg.guard(fluid.CPUPlace()):
    net = dg.Conv2D(2, 3, 3, padding=1)
    bn = dg.BatchNorm(3, act="relu")
    opt = fluid.optimizer.Momentum(dg.PiecewiseDecay([1], [0.1, 0.01], 0),
                                   0.9, regularization=fluid.regularizer
                                   .L2Decay(1e-3))
    x = dg.to_variable(np.ones((2, 2, 4, 4), "float32"))
    loss = eager_op("mean", {"X": [bn(net(x))]})[0]
    loss.backward()
    opt.minimize(loss, parameter_list=net.parameters() + bn.parameters(),
                 grad_clip=fluid.dygraph_grad_clip.GradClipByGlobalNorm(1.0))
    path = os.path.join(tempfile.mkdtemp(), "net")
    dg.save_dygraph(net.state_dict(), path)
    assert set(dg.load_dygraph(path)[0]) == {"weight", "bias"}
from paddle_tpu_torch.ops import registry
for op_type in ("conv3d", "conv2d_transpose", "conv3d_transpose", "gru_unit",
                "prelu", "bilinear_tensor_product", "sequence_conv",
                "row_conv", "group_norm", "spectral_norm", "tree_conv",
                "nce"):
    assert registry.has_op(op_type) and registry.has_op(op_type + "_grad")
main, startup = fluid.Program(), fluid.Program()
with fluid.program_guard(main, startup):
    x = fluid.layers.data("x", shape=[1, 1], dtype="float32",
                          append_batch_size=False)
    y = fluid.layers.assign(x)
    i = fluid.layers.fill_constant([1], "int32", 0)
    limit = fluid.layers.fill_constant([1], "int32", 3)
    arr = fluid.layers.array_write(y, i, capacity=4)
    cond = fluid.layers.less_than(i, limit)
    loop = fluid.layers.While(cond, max_trip_count=4)
    with loop.block():
        fluid.layers.assign(fluid.layers.fc(
            y, size=1, bias_attr=False, param_attr=fluid.ParamAttr(
                name="iso.w", initializer=fluid.initializer.Constant(2.0))),
            output=y)
        fluid.layers.increment(i, value=1, in_place=True)
        fluid.layers.array_write(y, i, array=arr)
        fluid.layers.less_than(i, limit, cond=cond)
    z = fluid.layers.cond(fluid.layers.reduce_all(cond),
                          lambda: fluid.layers.scale(y, 2.0),
                          lambda: fluid.layers.scale(y, 3.0))
    loss = fluid.layers.mean(z)
    pg = fluid.backward.append_backward(loss)
    n = fluid.layers.array_length(arr)
with fluid.scope_guard(fluid.Scope()):
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    for _ in range(2):
        lv, gv, nv = exe.run(main, feed={"x": np.ones((1, 1), "float32")},
                             fetch_list=[loss, pg[0][1], n])
    assert float(lv[0]) == 24.0 and float(gv[0, 0]) == 36.0, (lv, gv)
    assert int(nv[0]) == 4 and exe.last_loops[0]["mode"] == "graph"
cfg = gpt.GPTConfig(vocab=16, hidden=8, layers=1, heads=2, max_len=16)
toks, glen, _, _ = gpt.run_generate(
    lambda: gpt.build_program(cfg, 2, 4, 3), cfg, 2, 4, 3,
    place=fluid.CPUPlace())
ntoks, _, _, _ = gpt.run_generate(
    lambda: gpt.build_naive_program(cfg, 2, 4, 3), cfg, 2, 4, 3,
    place=fluid.CPUPlace())
assert toks.shape == (2, 3) and (toks == ntoks).all(), (toks, ntoks)
from paddle_tpu_torch.layers import beam as beam_layers  # noqa: F401
from paddle_tpu_torch.models import machine_translation as mt
from paddle_tpu_torch.models import stacked_dynamic_lstm as sdl
from paddle_tpu_torch.ops import beam_search as beam_ops  # noqa: F401
feed = {"src": np.ones((2, 4), "int64"), "tgt_in": np.ones((2, 4), "int64"),
        "tgt_out": np.ones((2, 4, 1), "int64"),
        "tgt_lens": np.array([4, 2], "int64")}
scope = fluid.Scope()
for build in (mt.build_train, mt.build_train_dynamic):
    main, startup, feeds, loss = build(16, emb_dim=4, hidden_dim=8,
                                       src_len=4, tgt_len=4)
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        lv = exe.run(main, feed={f.name: feed[f.name] for f in feeds},
                     fetch_list=[loss])[0]
    assert np.isfinite(lv).all(), lv
main, startup, _, ids, scores = mt.build_infer(
    16, emb_dim=4, hidden_dim=8, src_len=4, batch_size=2, beam_size=3,
    max_len=5)
with fluid.scope_guard(scope):
    iv, sv = exe.run(main, feed={"src": feed["src"]},
                     fetch_list=[ids, scores])
assert iv.shape == (2, 3, 5) and np.isfinite(sv).all(), (iv, sv)
main, startup, _, loss, acc = sdl.build(vocab_size=16, seq_len=4,
                                        emb_dim=4, hidden_dim=4)
with fluid.scope_guard(fluid.Scope()):
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    lv, av = exe.run(main, feed={"words": feed["src"],
                                 "lens": feed["tgt_lens"],
                                 "label": np.zeros((2, 1), "int64")},
                     fetch_list=[loss, acc])
assert np.isfinite(lv).all() and av.shape == (1,), (lv, av)
from paddle_tpu_torch import nets
from paddle_tpu_torch.contrib import decoder as dsl  # noqa: F401
from paddle_tpu_torch.layers import nn_extra, nn_extra2  # noqa: F401
from paddle_tpu_torch.models import se_resnext, vgg
from paddle_tpu_torch.ops import metrics as metric_ops  # noqa: F401
from paddle_tpu_torch.serving import SpeculativeDecoder, ngram_draft
assert ngram_draft([5, 1, 2, 5, 9, 5], 3) == [9, 5, 5]
with SpeculativeDecoder(gpt.DecodeAdapter(cfg), draft="ngram", k=2,
                        prompt_buckets=(4,), place=fluid.CPUPlace(),
                        name="iso_spec") as dec:
    stoks, sinfo = dec.generate(np.asarray([1, 2, 1], "int32"),
                                max_new_tokens=4)
assert len(stoks) == 4 and sinfo["rounds"] >= 1, (stoks, sinfo)
for build, shape in ((lambda: se_resnext.build(
        depth=(1,), num_filters=(8,), cardinality=2, reduction_ratio=2),
        (2, 3, 32, 32)), (lambda: vgg.build(data_format="NHWC"),
                          (2, 32, 32, 3))):
    main, startup, _, loss, _acc = build()
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        lv = exe.run(main, feed={"img": np.ones(shape, "float32"),
                                 "label": np.zeros((2, 1), "int64")},
                     fetch_list=[loss])[0]
    assert np.isfinite(lv).all(), lv
main, startup = fluid.Program(), fluid.Program()
with fluid.program_guard(main, startup):
    img = fluid.layers.data("img", shape=[4, 8, 8], dtype="float32")
    y = nets.img_conv_group(img, [4], pool_size=2, pool_stride=2)
    y = fluid.layers.deformable_conv(
        y, fluid.layers.conv2d(y, 18, 3, padding=1), None, 4, 3, padding=1,
        modulated=False)
    y = fluid.layers.resize_bilinear(fluid.layers.roi_pool(
        y, fluid.layers.data("rois", shape=[1, 5], dtype="float32",
                             append_batch_size=False), 2, 2), [3, 3])
    seq = nets.sequence_conv_pool(fluid.layers.reshape(y, [-1, 9, 4]), 3, 2)
    loss = fluid.layers.mean(seq)
    fluid.backward.append_backward(loss)
with fluid.scope_guard(fluid.Scope()):
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    lv = exe.run(main, feed={"img": np.ones((2, 4, 8, 8), "float32"),
                             "rois": np.asarray([[0, 0, 0, 3, 3]],
                                                "float32")},
                 fetch_list=[loss])[0]
assert np.isfinite(lv).all(), lv
main, startup = fluid.Program(), fluid.Program()
with fluid.program_guard(main, startup):
    src = fluid.layers.data("src", shape=[2], dtype="int64")
    h0 = fluid.layers.fc(fluid.layers.cast(src, "float32"), size=4)
    cell = fluid.contrib.StateCell(
        inputs={"x": None}, states={"h": fluid.contrib.InitState(init=h0)},
        out_state="h")

    @cell.state_updater
    def _update(c):
        c.set_state("h", fluid.layers.fc(fluid.layers.concat(
            [c.get_input("x"), c.get_state("h")], axis=1), size=4,
            act="tanh"))
    emb = fluid.layers.embedding(src, size=[8, 4])
    decoder = fluid.contrib.TrainingDecoder(cell)
    with decoder.block():
        cell.compute_state(inputs={"x": decoder.step_input(emb)})
        cell.update_states()
        decoder.output(cell.out_state())
    dloss = fluid.layers.mean(decoder())
with fluid.scope_guard(fluid.Scope()):
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    lv = exe.run(main, feed={"src": np.ones((2, 2), "int64")},
                 fetch_list=[dloss])[0]
assert np.isfinite(lv).all(), lv
from paddle_tpu_torch import compiler, parallel
from paddle_tpu_torch.incubate.fleet.base import role_maker
from paddle_tpu_torch.incubate.fleet.collective import (
    DistributedStrategy, fleet)
from paddle_tpu_torch.layers import collective as coll_layers
from paddle_tpu_torch.tools import chaos
from paddle_tpu_torch.transpiler import (AsyncSGD, DistributeTranspiler,
                                         DistributeTranspilerConfig, GeoSGD,
                                         LocalSGD)
main, startup = fluid.Program(), fluid.Program()
with fluid.program_guard(main, startup):
    x = fluid.layers.data("x", shape=[4], dtype="float32")
    loss = fluid.layers.mean(fluid.layers.fc(x, size=3))
    coll_layers._allreduce(loss)
    fleet.init(role_maker.UserDefinedCollectiveRoleMaker(0, ["a:1"]))
    fleet.distributed_optimizer(fluid.optimizer.Adam(0.01),
                                DistributedStrategy()).minimize(loss)
bs = fluid.BuildStrategy()
bs.shard_optimizer_state = True
es = fluid.ExecutionStrategy()
es.num_iteration_per_run = 2
cp = fluid.CompiledProgram(main, bs).with_data_parallel(
    loss_name=loss.name, exec_strategy=es)
with fluid.scope_guard(fluid.Scope()):
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    lv = exe.run(cp, feed={"x": np.ones((2, 4), "float32")},
                 fetch_list=[loss])[0]
assert np.isfinite(lv).all() and main._num_trainers == 1, lv
for t in (LocalSGD(), GeoSGD(2), AsyncSGD(dc_asgd=True)):
    m, s = main.clone(), fluid.Program()
    t.transpile(program=m, startup_program=s, rank=0, nranks=2)
    assert any(op.type == "c_allreduce_sum" for op in m.global_block().ops)
cfg = DistributeTranspilerConfig()
cfg.mode = "nccl2"
DistributeTranspiler(cfg).transpile(0, program=main.clone(), trainers=2,
                                    startup_program=fluid.Program())
code, rec = chaos.run_quant_drill(steps=6, device="cpu",
                                  echo=lambda s: None)
assert code == 0 and len(rec["losses_quant"]) == 6, rec
from paddle_tpu_torch import (data_feeder, dataset, host_table, native,
                              reader, reader_decorators)
from paddle_tpu_torch.incubate import data_generator
from paddle_tpu_torch import datasets
from paddle_tpu_torch.models import ctr, mnist
ctr_dir = tempfile.mkdtemp()
with open(os.path.join(ctr_dir, "part-0"), "w") as f:
    for i in range(8):
        f.write("2 %d %d 2 %d 0 1 %d\n" % (i + 1, i + 2, i + 3, i % 2))
main, startup, feeds, loss, _ = ctr.build(
    model="deepfm", num_slots=2, slot_len=2, vocab=50, embed_dim=8)
ds = fluid.DatasetFactory().create_dataset("QueueDataset")
ds.set_batch_size(4)
ds.set_use_var(feeds)
ds.set_filelist([os.path.join(ctr_dir, "part-0")])
with fluid.scope_guard(fluid.Scope()):
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    out = exe.train_from_dataset(program=main, dataset=ds,
                                 fetch_list=[loss], print_period=0)
assert len(out) == 2 and np.isfinite(out[-1][0]).all(), out
assert native.is_native()
hl = ctr.run_deepfm_host_table_steps(steps=2, vocab=500, batch=4,
                                     place=fluid.CPUPlace())
assert len(hl) == 2 and np.isfinite(hl).all(), hl
mmain, mstart, mfeeds, mloss, _ = mnist.build()
loader = fluid.DataLoader.from_generator(feed_list=mfeeds, capacity=2)
loader.decorate_sample_list_generator(
    fluid.batch(reader_decorators.firstn(datasets.mnist.train(), 16), 8),
    places=fluid.CPUPlace())
with fluid.scope_guard(fluid.Scope()):
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(mstart)
    ml = [exe.run(mmain, feed=b, fetch_list=[mloss])[0] for b in loader]
assert len(ml) == 2 and np.isfinite(ml).all(), ml
assert data_feeder.DataFeeder(mfeeds, program=mmain).feed(
    [(np.zeros(784, "float32"), 1)])["label"].shape == (1, 1)
assert not any(m.split(".")[0] in ("jax", "paddle_tpu")
               for m in sys.modules), sorted(sys.modules)
print("ISOLATED-OK")
"""


def test_port_imports_and_runs_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _BLOCKER], cwd=REPO,
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, timeout=300)
    assert res.returncode == 0 and "ISOLATED-OK" in res.stdout, res.stdout


def _sources():
    root = os.path.join(REPO, "paddle_tpu_torch")
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "chip_ab.py")


def test_no_source_imports_jax_or_the_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|paddle_tpu)\b")
    hits = []
    for path in _sources():
        with open(path) as f:
            for n, line in enumerate(f, 1):
                if pat.match(line):
                    hits.append("%s:%d: %s" % (path, n, line.strip()))
    assert not hits, "\n".join(hits)
    assert len(list(_sources())) > 20


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_executor_defaults_to_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="CUDAPlace"):
        fluid.Executor()
    with pytest.raises(RuntimeError, match="CUDAPlace"):
        fluid.Executor(fluid.TPUPlace())
    assert fluid.Executor(fluid.CPUPlace()).device.type == "cpu"


def test_chaos_quant_defaults_to_cuda_and_refuses_without_it(no_cuda,
                                                             capsys):
    from paddle_tpu_torch.tools import chaos

    assert chaos.main(["--quant"]) == 2
    assert "--cpu" in capsys.readouterr().err
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        chaos.main(["--elastic"])


def test_decode_engine_defaults_to_cuda_and_raises_without_it(no_cuda):
    from paddle_tpu_torch.models import gpt

    cfg = gpt.GPTConfig(vocab=16, hidden=8, layers=1, heads=2, max_len=8)
    with pytest.raises(RuntimeError, match="CUDAPlace"):
        fluid.serving.DecodeEngine(gpt.DecodeAdapter(cfg), prompt_buckets=(4,),
                                   auto_start=False)
    eng = fluid.serving.DecodeEngine(gpt.DecodeAdapter(cfg),
                                     prompt_buckets=(4,),
                                     place=fluid.CPUPlace(), auto_start=False)
    assert eng.place == fluid.CPUPlace() and eng.paged


def test_data_path_defaults_to_cuda_and_raises_without_it(no_cuda,
                                                         tmp_path):
    import numpy as np

    from paddle_tpu_torch.models import mnist

    fluid.unique_name.switch()
    main, startup, feeds, loss, _ = mnist.build()
    path = str(tmp_path / "part")
    with open(path, "w") as f:
        f.write("784 %s 1 3\n" % " ".join(["0.5"] * 784))
    ds = fluid.DatasetFactory().create_dataset("QueueDataset")
    ds.set_use_var(feeds)
    ds.set_filelist([path])
    # train_from_dataset runs on its executor's place: CUDA by default
    with pytest.raises(RuntimeError, match="CUDAPlace"):
        fluid.Executor(fluid.CUDAPlace(0)).train_from_dataset(
            program=main, dataset=ds, fetch_list=[loss])
    rows = [(np.zeros(784, "float32"), 1)]
    loader = fluid.DataLoader.from_generator(feed_list=feeds, capacity=2)
    loader.decorate_sample_list_generator(lambda: iter([rows]))
    with pytest.raises(RuntimeError, match="CUDAPlace"):
        list(loader)
    plain = fluid.PyReader(feed_list=feeds, use_double_buffer=False)
    plain.decorate_sample_list_generator(lambda: iter([rows]))
    assert [b["img"].shape for b in plain] == [(1, 784)]  # host batches


def test_native_build_writes_nothing_under_the_sources():
    from paddle_tpu_torch import native

    src = os.path.dirname(native.__file__)
    before = sorted(os.walk(src))
    assert native.is_native()
    assert sorted(os.walk(src)) == before
    assert not os.path.commonpath([native.library_path(), src]) == src
    assert "_build" in native.library_path().split(os.sep)


def test_feed_pipeline_defaults_to_cuda_and_raises_without_it(no_cuda):
    import numpy as np

    from paddle_tpu_torch import pipeline

    feed = {"x": np.ones((2, 4), "float32")}
    with pytest.raises(RuntimeError, match="CUDAPlace"):
        pipeline.DeviceFeedPipeline([feed])
    with pytest.raises(RuntimeError, match="CUDAPlace"):
        pipeline.device_put_feed(feed)
    got = list(pipeline.DeviceFeedPipeline([feed, feed],
                                           place=fluid.CPUPlace()))
    assert [g["x"].device.type for g in got] == ["cpu", "cpu"]
    assert got[0]["x"] is got[1]["x"]  # the second is a cache hit


def _export_tiny(tmp_path):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        y = fluid.layers.fc(x, size=3)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        fluid.io.save_inference_model(str(tmp_path), ["x"], [y], exe,
                                      main_program=main)
    return str(tmp_path)


def test_predictor_defaults_to_cuda_and_raises_without_it(no_cuda,
                                                          tmp_path):
    d = _export_tiny(tmp_path)
    cfg = fluid.inference.AnalysisConfig(model_dir=d)
    assert cfg.use_gpu()
    with pytest.raises(RuntimeError, match="disable_gpu"):
        fluid.inference.create_paddle_predictor(cfg)
    cfg.disable_gpu()
    pred = fluid.inference.create_paddle_predictor(cfg)
    assert pred.place == fluid.CPUPlace()
    assert pred.run({"x": __import__("numpy").ones((1, 4), "float32")}
                    )[0].shape == (1, 3)


def test_unported_gates_raise(tmp_path):
    """The gates are ported: the server's construction gates (the
    concurrency proofs) run by default, and the verifier's battery runs
    behind ``Analyzer.run(verify=True)`` and ``Executor.run(verify=True)``
    (its planner comparison is what still raises, ROADMAP.md Queue A
    item 9)."""
    d = _export_tiny(tmp_path)
    cfg = fluid.inference.AnalysisConfig(model_dir=d)
    cfg.disable_gpu()
    pred = fluid.inference.create_paddle_predictor(cfg)
    server = fluid.serving.PredictorServer(pred, auto_start=False)
    assert server.certificates["default"].ok
    server.close()
    assert analysis.Analyzer().run(pred.program, verify=True) \
        is pred.program
    out = fluid.Executor(fluid.CPUPlace()).run(
        pred.program, feed={"x": __import__("numpy").ones((1, 4),
                                                          "float32")},
        fetch_list=pred.get_output_names(), scope=pred._scope, verify=True)
    assert out[0].shape == (1, 3)
    pred.program._cluster_spec = "2"
    for op in pred.program.global_block().ops[:1]:
        pred.program.global_block().append_op(
            type="c_allreduce_sum", inputs={"X": op.output_arg_names[:1]},
            outputs={"Out": op.output_arg_names[:1]}, attrs={"ring_id": 0})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fluid.Executor(fluid.CPUPlace()).run(pred.program, verify=True)


def test_unported_training_options_raise():
    """What training still lacks raises: an op of the reference the port
    has not registered (``dynamic_lstmp``, ROADMAP.md Queue A item 9)
    stops the run naming it.  The grads through ``recurrent`` (item 5)
    and ``while``, and the reference's other optimizers, which raised
    here until they were ported, are built now."""
    for name, base in (("Adagrad", fluid.optimizer.Optimizer),
                       ("RMSPropOptimizer", fluid.optimizer.Optimizer),
                       ("Ftrl", fluid.optimizer.Optimizer),
                       ("ModelAverage", fluid.optimizer.Optimizer)):
        cls = getattr(fluid.optimizer, name)
        assert isinstance(cls, type) and issubclass(cls, base), name
        assert name in fluid.optimizer.__all__
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[3, 4], dtype="float32")
        rnn = fluid.layers.DynamicRNN()
        with rnn.block():
            x_t = rnn.step_input(x, lengths=fluid.layers.data(
                "lens", shape=[], dtype="int64"))
            h = rnn.memory(shape=[4], value=0.0)
            hn = fluid.layers.fc(fluid.layers.concat([x_t, h], axis=1),
                                 size=4)
            rnn.update_memory(h, hn)
            rnn.output(hn)
        loss = fluid.layers.reduce_sum(rnn())
        fluid.optimizer.SGD(0.01).minimize(loss)
    types = [op.type for op in main.global_block().ops]
    assert "recurrent" in types and "recurrent_grad" in types
    from paddle_tpu_torch.ops import registry
    assert not registry.has_op("dynamic_lstmp")
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        out = prog.global_block().create_var(name="proj", dtype="float32")
        prog.global_block().append_op(type="dynamic_lstmp",
                                      inputs={"Input": [x]},
                                      outputs={"Projection": [out]})
    with pytest.raises(KeyError, match="dynamic_lstmp"):
        fluid.Executor(fluid.CPUPlace()).run(
            prog, feed={"x": __import__("numpy").ones((1, 4), "float32")},
            fetch_list=[out])


def test_resnet_unported_options_raise_and_cuda_is_the_default(no_cuda):
    from paddle_tpu_torch.models import resnet

    main, startup, _, _, _ = resnet.build(depth=8, data_format="NHWC")
    with pytest.raises(RuntimeError, match="CUDAPlace"):
        fluid.Executor().run(startup)
    with pytest.raises(RuntimeError, match="CUDAPlace"):
        fluid.Executor(fluid.CUDAPlace(0)).run(main)
