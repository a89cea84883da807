"""The port's optimizer updates, in place, against the reference's ops.

``paddle_tpu_torch``'s ``adam``, ``momentum``, ``sgd``, ``fused_adam``
and ``fused_sgd`` write their results into their input tensors (declared
``in_place``), through a hand-written kernel on the card and through
their plain PyTorch twins on the CPU, where these tests run them.  Here
they are held against the reference's lowerings on the same seeded
numpy inputs, trained models are held against the reference and against
the port's own eager executor, the ``optimizer`` fusion family is held
against the reference's report, and the executor's replay is shown to
skip its walk over the scope until the scope changes.  K3 backward's
plan and order of additions are held against ``index_add_``.

Tolerances.  The updates: float32 on both sides with the same formula,
so the port agrees with the reference to 2 float32 units in the last
place (XLA may round a product or a quotient another way); bfloat16
parameters to 1 bfloat16 unit.  The models: the one-step tolerances of
``tests/test_torch_training.py`` (loss 1e-4 relative, an Adam parameter
2 lr a step) and ``tests/test_torch_executor.py`` (bit for bit against
the port's eager path).
"""

import copy
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops import registry as j_registry
from paddle_tpu.static_analysis import fusion as jfusion

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.ops import registry as t_registry
from paddle_tpu_torch.ops.cuda import embedding as t_emb
from paddle_tpu_torch.ops.cuda import optimizer as t_opt
from paddle_tpu_torch.static_analysis import fusion as tfusion

SEED = 11
F32_ULPS = 2
BF16_UNIT = 2.0 ** -8
T = 32
BATCH = 2
STEPS = 3
LR = 1e-3
LOSS_RTOL = 1e-4
PARAM_ATOL = 2 * LR * STEPS

# ---------------------------------------------------------------------------
# the update ops against the reference's
# ---------------------------------------------------------------------------

_SHAPES = ((7, 5), (13,), (2, 3, 4))


def _member(rng, shape, step):
    """Seeded numpy inputs of one parameter's update at step ``step``."""
    return {"Param": rng.randn(*shape).astype("float32"),
            "Grad": (0.1 * rng.randn(*shape)).astype("float32"),
            "Moment1": (0.01 * rng.randn(*shape)).astype("float32"),
            "Moment2": np.abs(1e-3 * rng.randn(*shape)).astype("float32"),
            "Velocity": (0.1 * rng.randn(*shape)).astype("float32"),
            "Beta1Pow": np.full((1,), 0.9 ** step, "float32"),
            "Beta2Pow": np.full((1,), 0.999 ** step, "float32")}


_CASES = {
    "adam": ("adam", ("Param", "Grad", "Moment1", "Moment2", "Beta1Pow",
                      "Beta2Pow"), {"beta1": 0.9, "beta2": 0.999,
                                    "epsilon": 1e-8}),
    "momentum": ("momentum", ("Param", "Grad", "Velocity"),
                 {"mu": 0.9, "use_nesterov": False}),
    "momentum_nesterov": ("momentum", ("Param", "Grad", "Velocity"),
                          {"mu": 0.9, "use_nesterov": True}),
    "sgd": ("sgd", ("Param", "Grad"), {}),
    "fused_adam": ("fused_adam", ("Param", "Grad", "Moment1", "Moment2",
                                  "Beta1Pow", "Beta2Pow"),
                   {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "fused_sgd": ("fused_sgd", ("Param", "Grad"), {}),
}


def _op_inputs(case, dtype):
    """``{slot: [numpy array, ...]}`` for a case: one member, or three
    members at steps 1, 2 and 5 (each its own bias correction)."""
    op_type, slots, _attrs = _CASES[case]
    rng = np.random.RandomState(SEED)
    fused = op_type.startswith("fused_")
    members = [_member(rng, s, step) for s, step in
               zip(_SHAPES, (1, 2, 5) if fused else (3,))][:3 if fused
                                                           else 1]
    ins = {slot: [m[slot] for m in members] for slot in slots}
    if dtype == "bfloat16":  # values a bfloat16 holds exactly
        for slot in ("Param", "Grad", "Velocity"):
            if slot in ins:
                ins[slot] = [torch.from_numpy(a).bfloat16().float().numpy()
                             for a in ins[slot]]
    ins["LearningRate"] = [np.full((1,), LR, "float32")]
    return op_type, ins


def _to_jax(a, slot, dtype):
    x = jnp.asarray(a)
    return x.astype(jnp.bfloat16) if dtype == "bfloat16" and slot in (
        "Param", "Grad", "Velocity") else x


def _to_torch(a, slot, dtype):
    x = torch.from_numpy(a.copy())
    return x.bfloat16() if dtype == "bfloat16" and slot in (
        "Param", "Grad", "Velocity") else x


def _tol(dtype, want):
    if dtype == "bfloat16":
        return BF16_UNIT * np.abs(want).max()
    return F32_ULPS * np.spacing(np.abs(want).max().astype("float32"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_update_op_matches_reference_and_writes_its_inputs(case, dtype):
    """Every output of the port's op equals the reference's op on the
    same inputs (float32: within 2 units in the last place; bfloat16
    parameters: 1 bfloat16 unit), and is the input tensor it was
    declared to write (same object, same storage)."""
    op_type, ins = _op_inputs(case, dtype)
    attrs = _CASES[case][2]
    jdef = j_registry.get_op_def(op_type)
    want = j_registry.call_op(
        jdef, j_registry.LoweringContext(),
        {s: [_to_jax(a, s, dtype) for a in v] for s, v in ins.items()},
        attrs)
    tdef = t_registry.get_op_def(op_type)
    t_ins = {s: [_to_torch(a, s, dtype) for a in v] for s, v in ins.items()}
    ptrs = {s: [t.data_ptr() for t in v] for s, v in t_ins.items()}
    got = t_registry.call_op(tdef, t_registry.LoweringContext(), t_ins,
                             attrs)
    assert set(tdef.in_place) == set(got) == set(want)
    for out_slot, in_slot in tdef.in_place.items():
        for i, (g, w) in enumerate(zip(got[out_slot], want[out_slot])):
            assert g is t_ins[in_slot][i]
            assert g.data_ptr() == ptrs[in_slot][i]
            w = np.asarray(jnp.asarray(w).astype(jnp.float32))
            g = g.float().numpy()
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=_tol(dtype, w),
                                       err_msg="%s %s[%d]"
                                       % (case, out_slot, i))


@pytest.mark.parametrize("op_type", ["adam", "sgd"])
def test_fused_op_equals_per_parameter_ops_bit_for_bit(op_type):
    """``fused_<op>`` over three members gives each member exactly what
    the per-parameter op gives it, each member at its own step."""
    _, ins = _op_inputs("fused_" + op_type, "float32")
    attrs = _CASES[op_type][2]
    fused = {s: [torch.from_numpy(a.copy()) for a in v]
             for s, v in ins.items()}
    t_registry.call_op(t_registry.get_op_def("fused_" + op_type),
                       t_registry.LoweringContext(), fused, attrs)
    for i in range(len(ins["Param"])):
        one = {s: [torch.from_numpy(v[0 if s == "LearningRate"
                                      else i].copy())]
               for s, v in ins.items()}
        t_registry.call_op(t_registry.get_op_def(op_type),
                           t_registry.LoweringContext(), one, attrs)
        for s in one:
            if s != "LearningRate":
                np.testing.assert_array_equal(fused[s][i].numpy(),
                                              one[s][0].numpy(), err_msg=s)


def test_update_wrappers_refuse_what_the_kernels_do_not_take():
    """A CUDA wrapper's argument checks, run on meta tensors that claim
    to be elsewhere: the plain path takes CPU and meta tensors and
    updates them in place; shared members are refused before a
    launch."""
    p = torch.zeros(4)
    lr = torch.full((1,), 0.5)
    t_opt.sgd_(p, torch.ones(4), lr)
    np.testing.assert_array_equal(p.numpy(), np.full(4, -0.5, "float32"))
    with pytest.raises(ValueError, match="share a parameter"):
        t_opt._distinct(t_opt.MULTI_SGD, "parameter", [p, p])
    with pytest.raises(ValueError, match="elements"):
        t_opt._check(t_opt.SGD, [p], [torch.ones(3)], [lr])
    with pytest.raises(ValueError, match="contiguous"):
        t_opt._check(t_opt.SGD, [p], [torch.ones(8)[::2]], [lr])
    with pytest.raises(TypeError, match="differ in dtype"):
        t_opt._same(t_opt.MULTI_ADAM, "moments",
                    [p, torch.zeros(4, dtype=torch.bfloat16)])
    assert t_opt.CHUNK == {"multi_tensor_adam": 56, "multi_tensor_sgd": 128}


# ---------------------------------------------------------------------------
# update order: every grad op before the in-place updates
# ---------------------------------------------------------------------------

def _grad_and_update_positions(program):
    ops = program.global_block().ops
    grads = [i for i, op in enumerate(ops) if op.type.endswith("_grad")]
    updates = [i for i, op in enumerate(ops)
               if op.type in ("adam", "momentum", "sgd", "fused_adam",
                              "fused_sgd")]
    return grads, updates


@pytest.mark.parametrize("model", ["bert", "resnet"])
def test_updates_follow_every_grad_op(model):
    """In the programs the main paths run (fusion-resolved BERT
    pretraining with Adam, ResNet with Momentum), every update op comes
    after every grad op, so no grad op reads a parameter an update has
    written."""
    with tfluid.unique_name.guard():
        if model == "bert":
            main, _startup, _feeds, loss = tbert.build_pretrain(
                _bert_cfg(tbert), seq_len=T)
        else:
            main, _startup, _feeds, loss, _acc = tresnet.build(
                "cifar10", depth=8, data_format="NHWC")
    prog = tfusion.resolve_fused_program(main, targets=[loss.name])[0]
    grads, updates = _grad_and_update_positions(prog)
    assert grads and updates
    assert max(grads) < min(updates)


def _small_sgd_program():
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = SEED
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4], dtype="float32")
        h = tfluid.layers.fc(x, size=3, param_attr="w", bias_attr="b")
        loss = tfluid.layers.mean(h)
        tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("cache", [False, True], ids=["eager", "cached"])
def test_update_before_a_grad_op_raises_with_its_name(cache):
    """A program with an update of ``w`` (by a fed gradient) before the
    grad op of a forward that read ``w`` raises at that update, naming it
    and ``w``, and leaves ``w`` as it was; nothing falls back to a
    functional update."""
    main, startup, loss = _small_sgd_program()
    block = main.global_block()
    grad = min(i for i, op in enumerate(block.ops)
               if op.type.endswith("_grad"))
    lr = next(op for op in block.ops
              if op.type == "sgd").inputs["LearningRate"]
    block.create_var(name="gw", shape=[4, 3], dtype="float32")
    block._insert_op(grad, type="sgd",
                     inputs={"Param": ["w"], "Grad": ["gw"],
                             "LearningRate": lr},
                     outputs={"ParamOut": ["w"]},
                     attrs={"op_role": "optimize"})
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    before = scope.get("w").clone()
    feed = {"x": np.random.RandomState(SEED).randn(2, 4).astype("float32"),
            "gw": np.ones((4, 3), "float32")}
    with pytest.raises(RuntimeError, match="sgd writes 'w' in place"):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                use_program_cache=cache)
    np.testing.assert_array_equal(scope.get("w").numpy(), before.numpy())


# ---------------------------------------------------------------------------
# trained models: the reference, and the port's eager path, bit for bit
# ---------------------------------------------------------------------------

def _bert_cfg(bert):
    cfg = copy.copy(bert.BERT_TINY)
    cfg.fuse_attn = True
    cfg.dropout = cfg.attn_dropout = 0.0
    return cfg


def _bert(fluid, bert):
    with fluid.unique_name.guard():
        main, startup, _feeds, loss = bert.build_pretrain(
            _bert_cfg(bert), seq_len=T, lr=LR)
    main.random_seed = startup.random_seed = SEED
    return main, startup, loss


def _bert_batches():
    return [tbert.make_fake_batch(BATCH, T, _bert_cfg(tbert),
                                  np.random.RandomState(SEED + s))
            for s in range(STEPS)]


def _reference_bert():
    main, startup, loss = _bert(jfluid, jbert)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        start = {p.name: np.asarray(scope.get(p.name))
                 for p in main.all_parameters()}
        losses = [float(np.asarray(exe.run(main, feed=b,
                                           fetch_list=[loss])[0]).reshape(-1)
                        [0]) for b in _bert_batches()]
        params = {n: np.asarray(scope.get(n)) for n in start}
    return start, losses, params


def _port_bert(start, cache):
    main, startup, loss = _bert(tfluid, tbert)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    convert.load_params_into_scope(start, scope, "cpu", program=main)
    resident = {n: scope.get(n) for n in start}
    losses = [float(np.asarray(exe.run(
        main, feed=b, fetch_list=[loss], scope=scope,
        use_program_cache=cache)[0]).reshape(-1)[0])
        for b in _bert_batches()]
    copies = [e.copy_backs for e in exe._cache.values()
              if e.reads is not None]
    state = {n: scope.get(n).numpy().copy()
             for n in _persistables(main) if scope.has(n)}
    return losses, state, copies, resident, scope, exe.last_run_mode


def _persistables(program):
    return sorted(v.name for v in program.global_block().vars.values()
                  if v.persistable and not getattr(v, "is_data", False))


def test_bert_trains_like_the_reference_and_its_eager_path():
    """A tiny BERT (dropout 0) trained 3 Adam steps from the reference's
    parameters: the port's losses and parameters match the reference's
    at the one-step tolerances; the compiled step (warm-up, capture,
    replay) gives the eager path's losses and every persistable bit for
    bit, makes no copy-back, and leaves every parameter in the tensor it
    started in."""
    start, want_losses, want_params = _reference_bert()
    got, got_state, copies, resident, scope, mode = _port_bert(start, True)
    eager, eager_state, _, _, _, _ = _port_bert(start, False)
    assert mode == "graph" and copies == [0]
    np.testing.assert_allclose(got, want_losses, rtol=LOSS_RTOL)
    for n, w in want_params.items():
        np.testing.assert_allclose(got_state[n], w, rtol=0, atol=PARAM_ATOL,
                                   err_msg=n)
        assert scope.get(n) is resident[n]
    assert got == eager
    for n in eager_state:
        np.testing.assert_array_equal(got_state[n], eager_state[n],
                                      err_msg=n)


def _resnet_runs(cache):
    with tfluid.unique_name.guard():
        main, startup, _feeds, loss, acc = tresnet.build(
            "cifar10", depth=8, data_format="NHWC")
    main.random_seed = startup.random_seed = SEED
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED)
    outs = []
    for _ in range(STEPS):
        batch = {"img": rng.randn(2, 32, 32, 3).astype("float32"),
                 "label": rng.randint(0, 10, (2, 1)).astype("int64")}
        outs.append(exe.run(main, feed=batch, fetch_list=[loss, acc],
                            scope=scope, use_program_cache=cache))
    copies = [e.copy_backs for e in exe._cache.values()
              if e.reads is not None]
    state = {n: scope.get(n).numpy().copy()
             for n in _persistables(main) if scope.has(n)}
    return outs, state, copies, exe.last_run_mode


def test_resnet_compiled_steps_equal_eager_with_no_copy_back():
    """A small NHWC ResNet with Nesterov Momentum and batch-norm
    statistics, 3 steps: the compiled step equals the eager path bit for
    bit (losses, velocities, parameters, statistics) and copies no state
    back: the updates write in place and the statistics too."""
    got, got_state, copies, mode = _resnet_runs(True)
    want, want_state, _, _ = _resnet_runs(False)
    assert mode == "graph" and copies == [0]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert any("velocity" in n for n in got_state)
    for n in want_state:
        np.testing.assert_array_equal(got_state[n], want_state[n],
                                      err_msg=n)


# ---------------------------------------------------------------------------
# the optimizer fusion family against the reference's
# ---------------------------------------------------------------------------

def _mlp(fluid, optimizer, widths):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[widths[0]], dtype="float32")
        y = fluid.layers.data("y", shape=[widths[-1]], dtype="float32")
        h = x
        for w in widths[1:]:
            h = fluid.layers.fc(h, size=w)
        err = fluid.layers.elementwise_sub(h, y)
        loss = fluid.layers.mean(fluid.layers.elementwise_mul(err, err))
        if optimizer == "adam":
            fluid.optimizer.Adam(learning_rate=LR).minimize(loss)
        else:
            fluid.optimizer.SGD(learning_rate=LR).minimize(loss)
    return main, startup, loss


def _reason_numbers(reason):
    return [int(n) for n in re.findall(r"~(\d+) MB", reason)] \
        + [int(re.search(r"for (\d+) params", reason).group(1))]


# narrow layers fuse at the CPU gate (256 KiB a launch); wide ones do not
_MLPS = {"narrow": (8, 16, 16, 16, 4), "wide": (512, 1024, 1024, 4)}


@pytest.mark.parametrize("widths", sorted(_MLPS))
@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_optimizer_family_decides_as_the_reference(optimizer, widths):
    """The same program built by both packages: the ``optimizer``
    family fuses the same runs into the same ops (indices, members,
    predicted bytes) and skips the same runs for the same reason (its
    numbers: traffic added, launch savings, members), and the fused
    program's op types are the reference's."""
    progs, reports = [], []
    for fluid, fusion in ((jfluid, jfusion), (tfluid, tfusion)):
        main, _startup, loss = _mlp(fluid, optimizer, _MLPS[widths])
        prog, report = fusion.resolve_fused_program(main,
                                                    targets=[loss.name])
        progs.append([op.type for op in prog.global_block().ops])
        reports.append(report)
    jrep, trep = reports
    assert progs[0] == progs[1]

    def applied(rep):
        return [(r.family, r.fused_op_type, list(r.op_idxs), list(r.vars),
                 r.predicted) for r in rep.applied if r.family == "optimizer"]

    def skipped(rep):
        return [(s.family, s.op_idx, s.op_type, _reason_numbers(s.reason))
                for s in rep.skipped if s.family == "optimizer"]

    assert applied(trep) == applied(jrep)
    assert skipped(trep) == skipped(jrep)
    assert applied(trep) if widths == "narrow" else skipped(trep)


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_fused_program_trains_as_the_unfused_one(optimizer, monkeypatch):
    """The narrow MLP trained 3 steps with the fusion pipeline (one
    ``fused_<op>``) and without (per-parameter ops) gives the same
    losses and parameters bit for bit, compiled, with no copy-back."""
    def run(fuse):
        monkeypatch.setenv("PADDLE_TPU_FUSION", "1" if fuse else "0")
        main, startup, loss = _mlp(tfluid, optimizer, _MLPS["narrow"])
        prog, report = tfusion.resolve_fused_program(main,
                                                     targets=[loss.name])
        assert bool(report.counts().get("optimizer")) == fuse
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        rng = np.random.RandomState(SEED)
        losses = [exe.run(main, feed={
            "x": rng.randn(4, 8).astype("float32"),
            "y": rng.randn(4, 4).astype("float32")}, fetch_list=[loss],
            scope=scope)[0] for _ in range(STEPS)]
        copies = [e.copy_backs for e in exe._cache.values()
                  if e.reads is not None]
        return losses, {p.name: scope.get(p.name).numpy().copy()
                        for p in main.all_parameters()}, copies

    fused, fused_params, copies = run(True)
    plain, plain_params, _ = run(False)
    assert copies == [0]
    for a, b in zip(fused, plain):
        np.testing.assert_array_equal(a, b)
    for n in plain_params:
        np.testing.assert_array_equal(fused_params[n], plain_params[n])


def test_optimizer_fuse_overhead_follows_the_environment(monkeypatch):
    """``PADDLE_TPU_FUSE_OPT_OVERHEAD_BYTES`` overrides the default, as in
    the reference, and the default on a host without CUDA is the
    reference's CPU default; both are part of the fusion signature."""
    monkeypatch.delenv("PADDLE_TPU_FUSE_OPT_OVERHEAD_BYTES", raising=False)
    assert tfusion.optimizer_fuse_overhead_bytes() \
        == jfusion.optimizer_fuse_overhead_bytes() == 256 << 10
    base = tfusion.FusionConfig().signature()
    monkeypatch.setenv("PADDLE_TPU_FUSE_OPT_OVERHEAD_BYTES", "1234")
    assert tfusion.optimizer_fuse_overhead_bytes() == 1234
    assert tfusion.FusionConfig().signature() != base
    assert tfusion.FusionConfig(fuse_optimizer=False).signature() \
        != tfusion.FusionConfig().signature()


# ---------------------------------------------------------------------------
# the replay's walk over the scope
# ---------------------------------------------------------------------------

class _CountingScope(tfluid.Scope):
    """A child scope that counts the values looked up through it."""

    gets = 0

    def get(self, name):
        _CountingScope.gets += 1
        return super().get(name)


def test_replay_walks_the_scope_only_after_it_changed(tmp_path):
    """A replay whose scope has not changed since the last one reads no
    scope value.  A value of the same shape put in the scope after a
    replay, by ``set`` in the parent scope that holds it, by
    ``io.load_persistables`` or by a ``convert`` load, is copied into the
    captured tensor: the next step trains from it.  A value of another
    shape drops the entry."""
    parent = tfluid.Scope()
    scope = _CountingScope(parent=parent)
    main, startup, loss = _small_sgd_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=parent)  # the state lives in the parent
    x = np.random.RandomState(SEED).randn(2, 4).astype("float32")

    def step():
        exe.run(main, feed={"x": x}, fetch_list=[loss], scope=scope)
        return exe.last_run_mode

    assert [step() for _ in range(3)] == ["eager", "capture", "graph"]
    captured = scope.get("w")
    _CountingScope.gets = 0
    assert step() == "graph" and _CountingScope.gets == 0

    def trains_from(value):
        assert step() == "graph" and scope.get("w") is captured
        grad = np.tile(x.mean(0)[:, None] / 3, (1, 3))
        np.testing.assert_allclose(captured.numpy(), value - 0.1 * grad,
                                   rtol=1e-6, atol=1e-7)

    w = np.full((4, 3), 0.25, "float32")
    parent.set("w", torch.from_numpy(w.copy()))
    trains_from(w)
    saved = captured.numpy().copy()
    with tfluid.scope_guard(scope):
        tfluid.io.save_persistables(exe, str(tmp_path), main_program=main)
        step()
        tfluid.io.load_persistables(exe, str(tmp_path), main_program=main)
    trains_from(saved)
    convert.load_params_into_scope({"w": w * 2}, scope, "cpu", program=main)
    trains_from(w * 2)
    scope.set("b", torch.zeros((1, 3)))  # another shape
    assert step() == "eager"  # the entry was dropped


# ---------------------------------------------------------------------------
# SGD at odd lengths, per parameter and multi-tensor
# ---------------------------------------------------------------------------

_SGD_LENGTHS = (1, 7, 4097)


def _sgd_inputs(dtype, lengths):
    """Seeded numpy parameters and gradients of ``lengths`` (bfloat16:
    values a bfloat16 holds exactly) and the learning rate."""
    rng = np.random.RandomState(SEED)
    ins = {"Param": [rng.randn(n).astype("float32") for n in lengths],
           "Grad": [(0.1 * rng.randn(n)).astype("float32")
                    for n in lengths]}
    if dtype == "bfloat16":
        ins = {k: [torch.from_numpy(a).bfloat16().float().numpy()
                   for a in v] for k, v in ins.items()}
    ins["LearningRate"] = [np.full((1,), LR, "float32")]
    return ins


def _reference_sgd(op_type, ins, dtype):
    out = j_registry.call_op(
        j_registry.get_op_def(op_type), j_registry.LoweringContext(),
        {s: [_to_jax(a, s, dtype) for a in v] for s, v in ins.items()}, {})
    return [np.asarray(jnp.asarray(w).astype(jnp.float32))
            for w in out["ParamOut"]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", _SGD_LENGTHS)
def test_sgd_plain_matches_reference_at_odd_lengths(length, dtype):
    """``sgd_plain`` and ``sgd_`` on the CPU against the reference's
    ``sgd`` lowering (float32: 2 units in the last place; bfloat16: 1
    bfloat16 unit), at lengths that leave a scalar tail after the
    kernel's 16-byte vectors."""
    ins = _sgd_inputs(dtype, (length,))
    (want,) = _reference_sgd("sgd", ins, dtype)
    p, g = (_to_torch(ins[s][0], s, dtype) for s in ("Param", "Grad"))
    lr = torch.from_numpy(ins["LearningRate"][0])
    plain = t_opt.sgd_plain(p, g, lr)
    np.testing.assert_allclose(plain.float().numpy(), want, rtol=0,
                               atol=_tol(dtype, want))
    ptr = p.data_ptr()
    assert t_opt.sgd_(p, g, lr) is p and p.data_ptr() == ptr
    assert torch.equal(p, plain)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_sgd_matches_reference_fused_sgd(dtype):
    """``multi_sgd_`` over members of lengths 1, 7 and 4097 on the CPU
    against the reference's ``fused_sgd`` (tolerances as for ``sgd``),
    each member written in place and equal to ``sgd_plain`` bit for
    bit."""
    ins = _sgd_inputs(dtype, _SGD_LENGTHS)
    wants = _reference_sgd("fused_sgd", ins, dtype)
    ps, gs = ([_to_torch(a, s, dtype) for a in ins[s]]
              for s in ("Param", "Grad"))
    lr = torch.from_numpy(ins["LearningRate"][0])
    plains = [t_opt.sgd_plain(p, g, lr) for p, g in zip(ps, gs)]
    ptrs = [p.data_ptr() for p in ps]
    got = t_opt.multi_sgd_(ps, gs, lr)
    for i, (p, want, plain) in enumerate(zip(got, wants, plains)):
        assert p is ps[i] and p.data_ptr() == ptrs[i]
        assert torch.equal(p, plain)
        np.testing.assert_allclose(p.float().numpy(), want, rtol=0,
                                   atol=_tol(dtype, want),
                                   err_msg="member %d" % i)


# ---------------------------------------------------------------------------
# K3 backward's plan and order of additions
# ---------------------------------------------------------------------------

_PLAN_CASES = {
    # random over a small vocabulary: rows of ~20 ids, a few above LONG
    "random": (200, 4096, lambda rng: rng.randint(0, 200, 4096), -1),
    # one id over every position: one long row, summed in parts
    "all_alike": (50, 4096, lambda rng: np.full(4096, 7), -1),
    # negative ids feed row 0; ids >= V and padding_idx send nothing
    "ragged": (30, 300, lambda rng: rng.randint(-3, 35, 300), 4),
    # more ids than a block of the kernels scans at once (csrc kChunk)
    "several_chunks": (700, 9000, lambda rng: rng.randint(-1, 702, 9000),
                        3),
}


@pytest.mark.parametrize("case", sorted(_PLAN_CASES))
def test_scatter_plan_segment_sum_matches_index_add(case):
    """The backward's plan (``scatter_plan``) and the kernels' order of
    additions (``embedding_gather_bwd_sorted_plain``) against
    ``index_add_``.  The plan: every position that sends a gradient once,
    ordered by (row, position); its rows unique and ascending; each
    segment the positions of its row.  The sums: equal to ``index_add_``
    bit for bit where every row has at most LONG ids (the kernel adds
    them in the ids' order, as ``index_add_`` on the CPU), else within
    1e-5 of the largest row sum (parts, then their sums, in a fixed
    order)."""
    rows, n, make, pad = _PLAN_CASES[case]
    rng = np.random.RandomState(SEED)
    ids = torch.from_numpy(make(rng).astype("int64"))
    dout = torch.from_numpy(rng.randn(n, 24).astype("float32"))
    perm, keys, starts = t_emb.scatter_plan(ids, rows, pad)
    kept = torch.nonzero((ids < rows) & (ids != pad)).reshape(-1)
    assert torch.equal(torch.sort(perm).values, kept)
    row_of = ids.clamp(min=0)[perm]
    assert torch.equal(torch.unique(row_of), keys)
    assert int(starts[0]) == 0 and int(starts[-1]) == kept.numel()
    assert bool((starts[1:] > starts[:-1]).all())
    for j in range(keys.numel()):
        seg = perm[starts[j]:starts[j + 1]]
        assert bool((row_of[starts[j]:starts[j + 1]] == keys[j]).all())
        assert bool((seg[1:] > seg[:-1]).all())
    want = t_emb.embedding_gather_bwd_plain(dout, ids, rows, pad)
    got = t_emb.embedding_gather_bwd_sorted_plain(dout, (perm, keys, starts),
                                                  rows)
    longest = int((starts[1:] - starts[:-1]).max())
    if longest <= t_emb.LONG:
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
    untouched = torch.ones(rows, dtype=torch.bool)
    untouched[keys] = False
    assert float(got[untouched].abs().sum()) == 0.0
