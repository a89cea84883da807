"""The reference's other optimizers in the port, against the reference.

The nine update ops (``adamax``, ``adagrad``, ``decayed_adagrad``,
``adadelta``, ``rmsprop`` plain and centered, ``ftrl`` at ``lr_power``
-0.5 and another, ``average_accumulates``, ``proximal_gd``,
``proximal_adagrad``) go through both packages' ``call_op`` on the same
seeded numpy inputs, and each port op writes its results into the
tensors it was declared to write.  The optimizer classes train bert-tiny
for 3 steps in both packages from the reference's start (parameters
copied with ``paddle_tpu_torch.convert``; the program built by one
function, ``chip_smoke.rule_program``), the reference running its Pallas
kernels in interpret mode; then the port's compiled step is held to its
eager step.  Also DGCMomentum's warning and its update, which is
Momentum's; ``PipelineOptimizer``'s record; decoupled weight decay; the
aliases; ``WeightedAverage``.

Tolerances.  The ops: float32 on both sides with the same formula, 2
float32 units in the last place (measured: 0).  Training: the losses to
1e-4 relative (measured 1e-7).  The accumulators to 1e-4 of the largest
value of that accumulator over the parameters (measured 1.2e-5 at most,
RMSProp's momentum).  A parameter to 1e-5 of the model's largest
parameter value (measured 1.7e-7 of it, Adadelta) plus, element by
element, what the two packages' gradients of it can explain
(``chip_smoke.rule_parity_tol``): a rule that divides the gradient by
a running norm of itself moves an element by up to a full step either
way only where its gradients differ in sign or by a large share of
themselves (rounding noise: the attention key bias, whose exact
gradient is zero under softmax's shift invariance, and elements near
zero), and otherwise by a share of a step proportional to their
relative difference; DGCMomentum by ``lr`` times the gradients'
difference; Ftrl also by its l1 and l2 shift, which grows as the
gradient shrinks.  The same bounds must fail the port's update dropped
or reversed.
"""

import copy
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops import registry as j_registry

import chip_smoke
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import registry as t_registry
from test_torch_executor import private_autotune  # noqa: F401 - a fixture

SEED = 7
F32_ULPS = 2
T = 32
BATCH = 2
STEPS = 3
LR = 1e-3
LOSS_RTOL = 1e-4
ACC_RTOL = 1e-4
PARAM_RTOL = 1e-5
# ---------------------------------------------------------------------------
# the update ops against the reference's
# ---------------------------------------------------------------------------

_SHAPE = (9, 7)


def _draw(rng, scale, positive=False, offset=0.0):
    a = scale * rng.randn(*_SHAPE)
    return (np.abs(a) + offset if positive else a).astype("float32")


def _lr(value=1e-2):
    return np.full((1,), value, "float32")


_OP_CASES = {
    "adamax": ("adamax", lambda r: {
        "Param": _draw(r, 1), "Grad": _draw(r, .1), "LearningRate": _lr(),
        "Moment": _draw(r, .01), "InfNorm": _draw(r, .1, True),
        "Beta1Pow": np.full((1,), 0.9 ** 3, "float32")},
        {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "adagrad": ("adagrad", lambda r: {
        "Param": _draw(r, 1), "Grad": _draw(r, .1),
        "Moment": _draw(r, .01, True), "LearningRate": _lr()},
        {"epsilon": 1e-6}),
    "decayed_adagrad": ("decayed_adagrad", lambda r: {
        "Param": _draw(r, 1), "Grad": _draw(r, .1),
        "Moment": _draw(r, .01, True), "LearningRate": _lr()},
        {"decay": 0.95, "epsilon": 1e-6}),
    "adadelta": ("adadelta", lambda r: {
        "Param": _draw(r, 1), "Grad": _draw(r, .1),
        "AvgSquaredGrad": _draw(r, .01, True),
        "AvgSquaredUpdate": _draw(r, .001, True)},
        {"rho": 0.95, "epsilon": 1e-6}),
    "rmsprop": ("rmsprop", lambda r: {
        "Param": _draw(r, 1), "Grad": _draw(r, .1),
        "MeanSquare": _draw(r, .01, True), "MeanGrad": _draw(r, .001),
        "Moment": _draw(r, .01), "LearningRate": _lr()},
        {"epsilon": 1e-6, "decay": 0.95, "momentum": 0.9,
         "centered": False}),
    "rmsprop_centered": ("rmsprop", lambda r: {
        "Param": _draw(r, 1), "Grad": _draw(r, .1),
        "MeanSquare": _draw(r, .01, True, 0.01), "MeanGrad": _draw(r, .001),
        "Moment": _draw(r, .01), "LearningRate": _lr()},
        {"epsilon": 1e-6, "decay": 0.95, "momentum": 0.9,
         "centered": True}),
    "ftrl": ("ftrl", lambda r: {
        "Param": _draw(r, 1), "SquaredAccumulator": _draw(r, .01, True),
        "LinearAccumulator": _draw(r, .1), "Grad": _draw(r, .1),
        "LearningRate": _lr()},
        {"l1": 0.01, "l2": 0.02, "lr_power": -0.5}),
    "ftrl_general": ("ftrl", lambda r: {
        "Param": _draw(r, 1), "SquaredAccumulator": _draw(r, .01, True),
        "LinearAccumulator": _draw(r, .1), "Grad": _draw(r, .1),
        "LearningRate": _lr()},
        {"l1": 0.01, "l2": 0.02, "lr_power": -0.25}),
    "proximal_gd": ("proximal_gd", lambda r: {
        "Param": _draw(r, 1), "Grad": _draw(r, .1), "LearningRate": _lr(.1)},
        {"l1": 0.01, "l2": 0.02}),
    # nonzero gradients: lr / sqrt(m) is 0/0 at m = 0 in both packages
    "proximal_adagrad": ("proximal_adagrad", lambda r: {
        "Param": _draw(r, 1), "Moment": _draw(r, .01, True),
        "Grad": _draw(r, .1, True, 1e-3) * np.sign(r.randn(*_SHAPE)).astype(
            "float32"), "LearningRate": _lr(.1)},
        {"l1": 0.01, "l2": 0.02}),
    "average_accumulates": ("average_accumulates", lambda r: {
        "param": _draw(r, 1), "in_sum_1": _draw(r, 1),
        "in_sum_2": _draw(r, 1), "in_sum_3": _draw(r, 1),
        "in_num_accumulates": np.array([4], "int64"),
        "in_old_num_accumulates": np.array([3], "int64"),
        "in_num_updates": np.array([9], "int64")},
        {"average_window": 0.5, "min_average_window": 2,
         "max_average_window": 5}),
}

NEW_OPS = ("adamax", "adagrad", "decayed_adagrad", "adadelta", "rmsprop",
           "ftrl", "average_accumulates", "proximal_gd", "proximal_adagrad")


def _call_both(op_type, ins, attrs):
    """→ (the reference's outputs as numpy, the port's outputs, the
    port's input tensors)."""
    want = j_registry.call_op(
        j_registry.get_op_def(op_type), j_registry.LoweringContext(),
        {s: [jnp.asarray(v)] for s, v in ins.items()}, attrs)
    want = {s: [np.asarray(v) for v in vs] for s, vs in want.items()}
    t_ins = {s: [torch.from_numpy(v.copy())] for s, v in ins.items()}
    got = t_registry.call_op(t_registry.get_op_def(op_type),
                             t_registry.LoweringContext(), t_ins, attrs)
    return want, got, t_ins


def _assert_close(got, want, msg):
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype \
        or want.dtype == np.int32, (msg, got.dtype, want.dtype)
    if got.dtype.kind == "f":
        tol = F32_ULPS * np.spacing(np.abs(want).max().astype("float32"))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=msg)
    else:
        np.testing.assert_array_equal(got, want, err_msg=msg)


@pytest.mark.parametrize("case", sorted(_OP_CASES))
def test_update_op_matches_reference_and_writes_its_inputs(case):
    """Every output equals the reference's op on the same inputs (2
    float32 units in the last place; counters exactly) and is the input
    tensor the op is declared to write."""
    op_type, make, attrs = _OP_CASES[case]
    ins = make(np.random.RandomState(SEED))
    want, got, t_ins = _call_both(op_type, ins, attrs)
    tdef = t_registry.get_op_def(op_type)
    assert set(got) == set(want) == set(tdef.in_place)
    for out_slot, in_slot in tdef.in_place.items():
        assert got[out_slot][0] is t_ins[in_slot][0], out_slot
        _assert_close(got[out_slot][0], want[out_slot][0],
                      "%s %s" % (case, out_slot))


def test_new_ops_are_registered_in_place_and_capturable():
    """Each op writes every output into an input of its own (so a
    captured step copies nothing back), takes no gradient, and may be
    captured."""
    for op_type in NEW_OPS:
        tdef = t_registry.get_op_def(op_type)
        jdef = j_registry.get_op_def(op_type)
        assert tdef.input_slot_names == jdef.input_slot_names, op_type
        assert tdef.output_slot_names == jdef.output_slot_names, op_type
        assert tdef.no_grad and tdef.is_capturable({}, {}), op_type
        assert sorted(tdef.in_place) == sorted(tdef.output_slot_names)
        assert set(tdef.in_place.values()) <= set(tdef.input_slot_names)


def _accumulate_both(ins, attrs, calls):
    """``calls`` calls of ``average_accumulates``, each package feeding
    its outputs back → the (reference, port) outputs after every call."""
    jdef = j_registry.get_op_def("average_accumulates")
    tdef = t_registry.get_op_def("average_accumulates")
    j_state = {s: jnp.asarray(v) for s, v in ins.items()}
    t_state = {s: torch.from_numpy(v.copy()) for s, v in ins.items()}
    rows = []
    for _ in range(calls):
        w = j_registry.call_op(jdef, j_registry.LoweringContext(),
                               {s: [v] for s, v in j_state.items()}, attrs)
        g = t_registry.call_op(tdef, t_registry.LoweringContext(),
                               {s: [v] for s, v in t_state.items()}, attrs)
        for out_slot, in_slot in tdef.in_place.items():
            j_state[in_slot] = w[out_slot][0]
            assert g[out_slot][0] is t_state[in_slot]
        rows.append(({s: np.asarray(v[0]) for s, v in w.items()},
                     {s: v[0].clone() for s, v in g.items()}))
    return rows


def test_average_accumulates_across_a_fold_and_a_restart():
    """From ``num_updates`` 16380, with windows 2 to 3: the 16384th update
    folds ``sum_1`` into ``sum_2`` and the window restarts every few
    calls; every output after every call equals the reference's."""
    rng = np.random.RandomState(SEED)
    ins = {"param": _draw(rng, 1), "in_sum_1": _draw(rng, 1),
           "in_sum_2": _draw(rng, 1), "in_sum_3": np.zeros(_SHAPE, "float32"),
           "in_num_accumulates": np.array([0], "int64"),
           "in_old_num_accumulates": np.array([0], "int64"),
           "in_num_updates": np.array([16380], "int64")}
    attrs = {"average_window": 1.0, "min_average_window": 2,
             "max_average_window": 3}
    rows = _accumulate_both(ins, attrs, 7)
    restarts = folds = 0
    for i, (want, got) in enumerate(rows):
        for slot in want:
            _assert_close(got[slot], want[slot], "call %d %s" % (i, slot))
        restarts += int(got["out_num_accumulates"][0]) == 0
        folds += int(got["out_num_updates"][0]) % 16384 == 0
    assert folds == 1 and restarts >= 2, (folds, restarts)


# ---------------------------------------------------------------------------
# the optimizer classes on bert-tiny
# ---------------------------------------------------------------------------

@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")


def _cfg(bert):
    cfg = copy.copy(bert.BERT_TINY)
    cfg.dropout = cfg.attn_dropout = 0.0
    return cfg


def _program(fluid, bert, rule):
    with fluid.unique_name.guard():
        return chip_smoke.rule_program(fluid, bert, _cfg(bert), T, rule,
                                       lr=LR)


def _feed():
    return jbert.make_fake_batch(BATCH, T, jbert.BERT_TINY,
                                 np.random.RandomState(0))


def _steps(exe, main, loss, feed, steps, **kw):
    """``steps`` steps → (the losses, each parameter's gradient at every
    step)."""
    grads = chip_smoke.rule_grads(main)
    names = sorted(grads)
    losses, seen = [], {n: [] for n in names}
    for _ in range(steps):
        out = exe.run(main, feed=feed,
                      fetch_list=[loss] + [grads[n] for n in names], **kw)
        losses.append(float(np.asarray(out[0]).ravel()[0]))
        for n, g in zip(names, out[1:]):
            seen[n].append(np.asarray(g))
    return losses, seen


@functools.lru_cache(maxsize=None)
def _reference_run(rule, steps=STEPS):
    """→ (start persistables, losses, persistables after the steps, the
    gradients); one run a rule per process (the callers only read it)."""
    main, startup, loss = _program(jfluid, jbert, rule)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        start = convert.scope_persistables(main, scope)
        losses, grads = _steps(exe, main, loss, _feed(), steps)
        return start, losses, convert.scope_persistables(main, scope), grads


def _port_run(rule, start, cached=True, steps=STEPS):
    """→ (losses, persistables after the steps, the program, the
    executor, the gradients) from the reference's start."""
    main, startup, loss = _program(tfluid, tbert, rule)
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        convert.load_params_into_scope(start, scope, "cpu", program=main)
        losses, grads = _steps(exe, main, loss, _feed(), steps,
                               use_program_cache=cached)
        return (losses, convert.scope_persistables(main, scope), main, exe,
                grads)


def _accumulator_kind(name, param_names):
    """``<param>_<type>_<kind>_<n>`` → kind (the accumulators of one kind
    share a scale)."""
    for p in sorted(param_names, key=len, reverse=True):
        if name.startswith(p + "_"):
            return re.sub(r"_\d+$", "", name[len(p) + 1:])
    return name


@pytest.mark.parametrize("rule", chip_smoke.RULES)
def test_rule_trains_like_the_reference(rule, interpret):
    """3 steps of bert-tiny from one start in both packages: the losses,
    every parameter and every accumulator within the stated bounds; the
    same persistables; and the parameters' bounds would fail the port's
    update dropped or reversed."""
    start, want_losses, want, want_grads = _reference_run(rule)
    got_losses, got, main, _exe, got_grads = _port_run(rule, start)
    np.testing.assert_allclose(got_losses, want_losses, rtol=LOSS_RTOL)
    assert sorted(got) == sorted(want)
    params = {p.name for p in main.all_parameters()}
    model_scale = max(float(np.abs(start[n]).max()) for n in params)
    scale = {}
    for name, w in want.items():
        if name not in params:
            kind = _accumulator_kind(name, params)
            scale[kind] = max(scale.get(kind, 0.0),
                              float(np.abs(w).max()))
    caught = {"dropped": False, "reversed": False}
    for name, w in want.items():
        w = w.astype("float64")
        err = np.abs(got[name].astype("float64") - w)
        if name in params:
            assert not np.array_equal(got[name], start[name]), name
            bound = chip_smoke.rule_parity_tol(
                rule, LR, start[name], got_grads[name], want_grads[name],
                PARAM_RTOL * model_scale)
            # the same bound fails the port's update dropped or reversed
            p0 = start[name].astype("float64")
            caught["dropped"] |= bool(np.any(np.abs(p0 - w) > bound))
            caught["reversed"] |= bool(np.any(
                np.abs(2 * p0 - got[name] - w) > bound))
        else:
            bound = ACC_RTOL * scale[_accumulator_kind(name, params)]
        assert np.all(err <= bound), (rule, name, float(err.max()),
                                      float(np.max(err / bound)))
    assert all(caught.values()), (rule, caught)


@pytest.mark.parametrize("rule", chip_smoke.RULES)
def test_rule_compiled_step_equals_eager_and_names_its_copy_backs(
        rule, private_autotune):
    """The port's cached steps (a capture on the CPU, then replays)
    equal its eager steps bit for bit.  No update op's state is copied
    back: only Adamax's ``scale`` of each ``Beta1Pow`` and decoupled
    weight decay's ``assign`` of each parameter are, one a parameter."""
    main, startup, _ = _program(tfluid, tbert, rule)
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        tfluid.Executor(tfluid.CPUPlace()).run(startup)
        start = convert.scope_persistables(main, scope)
    eager_losses, eager, _, _, _ = _port_run(rule, start, cached=False)
    losses, state, main, exe, _ = _port_run(rule, start, cached=True)
    assert exe.last_run_mode == "graph"
    assert losses == eager_losses
    for name in state:
        np.testing.assert_array_equal(state[name], eager[name], name)
    n = len(main.all_parameters())
    want = {"adamax": {"scale": n}, "adamw": {"assign": n}}.get(rule, {})
    assert chip_smoke.copy_back_writers(exe) == want


def test_adamax_beta1_pow_after_three_steps(interpret):
    """Adamax advances each ``Beta1Pow`` by its ``scale`` op after the
    update: 0.9^4 after 3 steps, the reference's float32 value exactly."""
    start, _, want, _ = _reference_run("adamax")
    _, got, main, _, _ = _port_run("adamax", start)
    pows = [n for n in got if "_adamax_beta1_pow_acc" in n]
    assert len(pows) == len(main.all_parameters())
    expect = np.float32(0.9)
    for _ in range(STEPS):
        expect = np.float32(expect * np.float32(0.9))
    for n in pows:
        np.testing.assert_array_equal(got[n], want[n], n)
        assert got[n].dtype == np.float32 and got[n][0] == expect, n


def _tiny_program(fluid, make_opt):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[6], dtype="float32")
        h = fluid.layers.fc(x, size=5, act="relu",
                            param_attr=fluid.ParamAttr(name="w1"),
                            bias_attr=fluid.ParamAttr(name="b1"))
        y = fluid.layers.fc(h, size=3, param_attr=fluid.ParamAttr(name="w2"),
                            bias_attr=False)
        loss = fluid.layers.mean(y)
        opt = make_opt(fluid)
        opt.minimize(loss)
    return main, startup, loss, opt


def _tiny_steps(fluid, main, startup, loss, start=None, steps=3):
    """``steps`` steps from the startup's values, or from ``start`` (a
    persistables dict) → (the start, the parameters after the steps)."""
    rng = np.random.RandomState(4)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        if start is None:
            start = convert.scope_persistables(main, scope)
        else:
            convert.load_params_into_scope(start, scope, "cpu", program=main)
        for _ in range(steps):
            exe.run(main, feed={"x": rng.randn(4, 6).astype("float32")},
                    fetch_list=[loss])
        return start, {n: np.asarray(scope.get(n)).copy()
                       for n in ("w1", "b1", "w2")}


def test_dgc_momentum_warns_and_updates_as_momentum():
    """DGCMomentum warns, giving the port's reason, and its program and
    steps are Momentum's bit for bit (the same ``momentum`` ops)."""
    with pytest.warns(UserWarning, match="plain momentum") as rec:
        dgc = _tiny_program(tfluid, lambda f: f.optimizer.DGCMomentumOptimizer(
            0.1, momentum=0.9, sparsity=[0.999]))
    text = str(rec[0].message)
    assert "one card" in text.lower() or "One card" in text
    assert "Queue A" in text and "TPU" not in text and "ICI" not in text
    mom = _tiny_program(tfluid, lambda f: f.optimizer.Momentum(
        0.1, momentum=0.9))
    assert [op.type for op in dgc[0].global_block().ops] \
        == [op.type for op in mom[0].global_block().ops]
    assert isinstance(dgc[3], tfluid.optimizer.MomentumOptimizer)
    start, want = _tiny_steps(tfluid, *mom[:3])
    got = _tiny_steps(tfluid, *dgc[:3], start=start)[1]
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], n)


def _normalized(record):
    """``_pipeline_opt`` with its Variables named."""
    def name(v):
        if isinstance(v, (list, tuple)):
            return [name(x) for x in v]
        return getattr(v, "name", v)
    out = dict(record)
    out["cut_list"] = name(record["cut_list"])
    return out


@pytest.mark.parametrize("cuts", [None, "one"])
def test_pipeline_optimizer_records_the_reference_config(cuts):
    """``minimize`` delegates to the inner optimizer (the same ops as the
    inner one alone) and leaves the reference's ``_pipeline_opt`` on the
    program."""
    records, types = [], []
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[6], dtype="float32")
            h = fluid.layers.fc(x, size=5, act="relu")
            loss = fluid.layers.mean(fluid.layers.fc(h, size=3))
            opt = fluid.optimizer.PipelineOptimizer(
                fluid.optimizer.SGD(0.1),
                cut_list=None if cuts is None else [[h]],
                place_list=["a", "b"], concurrency_list=[1, 1],
                queue_size=4, sync_steps=2)
            opt.minimize(loss)
        records.append(_normalized(main._pipeline_opt))
        types.append([op.type for op in main.global_block().ops])
    assert records[0] == records[1]
    assert types[0] == types[1]
    assert records[1]["num_microbatches"] == (1 if cuts is None else 2)


def _decay_program(fluid, coeff=0.01, fun=None):
    import importlib

    ext = importlib.import_module(fluid.__name__
                                  + ".contrib.extend_optimizer")
    adamw = ext.extend_with_decoupled_weight_decay(fluid.optimizer.Adam)
    return _tiny_program(fluid, lambda f: adamw(
        weight_decay=coeff, apply_decay_param_fun=fun, learning_rate=0.01))


@pytest.mark.parametrize("fun", [None, "only_w"])
def test_decoupled_weight_decay_ops_and_steps_match_the_reference(fun):
    """The decay ops (``scale``, ``elementwise_sub``, ``assign`` a
    decayed parameter) come before the updates, as the reference's; the
    filter leaves the other parameters undecayed; 3 steps give the
    reference's parameters (2 float32 units of each update)."""
    pick = None if fun is None else (lambda n: n.startswith("w"))
    progs = {f.__name__: _decay_program(f, fun=pick)
             for f in (jfluid, tfluid)}
    jtypes, ttypes = ([op.type for op in p[0].global_block().ops]
                      for p in progs.values())
    assert ttypes == jtypes
    decayed = 2 if pick else 3
    assert ttypes.count("assign") == decayed
    assert max(i for i, t in enumerate(ttypes) if t == "assign") \
        < min(i for i, t in enumerate(ttypes) if t == "adam")
    assert str(progs["paddle_tpu_torch"][3]) == str(progs["paddle_tpu"][3])
    start, want = _tiny_steps(jfluid, *progs["paddle_tpu"][:3])
    got = _tiny_steps(tfluid, *progs["paddle_tpu_torch"][:3],
                      start=start)[1]
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=0,
                                   atol=1e-6, err_msg=n)


def test_decoupled_weight_decay_refuses_what_the_reference_refuses():
    """A non-Optimizer base and a non-number coefficient raise; a zero
    coefficient adds no op; a parameter decays once per optimizer."""
    from paddle_tpu_torch.contrib import extend_optimizer as ext

    with pytest.raises(TypeError, match="Optimizer subclass"):
        ext.extend_with_decoupled_weight_decay(object)
    adamw = ext.extend_with_decoupled_weight_decay(tfluid.optimizer.Adam)
    with pytest.raises(TypeError, match="float or Variable"):
        adamw(weight_decay="0.1", learning_rate=0.01)
    main = _decay_program(tfluid, coeff=0.0)[0]
    assert "assign" not in [op.type for op in main.global_block().ops]
    opt = adamw(weight_decay=0.1, learning_rate=0.01)
    params_grads = [(main.global_block().var("w1"), object())]
    with tfluid.program_guard(main):
        opt._append_decay_ops(params_grads)
        with pytest.raises(RuntimeError, match="already decayed"):
            opt._append_decay_ops(params_grads)


def test_aliases_and_names_are_the_reference_ones():
    """Every name of the reference's ``optimizer.__all__`` is in the
    port's, each short alias is its class, and no name raises."""
    import paddle_tpu.optimizer as jopt

    topt = tfluid.optimizer
    assert sorted(topt.__all__) == sorted(jopt.__all__)
    for short, cls in (("SGD", "SGDOptimizer"), ("Momentum",
                                                 "MomentumOptimizer"),
                       ("Adagrad", "AdagradOptimizer"),
                       ("DecayedAdagrad", "DecayedAdagradOptimizer"),
                       ("Adam", "AdamOptimizer"), ("Adamax",
                                                   "AdamaxOptimizer"),
                       ("Adadelta", "AdadeltaOptimizer"),
                       ("RMSProp", "RMSPropOptimizer"),
                       ("Ftrl", "FtrlOptimizer"), ("Lamb", "LambOptimizer"),
                       ("LarsMomentum", "LarsMomentumOptimizer")):
        assert getattr(topt, short) is getattr(topt, cls)
        assert getattr(topt, cls).__name__ == getattr(jopt, cls).__name__
    for name in jopt.__all__:
        assert hasattr(topt, name), name


def test_adagrad_initial_accumulator_value_fills_the_moment(interpret):
    """``initial_accumulator_value`` is the moment's start in both
    packages, and one step from it matches the reference."""
    for fluid in (jfluid, tfluid):
        main, startup, loss, _ = _tiny_program(
            fluid, lambda f: f.optimizer.Adagrad(
                0.1, initial_accumulator_value=0.25))
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            fluid.Executor(fluid.CPUPlace()).run(startup)
            moments = [v.name for v in main.list_vars()
                       if "_adagrad_moment" in v.name]
            assert len(moments) == 3
            for n in moments:
                assert np.all(np.asarray(scope.get(n)) == 0.25), n
    start, want = _tiny_steps(jfluid, *_tiny_program(
        jfluid, lambda f: f.optimizer.Adagrad(
            0.1, initial_accumulator_value=0.25))[:3])
    got = _tiny_steps(tfluid, *_tiny_program(
        tfluid, lambda f: f.optimizer.Adagrad(
            0.1, initial_accumulator_value=0.25))[:3], start=start)[1]
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=0, atol=1e-6,
                                   err_msg=n)


def test_weighted_average_matches_the_reference():
    """The host-side ``WeightedAverage``: the same means and the same
    refusals."""
    from paddle_tpu import average as javg
    from paddle_tpu_torch import average as tavg

    outs = []
    for mod in (javg, tavg):
        avg = mod.WeightedAverage()
        with pytest.raises(ValueError, match="no data"):
            avg.eval()
        avg.add(2.0, 1)
        avg.add(np.array([1.0, 3.0, 5.0]), 3)
        avg.add([4, 6], 2.5)
        with pytest.raises(ValueError, match="value"):
            avg.add("x", 1)
        with pytest.raises(ValueError, match="weight"):
            avg.add(1.0, "1")
        outs.append(avg.eval())
        avg.reset()
        assert avg.numerator is None
    assert outs[0] == outs[1] == (2.0 + 9.0 + 12.5) / 6.5


def _rule_parity_tol_numpy(rule, lr, start, grads_a, grads_b, base):
    """``chip_smoke.rule_parity_tol`` as it was written in float64 numpy
    on the host: the reference the torch version is held to."""
    steps = len(grads_a)
    ga = np.stack(grads_a).astype("float64")
    gb = np.stack(grads_b).astype("float64")
    low = np.minimum(np.abs(ga), np.abs(gb))
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where((np.sign(ga) == np.sign(gb)) & (low > 0),
                       np.abs(ga - gb) / low, np.inf).max(axis=0)
    s = chip_smoke.RULE_SETTINGS[rule][1]
    if rule == "dgc_momentum":
        slack = lr * steps * sum(s["momentum"] ** k for k in range(steps)) \
            * np.abs(ga - gb).max(axis=0)
        return base + slack
    step = chip_smoke.rule_step_bound(rule, lr)
    slack = np.minimum(2.0, chip_smoke.PARITY_GRAD_K * rel) * steps * step
    if rule == "ftrl":
        p = np.abs(start.astype("float64"))
        l1 = s["l1"] + chip_smoke.FTRL_L_FLOOR
        l2 = s["l2"] + chip_smoke.FTRL_L_FLOOR
        with np.errstate(divide="ignore"):
            shift = sum(steps * (l1 + l2 * (p + steps * lr)) * lr
                        / np.abs(g[0]) for g in (ga, gb))
        slack = np.minimum(slack + shift, p + 2 * steps * lr)
    return base + slack


@pytest.mark.parametrize("rule", chip_smoke.RULES)
@pytest.mark.parametrize("steps", [1, 3])
def test_rule_parity_tol_in_torch_equals_the_numpy_version(rule, steps):
    """The bound ``phase_optimizers_parity`` computes with torch on the
    card is element for element the float64 numpy one, on seeded arrays
    with zeros, sign flips and near ties in the gradients, for numpy
    inputs (a numpy result) and for tensors (a tensor result)."""
    rng = np.random.RandomState(11 + steps)
    shape = (37, 19)
    start = rng.randn(*shape).astype("float32")
    grads_a = [rng.randn(*shape).astype("float32") for _ in range(steps)]
    grads_b = [(g * (1 + 1e-3 * rng.randn(*shape))).astype("float32")
               for g in grads_a]
    for g in grads_a + grads_b:
        g[rng.rand(*shape) < 0.05] = 0.0
    grads_b[0][rng.rand(*shape) < 0.05] *= -1
    base = 1e-6 * float(np.abs(start).max())
    want = _rule_parity_tol_numpy(rule, LR, start, grads_a, grads_b, base)
    got = chip_smoke.rule_parity_tol(rule, LR, start, grads_a, grads_b,
                                     base)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    got_t = chip_smoke.rule_parity_tol(
        rule, LR, torch.from_numpy(start), [torch.from_numpy(g)
                                            for g in grads_a],
        [torch.from_numpy(g) for g in grads_b], base)
    assert got_t.dtype == torch.float64
    np.testing.assert_array_equal(got_t.numpy(), want)
    assert np.isfinite(want).all() or rule == "ftrl"
