"""The reference's flagship training program, built by one function in
both packages (``chip_smoke.recipe_program``): BERT MLM pretraining with
``fused_ln`` and ``fused_qkv``, bf16 AMP through ``decorate``, LAMB with
weight decay 0.01, ``linear_lr_warmup(polynomial_decay(...))`` and the
gradients clipped to a global norm of 1.

At 2 layers, hidden 128, T=32 the two packages build the same program and
take the same 3 steps from the reference's start on the CPU (the
reference runs its Pallas kernels in interpret mode): the learning rate
of each step exactly (a bf16 value in both: the AMP rewrite retypes the
schedule's white-listed ``scale`` and ``elementwise_*`` ops, so the rate
is the schedule's to one bf16 unit), the losses to one bf16 unit (the loss is a float32
mean of bf16-rounded logits' cross entropy; the packages round their bf16
intermediates in different places, ``tests/test_torch_amp.py``), and the
parameters and LAMB's state after the steps to the bounds stated below.  The port's eager and compiled steps agree bit for bit over 12
steps, and the schedule moves in both.
"""

import collections
import copy

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.models import bert as jbert

import chip_smoke
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import bert as tbert

T = 32
BATCH = 2
STEPS = 3
BF16_ULP = 2.0 ** -7
LOSS_RTOL = BF16_ULP
# LAMB moves a tensor by lr * |param| a step (its trust ratio), and a
# tensor at 0 (the biases, the LN shifts) by up to lr an element (ratio
# 1, |m1_hat / sqrt(m2_hat)| <= ~1); two packages whose bf16 rounding
# differs can move it that much in opposite directions.  Over the 3
# warm-up steps (rates 1e-5, 2e-5, 3e-5): measured 2.6e-5 at most, on
# the zero-start tensors
PARAM_RTOL = PARAM_ATOL = 2 * (1e-5 + 2e-5 + 3e-5)
# LAMB's moments hold the float32 master gradients, which the packages
# reach through bf16 casts rounded in other places: max |diff| over
# max |ref| measured up to 1.6e-2 for the first moment, 2.6e-2 for the
# second (it squares the gradient)
M1_RTOL = 3 * BF16_ULP
M2_RTOL = 6 * BF16_ULP


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")


def _cfg(bert):
    cfg = copy.copy(bert.BERT_TINY)
    cfg.fused_ln = True
    cfg.fused_qkv = True
    cfg.fuse_attn = True
    cfg.dropout = cfg.attn_dropout = 0.0
    return cfg


def _recipe(fluid, bert):
    with fluid.unique_name.guard():
        return chip_smoke.recipe_program(fluid, bert, _cfg(bert), T)


def _feed():
    return jbert.make_fake_batch(BATCH, T, jbert.BERT_TINY,
                                 np.random.RandomState(0))


def _types(program):
    return collections.Counter(op.type for op in program.global_block().ops)


def test_recipe_builds_the_reference_program():
    jmain, _, _, _ = _recipe(jfluid, jbert)
    tmain, _, _, _ = _recipe(tfluid, tbert)
    assert _types(tmain) == _types(jmain)
    types = _types(tmain)
    assert types["lamb"] == len(tmain.all_parameters())
    assert types["squared_l2_norm"] == len(tmain.all_parameters())
    assert types["slice"] == 3 * 2 and types["fused_dropout_add_ln"] == 4
    assert tmain.global_block().ops[0].type == "increment"
    assert sorted(v.name for v in tmain.list_vars() if v.persistable) == \
        sorted(v.name for v in jmain.list_vars() if v.persistable)


def test_recipe_trains_as_the_reference(interpret):
    jmain, jstart, jloss, jlr = _recipe(jfluid, jbert)
    tmain, tstart, tloss, tlr = _recipe(tfluid, tbert)
    feed = _feed()
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
        start = convert.scope_persistables(jmain, jscope)
        want = [[float(np.asarray(v).ravel()[0]) for v in jexe.run(
            jmain, feed=feed, fetch_list=[jloss, jlr])]
            for _ in range(STEPS)]
        jstate = convert.scope_persistables(jmain, jscope)
    tscope = tfluid.Scope()
    with tfluid.scope_guard(tscope):
        texe = tfluid.Executor(tfluid.CPUPlace())
        texe.run(tstart)
        convert.load_params_into_scope(start, tscope, "cpu", program=tmain)
        got = [[float(v[0]) for v in texe.run(tmain, feed=feed,
                                              fetch_list=[tloss, tlr])]
               for _ in range(STEPS)]
        tstate = convert.scope_persistables(tmain, tscope)
    assert [g[1] for g in got] == [w[1] for w in want]
    np.testing.assert_allclose([g[1] for g in got], [1e-5, 2e-5, 3e-5],
                               rtol=BF16_ULP)
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=LOSS_RTOL)
    assert sorted(tstate) == sorted(jstate)
    assert float(tstate["@LR_DECAY_COUNTER@"][0]) == STEPS
    params = {p.name for p in tmain.all_parameters()}
    for name, w in jstate.items():
        g = tstate[name]
        err = float(np.abs(g.astype("float64") - w).max())
        if name in params:
            assert not np.array_equal(g, start[name]), name
            bound = PARAM_RTOL * float(np.abs(start[name]).max()) \
                + PARAM_ATOL
        elif "_lamb_moment" in name:
            bound = float(np.abs(w).max()) * (
                M1_RTOL if "_moment1" in name else M2_RTOL)
        else:  # the beta powers and the step counter
            bound = 0.0
        assert err <= bound, (name, err, bound)


def test_recipe_compiled_step_equals_eager_over_12_steps():
    """12 steps in the port, uncached (eager) and cached (a capture, then
    replays): losses and learning rates bit for bit, the schedule warming
    up over 10 steps and then decaying (in bf16 steps: 1e-7 a step is
    below one bf16 unit of 1e-4), no state copied back."""
    feed = _feed()
    out = {}
    for cached in (False, True):
        main, startup, loss, lr = _recipe(tfluid, tbert)
        scope = tfluid.Scope()
        with tfluid.scope_guard(scope):
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup)
            out[cached] = [[float(v[0]) for v in exe.run(
                main, feed=feed, fetch_list=[loss, lr],
                use_program_cache=cached)] for _ in range(12)]
            if cached:
                assert exe.last_run_mode == "graph"
                assert not any(e.copy_backs for e in exe._cache.values())
    assert out[True] == out[False]
    lrs = [r[1] for r in out[True]]
    want = [1e-4 * s / 10 if s < 10 else 1e-4 * (1 - s / 1000)
            for s in range(1, 13)]
    np.testing.assert_allclose(lrs, want, rtol=BF16_ULP)
    assert lrs.index(max(lrs)) == 9 and lrs[9:] == sorted(lrs[9:],
                                                           reverse=True)
