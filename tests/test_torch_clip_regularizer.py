"""Gradient clipping, weight decay, LAMB and LARS in the PyTorch port
against the reference package on the CPU.

A small fc program (two hidden layers, 8 rows) is built by the same
code in both packages, the port is loaded with the reference's starting
parameters (``paddle_tpu_torch.convert``) and both take 3 steps on the
same seeded batch: the programs have the same ops, and the losses and
the parameters after each run agree to float32 rounding through a few
layers and one update a step (rtol 1e-4, atol 1e-6).  The clip
attributes are also checked to do what they say (a clipped update is
smaller), and ``minimize(grad_clip=)`` to leave no clip registered.
"""

import collections

import numpy as np
import pytest

import paddle_tpu as jfluid

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert

STEPS = 3
RTOL, ATOL = 1e-4, 1e-6


def _program(fluid, make_opt, param_attr=None, minimize_kw=None,
             before=None):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[16], dtype="float32")
        y = fluid.layers.data("y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, size=32, act="relu",
                            param_attr=param_attr(fluid) if param_attr
                            else None)
        h = fluid.layers.fc(h, size=16, act="relu")
        p = fluid.layers.fc(h, size=1)
        err = fluid.layers.elementwise_sub(p, y)
        loss = fluid.layers.mean(fluid.layers.elementwise_mul(err, err))
        if before is not None:
            before(fluid, main)
        make_opt(fluid).minimize(
            loss, **(minimize_kw(fluid) if minimize_kw else {}))
    return main, startup, loss


def _feed():
    rng = np.random.RandomState(7)
    x = rng.randn(8, 16).astype("float32") * 3.0
    return {"x": x, "y": (x.sum(1, keepdims=True) > 0).astype("float32")}


def _train_both(make_opt, **kw):
    """3 steps in each package from the reference's start → (reference
    losses, port losses, reference state, port state, port program)."""
    jmain, jstart, jloss = _program(jfluid, make_opt, **kw)
    tmain, tstart, tloss = _program(tfluid, make_opt, **kw)
    assert collections.Counter(o.type for o in tmain.global_block().ops) \
        == collections.Counter(o.type for o in jmain.global_block().ops)
    feed = _feed()
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
        start = convert.scope_persistables(jmain, jscope)
        want = [float(np.asarray(jexe.run(jmain, feed=feed,
                                          fetch_list=[jloss])[0])[0])
                for _ in range(STEPS)]
        jstate = convert.scope_persistables(jmain, jscope)
    tscope = tfluid.Scope()
    with tfluid.scope_guard(tscope):
        texe = tfluid.Executor(tfluid.CPUPlace())
        texe.run(tstart)
        convert.load_params_into_scope(start, tscope, "cpu", program=tmain)
        got = [float(texe.run(tmain, feed=feed, fetch_list=[tloss])[0][0])
               for _ in range(STEPS)]
        tstate = convert.scope_persistables(tmain, tscope)
    return want, got, jstate, tstate, tmain


def _assert_same(want, got, jstate, tstate):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert sorted(tstate) == sorted(jstate)
    for name in jstate:
        np.testing.assert_allclose(tstate[name], jstate[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)


CLIPS = {
    "value": lambda fluid: fluid.clip.GradientClipByValue(0.05),
    "value_min_max": lambda fluid: fluid.clip.GradientClipByValue(
        0.1, min=-0.02),
    "norm": lambda fluid: fluid.clip.GradientClipByNorm(0.1),
    "global_norm": lambda fluid: fluid.clip.GradientClipByGlobalNorm(0.2),
}


@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_set_gradient_clip_trains_as_the_reference(clip):
    def before(fluid, main):
        fluid.clip.set_gradient_clip(CLIPS[clip](fluid), program=main)

    want, got, jstate, tstate, tmain = _train_both(
        lambda fluid: fluid.optimizer.SGD(learning_rate=0.1),
        before=before)
    _assert_same(want, got, jstate, tstate)
    op = {"value": "clip", "value_min_max": "clip", "norm": "clip_by_norm",
          "global_norm": "squared_l2_norm"}[clip]
    assert op in [o.type for o in tmain.global_block().ops]


@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_per_parameter_clip_attr_trains_as_the_reference(clip):
    def attr(fluid):
        return fluid.ParamAttr(gradient_clip=CLIPS[clip](fluid))

    _assert_same(*_train_both(
        lambda fluid: fluid.optimizer.SGD(learning_rate=0.1),
        param_attr=attr)[:4])


@pytest.mark.parametrize("clip", ["norm", "global_norm"])
def test_minimize_grad_clip_clips_and_does_not_leak(clip):
    """``minimize(grad_clip=)`` (``tests/test_contrib_tail.py:187``): the
    clipped update is much smaller, it matches the reference's, and no
    clip stays registered for the program."""
    big = {"x": np.full((8, 16), 10.0, "float32"),
           "y": np.zeros((8, 1), "float32")}
    deltas = {}
    for with_clip in (False, True):
        main, startup, loss = _program(
            tfluid, lambda fluid: fluid.optimizer.SGD(learning_rate=1.0),
            minimize_kw=lambda fluid: {"grad_clip": CLIPS[clip](fluid)
                                       if with_clip else None})
        scope = tfluid.Scope()
        with tfluid.scope_guard(scope):
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup)
            w0 = scope.get("fc_0.w_0").numpy().copy()
            exe.run(main, feed=big, fetch_list=[])
            deltas[with_clip] = float(np.abs(
                scope.get("fc_0.w_0").numpy() - w0).max())
        assert id(main) not in tfluid.clip._clip_attr
    assert deltas[True] < 0.1 * deltas[False], deltas


@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_minimize_grad_clip_matches_reference(clip):
    _assert_same(*_train_both(
        lambda fluid: fluid.optimizer.SGD(learning_rate=0.1),
        minimize_kw=lambda fluid: {"grad_clip": CLIPS[clip](fluid)})[:4])


REGS = {
    "l2_optimizer": (lambda fluid: fluid.regularizer.L2Decay(0.05), None),
    "l1_optimizer": (lambda fluid: fluid.regularizer.L1Decay(0.01), None),
    "l2_param": (None, lambda fluid: fluid.regularizer.L2Decay(0.1)),
    "l1_param_over_l2_optimizer": (
        lambda fluid: fluid.regularizer.L2Decay(0.05),
        lambda fluid: fluid.regularizer.L1Decay(0.02)),
}


@pytest.mark.parametrize("reg", sorted(REGS))
def test_weight_decay_trains_as_the_reference(reg):
    """L1Decay / L2Decay optimizer-wide and per ``ParamAttr``
    (``tests/test_backward_optimizer.py:191``); a parameter's own
    regularizer wins over the optimizer's."""
    opt_reg, param_reg = REGS[reg]

    def make(fluid):
        return fluid.optimizer.SGD(
            learning_rate=0.1,
            regularization=opt_reg(fluid) if opt_reg else None)

    def attr(fluid):
        return fluid.ParamAttr(regularizer=param_reg(fluid))

    want, got, jstate, tstate, tmain = _train_both(
        make, param_attr=attr if param_reg else None)
    _assert_same(want, got, jstate, tstate)
    types = [o.type for o in tmain.global_block().ops]
    assert types.count("sum") >= (6 if opt_reg else 1)
    if reg.startswith("l1"):
        assert "sign" in types


def test_weight_decay_with_global_norm_clip_order():
    """clip → regularize → update, as the reference orders them: the
    decay term is added to the clipped gradient."""
    def before(fluid, main):
        fluid.clip.set_gradient_clip(CLIPS["global_norm"](fluid),
                                     program=main)

    want, got, jstate, tstate, tmain = _train_both(
        lambda fluid: fluid.optimizer.SGD(
            learning_rate=0.1,
            regularization=fluid.regularizer.L2Decay(0.05)),
        before=before)
    _assert_same(want, got, jstate, tstate)
    types = [o.type for o in tmain.global_block().ops]
    assert types.index("squared_l2_norm") < types.index("scale") \
        < types.index("sgd")


OPTIMIZERS = {
    "lamb": lambda fluid: fluid.optimizer.LambOptimizer(learning_rate=0.05),
    "lamb_decay": lambda fluid: fluid.optimizer.Lamb(
        learning_rate=0.02, lamb_weight_decay=0.1, beta1=0.8, epsilon=1e-5),
    "lars": lambda fluid: fluid.optimizer.LarsMomentumOptimizer(
        learning_rate=0.1, momentum=0.9),
    "lars_decay": lambda fluid: fluid.optimizer.LarsMomentum(
        learning_rate=0.2, momentum=0.5, lars_coeff=0.01,
        lars_weight_decay=0.01),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_lamb_and_lars_three_steps_match_reference(name):
    """3 steps (``tests/test_backward_optimizer.py:130``): losses,
    parameters and every accumulator (moments, beta powers, velocity)."""
    want, got, jstate, tstate, tmain = _train_both(OPTIMIZERS[name])
    _assert_same(want, got, jstate, tstate)
    assert got[-1] < got[0]
    op = "lamb" if name.startswith("lamb") else "lars_momentum"
    assert [o.type for o in tmain.global_block().ops].count(op) == 6


@pytest.mark.parametrize("name", ["lamb", "lars"])
def test_lamb_and_lars_write_their_state_in_place(name):
    """The update ops write the resident parameter and accumulators: the
    compiled step copies nothing back."""
    main, startup, loss = _program(tfluid, OPTIMIZERS[name])
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        w = scope.get("fc_0.w_0")
        for _ in range(3):
            exe.run(main, feed=_feed(), fetch_list=[loss])
        assert exe.last_run_mode == "graph"
        assert scope.get("fc_0.w_0") is w
        assert not any(e.copy_backs for e in exe._cache.values())


@pytest.mark.parametrize("name", ["lamb", "lars"])
def test_convert_carries_the_state_mid_schedule(name):
    """``convert`` moves LAMB's moments and beta powers, LARS's velocity
    and the schedule's step counter: the port resumes from the
    reference's state after 2 steps and takes the next 2 as the
    reference does."""
    def make(fluid):
        lr = fluid.layers.exponential_decay(0.05, 2, 0.5)
        if name == "lamb":
            return fluid.optimizer.LambOptimizer(learning_rate=lr)
        return fluid.optimizer.LarsMomentumOptimizer(learning_rate=lr,
                                                     momentum=0.9)

    jmain, jstart, jloss = _program(jfluid, make)
    tmain, tstart, tloss = _program(tfluid, make)
    feed = _feed()
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
        for _ in range(2):
            jexe.run(jmain, feed=feed, fetch_list=[jloss])
        mid = convert.scope_persistables(jmain, jscope)
        want = [float(np.asarray(jexe.run(jmain, feed=feed,
                                          fetch_list=[jloss])[0])[0])
                for _ in range(2)]
        jstate = convert.scope_persistables(jmain, jscope)
    assert mid["@LR_DECAY_COUNTER@"][0] == 2.0
    acc = [n for n in mid if "_moment1_" in n or "_velocity_" in n]
    assert acc and all(np.abs(mid[n]).max() > 0 for n in acc)
    tscope = tfluid.Scope()
    with tfluid.scope_guard(tscope):
        texe = tfluid.Executor(tfluid.CPUPlace())
        texe.run(tstart)
        convert.load_params_into_scope(mid, tscope, "cpu", program=tmain)
        got = [float(texe.run(tmain, feed=feed, fetch_list=[tloss])[0][0])
               for _ in range(2)]
        tstate = convert.scope_persistables(tmain, tscope)
    _assert_same(want, got, jstate, tstate)
