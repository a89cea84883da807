"""The layers the training recipes build, ported to PyTorch, against the
reference package on the CPU: the unary math ops (``sqrt``, ``floor``,
``ceil``, ``exp``, ``cos``, ``sign``, ``pow``), ``elementwise_min`` /
``max`` / ``pow``, the comparisons and ``where``, ``slice``, ``clip``,
``clip_by_norm`` and ``squared_l2_norm``, the Variable operator
overloads, and the eight learning-rate schedules over 12 steps on the
global step counter.

The same seeded numpy inputs go through a one-layer program in each
package; forward values match to float32 rounding (rtol 1e-5), and the
gradients ``gradients`` builds to rtol 1e-4.  The schedules are float32
arithmetic on a [1] counter: rtol 1e-6.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid

import paddle_tpu_torch as tfluid

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4
LR_RTOL = 1e-6
STEPS = 12


def _reference_run(fluid, main, startup, feed, fetch, steps=1):
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        return [[np.asarray(v) for v in exe.run(main, feed=feed,
                                                fetch_list=fetch)]
                for _ in range(steps)]


def _both(build, feed, steps=1):
    """``build(fluid) → (fetch vars, op types)`` in a fresh program of
    each package; → (reference fetches, port fetches) per step."""
    out = {}
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            fetch = build(fluid)
        out[fluid] = (main, [v.name for v in fetch],
                      _reference_run(fluid, main, startup, feed, fetch,
                                     steps))
    (jmain, jnames, want), (tmain, tnames, got) = out[jfluid], out[tfluid]
    assert tnames == jnames
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    return want, got


def _x(fluid, shape=(3, 4)):
    x = fluid.layers.data("x", shape=list(shape[1:]), dtype="float32")
    x.stop_gradient = False
    return x


def _feed(shape=(3, 4), positive=False, seed=0):
    x = np.random.RandomState(seed).randn(*shape).astype("float32")
    return {"x": np.abs(x) + 0.5 if positive else x * 2.0}


def _grad_of(fluid, x, y):
    loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(y, y))
    (gx,) = fluid.gradients([loss], [x])
    return [y, gx]


UNARY = {
    "sqrt": True, "exp": False, "cos": False, "floor": False, "ceil": False,
    "sign": False,
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_op_and_grad_match_reference(name):
    def build(fluid):
        x = _x(fluid)
        return _grad_of(fluid, x, getattr(fluid.layers, name)(x))

    want, got = _both(build, _feed(positive=UNARY[name]))
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=1e-6)


@pytest.mark.parametrize("factor", [-0.5, 2.0, 3.0])
def test_pow_and_grad_match_reference(factor):
    def build(fluid):
        x = _x(fluid)
        return _grad_of(fluid, x, fluid.layers.pow(x, factor))

    want, got = _both(build, _feed(positive=True))
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL)


@pytest.mark.parametrize("op", ["elementwise_min", "elementwise_max",
                                "elementwise_pow"])
def test_binary_elementwise_and_grads_match_reference(op):
    def build(fluid):
        x = _x(fluid)
        y = fluid.layers.data("y", shape=[4], dtype="float32")
        y.stop_gradient = False
        out = getattr(fluid.layers, op)(x, y)
        loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(out,
                                                                    out))
        return [out] + list(fluid.gradients([loss], [x, y]))

    rng = np.random.RandomState(1)
    feed = {"x": np.abs(rng.randn(3, 4)).astype("float32") + 0.5,
            "y": rng.randn(3, 4).astype("float32")}
    want, got = _both(build, feed)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=1e-6)


@pytest.mark.parametrize("op", ["less_than", "less_equal", "greater_than",
                                "greater_equal", "equal", "not_equal"])
def test_comparison_matches_reference(op):
    def build(fluid):
        x = _x(fluid)
        y = fluid.layers.data("y", shape=[4], dtype="float32")
        return [getattr(fluid.layers, op)(x, y)]

    rng = np.random.RandomState(2)
    x = rng.randint(-2, 3, (3, 4)).astype("float32")
    feed = {"x": x, "y": rng.randint(-2, 3, (3, 4)).astype("float32")}
    want, got = _both(build, feed)
    assert got[0][0].dtype == np.bool_
    np.testing.assert_array_equal(got[0][0], want[0][0])


def test_where_and_its_grads_match_reference():
    def build(fluid):
        x = _x(fluid)
        y = fluid.layers.data("y", shape=[4], dtype="float32")
        y.stop_gradient = False
        out = fluid.layers.where(fluid.layers.less_than(x, y), x, y)
        loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(out,
                                                                    out))
        return [out] + list(fluid.gradients([loss], [x, y]))

    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(3, 4).astype("float32"),
            "y": rng.randn(3, 4).astype("float32")}
    want, got = _both(build, feed)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL)


@pytest.mark.parametrize("axes,starts,ends", [
    ([2], [0], [8]), ([2], [8], [16]), ([2], [16], [24]),
    ([1, 2], [1, 4], [3, 100]), ([2], [-8], [-2])])
def test_slice_and_its_grad_match_reference(axes, starts, ends):
    def build(fluid):
        x = _x(fluid, (2, 3, 24))
        y = fluid.layers.slice(x, axes, starts, ends)
        return _grad_of(fluid, x, fluid.layers.reshape(
            fluid.layers.transpose(y, [0, 2, 1]), [0, -1]))

    want, got = _both(build, _feed((2, 3, 24)))
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL)


@pytest.mark.parametrize("layer", ["clip", "clip_by_norm_over",
                                   "clip_by_norm_under"])
def test_clip_layers_and_grads_match_reference(layer):
    def build(fluid):
        x = _x(fluid)
        if layer == "clip":
            y = fluid.layers.clip(x, -0.5, 1.0)
        else:
            y = fluid.layers.clip_by_norm(
                x, 1.0 if layer.endswith("over") else 100.0)
        return _grad_of(fluid, x, y)

    want, got = _both(build, _feed())
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=1e-7)


def test_squared_l2_norm_matches_reference():
    def build(fluid):
        x = _x(fluid)
        block = fluid.default_main_program().global_block()
        out = block.create_var(name="sq", shape=[1], dtype="float32")
        block.append_op(type="squared_l2_norm", inputs={"X": [x]},
                        outputs={"Out": [out]})
        return [out]

    want, got = _both(build, _feed())
    assert got[0][0].shape == (1,)
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=FWD_RTOL)


def test_variable_operators_build_the_reference_ops():
    """``+ - * / ** < <= > >= -`` with Variables and scalars on either
    side: the same op list (scalar shortcuts to one ``scale``) and the
    same values."""
    def build(fluid):
        x = _x(fluid)
        y = fluid.layers.data("y", shape=[4], dtype="float32")
        outs = [x + 2.0, 3.0 + x, x - y, 1.5 - x, x * 0.5, 2.0 * x, x * y,
                x / 4.0, 2.0 / y, x / y, x ** y, -x, x < y, x <= 0.0,
                x > y, x >= 1.0, x.astype("float64")]
        return outs

    rng = np.random.RandomState(4)
    feed = {"x": np.abs(rng.randn(3, 4)).astype("float32") + 0.5,
            "y": np.abs(rng.randn(3, 4)).astype("float32") + 0.5}
    want, got = _both(build, feed)
    for g, w in zip(got[0], want[0]):
        assert g.dtype == w.dtype or (g.dtype, w.dtype) == (
            np.float64, np.float32)  # the reference has no x64
        np.testing.assert_allclose(g, w, rtol=FWD_RTOL)


def _schedules(fluid):
    L = fluid.layers
    return {
        "exponential_decay": lambda: L.exponential_decay(0.1, 3, 0.5),
        "exponential_decay_staircase": lambda: L.exponential_decay(
            0.1, 3, 0.5, staircase=True),
        "natural_exp_decay": lambda: L.natural_exp_decay(0.1, 4, 0.3),
        "inverse_time_decay": lambda: L.inverse_time_decay(
            0.1, 2, 0.5, staircase=True),
        "polynomial_decay": lambda: L.polynomial_decay(
            0.1, 5, end_learning_rate=0.01, power=2.0),
        "polynomial_decay_cycle": lambda: L.polynomial_decay(
            0.1, 4, end_learning_rate=0.0, power=1.0, cycle=True),
        "piecewise_decay": lambda: L.piecewise_decay([3, 7],
                                                     [0.1, 0.05, 0.01]),
        "noam_decay": lambda: L.noam_decay(64, 4),
        "cosine_decay": lambda: L.cosine_decay(0.1, 2, 6),
        "linear_lr_warmup": lambda: L.linear_lr_warmup(
            L.polynomial_decay(1e-3, 20, end_learning_rate=0.0),
            warmup_steps=5, start_lr=0.0, end_lr=1e-3),
        "linear_lr_warmup_float": lambda: L.linear_lr_warmup(
            0.05, warmup_steps=4, start_lr=0.01, end_lr=0.05),
    }


@pytest.mark.parametrize("name", sorted(_schedules(jfluid)))
def test_schedule_over_12_steps_matches_reference(name):
    def build(fluid):
        lr = _schedules(fluid)[name]()
        counter = fluid.default_main_program().global_block().var(
            "@LR_DECAY_COUNTER@")
        return [lr, counter]

    want, got = _both(build, {}, steps=STEPS)
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=LR_RTOL, atol=1e-9)
    np.testing.assert_array_equal([float(g[1][0]) for g in got],
                                  np.arange(1, STEPS + 1))


def test_polynomial_decay_cycle_restarts_as_the_reference_test_says():
    """``tests/test_nn_call_parity.py:615``: steps 1-4 decay over 4,
    steps 5-7 over a horizon of 8."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        lr = tfluid.layers.polynomial_decay(0.1, decay_steps=4,
                                            end_learning_rate=0.0,
                                            power=1.0, cycle=True)
    seen = [float(r[0][0]) for r in _reference_run(
        tfluid, main, startup, {}, [lr], steps=7)]
    exp = [0.1 * (1 - min(s, 4) / 4) if s <= 4 else 0.1 * (1 - s / 8.0)
           for s in range(1, 8)]
    np.testing.assert_allclose(seen, exp, atol=1e-6)


def test_counter_increment_is_first_in_place_and_pruned_for_test():
    """The schedule's counter: one ``increment`` at the head of the
    block (``op_role: lr_sched``), written in place, and dropped by
    ``clone(for_test=True)`` so an evaluation does not advance it."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4], dtype="float32")
        lr = tfluid.layers.cosine_decay(0.1, 2, 6)
        out = tfluid.layers.elementwise_mul(x, lr)
    ops = main.global_block().ops
    assert ops[0].type == "increment"
    assert ops[0].attrs["op_role"] == "lr_sched"
    assert ops[0].input("X") == ops[0].output("Out") == ["@LR_DECAY_COUNTER@"]
    test_prog = main.clone(for_test=True)
    assert "increment" not in [o.type for o in test_prog.global_block().ops]
    scope = tfluid.Scope()
    feed = {"x": np.ones((2, 4), "float32")}
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        counter = scope.get("@LR_DECAY_COUNTER@")
        for _ in range(3):
            exe.run(main, feed=feed, fetch_list=[out])
        assert scope.get("@LR_DECAY_COUNTER@") is counter  # in place
        assert float(counter[0]) == 3.0
        for _ in range(2):
            exe.run(test_prog, feed=feed, fetch_list=[out])
        assert float(scope.get("@LR_DECAY_COUNTER@")[0]) == 3.0


def test_schedule_advances_alike_eager_and_from_the_compiled_step():
    """The cached step (capture, then replays) advances the schedule as
    the uncached eager path does, and copies no state back."""
    seen = {}
    for cached in (False, True):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.unique_name.guard(), tfluid.program_guard(main,
                                                              startup):
            lr = tfluid.layers.linear_lr_warmup(
                tfluid.layers.polynomial_decay(1e-4, 8,
                                               end_learning_rate=0.0),
                warmup_steps=4, start_lr=0.0, end_lr=1e-4)
        scope = tfluid.Scope()
        with tfluid.scope_guard(scope):
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup)
            seen[cached] = [float(exe.run(main, fetch_list=[lr],
                                          use_program_cache=cached)[0][0])
                            for _ in range(STEPS)]
            if cached:
                assert exe.last_run_mode == "graph"
                assert not any(e.copy_backs for e in exe._cache.values())
    assert seen[True] == seen[False]
    want = [1e-4 * s / 4 if s < 4 else 1e-4 * (1 - min(s, 8) / 8)
            for s in range(1, STEPS + 1)]
    np.testing.assert_allclose(seen[True], want, rtol=1e-6, atol=1e-12)
