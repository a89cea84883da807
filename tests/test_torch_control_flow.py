"""Control flow in the PyTorch port against the reference: ``While``,
``cond``, ``ConditionalBlock``, ``Switch``, ``IfElse``, the tensor arrays
and the gradients through them, on the CPU.

The programs are the reference's own tests' (``tests/test_control_flow.py``,
the ``While`` and ``cond`` tests of ``tests/test_control_flow_grad.py``
and ``tests/test_while_grad_dynrnn.py:48-196``), built in both packages
from one function and run on the same seeded numpy inputs; closed forms
are checked as the reference's tests check them.  Integers (trip
counts, array lengths, indices) are compared exactly, float values and
gradients within rtol 1e-5 / atol 1e-6 of their scale (float32 sums of
a few terms).  The port drives a loop's trips from the host: its first
trip runs op by op, its second binds the body's inputs and runs it on
them (a CUDA graph on the card), the rest replay that; the runs below go
through all three and through the eager path (``use_program_cache=False``).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import scope_guard as jscope_guard

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import executor as texecutor
from paddle_tpu_torch.ops import control_flow as tcf
from paddle_tpu_torch.ops import registry as tregistry

RTOL, ATOL = 1e-5, 1e-6
BOTH = (("reference", jfluid, JScope, jscope_guard),
        ("port", tfluid, texecutor.Scope, texecutor.scope_guard))


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def _run_both(build, feeds, runs=1, startup_first=True, cache=True):
    """``build(fluid) -> (main, startup, fetch vars)`` in both packages,
    each run ``runs`` times per feed in a fresh scope → {package: [each
    run's fetches as numpy]} and the port's executor."""
    out = {}
    exe_t = None
    for label, fluid, scope_cls, guard in BOTH:
        fluid.unique_name.switch()
        main, startup, fetch = build(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        if label == "port":
            exe_t = exe
        got = []
        with guard(scope_cls()):
            if startup_first:
                exe.run(startup)
            for feed in feeds:
                for _ in range(runs):
                    kw = {} if label == "reference" else \
                        {"use_program_cache": cache}
                    got.append([np.asarray(v) for v in exe.run(
                        main, feed=feed, fetch_list=fetch, **kw)])
        out[label] = got
    return out, exe_t


def _same(out, exact=False):
    for got, want in zip(out["port"], out["reference"]):
        for g, w in zip(got, want):
            if exact:
                np.testing.assert_array_equal(g, w)
            else:
                _close(g, w)


# ---------------------------------------------------------------------------
# tests/test_control_flow.py
# ---------------------------------------------------------------------------


def _sum_of_squares(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        i = fluid.layers.fill_constant([1], "float32", 0.0)
        acc = fluid.layers.fill_constant([1], "float32", 0.0)
        limit = fluid.layers.fill_constant([1], "float32", 10.0)
        cond = fluid.layers.less_than(i, limit)
        w = fluid.layers.While(cond)
        with w.block():
            sq = fluid.layers.elementwise_mul(i, i)
            fluid.layers.assign(fluid.layers.elementwise_add(acc, sq),
                                output=acc)
            fluid.layers.increment(i, value=1.0, in_place=True)
            fluid.layers.less_than(i, limit, cond=cond)
    return main, startup, [acc, i]


def test_while_sum_of_squares_and_the_loops_run_modes():
    """sum k^2 for k < 10 = 285 in both; the port's three runs go through
    the loop's warm-up, bind and replays, with 10 trips and 11 condition
    reads each, one cache entry for the body, and a fetched carry that
    the next run does not write."""
    out, exe = _run_both(_sum_of_squares, [{}], runs=3)
    _same(out, exact=True)
    assert float(out["port"][0][0][0]) == 285.0
    assert float(out["port"][0][1][0]) == 10.0
    loops = exe.last_loops
    assert [(r["trips"], r["cond_reads"], r["mode"]) for r in loops] \
        == [(10, 11, "graph")]
    assert loops[0]["replayed_trips"] == 10
    assert exe.last_run_mode == "eager"
    assert "reads its condition on the host" in exe.last_run_reason
    bodies = [e for e in exe._cache.values()
              if isinstance(e, texecutor._LoopBody)]
    assert len(bodies) == 1 and bodies[0].calls == 3
    # acc and the condition are new values a trip, the counter is written
    # in place
    counter = "fill_constant_0.tmp_0"
    assert counter in bodies[0].carried
    assert bodies[0].copy_back_names == sorted(
        set(bodies[0].carried) - {counter})


def test_first_run_warms_binds_and_replays():
    _, exe = _run_both(_sum_of_squares, [{}], runs=1)
    rec = exe.last_loops[0]
    assert (rec["eager_trips"], rec["captured_trips"],
            rec["replayed_trips"]) == (1, 1, 8)


def _array_loop(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        i = fluid.layers.fill_constant([1], "int32", 0)
        limit = fluid.layers.fill_constant([1], "int32", 5)
        x = fluid.layers.fill_constant([3], "float32", 2.0)
        arr = fluid.layers.array_write(x, i, capacity=8)
        cond = fluid.layers.less_than(i, limit)
        w = fluid.layers.While(cond)
        with w.block():
            val = fluid.layers.array_read(arr, i)
            doubled = fluid.layers.scale(val, scale=2.0)
            fluid.layers.increment(i, value=1, in_place=True)
            fluid.layers.array_write(doubled, i, array=arr)
            fluid.layers.less_than(i, limit, cond=cond)
        final = fluid.layers.array_read(arr, i)
        n = fluid.layers.array_length(arr)
        whole, sizes = fluid.layers.tensor_array_to_tensor(arr, axis=0)
    return main, startup, [final, n, whole, sizes]


@pytest.mark.parametrize("cache", [True, False])
def test_while_with_tensor_array(cache):
    """2 * 2^5 at row 5, length 6, the capacity-8 buffer whole with its
    zero fill past the last write, in both, cached and eager."""
    out, _ = _run_both(_array_loop, [{}], runs=2, cache=cache)
    _same(out, exact=True)
    final, n, whole, sizes = out["port"][0]
    np.testing.assert_allclose(final, 2.0 * 2 ** 5)
    assert int(n[0]) == 6 and whole.shape == (24,)
    np.testing.assert_array_equal(whole[18:], 0.0)
    np.testing.assert_array_equal(sizes, [3] * 8)


def _conditional(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[1], dtype="float32",
                              append_batch_size=False)
        zero = fluid.layers.fill_constant([1], "float32", 0.0)
        out = fluid.layers.fill_constant([1], "float32", 0.0)
        count = fluid.layers.fill_constant([1], "float32", 0.0)
        pred = fluid.layers.greater_than(x, zero)
        cb = fluid.layers.ConditionalBlock([pred])
        with cb.block():
            fluid.layers.assign(
                fluid.layers.fill_constant([1], "float32", 5.0),
                output=out)
            fluid.layers.increment(count, value=1.0, in_place=True)
    return main, startup, [out, count]


def test_conditional_block_true_false():
    """5 when x > 0, else the 0 it held; the untaken branch's in-place
    increment writes nothing."""
    feeds = [{"x": np.array([f], "float32")} for f in (1.0, -1.0)]
    out, _ = _run_both(_conditional, feeds)
    _same(out, exact=True)
    assert [(float(o[0][0]), float(o[1][0])) for o in out["port"]] \
        == [(5.0, 1.0), (0.0, 0.0)]


def _switch(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        step = fluid.layers.data("step", shape=[1], dtype="float32",
                                 append_batch_size=False)
        lr = fluid.layers.fill_constant([1], "float32", 0.0)
        b1 = fluid.layers.fill_constant([1], "float32", 10.0)
        b2 = fluid.layers.fill_constant([1], "float32", 20.0)
        with fluid.layers.Switch() as switch:
            with switch.case(fluid.layers.less_than(step, b1)):
                fluid.layers.assign(
                    fluid.layers.fill_constant([1], "float32", 0.1),
                    output=lr)
            with switch.case(fluid.layers.less_than(step, b2)):
                fluid.layers.assign(
                    fluid.layers.fill_constant([1], "float32", 0.05),
                    output=lr)
            with switch.default():
                fluid.layers.assign(
                    fluid.layers.fill_constant([1], "float32", 0.01),
                    output=lr)
    return main, startup, [lr]


def test_switch_lr_band():
    feeds = [{"step": np.array([s], "float32")} for s in (5.0, 15.0, 50.0)]
    out, _ = _run_both(_switch, feeds)
    _same(out, exact=True)
    np.testing.assert_allclose([o[0][0] for o in out["port"]],
                               [0.1, 0.05, 0.01], rtol=1e-6)


def _counter(fluid, trips):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        i = fluid.layers.fill_constant([1], "float32", 0.0)
        limit = fluid.layers.fill_constant([1], "float32", float(trips))
        cond = fluid.layers.less_than(i, limit)
        w = fluid.layers.While(cond)
        with w.block():
            fluid.layers.increment(i, value=1.0, in_place=True)
            fluid.layers.less_than(i, limit, cond=cond)
    return main, startup, [i]


def test_while_1000_trips_one_body_entry():
    """The reference's compiled-loop test: 1000 trips; here one body
    cache entry whose 1000 trips the second run all replays, with no
    copy-back for the in-place counter."""
    out, exe = _run_both(lambda f: _counter(f, 1000), [{}], runs=2)
    _same(out, exact=True)
    assert float(out["port"][1][0][0]) == 1000.0
    rec = exe.last_loops[0]
    assert (rec["trips"], rec["replayed_trips"], rec["cond_reads"]) \
        == (1000, 1000, 1001)
    assert rec["copy_backs"] == [n for n in rec["copy_backs"]
                                 if n.startswith("less_than")]


def _ifelse(fluid, grad):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[3], dtype="float32",
                              stop_gradient=not grad)
        zero = fluid.layers.fill_constant([1], "float32", 0.0)
        row_sum = fluid.layers.reduce_sum(x, dim=[1], keep_dim=True)
        cond = fluid.layers.greater_than(row_sum, zero)  # [B, 1] bool
        ie = fluid.layers.IfElse(cond)
        with ie.true_block():
            ie.output(fluid.layers.scale(ie.input(x), 10.0))
        with ie.false_block():
            ie.output(fluid.layers.scale(ie.input(x), -1.0))
        (merged,) = ie()
        total = fluid.layers.reduce_sum(merged)
        fetch = [merged, total]
        if grad:
            fetch += fluid.backward.gradients(total, x)
    return main, startup, fetch


@pytest.mark.parametrize("grad", [False, True])
def test_ifelse_per_row_branches(grad):
    xv = np.array([[1, 1, 1], [-1, -1, -1], [2, 0, 0]], "float32")
    out, _ = _run_both(lambda f: _ifelse(f, grad), [{"x": xv}])
    _same(out)
    got = out["port"][0]
    np.testing.assert_allclose(
        got[0], np.where(xv.sum(1, keepdims=True) > 0, xv * 10.0, -xv))
    if grad:
        want = np.where(xv.sum(1, keepdims=True) > 0, 10.0, -1.0)
        np.testing.assert_allclose(got[2], np.broadcast_to(want, xv.shape))


def _cond(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[1], dtype="float32",
                              append_batch_size=False)
        zero = fluid.layers.fill_constant([1], "float32", 0.0)
        pred = fluid.layers.greater_than(x, zero)
        out = fluid.layers.cond(
            pred,
            lambda: fluid.layers.fill_constant([1], "float32", 7.0),
            lambda: fluid.layers.fill_constant([1], "float32", -7.0))
    return main, startup, [out]


def test_cond_two_branches():
    feeds = [{"x": np.array([v], "float32")} for v in (2.0, -2.0)]
    out, _ = _run_both(_cond, feeds)
    _same(out, exact=True)
    assert [float(o[0][0]) for o in out["port"]] == [7.0, -7.0]


def _cond_grad(fluid):
    """loss = mean(cond(x > 0, 3 w x, x / 2)) with a trainable scalar w
    read in the first branch: the taken branch's gradient, zeros from
    the untaken one."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[1, 1], dtype="float32",
                              append_batch_size=False)
        pred = fluid.layers.reduce_all(fluid.layers.greater_than(
            x, fluid.layers.fill_constant([1, 1], "float32", 0.0)))

        def taken():
            y = fluid.layers.fc(x, size=1, bias_attr=False,
                                param_attr=fluid.ParamAttr(
                                    name="cond.w",
                                    initializer=fluid.initializer.Constant(
                                        2.0)))
            return fluid.layers.scale(y, 3.0)

        out = fluid.layers.cond(pred, taken,
                                lambda: fluid.layers.scale(x, 0.5))
        loss = fluid.layers.mean(out)
        pg = fluid.backward.append_backward(loss)
    return main, startup, [loss, pg[0][1]]


def test_cond_grad_taken_and_untaken():
    feeds = [{"x": np.array([[v]], "float32")} for v in (0.5, -0.5)]
    out, _ = _run_both(_cond_grad, feeds)
    _same(out)
    (l1, g1), (l2, g2) = out["port"]
    _close(l1, [3.0]), _close(g1, [[1.5]])       # 3 w x, d/dw = 3 x
    _close(l2, [-0.25]), _close(g2, [[0.0]])     # untaken: zero


def _capacity(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        arr = fluid.layers.create_array("float32", capacity=300)
        i = fluid.layers.fill_constant([1], "int32", 0)
        limit = fluid.layers.fill_constant([1], "int32", 200)
        x = fluid.layers.fill_constant([2], "float32", 1.0)
        fluid.layers.array_write(x, i, array=arr)
        cond = fluid.layers.less_than(i, limit)
        w = fluid.layers.While(cond)
        with w.block():
            fluid.layers.increment(i, value=1, in_place=True)
            fluid.layers.array_write(
                fluid.layers.elementwise_add(
                    fluid.layers.cast(i, "float32"),
                    fluid.layers.fill_constant([2], "float32", 0.0)),
                i, array=arr)
            fluid.layers.less_than(i, limit, cond=cond)
        at = fluid.layers.array_read(
            arr, fluid.layers.fill_constant([1], "int32", 150))
        n = fluid.layers.array_length(arr)
    return main, startup, [at, n]


def test_array_capacity_respected():
    out, _ = _run_both(_capacity, [{}])
    _same(out, exact=True)
    np.testing.assert_allclose(out["port"][0][0], 150.0)
    assert int(out["port"][0][1][0]) == 201


# ---------------------------------------------------------------------------
# while gradients (tests/test_control_flow_grad.py, test_while_grad_dynrnn.py)
# ---------------------------------------------------------------------------


def _pow_loop(fluid, max_trip, limit_feed=False, grad_x=False):
    """y = w^n (3x when ``grad_x``) through ``while i < n: y = fc(y)``
    with a trainable scalar w = 2."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[1, 1], dtype="float32",
                              append_batch_size=False,
                              stop_gradient=not grad_x)
        y = fluid.layers.assign(fluid.layers.scale(x, 3.0) if grad_x else x)
        i = fluid.layers.fill_constant([1], "float32", 0.0)
        if limit_feed:
            limit = fluid.layers.data("limit", shape=[1], dtype="float32",
                                      append_batch_size=False)
        else:
            limit = fluid.layers.fill_constant([1], "float32", 3.0)
        cond = fluid.layers.less_than(i, limit)
        w = fluid.layers.While(cond, max_trip_count=max_trip)
        with w.block():
            fluid.layers.assign(
                fluid.layers.fc(y, size=1, bias_attr=False,
                                param_attr=fluid.ParamAttr(
                                    name="loop.w",
                                    initializer=fluid.initializer.Constant(
                                        2.0))),
                output=y)
            fluid.layers.increment(i, in_place=True)
            fluid.layers.less_than(i, limit, cond=cond)
        loss = fluid.layers.mean(y)
        if grad_x:
            fetch = [loss] + fluid.backward.gradients(loss, x)
        else:
            pg = fluid.backward.append_backward(loss)
            assert [p.name for p, _ in pg] == ["loop.w"]
            fetch = [loss, pg[0][1]]
    return main, startup, fetch


@pytest.mark.parametrize("max_trip", [3, 8, None])
def test_while_grad_closed_form(max_trip):
    """mean(w^3 x) = 4, d/dw = 3 w^2 x = 6 at x = 0.5, bounded (a bound
    above the trips changes nothing) and unbounded, each run twice."""
    xv = {"x": np.array([[0.5]], "float32")}
    out, exe = _run_both(lambda f: _pow_loop(f, max_trip), [xv], runs=2)
    _same(out)
    for lv, gv in out["port"]:
        _close(lv, [4.0]), _close(gv, [[6.0]])
    assert exe.last_loops[0]["trips"] == 3


def test_while_grad_reaches_the_ops_before_the_loop():
    """d mean(w^3 * 3x)/dx = 3 w^3 = 24: StateIn@GRAD flows on through
    the pre-loop scale."""
    xv = {"x": np.array([[0.5]], "float32")}
    out, _ = _run_both(lambda f: _pow_loop(f, 5, grad_x=True), [xv])
    _same(out)
    _close(out["port"][0][1], [[24.0]])


def test_while_grad_data_dependent_trips():
    """The trip count comes from a fed limit, unbounded: n w^(n-1) x for
    n = 2, 4, then a finite difference at n = 4 (the reference's oracle)
    and the zero-trip loop, whose gradient is exactly 0."""
    xv = np.array([[0.5]], "float32")
    feeds = [{"x": xv, "limit": np.array([float(n)], "float32")}
             for n in (2, 4, 0)]
    out, _ = _run_both(lambda f: _pow_loop(f, None, limit_feed=True), feeds)
    _same(out)
    for (lv, gv), n in zip(out["port"], (2, 4, 0)):
        _close(lv, [2.0 ** n * 0.5])
        _close(gv, [[n * 2.0 ** max(n - 1, 0) * 0.5 if n else 0.0]])
    # the finite difference of the port's own loss
    tfluid.unique_name.switch()
    main, startup, fetch = _pow_loop(tfluid, None, limit_feed=True)
    exe = tfluid.Executor(tfluid.CPUPlace())
    losses = []
    with texecutor.scope_guard(texecutor.Scope()) as _:
        scope = texecutor.global_scope()
        exe.run(startup)
        for w in (2.0 + 1e-3, 2.0 - 1e-3):
            scope.set("loop.w", torch.tensor([[w]], dtype=torch.float32))
            losses.append(float(exe.run(
                main, feed=feeds[1], fetch_list=fetch[:1])[0][0]))
    _close((losses[0] - losses[1]) / 2e-3, out["port"][1][1][0, 0],
           rtol=1e-3)


def test_max_trip_count_below_the_trips():
    """The forward runs every trip the condition asks for (w^3 x); the
    gradient is the reference's: that of the loop cut at the bound (two
    trips, 2 w x = 2 at x = 0.5)."""
    xv = {"x": np.array([[0.5]], "float32")}
    out, _ = _run_both(lambda f: _pow_loop(f, 2), [xv])
    _same(out)
    _close(out["port"][0][0], [4.0])
    _close(out["port"][0][1], [[2.0]])


def _unbounded_minimize(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        i = fluid.layers.fill_constant([1], "float32", 0.0)
        acc = fluid.layers.fc(
            fluid.layers.data("x", shape=[1], dtype="float32"), size=1,
            param_attr=fluid.ParamAttr(
                name="min.w", initializer=fluid.initializer.Constant(0.7)),
            bias_attr=fluid.ParamAttr(
                name="min.b", initializer=fluid.initializer.Constant(0.1)))
        limit = fluid.layers.fill_constant([1], "float32", 3.0)
        cond = fluid.layers.less_than(i, limit)
        w = fluid.layers.While(cond)
        with w.block():
            fluid.layers.assign(fluid.layers.scale(acc, 2.0), output=acc)
            fluid.layers.increment(i, in_place=True)
            fluid.layers.less_than(i, limit, cond=cond)
        loss = fluid.layers.mean(fluid.layers.elementwise_mul(acc, acc))
        # loss = (8 (w x + b))^2: lr below 2/128
        fluid.optimizer.SGD(0.005).minimize(loss)
    return main, startup, [loss, "min.w"]


def test_while_unbounded_minimize_trains():
    """SGD through an unbounded loop: 6 steps, loss and parameter equal
    the reference's step for step, and the loss falls."""
    out, exe = _run_both(_unbounded_minimize,
                         [{"x": np.array([[1.0]], "float32")}], runs=6)
    _same(out)
    losses = [float(o[0].reshape(())) for o in out["port"]]
    assert losses[-1] < losses[0]
    assert exe.last_loops[0]["mode"] == "graph"


def _array_grad(fluid):
    """y_k = w y_{k-1} written into an array each trip, loss = the mean
    of rows 1..3 read back after the loop: d/dw (w x + w^2 x + w^3 x)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[1, 1], dtype="float32",
                              append_batch_size=False)
        y = fluid.layers.assign(x)
        i = fluid.layers.fill_constant([1], "int32", 0)
        limit = fluid.layers.fill_constant([1], "int32", 3)
        acc = fluid.layers.scale(x, 0.0)  # a zero that takes a gradient
        arr = fluid.layers.array_write(y, i, capacity=4)
        cond = fluid.layers.less_than(i, limit)
        w = fluid.layers.While(cond, max_trip_count=4)
        with w.block():
            prev = fluid.layers.reshape(fluid.layers.array_read(arr, i),
                                        [1, 1])
            nxt = fluid.layers.fc(prev, size=1, bias_attr=False,
                                  param_attr=fluid.ParamAttr(
                                      name="arr.w",
                                      initializer=fluid.initializer.Constant(
                                          2.0)))
            fluid.layers.increment(i, value=1, in_place=True)
            fluid.layers.array_write(nxt, i, array=arr)
            fluid.layers.assign(fluid.layers.elementwise_add(acc, nxt),
                                output=acc)
            fluid.layers.less_than(i, limit, cond=cond)
        loss = fluid.layers.mean(acc)
        pg = fluid.backward.append_backward(loss)
    return main, startup, [loss, pg[0][1]]


def test_while_grad_through_an_array():
    """The port alone, against the closed form: the reference's
    ``while_grad`` cannot take an array among its carries (its vjp reads
    every carry as one array)."""
    tfluid.unique_name.switch()
    main, startup, fetch = _array_grad(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with texecutor.scope_guard(texecutor.Scope()):
        exe.run(startup)
        runs = [exe.run(main, feed={"x": np.array([[0.5]], "float32")},
                        fetch_list=fetch) for _ in range(2)]
    assert runs[0][0] == runs[1][0] and runs[0][1] == runs[1][1]
    lv, gv = runs[1]
    _close(lv, [0.5 * (2 + 4 + 8)])
    _close(gv, [[0.5 * (1 + 2 * 2 + 3 * 4)]])


# ---------------------------------------------------------------------------
# the port's own: a body that cannot be captured, nested loops, the ops
# ---------------------------------------------------------------------------


def test_a_failed_capture_leaves_no_binding(monkeypatch):
    """A trip that raises while the body is bound and captured leaves the
    entry unbound, so the next run warms, binds and captures again
    rather than replaying a body that was never captured."""
    tfluid.unique_name.switch()
    main, startup, fetch = _sum_of_squares(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    trip = texecutor._LoopBody.trip

    def fail_once(self, run_block):
        monkeypatch.setattr(texecutor._LoopBody, "trip", trip)
        raise RuntimeError("capture failed")

    monkeypatch.setattr(texecutor._LoopBody, "trip", fail_once)
    with texecutor.scope_guard(texecutor.Scope()):
        with pytest.raises(RuntimeError, match="capture failed"):
            exe.run(main, fetch_list=fetch)
        body, = [e for e in exe._cache.values()
                 if isinstance(e, texecutor._LoopBody)]
        assert body.bound is None
        out = exe.run(main, fetch_list=fetch)
    assert float(out[0][0]) == 285.0
    assert exe.last_loops[0]["captured_trips"] == 1


def test_the_body_never_writes_a_tensor_it_does_not_own():
    """The body reads the fed limit and the scope's parameter.  Two limit
    tensors fed in turn, run after run (warm-up, capture, replays), keep
    their values and each run gives w^n x and n w^(n-1) x (rtol 1e-5,
    atol 1e-6 of the scale): the body reads its own copy of the limit.
    It reads the parameter where the scope holds it; once the scope holds
    another tensor, the body binds anew, gives w = 3's values, and the
    old parameter tensor keeps 2."""
    tfluid.unique_name.switch()
    main, startup, fetch = _pow_loop(tfluid, None, limit_feed=True)
    exe = tfluid.Executor(tfluid.CPUPlace())
    x = torch.tensor([[0.5]])
    limits = {n: torch.tensor([float(n)]) for n in (2, 4)}
    with texecutor.scope_guard(texecutor.Scope()):
        scope = texecutor.global_scope()
        exe.run(startup)
        w2 = scope.get("loop.w")
        for n in (2, 4, 2, 4):
            loss, grad = exe.run(main, feed={"x": x, "limit": limits[n]},
                                 fetch_list=fetch)
            _close(loss, [2.0 ** n * 0.5])
            _close(grad, [[n * 2.0 ** (n - 1) * 0.5]])
            assert [float(t[0]) for t in limits.values()] == [2.0, 4.0]
        body, = [e for e in exe._cache.values()
                 if isinstance(e, texecutor._LoopBody)]
        assert body.borrowed == ("loop.w",) and body.bound["loop.w"] is w2
        assert all(body.bound["limit"] is not t for t in limits.values())
        scope.set("loop.w", torch.tensor([[3.0]]))
        loss, grad = exe.run(main, feed={"x": x, "limit": limits[2]},
                             fetch_list=fetch)
    _close(loss, [4.5]), _close(grad, [[3.0]])
    assert float(w2[0, 0]) == 2.0
    assert exe.last_loops[0]["captured_trips"] == 1


def _printing_loop(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        i = fluid.layers.fill_constant([1], "float32", 0.0)
        limit = fluid.layers.fill_constant([1], "float32", 3.0)
        cond = fluid.layers.less_than(i, limit)
        w = fluid.layers.While(cond)
        with w.block():
            shown = fluid.layers.Print(i, message="trip ")
            fluid.layers.assign(fluid.layers.scale(shown, 1.0, bias=1.0),
                                output=i)
            fluid.layers.less_than(i, limit, cond=cond)
    return main, startup, [i]


def test_a_body_with_a_print_runs_eagerly_and_says_why(capfd):
    out, exe = _run_both(_printing_loop, [{}], runs=2)
    _same(out, exact=True)
    rec = exe.last_loops[0]
    assert rec["mode"] == "eager" and rec["eager_trips"] == 3
    assert "'print'" in rec["reason"] and "not capturable" in rec["reason"]
    assert "trip [2.]" in capfd.readouterr().out


def _nested(fluid):
    """sum over i < 3 of sum over j < i + 1 of (i + j), inner loop in the
    outer body."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        i = fluid.layers.fill_constant([1], "float32", 0.0)
        acc = fluid.layers.fill_constant([1], "float32", 0.0)
        n = fluid.layers.fill_constant([1], "float32", 3.0)
        c1 = fluid.layers.less_than(i, n)
        outer = fluid.layers.While(c1)
        with outer.block():
            j = fluid.layers.fill_constant([1], "float32", 0.0)
            top = fluid.layers.scale(i, 1.0, bias=1.0)
            c2 = fluid.layers.less_than(j, top)
            inner = fluid.layers.While(c2)
            with inner.block():
                fluid.layers.assign(fluid.layers.elementwise_add(
                    acc, fluid.layers.elementwise_add(i, j)), output=acc)
                fluid.layers.increment(j, value=1.0, in_place=True)
                fluid.layers.less_than(j, top, cond=c2)
            fluid.layers.increment(i, value=1.0, in_place=True)
            fluid.layers.less_than(i, n, cond=c1)
    return main, startup, [acc]


def test_nested_loops():
    out, exe = _run_both(_nested, [{}], runs=2)
    _same(out, exact=True)
    assert float(out["port"][0][0][0]) == sum(
        i + j for i in range(3) for j in range(i + 1))
    rec = exe.last_loops[0]
    assert rec["mode"] == "eager" and "'while'" in rec["reason"]


def _branch_in_loop(fluid):
    """acc += i where i is even, else acc -= 1, for i < 6: a
    ConditionalBlock in a While body."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        i = fluid.layers.fill_constant([1], "float32", 0.0)
        acc = fluid.layers.fill_constant([1], "float32", 0.0)
        n = fluid.layers.fill_constant([1], "float32", 6.0)
        two = fluid.layers.fill_constant([1], "float32", 2.0)
        c = fluid.layers.less_than(i, n)
        loop = fluid.layers.While(c)
        with loop.block():
            half = fluid.layers.floor(fluid.layers.elementwise_div(i, two))
            even = fluid.layers.equal(fluid.layers.elementwise_mul(
                half, two), i)
            with fluid.layers.Switch() as switch:
                with switch.case(even):
                    fluid.layers.assign(fluid.layers.elementwise_add(
                        acc, i), output=acc)
                with switch.default():
                    fluid.layers.assign(fluid.layers.scale(
                        acc, 1.0, bias=-1.0), output=acc)
            fluid.layers.increment(i, value=1.0, in_place=True)
            fluid.layers.less_than(i, n, cond=c)
    return main, startup, [acc]


def test_a_switch_inside_a_loop():
    """0 + 2 + 4 - 3 = 3 in both; the body reads its branches' conditions
    on the host, so it runs op by op, and the record says so."""
    out, exe = _run_both(_branch_in_loop, [{}], runs=2)
    _same(out, exact=True)
    assert float(out["port"][0][0][0]) == 3.0
    rec = exe.last_loops[0]
    assert rec["mode"] == "eager" and rec["trips"] == 6
    assert "'conditional_block'" in rec["reason"]


def _small_ops(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        a = fluid.layers.data("a", shape=[2, 3], dtype="float32",
                              append_batch_size=False)
        b = fluid.layers.assign(np.arange(6, dtype="float32").reshape(2, 3))
        c = fluid.layers.concat([a, b], axis=1)
        m = fluid.layers.greater_than(a, b)
        n = fluid.layers.less_than(a, b)
        fetch = [b, c, fluid.layers.logical_and(m, n),
                 fluid.layers.logical_or(m, n),
                 fluid.layers.logical_xor(m, n), fluid.layers.logical_not(m),
                 fluid.layers.reduce_all(m), fluid.layers.reduce_any(m),
                 fluid.layers.reduce_all(m, dim=[1]),
                 fluid.layers.reduce_any(m, dim=[0], keep_dim=True),
                 fluid.layers.is_empty(a)]
    return main, startup, fetch


def test_the_new_ops_match_the_reference():
    av = np.random.RandomState(0).uniform(0, 6, (2, 3)).astype("float32")
    out, _ = _run_both(_small_ops, [{"a": av}])
    _same(out, exact=True)
    assert out["port"][0][-1].tolist() == [False]


def test_array_ops_clamp_rows_and_keep_their_buffer():
    """A write past the capacity lands in the last row (the reference's
    clamped dynamic update) and the length counts the index asked for;
    the buffer is written in place."""
    op = tregistry.get_op_def("write_to_array")
    ctx = tregistry.LoweringContext()
    x = torch.ones(2)
    arr = op.fn(ctx, {tcf.ARRAY_CAPACITY_ATTR: 4}, X=x,
                I=torch.tensor([1], dtype=torch.int32), Array=None)
    buf = arr.buffer
    again = op.fn(ctx, {}, X=2 * x, I=torch.tensor([9], dtype=torch.int32),
                  Array=arr)
    assert again is arr and again.buffer is buf
    assert buf[:, 0].tolist() == [0.0, 1.0, 0.0, 2.0]
    assert int(arr.length) == 10
