"""``ExponentialMovingAverage`` and ``ModelAverage`` in the port, against
the reference.

The four cases of the reference's ``tests/test_ema_model_average.py``
(EMA applied and restored with its bias correction, EMA applied without
a restore and restored after, ModelAverage over a window that never
restarts, and one that restarts) run in both packages from the
reference's start (``paddle_tpu_torch.convert``) on the same feeds; then
two cases of the port's own: EMA with the decay scheduled from a step
counter (``thres_steps``), and EMA and ModelAverage on one Adam program
applied twice, so that the second apply and restore run their cached
programs.  Each case compares the parameters after the steps, inside
``apply`` and after ``restore`` with the reference's, and with the
reference's numpy oracle where it has one.

Tolerances.  The packages train the same small float32 model with the
same formulas: parameters, applied averages and restored values agree to
1e-5 relative and 1e-6 absolute (the reference's own oracle tolerance is
1e-5 relative).  A restore is bit for bit the parameters before the
apply, in each package.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert

RTOL = 1e-5
ATOL = 1e-6


def _param(scope, name):
    return np.array(np.asarray(scope.get(name)), copy=True)


def _build(fluid, width, size, name, optimizer, make_avg, average=True):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[width], dtype="float32")
        attr = fluid.ParamAttr(name=name, do_model_average=average)
        y = fluid.layers.fc(x, size=size, bias_attr=False, param_attr=attr)
        loss = fluid.layers.mean(y)
        optimizer(fluid).minimize(loss)
        avg = make_avg(fluid)
    return main, startup, avg


def _run(fluid, build, feeds, names, start=None, need_restore=True,
         applies=1):
    """Train on ``feeds``, then ``applies`` times: read the parameters
    inside ``apply`` and after the restore (an explicit one when
    ``need_restore`` is False) → a dict of what was read, and the
    start."""
    main, startup, avg = build(fluid)
    scope = fluid.Scope()
    out = {"hist": [], "raw": [], "applied": [], "restored": []}
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        if start is None:
            start = convert.scope_persistables(main, scope)
        else:
            convert.load_params_into_scope(start, scope, "cpu",
                                           program=main)
        per_apply = len(feeds) // applies
        for a in range(applies):
            for feed in feeds[a * per_apply:(a + 1) * per_apply]:
                exe.run(main, feed={"x": feed}, fetch_list=[])
                out["hist"].append({n: _param(scope, n) for n in names})
            out["raw"].append({n: _param(scope, n) for n in names})
            with avg.apply(exe, need_restore=need_restore):
                out["applied"].append({n: _param(scope, n) for n in names})
            if not need_restore:
                out["unrestored"] = {n: _param(scope, n) for n in names}
                avg.restore(exe)
            out["restored"].append({n: _param(scope, n) for n in names})
    return out, start


def _both(build, feeds, names, differs=True, **kw):
    """The reference's run, then the port's from its start; every read
    compared, and each package's restores held to its parameters (and,
    with ``differs``, its applied values held apart from them)."""
    want, start = _run(jfluid, build, feeds, names, **kw)
    got, _ = _run(tfluid, build, feeds, names, start=start, **kw)
    for key in ("hist", "raw", "applied", "restored"):
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            for n in names:
                np.testing.assert_allclose(g[n], w[n], rtol=RTOL, atol=ATOL,
                                           err_msg="%s[%d] %s" % (key, i, n))
    for side in (got, want):
        for raw, restored, applied in zip(side["raw"], side["restored"],
                                          side["applied"]):
            for n in names:
                np.testing.assert_array_equal(restored[n], raw[n])
                assert not differs or not np.allclose(applied[n], raw[n]), n
    return got, want


def _feeds(seed, n, rows, width):
    rng = np.random.RandomState(seed)
    return [rng.randn(rows, width).astype("float32") for _ in range(n)]


def test_ema_apply_restore_bias_corrected():
    build = lambda f: _build(  # noqa: E731
        f, 4, 3, "w", lambda f: f.optimizer.SGD(0.1),
        lambda f: _ema(f, decay=0.9))
    got, _ = _both(build, _feeds(0, 4, 8, 4), ["w"])
    ema = np.zeros_like(got["hist"][0]["w"])
    for h in got["hist"]:
        ema = 0.9 * ema + 0.1 * h["w"]
    np.testing.assert_allclose(got["applied"][0]["w"],
                               ema / (1.0 - 0.9 ** 4), rtol=RTOL)


def _ema(fluid, decay, thres_steps=None):
    ema = fluid.optimizer.ExponentialMovingAverage(decay=decay,
                                                   thres_steps=thres_steps)
    ema.update()
    return ema


def test_ema_apply_no_restore():
    build = lambda f: _build(  # noqa: E731
        f, 4, 3, "w2", lambda f: f.optimizer.SGD(0.1),
        lambda f: _ema(f, decay=0.5))
    # one step: the bias-corrected average is the parameter itself
    got, want = _both(build, _feeds(1, 1, 8, 4), ["w2"], differs=False,
                      need_restore=False)
    for side in (got, want):
        np.testing.assert_array_equal(side["unrestored"]["w2"],
                                      side["applied"][0]["w2"])
    np.testing.assert_allclose(got["unrestored"]["w2"],
                               want["unrestored"]["w2"], rtol=RTOL,
                               atol=ATOL)


def test_model_average_window():
    build = lambda f: _build(  # noqa: E731
        f, 4, 3, "wa", lambda f: f.optimizer.SGD(0.1),
        lambda f: f.optimizer.ModelAverage(
            0.15, min_average_window=10000, max_average_window=20000))
    got, _ = _both(build, _feeds(2, 6, 8, 4), ["wa"])
    np.testing.assert_allclose(
        got["applied"][0]["wa"],
        np.mean([h["wa"] for h in got["hist"]], axis=0), rtol=RTOL)


def test_model_average_window_restart():
    """max window 3, min 2: the sums restart twice in 7 steps, and the
    average covers the steps since the last restart and the window
    before it (the reference's numpy oracle)."""
    build = lambda f: _build(  # noqa: E731
        f, 2, 1, "wr", lambda f: f.optimizer.SGD(0.5),
        lambda f: f.optimizer.ModelAverage(
            1.0, min_average_window=2, max_average_window=3))
    got, _ = _both(build, _feeds(3, 7, 4, 2), ["wr"])
    s1 = s2 = s3 = np.zeros_like(got["hist"][0]["wr"])
    na = ona = nu = 0
    for h in got["hist"]:
        nu += 1
        na += 1
        s1 = s1 + h["wr"]
        if na >= 2 and na >= min(3, nu * 1.0):
            s3 = s1 + s2
            s1 = np.zeros_like(s1)
            s2 = np.zeros_like(s2)
            ona, na = na, 0
    np.testing.assert_allclose(got["applied"][0]["wr"],
                               (s1 + s2 + s3) / float(na + ona), rtol=RTOL)


def test_ema_scheduled_decay_from_a_step_counter():
    """``thres_steps`` from ``autoincreased_step_counter(begin=0)``: the
    decay of step t is min(0.999, (1 + t) / (10 + t)), and the bias
    correction uses the last step's decay, as in the reference."""
    def avg(fluid):
        step = fluid.layers.autoincreased_step_counter(begin=0)
        return _ema(fluid, decay=0.999, thres_steps=step)

    build = lambda f: _build(  # noqa: E731
        f, 4, 3, "ws", lambda f: f.optimizer.SGD(0.1), avg)
    got, _ = _both(build, _feeds(4, 5, 8, 4), ["ws"])
    ema, d = np.zeros_like(got["hist"][0]["ws"]), None
    for t, h in enumerate(got["hist"]):
        d = np.float32(min(np.float32(0.999),
                           np.float32(1 + t) / np.float32(10 + t)))
        ema = d * ema + (np.float32(1) - d) * h["ws"]
    np.testing.assert_allclose(got["applied"][0]["ws"],
                               ema / (1.0 - d ** len(got["hist"])),
                               rtol=RTOL)


@pytest.mark.parametrize("kind", ["ema", "model_average"])
def test_averages_apply_twice_through_the_cached_programs(kind):
    """An Adam program with an average, applied after 3 steps and again
    after 3 more: the second apply and restore run the programs the
    executor cached at the first (a captured step on the card), and
    agree with the reference."""
    def avg(fluid):
        if kind == "ema":
            return _ema(fluid, decay=0.8)
        return fluid.optimizer.ModelAverage(1.0, min_average_window=2,
                                            max_average_window=4)

    build = lambda f: _build(  # noqa: E731
        f, 4, 3, "wc", lambda f: f.optimizer.Adam(0.05), avg)
    got, _ = _both(build, _feeds(5, 6, 8, 4), ["wc"], applies=2)
    assert len(got["applied"]) == 2
    assert not np.allclose(got["applied"][0]["wc"], got["applied"][1]["wc"])
