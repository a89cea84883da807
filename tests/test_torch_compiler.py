"""``CompiledProgram``, ``BuildStrategy`` and ``ExecutionStrategy`` of the
port (``paddle_tpu_torch/compiler.py``) against the reference's, on one
process (world 1): the knobs and their warnings, the fast path, the
iterations per run and the gradient accumulation of the executor.

Tolerances:

- ``ITERS_RTOL`` 1e-5: ``num_iteration_per_run`` against the reference's
  (``tests/test_iters_per_run.py``'s model and its own 1e-5), float32
  in another summation order;
- ``ACCUM_RTOL`` 1e-5: ``batch_merge_repeat`` against the reference's
  accumulation (``tests/test_grad_accum_syncbn.py``'s MLP), per-step
  losses and parameters;
- ``ACCUM_VS_PLAIN`` 2e-4: accumulation against one step on the whole
  batch, the reference's own bound (the microbatch means are averaged:
  a reassociation of the batch mean).

The fast path and the port's own iterations are held bit for bit.
"""

import warnings

import numpy as np
import pytest

import paddle_tpu_torch as tfluid

ITERS_RTOL = 1e-5
ACCUM_RTOL = 1e-5
ACCUM_VS_PLAIN = 2e-4


def _iters_model(fluid, seed=7, dropout=0.0):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=32, act="relu")
        if dropout:
            h = fluid.layers.dropout(h, dropout)
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.reduce_mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _mlp_model(fluid):
    """``tests/test_grad_accum_syncbn.py``'s ``_mlp_model``."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 9
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[12], dtype="float32")
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, size=24, act="relu")
        logits = fluid.layers.fc(h, size=3)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _iters_feed(seed=0, batch=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, 16).astype(np.float32)
    return {"x": x, "y": (x.sum(1, keepdims=True) > 0).astype(np.float32)}


def _mlp_batches(n, bs=32):
    rng = np.random.RandomState(1)
    W = rng.randn(12, 3)
    out = []
    for _ in range(n):
        xv = rng.randn(bs, 12).astype("float32")
        yv = np.argmax(xv @ W, axis=1)[:, None].astype("int64")
        out.append({"x": xv, "y": yv})
    return out


def _params(fluid, main, scope):
    return {p.name: np.asarray(scope.get(p.name) if fluid is not tfluid
                               else scope.get(p.name).numpy())
            for p in main.all_parameters()}


def _start(fluid, build, params=None):
    """Build in ``fluid``, run the startup in a new scope and, with
    ``params``, set them: → (main, loss, scope, exe)."""
    main, startup, loss = build(fluid)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        for n, v in (params or {}).items():
            if fluid is tfluid:
                import torch

                scope.set(n, torch.from_numpy(np.array(v)))
            else:
                scope.set(n, np.asarray(v))
    return main, loss, scope, exe


# ---------------------------------------------------------------------------
# the knobs
# ---------------------------------------------------------------------------

def test_strategies_have_the_reference_knobs_and_defaults():
    import paddle_tpu as jfluid

    for cls in ("BuildStrategy", "ExecutionStrategy"):
        assert vars(getattr(tfluid, cls)()) == vars(getattr(jfluid, cls)())
    assert vars(tfluid.BuildStrategy.ReduceStrategy).keys() >= {
        "AllReduce", "Reduce"}
    G = tfluid.BuildStrategy.GradientScaleStrategy
    assert (G.CoeffNumDevice, G.One, G.Customized) == (0, 1, 2)
    for name in ("CompiledProgram", "BuildStrategy", "ExecutionStrategy",
                 "ParallelExecutor", "DistributeTranspiler",
                 "DistributeTranspilerConfig"):
        assert name in tfluid.__all__ and hasattr(tfluid, name), name


def _warned(fluid, bs):
    main, _, loss = _iters_model(fluid)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, build_strategy=bs)
    return [str(x.message) for x in w]


@pytest.mark.parametrize("knob", ["reduce", "customized", "remat", "none"])
def test_inert_knobs_warn_as_the_reference(knob):
    import paddle_tpu as jfluid

    got = []
    for fluid in (jfluid, tfluid):
        bs = fluid.BuildStrategy()
        if knob == "reduce":
            bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
        elif knob == "customized":
            bs.gradient_scale_strategy = \
                fluid.BuildStrategy.GradientScaleStrategy.Customized
        elif knob == "remat":
            bs.remat = True
        got.append(_warned(fluid, bs))
    assert got[1] == got[0]
    assert bool(got[1]) == (knob != "none")


# ---------------------------------------------------------------------------
# the fast path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data_parallel", [False, True])
def test_fast_path_is_executor_run_bit_for_bit(data_parallel):
    """``CompiledProgram(main)`` (the fast path) and
    ``with_data_parallel`` at world 1 (the runner: the executor plus the
    knobs) give a plain ``Executor.run``'s fetches and parameters bit
    for bit over the warm-up, capture and replay calls of one cache
    entry, and use that entry's modes."""
    feeds = [_iters_feed(s) for s in range(4)]
    runs = []
    for compiled in (False, True):
        main, loss, scope, exe = _start(tfluid, _iters_model)
        prog = main
        if compiled:
            prog = tfluid.CompiledProgram(main)
            if data_parallel:
                prog = prog.with_data_parallel(loss_name=loss.name)
        with tfluid.scope_guard(scope):
            losses, modes = [], []
            for f in feeds:
                losses.append(exe.run(prog, feed=f, fetch_list=[loss])[0])
                modes.append(exe.last_run_mode)
        runs.append((np.asarray(losses), _params(tfluid, main, scope),
                     modes))
    assert np.array_equal(runs[0][0], runs[1][0])
    for n, v in runs[0][1].items():
        assert np.array_equal(v, runs[1][1][n]), n
    assert runs[1][2] == runs[0][2] == ["eager", "capture", "graph",
                                        "graph"]


def test_fusion_report_feed_check_and_inference_optimize():
    main, loss, scope, exe = _start(tfluid, _iters_model)
    cp = tfluid.CompiledProgram(main)
    assert cp.fusion_report() is not None
    with tfluid.scope_guard(scope):
        with pytest.raises(ValueError, match="feed 'x' has shape"):
            exe.run(cp, feed={"x": np.ones((2, 15), "float32"),
                              "y": np.ones((2, 1), "float32")},
                    fetch_list=[loss])
        exe.run(cp, feed=_iters_feed(), fetch_list=[loss])
    assert cp.fusion_report() is cp._last_fusion_report
    inf = tfluid.CompiledProgram(main).with_inference_optimize(None)
    assert inf.program is not main


# ---------------------------------------------------------------------------
# num_iteration_per_run
# ---------------------------------------------------------------------------

def _iters_run(fluid, k, params, dropout=0.0, steps=2):
    """``steps`` calls of a ``num_iteration_per_run=k`` program → the
    fetched (last iteration's) losses and the parameters."""
    main, loss, scope, exe = _start(
        fluid, lambda f: _iters_model(f, dropout=dropout), params)
    es = fluid.ExecutionStrategy()
    es.num_iteration_per_run = k
    cp = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, exec_strategy=es)
    with fluid.scope_guard(scope):
        got = [float(np.asarray(exe.run(cp, feed=_iters_feed(),
                                        fetch_list=[loss])[0]).reshape(-1)[0])
               for _ in range(steps)]
    return got, _params(fluid, main, scope)


def test_iterations_per_run_match_the_reference_and_plain_steps():
    """K=4 iterations per call: the fetch is the fourth iteration's and
    the state moved four steps; against the reference's run of the same
    program and against 4 plain calls of the port bit for bit."""
    import paddle_tpu as jfluid

    main, loss, scope, exe = _start(jfluid, _iters_model)
    params = _params(jfluid, main, scope)
    want, want_p = _iters_run(jfluid, 4, params)
    got, got_p = _iters_run(tfluid, 4, params)
    np.testing.assert_allclose(got, want, rtol=ITERS_RTOL, atol=1e-7)
    for n, v in want_p.items():
        np.testing.assert_allclose(got_p[n], v, rtol=ITERS_RTOL,
                                   atol=ITERS_RTOL)
    main, loss, scope, exe = _start(tfluid, _iters_model, params)
    with tfluid.scope_guard(scope):
        plain = [exe.run(main, feed=_iters_feed(), fetch_list=[loss])[0]
                 for _ in range(8)]
    assert [float(plain[3][0]), float(plain[7][0])] == got
    for n, v in _params(tfluid, main, scope).items():
        assert np.array_equal(v, got_p[n]), n


def test_iterations_draw_a_new_dropout_mask_each():
    """At dropout 0.5 the K iterations are K steps, each with its own
    device step (so its own masks): the same bits as K plain calls."""
    got, got_p = _iters_run(tfluid, 3, None, dropout=0.5, steps=1)
    main, loss, scope, exe = _start(
        tfluid, lambda f: _iters_model(f, dropout=0.5))
    with tfluid.scope_guard(scope):
        plain = [float(exe.run(main, feed=_iters_feed(),
                               fetch_list=[loss])[0][0]) for _ in range(3)]
    assert got == plain[-1:] and len(set(plain)) == 3
    for n, v in _params(tfluid, main, scope).items():
        assert np.array_equal(v, got_p[n]), n


def test_iterations_with_accumulation_raise_as_the_reference():
    import paddle_tpu as jfluid

    msgs = []
    for fluid in (jfluid, tfluid):
        main, loss, scope, exe = _start(fluid, _iters_model)
        bs = fluid.BuildStrategy()
        bs.batch_merge_repeat = 2
        es = fluid.ExecutionStrategy()
        es.num_iteration_per_run = 2
        with fluid.scope_guard(scope):
            with pytest.raises(ValueError,
                               match="num_iteration_per_run") as e:
                cp = fluid.CompiledProgram(main).with_data_parallel(
                    loss_name=loss.name, build_strategy=bs,
                    exec_strategy=es)
                exe.run(cp, feed=_iters_feed(), fetch_list=[loss])
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


# ---------------------------------------------------------------------------
# batch_merge_repeat
# ---------------------------------------------------------------------------

def _accum_run(fluid, params, batches, k, fetch_pred=False):
    main, loss, scope, exe = _start(fluid, _mlp_model, params)
    bs = fluid.BuildStrategy()
    bs.batch_merge_repeat = k
    prog = fluid.CompiledProgram(main, build_strategy=bs) if k > 1 \
        else main
    pred = [op.output("Out")[0] for op in main.global_block().ops
            if op.type == "elementwise_add"][-1]
    losses, preds = [], []
    with fluid.scope_guard(scope):
        for feed in batches:
            out = exe.run(prog, feed=feed, fetch_list=[loss, pred])
            losses.append(float(np.asarray(out[0]).reshape(())))
            preds.append(np.asarray(out[1]))
    return losses, _params(fluid, main, scope), preds


def test_accumulation_matches_the_reference_and_one_step():
    """k=4 microbatches of 8 rows, 6 steps: per-step losses (the microbatches'
    mean) and parameters against the reference's accumulation, and
    against one step on the 32 rows within the reference's own bound;
    a per-sample fetch (the logits) comes back whole."""
    import paddle_tpu as jfluid

    batches = _mlp_batches(6)
    main, loss, scope, exe = _start(jfluid, _mlp_model)
    params = _params(jfluid, main, scope)
    want, want_p, _ = _accum_run(jfluid, params, batches, 4)
    got, got_p, preds = _accum_run(tfluid, params, batches, 4)
    plain, _, plain_preds = _accum_run(tfluid, params, batches, 1)
    np.testing.assert_allclose(got, want, rtol=ACCUM_RTOL, atol=1e-7)
    for n, v in want_p.items():
        np.testing.assert_allclose(got_p[n], v, rtol=ACCUM_RTOL,
                                   atol=ACCUM_RTOL)
    np.testing.assert_allclose(got, plain, rtol=ACCUM_VS_PLAIN,
                               atol=ACCUM_VS_PLAIN)
    assert preds[0].shape == plain_preds[0].shape == (32, 3)
    np.testing.assert_allclose(preds[0], plain_preds[0], rtol=1e-5,
                               atol=1e-6)
    assert plain[-1] < plain[0]


def test_accumulation_repeats_bit_for_bit_through_its_cache_entry():
    """The accumulated step as one cache entry: warm-up, capture and
    replay calls give the uncached (eager) run's losses bit for bit."""
    batches = _mlp_batches(3)
    runs = []
    for cached in (True, False):
        main, loss, scope, exe = _start(tfluid, _mlp_model)
        with tfluid.scope_guard(scope):
            runs.append([exe.run(main, feed=f, fetch_list=[loss],
                                 use_program_cache=cached,
                                 _accumulate=4)[0]
                         for f in batches])
    assert np.array_equal(np.asarray(runs[0]), np.asarray(runs[1]))


def test_indivisible_batch_raises_as_the_reference():
    import paddle_tpu as jfluid

    msgs = []
    for fluid in (jfluid, tfluid):
        main, loss, scope, exe = _start(fluid, _mlp_model)
        bs = fluid.BuildStrategy()
        bs.batch_merge_repeat = 4
        with fluid.scope_guard(scope):
            with pytest.raises(ValueError, match="divisible") as e:
                exe.run(fluid.CompiledProgram(main, build_strategy=bs),
                        feed={"x": np.zeros((10, 12), "float32"),
                              "y": np.zeros((10, 1), "int64")},
                        fetch_list=[loss])
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]
