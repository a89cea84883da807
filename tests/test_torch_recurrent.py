"""``recurrent`` in the PyTorch port against the reference, on the CPU:
``StaticRNN`` (time-major, one memory from a var and one filled from the
batch) and ``DynamicRNN`` (batch-major padded sequences with lengths, a
static input, a filled memory) forward and gradients (of the sequence
inputs, the initial states and the ``Captured`` parameters the step
reads), the LoD rank-table ops in their padded form, and a training
program holding a ``recurrent`` through the executor's cache.

Both packages build each program from one function; the port starts
from the reference's parameters (``convert``).  Values and gradients are
held at rtol 1e-5 (atol 1e-6 of the scale), integers exactly; the rank
table's ids are int32 in the reference (jax without x64) and int64 in
the port, compared by value."""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert

RTOL, ATOL = 1e-5, 1e-6
T, B, D, H = 5, 3, 4, 6
LENGTHS = np.array([5, 2, 4], "int64")


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale)


def _data(fluid, name, shape, dtype="float32", grad=True):
    v = fluid.layers.data(name, shape=list(shape), dtype=dtype,
                          append_batch_size=False)
    v.stop_gradient = not grad
    return v


def _cell(fluid, x_t, h):
    return fluid.layers.fc(
        fluid.layers.concat([x_t, h], axis=1), size=H, act="tanh",
        param_attr=fluid.ParamAttr(name="rnn.w"),
        bias_attr=fluid.ParamAttr(name="rnn.b"))


def _static_rnn(fluid):
    """A StaticRNN over x [T, B, D]: memory h from h0, memory z filled
    with 0.5 from the batch; outputs h and z stacked; the loss and the
    gradients of x, h0 and the step's parameters."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = _data(fluid, "x", [T, B, D])
        h0 = _data(fluid, "h0", [B, H])
        rnn = fluid.layers.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h = rnn.memory(init=h0)
            z = rnn.memory(shape=[H], batch_ref=x_t, init_value=0.5)
            hn = _cell(fluid, x_t, h)
            zn = fluid.layers.elementwise_mul(z, hn)
            rnn.update_memory(h, hn)
            rnn.update_memory(z, zn)
            rnn.step_output(hn)
            rnn.step_output(zn)
        hs, zs = rnn()
        loss = fluid.layers.elementwise_add(
            fluid.layers.reduce_sum(fluid.layers.elementwise_mul(hs, hs)),
            fluid.layers.reduce_sum(zs))
        block = main.global_block()
        grads = fluid.backward.gradients(
            [loss], [x, h0, block.var("rnn.w"), block.var("rnn.b")])
    return main, startup, [hs, zs, loss] + grads


def _dynamic_rnn(fluid, init_from_var=True):
    """A DynamicRNN over x [B, T, D] of LENGTHS, a static input s [B, H]
    added every step, a memory from h0 (or filled with 0.25)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = _data(fluid, "x", [B, T, D])
        h0 = _data(fluid, "h0", [B, H])
        s = _data(fluid, "s", [B, H])
        lens = _data(fluid, "lens", [B], "int64", grad=False)
        drnn = fluid.layers.DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(x, lengths=lens)
            st = drnn.static_input(s)
            h = drnn.memory(init=h0) if init_from_var \
                else drnn.memory(shape=[H], value=0.25)
            hn = fluid.layers.elementwise_add(_cell(fluid, x_t, h), st)
            drnn.update_memory(h, hn)
            drnn.output(hn)
        hs = drnn()
        loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(hs, hs))
        block = main.global_block()
        wrt = [x, s, block.var("rnn.w"), block.var("rnn.b")] \
            + ([h0] if init_from_var else [])
        grads = fluid.backward.gradients([loss], wrt)
    return main, startup, [hs, loss] + grads


def _feed(dynamic):
    rng = np.random.RandomState(11)
    shape = (B, T, D) if dynamic else (T, B, D)
    feed = {"x": rng.randn(*shape).astype("float32"),
            "h0": rng.randn(B, H).astype("float32")}
    if dynamic:
        feed["s"] = (0.1 * rng.randn(B, H)).astype("float32")
        feed["lens"] = LENGTHS
    return feed


def _run_both(build, feed, runs=1, cache=True):
    """``build(fluid)`` in both packages, the port from the reference's
    parameters → {package: [each run's fetches]}, the port's executor."""
    out, start, exe_t = {}, None, None
    for label, fluid in (("reference", jfluid), ("port", tfluid)):
        fluid.unique_name.switch()
        main, startup, fetch = build(fluid)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        kw = {}
        with fluid.scope_guard(scope):
            exe.run(startup)
            if label == "reference":
                start = convert.scope_persistables(main, scope)
            else:
                convert.load_params_into_scope(start, scope, "cpu",
                                               program=main)
                kw = {"use_program_cache": cache}
                exe_t = exe
            out[label] = [[np.asarray(v) for v in exe.run(
                main, feed=feed, fetch_list=fetch, **kw)]
                for _ in range(runs)]
    return out, exe_t


def _same(out):
    for got, want in zip(out["port"], out["reference"]):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)


def test_static_rnn_forward_and_grads():
    out, exe = _run_both(_static_rnn, _feed(False))
    _same(out)
    hs, zs = out["port"][0][:2]
    assert hs.shape == (T, B, H) and zs.shape == (T, B, H)
    # every gradient, the captured parameters' among them, is non-zero
    assert all(np.abs(g).max() > 0 for g in out["port"][0][3:])
    assert exe.last_loops == []


@pytest.mark.parametrize("init_from_var", [True, False],
                         ids=["memory_from_var", "memory_filled"])
def test_dynamic_rnn_forward_and_grads(init_from_var):
    out, _ = _run_both(lambda f: _dynamic_rnn(f, init_from_var),
                       _feed(True))
    _same(out)
    hs = out["port"][0][0]
    assert hs.shape == (B, T, H)
    # the padded steps' outputs are zero, the real ones are not
    for b, n in enumerate(LENGTHS):
        assert not hs[b, n:].any() and np.abs(hs[b, :n]).min() > 0
    assert all(np.abs(g).max() > 0 for g in out["port"][0][2:])


def test_dynamic_rnn_x_grad_is_zero_past_each_length():
    out, _ = _run_both(_dynamic_rnn, _feed(True))
    gx = out["port"][0][2]
    for b, n in enumerate(LENGTHS):
        assert not gx[b, n:].any() and np.abs(gx[b, :n]).max() > 0


def test_recurrent_ops_and_grad_op_in_the_reference_form():
    """The port builds the reference's ``recurrent`` and
    ``recurrent_grad`` ops: types, slots and attrs."""
    progs = {}
    for label, fluid in (("reference", jfluid), ("port", tfluid)):
        fluid.unique_name.switch()
        main, _, _ = _dynamic_rnn(fluid)
        progs[label] = [
            (op.type, {k: list(v) for k, v in op.inputs.items()},
             {k: list(v) for k, v in op.outputs.items()},
             {k: v for k, v in op.attrs.items()
              if not k.startswith("__") and k not in ("op_role",
                                                      "op_namescope")})
            for op in main.global_block().ops
            if op.type.startswith("recurrent")]
    assert [p[0] for p in progs["port"]] == ["recurrent", "recurrent_grad"]
    assert progs["port"] == progs["reference"]


def _rank_table(fluid, grad=False):
    """The rank-table ops on lengths [B] and a padded x [B, T, D]: the
    longest length, x as an array of its steps and back, a state passed
    through ``shrink_rnn_memory``, x reordered by descending length, and
    with ``grad`` the gradient through the reorder."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        block = main.global_block()
        x = _data(fluid, "x", [B, T, D])
        h = _data(fluid, "h", [B, H], grad=False)
        lens = _data(fluid, "lens", [B], "int64", grad=False)
        i = fluid.layers.fill_constant([1], "int64", 1)
        names = ("rank", "max2", "max1", "arr", "back", "shrunk")
        v = {n: block.create_var(name=n, dtype="int64") for n in names}
        for n in names:
            v[n].stop_gradient = True
        block.append_op(type="lod_rank_table", inputs={"X": [lens]},
                        outputs={"Out": [v["rank"]]}, attrs={"level": 0})
        block.append_op(type="max_sequence_len2",
                        inputs={"RankTable": [v["rank"]]},
                        outputs={"Out": [v["max2"]]})
        block.append_op(type="max_sequence_len",
                        inputs={"RankTable": [lens]},
                        outputs={"Out": [v["max1"]]})
        block.append_op(type="lod_tensor_to_array",
                        inputs={"X": [x], "RankTable": [v["rank"]]},
                        outputs={"Out": [v["arr"]]})
        block.append_op(type="array_to_lod_tensor",
                        inputs={"X": [v["arr"]], "RankTable": [v["rank"]]},
                        outputs={"Out": [v["back"]]})
        block.append_op(type="shrink_rnn_memory",
                        inputs={"X": [h], "RankTable": [v["rank"]],
                                "I": [i]},
                        outputs={"Out": [v["shrunk"]]})
        step = fluid.layers.array_read(v["arr"], i)
        sorted_x = fluid.layers.reorder_lod_tensor_by_rank(x, v["rank"])
        fetch = [v["max2"], v["max1"], v["back"], v["shrunk"], step,
                 sorted_x]
        if grad:
            w = fluid.layers.assign(np.arange(B * T * D, dtype="float32")
                                    .reshape(B, T, D))
            loss = fluid.layers.reduce_sum(
                fluid.layers.elementwise_mul(sorted_x, w))
            fetch += fluid.backward.gradients([loss], [x])
    return main, startup, fetch


def _rank_feed():
    rng = np.random.RandomState(12)
    return {"x": rng.randn(B, T, D).astype("float32"),
            "h": rng.randn(B, H).astype("float32"), "lens": LENGTHS}


def test_rank_table_ops():
    feed = _rank_feed()
    out, _ = _run_both(_rank_table, feed)
    got, want = out["port"][0], out["reference"][0]
    for g, w in zip(got, want):
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64))
        else:
            _close(g, w)
    max2, max1, back, shrunk, step, sorted_x = got
    assert int(max2[0]) == int(max1[0]) == 5 and max2.dtype == np.int64
    np.testing.assert_array_equal(back, feed["x"])
    np.testing.assert_array_equal(shrunk, feed["h"])
    np.testing.assert_array_equal(step, feed["x"][:, 1])
    # descending length, ties by row: rows 0 (5), 2 (4), 1 (2)
    np.testing.assert_array_equal(sorted_x, feed["x"][[0, 2, 1]])


def test_reorder_by_rank_gradient():
    """The reorder's gradient puts each row's back where it came from
    (the reference's generic grad fails on its dict-valued rank table,
    so this one is held to its closed form)."""
    tfluid.unique_name.switch()
    main, startup, fetch = _rank_table(tfluid, grad=True)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        gx = np.asarray(exe.run(main, feed=_rank_feed(),
                                fetch_list=fetch)[-1])
    w = np.arange(B * T * D, dtype="float32").reshape(B, T, D)
    np.testing.assert_array_equal(gx, w[[0, 2, 1]])


def _train_program(fluid, dynamic):
    """A step's loss through a StaticRNN or a DynamicRNN, Adam."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = _data(fluid, "x", [B, T, D] if dynamic else [T, B, D],
                  grad=False)
        h0 = _data(fluid, "h0", [B, H], grad=False)
        if dynamic:
            lens = _data(fluid, "lens", [B], "int64", grad=False)
            rnn = fluid.layers.DynamicRNN()
            with rnn.block():
                x_t = rnn.step_input(x, lengths=lens)
                h = rnn.memory(init=h0)
                hn = _cell(fluid, x_t, h)
                rnn.update_memory(h, hn)
                rnn.output(hn)
        else:
            rnn = fluid.layers.StaticRNN()
            with rnn.step():
                x_t = rnn.step_input(x)
                h = rnn.memory(init=h0)
                hn = _cell(fluid, x_t, h)
                rnn.update_memory(h, hn)
                rnn.step_output(hn)
        loss = fluid.layers.reduce_mean(
            fluid.layers.elementwise_mul(rnn(), rnn()))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, [loss]


@pytest.mark.parametrize("dynamic", [False, True],
                         ids=["static_rnn", "dynamic_rnn"])
def test_training_through_the_executor_cache(dynamic):
    """Four Adam steps of a program with a ``recurrent`` and its grad:
    through the cache, warm-up, capture, then replays (a CUDA graph on
    the card: the step count is static, nothing is read on the host),
    bit for bit the eager executor's losses and parameters, no loop
    record; and within the tolerances of the reference's."""
    feed = _feed(dynamic)
    feed.pop("s", None)
    results = {}
    for cache in (True, False):
        tfluid.unique_name.switch()
        main, startup, fetch = _train_program(tfluid, dynamic)
        startup.random_seed = 7
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        with tfluid.scope_guard(scope):
            exe.run(startup)
            losses, modes = [], []
            for _ in range(4):
                losses.append(np.asarray(exe.run(
                    main, feed=feed, fetch_list=fetch,
                    use_program_cache=cache)[0]))
                modes.append(exe.last_run_mode)
                assert exe.last_loops == []
            state = convert.scope_persistables(main, scope)
        results[cache] = (losses, modes, state)
    (got, modes, got_state), (want, eager, want_state) = \
        results[True], results[False]
    assert modes == ["eager", "capture", "graph", "graph"]
    assert eager == ["eager"] * 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert set(got_state) == set(want_state) and len(got_state) > 4
    for n in want_state:
        np.testing.assert_array_equal(got_state[n], want_state[n], n)
    assert got[-1][0] < got[0][0]
    out, _ = _run_both(lambda f: _train_program(f, dynamic), feed, runs=4)
    _same(out)
