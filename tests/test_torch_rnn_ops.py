"""The recurrent and tensor ops of the NMT and stacked-LSTM models in the
PyTorch port against the reference, on the CPU: ``lstm`` / ``dynamic_lstm``
(with and without peepholes, masks and ``is_reverse``), ``gru`` /
``dynamic_gru``, ``lstm_unit``, ``sequence_mask``, ``split``, ``expand``,
``log_softmax``, ``reduce_mean`` and ``reduce_max``.

Each case is one op in a program of each package, built from the same
slots and attrs, fed the same seeded numpy inputs; the loss is the sum
of the squares of its float outputs, and ``backward.gradients`` gives the
gradients of the float inputs (the reference's ``append_backward``
machinery, the port's generic grad through autograd).  Forward values and
gradients are held at rtol 1e-5 (atol 1e-6 of the value's scale);
integer outputs exactly."""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid

RTOL, ATOL = 1e-5, 1e-6
PACKAGES = (("reference", jfluid), ("port", tfluid))
B, T, D = 3, 5, 4
LENGTHS = np.array([5, 2, 4], "int64")


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale)


def _run_op(fluid, op_type, inputs, outputs, attrs):
    """One ``op_type`` op over data vars ``inputs`` ({slot: [(name,
    array)]}) writing ``outputs`` ({slot: [(name, dtype)]}) → its
    outputs, then the gradients of the squared sum of its float outputs
    with respect to its float inputs, as numpy."""
    fluid.unique_name.switch()
    main, startup = fluid.Program(), fluid.Program()
    feed, wrt = {}, []
    with fluid.program_guard(main, startup):
        block = main.global_block()
        ins = {}
        for slot, items in inputs.items():
            names = []
            for name, arr in items:
                v = fluid.layers.data(name, shape=list(arr.shape),
                                      dtype=str(arr.dtype),
                                      append_batch_size=False)
                if arr.dtype.kind == "f":
                    v.stop_gradient = False
                    wrt.append(v)
                feed[name] = arr
                names.append(name)
            ins[slot] = names
        outs, floats = {}, []
        for slot, items in outputs.items():
            outs[slot] = []
            for name, dtype in items:
                v = block.create_var(name=name, dtype=dtype)
                outs[slot].append(name)
                if dtype.startswith("float"):
                    floats.append(v)
        block.append_op(type=op_type, inputs=ins, outputs=outs,
                        attrs=dict(attrs))
        fetch = [n for names in outs.values() for n in names]
        grads = []
        if floats and wrt:
            loss = None
            for v in floats:
                sq = fluid.layers.reduce_sum(
                    fluid.layers.elementwise_mul(v, v))
                loss = sq if loss is None \
                    else fluid.layers.elementwise_add(loss, sq)
            grads = fluid.backward.gradients([loss], wrt)
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        got = exe.run(main, feed=feed, fetch_list=fetch + grads)
    got = [np.asarray(g) for g in got]
    return got[:len(fetch)], got[len(fetch):]


def _both(op_type, inputs, outputs, attrs, exact=False):
    res = {label: _run_op(fluid, op_type, inputs, outputs, attrs)
           for label, fluid in PACKAGES}
    (jout, jgrad), (tout, tgrad) = res["reference"], res["port"]
    assert len(tout) == len(jout) and len(tgrad) == len(jgrad)
    for g, w in zip(tout, jout):
        if exact or w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w)
        else:
            _close(g, w)
    for g, w in zip(tgrad, jgrad):
        _close(g, w)
    return tout, tgrad


def _rng(seed):
    return np.random.RandomState(seed)


def _f32(rng, *shape, scale=0.5):
    return (rng.randn(*shape) * scale).astype("float32")


LSTM_CASES = [
    # (op type, peepholes, with SeqLen, is_reverse, with H0/C0)
    ("lstm", True, True, False, True),
    ("lstm", True, True, True, True),
    ("lstm", False, False, False, False),
    ("dynamic_lstm", False, True, True, True),
    ("dynamic_lstm", True, False, True, False),
]


@pytest.mark.parametrize("op_type,peep,masked,reverse,init", LSTM_CASES)
def test_lstm(op_type, peep, masked, reverse, init):
    rng = _rng(1)
    inputs = {"Input": [("x", _f32(rng, B, T, 4 * D))],
              "Weight": [("w", _f32(rng, D, 4 * D))],
              "Bias": [("b", _f32(rng, 1, (7 if peep else 4) * D))]}
    if init:
        inputs["H0"] = [("h0", _f32(rng, B, D))]
        inputs["C0"] = [("c0", _f32(rng, B, D))]
    if masked:
        inputs["SeqLen"] = [("len", LENGTHS)]
    out, grads = _both(op_type, inputs,
                       {"Hidden": [("hidden", "float32")],
                        "Cell": [("cell", "float32")]},
                       {"use_peepholes": peep, "is_reverse": reverse,
                        "gate_activation": "sigmoid",
                        "cell_activation": "tanh",
                        "candidate_activation": "tanh"})
    assert out[0].shape == (B, T, D)
    if masked and not reverse:
        # a row past its length keeps the state of its last real step
        n = LENGTHS[1]
        for y in out:
            np.testing.assert_array_equal(
                y[1, n:], np.broadcast_to(y[1, n - 1], y[1, n:].shape))
    assert all(np.abs(g).max() > 0 for g in grads)


GRU_CASES = [("gru", False, False, False), ("gru", True, False, True),
             ("dynamic_gru", True, True, True),
             ("dynamic_gru", False, True, False)]


@pytest.mark.parametrize("op_type,masked,reverse,init", GRU_CASES)
def test_gru(op_type, masked, reverse, init):
    rng = _rng(2)
    inputs = {"Input": [("x", _f32(rng, B, T, 3 * D))],
              "Weight": [("w", _f32(rng, D, 3 * D))],
              "Bias": [("b", _f32(rng, 1, 3 * D))]}
    if init:
        inputs["H0"] = [("h0", _f32(rng, B, D))]
    if masked:
        inputs["SeqLen"] = [("len", LENGTHS)]
    out, grads = _both(op_type, inputs, {"Hidden": [("hidden", "float32")]},
                       {"is_reverse": reverse, "gate_activation": "sigmoid",
                        "activation": "tanh"})
    assert out[0].shape == (B, T, D)
    assert all(np.abs(g).max() > 0 for g in grads)


def test_gru_applies_the_reset_gate_before_the_candidate_product():
    """The reference's formula, not cuDNN's: with a zero input and a
    reset gate of sigmoid(0) = 1/2, the candidate reads (h/2) W_c, so one
    step from h0 is u h0 + (1 - u) tanh((h0 / 2) W_c)."""
    rng = _rng(3)
    h0 = _f32(rng, B, D, scale=1.0)
    w = _f32(rng, D, 3 * D, scale=1.0)
    w[:, :2 * D] = 0.0  # u = r = 1/2
    out, _ = _both("gru", {"Input": [("x", np.zeros((B, 1, 3 * D),
                                                    "float32"))],
                           "H0": [("h0", h0)], "Weight": [("w", w)]},
                   {"Hidden": [("hidden", "float32")]}, {})
    want = 0.5 * h0 + 0.5 * np.tanh((0.5 * h0) @ w[:, 2 * D:])
    _close(out[0][:, 0], want)


def test_lstm_unit():
    rng = _rng(4)
    _both("lstm_unit", {"X": [("x", _f32(rng, B, 4 * D))],
                        "C_prev": [("c", _f32(rng, B, D))]},
          {"C": [("c_out", "float32")], "H": [("h_out", "float32")]},
          {"forget_bias": 0.5})


@pytest.mark.parametrize("dtype", ["int64", "float32", "bool"])
def test_sequence_mask(dtype):
    out, _ = _both("sequence_mask", {"X": [("len", np.array([0, 3, 6, 2],
                                                            "int64"))]},
                   {"Y": [("y", dtype)]}, {"maxlen": 6, "out_dtype": dtype},
                   exact=True)
    assert out[0].shape == (4, 6) and int(out[0].astype(int).sum()) == 11


@pytest.mark.parametrize("attrs,n", [({"num": 2, "axis": 1, "sections": []},
                                      2),
                                     ({"num": 0, "axis": 1,
                                       "sections": [2, 3, 5]}, 3),
                                     ({"num": 3, "axis": 0,
                                       "sections": []}, 3)])
def test_split(attrs, n):
    x = _f32(_rng(5), 3, 10)
    out, grads = _both("split", {"X": [("x", x)]},
                       {"Out": [("out%d" % i, "float32")
                                for i in range(n)]}, attrs)
    assert len(out) == n
    np.testing.assert_array_equal(np.concatenate(out, axis=attrs["axis"]),
                                  x)
    _close(grads[0], 2 * x)


@pytest.mark.parametrize("times", [[1, 4, 2], [3, 1, 1], [2, 2]])
def test_expand(times):
    rng = _rng(6)
    out, _ = _both("expand", {"X": [("x", _f32(rng, 2, 1, 3))]},
                   {"Out": [("out", "float32")]}, {"expand_times": times})
    assert out[0].shape == tuple(np.tile(np.zeros((2, 1, 3)), times).shape)


@pytest.mark.parametrize("axis", [-1, 0, 1])
def test_log_softmax(axis):
    rng = _rng(7)
    _both("log_softmax", {"X": [("x", _f32(rng, 3, 7, 2, scale=3.0))]},
          {"Out": [("out", "float32")]}, {"axis": axis})


REDUCE_CASES = [
    ("reduce_mean", {"dim": [1], "keep_dim": False, "reduce_all": False}),
    ("reduce_mean", {"dim": [0, 2], "keep_dim": True, "reduce_all": False}),
    ("reduce_mean", {"dim": [0], "keep_dim": False, "reduce_all": True}),
    ("reduce_max", {"dim": [1], "keep_dim": False, "reduce_all": False}),
    ("reduce_max", {"dim": [1, 2], "keep_dim": True, "reduce_all": False}),
    ("reduce_max", {"dim": [0], "keep_dim": False, "reduce_all": True}),
]


@pytest.mark.parametrize("op_type,attrs", REDUCE_CASES)
def test_reductions(op_type, attrs):
    rng = _rng(8)
    x = _f32(rng, 3, 4, 5)
    x[1, 2, :2] = x[1, :, :2].max(axis=0) + 1.0  # ties of the max ...
    x[1, 3, :2] = x[1, 2, :2]                    # ... along dim 1
    _both(op_type, {"X": [("x", x)]}, {"Out": [("out", "float32")]}, attrs)
