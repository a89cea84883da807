"""The everyday basic, math and shape ops of the PyTorch port against
the reference (``paddle_tpu/ops/basic.py``, ``math.py``,
``tensor_manip.py`` and ``extra.py``'s ``diag``): each op, or its
``fluid.layers`` front end where it has one, on seeded numpy feeds,
forward and the gradient of ``sum(out * cot)``; floats within 1e-6 of
max(1, |ref|), integers and bools exact.  ``randint`` draws on the
device in the port and with jax's generator in the reference, so it is
held to its shape, dtype, range and moments, and to a fresh draw each
step; ``shape`` is a fill from metadata, captured whole."""

import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.ops import registry as t_registry

from torch_parity_helpers import append, ints, run_layers, run_pair, x


def _dups():
    return np.array([[1], [3], [1], [0], [3], [1]], "int64")


CASES = {
    "maximum": (lambda f, v: append(f, "maximum", {"X": v["a"], "Y": v["b"]}),
                {"a": x(3, 4), "b": x(3, 4, seed=1)}, ["a", "b"]),
    "minimum": (lambda f, v: append(f, "minimum", {"X": v["a"], "Y": v["b"]}),
                {"a": x(3, 4), "b": x(3, 4, seed=1)}, ["a", "b"]),
    "maximum_ties": (lambda f, v: append(f, "maximum",
                                         {"X": v["a"], "Y": v["b"]}),
                     {"a": np.ones((2, 3), "float32"),
                      "b": np.ones((2, 3), "float32")}, ["a", "b"]),
    "isfinite_has_inf_has_nan": (
        lambda f, v: [f.layers.isfinite(v["a"]), f.layers.has_inf(v["a"]),
                      f.layers.has_nan(v["a"]), f.layers.isfinite(v["b"]),
                      f.layers.has_inf(v["b"]), f.layers.has_nan(v["b"])],
        {"a": x(3, 4), "b": np.array([[1.0, np.inf], [np.nan, 0.0]],
                                     "float32")}, []),
    "isfinite_two_inputs": (
        lambda f, v: append(f, "isfinite", {"X": [v["a"], v["b"]]},
                            dtype="bool"),
        {"a": x(3), "b": np.array([1.0, -np.inf], "float32")}, []),
    "linspace": (lambda f, v: [f.layers.linspace(-1.5, 2.0, 7, "float32"),
                               f.layers.linspace(0, 10, 4, "int32"),
                               f.layers.linspace(3.0, 3.0, 1, "float32")],
                 {}, []),
    "shape": (lambda f, v: [f.layers.shape(v["x"]), f.layers.shape(v["y"])],
              {"x": x(2, 3, 4), "y": x(5)}, []),
    "share_data": (lambda f, v: append(f, "share_data", {"X": v["x"]}),
                   {"x": x(3, 4)}, ["x"]),
    "reshape_v1": (lambda f, v: append(f, "reshape", {"X": v["x"]},
                                       {"shape": [0, -1, 2]}),
                   {"x": x(2, 3, 4)}, ["x"]),
    "transpose_v1": (lambda f, v: append(f, "transpose", {"X": v["x"]},
                                         {"axis": [2, 0, 1]}),
                     {"x": x(2, 3, 4)}, ["x"]),
    "squeeze_v1": (lambda f, v: append(f, "squeeze", {"X": v["x"]},
                                       {"axes": [1, 3]}),
                   {"x": x(2, 1, 4, 1)}, ["x"]),
    "unsqueeze_v1": (lambda f, v: append(f, "unsqueeze", {"X": v["x"]},
                                         {"axes": [0, 2]}),
                     {"x": x(3, 4)}, ["x"]),
    "gather_nd": (lambda f, v: f.layers.gather_nd(v["x"], v["i"]),
                  {"x": x(4, 5, 3), "i": np.array(
                      [[[0, 1], [3, 4]], [[2, 2], [1, 0]]], "int64")},
                  ["x"]),
    "gather_nd_rows": (lambda f, v: f.layers.gather_nd(v["x"], v["i"]),
                       {"x": x(6, 3), "i": ints(0, 6, (4, 1))}, ["x"]),
    "scatter_overwrite_duplicates": (
        lambda f, v: f.layers.scatter(v["x"], v["i"], v["u"]),
        {"x": x(5, 3), "i": _dups(), "u": x(6, 3, seed=1)}, ["x", "u"]),
    "scatter_add_duplicates": (
        lambda f, v: f.layers.scatter(v["x"], v["i"], v["u"],
                                      overwrite=False),
        {"x": x(5, 3), "i": _dups(), "u": x(6, 3, seed=1)}, ["x", "u"]),
    "expand_as": (lambda f, v: append(f, "expand_as", {
        "X": v["x"], "target_tensor": v["t"]}),
        {"x": x(2, 1, 3), "t": x(4, 3, 6, seed=1)}, ["x"]),
    "tile": (lambda f, v: append(f, "tile", {"X": v["x"]},
                                 {"repeat_times": [2, 1, 3]}),
             {"x": x(2, 3)}, ["x"]),
    "reverse": (lambda f, v: [f.layers.reverse(v["x"], 1),
                              f.layers.reverse(v["x"], [0, 2])],
                {"x": x(2, 3, 4)}, ["x"]),
    "lod_reset": (lambda f, v: f.layers.lod_reset(v["x"], v["y"]),
                  {"x": x(4, 3), "y": ints(0, 4, (3,))}, ["x"]),
    "im2sequence": (lambda f, v: f.layers.im2sequence(
        v["x"], filter_size=[2, 3], stride=[1, 2], padding=[1, 0, 0, 1]),
        {"x": x(2, 3, 5, 6)}, []),
    "diag": (lambda f, v: f.layers.diag(v["d"]), {"d": x(5)}, []),
    "diag_numpy": (lambda f, v: f.layers.diag(np.arange(3.0).astype(
        "float32")), {}, []),
}

for _mode in ("constant", "reflect", "edge"):
    for _fmt in ("NCHW", "NHWC"):
        CASES["pad2d_%s_%s" % (_mode, _fmt)] = (
            lambda f, v, m=_mode, d=_fmt: f.layers.pad2d(
                v["x"], paddings=[1, 2, 2, 1], mode=m, pad_value=0.5,
                data_format=d),
            {"x": x(2, 3, 4, 5)}, ["x"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_everyday_op_matches_reference(case):
    build, feeds, grad_feeds = CASES[case]
    run_pair(build, feeds, grad_feeds, what=case)


def test_scatter_overwrite_keeps_the_last_duplicate():
    got, _ = run_pair(lambda f, v: f.layers.scatter(v["x"], v["i"], v["u"]),
                      {"x": np.zeros((4, 1), "float32"),
                       "i": np.array([2, 2, 2], "int64"),
                       "u": np.array([[1.0], [2.0], [3.0]], "float32")},
                      [], what="scatter last")
    np.testing.assert_array_equal(got[0][:, 0], [0, 0, 3, 0])


def test_new_ops_are_registered_with_the_reference_flags():
    with_grad = ("maximum", "minimum", "share_data", "reshape", "transpose",
                 "squeeze", "unsqueeze", "gather_nd", "scatter", "expand_as",
                 "tile", "pad2d", "reverse", "lod_reset")
    no_grad = ("isfinite", "isinf", "isnan", "linspace", "shape", "randint",
               "im2sequence", "diag")
    for t in with_grad:
        assert not t_registry.get_op_def(t).no_grad, t
        assert t_registry.has_op(t + "_grad"), t
    for t in no_grad:
        assert t_registry.get_op_def(t).no_grad, t


def _randint_program(fluid, seed=0):
    fluid.unique_name.switch()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        out = append(fluid, "randint", {}, {"shape": [64, 50], "low": -3,
                                            "high": 9, "seed": seed},
                     dtype="int64")
    return main, startup, out


def test_randint_range_moments_and_fresh_draws():
    """Uniform over [low, high): every value in range, every value hit,
    mean and variance of U{-3..8} within 5 standard errors; each step
    draws anew; a nonzero ``seed`` repeats."""
    from paddle_tpu_torch.executor import Scope

    main, startup, out = _randint_program(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = Scope()
    exe.run(startup, scope=scope)
    a, = exe.run(main, fetch_list=[out], scope=scope)
    b, = exe.run(main, fetch_list=[out], scope=scope)
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == (64, 50) and a.dtype == np.int64
    assert a.min() >= -3 and a.max() <= 8 and len(np.unique(a)) == 12
    n = a.size
    mean, var = 2.5, (12 ** 2 - 1) / 12.0
    assert abs(a.mean() - mean) < 5 * np.sqrt(var / n)
    assert abs(a.var() - var) < 5 * var * np.sqrt(2.0 / n)
    assert (a != b).mean() > 0.8
    main, startup, out = _randint_program(tfluid, seed=7)
    exe.run(startup, scope=scope)
    c, = exe.run(main, fetch_list=[out], scope=scope)
    d, = exe.run(main, fetch_list=[out], scope=scope)
    np.testing.assert_array_equal(c, d)


def test_shape_and_randint_keep_a_program_capturable():
    def build(fluid, v):
        return [fluid.layers.shape(v["x"]),
                append(fluid, "randint", {}, {"shape": [3]}, dtype="int64")]

    _, (main, _) = run_layers(tfluid, build, {"x": x(2, 3)}, [])
    for op in main.global_block().ops:
        d = t_registry.get_op_def(op.type)
        assert d.is_capturable(op.attrs, op.inputs), op.type
