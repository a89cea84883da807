"""The everyday tensor ops and their ``fluid.layers`` front ends of the
PyTorch port against the reference: ``stack`` / ``unstack``,
``flatten`` (``flatten2``), ``reduce_min`` / ``reduce_prod``, ``sum`` /
``sums``, ``mul``, ``zeros`` / ``ones`` / ``zeros_like`` / ``ones_like``
(``fill_constant``, ``fill_any_like``), ``fill_zeros_like``, ``argmax``
/ ``argmin`` / ``argsort``, ``log``, ``square`` and
``sigmoid_cross_entropy_with_logits``.

Each case builds the same layers in both packages on seeded numpy feeds
and fetches every output and, where the outputs are floating, the
gradients of ``sum(out_i * cot_i)`` (seeded cotangents) with respect to
the differentiable feeds.  Integer outputs must match exactly (ties
included: the first index wins in ``arg_max`` / ``arg_min``, and
``argsort`` is stable, as jax's); floats within 1e-6 of the larger of 1
and the reference's largest magnitude.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.executor import Scope as JScope

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.executor import Scope

TOL = 1e-6


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if np.issubdtype(ref.dtype, np.integer) or ref.dtype == np.bool_:
        np.testing.assert_array_equal(got, ref, err_msg=what)
        return
    got, ref = got.astype(np.float64), ref.astype(np.float64)
    if not got.size:
        return
    err = float(np.abs(got - ref).max())
    assert err <= TOL * max(1.0, float(np.abs(ref).max())), (what, err)


def _run(fluid, build, feeds, grad_feeds):
    fluid.unique_name.switch()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ins = {n: fluid.layers.data(n, shape=list(v.shape),
                                    dtype=str(v.dtype),
                                    append_batch_size=False,
                                    stop_gradient=n not in grad_feeds)
               for n, v in feeds.items()}
        outs = build(fluid, ins)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        floats = [o for o in outs if o.dtype in ("float32", "float64")]
        cots = {}
        if grad_feeds and floats:
            terms = []
            for i, o in enumerate(floats):
                c = fluid.layers.data("cot%d" % i, shape=list(o.shape),
                                      dtype="float32",
                                      append_batch_size=False)
                cots[c.name] = np.random.RandomState(10 + i).randn(
                    *o.shape).astype("float32")
                terms.append(fluid.layers.reduce_sum(
                    fluid.layers.elementwise_mul(o, c)))
            loss = fluid.layers.sums(terms) if len(terms) > 1 else terms[0]
            fluid.backward.append_backward(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = JScope() if fluid is jfluid else Scope()
    exe.run(startup, scope=scope)
    fetch = outs + [n + "@GRAD" for n in grad_feeds] if cots else outs
    res = exe.run(main, feed=dict(feeds, **cots), fetch_list=fetch,
                  scope=scope)
    return [np.asarray(r) for r in res]


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _ties(seed=0):
    """[4, 6] float32 with repeated values in every row."""
    return np.random.RandomState(seed).randint(
        0, 3, (4, 6)).astype("float32")


def _fill_zeros_like(fluid, x):
    helper = fluid.layer_helper.LayerHelper("fill_zeros_like")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="fill_zeros_like", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


CASES = {
    "stack": (lambda f, v: f.layers.stack([v["a"], v["b"], v["c"]],
                                          axis=1),
              {"a": _x(3, 4), "b": _x(3, 4, seed=1),
               "c": _x(3, 4, seed=2)}, ["a", "b", "c"]),
    "unstack": (lambda f, v: f.layers.unstack(v["x"], axis=1),
                {"x": _x(2, 3, 4)}, ["x"]),
    "flatten": (lambda f, v: f.layers.flatten(v["x"], axis=2),
                {"x": _x(2, 3, 4, 5)}, ["x"]),
    "reduce_min": (lambda f, v: f.layers.reduce_min(v["x"], dim=1),
                   {"x": _ties()}, ["x"]),
    "reduce_min_all": (lambda f, v: f.layers.reduce_min(v["x"]),
                       {"x": _x(3, 4)}, ["x"]),
    "reduce_prod": (lambda f, v: f.layers.reduce_prod(v["x"], dim=[1],
                                                      keep_dim=True),
                    {"x": _x(3, 4, 2)}, ["x"]),
    "reduce_prod_two_dims": (lambda f, v: f.layers.reduce_prod(
        v["x"], dim=[0, 2]), {"x": _x(3, 2, 3)}, ["x"]),
    "sum": (lambda f, v: f.layers.sum([v["a"], v["b"], v["c"]]),
            {"a": _x(3, 4), "b": _x(3, 4, seed=1), "c": _x(3, 4, seed=2)},
            ["a", "b", "c"]),
    "sums": (lambda f, v: f.layers.sums([v["a"], v["b"]]),
             {"a": _x(5, 1), "b": _x(5, 1, seed=1)}, ["a", "b"]),
    "mul": (lambda f, v: f.layers.mul(v["x"], v["y"], x_num_col_dims=2),
            {"x": _x(2, 3, 4), "y": _x(4, 5, seed=1)}, ["x", "y"]),
    "zeros_ones": (lambda f, v: [f.layers.zeros([2, 3], "float32"),
                                 f.layers.ones([4], "int64")], {}, []),
    "zeros_like_ones_like": (
        lambda f, v: [f.layers.zeros_like(v["x"]),
                      f.layers.ones_like(v["i"])],
        {"x": _x(3, 2), "i": np.arange(6, dtype="int64").reshape(2, 3)},
        []),
    "fill_zeros_like": (lambda f, v: _fill_zeros_like(f, v["x"]),
                        {"x": _x(2, 5)}, []),
    "argmax_argmin": (lambda f, v: [f.layers.argmax(v["x"], axis=1),
                                    f.layers.argmin(v["x"], axis=0),
                                    f.layers.argmax(v["y"], axis=-1)],
                      {"x": _ties(), "y": _x(2, 3, 5)}, []),
    "argsort": (lambda f, v: list(f.layers.argsort(v["x"], axis=1))
                + list(f.layers.argsort(v["y"], axis=0)),
                {"x": _ties(), "y": _x(5, 3)}, []),
    "log_square": (lambda f, v: [f.layers.log(v["p"]),
                                 f.layers.square(v["x"])],
                   {"p": np.abs(_x(3, 4)) + 0.1, "x": _x(3, 4, seed=1)},
                   ["p", "x"]),
    "sigmoid_xent": (
        lambda f, v: f.layers.sigmoid_cross_entropy_with_logits(
            v["x"], v["z"]),
        {"x": 3 * _x(6, 1), "z": np.random.RandomState(4).randint(
            0, 2, (6, 1)).astype("float32")}, ["x"]),
    "sigmoid_xent_ignore_normalize": (
        lambda f, v: f.layers.sigmoid_cross_entropy_with_logits(
            v["x"], v["z"], ignore_index=-1, normalize=True),
        {"x": 3 * _x(4, 3), "z": np.array(
            [[1, 0, -1], [0, -1, 1], [1, 1, 0], [-1, 0, 0]], "float32")},
        ["x"]),
    "sigmoid_xent_int64_label_cast": (
        lambda f, v: f.layers.mean(f.layers.sigmoid_cross_entropy_with_logits(
            v["x"], f.layers.cast(v["z"], "float32"))),
        {"x": _x(8, 1), "z": np.random.RandomState(5).randint(
            0, 2, (8, 1)).astype("int64")}, ["x"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tensor_layer_matches_reference(case):
    build, feeds, grad_feeds = CASES[case]
    ref = _run(jfluid, build, feeds, grad_feeds)
    got = _run(tfluid, build, feeds, grad_feeds)
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        _close(g, r, "%s fetch %d" % (case, i))


def test_every_new_op_type_is_registered_with_its_grad():
    from paddle_tpu_torch.ops import registry

    with_grad = ("stack", "unstack", "flatten", "flatten2", "reduce_min",
                 "reduce_prod", "log", "square",
                 "sigmoid_cross_entropy_with_logits")
    no_grad = ("arg_max", "arg_min", "argsort", "fill_any_like",
               "fill_zeros_like")
    for t in with_grad:
        assert registry.has_op(t) and registry.has_op(t + "_grad"), t
    for t in no_grad:
        assert registry.get_op_def(t).no_grad, t
