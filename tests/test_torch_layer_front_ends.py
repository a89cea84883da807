"""The 73 ``fluid.layers`` names of this slice in the PyTorch port
against the reference (``paddle_tpu/layers/ops.py``, ``nn.py``,
``nn_extra.py``, ``nn_extra2.py``, ``tensor.py``): each exists with the
reference's signature and defaults, and the front ends that other
parity files do not reach (the compositions, the parameterised layers,
the creation layers and the random layers) build programs that compute
what the reference's compute, on the reference's parameters (copied with
``convert``), forward and gradient, floats within 1e-6 of max(1,
|ref|).  The random layers are held to the reference's declared shapes
and dtypes and to their ranges."""

import inspect

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.layers as j_layers

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.layers as t_layers

from torch_parity_helpers import ints, run_layers, run_pair, x

NAMES = """
abs acos add_position_encoding asin atan bilinear_tensor_product bpr_loss
brelu create_global_var create_tensor data_norm depthwise_conv2d diag
dice_loss elu erf gather_nd gaussian_random gaussian_random_batch_size_like
gru_unit hard_shrink hard_sigmoid hard_swish has_inf has_nan hash hsigmoid
huber_loss im2sequence isfinite kldiv_loss l2_normalize label_smooth
leaky_relu linspace lod_reset log_loss logsigmoid margin_rank_loss mean_iou
multiplex nce npair_loss pad2d prelu rank rank_loss reciprocal relu6 reverse
round row_conv rsqrt sampled_softmax_with_cross_entropy sampling_id scatter
selu shape sin smooth_l1 soft_relu softplus softshrink softsign
spectral_norm stanh swish tanh_shrink teacher_student_sigmoid_loss
thresholded_relu tree_conv uniform_random uniform_random_batch_size_like
""".split()


def test_the_slice_has_73_names():
    assert len(NAMES) == len(set(NAMES)) == 73


@pytest.mark.parametrize("name", NAMES)
def test_layer_has_the_reference_signature(name):
    got = inspect.signature(getattr(t_layers, name))
    want = inspect.signature(getattr(j_layers, name))
    assert got == want, (name, str(got), str(want))


def _tree_edges():
    """A 5-node tree (edges parent, child; a (0, 0) row pads), batch of
    2."""
    e = np.array([[0, 1], [0, 2], [1, 3], [1, 4], [0, 0]], "int32")
    return np.stack([e, e])


CASES = {
    "depthwise_conv2d": (lambda f, v: f.layers.depthwise_conv2d(
        v["x"], num_filters=6, filter_size=3, padding=1),
        {"x": x(2, 3, 6, 6)}, ["x"]),
    "depthwise_conv2d_nhwc": (lambda f, v: f.layers.depthwise_conv2d(
        v["x"], num_filters=4, filter_size=3, data_format="NHWC"),
        {"x": x(2, 5, 5, 4)}, ["x"]),
    "l2_normalize": (lambda f, v: f.layers.l2_normalize(v["x"], axis=1),
                     {"x": x(3, 5)}, ["x"]),
    "prelu_all": (lambda f, v: f.layers.prelu(v["x"], "all"),
                  {"x": x(2, 3, 4)}, ["x"]),
    "prelu_channel": (lambda f, v: f.layers.prelu(v["x"], "channel"),
                      {"x": x(2, 3, 4, 4)}, ["x"]),
    "prelu_element": (lambda f, v: f.layers.prelu(v["x"], "element"),
                      {"x": x(2, 3, 4)}, ["x"]),
    "row_conv": (lambda f, v: f.layers.row_conv(v["x"], 2, act="relu"),
                 {"x": x(2, 5, 3)}, ["x"]),
    "spectral_norm": (lambda f, v: f.layers.spectral_norm(
        v["w"], dim=1, power_iters=3), {"w": x(4, 6, 2)}, ["w"]),
    "tree_conv": (lambda f, v: f.layers.tree_conv(
        v["n"], v["e"], output_size=4, max_depth=2),
        {"n": x(2, 5, 3), "e": _tree_edges()}, ["n"]),
    "bilinear_tensor_product": (
        lambda f, v: f.layers.bilinear_tensor_product(v["a"], v["b"], 3,
                                                      act="tanh"),
        {"a": x(4, 5), "b": x(4, 2, seed=1)}, ["a", "b"]),
    "gru_unit": (lambda f, v: list(f.layers.gru_unit(v["i"], v["h"], 12)),
                 {"i": x(3, 12), "h": x(3, 4, seed=1)}, ["i", "h"]),
    "dice_loss": (lambda f, v: f.layers.dice_loss(
        f.layers.softmax(v["x"]), v["y"]),
        {"x": x(4, 5), "y": ints(0, 5, (4, 1))}, ["x"]),
    "npair_loss": (lambda f, v: f.layers.npair_loss(v["a"], v["p"], v["y"]),
                   {"a": x(4, 6), "p": x(4, 6, seed=1),
                    "y": ints(0, 4, (4, 1))}, ["a", "p"]),
    "rank": (lambda f, v: f.layers.rank(v["x"]), {"x": x(2, 3, 4)}, []),
    "create_global_var": (lambda f, v: f.layers.elementwise_add(
        v["x"], f.layers.create_global_var([3], 1.5, "float32",
                                           persistable=True)),
        {"x": x(2, 3)}, ["x"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_front_end_matches_reference(case):
    build, feeds, grad_feeds = CASES[case]
    run_pair(build, feeds, grad_feeds, what=case)


def test_create_tensor_then_assign():
    def build(fluid, v):
        t = fluid.layers.create_tensor("float32")
        fluid.layers.assign(v["x"], t)
        return fluid.layers.scale(t, 2.0)

    run_pair(build, {"x": x(2, 3)}, [], what="create_tensor")


def _declared(fluid, build, feeds):
    fluid.unique_name.switch()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ins = {n: fluid.layers.data(n, shape=list(v.shape),
                                    dtype=str(v.dtype),
                                    append_batch_size=False)
               for n, v in feeds.items()}
        out = build(fluid, ins)
    return out


RANDOM = {
    "uniform_random": (lambda f, v: f.layers.uniform_random(
        [50, 40], min=-2.0, max=0.5), {}, (-2.0, 0.5)),
    "gaussian_random": (lambda f, v: f.layers.gaussian_random(
        [50, 40], mean=3.0, std=0.5), {}, None),
    "uniform_random_batch_size_like": (
        lambda f, v: f.layers.uniform_random_batch_size_like(
            v["x"], [-1, 30], min=0.0, max=1.0), {"x": x(60, 2)},
        (0.0, 1.0)),
    "gaussian_random_batch_size_like": (
        lambda f, v: f.layers.gaussian_random_batch_size_like(
            v["x"], [-1, 30], std=2.0), {"x": x(60, 2)}, None),
    "sampling_id": (lambda f, v: f.layers.sampling_id(
        f.layers.softmax(v["x"])), {"x": x(500, 4)}, (0, 3)),
    "nce": (lambda f, v: f.layers.nce(v["x"], v["y"], 20,
                                      num_neg_samples=5),
            {"x": x(6, 4), "y": ints(0, 20, (6, 1))}, None),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_front_end_declares_and_draws_like_reference(name):
    """Declared shape and dtype as the reference's (whose int64 vars are
    int32, jax without x64); the port's draw takes that shape and its
    declared dtype, finite and in range."""
    build, feeds, bounds = RANDOM[name]
    jv = _declared(jfluid, build, feeds)
    tv = _declared(tfluid, build, feeds)
    assert tuple(tv.shape) == tuple(jv.shape), name
    assert str(tv.dtype) == str(jv.dtype).replace("int32", "int64"), name
    got, _ = run_layers(tfluid, build, feeds, [])
    a = got[0]
    want = tuple(d if d >= 0 else feeds["x"].shape[0] for d in jv.shape)
    assert a.shape == want and str(a.dtype) == str(tv.dtype), (a.shape,
                                                               a.dtype)
    assert np.isfinite(a.astype("float64")).all()
    if bounds is not None:
        assert a.min() >= bounds[0] and a.max() <= bounds[1], name


def _mixed_program(fluid):
    """One training program through many of this slice's layers."""
    fluid.unique_name.switch()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        xv = fluid.layers.data("x", shape=[6], dtype="float32")
        ids = fluid.layers.data("ids", shape=[4], dtype="int64")
        lab = fluid.layers.data("lab", shape=[1], dtype="int64")
        h = fluid.layers.fc(xv, size=8, act="swish")
        h = fluid.layers.hard_swish(fluid.layers.leaky_relu(h, alpha=0.1))
        h = fluid.layers.selu(fluid.layers.softplus(h))
        h = fluid.layers.data_norm(h)
        soft = fluid.layers.label_smooth(fluid.layers.one_hot(lab, 8),
                                         epsilon=0.1)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            h, soft, soft_label=True))
        loss = fluid.layers.elementwise_add(loss, fluid.layers.reduce_mean(
            fluid.layers.huber_loss(fluid.layers.reduce_sum(
                h, dim=1, keep_dim=True), fluid.layers.cast(lab, "float32"),
                1.0)))
        loss = fluid.layers.elementwise_add(loss, fluid.layers.mean(
            fluid.layers.bpr_loss(h, lab)))
        fluid.layers.hash(ids, hash_size=1000, num_hash=2)
        fluid.layers.isfinite(h)
        fluid.layers.shape(h)
        fluid.layers.reverse(h, 1)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def test_verifier_interp_and_cost_see_the_new_ops_as_the_reference():
    """The battery's findings by (check, severity), the interpreter's
    per-op shapes and dtypes and the cost model's per-op FLOPs and bytes
    on a program of this slice's layers are the reference's (its int64
    results are int32 there, jax without x64); ``Executor.run(verify=
    True)`` runs it on the CPU."""
    from paddle_tpu.static_analysis import cost as jcost
    from paddle_tpu.static_analysis import interp as jinterp
    from paddle_tpu.static_analysis import verifier as jverifier

    from paddle_tpu_torch.executor import Scope
    from paddle_tpu_torch.static_analysis import cost as tcost
    from paddle_tpu_torch.static_analysis import interp as tinterp
    from paddle_tpu_torch.static_analysis import verifier as tverifier

    from test_torch_verifier import _as_jax_records, _records

    jp, _, jl = _mixed_program(jfluid)
    tp, tstart, tl = _mixed_program(tfluid)
    key = lambda ds: sorted((d.check, d.severity) for d in ds)  # noqa: E731
    want = key(jverifier.verify_program(jp, targets=[jl.name]))
    got = key(tverifier.verify_program(tp, targets=[tl.name]))
    assert got == want
    tq, _ = _as_jax_records(tp, jp)
    ji, ti = jinterp.interpret_program(jp), tinterp.interpret_program(tq)
    assert _records(ti) == _records(ji)
    jc = jcost.estimate_cost(jp, interp=ji, targets=[jl.name])
    tc = tcost.estimate_cost(tq, interp=ti, targets=[tl.name])
    assert [c.to_dict() for c in tc.op_costs] == \
        [c.to_dict() for c in jc.op_costs]
    feed = {"x": x(4, 6), "ids": ints(0, 50, (4, 4)),
            "lab": ints(0, 8, (4, 1))}
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = Scope()
    exe.run(tstart, scope=scope)
    out, = exe.run(tp, feed=feed, fetch_list=[tl], scope=scope,
                   verify=True)
    assert np.isfinite(np.asarray(out)).all()
