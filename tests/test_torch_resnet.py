"""The ResNet training slice of the PyTorch port against the reference.

On the CPU the port's K4 wrappers run their plain PyTorch versions and
the reference runs its Pallas K4 kernels in interpret mode; the two
packages draw different random initialisations, so the port is held to
the reference's persistables (parameters and batch_norm's moving
statistics) through ``paddle_tpu_torch.convert``; inputs come from
seeded numpy.

ResNet-50 as ``models/resnet.build`` writes it has 65 conv → batch_norm
sites, not the 53 of He et al.: ``_layer_warp`` passes ``ch_in = ch_out``
to every later bottleneck, whose shortcut compares it with ``ch_out * 4``
and so projects in every block.  Both packages build it so.
"""

import collections
import importlib

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu.models import resnet as jres
from paddle_tpu.static_analysis import fusion as jfusion

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import resnet as tres
from paddle_tpu_torch.ops.cuda import conv_bn_act as t_k4
from paddle_tpu_torch.static_analysis import fusion as tfusion

K4 = importlib.import_module("paddle_tpu.ops.pallas.conv_bn_act")

# K4 alone, float32 both sides: the forward differs by the reference's
# contracted multiply-add (one rounding, values of order 1); the four
# per-channel sums run in another order over 128-256 rows
K4_FWD_TOL = 2e-6
K4_GRAD_RTOL = 2e-6     # max |diff| over max |ref|, per output
# single ops on tiny inputs, float32: the convolutions and reductions sum
# in another order (XLA against oneDNN / ATen)
OP_RTOL = 1e-5          # max |diff| over max |ref|, per output
# the slice in small: ResNet-18 at 64x64, batch 4, three Nesterov
# Momentum steps at lr 1e-4.  The first step's loss is the forward alone.
# Later quantities depend on the gradients, and a relu input within a
# few 1e-6 of 0 (the two packages' convolutions differ by that much
# after a dozen layers) takes the gradient in one package and not in the
# other: at this seed one unit of the stage-3 block flips, which moves
# that conv's weight gradient by ~10% of its update and the layers below
# by ~1%.  At the build's lr 0.1 the loss falls 60x a step on a batch of
# 4 and such differences grow step by step; lr 1e-4 keeps the three
# steps near-linear, where they stay that size.
SLICE_LR = 1e-4
SLICE_STEPS = 3
FIRST_LOSS_RTOL = 1e-5
LOSS_RTOL = 2e-4        # steps 2-3 (measured <= 2.1e-5)
STATS_RTOL = 2e-3       # moving mean/variance after 3 steps, over max
LOGITS_RTOL = 2e-3      # eval clone's logits, over max |ref|
UPDATE_RTOL = 0.3       # |p_port - p_ref| over max |p_ref - p_start|
# That explanation is tested: the relu masks of both packages are
# compared at every relu site (each fused conv -> batch_norm -> relu and
# each residual add's relu), every flipped unit of the first step that
# flips must sit within FLIP_ATOL of 0 (relative to the site's largest
# output), and the
# gradients and updates of every layer above the first flipped site
# (nearer the head, so no flipped relu lies on their backward path) are
# held far tighter: in the first step that flips, and in every step
# before it, to ABOVE_FLIP_RTOL (max |diff| over max |ref| for a
# gradient; for an update |p_port - p_ref| <= ABOVE_FLIP_RTOL * max
# |p_ref - p_start| plus one unit in the last place of p_ref, the
# parameter's own rounding).  It is 5x OP_RTOL: one op's rounding
# compounds through the conv and batch_norm backward between the head
# and a layer (measured up to 1.9e-5, batch_norm scales).  After the
# first flip the layers below it have moved differently, so later steps
# keep the bounds above.
FLIP_ATOL = 1e-4
ABOVE_FLIP_RTOL = 5e-5


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# (a) the K4 module
# ---------------------------------------------------------------------------

def _k4_inputs(r, c, seed=1):
    rng = np.random.RandomState(seed)
    y = rng.randn(r, c).astype("float32")
    g = (1 + 0.1 * rng.randn(c)).astype("float32")
    b = (0.1 * rng.randn(c)).astype("float32")
    m = (0.1 * rng.randn(c)).astype("float32")
    rstd = (1 + 0.1 * rng.rand(c)).astype("float32")
    cot = rng.randn(r, c).astype("float32")
    return (y, g, b, m, rstd), cot


@pytest.mark.parametrize("act", ["identity", "relu"])
@pytest.mark.parametrize("r, c", [(128, 128), (256, 256)])
def test_k4_module_matches_pallas_kernel(interpret, r, c, act):
    """The port's K4 (its plain versions on the CPU, through the autograd
    function) against the reference's ``bn_act_epilogue`` in interpret
    mode: the output, then dy, dgamma, dbeta, dmean and drstd against
    ``jax.vjp``."""
    args, cot = _k4_inputs(r, c)
    assert K4.epilogue_eligible(r, c, act)
    want, vjp = jax.vjp(lambda *a: K4.bn_act_epilogue(*a, act=act), *args)
    want_g = vjp(jnp.asarray(cot))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = t_k4.bn_act_epilogue(*ts, act=act)
    got_g = torch.autograd.grad(out, ts, torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=K4_FWD_TOL, rtol=K4_FWD_TOL)
    for name, g, w in zip(("dy", "dgamma", "dbeta", "dmean", "drstd"),
                          got_g, want_g):
        assert _rel(g.numpy(), w) <= K4_GRAD_RTOL, name


# ---------------------------------------------------------------------------
# (b) the ops, through one-op programs in both packages
# ---------------------------------------------------------------------------

def _run_both(build, feed, steps=1):
    """Build ``build(fluid) -> fetch vars`` in both packages, copy the
    reference's persistables into the port, run ``steps`` times on the
    CPU; → (reference fetches, port fetches, reference program,
    reference scope, port scope)."""
    progs = {}
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            fetch = build(fluid)
        progs[fluid] = (main, startup, [v.name for v in fetch])
    jmain, jstart, names = progs[jfluid]
    tmain, tstart, tnames = progs[tfluid]
    assert tnames == names
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
        params = convert.scope_persistables(jmain, jscope)
        want = [jexe.run(jmain, feed=feed, fetch_list=names)
                for _ in range(steps)][-1]
    tscope = tfluid.Scope()
    with tfluid.scope_guard(tscope):
        texe = tfluid.Executor(tfluid.CPUPlace())
        texe.run(tstart)
    convert.load_params_into_scope(params, tscope, "cpu", program=tmain)
    with tfluid.scope_guard(tscope):
        got = [texe.run(tmain, feed=feed, fetch_list=names)
               for _ in range(steps)][-1]
    return ([np.asarray(w) for w in want], got, names, (jmain, tmain),
            (jscope, tscope))


def _weighted_loss(fluid, out):
    """sum(out * w) with a fed cotangent w, so every gradient is a
    generic one (a mean loss would give batch_norm a zero input
    gradient)."""
    w = fluid.layers.data("w", shape=list(out.shape[1:]), dtype="float32")
    return fluid.layers.reduce_sum(fluid.layers.elementwise_mul(out, w))


def _assert_close(got, want, names, rtol=OP_RTOL):
    for n, g, w in zip(names, got, want):
        assert g.shape == w.shape, (n, g.shape, w.shape)
        assert _rel(g, w) <= rtol, (n, _rel(g, w))


def _img(rng, shape):
    return rng.randn(*shape).astype("float32")


@pytest.mark.parametrize("is_test", [False, True])
def test_fused_conv_bn_act_matches_reference(interpret, is_test):
    """conv2d → batch_norm(relu) at [2, 8, 8, 128] NHWC fuses into one
    ``fused_conv_bn_act`` in both packages (the reference's Pallas K4,
    the port's plain K4): Out, MeanOut, VarianceOut and the input,
    filter, scale and bias gradients agree."""
    rng = np.random.RandomState(2)
    feed = {"x": _img(rng, (2, 8, 8, 64)), "w": _img(rng, (2, 8, 8, 128))}

    def build(fluid):
        x = fluid.layers.data("x", shape=[8, 8, 64], dtype="float32")
        x.stop_gradient = False
        conv = fluid.layers.conv2d(x, 128, 3, padding=1, bias_attr=False,
                                   data_format="NHWC")
        out = fluid.layers.batch_norm(conv, act="relu", is_test=is_test,
                                      data_layout="NHWC")
        loss = _weighted_loss(fluid, out)
        block = fluid.default_main_program().global_block()
        bn = [op for op in block.ops if op.type == "batch_norm"][0]
        stats = [block.var(bn.inputs[s][0]) for s in ("Mean", "Variance")]
        params = [block.var(bn.inputs[s][0]) for s in ("Scale", "Bias")]
        filt = block.var([op for op in block.ops
                          if op.type == "conv2d"][0].inputs["Filter"][0])
        grads = fluid.gradients([loss], [x, filt] + params)
        return [out] + stats + grads

    want, got, names, (jmain, tmain), _ = _run_both(build, feed)
    _assert_close(got, want, names)
    jprog, _ = jfusion.resolve_fused_program(jmain, targets=names)
    tprog, report = tfusion.resolve_fused_program(tmain, targets=names)
    assert report.counts() == {"conv_bn_act": 1}
    for prog in (jprog, tprog):
        types = collections.Counter(op.type for op in prog.global_block().ops)
        assert types["fused_conv_bn_act"] == 1
        assert types["fused_conv_bn_act_grad"] == 1
        assert types["conv2d"] == types["batch_norm"] == 0
    if is_test:  # the moving statistics are read, not moved
        np.testing.assert_array_equal(got[1], np.zeros(128, "float32"))
        np.testing.assert_array_equal(got[2], np.ones(128, "float32"))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("stride, padding, dilation, groups", [
    (1, 1, 1, 1), (2, 3, 1, 1), (1, 2, 2, 2)])
def test_conv2d_matches_reference(layout, stride, padding, dilation,
                                  groups):
    rng = np.random.RandomState(3)
    shape = (2, 4, 9, 9) if layout == "NCHW" else (2, 9, 9, 4)
    feed = {"x": _img(rng, shape)}
    ksize = 7 if padding == 3 else 3

    def build(fluid):
        x = fluid.layers.data("x", shape=list(shape[1:]), dtype="float32")
        x.stop_gradient = False
        out = fluid.layers.conv2d(x, 6, ksize, stride=stride,
                                  padding=padding, dilation=dilation,
                                  groups=groups, data_format=layout)
        feed["w"] = _img(rng, (2,) + tuple(out.shape[1:]))
        loss = _weighted_loss(fluid, out)
        block = fluid.default_main_program().global_block()
        return [out] + fluid.gradients(
            [loss], [x] + block.all_parameters())

    want, got, names, _, _ = _run_both(build, feed)
    _assert_close(got, want, names)


@pytest.mark.parametrize("padding", ["SAME", "VALID", [1, 2, 0, 1]])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_conv2d_padding_attrs_match_reference(layout, padding):
    """The op's padding attr as a string or as (lo, hi) pairs (no layer
    writes these): the lowerings of both packages called directly."""
    from paddle_tpu.ops import registry as jreg
    from paddle_tpu_torch.ops import registry as treg

    rng = np.random.RandomState(8)
    shape = (2, 3, 9, 8) if layout == "NCHW" else (2, 9, 8, 3)
    x, w = _img(rng, shape), _img(rng, (5, 3, 3, 3))
    attrs = {"strides": [2, 2], "paddings": padding, "dilations": [1, 1],
             "groups": 1, "data_format": layout}
    want = jreg.get_op_def("conv2d").fn(None, dict(attrs), jnp.asarray(x),
                                        jnp.asarray(w))
    got = treg.get_op_def("conv2d").fn(None, dict(attrs),
                                       torch.from_numpy(x),
                                       torch.from_numpy(w))
    assert tuple(got.shape) == tuple(want.shape)
    assert _rel(got.numpy(), want) <= OP_RTOL


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("kind", ["max_padded", "avg_exclusive_padded",
                                  "avg_inclusive_padded", "global_avg",
                                  "global_max"])
def test_pool2d_matches_reference(layout, kind):
    """Max pooling pads with -inf, exclusive average pooling divides by
    the real cells, global pooling takes the whole extent of either
    layout; outputs and input gradients agree."""
    rng = np.random.RandomState(4)
    shape = (2, 3, 7, 7) if layout == "NCHW" else (2, 7, 7, 3)
    # all-negative input: a zero-padded max would differ from -inf
    feed = {"x": _img(rng, shape) - 3.0}
    kw = {"max_padded": dict(pool_size=3, pool_stride=2, pool_padding=1),
          "avg_exclusive_padded": dict(pool_size=3, pool_stride=2,
                                       pool_padding=1, pool_type="avg"),
          "avg_inclusive_padded": dict(pool_size=3, pool_stride=2,
                                       pool_padding=1, pool_type="avg",
                                       exclusive=False),
          "global_avg": dict(pool_size=7, pool_type="avg",
                             global_pooling=True),
          "global_max": dict(pool_type="max", global_pooling=True)}[kind]

    def build(fluid):
        x = fluid.layers.data("x", shape=list(shape[1:]), dtype="float32")
        x.stop_gradient = False
        out = fluid.layers.pool2d(x, data_format=layout, **kw)
        feed["w"] = _img(rng, (2,) + tuple(out.shape[1:]))
        loss = _weighted_loss(fluid, out)
        return [out] + fluid.gradients([loss], [x])

    want, got, names, _, _ = _run_both(build, feed)
    _assert_close(got, want, names)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("kind, attrs, out_shape", [
    ("max_k1_pad1", dict(pooling_type="max", ksize=[1, 1], strides=[1, 1],
                         paddings=[1, 1]), (1, 3, 7, 7)),
    ("avg_exclusive_k2_pad2", dict(pooling_type="avg", ksize=[2, 2],
                                   strides=[2, 2], paddings=[2, 2],
                                   exclusive=True), (1, 3, 4, 4)),
    ("avg_inclusive_k2_pad2", dict(pooling_type="avg", ksize=[2, 2],
                                   strides=[2, 2], paddings=[2, 2],
                                   exclusive=False), (1, 3, 4, 4)),
    ("max_k3_pad2_stride2", dict(pooling_type="max", ksize=[3, 3],
                                 strides=[2, 2], paddings=[2, 2]),
     (1, 3, 4, 4)),
])
def test_pool2d_padding_above_half_the_window(layout, kind, attrs,
                                              out_shape):
    """Padding above half the window, which torch's pooling refuses: the
    op pads explicitly (-inf for max; zeros and a count of the real cells
    for the exclusive average, the window for the inclusive one) and
    gives the reference's ``reduce_window`` output, -inf and the NaN of
    an all-padding exclusive window included; the max's input gradient
    agrees too."""
    import jax

    from paddle_tpu.ops import registry as jreg
    from paddle_tpu_torch.ops import registry as treg

    rng = np.random.RandomState(9)
    x = _img(rng, (1, 3, 5, 5)) - 3.0
    attrs = dict(attrs, data_format=layout)
    if layout == "NHWC":
        x = x.transpose(0, 2, 3, 1).copy()
        out_shape = (out_shape[0], out_shape[2], out_shape[3], out_shape[1])
    jfn = jreg.get_op_def("pool2d").fn
    want = np.asarray(jfn(None, dict(attrs), jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    got = treg.get_op_def("pool2d").fn(None, dict(attrs), tx)
    assert tuple(got.shape) == tuple(want.shape) == out_shape
    g = got.detach().numpy()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(g), np.isinf(want))
    fin = np.isfinite(want)
    assert fin.any()
    assert _rel(g[fin], want[fin]) <= OP_RTOL, kind
    if attrs["pooling_type"] == "max":
        w = _img(rng, out_shape)
        w_fin = np.where(fin, w, 0.0).astype("float32")
        torch.where(torch.from_numpy(fin), got, torch.zeros_like(got)).mul(
            torch.from_numpy(w_fin)).sum().backward()
        jgrad = jax.grad(lambda z: jnp.sum(jnp.where(
            fin, jfn(None, dict(attrs), z), 0.0) * w_fin))(jnp.asarray(x))
        assert _rel(tx.grad.numpy(), np.asarray(jgrad)) <= OP_RTOL, kind


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("is_test", [False, True])
def test_batch_norm_matches_reference(layout, is_test):
    """The unfused op: Y, the moved running statistics, SavedMean and
    SavedVariance (rstd), and the input, scale and bias gradients; in
    training the moving statistics after two steps."""
    rng = np.random.RandomState(5)
    shape = (4, 6, 5, 5) if layout == "NCHW" else (4, 5, 5, 6)
    feed = {"x": 2.0 + 3.0 * _img(rng, shape), "w": _img(rng, shape)}

    def build(fluid):
        x = fluid.layers.data("x", shape=list(shape[1:]), dtype="float32")
        x.stop_gradient = False
        y = fluid.layers.batch_norm(x, is_test=is_test, data_layout=layout,
                                    momentum=0.8)
        loss = _weighted_loss(fluid, y)
        block = fluid.default_main_program().global_block()
        bn = [op for op in block.ops if op.type == "batch_norm"][0]
        outs = [block.var(bn.outputs[s][0]) for s in (
            "MeanOut", "VarianceOut", "SavedMean", "SavedVariance")]
        params = [block.var(bn.inputs[s][0]) for s in ("Scale", "Bias")]
        return [y] + outs + fluid.gradients([loss], [x] + params)

    want, got, names, _, _ = _run_both(build, feed, steps=2)
    _assert_close(got, want, names)


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_matches_reference(nesterov):
    """Three Momentum steps of a two-layer program: the loss per step,
    the parameters and the velocities."""
    rng = np.random.RandomState(6)
    feed = {"x": _img(rng, (8, 16)), "w": _img(rng, (8, 4))}

    def build(fluid):
        x = fluid.layers.data("x", shape=[16], dtype="float32")
        h = fluid.layers.fc(fluid.layers.fc(x, 32, act="relu"), 4)
        loss = _weighted_loss(fluid, h)
        fluid.optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                                 use_nesterov=nesterov).minimize(loss)
        return [loss]

    want, got, names, (jmain, tmain), (jscope, tscope) = _run_both(
        build, feed, steps=3)
    _assert_close(got, want, names)
    types = collections.Counter(op.type for op in tmain.global_block().ops)
    assert types["momentum"] == 4
    jp = convert.scope_persistables(jmain, jscope)
    tp = convert.scope_persistables(tmain, tscope)
    assert set(jp) == set(tp) and any("velocity" in k for k in tp)
    for k in jp:
        assert _rel(tp[k], jp[k]) <= OP_RTOL, k


# ---------------------------------------------------------------------------
# (c) the fusion structure of ResNet-50
# ---------------------------------------------------------------------------

def _op_counts(program):
    return collections.Counter(op.type for op in program.global_block().ops)


def test_resnet50_fuses_every_site_like_the_reference():
    """``build(imagenet, 50, NHWC)``: 65 conv_bn_act rewrites with their
    grad twins in both packages, no conv2d or batch_norm left, and the
    same resolved program op for op (build only)."""
    progs = {}
    for fluid, resnet, fusion in ((jfluid, jres, jfusion),
                                  (tfluid, tres, tfusion)):
        with fluid.unique_name.guard():
            main, _, _, loss, _ = resnet.build(dataset="imagenet", depth=50,
                                               data_format="NHWC")
        progs[fluid] = (main, fusion.resolve_fused_program(
            main, targets=[loss.name]))
    (jmain, (jprog, jrep)), (tmain, (tprog, trep)) = progs[jfluid], \
        progs[tfluid]
    assert _op_counts(tmain) == _op_counts(jmain)
    assert jrep.counts() == trep.counts() == {"conv_bn_act": 65}
    counts = _op_counts(tprog)
    assert counts == _op_counts(jprog)
    assert counts["fused_conv_bn_act"] == counts[
        "fused_conv_bn_act_grad"] == 65
    assert counts["conv2d"] == counts["batch_norm"] == 0
    assert counts["momentum"] == 197


def test_small_conv_outputs_stay_unfused_below_the_gate(monkeypatch):
    """The byte gate: with the gate above a site's conv output the site
    keeps its conv2d and batch_norm, and the report says why."""
    monkeypatch.setenv("PADDLE_TPU_CONV_BN_MIN_BYTES", str(1 << 30))
    with tfluid.unique_name.guard():
        main, _, _, loss, _ = tres.build(dataset="cifar10", depth=20,
                                         data_format="NHWC")
    prog, report = tfusion.resolve_fused_program(main, targets=[loss.name])
    assert report.counts() == {}
    assert prog is main
    assert report.skipped and all("gate" in s.reason
                                  for s in report.skipped)


def test_a_cast_between_conv_and_batch_norm_leaves_the_site_unfused():
    """The AMP rewrite's cast pair (bf16 conv → cast f32 → batch_norm →
    cast bf16 → relu) is not matched until AMP is ported: the site keeps
    its ops (build only)."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[8, 8, 64], dtype="bfloat16")
        conv = tfluid.layers.conv2d(x, 128, 3, padding=1, bias_attr=False,
                                    data_format="NHWC")
        y = tfluid.layers.batch_norm(tfluid.layers.cast(conv, "float32"),
                                     data_layout="NHWC")
        out = tfluid.layers.relu(tfluid.layers.cast(y, "bfloat16"))
    prog, report = tfusion.resolve_fused_program(main, targets=[out.name])
    assert report.counts() == {} and prog is main
    assert _op_counts(main)["batch_norm"] == 1


# ---------------------------------------------------------------------------
# (d) the slice in small
# ---------------------------------------------------------------------------

def _slice_program(fluid, resnet, hw, depth, lr, stem="conv7",
                   layout="NHWC"):
    """``resnet.build``'s program at an hw x hw input (``build`` itself
    declares 224 x 224): the eval clone is taken before ``minimize``."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        shape = [hw, hw, 3] if layout == "NHWC" else [3, hw, hw]
        img = fluid.layers.data("img", shape=shape, dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        logits = resnet.resnet_imagenet(img, 1000, depth, False, layout,
                                        stem)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        acc = fluid.layers.accuracy(fluid.layers.softmax(logits), label)
        test = main.clone(for_test=True)
        fluid.optimizer.Momentum(learning_rate=lr, momentum=0.9,
                                 use_nesterov=True).minimize(loss)
    return main, startup, test, loss, acc, logits


def _relu_sites(program):
    """``[(op index, output var)]`` of the forward relu ops, in order."""
    return [(i, op.outputs["Out"][0])
            for i, op in enumerate(program.global_block().ops)
            if op.type == "relu"]


def _param_sites(program):
    """param name → the index of the forward op that reads it."""
    pos = {}
    for i, op in enumerate(program.global_block().ops):
        if op.attrs.get("op_role") in ("backward", "optimize"):
            continue
        for n in op.input_arg_names:
            pos.setdefault(n, i)
    return pos


def test_resnet18_slice_trains_like_the_reference(interpret):
    """ResNet-18 NHWC at 64x64, batch 4: all 20 sites fuse (those with
    C >= 128 run the reference's Pallas K4), three Nesterov Momentum
    steps from the reference's parameters and moving statistics, then
    the eval clone.  The relu masks of the two packages are compared at
    all 17 relu sites each step, and the layers above the first flipped
    site are held to ABOVE_FLIP_RTOL.  Tolerances at the top of the
    file."""
    rng = np.random.RandomState(0)
    feed = {"img": _img(rng, (4, 64, 64, 3)),
            "label": rng.randint(0, 10, (4, 1)).astype("int64")}
    jm, js, jt, jl, ja, jlog = _slice_program(jfluid, jres, 64, 18,
                                              SLICE_LR)
    tm, ts, tt, tl, ta, tlog = _slice_program(tfluid, tres, 64, 18,
                                              SLICE_LR)
    assert _op_counts(tm) == _op_counts(jm)
    sites = _relu_sites(tm)
    assert sites == _relu_sites(jm) and len(sites) == 17
    grads = {op.inputs["Param"][0]: op.inputs["Grad"][0]
             for op in tm.global_block().ops if op.type == "momentum"}
    pnames = sorted(grads)
    fetch = [tl.name, ta.name] + [n for _, n in sites] \
        + [grads[p] for p in pnames]
    _, report = tfusion.resolve_fused_program(tm, targets=fetch)
    assert report.counts() == {"conv_bn_act": 20}
    jscope = jfluid.Scope()
    want, want_states = [], []
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(js)
        start = convert.scope_persistables(jm, jscope)
        for _ in range(SLICE_STEPS):
            want.append([np.asarray(v) for v in
                         jexe.run(jm, feed=feed, fetch_list=fetch)])
            want_states.append(convert.scope_persistables(jm, jscope))
        want_logits = np.asarray(jexe.run(jt, feed=feed,
                                          fetch_list=[jlog])[0])
    tscope = tfluid.Scope()
    with tfluid.scope_guard(tscope):
        texe = tfluid.Executor(tfluid.CPUPlace())
        texe.run(ts)
    convert.load_params_into_scope(start, tscope, "cpu", program=tm)
    got, got_states = [], []
    with tfluid.scope_guard(tscope):
        for _ in range(SLICE_STEPS):
            got.append(texe.run(tm, feed=feed, fetch_list=fetch))
            got_states.append(convert.scope_persistables(tm, tscope))
        got_logits = texe.run(tt, feed=feed, fetch_list=[tlog])[0]

    losses = [(float(g[0][0]), float(np.asarray(w[0])[0]))
              for g, w in zip(got, want)]
    assert abs(losses[0][0] - losses[0][1]) <= FIRST_LOSS_RTOL \
        * abs(losses[0][1])
    for g, w in losses[1:]:
        assert abs(g - w) <= LOSS_RTOL * abs(w), losses
    assert losses[-1][0] < losses[0][0]

    # the relu masks, site by site; up to the first step that flips
    # (while both packages start each step from the same parameters to
    # rounding) every flip is a unit within rounding of 0 on the side
    # that kept it; later flips follow the layers' diverged updates
    ns = len(sites)
    flips, kept_max = [], []
    for step in range(SLICE_STEPS):
        row, kept = [], []
        for k in range(ns):
            g, w = got[step][2 + k], want[step][2 + k]
            f = (g > 0) != (w > 0)
            row.append(int(f.sum()))
            kept.append(float(np.maximum(g[f], w[f]).max()
                              / np.abs(w).max()) if f.any() else 0.0)
            assert f.sum() <= 1e-3 * f.size, (step, k, int(f.sum()))
        flips.append(row)
        kept_max.append(max(kept))
    print("relu-mask flips per site (rows: steps; columns: sites from "
          "the stem to the head):", flips, "largest flipped unit over "
          "its site's largest, per step:", kept_max)

    # the first step that flips, and the first flipped site in it
    # counting from the head; with no flip at all the whole model is
    # above it in every step
    first = next((s for s in range(SLICE_STEPS) if any(flips[s])), None)
    held = SLICE_STEPS if first is None else first + 1
    assert max(kept_max[:held]) <= FLIP_ATOL, kept_max
    top = -1 if first is None else max(
        sites[k][0] for k in range(ns) if flips[first][k])
    pos = _param_sites(tm)
    trainable = {p.name for p in jm.all_parameters() if p.trainable}
    above = [p for p in pnames if p in trainable and pos[p] > top]
    assert {"fc_0.w_0", "fc_0.b_0"} <= set(above)
    for step in range(held):
        prev = start if step == 0 else want_states[step - 1]
        for p in (above if step == held - 1 else pnames):
            j = 2 + ns + pnames.index(p)
            assert _rel(got[step][j], want[step][j]) <= ABOVE_FLIP_RTOL, \
                (step, p, _rel(got[step][j], want[step][j]))
            moved = np.abs(want_states[step][p] - prev[p]).max()
            slack = np.spacing(np.abs(want_states[step][p]))
            assert (np.abs(got_states[step][p] - want_states[step][p])
                    <= ABOVE_FLIP_RTOL * moved + slack).all(), (step, p)

    jp, tp = want_states[-1], got_states[-1]
    assert set(tp) == set(jp)
    moving = {p.name for p in jm.all_parameters() if not p.trainable}
    assert len(moving) == 40
    for k in moving:
        assert _rel(tp[k], jp[k]) <= STATS_RTOL, k
        assert not np.array_equal(jp[k], start[k]), k
    for k in trainable:
        moved = np.abs(jp[k] - start[k]).max()
        assert np.abs(tp[k] - jp[k]).max() <= UPDATE_RTOL * moved, k
    assert got_logits.shape == (4, 1000)
    assert _rel(got_logits, want_logits) <= LOGITS_RTOL


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_space_to_depth_stem_builds_like_the_reference(layout):
    """``stem="s2d"``: the same training program and the same fused sites
    in both packages (build only: at 32x32 stage 4's five 1x1 outputs of
    2 KB stay under the 4096-byte gate); the port's eval clone runs."""
    progs = {}
    for fluid, resnet, fusion in ((jfluid, jres, jfusion),
                                  (tfluid, tres, tfusion)):
        prog = _slice_program(fluid, resnet, 32, 18, 0.1, "s2d", layout)
        progs[fluid] = prog + fusion.resolve_fused_program(
            prog[0], targets=[prog[3].name])
    jm, _, _, _, _, _, jprog, jrep = progs[jfluid]
    tm, ts, tt, _, _, tlog, tprog, trep = progs[tfluid]
    assert _op_counts(tm) == _op_counts(jm)
    assert _op_counts(tprog) == _op_counts(jprog)
    assert trep.counts() == jrep.counts() == {"conv_bn_act": 15}
    rng = np.random.RandomState(7)
    shape = (2, 3, 32, 32) if layout == "NCHW" else (2, 32, 32, 3)
    feed = {"img": _img(rng, shape),
            "label": rng.randint(0, 10, (2, 1)).astype("int64")}
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(ts)
        logits = exe.run(tt, feed=feed, fetch_list=[tlog])[0]
    assert logits.shape == (2, 1000) and np.isfinite(logits).all()


def test_space_to_depth_and_pad_ops_match_reference():
    """The NCHW s2d stem's two ops, called directly: space_to_depth with
    block 2, and pad with asymmetric (before, after) pairs."""
    from paddle_tpu.ops import registry as jreg
    from paddle_tpu_torch.ops import registry as treg

    x = _img(np.random.RandomState(9), (2, 3, 8, 6))
    for op, attrs in (("space_to_depth", {"blocksize": 2}),
                      ("pad", {"paddings": [0, 0, 0, 1, 1, 2, 2, 0],
                               "pad_value": -1.5})):
        want = jreg.get_op_def(op).fn(None, dict(attrs), jnp.asarray(x))
        got = treg.get_op_def(op).fn(None, dict(attrs), torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
