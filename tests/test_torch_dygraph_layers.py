"""The 20 dygraph layers and the 12 ops they dispatch in the PyTorch port
against the reference package on the CPU.

Layers (``chip_smoke.DYGRAPH_LAYER_CASES``, which the chip script's
``dygraph_parity`` phase also runs): each is built in both packages (the reference under
``dygraph.guard()``, the port under ``guard(CPUPlace())``), the port's
weights are carried over from the reference's with
``convert.load_layer_state``, the same seeded numpy inputs go through
both, and ``mean(out * R)`` for a seeded R is differentiated: the outputs
and the gradients of every parameter and of the float inputs must agree.
Ops: each of the 12 new op types runs in the port through
``call_op_taped`` and its generic grad op (``ops/registry.py``), and in
the reference through its ``jax.vjp`` grad op, with attrs the layers do
not reach (string and asymmetric transposed paddings, groups,
channels-last 3-D input, integer activation codes, a sample weight and
the log-uniform sampler).

Tolerance: float32 through one op or a few, summed in another order:
``RTOL``/``ATOL`` 1e-5 on values of order 1.  NCE draws its negatives on
the op: the reference evaluates its formula on the port's own draw
(``_draw_negatives`` patched to return it), and the port's sampler is
held to its distribution by counts."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu.ops import nn as j_nn_ops
from paddle_tpu.ops import registry as j_registry

import chip_smoke
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.ops import nn as t_nn_ops
from paddle_tpu_torch.ops import registry as t_registry

RTOL, ATOL = 1e-5, 1e-5


def _rng(seed=0):
    return np.random.RandomState(seed)


_f32 = chip_smoke._randn


# the layers at small widths, shared with the chip script's parity phase
LAYERS = chip_smoke.DYGRAPH_LAYER_CASES


def _run_layer(dg, guard, layer, inputs, weight):
    return chip_smoke.dygraph_layer_grads(dg, guard, layer, inputs, weight)


def _named_params(layer):
    return chip_smoke.dygraph_named_params(layer)


def _both(make, inputs, train=True):
    with jfluid.dygraph.guard():
        ref = make(jfluid.dygraph)
    with tfluid.dygraph.guard(tfluid.CPUPlace()):
        port = make(tfluid.dygraph)
    convert.load_layer_state(port, ref)
    if not train:
        ref.eval()
        port.eval()
    return ref, port


def _check_layer(ref, port, inputs, weight):
    r = _run_layer(jfluid.dygraph, jfluid.dygraph.guard(), ref, inputs,
                   weight)
    t = _run_layer(tfluid.dygraph, tfluid.dygraph.guard(tfluid.CPUPlace()),
                   port, inputs, weight)
    np.testing.assert_allclose(t[0], r[0], rtol=RTOL, atol=ATOL)
    assert sorted(t[1]) == sorted(r[1]) == sorted(
        k for k, _ in _named_params(ref) if k not in ("_mean", "_variance"))
    for k in r[1]:
        np.testing.assert_allclose(t[1][k], r[1][k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert len(t[2]) == len(r[2])
    for a, b in zip(t[2], r[2]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    return r, t


def _out_shape(make, inputs):
    with tfluid.dygraph.guard(tfluid.CPUPlace()):
        out = make(tfluid.dygraph)(*[tfluid.dygraph.to_variable(a)
                                     for a in inputs])
    return (out[0] if isinstance(out, tuple) else out).shape


@pytest.mark.parametrize("name,make,inputs", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_layer_forward_and_grads_match_reference(name, make, inputs):
    rng = _rng(sum(map(ord, name)))  # a seed of its own, stable
    xs = inputs(rng)
    weight = _f32(rng, *_out_shape(make, xs))
    ref, port = _both(make, xs)
    _check_layer(ref, port, xs, weight)
    if name == "BatchNorm":  # the running statistics moved alike
        for k in ("_mean", "_variance"):
            np.testing.assert_allclose(port.state_dict()[k],
                                       ref.state_dict()[k], rtol=RTOL,
                                       atol=ATOL)


def test_batchnorm_eval_uses_and_keeps_running_statistics():
    make = lambda dg: dg.BatchNorm(3)  # noqa: E731
    rng = _rng(3)
    x = _f32(rng, 4, 3, 5, 5) * 2 + 1
    ref, port = _both(make, [x])
    _check_layer(ref, port, [x], _f32(rng, 4, 3, 5, 5))  # moves them
    before = port.state_dict()
    ref.eval()
    port.eval()
    _check_layer(ref, port, [x], _f32(rng, 4, 3, 5, 5))
    after = port.state_dict()
    for k in ("_mean", "_variance"):
        np.testing.assert_array_equal(after[k], before[k])
    assert not np.allclose(before["_mean"], 0.0)


def test_dropout_eval_is_identity_and_train_draws_new_masks():
    """``eval()`` (and p = 0 above) is the identity in both packages; in
    training each call draws a new mask (its own op id), keeps about
    1 - p of the cells and scales them by 1 / (1 - p)."""
    x = np.ones((64, 256), "float32")
    ref, port = _both(lambda dg: dg.Dropout(0.3), [x], train=False)
    _check_layer(ref, port, [x], _f32(_rng(4), 64, 256))
    port.train()
    with tfluid.dygraph.guard(tfluid.CPUPlace()):
        xv = tfluid.dygraph.to_variable(x)
        a, b = port(xv).numpy(), port(xv).numpy()
    for m in (a, b):
        assert set(np.unique(m)) <= {0.0, np.float32(1 / 0.7)}
        keep = (m != 0).mean()
        # 16384 cells: 5 standard deviations of a Bernoulli(0.7) mean
        assert abs(keep - 0.7) < 5 * np.sqrt(0.21 / m.size), keep
    assert (a != b).any()


def _capture_negatives(monkeypatch):
    drawn = []
    orig = t_nn_ops._draw_negatives

    def draw(*a, **k):
        neg = orig(*a, **k)
        drawn.append(neg.clone())
        return neg

    monkeypatch.setattr(t_nn_ops, "_draw_negatives", draw)
    monkeypatch.setattr(
        j_nn_ops, "_draw_negatives",
        lambda *a, **k: jnp.asarray(drawn[-1].numpy(), jnp.int32))
    return drawn


def test_nce_layer_cost_and_grads_on_the_ports_own_negatives(monkeypatch):
    drawn = _capture_negatives(monkeypatch)
    make = lambda dg: dg.NCE(12, dim=8, num_neg_samples=4)  # noqa: E731
    rng = _rng(5)
    feats = _f32(rng, 6, 8)
    labels = rng.randint(0, 12, (6, 1)).astype("int64")
    ref, port = _both(make, [feats, labels])
    w = _f32(rng, 6, 1)
    # the port runs first (its draw), then the reference on that draw
    t = _run_layer(tfluid.dygraph, tfluid.dygraph.guard(tfluid.CPUPlace()),
                   port, [feats, labels], w)
    r = _run_layer(jfluid.dygraph, jfluid.dygraph.guard(), ref,
                   [feats, labels], w)
    assert len(drawn) == 1
    np.testing.assert_allclose(t[0], r[0], rtol=RTOL, atol=ATOL)
    assert sorted(t[1]) == sorted(r[1]) == ["bias", "weight"]
    for k in r[1]:
        np.testing.assert_allclose(t[1][k], r[1][k], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t[2][0], r[2][0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("sampler", [0, 1])
def test_nce_sampler_distribution_by_counts(sampler):
    """200000 draws over 10 classes: each class's count within 5 standard
    deviations of n q(c) (uniform, or log-uniform q(c) = log((c + 2) /
    (c + 1)) / log(11))."""
    ctx = t_registry.LoweringContext(seed=11)
    ctx.set_op(3)
    n, k = 10, 200000
    ids = t_nn_ops._draw_negatives(ctx, sampler, k, n).numpy()
    assert ids.min() >= 0 and ids.max() < n
    c = np.arange(n)
    q = (np.full(n, 1.0 / n) if sampler == 0
         else np.log((c + 2.0) / (c + 1.0)) / np.log(n + 1.0))
    counts = np.bincount(ids, minlength=n)
    assert np.all(np.abs(counts - k * q) < 5 * np.sqrt(k * q * (1 - q))), \
        (counts, k * q)


# ---- the 12 ops through each package's static grad op ----

def _port_op(op_type, ins, attrs, cots):
    opdef = t_registry.get_op_def(op_type)
    ctx = t_registry.LoweringContext(mode="train")
    tins = {s: [None if v is None else torch.from_numpy(np.array(v))
                for v in vs] for s, vs in ins.items()}
    wanted = {s: set(range(len(vs))) for s, vs in tins.items()}
    outs = t_registry.call_op_taped(opdef, ctx, tins, attrs, 1, wanted)
    gin = dict(tins)
    gin.update(outs)
    for slot, c in cots.items():
        gin[slot + "@GRAD"] = [torch.from_numpy(c)]
    res = t_registry.call_op(t_registry.get_op_def(op_type + "_grad"), ctx,
                             gin, dict(attrs, __fwd_op_id__=1), op_id=1)
    return ({s: [v.numpy() for v in vs] for s, vs in outs.items()},
            {s: [None if g is None else g.numpy() for g in gs]
             for s, gs in res.items()})


def _ref_op(op_type, ins, attrs, cots):
    opdef = j_registry.get_op_def(op_type)
    ctx = j_registry.LoweringContext(mode="train")
    jins = {s: [None if v is None else jnp.asarray(v) for v in vs]
            for s, vs in ins.items()}
    outs = j_registry.call_op(opdef, ctx, jins, attrs, op_id=1)
    gin = dict(jins)
    gin.update(outs)
    for slot, c in cots.items():
        gin[slot + "@GRAD"] = [jnp.asarray(c)]
    res = j_registry.call_op(j_registry.get_op_def(op_type + "_grad"), ctx,
                             gin, dict(attrs, __fwd_op_id__=1), op_id=1)
    return ({s: [np.asarray(v) for v in vs] for s, vs in outs.items()},
            {s: [np.asarray(g) for g in gs] for s, gs in res.items()})


def _r(seed, *shape):
    return _f32(_rng(seed), *shape)


OPS = [
    ("conv3d_ndhwc_stride_dilation", "conv3d",
     {"Input": [_r(1, 1, 5, 6, 6, 4)], "Filter": [_r(2, 6, 2, 2, 3, 3)]},
     {"strides": [1, 2, 1], "paddings": [1, 0, 2], "dilations": [1, 1, 2],
      "groups": 2, "data_format": "NDHWC"}, "Output"),
    ("conv2d_transpose_asym_pads", "conv2d_transpose",
     {"Input": [_r(3, 2, 3, 4, 4)], "Filter": [_r(4, 3, 2, 3, 3)]},
     {"strides": [2, 1], "paddings": [1, 0, 0, 2], "dilations": [1, 2]},
     "Output"),
    ("conv2d_transpose_same", "conv2d_transpose",
     {"Input": [_r(5, 1, 2, 5, 5)], "Filter": [_r(6, 2, 3, 4, 4)]},
     {"strides": [2, 2], "paddings": "SAME"}, "Output"),
    ("conv2d_transpose_valid_groups", "conv2d_transpose",
     {"Input": [_r(7, 1, 4, 3, 3)], "Filter": [_r(8, 4, 2, 3, 3)]},
     {"strides": [2, 2], "paddings": "VALID", "groups": 2}, "Output"),
    ("conv3d_transpose_groups_pad", "conv3d_transpose",
     {"Input": [_r(9, 1, 4, 2, 3, 3)], "Filter": [_r(10, 4, 1, 3, 3, 3)]},
     {"strides": [2, 2, 1], "paddings": [1, 1, 1], "groups": 2},
     "Output"),
    ("prelu_channel", "prelu",
     {"X": [_r(11, 2, 3, 4)], "Alpha": [_r(12, 3)]}, {"mode": "channel"},
     "Out"),
    ("spectral_norm_dim2", "spectral_norm",
     {"Weight": [_r(13, 3, 4, 5)], "U": [_r(14, 5)], "V": [_r(15, 12)]},
     {"dim": 2, "power_iters": 4, "eps": 1e-12}, "Out"),
    ("row_conv", "row_conv",
     {"X": [_r(16, 2, 5, 3)], "Filter": [_r(17, 4, 3)]}, {}, "Out"),
    ("group_norm_no_affine", "group_norm",
     {"X": [_r(18, 2, 6, 3, 3) * 3 + 2], "Scale": [None], "Bias": [None]},
     {"groups": 3, "epsilon": 1e-5}, "Y"),
    ("gru_unit_int_codes", "gru_unit",
     {"Input": [_r(19, 3, 6)], "HiddenPrev": [_r(20, 3, 2)],
      "Weight": [_r(21, 2, 6)], "Bias": [_r(22, 1, 6)]},
     {"activation": 3, "gate_activation": 1}, "Hidden"),
    ("bilinear_tensor_product_no_bias", "bilinear_tensor_product",
     {"X": [_r(23, 4, 3)], "Y": [_r(24, 4, 2)],
      "Weight": [_r(25, 5, 3, 2)], "Bias": [None]}, {}, "Out"),
    ("sequence_conv_start", "sequence_conv",
     {"X": [_r(26, 2, 5, 3)], "Filter": [_r(27, 12, 2)],
      "SeqLen": [np.array([5, 2], "int64")]},
     {"contextLength": 4, "contextStart": -2}, "Out"),
    ("sequence_conv_no_lengths", "sequence_conv",
     {"X": [_r(28, 2, 4, 3)], "Filter": [_r(29, 6, 2)],
      "SeqLen": [None]}, {"contextLength": 2, "contextStart": 0}, "Out"),
    ("tree_conv", "tree_conv",
     {"NodesVector": [_r(30, 1, 4, 3)],
      "EdgeSet": [np.array([[[0, 1], [0, 2], [2, 3]]], "int64")],
      "Filter": [_r(31, 3, 2, 3)]}, {}, "Out"),
]


@pytest.mark.parametrize("case,op_type,ins,attrs,out_slot", OPS,
                         ids=[c[0] for c in OPS])
def test_op_forward_and_generic_grad_match_reference(case, op_type, ins,
                                                     attrs, out_slot):
    t_outs, _ = _port_op(op_type, ins, attrs, {})
    cot = _r(99, *t_outs[out_slot][0].shape)
    t_outs, t_grads = _port_op(op_type, ins, attrs, {out_slot: cot})
    r_outs, r_grads = _ref_op(op_type, ins, attrs, {out_slot: cot})
    np.testing.assert_allclose(t_outs[out_slot][0], r_outs[out_slot][0],
                               rtol=RTOL, atol=ATOL)
    for slot, vals in ins.items():
        for i, v in enumerate(vals):
            if v is None or v.dtype != np.float32:
                continue
            np.testing.assert_allclose(
                t_grads[slot + "@GRAD"][i], r_grads[slot + "@GRAD"][i],
                rtol=RTOL, atol=ATOL, err_msg="%s@GRAD" % slot)


@pytest.mark.parametrize("sampler", [0, 1])
def test_nce_op_with_sample_weight_on_the_ports_draw(monkeypatch, sampler):
    drawn = _capture_negatives(monkeypatch)
    rng = _rng(40 + sampler)
    ins = {"Input": [_f32(rng, 5, 6)],
           "Label": [rng.randint(0, 9, (5, 1)).astype("int64")],
           "Weight": [_f32(rng, 9, 6)], "Bias": [_f32(rng, 9, 1)],
           "SampleWeight": [np.abs(_f32(rng, 5, 1))]}
    attrs = {"num_total_classes": 9, "num_neg_samples": 5,
             "sampler": sampler, "seed": 7}
    cot = _f32(rng, 5, 1)
    t_outs, t_grads = _port_op("nce", ins, attrs, {"Cost": cot})
    assert len(drawn) == 1
    r_outs, r_grads = _ref_op("nce", ins, attrs, {"Cost": cot})
    for slot in ("Cost", "SampleLogits"):
        np.testing.assert_allclose(t_outs[slot][0], r_outs[slot][0],
                                   rtol=RTOL, atol=ATOL, err_msg=slot)
    np.testing.assert_array_equal(t_outs["SampleLabels"][0],
                                  r_outs["SampleLabels"][0])
    for slot in ("Input", "Weight", "Bias"):
        np.testing.assert_allclose(t_grads[slot + "@GRAD"][0],
                                   r_grads[slot + "@GRAD"][0], rtol=RTOL,
                                   atol=ATOL, err_msg=slot)
