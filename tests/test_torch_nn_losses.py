"""The nn, loss and metric ops of this slice of the PyTorch port against
the reference (``paddle_tpu/ops/nn.py``, ``losses.py``, ``metrics.py``):
each through its ``fluid.layers`` front end (or as one op where it has
none) on seeded numpy feeds, forward and the gradient of ``sum(out *
cot)``, the reference's parameters copied into the port with
``convert``; floats within 1e-6 of max(1, |ref|), integers exact.
``hash`` is the reference's uint32 mix bit for bit.  The random ops draw
on the device in the port and with jax's generator in the reference, so
they are held to shape, dtype, range and moments, to fresh values each
step and to a capturable program; ``sampled_softmax_with_cross_entropy``
with customized samples is compared value for value with the reference
drawing the same samples."""

import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.executor import Scope
from paddle_tpu_torch.ops import registry as t_registry

from torch_parity_helpers import append, close, ints, run_layers, run_pair, x


def _probs(n, c, seed=0):
    p = np.random.RandomState(seed).uniform(0.05, 1.0, (n, c))
    return (p / p.sum(axis=1, keepdims=True)).astype("float32")


def _tss_labels():
    """One label in each of the four ranges of the distillation code."""
    return np.array([[-1.5], [-0.5], [0.3], [1.7], [-2.0], [0.9]],
                    "float32")


CASES = {
    "lookup_table_v2": (
        lambda f, v: append(f, "lookup_table_v2", {"W": v["w"],
                                                   "Ids": v["i"]},
                            {"padding_idx": 2}),
        {"w": x(7, 4), "i": ints(0, 7, (3, 5))}, ["w"]),
    "lookup_sparse_table": (
        lambda f, v: append(f, "lookup_sparse_table", {"W": v["w"],
                                                       "Ids": v["i"]}),
        {"w": x(7, 4), "i": ints(0, 7, (6, 1))}, ["w"]),
    "one_hot_v2": (lambda f, v: append(f, "one_hot_v2", {"X": v["i"]},
                                       {"depth": 6}, dtype="float32"),
                   {"i": ints(0, 6, (3, 4))}, []),
    "huber_loss": (lambda f, v: f.layers.huber_loss(v["a"], v["b"], 0.8),
                   {"a": x(6, 1), "b": x(6, 1, seed=1)}, ["a", "b"]),
    "smooth_l1": (lambda f, v: f.layers.smooth_l1(v["a"], v["b"], sigma=2.0),
                  {"a": x(4, 3), "b": x(4, 3, seed=1)}, ["a", "b"]),
    "smooth_l1_weights": (
        lambda f, v: f.layers.smooth_l1(v["a"], v["b"], v["iw"], v["ow"]),
        {"a": x(4, 3), "b": x(4, 3, seed=1),
         "iw": np.abs(x(4, 3, seed=2)), "ow": np.abs(x(4, 3, seed=3))},
        ["a", "b"]),
    "label_smooth": (lambda f, v: f.layers.label_smooth(v["y"],
                                                        epsilon=0.1),
                     {"y": _probs(4, 5)}, ["y"]),
    "label_smooth_prior": (
        lambda f, v: f.layers.label_smooth(v["y"], prior_dist=v["p"],
                                           epsilon=0.2),
        {"y": _probs(4, 5), "p": _probs(1, 5, seed=1)}, ["y", "p"]),
    "selu": (lambda f, v: f.layers.selu(v["x"]), {"x": x(4, 5, scale=2)},
             ["x"]),
    "multiplex": (lambda f, v: f.layers.multiplex([v["a"], v["b"], v["c"]],
                                                  v["i"]),
                  {"a": x(5, 3), "b": x(5, 3, seed=1), "c": x(5, 3, seed=2),
                   "i": np.array([[2], [0], [1], [1], [2]], "int32")},
                  ["a", "b", "c"]),
    "add_position_encoding": (
        lambda f, v: f.layers.add_position_encoding(v["x"], alpha=0.5,
                                                    beta=2.0),
        {"x": x(2, 6, 8)}, ["x"]),
    "add_position_encoding_odd": (
        lambda f, v: f.layers.add_position_encoding(v["x"]),
        {"x": x(2, 5, 7)}, ["x"]),
    "hash": (lambda f, v: [f.layers.hash(v["i"], hash_size=1000,
                                         num_hash=3),
                           f.layers.hash(v["j"], hash_size=64)],
             {"i": ints(0, 200000, (8, 4)), "j": ints(0, 5000, (2, 3, 2))},
             []),
    "data_norm": (lambda f, v: f.layers.data_norm(v["x"]),
                  {"x": x(6, 13)}, ["x"]),
    "hsigmoid": (lambda f, v: f.layers.hsigmoid(v["x"], v["y"], 6),
                 {"x": x(5, 4), "y": ints(0, 6, (5, 1))}, ["x"]),
    "hsigmoid_no_bias": (lambda f, v: f.layers.hsigmoid(
        v["x"], v["y"], 9, bias_attr=False),
        {"x": x(7, 3), "y": ints(0, 9, (7, 1))}, ["x"]),
    "log_loss": (lambda f, v: f.layers.log_loss(v["p"], v["y"]),
                 {"p": np.random.RandomState(0).uniform(
                     0.05, 0.95, (6, 1)).astype("float32"),
                  "y": ints(0, 2, (6, 1), dtype="float32")}, ["p"]),
    "rank_loss": (lambda f, v: f.layers.rank_loss(v["y"], v["l"], v["r"]),
                  {"y": ints(0, 2, (5, 1), dtype="float32"), "l": x(5, 1),
                   "r": x(5, 1, seed=1)}, ["l", "r"]),
    "margin_rank_loss": (
        lambda f, v: f.layers.margin_rank_loss(v["y"], v["l"], v["r"],
                                               margin=0.3),
        {"y": np.array([[1], [-1], [1], [-1], [1]], "float32"),
         "l": x(5, 1), "r": x(5, 1, seed=1)}, ["l", "r"]),
    "bpr_loss": (lambda f, v: f.layers.bpr_loss(v["x"], v["y"]),
                 {"x": x(4, 6), "y": ints(0, 6, (4, 1))}, ["x"]),
    "teacher_student_sigmoid_loss": (
        lambda f, v: f.layers.teacher_student_sigmoid_loss(v["x"], v["y"]),
        {"x": x(6, 1, scale=2), "y": _tss_labels()}, ["x"]),
    "mean_iou": (lambda f, v: list(f.layers.mean_iou(v["p"], v["y"], 5)),
                 {"p": ints(0, 5, (4, 6), dtype="int32"),
                  "y": ints(0, 5, (4, 6), seed=1, dtype="int32")}, []),
    "mean_iou_absent_class": (
        lambda f, v: list(f.layers.mean_iou(v["p"], v["y"], 6)),
        {"p": ints(0, 4, (10,), dtype="int32"),
         "y": ints(0, 4, (10,), seed=1, dtype="int32")}, []),
    "precision_recall": (
        lambda f, v: list(append(
            f, "precision_recall",
            {"MaxProbs": v["mp"], "Indices": v["i"], "Labels": v["y"],
             "Weights": v["w"], "StatesInfo": v["s"]},
            {"class_number": 4},
            outs=("BatchMetrics", "AccumMetrics", "AccumStatesInfo"),
            dtype="float32")),
        {"mp": np.random.RandomState(0).uniform(size=(8, 1)).astype(
            "float32"), "i": ints(0, 4, (8, 1), dtype="int32"),
         "y": ints(0, 4, (8, 1), seed=1, dtype="int32"),
         "w": np.abs(x(8, 1)) + 0.1,
         "s": np.abs(x(4, 4, seed=2)).round()}, []),
    "positive_negative_pair": (
        lambda f, v: list(append(
            f, "positive_negative_pair",
            {"Score": v["s"], "Label": v["y"], "QueryID": v["q"],
             "AccumulatePositivePair": v["ap"],
             "AccumulateNegativePair": v["an"],
             "AccumulateNeutralPair": v["au"], "Weight": v["w"]},
            {"column": 1},
            outs=("PositivePair", "NegativePair", "NeutralPair"),
            dtype="float32")),
        {"s": np.round(x(10, 2), 1), "y": ints(0, 3, (10, 1),
                                               dtype="float32"),
         "q": np.array([[0], [0], [1], [0], [1], [1], [2], [2], [0], [2]],
                       "int64"),
         "ap": np.array([2.0], "float32"), "an": np.array([1.0], "float32"),
         "au": np.array([0.5], "float32"), "w": np.abs(x(10, 1)) + 0.1},
        []),
}

for _red in ("none", "sum", "batchmean", "mean"):
    CASES["kldiv_loss_" + _red] = (
        lambda f, v, r=_red: f.layers.kldiv_loss(v["x"], v["t"],
                                                 reduction=r),
        {"x": np.log(_probs(4, 5)), "t": np.where(
            np.arange(20).reshape(4, 5) % 7 == 0, 0.0,
            _probs(4, 5, seed=1)).astype("float32")}, ["x"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_nn_loss_metric_op_matches_reference(case):
    build, feeds, grad_feeds = CASES[case]
    run_pair(build, feeds, grad_feeds, what=case)


def _hsig_custom(v, w, b, table, code):
    """The custom tree's loss in numpy: per row the sum over its path of
    softplus(x . w_node + b_node) - bit * (x . w_node + b_node)."""
    out = []
    for r in range(v.shape[0]):
        total = 0.0
        for node, bit in zip(table[r], code[r]):
            if node < 0:
                continue
            pre = float(v[r] @ w[node] + b[node, 0])
            total += np.logaddexp(0.0, pre) - bit * pre
        out.append([total])
    return np.array(out, "float32")


def test_hsigmoid_custom_tree_against_its_formula():
    table = np.array([[0, 2, -1], [1, 3, 4], [0, -1, -1], [2, 4, 1]],
                     "int64")
    code = np.array([[1, 0, 0], [0, 1, 1], [1, 0, 0], [0, 0, 1]], "int64")
    feeds = {"x": x(4, 3), "y": ints(0, 5, (4, 1)), "t": table, "c": code}

    def build(fluid, v):
        return fluid.layers.hsigmoid(v["x"], v["y"], 5,
                                     path_table=v["t"], path_code=v["c"],
                                     is_custom=True)

    got, (main, scope) = run_layers(tfluid, build, feeds, [])
    params = {p.name: scope.get(p.name).numpy()
              for p in main.global_block().all_parameters()}
    w = next(a for a in params.values() if a.shape == (5, 3))
    b = next(a for a in params.values() if a.shape == (5, 1))
    close(got[0], _hsig_custom(feeds["x"], w, b, table, code), "custom")


def test_sampled_softmax_customized_samples_value_for_value(monkeypatch):
    """The port with customized samples (each row's label, then the
    shared negatives, with their log-uniform probabilities) against the
    reference drawing those negatives."""
    import jax.numpy as jnp
    import paddle_tpu as jfluid
    from paddle_tpu.ops import nn as j_nn

    n_cls, s_cnt, b = 20, 6, 5
    neg = np.array([3, 0, 11, 3, 7, 19], "int64")
    monkeypatch.setattr(j_nn, "_draw_negatives",
                        lambda *a, **k: jnp.asarray(neg, jnp.int32))
    label = np.array([[3], [5], [0], [19], [12]], "int64")
    samples = np.concatenate([label, np.tile(neg, (b, 1))], axis=1)
    c = samples.astype("float32")
    probs = (np.log((c + 2.0) / (c + 1.0)) / np.log(n_cls + 1.0)).astype(
        "float32")
    feeds = {"z": x(b, n_cls, scale=2), "y": label, "s": samples,
             "p": probs}

    def build(fluid, v):
        if fluid is jfluid:
            return fluid.layers.sampled_softmax_with_cross_entropy(
                v["z"], v["y"], s_cnt)
        return fluid.layers.sampled_softmax_with_cross_entropy(
            v["z"], v["y"], s_cnt, use_customized_samples=True,
            customized_samples=v["s"], customized_probabilities=v["p"])

    run_pair(build, feeds, ["z"], what="sampled softmax")


def _draws(op, attrs, slot, value, dtype="float32", runs=2):
    """``runs`` calls of a program of one random ``op`` reading the fed
    ``value`` at ``slot`` → (each call's output); every op capturable."""
    tfluid.unique_name.switch()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        v = tfluid.layers.data("v", shape=list(value.shape),
                               dtype=str(value.dtype),
                               append_batch_size=False)
        out = append(tfluid, op, {slot: v}, attrs, dtype=dtype)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = Scope()
    exe.run(startup, scope=scope)
    vals = [np.asarray(exe.run(main, feed={"v": value}, fetch_list=[out],
                               scope=scope)[0]) for _ in range(runs)]
    for op_ in main.global_block().ops:
        assert t_registry.get_op_def(op_.type).is_capturable(
            op_.attrs, op_.inputs), op_.type
    return vals


def test_uniform_random_batch_size_like_moments_and_replays():
    """The batch dim from the input, U(min, max) moments within 5
    standard errors, new values every run (the executor's compiled
    step: run 1 eager, run 2 captured, run 3 replayed on a card), with
    a ``seed`` attr too: the reference ignores it and draws per step."""
    attrs = {"shape": [-1, 40], "min": -2.0, "max": 3.0}
    vals = _draws("uniform_random_batch_size_like", attrs, "Input",
                  x(300, 2), runs=3)
    a = vals[0]
    assert a.shape == (300, 40) and a.dtype == np.float32
    assert a.min() >= -2.0 and a.max() < 3.0
    n, var = a.size, 25.0 / 12
    assert abs(a.mean() - 0.5) < 5 * np.sqrt(var / n)
    assert abs(a.var() - var) < 5 * np.sqrt(0.8 * var * var / n)
    assert (vals[0] != vals[1]).mean() > 0.99
    assert (vals[1] != vals[2]).mean() > 0.99
    seeded = _draws("uniform_random_batch_size_like", dict(attrs, seed=5),
                    "Input", x(300, 2), runs=3)
    assert (seeded[0] != seeded[1]).mean() > 0.99
    assert (seeded[1] != seeded[2]).mean() > 0.99


def test_gaussian_random_batch_size_like_moments():
    vals = _draws("gaussian_random_batch_size_like",
                  {"shape": [40, -1], "mean": 1.0, "std": 2.0,
                   "input_dim_idx": 1, "output_dim_idx": 1}, "Input",
                  x(3, 250))
    a = vals[0]
    assert a.shape == (40, 250)
    n = a.size
    assert abs(a.mean() - 1.0) < 5 * 2.0 / np.sqrt(n)
    assert abs(a.std() - 2.0) < 5 * 2.0 / np.sqrt(2 * n)
    assert (vals[0] != vals[1]).mean() > 0.99


def test_sampling_id_follows_the_row_probabilities():
    p = np.tile(np.array([[0.1, 0.6, 0.0, 0.3]], "float32"), (4000, 1))
    vals = _draws("sampling_id", {}, "X", p, dtype="int64")
    a = vals[0]
    assert a.shape == (4000,) and a.dtype == np.int64
    freq = np.bincount(a, minlength=4) / a.size
    assert freq[2] == 0.0
    se = np.sqrt(0.25 / a.size)
    np.testing.assert_array_less(np.abs(freq - p[0]), 5 * se)
    assert (vals[0] != vals[1]).any()


def test_sampled_softmax_draws_on_the_device():
    """The log-uniform draw: loss finite, negatives in range, a fresh
    draw every run, the op capturable."""
    feeds = {"z": x(6, 50), "y": ints(0, 50, (6, 1))}

    def build(fluid, v):
        return fluid.layers.sampled_softmax_with_cross_entropy(
            v["z"], v["y"], 8)

    first, (main, scope) = run_layers(tfluid, build, feeds, [])
    exe = tfluid.Executor(tfluid.CPUPlace())
    loss = main.global_block().ops[-1].output("Loss")[0]
    again = np.asarray(exe.run(main, feed=feeds, fetch_list=[loss],
                               scope=scope)[0])
    assert first[0].shape == (6, 1) and np.isfinite(first[0]).all()
    assert (first[0] != again).any()
    for op in main.global_block().ops:
        assert t_registry.get_op_def(op.type).is_capturable(
            op.attrs, op.inputs), op.type


def _seeded_negatives(build, fetch, runs=3):
    """The fetched ``fetch`` op output of a program of one seeded
    sampler op (``build(fluid, z, y)`` → the op's outputs), ``runs``
    calls → each call's value; the program's ops all capturable."""
    tfluid.unique_name.switch()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        z = tfluid.layers.data("z", shape=[8], dtype="float32")
        y = tfluid.layers.data("y", shape=[1], dtype="int64")
        build(tfluid, z, y)
    op = main.global_block().ops[-1]
    assert t_registry.get_op_def(op.type).is_capturable(op.attrs, op.inputs)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = Scope()
    exe.run(startup, scope=scope)
    feed = {"z": x(6, 8), "y": ints(0, 8, (6, 1))}
    return [np.asarray(exe.run(main, feed=feed, fetch_list=[
        op.output(fetch)[0]], scope=scope)[0]) for _ in range(runs)]


@pytest.mark.parametrize("op", ["sampled_softmax", "nce"])
def test_a_seeded_sampler_draws_new_negatives_every_step(op):
    """A nonzero ``seed`` is folded into the per-step draw, as the
    reference folds it into its step key: three steps, three draws.
    ``nce`` shows its negatives (``SampleLabels``); the sampled softmax
    its probabilities over them, which move with the draw."""
    if op == "nce":
        vals = _seeded_negatives(
            lambda f, z, y: f.layers.nce(z, y, 1000, num_neg_samples=16,
                                         seed=7), "SampleLabels")
        for v in vals:
            assert v.shape == (6, 17) and v.min() >= 0 and v.max() < 1000
        vals = [v[0, 1:] for v in vals]
    else:
        vals = _seeded_negatives(
            lambda f, z, y: f.layers.sampled_softmax_with_cross_entropy(
                f.layers.fc(z, 1000), y, 16, seed=7), "Softmax")
    assert (vals[0] != vals[1]).any() and (vals[1] != vals[2]).any()


def test_new_ops_are_registered_with_the_reference_flags():
    with_grad = ("lookup_table_v2", "lookup_sparse_table", "huber_loss",
                 "smooth_l1_loss", "label_smooth", "selu", "multiplex",
                 "add_position_encoding", "data_norm",
                 "hierarchical_sigmoid", "sampled_softmax_with_cross_entropy",
                 "log_loss", "kldiv_loss", "rank_loss", "margin_rank_loss",
                 "bpr_loss", "teacher_student_sigmoid_loss")
    no_grad = ("one_hot_v2", "sampling_id", "uniform_random_batch_size_like",
               "gaussian_random_batch_size_like", "hash", "mean_iou",
               "precision_recall", "positive_negative_pair")
    for t in with_grad:
        assert not t_registry.get_op_def(t).no_grad, t
        assert t_registry.has_op(t + "_grad"), t
    for t in no_grad:
        d = t_registry.get_op_def(t)
        assert d.no_grad and d.capturable is True, t
