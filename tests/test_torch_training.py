"""The training slice of the PyTorch port against the reference package.

``append_backward`` and the optimizers build the same grad programs in
both packages, and a narrow BERT (vocab 1024, hidden 128, 2 layers, 2
heads, ffn 512) at T=128 trains the same in both on the CPU, where the
port's kernel wrappers run their plain PyTorch versions and the
reference runs its Pallas kernels in interpret mode.  The two packages'
random initialisers draw different numbers, so the port is held to the
reference's parameters through ``paddle_tpu_torch.convert``; inputs come
from seeded numpy.
"""

import collections
import copy

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.models import bert as jbert
from paddle_tpu.static_analysis import fusion as jfusion

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import registry as t_registry
from paddle_tpu_torch.static_analysis import fusion as tfusion

T = 128
BATCH = 4
STEPS = 3
LR = 1e-4
# float32 both sides; sums in another order through 2 layers and the
# vocab head
LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6
# Adam divides by sqrt(m2) + eps: a near-zero gradient whose sign flips
# between the packages moves its parameter by up to 2 lr per step
PARAM_ATOL = 2 * LR * STEPS


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")


def _cfg(bert, dropout):
    cfg = copy.copy(bert.BERT_TINY)
    cfg.fuse_attn = True
    cfg.dropout = dropout
    cfg.attn_dropout = dropout
    return cfg


def _pretrain(fluid, bert, dropout, **kw):
    """``build_pretrain`` with fresh unique names, so both packages name
    every var alike whatever ran before in the process."""
    with fluid.unique_name.guard():
        return bert.build_pretrain(_cfg(bert, dropout), seq_len=T, **kw)


def _op_counts(program):
    return collections.Counter(op.type for op in program.global_block().ops)


def _grad_names(program):
    """param name → its gradient's var name, read off the adam ops."""
    return {op.inputs["Param"][0]: op.inputs["Grad"][0]
            for op in program.global_block().ops if op.type == "adam"}


def _reference_params(program, scope):
    return {p.name: np.asarray(scope.get(p.name))
            for p in program.all_parameters()}


def _port_scope(program, startup, params):
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
    convert.load_params_into_scope(params, scope, "cpu", program=program)
    return scope, exe


def _fc_program(fluid, optimizer=None):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[16], dtype="float32")
        y = fluid.layers.data("y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, size=32, act="gelu")
        h = fluid.layers.layer_norm(h, begin_norm_axis=1)
        h = fluid.layers.elementwise_add(h, fluid.layers.fc(x, size=32))
        p = fluid.layers.fc(h, size=1)
        err = fluid.layers.elementwise_sub(p, y)
        loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(err, err))
        if optimizer is None:
            pg = fluid.backward.append_backward(loss)
        else:
            _, pg = optimizer(fluid).minimize(loss)
    return main, startup, loss, [(p.name, g.name) for p, g in pg]


def _fc_feed():
    rng = np.random.RandomState(3)
    return {"x": rng.randn(8, 16).astype("float32"),
            "y": rng.randn(8, 1).astype("float32")}


def test_append_backward_matches_reference_on_fc_program():
    jmain, jstart, jloss, jpg = _fc_program(jfluid)
    tmain, tstart, tloss, tpg = _fc_program(tfluid)
    assert _op_counts(tmain) == _op_counts(jmain)
    assert tpg == jpg
    feed = _fc_feed()
    fetch = [jloss.name] + [g for _, g in jpg]
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
        want = jexe.run(jmain, feed=feed, fetch_list=fetch)
    scope, exe = _port_scope(tmain, tstart, _reference_params(jmain, jscope))
    with tfluid.scope_guard(scope):
        got = exe.run(tmain, feed=feed, fetch_list=fetch)
    for name, g, w in zip(fetch, got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_gradients_matches_reference_on_fc_program():
    """``gradients`` (calc_gradient) of the loss with respect to an
    input and a hidden activation."""
    outs = {}
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[16], dtype="float32")
            x.stop_gradient = False
            h = fluid.layers.fc(x, size=32, act="gelu")
            loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(h, h))
            gx, gh = fluid.gradients([loss], [x, h])
        outs[fluid] = (main, startup, [gx.name, gh.name])
    jmain, jstart, fetch = outs[jfluid]
    tmain, tstart, tfetch = outs[tfluid]
    assert tfetch == fetch
    feed = {"x": _fc_feed()["x"]}
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
        want = jexe.run(jmain, feed=feed, fetch_list=fetch)
    scope, exe = _port_scope(tmain, tstart, _reference_params(jmain, jscope))
    with tfluid.scope_guard(scope):
        got = exe.run(tmain, feed=feed, fetch_list=fetch)
    for name, g, w in zip(fetch, got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_sgd_steps_match_reference():
    sgd = lambda fluid: fluid.optimizer.SGD(learning_rate=0.001)  # noqa
    jmain, jstart, jloss, jpg = _fc_program(jfluid, sgd)
    tmain, tstart, tloss, _ = _fc_program(tfluid, sgd)
    assert _op_counts(tmain) == _op_counts(jmain)
    feed = _fc_feed()
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
        params = _reference_params(jmain, jscope)
        want = [jexe.run(jmain, feed=feed, fetch_list=[jloss])[0]
                for _ in range(3)]
    scope, exe = _port_scope(tmain, tstart, params)
    with tfluid.scope_guard(scope):
        got = [exe.run(tmain, feed=feed, fetch_list=[tloss])[0]
               for _ in range(3)]
    assert got[2][0] < got[0][0]
    np.testing.assert_allclose(np.ravel(got), np.ravel(want), rtol=LOSS_RTOL)
    for name, _g in jpg:
        np.testing.assert_allclose(scope.get(name).numpy(),
                                   np.asarray(jscope.get(name)),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_resolved_training_program_fuses_like_the_reference():
    """Fused ops and their grad twins, op for op: 5 dropout_add_ln, 2
    bias_act and 3 embedding_gather rewrites of forward and grad."""
    jmain, _, _, jloss = _pretrain(jfluid, jbert, 0.1)
    tmain, _, _, tloss = _pretrain(tfluid, tbert, 0.1)
    assert _op_counts(tmain) == _op_counts(jmain)
    jprog, _ = jfusion.resolve_fused_program(jmain, targets=[jloss.name])
    tprog, report = tfusion.resolve_fused_program(tmain,
                                                  targets=[tloss.name])
    assert _op_counts(tprog) == _op_counts(jprog)
    assert report.counts() == {"dropout_add_ln": 5, "bias_act": 2,
                               "embedding_gather": 3}
    counts = _op_counts(tprog)
    for fused in ("fused_dropout_add_ln", "fused_bias_act",
                  "fused_embedding_gather", "fused_multihead_attention"):
        assert counts[fused] == counts[fused + "_grad"] > 0


def test_bert_tiny_adam_steps_match_reference(interpret):
    """3 Adam steps of bert-tiny MLM pretraining from the reference's
    parameters: losses, step-0 gradients and final parameters."""
    jmain, jstart, _, jloss = _pretrain(jfluid, jbert, 0.0, lr=LR)
    tmain, tstart, _, tloss = _pretrain(tfluid, tbert, 0.0, lr=LR)
    grads = _grad_names(jmain)
    assert _grad_names(tmain) == grads
    names = sorted(grads)
    feed = jbert.make_fake_batch(BATCH, T, jbert.BERT_TINY,
                                 np.random.RandomState(0))
    fetch0 = [jloss.name] + [grads[n] for n in names]
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
        params = _reference_params(jmain, jscope)
        want0 = jexe.run(jmain, feed=feed, fetch_list=fetch0)
        want_losses = [want0[0]] + [
            jexe.run(jmain, feed=feed, fetch_list=[jloss])[0]
            for _ in range(STEPS - 1)]
    scope, exe = _port_scope(tmain, tstart, params)
    with tfluid.scope_guard(scope):
        got0 = exe.run(tmain, feed=feed, fetch_list=fetch0)
        got_losses = [got0[0]] + [
            exe.run(tmain, feed=feed, fetch_list=[tloss])[0]
            for _ in range(STEPS - 1)]
    np.testing.assert_allclose(np.ravel(got_losses), np.ravel(want_losses),
                               rtol=LOSS_RTOL)
    assert got_losses[-1][0] < got_losses[0][0]
    for name, g, w in zip(names, got0[1:], want0[1:]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=grads[name])
    for name in names:
        np.testing.assert_allclose(scope.get(name).numpy(),
                                   np.asarray(jscope.get(name)),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)


def _dropout_run(steps=2):
    main, startup, _, loss = _pretrain(tfluid, tbert, 0.1)
    main.random_seed = startup.random_seed = 5
    feed = tbert.make_fake_batch(2, T, tbert.BERT_TINY,
                                 np.random.RandomState(1))
    grads = _grad_names(main)
    fetch = [loss.name, grads["bert.word_emb"],
             grads["bert.layer0.ln1.scale"]]
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        return [exe.run(main, feed=feed, fetch_list=fetch)
                for _ in range(steps)]


def test_dropout_training_repeats_bit_for_bit():
    """At rate 0.1 every mask is drawn from (program seed, step, op), so
    two runs from the same seed agree exactly, and the masks change from
    step to step."""
    first, again = _dropout_run(), _dropout_run()
    for a, b in zip(first, again):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert not np.array_equal(first[0][2], first[1][2])


def test_grad_op_without_its_forward_tape_raises():
    """A grad op differentiates the graph its forward recorded in the
    same run; without it, it raises rather than recompute."""
    opdef = t_registry.get_op_def("elementwise_add_grad")
    ctx = t_registry.LoweringContext()
    with pytest.raises(RuntimeError, match="never recomputes"):
        t_registry.call_op(opdef, ctx, {}, {"__fwd_op_id__": 42})


@pytest.mark.parametrize("ignore_index, labels", [
    (255, [[0], [255], [2], [1]]),      # an ignored label >= C: loss 0
    (-100, [[0], [7], [2], [1]]),       # a label >= C: NaN, as jnp.take
    (255, [[0], [7], [255], [-3]]),     # both, and a negative label
])
def test_softmax_with_cross_entropy_out_of_range_labels(ignore_index,
                                                        labels):
    """A label at or above the class count: the op masks and fills as
    the reference does (the ignored row's loss 0, another label >= C
    NaN, a negative label class 0) instead of gathering out of range;
    the Softmax output and the gradients of the rows in range agree."""
    import jax
    import jax.numpy as jnp
    import torch

    from paddle_tpu.ops import registry as j_registry

    rng = np.random.RandomState(12)
    logits = rng.randn(4, 3).astype("float32")
    lab = np.asarray(labels, "int64")
    attrs = {"ignore_index": ignore_index}
    want = j_registry.get_op_def("softmax_with_cross_entropy").fn(
        None, dict(attrs), jnp.asarray(logits), jnp.asarray(lab))
    x = torch.from_numpy(logits).requires_grad_()
    got = t_registry.get_op_def("softmax_with_cross_entropy").fn(
        None, dict(attrs), x, torch.from_numpy(lab))
    loss, wloss = got["Loss"].detach().numpy(), np.asarray(want["Loss"])
    np.testing.assert_array_equal(np.isnan(loss), np.isnan(wloss))
    assert np.isnan(wloss).any() == (7 in lab.ravel())
    keep = ~np.isnan(wloss)
    np.testing.assert_allclose(loss[keep], wloss[keep], rtol=1e-6,
                               atol=1e-7)
    assert (loss[lab == ignore_index] == 0).all()
    np.testing.assert_allclose(got["Softmax"].numpy(),
                               np.asarray(want["Softmax"]), rtol=1e-6)
    # gradient of the finite rows' sum, against jax.grad of the same
    finite = torch.from_numpy(keep.astype("float32"))
    torch.where(torch.from_numpy(keep), got["Loss"],
                torch.zeros_like(got["Loss"])).mul(finite).sum().backward()
    opfn = j_registry.get_op_def("softmax_with_cross_entropy").fn

    def jloss(z):
        out = opfn(None, dict(attrs), z, jnp.asarray(lab))["Loss"]
        return jnp.where(jnp.asarray(keep), out, 0.0).sum()

    np.testing.assert_allclose(x.grad.numpy(),
                               np.asarray(jax.grad(jloss)(
                                   jnp.asarray(logits))),
                               rtol=1e-5, atol=1e-6)
