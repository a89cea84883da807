"""The attention and softmax_xent rewrites against the reference's
(``tests/test_fusion.py``).

The same program-building code runs in both packages (unique names
reset), and ``resolve_fused_program`` must give the same program op for
op and the same report: families, op indices, vars and predicted bytes
(the attention rewrite's ``flash_kernel`` names the port's kernel where
the reference says ``"tpu"``).  Numerics on the CPU, where the port's K1
runs its plain version and the reference its Pallas kernel in interpret
mode, from the reference's parameters (``paddle_tpu_torch.convert``):

* bert-tiny built with ``fuse_attn=False`` and ``PADDLE_TPU_FLASH_MIN_T``
  lowered: 2 Adam steps' losses and parameters against the reference's,
  and against the port's own unfused run;
* softmax → cross_entropy with hard labels, ``ignore_index`` and soft
  labels, forward-only and trained by SGD, against the reference and the
  unfused port.

Every skip has a case: the reference's (a bias that needs a gradient,
``downgrade_in_infer`` dropout, T below the threshold, dynamic dims; a
label produced after the softmax, probabilities with a second gradient,
a differentiable soft label) with the reference's text, and the port's
own skip for shapes K1 cannot take, where the reference rewrites.
"""

import copy
import re

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.models import bert as jbert
from paddle_tpu.static_analysis import fusion as jfusion

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.static_analysis import fusion as tfusion

T = 128
BATCH = 4
STEPS = 2
LR = 1e-4
LOSS_RTOL = 1e-5
# Adam moves a parameter whose gradient is near zero by up to lr a step
# whichever way the last bits round
PARAM_ATOL = 2 * LR * STEPS
SMALL_RTOL = 1e-5

# the reference's gate texts that name its backend, with the port's
THRESHOLD_TEXT = (r" \(XLA's unblocked attention is faster there, r05 "
                  r"sweep; PADDLE_TPU_FLASH_MIN_T re-decides\)",
                  " (PADDLE_TPU_FLASH_MIN_T re-decides)")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_FLASH_MIN_T", raising=False)
    monkeypatch.delenv("PADDLE_TPU_FUSION", raising=False)
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")


def _ops(program):
    return [(op.type, op.inputs, op.outputs) for op in
            program.global_block().ops]


def _applied(report):
    out = []
    for r in report.applied:
        pred = dict(r.predicted)
        if pred.get("flash_kernel") in ("tpu", "flash_attention_fwd"):
            pred["flash_kernel"] = "K1"
        out.append((r.family, tuple(r.op_idxs), tuple(r.vars), pred))
    return out


def _skipped(report):
    return [(s.family, s.op_idx, s.op_type,
             re.sub(THRESHOLD_TEXT[0], THRESHOLD_TEXT[1], s.reason))
            for s in report.skipped]


def _resolve_both(build):
    """``build(fluid)`` → (program, fetch vars) in each package; the two
    resolved programs and reports."""
    out = []
    for fluid, fusion in ((jfluid, jfusion), (tfluid, tfusion)):
        fluid.unique_name.switch()
        prog, fetch = build(fluid)
        resolved, report = fusion.resolve_fused_program(
            prog, targets=[v.name for v in fetch])
        out.append((prog, fetch, resolved, report))
    return out


def _assert_same_resolve(j, t):
    assert _ops(t[2]) == _ops(j[2])
    assert _applied(t[3]) == _applied(j[3])
    assert _skipped(t[3]) == _skipped(j[3])


# ---------------------------------------------------------------------------
# attention: bert-tiny built unfused
# ---------------------------------------------------------------------------


def _bert(fluid, bert, train=True, **kw):
    cfg = copy.copy(bert.BERT_TINY)
    cfg.fuse_attn = False
    cfg.dropout = kw.pop("dropout", 0.0)
    cfg.attn_dropout = kw.pop("attn_dropout", cfg.dropout)
    with fluid.unique_name.guard():
        return bert.build_pretrain(cfg, seq_len=T, lr=LR, train=train, **kw)


@pytest.mark.parametrize("train, attn_dropout", [(True, 0.1), (False, 0.0)])
def test_bert_unfused_attention_rewrites_like_the_reference(
        monkeypatch, train, attn_dropout):
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_T", "64")
    res = []
    for fluid, bert, fusion in ((jfluid, jbert, jfusion),
                                (tfluid, tbert, tfusion)):
        main, _, _, loss = _bert(fluid, bert, train=train,
                                 attn_dropout=attn_dropout)
        res.append((main, None) + fusion.resolve_fused_program(
            main, targets=[loss.name]))
    _assert_same_resolve(*res)
    report = res[1][3]
    assert report.counts()["attention"] == 2
    types = [op.type for op in res[1][2].global_block().ops]
    assert "softmax" not in types
    assert types.count("fused_multihead_attention") == 2
    assert types.count("fused_multihead_attention_grad") == (2 if train
                                                             else 0)
    att = [r for r in report.applied if r.family == "attention"]
    assert att[0].predicted["flash_kernel"] == "flash_attention_fwd"
    if attn_dropout:
        assert "mask stream differs" in att[0].note


def test_below_the_threshold_attention_stays_unfused_in_both():
    res = []
    for fluid, bert, fusion in ((jfluid, jbert, jfusion),
                                (tfluid, tbert, tfusion)):
        main, _, _, loss = _bert(fluid, bert)
        res.append((main, None) + fusion.resolve_fused_program(
            main, targets=[loss.name]))
    _assert_same_resolve(*res)
    skips = [s for s in res[1][3].skipped if s.family == "attention"]
    assert len(skips) == 2
    assert "T=128 below the flash engagement threshold 512" \
        in skips[0].reason


def _reference_run(main, startup, loss, feed):
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        params = {n: np.asarray(scope.get(n)) for n in
                  _param_names(main)}
        losses = [np.asarray(exe.run(main, feed=feed,
                                     fetch_list=[loss])[0])
                  for _ in range(STEPS)]
        final = {n: np.asarray(scope.get(n)) for n in params}
    return params, losses, final


def _param_names(main):
    return [p.name for p in main.all_parameters()]


def _port_run(main, startup, loss, feed, params):
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        convert.load_params_into_scope(params, scope, "cpu", program=main)
        losses = [exe.run(main, feed=feed, fetch_list=[loss])[0]
                  for _ in range(STEPS)]
        final = {n: scope.get(n).numpy() for n in params}
    return losses, final


def test_bert_unfused_adam_steps_match_the_reference(monkeypatch):
    """2 Adam steps of bert-tiny built unfused and rewritten onto K1 in
    both packages: losses within 1e-5 relative, parameters within what
    Adam's rounding allows; and the port rewritten against the port left
    unfused (``PADDLE_TPU_FLASH_MIN_T=4096``)."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_T", "64")
    jmain, jstart, _, jloss = _bert(jfluid, jbert)
    tmain, tstart, _, tloss = _bert(tfluid, tbert)
    feed = jbert.make_fake_batch(BATCH, T, jbert.BERT_TINY,
                                 np.random.RandomState(0))
    params, want, want_final = _reference_run(jmain, jstart, jloss, feed)
    got, got_final = _port_run(tmain, tstart, tloss, feed, params)
    np.testing.assert_allclose(np.ravel(got), np.ravel(want),
                               rtol=LOSS_RTOL)
    for n in params:
        np.testing.assert_allclose(got_final[n], want_final[n],
                                   atol=PARAM_ATOL, rtol=0, err_msg=n)
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_T", "4096")
    unfused, _ = _port_run(tmain, tstart, tloss, feed, params)
    np.testing.assert_allclose(np.ravel(got), np.ravel(unfused),
                               rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# attention: one chain, each gate
# ---------------------------------------------------------------------------

H, TQ, DH = 2, 8, 16


def _attention(fluid, dh=DH, dv=None, tq=TQ, dtype="float32",
               dropout=None, bias_grad=False, train=False):
    """q from an fc (a parameter, so a training program has grads), k
    and v fed; scores·α (+ [B,1,1,Tk] bias) → softmax → (dropout) → ·V."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[H, tq, dh], dtype=dtype)
        q = fluid.layers.fc(x, size=dh, num_flatten_dims=3,
                            bias_attr=False)
        k = fluid.layers.data("k", shape=[H, TQ, dh], dtype=dtype)
        v = fluid.layers.data("v", shape=[H, TQ, dv or dh], dtype=dtype)
        bias = fluid.layers.data("bias", shape=[1, 1, TQ], dtype=dtype)
        bias.stop_gradient = not bias_grad
        s = fluid.layers.matmul(q, k, transpose_y=True, alpha=0.25)
        s = fluid.layers.elementwise_add(s, bias)
        p = fluid.layers.softmax(s)
        if dropout is not None:
            p = fluid.layers.dropout(p, 0.1,
                                     dropout_implementation=dropout)
        out = fluid.layers.matmul(p, v)
        fetch = [out]
        if train:
            loss = fluid.layers.mean(out)
            fluid.backward.append_backward(loss)
            fetch = [loss]
    return main, startup, fetch


SKIPS = {
    "bias needs a gradient": (dict(bias_grad=True, train=True), "1",
                              "requires a gradient"),
    "downgrade_in_infer": (dict(dropout="downgrade_in_infer"), "1",
                           "downgrade_in_infer"),
    "below the threshold": ({}, None, "T=8 below the flash engagement "
                            "threshold 512 (PADDLE_TPU_FLASH_MIN_T "
                            "re-decides)"),
    "dynamic dims": (dict(tq=-1), "1", "dynamic head/seq dims [-1]"),
}


@pytest.mark.parametrize("case", sorted(SKIPS))
def test_attention_skip_is_the_reference_s(monkeypatch, case):
    kw, min_t, reason = SKIPS[case]
    if min_t is not None:
        monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_T", min_t)
    j, t = _resolve_both(lambda fl: _attention(fl, **kw)[::2])
    _assert_same_resolve(j, t)
    assert not t[3].applied or "attention" not in t[3].counts()
    skips = [s for s in t[3].skipped if s.family == "attention"]
    assert len(skips) == 1 and reason in skips[0].reason


PORT_SKIPS = {
    "head dim 160": (dict(dh=160), "head dim 160 — the flash kernels "
                     "take 1 to 128"),
    "float16": (dict(dtype="float16"), "q/k/v dtypes float16/float16/"
                "float16 — the flash kernels take float32 or bfloat16"),
    "v head dim 32": (dict(dv=32), "k and v alike"),
}


@pytest.mark.parametrize("case", sorted(PORT_SKIPS))
@pytest.mark.parametrize("train", [False, True])
def test_port_skips_shapes_k1_cannot_take(monkeypatch, case, train):
    """The reference rewrites these chains (its fused op falls back to
    XLA inside itself); the port's gate leaves them unfused with the
    reason, since its op launches K1 or raises on a CUDA tensor."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_T", "1")
    kw, reason = PORT_SKIPS[case]
    j, t = _resolve_both(
        lambda fl: _attention(fl, train=train, **kw)[::2])
    assert j[3].counts().get("attention") == 1
    assert "attention" not in t[3].counts()
    skips = [s for s in t[3].skipped if s.family == "attention"]
    assert len(skips) == 1 and reason in skips[0].reason
    assert skips[0].reason.endswith("the chain stays unfused")
    assert "softmax" in [op.type for op in t[2].global_block().ops]


@pytest.mark.parametrize("dropout", [None, "upscale_in_train"])
def test_attention_chain_rewritten_computes_the_unfused_chain(
        monkeypatch, dropout):
    """The rewritten chain's output equals the unfused chain's in the port
    (rate 0 at inference: ``is_test`` drops nothing) and the reference's
    rewritten chain."""
    rng = np.random.RandomState(4)
    feed = {"x": rng.randn(3, H, TQ, DH).astype("float32"),
            "k": rng.randn(3, H, TQ, DH).astype("float32"),
            "v": rng.randn(3, H, TQ, DH).astype("float32"),
            "bias": np.where(rng.rand(3, 1, 1, TQ) < 0.25, -1e4,
                             0.0).astype("float32")}
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_T", "1")
    outs = {}
    for fluid in (jfluid, tfluid):
        fluid.unique_name.switch()
        main, startup, (out,) = _attention(fluid, dropout=dropout)
        test_prog = main.clone(for_test=True)
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = fluid.Executor(fluid.CPUPlace())
            if fluid is jfluid:
                exe.run(startup)
                w = {p.name: np.asarray(scope.get(p.name))
                     for p in main.all_parameters()}
            else:
                for n, a in w.items():
                    scope.set(n, a)
            outs[fluid] = np.asarray(exe.run(test_prog, feed=feed,
                                             fetch_list=[out])[0])
            if fluid is tfluid:
                monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_T", "4096")
                outs["unfused"] = exe.run(test_prog, feed=feed,
                                          fetch_list=[out])[0]
    np.testing.assert_allclose(outs[tfluid], outs["unfused"],
                               rtol=SMALL_RTOL, atol=1e-6)
    np.testing.assert_allclose(outs[tfluid], outs[jfluid],
                               rtol=SMALL_RTOL, atol=1e-6)


# ---------------------------------------------------------------------------
# softmax_xent
# ---------------------------------------------------------------------------

C = 10


def _xent(fluid, soft=False, ignore_index=-100, train=False):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[16], dtype="float32")
        if soft:
            label = fluid.layers.data("label", shape=[C], dtype="float32")
        else:
            label = fluid.layers.data("label", shape=[1], dtype="int64")
        p = fluid.layers.softmax(fluid.layers.fc(x, size=C))
        ce = fluid.layers.cross_entropy(p, label, soft_label=soft,
                                        ignore_index=ignore_index)
        loss = fluid.layers.mean(ce)
        if train:
            fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return main, startup, [loss, p]


def _xent_feed(soft, ignore_index):
    rng = np.random.RandomState(7)
    feed = {"x": rng.randn(6, 16).astype("float32")}
    if soft:
        lab = rng.rand(6, C).astype("float32")
        feed["label"] = lab / lab.sum(1, keepdims=True)
    else:
        lab = rng.randint(0, C, (6, 1)).astype("int64")
        if ignore_index >= 0:
            lab[::3] = ignore_index
        feed["label"] = lab
    return feed


XENT_CASES = [(False, -100), (False, 3), (True, -100)]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("soft, ignore_index", XENT_CASES)
def test_softmax_xent_rewrites_and_trains_like_the_reference(
        monkeypatch, soft, ignore_index, train):
    res, runs = [], {}
    feed = _xent_feed(soft, ignore_index)
    for fluid, fusion in ((jfluid, jfusion), (tfluid, tfusion)):
        fluid.unique_name.switch()
        main, startup, fetch = _xent(fluid, soft, ignore_index, train)
        res.append((main, fetch) + fusion.resolve_fused_program(
            main, targets=[v.name for v in fetch]))
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup)
            if fluid is jfluid:
                w = {p.name: np.asarray(scope.get(p.name))
                     for p in main.all_parameters()}
            else:
                convert.load_params_into_scope(w, scope, "cpu",
                                               program=main)
            runs[fluid] = [[np.asarray(a) for a in exe.run(
                main, feed=feed, fetch_list=fetch)] for _ in range(3)]
            if fluid is tfluid:
                convert.load_params_into_scope(w, scope, "cpu",
                                               program=main)
                monkeypatch.setenv("PADDLE_TPU_FUSION", "0")
                runs["unfused"] = [exe.run(main, feed=feed,
                                           fetch_list=fetch)
                                   for _ in range(3)]
    _assert_same_resolve(*res)
    counts = res[1][3].counts()
    assert counts.get("softmax_xent") == 1
    types = [op.type for op in res[1][2].global_block().ops]
    assert "cross_entropy" not in types and "softmax" not in types
    assert types.count("softmax_with_cross_entropy_grad") == int(train)
    for other in (jfluid, "unfused"):
        for got, want in zip(runs[tfluid], runs[other]):
            for g, w_ in zip(got, want):
                np.testing.assert_allclose(g, w_, rtol=SMALL_RTOL,
                                           atol=1e-6)


def _xent_label_after(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[16], dtype="float32")
        p = fluid.layers.softmax(fluid.layers.fc(x, size=C))
        label = fluid.layers.softmax(fluid.layers.fc(x, size=C))
        loss = fluid.layers.mean(fluid.layers.cross_entropy(
            p, label, soft_label=True))
    return main, [loss]


def _xent_second_grad(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[16], dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        p = fluid.layers.softmax(fluid.layers.fc(x, size=C))
        loss = fluid.layers.elementwise_add(
            fluid.layers.mean(fluid.layers.cross_entropy(p, label)),
            fluid.layers.mean(p))
        fluid.backward.append_backward(loss)
    return main, [loss]


def _xent_soft_label_grad(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[16], dtype="float32")
        label = fluid.layers.softmax(fluid.layers.fc(x, size=C))
        p = fluid.layers.softmax(fluid.layers.fc(x, size=C))
        loss = fluid.layers.mean(fluid.layers.cross_entropy(
            p, label, soft_label=True))
        fluid.backward.append_backward(loss)
    return main, [loss]


XENT_SKIPS = {
    "label produced after the softmax": (_xent_label_after,
                                         "is produced after the softmax"),
    "probabilities with a second gradient": (
        _xent_second_grad, "receives gradients from outside the "
        "cross_entropy"),
    "differentiable soft label": (_xent_soft_label_grad,
                                  "the fused op emits no Label@GRAD"),
}


@pytest.mark.parametrize("case", sorted(XENT_SKIPS))
def test_softmax_xent_skip_is_the_reference_s(case):
    build, reason = XENT_SKIPS[case]
    j, t = _resolve_both(build)
    _assert_same_resolve(j, t)
    assert "softmax_xent" not in t[3].counts()
    skips = [s for s in t[3].skipped if s.family == "softmax_xent"]
    assert len(skips) == 1 and reason in skips[0].reason


@pytest.mark.parametrize("ignore_index, labels", [
    (-100, [[0], [9], [3], [1]]),
    (3, [[0], [3], [2], [-2]]),       # ignored, and a negative label
    (-100, [[0], [12], [2], [1]]),    # a label >= C: NaN, as jnp.take
])
def test_cross_entropy_op_is_the_reference_s(ignore_index, labels):
    """The registered ``cross_entropy`` op, hard and soft, against the
    reference's lowering on the same probabilities."""
    import jax.numpy as jnp
    import torch

    from paddle_tpu.ops import registry as jreg
    from paddle_tpu_torch.ops import registry as treg

    rng = np.random.RandomState(11)
    p = rng.rand(4, C).astype("float32")
    p /= p.sum(1, keepdims=True)
    lab = np.asarray(labels, "int64")
    for soft, label in ((False, lab), (True, p[::-1].copy())):
        attrs = {"ignore_index": ignore_index, "soft_label": soft}
        want = jreg.get_op_def("cross_entropy").fn(
            None, dict(attrs), jnp.asarray(p), jnp.asarray(label))
        got = treg.get_op_def("cross_entropy").fn(
            None, dict(attrs), torch.from_numpy(p),
            torch.from_numpy(label))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)


def test_fusion_signature_carries_the_threshold_and_autotune_state(
        monkeypatch, tmp_path):
    from paddle_tpu_torch import autotune

    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    autotune.reset()
    config = tfusion.FusionConfig()
    a = config.signature()
    autotune.record_flash_min_t(128)  # the autotune cache's decision
    b = config.signature()
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_T", "256")  # the override
    c = config.signature()
    autotune.record("x", {"params": {}})  # an entry no fusion reads
    assert config.signature() == c
    assert len({a, b, c}) == 3
    assert tfusion.FusionConfig(fuse_attention=False).signature() != c
    autotune.reset()
