"""The NMT and stacked-LSTM models in the PyTorch port against the
reference, on the CPU, at small widths (embedding 16, hidden 32,
vocabulary 64, lengths 6, batch 4): ``build_train`` (StaticRNN decoder)
and ``build_train_dynamic`` (DynamicRNN decoder, length-masked loss)
losses over 3 Adam steps, ``build_infer``'s beam-search sentences and
scores from the trainers' weights (the programs share their parameters
by name), and ``stacked_dynamic_lstm``'s losses and accuracy.

The port builds the reference's programs, op for op: the same op types,
slots and attrs in every block.  It starts from the reference's
parameters (``convert``), which also carries the GRU and LSTM weights in
the reference's layout ([H, 3H] / [H, 4H], biases [1, 3H] / [1, 7H]).
Losses within rtol 1e-5, beam ids equal, scores within rtol 1e-5."""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.models import machine_translation as jmt
from paddle_tpu.models import stacked_dynamic_lstm as jsdl

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import machine_translation as tmt
from paddle_tpu_torch.models import stacked_dynamic_lstm as tsdl

RTOL = 1e-5
V, E, H, L, B = 64, 16, 32, 6, 4
STEPS = 3
MODELS = {"reference": (jfluid, jmt, jsdl), "port": (tfluid, tmt, tsdl)}
_INTERNAL_ATTRS = ("op_role", "op_namescope", "op_callstack")


def _nmt_feed():
    rng = np.random.RandomState(0)
    return {"src": rng.randint(3, V, (B, L)).astype("int64"),
            "tgt_in": rng.randint(3, V, (B, L)).astype("int64"),
            "tgt_out": rng.randint(3, V, (B, L, 1)).astype("int64"),
            "tgt_lens": np.array([6, 2, 4, 5], "int64")}


def _build(label, kind):
    fluid, mt, sdl = MODELS[label]
    fluid.unique_name.switch()
    if kind == "lstm":
        main, startup, feeds, loss, acc = sdl.build(
            vocab_size=V, seq_len=L, emb_dim=E, hidden_dim=8, stacked_num=3)
        return main, startup, feeds, [loss, acc]
    if kind == "infer":
        main, startup, feeds, ids, scores = mt.build_infer(
            V, emb_dim=E, hidden_dim=H, src_len=L, batch_size=B,
            beam_size=3, max_len=8)
        return main, startup, [f.name for f in feeds], [ids, scores]
    build = mt.build_train_dynamic if kind == "dynamic" else mt.build_train
    main, startup, feeds, loss = build(V, emb_dim=E, hidden_dim=H,
                                       src_len=L, tgt_len=L)
    return main, startup, [f.name for f in feeds], [loss]


def _attr(v):
    """An attr as compared: a var's int64 is int32 in the reference (jax
    without x64), so a dtype attr naming it is compared as int32."""
    return "int32" if v == "int64" else v


def _op_forms(program):
    """Every block's ops as (type, slots, attrs), internal attrs apart."""
    return [[(op.type, {k: list(v) for k, v in op.inputs.items()},
              {k: list(v) for k, v in op.outputs.items()},
              {k: _attr(v) for k, v in op.attrs.items()
               if not k.startswith("__") and k not in _INTERNAL_ATTRS})
             for op in block.ops] for block in program.blocks]


@pytest.mark.parametrize("kind", ["static", "dynamic", "infer", "lstm"])
def test_the_port_builds_the_reference_programs(kind):
    forms = {label: _op_forms(_build(label, kind)[0]) for label in MODELS}
    assert len(forms["port"]) == len(forms["reference"])
    for got, want in zip(forms["port"], forms["reference"]):
        assert [o[0] for o in got] == [o[0] for o in want]
        assert got == want


def _run(label, kind, feed, start=None, calls=STEPS):
    fluid = MODELS[label][0]
    main, startup, feeds, fetch = _build(label, kind)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        if start is None:
            start = convert.scope_persistables(main, scope)
        elif label == "reference":
            for n, v in start.items():
                scope.set(n, v)
        else:
            convert.load_params_into_scope(start, scope, "cpu",
                                           program=main)
        outs = [[np.asarray(v) for v in exe.run(
            main, feed={n: feed[n] for n in feeds}, fetch_list=fetch)]
            for _ in range(calls)]
        state = convert.scope_persistables(main, scope)
    return outs, start, state


def _both(kind, feed, calls=STEPS):
    want, start, wstate = _run("reference", kind, feed, calls=calls)
    got, _, gstate = _run("port", kind, feed, start, calls=calls)
    return got, want, start, gstate, wstate


@pytest.mark.parametrize("kind", ["static", "dynamic"])
def test_nmt_trainers_losses_over_adam_steps(kind):
    got, want, start, gstate, wstate = _both(kind, _nmt_feed())
    losses = [float(o[0].reshape(-1)[0]) for o in got]
    np.testing.assert_allclose(
        losses, [float(o[0].reshape(-1)[0]) for o in want], rtol=RTOL)
    assert losses[-1] < losses[0]
    # the GRU weights cross in the reference's layout
    assert start["enc_gru_w"].shape == (H, 3 * H)
    assert start["enc_gru_b"].shape == (1, 3 * H)
    for n in ("enc_gru_w", "dec_gru_gate_w", "tgt_emb", "out_b"):
        np.testing.assert_allclose(gstate[n], wstate[n], rtol=1e-4,
                                   atol=1e-6, err_msg=n)


def test_nmt_translation_sentences_and_scores():
    """``build_infer`` from the StaticRNN trainer's weights after its
    steps: the same beams, token for token, and their scores."""
    _, _, _, trained, _ = _both("static", _nmt_feed())
    infer = _build("port", "infer")[0]
    trained = {p.name: trained[p.name] for p in infer.all_parameters()}
    assert len(trained) == 14  # every parameter of the decoder is shared
    feed = {"src": _nmt_feed()["src"]}
    want, _, _ = _run("reference", "infer", feed, trained, calls=2)
    got, _, _ = _run("port", "infer", feed, trained, calls=2)
    for g, w in zip(got, want):
        ids, scores = g
        assert ids.shape == (B, 3, 8) and ids.dtype == w[0].dtype
        np.testing.assert_array_equal(ids, w[0])
        np.testing.assert_allclose(scores, w[1], rtol=RTOL)
        assert (np.diff(scores, axis=1) <= 0).all()


def test_stacked_dynamic_lstm_losses_and_accuracy():
    rng = np.random.RandomState(1)
    feed = {"words": rng.randint(0, V, (B, L)).astype("int64"),
            "lens": np.array([6, 2, 5, 3], "int64"),
            "label": rng.randint(0, 2, (B, 1)).astype("int64")}
    got, want, start, _, _ = _both("lstm", feed)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], w[0], rtol=RTOL)
        np.testing.assert_array_equal(g[1], w[1])
    # peepholes: the LSTM biases are [1, 7 * hidden]
    assert start["dynamic_lstm_0.b_0"].shape == (1, 7 * 8)
    assert start["dynamic_lstm_0.w_0"].shape == (8, 4 * 8)
