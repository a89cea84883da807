"""The contrib seq2seq decoder DSL of the PyTorch port against the
reference.

The reference's copy-task test (``tests/test_contrib_decoder.py``) runs on
the port: a ``StateCell`` trained through ``TrainingDecoder`` (a
``DynamicRNN``) and the same cell decoding through
``BeamSearchDecoder.decode`` (a bounded ``While``) reproduces the source.
Then both packages build the same programs, the reference's parameters
are copied into the port by name, and five Adam steps on the same seeded
batches give losses within 1e-5 (relative); beam decoding from the same
trained parameters gives equal ids and scores within 1e-5.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import scope_guard as j_scope_guard

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.convert import load_params_into_scope
from paddle_tpu_torch.executor import Scope, scope_guard

V, L, EMB, H = 12, 4, 24, 48
START, END = 1, 2
TOL = 1e-5


def _encode(fluid, src):
    emb = fluid.layers.embedding(src, size=[V, EMB],
                                 param_attr=fluid.ParamAttr(name="src_emb"))
    flat = fluid.layers.reshape(emb, shape=[-1, L * EMB])
    return fluid.layers.fc(flat, size=H, act="tanh",
                           param_attr=fluid.ParamAttr(name="enc_w"),
                           bias_attr=fluid.ParamAttr(name="enc_b"))


def _make_cell(fluid, init_h):
    cell = fluid.contrib.StateCell(
        inputs={"x": None},
        states={"h": fluid.contrib.InitState(init=init_h)},
        out_state="h")

    @cell.state_updater
    def updater(c):
        nh = fluid.layers.fc(
            fluid.layers.concat([c.get_input("x"), c.get_state("h")],
                                axis=1),
            size=H, act="tanh", param_attr=fluid.ParamAttr(name="dec_w"),
            bias_attr=fluid.ParamAttr(name="dec_b"))
        c.set_state("h", nh)

    return cell


def _build_train(fluid, lr=5e-3):
    fluid.unique_name.switch()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.layers.data("src", shape=[L], dtype="int64")
        tgt_in = fluid.layers.data("tgt_in", shape=[L + 1], dtype="int64")
        tgt_out = fluid.layers.data("tgt_out", shape=[L + 1, 1],
                                    dtype="int64")
        cell = _make_cell(fluid, _encode(fluid, src))
        tgt_emb = fluid.layers.embedding(
            tgt_in, size=[V, EMB], param_attr=fluid.ParamAttr(name="bsd_emb"))
        decoder = fluid.contrib.TrainingDecoder(cell)
        with decoder.block():
            tok = decoder.step_input(tgt_emb)
            cell.compute_state(inputs={"x": tok})
            out = cell.out_state()
            cell.update_states()
            decoder.output(out)
        logits = fluid.layers.fc(
            decoder(), size=V, num_flatten_dims=2,
            param_attr=fluid.ParamAttr(name="bsd_out_w"),
            bias_attr=fluid.ParamAttr(name="bsd_out_b"))
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, tgt_out))
        fluid.optimizer.Adam(lr).minimize(loss)
    return main, startup, loss


def _build_infer(fluid, b, k, max_len):
    fluid.unique_name.switch()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.layers.data("src", shape=[b, L], dtype="int64",
                                append_batch_size=False)
        cell = _make_cell(fluid, _encode(fluid, src))
        init_ids = fluid.layers.fill_constant([b, k], "int32", float(START))
        zero_col = fluid.layers.fill_constant([b, 1], "float32", 0.0)
        ninf = fluid.layers.fill_constant([b, k - 1], "float32", -1e9)
        init_scores = fluid.layers.concat([zero_col, ninf], axis=1)
        decoder = fluid.contrib.BeamSearchDecoder(
            cell, init_ids, init_scores, target_dict_dim=V, word_dim=EMB,
            max_len=max_len, beam_size=k, end_id=END, name="bsd")
        decoder.decode()
        sent_ids, sent_scores = decoder()
    return main, startup, sent_ids, sent_scores


def _batches(seed, n, rows):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = rng.randint(3, V, size=(rows, L))
        tgt_in = np.concatenate([np.full((rows, 1), START), toks], axis=1)
        tgt_out = np.concatenate([toks, np.full((rows, 1), END)],
                                 axis=1)[..., None]
        out.append((toks.astype("int64"), tgt_in.astype("int64"),
                    tgt_out.astype("int64")))
    return out


def _feed(batch):
    s, ti, to = batch
    return {"src": s, "tgt_in": ti, "tgt_out": to}


def test_decoder_dsl_trains_and_beam_decodes():
    b, k = 4, 3
    main, startup, loss = _build_train(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with scope_guard(Scope()):
        exe.run(startup)
        losses = [float(np.asarray(exe.run(
            main, feed=_feed(batch), fetch_list=[loss])[0]).reshape(()))
            for batch in _batches(0, 200, 16)]
        assert losses[-1] < losses[0] * 0.25, (losses[0], losses[-1])
        imain, _istartup, sent, scores = _build_infer(tfluid, b, k, L + 2)
        s = _batches(1, 1, b)[0][0]
        sids, sscores = exe.run(imain, feed={"src": s},
                                fetch_list=[sent, scores])
    assert sids.shape == (b, k, L + 2)
    correct = sum(1 for i in range(b) if sids[i, 0, :L].tolist()
                  == s[i].tolist())
    assert correct >= b - 1, (sids[:, 0], s)
    assert (sscores[:, 0] >= sscores[:, 1] - 1e-6).all()


def _params(program, scope):
    return {p.name: np.asarray(scope.get(p.name))
            for p in program.all_parameters()}


@pytest.fixture(scope="module")
def reference():
    """Five reference Adam steps from its own initialisation (losses,
    the initial and the trained parameters), then its beam decode of the
    trained model (ids, scores)."""
    main, startup, loss = _build_train(jfluid)
    exe = jfluid.Executor(jfluid.CPUPlace())
    with j_scope_guard(JScope()):
        scope = jfluid.global_scope()
        exe.run(startup)
        init = _params(main, scope)
        losses = [float(np.asarray(exe.run(
            main, feed=_feed(batch), fetch_list=[loss])[0]).reshape(()))
            for batch in _batches(5, 5, 8)]
        trained = _params(main, scope)
        imain, _s, sent, scores = _build_infer(jfluid, 4, 3, L + 3)
        src = _batches(6, 1, 4)[0][0]
        sids, sscores = exe.run(imain, feed={"src": src},
                                fetch_list=[sent, scores])
    return {"init": init, "losses": losses, "trained": trained,
            "src": src, "ids": np.asarray(sids),
            "scores": np.asarray(sscores)}


def test_training_losses_match_reference(reference):
    main, startup, loss = _build_train(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = Scope()
    exe.run(startup, scope=scope)
    assert set(reference["init"]) == {p.name for p in main.all_parameters()}
    load_params_into_scope(reference["init"], scope, program=main)
    losses = [float(np.asarray(exe.run(
        main, feed=_feed(batch), fetch_list=[loss], scope=scope)[0]
    ).reshape(())) for batch in _batches(5, 5, 8)]
    np.testing.assert_allclose(losses, reference["losses"], rtol=TOL)
    assert losses[-1] < losses[0]
    for name, ref in reference["trained"].items():
        got = np.asarray(scope.get(name))
        err = float(np.abs(got - ref).max())
        assert err <= TOL * max(1.0, float(np.abs(ref).max())), (name, err)


def test_beam_decode_matches_reference(reference):
    imain, startup, sent, scores = _build_infer(tfluid, 4, 3, L + 3)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = Scope()
    exe.run(startup, scope=scope)
    names = {p.name for p in imain.all_parameters()}
    load_params_into_scope({n: v for n, v in reference["trained"].items()
                            if n in names}, scope, program=imain)
    sids, sscores = exe.run(imain, feed={"src": reference["src"]},
                            fetch_list=[sent, scores], scope=scope)
    np.testing.assert_array_equal(np.asarray(sids), reference["ids"])
    np.testing.assert_allclose(np.asarray(sscores), reference["scores"],
                               rtol=TOL, atol=TOL)
    # the loop is a while over dense [B, K] records: one sub-block
    ops = [op.type for op in imain.global_block().ops]
    assert ops.count("while") == 1 and "beam_search_decode" in ops
