"""Recompute regions in the PyTorch port: ``layers.recompute()``,
``RecomputeOptimizer`` and ``rewrite_program_recompute``, the
``recompute_block`` op and its grad, against the reference package and
against the same program without regions.

The classes mirror the reference's ``tests/test_recompute.py``.  Without
dropout a program trains the same with and without its regions; in the
port also with dropout, bit for bit, since a region's second run draws
the masks of its first (the same ops, ids and step).  Against the
reference the port starts from the reference's parameters
(``paddle_tpu_torch.convert``): losses to rtol 1e-5 over a few float32
layers, BERT-tiny's to 1e-4 and its gradients to rtol 1e-3 (sums in
another order through 2 layers and the vocab head; the reference runs
its Pallas kernels in interpret mode).
"""

import collections
import copy

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import executor as texecutor
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import control_flow as tcf

WIDTH = 64
DEPTH = 4
LOSS_RTOL = 1e-5
BERT_T = 64
BERT_LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6
BERT_LR = 1e-3
# Adam divides by sqrt(m2) + eps: a near-zero gradient whose sign flips
# between the packages moves its parameter by up to 2 lr a step
PARAM_ATOL = 2 * BERT_LR * 3


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")


def _mse(fluid, pred, y):
    err = fluid.layers.elementwise_sub(pred, y)
    return fluid.layers.mean(fluid.layers.elementwise_mul(err, err))


def _stack(fluid, h, depth, dropout=0.0):
    for _ in range(depth):
        h = fluid.layers.fc(h, size=WIDTH, act="relu")
        if dropout:
            h = fluid.layers.dropout(
                h, dropout, dropout_implementation="upscale_in_train")
    return h


def _build(fluid, use_recompute, dropout=0.0, regions=1, make_opt=None):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[WIDTH], dtype="float32")
        y = fluid.layers.data("y", shape=[1], dtype="float32")
        h = x
        for _ in range(regions):
            if use_recompute:
                with fluid.layers.recompute():
                    h = _stack(fluid, h, DEPTH // regions, dropout)
            else:
                h = _stack(fluid, h, DEPTH // regions, dropout)
        loss = _mse(fluid, fluid.layers.fc(h, size=1), y)
        (make_opt or (lambda f: f.optimizer.SGD(learning_rate=0.05)))(
            fluid).minimize(loss)
    return main, startup, loss


def _feed(seed=0, batch=8):
    x = np.random.RandomState(seed).randn(batch, WIDTH).astype("float32")
    return {"x": x, "y": (x.sum(1, keepdims=True) > 0).astype("float32")}


def _losses(fluid, main, startup, loss, feed, steps, start=None,
            place=None):
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        if start is not None:
            convert.load_params_into_scope(start, scope, "cpu",
                                           program=main)
        first = convert.scope_persistables(main, scope)
        out = [float(np.asarray(exe.run(main, feed=feed,
                                        fetch_list=[loss])[0]).ravel()[0])
               for _ in range(steps)]
    return out, first


def _types(program, block=0):
    return [op.type for op in program.block(block).ops]


class TestRecompute:
    def test_loss_trajectory_identical(self):
        feed = _feed()
        traj = {}
        for use in (False, True):
            main, startup, loss = _build(tfluid, use)
            traj[use], start = _losses(tfluid, main, startup, loss, feed, 6,
                                       start=None)
        assert traj[True] == traj[False]
        assert traj[True][-1] < traj[True][0]
        jmain, jstart, jloss = _build(jfluid, True)
        want, start = _losses(jfluid, jmain, jstart, jloss, feed, 6)
        tmain, tstart, tloss = _build(tfluid, True)
        got, _ = _losses(tfluid, tmain, tstart, tloss, feed, 6, start=start)
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)

    def test_program_matches_reference(self):
        jmain, _, _ = _build(jfluid, True, regions=2)
        tmain, _, _ = _build(tfluid, True, regions=2)
        assert tmain.num_blocks == jmain.num_blocks == 3
        for b in range(3):
            assert _types(tmain, b) == _types(jmain, b)
        for jop, top in zip(jmain.global_block().ops,
                            tmain.global_block().ops):
            if jop.type.startswith("recompute_block"):
                assert top.inputs == jop.inputs
                assert top.outputs == jop.outputs

    def test_multi_region_all_params_train(self):
        """Every region's grad op is there and every fc's parameters
        update (the region declares its captures as formal inputs)."""
        main, startup, loss = _build(tfluid, True, regions=4)
        types = _types(main)
        assert types.count("recompute_block_grad") == 4
        assert types.count("sgd") == 10
        losses, _ = _losses(tfluid, main, startup, loss, _feed(4), 8)
        assert losses[-1] < losses[0] * 0.9, losses

    def test_clone_and_inference_export(self, tmp_path):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.unique_name.guard(), tfluid.program_guard(main,
                                                              startup):
            x = tfluid.layers.data("x", shape=[16], dtype="float32")
            y = tfluid.layers.data("y", shape=[1], dtype="float32")
            with tfluid.layers.recompute():
                h = tfluid.layers.fc(x, size=32, act="relu")
                h = tfluid.layers.dropout(h, 0.2)
            pred = tfluid.layers.fc(h, size=1)
            loss = _mse(tfluid, pred, y)
            test_prog = main.clone(for_test=True)
            tfluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
        xb = np.random.RandomState(0).randn(8, 16).astype("float32")
        feed = {"x": xb, "y": (xb.sum(1, keepdims=True) > 0).astype(
            "float32")}
        with tfluid.scope_guard(tfluid.Scope()):
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup)
            exe.run(main, feed=feed, fetch_list=[loss])
            ev = exe.run(test_prog, feed=feed, fetch_list=[loss, pred])
            assert np.isfinite(ev[0]).all()
            tfluid.io.save_inference_model(str(tmp_path), ["x"], [pred],
                                           exe, main_program=main)
            prog2, fnames, ftargets = tfluid.io.load_inference_model(
                str(tmp_path), exe)
            assert "recompute_block" in _types(prog2)
            o = exe.run(prog2, feed={fnames[0]: xb}, fetch_list=ftargets)[0]
        assert o.shape == (8, 1)
        np.testing.assert_allclose(o, ev[1], rtol=1e-6)

    def test_dropout_inside_region(self):
        """The region's second run draws the masks of its first: with
        dropout the program trains bit for bit as without regions."""
        feed = _feed(2)
        traj = {}
        for use in (False, True):
            main, startup, loss = _build(tfluid, use, dropout=0.3,
                                         regions=2)
            traj[use], _ = _losses(tfluid, main, startup, loss, feed, 8)
        assert traj[True] == traj[False]
        assert all(np.isfinite(traj[True])) and traj[True][-1] \
            < traj[True][0]

    def test_state_a_region_writes_is_written_once_a_step(self):
        """Batch norm's running statistics, written in place inside a
        region: its second run writes copies, so the statistics move once
        a step, as without the region."""
        out = {}
        for use in (False, True):
            main, startup = tfluid.Program(), tfluid.Program()
            with tfluid.unique_name.guard(), tfluid.program_guard(main,
                                                                  startup):
                x = tfluid.layers.data("x", shape=[4, 6, 6],
                                       dtype="float32")

                def body(h):
                    h = tfluid.layers.conv2d(h, 8, 3, padding=1)
                    return tfluid.layers.batch_norm(h, act="relu")

                if use:
                    with tfluid.layers.recompute():
                        h = body(x)
                else:
                    h = body(x)
                loss = tfluid.layers.mean(h)
                tfluid.optimizer.SGD(0.1).minimize(loss)
            feed = {"x": np.random.RandomState(0).randn(2, 4, 6, 6)
                    .astype("float32")}
            losses, _ = _losses(tfluid, main, startup, loss, feed, 3)
            scope = tfluid.Scope()
            with tfluid.scope_guard(scope):
                exe = tfluid.Executor(tfluid.CPUPlace())
                exe.run(startup)
                for _ in range(3):
                    exe.run(main, feed=feed, fetch_list=[loss])
                out[use] = (losses, convert.scope_persistables(main, scope))
        assert out[True][0] == out[False][0]
        assert sorted(out[True][1]) == sorted(out[False][1])
        for name, v in out[False][1].items():
            np.testing.assert_array_equal(out[True][1][name], v, name)

    def test_eager_run_frees_the_region_intermediates(self):
        """After a region's forward op the eager step's environment holds
        the region's output and nothing else the region made; its grad op
        computes them again."""
        main, startup, loss = _build(tfluid, True, regions=2)
        regions = [op for op in main.global_block().ops
                   if op.type == "recompute_block"]
        seen = []
        real = tcf.run_sub_block_op

        def spy(op, block, env, ctx, run_block, live):
            real(op, block, env, ctx, run_block, live)
            if op.type == "recompute_block":
                seen.append((op, set(env)))

        with tfluid.scope_guard(tfluid.Scope()):
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup)
            texecutor._cf.run_sub_block_op = spy
            try:
                exe.run(main, feed=_feed(), fetch_list=[loss],
                        use_program_cache=False)
            finally:
                texecutor._cf.run_sub_block_op = real
        # the executor runs the fusion pipeline's clone of ``main``
        assert [op.attrs["__op_id__"] for op, _ in seen] == \
            [op.attrs["__op_id__"] for op in regions]
        for op, env in seen:
            written = set(op.output("Out"))
            kept = written & env
            assert len(written) > 4 and len(kept) == 1, kept
            consumer = [o for o in main.global_block().ops
                        if kept & set(o.input_arg_names)
                        and o.type != "recompute_block_grad"]
            assert consumer

    def test_grads_of_other_sub_block_ops_point_at_queue_a_5(self):
        """``recurrent`` (StaticRNN, DynamicRNN; Queue A item 5, whose
        grad raised here until it was ported) gets its one grad op as the
        regions do; ``while`` and ``conditional_block`` have theirs
        (``tests/test_torch_control_flow.py``,
        ``tests/test_torch_recurrent.py``)."""
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.unique_name.guard(), tfluid.program_guard(main,
                                                              startup):
            x = tfluid.layers.data("x", shape=[3, 2, 4], dtype="float32",
                                   append_batch_size=False)
            rnn = tfluid.layers.StaticRNN()
            with rnn.step():
                x_t = rnn.step_input(x)
                h = rnn.memory(shape=[4], batch_ref=x_t)
                hn = tfluid.layers.fc(tfluid.layers.concat([x_t, h], 1), 4)
                rnn.update_memory(h, hn)
                rnn.step_output(hn)
            tfluid.append_backward(tfluid.layers.reduce_sum(rnn()))
        grads = [op for op in main.global_block().ops
                 if op.type == "recurrent_grad"]
        assert len(grads) == 1
        assert len(grads[0].output("Captured@GRAD")) == 2

    def test_append_backward_accepts_checkpoints(self):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.unique_name.guard(), tfluid.program_guard(main,
                                                              startup):
            x = tfluid.layers.data("x", shape=[8], dtype="float32")
            h = tfluid.layers.fc(x, size=8, act="relu")
            loss = tfluid.layers.mean(tfluid.layers.fc(h, size=1))
            pg = tfluid.append_backward(loss, checkpoints=[h])
        assert len(pg) == 4


class TestRecomputeOptimizer:
    def _build(self, fluid):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 33
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[32], dtype="float32")
            y = fluid.layers.data("y", shape=[1], dtype="float32")
            h1 = fluid.layers.fc(x, size=64, act="relu")
            h2 = fluid.layers.fc(h1, size=64, act="relu")
            h3 = fluid.layers.fc(h2, size=32, act="relu")
            loss = _mse(fluid, fluid.layers.fc(h3, size=1), y)
        return main, startup, loss, [h1, h2]

    def _train(self, fluid, wrap, steps=8, start=None):
        main, startup, loss, cps = self._build(fluid)
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            opt = fluid.optimizer.SGD(learning_rate=0.05)
            if wrap:
                opt = fluid.optimizer.RecomputeOptimizer(opt)
                opt._set_checkpoints(cps)
            opt.minimize(loss)
        xb = np.random.RandomState(3).randn(8, 32).astype("float32")
        feed = {"x": xb, "y": (xb.sum(1, keepdims=True) > 0).astype(
            "float32")}
        losses, first = _losses(fluid, main, startup, loss, feed, steps,
                                start=start)
        return main, losses, first

    def test_rewrite_structure(self):
        main, _, _ = self._train(tfluid, wrap=True, steps=1)
        jmain, _, _ = self._train(jfluid, wrap=True, steps=1)
        types = _types(main)
        assert types.count("recompute_block") == 2
        assert types.count("relu") == 1
        assert types == _types(jmain)
        for b in range(1, main.num_blocks):
            assert _types(main, b) == _types(jmain, b)

    def test_loss_trajectory_identical(self):
        _, plain, _ = self._train(tfluid, wrap=False)
        _, wrapped, _ = self._train(tfluid, wrap=True)
        assert wrapped == plain and plain[-1] < plain[0]
        _, want, start = self._train(jfluid, wrap=True)
        _, got, _ = self._train(tfluid, wrap=True, start=start)
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)

    def test_requires_checkpoints_and_pre_backward(self):
        main, startup, loss, cps = self._build(tfluid)
        with tfluid.program_guard(main, startup):
            opt = tfluid.optimizer.RecomputeOptimizer(
                tfluid.optimizer.SGD(learning_rate=0.05))
            with pytest.raises(ValueError):
                opt.minimize(loss)
            opt._set_checkpoints([cps[0]])
            opt.minimize(loss)
            with pytest.raises(RuntimeError):
                tfluid.optimizer.rewrite_program_recompute(main,
                                                           [cps[1].name])
        with pytest.raises(ValueError, match="not found"):
            tfluid.optimizer.rewrite_program_recompute(
                self._build(tfluid)[0], ["no_such_var"])

    def test_repeat_minimize_does_not_stack_wrappers(self):
        """One wrapper minimizing two programs with fresh checkpoints:
        one region each, and the inner optimizer is not wrapped again."""
        inner = tfluid.optimizer.SGD(learning_rate=0.05)
        opt = tfluid.optimizer.RecomputeOptimizer(inner)
        progs = []
        for _ in range(2):
            main, startup = tfluid.Program(), tfluid.Program()
            with tfluid.unique_name.guard(), tfluid.program_guard(main,
                                                                  startup):
                x = tfluid.layers.data("x", shape=[8], dtype="float32")
                h = tfluid.layers.fc(x, size=8, act="relu")
                loss = tfluid.layers.mean(tfluid.layers.fc(h, size=1))
                opt._set_checkpoints([h])
                opt.minimize(loss, startup_program=startup)
            progs.append(main)
        assert opt._optimizer is inner
        for prog in progs:
            assert _types(prog).count("recompute_block") == 1

    def test_decomposed_backward_applies_rewrite(self):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.unique_name.guard(), tfluid.program_guard(main,
                                                              startup):
            x = tfluid.layers.data("x", shape=[8], dtype="float32")
            h = tfluid.layers.fc(x, size=8, act="relu")
            loss = tfluid.layers.mean(tfluid.layers.fc(h, size=1))
            opt = tfluid.optimizer.RecomputeOptimizer(
                tfluid.optimizer.SGD(learning_rate=0.05))
            opt._set_checkpoints([h])
            opt.apply_gradients(opt.backward(loss))
        types = _types(main)
        assert "recompute_block" in types and "sgd" in types


class TestRecomputeComposition:
    def _build(self, fluid, order):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 8
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[32], dtype="float32")
            y = fluid.layers.data("y", shape=[1], dtype="float32")
            if order == "region":
                with fluid.layers.recompute():
                    h1 = fluid.layers.fc(x, size=64, act="relu")
                    h2 = fluid.layers.fc(h1, size=64, act="relu")
            else:
                h1 = fluid.layers.fc(x, size=64, act="relu")
                h2 = fluid.layers.fc(h1, size=64, act="relu")
            loss = _mse(fluid, fluid.layers.fc(h2, size=1), y)
            opt = fluid.optimizer.SGD(learning_rate=0.05)
            if order == "amp_outside":
                opt = fluid.optimizer.RecomputeOptimizer(opt)
                opt._set_checkpoints([h1])
            opt = fluid.contrib.mixed_precision.decorate(opt)
            opt.minimize(loss)
        return main, startup, loss

    def test_amp_plus_recompute_casts_inside_regions(self):
        """``tests/test_recompute.py:306``: with AMP outermost the bf16
        rewrite runs before the regions form, so the regions hold the
        casts, in both packages alike; and the program trains."""
        tmain, tstart, tloss = self._build(tfluid, "amp_outside")
        jmain, jstart, jloss = self._build(jfluid, "amp_outside")
        rc = next(op for op in tmain.global_block().ops
                  if op.type == "recompute_block")
        sub = tmain.block(rc.attrs["sub_block"])
        assert "cast" in _types(tmain, sub.idx)
        assert _types(tmain) == _types(jmain)
        assert _types(tmain, sub.idx) == _types(jmain, sub.idx)
        xb = np.random.RandomState(1).randn(8, 32).astype("float32")
        feed = {"x": xb, "y": (xb.sum(1, keepdims=True) > 0).astype(
            "float32")}
        want, start = _losses(jfluid, jmain, jstart, jloss, feed, 6)
        got, _ = _losses(tfluid, tmain, tstart, tloss, feed, 6, start=start)
        assert all(np.isfinite(got)) and got[-1] < got[0]
        np.testing.assert_allclose(got, want, rtol=2 ** -7)

    def test_amp_walks_into_regions_built_before_it(self):
        """A region built by ``layers.recompute()`` before the rewrite:
        the port's rewrite puts the casts inside it too (the reference's
        leaves such a region float32), and it trains as the program
        without the region does."""
        main, startup, loss = self._build(tfluid, "region")
        rc = next(op for op in main.global_block().ops
                  if op.type == "recompute_block")
        sub_types = _types(main, rc.attrs["sub_block"])
        assert "cast" in sub_types \
            and sub_types.index("cast") < sub_types.index("mul")
        plain = self._build(tfluid, "none")
        feed = {"x": np.random.RandomState(1).randn(8, 32).astype(
            "float32"), "y": np.ones((8, 1), "float32")}
        got, _ = _losses(tfluid, main, startup, loss, feed, 4)
        want, _ = _losses(tfluid, *plain, feed, 4)
        assert got == want


def _bert_cfg(bert, recompute, fused_qkv, dropout=0.0):
    cfg = copy.copy(bert.BERT_TINY)
    cfg.fuse_attn = True
    cfg.fused_ln = True
    cfg.recompute = recompute
    cfg.fused_qkv = fused_qkv
    cfg.dropout = cfg.attn_dropout = dropout
    return cfg


def _bert(fluid, bert, **kw):
    with fluid.unique_name.guard():
        main, startup, _, loss = bert.build_pretrain(
            _bert_cfg(bert, **kw), seq_len=BERT_T, lr=BERT_LR)
    main.random_seed = startup.random_seed = 4
    return main, startup, loss


def _grad_names(program):
    return {op.inputs["Param"][0]: op.inputs["Grad"][0]
            for op in program.global_block().ops if op.type == "adam"}


@pytest.mark.parametrize("recompute,fused_qkv", [(True, False),
                                                 (False, True),
                                                 (True, True)])
def test_bert_tiny_trains_as_the_reference(interpret, recompute, fused_qkv):
    """``BertConfig(recompute=True)`` / ``fused_qkv=True`` at BERT-tiny:
    the same program (one ``.qkv.w`` [128, 384] and three slices; one
    region per layer), 3 Adam steps from the reference's start: losses,
    the first step's gradients and the final parameters (rtol 1e-3,
    atol 1e-6; parameters to 2 lr a step)."""
    kw = dict(recompute=recompute, fused_qkv=fused_qkv)
    jmain, jstart, jloss = _bert(jfluid, jbert, **kw)
    tmain, tstart, tloss = _bert(tfluid, tbert, **kw)
    assert collections.Counter(_types(tmain)) == \
        collections.Counter(_types(jmain))
    assert _types(tmain).count("recompute_block") == (2 if recompute else 0)
    if fused_qkv:
        w = tmain.global_block().var("bert.layer0.attn.qkv.w")
        assert tuple(w.shape) == (128, 384)
        assert _types(tmain, 1 if recompute else 0).count("slice") == \
            (3 if recompute else 6)
    grads = _grad_names(jmain)
    assert _grad_names(tmain) == grads
    names = sorted(grads)
    feed = jbert.make_fake_batch(2, BERT_T, jbert.BERT_TINY,
                                 np.random.RandomState(0))
    fetch0 = [jloss.name] + [grads[n] for n in names]
    out = {}
    start = None
    for fluid, main, startup in ((jfluid, jmain, jstart),
                                 (tfluid, tmain, tstart)):
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup)
            if start is None:
                start = convert.scope_persistables(main, scope)
            else:
                convert.load_params_into_scope(start, scope, "cpu",
                                               program=main)
            first = [np.asarray(v) for v in exe.run(main, feed=feed,
                                                    fetch_list=fetch0)]
            losses = [float(first[0].ravel()[0])] + [
                float(np.asarray(exe.run(main, feed=feed,
                                         fetch_list=[fetch0[0]])[0])
                      .ravel()[0]) for _ in range(2)]
            out[fluid] = (losses, first[1:],
                          {n: np.asarray(scope.get(n)) for n in names})
    (wl, wg, wp), (gl, gg, gp) = out[jfluid], out[tfluid]
    np.testing.assert_allclose(gl, wl, rtol=BERT_LOSS_RTOL)
    assert gl[-1] < gl[0]
    for n, g, w in zip(names, gg, wg):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=n)
    for n in names:
        np.testing.assert_allclose(gp[n], wp[n], rtol=0, atol=PARAM_ATOL,
                                   err_msg=n)


def test_bert_tiny_recompute_is_bit_for_bit_with_dropout():
    """The port's BERT-tiny with dropout 0.1, 3 steps with and without
    ``recompute=True`` from one start: losses and the gradients of the
    embedding, a first-layer projection and a last-layer LN scale equal
    bit for bit (the chip phase's check, at test size)."""
    names = ["bert.word_emb", "bert.layer0.attn.qkv.w",
             "bert.layer1.ln2.scale"]
    feed = tbert.make_fake_batch(2, BERT_T, tbert.BERT_TINY,
                                 np.random.RandomState(1))
    out, start = {}, None
    for rc in (False, True):
        main, startup, loss = _bert(tfluid, tbert, recompute=rc,
                                    fused_qkv=True, dropout=0.1)
        grads = _grad_names(main)
        fetch = [loss.name] + [grads[n] for n in names]
        scope = tfluid.Scope()
        with tfluid.scope_guard(scope):
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup)
            if start is None:
                start = convert.scope_persistables(main, scope)
            else:
                convert.load_params_into_scope(start, scope, "cpu",
                                               program=main)
            out[rc] = [exe.run(main, feed=feed, fetch_list=fetch)
                       for _ in range(3)]
    for a, b in zip(out[False], out[True]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_verifier_cost_model_and_drift_take_regions_as_the_reference():
    """The executor's gates on a program with regions: the verifier's
    battery gives the reference's diagnostics (no ERROR), the cost model
    prices it as the reference's does, and the drift monitor registers
    it.  Op ids are left out of the comparison: the port's region ops
    take none from the program's counter, so the ids after a region are
    the reference's less one per region; the cost model's records take
    the reference's int32 for the int64 position arithmetic
    (``test_torch_verifier._as_jax_records``)."""
    from paddle_tpu.static_analysis import cost as jcost
    from paddle_tpu.static_analysis import verifier as jverifier

    from paddle_tpu_torch.observability import drift
    from paddle_tpu_torch.static_analysis import cost as tcost
    from paddle_tpu_torch.static_analysis import verifier as tverifier
    from test_torch_verifier import (_as_jax_records, _as_port,
                                     _assert_port_texts, _dicts)

    kw = dict(recompute=True, fused_qkv=True)
    jmain, _, jloss = _bert(jfluid, jbert, **kw)
    tmain, _, tloss = _bert(tfluid, tbert, **kw)
    want = _as_port(_dicts(jverifier.verify_program(jmain,
                                                    targets=[jloss.name])))
    got = _dicts(tverifier.verify_program(tmain, targets=[tloss.name]))
    assert [dict(d, op_id=None) for d in got] == \
        [dict(d, op_id=None) for d in want]
    _assert_port_texts(got)
    assert not [d for d in got if d["severity"] == "ERROR"]
    tprog, _ = _as_jax_records(tmain, jmain)
    jreport = jcost.estimate_cost(jmain, targets=[jloss.name])
    treport = tcost.estimate_cost(tprog, targets=[tloss.name])
    assert [c.to_dict() for c in treport.op_costs] == \
        [c.to_dict() for c in jreport.op_costs]
    assert treport.to_dict() == jreport.to_dict()
    assert drift.monitor().register_program(
        tmain, batch_size=2, targets=[tloss.name]) is not None
