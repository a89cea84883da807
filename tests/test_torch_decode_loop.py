"""Single-program generation in the PyTorch port against the reference:
``layers.decode_loop`` and ``models.gpt.build_program`` /
``build_naive_program`` (the reference's ``examples/gpt_small.py``), on
the CPU.

The reference's own tests (``tests/test_decode.py:250-410``) at their
sizes: ``GPT_TINY`` widths, batch 2, prompt 8, 4-16 new tokens, and
``GPTConfig(max_len=32)`` where the naive arm runs.  Each program is
built in both packages; the port loads the reference's parameters
(``convert.load_params_into_scope``) and both decode the same seeded
prompts, the reference as its own decode tests run it.  Greedy tokens,
``gen_len`` and every other integer are compared exactly (the tiny
model's top-2 logit gaps are far above float32 rounding).  Sampled
tokens cannot equal the reference's (the port draws on the device from
the step seed, the reference from JAX's PRNG): they are held to their
own repeatability, graph against eager, and to top-k / top-p
membership.  The zero-sync certificate and the decode-shape lint give
the reference's verdicts on the same programs.
"""

import os
import sys

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import scope_guard as jscope_guard
from paddle_tpu.static_analysis.concurrency import \
    certify_zero_sync as jcertify

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import executor as texecutor
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.static_analysis.concurrency import \
    certify_zero_sync as tcertify

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import gpt_small  # noqa: E402

BATCH, PROMPT = 2, 8
SHORT = 32  # the naive arm's max_len, as the reference's test


def _cfg(module, max_len=None):
    return module.GPT_TINY if max_len is None \
        else module.GPTConfig(max_len=max_len)


def _reference(build, feeds):
    """Run the reference's ``build()`` on each feed → (its outputs, its
    parameters by name)."""
    jfluid.unique_name.switch()
    main, startup, _feeds, tokens, gen_len = build()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jscope_guard(JScope()):
        exe.run(startup)
        scope = jfluid.executor.global_scope()
        params = {p.name: np.asarray(scope.get(p.name))
                  for p in main.all_parameters()}
        outs = [[np.asarray(v) for v in exe.run(
            main, feed=f, fetch_list=[tokens, gen_len])] for f in feeds]
    return outs, params


def _port(build, feeds, params, exe=None, cache=True):
    tfluid.unique_name.switch()
    main, startup, _feeds, tokens, gen_len = build()
    exe = exe or tfluid.Executor(tfluid.CPUPlace())
    with texecutor.scope_guard(texecutor.Scope()):
        exe.run(startup)
        if params:
            tfluid.convert.load_params_into_scope(
                params, texecutor.global_scope(), program=main)
        outs = [[np.asarray(v) for v in exe.run(
            main, feed=f, fetch_list=[tokens, gen_len],
            use_program_cache=cache)] for f in feeds]
    return outs, exe


def _prompts(cfg, seeds=(0,)):
    return [gpt_small.make_fake_prompt(BATCH, PROMPT, cfg,
                                       np.random.RandomState(s))
            for s in seeds]


@pytest.mark.parametrize("new_tokens", [4, 16])
def test_greedy_build_program_matches_the_reference(new_tokens):
    """Two prompts, each run twice by the port (warm-up, bind, replays):
    the reference's tokens and gen_len, as int32."""
    feeds = _prompts(_cfg(gpt_small), seeds=(0, 1))
    want, params = _reference(lambda: gpt_small.build_program(
        gpt_small.GPT_TINY, BATCH, PROMPT, new_tokens), feeds)
    got, exe = _port(lambda: tgpt.build_program(
        tgpt.GPT_TINY, BATCH, PROMPT, new_tokens), feeds + feeds, params)
    for g, w in zip(got, want + want):
        assert g[0].dtype == np.int32 and g[1].dtype == np.int32
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
    rec = exe.last_loops[0]
    assert rec["trips"] == new_tokens - 1 and rec["mode"] == "graph"
    assert rec["replayed_trips"] == new_tokens - 1


def test_kv_cache_matches_naive_full_recompute():
    """The reference's equivalence oracle: ring-cache greedy tokens equal
    the recompute-everything program's, in the port and in the
    reference; both programs on the reference's parameters."""
    cfg_j, cfg_t = _cfg(gpt_small, SHORT), _cfg(tgpt, SHORT)
    feeds = _prompts(cfg_j)
    want, params = _reference(lambda: gpt_small.build_program(
        cfg_j, BATCH, PROMPT, 6), feeds)
    kv, _ = _port(lambda: tgpt.build_program(cfg_t, BATCH, PROMPT, 6),
                  feeds, params)
    naive, exe = _port(lambda: tgpt.build_naive_program(
        cfg_t, BATCH, PROMPT, 6), feeds, params)
    np.testing.assert_array_equal(kv[0][0], want[0][0])
    np.testing.assert_array_equal(naive[0][0], want[0][0])
    assert exe.last_loops[0]["trips"] == 5


def test_run_generate_on_the_cpu():
    cfg = _cfg(tgpt, SHORT)
    toks, glen, ttft, rate = tgpt.run_generate(
        lambda: tgpt.build_program(cfg, BATCH, PROMPT, 4), cfg, BATCH,
        PROMPT, 4, place=tfluid.CPUPlace())
    assert toks.shape == (BATCH, 4) and toks.dtype == np.int32
    assert glen.tolist() == [1, 1]  # gen_len counts only with an eos
    assert ttft > 0 and rate > 0


def _rigged(fluid, eos=3, vocab=16):
    """The reference's eos test program: next = cur + 1 as one-hot
    logits, so rows march to eos at different steps."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        first = fluid.layers.data("first", shape=[2], dtype="int32",
                                  append_batch_size=False)
        plen = fluid.layers.data("plen", shape=[1], dtype="int32",
                                 append_batch_size=False)

        def step(cur, cursor, i):
            nxt = fluid.layers.elementwise_add(
                cur, fluid.layers.fill_constant([2], "int32", 1))
            oh = fluid.layers.one_hot(fluid.layers.reshape(nxt, [2, 1]),
                                      vocab)
            return fluid.layers.cast(oh, "float32")

        tokens, gen_len = fluid.layers.decode_loop(
            step, first, plen, max_new_tokens=8, eos_id=eos)
    return main, startup, [tokens, gen_len]


def _run(fluid, scope_cls, guard, build, feeds, **kw):
    fluid.unique_name.switch()
    main, startup, fetch = build(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    with guard(scope_cls()):
        exe.run(startup)
        return [[np.asarray(v) for v in exe.run(main, feed=f,
                                                fetch_list=fetch, **kw)]
                for f in feeds], exe


@pytest.mark.parametrize("cache", [True, False])
def test_eos_early_exit_keeps_the_zero_fill(cache):
    """Row 0 hits eos at its 4th token, row 1 at its 2nd and then emits
    eos; the loop stops after 4 tokens, so the columns past it keep the
    zero fill; gen_len [4, 2].  Equal to the reference, twice."""
    feeds = [{"first": np.asarray([0, 2], "int32"),
              "plen": np.asarray([1], "int32")}] * 2
    want, _ = _run(jfluid, JScope, jscope_guard, _rigged, feeds)
    got, exe = _run(tfluid, texecutor.Scope, texecutor.scope_guard,
                    _rigged, feeds, use_program_cache=cache)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
    toks, glen = got[-1]
    assert glen.tolist() == [4, 2]
    assert toks.tolist() == [[0, 1, 2, 3, 0, 0, 0, 0],
                             [2, 3, 3, 3, 0, 0, 0, 0]]
    rec = exe.last_loops[0]
    assert rec["trips"] == 3 and rec["cond_reads"] == 4


def test_eos_on_the_model_matches_the_reference():
    """build_program with an eos that the greedy run emits early: the
    same early exit, tokens and gen_len as the reference."""
    feeds = _prompts(_cfg(gpt_small))
    plain, params = _reference(lambda: gpt_small.build_program(
        gpt_small.GPT_TINY, BATCH, PROMPT, 12), feeds)
    eos = int(plain[0][0][0, 2])  # row 0's third token
    want, _ = _reference(lambda: gpt_small.build_program(
        gpt_small.GPT_TINY, BATCH, PROMPT, 12, eos_id=eos), feeds)
    got, exe = _port(lambda: tgpt.build_program(
        tgpt.GPT_TINY, BATCH, PROMPT, 12, eos_id=eos), feeds * 2, params)
    for g in got:
        np.testing.assert_array_equal(g[0], want[0][0])
        np.testing.assert_array_equal(g[1], want[0][1])
    # the row that finishes last was live on every trip
    assert got[0][1][0] == 3
    assert exe.last_loops[0]["trips"] == int(got[0][1].max()) - 1


def test_program_cache_flat_across_generated_lengths():
    """The port's counterpart of the reference's jit-cache test: a
    generation of 4 tokens and one of 16 add as many cache entries (the
    startup, the step, the loop body), and more runs with fresh prompts
    add none."""
    exe = tfluid.Executor(tfluid.CPUPlace())
    counts = []
    for new_tokens in (4, 16):
        before = len(exe._cache)
        got, _ = _port(lambda: tgpt.build_program(
            tgpt.GPT_TINY, BATCH, PROMPT, new_tokens),
            _prompts(_cfg(tgpt), seeds=(0, 4, 5)), None, exe=exe)
        assert got[0][0].shape == (BATCH, new_tokens)
        counts.append(len(exe._cache) - before)
    assert counts[0] == counts[1] == 3
    bodies = [e for e in exe._cache.values()
              if isinstance(e, texecutor._LoopBody)]
    assert [b.calls for b in bodies] == [3, 3]
    # the counters and ids stay int32 in the body's bound tensors
    for body in bodies:
        ints = {str(t.dtype) for t in body.bound.values()
                if not isinstance(t, tfluid.ops.control_flow.TensorArray)
                and not t.is_floating_point() and t.dtype != "torch.bool"}
        assert ints <= {"torch.int32", "torch.bool"}, ints


def test_zero_sync_certificate_over_the_decode_program(monkeypatch):
    """Both packages certify the generation program (strict sync on);
    the port names the condition read a trip as an allowed sync."""
    monkeypatch.setenv("PADDLE_TPU_STRICT_SYNC", "1")
    certs = []
    for fluid, model, certify in ((jfluid, gpt_small, jcertify),
                                  (tfluid, tgpt, tcertify)):
        fluid.unique_name.switch()
        main, _s, _f, tokens, gen_len = model.build_program(
            model.GPT_TINY, BATCH, PROMPT, 4)
        main._serving_hot_loop = True
        certs.append(certify(main, targets=[tokens.name, gen_len.name],
                             label="decode"))
    want, got = certs
    assert want.ok and got.ok
    assert got.to_dict()["violations"] == want.to_dict()["violations"]
    assert [a.op_type for a in got.allowed] == ["while"]


def _concat_loop(fluid):
    """The lint's anti-pattern: a loop carry grown by concat (built, not
    run)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        kv = fluid.layers.data("kv", shape=[2, 4, 8], dtype="float32",
                               append_batch_size=False)
        step = fluid.layers.data("x", shape=[2, 1, 8], dtype="float32",
                                 append_batch_size=False)
        i = fluid.layers.fill_constant([1], "int32", 0)
        limit = fluid.layers.fill_constant([1], "int32", 4)
        cond = fluid.layers.less_than(i, limit)
        w = fluid.layers.While(cond)
        with w.block():
            grown = fluid.layers.concat([kv, step], axis=1)
            fluid.layers.assign(grown, output=kv)
            fluid.layers.increment(i, value=1, in_place=True)
            fluid.layers.less_than(i, limit, cond=cond)
        out = fluid.layers.reduce_sum(kv)
    return main, startup, [out]


def _shape_lint(main, targets):
    report = main.analyze(targets=targets)
    return [(d.check, d.severity, d.hint) for d in report.diagnostics
            if d.check == "decode-shape-unbucketed"], bool(report.errors)


def test_decode_shape_lint_gives_the_reference_verdicts():
    verdicts = []
    for fluid, model in ((jfluid, gpt_small), (tfluid, tgpt)):
        fluid.unique_name.switch()
        main, _s, out = _concat_loop(fluid)
        positive = _shape_lint(main, [out[0].name])
        fluid.unique_name.switch()
        main, _s, _f, tokens, gen_len = model.build_program(
            model.GPT_TINY, BATCH, PROMPT, 4)
        verdicts.append((positive,
                         _shape_lint(main, [tokens.name, gen_len.name])))
    assert verdicts[0] == verdicts[1]
    (hits, _), (clean, errors) = verdicts[1]
    assert hits and "ring-buffer" in hits[0][2]
    assert clean == [] and not errors


def test_the_grown_carry_runs_eagerly_and_says_why():
    """A carry that changes shape in a trip cannot live in a captured
    body: the warm-up trip finds it and the body stays eager.  The port
    alone (the reference's ``lax.while_loop`` refuses a carry whose
    shape changes; its build also re-declares ``kv`` with the grown
    shape, which its feed check then refuses)."""
    tfluid.unique_name.switch()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        kv = tfluid.layers.fill_constant([2, 4, 8], "float32", 1.0)
        step = tfluid.layers.data("x", shape=[2, 1, 8], dtype="float32",
                                  append_batch_size=False)
        i = tfluid.layers.fill_constant([1], "int32", 0)
        limit = tfluid.layers.fill_constant([1], "int32", 4)
        cond = tfluid.layers.less_than(i, limit)
        w = tfluid.layers.While(cond)
        with w.block():
            tfluid.layers.assign(tfluid.layers.concat([kv, step], axis=1),
                                 output=kv)
            tfluid.layers.increment(i, value=1, in_place=True)
            tfluid.layers.less_than(i, limit, cond=cond)
        out = tfluid.layers.reduce_sum(kv)
    xv = np.random.RandomState(2).randn(2, 1, 8).astype("float32")
    exe = tfluid.Executor(tfluid.CPUPlace())
    with texecutor.scope_guard(texecutor.Scope()):
        for _ in range(2):
            got = exe.run(main, feed={"x": xv}, fetch_list=[out])[0]
            np.testing.assert_allclose(got, [64.0 + 4 * xv.sum()],
                                       rtol=1e-5)
    rec = exe.last_loops[0]
    assert rec["mode"] == "eager" and "changes from" in rec["reason"]


def _sampling_loop(fluid, strategy):
    """decode_loop over fixed logits (a fed [2, 16] table read each
    trip), so the top-k and nucleus sets are known."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        logits = fluid.layers.data("logits", shape=[2, 16],
                                   dtype="float32", append_batch_size=False)
        first = fluid.layers.data("first", shape=[2], dtype="int32",
                                  append_batch_size=False)
        plen = fluid.layers.data("plen", shape=[1], dtype="int32",
                                 append_batch_size=False)
        tokens, gen_len = fluid.layers.decode_loop(
            lambda cur, cursor, i: fluid.layers.scale(logits, 1.0), first,
            plen, max_new_tokens=24, strategy=strategy, k=4, p=0.6,
            temperature=1.0, seed=7)
    return main, startup, [tokens, gen_len]


@pytest.mark.parametrize("strategy", ["top_k", "top_p"])
def test_sampled_generation_repeats_and_stays_in_its_set(strategy):
    rng = np.random.RandomState(5)
    logits = rng.randn(2, 16).astype("float32") * 2
    feed = {"logits": logits, "first": np.asarray([0, 0], "int32"),
            "plen": np.asarray([1], "int32")}
    # a draw is keyed by the executor's step and the trip's Step: the
    # cached runs (warm-up, bind, replays) against eager runs at the same
    # executor steps
    graph, _ = _run(tfluid, texecutor.Scope, texecutor.scope_guard,
                    lambda f: _sampling_loop(f, strategy), [feed] * 3)
    eager, _ = _run(tfluid, texecutor.Scope, texecutor.scope_guard,
                    lambda f: _sampling_loop(f, strategy), [feed] * 3,
                    use_program_cache=False)
    for g, e in zip(graph, eager):
        np.testing.assert_array_equal(g[0], e[0])
    assert not np.array_equal(graph[0][0], graph[1][0])
    toks = np.concatenate([g[0][:, 1:] for g in graph], axis=1)
    order = np.argsort(-logits, axis=1)
    if strategy == "top_k":
        allowed = order[:, :4]
    else:
        p = np.exp(logits - logits.max(1, keepdims=True))
        p /= p.sum(1, keepdims=True)
        mass = np.cumsum(np.take_along_axis(p, order, 1), 1)
        allowed = [order[r, :int(np.searchsorted(mass[r], 0.6)) + 1]
                   for r in range(2)]
    for r in range(2):
        assert set(toks[r].tolist()) <= set(np.asarray(allowed[r]).tolist())
        if len(allowed[r]) > 1:  # the draws move with Step
            assert len(set(toks[r].tolist())) > 1
