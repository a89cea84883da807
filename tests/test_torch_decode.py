"""The decode-serving slice of the PyTorch port against the reference.

A narrow GPT (vocab 128, hidden 64, 2 layers, 4 heads, cache depth 64,
paged blocks of 16) runs through ``serving.DecodeEngine`` in both
packages on the CPU.  The reference runs with
``PADDLE_TPU_PALLAS=interpret`` and ``PADDLE_TPU_DECODE_MIN_T=1`` so its
flash-decode and paged flash-decode Pallas bodies really run; the port
runs its kernels' plain PyTorch versions.  The reference's parameters
are copied into the port through ``DecodeAdapter(params=...)``, and
inputs come from seeded numpy.  Both sides are float32: 1e-5 is the
reference's documented tolerance for its decode oracle.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu.ops import registry as j_registry
from paddle_tpu.ops.pallas import flash_decode as j_fd
from paddle_tpu.ops.pallas import paged_flash_decode as j_pfd
from paddle_tpu.serving import DecodeEngine as JDecodeEngine
from paddle_tpu.serving import GenerationConfig as JGenerationConfig

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import registry as t_registry
from paddle_tpu_torch.ops.cuda import flash_decode as t_fd
from paddle_tpu_torch.ops.cuda import paged_flash_decode as t_pfd
from paddle_tpu_torch.serving import DecodeEngine, GenerationConfig

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import gpt_small  # noqa: E402

TOL = 1e-5
MAX_LEN = 64
BLOCK_LEN = 16
BUCKETS = (8, 16)
NEW_TOKENS = 6
PROMPT_LENS = (5, 12, 3)
STEPS = 3
SEED = 3


def _cfg(module):
    return module.GPTConfig(vocab=128, hidden=64, layers=2, heads=4,
                            max_len=MAX_LEN)


def _prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(1, 127, size=n).astype("int32")
            for n in PROMPT_LENS]


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max()) if a.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(b).max())), err


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")
    monkeypatch.setenv("PADDLE_TPU_DECODE_MIN_T", "1")


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------


def _ring_inputs(rng, b=3, h=2, t=64, d=16):
    q = rng.randn(b, h, d).astype("float32")
    k = rng.randn(b, h, t, d).astype("float32")
    v = rng.randn(b, h, t, d).astype("float32")
    return q, k, v


@pytest.mark.parametrize("lengths", [(0, 5, 64), (64, 64, 64), (1, 0, 33)],
                         ids=["empty-ragged-full", "full", "one-empty"])
def test_flash_decode_plain_matches_reference_kernel(interpret, lengths):
    q, k, v = _ring_inputs(np.random.RandomState(sum(lengths)))
    lens = np.asarray(lengths, "int32")
    ref = np.asarray(j_fd.flash_decode(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(lens)))
    got = t_fd.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(lens))
    _close(got.numpy(), ref)
    assert not got[np.asarray(lengths) == 0].any()


def _paged_inputs(rng, lengths, s=3, h=2, d=16, bl=BLOCK_LEN, mb=4,
                  pool=17):
    """A pool larger than the tables, shuffled block ids, -1 tails."""
    q = rng.randn(s, h, d).astype("float32")
    kp = rng.randn(pool, h, bl, d).astype("float32")
    vp = rng.randn(pool, h, bl, d).astype("float32")
    order = rng.permutation(pool)
    table = np.full((s, mb), -1, "int32")
    nxt = 0
    for i, n in enumerate(lengths):
        need = -(-n // bl)
        table[i, :need] = order[nxt:nxt + need]
        nxt += need
    return q, kp, vp, table


@pytest.mark.parametrize("lengths", [(0, 17, 64), (1, 40, 3)],
                         ids=["empty-ragged-full", "short"])
def test_paged_flash_decode_plain_matches_reference_kernel(interpret,
                                                           lengths):
    q, kp, vp, table = _paged_inputs(np.random.RandomState(7), lengths)
    lens = np.asarray(lengths, "int32")
    ref = np.asarray(j_pfd.paged_flash_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lens),
        jnp.asarray(table)))
    got = t_pfd.paged_flash_decode(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(lens), torch.from_numpy(table))
    _close(got.numpy(), ref)


# ---------------------------------------------------------------------------
# the decode ops, caches included
# ---------------------------------------------------------------------------


def _op_cases():
    rng = np.random.RandomState(11)
    ring = rng.randn(3, 2, 8, 4).astype("float32")
    pool = rng.randn(6, 2, 4, 4).astype("float32")
    x3 = rng.randn(3, 2, 4).astype("float32")
    i32 = lambda *v: np.asarray(v, "int32")  # noqa: E731
    table = i32([4, 1], [-1, -1], [2, -1])
    return [
        ("kv_cache_write", {"Cache": ring, "X": x3, "Cursor": i32(9)},
         {"per_row": False}),
        ("kv_cache_write", {"Cache": ring, "X": x3[:, :, None],
                            "Cursor": i32(0, 7, 12)}, {"per_row": True}),
        ("kv_cache_prefill", {"Cache": ring,
                              "X": rng.randn(1, 2, 5, 4).astype("float32"),
                              "Slot": i32(2)}, {}),
        ("kv_cache_prefill", {"Cache": ring,
                              "X": rng.randn(1, 2, 5, 4).astype("float32"),
                              "Slot": i32(7)}, {}),
        ("kv_cache_prefill", {"Cache": ring,
                              "X": rng.randn(2, 2, 3, 4).astype("float32"),
                              "Slot": None}, {}),
        ("flash_decode_attention", {"Q": x3, "KCache": ring, "VCache": ring,
                                    "Cursor": i32(0, 5, 20)},
         {"per_row": True}),
        ("flash_decode_attention", {"Q": x3[:, :, None], "KCache": ring,
                                    "VCache": ring * 0.5, "Cursor": i32(3)},
         {"per_row": False, "sm_scale": 0.3}),
        ("paged_kv_cache_write", {"Cache": pool, "X": x3,
                                  "Cursor": i32(5, 0, 2),
                                  "BlockTable": table}, {"per_row": True}),
        ("paged_kv_cache_write", {"Cache": pool, "X": x3,
                                  "Cursor": i32(1, 1, 9),
                                  "BlockTable": i32([-1, -1], [-1, -1],
                                                    [-1, 6])},
         {"per_row": True}),
        # a dropped row whose clamped block is the kept row's target
        ("paged_kv_cache_write", {"Cache": pool, "X": x3,
                                  "Cursor": i32(0, 0, 0),
                                  "BlockTable": i32([0, 1], [-1, -1],
                                                    [-1, -1])},
         {"per_row": True}),
        ("paged_kv_cache_prefill", {"Cache": pool,
                                    "X": rng.randn(1, 2, 8, 4).astype(
                                        "float32"),
                                    "Len": i32(6), "BlockTable": i32(3, -1)},
         {}),
        ("paged_flash_decode_attention", {"Q": x3, "KCache": pool,
                                          "VCache": pool * 2.0,
                                          "Cursor": i32(30, 0, 3),
                                          "BlockTable": table},
         {"per_row": True}),
        ("top_k_sampling", {"X": rng.randn(3, 50).astype("float32"),
                            "Step": None}, {"k": 1, "temperature": 1.0}),
        ("top_p_sampling", {"X": rng.randn(3, 50).astype("float32"),
                            "Step": None}, {"p": 0.9, "temperature": 0.0}),
    ]


_OP_CASES = _op_cases()


@pytest.mark.parametrize("case", range(len(_OP_CASES)),
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(_OP_CASES)])
def test_decode_op_matches_reference(interpret, case):
    op_type, ins, attrs = _OP_CASES[case]
    jdef = j_registry.get_op_def(op_type)
    jout = jdef.fn(j_registry.LoweringContext(mode="infer"), dict(attrs),
                   **{k: None if v is None else jnp.asarray(v)
                      for k, v in ins.items()})
    tdef = t_registry.get_op_def(op_type)
    # the port's cache ops write into their input: hand them copies
    tins = {k: None if v is None else torch.from_numpy(v.copy())
            for k, v in ins.items()}
    tout = tdef.fn(t_registry.LoweringContext(), dict(attrs), **tins)
    if op_type.endswith("sampling"):
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        assert tout.dtype == torch.int32
    else:
        _close(tout.numpy(), np.asarray(jout))
    if tdef.in_place:
        assert tout is tins["Cache"]


def test_in_place_cache_op_leaves_the_scope_value_when_out_differs():
    """The executor's one in-place exception: a cache write whose program
    sends the result to a new var gets a copy of the cache."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        cache = tfluid.layers.create_kv_cache(2, 1, 4, 2)
        x = tfluid.layers.data("x", shape=[2, 1, 2], dtype="float32",
                               append_batch_size=False)
        cur = tfluid.layers.data("cur", shape=[2], dtype="int32",
                                 append_batch_size=False)
        out = tfluid.layers.kv_cache_write(cache, x, cur, per_row=True,
                                           in_place=False)
    exe = tfluid.Executor(tfluid.CPUPlace())
    got, old = exe.run(main, feed={"x": np.ones((2, 1, 2), "float32"),
                                   "cur": np.asarray([1, 3], "int32")},
                       fetch_list=[out, cache])
    assert got[0, 0, 1].tolist() == [1.0, 1.0]
    assert got[1, 0, 3].tolist() == [1.0, 1.0]
    assert not old.any()


# ---------------------------------------------------------------------------
# DecodeEngine: reference vs port
# ---------------------------------------------------------------------------


def _logits_name(program):
    return next(op.input("X")[0] for op in program.global_block().ops
                if op.type in ("top_k_sampling", "top_p_sampling"))


def _drive(eng, prompts):
    """Prefill two prompts into slots 0 and 1 and run STEPS steps on the
    engine's programs directly, as its scheduler would; returns the
    logits and tokens of every stage and the caches after."""
    tables = np.full((2, MAX_LEN // BLOCK_LEN), -1, "int32")
    out, cur = [], []
    for slot, p in enumerate(prompts[:2]):
        length = eng.buckets.bucket_for_seq(p.size)
        main, fetch = eng._prefill[length]
        padded = np.zeros((1, length), "int32")
        padded[0, :p.size] = p
        feed = {"prompt_ids": padded,
                "prompt_len": np.asarray([p.size], "int32")}
        if eng.paged:
            tables[slot, :2] = ((5, 2), (0, 4))[slot]  # shuffled blocks
            feed["block_table"] = tables[slot:slot + 1]
        else:
            feed["slot"] = np.asarray([slot], "int32")
        logits, tok = eng._exe.run(main, feed=feed,
                                   fetch_list=[_logits_name(main), fetch],
                                   scope=eng.scope)
        out.append(np.asarray(logits))
        cur.append(int(np.asarray(tok).reshape(-1)[0]))
    cursors = np.asarray([p.size for p in prompts[:2]], "int32")
    for i in range(STEPS):
        feed = {"cur_ids": np.asarray(cur, "int32"), "cursors": cursors,
                "step": np.asarray([i + 1], "int32")}
        if eng.paged:
            feed["block_tables"] = tables
        logits, tok = eng._exe.run(
            eng._step_prog, feed=feed,
            fetch_list=[_logits_name(eng._step_prog), eng._step_fetch],
            scope=eng.scope)
        out.append(np.asarray(logits))
        cur = [int(t) for t in np.asarray(tok).reshape(-1)]
        cursors = cursors + 1
    caches = {n: np.asarray(eng.scope.get(n))
              for pair in eng._cache_names for n in pair}
    return out, caches


def _generate(eng, prompts):
    futs = [eng.submit(p) for p in prompts]
    return [list(f.result(timeout=120)[0]) for f in futs]


@pytest.fixture(scope="module")
def reference():
    """The reference engines, ring and paged: the logits and caches of a
    direct drive, then the greedy tokens of 3 requests on 2 slots through
    the scheduler, and the parameters."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_PALLAS", "interpret")
        mp.setenv("PADDLE_TPU_DECODE_MIN_T", "1")
        for paged in (False, True):
            jfluid.unique_name.switch()
            eng = JDecodeEngine(
                gpt_small.DecodeAdapter(_cfg(gpt_small), seed=SEED),
                slots=2, prompt_buckets=BUCKETS,
                config=JGenerationConfig(max_new_tokens=NEW_TOKENS),
                place=jfluid.CPUPlace(), name="gen", auto_start=False,
                paged=paged, block_len=BLOCK_LEN)
            drive = _drive(eng, _prompts())
            eng.start()
            tokens = _generate(eng, _prompts())
            eng.close()
            params = {p.name: np.asarray(eng.scope.get(p.name))
                      for p in eng._step_prog.all_parameters()}
            runs[paged] = (drive, tokens, params)
    return runs


def _port_engine(params, name="gen", **kw):
    tfluid.unique_name.switch()
    kw.setdefault("block_len", BLOCK_LEN)
    return DecodeEngine(
        tgpt.DecodeAdapter(_cfg(tgpt), seed=SEED, params=params), slots=2,
        prompt_buckets=BUCKETS,
        config=GenerationConfig(max_new_tokens=NEW_TOKENS),
        place=tfluid.CPUPlace(), name=name, **kw)


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_engine_logits_caches_and_tokens_match_reference(reference, paged):
    (ref_logits, ref_caches), ref_tokens, params = reference[paged]
    eng = _port_engine(params, paged=paged, auto_start=False)
    assert eng.paged == paged
    logits, caches = _drive(eng, _prompts())
    for got, ref in zip(logits, ref_logits):
        _close(got, ref)
    assert set(caches) == set(ref_caches)
    for name in caches:
        _close(caches[name], ref_caches[name])
    eng.start()
    try:
        assert _generate(eng, _prompts()) == ref_tokens
    finally:
        eng.close()
    st = eng.stats()
    assert st["completed"] == len(PROMPT_LENS) and st["paged"] == paged
    if paged:
        assert st["kv_blocks_free"] == st["kv_blocks_total"]


def test_port_ring_and_paged_agree_bit_for_bit(reference):
    params = reference[False][2]
    ring = _port_engine(params, paged=False, auto_start=False)
    paged = _port_engine(params, paged=True, auto_start=False)
    ring_logits, _ = _drive(ring, _prompts())
    paged_logits, _ = _drive(paged, _prompts())
    for a, b in zip(ring_logits, paged_logits):
        np.testing.assert_array_equal(a, b)
    assert ring.cache_bytes == paged.cache_bytes


@pytest.mark.parametrize("mode", ["disaggregate", "resize"])
def test_disaggregate_and_resize_keep_the_tokens(reference, mode):
    _drive_unused, ref_tokens, params = reference[True]
    if mode == "disaggregate":
        with _port_engine(params, paged=True, disaggregate=True) as eng:
            assert eng.stats()["disaggregated"]
            assert _generate(eng, _prompts()) == ref_tokens
        return
    with _port_engine(params, paged=True) as eng:
        assert _generate(eng, _prompts()[:1]) == ref_tokens[:1]
        eng.resize(3)
        assert eng.stats()["kv_blocks_total"] == 3 * eng.max_blocks
        assert _generate(eng, _prompts()) == ref_tokens


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_fused_programs_route_every_layer_to_the_kernels(paged):
    """At a width the fusion gates take (D % 128 == 0), a step runs one
    decode attention per layer, a fused add+LN per residual (two per
    layer; the final LN has no add) and two embedding gathers; a prefill
    runs one causal fused attention per layer, the same add+LNs and
    gathers: the per-step and per-prefill launch counts chip_smoke.py
    asserts on the card."""
    from paddle_tpu_torch.static_analysis import fusion

    cfg = tgpt.GPTConfig(vocab=256, hidden=128, layers=3, heads=2,
                         max_len=MAX_LEN)
    tfluid.unique_name.switch()
    eng = DecodeEngine(tgpt.DecodeAdapter(cfg), slots=8,
                       prompt_buckets=BUCKETS, place=tfluid.CPUPlace(),
                       paged=paged, auto_start=False)
    attn = ("paged_flash_decode_attention" if paged
            else "flash_decode_attention")
    progs = [(eng._step_prog, eng._step_fetch, attn)] + [
        (main, fetch, "fused_multihead_attention")
        for main, fetch in eng._prefill.values()]
    for prog, fetch, attention in progs:
        fused, report = fusion.resolve_fused_program(prog, targets=[fetch])
        types = [op.type for op in fused.global_block().ops]
        assert types.count(attention) == cfg.layers
        assert types.count("fused_dropout_add_ln") == 2 * cfg.layers
        assert types.count("fused_embedding_gather") == 2
        assert "layer_norm" in types  # lnf stays unfused
        assert report.counts()["dropout_add_ln"] == 2 * cfg.layers


def test_seeded_adapter_gives_the_same_weights_in_every_engine():
    a = _port_engine(None, name="a", paged=False, auto_start=False)
    b = _port_engine(None, name="b", paged=True, auto_start=False)
    for p in a._step_prog.all_parameters():
        assert torch.equal(a.scope.get(p.name), b.scope.get(p.name))


def test_server_routes_a_decode_tenant_beside_a_batch_tenant(reference,
                                                             tmp_path):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4], dtype="float32")
        y = tfluid.layers.fc(x, size=3)
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        tfluid.io.save_inference_model(str(tmp_path), ["x"], [y], exe,
                                       main_program=main)
    cfg = tfluid.inference.AnalysisConfig(model_dir=str(tmp_path))
    cfg.disable_gpu()
    pred = tfluid.inference.create_paddle_predictor(cfg)
    _drive_unused, ref_tokens, params = reference[False]
    eng = _port_engine(params, paged=False, auto_start=False)
    server = tfluid.serving.PredictorServer({"fc": pred, "gen": eng},
                                            verify=False, buckets=(1, 2))
    try:
        gens = [server.submit("gen", p) for p in _prompts()]
        batch = server.submit("fc", {"x": np.ones((2, 4), "float32")})
        assert [list(g.result(timeout=120)[0]) for g in gens] == ref_tokens
        assert batch.result(timeout=60)[0].shape == (2, 3)
        st = server.stats()
        assert st["decode"]["gen"]["completed"] == len(PROMPT_LENS)
        assert st["completed"] == 1
    finally:
        server.close()
    assert eng._closed  # the server closes its engines


def test_decode_loop_and_whole_program_builders_raise():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        ids = tfluid.layers.data("ids", shape=[2], dtype="int32",
                                 append_batch_size=False)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tfluid.layers.decode_loop(lambda c, k, i: c, ids, ids, 4)
    for build in (tgpt.build_program, tgpt.build_naive_program):
        with pytest.raises(NotImplementedError, match="While"):
            build(tgpt.GPT_TINY)


# ---------------------------------------------------------------------------
# sampled strategies
# ---------------------------------------------------------------------------


def _sample(op_type, logits, step, **attrs):
    ctx = t_registry.LoweringContext(program_seed=5)
    ctx.set_op(42)
    return t_registry.get_op_def(op_type).fn(
        ctx, dict(attrs, seed=9), X=torch.from_numpy(logits),
        Step=torch.tensor([step], dtype=torch.int32))


@pytest.mark.parametrize("op_type,attrs", [
    ("top_k_sampling", {"k": 4, "temperature": 1.5}),
    ("top_p_sampling", {"p": 0.5, "temperature": 1.0}),
], ids=["top_k", "top_p"])
def test_sampling_stays_in_the_kept_set_and_replays(op_type, attrs):
    logits = np.random.RandomState(1).randn(16, 50).astype("float32")
    order = np.argsort(-logits, axis=-1)
    if op_type == "top_k_sampling":
        allowed = [set(r[:attrs["k"]]) for r in order]
    else:
        probs = torch.softmax(torch.from_numpy(logits), -1).numpy()
        allowed = []
        for r, o in zip(probs, order):
            mass = np.cumsum(r[o]) - r[o]
            allowed.append(set(o[mass < attrs["p"]]))
    draws = [_sample(op_type, logits, step, **attrs).numpy()
             for step in range(6)]
    for d in draws:
        assert d.dtype == np.int32
        assert all(t in a for t, a in zip(d, allowed))
    np.testing.assert_array_equal(
        draws[2], _sample(op_type, logits, 2, **attrs).numpy())
    assert any((draws[0] != d).any() for d in draws[1:])


def test_sampled_engine_replays_with_the_same_seed(reference):
    params = reference[False][2]
    runs = []
    for _ in range(2):
        tfluid.unique_name.switch()
        with DecodeEngine(
                tgpt.DecodeAdapter(_cfg(tgpt), seed=SEED, params=params),
                slots=1, prompt_buckets=BUCKETS, place=tfluid.CPUPlace(),
                config=GenerationConfig(strategy="top_k", k=5, seed=4,
                                        max_new_tokens=NEW_TOKENS)) as eng:
            runs.append(_generate(eng, _prompts()))
    assert runs[0] == runs[1]
    assert all(0 <= t < 128 for r in runs[0] for t in r)
