"""Speculative decoding of the PyTorch port against the reference.

The reference's ``TestSpeculative`` cases (``tests/test_paged_decode.py``)
run on the port's tiny paged model: a deterministic next-token chain
(next = last + 1) through the real paged cache ops and paged flash
decode.  Then a narrow GPT (vocab 128, hidden 64, 2 layers, 4 heads,
cache depth 64, blocks of 16) decodes speculatively in both packages
from the same parameters (the reference's, carried into the port through
``DecodeAdapter(params=...)``) and the same prompts, for four drafts:
prompt lookup, an oracle that proposes the plain greedy stream's own
tokens, one that proposes zeros, and a draft-model tenant with other
weights.  The token lists, ``rounds`` and ``accepted`` must be equal.
The reference runs with ``PADDLE_TPU_PALLAS=interpret`` and
``PADDLE_TPU_DECODE_MIN_T=1``, so its paged flash-decode Pallas body
scores the verify rows.
"""

import os
import sys

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.serving import DecodeEngine as JDecodeEngine
from paddle_tpu.serving import GenerationConfig as JGenerationConfig
from paddle_tpu.serving import SpeculativeDecoder as JSpeculativeDecoder
from paddle_tpu.serving import ngram_draft as j_ngram_draft

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.observability as tobs
import paddle_tpu_torch.observability.metrics as tom
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.serving import (DecodeEngine, GenerationConfig,
                                      SpeculativeDecoder, ngram_draft)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import gpt_small  # noqa: E402

V = 16
MAX_LEN = 64
BLOCK_LEN = 16
NEW_TOKENS = 12
K = 3
TARGET_SEED = 3
DRAFT_SEED = 11


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    tfluid.unique_name.switch()
    for var in ("PADDLE_TPU_TELEMETRY", "PADDLE_TPU_TELEMETRY_DIR",
                "PADDLE_TPU_TRACING", "PADDLE_TPU_PAGED_KV"):
        monkeypatch.delenv(var, raising=False)
    tobs.reset_telemetry()
    yield
    tobs.reset_telemetry()


class PagedTinyModel:
    """The reference tests' deterministic adapter with its paged
    builders: next token = current + 1, with the attention output folded
    in at zero weight, so a block-routing fault still poisons the
    logits."""

    def cache_spec(self):
        return 1, 1, 32, 4

    def _embed(self, ids_f, rows):
        ones = tfluid.layers.fill_constant([1, 4], "float32", 1.0)
        return tfluid.layers.matmul(tfluid.layers.reshape(ids_f, [rows, 1]),
                                    ones)

    def build_prefill_paged(self, prompt, plen, table, caches):
        L = tfluid.layers
        n = prompt.shape[1]
        pf = L.cast(prompt, "float32")
        x = L.reshape(self._embed(L.reshape(pf, [n]), n), [1, 1, n, 4])
        k, v = caches[0]
        L.paged_kv_cache_prefill(k, x, plen, table)
        L.paged_kv_cache_prefill(v, x, plen, table)
        idx = L.increment(L.assign(plen), value=-1, in_place=True)
        oh = L.cast(L.one_hot(L.reshape(idx, [1, 1]), n), "float32")
        last = L.reduce_sum(L.elementwise_mul(pf, oh), dim=[1])
        nxt = L.cast(L.scale(last, scale=1.0, bias=1.0), "int32")
        return L.scale(L.cast(L.one_hot(L.reshape(nxt, [1, 1]), V),
                              "float32"), 10.0)

    def build_step_paged(self, cur, cursors, tables, caches):
        L = tfluid.layers
        s = cur.shape[0]
        cf = L.cast(cur, "float32")
        x = L.reshape(self._embed(cf, s), [s, 1, 4])
        k, v = caches[0]
        L.paged_kv_cache_write(k, x, cursors, tables, per_row=True)
        L.paged_kv_cache_write(v, x, cursors, tables, per_row=True)
        att = L.paged_flash_decode(x, k, v, cursors, tables, per_row=True)
        zero = L.scale(L.reduce_sum(att, dim=[1, 2]), 0.0)
        nxt = L.cast(L.scale(cf, scale=1.0, bias=1.0), "int32")
        logits = L.scale(L.cast(L.one_hot(L.reshape(nxt, [s, 1]), V),
                                "float32"), 10.0)
        return L.elementwise_add(logits, L.reshape(zero, [s, 1]), axis=0)


def _chain(prompt, n):
    return [prompt[-1] + 1 + i for i in range(n)]


def _tiny_spec(draft, max_new=8, name="sp", eos_id=None):
    return SpeculativeDecoder(
        PagedTinyModel(), draft=draft, k=K,
        config=GenerationConfig(max_new_tokens=max_new, eos_id=eos_id),
        prompt_buckets=(8,), place=tfluid.CPUPlace(), name=name)


@pytest.mark.parametrize("context,k", [
    ([5, 1, 2, 5, 9, 5], 3), ([1, 2, 3], 2), ([7], 4), ([], 2),
    ([4, 4, 4, 8, 4], 5)])
def test_ngram_draft_matches_reference(context, k):
    assert ngram_draft(context, k) == j_ngram_draft(context, k)
    assert len(ngram_draft(context, k)) == k


@pytest.mark.parametrize("draft,rounds,rate", [
    ("chain", 2, 1.0), ("zeros", 7, 0.0)])
def test_tiny_model_stream_is_exact_whatever_the_draft(draft, rounds, rate):
    fn = (lambda ctx, k: _chain(ctx, k)) if draft == "chain" \
        else (lambda ctx, k: [0] * k)
    name = "sp_" + draft
    with _tiny_spec(fn, name=name) as dec:
        toks, info = dec.generate([3, 5, 7])
    assert toks == _chain([3, 5, 7], 8)
    assert info["rounds"] == rounds
    assert info["acceptance_rate"] == rate
    assert tom.gauge("spec_acceptance_rate", tenant=name).value == rate
    assert tom.counter("spec_tokens_proposed_total",
                       tenant=name).value == info["proposed"]
    assert tom.counter("spec_tokens_accepted_total",
                       tenant=name).value == info["accepted"]
    assert dec.engine._pool.num_free == dec.engine.num_blocks


def test_draft_model_tenant_is_exact_and_isolated():
    from paddle_tpu_torch.static_analysis.concurrency import \
        prove_scope_isolation

    with _tiny_spec(PagedTinyModel(), name="spd") as dec:
        toks, info = dec.generate([3, 5, 7])
        progs = dec.coresident_programs()
        labels = [lbl for lbl, _p, _t in progs]
        _fp, diags = prove_scope_isolation(
            [p for _l, p, _t in progs], labels=labels)
        assert not [d for d in diags if d.severity >= 40], \
            [str(d) for d in diags]
    assert any(lbl.startswith("spd.draft") for lbl in labels)
    assert toks == _chain([3, 5, 7], 8)
    assert info["acceptance_rate"] == 1.0


def test_eos_inside_the_accepted_window_truncates():
    with _tiny_spec(lambda ctx, k: _chain(ctx, k), max_new=10, name="spe",
                    eos_id=8) as dec:
        toks, _info = dec.generate([5])
    assert toks == [6, 7, 8]


def test_greedy_only_and_the_budget_is_checked():
    with pytest.raises(ValueError, match="greedy"):
        SpeculativeDecoder(PagedTinyModel(),
                           config=GenerationConfig(strategy="top_k"),
                           prompt_buckets=(8,), place=tfluid.CPUPlace())
    with pytest.raises(ValueError, match="k must be"):
        SpeculativeDecoder(PagedTinyModel(), k=0, prompt_buckets=(8,),
                           place=tfluid.CPUPlace())
    with _tiny_spec("ngram", max_new=40, name="spb") as dec:
        with pytest.raises(ValueError, match="cache depth"):
            dec.generate([1, 2, 3])


def test_telemetry_off_records_nothing(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY", "0")
    tobs.reset_telemetry()
    with _tiny_spec(lambda ctx, k: _chain(ctx, k), name="spoff") as dec:
        dec.generate([3, 5, 7])
    assert tom.counter("spec_tokens_proposed_total",
                       tenant="spoff").value == 0


# ---------------------------------------------------------------------------
# the port against the reference on a narrow GPT
# ---------------------------------------------------------------------------

DRAFTS = ("ngram", "oracle", "zeros", "model")


def _cfg(module):
    return module.GPTConfig(vocab=128, hidden=64, layers=2, heads=4,
                            max_len=MAX_LEN)


def _prompts():
    rng = np.random.RandomState(0)
    loop = [int(t) for t in rng.randint(1, 127, size=4)]
    return [np.asarray(loop * 3, "int32"),
            rng.randint(1, 127, size=9).astype("int32")]


def _oracle(plain):
    """Proposes the plain greedy stream's own next tokens."""
    def draft(context, k):
        for prompt, toks in plain:
            full = list(prompt) + list(toks)
            if full[:len(context)] == list(context):
                nxt = full[len(context):len(context) + k]
                return nxt + [0] * (k - len(nxt))
        raise AssertionError("context is not a plain greedy prefix")
    return draft


def _run(pkg, params, draft_params):
    """Plain greedy tokens and every draft's (tokens, rounds, accepted)
    of package ``pkg`` ("ref" or "port")."""
    ref = pkg == "ref"
    fluid = jfluid if ref else tfluid
    mod = gpt_small if ref else tgpt
    Engine = JDecodeEngine if ref else DecodeEngine
    Config = JGenerationConfig if ref else GenerationConfig
    Spec = JSpeculativeDecoder if ref else SpeculativeDecoder

    def adapter(seed, p):
        if ref:
            return gpt_small.DecodeAdapter(_cfg(gpt_small), seed=seed)
        return tgpt.DecodeAdapter(_cfg(tgpt), seed=seed, params=p)

    cfg = Config(max_new_tokens=NEW_TOKENS)
    fluid.unique_name.switch()
    plain_eng = Engine(adapter(TARGET_SEED, params), slots=1,
                       prompt_buckets=(16,), config=cfg,
                       place=fluid.CPUPlace(), name="plain", paged=True,
                       block_len=BLOCK_LEN)
    try:
        plain = [(p.tolist(), list(plain_eng.submit(p).result(
            timeout=300)[0])) for p in _prompts()]
    finally:
        plain_eng.close()
    out = {"plain": [t for _p, t in plain]}
    learned = {}
    # one decoder serves the three callable drafts, switched between
    # generations; the model draft needs its own tenant
    current = []
    callables = {"ngram": ngram_draft if not ref else j_ngram_draft,
                 "oracle": _oracle(plain),
                 "zeros": lambda ctx, k: [0] * k}
    for name in ("callable", "model"):
        draft = (adapter(DRAFT_SEED, draft_params) if name == "model"
                 else (lambda ctx, k: current[0](ctx, k)))
        fluid.unique_name.switch()
        dec = Spec(adapter(TARGET_SEED, params), draft=draft, k=K,
                   prompt_buckets=(16,), config=cfg,
                   place=fluid.CPUPlace(), name="spec_" + name,
                   block_len=BLOCK_LEN)
        try:
            for dname in (callables if name == "callable" else ["model"]):
                current[:] = [callables.get(dname)]
                runs = []
                for p in _prompts():
                    toks, info = dec.generate(p)
                    runs.append((list(toks), info["rounds"],
                                 info["accepted"]))
                out[dname] = runs
            if ref and name == "callable":
                learned["params"] = {
                    q.name: np.asarray(dec.engine.scope.get(q.name))
                    for q in dec.engine._step_prog.all_parameters()}
            if ref and name == "model":
                deng = dec._draft.eng
                learned["draft_params"] = {
                    q.name: np.asarray(deng.scope.get(q.name))
                    for q in deng._step_prog.all_parameters()}
        finally:
            dec.close()
    return out, learned


@pytest.fixture(scope="module")
def reference():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_PALLAS", "interpret")
        mp.setenv("PADDLE_TPU_DECODE_MIN_T", "1")
        return _run("ref", None, None)


@pytest.fixture(scope="module")
def port(reference):
    _out, learned = reference
    return _run("port", learned["params"], learned["draft_params"])[0]


@pytest.mark.parametrize("draft", DRAFTS)
def test_port_tokens_rounds_and_accepted_match_reference(reference, port,
                                                         draft):
    ref = reference[0]
    assert port["plain"] == ref["plain"]
    assert port[draft] == ref[draft]
    for (toks, _r, _a), plain in zip(port[draft], port["plain"]):
        assert toks == plain  # the gate: speculative = plain greedy


def test_the_drafts_span_the_acceptance_range(port):
    k_rounds = {d: [(r, a) for _t, r, a in port[d]] for d in DRAFTS}
    # the oracle's proposals match but where they run past the stream
    assert all(a >= K * (r - 1) for r, a in k_rounds["oracle"])
    assert all(a == 0 for _r, a in k_rounds["zeros"])
    assert all(r == NEW_TOKENS - 1 for r, _a in k_rounds["zeros"])
