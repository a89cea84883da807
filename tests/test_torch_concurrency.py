"""The port's concurrency proofs against the reference's.

The same builder code runs in ``paddle_tpu`` and ``paddle_tpu_torch``
(each with its unique-name counter reset), and the two packages'
``static_analysis.concurrency`` must agree exactly — footprints,
diagnostics (check, severity, block/op coordinates, var names, message,
hint) and zero-sync certificates — on:

* a bert-tiny inference program (T=32);
* a narrow GPT decode engine (vocab 128, hidden 64, 2 layers), ring and
  paged, and a disaggregated one with its prefill programs;
* a program with host-IO ops and a host table in its hot loop;
* a training program whose fetches race with its in-place updates;
* two tenants that write one persistable, which both packages' servers
  refuse with ``VerifyError``.

Nothing here runs a step except the engines' startup programs, so the
reference needs no Pallas kernel.
"""

import copy
import os
import sys

import pytest

import paddle_tpu as jfluid
from paddle_tpu import serving as jserving
from paddle_tpu.models import bert as jbert
from paddle_tpu.static_analysis import concurrency as jconc
from paddle_tpu.static_analysis.verifier import VerifyError as JVerifyError

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.static_analysis import concurrency as tconc
from paddle_tpu_torch.static_analysis.verifier import \
    VerifyError as TVerifyError

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import gpt_small  # noqa: E402

J = (jfluid, jconc)
T = (tfluid, tconc)
SEQ = 32


def _bert_program(fluid, bert):
    fluid.unique_name.switch()
    cfg = copy.copy(bert.BERT_TINY)
    cfg.fuse_attn = True
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data("input_ids", shape=[SEQ], dtype="int64")
        tt = fluid.layers.data("token_type_ids", shape=[SEQ], dtype="int64")
        mask = fluid.layers.data("attn_mask_bias", shape=[1, 1, SEQ],
                                 dtype="float32")
        hidden = bert.encoder(ids, tt, mask, cfg, SEQ)
    return main.clone(for_test=True), [hidden.name]


def _train_program(fluid):
    """SGD updates its parameters in place; the program fetches one of
    them and overwrites a fed var."""
    fluid.unique_name.switch()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        y = fluid.layers.fc(x, size=3, param_attr=fluid.ParamAttr(name="w"))
        loss = fluid.layers.reduce_sum(y)
        fluid.optimizer.SGD(0.1).minimize(loss)
        fluid.layers.assign(fluid.layers.relu(x), output=x)
    return main, [loss.name, "w"]


def _host_io_program(fluid):
    fluid.unique_name.switch()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        y = fluid.layers.fc(x, size=3)
    block = main.global_block()
    block.append_op(type="save", inputs={"X": [y.name]},
                    attrs={"file_path": "never_written"})
    block.append_op(type="load", outputs={"Out": [y.name]},
                    attrs={"file_path": "never_read"})
    main._host_tables = ["emb_table"]
    main._nan_guard = True
    return main, [y.name]


def _dicts(diags):
    return [d.to_dict() for d in diags]


def _report(conc, program, targets, k):
    return conc.analyze_concurrency(program, targets=targets,
                                    max_in_flight=k,
                                    certify=True).to_dict()


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("build", ["bert", "train", "host_io"])
def test_programs_give_the_same_report(build, k):
    reports = []
    for fluid, conc in (J, T):
        if build == "bert":
            prog, targets = _bert_program(
                fluid, jbert if fluid is jfluid else tbert)
        elif build == "train":
            prog, targets = _train_program(fluid)
        else:
            prog, targets = _host_io_program(fluid)
        reports.append((_report(conc, prog, targets, k),
                        conc.scope_footprint(prog).to_dict(),
                        conc.certify_zero_sync(prog, targets=targets,
                                               label="p").format()))
    assert reports[1] == reports[0]
    report, footprint, _cert = reports[1]
    if build == "bert":
        assert report["race_free"] and report["certificate"]["ok"]
        assert footprint["writes"] == [] and len(footprint["reads"]) > 20
    elif build == "train":
        checks = sorted(r["check"] for r in report["races"])
        assert checks == ([] if k == 1 else
                          ["donated-buffer-live-read",
                           "race-inflight-write"])
        assert "w" in footprint["writes"]
    else:
        cert = report["certificate"]
        assert not cert["ok"] and len(cert["violations"]) == 3
        assert [s["op_type"] for s in cert["violations"][:2]] == [
            "save", "load"]
        assert len(cert["allowed"]) == 1


@pytest.mark.parametrize("build", ["bert", "train", "host_io"])
def test_async_hot_path_gate_agrees(build):
    verdicts = []
    for fluid, conc in (J, T):
        if build == "bert":
            prog, targets = _bert_program(
                fluid, jbert if fluid is jfluid else tbert)
        elif build == "train":
            prog, targets = _train_program(fluid)
        else:
            prog, targets = _host_io_program(fluid)
        err = JVerifyError if fluid is jfluid else TVerifyError
        try:
            verdicts.append(("ok", _dicts(conc.verify_async_hot_path(
                prog, targets=targets, max_in_flight=2, label="gate"))))
        except err as exc:
            verdicts.append(("raised", _dicts(exc.diagnostics)))
    assert verdicts[1] == verdicts[0]
    assert verdicts[1][0] == ("ok" if build == "bert" else "raised")


def _engine(fluid, serving, adapter, **kw):
    fluid.unique_name.switch()
    return serving.DecodeEngine(
        adapter, slots=2, prompt_buckets=(8, 16),
        config=serving.GenerationConfig(max_new_tokens=4),
        place=fluid.CPUPlace(), name="gen", auto_start=False,
        block_len=16, **kw)


def _gpt(fluid):
    if fluid is jfluid:
        cfg = gpt_small.GPTConfig(vocab=128, hidden=64, layers=2, heads=4,
                                  max_len=64)
        return gpt_small.DecodeAdapter(cfg, seed=3)
    cfg = tgpt.GPTConfig(vocab=128, hidden=64, layers=2, heads=4, max_len=64)
    return tgpt.DecodeAdapter(cfg, seed=3)


@pytest.fixture(scope="module")
def engines():
    out = {}
    for mode, kw in (("ring", dict(paged=False)), ("paged", dict(paged=True)),
                     ("disaggregated", dict(paged=True, disaggregate=True))):
        out[mode] = [
            _engine(jfluid, jserving, _gpt(jfluid), **kw),
            _engine(tfluid, tserving, _gpt(tfluid), **kw)]
    return out


@pytest.mark.parametrize("mode", ["ring", "paged", "disaggregated"])
def test_decode_engines_give_the_same_proofs(engines, mode):
    results = []
    for eng, conc in zip(engines[mode], (jconc, tconc)):
        co = eng.coresident_programs()
        labels = [label for label, _p, _t in co]
        prints, diags = conc.prove_scope_isolation(
            [p for _l, p, _t in co], labels=labels)
        reports = [_report(conc, p, t, 2) for _l, p, t in co]
        gates = [_dicts(conc.verify_async_hot_path(p, targets=t,
                                                   max_in_flight=2))
                 for _l, p, t in co]
        results.append((labels, [f.to_dict() for f in prints],
                        _dicts(diags), reports, gates,
                        eng.get_input_names(), eng.get_output_names()))
    assert results[1] == results[0]
    labels, prints, diags, reports, _gates, _ins, _outs = results[1]
    assert all(r["race_free"] and r["certificate"]["ok"] for r in reports)
    assert len(prints[0]["writes"]) == 4  # 2 layers x K, V caches
    if mode == "disaggregated":
        assert labels == ["gen", "gen.prefill8", "gen.prefill16"]
        # prefill and step share the pool by declared handoff only
        assert {d["check"] for d in diags} == {"scope-handoff",
                                               "scope-overlap"}
        assert all(d["severity"] != "ERROR" for d in diags)
    else:
        assert labels == ["gen"] and diags == []


class _Stub:
    """Predictor-shaped tenant over a program (never run)."""

    def __init__(self, program, fetch):
        self.program = program
        self._fetch = fetch

    def get_input_names(self):
        return ["x"]

    def get_output_names(self):
        return [self._fetch]

    def run_async(self, feed):
        raise AssertionError("a refused server runs nothing")


def _counter_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        y = fluid.layers.fc(x, size=3)
    block = main.global_block()
    block.create_var(name="requests_seen", shape=[1], dtype="float32",
                     persistable=True)
    block.append_op(type="increment", inputs={"X": ["requests_seen"]},
                    outputs={"Out": ["requests_seen"]}, attrs={"step": 1.0})
    return main, y.name


def test_two_tenants_writing_one_persistable_are_refused():
    refused = []
    for fluid, serving, err in ((jfluid, jserving, JVerifyError),
                                (tfluid, tserving, TVerifyError)):
        fluid.unique_name.switch()
        a = _Stub(*_counter_program(fluid))
        b = _Stub(*_counter_program(fluid))
        with pytest.raises(err) as info:
            serving.PredictorServer({"a": a, "b": b}, auto_start=False)
        refused.append((str(info.value), _dicts(info.value.diagnostics)))
        assert not hasattr(a.program, "_serving_hot_loop")
        # verify=False builds it (and still certifies the hot loop)
        server = serving.PredictorServer({"a": a, "b": b}, verify=False,
                                         auto_start=False)
        assert sorted(server.certificates) == ["a", "b"]
        server.close()
    assert refused[1] == refused[0]
    text = refused[1][0]
    assert text.startswith("multi-tenant placement rejected")
    assert "[ERROR] scope-overlap: a and b share a written scope var: " \
        "requests_seen" in text


def test_registered_checks_and_resolve_max_in_flight(monkeypatch):
    from paddle_tpu.static_analysis import checks as jchecks
    from paddle_tpu_torch.static_analysis import checks as tchecks

    for cid in tconc.CONCURRENCY_CHECK_IDS:
        assert cid in tchecks.all_checks() and cid in jchecks.all_checks()
    prog, _ = _train_program(tfluid)
    monkeypatch.setenv("PADDLE_TPU_MAX_IN_FLIGHT", "3")
    assert tconc.resolve_max_in_flight(prog) == 3
    prog._max_in_flight = 5
    assert tconc.resolve_max_in_flight(prog) == 5
    assert tconc.resolve_max_in_flight(prog, explicit=0) == 1
    monkeypatch.setenv("PADDLE_TPU_STRICT_SYNC", "1")
    assert tconc.strict_sync_enabled(prog) and jconc.strict_sync_enabled(prog)
    base = tconc.race_signatures(prog, targets=["w"])
    assert tconc.race_signatures(prog, targets=["w"]) == base
    with pytest.raises(TVerifyError, match="rewrite introduced a race"):
        tconc.assert_no_new_races(prog, set(), "a rewrite", targets=["w"])
