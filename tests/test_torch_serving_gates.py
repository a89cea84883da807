"""Serving started as the reference starts it, on the CPU, against the
reference package.

A bert-tiny encoder (vocab 1024, hidden 128, 2 layers, T=64) exported by
the reference and a narrow GPT decoder (vocab 128, hidden 64, 2 layers,
cache depth 64) with the reference's weights serve as co-resident
tenants of one ``PredictorServer`` built with its default arguments, so
the scope-overlap proof and the zero-sync certificate gate it.  The
reference runs with ``PADDLE_TPU_PALLAS=interpret`` (and
``PADDLE_TPU_DECODE_MIN_T=1``), as its own tests do.  Tolerances: the
served encoder rows against the reference within
``tests/test_torch_bert_serving.py``'s 1e-4 (float32, sums in another
order), against the same port server built with ``verify=False`` bit for
bit; greedy tokens equal.  Also ``run_batches``, the load generator's
report and ``tools.serve``'s exit codes in both packages.
"""

import copy
import json
import os
import sys

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.observability as jobs
from paddle_tpu import serving as jserving
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.observability as tobs
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.static_analysis.verifier import VerifyError

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import gpt_small  # noqa: E402

T = 64
FEEDS = ["input_ids", "token_type_ids", "attn_mask_bias", "pos_ids"]
PORT_VS_REF_ATOL = 1e-4
ROWS = (1, 2, 3, 1)
PROMPTS = [np.random.RandomState(0).randint(1, 127, size=n).astype("int32")
           for n in (5, 12, 3)]
NEW_TOKENS = 5


def _feed(seed, rows):
    rng = np.random.RandomState(seed)
    mask = np.zeros((rows, 1, 1, T), "float32")
    for r in range(rows):
        mask[r, 0, 0, T - rng.randint(0, T // 2):] = -1e4
    return {"input_ids": rng.randint(0, 1024, (rows, T)).astype("int64"),
            "token_type_ids": rng.randint(0, 2, (rows, T)).astype("int64"),
            "attn_mask_bias": mask,
            "pos_ids": np.tile(np.arange(T, dtype="int64"), (rows, 1))}


def _gpt_cfg(module):
    return module.GPTConfig(vocab=128, hidden=64, layers=2, heads=4,
                            max_len=64)


def _reference_engine():
    jfluid.unique_name.switch()
    return jserving.DecodeEngine(
        gpt_small.DecodeAdapter(_gpt_cfg(gpt_small), seed=3), slots=2,
        prompt_buckets=(8, 16),
        config=jserving.GenerationConfig(max_new_tokens=NEW_TOKENS),
        place=jfluid.CPUPlace(), name="gen", auto_start=False, paged=False)


def _port_engine(params):
    tfluid.unique_name.switch()
    return tserving.DecodeEngine(
        tgpt.DecodeAdapter(_gpt_cfg(tgpt), seed=3, params=params), slots=2,
        prompt_buckets=(8, 16),
        config=tserving.GenerationConfig(max_new_tokens=NEW_TOKENS),
        place=tfluid.CPUPlace(), name="gen", auto_start=False, paged=False)


def _port_predictor(d):
    cfg = tfluid.inference.AnalysisConfig(model_dir=d)
    cfg.disable_gpu()
    return tfluid.inference.create_paddle_predictor(cfg)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The reference exports bert-tiny and drives its decode engine; its
    encoder outputs, greedy tokens and decoder weights are the
    oracles."""
    d = str(tmp_path_factory.mktemp("bert_tiny"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_PALLAS", "interpret")
        mp.setenv("PADDLE_TPU_DECODE_MIN_T", "1")
        jfluid.unique_name.switch()
        cfg = copy.copy(jbert.BERT_TINY)
        cfg.fuse_attn = True
        main, startup = jfluid.Program(), jfluid.Program()
        with jfluid.program_guard(main, startup):
            ids = jfluid.layers.data("input_ids", shape=[T], dtype="int64")
            tt = jfluid.layers.data("token_type_ids", shape=[T],
                                    dtype="int64")
            mask = jfluid.layers.data("attn_mask_bias", shape=[1, 1, T],
                                      dtype="float32")
            hidden = jbert.encoder(ids, tt, mask, cfg, T)
        with jfluid.scope_guard(jfluid.Scope()):
            exe = jfluid.Executor(jfluid.CPUPlace())
            exe.run(startup)
            jfluid.io.save_inference_model(d, FEEDS, [hidden], exe,
                                           main_program=main)
        jpred = jfluid.inference.create_paddle_predictor(
            jfluid.inference.AnalysisConfig(model_dir=d))
        feeds = [_feed(10 + i, r) for i, r in enumerate(ROWS)]
        want = [np.asarray(jpred.run(f)[0]) for f in feeds]
        eng = _reference_engine()
        params = {p.name: np.asarray(eng.scope.get(p.name))
                  for p in eng._step_prog.all_parameters()}
        eng.start()
        tokens = [list(f.result(timeout=120)[0])
                  for f in [eng.submit(p) for p in PROMPTS]]
        eng.close()
    return {"dir": d, "feeds": feeds, "want": want, "tokens": tokens,
            "params": params}


def _serve(server, feeds):
    reqs = [server.submit("bert", f, request_id="b%d" % i)
            for i, f in enumerate(feeds)]
    gens = [server.submit("gen", p, request_id="g%d" % i)
            for i, p in enumerate(PROMPTS)]
    server.start()
    outs = [r.result(timeout=120)[0] for r in reqs]
    tokens = [list(g.result(timeout=120)[0]) for g in gens]
    return outs, tokens


@pytest.mark.parametrize("telemetry", [True, False], ids=["on", "off"])
def test_default_server_gates_and_serves(models, telemetry):
    tobs.reset_telemetry()
    tobs.set_telemetry_enabled(telemetry)
    tobs.set_tracing_enabled(telemetry)
    results = {}
    try:
        for verify in (True, False):
            server = tserving.PredictorServer(
                {"bert": _port_predictor(models["dir"]),
                 "gen": _port_engine(models["params"])},
                buckets=(1, 2, 4), auto_start=False,
                **({} if verify else {"verify": False}))
            try:
                results[verify] = _serve(server, models["feeds"])
                if verify:
                    assert server.certificates and all(
                        c.ok for c in server.certificates.values())
                    assert sorted(server.certificates) == ["bert", "gen"]
                    assert server.stats()["zero_sync"] == {"bert": True,
                                                           "gen": True}
            finally:
                server.close()
    finally:
        tobs.reset_telemetry()
    (outs, tokens), (outs_nv, tokens_nv) = results[True], results[False]
    assert tokens == tokens_nv == models["tokens"]
    for got, same, want in zip(outs, outs_nv, models["want"]):
        np.testing.assert_array_equal(got, same)
        np.testing.assert_allclose(got, want, atol=PORT_VS_REF_ATOL, rtol=0)


def _flow(obs, serving, pred, eng, feeds):
    obs.reset_telemetry()
    server = serving.PredictorServer({"bert": pred, "gen": eng},
                                     buckets=(1, 2, 4), auto_start=False)
    try:
        _serve(server, feeds)
    finally:
        server.close()
    names = {r["name"] for r in obs.get_tracer().records()}
    metrics = {k.split("{")[0] for k in obs.export_json()["metrics"]}
    obs.reset_telemetry()
    return names, metrics


def test_both_packages_emit_the_same_spans_for_one_request_flow(
        models, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")
    monkeypatch.setenv("PADDLE_TPU_DECODE_MIN_T", "1")
    jpred = jfluid.inference.create_paddle_predictor(
        jfluid.inference.AnalysisConfig(model_dir=models["dir"]))
    ref = _flow(jobs, jserving, jpred, _reference_engine(),
                models["feeds"])
    port = _flow(tobs, tserving, _port_predictor(models["dir"]),
                 _port_engine(models["params"]), models["feeds"])
    assert port[0] == ref[0]
    assert {"serving.request", "serving.queue_wait", "serving.batch",
            "serving.pad", "serving.dispatch", "serving.device",
            "serving.sync", "serving.prefill", "serving.decode_step",
            "serving.decode", "executor.step", "executor.compile",
            "executor.dispatch", "host.sync"} <= port[0]
    # the series the flow leaves (the reference's drift and compile-
    # telemetry gauges aside, which need its cost model)
    assert port[1] <= ref[1]
    assert {"serving_requests_total", "serving_latency_ms",
            "serving_decode_tokens_total", "steps_total", "compile_ms",
            "jit_cache_hits_total", "host_syncs_total"} <= port[1]


def test_run_batches_equals_run_and_names_a_bad_request(models):
    pred = _port_predictor(models["dir"])
    feeds = [_feed(40 + i, 2) for i in range(5)] + [_feed(40, 2)]
    want = [pred.run(f)[0] for f in feeds]
    for depth in (1, 2):
        got = [out[0] for out in pred.run_batches(feeds,
                                                  max_in_flight=depth,
                                                  verify=True)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert pred.program._serving_hot_loop
    assert pred.program._max_in_flight == 2
    bad = [dict(f) for f in feeds[:3]]
    bad[1]["input_ids"] = bad[1]["input_ids"][:, :T - 1]
    messages = []
    jpred = jfluid.inference.create_paddle_predictor(
        jfluid.inference.AnalysisConfig(model_dir=models["dir"]))
    for p in (jpred, pred):
        with pytest.raises(ValueError) as info:
            list(p.run_batches(bad, request_ids=["a", "b", "c"]))
        messages.append(str(info.value))
    assert messages[1] == messages[0]
    assert messages[1].startswith("request 'b' (batch #1): ")


def test_run_batches_feed_cache_never_writes_a_staged_feed(models):
    """Repeated host feeds hit the pipeline's cache; the staged tensor
    keeps the host values after every step that read it."""
    from paddle_tpu_torch import pipeline

    pred = _port_predictor(models["dir"])
    feed = _feed(7, 2)
    cache = pipeline.FeedCache()
    staged = pipeline.device_put_feed(feed, cache=cache,
                                      place=tfluid.CPUPlace())
    for name, arr in feed.items():
        assert staged[name].numpy() is not arr
    outs = [pred.run(staged)[0] for _ in range(3)]
    again = pipeline.device_put_feed(feed, cache=cache,
                                     place=tfluid.CPUPlace())
    for name, arr in feed.items():
        assert again[name] is staged[name]
        np.testing.assert_array_equal(again[name].numpy(), arr)
    np.testing.assert_array_equal(outs[0], outs[2])
    np.testing.assert_array_equal(outs[0], pred.run(feed)[0])


def test_run_load_reports_the_reference_keys(models):
    reports = []
    for fluid, serving, pred in (
            (jfluid, jserving, jfluid.inference.create_paddle_predictor(
                jfluid.inference.AnalysisConfig(model_dir=models["dir"]))),
            (tfluid, tserving, _port_predictor(models["dir"]))):
        server = serving.PredictorServer({"bert": pred}, buckets=(1, 2),
                                         auto_start=False)
        rng = np.random.RandomState(0)
        server.warmup({"bert": serving.make_feed_sampler(pred, rng=rng)()})
        server.start()
        try:
            reports.append(serving.run_load(
                server, {"bert": serving.make_feed_sampler(
                    pred, rows=1, rng=rng, int_high=1024)},
                qps=400.0, requests=6))
        finally:
            server.close()
    assert set(reports[1]) == set(reports[0])
    assert set(reports[1]["tenants"]["bert"]) == set(
        reports[0]["tenants"]["bert"])
    assert reports[1]["completed"] == 6 and reports[1]["p99_ms"] > 0
    assert tserving.percentile([3.0, 1.0, 2.0], 50) == 2.0


def _save_fc(fluid, d, counter=False):
    """A tiny fc model; ``counter`` adds a persistable the program
    increments and adds to its output (two tenants of it collide)."""
    fluid.unique_name.switch()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        y = fluid.layers.fc(x, size=3)
        if counter:
            main.global_block().create_var(
                name="requests_seen", shape=[1], dtype="float32",
                persistable=True)
            seen = startup.global_block().create_var(
                name="requests_seen", shape=[1], dtype="float32",
                persistable=True)
            fluid.layers.fill_constant([1], "float32", 0.0, out=seen)
            main.global_block().append_op(
                type="increment", inputs={"X": ["requests_seen"]},
                outputs={"Out": ["requests_seen"]}, attrs={"step": 1.0})
            y = fluid.layers.elementwise_add(
                y, main.global_block().var("requests_seen"))
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        fluid.io.save_inference_model(str(d), ["x"], [y], exe,
                                      main_program=main)
    return str(d)


def test_serve_cli_exit_codes_in_both_packages(tmp_path, monkeypatch,
                                               capsys):
    from paddle_tpu.tools import serve as jserve
    from paddle_tpu_torch.tools import serve as tserve

    monkeypatch.setenv("PADDLE_TPU_STRICT_SYNC", "1")
    # the port's CLI runs on CUDAPlace(0), as the reference's flags ask;
    # the test asks for the CPU through the config
    monkeypatch.setattr(tfluid.inference.AnalysisConfig, "use_gpu",
                        lambda self: False)
    d = _save_fc(jfluid, tmp_path / "fc")
    dc = _save_fc(jfluid, tmp_path / "counter", counter=True)
    runs = {}
    for name, cli in (("ref", jserve), ("port", tserve)):
        capsys.readouterr()
        rc_ok = cli.main([d, "--requests", "8", "--qps", "500",
                          "--buckets", "1,2", "--json"])
        report = json.loads(capsys.readouterr().out)
        rc_cert = cli.main([d, "--certify-zero-sync"])
        cert = capsys.readouterr().out
        rc_gate = cli.main(["--tenants", "a=%s,b=%s" % (dc, dc),
                            "--requests", "2"])
        gate = capsys.readouterr().err
        with pytest.raises(SystemExit) as bad_flag:
            cli.main([d, "--qps", "many"])
        rc_none = cli.main([])
        runs[name] = (rc_ok, rc_cert, rc_gate, bad_flag.value.code, rc_none,
                      sorted(report), report["completed"],
                      report["zero_sync"], cert.splitlines()[0],
                      "scope-overlap" in gate)
    assert runs["port"] == runs["ref"]
    assert runs["port"][:5] == (0, 0, 1, 2, 2)
    assert runs["port"][6:] == (8, {"default": True},
                                "zero-sync certificate for serving:default: "
                                "PASS", True)


def test_verify_error_before_traffic_and_unported_battery(models):
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.static_analysis import verifier

    pred = _port_predictor(models["dir"])
    with pytest.raises(NotImplementedError, match="Queue A item 3"):
        verifier.verify_program(pred.program)
    with pytest.raises(NotImplementedError, match="Queue A item 3"):
        verifier.assert_valid(pred.program)
    with pytest.raises(NotImplementedError, match="Queue A item 3"):
        analysis.Analyzer().run(pred.program, verify=True)
    with pytest.raises(NotImplementedError, match="Queue A item 3"):
        tfluid.Executor(tfluid.CPUPlace()).run(pred.program, verify=True)
    same = _port_predictor(models["dir"])
    for prog in (pred.program, same.program):
        prog.global_block().create_var(name="requests_seen", shape=[1],
                                       dtype="float32", persistable=True)
        prog.global_block().append_op(
            type="increment", inputs={"X": ["requests_seen"]},
            outputs={"Out": ["requests_seen"]}, attrs={"step": 1.0})
    with pytest.raises(VerifyError, match="scope-overlap"):
        tserving.PredictorServer({"a": pred, "b": same})
