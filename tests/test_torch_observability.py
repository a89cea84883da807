"""The port's observability layer against the reference's.

The same sequence of recorder and span calls goes through
``paddle_tpu.observability`` and ``paddle_tpu_torch.observability``:
the exported JSON (timestamps, pids and span ids excepted), the
Prometheus text, the journal and the span tree must be identical — the
comparison is exact (every recorded value is given, none measured).
Also the kill switches (API and env) and the flight recorder dump.
"""

import collections
import threading

import pytest

import paddle_tpu.observability as jobs
from paddle_tpu.observability import runtime as jrt

import paddle_tpu_torch.observability as tobs
from paddle_tpu_torch.observability import runtime as trt

PACKAGES = [(jobs, jrt), (tobs, trt)]

Event = collections.namedtuple("Event", ["numel", "dtype"])


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    for var in ("PADDLE_TPU_TELEMETRY", "PADDLE_TPU_TRACING",
                "PADDLE_TPU_TELEMETRY_DIR", "PADDLE_TPU_TRACE_SAMPLE",
                "PADDLE_TPU_TRACEPARENT", "PADDLE_TPU_TELEMETRY_STEP_EVERY"):
        monkeypatch.delenv(var, raising=False)
    for obs, _rt in PACKAGES:
        obs.reset_telemetry()
    yield
    for obs, _rt in PACKAGES:
        obs.reset_telemetry()


def _record(obs, rt):
    """One process's worth of hook calls: executor, pipeline, serving,
    decode, gates, collectives, and a span tree crossing a thread."""
    rt.set_collective_schedule({0: [Event(1024, "float32"),
                                    Event(8, "bfloat16")],
                                1: [Event(3, "int64")]})
    for step, (wall, disp) in enumerate([(4.0, 1.0), (2.5, 0.25),
                                         (30.0, None)]):
        rt.record_step("executor", step, wall, dispatch_ms=disp)
    rt.record_jit_cache(False)
    rt.record_jit_cache(True)
    rt.record_jit_cache(True, runner="spmd")
    rt.record_compile(1234.5)
    rt.record_fusion_resolve(False)
    rt.record_fusion_resolve(True)
    rt.record_feed_cache(True)
    rt.record_feed_cache(False)
    rt.record_feed_cache_eviction(3)
    rt.record_sync(0.75, handles=4)
    rt.record_prefetch(1, 2)
    for tenant in ("bert", "gpt"):
        rt.record_serving_request(tenant)
        rt.record_serving_batch(tenant, 8, 5)
        rt.record_serving_queue_wait(tenant, 3.0)
        rt.record_serving_sync(tenant, 0.5)
        rt.record_serving_done(tenant, 21.0)
    rt.record_serving_reject()
    rt.record_serving_shed("bert")
    rt.set_serving_depths(7, 2)
    rt.set_serving_throughput(99.5)
    rt.record_decode_tokens("gpt", 8)
    rt.record_decode_request("gpt", 64, ttft_ms=12.0)
    rt.record_decode_request("gpt", 3)
    rt.set_decode_throughput(1500.0)
    rt.set_kv_pool("gpt", 256, 64)
    rt.record_kv_handoff("gpt", 0.4, 5)
    rt.record_decode_resize("gpt", 8, 16)
    rt.record_concurrency_check(0, gate="analyze")
    rt.record_concurrency_check(2, gate="run_batches", tripped=True)

    tr = obs.tracing
    with tr.span("serving.request", tenant="bert", rows=3) as root:
        with tr.span("serving.pad", bucket=8):
            pass
        ctx = tr.capture_context()

        def worker():
            with tr.use_context(ctx):
                with tr.span("pipeline.prefetch", depth=2) as p:
                    p.set_attr("items", 4)

        t = threading.Thread(target=worker)
        t.start()
        t.join()
        dev = tr.start_span("serving.device", parent=root, bucket=8)
        # the reference's null span takes no dur_ms (the port's does)
        dev.end(dur_ms=1.5) if dev.recording else dev.end()
        with tr.span_if_traced("executor.dispatch"):
            pass
    try:
        with tr.span("serving.sync", handles=1):
            raise KeyError("x")
    except KeyError:
        pass
    # a root-level interior phase records nothing
    with tr.span_if_traced("host.sync"):
        pass
    return tr.get_tracer().records()


def _span_tree(records):
    by_id = {r["span"]: r for r in records}
    out = []
    for r in records:
        parent = by_id.get(r["parent"])
        out.append((r["name"], parent["name"] if parent else None,
                    r["status"], tuple(sorted((r.get("attrs") or {}).items())),
                    r["dur_ms"] if r["name"] == "serving.device" else None,
                    r["thread"] != threading.current_thread().name))
    return sorted(out, key=repr)


def _events(obs):
    return [{k: v for k, v in e.items() if k not in ("ts", "trace")}
            for e in obs.get_journal().events()]


def test_same_calls_give_the_same_export_journal_and_span_tree():
    spans = [_record(obs, rt) for obs, rt in PACKAGES]
    (jo, _), (to, _) = PACKAGES
    jsnap, tsnap = jo.export_json(), to.export_json()
    assert set(jsnap) == set(tsnap) == {"schema", "ts", "pid", "metrics"}
    assert tsnap["metrics"] == jsnap["metrics"]
    assert len(tsnap["metrics"]) > 40
    assert to.export_prometheus() == jo.export_prometheus()
    assert _events(to) == _events(jo)
    assert _span_tree(spans[1]) == _span_tree(spans[0])
    assert len(spans[1]) == 6
    assert trt.collective_step_shape() == jrt.collective_step_shape() == {
        "ring:0": "2x/4112B", "ring:1": "1x/24B"}
    t_last = {k: v for k, v in trt.last_step_info().items() if k != "ts"}
    j_last = {k: v for k, v in jrt.last_step_info().items() if k != "ts"}
    assert t_last == j_last == {"step": 2, "step_ms": 30.0}


def test_histogram_percentiles_and_registry_kinds_agree():
    for obs, _rt in PACKAGES:
        h = obs.histogram("lat_ms", tenant="a")
        for v in (0.01, 0.3, 0.3, 7.0, 400.0, 2e5):
            h.observe(v)
        with pytest.raises(TypeError):
            obs.counter("lat_ms", tenant="a")
        with pytest.raises(ValueError):
            obs.counter("c").inc(-1)
    jh = jobs.registry().get("lat_ms", tenant="a")
    th = tobs.registry().get("lat_ms", tenant="a")
    for p in (0, 1, 50, 90, 99, 100):
        assert th.percentile(p) == jh.percentile(p)
    assert th.to_dict() == jh.to_dict()


@pytest.mark.parametrize("how", ["api", "env"])
def test_kill_switches(how, monkeypatch):
    if how == "env":
        monkeypatch.setenv("PADDLE_TPU_TELEMETRY", "0")
        monkeypatch.setenv("PADDLE_TPU_TRACING", "off")
    for obs, rt in PACKAGES:
        obs.reset_telemetry()
        if how == "api":
            obs.set_telemetry_enabled(False)
            obs.set_tracing_enabled(False)
        assert not obs.telemetry_enabled() and not obs.tracing_enabled()
        _record(obs, rt)
        assert obs.export_json()["metrics"] == {}
        assert obs.export_prometheus() == ""
        assert obs.get_journal().events() == []
        assert obs.get_tracer().records() == []
        assert obs.counter("x") is obs.metrics.NULL_METRIC
        assert obs.span("x") is obs.NULL_SPAN
        assert not obs.sample_step(0)
        assert obs.flight_dump("nothing") is None
    tobs.NULL_SPAN.end("ok", dur_ms=1.0)  # the serving path's call


def test_step_sampling_follows_the_trace(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TRACE_SAMPLE", "4")
    for obs, _rt in PACKAGES:
        obs.reset_telemetry()
        standalone = [obs.sample_step(s) for s in range(9)]
        with obs.span("serving.request"):
            traced = [obs.sample_step(s) for s in range(9)]
        assert standalone == [s % 4 == 0 for s in range(9)]
        assert all(traced)


def test_flight_dump_and_dispatcher_death(tmp_path, monkeypatch):
    dumps = []
    for i, (obs, rt) in enumerate(PACKAGES):
        d = tmp_path / ("pkg%d" % i)
        monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(d))
        obs.reset_telemetry()
        with obs.span("serving.batch", bucket=8):
            with obs.span("serving.sync"):
                rt.record_dispatcher_died("RuntimeError: boom", 3)
        recs = obs.read_flight_records(str(d))
        assert len(recs) == 1
        rec = recs[0]
        dumps.append((rec["reason"], sorted(s["name"]
                                            for s in rec["open_spans"])))
        obs.get_tracer().flush()
        obs.get_journal().flush()
        traces = obs.read_traces(str(d))
        assert sorted(r["name"] for r in traces) == ["serving.batch",
                                                     "serving.sync"]
        died = [e for e in obs.read_journal(str(d))
                if e["kind"] == "dispatcher-died"]
        assert len(died) == 1 and died[0]["failed_requests"] == 3
        assert died[0]["trace"] == traces[0]["trace"]
    assert dumps[0] == dumps[1] == (
        "dispatcher-died: RuntimeError: boom",
        ["serving.batch", "serving.sync"])


def test_traceparent_round_trip_and_remote_parent(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TRACEPARENT",
                       "00-0123456789abcdef0123456789abcdef-00000000000000ff-01")
    for obs, _rt in PACKAGES:
        obs.reset_telemetry()
        tr = obs.tracing
        with tr.span("executor.step") as s:
            assert s.trace_id == "0123456789abcdef0123456789abcdef"
            assert s.parent_id == "00000000000000ff"
            assert tr.parse_traceparent(s.traceparent) == s.context
        assert tr.parse_traceparent("garbage") is None
        env = tr.inject_env({})
        assert env["PADDLE_TPU_TRACEPARENT"].startswith(
            "00-0123456789abcdef")
