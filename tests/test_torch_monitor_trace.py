"""The operator's CLIs and the watchdog in the port, against the reference.

One telemetry directory is written by the port on the CPU
(``chip_smoke.telemetry_run``: bert-tiny requests served through a
default ``PredictorServer``, the startup and 4 steps of a small training
program with every step journaled, a ``HeartbeatWriter`` beating for rank
0), then read by both packages: ``tools.monitor.collect_status`` at one
``now`` gives the same status, and ``tools.trace``'s ``--serving``,
``--slowest``, ``--id`` and ``--chrome`` views give the same ``--json``
output (and the same chrome file).  The comparisons are exact: both
packages read the same files.  Also the ``--alert`` grammar and the exit
codes 0 / 1 / 2 of both CLIs in both packages, and the port's
``HeartbeatWriter`` / ``HeartbeatMonitor`` / ``wait_cluster`` as the
reference's own tests hold the reference's
(``tests/test_resilience.py:521-592``), with the journal records and
counters a lost worker leaves in both.
"""

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import paddle_tpu.observability as jobs
from paddle_tpu.resilience import watchdog as jwatchdog
from paddle_tpu.tools import monitor as jmonitor
from paddle_tpu.tools import trace as jtrace

import chip_smoke
import paddle_tpu_torch as tfluid
import paddle_tpu_torch.observability as tobs
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.resilience import watchdog as twatchdog
from paddle_tpu_torch.tools import monitor as tmonitor
from paddle_tpu_torch.tools import trace as ttrace

T = 32
REQUESTS = 6
STEPS = 4
TOOLS = {"reference": (jmonitor, jtrace), "port": (tmonitor, ttrace)}

_TELEMETRY_ENV = ("PADDLE_TPU_TELEMETRY", "PADDLE_TPU_TRACING",
                  "PADDLE_TPU_TELEMETRY_DIR", "PADDLE_TPU_TRACE_SAMPLE",
                  "PADDLE_TPU_TRACEPARENT",
                  "PADDLE_TPU_TELEMETRY_STEP_EVERY")


def _predictor(dirname):
    cfg = copy.copy(tbert.BERT_TINY)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        feeds = [tfluid.layers.data(n, shape=s, dtype=d) for n, s, d in (
            ("input_ids", [T], "int64"), ("token_type_ids", [T], "int64"),
            ("attn_mask_bias", [1, 1, T], "float32"))]
        hidden = tbert.encoder(*feeds, cfg, T)
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        tfluid.io.save_inference_model(
            dirname, [f.name for f in feeds] + ["pos_ids"], [hidden], exe,
            main_program=main)
    acfg = tfluid.inference.AnalysisConfig(model_dir=dirname)
    acfg.disable_gpu()
    return tfluid.inference.create_paddle_predictor(acfg)


def _requests(n):
    rng = np.random.RandomState(3)
    out = []
    for _ in range(n):
        mask = np.zeros((1, 1, 1, T), "float32")
        mask[0, 0, 0, T - rng.randint(0, T // 2):] = -1e4
        out.append({"input_ids": rng.randint(0, 1024, (1, T)).astype(
                        "int64"),
                    "token_type_ids": np.zeros((1, T), "int64"),
                    "attn_mask_bias": mask,
                    "pos_ids": np.arange(T, dtype="int64")[None]})
    return out


def _train():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[8], dtype="float32")
        loss = tfluid.layers.mean(tfluid.layers.fc(x, size=4, act="relu"))
        tfluid.optimizer.SGD(0.1).minimize(loss)
    feed = {"x": np.random.RandomState(5).randn(4, 8).astype("float32")}
    return main, startup, feed, [loss], tfluid.CPUPlace()


def _telemetry_run(tmp_path_factory, submit_delay_s=0.0):
    """The port's served run and training run under one telemetry
    directory → (the directory, what ran, the ``now`` both packages read
    it at); ``submit_delay_s`` slows each request's submission, as a
    loaded machine does."""
    from paddle_tpu_torch import serving

    dirname = str(tmp_path_factory.mktemp("telemetry"))
    pred = _predictor(str(tmp_path_factory.mktemp("bert_tiny")))
    submit = serving.PredictorServer.submit

    def slow_submit(self, *args, **kwargs):
        time.sleep(submit_delay_s)
        return submit(self, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        for var in _TELEMETRY_ENV:
            mp.delenv(var, raising=False)
        mp.setenv("PADDLE_TPU_TELEMETRY_DIR", dirname)
        mp.setenv("PADDLE_TPU_TELEMETRY_STEP_EVERY", "1")
        if submit_delay_s:
            mp.setattr(serving.PredictorServer, "submit", slow_submit)
        tobs.reset_telemetry()
        try:
            ran, writer = chip_smoke.telemetry_run(
                tfluid, pred, _requests(REQUESTS), _train(), STEPS,
                heartbeat_s=0.05)
            writer.stop()
        finally:
            tobs.reset_telemetry()
    return dirname, ran, time.time() + 1.0


@pytest.fixture(scope="module")
def telemetry(tmp_path_factory):
    return _telemetry_run(tmp_path_factory)


def test_both_monitors_read_the_same_status(telemetry):
    """The reference's ``collect_status`` and the port's give the same
    dict at one ``now``; it counts what ran: every executor call a step
    event, the newest step number, the requests, one rank alive and not
    wedged; the fields whose writers are not ported read as absent."""
    dirname, ran, now = telemetry
    want = jmonitor.collect_status(dirname, now=now)
    got = tmonitor.collect_status(dirname, now=now)
    assert got == want
    serving = ttrace.serving_stats(ttrace.group_traces(
        tobs.read_traces(dirname)))
    assert chip_smoke.check_tools(got, serving, ran) == []
    assert ran["requests"] == REQUESTS and ran["train_calls"] == STEPS + 1
    assert got["serving_requests"] == REQUESTS
    assert got["ranks"]["0"]["done"] and got["ranks"]["0"]["step"] \
        == ran["last_step"]
    for absent in ("skip_rate", "checkpoint_age_s", "quant_error",
                   "guard_skips", "elastic_world_size", "autoscale"):
        assert got[absent] is None, absent
    assert "ALERT" not in tmonitor.render_status(got)
    assert tmonitor.render_status(got).splitlines()[1:] \
        == jmonitor.render_status(want).splitlines()[1:]


def test_the_status_does_not_depend_on_how_fast_requests_come(
        tmp_path_factory):
    """The test above under load: a server started before its requests
    are submitted races the submitting thread, and a slow submitter (six
    test workers on one CPU) has each request served alone, so the
    predictor's steps outnumber the training's and the newest step the
    journal and the heartbeat hold is not the one checked.  With every
    request queued before the dispatcher starts
    (``chip_smoke.telemetry_run``), a submitter that waits 0.2 s a
    request gives the same status."""
    dirname, ran, now = _telemetry_run(tmp_path_factory,
                                       submit_delay_s=0.2)
    assert ran["served_calls"] < STEPS + 1
    got = tmonitor.collect_status(dirname, now=now)
    assert got == jmonitor.collect_status(dirname, now=now)
    serving = ttrace.serving_stats(ttrace.group_traces(
        tobs.read_traces(dirname)))
    assert chip_smoke.check_tools(got, serving, ran) == []
    assert got["ranks"]["0"]["step"] == ran["last_step"]


def test_the_trace_does_not_depend_on_how_fast_requests_complete(
        tmp_path_factory, monkeypatch):
    """The two tests above under load, at the completion end: a batch
    span that ended after the request span it is the child of, by the
    time the batch's requests took to complete (a loaded machine), was
    left off that request's critical path, and with it the batch's
    ``serving.device`` phase (the trace's ``--serving`` view then had no
    ``device_p99_ms``).  With each request's completion slowed by 2 ms,
    four times the trace reader's clock skew, the status and the serving
    view still hold every phase."""
    from paddle_tpu_torch.serving import server as tserver

    done = tserver._obs.record_serving_done

    def slow_done(*args, **kwargs):
        time.sleep(0.002)
        return done(*args, **kwargs)

    monkeypatch.setattr(tserver._obs, "record_serving_done", slow_done)
    dirname, ran, now = _telemetry_run(tmp_path_factory)
    got = tmonitor.collect_status(dirname, now=now)
    assert got == jmonitor.collect_status(dirname, now=now)
    serving = ttrace.serving_stats(ttrace.group_traces(
        tobs.read_traces(dirname)))
    assert chip_smoke.check_tools(got, serving, ran) == []
    assert {"queue_wait_p99_ms", "device_p99_ms", "request_p99_ms"} \
        <= set(serving)


def _trace_json(module, argv, capsys):
    code = module.main(argv + ["--json"])
    out = capsys.readouterr().out
    return code, json.loads(out)


@pytest.mark.parametrize("view", ["serving", "slowest", "id", "chrome"])
def test_both_trace_views_give_the_same_json(view, telemetry, capsys,
                                             tmp_path):
    dirname, ran, _ = telemetry
    records = tobs.read_traces(dirname)
    args = {"serving": ["--serving"], "slowest": ["--slowest", "3"],
            "id": ["--id", next(r["trace"] for r in records
                                if r.get("name") == "serving.request")[:8]],
            "chrome": []}[view]
    outs = {}
    for label, (_mon, trace) in TOOLS.items():
        extra = []
        if view == "chrome":
            extra = ["--chrome", str(tmp_path / ("%s.json" % label))]
        outs[label] = _trace_json(trace, [dirname] + args + extra, capsys)
    assert outs["port"] == outs["reference"]
    code, stats = outs["port"]
    assert code == 0
    if view == "serving":
        assert stats["requests"] == ran["requests"]
        assert {"queue_wait_p99_ms", "device_p99_ms", "request_p99_ms"} \
            <= set(stats)
    elif view == "id":
        assert stats["root"] == "serving.request"
    elif view == "chrome":
        files = [json.loads((tmp_path / ("%s.json" % k)).read_text())
                 for k in TOOLS]
        assert files[0] == files[1] and files[1]["traceEvents"]
        assert stats == {"spans": len(records),
                         "traces": len({r["trace"] for r in records})}


_ALERTS = [("steps>0", 1), ("steps<0", 0), ("steps>=4", 1),
           ("serving_requests==6", 1), ("serving_requests!=6", 0),
           ("alive_ranks<1", 0), ("ranks.0.beat_age_s>=0", 1),
           ("quant_error>0.05", 2), ("skip_rate>0", 2),
           ("step_ms>-1", None)]


@pytest.mark.parametrize("expr,want", _ALERTS)
def test_alert_grammar_in_both_packages(expr, want, telemetry):
    """``<field><op><number>`` against the status: 1 tripped, 0 held, 2
    no data (a field whose writer is absent); ``step_ms`` falls back to
    ``drift.step_ms``; the same codes and messages in both packages."""
    dirname, _ran, now = telemetry
    status = tmonitor.collect_status(dirname, now=now)
    got = tmonitor.check_alert(status, expr)
    assert got == jmonitor.check_alert(status, expr)
    if want is not None:
        assert got[0] == want, got
    else:  # the drift alias: data exactly when the drift gauge is there
        assert got[0] == (2 if status["drift"] is None else 1)


def test_alert_refuses_a_bad_expression():
    for mon, _trace in TOOLS.values():
        for bad in ("steps>", "p99 step>1", "steps=>1", "steps>abc"):
            with pytest.raises(ValueError, match="bad alert"):
                mon.check_alert({}, bad)


@pytest.mark.parametrize("label", sorted(TOOLS))
def test_cli_exit_codes(label, telemetry, tmp_path, capsys):
    """The monitor: 1 when an alert trips, 0 when it holds, 2 for no data
    and for an empty directory; trace the same with ``--serving``."""
    dirname, _ran, _now = telemetry
    mon, trace = TOOLS[label]
    once = [dirname, "--once", "--json", "--alert"]
    codes = [mon.main(once + ["steps>0"]), mon.main(once + ["steps<0"]),
             mon.main(once + ["quant_error>0.05"]),
             mon.main([str(tmp_path), "--once"]),
             trace.main([dirname, "--serving", "--json", "--alert",
                         "requests>0"]),
             trace.main([dirname, "--serving", "--json", "--alert",
                         "requests>1000"]),
             trace.main([dirname, "--serving", "--json", "--alert",
                         "nothing>0"]),
             trace.main([str(tmp_path)])]
    capsys.readouterr()
    assert codes == [1, 0, 2, 2, 1, 0, 2, 2]


def test_port_clis_run_as_modules(telemetry):
    """``python -m paddle_tpu_torch.tools.monitor DIR --once --json`` and
    ``... tools.trace DIR --serving --json`` in subprocesses (with jax and
    the reference blocked)."""
    dirname, ran, _ = telemetry
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    block = ("import runpy, sys\n"
             "class B:\n"
             "    def find_spec(self, name, path=None, target=None):\n"
             "        if name.split('.')[0] in ('jax', 'jaxlib', "
             "'paddle_tpu'):\n"
             "            raise ImportError(name)\n"
             "sys.meta_path.insert(0, B())\n"
             "sys.argv = sys.argv[1:]\n"
             "runpy.run_module(sys.argv[0], run_name='__main__')\n")
    outs = {}
    for tool, args in (("monitor", ["--once", "--json"]),
                       ("trace", ["--serving", "--json"])):
        mod = "paddle_tpu_torch.tools." + tool
        res = subprocess.run([sys.executable, "-c", block, mod, dirname]
                             + args, cwd=root, env=dict(
                                 os.environ, PYTHONPATH=root),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        outs[tool] = json.loads(res.stdout)
    assert outs["monitor"]["steps"] == ran["last_step"]
    assert outs["trace"]["requests"] == ran["requests"]


# ---------------------------------------------------------------------------
# the watchdog, as the reference's tests hold the reference's
# ---------------------------------------------------------------------------

def test_wait_cluster_detects_dead_worker_quickly():
    sleeper = subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(60)"])
    dier = subprocess.Popen([sys.executable, "-c", "import sys; sys.exit(5)"])
    t0 = time.time()
    try:
        with pytest.raises(twatchdog.WorkerLostError) as ei:
            twatchdog.wait_cluster([sleeper, dier], timeout=30, poll=0.1)
    finally:
        for p in (sleeper, dier):
            if p.poll() is None:
                p.kill()
            p.wait()
    assert time.time() - t0 < 20
    assert 5 in ei.value.returncodes
    assert sleeper.poll() is not None


def test_wait_cluster_timeout_raises():
    p = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    try:
        with pytest.raises(twatchdog.WorkerLostError, match="timeout"):
            twatchdog.wait_cluster([p], timeout=0.5, poll=0.1)
    finally:
        if p.poll() is None:
            p.kill()
        p.wait()


def test_wait_cluster_all_ok():
    procs = [subprocess.Popen([sys.executable, "-c", "pass"])
             for _ in range(2)]
    assert twatchdog.wait_cluster(procs, timeout=30) == [0, 0]


def test_heartbeat_staleness(tmp_path):
    hb_dir = str(tmp_path)
    writer = twatchdog.HeartbeatWriter(hb_dir, rank=1, interval=0.1)
    writer.beat()
    mon = twatchdog.HeartbeatMonitor(hb_dir, ranks=[1], timeout=0.5,
                                     boot_grace=0.1)
    assert mon.check() is True
    stale_t = time.time() - 5.0
    os.utime(os.path.join(hb_dir, "hb-1"), (stale_t, stale_t))
    with pytest.raises(twatchdog.WorkerLostError) as ei:
        mon.check()
    assert ei.value.ranks == (1,)


def test_clean_shutdown_is_not_worker_loss(tmp_path):
    hb_dir = str(tmp_path)
    w = twatchdog.HeartbeatWriter(hb_dir, rank=1, interval=0.05).start()
    mon = twatchdog.HeartbeatMonitor(hb_dir, ranks=[1], timeout=0.3,
                                     boot_grace=0.1)
    assert mon.check() is True
    w.stop()
    time.sleep(0.6)
    assert mon.check() is True


def test_heartbeat_writer_keeps_beating(tmp_path):
    hb_dir = str(tmp_path)
    with twatchdog.HeartbeatWriter(hb_dir, rank=0, interval=0.05):
        mon = twatchdog.HeartbeatMonitor(hb_dir, ranks=[0], timeout=1.0)
        time.sleep(0.3)
        assert mon.check() is True


def _lost_worker(obs, watchdog, dirname, monkeypatch):
    """A stale peer under a telemetry directory → (the journal's
    worker-lost events, the two counters, the flight records)."""
    for var in _TELEMETRY_ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", dirname)
    obs.reset_telemetry()
    try:
        watchdog.HeartbeatWriter(dirname, rank=3, interval=1.0).beat()
        stale_t = time.time() - 60.0
        os.utime(os.path.join(dirname, "hb-3"), (stale_t, stale_t))
        mon = watchdog.HeartbeatMonitor(dirname, ranks=[3], timeout=1.0,
                                        boot_grace=0.0)
        time.sleep(0.01)  # past the (zero) boot grace
        with pytest.raises(watchdog.WorkerLostError):
            mon.check()
        obs.get_journal().flush()
        events = [{k: e[k] for k in ("kind", "ranks", "reason")}
                  for e in obs.read_journal(dirname)
                  if e["kind"] == "worker-lost"]
        reg = obs.registry()
        counters = (reg.get("watchdog_missed_beats_total").value,
                    reg.get("workers_lost_total").value)
        flights = [f["reason"] for f in obs.read_flight_records(dirname)]
    finally:
        obs.reset_telemetry()
    return events, counters, flights


def test_lost_worker_leaves_the_reference_records(tmp_path, monkeypatch):
    """``HeartbeatMonitor.check`` on a stale rank journals a
    ``worker-lost`` event, counts a missed beat and a lost worker and
    dumps a flight record, in both packages alike; the monitor then
    reports the rank lost."""
    got = _lost_worker(tobs, twatchdog, str(tmp_path / "port"), monkeypatch)
    want = _lost_worker(jobs, jwatchdog, str(tmp_path / "ref"), monkeypatch)
    assert got == want
    events, counters, flights = got
    assert events == [{"kind": "worker-lost", "ranks": [3],
                       "reason": "heartbeat stale > 1.0s"}]
    assert counters == (1, 1) and len(flights) == 1
    status = tmonitor.collect_status(str(tmp_path / "port"))
    assert status["lost_ranks"] == 1 and status["alive_ranks"] == 0
    assert tmonitor.check_alert(status, "lost_ranks>0")[0] == 1
