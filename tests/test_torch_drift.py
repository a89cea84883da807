"""The port's drift monitor against the reference's
(``tests/test_observability.py``'s drift cases), and its hooks.

* One measured series through both packages' monitors gives the same
  EMA, ratios, gauges, ``drift`` journal events and throttled
  calibration writes (each package with its own autotune cache and
  telemetry dir);
* ``register_report`` prices a program as the reference does under the
  same hardware numbers, and on the port's H100 defaults without them;
* the executor registers a key's program at its first call and feeds
  every step's wall time to the monitor (``record_step(drift_key=...)``),
  the collective schedule's bytes too;
* the executor's repair: autotune writes that resolve a program to a new
  fusion clone drop the old clone's cache entries, so the entries (and
  graphs) an executor holds stay bounded.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import autotune as jat
from paddle_tpu import observability as jobs
from paddle_tpu.observability import drift as jdrift
from paddle_tpu.observability import journal as jjournal
from paddle_tpu.observability import metrics as jmetrics

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import autotune as tat
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.observability import drift as tdrift
from paddle_tpu_torch.observability import journal as tjournal
from paddle_tpu_torch.observability import metrics as tmetrics

J = (jat, jobs, jdrift, jjournal, jmetrics, jfluid)
T = (tat, tobs, tdrift, tjournal, tmetrics, tfluid)
# both packages' cost models priced at the same hardware numbers
HW = {"peak_tflops": 100.0, "hbm_gbps": 1200.0, "ici_gbps": 100.0,
      "launch_us": 5.0}
SERIES = [20.0, 18.0, 25.0] + [21.0] * 40 + [30.0] * 120


class _Cluster:
    has_topology = False

    def __init__(self, **kw):
        self.__dict__.update(kw)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("PADDLE_TPU_TELEMETRY", "PADDLE_TPU_TELEMETRY_DIR",
                "PADDLE_TPU_DRIFT_RECORD", "PADDLE_TPU_DRIFT_EVERY",
                "PADDLE_TPU_DRIFT_RECORD_EVERY",
                "PADDLE_TPU_DRIFT_RECORD_DELTA", "PADDLE_TPU_AUTOTUNE"):
        monkeypatch.delenv(var, raising=False)
    for pkg in (J, T):
        pkg[1].reset_telemetry()
    yield
    for pkg in (J, T):
        pkg[1].reset_telemetry()
        pkg[0].reset()


def _series(pkg, tmp_path, monkeypatch, record):
    at, obs, drift, journal, metrics, _ = pkg
    name = pkg[5].__name__
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE",
                       str(tmp_path / ("%s.json" % name)))
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path / name))
    monkeypatch.setenv("PADDLE_TPU_DRIFT_EVERY", "25")
    monkeypatch.setenv("PADDLE_TPU_DRIFT_RECORD_EVERY", "40")
    if record is not None:
        monkeypatch.setenv("PADDLE_TPU_DRIFT_RECORD", record)
    at.reset()
    obs.reset_telemetry()
    m = drift.monitor()
    m.register("prog", predicted_step_ms=12.5, predicted_ici_bytes=4096,
               predicted_peak_bytes=1 << 20)
    trace = []
    for i, ms in enumerate(SERIES):
        st = m.observe_step(ms, key="prog", step=i)
        if i == 7:
            m.observe_scheduled_ici(2048, key="prog")
        trace.append((st.measured_ms_ema, st.measured_steps,
                      dict(st.ratios()), st._last_recorded_factor))
    journal.get_journal().flush()
    events = [{k: e[k] for k in ("step", "key", "measured_ms_ema",
                                 "measured_steps", "ratios")}
              for e in journal.read_journal(str(tmp_path / name))
              if e["kind"] == "drift"]
    reg = metrics.registry()
    gauges = {kind: reg.get("drift_ratio", kind=kind).value
              for kind in ("step_ms", "ici_bytes")}
    writes = reg.get("drift_calibrations_recorded_total")
    sig = at.sweep_signature(drift.DRIFT_CALIBRATION_FAMILY,
                             {"program": "prog"})
    return {"trace": trace, "events": events, "gauges": gauges,
            "ema_gauge": reg.get("measured_step_ms_ema",
                                 program="prog").value,
            "predicted": reg.get("predicted_step_ms",
                                 program="prog").value,
            "writes": writes.value if writes is not None else 0,
            "cached": at.lookup(sig), "recording": m.recording_enabled()}


@pytest.mark.parametrize("record", [None, "1", "0"])
def test_one_series_gives_the_reference_s_numbers(tmp_path, monkeypatch,
                                                  record):
    want = _series(J, tmp_path, monkeypatch, record)
    got = _series(T, tmp_path, monkeypatch, record)
    assert got == want
    assert len(got["events"]) == len(SERIES) // 25
    assert got["recording"] == (record != "0")
    if record != "0":
        # the first write after the 30-step warm-up, a later one once
        # the factor moved by more than 10%
        assert got["writes"] == 2
        assert got["cached"]["calibration"] == pytest.approx(
            got["trace"][-1][2]["step_ms"], rel=0.1)
    else:
        assert got["writes"] == 0 and got["cached"] is None
    assert all(np.isfinite(r) for r in got["trace"][-1][2].values())


def _fc_program(fluid, train=True):
    fluid.unique_name.switch()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.fc(input=x, size=8, act="relu")
        loss = fluid.layers.mean(y)
        if train:
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def test_register_report_prices_like_the_reference():
    from paddle_tpu.static_analysis import analyze_program as janalyze
    from paddle_tpu_torch.static_analysis import analyze_program as tanalyze

    prices = []
    for fluid, drift, analyze in ((jfluid, jdrift, janalyze),
                                  (tfluid, tdrift, tanalyze)):
        main, _, loss = _fc_program(fluid, train=False)
        report = analyze(main, targets=[loss], batch_size=4)
        key = drift.monitor().register_report(report,
                                              cluster=_Cluster(**HW))
        st = drift.monitor().get(key)
        assert st.predicted_peak_bytes == report.cost.peak_memory_bytes
        prices.append((key, st.predicted_step_ms))
    assert prices[1][0] == prices[0][0]
    assert prices[1][1] == pytest.approx(prices[0][1], rel=1e-9)
    # without a cluster the port prices at one H100's numbers
    main, _, loss = _fc_program(tfluid, train=False)
    report = tanalyze(main, targets=[loss], batch_size=4)
    key = tdrift.monitor().register_report(report)
    assert 0 < tdrift.monitor().get(key).predicted_step_ms \
        < prices[0][1]


def test_device_peak_is_none_on_the_cpu():
    assert tdrift._device_peak_bytes() is None


def test_executor_registers_at_first_call_and_feeds_each_step():
    main, startup, loss = _fc_program(tfluid)
    feed = {"x": np.random.RandomState(0).randn(4, 16).astype("float32")}
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        for _ in range(5):
            exe.run(main, feed=feed, fetch_list=[loss])
        entry = next(e for e in exe._cache.values() if e.calls == 5)
    st = tdrift.monitor().get(entry.drift_key)
    assert st.key == tdrift.program_key(entry.program)
    assert st.measured_steps == 5 and st.predicted_step_ms > 0
    assert np.isfinite(st.step_ratio()) and st.step_ratio() > 0
    assert tmetrics.registry().get("drift_ratio", kind="step_ms").value \
        == st.step_ratio()


def test_executor_registers_nothing_with_telemetry_off(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY", "0")
    tobs.reset_telemetry()
    main, startup, loss = _fc_program(tfluid)
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        exe.run(main, feed={"x": np.ones((2, 16), "float32")},
                fetch_list=[loss])
    assert all(e.drift_key is None for e in exe._cache.values())
    assert tdrift.monitor()._programs == {}


def test_collective_schedule_feeds_the_drift_monitor():
    from paddle_tpu_torch.observability import runtime

    class _Ev:
        numel, dtype = 256, "float32"

    tdrift.monitor().register("dp", predicted_step_ms=1.0,
                              predicted_ici_bytes=2048)
    runtime.set_collective_schedule({0: [_Ev(), _Ev()]}, drift_key="dp")
    assert tdrift.monitor().get("dp").ici_ratio() == 1.0


def test_autotune_writes_keep_the_held_entries_bounded(tmp_path,
                                                        monkeypatch):
    """Each autotune write of the calibration the program's K3 gate
    read gives the program a new fusion clone and so a new cache key;
    the executor drops the superseded clone's entries, so the entries it
    holds do not grow with the writes."""
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    tat.reset()
    tfluid.unique_name.switch()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        ids = tfluid.layers.data("ids", shape=[8, 1], dtype="int64")
        emb = tfluid.layers.embedding(ids, size=[100, 128])
        loss = tfluid.layers.mean(emb)
        tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    feed = {"ids": np.arange(16, dtype="int64").reshape(2, 8, 1)}
    held, losses = [], []
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        for write in range(6):
            for _ in range(3):
                losses.append(exe.run(main, feed=feed,
                                      fetch_list=[loss])[0])
            assert exe.last_run_mode == "graph"
            held.append(len(exe._cache))
            tat.record(tat.sweep_signature(
                "embedding_gather",
                {"rows": 100, "dim": 128, "dtype": "float32"}),
                {"calibration": 1.0 + write})
        # a program run with another fetch list keeps its own entries
        exe.run(main, feed=feed, fetch_list=[loss, emb])
        exe.run(main, feed=feed, fetch_list=[loss])
        assert exe.last_run_mode == "eager"  # resolved again after a write
        assert len(exe._cache) == held[-1] + 1
    assert held == [2] * 6  # the startup's entry and the newest clone's
    assert len(main._fusion_cache) <= 16
    assert all(np.isfinite(v).all() for v in losses)
