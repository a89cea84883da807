"""Predicted-vs-measured drift monitor (mirrors
``paddle_tpu/observability/drift.py``, all of it).

Joins the static analyzer's predictions (the cost model's
``price_program`` step ms, with the port's H100 defaults, collective
bytes, the liveness peak memory) against what the runtime measures (each
step's wall time, the device's peak allocated memory), and keeps three
things current while the job runs:

* ``drift_ratio{kind=...}`` gauges — measured / predicted, the single
  number an SLO can watch (1.0 = the model is honest; finite always);
* periodic ``drift`` journal events for the monitor CLI;
* calibration factors recorded into the autotune cache while steps
  run, so steady-state training teaches the cost model too.

Recording discipline: an autotune-cache write is a file write, and it
moves the cache's ``state_token``, after which every cached fusion
resolution looks again at the calibration factors it read (no fusion
gate reads the ``drift`` family, so none resolves again).  Writes are
throttled: only after a warmup, at most every
``PADDLE_TPU_DRIFT_RECORD_EVERY`` steps, and only when the factor moved
by more than
``PADDLE_TPU_DRIFT_RECORD_DELTA`` (default 10%) from what the cache
already holds.
"""

import hashlib
import os
import threading

from . import journal as _journal
from . import metrics as _metrics

__all__ = ["DRIFT_CALIBRATION_FAMILY", "ProgramDrift", "DriftMonitor",
           "monitor", "reset_drift", "program_key"]

#: autotune-cache family continuous runtime calibrations are filed
#: under (the bench planner child keeps its own ``planner`` family)
DRIFT_CALIBRATION_FAMILY = "drift"

_EMA_ALPHA = 0.1
_WARMUP_STEPS = 5
#: a calibration write costs a file write and a look at every cached
#: fusion resolution's reads, so
#: the FIRST record waits until the EMA has actually converged —
#: recording at step 5 guarantees a >10%-moved re-record (and another
#: capture) a hundred steps later as the EMA settles
_RECORD_WARMUP_STEPS = 30
#: drift_ratio gauge handles by kind — resolved once, off the step path
_RATIO_GAUGES = {}
_QUANT_GAUGES = {}
#: device memory stats are polled every Nth observed step, off the
#: per-step hot path
_MEM_POLL_EVERY = 16


def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name, default):
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def program_key(program):
    """Stable-ish fingerprint of a program's op structure — the join
    key between predictions registered at compile time and step
    latencies observed later, and the autotune signature component (so
    a factor learned in one run resolves in the next)."""
    try:
        h = hashlib.sha1()
        for block in program.blocks:
            for op in block.ops:
                h.update(op.type.encode())
                h.update(b"|")
        return h.hexdigest()[:12]
    except Exception:  # noqa: BLE001 - any program-ish object must do
        return "prog-%x" % (id(program) & 0xFFFFFF)


class ProgramDrift:
    """Prediction + running measurement for one registered program."""

    __slots__ = ("key", "predicted_step_ms", "predicted_ici_bytes",
                 "predicted_peak_bytes", "measured_ms_ema",
                 "measured_steps", "measured_peak_bytes",
                 "scheduled_ici_bytes", "_last_recorded_factor",
                 "_steps_since_record", "_g_ema")

    def __init__(self, key, predicted_step_ms,
                 predicted_ici_bytes=None, predicted_peak_bytes=None):
        self.key = key
        self.predicted_step_ms = float(predicted_step_ms)
        self.predicted_ici_bytes = predicted_ici_bytes
        self.predicted_peak_bytes = predicted_peak_bytes
        self.measured_ms_ema = None
        self.measured_steps = 0
        self.measured_peak_bytes = None
        self.scheduled_ici_bytes = None
        self._last_recorded_factor = None
        self._steps_since_record = 0
        self._g_ema = None  # cached per-series gauge (hot path)

    def step_ratio(self):
        if self.measured_ms_ema is None or self.predicted_step_ms <= 0:
            return None
        return self.measured_ms_ema / self.predicted_step_ms

    def hbm_ratio(self):
        if not self.measured_peak_bytes or not self.predicted_peak_bytes:
            return None
        return self.measured_peak_bytes / float(self.predicted_peak_bytes)

    def ici_ratio(self):
        if self.scheduled_ici_bytes is None \
                or not self.predicted_ici_bytes:
            return None
        return self.scheduled_ici_bytes / float(self.predicted_ici_bytes)

    def ratios(self):
        out = {}
        for kind, r in (("step_ms", self.step_ratio()),
                        ("peak_hbm", self.hbm_ratio()),
                        ("ici_bytes", self.ici_ratio())):
            if r is not None:
                out[kind] = r
        return out

    def to_dict(self):
        return {
            "key": self.key,
            "predicted_step_ms": self.predicted_step_ms,
            "predicted_ici_bytes": self.predicted_ici_bytes,
            "predicted_peak_bytes": self.predicted_peak_bytes,
            "measured_ms_ema": self.measured_ms_ema,
            "measured_steps": self.measured_steps,
            "measured_peak_bytes": self.measured_peak_bytes,
            "ratios": self.ratios(),
        }


def _device_peak_bytes():
    """Peak device memory allocated by this process
    (``torch.cuda.max_memory_allocated``); None on the CPU."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return torch.cuda.max_memory_allocated() or None


class DriftMonitor:
    """Registry of per-program drift states; thread-safe."""

    def __init__(self):
        self._programs = {}
        self._last_key = None
        self._lock = threading.Lock()
        self._recording = None
        self.journal_every = _env_int("PADDLE_TPU_DRIFT_EVERY", 50)
        self.record_every = _env_int(
            "PADDLE_TPU_DRIFT_RECORD_EVERY", 100)
        self.record_delta = _env_float(
            "PADDLE_TPU_DRIFT_RECORD_DELTA", 0.10)

    # -- registration ---------------------------------------------------

    def register(self, key, predicted_step_ms, predicted_ici_bytes=None,
                 predicted_peak_bytes=None, tier_bytes=None):
        with self._lock:
            state = ProgramDrift(key, predicted_step_ms,
                                 predicted_ici_bytes,
                                 predicted_peak_bytes)
            self._programs[key] = state
            self._last_key = key
        g = _metrics.gauge("predicted_step_ms", program=key)
        g.set(predicted_step_ms)
        # per-tier wire gauges (ici/dcn/pod) when the cluster carries a
        # topology tree — tools.monitor surfaces these next to the
        # drift ratios so a mis-tiered plan shows up as DCN bytes
        for tier, nbytes in sorted((tier_bytes or {}).items()):
            _metrics.gauge("predicted_tier_bytes", program=key,
                           tier=tier).set(nbytes)
        return state

    def register_program(self, program, cluster=None, batch_size=None,
                         targets=(), nranks=None):
        """Price ``program`` with the static cost model and register
        the prediction.  Returns the join key, or None when analysis
        fails (telemetry never breaks the run)."""
        key = program_key(program)
        with self._lock:
            if key in self._programs:
                self._last_key = key
                return key
        try:
            from ..static_analysis.cost import price_program

            # calibration=1.0: drift measures the RAW model error; a
            # learned factor folded in here would chase measured and
            # report 1.0 forever
            report, price = price_program(
                program, cluster=cluster, nranks=nranks,
                targets=targets, batch_size=batch_size,
                calibration=1.0)
        except Exception:  # noqa: BLE001 - analysis must not kill a run
            return None
        tiers = None
        if getattr(cluster, "has_topology", False):
            try:
                tiers = report.ici_bytes_per_tier(cluster)
            except Exception:  # noqa: BLE001 - telemetry only
                tiers = None
        self.register(key, price.step_ms,
                      predicted_ici_bytes=report.total_ici_bytes,
                      predicted_peak_bytes=report.peak_memory_bytes,
                      tier_bytes=tiers)
        return key

    def register_report(self, report, cluster=None, key=None):
        """Register from an existing :class:`AnalysisReport` (the
        analyzer already ran; don't pay for a second interp).  Without a
        ``cluster`` the prices use the cost model's H100 defaults."""
        from ..static_analysis import cost as _cost

        if key is None:
            key = program_key(report.program)
        price = _cost.price_plan(
            report.cost,
            peak_tflops=getattr(cluster, "peak_tflops",
                                _cost.H100_PEAK_TFLOPS),
            hbm_gbps=getattr(cluster, "hbm_gbps", _cost.H100_HBM_GBPS),
            ici_gbps=getattr(cluster, "ici_gbps", _cost.H100_NVLINK_GBPS),
            launch_us=getattr(cluster, "launch_us", 5.0),
            calibration=1.0)
        tiers = None
        if getattr(cluster, "has_topology", False):
            try:
                tiers = report.cost.ici_bytes_per_tier(cluster)
            except Exception:  # noqa: BLE001 - telemetry only
                tiers = None
        self.register(key, price.step_ms,
                      predicted_ici_bytes=report.cost.total_ici_bytes,
                      predicted_peak_bytes=report.cost.peak_memory_bytes,
                      tier_bytes=tiers)
        return key

    def get(self, key=None):
        with self._lock:
            return self._programs.get(key or self._last_key)

    # -- measurement ----------------------------------------------------

    def observe_step(self, measured_ms, key=None, step=None):
        """Fold one measured step latency in; refresh gauges, maybe
        journal, maybe record a calibration factor."""
        state = self.get(key)
        if state is None:
            return None
        with self._lock:
            state.measured_steps += 1
            state._steps_since_record += 1
            if state.measured_ms_ema is None:
                state.measured_ms_ema = float(measured_ms)
            else:
                state.measured_ms_ema += _EMA_ALPHA * (
                    float(measured_ms) - state.measured_ms_ema)
        if state.measured_steps % _MEM_POLL_EVERY == 1:
            peak = _device_peak_bytes()
            if peak:
                state.measured_peak_bytes = peak
        self._export(state)
        if self.journal_every > 0 \
                and state.measured_steps % self.journal_every == 0:
            _journal.emit("drift", step=step, **state.to_dict())
        self._maybe_record(state)
        return state

    def observe_scheduled_ici(self, bytes_per_step, key=None):
        state = self.get(key)
        if state is not None:
            state.scheduled_ici_bytes = int(bytes_per_step)
            self._export(state)

    def _export(self, state):
        if state._g_ema is None:
            state._g_ema = _metrics.gauge("measured_step_ms_ema",
                                          program=state.key)
        state._g_ema.set(state.measured_ms_ema or 0.0)
        for kind, r in state.ratios().items():
            g = _RATIO_GAUGES.get(kind)
            if g is None:
                g = _metrics.gauge("drift_ratio", kind=kind)
                _RATIO_GAUGES[kind] = g
            g.set(r)

    def ratios(self, key=None):
        state = self.get(key)
        return state.ratios() if state is not None else {}

    def observe_quant_error(self, measured, predicted=None, bucket=None):
        """Per-bucket quantization-error gauges for the quant subsystem
        (``paddle_tpu_torch/quant``; no caller yet, ROADMAP.md Queue A
        item 8): ``quant_error`` holds the measured
        relative RMS error of the int8 round trip and
        ``quant_error_ratio`` the measured/predicted factor against the
        blockwise error model — the convergence tripwire
        ``tools.monitor --alert 'quant_error>0.05'`` watches in
        production."""
        label = str(bucket) if bucket is not None else "all"
        g = _QUANT_GAUGES.get(label)
        if g is None:
            g = _metrics.gauge("quant_error", bucket=label)
            _QUANT_GAUGES[label] = g
        g.set(float(measured))
        if predicted is not None and float(predicted) > 0:
            rg = _QUANT_GAUGES.get(("ratio", label))
            if rg is None:
                rg = _metrics.gauge("quant_error_ratio", bucket=label)
                _QUANT_GAUGES[("ratio", label)] = rg
            rg.set(float(measured) / float(predicted))

    # -- calibration feedback -------------------------------------------

    def recording_enabled(self):
        """Whether the continuous calibration feedback writes to the
        autotune cache: ``PADDLE_TPU_DRIFT_RECORD=1/0`` wins; default
        is on exactly when a telemetry dir is configured (a deployed
        run), so the write never perturbs plain programmatic use.  Cached per monitor (env reads are off the
        step budget); ``reset_drift()`` re-arms it."""
        if self._recording is None:
            v = os.environ.get(
                "PADDLE_TPU_DRIFT_RECORD", "").strip().lower()
            if v:
                self._recording = v not in ("0", "false", "off", "no")
            else:
                self._recording = _journal.journal_dir() is not None
        return self._recording

    def _maybe_record(self, state):
        """Throttled write of measured/predicted into the autotune
        cache (see module docstring for why throttled)."""
        ratio = state.step_ratio()
        if ratio is None or state.measured_steps < _RECORD_WARMUP_STEPS:
            return False
        if not self.recording_enabled():
            return False
        if state._steps_since_record < self.record_every \
                and state._last_recorded_factor is not None:
            return False
        prior = state._last_recorded_factor
        if prior is None:
            prior = self._cached_factor(state.key)
        if prior is not None and prior > 0:
            if abs(ratio - prior) / prior < self.record_delta:
                state._steps_since_record = 0
                state._last_recorded_factor = prior
                return False
        return self.record_calibration(state)

    def _signature(self, key):
        try:
            from ..autotune import sweep_signature

            return sweep_signature(
                DRIFT_CALIBRATION_FAMILY, {"program": key})
        except Exception:  # noqa: BLE001
            return None

    def _cached_factor(self, key):
        sig = self._signature(key)
        if sig is None:
            return None
        try:
            from ..autotune import lookup

            hit = lookup(sig)
            if hit:
                return float(hit.get("calibration", 0.0)) or None
        except Exception:  # noqa: BLE001
            pass
        return None

    def record_calibration(self, state=None, key=None):
        """Write this program's measured/predicted factor into the
        autotune cache now.  Returns True when a write happened."""
        state = state or self.get(key)
        if state is None:
            return False
        ratio = state.step_ratio()
        if ratio is None:
            return False
        sig = self._signature(state.key)
        if sig is None:
            return False
        try:
            from ..autotune import record

            record(sig, {
                "calibration": round(ratio, 4),
                "measured_ms": round(state.measured_ms_ema, 4),
                "predicted_ms": round(state.predicted_step_ms, 4),
                "steps": state.measured_steps,
            })
        except Exception:  # noqa: BLE001 - cache write must not raise
            return False
        state._last_recorded_factor = ratio
        state._steps_since_record = 0
        _metrics.counter("drift_calibrations_recorded_total").inc()
        return True


_monitor = None
_monitor_lock = threading.Lock()


def monitor():
    """The process-wide drift monitor."""
    global _monitor
    if _monitor is None:
        with _monitor_lock:
            if _monitor is None:
                _monitor = DriftMonitor()
    return _monitor


def reset_drift():
    """Drop the singleton and cached gauge handles (test isolation)."""
    global _monitor
    with _monitor_lock:
        _monitor = None
    _RATIO_GAUGES.clear()
    _QUANT_GAUGES.clear()
