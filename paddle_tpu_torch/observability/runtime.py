"""Instrumentation hooks: the one-line calls the executor, the pipeline,
the serving dispatcher, the decode engine and the concurrency gates make
(mirrors ``paddle_tpu/observability/runtime.py`` :1-365, :442-450,
:560-685).

Centralizing the metric names and journal kinds here keeps the
instrumented files to single-line edits, and keeps the disabled path
uniform: every hook starts with the cached kill-switch check and
returns immediately when telemetry is off.  No hook reads the device.

A ``drift_key`` (the executor's, registered at a key's first call)
feeds the drift monitor (:mod:`.drift`).  The watchdog's two recorders
(``record_worker_lost``, ``record_missed_beat``) are ported with
``resilience.watchdog``.  Not ported yet: the guard, checkpoint,
elastic and speculative-decoding recorders, which wait for the modules
that call them.
"""

import os
import threading
import time

from . import journal as _journal
from . import metrics as _m
from . import tracing as _tracing
from .metrics import telemetry_enabled

__all__ = [
    "record_step", "record_jit_cache", "record_compile",
    "record_fusion_resolve", "record_feed_cache",
    "record_feed_cache_eviction", "record_sync",
    "record_prefetch", "record_serving_request", "record_serving_reject",
    "record_serving_shed", "record_serving_batch",
    "record_serving_done", "record_serving_queue_wait",
    "record_serving_sync", "set_serving_depths",
    "set_serving_throughput",
    "record_decode_tokens", "record_decode_request",
    "set_decode_throughput", "set_kv_pool", "record_kv_handoff",
    "record_decode_resize", "record_dispatcher_died",
    "record_concurrency_check", "record_worker_lost", "record_missed_beat",
    "set_collective_schedule", "collective_step_shape",
    "last_step_info", "reset_runtime",
]


def _trace_id(explicit=None):
    """Trace id to stamp on an urgent journal event: the caller's
    explicit id, else this thread's active trace (which falls back to
    the cross-process ``PADDLE_TPU_TRACEPARENT`` parent) — links the
    monitor's incident sequences to ``tools.trace --id``."""
    if explicit is not None:
        return explicit
    try:
        return _tracing.current_trace_id()
    except Exception:  # noqa: BLE001 - correlation must never raise
        return None

# latest step progress, consumed by the watchdog heartbeat payload so
# `tools/monitor` can tell a wedged-but-alive rank from a healthy one
_last_step = {"step": None, "step_ms": None, "ts": None}
_last_step_lock = threading.Lock()

# per-step collective totals of the last compiled program:
# [(launches_counter, payload_counter, launches, payload_bytes)]
# (counter handles pre-resolved at schedule install, off the step path)
_collective_per_step = []

# hot-path metric handles, resolved once per series: the registry's
# get-or-create pays a sorted-label key build plus a lock per call,
# which is real money at per-step rates.  Populated only while enabled;
# reset_runtime() clears them (reset_telemetry() resets the registry
# too, so a stale handle can never outlive its series).
_step_handles = {}
_jit_handles = {}
_named_handles = {}


def _step_h(runner):
    h = _step_handles.get(runner)
    if h is None:
        h = (_m.counter("steps_total", runner=runner),
             _m.histogram("step_wall_ms", runner=runner),
             _m.histogram("step_dispatch_ms", runner=runner))
        _step_handles[runner] = h
    return h


def _named(factory, name):
    m = _named_handles.get(name)
    if m is None:
        m = factory(name)
        _named_handles[name] = m
    return m


_env_cache = {}


def _env_int(name, default):
    v = _env_cache.get(name)
    if v is None:
        try:
            v = int(os.environ.get(name, default))
        except ValueError:
            v = default
        _env_cache[name] = v
    return v


def _step_event_every():
    """Journal ``step`` events are SAMPLED (default every 10th step):
    they exist for the monitor's rate/latency view, which step numbers
    make exact anyway, and a per-step JSONL append would be the single
    biggest line item in the <2% overhead budget.  Set
    ``PADDLE_TPU_TELEMETRY_STEP_EVERY=1`` for full per-step fidelity."""
    return max(_env_int("PADDLE_TPU_TELEMETRY_STEP_EVERY", 10), 1)


_snapshot_state = {"steps": 0, "last_write": 0.0}


def _maybe_write_snapshot():
    """Refresh ``metrics-r<rank>-<pid>.json`` in the telemetry dir —
    the gauge/histogram side of what the monitor CLI reads (the journal
    carries the events).  Double-throttled: every
    ``PADDLE_TPU_TELEMETRY_SNAPSHOT_EVERY`` steps AND at least
    ``PADDLE_TPU_TELEMETRY_SNAPSHOT_SECS`` apart (the first write is
    exempt so short runs still leave a snapshot)."""
    j = _journal.get_journal()  # its dir is pinned at creation — no
    if j.path is None:          # per-step env read on the hot path
        return
    _snapshot_state["steps"] += 1
    if _snapshot_state["steps"] \
            % max(_env_int("PADDLE_TPU_TELEMETRY_SNAPSHOT_EVERY", 25),
                  1) != 1:
        return
    now = time.time()
    if _snapshot_state["last_write"] and (
            now - _snapshot_state["last_write"]
            < _env_int("PADDLE_TPU_TELEMETRY_SNAPSHOT_SECS", 2)):
        return
    _snapshot_state["last_write"] = now
    from .exporters import write_metrics_snapshot

    write_metrics_snapshot(os.path.join(
        os.path.dirname(j.path),
        "metrics-r%d-%d.json" % (j.rank, os.getpid())))


# ---------------------------------------------------------------------------
# executor / SPMD runner
# ---------------------------------------------------------------------------

def record_step(runner, step, wall_ms, dispatch_ms=None,
                drift_key=None):
    """One completed training/inference step."""
    if not telemetry_enabled():
        return
    steps_c, wall_h, disp_h = _step_h(runner)
    steps_c.inc()
    wall_h.observe(wall_ms)
    if dispatch_ms is not None:
        disp_h.observe(dispatch_ms)
    with _last_step_lock:
        _last_step["step"] = step
        _last_step["step_ms"] = wall_ms
        _last_step["ts"] = time.time()
    for launches_c, payload_c, launches, payload in _collective_per_step:
        launches_c.inc(launches)
        payload_c.inc(payload)
    ev = _step_event_every()
    if ev == 1 or steps_c.value % ev == 1:
        _journal.emit("step", runner=runner, step=step,
                      wall_ms=round(wall_ms, 4),
                      dispatch_ms=None if dispatch_ms is None
                      else round(dispatch_ms, 4))
    if drift_key is not None:
        from . import drift as _drift

        _drift.monitor().observe_step(wall_ms, key=drift_key, step=step)
    _maybe_write_snapshot()


def record_jit_cache(hit, runner="executor"):
    if not telemetry_enabled():
        return
    key = (runner, bool(hit))
    c = _jit_handles.get(key)
    if c is None:
        c = _m.counter("jit_cache_hits_total" if hit
                       else "jit_cache_misses_total", runner=runner)
        _jit_handles[key] = c
    c.inc()


def record_compile(ms, runner="executor"):
    if not telemetry_enabled():
        return
    _m.histogram("compile_ms", runner=runner).observe(ms)
    _journal.emit("compile", runner=runner, compile_ms=round(ms, 2))


def record_fusion_resolve(hit):
    if not telemetry_enabled():
        return
    _named(_m.counter,
           "fusion_resolve_cache_hits_total" if hit
           else "fusion_resolve_cache_misses_total").inc()


# ---------------------------------------------------------------------------
# async pipeline
# ---------------------------------------------------------------------------

def record_feed_cache(hit):
    if not telemetry_enabled():
        return
    _named(_m.counter,
           "feed_cache_hits_total" if hit
           else "feed_cache_misses_total").inc()


def record_feed_cache_eviction(n=1):
    """LRU eviction(s) from the bounded feed placement cache."""
    if not telemetry_enabled():
        return
    _named(_m.counter, "feed_cache_evictions_total").inc(n)


def record_sync(wait_ms, handles=1):
    """One batched device->host sync drained ``handles`` handles."""
    if not telemetry_enabled():
        return
    _named(_m.counter, "host_syncs_total").inc()
    _named(_m.counter, "host_sync_handles_total").inc(handles)
    _named(_m.histogram, "host_sync_wait_ms").observe(wait_ms)


def record_prefetch(depth, capacity):
    """Prefetch queue occupancy observed at a consumer get()."""
    if not telemetry_enabled():
        return
    _named(_m.counter, "prefetch_gets_total").inc()
    _named(_m.gauge, "prefetch_queue_depth").set(depth)
    if capacity:
        _named(_m.gauge, "prefetch_occupancy").set(
            depth / float(capacity))


# ---------------------------------------------------------------------------
# serving (paddle_tpu/serving — the continuous-batching server)
# ---------------------------------------------------------------------------

def record_serving_request(tenant):
    if not telemetry_enabled():
        return
    _m.counter("serving_requests_total", tenant=tenant).inc()


def record_serving_reject():
    """Backpressure rejection (bounded queue full)."""
    if not telemetry_enabled():
        return
    _named(_m.counter, "serving_rejected_total").inc()


def record_serving_shed(tenant):
    """SLA priority eviction: a request shed before dispatch."""
    if not telemetry_enabled():
        return
    _m.counter("serving_shed_total", tenant=tenant).inc()
    _journal.emit("request-shed", tenant=tenant)


def record_serving_batch(tenant, bucket, rows):
    """One coalesced batch dispatched: occupancy = real rows over the
    padded bucket size (1.0 means no padding waste)."""
    if not telemetry_enabled():
        return
    _m.counter("serving_batches_total", tenant=tenant).inc()
    _named(_m.counter, "serving_rows_total").inc(rows)
    _named(_m.counter, "serving_padded_rows_total").inc(bucket - rows)
    _named(_m.gauge, "serving_batch_occupancy").set(
        rows / float(bucket) if bucket else 0.0)


def record_serving_done(tenant, latency_ms):
    """One request completed (enqueue→result latency)."""
    if not telemetry_enabled():
        return
    _m.counter("serving_completed_total", tenant=tenant).inc()
    _named(_m.histogram, "serving_latency_ms").observe(latency_ms)


def record_serving_queue_wait(tenant, wait_ms):
    """Enqueue→batch-formation wait of one request (the queue_wait
    span's interval) — the histogram shedding decisions are diagnosed
    from."""
    if not telemetry_enabled():
        return
    _named(_m.histogram, "serving_queue_wait_ms").observe(wait_ms)


def record_serving_sync(tenant, sync_ms):
    """One batched materialize (the serving.sync span's interval)."""
    if not telemetry_enabled():
        return
    _named(_m.histogram, "serving_sync_ms").observe(sync_ms)


def set_serving_depths(queued, inflight):
    if not telemetry_enabled():
        return
    _named(_m.gauge, "serving_queue_depth").set(queued)
    _named(_m.gauge, "serving_inflight_depth").set(inflight)


def set_serving_throughput(qps):
    if not telemetry_enabled():
        return
    _named(_m.gauge, "serving_throughput_qps").set(qps)


def record_decode_tokens(tenant, n):
    """``n`` tokens generated this decode step across a tenant's active
    slots (the autoregressive analogue of serving_rows_total)."""
    if not telemetry_enabled():
        return
    _m.counter("serving_decode_tokens_total", tenant=tenant).inc(n)


def record_decode_request(tenant, generated_len, ttft_ms=None):
    """One generation request finished: its generated length (the
    per-request histogram capacity planning reads) and, when known, its
    time-to-first-token."""
    if not telemetry_enabled():
        return
    _named(_m.histogram, "serving_generated_len").observe(generated_len)
    if ttft_ms is not None:
        _named(_m.histogram, "serving_ttft_ms").observe(ttft_ms)


def set_decode_throughput(tokens_per_sec):
    if not telemetry_enabled():
        return
    _named(_m.gauge, "decode_tokens_per_sec").set(tokens_per_sec)


def set_kv_pool(tenant, total, free):
    """Paged-KV pool state after an allocate/free: the capacity-
    planning gauges ``tools.monitor`` renders, plus the occupancy
    ratio the ``--alert 'kv_pool_occupancy>0.9'`` predicate watches
    (high occupancy means admissions are about to backpressure)."""
    if not telemetry_enabled():
        return
    _m.gauge("kv_blocks_total", tenant=tenant).set(total)
    _m.gauge("kv_blocks_free", tenant=tenant).set(free)
    occ = 1.0 - free / float(total) if total else 0.0
    _m.gauge("kv_pool_occupancy", tenant=tenant).set(occ)


def record_kv_handoff(tenant, wait_ms, blocks):
    """One prefill->decode KV-block handoff (disaggregated serving):
    how long the finished prefill waited for a decode slot, and how
    many pool blocks changed owner without a copy."""
    if not telemetry_enabled():
        return
    _m.counter("serving_kv_handoffs_total", tenant=tenant).inc()
    _m.counter("serving_kv_handoff_blocks_total",
               tenant=tenant).inc(blocks)
    _named(_m.histogram, "serving_kv_handoff_wait_ms").observe(wait_ms)


# ---------------------------------------------------------------------------
# serving dispatcher + static gates
# ---------------------------------------------------------------------------

def record_decode_resize(tenant, old_slots, new_slots):
    """A DecodeEngine drained and rebuilt its KV-cache slots at a new
    count (autoscaler serving surface)."""
    if not telemetry_enabled():
        return
    _named(_m.counter, "decode_resizes_total").inc()
    _m.gauge("decode_slots", tenant=str(tenant)).set(int(new_slots))
    _journal.emit("autoscale", action="resize-slots",
                  reason="decode tenant %s: %d -> %d slots"
                         % (tenant, old_slots, new_slots),
                  world=None, target_world=None,
                  evidence={"tenant": str(tenant),
                            "old_slots": int(old_slots),
                            "new_slots": int(new_slots)},
                  trace=_trace_id())


def record_dispatcher_died(reason, failed_requests, trace=None):
    """The serving dispatcher thread crashed: every pending request was
    failed with a typed error instead of stranding callers."""
    if not telemetry_enabled():
        return
    _named(_m.counter, "serving_dispatcher_crashes_total").inc()
    _journal.emit("dispatcher-died", reason=str(reason)[:200],
                  failed_requests=int(failed_requests),
                  trace=_trace_id(trace))
    _tracing.flight_dump("dispatcher-died: %s" % str(reason)[:200])


def record_worker_lost(ranks, reason="", trace=None):
    """A worker-loss verdict of the watchdog: counted, journaled as an
    urgent ``worker-lost`` event and a flight-recorder dump."""
    if not telemetry_enabled():
        return
    _m.counter("workers_lost_total").inc(max(len(ranks), 1))
    _journal.emit("worker-lost", ranks=list(ranks), reason=reason,
                  trace=_trace_id(trace))
    _tracing.flight_dump("worker-lost: ranks=%s %s" % (list(ranks),
                                                       reason))


def record_missed_beat(ranks):
    if not telemetry_enabled():
        return
    _m.counter("watchdog_missed_beats_total").inc(max(len(ranks), 1))


def record_concurrency_check(races_found, gate, tripped=False):
    """One run of the concurrency analyzer: ``gate`` names the
    caller (``analyze``, ``run_batches``, a rewrite-bracket context).
    A finding at an enforcing gate journals an URGENT ``race-detected``
    event so the monitor's incident sequence shows the tripped gate."""
    if not telemetry_enabled():
        return
    _named(lambda n: _m.counter(n), "concurrency_checks_total").inc()
    if races_found:
        _named(lambda n: _m.counter(n), "races_found_total").inc(
            races_found)
        _journal.emit("race-detected", races=int(races_found),
                      gate=str(gate), tripped=bool(tripped),
                      trace=_trace_id())


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

_DTYPE_BYTES = {
    "float64": 8, "int64": 8, "uint64": 8,
    "float32": 4, "int32": 4, "uint32": 4,
    "float16": 2, "bfloat16": 2, "int16": 2, "uint16": 2,
    "int8": 1, "uint8": 1, "bool": 1,
}


def _dtype_bytes(dtype):
    """Bytes per element of a program dtype string (the reference's
    ``static_analysis/cost.py`` ``dtype_bytes``; 4 when unknown)."""
    return _DTYPE_BYTES.get(str(dtype), 4)


def set_collective_schedule(schedule, drift_key=None):
    """Install the compiled program's extracted per-ring schedule:
    gauges for the per-step shape, and the per-step totals the step
    hook turns into running counters.  ``schedule`` is
    ``{ring_id: [CollectiveEvent]}``."""
    global _collective_per_step
    if not telemetry_enabled():
        return
    per_step = []
    total_bytes = 0
    for ring, events in (schedule or {}).items():
        label = str(ring)
        payload = sum(int(e.numel) * _dtype_bytes(e.dtype)
                      for e in events)
        per_step.append((
            _m.counter("collective_launches_total", ring=label),
            _m.counter("collective_payload_bytes_total", ring=label),
            len(events), payload))
        total_bytes += payload
        _m.gauge("collective_launches_per_step", ring=label).set(
            len(events))
        _m.gauge("collective_payload_bytes_per_step", ring=label).set(
            payload)
    _collective_per_step = per_step
    if drift_key is not None and schedule:
        from . import drift as _drift

        _drift.monitor().observe_scheduled_ici(total_bytes, key=drift_key)


def collective_step_shape():
    """The installed schedule's per-ring per-step shape as span attrs:
    ``{"ring:<label>": "<launches>x/<payload_bytes>B"}`` (empty when no
    schedule is installed) — what the step span carries so a trace
    shows each step's collective launches without per-launch spans."""
    out = {}
    for launches_c, _payload_c, launches, payload in _collective_per_step:
        ring = dict(getattr(launches_c, "labels", ())).get("ring", "?")
        out["ring:%s" % ring] = "%dx/%dB" % (launches, payload)
    return out


# ---------------------------------------------------------------------------
# watchdog payload
# ---------------------------------------------------------------------------

def last_step_info():
    """``{"step": ..., "step_ms": ..., "ts": ...}`` of the newest
    completed step (None fields before the first) — what heartbeats
    embed so the monitor can flag a wedged-but-alive rank."""
    with _last_step_lock:
        return dict(_last_step)


def reset_runtime():
    """Clear cross-step state and cached handles (test isolation)."""
    global _collective_per_step
    with _last_step_lock:
        _last_step.update(step=None, step_ms=None, ts=None)
    _collective_per_step = []
    _snapshot_state.update(steps=0, last_write=0.0)
    _step_handles.clear()
    _jit_handles.clear()
    _named_handles.clear()
    _env_cache.clear()
