"""Distributed tracing: cross-thread / cross-process spans and a flight
recorder for hangs (mirrors ``paddle_tpu/observability/tracing.py``, all
of it).

A span is one timed unit of work (``trace_id``/``span_id``/``parent_id``,
wall start + monotonic duration, attributes, a terminal status).  Spans
form trees within a process, and one trace crosses threads (the serving
dispatcher, a disaggregated decode engine's prefill worker, the
:class:`~paddle_tpu_torch.pipeline.DeviceFeedPipeline` staging thread)
through :func:`capture_context` / :func:`use_context`, and processes
through a *traceparent* string (``PADDLE_TPU_TRACEPARENT``).

Write discipline mirrors :mod:`.journal`: a bounded in-memory ring of
closed spans, buffered JSONL appends into ``PADDLE_TPU_TELEMETRY_DIR`` as
``trace-r<rank>-<pid>.jsonl`` (flushed every
``PADDLE_TPU_TELEMETRY_FLUSH`` spans; error-status spans flush at once)
and a torn-line-tolerant reader (:func:`read_traces`).
``PADDLE_TPU_TRACING=0`` is the kill switch: every ``span()`` call
degrades to one cached boolean check returning a shared null stub.  No
span reads the device: a span's duration is host wall time.

Flight recorder: the tracer knows the last N closed spans and every
open span per thread; :func:`flight_dump` writes that state as
``flight-r<rank>-<pid>-<n>.json`` (the serving dispatcher's crash hook
calls it).
"""

import atexit
import json
import os
import threading
import time
from collections import deque, namedtuple

from .journal import _rank, journal_dir
from .metrics import _FALSY

__all__ = [
    "SCHEMA_VERSION", "TRACEPARENT_ENV", "SpanContext", "Span",
    "Tracer", "get_tracer", "reset_tracing", "tracing_enabled",
    "set_tracing_enabled", "set_rank", "span", "start_span",
    "span_if_traced", "sample_step", "step_sample_every",
    "current_span",
    "current_context", "current_trace_id", "current_traceparent",
    "capture_context", "use_context", "parse_traceparent",
    "format_traceparent", "inject_env", "remote_parent",
    "set_remote_parent", "flight_dump", "read_traces",
    "read_flight_records", "spans_to_chrome_events",
    "fused_op_sources", "NULL_SPAN",
]

SCHEMA_VERSION = 1

#: env var carrying a W3C-style traceparent into child processes
TRACEPARENT_ENV = "PADDLE_TPU_TRACEPARENT"

_DEFAULT_RING = 1024
_DEFAULT_FLUSH_EVERY = 32

# ---------------------------------------------------------------------------
# kill switch (the metrics.py discipline: lazy env read, cached bool)
# ---------------------------------------------------------------------------

_enabled = None
_enabled_lock = threading.Lock()


def tracing_enabled():
    """True unless ``PADDLE_TPU_TRACING`` is set falsy or
    :func:`set_tracing_enabled` said otherwise."""
    global _enabled
    if _enabled is None:
        with _enabled_lock:
            if _enabled is None:
                _enabled = os.environ.get(
                    "PADDLE_TPU_TRACING", "1").strip().lower() \
                    not in _FALSY
    return _enabled


def set_tracing_enabled(on):
    """Force the kill switch on/off in-process (bench A/B, tests).
    ``None`` re-arms the lazy env read."""
    global _enabled
    with _enabled_lock:
        _enabled = None if on is None else bool(on)


# ---------------------------------------------------------------------------
# ids + traceparent
# ---------------------------------------------------------------------------

SpanContext = namedtuple("SpanContext", ["trace_id", "span_id"])

# span ids: a per-process random prefix + counter is collision-safe
# across processes and ~10x cheaper than urandom per span (span
# creation sits on the executor's per-step hot path).  Trace ids take the
# same form at 16 bytes (an 8-byte random prefix and a 64-bit counter)
# and the process id is read once and again in a forked child: the
# reference draws a trace id from urandom for every root span and reads
# os.getpid() twice for every span, and both are system calls, which
# some hosts make cost tens of µs inside a busy serving loop (PERF.md §6)
_id_lock = threading.Lock()
_id_prefix = None
_trace_prefix = None
_id_counter = 0
_pid = os.getpid()


def _after_fork():
    global _pid, _id_prefix, _trace_prefix
    _pid = os.getpid()
    _id_prefix = _trace_prefix = None  # fresh prefixes in the child


os.register_at_fork(after_in_child=_after_fork)


def _new_id(nbytes=8):
    if nbytes not in (8, 16):
        return os.urandom(nbytes).hex()
    global _id_prefix, _trace_prefix, _id_counter
    with _id_lock:
        if _id_prefix is None:
            _id_prefix = os.urandom(4).hex()
            _trace_prefix = os.urandom(8).hex()
        _id_counter += 1
        n = _id_counter
    if nbytes == 16:
        return "%s%016x" % (_trace_prefix, n)
    return "%s%08x" % (_id_prefix, n & 0xFFFFFFFF)


def new_trace_context():
    """A fresh root context (e.g. a driver minting the trace its child
    processes will all join)."""
    return SpanContext(trace_id=_new_id(16), span_id=_new_id(8))


def format_traceparent(ctx):
    """``00-<trace_id>-<span_id>-01`` (W3C-traceparent shaped)."""
    if ctx is None:
        return None
    return "00-%s-%s-01" % (ctx.trace_id, ctx.span_id)


def parse_traceparent(value):
    """Tolerant parse; returns :class:`SpanContext` or None — a torn or
    foreign header must never break the instrumented path."""
    if not value or not isinstance(value, str):
        return None
    parts = value.strip().split("-")
    if len(parts) < 3:
        return None
    trace_id, span_id = parts[1], parts[2]
    if not trace_id or not span_id:
        return None
    try:
        int(trace_id, 16)
        int(span_id, 16)
    except ValueError:
        return None
    return SpanContext(trace_id=trace_id, span_id=span_id)


# remote parent: the cross-process ambient context this process was
# born with (PADDLE_TPU_TRACEPARENT) or adopted from a peer's record
_remote = {"parsed": False, "ctx": None}
_remote_lock = threading.Lock()


def remote_parent():
    """The ambient cross-process parent context, or None.  Parsed once
    from ``PADDLE_TPU_TRACEPARENT`` unless overridden by
    :func:`set_remote_parent`."""
    if not _remote["parsed"]:
        with _remote_lock:
            if not _remote["parsed"]:
                _remote["ctx"] = parse_traceparent(
                    os.environ.get(TRACEPARENT_ENV))
                _remote["parsed"] = True
    return _remote["ctx"]


def set_remote_parent(value):
    """Adopt a traceparent (string or :class:`SpanContext`) received
    from a peer — e.g. out of a membership record or a reshard
    manifest — as this process's ambient parent.  ``None`` re-arms the
    lazy env read."""
    with _remote_lock:
        if value is None:
            _remote["parsed"] = False
            _remote["ctx"] = None
        else:
            _remote["ctx"] = (value if isinstance(value, SpanContext)
                              else parse_traceparent(value))
            _remote["parsed"] = True


def inject_env(env):
    """Stamp the current traceparent into an env dict for a child
    process (chaos drivers, multiprocess harnesses).  Returns ``env``."""
    tp = current_traceparent()
    if tp:
        env[TRACEPARENT_ENV] = tp
    return env


# ---------------------------------------------------------------------------
# thread-local context stack
# ---------------------------------------------------------------------------

_tls = threading.local()


def _stack():
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _thread_name():
    name = getattr(_tls, "name", None)
    if name is None:
        name = _tls.name = threading.current_thread().name
    return name


def current_span():
    """Innermost ACTIVE span on this thread (not a bare attached
    context), or None."""
    for entry in reversed(_stack()):
        if isinstance(entry, Span):
            return entry
    return None


def current_context():
    """The context a new span on this thread would parent to: the
    innermost active span or attached context, else the cross-process
    remote parent, else None."""
    stack = _stack()
    if stack:
        top = stack[-1]
        return top.context if isinstance(top, Span) else top
    return remote_parent()


def current_trace_id():
    """Active trace id on this thread (for journal correlation), or
    None."""
    ctx = current_context()
    return ctx.trace_id if ctx is not None else None


def current_traceparent():
    """Formatted traceparent of the current context, or None."""
    return format_traceparent(current_context())


def capture_context():
    """Snapshot the current context for hand-off to another thread
    (pair with :func:`use_context` over there)."""
    return current_context()


class use_context:
    """Attach a captured :class:`SpanContext` on this thread: spans
    started inside parent to it.  ``None`` is a no-op (so call sites
    need no conditional)."""

    __slots__ = ("_ctx", "_pushed")

    def __init__(self, ctx):
        self._ctx = ctx
        self._pushed = False

    def __enter__(self):
        if self._ctx is not None:
            _stack().append(self._ctx)
            self._pushed = True
        return self._ctx

    def __exit__(self, *exc):
        if self._pushed:
            stack = _stack()
            if stack and stack[-1] is self._ctx:
                stack.pop()
            elif self._ctx in stack:
                stack.remove(self._ctx)
        return False


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class _NullSpan:
    """Shared do-nothing stub returned when tracing is killed — the
    instrumented path pays one cached boolean check and nothing else."""

    __slots__ = ()
    recording = False
    trace_id = span_id = parent_id = None
    context = None
    traceparent = None

    def set_attr(self, key, value):
        return self

    def set_status(self, status):
        return self

    def end(self, status=None, dur_ms=None):
        # dur_ms too: the serving path ends retroactive spans with it
        # whether tracing is on or off
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class Span:
    """One timed unit of work.  Use as a context manager (activates on
    the current thread) or hold it and call :meth:`end` explicitly — a
    serving request span lives across threads that way."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "attrs",
                 "status", "start_ts", "dur_ms", "rank", "thread",
                 "_t0", "_tracer", "_ended", "_active")

    recording = True

    def __init__(self, name, trace_id, parent_id, tracer, attrs=None,
                 start_ts=None):
        self.name = str(name)
        self.trace_id = trace_id
        self.span_id = _new_id(8)
        self.parent_id = parent_id
        self.attrs = dict(attrs) if attrs else {}
        self.status = "ok"
        self.start_ts = time.time() if start_ts is None else start_ts
        self._t0 = time.perf_counter()
        self.dur_ms = None
        self.rank = tracer.rank
        self.thread = _thread_name()
        self._tracer = tracer
        self._ended = False
        self._active = False
        tracer._on_start(self)

    @property
    def context(self):
        return SpanContext(trace_id=self.trace_id, span_id=self.span_id)

    @property
    def traceparent(self):
        return format_traceparent(self.context)

    def set_attr(self, key, value):
        self.attrs[key] = value
        return self

    def set_status(self, status):
        self.status = str(status)
        return self

    def end(self, status=None, dur_ms=None):
        """Close the span (idempotent); duration is monotonic unless
        ``dur_ms`` overrides it (retroactive spans reconstructed from
        measured windows, e.g. device-compute between dispatch and
        sync)."""
        if self._ended:
            return self
        self._ended = True
        if status is not None:
            self.status = str(status)
        self.dur_ms = (float(dur_ms) if dur_ms is not None
                       else (time.perf_counter() - self._t0) * 1000.0)
        self._tracer._on_end(self)
        return self

    def to_record(self):
        rec = {"schema": SCHEMA_VERSION, "kind": "span",
               "ts": self.start_ts, "rank": self.rank,
               "pid": _pid, "thread": self.thread,
               "trace": self.trace_id, "span": self.span_id,
               "parent": self.parent_id, "name": self.name,
               "dur_ms": (None if self.dur_ms is None
                          else round(self.dur_ms, 4)),
               "status": self.status}
        if self.attrs:
            rec["attrs"] = self.attrs
        return rec

    # context-manager protocol: activate on this thread
    def __enter__(self):
        _stack().append(self)
        self._active = True
        return self

    def __exit__(self, exc_type, exc, tb):
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        self._active = False
        if exc_type is not None and self.status == "ok":
            self.status = "error:%s" % exc_type.__name__
        self.end()
        return False

    def __repr__(self):
        return "Span(%s trace=%s span=%s %s)" % (
            self.name, self.trace_id, self.span_id,
            "open" if not self._ended else "%.3fms" % (self.dur_ms or 0))


def _resolve_parent(parent):
    """Accept a Span, SpanContext, traceparent string, or None."""
    if parent is None:
        return current_context()
    if isinstance(parent, Span):
        return parent.context
    if isinstance(parent, SpanContext):
        return parent
    if isinstance(parent, str):
        return parse_traceparent(parent)
    return None


def start_span(name, parent=None, start_ts=None, **attrs):
    """Create a span WITHOUT activating it on this thread (hold it
    across threads; call ``.end()`` when done).  ``parent`` may be a
    Span, :class:`SpanContext` or traceparent string; defaults to the
    current context (new trace root when there is none).  ``start_ts``
    backdates the wall-clock start (retroactive spans)."""
    if not tracing_enabled():
        return NULL_SPAN
    ctx = _resolve_parent(parent)
    if ctx is None:
        trace_id, parent_id = _new_id(16), None
    else:
        trace_id, parent_id = ctx.trace_id, ctx.span_id
    return Span(name, trace_id, parent_id, get_tracer(), attrs=attrs,
                start_ts=start_ts)


def span(name, parent=None, start_ts=None, **attrs):
    """The instrumentation one-liner: ``with tracing.span("x"): ...``.
    Same as :func:`start_span`; returned object is a context manager
    that activates the span on this thread for its body."""
    return start_span(name, parent=parent, start_ts=start_ts, **attrs)


# ---------------------------------------------------------------------------
# step sampling: full fidelity inside a trace, 1-of-N standalone
# ---------------------------------------------------------------------------

_SAMPLE_ENV = "PADDLE_TPU_TRACE_SAMPLE"
_DEFAULT_SAMPLE_EVERY = 16

_sample_every = None


def step_sample_every():
    """``PADDLE_TPU_TRACE_SAMPLE`` (cached): record 1-of-N standalone
    step traces.  1 = every step, 0 = none."""
    global _sample_every
    if _sample_every is None:
        try:
            _sample_every = max(0, int(os.environ.get(
                _SAMPLE_ENV, _DEFAULT_SAMPLE_EVERY)))
        except ValueError:
            _sample_every = _DEFAULT_SAMPLE_EVERY
    return _sample_every


def sample_step(step):
    """Should this step's phase spans record?  A step already inside a
    trace — a serving request, an elastic worker joined via traceparent,
    any enclosing user span — ALWAYS records (those traces are the
    product).  A standalone training loop would mint a fresh root trace
    per step, which is where tracing overhead lives, so it records
    1-of-N (:func:`step_sample_every`) — enough that the trace dir
    still shows representative step-phase breakdowns."""
    if not tracing_enabled():
        return False
    if current_context() is not None:
        return True
    n = step_sample_every()
    if n <= 1:
        return n == 1
    try:
        return int(step) % n == 0
    except (TypeError, ValueError):
        return True


def span_if_traced(name, **attrs):
    """A span only when it joins an existing trace; NULL_SPAN when it
    would start a fresh root.  Interior step phases (dispatch, host
    sync) use this so the root-level :func:`sample_step` decision gates
    the whole subtree."""
    if not tracing_enabled() or current_context() is None:
        return NULL_SPAN
    return span(name, **attrs)


# ---------------------------------------------------------------------------
# the tracer: ring + JSONL writer + flight recorder (journal discipline)
# ---------------------------------------------------------------------------

class Tracer:
    """One process's closed-span ring + JSONL writer + open-span
    registry.  Thread-safe."""

    def __init__(self, dirname=None, capacity=None, flush_every=None,
                 rank=None):
        self.dirname = dirname
        self.rank = _rank() if rank is None else int(rank)
        if capacity is None:
            try:
                capacity = int(os.environ.get(
                    "PADDLE_TPU_TRACE_RING", _DEFAULT_RING))
            except ValueError:
                capacity = _DEFAULT_RING
        if flush_every is None:
            try:
                flush_every = int(os.environ.get(
                    "PADDLE_TPU_TELEMETRY_FLUSH", _DEFAULT_FLUSH_EVERY))
            except ValueError:
                flush_every = _DEFAULT_FLUSH_EVERY
        self.flush_every = max(int(flush_every), 1)
        self._ring = deque(maxlen=max(int(capacity), 1))
        self._pending = []
        self._open = {}
        self._lock = threading.Lock()
        self._flight_seq = 0
        self._path = None
        if dirname:
            os.makedirs(dirname, exist_ok=True)
            self._path = os.path.join(
                dirname, "trace-r%d-%d.jsonl" % (self.rank, os.getpid()))

    @property
    def path(self):
        return self._path

    def _on_start(self, s):
        with self._lock:
            self._open[s.span_id] = s

    def _on_end(self, s):
        record = s.to_record()
        with self._lock:
            self._open.pop(s.span_id, None)
            self._ring.append(record)
            if self._path is not None:
                self._pending.append(record)
                # error/shed/crash terminals are the spans a dying
                # process must not lose — the journal's URGENT rule
                if (len(self._pending) >= self.flush_every
                        or s.status != "ok"):
                    self._flush_locked()

    def records(self):
        """Closed-span ring contents (oldest first)."""
        with self._lock:
            return list(self._ring)

    def open_spans(self):
        """Snapshot of every currently-open span's record (duration =
        time open so far)."""
        now = time.perf_counter()
        with self._lock:
            spans = list(self._open.values())
        out = []
        for s in spans:
            rec = s.to_record()
            rec["open"] = True
            rec["dur_ms"] = round((now - s._t0) * 1000.0, 4)
            out.append(rec)
        return out

    def _flush_locked(self):
        if not self._pending or self._path is None:
            return
        # compact, unsorted: the torn-tolerant reader doesn't care and
        # this encode runs on the span hot path's flush amortization
        lines = "".join(
            json.dumps(r, separators=(",", ":"), default=str) + "\n"
            for r in self._pending)
        self._pending = []
        try:
            with open(self._path, "a") as f:
                f.write(lines)
        except OSError:
            pass  # shared-fs hiccup: the ring still has the spans

    def flush(self):
        with self._lock:
            self._flush_locked()

    def close(self):
        self.flush()

    def flight_record(self, reason):
        """The in-memory postmortem: every open span (what each thread
        is inside RIGHT NOW) plus the last-N closed spans."""
        return {"schema": SCHEMA_VERSION, "kind": "flight",
                "ts": time.time(), "rank": self.rank,
                "pid": os.getpid(), "reason": str(reason)[:500],
                "open_spans": self.open_spans(),
                "recent_spans": self.records()}

    def dump_flight(self, reason, dirname=None):
        """Write the flight record as ``flight-r<rank>-<pid>-<n>.json``
        (atomic tmp+rename); returns the path, or None without a dir."""
        dirname = dirname or self.dirname or journal_dir()
        if not dirname:
            return None
        with self._lock:
            self._flight_seq += 1
            seq = self._flight_seq
            self._flush_locked()
        path = os.path.join(dirname, "flight-r%d-%d-%d.json"
                            % (self.rank, os.getpid(), seq))
        tmp = "%s.tmp.%d" % (path, os.getpid())
        try:
            os.makedirs(dirname, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(self.flight_record(reason), f, sort_keys=True,
                          default=str)
            os.replace(tmp, path)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            return None
        return path

    def __len__(self):
        return len(self._ring)


_tracer = None
_tracer_lock = threading.Lock()


def get_tracer():
    """The process-wide tracer (created on first use; its directory is
    whatever ``PADDLE_TPU_TELEMETRY_DIR`` said at that moment)."""
    global _tracer
    if _tracer is None:
        with _tracer_lock:
            if _tracer is None:
                t = Tracer(dirname=journal_dir())
                atexit.register(t.close)
                _tracer = t
    return _tracer


def set_rank(rank):
    """Stamp subsequent spans with this rank.  For launchers that carry
    rank out-of-band (the elastic trainer's ``--rank`` argument) instead
    of the ``PADDLE_TRAINER_ID`` env the tracer reads at creation."""
    get_tracer().rank = int(rank)


def flight_dump(reason, dirname=None):
    """Dump the flight record for a fatal condition (worker lost,
    dispatcher crash, guard abort).  No-op (None) when tracing is
    killed or no tracer exists yet — a postmortem hook must never add a
    second failure."""
    if not tracing_enabled():
        return None
    try:
        return get_tracer().dump_flight(reason, dirname=dirname)
    except Exception:  # noqa: BLE001 - last-resort hook
        return None


def reset_tracing():
    """Drop the singleton + context state so the next span re-reads the
    env (test isolation)."""
    global _tracer
    with _tracer_lock:
        t, _tracer = _tracer, None
    if t is not None:
        t.close()
    set_tracing_enabled(None)
    set_remote_parent(None)
    global _sample_every
    _sample_every = None
    stack = getattr(_tls, "stack", None)
    if stack:
        del stack[:]


# ---------------------------------------------------------------------------
# readers (torn-line tolerant, the journal discipline)
# ---------------------------------------------------------------------------

def _parse_line(line):
    line = line.strip()
    if not line:
        return None
    try:
        rec = json.loads(line)
    except ValueError:
        return None  # torn trailing write from a killed process
    if not isinstance(rec, dict) or "span" not in rec:
        return None
    try:
        if int(rec.get("schema", 0)) > SCHEMA_VERSION:
            return None  # a future writer; this reader can't vouch
    except (TypeError, ValueError):
        return None
    return rec


def read_traces(path):
    """Parse one ``trace-*.jsonl`` file or every one in a directory,
    merged in timestamp order.  Unparseable lines (torn writes) and
    unknown-schema records are skipped, never raised."""
    paths = []
    if os.path.isdir(path):
        for name in sorted(os.listdir(path)):
            if name.startswith("trace-") and name.endswith(".jsonl"):
                paths.append(os.path.join(path, name))
    elif os.path.exists(path):
        paths.append(path)
    records = []
    for p in paths:
        try:
            with open(p) as f:
                for line in f:
                    rec = _parse_line(line)
                    if rec is not None:
                        records.append(rec)
        except OSError:
            continue
    records.sort(key=lambda r: r.get("ts", 0.0))
    return records


def read_flight_records(path):
    """Every parseable ``flight-*.json`` under a directory (or one
    file), newest first."""
    paths = []
    if os.path.isdir(path):
        for name in sorted(os.listdir(path)):
            if name.startswith("flight-") and name.endswith(".json"):
                paths.append(os.path.join(path, name))
    elif os.path.exists(path):
        paths.append(path)
    out = []
    for p in paths:
        try:
            with open(p) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(rec, dict):
            out.append(rec)
    out.sort(key=lambda r: r.get("ts", 0.0), reverse=True)
    return out


# ---------------------------------------------------------------------------
# chrome-trace conversion (what the reference's profiler export and
# trace CLI read)
# ---------------------------------------------------------------------------

def spans_to_chrome_events(records, flow=True):
    """Convert span records into chrome://tracing events: one ``X``
    (complete) event per closed span on pid ``rank<r>`` / tid = thread
    name, timestamps in wall-clock µs (so per-rank files merge on one
    axis), plus ``s``/``f`` flow arrows for every parent→child edge
    that crosses a thread or process — the causality the flat host and
    device streams can't show."""
    events = []
    by_id = {}
    for r in records:
        sid = r.get("span")
        if sid:
            by_id[sid] = r

    def _pid(r):
        return "rank%s" % r.get("rank", 0)

    pids = set()
    for r in records:
        if r.get("dur_ms") is None or r.get("ts") is None:
            continue
        ts_us = float(r["ts"]) * 1e6
        pid = _pid(r)
        pids.add(pid)
        attrs = dict(r.get("attrs") or {})
        attrs["trace"] = r.get("trace")
        attrs["status"] = r.get("status", "ok")
        events.append({
            "name": r.get("name", "?"), "cat": "span", "ph": "X",
            "pid": pid, "tid": r.get("thread", "main"),
            "ts": ts_us, "dur": max(float(r["dur_ms"]) * 1000.0, 0.1),
            "args": attrs,
        })
        parent = by_id.get(r.get("parent"))
        if (flow and parent is not None
                and parent.get("ts") is not None
                and (parent.get("thread") != r.get("thread")
                     or parent.get("pid") != r.get("pid")
                     or parent.get("rank") != r.get("rank"))):
            fid = "%s/%s" % (r.get("trace"), r.get("span"))
            events.append({
                "name": "span-link", "cat": "span", "ph": "s",
                "id": fid, "pid": _pid(parent),
                "tid": parent.get("thread", "main"),
                "ts": float(parent["ts"]) * 1e6,
            })
            events.append({
                "name": "span-link", "cat": "span", "ph": "f",
                "bp": "e", "id": fid, "pid": pid,
                "tid": r.get("thread", "main"), "ts": ts_us,
            })
    for pid in sorted(pids):
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": "spans:%s" % pid}})
    return events


# ---------------------------------------------------------------------------
# fused-op attribution (reuses the compiler's __fwd_op_id__ breadcrumbs)
# ---------------------------------------------------------------------------

def fused_op_sources(program):
    """Map each fused op in ``program`` back to its source ops: fusion
    rewrites replace N source ops with one ``fused_*`` op but stamp
    ``__fwd_op_id__`` (backward.py / fusion.py), so a device-trace row
    named after the fused kernel can be attributed to the Program ops
    it absorbed.  Returns ``[{"idx", "op", "fwd_op_id", "sources"}]``
    — ``sources`` are the op types in the program sharing that forward
    id (empty when the breadcrumb is missing)."""
    try:
        ops = list(program.global_block().ops)
    except Exception:  # noqa: BLE001 - attribution is best-effort
        return []
    by_fwd_id = {}
    for op in ops:
        fid = op.attrs.get("__op_id__")
        if fid is not None:
            by_fwd_id.setdefault(fid, []).append(op.type)
    out = []
    for i, op in enumerate(ops):
        if not op.type.startswith("fused_"):
            continue
        fid = op.attrs.get("__fwd_op_id__", op.attrs.get("__op_id__"))
        sources = [t for t in by_fwd_id.get(fid, [])
                   if t != op.type]
        out.append({"idx": i, "op": op.type, "fwd_op_id": fid,
                    "sources": sources})
    return out
