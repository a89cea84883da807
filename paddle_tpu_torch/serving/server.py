"""Continuous-batching predictor server for batch and decode tenants.

Mirrors ``paddle_tpu/serving/server.py`` (``PredictorServer`` :191)::

      submit() ──► per-tenant queue ──► bucketer ──► in-flight dispatcher
      (bounded,      (deadline-sorted,   (pad to a     (run_async window of
       rejects)       sheds late work)    fixed set)    max_in_flight, then
                                                        fetch + slice out)

``submit`` validates a request against the program's ``need_check_feed``
marks at once, so a bad shape names the request id.  A dispatcher thread
coalesces one tenant's queued requests into a padded bucket
(:mod:`.buckets`), dispatches through the predictor's ``run_async`` and
keeps up to ``max_in_flight`` batches' fetch handles un-synced; the
oldest batch is read with ONE batched sync and each request gets its
rows.  Scheduling: round-robin over tenants, per-request SLA deadlines
with shedding at batch formation (``now + EMA(batch service) >
deadline``), a bounded queue that rejects with :class:`QueueFullError`.
A batch that fails fails only its requests; if the dispatcher thread
dies, every pending request fails with :class:`DispatcherCrashedError`,
the crash is journaled (``dispatcher-died``) with a flight-recorder dump,
and the server stays dead.

A :class:`~paddle_tpu_torch.serving.decode.DecodeEngine` tenant runs its
own slot scheduler instead of the padded-batch dispatcher (reference
:215-224): ``submit`` hands its prompt to the engine and returns the
engine's ``DecodeRequest``; ``start``/``close`` start and close the
engines too, and ``stats()`` adds theirs under ``"decode"`` (:753).

Guarantees enforced at construction (``verify=True``, the default):

* **Scope isolation** — co-resident tenants' programs (a disaggregated
  decode engine's prefill programs included) are proven scope-disjoint
  (:func:`~paddle_tpu_torch.static_analysis.concurrency.prove_scope_isolation`);
  a written overlap is a hard ``VerifyError`` before the server accepts
  any traffic.  Shared read-only names are allowed and recorded in
  ``placement_diags``.
* **Zero-sync hot loop** — each tenant's program is stamped
  ``_serving_hot_loop`` and must pass
  :func:`~paddle_tpu_torch.static_analysis.concurrency.verify_async_hot_path`
  at the configured in-flight depth; the per-tenant
  ``ZeroSyncCertificate`` is kept in ``certificates``.

Telemetry and tracing as the reference's (:419-697): per request a
``serving.request`` span (enqueue → respond) and ``serving.queue_wait``;
per batch ``serving.batch`` with ``serving.pad``, ``serving.dispatch``,
``serving.device`` (the wall time from dispatch to the start of the
sync, reconstructed afterwards: nothing waits for it) and
``serving.sync``; the ``serving_*`` counters, gauges and histograms of
:mod:`..observability.runtime`.
"""

import itertools
import threading
import time

import numpy as np

from .. import pipeline as pl
from ..executor import _check_feed_shapes
from ..observability import runtime as _obs
from ..observability import tracing as _tr
from ..static_analysis.diagnostics import Severity, format_diagnostics
from .buckets import ShapeBuckets
from .decode import DecodeEngine

__all__ = [
    "DeadlineExceededError",
    "DispatcherCrashedError",
    "PredictorServer",
    "QueueFullError",
    "Request",
    "ServerClosedError",
    "ServingError",
]


class ServingError(RuntimeError):
    pass


class QueueFullError(ServingError):
    """Backpressure: the bounded request queue rejected the submit."""


class ServerClosedError(ServingError):
    pass


class DeadlineExceededError(ServingError):
    """The request was shed: it could no longer meet its SLA deadline."""


class DispatcherCrashedError(ServingError):
    """The dispatcher thread died outside the per-batch guards.

    Every pending request (queued and in-flight) is failed with this
    error — a client blocked in :meth:`Request.result` gets a typed
    verdict, never a silent hang — and the server is dead: subsequent
    :meth:`PredictorServer.submit` calls raise it too.  The crash is
    journaled urgent as ``dispatcher-died``."""


class Request:
    """One enqueued inference request (a mini-batch of ``rows`` rows).

    ``result(timeout)`` blocks until completion and returns the list of
    fetch outputs sliced to this request's rows, or raises the error the
    request was failed with (shed, validation, executor error).
    """

    __slots__ = ("id", "tenant", "feed", "rows", "deadline", "enqueue_ts",
                 "sig", "seq", "_event", "_outputs", "_error",
                 "latency_ms", "queue_wait_ms", "span", "_qspan")

    def __init__(self, rid, tenant, feed, rows, deadline, sig, seq):
        self.id = rid
        self.tenant = tenant
        self.feed = feed
        self.rows = rows
        self.deadline = deadline
        self.enqueue_ts = time.time()
        self.sig = sig
        self.seq = seq
        self._event = threading.Event()
        self._outputs = None
        self._error = None
        self.latency_ms = None
        self.queue_wait_ms = None
        # request-lifecycle spans: span covers enqueue→respond and is
        # ended by whichever thread completes/fails the request; _qspan
        # covers enqueue→batch-formation (or shed)
        self.span = _tr.NULL_SPAN
        self._qspan = _tr.NULL_SPAN

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError("request %r not completed within %ss"
                               % (self.id, timeout))
        if self._error is not None:
            raise self._error
        return self._outputs

    # dispatcher-side completion
    def _complete(self, outputs):
        self._outputs = outputs
        self.latency_ms = (time.time() - self.enqueue_ts) * 1000.0
        self.span.set_attr("latency_ms", round(self.latency_ms, 3))
        self.span.end("ok")
        self._event.set()

    def _fail(self, exc):
        self._error = exc
        self.latency_ms = (time.time() - self.enqueue_ts) * 1000.0
        status = "%s:%s" % (
            "shed" if isinstance(exc, DeadlineExceededError)
            else "crash" if isinstance(exc, DispatcherCrashedError)
            else "error", type(exc).__name__)
        self._qspan.end(status)
        self.span.end(status)
        self._event.set()

    def __repr__(self):
        return "Request(id=%r, tenant=%r, rows=%d)" % (
            self.id, self.tenant, self.rows)


class _Tenant:
    __slots__ = ("name", "predictor", "queue", "est_ms", "feed_names")

    def __init__(self, name, predictor):
        self.name = name
        self.predictor = predictor
        self.queue = []          # Requests, ordered at batch formation
        self.est_ms = None       # EMA of batch service (dispatch→fetch)
        get = getattr(predictor, "get_input_names", None)
        self.feed_names = list(get()) if get is not None else None


class _InFlight:
    __slots__ = ("tenant", "requests", "offsets", "bucket", "handles",
                 "dispatch_ts", "span")

    def __init__(self, tenant, requests, offsets, bucket, handles,
                 dispatch_ts, span=_tr.NULL_SPAN):
        self.tenant = tenant
        self.requests = requests
        self.offsets = offsets
        self.bucket = bucket
        self.handles = handles
        self.dispatch_ts = dispatch_ts
        self.span = span  # serving.batch, ends after the batched sync


class PredictorServer:
    """Continuous-batching server over one or more
    :class:`~paddle_tpu_torch.inference.AnalysisPredictor`\\ s and
    :class:`~paddle_tpu_torch.serving.decode.DecodeEngine`\\ s.

    ``tenants``: ``{name: predictor or engine}`` (or a single predictor,
    served as tenant ``"default"``).  Each tenant keeps its own predictor
    (own Scope, own graph cache); the scope-overlap proof gates their
    co-residency in this process.
    """

    #: EMA smoothing for the per-tenant batch-service-time estimate
    EST_ALPHA = 0.3

    def __init__(self, tenants, max_in_flight=2, sla_ms=None,
                 queue_cap=256, buckets=None, bucket_cap=None,
                 verify=True, auto_start=True):
        if hasattr(tenants, "run_async") or hasattr(tenants, "program"):
            tenants = {"default": tenants}
        if not tenants:
            raise ValueError("PredictorServer needs at least one tenant")
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1, got %d"
                             % max_in_flight)
        # decode tenants run their own slot scheduler (continuous
        # batching over KV-cache blocks) instead of the padded-batch
        # dispatcher; they still go through the co-residency proof and
        # the zero-sync stamp below
        self._engines = {name: t for name, t in tenants.items()
                         if isinstance(t, DecodeEngine)}
        self._tenants = {name: _Tenant(name, pred)
                         for name, pred in tenants.items()
                         if not isinstance(pred, DecodeEngine)}
        self._order = list(self._tenants)   # round-robin order
        self._rr = 0
        self._max_in_flight = int(max_in_flight)
        self._sla_ms = sla_ms
        self._queue_cap = int(queue_cap)
        self.buckets = (buckets if isinstance(buckets, ShapeBuckets)
                        else ShapeBuckets(buckets, cap=bucket_cap))
        self._seq = itertools.count()
        self._cond = threading.Condition()
        self._running = False
        self._closed = False
        self._crashed = None
        self._thread = None
        self._inflight = []          # owned by the dispatcher thread
        self.dispatch_log = []       # (tenant, bucket, rows) — bounded
        self.stats_lock = threading.Lock()
        self._counts = {"submitted": 0, "completed": 0, "shed": 0,
                        "rejected": 0, "failed": 0}
        self._first_dispatch_ts = None
        self._last_complete_ts = None
        self.placement_diags = ()
        self.certificates = {}
        if verify:
            self._verify_placement()
        self._stamp_hot_loop(verify)
        if auto_start:
            self.start()

    # ------------------------------------------------------------------
    # construction-time gates
    # ------------------------------------------------------------------

    def _verify_placement(self):
        """The ``coresident`` scope-overlap proof: a written
        overlap between tenant programs is a hard error before any
        traffic; shared read-only names are advisory."""
        from ..static_analysis.concurrency import prove_scope_isolation
        from ..static_analysis.verifier import VerifyError

        programs = [t.predictor.program for t in self._tenants.values()]
        labels = list(self._tenants)
        # decode engines co-reside too: their step program names the
        # resident caches, so a cache-name collision between tenants is
        # caught here.  A disaggregated engine contributes ALL its
        # resident program families (prefill runs on its own thread
        # against the same scope) — the pool overlap between them is a
        # declared KV-block handoff, not an accidental collision
        for name, eng in self._engines.items():
            co = getattr(eng, "coresident_programs", None)
            if co is not None:
                for label, prog, _targets in co():
                    programs.append(prog)
                    labels.append(label)
            else:
                programs.append(eng.program)
                labels.append(name)
        if len(programs) < 2:
            return
        _fp, diags = prove_scope_isolation(programs, labels=labels)
        self.placement_diags = tuple(diags)
        errors = [d for d in diags if d.severity >= Severity.ERROR]
        if errors:
            raise VerifyError(format_diagnostics(
                diags,
                header="multi-tenant placement rejected "
                       "(scope-overlap proof failed)"))

    def _stamp_hot_loop(self, verify):
        """Stamp every tenant program as the serving hot loop (strict
        zero-sync promotion) at this in-flight depth, verify the async
        path, and keep the per-tenant zero-sync certificate."""
        from ..static_analysis.concurrency import (certify_zero_sync,
                                                   verify_async_hot_path)

        entries = []
        for t in self._tenants.values():
            prog = t.predictor.program
            targets = []
            get = getattr(t.predictor, "get_output_names", None)
            if get is not None:
                targets = list(get())
            entries.append((t.name, prog, targets))
        # a decode engine's hot loop is its step program — the one the
        # slot scheduler re-runs every generated token.  Disaggregated
        # engines also run their prefill programs concurrently, so
        # those get stamped + certified under "name.prefillL" labels
        for name, eng in self._engines.items():
            co = getattr(eng, "coresident_programs", None)
            if co is not None:
                entries.extend(co())
            else:
                entries.append((name, eng.program,
                                list(eng.get_output_names())))
        for name, prog, targets in entries:
            prog._serving_hot_loop = True
            prog._max_in_flight = max(
                self._max_in_flight,
                int(getattr(prog, "_max_in_flight", 1) or 1))
            if verify:
                verify_async_hot_path(prog, targets=targets,
                                      max_in_flight=self._max_in_flight,
                                      label="serving:%s" % name)
            self.certificates[name] = certify_zero_sync(
                prog, targets=targets, label="serving:%s" % name,
                max_in_flight=self._max_in_flight)

    # ------------------------------------------------------------------
    # client side
    # ------------------------------------------------------------------

    def _as_feed(self, tenant, inputs):
        as_feed = getattr(tenant.predictor, "_as_feed", None)
        if as_feed is not None:
            return as_feed(inputs)
        if isinstance(inputs, dict):
            return dict(inputs)
        names = tenant.feed_names or []
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        if len(inputs) != len(names):
            raise ValueError("expected %d inputs (%s), got %d"
                             % (len(names), names, len(inputs)))
        return dict(zip(names, inputs))

    def _validate(self, rid, tenant, feed):
        """Enqueue-time validation: every fed array must be batch-leading
        with one consistent row count <= the largest bucket, and must
        satisfy the program's ``need_check_feed`` declarations.  Errors
        name the request id — they never surface as a late step error."""
        rows = None
        for name, value in feed.items():
            arr = np.asarray(value)
            if arr is not value:
                feed[name] = arr
            if arr.ndim < 1:
                raise ValueError(
                    "request %r: feed %r is 0-d — continuous batching "
                    "requires every feed to carry the batch dim first"
                    % (rid, name))
            if rows is None:
                rows = int(arr.shape[0])
            elif int(arr.shape[0]) != rows:
                raise ValueError(
                    "request %r: inconsistent batch dims (%r has %d "
                    "rows, expected %d)" % (rid, name, arr.shape[0],
                                            rows))
        if not feed:
            raise ValueError("request %r: empty feed" % (rid,))
        if rows > self.buckets.max_rows:
            raise ValueError(
                "request %r: %d rows exceeds the largest bucket (%d) — "
                "split the request or widen the bucket set"
                % (rid, rows, self.buckets.max_rows))
        program = getattr(tenant.predictor, "program", None)
        if program is not None:
            try:
                _check_feed_shapes(program, feed)
            except ValueError as exc:
                raise ValueError("request %r: %s" % (rid, exc)) from None
        sig = tuple(sorted((n, tuple(v.shape[1:]), str(v.dtype))
                           for n, v in feed.items()))
        return rows, sig

    def submit(self, tenant, inputs, request_id=None, sla_ms=None):
        """Enqueue one request; returns the :class:`Request` future.

        Raises :class:`QueueFullError` when the bounded queue is full
        (backpressure — the caller decides whether to retry or fail the
        client), ``ValueError`` on a malformed feed (attributed to
        ``request_id``), :class:`ServerClosedError` after ``close``.
        """
        engine = self._engines.get(tenant)
        if engine is not None:
            # decode tenant: the engine's slot scheduler owns queueing,
            # admission, and completion — returns a DecodeRequest future
            with self._cond:
                if self._closed:
                    raise ServerClosedError("server is closed")
            return engine.submit(inputs, request_id=request_id)
        t = self._tenants.get(tenant)
        if t is None:
            raise KeyError("unknown tenant %r (have %s)"
                           % (tenant, list(self._tenants)
                              + list(self._engines)))
        seq = next(self._seq)
        rid = request_id if request_id is not None else seq
        feed = self._as_feed(t, inputs)
        rows, sig = self._validate(rid, t, feed)
        if sla_ms is None:
            sla_ms = self._sla_ms
        deadline = (time.time() + sla_ms / 1000.0
                    if sla_ms is not None else None)
        req = Request(rid, tenant, feed, rows, deadline, sig, seq)
        # root of the request's trace (enqueue→respond); joins the
        # caller's active trace when there is one
        req.span = _tr.start_span("serving.request", tenant=tenant,
                                  request_id=rid, rows=rows)
        req._qspan = _tr.start_span("serving.queue_wait",
                                    parent=req.span)
        with self._cond:
            if self._crashed is not None:
                req._qspan.end("crash:DispatcherCrashedError")
                req.span.end("crash:DispatcherCrashedError")
                raise DispatcherCrashedError(
                    "server is dead: dispatcher crashed (%s: %s)"
                    % (type(self._crashed).__name__, self._crashed))
            if self._closed:
                req._qspan.end("reject:ServerClosedError")
                req.span.end("reject:ServerClosedError")
                raise ServerClosedError("server is closed")
            depth = sum(len(x.queue) for x in self._tenants.values())
            if depth >= self._queue_cap:
                self._count("rejected")
                _obs.record_serving_reject()
                req._qspan.end("reject:QueueFullError")
                req.span.end("reject:QueueFullError")
                raise QueueFullError(
                    "queue full (%d queued, cap %d) — backpressure"
                    % (depth, self._queue_cap))
            t.queue.append(req)
            self._count("submitted")
            self._cond.notify()
        _obs.record_serving_request(tenant)
        _obs.set_serving_depths(depth + 1, len(self._inflight))
        return req

    # ------------------------------------------------------------------
    # dispatcher
    # ------------------------------------------------------------------

    def start(self):
        with self._cond:
            if self._crashed is not None:
                raise DispatcherCrashedError(
                    "server is dead: dispatcher crashed (%s: %s)"
                    % (type(self._crashed).__name__, self._crashed))
            if self._closed:
                raise ServerClosedError("server is closed")
            if self._running:
                return self
            self._running = True
        for engine in self._engines.values():
            engine.start()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="paddle_tpu_torch-serving")
        self._thread.start()
        return self

    def close(self, timeout=60.0):
        """Stop accepting work, drain queued + in-flight requests, join
        the dispatcher."""
        with self._cond:
            self._closed = True
            self._running = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        for engine in self._engines.values():
            engine.close(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _has_queued_locked(self):
        return any(t.queue for t in self._tenants.values())

    def _loop(self):
        try:
            self._dispatch_loop()
        except Exception as exc:  # noqa: BLE001 — last-resort net: the
            # per-batch guards in _dispatch_loop already contain
            # request-attributable failures; anything landing here is a
            # dispatcher bug and must not strand blocked clients
            self._dispatcher_crashed(exc)

    def _dispatcher_crashed(self, exc):
        with self._cond:
            self._crashed = exc
            self._closed = True
            self._running = False
            pending = []
            for t in self._tenants.values():
                pending.extend(t.queue)
                t.queue = []
            self._cond.notify_all()
        for entry in self._inflight:
            pending.extend(entry.requests)
            entry.span.end("crash:DispatcherCrashedError")
        self._inflight = []
        err = DispatcherCrashedError(
            "serving dispatcher thread crashed: %s: %s"
            % (type(exc).__name__, exc))
        err.__cause__ = exc
        to_fail = [r for r in pending if not r.done()]
        # journal + count BEFORE unblocking clients: whoever observes
        # the typed error can rely on the incident being on disk
        self._count("failed", len(to_fail))
        _obs.record_dispatcher_died(
            "%s: %s" % (type(exc).__name__, exc), len(to_fail),
            trace=next((r.span.trace_id for r in pending
                        if r.span.recording), None))
        for r in to_fail:
            r._fail(err)

    def _dispatch_loop(self):
        while True:
            picked = None
            with self._cond:
                while (self._running and not self._has_queued_locked()
                       and not self._inflight):
                    self._cond.wait(0.05)
                if (not self._running and not self._has_queued_locked()
                        and not self._inflight):
                    break
                if self._has_queued_locked():
                    picked = self._pick_batch_locked()
            if picked is None:
                if self._inflight:
                    self._complete_oldest()
                continue
            tenant, reqs = picked
            try:
                self._dispatch(tenant, reqs)
            except Exception as exc:  # noqa: BLE001 — fail the batch,
                for r in reqs:        # keep serving other requests
                    r._fail(exc)
                self._count("failed", len(reqs))
                continue
            while len(self._inflight) >= self._max_in_flight:
                self._complete_oldest()
        while self._inflight:
            self._complete_oldest()

    def _pick_batch_locked(self):
        """Round-robin over tenants with queued work; within the chosen
        tenant, shed unmeetable deadlines, order by (deadline, arrival)
        and coalesce same-signature requests up to the largest bucket."""
        n = len(self._order)
        for i in range(n):
            name = self._order[(self._rr + i) % n]
            t = self._tenants[name]
            if not t.queue:
                continue
            self._rr = (self._rr + i + 1) % n
            now = time.time()
            est_s = (t.est_ms / 1000.0) if t.est_ms else 0.0
            keep, shed = [], []
            for r in t.queue:
                if r.deadline is not None and now + est_s > r.deadline:
                    shed.append(r)
                else:
                    keep.append(r)
            for r in shed:
                r._fail(DeadlineExceededError(
                    "request %r shed: deadline cannot be met "
                    "(est batch service %.1fms)" % (r.id, t.est_ms or 0)))
                self._count("shed")
                _obs.record_serving_shed(name)
            keep.sort(key=lambda r: (
                r.deadline if r.deadline is not None else float("inf"),
                r.seq))
            if not keep:
                t.queue = []
                continue
            sig = keep[0].sig
            batch, rows, rest = [], 0, []
            for r in keep:
                if (r.sig == sig
                        and rows + r.rows <= self.buckets.max_rows):
                    batch.append(r)
                    rows += r.rows
                else:
                    rest.append(r)
            t.queue = rest
            formed = time.time()
            for r in batch:
                r.queue_wait_ms = (formed - r.enqueue_ts) * 1000.0
                r._qspan.end("ok")
                _obs.record_serving_queue_wait(name, r.queue_wait_ms)
            return t, batch
        return None

    def _dispatch(self, tenant, reqs):
        rows = sum(r.rows for r in reqs)
        bucket = self.buckets.bucket_for(rows)
        # the batch span parents to the first request's span and names
        # its coalesced siblings, so a trace walks request→batch even
        # when N requests share one device launch
        bspan = _tr.start_span(
            "serving.batch", parent=reqs[0].span, tenant=tenant.name,
            bucket=bucket, rows=rows, requests=len(reqs),
            coalesced=[r.span.span_id for r in reqs[1:]
                       if r.span.recording])
        try:
            with _tr.use_context(bspan.context):
                with _tr.span("serving.pad", bucket=bucket):
                    feed = {}
                    for name in reqs[0].feed:
                        feed[name] = (reqs[0].feed[name]
                                      if len(reqs) == 1
                                      else np.concatenate(
                                          [r.feed[name] for r in reqs],
                                          axis=0))
                    feed = self.buckets.pad_feed(feed, rows, bucket)
                offsets, off = [], 0
                for r in reqs:
                    offsets.append((off, off + r.rows))
                    off += r.rows
                now = time.time()
                if self._first_dispatch_ts is None:
                    self._first_dispatch_ts = now
                with _tr.span("serving.dispatch"):
                    handles = tenant.predictor.run_async(feed)
        except Exception as exc:  # noqa: BLE001 — terminal status, then
            bspan.end("error:%s" % type(exc).__name__)  # re-raised for
            raise                                 # the per-batch guard
        self._inflight.append(_InFlight(tenant, reqs, offsets, bucket,
                                        handles, now, span=bspan))
        if len(self.dispatch_log) < 4096:
            self.dispatch_log.append((tenant.name, bucket, rows))
        _obs.record_serving_batch(tenant.name, bucket, rows)
        with self._cond:
            depth = sum(len(x.queue) for x in self._tenants.values())
        _obs.set_serving_depths(depth, len(self._inflight))

    def _complete_oldest(self):
        entry = self._inflight.pop(0)
        sync_t0 = time.time()
        # the window dispatch→sync-start is device compute overlapped
        # with anything the dispatcher did meanwhile — attributed as a
        # retroactive child span of the batch
        _tr.start_span("serving.device", parent=entry.span,
                       start_ts=entry.dispatch_ts,
                       bucket=entry.bucket).end(
            dur_ms=(sync_t0 - entry.dispatch_ts) * 1000.0)
        sspan = _tr.start_span("serving.sync", parent=entry.span,
                               handles=len(entry.handles)
                               if hasattr(entry.handles, "__len__")
                               else 1)
        try:
            outputs = pl.materialize(entry.handles)
        except Exception as exc:  # noqa: BLE001
            sspan.end("error:%s" % type(exc).__name__)
            entry.span.end("error:%s" % type(exc).__name__)
            for r in entry.requests:
                r._fail(exc)
            self._count("failed", len(entry.requests))
            return
        sspan.end("ok")
        now = time.time()
        sync_ms = (now - sync_t0) * 1000.0
        _obs.record_serving_sync(entry.tenant.name, sync_ms)
        service_ms = (now - entry.dispatch_ts) * 1000.0
        t = entry.tenant
        t.est_ms = (service_ms if t.est_ms is None
                    else (1 - self.EST_ALPHA) * t.est_ms
                    + self.EST_ALPHA * service_ms)
        # the batch span ends before the request span it is the child
        # of: a trace's critical path walks only the children that end
        # by their parent's end (within the clock skew), so a batch that
        # ended after its first request, by the time the batch's other
        # requests took to complete, left the device out of that path
        entry.span.set_attr("service_ms", round(service_ms, 3))
        entry.span.end("ok")
        for r, (a, b) in zip(entry.requests, entry.offsets):
            r._complete(self.buckets.slice_rows(outputs, a, b,
                                                entry.bucket))
            _obs.record_serving_done(t.name, r.latency_ms)
        self._count("completed", len(entry.requests))
        self._last_complete_ts = now
        qps = self._qps_locked()
        if qps is not None:
            _obs.set_serving_throughput(qps)

    def _count(self, key, n=1):
        with self.stats_lock:
            self._counts[key] += n

    def _qps_locked(self):
        if (self._first_dispatch_ts is None
                or self._last_complete_ts is None):
            return None
        span = self._last_complete_ts - self._first_dispatch_ts
        if span <= 0:
            return None
        with self.stats_lock:
            done = self._counts["completed"]
        return done / span

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def warmup(self, sample_feeds):
        """Pre-compile every bucket signature: ``sample_feeds`` maps
        tenant name → a 1-row feed; each bucket size is run twice
        synchronously (the executor's eager warm-up, then the CUDA graph
        capture), so the serving loop only replays graphs and the graph
        cache is exactly one entry per bucket."""
        for name, feed in sample_feeds.items():
            t = self._tenants[name]
            feed = self._as_feed(t, feed)
            feed = {n: np.asarray(v) for n, v in feed.items()}
            for size in self.buckets.sizes:
                padded = self.buckets.pad_feed(feed, 1, size)
                for _ in range(2):
                    pl.materialize(t.predictor.run_async(padded))
        return self

    def stats(self):
        with self.stats_lock:
            counts = dict(self._counts)
        with self._cond:
            depth = sum(len(t.queue) for t in self._tenants.values())
        counts.update(
            queue_depth=depth,
            inflight=len(self._inflight),
            tenants=list(self._tenants),
            buckets=list(self.buckets.sizes),
            dispatches=len(self.dispatch_log),
            est_ms={n: t.est_ms for n, t in self._tenants.items()},
            qps=self._qps_locked(),
            shed_rate=(counts["shed"] / counts["submitted"]
                       if counts["submitted"] else 0.0),
            zero_sync={n: c.ok for n, c in self.certificates.items()},
        )
        if self._engines:
            counts["decode"] = {n: e.stats()
                                for n, e in self._engines.items()}
        return counts
