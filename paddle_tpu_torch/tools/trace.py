"""Trace reconstruction: ``python -m paddle_tpu_torch.tools.trace DIR``
(mirrors ``paddle_tpu/tools/trace.py``; the same ``--json`` output).

Merges every ``trace-r<rank>-<pid>.jsonl`` a job's processes wrote into
``PADDLE_TPU_TELEMETRY_DIR`` (torn-write tolerant, like the journal
reader), stitches the spans back into per-trace trees, and computes each
trace's *critical path* — the chain of spans that actually bounded its
wall time, attributed per phase::

    p99 request = 1.2ms serving.queue_wait + 0.3ms serving.pad
                + 4.1ms serving.device + 2.0ms serving.sync

Modes::

    python -m paddle_tpu_torch.tools.trace DIR            # slowest traces
    python -m paddle_tpu_torch.tools.trace DIR --slowest 10
    python -m paddle_tpu_torch.tools.trace DIR --id 3f2a  # one trace tree
    python -m paddle_tpu_torch.tools.trace DIR --serving  # phase p50/p99
    python -m paddle_tpu_torch.tools.trace DIR --elastic  # recovery story
    python -m paddle_tpu_torch.tools.trace DIR --flights  # postmortems
    python -m paddle_tpu_torch.tools.trace DIR --chrome out.json
    python -m paddle_tpu_torch.tools.trace DIR --serving \\
        --alert 'queue_wait_p99_ms>5'                    # exit 1 if hot

``--id`` accepts a trace-id prefix (the 8-char form the monitor and the
journal print is enough).  ``--elastic`` finds the trace that crossed a
worker-lost recovery and prints the chain — one trace covering
worker-lost→agree→replan→reshard→restore→resume across every surviving
rank (this package writes no elastic spans yet: the view reads them
from any directory that holds them).  ``--flights`` lists the flight
recorder's dumps, such as the watchdog's on a lost worker.
``--alert`` reuses the monitor's expression grammar against the
``--json`` fields of the selected view; exit codes 0 OK, 1 tripped,
2 no data.
"""

import argparse
import json
import sys
from collections import OrderedDict

from ..observability import tracing as _tracing

__all__ = ["group_traces", "trace_summary", "critical_path",
           "serving_stats", "elastic_traces", "main"]

#: cross-process wall clocks drift; child ends this close to (or past)
#: the parent cursor still count as on the critical path (seconds)
_CLOCK_SKEW_S = 5e-4

# span names whose presence marks a trace as an elastic-recovery story
_ELASTIC_MARKERS = ("elastic.recover", "elastic.replan", "elastic.reshard")


def _ts(rec):
    return float(rec.get("ts") or 0.0)


def _dur_s(rec):
    d = rec.get("dur_ms")
    return None if d is None else float(d) / 1000.0


def _end(rec):
    d = _dur_s(rec)
    return _ts(rec) + (d or 0.0)


def group_traces(records):
    """``{trace_id: [span records, ts-sorted]}`` in first-seen order."""
    traces = OrderedDict()
    for rec in records:
        tid = rec.get("trace")
        if tid:
            traces.setdefault(tid, []).append(rec)
    for spans in traces.values():
        spans.sort(key=_ts)
    return traces


def _index(spans):
    """(by_id, children) for one trace's records; duplicate span ids
    (a span record re-read from ring AND file) keep the first."""
    by_id, children = {}, {}
    for rec in spans:
        sid = rec.get("span")
        if sid and sid not in by_id:
            by_id[sid] = rec
    for rec in by_id.values():
        parent = rec.get("parent")
        if parent in by_id:
            children.setdefault(parent, []).append(rec)
    return by_id, children


def _roots(spans, by_id):
    return [rec for rec in by_id.values()
            if rec.get("parent") not in by_id]


def critical_path(spans):
    """The spans that bounded this trace's wall time, with the self-time
    each contributed.  Walks the tree backwards from the root's end:
    at every node the child ending latest (within clock skew) is on the
    path for its window, and whatever the children don't cover is the
    node's own time.  Returns ``[(record, self_ms)]`` in start order —
    their self-times sum to (about) the root duration."""
    by_id, children = _index(spans)
    closed_roots = [r for r in _roots(spans, by_id)
                    if _dur_s(r) is not None]
    if not closed_roots:
        return []
    root = max(closed_roots, key=lambda r: _dur_s(r) or 0.0)
    segments = []

    def walk(rec, window_hi):
        lo = _ts(rec)
        cursor = min(_end(rec), window_hi)
        self_s = 0.0
        kids = [k for k in children.get(rec["span"], ())
                if _dur_s(k) is not None and _end(k) > lo]
        kids.sort(key=_end, reverse=True)
        for kid in kids:
            if _end(kid) > cursor + _CLOCK_SKEW_S:
                continue  # concurrent sibling already covered
            self_s += max(cursor - _end(kid), 0.0)
            walk(kid, min(_end(kid), cursor))
            cursor = min(_ts(kid), cursor)
            if cursor <= lo:
                break
        self_s += max(cursor - lo, 0.0)
        segments.append((rec, self_s * 1000.0))

    walk(root, _end(root))
    # start order; an enclosing span starting at the same instant as
    # its child (queue_wait at t0 of the request) sorts first
    segments.sort(
        key=lambda seg: (_ts(seg[0]), -(_dur_s(seg[0]) or 0.0)))
    return segments


def _path_breakdown(segments):
    """Critical-path self-times pooled by span name, start order."""
    order, totals = [], {}
    for rec, self_ms in segments:
        name = rec.get("name", "?")
        if name not in totals:
            order.append(name)
            totals[name] = 0.0
        totals[name] += self_ms
    return [(name, totals[name]) for name in order]


def trace_summary(trace_id, spans):
    """One trace's headline dict (root, duration, ranks, worst status)."""
    by_id, _ = _index(spans)
    roots = _roots(spans, by_id)
    closed = [r for r in roots if _dur_s(r) is not None]
    root = (max(closed, key=lambda r: _dur_s(r) or 0.0) if closed
            else (roots[0] if roots else spans[0]))
    bad = sorted({r.get("status", "ok") for r in spans
                  if r.get("status", "ok") != "ok"})
    return {
        "trace": trace_id,
        "root": root.get("name", "?"),
        "dur_ms": root.get("dur_ms"),
        "spans": len(by_id),
        "ranks": sorted({r.get("rank", 0) for r in spans}),
        "status": bad[0] if bad else "ok",
    }


def _percentile(values, p):
    if not values:
        return None
    values = sorted(values)
    if len(values) == 1:
        return values[0]
    idx = max(p, 0.0) / 100.0 * (len(values) - 1)
    lo = int(idx)
    hi = min(lo + 1, len(values) - 1)
    return values[lo] + (idx - lo) * (values[hi] - values[lo])


def serving_stats(traces):
    """Aggregate serving.request traces: request latency and per-phase
    critical-path p50/p99 — the "where does the p99 go" answer."""
    durations, phases = [], {}
    for spans in traces.values():
        segments = critical_path(spans)
        if not segments or segments[0][0].get("name") != "serving.request":
            continue
        root = segments[0][0]
        if root.get("dur_ms") is None:
            continue
        durations.append(float(root["dur_ms"]))
        for name, self_ms in _path_breakdown(segments):
            phases.setdefault(name, []).append(self_ms)
    if not durations:
        return None
    stats = {"requests": len(durations),
             "request_p50_ms": _percentile(durations, 50.0),
             "request_p99_ms": _percentile(durations, 99.0),
             "phases": {}}
    for name, vals in sorted(phases.items()):
        stats["phases"][name] = {"p50_ms": _percentile(vals, 50.0),
                                 "p99_ms": _percentile(vals, 99.0)}
    # flat aliases so --alert 'queue_wait_p99_ms>5' just works
    for name, alias in (("serving.queue_wait", "queue_wait"),
                        ("serving.pad", "pad"),
                        ("serving.dispatch", "dispatch"),
                        ("serving.device", "device"),
                        ("serving.sync", "sync"),
                        # decode tenants: prompt ingest vs per-token
                        # generation — the TTFT / steady-state split
                        ("serving.prefill", "prefill"),
                        # disaggregated serving: finished-prefill ->
                        # decode-slot block handoff, the third TTFT leg
                        ("serving.kv_handoff", "kv_handoff"),
                        ("serving.decode", "decode")):
        if name in stats["phases"]:
            stats["%s_p50_ms" % alias] = stats["phases"][name]["p50_ms"]
            stats["%s_p99_ms" % alias] = stats["phases"][name]["p99_ms"]
    return stats


def elastic_traces(traces):
    """Traces that crossed a worker-lost recovery, slowest first."""
    out = []
    for tid, spans in traces.items():
        names = {r.get("name") for r in spans}
        if names.intersection(_ELASTIC_MARKERS):
            out.append((tid, spans))
    out.sort(key=lambda item: -(trace_summary(*item)["dur_ms"] or 0.0))
    return out


def _fmt_ms(v):
    return "-" if v is None else "%.3gms" % v


def _render_breakdown(segments, head):
    parts = ["%.3gms %s" % (ms, name)
             for name, ms in _path_breakdown(segments)]
    return "%s = %s" % (head, " + ".join(parts)) if parts else head


def _render_tree(spans, out):
    by_id, children = _index(spans)
    crit = {rec["span"] for rec, _ in critical_path(spans)}

    def show(rec, depth):
        mark = "*" if rec.get("span") in crit else " "
        status = rec.get("status", "ok")
        out.append("  %s%s%s r%s %s  %s%s" % (
            mark, "  " * depth, rec.get("name", "?"),
            rec.get("rank", 0), _fmt_ms(rec.get("dur_ms")),
            "" if status == "ok" else "[%s] " % status,
            "open " if rec.get("open") else ""))
        kids = sorted(children.get(rec.get("span"), ()), key=_ts)
        for kid in kids:
            show(kid, depth + 1)

    for root in sorted(_roots(spans, by_id), key=_ts):
        show(root, 0)


def _render_trace(tid, spans, out):
    info = trace_summary(tid, spans)
    out.append("trace %s  root=%s  %s  spans=%d  ranks=%s%s" % (
        tid[:16], info["root"], _fmt_ms(info["dur_ms"]), info["spans"],
        ",".join(str(r) for r in info["ranks"]),
        "" if info["status"] == "ok" else "  status=%s" % info["status"]))
    segments = critical_path(spans)
    if segments:
        out.append("  critical path: " + _render_breakdown(
            segments, "%s %s" % (info["root"],
                                 _fmt_ms(info["dur_ms"]))))
    _render_tree(spans, out)


def _elastic_report(traces, out):
    """The chaos acceptance view: ONE trace spanning the recovery."""
    found = elastic_traces(traces)
    if not found:
        out.append("no elastic-recovery trace found (no elastic.recover"
                   "/replan/reshard spans)")
        return None
    tid, spans = found[0]
    info = trace_summary(tid, spans)
    chain = [r for r in spans
             if r.get("name") in ("elastic.worker", "elastic.recover",
                                  "elastic.agree", "elastic.replan",
                                  "elastic.restore", "elastic.reshard")]
    chain.sort(key=_ts)
    out.append("elastic recovery trace %s  ranks=%s  spans=%d" % (
        tid, ",".join(str(r) for r in info["ranks"]), info["spans"]))
    seen = []
    for rec in chain:
        step = rec.get("attrs", {}).get("step")
        seen.append("%s(r%s%s)" % (
            rec.get("name", "?").replace("elastic.", ""),
            rec.get("rank", 0),
            "@%s" % step if step is not None else ""))
    out.append("  chain: " + " -> ".join(seen[:24])
               + (" ..." if len(seen) > 24 else ""))
    recs = [r for r in spans if r.get("name") == "elastic.recover"
            and r.get("dur_ms") is not None]
    if recs:
        rec = max(recs, key=lambda r: r["dur_ms"])
        # critical path over the recover span's own subtree, so a
        # post-recovery step can't masquerade as the root
        _, children = _index(spans)
        subtree, frontier = [], [rec]
        while frontier:
            node = frontier.pop()
            subtree.append(node)
            frontier.extend(children.get(node.get("span"), ()))
        segments = critical_path(subtree)
        out.append("  recovery critical path: " + _render_breakdown(
            segments, "recover %s" % _fmt_ms(rec["dur_ms"])))
    stats = {"trace": tid, "ranks": info["ranks"], "spans": info["spans"],
             "recover_ms": recs[0]["dur_ms"] if recs else None}
    return stats


def _flights_report(dirname, out):
    flights = _tracing.read_flight_records(dirname)
    if not flights:
        out.append("no flight records under %s" % dirname)
        return flights
    for rec in flights:
        out.append("flight r%s pid=%s  %s" % (
            rec.get("rank", "?"), rec.get("pid", "?"),
            rec.get("reason", "")))
        for span in rec.get("open_spans", []):
            out.append("  OPEN %s r%s %s  trace=%s" % (
                span.get("name", "?"), span.get("rank", 0),
                _fmt_ms(span.get("dur_ms")),
                str(span.get("trace"))[:8]))
        out.append("  recent: " + " -> ".join(
            s.get("name", "?")
            for s in rec.get("recent_spans", [])[-8:]))
    return flights


def _write_chrome(records, path):
    events = _tracing.spans_to_chrome_events(records)
    with open(path, "w") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms"}, f)
    return len(events)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.trace",
        description="reconstruct distributed traces from a "
                    "PADDLE_TPU_TELEMETRY_DIR")
    ap.add_argument("dir", help="telemetry dir (or one trace-*.jsonl)")
    ap.add_argument("--slowest", type=int, default=5, metavar="K",
                    help="how many traces to detail (default 5)")
    ap.add_argument("--id", default=None, metavar="TRACE",
                    help="show one trace (id prefix ok)")
    ap.add_argument("--serving", action="store_true",
                    help="aggregate serving.request phase breakdown")
    ap.add_argument("--elastic", action="store_true",
                    help="reconstruct the worker-lost recovery trace")
    ap.add_argument("--flights", action="store_true",
                    help="list flight-recorder postmortems")
    ap.add_argument("--chrome", default=None, metavar="OUT",
                    help="export all spans as a chrome://tracing file "
                         "(flow arrows across threads/ranks; load "
                         "alongside a profiler timeline)")
    ap.add_argument("--alert", action="append", default=[],
                    metavar="EXPR",
                    help="e.g. 'queue_wait_p99_ms>5' with --serving, "
                         "'recover_ms>5000' with --elastic; exit 1 "
                         "tripped, 2 no data (repeatable)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    args = ap.parse_args(argv)

    records = _tracing.read_traces(args.dir)
    traces = group_traces(records)
    out, stats = [], None

    if args.flights:
        flights = _flights_report(args.dir, out)
        stats = {"flights": len(flights)}
    elif args.serving:
        stats = serving_stats(traces)
        if stats is None:
            out.append("no closed serving.request traces under %s"
                       % args.dir)
        else:
            out.append("serving: %d requests  p50=%s  p99=%s" % (
                stats["requests"], _fmt_ms(stats["request_p50_ms"]),
                _fmt_ms(stats["request_p99_ms"])))
            parts = ["%s %s" % (_fmt_ms(v["p99_ms"]), name)
                     for name, v in stats["phases"].items()
                     if name != "serving.request"]
            out.append("  p99 request = " + " + ".join(parts))
    elif args.elastic:
        stats = _elastic_report(traces, out)
    elif args.id:
        matches = [tid for tid in traces if tid.startswith(args.id)]
        if not matches:
            out.append("no trace matching %r under %s"
                       % (args.id, args.dir))
        else:
            for tid in matches:
                _render_trace(tid, traces[tid], out)
            stats = trace_summary(matches[0], traces[matches[0]])
    else:
        out.append("%d spans, %d traces under %s"
                   % (len(records), len(traces), args.dir))
        ranked = sorted(
            traces.items(),
            key=lambda item: -(trace_summary(*item)["dur_ms"] or 0.0))
        for tid, spans in ranked[:max(args.slowest, 0)]:
            _render_trace(tid, spans, out)
        stats = {"spans": len(records), "traces": len(traces)}

    if args.chrome:
        n = _write_chrome(records, args.chrome)
        out.append("wrote %d chrome events to %s" % (n, args.chrome))

    if args.json:
        print(json.dumps(stats if stats is not None else {},
                         sort_keys=True, default=str))
    else:
        print("\n".join(out))

    code = 0
    for expr in args.alert:
        from .monitor import check_alert

        c, msg = check_alert(stats or {}, expr)
        print(msg, file=sys.stderr)
        code = max(code, c)
    if not args.alert and not records and not args.flights:
        print("no trace files under %s" % args.dir, file=sys.stderr)
        return 2
    return code


if __name__ == "__main__":
    sys.exit(main())
