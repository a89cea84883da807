"""Live telemetry monitor: ``python -m paddle_tpu_torch.tools.monitor
DIR`` (mirrors ``paddle_tpu/tools/monitor.py``; the same ``--json``
fields and alert grammar).

Tails a ``PADDLE_TPU_TELEMETRY_DIR`` written by a running (or finished)
job and reports the operator view: step progress and rate, p50/p99 step
latency, predicted-vs-measured drift, the serving and decode tenants'
latency, throughput and KV-pool figures, and per-rank liveness —
including the wedged-but-alive case where heartbeats stay fresh but the
step counter inside them froze.

Everything is read-only and torn-write tolerant: journals via
:func:`~paddle_tpu_torch.observability.journal.read_journal` (skips torn
lines), metrics via the atomic ``metrics-r*.json`` snapshots, liveness
via :func:`~paddle_tpu_torch.resilience.watchdog.read_heartbeat`.
Fields whose writers this package does not have yet — the NaN-guard
skip rate, the checkpoint age, ``quant_error``, the elastic membership
and the autoscaler's decisions — read as absent (``null``), as they do
for any directory without those records; they are never made up.

Modes::

    python -m paddle_tpu_torch.tools.monitor DIR               # live tail
    python -m paddle_tpu_torch.tools.monitor DIR --once        # one report
    python -m paddle_tpu_torch.tools.monitor DIR --once --json
    python -m paddle_tpu_torch.tools.monitor DIR --once \\
        --alert 'p99_step_ms>50'                          # exit 1 if hot

Alert expressions are ``<field><op><number>`` with op one of
``> >= < <= == !=`` against any numeric field of the ``--json`` output
(dotted paths allowed, e.g. ``drift.step_ms``).  Exit codes: 0 OK, 1
alert tripped, 2 no data for the alerted field (or an empty dir).
"""

import argparse
import json
import os
import re
import sys
import time

__all__ = ["collect_status", "check_alert", "main"]

#: a heartbeat older than this many seconds marks the rank dead
DEFAULT_STALE_S = 15.0
#: fresh beats but no step progress for this long marks the rank wedged
DEFAULT_WEDGE_S = 30.0

_HB_RE = re.compile(r"^hb-(\d+)$")
_ALERT_RE = re.compile(
    r"^\s*([A-Za-z_][\w.]*)\s*(>=|<=|==|!=|>|<)\s*(-?[\d.]+)\s*$")

# the journal kinds an incident reads as a story, in the order the
# chaos acceptance scenarios expect them: fault -> skip -> restore, the
# elastic shrink chain worker-lost -> replan -> reshard -> resume, and
# the grow chain join-request -> admitted -> warmup -> replan ->
# reshard -> resume (race-detected: a concurrency gate tripped before
# dispatch; dispatcher-died: the serving dispatch thread crashed;
# autoscale: an SLO-policy decision)
_SEQUENCE_KINDS = ("fault-injected", "guard-skip", "race-detected",
                   "dispatcher-died", "worker-lost", "replan",
                   "reshard", "checkpoint-saved",
                   "checkpoint-loaded", "join-request", "admitted",
                   "warmup", "autoscale", "resume")

_MEMBER_RE = re.compile(r"^member-(\d{8})\.json$")
_JOIN_RE = re.compile(r"^join-(\d{8})-r(\d+)\.json$")


def _elastic_fs_view(hb_dir, ranks):
    """Elastic membership read straight off the rendezvous dir: the
    newest ``member-*`` record's epoch/world, plus how many *live*
    non-member ranks have a join request posted at (or past) it.  A
    dead job's leftovers still render — gauges need a live snapshot,
    files do not."""
    try:
        names = os.listdir(hb_dir)
    except OSError:
        return {}
    epochs = [int(m.group(1))
              for m in (_MEMBER_RE.match(n) for n in names) if m]
    joins = [(int(m.group(1)), int(m.group(2)))
             for m in (_JOIN_RE.match(n) for n in names) if m]
    if not epochs and not joins:
        return {}
    out = {}
    members = set()
    if epochs:
        newest = max(epochs)
        out["epoch"] = newest
        try:
            with open(os.path.join(
                    hb_dir, "member-%08d.json" % newest)) as f:
                rec = json.load(f)
            members = set(rec.get("members") or [])
            out["world"] = len(members) or None
        except (OSError, ValueError):
            pass  # torn write: epoch still stands, world unknown
    floor = max(epochs) if epochs else 0
    pending = set()
    for epoch, rank in joins:
        if epoch < floor or rank in members:
            continue
        r = ranks.get(str(rank))
        if r is not None and r["alive"] and not r["done"]:
            pending.add(rank)
    out["pending"] = len(pending)
    return out


def _read_snapshots(dirname):
    """Newest-first list of parsed ``metrics-r*.json`` snapshots."""
    snaps = []
    try:
        names = os.listdir(dirname)
    except OSError:
        return []
    for name in names:
        if not (name.startswith("metrics-r") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(dirname, name)) as f:
                snap = json.load(f)
        except (OSError, ValueError):
            continue  # torn/raced write: the next refresh will have it
        if isinstance(snap, dict) and isinstance(snap.get("metrics"),
                                                 dict):
            snaps.append(snap)
    snaps.sort(key=lambda s: s.get("ts", 0.0), reverse=True)
    return snaps


def _merged_metrics(snaps):
    """Merge per-process snapshots: counters sum, gauges take the
    newest writer's value, histograms pool buckets/sums/counts."""
    merged = {}
    for snap in snaps:  # newest first: first writer wins for gauges
        for key, m in snap["metrics"].items():
            kind = m.get("type")
            have = merged.get(key)
            if have is None:
                merged[key] = dict(m)
            elif kind == "counter":
                have["value"] = have.get("value", 0) + m.get("value", 0)
            elif kind == "histogram":
                have["count"] = have.get("count", 0) + m.get("count", 0)
                have["sum"] = have.get("sum", 0.0) + m.get("sum", 0.0)
                if len(have.get("counts", [])) == len(m.get("counts", [])):
                    have["counts"] = [a + b for a, b in
                                      zip(have["counts"], m["counts"])]
                for f, pick in (("min", min), ("max", max)):
                    if m.get(f) is not None:
                        have[f] = (m[f] if have.get(f) is None
                                   else pick(have[f], m[f]))
    return merged


def _hist_percentile(h, p):
    """Monitor-grade percentile from a merged histogram dict (same
    linear interpolation as ``Histogram.percentile``)."""
    count = h.get("count", 0)
    if not count:
        return None
    target = max(p, 0.0) / 100.0 * count
    buckets, counts = h.get("buckets", []), h.get("counts", [])
    cum, lo = 0, 0.0
    for ub, c in zip(buckets, counts):
        if cum + c >= target and c > 0:
            frac = (target - cum) / c
            est = lo + frac * (ub - lo)
            hi = h.get("max")
            return min(est, hi) if hi is not None else est
        cum += c
        lo = ub
    return h.get("max")


def _metric_value(merged, name, labels=None):
    """Sum of matching counter/gauge series (exact-name series plus any
    labeled series of the name); None when absent."""
    total, seen = 0.0, False
    for key, m in merged.items():
        base = key.split("{", 1)[0]
        if base != name:
            continue
        if labels and not all(
                '%s="%s"' % (k, v) in key for k, v in labels.items()):
            continue
        total += float(m.get("value", 0.0))
        seen = True
    return total if seen else None


def _metric_max(merged, name):
    """Max over matching gauge series — for per-bucket gauges (e.g.
    ``quant_error``) where the alert should watch the WORST bucket, not
    the sum of all of them; None when absent."""
    worst = None
    for key, m in merged.items():
        if key.split("{", 1)[0] != name:
            continue
        v = float(m.get("value", 0.0))
        worst = v if worst is None else max(worst, v)
    return worst


def _merged_histogram(merged, name):
    """All series of histogram ``name`` pooled into one dict."""
    out = None
    for key, m in merged.items():
        if key.split("{", 1)[0] != name or m.get("type") != "histogram":
            continue
        if out is None:
            out = dict(m)
            out["counts"] = list(m.get("counts", []))
        else:
            out["count"] += m.get("count", 0)
            out["sum"] += m.get("sum", 0.0)
            if len(out["counts"]) == len(m.get("counts", [])):
                out["counts"] = [a + b for a, b in
                                 zip(out["counts"], m["counts"])]
            for f, pick in (("min", min), ("max", max)):
                if m.get(f) is not None:
                    out[f] = (m[f] if out.get(f) is None
                              else pick(out[f], m[f]))
    return out


def _read_ranks(hb_dir, now, stale_after, wedge_after):
    """Per-rank liveness from ``hb-<rank>`` heartbeat files."""
    from ..resilience.watchdog import read_heartbeat

    ranks = {}
    try:
        names = os.listdir(hb_dir)
    except OSError:
        return ranks
    for name in names:
        match = _HB_RE.match(name)
        if not match:
            continue
        rank = int(match.group(1))
        hb = read_heartbeat(hb_dir, rank)
        if hb is None:
            continue
        done = os.path.exists(os.path.join(hb_dir, name + ".done"))
        age = now - hb["mtime"]
        alive = done or age <= stale_after
        # fresh beats with a frozen step counter: the daemon heartbeat
        # thread outlives a worker wedged inside a collective — exactly
        # the silent-hang case the watchdog layer documents
        step_ts = hb.get("step_ts")
        wedged = bool(alive and not done and step_ts is not None
                      and now - step_ts > wedge_after)
        ranks[str(rank)] = {
            "alive": bool(alive),
            "done": bool(done),
            "beat_age_s": round(age, 2),
            "step": hb.get("step"),
            "step_ms": hb.get("step_ms"),
            "wedged": wedged,
        }
    return ranks


def collect_status(dirname, hb_dir=None, now=None,
                   stale_after=DEFAULT_STALE_S,
                   wedge_after=DEFAULT_WEDGE_S):
    """One read of the telemetry dir -> the status dict ``--json``
    prints.  Missing inputs yield None fields, never a raise."""
    from ..observability.journal import read_journal

    now = time.time() if now is None else now
    events = read_journal(dirname)
    merged = _merged_metrics(_read_snapshots(dirname))
    ranks = _read_ranks(hb_dir or dirname, now, stale_after, wedge_after)

    step_events = [e for e in events if e.get("kind") == "step"]
    steps = None
    if step_events:
        nums = [e["step"] for e in step_events
                if isinstance(e.get("step"), (int, float))]
        steps = int(max(nums)) if nums else len(step_events)
    elif _metric_value(merged, "steps_total") is not None:
        steps = int(_metric_value(merged, "steps_total"))

    step_rate = None
    if len(step_events) >= 2:
        span = step_events[-1].get("ts", 0) - step_events[0].get("ts", 0)
        if span > 0:
            step_rate = round((len(step_events) - 1) / span, 3)

    wall = _merged_histogram(merged, "step_wall_ms")
    p50 = p99 = None
    if wall is None and step_events:
        # no snapshot yet (short run): fall back to the journaled steps
        ms = sorted(e["wall_ms"] for e in step_events
                    if isinstance(e.get("wall_ms"), (int, float)))
        if ms:
            p50 = ms[min(len(ms) // 2, len(ms) - 1)]
            p99 = ms[min(int(len(ms) * 0.99), len(ms) - 1)]
    elif wall is not None:
        p50 = _hist_percentile(wall, 50)
        p99 = _hist_percentile(wall, 99)

    guard_total = _metric_value(merged, "guard_steps_total")
    guard_skips = _metric_value(merged, "guard_skips_total")
    journal_skips = sum(1 for e in events
                        if e.get("kind") == "guard-skip")
    if guard_skips is None and journal_skips:
        guard_skips = float(journal_skips)
    skip_rate = None
    if guard_total:
        skip_rate = round((guard_skips or 0.0) / guard_total, 4)

    drift = {}
    for kind in ("step_ms", "peak_hbm", "ici_bytes"):
        v = _metric_value(merged, "drift_ratio", labels={"kind": kind})
        if v is not None:
            drift[kind] = round(v, 4)
    if not drift:
        # journal fallback: the periodic drift events carry the ratios
        for e in reversed(events):
            if e.get("kind") == "drift" \
                    and isinstance(e.get("ratios"), dict):
                for kind, v in e["ratios"].items():
                    if isinstance(v, (int, float)):
                        drift[kind] = round(float(v), 4)
                break

    # per-tier wire bytes (static_analysis/hierarchy + the topology
    # tree): predicted ICI vs DCN traffic of the registered programs —
    # a hierarchical plan shows its slow-tier cut here, a flat plan on
    # a multi-slice spec shows every gradient byte riding DCN
    tier_bytes = {}
    for tier in ("ici", "dcn", "pod"):
        v = _metric_value(merged, "predicted_tier_bytes",
                          labels={"tier": tier})
        if v is not None:
            tier_bytes[tier] = int(v)

    # quantized-collective health (the quant subsystem): worst per-bucket
    # measured relative error and its drift against the blockwise error
    # model — the '--alert quant_error>0.05' production gate
    quant_err = _metric_max(merged, "quant_error")
    quant_ratio = _metric_max(merged, "quant_error_ratio")

    ckpt_ts = _metric_value(merged, "checkpoint_last_save_ts")
    if not ckpt_ts:
        saved = [e for e in events if e.get("kind") == "checkpoint-saved"]
        ckpt_ts = saved[-1].get("ts") if saved else None
    checkpoint_age_s = (round(now - ckpt_ts, 2)
                        if ckpt_ts else None)

    # serving view (serving/): latency percentiles from the
    # pooled serving_latency_ms histogram, throughput/depth gauges, and
    # the shed rate (SLA evictions over submitted requests)
    srv_lat = _merged_histogram(merged, "serving_latency_ms")
    srv_p50 = _hist_percentile(srv_lat, 50) if srv_lat else None
    srv_p99 = _hist_percentile(srv_lat, 99) if srv_lat else None
    # queue-wait percentiles (fed from the serving.queue_wait spans):
    # the component that explains shedding, invisible in end-to-end
    srv_qw = _merged_histogram(merged, "serving_queue_wait_ms")
    srv_qw_p50 = _hist_percentile(srv_qw, 50) if srv_qw else None
    srv_qw_p99 = _hist_percentile(srv_qw, 99) if srv_qw else None
    srv_sync = _merged_histogram(merged, "serving_sync_ms")
    srv_sync_p99 = _hist_percentile(srv_sync, 99) if srv_sync else None
    srv_qps = _metric_value(merged, "serving_throughput_qps")
    srv_reqs = _metric_value(merged, "serving_requests_total")
    srv_shed = _metric_value(merged, "serving_shed_total")
    srv_shed_rate = None
    if srv_reqs:
        srv_shed_rate = round((srv_shed or 0.0) / srv_reqs, 4)
    # decode-tenant view: generated tokens, per-request generated-length
    # percentiles, and the steady-state tokens/sec gauge
    dec_tokens = _metric_value(merged, "serving_decode_tokens_total")
    dec_len = _merged_histogram(merged, "serving_generated_len")
    dec_len_p50 = _hist_percentile(dec_len, 50) if dec_len else None
    dec_len_p99 = _hist_percentile(dec_len, 99) if dec_len else None
    dec_tps = _metric_value(merged, "decode_tokens_per_sec")
    # paged-KV pool: totals sum across engines, occupancy takes the
    # WORST engine (the one about to backpressure admissions)
    kv_total = _metric_value(merged, "kv_blocks_total")
    kv_free = _metric_value(merged, "kv_blocks_free")
    kv_occ = _metric_max(merged, "kv_pool_occupancy")
    kv_handoffs = _metric_value(merged, "serving_kv_handoffs_total")
    # acceptance from the raw counters so multi-tenant rates merge as
    # a true token-weighted ratio, not an average of gauges
    spec_prop = _metric_value(merged, "spec_tokens_proposed_total")
    spec_acc = _metric_value(merged, "spec_tokens_accepted_total")
    spec_rate = (spec_acc or 0.0) / spec_prop if spec_prop else None

    # elastic view (resilience/elastic + autoscale): world/epoch from
    # the gauges when a live snapshot exists, else from the membership
    # files; pending joiners from the join files (ground truth), else
    # the leader's gauge; plus the autoscaler's last journaled decision
    fs = _elastic_fs_view(hb_dir or dirname, ranks)
    elastic_world = _metric_value(merged, "elastic_world_size")
    if elastic_world is None:
        elastic_world = fs.get("world")
    membership_epoch = _metric_value(merged, "membership_epoch")
    if membership_epoch is None:
        membership_epoch = fs.get("epoch")
    pending_joins = fs.get("pending")
    if pending_joins is None:
        pending_joins = _metric_value(merged, "elastic_pending_joins")
    autoscale = None
    for e in reversed(events):
        if e.get("kind") == "autoscale":
            autoscale = {"action": e.get("action"),
                         "reason": e.get("reason"),
                         "world": e.get("world"),
                         "target_world": e.get("target_world"),
                         "ts": e.get("ts")}
            break

    counts = {}
    for e in events:
        counts[e["kind"]] = counts.get(e["kind"], 0) + 1
    sequence = [
        {"kind": e["kind"], "ts": e.get("ts"), "rank": e.get("rank"),
         "step": e.get("step"), "trace": e.get("trace")}
        for e in events if e.get("kind") in _SEQUENCE_KINDS
    ]

    alive = sum(1 for r in ranks.values() if r["alive"])
    return {
        "dir": dirname,
        "ts": now,
        "steps": steps,
        "step_rate": step_rate,
        "p50_step_ms": None if p50 is None else round(p50, 3),
        "p99_step_ms": None if p99 is None else round(p99, 3),
        "skip_rate": skip_rate,
        "guard_skips": None if guard_skips is None else int(guard_skips),
        "faults": counts.get("fault-injected", 0),
        "restores": counts.get("checkpoint-loaded", 0),
        "drift": drift or None,
        "tier_bytes": tier_bytes or None,
        "quant_error": (None if quant_err is None
                        else round(quant_err, 6)),
        "quant_error_ratio": (None if quant_ratio is None
                              else round(quant_ratio, 4)),
        "checkpoint_age_s": checkpoint_age_s,
        "p50_serving_latency_ms": (None if srv_p50 is None
                                   else round(srv_p50, 3)),
        "p99_serving_latency_ms": (None if srv_p99 is None
                                   else round(srv_p99, 3)),
        "p50_serving_queue_wait_ms": (None if srv_qw_p50 is None
                                      else round(srv_qw_p50, 3)),
        "p99_serving_queue_wait_ms": (None if srv_qw_p99 is None
                                      else round(srv_qw_p99, 3)),
        "p99_serving_sync_ms": (None if srv_sync_p99 is None
                                else round(srv_sync_p99, 3)),
        "serving_throughput_qps": (None if srv_qps is None
                                   else round(srv_qps, 3)),
        "serving_queue_depth": _metric_value(merged,
                                             "serving_queue_depth"),
        "serving_requests": (None if srv_reqs is None
                             else int(srv_reqs)),
        "serving_rejected": _metric_value(merged,
                                          "serving_rejected_total"),
        "serving_shed_rate": srv_shed_rate,
        "serving_decode_tokens": (None if dec_tokens is None
                                  else int(dec_tokens)),
        "p50_generated_len": (None if dec_len_p50 is None
                              else round(dec_len_p50, 1)),
        "p99_generated_len": (None if dec_len_p99 is None
                              else round(dec_len_p99, 1)),
        "decode_tokens_per_sec": (None if dec_tps is None
                                  else round(dec_tps, 3)),
        "kv_blocks_total": (None if kv_total is None
                            else int(kv_total)),
        "kv_blocks_free": (None if kv_free is None else int(kv_free)),
        "kv_pool_occupancy": (None if kv_occ is None
                              else round(kv_occ, 4)),
        "kv_handoffs": (None if kv_handoffs is None
                        else int(kv_handoffs)),
        "spec_acceptance_rate": (None if spec_rate is None
                                 else round(spec_rate, 4)),
        "elastic_world_size": (None if elastic_world is None
                               else int(elastic_world)),
        "membership_epoch": (None if membership_epoch is None
                             else int(membership_epoch)),
        "pending_joins": (None if pending_joins is None
                          else int(pending_joins)),
        "autoscale": autoscale,
        "ranks": ranks or None,
        "alive_ranks": alive if ranks else None,
        "lost_ranks": (len(ranks) - alive) if ranks else None,
        "event_counts": counts or None,
        "sequence": sequence or None,
    }


def _lookup(status, path):
    """Dotted-path numeric lookup into the status dict."""
    cur = status
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    if isinstance(cur, bool) or not isinstance(cur, (int, float)):
        return None
    return float(cur)


_OPS = {
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
}


def check_alert(status, expr):
    """Evaluate one alert expression against a status dict.  Returns
    (exit_code, message): 0 OK, 1 tripped, 2 no data."""
    match = _ALERT_RE.match(expr)
    if not match:
        raise ValueError(
            "bad alert %r (want e.g. 'p99_step_ms>50')" % expr)
    field, op, threshold = match.groups()
    # convenience aliases into the nested drift dict
    value = _lookup(status, field)
    if value is None and not field.startswith("drift."):
        value = _lookup(status, "drift." + field)
    if value is None:
        return 2, "ALERT %s: no data" % expr
    if _OPS[op](value, float(threshold)):
        return 1, "ALERT %s TRIPPED (value=%s)" % (expr, value)
    return 0, "alert %s ok (value=%s)" % (expr, value)


def _fmt(v, suffix=""):
    if v is None:
        return "-"
    if isinstance(v, float):
        return "%.3g%s" % (v, suffix)
    return "%s%s" % (v, suffix)


def render_status(status):
    """Human one-screen rendering of a status dict."""
    lines = ["telemetry %s @ %s" % (
        status["dir"],
        time.strftime("%H:%M:%S", time.localtime(status["ts"])))]
    lines.append(
        "  steps=%s  rate=%s/s  step_ms p50=%s p99=%s" % (
            _fmt(status["steps"]), _fmt(status["step_rate"]),
            _fmt(status["p50_step_ms"]), _fmt(status["p99_step_ms"])))
    lines.append(
        "  skip_rate=%s  faults=%s  restores=%s  ckpt_age=%s" % (
            _fmt(status["skip_rate"]), _fmt(status["faults"]),
            _fmt(status["restores"]),
            _fmt(status["checkpoint_age_s"], "s")))
    if status["drift"]:
        lines.append("  drift " + "  ".join(
            "%s=%s" % (k, _fmt(v))
            for k, v in sorted(status["drift"].items())))
    if status.get("tier_bytes"):
        lines.append("  wire " + "  ".join(
            "%s=%sB" % (k, _fmt(v))
            for k, v in sorted(status["tier_bytes"].items())))
    if status.get("quant_error") is not None:
        lines.append("  quant: error=%s  vs_model=%sx" % (
            _fmt(status["quant_error"]),
            _fmt(status.get("quant_error_ratio"))))
    if status.get("serving_requests") is not None:
        lines.append(
            "  serving: reqs=%s  qps=%s  lat_ms p50=%s p99=%s  "
            "qwait_ms p50=%s p99=%s  queue=%s  shed_rate=%s" % (
                _fmt(status["serving_requests"]),
                _fmt(status["serving_throughput_qps"]),
                _fmt(status["p50_serving_latency_ms"]),
                _fmt(status["p99_serving_latency_ms"]),
                _fmt(status.get("p50_serving_queue_wait_ms")),
                _fmt(status.get("p99_serving_queue_wait_ms")),
                _fmt(status["serving_queue_depth"]),
                _fmt(status["serving_shed_rate"])))
    if status.get("serving_decode_tokens") is not None:
        lines.append(
            "  decode: tokens=%s  tok/s=%s  gen_len p50=%s p99=%s" % (
                _fmt(status["serving_decode_tokens"]),
                _fmt(status["decode_tokens_per_sec"]),
                _fmt(status["p50_generated_len"]),
                _fmt(status["p99_generated_len"])))
    if status.get("kv_blocks_total") is not None:
        kv = "  kv_pool: blocks=%s free=%s occupancy=%s" % (
            _fmt(status["kv_blocks_total"]),
            _fmt(status["kv_blocks_free"]),
            _fmt(status["kv_pool_occupancy"]))
        if status.get("kv_handoffs") is not None:
            kv += "  handoffs=%s" % _fmt(status["kv_handoffs"])
        if status.get("spec_acceptance_rate") is not None:
            kv += "  spec_accept=%s" % _fmt(
                status["spec_acceptance_rate"])
        lines.append(kv)
    if status.get("elastic_world_size") is not None \
            or status.get("pending_joins"):
        lines.append("  elastic: world=%s  epoch=%s  pending_joins=%s"
                     % (_fmt(status.get("elastic_world_size")),
                        _fmt(status.get("membership_epoch")),
                        _fmt(status.get("pending_joins"))))
    if status.get("autoscale"):
        a = status["autoscale"]
        lines.append("  autoscale: %s (%s)"
                     % (a.get("action"), a.get("reason")))
    if status["ranks"]:
        for rank in sorted(status["ranks"], key=int):
            r = status["ranks"][rank]
            state = ("done" if r["done"]
                     else "WEDGED" if r["wedged"]
                     else "alive" if r["alive"] else "LOST")
            lines.append(
                "  rank %s: %s  beat_age=%ss  step=%s  step_ms=%s" % (
                    rank, state, r["beat_age_s"], _fmt(r["step"]),
                    _fmt(r["step_ms"])))
    if status["sequence"]:
        # collapse consecutive repeats (routine per-step checkpoints)
        # so they cannot scroll an incident chain out of the window
        collapsed = []
        for e in status["sequence"]:
            if collapsed and collapsed[-1][0]["kind"] == e["kind"]:
                collapsed[-1] = (e, collapsed[-1][1] + 1)
            else:
                collapsed.append((e, 1))
        tail = collapsed[-8:]
        lines.append("  recent: " + " -> ".join(
            e["kind"]
            + ("@%s" % e["step"] if e.get("step") is not None else "")
            + (" x%d" % n if n > 1 else "")
            for e, n in tail))
        # point the operator at `tools.trace --id` for the incident chain
        traces = []
        for e, _ in tail:
            t = e.get("trace")
            if t and t not in traces:
                traces.append(t)
        if traces:
            lines.append("  trace: " + " ".join(t[:8] for t in traces)
                         + "  (paddle_tpu_torch.tools.trace --id <id> DIR)")
    return "\n".join(lines)


def _has_data(status):
    return any(status.get(k) is not None
               for k in ("steps", "ranks", "event_counts"))


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.monitor",
        description="tail a paddle_tpu_torch telemetry directory")
    ap.add_argument("dir", help="PADDLE_TPU_TELEMETRY_DIR of the job")
    ap.add_argument("--hb-dir", default=None,
                    help="heartbeat dir when separate from the "
                         "telemetry dir")
    ap.add_argument("--once", action="store_true",
                    help="print one report and exit")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    ap.add_argument("--alert", action="append", default=[],
                    metavar="EXPR",
                    help="e.g. 'p99_step_ms>50' or, for a serving job, "
                         "'p99_serving_latency_ms>250' / "
                         "'serving_shed_rate>0'; decode tenants add "
                         "'decode_tokens_per_sec<100' / "
                         "'serving_decode_tokens==0' / "
                         "'p99_generated_len>512'; paged-KV serving "
                         "adds 'kv_pool_occupancy>0.9' (the worst "
                         "engine's pool is nearly exhausted — "
                         "admissions are about to backpressure) / "
                         "'kv_blocks_free==0' / "
                         "'spec_acceptance_rate<0.3' (the draft "
                         "stopped paying for itself); "
                         "quantized-collective "
                         "jobs add 'quant_error>0.05' (worst per-bucket "
                         "int8 error) / 'quant_error_ratio>2' (error "
                         "model drift); elastic jobs add "
                         "'pending_joins>0' (a worker is waiting for "
                         "admission) / 'elastic_world_size<4'; exit 1 "
                         "when tripped, 2 when the field has no data "
                         "(repeatable)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="live-mode refresh seconds (default 2)")
    ap.add_argument("--stale-after", type=float,
                    default=DEFAULT_STALE_S,
                    help="heartbeat age marking a rank lost")
    ap.add_argument("--wedge-after", type=float,
                    default=DEFAULT_WEDGE_S,
                    help="step-progress age marking a rank wedged")
    args = ap.parse_args(argv)

    def _report():
        status = collect_status(
            args.dir, hb_dir=args.hb_dir,
            stale_after=args.stale_after, wedge_after=args.wedge_after)
        if args.json:
            print(json.dumps(status, sort_keys=True, default=str))
        else:
            print(render_status(status))
        code = 0
        for expr in args.alert:
            c, msg = check_alert(status, expr)
            print(msg, file=sys.stderr)
            code = max(code, c)
        if not args.alert and not _has_data(status):
            print("no telemetry found under %s" % args.dir,
                  file=sys.stderr)
            code = 2
        return code

    if args.once:
        return _report()
    code = 0
    try:
        while True:
            code = _report()
            time.sleep(max(args.interval, 0.1))
    except KeyboardInterrupt:
        return code


if __name__ == "__main__":
    sys.exit(main())
