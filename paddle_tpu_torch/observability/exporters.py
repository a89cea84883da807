"""Exporters: Prometheus text format, JSON snapshot (mirrors
``paddle_tpu/observability/exporters.py``; the merged chrome trace of
:110 waits for the profiler hook).

Prometheus output follows the text exposition format 0.0.4 (one
``# TYPE`` line per family, ``_bucket``/``_sum``/``_count`` triplets
for histograms with cumulative ``le`` buckets) so a node exporter
sidecar can scrape the snapshot file directly.  Ordering is
deterministic — the test suite pins a golden.
"""

import json
import os
import time

from .metrics import Counter, Gauge, Histogram, registry

__all__ = ["export_prometheus", "export_json",
           "write_metrics_snapshot", "write_chrome_trace"]

_PREFIX = "paddle_tpu_"


def _fmt(v):
    if v is None:
        return "NaN"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_str(labels, extra=None):
    items = list(labels)
    if extra:
        items = items + list(extra)
    if not items:
        return ""
    return "{%s}" % ",".join('%s="%s"' % (k, v) for k, v in items)


def export_prometheus(reg=None):
    """The whole registry in Prometheus text format."""
    reg = reg or registry()
    lines = []
    seen_families = set()
    for m in reg.collect():
        family = _PREFIX + m.name
        if family not in seen_families:
            seen_families.add(family)
            if m.help:
                lines.append("# HELP %s %s" % (family, m.help))
            lines.append("# TYPE %s %s" % (family, m.kind))
        if isinstance(m, (Counter, Gauge)):
            lines.append("%s%s %s"
                         % (family, _label_str(m.labels), _fmt(m.value)))
        elif isinstance(m, Histogram):
            cum = 0
            counts = m.to_dict()["counts"]
            for ub, c in zip(m.buckets, counts):
                cum += c
                lines.append("%s_bucket%s %d" % (
                    family,
                    _label_str(m.labels, [("le", _fmt(ub))]), cum))
            lines.append("%s_bucket%s %d" % (
                family, _label_str(m.labels, [("le", "+Inf")]),
                m.count))
            lines.append("%s_sum%s %s" % (family, _label_str(m.labels),
                                          _fmt(m.sum)))
            lines.append("%s_count%s %d" % (family,
                                            _label_str(m.labels),
                                            m.count))
    return "\n".join(lines) + ("\n" if lines else "")


def export_json(reg=None):
    """``{"schema": 1, "ts": ..., "metrics": {...}}`` — every series'
    ``to_dict()`` keyed by ``name{labels}``."""
    reg = reg or registry()
    return {"schema": 1, "ts": time.time(), "pid": os.getpid(),
            "metrics": reg.snapshot()}


def write_metrics_snapshot(path, reg=None):
    """Atomically write :func:`export_json` to ``path`` (tmp+rename, so
    the monitor CLI never reads a torn snapshot).  Returns the dict
    written, or None on I/O failure."""
    snap = export_json(reg)
    tmp = "%s.tmp.%d" % (path, os.getpid())
    try:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(snap, f, sort_keys=True, default=str)
        os.replace(tmp, path)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        return None
    return snap


def write_chrome_trace(path):
    """The reference merges host spans with the profiler's device rows
    here (its ``profiler.export_chrome_trace``); the port's profiler
    hook is not ported yet."""
    raise NotImplementedError(
        "write_chrome_trace needs the profiler's device-row merge, which "
        "is not ported yet (ROADMAP.md, Queue A item 3: tools/trace.py); "
        "time the device with torch.profiler")
