"""Process-wide metrics registry: counters, gauges, fixed-bucket
histograms (mirrors ``paddle_tpu/observability/metrics.py``, all of it).

Reference point is ``paddle/fluid/platform/profiler`` plus VisualDL's
scalar logging — but flipped always-on: the registry is cheap enough to
leave enabled in steady-state training/serving, and the exporters
(:mod:`.exporters`) snapshot it in Prometheus text format / JSON for
scraping.

Design constraints:

* **kill switch** — ``PADDLE_TPU_TELEMETRY=0`` turns every accessor
  into a shared no-op stub; instrumented call sites pay one function
  call and one cached boolean check, nothing else;
* **lock-cheap hot path** — metric creation (a dict mutation) takes the
  registry lock; updates take only the metric's own lock around a
  couple of arithmetic ops.  No I/O ever happens on an update;
* **labels** — a metric instance is keyed ``(name, sorted(labels))`` so
  ``counter("collective_launches_total", ring=0)`` and ``ring=1`` are
  independent series, the way Prometheus client libraries model it.
"""

import os
import threading
from bisect import bisect_left

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_LATENCY_BUCKETS_MS", "registry", "counter", "gauge",
    "histogram", "telemetry_enabled", "set_telemetry_enabled",
    "reset_metrics",
]

#: default fixed bucket upper bounds for latency histograms, in ms —
#: covers a 10us kernel through a 100s compile in ~3x steps
DEFAULT_LATENCY_BUCKETS_MS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 100000.0)

_FALSY = ("0", "false", "off", "no")

# resolved lazily so tests/bench can flip the env var before first use;
# set_telemetry_enabled() overrides it explicitly
_enabled = None
_enabled_lock = threading.Lock()


def telemetry_enabled():
    """True unless ``PADDLE_TPU_TELEMETRY`` is set falsy (the kill
    switch) or :func:`set_telemetry_enabled` said otherwise."""
    global _enabled
    if _enabled is None:
        with _enabled_lock:
            if _enabled is None:
                _enabled = os.environ.get(
                    "PADDLE_TPU_TELEMETRY", "1").strip().lower() \
                    not in _FALSY
    return _enabled


def set_telemetry_enabled(on):
    """Force the kill switch on/off in-process (bench A/B, tests).
    ``None`` re-arms the lazy env read."""
    global _enabled
    with _enabled_lock:
        _enabled = None if on is None else bool(on)


class _NullMetric:
    """Shared do-nothing stub returned by every accessor when the kill
    switch is set — the zero-overhead disabled path."""

    __slots__ = ()

    def inc(self, amount=1):
        pass

    def dec(self, amount=1):
        pass

    def set(self, value):
        pass

    def observe(self, value):
        pass

    @property
    def value(self):
        return 0


NULL_METRIC = _NullMetric()


class _Metric:
    __slots__ = ("name", "labels", "help", "_lock")

    def __init__(self, name, labels=(), help=""):
        self.name = str(name)
        self.labels = tuple(labels)
        self.help = help
        self._lock = threading.Lock()

    def label_suffix(self):
        if not self.labels:
            return ""
        return "{%s}" % ",".join(
            '%s="%s"' % (k, v) for k, v in self.labels)

    def __repr__(self):
        return "%s(%s%s=%r)" % (type(self).__name__, self.name,
                                self.label_suffix(), self.value)


class Counter(_Metric):
    """Monotonically increasing count (steps, cache hits, retries)."""

    __slots__ = ("_value",)
    kind = "counter"

    def __init__(self, name, labels=(), help=""):
        super().__init__(name, labels, help)
        self._value = 0

    def inc(self, amount=1):
        if amount < 0:
            raise ValueError("counter %s cannot decrease" % self.name)
        with self._lock:
            self._value += amount

    @property
    def value(self):
        return self._value

    def to_dict(self):
        return {"type": "counter", "value": self._value}


class Gauge(_Metric):
    """Point-in-time value (queue depth, drift ratio, bytes)."""

    __slots__ = ("_value",)
    kind = "gauge"

    def __init__(self, name, labels=(), help=""):
        super().__init__(name, labels, help)
        self._value = 0.0

    def set(self, value):
        with self._lock:
            self._value = float(value)

    def inc(self, amount=1):
        with self._lock:
            self._value += amount

    def dec(self, amount=1):
        with self._lock:
            self._value -= amount

    @property
    def value(self):
        return self._value

    def to_dict(self):
        return {"type": "gauge", "value": self._value}


class Histogram(_Metric):
    """Fixed-bucket histogram (latencies).  Buckets are upper bounds in
    the observed unit; an implicit +Inf bucket catches the tail.
    ``percentile`` linearly interpolates within the winning bucket —
    coarse, but monitor-grade."""

    __slots__ = ("buckets", "_counts", "_sum", "_count", "_min", "_max")
    kind = "histogram"

    def __init__(self, name, labels=(), help="", buckets=None):
        super().__init__(name, labels, help)
        self.buckets = tuple(sorted(buckets or DEFAULT_LATENCY_BUCKETS_MS))
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._min = None
        self._max = None

    def observe(self, value):
        value = float(value)
        i = bisect_left(self.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if self._min is None or value < self._min:
                self._min = value
            if self._max is None or value > self._max:
                self._max = value

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    @property
    def value(self):
        """Mean — what a scalar-shaped reading of a histogram means."""
        return self._sum / self._count if self._count else 0.0

    def percentile(self, p):
        """Estimated p-th percentile (p in [0, 100]) from the bucket
        counts; None when empty.  The +Inf bucket clamps to the max
        observed value."""
        if not self._count:
            return None
        rank = max(p, 0.0) / 100.0 * self._count
        seen = 0
        for i, c in enumerate(self._counts):
            if not c:
                continue
            if seen + c >= rank:
                hi = (self.buckets[i] if i < len(self.buckets)
                      else self._max)
                lo = self.buckets[i - 1] if i > 0 else 0.0
                if hi is None:
                    hi = lo
                frac = (rank - seen) / c
                est = lo + (hi - lo) * min(max(frac, 0.0), 1.0)
                return min(est, self._max)
            seen += c
        return self._max

    def to_dict(self):
        return {
            "type": "histogram",
            "count": self._count,
            "sum": round(self._sum, 6),
            "min": self._min,
            "max": self._max,
            "buckets": list(self.buckets),
            "counts": list(self._counts),
            "p50": self.percentile(50),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Name+labels -> metric instance; get-or-create semantics with a
    kind check (re-registering ``x`` as a different kind is a bug, not
    a silent overwrite)."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(name, labels):
        return (name, tuple(sorted(labels.items())))

    def _get_or_create(self, cls, name, labels, help, **kwargs):
        key = self._key(name, labels)
        m = self._metrics.get(key)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(
                    "metric %r already registered as %s, not %s"
                    % (name, m.kind, cls.kind))
            return m
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, labels=key[1], help=help, **kwargs)
                self._metrics[key] = m
            return m

    def counter(self, name, help="", **labels):
        return self._get_or_create(Counter, name, labels, help)

    def gauge(self, name, help="", **labels):
        return self._get_or_create(Gauge, name, labels, help)

    def histogram(self, name, help="", buckets=None, **labels):
        return self._get_or_create(Histogram, name, labels, help,
                                   buckets=buckets)

    def get(self, name, **labels):
        """The registered metric, or None."""
        return self._metrics.get(self._key(name, labels))

    def collect(self):
        """All metrics, sorted by (name, labels) — the exporters'
        deterministic iteration order."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self):
        """``{name{labels}: metric.to_dict()}`` — the JSON export."""
        return {m.name + m.label_suffix(): m.to_dict()
                for m in self.collect()}

    def reset(self):
        with self._lock:
            self._metrics.clear()

    def __len__(self):
        return len(self._metrics)


_REGISTRY = MetricsRegistry()


def registry():
    """The process-wide registry (always real, even when disabled —
    only the convenience accessors below honor the kill switch)."""
    return _REGISTRY


def counter(name, help="", **labels):
    if not telemetry_enabled():
        return NULL_METRIC
    return _REGISTRY.counter(name, help=help, **labels)


def gauge(name, help="", **labels):
    if not telemetry_enabled():
        return NULL_METRIC
    return _REGISTRY.gauge(name, help=help, **labels)


def histogram(name, help="", buckets=None, **labels):
    if not telemetry_enabled():
        return NULL_METRIC
    return _REGISTRY.histogram(name, help=help, buckets=buckets,
                               **labels)


def reset_metrics():
    """Clear every series and re-arm the lazy kill-switch read (test
    isolation)."""
    _REGISTRY.reset()
    set_telemetry_enabled(None)
