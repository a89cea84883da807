"""Built-in load generator for the predictor server (mirrors
``paddle_tpu/serving/loadgen.py``, all of it).

Paced open-loop submission (fixed offered QPS, round-robin across
tenants), exact percentile computation from the recorded per-request
latencies, and a JSON-able report — what ``python -m
paddle_tpu_torch.tools.serve`` runs.
"""

import time

import numpy as np

from .server import QueueFullError

__all__ = ["make_feed_sampler", "percentile", "run_load"]


def make_feed_sampler(predictor, rows=1, rng=None, int_high=1):
    """Build a feed sampler from the program's declared data vars:
    float feeds get standard-normal noise, integer feeds uniform ids in
    ``[0, int_high)`` (keeps embedding lookups in-vocab).  The leading
    ``-1`` batch dim becomes ``rows``.  Returns a zero-arg callable
    producing a fresh name→array feed."""
    rng = np.random.RandomState(0) if rng is None else rng
    program = predictor.program
    block = program.global_block()
    specs = []
    for name in predictor.get_input_names():
        var = block.var(name)
        shape = [rows if int(d) == -1 else int(d) for d in var.shape]
        if not shape:
            shape = [rows]
        dtype = str(getattr(var, "dtype", "float32") or "float32")
        specs.append((name, tuple(shape), dtype))

    def sample():
        feed = {}
        for name, shape, dtype in specs:
            if "int" in dtype:
                feed[name] = rng.randint(
                    0, max(int_high, 1), size=shape).astype(dtype)
            else:
                # bfloat16 has no numpy dtype — feed f32, the program
                # casts on the device
                feed[name] = rng.standard_normal(shape).astype(
                    dtype if dtype.startswith("float") else "float32")
        return feed

    return sample


def percentile(latencies, q):
    """Exact percentile (nearest-rank) of a latency list; None when
    empty."""
    if not latencies:
        return None
    xs = sorted(latencies)
    k = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[k]


def run_load(server, samplers, qps=100.0, requests=100, sla_ms=None,
             burst=False):
    """Drive ``server`` with generated traffic and report latency and
    throughput.

    ``samplers``: ``{tenant: zero-arg feed factory}``.  Open-loop pacing
    at ``qps`` offered load (``burst=True`` submits everything at once —
    the saturation-throughput mode bench's A/B arm uses).  Rejected
    submits (backpressure) are counted, not retried.

    Returns a JSON-able report: counts, ``p50_ms``/``p99_ms``/mean
    latency, measured ``qps`` (completions over the submit→last-complete
    span), shed/reject counts and per-tenant breakdown.
    """
    tenants = list(samplers)
    period = 0.0 if burst or qps <= 0 else 1.0 / qps
    pending = []
    rejected = 0
    t0 = time.time()
    next_at = t0
    for i in range(requests):
        tenant = tenants[i % len(tenants)]
        if period:
            delay = next_at - time.time()
            if delay > 0:
                time.sleep(delay)
            next_at += period
        try:
            pending.append(server.submit(
                tenant, samplers[tenant](),
                request_id="%s-%d" % (tenant, i), sla_ms=sla_ms))
        except QueueFullError:
            rejected += 1
    lat, shed, failed = [], 0, 0
    per_tenant = {t: {"completed": 0, "shed": 0, "latencies": []}
                  for t in tenants}
    for req in pending:
        try:
            req.result(timeout=120.0)
            lat.append(req.latency_ms)
            per_tenant[req.tenant]["completed"] += 1
            per_tenant[req.tenant]["latencies"].append(req.latency_ms)
        except Exception as exc:  # noqa: BLE001
            if type(exc).__name__ == "DeadlineExceededError":
                shed += 1
                per_tenant[req.tenant]["shed"] += 1
            else:
                failed += 1
    wall = max(time.time() - t0, 1e-9)
    report = {
        "requests": requests,
        "completed": len(lat),
        "shed": shed,
        "rejected": rejected,
        "failed": failed,
        "offered_qps": None if burst else qps,
        "qps": len(lat) / wall,
        "duration_s": round(wall, 4),
        "p50_ms": percentile(lat, 50),
        "p99_ms": percentile(lat, 99),
        "mean_ms": (sum(lat) / len(lat)) if lat else None,
        "shed_rate": shed / float(requests) if requests else 0.0,
        "tenants": {
            t: {
                "completed": d["completed"],
                "shed": d["shed"],
                "p50_ms": percentile(d["latencies"], 50),
                "p99_ms": percentile(d["latencies"], 99),
            } for t, d in per_tenant.items()
        },
    }
    return report
