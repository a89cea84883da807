"""Serving CLI: ``python -m paddle_tpu_torch.tools.serve`` (mirrors
``paddle_tpu/tools/serve.py``, all of it: the same flags and exit codes).

Loads one or more saved inference programs as co-resident tenants of a
:class:`~paddle_tpu_torch.serving.PredictorServer` on ``CUDAPlace(0)``
(the scope-overlap proof
gates the placement, the zero-sync certificate gates the hot loop) and
drives the built-in load generator against them::

    # one tenant, defaults
    python -m paddle_tpu_torch.tools.serve /models/mnist --requests 200

    # two co-resident tenants, explicit buckets + SLA, JSON report
    python -m paddle_tpu_torch.tools.serve \\
        --tenants mnist=/models/mnist,bert=/models/bert \\
        --buckets 1,2,4,8 --max-in-flight 3 --sla-ms 500 \\
        --qps 100 --requests 500 --json

The serving hot loop runs under ``PADDLE_TPU_STRICT_SYNC=1`` (set by
this CLI unless already set): any host-sync construct in a tenant
program is a hard startup error, not a latency cliff discovered in
production.  ``--certify-zero-sync`` prints each tenant's certificate
and exits — the preflight check.  Exit codes: 0 OK, 1 a gate failed or
the run shed/rejected with ``--fail-on-shed``, 2 bad arguments.
"""

import argparse
import json
import sys

__all__ = ["main"]


def _parse_tenants(args):
    tenants = []
    if args.tenants:
        for part in args.tenants.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    "--tenants wants name=model_dir[,name=dir...], "
                    "got %r" % part)
            name, path = part.split("=", 1)
            tenants.append((name.strip(), path.strip()))
    for i, path in enumerate(args.model_dir):
        tenants.append(("tenant%d" % i if len(args.model_dir) > 1
                        or args.tenants else "default", path))
    if not tenants:
        raise ValueError("no tenants: pass MODEL_DIR or --tenants")
    return tenants


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.serve",
        description="continuous-batching predictor server + load "
                    "generator over saved inference programs")
    ap.add_argument("model_dir", nargs="*",
                    help="saved inference model dir(s) "
                         "(save_inference_model output)")
    ap.add_argument("--tenants", default=None, metavar="N=DIR,...",
                    help="named tenants: mnist=/m/mnist,bert=/m/bert")
    ap.add_argument("--buckets", default=None, metavar="1,2,4,8",
                    help="padded batch-size buckets (default: env "
                         "PADDLE_TPU_SERVING_BUCKETS or 1,2,4,8)")
    ap.add_argument("--bucket-cap", type=int, default=None,
                    help="max bucket count (compiled signatures per tenant)")
    ap.add_argument("--max-in-flight", type=int, default=2,
                    help="dispatched batches kept un-synced (default 2)")
    ap.add_argument("--sla-ms", type=float, default=None,
                    help="default per-request deadline; late requests "
                         "are shed, not served stale")
    ap.add_argument("--queue-cap", type=int, default=256,
                    help="bounded queue size; beyond it submits are "
                         "rejected (backpressure, default 256)")
    ap.add_argument("--qps", type=float, default=100.0,
                    help="load-generator offered QPS (default 100)")
    ap.add_argument("--requests", type=int, default=200,
                    help="load-generator request count (default 200)")
    ap.add_argument("--rows", type=int, default=1,
                    help="rows per generated request (default 1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-verify", action="store_true",
                    help="skip the scope-overlap proof and async-path "
                         "verification (NOT for production)")
    ap.add_argument("--certify-zero-sync", action="store_true",
                    help="print each tenant's zero-sync certificate "
                         "and exit (0 all pass, 1 any fail)")
    ap.add_argument("--fail-on-shed", action="store_true",
                    help="exit 1 if any request was shed or rejected")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report")
    args = ap.parse_args(argv)

    import os

    # the serving hot loop runs strict: a host-sync construct is a
    # startup error (the zero-sync certificate), never a latency cliff
    os.environ.setdefault("PADDLE_TPU_STRICT_SYNC", "1")

    import numpy as np

    from .. import serving
    from ..inference import AnalysisConfig, AnalysisPredictor
    from ..static_analysis.verifier import VerifyError

    try:
        tenant_dirs = _parse_tenants(args)
    except ValueError as exc:
        print(str(exc), file=sys.stderr)
        return 2

    preds = {}
    for name, path in tenant_dirs:
        preds[name] = AnalysisPredictor(AnalysisConfig(model_dir=path))

    try:
        server = serving.PredictorServer(
            preds, max_in_flight=args.max_in_flight, sla_ms=args.sla_ms,
            queue_cap=args.queue_cap, buckets=args.buckets,
            bucket_cap=args.bucket_cap, verify=not args.no_verify,
            auto_start=False)
    except VerifyError as exc:
        print("placement/hot-loop verification failed:\n%s" % exc,
              file=sys.stderr)
        return 1

    if args.certify_zero_sync:
        ok = True
        for name, cert in server.certificates.items():
            print(cert.format())
            ok = ok and cert.ok
        return 0 if ok else 1

    rng = np.random.RandomState(args.seed)
    samplers = {
        name: serving.make_feed_sampler(pred, rows=args.rows, rng=rng)
        for name, pred in preds.items()
    }
    server.warmup({
        name: serving.make_feed_sampler(pred, rows=1, rng=rng)()
        for name, pred in preds.items()})
    server.start()
    try:
        report = serving.run_load(
            server, samplers, qps=args.qps, requests=args.requests,
            sla_ms=args.sla_ms)
    finally:
        server.close()
    stats = server.stats()
    report["buckets"] = stats["buckets"]
    report["zero_sync"] = stats["zero_sync"]
    report["dispatched_batches"] = stats["dispatches"]
    report["jit_entries"] = {
        name: len(pred._exe._cache) for name, pred in preds.items()}

    if args.json:
        print(json.dumps(report, sort_keys=True))
    else:
        print("served %d requests over %d tenant(s): "
              "p50=%.2fms p99=%.2fms qps=%.1f shed=%d rejected=%d"
              % (report["completed"], len(preds),
                 report["p50_ms"] or 0.0, report["p99_ms"] or 0.0,
                 report["qps"], report["shed"], report["rejected"]))
        print("buckets=%s zero_sync=%s jit_entries=%s"
              % (report["buckets"], report["zero_sync"],
                 report["jit_entries"]))
    if args.fail_on_shed and (report["shed"] or report["rejected"]
                              or report["failed"]):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
