"""Whole-program static analysis from the command line (mirrors
``paddle_tpu/tools/analyze_program.py``).

Usage::

    python -m paddle_tpu_torch.tools.analyze_program MODEL_DIR [options]
    python -m paddle_tpu_torch.tools.analyze_program --program-json \
        prog.json --workers w0.json w1.json --hbm-budget 16G --batch 64

Loads a serialized Program (the same inputs as ``lint_program``) and runs
``Program.analyze()``: the abstract interpretation, the static
FLOP/byte/collective cost model with the liveness-based peak-memory
estimate (priced at one H100's numbers), the per-ring collective
schedule, and, when ``--workers`` supplies the N transpiled per-worker
programs, the cross-worker deadlock-freedom proof.  Prints the
cost/memory table (or ``--json`` for the whole report, in the lint
CLI's format) and exits:

* 0 — no findings at or above ``--fail-on`` (default ERROR)
* 1 — findings at or above the gate
* 2 — could not load a program

``--bench-json PATH`` also writes the static cost metrics as JSON lines,
with the calibration factors of the autotune cache
(``autotune_calibration_factors``) when it holds any.

``--concurrency`` adds the concurrency battery at ``--max-in-flight K``;
``--certify-zero-sync`` prints the zero-sync certificate; ``--coresident
P.json ...`` proves scope isolation against programs sharing the
Executor.  ``--overlap`` prints the windows of the fusion-resolved
program, whose resolve ran the overlap scheduler.  ``--plan`` needs the
planner's search, which is not ported (ROADMAP.md, Queue A item 9), and
raises.
"""

import argparse
import sys

from .diag_cli import (add_emitter_args, add_program_args,
                       emit_diagnostics, load_program_arg,
                       severity_gate)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.analyze_program",
        description="Static cost/memory/collective-schedule analysis "
                    "of a saved paddle_tpu program.")
    add_program_args(parser)
    parser.add_argument("--workers", nargs="+", default=None,
                        metavar="PROG_JSON",
                        help="serialized per-worker main programs (ALL "
                             "workers, in rank order) — enables the "
                             "cross-worker schedule proof")
    parser.add_argument("--nranks", type=int, default=None,
                        help="worker count for the sharding model "
                             "(default: len(--workers) or the recorded "
                             "trainer count)")
    parser.add_argument("--batch", type=int, default=None,
                        help="what -1 (batch) dims resolve to (default "
                             "PADDLE_TPU_ANALYZE_BATCH or 1)")
    parser.add_argument("--hbm-budget", default=None,
                        help="peak-memory budget (bytes; K/M/G suffix) "
                             "— overrides PADDLE_TPU_HBM_BUDGET")
    parser.add_argument("--top", type=int, default=12,
                        help="rows in the top-ops-by-FLOPs table")
    parser.add_argument("--bench-json", default=None, metavar="PATH",
                        help="also write the static cost metric lines "
                             "(and the autotune calibrations) to PATH")
    parser.add_argument("--concurrency", action="store_true",
                        help="run the whole-program concurrency "
                             "analyzer: in-flight race detection, "
                             "donated-buffer hazards, host-sync audit")
    parser.add_argument("--max-in-flight", type=int, default=None,
                        metavar="K",
                        help="in-flight step depth the race analysis "
                             "assumes (default: the program's recorded "
                             "depth, PADDLE_TPU_MAX_IN_FLIGHT, or 2)")
    parser.add_argument("--certify-zero-sync", action="store_true",
                        help="prove the program's hot loop issues no "
                             "host syncs (prints the certificate; any "
                             "violation is an ERROR naming the "
                             "introducing API)")
    parser.add_argument("--coresident", nargs="+", default=None,
                        metavar="PROG_JSON",
                        help="serialized programs that will share this "
                             "program's Executor/scope — proves their "
                             "scope-variable footprints are disjoint")
    parser.add_argument("--plan", default=None, metavar="CLUSTER_SPEC",
                        help="the auto-parallelism planner's candidate "
                             "table: not ported (ROADMAP.md, Queue A "
                             "item 9); raises")
    parser.add_argument("--overlap", action="store_true",
                        help="run the fusion + overlap-scheduler "
                             "rewrite and print the per-window table: "
                             "bucket, start/wait op coords, window "
                             "compute ms, wire ms, exposed ms, verdict")
    add_emitter_args(parser)
    args = parser.parse_args(argv)
    if not args.model_dir and not args.program_json:
        parser.error("need MODEL_DIR or --program-json")
    if args.plan:
        raise NotImplementedError(
            "analyze_program --plan runs the auto-parallelism planner's "
            "search, which is not ported yet (ROADMAP.md, Queue A item 9)")

    from ..proto import load_program
    from ..static_analysis.cost import parse_size

    try:
        program, targets = load_program_arg(args)
        workers = None
        if args.workers:
            workers = [load_program(p) for p in args.workers]
        coresident = None
        if args.coresident:
            coresident = [(p, load_program(p)) for p in args.coresident]
    except Exception as e:  # noqa: BLE001 - any load failure is exit 2
        print("error: could not load program: %s" % e, file=sys.stderr)
        return 2

    budget = parse_size(args.hbm_budget) if args.hbm_budget else None
    report = program.analyze(
        targets=targets, workers=workers, nranks=args.nranks,
        batch_size=args.batch, hbm_budget=budget,
        concurrency=args.concurrency, max_in_flight=args.max_in_flight,
        coresident=coresident,
        certify_zero_sync=args.certify_zero_sync)

    overlap_info = overlap_lines = None
    if args.overlap:
        from ..static_analysis.cost import (estimate_cost,
                                            overlap_window_table)

        from ..static_analysis.fusion import resolve_fused_program

        resolved, _ = resolve_fused_program(program, targets=targets)
        ovr = getattr(resolved, "_overlap_report", None)
        cost_r = estimate_cost(resolved, nranks=args.nranks,
                               targets=targets, batch_size=args.batch,
                               budget=budget)
        rows = overlap_window_table(cost_r)
        overlap_info = {"windows": rows,
                        "report": ovr.to_dict() if ovr else None}
        overlap_lines = ["overlap windows (%d):" % len(rows),
                         "  %-6s %-10s %-10s %5s %5s %12s %10s %11s  %s"
                         % ("bucket", "start", "wait", "vars", "quant",
                            "compute ms", "wire ms", "exposed ms",
                            "verdict")]
        for r in rows:
            overlap_lines.append(
                "  %-6d %-10s %-10s %5d %5s %12.4f %10.4f %11.4f  %s"
                % (r["bucket"], tuple(r["start"]), tuple(r["wait"]),
                   r["vars"], "int8" if r["quant"] else "-",
                   r["window_compute_ms"], r["wire_ms"],
                   r["exposed_ms"], r["verdict"]))
        if ovr is not None:
            overlap_lines.append(ovr.format())

    if args.as_json:
        extra = {k: v for k, v in report.to_dict().items()
                 if k != "diagnostics"}
        if overlap_info is not None:
            extra["overlap"] = overlap_info
        emit_diagnostics(report.diagnostics, True, extra_json=extra)
    else:
        print(report.format(top_ops=args.top))
        if overlap_lines is not None:
            print("\n".join(overlap_lines))

    if args.bench_json:
        with open(args.bench_json, "w") as f:
            f.write(report.cost.bench_json() + "\n")

    return severity_gate(report.diagnostics, args.fail_on, args.as_json)


if __name__ == "__main__":
    sys.exit(main())
