"""Static concurrency analysis over the Program IR (mirrors
``paddle_tpu/static_analysis/concurrency.py``, all of it, with private
copies of ``HOST_IO_OP_TYPES`` from ``paddle_tpu/static_analysis/cost.py``
:86 and the ``guard_enabled`` predicate of
``paddle_tpu/resilience/guard.py`` :63-69).  Both packages give the same
footprints, diagnostics and certificates for the same program; in the
port a "dispatch" is a step's kernels enqueued on the CUDA stream (or a
captured graph's replay) and a "donated buffer" a resident scope tensor
that the step updates in place.

``run_batches`` / ``run_async`` keep up to K steps in flight,
``DeviceFeedPipeline`` stages upcoming batches on the device from a
background thread, fetch results ride lazy
:class:`~paddle_tpu_torch.pipeline.FetchHandle`\\ s that are read long
after the step was enqueued, and a step updates its read-write
persistables in place.  Within one step, program order gives
happens-before; across the in-flight window there is no ordering except
the data dependency of those in-place updates, so any buffer visible both
to a pending consumer (an unread fetch handle, the prefetch thread's
staging slot) and to a later in-flight step's write is a hazard:

**Race detection** (``race-inflight-write``, ``donated-buffer-live-read``)
    A persistable that is both written by the step and fetched races
    under ``max_in_flight>1``; when the writer updates it in place (an
    optimizer's ``Param -> ParamOut``), the fetched handle aliases the
    updated buffer.  A program that overwrites one of its own fed data
    vars races with the prefetch thread's next staged batch.

**Scope isolation** (``scope-overlap``)
    Programs sharing one scope touch disjoint scope-variable footprints
    (writes of one disjoint from reads and writes of the other), the
    precondition for multi-tenant serving.  Shared read-only state is
    allowed.

**Zero-sync certificate** (``sync-in-hot-loop``)
    The steady-state loop contains no host-sync point: no host-IO op, no
    host-table prefetch, no eager while trip-count probe.  The opt-in
    NaN step-guard's scalar flag is an *allowed* sync.

Surfaces: the four registered checks, :func:`analyze_concurrency`, and
two gates: ``AnalysisPredictor.run_batches(..., verify=True)`` and
``PredictorServer``'s construction (:mod:`..serving.server`).
"""

import os

from .checks import register_check
from .defuse import DefUseGraph
from .diagnostics import Diagnostic, Severity, format_diagnostics

__all__ = [
    "RACE_CHECK_IDS", "CONCURRENCY_CHECK_IDS",
    "ScopeFootprint", "scope_footprint", "prove_scope_isolation",
    "SyncPoint", "ZeroSyncCertificate", "certify_zero_sync",
    "ConcurrencyReport", "analyze_concurrency",
    "find_inflight_races", "find_overlap_window_races",
    "resolve_max_in_flight",
    "strict_sync_enabled", "race_signatures", "assert_no_new_races",
    "verify_async_hot_path",
]

#: host-IO op types: the executor runs them on the host around the step
#: (a copy of the reference's ``ops/io_ops.py`` roster)
HOST_IO_OP_TYPES = frozenset(("save", "load", "save_combine",
                              "load_combine"))

#: the two race checks the rewrite brackets re-run
RACE_CHECK_IDS = ("race-inflight-write", "donated-buffer-live-read")

#: everything this module registers
CONCURRENCY_CHECK_IDS = RACE_CHECK_IDS + ("scope-overlap",
                                          "sync-in-hot-loop")


def _truthy(val):
    return str(val).strip().lower() not in ("0", "", "false", "off",
                                            "none")


def guard_enabled(program=None):
    """Is the finite step-guard on for this run?  Env wins; a program
    can opt in via ``program._nan_guard = True``."""
    env = os.environ.get("PADDLE_TPU_NAN_GUARD")
    if env is not None:
        return str(env).strip().lower() not in ("", "0", "false", "off",
                                                "no")
    return bool(getattr(program, "_nan_guard", False))


def strict_sync_enabled(program=None):
    """Is the host-sync advisory promoted to a hard ERROR?  Env wins
    (``PADDLE_TPU_STRICT_SYNC=1``); a program that has entered the
    serving hot loop (``run_batches`` stamps ``_serving_hot_loop``) is
    strict by definition — a per-step sync there is a throughput bug,
    not a style note."""
    env = os.environ.get("PADDLE_TPU_STRICT_SYNC")
    if env is not None and _truthy(env):
        return True
    return bool(getattr(program, "_serving_hot_loop", False))


def resolve_max_in_flight(program=None, explicit=None, default=1):
    """The K the happens-before model assumes: an explicit argument,
    else the ``program._max_in_flight`` mark (``run_batches`` stamps
    it), else ``PADDLE_TPU_MAX_IN_FLIGHT``, else ``default``.  K<=1
    means sequential execution — every overlap window is empty and the
    race checks are vacuously silent."""
    if explicit is not None:
        return max(int(explicit), 1)
    mark = getattr(program, "_max_in_flight", None)
    if mark:
        try:
            return max(int(mark), 1)
        except (TypeError, ValueError):
            pass
    env = os.environ.get("PADDLE_TPU_MAX_IN_FLIGHT")
    if env:
        try:
            return max(int(env), 1)
        except ValueError:
            pass
    return max(int(default), 1)


# ---------------------------------------------------------------------------
# scope footprints + isolation proof
# ---------------------------------------------------------------------------

class ScopeFootprint:
    """The scope-variable footprint of one program: which persistable
    (scope-resident) names it reads and which it writes.  Disjointness
    of footprints is what makes two programs safe to run against one
    shared Executor scope with steps of both in flight."""

    __slots__ = ("reads", "writes")

    def __init__(self, reads=(), writes=()):
        self.reads = frozenset(reads)
        self.writes = frozenset(writes)

    def conflicts(self, other):
        """Scope vars that break isolation: any var one program writes
        while the other touches it at all.  Shared read-only state is
        fine (both only read it)."""
        return ((self.writes & (other.reads | other.writes))
                | (other.writes & self.reads))

    def isolated_from(self, other):
        return not self.conflicts(other)

    def to_dict(self):
        return {"reads": sorted(self.reads),
                "writes": sorted(self.writes)}

    def __repr__(self):
        return "ScopeFootprint(%d read(s), %d write(s))" % (
            len(self.reads), len(self.writes))


def _persistable_name(program, block_idx, name):
    b = program.block(block_idx) if block_idx < program.num_blocks \
        else program.global_block()
    v = b._find_var_recursive(name)
    return v is not None and v.persistable


def scope_footprint(program, graph=None):
    """Compute the program's :class:`ScopeFootprint` from the def-use
    graph (all walked blocks, sub-blocks included)."""
    graph = graph or DefUseGraph(program)
    reads, writes = set(), set()
    for name, sites in graph.uses.items():
        if any(_persistable_name(program, s.block_idx, name)
               for s in sites):
            reads.add(name)
    for name, sites in graph.defs.items():
        if any(s.op.type != "feed"
               and _persistable_name(program, s.block_idx, name)
               for s in sites):
            writes.add(name)
    return ScopeFootprint(reads, writes)


def prove_scope_isolation(programs, labels=None):
    """Prove N programs sharing one Executor/predictor scope touch
    disjoint scope-variable footprints.

    ``programs``: list of Programs; ``labels``: optional display names
    (default ``program[i]``).  Returns ``(footprints, diagnostics)`` —
    an empty diagnostics list IS the proof; each ``scope-overlap``
    ERROR names the offending pair and the conflicting vars."""
    labels = list(labels or [])
    while len(labels) < len(programs):
        labels.append("program[%d]" % len(labels))
    prints = [scope_footprint(p) for p in programs]
    # declared KV-block handoffs: a prefill tenant fills cache blocks a
    # decode tenant then owns (ownership transfer of block-table
    # entries, no copy).  The written overlap is intentional and
    # scheduler-serialized per block — downgraded to INFO when BOTH
    # programs declare the var, so an accidental collision on one side
    # still fails the proof
    declared = [frozenset(getattr(p, "_kv_handoff_vars", ()) or ())
                for p in programs]
    diags = []
    for i in range(len(prints)):
        for j in range(i + 1, len(prints)):
            conflicts = prints[i].conflicts(prints[j])
            handoff = sorted(conflicts & declared[i] & declared[j])
            if handoff:
                shown = ", ".join(handoff[:8]) + (
                    ", ... (%d total)" % len(handoff)
                    if len(handoff) > 8 else "")
                diags.append(Diagnostic(
                    "scope-handoff", Severity.INFO,
                    "%s and %s share written KV-pool vars by declared "
                    "block handoff: %s — ownership of block-table "
                    "entries transfers prefill -> decode without a "
                    "copy; block-level disjointness is the allocator's "
                    "no-double-assign invariant, not a scope-name "
                    "property" % (labels[i], labels[j], shown),
                    var_names=tuple(handoff),
                    hint="the paging property test "
                         "(admit/generate/retire churn) is the "
                         "correctness carrier for this allowance"))
            bad = sorted(conflicts - (declared[i] & declared[j]))
            if bad:
                shown = ", ".join(bad[:8]) + (
                    ", ... (%d total)" % len(bad) if len(bad) > 8
                    else "")
                diags.append(Diagnostic(
                    "scope-overlap", Severity.ERROR,
                    "%s and %s share a written scope var: %s — running "
                    "both against one Executor scope lets an in-flight "
                    "step of one donate/overwrite state the other is "
                    "reading" % (labels[i], labels[j], shown),
                    var_names=tuple(bad),
                    hint="give each program its own Scope "
                         "(scope_guard), or rename/split the shared "
                         "persistables; shared READ-ONLY state is "
                         "allowed"))
                continue
            shared_ro = sorted((prints[i].reads & prints[j].reads)
                               - prints[i].writes - prints[j].writes)
            if shared_ro:
                shown = ", ".join(shared_ro[:8]) + (
                    ", ... (%d total)" % len(shared_ro)
                    if len(shared_ro) > 8 else "")
                diags.append(Diagnostic(
                    "scope-overlap", Severity.WARNING,
                    "%s and %s read identically-named persistables: %s "
                    "— safe only if both programs intend to SHARE that "
                    "state; two independent models colliding on default "
                    "names will silently read whichever loaded last"
                    % (labels[i], labels[j], shown),
                    var_names=tuple(shared_ro),
                    hint="intended sharing (e.g. a common embedding "
                         "table) is fine; otherwise load each model "
                         "under its own Scope or unique_name "
                         "namespace"))
    return prints, diags


# ---------------------------------------------------------------------------
# in-flight race detection
# ---------------------------------------------------------------------------

def _fetch_names(program, targets, graph):
    """Explicit fetch targets plus inputs of any ``fetch`` ops a saved
    model carries — both produce pending FetchHandles at run time."""
    names = []
    for t in targets or ():
        names.append(t.name if hasattr(t, "name") else str(t))
    for _, _, op in graph.order:
        if op.type == "fetch":
            names.extend(op.input_arg_names)
    # de-dup, preserve order
    seen = set()
    out = []
    for n in names:
        if n not in seen:
            seen.add(n)
            out.append(n)
    return out


def find_inflight_races(program, targets=(), max_in_flight=None,
                        graph=None):
    """The happens-before race scan.  Returns Diagnostics (ERROR) for
    every pair of operations that can overlap under ``max_in_flight>1``
    and touch the same buffer without an ordering edge:

    * ``donated-buffer-live-read`` — a fetch target whose last writer
      ALIASES it (the var is also an input of the writing op: a fused /
      plain optimizer update, an in-place collective).  The pending
      handle of step N-1 holds exactly the buffer step N donates.
    * ``race-inflight-write`` — a fetched persistable written by a
      non-aliasing op (step N's scope write-back + donation vs the
      pending read), or an op overwriting a fed data var (write-write
      with the ``DeviceFeedPipeline`` prefetch thread's staging slot —
      the double-buffer feed overwrite).

    * ``race-inflight-write`` (overlap window) — a write to a bucket
      member between its ``c_allreduce_start`` and ``c_allreduce_wait``
      (:func:`find_overlap_window_races`).  Unlike the cross-step
      hazards this is K-INDEPENDENT: the ring transfer is in flight
      within one step, so even sequential execution races.

    K<=1 (sequential) proves every cross-step window empty: returns
    only the overlap-window findings.
    """
    k = resolve_max_in_flight(program, explicit=max_in_flight)
    # the overlap scheduler's start→wait windows race at ANY depth —
    # checked before the sequential early-out on purpose
    diags = find_overlap_window_races(program)
    if k <= 1:
        return diags
    graph = graph or DefUseGraph(program)

    def _mk(check, message, site, var, hint):
        return Diagnostic(
            check, Severity.ERROR, message,
            block_idx=site.block_idx, op_idx=site.op_idx,
            op_type=site.op.type,
            op_id=site.op.attrs.get("__op_id__"),
            var_names=(var,), hint=hint)

    # (1) pending fetch handle vs in-flight write/donate
    for name in _fetch_names(program, targets, graph):
        sites = [s for s in graph.defs.get(name, ())
                 if s.op.type != "feed"]
        if not sites:
            continue
        writer = sites[-1]
        persistable = _persistable_name(program, writer.block_idx, name)
        if name in writer.op.input_arg_names and persistable:
            diags.append(_mk(
                "donated-buffer-live-read",
                "fetch target %r aliases the buffer op %r updates in "
                "place: with max_in_flight=%d the jitted step donates "
                "its read-write persistables, so step N invalidates "
                "the very buffer step N-1's un-materialized "
                "FetchHandle still reads"
                % (name, writer.op.type, k),
                writer, name,
                hint="materialize the handle before dispatching the "
                     "next step, fetch a copy (assign to a fresh var), "
                     "or drop max_in_flight to 1"))
        elif persistable:
            diags.append(_mk(
                "race-inflight-write",
                "persistable %r is fetched AND written by op %r: with "
                "max_in_flight=%d, step N's scope write-back (donated "
                "buffer) overlaps step N-1's pending FetchHandle read "
                "of the same scope var"
                % (name, writer.op.type, k),
                writer, name,
                hint="fetch a non-persistable copy of the value, or "
                     "materialize each step's handles before the next "
                     "dispatch"))

    # (2) write-write with the prefetch thread: overwriting a fed slot
    for block_idx, op_idx, op in graph.order:
        if op.type == "feed":
            continue
        for name in op.output_arg_names:
            b = program.block(block_idx)
            v = b._find_var_recursive(name)
            if v is None or not getattr(v, "is_data", False):
                continue
            diags.append(Diagnostic(
                "race-inflight-write", Severity.ERROR,
                "op %r overwrites fed data var %r — the double-buffer "
                "feed overwrite: with max_in_flight=%d the "
                "DeviceFeedPipeline prefetch thread stages the next "
                "batch into this slot while the in-flight step's "
                "write is still dispatched"
                % (op.type, name, k),
                block_idx=block_idx, op_idx=op_idx, op_type=op.type,
                op_id=op.attrs.get("__op_id__"), var_names=(name,),
                hint="write results to a fresh var; feed slots belong "
                     "to the feed pipeline"))
    return diags


def find_overlap_window_races(program):
    """The overlap scheduler's in-flight window scan: between a
    ``c_allreduce_start`` and its ``c_allreduce_wait`` (paired by the
    ``overlap_bucket`` attr) the ring transfer holds the bucket members
    in flight — an op writing any member inside that window (output
    slot or sub-block closure write) clobbers the buffer the collective
    is still reducing.  ERROR per (window, writer, member).

    K-independent by design: this is intra-step overlap, not the
    cross-step pipelining :func:`find_inflight_races` models — the
    overlap pass's proof bracket reverts the bucket on any finding."""
    from .defuse import resolve_sub_block, sub_block_writes_recursive

    diags = []
    block = program.global_block()
    open_windows = {}   # bucket -> (start idx, member set)
    for idx, op in enumerate(block.ops):
        if op.type == "c_allreduce_start":
            b = op.attrs.get("overlap_bucket")
            if b is not None:
                open_windows[int(b)] = (
                    idx, frozenset(op.outputs.get("Out", ())))
            continue
        if op.type != "c_allreduce_wait":
            continue
        b = op.attrs.get("overlap_bucket")
        if b is None or int(b) not in open_windows:
            continue
        start_idx, members = open_windows.pop(int(b))
        for j in range(start_idx + 1, idx):
            other = block.ops[j]
            written = members.intersection(other.output_arg_names)
            sub = resolve_sub_block(program, other,
                                    host_block_idx=block.idx)
            if sub is not None:
                written = written | (
                    members
                    & set(sub_block_writes_recursive(program, sub)))
            for name in sorted(written):
                diags.append(Diagnostic(
                    "race-inflight-write", Severity.ERROR,
                    "op %r writes bucket member %r inside the overlap "
                    "window of bucket %d (start at op %d, wait at op "
                    "%d) — the in-flight ring transfer is still "
                    "reducing this buffer"
                    % (other.type, name, int(b), start_idx, idx),
                    block_idx=block.idx, op_idx=j, op_type=other.type,
                    op_id=other.attrs.get("__op_id__"),
                    var_names=(name,),
                    hint="let the overlap pass place the start after "
                         "the member's last def (it reverts the bucket "
                         "to the fused synchronous form when it "
                         "cannot), or write to a fresh var"))
    return diags


# ---------------------------------------------------------------------------
# zero-sync certificate
# ---------------------------------------------------------------------------

class SyncPoint:
    """One host-sync source in a hot loop: where it is, and which
    runtime API introduces the sync."""

    __slots__ = ("api", "reason", "block_idx", "op_idx", "op_type",
                 "var_names", "allowed")

    def __init__(self, api, reason, block_idx=None, op_idx=None,
                 op_type=None, var_names=(), allowed=False):
        self.api = api
        self.reason = reason
        self.block_idx = block_idx
        self.op_idx = op_idx
        self.op_type = op_type
        self.var_names = tuple(var_names)
        self.allowed = bool(allowed)

    def where(self):
        if self.block_idx is None:
            return "program-level"
        return "block %d op %d (%s)" % (self.block_idx, self.op_idx,
                                        self.op_type)

    def to_dict(self):
        return {"api": self.api, "reason": self.reason,
                "block_idx": self.block_idx, "op_idx": self.op_idx,
                "op_type": self.op_type,
                "var_names": list(self.var_names),
                "allowed": self.allowed}

    def __repr__(self):
        return "SyncPoint(%s, %s%s)" % (
            self.api, self.where(), ", allowed" if self.allowed else "")


class ZeroSyncCertificate:
    """The checkable contract: ``ok`` iff the steady-state loop of this
    program contains no host-sync point outside the explicitly allowed
    ones (today: the opt-in NaN step-guard's scalar flag)."""

    __slots__ = ("label", "violations", "allowed", "max_in_flight")

    def __init__(self, label, violations=(), allowed=(),
                 max_in_flight=1):
        self.label = label
        self.violations = list(violations)
        self.allowed = list(allowed)
        self.max_in_flight = max_in_flight

    @property
    def ok(self):
        return not self.violations

    def to_dict(self):
        return {"label": self.label, "ok": self.ok,
                "max_in_flight": self.max_in_flight,
                "violations": [s.to_dict() for s in self.violations],
                "allowed": [s.to_dict() for s in self.allowed]}

    def format(self):
        lines = ["zero-sync certificate for %s: %s"
                 % (self.label, "PASS" if self.ok else "FAIL")]
        for s in self.violations:
            lines.append("  SYNC %s — %s: %s"
                         % (s.where(), s.api, s.reason))
        for s in self.allowed:
            lines.append("  allowed %s — %s: %s"
                         % (s.where(), s.api, s.reason))
        if self.ok and not self.allowed:
            lines.append("  steady-state loop is one pure dispatch — "
                         "no D2H fetch, host-IO, or eager host probe")
        return "\n".join(lines)

    def __repr__(self):
        return "ZeroSyncCertificate(%s, ok=%s, %d violation(s))" % (
            self.label, self.ok, len(self.violations))


def certify_zero_sync(program, targets=(), graph=None, label=None,
                      max_in_flight=None):
    """Scan ``program`` for every construct that forces the Executor
    onto the host each step, and return the
    :class:`ZeroSyncCertificate`.  Sources modeled (each names the
    introducing API, so a FAIL is actionable):

    * host-IO ops (``save``/``load``/...) — ``Executor.run`` brackets
      the jitted step with ``ops.io_ops.run_host_io_block``;
    * host-resident embedding tables (``program._host_tables``) — the
      per-step prefetch/grad-push calls ``np.asarray`` on ids and slab
      grads;
    * an unbounded ``while_grad`` — ``Executor.run`` re-probes trip
      counts with an eager host loop before EVERY dispatch;
    * the NaN step-guard scalar flag — *allowed* (explicitly opted in
      via ``PADDLE_TPU_NAN_GUARD`` / ``program._nan_guard``).
    """
    graph = graph or DefUseGraph(program)
    k = resolve_max_in_flight(program, explicit=max_in_flight)
    violations, allowed = [], []
    for block_idx, op_idx, op in graph.order:
        if op.type in HOST_IO_OP_TYPES:
            violations.append(SyncPoint(
                "Executor.run host-IO phase "
                "(ops.io_ops.run_host_io_block)",
                "host-IO op %r runs on the host around every jitted "
                "step — a full pipeline drain per call" % op.type,
                block_idx=block_idx, op_idx=op_idx, op_type=op.type,
                var_names=tuple(op.output_arg_names
                                or op.input_arg_names)))
        elif op.type == "while_grad" \
                and not op.attrs.get("max_trip_count"):
            violations.append(SyncPoint(
                "executor._probe_trip_counts (eager host probe)",
                "while_grad without max_trip_count makes Executor.run "
                "probe trip counts with an eager host loop before "
                "every dispatch",
                block_idx=block_idx, op_idx=op_idx, op_type=op.type))
    for spec in getattr(program, "_host_tables", None) or ():
        name = getattr(spec, "name", None) or str(spec)
        violations.append(SyncPoint(
            "host_table per-step prefetch/push (np.asarray on ids and "
            "slab grads)",
            "host-resident table %r bounces ids and gradients through "
            "the host every step" % name,
            var_names=(name,)))
    if guard_enabled(program):
        allowed.append(SyncPoint(
            "NaN step-guard finite flag (resilience.guard.record_step)",
            "opted-in scalar sync per step; skip bookkeeping must see "
            "the flag on the host", allowed=True))
    return ZeroSyncCertificate(
        label or getattr(program, "_name", None) or "program",
        violations, allowed, max_in_flight=k)


# ---------------------------------------------------------------------------
# registered checks (active only when an in-flight context exists, so
# the default lint battery is unchanged)
# ---------------------------------------------------------------------------

def _ctx_races(ctx):
    """Compute (and cache on the ctx) the race scan for this battery
    run — both race checks share one walk."""
    cached = getattr(ctx, "_inflight_races", None)
    if cached is None:
        cached = find_inflight_races(
            ctx.program, targets=ctx.targets,
            max_in_flight=getattr(ctx, "max_in_flight", None),
            graph=ctx.graph)
        ctx._inflight_races = cached
    return cached


@register_check("race-inflight-write")
def check_race_inflight_write(ctx):
    """Write-write / write-vs-pending-read races under
    ``max_in_flight>1`` (see :func:`find_inflight_races`)."""
    for d in _ctx_races(ctx):
        if d.check == "race-inflight-write":
            yield d


@register_check("donated-buffer-live-read")
def check_donated_buffer_live_read(ctx):
    """A pending FetchHandle aliasing a buffer a later in-flight step
    donates (see :func:`find_inflight_races`)."""
    for d in _ctx_races(ctx):
        if d.check == "donated-buffer-live-read":
            yield d


@register_check("scope-overlap")
def check_scope_overlap(ctx):
    """Scope-isolation proof against the coresident programs supplied
    via ``analyze(coresident=[...])`` / ``verify_program(coresident=
    ...)``; silent when the program runs alone."""
    coresident = getattr(ctx, "coresident", None)
    if not coresident:
        return
    programs = [ctx.program]
    labels = ["this program"]
    for i, entry in enumerate(coresident):
        if isinstance(entry, tuple):
            labels.append(str(entry[0]))
            programs.append(entry[1])
        else:
            labels.append("coresident[%d]" % i)
            programs.append(entry)
    _, diags = prove_scope_isolation(programs, labels)
    for d in diags:
        yield d


@register_check("sync-in-hot-loop")
def check_sync_in_hot_loop(ctx):
    """The zero-sync certificate as a lint check: every violating sync
    point is an ERROR naming the introducing op and API.  Runs when a
    certificate was requested (``analyze(certify_zero_sync=True)`` /
    ``--certify-zero-sync``) or the program is strict
    (``PADDLE_TPU_STRICT_SYNC=1`` / the serving hot loop)."""
    if not (getattr(ctx, "certify_zero_sync", False)
            or strict_sync_enabled(ctx.program)):
        return
    cert = certify_zero_sync(ctx.program, targets=ctx.targets,
                             graph=ctx.graph)
    for s in cert.violations:
        yield ctx.diag(
            "sync-in-hot-loop", Severity.ERROR,
            "host-sync point in the hot loop at %s — introduced by %s: "
            "%s" % (s.where(), s.api, s.reason),
            block_idx=s.block_idx, op_idx=s.op_idx,
            var_names=s.var_names,
            hint="the steady-state loop must stay one pure dispatch; "
                 "move the sync to step boundaries or a separate "
                 "program (certificate: analyze_program "
                 "--certify-zero-sync)")


# ---------------------------------------------------------------------------
# report driver + gates
# ---------------------------------------------------------------------------

class ConcurrencyReport:
    """What ``Program.analyze(concurrency=True)`` proved: the assumed
    in-flight depth, the race findings, the scope footprint (and
    isolation verdict when coresident programs were supplied), and the
    zero-sync certificate when requested."""

    __slots__ = ("max_in_flight", "races", "isolation", "footprint",
                 "certificate")

    def __init__(self, max_in_flight, races=(), isolation=(),
                 footprint=None, certificate=None):
        self.max_in_flight = max_in_flight
        self.races = list(races)
        self.isolation = list(isolation)
        self.footprint = footprint
        self.certificate = certificate

    @property
    def race_free(self):
        return not self.races

    @property
    def isolated(self):
        return not self.isolation

    def to_dict(self):
        return {
            "max_in_flight": self.max_in_flight,
            "race_free": self.race_free,
            "races": [d.to_dict() for d in self.races],
            "isolated": self.isolated,
            "scope_overlaps": [d.to_dict() for d in self.isolation],
            "footprint": self.footprint.to_dict()
            if self.footprint else None,
            "certificate": self.certificate.to_dict()
            if self.certificate else None,
        }

    def format(self):
        lines = ["concurrency (max_in_flight=%d): %s"
                 % (self.max_in_flight,
                    "race-free" if self.race_free
                    else "%d race(s)" % len(self.races))]
        if self.footprint is not None:
            lines.append("  scope footprint: %d read(s), %d write(s)"
                         % (len(self.footprint.reads),
                            len(self.footprint.writes)))
        if self.isolation:
            lines.append("  scope isolation: VIOLATED (%d overlap(s))"
                         % len(self.isolation))
        if self.certificate is not None:
            lines.append(self.certificate.format())
        return "\n".join(lines)

    def __repr__(self):
        return ("ConcurrencyReport(K=%d, race_free=%s, isolated=%s%s)"
                % (self.max_in_flight, self.race_free, self.isolated,
                   "" if self.certificate is None
                   else ", zero_sync=%s" % self.certificate.ok))


def analyze_concurrency(program, targets=(), max_in_flight=None,
                        coresident=None, certify=False, graph=None):
    """Standalone driver (``Program.analyze(concurrency=True)`` builds
    the same report through the shared check battery).  Assumes K=2
    when nothing specifies a depth — the async serving default — since
    a concurrency question about a sequential program is vacuous."""
    graph = graph or DefUseGraph(program)
    k = resolve_max_in_flight(program, explicit=max_in_flight,
                              default=2)
    races = find_inflight_races(program, targets=targets,
                                max_in_flight=k, graph=graph)
    isolation = []
    if coresident:
        programs = [program] + [e[1] if isinstance(e, tuple) else e
                                for e in coresident]
        labels = ["this program"] + [
            e[0] if isinstance(e, tuple) else "coresident[%d]" % i
            for i, e in enumerate(coresident)]
        _, isolation = prove_scope_isolation(programs, labels)
    cert = certify_zero_sync(program, targets=targets, graph=graph,
                             max_in_flight=k) if certify else None
    report = ConcurrencyReport(k, races, isolation,
                               footprint=scope_footprint(program, graph),
                               certificate=cert)
    from ..observability import runtime as _obs

    _obs.record_concurrency_check(len(races) + len(isolation),
                                  gate="analyze")
    return report


def race_signatures(program, targets=(), max_in_flight=2):
    """Order-insensitive signatures of the race findings — the rewrite
    brackets diff these, so a pass is only blamed for races it
    *introduces* (op indices excluded: removing ops ahead of a
    pre-existing race must not make it look new)."""
    return {(d.check, d.var_names)
            for d in find_inflight_races(program, targets=targets,
                                         max_in_flight=max_in_flight)}


def assert_no_new_races(program, baseline, context, targets=(),
                        max_in_flight=2):
    """Raise :class:`~.verifier.VerifyError` if ``program`` has a race
    signature not in ``baseline`` (from :func:`race_signatures` on the
    pre-rewrite program)."""
    diags = find_inflight_races(program, targets=targets,
                                max_in_flight=max_in_flight)
    new = [d for d in diags
           if (d.check, d.var_names) not in baseline]
    if new:
        from .verifier import VerifyError
        from ..observability import runtime as _obs

        _obs.record_concurrency_check(len(new), gate=context,
                                      tripped=True)
        raise VerifyError(
            format_diagnostics(
                new, header="rewrite introduced a race (%s):" % context),
            diagnostics=new)


def verify_async_hot_path(program, targets=(), max_in_flight=2,
                          label=None):
    """The ``run_batches(..., verify=True)`` gate: race-check the
    program the executor will actually run (the fused twin when fusion
    is enabled) at the requested in-flight depth, and enforce the
    strict-sync promotion for the serving path.  Raises
    :class:`~.verifier.VerifyError` naming every finding; returns the
    (possibly empty) advisory diagnostics otherwise."""
    from .verifier import VerifyError
    from ..observability import runtime as _obs

    checked = program
    try:
        from .fusion import fusion_enabled, resolve_fused_program

        if fusion_enabled():
            checked, _ = resolve_fused_program(program, targets=[
                t.name if hasattr(t, "name") else str(t)
                for t in targets])
    except Exception:
        checked = program  # the gate must not be harder than the run
    graph = DefUseGraph(checked)
    diags = list(find_inflight_races(checked, targets=targets,
                                     max_in_flight=max_in_flight,
                                     graph=graph))
    cert = certify_zero_sync(checked, targets=targets, graph=graph,
                             label=label, max_in_flight=max_in_flight)
    for s in cert.violations:
        diags.append(Diagnostic(
            "sync-in-hot-loop", Severity.ERROR,
            "host-sync point in the serving hot loop at %s — "
            "introduced by %s: %s" % (s.where(), s.api, s.reason),
            block_idx=s.block_idx, op_idx=s.op_idx, op_type=s.op_type,
            var_names=s.var_names,
            hint="run_batches keeps %d step(s) in flight; a per-step "
                 "host sync serializes them" % max_in_flight))
    _obs.record_concurrency_check(len(diags), gate="run_batches",
                                  tripped=bool(diags))
    if diags:
        raise VerifyError(
            format_diagnostics(
                diags,
                header="async hot path failed concurrency verification "
                       "(max_in_flight=%d):" % max_in_flight),
            diagnostics=diags)
    return diags
