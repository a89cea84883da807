"""Overlap scheduler: liveness-driven collective hoisting (mirrors
``paddle_tpu/static_analysis/overlap.py``, all of it).

``resolve_fused_program`` runs it after the fusion families and the
hierarchy pass; ``c_allreduce_start`` issues the bucket's exchange
asynchronously over its ``torch.distributed`` group and
``c_allreduce_wait`` waits on it (``ops/collective.py``).

Fluid's ParallelExecutor overlaps gradient allreduce with backward
compute as a graph-level scheduling decision; after the fusion pipeline
our programs still fire every bucketed collective exactly where the
rewrite dropped it, so ICI-bound plans serialize compute behind wire
time.  Latency hiding is a *schedule* property, not a kernel property
(arXiv 2301.13062): this pass splits each bucketed collective
(``c_fused_allreduce_sum`` / ``c_allreduce_quant``) into a
``c_allreduce_start`` / ``c_allreduce_wait`` pair and schedules them
with a liveness pass over the def-use graph —

* the **start** hoists to the earliest point all bucket members are
  fully defined (just after the last def of any member, including
  sub-block closure writes, and never above a reader that expects the
  un-reduced local value);
* the **wait** sinks to just before the first consumer (the optimizer
  ops; sub-block closure reads count), maximizing the in-flight window
  the device's scheduler can fill with compute.

Every rewritten program is bracketed by both provers:

* **race proof** — a write to any bucket member between start and wait
  is a ``race-inflight-write`` ERROR
  (:func:`~.concurrency.find_overlap_window_races`, K-independent: the
  ring transfer is in flight *within* one step);
* **deadlock proof** — hoisting must preserve the rank-symmetric
  per-ring start order (the pre-rewrite schedule, with each fused
  collective mapped to its start half, must match position-for-position
  per ring), and the rewritten schedule replicated across ranks must
  pass :func:`~.distributed.check_schedule_consistency`.

A failed proof **reverts that bucket** to the fused synchronous form —
the pass never crashes and never ships an unproven schedule.  The pair
is bit-exact with the fused op by construction (the start performs the
identical reduction; the wait is an identity consumer barrier), so
``PADDLE_TPU_OVERLAP=0`` — which keeps the fused form — restores
today's schedule bit-exactly.

Knob precedence (the ``allreduce_bucket_mb`` idiom): the program's
``_overlap`` mark (how the planner scopes its chosen schedule to ONE
program) → ``PADDLE_TPU_OVERLAP`` → default on.
"""

import os

from .defuse import (resolve_sub_block, sub_block_reads_recursive,
                     sub_block_writes_recursive)

__all__ = [
    "OVERLAPPABLE_OP_TYPES", "overlap_enabled", "OverlapDecision",
    "OverlapReport", "apply_overlap_pass",
]

#: the bucketed synchronous collectives the pass splits into pairs
OVERLAPPABLE_OP_TYPES = ("c_fused_allreduce_sum", "c_allreduce_quant")


def _truthy(val):
    return str(val).strip().lower() not in ("0", "", "false", "off",
                                            "none")


def overlap_enabled(program=None):
    """Is overlap scheduling on for this program?  The program's
    ``_overlap`` mark wins (the planner's in-place apply stamps it so a
    plan scopes its schedule to one program instead of leaking a
    process-global env change), else ``PADDLE_TPU_OVERLAP``, default
    on.  ``PADDLE_TPU_OVERLAP=0`` is the kill switch that restores the
    fused synchronous schedule bit-exactly."""
    mark = getattr(program, "_overlap", None) if program is not None \
        else None
    if mark is not None:
        return _truthy(mark)
    return os.environ.get("PADDLE_TPU_OVERLAP", "1").strip() != "0"


class OverlapDecision:
    """What the pass did with one bucketed collective: the pair's final
    op coordinates when applied, or why the bucket kept its fused
    synchronous form."""

    __slots__ = ("bucket", "op_type", "ring_id", "vars", "fused_idx",
                 "start_idx", "wait_idx", "window_ops", "status",
                 "note", "quant")

    #: status values: ``applied`` (pair scheduled, proofs passed),
    #: ``no-window`` (hoist/sink left zero ops in flight — splitting
    #: buys nothing), ``reverted-race`` / ``reverted-deadlock`` (a
    #: proof failed; the fused form was kept)
    def __init__(self, bucket, op_type, ring_id, vars, fused_idx,
                 start_idx=None, wait_idx=None, window_ops=0,
                 status="applied", note="", quant=False):
        self.bucket = int(bucket)
        self.op_type = op_type
        self.ring_id = ring_id
        self.vars = tuple(vars)
        self.fused_idx = fused_idx      # coordinate of the fused op
        self.start_idx = start_idx      # final coordinate of the start
        self.wait_idx = wait_idx        # final coordinate of the wait
        self.window_ops = int(window_ops)
        self.status = status
        self.note = note
        self.quant = bool(quant)

    def to_dict(self):
        return {"bucket": self.bucket, "op_type": self.op_type,
                "ring_id": self.ring_id, "vars": list(self.vars),
                "fused_idx": self.fused_idx,
                "start_idx": self.start_idx, "wait_idx": self.wait_idx,
                "window_ops": self.window_ops, "status": self.status,
                "note": self.note, "quant": self.quant}

    def __repr__(self):
        if self.status == "applied":
            return ("[overlap] bucket %d (%d vars, ring %r%s): start@%s "
                    "wait@%s, %d ops in flight") % (
                self.bucket, len(self.vars), self.ring_id,
                ", int8" if self.quant else "", self.start_idx,
                self.wait_idx, self.window_ops)
        return "[overlap] bucket %d (%d vars, ring %r): %s%s" % (
            self.bucket, len(self.vars), self.ring_id, self.status,
            " — %s" % self.note if self.note else "")


class OverlapReport:
    """Outcome of one overlap pass over one program."""

    def __init__(self, enabled=True):
        self.enabled = enabled
        self.decisions = []
        self.note = ""

    @property
    def applied(self):
        return [d for d in self.decisions if d.status == "applied"]

    @property
    def reverted(self):
        return [d for d in self.decisions
                if d.status.startswith("reverted")]

    def to_dict(self):
        return {"enabled": self.enabled,
                "decisions": [d.to_dict() for d in self.decisions]}

    def format(self):
        lines = ["overlap report (%d applied, %d kept synchronous; %s)"
                 % (len(self.applied),
                    len(self.decisions) - len(self.applied),
                    "enabled" if self.enabled
                    else "DISABLED (PADDLE_TPU_OVERLAP=0)")]
        for d in self.decisions:
            lines.append("  %r" % d)
        return "\n".join(lines)

    def __repr__(self):
        return self.format()


# ---------------------------------------------------------------------------
# liveness planning
# ---------------------------------------------------------------------------

def _op_writes(program, block, op, members):
    """Member names ``op`` writes — output slots plus sub-block closure
    writes (a while body updating a grad is a write no slot shows)."""
    hit = members.intersection(op.output_arg_names)
    sub = resolve_sub_block(program, op, host_block_idx=block.idx)
    if sub is not None:
        hit = hit | (members
                     & set(sub_block_writes_recursive(program, sub)))
    return hit


def _op_reads(program, block, op, members):
    hit = members.intersection(op.input_arg_names)
    sub = resolve_sub_block(program, op, host_block_idx=block.idx)
    if sub is not None:
        hit = hit | (members
                     & set(sub_block_reads_recursive(program, sub)))
    return hit


def _start_position(program, block, members, fused_idx):
    """Earliest legal insertion index for the start op: just after the
    last def of any member (closure writes included), then pushed below
    any reader of the still-un-reduced value — a reader between the last
    def and the fused site expects the LOCAL gradient, and hoisting the
    reduction above it would hand it the ring sum (a semantics change no
    write-race scan would catch)."""
    pos = 0
    for j in range(fused_idx):
        if _op_writes(program, block, block.ops[j], members):
            pos = j + 1
    for j in range(pos, fused_idx):
        if _op_reads(program, block, block.ops[j], members):
            pos = j + 1
    return pos


def _wait_position(program, block, members, fused_idx):
    """Insertion index for the wait op: just before the first op after
    the fused site that touches any member (the optimizer reads the
    reduced grad; closure reads count; a write would also need the
    reduction settled).  No consumer → the end of the block, so the
    step's final state is the reduced value."""
    for j in range(fused_idx + 1, len(block.ops)):
        op = block.ops[j]
        if _op_reads(program, block, op, members) \
                or _op_writes(program, block, op, members):
            return j
    return len(block.ops)


def _plan(program, targets, exclude):
    """One planning sweep over the global block: a list of
    :class:`OverlapDecision` (bucket ids are the sequence index over
    bucketed collectives in program order — stable across revert
    retries because the block is restored before each sweep), plus the
    rebuild schedule for the applied ones."""
    block = program.global_block()
    decisions = []
    schedule = []   # (decision, fused_idx, start_pos, wait_pos, ops)
    bucket = -1
    for fi, op in enumerate(block.ops):
        if op.type not in OVERLAPPABLE_OP_TYPES:
            continue
        if op.attrs.get("hier_groups"):
            # the cross-slice hop of a hierarchical decomposition: it
            # reuses the allreduce op types but its ring is the DCN
            # group — splitting it into a start/wait pair would drop
            # the group attrs and mis-lower to a full-ring collective
            continue
        bucket += 1
        members = frozenset(op.inputs.get("X", ()))
        quant = op.type == "c_allreduce_quant"
        dec = OverlapDecision(
            bucket, op.type, op.attrs.get("ring_id"),
            sorted(members), fused_idx=(block.idx, fi), quant=quant)
        if bucket in exclude:
            dec.status, dec.note = exclude[bucket]
            decisions.append(dec)
            continue
        start_pos = _start_position(program, block, members, fi)
        wait_pos = _wait_position(program, block, members, fi)
        # window = ops left in flight once the fused op itself is gone
        window = (wait_pos - start_pos) - 1
        if window <= 0:
            dec.status = "no-window"
            dec.note = ("last member def and first consumer are "
                        "adjacent — nothing to hide the wire under")
            decisions.append(dec)
            continue
        dec.window_ops = window
        schedule.append((dec, fi, start_pos, wait_pos,
                         _make_pair(block, op, bucket, members)))
        decisions.append(dec)
    return decisions, schedule


def _make_pair(block, fused_op, bucket, members):
    """Build the start/wait twins of one fused collective.  The start
    carries the whole reduction (quant path included) so the pair is
    bit-exact with the fused op; ``overlap_bucket`` links the twins for
    the cost model, the provers, and the lint pairing checks."""
    from ..framework import Operator

    names = list(fused_op.inputs.get("X", ()))
    base = {"ring_id": fused_op.attrs.get("ring_id"),
            "op_role": "backward", "overlap_bucket": int(bucket)}
    start_attrs = dict(base)
    if fused_op.attrs.get("pre_scale"):
        start_attrs["pre_scale"] = fused_op.attrs["pre_scale"]
    if fused_op.type == "c_allreduce_quant":
        start_attrs["quant"] = True
        if fused_op.attrs.get("quant_block"):
            start_attrs["quant_block"] = fused_op.attrs["quant_block"]
    start = Operator(block, "c_allreduce_start", {"X": names},
                     {"Out": list(names)}, start_attrs)
    wait = Operator(block, "c_allreduce_wait", {"X": names},
                    {"Out": list(names)}, dict(base))
    return start, wait


def _rebuild(block, schedule):
    """Apply the planned splits in one block rebuild: drop each fused
    op, insert its start before the hoist index and its wait before the
    sink index.  Waits emit before starts at a shared index (an earlier
    bucket's window closes before a later bucket's opens there)."""
    starts, waits, removed = {}, {}, set()
    for dec, fi, start_pos, wait_pos, (start, wait) in schedule:
        starts.setdefault(start_pos, []).append(start)
        waits.setdefault(wait_pos, []).append(wait)
        removed.add(fi)
    new_ops = []
    for i in range(len(block.ops) + 1):
        new_ops.extend(waits.get(i, ()))
        new_ops.extend(starts.get(i, ()))
        if i < len(block.ops) and i not in removed:
            new_ops.append(block.ops[i])
    block.ops[:] = new_ops
    block.program._bump_version()


def _stamp_final_coords(block, decisions):
    """Record each decision's final op coordinates in the rewritten
    program: start/wait by their ``overlap_bucket`` attr, kept-fused
    buckets by sequence over the surviving bucketed collectives."""
    by_bucket = {d.bucket: d for d in decisions}
    fused_seq = iter(sorted(
        d.bucket for d in decisions if d.status != "applied"))
    for idx, op in enumerate(block.ops):
        if op.type == "c_allreduce_start":
            d = by_bucket.get(op.attrs.get("overlap_bucket"))
            if d is not None:
                d.start_idx = (block.idx, idx)
        elif op.type == "c_allreduce_wait":
            d = by_bucket.get(op.attrs.get("overlap_bucket"))
            if d is not None:
                d.wait_idx = (block.idx, idx)
        elif op.type in OVERLAPPABLE_OP_TYPES:
            b = next(fused_seq, None)
            if b is not None:
                by_bucket[b].fused_idx = (block.idx, idx)


# ---------------------------------------------------------------------------
# the proof bracket
# ---------------------------------------------------------------------------

def _normalized_ring_order(sched):
    """Per-ring signature sequences with the fused↔start identity
    applied: a fused collective and the start half of its split pair
    are the SAME rendezvous, so mapping both onto the start kind lets
    the pre- and post-rewrite schedules compare position-for-position.
    Wire identity (int8 vs dense dtype, coalesced numel) is preserved
    by the extraction itself."""
    out = {}
    for ring, evs in sched.items():
        sigs = []
        for e in evs:
            kind = e.kind
            if kind in OVERLAPPABLE_OP_TYPES:
                kind = "c_allreduce_start"
            sigs.append((kind, str(e.dtype), e.numel))
        out[ring] = sigs
    return out


def _prove(program, pre_schedule, nranks, decisions):
    """Run both proofs over the rewritten program.  Returns a dict of
    ``bucket -> (status, note)`` for every bucket a proof rejects
    (empty = both proofs PASS)."""
    from .concurrency import find_overlap_window_races
    from .distributed import (check_schedule_consistency,
                              extract_collective_schedule)

    offenders = {}
    applied = [d for d in decisions if d.status == "applied"]

    # ---- race proof: no write to a member inside its window ----
    for diag in find_overlap_window_races(program):
        hit = set(diag.var_names)
        for d in applied:
            if d.bucket in offenders or not hit & set(d.vars):
                continue
            offenders[d.bucket] = (
                "reverted-race",
                "in-flight write: %s" % diag.message.split(":")[0])

    # ---- deadlock proof: rank-symmetric per-ring start order ----
    post_schedule = extract_collective_schedule(program, nranks=nranks)
    pre = _normalized_ring_order(pre_schedule)
    post = _normalized_ring_order(post_schedule)
    bad_rings = {r for r in set(pre) | set(post)
                 if pre.get(r, []) != post.get(r, [])}
    diags = check_schedule_consistency(
        [post_schedule] * max(int(nranks or 2), 2))
    if diags:
        # a replicated-schedule inconsistency implicates every ring the
        # rewrite touched — conservative, and the revert loop converges
        bad_rings.update(d.ring_id for d in applied)
    for d in applied:
        if d.bucket not in offenders and d.ring_id in bad_rings:
            offenders[d.bucket] = (
                "reverted-deadlock",
                "hoist would reorder ring %r collectives across ranks"
                % (d.ring_id,))
    return offenders


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def apply_overlap_pass(program, targets=(), nranks=None):
    """Split + schedule every provable bucket of ``program`` IN PLACE
    (run it on the resolved clone, never the user's program); returns
    the :class:`OverlapReport`, also stamped on the program as
    ``_overlap_report``.

    Revert loop: plan → rebuild → prove; any bucket a proof rejects is
    excluded and the whole rewrite replans from the pristine op list,
    so a reverted bucket's fused op sits at its ORIGINAL position
    (schedule identity with the kill switch, not an approximation).
    Bounded by the bucket count, so it always terminates.
    """
    report = OverlapReport(enabled=overlap_enabled(program))
    program._overlap_report = report
    if not report.enabled:
        return report
    block = program.global_block()
    if not any(op.type in OVERLAPPABLE_OP_TYPES for op in block.ops):
        return report
    if nranks is None:
        nranks = getattr(program, "_num_trainers", None) or 2

    from .distributed import extract_collective_schedule

    try:
        pre_schedule = extract_collective_schedule(program,
                                                   nranks=nranks)
    except Exception as e:  # noqa: BLE001 - never break resolve
        report.decisions = []
        report.note = "schedule extraction failed: %s" % e
        return report

    orig_ops = list(block.ops)
    exclude = {}
    for _ in range(len(orig_ops) + 1):
        block.ops[:] = list(orig_ops)
        program._bump_version()
        decisions, schedule = _plan(program, targets, exclude)
        if not schedule:
            # nothing (left) to split — the block is already pristine
            _stamp_final_coords(block, decisions)
            report.decisions = decisions
            return report
        _rebuild(block, schedule)
        offenders = _prove(program, pre_schedule, nranks, decisions)
        if not offenders:
            _stamp_final_coords(block, decisions)
            report.decisions = decisions
            return report
        exclude.update(offenders)
    # unreachable unless a proof keeps rejecting fresh buckets beyond
    # the bucket count; keep the synchronous schedule rather than crash
    block.ops[:] = orig_ops
    program._bump_version()
    decisions, _ = _plan(program, targets,
                         dict.fromkeys(exclude,
                                       ("reverted-deadlock", "")))
    report.decisions = decisions
    return report
