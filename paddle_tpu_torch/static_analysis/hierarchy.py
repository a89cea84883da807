"""Hierarchical collective decomposition (the multi-tier rewrite of the
flat data-parallel allreduce; arXiv 2110.10548's slice/pod hierarchy)
(mirrors ``paddle_tpu/static_analysis/hierarchy.py``, all of it).

``resolve_fused_program`` runs it after the fusion families and
before the overlap scheduler; the ``c_hier_*`` ops exchange over
subgroups of the ring's ``torch.distributed`` group
(``ops/collective.py``).

A flat ``c_allreduce_sum`` / ``c_fused_allreduce_sum`` /
``c_allreduce_quant`` whose ring spans slices moves the FULL bucket over
the slow DCN tier: ring volume ``2B(n-1)/n`` priced at DCN bandwidth.
The hierarchical form decomposes it into

    reduce-scatter within the slice   (ring 5, ICI, payload B)
    allreduce across slices           (ring 6, DCN, payload B/c)
    allgather back within the slice   (ring 5, ICI, payload B)

so only ``2*(B/c)*(s-1)/s`` bytes cross the slow tier — a ~c× cut, and
the hop where the int8 wire format pays most (EQuARX,
arXiv 2506.17615): a quantized bucket keeps its int8 exchange on the
cross-slice hop while the intra-slice hops stay dense.

Like the overlap scheduler this is a *proved* rewrite: every emitted
schedule is re-checked by the deadlock prover (schedule extraction +
:func:`check_schedule_consistency` + payload conservation per bucket)
and the race prover (:func:`race_signatures` delta), and any offending
bucket reverts to its flat form — ``PADDLE_TPU_HIERARCHY=0`` (or a
topology-free ClusterSpec) keeps the flat schedule bit-exactly.

Ring-id conventions (established in ``parallel/``): 0=dp, 1=pipe,
2=moe, 3=ulysses, 4=ring-attention — the hierarchy claims 5 (intra-
slice) and 6 (cross-slice).
"""

import os

from ..framework import Operator
from .concurrency import race_signatures
from .distributed import extract_collective_schedule, \
    check_schedule_consistency

__all__ = [
    "HIER_SLICE_RING", "HIER_CROSS_RING", "HIER_OP_TYPES",
    "HierarchyDecision", "HierarchyReport", "hierarchy_enabled",
    "hierarchy_topology", "hierarchy_min_bytes", "hierarchy_signature",
    "apply_hierarchy_pass",
]

HIER_SLICE_RING = 5   # intra-slice hops (reduce-scatter / allgather, ICI)
HIER_CROSS_RING = 6   # cross-slice hop (allreduce, DCN)

# flat forms the rewrite decomposes (ring 0 / data-parallel only)
HIER_OP_TYPES = ("c_allreduce_sum", "c_fused_allreduce_sum",
                 "c_allreduce_quant")


def _truthy(v):
    return str(v).strip().lower() not in ("", "0", "false", "no", "off")


def hierarchy_enabled(program=None):
    """Kill-switch resolution: program mark ``_hierarchy`` wins (False
    disables; a dict or True enables), else ``PADDLE_TPU_HIERARCHY``
    (default on — but the pass is still inert without a topology)."""
    mark = getattr(program, "_hierarchy", None) if program is not None \
        else None
    if mark is not None:
        return bool(mark)
    return _truthy(os.environ.get("PADDLE_TPU_HIERARCHY", "1"))


def hierarchy_topology(program=None, nranks=None, spec=None):
    """Resolve chips-per-slice ``c`` for the rewrite, or None when no
    topology is known.  Precedence: explicit ``spec`` arg > the
    ``_hierarchy`` mark's dict > the ``_cluster_spec`` mark >
    ``PADDLE_TPU_CLUSTER_SPEC`` — mirroring the quant/bucket mark
    precedence the planner stamps."""
    mark = getattr(program, "_hierarchy", None) if program is not None \
        else None
    if isinstance(mark, dict):
        c = mark.get("chips_per_slice")
        if c:
            return int(c)
        slices = int(mark.get("slices") or 0)
        if slices > 1 and nranks and nranks % slices == 0:
            return nranks // slices
    from ..parallel.planner import ClusterSpec

    if spec is None:
        raw = getattr(program, "_cluster_spec", None) \
            if program is not None else None
        if raw is None:
            raw = os.environ.get("PADDLE_TPU_CLUSTER_SPEC") or None
        if raw is None:
            return None
        try:
            spec = ClusterSpec.coerce(raw)
        except (ValueError, TypeError):
            return None
    if not getattr(spec, "has_topology", False):
        return None
    return int(spec.chips_per_slice)


def hierarchy_min_bytes(program=None):
    """Bucket-size floor: below it the DCN saving can't beat the two
    extra launches.  Mark dict ``min_bytes`` > env > 0."""
    mark = getattr(program, "_hierarchy", None) if program is not None \
        else None
    if isinstance(mark, dict) and mark.get("min_bytes") is not None:
        return int(mark["min_bytes"])
    try:
        return int(os.environ.get("PADDLE_TPU_HIERARCHY_MIN_BYTES", "0"))
    except ValueError:
        return 0


def hierarchy_signature(program=None):
    """Hashable identity of every knob the pass reads — folded into
    ``FusionConfig.signature`` so stamping a topology (or a
    ``PADDLE_TPU_CLUSTER_SPEC`` change) after a resolve invalidates the
    cached fused clone, exactly like the quant/overlap signature
    fixes."""
    mark = getattr(program, "_hierarchy", None) if program is not None \
        else None
    spec = getattr(program, "_cluster_spec", None) \
        if program is not None else None
    if spec is None:
        spec = os.environ.get("PADDLE_TPU_CLUSTER_SPEC") or None
    return (hierarchy_enabled(program), repr(mark), repr(spec),
            hierarchy_min_bytes(program))


_DTYPE_BYTES = {"float32": 4, "float64": 8, "float16": 2, "bfloat16": 2,
                "int32": 4, "int64": 8, "int8": 1, "uint8": 1, "bool": 1}


def _var_numel(block, name):
    v = block._find_var_recursive(name)
    if v is None or v.shape is None:
        return None
    n = 1
    for d in v.shape:
        if d is None or int(d) < 0:
            return None  # dynamic dim: not statically decomposable
        n *= int(d)
    return n


class HierarchyDecision:
    """One flat collective's verdict.  ``status``: applied / skipped /
    reverted-race / reverted-deadlock, with ``note`` carrying the
    reason (mirrors the overlap scheduler's decision discipline)."""

    __slots__ = ("bucket", "op_type", "ring_id", "vars", "op_idx",
                 "chips", "slices", "numel", "quant", "status", "note")

    def __init__(self, bucket, op_type, ring_id, vars, op_idx, chips=0,
                 slices=0, numel=0, quant=False, status="skipped",
                 note=""):
        self.bucket = bucket
        self.op_type = op_type
        self.ring_id = ring_id
        self.vars = tuple(vars)
        self.op_idx = op_idx
        self.chips = chips
        self.slices = slices
        self.numel = numel
        self.quant = quant
        self.status = status
        self.note = note

    def to_dict(self):
        return {
            "bucket": self.bucket, "op_type": self.op_type,
            "ring_id": self.ring_id, "vars": list(self.vars),
            "op_idx": self.op_idx, "chips": self.chips,
            "slices": self.slices, "numel": self.numel,
            "quant": self.quant, "status": self.status,
            "note": self.note,
        }

    def __repr__(self):
        return "HierarchyDecision(bucket=%d %s ring=%r %s%s)" % (
            self.bucket, self.op_type, self.ring_id, self.status,
            ": %s" % self.note if self.note else "")


class HierarchyReport:
    """Stamped on the resolved program as ``_hierarchy_report`` —
    the auditable record of what decomposed, what didn't, and why."""

    __slots__ = ("enabled", "chips_per_slice", "slices", "decisions",
                 "note")

    def __init__(self, enabled, chips_per_slice=0, slices=0,
                 decisions=None, note=""):
        self.enabled = enabled
        self.chips_per_slice = chips_per_slice
        self.slices = slices
        self.decisions = list(decisions or ())
        self.note = note

    @property
    def applied(self):
        return [d for d in self.decisions if d.status == "applied"]

    @property
    def reverted(self):
        return [d for d in self.decisions
                if d.status.startswith("reverted")]

    def to_dict(self):
        return {
            "enabled": self.enabled,
            "chips_per_slice": self.chips_per_slice,
            "slices": self.slices,
            "note": self.note,
            "decisions": [d.to_dict() for d in self.decisions],
        }

    def format(self):
        lines = ["hierarchy: enabled=%s chips_per_slice=%d slices=%d%s"
                 % (self.enabled, self.chips_per_slice, self.slices,
                    " (%s)" % self.note if self.note else "")]
        for d in self.decisions:
            lines.append(
                "  bucket %d %s x%d [%d vars] -> %s%s"
                % (d.bucket, d.op_type, d.numel, len(d.vars), d.status,
                   ": %s" % d.note if d.note else ""))
        return "\n".join(lines)


def _plan(program, c, nranks, min_bytes, exclude):
    """Decide per flat collective.  Returns (decisions, schedule) where
    schedule = [(op_idx, op, members, total_numel, decision)]."""
    block = program.global_block()
    decisions = []
    schedule = []
    bucket = 0
    s = nranks // c
    for idx, op in enumerate(block.ops):
        if op.type not in HIER_OP_TYPES:
            continue
        if op.attrs.get("hier_groups"):
            continue  # already a decomposition product
        members = list(op.inputs.get("X", ()))
        d = HierarchyDecision(
            bucket, op.type, op.attrs.get("ring_id"), members, idx,
            chips=c, slices=s, quant=(op.type == "c_allreduce_quant"))
        bucket += 1
        decisions.append(d)
        if op.attrs.get("ring_id", 0) not in (0, None):
            d.note = "ring %r is not the data-parallel ring" \
                % op.attrs.get("ring_id")
            continue
        if not members or \
                set(members) != set(op.outputs.get("Out", ())):
            d.note = "not an in-place allreduce"
            continue
        key = frozenset(members)
        if key in exclude:
            d.status, d.note = exclude[key]
            continue
        numels = [_var_numel(block, n) for n in members]
        if any(n is None for n in numels):
            d.note = "non-static member shape"
            continue
        total = sum(numels)
        d.numel = total
        v0 = block._find_var_recursive(members[0])
        nbytes = total * _DTYPE_BYTES.get(str(v0.dtype), 4)
        if nbytes < min_bytes:
            d.note = "below min_bytes (%d < %d)" % (nbytes, min_bytes)
            continue
        schedule.append((idx, op, members, total, d))
    return decisions, schedule


def _decompose(block, op, members, total, k, c, s):
    """The three replacement ops for bucket ``k``: RS (ring 5) ->
    cross allreduce (ring 6) -> AG (ring 5).  The chunk buffer is
    padded to a multiple of ``c`` so the tiled reduce-scatter splits
    evenly; the allgather trims the pad back."""
    v0 = block._find_var_recursive(members[0])
    chunk_len = -(-total // c)          # ceil
    chunk_name = "hier_chunk_%d" % k
    block.create_var(name=chunk_name, shape=[chunk_len], dtype=v0.dtype,
                     persistable=False)
    quant = op.type == "c_allreduce_quant"
    role = op.attrs.get("op_role", "backward")
    member_shapes = [list(block._find_var_recursive(n).shape)
                     for n in members]
    common = {"hier_bucket": k, "hier_chips": c, "hier_slices": s,
              "op_role": role}
    rs_attrs = dict(common, ring_id=HIER_SLICE_RING, comm_nranks=c,
                    tier="ici", hier_groups="slice", hier_total=total)
    if op.attrs.get("pre_scale"):
        rs_attrs["pre_scale"] = op.attrs["pre_scale"]
    rs = Operator(block, "c_hier_reducescatter", {"X": members},
                  {"Out": [chunk_name]}, rs_attrs)
    cross_attrs = dict(common, ring_id=HIER_CROSS_RING, comm_nranks=s,
                       tier="dcn", hier_groups="cross")
    if quant and op.attrs.get("quant_block"):
        cross_attrs["quant_block"] = op.attrs["quant_block"]
    cross = Operator(
        block, "c_allreduce_quant" if quant else "c_allreduce_sum",
        {"X": [chunk_name]}, {"Out": [chunk_name]}, cross_attrs)
    ag_attrs = dict(common, ring_id=HIER_SLICE_RING, comm_nranks=c,
                    tier="ici", hier_groups="slice", hier_total=total,
                    member_shapes=member_shapes)
    ag = Operator(block, "c_hier_allgather", {"X": [chunk_name]},
                  {"Out": members}, ag_attrs)
    return [rs, cross, ag]


def _rebuild(block, schedule, c, s):
    """Whole-block rebuild: each planned flat op is replaced in place
    by its three-op decomposition (schedule order preserved — the
    rewrite never reorders relative to compute or other collectives)."""
    planned = {idx: (op, members, total, d)
               for idx, op, members, total, d in schedule}
    new_ops = []
    for idx, op in enumerate(block.ops):
        hit = planned.get(idx)
        if hit is None:
            new_ops.append(op)
            continue
        _, members, total, d = hit
        d.op_idx = len(new_ops)
        new_ops.extend(_decompose(block, op, members, total, d.bucket,
                                  c, s))
        d.status = "applied"
        d.note = ""
    block.ops[:] = new_ops
    block.program._bump_version()


def _prove(program, nranks, c, schedule, baseline_races):
    """Re-prove the rewritten program; returns {member-frozenset:
    (status, note)} offenders (empty = proven).

    Race prover: :func:`race_signatures` delta vs the flat
    baseline — any NEW race introduced by a bucket's chunk buffer or
    members reverts that bucket.  Deadlock prover: extract the
    schedule, replicate across ``nranks`` symmetric workers, and run
    :func:`check_schedule_consistency` (per-ring sequences + rendezvous
    simulation over rings 0/5/6); plus per-bucket payload conservation
    — the RS and AG must move the full bucket on ring 5 and the cross
    hop exactly ceil(total/c) elements on ring 6."""
    offenders = {}
    by_bucket = {d.bucket: (frozenset(members), total, d)
                 for _, _, members, total, d in schedule}

    def _blame(var_names, status, note):
        hit = False
        for key, total, d in by_bucket.values():
            chunk = "hier_chunk_%d" % d.bucket
            if any(v and (v in key or chunk in v) for v in var_names):
                offenders[key] = (status, note)
                hit = True
        if not hit:  # unattributable: revert everything this round
            for key, total, d in by_bucket.values():
                offenders[key] = (status, note)

    new_races = race_signatures(program) - baseline_races
    for check, var_names in sorted(new_races):
        _blame(var_names, "reverted-race",
               "new race (%s) on %s" % (check, ",".join(var_names)))
    if offenders:
        return offenders

    post = extract_collective_schedule(program, nranks=nranks)
    diags = check_schedule_consistency([post] * max(nranks, 2))
    for dg in diags:
        _blame(dg.var_names, "reverted-deadlock", dg.message)
    if offenders:
        return offenders

    # payload conservation per bucket across the three hops
    slice_evs = {}
    cross_evs = {}
    for ev in post.get(HIER_SLICE_RING, ()):
        slice_evs.setdefault(ev.kind, []).append(ev)
    for ev in post.get(HIER_CROSS_RING, ()):
        cross_evs.setdefault(ev.kind, []).append(ev)
    n_applied = len(by_bucket)
    rs_n = len(slice_evs.get("c_hier_reducescatter", ()))
    ag_n = len(slice_evs.get("c_hier_allgather", ()))
    cr_n = sum(len(v) for v in cross_evs.values())
    if (rs_n, ag_n, cr_n) != (n_applied, n_applied, n_applied):
        _blame((), "reverted-deadlock",
               "decomposition dropped a hop: %d buckets -> %d RS, "
               "%d cross, %d AG" % (n_applied, rs_n, cr_n, ag_n))
        return offenders
    totals = sorted(t for _, t, _ in by_bucket.values())
    chunks = sorted(-(-t // c) for t in totals)
    if sorted(e.numel for e in slice_evs.get(
            "c_hier_reducescatter", ())) != totals \
            or sorted(e.numel for e in slice_evs.get(
                "c_hier_allgather", ())) != totals \
            or sorted(e.numel for v in cross_evs.values()
                      for e in v) != chunks:
        _blame((), "reverted-deadlock",
               "payload not conserved across the RS/cross/AG hops")
    return offenders


def apply_hierarchy_pass(program, targets=(), nranks=None, spec=None):
    """Decompose spanning flat collectives, prove, revert offenders.

    Bounded revert loop exactly like the overlap scheduler's: restore
    the flat ops, re-plan with the offending buckets excluded, rebuild,
    re-prove — each iteration excludes at least one bucket, so it
    terminates.  Stamps ``program._hierarchy_report``; returns True
    when at least one bucket decomposed."""
    enabled = hierarchy_enabled(program)
    report = HierarchyReport(enabled)
    program._hierarchy_report = report
    if not enabled:
        report.note = "disabled"
        return False
    nranks = int(nranks or getattr(program, "_num_trainers", 0) or 0)
    if nranks < 2:
        report.note = "single worker"
        return False
    c = hierarchy_topology(program, nranks=nranks, spec=spec)
    if not c:
        report.note = "no topology in ClusterSpec"
        return False
    if nranks <= c:
        report.note = "ring fits inside one slice (%d <= %d)" \
            % (nranks, c)
        return False
    if nranks % c:
        report.note = "asymmetric topology: nranks=%d not divisible " \
            "by chips_per_slice=%d" % (nranks, c)
        return False
    report.chips_per_slice = c
    report.slices = nranks // c
    min_bytes = hierarchy_min_bytes(program)
    block = program.global_block()
    orig_ops = list(block.ops)
    baseline_races = race_signatures(program)
    exclude = {}
    for _ in range(len(orig_ops) + 1):
        block.ops[:] = list(orig_ops)
        program._bump_version()
        decisions, schedule = _plan(program, c, nranks, min_bytes,
                                    exclude)
        report.decisions = decisions
        if not schedule:
            return False
        _rebuild(block, schedule, c, report.slices)
        offenders = _prove(program, nranks, c, schedule,
                           baseline_races)
        if not offenders:
            return True
        exclude.update(offenders)
    block.ops[:] = list(orig_ops)  # unreachable safety net
    program._bump_version()
    return False
