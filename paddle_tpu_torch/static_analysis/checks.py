"""Built-in verifier checks + the check registry (mirrors
``paddle_tpu/static_analysis/checks.py``, all of it: the registry, the
lazy ``VerifyContext`` and the 24 checks in the reference's order; the
four concurrency checks register after them from :mod:`.concurrency`).
Messages and hints are the reference's text, so both packages report
the same diagnostics for the same program.

Where the port differs: ``shape-dtype-drift`` re-infers each op on
``meta`` tensors (``ops.registry.infer_output_structs``) where the
reference runs ``jax.eval_shape``; ``manual-plan-suboptimal`` raises
``NotImplementedError`` where the reference would run its planner's
search, which is not ported (ROADMAP.md, Queue A item 9) — it stays
silent without a cluster spec, as in the reference; and
``overlap-opportunity-unexploited`` reports a fused bucket with a
window that the reference's resolve would split next, since the
port's resolve does not run the overlap pass yet (Queue A item 7).

Each check is a generator ``fn(ctx) -> Iterable[Diagnostic]`` registered
under a stable id, mirroring ``analysis.register_pass``; custom checks
register the same way::

    from paddle_tpu_torch.static_analysis import (register_check,
                                                  Diagnostic, Severity)

    @register_check("no-print-ops")
    def no_print_ops(ctx):
        for block_idx, op_idx, op in ctx.graph.order:
            if op.type == "print":
                yield ctx.diag("no-print-ops", Severity.WARNING,
                               "print op in production program",
                               block_idx=block_idx, op_idx=op_idx, op=op)

The catalog (see README "Static analysis / lint"):

==========================  ========  ====================================
check id                    severity  violation
==========================  ========  ====================================
use-before-def              ERROR     non-persistable var read before any
                                      write (or never declared at all)
double-write                ERROR/W   second blind write to a var (ERROR
                                      for persistables: donated-buffer
                                      aliasing hazard; WARNING otherwise)
shape-dtype-drift           ERROR/W   re-inferred output dtype (ERROR) or
                                      static shape (WARNING) disagrees
                                      with recorded Variable metadata
orphaned-fetch              ERROR     fetch target neither produced, fed,
                                      nor persistable (or missing wholly)
sub-block-index             ERROR     attrs["sub_block"] out of range or
                                      self-referential
collective-ring             ERROR/W   collective op missing ring_id or
                                      send_v2/recv_v2 missing peer
                                      (ERROR); c_gen_nccl_id without a
                                      matching c_comm_init (WARNING)
unreferenced-op             INFO      op output never read / fetched —
                                      advisory twin of DCE
resilience-finite-guard     INFO      training program fetches its loss
                                      but no NaN/Inf step-guard is
                                      enabled (PADDLE_TPU_NAN_GUARD /
                                      program._nan_guard)
peak-memory-over-budget     ERROR     liveness peak-memory estimate
                                      exceeds the configured HBM budget
                                      (PADDLE_TPU_HBM_BUDGET /
                                      program._hbm_budget)
collective-schedule-        ERROR     cross-worker collective schedules
divergence                            diverge (kind/dtype/numel/order,
                                      or mispaired p2p) — runs when the
                                      per-worker programs are supplied
degenerate-sharding         WARNING   var marked sharded over parts the
                                      tensor dim cannot fill (or fill
                                      evenly) — silently degenerate
                                      distribution
oversized-replicated-       WARNING   replicated persistable larger
persistable                           than the replication budget on a
                                      multi-worker program — shard it
executor-host-sync-in-loop  INFO/E    host-IO op (save/load/...) in
                                      the hot loop — a while/recurrent
                                      body, or the per-step program of
                                      a training run — forces a device
                                      sync every iteration and defeats
                                      async dispatch overlap (ERROR
                                      under PADDLE_TPU_STRICT_SYNC=1
                                      or in the serving hot loop)
race-inflight-write         ERROR     persistable fetched AND written,
                                      or a fed data var overwritten —
                                      overlapping in-flight steps race
                                      on the buffer (silent when
                                      max_in_flight<=1; see
                                      static_analysis.concurrency)
donated-buffer-live-read    ERROR     pending FetchHandle aliases a
                                      buffer an in-place op (fused
                                      optimizer, in-place collective)
                                      donates in the next in-flight
                                      step
scope-overlap               ERROR     coresident programs' scope
                                      footprints are not disjoint —
                                      multi-tenant isolation proof
                                      fails (runs when coresident
                                      programs are supplied)
sync-in-hot-loop            ERROR     zero-sync certificate violation:
                                      host-sync point (host-IO, host
                                      table, eager while probe) in the
                                      steady-state loop (runs when
                                      certifying or strict)
fused-op-missing-grad       ERROR     fused op registered no_grad=True
                                      on a parameter-derived path of a
                                      training program — its param
                                      grads would silently zero
fusible-pattern-not-fused   INFO      pattern the fusion pipeline
                                      matched but will not rewrite,
                                      with the cost-model reason
quantizable-bucket-not-     INFO      ICI-bound gradient bucket the
quantized                             cost model prices as an int8
                                      quantization win but that runs
                                      bf16 (no plan mark / env
                                      threshold, kill switch, or
                                      uncalibrated autotune family)
collective-crosses-slow-    INFO      ring-0 gradient exchange whose
tier                                  ring spans slices carrying >=
                                      threshold bytes flat across the
                                      DCN tier (rewrite disabled, plan
                                      mark pins flat, asymmetric
                                      topology, or no topology in
                                      ClusterSpec), with the priced
                                      per-tier delta in the hint
collective-start-without-   ERROR     c_allreduce_start with no
wait                                  matching c_allreduce_wait after
                                      it — the in-flight reduction is
                                      never barriered
wait-without-start          ERROR     c_allreduce_wait with no
                                      c_allreduce_start before it —
                                      barriers a reduction nobody
                                      launched
double-wait                 ERROR     duplicate c_allreduce_wait for
                                      one overlap bucket
overlap-opportunity-        INFO      bucketed collective kept fused
unexploited                           synchronous despite a window of
                                      dead compute (overlap disabled,
                                      proof-reverted, or no-window)
decode-shape-unbucketed     WARNING   while body concatenates a loop
                                      carry with per-step data and
                                      writes it back — operand shapes
                                      grow with the loop index, so
                                      every decode step is a fresh
                                      shape bucket (use the ring-buffer
                                      KV cache: layers.decode_loop)
==========================  ========  ====================================
"""

from .defuse import (SUB_BLOCK_DESCENT_OPS, _machinery_defined_names,
                     resolve_sub_block, sub_block_reads_recursive)
from .diagnostics import Diagnostic, Severity
from ..ops.registry import EMPTY_VAR_NAME

__all__ = ["register_check", "get_check", "all_checks", "VerifyContext"]

_CHECKS = {}


def register_check(check_id):
    """Register ``fn(ctx) -> Iterable[Diagnostic]`` under ``check_id``
    (the ``register_pass`` idiom; later registration replaces earlier,
    so a project can override a built-in)."""

    def deco(fn):
        _CHECKS[check_id] = fn
        return fn

    return deco


def get_check(check_id):
    return _CHECKS[check_id]


def all_checks():
    """Ordered {id: fn} of registered checks."""
    return dict(_CHECKS)


class VerifyContext:
    """What a check sees: the program, the def-use graph, the (optional)
    fetch targets, the (optional) per-worker program list for the
    cross-worker checks, and a Diagnostic factory that fills in
    coordinates.  ``interp``/``cost`` are computed lazily so the cheap
    structural checks never pay for the analyzer."""

    def __init__(self, program, graph, targets=None, workers=None,
                 analysis=None, worker_schedules=None,
                 max_in_flight=None, coresident=None,
                 certify_zero_sync=False):
        self.program = program
        self.graph = graph
        self.targets = tuple(targets or ())
        self.workers = list(workers) if workers else None
        # precomputed per-worker schedules (Program.analyze already
        # extracted them) so the divergence check doesn't re-interpret
        # every worker program
        self.worker_schedules = worker_schedules
        self._interp, self._cost = analysis or (None, None)
        # concurrency context: the in-flight depth the race
        # checks assume (None → program mark / env / 1), programs
        # sharing this one's Executor scope, and whether the zero-sync
        # certificate check should run unconditionally
        self.max_in_flight = max_in_flight
        self.coresident = list(coresident) if coresident else None
        self.certify_zero_sync = bool(certify_zero_sync)

    @property
    def interp(self):
        if self._interp is None:
            from .interp import interpret_program

            self._interp = interpret_program(
                self.program,
                nranks=len(self.workers) if self.workers else None)
        return self._interp

    @property
    def cost(self):
        if self._cost is None:
            from .cost import estimate_cost

            self._cost = estimate_cost(
                self.program, interp=self.interp, targets=self.targets)
        return self._cost

    def var(self, name, near_block=None):
        """Recursive var lookup starting at ``near_block`` (a block idx)."""
        b = (self.program.block(near_block) if near_block is not None
             else self.program.global_block())
        return b._find_var_recursive(name)

    def diag(self, check, severity, message, block_idx=None, op_idx=None,
             op=None, var_names=(), hint=""):
        return Diagnostic(
            check, severity, message,
            block_idx=block_idx, op_idx=op_idx,
            op_type=op.type if op is not None else None,
            op_id=op.attrs.get("__op_id__") if op is not None else None,
            var_names=var_names, hint=hint,
        )


def _is_defined_root(ctx, name, block_idx):
    """Names with a value before any op runs: persistables (scope-resident
    across runs) and data vars (fed)."""
    v = ctx.var(name, block_idx)
    if v is None:
        return False
    return bool(v.persistable or v.is_data)


# ---------------------------------------------------------------------------
# use-before-def
# ---------------------------------------------------------------------------

@register_check("use-before-def")
def check_use_before_def(ctx):
    """Walk in execution order threading the defined-name set through
    sub-block descent; flag reads of non-persistable, non-fed vars with no
    prior write (the dangling edges a broken fuse/DCE pass leaves)."""
    program = ctx.program
    reported = set()
    visited_blocks = set()

    def walk(block, defined):
        if block.idx in visited_blocks:
            # sub_block cycle in a malformed program: sub-block-index
            # reports it; don't recurse forever here
            return
        visited_blocks.add(block.idx)
        for op_idx, op in enumerate(block.ops):
            for n in op.input_arg_names:
                if (not n or n == EMPTY_VAR_NAME or n in defined
                        or n in reported):
                    continue
                if _is_defined_root(ctx, n, block.idx):
                    defined.add(n)
                    continue
                reported.add(n)
                v = ctx.var(n, block.idx)
                if v is None:
                    msg = ("op reads %r which is not declared in any "
                           "reachable block" % n)
                    hint = ("a pass rewired an input to a var it never "
                            "created — create the var or fix the slot")
                else:
                    msg = ("op reads %r before any op writes it (and it "
                           "is neither persistable nor fed)" % n)
                    hint = ("reorder the producer before this op, or mark "
                            "the var persistable/is_data if it is "
                            "scope-provided")
                yield ctx.diag(
                    "use-before-def", Severity.ERROR, msg,
                    block_idx=block.idx, op_idx=op_idx, op=op,
                    var_names=(n,), hint=hint)
            if op.type in SUB_BLOCK_DESCENT_OPS:
                inner = resolve_sub_block(program, op,
                                          host_block_idx=block.idx)
                if inner is not None:
                    inner_defined = set(defined)
                    inner_defined.update(_machinery_defined_names(op))
                    yield from walk(inner, inner_defined)
            for n in op.output_arg_names:
                if n and n != EMPTY_VAR_NAME:
                    defined.add(n)

    yield from walk(program.global_block(), set())


# ---------------------------------------------------------------------------
# double-write
# ---------------------------------------------------------------------------

@register_check("double-write")
def check_double_write(ctx):
    """Two writes to one var in a block with no read in between, where the
    second writer does not read-modify-write it: the first write is dead,
    and for persistables it aliases the jit cache's donated param buffers
    (executor.py donates the mutated-param argument — two blind writes in
    one step mean one update silently vanishes).

    Read-modify-write ops (sgd ParamOut==Param, batch_norm MeanOut==Mean,
    c_allreduce in-place) and control-flow merges (conditional branches
    each assign the merge var; the op semantically reads the prior value)
    are not violations.
    """
    for block in ctx.program.blocks:
        if block.idx not in ctx.graph.walked_blocks:
            continue
        last_write = {}   # name -> (op_idx, op)
        read_since = {}   # name -> True once read after last write
        for op_idx, op in enumerate(block.ops):
            for n in op.input_arg_names:
                read_since[n] = True
            sub = resolve_sub_block(ctx.program, op,
                                    host_block_idx=block.idx)
            if sub is not None:
                # closure reads never appear on the op's input slots
                for n in sub_block_reads_recursive(ctx.program, sub):
                    read_since[n] = True
            is_cf = op.type in SUB_BLOCK_DESCENT_OPS
            if is_cf:
                # the sub-block body reads/merges the carried names
                for n in op.output_arg_names:
                    read_since[n] = True
            for n in op.output_arg_names:
                if not n or n == EMPTY_VAR_NAME:
                    continue
                prev = last_write.get(n)
                # read-modify-write ops (sgd, batch_norm stats, in-place
                # allreduce) are exempt via read_since: their own input
                # read was recorded just above
                if prev is not None and not read_since.get(n) and not is_cf:
                    v = ctx.var(n, block.idx)
                    persistable = bool(v is not None and v.persistable)
                    sev = Severity.ERROR if persistable else Severity.WARNING
                    what = ("persistable %r (donation-aliasing hazard: the "
                            "first update is lost in the donated buffer)"
                            if persistable else
                            "%r (the first write is dead)")
                    yield ctx.diag(
                        "double-write", sev,
                        ("op overwrites " + what + "; prior write at op %d "
                         "(%s) was never read") % (n, prev[0], prev[1].type),
                        block_idx=block.idx, op_idx=op_idx, op=op,
                        var_names=(n,),
                        hint="drop the dead writer or rename one output")
                last_write[n] = (op_idx, op)
                read_since[n] = False


# ---------------------------------------------------------------------------
# shape/dtype re-inference drift
# ---------------------------------------------------------------------------

def _shapes_conflict(recorded, inferred):
    """Static-dim conflict only: -1/None dims are unknown, and rank-1 vs
    rank-0 scalars round-trip loosely through serialization, so only
    same-rank tensors with differing static dims count."""
    if recorded is None or inferred is None:
        return False
    if len(recorded) != len(inferred):
        return not (len(recorded) == 0 or len(inferred) == 0)
    for r, i in zip(recorded, inferred):
        if r is None or i is None or r < 0 or i < 0:
            continue
        if int(r) != int(i):
            return True
    return False


@register_check("shape-dtype-drift")
def check_shape_dtype_drift(ctx):
    """Re-run the shape inference engine (framework.py's append-time
    InferShape, on ``meta`` tensors) over every op and diff against the
    recorded
    Variable metadata.  At build time the two agree by construction, so a
    disagreement means a pass rewired the graph without re-inferring —
    dtype drift is an ERROR (it changes numerics/casts silently), static
    shape drift a WARNING (execution re-traces with concrete feeds)."""
    from ..ops import registry

    for block_idx, op_idx, op in ctx.graph.order:
        if op.type.endswith("_grad") or op.type in ("feed", "fetch"):
            continue
        block = ctx.program.block(block_idx)
        try:
            inferred = registry.infer_output_structs(op, block)
        except registry.OpNotRegistered:
            continue
        except Exception as e:
            # at build time append_op would have propagated this, so a
            # raise here means a rewrite left metadata the lowering
            # rejects outright — the strongest drift signal there is
            yield ctx.diag(
                "shape-dtype-drift", Severity.ERROR,
                "the op's lowering rejects the recorded input metadata "
                "(%s: %s)" % (type(e).__name__, str(e)[:200]),
                block_idx=block_idx, op_idx=op_idx, op=op,
                var_names=tuple(op.input_arg_names),
                hint="a pass rewired this op's inputs to incompatible "
                     "vars — fix the rewrite or re-infer shapes")
            continue
        if not inferred:
            continue
        for n, (shape, dtype) in inferred.items():
            var = block._find_var_recursive(n)
            if var is None:
                continue
            recorded_dtype = var.dtype
            if recorded_dtype is not None and dtype != str(recorded_dtype):
                yield ctx.diag(
                    "shape-dtype-drift", Severity.ERROR,
                    "recorded dtype of %r is %s but the op's lowering "
                    "produces %s" % (n, recorded_dtype, dtype),
                    block_idx=block_idx, op_idx=op_idx, op=op,
                    var_names=(n,),
                    hint="re-run shape inference after rewriting, or cast "
                         "explicitly")
            elif _shapes_conflict(var.shape, shape):
                yield ctx.diag(
                    "shape-dtype-drift", Severity.WARNING,
                    "recorded shape of %r is %s but the op's lowering "
                    "produces %s" % (n, tuple(var.shape), tuple(shape)),
                    block_idx=block_idx, op_idx=op_idx, op=op,
                    var_names=(n,),
                    hint="update the var's shape metadata after rewriting")


# ---------------------------------------------------------------------------
# orphaned fetch targets
# ---------------------------------------------------------------------------

@register_check("orphaned-fetch")
def check_orphaned_fetch(ctx):
    """Every fetch target (explicit ``targets`` plus any fetch op's inputs)
    must be produced by a surviving op, fed, or persistable — the exact
    invariant a too-eager rewrite pass breaks."""
    wanted = list(ctx.targets)
    for block_idx, op_idx, op in ctx.graph.order:
        if op.type == "fetch":
            wanted.extend(op.input_arg_names)
    seen = set()
    for n in wanted:
        if not n or n == EMPTY_VAR_NAME or n in seen:
            continue
        seen.add(n)
        v = ctx.var(n)
        if v is None:
            yield ctx.diag(
                "orphaned-fetch", Severity.ERROR,
                "fetch target %r does not exist in the program" % n,
                var_names=(n,),
                hint="a pass pruned the target var — exclude fetch "
                     "targets from rewrites (pass targets= to the "
                     "Analyzer)")
        elif not (ctx.graph.is_produced(n) or v.persistable or v.is_data):
            yield ctx.diag(
                "orphaned-fetch", Severity.ERROR,
                "fetch target %r is never produced by any op (nor fed, "
                "nor persistable)" % n,
                var_names=(n,),
                hint="the producing op was fused/eliminated — rerun the "
                     "pass with targets= or keep the producer")


# ---------------------------------------------------------------------------
# sub-block indices
# ---------------------------------------------------------------------------

@register_check("sub-block-index")
def check_sub_block_index(ctx):
    for block in ctx.program.blocks:
        for op_idx, op in enumerate(block.ops):
            if "sub_block" not in op.attrs:
                continue
            idx = op.attrs["sub_block"]
            if (not isinstance(idx, int)
                    or idx < 0 or idx >= ctx.program.num_blocks):
                yield ctx.diag(
                    "sub-block-index", Severity.ERROR,
                    "attrs['sub_block']=%r is not a valid block index "
                    "(program has %d blocks)" % (idx, ctx.program.num_blocks),
                    block_idx=block.idx, op_idx=op_idx, op=op,
                    hint="clone/serialize must remap sub_block indices")
            elif idx == block.idx:
                yield ctx.diag(
                    "sub-block-index", Severity.ERROR,
                    "op's sub_block is its own block (infinite descent)",
                    block_idx=block.idx, op_idx=op_idx, op=op)


# ---------------------------------------------------------------------------
# collective ring-id pairing (transpiled programs)
# ---------------------------------------------------------------------------

# c_sync_*_stream ops are ring-less by design and match none of these
_COLLECTIVE_OP_PREFIXES = ("c_allreduce", "c_reduce", "c_broadcast",
                           "c_allgather", "c_reducescatter", "c_scatter")
# collectives emitted by the parallel program emitters (moe/ulysses
# all_to_all resharding, ring-attention/pipeline ppermute hops) — no
# ``c_`` prefix but the same ring_id contract
_RINGED_OP_TYPES = ("all_to_all", "ppermute")


@register_check("collective-ring")
def check_collective_ring(ctx):
    """Transpiled programs: every collective must carry an integer
    ``ring_id`` — the transpiler-emitted ``c_*`` families AND the
    collectives the parallel emitters insert (``all_to_all`` from
    parallel/{moe,ulysses}.py, ``ppermute`` from
    parallel/ring_attention.py); bootstrap pairs (``c_gen_nccl_id`` →
    ``c_comm_init``) must agree per ring, every ring a collective uses
    should have a bootstrap pair when any bootstrap exists, and p2p
    send/recv ops must name an integer ``peer`` (reference keeps rings
    consistent in C++; here a mismatch would silently place collectives
    on different meshes).  Note: a single rank's program legitimately
    has asymmetric send/recv peers (pipeline stages), so pairing is
    checked per-op, not globally."""
    gen_rings = {}
    init_rings = set()
    used_rings = {}
    for block_idx, op_idx, op in ctx.graph.order:
        t = op.type
        if t == "c_gen_nccl_id":
            gen_rings[op.attrs.get("ring_id", 0)] = (block_idx, op_idx, op)
        elif t == "c_comm_init":
            init_rings.add(op.attrs.get("ring_id", 0))
        elif t in ("send_v2", "recv_v2"):
            if not isinstance(op.attrs.get("peer"), int):
                yield ctx.diag(
                    "collective-ring", Severity.ERROR,
                    "%s op has no integer peer attr (got %r)"
                    % (t, op.attrs.get("peer")),
                    block_idx=block_idx, op_idx=op_idx, op=op,
                    hint="p2p ops must name their partner rank")
            used_rings.setdefault(op.attrs.get("ring_id"),
                                  (block_idx, op_idx, op))
        elif t.startswith(_COLLECTIVE_OP_PREFIXES) or t in _RINGED_OP_TYPES:
            ring = op.attrs.get("ring_id")
            if ring is None or not isinstance(ring, int):
                yield ctx.diag(
                    "collective-ring", Severity.ERROR,
                    "collective op has no integer ring_id attr (got %r)"
                    % (ring,),
                    block_idx=block_idx, op_idx=op_idx, op=op,
                    hint="the transpiler/parallel emitter must stamp "
                         "ring_id on every collective it inserts")
            else:
                used_rings.setdefault(ring, (block_idx, op_idx, op))
    # key=repr: a malformed program may mix int and str ring ids — the
    # check must report them, not die sorting them
    for ring, (block_idx, op_idx, op) in sorted(gen_rings.items(),
                                                key=lambda kv: repr(kv[0])):
        if ring not in init_rings:
            yield ctx.diag(
                "collective-ring", Severity.WARNING,
                "c_gen_nccl_id for ring %r has no matching c_comm_init"
                % (ring,),
                block_idx=block_idx, op_idx=op_idx, op=op,
                hint="append c_comm_init with the same ring_id in the "
                     "startup program")
    # a program that carries its own bootstrap (startup, or merged
    # startup+main) must bootstrap every ring its collectives use; a
    # main-only program (gen_rings empty) is exempt — its bootstrap
    # lives in the separate startup program
    if gen_rings:
        for ring, (block_idx, op_idx, op) in sorted(
                used_rings.items(), key=lambda kv: repr(kv[0])):
            if ring not in gen_rings and ring is not None:
                yield ctx.diag(
                    "collective-ring", Severity.WARNING,
                    "collective uses ring %r but the program only "
                    "bootstraps ring(s) %s"
                    % (ring, sorted(gen_rings, key=repr)),
                    block_idx=block_idx, op_idx=op_idx, op=op,
                    hint="transpiler.collective.ensure_comm_ring "
                         "appends the c_gen_nccl_id/c_comm_init pair")


# ---------------------------------------------------------------------------
# unreferenced ops (advisory DCE twin)
# ---------------------------------------------------------------------------

# op types whose value is their side effect, not a consumed output
_SIDE_EFFECT_OPS = frozenset((
    "feed", "fetch", "print", "save", "load", "save_combine",
    "load_combine", "c_gen_nccl_id", "c_comm_init", "c_sync_calc_stream",
    "c_sync_comm_stream", "barrier",
))


@register_check("unreferenced-op")
def check_unreferenced_op(ctx):
    """Ops in the global block whose outputs nothing reads and nothing
    fetches: dead weight the DCE pass would remove.  Advisory (INFO) —
    intentionally kept side-effecting, persistable-writing and
    control-flow ops are exempt."""
    targets = set(ctx.targets)
    block = ctx.program.global_block()
    for op_idx, op in enumerate(block.ops):
        if (op.type in _SIDE_EFFECT_OPS
                or op.type in SUB_BLOCK_DESCENT_OPS
                or op.type.endswith("_grad")):
            continue
        outs = [n for n in op.output_arg_names
                if n and n != EMPTY_VAR_NAME]
        if not outs:
            continue
        live = False
        for n in outs:
            v = ctx.var(n)
            if (n in targets or ctx.graph.consumers(n)
                    or (v is not None and v.persistable)):
                live = True
                break
        if not live:
            yield ctx.diag(
                "unreferenced-op", Severity.INFO,
                "no op, fetch target or persistable consumes outputs %s"
                % (outs,),
                block_idx=block.idx, op_idx=op_idx, op=op,
                var_names=tuple(outs),
                hint="dead_code_elimination_pass would remove this op")


@register_check("resilience-finite-guard")
def check_resilience_finite_guard(ctx):
    """Training programs run without the NaN/Inf step-guard: one
    non-finite gradient silently corrupts every parameter it touches,
    and the donated-buffer executor cannot roll the step back after the
    fact.  Advisory (INFO) — inference programs and guarded runs are
    exempt; fires only when fetch targets are given (i.e. a run loop is
    actually reading the loss)."""
    if not ctx.targets:
        return
    is_training = any(
        op.type.endswith("_grad") or op.attrs.get("op_role") == "optimize"
        for _, _, op in ctx.graph.order)
    if not is_training:
        return
    from .concurrency import guard_enabled

    if guard_enabled(ctx.program):
        return
    loss = getattr(ctx.program, "_guard_loss_name", None)
    yield ctx.diag(
        "resilience-finite-guard", Severity.INFO,
        "training program fetches %s but no finite step-guard is "
        "enabled — a NaN/Inf step would be applied to the parameters"
        % (("loss %r" % loss) if loss else list(ctx.targets)),
        block_idx=0,
        var_names=(loss,) if loss else tuple(ctx.targets),
        hint="set PADDLE_TPU_NAN_GUARD=1 (or program._nan_guard=True) so "
             "non-finite steps are skipped, counted and warned about")


# loop-body ops: their sub_block re-runs per iteration, so host IO
# inside costs one sync per ITERATION, not per step.  The host-IO op
# roster itself is cost.HOST_IO_OP_TYPES (one source of truth).
_LOOP_BODY_OPS = ("while", "recurrent")


@register_check("executor-host-sync-in-loop")
def check_executor_host_sync_in_loop(ctx):
    """Advisory: host-IO ops in a hot loop serialize async dispatch.

    Two shapes (both INFO — sometimes a per-step save is the point):

    * a host-IO op inside a ``while``/``recurrent`` sub-block (or any
      block nested under one) — every loop iteration would bounce to
      the host;
    * a host-IO op in the global block of a TRAINING program — the
      per-step program IS the hot loop, so each ``Executor.run`` pays a
      full pipeline drain around the jitted step, exactly the per-batch
      sync latency the async fetch-handle path exists to remove.
    """
    from .cost import HOST_IO_OP_TYPES

    program = ctx.program

    def loop_block_idxs():
        """Block indices reachable through a while/recurrent sub_block."""
        seen = set()
        stack = []
        for block in program.blocks:
            for op in block.ops:
                if op.type in _LOOP_BODY_OPS:
                    inner = resolve_sub_block(program, op,
                                              host_block_idx=block.idx)
                    if inner is not None:
                        stack.append(inner)
        while stack:
            b = stack.pop()
            if b.idx in seen:
                continue
            seen.add(b.idx)
            for op in b.ops:
                inner = resolve_sub_block(program, op,
                                          host_block_idx=b.idx)
                if inner is not None:
                    stack.append(inner)
        return seen

    in_loop = loop_block_idxs()
    is_training = any(
        op.type.endswith("_grad") or op.attrs.get("op_role") == "optimize"
        for _, _, op in ctx.graph.order)
    # promotion: under PADDLE_TPU_STRICT_SYNC=1 (or once the
    # program has entered the serving hot loop) the advisory is an
    # ERROR backed by the zero-sync certificate — a per-step host sync
    # there is a throughput bug, not a style note
    from .concurrency import strict_sync_enabled

    strict = strict_sync_enabled(ctx.program)
    severity = Severity.ERROR if strict else Severity.INFO
    for block_idx, op_idx, op in ctx.graph.order:
        if op.type not in HOST_IO_OP_TYPES:
            continue
        if block_idx in in_loop:
            yield ctx.diag(
                "executor-host-sync-in-loop", severity,
                "host-IO op %r at block %d op %d inside a "
                "while/recurrent body forces a device sync every loop "
                "iteration — introduced by Executor.run's host-IO "
                "phase (ops.io_ops.run_host_io_block)%s"
                % (op.type, block_idx, op_idx,
                   "; strict-sync mode fails the zero-sync certificate "
                   "on it" if strict else ""),
                block_idx=block_idx, op_idx=op_idx, op=op,
                hint="hoist the IO out of the loop (checkpoint/print at "
                     "step boundaries) so the loop stays one dispatch")
        elif block_idx == 0 and is_training:
            yield ctx.diag(
                "executor-host-sync-in-loop", severity,
                "host-IO op %r at block %d op %d in a training "
                "program's global block forces a per-step host sync "
                "around the jitted step — introduced by Executor.run's "
                "host-IO phase (ops.io_ops.run_host_io_block)%s"
                % (op.type, block_idx, op_idx,
                   "; strict-sync mode fails the zero-sync certificate "
                   "on it" if strict else ""),
                block_idx=block_idx, op_idx=op_idx, op=op,
                hint="run IO from a separate program at "
                     "checkpoint/print_period boundaries; keep the "
                     "per-step program pure so async dispatch "
                     "(return_numpy=False fetch handles, "
                     "DeviceFeedPipeline feeds) can overlap steps")


# ---------------------------------------------------------------------------
# analyzer-backed checks (abstract interpretation + cost model)
# ---------------------------------------------------------------------------

@register_check("peak-memory-over-budget")
def check_peak_memory_over_budget(ctx):
    """The liveness-based peak-memory estimate must fit the configured
    HBM budget (``PADDLE_TPU_HBM_BUDGET`` / ``program._hbm_budget``, or
    an explicit ``analyze(hbm_budget=...)`` override riding on the
    precomputed cost report).  Skipped when no budget is configured —
    there is nothing to gate against, and guessing a device would make
    CI flaky."""
    from .cost import hbm_budget

    # cheap pre-probe: only build the cost report when some budget
    # source exists (the lazy ctx.cost resolves the same sources)
    if hbm_budget(ctx.program) is None and ctx._cost is None:
        return
    cost = ctx.cost
    budget = cost.hbm_budget
    if budget is None:
        return
    if cost.peak_memory_bytes > budget:
        yield ctx.diag(
            "peak-memory-over-budget", Severity.ERROR,
            "estimated peak memory %d bytes exceeds the HBM budget %d "
            "(persistables %d, peak live activations %d; batch=%d)"
            % (cost.peak_memory_bytes, budget, cost.persistent_bytes,
               cost.peak_memory_bytes - cost.persistent_bytes,
               cost.batch_size),
            block_idx=0,
            hint="shard the largest persistables, enable recompute, or "
                 "cut the assumed batch (PADDLE_TPU_ANALYZE_BATCH)")


@register_check("collective-schedule-divergence")
def check_collective_schedule_divergence(ctx):
    """Cross-worker proof: the N per-worker programs must issue the same
    ordered collectives per ring and pairwise-matched p2p — the static
    deadlock-freedom obligation (see static_analysis/distributed.py).
    Runs only when the worker program set is supplied
    (``verify_program(..., workers=[...])`` / ``Program.analyze``)."""
    from .distributed import check_schedule_consistency

    if ctx.worker_schedules is not None:
        yield from check_schedule_consistency(ctx.worker_schedules)
        return
    if not ctx.workers or len(ctx.workers) <= 1:
        return
    from .distributed import prove_deadlock_free

    _, diags = prove_deadlock_free(ctx.workers)
    yield from diags


@register_check("degenerate-sharding")
def check_degenerate_sharding(ctx):
    """A var marked sharded into more parts than its sharded dim holds
    (or into parts that don't divide it) silently degenerates: some
    workers hold empty/ragged shards while the program still pays every
    collective.  Runs on multi-worker programs only — the cheap
    trainer-count probe comes first so single-worker lint/verify_pass
    sweeps never build the interpreter."""
    nranks = (len(ctx.workers) if ctx.workers
              else int(getattr(ctx.program, "_num_trainers", 1) or 1))
    if nranks <= 1:
        return
    interp = ctx.interp
    for name, v in sorted(interp.sharded_vars().items()):
        s = v.sharding
        if v.shape is None or s.dim is None or s.dim >= len(v.shape):
            continue
        # a dynamic (-1) recorded dim is runtime-sized — the interp
        # resolved it to the assumed batch, which must not be judged
        recorded = ctx.var(name)
        if recorded is not None and recorded.shape is not None \
                and s.dim < len(recorded.shape):
            rd = recorded.shape[s.dim]
            if rd is None or int(rd) < 0:
                continue
        dim_size = int(v.shape[s.dim])
        if dim_size < s.parts:
            yield ctx.diag(
                "degenerate-sharding", Severity.WARNING,
                "%r is sharded %d-way over axis %r but its dim %d has "
                "only %d element(s) — some workers hold empty shards"
                % (name, s.parts, s.axis, s.dim, dim_size),
                var_names=(name,),
                hint="shard a larger dim, or lower the parallelism "
                     "degree for this tensor")
        elif dim_size % s.parts:
            yield ctx.diag(
                "degenerate-sharding", Severity.WARNING,
                "%r dim %d (%d elements) is not divisible by the %d-way "
                "sharding over axis %r — ragged shards"
                % (name, s.dim, dim_size, s.parts, s.axis),
                var_names=(name,),
                hint="pad the dim or choose a degree that divides it")


@register_check("oversized-replicated-persistable")
def check_oversized_replicated_persistable(ctx):
    """On a multi-worker program, a replicated persistable bigger than
    the replication budget (``PADDLE_TPU_REPLICATED_BUDGET`` bytes,
    default: HBM budget / 4 when configured, else 1 GiB) multiplies its
    HBM cost by the worker count for no throughput — shard it (ZeRO /
    tensor parallel / host table)."""
    import os

    from .cost import dtype_bytes, hbm_budget, parse_size

    nranks = (len(ctx.workers) if ctx.workers
              else int(getattr(ctx.program, "_num_trainers", 1) or 1))
    if nranks <= 1:
        return
    interp = ctx.interp
    val = os.environ.get("PADDLE_TPU_REPLICATED_BUDGET", "").strip()
    if val:
        threshold = parse_size(val)
    else:
        budget = hbm_budget(ctx.program)
        threshold = budget // 4 if budget else 1 << 30
    for name, v in sorted(interp.replicated_persistables().items()):
        n = v.numel
        if n is None:
            continue
        size = n * dtype_bytes(v.dtype)
        if size > threshold:
            yield ctx.diag(
                "oversized-replicated-persistable", Severity.WARNING,
                "persistable %r (%d bytes) is replicated on all %d "
                "workers (budget %d bytes per replicated var)"
                % (name, size, nranks, threshold),
                var_names=(name,),
                hint="shard it: BuildStrategy.shard_optimizer_state "
                     "(ZeRO-1), shard_spec/tensor parallel, or a host "
                     "table for embeddings")


@register_check("fused-op-missing-grad")
def check_fused_op_missing_grad(ctx):
    """A fused forward op registered with ``no_grad=True`` silently
    blocks gradient flow: backward.py treats it as non-differentiable,
    so every parameter feeding it gets a zero (or missing) gradient with
    no error.  ERROR when such an op sits on a parameter-derived path of
    a TRAINING program AND a gradient is actually demanded through its
    output (a metrics-only branch is fine; the fusion pipeline's own
    fused ops are all differentiable via the registry's generic vjp —
    this guards custom fused kernels wired in by hand)."""
    from ..ops import registry
    from .fusion import FUSED_FORWARD_OP_TYPES

    order = [rec for rec in ctx.graph.order if rec[0] == 0]
    training = any(
        op.type.endswith("_grad") or op.attrs.get("op_role") == "optimize"
        for _, _, op in order)
    if not training:
        return
    bearing = set()
    for p in ctx.program.all_parameters():
        if getattr(p, "trainable", True) and not p.stop_gradient:
            bearing.add(p.name)
    # gradient demand: vars from which an op WITH a grad twin is
    # reachable.  Only a blocked gradient on a demanded path silently
    # zeroes a param update — a metrics/fetch-only branch reading
    # param-derived values through a no_grad fused op is fine.
    twin_ids = {op.attrs.get("__fwd_op_id__") for _, _, op in order
                if op.type.endswith("_grad")}
    twin_ids.discard(None)
    demanded = set()
    for _, _, op in order:
        if op.attrs.get("__op_id__") in twin_ids:
            demanded.update(n for n in op.input_arg_names
                            if n and n != EMPTY_VAR_NAME)
    for _, _, op in reversed(order):
        if op.type.endswith("_grad"):
            continue
        if demanded.intersection(op.output_arg_names):
            demanded.update(n for n in op.input_arg_names
                            if n and n != EMPTY_VAR_NAME)
    for block_idx, op_idx, op in order:
        if op.type.endswith("_grad") \
                or op.attrs.get("op_role") in ("backward", "optimize"):
            continue
        try:
            opdef = registry.get_op_def(op.type)
        except registry.OpNotRegistered:
            continue
        touches = [n for n in op.input_arg_names if n in bearing]
        if not touches:
            continue
        if opdef.no_grad and (op.type.startswith("fused_")
                              or op.type.startswith("c_fused_")
                              or op.type in FUSED_FORWARD_OP_TYPES) \
                and demanded.intersection(op.output_arg_names):
            yield ctx.diag(
                "fused-op-missing-grad", Severity.ERROR,
                "fused op %r has no registered grad_fn (no_grad=True) "
                "but a parameter gradient path flows through it via %s "
                "— training would silently zero those grads"
                % (op.type, touches[:3]),
                block_idx=block_idx, op_idx=op_idx, op=op,
                var_names=tuple(touches[:3]),
                hint="register the op without no_grad (the registry "
                     "derives <type>_grad via autograd) or give it a "
                     "custom grad_maker")
        if not opdef.no_grad:
            bearing.update(
                n for n in op.output_arg_names if n != EMPTY_VAR_NAME)


@register_check("fusible-pattern-not-fused")
def check_fusible_pattern_not_fused(ctx):
    """Advisory twin of the fusion pipeline: patterns the matchers
    recognize but the pipeline will NOT rewrite — either gated out by
    the cost model (with the model's reason) or because fusion is
    globally disabled.  Points at the anchor op of each pattern."""
    from .fusion import (FusionConfig, fusion_enabled,
                         scan_fusible_patterns)

    report = scan_fusible_patterns(
        ctx.program, FusionConfig(enabled=True), targets=ctx.targets)
    for s in report.skipped:
        yield ctx.diag(
            "fusible-pattern-not-fused", Severity.INFO,
            "fusible %s pattern matched but will not fuse: %s"
            % (s.family, s.reason),
            block_idx=s.block_idx, op_idx=s.op_idx,
            hint="see CompiledProgram.fusion_report() for the full "
                 "pipeline outcome")
    if not fusion_enabled():
        for r in report.applied:
            yield ctx.diag(
                "fusible-pattern-not-fused", Severity.INFO,
                "fusible %s pattern (block %d ops %s -> %s) is disabled "
                "by PADDLE_TPU_FUSION=0"
                % (r.family, r.block_idx, list(r.op_idxs),
                   r.fused_op_type),
                block_idx=r.block_idx,
                op_idx=r.op_idxs[0] if r.op_idxs else None,
                hint="unset PADDLE_TPU_FUSION to enable the rewrite")


@register_check("quantizable-bucket-not-quantized")
def check_quantizable_bucket_not_quantized(ctx):
    """Advisory twin of the quant planner axis (``paddle_tpu/quant``):
    ring-0 gradient buckets big enough that the cost model prices the
    int8 block-quantized exchange as a win, but that will run bf16 —
    because ``PADDLE_TPU_QUANT=0`` disables the subsystem, or because
    no plan mark / env threshold engages it.  Mirrors
    ``fusible-pattern-not-fused``, including the "uncalibrated" reason
    when the autotune ``quant`` family has no measured entry for the
    bucket's shape."""
    from ..quant.blockwise import quant_block, quant_enabled
    from ..quant.collective import quant_min_bytes
    from .cost import dtype_bytes
    from .fusion import _calibration, allreduce_bucket_mb

    if quant_min_bytes(ctx.program) is not None:
        return  # quant is engaged — the rewrite handles these buckets
    block = ctx.program.global_block()
    # group + size-cap the in-place grad allreduces exactly as the
    # fusion bucketer does, so the advisory names the same buckets the
    # rewrite would quantize
    groups = {}
    for i, op in enumerate(block.ops):
        if op.type not in ("c_allreduce_sum", "c_fused_allreduce_sum"):
            continue
        names = op.inputs.get("X", [])
        if not names or set(names) != set(op.outputs.get("Out", [])):
            continue  # only the in-place grad-allreduce shape
        dt = None
        nbytes = 0
        for n in names:
            v = block._find_var_recursive(n)
            if v is None or not v.shape or any(
                    int(d) < 0 for d in v.shape):
                nbytes = 0
                break
            numel = 1
            for d in v.shape:
                numel *= int(d)
            nbytes += numel * dtype_bytes(v.dtype)
            dt = str(v.dtype)
        if not nbytes or dt not in ("float32", "bfloat16"):
            continue
        key = (op.attrs.get("ring_id"), dt)
        groups.setdefault(key, []).append((i, names[0], nbytes))
    if not groups:
        return
    cap = int(allreduce_bucket_mb(ctx.program) * (1 << 20))
    # break-even on the program's cluster spec (or the generic default
    # chip): the same rule a quant-winning plan stamps as min_bytes
    from ..parallel.planner import ClusterSpec, quant_bucket_mark

    spec = getattr(ctx.program, "_cluster_spec", None)
    try:
        cluster = ClusterSpec.coerce(spec) if spec else ClusterSpec(2)
    except Exception:  # noqa: BLE001 - bad spec has its own advisory
        cluster = ClusterSpec(2)
    mark = quant_bucket_mark(cluster, max(cluster.chips, 2))
    blk = quant_block()
    for key, members in sorted(groups.items(),
                               key=lambda kv: kv[1][0][0]):
        buckets = []
        cur, cur_bytes = [], 0
        for item in members:
            if cur and cur_bytes + item[2] > cap:
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(item)
            cur_bytes += item[2]
        if cur:
            buckets.append(cur)
        for bucket in buckets:
            total = sum(b for _, _, b in bucket)
            if total < mark["min_bytes"]:
                continue  # cost model says bf16 is right — no noise
            if not quant_enabled():
                reason = "disabled by PADDLE_TPU_QUANT=0"
                hint = ("unset PADDLE_TPU_QUANT and set "
                        "PADDLE_TPU_QUANT_MIN_BYTES to exchange this "
                        "bucket in int8 (the planner that prices it is "
                        "not ported: ROADMAP.md, Queue A item 9)")
            else:
                reason = ("no _quant_buckets plan mark or "
                          "PADDLE_TPU_QUANT_MIN_BYTES threshold engages "
                          "it")
                hint = ("set PADDLE_TPU_QUANT_MIN_BYTES (the planner "
                        "that prices the quant axis is not ported: "
                        "ROADMAP.md, Queue A item 9)")
                _, _, calibrated = _calibration(
                    "quant", nblocks=total // max(
                        dtype_bytes(key[1]), 1) // blk or 1, block=blk)
                if not calibrated:
                    reason += (" (uncalibrated: autotune family 'quant'"
                               " has no measured entry for this shape)")
            yield ctx.diag(
                "quantizable-bucket-not-quantized", Severity.INFO,
                "ring %r %s gradient bucket (%d members, %d bytes, "
                "anchored at %r) prices as an int8 quantization win "
                "(break-even %d bytes) but runs bf16: %s"
                % (key[0], key[1], len(bucket), total, bucket[0][1],
                   mark["min_bytes"], reason),
                block_idx=0, op_idx=bucket[0][0],
                var_names=(bucket[0][1],), hint=hint)


@register_check("collective-crosses-slow-tier")
def check_collective_crosses_slow_tier(ctx):
    """Advisory twin of the hierarchical-collective rewrite
    (``static_analysis/hierarchy.py``): ring-0 gradient buckets that
    will cross the cluster's slow (DCN) tier as a flat single-ring
    exchange — because the rewrite is disabled, the plan mark pins the
    flat schedule, the topology is asymmetric, or no topology is
    stamped at all so the tier split cannot engage.  Mirrors
    ``fusible-pattern-not-fused`` reason discipline; the hint carries
    the priced per-tier byte/ms delta of the reduce-scatter /
    cross-slice allreduce / allgather decomposition."""
    import os

    from .cost import collective_ici_bytes, dtype_bytes
    from .fusion import allreduce_bucket_mb
    from .hierarchy import (HIER_OP_TYPES, hierarchy_enabled,
                            hierarchy_min_bytes, hierarchy_topology)

    block = ctx.program.global_block()
    nranks = (len(ctx.workers) if ctx.workers
              else int(getattr(ctx.program, "_num_trainers", 0) or 0))
    groups = {}
    for i, op in enumerate(block.ops):
        if op.type not in HIER_OP_TYPES:
            continue
        if op.attrs.get("hier_groups"):
            continue  # already a tier hop of a decomposed exchange
        if op.attrs.get("ring_id") not in (0, None):
            continue  # subgroup rings live inside the fast tier
        names = op.inputs.get("X", [])
        if not names or set(names) != set(op.outputs.get("Out", [])):
            continue  # only the in-place grad-allreduce shape
        nranks = max(nranks, int(op.attrs.get("comm_nranks") or 0))
        if op.attrs.get("pre_scale"):  # GradAllReduce stamps 1/nranks
            nranks = max(
                nranks, int(round(1.0 / float(op.attrs["pre_scale"]))))
        nbytes = 0
        for n in names:
            v = block._find_var_recursive(n)
            if v is None or not v.shape or any(
                    int(d) < 0 for d in v.shape):
                nbytes = 0
                break
            numel = 1
            for d in v.shape:
                numel *= int(d)
            nbytes += numel * dtype_bytes(v.dtype)
        if not nbytes:
            continue
        groups.setdefault(op.attrs.get("ring_id"),
                          []).append((i, names[0], nbytes))
    if not groups or nranks < 4:
        return  # a 2-tier split needs >= 2 chips on each tier
    c = hierarchy_topology(ctx.program, nranks=nranks)
    if c is not None and nranks <= c:
        return  # ring fits inside one slice — nothing crosses DCN
    min_bytes = hierarchy_min_bytes(ctx.program)
    mark = getattr(ctx.program, "_hierarchy", None)
    delta = None
    if c is None:
        reason = ("no topology in ClusterSpec — the ring's tier is "
                  "unknown, so the hierarchical rewrite cannot engage")
        hint = ("stamp program._cluster_spec (or set "
                "PADDLE_TPU_CLUSTER_SPEC) with slices/dcn_gbps so "
                "this check can price the per-tier split")
    elif nranks % c:
        reason = ("asymmetric topology: nranks=%d not divisible by "
                  "chips_per_slice=%d, so the hierarchical rewrite "
                  "refuses the ring" % (nranks, c))
        hint = ("repair the topology (slices must tile the ring) or "
                "re-plan on the real chip count")
    elif not hierarchy_enabled(ctx.program):
        if mark is False:
            reason = ("the _hierarchy plan mark pins the flat "
                      "schedule (the planner priced flat as the win)")
            hint = ("re-plan if the topology or model changed since "
                    "the plan was stamped (the planner is not ported: "
                    "ROADMAP.md, Queue A item 9)")
        else:
            reason = "disabled by PADDLE_TPU_HIERARCHY=0"
            hint = ("static_analysis.hierarchy.apply_hierarchy_pass "
                    "decomposes the exchange; the port's fusion resolve "
                    "does not run it yet (ROADMAP.md, Queue A item 7)")
        delta = True
    else:
        return  # rewrite engaged: resolve_fused_program handles these

    # price the per-tier delta on the stamped spec (or its topology
    # defaults) so the hint carries numbers, not vibes
    rates = None
    if delta:
        from ..parallel.planner import ClusterSpec

        raw = getattr(ctx.program, "_cluster_spec", None)
        if raw is None:
            raw = os.environ.get("PADDLE_TPU_CLUSTER_SPEC") or None
        try:
            spec = ClusterSpec.coerce(raw) if raw is not None else None
        except (ValueError, TypeError):
            spec = None
        if spec is None or not spec.has_topology:
            spec = ClusterSpec.coerce(
                {"chips": nranks, "slices": nranks // c})
        rates = spec.tier_wire()

    cap = int(allreduce_bucket_mb(ctx.program) * (1 << 20))
    for ring_id, members in sorted(groups.items(),
                                   key=lambda kv: kv[1][0][0]):
        buckets = []
        cur, cur_bytes = [], 0
        for item in members:
            if cur and cur_bytes + item[2] > cap:
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(item)
            cur_bytes += item[2]
        if cur:
            buckets.append(cur)
        for bucket in buckets:
            total = sum(b for _, _, b in bucket)
            if total < min_bytes:
                continue  # threshold says flat is right — no noise
            hint_txt = hint
            if rates is not None:
                s = nranks // c
                flat_dcn = collective_ici_bytes(
                    "c_allreduce_sum", total, nranks)
                hier_dcn = collective_ici_bytes(
                    "c_allreduce_sum", -(-total // c), s)
                hier_ici = 2 * collective_ici_bytes(
                    "c_allgather", total, c)
                dcn_gbps = rates["dcn"][0]
                ici_gbps = rates.get("ici", rates["dcn"])[0]
                hint_txt = (
                    "%s; decomposing cuts slow-tier bytes %d -> %d "
                    "(%.3f -> %.3f ms DCN wire, +%.3f ms ICI)"
                    % (hint, flat_dcn, hier_dcn,
                       flat_dcn / (dcn_gbps * 1e9) * 1e3,
                       hier_dcn / (dcn_gbps * 1e9) * 1e3,
                       hier_ici / (ici_gbps * 1e9) * 1e3))
            yield ctx.diag(
                "collective-crosses-slow-tier", Severity.INFO,
                "ring %r gradient bucket (%d members, %d bytes, "
                "anchored at %r) crosses the slow tier flat "
                "(nranks=%d%s): %s"
                % (ring_id, len(bucket), total, bucket[0][1], nranks,
                   "" if c is None else ", chips_per_slice=%d" % c,
                   reason),
                block_idx=0, op_idx=bucket[0][0],
                var_names=(bucket[0][1],), hint=hint_txt)


def _overlap_pair_sites(block):
    """Per-bucket start/wait op indices in one block, keyed by the
    ``overlap_bucket`` attr that links a pair's twins."""
    starts, waits = {}, {}
    for i, op in enumerate(block.ops):
        if op.type == "c_allreduce_start":
            starts.setdefault(op.attrs.get("overlap_bucket"),
                              []).append(i)
        elif op.type == "c_allreduce_wait":
            waits.setdefault(op.attrs.get("overlap_bucket"),
                             []).append(i)
    return starts, waits


@register_check("collective-start-without-wait")
def check_collective_start_without_wait(ctx):
    """A ``c_allreduce_start`` with no matching ``c_allreduce_wait``
    after it (same ``overlap_bucket``, same block): the in-flight
    reduction has no consumer barrier, so nothing orders the optimizer
    behind the ring — the step would read whatever the async transfer
    happened to deliver.  Extends the collective ring-pairing battery
    to the split-collective form."""
    for block in ctx.program.blocks:
        starts, waits = _overlap_pair_sites(block)
        for b, sidxs in sorted(starts.items(),
                               key=lambda kv: kv[1][0]):
            avail = sorted(waits.get(b, []))
            for s in sorted(sidxs):
                w = next((x for x in avail if x > s), None)
                if w is not None:
                    avail.remove(w)
                    continue
                yield ctx.diag(
                    "collective-start-without-wait", Severity.ERROR,
                    "c_allreduce_start (overlap bucket %r) at block %d "
                    "op %d has no c_allreduce_wait after it — the "
                    "in-flight reduction is never barriered"
                    % (b, block.idx, s),
                    block_idx=block.idx, op_idx=s, op=block.ops[s],
                    hint="the overlap pass emits the pair atomically; "
                         "a hand edit dropped or reordered the wait")


@register_check("wait-without-start")
def check_wait_without_start(ctx):
    """A ``c_allreduce_wait`` with no ``c_allreduce_start`` before it
    (same ``overlap_bucket``, same block): the barrier guards a
    transfer nobody launched, so the 'reduced' values it hands the
    optimizer are the raw local gradients."""
    for block in ctx.program.blocks:
        starts, waits = _overlap_pair_sites(block)
        for b, widxs in sorted(waits.items(),
                               key=lambda kv: kv[1][0]):
            sidxs = sorted(starts.get(b, []))
            w = sorted(widxs)[0]
            if not sidxs or sidxs[0] > w:
                yield ctx.diag(
                    "wait-without-start", Severity.ERROR,
                    "c_allreduce_wait (overlap bucket %r) at block %d "
                    "op %d has no c_allreduce_start before it — the "
                    "barrier guards a reduction nobody launched"
                    % (b, block.idx, w),
                    block_idx=block.idx, op_idx=w, op=block.ops[w],
                    hint="the overlap pass emits the pair atomically; "
                         "a hand edit dropped or reordered the start")


@register_check("double-wait")
def check_double_wait(ctx):
    """More than one ``c_allreduce_wait`` for the same
    ``overlap_bucket`` in one block: the pass emits exactly one
    consumer barrier per bucket — a duplicate re-consumes buffers the
    first wait already settled (and under a real async runtime would
    block on a rendezvous that never fires twice)."""
    for block in ctx.program.blocks:
        _, waits = _overlap_pair_sites(block)
        for b, widxs in sorted(waits.items(),
                               key=lambda kv: kv[1][0]):
            for w in sorted(widxs)[1:]:
                yield ctx.diag(
                    "double-wait", Severity.ERROR,
                    "duplicate c_allreduce_wait for overlap bucket %r "
                    "at block %d op %d (first wait at op %d)"
                    % (b, block.idx, w, sorted(widxs)[0]),
                    block_idx=block.idx, op_idx=w, op=block.ops[w],
                    hint="one wait per bucket: drop the duplicate")


@register_check("overlap-opportunity-unexploited")
def check_overlap_opportunity_unexploited(ctx):
    """Advisory twin of the overlap scheduler: bucketed
    collectives still in fused synchronous form even though the
    liveness plan finds a window of dead compute to hide the wire
    under — because ``PADDLE_TPU_OVERLAP=0`` disables the pass or a
    proof reverted the bucket — plus the degenerate no-window buckets
    (wait would immediately follow start).  Mirrors
    ``fusible-pattern-not-fused``: INFO, with the pass's own reason."""
    from .overlap import OVERLAPPABLE_OP_TYPES, _plan, overlap_enabled

    block = ctx.program.global_block()
    if not any(op.type in OVERLAPPABLE_OP_TYPES for op in block.ops):
        return
    enabled = overlap_enabled(ctx.program)
    report = getattr(ctx.program, "_overlap_report", None)
    by_vars = {frozenset(d.vars): d for d in report.decisions} \
        if report is not None else {}
    decisions, schedule = _plan(ctx.program, ctx.targets, {})
    planned = {d.bucket for d, _, _, _, _ in schedule}
    for dec in decisions:
        coord = dec.fused_idx
        if dec.status == "no-window":
            yield ctx.diag(
                "overlap-opportunity-unexploited", Severity.INFO,
                "bucket of %d gradient(s) (ring %r, anchored at %r) "
                "stays synchronous: %s"
                % (len(dec.vars), dec.ring_id,
                   dec.vars[0] if dec.vars else "?", dec.note),
                block_idx=coord[0], op_idx=coord[1],
                var_names=dec.vars[:1],
                hint="a smaller allreduce bucket cap closes buckets "
                     "earlier and opens a window")
            continue
        if dec.bucket not in planned or dec.window_ops <= 1:
            continue
        if not enabled:
            reason = "disabled by PADDLE_TPU_OVERLAP=0"
            hint = ("static_analysis.overlap.apply_overlap_pass hides "
                    "the wire under %d ops of compute; the port's fusion "
                    "resolve does not run it yet (ROADMAP.md, Queue A "
                    "item 7), so unsetting PADDLE_TPU_OVERLAP alone "
                    "changes nothing" % dec.window_ops)
        else:
            prior = by_vars.get(frozenset(dec.vars))
            if prior is None:
                # the reference's resolve would split it next; the
                # port's does not run the overlap pass yet
                reason = ("the port's fusion resolve does not run the "
                          "overlap pass yet (ROADMAP.md, Queue A item 7)")
                hint = ("static_analysis.overlap.apply_overlap_pass "
                        "plans the split; the executor cannot run "
                        "c_allreduce_start / c_allreduce_wait yet")
            elif prior.status.startswith("reverted"):
                reason = "%s — %s" % (prior.status, prior.note)
                hint = ("fix the in-window hazard (or the ring asymmetry) "
                        "and re-resolve")
            else:
                continue
        yield ctx.diag(
            "overlap-opportunity-unexploited", Severity.INFO,
            "bucket of %d gradient(s) (ring %r, anchored at %r) has a "
            "%d-op window of dead compute but runs synchronous: %s"
            % (len(dec.vars), dec.ring_id,
               dec.vars[0] if dec.vars else "?", dec.window_ops,
               reason),
            block_idx=coord[0], op_idx=coord[1],
            var_names=dec.vars[:1], hint=hint)


@register_check("manual-plan-suboptimal")
def check_manual_plan_suboptimal(ctx):
    """Advisory twin of the auto-parallelism planner: a user-transpiled
    (GradAllReduce-style) program priced against the planner's best
    plan for the same cluster.  Fires when the manual plan is more than
    ``PADDLE_TPU_PLAN_ADVISORY_MARGIN`` (default 15%) worse, naming the
    cheaper plan and the predicted delta.

    Opt-in: needs a cluster spec — ``program._cluster_spec`` or
    ``PADDLE_TPU_CLUSTER_SPEC`` (a JSON file path, inline JSON, or a
    bare chip count); with neither, the check is silent (lint must not
    pay for a planner search nobody asked for).  Planner-emitted
    programs (``_auto_plan_key``) and pipeline-stage workers (their
    pre-transpile program is not reconstructible from one stage) are
    skipped.  The port has no planner search yet: where the reference
    would price the program against it, this check raises
    ``NotImplementedError`` (ROADMAP.md, Queue A item 9) rather than
    report a comparison it cannot make.
    """
    import os as _os

    spec = getattr(ctx.program, "_cluster_spec", None)
    if spec is None:
        spec = _os.environ.get("PADDLE_TPU_CLUSTER_SPEC", "").strip()
    if not spec:
        return
    if getattr(ctx.program, "_auto_plan_key", None) is not None:
        return  # the planner priced this very program already
    if getattr(ctx.program, "_pipeline_stage", None) is not None:
        return
    block = ctx.program.global_block()

    # the invertible manual journey: per-grad allreduce inserted over
    # the same vars (X == Out identity under GSPMD) — exactly what
    # DistributeTranspiler(grad_allreduce)/fleet emit.  ONE predicate
    # for both the gate below and the strip that reconstructs the
    # pre-transpile program, so they cannot drift apart
    def _is_identity_allreduce(op):
        return (op.type in ("c_allreduce_sum", "c_fused_allreduce_sum")
                and set(op.input_arg_names) == set(op.output_arg_names))

    manual_allreduces = [op for op in block.ops
                         if _is_identity_allreduce(op)]
    if not manual_allreduces or any(
            op.type in ("send_v2", "recv_v2") for op in block.ops):
        return

    from ..parallel.planner import ClusterSpec

    try:
        cluster = ClusterSpec.coerce(spec)
    except Exception as e:  # noqa: BLE001 - bad spec is a finding
        yield ctx.diag(
            "manual-plan-suboptimal", Severity.WARNING,
            "cluster spec %r is unusable: %s" % (spec, e),
            hint="PADDLE_TPU_CLUSTER_SPEC takes a JSON file path, "
                 "inline JSON, or a chip count")
        return

    raise NotImplementedError(
        "manual-plan-suboptimal: pricing %d manual allreduce(s) against "
        "the planner's best plan for %r needs the planner's search "
        "(auto_transpile, price_worker_set), which is not ported yet "
        "(ROADMAP.md, Queue A item 9); drop the cluster spec "
        "(program._cluster_spec / PADDLE_TPU_CLUSTER_SPEC) to lint "
        "without it" % (len(manual_allreduces), cluster))


@register_check("decode-shape-unbucketed")
def check_decode_shape_unbucketed(ctx):
    """WARNING: a ``while`` body concatenates a loop-carried tensor with
    fresh per-step data and feeds the result back into the carry — the
    operand's shape grows with the loop index.  That is the classic
    naive KV-append decoder (``k = concat([k, k_step], axis=2)``): on
    TPU every iteration is a NEW shape bucket, so each generated token
    pays a fresh trace+compile plus the host sync that entails — the
    jit cache grows linearly with generated length instead of holding
    one entry.

    The carry set is the while op's ``X``/``Out`` slots plus every
    external var the body writes in place; a concat counts as growing
    when a carried var flows into it (directly or through a chain of
    shape-preserving views) and its result is written back to a carried
    var (directly, via ``assign``, or through such a chain)."""
    _VIEW_OPS = ("assign", "scale", "cast", "reshape", "dropout")
    for block in ctx.program.blocks:
        for op_idx, op in enumerate(block.ops):
            if op.type != "while":
                continue
            carried = set()
            for names in op.inputs.values():
                carried.update(names)
            for names in op.outputs.values():
                carried.update(names)
            carried.discard(EMPTY_VAR_NAME)
            sub = resolve_sub_block(ctx.program, op,
                                    host_block_idx=block.idx)
            if sub is None:
                continue
            # in-place writes to externals are carries too (increment /
            # kv_cache_write idiom): written in the body, defined outside
            local = {v for v in sub.vars}
            for b_op in sub.ops:
                for n in b_op.output_arg_names:
                    if n != EMPTY_VAR_NAME and n not in local:
                        carried.add(n)
            # taint: carried names + anything view-derived from them
            tainted = set(carried)
            grown = {}  # var name -> (op_idx in sub, concat op)
            for b_idx, b_op in enumerate(sub.ops):
                ins = [n for n in b_op.input_arg_names
                       if n != EMPTY_VAR_NAME]
                outs = [n for n in b_op.output_arg_names
                        if n != EMPTY_VAR_NAME]
                if b_op.type == "concat" and tainted.intersection(ins):
                    if set(outs) & carried:  # concat straight into carry
                        yield ctx.diag(
                            "decode-shape-unbucketed", Severity.WARNING,
                            "while body grows a loop-carried tensor: "
                            "concat(axis=%s) over carried %s writes the "
                            "carry itself — each iteration is a new "
                            "shape bucket (an eager warm-up and a new "
                            "graph capture per token)"
                            % (b_op.attrs.get("axis"),
                               sorted(tainted.intersection(ins))[:2]),
                            block_idx=sub.idx, op_idx=b_idx, op=b_op,
                            var_names=tuple(sorted(set(outs)
                                                   & carried))[:3],
                            hint="keep decode shapes static with a "
                                 "ring-buffer KV cache: "
                                 "layers.create_kv_cache(...) + "
                                 "kv_cache_write(cache, x, cursor) + "
                                 "flash_decode(q, k_cache, v_cache, "
                                 "cursor) — see layers.decode_loop")
                        continue
                    for n in outs:
                        grown[n] = (b_idx, b_op)
                    continue
                hit = grown.keys() & set(ins)
                if hit:
                    # does the grown value reach a carried var?
                    if set(outs) & carried:
                        g_idx, g_op = grown[next(iter(hit))]
                        axis = g_op.attrs.get("axis")
                        yield ctx.diag(
                            "decode-shape-unbucketed", Severity.WARNING,
                            "while body grows a loop-carried tensor: "
                            "concat(axis=%s) over carried %s is written "
                            "back to the carry via %r — each iteration "
                            "is a new shape bucket (an eager warm-up and "
                            "a new graph capture per token)"
                            % (axis,
                               sorted(tainted.intersection(
                                   g_op.input_arg_names))[:2],
                               b_op.type),
                            block_idx=sub.idx, op_idx=g_idx, op=g_op,
                            var_names=tuple(sorted(set(outs)
                                                   & carried))[:3],
                            hint="keep decode shapes static with a "
                                 "ring-buffer KV cache: "
                                 "layers.create_kv_cache(...) + "
                                 "kv_cache_write(cache, x, cursor) + "
                                 "flash_decode(q, k_cache, v_cache, "
                                 "cursor) — see layers.decode_loop")
                        for n in hit:
                            grown.pop(n, None)
                    elif b_op.type in _VIEW_OPS:
                        for n in outs:
                            grown[n] = grown[next(iter(hit))]
                if b_op.type in _VIEW_OPS and tainted.intersection(ins):
                    tainted.update(outs)


#: size floor (bytes) below which a slot-ring KV cache is not worth
#: paging — the block table + free-list overhead beats the saving
PAGED_MIN_BYTES_ENV = "PADDLE_TPU_PAGED_MIN_BYTES"
DEFAULT_PAGED_MIN_BYTES = 4 << 20


def paged_min_bytes():
    import os

    raw = os.environ.get(PAGED_MIN_BYTES_ENV)
    if raw:
        try:
            return int(raw)
        except ValueError:
            pass
    return DEFAULT_PAGED_MIN_BYTES


@register_check("decode-cache-unpaged")
def check_decode_cache_unpaged(ctx):
    """Advisory twin of the paged-KV serving path: a large
    persistable slot-ring KV cache written by ``kv_cache_write`` /
    ``kv_cache_prefill`` that would run through the paged pool
    (``paged_kv_cache_*`` + ``DecodeEngine`` paged mode) instead.  The
    slot ring reserves ``Tmax`` rows per stream no matter how short
    the stream actually runs; the paged pool bounds that internal
    fragmentation at one ``block_len`` block per stream, which is the
    whole streams-per-chip lever.  Mirrors the reason discipline of
    ``fusible-pattern-not-fused``: names the kill switch when
    ``PADDLE_TPU_PAGED_KV=0`` is the blocker, otherwise points at the
    missing paged builders.  Gated by ``PADDLE_TPU_PAGED_MIN_BYTES``
    (default 4 MiB) so toy caches stay quiet."""
    from .cost import dtype_bytes

    floor = paged_min_bytes()
    seen = set()
    for block in ctx.program.blocks:
        for op_idx, op in enumerate(block.ops):
            if op.type not in ("kv_cache_write", "kv_cache_prefill"):
                continue
            names = op.inputs.get("Cache", [])
            if not names or names[0] in seen:
                continue
            name = names[0]
            v = block._find_var_recursive(name)
            if v is None or not getattr(v, "persistable", False):
                continue
            shape = [int(d) for d in (v.shape or [])]
            if len(shape) != 4 or any(d <= 0 for d in shape):
                continue
            seen.add(name)
            slots, heads, tmax, dh = shape
            nbytes = slots * heads * tmax * dh * dtype_bytes(v.dtype)
            if nbytes < floor:
                continue
            try:
                from ..ops.cuda.paged_flash_decode import \
                    paged_block_len
                from ..serving.paging import paged_kv_enabled
                bl = paged_block_len(tmax)
                enabled = paged_kv_enabled()
            except Exception:  # pragma: no cover - serving stack absent
                bl, enabled = 16, True
            # the ring's worst-case idle reservation is the full Tmax
            # row per stream; paging bounds it at one block
            saving = 100.0 * (1.0 - bl / float(tmax)) if tmax else 0.0
            if not enabled:
                reason = ("disabled by the PADDLE_TPU_PAGED_KV=0 kill "
                          "switch")
                hint = ("unset PADDLE_TPU_PAGED_KV to let a "
                        "paged-capable model use the pool")
            else:
                reason = ("the program builds the slot-ring path only "
                          "(no paged_kv_cache_* ops)")
                hint = ("give the model build_prefill_paged/"
                        "build_step_paged (layers.paged_kv_cache_"
                        "prefill/write + layers.paged_flash_decode) — "
                        "DecodeEngine pages it automatically")
            yield ctx.diag(
                "decode-cache-unpaged", Severity.INFO,
                "persistable KV cache %r ([%d, %d, %d, %d], %d bytes) "
                "is slot-ring managed: every stream reserves the full "
                "%d-row depth up front; paging (block_len=%d) would "
                "bound idle reservation at one block — up to %.0f%% "
                "less HBM fragmentation per stream: %s"
                % (name, slots, heads, tmax, dh, nbytes, tmax, bl,
                   saving, reason),
                block_idx=block.idx, op_idx=op_idx, op=op,
                var_names=(name,), hint=hint)
