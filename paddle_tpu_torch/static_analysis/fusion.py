"""Program-IR fusion pipeline, the reference's eight families.

Mirrors ``paddle_tpu/static_analysis/fusion.py``: ``resolve_fused_program``
(:2014) with its families, in its order (:1783-1792),

========================  ==================================================
family                    rewrite
========================  ==================================================
``attention`` (:602)      matmul(QKᵀ·α) → (+ [B,1,1,Tk] bias) → softmax →
                          (upscale_in_train dropout) → matmul(·V) ⇒ one
                          ``fused_multihead_attention`` (K1, the flash
                          attention kernels, forward and dK/dV + dQ), gated
                          on T reaching :func:`_flash_min_t` (the card's
                          measured decision from the autotune cache, else
                          512) and on shapes K1 takes (head dim 1-128,
                          float32 or bfloat16, K and V alike)
``conv_bn_act`` (:1201)   conv2d → batch_norm (→ activation) ⇒ one
                          ``fused_conv_bn_act`` (the K4 epilogue kernels
                          on a channels-last output), gated on the conv
                          output reaching ``PADDLE_TPU_CONV_BN_MIN_BYTES``
                          (default 4096) times its calibration factor;
                          the AMP cast sandwich is absorbed
``softmax_xent`` (:1087)  softmax → cross_entropy ⇒ one
                          ``softmax_with_cross_entropy`` (its logsumexp
                          form), placed at the softmax
``dropout_add_ln`` (:843)  (dropout) → elementwise_add → layer_norm over
                          the last axis ⇒ one ``fused_dropout_add_ln`` (the
                          fused LN kernels)
``bias_act`` (:1007)      elementwise_add(·, 1-D persistable bias) →
                          activation ⇒ ``fused_bias_act`` (the same math)
``embedding_gather``      ``lookup_table``/``embedding`` on a persistable
(:1427)                   2-D table ⇒ ``fused_embedding_gather`` (the
                          gather kernel), gated on ``D % 128 == 0`` and the
                          gathered slab at a nominal batch of 8 times its
                          calibration factor reaching
                          ``PADDLE_TPU_EMBED_FUSE_MIN_BYTES`` (default 4096)
``optimizer`` (:1521)     a run of per-parameter ``adam``/``sgd`` ops with
                          one key (type, dtypes, LearningRate, Adam's
                          hyperparameters) ⇒ one ``fused_adam`` /
                          ``fused_sgd`` (the multi-tensor update kernels),
                          gated by the reference's traffic model and
                          formula (``optimizer_fuse_overhead_bytes``)
``allreduce`` (:1638)     the in-place ``c_allreduce_sum`` of each gradient
                          (``GradAllReduce``), grouped by (ring,
                          ``pre_scale``, dtype) into buckets of at most
                          ``allreduce_bucket_mb`` (default 32 MB) in
                          program order ⇒ one ``c_fused_allreduce_sum``
                          per bucket, or ``c_allreduce_quant`` (the int8
                          exchange on K7) once the bucket reaches
                          ``quant.quant_min_bytes``
========================  ==================================================

The gates' calibration factors come from the autotune cache
(:mod:`paddle_tpu_torch.autotune`, :func:`_calibration`, :182-195).  A
resolved clone keeps the values it read there (each site's factor under
its signature; the flash threshold is part of the config signature), and
a later call resolves the program again only when one of those values
moved: a write of another signature, by either package or by the drift
monitor, leaves every program that did not read it alone.  Training
programs are rewritten with their grad twins, as in the reference: every
grad op carries ``__fwd_op_id__``, so a matched forward pattern's grad
ops are found
exactly (``_GlobalView.twin``, :472-489, :526) and replaced by the
fused op's one ``<type>_grad`` (:778, :972, :1062, :1166, :1495), whose
lowering differentiates the fused op's recorded graph
(``ops/registry.py``).  A pattern whose twins are not all there, or not
the expected ones, is left alone.  A rewritten attention chain with
dropout draws its mask in K1 from the fused op's own stream, not the
dropout op's (the rewrite's note says so).  The executor runs a
rewritten CLONE, cached on the original program by (config signature,
program version, fetch set); the user's program is never mutated.  Kill
switch: ``PADDLE_TPU_FUSION=0``.

After the families the resolve runs the hierarchical decomposition and
then the overlap scheduler on the clone (``_run_hierarchy_pass``,
``_run_overlap_pass``, the reference's :1956-2007, :2069-2072): a
bucket whose ring spans slices becomes ``c_hier_reducescatter`` → the
cross-slice ``c_allreduce_sum`` → ``c_hier_allgather``, and a bucket
with a window of compute after its last member becomes a
``c_allreduce_start`` / ``c_allreduce_wait`` pair; the clone is kept
when only they fired.  ``PADDLE_TPU_HIERARCHY=0`` and
``PADDLE_TPU_OVERLAP=0`` keep the flat fused buckets, bit for bit.

The executor's resolved clone carries the program marks the families
and the collectives read (``_num_trainers``, ``_trainer_id``,
``_allreduce_bucket_mb``, ``_quant_buckets``, ``_overlap``, ...), as
the reference's ``_PROGRAM_MARKS`` (:119), and ``_sync_batch_stats``,
which the data-parallel runner stamps (``parallel/__init__.py``).

Each family is bracketed by the verifier when pass verification is on
(``PADDLE_TPU_VERIFY_PASSES``, on in the tests), as in the reference
(:1815-1910): a family that introduces an ERROR finding the program did
not have before the pipeline raises ``VerifyError`` naming it.
:func:`scan_fusible_patterns` dry-runs the matchers for the
``fusible-pattern-not-fused`` advisory (:1914).
"""

import functools
import os
import threading

from ..ops.registry import EMPTY_VAR_NAME
from .defuse import resolve_sub_block, sub_block_reads_recursive

__all__ = ["FusionConfig", "FusionRewrite", "FusionSkip", "FusionReport",
           "fusion_enabled", "conv_bn_min_bytes", "embed_fuse_min_bytes",
           "allreduce_bucket_mb", "optimizer_fuse_overhead_bytes",
           "apply_fusion_passes", "resolve_fused_program",
           "scan_fusible_patterns", "FUSED_FORWARD_OP_TYPES"]

# fused forward op types the reference's pipeline emits (roster for the
# fused-op-missing-grad check; ``fusion.py:99``)
FUSED_FORWARD_OP_TYPES = frozenset((
    "fused_multihead_attention", "fused_dropout_add_ln",
    "fused_bias_act", "softmax_with_cross_entropy",
    "fused_conv_bn_act", "fused_embedding_gather",
    # decode family: emitted by the decode layers, never by a rewrite —
    # listed so the fused-op-missing-grad check treats them as
    # already-fused kernels (forward-only by design)
    "flash_decode_attention", "paged_flash_decode_attention",
))

_DTYPE_BYTES = {"float64": 8, "int64": 8, "float32": 4, "int32": 4,
                "float16": 2, "bfloat16": 2, "int16": 2, "int8": 1,
                "uint8": 1, "bool": 1}
_FUSION_CACHE_CAP = 16
_MAX_REWRITES = 10000
# program marks Program.clone() does not carry that the resolved clone
# must keep (the reference's _PROGRAM_MARKS, :119, as far as the port
# reads them)
_PROGRAM_MARKS = ("_num_trainers", "_trainer_id", "_host_tables",
                  "_hbm_budget",
                  "_nan_guard", "_guard_loss_name", "_pipeline_stage",
                  "_allreduce_bucket_mb", "_shard_optimizer_state",
                  "_quant_buckets", "_overlap", "_hierarchy",
                  "_cluster_spec", "_sync_batch_stats")


def fusion_enabled():
    """Global kill switch: ``PADDLE_TPU_FUSION=0`` disables every pass."""
    return os.environ.get("PADDLE_TPU_FUSION", "1") != "0"


def conv_bn_min_bytes():
    """Minimum conv-output bytes for the conv + BN + act rewrite
    (``PADDLE_TPU_CONV_BN_MIN_BYTES``, default 4096)."""
    try:
        return int(os.environ.get(
            "PADDLE_TPU_CONV_BN_MIN_BYTES", "4096") or 4096)
    except ValueError:
        return 4096


def embed_fuse_min_bytes():
    """Minimum gathered-slab bytes for the embedding-gather rewrite
    (``PADDLE_TPU_EMBED_FUSE_MIN_BYTES``, default 4096)."""
    try:
        return int(os.environ.get(
            "PADDLE_TPU_EMBED_FUSE_MIN_BYTES", "4096") or 4096)
    except ValueError:
        return 4096


def _autotune_state():
    """The autotune cache's state token: a write, of any signature, gives
    a new one.  Not part of any signature: it says only when the values
    a resolution read must be looked at again (:func:`_reads_moved`)."""
    from ..autotune import state_token

    return state_token()


# the calibration reads of the resolution running on this thread
_reading = threading.local()


def _calibration_value(sig):
    """``(factor, calibrated)`` of ``sig`` in the autotune cache now."""
    from ..autotune import autotune_enabled, calibration_factor, lookup

    if not autotune_enabled():
        return 1.0, False
    return calibration_factor(sig), lookup(sig) is not None


def _calibration(family, **key):
    """``(factor, sig, calibrated)`` of one fusion site (:182): the
    autotune calibration factor the gate multiplies its predicted delta
    by, the signature it looked under, and whether a measured entry
    exists.  A resolution in progress keeps the value it read."""
    from ..autotune import sweep_signature

    sig = sweep_signature(family, key)
    factor, calibrated = _calibration_value(sig)
    reads = getattr(_reading, "reads", None)
    if reads is not None:
        reads[sig] = (factor, calibrated)
    return factor, sig, calibrated


def _reads_moved(reads):
    """Whether a calibration a resolution read has another value now."""
    return any(_calibration_value(sig) != val for sig, val in reads.items())


def _uncalibrated(sig):
    return (" — uncalibrated: no autotune cache entry for %r yet; a "
            "silicon sweep (paddle_tpu_torch.autotune.sweep) re-decides "
            "this gate" % sig)


def _flash_min_t(state=None):
    """``flash_min_t()``, looked up once per (autotune state, env value):
    every executor call computes the fusion signature."""
    return _flash_min_t_at(_autotune_state() if state is None else state,
                           os.environ.get("PADDLE_TPU_FLASH_MIN_T"))


@functools.lru_cache(maxsize=16)
def _flash_min_t_at(state, env):
    from ..ops.cuda.flash_attention import flash_min_t

    return flash_min_t()


def allreduce_bucket_mb(program=None):
    """Gradient-allreduce bucket cap in MB: the program's
    ``_allreduce_bucket_mb`` mark, else ``PADDLE_TPU_ALLREDUCE_BUCKET_MB``,
    default 32 (``fusion.py:198``)."""
    mark = getattr(program, "_allreduce_bucket_mb", None) \
        if program is not None else None
    if mark:
        try:
            return float(mark)
        except (TypeError, ValueError):
            pass
    try:
        return float(os.environ.get(
            "PADDLE_TPU_ALLREDUCE_BUCKET_MB", "32") or 32)
    except ValueError:
        return 32.0


# the CUDA default of optimizer_fuse_overhead_bytes: the device time of one
# small Adam update (768 elements, its two launches) in a replayed CUDA
# graph, 3.03 us on an NVIDIA H100 80GB HBM3 at a 700 W power limit
# (chip_smoke.py _small_update_overhead), as bytes at 3.35 TB/s
_CUDA_OVERHEAD_BYTES = 10_150_000


def optimizer_fuse_overhead_bytes():
    """Per-op overhead the multi-tensor optimizer fusion is credited with
    removing, as bytes of device-memory traffic (``fusion.py:218-242``):
    ``PADDLE_TPU_FUSE_OPT_OVERHEAD_BYTES`` overrides; else 256 KiB on a
    host without CUDA, the reference's CPU default, so both packages fuse
    the same programs there, and on a CUDA host the launch and ramp of one
    small update kernel as bytes at 3.35 TB/s (``_CUDA_OVERHEAD_BYTES``;
    ``chip_smoke.py`` measures it: PERF.md)."""
    val = os.environ.get("PADDLE_TPU_FUSE_OPT_OVERHEAD_BYTES", "").strip()
    if val:
        try:
            return int(val)
        except ValueError:
            pass
    import torch

    return _CUDA_OVERHEAD_BYTES if torch.cuda.is_available() \
        else (256 << 10)


class FusionConfig:
    """Which families run; ``enabled`` follows the kill switch."""

    __slots__ = ("enabled", "fuse_attention", "fuse_elewise",
                 "fuse_softmax_xent", "fuse_conv_bn_act",
                 "fuse_embedding_gather", "fuse_optimizer", "fuse_allreduce")

    def __init__(self, enabled=None, fuse_attention=True, fuse_elewise=True,
                 fuse_softmax_xent=True, fuse_conv_bn_act=True,
                 fuse_embedding_gather=True, fuse_optimizer=True,
                 fuse_allreduce=True):
        self.enabled = fusion_enabled() if enabled is None else bool(enabled)
        self.fuse_attention = bool(fuse_attention)
        self.fuse_elewise = bool(fuse_elewise)
        self.fuse_softmax_xent = bool(fuse_softmax_xent)
        self.fuse_conv_bn_act = bool(fuse_conv_bn_act)
        self.fuse_embedding_gather = bool(fuse_embedding_gather)
        self.fuse_optimizer = bool(fuse_optimizer)
        self.fuse_allreduce = bool(fuse_allreduce)

    @classmethod
    def default(cls):
        return cls()

    @classmethod
    def from_build_strategy(cls, bs):
        """The families a ``BuildStrategy``'s ``fuse_*`` knobs leave on
        (the reference's :277); ZeRO-1 turns the optimizer family off,
        since a multi-tensor update would read whole moments."""
        c = cls()
        if bs is None:
            return c
        c.fuse_elewise = bool(getattr(bs, "fuse_elewise_add_act_ops", True))
        c.fuse_optimizer = (
            bool(getattr(bs, "fuse_all_optimizer_ops", True))
            and not getattr(bs, "shard_optimizer_state", False))
        c.fuse_allreduce = bool(getattr(bs, "fuse_all_reduce_ops", True))
        c.fuse_attention = bool(getattr(bs, "fuse_attention", True))
        c.fuse_softmax_xent = bool(getattr(bs, "fuse_softmax_xent", True))
        c.fuse_conv_bn_act = bool(getattr(bs, "fuse_bn_act_ops", True))
        c.fuse_embedding_gather = bool(
            getattr(bs, "fuse_embedding_gather", True))
        return c

    def signature(self, program=None):
        """Hashable identity of the rewrite of ``program``: the bucket cap
        and the quant threshold resolve mark → env → default, so the
        program's marks are part of it; the flash threshold's value is
        too (the autotune cache's decision or the env's override); the
        calibration factors a resolution read are kept with its clone
        (:func:`resolve_fused_program`)."""
        from ..quant.blockwise import quant_block
        from ..quant.collective import quant_min_bytes
        from .hierarchy import hierarchy_signature
        from .overlap import overlap_enabled

        return (self.enabled, self.fuse_attention, self.fuse_elewise,
                self.fuse_softmax_xent, self.fuse_conv_bn_act,
                self.fuse_embedding_gather, self.fuse_optimizer,
                self.fuse_allreduce, conv_bn_min_bytes(),
                embed_fuse_min_bytes(), optimizer_fuse_overhead_bytes(),
                allreduce_bucket_mb(program), quant_min_bytes(program),
                quant_block(), _flash_min_t(), overlap_enabled(program),
                hierarchy_signature(program))

    def __repr__(self):
        return "FusionConfig%r" % (self.signature(),)


class FusionRewrite:
    """One applied rewrite: family, fused op type, original op indices."""

    __slots__ = ("family", "fused_op_type", "op_idxs", "vars", "predicted",
                 "note", "block_idx")

    def __init__(self, family, fused_op_type, op_idxs, vars=(),
                 predicted=None, note="", block_idx=0):
        self.family = family
        self.fused_op_type = fused_op_type
        self.block_idx = block_idx
        self.op_idxs = tuple(op_idxs)
        self.vars = tuple(vars)
        self.predicted = dict(predicted or {})
        self.note = note

    def __repr__(self):
        return "[%s] ops %s -> %s %s" % (self.family, list(self.op_idxs),
                                          self.fused_op_type, self.note)


class FusionSkip:
    """A matched-but-not-rewritten pattern and why."""

    __slots__ = ("family", "op_idx", "op_type", "reason", "key",
                 "block_idx")

    def __init__(self, family, op_idx, op_type, reason, key=None,
                 block_idx=0):
        self.family = family
        self.block_idx = block_idx
        self.op_idx = op_idx
        self.op_type = op_type
        self.reason = reason
        self.key = key

    def __repr__(self):
        return "[%s] op %d (%s) skipped: %s" % (
            self.family, self.op_idx, self.op_type, self.reason)


class FusionReport:
    """Outcome of one pipeline run over one program."""

    def __init__(self, config):
        self.config = config
        self.applied = []
        self.skipped = []

    def record(self, rewrite):
        self.applied.append(rewrite)

    def skip(self, family, op_idx, op_type, reason, key=None):
        entry = FusionSkip(family, op_idx, op_type, reason, key=key)
        for n, s in enumerate(self.skipped):
            if key is not None and s.family == family and s.key == key:
                self.skipped[n] = entry
                return
        self.skipped.append(entry)

    def counts(self):
        out = {}
        for r in self.applied:
            out[r.family] = out.get(r.family, 0) + 1
        return out


def _is_grad_op(op):
    return op.type.endswith("_grad") \
        or op.attrs.get("op_role") == "backward"


class _GlobalView:
    """Def/use indexes over the global block, rebuilt after every
    rewrite.  Sub-block reads count as consumers."""

    def __init__(self, program, targets=()):
        self.program = program
        self.block = program.global_block()
        self.targets = {getattr(t, "name", t) for t in (targets or ())}
        self.refresh()

    def refresh(self):
        self.consumers = {}
        self.producers = {}
        self.closure_reads = set()
        self.grad_twins = {}  # forward __op_id__ → [(idx, grad op)]
        self.op_index = {}
        for idx, op in enumerate(self.block.ops):
            self.op_index[id(op)] = idx
            for n in op.input_arg_names:
                if n and n != EMPTY_VAR_NAME:
                    self.consumers.setdefault(n, []).append((idx, op))
            for n in op.output_arg_names:
                if n and n != EMPTY_VAR_NAME:
                    self.producers.setdefault(n, []).append((idx, op))
            sub = resolve_sub_block(self.program, op,
                                    host_block_idx=self.block.idx)
            if sub is not None:
                self.closure_reads.update(
                    sub_block_reads_recursive(self.program, sub))
            fwd_id = op.attrs.get("__fwd_op_id__")
            if fwd_id is not None and _is_grad_op(op):
                self.grad_twins.setdefault(fwd_id, []).append((idx, op))

    def idx_of(self, op):
        return self.op_index[id(op)]

    def var(self, name):
        return self.block._find_var_recursive(name)

    def shape(self, name):
        v = self.var(name)
        return None if v is None else v.shape

    def twin(self, op, expect_type):
        """The unique grad twin ``(idx, op)`` of ``op`` with the expected
        type; None when it has none, False when the twins are not what
        the rewrite expects (the match is then refused)."""
        twins = [t for t in self.grad_twins.get(op.attrs.get("__op_id__"),
                                                ())
                 if t[1].type == expect_type]
        if not twins:
            return None
        return twins[0] if len(twins) == 1 else False

    def group_twins(self, group):
        """``[(op, (idx, grad op))]`` for a pattern's ops: all of them
        twinned or none; None when that does not hold."""
        twins = []
        for o in group:
            t = self.twin(o, o.type + "_grad")
            if t is False:
                return None
            if t is not None:
                twins.append((o, t))
        if twins and len(twins) != len(group):
            return None
        return twins

    def twin_ops(self, group):
        return [t for o in group
                for _, t in self.grad_twins.get(o.attrs.get("__op_id__"), ())]

    def sole_fwd_consumer(self, name):
        if name in self.targets or name in self.closure_reads:
            return None
        fwd = [(i, o) for i, o in self.consumers.get(name, ())
               if not _is_grad_op(o)]
        return fwd[0] if len(fwd) == 1 else None

    def unconsumed(self, name, group_ops):
        """Every consumer of ``name`` is in ``group_ops`` and the name is
        neither fetched nor persistable."""
        if name in self.targets or name in self.closure_reads:
            return False
        v = self.var(name)
        if v is not None and v.persistable:
            return False
        ids = {id(o) for o in group_ops}
        return all(id(o) in ids for _, o in self.consumers.get(name, ()))


def _replace_ops(block, replacements, removals):
    block.ops[:] = [replacements.get(i, op) for i, op in enumerate(block.ops)
                    if i in replacements or i not in removals]
    block.program._bump_version()


def _new_op(block, type, inputs, outputs, attrs, dry_run=False):
    """A fused op for ``block``; a dry run's op belongs to no block, so
    it takes no op id from the program."""
    from ..framework import Operator

    return Operator(None if dry_run else block, type, inputs, outputs,
                    attrs)


def _grad_attrs(fwd_op):
    """Attrs of a fused op's grad twin: the forward's, tied to it by
    ``__fwd_op_id__``."""
    attrs = dict(fwd_op.attrs)
    attrs.pop("__op_id__", None)
    attrs["__fwd_op_id__"] = fwd_op.attrs.get("__op_id__", 0)
    attrs["op_role"] = "backward"
    return attrs


def _grad_out(grad_op, slot):
    names = grad_op.outputs.get(slot, [])
    return names[0] if names else EMPTY_VAR_NAME


def _replace_twins(twins, gfused, replacements, removals):
    """Put the fused grad op where the pattern's first grad op was and
    drop the others."""
    first = min(t[0] for _, t in twins)
    replacements[first] = gfused
    removals |= {t[0] for _, t in twins} - set(replacements)


def _numel(shape, batch=1):
    if shape is None:
        return None
    n = 1
    for d in shape:
        n *= batch if (d is None or int(d) < 0) else max(int(d), 1)
    return n


def _var_bytes(view, name, batch=1):
    v = view.var(name)
    if v is None or v.shape is None:
        return 0
    return (_numel(v.shape, batch) or 0) * _DTYPE_BYTES.get(str(v.dtype), 4)


def _find_dropout_add_ln(view, report, dry_run=False):
    block = view.block
    for op in block.ops:
        if op.type != "layer_norm" or _is_grad_op(op):
            continue
        x_in = op.inputs.get("X", [None])[0]
        scale = op.inputs.get("Scale", [None])
        bias = op.inputs.get("Bias", [None])
        if not scale or not bias or scale[0] is None or bias[0] is None:
            continue
        xs = view.shape(x_in)
        if not xs or int(op.attrs.get("begin_norm_axis", 1)) != len(xs) - 1:
            continue
        d = xs[-1]
        if d is None or int(d) <= 0:
            continue
        prods = view.producers.get(x_in, [])
        if len(prods) != 1 or prods[0][1].type != "elementwise_add":
            continue
        add_op = prods[0][1]
        sole = view.sole_fwd_consumer(x_in)
        if sole is None or sole[1] is not op:
            continue
        a = add_op.inputs.get("X", [None])[0]
        bm = add_op.inputs.get("Y", [None])[0]
        if view.shape(a) != view.shape(bm):
            continue
        drop_op = None
        x_name, res_name = bm, a
        for cand, other in ((a, bm), (bm, a)):
            p = view.producers.get(cand, [])
            if len(p) == 1 and p[0][1].type == "dropout" \
                    and not _is_grad_op(p[0][1]):
                dp = p[0][1]
                sole = view.sole_fwd_consumer(cand)
                if sole is None or sole[1] is not add_op:
                    continue
                if dp.attrs.get("dropout_implementation") \
                        != "upscale_in_train":
                    continue
                drop_op = dp
                x_name, res_name = dp.inputs["X"][0], other
                break
        group = ([drop_op] if drop_op else []) + [add_op, op]
        rate = 0.0
        if drop_op is not None:
            rate = float(drop_op.attrs.get("dropout_prob", 0.0) or 0.0)
            mask = drop_op.outputs.get("Mask", [None])[0]
            if mask and not view.unconsumed(mask,
                                            group + view.twin_ops(group)):
                continue
        twins = view.group_twins(group)
        if twins is None:
            continue
        all_ops = group + [t[1] for _, t in twins]
        removed = [x_in] + ([drop_op.outputs["Out"][0]] if drop_op else [])
        removed += [n for s in ("Mean", "Variance")
                    for n in op.outputs.get(s, []) if n]
        if not all(view.unconsumed(n, all_ops) for n in removed):
            continue
        ln_twin = next((t[1] for o, t in twins if o is op), None)
        add_twin = next((t[1] for o, t in twins if o is add_op), None)
        drop_twin = next((t[1] for o, t in twins if o is drop_op), None)
        if twins:
            # the grads between the pattern's ops must stay inside it
            internal = [_grad_out(ln_twin, "X@GRAD")]
            if drop_op is not None:
                internal.append(_grad_out(
                    add_twin, "Y@GRAD" if add_op.inputs["Y"][0]
                    == drop_op.outputs["Out"][0] else "X@GRAD"))
            if any(n != EMPTY_VAR_NAME and not view.unconsumed(n, all_ops)
                   for n in internal):
                continue
        n_rows = _numel(xs[:-1])
        predicted = {"hbm_bytes_saved": 2 * (len(group) - 1)
                     * (n_rows or 1) * int(d) * 4,
                     "ops_removed": len(group) - 1}
        fattrs = {"dropout_prob": rate,
                  "epsilon": float(op.attrs.get("epsilon", 1e-5))}
        if drop_op is not None and "is_test" in drop_op.attrs:
            fattrs["is_test"] = drop_op.attrs["is_test"]
        ins = {"X": [x_name], "Residual": [res_name], "Scale": [scale[0]],
               "Bias": [bias[0]]}
        fused = _new_op(block, "fused_dropout_add_ln", ins,
                        {"Out": [op.outputs["Y"][0]]}, fattrs, dry_run)
        replacements = {view.idx_of(op): fused}
        removals = {view.idx_of(o) for o in group} - set(replacements)
        if twins:
            if drop_op is not None:
                x_grad = _grad_out(drop_twin, "X@GRAD")
                res_grad = _grad_out(add_twin, "X@GRAD" if add_op.inputs[
                    "X"][0] == res_name else "Y@GRAD")
            else:
                x_slot = "Y@GRAD" if add_op.inputs["Y"][0] == x_name \
                    else "X@GRAD"
                x_grad = _grad_out(add_twin, x_slot)
                res_grad = _grad_out(add_twin, "X@GRAD" if x_slot == "Y@GRAD"
                                     else "Y@GRAD")
            g_ins = dict(ins, Out=[op.outputs["Y"][0]],
                         **{"Out@GRAD": list(ln_twin.inputs.get(
                             "Y@GRAD", [EMPTY_VAR_NAME]))})
            g_outs = {"X@GRAD": [x_grad], "Residual@GRAD": [res_grad],
                      "Scale@GRAD": [_grad_out(ln_twin, "Scale@GRAD")],
                      "Bias@GRAD": [_grad_out(ln_twin, "Bias@GRAD")]}
            gfused = _new_op(block, "fused_dropout_add_ln_grad", g_ins, g_outs,
                             _grad_attrs(fused), dry_run)
            _replace_twins(twins, gfused, replacements, removals)
        match = {"replacements": replacements, "removals": removals,
                 "rewrite": FusionRewrite(
                     "dropout_add_ln", "fused_dropout_add_ln",
                     sorted({view.idx_of(o) for o in group}
                            | {t[0] for _, t in twins}),
                     vars=(x_name, res_name), predicted=predicted,
                     note="dropout rate %.3g (the mask stream differs from "
                     "the unfused dropout op's)" % rate if rate
                     else "rate 0: the same math as the unfused ops")}
        if dry_run:
            report.record(match["rewrite"])
            continue
        return match
    return None


_ACT_TYPES = ("relu", "gelu", "tanh", "sigmoid", "relu6", "leaky_relu",
              "elu", "softplus", "swish")


def _find_conv_bn_act(view, report, dry_run=False):
    """conv2d → batch_norm (→ activation) ⇒ ``fused_conv_bn_act``, with
    its grad twins all or none, gated on the conv output's bytes.  The
    bf16 rewrite's cast pair around the batch_norm (conv bf16 → cast f32
    → batch_norm → cast bf16 → act, the reference's AMP cast sandwich,
    ``paddle_tpu/static_analysis/fusion.py:1220-1310``) is absorbed: the
    fused op keeps f32 statistics and writes its output in the conv's
    dtype, which is what the sandwich computes.  Half a sandwich leaves
    the site unfused."""
    block = view.block
    for i, op in enumerate(block.ops):
        if op.type != "conv2d" or _is_grad_op(op):
            continue
        conv_out = op.outputs["Output"][0]
        cv = view.var(conv_out)
        conv_dtype = str(cv.dtype) if cv is not None else "float32"
        nxt = view.sole_fwd_consumer(conv_out)
        cast_in = None
        if nxt is not None and nxt[1].type == "cast" \
                and str(nxt[1].attrs.get("out_dtype")) == "float32" \
                and conv_dtype != "float32":
            cast_in = nxt[1]
            nxt = view.sole_fwd_consumer(cast_in.outputs["Out"][0])
        if nxt is None or nxt[1].type != "batch_norm":
            continue
        bn = nxt[1]
        bn_x = conv_out if cast_in is None else cast_in.outputs["Out"][0]
        if bn.inputs.get("X", [None])[0] != bn_x:
            continue
        conv_fmt = op.attrs.get("data_format", "NCHW")
        if conv_fmt == "AnyLayout":
            conv_fmt = "NCHW"
        if conv_fmt != bn.attrs.get("data_layout", "NCHW"):
            continue
        scale, bias, mean, var = (bn.inputs.get(s, [None])[0] for s in (
            "Scale", "Bias", "Mean", "Variance"))
        if None in (scale, bias, mean, var):
            continue
        y = bn.outputs["Y"][0]
        nxt2 = view.sole_fwd_consumer(y)
        cast_out = None
        if cast_in is not None and nxt2 is not None \
                and nxt2[1].type == "cast" \
                and str(nxt2[1].attrs.get("out_dtype")) == conv_dtype:
            cast_out = nxt2[1]
            nxt2 = view.sole_fwd_consumer(cast_out.outputs["Out"][0])
        if (cast_in is None) != (cast_out is None):
            continue  # half a sandwich
        act_op = None
        if nxt2 is not None and nxt2[1].type in _ACT_TYPES \
                and not _is_grad_op(nxt2[1]):
            act_op = nxt2[1]
        group = [o for o in (op, cast_in, bn, cast_out, act_op)
                 if o is not None]
        out_final = group[-1].outputs[
            "Y" if group[-1] is bn else "Out"][0]
        twins = view.group_twins(group)
        if twins is None:
            continue
        all_ops = group + [t[1] for _, t in twins]
        # removed intermediates: every forward output inside the group
        # but the last, and the saved batch statistics
        removed = [conv_out] + [o.outputs["Y" if o is bn else "Out"][0]
                                for o in group[1:-1]]
        removed += [n for s in ("SavedMean", "SavedVariance")
                    for n in bn.outputs.get(s, []) if n]
        if not all(view.unconsumed(n, all_ops) for n in removed):
            continue
        twin_of = {id(o): t[1] for o, t in twins}
        if twins:
            internal = [_grad_out(twin_of[id(o)], "X@GRAD")
                        for o in group[1:]]
            if not all(n == EMPTY_VAR_NAME or view.unconsumed(n, all_ops)
                       for n in internal):
                continue
        out_bytes = _var_bytes(view, conv_out)
        act_name = act_op.type if act_op is not None else "identity"
        factor, sig, calibrated = _calibration(
            "conv_bn_act", shape=tuple(cv.shape) if cv is not None
            and cv.shape else (), dtype=conv_dtype, act=act_name)
        threshold = conv_bn_min_bytes()
        if out_bytes * factor < threshold:
            report.skip(
                "conv_bn_act", i, op.type,
                "cost model: fused epilogue saves ~%d B of HBM traffic "
                "per removed op, below the %d B gate (calibration x%.2f"
                "%s)" % (
                    int(out_bytes * factor), threshold, factor,
                    "" if calibrated else _uncalibrated(sig)),
                key=op.attrs.get("__op_id__"))
            continue
        ins = {"Input": list(op.inputs["Input"]),
               "Filter": list(op.inputs["Filter"]),
               "Scale": [scale], "Bias": [bias], "Mean": [mean],
               "Variance": [var]}
        fattrs = {k: v for k, v in op.attrs.items()
                  if not k.startswith("__") and k != "op_namescope"}
        for k in ("epsilon", "momentum", "is_test", "use_global_stats",
                  "data_layout"):
            if k in bn.attrs:
                fattrs[k] = bn.attrs[k]
        if act_op is not None:
            fattrs.update({k: v for k, v in act_op.attrs.items()
                           if not k.startswith("__")
                           and k != "op_namescope"})
        fattrs["act_type"] = act_op.type if act_op is not None else ""
        fused = _new_op(block, "fused_conv_bn_act", ins,
                        {"Out": [out_final],
                         "MeanOut": list(bn.outputs.get("MeanOut", [])),
                         "VarianceOut": list(bn.outputs.get("VarianceOut",
                                                            []))},
                        fattrs, dry_run)
        replacements = {view.idx_of(group[-1]): fused}
        removals = {view.idx_of(o) for o in group} - set(replacements)
        if twins:
            last = twin_of[id(group[-1])]
            g_ins = dict(ins, Out=[out_final], **{"Out@GRAD": list(
                last.inputs.get("Y@GRAD" if group[-1] is bn
                                else "Out@GRAD", [EMPTY_VAR_NAME]))})
            conv_twin, bn_twin = twin_of[id(op)], twin_of[id(bn)]
            g_outs = {"Input@GRAD": [_grad_out(conv_twin, "Input@GRAD")],
                      "Filter@GRAD": [_grad_out(conv_twin, "Filter@GRAD")],
                      "Scale@GRAD": [_grad_out(bn_twin, "Scale@GRAD")],
                      "Bias@GRAD": [_grad_out(bn_twin, "Bias@GRAD")]}
            gfused = _new_op(block, "fused_conv_bn_act_grad", g_ins, g_outs,
                             _grad_attrs(fused), dry_run)
            _replace_twins(twins, gfused, replacements, removals)
        match = {"replacements": replacements, "removals": removals,
                 "rewrite": FusionRewrite(
                     "conv_bn_act", "fused_conv_bn_act",
                     sorted({view.idx_of(o) for o in group}
                            | {t[0] for _, t in twins}),
                     vars=(op.inputs["Input"][0], op.inputs["Filter"][0],
                           scale, bias),
                     predicted={"hbm_bytes_saved": 2 * (len(group) - 1)
                                * out_bytes, "ops_removed": len(group) - 1,
                                "calibration": factor},
                     note="%s epilogue%s%s" % (
                         act_name, " +AMP cast sandwich"
                         if cast_in is not None else "",
                         "" if calibrated else " (uncalibrated gate)"))}
        if dry_run:
            report.record(match["rewrite"])
            continue
        return match
    return None


_LOOKUP_OP_TYPES = ("lookup_table", "lookup_table_v2", "embedding",
                    "lookup_sparse_table")


def _find_embedding_gather(view, report, dry_run=False):
    block = view.block
    for i, op in enumerate(block.ops):
        if op.type not in _LOOKUP_OP_TYPES or _is_grad_op(op):
            continue
        w = op.inputs.get("W", [None])[0]
        wv = view.var(w) if w else None
        if wv is None or not wv.persistable or wv.shape is None \
                or len(wv.shape) != 2:
            continue
        rows, dim = wv.shape
        if not all(isinstance(d, int) and d > 0 for d in (rows, dim)):
            continue
        key = op.attrs.get("__op_id__")
        twin = view.twin(op, op.type + "_grad")
        if twin is False:
            continue
        if dim % 128:
            report.skip(
                "embedding_gather", i, op.type,
                "table dim %d is not lane-aligned (128) — the gate keeps "
                "the plain gather (K3, csrc/embedding.cu, is fused only "
                "for 128-aligned rows)" % dim, key=key)
            continue
        out = op.outputs["Out"][0]
        # the slab scales with the batch: a nominal batch of 8 stands in
        # for the dynamic dim, as in the reference
        slab_bytes = _var_bytes(view, out, batch=8)
        factor, sig, calibrated = _calibration(
            "embedding_gather", rows=rows, dim=dim, dtype=str(wv.dtype))
        threshold = embed_fuse_min_bytes()
        if slab_bytes * factor < threshold:
            report.skip(
                "embedding_gather", i, op.type,
                "cost model: gathered slab is ~%d B, below the %d B "
                "gate (calibration x%.2f%s)" % (
                    int(slab_bytes * factor), threshold, factor,
                    "" if calibrated else _uncalibrated(sig)),
                key=key)
            continue
        fattrs = {k: v for k, v in op.attrs.items()
                  if not k.startswith("__") and k != "op_namescope"}
        fused = _new_op(block, "fused_embedding_gather",
                        {"W": list(op.inputs["W"]),
                         "Ids": list(op.inputs["Ids"])},
                        {"Out": [out]}, fattrs, dry_run)
        replacements = {i: fused}
        if twin is not None:
            g_ins = {"W": list(op.inputs["W"]), "Ids": list(op.inputs["Ids"]),
                     "Out": [out],
                     "Out@GRAD": list(twin[1].inputs.get(
                         "Out@GRAD", [EMPTY_VAR_NAME]))}
            replacements[twin[0]] = _new_op(
                block, "fused_embedding_gather_grad", g_ins,
                {"W@GRAD": [_grad_out(twin[1], "W@GRAD")]},
                _grad_attrs(fused), dry_run)
        match = {"replacements": replacements, "removals": set(),
                 "rewrite": FusionRewrite(
                     "embedding_gather", "fused_embedding_gather",
                     sorted(replacements), vars=(w,),
                     predicted={"device_gather_bytes": slab_bytes,
                                "calibration": factor, "ops_removed": 0},
                     note="V=%d, D=%d%s" % (
                         rows, dim,
                         "" if calibrated else " (uncalibrated gate)"))}
        if dry_run:
            report.record(match["rewrite"])
            continue
        return match
    return None


def _find_bias_act(view, report, dry_run=False):
    block = view.block
    for op in block.ops:
        if op.type != "elementwise_add" or _is_grad_op(op):
            continue
        b = op.inputs.get("Y", [None])[0]
        bv = view.var(b) if b else None
        if bv is None or not bv.persistable or bv.shape is None \
                or len(bv.shape) != 1:
            continue
        out = op.outputs["Out"][0]
        nxt = view.sole_fwd_consumer(out)
        if nxt is None or nxt[1].type not in _ACT_TYPES:
            continue
        act_op = nxt[1]
        group = [op, act_op]
        twins = view.group_twins(group)
        if twins is None:
            continue
        all_ops = group + [t[1] for _, t in twins]
        if not view.unconsumed(out, all_ops):
            continue
        add_twin = next((t[1] for o, t in twins if o is op), None)
        act_twin = next((t[1] for o, t in twins if o is act_op), None)
        if twins:
            inter = _grad_out(act_twin, "X@GRAD")
            if inter != EMPTY_VAR_NAME and not view.unconsumed(inter,
                                                               all_ops):
                continue
        fattrs = {k: v for k, v in act_op.attrs.items()
                  if not k.startswith("__") and k != "op_namescope"}
        fattrs["act_type"] = act_op.type
        fattrs["axis"] = int(op.attrs.get("axis", -1))
        fused = _new_op(block, "fused_bias_act",
                        {"X": [op.inputs["X"][0]], "Bias": [b]},
                        {"Out": [act_op.outputs["Out"][0]]}, fattrs, dry_run)
        replacements = {view.idx_of(act_op): fused}
        removals = {view.idx_of(op)}
        if twins:
            g_ins = {"X": [op.inputs["X"][0]], "Bias": [b],
                     "Out": [act_op.outputs["Out"][0]],
                     "Out@GRAD": list(act_twin.inputs.get(
                         "Out@GRAD", [EMPTY_VAR_NAME]))}
            g_outs = {"X@GRAD": [_grad_out(add_twin, "X@GRAD")],
                      "Bias@GRAD": [_grad_out(add_twin, "Y@GRAD")]}
            gfused = _new_op(block, "fused_bias_act_grad", g_ins, g_outs,
                             _grad_attrs(fused), dry_run)
            _replace_twins(twins, gfused, replacements, removals)
        match = {"replacements": replacements, "removals": removals,
                 "rewrite": FusionRewrite(
                     "bias_act", "fused_bias_act",
                     sorted({view.idx_of(o) for o in group}
                            | {t[0] for _, t in twins}),
                     vars=(op.inputs["X"][0], b),
                     predicted={"ops_removed": 1,
                                "hbm_bytes_saved": 2 * _var_bytes(view, out)},
                     note="the same math (%s)" % act_op.type)}
        if dry_run:
            report.record(match["rewrite"])
            continue
        return match
    return None


_OPT_SLOTS = {
    "adam": (("Param", "Grad", "Moment1", "Moment2", "Beta1Pow",
              "Beta2Pow"),
             ("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
              "Beta2PowOut")),
    "sgd": (("Param", "Grad"), ("ParamOut",)),
}


def _opt_key(view, op):
    """The key of a per-parameter update that may join a fused one
    (``fusion.py:1533-1553``), or None."""
    if op.type not in _OPT_SLOTS or _is_grad_op(op):
        return None
    pname = op.inputs.get("Param", [None])[0]
    pv = view.var(pname) if pname else None
    if pv is None or pv.shape is None:
        return None
    if getattr(pv, "_is_distributed", False) \
            or getattr(pv, "shard_spec", None):
        return None
    gname = op.inputs.get("Grad", [None])[0]
    gv = view.var(gname) if gname else None
    key = (op.type, str(pv.dtype),
           str(gv.dtype) if gv is not None else str(pv.dtype),
           tuple(op.inputs.get("LearningRate", [])))
    if op.type == "adam":
        key += (op.attrs.get("beta1", 0.9), op.attrs.get("beta2", 0.999),
                op.attrs.get("epsilon", 1e-8))
    return key


def _find_optimizer(view, report, dry_run=False):
    """The first run of adjacent per-parameter updates with one key that
    the gate admits ⇒ one ``fused_adam``/``fused_sgd`` at its first op
    (``fusion.py:1556-1630``).  The gate is the reference's: a fused run
    is credited ``(members - 1) * optimizer_fuse_overhead_bytes()`` of
    launches saved against ``n_streams * elements * max(dtype bytes, 4)``
    of flat-stream traffic (7 streams for Adam, 3 for SGD), and fuses
    only when the credit is larger.  The port's multi-tensor kernel moves
    no more bytes than the per-parameter ones; the formula is kept so
    both packages rewrite the same programs."""
    block = view.block
    runs = []
    cur, cur_key = [], None
    for i, op in enumerate(block.ops):
        key = _opt_key(view, op)
        if key is not None and key == cur_key:
            cur.append((i, op))
            continue
        if len(cur) >= 2:
            runs.append((cur_key, cur))
        cur, cur_key = ([(i, op)], key) if key is not None else ([], None)
    if len(cur) >= 2:
        runs.append((cur_key, cur))

    for key, members in runs:
        if any(view.idx_of(o) != i for i, o in members):
            continue
        op_type = key[0]
        dt_bytes = _DTYPE_BYTES.get(key[1], 4)
        total = sum(_numel(view.var(o.inputs["Param"][0]).shape) or 0
                    for _, o in members)
        n_streams = 7 if op_type == "adam" else 3
        extra_bytes = n_streams * total * max(dt_bytes, 4)
        benefit = (len(members) - 1) * optimizer_fuse_overhead_bytes()
        first_idx = members[0][0]
        if benefit <= extra_bytes:
            report.skip(
                "optimizer", first_idx, op_type,
                "cost model: flat-stream concat/split would add ~%d MB "
                "of HBM traffic vs ~%d MB of launch savings for %d "
                "params (the r04 A/B regressed MFU 0.42->0.30 fusing "
                "BERT-scale groups)" % (
                    extra_bytes >> 20, benefit >> 20, len(members)),
                key=members[0][1].attrs.get("__op_id__"))
            continue
        in_slots, out_slots = _OPT_SLOTS[op_type]
        ins = {"LearningRate": list(
            members[0][1].inputs.get("LearningRate", []))}
        for slot in in_slots:
            ins[slot] = [o.inputs[slot][0] for _, o in members]
        outs = {slot: [o.outputs[slot][0] for _, o in members]
                for slot in out_slots}
        attrs = {k: v for k, v in members[0][1].attrs.items()
                 if not k.startswith("__")}
        attrs["op_role"] = "optimize"
        fused = _new_op(block, "fused_" + op_type, ins, outs, attrs, dry_run)
        match = {"replacements": {first_idx: fused},
                 "removals": {i for i, _ in members[1:]},
                 "rewrite": FusionRewrite(
                     "optimizer", "fused_" + op_type,
                     [i for i, _ in members], vars=tuple(ins["Param"]),
                     predicted={"ops_removed": len(members) - 1,
                                "hbm_bytes_added": extra_bytes,
                                "launch_bytes_saved": benefit},
                     note="bit-exact multi-tensor update (%d params, %d "
                          "elems)" % (len(members), total))}
        if dry_run:
            report.record(match["rewrite"])
            continue
        return match
    return None


def _find_allreduce(view, report, dry_run=False):
    """One bucket of in-place ``c_allreduce_sum`` ops ⇒ one
    ``c_fused_allreduce_sum`` or ``c_allreduce_quant`` at the bucket's
    last member (``fusion.py:1638-1770``)."""
    from ..quant.blockwise import quant_block
    from ..quant.collective import quant_min_bytes, quantized_wire_bytes

    block = view.block
    groups = {}
    for i, op in enumerate(block.ops):
        if op.type != "c_allreduce_sum":
            continue
        x = op.inputs.get("X", [None])
        o = op.outputs.get("Out", [None])
        if len(x) != 1 or len(o) != 1 or x[0] != o[0] or x[0] is None:
            continue  # only the in-place grad-allreduce shape buckets
        nbytes = _var_bytes(view, x[0])
        if not nbytes:
            continue
        key = (op.attrs.get("ring_id"), op.attrs.get("pre_scale"),
               str(view.var(x[0]).dtype))
        groups.setdefault(key, []).append((i, op, nbytes))

    cap = int(allreduce_bucket_mb(block.program) * (1 << 20))
    qmin = quant_min_bytes(block.program)
    qblock = quant_block()
    for key, members in sorted(groups.items(), key=lambda kv: kv[1][0][0]):
        buckets, cur, cur_bytes = [], [], 0
        for i, op, nbytes in members:  # size-capped, in program order
            if cur and cur_bytes + nbytes > cap:
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append((i, op, nbytes))
            cur_bytes += nbytes
        if cur:
            buckets.append(cur)
        for bucket in buckets:
            # a quantizable bucket engages at any member count; without
            # quant a single member has nothing to coalesce
            quantizable = (qmin is not None
                           and key[2] in ("float32", "bfloat16")
                           and sum(b for _, _, b in bucket) >= qmin)
            if len(bucket) < 2 and not quantizable:
                continue
            flush_idx = bucket[-1][0]
            member_ids = {id(op) for _, op, _ in bucket}
            # coalescing delays each member's exchange to the flush site:
            # no op in between may read or write the grad
            safe = []
            for i, op, nbytes in bucket:
                g = op.inputs["X"][0]
                ok = True
                for j in range(i + 1, flush_idx + 1):
                    other = block.ops[j]
                    if id(other) in member_ids:
                        continue
                    if g in other.input_arg_names \
                            or g in other.output_arg_names:
                        ok = False
                        break
                    sub = resolve_sub_block(view.program, other,
                                            host_block_idx=block.idx)
                    if sub is not None and g in sub_block_reads_recursive(
                            view.program, sub):
                        ok = False
                        break
                if ok:
                    safe.append((i, op, nbytes))
                else:
                    report.skip(
                        "allreduce", i, op.type,
                        "grad %r is read/written between its allreduce "
                        "and the bucket flush site — stays unfused" % g,
                        key=op.attrs.get("__op_id__"))
            total = sum(b for _, _, b in safe)
            quant = (qmin is not None
                     and key[2] in ("float32", "bfloat16")
                     and total >= qmin)
            if len(safe) < (1 if quant else 2):
                continue
            names = [op.inputs["X"][0] for _, op, _ in safe]
            attrs = {"ring_id": key[0], "op_role": "backward"}
            if key[1]:
                attrs["pre_scale"] = key[1]
            if quant:
                attrs["quant_block"] = qblock
            fused_type = "c_allreduce_quant" if quant \
                else "c_fused_allreduce_sum"
            fused = _new_op(block, fused_type, {"X": list(names)},
                            {"Out": list(names)}, attrs, dry_run)
            if quant:
                esize = _DTYPE_BYTES[key[2]]
                wire, dense = quantized_wire_bytes(
                    total // esize, 2, block=qblock, dtype_bytes=esize)
                predicted = {"collectives_removed": len(safe) - 1,
                             "wire_bytes_saved": dense - wire,
                             "quant_block": qblock,
                             "bucket_mb_cap": cap / float(1 << 20)}
                note = ("ring %r; int8 wire %d -> %d bytes, %d launches "
                        "-> 1" % (key[0], dense, wire, len(safe)))
            else:
                predicted = {"collectives_removed": len(safe) - 1,
                             "wire_bytes_unchanged": total,
                             "bucket_mb_cap": cap / float(1 << 20)}
                note = ("ring %r; wire volume unchanged, %d launches -> 1"
                        % (key[0], len(safe)))
            match = {"replacements": {safe[-1][0]: fused},
                     "removals": {i for i, _, _ in safe[:-1]},
                     "rewrite": FusionRewrite(
                         "allreduce", fused_type, [i for i, _, _ in safe],
                         vars=tuple(names), predicted=predicted,
                         note=note)}
            if dry_run:
                report.record(match["rewrite"])
                continue
            return match
    return None


def _find_attention(view, report, dry_run=False):
    """matmul(QKᵀ·α) → (+bias) → softmax → (dropout) → matmul(·V) ⇒
    ``fused_multihead_attention`` (``fusion.py:602-727``)."""
    block = view.block
    for i, op in enumerate(block.ops):
        if op.type != "matmul" or _is_grad_op(op):
            continue
        if not op.attrs.get("transpose_Y") or op.attrs.get("transpose_X"):
            continue
        q = op.inputs.get("X", [None])[0]
        k = op.inputs.get("Y", [None])[0]
        qs, ks = view.shape(q), view.shape(k)
        if not qs or not ks or len(qs) != 4 or len(ks) != 4:
            continue
        s0 = op.outputs["Out"][0]
        alpha = float(op.attrs.get("alpha", 1.0))
        group = [op]
        nxt = view.sole_fwd_consumer(s0)
        bias = None
        if nxt is not None and nxt[1].type == "elementwise_add":
            add_op = nxt[1]
            if add_op.inputs.get("X", [None])[0] != s0:
                continue
            if int(add_op.attrs.get("axis", -1)) != -1:
                continue
            bias = add_op.inputs.get("Y", [None])[0]
            bs = view.shape(bias)
            # the fused op broadcasts its bias per batch over heads and
            # query rows: only [B,1,1,Tk] (or [1,Tk]) means the same under
            # the unfused add's trailing alignment
            if not bs or not (
                    (len(bs) == 4 and bs[1] == 1 and bs[2] == 1)
                    or (len(bs) == 2 and bs[0] == 1)):
                continue
            # the fused path treats the bias as constant: a bias that
            # needs a gradient stays unfused
            bias_twin = view.twin(add_op, "elementwise_add_grad")
            if bias_twin is False:
                continue
            if bias_twin is not None:
                yg = bias_twin[1].outputs.get("Y@GRAD", [EMPTY_VAR_NAME])
                if yg and yg[0] != EMPTY_VAR_NAME:
                    report.skip("attention", i, op.type,
                                "additive bias %r requires a gradient — "
                                "the flash path treats the mask bias as "
                                "constant" % bias,
                                key=op.attrs.get("__op_id__"))
                    continue
            if view.var(bias) is None:
                continue
            group.append(add_op)
            nxt = view.sole_fwd_consumer(add_op.outputs["Out"][0])
        if nxt is None or nxt[1].type != "softmax":
            continue
        sm_op = nxt[1]
        if int(sm_op.attrs.get("axis", -1)) not in (-1, 3):
            continue
        group.append(sm_op)
        nxt = view.sole_fwd_consumer(sm_op.outputs["Out"][0])
        drop_op = None
        rate = 0.0
        if nxt is not None and nxt[1].type == "dropout":
            drop_op = nxt[1]
            if drop_op.attrs.get("dropout_implementation") \
                    != "upscale_in_train":
                report.skip("attention", i, op.type,
                            "attention dropout uses downgrade_in_infer — "
                            "the fused kernel implements upscale_in_train "
                            "only", key=op.attrs.get("__op_id__"))
                continue
            mask = drop_op.outputs.get("Mask", [None])[0]
            probe = group + [drop_op]
            if mask and not view.unconsumed(mask,
                                            probe + view.twin_ops(probe)):
                continue
            rate = float(drop_op.attrs.get("dropout_prob", 0.0) or 0.0)
            group.append(drop_op)
            nxt = view.sole_fwd_consumer(drop_op.outputs["Out"][0])
        if nxt is None or nxt[1].type != "matmul":
            continue
        mm2 = nxt[1]
        if mm2.attrs.get("transpose_X") or mm2.attrs.get("transpose_Y") \
                or float(mm2.attrs.get("alpha", 1.0)) != 1.0:
            continue
        probs = (drop_op or sm_op).outputs["Out"][0]
        if mm2.inputs.get("X", [None])[0] != probs:
            continue
        v = mm2.inputs.get("Y", [None])[0]
        vs = view.shape(v)
        if not vs or len(vs) != 4:
            continue
        group.append(mm2)

        # cost gate: the fused kernel engages from the measured threshold
        tq = int(qs[2]) if qs[2] and int(qs[2]) > 0 else 0
        tk = int(ks[2]) if ks[2] and int(ks[2]) > 0 else 0
        min_t = _flash_min_t()
        if max(tq, tk) < min_t:
            report.skip(
                "attention", i, op.type,
                "cost model: T=%d below the flash engagement threshold "
                "%d (PADDLE_TPU_FLASH_MIN_T re-decides)"
                % (max(tq, tk), min_t),
                key=op.attrs.get("__op_id__"))
            continue

        match = _match_attention_grads(view, report, group, i, q, k, v,
                                       bias, alpha, rate, drop_op, mm2,
                                       dry_run=dry_run)
        if match is None:
            continue
        if dry_run:
            report.record(match["rewrite"])
            continue
        return match
    return None


def _k1_refusal(view, q, k, v):
    """Why K1 (``ops/cuda/flash_attention.py``) cannot take these q/k/v
    vars, or None.  The reference's fused op falls back to XLA inside
    itself for shapes its kernel cannot take (``_kernel_applicable``);
    the port's op launches K1 or raises on a CUDA tensor, so the gate
    leaves such chains unfused."""
    from ..ops.cuda.flash_attention import MAX_HEAD_DIM

    qs, ks, vs = view.shape(q), view.shape(k), view.shape(v)
    dtypes = [str(view.var(n).dtype) for n in (q, k, v)]
    if len(set(dtypes)) != 1 or dtypes[0] not in ("float32", "bfloat16"):
        return ("q/k/v dtypes %s — the flash kernels take float32 or "
                "bfloat16, all alike" % "/".join(dtypes))
    if not 1 <= int(qs[3]) <= MAX_HEAD_DIM:
        return ("head dim %d — the flash kernels take 1 to %d"
                % (int(qs[3]), MAX_HEAD_DIM))
    if tuple(ks[1:]) != tuple(vs[1:]) or int(ks[3]) != int(qs[3]) \
            or int(ks[1]) != int(qs[1]):
        return ("q %s, k %s, v %s — the flash kernels take q, k and v "
                "of one head count and head dim, k and v alike"
                % (tuple(qs), tuple(ks), tuple(vs)))
    return None


def _match_attention_grads(view, report, group, i, q, k, v, bias, alpha,
                           rate, drop_op, mm2, dry_run=False):
    """The rewrite of a matched chain with its grad twins
    (``fusion.py:730-833``), or None (skips recorded)."""
    mm1 = group[0]
    ctx_out = mm2.outputs["Out"][0]

    # grad twins (none in an inference program)
    twins = []
    for o in group:
        t = view.twin(o, o.type + "_grad")
        if t is False:
            return None
        if t is not None:
            twins.append(t)
    mm2_twin = view.twin(mm2, "matmul_grad")
    mm1_twin = view.twin(mm1, "matmul_grad")
    if twins and (mm2_twin is None or mm1_twin in (None, False)
                  or mm2_twin is False or len(twins) != len(group)):
        return None  # a partial backward chain

    # every removed intermediate (and its grad) must be internal
    removed_fwd = [o.outputs["Out"][0] for o in group[:-1]]
    all_group_ops = list(group) + [t[1] for t in twins]
    for n in removed_fwd:
        if not view.unconsumed(n, all_group_ops):
            return None
    if twins:
        kept = (_grad_out(mm1_twin[1], "X@GRAD"),
                _grad_out(mm1_twin[1], "Y@GRAD"),
                _grad_out(mm2_twin[1], "Y@GRAD"))
        for _, g in twins:
            for n in g.output_arg_names:
                if n == EMPTY_VAR_NAME or n in kept:
                    continue
                if not view.unconsumed(n, all_group_ops):
                    return None

    block = view.block
    qs, ks = view.shape(q), view.shape(k)
    # the batch dim may be dynamic, the head, seq and depth dims not
    dyn = [d for d in (qs[1], qs[2], qs[3], ks[2])
           if not (isinstance(d, int) and d > 0)]
    if dyn:
        report.skip(
            "attention", i, mm1.type,
            "dynamic head/seq dims %r — the fused attention kernel "
            "needs static non-batch shapes" % (dyn,),
            key=mm1.attrs.get("__op_id__"))
        return None
    refusal = _k1_refusal(view, q, k, v)
    if refusal is not None:
        report.skip("attention", i, mm1.type,
                    "%s: the chain stays unfused" % refusal,
                    key=mm1.attrs.get("__op_id__"))
        return None
    b, h, tq = _numel((qs[0],)), int(qs[1]), int(qs[2])
    tk = int(ks[2])
    # the [B,H,Tq,Tk] score and probability tensors never reach memory
    score_bytes = 4 * (b or 1) * h * tq * tk
    from ..ops.cuda.flash_attention import KERNEL

    predicted = {
        "hbm_bytes_saved": 2 * (len(group) - 1) * score_bytes,
        "ops_removed": len(group) - 1,
        "flash_kernel": KERNEL,
    }

    ins = {"Q": [q], "K": [k], "V": [v]}
    if bias is not None:
        ins["BiasQK"] = [bias]
    attrs = {"causal": False, "scale": alpha, "dropout_rate": rate}
    if drop_op is not None and "is_test" in drop_op.attrs:
        attrs["is_test"] = drop_op.attrs["is_test"]
    fused = _new_op(block, "fused_multihead_attention", ins,
                    {"Out": [ctx_out]}, attrs, dry_run)

    replacements = {view.idx_of(mm2): fused}
    removals = {view.idx_of(o) for o in group} - set(replacements)
    if twins:
        g_ins = dict(ins)
        g_ins["Out"] = [ctx_out]
        g_ins["Out@GRAD"] = list(mm2_twin[1].inputs.get(
            "Out@GRAD", [EMPTY_VAR_NAME]))
        g_outs = {
            "Q@GRAD": [_grad_out(mm1_twin[1], "X@GRAD")],
            "K@GRAD": [_grad_out(mm1_twin[1], "Y@GRAD")],
            "V@GRAD": [_grad_out(mm2_twin[1], "Y@GRAD")],
        }
        gfused = _new_op(block, "fused_multihead_attention_grad", g_ins,
                         g_outs, _grad_attrs(fused), dry_run)
        _replace_twins([(None, t) for t in twins], gfused, replacements,
                       removals)

    op_idxs = sorted({view.idx_of(o) for o in group}
                     | {t[0] for t in twins})
    rewrite = FusionRewrite(
        "attention", "fused_multihead_attention", op_idxs,
        vars=(q, k, v) + ((bias,) if bias else ()), predicted=predicted,
        note="dropout rate %.3g (the mask stream differs from the unfused "
             "dropout op's: K1 draws it in the kernel from the fused "
             "op's seed)" % rate if rate else "")
    return {"replacements": replacements, "removals": removals,
            "rewrite": rewrite}


def _find_softmax_xent(view, report, dry_run=False):
    """softmax → cross_entropy ⇒ ``softmax_with_cross_entropy`` at the
    softmax's index (``fusion.py:1087-1195``)."""
    block = view.block
    for i, op in enumerate(block.ops):
        if op.type != "softmax" or _is_grad_op(op):
            continue
        p_name = op.outputs["Out"][0]
        xs = view.shape(op.inputs["X"][0])
        ax = int(op.attrs.get("axis", -1))
        if xs and ax not in (-1, len(xs) - 1):
            continue
        ce_ops = [(j, o) for j, o in view.consumers.get(p_name, ())
                  if o.type == "cross_entropy" and not _is_grad_op(o)]
        if len(ce_ops) != 1:
            continue
        j, ce = ce_ops[0]
        if ce.inputs.get("X", [None])[0] != p_name:
            continue
        label = ce.inputs.get("Label", [None])[0]
        # the fused op takes the softmax's place, so consumers of the
        # softmax output between the two sites stay valid: the label
        # must be defined there already
        lv = view.var(label)
        label_ready = lv is not None and (lv.is_data or lv.persistable)
        if not label_ready:
            lp = view.producers.get(label, [])
            label_ready = bool(lp) and all(idx < i for idx, _ in lp)
        if not label_ready:
            report.skip("softmax_xent", i, op.type,
                        "label %r is produced after the softmax — cannot "
                        "hoist the fused op" % label,
                        key=op.attrs.get("__op_id__"))
            continue
        group = [op, ce]
        sm_twin = view.twin(op, "softmax_grad")
        ce_twin = view.twin(ce, "cross_entropy_grad")
        if sm_twin is False or ce_twin is False:
            continue
        twins = [t for t in (ce_twin, sm_twin) if t is not None]
        if twins and len(twins) != 2:
            continue
        all_ops = group + [t[1] for t in twins]
        if twins:
            # the probabilities' gradient must come from the
            # cross_entropy alone: the fused op's Softmax output takes
            # no gradient, so a second loss path would be dropped
            pg = _grad_out(ce_twin[1], "X@GRAD")
            if pg == EMPTY_VAR_NAME or not view.unconsumed(pg, all_ops):
                report.skip(
                    "softmax_xent", i, op.type,
                    "softmax output %r receives gradients from outside "
                    "the cross_entropy — fusing would drop them"
                    % p_name, key=op.attrs.get("__op_id__"))
                continue
            # the fused grad writes Logits@GRAD only: a soft label whose
            # gradient is read would be left dangling
            lg = _grad_out(ce_twin[1], "Label@GRAD")
            if lg != EMPTY_VAR_NAME and not view.unconsumed(lg, all_ops):
                report.skip(
                    "softmax_xent", i, op.type,
                    "label %r is differentiable and its gradient %r is "
                    "consumed — the fused op emits no Label@GRAD"
                    % (label, lg), key=op.attrs.get("__op_id__"))
                continue
        cs = view.shape(p_name)
        predicted = {
            "ops_removed": 1,
            "hbm_bytes_saved": 2 * _var_bytes(view, p_name),
            "flops_saved": 3 * (_numel(cs) or 0),
        }
        fattrs = {"soft_label": ce.attrs.get("soft_label", False),
                  "ignore_index": int(ce.attrs.get("ignore_index", -100)),
                  "axis": -1}
        fused = _new_op(
            block, "softmax_with_cross_entropy",
            {"Logits": list(op.inputs["X"]), "Label": [label]},
            {"Softmax": [p_name], "Loss": list(ce.outputs["Y"])}, fattrs,
            dry_run)
        replacements = {i: fused}
        removals = {j}
        if twins:
            g_ins = {"Logits": list(op.inputs["X"]), "Label": [label],
                     "Softmax": [p_name],
                     "Loss": list(ce.outputs["Y"]),
                     "Loss@GRAD": list(ce_twin[1].inputs.get(
                         "Y@GRAD", [EMPTY_VAR_NAME]))}
            g_outs = {"Logits@GRAD": [_grad_out(sm_twin[1], "X@GRAD")]}
            gfused = _new_op(block, "softmax_with_cross_entropy_grad",
                             g_ins, g_outs, _grad_attrs(fused), dry_run)
            _replace_twins([(None, t) for t in twins], gfused,
                           replacements, removals)
        rewrite = FusionRewrite(
            "softmax_xent", "softmax_with_cross_entropy",
            sorted({i, j} | {t[0] for t in twins}),
            vars=(op.inputs["X"][0], label), predicted=predicted,
            note="logsumexp form: loss differs from the eps-guarded "
                 "unfused pair by ~1e-6 relative")
        if dry_run:
            report.record(rewrite)
            continue
        return {"replacements": replacements, "removals": removals,
                "rewrite": rewrite}
    return None


_FAMILIES = (
    ("attention", "fuse_attention", _find_attention),
    ("conv_bn_act", "fuse_conv_bn_act", _find_conv_bn_act),
    ("softmax_xent", "fuse_softmax_xent", _find_softmax_xent),
    ("dropout_add_ln", "fuse_elewise", _find_dropout_add_ln),
    ("bias_act", "fuse_elewise", _find_bias_act),
    ("embedding_gather", "fuse_embedding_gather", _find_embedding_gather),
    ("optimizer", "fuse_optimizer", _find_optimizer),
    ("allreduce", "fuse_allreduce", _find_allreduce),
)


def _run_family(view, find, report):
    applied = 0
    while applied < _MAX_REWRITES:
        match = find(view, report)
        if match is None:
            break
        _replace_ops(view.block, match["replacements"], match["removals"])
        report.record(match["rewrite"])
        view.refresh()
        applied += 1
    return applied


def apply_fusion_passes(program, config=None, targets=(), verify=None,
                        baseline=None):
    """Run the ported families over ``program`` IN PLACE; returns the
    :class:`FusionReport`.  With pass verification on (``verify=None``
    reads :func:`~.verifier.pass_verification_enabled`) each family that
    fired is bracketed by the verifier, baseline-aware
    (``fusion.py:1815-1838``): only ERROR findings the rewrite
    introduces fail it, since a program may arrive with ERROR metadata
    drift of its own (the bf16 AMP rewrite's) that the executor
    tolerates."""
    config = config or FusionConfig.default()
    report = FusionReport(config)
    if not config.enabled:
        return report
    if verify is None:
        from .verifier import pass_verification_enabled

        verify = pass_verification_enabled()
    view = _GlobalView(program, targets)
    if verify and baseline is None:
        baseline = _error_signatures(program, view.targets)
    for family, flag, find in _FAMILIES:
        if not getattr(config, flag):
            continue
        if _run_family(view, find, report) and verify:
            _assert_no_new_errors(program, view.targets, baseline,
                                  "after fuse_%s_pass" % family)
    return report


# advisory-only checks skipped inside the pass brackets (``fusion.py:1841``):
# the bracket gates on ERROR findings only.  ``manual-plan-suboptimal``
# is skipped here too: the reference's yields a WARNING at most, while
# the port's raises where it would price a plan (planner search not
# ported), which must not break a run of a transpiled program
_BRACKET_EXCLUDE = ("fusible-pattern-not-fused", "unreferenced-op",
                    "resilience-finite-guard",
                    "executor-host-sync-in-loop", "sync-in-hot-loop",
                    "quantizable-bucket-not-quantized",
                    "collective-crosses-slow-tier",
                    "overlap-opportunity-unexploited",
                    "manual-plan-suboptimal")

# the in-flight depth the bracket's race checks assume: a rewrite must
# be safe for the overlapped paths whatever depth the caller picks later
_BRACKET_MAX_IN_FLIGHT = 2


def _finding_signature(d):
    """Baseline-diff key of one ERROR finding, without op indices (a
    rewrite removing ops ahead of a finding must not make it new); race
    findings also drop the message, which names the writing op's type."""
    from .concurrency import RACE_CHECK_IDS

    if d.check in RACE_CHECK_IDS:
        return (d.check, d.var_names)
    return (d.check, d.message, d.var_names)


def _error_signatures(program, targets):
    from .diagnostics import Severity
    from .verifier import verify_program

    return {
        _finding_signature(d)
        for d in verify_program(program, targets=list(targets),
                                exclude=_BRACKET_EXCLUDE,
                                max_in_flight=_BRACKET_MAX_IN_FLIGHT)
        if d.severity >= Severity.ERROR
    }


def _assert_no_new_errors(program, targets, baseline, context):
    from .diagnostics import Severity, format_diagnostics
    from .verifier import VerifyError, verify_program

    diags = verify_program(program, targets=list(targets),
                           exclude=_BRACKET_EXCLUDE,
                           max_in_flight=_BRACKET_MAX_IN_FLIGHT)
    new = [d for d in diags
           if d.severity >= Severity.ERROR
           and _finding_signature(d) not in baseline]
    if new:
        raise VerifyError(
            format_diagnostics(
                new, header="program failed verification (%s):" % context),
            diagnostics=new)


def scan_fusible_patterns(program, config=None, targets=()):
    """Dry-run the matchers without mutating the program, the engine of
    the ``fusible-pattern-not-fused`` check (``fusion.py:1914``): the
    report's ``applied`` lists the patterns that would fuse, ``skipped``
    the matched but gated-out ones."""
    config = config or FusionConfig.default()
    report = FusionReport(config)
    view = _GlobalView(program, targets)
    for _family, flag, find in _FAMILIES:
        if getattr(config, flag):
            find(view, report, dry_run=True)
    return report


def _run_hierarchy_pass(clone, targets, baseline=None):
    """The hierarchical decomposition on the resolved clone, after the
    fusion families (it decomposes the buckets they emitted) and before
    the overlap scheduler (the remaining flat buckets can still split;
    the hierarchical hops opt out of overlap), bracketed by the verifier
    like a family (the reference's :1956).  True when a bucket
    decomposed: the resolve then keeps the clone."""
    from .hierarchy import apply_hierarchy_pass, hierarchy_enabled

    if not hierarchy_enabled(clone):
        clone._hierarchy_report = None
        return False
    from .verifier import pass_verification_enabled

    verify = pass_verification_enabled()
    if verify and baseline is None:
        baseline = _error_signatures(clone, set(targets))
    applied = apply_hierarchy_pass(clone, targets=targets)
    if applied and verify:
        _assert_no_new_errors(clone, set(targets), baseline,
                              "after hierarchy_pass")
    return applied


def _run_overlap_pass(clone, targets, baseline=None):
    """The overlap scheduler on the resolved clone, after the fusion
    families and the hierarchy pass (it splits the buckets they left),
    bracketed by the verifier against the same pre-fusion baseline (the
    reference's :1985).  True when a bucket was split."""
    from .overlap import apply_overlap_pass, overlap_enabled

    if not overlap_enabled(clone):
        return False
    from .verifier import pass_verification_enabled

    verify = pass_verification_enabled()
    if verify and baseline is None:
        baseline = _error_signatures(clone, set(targets))
    ov = apply_overlap_pass(clone, targets=targets)
    if ov.applied and verify:
        _assert_no_new_errors(clone, set(targets), baseline,
                              "after overlap_schedule_pass")
    return bool(ov.applied)


def resolve_fused_program(program, config=None, targets=()):
    """``(program_to_run, FusionReport)``: the fusion-rewritten clone of
    ``program``, cached on it by (config signature, program version,
    fetch set), or ``program`` itself when nothing fused.  An entry
    holds the calibration factors its resolution read; after a write to
    the autotune cache it is resolved again only if one of them moved."""
    config = config or FusionConfig.default()
    if getattr(program, "_fusion_applied", False):
        return program, getattr(program, "_fusion_report", None) \
            or FusionReport(config)
    if not config.enabled:
        return program, FusionReport(config)
    from ..observability import runtime as _obs

    tkey = tuple(sorted({getattr(t, "name", t) for t in (targets or ())}))
    sig = config.signature(program)
    key = (sig, program._version, tkey)
    cache = program.__dict__.setdefault("_fusion_cache", {})
    hit = cache.get(key)
    state = _autotune_state()
    if hit is not None and (hit[3] == state or not _reads_moved(hit[2])):
        # an entry stands while the calibrations it read keep their
        # values, whatever else was written to the cache
        hit[3] = state
        _obs.record_fusion_resolve(True)
        fused, report = hit[0], hit[1]
        return (fused if fused is not None else program), report
    _obs.record_fusion_resolve(False)
    cache.pop(key, None)
    for k in [k for k in cache if k[1] != program._version]:
        del cache[k]
    while len(cache) >= _FUSION_CACHE_CAP:
        del cache[next(iter(cache))]
    clone = program.clone()
    for mark in _PROGRAM_MARKS:
        if hasattr(program, mark):
            setattr(clone, mark, getattr(program, mark))
    clone._fusion_applied = True
    from .verifier import pass_verification_enabled

    baseline = None
    if pass_verification_enabled():
        baseline = _error_signatures(clone, set(tkey))
    outer, reads = getattr(_reading, "reads", None), {}
    _reading.reads = reads
    try:
        report = apply_fusion_passes(clone, config, targets=tkey,
                                     baseline=baseline)
    finally:
        _reading.reads = outer
    hier_applied = _run_hierarchy_pass(clone, tkey, baseline=baseline)
    overlap_applied = _run_overlap_pass(clone, tkey, baseline=baseline)
    if not report.applied and not overlap_applied and not hier_applied:
        cache[key] = [None, report, reads, state]
        return program, report
    clone._fusion_sig = sig + (tuple(sorted(reads.items())),)
    clone._fusion_report = report
    cache[key] = [clone, report, reads, state]
    return clone, report
