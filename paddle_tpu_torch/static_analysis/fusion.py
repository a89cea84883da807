"""Program-IR fusion pipeline, the families of BERT serving and training
and of ResNet training.

Mirrors ``paddle_tpu/static_analysis/fusion.py``: ``resolve_fused_program``
(:2014) with the four families that fire on BERT and ResNet,

========================  ==================================================
family                    rewrite
========================  ==================================================
``conv_bn_act`` (:1201)   conv2d → batch_norm (→ activation) ⇒ one
                          ``fused_conv_bn_act`` (the K4 epilogue kernels
                          on a channels-last output), gated on the conv
                          output reaching ``PADDLE_TPU_CONV_BN_MIN_BYTES``
                          (default 4096); the reference's AMP cast-pair
                          match waits with AMP
``dropout_add_ln`` (:843)  (dropout) → elementwise_add → layer_norm over
                          the last axis ⇒ one ``fused_dropout_add_ln`` (the
                          fused LN kernels)
``bias_act`` (:1007)      elementwise_add(·, 1-D persistable bias) →
                          activation ⇒ ``fused_bias_act`` (the same math)
``embedding_gather``      ``lookup_table``/``embedding`` on a persistable
(:1427)                   2-D table ⇒ ``fused_embedding_gather`` (the
                          gather kernel), gated on ``D % 128 == 0`` and the
                          gathered slab at a nominal batch of 8 reaching
                          ``PADDLE_TPU_EMBED_FUSE_MIN_BYTES`` (default 4096)
``allreduce`` (:1638)     the in-place ``c_allreduce_sum`` of each gradient
                          (``GradAllReduce``), grouped by (ring,
                          ``pre_scale``, dtype) into buckets of at most
                          ``allreduce_bucket_mb`` (default 32 MB) in
                          program order ⇒ one ``c_fused_allreduce_sum``
                          per bucket, or ``c_allreduce_quant`` (the int8
                          exchange on K7) once the bucket reaches
                          ``quant.quant_min_bytes``
========================  ==================================================

with the reference's gates and its uncalibrated cost factor 1.0
(:182-195; the autotune cache is not ported).  Training programs are
rewritten with their grad twins, as in the reference: every grad op
carries ``__fwd_op_id__``, so a matched forward pattern's grad ops are
found exactly (``_GlobalView.twin``, :472-489, :526) and replaced by the
fused op's one ``<type>_grad`` (:972, :1062, :1495), whose lowering
differentiates the fused op's recorded graph (``ops/registry.py``).  A
pattern whose twins are not all there, or not the expected ones, is left
alone.  The executor runs a rewritten CLONE, cached on the original
program by (config signature, program version, fetch set); the user's
program is never mutated.  Kill switch: ``PADDLE_TPU_FUSION=0``.

The executor's resolved clone carries the program marks the families
and the collectives read (``_num_trainers``, ``_trainer_id``,
``_allreduce_bucket_mb``, ``_quant_buckets``), as the reference's
``_PROGRAM_MARKS`` (:119).

Not ported yet (ROADMAP.md): the attention, softmax_xent and optimizer
families, and the verifier bracket around each family.
"""

import os

from ..ops.registry import EMPTY_VAR_NAME
from ._defuse import resolve_sub_block, sub_block_reads_recursive

__all__ = ["FusionConfig", "FusionRewrite", "FusionSkip", "FusionReport",
           "fusion_enabled", "conv_bn_min_bytes", "embed_fuse_min_bytes",
           "allreduce_bucket_mb", "apply_fusion_passes",
           "resolve_fused_program"]

_DTYPE_BYTES = {"float64": 8, "int64": 8, "float32": 4, "int32": 4,
                "float16": 2, "bfloat16": 2, "int16": 2, "int8": 1,
                "uint8": 1, "bool": 1}
_FUSION_CACHE_CAP = 16
_MAX_REWRITES = 10000
# program marks Program.clone() does not carry that the resolved clone
# must keep (the reference's _PROGRAM_MARKS, :119, as far as the port
# reads them)
_PROGRAM_MARKS = ("_num_trainers", "_trainer_id", "_allreduce_bucket_mb",
                  "_quant_buckets")


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


class FusionConfig:
    """Which families run; ``enabled`` follows the kill switch."""

    __slots__ = ("enabled", "fuse_elewise", "fuse_conv_bn_act",
                 "fuse_embedding_gather", "fuse_allreduce")

    def __init__(self, enabled=None, fuse_elewise=True,
                 fuse_conv_bn_act=True, fuse_embedding_gather=True,
                 fuse_allreduce=True):
        self.enabled = fusion_enabled() if enabled is None else bool(enabled)
        self.fuse_elewise = bool(fuse_elewise)
        self.fuse_conv_bn_act = bool(fuse_conv_bn_act)
        self.fuse_embedding_gather = bool(fuse_embedding_gather)
        self.fuse_allreduce = bool(fuse_allreduce)

    @classmethod
    def default(cls):
        return cls()

    def signature(self, program=None):
        """Hashable identity of the rewrite of ``program``: the bucket cap
        and the quant threshold resolve mark → env → default, so the
        program's marks are part of it."""
        from ..quant.blockwise import quant_block
        from ..quant.collective import quant_min_bytes

        return (self.enabled, self.fuse_elewise, self.fuse_conv_bn_act,
                self.fuse_embedding_gather, self.fuse_allreduce,
                conv_bn_min_bytes(), embed_fuse_min_bytes(),
                allreduce_bucket_mb(program), quant_min_bytes(program),
                quant_block())

    def __repr__(self):
        return "FusionConfig%r" % (self.signature(),)


class FusionRewrite:
    """One applied rewrite: family, fused op type, original op indices."""

    __slots__ = ("family", "fused_op_type", "op_idxs", "vars", "predicted",
                 "note")

    def __init__(self, family, fused_op_type, op_idxs, vars=(),
                 predicted=None, note=""):
        self.family = family
        self.fused_op_type = fused_op_type
        self.op_idxs = tuple(op_idxs)
        self.vars = tuple(vars)
        self.predicted = dict(predicted or {})
        self.note = note

    def __repr__(self):
        return "[%s] ops %s -> %s %s" % (self.family, list(self.op_idxs),
                                          self.fused_op_type, self.note)


class FusionSkip:
    """A matched-but-not-rewritten pattern and why."""

    __slots__ = ("family", "op_idx", "op_type", "reason", "key")

    def __init__(self, family, op_idx, op_type, reason, key=None):
        self.family = family
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


def _new_op(block, type, inputs, outputs, attrs):
    from ..framework import Operator

    return Operator(block, type, inputs, outputs, attrs)


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


def _find_dropout_add_ln(view, report):
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
                        {"Out": [op.outputs["Y"][0]]}, fattrs)
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
                             _grad_attrs(fused))
            _replace_twins(twins, gfused, replacements, removals)
        return {"replacements": replacements, "removals": removals,
                "rewrite": FusionRewrite(
                    "dropout_add_ln", "fused_dropout_add_ln",
                    sorted({view.idx_of(o) for o in group}
                           | {t[0] for _, t in twins}),
                    vars=(x_name, res_name), predicted=predicted,
                    note="dropout rate %.3g (the mask stream differs from "
                    "the unfused dropout op's)" % rate if rate
                    else "rate 0: the same math as the unfused ops")}
    return None


_ACT_TYPES = ("relu", "gelu", "tanh", "sigmoid", "relu6", "leaky_relu",
              "elu", "softplus", "swish")


def _find_conv_bn_act(view, report):
    """conv2d → batch_norm (→ activation) ⇒ ``fused_conv_bn_act``, with
    its grad twins all or none, gated on the conv output's bytes.  The
    reference also absorbs the AMP rewrite's cast pair around the
    batch_norm; that waits with AMP here, so a cast between the conv and
    the batch_norm leaves the site unfused (as half a cast pair does in
    the reference)."""
    block = view.block
    for i, op in enumerate(block.ops):
        if op.type != "conv2d" or _is_grad_op(op):
            continue
        conv_out = op.outputs["Output"][0]
        nxt = view.sole_fwd_consumer(conv_out)
        if nxt is None or nxt[1].type != "batch_norm":
            continue
        bn = nxt[1]
        if bn.inputs.get("X", [None])[0] != conv_out:
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
        act_op = None
        nxt2 = view.sole_fwd_consumer(y)
        if nxt2 is not None and nxt2[1].type in _ACT_TYPES \
                and not _is_grad_op(nxt2[1]):
            act_op = nxt2[1]
        group = [op, bn] + ([act_op] if act_op is not None else [])
        out_final = act_op.outputs["Out"][0] if act_op is not None else y
        twins = view.group_twins(group)
        if twins is None:
            continue
        all_ops = group + [t[1] for _, t in twins]
        # removed intermediates: the conv output, bn's Y when the act
        # follows it, and the saved batch statistics
        removed = [conv_out] + ([y] if act_op is not None else [])
        removed += [n for s in ("SavedMean", "SavedVariance")
                    for n in bn.outputs.get(s, []) if n]
        if not all(view.unconsumed(n, all_ops) for n in removed):
            continue
        twin_of = {id(o): t[1] for o, t in twins}
        if twins:
            internal = [_grad_out(twin_of[id(o)], "X@GRAD")
                        for o in (bn, act_op) if o is not None]
            if not all(n == EMPTY_VAR_NAME or view.unconsumed(n, all_ops)
                       for n in internal):
                continue
        out_bytes = _var_bytes(view, conv_out)
        factor = 1.0  # uncalibrated: the autotune cache is not ported
        threshold = conv_bn_min_bytes()
        act_name = act_op.type if act_op is not None else "identity"
        if out_bytes * factor < threshold:
            report.skip("conv_bn_act", i, op.type,
                        "conv output is ~%d B, below the %d B gate"
                        % (int(out_bytes * factor), threshold),
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
                        fattrs)
        replacements = {view.idx_of(group[-1]): fused}
        removals = {view.idx_of(o) for o in group} - set(replacements)
        if twins:
            last = twin_of[id(group[-1])]
            g_ins = dict(ins, Out=[out_final], **{"Out@GRAD": list(
                last.inputs.get("Out@GRAD" if act_op is not None
                                else "Y@GRAD", [EMPTY_VAR_NAME]))})
            conv_twin, bn_twin = twin_of[id(op)], twin_of[id(bn)]
            g_outs = {"Input@GRAD": [_grad_out(conv_twin, "Input@GRAD")],
                      "Filter@GRAD": [_grad_out(conv_twin, "Filter@GRAD")],
                      "Scale@GRAD": [_grad_out(bn_twin, "Scale@GRAD")],
                      "Bias@GRAD": [_grad_out(bn_twin, "Bias@GRAD")]}
            gfused = _new_op(block, "fused_conv_bn_act_grad", g_ins, g_outs,
                             _grad_attrs(fused))
            _replace_twins(twins, gfused, replacements, removals)
        return {"replacements": replacements, "removals": removals,
                "rewrite": FusionRewrite(
                    "conv_bn_act", "fused_conv_bn_act",
                    sorted({view.idx_of(o) for o in group}
                           | {t[0] for _, t in twins}),
                    vars=(op.inputs["Input"][0], op.inputs["Filter"][0],
                          scale, bias),
                    predicted={"hbm_bytes_saved": 2 * (len(group) - 1)
                               * out_bytes, "ops_removed": len(group) - 1,
                               "calibration": factor},
                    note="%s epilogue" % act_name)}
    return None


_LOOKUP_OP_TYPES = ("lookup_table", "lookup_table_v2", "embedding",
                    "lookup_sparse_table")


def _find_embedding_gather(view, report):
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
            report.skip("embedding_gather", i, op.type,
                        "table dim %d is not a multiple of 128" % dim,
                        key=key)
            continue
        out = op.outputs["Out"][0]
        # the slab scales with the batch: a nominal batch of 8 stands in
        # for the dynamic dim, as in the reference
        slab_bytes = _var_bytes(view, out, batch=8)
        factor = 1.0  # uncalibrated: the autotune cache is not ported
        threshold = embed_fuse_min_bytes()
        if slab_bytes * factor < threshold:
            report.skip("embedding_gather", i, op.type,
                        "gathered slab is ~%d B, below the %d B gate"
                        % (int(slab_bytes * factor), threshold), key=key)
            continue
        fattrs = {k: v for k, v in op.attrs.items()
                  if not k.startswith("__") and k != "op_namescope"}
        fused = _new_op(block, "fused_embedding_gather",
                        {"W": list(op.inputs["W"]),
                         "Ids": list(op.inputs["Ids"])},
                        {"Out": [out]}, fattrs)
        replacements = {i: fused}
        if twin is not None:
            g_ins = {"W": list(op.inputs["W"]), "Ids": list(op.inputs["Ids"]),
                     "Out": [out],
                     "Out@GRAD": list(twin[1].inputs.get(
                         "Out@GRAD", [EMPTY_VAR_NAME]))}
            replacements[twin[0]] = _new_op(
                block, "fused_embedding_gather_grad", g_ins,
                {"W@GRAD": [_grad_out(twin[1], "W@GRAD")]},
                _grad_attrs(fused))
        return {"replacements": replacements, "removals": set(),
                "rewrite": FusionRewrite(
                    "embedding_gather", "fused_embedding_gather",
                    sorted(replacements), vars=(w,),
                    predicted={"device_gather_bytes": slab_bytes,
                               "calibration": factor},
                    note="V=%d, D=%d" % (rows, dim))}
    return None


def _find_bias_act(view, report):
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
                        {"Out": [act_op.outputs["Out"][0]]}, fattrs)
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
                             _grad_attrs(fused))
            _replace_twins(twins, gfused, replacements, removals)
        return {"replacements": replacements, "removals": removals,
                "rewrite": FusionRewrite(
                    "bias_act", "fused_bias_act",
                    sorted({view.idx_of(o) for o in group}
                           | {t[0] for _, t in twins}),
                    vars=(op.inputs["X"][0], b),
                    predicted={"ops_removed": 1,
                               "hbm_bytes_saved": 2 * _var_bytes(view, out)},
                    note="the same math (%s)" % act_op.type)}
    return None


def _find_allreduce(view, report):
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
                        "and the bucket flush site; stays unfused" % g,
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
                            {"Out": list(names)}, attrs)
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
            return {"replacements": {safe[-1][0]: fused},
                    "removals": {i for i, _, _ in safe[:-1]},
                    "rewrite": FusionRewrite(
                        "allreduce", fused_type, [i for i, _, _ in safe],
                        vars=tuple(names), predicted=predicted,
                        note=note)}
    return None


_FAMILIES = (
    ("conv_bn_act", "fuse_conv_bn_act", _find_conv_bn_act),
    ("dropout_add_ln", "fuse_elewise", _find_dropout_add_ln),
    ("bias_act", "fuse_elewise", _find_bias_act),
    ("embedding_gather", "fuse_embedding_gather", _find_embedding_gather),
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


def apply_fusion_passes(program, config=None, targets=()):
    """Run the ported families over ``program`` IN PLACE; returns the
    :class:`FusionReport`."""
    config = config or FusionConfig.default()
    report = FusionReport(config)
    if not config.enabled:
        return report
    view = _GlobalView(program, targets)
    for _family, flag, find in _FAMILIES:
        if getattr(config, flag):
            _run_family(view, find, report)
    return report


def resolve_fused_program(program, config=None, targets=()):
    """``(program_to_run, FusionReport)``: the fusion-rewritten clone of
    ``program``, cached on it by (config signature, program version,
    fetch set), or ``program`` itself when nothing fused."""
    config = config or FusionConfig.default()
    if getattr(program, "_fusion_applied", False):
        return program, getattr(program, "_fusion_report", None) \
            or FusionReport(config)
    if not config.enabled:
        return program, FusionReport(config)
    tkey = tuple(sorted({getattr(t, "name", t) for t in (targets or ())}))
    key = (config.signature(program), program._version, tkey)
    cache = program.__dict__.setdefault("_fusion_cache", {})
    hit = cache.get(key)
    if hit is not None:
        fused, report = hit
        return (fused if fused is not None else program), report
    for k in [k for k in cache if k[1] != program._version]:
        del cache[k]
    while len(cache) >= _FUSION_CACHE_CAP:
        del cache[next(iter(cache))]
    clone = program.clone()
    for mark in _PROGRAM_MARKS:
        if hasattr(program, mark):
            setattr(clone, mark, getattr(program, mark))
    clone._fusion_applied = True
    report = apply_fusion_passes(clone, config, targets=tkey)
    if not report.applied:
        cache[key] = (None, report)
        return program, report
    clone._fusion_sig = config.signature(program)
    clone._fusion_report = report
    cache[key] = (clone, report)
    return clone, report
