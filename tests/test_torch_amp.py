"""The bf16 AMP slice of the PyTorch port against the reference package.

``contrib.mixed_precision`` rewrites a program to bf16 in both packages
alike; the rewritten programs fuse alike; each op on the AMP paths
computes what the reference's lowering computes on the same bf16 inputs
(forward and gradient); bert-tiny pretraining (Adam) and a small ResNet
(Momentum) train alike for three steps with ``amp=True``; and
``AnalysisConfig.enable_bf16`` serves a ResNet and a tiny BERT alike.
On the CPU the port's kernel wrappers run their plain PyTorch versions
and the reference runs its Pallas kernels in interpret mode.  The two
packages' random initialisers draw different numbers, so the port is
held to the reference's persistables through
``paddle_tpu_torch.convert``; inputs come from seeded numpy.

Where the two can differ: the reference runs each block jitted, and XLA
on the CPU keeps some bf16 intermediates of a fusion in float32 (it
drops a rounding where a bf16 result feeds another op of the same
fusion), while the port rounds every op's bf16 result.  One op alone
rounds alike in both (the per-op tests below are mostly bit for bit);
through a whole program a value can differ by a bf16 unit in the last
place, and the differences compound.  The tolerances are in those
units.
"""

import collections
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import resnet as jres
from paddle_tpu.ops import registry as j_registry
from paddle_tpu.static_analysis import fusion as jfusion

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import resnet as tres
from paddle_tpu_torch.ops import registry as t_registry
from paddle_tpu_torch.ops.cuda import fused_ln as t_fln
from paddle_tpu_torch.static_analysis import fusion as tfusion
from test_torch_executor import private_autotune  # noqa: F401 - a fixture

BF16_ULP = 2.0 ** -7    # one bf16 unit in the last place, relative
# one op on the same bf16 inputs, max |diff| over max |ref|: 0 for all
# but the fused attention, whose reference is the blocked online softmax
# of the Pallas kernel (measured 1.7e-3 on its output, 1.2e-3 on dV)
OP_RTOL = 0.0
ATTN_RTOL = BF16_ULP / 2
# float32 outputs of a mixed bf16/f32 op: float32 sums in another order
MIXED_RTOL = 1e-6
# bert-tiny, 3 Adam steps at lr 1e-4, dropout 0: the loss is a bf16
# value; measured equal at every step
T = 128
BATCH = 4
STEPS = 3
LR = 1e-4
BERT_LOSS_RTOL = BF16_ULP
# step-0 gradients (float32 masters, reached through bf16 casts), max
# |diff| over max |ref|: measured up to 1.6e-2, two bf16 units; the
# attention key biases' gradients are rounding noise in both (the
# softmax is invariant to them: measured |ref| <= 1.3e-5), hence the atol
BERT_GRAD_RTOL = 3 * BF16_ULP
BERT_GRAD_ATOL = 3e-5
# Adam divides by sqrt(m2) + eps: a near-zero gradient whose sign flips
# between the packages moves its parameter by up to 2 lr per step
BERT_PARAM_ATOL = 2 * LR * STEPS
# ResNet (cifar10, depth 8, NHWC, so K4 runs at every site), batch 4,
# 3 Nesterov Momentum steps at lr 0.01: the float32 loss after bf16
# convolutions and the cast sandwich, measured within 3.5e-4 at every
# step (the float32 runs of the two packages agree to 3e-7)
RESNET_LR = 0.01
RESNET_LOSS_RTOL = 1e-3
# AMP against float32 in the same package: above float32 noise, so bf16
# ran (measured 3.4e-4 and more for the ResNet, 1.3e-3 for bert-tiny)
AMP_VS_F32_MIN = 1e-4
# serving: the reference's own bounds on the bf16 predictor's error
# against float32, max |diff| over max |f32| (tests/test_inference.py)
SERVE_ERR_MIN, SERVE_ERR_MAX = 1e-6, 0.05
# port against reference, both bf16, over max |ref|: the ResNet's logits
# leave the bf16 graph through the float32 fc (measured 2e-7); the
# BERT's hidden states are bf16 (measured 7.5e-3, one unit at the
# largest output, 2 layers deep)
SERVE_RESNET_RTOL = 1e-5
SERVE_BERT_RTOL = 2 * BF16_ULP


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _op_counts(program):
    return collections.Counter(op.type for op in program.global_block().ops)


# ---------------------------------------------------------------------------
# (a) the rewrite
# ---------------------------------------------------------------------------

def _same_width(dtype):
    """The port keeps 64-bit integers where the reference (JAX without
    x64) records 32-bit ones; float dtypes are compared as they are."""
    return {"int64": "int32"}.get(str(dtype), str(dtype))


def _describe(program):
    block = program.global_block()
    ops = [(op.type, {k: list(v) for k, v in op.inputs.items()},
            {k: list(v) for k, v in op.outputs.items()},
            {k: v for k, v in op.attrs.items() if k != "op_namescope"})
           for op in block.ops]
    dtypes = {n: _same_width(v.dtype) for n, v in block.vars.items()}
    return ops, dtypes


def _bert_amp(fluid, bert, train):
    cfg = copy.copy(bert.BERT_TINY)
    cfg.fuse_attn = True
    with fluid.unique_name.guard():
        return bert.build_pretrain(cfg, seq_len=T, amp=True, train=train)


def _resnet_amp(fluid, resnet):
    with fluid.unique_name.guard():
        return resnet.build(dataset="cifar10", amp=True)


def _custom_lists_program(fluid, mp):
    """An embedding → fc → cumsum → sum chain rewritten with custom
    lists: ``lookup_table`` and ``reduce_sum`` made white, ``cumsum``
    black."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data("ids", shape=[8, 1], dtype="int64")
        emb = fluid.layers.embedding(ids, size=[64, 16])
        h = fluid.layers.fc(emb, size=16, num_flatten_dims=2, act="gelu")
        c = fluid.layers.cumsum(h, axis=1)
        fluid.layers.reduce_sum(c)
        # the casts' names come from the guard's fresh generator, so they
        # do not depend on what earlier tests in the process generated
        lists = mp.AutoMixedPrecisionLists(
            custom_white_list={"lookup_table", "reduce_sum"},
            custom_black_list={"cumsum"})
        mp.rewrite_program_bf16(main, lists)
    return main


@pytest.mark.parametrize("case", ["bert_train", "bert_infer", "resnet",
                                  "custom_lists"])
def test_rewrite_gives_the_reference_program(case):
    """The same model code in both packages gives the same rewritten
    program: op types in order, every ``cast`` with its name, inputs,
    outputs and attrs, and every var's dtype (white-listed outputs
    retyped to bf16)."""
    if case.startswith("bert"):
        train = case == "bert_train"
        jmain = _bert_amp(jfluid, jbert, train)[0]
        tmain = _bert_amp(tfluid, tbert, train)[0]
    elif case == "resnet":
        jmain = _resnet_amp(jfluid, jres)[0]
        tmain = _resnet_amp(tfluid, tres)[0]
    else:
        jmain = _custom_lists_program(jfluid, jmp)
        tmain = _custom_lists_program(tfluid, tmp)
    jops, jdtypes = _describe(jmain)
    tops, tdtypes = _describe(tmain)
    assert tops == jops
    assert tdtypes == jdtypes
    counts = _op_counts(tmain)
    assert counts["cast"] > 0
    assert any(d == "bfloat16" for d in tdtypes.values())
    if case == "custom_lists":
        types = [op.type for op in tmain.global_block().ops]
        cum = types.index("cumsum")
        assert types[cum - 1] == "cast"
        assert tmain.global_block().ops[cum - 1].attrs["out_dtype"] == \
            "float32"
    if case == "bert_train":  # the masters stay float32
        for p in tmain.all_parameters():
            assert p.dtype == "float32", p.name
            assert tmain.global_block().var(p.name + "@GRAD").dtype \
                == "float32", p.name


# ---------------------------------------------------------------------------
# (b) the fusion passes on AMP programs
# ---------------------------------------------------------------------------

def test_conv_bn_act_absorbs_the_amp_cast_sandwich():
    """conv bf16 → cast f32 → batch_norm → cast bf16 → relu fuses at all
    21 sites of the cifar10 ResNet, as the reference's, with the
    reference's op counts and no batch_norm left."""
    jmain, _, _, jloss, _ = _resnet_amp(jfluid, jres)
    tmain, _, _, tloss, _ = _resnet_amp(tfluid, tres)
    jprog, jreport = jfusion.resolve_fused_program(jmain,
                                                   targets=[jloss.name])
    tprog, treport = tfusion.resolve_fused_program(tmain,
                                                   targets=[tloss.name])
    assert treport.counts() == jreport.counts() == {"conv_bn_act": 21}
    assert _op_counts(tprog) == _op_counts(jprog)
    assert _op_counts(tprog)["batch_norm"] == 0
    notes = [r.note for r in treport.applied if r.family == "conv_bn_act"]
    assert len(notes) == 21
    assert all("AMP cast sandwich" in n for n in notes)


@pytest.mark.parametrize("train", [True, False], ids=["train", "infer"])
def test_bert_amp_program_fuses_like_the_reference(train):
    """Every family on bert-tiny's AMP program: the same rewrites and
    the same op counts as the reference's."""
    jmain, _, _, jloss = _bert_amp(jfluid, jbert, train)
    tmain, _, _, tloss = _bert_amp(tfluid, tbert, train)
    jprog, jreport = jfusion.resolve_fused_program(jmain,
                                                   targets=[jloss.name])
    tprog, treport = tfusion.resolve_fused_program(tmain,
                                                   targets=[tloss.name])
    assert treport.counts() == jreport.counts()
    assert treport.counts().get("dropout_add_ln", 0) > 0
    assert _op_counts(tprog) == _op_counts(jprog)


# ---------------------------------------------------------------------------
# (c) each op on the AMP paths, one op on the same bf16 inputs
# ---------------------------------------------------------------------------

def _as(a, dtype, pkg):
    if pkg == "jax":
        x = jnp.asarray(a)
        return x.astype(jnp.bfloat16) if dtype == "bf16" else x
    x = torch.from_numpy(np.ascontiguousarray(a))
    return x.to(torch.bfloat16) if dtype == "bf16" else x


def _op_pair(op, attrs, ins, out_slot, wrt, seed=0):
    """One op through both packages' lowerings: ``ins`` maps a slot to
    ``(array, "bf16" | "f32" | None)``; the output of ``out_slot`` and
    the gradients of the ``wrt`` slots under a seeded cotangent (the
    reference's by ``jax.vjp``, the port's by autograd) → ``{name:
    (port, reference)}``, each also with its dtype."""
    jins = {s: [_as(a, d, "jax")] for s, (a, d) in ins.items()}
    tins = {s: [_as(a, d, "torch")] for s, (a, d) in ins.items()}
    jdef, tdef = j_registry.get_op_def(op), t_registry.get_op_def(op)
    jctx = j_registry.LoweringContext(mode="train")

    def jfn(*vals):
        slots = dict(jins, **{s: [v] for s, v in zip(wrt, vals)})
        return j_registry.call_op(jdef, jctx, slots, dict(attrs))[
            out_slot][0]

    jout, vjp = jax.vjp(jfn, *[jins[s][0] for s in wrt])
    cot = np.random.RandomState(seed + 7).randn(*jout.shape).astype(
        "float32")
    jgrads = vjp(jnp.asarray(cot).astype(jout.dtype))
    leaves = {s: tins[s][0].detach().requires_grad_() for s in wrt}
    slots = dict(tins, **{s: [v] for s, v in leaves.items()})
    tout = t_registry.call_op(tdef, t_registry.LoweringContext(), slots,
                              dict(attrs))[out_slot][0]
    tgrads = torch.autograd.grad(tout, [leaves[s] for s in wrt],
                                 torch.from_numpy(cot).to(tout.dtype))
    out = {"out": (tout, jout)}
    out.update({s + "@GRAD": (g, w) for s, g, w in zip(wrt, tgrads,
                                                       jgrads)})
    return out


def _assert_pairs(pairs, rtol):
    for name, (got, want) in pairs.items():
        assert str(got.dtype).replace("torch.", "") == str(want.dtype), (
            name, got.dtype, want.dtype)
        assert tuple(got.shape) == tuple(want.shape), name
        assert _rel(_f32(got), _f32(want)) <= rtol, (
            name, _rel(_f32(got), _f32(want)))


def _rng(seed=0):
    return np.random.RandomState(seed)


def test_mul_and_matmul_in_bf16():
    """bf16 products accumulate in f32 and round once to bf16; matmul's
    alpha is rounded to bf16 first (0.3 is not a bf16 value)."""
    rng = _rng()
    x = rng.randn(6, 8, 32).astype("float32")
    w = rng.randn(32, 16).astype("float32")
    _assert_pairs(_op_pair("mul", {"x_num_col_dims": 2},
                           {"X": (x, "bf16"), "Y": (w, "bf16")}, "Out",
                           ["X", "Y"]), OP_RTOL)
    a, b = (rng.randn(2, 3, 16, 64).astype("float32") for _ in range(2))
    for alpha in (0.125, 0.3):
        _assert_pairs(_op_pair("matmul", {"transpose_Y": True,
                                          "alpha": alpha},
                               {"X": (a, "bf16"), "Y": (b, "bf16")}, "Out",
                               ["X", "Y"]), OP_RTOL)


@pytest.mark.parametrize("src, dst", [("f32", "bfloat16"),
                                      ("bf16", "float32")])
def test_cast_and_its_grad(src, dst):
    """The cast's gradient casts back to the input's dtype: the float32
    masters' gradients arrive float32."""
    x = _rng().randn(4, 33).astype("float32")
    pairs = _op_pair("cast", {"in_dtype": "float32" if src == "f32"
                              else "bfloat16", "out_dtype": dst},
                     {"X": (x, src)}, "Out", ["X"])
    _assert_pairs(pairs, OP_RTOL)
    assert pairs["X@GRAD"][0].dtype == (torch.float32 if src == "f32"
                                        else torch.bfloat16)


def test_fused_dropout_add_ln_with_bf16_scale_and_bias(interpret):
    """The rewrite casts the op's Scale and Bias to bf16: the kernels
    widen them to f32 (exact), and their gradients come back bf16,
    rounded as the reference's vjp rounds them."""
    rng = _rng(1)
    n, d = 64, 128
    x, res = (rng.randn(n, d).astype("float32") for _ in range(2))
    g = (1 + 0.1 * rng.randn(d)).astype("float32")
    b = (0.1 * rng.randn(d)).astype("float32")
    pairs = _op_pair("fused_dropout_add_ln", {"epsilon": 1e-12},
                     {"X": (x, "bf16"), "Residual": (res, "bf16"),
                      "Scale": (g, "bf16"), "Bias": (b, "bf16")}, "Out",
                     ["X", "Residual", "Scale", "Bias"])
    _assert_pairs(pairs, OP_RTOL)
    assert pairs["Scale@GRAD"][0].dtype == torch.bfloat16


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_ln_entry_takes_bf16_scale_and_bias_as_widened(rate):
    """The K2 entry given bf16 Scale and Bias computes what it computed
    from the same values widened to float32 first (the cast launches it
    no longer makes), with gradients of the same dtype and bits: dgamma
    and dbeta summed in float32 and rounded to bf16 once."""
    rng = _rng(3)
    n, d = 37, 96
    x, res, dout = (torch.from_numpy(rng.randn(n, d).astype("float32"))
                    .bfloat16() for _ in range(3))
    g = torch.from_numpy((1 + 0.1 * rng.randn(d)).astype("float32"))
    b = torch.from_numpy((0.1 * rng.randn(d)).astype("float32"))
    seed = 5 if rate else None
    runs = []
    for widen in (False, True):
        leaves = [t.clone().requires_grad_() for t in
                  (x, res, g.bfloat16(), b.bfloat16())]
        args = leaves[:2] + ([t.float() for t in leaves[2:]] if widen
                             else leaves[2:])
        out = t_fln.fused_dropout_add_ln(*args, dropout_rate=rate,
                                         eps=1e-12, seed=seed)
        runs.append([out] + list(torch.autograd.grad(out, leaves, dout)))
    for name, a, w in zip(("out", "dx", "dres", "dgamma", "dbeta"), *runs):
        assert a.dtype == w.dtype == torch.bfloat16, (name, a.dtype, w.dtype)
        assert torch.equal(a.view(torch.int16), w.view(torch.int16)), name


def test_fused_ln_entry_passes_bf16_scale_and_bias_on(monkeypatch):
    """The entry hands bf16 gamma/beta to the forward wrapper as they
    are, with and without a gradient wanted; gamma/beta of a third dtype
    are widened to float32."""
    seen = []
    real = t_fln.fused_dropout_add_ln_fwd

    def spy(x, residual, gamma, beta, *args, **kwargs):
        seen.append((gamma.dtype, beta.dtype))
        return real(x, residual, gamma, beta, *args, **kwargs)

    monkeypatch.setattr(t_fln, "fused_dropout_add_ln_fwd", spy)
    x = torch.randn(8, 32).bfloat16()
    g, b = torch.ones(32).bfloat16(), torch.zeros(32).bfloat16()
    t_fln.fused_dropout_add_ln(x, x, g, b)
    t_fln.fused_dropout_add_ln(x.requires_grad_(), x, g, b)
    t_fln.fused_dropout_add_ln(x.float(), x.float(), g, b)
    assert seen == [(torch.bfloat16, torch.bfloat16)] * 2 \
        + [(torch.float32, torch.float32)]


def test_fused_multihead_attention_with_bf16_qkv_and_mask_bias(interpret):
    """bf16 Q/K/V and a bf16 mask bias (-1e4 rounds to -9984 in the
    cast, alike in both), against the reference's Pallas kernel in
    interpret mode."""
    rng = _rng(2)
    q, k, v = (rng.randn(2, 2, 128, 64).astype("float32") for _ in range(3))
    mask = np.zeros((2, 1, 1, 128), "float32")
    mask[0, ..., 100:] = -1e4
    mask[1, ..., 60:] = -1e4
    pairs = _op_pair("fused_multihead_attention", {"scale": 0.125},
                     {"Q": (q, "bf16"), "K": (k, "bf16"), "V": (v, "bf16"),
                      "BiasQK": (mask, "bf16")}, "Out", ["Q", "K", "V"])
    _assert_pairs(pairs, ATTN_RTOL)


def test_softmax_with_cross_entropy_on_bf16_logits():
    """f32 internals: the loss is float32, the logits' gradient bf16."""
    rng = _rng(3)
    logits = (3 * rng.randn(20, 50)).astype("float32")
    label = rng.randint(0, 50, (20, 1)).astype("int64")
    pairs = _op_pair("softmax_with_cross_entropy", {},
                     {"Logits": (logits, "bf16"), "Label": (label, None)},
                     "Loss", ["Logits"])
    assert pairs["out"][0].dtype == torch.float32
    _assert_pairs(pairs, MIXED_RTOL)


@pytest.mark.parametrize("op", ["elementwise_add", "fc"])
def test_mixed_bf16_and_f32_inputs_promote_to_f32(op):
    """An op in neither list meeting a bf16 and an f32 input (``fc``
    after ``fc_fuse_pass`` in the bf16 predictor; an add beside a
    black-listed op) computes in f32, as ``jnp.result_type``."""
    rng = _rng(4)
    x = rng.randn(6, 8, 32).astype("float32")
    if op == "elementwise_add":
        pairs = _op_pair(op, {"axis": -1},
                         {"X": (x, "bf16"),
                          "Y": (rng.randn(32).astype("float32"), "f32")},
                         "Out", ["X", "Y"])
    else:
        pairs = _op_pair(op, {"in_num_col_dims": 2},
                         {"Input": (x, "bf16"),
                          "W": (rng.randn(32, 16).astype("float32"), "f32"),
                          "Bias": (rng.randn(16).astype("float32"), "f32")},
                         "Out", ["Input", "W", "Bias"])
    assert pairs["out"][0].dtype == torch.float32
    _assert_pairs(pairs, MIXED_RTOL)


GLUE = [
    ("gelu", {}, "Out"),
    ("relu", {}, "Out"),
    ("scale", {"scale": 0.3, "bias": 0.7}, "Out"),
    ("dropout", {"dropout_prob": 0.1, "is_test": True}, "Out"),
    ("softmax", {}, "Out"),
    ("layer_norm", {"begin_norm_axis": 2, "epsilon": 1e-12}, "Y"),
    ("reshape2", {"shape": [6, 256]}, "Out"),
    ("transpose2", {"axis": [1, 0, 2]}, "Out"),
    ("sum", {}, "Out"),
]


@pytest.mark.parametrize("op, attrs, out", GLUE, ids=[g[0] for g in GLUE])
def test_bf16_glue_ops_round_as_the_reference(op, attrs, out):
    """The white-listed glue in bf16, forward and gradient, bit for bit:
    gelu's erf form op by op in bf16 with bf16 constants, as
    ``jax.nn.gelu`` computes it; scale's and dropout's scalars rounded
    to bf16 first; layer_norm and softmax with f32 internals."""
    rng = _rng(5)
    ins = {"X": (rng.randn(6, 8, 32).astype("float32"), "bf16")}
    wrt = ["X"]
    if op == "layer_norm":
        ins["Scale"] = (rng.randn(32).astype("float32"), "bf16")
        ins["Bias"] = (rng.randn(32).astype("float32"), "bf16")
        wrt += ["Scale", "Bias"]
    if op == "sum":
        ins = {"X": ([ins["X"][0]], "bf16")}
        pairs = _sum_pair(ins["X"][0][0])
    else:
        pairs = _op_pair(op, attrs, ins, out, wrt)
    _assert_pairs(pairs, OP_RTOL)


def _sum_pair(a):
    """``sum`` over a duplicable slot of two bf16 inputs."""
    b = a[::-1].copy()
    jdef, tdef = j_registry.get_op_def("sum"), t_registry.get_op_def("sum")
    jx = [_as(v, "bf16", "jax") for v in (a, b)]
    want = j_registry.call_op(jdef, j_registry.LoweringContext(),
                              {"X": jx}, {})["Out"][0]
    tx = [_as(v, "bf16", "torch") for v in (a, b)]
    got = t_registry.call_op(tdef, t_registry.LoweringContext(),
                             {"X": tx}, {})["Out"][0]
    return {"out": (got, want)}


def test_bf16_conv2d_channels_last():
    """conv2d on bf16 NHWC input and filter: bf16 out, f32 accumulation
    on both sides."""
    rng = _rng(6)
    pairs = _op_pair("conv2d", {"strides": [1, 1], "paddings": [1, 1],
                                "data_format": "NHWC"},
                     {"Input": (rng.randn(2, 8, 8, 16).astype("float32"),
                                "bf16"),
                      "Filter": (0.1 * rng.randn(32, 16, 3, 3).astype(
                          "float32"), "bf16")},
                     "Output", ["Input", "Filter"])
    _assert_pairs(pairs, OP_RTOL)


# ---------------------------------------------------------------------------
# (d) training with amp=True
# ---------------------------------------------------------------------------

def _pretrain(fluid, bert, amp):
    cfg = copy.copy(bert.BERT_TINY)
    cfg.fuse_attn = True
    cfg.dropout = cfg.attn_dropout = 0.0
    with fluid.unique_name.guard():
        return bert.build_pretrain(cfg, seq_len=T, amp=amp, lr=LR)


def _grad_names(program, opt):
    return {op.inputs["Param"][0]: op.inputs["Grad"][0]
            for op in program.global_block().ops if op.type == opt}


def _train_both(jprog, tprog, feed, fetch0, loss, steps):
    """``steps`` steps in both packages from the reference's start: the
    first step's ``fetch0`` and every step's loss → (reference, port,
    the start, reference scope, port scope)."""
    jmain, jstart = jprog
    tmain, tstart = tprog
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
        start = convert.scope_persistables(jmain, jscope)
        want = [jexe.run(jmain, feed=feed, fetch_list=fetch0)]
        want += [jexe.run(jmain, feed=feed, fetch_list=[loss])
                 for _ in range(steps - 1)]
    tscope = tfluid.Scope()
    with tfluid.scope_guard(tscope):
        texe = tfluid.Executor(tfluid.CPUPlace())
        texe.run(tstart)
    convert.load_params_into_scope(start, tscope, "cpu", program=tmain)
    with tfluid.scope_guard(tscope):
        got = [texe.run(tmain, feed=feed, fetch_list=fetch0)]
        got += [texe.run(tmain, feed=feed, fetch_list=[loss])
                for _ in range(steps - 1)]
    return want, got, start, jscope, tscope


def _losses(runs):
    return np.array([float(np.asarray(r[0], np.float32).reshape(-1)[0])
                     for r in runs])


def _port_losses(tmain, tstart, start, feed, loss, steps):
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(tstart)
    convert.load_params_into_scope(start, scope, "cpu", program=tmain)
    with tfluid.scope_guard(scope):
        return _losses([exe.run(tmain, feed=feed, fetch_list=[loss])
                        for _ in range(steps)])


def test_bert_tiny_amp_adam_steps_match_reference(interpret):
    """3 Adam steps of bert-tiny ``build_pretrain(amp=True)``: losses,
    step-0 gradients (float32) and final parameters against the
    reference; the loss differs from the port's float32 run by more
    than float32 noise."""
    jmain, jstart, _, jloss = _pretrain(jfluid, jbert, True)
    tmain, tstart, _, tloss = _pretrain(tfluid, tbert, True)
    grads = _grad_names(jmain, "adam")
    assert _grad_names(tmain, "adam") == grads
    names = sorted(grads)
    feed = jbert.make_fake_batch(BATCH, T, jbert.BERT_TINY,
                                 np.random.RandomState(0))
    fetch0 = [jloss.name] + [grads[n] for n in names]
    want, got, start, jscope, tscope = _train_both(
        (jmain, jstart), (tmain, tstart), feed, fetch0, jloss.name, STEPS)
    assert np.asarray(got[0][0]).dtype == np.asarray(want[0][0]).dtype
    np.testing.assert_allclose(_losses(got), _losses(want),
                               rtol=BERT_LOSS_RTOL)
    assert _losses(got)[-1] < _losses(got)[0]
    for name, g, w in zip(names, got[0][1:], want[0][1:]):
        assert g.dtype == np.float32, name
        w = np.asarray(w)
        assert np.abs(g - w).max() <= BERT_GRAD_RTOL * np.abs(w).max() \
            + BERT_GRAD_ATOL, (name, _rel(g, w))
    for name in names:
        np.testing.assert_allclose(tscope.get(name).numpy(),
                                   np.asarray(jscope.get(name)),
                                   atol=BERT_PARAM_ATOL, rtol=0,
                                   err_msg=name)
    f32main, f32start, _, f32loss = _pretrain(tfluid, tbert, False)
    f32 = _port_losses(f32main, f32start, start, feed, f32loss.name, STEPS)
    assert np.abs(_losses(got) - f32).max() / np.abs(f32).max() \
        > AMP_VS_F32_MIN


def _resnet(fluid, resnet, amp):
    with fluid.unique_name.guard():
        return resnet.build(dataset="cifar10", depth=8, amp=amp,
                            data_format="NHWC", batch_lr=RESNET_LR)


def test_resnet_amp_momentum_steps_match_reference(interpret):
    """3 Nesterov Momentum steps of a small ``resnet.build(dataset=
    "cifar10", amp=True)`` NHWC (every conv → batch_norm site fused
    with its cast sandwich): losses and float32 gradients against the
    reference; AMP differs from float32 by more than float32 noise."""
    jmain, jstart, _, jloss, _ = _resnet(jfluid, jres, True)
    tmain, tstart, _, tloss, _ = _resnet(tfluid, tres, True)
    grads = _grad_names(jmain, "momentum")
    assert _grad_names(tmain, "momentum") == grads
    names = sorted(grads)
    rng = np.random.RandomState(0)
    feed = {"img": rng.randn(4, 32, 32, 3).astype("float32"),
            "label": rng.randint(0, 10, (4, 1)).astype("int64")}
    fetch0 = [jloss.name] + [grads[n] for n in names]
    want, got, start, _, _ = _train_both(
        (jmain, jstart), (tmain, tstart), feed, fetch0, jloss.name, STEPS)
    gl, wl = _losses(got), _losses(want)
    np.testing.assert_allclose(gl, wl, rtol=RESNET_LOSS_RTOL)
    for name, g in zip(names, got[0][1:]):
        assert g.dtype == np.float32 and np.isfinite(g).all(), name
    f32main, f32start, _, f32loss, _ = _resnet(tfluid, tres, False)
    f32 = _port_losses(f32main, f32start, start, feed, f32loss.name, STEPS)
    assert np.abs(gl - f32).max() / np.abs(f32).max() > AMP_VS_F32_MIN


def test_amp_compiled_step_matches_eager_bit_for_bit(private_autotune):
    """bert-tiny's AMP training program through the executor's compiled
    step (eager, then capture, then replays: on the CPU the same
    bookkeeping runs the step directly) against the eager path: the
    losses and every parameter after three steps, bit for bit.  The
    check's own autotune cache keeps another test's write to the shared
    one from resolving the program again mid-check."""
    main, startup, _, loss = _pretrain(tfluid, tbert, True)
    feed = tbert.make_fake_batch(BATCH, T, tbert.BERT_TINY,
                                 np.random.RandomState(2))
    runs = []
    for cache in (False, True):
        scope = tfluid.Scope()
        with tfluid.scope_guard(scope):
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup)
            losses = [exe.run(main, feed=feed, fetch_list=[loss],
                              use_program_cache=cache)[0]
                      for _ in range(STEPS)]
            params = {p.name: scope.get(p.name).numpy().copy()
                      for p in main.all_parameters()}
        runs.append((losses, params, exe.last_run_mode))
    (el, ep, _), (gl, gp, mode) = runs
    assert mode == "graph"
    for a, b in zip(el, gl):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    for name in ep:
        np.testing.assert_array_equal(ep[name], gp[name], err_msg=name)


def test_amp_checkpoint_holds_the_reference_file_set(tmp_path):
    """``save_persistables`` of bert-tiny's AMP training program writes
    the reference's file set (float32 masters and optimizer state; the
    ``.cast_bfloat16`` copies are not persistable), and the port loads
    the reference's checkpoint into its own AMP program."""
    dirs = {}
    for fluid, bert in ((jfluid, jbert), (tfluid, tbert)):
        main, startup, _, _ = _pretrain(fluid, bert, True)
        d = str(tmp_path / fluid.__name__)
        with fluid.scope_guard(fluid.Scope()):
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup)
            fluid.io.save_persistables(exe, d, main_program=main)
        dirs[fluid] = (d, main, startup)
    jfiles = sorted(os.listdir(dirs[jfluid][0]))
    assert sorted(os.listdir(dirs[tfluid][0])) == jfiles
    assert not any("cast_" in f for f in jfiles)
    d, main, startup = dirs[jfluid][0], dirs[tfluid][1], dirs[tfluid][2]
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        tfluid.io.load_persistables(exe, d, main_program=main)
    w = scope.get("bert.word_emb")
    assert w.dtype == torch.float32
    np.testing.assert_array_equal(
        w.numpy(), np.load(os.path.join(d, "bert.word_emb.npy")))


# ---------------------------------------------------------------------------
# (e) serving with enable_bf16
# ---------------------------------------------------------------------------

def _export_resnet():
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        img = jfluid.layers.data("img", shape=[3, 32, 32], dtype="float32")
        out = jres.resnet_cifar10(img, 10, 20, is_test=True)
    feed = {"img": _rng(0).randn(2, 3, 32, 32).astype("float32")}
    return main, startup, ["img"], out, feed


def _export_bert():
    cfg = copy.copy(jbert.BERT_TINY)
    cfg.fuse_attn = True
    cfg.dropout = cfg.attn_dropout = 0.0
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        ids = jfluid.layers.data("input_ids", shape=[T], dtype="int64")
        tt = jfluid.layers.data("token_type_ids", shape=[T], dtype="int64")
        mask = jfluid.layers.data("attn_mask_bias", shape=[1, 1, T],
                                  dtype="float32")
        out = jbert.encoder(ids, tt, mask, cfg, T)
    rng = _rng(0)
    bias = np.zeros((3, 1, 1, T), "float32")
    for r in range(3):
        bias[r, 0, 0, T - rng.randint(0, T // 2):] = -1e4
    feed = {"input_ids": rng.randint(0, 1024, (3, T)).astype("int64"),
            "token_type_ids": rng.randint(0, 2, (3, T)).astype("int64"),
            "attn_mask_bias": bias,
            "pos_ids": np.tile(np.arange(T, dtype="int64"), (3, 1))}
    return (main, startup, ["input_ids", "token_type_ids", "attn_mask_bias",
                            "pos_ids"], out, feed)


@pytest.mark.parametrize("model", ["resnet", "bert"])
def test_enable_bf16_serving_matches_reference(interpret, tmp_path, model):
    """The reference exports the model; each package's predictor with
    ``enable_bf16`` folds first (no batch_norm left, casts present, the
    reference's op list), serves within its own bounds against its
    float32 predictor, and the port agrees with the reference."""
    d = str(tmp_path / model)
    main, startup, feeds, out, feed = (_export_resnet if model == "resnet"
                                       else _export_bert)()
    with jfluid.scope_guard(jfluid.Scope()):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        jfluid.io.save_inference_model(d, feeds, [out], exe,
                                       main_program=main)
    preds = {}
    for fluid in (jfluid, tfluid):
        for bf16 in (False, True):
            cfg = fluid.inference.AnalysisConfig(d)
            if fluid is tfluid:
                cfg.disable_gpu()
            if bf16:
                cfg.enable_bf16()
                assert cfg.bf16_enabled()
            preds[fluid, bf16] = fluid.inference.create_paddle_predictor(cfg)
    jprog, tprog = preds[jfluid, True].program, preds[tfluid, True].program
    assert [op.type for op in tprog.global_block().ops] == \
        [op.type for op in jprog.global_block().ops]
    counts = _op_counts(tprog)
    assert counts["batch_norm"] == 0 and counts["cast"] > 0
    outs = {k: np.asarray(p.run(feed)[0]) for k, p in preds.items()}
    for fluid in (jfluid, tfluid):
        assert outs[fluid, True].dtype == outs[jfluid, True].dtype
        err = _rel(outs[fluid, True].astype("float32"), outs[fluid, False])
        assert SERVE_ERR_MIN < err < SERVE_ERR_MAX, (fluid.__name__, err)
    tol = SERVE_RESNET_RTOL if model == "resnet" else SERVE_BERT_RTOL
    assert _rel(outs[tfluid, True].astype("float32"),
                outs[jfluid, True].astype("float32")) <= tol


# ---------------------------------------------------------------------------
# (f) what the card's runs read: fetch dtypes, launches by element type
# ---------------------------------------------------------------------------

def test_bf16_fetch_is_float32_without_ml_dtypes(monkeypatch):
    """A bf16 fetch is ``ml_dtypes.bfloat16`` numpy where that package is
    installed (the reference's fetch dtype) and exact float32 where it
    is not (PyTorch does not depend on it)."""
    import sys

    from paddle_tpu_torch import pipeline

    t = torch.tensor([1.5, -2.25, 3.0e-3], dtype=torch.bfloat16)
    with_pkg = pipeline.host_values([t])[0]
    assert with_pkg.dtype.name == "bfloat16"
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    without = pipeline.host_values([t])[0]
    assert without.dtype == np.float32
    np.testing.assert_array_equal(without, t.float().numpy())
    np.testing.assert_array_equal(with_pkg.astype(np.float32), without)


@pytest.mark.parametrize("name, kernel, dtype", [
    ("_ZN12_GLOBAL__N_116flash_fwd_kernelI13__nv_bfloat16Li64EEEvPKT_",
     "flash_attention_fwd", "bfloat16"),
    ("_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi64EEEvPKT_",
     "flash_attention_fwd", "float32"),
    ("_ZN12_GLOBAL__N_113gather_kernelIl5uint4EEvPKT0_",
     "embedding_gather_fwd", None),
    ("_ZN12_GLOBAL__N_125embedding_bwd_rows_kernelIlfLi4EEEvv",
     "embedding_gather_bwd", "float32"),
    ("void (anonymous namespace)::add_ln_fwd_kernel<__nv_bfloat16, 4>(int)",
     "fused_dropout_add_ln_fwd", "bfloat16"),
    ("void (anonymous namespace)::bn_act_fwd_kernel<float, 8, true>(x)",
     "bn_act_epilogue_fwd", "float32"),
])
def test_kernel_dtype_reads_the_template_arguments(name, kernel, dtype):
    """A graph kernel node's device function name, mangled (libcuda) or
    demangled (the profiler), gives its kernel and the element type it
    was instantiated for: the first floating template argument; the
    gather, which moves raw words, has none."""
    from paddle_tpu_torch.ops.cuda import _lib

    assert _lib.kernel_of(name) == kernel
    assert _lib.kernel_dtype(name) == dtype
