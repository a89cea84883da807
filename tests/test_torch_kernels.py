"""Each kernel module of the PyTorch port against the reference package.

The same seeded numpy inputs go through the reference's Pallas kernels
(``PADDLE_TPU_PALLAS=interpret``, set through ``monkeypatch``, as the
reference's own CPU tests run them) and through the port's wrappers on
CPU tensors, where each wrapper runs its kernel's plain PyTorch version.
The CUDA kernels themselves are held against the same plain versions on
the GPU by ``chip_smoke.py``.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

FA = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
FLN = importlib.import_module("paddle_tpu.ops.pallas.fused_ln")
EMB = importlib.import_module("paddle_tpu.ops.pallas.embedding")
CBA = importlib.import_module("paddle_tpu.ops.pallas.conv_bn_act")

from paddle_tpu_torch.ops.cuda import conv_bn_act as t_cba  # noqa: E402
from paddle_tpu_torch.ops.cuda import dropout as t_drop  # noqa: E402
from paddle_tpu_torch.ops.cuda import embedding as t_emb  # noqa: E402
from paddle_tpu_torch.ops.cuda import flash_attention as t_fa  # noqa: E402
from paddle_tpu_torch.ops.cuda import fused_ln as t_fln  # noqa: E402

# float32 both sides; sums run in another order (blocked online softmax
# on the reference side, one matmul on ours)
FLASH_TOL = 2e-5
LN_TOL = 1e-5
# gradients: float32 both sides, the reference's blocked sums against one
# matmul per product here, through a softmax Jacobian
FLASH_GRAD_TOL = 1e-4
LN_GRAD_TOL = 2e-5
DROP_SEED = 1234


@pytest.fixture
def debug_dropout(monkeypatch):
    """The reference's debug hash for in-kernel dropout, on both sides."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_DROPOUT_DEBUG", "iota")


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")


def _flash_inputs(seed, b, h, t, d, with_bias):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, t, d).astype("float32") for _ in range(3))
    bias = None
    if with_bias:
        bias = np.where(rng.rand(b, t) < 0.2, -1e4, 0).astype("float32")
    return q, k, v, bias


@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_attention_matches_pallas_kernel(interpret, t, causal,
                                               with_bias):
    q, k, v, bias = _flash_inputs(t + causal, 2, 2, t, 64, with_bias)
    jb = None if bias is None else jnp.asarray(bias)
    want_kernel = np.asarray(FA.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jb,
        causal=causal))
    want_ref = np.asarray(FA.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jb,
        causal=causal))
    got = t_fa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        bias=None if bias is None else torch.from_numpy(bias),
        causal=causal).numpy()
    np.testing.assert_allclose(got, want_kernel, atol=FLASH_TOL,
                               rtol=FLASH_TOL)
    np.testing.assert_allclose(got, want_ref, atol=FLASH_TOL,
                               rtol=FLASH_TOL)


def test_flash_attention_saves_m_and_l_like_the_kernel(interpret):
    """The backward reads the saved m and l: they match the reference
    kernel's saved statistics, bias given as [B,1,1,T]."""
    b, h, t, d = 2, 2, 128, 64
    q, k, v, bias = _flash_inputs(3, b, h, t, d, True)
    scale = 1.0 / np.sqrt(d)
    flat = [jnp.asarray(x.reshape(b * h, t, d)) for x in (q, k, v)]
    seed = jnp.zeros((1,), jnp.int32)
    _, m, l = FA._flash_fwd(*flat, jnp.asarray(bias), seed, False, scale,
                            128, 128, True, 0.0, False)
    _, tm, tl = t_fa.flash_attention_fwd(
        *(torch.from_numpy(x.reshape(b * h, t, d)) for x in (q, k, v)),
        bias=torch.from_numpy(bias.reshape(b, 1, 1, t)))
    np.testing.assert_allclose(tm.numpy(), np.asarray(m)[:, 0],
                               atol=FLASH_TOL, rtol=FLASH_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(l)[:, 0],
                               atol=1e-4, rtol=FLASH_TOL)


def test_flash_attention_fully_masked_row_is_zero():
    """A row whose every key is biased to -inf returns 0 and saves l=1
    (the TPU kernel's l == 0 guard)."""
    q, k, v, _ = _flash_inputs(4, 2, 2, 16, 8, False)
    bias = np.zeros((2, 16), "float32")
    bias[1, :] = -np.inf
    o, m, l = t_fa.flash_attention_fwd(
        *(torch.from_numpy(x.reshape(4, 16, 8)) for x in (q, k, v)),
        bias=torch.from_numpy(bias))
    assert torch.all(o[2:] == 0) and torch.isfinite(o[:2]).all()
    assert torch.all(l[2:] == 1) and torch.all(m[2:] == t_fa.NEG_INF)


def test_flash_attention_wrapper_rejects_dropout():
    """The reference's argument checks (flash_attention.py:720-726): rate
    1 would upscale by 1/0, and a rate > 0 needs a seed."""
    q = torch.zeros(1, 2, 4, 8)
    jq = jnp.asarray(q.numpy())
    for rate, seed, match in ((1.0, 3, "must be in"),
                              (0.1, None, "requires dropout_seed")):
        with pytest.raises(ValueError, match=match):
            FA.flash_attention(jq, jq, jq, dropout_rate=rate,
                               dropout_seed=seed)
        with pytest.raises(ValueError, match=match):
            t_fa.flash_attention(q, q, q, dropout_rate=rate,
                                 dropout_seed=seed)
        with pytest.raises(ValueError, match=match):
            t_fa.flash_attention_fwd(q[0], q[0], q[0], dropout_rate=rate,
                                     dropout_seed=seed)


def test_fused_ln_matches_pallas_kernel(interpret):
    rng = np.random.RandomState(5)
    n, d = 64, 128
    x, res = (rng.randn(n, d).astype("float32") for _ in range(2))
    g = (1.0 + 0.1 * rng.randn(d)).astype("float32")
    b = (0.1 * rng.randn(d)).astype("float32")
    want = np.asarray(FLN.fused_dropout_add_ln(
        jnp.asarray(x), jnp.asarray(res), jnp.asarray(g), jnp.asarray(b)))
    got = t_fln.fused_dropout_add_ln_fwd(
        *(torch.from_numpy(a) for a in (x, res, g, b))).numpy()
    np.testing.assert_allclose(got, want, atol=LN_TOL, rtol=LN_TOL)


# the widths at which the K2 forward's instance table switches (one warp
# up to 768 columns, several above; 30 and 1000 are not whole 16-byte
# chunks of bf16 or float32 and take scalar accesses), and row counts the
# reference's Pallas kernel takes (a multiple of 8, interpret mode) or
# leaves to its XLA composite (ragged)
LN_FWD_DS = [30, 640, 768, 1000, 4096]
LN_FWD_NS = [40, 37]
# bf16: the same float32 arithmetic rounded once, the row sums in another
# order: at most one unit in the last place at the largest |out|
LN_BF16_UNITS = 1


def _ln_fwd_inputs(seed, n, d, dtype="float32"):
    rng = np.random.RandomState(seed)
    x, res = (rng.randn(n, d).astype("float32") for _ in range(2))
    if dtype == "bfloat16":  # bf16 values, carried in float32 arrays
        x, res = (torch.from_numpy(a).bfloat16().float().numpy()
                  for a in (x, res))
    g = (1.0 + 0.1 * rng.randn(d)).astype("float32")
    b = (0.1 * rng.randn(d)).astype("float32")
    return x, res, g, b


def _ln_fwd_pair(x, res, g, b, rate, dtype):
    """The port's forward with its statistics, and the reference's fused
    op: ``_fwd_call``'s out, y, mean and rstd where its Pallas kernel
    takes the shape, else the public entry's out; all float32 numpy."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx, jr = (jnp.asarray(a).astype(jdt) for a in (x, res))
    jg, jb = jnp.asarray(g), jnp.asarray(b)
    jseed = jnp.asarray([DROP_SEED if rate else 0], jnp.int32)
    if FLN._eligible(jx):
        want = FLN._fwd_call(jx, jr, jg, jb, rate, 1e-5, jseed)
    else:
        want = (FLN.fused_dropout_add_ln(jx, jr, jg, jb, dropout_rate=rate,
                                         seed=jseed),)
    want = [np.asarray(w.astype(jnp.float32)) for w in want]
    got = t_fln.fused_dropout_add_ln_fwd(
        torch.from_numpy(x).to(tdt), torch.from_numpy(res).to(tdt),
        torch.from_numpy(g), torch.from_numpy(b), 1e-5, rate,
        DROP_SEED if rate else None, save_stats=True)
    # the reference's mean and rstd are [1, N]
    return ([t.float().numpy() for t in got],
            [w[0] if w.shape[0] == 1 else w for w in want])


@pytest.mark.parametrize("n", LN_FWD_NS)
@pytest.mark.parametrize("d", LN_FWD_DS)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_ln_fwd_matches_reference_across_widths(interpret,
                                                      debug_dropout, n, d,
                                                      rate):
    """The forward in float32 at every width the kernel's instance table
    tells apart, against the reference (its Pallas kernel in interpret
    mode where it takes the shape, with y, mean and rstd; its composite
    otherwise), the debug hash's mask at rate 0.1."""
    x, res, g, b = _ln_fwd_inputs(11 + d, n, d)
    got, want = _ln_fwd_pair(x, res, g, b, rate, "float32")
    for name, a, w in zip(("out", "y", "mean", "rstd"), got, want):
        np.testing.assert_allclose(a, w, atol=LN_TOL, rtol=LN_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("d", LN_FWD_DS)
def test_fused_ln_fwd_matches_reference_in_bfloat16(interpret,
                                                    debug_dropout, d):
    """x and residual in bf16 at rate 0.1 over a ragged N: out within
    ``LN_BF16_UNITS`` units in the last place at its largest value, and
    y, one rounding of the same float32 sum under the reference's debug
    mask, bit for bit."""
    n = 37
    x, res, g, b = _ln_fwd_inputs(21 + d, n, d, "bfloat16")
    got, want = _ln_fwd_pair(x, res, g, b, 0.1, "bfloat16")
    unit = 2.0 ** -7 * np.abs(want[0]).max()
    assert np.abs(got[0] - want[0]).max() <= LN_BF16_UNITS * unit
    rows = np.arange(n, dtype=np.uint32)[:, None]
    cols = np.arange(d, dtype=np.uint32)[None, :]
    keep = np.asarray(FA._hash_bits(jnp.uint32(0), rows, cols,
                                    jnp.uint32(DROP_SEED))
                      >= FA._rate_threshold(0.1))
    y = np.where(keep, x * np.float32(1.0 / 0.9), np.float32(0)) + res
    np.testing.assert_array_equal(
        got[1], torch.from_numpy(y).bfloat16().float().numpy())


@pytest.mark.parametrize("ids_dtype", ["int32", "int64"])
def test_embedding_gather_matches_pallas_kernel(interpret, ids_dtype):
    """Negative ids read row 0, ids >= V read NaN, padding_idx reads
    zeros — exactly."""
    rng = np.random.RandomState(6)
    v, d = 50, 128
    table = rng.randn(v, d).astype("float32")
    ids = rng.randint(0, v, (40,)).astype(ids_dtype)
    ids[:4] = [-3, v, v + 7, 9]
    want = np.asarray(EMB.embedding_gather(
        jnp.asarray(table), jnp.asarray(ids.astype("int32")), 9))
    got = t_emb.embedding_gather_fwd(
        torch.from_numpy(table), torch.from_numpy(ids), 9).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[1]).all() and (got[3] == 0).all()
    np.testing.assert_array_equal(got[0], table[0])


def test_kernel_wrappers_run_plain_versions_on_cpu_without_counting():
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    reset_launch_counts()
    x = torch.randn(8, 128)
    t_fln.fused_dropout_add_ln_fwd(x, x, torch.ones(128), torch.zeros(128))
    t_emb.embedding_gather_fwd(x, torch.tensor([0, 3]))
    t_fa.flash_attention_fwd(x[None], x[None], x[None])
    assert set(launch_counts().values()) == {0}


def test_kernel_wrappers_check_dtypes():
    with pytest.raises(TypeError):
        t_emb.embedding_gather_fwd(torch.zeros(4, 8),
                                   torch.zeros(2, dtype=torch.float32))
    with pytest.raises(ValueError):
        t_fln.fused_dropout_add_ln_fwd(torch.zeros(4, 8), torch.zeros(4, 9),
                                       torch.ones(8), torch.zeros(8))


def _np_card_bits(seed, b, r, c):
    """The card generator in numpy uint32 arithmetic (wrapping)."""
    def fmix(h):
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        return h ^ (h >> np.uint32(16))

    with np.errstate(over="ignore"):
        u = lambda x: np.asarray(x, np.uint64).astype(np.uint32)  # noqa
        key = fmix(u(seed) ^ (u(b) * np.uint32(0x9E3779B9)))
        key = fmix(key + u(r) * np.uint32(0x7FEB352D))
        return fmix(key ^ (u(c) * np.uint32(0x846CA68B)))


def test_dropout_generators_match_uint32_arithmetic():
    """The plain twins' int64 arithmetic masked to 32 bits gives the
    uint32 wrap-around results of the kernels' generators: the card
    generator against numpy, the debug hash against the reference's own
    ``debug_keep_mask``."""
    b = np.arange(3)[:, None, None]
    r = np.arange(70)[None, :, None]
    c = np.arange(90)[None, None, :]
    want = _np_card_bits(0xDEADBEEF, b, r, c)
    got = t_drop.card_bits(0xDEADBEEF, torch.from_numpy(b),
                           torch.from_numpy(r), torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    want_keep = np.asarray(FA.debug_keep_mask(3, 70, 90, 0.1, 77))
    got_keep = t_drop.keep_mask(77, 0.1, torch.from_numpy(b),
                                torch.from_numpy(r), torch.from_numpy(c),
                                debug=True)
    np.testing.assert_array_equal(got_keep.numpy(), want_keep)
    keep = t_drop.attention_keep_mask(5, 0.1, 4, 128, 128, "cpu")
    # 65536 Bernoulli(0.9) draws: the keep fraction within 4 sigma
    assert abs(float(keep.float().mean()) - 0.9) < 4 * (0.09 / keep.numel()) ** 0.5


def _jvjp(fn, args, cot):
    out, vjp = jax.vjp(fn, *args)
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _tgrads(fn, args, cot):
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(cot))
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("causal, with_bias, rate", [
    (False, True, 0.0), (True, False, 0.0), (False, False, 0.0),
    (True, True, 0.1), (False, True, 0.1)])
def test_flash_attention_bwd_matches_pallas_kernel(interpret, debug_dropout,
                                                   causal, with_bias, rate):
    """dQ, dK, dV of the plain backward (through the autograd function)
    against ``jax.vjp`` of the reference's kernels; at rate 0.1 both draw
    the debug hash mask from one shared seed."""
    q, k, v, bias = _flash_inputs(11 + causal, 2, 2, 128, 64, with_bias)
    cot = np.random.RandomState(7).randn(*q.shape).astype("float32")
    seed = DROP_SEED if rate else None
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else torch.from_numpy(bias)
    want_o, want = _jvjp(
        lambda a, b_, c: FA.flash_attention(
            a, b_, c, bias=jb, causal=causal, dropout_rate=rate,
            dropout_seed=seed), (q, k, v), cot)
    got_o, got = _tgrads(
        lambda a, b_, c: t_fa.flash_attention(
            a, b_, c, bias=tb, causal=causal, dropout_rate=rate,
            dropout_seed=seed), (q, k, v), cot)
    np.testing.assert_allclose(got_o, want_o, atol=FLASH_TOL, rtol=FLASH_TOL)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, atol=FLASH_GRAD_TOL,
                                   rtol=FLASH_GRAD_TOL, err_msg="d" + name)


def test_flash_attention_bwd_plain_matches_kernel_wrapper_and_masked_rows():
    """The wrapper's backward is the plain version on the CPU, and a row
    that sees no key gets zero gradients."""
    q, k, v, _ = _flash_inputs(4, 2, 2, 16, 8, False)
    bias = np.zeros((2, 16), "float32")
    bias[1, :] = -np.inf
    qt, kt, vt = (torch.from_numpy(x.reshape(4, 16, 8)) for x in (q, k, v))
    bt = torch.from_numpy(bias)
    o, m, l = t_fa.flash_attention_fwd(qt, kt, vt, bt)
    do = torch.randn(4, 16, 8, generator=torch.Generator().manual_seed(0))
    dq, dk, dv = t_fa.flash_attention_bwd(qt, kt, vt, bt, o, m, l, do)
    pq, pk, pv = t_fa.flash_attention_bwd_plain(qt, kt, vt, bt, o, m, l, do,
                                                sm_scale=8 ** -0.5)
    for a, b in ((dq, pq), (dk, pk), (dv, pv)):
        assert torch.equal(a, b)
    assert torch.all(dq[2:] == 0) and torch.all(dk[2:] == 0) \
        and torch.all(dv[2:] == 0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_ln_bwd_matches_pallas_kernel(interpret, debug_dropout, rate):
    """dx, dres, dgamma, dbeta against ``jax.vjp`` of the reference's
    fused op (its Pallas kernels; the debug hash mask at rate 0.1)."""
    rng = np.random.RandomState(8)
    n, d = 64, 128
    x, res = (rng.randn(n, d).astype("float32") for _ in range(2))
    g = (1.0 + 0.1 * rng.randn(d)).astype("float32")
    b = (0.1 * rng.randn(d)).astype("float32")
    cot = rng.randn(n, d).astype("float32")
    seed = DROP_SEED if rate else None
    jseed = None if seed is None else jnp.asarray([seed], jnp.int32)
    want_o, want = _jvjp(
        lambda *a: FLN.fused_dropout_add_ln(*a, dropout_rate=rate,
                                            seed=jseed),
        (x, res, g, b), cot)
    got_o, got = _tgrads(
        lambda *a: t_fln.fused_dropout_add_ln(*a, dropout_rate=rate,
                                              seed=seed),
        (x, res, g, b), cot)
    np.testing.assert_allclose(got_o, want_o, atol=LN_TOL, rtol=LN_TOL)
    for name, gg, w in zip(("dx", "dres", "dgamma", "dbeta"), got, want):
        # dgamma/dbeta sum 64 rows: the tolerance scales with that sum
        tol = LN_GRAD_TOL * (n if name in ("dgamma", "dbeta") else 1)
        np.testing.assert_allclose(gg, w, atol=tol, rtol=LN_GRAD_TOL,
                                   err_msg=name)


def test_fused_ln_saves_stats_and_drops_like_its_plain_twin():
    """The saved y/mean/rstd reproduce out, and the dropped x is the
    card generator's mask times 1 / (1 - rate)."""
    x = torch.randn(6, 32, generator=torch.Generator().manual_seed(1))
    zeros = torch.zeros_like(x)
    out, y, mean, rstd = t_fln.fused_dropout_add_ln_fwd(
        x, zeros, torch.ones(32), torch.zeros(32), 1e-5, 0.25, 9,
        save_stats=True)
    keep = t_drop.row_keep_mask(9, 0.25, (6, 32), "cpu")
    torch.testing.assert_close(y, torch.where(keep, x / 0.75, zeros))
    torch.testing.assert_close(out, (y - mean[:, None]) * rstd[:, None])


def test_embedding_gather_bwd_matches_reference_scatter_add(interpret):
    """Duplicate ids accumulate; a negative id feeds row 0; ids >= V and
    padding_idx rows send no gradient (exact in float32: each table row
    sums at most a few float32 rows of small integers' order)."""
    rng = np.random.RandomState(9)
    v, d = 20, 128
    table = rng.randn(v, d).astype("float32")
    ids = rng.randint(0, v, (40,)).astype("int32")
    ids[:6] = [-2, v, v + 3, 5, 5, 5]
    cot = rng.randn(40, d).astype("float32")
    _, (want,) = _jvjp(
        lambda t: EMB.embedding_gather(t, jnp.asarray(ids), 5), (table,),
        cot)
    got = t_emb.embedding_gather_bwd(torch.from_numpy(cot),
                                     torch.from_numpy(ids), v, 5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert (got[5] == 0).all()
    tab = torch.from_numpy(table).requires_grad_()
    out = t_emb.embedding_gather(tab, torch.from_numpy(ids), 5)
    (g,) = torch.autograd.grad(out, tab, torch.from_numpy(cot))
    np.testing.assert_allclose(g.numpy(), want, atol=1e-6, rtol=1e-6)


# (rows, n, ids from a RandomState, padding_idx) of the backward's order
_BWD_ORDER_CASES = {
    "random": (30522, 4096, lambda rng: rng.randint(0, 30522, 4096), -1),
    "all_alike": (64, 4096, lambda rng: np.full(4096, 7), -1),
    "ragged": (40, 500, lambda rng: rng.randint(-3, 44, 500), 6),
    # more ids than a block of the kernels scans at once (csrc kChunk)
    "several_chunks": (3000, 9000, lambda rng: rng.randint(-1, 3002, 9000),
                        11),
}


@pytest.mark.parametrize("case", sorted(_BWD_ORDER_CASES))
def test_embedding_bwd_order_matches_reference_scatter_add(interpret, case):
    """The CUDA backward's order of additions, as its CPU twin
    ``embedding_gather_bwd_sorted_plain`` repeats it on ``scatter_plan``'s
    plan, against the reference's scatter-add (the vjp of
    ``embedding_gather``) and ``embedding_gather_bwd_plain``.  Tolerance:
    two float32 sums of the same L terms in any orders differ by at most
    2 L 2^-24 times the sum of the terms' magnitudes, per element."""
    rows, n, make, pad = _BWD_ORDER_CASES[case]
    rng = np.random.RandomState(5)
    ids = make(rng).astype("int32")
    d = 24
    cot = rng.randn(n, d).astype("float32")
    _, (want,) = _jvjp(
        lambda t: EMB.embedding_gather(t, jnp.asarray(ids), pad),
        (np.zeros((rows, d), "float32"),), cot)
    tids = torch.from_numpy(ids)
    got = t_emb.embedding_gather_bwd_sorted_plain(
        torch.from_numpy(cot), t_emb.scatter_plan(tids, rows, pad),
        rows).numpy()
    plain = t_emb.embedding_gather_bwd_plain(torch.from_numpy(cot), tids,
                                             rows, pad).numpy()
    kept = (ids < rows) & (ids != pad)
    where = np.clip(ids, 0, None)[kept]
    count = np.bincount(where, minlength=rows)[:, None]
    mags = np.zeros((rows, d), "float64")
    np.add.at(mags, where, np.abs(cot[kept]))
    bound = 2 * count * 2.0 ** -24 * mags
    assert np.all(np.abs(got - want) <= bound)
    assert np.all(np.abs(got - plain) <= bound)
    assert (got[count[:, 0] == 0] == 0).all()


def _bn_act_inputs(seed, r, c):
    rng = np.random.RandomState(seed)
    y = rng.randn(r, c).astype("float32")
    params = [(1 + 0.1 * rng.randn(c)).astype("float32"),
              (0.1 * rng.randn(c)).astype("float32"),
              (0.1 * rng.randn(c)).astype("float32"),
              (1 + 0.1 * rng.rand(c)).astype("float32")]
    return y, params, rng.randn(r, c).astype("float32")


@pytest.mark.parametrize("act", ["identity", "relu"])
def test_bn_act_epilogue_matches_pallas_kernel_in_bfloat16(interpret, act):
    """bfloat16 y: the output and dy in bfloat16, the four sums in
    float32, against the reference's K4 in interpret mode.  Both compute
    in float32 and round once at the end; the reference's contracted
    multiply-add can land one bfloat16 unit apart on a rounding boundary,
    so outputs are held to one unit (2**-7 relative) at the largest."""
    y, params, cot = _bn_act_inputs(10, 64, 256)
    yb = jnp.asarray(y).astype(jnp.bfloat16)
    want, vjp = jax.vjp(lambda a: CBA.bn_act_epilogue(a, *params, act=act),
                        yb)
    (want_dy,) = vjp(jnp.asarray(cot).astype(jnp.bfloat16))
    yt = torch.from_numpy(y).to(torch.bfloat16)
    pt = [torch.from_numpy(p) for p in params]
    got = t_cba.bn_act_epilogue_fwd(yt, *pt, act=act)
    grads = t_cba.bn_act_epilogue_bwd(
        torch.from_numpy(cot).to(torch.bfloat16), yt, *pt, act=act)
    assert got.dtype == grads[0].dtype == torch.bfloat16
    for g, w in ((got, want), (grads[0], want_dy)):
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=2.0 ** -7 * np.abs(w).max())
    # the sums against jax.vjp through the parameters, in float32
    _, pvjp = jax.vjp(lambda *p: CBA.bn_act_epilogue(yb, *p, act=act),
                      *params)
    want_sums = pvjp(jnp.asarray(cot).astype(jnp.bfloat16))
    for g, w in zip(grads[1:], want_sums):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("act", ["identity", "relu"])
def test_bn_act_epilogue_bwd_formulas_match_autograd(act):
    """The plain backward's explicit formulas (those the CUDA kernel
    computes) against autograd through the plain forward, float32."""
    y, params, cot = _bn_act_inputs(11, 96, 72)
    ts = [torch.from_numpy(a).requires_grad_() for a in [y] + params]
    out = t_cba.bn_act_epilogue_fwd_plain(*ts, act=act)
    want = torch.autograd.grad(out, ts, torch.from_numpy(cot))
    got = t_cba.bn_act_epilogue_bwd_plain(torch.from_numpy(cot),
                                          *[t.detach() for t in ts],
                                          act=act)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_bn_act_epilogue_runs_plain_on_cpu_without_counting():
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    reset_launch_counts()
    y, params, cot = _bn_act_inputs(12, 8, 64)
    pt = [torch.from_numpy(p) for p in params]
    yt = torch.from_numpy(y)
    out = t_cba.bn_act_epilogue_fwd(yt, *pt, act="relu")
    torch.testing.assert_close(
        out, t_cba.bn_act_epilogue_fwd_plain(yt, *pt, act="relu"),
        rtol=0, atol=0)
    t_cba.bn_act_epilogue_bwd(torch.from_numpy(cot), yt, *pt, act="relu")
    assert launch_counts()["bn_act_epilogue_fwd"] == 0
    assert launch_counts()["bn_act_epilogue_bwd"] == 0


def test_bn_act_epilogue_wrappers_check_inputs():
    y = torch.zeros(4, 8)
    ok = [torch.ones(8)] * 4
    with pytest.raises(ValueError, match="act"):
        t_cba.bn_act_epilogue_fwd(y, *ok, act="gelu")
    with pytest.raises(ValueError, match=r"\[R, C\]"):
        t_cba.bn_act_epilogue_fwd(torch.zeros(2, 4, 8), *ok)
    with pytest.raises(ValueError, match="float32"):
        t_cba.bn_act_epilogue_fwd(y, torch.ones(8, dtype=torch.float64),
                                  *ok[1:])
    with pytest.raises(ValueError, match="float32"):
        t_cba.bn_act_epilogue_fwd(y, torch.ones(7), *ok[1:])
    with pytest.raises(ValueError, match="like y"):
        t_cba.bn_act_epilogue_bwd(torch.zeros(4, 9), y, *ok)
