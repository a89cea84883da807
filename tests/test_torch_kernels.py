"""Each kernel module of the PyTorch port against the reference package.

The same seeded numpy inputs go through the reference's Pallas kernels
(``PADDLE_TPU_PALLAS=interpret``, set through ``monkeypatch``, as the
reference's own CPU tests run them) and through the port's wrappers on
CPU tensors, where each wrapper runs its kernel's plain PyTorch version.
The CUDA kernels themselves are held against the same plain versions on
the GPU by ``chip_smoke.py``.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

FA = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
FLN = importlib.import_module("paddle_tpu.ops.pallas.fused_ln")
EMB = importlib.import_module("paddle_tpu.ops.pallas.embedding")

from paddle_tpu_torch.ops.cuda import embedding as t_emb  # noqa: E402
from paddle_tpu_torch.ops.cuda import flash_attention as t_fa  # noqa: E402
from paddle_tpu_torch.ops.cuda import fused_ln as t_fln  # noqa: E402

# float32 both sides; sums run in another order (blocked online softmax
# on the reference side, one matmul on ours)
FLASH_TOL = 2e-5
LN_TOL = 1e-5


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
    """The training slice's backward reads m and l: they match the
    reference kernel's saved statistics, bias given as [B,1,1,T]."""
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
    q = torch.zeros(2, 4, 8)
    with pytest.raises(NotImplementedError, match="training slice"):
        t_fa.flash_attention_fwd(q, q, q, dropout_rate=0.1)


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
