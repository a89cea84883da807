"""The arithmetic of the flash-attention backward kernels, on the CPU.

``csrc/flash_attention_bwd.cu`` runs every float32 product of the
backward (S = Q K^T, dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K) on
the tensor cores as 3xTF32: each operand x is split into a TF32 big part
and a small part, and a product is small*big + big*small + big*big
accumulated in float32.  The kernel's split (``split_kernel``) clears
x's low 13 bits for big (x truncated to TF32) and takes small = x - big,
which the MMA reads truncated to TF32 in turn; the textbook split
(``split_rna``) rounds both with ``cvt.rna.tf32.f32`` (add 0x1000 to the
int32 view and clear the low 13 bits).  These tests emulate the products
in PyTorch inside the port's plain backward, ``flash_attention_bwd_plain``,
whose ``torch.matmul`` calls are exactly those five products, and hold
the result against float64: 3xTF32 with either split stays within
``chip_smoke.py``'s float32 tolerance (1e-4 of the largest |ref|),
single-pass TF32 does not.  That is why the kernels split.  The CUDA
kernels themselves are held against the plain version on the card by
``chip_smoke.py``.
"""

import functools
import importlib

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

FA = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

from paddle_tpu_torch.ops.cuda import flash_attention as t_fa  # noqa: E402

# chip_smoke.py's float32 tolerance for the backward kernels (``_tol``)
F32_TOL = 1e-4
# float32 gradients against the reference's blocked kernels
# (tests/test_torch_kernels.py's FLASH_GRAD_TOL)
FLASH_GRAD_TOL = 1e-4
_MATMUL = torch.matmul


def tf32(x):
    """``cvt.rna.tf32.f32``: x rounded to 10 mantissa bits, ties away
    from zero, as a float32 tensor."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x):
    """x with its low 13 bits cleared: what a TF32 MMA reads of a float32
    register."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_rna(x):
    big = tf32(x)
    return big, tf32(x - big)


def split_kernel(x):
    """The kernel's split: big truncated, small = x - big exactly, read by
    the MMA truncated."""
    big = tf32_trunc(x)
    return big, tf32_trunc(x - big)


SPLITS = {"kernel": split_kernel, "rna": split_rna}


def matmul_3xtf32(split):
    def mm(a, b):
        (ab, as_), (bb, bs) = split(a), split(b)
        return (_MATMUL(as_, bb) + _MATMUL(ab, bs)) + _MATMUL(ab, bb)
    return mm


def matmul_1xtf32(a, b):
    return _MATMUL(tf32(a), tf32(b))


def _inputs(seed, bh, t, dh):
    """q, k, v, dO [bh, t, dh] and a padded-key bias [bh / 4, t]
    (chip_smoke.py's ``_flash_inputs``: row i drops its last (37 i) mod
    (t / 2) keys)."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(bh, t, dh).astype("float32") for _ in range(4))
    bias = np.zeros((bh // 4, t), "float32")
    for i in range(bh // 4):
        n_pad = (i * 37) % (t // 2)
        if n_pad:
            bias[i, t - n_pad:] = -1e4
    return q, k, v, do, bias


def _float64_grads(q, k, v, do, bias, scale):
    qd, kd, vd = (torch.from_numpy(x).double().requires_grad_()
                  for x in (q, k, v))
    heads = q.shape[0] // bias.shape[0]
    s = _MATMUL(qd, kd.transpose(1, 2)) * scale + torch.from_numpy(
        bias).double().repeat_interleave(heads, dim=0)[:, None, :]
    o = _MATMUL(torch.softmax(s, dim=-1), vd)
    return torch.autograd.grad(o, (qd, kd, vd), torch.from_numpy(do).double())


def _plain_bwd(q, k, v, do, bias, scale, matmul):
    """The port's plain backward with its products computed by
    ``matmul``; the forward's o, m, l are float32 as the kernel saves
    them."""
    qt, kt, vt, dot, bt = (torch.from_numpy(x) for x in (q, k, v, do, bias))
    o, m, l = t_fa.flash_attention_fwd(qt, kt, vt, bt, sm_scale=scale)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "matmul", matmul)
        return t_fa.flash_attention_bwd(qt, kt, vt, bt, o, m, l, dot,
                                        sm_scale=scale)


@functools.lru_cache(maxsize=None)
def _relative_errors():
    """max |got - ref| / max |ref| of (dq, dk, dv) for each arithmetic, at
    B*H = 8, T = 512, Dh = 64 with padded keys."""
    q, k, v, do, bias = _inputs(3, 8, 512, 64)
    scale = 64 ** -0.5
    ref = _float64_grads(q, k, v, do, bias, scale)
    out = {}
    for name, mm in (("f32", _MATMUL),
                     ("3xtf32 kernel", matmul_3xtf32(split_kernel)),
                     ("3xtf32 rna", matmul_3xtf32(split_rna)),
                     ("1xtf32", matmul_1xtf32)):
        got = _plain_bwd(q, k, v, do, bias, scale, mm)
        out[name] = tuple(float((g.double() - r).abs().max() / r.abs().max())
                          for g, r in zip(got, ref))
    return out


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one + 2 ** -11, one + 2 ** -12, -(one + 2 ** -11),
                      one + 3 * 2 ** -11, 0.0, -0.0, 3.0e-39])
    want = torch.tensor([one + 2 ** -10, one, -(one + 2 ** -10),
                         one + 2 * 2 ** -10, 0.0, -0.0, tf32(x)[-1]])
    assert torch.equal(tf32(x), want)
    # 10 explicit mantissa bits: the low 13 of the float32 view are clear
    r = tf32(torch.randn(1000, generator=torch.Generator().manual_seed(0)))
    assert int((r.view(torch.int32) & 0x1FFF).abs().max()) == 0


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_split_keeps_float32_precision(split):
    x = torch.randn(4096, generator=torch.Generator().manual_seed(1))
    big, small = SPLITS[split](x)
    assert torch.equal(tf32_trunc(big), big)
    assert torch.equal(tf32_trunc(small), small)
    # big carries 11 significant bits, small the next 11: ~2^-21 left over
    assert float(((big + small) - x).abs().max()
                 / x.abs().max()) <= 2.0 ** -20


@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("i, grad", [(0, "dq"), (1, "dk"), (2, "dv")])
def test_3xtf32_backward_within_float32_tolerance(split, i, grad):
    errs = _relative_errors()
    got = errs["3xtf32 " + split][i]
    assert got <= F32_TOL, (grad, errs)
    # near the float32 products' own error: the truncated split leaves
    # ~2^-21 of each operand (float32 rounds at 2^-24), so within 8x
    assert got <= 8 * errs["f32"][i], (grad, errs)


@pytest.mark.parametrize("i, grad", [(0, "dq"), (1, "dk"), (2, "dv")])
def test_single_pass_tf32_misses_float32_tolerance(i, grad):
    errs = _relative_errors()
    assert errs["1xtf32"][i] > F32_TOL, (grad, errs)


@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_backward_matches_pallas_kernel(monkeypatch, causal):
    """The emulated kernel arithmetic (its split) against ``jax.vjp`` of the
    reference's Pallas kernels in interpret mode, at a small size."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")
    q, k, v, do, bias = _inputs(5, 4, 128, 64)
    scale = 64 ** -0.5
    shape = (1, 4, 128, 64)
    _, vjp = jax.vjp(
        lambda a, b, c: FA.flash_attention(a, b, c, bias=jnp.asarray(bias),
                                           causal=causal, sm_scale=scale),
        *(jnp.asarray(x.reshape(shape)) for x in (q, k, v)))
    want = vjp(jnp.asarray(do.reshape(shape)))
    qt, kt, vt, dot, bt = (torch.from_numpy(x) for x in (q, k, v, do, bias))
    o, m, l = t_fa.flash_attention_fwd(qt, kt, vt, bt, causal=causal,
                                       sm_scale=scale)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "matmul", matmul_3xtf32(split_kernel))
        got = t_fa.flash_attention_bwd(qt, kt, vt, bt, o, m, l, dot,
                                       causal=causal, sm_scale=scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(g.shape),
                                   atol=FLASH_GRAD_TOL, rtol=FLASH_GRAD_TOL,
                                   err_msg=name)
