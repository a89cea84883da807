"""The arithmetic of the flash-attention forward kernel, on the CPU.

``csrc/flash_attention.cu`` runs both float32 products of the forward
(S = Q K^T and O = P V) on the tensor cores as 3xTF32, with the backward
kernels' split: each operand x is split into big = x with its low 13 bits
cleared and small = x - big, and a product is small*big + big*small +
big*big accumulated in float32.  These tests emulate the two products in
PyTorch inside the port's plain forward, ``flash_attention_fwd_plain``,
whose two ``torch.matmul`` calls are exactly S and PV, and hold o and the
saved statistics m and l against float64 and against the reference's
Pallas forward in interpret mode.  The split helpers are
``tests/test_torch_flash_bwd.py``'s.  3xTF32 stays within
``chip_smoke.py``'s float32 tolerance (1e-4 of the largest |ref|);
single-pass TF32 does not (measured here: ~6e-4 for o, ~1.3e-3 absolute
for m), which is why the forward splits too.  The CUDA kernel itself is
held against the plain version on the card by ``chip_smoke.py``.
"""

import functools
import importlib

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_flash_bwd import (F32_TOL, _MATMUL, _inputs, matmul_1xtf32,
                                  matmul_3xtf32, split_kernel, split_rna)

FA = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

from paddle_tpu_torch.ops.cuda import flash_attention as t_fa  # noqa: E402

# chip_smoke.py's tolerance for the saved row max m: absolute, since m
# carries the scores' own scale (kernel_flash's check)
M_TOL = 1e-3
# the reference's blocked Pallas forward against the emulated kernel
# arithmetic: float32 sums in another order on both sides
# (tests/test_torch_kernels.py's FLASH_TOL; l as its saved-l check)
FLASH_TOL = 2e-5
L_ATOL = 1e-4
DROP_SEED = 1234
ARITHMETIC = {"f32": _MATMUL,
              "3xtf32 kernel": matmul_3xtf32(split_kernel),
              "3xtf32 rna": matmul_3xtf32(split_rna),
              "1xtf32": matmul_1xtf32}


def _float64_fwd(q, k, v, bias, scale, causal):
    """o, m, l of softmax(q k^T * scale + bias) v in float64."""
    qd, kd, vd, bd = (torch.from_numpy(x).double() for x in (q, k, v, bias))
    heads = q.shape[0] // bias.shape[0]
    s = _MATMUL(qd, kd.transpose(1, 2)) * scale \
        + bd.repeat_interleave(heads, dim=0)[:, None, :]
    if causal:
        t = q.shape[1]
        s = s.masked_fill(torch.ones(t, t, dtype=torch.bool).triu(1),
                          float("-inf"))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    return _MATMUL(p, vd) / l[..., None], m, l


def _plain_fwd(q, k, v, bias, scale, causal, matmul, rate=0.0, seed=None):
    """The port's plain forward with its two products computed by
    ``matmul``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "matmul", matmul)
        return t_fa.flash_attention_fwd_plain(
            *(torch.from_numpy(x) for x in (q, k, v, bias)), causal=causal,
            sm_scale=scale, dropout_rate=rate, dropout_seed=seed)


@functools.lru_cache(maxsize=None)
def _errors(causal):
    """For each arithmetic: max |o - ref| / max |ref|, max |m - ref| and
    max |l / ref - 1| at B*H = 8, T = 512, Dh = 64 with padded keys."""
    q, k, v, _, bias = _inputs(3, 8, 512, 64)
    scale = 64 ** -0.5
    ref = _float64_fwd(q, k, v, bias, scale, causal)
    out = {}
    for name, mm in ARITHMETIC.items():
        o, m, l = _plain_fwd(q, k, v, bias, scale, causal, mm)
        out[name] = (float((o.double() - ref[0]).abs().max()
                           / ref[0].abs().max()),
                     float((m.double() - ref[1]).abs().max()),
                     float((l.double() / ref[2] - 1).abs().max()))
    return out


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("split", ["kernel", "rna"])
def test_3xtf32_forward_within_float32_tolerance(causal, split):
    errs = _errors(causal)
    o, m, l = errs["3xtf32 " + split]
    assert o <= F32_TOL and l <= F32_TOL and m <= M_TOL, errs
    # near the float32 products' own error: the truncated split leaves
    # ~2^-21 of each operand (float32 rounds at 2^-24), so within 8x
    # (measured 1.2-2.4x for o, 1.0-1.5x for m and l)
    f_o, f_m, f_l = errs["f32"]
    assert o <= 8 * f_o and m <= 8 * f_m and l <= 8 * f_l, errs


@pytest.mark.parametrize("causal", [False, True])
def test_single_pass_tf32_forward_misses_float32_tolerance(causal):
    """TF32 alone keeps 10 mantissa bits: o misses the float32 tolerance
    by ~6x and m the absolute 1e-3 (measured 6.0-6.4e-4 and 1.3-1.5e-3),
    so the kernel cannot drop the split."""
    o, m, _ = _errors(causal)["1xtf32"]
    assert o > F32_TOL and m > M_TOL, _errors(causal)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_forward_matches_pallas_kernel(monkeypatch, causal, rate):
    """o, m and l of the emulated kernel arithmetic against the
    reference's Pallas forward in interpret mode, padded keys, at rate 0.1
    with the reference's debug-hash mask on both sides."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")
    monkeypatch.setenv("PADDLE_TPU_FLASH_DROPOUT_DEBUG", "iota")
    q, k, v, _, bias = _inputs(5, 4, 256, 64)
    scale = 64 ** -0.5
    seed = DROP_SEED if rate else None
    jseed = jnp.asarray([DROP_SEED if rate else 0], jnp.int32)
    want = FA._flash_fwd(*(jnp.asarray(x) for x in (q, k, v, bias)), jseed,
                         causal, scale, 128, 128, True, rate, bool(rate))
    got = _plain_fwd(q, k, v, bias, scale, causal,
                     ARITHMETIC["3xtf32 kernel"], rate, seed)
    for name, g, w, atol in (("o", got[0], want[0], FLASH_TOL),
                             ("m", got[1], want[1], FLASH_TOL),
                             ("l", got[2], want[2], L_ATOL)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(g.shape),
                                   atol=atol, rtol=FLASH_TOL, err_msg=name)
