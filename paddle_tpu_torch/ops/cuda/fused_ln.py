"""Fused residual-add + layer_norm forward: a hand-written CUDA kernel for
Hopper (``csrc/fused_ln.cu``) and its plain PyTorch version.

Replaces the Pallas TPU kernel ``paddle_tpu/ops/pallas/fused_ln.py``
(``_fwd_call`` at :182, ``pallas_call`` at :190, body ``_fwd_kernel`` at
:86):
``out = LN(x + res) * gamma + beta`` over the last axis of ``[N, D]``
rows, mean and variance in f32 by two passes (``fused_ln.py:95-98``).
The forward-only serving path writes ``out`` alone; saving ``y``, mean
and rstd, and dropout inside the kernel, come with the backward of the
training slice — a rate > 0 raises here.

:func:`fused_dropout_add_ln_fwd` launches the kernel for CUDA tensors
(or raises) and runs :func:`fused_dropout_add_ln_fwd_plain` for CPU and
meta tensors.
"""

import torch

from . import _lib

MAX_D = 4096
KERNEL = "fused_dropout_add_ln_fwd"


def fused_dropout_add_ln_fwd_plain(x, residual, gamma, beta, eps=1e-5):
    y = x.float() + residual.float()
    mean = y.mean(dim=-1, keepdim=True)
    var = torch.square(y - mean).mean(dim=-1, keepdim=True)
    out = (y - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return out.to(x.dtype)


def fused_dropout_add_ln_fwd(x, residual, gamma, beta, eps=1e-5,
                             dropout_rate=0.0):
    """x, residual [N, D]; gamma, beta [D] float32 → out [N, D] in x's
    dtype.  CUDA tensors launch the kernel; CPU and meta tensors run the
    plain version."""
    if dropout_rate:
        raise NotImplementedError(
            "dropout inside the fused LN kernel comes with the training "
            "slice (ROADMAP.md, K2 backward); serving runs at rate 0")
    if x.dim() != 2 or residual.shape != x.shape:
        raise ValueError("x and residual must be the same [N, D], got %s / %s"
                         % (tuple(x.shape), tuple(residual.shape)))
    n, d = x.shape
    if gamma.shape != (d,) or beta.shape != (d,):
        raise ValueError("gamma/beta must be [%d]" % d)
    devs = {t.device for t in (x, residual, gamma, beta)}
    if len(devs) != 1:
        raise ValueError("inputs lie on different devices: %s" % devs)
    if x.device.type != "cuda":
        return fused_dropout_add_ln_fwd_plain(x, residual, gamma, beta, eps)
    code = _lib.dtype_code(x, KERNEL)
    if residual.dtype != x.dtype:
        raise TypeError("residual dtype %s != x dtype %s"
                        % (residual.dtype, x.dtype))
    if gamma.dtype != torch.float32 or beta.dtype != torch.float32:
        raise TypeError("gamma/beta must be float32")
    if n == 0 or not 1 <= d <= MAX_D:
        raise ValueError("fused LN kernel takes non-empty rows with "
                         "1 <= D <= %d, got %s" % (MAX_D, tuple(x.shape)))
    for t in (x, residual, gamma, beta):
        if not t.is_contiguous():
            raise ValueError("fused LN kernel needs contiguous inputs")
    out = torch.empty_like(x)
    err = _lib.lib().pt_fused_add_ln_fwd(
        x.data_ptr(), residual.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        out.data_ptr(), n, d, float(eps), code, _lib.stream_handle(x.device))
    _lib.check(err, KERNEL)
    _lib.count_launch(KERNEL)
    return out
