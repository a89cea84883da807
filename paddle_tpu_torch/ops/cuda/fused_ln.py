"""Fused dropout + residual add + layer_norm, forward and backward:
hand-written CUDA kernels for Hopper (``csrc/fused_ln.cu``) and their
plain PyTorch versions.

Replaces the Pallas TPU kernels of ``paddle_tpu/ops/pallas/fused_ln.py``:
the forward (``_fwd_call`` :182, ``pallas_call`` :190, body
``_fwd_kernel`` :86), ``out = LN(dropout(x) + res) * gamma + beta`` over
the last axis of ``[N, D]`` rows, mean and variance in f32 by two passes
(:95-98), saving ``y = dropout(x) + res`` (x's dtype), mean and rstd for
the backward; and the backward (``_bwd_call`` :217, ``pallas_call`` :224,
body ``_bwd_kernel`` :108), which gives dx, dres, dgamma and dbeta, the
forward's dropout mask re-applied to dx.  The mask is :mod:`.dropout`'s
row form (b = 0).  gamma and beta are float32 or x's dtype: the kernels
widen them in registers, which is exact.

:func:`fused_dropout_add_ln_fwd` and :func:`fused_dropout_add_ln_bwd`
launch the kernels for CUDA tensors (or raise) and run the ``_plain``
versions for CPU and meta tensors.  :func:`fused_dropout_add_ln` is the
reference's entry, a ``torch.autograd.Function`` over the two
(``_fused_core`` :252-274) when a gradient is wanted.
"""

import torch

from . import _lib
from . import dropout as _drop

MAX_D = 4096
KERNEL = "fused_dropout_add_ln_fwd"
KERNEL_BWD = "fused_dropout_add_ln_bwd"


def _keep(x, rate, seed):
    if not rate:
        return None
    return _drop.row_keep_mask(seed, rate, tuple(x.shape), x.device)


def fused_dropout_add_ln_fwd_plain(x, residual, gamma, beta, eps=1e-5,
                                   dropout_rate=0.0, dropout_seed=None):
    """→ (out, y, mean, rstd): out and y in x's dtype, mean and rstd [N]
    float32."""
    xf = x.float()
    keep = _keep(x, dropout_rate, dropout_seed)
    if keep is not None:
        xf = torch.where(keep, xf * _drop.keep_scale(dropout_rate),
                         torch.zeros_like(xf))
    y = xf + residual.float()
    mean = y.mean(dim=-1, keepdim=True)
    var = torch.square(y - mean).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    out = (y - mean) * rstd * gamma.float() + beta.float()
    return out.to(x.dtype), y.to(x.dtype), mean[:, 0], rstd[:, 0]


def fused_dropout_add_ln_bwd_plain(dout, y, gamma, mean, rstd,
                                   dropout_rate=0.0, dropout_seed=None):
    """→ (dx, dres, dgamma, dbeta): dx and dres in y's dtype, dgamma and
    dbeta [D] float32."""
    g = dout.float()
    xhat = (y.float() - mean[:, None]) * rstd[:, None]
    dgamma = (g * xhat).sum(dim=0)
    dbeta = g.sum(dim=0)
    dxhat = g * gamma.float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dy = rstd[:, None] * (dxhat - m1 - xhat * m2)
    dx = dy
    keep = _keep(y, dropout_rate, dropout_seed)
    if keep is not None:
        dx = torch.where(keep, dy * _drop.keep_scale(dropout_rate),
                         torch.zeros_like(dy))
    return dx.to(y.dtype), dy.to(y.dtype), dgamma, dbeta


def _param_code(x, params, kernel):
    """The dtype code of gamma (and beta): float32 or x's dtype."""
    dtypes = {p.dtype for p in params}
    if len(dtypes) != 1 or not dtypes <= {torch.float32, x.dtype}:
        raise TypeError("%s: gamma/beta must be float32 or %s alike, got %s"
                        % (kernel, x.dtype, sorted(map(str, dtypes))))
    return _lib.dtype_code(params[0], kernel)


def _check_rows(kernel, tensors, n, d):
    if n == 0 or not 1 <= d <= MAX_D:
        raise ValueError("%s kernel takes non-empty rows with 1 <= D <= %d, "
                         "got [%d, %d]" % (kernel, MAX_D, n, d))
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("%s kernel needs contiguous inputs" % kernel)


def fused_dropout_add_ln_fwd(x, residual, gamma, beta, eps=1e-5,
                             dropout_rate=0.0, dropout_seed=None,
                             save_stats=False):
    """x, residual [N, D]; gamma, beta [D] float32 or x's dtype → out
    [N, D] in x's dtype, or (out, y, mean, rstd) with ``save_stats``.
    CUDA tensors launch the kernel; CPU and meta tensors run the plain
    version."""
    rate = _drop.check_rate(dropout_rate, dropout_seed)
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
        res = fused_dropout_add_ln_fwd_plain(x, residual, gamma, beta, eps,
                                             rate, dropout_seed)
        return res if save_stats else res[0]
    code = _lib.dtype_code(x, KERNEL)
    if residual.dtype != x.dtype:
        raise TypeError("residual dtype %s != x dtype %s"
                        % (residual.dtype, x.dtype))
    pcode = _param_code(x, (gamma, beta), KERNEL)
    _check_rows(KERNEL, (x, residual, gamma, beta), n, d)
    out = torch.empty_like(x)
    y = mean = rstd = None
    if save_stats:
        y = torch.empty_like(x)
        mean = torch.empty((n,), dtype=torch.float32, device=x.device)
        rstd = torch.empty((n,), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _lib.lib().pt_fused_add_ln_fwd(
        x.data_ptr(), residual.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        out.data_ptr(), ptr(y), ptr(mean), ptr(rstd), n, d, float(eps),
        *_drop.kernel_args(rate, dropout_seed), code, pcode,
        _lib.stream_handle(x.device))
    _lib.check(err, KERNEL)
    _lib.count_launch(KERNEL)
    return (out, y, mean, rstd) if save_stats else out


def fused_dropout_add_ln_bwd(dout, y, gamma, mean, rstd, dropout_rate=0.0,
                             dropout_seed=None):
    """Gradients (dx, dres, dgamma, dbeta) from the forward's saved y,
    mean and rstd.  CUDA tensors launch the backward kernel (a row kernel
    on a grid sized to fill the card, writing per-block dgamma/dbeta
    partials, then their fixed-order sum); CPU tensors run the plain
    version."""
    rate = _drop.check_rate(dropout_rate, dropout_seed)
    if y.device.type != "cuda":
        return fused_dropout_add_ln_bwd_plain(dout, y, gamma, mean, rstd,
                                              rate, dropout_seed)
    n, d = y.shape
    if dout.shape != y.shape or dout.dtype != y.dtype:
        raise ValueError("dout %s %s must be like y %s %s"
                         % (tuple(dout.shape), dout.dtype, tuple(y.shape),
                            y.dtype))
    code = _lib.dtype_code(y, KERNEL_BWD)
    pcode = _param_code(y, (gamma,), KERNEL_BWD)
    dout = dout.contiguous()
    _check_rows(KERNEL_BWD, (dout, y, gamma, mean, rstd), n, d)
    lib = _lib.lib()
    blocks = lib.pt_fused_add_ln_bwd_blocks(n, d, code)
    if blocks < 1:  # a negated cudaError_t
        raise RuntimeError("CUDA kernel %s: sizing its grid failed: "
                           "cudaError %d" % (KERNEL_BWD, -blocks))
    dx = torch.empty_like(y)
    dres = torch.empty_like(y)
    parts = torch.empty((2, blocks, d), dtype=torch.float32, device=y.device)
    dgamma = torch.empty((d,), dtype=torch.float32, device=y.device)
    dbeta = torch.empty((d,), dtype=torch.float32, device=y.device)
    err = lib.pt_fused_add_ln_bwd(
        dout.data_ptr(), y.data_ptr(), gamma.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), dx.data_ptr(), dres.data_ptr(), parts[0].data_ptr(),
        parts[1].data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), n, d,
        blocks, *_drop.kernel_args(rate, dropout_seed), code, pcode,
        _lib.stream_handle(y.device))
    _lib.check(err, KERNEL_BWD)
    _lib.count_launch(KERNEL_BWD)
    return dx, dres, dgamma, dbeta


class _FusedDropoutAddLN(torch.autograd.Function):
    """``_fused_core`` with its custom vjp (:252-274)."""

    @staticmethod
    def forward(ctx, x, residual, gamma, beta, eps, rate, seed):
        out, y, mean, rstd = fused_dropout_add_ln_fwd(
            x, residual, gamma, beta, eps, rate, seed, save_stats=True)
        ctx.save_for_backward(y, gamma, mean, rstd)
        ctx.args = (rate, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        y, gamma, mean, rstd = ctx.saved_tensors
        dx, dres, dg, db = fused_dropout_add_ln_bwd(dout, y, gamma, mean,
                                                    rstd, *ctx.args)
        return dx, dres, dg.to(gamma.dtype), db.to(gamma.dtype), None, None, \
            None


def fused_dropout_add_ln(x, residual, gamma, beta, dropout_rate=0.0,
                         eps=1e-5, seed=None):
    """``layer_norm(residual + dropout(x)) * gamma + beta`` over the last
    axis of ``[N, D]`` rows (the reference's entry).  When a gradient is
    wanted it goes through the autograd function, whose forward saves y,
    mean and rstd; otherwise only ``out`` is written.  gamma and beta in
    x's dtype (the AMP rewrite casts every float input of the op to bf16)
    go to the kernels as they are, which widen them exactly, as the
    reference's kernel body reads them; their gradients are summed in
    float32 and rounded to bf16 once, as the reference's vjp rounds them.
    gamma and beta of another dtype are widened to float32 first."""
    rate = _drop.check_rate(dropout_rate, seed)
    if gamma.dtype != beta.dtype \
            or gamma.dtype not in (torch.float32, x.dtype):
        gamma, beta = gamma.float(), beta.float()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, residual, gamma, beta)):
        return _FusedDropoutAddLN.apply(x, residual, gamma, beta, float(eps),
                                        rate, seed)
    return fused_dropout_add_ln_fwd(x, residual, gamma, beta, eps, rate, seed)
