"""Fused BatchNorm + activation epilogue over a channels-last conv output,
forward and backward: hand-written CUDA kernels for Hopper
(``csrc/conv_bn_act.cu``) and their plain PyTorch versions.

Replaces the Pallas TPU kernels of ``paddle_tpu/ops/pallas/conv_bn_act.py``:
the forward (``_fwd_call`` :148, ``pallas_call`` :153, body ``_fwd_kernel``
:102), ``act((y - mean) * rstd * gamma + beta)`` over the ``[R, C]`` view
of an NHWC conv output, cast to y's dtype before the act; and the backward
(``_bwd_call`` :170, ``pallas_call`` :175, body ``_bwd_kernel`` :112,
custom vjp :206-226), which gives dy and the per-channel dgamma, dbeta,
dmean and drstd, with the relu mask recomputed from ``xhat * g + b > 0``.
mean and rstd are inputs: the caller owns the batch statistics, and
autograd carries dmean/drstd through them to the conv output
(:28-30).

Eligibility differs from the reference's on purpose: its ``C % 128 ==
0``, ``C <= 4096`` and ``R % 8 == 0`` (:86) are the TPU's lane and
sublane tiling, which a CUDA kernel does not have.  These kernels take
any channels-last site with act identity or relu, the 64-channel outputs
of ResNet's stem and first stage included.

:func:`bn_act_epilogue_fwd` and :func:`bn_act_epilogue_bwd` launch the
kernels for CUDA tensors (or raise) and run the ``_plain`` versions for
CPU and meta tensors.  :func:`bn_act_epilogue` is the reference's entry,
a ``torch.autograd.Function`` over the two when a gradient is wanted.
"""

import torch

from . import _lib

KERNEL = "bn_act_epilogue_fwd"
KERNEL_BWD = "bn_act_epilogue_bwd"
ACTS = ("identity", "relu")


def bn_act_epilogue_fwd_plain(y, gamma, beta, mean, rstd, act="identity"):
    """The reference's composite (``ops/nn.py:656-666``): the unfused
    batch_norm's float sequence, the cast, then the act."""
    h = (y.float() - mean) * rstd
    h = h * gamma.float() + beta.float()
    out = h.to(y.dtype)
    return torch.relu(out) if act == "relu" else out


def bn_act_epilogue_bwd_plain(dout, y, gamma, beta, mean, rstd,
                              act="identity"):
    """→ (dy, dgamma, dbeta, dmean, drstd): dy in y's dtype, the rest [C]
    float32, by the TPU kernel's formulas."""
    d = dout.float()
    g = gamma.float()
    cen = y.float() - mean
    xhat = cen * rstd
    if act == "relu":
        s = xhat * g + beta.float()
        d = torch.where(s > 0, d, torch.zeros_like(d))
    dy = d * (g * rstd)
    return (dy.to(y.dtype), (d * xhat).sum(dim=0), d.sum(dim=0),
            -dy.sum(dim=0), (d * g * cen).sum(dim=0))


def _check(kernel, y, params, act):
    if act not in ACTS:
        raise ValueError("%s takes act in %s, got %r" % (kernel, ACTS, act))
    if y.dim() != 2 or y.shape[0] == 0 or y.shape[1] == 0:
        raise ValueError("%s takes a non-empty [R, C] view, got %s"
                         % (kernel, tuple(y.shape)))
    c = y.shape[1]
    for t in params:
        if t.shape != (c,) or t.dtype != torch.float32:
            raise ValueError("%s takes [%d] float32 gamma/beta/mean/rstd, "
                             "got %s %s" % (kernel, c, tuple(t.shape),
                                            t.dtype))
    devs = {t.device for t in (y,) + tuple(params)}
    if len(devs) != 1:
        raise ValueError("inputs lie on different devices: %s" % devs)


def _need_contiguous(kernel, tensors):
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("%s kernel needs contiguous inputs" % kernel)


def bn_act_epilogue_fwd(y, gamma, beta, mean, rstd, act="identity"):
    """y [R, C] float32 or bfloat16; gamma, beta, mean, rstd [C] float32
    → out [R, C] in y's dtype.  CUDA tensors launch the kernel; CPU and
    meta tensors run the plain version."""
    params = (gamma, beta, mean, rstd)
    _check(KERNEL, y, params, act)
    if y.device.type != "cuda":
        return bn_act_epilogue_fwd_plain(y, gamma, beta, mean, rstd, act)
    code = _lib.dtype_code(y, KERNEL)
    _need_contiguous(KERNEL, (y,) + params)
    r, c = y.shape
    out = torch.empty_like(y)
    err = _lib.lib().pt_bn_act_fwd(
        y.data_ptr(), gamma.data_ptr(), beta.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), out.data_ptr(), r, c, ACTS.index(act), code,
        _lib.stream_handle(y.device))
    _lib.check(err, KERNEL)
    _lib.count_launch(KERNEL)
    return out


def bn_act_epilogue_bwd(dout, y, gamma, beta, mean, rstd, act="identity"):
    """Gradients (dy, dgamma, dbeta, dmean, drstd).  CUDA tensors launch
    the backward kernel (a row-tile kernel writing per-tile partials of
    the four sums, then their fixed-order sum); CPU tensors run the plain
    version."""
    params = (gamma, beta, mean, rstd)
    _check(KERNEL_BWD, y, params, act)
    if dout.shape != y.shape or dout.dtype != y.dtype:
        raise ValueError("dout %s %s must be like y %s %s"
                         % (tuple(dout.shape), dout.dtype, tuple(y.shape),
                            y.dtype))
    if y.device.type != "cuda":
        return bn_act_epilogue_bwd_plain(dout, y, gamma, beta, mean, rstd,
                                         act)
    code = _lib.dtype_code(y, KERNEL_BWD)
    _need_contiguous(KERNEL_BWD, (dout, y) + params)
    r, c = y.shape
    lib = _lib.lib()
    tiles = lib.pt_bn_act_bwd_tiles(r, c, code)
    dy = torch.empty_like(y)
    part = torch.empty((4, tiles, c), dtype=torch.float32, device=y.device)
    sums = torch.empty((4, c), dtype=torch.float32, device=y.device)
    err = lib.pt_bn_act_bwd(
        dout.data_ptr(), y.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), dy.data_ptr(), part.data_ptr(),
        sums[0].data_ptr(), sums[1].data_ptr(), sums[2].data_ptr(),
        sums[3].data_ptr(), r, c, ACTS.index(act), code,
        _lib.stream_handle(y.device))
    _lib.check(err, KERNEL_BWD)
    _lib.count_launch(KERNEL_BWD)
    return (dy,) + tuple(sums.unbind(0))


class _BNActEpilogue(torch.autograd.Function):
    """``_epilogue_core`` with its custom vjp (:206-226)."""

    @staticmethod
    def forward(ctx, y, gamma, beta, mean, rstd, act):
        ctx.save_for_backward(y, gamma, beta, mean, rstd)
        ctx.act = act
        return bn_act_epilogue_fwd(y, gamma, beta, mean, rstd, act)

    @staticmethod
    def backward(ctx, dout):
        y, gamma, beta, mean, rstd = ctx.saved_tensors
        dy, dg, db, dm, dr = bn_act_epilogue_bwd(
            dout.contiguous(), y, gamma, beta, mean, rstd, ctx.act)
        return dy, dg, db, dm, dr, None


def bn_act_epilogue(y2d, gamma, beta, mean, rstd, act="identity"):
    """``act((y - mean) * rstd * gamma + beta)`` over a channels-last
    ``[R, C]`` view (the reference's entry).  rstd is ``rsqrt(var +
    eps)``, precomputed by the caller.  Differentiable in every tensor
    argument when a gradient is wanted."""
    gamma, beta, mean, rstd = (t.float() for t in (gamma, beta, mean, rstd))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (y2d, gamma, beta, mean, rstd)):
        return _BNActEpilogue.apply(y2d, gamma, beta, mean, rstd, act)
    return bn_act_epilogue_fwd(y2d, gamma, beta, mean, rstd, act)
