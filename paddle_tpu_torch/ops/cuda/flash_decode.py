"""Flash decode: single-query attention against the ring KV cache, a
hand-written CUDA kernel for Hopper (``csrc/flash_decode.cu``) and its
plain PyTorch version.

Replaces the Pallas TPU kernel of ``paddle_tpu/ops/pallas/flash_decode.py``
(``_flash_decode_call`` :172, ``pallas_call`` :178, body ``_decode_kernel``
:121-169, wrapper ``flash_decode`` :202).  One query row per (sequence,
head) attends to the first ``length`` rows of its ``[Tmax, Dh]`` cache:
f32 scores, online softmax, the keys past the length never read, and a
row of length 0 gives zeros, not NaN.

:func:`flash_decode` takes the reference's public layout (q ``[B, H, Dh]``,
k/v ``[B, H, Tmax, Dh]``, lengths a scalar or ``[B]``).  It launches the
kernel for CUDA tensors (or raises) and runs :func:`flash_decode_plain`,
the mirror of the reference's oracle ``decode_reference`` (:95-118), for
CPU tensors and for ``meta`` tensors during shape inference.  The kernel
has no engagement threshold: the reference's ``decode_min_t`` and block
autotune are TPU launch heuristics and are not ported.
"""

import math

import torch

from . import _lib

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
KERNEL = "flash_decode_fwd"


def norm_lengths(lengths, batch, device):
    """Valid-entry counts as an int32 ``[batch]`` tensor (a scalar or
    one-element count broadcasts: every row shares the cursor)."""
    lengths = torch.as_tensor(lengths, device=device).to(torch.int32)
    if lengths.numel() == 1 and batch != 1:
        lengths = lengths.reshape(()).expand(batch)
    return lengths.reshape(batch)


def flash_decode_plain(q, k, v, lengths, sm_scale=None):
    """``decode_reference``: q [B,H,D], k/v [B,H,T,D] (positions >=
    length are garbage), lengths scalar or [B] → [B,H,D] in q's dtype.
    f32 masked softmax; the normalised p is rounded to v's dtype before
    the f32 PV product."""
    b, _h, d = q.shape
    t = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    lengths = norm_lengths(lengths, b, q.device)
    s = torch.einsum("bhd,bhtd->bht", q.float(), k.float()) * sm_scale
    mask = torch.arange(t, device=q.device)[None, None, :] \
        < lengths[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)  # empty → zeros
    p = (p / l).to(v.dtype)
    return torch.einsum("bht,bhtd->bhd", p.float(), v.float()).to(q.dtype)


def check_operands(kernel, q, caches):
    """Device, dtype, head-dim and contiguity checks of a decode launch;
    returns the dtype code."""
    for name, t in (("q", q),) + tuple(caches):
        if t.device != q.device:
            raise ValueError("%s: %s lies on %s, q on %s"
                             % (kernel, name, t.device, q.device))
        if t.dtype != q.dtype:
            raise TypeError("%s: %s is %s, q is %s"
                            % (kernel, name, t.dtype, q.dtype))
        if not t.is_contiguous():
            raise ValueError("%s: %s must be contiguous" % (kernel, name))
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError("%s kernel takes head dims %s, got %d"
                         % (kernel, HEAD_DIMS, q.shape[-1]))
    return _lib.dtype_code(q, kernel)


def flash_decode(q, k, v, lengths, sm_scale=None):
    """Single-step decode attention (the reference's ``flash_decode``):
    q [B, H, D], k/v [B, H, Tmax, D], lengths scalar or [B] → [B, H, D].
    CUDA tensors launch the kernel; CPU and meta tensors run the plain
    version."""
    b, h, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.device.type != "cuda":
        return flash_decode_plain(q, k, v, lengths, sm_scale)
    if b * h == 0 or k.dim() != 4 or k.shape != v.shape \
            or tuple(k.shape[:2]) != (b, h) or k.shape[3] != d \
            or k.shape[2] == 0:
        raise ValueError("%s: q %s, k %s, v %s do not fit [B, H, D] / "
                         "[B, H, Tmax, D]" % (KERNEL, tuple(q.shape),
                                              tuple(k.shape), tuple(v.shape)))
    q = q.contiguous()
    code = check_operands(KERNEL, q, (("k", k), ("v", v)))
    lens = norm_lengths(lengths, b, q.device).repeat_interleave(h)
    lens = lens.contiguous()
    o = torch.empty_like(q)
    err = _lib.lib().pt_flash_decode_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        o.data_ptr(), b * h, k.shape[2], d, float(sm_scale), code,
        _lib.stream_handle(q.device))
    _lib.check(err, KERNEL)
    _lib.count_launch(KERNEL)
    return o
