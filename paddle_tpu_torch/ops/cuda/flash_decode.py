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

The kernel splits each row's keys into chunks of :func:`kernel_chunk` and
merges the chunks' partials in chunk order inside the same launch;
:func:`flash_decode_chunked_plain` is the plain twin of that arithmetic
(tests and ``chip_smoke.py`` hold it against the reference and the
kernel; the wrappers never call it).  A launch takes a float32 workspace
from ``torch.empty`` and the per-row ticket counters of
:func:`row_counters`, which the kernel leaves at 0: no host sync, no
allocation inside the kernel.
"""

import math
import threading

import torch
import torch.nn.functional as F

from . import _lib

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
KERNEL = "flash_decode_fwd"
CHUNK_ELEMS = 8192  # K elements a block takes: kChunkElems of the kernels

# (device index, stream) → int32 ticket counters, one a row, all 0
# between launches
_COUNTERS = {}
_COUNTERS_LOCK = threading.Lock()


def norm_lengths(lengths, batch, device):
    """Valid-entry counts as an int32 ``[batch]`` tensor (a scalar or
    one-element count broadcasts: every row shares the cursor)."""
    lengths = torch.as_tensor(lengths, device=device).to(torch.int32)
    if lengths.numel() == 1 and batch != 1:
        lengths = lengths.reshape(()).expand(batch)
    return lengths.reshape(batch)


def kernel_chunk(head_dim):
    """Keys a block of the decode kernels takes at ``head_dim``: 128 at
    64, 64 at 128 (``chunk_keys`` of ``csrc/flash_decode.cu``)."""
    return CHUNK_ELEMS // head_dim


def kernel_lengths(lengths, batch, device):
    """The lengths as the kernels read them: an int32 tensor and the
    stride between sequences, 1 for a ``[batch]`` count and 0 for one
    count every sequence shares (no per-row copy is made)."""
    lengths = torch.as_tensor(lengths, device=device)
    if lengths.dtype != torch.int32:
        lengths = lengths.to(torch.int32)
    if lengths.numel() == 1:
        return lengths.reshape(1), 0
    if lengths.numel() != batch:
        raise ValueError("lengths hold %d counts for %d sequences"
                         % (lengths.numel(), batch))
    return lengths.reshape(batch).contiguous(), 1


def row_counters(device, stream, rows):
    """The ticket counters of the decode kernels launched on ``stream``
    (a handle) of ``device``: int32, at least ``rows`` of them, zeroed
    when made or grown and left at 0 by every launch."""
    key = (device.index, stream)
    with _COUNTERS_LOCK:
        buf = _COUNTERS.get(key)
        if buf is None or buf.numel() < rows:
            buf = torch.zeros(max(rows, 1024), dtype=torch.int32,
                              device=device)
            _COUNTERS[key] = buf
    return buf


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


def flash_decode_chunked_plain(q, k, v, lengths, chunk, sm_scale=None):
    """The kernel's arithmetic in plain PyTorch: q [B, H, D], k/v [B, H,
    T, D], lengths scalar or [B] → [B, H, D].  The keys are split into
    chunks of ``chunk``; each chunk's partial is its max score m_c, l_c =
    sum exp(s - m_c) and acc_c = sum p v with the unnormalised p rounded
    to v's dtype; the partials of the chunks that start below the length
    merge in chunk order: M = max m_c, L = sum l_c e^(m_c - M), o = sum
    acc_c e^(m_c - M) / L (no live chunk: zeros).  A twin for tests and
    on-card checks; the main path never calls it."""
    b, h, d = q.shape
    t = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    lengths = norm_lengths(lengths, b, q.device)
    n = -(-t // chunk)
    pad = n * chunk - t
    s = torch.einsum("bhd,bhtd->bht", q.float(), k.float()) * sm_scale
    mask = torch.arange(t, device=q.device)[None, None, :] \
        < lengths[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    s = F.pad(s, (0, pad), value=NEG_INF).reshape(b, h, n, chunk)
    mask = F.pad(mask, (0, pad), value=False).reshape(b, 1, n, chunk)
    vc = F.pad(v, (0, 0, 0, pad)).reshape(b, h, n, chunk, d).float()
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    acc = torch.einsum("bhnc,bhncd->bhnd", p.to(v.dtype).float(), vc)
    live = (torch.arange(n, device=q.device) * chunk)[None, None, :] \
        < lengths[:, None, None]
    big = torch.where(live, m, torch.full_like(m, NEG_INF)).amax(dim=-1)
    den = torch.zeros_like(big)
    num = torch.zeros_like(acc[:, :, 0])
    for c in range(n):
        w = torch.where(live[..., c], torch.exp(m[..., c] - big),
                        torch.zeros_like(big))
        den = den + l[..., c] * w
        num = num + acc[:, :, c] * w[..., None]
    den = torch.where(den == 0.0, torch.ones_like(den), den)
    return (num / den[..., None]).to(q.dtype)


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
    lens, stride = kernel_lengths(lengths, b, q.device)
    t = k.shape[2]
    o = torch.empty_like(q)
    chunk = kernel_chunk(d)
    ws = torch.empty((b * h, -(-t // chunk), d + 4), dtype=torch.float32,
                     device=q.device)
    stream = _lib.stream_handle(q.device)
    err = _lib.lib().pt_flash_decode_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        o.data_ptr(), ws.data_ptr(),
        row_counters(q.device, stream, b * h).data_ptr(), b * h, h, t, d,
        stride, chunk, float(sm_scale), code, stream)
    _lib.check(err, KERNEL)
    _lib.count_launch(KERNEL)
    return o
