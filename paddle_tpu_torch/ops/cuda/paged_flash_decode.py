"""Paged flash decode: single-query attention through a block table into
a shared KV pool, a hand-written CUDA kernel for Hopper
(``csrc/flash_decode.cu``) and its plain PyTorch version.

Replaces the Pallas TPU kernel of
``paddle_tpu/ops/pallas/paged_flash_decode.py`` (``_paged_flash_decode_call``
:155, ``pallas_call`` :185, body ``_paged_decode_kernel`` :104-152,
wrapper ``paged_flash_decode`` :193).  The pool is
``[num_blocks, H, block_len, Dh]``; row ``s`` of the ``[S, MB]`` int32
table names the pool blocks that hold that sequence's cache rows
``[j*BL, (j+1)*BL)``, ``-1`` for unmapped.  The reference flattens the
heads into the table on the host (:219-222); the kernel does it itself
(block ``table[s, j]``, head ``h``), clamps ``-1`` to block 0 as
``safe_tab`` does (:166) and never reads a block that starts at or past
the length.

:func:`paged_flash_decode` launches the kernel for CUDA tensors (or
raises) and runs :func:`paged_flash_decode_plain`, the mirror of
``paged_decode_reference`` (:90-101: gather the table's blocks into the
ring layout, then the ring oracle), for CPU and ``meta`` tensors.  The
kernel shares the ring kernel's chunking, merge, workspace and counters
(``flash_decode``); :func:`paged_flash_decode_chunked_plain` is the plain
twin of its arithmetic, for tests and on-card checks only.
"""

import math

import torch

from . import _lib
from .flash_decode import (check_operands,
                           flash_decode_chunked_plain, flash_decode_plain,
                           kernel_chunk, kernel_lengths, row_counters)

DEFAULT_BLOCK_LEN = 16   # the reference's hand-set default (:51)
KERNEL = "paged_flash_decode_fwd"


def _norm_table(table, rows):
    table = torch.as_tensor(table).to(torch.int32)
    if table.dim() == 1:
        table = table[None, :]
    return table.reshape(rows, -1)


def gather_paged_cache(cache, table):
    """``[N, H, BL, D]`` pool + ``[S, MB]`` table → ``[S, H, MB*BL, D]``:
    the owned blocks laid out as the ring cache; unmapped (-1) entries
    read block 0, past every valid length."""
    n, h, bl, d = cache.shape
    s, mb = table.shape
    safe = table.long().clamp(0, n - 1)
    g = cache[safe]                       # [S, MB, H, BL, D]
    return g.permute(0, 2, 1, 3, 4).reshape(s, h, mb * bl, d)


def paged_flash_decode_plain(q, k_cache, v_cache, lengths, table,
                             sm_scale=None):
    """``paged_decode_reference``: gather, then the ring oracle."""
    table = _norm_table(table, q.shape[0])
    return flash_decode_plain(q, gather_paged_cache(k_cache, table),
                              gather_paged_cache(v_cache, table), lengths,
                              sm_scale)


def paged_flash_decode_chunked_plain(q, k_cache, v_cache, lengths, table,
                                     chunk, sm_scale=None):
    """The kernel's arithmetic in plain PyTorch: gather, then
    ``flash_decode_chunked_plain`` (chunks of ``chunk`` keys merged in
    chunk order).  For tests and on-card checks; the main path never
    calls it."""
    table = _norm_table(table, q.shape[0])
    return flash_decode_chunked_plain(
        q, gather_paged_cache(k_cache, table),
        gather_paged_cache(v_cache, table), lengths, chunk, sm_scale)


def paged_flash_decode(q, k_cache, v_cache, lengths, table, sm_scale=None):
    """Single-step decode attention through a block table (the
    reference's ``paged_flash_decode``): q [S, H, D], pools [N, H, BL,
    D], lengths scalar or [S], table [S, MB] (or [MB] for S = 1) →
    [S, H, D].  CUDA tensors launch the kernel; CPU and meta tensors run
    the plain version."""
    s, h, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.device.type != "cuda":
        return paged_flash_decode_plain(q, k_cache, v_cache, lengths, table,
                                        sm_scale)
    n, hp, bl, dp = k_cache.shape
    table = _norm_table(table, s).to(q.device).contiguous()
    mb = table.shape[1]
    if k_cache.shape != v_cache.shape or hp != h or dp != d or s == 0:
        raise ValueError("%s: q %s does not fit pools %s / %s"
                         % (KERNEL, tuple(q.shape), tuple(k_cache.shape),
                            tuple(v_cache.shape)))
    if mb < 1:
        raise ValueError("%s: the table has no block per row" % KERNEL)
    q = q.contiguous()
    code = check_operands(KERNEL, q, (("k_cache", k_cache),
                                      ("v_cache", v_cache)))
    lens, stride = kernel_lengths(lengths, s, q.device)
    o = torch.empty_like(q)
    chunk = kernel_chunk(d)
    ws = torch.empty((s * h, -(-(mb * bl) // chunk), d + 4),
                     dtype=torch.float32, device=q.device)
    stream = _lib.stream_handle(q.device)
    err = _lib.lib().pt_paged_flash_decode_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lens.data_ptr(), table.data_ptr(), o.data_ptr(), ws.data_ptr(),
        row_counters(q.device, stream, s * h).data_ptr(), s * h, h, n, bl,
        mb, d, stride, chunk, float(sm_scale), code, stream)
    _lib.check(err, KERNEL)
    _lib.count_launch(KERNEL)
    return o
