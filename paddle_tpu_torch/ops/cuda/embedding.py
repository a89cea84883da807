"""Embedding row gather: a hand-written CUDA kernel for Hopper
(``csrc/embedding.cu``) and its plain PyTorch version.

Replaces the Pallas TPU kernel ``paddle_tpu/ops/pallas/embedding.py``
(``_pallas_gather`` at :63, ``pallas_call`` at :74, body ``_gather_kernel``
at :58) together
with the semantics its wrapper ``embedding_gather`` (:107-136) adds:
negative ids read row 0, ids >= V give NaN rows (``jnp.take``'s fill
mode; ``torch.index_select`` would raise instead, so the plain version
fills explicitly), and ``padding_idx`` rows come back zero.

:func:`embedding_gather_fwd` launches the kernel for CUDA tensors (or
raises) and runs :func:`embedding_gather_fwd_plain` for CPU and meta
tensors.  :func:`embedding_gather` is a ``torch.autograd.Function`` over
it whose backward is the reference's scatter-add (``_gather_core_bwd``
:96-101): duplicate ids accumulate, negative ids feed row 0, and ids >= V
and ``padding_idx`` rows send no gradient.  The reference leaves the
scatter to XLA; here it is ``index_add_``, whose CUDA atomics sum
duplicate ids in an order that varies from run to run.
"""

import torch

from . import _lib

KERNEL = "embedding_gather_fwd"


def embedding_gather_fwd_plain(table, ids, padding_idx=-1):
    """table [V, D], ids [n] int → [n, D]."""
    v = table.shape[0]
    ids = ids.long()
    out = table[ids.clamp(0, v - 1)]
    if out.is_floating_point():
        out = torch.where((ids >= v)[:, None],
                          torch.full_like(out, float("nan")), out)
    if padding_idx is not None and padding_idx != -1:
        out = torch.where((ids == padding_idx)[:, None],
                          torch.zeros_like(out), out)
    return out


def embedding_gather_fwd(table, ids, padding_idx=-1):
    """table [V, D] float32/bfloat16, ids [n] int32/int64 → [n, D].
    CUDA tensors launch the kernel; CPU and meta tensors run the plain
    version."""
    if table.dim() != 2 or ids.dim() != 1:
        raise ValueError("table must be [V, D] and ids [n], got %s / %s"
                         % (tuple(table.shape), tuple(ids.shape)))
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError("ids must be int32 or int64, got %s" % ids.dtype)
    if table.device != ids.device:
        raise ValueError("table on %s, ids on %s" % (table.device, ids.device))
    pad = -1 if padding_idx is None else int(padding_idx)
    if table.device.type != "cuda":
        return embedding_gather_fwd_plain(table, ids, pad)
    code = _lib.dtype_code(table, KERNEL)
    if not table.is_contiguous() or not ids.is_contiguous():
        raise ValueError("embedding gather kernel needs contiguous inputs")
    v, d = table.shape
    n = ids.shape[0]
    if n == 0 or v == 0 or d == 0:
        raise ValueError("embedding gather kernel takes non-empty table and "
                         "ids, got %s / %s" % (tuple(table.shape), n))
    out = torch.empty((n, d), dtype=table.dtype, device=table.device)
    err = _lib.lib().pt_embedding_gather_fwd(
        table.data_ptr(), ids.data_ptr(), out.data_ptr(), n, v, d, pad,
        int(ids.dtype == torch.int64), code, _lib.stream_handle(table.device))
    _lib.check(err, KERNEL)
    _lib.count_launch(KERNEL)
    return out


def embedding_gather_bwd(dout, ids, rows, padding_idx=-1):
    """The gather's table gradient [rows, D] (float32 sums, then dout's
    dtype): the scatter-add of ``dout`` [n, D] at the clamped ids, with
    the rows of ids >= V and of ``padding_idx`` zeroed first."""
    ids = ids.long()
    drop = ids >= rows
    if padding_idx is not None and padding_idx != -1:
        drop = drop | (ids == padding_idx)
    g = dout.float().masked_fill(drop[:, None], 0.0)
    table = torch.zeros((rows, dout.shape[1]), dtype=torch.float32,
                        device=dout.device)
    table.index_add_(0, ids.clamp(0, rows - 1), g)
    return table.to(dout.dtype)


class _EmbeddingGather(torch.autograd.Function):
    """``_gather_core`` with its custom vjp (:82-104)."""

    @staticmethod
    def forward(ctx, table, ids, padding_idx):
        ctx.save_for_backward(ids)
        ctx.rows, ctx.padding_idx = table.shape[0], padding_idx
        return embedding_gather_fwd(table, ids, padding_idx)

    @staticmethod
    def backward(ctx, dout):
        (ids,) = ctx.saved_tensors
        return (embedding_gather_bwd(dout, ids, ctx.rows, ctx.padding_idx),
                None, None)


def embedding_gather(table, ids, padding_idx=-1):
    """``table[ids]`` with the ``lookup_table`` semantics and the
    scatter-add gradient; table [V, D], ids [n] → [n, D]."""
    return _EmbeddingGather.apply(table, ids, padding_idx)
