"""Embedding row gather and its table gradient: hand-written CUDA kernels
for Hopper (``csrc/embedding.cu``) and their plain PyTorch versions.

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
scatter to XLA.  Here :func:`embedding_gather_bwd` launches two
hand-written kernels for CUDA tensors (``index_add_``'s CUDA atomics
would sum duplicate ids in an order that changes from run to run): one
pass that writes every row of the table once, each block finding its
rows' ids in order by scanning the ids itself, then the rows with more
than :data:`LONG` ids summed in :data:`PARTS` parts over many blocks.
Nothing of it runs on the host, and no allocation depends on the data,
so a CUDA graph captures it.  Its plain version,
:func:`embedding_gather_bwd_plain`, is ``index_add_`` (sequential on the
CPU); :func:`embedding_gather_bwd_sorted_plain` repeats the kernels'
order of additions on :func:`scatter_plan`'s description of it, bit for
bit.
"""

import torch

from . import _lib

KERNEL = "embedding_gather_fwd"
KERNEL_BWD = "embedding_gather_bwd"
# the backward's order (csrc/embedding.cu kLong, kParts): a row with at
# most LONG ids sums them in the ids' order; a longer one sums PARTS parts
# cut by its length alone, each in order, then the parts in order
LONG = 32
PARTS = 16


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


def _dropped(ids, rows, padding_idx):
    drop = ids >= rows
    if padding_idx is not None and padding_idx != -1:
        drop = drop | (ids == padding_idx)
    return drop


def embedding_gather_bwd_plain(dout, ids, rows, padding_idx=-1):
    """The gather's table gradient [rows, D] (float32 sums, then dout's
    dtype): the scatter-add of ``dout`` [n, D] at the clamped ids, with
    the rows of ids >= V and of ``padding_idx`` zeroed first."""
    ids = ids.long()
    g = dout.float().masked_fill(_dropped(ids, rows, padding_idx)[:, None],
                                 0.0)
    table = torch.zeros((rows, dout.shape[1]), dtype=torch.float32,
                        device=dout.device)
    table.index_add_(0, ids.clamp(0, rows - 1), g)
    return table.to(dout.dtype)


def scatter_plan(ids, rows, padding_idx=-1):
    """The order in which the backward's kernels add, as a plan for
    the plain twin: ``(perm, keys, starts)``, int64.  ``perm`` holds the
    positions of the
    ids that send a gradient (not >= ``rows``, not ``padding_idx``),
    ordered by their row (a negative id: row 0) and, within a row, by
    position; ``keys`` the rows they touch, ascending; the positions of
    ``keys[j]`` are ``perm[starts[j]:starts[j + 1]]``."""
    ids = ids.long()
    kept = torch.nonzero(~_dropped(ids, rows, padding_idx)).reshape(-1)
    rows_of = ids[kept].clamp(min=0)
    order = torch.sort(rows_of, stable=True).indices
    keys, counts = torch.unique_consecutive(rows_of[order],
                                            return_counts=True)
    starts = torch.zeros(keys.shape[0] + 1, dtype=torch.int64,
                         device=ids.device)
    torch.cumsum(counts, 0, out=starts[1:])
    return kept[order], keys, starts


def _run_sums(g, lo, length):
    """Float32 sums of the runs ``g[lo[r]:lo[r] + length[r]]``, each
    added in order from 0 (all runs in step)."""
    acc = torch.zeros((lo.shape[0], g.shape[1]), dtype=torch.float32,
                      device=g.device)
    top = int(length.max()) if length.numel() else 0
    for k in range(top):
        live = (k < length)[:, None]
        acc = torch.where(live, acc + g[(lo + k).clamp(max=g.shape[0] - 1)],
                          acc)
    return acc


def embedding_gather_bwd_sorted_plain(dout, plan, rows):
    """The kernels' arithmetic on a plan (:func:`scatter_plan`), float32,
    then dout's dtype: a row of at most LONG ids sums their rows of
    ``dout`` in the ids' order, from 0; a longer one of L ids cuts them
    into PARTS parts, part k the ids [k L // PARTS, (k + 1) L // PARTS),
    sums each in order from 0, then the parts in order from 0."""
    perm, keys, starts = plan
    g = dout.float()[perm]
    lo, length = starts[:-1], starts[1:] - starts[:-1]
    out = torch.zeros((rows, dout.shape[1]), dtype=torch.float32,
                      device=dout.device)
    short = length <= LONG
    out[keys[short]] = _run_sums(g, lo[short], length[short])
    lo_l, len_l = lo[~short], length[~short]
    if lo_l.numel():
        cuts = [lo_l + k * len_l // PARTS for k in range(PARTS + 1)]
        parts = [_run_sums(g, cuts[k], cuts[k + 1] - cuts[k])
                 for k in range(PARTS)]
        acc = torch.zeros_like(parts[0])
        for part in parts:
            acc = acc + part
        out[keys[~short]] = acc
    return out.to(dout.dtype)


def embedding_gather_bwd(dout, ids, rows, padding_idx=-1):
    """The gather's table gradient [rows, D] from ``dout`` [n, D]: CUDA
    tensors launch the rows and long-rows kernels (ids int32 or int64 as
    they come); CPU and meta tensors run
    :func:`embedding_gather_bwd_plain`."""
    if dout.device.type != "cuda":
        return embedding_gather_bwd_plain(dout, ids, rows, padding_idx)
    code = _lib.dtype_code(dout, KERNEL_BWD)
    if dout.dim() != 2 or ids.dim() != 1 or ids.shape[0] != dout.shape[0]:
        raise ValueError("dout must be [n, D] and ids [n], got %s / %s"
                         % (tuple(dout.shape), tuple(ids.shape)))
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError("ids must be int32 or int64, got %s" % ids.dtype)
    if ids.device != dout.device:
        raise ValueError("dout on %s, ids on %s" % (dout.device, ids.device))
    n, d = dout.shape
    if n == 0 or rows == 0 or d == 0:
        raise ValueError("embedding gather backward kernel takes non-empty "
                         "dout and table, got %s / %d rows"
                         % (tuple(dout.shape), rows))
    dout, ids = dout.contiguous(), ids.contiguous()
    lib = _lib.lib()
    words = lib.pt_embedding_gather_bwd_workspace(n, rows)
    if words < 0:
        _lib.check(-words, KERNEL_BWD)
    ws = torch.empty((words,), dtype=torch.int32, device=dout.device)
    out = torch.empty((rows, d), dtype=dout.dtype, device=dout.device)
    pad = -1 if padding_idx is None else int(padding_idx)
    err = lib.pt_embedding_gather_bwd(
        dout.data_ptr(), ids.data_ptr(), out.data_ptr(), ws.data_ptr(), n,
        rows, d, pad, int(ids.dtype == torch.int64), code,
        _lib.stream_handle(dout.device))
    _lib.check(err, KERNEL_BWD)
    _lib.count_launch(KERNEL_BWD)
    return out


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
