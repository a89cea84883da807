"""Autoregressive decoding ops: ring and paged KV caches, single-query
attention over them, and sampling.

Mirrors ``paddle_tpu/ops/decode.py`` (``kv_cache_write`` :50,
``kv_cache_prefill`` :73, ``flash_decode_attention`` :90,
``paged_kv_cache_write`` :131, ``paged_kv_cache_prefill`` :162,
``paged_flash_decode_attention`` :188, ``top_k_sampling`` :235,
``top_p_sampling`` :258).  Cursor convention as there: ``Cursor`` is
int32 ``[1]`` (one shared cursor) or ``[B]`` with ``per_row=True`` (each
serving slot at its own depth); ring writes wrap at ``Tmax`` and reads
mask to ``min(cursor, Tmax)``; paged reads mask to ``min(cursor,
MB*BL)``, and a paged write routed to a ``-1`` (or out-of-pool) table
entry, or a prefill row at or past the prompt length, is dropped.

**The cache ops write in place.**  The reference's writes are
functional (a one-hot merge, ``dynamic_update_slice``, a ``.at[].set``
scatter); on an eager executor that would copy the whole cache per op —
25 MB per ring write at GPT-2-small width, 24 writes per step.  So the
four cache-writing ops update the resident cache tensor itself with
``index_put_``/``index_copy_`` (the same result) and are registered with
``in_place={"Out": "Cache"}``.  The executor honours that declaration
only for them (``executor.py``): when the program writes the result to a
var other than the cache, it hands the op a copy.

Sampling draws its Gumbel noise on the op's device, as the reference
draws it inside its jitted step (``_sampling_key`` :220): the uniform
bits are the dropout kernels' card generator (``cuda/dropout.py``
``card_bits``) keyed by the run's device step tensor and the op's salt
(``LoweringContext.step_seed``, the ``seed`` attr folded in), with the
``Step`` input mixed in on the device.  Nothing is read on the host, so
both ops are capturable in a CUDA graph for every attr set, and a step
replays its draw exactly, eager or from the graph.  The bits cannot
reproduce the reference's ``jax.random`` draws: parity is in the kept
set and in distribution.  Greedy (``k=1`` or ``temperature <= 0``) is an
argmax and matches the reference exactly.
"""

import math

import torch

from .common import gumbel_of_bits
from .cuda import dropout as _drop
from .cuda.flash_decode import flash_decode
from .cuda.paged_flash_decode import paged_flash_decode
from .registry import register_op

NEG_INF = -1e30


def _cursor_starts(Cursor, per_row, batch):
    """int32 [B] positions from a [1]/[] shared cursor or [B] per-row."""
    cur = Cursor.reshape(-1).to(torch.int32)
    if per_row:
        return cur.expand(batch) if cur.numel() == 1 else cur.reshape(batch)
    return cur[0].expand(batch)


def _norm_kv(X, cache):
    """New K/V entries as [B, H, 1, D] (accepts [B, H, D] too)."""
    if X.dim() == cache.dim() - 1:
        X = X[:, :, None, :]
    return X.to(cache.dtype)


@register_op("kv_cache_write", inputs=["Cache", "X", "Cursor"],
             outputs=["Out"], no_grad=True, in_place={"Out": "Cache"})
def kv_cache_write(ctx, attrs, Cache, X, Cursor):
    """This step's K (or V) row into the ring cache at the cursor (mod
    Tmax), in place.  Cache [B, H, Tmax, D]; X [B, H, D] or [B, H, 1,
    D]; Cursor [1] or [B] (``per_row=True``)."""
    b, _h, t, _d = Cache.shape
    X = _norm_kv(X, Cache)
    per_row = bool(attrs.get("per_row", False))
    if not per_row:
        pos = Cursor.reshape(-1)[:1].long() % t
        return Cache.index_copy_(2, pos, X)
    pos = _cursor_starts(Cursor, True, b).long() % t
    rows = torch.arange(b, device=Cache.device)
    Cache[rows, :, pos] = X[:, :, 0, :]
    return Cache


@register_op("kv_cache_prefill", inputs=["Cache", "X", "Slot"],
             outputs=["Out"], no_grad=True, in_place={"Out": "Cache"})
def kv_cache_prefill(ctx, attrs, Cache, X, Slot):
    """A prompt's K/V rows [B', H, L, D] into cache positions [0, L), in
    place; with ``Slot`` ([1] int32) into cache rows slot .. slot+B'-1,
    the start clamped so they fit, as ``dynamic_update_slice``."""
    X = X.to(Cache.dtype)
    xb, xh, length, xd = X.shape
    if Slot is None:
        Cache[:xb, :xh, :length, :xd] = X
        return Cache
    start = Slot.reshape(-1)[0].long().clamp(0, Cache.shape[0] - xb)
    rows = start + torch.arange(xb, device=Cache.device)
    Cache[:, :xh, :length, :xd].index_copy_(0, rows, X)
    return Cache


@register_op("flash_decode_attention",
             inputs=["Q", "KCache", "VCache", "Cursor"],
             outputs=["Out"], no_grad=True)
def flash_decode_attention(ctx, attrs, Q, KCache, VCache, Cursor):
    """Single-query attention against the ring cache, masked to the
    cursor (clamped to Tmax): the flash-decode kernel on the GPU.  Q
    [B, H, D] (or [B, H, 1, D]); caches [B, H, Tmax, D]."""
    squeeze = Q.dim() == 4
    if squeeze:
        Q = Q[:, :, 0, :]
    b, _h, d = Q.shape
    t = KCache.shape[2]
    sm_scale = attrs.get("sm_scale")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    lens = _cursor_starts(Cursor, bool(attrs.get("per_row", False)), b)
    lens = torch.clamp(lens, max=t)  # ring: at most Tmax entries are live
    out = flash_decode(Q, KCache, VCache, lens, sm_scale=float(sm_scale))
    return out[:, :, None, :] if squeeze else out


def _norm_table(BlockTable, rows):
    """int32 ``[rows, MB]`` block table (a 1-D table means one row)."""
    table = BlockTable.to(torch.int32)
    if table.dim() == 1:
        table = table[None, :]
    return table.reshape(rows, -1)


def _write_rows(cache, blk, off, vals, keep):
    """``cache[blk[i], :, off[i], :] = vals[i]`` where ``keep[i]`` and the
    block lies in the pool, in place, with one ``index_put_`` and no host
    sync.  Every other row repeats the first kept row's write (the same
    place and value), or, when no row is kept, writes a cache row back
    unchanged, so the scatter holds no conflicting duplicates."""
    safe = blk.long().clamp(0, cache.shape[0] - 1)
    keep = keep & (blk == safe)
    rows = torch.arange(keep.shape[0], device=keep.device)
    src = torch.where(keep, rows, torch.argmax(keep.to(torch.int32)))
    blk, off = safe[src], off.long()[src]
    vals = torch.where(keep.any(), vals[src], cache[blk, :, off, :])
    cache[blk, :, off, :] = vals
    return cache


@register_op("paged_kv_cache_write",
             inputs=["Cache", "X", "Cursor", "BlockTable"],
             outputs=["Out"], no_grad=True, in_place={"Out": "Cache"})
def paged_kv_cache_write(ctx, attrs, Cache, X, Cursor, BlockTable):
    """This step's K (or V) rows [S, H, D] into the paged pool [N, H, BL,
    D], in place: row ``s`` lands in block ``table[s, cursor // BL]`` at
    offset ``cursor % BL``; a row routed to an unmapped entry is
    dropped."""
    bl = Cache.shape[2]
    X = _norm_kv(X, Cache)[:, :, 0, :]
    s = X.shape[0]
    pos = _cursor_starts(Cursor, bool(attrs.get("per_row", True)), s)
    table = _norm_table(BlockTable, s)
    col = torch.clamp(pos // bl, 0, table.shape[1] - 1)
    blk = table.gather(1, col.long()[:, None])[:, 0]
    return _write_rows(Cache, blk, pos % bl, X,
                       torch.ones_like(blk, dtype=torch.bool))


@register_op("paged_kv_cache_prefill",
             inputs=["Cache", "X", "Len", "BlockTable"],
             outputs=["Out"], no_grad=True, in_place={"Out": "Cache"})
def paged_kv_cache_prefill(ctx, attrs, Cache, X, Len, BlockTable):
    """A prompt's K/V [1, H, L, D] into the table's blocks, in place:
    position ``p`` lands in block ``table[p // BL]`` at offset ``p %
    BL``; padded positions ``>= Len`` and unmapped entries are
    dropped."""
    bl = Cache.shape[2]
    if X.dim() == 4:
        X = X[0]
    X = X.to(Cache.dtype)                          # [H, L, D]
    length = X.shape[1]
    table = _norm_table(BlockTable, 1)[0]          # [MB]
    pos = torch.arange(length, device=Cache.device)
    blk = table[torch.clamp(pos // bl, 0, table.shape[0] - 1)]
    keep = pos < Len.reshape(-1)[0]
    return _write_rows(Cache, blk, pos % bl, X.transpose(0, 1), keep)


@register_op("paged_flash_decode_attention",
             inputs=["Q", "KCache", "VCache", "Cursor", "BlockTable"],
             outputs=["Out"], no_grad=True)
def paged_flash_decode_attention(ctx, attrs, Q, KCache, VCache, Cursor,
                                 BlockTable):
    """Single-query attention through the block table, masked to the
    cursor (clamped to the table's depth MB*BL): the paged flash-decode
    kernel on the GPU.  Q [S, H, D] (or [S, H, 1, D]); pools [N, H, BL,
    D]; rows are independent."""
    squeeze = Q.dim() == 4
    if squeeze:
        Q = Q[:, :, 0, :]
    s, _h, d = Q.shape
    bl = KCache.shape[2]
    sm_scale = attrs.get("sm_scale")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    table = _norm_table(BlockTable, s)
    lens = _cursor_starts(Cursor, bool(attrs.get("per_row", True)), s)
    lens = torch.clamp(lens, max=table.shape[1] * bl)
    out = paged_flash_decode(Q, KCache, VCache, lens, table,
                             sm_scale=float(sm_scale))
    return out[:, :, None, :] if squeeze else out


def _gumbel(ctx, attrs, Step, shape, device):
    """Gumbel noise [rows, cols] for this (program seed, op, ``seed``
    attr, executor step, ``Step``), drawn on ``device`` with no host
    read: the card generator's bits at (row, col), keyed by the step
    seed with ``Step`` mixed in (int64 arithmetic masked to 32 bits),
    mapped by ``common.gumbel_of_bits``."""
    seed = _drop.seed_u32(ctx.step_seed(
        fold=int(attrs.get("seed", 0)) & 0x7FFFFFFF)).to(device)
    if Step is not None:
        step = Step.reshape(-1)[0].to(device=device, dtype=torch.int64)
        seed = _drop._fmix32(
            (seed + _drop._mul32(step & _drop.MASK32, 0x27D4EB2F))
            & _drop.MASK32)
    rows, cols = shape
    bits = _drop.card_bits(
        seed, 0, torch.arange(rows, dtype=torch.int64, device=device)[:, None],
        torch.arange(cols, dtype=torch.int64, device=device)[None, :])
    return gumbel_of_bits(bits)


def _greedy(X):
    return torch.argmax(X, dim=-1).to(torch.int32)


def _top_k_greedy(attrs):
    return int(attrs.get("k", 1)) <= 1 \
        or float(attrs.get("temperature", 1.0)) <= 0.0


@register_op("top_k_sampling", inputs=["X", "Step"], outputs=["Out"],
             no_grad=True)
def top_k_sampling(ctx, attrs, X, Step):
    """Token ids from the top-k of each row of logits X [B, V]: greedy
    argmax for ``k <= 1`` or ``temperature <= 0``, else Gumbel-max over
    the top k logits over ``temperature``."""
    if _top_k_greedy(attrs):
        return _greedy(X)
    k = int(attrs.get("k", 1))
    temp = float(attrs.get("temperature", 1.0))
    if X.device.type == "meta":
        return torch.empty(X.shape[:-1], dtype=torch.int32, device="meta")
    vals, idx = torch.topk(X, min(k, X.shape[-1]), dim=-1)
    g = _gumbel(ctx, attrs, Step, tuple(vals.shape), X.device)
    choice = torch.argmax(vals.float() / temp + g, dim=-1)
    return idx.gather(1, choice[:, None])[:, 0].to(torch.int32)


def _top_p_greedy(attrs):
    return float(attrs.get("temperature", 1.0)) <= 0.0


@register_op("top_p_sampling", inputs=["X", "Step"], outputs=["Out"],
             no_grad=True)
def top_p_sampling(ctx, attrs, X, Step):
    """Nucleus sampling: keep the smallest prefix of the descending
    softmax whose mass reaches ``p`` (the head token always survives),
    then Gumbel-max over the survivors; ``temperature <= 0`` is greedy."""
    if _top_p_greedy(attrs):
        return _greedy(X)
    p = float(attrs.get("p", 0.9))
    temp = float(attrs.get("temperature", 1.0))
    if X.device.type == "meta":
        return torch.empty(X.shape[:-1], dtype=torch.int32, device="meta")
    order = torch.argsort(-X, dim=-1, stable=True)
    logits = X.gather(-1, order).float() / temp
    probs = torch.softmax(logits, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < p
    masked = torch.where(keep, logits, torch.full_like(logits, NEG_INF))
    g = _gumbel(ctx, attrs, Step, tuple(masked.shape), X.device)
    choice = torch.argmax(masked + g, dim=-1)
    return order.gather(1, choice[:, None])[:, 0].to(torch.int32)
