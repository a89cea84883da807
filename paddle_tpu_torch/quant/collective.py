"""The ``c_allreduce_quant`` math: an int8 block-quantized allreduce over
a ``torch.distributed`` group.

Mirrors ``paddle_tpu/quant/collective.py``, whose exchange runs under
``shard_map`` with lax collectives; here it runs on a process group
(:mod:`paddle_tpu_torch.ops.comm`):

1. quantize the flat bucket, zero-padded to ``n · B`` so every rank's
   chunk is a whole number of blocks (K7 quantize);
2. reduce-scatter in int8: ``all_to_all`` of the per-rank chunks (int8
   q and the float32 scale sidecar), then each rank dequantizes what its
   peers sent (K7 dequantize) and sums it in ascending rank order, so
   every rank adds the same summands in the same order;
3. requantize the reduced chunk (K7 quantize), ``all_gather`` it (int8
   and sidecar), dequantize (K7 dequantize) and trim the pad.

Per bucket that is two quantize and two dequantize launches, at any
world size (one included).  The reference pins its XLA composite inside
the collective (``kernel=False``, :54-57) because ``pallas_call`` has no
``shard_map`` rule; a process group has no such limit, so the kernels
run here.  The payload is quantized twice, so the end-to-end RMS error
is about √2 times the single-pass model of :mod:`.blockwise`.  Every
rank dequantizes the same gathered bits, so the result is bit-identical
across ranks.
"""

import os

import torch
import torch.distributed as dist

from ..ops import comm
from .blockwise import (block_dequantize, block_quantize, padded_size,
                        quant_block, quant_enabled)

__all__ = ["quantized_allreduce", "quantized_wire_bytes",
           "quant_min_bytes"]


def quantized_allreduce(flat, group=None, block=None, kernel=True):
    """Allreduce-sum a flat float32/bfloat16 vector over ``group`` (the
    default group when None) with int8 block-quantized exchange; returns
    the (approximate) sum in ``flat``'s dtype on ``flat``'s device.
    ``kernel=False`` runs K7's plain versions (the same bits)."""
    b = int(block) if block else quant_block()
    n = dist.get_world_size(group)
    dtype = flat.dtype
    numel = flat.numel()
    npad = padded_size(numel, n * b)
    chunk = npad // n

    # zero blocks quantize to q 0 under scale 1: padding the input to
    # n·B gives the reference's re-padded payload bit for bit
    x = flat.reshape(-1).to(torch.float32)
    if npad != numel:
        x = torch.cat([x, x.new_zeros(npad - numel)])
    q, scales = block_quantize(x, block=b, kernel=kernel)

    q_peer = comm.all_to_all(q.view(n, chunk), group)
    s_peer = comm.all_to_all(scales.view(n, chunk // b), group)
    vals = block_dequantize(q_peer, s_peer.reshape(-1),
                            kernel=kernel).view(n, chunk)
    part = vals[0]
    for p in range(1, n):  # ascending rank order, on every rank
        part = part + vals[p]

    q_r, s_r = block_quantize(part, block=b, kernel=kernel)
    q_all = comm.all_gather(q_r, group)
    s_all = comm.all_gather(s_r, group)
    out = block_dequantize(q_all, s_all.reshape(-1), dtype=dtype,
                           kernel=kernel)
    return out[:numel]


def quantized_wire_bytes(numel, nranks, block=None, dtype_bytes=2):
    """(quant_bytes, dense_bytes) one ring allreduce moves per rank for a
    ``numel``-element bucket, before the ring factor ``2·(n-1)/n``: the
    int8 payload padded to ``n · B`` plus the float32 scale per block,
    against ``numel · dtype_bytes``."""
    b = int(block) if block else quant_block()
    n = max(int(nranks), 1)
    npad = padded_size(numel, n * b)
    quant_bytes = npad + (npad // b) * 4
    dense_bytes = int(numel) * int(dtype_bytes)
    return quant_bytes, dense_bytes


def quant_min_bytes(program=None):
    """The per-bucket engagement threshold in bytes, or None when
    quantized collectives are off for this program.

    Precedence: the kill switch (``PADDLE_TPU_QUANT=0`` → None) → the
    program's ``_quant_buckets`` mark (``{"min_bytes": …}``) →
    ``PADDLE_TPU_QUANT_MIN_BYTES`` → None (quant never engages without an
    explicit mark or env opt-in)."""
    if not quant_enabled():
        return None
    mark = getattr(program, "_quant_buckets", None) if program else None
    if isinstance(mark, dict) and mark.get("min_bytes") is not None:
        try:
            return int(mark["min_bytes"])
        except (TypeError, ValueError):
            return None
    env = os.environ.get("PADDLE_TPU_QUANT_MIN_BYTES", "").strip()
    if env:
        try:
            return int(env)
        except ValueError:
            return None
    return None
