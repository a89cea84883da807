"""The exchanges of the collective ops over a ``torch.distributed``
group: sum (at once or started and waited on), max / min / product,
broadcast, all-to-all and all-gather of one contiguous tensor.

NCCL takes CUDA tensors where they lie.  Gloo takes CPU tensors only
(its all-to-all and all-gather refuse CUDA tensors), so for a gloo
group a CUDA payload is copied into pinned host memory, exchanged
there, and copied back to the card.  Two ranks that share one card run
such a group: NCCL refuses two ranks on one device.
"""

import torch
import torch.distributed as dist

__all__ = ["host_staged", "all_reduce_sum", "all_reduce",
           "all_reduce_start", "broadcast", "all_to_all", "all_gather"]


def host_staged(t, group):
    """True when ``t`` crosses ``group`` through pinned host memory."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _pinned(shape, dtype):
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def _to_host(t):
    host = _pinned(t.shape, t.dtype)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host


def _back(host, like):
    return host.to(like.device, non_blocking=False)


def all_reduce_sum(t, group):
    """The group's sum of ``t`` (a new tensor)."""
    return all_reduce(t, group, dist.ReduceOp.SUM)


def all_reduce(t, group, op):
    """The group's reduction of ``t`` by ``op`` (a ``dist.ReduceOp``), a
    new tensor."""
    if host_staged(t, group):
        host = _to_host(t)
        dist.all_reduce(host, op=op, group=group)
        return _back(host, t)
    out = t.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class Pending:
    """A started sum: :meth:`wait` blocks until the exchange is done and
    returns the sum on ``t``'s device."""

    def __init__(self, work, buf, like):
        self._work, self._buf, self._like = work, buf, like

    def wait(self):
        if self._work is not None:
            self._work.wait()
            self._work = None
        if self._buf.device != self._like.device:
            return _back(self._buf, self._like)
        return self._buf


def all_reduce_start(t, group):
    """Start the group's sum of ``t`` (``async_op=True``) → a
    :class:`Pending`.  A gloo payload on a card is staged to host memory
    first (that copy waits for the card); the exchange itself runs while
    the caller goes on."""
    buf = _to_host(t) if host_staged(t, group) else t.clone()
    work = dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group,
                           async_op=True)
    return Pending(work, buf, t)


def broadcast(t, group, root):
    """Rank ``root``'s ``t`` on every rank of ``group`` (a new tensor);
    ``root`` is the rank in ``group``."""
    src = dist.get_global_rank(group, root) \
        if group is not None and group is not dist.group.WORLD else root
    if host_staged(t, group):
        host = _to_host(t)
        dist.broadcast(host, src=src, group=group)
        return _back(host, t)
    out = t.clone()
    dist.broadcast(out, src=src, group=group)
    return out


def all_to_all(t, group):
    """``t`` [n, ...] with row ``p`` bound for rank ``p`` → [n, ...] with
    row ``p`` from rank ``p``."""
    staged = host_staged(t, group)
    src = _to_host(t) if staged else t.contiguous()
    out = _pinned(src.shape, src.dtype) if staged else torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return _back(out, t) if staged else out


def all_gather(t, group):
    """``t`` of every rank, stacked in rank order: [n, *t.shape]."""
    n = dist.get_world_size(group)
    staged = host_staged(t, group)
    src = _to_host(t) if staged else t.contiguous()
    shape = (n,) + tuple(src.shape)
    out = _pinned(shape, src.dtype) if staged else src.new_empty(shape)
    dist.all_gather(list(out.unbind(0)), src, group=group)
    return _back(out, t) if staged else out
