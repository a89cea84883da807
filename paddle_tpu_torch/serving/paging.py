"""Paged KV-cache management: the block free-list, block tables and the
paged-mode switch (mirrors ``paddle_tpu/serving/paging.py``).

The slot-ring cache (``[slots, H, Tmax, Dh]``) reserves ``Tmax`` rows per
stream for its whole life.  The paged pool (``[num_blocks, H,
block_len, Dh]``) gives a request exactly ``ceil(tokens / block_len)``
blocks, named by its **block table** (an int32 ``[max_blocks]`` row,
``-1`` = unmapped), and the free-list hands blocks out and takes them
back as requests are admitted and retired.

The free-list is LIFO and every mutation happens on the engine's
scheduler thread (or under its condition lock), so a seeded
admit/generate/retire schedule replays exactly.  ``PADDLE_TPU_PAGED_KV=0``
makes :func:`paged_kv_enabled` false and the
:class:`~paddle_tpu_torch.serving.decode.DecodeEngine` keeps its
slot-ring path.
"""

import os

import numpy as np

__all__ = ["BlockAllocator", "KVPoolExhausted", "blocks_needed",
           "build_block_table", "paged_kv_enabled"]

PAGED_KV_ENV = "PADDLE_TPU_PAGED_KV"


def paged_kv_enabled():
    """The tentpole kill switch: ``PADDLE_TPU_PAGED_KV=0`` restores the
    slot-ring cache path bit-exactly (default: paged on)."""
    return os.environ.get(PAGED_KV_ENV, "1").strip() != "0"


def blocks_needed(tokens, block_len):
    """Blocks a request owning ``tokens`` cache rows must hold."""
    tokens = int(tokens)
    if tokens <= 0:
        return 0
    return -(-tokens // int(block_len))


def build_block_table(blocks, max_blocks):
    """An int32 ``[max_blocks]`` table row: owned block ids first,
    ``-1`` padding after (the paged ops drop writes routed to ``-1``
    and the attention mask never reads past the owned depth)."""
    table = np.full((int(max_blocks),), -1, dtype="int32")
    if blocks:
        table[:len(blocks)] = np.asarray(list(blocks), dtype="int32")
    return table


class KVPoolExhausted(RuntimeError):
    """An allocation asked for more blocks than the free-list holds —
    the engine treats this as backpressure (the request stays queued
    until retirements return blocks), never as partial allocation."""


class BlockAllocator:
    """LIFO free-list over ``num_blocks`` fixed-size KV blocks.

    Invariants (the property-test contract):

    * a block id is owned by at most one holder at a time — ``allocate``
      never hands out an id that has not been ``free``\\ d back;
    * conservation — ``num_free + sum(live allocations) == num_blocks``
      at every point in any schedule;
    * ``free`` rejects double-frees and foreign ids loudly instead of
      corrupting the list.
    """

    __slots__ = ("num_blocks", "block_len", "_free", "_live")

    def __init__(self, num_blocks, block_len):
        self.num_blocks = int(num_blocks)
        self.block_len = int(block_len)
        if self.num_blocks < 1:
            raise ValueError("num_blocks must be >= 1, got %d"
                             % self.num_blocks)
        if self.block_len < 1:
            raise ValueError("block_len must be >= 1, got %d"
                             % self.block_len)
        # LIFO: block 0 on top so fresh pools allocate 0,1,2,... — the
        # deterministic order the churn property test replays
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._live = set()

    @property
    def num_free(self):
        return len(self._free)

    def can_allocate(self, n):
        return int(n) <= len(self._free)

    def allocate(self, n):
        """Pop ``n`` block ids; all-or-nothing (raises
        :class:`KVPoolExhausted` without touching the list when the
        pool is short)."""
        n = int(n)
        if n < 0:
            raise ValueError("cannot allocate %d blocks" % n)
        if n > len(self._free):
            raise KVPoolExhausted(
                "KV pool exhausted: asked for %d block(s), %d free of "
                "%d" % (n, len(self._free), self.num_blocks))
        got = [self._free.pop() for _ in range(n)]
        self._live.update(got)
        return got

    def free(self, blocks):
        """Return a request's blocks to the pool (retirement)."""
        blocks = list(blocks)
        for b in blocks:
            b = int(b)
            if b not in self._live:
                raise ValueError(
                    "freeing block %d which is not live (double-free "
                    "or foreign id; %d live, %d free)"
                    % (b, len(self._live), len(self._free)))
        for b in blocks:
            self._live.discard(int(b))
            self._free.append(int(b))

    def __repr__(self):
        return "BlockAllocator(%d/%d free, block_len=%d)" % (
            len(self._free), self.num_blocks, self.block_len)
