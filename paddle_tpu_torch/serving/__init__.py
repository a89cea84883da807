"""Serving tier (mirrors ``paddle_tpu/serving/``): the continuous-batching
:class:`PredictorServer` for batch tenants, its shape buckets, and the
:class:`DecodeEngine` decode tenant with its paged KV pool.  The load
generator, speculative decoding and telemetry come with later slices
(ROADMAP.md)."""

from .buckets import (  # noqa: F401
    BUCKETS_ENV, DEFAULT_BUCKETS, ShapeBuckets, derive_buckets,
    parse_buckets, resolve_buckets)
from .decode import (  # noqa: F401
    DecodeEngine, DecodeRequest, GenerationConfig)
from .paging import (  # noqa: F401
    BlockAllocator, KVPoolExhausted, blocks_needed, build_block_table,
    paged_kv_enabled)
from .server import (  # noqa: F401
    DeadlineExceededError, DispatcherCrashedError, PredictorServer,
    QueueFullError, Request, ServerClosedError, ServingError)
