"""Serving tier (mirrors ``paddle_tpu/serving/``): the continuous-batching
:class:`PredictorServer` for batch and decode tenants behind its
construction gates, its shape buckets, the :class:`DecodeEngine` decode
tenant with its paged KV pool, the load generator (:func:`run_load`) and
speculative decoding over the paged tier (:class:`SpeculativeDecoder`,
:func:`ngram_draft`).  CLI: ``python -m paddle_tpu_torch.tools.serve``."""

from .buckets import (  # noqa: F401
    BUCKETS_ENV, DEFAULT_BUCKETS, ShapeBuckets, derive_buckets,
    parse_buckets, resolve_buckets)
from .decode import (  # noqa: F401
    DecodeEngine, DecodeRequest, GenerationConfig)
from .loadgen import make_feed_sampler, percentile, run_load  # noqa: F401
from .paging import (  # noqa: F401
    BlockAllocator, KVPoolExhausted, blocks_needed, build_block_table,
    paged_kv_enabled)
from .server import (  # noqa: F401
    DeadlineExceededError, DispatcherCrashedError, PredictorServer,
    QueueFullError, Request, ServerClosedError, ServingError)
from .speculative import SpeculativeDecoder, ngram_draft  # noqa: F401
