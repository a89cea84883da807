"""Serving tier (mirrors ``paddle_tpu/serving/``): the continuous-batching
:class:`PredictorServer` for batch tenants and its shape buckets.  Decode
tenants, the load generator and telemetry come with later slices
(ROADMAP.md)."""

from .buckets import (  # noqa: F401
    BUCKETS_ENV, DEFAULT_BUCKETS, ShapeBuckets, derive_buckets,
    parse_buckets, resolve_buckets)
from .server import (  # noqa: F401
    DeadlineExceededError, DispatcherCrashedError, PredictorServer,
    QueueFullError, Request, ServerClosedError, ServingError)
