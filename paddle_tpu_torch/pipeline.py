"""Async dispatch pipeline: lazy fetch handles, the one batched
device→host sync, and device-staged feeds (mirrors
``paddle_tpu/pipeline.py``, all of it).

PyTorch launches CUDA work asynchronously on the current stream, so a
step returns as soon as its kernels are enqueued.  This module owns the
pieces that keep the serving loop free of host syncs:

* :class:`FetchHandle` — a step's output tensor and a CUDA event
  recorded right after the step; nothing waits until the value is read.
* :func:`host_values` / :func:`materialize` — the ONE device→host sync
  point: every copy into pinned memory starts without blocking, one
  event is recorded after them and waited on once.  It is the
  ``host.sync`` span and the ``host_syncs_total`` /
  ``host_sync_wait_ms`` telemetry; :func:`sync_stats` counts it.
* :class:`DeviceFeedPipeline` — a background thread that stages upcoming
  feed batches on the device (pinned host copy, ``non_blocking`` copy on
  a stream of its own, an event after the batch) with a depth of
  ``PADDLE_TPU_PIPELINE_DEPTH`` (default 2).  The consumer's stream waits
  on each batch's event before the batch is handed out, and every staged
  tensor is marked used on that stream (``record_stream``), so the
  caching allocator never reuses a staged buffer while a step still
  reads it.  :class:`FeedCache` backs it: a host array fed again by
  value is transferred once.  On the CPU a staged feed is a copy of the
  host array, never a view of it.

Exceptions raised on the staging thread propagate to the consumer
instead of hanging the queue.
"""

import os
import queue as _queue
import threading
import time

import numpy as np
import torch

__all__ = [
    "FetchHandle", "DeviceFeedPipeline", "FeedCache", "host_values",
    "materialize", "device_put_feed", "pipeline_depth", "sync_stats",
    "reset_sync_stats",
]


def pipeline_depth(default=2):
    """Prefetch depth for device feed pipelines: how many upcoming
    batches may be staged on the device ahead of the running step
    (``PADDLE_TPU_PIPELINE_DEPTH``, default 2 — double buffering)."""
    try:
        d = int(os.environ.get("PADDLE_TPU_PIPELINE_DEPTH", "") or default)
    except ValueError:
        d = default
    return max(1, d)


_sync_lock = threading.Lock()
_sync_count = 0
_sync_wait_ms = 0.0


def sync_stats():
    """{"syncs": N, "sync_wait_ms": total} — every device→host sync this
    process has paid through :func:`host_values` (a fetch handle that was
    never read leaves the counter alone)."""
    with _sync_lock:
        return {"syncs": _sync_count, "sync_wait_ms": _sync_wait_ms}


def reset_sync_stats():
    global _sync_count, _sync_wait_ms
    with _sync_lock:
        _sync_count = 0
        _sync_wait_ms = 0.0


def _is_cuda(v):
    return isinstance(v, torch.Tensor) and v.device.type == "cuda"


def _to_numpy(t):
    """A host tensor as numpy.  bfloat16 becomes ``ml_dtypes.bfloat16``,
    numpy's bf16 and the reference's fetch dtype, where ``ml_dtypes`` is
    installed, else float32 (exact): PyTorch does not depend on it."""
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError:
            return t.float().numpy()
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def host_values(values):
    """Tensors, handles or host values → numpy arrays, in order, with one
    synchronisation for all the CUDA tensors among them.  A call given
    any tensor (on the CPU too, as the reference counts its CPU arrays)
    is one sync: the ``host.sync`` span and ``record_sync``."""
    global _sync_count, _sync_wait_ms

    vals = [v.device_value if isinstance(v, FetchHandle) else v
            for v in values]
    if not any(isinstance(v, torch.Tensor) for v in vals):
        return [np.asarray(v) for v in vals]
    from .observability import runtime as _obs
    from .observability import tracing as _tr

    handles = sum(1 for v in vals if isinstance(v, torch.Tensor))
    t0 = time.perf_counter()
    with _tr.span_if_traced("host.sync", handles=handles):
        out = _copy_all(vals)
    wait_ms = (time.perf_counter() - t0) * 1e3
    with _sync_lock:
        _sync_count += 1
        _sync_wait_ms += wait_ms
    _obs.record_sync(wait_ms, handles=handles)
    return out


def _copy_all(vals):
    out = [None] * len(vals)
    copies = []
    for i, v in enumerate(vals):
        if _is_cuda(v):
            host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host.copy_(v, non_blocking=True)
            copies.append((i, host))
        elif isinstance(v, torch.Tensor):
            out[i] = _to_numpy(v.detach())
        else:
            out[i] = np.asarray(v)
    if copies:
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        for i, host in copies:
            out[i] = _to_numpy(host)
    return out


class FetchHandle:
    """Lazy fetch: a step's output tensor plus the CUDA event recorded
    after the step.  Creating or passing a handle costs no sync; the
    first read (``np.asarray(h)``, ``h.numpy()``) waits and copies once,
    caches the host array and releases the device tensor."""

    __slots__ = ("_dev", "_host", "_event")

    def __init__(self, device_value):
        self._dev = device_value
        self._host = None
        self._event = None
        if _is_cuda(device_value):
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device_value.device))

    @property
    def device_value(self):
        """The device tensor while in flight; the host copy after."""
        return self._host if self._dev is None else self._dev

    @property
    def synced(self):
        return self._host is not None

    def numpy(self):
        if self._host is None:
            self._host = host_values([self._dev])[0]
            self._dev = None
        return self._host

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def is_ready(self):
        return self._host is not None or self._event is None \
            or self._event.query()

    def block_until_ready(self):
        if self._host is None and self._event is not None:
            self._event.synchronize()
        return self

    @property
    def shape(self):
        return tuple(self.device_value.shape)

    @property
    def dtype(self):
        return self.device_value.dtype

    def __repr__(self):
        return "<FetchHandle shape=%s dtype=%s %s>" % (
            self.shape, self.dtype, "synced" if self.synced else "in-flight")


def materialize(fetches):
    """One handle, or a (nested) list/tuple of handles → numpy values in
    the same structure, with ONE batched sync."""
    if isinstance(fetches, FetchHandle):
        return fetches.numpy()
    flat = []

    def collect(x):
        if isinstance(x, (list, tuple)):
            for e in x:
                collect(e)
        else:
            flat.append(x)

    collect(fetches)
    need = [h for h in flat if isinstance(h, FetchHandle) and not h.synced]
    if need:
        for h, a in zip(need, host_values([h.device_value for h in need])):
            h._host = a
            h._dev = None

    def rebuild(x):
        if isinstance(x, (list, tuple)):
            return type(x)(rebuild(e) for e in x)
        return x.numpy() if isinstance(x, FetchHandle) else np.asarray(x)

    return rebuild(fetches)


# ---------------------------------------------------------------------------
# device-staged feeds
# ---------------------------------------------------------------------------


def _cache_enabled():
    return os.environ.get("PADDLE_TPU_FEED_CACHE", "1") != "0"


def _cache_cap(default=64):
    try:
        cap = int(os.environ.get("PADDLE_TPU_FEED_CACHE_CAP", default))
    except ValueError:
        cap = default
    return max(1, cap)


class FeedCache:
    """Bounded LRU placement cache for repeated feeds, keyed by
    ``(name, shape, dtype, content fingerprint)``.  A candidate hit is
    confirmed with an ``is`` identity check or a full ``np.array_equal``
    compare of the host arrays (the fingerprint only narrows, never
    decides); in-place mutation of a host array changes the fingerprint
    and misses.  The cached value is the staged tensor the executor only
    reads: a step copies feeds into its static inputs, and an eager step
    copies a fed tensor that an op writes in place.  Bounded by
    ``PADDLE_TPU_FEED_CACHE_CAP`` (default 64) with evictions counted in
    ``feed_cache_evictions_total``; ``PADDLE_TPU_FEED_CACHE=0`` disables
    it."""

    def __init__(self, cap=None):
        import collections

        self._entries = collections.OrderedDict()
        self._cap = _cache_cap() if cap is None else max(1, int(cap))
        self._lock = threading.Lock()

    @staticmethod
    def _fingerprint(a):
        n = a.size
        if n == 0:
            return (0,)
        flat = a.reshape(-1)
        sample = flat[:: max(1, n // 64)][:64]
        return sample.tobytes()

    def _key(self, name, a):
        return (name, a.shape, str(a.dtype), self._fingerprint(a))

    def get(self, name, host_value):
        if not _cache_enabled():
            return None
        from .observability import runtime as _obs

        key = self._key(name, host_value)
        with self._lock:
            e = self._entries.get(key)
            if e is not None and (e[0] is host_value
                                  or np.array_equal(e[0], host_value)):
                self._entries.move_to_end(key)
                _obs.record_feed_cache(True)
                return e[1]
        _obs.record_feed_cache(False)
        return None

    def put(self, name, host_value, device_value):
        if not _cache_enabled():
            return
        evicted = 0
        with self._lock:
            key = self._key(name, host_value)
            self._entries[key] = (host_value, device_value)
            self._entries.move_to_end(key)
            while len(self._entries) > self._cap:
                self._entries.popitem(last=False)
                evicted += 1
        if evicted:
            from .observability import runtime as _obs

            _obs.record_feed_cache_eviction(evicted)

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def clear(self):
        with self._lock:
            self._entries.clear()


def _put(value, device):
    """One host array → a tensor on ``device``: a pinned host copy and a
    ``non_blocking`` copy on the current stream for CUDA, a copy for the
    CPU."""
    from .ops.registry import np_to_torch

    host = np_to_torch(value, torch.device("cpu"))
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def _stage(value, device, name=None, cache=None):
    """One leaf host→device (numpy leaves only; tensors pass through
    untransferred, python values are left for the executor)."""
    if not isinstance(value, np.ndarray):
        return value
    if cache is not None and name is not None:
        hit = cache.get(name, value)
        if hit is not None:
            return hit
    dev = _put(value, device)
    if cache is not None and name is not None:
        cache.put(name, value, dev)
    return dev


def device_put_feed(feed, cache=None, place=None, keep_on_host=()):
    """Stage one feed item on the device of ``place`` (default
    ``CUDAPlace(0)``): dict (name→array) feeds cache by name, except the
    names in ``keep_on_host``, which pass through as they are; tuple/list
    items stage each ndarray leaf.  Anything else passes through.  On a
    CUDA device the copies are enqueued on the current stream."""
    from .core import as_torch_device

    device = place if isinstance(place, torch.device) \
        else as_torch_device(place)
    if isinstance(feed, dict):
        return {n: v if n in keep_on_host
                else _stage(v, device, name=n, cache=cache)
                for n, v in feed.items()}
    if isinstance(feed, (list, tuple)):
        return type(feed)(_stage(v, device) for v in feed)
    return _stage(feed, device)


def _leaves(item):
    if isinstance(item, dict):
        return list(item.values())
    if isinstance(item, (list, tuple)):
        return list(item)
    return [item]


class _PipeEnd:
    pass


class DeviceFeedPipeline:
    """Background prefetch + H2D staging of a feed stream.

    ``source``: an iterable of feed items (dicts/tuples of arrays) or a
    zero-arg callable returning one (a reader creator); ``place``: where
    the feeds go (default ``CUDAPlace(0)``; ``CPUPlace()`` for the CPU);
    ``keep_on_host``: dict names left as host arrays (the ids a
    host-resident table's prefetch reads on the host).
    A worker thread pulls items and stages each on a CUDA stream of its
    own into a depth-bounded queue with the event recorded after it, so
    while step k computes, batch k+1 (and up to ``depth-1`` more) is
    already on the device.  Handing an item out makes the consumer
    thread's current stream wait on that event and marks each staged
    tensor as used on that stream.  Worker exceptions re-raise in the
    consumer; ``stop()`` tears the current epoch down."""

    def __init__(self, source, depth=None, cache=None, place=None,
                 keep_on_host=()):
        from .core import as_torch_device

        self._keep = frozenset(keep_on_host)
        self._source = source
        self._depth = depth if depth is not None else pipeline_depth()
        self._cache = FeedCache() if cache is None else cache
        self._device = place if isinstance(place, torch.device) \
            else as_torch_device(place)
        self._active = None

    def _spawn(self):
        from .observability import tracing as _tr

        src = self._source() if callable(self._source) else self._source
        q = _queue.Queue(maxsize=max(1, int(self._depth)))
        stop = threading.Event()
        device = self._device
        # the staging thread's spans join the CONSUMER's trace
        ctx = _tr.capture_context()

        def put(item):
            # never block forever on a full queue: an abandoned consumer
            # sets `stop` and this worker must drop its staged batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        def stage(item):
            if device.type != "cuda":
                return _Staged(device_put_feed(
                    item, cache=self._cache, place=device,
                    keep_on_host=self._keep), None, device)
            with torch.cuda.stream(stream):
                staged = device_put_feed(item, cache=self._cache,
                                         place=device,
                                         keep_on_host=self._keep)
                ready = torch.cuda.Event()
                ready.record(stream)
            return _Staged(staged, ready, device)

        def worker():
            try:
                with _tr.use_context(ctx):
                    with _tr.span("pipeline.prefetch",
                                  depth=int(self._depth)) as pspan:
                        n = 0
                        for item in src:
                            if stop.is_set():
                                return
                            if not put(stage(item)):
                                return
                            n += 1
                        pspan.set_attr("items", n)
                    put(_PipeEnd)
            except BaseException as exc:  # propagate, never hang
                put(exc)

        stream = torch.cuda.Stream(device) if device.type == "cuda" \
            else None
        t = threading.Thread(target=worker, daemon=True,
                             name="paddle_tpu_torch-device-feed")
        t.start()
        return q, stop

    def start(self):
        """Begin prefetching ahead of iteration (optional — ``__iter__``
        starts an epoch on demand)."""
        if self._active is None:
            self._active = self._spawn()
        return self

    def stop(self):
        if self._active is not None:
            q, stop = self._active
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except _queue.Empty:
                pass
            self._active = None

    def __iter__(self):
        act = self._active or self._spawn()
        self._active = None
        q, stop = act
        from .observability import runtime as _obs

        try:
            while True:
                # occupancy sampled before the blocking get: 0 here means
                # the consumer is about to stall on the producer
                _obs.record_prefetch(q.qsize(), q.maxsize)
                item = q.get()
                if item is _PipeEnd:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item.hand_out()
        finally:
            stop.set()
            try:  # drop staged batches promptly on early abandonment
                while True:
                    q.get_nowait()
            except _queue.Empty:
                pass


class _Staged:
    """A staged feed item and the event recorded after its copies (None
    on the CPU)."""

    __slots__ = ("item", "ready", "device")

    def __init__(self, item, ready, device):
        self.item = item
        self.ready = ready
        self.device = device

    def hand_out(self):
        """Order the consumer thread's current stream after the staging
        and keep the staged buffers alive for the work it enqueues."""
        if self.ready is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(self.ready)
            for t in _leaves(self.item):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(cur)
        return self.item
