"""Host input pipeline: ``PyReader`` and ``DataLoader.from_generator``
(mirrors ``paddle_tpu/reader.py``, all of it; the reference's
``python/paddle/fluid/reader.py`` PyReader → background thread →
LoDTensorBlockingQueue → read op).

A background thread assembles batches into a bounded queue (the user's
``capacity``); with ``use_double_buffer`` (the default, as the
reference's ``double_buffer``) a :class:`~.pipeline.DeviceFeedPipeline`
also stages the front ``PADDLE_TPU_PIPELINE_DEPTH`` (default 2) of them
on the card from its own thread, so the executor's step never waits on
a host-to-device copy.  The device is the first of the ``places``
given to ``decorate_*`` (default ``CUDAPlace(0)``, which raises where
there is no CUDA device; pass ``CPUPlace()`` for the CPU).  In-process
batches pass by reference through a ``queue.Queue``; the native
byte-buffer queue (``native.BlockingQueue``) serves the serialized,
cross-process role of the reference's LoDTensorBlockingQueue."""

import queue as _queue
import threading

import numpy as np

__all__ = ["PyReader", "DataLoader"]

_SENTINEL = "__paddle_tpu_epoch_end__"


class _Prefetcher:
    def __init__(self, gen_fn, capacity):
        self.gen_fn = gen_fn
        self.capacity = capacity
        self.queue = None
        self.thread = None
        self._stop = threading.Event()

    def start(self):
        self.queue = _queue.Queue(maxsize=self.capacity)
        self._stop.clear()

        def worker():
            try:
                for item in self.gen_fn():
                    if self._stop.is_set():
                        return
                    self.queue.put(item)
            finally:
                self.queue.put(_SENTINEL)  # end-of-epoch sentinel

        self.thread = threading.Thread(target=worker, daemon=True)
        self.thread.start()

    def stop(self):
        self._stop.set()
        if self.queue is not None:
            try:
                while True:
                    self.queue.get_nowait()
            except _queue.Empty:
                pass

    def __iter__(self):
        while True:
            item = self.queue.get()
            if isinstance(item, str) and item == _SENTINEL:
                return
            yield item


class _DeviceStagedPrefetcher:
    """``capacity`` host batches buffered by the background thread, the
    front ``PADDLE_TPU_PIPELINE_DEPTH`` of them staged on the device."""

    def __init__(self, gen_fn, capacity, place):
        from .pipeline import DeviceFeedPipeline

        self._host = _Prefetcher(gen_fn, capacity)
        self._dev = DeviceFeedPipeline(lambda: iter(self._host),
                                       place=place)

    def start(self):
        self._host.start()
        self._dev.start()

    def stop(self):
        self._dev.stop()
        self._host.stop()

    def __iter__(self):
        return iter(self._dev)


class PyReader:
    """Iterable/decorated reader (reference reader.py:46).  Use
    ``decorate_sample_list_generator``/``decorate_batch_generator`` then
    iterate: each item is a feed dict."""

    def __init__(self, feed_list=None, capacity=16, use_double_buffer=True,
                 iterable=True, return_list=False):
        self._feed_list = feed_list or []
        self._capacity = capacity
        self._iterable = iterable
        self._use_double_buffer = bool(use_double_buffer)
        self._prefetcher = None
        self._feeder = None
        self._place = None

    def _set_places(self, places):
        if places is not None:
            if isinstance(places, (list, tuple)):
                places = places[0] if places else None
            self._place = places

    def decorate_sample_list_generator(self, reader, places=None):
        from .data_feeder import DataFeeder

        self._set_places(places)
        feeder = DataFeeder(self._feed_list, places)

        def gen():
            for batch in reader():
                yield feeder.feed(batch)

        self._gen = gen
        return self

    def decorate_batch_generator(self, reader, places=None):
        self._set_places(places)

        def gen():
            for batch in reader():
                if isinstance(batch, dict):
                    yield batch
                else:
                    yield {v.name: np.asarray(b)
                           for v, b in zip(self._feed_list, batch)}

        self._gen = gen
        return self

    decorate_paddle_reader = decorate_sample_list_generator

    def decorate_sample_generator(self, sample_generator, batch_size,
                                  drop_last=True, places=None):
        """Batch a per-sample generator, then feed (reference
        PyReader.decorate_sample_generator)."""

        def batched():
            buf = []
            for sample in sample_generator():
                buf.append(sample)
                if len(buf) == batch_size:
                    yield buf
                    buf = []
            if buf and not drop_last:
                yield buf

        return self.decorate_sample_list_generator(batched, places)

    def start(self):
        if self._use_double_buffer:
            self._prefetcher = _DeviceStagedPrefetcher(
                self._gen, self._capacity, self._place)
        else:
            self._prefetcher = _Prefetcher(self._gen, self._capacity)
        self._prefetcher.start()

    def reset(self):
        if self._prefetcher:
            self._prefetcher.stop()
        self._prefetcher = None

    def __iter__(self):
        if self._prefetcher is None:
            self.start()
        p = self._prefetcher
        self._prefetcher = None
        return iter(p)


class DataLoader:
    @staticmethod
    def from_generator(feed_list=None, capacity=16, use_double_buffer=True,
                       iterable=True, return_list=False):
        return PyReader(feed_list, capacity, use_double_buffer, iterable,
                        return_list)
