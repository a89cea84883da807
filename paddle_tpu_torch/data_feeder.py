"""DataFeeder: user minibatch rows → feed arrays (mirrors
``paddle_tpu/data_feeder.py``, all of it; the reference's
``python/paddle/fluid/data_feeder.py``)."""

import numpy as np

from .framework import Variable

__all__ = ["DataFeeder"]


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None):
        self.feed_vars = []
        for v in feed_list:
            if isinstance(v, str):
                from .framework import default_main_program

                v = (program or default_main_program()).global_block().var(v)
            self.feed_vars.append(v)
        self.place = place

    def feed(self, iterable):
        """iterable of rows, each row a tuple with one entry per feed var."""
        columns = [[] for _ in self.feed_vars]
        for row in iterable:
            for i, item in enumerate(row):
                columns[i].append(np.asarray(item))
        out = {}
        for var, col in zip(self.feed_vars, columns):
            arr = np.stack(col)
            want = var.shape
            # reference feeders deliver labels as [N, 1]
            if want is not None and len(want) == arr.ndim + 1 and want[-1] == 1:
                arr = arr[..., None]
            if var.dtype is not None and var.dtype != "bfloat16":
                arr = arr.astype(var.dtype)
            out[var.name] = arr
        return out

    def feed_parallel(self, iterable, num_places=None):
        """reference DataFeeder.feed_parallel: one feed dict per place,
        the per-place splits of each mini-batch (a data-parallel rank
        feeds its own)."""
        for batch in iterable:
            fed = self.feed(batch)
            n = num_places or 1
            splits = {k: np.array_split(v, n) for k, v in fed.items()}
            yield [{k: splits[k][i] for k in splits} for i in range(n)]

    def decorate_reader(self, reader, multi_devices=False,
                        num_places=None, drop_last=True):
        """reference DataFeeder.decorate_reader: wrap a batch reader so it
        yields ready feed dicts."""

        def _reader():
            for batch in reader():
                if multi_devices:
                    n = num_places or 1
                    if drop_last and len(batch) % n:
                        continue
                    yield list(self.feed_parallel([batch], n))[0]
                else:
                    yield self.feed(batch)

        return _reader
