"""Datasets (mirrors ``paddle_tpu/dataset.py``, all of it; the
reference's ``python/paddle/fluid/dataset.py`` facades over the C++
``framework/data_set.h:40`` Dataset / MultiSlotDataset and the
``data_feed.h`` MultiSlot parsers feeding trainer threads).

Files are parsed into padded numpy slot arrays on the host (the native
MultiSlot parser of :mod:`.native`, over a thread pool, or its Python
twin), a batch is a slice (or, loaded and shuffled, a gather) of those
arrays, and ``Executor.train_from_dataset`` stages it on the card
ahead of the step (:mod:`.dataset_runtime`).  The reference splits the
arrays into per-example lists and stacks each batch back; the batches
are the same.  The MultiSlot text format
(one example a line: per slot ``<n> id...`` or ``<n> v v ...``) is
parsed as in ``data_feed.cc``; a ragged slot is padded with zeros or
clipped to its var's declared length (the step's shapes are static).
``InMemoryDataset.local_shuffle`` shuffles with ``random.Random(seed)``,
as the reference, so both packages give the same batches."""

import os
import random

import numpy as np

__all__ = ["DatasetFactory", "DatasetBase", "InMemoryDataset",
           "QueueDataset"]


class DatasetFactory:
    def create_dataset(self, datafeed_class="QueueDataset"):
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        if datafeed_class == "QueueDataset":
            return QueueDataset()
        raise ValueError("unknown dataset class %r" % datafeed_class)


class DatasetBase:
    def __init__(self):
        self.proto_desc_pipe_command = "cat"
        self.batch_size = 1
        self.filelist = []
        self.use_vars = []
        self.thread_num = 1
        self.hdfs_config = None
        self._shuffle_seed = 0

    # ---- reference config surface ----
    def set_pipe_command(self, pipe_command):
        self.proto_desc_pipe_command = pipe_command

    def set_batch_size(self, batch_size):
        self.batch_size = int(batch_size)

    def set_thread(self, thread_num):
        self.thread_num = int(thread_num)

    def set_filelist(self, filelist):
        self.filelist = list(filelist)

    def set_use_var(self, var_list):
        self.use_vars = list(var_list)

    def set_hdfs_config(self, fs_name, fs_ugi):
        self.hdfs_config = (fs_name, fs_ugi)

    def desc(self):
        return {
            "pipe_command": self.proto_desc_pipe_command,
            "batch_size": self.batch_size,
            "thread_num": self.thread_num,
        }

    # ---- parsing ----
    def _slot_len(self, var):
        shape = var.shape or (-1, 1)
        inner = 1
        for d in shape[1:]:
            inner *= abs(d)
        return max(inner, 1)

    def _to_feed(self, columns):
        """A batch's per-var [n, L] arrays → the feed, each shaped as its
        var."""
        feed = {}
        for var, arr in zip(self.use_vars, columns):
            shape = var.shape or ()
            if len(shape) > 1:
                arr = arr.reshape((arr.shape[0],) + tuple(
                    abs(d) for d in shape[1:]))
            feed[var.name] = arr
        return feed

    def _batches_from_files(self):
        """Batches in file order, a batch spanning a file boundary as the
        reference's example stream does; the last one may be short."""
        bs = self.batch_size
        carry = None
        for path in self.filelist:
            arrays = self._native_file_arrays(path)
            if carry is not None:
                arrays = [np.concatenate([c, a])
                          for c, a in zip(carry, arrays)]
            n = arrays[0].shape[0] if arrays else 0
            full = n - n % bs
            for s0 in range(0, full, bs):
                yield self._to_feed([a[s0:s0 + bs] for a in arrays])
            carry = [a[full:] for a in arrays]
        if carry and carry[0].shape[0]:
            yield self._to_feed(carry)

    def _native_file_arrays(self, path):
        """Parse one file with the MultiSlot parser (C++ thread pool when
        available, else its Python twin: :mod:`.native`) into per-slot
        [N, L] arrays."""
        from . import native

        types = ["uint64" if v.dtype in ("int64", "int32") else "float"
                 for v in self.use_vars]
        lens = [self._slot_len(v) for v in self.use_vars]
        return native.parse_multislot_file(path, types, lens,
                                           threads=self.thread_num)

    def batch_iterator(self):
        return self._batches_from_files()


class QueueDataset(DatasetBase):
    """Streams files (reference dataset.py QueueDataset)."""

    def local_shuffle(self):
        raise NotImplementedError(
            "QueueDataset streams; use InMemoryDataset for shuffling "
            "(same restriction as the reference)"
        )

    def global_shuffle(self, fleet=None):
        raise NotImplementedError(
            "QueueDataset streams; use InMemoryDataset for shuffling"
        )


class InMemoryDataset(DatasetBase):
    """Loads, shuffles in memory (reference dataset.py InMemoryDataset;
    global_shuffle's cross-worker exchange maps to per-worker filelist
    sharding + local shuffle)."""

    def __init__(self):
        super().__init__()
        self._arrays = []   # per var: every loaded example's [L] row
        self._order = []    # the examples' order (shuffled in place)
        self._loaded = False

    def load_into_memory(self):
        chunks = [self._native_file_arrays(p) for p in self.filelist]
        self._arrays = [np.concatenate(c) for c in zip(*chunks)]
        self._order = list(range(self._arrays[0].shape[0]
                                 if self._arrays else 0))
        self._loaded = True

    def local_shuffle(self):
        """The reference's ``random.Random(seed).shuffle`` of the loaded
        examples, applied to their indices: the same permutation."""
        if not self._loaded:
            raise RuntimeError("call load_into_memory() first")
        random.Random(self._shuffle_seed).shuffle(self._order)

    def global_shuffle(self, fleet=None, thread_num=12):
        if fleet is not None:
            self.filelist = fleet.split_files(self.filelist)
            self.load_into_memory()
        self.local_shuffle()

    def release_memory(self):
        self._arrays, self._order = [], []
        self._loaded = False

    def get_memory_data_size(self, fleet=None):
        return len(self._order)

    def get_shuffle_data_size(self, fleet=None):
        return len(self._order)

    def batch_iterator(self):
        if self._loaded:
            return self._batches_from_memory()
        return super().batch_iterator()

    def _batches_from_memory(self):
        order = np.asarray(self._order, dtype=np.int64)
        for s0 in range(0, order.shape[0], self.batch_size):
            idx = order[s0:s0 + self.batch_size]
            yield self._to_feed([a[idx] for a in self._arrays])
