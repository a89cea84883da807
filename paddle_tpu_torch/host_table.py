"""Host-resident embedding tables: the bigger-than-device-memory CTR
tables (mirrors ``paddle_tpu/host_table.py``, all of it, with the
per-shard checkpoint helpers of ``paddle_tpu/io.py`` :98-180 that it
reads: ``_shard_fname``, ``_shard_entries``, ``_read_sharded_region``).

The table is a numpy array in this process's host memory; the card never
holds it.  Each step the executor (``executor.py``
``_host_table_prefetch``)

1. joins the previous step's update thread (``join``: the push of step
   k-1 overlaps the host work and enqueue of step k),
2. gathers the batch's rows into a dense ``[batch..., dim]`` slab, fed
   to the step as the ``is_data`` var ``host_embedding`` declared
   (``lookup``),
3. fetches the slab's gradient (one device-to-host copy a step, as the
   reference's ``np.asarray(fetches[gi])``) and hands it to a thread
   that sums duplicate ids and applies the table's own sparse rule, SGD
   or Adagrad (``update_async``).

Checkpoints use the per-shard layout of the reference's sharded device
checkpoints: row-range ``shard-r0_r1-0_D.npy`` files and ``meta.json``
under ``<name>.shards/``, with the Adagrad accumulator beside them, and
``load`` reshards from any row split of the same table.
"""

import json
import os
import threading
import zlib

import numpy as np

__all__ = ["HostTable", "get_table", "get_or_create", "reset_tables"]

_TABLES = {}


def reset_tables():
    """Drop all registered tables (test isolation)."""
    for t in _TABLES.values():
        t.join()
    _TABLES.clear()


def get_table(name):
    return _TABLES[name]


def get_or_create(name, rows, dim, dtype="float32", lr=0.1,
                  optimizer="sgd", initializer=None, seed=0):
    tab = _TABLES.get(name)
    if tab is None:
        tab = HostTable(name, rows, dim, dtype=dtype, lr=lr,
                        optimizer=optimizer, initializer=initializer,
                        seed=seed)
        _TABLES[name] = tab
    elif (tab.rows, tab.dim, tab.lr, tab.optimizer) != (
            int(rows), int(dim), float(lr), optimizer):
        raise ValueError(
            "host table %r already exists with (rows=%d, dim=%d, lr=%g, "
            "optimizer=%s); requested (%d, %d, %g, %s) — call "
            "host_table.reset_tables() to rebuild"
            % (name, tab.rows, tab.dim, tab.lr, tab.optimizer,
               int(rows), int(dim), float(lr), optimizer))
    return tab


def _shard_fname(bounds):
    return "shard-" + "-".join("%d_%d" % b for b in bounds) + ".npy"


def _shard_entries(shard_dir, meta):
    """(bounds, path) of each shard file that ``meta`` lists (every
    ``shard-*.npy`` of the directory when it lists none)."""
    names = meta.get("files")
    if names is None:
        names = [f for f in os.listdir(shard_dir)
                 if f.startswith("shard-") and f.endswith(".npy")]
    entries = []
    for fname in names:
        fb = tuple(tuple(int(x) for x in part.split("_"))
                   for part in fname[len("shard-"):-len(".npy")].split("-"))
        entries.append((fb, os.path.join(shard_dir, fname)))
    return entries


def _read_sharded_region(entries, meta, bounds, name):
    """The ``bounds`` region assembled from the shard files overlapping
    it; a region the files do not cover raises."""
    from .io import _load_array

    region = np.zeros([b[1] - b[0] for b in bounds],
                      dtype=np.dtype(meta["dtype"]))
    covered = np.zeros(region.shape, dtype=bool)
    for fb, path in entries:
        overlap = [(max(a0, b0), min(a1, b1))
                   for (a0, a1), (b0, b1) in zip(fb, bounds)]
        if any(o0 >= o1 for o0, o1 in overlap):
            continue
        if not os.path.exists(path):
            raise RuntimeError(
                "sharded checkpoint for %r is missing %s — all shard "
                "files listed in meta.json must be reachable" % (name, path))
        data = _load_array(path, name)
        src = tuple(slice(o0 - f0, o1 - f0)
                    for (o0, o1), (f0, _) in zip(overlap, fb))
        dst = tuple(slice(o0 - b0, o1 - b0)
                    for (o0, o1), (b0, _) in zip(overlap, bounds))
        region[dst] = data[src]
        covered[dst] = True
    if not covered.all():
        raise RuntimeError(
            "sharded checkpoint for %r does not cover region %s — the "
            "meta.json shard list leaves gaps" % (name, bounds))
    return region


class HostTable:
    def __init__(self, name, rows, dim, dtype="float32", lr=0.1,
                 optimizer="sgd", initializer=None, seed=0):
        self.name = name
        self.rows = int(rows)
        self.dim = int(dim)
        self.lr = float(lr)
        self.optimizer = optimizer
        if optimizer not in ("sgd", "adagrad"):
            raise ValueError("host table optimizer must be sgd or adagrad")
        if initializer is not None:
            self.value = np.asarray(initializer, dtype).reshape(
                self.rows, self.dim)
        else:
            # uniform in [-0.05, 0.05) from (crc32(name) ^ seed): every
            # process builds the same table, and the same numbers as the
            # reference's
            rng = np.random.RandomState(
                (zlib.crc32(name.encode()) ^ seed) & 0x7FFFFFFF)
            self.value = rng.uniform(
                -0.05, 0.05, (self.rows, self.dim)).astype(dtype)
        self._accum = None
        if optimizer == "adagrad":
            self._accum = np.zeros((self.rows, self.dim), "float32")
        self._pending = None

    # ---- step-time path ------------------------------------------------

    def join(self):
        """Wait for the update in flight (``lookup`` calls it first)."""
        t = self._pending
        if t is not None:
            t.join()
            self._pending = None

    def lookup(self, ids):
        """The rows of ``ids`` (any int shape, clipped to the table) as
        ``ids.shape + (dim,)``."""
        self.join()
        idx = np.asarray(ids).astype(np.int64)
        flat = np.clip(idx.reshape(-1), 0, self.rows - 1)
        return self.value[flat].reshape(idx.shape + (self.dim,))

    def update_async(self, ids, slab_grad):
        """Apply the slab's gradient on a background thread; duplicate ids
        are summed before the rule, so the result is a dense
        scatter-add update's."""
        self.join()
        idx = np.clip(np.asarray(ids).astype(np.int64).reshape(-1),
                      0, self.rows - 1)
        g = np.asarray(slab_grad, np.float32).reshape(idx.shape[0],
                                                      self.dim)
        t = threading.Thread(target=self._apply, args=(idx, g),
                             daemon=True)
        self._pending = t
        t.start()

    def _apply(self, idx, g):
        uniq, inv = np.unique(idx, return_inverse=True)
        agg = np.zeros((uniq.shape[0], self.dim), np.float32)
        np.add.at(agg, inv, g)
        if self.optimizer == "sgd":
            self.value[uniq] -= (self.lr * agg).astype(self.value.dtype)
        else:  # the reference's sparse adagrad
            self._accum[uniq] += agg * agg
            self.value[uniq] -= (
                self.lr * agg / (np.sqrt(self._accum[uniq]) + 1e-6)
            ).astype(self.value.dtype)

    # ---- checkpoint ----------------------------------------------------

    def _shard_dir(self, dirname):
        return os.path.join(dirname, self.name.replace("/", "_")
                            + ".shards")

    def has_checkpoint(self, dirname):
        return os.path.isdir(self._shard_dir(dirname))

    def save(self, dirname, rows_per_shard=None):
        """Row-range shard files, ``meta.json`` (written last, by rename)
        and the Adagrad accumulator."""
        self.join()  # never snapshot mid-update
        shard_dir = self._shard_dir(dirname)
        os.makedirs(shard_dir, exist_ok=True)
        step = int(rows_per_shard or max(1, min(self.rows, 1 << 20)))
        files = []
        for r0 in range(0, self.rows, step):
            r1 = min(r0 + step, self.rows)
            fname = _shard_fname(((r0, r1), (0, self.dim)))
            np.save(os.path.join(shard_dir, fname), self.value[r0:r1])
            files.append(fname)
        if self._accum is not None:
            np.save(os.path.join(shard_dir, "adagrad_accum.npy"),
                    self._accum)
        meta_tmp = os.path.join(shard_dir,
                                ".meta.json.tmp.%d" % os.getpid())
        with open(meta_tmp, "w") as f:
            json.dump({"shape": [self.rows, self.dim],
                       "dtype": str(self.value.dtype),
                       "files": files}, f)
        os.replace(meta_tmp, os.path.join(shard_dir, "meta.json"))

    def load(self, dirname):
        """The table from any shard layout of the same global shape."""
        self.join()
        shard_dir = self._shard_dir(dirname)
        with open(os.path.join(shard_dir, "meta.json")) as f:
            meta = json.load(f)
        if list(meta["shape"]) != [self.rows, self.dim]:
            raise ValueError(
                "checkpointed table %s has shape %s, expected %s"
                % (self.name, meta["shape"], [self.rows, self.dim]))
        entries = _shard_entries(shard_dir, meta)
        self.value = np.asarray(_read_sharded_region(
            entries, meta, ((0, self.rows), (0, self.dim)), self.name),
            dtype=self.value.dtype)
        if self._accum is not None:
            apath = os.path.join(shard_dir, "adagrad_accum.npy")
            # a checkpoint without the accumulator restarts the history
            self._accum = (np.load(apath) if os.path.exists(apath)
                           else np.zeros((self.rows, self.dim), "float32"))
