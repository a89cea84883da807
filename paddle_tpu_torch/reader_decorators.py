"""Reader decorators (mirrors ``paddle_tpu/reader_decorators.py``, all of
it; the reference's ``python/paddle/reader/decorator.py`` — cache,
map_readers, shuffle, chain, compose, buffered, firstn, xmap_readers,
multiprocess_reader — its ``reader/creator.py`` and
``python/paddle/batch.py``).

A *reader creator* is a zero-arg callable returning an iterator of
samples; decorators wrap creators.  The threaded variants use threads
(not processes): the consumer feeds a step that runs on the card, so
the GIL is free while it runs.  ``shuffle`` draws from Python's
``random`` module, as the reference, so a seeded ``random`` gives both
packages the same order; ``xmap_readers(order=True)`` keeps the input
order."""

import itertools
import queue as _queue
import random as _random
import threading

__all__ = [
    "cache", "map_readers", "shuffle", "chain", "compose", "buffered",
    "device_buffered", "firstn", "xmap_readers", "batch",
    "ComposeNotAligned", "multiprocess_reader", "Fake", "PipeReader",
    "np_array", "text_file", "recordio",
]


class ComposeNotAligned(ValueError):
    pass


def cache(reader):
    """Cache the first *complete* pass in memory; later passes replay it.
    A partially consumed pass is discarded (not mixed into a later one)."""
    all_data = []
    filled = []

    def impl():
        if not filled:
            fresh = []
            for item in reader():
                fresh.append(item)
                yield item
            all_data[:] = fresh
            filled.append(True)
        else:
            for item in all_data:
                yield item

    return impl


def map_readers(func, *readers):
    """Zip readers, map func over the per-reader samples."""

    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return reader


def shuffle(reader, buf_size):
    """Buffered shuffle (reference decorator.py:82)."""

    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            _random.shuffle(buf)
            for b in buf:
                yield b

    return data_reader


def chain(*readers):
    """Concatenate readers end to end."""

    def reader():
        for r in readers:
            for item in r():
                yield item

    return reader


def compose(*readers, **kwargs):
    """Zip readers into flat tuples: (a, b1, b2) from ((a,), (b1, b2)).
    check_alignment=True (default) raises ComposeNotAligned on length
    mismatch."""
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        if check_alignment:
            for outputs in itertools.zip_longest(*rs):
                if any(o is None for o in outputs):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned")
                yield sum((make_tuple(o) for o in outputs), ())
        else:
            for outputs in zip(*rs):
                yield sum((make_tuple(o) for o in outputs), ())

    return reader


def buffered(reader, size):
    """Background-thread prefetch of up to `size` samples.  Reader
    exceptions propagate to the consumer (instead of hanging the queue)."""

    class _End:
        pass

    def data_reader():
        r = reader()
        q = _queue.Queue(maxsize=size)

        def read_worker():
            try:
                for d in r:
                    q.put(d)
                q.put(_End)
            except BaseException as exc:  # propagate to consumer
                q.put(exc)

        t = threading.Thread(target=read_worker, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is _End:
                return
            if isinstance(e, BaseException):
                raise e
            yield e

    return data_reader


def device_buffered(reader, size=None, place=None):
    """Background-thread prefetch that also stages each item's numpy
    arrays on the device of ``place`` (default ``CUDAPlace(0)``;
    ``CPUPlace()`` for the CPU) off the consumer thread — ``double_buffer``:
    batch k+1's host-to-device copy overlaps step k.  ``size`` defaults
    to ``PADDLE_TPU_PIPELINE_DEPTH`` (2).  Items may be dicts (feed
    name→array; placement cached for repeated arrays), tuples/lists of
    arrays, or bare arrays; non-array leaves pass through.  Reader
    exceptions propagate to the consumer (the ``buffered`` contract)."""
    from .pipeline import DeviceFeedPipeline

    def data_reader():
        return iter(DeviceFeedPipeline(reader, depth=size, place=place))

    return data_reader


def firstn(reader, n):
    def firstn_reader():
        for i, item in enumerate(reader()):
            if i == n:
                return
            yield item

    return firstn_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map with `process_num` worker threads (reference uses
    threads too despite the name); ``order=True`` yields in the input's
    order."""

    end = object()

    def data_reader():
        in_q = _queue.Queue(buffer_size)
        out_q = _queue.Queue(buffer_size)

        def feed():
            try:
                for i, sample in enumerate(reader()):
                    in_q.put((i, sample))
            except BaseException as exc:
                out_q.put(exc)
            finally:
                for _ in range(process_num):
                    in_q.put(end)

        def work():
            while True:
                item = in_q.get()
                if item is end:
                    out_q.put(end)
                    return
                i, sample = item
                try:
                    out_q.put((i, mapper(sample)))
                except BaseException as exc:
                    out_q.put(exc)
                    out_q.put(end)
                    return

        threading.Thread(target=feed, daemon=True).start()
        workers = [threading.Thread(target=work, daemon=True)
                   for _ in range(process_num)]
        for w in workers:
            w.start()

        finished = 0
        if order:
            pending = {}
            want = 0
            while finished < process_num:
                item = out_q.get()
                if item is end:
                    finished += 1
                    continue
                if isinstance(item, BaseException):
                    raise item
                i, mapped = item
                pending[i] = mapped
                while want in pending:
                    yield pending.pop(want)
                    want += 1
            assert not pending, "xmap order protocol violated"
        else:
            while finished < process_num:
                item = out_q.get()
                if item is end:
                    finished += 1
                    continue
                if isinstance(item, BaseException):
                    raise item
                yield item[1]

    return data_reader


def batch(reader, batch_size, drop_last=False):
    """Group samples into lists of `batch_size` (reference batch.py)."""

    def batch_reader():
        b = []
        for instance in reader():
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Merge samples from several readers, each driven by its own OS
    process (reference decorator.py:441).  Queue mode uses a shared
    multiprocessing.Queue; pipe mode one Pipe per reader with samples
    JSON-framed, exactly the reference's two transports.  Samples must
    be picklable (queue) / JSON-able (pipe)."""
    import multiprocessing

    if not isinstance(readers, list) or not readers:
        raise AssertionError("readers must be a non-empty list")

    # error sentinel: a child that dies without its end-sentinel would
    # deadlock the parent's blocking get (same propagate-don't-hang
    # contract as `buffered` above, crossing a process boundary)
    _ERR = "__multiprocess_reader_error__"

    def _read_into_queue(reader, q):
        try:
            for sample in reader():
                if sample is None:
                    raise ValueError("sample has None")
                q.put(sample)
            q.put(None)
        except BaseException as exc:  # noqa: BLE001 - must reach parent
            q.put((_ERR, repr(exc)))

    def queue_reader():
        q = multiprocessing.Queue(queue_size)
        procs = [
            multiprocessing.Process(
                target=_read_into_queue, args=(r, q), daemon=True)
            for r in readers
        ]
        for p in procs:
            p.start()
        finished = 0
        while finished < len(readers):
            try:
                sample = q.get(timeout=5)
            except _queue.Empty:
                # a child killed outright (OOM/SIGKILL) never sends any
                # sentinel — detect the dead-and-drained state instead
                # of blocking forever
                if any(not p.is_alive() and p.exitcode not in (0, None)
                       for p in procs) and q.empty():
                    for p in procs:
                        p.terminate()
                    raise RuntimeError(
                        "multiprocess_reader child killed (exitcodes %s)"
                        % [p.exitcode for p in procs])
                continue
            if sample is None:
                finished += 1
            elif isinstance(sample, tuple) and len(sample) == 2 \
                    and sample[0] == _ERR:
                for p in procs:
                    p.terminate()
                raise RuntimeError(
                    "multiprocess_reader child failed: %s" % sample[1])
            else:
                yield sample
        for p in procs:
            p.join()

    def _read_into_pipe(reader, conn):
        import json

        try:
            for sample in reader():
                if sample is None:
                    raise ValueError("sample has None")
                conn.send(json.dumps(sample))
            conn.send(json.dumps(None))
        except BaseException as exc:  # noqa: BLE001 - must reach parent
            try:
                conn.send(json.dumps({_ERR: repr(exc)}))
            except (OSError, TypeError, ValueError):
                pass
        finally:
            conn.close()

    def pipe_reader():
        import json

        conns = []
        procs = []
        for r in readers:
            parent, child = multiprocessing.Pipe()
            conns.append(parent)
            p = multiprocessing.Process(
                target=_read_into_pipe, args=(r, child), daemon=True)
            procs.append(p)
            p.start()
        live = list(conns)
        finished = 0
        while finished < len(readers):
            for conn in list(live):
                try:
                    sample = json.loads(conn.recv())
                except EOFError:
                    for p in procs:
                        p.terminate()
                    raise RuntimeError(
                        "multiprocess_reader child died without its end "
                        "sentinel (crashed before sending error)")
                if sample is None:
                    finished += 1
                    conn.close()
                    live.remove(conn)
                elif isinstance(sample, dict) and _ERR in sample:
                    for p in procs:
                        p.terminate()
                    raise RuntimeError(
                        "multiprocess_reader child failed: %s"
                        % sample[_ERR])
                else:
                    yield sample
        for p in procs:
            p.join()

    return pipe_reader if use_pipe else queue_reader


class Fake:
    """Cache the first sample and replay it data_num times (reference
    decorator.py:531) — isolates input-pipeline cost for speed tests."""

    def __init__(self):
        self.data = None
        self.yield_num = 0

    def __call__(self, reader, data_num):
        def fake_reader():
            if self.data is None:
                self.data = next(reader())
            while self.yield_num < data_num:
                yield self.data
                self.yield_num += 1
            self.yield_num = 0

        return fake_reader


class PipeReader:
    """Stream a shell command's stdout and yield decoded lines
    (reference decorator.py:388) — the HDFS/S3/curl ingestion path.
    gzip file_type inflates on the fly."""

    def __init__(self, command, bufsize=8192, file_type="plain"):
        import shlex
        import subprocess
        import zlib

        if not isinstance(command, str):
            raise TypeError("command must be a string")
        if file_type not in ("plain", "gzip"):
            raise TypeError("file_type %s is not allowed" % file_type)
        if file_type == "gzip":
            # wbits offset 32: auto-detect gzip header
            self.dec = zlib.decompressobj(32 + zlib.MAX_WBITS)
        self.file_type = file_type
        self.bufsize = bufsize
        self.process = subprocess.Popen(
            shlex.split(command), bufsize=bufsize, stdout=subprocess.PIPE)

    def get_line(self, cut_lines=True, line_break="\n"):
        remained = ""
        while True:
            buff = self.process.stdout.read(self.bufsize)
            if buff:
                if self.file_type == "gzip":
                    decomp = self.dec.decompress(buff).decode(
                        "utf-8", "replace")
                else:
                    decomp = buff.decode("utf-8", "replace")
                if cut_lines:
                    parts = (remained + decomp).split(line_break)
                    remained = parts[-1]
                    for line in parts[:-1]:
                        yield line
                else:
                    yield decomp
            else:
                break
        if remained:
            yield remained


# ---------------------------------------------------------------------------
# reader creators (reference: python/paddle/reader/creator.py)
# ---------------------------------------------------------------------------


def np_array(x):
    """Creator from a numpy array: yields one row per sample
    (reference creator.py:22)."""
    import numpy as _np

    x = _np.asarray(x)
    if x.ndim < 1:
        raise ValueError("np_array needs at least a 1-D array")

    def reader():
        for row in x:
            yield row

    return reader


def text_file(path):
    """Creator yielding stripped lines of a text file
    (reference creator.py:42)."""

    def reader():
        with open(path) as f:
            for line in f:
                yield line.rstrip("\n")

    return reader


def recordio(paths, buf_size=100):
    """Creator over RecordIO file(s) (reference creator.py:63 reads via
    the recordio client); here the native-or-python reader from
    recordio_writer.  Accepts a path, comma-joined paths, or a list."""
    if isinstance(paths, str):
        paths = paths.split(",")

    def reader():
        from .recordio_writer import recordio_reader

        for p in paths:
            for rec in recordio_reader(p)():
                yield rec

    # reference parity: reads are prefetched through the buffered
    # decorator with the caller's buf_size
    return buffered(reader, buf_size)
