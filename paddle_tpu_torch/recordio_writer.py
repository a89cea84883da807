"""RecordIO conversion helpers (mirrors ``paddle_tpu/recordio_writer.py``,
all of it; the reference's ``python/paddle/fluid/recordio_writer.py``).

A record holds one sample, a tuple of arrays, as an npz archive, over
the chunked writer of ``native/src/recordio.cc``: a file either package
writes, the other reads."""

import io

import numpy as np

from . import native

__all__ = [
    "convert_reader_to_recordio_file",
    "convert_reader_to_recordio_files",
    "recordio_reader",
]


def _pack(sample):
    buf = io.BytesIO()
    arrays = {("f%d" % i): np.asarray(a) for i, a in enumerate(sample)}
    np.savez(buf, **arrays)
    return buf.getvalue()


def _unpack(record):
    with np.load(io.BytesIO(record)) as z:
        return tuple(z["f%d" % i] for i in range(len(z.files)))


def convert_reader_to_recordio_file(filename, reader_creator, feeder=None,
                                    compressor=None, max_num_records=1000):
    """Writes every sample from ``reader_creator()`` into ``filename``.
    Returns the number of records written."""
    count = 0
    with native.RecordIOWriter(filename,
                               max_chunk_records=max_num_records) as w:
        for sample in reader_creator():
            if not isinstance(sample, (tuple, list)):
                sample = (sample,)
            w.write(_pack(sample))
            count += 1
    return count


def recordio_reader(filename):
    """Reader creator yielding the samples stored in ``filename``."""

    def reader():
        with native.RecordIOScanner(filename) as s:
            for record in s:
                yield _unpack(record)

    return reader


def convert_reader_to_recordio_files(
        filename, batch_per_file, reader_creator, feeder=None,
        compressor=None, max_num_records=1000):
    """Multi-file variant (reference recordio_writer.py): split the
    stream into files of ``batch_per_file`` records named
    ``filename-00000`` etc.  Returns the list of paths written."""
    paths = []
    buf = []

    def flush():
        if not buf:
            return
        path = "%s-%05d" % (filename, len(paths))
        with native.RecordIOWriter(
                path, max_chunk_records=max_num_records) as w:
            for s in buf:
                w.write(_pack(s))
        paths.append(path)
        buf.clear()

    for sample in reader_creator():
        if not isinstance(sample, (tuple, list)):
            sample = (sample,)
        buf.append(sample)
        if len(buf) >= batch_per_file:
            flush()
    flush()
    return paths
