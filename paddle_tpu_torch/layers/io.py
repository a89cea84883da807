"""Data-layer front end (mirrors ``paddle_tpu/layers/io.py``: ``data``
:22 and the reader names ``py_reader`` :49, ``create_py_reader_by_data``
:71, ``read_file`` :82, ``double_buffer`` :91, ``batch`` :104,
``shuffle`` :111, ``random_data_generator`` :118, ``Preprocessor`` :134,
``open_files`` :159).  There is no graph-side read op: a reader's
batches are fed to each step, and ``read_file`` returns the data vars
they feed."""

from .. import core
from ..framework import default_main_program, default_startup_program

__all__ = ["data", "py_reader", "create_py_reader_by_data", "read_file",
           "double_buffer", "batch", "shuffle", "random_data_generator",
           "Preprocessor", "open_files"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         type=core.VarDesc.VarType.LOD_TENSOR, stop_gradient=True):
    """Declare an input variable fed at run time; with
    ``append_batch_size`` a leading -1 batch dim is added."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    var = default_main_program().current_block().create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        stop_gradient=stop_gradient, is_data=True, need_check_feed=True)
    # mirrored into the startup program so either program resolves it
    sb = default_startup_program().current_block()
    if not sb.has_var(name):
        sb.create_var(name=name, shape=shape, dtype=dtype,
                      lod_level=lod_level, stop_gradient=stop_gradient,
                      is_data=True)
    return var


def py_reader(capacity=64, shapes=None, dtypes=None, lod_levels=None,
              name=None, use_double_buffer=True):
    """Data vars of ``shapes`` / ``dtypes`` (the first dim of each shape
    is the batch) and a :class:`~paddle_tpu_torch.reader.PyReader` bound
    to them; ``read_file`` returns the vars, and the reader's
    ``decorate_*`` and iteration give their feeds."""
    from .. import unique_name
    from ..reader import PyReader

    shapes = shapes or []
    dtypes = dtypes or ["float32"] * len(shapes)
    feed_vars = []
    for i, (sh, dt) in enumerate(zip(shapes, dtypes)):
        nm = unique_name.generate((name or "py_reader") + "_slot%d" % i)
        feed_vars.append(data(nm, shape=list(sh)[1:], dtype=dt))
    reader = PyReader(feed_list=feed_vars, capacity=capacity,
                      use_double_buffer=use_double_buffer, iterable=True)
    reader._py_reader_vars = feed_vars
    return reader


def create_py_reader_by_data(capacity=64, feed_list=None, name=None,
                             use_double_buffer=True):
    from ..reader import PyReader

    reader = PyReader(feed_list=feed_list or [], capacity=capacity,
                      use_double_buffer=use_double_buffer, iterable=True)
    reader._py_reader_vars = list(feed_list or [])
    return reader


def read_file(reader):
    """The data vars a ``py_reader`` feeds (one var, or a list)."""
    vs = getattr(reader, "_py_reader_vars", None)
    if vs is None:
        raise ValueError("read_file expects a py_reader-created reader")
    return vs[0] if len(vs) == 1 else list(vs)


def double_buffer(reader, place=None, name=None):
    """``reader``'s items staged on the device of ``place`` (default
    ``CUDAPlace(0)``) from a background thread, depth
    ``PADDLE_TPU_PIPELINE_DEPTH`` (2): the next batch's copy overlaps the
    current step."""
    from .. import reader_decorators as rd

    return rd.device_buffered(reader, place=place)


def batch(reader, batch_size):
    from .. import reader_decorators as rd

    return rd.batch(reader, batch_size)


def shuffle(reader, buffer_size):
    from .. import reader_decorators as rd

    return rd.shuffle(reader, buffer_size)


def random_data_generator(low, high, shapes, lod_levels=None,
                          for_parallel=True):
    """A reader creator of uniform float32 tuples of ``shapes``, from
    ``RandomState(0)`` (the reference's draws)."""
    import numpy as np

    def reader():
        rng = np.random.RandomState(0)
        while True:
            yield tuple(rng.uniform(low, high, size=sh).astype("float32")
                        for sh in shapes)

    return reader


class Preprocessor:
    """A user transform over a reader's outputs, run on the host in the
    reader pipeline."""

    def __init__(self, reader, name=None):
        self.underlying = reader
        self._inputs = None
        self._outputs = None
        self._fn = None

    def block(self):
        import contextlib

        @contextlib.contextmanager
        def guard():
            yield self

        return guard()

    def inputs(self):
        return self._inputs

    def outputs(self, *outs):
        self._outputs = outs


def open_files(filenames=None, shapes=None, lod_levels=None, dtypes=None,
               thread_num=None, buffer_size=None, pass_num=1,
               is_test=None):
    """Graph-side RecordIO readers are replaced by the host pipeline, as
    in the reference: this raises with the way to do it."""
    raise NotImplementedError(
        "open_files: graph-side RecordIO readers are replaced by the "
        "host pipeline — read with reader_decorators.recordio (the native "
        "scanner) and feed through PyReader")
