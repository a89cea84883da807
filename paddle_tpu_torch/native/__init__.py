"""The host data plane in C++, loaded with ``ctypes`` (mirrors
``paddle_tpu/native/__init__.py``, all of it, over the port's own copy of
``src/recordio.cc``, ``src/multislot.cc`` and ``src/blocking_queue.cc``).

RecordIO (the reference's ``paddle/fluid/recordio/``), the MultiSlot
text parser (``framework/data_feed.cc``) and the bounded byte-buffer
reader queue (``framework/blocking_queue.h``) are host code: they parse
and queue batches on the CPU, and are no device kernel.  The library is
compiled by ``g++`` at first use, never at import, into
``paddle_tpu_torch/_build/native-<hash>/`` (keyed by a hash of the
sources and flags), under the exclusive lock the CUDA kernels' build
takes (``ops/cuda/_lib.py`` ``build_once``), so several processes that
start at once build it once; nothing is written beside the sources.
Every entry point has a pure-Python twin with the same semantics, used
where no ``g++`` is found or the build fails, as in the reference;
:func:`is_native` says which one runs.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src")
_SOURCES = ["recordio.cc", "multislot.cc", "blocking_queue.cc"]
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++14", "-pthread")

_lib = None
_lib_lock = threading.Lock()
_build_attempted = False


def library_path():
    """Where the library is built: ``_build/native-<hash of the sources
    and flags>/libpaddle_tpu_native.so`` under the package."""
    from ..ops.cuda._lib import BUILD_ROOT

    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in _SOURCES:
        h.update(s.encode())
        with open(os.path.join(_SRC, s), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, "native-" + h.hexdigest()[:16],
                        "libpaddle_tpu_native.so")


def _compile(work):
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    so = os.path.join(work, "libpaddle_tpu_native.so")
    subprocess.run([gxx, *_FLAGS, "-o", so]
                   + [os.path.join(_SRC, s) for s in _SOURCES],
                   check=True, capture_output=True, timeout=120)
    return so


def _build():
    """The library's path, built now if needed; None when it cannot be
    built here."""
    from ..ops.cuda._lib import build_once

    try:
        return build_once(library_path(), _compile)
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None


def get_lib():
    """The loaded ctypes library, built on the first call; None if native
    support is unavailable (the Python twins run)."""
    global _lib, _build_attempted
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _build_attempted:
            return None
        _build_attempted = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        # signatures
        lib.rio_writer_open.restype = ctypes.c_void_p
        lib.rio_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                        ctypes.c_int]
        lib.rio_write.restype = ctypes.c_int
        lib.rio_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_long]
        lib.rio_writer_close.restype = ctypes.c_int
        lib.rio_writer_close.argtypes = [ctypes.c_void_p]
        lib.rio_scanner_open.restype = ctypes.c_void_p
        lib.rio_scanner_open.argtypes = [ctypes.c_char_p]
        lib.rio_next_size.restype = ctypes.c_long
        lib.rio_next_size.argtypes = [ctypes.c_void_p]
        lib.rio_next_copy.restype = ctypes.c_int
        lib.rio_next_copy.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rio_scanner_close.argtypes = [ctypes.c_void_p]
        lib.ms_parse_file.restype = ctypes.c_void_p
        lib.ms_parse_file.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int]
        lib.ms_num_examples.restype = ctypes.c_long
        lib.ms_num_examples.argtypes = [ctypes.c_void_p]
        lib.ms_copy_slot.restype = ctypes.c_int
        lib.ms_copy_slot.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p]
        lib.ms_free.argtypes = [ctypes.c_void_p]
        lib.ptq_create.restype = ctypes.c_void_p
        lib.ptq_create.argtypes = [ctypes.c_size_t]
        lib.ptq_destroy.argtypes = [ctypes.c_void_p]
        lib.ptq_push.restype = ctypes.c_int
        lib.ptq_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_size_t]
        lib.ptq_pop.restype = ctypes.c_int64
        lib.ptq_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_size_t]
        lib.ptq_peek_len.restype = ctypes.c_int64
        lib.ptq_peek_len.argtypes = [ctypes.c_void_p]
        lib.ptq_size.restype = ctypes.c_size_t
        lib.ptq_size.argtypes = [ctypes.c_void_p]
        lib.ptq_close.argtypes = [ctypes.c_void_p]
        lib.ptq_is_closed.restype = ctypes.c_int
        lib.ptq_is_closed.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def is_native():
    return get_lib() is not None


# ---------------------------------------------------------------------------
# RecordIO
# ---------------------------------------------------------------------------

_RIO_MAGIC = 0x01020304  # reference header.h kMagicNumber


class RecordIOWriter:
    """Chunked record writer (reference recordio/writer.h)."""

    def __init__(self, path, max_chunk_records=1000, max_chunk_bytes=None):
        self._path = path
        self._max_records = max_chunk_records
        self._max_bytes = max_chunk_bytes or (32 << 20)
        lib = get_lib()
        self._lib = lib
        if lib is not None:
            self._h = lib.rio_writer_open(
                path.encode(), max_chunk_records, self._max_bytes)
            if not self._h:
                raise IOError("cannot open %s" % path)
        else:
            self._f = open(path, "wb")
            self._records = []
            self._pending = 0

    def write(self, data):
        if isinstance(data, str):
            data = data.encode()
        if self._lib is not None:
            if self._lib.rio_write(self._h, data, len(data)) != 0:
                raise IOError("recordio write failed")
            return
        self._records.append(bytes(data))
        self._pending += len(data)
        if (len(self._records) >= self._max_records
                or self._pending >= self._max_bytes):
            self._flush()

    def _flush(self):
        if not self._records:
            return
        import struct
        import zlib

        payload = b"".join(
            struct.pack("<I", len(r)) + r for r in self._records)
        header = struct.pack(
            "<IIIII", _RIO_MAGIC, len(self._records), 0,
            zlib.crc32(payload) & 0xFFFFFFFF, len(payload))
        self._f.write(header + payload)
        self._records = []
        self._pending = 0

    def close(self):
        if self._lib is not None:
            if self._h:
                h, self._h = self._h, None  # C side frees even on error
                if self._lib.rio_writer_close(h) != 0:
                    raise IOError("recordio flush failed")
        elif self._f is not None:
            self._flush()
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class RecordIOScanner:
    """Sequential record reader (reference recordio/scanner.h)."""

    def __init__(self, path):
        lib = get_lib()
        self._lib = lib
        if lib is not None:
            self._h = lib.rio_scanner_open(path.encode())
            if not self._h:
                raise IOError("cannot open %s" % path)
        else:
            self._f = open(path, "rb")
            self._chunk = []
            self._cursor = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._lib is not None:
            size = self._lib.rio_next_size(self._h)
            if size == -1:
                raise StopIteration
            if size < 0:
                raise IOError("corrupt recordio chunk")
            buf = ctypes.create_string_buffer(int(size))
            if self._lib.rio_next_copy(self._h, buf) != 0:
                raise StopIteration
            return buf.raw[:size]
        # python fallback
        import struct
        import zlib

        while self._cursor >= len(self._chunk):
            head = self._f.read(20)
            if not head:
                raise StopIteration
            if len(head) < 20:  # truncated header
                raise IOError("corrupt recordio chunk")
            magic, num, comp, crc, size = struct.unpack("<IIIII", head)
            if magic != _RIO_MAGIC or comp != 0:
                raise IOError("corrupt recordio chunk")
            payload = self._f.read(size)
            if len(payload) != size or (zlib.crc32(payload)
                                        & 0xFFFFFFFF) != crc:
                raise IOError("corrupt recordio chunk")
            self._chunk = []
            pos = 0
            for _ in range(num):
                (ln,) = struct.unpack_from("<I", payload, pos)
                pos += 4
                self._chunk.append(payload[pos:pos + ln])
                pos += ln
            self._cursor = 0
        rec = self._chunk[self._cursor]
        self._cursor += 1
        return rec

    def close(self):
        if self._lib is not None:
            if self._h:
                self._lib.rio_scanner_close(self._h)
                self._h = None
        else:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------------
# MultiSlot parser
# ---------------------------------------------------------------------------

def _wrap_u64(x):
    u = int(x) & 0xFFFFFFFFFFFFFFFF
    return u - (1 << 64) if u >= (1 << 63) else u


def parse_multislot_file(path, slot_types, slot_lens, threads=0):
    """Parse a MultiSlot text file into dense per-slot arrays.

    slot_types: 'float'/'uint64' (or 0/1) per slot; slot_lens: padded length
    per slot.  Returns list of np arrays [N, slot_len] (float32 / int64).
    """
    types = [0 if str(t).startswith(("f", "0")) else 1 for t in slot_types]
    lens = [int(l) for l in slot_lens]
    lib = get_lib()
    if lib is not None:
        n = len(types)
        ctypes_types = (ctypes.c_int * n)(*types)
        ctypes_lens = (ctypes.c_int * n)(*lens)
        h = lib.ms_parse_file(path.encode(), ctypes_types, ctypes_lens, n,
                              threads)
        if not h:
            raise IOError("cannot parse %s" % path)
        try:
            N = lib.ms_num_examples(h)
            out = []
            for s in range(n):
                if types[s] == 0:
                    arr = np.empty((N, lens[s]), np.float32)
                else:
                    arr = np.empty((N, lens[s]), np.int64)
                lib.ms_copy_slot(h, s, arr.ctypes.data_as(ctypes.c_void_p))
                out.append(arr)
            return out
        finally:
            lib.ms_free(h)
    # python fallback — skip-and-continue on malformed lines, matching the
    # native parser's error path
    rows = [[] for _ in types]
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            pos = 0
            vals = []
            ok = True
            for s in range(len(types)):
                if pos >= len(toks):
                    ok = False
                    break
                try:
                    cnt = int(toks[pos])
                except ValueError:
                    ok = False
                    break
                if cnt <= 0:  # reference enforces nonzero counts
                    ok = False
                    break
                pos += 1
                v = toks[pos:pos + cnt]
                if len(v) != cnt:
                    ok = False
                    break
                pos += cnt
                try:
                    if types[s] == 0:
                        vals.append([float(x) for x in v])
                    else:
                        # uint64 feasigns wrap two's-complement into int64,
                        # matching the native parser's C cast (the ids
                        # are int64 tensors; hash ids below 2^63 to avoid
                        # negative embedding rows)
                        vals.append([_wrap_u64(x) for x in v])
                except ValueError:
                    ok = False
                    break
            if not ok:
                continue
            for s, v in enumerate(vals):
                L = lens[s]
                if types[s] == 0:
                    a = np.zeros(L, np.float32)
                else:
                    a = np.zeros(L, np.int64)
                a[:min(len(v), L)] = v[:L]
                rows[s].append(a)
    return [
        np.stack(r) if r else np.zeros(
            (0, lens[s]), np.float32 if types[s] == 0 else np.int64)
        for s, r in enumerate(rows)
    ]


# ---------------------------------------------------------------------------
# Blocking reader queue (reference: framework/blocking_queue.h + the
# LoDTensorBlockingQueue bound at pybind.cc:591) — native bounded MPMC
# byte-buffer queue with a queue.Queue fallback.
# ---------------------------------------------------------------------------


class BlockingQueue:
    """Bounded blocking queue of PICKLED items — the serialized-batch /
    cross-process role of the reference's LoDTensorBlockingQueue (items
    must be picklable; in-process prefetch passes references through
    queue.Queue instead, see reader.py).  The C++ side releases the GIL
    while copying/waiting."""

    def __init__(self, capacity=64):
        import threading as _threading

        self._lib = get_lib()
        self._capacity = int(capacity)
        # peek+pop must be atomic per consumer (the C queue is MPMC but
        # the two-call read is not)
        self._pop_lock = _threading.Lock()
        self._closed = _threading.Event()
        if self._lib is not None:
            self._h = self._lib.ptq_create(self._capacity)
            self._q = None
        else:  # pure-python fallback with the same close semantics
            import queue

            self._h = None
            self._q = queue.Queue(maxsize=self._capacity)

    def push(self, obj):
        """False once the queue is closed."""
        import pickle
        import queue

        if self._h is not None:
            raw = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
            return bool(self._lib.ptq_push(self._h, raw, len(raw)))
        while not self._closed.is_set():
            try:
                self._q.put(obj, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def pop(self):
        """Next item, or None when closed and drained."""
        import pickle
        import queue

        if self._h is not None:
            with self._pop_lock:
                n = self._lib.ptq_peek_len(self._h)
                if n <= 0:
                    return None
                buf = ctypes.create_string_buffer(int(n))
                got = self._lib.ptq_pop(self._h, buf, int(n))
            if got <= 0:
                return None
            return pickle.loads(buf.raw[:got])
        while True:
            try:
                return self._q.get(timeout=0.05)
            except queue.Empty:
                if self._closed.is_set():
                    return None

    def size(self):
        if self._h is not None:
            return int(self._lib.ptq_size(self._h))
        return self._q.qsize()

    def close(self):
        self._closed.set()
        if self._h is not None:
            self._lib.ptq_close(self._h)

    def __del__(self):
        try:
            if self._h is not None:
                self._lib.ptq_close(self._h)
                self._lib.ptq_destroy(self._h)
                self._h = None
        except Exception:
            pass
