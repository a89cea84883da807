"""One atomic-write idiom (mirrors ``paddle_tpu/resilience/atomic.py``;
the standard library only, so any module can share it without an import
cycle): write to a temporary file, optionally fsync, ``os.replace`` — a
crash mid-write never leaves a torn file under the final name, and the
previous file, if any, survives intact."""

import os

__all__ = ["atomic_write"]


def atomic_write(path, writer, fsync=True, text=False):
    """``writer(fileobj)`` produces the content; ``path`` must already
    carry its extension (handing numpy an open file object stops it from
    appending one)."""
    tmp = "%s.tmp-%d" % (path, os.getpid())
    try:
        with open(tmp, "w" if text else "wb") as f:
            writer(f)
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
