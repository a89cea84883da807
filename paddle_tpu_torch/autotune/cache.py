"""On-disk autotune cache: measured kernel decisions keyed by signature
(mirrors ``paddle_tpu/autotune/cache.py``, all of it).

Every sweep of the harness (:mod:`.harness`) writes one entry (the
winning parameters, the measured times, the predicted-vs-measured
calibration factor) under a canonical signature string
``family|k=v|...`` that includes shape, dtype and backend, so a decision
made on one GPU never applies on another one or on the CPU.

Durability, as the reference's:

* writes are atomic: staged to a temp file in the same directory, then
  ``os.replace`` over the real one;
* reads are corrupt-safe: a truncated, garbage or wrong-schema file
  warns once and reads as an empty cache; the next :func:`record`
  rewrites it whole;
* a process sees its own writes at once and another process's within
  ``_RESTAT_S`` (1 s): it looks at the file's mtime at most that often,
  where the reference stats the file on every read (each executor call
  reads the cache's state, and a system call there cost the decode step
  ~0.4 ms on the card's host);
* the schema is versioned (``{"schema": 1, ...}``).

Environment:

* ``PADDLE_TPU_AUTOTUNE=0``: every lookup misses and nothing is written,
  so every threshold and gate uses its hand-set default;
* ``PADDLE_TPU_AUTOTUNE_CACHE``: the cache file.  The default is the
  port's own, ``~/.cache/paddle_tpu_torch/autotune-v1.json``, apart
  from the reference's file, whose ``cpu`` entries would otherwise
  apply to the port's CPU runs.
"""

import functools
import json
import os
import threading
import time
import warnings

__all__ = [
    "SCHEMA_VERSION", "autotune_enabled", "cache_path", "signature",
    "lookup", "record", "entries", "state_token", "reset",
]

SCHEMA_VERSION = 1

_lock = threading.RLock()
# {path: {"sigs": {...}, "mtime": int, "checked": float}}: loaded once per
# path per process, again when the file's mtime moves; record() bumps
# _generation, so the fusion signatures (part of the executor's cache
# key) see in-process changes at once
_loaded = {}
# every executor call reads the cache's state (the fusion signature), and
# a stat is a system call: a process looks at the file's mtime at most
# this often, so another process's write shows within this many seconds
_RESTAT_S = 1.0
_generation = 0
_warned_paths = set()


def autotune_enabled():
    """Kill switch: ``PADDLE_TPU_AUTOTUNE=0`` disables every cache read
    and write."""
    return os.environ.get("PADDLE_TPU_AUTOTUNE", "1") != "0"


def cache_path():
    """``PADDLE_TPU_AUTOTUNE_CACHE`` or the port's per-user default."""
    p = os.environ.get("PADDLE_TPU_AUTOTUNE_CACHE", "").strip()
    if p:
        return p
    return _default_path(os.environ.get("HOME"))


@functools.lru_cache(maxsize=None)
def _default_path(home):
    # every executor call reads the path (the fusion signature): resolve
    # ``~`` once per HOME
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "paddle_tpu_torch",
                        "autotune-v%d.json" % SCHEMA_VERSION)


def signature(family, **key):
    """``family|k1=v1|k2=v2`` with sorted keys; a list or tuple value is
    joined with ``x``."""
    parts = [str(family)]
    for k in sorted(key):
        v = key[k]
        if isinstance(v, (list, tuple)):
            v = "x".join(str(x) for x in v)
        parts.append("%s=%s" % (k, v))
    return "|".join(parts)


def _parse_file(path):
    """The file's signature dict; a corrupt or wrong-schema file reads
    as {} with one warning per path per process."""
    try:
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict) \
                or data.get("schema") != SCHEMA_VERSION \
                or not isinstance(data.get("entries"), dict):
            raise ValueError("bad schema %r" % (
                data.get("schema") if isinstance(data, dict) else None))
        return dict(data["entries"])
    except FileNotFoundError:
        return {}
    except (OSError, ValueError) as e:  # json's errors are ValueErrors
        if path not in _warned_paths:
            _warned_paths.add(path)
            warnings.warn(
                "paddle_tpu_torch autotune cache %s is unreadable (%s) — "
                "falling back to default kernel parameters; the next "
                "sweep rewrites it" % (path, e), stacklevel=3)
        return {}


def _load(path):
    """The in-process record of ``path``: ``{"sigs", "mtime",
    "checked"}``."""
    now = time.monotonic()
    with _lock:
        cached = _loaded.get(path)
        if cached is not None and now - cached["checked"] < _RESTAT_S:
            return cached
        try:
            mtime = os.stat(path).st_mtime_ns
        except OSError:
            mtime = None
        if cached is not None and cached["mtime"] == mtime:
            cached["checked"] = now
            return cached
        _loaded[path] = {"sigs": _parse_file(path), "mtime": mtime,
                         "checked": now}
        return _loaded[path]


def lookup(sig):
    """The cached entry for ``sig`` (a copy), or None: a miss, the kill
    switch, or a corrupt file."""
    if not autotune_enabled():
        return None
    entry = _load(cache_path())["sigs"].get(sig)
    return dict(entry) if isinstance(entry, dict) else None


def entries():
    """Every cached entry ``{sig: entry}`` ({} when disabled)."""
    if not autotune_enabled():
        return {}
    return {k: dict(v) for k, v in _load(cache_path())["sigs"].items()
            if isinstance(v, dict)}


def record(sig, entry):
    """Merge ``{sig: entry}`` into the cache file atomically (a no-op
    under the kill switch); returns the entry."""
    global _generation
    if not autotune_enabled():
        return dict(entry)
    path = cache_path()
    with _lock:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # read, merge, write: concurrent processes mostly compose
        sigs = _parse_file(path)
        sigs[sig] = dict(entry)
        tmp = "%s.tmp.%d" % (path, os.getpid())
        with open(tmp, "w") as f:
            json.dump({"schema": SCHEMA_VERSION, "entries": sigs}, f,
                      indent=1, sort_keys=True)
        os.replace(tmp, path)
        try:
            mtime = os.stat(path).st_mtime_ns
        except OSError:  # pragma: no cover
            mtime = None
        _loaded[path] = {"sigs": sigs, "mtime": mtime,
                         "checked": time.monotonic()}
        _generation += 1
    return dict(entry)


def state_token():
    """Hashable token of the cache state this process sees: a write,
    here or by another process, gives a new token (another process's
    within ``_RESTAT_S``), and a cached fusion resolution then looks
    again at the entries it read, resolving again only if one moved.
    Stable across a program's first lookup (an ``os.stat`` at most every
    ``_RESTAT_S``, a parse only when the mtime moved)."""
    if not autotune_enabled():
        return ("autotune-off",)
    path = cache_path()
    return (path, _load(path)["mtime"], _generation)


def reset():
    """Drop the in-process cache state (test isolation)."""
    global _generation
    with _lock:
        _loaded.clear()
        _warned_paths.clear()
        _generation += 1
