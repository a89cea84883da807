"""Schema-versioned structured step/event journal (mirrors
``paddle_tpu/observability/journal.py``, all of it).

A bounded in-memory ring buffer of event dicts, optionally flushed as
JSONL into ``PADDLE_TPU_TELEMETRY_DIR`` (one ``journal-r<rank>-<pid>``
file per process, so multi-worker runs never interleave writes).  The
same directory is what ``python -m paddle_tpu_torch.tools.monitor`` tails.

Write discipline mirrors the checkpoint layer's: appends are buffered
and flushed every ``PADDLE_TPU_TELEMETRY_FLUSH`` events (default 32),
but *urgent* kinds — faults, guard skips, checkpoint transitions,
worker loss — flush immediately, because they are exactly the events a
crashing process must not lose.  Readers tolerate torn trailing lines
(a killed worker mid-write must not poison the monitor), the
skip-torn-version discipline checkpoint manifests already follow.

Event schema (``SCHEMA_VERSION = 1``)::

    {"schema": 1, "ts": <unix seconds>, "rank": <int>,
     "kind": "<step|fusion-applied|plan-chosen|checkpoint-saved|...>",
     ...kind-specific fields...}
"""

import atexit
import json
import os
import threading
import time
from collections import deque

from .metrics import telemetry_enabled

__all__ = ["SCHEMA_VERSION", "Journal", "get_journal", "emit",
           "read_journal", "journal_dir", "reset_journal"]

SCHEMA_VERSION = 1

#: event kinds flushed to disk immediately — losing them to a buffer
#: on a crash would defeat their purpose
URGENT_KINDS = frozenset([
    "fault-injected", "guard-skip", "checkpoint-saved",
    "checkpoint-loaded", "worker-lost", "resume", "race-detected",
    "replan", "reshard", "dispatcher-died",
    "join-request", "admitted", "warmup", "autoscale",
])

_DEFAULT_CAPACITY = 4096
_DEFAULT_FLUSH_EVERY = 32


def journal_dir():
    """``PADDLE_TPU_TELEMETRY_DIR`` or None (in-memory ring only)."""
    d = os.environ.get("PADDLE_TPU_TELEMETRY_DIR", "").strip()
    return d or None


def _rank():
    for var in ("PADDLE_TRAINER_ID", "PADDLE_TPU_RANK"):
        v = os.environ.get(var)
        if v:
            try:
                return int(v)
            except ValueError:
                pass
    return 0


class Journal:
    """One process's event ring + JSONL writer.  Thread-safe."""

    def __init__(self, dirname=None, capacity=None, flush_every=None,
                 rank=None):
        self.dirname = dirname
        self.rank = _rank() if rank is None else int(rank)
        if capacity is None:
            try:
                capacity = int(os.environ.get(
                    "PADDLE_TPU_TELEMETRY_RING", _DEFAULT_CAPACITY))
            except ValueError:
                capacity = _DEFAULT_CAPACITY
        if flush_every is None:
            try:
                flush_every = int(os.environ.get(
                    "PADDLE_TPU_TELEMETRY_FLUSH", _DEFAULT_FLUSH_EVERY))
            except ValueError:
                flush_every = _DEFAULT_FLUSH_EVERY
        self.flush_every = max(int(flush_every), 1)
        self._ring = deque(maxlen=max(int(capacity), 1))
        self._pending = []
        self._lock = threading.Lock()
        self._path = None
        if dirname:
            os.makedirs(dirname, exist_ok=True)
            self._path = os.path.join(
                dirname, "journal-r%d-%d.jsonl" % (self.rank, os.getpid()))

    @property
    def path(self):
        return self._path

    def emit(self, kind, **fields):
        """Append one event; returns the event dict (None when
        telemetry is killed)."""
        if not telemetry_enabled():
            return None
        event = {"schema": SCHEMA_VERSION, "ts": time.time(),
                 "rank": self.rank, "kind": str(kind)}
        event.update(fields)
        with self._lock:
            self._ring.append(event)
            if self._path is not None:
                self._pending.append(event)
                if (len(self._pending) >= self.flush_every
                        or kind in URGENT_KINDS):
                    self._flush_locked()
        return event

    def events(self, kind=None):
        """Ring contents (oldest first), optionally one kind."""
        with self._lock:
            evs = list(self._ring)
        if kind is not None:
            evs = [e for e in evs if e.get("kind") == kind]
        return evs

    def _flush_locked(self):
        if not self._pending or self._path is None:
            return
        lines = "".join(
            json.dumps(e, sort_keys=True, default=str) + "\n"
            for e in self._pending)
        self._pending = []
        try:
            with open(self._path, "a") as f:
                f.write(lines)
        except OSError:
            pass  # shared-fs hiccup: the ring still has the events

    def flush(self):
        with self._lock:
            self._flush_locked()

    def close(self):
        self.flush()

    def __len__(self):
        return len(self._ring)


_journal = None
_journal_lock = threading.Lock()


def get_journal():
    """The process-wide journal (created on first use; its directory is
    whatever ``PADDLE_TPU_TELEMETRY_DIR`` said at that moment)."""
    global _journal
    if _journal is None:
        with _journal_lock:
            if _journal is None:
                j = Journal(dirname=journal_dir())
                atexit.register(j.close)
                _journal = j
    return _journal


def emit(kind, **fields):
    """Emit one event into the process journal (no-op when killed)."""
    if not telemetry_enabled():
        return None
    return get_journal().emit(kind, **fields)


def reset_journal():
    """Drop the singleton so the next emit re-reads the env (tests)."""
    global _journal
    with _journal_lock:
        j, _journal = _journal, None
    if j is not None:
        j.close()


def _parse_line(line):
    line = line.strip()
    if not line:
        return None
    try:
        event = json.loads(line)
    except ValueError:
        return None  # torn trailing write from a killed process
    if not isinstance(event, dict) or "kind" not in event:
        return None
    try:
        if int(event.get("schema", 0)) > SCHEMA_VERSION:
            return None  # a future writer; this reader can't vouch
    except (TypeError, ValueError):
        return None
    return event


def read_journal(path):
    """Parse one JSONL journal file or every ``journal-*.jsonl`` in a
    directory, in timestamp order.  Unparseable lines (torn writes) and
    unknown-schema events are skipped, never raised."""
    paths = []
    if os.path.isdir(path):
        for name in sorted(os.listdir(path)):
            if name.startswith("journal-") and name.endswith(".jsonl"):
                paths.append(os.path.join(path, name))
    elif os.path.exists(path):
        paths.append(path)
    events = []
    for p in paths:
        try:
            with open(p) as f:
                for line in f:
                    event = _parse_line(line)
                    if event is not None:
                        events.append(event)
        except OSError:
            continue
    events.sort(key=lambda e: e.get("ts", 0.0))
    return events
