"""Worker liveness: heartbeats, hang watchdogs, cluster supervision
(mirrors ``paddle_tpu/resilience/watchdog.py``).

The failure this layer exists for: one worker of a cluster dies (OOM
kill, preemption) and every *surviving* worker blocks forever inside its
next collective — the run does not crash, it silently stops.  Three
pieces bound that hang:

* :class:`HeartbeatWriter` — each worker touches ``hb-<rank>`` in a
  shared directory every ``interval`` seconds from a daemon thread; the
  payload carries the newest step and its latency from the telemetry
  layer, which ``tools.monitor`` reads;
* :class:`HeartbeatMonitor` — watches the peers' files; a rank whose
  heartbeat goes stale past ``timeout`` is declared lost.  The
  background form (``start()``) exits the process with
  :data:`LOST_EXIT_CODE` by default, so a worker wedged in a collective
  dies promptly and visibly instead of hanging;
* :func:`wait_cluster` — the parent-side supervisor: polls worker
  subprocesses and turns "one died while others still run" or "nobody
  finished before the deadline" into :class:`WorkerLostError` within a
  bounded time, killing the survivors.

A lost worker is journaled (``worker-lost``) and counted
(``watchdog_missed_beats_total``, ``workers_lost_total``) through the
port's ``observability.runtime``.  File mtimes, not sockets: a
heartbeat writer that is itself wedged cannot lie.
"""

import json
import os
import sys
import threading
import time

__all__ = ["WorkerLostError", "HeartbeatWriter", "HeartbeatMonitor",
           "wait_cluster", "read_heartbeat", "LOST_EXIT_CODE"]

#: exit status a worker uses when its peer-loss watchdog trips
LOST_EXIT_CODE = 44


class WorkerLostError(RuntimeError):
    """A cluster worker died or went silent.  ``.ranks`` names the lost
    ranks (when known), ``.returncodes`` the observed exit codes."""

    def __init__(self, message, ranks=(), returncodes=()):
        super().__init__(message)
        self.ranks = tuple(ranks)
        self.returncodes = tuple(returncodes)


def _record_lost(ranks, reason):
    """Journal + count a worker-loss verdict (urgent-flushed — the
    default on_lost handler ``os._exit``\\ s right after)."""
    try:
        from ..observability import runtime as _obs

        _obs.record_missed_beat(ranks)
        _obs.record_worker_lost(ranks, reason=reason)
    except Exception:  # noqa: BLE001 - telemetry never blocks the exit
        pass


def _hb_path(dirname, rank):
    return os.path.join(dirname, "hb-%d" % rank)


def _done_path(dirname, rank):
    return _hb_path(dirname, rank) + ".done"


def read_heartbeat(dirname, rank):
    """Parse one rank's heartbeat file: ``{"t", "rank", and — when the
    telemetry layer has seen a step — "step", "step_ms", "step_ts"}``,
    plus ``"mtime"`` (what staleness is judged on).  Returns None when
    the file is absent.  Tolerates the pre-telemetry plain-float
    payload and torn writes (mtime still counts as a beat)."""
    path = _hb_path(dirname, rank)
    try:
        mtime = os.path.getmtime(path)
        with open(path) as f:
            raw = f.read().strip()
    except OSError:
        return None
    out = {"rank": int(rank), "mtime": mtime}
    try:
        payload = json.loads(raw)
        if isinstance(payload, dict):
            out.update(payload)
        else:
            out["t"] = float(payload)
    except (ValueError, TypeError):
        try:
            out["t"] = float(raw)
        except (ValueError, TypeError):
            pass
    return out


class HeartbeatWriter:
    """Touch ``hb-<rank>`` every ``interval`` seconds (daemon thread)."""

    def __init__(self, dirname, rank, interval=0.5):
        self.dirname = dirname
        self.rank = int(rank)
        self.interval = float(interval)
        self._stop = threading.Event()
        self._thread = None
        os.makedirs(dirname, exist_ok=True)

    def beat(self):
        """One heartbeat now (atomic create-or-touch; no fsync — a beat
        is cheap and its loss is one interval, not corruption).

        The payload carries the newest step number + step latency from
        the telemetry layer, so ``tools/monitor`` can tell a
        wedged-but-alive rank (fresh beats, step frozen) from a healthy
        one.  Staleness detection stays mtime-based — a reader that
        ignores the content loses nothing."""
        from .atomic import atomic_write

        payload = {"t": time.time(), "rank": self.rank}
        try:
            from ..observability import runtime as _obs

            info = _obs.last_step_info()
            if info.get("step") is not None:
                payload["step"] = info["step"]
                payload["step_ms"] = round(info["step_ms"], 3)
                payload["step_ts"] = info["ts"]
        except Exception:  # noqa: BLE001 - a beat must never fail
            pass
        atomic_write(_hb_path(self.dirname, self.rank),
                     lambda f: f.write(json.dumps(payload) + "\n"),
                     fsync=False, text=True)

    def start(self):
        self.beat()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="paddle_tpu_torch-heartbeat-%d" % self.rank)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.beat()
            except OSError:
                pass  # shared fs hiccup: skip the beat, not the thread

    def stop(self):
        """Clean shutdown: leave a ``.done`` marker so peers' monitors
        know this rank *finished* rather than died — a worker still
        wrapping up (final checkpoint) must not be declared lost just
        because a faster peer exited first."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(self.interval + 1.0)
        try:
            with open(_done_path(self.dirname, self.rank), "w") as f:
                f.write("%f\n" % time.time())
        except OSError:
            pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class HeartbeatMonitor:
    """Watch peer heartbeats; declare a rank lost when its file goes
    ``timeout`` seconds stale (or never appears within ``boot_grace``)."""

    def __init__(self, dirname, ranks, timeout=10.0, interval=0.5,
                 boot_grace=60.0):
        self.dirname = dirname
        self.ranks = [int(r) for r in ranks]
        self.timeout = float(timeout)
        self.interval = float(interval)
        self.boot_grace = float(boot_grace)
        self._born = time.time()
        self._seen = set()  # ranks whose live heartbeat we've observed
        self._stop = threading.Event()
        self._thread = None

    def stale_ranks(self, now=None):
        now = time.time() if now is None else now
        stale = []
        for rank in self.ranks:
            try:
                done_m = os.path.getmtime(_done_path(self.dirname, rank))
            except OSError:
                done_m = None
            # a clean-shutdown marker from THIS incarnation: the peer
            # finished, it didn't die (pre-birth markers are leftovers)
            if done_m is not None and done_m >= self._born - self.timeout:
                continue
            try:
                mtime = os.path.getmtime(_hb_path(self.dirname, rank))
            except OSError:
                mtime = None
            # a beat within one timeout of our birth counts as live even
            # if it predates us (the peer may have booted first); older
            # pre-birth files are leftovers from an earlier incarnation
            if mtime is None or (mtime < self._born - self.timeout
                                 and rank not in self._seen):
                # the peer hasn't booted yet — only fatal once the boot
                # grace runs out
                if now - self._born > self.boot_grace:
                    stale.append(rank)
                continue
            self._seen.add(rank)
            if now - mtime > self.timeout:
                stale.append(rank)
        return stale

    def progress_of(self, rank):
        """The rank's parsed heartbeat payload (see
        :func:`read_heartbeat`), or None."""
        return read_heartbeat(self.dirname, rank)

    def check(self):
        """Raise :class:`WorkerLostError` if any watched rank is stale."""
        stale = self.stale_ranks()
        if stale:
            _record_lost(stale, "heartbeat stale > %.1fs" % self.timeout)
            raise WorkerLostError(
                "worker rank(s) %s heartbeat stale for > %.1fs (dir %s)"
                % (stale, self.timeout, self.dirname), ranks=stale)
        return True

    def start(self, on_lost=None):
        """Background watch.  Default ``on_lost`` prints WORKER_LOST and
        hard-exits with :data:`LOST_EXIT_CODE` — the surviving worker is
        very likely wedged inside a collective whose peer is gone, and a
        prompt visible death is the recoverable outcome."""

        def _default_on_lost(ranks):
            print("WORKER_LOST ranks=%s (heartbeat stale > %.1fs)"
                  % (ranks, self.timeout), file=sys.stderr, flush=True)
            os._exit(LOST_EXIT_CODE)

        handler = on_lost or _default_on_lost

        def _loop():
            while not self._stop.wait(self.interval):
                stale = self.stale_ranks()
                if stale:
                    _record_lost(stale,
                                 "heartbeat stale > %.1fs" % self.timeout)
                    handler(stale)
                    return

        self._thread = threading.Thread(
            target=_loop, daemon=True, name="paddle_tpu_torch-hb-monitor")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(self.interval + 1.0)


def wait_cluster(procs, timeout=None, poll=0.25, kill_on_failure=True):
    """Supervise cluster worker subprocesses (``subprocess.Popen``-like:
    ``poll()``/``kill()``).  Returns the list of return codes once ALL
    exit zero.  Raises :class:`WorkerLostError` within ``poll`` seconds
    of any worker dying nonzero while peers still run (the survivors are
    killed first when ``kill_on_failure``), or when ``timeout`` expires
    with workers still running — a bounded answer instead of a silent
    collective hang."""
    deadline = None if timeout is None else time.time() + float(timeout)
    while True:
        codes = [p.poll() for p in procs]
        bad = [(i, c) for i, c in enumerate(codes)
               if c is not None and c != 0]
        if bad:
            if kill_on_failure:
                for p, c in zip(procs, codes):
                    if c is None:
                        p.kill()
            ranks = [i for i, _ in bad]
            _record_lost(ranks, "exited with code(s) %s"
                         % [c for _, c in bad])
            raise WorkerLostError(
                "cluster worker(s) %s exited with code(s) %s"
                % (ranks, [c for _, c in bad]),
                ranks=ranks, returncodes=[c for _, c in bad])
        if all(c == 0 for c in codes):
            return codes
        if deadline is not None and time.time() > deadline:
            hung = [i for i, c in enumerate(codes) if c is None]
            if kill_on_failure:
                for p, c in zip(procs, codes):
                    if c is None:
                        p.kill()
            _record_lost(hung, "timeout after %.1fs" % float(timeout))
            raise WorkerLostError(
                "cluster worker(s) %s still running after %.1fs timeout "
                "(likely hung in a collective)" % (hung, float(timeout)),
                ranks=hung)
        time.sleep(poll)
