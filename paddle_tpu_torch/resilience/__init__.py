"""The fault-tolerant runtime (mirrors ``paddle_tpu/resilience/``).
Ported so far: :mod:`.atomic` (write to a temporary file, then rename)
and :mod:`.watchdog` (heartbeats, :class:`HeartbeatMonitor`,
:func:`wait_cluster`, :func:`read_heartbeat`, which ``tools.monitor``
reads).  The reference's ``faults``, ``retry``, ``guard``,
``checkpoint``, ``elastic``, ``reshard`` and ``autoscale`` are not
ported yet (ROADMAP.md, Queue A item 9)."""

from . import atomic
from . import watchdog
from .atomic import atomic_write
from .watchdog import (LOST_EXIT_CODE, HeartbeatMonitor, HeartbeatWriter,
                       WorkerLostError, read_heartbeat, wait_cluster)

__all__ = ["atomic", "watchdog", "atomic_write", "WorkerLostError",
           "HeartbeatWriter", "HeartbeatMonitor", "wait_cluster",
           "read_heartbeat", "LOST_EXIT_CODE"]
