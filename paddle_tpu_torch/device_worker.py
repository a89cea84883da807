"""Device-worker facades (mirrors ``paddle_tpu/device_worker.py``, all of
it; the reference's ``python/paddle/fluid/device_worker.py``:
Hogwild, DownpourSGD and Section configure the per-thread C++ workers of
``framework/device_worker.h``).

Here the worker is the executor's step; these classes keep the
configuration surface and record their role for the dataset runtime."""

__all__ = ["DeviceWorker", "Hogwild", "DownpourSGD", "Section"]


class DeviceWorker:
    """reference device_worker.py:18."""

    def __init__(self):
        self._infer = False
        self._fleet_desc = None
        self._program = None
        self._trainer = None

    def _set_infer(self, infer=False):
        self._infer = infer

    def _set_fleet_desc(self, fleet_desc):
        self._fleet_desc = fleet_desc

    def _set_program(self, program):
        self._program = program

    def _set_trainer(self, trainer):
        self._trainer = trainer

    def _gen_worker_desc(self, trainer_desc):
        return trainer_desc


class Hogwild(DeviceWorker):
    """Lock-free per-thread SGD in the reference (hogwild_worker.cc);
    the executor's one step on the card subsumes it."""


class DownpourSGD(DeviceWorker):
    """Pserver pull/push worker (downpour_worker.cc); the sparse path is
    device or host-resident tables, so the worker is the same step."""


class Section(DeviceWorker):
    """Pipeline-stage worker (section_worker.cc); recorded only (the
    pipeline schedule is not ported, ROADMAP.md)."""
