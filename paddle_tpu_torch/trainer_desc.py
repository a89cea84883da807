"""Trainer configuration facades (mirrors ``paddle_tpu/trainer_desc.py``,
all of it; the reference's ``python/paddle/fluid/trainer_desc.py``:
TrainerDesc, MultiTrainer, DistMultiTrainer and PipelineTrainer emit the
TrainerDesc proto the C++ trainer runtime of ``framework/trainer.h:38``
reads).

There is no thread-per-core worker runtime: the executor's step is the
worker.  These classes carry the same configuration surface (thread
num, fetch config, debug, device worker) as plain Python state, and
``dataset_runtime.run_from_dataset`` records the resolved trainer on the
program (``program._trainer_desc``) for inspection; the knobs configure
nothing at run time."""

from . import device_worker as dw

__all__ = ["TrainerDesc", "MultiTrainer", "DistMultiTrainer",
           "PipelineTrainer", "TrainerFactory"]


class TrainerDesc:
    """reference trainer_desc.py:21."""

    def __init__(self):
        self._fetch_vars = []
        self._fetch_info = []
        self._print_period = 100
        self._debug = False
        self._thread_num = 1
        self._device_worker = None
        self._infer = False
        self._program = None
        self._fleet_desc = None

    def _set_fetch_var_and_info(self, fetch_vars, fetch_info, print_period):
        self._fetch_vars = list(fetch_vars or [])
        self._fetch_info = list(fetch_info or [])
        self._print_period = print_period

    def _set_debug(self, debug):
        self._debug = debug

    def _set_thread(self, thread_num):
        # the executor's step owns the card; recorded for API parity
        self._thread_num = thread_num

    def _set_device_worker(self, device_worker):
        self._device_worker = device_worker
        device_worker._set_trainer(self)

    def _set_infer(self, infer):
        self._infer = infer

    def _set_program(self, program):
        self._program = program

    def _set_fleet_desc(self, fleet_desc):
        self._fleet_desc = fleet_desc

    def _gen_trainer_desc(self):
        return self


class MultiTrainer(TrainerDesc):
    """reference trainer_desc.py MultiTrainer (thread-per-core Hogwild in
    C++; one executor step here)."""

    def _gen_trainer_desc(self):
        if self._device_worker is None:
            self._set_device_worker(dw.Hogwild())
        return self


class DistMultiTrainer(TrainerDesc):
    """reference DistMultiTrainer (pserver pull/push workers).  The PS
    runtime is replaced by device or host-resident tables; this trainer
    runs the same local loop."""

    def _gen_trainer_desc(self):
        if self._device_worker is None:
            self._set_device_worker(dw.DownpourSGD())
        return self


class PipelineTrainer(TrainerDesc):
    """reference PipelineTrainer + SectionWorker (recorded; the pipeline
    schedule is not ported)."""

    def _gen_trainer_desc(self):
        if self._device_worker is None:
            self._set_device_worker(dw.Section())
        return self


class TrainerFactory:
    """reference trainer_factory.py: map (TrainerDesc name, DeviceWorker
    name) strings from a Dataset/opt config onto the classes above."""

    _TRAINERS = {
        "MultiTrainer": MultiTrainer,
        "DistMultiTrainer": DistMultiTrainer,
        "PipelineTrainer": PipelineTrainer,
    }

    def _create_trainer(self, opt_info=None):
        import warnings

        opt_info = opt_info or {}
        name = opt_info.get("trainer", "MultiTrainer")
        worker = opt_info.get("device_worker", None)
        cls = self._TRAINERS.get(name)
        if cls is None:
            warnings.warn(
                "unknown trainer %r; falling back to MultiTrainer" % name)
            cls = MultiTrainer
        trainer = cls()
        if worker:
            wcls = getattr(dw, worker, None)
            if wcls is None:
                warnings.warn(
                    "unknown device worker %r; using the trainer default"
                    % worker)
            else:
                trainer._set_device_worker(wcls())
        return trainer._gen_trainer_desc()
