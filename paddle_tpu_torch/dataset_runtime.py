"""The dataset → executor bridge behind ``Executor.train_from_dataset`` /
``infer_from_dataset`` (mirrors ``paddle_tpu/dataset_runtime.py``, all of
it; the reference's ``Executor::RunFromDataset``, ``executor.cc:120`` →
TrainerFactory → trainers and device workers).

The thread-per-core C++ worker runtime is the executor's step; the
TrainerDesc / DeviceWorker configuration surface stays
(``trainer_desc.TrainerFactory``) and is recorded on the program.  The
loop: a :class:`~.pipeline.DeviceFeedPipeline` parses and stages the
next batches on the executor's device from a background thread (depth
``PADDLE_TPU_PIPELINE_DEPTH``, default 2), every step returns lazy
:class:`~.pipeline.FetchHandle`\\ s, and the device-to-host syncs are
one batched read a ``print_period`` window (or a window of twice the
depth when nothing prints), so the host's work on batch k+1 overlaps
the card's on batch k.  The ids that a host-resident table's prefetch
reads stay host arrays.  The result is numpy, one list a step."""


def run_from_dataset(executor, program, dataset, scope, fetch_list,
                     fetch_info, print_period, train=True):
    from . import pipeline as pl
    from .trainer_desc import TrainerFactory

    if dataset is None:
        raise ValueError("dataset is required")
    opt_info = getattr(program, "_opt_info", None) or {}
    trainer = TrainerFactory()._create_trainer(opt_info)
    trainer._set_program(program)
    trainer._set_infer(not train)
    trainer._set_fetch_var_and_info(fetch_list, fetch_info, print_period)
    program._trainer_desc = trainer

    host_ids = [spec["ids"]
                for spec in getattr(program, "_host_tables", None) or ()]
    it = pl.DeviceFeedPipeline(dataset.batch_iterator,
                               place=executor.device,
                               keep_on_host=host_ids)
    window = (print_period if (fetch_list and print_period)
              else max(2, pl.pipeline_depth() * 2))
    results = []
    unsynced = 0

    def _sync_window():
        # ONE batched sync for every fetch still in flight
        pl.materialize([h for step in results[len(results) - unsynced:]
                        for h in step])

    for i, feed in enumerate(it):
        out = executor.run(program, feed=feed, fetch_list=fetch_list,
                           scope=scope, return_numpy=False)
        results.append(out)
        unsynced += 1
        if fetch_list and print_period and i % print_period == 0:
            _sync_window()
            unsynced = 0
            names = fetch_info or [
                getattr(v, "name", str(v)) for v in fetch_list]
            msg = ", ".join("%s=%s" % (n, o.numpy().reshape(-1)[:3])
                            for n, o in zip(names, out))
            print("[paddle_tpu] step %d: %s" % (i, msg))
        elif unsynced >= window:
            _sync_window()
            unsynced = 0
    if unsynced:
        _sync_window()
    # numpy values per step (the handles are synced: no further wait)
    return [pl.materialize(step) for step in results]
