"""Checkpoint save/load and inference export (mirrors ``paddle_tpu/io.py``:
``save_vars``/``load_vars``, ``save_persistables``/``load_persistables``,
``save_inference_model``/``load_inference_model`` :380-415).

The on-disk format is the reference package's: one ``<var>.npy`` per var
(or a combined ``.npz`` under ``filename``), the program as JSON in
``__model__`` (:mod:`.proto`), and ``__meta__.json`` with the feed and
fetch names.  A directory the reference exports loads here unchanged.
Loaded values are placed on the executor's device.  ``save_persistables``
/ ``load_persistables`` also save and load the program's host-resident
tables (:mod:`.host_table`, the reference's :275-290, :374) in the
per-shard layout under ``<table>.shards/``.  Sharded device checkpoints
(``<var>.shards/`` of a device var) are not ported yet (ROADMAP.md) and
raise."""

import json
import os
import tempfile

import numpy as np
import torch

from . import proto
from .executor import global_scope
from .framework import Parameter, default_main_program
from .ops.registry import np_to_torch
from .pipeline import host_values

__all__ = [
    "save_vars", "save_params", "save_persistables", "load_vars",
    "load_params", "load_persistables", "save_inference_model",
    "load_inference_model", "get_program_parameter",
]

MODEL_FILENAME = "__model__"


def _atomic_write(path, write):
    """Write through a temp file in the same directory, then rename."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=".tmp-", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _load_array(path, var_name):
    import zipfile

    if not os.path.exists(path):
        raise RuntimeError(
            "checkpoint file %r for variable %r is missing — the "
            "checkpoint directory is incomplete" % (path, var_name))
    try:
        return np.load(path)
    except (ValueError, OSError, EOFError, zipfile.BadZipFile) as e:
        raise RuntimeError("checkpoint file %r for variable %r is corrupt "
                           "or unreadable: %s" % (path, var_name, e)) from e


def _is_persistable(var):
    return var.persistable and not var.is_data


def _is_parameter(var):
    return isinstance(var, Parameter)


def _device_of(executor):
    return getattr(executor, "device", None) or torch.device("cpu")


def _select(main_program, vars, predicate):
    if main_program is None:
        main_program = default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if (predicate or _is_persistable)(v)]
    return vars


def _whole(scope, name):
    """``name``'s value, gathered whole when it is a ZeRO-1 accumulator
    whose rows this rank holds (``Scope.shards``): a collective, so
    every rank of the group saves."""
    val = scope.get(name)
    shard = scope._owner_of(name).shards.get(name)
    if shard is None or val.shape[0] == shard[0]:
        return val
    from .ops import comm

    return comm.all_gather(val, shard[2]).reshape(
        (shard[0],) + tuple(val.shape[1:]))


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    vars = _select(main_program, vars, predicate)
    scope = global_scope()
    os.makedirs(dirname, exist_ok=True)
    present = [v for v in vars if scope.get(v.name) is not None]
    arrays = dict(zip([v.name for v in present],
                      host_values([_whole(scope, v.name)
                                   for v in present])))
    if filename is None:
        for name, arr in arrays.items():
            _atomic_write(os.path.join(dirname, name.replace("/", "_")
                                       + ".npy"),
                          lambda f, a=arr: np.save(f, a))
    else:
        path = os.path.join(dirname, filename)
        if not path.endswith(".npz"):
            path += ".npz"
        _atomic_write(path, lambda f: np.savez(f, **arrays))


def save_params(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=_is_parameter, filename=filename)


def _host_tables_of(main_program):
    from . import host_table as _ht

    prog = main_program or default_main_program()
    names = {spec["table"]
             for spec in getattr(prog, "_host_tables", None) or []}
    return [_ht.get_table(n) for n in sorted(names)]


def save_persistables(executor, dirname, main_program=None, filename=None):
    r = save_vars(executor, dirname, main_program,
                  predicate=_is_persistable, filename=filename)
    for tab in _host_tables_of(main_program):
        tab.save(dirname)
    return r


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    vars = _select(main_program, vars, predicate)
    scope = global_scope()
    device = _device_of(executor)
    for v in vars:
        if os.path.isdir(os.path.join(dirname, v.name.replace("/", "_")
                                      + ".shards")):
            raise NotImplementedError(
                "sharded checkpoints (%s.shards/) are not ported yet "
                "(ROADMAP.md, Queue A item 9)" % v.name)
    if filename is None:
        for v in vars:
            path = os.path.join(dirname, v.name.replace("/", "_") + ".npy")
            if not os.path.exists(path):
                import warnings

                warnings.warn(
                    "checkpoint dir %r has no file for variable %r — it "
                    "keeps its current value (partial restore?)"
                    % (dirname, v.name), RuntimeWarning, stacklevel=2)
                continue
            scope.set(v.name, np_to_torch(_load_array(path, v.name), device))
        return
    path = os.path.join(dirname, filename)
    if not path.endswith(".npz"):
        path += ".npz"
    if not os.path.exists(path):
        raise RuntimeError("combined checkpoint file %r does not exist"
                           % path)
    data = _load_array(path, "<combined>")
    for v in vars:
        if v.name in data:
            scope.set(v.name, np_to_torch(data[v.name], device))


def load_params(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program,
                     predicate=_is_parameter, filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    r = load_vars(executor, dirname, main_program,
                  predicate=_is_persistable, filename=filename)
    for tab in _host_tables_of(main_program):
        if tab.has_checkpoint(dirname):
            tab.load(dirname)
    return r


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True):
    """Prune to the inference subgraph (cloned for test) and write the
    program, ``__meta__.json`` and the persistables."""
    if main_program is None:
        main_program = default_main_program()
    target_names = [v.name for v in target_vars]
    pruned = main_program.clone(for_test=True)._prune(feeded_var_names,
                                                      target_names)
    os.makedirs(dirname, exist_ok=True)
    proto.save_program(pruned, os.path.join(
        dirname, model_filename or MODEL_FILENAME))
    with open(os.path.join(dirname, "__meta__.json"), "w") as f:
        json.dump({"feed": list(feeded_var_names), "fetch": target_names}, f)
    save_persistables(executor, dirname, main_program=pruned,
                      filename=params_filename)
    return target_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    program = proto.load_program(
        os.path.join(dirname, model_filename or MODEL_FILENAME))
    with open(os.path.join(dirname, "__meta__.json")) as f:
        meta = json.load(f)
    load_persistables(executor, dirname, main_program=program,
                      filename=params_filename)
    fetch_vars = [program.global_block().var(n) for n in meta["fetch"]]
    return program, meta["feed"], fetch_vars


def get_program_parameter(program):
    return list(program.all_parameters())
