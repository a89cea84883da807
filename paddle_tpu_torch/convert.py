"""Parameters from the reference package into the port.

The reference keeps parameters as jax arrays in its ``Scope`` and
exports them as one ``<name>.npy`` per persistable beside ``__model__``
(``paddle_tpu/io.py``); both use the same names as the port, since the
model builders are the same.  :func:`read_exported_params` reads an
exported directory into a ``{name: np.ndarray}`` dict, and
:func:`scope_persistables` reads every persistable var of a program out
of a scope of either package (parameters, and the state a step carries:
batch_norm's moving means and variances, optimizer accumulators, among
them LAMB's moments and beta powers and LARS's velocity, and the
learning-rate schedules' ``@LR_DECAY_COUNTER@``, so both packages can
start from one state mid-schedule);
:func:`load_layer_state` and :func:`load_optimizer_state` carry a
dygraph ``Layer``'s ``state_dict()`` and an optimizer's eager state from
either package into a port layer and optimizer;
:func:`convert_params` turns such a dict into the port's CPU tensors and
:func:`load_params_into_scope` places them in a port ``Scope`` on a
device.  The port's random initialisation draws other numbers than the
reference's from the same seed, so these are how the two packages are
held to the same weights.

Every parameter keeps the reference's layout, so arrays cross as they
are: conv filters [C_out, C_in / groups, kh, kw] (grouped, depthwise and
``deformable_conv``'s, whose offset and mask maps come from ordinary
convs), 3-D filters [C_out, C_in / groups, kd, kh, kw], transposed
filters [C_in, C_out / groups, k...] (the layout of
``F.conv_transpose2d`` / ``3d``, so no op permutes them), fc weights
[in, out], embeddings [vocab, width]; the checks above are the shapes a
program declares."""

import json
import os

import numpy as np
import torch

from . import core
from . import proto
from .ops.registry import np_to_torch

__all__ = ["read_exported_params", "scope_persistables", "convert_params",
           "load_params_into_scope", "load_layer_state",
           "load_optimizer_state"]


def read_exported_params(dirname, model_filename="__model__"):
    """``{name: np.ndarray}`` of every persistable an exported inference
    directory holds (one ``.npy`` per var)."""
    program = proto.load_program(os.path.join(dirname, model_filename))
    out = {}
    for v in program.list_vars():
        if not v.persistable or v.is_data:
            continue
        path = os.path.join(dirname, v.name.replace("/", "_") + ".npy")
        if os.path.exists(path):
            out[v.name] = np.load(path)
    if not out:
        raise ValueError("no parameter files found under %r (meta: %s)"
                         % (dirname, json.dumps(os.listdir(dirname))))
    return out


def scope_persistables(program, scope):
    """``{name: np.ndarray}`` of every persistable, non-data var of
    ``program`` that ``scope`` holds.  ``scope`` is a ``Scope`` of this
    package or of the reference (anything with ``get(name)``); values
    are copied to host numpy arrays."""
    out = {}
    for v in program.list_vars():
        if not v.persistable or v.is_data:
            continue
        val = scope.get(v.name)
        if val is None:
            continue
        if isinstance(val, torch.Tensor):
            val = val.detach().cpu().numpy()
        out[v.name] = np.array(val)
    return out


def convert_params(params, program=None):
    """``{name: array}`` → ``{name: torch.Tensor}`` on the CPU.  With a
    port ``program``, each array is checked against the declared shape
    and cast to the declared dtype of its var (the reference stores int64
    vars as int32, as jax without x64 does)."""
    out = {}
    block = program.global_block() if program is not None else None
    for name, arr in params.items():
        arr = np.asarray(arr)
        if block is not None:
            var = block._find_var_recursive(name)
            if var is None:
                raise KeyError("parameter %r is not a var of the program"
                               % name)
            if var.shape is not None and tuple(var.shape) != arr.shape:
                raise ValueError("parameter %r has shape %s, the program "
                                 "declares %s" % (name, arr.shape,
                                                  tuple(var.shape)))
            t = np_to_torch(arr, "cpu").to(core.torch_dtype(var.dtype))
        else:
            t = np_to_torch(arr, "cpu")
        out[name] = t
    return out


def load_params_into_scope(params, scope, device="cpu", program=None):
    """Place converted parameters in a port ``Scope`` on ``device`` (a
    torch device, device string or Place)."""
    dev = core.as_torch_device(device)
    for name, t in convert_params(params, program).items():
        scope.set(name, t.to(dev))
    return scope


def load_layer_state(layer, source):
    """Write the ``state_dict()`` of dygraph layer ``source`` (of either
    package: keys are attribute paths in both) into the port's ``layer``
    in place; every key of ``layer`` must be there, with its shape."""
    state = {k: np.asarray(v) for k, v in source.state_dict().items()}
    own = layer.state_dict()
    missing = [k for k in own if k not in state]
    if missing:
        raise KeyError("the source layer lacks %s" % missing)
    for k, v in own.items():
        if v.shape != state[k].shape:
            raise ValueError("%r has shape %s in the source, %s here"
                             % (k, state[k].shape, v.shape))
    layer.set_dict(state)
    return layer


def load_optimizer_state(optimizer, source, source_params, params):
    """Load into the port's ``optimizer`` the eager accumulators of
    optimizer ``source`` (of either package), whose parameters
    ``source_params`` correspond one to one, in order, to the port's
    ``params``: the state is keyed by parameter name, and each package
    names its parameters from its own counters."""
    if len(source_params) != len(params):
        raise ValueError("%d source parameters against %d"
                         % (len(source_params), len(params)))
    state = getattr(source, "_eager_state", {})
    out = {}
    for sp, p in zip(source_params, params):
        if sp.name in state:
            out[p.name] = {k: np.array(v.detach().cpu() if isinstance(
                v, torch.Tensor) else v) for k, v in state[sp.name].items()}
    optimizer.load(out)
    return optimizer
