"""Dygraph checkpoints (mirrors ``paddle_tpu/dygraph/checkpoint.py``):
the same ``<path>.pdparams.npz`` file of numpy arrays under the state
dict's keys, so a checkpoint saved by either package loads in the
other."""

import os

import numpy as np
import torch

__all__ = ["save_dygraph", "load_dygraph", "save_persistables",
           "load_persistables"]


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_dygraph(state_dict, model_path):
    np.savez(model_path + ".pdparams.npz",
             **{k: _host(v) for k, v in state_dict.items()})


def load_dygraph(model_path):
    path = model_path + ".pdparams.npz"
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with np.load(path) as data:
        return {k: data[k] for k in data.files}, None


def save_persistables(model_dict, dirname="save_dir"):
    os.makedirs(dirname, exist_ok=True)
    save_dygraph(model_dict, os.path.join(dirname, "params"))


def load_persistables(dirname="save_dir"):
    state, _ = load_dygraph(os.path.join(dirname, "params"))
    return state
