"""Dygraph Layer base (mirrors ``paddle_tpu/dygraph/layers.py``).

Attributes that are persistable VarBases are the layer's parameters
(batch norm's running statistics among them, as in the reference, which
take no gradient) and attributes that are Layers its sublayers;
``state_dict`` keys are their attribute paths, so a state dict of either
package loads into the other's layer."""

from collections import OrderedDict

import numpy as np

from .varbase import VarBase

__all__ = ["Layer"]


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        self._parameters = OrderedDict()
        self._sub_layers = OrderedDict()
        self.training = True
        self._full_name = name_scope or self.__class__.__name__.lower()

    def full_name(self):
        return self._full_name

    def add_parameter(self, name, parameter):
        if not (isinstance(parameter, VarBase) and parameter.persistable):
            raise TypeError(
                "add_parameter expects a persistable VarBase (a "
                "parameter); got %r — create it via create_parameter or "
                "VarBase(..., persistable=True)" % (parameter,))
        setattr(self, name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        setattr(self, name, sublayer)
        return sublayer

    def create_variable(self, name=None, persistable=None, dtype="float32",
                        type=None):
        """A non-parameter buffer."""
        return VarBase(np.zeros((1,), dtype), persistable=bool(persistable),
                       stop_gradient=True)

    def backward(self, *inputs):
        raise ValueError("Layer.backward is not implemented; call "
                         "backward() on the loss VarBase instead")

    def create_parameter(self, shape, dtype, value):
        from .. import unique_name

        # unique per-process names (deterministic under the same model
        # construction order) key the optimizer's accumulator state, so
        # Optimizer.load can restore it across processes
        return VarBase(np.asarray(value, dtype),
                       name=unique_name.generate("eager_param"),
                       persistable=True, stop_gradient=False)

    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        subs = self.__dict__.get("_sub_layers")
        if isinstance(value, VarBase) and value.persistable \
                and params is not None:
            params[name] = value
        elif isinstance(value, Layer) and subs is not None:
            subs[name] = value
        object.__setattr__(self, name, value)

    def parameters(self, include_sublayers=True):
        out = list(self._parameters.values())
        if include_sublayers:
            for layer in self._sub_layers.values():
                out.extend(layer.parameters())
        return out

    def sublayers(self, include_sublayers=True):
        out = list(self._sub_layers.values())
        if include_sublayers:
            for layer in self._sub_layers.values():
                out.extend(layer.sublayers())
        return out

    def train(self):
        self.training = True
        for layer in self._sub_layers.values():
            layer.train()

    def eval(self):
        self.training = False
        for layer in self._sub_layers.values():
            layer.eval()

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    # ---- state dict (the reference's dygraph/checkpoint.py keys) ----
    def state_dict(self, prefix=""):
        out = OrderedDict()
        for name, p in self._parameters.items():
            out[prefix + name] = p.numpy()
        for lname, layer in self._sub_layers.items():
            out.update(layer.state_dict(prefix + lname + "."))
        return out

    def set_dict(self, state, prefix=""):
        for name, p in self._parameters.items():
            key = prefix + name
            if key in state:
                p.set_value(state[key])
        for lname, layer in self._sub_layers.items():
            layer.set_dict(state, prefix + lname + ".")

    load_dict = set_dict
