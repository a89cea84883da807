"""Initializers emitted as startup-program ops (mirrors
``paddle_tpu/initializer.py``: each __call__ appends a fill_constant /
gaussian_random / uniform_random / truncated_gaussian_random op to the
startup block; the executor draws them from a seeded
``torch.Generator``)."""

import math

import numpy as np

__all__ = [
    "Initializer",
    "Constant",
    "ConstantInitializer",
    "Uniform",
    "UniformInitializer",
    "Normal",
    "NormalInitializer",
    "TruncatedNormal",
    "TruncatedNormalInitializer",
    "Xavier",
    "XavierInitializer",
    "MSRA",
    "MSRAInitializer",
    "set_global_initializer",
]

_global_weight_initializer_ = None
_global_bias_initializer_ = None


def set_global_initializer(weight_init, bias_init=None):
    global _global_weight_initializer_, _global_bias_initializer_
    _global_weight_initializer_ = weight_init
    _global_bias_initializer_ = bias_init


def _global_weight_initializer():
    return _global_weight_initializer_


def _global_bias_initializer():
    return _global_bias_initializer_


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError

    def _compute_fans(self, var):
        shape = var.shape
        if not shape or len(shape) == 0:
            fan_in = fan_out = 1
        elif len(shape) == 1:
            fan_in = fan_out = shape[0]
        elif len(shape) == 2:
            fan_in, fan_out = shape[0], shape[1]
        else:
            receptive = int(np.prod(shape[2:]))
            fan_in = shape[1] * receptive
            fan_out = shape[0] * receptive
        return fan_in, fan_out


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self._value = value

    def __call__(self, var, block):
        return block.append_op(
            type="fill_constant",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "value": float(self._value),
            },
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self._low, self._high, self._seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            type="uniform_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "min": self._low,
                "max": self._high,
                "seed": self._seed,
            },
        )


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self._mean, self._std, self._seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type="gaussian_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "mean": self._mean,
                "std": self._std,
                "seed": self._seed,
            },
        )


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self._mean, self._std, self._seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type="truncated_gaussian_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "mean": self._mean,
                "std": self._std,
                "seed": self._seed,
            },
        )


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self._uniform, self._fan_in, self._fan_out, self._seed = (
            uniform, fan_in, fan_out, seed,
        )

    def __call__(self, var, block):
        f_in, f_out = self._compute_fans(var)
        fan_in = f_in if self._fan_in is None else self._fan_in
        fan_out = f_out if self._fan_out is None else self._fan_out
        if self._uniform:
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            return UniformInitializer(-limit, limit, self._seed)(var, block)
        std = math.sqrt(2.0 / (fan_in + fan_out))
        return NormalInitializer(0.0, std, self._seed)(var, block)


class MSRAInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, seed=0):
        self._uniform, self._fan_in, self._seed = uniform, fan_in, seed

    def __call__(self, var, block):
        f_in, _ = self._compute_fans(var)
        fan_in = f_in if self._fan_in is None else self._fan_in
        if self._uniform:
            limit = math.sqrt(6.0 / fan_in)
            return UniformInitializer(-limit, limit, self._seed)(var, block)
        std = math.sqrt(2.0 / fan_in)
        return NormalInitializer(0.0, std, self._seed)(var, block)


# reference short aliases
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer

