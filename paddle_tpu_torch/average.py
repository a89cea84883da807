"""Weighted averaging on the host (mirrors ``paddle_tpu/average.py``):
``WeightedAverage`` keeps a running weighted mean of numbers or numpy
arrays, such as a training loop's losses."""

import numpy as np

__all__ = ["WeightedAverage"]


def _is_number_or_matrix(var):
    return isinstance(var, (int, float, np.ndarray)) or (
        isinstance(var, (list, tuple))
        and all(isinstance(v, (int, float)) for v in var))


class WeightedAverage:
    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = None
        self.denominator = None

    def add(self, value, weight):
        if not _is_number_or_matrix(value):
            raise ValueError(
                "The 'value' must be a number(int, float) or a numpy array.")
        if not isinstance(weight, (int, float)):
            raise ValueError("The 'weight' must be a number(int, float).")
        value = np.mean(np.asarray(value, dtype="float64"))
        if self.numerator is None:
            self.numerator = value * weight
            self.denominator = float(weight)
        else:
            self.numerator += value * weight
            self.denominator += float(weight)

    def eval(self):
        if self.numerator is None or self.denominator == 0.0:
            raise ValueError(
                "There is no data to be averaged in WeightedAverage.")
        return self.numerator / self.denominator
