"""Dygraph learning-rate decay objects (mirrors
``paddle_tpu/dygraph/learning_rate_scheduler.py``: ``LearningRateDecay``
and its 7 subclasses, the eager counterparts of the graph-op schedules in
``layers/learning_rate_scheduler.py``).

An instance is passed as ``learning_rate`` to an optimizer; each
minimize() consumes one step's value (``step()``)."""

import math

__all__ = [
    "LearningRateDecay", "PiecewiseDecay", "NaturalExpDecay",
    "ExponentialDecay", "InverseTimeDecay", "PolynomialDecay",
    "CosineDecay", "NoamDecay",
]


class LearningRateDecay:
    def __init__(self, begin=0, step=1):
        self.step_num = int(begin)
        self.step_size = int(step)

    def value(self):
        raise NotImplementedError

    def step(self):
        v = self.value()
        self.step_num += self.step_size
        return v

    def create_lr_var(self, lr):
        """The float as a [1] float32 tensor on the current dygraph
        device."""
        import torch

        from .varbase import current_device

        return torch.full((1,), float(lr), dtype=torch.float32,
                          device=current_device())

    # reference API: calling the object yields the current value
    def __call__(self):
        return self.value()


class PiecewiseDecay(LearningRateDecay):
    def __init__(self, boundaries, values, begin, step=1):
        super().__init__(begin, step)
        self.boundaries = list(boundaries)
        self.values = list(values)

    def value(self):
        for b, v in zip(self.boundaries, self.values):
            if self.step_num < b:
                return v
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1):
        super().__init__(begin, step)
        self.lr = learning_rate
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def value(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.lr * math.exp(-self.decay_rate * div)


class ExponentialDecay(NaturalExpDecay):
    def value(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.lr * (self.decay_rate ** div)


class InverseTimeDecay(NaturalExpDecay):
    def value(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.lr / (1.0 + self.decay_rate * div)


class PolynomialDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, end_learning_rate=0.0001,
                 power=1.0, cycle=False, begin=0, step=1):
        super().__init__(begin, step)
        self.lr = learning_rate
        self.decay_steps = decay_steps
        self.end_lr = end_learning_rate
        self.power = power
        self.cycle = cycle

    def value(self):
        n = self.step_num
        steps = self.decay_steps
        if self.cycle:
            div = math.ceil(n / steps) if n > 0 else 1.0
            steps = steps * max(div, 1.0)
        else:
            n = min(n, steps)
        return ((self.lr - self.end_lr)
                * (1 - n / steps) ** self.power + self.end_lr)


class CosineDecay(LearningRateDecay):
    def __init__(self, learning_rate, step_each_epoch, epochs, begin=0,
                 step=1):
        super().__init__(begin, step)
        self.lr = learning_rate
        self.step_each_epoch = step_each_epoch
        self.epochs = epochs

    def value(self):
        cur_epoch = math.floor(self.step_num / self.step_each_epoch)
        return (self.lr * 0.5
                * (math.cos(cur_epoch * math.pi / self.epochs) + 1))


class NoamDecay(LearningRateDecay):
    def __init__(self, d_model, warmup_steps, begin=1, step=1):
        super().__init__(begin, step)
        self.d_model = d_model
        self.warmup_steps = warmup_steps

    def value(self):
        n = max(self.step_num, 1)
        a = n ** -0.5
        b = (self.warmup_steps ** -1.5) * n
        return (self.d_model ** -0.5) * min(a, b)
