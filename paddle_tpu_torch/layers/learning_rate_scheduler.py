"""Learning-rate schedules as graph ops (mirrors
``paddle_tpu/layers/learning_rate_scheduler.py``): each schedule is a
small subgraph on the global step counter ``@LR_DECAY_COUNTER@``, a
persistable float32 ``[1]`` that an ``increment`` op prepended to the
global block (``op_role: lr_sched``) advances once a step.  The counter
and every op of the schedule stay on the device, so a step replayed from
a captured CUDA graph advances the schedule as an eager step does;
``Program.clone(for_test=True)`` drops the increment, so an evaluation
does not advance it."""

import math

from ..framework import default_main_program
from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper
from . import ops
from . import tensor

__all__ = ["exponential_decay", "natural_exp_decay", "inverse_time_decay",
           "polynomial_decay", "piecewise_decay", "noam_decay",
           "cosine_decay", "linear_lr_warmup"]


def _global_step(counter_name="@LR_DECAY_COUNTER@"):
    """The global step counter, created with its increment on first use."""
    helper = LayerHelper("global_step_counter")
    block = default_main_program().global_block()
    if block.has_var(counter_name):
        return block.var(counter_name)
    counter = block.create_var(name=counter_name, dtype="float32",
                               shape=[1], persistable=True)
    helper.set_variable_initializer(counter, ConstantInitializer(0.0))
    block._prepend_op(type="increment", inputs={"X": [counter]},
                      outputs={"Out": [counter]},
                      attrs={"step": 1.0, "op_role": "lr_sched"})
    counter.stop_gradient = True
    return counter


def noam_decay(d_model, warmup_steps):
    from .nn import elementwise_min

    step = _global_step()
    a = ops.pow(step, -0.5)
    b = step * (warmup_steps ** -1.5)
    return elementwise_min(a, b) * (d_model ** -0.5)


def _pow_scalar_base(base, exponent_var):
    """``base ** x`` as ``exp(x * ln(base))``."""
    return ops.exp(exponent_var * math.log(base))


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _global_step()
    div = step / float(decay_steps)
    if staircase:
        div = ops.floor(div)
    return _pow_scalar_base(decay_rate, div) * float(learning_rate)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _global_step()
    div = step / float(decay_steps)
    if staircase:
        div = ops.floor(div)
    return learning_rate * ops.exp(div * (-decay_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    step = _global_step()
    div = step / float(decay_steps)
    if staircase:
        div = ops.floor(div)
    denom = div * decay_rate + 1.0
    return tensor.fill_constant([1], "float32", learning_rate) / denom


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    """With ``cycle`` the horizon is ``decay_steps * ceil(step /
    decay_steps)``, restarting each period (a ``where`` on step 0)."""
    from .control_flow import equal
    from .nn import elementwise_min, where

    step = _global_step()
    if cycle:
        div = ops.ceil(step / float(decay_steps))
        one = tensor.fill_constant([1], "float32", 1.0)
        zero = tensor.fill_constant([1], "float32", 0.0)
        div = where(equal(step, zero), one, div)
        frac = step / (div * float(decay_steps))
    else:
        capped = elementwise_min(
            step, tensor.fill_constant([1], "float32", float(decay_steps)))
        frac = capped / float(decay_steps)
    one_minus = frac * (-1.0) + 1.0
    return (learning_rate - end_learning_rate) * ops.pow(
        one_minus, power) + end_learning_rate


def piecewise_decay(boundaries, values):
    from .nn import where

    step = _global_step()
    lr = tensor.fill_constant([1], "float32", values[-1])
    # chained wheres, built from the last boundary back
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        cond = step < float(b)
        lr = where(cond, tensor.fill_constant([1], "float32", v), lr)
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    step = _global_step()
    epoch = ops.floor(step / float(step_each_epoch))
    inner = epoch * (math.pi / float(epochs))
    return 0.5 * learning_rate * (ops.cos(inner) + 1.0)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    from .nn import where

    step = _global_step()
    warm = start_lr + (end_lr - start_lr) * (step / float(warmup_steps))
    if not hasattr(learning_rate, "name"):
        learning_rate = tensor.fill_constant([1], "float32",
                                             float(learning_rate))
    return where(step < float(warmup_steps), warm, learning_rate)
