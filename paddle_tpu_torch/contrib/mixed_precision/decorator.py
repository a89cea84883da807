"""The bf16 program rewrite and the AMP optimizer decorator (mirrors
``paddle_tpu/contrib/mixed_precision/decorator.py``).

:func:`rewrite_program_bf16` puts a ``cast`` to bfloat16 in front of
every float32 input of a white-listed op and retypes that op's float32
outputs to bfloat16, and puts a ``cast`` to float32 in front of every
bfloat16 input of a black-listed op.  Parameters stay float32 masters:
a white-listed op reads the parameter's ``.cast_bfloat16`` copy, and
the ``cast`` op's gradient casts back to float32, so the optimizer
updates float32 parameters with float32 gradients.  The loss-scaling
arguments are accepted and ignored, as bf16 needs no loss scaling.

Where the reference's rewrite runs after regions exist (a model built
with ``layers.recompute()``, or ``RecomputeOptimizer`` wrapping the
decorated optimizer), it leaves the regions float32; this one walks into
them.  Rewritten first (``decorate(RecomputeOptimizer(...))``, the
reference test's order), both packages build the same program."""

from ... import unique_name
from ...framework import Operator
from .fp16_lists import AutoMixedPrecisionLists

__all__ = ["decorate", "OptimizerWithMixedPrecision", "rewrite_program_bf16"]


def rewrite_program_bf16(program, amp_lists=None):
    """Rewrite the global block of ``program`` in place (see the module
    docstring) and return it.  A var cast once to a dtype is cast once:
    later readers in the same block share the cast.  The rewrite walks
    into ``recompute_block`` regions and puts their casts inside them, so
    a region's second run casts again instead of the step keeping the
    casts."""
    _rewrite_block(program.global_block(),
                   amp_lists or AutoMixedPrecisionLists())
    program._bump_version()
    return program


def _rewrite_block(block, amp_lists):
    cast_cache = {}  # (var, dtype) -> cast var name
    new_ops = []

    def cast_input(op, target_dtype, from_dtypes):
        for slot, names in op.inputs.items():
            new_names = []
            for n in names:
                var = block._find_var_recursive(n)
                if var is None or var.dtype not in from_dtypes:
                    new_names.append(n)
                    continue
                key = (n, target_dtype)
                if key not in cast_cache:
                    cast_name = unique_name.generate(n + ".cast_" + target_dtype)
                    block.create_var(
                        name=cast_name, shape=var.shape, dtype=target_dtype,
                        persistable=False, stop_gradient=var.stop_gradient)
                    new_ops.append(Operator(
                        block, "cast", {"X": [n]}, {"Out": [cast_name]},
                        {"in_dtype": var.dtype, "out_dtype": target_dtype}))
                    cast_cache[key] = cast_name
                new_names.append(cast_cache[key])
            op.inputs[slot] = new_names

    for op in block.ops:
        if op.type == "recompute_block":
            _rewrite_block(block.program.block(op.attrs["sub_block"]),
                           amp_lists)
        elif op.type in amp_lists.white_list:
            cast_input(op, "bfloat16", ("float32",))
            # the op's float outputs are bf16 when it runs
            for name in op.output_arg_names:
                v = block._find_var_recursive(name)
                if v is not None and v.dtype == "float32":
                    v.dtype = "bfloat16"
        elif op.type in amp_lists.black_list:
            cast_input(op, "float32", ("bfloat16",))
        new_ops.append(op)
    block.ops = new_ops


class OptimizerWithMixedPrecision:
    """An optimizer whose ``minimize`` / ``backward`` rewrite the loss's
    program to bf16 first."""

    def __init__(self, optimizer, amp_lists=None, init_loss_scaling=1.0,
                 use_dynamic_loss_scaling=False, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.8):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._loss_scaling = init_loss_scaling  # bf16 needs none

    def backward(self, loss, **kwargs):
        rewrite_program_bf16(loss.block.program, self._amp_lists)
        return self._optimizer.backward(loss, **kwargs)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        rewrite_program_bf16(loss.block.program, self._amp_lists)
        return self._optimizer.minimize(
            loss, startup_program, parameter_list, no_grad_set)


def decorate(optimizer, amp_lists=None, init_loss_scaling=1.0,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=False):
    """Wrap ``optimizer`` in :class:`OptimizerWithMixedPrecision`."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio, decr_ratio)
