"""Decoupled weight decay (mirrors
``paddle_tpu/contrib/extend_optimizer/__init__.py``): any optimizer
class extended so that its ``minimize`` scales each parameter down by
``coeff`` with ops appended before the update (``p -= coeff * p``, the
AdamW-style decoupling: the decay is no part of the gradient, so the
adaptive scaling never touches it).  The decay's ``assign`` writes the
parameter through a new value, which a captured step copies back into
the resident tensor (one copy a parameter)."""

from ...framework import Variable

__all__ = ["extend_with_decoupled_weight_decay"]


class DecoupledWeightDecay:
    def __init__(self, coeff=0.0, apply_decay_param_fun=None, **kwargs):
        if not isinstance(coeff, (float, int, Variable)):
            raise TypeError("coeff should be float or Variable")
        self._coeff = coeff
        self._apply_decay_param_fun = apply_decay_param_fun
        self._decayed_params = set()
        super().__init__(**kwargs)

    def _append_decay_ops(self, params_grads):
        from ... import layers

        if isinstance(self._coeff, (float, int)) \
                and float(self._coeff) == 0.0:
            return
        for param, grad in params_grads:
            if grad is None:
                continue
            if self._apply_decay_param_fun is not None \
                    and not self._apply_decay_param_fun(param.name):
                continue
            if param.name in self._decayed_params:
                raise RuntimeError("param %r already decayed by this "
                                   "optimizer" % param.name)
            self._decayed_params.add(param.name)
            if isinstance(self._coeff, Variable):
                scaled = layers.elementwise_mul(param, self._coeff)
            else:
                scaled = layers.scale(param, scale=float(self._coeff))
            layers.assign(layers.elementwise_sub(param, scaled),
                          output=param)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_clip=None):
        from ...clip import per_call_gradient_clip

        params_grads = self.backward(
            loss, startup_program=startup_program,
            parameter_list=parameter_list, no_grad_set=no_grad_set)
        # the decay ops come before the update ops, so an update reads
        # the decayed parameter (the reference's order)
        self._append_decay_ops(params_grads)
        with per_call_gradient_clip(loss.block.program, grad_clip):
            optimize_ops = self.apply_optimize(loss, startup_program,
                                               params_grads)
        return optimize_ops, params_grads

    def __str__(self):
        return "Weight Decay, params: %s" % ",".join(
            sorted(self._decayed_params))


def extend_with_decoupled_weight_decay(base_optimizer):
    """A subclass of ``base_optimizer`` whose ``minimize`` applies
    decoupled weight decay::

        AdamW = extend_with_decoupled_weight_decay(fluid.optimizer.Adam)
        AdamW(weight_decay=0.01, learning_rate=1e-3).minimize(loss)
    """
    from ...optimizer import Optimizer

    if not issubclass(base_optimizer, Optimizer):
        raise TypeError("base_optimizer must be an Optimizer subclass")

    class OptimizerWithDecoupledWeightDecay(DecoupledWeightDecay,
                                            base_optimizer):
        def __init__(self, weight_decay, apply_decay_param_fun=None,
                     **kwargs):
            super().__init__(weight_decay, apply_decay_param_fun, **kwargs)

    return OptimizerWithDecoupledWeightDecay
