"""Optimizers of the static-graph path (mirrors ``paddle_tpu/optimizer.py``:
the ``Optimizer`` base with ``_create_global_learning_rate`` :94,
``_add_accumulator`` :141, ``_create_optimization_pass`` :196,
``apply_gradients`` :216, ``minimize`` :233; ``SGDOptimizer`` :368-393;
``MomentumOptimizer`` :395-443; ``AdamOptimizer`` :549-631).  ``minimize`` = ``append_backward`` + one
optimizer op per parameter, whose lowering (``ops/optimizer_ops.py``)
writes new tensors that the executor binds to the same names.  The
dygraph paths and the other optimizers are not ported yet (ROADMAP.md)."""

from collections import defaultdict

from . import unique_name
from .backward import append_backward
from .clip import append_gradient_clip_ops, per_call_gradient_clip
from .framework import (Variable, default_main_program,
                        default_startup_program, name_scope, program_guard)
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = ["Optimizer", "SGD", "SGDOptimizer", "Momentum",
           "MomentumOptimizer", "Adam", "AdamOptimizer"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        if not isinstance(learning_rate, (float, int, Variable)):
            raise TypeError("learning_rate must be a float or a Variable")
        self.regularization = regularization
        self._name = name
        self._learning_rate = learning_rate
        self._learning_rate_map = {}
        self._accumulators = defaultdict(dict)  # {acc: {param: var}}
        self.type = getattr(self, "type", "optimizer")

    def get_opti_var_name_list(self):
        out = [v.name for accs in self._accumulators.values()
               for v in accs.values()]
        out += [lr.name for lr in self._learning_rate_map.values()]
        return out

    # ---- learning rate ----
    def _create_global_learning_rate(self):
        program = default_main_program()
        if program in self._learning_rate_map:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[program] = self._learning_rate
            return
        lr_var = program.global_block().create_var(
            name=unique_name.generate("learning_rate"), shape=[1],
            dtype="float32", persistable=True)
        lr_var.stop_gradient = True
        LayerHelper("learning_rate").set_variable_initializer(
            lr_var, ConstantInitializer(float(self._learning_rate)))
        self._learning_rate_map[program] = lr_var

    def _global_learning_rate(self, program=None):
        return self._learning_rate_map.get(program or default_main_program())

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        param_lr = float(param.optimize_attr.get("learning_rate", 1.0))
        base = self._global_learning_rate()
        if param_lr == 1.0:
            return base
        helper = LayerHelper("param_lr")
        out = helper.create_variable_for_type_inference("float32", True)
        helper.append_op(type="scale", inputs={"X": [base]},
                         outputs={"Out": [out]},
                         attrs={"scale": param_lr, "bias": 0.0})
        return out

    # ---- accumulators ----
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        shape = param.shape if shape is None else shape
        var = default_main_program().global_block().create_var(
            name=unique_name.generate("_".join([param.name, self.type,
                                                name])),
            shape=list(shape), dtype=dtype or "float32", persistable=True)
        var.stop_gradient = True
        if list(shape) == list(param.shape or []):
            var._is_optimizer_state = True
        LayerHelper(self.type).set_variable_initializer(
            var, ConstantInitializer(float(fill_value)))
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # ---- subclass hooks ----
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # ---- driver ----
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            return append_backward(loss, parameter_list, no_grad_set)

    def _create_optimization_pass(self, parameters_and_grads):
        program = default_main_program()
        with name_scope("optimizer"):
            self._create_global_learning_rate()
            block = program.global_block()
            self._create_accumulators(
                block, [p for p, g in parameters_and_grads if g is not None])
            return [self._append_optimize_op(block, pg)
                    for pg in parameters_and_grads
                    if pg[1] is not None and pg[0].trainable]

    def apply_gradients(self, params_grads):
        """clip → regularize → one optimizer op per parameter."""
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        self._create_optimization_pass(params_grads)
        return params_grads

    def apply_optimize(self, loss, startup_program, params_grads):
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            self.apply_gradients(params_grads)
        return []

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_clip=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        with per_call_gradient_clip(loss.block.program, grad_clip):
            optimize_ops = self.apply_optimize(loss, startup_program,
                                               params_grads)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, regularization=None, name=None):
        self.type = "sgd"
        super().__init__(learning_rate, regularization, name)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        return block.append_op(
            type="sgd",
            inputs={"Param": [param], "Grad": [grad],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param]}, attrs={"op_role": "optimize"})


class MomentumOptimizer(Optimizer):
    """One zero-initialised velocity per parameter; the ``momentum`` op
    with ``mu`` and ``use_nesterov``."""

    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 regularization=None, name=None):
        self.type = "momentum"
        super().__init__(learning_rate, regularization, name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        velocity = self._get_accumulator(self._velocity_acc_str, param)
        return block.append_op(
            type="momentum",
            inputs={"Param": [param], "Grad": [grad], "Velocity": [velocity],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "VelocityOut": [velocity]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov,
                   "op_role": "optimize"})


class AdamOptimizer(Optimizer):
    _moment1_acc_str = "moment1"
    _moment2_acc_str = "moment2"
    _beta1_pow_acc_str = "beta1_pow_acc"
    _beta2_pow_acc_str = "beta2_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None,
                 lazy_mode=False):
        self.type = "adam"
        super().__init__(learning_rate, regularization, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._lazy_mode = lazy_mode

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment1_acc_str, p)
            self._add_accumulator(self._moment2_acc_str, p)
            self._add_accumulator(self._beta1_pow_acc_str, p,
                                  fill_value=self._beta1, shape=[1])
            self._add_accumulator(self._beta2_pow_acc_str, p,
                                  fill_value=self._beta2, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        m1, m2, b1p, b2p = (self._get_accumulator(a, param) for a in (
            self._moment1_acc_str, self._moment2_acc_str,
            self._beta1_pow_acc_str, self._beta2_pow_acc_str))
        return block.append_op(
            type="adam",
            inputs={"Param": [param], "Grad": [grad],
                    "LearningRate": [self._create_param_lr(param_and_grad)],
                    "Moment1": [m1], "Moment2": [m2], "Beta1Pow": [b1p],
                    "Beta2Pow": [b2p]},
            outputs={"ParamOut": [param], "Moment1Out": [m1],
                     "Moment2Out": [m2], "Beta1PowOut": [b1p],
                     "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "lazy_mode": self._lazy_mode,
                   "op_role": "optimize"})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
