"""Optimizers of the static-graph path (mirrors ``paddle_tpu/optimizer.py``:
the ``Optimizer`` base with ``_create_global_learning_rate`` :94,
``_add_accumulator`` :141, ``_create_optimization_pass`` :196,
``apply_gradients`` :216, ``minimize`` :233; ``SGDOptimizer`` :368-393;
``MomentumOptimizer`` :395-443; ``LarsMomentumOptimizer`` :449;
``AdagradOptimizer`` :489; ``DecayedAdagradOptimizer`` :521;
``AdamOptimizer`` :549-631; ``AdamaxOptimizer`` :633;
``AdadeltaOptimizer`` :692; ``RMSPropOptimizer`` :736; ``FtrlOptimizer``
:788; ``LambOptimizer`` :831; ``DGCMomentumOptimizer`` :873;
``_mirror_var`` :900; ``ExponentialMovingAverage`` :914-1152;
``ModelAverage`` :1153-1295; ``PipelineOptimizer`` :1296;
``rewrite_program_recompute`` :1347 and ``RecomputeOptimizer`` :1409;
the aliases :1455-1465).
``minimize`` = ``append_backward``, then clip → regularize → one
optimizer op per parameter, whose lowering (``ops/optimizer_ops.py``)
writes the parameter and its accumulators in place.  The learning rate
is a float or a Variable (a schedule of ``layers.learning_rate_scheduler``).
``ExponentialMovingAverage`` and ``ModelAverage`` keep their state in
persistable vars updated by the training program; ``apply`` and
``restore`` run small programs of their own against the same scope.
The dygraph paths (``load`` :83, ``minimize``'s dygraph branch :237,
``_eager_state_for`` :256, ``_eager_lr`` :265, ``_eager_apply`` :281,
``_dygraph_apply_regularization`` :287, ``_dygraph_clip_grads`` :306,
``_dygraph_minimize`` :338, ``_eager_run_op`` :360 and the ``_eager_apply``
of SGD :373, Momentum :409 and Adam :576) run the registered ``sgd`` /
``momentum`` / ``adam`` ops on each parameter's tensor, so on the card
the hand-written in-place kernels do the update; the learning rate may
then be a ``dygraph.LearningRateDecay``, stepped once a ``minimize``.
Not ported yet: the reference's env-gated ``_fuse_adam_ops``; the real
DGC exchange and the GPipe runner behind ``PipelineOptimizer`` wait for
``parallel/`` (ROADMAP.md Queue A item 9)."""

import contextlib
import warnings
from collections import defaultdict

import torch

from . import unique_name
from .backward import append_backward
from .clip import append_gradient_clip_ops, per_call_gradient_clip
from .framework import (Operator, Program, Variable, default_main_program,
                        default_startup_program, name_scope, program_guard)
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = ["Optimizer", "SGD", "SGDOptimizer", "Momentum",
           "MomentumOptimizer", "Adagrad", "AdagradOptimizer",
           "DecayedAdagrad", "DecayedAdagradOptimizer", "Adam",
           "AdamOptimizer", "Adamax", "AdamaxOptimizer", "Adadelta",
           "AdadeltaOptimizer", "RMSProp", "RMSPropOptimizer", "Ftrl",
           "FtrlOptimizer", "Lamb", "LambOptimizer", "LarsMomentum",
           "LarsMomentumOptimizer", "ExponentialMovingAverage",
           "ModelAverage", "PipelineOptimizer", "RecomputeOptimizer",
           "DGCMomentumOptimizer"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        from .dygraph.learning_rate_scheduler import LearningRateDecay

        if not isinstance(learning_rate,
                          (float, int, Variable, LearningRateDecay)):
            raise TypeError("learning_rate must be float, Variable, or a "
                            "dygraph LearningRateDecay")
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

    def load(self, state_dict):
        """Restore the eager accumulator state (the dict is keyed by
        parameter name, which regenerates the same for the same
        model-construction order: rebuild the model before loading).
        Its values may be tensors or host arrays."""
        if not isinstance(state_dict, dict):
            raise TypeError("load expects the dict of per-param "
                            "accumulator maps (optimizer._eager_state)")
        self._eager_state = dict(state_dict)

    # ---- learning rate ----
    def _create_global_learning_rate(self):
        program = default_main_program()
        if program in self._learning_rate_map:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[program] = self._learning_rate
            return
        from .dygraph.learning_rate_scheduler import LearningRateDecay

        if isinstance(self._learning_rate, LearningRateDecay):
            raise TypeError(
                "dygraph LearningRateDecay objects are dygraph-only; on "
                "the graph path use layers.learning_rate_scheduler (e.g. "
                "layers.polynomial_decay) which builds the schedule as "
                "graph ops")
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
        from .framework import in_dygraph_mode

        if in_dygraph_mode():
            return self._dygraph_minimize(loss, parameter_list,
                                          grad_clip=grad_clip)
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        # the reference's mark naming THE loss (optimizer.py:246), which
        # the resilience-finite-guard check names in its finding
        loss.block.program._guard_loss_name = loss.name
        with per_call_gradient_clip(loss.block.program, grad_clip):
            optimize_ops = self.apply_optimize(loss, startup_program,
                                               params_grads)
        return optimize_ops, params_grads

    # ---- dygraph (eager) path: the same update ops on the parameters'
    # tensors; per-parameter accumulators live on the optimizer ----
    def _eager_state_for(self, param):
        """The parameter's accumulators, keyed by its unique name (which
        regenerates the same for the same model-construction order, so a
        state saved in one process restores in another), each a tensor
        on the parameter's device (a loaded host array is placed there at
        its first use)."""
        if not hasattr(self, "_eager_state"):
            self._eager_state = {}
        st = self._eager_state.setdefault(param.name, {})
        dev = param.value.device
        for k, v in st.items():
            if not isinstance(v, torch.Tensor) or v.device != dev:
                st[k] = torch.as_tensor(v).to(dev)
        return st

    def _eager_lr(self, param):
        """This minimize's learning rate as a [1] float32 tensor on the
        parameter's device, made once a device and minimize."""
        dev = param.value.device
        lr = self._eager_lr_tensors.get(dev)
        if lr is None:
            lr = self._eager_lr_tensors[dev] = torch.full(
                (1,), self._eager_lr_value, dtype=torch.float32,
                device=dev)
        return lr

    def _eager_apply(self, param):
        raise NotImplementedError(
            "%s has no dygraph update yet — use SGD/Momentum/Adam"
            % type(self).__name__)

    def _dygraph_apply_regularization(self, param):
        """Weight decay on the eager gradient (the dygraph analogue of
        ``append_regularization_ops``)."""
        from .regularizer import L1DecayRegularizer, L2DecayRegularizer

        reg = getattr(param, "regularizer", None) or self.regularization
        if isinstance(reg, L2DecayRegularizer):
            param._grad = param._grad + reg._regularization_coeff \
                * param.value
        elif isinstance(reg, L1DecayRegularizer):
            param._grad = param._grad + reg._regularization_coeff \
                * torch.sign(param.value)

    def _dygraph_clip_grads(self, grad_clip, params):
        """Eager analogue of ``append_gradient_clip_ops``: clip ``_grad``
        of every trainable parameter (the graph-path clip classes' math,
        so a model ported between modes trains the same)."""
        from .clip import (GradientClipByGlobalNorm, GradientClipByNorm,
                           GradientClipByValue)

        live = [p for p in params
                if getattr(p, "_grad", None) is not None and p.trainable]
        if isinstance(grad_clip, GradientClipByValue):
            for p in live:
                p._grad = torch.clamp(p._grad, grad_clip.min, grad_clip.max)
        elif isinstance(grad_clip, GradientClipByNorm):
            for p in live:
                n = torch.sqrt(torch.sum(torch.square(p._grad)))
                p._grad = p._grad * (grad_clip.clip_norm / torch.clamp(
                    n, min=grad_clip.clip_norm))
        elif isinstance(grad_clip, GradientClipByGlobalNorm):
            if not live:
                return
            gnorm = torch.sqrt(sum(torch.sum(torch.square(p._grad))
                                   for p in live))
            scale = grad_clip.clip_norm / torch.clamp(
                gnorm, min=grad_clip.clip_norm)
            for p in live:
                p._grad = p._grad * scale
        else:
            raise TypeError(
                "unsupported grad_clip %r on the dygraph path" % grad_clip)

    def _dygraph_minimize(self, loss, parameter_list, grad_clip=None):
        if parameter_list is None:
            raise ValueError(
                "dygraph minimize requires parameter_list (the Layer's "
                ".parameters())")
        if loss is not None and getattr(loss, "_grad", None) is None:
            loss.backward()
        from .dygraph.learning_rate_scheduler import LearningRateDecay

        lr = self._learning_rate
        if isinstance(lr, LearningRateDecay):
            # once a minimize: a step a parameter would give each
            # parameter another rate
            lr = lr.step()
        elif not isinstance(lr, (float, int)):
            raise TypeError("dygraph mode needs a float learning rate or a "
                            "dygraph.LearningRateDecay")
        self._eager_lr_value = float(lr)
        self._eager_lr_tensors = {}
        # the updates write the parameters in place, outside autograd
        with torch.no_grad():
            if grad_clip is not None:
                self._dygraph_clip_grads(grad_clip, parameter_list)
            for p in parameter_list:
                if getattr(p, "_grad", None) is None or not p.trainable:
                    continue
                self._dygraph_apply_regularization(p)
                self._eager_apply(p)
        return [], []


def _eager_run_op(op_type, ins, attrs):
    """One registered update op on eager tensors (``{slot: tensor}``),
    on the parameter's device."""
    from .ops.registry import LoweringContext, call_op, get_op_def

    ctx = LoweringContext(mode="train", device=ins["Param"].device)
    return call_op(get_op_def(op_type), ctx,
                   {k: [v] for k, v in ins.items()}, attrs)


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, regularization=None, name=None):
        self.type = "sgd"
        super().__init__(learning_rate, regularization, name)

    def _eager_apply(self, param):
        outs = _eager_run_op(
            "sgd", {"Param": param.value, "Grad": param._grad,
                    "LearningRate": self._eager_lr(param)}, {})
        param.set_value(outs["ParamOut"][0])

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

    def _eager_apply(self, param):
        st = self._eager_state_for(param)
        if "velocity" not in st:
            st["velocity"] = torch.zeros_like(param.value)
        outs = _eager_run_op(
            "momentum", {"Param": param.value, "Grad": param._grad,
                         "Velocity": st["velocity"],
                         "LearningRate": self._eager_lr(param)},
            {"mu": self._momentum, "use_nesterov": self._use_nesterov})
        param.set_value(outs["ParamOut"][0])
        st["velocity"] = outs["VelocityOut"][0]

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


class AdagradOptimizer(Optimizer):
    """One moment per parameter, filled with
    ``initial_accumulator_value``; the ``adagrad`` op."""

    _moment_acc_str = "moment"

    def __init__(self, learning_rate, epsilon=1e-6, regularization=None,
                 name=None, initial_accumulator_value=0.0):
        self.type = "adagrad"
        super().__init__(learning_rate, regularization, name)
        self._epsilon = epsilon
        self._initial_accumulator_value = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(
                self._moment_acc_str, p,
                fill_value=self._initial_accumulator_value)

    def _op_attrs(self):
        return {"epsilon": self._epsilon}

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator(self._moment_acc_str, param)
        return block.append_op(
            type=self.type,
            inputs={"Param": [param], "Grad": [grad], "Moment": [moment],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "MomentOut": [moment]},
            attrs=dict(self._op_attrs(), op_role="optimize"))


class DecayedAdagradOptimizer(AdagradOptimizer):
    """Adagrad's moment decayed by ``decay`` each step: the
    ``decayed_adagrad`` op."""

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6,
                 regularization=None, name=None):
        Optimizer.__init__(self, learning_rate, regularization, name)
        self.type = "decayed_adagrad"
        self._decay = decay
        self._epsilon = epsilon
        self._initial_accumulator_value = 0.0

    def _op_attrs(self):
        return {"decay": self._decay, "epsilon": self._epsilon}


class AdamaxOptimizer(Optimizer):
    """A moment, an infinity norm and ``Beta1Pow`` per parameter: the
    ``adamax`` op, then a ``scale`` op that advances ``Beta1Pow`` (the
    reference's order; ``scale`` is no in-place op, so a captured step
    copies each ``Beta1Pow`` back)."""

    _moment_acc_str = "moment"
    _inf_norm_acc_str = "inf_norm"
    _beta1_pow_acc_str = "beta1_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None):
        self.type = "adamax"
        super().__init__(learning_rate, regularization, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)
            self._add_accumulator(self._inf_norm_acc_str, p)
            self._add_accumulator(self._beta1_pow_acc_str, p,
                                  fill_value=self._beta1, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment, inf_norm, b1p = (self._get_accumulator(a, param) for a in (
            self._moment_acc_str, self._inf_norm_acc_str,
            self._beta1_pow_acc_str))
        op = block.append_op(
            type="adamax",
            inputs={"Param": [param], "Grad": [grad],
                    "LearningRate": [self._create_param_lr(param_and_grad)],
                    "Moment": [moment], "InfNorm": [inf_norm],
                    "Beta1Pow": [b1p]},
            outputs={"ParamOut": [param], "MomentOut": [moment],
                     "InfNormOut": [inf_norm]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "op_role": "optimize"})
        block.append_op(type="scale", inputs={"X": [b1p]},
                        outputs={"Out": [b1p]},
                        attrs={"scale": self._beta1, "op_role": "optimize"})
        return op


class AdadeltaOptimizer(Optimizer):
    """Two running averages per parameter; the ``adadelta`` op, which
    takes no learning rate (the argument is kept for the API)."""

    _avg_squared_grad_acc_str = "_avg_squared_grad"
    _avg_squared_update_acc_str = "_avg_squared_update"

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95,
                 regularization=None, name=None):
        self.type = "adadelta"
        super().__init__(learning_rate, regularization, name)
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._avg_squared_grad_acc_str, p)
            self._add_accumulator(self._avg_squared_update_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        asg = self._get_accumulator(self._avg_squared_grad_acc_str, param)
        asu = self._get_accumulator(self._avg_squared_update_acc_str, param)
        return block.append_op(
            type="adadelta",
            inputs={"Param": [param], "Grad": [grad],
                    "AvgSquaredGrad": [asg], "AvgSquaredUpdate": [asu]},
            outputs={"ParamOut": [param], "AvgSquaredGradOut": [asg],
                     "AvgSquaredUpdateOut": [asu]},
            attrs={"epsilon": self._epsilon, "rho": self._rho,
                   "op_role": "optimize"})


class RMSPropOptimizer(Optimizer):
    """Momentum, mean square and mean gradient per parameter; the
    ``rmsprop`` op (``centered`` subtracts the squared mean gradient)."""

    _momentum_acc_str = "momentum"
    _mean_square_acc_str = "mean_square"
    _mean_grad_acc_str = "mean_grad"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, regularization=None, name=None):
        self.type = "rmsprop"
        super().__init__(learning_rate, regularization, name)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._momentum_acc_str, p)
            self._add_accumulator(self._mean_square_acc_str, p)
            self._add_accumulator(self._mean_grad_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        momentum, ms, mg = (self._get_accumulator(a, param) for a in (
            self._momentum_acc_str, self._mean_square_acc_str,
            self._mean_grad_acc_str))
        return block.append_op(
            type="rmsprop",
            inputs={"Param": [param], "Grad": [grad], "Moment": [momentum],
                    "MeanSquare": [ms], "MeanGrad": [mg],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "MomentOut": [momentum],
                     "MeanSquareOut": [ms], "MeanGradOut": [mg]},
            attrs={"epsilon": self._epsilon, "decay": self._rho,
                   "momentum": self._momentum, "centered": self._centered,
                   "op_role": "optimize"})


class FtrlOptimizer(Optimizer):
    """Squared and linear accumulators per parameter; the ``ftrl`` op."""

    _squared_acc_str = "squared"
    _linear_acc_str = "linear"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 regularization=None, name=None):
        self.type = "ftrl"
        super().__init__(learning_rate, regularization, name)
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._squared_acc_str, p)
            self._add_accumulator(self._linear_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        sq = self._get_accumulator(self._squared_acc_str, param)
        lin = self._get_accumulator(self._linear_acc_str, param)
        return block.append_op(
            type="ftrl",
            inputs={"Param": [param], "Grad": [grad],
                    "SquaredAccumulator": [sq], "LinearAccumulator": [lin],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "SquaredAccumOut": [sq],
                     "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power, "op_role": "optimize"})


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

    def _eager_apply(self, param):
        st = self._eager_state_for(param)
        if "m1" not in st:
            dev = param.value.device
            st["m1"] = torch.zeros_like(param.value)
            st["m2"] = torch.zeros_like(param.value)
            st["b1p"] = torch.full((1,), self._beta1, dtype=torch.float32,
                                   device=dev)
            st["b2p"] = torch.full((1,), self._beta2, dtype=torch.float32,
                                   device=dev)
        outs = _eager_run_op(
            "adam", {"Param": param.value, "Grad": param._grad,
                     "LearningRate": self._eager_lr(param),
                     "Moment1": st["m1"], "Moment2": st["m2"],
                     "Beta1Pow": st["b1p"], "Beta2Pow": st["b2p"]},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon})
        param.set_value(outs["ParamOut"][0])
        for k, slot in (("m1", "Moment1Out"), ("m2", "Moment2Out"),
                        ("b1p", "Beta1PowOut"), ("b2p", "Beta2PowOut")):
            st[k] = outs[slot][0]

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


class LarsMomentumOptimizer(Optimizer):
    """Momentum with the LARS layer-wise rate: the ``lars_momentum`` op
    (its norms on the device)."""

    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, regularization=None, name=None):
        self.type = "lars_momentum"
        super().__init__(learning_rate, regularization, name)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        velocity = self._get_accumulator(self._velocity_acc_str, param)
        return block.append_op(
            type="lars_momentum",
            inputs={"Param": [param], "Grad": [grad], "Velocity": [velocity],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "VelocityOut": [velocity]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay,
                   "op_role": "optimize"})


class LambOptimizer(AdamOptimizer):
    """Adam's accumulators, the ``lamb`` update (decoupled weight decay
    and the per-tensor trust ratio, its norms on the device)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, regularization=None,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon,
                         regularization, name)
        self.type = "lamb"
        self._weight_decay = lamb_weight_decay

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        m1, m2, b1p, b2p = (self._get_accumulator(a, param) for a in (
            self._moment1_acc_str, self._moment2_acc_str,
            self._beta1_pow_acc_str, self._beta2_pow_acc_str))
        return block.append_op(
            type="lamb",
            inputs={"Param": [param], "Grad": [grad],
                    "LearningRate": [self._create_param_lr(param_and_grad)],
                    "Moment1": [m1], "Moment2": [m2], "Beta1Pow": [b1p],
                    "Beta2Pow": [b2p]},
            outputs={"ParamOut": [param], "Moment1Out": [m1],
                     "Moment2Out": [m2], "Beta1PowOut": [b1p],
                     "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon,
                   "weight_decay": self._weight_decay,
                   "op_role": "optimize"})


class DGCMomentumOptimizer(MomentumOptimizer):
    """Deep gradient compression's momentum (the reference's
    ``DGCMomentumOptimizer``): here it runs as plain momentum on the
    hand-written Momentum update, and warns that it does.  One card has
    no slow link for a sparse exchange to save time on; the real top-k
    exchange with momentum correction and error feedback (the
    reference's ``parallel/dgc.py``) waits for the port's data-parallel
    and ``parallel/`` modules (ROADMAP.md, Queue A item 9)."""

    def __init__(self, learning_rate, momentum, rampup_begin_step=0,
                 rampup_step=1, sparsity=(0.999,), use_nesterov=False,
                 local_grad_clip_norm=None, num_trainers=None,
                 regularization=None, name=None):
        warnings.warn(
            "DGCMomentumOptimizer runs as plain momentum in "
            "paddle_tpu_torch: sparsity, rampup_begin_step, rampup_step "
            "and local_grad_clip_norm are ignored.  One card exchanges no "
            "gradients over a slow link, and the top-k exchange with "
            "error feedback (parallel/dgc.py) is not ported yet "
            "(ROADMAP.md, Queue A item 9)")
        super().__init__(learning_rate, momentum, use_nesterov,
                         regularization, name)


def _tmp_var(block, name, shape=(1,), dtype="float32"):
    return block.create_var(name=unique_name.generate(name),
                            shape=list(shape), dtype=dtype)


def _mirror_var(block, var, persistable=True):
    """Declare ``var`` (by name) in another program's block, so that its
    value comes from the shared scope when that program runs (the
    apply and restore programs)."""
    if block.has_var(var.name):
        return block.var(var.name)
    v = block.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                         persistable=persistable)
    v.stop_gradient = True
    return v


class _SwapIn:
    """``apply`` and ``restore`` of an average kept beside the
    parameters: ``_build_programs`` makes an apply program that backs the
    parameters up and writes the average into them, and a restore
    program that copies the backups back; both run against the caller's
    scope."""

    _apply_program = None
    _restore_program = None

    @contextlib.contextmanager
    def apply(self, executor, need_restore=True):
        """Swap the averages into the parameters for the block (restored
        after it unless ``need_restore`` is False)."""
        if self._apply_program is None:
            self._build_programs()
        executor.run(self._apply_program)
        try:
            yield
        finally:
            if need_restore:
                self.restore(executor)

    def restore(self, executor):
        if self._restore_program is None:
            raise RuntimeError("%s.restore called before apply"
                               % type(self).__name__)
        executor.run(self._restore_program)

    def _back_up(self, block, param, suffix):
        """In the apply program: ``param`` copied into a persistable
        backup → the parameter's var there."""
        pv = _mirror_var(block, param)
        backup = block.create_var(
            name=unique_name.generate(param.name + suffix),
            shape=param.shape, dtype=param.dtype, persistable=True)
        backup.stop_gradient = True
        self._backup_vars[param.name] = backup
        block.append_op(type="assign", inputs={"X": [pv]},
                        outputs={"Out": [backup]})
        return pv

    def _build_restore_program(self):
        """A program that copies each parameter's backup back into it."""
        self._restore_program = Program()
        with program_guard(self._restore_program):
            block = self._restore_program.global_block()
            for p in self._params:
                block.append_op(
                    type="assign",
                    inputs={"X": [_mirror_var(block,
                                              self._backup_vars[p.name])]},
                    outputs={"Out": [_mirror_var(block, p)]})


class ExponentialMovingAverage(_SwapIn):
    """An exponential moving average of each trainable parameter, kept in
    a persistable var that ``update()``'s ops advance every step, with a
    step counter for the bias correction and the decay in a var of its
    own (scheduled as ``min(decay, (1 + t) / (10 + t))`` when
    ``thres_steps`` gives ``t``).  ``apply`` runs a small program that
    backs the parameters up and swaps in ``ema / (1 - decay^steps)``;
    ``restore`` runs one that copies the backups back."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._thres_steps = thres_steps
        self._name = name or ""
        self._ema_vars = {}
        self._backup_vars = {}
        self._params = []
        program = default_main_program()
        helper = LayerHelper("ema")
        block = program.global_block()
        for p in program.all_parameters():
            if not p.trainable:
                continue
            ema = block.create_var(
                name=unique_name.generate(p.name + ".ema"), shape=p.shape,
                dtype=p.dtype, persistable=True)
            ema.stop_gradient = True
            helper.set_variable_initializer(ema, ConstantInitializer(0.0))
            self._ema_vars[p.name] = ema
            self._params.append(p)
        self._counter = self._state_var(block, helper, "ema.step", 0.0)
        self._decay_var = self._state_var(block, helper, "ema.decay",
                                          float(decay))

    def _state_var(self, block, helper, name, value):
        var = block.create_var(name=unique_name.generate(self._name + name),
                               shape=[1], dtype="float32", persistable=True)
        var.stop_gradient = True
        helper.set_variable_initializer(var, ConstantInitializer(value))
        return var

    def _append_scheduled_decay(self, block):
        """``decay_var = min(decay, (1 + t) / (10 + t))`` as graph ops."""
        from .layers import tensor as ltensor

        tf = _tmp_var(block, "ema.thres_f")
        num = _tmp_var(block, "ema.decay_num")
        den = _tmp_var(block, "ema.decay_den")
        ratio = _tmp_var(block, "ema.decay_ratio")
        block.append_op(type="cast", inputs={"X": [self._thres_steps]},
                        outputs={"Out": [tf]},
                        attrs={"out_dtype": "float32"})
        block.append_op(type="scale", inputs={"X": [tf]},
                        outputs={"Out": [num]},
                        attrs={"scale": 1.0, "bias": 1.0})
        block.append_op(type="scale", inputs={"X": [tf]},
                        outputs={"Out": [den]},
                        attrs={"scale": 1.0, "bias": 10.0})
        block.append_op(type="elementwise_div",
                        inputs={"X": [num], "Y": [den]},
                        outputs={"Out": [ratio]})
        cap = ltensor.fill_constant([1], "float32", float(self._decay))
        block.append_op(type="elementwise_min",
                        inputs={"X": [ratio], "Y": [cap]},
                        outputs={"Out": [self._decay_var]})

    def update(self):
        """Append the step's ops to the main program: the counter's
        increment, the scheduled decay, then ``ema = d ema + (1 - d) p``
        for each parameter."""
        block = default_main_program().global_block()
        block.append_op(type="increment", inputs={"X": [self._counter]},
                        outputs={"Out": [self._counter]},
                        attrs={"step": 1.0})
        if self._thres_steps is not None:
            self._append_scheduled_decay(block)
        for p in self._params:
            ema = self._ema_vars[p.name]
            t1 = _tmp_var(block, p.name + ".ema_t1", p.shape, p.dtype)
            t2 = _tmp_var(block, p.name + ".ema_t2", p.shape, p.dtype)
            if self._thres_steps is not None:
                one_minus = _tmp_var(block, p.name + ".ema_1md")
                block.append_op(type="scale",
                                inputs={"X": [self._decay_var]},
                                outputs={"Out": [one_minus]},
                                attrs={"scale": -1.0, "bias": 1.0})
                block.append_op(type="elementwise_mul",
                                inputs={"X": [ema], "Y": [self._decay_var]},
                                outputs={"Out": [t1]})
                block.append_op(type="elementwise_mul",
                                inputs={"X": [p], "Y": [one_minus]},
                                outputs={"Out": [t2]})
            else:
                block.append_op(type="scale", inputs={"X": [ema]},
                                outputs={"Out": [t1]},
                                attrs={"scale": self._decay})
                block.append_op(type="scale", inputs={"X": [p]},
                                outputs={"Out": [t2]},
                                attrs={"scale": 1.0 - self._decay})
            block.append_op(type="sum", inputs={"X": [t1, t2]},
                            outputs={"Out": [ema]})

    def _build_programs(self):
        from .layers import tensor as ltensor

        self._apply_program = Program()
        with program_guard(self._apply_program):
            block = self._apply_program.global_block()
            counter = _mirror_var(block, self._counter)
            decay = _mirror_var(block, self._decay_var)
            decay_pow = _tmp_var(block, "ema.decay_pow")
            block.append_op(type="elementwise_pow",
                            inputs={"X": [decay], "Y": [counter]},
                            outputs={"Out": [decay_pow]})
            one = ltensor.fill_constant([1], "float32", 1.0)
            denom = _tmp_var(block, "ema.denom")
            block.append_op(type="elementwise_sub",
                            inputs={"X": [one], "Y": [decay_pow]},
                            outputs={"Out": [denom]})
            # before any update() the counter is 0 and so is the
            # denominator: clamped, apply gives the zero EMA, not NaNs
            denom_safe = _tmp_var(block, "ema.denom_safe")
            eps = ltensor.fill_constant([1], "float32", 1e-12)
            block.append_op(type="elementwise_max",
                            inputs={"X": [denom], "Y": [eps]},
                            outputs={"Out": [denom_safe]})
            for p in self._params:
                ema = _mirror_var(block, self._ema_vars[p.name])
                pv = self._back_up(block, p, ".ema_bak")
                corrected = _tmp_var(block, p.name + ".ema_corr", p.shape,
                                      p.dtype)
                block.append_op(type="elementwise_div",
                                inputs={"X": [ema], "Y": [denom_safe]},
                                outputs={"Out": [corrected]})
                block.append_op(type="assign", inputs={"X": [corrected]},
                                outputs={"Out": [pv]})
        self._build_restore_program()


class ModelAverage(_SwapIn, Optimizer):
    """A sliding-window average of the parameters: each step the
    ``average_accumulates`` op adds a parameter into its three-tier sums
    (appended to the main program at construction); ``apply`` swaps
    ``(sum_1 + sum_2 + sum_3) / (num_accumulates + old_num_accumulates)``
    into the parameters and ``restore`` swaps them back."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None):
        super().__init__(0.0, regularization=regularization, name=name)
        self.type = "average_accumulates"
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self._backup_vars = {}
        program = default_main_program()
        block = program.global_block()
        self._params = [p for p in program.all_parameters()
                        if getattr(p, "do_model_average", None) is not False]
        for p in self._params:
            self._append_average_accumulate_op(block, p)

    def _append_average_accumulate_op(self, block, param):
        s1, s2, s3 = (self._add_accumulator(n, param, dtype=param.dtype)
                      for n in ("sum_1", "sum_2", "sum_3"))
        na, ona, nu = (self._add_accumulator(n, param, dtype="int64",
                                             shape=[1])
                       for n in ("num_accumulates", "old_num_accumulates",
                                 "num_updates"))
        block.append_op(
            type="average_accumulates",
            inputs={"param": [param], "in_sum_1": [s1], "in_sum_2": [s2],
                    "in_sum_3": [s3], "in_num_accumulates": [na],
                    "in_old_num_accumulates": [ona],
                    "in_num_updates": [nu]},
            outputs={"out_sum_1": [s1], "out_sum_2": [s2],
                     "out_sum_3": [s3], "out_num_accumulates": [na],
                     "out_old_num_accumulates": [ona],
                     "out_num_updates": [nu]},
            attrs={"average_window": float(self.average_window),
                   "min_average_window": int(self.min_average_window),
                   "max_average_window": int(self.max_average_window),
                   "op_role": "optimize"})

    def _build_programs(self):
        self._apply_program = Program()
        with program_guard(self._apply_program):
            block = self._apply_program.global_block()
            for p in self._params:
                s1, s2, s3, na, ona = (
                    _mirror_var(block, self._get_accumulator(n, p))
                    for n in ("sum_1", "sum_2", "sum_3", "num_accumulates",
                              "old_num_accumulates"))
                pv = self._back_up(block, p, ".avg_bak")
                total = _tmp_var(block, p.name + ".avg_sum", p.shape,
                                 p.dtype)
                block.append_op(type="sum", inputs={"X": [s1, s2, s3]},
                                outputs={"Out": [total]})
                cnt_i = _tmp_var(block, p.name + ".avg_cnt_i",
                                 dtype="int64")
                block.append_op(type="sum", inputs={"X": [na, ona]},
                                outputs={"Out": [cnt_i]})
                cnt = _tmp_var(block, p.name + ".avg_cnt")
                block.append_op(type="cast", inputs={"X": [cnt_i]},
                                outputs={"Out": [cnt]},
                                attrs={"out_dtype": "float32"})
                block.append_op(type="elementwise_div",
                                inputs={"X": [total], "Y": [cnt]},
                                outputs={"Out": [pv]})
        self._build_restore_program()


class PipelineOptimizer:
    """Pipeline-parallel training's front end: ``minimize`` delegates to
    the inner optimizer, so the program stays a correct one-device
    program, and records the pipeline's configuration on it as
    ``program._pipeline_opt``, as the reference does for its runner.
    The runner itself (the reference's GPipe schedule,
    ``parallel/pipeline.py``) is not ported yet (ROADMAP.md, Queue A
    item 9): nothing in this package reads the record."""

    def __init__(self, optimizer, cut_list=None, place_list=None,
                 concurrency_list=None, queue_size=30, sync_steps=1,
                 start_cpu_core_id=0, num_microbatches=None):
        self._optimizer = optimizer
        self._cut_list = cut_list
        self._num_microbatches = (
            num_microbatches if num_microbatches is not None
            else (len(cut_list) + 1 if cut_list else 1))
        # the reference's queue, thread and core knobs: recorded only
        self._legacy_knobs = {"place_list": place_list,
                              "concurrency_list": concurrency_list,
                              "queue_size": queue_size,
                              "sync_steps": sync_steps,
                              "start_cpu_core_id": start_cpu_core_id}

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        result = self._optimizer.minimize(
            loss, startup_program=startup_program,
            parameter_list=parameter_list, no_grad_set=no_grad_set)
        loss.block.program._pipeline_opt = {
            "cut_list": self._cut_list,
            "num_microbatches": self._num_microbatches,
            "schedule": "gpipe", "legacy": self._legacy_knobs}
        return result


# ops rewrite_program_recompute never moves into a region: the executor
# runs them around the step (feed/fetch) or on the host
_UNWRAPPABLE = ("feed", "fetch", "save", "load", "save_combine",
                "load_combine")


def rewrite_program_recompute(program, checkpoints):
    """Split the global block's forward at the checkpoint vars: each
    segment of two or more ops ending at a checkpoint becomes one
    ``recompute_block`` region (``layers.recompute()`` applied after the
    build); the last segment, which feeds the loss, stays as it is.  Runs
    before ``append_backward``, which must see the regions.  Returns the
    number of regions."""
    from .layers.control_flow import make_recompute_region_op_spec

    block = program.global_block()
    if any(op.type.endswith("_grad") for op in block.ops):
        raise RuntimeError(
            "rewrite_program_recompute must run before append_backward/"
            "minimize (backward needs to see the recompute regions)")
    cps = {getattr(c, "name", c) for c in checkpoints}
    missing = [c for c in cps if block._find_var_recursive(c) is None]
    if missing:
        raise ValueError("checkpoint vars %s not found in the program"
                         % sorted(missing))
    segments, cur = [], []
    for op in block.ops:
        if op.type in _UNWRAPPABLE:
            if cur:
                segments.append(cur)
                cur = []
            segments.append([op])
            continue
        cur.append(op)
        if cps & set(op.output_arg_names):
            segments.append(cur)
            cur = []
    if cur:
        segments.append(cur)
    new_ops, n_wrapped = [], 0
    for si, seg in enumerate(segments):
        if len(seg) < 2 or si == len(segments) - 1:
            new_ops.extend(seg)
            continue
        sub = program._create_block(parent_idx=0)
        program._rollback()
        sub.ops = list(seg)
        for op in seg:
            op.block = sub
        spec = make_recompute_region_op_spec(
            block, sub, unique_name.generate("recompute_seg") + ".scope")
        new_ops.append(Operator(block, **spec))
        n_wrapped += 1
    block.ops = new_ops
    program._bump_version()
    return n_wrapped


class RecomputeOptimizer:
    """Activation recompute as an optimizer wrapper:
    ``_set_checkpoints`` names the segment boundaries, and ``backward``
    / ``minimize`` rewrite the forward into ``recompute_block`` regions
    (:func:`rewrite_program_recompute`) before the inner optimizer's."""

    def __init__(self, optimizer):
        self._optimizer = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = list(checkpoints)

    def _apply_rewrite(self, loss):
        if not self._checkpoints:
            raise ValueError(
                "RecomputeOptimizer needs checkpoints: call "
                "_set_checkpoints([...]) with the segment-boundary vars")
        rewrite_program_recompute(loss.block.program, self._checkpoints)

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        self._apply_rewrite(loss)
        return self._optimizer.backward(
            loss, startup_program=startup_program,
            parameter_list=parameter_list, no_grad_set=no_grad_set,
            callbacks=callbacks)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        self._apply_rewrite(loss)
        return self._optimizer.minimize(
            loss, startup_program=startup_program,
            parameter_list=parameter_list, no_grad_set=no_grad_set)


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
LarsMomentum = LarsMomentumOptimizer
