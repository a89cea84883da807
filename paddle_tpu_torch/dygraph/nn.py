"""Dygraph layers (mirrors ``paddle_tpu/dygraph/nn.py``: ``_init_array``,
``_fans`` and ``_param_rng`` :18-56, then the 20 layers ``Linear`` :59,
``FC`` :91, ``Conv2D`` :103, ``Pool2D`` :143, ``BatchNorm`` :162,
``Embedding`` :202, ``LayerNorm`` :222, ``Dropout`` :242, ``Conv3D`` :255,
``Conv2DTranspose`` :293, ``Conv3DTranspose`` :331, ``GRUUnit`` :369,
``PRelu`` :400, ``BilinearTensorProduct`` :424, ``SequenceConv`` :453,
``RowConv`` :493, ``GroupNorm`` :518, ``SpectralNorm`` :550, ``TreeConv``
:581, ``NCE`` :606).

Parameters are drawn on the host from the same seeded ``RandomState`` as
the reference's, in the same order, then placed on the innermost guard's
device.  Each layer dispatches the same registered ops with the same
slots and attrs as the reference's; ``BatchNorm``'s running statistics
move in place (the ``batch_norm`` op writes them into its inputs) and
stay put in ``eval()``."""

import numpy as np

from .. import initializer as init_mod
from ..param_attr import ParamAttr
from .layers import Layer
from .varbase import VarBase, eager_op

__all__ = ["Linear", "FC", "Conv2D", "Pool2D", "BatchNorm", "Embedding",
           "LayerNorm", "Dropout", "Conv3D", "Conv2DTranspose",
           "Conv3DTranspose", "GRUUnit", "PRelu", "BilinearTensorProduct",
           "SequenceConv", "RowConv", "GroupNorm", "SpectralNorm",
           "TreeConv", "NCE"]


def _init_array(initializer, shape, dtype, rng):
    """Evaluate an initializer eagerly (dygraph params materialize at
    construction, not via a startup program)."""
    initializer = initializer or init_mod.XavierInitializer()
    if isinstance(initializer, init_mod.ConstantInitializer):
        return np.full(shape, initializer._value, dtype)
    if isinstance(initializer, init_mod.UniformInitializer):
        return rng.uniform(initializer._low, initializer._high,
                           shape).astype(dtype)
    if isinstance(initializer, init_mod.NormalInitializer):
        return (initializer._mean + initializer._std *
                rng.randn(*shape)).astype(dtype)
    if isinstance(initializer, init_mod.TruncatedNormalInitializer):
        v = rng.randn(*shape)
        v = np.clip(v, -2, 2)
        return (initializer._mean + initializer._std * v).astype(dtype)
    if isinstance(initializer, init_mod.XavierInitializer):
        fan_in, fan_out = _fans(shape)
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-limit, limit, shape).astype(dtype)
    if isinstance(initializer, init_mod.MSRAInitializer):
        fan_in, _ = _fans(shape)
        limit = np.sqrt(6.0 / fan_in)
        return rng.uniform(-limit, limit, shape).astype(dtype)
    raise NotImplementedError(type(initializer))


def _fans(shape):
    if len(shape) < 2:
        return (shape[0] if shape else 1,) * 2
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


_param_rng = np.random.RandomState(20190701)


class Linear(Layer):
    def __init__(self, input_dim, output_dim, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__()
        p = ParamAttr._to_attr(param_attr)
        self.weight = self.create_parameter(
            [input_dim, output_dim], dtype,
            _init_array(p.initializer, (input_dim, output_dim), dtype,
                        _param_rng),
        )
        self._act = act
        b = ParamAttr._to_attr(bias_attr)
        if b is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(
                [output_dim], dtype,
                _init_array(b.initializer or init_mod.Constant(0.0),
                            (output_dim,), dtype, _param_rng),
            )

    def forward(self, x):
        out = eager_op("mul", {"X": [x], "Y": [self.weight]},
                       {"x_num_col_dims": 1, "y_num_col_dims": 1})[0]
        if self.bias is not None:
            out = eager_op("elementwise_add",
                           {"X": [out], "Y": [self.bias]}, {"axis": 1})[0]
        if self._act:
            out = eager_op(self._act, {"X": [out]})[0]
        return out


class FC(Linear):
    """Old-style FC (reference dygraph/nn.py FC) — alias of Linear with
    size-first signature."""

    def __init__(self, name_scope=None, size=None, input_dim=None,
                 param_attr=None, bias_attr=None, act=None,
                 dtype="float32"):
        if input_dim is None:
            raise ValueError("FC requires input_dim on TPU (static shapes)")
        super().__init__(input_dim, size, param_attr, bias_attr, act, dtype)


class Conv2D(Layer):
    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__()
        fs = filter_size if isinstance(filter_size, (list, tuple)) else (
            filter_size, filter_size)
        shape = (num_filters, num_channels // (groups or 1)) + tuple(fs)
        p = ParamAttr._to_attr(param_attr)
        fan_in = shape[1] * shape[2] * shape[3]
        default = init_mod.NormalInitializer(0.0, (2.0 / fan_in) ** 0.5)
        self.weight = self.create_parameter(
            list(shape), dtype,
            _init_array(p.initializer or default, shape, dtype, _param_rng),
        )
        b = ParamAttr._to_attr(bias_attr)
        self.bias = None if b is False else self.create_parameter(
            [num_filters], dtype,
            _init_array(b.initializer or init_mod.Constant(0.0),
                        (num_filters,), dtype, _param_rng),
        )
        self._attrs = {
            "strides": [stride] * 2 if isinstance(stride, int) else list(stride),
            "paddings": [padding] * 2 if isinstance(padding, int) else list(padding),
            "dilations": [dilation] * 2 if isinstance(dilation, int) else list(dilation),
            "groups": groups or 1,
        }
        self._act = act

    def forward(self, x):
        out = eager_op("conv2d", {"Input": [x], "Filter": [self.weight]},
                       self._attrs)[0]
        if self.bias is not None:
            out = eager_op("elementwise_add",
                           {"X": [out], "Y": [self.bias]}, {"axis": 1})[0]
        if self._act:
            out = eager_op(self._act, {"X": [out]})[0]
        return out


class Pool2D(Layer):
    def __init__(self, pool_size=-1, pool_type="max", pool_stride=1,
                 pool_padding=0, global_pooling=False, ceil_mode=False,
                 exclusive=True):
        super().__init__()
        self._attrs = {
            "pooling_type": pool_type,
            "ksize": [pool_size] * 2 if isinstance(pool_size, int) else list(pool_size),
            "strides": [pool_stride] * 2 if isinstance(pool_stride, int) else list(pool_stride),
            "paddings": [pool_padding] * 2 if isinstance(pool_padding, int) else list(pool_padding),
            "global_pooling": global_pooling,
            "ceil_mode": ceil_mode,
            "exclusive": exclusive,
        }

    def forward(self, x):
        return eager_op("pool2d", {"X": [x]}, self._attrs)[0]


class BatchNorm(Layer):
    def __init__(self, num_channels, act=None, is_test=False, momentum=0.9,
                 epsilon=1e-5, param_attr=None, bias_attr=None,
                 dtype="float32", data_layout="NCHW"):
        super().__init__()
        c = (num_channels,)
        self.weight = self.create_parameter(
            [num_channels], "float32",
            _init_array(init_mod.Constant(1.0), c, "float32", _param_rng),
        )
        self.bias = self.create_parameter(
            [num_channels], "float32",
            _init_array(init_mod.Constant(0.0), c, "float32", _param_rng),
        )
        self._mean = VarBase(np.zeros(c, "float32"), "bn.mean",
                             stop_gradient=True, persistable=True)
        self._variance = VarBase(np.ones(c, "float32"), "bn.var",
                                 stop_gradient=True, persistable=True)
        self._attrs = {
            "momentum": momentum, "epsilon": epsilon,
            "data_layout": data_layout, "is_test": is_test,
        }
        self._act = act

    def forward(self, x):
        outs = eager_op(
            "batch_norm",
            {"X": [x], "Scale": [self.weight], "Bias": [self.bias],
             "Mean": [self._mean], "Variance": [self._variance]},
            dict(self._attrs, is_test=self._attrs["is_test"] or
                 not self.training),
        )
        y, mean_out, var_out = outs[0], outs[1], outs[2]
        self._mean.set_value(mean_out.value)
        self._variance.set_value(var_out.value)
        if self._act:
            y = eager_op(self._act, {"X": [y]})[0]
        return y


class Embedding(Layer):
    def __init__(self, size, is_sparse=False, padding_idx=None,
                 param_attr=None, dtype="float32"):
        super().__init__()
        p = ParamAttr._to_attr(param_attr)
        default = init_mod.UniformInitializer(-0.05, 0.05)
        self.weight = self.create_parameter(
            list(size), dtype,
            _init_array(p.initializer or default, tuple(size), dtype,
                        _param_rng),
        )
        self._padding_idx = -1 if padding_idx is None else padding_idx

    def forward(self, ids):
        return eager_op(
            "lookup_table", {"W": [self.weight], "Ids": [ids]},
            {"padding_idx": self._padding_idx},
        )[0]


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, dtype="float32"):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        n = int(np.prod(normalized_shape))
        self.weight = self.create_parameter(
            [n], "float32", np.ones(n, "float32"))
        self.bias = self.create_parameter(
            [n], "float32", np.zeros(n, "float32"))
        self._eps = epsilon

    def forward(self, x):
        return eager_op(
            "layer_norm",
            {"X": [x], "Scale": [self.weight], "Bias": [self.bias]},
            {"begin_norm_axis": len(x.shape) - 1, "epsilon": self._eps},
        )[0]


class Dropout(Layer):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        return eager_op(
            "dropout", {"X": [x]},
            {"dropout_prob": self._p, "is_test": not self.training,
             "dropout_implementation": "upscale_in_train"},
        )[0]


class Conv3D(Layer):
    """reference dygraph/nn.py Conv3D → conv3d op (NCDHW)."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__()
        fs = (filter_size if isinstance(filter_size, (list, tuple))
              else (filter_size,) * 3)
        shape = (num_filters, num_channels // (groups or 1)) + tuple(fs)
        p = ParamAttr._to_attr(param_attr)
        fan_in = shape[1] * shape[2] * shape[3] * shape[4]
        default = init_mod.NormalInitializer(0.0, (2.0 / fan_in) ** 0.5)
        self.weight = self.create_parameter(
            list(shape), dtype,
            _init_array(p.initializer or default, shape, dtype, _param_rng))
        b = ParamAttr._to_attr(bias_attr)
        self.bias = None if b is False else self.create_parameter(
            [num_filters], dtype,
            _init_array(b.initializer or init_mod.Constant(0.0),
                        (num_filters,), dtype, _param_rng))
        def trip(v):
            return [v] * 3 if isinstance(v, int) else list(v)
        self._attrs = {"strides": trip(stride), "paddings": trip(padding),
                       "dilations": trip(dilation), "groups": groups or 1}
        self._act = act

    def forward(self, x):
        out = eager_op("conv3d", {"Input": [x], "Filter": [self.weight]},
                       self._attrs)[0]
        if self.bias is not None:
            out = eager_op("elementwise_add",
                           {"X": [out], "Y": [self.bias]}, {"axis": 1})[0]
        if self._act:
            out = eager_op(self._act, {"X": [out]})[0]
        return out


class Conv2DTranspose(Layer):
    """reference dygraph/nn.py Conv2DTranspose → conv2d_transpose op."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__()
        fs = (filter_size if isinstance(filter_size, (list, tuple))
              else (filter_size,) * 2)
        shape = (num_channels, num_filters // (groups or 1)) + tuple(fs)
        p = ParamAttr._to_attr(param_attr)
        default = init_mod.XavierInitializer()
        self.weight = self.create_parameter(
            list(shape), dtype,
            _init_array(p.initializer or default, shape, dtype, _param_rng))
        b = ParamAttr._to_attr(bias_attr)
        self.bias = None if b is False else self.create_parameter(
            [num_filters], dtype,
            _init_array(b.initializer or init_mod.Constant(0.0),
                        (num_filters,), dtype, _param_rng))
        def pair(v):
            return [v] * 2 if isinstance(v, int) else list(v)
        self._attrs = {"strides": pair(stride), "paddings": pair(padding),
                       "dilations": pair(dilation), "groups": groups or 1}
        self._act = act

    def forward(self, x):
        out = eager_op("conv2d_transpose",
                       {"Input": [x], "Filter": [self.weight]},
                       self._attrs)[0]
        if self.bias is not None:
            out = eager_op("elementwise_add",
                           {"X": [out], "Y": [self.bias]}, {"axis": 1})[0]
        if self._act:
            out = eager_op(self._act, {"X": [out]})[0]
        return out


class Conv3DTranspose(Layer):
    """reference dygraph/nn.py Conv3DTranspose → conv3d_transpose op."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__()
        fs = (filter_size if isinstance(filter_size, (list, tuple))
              else (filter_size,) * 3)
        shape = (num_channels, num_filters) + tuple(fs)
        p = ParamAttr._to_attr(param_attr)
        self.weight = self.create_parameter(
            list(shape), dtype,
            _init_array(p.initializer or init_mod.XavierInitializer(),
                        shape, dtype, _param_rng))
        b = ParamAttr._to_attr(bias_attr)
        self.bias = None if b is False else self.create_parameter(
            [num_filters], dtype,
            _init_array(b.initializer or init_mod.Constant(0.0),
                        (num_filters,), dtype, _param_rng))
        def trip(v):
            return [v] * 3 if isinstance(v, int) else list(v)
        self._attrs = {"strides": trip(stride), "paddings": trip(padding),
                       "dilations": trip(dilation)}
        self._act = act

    def forward(self, x):
        out = eager_op("conv3d_transpose",
                       {"Input": [x], "Filter": [self.weight]},
                       self._attrs)[0]
        if self.bias is not None:
            out = eager_op("elementwise_add",
                           {"X": [out], "Y": [self.bias]}, {"axis": 1})[0]
        if self._act:
            out = eager_op(self._act, {"X": [out]})[0]
        return out


class GRUUnit(Layer):
    """reference dygraph/nn.py GRUUnit → gru_unit op; size = 3*D."""

    def __init__(self, size, param_attr=None, bias_attr=None,
                 activation="tanh", gate_activation="sigmoid",
                 origin_mode=False, dtype="float32"):
        super().__init__()
        d = size // 3
        p = ParamAttr._to_attr(param_attr)
        self.weight = self.create_parameter(
            [d, 3 * d], dtype,
            _init_array(p.initializer, (d, 3 * d), dtype, _param_rng))
        b = ParamAttr._to_attr(bias_attr)
        self.bias = None if b is False else self.create_parameter(
            [1, 3 * d], dtype,
            _init_array(b.initializer or init_mod.Constant(0.0),
                        (1, 3 * d), dtype, _param_rng))
        self._attrs = {"activation": activation,
                       "gate_activation": gate_activation,
                       "origin_mode": origin_mode}

    def forward(self, input, hidden):
        ins = {"Input": [input], "HiddenPrev": [hidden],
               "Weight": [self.weight]}
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        # declared slot order: Gate, ResetHiddenPrev, Hidden
        gate, rhp, hid = eager_op("gru_unit", ins, self._attrs)
        return hid, rhp, gate


class PRelu(Layer):
    """reference dygraph/nn.py PRelu → prelu op."""

    def __init__(self, mode="all", channel=None, input_shape=None,
                 param_attr=None, dtype="float32"):
        super().__init__()
        if mode == "all":
            shape = [1]
        elif mode == "channel":
            shape = [channel or 1]
        else:
            shape = list(input_shape or [1])
        p = ParamAttr._to_attr(param_attr)
        self.weight = self.create_parameter(
            shape, dtype,
            _init_array(p.initializer or init_mod.Constant(0.25),
                        tuple(shape), dtype, _param_rng))
        self._mode = mode

    def forward(self, x):
        return eager_op("prelu", {"X": [x], "Alpha": [self.weight]},
                        {"mode": self._mode})[0]


class BilinearTensorProduct(Layer):
    """reference dygraph/nn.py BilinearTensorProduct."""

    def __init__(self, input1_dim, input2_dim, output_dim, name=None,
                 act=None, param_attr=None, bias_attr=None,
                 dtype="float32"):
        super().__init__()
        p = ParamAttr._to_attr(param_attr)
        shape = (output_dim, input1_dim, input2_dim)
        self.weight = self.create_parameter(
            list(shape), dtype,
            _init_array(p.initializer, shape, dtype, _param_rng))
        b = ParamAttr._to_attr(bias_attr)
        self.bias = None if b is False else self.create_parameter(
            [1, output_dim], dtype,
            _init_array(b.initializer or init_mod.Constant(0.0),
                        (1, output_dim), dtype, _param_rng))
        self._act = act

    def forward(self, x, y):
        ins = {"X": [x], "Y": [y], "Weight": [self.weight]}
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        out = eager_op("bilinear_tensor_product", ins, {})[0]
        if self._act:
            out = eager_op(self._act, {"X": [out]})[0]
        return out


class SequenceConv(Layer):
    """reference dygraph/nn.py SequenceConv → sequence_conv op (padded
    [B,T,D] + optional lengths)."""

    def __init__(self, name_scope=None, num_filters=1, filter_size=3,
                 filter_stride=1, padding=None, bias_attr=None,
                 param_attr=None, act=None, input_dim=None,
                 dtype="float32"):
        super().__init__()
        if input_dim is None:
            raise ValueError(
                "SequenceConv requires input_dim on TPU (static shapes)")
        p = ParamAttr._to_attr(param_attr)
        shape = (filter_size * input_dim, num_filters)
        self.weight = self.create_parameter(
            list(shape), dtype,
            _init_array(p.initializer, shape, dtype, _param_rng))
        b = ParamAttr._to_attr(bias_attr)
        self.bias = None if b is False else self.create_parameter(
            [num_filters], dtype,
            _init_array(b.initializer or init_mod.Constant(0.0),
                        (num_filters,), dtype, _param_rng))
        self._attrs = {"contextLength": int(filter_size),
                       "contextStart": -int(filter_size // 2),
                       "contextStride": int(filter_stride)}
        self._act = act

    def forward(self, x, seq_len=None):
        ins = {"X": [x], "Filter": [self.weight]}
        if seq_len is not None:
            ins["SeqLen"] = [seq_len]
        out = eager_op("sequence_conv", ins, self._attrs)[0]
        if self.bias is not None:
            out = eager_op("elementwise_add",
                           {"X": [out], "Y": [self.bias]}, {"axis": 2})[0]
        if self._act:
            out = eager_op(self._act, {"X": [out]})[0]
        return out


class RowConv(Layer):
    """reference dygraph/nn.py RowConv → row_conv op."""

    def __init__(self, name_scope=None, future_ctx_size=2,
                 param_attr=None, act=None, input_dim=None,
                 dtype="float32"):
        super().__init__()
        if input_dim is None:
            raise ValueError(
                "RowConv requires input_dim on TPU (static shapes)")
        p = ParamAttr._to_attr(param_attr)
        shape = (future_ctx_size + 1, input_dim)
        self.weight = self.create_parameter(
            list(shape), dtype,
            _init_array(p.initializer, shape, dtype, _param_rng))
        self._act = act

    def forward(self, x):
        out = eager_op("row_conv",
                       {"X": [x], "Filter": [self.weight]}, {})[0]
        if self._act:
            out = eager_op(self._act, {"X": [out]})[0]
        return out


class GroupNorm(Layer):
    """reference dygraph/nn.py GroupNorm → group_norm op."""

    def __init__(self, channels=None, groups=1, epsilon=1e-5,
                 param_attr=None, bias_attr=None, act=None,
                 dtype="float32", name_scope=None):
        super().__init__()
        p = ParamAttr._to_attr(param_attr)
        self.weight = None if p is False else self.create_parameter(
            [channels], dtype,
            _init_array(p.initializer or init_mod.Constant(1.0),
                        (channels,), dtype, _param_rng))
        b = ParamAttr._to_attr(bias_attr)
        self.bias = None if b is False else self.create_parameter(
            [channels], dtype,
            _init_array(b.initializer or init_mod.Constant(0.0),
                        (channels,), dtype, _param_rng))
        self._attrs = {"groups": int(groups), "epsilon": float(epsilon)}
        self._act = act

    def forward(self, x):
        ins = {"X": [x]}
        if self.weight is not None:
            ins["Scale"] = [self.weight]
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        y, _, _ = eager_op("group_norm", ins, self._attrs)
        if self._act:
            y = eager_op(self._act, {"X": [y]})[0]
        return y


class SpectralNorm(Layer):
    """reference dygraph/nn.py SpectralNorm → spectral_norm op."""

    def __init__(self, weight_shape=None, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32", name_scope=None):
        super().__init__()
        h = weight_shape[dim]
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= s
        self.u = self.create_parameter(
            [h], dtype,
            _init_array(init_mod.NormalInitializer(0.0, 1.0), (h,), dtype,
                        _param_rng))
        self.v = self.create_parameter(
            [w], dtype,
            _init_array(init_mod.NormalInitializer(0.0, 1.0), (w,), dtype,
                        _param_rng))
        self._attrs = {"dim": int(dim), "power_iters": int(power_iters),
                       "eps": float(eps)}

    def forward(self, weight):
        return eager_op(
            "spectral_norm",
            {"Weight": [weight], "U": [self.u], "V": [self.v]},
            self._attrs)[0]


class TreeConv(Layer):
    """reference dygraph/nn.py TreeConv → tree_conv op."""

    def __init__(self, feature_size=None, output_size=1, num_filters=1,
                 max_depth=2, act="tanh", param_attr=None, bias_attr=None,
                 name_scope=None, dtype="float32"):
        super().__init__()
        p = ParamAttr._to_attr(param_attr)
        shape = (feature_size, output_size, 3)
        self.weight = self.create_parameter(
            list(shape), dtype,
            _init_array(p.initializer, shape, dtype, _param_rng))
        self._attrs = {"max_depth": int(max_depth)}
        self._act = act

    def forward(self, nodes_vector, edge_set):
        out = eager_op(
            "tree_conv",
            {"NodesVector": [nodes_vector], "EdgeSet": [edge_set],
             "Filter": [self.weight]}, self._attrs)[0]
        if self._act:
            out = eager_op(self._act, {"X": [out]})[0]
        return out


class NCE(Layer):
    """reference dygraph/nn.py NCE → nce op."""

    def __init__(self, num_total_classes, dim=None, sample_weight=None,
                 param_attr=None, bias_attr=None, num_neg_samples=10,
                 sampler="uniform", custom_dist=None, seed=0,
                 is_sparse=False, dtype="float32", name_scope=None):
        super().__init__()
        if dim is None:
            raise ValueError("NCE requires dim on TPU (static shapes)")
        p = ParamAttr._to_attr(param_attr)
        self.weight = self.create_parameter(
            [num_total_classes, dim], dtype,
            _init_array(p.initializer, (num_total_classes, dim), dtype,
                        _param_rng))
        b = ParamAttr._to_attr(bias_attr)
        self.bias = None if b is False else self.create_parameter(
            [num_total_classes, 1], dtype,
            _init_array(b.initializer or init_mod.Constant(0.0),
                        (num_total_classes, 1), dtype, _param_rng))
        self._attrs = {
            "num_total_classes": int(num_total_classes),
            "num_neg_samples": int(num_neg_samples),
            "sampler": {"uniform": 0, "log_uniform": 1}.get(sampler, 0),
            "seed": seed,
        }

    def forward(self, input, label):
        ins = {"Input": [input], "Label": [label],
               "Weight": [self.weight]}
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        cost, _, _ = eager_op("nce", ins, self._attrs)
        return cost
