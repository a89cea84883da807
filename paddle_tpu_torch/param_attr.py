"""ParamAttr (mirrors ``paddle_tpu/param_attr.py``)."""

__all__ = ["ParamAttr", "WeightNormParamAttr"]


class ParamAttr:
    """Parameter attributes (reference param_attr.py).

    TPU-native extension: ``shard_spec`` annotates the parameter with a
    PartitionSpec-like tuple of mesh axis names for tensor parallelism —
    e.g. ``shard_spec=[None, "model"]`` column-shards an [in, out] weight
    over the model axis (Megatron column-parallel), ``["model", None]``
    row-shards it.  Honored when the program runs under
    ``CompiledProgram.with_data_parallel`` with
    ``BuildStrategy.tensor_parallel_degree > 1`` (SURVEY §2.3 TP row:
    TP is free via GSPMD once params carry PartitionSpecs)."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None,
                 do_model_average=False, shard_spec=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average
        self.shard_spec = tuple(shard_spec) if shard_spec is not None else None

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, bool):
            return ParamAttr() if arg else False
        from .initializer import Initializer

        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        raise TypeError("Unsupported ParamAttr spec: %r" % (arg,))

    def _set_default_initializer(self, initializer):
        if self.initializer is None:
            self.initializer = initializer

    def _to_kwargs(self, with_initializer=False):
        kwargs = {
            "name": self.name,
            "optimize_attr": {"learning_rate": self.learning_rate},
            "regularizer": self.regularizer,
            "trainable": self.trainable,
            "gradient_clip_attr": self.gradient_clip,
            "do_model_average": self.do_model_average,
            "shard_spec": self.shard_spec,
        }
        if with_initializer:
            kwargs["initializer"] = self.initializer
        return kwargs


class WeightNormParamAttr(ParamAttr):
    def __init__(self, dim=None, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim
