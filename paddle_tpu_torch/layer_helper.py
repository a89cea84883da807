"""LayerHelper: parameter creation + op appending glue used by every layer
(mirrors ``paddle_tpu/layer_helper.py``)."""

from . import unique_name
from .framework import default_main_program, default_startup_program, Variable
from .initializer import (
    ConstantInitializer,
    XavierInitializer,
    _global_bias_initializer,
    _global_weight_initializer,
)
from .param_attr import ParamAttr

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        name = kwargs.get("name")
        if name is None:
            name = unique_name.generate(layer_type)
        self.name = name
        self.layer_type = layer_type

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    def append_op(self, *args, **kwargs):
        return self.main_program.current_block().append_op(*args, **kwargs)

    # ---- inputs ----
    def multiple_input(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name, [])
        if isinstance(inputs, Variable):
            inputs = [inputs]
        return list(inputs)

    def input(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        if len(inputs) != 1:
            raise ValueError("%s layer needs exactly one input" % self.layer_type)
        return inputs[0]

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr"))

    def multiple_param_attr(self, length):
        attr = self.param_attr
        if isinstance(attr, ParamAttr):
            attr = [attr]
        if len(attr) != 1 and len(attr) != length:
            raise ValueError("parameter number mismatch")
        if len(attr) == 1 and length != 1:
            attr = [attr[0]] + [
                ParamAttr(**attr[0].__dict__) for _ in range(length - 1)
            ]
        return attr

    def iter_inputs_and_params(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        attrs = self.multiple_param_attr(len(inputs))
        for i, a in zip(inputs, attrs):
            yield i, a

    def input_dtype(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        dtype = None
        for i in inputs:
            if dtype is None:
                dtype = i.dtype
        return dtype

    # ---- parameters ----
    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None, stop_gradient=False):
        if attr is False:
            return None
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        if default_initializer is None:
            if is_bias:
                g = _global_bias_initializer()
                attr._set_default_initializer(g or ConstantInitializer(0.0))
            else:
                g = _global_weight_initializer()
                attr._set_default_initializer(g or XavierInitializer())
        else:
            attr._set_default_initializer(default_initializer)

        if attr.name is None:
            suffix = "b" if is_bias else "w"
            attr.name = unique_name.generate(".".join([self.name, suffix]))

        shape = [int(s) for s in shape]
        startup_block = self.startup_program.global_block()
        # a re-declared shared parameter (same ParamAttr name — e.g. the
        # prefill and decode-step subgraphs of one generation program)
        # is ONE var: initialize it once, or startup double-writes the
        # buffer (a donation-aliasing hazard the lint rightly flags)
        redeclared = attr.name in startup_block.vars
        sp = startup_block.create_parameter(
            shape=shape, dtype=dtype, **attr._to_kwargs(with_initializer=False)
        )
        if not redeclared:
            attr.initializer(sp, startup_block)
        main_block = self.main_program.global_block()
        return main_block.create_parameter(
            shape=shape, dtype=dtype, **attr._to_kwargs()
        )

    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        return self.main_program.current_block().create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype,
            persistable=False,
            stop_gradient=stop_gradient,
        )

    # older reference spelling
    create_tmp_variable = create_variable_for_type_inference

    def create_variable(self, *args, **kwargs):
        return self.main_program.current_block().create_var(*args, **kwargs)

    def create_global_variable(self, persistable=False, *args, **kwargs):
        return self.main_program.global_block().create_var(
            *args,
            persistable=persistable,
            name=unique_name.generate(".".join([self.name, "tmp"])),
            **kwargs,
        )

    def create_or_get_global_variable(self, name, *args, **kwargs):
        block = self.main_program.global_block()
        if block.has_var(name):
            return block.var(name)
        return block.create_var(*args, name=name, persistable=True, **kwargs)

    def set_variable_initializer(self, var, initializer):
        """Create `var` in the startup program and initialize it there."""
        sb = self.startup_program.global_block()
        sv = sb.create_var(
            name=var.name, shape=var.shape, dtype=var.dtype, persistable=True
        )
        initializer(sv, sb)
        return var

    # ---- common epilogues ----
    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        size = list(input_var.shape[dim_start:dim_end])
        bias_attr = self.bias_attr
        if not bias_attr:
            return input_var
        b = self.create_parameter(
            attr=bias_attr, shape=size, dtype=input_var.dtype, is_bias=True
        )
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(
            type="elementwise_add",
            inputs={"X": [input_var], "Y": [b]},
            outputs={"Out": [tmp]},
            attrs={"axis": dim_start},
        )
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        else:
            act = dict(act)
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(
            type=act_type,
            inputs={"X": [input_var]},
            outputs={"Out": [tmp]},
            attrs=act,
        )
        return tmp
