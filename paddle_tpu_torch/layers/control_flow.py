"""Control-flow layers (mirrors ``paddle_tpu/layers/control_flow.py``):
``increment`` (:45), the comparisons (:56-81), ``BlockGuard`` (:157)
and the recompute regions, ``make_recompute_region_op_spec`` (:362),
``_RecomputeGuard`` (:390) and ``recompute()`` (:436).  ``While``,
``ConditionalBlock`` and the tensor arrays come with the decode loop
(ROADMAP.md, Queue A item 5).  Also ``autoincreased_step_counter``
(the reference's ``layers/nn_extra.py:496``), a step counter for
``ExponentialMovingAverage(thres_steps=...)``.

A recompute region is one ``recompute_block`` op over a sub-block: its
forward runs the region without keeping anything but the outputs later
ops read, and its grad op runs the region again, differentiating that
second run (``ops/control_flow.py``).  The region op takes no id from
the program's counter (its ``__op_id__`` is minus its first op's), so
the ops after a region keep the ids they have without it, and with them
their dropout streams: a program trains bit for bit the same with and
without its regions."""

from .. import core
from ..framework import default_main_program
from ..layer_helper import LayerHelper

__all__ = ["increment", "autoincreased_step_counter", "less_than",
           "less_equal", "greater_than", "greater_equal", "equal",
           "not_equal", "recompute"]


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment", **locals())
    out = x if in_place else \
        helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A persistable int64 ``[1]`` counter (``@STEP_COUNTER@`` unless
    named), ``begin`` at the first step, advanced in place by an
    ``increment`` op appended where this is called."""
    from .. import initializer

    helper = LayerHelper("global_step_counter")
    name = counter_name or "@STEP_COUNTER@"
    block = helper.main_program.global_block()
    if block.has_var(name):
        counter = block.var(name)
    else:
        counter = block.create_var(name=name, dtype="int64", shape=[1],
                                   persistable=True)
        counter.stop_gradient = True
        helper.set_variable_initializer(
            counter, initializer.ConstantInitializer(float(begin - step)))
    block.append_op(type="increment", inputs={"X": [counter]},
                    outputs={"Out": [counter]}, attrs={"step": float(step)})
    return counter


def _compare(op_type, x, y, cond=None):
    helper = LayerHelper(op_type, **locals())
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool", True)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def less_than(x, y, force_cpu=None, cond=None):
    return _compare("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _compare("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _compare("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _compare("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _compare("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _compare("not_equal", x, y, cond)


class BlockGuard:
    def __init__(self, program):
        self.program = program

    def __enter__(self):
        self.program._create_block()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.program._rollback()
        return exc_type is None


def make_recompute_region_op_spec(parent, sub_block, scope_name):
    """The ``recompute_block`` op over ``sub_block``, shared by
    :func:`recompute` and ``optimizer.rewrite_program_recompute``:
    ``Out`` is every name the region writes, ``Captured`` the region's
    reads from before it that resolve in ``parent`` (formal inputs, so
    backward's op-path walk and the executor's scope reads see them)."""
    from ..ops.control_flow import sub_block_external_reads

    written = []
    for op in sub_block.ops:
        for n in op.output_arg_names:
            if n and n not in written:
                written.append(n)
    captured = [n for n in sub_block_external_reads(sub_block)
                if parent._find_var_recursive(n) is not None]
    scope_var = parent.create_var(name=scope_name,
                                  type=core.VarDesc.VarType.STEP_SCOPES)
    attrs = {"sub_block": sub_block.idx}
    if sub_block.ops:
        attrs["__op_id__"] = -int(sub_block.ops[0].attrs["__op_id__"])
    return dict(type="recompute_block", inputs={"Captured": captured},
                outputs={"Out": written, "Scope": [scope_var.name]},
                attrs=attrs)


class _RecomputeGuard(BlockGuard):
    """``with fluid.layers.recompute():`` — the ops built inside become
    one ``recompute_block`` op; its grad op runs them again instead of
    the step keeping their activations (one more forward of the region
    for its inputs and outputs alone held across the step)."""

    def __init__(self, name=None):
        super().__init__(default_main_program())
        self.helper = LayerHelper("recompute_block", name=name)

    def __enter__(self):
        self.sub_block = self.program._create_block()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.program._rollback()
        if exc_type is not None:
            return False
        parent = self.program.current_block()
        # the region's vars stay referable by later layers
        for name, var in self.sub_block.vars.items():
            if parent._find_var_recursive(name) is None:
                parent.vars[name] = var
        parent.append_op(**make_recompute_region_op_spec(
            parent, self.sub_block, self.helper.name + ".scope"))
        return True


def recompute(name=None):
    """Context manager: the ops built inside are run again in backward
    instead of keeping their activations::

        with fluid.layers.recompute():
            h = fluid.layers.fc(h, size=1024, act="relu")
    """
    return _RecomputeGuard(name=name)
