"""Control-flow layers (mirrors ``paddle_tpu/layers/control_flow.py``):
``increment`` (:45), the comparisons (:56-81), the tensor arrays
``create_array`` / ``array_write`` / ``array_read`` / ``array_length``
(:93-155), ``BlockGuard`` (:157), ``While`` (:187-276), ``cond`` (:278),
``ConditionalBlock`` (:330), the recompute regions,
``make_recompute_region_op_spec`` (:362), ``_RecomputeGuard`` (:390) and
``recompute()`` (:436), ``Switch`` (:464), ``IfElse`` (:510-627),
``StaticRNN`` (:630-786), ``DynamicRNN`` (:788-978), ``Print`` (:981),
``is_empty`` (:996) and ``reorder_lod_tensor_by_rank`` (:1005).  Also
``autoincreased_step_counter`` (the reference's ``layers/nn_extra.py:496``),
a step counter for ``ExponentialMovingAverage(thres_steps=...)``.

Each layer appends the reference's ops with the reference's slots and
attrs; ``ops/control_flow.py`` says how they run.  Loop-state vars are
made before the loop and assigned inside it, as the reference requires;
``While`` snapshots the pre-loop value of each loop-state var that has
one (an ``assign`` into ``<name>@WHILE_PRE``), which ``while_grad``
starts from (the executor skips the snapshots no grad op reads).

A recompute region is one ``recompute_block`` op over a sub-block: its
forward runs the region without keeping anything but the outputs later
ops read, and its grad op runs the region again, differentiating that
second run (``ops/control_flow.py``).  The region op takes no id from
the program's counter (its ``__op_id__`` is minus its first op's), so
the ops after a region keep the ids they have without it, and with them
their dropout streams: a program trains bit for bit the same with and
without its regions."""

from .. import core
from ..framework import Variable, default_main_program
from ..layer_helper import LayerHelper
from ..ops.control_flow import ARRAY_CAPACITY_ATTR, DEFAULT_ARRAY_CAPACITY

__all__ = ["increment", "autoincreased_step_counter", "less_than",
           "less_equal", "greater_than", "greater_equal", "equal",
           "not_equal", "create_array", "array_write", "array_read",
           "array_length", "While", "cond", "ConditionalBlock", "Switch",
           "IfElse", "StaticRNN", "DynamicRNN", "recompute", "Print",
           "is_empty", "reorder_lod_tensor_by_rank"]


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


def create_array(dtype, capacity=DEFAULT_ARRAY_CAPACITY):
    """A tensor-array var; its ``capacity`` rides on the var, so every
    ``array_write`` into it makes the same fixed-size buffer."""
    helper = LayerHelper("array")
    var = helper.main_program.current_block().create_var(
        name=helper.name + ".out", dtype=dtype,
        type=core.VarDesc.VarType.LOD_TENSOR_ARRAY)
    var._tensor_array_capacity = int(capacity)
    return var


def array_write(x, i, array=None, capacity=None):
    """Row ``i`` of ``array`` (a new array when None) := ``x``.  The
    first write into an array makes its buffer; a later write (say in a
    ``While`` body) reads the array, so the array is loop-carried."""
    helper = LayerHelper("array_write", **locals())
    if capacity is None:
        capacity = getattr(array, "_tensor_array_capacity",
                           DEFAULT_ARRAY_CAPACITY)
    if array is None:
        array = create_array(x.dtype, capacity)
    inputs = {"X": [x], "I": [i]}
    if getattr(array, "_tensor_array_written", False):
        inputs["Array"] = [array]
    array._tensor_array_written = True
    helper.append_op(type="write_to_array", inputs=inputs,
                     outputs={"Out": [array]},
                     attrs={ARRAY_CAPACITY_ATTR: int(capacity)})
    return array


def array_read(array, i):
    helper = LayerHelper("array_read", **locals())
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op(type="read_from_array",
                     inputs={"X": [array], "I": [i]}, outputs={"Out": [out]})
    return out


def array_length(array):
    helper = LayerHelper("array_length", **locals())
    out = helper.create_variable_for_type_inference("int64", True)
    helper.append_op(type="lod_array_length", inputs={"X": [array]},
                     outputs={"Out": [out]})
    return out


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


class _SubBlockGuard(BlockGuard):
    """Opens a sub-block; on a clean exit closes it and hands it to
    ``owner._complete(sub_block)``."""

    def __init__(self, owner):
        super().__init__(owner.helper.main_program)
        self.owner = owner

    def __enter__(self):
        self.sub_block = self.program._create_block()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        self.program._rollback()
        self.owner._complete(self.sub_block)
        return True


def _has_value_before(block, name):
    """Whether ``name`` holds a value at this point of ``block``: written
    by an earlier op, fed, or persistable (up the parent chain)."""
    b = block
    while b is not None:
        for op in b.ops:
            if name in op.output_arg_names:
                return True
        v = b.vars.get(name)
        if v is not None and (v.persistable or v.is_data):
            return True
        b = b.parent_block
    return False


class While:
    """``with While(cond).block(): ...``: the body runs while ``cond`` (a
    bool var, reassigned inside the body) holds.  ``max_trip_count``
    bounds the trips the gradient differentiates, as the reference's
    masked scan; the forward runs every trip the condition asks for."""

    def __init__(self, cond, is_test=False, name=None, max_trip_count=None):
        self.helper = LayerHelper("while", name=name)
        if cond.dtype != "bool":
            raise TypeError("While condition must be a bool Variable")
        self.cond_var = cond
        self.max_trip_count = max_trip_count

    def block(self):
        return _SubBlockGuard(self)

    def _complete(self, sub_block):
        from .. import unique_name

        parent = self.helper.main_program.current_block()
        written, reads = set(), []
        for op in sub_block.ops:
            for n in op.input_arg_names:
                if n not in written and n not in reads:
                    reads.append(n)
            written.update(op.output_arg_names)
        x_names = [n for n in reads
                   if parent._find_var_recursive(n) is not None]
        out_names = [n for n in written
                     if parent._find_var_recursive(n) is not None]
        # the pre-loop value of each loop-state var, for while_grad
        snap_vars, snap_pres = [], []
        for n in sorted(set(out_names) | {self.cond_var.name}):
            if not _has_value_before(parent, n):
                continue
            v = parent._find_var_recursive(n)
            pre = parent.create_var(
                name=unique_name.generate(n + "@WHILE_PRE"),
                shape=v.shape, dtype=v.dtype)
            parent.append_op(type="assign", inputs={"X": [n]},
                             outputs={"Out": [pre.name]})
            snap_vars.append(n)
            snap_pres.append(pre.name)
        step_scopes = parent.create_var(
            name=self.helper.name + ".step_scopes",
            type=core.VarDesc.VarType.STEP_SCOPES)
        parent.append_op(
            type="while",
            inputs={"X": x_names, "Condition": [self.cond_var]},
            outputs={"Out": out_names, "StepScopes": [step_scopes]},
            attrs={"sub_block": sub_block.idx, "is_test": False,
                   "max_trip_count": int(self.max_trip_count or 0),
                   "snapshot_vars": snap_vars, "snapshot_pres": snap_pres})


def cond(pred, true_fn=None, false_fn=None, name=None):
    """Two branches as two ``ConditionalBlock``s (the second on ``not
    pred``) that assign into shared output vars, zero-filled first."""
    from .. import unique_name
    from .ops import logical_not

    helper = LayerHelper("cond", name=name)
    parent = helper.main_program.current_block()
    out_vars = []

    def capture(rets):
        if rets is None:
            return
        rets = list(rets) if isinstance(rets, (list, tuple)) else [rets]
        if not out_vars:
            for r in rets:
                if r.shape is None or any(d < 0 for d in r.shape):
                    raise ValueError(
                        "cond() branch outputs need static shapes (got %s "
                        "for %s)" % (r.shape, r.name))
                ov = parent.create_var(
                    name=unique_name.generate("cond.out"), shape=r.shape,
                    dtype=r.dtype)
                parent.append_op(
                    type="fill_constant", outputs={"Out": [ov]},
                    attrs={"shape": list(r.shape), "dtype": r.dtype,
                           "value": 0.0})
                out_vars.append(ov)
        cur = helper.main_program.current_block()
        for r, ov in zip(rets, out_vars):
            cur.append_op(type="assign", inputs={"X": [r]},
                          outputs={"Out": [ov]})

    with ConditionalBlock([pred]).block():
        capture(true_fn() if true_fn is not None else None)
    if false_fn is not None:
        with ConditionalBlock([logical_not(pred)]).block():
            capture(false_fn())
    if not out_vars:
        return None
    return out_vars[0] if len(out_vars) == 1 else out_vars


class ConditionalBlock:
    """Run a sub-block when the condition holds; the vars it assigns keep
    their earlier values when it does not."""

    def __init__(self, inputs, is_scalar_condition=True, name=None):
        self.helper = LayerHelper("conditional_block", name=name)
        self.inputs = inputs if isinstance(inputs, (list, tuple)) \
            else [inputs]

    def block(self):
        return _SubBlockGuard(self)

    def _complete(self, sub_block):
        parent = self.helper.main_program.current_block()
        written = set()
        for op in sub_block.ops:
            written.update(op.output_arg_names)
        out_names = [n for n in written
                     if parent._find_var_recursive(n) is not None]
        scope_var = parent.create_var(
            name=self.helper.name + ".scope",
            type=core.VarDesc.VarType.STEP_SCOPES)
        parent.append_op(
            type="conditional_block", inputs={"Cond": [self.inputs[0]]},
            outputs={"Out": out_names, "Scope": [scope_var]},
            attrs={"sub_block": sub_block.idx})


class Switch:
    """A case / default chain of ``ConditionalBlock``s: a case runs when
    its condition holds and no earlier one did."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.pre_not_conditions = []
        self.inside_scope = False

    def case(self, condition):
        from .ops import logical_and, logical_not

        cur = condition
        for prev in self.pre_not_conditions:
            cur = logical_and(cur, prev)
        self.pre_not_conditions.append(logical_not(condition))
        return ConditionalBlock([cur]).block()

    def default(self):
        from .ops import logical_and

        cur = self.pre_not_conditions[0]
        for prev in self.pre_not_conditions[1:]:
            cur = logical_and(cur, prev)
        return ConditionalBlock([cur]).block()

    def __enter__(self):
        self.inside_scope = True
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.inside_scope = False
        return exc_type is None


class _IfElseBlockGuard:
    def __init__(self, is_true, ie):
        self.is_true = is_true
        self.ie = ie

    def __enter__(self):
        self.ie.status = (IfElse.IN_IF_ELSE_TRUE_BLOCKS if self.is_true
                          else IfElse.IN_IF_ELSE_FALSE_BLOCKS)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        if not self.ie.output_table[1 if self.is_true else 0]:
            raise ValueError("Must set output inside block")
        self.ie.status = IfElse.OUT_IF_ELSE_BLOCKS
        return True


class IfElse:
    """Per-row branches over a ``[B, 1]`` bool mask, in the reference's
    static-shape form: ``split_lod_tensor`` hands both branches the whole
    batch and ``merge_lod_tensor`` picks each row's branch.  Usage::

        ie = fluid.layers.IfElse(cond)
        with ie.true_block():
            ie.output(some_layers(ie.input(x)))
        with ie.false_block():
            ie.output(other_layers(ie.input(x)))
        merged, = ie()
    """

    OUT_IF_ELSE_BLOCKS = 0
    IN_IF_ELSE_TRUE_BLOCKS = 1
    IN_IF_ELSE_FALSE_BLOCKS = 2

    def __init__(self, cond, name=None):
        if not isinstance(cond, Variable):
            raise TypeError("cond must be a Variable")
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self.status = IfElse.OUT_IF_ELSE_BLOCKS
        self.input_table = {}
        self.output_table = ([], [])  # (false outputs, true outputs)

    def input(self, x):
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("input() must be called inside a block")
        if id(x) not in self.input_table:
            block = self.helper.main_program.current_block()
            k = len(self.input_table)
            out_true = block.create_var(
                name=self.helper.name + ".in_true_%d" % k, shape=x.shape,
                dtype=x.dtype)
            out_false = block.create_var(
                name=self.helper.name + ".in_false_%d" % k, shape=x.shape,
                dtype=x.dtype)
            block.append_op(
                type="split_lod_tensor",
                inputs={"X": [x], "Mask": [self.cond]},
                outputs={"OutTrue": [out_true], "OutFalse": [out_false]},
                attrs={"level": 0})
            self.input_table[id(x)] = (out_true, out_false)
        out_true, out_false = self.input_table[id(x)]
        return out_true if self.status == IfElse.IN_IF_ELSE_TRUE_BLOCKS \
            else out_false

    def true_block(self):
        return _IfElseBlockGuard(True, self)

    def false_block(self):
        return _IfElseBlockGuard(False, self)

    def output(self, *outs):
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("output() can only be invoked inside a block")
        self.output_table[
            1 if self.status == IfElse.IN_IF_ELSE_TRUE_BLOCKS else 0
        ].extend(outs)

    def __call__(self):
        if self.status != IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("IfElse::__call__ must be out of sub-blocks")
        false_outs, true_outs = self.output_table
        if len(false_outs) != len(true_outs):
            raise ValueError(
                "true_block and false_block must set the same number of "
                "outputs (%d vs %d)" % (len(true_outs), len(false_outs)))
        block = self.helper.main_program.current_block()
        merged = []
        for i, (t, f) in enumerate(zip(true_outs, false_outs)):
            out = block.create_var(name=self.helper.name + ".out_%d" % i,
                                   shape=t.shape, dtype=t.dtype)
            block.append_op(
                type="merge_lod_tensor",
                inputs={"InTrue": [t], "InFalse": [f], "Mask": [self.cond],
                        "X": [t]},
                outputs={"Out": [out]}, attrs={"level": 0})
            merged.append(out)
        return merged


class _RNNGuard(BlockGuard):
    """Opens the step block of a StaticRNN or DynamicRNN; on a clean exit
    closes it and appends the ``recurrent`` op."""

    def __init__(self, rnn):
        super().__init__(rnn.helper.main_program)
        self.rnn = rnn

    def __enter__(self):
        self.rnn._sub_block = self.program._create_block()
        self.rnn.status = self.rnn.IN_RNN_BLOCK
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        self.program._rollback()
        self.rnn.status = self.rnn.AFTER_RNN_BLOCK
        self.rnn._complete()
        return True


class _RNN:
    """What StaticRNN and DynamicRNN share: the step block, its memories
    and outputs, and the ``recurrent`` op they append."""

    BEFORE_RNN_BLOCK = 0
    IN_RNN_BLOCK = 1
    AFTER_RNN_BLOCK = 2

    def __init__(self, layer_type, name=None):
        self.helper = LayerHelper(layer_type, name=name)
        self.status = self.BEFORE_RNN_BLOCK
        self._sub_block = None
        self.seq_inputs = []       # outer sequence vars
        self.step_input_vars = []  # their per-step vars in the step block
        self.memories = []         # (pre-state var, initial var)
        self.mem_updates = {}      # pre-state name -> new state name
        self.step_outputs = []
        self.outputs = []          # outer stacked outputs

    def _assert_in_rnn_block(self, method):
        if self.status != self.IN_RNN_BLOCK:
            raise RuntimeError("%s() can only be called inside the RNN's "
                               "step block" % method)

    def _step_var(self, x, shape):
        self.seq_inputs.append(x)
        sv = self._sub_block.create_var(
            name=self.helper.name + ".step_in_%d"
            % len(self.step_input_vars), shape=shape, dtype=x.dtype)
        self.step_input_vars.append(sv)
        return sv

    def _filled_init(self, ref, shape, dtype, value, batch_dim):
        """A [batch, *shape] initial state filled with ``value``, made in
        the parent block before the op (batch from ``ref``'s
        ``batch_dim``)."""
        parent = self.helper.main_program.block(self._sub_block.parent_idx)
        init = parent.create_var(
            name=self.helper.name + ".mem_init_%d" % len(self.memories),
            shape=(-1,) + tuple(shape), dtype=dtype)
        parent.append_op(
            type="fill_constant_batch_size_like", inputs={"Input": [ref]},
            outputs={"Out": [init]},
            attrs={"shape": [0] + [int(s) for s in shape], "dtype": dtype,
                   "value": float(value), "input_dim_idx": batch_dim,
                   "output_dim_idx": 0})
        return init

    def _memory_of(self, init):
        pre = self._sub_block.create_var(
            name=self.helper.name + ".mem_%d" % len(self.memories),
            shape=init.shape, dtype=init.dtype)
        self.memories.append((pre, init))
        return pre

    def update_memory(self, mem, var):
        self._assert_in_rnn_block("update_memory")
        self.mem_updates[mem.name] = var.name

    def __call__(self, *args):
        if self.status != self.AFTER_RNN_BLOCK:
            raise RuntimeError("RNN output requested before its step "
                               "block closed")
        if len(self.outputs) == 1:
            return self.outputs[0]
        return self.outputs

    def _append_recurrent(self, out_shapes, inputs, attrs):
        parent = self.helper.main_program.current_block()
        self.outputs = [
            parent.create_var(name=self.helper.name + ".out_%d" % i,
                              shape=shape, dtype=so.dtype)
            for i, (so, shape) in enumerate(zip(self.step_outputs,
                                                out_shapes))]
        inputs = dict({
            "inputs": [v.name for v in self.seq_inputs],
            "initial_states": [init.name for _, init in self.memories]},
            **inputs)
        attrs = dict({"sub_block": self._sub_block.idx}, **attrs)
        attrs.update({
            "step_input_names": [v.name for v in self.step_input_vars],
            "state_names": [pre.name for pre, _ in self.memories],
            "state_out_names": [self.mem_updates.get(pre.name, pre.name)
                                for pre, _ in self.memories],
            "step_output_names": [v.name for v in self.step_outputs]})
        parent.append_op(
            type="recurrent", inputs=inputs,
            outputs={"outputs": [v.name for v in self.outputs],
                     "final_states": []},
            attrs=attrs)


class StaticRNN(_RNN):
    """An RNN over time-major [T, B, ...] sequences: the step block runs
    once per time step (one ``recurrent`` op)."""

    def __init__(self, name=None):
        super().__init__("static_rnn", name=name)

    def step(self):
        return _RNNGuard(self)

    def step_input(self, x):
        self._assert_in_rnn_block("step_input")
        return self._step_var(x, x.shape[1:] if x.shape else None)

    def memory(self, init=None, shape=None, batch_ref=None,
               init_value=0.0, init_batch_dim_idx=0, ref_batch_dim_idx=1):
        self._assert_in_rnn_block("memory")
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError("memory needs init or (shape & batch_ref)")
            for sv, seq in zip(self.step_input_vars, self.seq_inputs):
                if batch_ref is sv or batch_ref.name == sv.name:
                    break
            else:
                raise ValueError(
                    "batch_ref must be one of this RNN's step_input vars")
            # batch dim 1 of the time-major outer sequence
            init = self._filled_init(seq, shape, "float32", init_value, 1)
        return self._memory_of(init)

    def step_output(self, o):
        self._assert_in_rnn_block("step_output")
        self.step_outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _complete(self):
        steps = self.seq_inputs[0].shape[0] if self.seq_inputs else -1
        self._append_recurrent(
            [(steps,) + tuple(so.shape or ()) for so in self.step_outputs],
            {}, {})


class DynamicRNN(_RNN):
    """An RNN over padded batch-major [B, T, ...] sequences of
    ``lengths`` [B]: the step block runs T times, and a row at ``t >=
    length`` keeps its state, its step outputs zero (the padded form of
    the reference's rank-table reordering)::

        drnn = DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(x, lengths=seq_len)   # x: [B, T, D]
            h_prev = drnn.memory(shape=[H], value=0.0)
            h = some_layers(x_t, h_prev)
            drnn.update_memory(h_prev, h)
            drnn.output(h)
        out = drnn()                                    # [B, T, H]
    """

    def __init__(self, name=None):
        super().__init__("dynamic_rnn", name=name)
        self.lengths = None

    def block(self):
        return _RNNGuard(self)

    def step_input(self, x, level=0, lengths=None):
        """A [B, T, ...] padded sequence; the first one comes with its
        ``lengths`` ([B] ints, the reference's LoD offsets)."""
        self._assert_in_rnn_block("step_input")
        if lengths is not None:
            self.lengths = lengths
        if self.lengths is None:
            raise ValueError(
                "DynamicRNN.step_input needs a `lengths` tensor with the "
                "first sequence input (padded batches carry explicit "
                "lengths instead of LoD)")
        shape = None
        if x.shape is not None:
            shape = (x.shape[0],) + tuple(x.shape[2:])
        return self._step_var(x, shape)

    def static_input(self, x):
        """A var every step reads as it is (the step block reads it from
        outside; no reordering in the padded form)."""
        self._assert_in_rnn_block("static_input")
        return x

    def memory(self, init=None, shape=None, value=0.0, need_reorder=False,
               dtype="float32"):
        self._assert_in_rnn_block("memory")
        if init is None:
            if shape is None or not self.seq_inputs:
                raise ValueError(
                    "memory needs init=, or shape= after a step_input")
            # batch dim 0 of the batch-major outer sequence
            init = self._filled_init(self.seq_inputs[0], shape, dtype,
                                     value, 0)
        return self._memory_of(init)

    def output(self, *outputs):
        self._assert_in_rnn_block("output")
        self.step_outputs.extend(outputs)

    def _complete(self):
        shape = self.seq_inputs[0].shape
        batch, steps = (shape[0], shape[1]) if shape else (-1, -1)
        self._append_recurrent(
            [(batch, steps) + tuple((so.shape or ())[1:])
             for so in self.step_outputs],
            {"sequence_length": [self.lengths.name]},
            {"time_major": False})


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """A ``print`` op: prints ``message`` and the values when it runs and
    passes ``input`` on (a host read: not capturable)."""
    helper = LayerHelper("print")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="print", inputs={"In": [input]},
                     outputs={"Out": [out]},
                     attrs={"message": message or ""})
    return out


def is_empty(x, cond=None):
    helper = LayerHelper("is_empty")
    out = cond or helper.create_variable_for_type_inference("bool", True)
    helper.append_op(type="is_empty", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    helper = LayerHelper("reorder_lod_tensor_by_rank")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="reorder_lod_tensor_by_rank",
                     inputs={"X": [x], "RankTable": [rank_table]},
                     outputs={"Out": [out]})
    return out
