"""Seq2seq decoder DSL (mirrors
``paddle_tpu/contrib/decoder/beam_search_decoder.py``, the whole file:
``InitState`` :23, ``StateCell`` :58, ``TrainingDecoder`` :129,
``BeamSearchDecoder`` :203; the reference's
``python/paddle/fluid/contrib/decoder/beam_search_decoder.py``).

Beams are dense, as in the reference package: ids and scores are [B, K],
per-beam states [B*K, H], and a gather by the parent beam index takes
the place of the LoD expansion.  ``TrainingDecoder`` runs on
``DynamicRNN`` (one ``recurrent`` op and its grad);
``BeamSearchDecoder.decode`` is a bounded ``While`` over the dense step
records, updated through ``assign(..., output=carry)``, stopped early
through its condition, and backtraced by ``beam_search_decode``.
"""

import contextlib

import paddle_tpu_torch as fluid

__all__ = ["InitState", "StateCell", "TrainingDecoder",
           "BeamSearchDecoder"]


class InitState:
    """Initial decoder state (Paddle :43): either an existing variable
    (``init``) or a to-be-created zero/constant state (``shape`` +
    ``value``) whose batch dim follows ``init_boot``."""

    def __init__(self, init=None, shape=None, value=0.0, init_boot=None,
                 need_reorder=False, dtype="float32"):
        if init is None and init_boot is None and shape is None:
            raise ValueError(
                "InitState needs init, or shape (+ optional init_boot)")
        self._init = init
        self._shape = shape
        self._value = value
        self._need_reorder = need_reorder
        self._dtype = dtype

    @property
    def value(self):
        return self._init

    @property
    def need_reorder(self):
        return self._need_reorder

    def make_var(self, batch_ref=None):
        if self._init is not None:
            return self._init
        shape = list(self._shape or [])
        if batch_ref is not None and (not shape or shape[0] in (None, -1)):
            b = batch_ref.shape[0]
            shape = [b] + [d for d in shape[1:]]
        return fluid.layers.fill_constant(shape, self._dtype,
                                          float(self._value))


class StateCell:
    """Symbolic step cell (Paddle :159): named inputs + named states +
    an updater registered with ``@cell.state_updater`` that reads
    ``get_input``/``get_state`` and writes ``set_state``."""

    def __init__(self, inputs, states, out_state, name=None):
        self._inputs = dict(inputs)
        self._init_states = dict(states)
        self._state_names = list(states)
        self._out_state_name = out_state
        self._cur_states = {}
        self._next_states = {}
        self._updater = None
        self._decoder = None

    # decoder context ----------------------------------------------------
    def _enter_decoder(self, decoder):
        self._decoder = decoder

    def _leave_decoder(self, decoder):
        self._decoder = None

    # updater API --------------------------------------------------------
    def state_updater(self, updater):
        self._updater = updater

        def _decorator(cell):
            return updater(cell)

        return _decorator

    def get_input(self, input_name):
        if input_name not in self._inputs:
            raise ValueError("unknown input %r" % input_name)
        v = self._inputs[input_name]
        if v is None:
            raise ValueError("input %r has no value this step" % input_name)
        return v

    def get_state(self, state_name):
        if state_name not in self._cur_states:
            raise ValueError("unknown state %r" % state_name)
        return self._cur_states[state_name]

    def set_state(self, state_name, state_value):
        self._next_states[state_name] = state_value

    def compute_state(self, inputs):
        """Run the updater with this step's input values."""
        if self._updater is None:
            raise ValueError("no state_updater registered")
        for k, v in inputs.items():
            if k not in self._inputs:
                raise ValueError("unknown input %r" % k)
            self._inputs[k] = v
        self._next_states = {}
        self._updater(self)

    def update_states(self):
        """Commit set_state() values as the next step's states (the
        decoder in context wires the carry)."""
        if self._decoder is None:
            raise ValueError("update_states outside a decoder block")
        self._decoder._commit_states(self)

    def out_state(self):
        return self._next_states.get(
            self._out_state_name,
            self._cur_states.get(self._out_state_name))


class TrainingDecoder:
    """Teacher-forced decoder (Paddle :384) over DynamicRNN: states
    become rnn memories, ``step_input`` slices the target sequence, the
    updater runs per step."""

    def __init__(self, state_cell, name=None):
        self._state_cell = state_cell
        self._rnn = fluid.layers.DynamicRNN()
        self._in_block = False

    @property
    def state_cell(self):
        return self._state_cell

    @property
    def dynamic_rnn(self):
        return self._rnn

    @property
    def type(self):
        return "training"

    @contextlib.contextmanager
    def block(self):
        self._state_cell._enter_decoder(self)
        with self._rnn.block():
            self._in_block = True
            # states → rnn memories (init from InitState)
            self._memories = {}
            for name in self._state_cell._state_names:
                ist = self._state_cell._init_states[name]
                if ist.value is not None:
                    mem = self._rnn.memory(init=ist.value,
                                           need_reorder=ist.need_reorder)
                else:
                    shape = list(ist._shape or [])
                    mem = self._rnn.memory(shape=shape[1:] or shape,
                                           value=float(ist._value))
                self._memories[name] = mem
                self._state_cell._cur_states[name] = mem
            yield
            self._in_block = False
        self._state_cell._leave_decoder(self)

    def step_input(self, x, lengths=None):
        """``lengths`` [B] marks each sequence's valid steps (the LoD
        replacement); None means every row runs the full padded length
        (the fill op is emitted in x's own block, outside the rnn)."""
        if lengths is None and self._rnn.lengths is None:
            prog = x.block.program
            cur = prog.current_block_idx
            prog.current_block_idx = x.block.idx
            try:
                lengths = fluid.layers.fill_constant_batch_size_like(
                    x, [-1], "int64", float(x.shape[1]))
            finally:
                prog.current_block_idx = cur
        return self._rnn.step_input(x, lengths=lengths)

    def static_input(self, x):
        return self._rnn.static_input(x)

    def output(self, *outputs):
        self._rnn.output(*outputs)

    def _commit_states(self, cell):
        for name, new in cell._next_states.items():
            self._rnn.update_memory(self._memories[name], new)
            cell._cur_states[name] = new

    def __call__(self, *args, **kwargs):
        return self._rnn(*args, **kwargs)


class BeamSearchDecoder:
    """Beam decoder (Paddle :523), dense-beam redesign:
    ``init_ids``/``init_scores`` are [B, K] (beam 0 live, others -inf);
    states are [B*K, H] and are re-gathered by the parent index each
    step (the LoD sequence_expand role).  ``decode()`` builds the
    standard loop; ``__call__`` backtraces to ([B, K, max_len] ids,
    [B, K] scores)."""

    def __init__(self, state_cell, init_ids, init_scores, target_dict_dim,
                 word_dim, input_var_dict=None, topk_size=50,
                 sparse_emb=True, max_len=100, beam_size=1, end_id=1,
                 name=None):
        self._state_cell = state_cell
        self._init_ids = init_ids
        self._init_scores = init_scores
        self._target_dict_dim = int(target_dict_dim)
        self._word_dim = int(word_dim)
        self._input_var_dict = dict(input_var_dict or {})
        self._max_len = int(max_len)
        self._beam_size = int(beam_size)
        self._end_id = int(end_id)
        self._sparse_emb = sparse_emb
        self._name = name or "beam_search_decoder"
        self._arrays = {}         # id(array) → (array, update_var)
        self._built = False

    @property
    def state_cell(self):
        return self._state_cell

    @property
    def type(self):
        return "beam_search"

    @contextlib.contextmanager
    def block(self):
        """Open the decode loop.  Inside: read_array for loop-carried
        beams, the step computation, update_array for next-step values;
        on exit the arrays' step records are written and the counter
        advances."""
        L = fluid.layers
        B, K = self._init_ids.shape
        self._B, self._K = int(B), int(K)
        self._state_cell._enter_decoder(self)

        self._counter = L.fill_constant([1], "int32", 0.0)
        limit = L.fill_constant([1], "int32", float(self._max_len))
        self._cond = L.less_than(self._counter, limit)
        self._limit = limit

        # per-beam state carry vars: tile [B, H] inits to [B*K, H]
        self._state_vars = {}
        for name in self._state_cell._state_names:
            ist = self._state_cell._init_states[name]
            init = ist.make_var(batch_ref=self._init_ids)
            tiled = L.reshape(
                L.expand(L.unsqueeze(init, axes=[1]),
                         expand_times=[1, self._K, 1]),
                shape=[self._B * self._K, -1])
            carry = L.assign(tiled)
            self._state_vars[name] = carry

        self._row_offset = L.reshape(
            L.range(0, self._B * self._K, self._K, "int32"),
            shape=[self._B, 1])

        # parent record for every step (custom loops record it via
        # update_parents; decode() does so itself)
        zero = L.fill_constant([1], "int32", 0.0)
        self._parents_array = L.array_write(
            L.assign(L.cast(self._init_ids, "int32")), zero,
            capacity=self._max_len)

        self._while = L.While(self._cond)
        self._pending_writes = []
        self._parent = None
        self._alive = None
        with self._while.block():
            for name, carry in self._state_vars.items():
                self._state_cell._cur_states[name] = carry
            yield
            # epilogue: write this step's records, advance, re-check.
            # ANDing with the CURRENT cond keeps an early_stop() False
            # sticky instead of clobbering it
            for array, value in self._pending_writes:
                L.array_write(value, self._counter, array)
            L.increment(self._counter, in_place=True)
            keep = L.logical_and(L.less_than(self._counter, self._limit),
                                 self._cond)
            if self._alive is not None:
                keep = L.logical_and(keep, self._alive)
            L.assign(keep, output=self._cond)
        self._state_cell._leave_decoder(self)
        self._built = True

    @contextlib.contextmanager
    def _parent_block(self):
        """Emit ops into the block ENCLOSING the while (the reference's
        _parent_block(): arrays and their init writes live pre-loop)."""
        prog = fluid.default_main_program()
        cur = prog.current_block_idx
        prog.current_block_idx = prog.block(cur).parent_idx
        try:
            yield
        finally:
            prog.current_block_idx = cur

    def read_array(self, init, is_ids=False, is_scores=False):
        """A loop-carried [B, K] value: pre-loop it holds ``init``; each
        step's update_array() both records it into the step array and
        carries it to the next iteration."""
        L = fluid.layers
        with self._parent_block():
            carry = L.assign(init)
            zero = L.fill_constant([1], "int32", 0.0)
            array = L.array_write(L.assign(init), zero,
                                  capacity=self._max_len)
        self._arrays[id(carry)] = (array, carry)
        if is_ids:
            self._ids_carry, self._ids_array = carry, array
        if is_scores:
            self._scores_carry, self._scores_array = carry, array
        return carry

    def update_array(self, array, value):
        """Record ``value`` as this step's entry of ``array``'s step
        records and carry it into the next iteration."""
        arr, carry = self._arrays[id(array)]
        self._pending_writes.append((arr, value))
        fluid.layers.assign(value, output=carry)

    def early_stop(self):
        fluid.layers.fill_constant([1], "bool", 0.0, out=self._cond)

    def update_parents(self, parent):
        """Record this step's [B, K] parent-beam indices (custom block()
        loops must call this once per step so the final backtrace —
        ``decoder()`` → beam_search_decode — can replay the tree)."""
        self._parent = parent
        self._pending_writes.append((self._parents_array, parent))

    def _commit_states(self, cell):
        """Gather each state by the step's parent beams and carry it."""
        L = fluid.layers
        parent = self._parent
        for name, new in cell._next_states.items():
            if parent is not None:
                gp = L.reshape(
                    L.elementwise_add(parent, self._row_offset),
                    shape=[self._B * self._K])
                new = L.gather(new, gp)
            L.assign(new, output=self._state_vars[name])
            cell._cur_states[name] = self._state_vars[name]

    def decode(self):
        """The standard decode step (Paddle :653), dense-beam form."""
        L = fluid.layers
        with self.block():
            prev_ids = self.read_array(self._init_ids, is_ids=True)
            prev_scores = self.read_array(self._init_scores,
                                          is_scores=True)

            flat_ids = L.reshape(L.cast(prev_ids, "int64"),
                                 shape=[self._B * self._K])
            emb = L.embedding(flat_ids,
                              size=[self._target_dict_dim, self._word_dim],
                              param_attr=fluid.ParamAttr(
                                  name=self._name + "_emb"))
            feed_dict = {}
            for in_name in self._state_cell._inputs:
                if in_name in self._input_var_dict:
                    feed_dict[in_name] = self._input_var_dict[in_name]
                else:
                    feed_dict[in_name] = emb
            self._state_cell.compute_state(inputs=feed_dict)
            current_state = self._state_cell.out_state()
            logits = L.fc(current_state, size=self._target_dict_dim,
                          param_attr=fluid.ParamAttr(
                              name=self._name + "_out_w"),
                          bias_attr=fluid.ParamAttr(
                              name=self._name + "_out_b"))
            logp = L.log_softmax(logits)
            logp3 = L.reshape(
                logp, shape=[self._B, self._K, self._target_dict_dim])
            sel_ids, sel_scores, parent = L.beam_search(
                prev_ids, prev_scores, None, logp3,
                beam_size=self._beam_size, end_id=self._end_id,
                is_accumulated=False, return_parent_idx=True)
            self.update_parents(parent)

            # alive check (the reference's is_empty early stop)
            end_const = L.fill_constant([self._B, self._K], "int32",
                                        float(self._end_id))
            alive = L.cast(L.not_equal(sel_ids, end_const), "int32")
            self._alive = L.greater_than(
                L.reduce_sum(alive), L.fill_constant([1], "int32", 0.0))

            self._state_cell.update_states()
            self.update_array(prev_ids, sel_ids)
            self.update_array(prev_scores, sel_scores)
        return self

    def __call__(self):
        if not self._built:
            raise ValueError("call decode() (or build a block()) first")
        if not hasattr(self, "_ids_array"):
            raise ValueError(
                "no beam arrays recorded: a custom block() loop must "
                "read_array(init_ids, is_ids=True) / read_array(..., "
                "is_scores=True) and call update_parents() each step")
        return fluid.layers.beam_search_decode(
            self._ids_array, self._scores_array, self._parents_array,
            beam_size=self._beam_size, end_id=self._end_id)
