"""Collective transpilers (mirrors ``paddle_tpu/transpiler/collective.py``
:17-478: ``ensure_comm_ring``, ``Collective``, ``GradAllReduce``,
``LocalSGD``, ``GeoSGD``, ``AsyncSGD`` and ``build_toy_async_program``).

``GradAllReduce`` inserts a ``c_allreduce_sum`` (``pre_scale`` 1/nranks)
after the backward op that produces each parameter gradient the
optimizer consumes, and the startup program gets one
``c_gen_nccl_id`` → ``c_comm_init`` pair per ring.  Run by one process
per rank, the ops exchange over the process group ``c_comm_init`` binds
(``ops/collective.py``); the fusion pipeline buckets them into
``c_fused_allreduce_sum`` or ``c_allreduce_quant``
(``static_analysis/fusion.py``).

``LocalSGD`` averages the parameters' deltas since a snapshot every
step, ``GeoSGD`` every ``need_push_nums`` steps behind a 0/1 gate (a
persistable counter, ``elementwise_mod``), and ``AsyncSGD`` applies the
mean of the previous step's gradients (staleness 1; with DC-ASGD, delay
compensated), as the reference's programs do op for op.  The
reference's ``async_two_worker_probe`` is a ``shard_map`` recipe; its
counterpart here is a two-rank run of ``build_toy_async_program``
(``tests/test_torch_collective_modes.py``).
"""

from ..framework import (Operator, default_main_program,
                         default_startup_program)

__all__ = ["GradAllReduce", "LocalSGD", "GeoSGD", "AsyncSGD", "Collective",
           "ensure_comm_ring"]

OP_ROLE_BACKWARD = "backward"


def ensure_comm_ring(startup_program, ring_id, rank=0, nranks=1):
    """Append the ``c_gen_nccl_id`` → ``c_comm_init`` pair for
    ``ring_id`` to a startup program, once per ring."""
    block = startup_program.global_block()
    for op in block.ops:
        if op.type == "c_gen_nccl_id" \
                and op.attrs.get("ring_id") == ring_id:
            return
    nccl_id = block.create_var(name="tpu_comm_id_%s" % ring_id,
                               shape=[1], dtype="int32", persistable=True)
    block.append_op(
        type="c_gen_nccl_id", outputs={"Out": [nccl_id]},
        attrs={"rank": rank, "ring_id": ring_id},
    )
    block.append_op(
        type="c_comm_init", inputs={"X": [nccl_id]},
        attrs={"nranks": nranks, "rank": rank, "ring_id": ring_id},
    )


class Collective:
    def __init__(self, nrings=1):
        self.nrings = nrings
        self.rank = 0
        self.nranks = 1

    def transpile(self, startup_program=None, program=None, rank=0,
                  nranks=1, endpoints=None, current_endpoint=None,
                  wait_port=True):
        self.rank = rank
        self.nranks = nranks
        self.main_program = program or default_main_program()
        self.startup_program = startup_program or default_startup_program()
        self._transpile_startup_program()
        self._transpile_main_program()

    def _transpile_startup_program(self):
        for ring in range(self.nrings):
            ensure_comm_ring(self.startup_program, ring,
                             rank=self.rank, nranks=self.nranks)

    def _transpile_main_program(self):
        raise NotImplementedError


class GradAllReduce(Collective):
    def _transpile_main_program(self):
        if self.nranks <= 1:
            return
        block = self.main_program.global_block()
        # the grad the optimizer consumes is the one to exchange (for a
        # shared parameter, the fan-in sum, not a partial); activation
        # grads differ per rank and are never exchanged
        param_grads = {
            p.name + "@GRAD" for p in self.main_program.all_parameters()
        }
        for op in block.ops:
            if op.attrs.get("op_role") == "optimize" and op.input("Grad"):
                g = op.input("Grad")[0]
                p = op.input("Param")
                if p:
                    param_grads.discard(p[0] + "@GRAD")
                param_grads.add(g)
        new_ops = []
        for op in block.ops:
            new_ops.append(op)
            if op.attrs.get("op_role") != OP_ROLE_BACKWARD:
                continue
            for g in [n for n in op.output_arg_names if n in param_grads]:
                if block._find_var_recursive(g) is None:
                    continue
                # averaging rides on the collective (pre_scale), so the
                # program is exact whether the ring exchanges or not
                new_ops.append(Operator(
                    block, "c_allreduce_sum", {"X": [g]}, {"Out": [g]},
                    {"ring_id": 0, "pre_scale": 1.0 / self.nranks,
                     "op_role": OP_ROLE_BACKWARD},
                ))
        block.ops = new_ops
        self.main_program._bump_version()


class LocalSGD(Collective):
    """Periodic model averaging (reference collective.py:263): snapshot
    params, train locally, allreduce param deltas."""

    def _transpile_main_program(self):
        if self.nranks <= 1:
            return
        block = self.main_program.global_block()
        for p in self.main_program.all_parameters():
            snap_name = p.name + "@SNAPSHOT"
            block.create_var(name=snap_name, shape=p.shape, dtype=p.dtype,
                             persistable=True)
            sb = self.startup_program.global_block()
            sb.create_var(name=snap_name, shape=p.shape, dtype=p.dtype,
                          persistable=True)
            sb.append_op(
                type="assign", inputs={"X": [p.name]},
                outputs={"Out": [snap_name]},
            )
            # delta = snapshot - param ; allreduce ; param = snapshot - delta/n
            delta = p.name + "@DELTA"
            block.create_var(name=delta, shape=p.shape, dtype=p.dtype)
            block.append_op(
                type="elementwise_sub",
                inputs={"X": [snap_name], "Y": [p.name]},
                outputs={"Out": [delta]},
            )
            block.append_op(
                type="c_allreduce_sum", inputs={"X": [delta]},
                outputs={"Out": [delta]},
                attrs={"ring_id": 0, "pre_scale": 1.0 / self.nranks},
            )
            block.append_op(
                type="elementwise_sub",
                inputs={"X": [snap_name], "Y": [delta]},
                outputs={"Out": [p.name]},
            )
            block.append_op(
                type="assign", inputs={"X": [p.name]},
                outputs={"Out": [snap_name]},
            )
        self.main_program._bump_version()


class GeoSGD(Collective):
    """Geo-SGD (reference ``distribute_transpiler.py:131`` geo fields +
    the async geo ``Communicator`` mode): each worker trains locally and
    only every ``need_push_nums`` steps the parameter *deltas* since the
    last sync are averaged across workers.

    As the reference redesigned it: the pserver delta push/pull becomes
    a gated delta-allreduce appended after the optimizer — a persistable
    step counter drives a 0/1 gate, so off-sync steps keep their local
    parameters (the allreduce runs every step; the gate multiplies its
    result away off-sync, so the program has no host branch)."""

    def __init__(self, need_push_nums=100, nrings=1):
        super().__init__(nrings)
        self.need_push_nums = int(need_push_nums)

    def _transpile_main_program(self):
        if self.nranks <= 1:
            return
        block = self.main_program.global_block()
        sb = self.startup_program.global_block()

        step = "geo_sgd@STEP"
        block.create_var(name=step, shape=[1], dtype="float32",
                         persistable=True)
        sb.create_var(name=step, shape=[1], dtype="float32",
                      persistable=True)
        sb.append_op(
            type="fill_constant", outputs={"Out": [step]},
            attrs={"shape": [1], "dtype": "float32", "value": 0.0},
        )
        block.append_op(
            type="increment", inputs={"X": [step]}, outputs={"Out": [step]},
            attrs={"step": 1.0},
        )
        k = "geo_sgd@K"
        block.create_var(name=k, shape=[1], dtype="float32")
        block.append_op(
            type="fill_constant", outputs={"Out": [k]},
            attrs={"shape": [1], "dtype": "float32",
                   "value": float(self.need_push_nums)},
        )
        modv = "geo_sgd@MOD"
        block.create_var(name=modv, shape=[1], dtype="float32")
        block.append_op(
            type="elementwise_mod", inputs={"X": [step], "Y": [k]},
            outputs={"Out": [modv]},
        )
        zero = "geo_sgd@ZERO"
        block.create_var(name=zero, shape=[1], dtype="float32")
        block.append_op(
            type="fill_constant", outputs={"Out": [zero]},
            attrs={"shape": [1], "dtype": "float32", "value": 0.0},
        )
        gate_b = "geo_sgd@GATE_B"
        block.create_var(name=gate_b, shape=[1], dtype="bool")
        block.append_op(
            type="equal", inputs={"X": [modv], "Y": [zero]},
            outputs={"Out": [gate_b]},
        )
        gate = "geo_sgd@GATE"
        block.create_var(name=gate, shape=[1], dtype="float32")
        block.append_op(
            type="cast", inputs={"X": [gate_b]}, outputs={"Out": [gate]},
            attrs={"in_dtype": "bool", "out_dtype": "float32"},
        )
        # reset the counter on sync (step *= 1-gate): it never exceeds k,
        # so float32 increment can't saturate on billion-step runs
        notg = "geo_sgd@NOTGATE"
        block.create_var(name=notg, shape=[1], dtype="float32")
        block.append_op(
            type="scale", inputs={"X": [gate]}, outputs={"Out": [notg]},
            attrs={"scale": -1.0, "bias": 1.0},
        )
        block.append_op(
            type="elementwise_mul", inputs={"X": [step], "Y": [notg]},
            outputs={"Out": [step]},
        )

        for p in self.main_program.all_parameters():
            snap = p.name + "@GEO_SNAPSHOT"
            block.create_var(name=snap, shape=p.shape, dtype=p.dtype,
                             persistable=True)
            sb.create_var(name=snap, shape=p.shape, dtype=p.dtype,
                          persistable=True)
            sb.append_op(
                type="assign", inputs={"X": [p.name]},
                outputs={"Out": [snap]},
            )

            def tmp(suffix):
                n = p.name + suffix
                block.create_var(name=n, shape=p.shape, dtype=p.dtype)
                return n

            delta = tmp("@GEO_DELTA")
            block.append_op(
                type="elementwise_sub", inputs={"X": [snap], "Y": [p.name]},
                outputs={"Out": [delta]},
            )
            block.append_op(
                type="c_allreduce_sum", inputs={"X": [delta]},
                outputs={"Out": [delta]},
                attrs={"ring_id": 0, "pre_scale": 1.0 / self.nranks},
            )
            synced = tmp("@GEO_SYNCED")
            block.append_op(
                type="elementwise_sub", inputs={"X": [snap], "Y": [delta]},
                outputs={"Out": [synced]},
            )
            # param = param + gate * (synced - param)
            diff = tmp("@GEO_DIFF")
            block.append_op(
                type="elementwise_sub",
                inputs={"X": [synced], "Y": [p.name]},
                outputs={"Out": [diff]},
            )
            block.append_op(
                type="elementwise_mul", inputs={"X": [diff], "Y": [gate]},
                outputs={"Out": [diff]},
            )
            block.append_op(
                type="elementwise_add",
                inputs={"X": [p.name], "Y": [diff]},
                outputs={"Out": [p.name]},
            )
            # snapshot = snapshot + gate * (param - snapshot)
            sdiff = tmp("@GEO_SDIFF")
            block.append_op(
                type="elementwise_sub",
                inputs={"X": [p.name], "Y": [snap]},
                outputs={"Out": [sdiff]},
            )
            block.append_op(
                type="elementwise_mul", inputs={"X": [sdiff], "Y": [gate]},
                outputs={"Out": [sdiff]},
            )
            block.append_op(
                type="elementwise_add", inputs={"X": [snap], "Y": [sdiff]},
                outputs={"Out": [snap]},
            )
        self.main_program._bump_version()


class AsyncSGD(Collective):
    """Async-SGD (the reference's ``sync_mode=False`` parameter-server
    mode: ``communicator.h:160-179`` send/recv threads push gradients and
    pull parameters without barriers, so every update lands with roughly
    one step of staleness relative to the gradients of the other
    trainers).

    As the reference redesigned it — staleness-1 delayed gradient
    exchange.  A persistable buffer per gradient holds the *previous*
    step's local gradient.  At the top of the step the buffers are
    allreduce-averaged; this collective only carries last step's data,
    so it has no data dependency on the current forward/backward.  The
    optimizer consumes the stale average while the fresh local gradient
    replaces the buffer.

    Optional DC-ASGD delay compensation (``DistributeTranspilerConfig.
    enable_dc_asgd``; the reference wires this flag into its async
    pserver optimizer blocks): the applied gradient becomes
    ``g + lambda * g * g * (w - w_snapshot)`` where ``w_snapshot`` is the
    parameter value at the step the buffered gradient was produced —
    a first-order correction of the staleness (Zheng et al., 2017).

    With no group bound to the ring the allreduce is the identity and
    the program is exact delayed-gradient descent on the local batch;
    over a group it is the real exchange.
    """

    def __init__(self, dc_asgd=False, dc_lambda=0.04, nrings=1):
        super().__init__(nrings)
        self.dc_asgd = bool(dc_asgd)
        self.dc_lambda = float(dc_lambda)

    def _transpile_main_program(self):
        if self.nranks <= 1:
            # single trainer: nothing to overlap — the reference's
            # one-trainer async run is effectively synchronous, and a
            # delayed-gradient rewrite would only hurt convergence
            return
        block = self.main_program.global_block()
        sb = self.startup_program.global_block()

        grad_of = {p.name + "@GRAD": p
                   for p in self.main_program.all_parameters()}

        # last producer index per param-grad (fan-in dedup guarantees the
        # optimizer reads the final write)
        last_prod = {}
        for i, op in enumerate(block.ops):
            for g in op.output_arg_names:
                if g in grad_of:
                    last_prod[g] = i
        if not last_prod:
            return

        head = []   # ops prepended before the whole block
        after = {}  # producer index -> ops appended right after it
        for g, p in grad_of.items():
            if g not in last_prod:
                continue
            gv = block._find_var_recursive(g)
            gshape = list(gv.shape) if gv is not None else list(p.shape)
            gdtype = gv.dtype if gv is not None else p.dtype

            buf = g + "@ASYNC_BUF"
            stale = g + "@ASYNC_STALE"
            block.create_var(name=buf, shape=gshape, dtype=gdtype,
                             persistable=True)
            block.create_var(name=stale, shape=gshape, dtype=gdtype)
            sb.create_var(name=buf, shape=gshape, dtype=gdtype,
                          persistable=True)
            sb.append_op(
                type="fill_constant", outputs={"Out": [buf]},
                attrs={"shape": gshape, "dtype": gdtype, "value": 0.0},
            )

            # the head collective ships LAST step's gradients: no data
            # dependency on this step's compute, so it can overlap
            head.append(Operator(
                block, "c_allreduce_sum", {"X": [buf]}, {"Out": [stale]},
                {"ring_id": 0, "pre_scale": 1.0 / max(self.nranks, 1),
                 "op_role": OP_ROLE_BACKWARD},
            ))
            if self.dc_asgd:
                snap = p.name + "@ASYNC_PSNAP"
                block.create_var(name=snap, shape=list(p.shape),
                                 dtype=p.dtype, persistable=True)
                sb.create_var(name=snap, shape=list(p.shape),
                              dtype=p.dtype, persistable=True)
                sb.append_op(type="assign", inputs={"X": [p.name]},
                             outputs={"Out": [snap]})
                diff = g + "@ASYNC_DIFF"
                sq = g + "@ASYNC_SQ"
                block.create_var(name=diff, shape=gshape, dtype=gdtype)
                block.create_var(name=sq, shape=gshape, dtype=gdtype)
                head.append(Operator(
                    block, "elementwise_sub",
                    {"X": [p.name], "Y": [snap]}, {"Out": [diff]}, {}))
                head.append(Operator(
                    block, "elementwise_mul",
                    {"X": [stale], "Y": [stale]}, {"Out": [sq]}, {}))
                head.append(Operator(
                    block, "elementwise_mul",
                    {"X": [sq], "Y": [diff]}, {"Out": [sq]}, {}))
                head.append(Operator(
                    block, "scale", {"X": [sq]}, {"Out": [sq]},
                    {"scale": self.dc_lambda}))
                head.append(Operator(
                    block, "elementwise_add",
                    {"X": [stale], "Y": [sq]}, {"Out": [stale]}, {}))
                # snapshot w for the gradient being produced THIS step
                head.append(Operator(
                    block, "assign", {"X": [p.name]}, {"Out": [snap]}, {}))

            after.setdefault(last_prod[g], []).extend([
                Operator(block, "assign", {"X": [g]}, {"Out": [buf]},
                         {"op_role": OP_ROLE_BACKWARD}),
                Operator(block, "assign", {"X": [stale]}, {"Out": [g]},
                         {"op_role": OP_ROLE_BACKWARD}),
            ])

        new_ops = list(head)
        for i, op in enumerate(block.ops):
            new_ops.append(op)
            new_ops.extend(after.get(i, ()))
        block.ops = new_ops
        self.main_program._bump_version()


ASYNC_TOY_W0 = (1.0, -2.0, 3.0, 0.5)


def build_toy_async_program(dc_asgd=False, nranks=2, lr=0.1):
    """The 4-weight SGD toy used by every AsyncSGD oracle (tests +
    dryrun): loss = mean((w - x)^2), so d/dw = (w - x)/2.  Returns
    ``(main, startup, loss, w0)`` with the async transpile applied."""
    import numpy as np

    import paddle_tpu_torch as fluid

    fluid.unique_name.switch()
    main, startup = fluid.Program(), fluid.Program()
    w0 = np.array(ASYNC_TOY_W0, "float32")
    with fluid.program_guard(main, startup):
        w = fluid.layers.create_parameter(
            [4], "float32", name="w",
            default_initializer=fluid.initializer.NumpyArrayInitializer(w0))
        x = fluid.layers.data(name="x", shape=[4], append_batch_size=False)
        d = fluid.layers.elementwise_sub(w, x)
        loss = fluid.layers.reduce_mean(fluid.layers.elementwise_mul(d, d))
        fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    AsyncSGD(dc_asgd=dc_asgd).transpile(
        program=main, startup_program=startup, rank=0, nranks=nranks)
    return main, startup, loss, w0
