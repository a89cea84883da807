"""Collective transpilers (mirrors ``paddle_tpu/transpiler/collective.py``
:17-130: ``ensure_comm_ring``, ``Collective``, ``GradAllReduce``).

``GradAllReduce`` inserts a ``c_allreduce_sum`` (``pre_scale`` 1/nranks)
after the backward op that produces each parameter gradient the
optimizer consumes, and the startup program gets one
``c_gen_nccl_id`` → ``c_comm_init`` pair per ring.  Run by one process
per rank, the ops exchange over the process group ``c_comm_init`` binds
(``ops/collective.py``); the fusion pipeline buckets them into
``c_fused_allreduce_sum`` or ``c_allreduce_quant``
(``static_analysis/fusion.py``).  LocalSGD, GeoSGD and AsyncSGD are not
ported (ROADMAP.md, Queue A item 7).
"""

from ..framework import (Operator, default_main_program,
                         default_startup_program)

__all__ = ["GradAllReduce", "Collective", "ensure_comm_ring"]

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
