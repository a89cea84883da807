"""The verifier's check registry (mirrors
``paddle_tpu/static_analysis/checks.py:1-240``: ``register_check``,
``get_check``, ``all_checks``, ``VerifyContext``).

Each check is a generator ``fn(ctx) -> Iterable[Diagnostic]`` registered
under a stable id, the ``analysis.register_pass`` idiom.  The port
registers the four concurrency checks (:mod:`.concurrency`); the
reference's structural battery (use-before-def, double-write,
shape-dtype-drift and the rest, 25 checks over the abstract interpreter
and the cost model) is not ported yet (ROADMAP.md, Queue A item 3), so
:func:`.verifier.verify_program` refuses to run rather than pass
programs the reference would reject.
"""

from .diagnostics import Diagnostic

__all__ = ["register_check", "get_check", "all_checks", "VerifyContext"]

_CHECKS = {}


def register_check(check_id):
    """Register ``fn(ctx) -> Iterable[Diagnostic]`` under ``check_id``
    (later registration replaces earlier, so a project can override a
    built-in)."""

    def deco(fn):
        _CHECKS[check_id] = fn
        return fn

    return deco


def get_check(check_id):
    return _CHECKS[check_id]


def all_checks():
    """Ordered {id: fn} of registered checks."""
    return dict(_CHECKS)


class VerifyContext:
    """What a check sees: the program, the def-use graph, the (optional)
    fetch targets, the (optional) per-worker program list for the
    cross-worker checks, the concurrency context (the in-flight depth the
    race checks assume, the programs sharing this one's scope, whether
    the zero-sync certificate check runs unconditionally) and a
    Diagnostic factory that fills in coordinates.  The reference's lazy
    ``interp``/``cost`` properties wait for the abstract interpreter and
    the cost model."""

    def __init__(self, program, graph, targets=None, workers=None,
                 analysis=None, worker_schedules=None,
                 max_in_flight=None, coresident=None,
                 certify_zero_sync=False):
        self.program = program
        self.graph = graph
        self.targets = tuple(targets or ())
        self.workers = list(workers) if workers else None
        self.worker_schedules = worker_schedules
        self._interp, self._cost = analysis or (None, None)
        self.max_in_flight = max_in_flight
        self.coresident = list(coresident) if coresident else None
        self.certify_zero_sync = bool(certify_zero_sync)

    def var(self, name, near_block=None):
        """Recursive var lookup starting at ``near_block`` (a block idx)."""
        b = (self.program.block(near_block) if near_block is not None
             else self.program.global_block())
        return b._find_var_recursive(name)

    def diag(self, check, severity, message, block_idx=None, op_idx=None,
             op=None, var_names=(), hint=""):
        return Diagnostic(
            check, severity, message,
            block_idx=block_idx, op_idx=op_idx,
            op_type=op.type if op is not None else None,
            op_id=op.attrs.get("__op_id__") if op is not None else None,
            var_names=var_names, hint=hint,
        )
