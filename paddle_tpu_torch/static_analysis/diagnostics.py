"""Structured diagnostics for the program verifier (mirrors
``paddle_tpu/static_analysis/diagnostics.py``, all of it).

The reference surfaces graph-level violations as ``PADDLE_ENFORCE`` aborts
deep inside C++ (``paddle/fluid/framework/operator.cc``, ``ir/graph.cc``)
with a stack but no graph coordinates.  Here every finding is a structured
:class:`Diagnostic` — check id, severity, block/op coordinates, the vars
involved and a fix hint — so callers (tests, the Analyzer's verify_pass,
the lint CLI) can filter, format and gate on them uniformly.
"""

import enum

__all__ = ["Severity", "Diagnostic", "format_diagnostics"]


class Severity(enum.IntEnum):
    """Ordered: gating compares with ``>=`` (e.g. fail on ERROR only)."""

    INFO = 1
    WARNING = 2
    ERROR = 3

    def __str__(self):
        return self.name


class Diagnostic:
    """One finding: where in the Program, what rule, how bad, how to fix.

    Fields
    ------
    check:     registered check id (e.g. ``"use-before-def"``)
    severity:  :class:`Severity`
    message:   human-readable statement of the violation
    block_idx: block the finding anchors to (None for program-level)
    op_idx:    position of the op in its block (None for var-level)
    op_type:   op type string, if anchored to an op
    op_id:     the op's ``__op_id__`` attr (stable across clones), if any
    var_names: tuple of var names involved
    hint:      suggested fix, may be empty
    """

    __slots__ = ("check", "severity", "message", "block_idx", "op_idx",
                 "op_type", "op_id", "var_names", "hint")

    def __init__(self, check, severity, message, block_idx=None, op_idx=None,
                 op_type=None, op_id=None, var_names=(), hint=""):
        self.check = check
        self.severity = Severity(severity)
        self.message = message
        self.block_idx = block_idx
        self.op_idx = op_idx
        self.op_type = op_type
        self.op_id = op_id
        self.var_names = tuple(var_names)
        self.hint = hint

    def _loc(self):
        parts = []
        if self.block_idx is not None:
            parts.append("block %d" % self.block_idx)
        if self.op_idx is not None:
            parts.append("op %d" % self.op_idx)
        if self.op_type:
            parts.append("(%s)" % self.op_type)
        return " ".join(parts)

    def to_dict(self):
        """JSON-ready form (the lint CLI's ``--json`` output)."""
        return {
            "check": self.check,
            "severity": str(self.severity),
            "message": self.message,
            "block_idx": self.block_idx,
            "op_idx": self.op_idx,
            "op_type": self.op_type,
            "op_id": self.op_id,
            "var_names": list(self.var_names),
            "hint": self.hint,
        }

    def __str__(self):
        loc = self._loc()
        s = "[%s] %s: %s" % (self.severity, self.check, self.message)
        if loc:
            s += " @ " + loc
        if self.hint:
            s += "\n    hint: " + self.hint
        return s

    __repr__ = __str__


def format_diagnostics(diags, header=None):
    """Multi-line report, most severe first (stable within a severity)."""
    lines = []
    if header:
        lines.append(header)
    for d in sorted(diags, key=lambda d: -int(d.severity)):
        lines.append(str(d))
    return "\n".join(lines)
