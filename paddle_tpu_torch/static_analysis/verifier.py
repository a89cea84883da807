"""Program verifier entry points (mirrors
``paddle_tpu/static_analysis/verifier.py``: ``VerifyError`` :30, the
pass-verification flag :134-154).

``verify_program`` and ``assert_valid`` run the reference's whole check
battery, which needs the abstract interpreter and the cost model; the
port raises ``NotImplementedError`` for them until that battery is
ported (ROADMAP.md, Queue A item 3): a partial battery would pass
programs the reference rejects.  The concurrency gates
(:mod:`.concurrency`) raise :class:`VerifyError` as the reference does.
"""

import os

__all__ = ["verify_program", "assert_valid", "VerifyError",
           "pass_verification_enabled", "set_pass_verification"]


class VerifyError(RuntimeError):
    """Raised when a program fails verification; carries the structured
    diagnostics (``.diagnostics``) in addition to the formatted text."""

    def __init__(self, message, diagnostics=()):
        super().__init__(message)
        self.diagnostics = list(diagnostics)


_BATTERY = ("the verifier's check battery (use-before-def, double-write, "
            "shape-dtype-drift and the rest over the abstract interpreter "
            "and the cost model) is not ported yet (ROADMAP.md, Queue A "
            "item 3: the verifier battery)")


def verify_program(program, targets=None, checks=None, exclude=(),
                   workers=None, max_in_flight=None, coresident=None,
                   certify_zero_sync=False, _analysis=None,
                   _worker_schedules=None):
    raise NotImplementedError("verify_program: " + _BATTERY)


def assert_valid(program, targets=None, min_severity=None, header=None,
                 **kw):
    raise NotImplementedError("assert_valid: " + _BATTERY)


_PASS_VERIFY_OVERRIDE = None  # None → env var decides


def pass_verification_enabled():
    """Should Analyzer wrap each rewrite pass with verification?
    ``PADDLE_TPU_VERIFY_PASSES=1`` or :func:`set_pass_verification`."""
    if _PASS_VERIFY_OVERRIDE is not None:
        return _PASS_VERIFY_OVERRIDE
    val = os.environ.get("PADDLE_TPU_VERIFY_PASSES", "0")
    return val.strip().lower() not in ("0", "", "false", "off")


def set_pass_verification(flag):
    """Force pass verification on/off (None → defer to the env var
    again).  Returns the previous override."""
    global _PASS_VERIFY_OVERRIDE
    old = _PASS_VERIFY_OVERRIDE
    _PASS_VERIFY_OVERRIDE = flag
    return old
