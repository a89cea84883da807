"""Program analysis (mirrors ``paddle_tpu/static_analysis/``).  Ported
so far: the def-use graph (:mod:`.defuse`), structured diagnostics
(:mod:`.diagnostics`), the check registry (:mod:`.checks`), the
verifier's entry points (:mod:`.verifier`, whose battery raises until
it is ported), the concurrency proofs — in-flight races, scope
isolation, the zero-sync certificate — (:mod:`.concurrency`) and the
forward fusion families of the serving path (:mod:`.fusion`).  The
verifier's check battery, the abstract interpreter, the cost model, the
distributed schedule and the other fusion families are queued in
ROADMAP.md (Queue A item 3)."""

from . import fusion  # noqa: F401
from .checks import VerifyContext, all_checks, get_check, register_check
from .concurrency import (CONCURRENCY_CHECK_IDS, RACE_CHECK_IDS,
                          ConcurrencyReport, ScopeFootprint,
                          SyncPoint, ZeroSyncCertificate,
                          analyze_concurrency, assert_no_new_races,
                          certify_zero_sync, find_inflight_races,
                          find_overlap_window_races,
                          prove_scope_isolation, race_signatures,
                          resolve_max_in_flight, scope_footprint,
                          strict_sync_enabled, verify_async_hot_path)
from .defuse import DefUseGraph, build_def_use, sub_block_reads_recursive
from .diagnostics import Diagnostic, Severity, format_diagnostics
from .verifier import (VerifyError, assert_valid,
                       pass_verification_enabled, set_pass_verification,
                       verify_program)

__all__ = [
    "Diagnostic", "Severity", "format_diagnostics",
    "DefUseGraph", "build_def_use", "sub_block_reads_recursive",
    "VerifyContext", "all_checks", "get_check", "register_check",
    "VerifyError", "assert_valid", "pass_verification_enabled",
    "set_pass_verification", "verify_program",
    "CONCURRENCY_CHECK_IDS", "RACE_CHECK_IDS", "ConcurrencyReport",
    "ScopeFootprint", "SyncPoint", "ZeroSyncCertificate",
    "analyze_concurrency", "assert_no_new_races", "certify_zero_sync",
    "find_inflight_races", "find_overlap_window_races",
    "prove_scope_isolation", "race_signatures", "resolve_max_in_flight",
    "scope_footprint", "strict_sync_enabled", "verify_async_hot_path",
]
