"""Program analysis (mirrors ``paddle_tpu/static_analysis/``): the
def-use graph (:mod:`.defuse`), structured diagnostics
(:mod:`.diagnostics`), the verifier's whole check battery
(:mod:`.checks`, :mod:`.verifier`: ``verify_program`` /
``assert_valid``, ``Program.lint()``, ``Executor.run(verify=True)``,
``analysis.verify_pass``), the abstract interpreter (:mod:`.interp`),
the cost model (:mod:`.cost`), the cross-worker collective schedule and
its deadlock-freedom proof (:mod:`.distributed`), ``Program.analyze()``
(:mod:`.analyze`), the concurrency proofs (:mod:`.concurrency`), the
overlap and hierarchy passes (:mod:`.overlap`, :mod:`.hierarchy`, run
by the fusion resolve after the families) and the fusion families
(:mod:`.fusion`, bracketed by the verifier when
``PADDLE_TPU_VERIFY_PASSES`` is on).  ``python -m
paddle_tpu_torch.tools.lint_program <model_dir>`` lints an export.
"""

from .diagnostics import Diagnostic, Severity, format_diagnostics
from .defuse import DefUseGraph, build_def_use, sub_block_reads_recursive
from .checks import VerifyContext, all_checks, get_check, register_check
from .verifier import (
    VerifyError,
    assert_valid,
    pass_verification_enabled,
    set_pass_verification,
    verify_program,
)
from .interp import (AbstractVal, InterpResult, Sharding,
                     interpret_program, register_transfer)
from .cost import (CostReport, OpCost, PlanPrice, collective_ici_bytes,
                   estimate_cost, hbm_budget, price_plan,
                   price_program, register_flops)
from .distributed import (CollectiveEvent, check_schedule_consistency,
                          extract_collective_schedule,
                          prove_deadlock_free)
from .concurrency import (CONCURRENCY_CHECK_IDS, RACE_CHECK_IDS,
                          ConcurrencyReport, ScopeFootprint,
                          SyncPoint, ZeroSyncCertificate,
                          analyze_concurrency, assert_no_new_races,
                          certify_zero_sync, find_inflight_races,
                          find_overlap_window_races,
                          prove_scope_isolation, race_signatures,
                          resolve_max_in_flight, scope_footprint,
                          strict_sync_enabled, verify_async_hot_path)
from .analyze import AnalysisReport, analyze_program
from . import fusion  # noqa: F401
from .fusion import (FusionConfig, FusionReport, apply_fusion_passes,
                     fusion_enabled, resolve_fused_program,
                     scan_fusible_patterns)
from .overlap import (OverlapDecision, OverlapReport,
                      apply_overlap_pass, overlap_enabled)

__all__ = [
    "Diagnostic",
    "Severity",
    "format_diagnostics",
    "DefUseGraph",
    "build_def_use",
    "sub_block_reads_recursive",
    "VerifyContext",
    "all_checks",
    "get_check",
    "register_check",
    "VerifyError",
    "assert_valid",
    "pass_verification_enabled",
    "set_pass_verification",
    "verify_program",
    "AbstractVal",
    "InterpResult",
    "Sharding",
    "interpret_program",
    "register_transfer",
    "CostReport",
    "OpCost",
    "PlanPrice",
    "collective_ici_bytes",
    "estimate_cost",
    "hbm_budget",
    "price_plan",
    "price_program",
    "register_flops",
    "CollectiveEvent",
    "check_schedule_consistency",
    "extract_collective_schedule",
    "prove_deadlock_free",
    "CONCURRENCY_CHECK_IDS",
    "RACE_CHECK_IDS",
    "ConcurrencyReport",
    "ScopeFootprint",
    "SyncPoint",
    "ZeroSyncCertificate",
    "analyze_concurrency",
    "assert_no_new_races",
    "certify_zero_sync",
    "find_inflight_races",
    "find_overlap_window_races",
    "prove_scope_isolation",
    "race_signatures",
    "resolve_max_in_flight",
    "scope_footprint",
    "strict_sync_enabled",
    "verify_async_hot_path",
    "AnalysisReport",
    "analyze_program",
    "FusionConfig",
    "FusionReport",
    "apply_fusion_passes",
    "fusion_enabled",
    "resolve_fused_program",
    "scan_fusible_patterns",
    "OverlapDecision",
    "OverlapReport",
    "apply_overlap_pass",
    "overlap_enabled",
]
