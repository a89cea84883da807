"""Runnable tool modules (``python -m paddle_tpu_torch.tools.<name>``,
mirrors ``paddle_tpu/tools/``): :mod:`.serve`, :mod:`.lint_program`,
:mod:`.analyze_program` and their shared plumbing :mod:`.diag_cli`, and
the operator's two views of a telemetry directory, :mod:`.monitor` and
:mod:`.trace`.  The reference's chaos harness (``tools/chaos.py``) waits
for the resilience modules it drives (ROADMAP.md, Queue A item 9)."""
