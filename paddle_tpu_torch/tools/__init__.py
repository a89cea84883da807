"""Runnable tool modules (``python -m paddle_tpu_torch.tools.<name>``,
mirrors ``paddle_tpu/tools/``).  Ported so far: :mod:`.serve`; the
reference's trace and monitor CLIs are queued in ROADMAP.md (Queue A
item 3)."""
