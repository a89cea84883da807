"""Program analysis (mirrors ``paddle_tpu/static_analysis/``).  Ported so
far: the forward fusion families of the serving path (:mod:`.fusion`) and
the two def/use helpers the passes call.  The verifier, cost model,
concurrency proofs and the other fusion families are queued in
ROADMAP.md."""

from . import fusion  # noqa: F401
