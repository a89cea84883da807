"""``python -m paddle_tpu_torch.tools.chaos --quant``, the
quantized-collective drill, against the reference's
(``paddle_tpu/tools/chaos.py``:890-1029).

Both drills start from the reference's initial weights (drawn here with
``jax.random`` as the reference draws them, then handed to the port's
drill through ``--init-weights`` / ``weights=``) and train on the same
seeded batches on the CPU, so their per-step figures can be compared.
The reference prints them (``CHAOS_QUANT_STEP`` lines, 8 decimals for
the losses, 4 significant digits for the errors); the tolerances are
those print precisions with float32 headroom:

- ``LOSS_ATOL`` 1e-6: each step's dense and quant loss;
- ``ERR_RTOL`` 2e-3: each step's measured and modelled RMS error.

The exit code is the reference's and the ``quant_error`` gauge the
drill feeds reads back through ``tools.monitor``.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest

LOSS_ATOL = 1e-6
ERR_RTOL = 2e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def reference():
    """The reference drill's steps, exit code, final gauge and initial
    weights."""
    import jax

    from paddle_tpu.observability import drift as jdrift
    from paddle_tpu.tools import chaos as jchaos

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = jchaos.main(["--quant", "--steps", "6"])
    steps = []
    for line in buf.getvalue().splitlines():
        if line.startswith("CHAOS_QUANT_STEP"):
            vals = dict(kv.split("=") for kv in line.split()[2:])
            steps.append({k: float(v) for k, v in vals.items()})
    from paddle_tpu.observability import metrics as jmetrics

    gauge = jmetrics.gauge("quant_error", bucket="grads").value
    jdrift.reset_drift()
    k1, k2 = jax.random.split(jax.random.PRNGKey(jchaos._MODEL_SEED))
    weights = {
        "w1": np.asarray(jax.random.normal(
            k1, (jchaos._FEATS, jchaos._HIDDEN)) * 0.5, np.float32),
        "b1": np.zeros((jchaos._HIDDEN,), np.float32),
        "w2": np.asarray(jax.random.normal(
            k2, (jchaos._HIDDEN, 1)) * 0.5, np.float32),
        "b2": np.zeros((1,), np.float32),
    }
    return code, steps, gauge, weights


def test_drill_matches_the_reference_step_for_step(reference):
    from paddle_tpu_torch.observability import metrics as tmetrics
    from paddle_tpu_torch.tools import chaos

    code, steps, gauge, weights = reference
    got_code, rec = chaos.run_quant_drill(
        steps=6, device="cpu", weights=weights, echo=lambda s: None)
    assert got_code == code == 0
    assert len(rec["losses_dense"]) == len(steps) == 6
    for s, ref in enumerate(steps):
        assert abs(rec["losses_dense"][s] - ref["loss_dense"]) <= LOSS_ATOL
        assert abs(rec["losses_quant"][s] - ref["loss_quant"]) <= LOSS_ATOL
        assert abs(rec["measured_rms"][s] - ref["quant_rms"]) \
            <= ERR_RTOL * ref["quant_rms"], (s, rec, ref)
        assert abs(rec["predicted_rms"][s] - ref["model_rms"]) \
            <= ERR_RTOL * ref["model_rms"], (s, rec, ref)
    got_gauge = tmetrics.gauge("quant_error", bucket="grads").value
    assert got_gauge == rec["measured_rms"][-1]
    assert abs(got_gauge - gauge) <= ERR_RTOL * gauge


def test_cli_exit_code_and_monitor_gauge(reference, tmp_path):
    """The CLI on the CPU with the reference's weights exits 0, prints
    the reference's step lines, and ``tools.monitor`` reads
    ``quant_error`` / ``quant_error_ratio`` from the snapshot it
    wrote; ``--elastic`` and a drill without ``--quant`` raise."""
    from paddle_tpu_torch.tools import monitor

    _, steps, _, weights = reference
    np.savez(tmp_path / "w.npz", **weights)
    tel = tmp_path / "tel"
    res = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.chaos", "--quant",
         "--cpu", "--steps", "6", "--init-weights", str(tmp_path / "w.npz"),
         "--telemetry-dir", str(tel)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=120)
    assert res.returncode == 0, res.stdout
    lines = [ln for ln in res.stdout.splitlines()
             if ln.startswith("CHAOS_QUANT_STEP")]
    assert len(lines) == len(steps)
    assert "chaos: PASS" in res.stdout
    status = monitor.collect_status(str(tel))
    assert status["quant_error"] is not None
    assert status["quant_error_ratio"] is not None
    from paddle_tpu_torch.tools import chaos

    for argv in (["--elastic"], ["--spec", "nan_grad@step=3"]):
        with pytest.raises(NotImplementedError, match="Queue A item 9"):
            chaos.main(argv)
