"""Chaos harness, the quantized-collective drill (mirrors the ``--quant``
mode of ``paddle_tpu/tools/chaos.py``:890-1029, its flags and exit
codes).

Usage::

    python -m paddle_tpu_torch.tools.chaos --quant [--steps 6]
        [--tolerance 0.02] [--cpu] [--telemetry-dir DIR]
        [--init-weights W.npz]

Twin same-seed data-parallel training runs of a small regression MLP
(4 → 8 → 1, relu, mean squared error, plain SGD at lr 0.05): the
control reduces the two ranks' gradients densely, the quant twin pushes
the flat gradient bucket through the int8 block-quantized reduction of
``c_allreduce_quant`` for a 2-rank ring (quantize each rank's share →
dequantize and sum in rank order → requantize → dequantize), on the K7
kernels when the drill runs on the card (the default; ``--cpu`` runs
their plain versions on the CPU).  Every step the measured error of the
reduction against the dense sum is checked against the blockwise error
model and fed to the ``quant_error`` drift gauge (``observability.
drift.observe_quant_error``), which ``tools.monitor`` reads as
``quant_error`` / ``quant_error_ratio`` from the metrics snapshot the
drill writes into ``--telemetry-dir`` (or ``PADDLE_TPU_TELEMETRY_DIR``).

Exit status: 0 when the twins' loss curves stay within ``--tolerance``
relative error, both converge and the error stays within 3x the model;
1 otherwise; 2 when the card is asked for and absent.

The reference draws the initial weights from ``jax.random``; here they
come from ``numpy.random.RandomState(77)`` (the same scales), or from
``--init-weights`` (an ``.npz`` with ``w1``, ``b1``, ``w2``, ``b2``),
which is how a comparison hands both drills the same start.  The
flattening order is the reference's (``ravel_pytree`` of the dict:
sorted names).

The reference's worker, oracle and ``--elastic`` modes need the
resilience package's supervisor, faults and elastic membership, which
are not ported (ROADMAP.md, Queue A item 9): they raise.
"""

import argparse
import os
import sys

_DATA_SEED = 1234
_MODEL_SEED = 77
_BATCH = 16
_FEATS = 4
_HIDDEN = 8
_LR = 0.05
_NAMES = ("b1", "b2", "w1", "w2")  # ravel_pytree's order: sorted keys


def _batches(steps):
    import numpy as np

    rng = np.random.RandomState(_DATA_SEED)
    out = []
    for _ in range(steps):
        xb = rng.randn(_BATCH, _FEATS).astype("float32")
        yb = (xb.sum(axis=1, keepdims=True)
              + 0.1 * rng.randn(_BATCH, 1)).astype("float32")
        out.append((xb, yb))
    return out


def init_weights(path=None):
    """The drill's initial weights as numpy arrays: from ``path`` (an
    ``.npz``) when given, else drawn from ``RandomState(77)``."""
    import numpy as np

    if path:
        with np.load(path) as z:
            return {k: np.asarray(z[k], np.float32) for k in _NAMES}
    rng = np.random.RandomState(_MODEL_SEED)
    return {
        "w1": (rng.randn(_FEATS, _HIDDEN) * 0.5).astype(np.float32),
        "b1": np.zeros((_HIDDEN,), np.float32),
        "w2": (rng.randn(_HIDDEN, 1) * 0.5).astype(np.float32),
        "b2": np.zeros((1,), np.float32),
    }


def _loss(params, xb, yb):
    import torch

    h = torch.relu(xb @ params["w1"] + params["b1"])
    p = h @ params["w2"] + params["b2"]
    return torch.mean((p - yb) ** 2)


def _value_and_grad(params, xb, yb):
    """(loss, flat gradient in ``_NAMES`` order)."""
    import torch

    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        lv = _loss(leaves, xb, yb)
        grads = torch.autograd.grad(lv, [leaves[k] for k in _NAMES])
    return lv.detach(), torch.cat([g.reshape(-1) for g in grads])


def _unravel(flat, like):
    out, off = {}, 0
    for k in _NAMES:
        n = like[k].numel()
        out[k] = flat[off:off + n].reshape(like[k].shape)
        off += n
    return out


def _ravel(params):
    import torch

    return torch.cat([params[k].reshape(-1) for k in _NAMES])


def quant_reduce(flats, kernel=True):
    """The 2-rank quantized reduction of ``quantized_allreduce`` on
    shards in hand: each rank's share quantized and dequantized, summed
    in rank order, the sum requantized and dequantized → (reduced,
    the error model's RMS, in quadrature over the three passes)."""
    import math

    from ..quant import block_dequantize, block_quantize, predicted_rms_error

    numel = int(flats[0].numel())
    parts, preds = [], []
    for f in flats:
        q, s = block_quantize(f, kernel=kernel)
        parts.append(block_dequantize(q, s, size=numel, kernel=kernel))
        preds.append(float(predicted_rms_error(s)))
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    q_r, s_r = block_quantize(acc, kernel=kernel)
    out = block_dequantize(q_r, s_r, size=numel, kernel=kernel)
    preds.append(float(predicted_rms_error(s_r)))
    return out, math.sqrt(sum(p * p for p in preds))


def run_quant_drill(steps=6, tolerance=0.02, device="cuda",
                    weights=None, telemetry_dir=None, echo=print):
    """The drill → ``(exit code, record)``; the record holds the
    per-step losses and errors and the verdict's numbers."""
    import numpy as np
    import torch

    from ..observability import metrics as _metrics
    from ..observability.drift import monitor, reset_drift
    from ..quant import quant_block

    dev = torch.device(device)
    steps = max(int(steps), 6)
    echo("chaos: quant A/B drill — %d steps, block=%d, tolerance=%g, "
         "device=%s" % (steps, quant_block(), tolerance, dev))
    w0 = weights if weights is not None else init_weights()
    reset_drift()
    mon = monitor()
    params_c = {k: torch.tensor(np.asarray(w0[k], np.float32),
                                device=dev) for k in _NAMES}
    params_q = {k: v.clone() for k, v in params_c.items()}
    half_t = torch.tensor(0.5, dtype=torch.float32, device=dev)
    lr = torch.tensor(_LR, dtype=torch.float32, device=dev)
    rec = {"losses_dense": [], "losses_quant": [], "measured_rms": [],
           "predicted_rms": []}
    worst_rel, worst_ratio = 0.0, 0.0
    for k, (xb, yb) in enumerate(_batches(steps)):
        xb = torch.as_tensor(xb, device=dev)
        yb = torch.as_tensor(yb, device=dev)
        half = _BATCH // 2
        shards = [(xb[:half], yb[:half]), (xb[half:], yb[half:])]

        # control twin: the dense mean of the two ranks' gradients
        lv_c = _value_and_grad(params_c, xb, yb)[0]
        flats_c = [_value_and_grad(params_c, xs, ys)[1] * half_t
                   for xs, ys in shards]
        dense_c = flats_c[0] + flats_c[1]
        params_c = _unravel(_ravel(params_c) - lr * dense_c, params_c)

        # quant twin: the same shards through the int8 reduction; the
        # dense sum of its own gradients is the step's error reference
        lv_q = _value_and_grad(params_q, xb, yb)[0]
        flats_q = [_value_and_grad(params_q, xs, ys)[1] * half_t
                   for xs, ys in shards]
        dense_q = flats_q[0] + flats_q[1]
        reduced, predicted = quant_reduce(flats_q,
                                          kernel=dev.type == "cuda")
        measured = float(torch.sqrt(torch.mean((reduced - dense_q) ** 2)))
        mon.observe_quant_error(measured, predicted=predicted,
                                bucket="grads")
        if predicted > 0:
            worst_ratio = max(worst_ratio, measured / predicted)
        params_q = _unravel(_ravel(params_q) - lr * reduced, params_q)

        lc, lq = float(lv_c), float(lv_q)
        rel = abs(lq - lc) / max(abs(lc), 1e-8)
        worst_rel = max(worst_rel, rel)
        rec["losses_dense"].append(lc)
        rec["losses_quant"].append(lq)
        rec["measured_rms"].append(measured)
        rec["predicted_rms"].append(predicted)
        echo("CHAOS_QUANT_STEP %d loss_dense=%.8f loss_quant=%.8f "
             "rel=%.2e quant_rms=%.3e model_rms=%.3e"
             % (k, lc, lq, rel, measured, predicted))

    if dev.type == "cuda":
        from ..ops.cuda import launch_counts

        counts = launch_counts()
        rec["k7_launches"] = [counts["block_quantize"],
                              counts["block_dequantize"]]
        echo("chaos: K7 launches quantize=%d dequantize=%d"
             % tuple(rec["k7_launches"]))
    losses_c, losses_q = rec["losses_dense"], rec["losses_quant"]
    converged_c = losses_c[-1] < losses_c[0]
    converged_q = losses_q[-1] < losses_q[0]
    # 3x headroom over the RMS model: per-step error is a random draw,
    # the model is its expectation
    model_ok = worst_ratio <= 3.0
    rec.update(worst_loss_rel=worst_rel, worst_error_vs_model=worst_ratio,
               converged_dense=converged_c, converged_quant=converged_q)
    echo("chaos: quant drill worst_loss_rel=%.2e worst_error_vs_model="
         "%.2fx converged dense=%s quant=%s"
         % (worst_rel, worst_ratio, converged_c, converged_q))
    telemetry_dir = telemetry_dir or os.environ.get(
        "PADDLE_TPU_TELEMETRY_DIR", "").strip() or None
    if telemetry_dir:
        from ..observability.exporters import write_metrics_snapshot

        write_metrics_snapshot(os.path.join(
            telemetry_dir, "metrics-r0-%d.json" % os.getpid()),
            _metrics.registry())
    if worst_rel > tolerance:
        echo("chaos: FAIL — quant twin loss diverged %.2e > tolerance %g"
             % (worst_rel, tolerance))
        return 1, rec
    if not (converged_c and converged_q):
        echo("chaos: FAIL — a twin failed to converge (dense %s, quant %s)"
             % (converged_c, converged_q))
        return 1, rec
    if not model_ok:
        echo("chaos: FAIL — measured quant error %.2fx the documented "
             "model (alert 'quant_error_ratio>2' would page)" % worst_ratio)
        return 1, rec
    echo("chaos: PASS — quantized twin matched the dense loss curve "
         "within %g and the error stayed inside the model" % tolerance)
    return 0, rec


_NOT_PORTED = ("the chaos %s needs the resilience supervisor, fault "
               "injector and elastic membership, which are not ported "
               "(ROADMAP.md, Queue A item 9); run --quant")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.chaos",
        description="Chaos drills; the quantized-collective A/B drill "
                    "(--quant) is ported.")
    parser.add_argument("--quant", action="store_true",
                        help="run the quantized-collective A/B drill: "
                             "same-seed twins (dense vs int8 "
                             "block-quantized gradient reduction) must "
                             "match loss curves within --tolerance")
    parser.add_argument("--steps", type=int, default=None,
                        help="training steps (at least 6)")
    parser.add_argument("--tolerance", type=float, default=0.02,
                        help="max relative loss error between the twins")
    parser.add_argument("--telemetry-dir", default=None,
                        help="directory for the metrics snapshot "
                             "(default PADDLE_TPU_TELEMETRY_DIR); read it "
                             "with python -m "
                             "paddle_tpu_torch.tools.monitor")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the K7 kernels' plain "
                             "versions) instead of the card")
    parser.add_argument("--init-weights", default=None,
                        help=".npz with w1, b1, w2, b2: the initial "
                             "weights instead of the seeded draw")
    parser.add_argument("--spec", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--elastic", action="store_true",
                        help="not ported (ROADMAP.md, Queue A item 9)")
    parser.add_argument("--worker", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--elastic-worker", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker or args.elastic_worker:
        raise NotImplementedError(_NOT_PORTED % "worker")
    if args.elastic:
        raise NotImplementedError(_NOT_PORTED % "--elastic drill")
    if not args.quant:
        raise NotImplementedError(_NOT_PORTED % "fault-recovery drill")
    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("chaos: no CUDA device; pass --cpu to run the drill on the "
              "CPU", file=sys.stderr)
        return 2
    code, _ = run_quant_drill(
        steps=args.steps if args.steps is not None else 9,
        tolerance=args.tolerance, device="cpu" if args.cpu else "cuda",
        weights=init_weights(args.init_weights),
        telemetry_dir=args.telemetry_dir,
        echo=lambda s: print(s, flush=True))
    return code


if __name__ == "__main__":
    sys.exit(main())
