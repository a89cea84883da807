#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a host with one NVIDIA H100 (sm_90a)
and the CUDA toolkit.  Phases, each printing one JSON line:

1. environment: the card's name and power limit (``nvidia-smi``), torch
   and CUDA versions;
2. build: ``nvcc`` builds the kernel library from ``paddle_tpu_torch/csrc``;
3. kernels: each hand-written kernel (flash attention forward, its dK/dV
   and dQ backward kernels, fused add+LN forward and backward, embedding
   gather, flash decode and paged flash decode) against its plain
   PyTorch version on the card, in float32 and bfloat16, at dropout 0
   and 0.1, at the main paths' shapes and at edge cases (ragged T, head
   dims 96 and 128, causal, fully masked rows; for the decode kernels
   lengths 0 to 1024 in one launch, head dim 128, shuffled block
   tables with -1 tails over a larger pool, block lengths 16 and 32),
   with the error beside its tolerance, and the kernels' dropout keep
   fractions against 1 - rate; then the kernel, the plain version and
   one PyTorch library call for the same function are timed with L2
   flushed before every call (the library call is a yardstick only; the
   port never calls it);
4. main path, serving: BERT-base (vocab 30522, hidden 768, 12 layers, 12
   heads, ffn 3072) at sequence length 512 with random weights from a
   seed is built with the port's layers, exported with
   ``save_inference_model``, loaded by ``AnalysisPredictor`` on the GPU
   and served through ``PredictorServer``; every result must be finite,
   match a direct ``predictor.run`` and (for one request) a CPU
   predictor on the plain versions; the launch counters must rise by
   12 / 25 / 3 per dispatched batch; latency and tokens/s are taken
   after the 8-row bucket is warm;
5. profile: on the same predictor, latency and host dispatch time per
   bucket, and for bucket 8 the device time by kernel group
   (``torch.profiler``) and the device's idle share;
6. main path, training: ``models/bert.build_pretrain`` (MLM head, Adam,
   dropout 0.1) for BERT-base at T=512 runs ``TRAIN_WARMUP`` + ``TRAIN_STEPS``
   steps of batch 8 on one repeated batch through ``Executor``; the loss
   must be finite and fall, and every step must launch exactly 12 flash
   forward, 12 dK/dV, 12 dQ, 25 LN forward, 25 LN backward and 3 gather
   kernels; step time, tokens/s, peak memory, the host's time to enqueue
   a step, and the device time by kernel group with the idle share (and
   the busiest host ops) over two profiled steps;
7. train parity: one dropout-0.1 step of a 2-layer BERT at BERT-base
   width (batch 2, T=512) on the card and on the CPU with the plain
   versions, from the same seeded start and with the same masks; the
   loss and three gradients must agree within the stated tolerances;
8. main path, decode: a GPT decoder at GPT-2-small widths (vocab 50257,
   hidden 768, 12 layers, 12 heads, ffn 3072, cache depth 1024; random
   weights from a seed) served as a ``DecodeEngine`` tenant of
   ``PredictorServer``, ring then paged: 8 slots, prompt buckets 128 and
   512, greedy, 64 new tokens for each of 16 requests of seeded prompt
   lengths 32-500, so admission happens mid-stream.  Every request must
   complete with tokens in the vocabulary, ring and paged must give the
   same tokens, and the counters must rise by 12 K5 (ring) or K6
   (paged), 24 K2 and 2 K3 per step and 12 K1, 24 K2 and 2 K3 per
   prefill; tokens/s, TTFT, latency, step time, peak memory, the host's
   time to enqueue a step and the device time per step by kernel group
   with the idle share;
9. decode parity: a 2-layer decoder at GPT-2-small width, prefill and 8
   greedy steps, ring and paged, on the card and on the CPU with the
   plain versions from one parameter dict; logits and greedy tokens must
   agree within the stated tolerance and margin;
10. main path, ResNet training: ``models/resnet.build(dataset="imagenet",
   depth=50, data_format="NHWC")`` (Momentum, lr 0.1, Nesterov) at batch
   64, 224x224, float32, ``RESNET_WARMUP`` + ``RESNET_STEPS`` steps on
   one repeated batch, then one eval batch through the for-test clone;
   every loss must be finite, every training step must launch exactly
   65 K4 forward and 65 K4 backward kernels (one per conv -> batch_norm
   site) and the eval batch 65 forward; step time, images/s, peak
   memory, the host's time to enqueue a step, and the device time by
   kernel group (conv fwd/bwd, K4 fwd/bwd, BN statistics, Momentum and
   elementwise, pooling, layout copies) with the idle share;
11. ResNet parity: full-depth ResNet-50 NHWC at 64x64, batch 4, one
   step on the card and on the CPU with the plain versions from one
   parameter dict: the loss, every gradient and the moving statistics
   within the stated tolerances, with the relu-mask flips counted at
   every relu site and the gradients above the first flipped site held
   tight;
12. quant: ``quantized_allreduce`` over a world-1 NCCL group on the card
   against its plain composite, bit for bit, with 2 quantize and 2
   dequantize launches per call;
13. main path, data parallel: BERT-base MLM pretraining (T=512, dropout
   0.1, Adam) in two rank processes on the one card, each with the
   ``GradAllReduce``-transpiled program and 4 rows of the training
   path's batch of 8, over a gloo group (NCCL refuses two ranks on one
   device, so payloads cross through pinned host memory); a dense twin
   (``c_fused_allreduce_sum`` buckets) and a quant twin
   (``c_allreduce_quant`` on every bucket) from the same seeds and
   feeds.  Fails unless every step launches 2 + 2 K7 kernels per bucket,
   the parameters are identical across the ranks after every step, the
   twins' worst loss delta is at most 1e-3, every bucket's measured RMS
   error is at most 3x the model, and a dropout-0 2-rank step matches
   one process on the 8 rows.

The kernels phase also checks K4 forward and backward (float32 and
bfloat16, identity and relu) at the ResNet-50 sites' shapes and a
ragged one, and times them at every site shape of batch 64; and K7
quantize and dequantize (to float32 and bfloat16), bit for bit, at the
32 MB bucket, odd B, an unaligned pointer, an odd tail and zero,
subnormal, NaN, inf and tie blocks, timed at the bucket and at
BERT-base's whole gradient.  Then one JSON line lists every ported
kernel with its launches on the decode path (or, for the backward
kernels, the BERT training run; for K4 the ResNet training run; for K7
the data-parallel run's quant twin, rank 0) and its times, a line gives ``nvidia-smi``'s name and power limit, and the last
line is ``{"ok": true, "device": {...}}``.  Any failed
phase exits non-zero before that line.  Without a CUDA device, or without
the repository beside it, the script exits 2 and prints no result.
"""

import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
L2_FLUSH_BYTES = 512 << 20   # ten times the H100's 50 MB L2
BF16_UNIT = 2.0 ** -7        # one bf16 unit in the last place, relative
SEED = 0
SEQ = 512
REQUEST_ROWS = (1, 2, 3, 1, 2, 3, 1, 2)
BUCKETS = (1, 2, 4, 8)
SERVE_ATOL = 1e-4     # served rows vs a direct run of the same rows (f32)
CPU_ATOL = 2e-3       # GPU kernels vs CPU plain versions, 12 layers (f32)
DROPOUT = 0.1         # BERT's hidden and attention dropout
DROP_SEED = 1234      # the kernels' dropout seed in the kernel checks
TRAIN_BATCH = 8
TRAIN_WARMUP = 2
TRAIN_STEPS = 5
TRAIN_LR = 1e-4
# one training step, GPU kernels vs CPU plain versions, float32 with TF32
# off: sums in another order through 2 layers, the vocab head and the
# atomics of the embedding scatter-add
PARITY_LOSS_RTOL = 1e-4
PARITY_GRAD_RTOL = 1e-3   # max |GPU - CPU| over max |CPU| per gradient
DECODE_TMAX = 1024        # GPT-2 small's n_ctx: the decode caches' depth
# one K5/K6 launch's lengths at the main shapes (8 sequences): empty,
# one row, ragged, and the full cache
DECODE_KERNEL_LENGTHS = (0, 1, 17, 500, 1024, 333, 64, 1000)
DECODE_SLOTS = 8
DECODE_BUCKETS = (128, 512)   # prompt buckets: K1 runs at both lengths
DECODE_NEW_TOKENS = 64
DECODE_REQUESTS = 16
DECODE_PROMPT_LENS = (32, 500)  # seeded prompt lengths, inclusive
DECODE_PROFILE_STEPS = 5
DECODE_PARITY_PROMPTS = (37, 200, 480)
DECODE_PARITY_STEPS = 8
# GPU kernels vs CPU plain versions through 2 layers and the 50257-wide
# head, float32 with TF32 off: sums in another order
DECODE_PARITY_RTOL = 1e-4
GREEDY_MARGIN = 1e-4   # tokens are compared where the top-2 gap exceeds it
# K4's checks: the stage-1 and stage-4 sites and the stem of ResNet-50 at
# batch 64 ([R = 64*H*W, C]), and a ragged shape
K4_SHAPES = ((64 * 56 * 56, 256), (64 * 7 * 7, 2048), (64 * 112 * 112, 64),
             (1000, 72))
K4_TIME_SHAPE = (64 * 56 * 56, 256)   # the kernels line's row
RESNET_BATCH = 64
RESNET_HW = 224
RESNET_WARMUP = 2
RESNET_STEPS = 7
# models/resnet.build's ResNet-50: 65 conv -> batch_norm sites (a
# projection shortcut in every bottleneck), each one fused op
RESNET_SITES = 65
# the distinct [R, C] of those sites at batch 64 (stem, stages 1-4)
RESNET_SITE_SHAPES = ((802816, 64), (200704, 64), (200704, 256),
                      (50176, 128), (50176, 512), (12544, 256),
                      (12544, 1024), (3136, 512), (3136, 2048))
RESNET_PARITY_HW = 64
RESNET_PARITY_BATCH = 4
# one Momentum step of ResNet-50 at 64x64: the card's K4 path against the
# same step with fusion off (the unfused batch_norm and relu ops, the
# same cuDNN convolutions): the forward is the same float sequence, so
# only the backward's sums differ
PARITY_RESNET_RTOL = 1e-4
# the card against the CPU: cuDNN's convolutions (implicit GEMM and FFT
# kernels) and oneDNN's round differently; through 50 layers the loss
# agrees to ~1e-6 but quantities of the deep forward (the fc weight's
# gradient, the moving statistics) to a few 1e-4 (max |diff| over max
# |CPU|)
PARITY_RESNET_CPU_RTOL = 1e-4        # the loss
PARITY_RESNET_CPU_FWD_RTOL = 1e-3    # fc gradient, moving statistics
# gradients below the relus: a relu input within rounding of 0 takes the
# gradient on one device and not on the other, and moves the gradients
# of the layers below it by a few percent (the same effect is found on
# the CPU against the reference, tests/test_torch_resnet.py); held as
# ||GPU - CPU|| / ||CPU||.  That explanation is checked: the relu masks
# of the two runs are compared at every relu site (each fused site's and
# each residual add's), every flipped unit must sit within
# PARITY_RESNET_FLIP_ATOL of 0 (over its site's largest output), and
# every gradient above the first flipped site (nearer the head, so no
# flipped relu on its backward path) is held to
# PARITY_RESNET_CPU_FWD_RTOL (max |diff| over max |CPU|), as the fc
# gradient always was; only those at or below it keep the L2 bound
PARITY_RESNET_CPU_DEEP_RTOL = 0.1
PARITY_RESNET_FLIP_ATOL = 1e-3
# one conv -> batch_norm site (identity act, so no relu decision) at the
# stage-1 shape [4, 56, 56, 64], the card against the CPU: the output and
# the input, filter, scale and bias gradients (max |diff| over max |CPU|)
PARITY_RESNET_SITE_RTOL = 1e-4
# K7: the 32 MB gradient bucket (8M float32 at B = 256) and BERT-base's
# whole gradient (~110M float32), at the default block
K7_BLOCK = 256
K7_BUCKET = (32768, K7_BLOCK)
K7_WHOLE = (429688, K7_BLOCK)
# data-parallel BERT-base pretraining: 2 ranks on the one card over a
# gloo group (NCCL refuses two ranks on one device), 4 rows each of the
# training path's batch of 8
DP_RANKS = 2
DP_STEPS = 3
DP_TIMEOUT = 600            # seconds for both ranks
DP_LOSS_GATE = 1e-3         # the reference's gate (bench.py:1950-1954)
DP_ERR_MODEL_GATE = 3.0     # measured over modelled RMS (chaos.py:1007)


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def card_label(env):
    return "%s (%s)" % (env["card"], env["nvidia_smi"])


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(fn, iters=20, warmup=3):
    """Mean device time of one cold call of ``fn()``: before each of
    ``iters`` calls (after ``warmup``) a write of L2_FLUSH_BYTES evicts
    the inputs from the 50 MB L2, and a pair of CUDA events brackets the
    call alone, so the time reads against the HBM bound."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b):
    """Max |a - b| over positions where neither is NaN; NaN positions
    must agree."""
    import torch

    a, b = a.float(), b.float()
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        return float("inf")
    keep = ~torch.isnan(a)
    if not bool(keep.any()):
        return 0.0
    return float((a[keep] - b[keep]).abs().max())


class Checks:
    """Collects kernel-vs-plain comparisons; fails at the end of the
    phase if any exceeded its tolerance."""

    def __init__(self):
        self.failed = []

    def check(self, kernel, case, err, tol):
        ok = err <= tol
        emit({"phase": "kernels", "kernel": kernel, "case": case,
              "max_abs_err": err, "tol": tol, "ok": ok})
        if not ok:
            self.failed.append("%s %s: %g > %g" % (kernel, case, err, tol))
        return err


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_environment():
    import torch

    env = {"phase": "environment", "nvidia_smi": nvidia_smi(),
           "card": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0]}
    emit(env)
    return env


def phase_build():
    from paddle_tpu_torch.ops.cuda import _lib

    t0 = time.time()
    path = _lib.build(verbose=True)
    _lib.lib()
    emit({"phase": "build", "library": os.path.relpath(path, HERE),
          "seconds": time.time() - t0})


def _flash_inputs(torch, b, h, t, dh, dtype, gen, masked_tail=True):
    dev = "cuda"
    q, k, v = (torch.randn((b * h, t, dh), generator=gen, device=dev)
               .to(dtype) for _ in range(3))
    bias = torch.zeros((b, t), device=dev)
    if masked_tail:
        for i in range(b):  # padded keys: the tail of each row is dropped
            n_pad = (i * 37) % (t // 2)
            if n_pad:
                bias[i, t - n_pad:] = -1e4
    return q, k, v, bias


def _tol(ref, units=2):
    """float32: 1e-4 relative to the largest |ref| (sums in another
    order); bfloat16: ``units`` units in the last place at the largest
    |ref| (the kernel and the plain version round at the same points,
    and a value on a rounding boundary can land one unit apart)."""
    import torch

    big = float(ref.float().abs().max())
    if ref.dtype == torch.float32:
        return 1e-4 * max(1.0, big)
    return units * BF16_UNIT * big


def _dname(dtype):
    return str(dtype).split(".")[-1]


def _keep_fraction_check(checks, kernel, kept, rate):
    """The share of kept cells within 4 sigma of 1 - rate."""
    n = kept.numel()
    frac = float(kept.float().mean())
    sigma = (rate * (1 - rate) / n) ** 0.5
    checks.check(kernel, "keep fraction %.6f of %d cells at rate %g"
                 % (frac, n, rate), abs(frac - (1 - rate)), 4 * sigma)


def kernel_flash(checks, torch, gen):
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    b, h, t, dh = 8, 12, SEQ, 64
    main_err = None
    for dtype in (torch.float32, torch.bfloat16):
        name = _dname(dtype)
        q, k, v, bias = _flash_inputs(torch, b, h, t, dh, dtype, gen)
        for rate in (0.0, DROPOUT):
            seed = DROP_SEED if rate else None
            o, m, l = fa.flash_attention_fwd(q, k, v, bias, dropout_rate=rate,
                                             dropout_seed=seed)
            po, pm, pl = fa.flash_attention_fwd_plain(
                q, k, v, bias, sm_scale=dh ** -0.5, dropout_rate=rate,
                dropout_seed=seed)
            torch.cuda.synchronize()
            case = "B8 H12 T512 Dh64 padded keys rate %g %s" % (rate, name)
            err = checks.check("flash_attention_fwd", case, max_err(o, po),
                               _tol(po))
            checks.check("flash_attention_fwd", "m, " + case,
                         max_err(m, pm), 1e-3)
            checks.check("flash_attention_fwd", "l relative, " + case,
                         max_err(l / pl, torch.ones_like(pl)), 1e-4)
            if dtype == torch.float32 and rate:
                main_err = err
            if dtype == torch.bfloat16:
                # a typical |o| is far below the largest, so the mean
                # error must also stay under one unit of the mean |o|: a
                # dropped or extra key moves a whole row and shows here
                checks.check(
                    "flash_attention_fwd", "mean error vs one unit of mean "
                    "|o|, " + case,
                    float((o.float() - po.float()).abs().mean()),
                    BF16_UNIT * float(po.float().abs().mean()))
    # the kernel's own mask: with V the identity, o = dropped p / l, so
    # the zeros of o are the dropped cells
    q, k, _, _ = _flash_inputs(torch, b, h, 128, 128, torch.float32, gen,
                               masked_tail=False)
    q = q.repeat(1, 4, 1).contiguous()  # 512 query rows against 128 keys
    eye = torch.eye(128, device="cuda").expand(b * h, 128, 128).contiguous()
    o, _, _ = fa.flash_attention_fwd(q, k, eye, None, dropout_rate=DROPOUT,
                                     dropout_seed=DROP_SEED)
    torch.cuda.synchronize()
    _keep_fraction_check(checks, "flash_attention_fwd", o != 0, DROPOUT)
    # edge cases: ragged T, causal, fully masked rows, ragged and 128 Dh
    for dtype in (torch.float32, torch.bfloat16):
        name = _dname(dtype)
        q, k, v, bias = _flash_inputs(torch, 2, 3, 200, 64, dtype, gen)
        bias[0, 0] = float("-inf")   # causal row 0 of batch 0 sees nothing
        bias[1, :] = float("-inf")   # batch 1: every row fully masked
        o, m, l = fa.flash_attention_fwd(q, k, v, bias, causal=True,
                                         dropout_rate=DROPOUT,
                                         dropout_seed=DROP_SEED)
        po, pm, pl = fa.flash_attention_fwd_plain(q, k, v, bias, True,
                                                  64 ** -0.5, DROPOUT,
                                                  DROP_SEED)
        torch.cuda.synchronize()
        checks.check("flash_attention_fwd",
                     "B2 H3 T200 causal, fully masked rows, rate %g %s"
                     % (DROPOUT, name), max_err(o, po), _tol(po))
        checks.check("flash_attention_fwd", "masked rows are 0 %s" % name,
                     float(o[3:].float().abs().max()) + float(
                         o[:3, 0].float().abs().max()), 0.0)
        for t_, dh_ in ((200, 96), (256, 128)):
            q, k, v, bias = _flash_inputs(torch, 2, 2, t_, dh_, dtype, gen)
            o, _, _ = fa.flash_attention_fwd(q, k, v, bias)
            po, _, _ = fa.flash_attention_fwd_plain(q, k, v, bias,
                                                    sm_scale=dh_ ** -0.5)
            torch.cuda.synchronize()
            checks.check("flash_attention_fwd", "B2 H2 T%d Dh%d %s"
                         % (t_, dh_, name), max_err(o, po), _tol(po))
    return main_err


def _flash_bwd_case(checks, torch, fa, case, q, k, v, bias, causal, rate,
                    gen):
    """Both backward kernels against the plain backward; returns each
    kernel's largest error and the gradients."""
    dh = q.shape[2]
    seed = DROP_SEED if rate else None
    o, m, l = fa.flash_attention_fwd(q, k, v, bias, causal,
                                     dropout_rate=rate, dropout_seed=seed)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    delta = (do.float() * o.float()).sum(dim=-1)
    args = (causal, None, rate, seed)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, bias, do, m, l, delta,
                                        *args)
    dq = fa.flash_attention_bwd_dq(q, k, v, bias, do, m, l, delta, *args)
    pq, pk, pv = fa.flash_attention_bwd_plain(q, k, v, bias, o, m, l, do,
                                              causal, dh ** -0.5, rate, seed)
    torch.cuda.synchronize()
    errs = {}
    for kernel, name, got, ref in (
            ("flash_attention_bwd_dkv", "dk", dk, pk),
            ("flash_attention_bwd_dkv", "dv", dv, pv),
            ("flash_attention_bwd_dq", "dq", dq, pq)):
        err = checks.check(kernel, "%s, %s" % (name, case),
                           max_err(got, ref), _tol(ref))
        errs[kernel] = max(errs.get(kernel, 0.0), err)
        if got.dtype == torch.bfloat16:
            checks.check(kernel, "%s mean error vs one unit of mean |ref|, "
                         "%s" % (name, case),
                         float((got.float() - ref.float()).abs().mean()),
                         BF16_UNIT * float(ref.float().abs().mean()))
    return errs, (dq, dk, dv)


def kernel_flash_bwd(checks, torch, gen):
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    b, h, t, dh = 8, 12, SEQ, 64
    main_err = None
    for dtype in (torch.float32, torch.bfloat16):
        name = _dname(dtype)
        q, k, v, bias = _flash_inputs(torch, b, h, t, dh, dtype, gen)
        for rate in (0.0, DROPOUT):
            err, _ = _flash_bwd_case(
                checks, torch, fa, "B8 H12 T512 Dh64 padded keys rate %g %s"
                % (rate, name), q, k, v, bias, False, rate, gen)
            if dtype == torch.float32 and rate:
                main_err = err
        q, k, v, bias = _flash_inputs(torch, 2, 3, 200, 64, dtype, gen)
        bias[0, 0] = float("-inf")
        bias[1, :] = float("-inf")
        _, (dq, dk, dv) = _flash_bwd_case(
            checks, torch, fa, "B2 H3 T200 causal, fully masked rows, rate "
            "%g %s" % (DROPOUT, name), q, k, v, bias, True, DROPOUT, gen)
        checks.check("flash_attention_bwd_dq",
                     "masked rows get zero gradients %s" % name,
                     float(dq[3:].float().abs().max())
                     + float(dq[:3, 0].float().abs().max())
                     + float(dk[3:].float().abs().max())
                     + float(dv[3:].float().abs().max()), 0.0)
        for t_, dh_, rate in ((200, 96, 0.0), (256, 128, DROPOUT)):
            q, k, v, bias = _flash_inputs(torch, 2, 2, t_, dh_, dtype, gen)
            _flash_bwd_case(checks, torch, fa, "B2 H2 T%d Dh%d rate %g %s"
                            % (t_, dh_, rate, name), q, k, v, bias, False,
                            rate, gen)
    return main_err


def kernel_ln(checks, torch, gen):
    from paddle_tpu_torch.ops.cuda import fused_ln as fl

    fwd_err = bwd_err = None
    for dtype in (torch.float32, torch.bfloat16):
        name = _dname(dtype)
        for n, d in ((4096, 768), (37, 640), (8, 4096)):
            x, res, dout = (torch.randn((n, d), generator=gen, device="cuda")
                            .to(dtype) for _ in range(3))
            g = torch.randn((d,), generator=gen, device="cuda")
            bt = torch.randn((d,), generator=gen, device="cuda")
            for rate in (0.0, DROPOUT):
                seed = DROP_SEED if rate else None
                case = "N%d D%d rate %g %s" % (n, d, rate, name)
                got = fl.fused_dropout_add_ln_fwd(x, res, g, bt, 1e-5, rate,
                                                  seed, save_stats=True)
                ref = fl.fused_dropout_add_ln_fwd_plain(x, res, g, bt, 1e-5,
                                                        rate, seed)
                serve = fl.fused_dropout_add_ln_fwd(x, res, g, bt, 1e-5,
                                                    rate, seed)
                torch.cuda.synchronize()
                # bf16: one unit in the last place at the largest output
                err = checks.check("fused_dropout_add_ln_fwd", case,
                                   max(max_err(got[0], ref[0]),
                                       max_err(serve, ref[0])),
                                   _tol(ref[0], units=1))
                for what, a, r in zip(("y", "mean", "rstd"), got[1:],
                                      ref[1:]):
                    checks.check("fused_dropout_add_ln_fwd",
                                 "%s, %s" % (what, case), max_err(a, r),
                                 _tol(r, units=1))
                grads = fl.fused_dropout_add_ln_bwd(dout, got[1], g, got[2],
                                                    got[3], rate, seed)
                refs = fl.fused_dropout_add_ln_bwd_plain(
                    dout, got[1], g, got[2], got[3], rate, seed)
                torch.cuda.synchronize()
                errs = [checks.check("fused_dropout_add_ln_bwd",
                                     "%s, %s" % (what, case),
                                     max_err(a, r), _tol(r))
                        for what, a, r in zip(("dx", "dres", "dgamma",
                                               "dbeta"), grads, refs)]
                if dtype == torch.float32 and (n, d) == (4096, 768) and rate:
                    fwd_err, bwd_err = err, max(errs)
                    kept = (got[1] != res) | (x == 0)
                    _keep_fraction_check(checks, "fused_dropout_add_ln_fwd",
                                         kept, rate)
    return fwd_err, bwd_err


def kernel_gather(checks, torch, gen):
    from paddle_tpu_torch.ops.cuda import embedding as emb

    main_err = None
    for dtype in (torch.float32, torch.bfloat16):
        name = _dname(dtype)
        table = torch.randn((30522, 768), generator=gen,
                            device="cuda").to(dtype)
        ids = torch.randint(0, 30522, (4096,), generator=gen,
                            device="cuda")
        err = checks.check(
            "embedding_gather_fwd", "V30522 D768 n4096 int64 %s" % name,
            max_err(emb.embedding_gather_fwd(table, ids),
                    emb.embedding_gather_fwd_plain(table, ids)), 0.0)
        if dtype == torch.float32:
            main_err = err
        for v, d in ((1000, 640), (50, 3)):
            table = torch.randn((v, d), generator=gen,
                                device="cuda").to(dtype)
            ids = torch.randint(0, v, (300,), generator=gen, device="cuda")
            ids[:4] = torch.tensor([-3, v, v + 500, 7], device="cuda")
            ids = ids.to(torch.int32)
            got = emb.embedding_gather_fwd(table, ids, padding_idx=7)
            ref = emb.embedding_gather_fwd_plain(table, ids, 7)
            torch.cuda.synchronize()
            checks.check("embedding_gather_fwd",
                         "V%d D%d int32 negative, >=V, padding_idx %s"
                         % (v, d, name), max_err(got, ref), 0.0)
    return main_err


def _decode_tol(ref):
    """The decode kernels: float32 within 1e-5 of the largest |ref| (the
    reference's documented tolerance for its decode oracle); bfloat16
    within 2 units in the last place there."""
    import torch

    big = float(ref.float().abs().max())
    if ref.dtype == torch.float32:
        return 1e-5 * max(1.0, big)
    return 2 * BF16_UNIT * big


def _decode_ring_inputs(torch, gen, b, h, t, dh, dtype, lengths):
    q = torch.randn((b, h, dh), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, h, t, dh), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device="cuda")


def _paged_tables(torch, gen, lengths, block_len, max_blocks, pool_blocks):
    """Block tables over a shuffled pool: each sequence owns the blocks
    its length needs, at non-contiguous shuffled ids, and -1 after them."""
    import numpy as np

    order = torch.randperm(pool_blocks, generator=gen,
                           device="cuda").cpu().numpy()
    table = np.full((len(lengths), max_blocks), -1, "int32")
    nxt = 0
    for s, n in enumerate(lengths):
        need = -(-int(n) // block_len)
        table[s, :need] = order[nxt:nxt + need]
        nxt += need
    assert nxt <= pool_blocks
    return torch.from_numpy(table).cuda()


def kernel_decode(checks, torch, gen):
    """K5 and K6 against their plain versions: the main path's shapes (8
    sequences x 12 heads, Tmax 1024, Dh 64) with lengths 0, 1, 17, 500
    and 1024 mixed in one launch, Dh 128, and for K6 shuffled block ids,
    -1 tails, a pool larger than the tables, block_len 16 and 32."""
    from paddle_tpu_torch.ops.cuda import flash_decode as fd
    from paddle_tpu_torch.ops.cuda import paged_flash_decode as pfd

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = _dname(dtype)
        for b, h, t, dh, lens in (
                (8, 12, DECODE_TMAX, 64, DECODE_KERNEL_LENGTHS),
                (3, 4, 256, 128, (0, 17, 256)),
                (2, 2, 96, 64, (1, 95))):
            q, k, v, ln = _decode_ring_inputs(torch, gen, b, h, t, dh, dtype,
                                              lens)
            got = fd.flash_decode(q, k, v, ln)
            ref = fd.flash_decode_plain(q, k, v, ln)
            torch.cuda.synchronize()
            case = "B%d H%d Tmax%d Dh%d lengths %s %s" % (b, h, t, dh,
                                                          list(lens), name)
            err = checks.check("flash_decode_fwd", case, max_err(got, ref),
                               _decode_tol(ref))
            if 0 in lens:
                checks.check("flash_decode_fwd", "length-0 rows are 0, "
                             + case, float(got[[i for i, n in enumerate(lens)
                                                if n == 0]].float().abs()
                                           .max()), 0.0)
            if dtype == torch.float32 and t == DECODE_TMAX:
                errs["flash_decode_fwd"] = err
            for bl in (16, 32):
                if t % bl:
                    continue
                mb = t // bl
                pool = b * mb + 37
                table = _paged_tables(torch, gen, lens, bl, mb, pool)
                kp, vp = (torch.randn((pool, h, bl, dh), generator=gen,
                                      device="cuda").to(dtype)
                          for _ in range(2))
                got = pfd.paged_flash_decode(q, kp, vp, ln, table)
                ref = pfd.paged_flash_decode_plain(q, kp, vp, ln, table)
                torch.cuda.synchronize()
                case = ("S%d H%d BL%d MB%d pool %d shuffled, -1 tails, "
                        "Dh%d lengths %s %s" % (b, h, bl, mb, pool, dh,
                                                list(lens), name))
                err = checks.check("paged_flash_decode_fwd", case,
                                   max_err(got, ref), _decode_tol(ref))
                if dtype == torch.float32 and t == DECODE_TMAX and bl == 16:
                    errs["paged_flash_decode_fwd"] = err
                # the same cache rows through the ring kernel agree too
                ring = fd.flash_decode(
                    q, pfd.gather_paged_cache(kp, table).contiguous(),
                    pfd.gather_paged_cache(vp, table).contiguous(), ln)
                torch.cuda.synchronize()
                checks.check("paged_flash_decode_fwd", "vs the ring kernel "
                             "on the gathered rows, " + case,
                             max_err(got, ring), _decode_tol(ring))
    return errs


def _decode_bound(lengths, heads, dh, esize, rows, table_bytes=0):
    """Live bytes of one decode launch: the K and V rows below each
    length, q, o and the lengths (and the table), read or written once;
    4 flops per live key element (q.k and p.v)."""
    live = sum(int(n) for n in lengths) * heads * dh
    nbytes = 2 * live * esize + 2 * rows * dh * esize + 4 * rows \
        + table_bytes
    return bound_ms(nbytes, 4 * live, "float32")


def time_decode_kernels(torch, gen, errs):
    """Cold-L2 times of K5 and K6 at the decode path's shapes (8
    sequences x 12 heads, Dh 64, Tmax 1024, float32) with the mixed
    lengths of the checks, and with every row full; the bound counts the
    live rows only.  K5's yardstick is one masked
    ``scaled_dot_product_attention``; K6 has no single library call, so
    the gather + SDPA pair is timed beside it."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import flash_decode as fd
    from paddle_tpu_torch.ops.cuda import paged_flash_decode as pfd

    src = "paddle_tpu_torch/csrc/flash_decode.cu"
    b, h, t, dh, bl = 8, 12, DECODE_TMAX, 64, 16
    mb = t // bl
    rows, extra = [], []
    for lens in (DECODE_KERNEL_LENGTHS, (t,) * b):
        q, k, v, ln = _decode_ring_inputs(torch, gen, b, h, t, dh,
                                          torch.float32, lens)
        mask = (torch.arange(t, device="cuda")[None, :] < ln[:, None]
                )[:, None, None, :]
        q4 = q[:, :, None, :]
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k, v, attn_mask=mask), 50)
        shape = "q [8,12,64], k/v [8,12,1024,64] f32, lengths %s" % (
            list(lens),)
        r = _row("flash_decode_fwd", src,
                 "paddle_tpu/ops/pallas/flash_decode.py:178",
                 errs["flash_decode_fwd"],
                 time_ms(lambda: fd.flash_decode(q, k, v, ln), 50),
                 time_ms(lambda: fd.flash_decode_plain(q, k, v, ln), 50),
                 _decode_bound(lens, h, dh, 4, b * h), sdpa, shape)
        (rows if lens == DECODE_KERNEL_LENGTHS else extra).append(r)
        table = _paged_tables(torch, gen, lens, bl, mb, b * mb)
        kp, vp = (torch.randn((b * mb, h, bl, dh), generator=gen,
                              device="cuda") for _ in range(2))
        r = _row("paged_flash_decode_fwd", src,
                 "paddle_tpu/ops/pallas/paged_flash_decode.py:185",
                 errs["paged_flash_decode_fwd"],
                 time_ms(lambda: pfd.paged_flash_decode(q, kp, vp, ln,
                                                        table), 50),
                 time_ms(lambda: pfd.paged_flash_decode_plain(
                     q, kp, vp, ln, table), 50),
                 _decode_bound(lens, h, dh, 4, b * h,
                               4 * int((table >= 0).sum())),
                 None, "q [8,12,64], pools [512,12,16,64] f32, shuffled "
                 "tables [8,64], lengths %s" % (list(lens),))
        r["gather_sdpa_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            q4, pfd.gather_paged_cache(kp, table),
            pfd.gather_paged_cache(vp, table), attn_mask=mask), 50)
        (rows if lens == DECODE_KERNEL_LENGTHS else extra).append(r)
    return rows, extra


def _row(name, source, replaces, err, ms, plain_ms, bound, library_ms,
         shape):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library_ms, "shape": shape}


def time_kernels(torch, gen, errs):
    """Cold-L2 times of every kernel at the training path's shapes and
    rate (K1, K2 at dropout 0.1; the forwards also at rate 0, as serving
    runs them), beside the plain version and one PyTorch library call."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import embedding as emb
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import fused_ln as fl

    fa_src, fa_ref = ("paddle_tpu_torch/csrc/flash_attention.cu",
                      "paddle_tpu/ops/pallas/flash_attention.py:")
    ln_src, ln_ref = ("paddle_tpu_torch/csrc/fused_ln.cu",
                      "paddle_tpu/ops/pallas/fused_ln.py:")
    rows, extra = [], []
    b, h, t, dh = 8, 12, SEQ, 64
    bh = b * h
    q, k, v, bias = _flash_inputs(torch, b, h, t, dh, torch.float32, gen)
    sc = dh ** -0.5
    drop = (DROPOUT, DROP_SEED)
    fwd_bound = bound_ms(4 * (4 * bh * t * dh + b * t + 2 * bh * t),
                         4 * bh * t * t * dh, "float32")
    q4, k4, v4 = (x.view(b, h, t, dh) for x in (q, k, v))
    mask4 = bias.view(b, 1, 1, t)
    for rate in (DROPOUT, 0.0):
        seed = DROP_SEED if rate else None
        ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, bias,
                                                    dropout_rate=rate,
                                                    dropout_seed=seed))
        plain = time_ms(lambda: fa.flash_attention_fwd_plain(
            q, k, v, bias, sm_scale=sc, dropout_rate=rate,
            dropout_seed=seed))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask4, dropout_p=rate))
        r = _row("flash_attention_fwd", fa_src, fa_ref + "266",
                 errs["flash_attention_fwd"], ms, plain, fwd_bound, lib,
                 "q,k,v [96,512,64] f32, bias [8,512], dropout %g" % rate)
        (rows if rate else extra).append(r)

    o, m, l = fa.flash_attention_fwd(q, k, v, bias, dropout_rate=DROPOUT,
                                     dropout_seed=DROP_SEED)
    do = torch.randn(q.shape, generator=gen, device="cuda")
    delta = (do * o).sum(dim=-1)
    plain = time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, bias, o, m, l, do, False, sc, *drop))
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q4, k4, v4))
    lo = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask4,
                                        dropout_p=DROPOUT)
    do4 = do.view(b, h, t, dh)
    lib = time_ms(lambda: torch.autograd.grad(lo, (qg, kg, vg), do4,
                                              retain_graph=True))
    io = 4 * (4 * bh * t * dh + 3 * bh * t + b * t)
    rows.append(_row(
        "flash_attention_bwd_dkv", fa_src, fa_ref + "473",
        errs["flash_attention_bwd_dkv"],
        time_ms(lambda: fa.flash_attention_bwd_dkv(
            q, k, v, bias, do, m, l, delta, False, None, *drop)),
        plain, bound_ms(io + 4 * 2 * bh * t * dh, 8 * bh * t * t * dh,
                        "float32"), lib,
        "q,k,v,dO [96,512,64] f32, dropout 0.1; plain and library ms are "
        "of the whole backward (dQ, dK, dV)"))
    rows.append(_row(
        "flash_attention_bwd_dq", fa_src, fa_ref + "521",
        errs["flash_attention_bwd_dq"],
        time_ms(lambda: fa.flash_attention_bwd_dq(
            q, k, v, bias, do, m, l, delta, False, None, *drop)),
        plain, bound_ms(io + 4 * bh * t * dh, 6 * bh * t * t * dh,
                        "float32"), lib,
        "q,k,v,dO [96,512,64] f32, dropout 0.1; plain and library ms are "
        "of the whole backward (dQ, dK, dV)"))
    del q, k, v, o, do, qg, kg, vg, lo

    n, d = 4096, 768
    x, res, dout = (torch.randn((n, d), generator=gen, device="cuda")
                    for _ in range(3))
    g = torch.randn((d,), generator=gen, device="cuda")
    bt = torch.randn((d,), generator=gen, device="cuda")
    lib = time_ms(lambda: F.layer_norm(x + res, (d,), g, bt, 1e-5), 50)
    rows.append(_row(
        "fused_dropout_add_ln_fwd", ln_src, ln_ref + "190",
        errs["fused_dropout_add_ln_fwd"],
        time_ms(lambda: fl.fused_dropout_add_ln_fwd(
            x, res, g, bt, 1e-5, *drop, save_stats=True), 50),
        time_ms(lambda: fl.fused_dropout_add_ln_fwd_plain(
            x, res, g, bt, 1e-5, *drop), 50),
        bound_ms(4 * (4 * n * d + 2 * d + 2 * n), 10 * n * d, "float32"),
        lib, "x,res [4096,768] f32, dropout 0.1, y/mean/rstd saved"))
    extra.append(_row(
        "fused_dropout_add_ln_fwd", ln_src, ln_ref + "190",
        errs["fused_dropout_add_ln_fwd"],
        time_ms(lambda: fl.fused_dropout_add_ln_fwd(x, res, g, bt), 50),
        time_ms(lambda: fl.fused_dropout_add_ln_fwd_plain(x, res, g, bt),
                50),
        bound_ms(4 * (3 * n * d + 2 * d), 8 * n * d, "float32"), lib,
        "x,res [4096,768] f32, dropout 0, out only (serving)"))
    _, y, mean, rstd = fl.fused_dropout_add_ln_fwd(x, res, g, bt, 1e-5,
                                                   *drop, save_stats=True)
    xr, rr, gr, br = (a.detach().clone().requires_grad_()
                      for a in (x, res, g, bt))
    lo = F.layer_norm(xr + rr, (d,), gr, br, 1e-5)
    rows.append(_row(
        "fused_dropout_add_ln_bwd", ln_src, ln_ref + "224",
        errs["fused_dropout_add_ln_bwd"],
        time_ms(lambda: fl.fused_dropout_add_ln_bwd(dout, y, g, mean, rstd,
                                                    *drop), 50),
        time_ms(lambda: fl.fused_dropout_add_ln_bwd_plain(
            dout, y, g, mean, rstd, *drop), 50),
        bound_ms(4 * (4 * n * d + 3 * d + 2 * n), 12 * n * d, "float32"),
        time_ms(lambda: torch.autograd.grad(lo, (xr, rr, gr, br), dout,
                                            retain_graph=True), 50),
        "dout,y [4096,768] f32, dropout 0.1"))
    del x, res, dout, y, xr, rr, lo

    table = torch.randn((30522, 768), generator=gen, device="cuda")
    ids = torch.randint(0, 30522, (4096,), generator=gen, device="cuda")
    rows.append(_row(
        "embedding_gather_fwd", "paddle_tpu_torch/csrc/embedding.cu",
        "paddle_tpu/ops/pallas/embedding.py:74",
        errs["embedding_gather_fwd"],
        time_ms(lambda: emb.embedding_gather_fwd(table, ids), 50),
        time_ms(lambda: emb.embedding_gather_fwd_plain(table, ids), 50),
        bound_ms(4096 * 768 * 4 * 2 + 4096 * 8, 0, "float32"),
        time_ms(lambda: F.embedding(ids, table), 50),
        "table [30522,768] f32, ids [4096] int64"))
    # the gather's backward: a PyTorch scatter-add (index_add_), as the
    # reference leaves it to XLA; timed for the table, not a kernel here
    gout = torch.randn((4096, 768), generator=gen, device="cuda")
    scatter = {
        "phase": "kernels", "timing": True,
        "library_op": "embedding_gather_bwd (index_add_ scatter-add)",
        "replaces": "paddle_tpu/ops/pallas/embedding.py:96 (XLA scatter-add)",
        "ms": time_ms(lambda: emb.embedding_gather_bwd(gout, ids, 30522),
                      50),
        "library_ms": time_ms(lambda: torch.zeros(
            (30522, 768), device="cuda").index_add_(0, ids, gout), 50),
        "shape": "dout [4096,768] f32 → table grad [30522,768]"}
    scatter["bound_ms"], scatter["bound_by"] = bound_ms(
        4 * (30522 * 768 + 4096 * 768) + 8 * 4096, 4096 * 768, "float32")
    return rows, extra, scatter


def _bn_act_inputs(torch, gen, r, c, dtype):
    """A conv output y [r, c] with its batch statistics (the fused op's
    mean and rstd), gamma, beta and an output gradient."""
    y = (torch.randn((r, c), generator=gen, device="cuda") * 1.5
         + 0.3).to(dtype)
    y32 = y.float()
    mean = y32.mean(dim=0)
    var = torch.clamp((y32 * y32).mean(dim=0) - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + 1e-5)
    g = 1.0 + 0.1 * torch.randn((c,), generator=gen, device="cuda")
    b = 0.1 * torch.randn((c,), generator=gen, device="cuda")
    dout = torch.randn((r, c), generator=gen, device="cuda").to(dtype)
    return y, g, b, mean, rstd, dout


def kernel_bn_act(checks, torch, gen):
    """K4 forward and backward against their plain versions at the
    ResNet-50 sites' shapes and a ragged one, float32 and bfloat16,
    identity and relu.  The forward and dy use the plain version's
    separate roundings (float32: expected bit-identical); the four sums
    run in another order over up to 802816 rows."""
    from paddle_tpu_torch.ops.cuda import conv_bn_act as cba

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = _dname(dtype)
        for r, c in K4_SHAPES:
            y, g, b, mean, rstd, dout = _bn_act_inputs(torch, gen, r, c,
                                                       dtype)
            for act in ("relu", "identity"):
                case = "[%d, %d] %s %s" % (r, c, act, name)
                got = cba.bn_act_epilogue_fwd(y, g, b, mean, rstd, act)
                ref = cba.bn_act_epilogue_fwd_plain(y, g, b, mean, rstd, act)
                torch.cuda.synchronize()
                ferr = checks.check("bn_act_epilogue_fwd", case,
                                    max_err(got, ref), _tol(ref, units=1))
                grads = cba.bn_act_epilogue_bwd(dout, y, g, b, mean, rstd,
                                                act)
                refs = cba.bn_act_epilogue_bwd_plain(dout, y, g, b, mean,
                                                     rstd, act)
                torch.cuda.synchronize()
                berr = max(checks.check(
                    "bn_act_epilogue_bwd", "%s, %s" % (what, case),
                    max_err(a, rf), _tol(rf))
                    for what, a, rf in zip(("dy", "dgamma", "dbeta",
                                            "dmean", "drstd"), grads, refs))
                if dtype == torch.float32 and (r, c) == K4_TIME_SHAPE \
                        and act == "relu":
                    errs["bn_act_epilogue_fwd"] = ferr
                    errs["bn_act_epilogue_bwd"] = berr
            del y, dout, got, ref, grads, refs
    torch.cuda.empty_cache()
    return errs


def _bn_act_library_bwd(torch, y4, dout4, g, mean, rstd):
    """ATen's batch-norm backward on the channels-last views: the
    per-channel reduce, then the elementwise pass.  It also carries the
    gradient through the batch statistics, which K4 leaves to autograd,
    and has no relu mask: the nearest single library computation."""
    sums = torch.ops.aten.batch_norm_backward_reduce(
        dout4, y4, mean, rstd, g, True, True, True)
    count = torch.full((1,), y4.numel() // y4.shape[1], dtype=torch.int32,
                       device="cuda")
    return torch.ops.aten.batch_norm_backward_elemt(
        dout4, y4, mean, rstd, g, sums[0], sums[1], count)


def time_bn_act(torch, gen, errs):
    """Cold-L2 times of K4 forward and backward (float32, relu) at every
    ResNet-50 site shape of batch 64, beside the plain version and the
    nearest library calls: ``F.batch_norm(training=False)`` + relu on the
    channels_last view (forward); ATen's batch-norm backward reduce +
    elementwise pass (backward).  The kernels line takes the stage-1
    [200704, 256] row; the others are printed as extra timing lines."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import conv_bn_act as cba

    src = "paddle_tpu_torch/csrc/conv_bn_act.cu"
    ref = "paddle_tpu/ops/pallas/conv_bn_act.py:"
    rows, extra = [], []
    for r, c in sorted(set(RESNET_SITE_SHAPES) | {K4_TIME_SHAPE}):
        y, g, b, mean, rstd, dout = _bn_act_inputs(torch, gen, r, c,
                                                   torch.float32)
        hw = r // RESNET_BATCH
        side = int(round(hw ** 0.5))
        y4 = y.view(RESNET_BATCH, side, side, c).permute(0, 3, 1, 2)
        d4 = dout.view(RESNET_BATCH, side, side, c).permute(0, 3, 1, 2)
        var = 1.0 / (rstd * rstd) - 1e-5
        shape = "y [%d, %d] f32 relu (%dx%d x %d channels at batch %d)" % (
            r, c, side, side, c, RESNET_BATCH)
        n_el = r * c
        fwd = _row(
            "bn_act_epilogue_fwd", src, ref + "153",
            errs["bn_act_epilogue_fwd"],
            time_ms(lambda: cba.bn_act_epilogue_fwd(y, g, b, mean, rstd,
                                                    "relu"), 20),
            time_ms(lambda: cba.bn_act_epilogue_fwd_plain(
                y, g, b, mean, rstd, "relu"), 20),
            bound_ms(4 * (2 * n_el + 4 * c), 5 * n_el, "float32"),
            time_ms(lambda: F.relu(F.batch_norm(y4, mean, var, g, b, False,
                                                0.0, 1e-5)), 20),
            shape)
        try:
            lib_bwd = time_ms(lambda: _bn_act_library_bwd(
                torch, y4, d4, g, mean, rstd), 20)
        except (RuntimeError, TypeError) as e:  # a yardstick only
            lib_bwd = None
            emit({"phase": "kernels", "library_bwd_unavailable": str(e)})
        bwd = _row(
            "bn_act_epilogue_bwd", src, ref + "175",
            errs["bn_act_epilogue_bwd"],
            time_ms(lambda: cba.bn_act_epilogue_bwd(dout, y, g, b, mean,
                                                    rstd, "relu"), 20),
            time_ms(lambda: cba.bn_act_epilogue_bwd_plain(
                dout, y, g, b, mean, rstd, "relu"), 20),
            bound_ms(4 * (3 * n_el + 4 * c + 4 * c), 12 * n_el, "float32"),
            lib_bwd, shape + "; library: ATen batch_norm_backward_reduce "
            "+ _elemt (also the statistics' chain, no relu)")
        if (r, c) == K4_TIME_SHAPE:
            rows += [fwd, bwd]
        else:
            extra += [fwd, bwd]
        del y, dout, y4, d4
    torch.cuda.empty_cache()
    return rows, extra


def _bit_mismatches(a, b):
    """Elements whose bits differ, NaN counting equal to any NaN (a
    NaN's sign and payload are the backend's)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return float("inf")
    if not a.is_floating_point():
        return int((a != b).sum())
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    same = (a.view(ints[a.dtype]) == b.view(ints[b.dtype])) | (nan_a & nan_b)
    return int((~same).sum())


def _k7_special(torch, block):
    """Blocks whose bits are easy to get wrong: zero, subnormal (and a
    normal block whose scale is subnormal), NaN, inf, NaN with inf, exact
    .5 ties, a wide dynamic range, and a negative absmax."""
    nan, inf = float("nan"), float("inf")
    rows = [[0.0], [1e-41] * block, [2e-38] * block, [1, nan, -2, 0.5],
            [1, inf, -2, 0.5], [1, inf, nan, -inf],
            [63.5, 2.5, -0.5, 127, 1.5, -2.5, 0.5, -126.5], [-3.25, 1e-3]]
    out = torch.zeros((len(rows) + 1, block), dtype=torch.float32)
    for i, r in enumerate(rows):
        out[i, :min(len(r), block)] = torch.tensor(r[:block])
    g = torch.Generator().manual_seed(SEED)
    out[-1] = torch.randn(block, generator=g) * 10.0 ** (
        torch.rand(block, generator=g) * 40 - 20)
    return out.cuda()


def kernel_quant(checks, torch, gen):
    """K7 quantize and dequantize (to float32 and bfloat16) against their
    plain versions: bit-identical, at the 32 MB bucket, an odd B (the
    vector and the scalar path), an unaligned pointer, an odd tail
    through ``block_quantize``, and the special blocks."""
    from paddle_tpu_torch.ops.cuda import quant as k7
    from paddle_tpu_torch.quant import block_dequantize, block_quantize

    cases = [("bucket [32768, 256]", torch.randn(
        K7_BUCKET, generator=gen, device="cuda"))]
    for b in (100, 7, K7_BLOCK):
        cases.append(("special blocks B=%d" % b, _k7_special(torch, b)))
    cases.append(("B=100 [1000, 100]", torch.randn(
        (1000, 100), generator=gen, device="cuda") * 3.0))
    flat = torch.randn(1 + 4000 * 64, generator=gen, device="cuda")
    cases.append(("unaligned pointer [4000, 64]", flat[1:].view(4000, 64)))
    errs = {"block_quantize": 0.0, "block_dequantize": 0.0}
    for case, x in cases:
        q, s = k7.block_quantize_blocks(x)
        pq, ps = k7.block_quantize_blocks_plain(x)
        torch.cuda.synchronize()
        checks.check("block_quantize", case + ": q, scales bits differing",
                     _bit_mismatches(q, pq) + _bit_mismatches(s, ps), 0)
        if case.startswith("bucket"):
            errs["block_quantize"] = max_err(s, ps)
        for dtype in (torch.float32, torch.bfloat16):
            got = k7.block_dequantize_blocks(q, s, dtype)
            ref = k7.block_dequantize_blocks_plain(q, s, dtype)
            torch.cuda.synchronize()
            checks.check("block_dequantize", "%s -> %s: bits differing"
                         % (case, _dname(dtype)),
                         _bit_mismatches(got, ref), 0)
            if case.startswith("bucket") and dtype == torch.float32:
                errs["block_dequantize"] = max_err(got, ref)
    x = torch.randn(1000003, generator=gen, device="cuda").to(torch.bfloat16)
    q, s = block_quantize(x)
    pq, ps = block_quantize(x, kernel=False)
    back = block_dequantize(q, s, size=x.numel(), dtype=torch.bfloat16)
    pback = block_dequantize(pq, ps, size=x.numel(), dtype=torch.bfloat16,
                             kernel=False)
    torch.cuda.synchronize()
    checks.check("block_quantize", "odd tail 1000003 bf16 through "
                 "block_quantize: bits differing",
                 _bit_mismatches(q, pq) + _bit_mismatches(s, ps), 0)
    checks.check("block_dequantize", "odd tail 1000003 -> bf16, trimmed: "
                 "bits differing", _bit_mismatches(back, pback), 0)
    return errs


def time_quant(torch, gen, errs):
    """Cold-L2 times of K7 at the 32 MB bucket (the kernels line's rows)
    and at BERT-base's whole gradient, beside the plain versions; no
    single PyTorch call computes either function."""
    from paddle_tpu_torch.ops.cuda import quant as k7

    src = "paddle_tpu_torch/csrc/quant.cu"
    ref = "paddle_tpu/quant/blockwise.py:"
    rows, extra = [], []
    for shape in (K7_BUCKET, K7_WHOLE):
        x = torch.randn(shape, generator=gen, device="cuda")
        n, b = x.numel(), shape[1]
        q, s = k7.block_quantize_blocks(x)
        label = "[%d, %d] f32 (%s)" % (shape[0], b, "one 32 MB bucket"
                                        if shape == K7_BUCKET
                                        else "BERT-base's whole gradient")
        quant = _row(
            "block_quantize", src, ref + "142", errs["block_quantize"],
            time_ms(lambda: k7.block_quantize_blocks(x)),
            time_ms(lambda: k7.block_quantize_blocks_plain(x)),
            bound_ms(4 * n + n + 4 * n // b, 5 * n, "float32"), None,
            label + " -> int8 + scales")
        dequant = _row(
            "block_dequantize", src, ref + "164", errs["block_dequantize"],
            time_ms(lambda: k7.block_dequantize_blocks(q, s)),
            time_ms(lambda: k7.block_dequantize_blocks_plain(q, s)),
            bound_ms(n + 4 * n // b + 4 * n, n, "float32"), None,
            label + " int8 + scales -> f32")
        dequant16 = _row(
            "block_dequantize", src, ref + "164", errs["block_dequantize"],
            time_ms(lambda: k7.block_dequantize_blocks(q, s,
                                                       torch.bfloat16)),
            time_ms(lambda: k7.block_dequantize_blocks_plain(
                q, s, torch.bfloat16)),
            bound_ms(n + 4 * n // b + 2 * n, n, "float32"), None,
            label + " int8 + scales -> bf16")
        if shape == K7_BUCKET:
            rows += [quant, dequant]
            extra.append(dequant16)
        else:
            extra += [quant, dequant, dequant16]
        del x, q, s
    torch.cuda.empty_cache()
    return rows, extra


def phase_kernels():
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    checks = Checks()
    errs = {"flash_attention_fwd": kernel_flash(checks, torch, gen)}
    errs.update(kernel_flash_bwd(checks, torch, gen))
    errs["fused_dropout_add_ln_fwd"], errs["fused_dropout_add_ln_bwd"] = \
        kernel_ln(checks, torch, gen)
    errs["embedding_gather_fwd"] = kernel_gather(checks, torch, gen)
    errs.update(kernel_decode(checks, torch, gen))
    errs.update(kernel_bn_act(checks, torch, gen))
    errs.update(kernel_quant(checks, torch, gen))
    if checks.failed:
        raise AssertionError("kernel checks failed: %s"
                             % "; ".join(checks.failed))
    rows, extra, scatter = time_kernels(torch, gen, errs)
    decode_rows, decode_extra = time_decode_kernels(torch, gen, errs)
    bn_rows, bn_extra = time_bn_act(torch, gen, errs)
    quant_rows, quant_extra = time_quant(torch, gen, errs)
    rows += decode_rows + bn_rows + quant_rows
    for r in rows + extra + decode_extra + bn_extra + quant_extra:
        emit(dict({"phase": "kernels", "timing": True}, **r))
    emit(scatter)
    torch.cuda.empty_cache()
    return rows


def _bert_program(fluid, bert, cfg):
    import copy

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup):
        input_ids = fluid.layers.data("input_ids", shape=[SEQ],
                                      dtype="int64")
        token_type = fluid.layers.data("token_type_ids", shape=[SEQ],
                                       dtype="int64")
        mask = fluid.layers.data("attn_mask_bias", shape=[1, 1, SEQ],
                                 dtype="float32")
        icfg = copy.copy(cfg)
        icfg.dropout = 0.0
        icfg.attn_dropout = 0.0
        hidden = bert.encoder(input_ids, token_type, mask, icfg, SEQ)
    return main, startup, hidden


def _bert_request(rng, rows, cfg):
    import numpy as np

    ids = rng.randint(10, cfg.vocab_size, (rows, SEQ)).astype("int64")
    mask = np.zeros((rows, 1, 1, SEQ), "float32")
    for r in range(rows):  # a padded tail per row, as real traffic has
        n_pad = int(rng.randint(0, SEQ // 4))
        if n_pad:
            mask[r, 0, 0, SEQ - n_pad:] = -1e4
    return {"input_ids": ids,
            "token_type_ids": np.zeros((rows, SEQ), "int64"),
            "attn_mask_bias": mask,
            "pos_ids": np.tile(np.arange(SEQ, dtype="int64"), (rows, 1))}


def phase_main_path(env):
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.executor import Scope, scope_guard
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops.cuda import (KERNELS, launch_counts,
                                           reset_launch_counts)

    cfg = bert.BERT_BASE
    feeds = ["input_ids", "token_type_ids", "attn_mask_bias", "pos_ids"]
    t0 = time.time()
    main, startup, hidden = _bert_program(fluid, bert, cfg)
    export_dir = os.path.join(HERE, ".smoke_tmp", "bert_base_export")
    shutil.rmtree(export_dir, ignore_errors=True)
    try:
        scope = Scope()
        with scope_guard(scope):
            exe = fluid.Executor(fluid.CUDAPlace(0))
            exe.run(startup)
            fluid.io.save_inference_model(export_dir, feeds, [hidden], exe,
                                          main_program=main)
        del scope, exe
        pred = fluid.inference.create_paddle_predictor(
            fluid.inference.AnalysisConfig(model_dir=export_dir))
        cpu_cfg = fluid.inference.AnalysisConfig(model_dir=export_dir)
        cpu_cfg.disable_gpu()
        cpu_pred = fluid.inference.create_paddle_predictor(cpu_cfg)
    finally:
        shutil.rmtree(os.path.dirname(export_dir), ignore_errors=True)
    setup_s = time.time() - t0
    op_types = {}
    for op in pred.program.global_block().ops:
        op_types[op.type] = op_types.get(op.type, 0) + 1
    emit({"phase": "main_path", "step": "export+load",
          "seconds": setup_s, "analyzed_ops": op_types})

    rng = np.random.RandomState(SEED)
    requests = [_bert_request(rng, r, cfg) for r in REQUEST_ROWS]
    server = serving.PredictorServer(
        {"bert": pred}, verify=False, buckets=BUCKETS, auto_start=False)
    try:
        # compile-free, but the first runs of a shape pay cuBLAS handle
        # and heuristic set-up: warm the 8-row bucket the server will use,
        # so the latency below is steady state
        warm = _bert_request(np.random.RandomState(SEED + 1), BUCKETS[-1],
                             cfg)
        for _ in range(2):
            pred.run(warm)
        reset_launch_counts()
        t_start = time.time()
        futures = [server.submit("bert", feed, request_id=i)
                   for i, feed in enumerate(requests)]
        server.start()
        results = [f.result(timeout=600) for f in futures]
        wall_s = time.time() - t_start
        counts = launch_counts()
    finally:
        server.close()
    batches = len(server.dispatch_log)
    want = dict.fromkeys(KERNELS, 0)
    want.update({"flash_attention_fwd": 12 * batches,
                 "fused_dropout_add_ln_fwd": 25 * batches,
                 "embedding_gather_fwd": 3 * batches})
    emit({"phase": "main_path", "step": "serve", "batches": batches,
          "dispatch_log": server.dispatch_log, "launches": counts,
          "expected_launches": want})
    if counts != want:
        raise AssertionError("launch counts %s != %s per %d batches"
                             % (counts, want, batches))

    worst = 0.0
    for feed, out, rows, f in zip(requests, results, REQUEST_ROWS, futures):
        got = out[0]
        if got.shape != (rows, SEQ, cfg.hidden) or not np.isfinite(got).all():
            raise AssertionError("request %r: shape %s or non-finite"
                                 % (f.id, got.shape))
        direct = pred.run(feed)[0]
        worst = max(worst, float(np.abs(got - direct).max()))
    emit({"phase": "main_path", "step": "served vs direct run",
          "max_abs_err": worst, "tol": SERVE_ATOL})
    if worst > SERVE_ATOL:
        raise AssertionError("served rows differ from a direct run by %g"
                             % worst)
    cpu_out = cpu_pred.run(requests[0])[0]
    cpu_err = float(np.abs(results[0][0] - cpu_out).max())
    emit({"phase": "main_path", "step": "GPU kernels vs CPU plain versions",
          "max_abs_err": cpu_err, "tol": CPU_ATOL})
    if cpu_err > CPU_ATOL:
        raise AssertionError("GPU result differs from the CPU plain "
                             "versions by %g" % cpu_err)
    tokens = sum(REQUEST_ROWS) * SEQ
    emit({"phase": "main_path", "step": "latency",
          "card": card_label(env),
          "request_latency_ms": [f.latency_ms for f in futures],
          "tokens": tokens, "wall_s": wall_s,
          "tokens_per_s": tokens / wall_s})
    return counts, pred, cfg


def _median_ms(fn, reps=5, warmup=2):
    import statistics

    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _kernel_group(name):
    """The profile's group of a device kernel, by its name."""
    for group, needles in (
            ("K1 fwd", ("flash_fwd_kernel",)),
            ("K1 bwd", ("flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")),
            ("K2 fwd", ("add_ln_fwd_kernel",)),
            ("K2 bwd", ("add_ln_bwd_kernel", "ln_bwd_reduce_kernel")),
            ("gather", ("::gather_kernel<",)),
            ("K6 paged decode", ("paged_decode_kernel<",)),
            ("K5 decode", ("decode_kernel<",)),
            ("scatter", ("indexFunc", "index_add", "scatter_add",
                         "index_put"))):
        if any(n in name for n in needles):
            return group
    low = name.lower()
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "GEMM"
    if "elementwise" in low or "reduce" in low:
        return "Adam and elementwise"
    return "other"


def _device_breakdown(prof, runs, group=None):
    """Device ms per run by kernel group (``group(name)``, by default
    ``_kernel_group``), and the busiest kernels."""
    group = group or _kernel_group
    groups, top = {}, []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        # kernel rows only: a CPU op's row repeats its kernels' time
        if not dev_us or not str(getattr(ev, "device_type", "")).endswith(
                "CUDA"):
            continue
        ms = dev_us / 1e3 / runs
        g = group(ev.key)
        groups[g] = groups.get(g, 0.0) + ms
        top.append((ms, ev.count // runs, ev.key[:90]))
    top.sort(reverse=True)
    return groups, top


def _step_profile(exe, main, batch, loss, group=None, runs=2, top_n=15):
    """The host's time to enqueue a training step (three times, nothing
    waited for), then ``runs`` steps under ``torch.profiler``: device ms
    per step by kernel group (``_device_breakdown``), the idle share of
    the profiled wall time, the busiest kernels and host ops."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    dispatch_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        exe.run(main, feed=batch, fetch_list=[loss], return_numpy=False)
        dispatch_ms.append((time.perf_counter() - s0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s0 = time.perf_counter()
        for _ in range(runs):
            exe.run(main, feed=batch, fetch_list=[loss])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - s0) * 1e3 / runs
    group = group or _kernel_group
    groups, top = _device_breakdown(prof, runs, group)
    host = sorted((ev for ev in prof.key_averages()
                   if ev.self_cpu_time_total > 0),
                  key=lambda ev: -ev.self_cpu_time_total)
    busy = sum(groups.values())
    return {"dispatch_ms": dispatch_ms,
            "median_dispatch_ms": statistics.median(dispatch_ms),
            "host_top_ops_under_profiler": [
                {"ms": ev.self_cpu_time_total / 1e3 / runs,
                 "calls": ev.count // runs, "name": ev.key[:60]}
                for ev in host[:top_n]],
            "wall_ms_per_step": wall_ms,
            "device_ms_per_step": busy if busy else "not measured",
            "device_idle_share": (1.0 - busy / wall_ms) if busy
            else "not measured",
            "device_ms_by_group": groups,
            "top_kernels": [{"ms": t, "launches": n, "group": group(k),
                             "name": k} for t, n, k in top[:top_n]]}


def phase_profile(env, pred, cfg, runs=3):
    """Where the time of one served batch goes, on the main path's
    predictor: per bucket, the median host wall time of ``predictor.run``
    (dispatch, device work, one batched device→host copy) and of
    ``run_async`` alone (the eager op-by-op enqueue); for bucket 8, device
    time by kernel group from ``torch.profiler`` over ``runs`` batches and
    the device's idle share over that window."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(SEED + 2)
    for rows in BUCKETS:
        feed = _bert_request(rng, rows, cfg)
        lat = _median_ms(lambda: pred.run(feed))
        disp = _median_ms(lambda: pred.run_async(feed))
        torch.cuda.synchronize()
        emit({"phase": "profile", "bucket": rows, "latency_ms": lat,
              "dispatch_ms": disp, "tokens_per_s": rows * SEQ / (lat / 1e3),
              "card": card_label(env)})
    feed = _bert_request(rng, BUCKETS[-1], cfg)
    pred.run(feed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            pred.run(feed)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / runs
    groups, top = _device_breakdown(prof, runs)
    busy = sum(groups.values())
    emit({"phase": "profile", "bucket": BUCKETS[-1],
          "wall_ms_per_batch": wall_ms,
          "device_ms_per_batch": busy if busy else "not measured",
          "device_idle_share": (1.0 - busy / wall_ms) if busy
          else "not measured",
          "device_ms_by_group": groups,
          "top_kernels": [{"ms": t, "launches": n, "name": k}
                          for t, n, k in top[:12]],
          "card": card_label(env)})


def _train_program(fluid, bert, cfg, seq):
    main, startup, _feeds, loss = bert.build_pretrain(cfg, seq_len=seq,
                                                      lr=TRAIN_LR)
    main.random_seed = startup.random_seed = SEED
    return main, startup, loss


def _grad_names(main):
    """param name → its gradient var, read off the adam ops."""
    return {op.inputs["Param"][0]: op.inputs["Grad"][0]
            for op in main.global_block().ops if op.type == "adam"}


def phase_train(env):
    """BERT-base MLM pretraining at T=512, B=8, dropout 0.1, Adam, on the
    card: warm-up steps, then timed steps on one repeated batch with the
    launch counts read around them, peak memory, and a profiled window."""
    import statistics

    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops.cuda import (KERNELS, launch_counts,
                                           reset_launch_counts)
    from paddle_tpu_torch.static_analysis import fusion

    cfg = bert.BERT_BASE  # dropout 0.1, attention dropout 0.1
    t0 = time.time()
    main, startup, loss = _train_program(fluid, bert, cfg, SEQ)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup)
        torch.cuda.synchronize()
        prog, report = fusion.resolve_fused_program(main,
                                                    targets=[loss.name])
        op_types = {}
        for op in prog.global_block().ops:
            op_types[op.type] = op_types.get(op.type, 0) + 1
        emit({"phase": "train", "step": "build+startup",
              "seconds": time.time() - t0, "ops_per_step": sum(
                  op_types.values()), "fused": report.counts(),
              "op_types": op_types})
        batch = bert.make_fake_batch(TRAIN_BATCH, SEQ, cfg,
                                     np.random.RandomState(SEED))
        losses = []
        for _ in range(TRAIN_WARMUP):
            losses.append(float(exe.run(main, feed=batch,
                                        fetch_list=[loss])[0][0]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        step_ms = []
        for _ in range(TRAIN_STEPS):
            s0 = time.perf_counter()
            losses.append(float(exe.run(main, feed=batch,
                                        fetch_list=[loss])[0][0]))
            step_ms.append((time.perf_counter() - s0) * 1e3)
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        per_step = {k: c / TRAIN_STEPS for k, c in counts.items()}
        want = dict.fromkeys(KERNELS, 0.0)
        want.update({"flash_attention_fwd": 12, "flash_attention_bwd_dkv": 12,
                     "flash_attention_bwd_dq": 12,
                     "fused_dropout_add_ln_fwd": 25,
                     "fused_dropout_add_ln_bwd": 25,
                     "embedding_gather_fwd": 3})
        med = statistics.median(step_ms)
        emit({"phase": "train", "step": "steps", "card": card_label(env),
              "losses": losses, "step_ms": step_ms, "median_step_ms": med,
              "tokens_per_s": TRAIN_BATCH * SEQ / (med / 1e3),
              "launches_per_step": per_step, "expected": want,
              "peak_memory_bytes": peak})
        if per_step != want:
            raise AssertionError("launches per step %s != %s"
                                 % (per_step, want))
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError("loss not finite and falling: %s" % losses)

        emit(dict({"phase": "train", "step": "profile",
                   "card": card_label(env)},
                  **_step_profile(exe, main, batch, loss)))
    del scope, exe
    torch.cuda.empty_cache()
    return counts


def phase_train_parity():
    """One dropout-0.1 step of a 2-layer BERT at BERT-base width (B=2,
    T=512) on the card and on the CPU with the plain versions: the seeded
    start is the same on both, and so is every dropout mask (the card
    generator has a plain twin)."""
    import copy

    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert

    cfg = copy.copy(bert.BERT_BASE)
    cfg.layers = 2
    main, startup, loss = _train_program(fluid, bert, cfg, SEQ)
    grads = _grad_names(main)
    names = ["bert.word_emb", "bert.layer0.attn.q.w", "bert.layer0.ln1.scale"]
    fetch = [loss.name] + [grads[n] for n in names]
    batch = bert.make_fake_batch(2, SEQ, cfg, np.random.RandomState(SEED + 3))
    out = {}
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = fluid.Executor(place)
            exe.run(startup)
            out[place._kind] = exe.run(main, feed=batch, fetch_list=fetch)
        del scope, exe
    gpu, cpu = out["cuda"], out["cpu"]
    result = {"phase": "train_parity", "step": "GPU kernels vs CPU plain "
              "versions, one step, dropout 0.1",
              "loss": [float(gpu[0][0]), float(cpu[0][0])],
              "loss_rel_err": abs(float(gpu[0][0] - cpu[0][0]))
              / abs(float(cpu[0][0])), "loss_tol": PARITY_LOSS_RTOL}
    ok = result["loss_rel_err"] <= PARITY_LOSS_RTOL
    for name, g, c in zip(names, gpu[1:], cpu[1:]):
        err = float(np.abs(g - c).max()) / max(float(np.abs(c).max()), 1e-30)
        result[name + "@GRAD rel_err"] = err
        ok = ok and np.isfinite(g).all() and err <= PARITY_GRAD_RTOL
    result["grad_tol"] = PARITY_GRAD_RTOL
    emit(result)
    if not ok:
        raise AssertionError("train parity failed: %s" % result)


def _decode_engine(cfg, paged, place, params=None, name="gpt2"):
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models import gpt

    return serving.DecodeEngine(
        gpt.DecodeAdapter(cfg, seed=SEED, params=params),
        slots=DECODE_SLOTS, prompt_buckets=DECODE_BUCKETS,
        config=serving.GenerationConfig(max_new_tokens=DECODE_NEW_TOKENS),
        place=place, name=name, paged=paged, auto_start=False)


def _logits_var(program):
    return next(op.input("X")[0] for op in program.global_block().ops
                if op.type == "top_k_sampling")


def _decode_drive(eng, prompts, steps, forced=None):
    """Run an engine's programs directly, as its scheduler does: prefill
    ``prompts`` into slots 0, 1, ... (paged: each slot owns its own
    blocks in reverse order), then ``steps`` greedy steps of every slot
    (the other slots inactive: token 0, cursor 0, table -1).  Returns the
    logits and tokens of every stage; ``forced`` (another drive's tokens)
    feeds those tokens instead of this drive's own."""
    import numpy as np

    mb = eng.max_blocks
    tables = np.full((eng.slots, max(mb, 1)), -1, "int32")
    cur = np.zeros(eng.slots, "int32")
    cursors = np.zeros(eng.slots, "int32")
    stages, toks = [], []

    def record(logits, tok):
        stages.append(np.asarray(logits))
        toks.append(np.asarray(tok).reshape(-1))
        return toks[-1] if forced is None else forced[len(toks) - 1]

    for slot, p in enumerate(prompts):
        length = eng.buckets.bucket_for_seq(p.size)
        main, fetch = eng._prefill[length]
        padded = np.zeros((1, length), "int32")
        padded[0, :p.size] = p
        feed = {"prompt_ids": padded,
                "prompt_len": np.asarray([p.size], "int32")}
        if eng.paged:
            tables[slot] = np.arange((slot + 1) * mb - 1, slot * mb - 1, -1)
            feed["block_table"] = tables[slot:slot + 1]
        else:
            feed["slot"] = np.asarray([slot], "int32")
        cur[slot] = record(*eng._exe.run(
            main, feed=feed, fetch_list=[_logits_var(main), fetch],
            scope=eng.scope))[0]
        cursors[slot] = p.size
    live = len(prompts)
    for i in range(steps):
        feed = {"cur_ids": cur.copy(), "cursors": cursors.copy(),
                "step": np.asarray([i + 1], "int32")}
        if eng.paged:
            feed["block_tables"] = tables
        nxt = record(*eng._exe.run(
            eng._step_prog, feed=feed,
            fetch_list=[_logits_var(eng._step_prog), eng._step_fetch],
            scope=eng.scope))
        cur[:live] = nxt[:live]
        cursors[:live] += 1
    return stages, toks


def _decode_launches(cfg, paged, steps, prefills):
    """Launches of ``steps`` decode steps and ``prefills`` prefills: per
    step one K5 (ring) or K6 (paged) per layer, one K2 per residual add
    + LN (two per layer; ``lnf`` has no add) and K3 for wte and wpe; per
    prefill one causal K1 per layer, the same K2 and K3."""
    from paddle_tpu_torch.ops.cuda import KERNELS

    want = dict.fromkeys(KERNELS, 0)
    want["paged_flash_decode_fwd" if paged else "flash_decode_fwd"] = \
        cfg.layers * steps
    want["flash_attention_fwd"] = cfg.layers * prefills
    want["fused_dropout_add_ln_fwd"] = 2 * cfg.layers * (steps + prefills)
    want["embedding_gather_fwd"] = 2 * (steps + prefills)
    return want


def _decode_step_feed(eng, rng, vocab):
    """A step of all slots active, at cursors from a tenth to 45% of the
    cache depth (paged: each slot owns a full-depth table)."""
    import numpy as np

    feed = {"cur_ids": rng.randint(1, vocab - 1, eng.slots).astype("int32"),
            "cursors": np.linspace(eng.max_len // 10, eng.max_len * 45 // 100,
                                   eng.slots).astype("int32"),
            "step": np.asarray([1], "int32")}
    if eng.paged:
        mb = eng.max_blocks
        feed["block_tables"] = np.arange(eng.slots * mb, dtype="int32"
                                         ).reshape(eng.slots, mb)
    return feed


def _decode_profile(env, eng, mode, rng, vocab, runs=DECODE_PROFILE_STEPS):
    """The host's time to enqueue one all-slots step, and the device time
    by kernel group and the idle share over ``runs`` profiled steps."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    feed = _decode_step_feed(eng, rng, vocab)
    run = lambda **kw: eng._exe.run(  # noqa: E731
        eng._step_prog, feed=feed, fetch_list=[eng._step_fetch],
        scope=eng.scope, **kw)
    run()
    enqueue_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        run(return_numpy=False)
        enqueue_ms.append((time.perf_counter() - s0) * 1e3)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s0 = time.perf_counter()
        for _ in range(runs):
            run()
        wall_ms = (time.perf_counter() - s0) * 1e3 / runs
    groups, top = _device_breakdown(prof, runs)
    busy = sum(groups.values())
    emit({"phase": "decode", "mode": mode, "step": "profile",
          "card": card_label(env), "slots_active": eng.slots,
          "enqueue_ms": enqueue_ms,
          "median_enqueue_ms": statistics.median(enqueue_ms),
          "wall_ms_per_step": wall_ms,
          "device_ms_per_step": busy if busy else "not measured",
          "device_idle_share": (1.0 - busy / wall_ms) if busy
          else "not measured",
          "device_ms_by_group": groups,
          "top_kernels": [{"ms": t, "launches": n, "name": k}
                          for t, n, k in top[:12]]})


def phase_decode(env):
    """GPT-2-small widths served by a PredictorServer decode tenant, ring
    then paged: 16 requests of seeded prompt lengths 32-500 on 8 slots,
    greedy, 64 new tokens each, after one warm-up request per prompt
    bucket.  Every request must complete with tokens in the vocabulary,
    ring and paged must give the same tokens, and the launch counters
    must rise by the per-step and per-prefill counts.  Then per mode the
    enqueue time and device breakdown of a step, and whether the two
    modes' logits agree bit for bit on a direct drive."""
    import statistics

    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from paddle_tpu_torch.static_analysis import fusion

    cfg = gpt.GPT2_SMALL_WIDTHS
    rng = np.random.RandomState(SEED + 4)
    lens = rng.randint(DECODE_PROMPT_LENS[0], DECODE_PROMPT_LENS[1] + 1,
                       DECODE_REQUESTS)
    prompts = [rng.randint(1, cfg.vocab - 1, size=n).astype("int32")
               for n in lens]
    tokens, counts, engines = {}, {}, {}
    for paged in (False, True):
        mode = "paged" if paged else "ring"
        t0 = time.time()
        eng = _decode_engine(cfg, paged, fluid.CUDAPlace(0))
        torch.cuda.synchronize()
        fused = {}
        for label, prog, fetch in (
                [("step", eng._step_prog, eng._step_fetch)]
                + [("prefill%d" % n, p, f)
                   for n, (p, f) in sorted(eng._prefill.items())]):
            prog, report = fusion.resolve_fused_program(prog,
                                                        targets=[fetch])
            fused[label] = {"ops": len(prog.global_block().ops),
                            "fused": report.counts()}
        emit({"phase": "decode", "mode": mode, "step": "build",
              "seconds": time.time() - t0, "programs": fused,
              "kv_cache_bytes": eng.cache_bytes})
        server = serving.PredictorServer({"gpt2": eng}, verify=False)
        try:
            warm = [server.submit("gpt2", p) for p in (
                rng.randint(1, cfg.vocab - 1, b // 2 + 1).astype("int32")
                for b in DECODE_BUCKETS)]
            for f in warm:
                f.result(timeout=600)
            torch.cuda.synchronize()
            st0 = eng.stats()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t_start = time.time()
            futs = [server.submit("gpt2", p, request_id=i)
                    for i, p in enumerate(prompts)]
            outs = [f.result(timeout=900) for f in futs]
            torch.cuda.synchronize()
            wall_s = time.time() - t_start
            counts[mode] = launch_counts()
            st1 = eng.stats()
        finally:
            server.close()
        steps = st1["decode_steps"] - st0["decode_steps"]
        prefills = st1["prefills"] - st0["prefills"]
        want = _decode_launches(cfg, paged, steps, prefills)
        step_ms = (st1["step_ms_mean"] * st1["decode_steps"]
                   - st0["step_ms_mean"] * st0["decode_steps"]) / steps
        prefill_ms = (st1["prefill_ms_mean"] * st1["prefills"]
                      - st0["prefill_ms_mean"] * st0["prefills"]) / prefills
        tokens[mode] = [list(t) for t, _ in outs]
        ttft = [info["ttft_ms"] for _, info in outs]
        lat = [info["latency_ms"] for _, info in outs]
        n_tok = sum(len(t) for t in tokens[mode])
        emit({"phase": "decode", "mode": mode, "step": "serve",
              "card": card_label(env), "requests": len(outs),
              "prompt_lens": [int(n) for n in lens],
              "tokens": n_tok, "wall_s": wall_s,
              "tokens_per_s": n_tok / wall_s,
              "ttft_ms_median": statistics.median(ttft),
              "ttft_ms_max": max(ttft),
              "latency_ms_median": statistics.median(lat),
              "latency_ms_max": max(lat),
              "decode_steps": steps, "prefills": prefills,
              "step_ms_mean": step_ms, "prefill_ms_mean": prefill_ms,
              "peak_memory_bytes": torch.cuda.max_memory_allocated(),
              "kv_cache_bytes": st1["kv_cache_bytes"],
              "launches": counts[mode], "expected_launches": want})
        if counts[mode] != want:
            raise AssertionError("%s: launches %s != %s for %d steps, %d "
                                 "prefills" % (mode, counts[mode], want,
                                               steps, prefills))
        bad = [i for i, t in enumerate(tokens[mode])
               if len(t) != DECODE_NEW_TOKENS
               or not all(0 <= x < cfg.vocab for x in t)]
        if len(outs) != DECODE_REQUESTS or bad:
            raise AssertionError("%s: requests %s incomplete or out of the "
                                 "vocabulary" % (mode, bad))
        _decode_profile(env, eng, mode, rng, cfg.vocab)
        engines[mode] = eng
    ring_logits, _ = _decode_drive(engines["ring"], prompts[:3], 4)
    paged_logits, _ = _decode_drive(engines["paged"], prompts[:3], 4)
    same_logits = all(np.array_equal(a, b)
                      for a, b in zip(ring_logits, paged_logits))
    emit({"phase": "decode", "step": "ring vs paged",
          "tokens_equal": tokens["ring"] == tokens["paged"],
          "logits_bit_identical": same_logits,
          "logits_max_abs_diff": max(float(np.abs(a - b).max())
                                     for a, b in zip(ring_logits,
                                                     paged_logits))})
    if tokens["ring"] != tokens["paged"]:
        raise AssertionError("ring and paged generated different tokens")
    del engines
    torch.cuda.empty_cache()
    return counts


def _greedy_mismatches(got, ref):
    """Rows whose argmax differs where the reference's top-2 margin is
    above GREEDY_MARGIN, and the rows with a smaller margin."""
    import numpy as np

    top2 = np.sort(ref, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > GREEDY_MARGIN
    differ = np.argmax(got, -1) != np.argmax(ref, -1)
    return int((differ & clear).sum()), int((~clear).sum())


def phase_decode_parity():
    """A 2-layer decoder at GPT-2-small width on the card and on the CPU
    (plain versions) from one seeded parameter dict: 3 prompts prefilled,
    then 8 greedy steps of all 8 slots, ring and paged, the CPU fed the
    card's tokens.  Logits agree within DECODE_PARITY_RTOL of the largest
    and the greedy tokens agree wherever the margin allows."""
    import copy

    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import gpt

    cfg = copy.copy(gpt.GPT2_SMALL_WIDTHS)
    cfg.layers = 2
    rng = np.random.RandomState(SEED + 5)
    prompts = [rng.randint(1, cfg.vocab - 1, size=n).astype("int32")
               for n in DECODE_PARITY_PROMPTS]
    first = _decode_engine(cfg, False, fluid.CUDAPlace(0))
    params = {p.name: first.scope.get(p.name).cpu().numpy()
              for p in first._step_prog.all_parameters()}
    ok = True
    for paged in (False, True):
        gpu = first if not paged else _decode_engine(
            cfg, True, fluid.CUDAPlace(0), params)
        cpu = _decode_engine(cfg, paged, fluid.CPUPlace(), params)
        g_logits, g_toks = _decode_drive(gpu, prompts, DECODE_PARITY_STEPS)
        c_logits, _ = _decode_drive(cpu, prompts, DECODE_PARITY_STEPS,
                                    forced=g_toks)
        rel = max(float(np.abs(g - c).max()) / float(np.abs(c).max())
                  for g, c in zip(g_logits, c_logits))
        miss = [_greedy_mismatches(g, c) for g, c in zip(g_logits, c_logits)]
        result = {"phase": "decode_parity",
                  "mode": "paged" if paged else "ring",
                  "step": "GPU kernels vs CPU plain versions, prefill of %s "
                  "+ %d steps, 2 layers at GPT-2-small width"
                  % (list(DECODE_PARITY_PROMPTS), DECODE_PARITY_STEPS),
                  "logits_rel_err": rel, "tol": DECODE_PARITY_RTOL,
                  "token_mismatches": sum(m for m, _ in miss),
                  "rows_below_margin": sum(n for _, n in miss),
                  "margin": GREEDY_MARGIN}
        emit(result)
        ok = ok and rel <= DECODE_PARITY_RTOL \
            and result["token_mismatches"] == 0
        del gpu, cpu
    del first
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("decode parity failed")


def _resnet_group(name):
    """The ResNet profile's group of a device kernel, by its name."""
    low = name.lower()
    for group, needles in (
            ("K4 fwd", ("bn_act_fwd_kernel",)),
            ("K4 bwd", ("bn_act_bwd_kernel", "bn_act_bwd_reduce_kernel")),
            ("conv bwd", ("dgrad", "wgrad", "convolve_dgrad",
                          "convolve_wgrad", "backward_data",
                          "backward_filter")),
            ("conv FFT and cuDNN helpers (fwd or bwd)", (
                "fft", "cf32", "scalepackedtensor")),
            ("conv fwd", ("fprop", "convolve_sgemm", "conv2d_", "winograd",
                          "implicit_gemm", "implicit_convolve")),
            ("layout copies", ("nchwtonhwc", "nhwctonchw", "direct_copy",
                               "copy_kernel", "transpose")),
            ("pooling", ("pool",)),
            ("BN statistics and reductions", ("reduce_kernel", "reduce")),
            ("GEMM (fc)", ("gemm", "cutlass", "xmma"))):
        if any(n.lower() in low for n in needles):
            return group
    if "elementwise" in low or "vectorized" in low:
        return "Momentum and elementwise"
    return "other"


def _aten_calls_per_op(exe, program, feed, fetch):
    """ATen calls per program op in one step, by op type: a
    ``TorchDispatchMode`` counts what each op's lowering dispatches (the
    grad ops' autograd backward included; a kernel launch through ctypes
    is not an ATen call)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from paddle_tpu_torch.ops import registry

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    per = {}
    orig = registry.call_op

    def counted(opdef, *args, **kwargs):
        with Count() as c:
            out = orig(opdef, *args, **kwargs)
        tot = per.setdefault(opdef.type, [0, 0])
        tot[0] += 1
        tot[1] += c.n
        return out

    registry.call_op = counted
    try:
        exe.run(program, feed=feed, fetch_list=fetch)
    finally:
        registry.call_op = orig
    return {t: {"ops": n, "aten_calls_per_op": a / n}
            for t, (n, a) in sorted(per.items(), key=lambda kv: -kv[1][1])}


def _resnet_program(fluid, resnet, hw):
    """``resnet.build(dataset="imagenet", depth=50, data_format="NHWC")``
    at an hw x hw input (``build`` declares 224 x 224): the training
    program with Momentum as ``build`` sets it, and the eval clone."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[hw, hw, 3], dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        logits = resnet.resnet_imagenet(img, 1000, 50, False, "NHWC")
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        acc = fluid.layers.accuracy(fluid.layers.softmax(logits), label)
        fluid.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                 use_nesterov=True).minimize(loss)
    return main, startup, main.clone(for_test=True), loss, acc


def _resnet_batch(np, rng, batch, hw):
    """Seeded images and labels in [0, 10), as the reference's ResNet
    bench draws them."""
    return {"img": rng.randn(batch, hw, hw, 3).astype("float32"),
            "label": rng.randint(0, 10, (batch, 1)).astype("int64")}


def phase_resnet(env):
    """ResNet-50 NHWC (``models/resnet.build``) trained at batch 64,
    224x224, float32 with TF32 off, Momentum (lr 0.1, 0.9, Nesterov) on
    the card: warm-up steps, then timed steps on one repeated batch with
    the launch counts read around them, one eval batch through the
    for-test clone, the host's enqueue time and a profiled window."""
    import statistics

    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.ops.cuda import (KERNELS, launch_counts,
                                           reset_launch_counts)
    from paddle_tpu_torch.static_analysis import fusion

    t0 = time.time()
    main, startup, _feeds, loss, acc = resnet.build(
        dataset="imagenet", depth=50, data_format="NHWC")
    main.random_seed = startup.random_seed = SEED
    test = main.clone(for_test=True)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup)
        torch.cuda.synchronize()
        prog, report = fusion.resolve_fused_program(
            main, targets=[loss.name, acc.name])
        op_types = {}
        for op in prog.global_block().ops:
            op_types[op.type] = op_types.get(op.type, 0) + 1
        emit({"phase": "resnet", "step": "build+startup",
              "seconds": time.time() - t0, "ops_per_step": sum(
                  op_types.values()), "fused": report.counts(),
              "op_types": op_types, "parameters": sum(
                  p.numel() for p in (scope.get(v.name)
                                      for v in main.all_parameters()
                                      if v.trainable))})
        if report.counts() != {"conv_bn_act": RESNET_SITES}:
            raise AssertionError("fused %s, expected %d conv_bn_act sites"
                                 % (report.counts(), RESNET_SITES))
        # the batch lies on the card, as an input pipeline leaves it
        batch = {k: torch.from_numpy(v).cuda() for k, v in _resnet_batch(
            np, np.random.RandomState(SEED), RESNET_BATCH,
            RESNET_HW).items()}
        losses = []
        for _ in range(RESNET_WARMUP):
            losses.append(float(exe.run(main, feed=batch,
                                        fetch_list=[loss])[0][0]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        step_ms = []
        for _ in range(RESNET_STEPS):
            s0 = time.perf_counter()
            out = exe.run(main, feed=batch, fetch_list=[loss, acc])
            step_ms.append((time.perf_counter() - s0) * 1e3)
            losses.append(float(out[0][0]))
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        per_step = {k: c / RESNET_STEPS for k, c in counts.items()}
        want = dict.fromkeys(KERNELS, 0.0)
        want.update({"bn_act_epilogue_fwd": RESNET_SITES,
                     "bn_act_epilogue_bwd": RESNET_SITES})
        med = statistics.median(step_ms)
        emit({"phase": "resnet", "step": "steps", "card": card_label(env),
              "batch": RESNET_BATCH, "image": RESNET_HW, "losses": losses,
              "step_ms": step_ms, "median_step_ms": med,
              "images_per_s": RESNET_BATCH / (med / 1e3),
              "launches_per_step": per_step, "expected": want,
              "peak_memory_bytes": peak})
        if per_step != want:
            raise AssertionError("launches per step %s != %s"
                                 % (per_step, want))
        if not all(np.isfinite(losses)):
            raise AssertionError("loss not finite: %s" % losses)

        reset_launch_counts()
        s0 = time.perf_counter()
        ev_loss, ev_acc = exe.run(test, feed=batch, fetch_list=[loss, acc])
        ev_ms = (time.perf_counter() - s0) * 1e3
        ev_counts = launch_counts()
        want_ev = dict.fromkeys(KERNELS, 0)
        want_ev["bn_act_epilogue_fwd"] = RESNET_SITES
        emit({"phase": "resnet", "step": "eval", "loss": float(ev_loss[0]),
              "acc": float(ev_acc[0]), "ms": ev_ms, "launches": ev_counts,
              "expected": want_ev})
        if ev_counts != want_ev or not np.isfinite(ev_loss).all():
            raise AssertionError("eval batch: launches %s (want %s), loss "
                                 "%s" % (ev_counts, want_ev, ev_loss))

        prof = _step_profile(exe, main, batch, loss, _resnet_group,
                             top_n=25)
        busy = prof["device_ms_per_step"]
        aten = _aten_calls_per_op(exe, main, batch, [loss])
        emit(dict({
            "phase": "resnet", "step": "profile", "card": card_label(env),
            # the profiler slows the host: against the unprofiled step
            "device_idle_share_of_median_step": (1.0 - busy / med)
            if busy != "not measured" else busy,
            "aten_calls_per_step": sum(v["ops"] * v["aten_calls_per_op"]
                                       for v in aten.values()),
            "aten_calls_by_op_type": aten}, **prof))
    del scope, exe, batch
    torch.cuda.empty_cache()
    return counts


def _resnet_parity_run(fluid, convert, main, startup, fetch, batch, place,
                       start, fuse):
    """One training step → (fetches, persistables before it, after it);
    ``start`` (a persistables dict) is loaded over the startup's values
    when given.  ``fuse`` False runs it with the fusion pipeline off."""
    prev = os.environ.get("PADDLE_TPU_FUSION")
    os.environ["PADDLE_TPU_FUSION"] = "1" if fuse else "0"
    try:
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = fluid.Executor(place)
            exe.run(startup)
            if start is not None:
                convert.load_params_into_scope(start, scope, place,
                                               program=main)
            before = convert.scope_persistables(main, scope)
            out = exe.run(main, feed=batch, fetch_list=fetch)
            return out, before, convert.scope_persistables(main, scope)
    finally:
        if prev is None:
            os.environ.pop("PADDLE_TPU_FUSION", None)
        else:
            os.environ["PADDLE_TPU_FUSION"] = prev


def _fused_site_parity(fluid, convert, np):
    """One fused conv -> batch_norm site, card against CPU → max
    relative errors of Out and the four gradients."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[56, 56, 64], dtype="float32")
        x.stop_gradient = False
        conv = fluid.layers.conv2d(x, 64, 3, padding=1, bias_attr=False,
                                   data_format="NHWC")
        out = fluid.layers.batch_norm(conv, data_layout="NHWC")
        w = fluid.layers.data("w", shape=[56, 56, 64], dtype="float32")
        loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(out, w))
        wrt = [x] + [p for p in main.all_parameters() if p.trainable]
        fetch = [out] + fluid.gradients([loss], wrt)
    rng = np.random.RandomState(SEED + 6)
    feed = {"x": rng.randn(4, 56, 56, 64).astype("float32"),
            "w": rng.randn(4, 56, 56, 64).astype("float32")}
    got = {}
    start = None
    for kind, place in (("cpu", fluid.CPUPlace()),
                        ("cuda", fluid.CUDAPlace(0))):
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = fluid.Executor(place)
            exe.run(startup)
            if start is None:
                start = convert.scope_persistables(main, scope)
            else:
                convert.load_params_into_scope(start, scope, place,
                                               program=main)
            got[kind] = exe.run(main, feed=feed, fetch_list=fetch)
    return {name: float(np.abs(g - c).max()) / max(float(np.abs(c).max()),
                                                   1e-30)
            for name, g, c in zip(("Out", "Input@GRAD", "Filter@GRAD",
                                   "Scale@GRAD", "Bias@GRAD"),
                                  got["cuda"], got["cpu"])}


def phase_resnet_parity():
    """Full-depth ResNet-50 NHWC at 64x64, batch 4, one Momentum step
    from one parameter dict (the CPU startup's, carried with
    ``convert``): on the card through the K4 kernels, on the card with
    fusion off (the unfused ops, no K4), and on the CPU with the plain
    versions.  Compared: the loss, the stem filter's, a stage-3
    batch_norm scale's and the fc weight's gradients, and the 130 moving
    statistics after the step; and one fused site alone, card against
    CPU."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models import resnet

    main, startup, _test, loss, _acc = _resnet_program(
        fluid, resnet, RESNET_PARITY_HW)
    grads = {op.inputs["Param"][0]: op.inputs["Grad"][0]
             for op in main.global_block().ops if op.type == "momentum"}
    deep = ["conv2d_0.w_0", "batch_norm_40.w_0"]
    names = deep + ["fc_0.w_0"]
    moving = sorted(p.name for p in main.all_parameters()
                    if not p.trainable)
    trainable = sorted(p.name for p in main.all_parameters() if p.trainable)
    ops = main.global_block().ops
    sites = [(i, op.outputs["Out"][0]) for i, op in enumerate(ops)
             if op.type == "relu"]
    reader = {}
    for i, op in enumerate(ops):
        if op.attrs.get("op_role") not in ("backward", "optimize"):
            for n in op.input_arg_names:
                reader.setdefault(n, i)
    fetch = [loss.name] + [grads[n] for n in names] \
        + [n for _, n in sites] + [grads[n] for n in trainable]
    nf = 1 + len(names)
    batch = _resnet_batch(np, np.random.RandomState(SEED + 5),
                          RESNET_PARITY_BATCH, RESNET_PARITY_HW)
    cpu, start, cpu_after = _resnet_parity_run(
        fluid, convert, main, startup, fetch, batch, fluid.CPUPlace(), None,
        True)
    runs = {"cpu": (cpu, cpu_after)}
    for kind, fuse in (("cuda_k4", True), ("cuda_unfused", False)):
        out, _, after = _resnet_parity_run(
            fluid, convert, main, startup, fetch, batch, fluid.CUDAPlace(0),
            start, fuse)
        runs[kind] = (out, after)

    def max_rel(a, b):
        return float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                1e-30)

    def compare(a, b):
        (fa, sa), (fb, sb) = runs[a], runs[b]
        res = {"loss": [float(fa[0][0]), float(fb[0][0])],
               "loss_rel_err": abs(float(fa[0][0] - fb[0][0]))
               / abs(float(fb[0][0]))}
        # the relu masks site by site, and the first flipped site from
        # the head
        flips, kept = [], 0.0
        for k in range(len(sites)):
            x, y = fa[nf + k], fb[nf + k]
            f = (x > 0) != (y > 0)
            flips.append(int(f.sum()))
            if f.any():
                kept = max(kept, float(np.maximum(x[f], y[f]).max())
                           / max(float(np.abs(y).max()), 1e-30))
        top = max([sites[k][0] for k in range(len(sites)) if flips[k]],
                  default=-1)
        above = [n for n in trainable if reader[n] > top]
        res["relu_flips_per_site"] = flips
        res["flipped_unit_max_over_site_max"] = kept
        res["first_flipped_site_from_head"] = max(
            [k for k in range(len(sites)) if flips[k]], default=None)
        res["params_above_first_flip"] = len(above)
        res["above_flip_grad_max_rel_err"] = max(
            [max_rel(fa[nf + len(sites) + trainable.index(n)],
                     fb[nf + len(sites) + trainable.index(n)])
             for n in above], default=0.0)
        res["below_flip_grad_l2_rel_err"] = max(
            [float(np.linalg.norm(fa[nf + len(sites) + j]
                                  - fb[nf + len(sites) + j])
                   / max(np.linalg.norm(fb[nf + len(sites) + j]), 1e-30))
             for j, n in enumerate(trainable) if n not in above],
            default=0.0)
        for name, g, c in zip(names, fa[1:], fb[1:]):
            res[name + "@GRAD max_rel_err"] = max_rel(g, c)
            res[name + "@GRAD l2_rel_err"] = float(
                np.linalg.norm(g - c) / max(np.linalg.norm(c), 1e-30))
            res[name + "@GRAD finite"] = bool(np.isfinite(g).all())
        res["moving_stats_max_rel_err"] = max(max_rel(sa[k], sb[k])
                                              for k in moving)
        res["moving_stats_moved"] = sum(
            not np.array_equal(sa[k], start[k]) for k in moving)
        return res

    card = compare("cuda_k4", "cuda_unfused")
    ok = all(card[n + "@GRAD finite"] for n in names) \
        and card["loss_rel_err"] <= PARITY_RESNET_RTOL \
        and card["moving_stats_max_rel_err"] <= PARITY_RESNET_RTOL \
        and all(card[n + "@GRAD max_rel_err"] <= PARITY_RESNET_RTOL
                for n in names) \
        and card["above_flip_grad_max_rel_err"] <= PARITY_RESNET_RTOL \
        and card["below_flip_grad_l2_rel_err"] \
        <= PARITY_RESNET_CPU_DEEP_RTOL
    emit(dict({"phase": "resnet_parity", "step": "card: K4 path vs fusion "
               "off (unfused ops, same cuDNN convolutions), one Momentum "
               "step, ResNet-50 NHWC %dx%d batch %d" % (
                   RESNET_PARITY_HW, RESNET_PARITY_HW, RESNET_PARITY_BATCH),
               "tol": PARITY_RESNET_RTOL, "ok": ok}, **card))
    site = _fused_site_parity(fluid, convert, np)
    ok_site = all(e <= PARITY_RESNET_SITE_RTOL for e in site.values())
    emit({"phase": "resnet_parity", "step": "card vs CPU, one fused conv "
          "-> batch_norm site [4, 56, 56, 64] NHWC (identity act)",
          "max_rel_err": site, "tol": PARITY_RESNET_SITE_RTOL,
          "ok": ok_site})
    vs_cpu = compare("cuda_k4", "cpu")
    ok_cpu = all(vs_cpu[n + "@GRAD finite"] for n in names) \
        and vs_cpu["loss_rel_err"] <= PARITY_RESNET_CPU_RTOL \
        and vs_cpu["fc_0.w_0@GRAD max_rel_err"] \
        <= PARITY_RESNET_CPU_FWD_RTOL \
        and vs_cpu["moving_stats_max_rel_err"] \
        <= PARITY_RESNET_CPU_FWD_RTOL \
        and vs_cpu["moving_stats_moved"] == len(moving) \
        and all(vs_cpu[n + "@GRAD l2_rel_err"] <= PARITY_RESNET_CPU_DEEP_RTOL
                for n in deep) \
        and vs_cpu["flipped_unit_max_over_site_max"] \
        <= PARITY_RESNET_FLIP_ATOL \
        and vs_cpu["params_above_first_flip"] >= 2 \
        and vs_cpu["above_flip_grad_max_rel_err"] \
        <= PARITY_RESNET_CPU_FWD_RTOL \
        and vs_cpu["below_flip_grad_l2_rel_err"] \
        <= PARITY_RESNET_CPU_DEEP_RTOL
    emit(dict({"phase": "resnet_parity", "step": "card (K4) vs CPU plain "
               "versions, the same step", "loss_tol": PARITY_RESNET_CPU_RTOL,
               "fwd_tol": PARITY_RESNET_CPU_FWD_RTOL,
               "deep_grad_l2_tol": PARITY_RESNET_CPU_DEEP_RTOL,
               "flip_atol": PARITY_RESNET_FLIP_ATOL,
               "moving_stats": len(moving), "ok": ok_cpu}, **vs_cpu))
    if not (ok and ok_site and ok_cpu):
        raise AssertionError("resnet parity failed")


def phase_quant():
    """``quantized_allreduce`` over a world-1 NCCL group on the card (the
    binding a multi-card run uses): at n = 1 it still quantizes twice;
    its result must equal the plain composite (``kernel=False``) bit for
    bit, float32 and bfloat16, at the 32 MB bucket and an odd size."""
    import tempfile

    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from paddle_tpu_torch.quant import quantized_allreduce

    torch.cuda.set_device(0)
    store = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_nccl_"),
                         "store")
    dist.init_process_group("nccl", init_method="file://" + store, rank=0,
                            world_size=1)
    try:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED + 7)
        results = []
        for numel, dtype in ((K7_BUCKET[0] * K7_BUCKET[1], torch.float32),
                             (1000003, torch.float32),
                             (1000003, torch.bfloat16)):
            x = torch.randn(numel, generator=gen, device="cuda").to(dtype)
            reset_launch_counts()
            got = quantized_allreduce(x)
            counts = launch_counts()
            ref = quantized_allreduce(x, kernel=False)
            torch.cuda.synchronize()
            bad = _bit_mismatches(got, ref)
            err = float((got.float() - x.float()).pow(2).mean().sqrt())
            results.append({
                "numel": numel, "dtype": _dname(dtype),
                "backend": dist.get_backend(), "bits_differing": bad,
                "k7_launches": [counts["block_quantize"],
                                counts["block_dequantize"]],
                "rms_vs_input": err})
        emit({"phase": "quant", "step": "quantized_allreduce, world-1 NCCL "
              "group, K7 vs plain composite", "cases": results})
        if any(r["bits_differing"] or r["k7_launches"] != [2, 2]
               for r in results):
            raise AssertionError("quantized_allreduce on NCCL: %s" % results)
    finally:
        dist.destroy_process_group()


def _dp_program(fluid, bert, cfg, rank, quant):
    from paddle_tpu_torch.transpiler import GradAllReduce

    main, startup, loss = _train_program(fluid, bert, cfg, SEQ)
    if rank is not None:
        GradAllReduce().transpile(program=main, startup_program=startup,
                                  rank=rank, nranks=DP_RANKS)
        main._num_trainers = DP_RANKS
    if quant:
        main._quant_buckets = {"min_bytes": 1}
    return main, startup, loss


def _params_digest(main, scope):
    import hashlib

    h = hashlib.sha256()
    for p in sorted(v.name for v in main.all_parameters()):
        h.update(scope.get(p).detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _dp_group(name):
    if "dequantize" in name:
        return "K7 dequant"
    if "quantize_kernel" in name:
        return "K7 quant"
    if "Memcpy" in name or "memcpy" in name:
        return "host staging copies"
    return _kernel_group(name)


def _dp_error_probe(records):
    """Wrap ``quantized_allreduce`` so that each bucket also records its
    dense sum and the error model's prediction: per rank, the RMS of its
    own first pass, gathered, in quadrature with the requantize pass of
    the sum (chaos.py's ``quant_reduce``, √2 for two equal passes).  The
    model gives every block its scale; a block of zeros (the embedding
    rows no id of the batch touched) carries the guard's unit scale and
    no error, so the gated prediction counts it as 0 (``predicted_rms``),
    and the model as the reference states it is kept beside it
    (``predicted_rms_all_blocks``)."""
    import torch

    import paddle_tpu_torch.quant.collective as qc
    from paddle_tpu_torch.ops import comm
    from paddle_tpu_torch.quant import (block_quantize, predicted_rms_error,
                                        quant_block)

    orig = qc.quantized_allreduce

    def model(x, b):
        q, s = block_quantize(x, b)
        live = q.view(s.numel(), -1).abs().amax(dim=1) > 0
        return torch.stack([predicted_rms_error(s * live),
                            predicted_rms_error(s)])

    def probe(flat, group=None, block=None, kernel=True):
        out = orig(flat, group, block, kernel)
        b = block or quant_block()
        dense = comm.all_reduce_sum(flat.float(), group)
        preds = comm.all_gather(model(flat, b), group)
        pred = torch.sqrt((preds ** 2).sum(dim=0) + model(dense, b) ** 2)
        measured = float((out.float() - dense).pow(2).mean().sqrt())
        records.append({"numel": flat.numel(), "measured_rms": measured,
                        "predicted_rms": float(pred[0]),
                        "predicted_rms_all_blocks": float(pred[1])})
        return out

    qc.quantized_allreduce = probe
    return orig


def _dp_rank(rank, store, out_path):
    """One rank of the data-parallel run: the dense and the quant twin of
    BERT-base pretraining (dropout 0.1) on this rank's 4 rows, a probed
    quant step, a profiled quant step (rank 0), and a dense step at
    dropout 0.  Writes its results to ``out_path``."""
    import copy
    import pickle
    import statistics

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from paddle_tpu_torch.static_analysis import fusion

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=DP_RANKS)
    try:
        batch = bert.make_fake_batch(TRAIN_BATCH, SEQ, bert.BERT_BASE,
                                     np.random.RandomState(SEED))
        rows = TRAIN_BATCH // DP_RANKS
        feed = {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}
        out = {"rank": rank}
        for twin in ("dense", "quant"):
            main, startup, loss = _dp_program(fluid, bert, bert.BERT_BASE,
                                              rank, twin == "quant")
            scope = fluid.Scope()
            with fluid.scope_guard(scope):
                exe = fluid.Executor(fluid.CUDAPlace(0))
                exe.run(startup)
                prog, _ = fusion.resolve_fused_program(main,
                                                       targets=[loss.name])
                buckets = [sum(int(np.prod(prog.global_block().var(n).shape))
                               for n in op.inputs["X"])
                           for op in prog.global_block().ops
                           if op.type in ("c_allreduce_quant",
                                          "c_fused_allreduce_sum",
                                          "c_allreduce_sum")]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                dist.barrier()
                reset_launch_counts()
                losses, step_ms, digests = [], [], []
                for _ in range(DP_STEPS):
                    t0 = time.perf_counter()
                    losses.append(float(exe.run(main, feed=feed,
                                                fetch_list=[loss])[0][0]))
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    digests.append(_params_digest(main, scope))
                counts = launch_counts()
                res = {"losses": losses, "step_ms": step_ms,
                       "median_step_ms": statistics.median(step_ms[1:]),
                       "digests": digests, "buckets": buckets,
                       "launches": counts,
                       "peak_memory_bytes": torch.cuda.max_memory_allocated()}
                if twin == "quant":
                    records = []
                    orig = _dp_error_probe(records)
                    try:
                        exe.run(main, feed=feed, fetch_list=[loss])
                    finally:
                        import paddle_tpu_torch.quant.collective as qc
                        qc.quantized_allreduce = orig
                    res["error_model"] = records
                    if rank == 0:
                        from torch.profiler import ProfilerActivity, profile

                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        with profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) as pr:
                            exe.run(main, feed=feed, fetch_list=[loss])
                            torch.cuda.synchronize()
                        wall = (time.perf_counter() - t0) * 1e3
                        groups, top = _device_breakdown(pr, 1, _dp_group)
                        res["profile"] = {
                            "wall_ms": wall, "device_ms_by_group": groups,
                            "device_ms": sum(groups.values()),
                            "top_kernels": top[:10]}
                    else:
                        exe.run(main, feed=feed, fetch_list=[loss])
                out[twin] = res
            del scope, exe
            torch.cuda.empty_cache()
        cfg0 = copy.copy(bert.BERT_BASE)
        cfg0.dropout = cfg0.attn_dropout = 0.0
        main, startup, loss = _dp_program(fluid, bert, cfg0, rank, False)
        grads = _grad_names(main)
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = fluid.Executor(fluid.CUDAPlace(0))
            exe.run(startup)
            vals = exe.run(main, feed=feed, fetch_list=[loss.name] + [
                grads[n] for n in DP_PARITY_PARAMS])
        out["dropout0"] = {"loss": float(vals[0][0]), "grads": vals[1:]}
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


DP_PARITY_PARAMS = ("bert.word_emb", "bert.layer0.attn.q.w",
                    "bert.layer0.ln1.scale")


def phase_dp(env):
    """Data-parallel BERT-base MLM pretraining (T=512) as the reference's
    collective mode runs it: two rank processes, each with the
    ``GradAllReduce``-transpiled program, on the one card over a gloo
    group (payloads cross through pinned host memory: a check of the
    path, not of a collective's speed).  Dense and int8-quantized twins
    from the same seeds and feeds; a dropout-0 dense step against one
    process on all 8 rows."""
    import copy
    import pickle
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert

    # one process on the 8 rows, dropout 0: the parity reference
    cfg0 = copy.copy(bert.BERT_BASE)
    cfg0.dropout = cfg0.attn_dropout = 0.0
    main, startup, loss = _dp_program(fluid, bert, cfg0, None, False)
    grads = _grad_names(main)
    batch = bert.make_fake_batch(TRAIN_BATCH, SEQ, bert.BERT_BASE,
                                 np.random.RandomState(SEED))
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup)
        one = exe.run(main, feed=batch, fetch_list=[loss.name] + [
            grads[n] for n in DP_PARITY_PARAMS])
    del scope, exe
    torch.cuda.empty_cache()

    work = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    store = os.path.join(work, "store")
    ctx = mp.get_context("spawn")
    paths = [os.path.join(work, "rank%d.pkl" % r) for r in range(DP_RANKS)]
    procs = [ctx.Process(target=_dp_rank, args=(r, store, paths[r]))
             for r in range(DP_RANKS)]
    t0 = time.time()
    for p in procs:
        p.start()
    try:
        deadline = t0 + DP_TIMEOUT
        for p in procs:
            p.join(max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    codes = [p.exitcode for p in procs]
    if codes != [0] * DP_RANKS:
        raise AssertionError("dp ranks exited with %s" % codes)
    ranks = []
    for path in paths:
        with open(path, "rb") as f:
            ranks.append(pickle.load(f))

    r0 = ranks[0]
    nbuckets = len(r0["quant"]["buckets"])
    per_step = {k: c / DP_STEPS for k, c in r0["quant"]["launches"].items()}
    twins = {}
    for twin in ("dense", "quant"):
        twins[twin] = [float(np.mean([r[twin]["losses"][s] for r in ranks]))
                       for s in range(DP_STEPS)]
    delta = max(abs(a - b) for a, b in zip(twins["dense"], twins["quant"]))
    same_params = {twin: [ranks[0][twin]["digests"][s]
                          == ranks[1][twin]["digests"][s]
                          for s in range(DP_STEPS)]
                   for twin in ("dense", "quant")}
    records = r0["quant"]["error_model"]
    ratios = [rec["measured_rms"] / rec["predicted_rms"]
              for rec in records if rec["predicted_rms"] > 0]
    mean_loss = float(np.mean([r["dropout0"]["loss"] for r in ranks]))
    parity = {"loss": [mean_loss, float(one[0][0])],
              "loss_rel_err": abs(mean_loss - float(one[0][0]))
              / abs(float(one[0][0])), "loss_tol": PARITY_LOSS_RTOL,
              "grad_tol": PARITY_GRAD_RTOL}
    ok_parity = parity["loss_rel_err"] <= PARITY_LOSS_RTOL
    for name, g, c in zip(DP_PARITY_PARAMS, r0["dropout0"]["grads"],
                          one[1:]):
        err = float(np.abs(g - c).max()) / max(float(np.abs(c).max()), 1e-30)
        parity[name + "@GRAD rel_err"] = err
        ok_parity = ok_parity and err <= PARITY_GRAD_RTOL
    emit({"phase": "dp", "step": "BERT-base MLM pretraining T=512, %d ranks "
          "of %d rows on one card over gloo (host-staged), dense vs int8 "
          "block-quantized gradient buckets" % (DP_RANKS, TRAIN_BATCH
                                               // DP_RANKS),
          "card": card_label(env), "seconds": time.time() - t0,
          "buckets": {t: r0[t]["buckets"] for t in ("dense", "quant")},
          "quant_buckets_per_step": nbuckets,
          "launches_per_step_quant": per_step,
          "losses": twins, "worst_loss_delta": delta,
          "loss_gate": DP_LOSS_GATE,
          "step_ms": {t: [r[t]["step_ms"] for r in ranks]
                      for t in ("dense", "quant")},
          "median_step_ms": {t: [r[t]["median_step_ms"] for r in ranks]
                             for t in ("dense", "quant")},
          "peak_memory_bytes": {t: [r[t]["peak_memory_bytes"] for r in ranks]
                                for t in ("dense", "quant")},
          "params_identical_across_ranks": same_params})
    emit({"phase": "dp", "step": "error model per quantized bucket "
          "(rank 0, one step): measured RMS against the model",
          "buckets": records, "worst_ratio": max(ratios) if ratios else None,
          "gate": DP_ERR_MODEL_GATE})
    emit(dict({"phase": "dp", "step": "profile of one quant step, rank 0 "
               "(the other rank runs beside it)"}, **r0["quant"]["profile"]))
    emit(dict({"phase": "dp", "step": "dropout 0: one dense 2-rank step vs "
               "one process on the 8 rows", "ok": ok_parity}, **parity))
    failed = []
    if per_step["block_quantize"] != 2 * nbuckets \
            or per_step["block_dequantize"] != 2 * nbuckets or not nbuckets:
        failed.append("K7 launches %s per step for %d buckets"
                      % (per_step, nbuckets))
    if not all(same_params["quant"]):
        failed.append("quant twin's parameters differ across ranks")
    if not all(same_params["dense"]):
        failed.append("dense twin's parameters differ across ranks")
    if not (delta <= DP_LOSS_GATE):
        failed.append("worst loss delta %g > %g" % (delta, DP_LOSS_GATE))
    if not ratios or max(ratios) > DP_ERR_MODEL_GATE:
        failed.append("quant error %s x the model" % ratios)
    if not ok_parity:
        failed.append("dropout-0 DP step vs one process: %s" % parity)
    if not all(np.isfinite(twins["dense"] + twins["quant"])):
        failed.append("non-finite loss %s" % twins)
    if failed:
        raise AssertionError("dp failed: %s" % "; ".join(failed))
    return r0["quant"]["launches"]


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch", "csrc")):
        print("chip_smoke: run it from a checkout of the repository "
              "(paddle_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = phase_environment()
    phase_build()
    rows = phase_kernels()
    serve_counts, pred, cfg = phase_main_path(env)
    phase_profile(env, pred, cfg)
    del pred
    train_counts = phase_train(env)
    phase_train_parity()
    decode_counts = phase_decode(env)
    phase_decode_parity()
    resnet_counts = phase_resnet(env)
    phase_resnet_parity()
    phase_quant()
    dp_counts = phase_dp(env)
    paths = {"serve": serve_counts, "train": train_counts,
             "decode_ring": decode_counts["ring"],
             "decode_paged": decode_counts["paged"],
             "resnet": resnet_counts, "dp": dp_counts}
    for r in rows:
        # the decode path's launches (ring + paged runs) where it runs the
        # kernel, else the BERT training path's (the backward kernels),
        # else the ResNet training path's (K4), else the data-parallel
        # path's (K7: rank 0's quant twin)
        name = r["name"]
        decode = paths["decode_ring"][name] + paths["decode_paged"][name]
        r["launches"] = (decode or train_counts[name] or resnet_counts[name]
                         or dp_counts[name])
        r["launches_path"] = "decode" if decode else (
            "train" if train_counts[name] else (
                "resnet" if resnet_counts[name] else "dp"))
    emit(dict({"phase": "launches"}, **paths))
    emit({"kernels": [{k: r[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "launches_path")} for r in rows]})
    print(env["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
