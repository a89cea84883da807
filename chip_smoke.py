#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a host with one NVIDIA H100 (sm_90a)
and the CUDA toolkit.  Phases, each printing one JSON line:

1. environment: the card's name and power limit (``nvidia-smi``), torch
   and CUDA versions;
2. build: ``nvcc`` builds the kernel library from ``paddle_tpu_torch/csrc``;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, in float32 and bfloat16, at the serving path's shapes and at
   edge cases, with the error beside its tolerance; then the kernel, the
   plain version and one PyTorch library call for the same function are
   timed with L2 flushed before every call (the library call is a
   yardstick only; the port never calls it);
4. main path: BERT-base (vocab 30522, hidden 768, 12 layers, 12 heads,
   ffn 3072) at sequence length 512 with random weights from a seed is
   built with the port's layers, exported with ``save_inference_model``,
   loaded by ``AnalysisPredictor`` on the GPU and served through
   ``PredictorServer``; every result must be finite, match a direct
   ``predictor.run`` and (for one request) a CPU predictor on the plain
   versions; the launch counters must rise by 12 / 25 / 3 per dispatched
   batch; latency and tokens/s are taken after the 8-row bucket is warm;
5. profile: on the same predictor, latency and host dispatch time per
   bucket, and for bucket 8 the device time by kernel group
   (``torch.profiler``) and the device's idle share.

Then one JSON line lists every ported kernel with its launches on the
main path and its times, a line gives ``nvidia-smi``'s name and power
limit, and the last line is ``{"ok": true, "device": {...}}``.  Any failed
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


def kernel_flash(checks, torch, gen):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    def tol(ref):
        # bf16: two units in the last place at the largest output (the
        # kernel and the plain version round p and o each once)
        if ref.dtype == torch.float32:
            return 5e-5
        return 2 * BF16_UNIT * float(ref.float().abs().max())

    b, h, t, dh = 8, 12, SEQ, 64
    main_err = None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        q, k, v, bias = _flash_inputs(torch, b, h, t, dh, dtype, gen)
        o, m, l = fa.flash_attention_fwd(q, k, v, bias)
        po, pm, pl = fa.flash_attention_fwd_plain(q, k, v, bias,
                                                  sm_scale=dh ** -0.5)
        torch.cuda.synchronize()
        err = checks.check("flash_attention_fwd",
                           "B8 H12 T512 Dh64 padded keys %s" % name,
                           max_err(o, po), tol(po))
        checks.check("flash_attention_fwd", "m, same %s" % name,
                     max_err(m, pm), 1e-3)
        checks.check("flash_attention_fwd", "l relative, same %s" % name,
                     max_err(l / pl, torch.ones_like(pl)), 1e-4)
        if dtype == torch.float32:
            main_err = err
        else:
            # a typical |o| is far below the largest, so the mean error
            # must also stay under one unit of the mean |o|: a dropped or
            # extra key moves a whole row and shows here
            mean_ref = float(po.float().abs().mean())
            checks.check("flash_attention_fwd",
                         "mean error vs one unit of mean |o| %s" % name,
                         float((o.float() - po.float()).abs().mean()),
                         BF16_UNIT * mean_ref)
    # edge cases: ragged T, causal, fully masked rows, ragged Dh
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        q, k, v, bias = _flash_inputs(torch, 2, 3, 200, 64, dtype, gen)
        bias[0, 0] = float("-inf")   # causal row 0 of batch 0 sees nothing
        bias[1, :] = float("-inf")   # batch 1: every row fully masked
        o, m, l = fa.flash_attention_fwd(q, k, v, bias, causal=True)
        po, pm, pl = fa.flash_attention_fwd_plain(q, k, v, bias, True,
                                                  64 ** -0.5)
        torch.cuda.synchronize()
        checks.check("flash_attention_fwd",
                     "B2 H3 T200 causal, fully masked rows %s" % name,
                     max_err(o, po), tol(po))
        checks.check("flash_attention_fwd", "masked rows are 0 %s" % name,
                     float(o[3:].float().abs().max()) + float(
                         o[:3, 0].float().abs().max()), 0.0)
        q, k, v, bias = _flash_inputs(torch, 2, 2, 200, 96, dtype, gen)
        o, _, _ = fa.flash_attention_fwd(q, k, v, bias)
        po, _, _ = fa.flash_attention_fwd_plain(q, k, v, bias,
                                                sm_scale=96 ** -0.5)
        torch.cuda.synchronize()
        checks.check("flash_attention_fwd", "B2 H2 T200 Dh96 %s" % name,
                     max_err(o, po), tol(po))

    q, k, v, bias = _flash_inputs(torch, b, h, t, dh, torch.float32, gen)
    ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, bias))
    plain_ms = time_ms(lambda: fa.flash_attention_fwd_plain(
        q, k, v, bias, sm_scale=dh ** -0.5))
    q4, k4, v4 = (x.view(b, h, t, dh) for x in (q, k, v))
    mask4 = bias.view(b, 1, 1, t)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask4))
    nbytes = 4 * (4 * b * h * t * dh + b * t + 2 * b * h * t)
    flops = 4 * b * h * t * t * dh
    bms, by = bound_ms(nbytes, flops, "float32")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/flash_attention.py:266",
            "max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
            "shape": "q,k,v [96,512,64] f32, bias [8,512]"}


def kernel_ln(checks, torch, gen):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import fused_ln as fl

    main_err = None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for n, d in ((4096, 768), (37, 640), (8, 4096)):
            x, res = (torch.randn((n, d), generator=gen, device="cuda")
                      .to(dtype) for _ in range(2))
            g = torch.randn((d,), generator=gen, device="cuda")
            bt = torch.randn((d,), generator=gen, device="cuda")
            out = fl.fused_dropout_add_ln_fwd(x, res, g, bt, eps=1e-5)
            ref = fl.fused_dropout_add_ln_fwd_plain(x, res, g, bt, 1e-5)
            torch.cuda.synchronize()
            # bf16: one unit in the last place at the largest output
            tol = 1e-4 if dtype == torch.float32 else \
                float(ref.float().abs().max()) * BF16_UNIT
            err = checks.check("fused_dropout_add_ln_fwd",
                               "N%d D%d %s" % (n, d, name),
                               max_err(out, ref), tol)
            if dtype == torch.float32 and (n, d) == (4096, 768):
                main_err = err
    n, d = 4096, 768
    x, res = (torch.randn((n, d), generator=gen, device="cuda")
              for _ in range(2))
    g = torch.randn((d,), generator=gen, device="cuda")
    bt = torch.randn((d,), generator=gen, device="cuda")
    ms = time_ms(lambda: fl.fused_dropout_add_ln_fwd(x, res, g, bt), 50)
    plain_ms = time_ms(
        lambda: fl.fused_dropout_add_ln_fwd_plain(x, res, g, bt), 50)
    library_ms = time_ms(
        lambda: F.layer_norm(x + res, (d,), g, bt, 1e-5), 50)
    bms, by = bound_ms(4 * (3 * n * d + 2 * d), 8 * n * d, "float32")
    return {"name": "fused_dropout_add_ln_fwd", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_ln.cu",
            "replaces": "paddle_tpu/ops/pallas/fused_ln.py:190",
            "max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
            "shape": "x,res [4096,768] f32"}


def kernel_gather(checks, torch, gen):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import embedding as emb

    main_err = None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
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
    table = torch.randn((30522, 768), generator=gen, device="cuda")
    ids = torch.randint(0, 30522, (4096,), generator=gen, device="cuda")
    ms = time_ms(lambda: emb.embedding_gather_fwd(table, ids), 50)
    plain_ms = time_ms(lambda: emb.embedding_gather_fwd_plain(table, ids),
                       50)
    library_ms = time_ms(lambda: F.embedding(ids, table), 50)
    bms, by = bound_ms(4096 * 768 * 4 * 2 + 4096 * 8, 0, "float32")
    return {"name": "embedding_gather_fwd", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/embedding.cu",
            "replaces": "paddle_tpu/ops/pallas/embedding.py:74",
            "max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
            "shape": "table [30522,768] f32, ids [4096] int64"}


def phase_kernels():
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    checks = Checks()
    rows = [kernel_flash(checks, torch, gen), kernel_ln(checks, torch, gen),
            kernel_gather(checks, torch, gen)]
    for r in rows:
        emit(dict({"phase": "kernels", "timing": True}, **r))
    if checks.failed:
        raise AssertionError("kernel checks failed: %s"
                             % "; ".join(checks.failed))
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
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

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
    want = {"flash_attention_fwd": 12 * batches,
            "fused_dropout_add_ln_fwd": 25 * batches,
            "embedding_gather_fwd": 3 * batches}
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
    for group, needle in (("flash_attention_fwd", "flash_fwd_kernel"),
                          ("fused_dropout_add_ln_fwd", "add_ln_fwd_kernel"),
                          ("embedding_gather_fwd", "gather_kernel")):
        if needle in name:
            return group
    low = name.lower()
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "gemm"
    return "other"


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
        g = _kernel_group(ev.key)
        groups[g] = groups.get(g, 0.0) + ms
        top.append((ms, ev.count // runs, ev.key[:90]))
    top.sort(reverse=True)
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
    counts, pred, cfg = phase_main_path(env)
    phase_profile(env, pred, cfg)
    for r in rows:
        r["launches"] = counts[r["name"]]
    emit({"kernels": [{k: r[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in rows]})
    print(env["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
