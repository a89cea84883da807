#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a host with one NVIDIA H100 (sm_90a)
and the CUDA toolkit.  Phases, each printing one JSON line:

1. environment: the card's name and power limit (``nvidia-smi``), torch
   and CUDA versions;
2. build: ``nvcc`` builds the kernel library from ``paddle_tpu_torch/csrc``
   and reports the registers and spills of the K1 forward, K2 backward
   and K5/K6 decode kernels (``ptxas -v``; a spill in a K2 backward or
   decode kernel fails the run), the blocks an SM holds of each decode
   kernel, the HMMA instructions in each K1 forward kernel's SASS
   (``cuobjdump -sass``; none fails the run) and a digest of the K1
   backward kernels' SASS;
3. kernels: each hand-written kernel (flash attention forward, its dK/dV
   and dQ backward kernels, fused add+LN forward and backward, embedding
   gather, flash decode and paged flash decode) against its plain
   PyTorch version on the card, in float32 and bfloat16, at dropout 0
   and 0.1, at the main paths' shapes and at edge cases (ragged T, head
   dims 30, 96, 100 and 128, causal, Tq != Tk, the decode path's causal
   prefills, fully masked rows, inputs 4 bytes off 16-byte alignment;
   for K2 D from 30 to 4096, ragged N, misaligned dout and y; for the
   decode kernels lengths 0 to 1024 in one launch, lengths on the
   chunk edges in caches no multiple of the chunk deep, 64 x 12 rows
   before smaller launches, head dim 128, shuffled block tables with -1
   tails over a larger pool, block lengths 16 and 32, each also against
   its chunked plain twin and the paged kernel against the ring kernel
   bit for bit), with the error beside its tolerance, the kernels'
   dropout keep fractions against 1 - rate, and the K1 forward, dK/dV,
   dQ, K2 backward and decode kernels run twice on the same inputs bit
   for bit; then the
   kernel, the plain version and one PyTorch library call for the same
   function are timed with L2 flushed before every call (the library
   call is a yardstick only; the port never calls it), and the K2
   backward's call is split between its two launches
   (``torch.profiler``).  K3 backward (a table pass, then the long
   rows) against ``index_add_`` at a tolerance, against its sorted
   plain twin and over two runs bit for bit, at BERT-base's three
   tables and the training batch's ids, all ids alike, 20000 ids and a
   ragged case, with its launches a call counted by kernel name and
   split between them; the in-place update kernels (Adam, Momentum
   plain and Nesterov, SGD) against their plain twins bit for bit in
   float32 and bfloat16 at BERT-base's and ResNet-50's largest and
   smallest parameters, writing into their inputs; the multi-tensor
   Adam and SGD over BERT-base's parameter list against the
   per-parameter kernels bit for bit; SGD and the multi-tensor SGD at
   odd lengths, mixed types and misaligned views against ``sgd_plain``
   bit for bit; each timed (K3 backward beside ``index_add_`` and the
   deterministic ``index_put_``), and one small update's device time in
   a graph (the optimizer fusion's CUDA gate);
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
   must be finite and fall, every step must launch exactly 12 flash
   forward, 12 dK/dV, 12 dQ, 25 LN forward, 25 LN backward, 3 gather, 3
   gather backward and 197 Adam update kernels, and copy no state back
   (the updates write in place); step time, tokens/s, peak memory, the
   host's time to enqueue a step, and the device time by kernel group
   (the optimizer a group of its own) with the idle share (and the
   busiest host ops) over two profiled steps;
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
   site) and 197 Momentum update kernels and copy no state back, and the
   eval batch 65 forward; step time, images/s, peak memory, the host's
   time to enqueue a step, and the device time by kernel group (conv
   fwd/bwd, K4 fwd/bwd, BN statistics, optimizer, elementwise, pooling,
   layout copies) with the idle share;
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

14. graph: each main path eagerly (``use_program_cache=False``) against
   the executor's captured CUDA graph in the same run: serving bucket 8
   on the main path's predictor (after every bucket is called three
   times and must end replaying), BERT-base training, GPT-2-small decode
   ring and paged (both prefill buckets and the greedy step must end
   replaying) and ResNet-50 training, each side from the same start and
   feeds.  Results must be bit for bit (outputs; tokens and logits;
   losses and a digest of every persistable); the training paths also
   eager against a second eager side, BERT with the default algorithms,
   ResNet under ``set_flags({"FLAGS_cpu_deterministic": True})`` (cuDNN's
   default convolution backward adds with atomics), with its step time
   with and without the flag and whether it repeats without it; the
   training graph sides must copy no state back; each side's numbers
   come from fresh sides with the default flags.
   The graph side must replay, and each side's launches a call must
   match the expected counts by counter and by the kernel names
   ``torch.profiler`` sees; each side's enqueue ms, step ms, idle share,
   peak allocated and reserved memory, graph count and run mode are
   printed.  The serving comparison runs after the profile phase,
   the others after ResNet parity.
15. bf16 AMP (``contrib.mixed_precision``), each phase after the one it
   mirrors.  ``serve_bf16`` (after the serving graph comparison): the
   same seeded BERT-base exported again and loaded with
   ``AnalysisConfig.enable_bf16()``; the analysis passes must have run
   before the rewrite (casts present, no batch_norm, the float32
   predictor's fused op counts), requests go through
   ``PredictorServer`` in the same buckets with the launches read per
   batch and every K1 and K2 graph node bfloat16, each bucket's latency
   and tokens/s beside the float32 predictor's in turns, and the error
   against float32 must lie in (1e-6, 0.05) of the output's scale.
   ``train_amp`` (after train parity): ``build_pretrain(BERT_BASE,
   seq_len=512, amp=True)``, batch 8, dropout 0.1, Adam on float32
   masters, on the captured graph: the launches per step by kernel and
   by the element type of each replayed graph node's device function
   (K1 and K2 bfloat16, K3 backward and Adam float32), no state copied
   back, median step, tokens/s, peak memory, device time by group with
   the casts a group of their own, then eager = graph = eager bit for
   bit; ``train_amp_parity``: one AMP step of a 2-layer
   BERT at BERT-base width on the card against the CPU plain versions,
   and the AMP loss against the float32 loss of the same step.
   ``resnet_amp`` (after ResNet parity): ``resnet.build(dataset=
   "imagenet", depth=50, data_format="NHWC", amp=True)`` at batch 64:
   65 fused sites that absorbed the AMP cast sandwich and no batch_norm
   op left, 65 K4 forward and 65 K4 backward graph nodes a step, all
   bfloat16, median step, images/s, device time by group and the
   layout copies' device ms against the float32 path's;
   ``resnet_amp_parity``: one AMP step of ResNet-20 NHWC on the card
   against the CPU.  Each phase fails the run on a failed check.
16. serve (after decode parity): serving started as the reference starts
   it.  One ``PredictorServer`` with default arguments (the scope-overlap
   proof and the zero-sync certificate gate its construction; the
   earlier phases' servers are gated too) over BERT-base T=512 and a
   GPT-2-small ring ``DecodeEngine`` (8 slots, prompt buckets 128/512);
   400 one-row BERT requests open loop at 100 requests/s through
   ``serving.run_load`` while 16 seeded prompts decode 64 tokens each,
   four times with telemetry and tracing on, off, on, off (latency p50 and
   p99, shed and rejected, decode tokens/s and step ms, host µs of a
   bucket-8 enqueue and of a decode-step enqueue on a drained device;
   the first run's spans by name and exported serving series); every
   request must complete and the tokens repeat across runs.  Then
   ``run_batches(verify=True)`` over 32 bucket-8 batches at depths 1 and
   2 must equal ``run`` bit for bit (batches/s printed); BERT and greedy
   decode replays run under ``torch.cuda.set_sync_debug_mode("error")``;
   a top-k sampled step's syncs are counted under "warn"; and
   ``python -m paddle_tpu_torch.tools.serve`` runs as a subprocess (64
   requests, ``--json``; ``--certify-zero-sync``), both exiting 0.
17. sampled (after decode parity): GPT-2-small widths as above with
   sampling drawn on the device, a top-k tenant (k 8) on the ring cache
   and a top-p tenant (p 0.9, temperature 0.8) on the paged pool: the
   16 requests served through ``PredictorServer`` (tokens/s beside the
   decode phase's greedy rate, the same launches a step and prefill as
   greedy); six all-slot steps on a fresh executor from a copy of the
   engine's scope, captured then replayed, against an eager executor
   from another copy, token for token (the same seed and steps), the
   draws moving with the step; replays under sync debug "error"; and
   the syncs of one replayed step counted under "warn", which must be 0.
   Before the tenants, the noise on the card: the generator's 1024
   highest and lowest codes give finite noise, and ``top_p_sampling``
   over [256, 50257] seeded logits at 32 steps draws no token outside
   the kept set.
18. verify (last): the static-analysis battery on the card's programs.
   ``Executor.run(verify=True)`` over 3 BERT-base T=512 training steps
   (float32, dropout 0.1) gives the losses of ``verify=False`` bit for
   bit and replays as a graph; on the AMP program it raises
   ``VerifyError`` naming ``shape-dtype-drift``, as the reference does;
   ``verify_program`` on ResNet-50 NHWC (training and eval), the
   GPT-2-small ring and paged step and prefill programs and the two DP
   worker programs (with ``workers=``); every one of these programs'
   fusion resolved under the verifier bracket; the BERT serving export
   loaded by ``AnalysisPredictor`` with ``PADDLE_TPU_VERIFY_PASSES=1``
   (every analysis pass bracketed) and run; a program with a dangling
   read raising ``VerifyError`` naming ``use-before-def``;
   ``python -m paddle_tpu_torch.tools.lint_program`` as a subprocess on
   the export and on the ring step program (``--program-json``; its
   caches draw INFO ``decode-cache-unpaged``), each exiting 0, and with
   ``--fail-on INFO`` exiting 1 exactly when it prints a finding;
   ``python -m paddle_tpu_torch.tools.analyze_program`` on the export
   and on the BERT-base training program (``--json``, ``--bench-json``),
   each exiting 0, with its host ms.  The findings by check and
   severity and the battery's host ms per program are printed.
19. fusion (after verify): BERT-base pretraining at T=512, batch 8, built
   with ``fuse_attn=True``, with ``fuse_attn=False`` (the attention
   rewrite must give 12 ``fused_multihead_attention`` ops and their 12
   grads, no ``softmax``, and 12 K1 forward, 12 dK/dV and 12 dQ
   launches a replayed step, as the fused build) and with
   ``fuse_attn=False`` under ``PADDLE_TPU_FLASH_MIN_T=4096`` (left
   unfused, no K1 launch): each one's median step and device ms; at
   dropout 0 the first two builds' losses over 3 steps within 1e-5
   relative; the ImageNet classifier head (fc 2048 → 1000, softmax,
   ``cross_entropy``, batch 256, one Momentum step) with one
   ``softmax_with_cross_entropy`` and its loss and gradients within
   1e-5 relative of the unfused pair; and three forced drift
   calibration writes, each followed by a warm-up, a capture and a
   replay of the fused build, after which its executor still holds one
   graph (``drift`` line).
20. autotune (last): K1 forward + backward against the port's unfused
   chain (``matmul`` with α, the [B,1,1,T] mask bias, ``softmax``,
   ``dropout`` upscale_in_train at 0.1, ``matmul``, differentiated by
   autograd as the grad ops do) over BERT-base heads [8, 12, T, 64], T
   128 to 2048, float32 and bfloat16, each side's replays timed by CUDA
   events; ``decide_threshold`` on the float32 rows, recorded with
   ``record_flash_min_t``; ``flash_min_t()`` must then return the
   decision and ``PADDLE_TPU_FLASH_MIN_T`` still override it.

21. tools (after the bf16 serving phase, on the main path's
   predictor): 32 one-row BERT-base requests through a default
   ``PredictorServer`` and 4 steps of a 2-layer BERT-base-width MLM
   program (T=128, batch 2, Adam) under one temporary
   ``PADDLE_TPU_TELEMETRY_DIR`` with every step journaled, a
   ``HeartbeatWriter`` beating for rank 0; then ``python -m
   paddle_tpu_torch.tools.monitor DIR --once --json``, ``python -m
   paddle_tpu_torch.tools.trace DIR --serving --json`` and two monitor
   alerts (``steps>0`` must exit 1, ``lost_ranks>0`` 0) as subprocesses
   at once: the monitor's newest step and step events must be what the
   executors ran, the rank alive and not wedged, trace's request count
   the requests sent with each phase's p50 and p99; the directory is
   deleted afterwards.
22. optimizers (last but two): BERT-base MLM pretraining (T=512, batch
   8, float32, dropout 0.1) with each of ``RULES`` — Adagrad,
   DecayedAdagrad, Adamax, Adadelta, centered RMSProp (momentum 0.9),
   Ftrl (``lr_power`` -0.5), DGCMomentum (its warning printed) and Adam
   extended by ``extend_with_decoupled_weight_decay`` — each program
   built once: the eager step (the key's first call) and, from the same
   start at the same executor step, the captured step must agree bit for
   bit (the loss and three parameters), then 3 timed replays, whose
   launches must be K1 12/12/12, K2 25/25, K3 3/3 and the rule's update
   kernels; the copy-backs a step by the op that wrote each (only
   Adamax's ``scale`` of each ``Beta1Pow`` and decoupled weight decay's
   ``assign`` of each parameter may copy back); then the nine new update
   ops alone at [30522, 768] float32 (ms from a graph with L2 evicted,
   byte bound, CUDA kernels an op).
23. optimizers_parity: each rule's first step on a 2-layer BERT-base-
   width model (T=128, batch 2, dropout 0.1), the card's captured step
   against the CPU's plain versions from one start and with the same
   masks: the loss within 1e-4 and three parameters within 1e-6 of their
   scale plus, element by element, what the two sides' gradients can
   explain (``rule_parity_tol``: a rule's step swings only where the
   gradients differ in sign or by a large share); the card's parameters
   moved; the same check would fail the card's update dropped or
   reversed, with each parameter's share of elements that catch either.
24. averaging: BERT-base T=512 b8 with Adam, an
   ``ExponentialMovingAverage`` whose decay is scheduled from
   ``autoincreased_step_counter`` (``thres_steps``) and a
   ``ModelAverage`` (windows 2 to 4, so it restarts), a warm-up and 6
   graph steps; inside each ``apply``, eager and captured, every
   parameter within 4 float32 units of the average computed in plain
   torch from the recorded parameters (and inside the eager one the
   eval program's loss); after ``restore`` every
   parameter bit for bit its value before; the apply and restore
   programs' ms, eager then captured.
25. dygraph: a ResNet-50 of dygraph layers (``dygraph_resnet``: Conv2D
   without bias + BatchNorm per site, block for block
   ``resnet_imagenet``'s, 65 sites, 197 trainable parameters), NCHW,
   batch 64, 224x224, float32, Momentum (lr 0.1, 0.9, Nesterov) through
   ``guard()``, ``backward``, ``minimize(parameter_list=)`` and
   ``clear_gradients`` on the card: its first step against the static
   ``resnet.build(..., data_format="NCHW")`` program from the same
   weights (the loss within 1e-4, every parameter and running statistic
   within 1e-4 of its scale), warm-up and 5 timed steps (step ms, the
   host's ms to enqueue, 197 Momentum launches a step and no other
   hand-written kernel, peak allocated and reserved), 2 profiled steps
   (device ms by group, idle share), the eval forward on the running
   statistics (left as they are) against the for-test clone, and a
   ``save_dygraph`` → ``load_dygraph`` → ``set_dict`` round trip bit for
   bit;
26. dygraph_parity (last): every one of the 20 dygraph layers at small
   widths (``DYGRAPH_LAYER_CASES``; Dropout at 0.5 and NCE with the same
   op ids on both sides) on the card against the port on the CPU, the
   output and every gradient of its parameters and inputs within 1e-4 of
   its scale; SGD, Momentum and Adam each with each dygraph clip, L2
   decay and a ``PiecewiseDecay``, 3 steps of a small MLP, the losses and
   parameters within 1e-4 of their scale (Adam's elements also what the
   two sides' consumed gradients explain), their update kernels counted;
27. decode_loop (after decode parity): ``models.gpt.build_program`` (the
   prefill, then ``layers.decode_loop``: one ``While`` whose body is a
   one-token step) at GPT-2-small widths, batch 8, prompt 32, 64 new
   tokens, greedy, f32, through ``Executor.run``: the trips are driven
   from the host (one condition read a trip) and the body replays a
   CUDA graph from its second trip.  One cold and 3 warm generations
   (wall time, trips, condition reads, syncs of one under
   ``set_sync_debug_mode("warn")``, the body's run mode and its reason,
   host ms before the loop, peak memory, launches: K1 12, K2 24 and K3
   2 in the prefill, K5 12 a trip, anything else fails), TTFT as a warm
   1-token generation, beside the ring ``DecodeEngine``'s rate (another
   program); ``build_naive_program`` on the same weights must give the
   same tokens, and the port on the CPU the card's tokens except at a
   near-tie (``_greedy_mismatches`` at the first parting);
28. control_flow_parity: ``While`` bounded and unbounded with their
   gradients, ``cond``, ``Switch``, ``IfElse`` with gradients, the
   tensor arrays and a gradient through one (``control_flow_cases``),
   card against CPU within 1e-5 of the scale, every loop body replayed
   from its graph on the card;
29. nmt_train: ``models.machine_translation.build_train`` (StaticRNN
   decoder) and ``build_train_dynamic`` (DynamicRNN, target lengths
   8-32) at the upstream benchmark's widths (embedding, encoder and
   decoder 512, dictionary 30000), length 32, batch 32, Adam: 5 steps
   eager against 5 through the cache, bit for bit on the fetches and
   every persistable; each graph step one replay with no host sync,
   K3 forward and backward twice and one Adam update a parameter; step
   ms, target tokens/s, device ms by group, idle share, peak memory;
30. lstm: ``models.stacked_dynamic_lstm.build()`` at its defaults
   (vocabulary 5149, length 80, width 512, 3 layers), batch 32, lengths
   8-80: 3 steps eager against 3 graph steps, as nmt_train;
31. nmt_translate: ``build_infer`` at those widths, batch 16, beam 3, at
   most 250 steps: trips, condition reads and syncs a translation, the
   body's run mode, a trip's wall ms against a body replay's device ms,
   sentences and tokens a second, peak memory, K3 forward once;
32. rnn_parity: the three programs at small widths, card against CPU:
   losses within 1e-4 of the scale, beam ids equal.

The whole run reads and writes a fresh autotune cache in a temp
directory (``PADDLE_TPU_AUTOTUNE_CACHE``), so no decision of an earlier
run routes it: the main paths run at the hand-set threshold, 512.  The
training, ResNet and decode phases print ``drift`` lines: per cached
program the cost model's predicted step ms (H100 defaults), the
measured EMA, each drift ratio (finite, or the run fails) and the host
ms of the registration its first call paid.  After the serving profile,
``profiler`` serves one bucket-8 BERT-base batch under
``paddle_tpu_torch.profiler`` with the device trace on: the merged
chrome trace (``.smoke_tmp/profile_bert_b8.json``) must hold the
serving spans and the K1, K2 and K3 kernels' rows; the top rows of
``device_op_stats`` are printed.  The serve phase's hook cost includes
``record_step`` with a drift key and the drift monitor's
``observe_step`` alone.

The main paths run through the executor's program cache, so their
timed steps replay CUDA graphs; the training and ResNet phases fail if
their timed steps did not.  The kernels phase also captures each
dropping kernel (K1 forward, dK/dV, dQ; K2 forward and backward) in a
CUDA graph with its seed read from a device step tensor and replays it
at two steps: each replay must match the plain twin at its step and
the two must differ.  It also checks K4 forward and backward (float32 and
bfloat16, identity and relu) at the ResNet-50 sites' shapes and a
ragged one, and times them at every site shape of batch 64; the kernels
in the AMP paths' call forms (K2 through its op entry with bf16 gamma
and beta, K1 through its entry with a bf16 mask bias, K4 in bf16 at
every ResNet-50 site shape) against their plain versions, with K2
forward and K4 forward and backward timed in bf16; and K7
quantize and dequantize (to float32 and bfloat16), bit for bit, at the
32 MB bucket, odd B, an unaligned pointer, an odd tail and zero,
subnormal, NaN, inf and tie blocks, timed at the bucket and at
BERT-base's whole gradient.  Then one JSON line lists every ported
kernel with its launches on the decode path (or, for the backward
kernels, the BERT training run; for K4 the ResNet training run; for K7
the data-parallel run's quant twin, rank 0), its launches on every path
(the dygraph ResNet's among them) and its times, a line gives ``nvidia-smi``'s name and power limit, and the last
line is ``{"ok": true, "device": {...}}``.  Any failed
phase exits non-zero before that line.  Without a CUDA device, or without
the repository beside it, the script exits 2 and prints no result.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TF32_FLOPS = 495e12          # the tensor cores' dense TF32 rate
L2_FLUSH_BYTES = 512 << 20   # ten times the H100's 50 MB L2
BF16_UNIT = 2.0 ** -7        # one bf16 unit in the last place, relative
SEED = 0
SEQ = 512
REQUEST_ROWS = (1, 2, 3, 1, 2, 3, 1, 2)
BUCKETS = (1, 2, 4, 8)
SERVE_ATOL = 1e-4     # served rows vs a direct run of the same rows (f32)
CPU_ATOL = 2e-3       # GPU kernels vs CPU plain versions, 12 layers (f32)
DROPOUT = 0.1         # BERT's hidden and attention dropout
# the kernel checks' dropout seed, as the main path passes it: a step in a
# 1-element int64 tensor on the card, read by the kernels through a
# pointer, and a salt (drop_seed)
DROP_STEP = 1234
DROP_SALT = 0x5EED
TRAIN_BATCH = 8
TRAIN_WARMUP = 2
TRAIN_STEPS = 5
TRAIN_LR = 1e-4
# the flagship training layout (bench.py:2741-2770): T=128, batch 64, and
# its LR schedule: linear warm-up over 10 steps to 1e-4, then a linear
# decay to 0 over 1000
RECIPE_SEQ = 128
RECIPE_BATCH = 64
RECIPE_LR = 1e-4
RECIPE_WARMUP_STEPS = 10
RECIPE_DECAY_STEPS = 1000
# one training step, GPU kernels vs CPU plain versions, float32 with TF32
# off: sums in another order through 2 layers, the vocab head and the
# embedding gradient's pieces
PARITY_LOSS_RTOL = 1e-4
# a parity step is the last of this many calls from one start: the card's
# third call replays the graph its second captured
PARITY_CALLS = 3
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
# eager against the captured CUDA graph: compared calls a side (warm-up,
# capture, a replay), then profiled calls a side
GRAPH_STEPS = 3
GRAPH_PROFILE_RUNS = 3
PROFILE_MARGIN_S = 0.05
# a profiled window of the graph phase opens and closes with marker
# kernels, so a profile that lost records at its edges is known; one that
# lost a marker is taken again, at most PROFILE_TRIES times in all
PROFILE_MARKERS = 2
PROFILE_TRIES = 3
MARKER_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel
MARKER_CYCLES = 1000
OUTSIDE_SHOWN = 8  # starts shown a kernel left out of a profile's window


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

def time_ms(fn, iters=20, warmup=3, clean_l2=False, graph=False):
    """Mean device time of one cold call of ``fn()``: before each of
    ``iters`` calls (after ``warmup``) a write of L2_FLUSH_BYTES evicts
    the inputs from the 50 MB L2, and a pair of CUDA events brackets the
    call alone, so the time reads against the HBM bound.  The write
    leaves L2 dirty, so the call's reads also pay the write-back of what
    they evict; ``clean_l2`` flushes with a read of the same bytes
    instead.  ``graph`` captures ``fn`` once in a CUDA graph and times its
    replays, so host work inside ``fn`` (a multi-tensor wrapper's checks
    of every member) cannot hold the card idle inside the window."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    for _ in range(warmup):
        fn()
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            fn()
        fn = captured.replay
    pairs = []
    for _ in range(iters):
        if clean_l2:
            flush.sum()
        else:
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


# kernels whose registers and spills the build phase reports, and whose
# SASS it reads: the K1 forward on the tensor cores (HMMA count), the K2
# forward and the K2 backward's two kernels, the K5 and K6 decode kernels
# (with the blocks an SM holds), and the K1 backward (a digest of its
# SASS, which moving its helpers into flash_mma.cuh must not change)
BUILD_REPORT = ("flash_fwd_kernel", "add_ln_fwd_kernel", "add_ln_bwd_kernel",
                "ln_bwd_reduce_kernel", "decode_kernel", "embedding_bwd_",
                "sgd_update_kernel", "multi_sgd_kernel")
# kernels whose spills fail the run
NO_SPILL = ("add_ln_fwd", "add_ln_bwd", "decode_kernel")
SASS_DIGEST = ("flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")


def _demangle(names):
    tool = shutil.which("c++filt")
    if not tool or not names:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         stdout=subprocess.PIPE, check=True).stdout
    return [n.replace("(anonymous namespace)::", "").split("(")[0]
            for n in out.splitlines()]


def _ptxas_report(log, needles):
    """Registers and spill bytes of every kernel whose mangled name holds
    one of ``needles``, from nvcc's ``-Xptxas=-v`` output."""
    import re

    rows, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and any(n in name for n in needles):
            rows.append((name, int(m.group(1)), spill))
            name = None
    return [{"kernel": short, "registers": regs, "spill_stores": st,
             "spill_loads": ld}
            for short, (_, regs, (st, ld)) in zip(
                _demangle([r[0] for r in rows]), rows)]


def _sass_report(path, hmma_needles, digest_needles):
    """From ``cuobjdump -sass`` of the library: the HMMA (tensor-core MMA)
    instructions of each kernel named by ``hmma_needles``, and a digest of
    the instruction text (addresses and encodings dropped) of each named
    by ``digest_needles``."""
    import hashlib
    import re

    from paddle_tpu_torch.ops.cuda import _lib

    tool = os.path.join(os.path.dirname(_lib._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", path], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
            if m:
                funcs[name].append(m.group(1))
    hmma = {n: sum("HMMA" in i for i in ins) for n, ins in funcs.items()
            if any(k in n for k in hmma_needles)}
    digests = {n: hashlib.sha256("\n".join(ins).encode()).hexdigest()[:16]
               for n, ins in funcs.items()
               if any(k in n for k in digest_needles)}
    return ({k: v for k, v in zip(_demangle(list(hmma)), hmma.values())},
            {k: v for k, v in zip(_demangle(list(digests)),
                                  digests.values())})


def phase_build():
    import contextlib
    import io

    from paddle_tpu_torch.ops.cuda import _lib

    t0 = time.time()
    out = io.StringIO()  # a verbose build prints nvcc's output
    with contextlib.redirect_stdout(out):
        path = _lib.build(verbose=True)
    _lib.lib()
    seconds = time.time() - t0
    log = out.getvalue()
    print(log, flush=True)
    hmma, digests = _sass_report(path, ("flash_fwd_kernel",), SASS_DIGEST)
    report = {"phase": "build", "library": os.path.relpath(path, HERE),
              "seconds": seconds,
              "registers": _ptxas_report(log, BUILD_REPORT)
              if "ptxas" in log else "library found built: no ptxas report",
              "hmma_per_kernel": hmma, "sass_digest": digests,
              "decode_blocks_per_sm": _decode_occupancy(_lib.lib())}
    emit(report)
    return report


def _decode_occupancy(lib):
    """Blocks of 256 threads one SM holds of each K5 / K6 kernel
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), or a note for a
    library without the query (a parent's, under ``chip_ab.py``)."""
    query = getattr(lib, "pt_flash_decode_blocks_per_sm", None)
    if query is None:
        return "not in this library"
    return {"%s<%s, %d>" % (kernel, dtype, dh): query(paged, dh, code)
            for paged, kernel in ((0, "decode_kernel"),
                                  (1, "paged_decode_kernel"))
            for code, dtype in ((0, "float"), (1, "__nv_bfloat16"))
            for dh in (64, 128)}


def _gen(torch):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    return gen


def drop_seed():
    """The kernel checks' dropout seed (``DROP_STEP`` on the card, and
    ``DROP_SALT``)."""
    import torch

    from paddle_tpu_torch.ops.cuda.dropout import StepSeed

    return StepSeed(torch.full((1,), DROP_STEP, dtype=torch.int64,
                               device="cuda"), DROP_SALT)


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
    main_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = _dname(dtype)
        q, k, v, bias = _flash_inputs(torch, b, h, t, dh, dtype, gen)
        for rate in (0.0, DROPOUT):
            seed = drop_seed() if rate else None
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
            if rate:  # the timed rows' errors
                main_err[name] = err
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
                                     dropout_seed=drop_seed())
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
                                         dropout_seed=drop_seed())
        po, pm, pl = fa.flash_attention_fwd_plain(q, k, v, bias, True,
                                                  64 ** -0.5, DROPOUT,
                                                  drop_seed())
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
    kernel_flash_fwd_edges(checks, torch, fa, gen)
    return main_err


def _fwd_case(checks, torch, fa, case, q, k, v, bias, causal, rate,
              shift=False):
    """The forward kernel against its plain version: o within ``_tol``,
    m within 1e-3, l within 1e-4 relative (kernel_flash's tolerances).
    ``shift``: the kernel reads q, k and v from copies 4 bytes off a
    16-byte boundary."""
    seed = drop_seed() if rate else None
    dh = q.shape[2]
    kq, kk, kv = ((_shifted(torch, x) for x in (q, k, v)) if shift
                  else (q, k, v))
    o, m, l = fa.flash_attention_fwd(kq, kk, kv, bias, causal,
                                     dropout_rate=rate, dropout_seed=seed)
    po, pm, pl = fa.flash_attention_fwd_plain(q, k, v, bias, causal,
                                              dh ** -0.5, rate, seed)
    torch.cuda.synchronize()
    checks.check("flash_attention_fwd", case, max_err(o, po), _tol(po))
    checks.check("flash_attention_fwd", "m, " + case, max_err(m, pm), 1e-3)
    checks.check("flash_attention_fwd", "l relative, " + case,
                 max_err(l / pl, torch.ones_like(pl)), 1e-4)


def _same_bits_check(checks, torch, kernel, case, a, b):
    """Two runs' outputs ``a`` and ``b`` bit for bit (error 0, tolerance
    0; a difference reads as at least the smallest subnormal)."""
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    same = torch.equal(a.view(view), b.view(view))
    checks.check(kernel, case, 0.0 if same
                 else max(max_err(a, b), 2 ** -149), 0.0)


def kernel_flash_fwd_edges(checks, torch, fa, gen):
    """The tensor-core forward's own cases: a rerun bit for bit, the
    decode path's causal prefills (b*h = 12 at T 128 and 512), the
    plain-load staging (rows of Dh 30 or 100 elements that are not whole
    16-byte chunks, and q, k, v 4 bytes off 16-byte alignment), and
    Tq != Tk under the causal flag."""
    for dtype in (torch.float32, torch.bfloat16):
        name = _dname(dtype)
        q, k, v, bias = _flash_inputs(torch, 8, 12, SEQ, 64, dtype, gen)
        runs = [fa.flash_attention_fwd(q, k, v, bias, dropout_rate=DROPOUT,
                                       dropout_seed=drop_seed())
                for _ in range(2)]
        torch.cuda.synchronize()
        for i, what in enumerate(("o", "m", "l")):
            _same_bits_check(checks, torch, "flash_attention_fwd",
                             "%s bit-identical over two runs, B8 H12 T512 "
                             "Dh64 rate %g %s" % (what, DROPOUT, name),
                             runs[0][i], runs[1][i])
        del q, k, v, runs
        for t in (128, SEQ):
            q, k, v, bias = _flash_inputs(torch, 1, 12, t, 64, dtype, gen)
            _fwd_case(checks, torch, fa, "prefill B1 H12 T%d causal, padded "
                      "keys %s" % (t, name), q, k, v, bias, True, 0.0)
        for t_, dh_, rate, shift in ((200, 30, DROPOUT, False),
                                     (200, 100, 0.0, False),
                                     (200, 64, DROPOUT, True),
                                     (256, 128, 0.0, True)):
            q, k, v, bias = _flash_inputs(torch, 2, 2, t_, dh_, dtype, gen)
            _fwd_case(checks, torch, fa, "B2 H2 T%d Dh%d rate %g%s %s"
                      % (t_, dh_, rate, ", 4 bytes off 16-byte alignment"
                         if shift else "", name),
                      q, k, v, bias, False, rate, shift)
        # Tq != Tk: 100 query rows against 260 keys, and 260 against 100
        for tq, tk in ((100, 260), (260, 100)):
            q = torch.randn((6, tq, 64), generator=gen,
                            device="cuda").to(dtype)
            _, k, v, bias = _flash_inputs(torch, 2, 3, tk, 64, dtype, gen)
            _fwd_case(checks, torch, fa, "B2 H3 Tq%d Tk%d causal, rate %g %s"
                      % (tq, tk, DROPOUT, name), q, k, v, bias, True,
                      DROPOUT)


def _shifted(torch, x):
    """A contiguous copy of ``x`` whose data starts 4 bytes past a 16-byte
    boundary."""
    pad = 4 // x.element_size()
    buf = torch.empty(x.numel() + pad, dtype=x.dtype, device=x.device)
    y = buf[pad:].view(x.shape)
    y.copy_(x)
    return y


def _flash_bwd_case(checks, torch, fa, case, q, k, v, bias, causal, rate,
                    gen, shift=False):
    """Both backward kernels against the plain backward; returns each
    kernel's largest error and the gradients.  ``shift``: the kernels
    read q, k, v and dO from copies 4 bytes off a 16-byte boundary."""
    dh = q.shape[2]
    seed = drop_seed() if rate else None
    o, m, l = fa.flash_attention_fwd(q, k, v, bias, causal,
                                     dropout_rate=rate, dropout_seed=seed)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    delta = (do.float() * o.float()).sum(dim=-1)
    args = (causal, None, rate, seed)
    kq, kk, kv, kdo = ((_shifted(torch, x) for x in (q, k, v, do)) if shift
                       else (q, k, v, do))
    dk, dv = fa.flash_attention_bwd_dkv(kq, kk, kv, bias, kdo, m, l, delta,
                                        *args)
    dq = fa.flash_attention_bwd_dq(kq, kk, kv, bias, kdo, m, l, delta, *args)
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


def _flash_bwd_determinism(checks, torch, fa, name, q, k, v, bias, gen):
    """Each backward kernel run twice on the same inputs (dropout 0.1)
    gives the same bits: a fixed loop order and no atomics."""
    o, m, l = fa.flash_attention_fwd(q, k, v, bias, dropout_rate=DROPOUT,
                                     dropout_seed=drop_seed())
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    delta = (do.float() * o.float()).sum(dim=-1)
    args = (False, None, DROPOUT, drop_seed())
    runs = [fa.flash_attention_bwd_dkv(q, k, v, bias, do, m, l, delta, *args)
            + (fa.flash_attention_bwd_dq(q, k, v, bias, do, m, l, delta,
                                         *args),) for _ in range(2)]
    torch.cuda.synchronize()
    for kernel, what, i in (("flash_attention_bwd_dkv", "dk", 0),
                            ("flash_attention_bwd_dkv", "dv", 1),
                            ("flash_attention_bwd_dq", "dq", 2)):
        _same_bits_check(checks, torch, kernel, "%s bit-identical over two "
                         "runs, B8 H12 T512 Dh64 rate %g %s"
                         % (what, DROPOUT, name), runs[0][i], runs[1][i])


def kernel_flash_bwd(checks, torch, gen):
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    b, h, t, dh = 8, 12, SEQ, 64
    main_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = _dname(dtype)
        q, k, v, bias = _flash_inputs(torch, b, h, t, dh, dtype, gen)
        for rate in (0.0, DROPOUT):
            err, _ = _flash_bwd_case(
                checks, torch, fa, "B8 H12 T512 Dh64 padded keys rate %g %s"
                % (rate, name), q, k, v, bias, False, rate, gen)
            if rate:  # the timed rows' errors: f32, and bf16 suffixed
                main_err.update(err if dtype == torch.float32 else {
                    kname + "_bf16": e for kname, e in err.items()})
        _flash_bwd_determinism(checks, torch, fa, name, q, k, v, bias, gen)
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
        # Dh 30 (f32) and 100 (bf16): rows of Dh elements are not whole
        # 16-byte chunks; with ``shift`` the tensors are not 16-byte
        # aligned: both stage their tiles by plain loads, not cp.async
        odd_dh = 30 if dtype == torch.float32 else 100
        for t_, dh_, rate, shift in ((200, 96, 0.0, False),
                                     (256, 128, DROPOUT, False),
                                     (200, odd_dh, DROPOUT, False),
                                     (200, 64, DROPOUT, True)):
            q, k, v, bias = _flash_inputs(torch, 2, 2, t_, dh_, dtype, gen)
            _flash_bwd_case(checks, torch, fa, "B2 H2 T%d Dh%d rate %g%s %s"
                            % (t_, dh_, rate, ", 4 bytes off 16-byte "
                               "alignment" if shift else "", name),
                            q, k, v, bias, False, rate, gen, shift)
    return main_err


def kernel_ln(checks, torch, gen):
    from paddle_tpu_torch.ops.cuda import fused_ln as fl

    fwd_err = bwd_err = bwd_bf16_err = None
    for dtype in (torch.float32, torch.bfloat16):
        name = _dname(dtype)
        for n, d in ((4096, 768), (37, 640), (8, 4096)):
            x, res, dout = (torch.randn((n, d), generator=gen, device="cuda")
                            .to(dtype) for _ in range(3))
            g = torch.randn((d,), generator=gen, device="cuda")
            bt = torch.randn((d,), generator=gen, device="cuda")
            for rate in (0.0, DROPOUT):
                seed = drop_seed() if rate else None
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
                if dtype == torch.bfloat16 and (n, d) == (4096, 768) and rate:
                    bwd_bf16_err = max(errs)
    kernel_ln_fwd_edges(checks, torch, fl, gen)
    kernel_ln_bwd_edges(checks, torch, fl, gen)
    return fwd_err, bwd_err, bwd_bf16_err


# the K2 forward's own cases (rows, columns, x and residual 4 bytes off
# 16-byte alignment): the decode step's 8 rows, a prefill's 512, rows
# that leave the grid's last stride partial, rows of 30 and 1000 columns
# (not whole 16-byte chunks: scalar accesses), 1000 and 4096 (a team of
# several warps)
LN_FWD_CASES = ((8, 768, False), (512, 768, False), (4133, 768, False),
                (4096, 768, True), (300, 30, False), (300, 1000, False),
                (37, 1000, True), (4096, 4096, False), (37, 4096, True))


def kernel_ln_fwd_edges(checks, torch, fl, gen):
    """The K2 forward's own cases (``LN_FWD_CASES``) in float32 and bf16
    at rates 0 and 0.1, out (with and without the saved statistics), y,
    mean and rstd against the plain version at kernel_ln's tolerances;
    the keep fraction of every dropping case's mask (drawn on x = 1, res
    = 0, so a kept cell is never 0); two runs bit for bit; and bf16 gamma
    and beta (the AMP path's form) against the same values widened to
    float32, bit for bit."""
    for dtype in (torch.float32, torch.bfloat16):
        name = _dname(dtype)
        for n, d, shift in LN_FWD_CASES:
            x, res = (torch.randn((n, d), generator=gen, device="cuda")
                      .to(dtype) for _ in range(2))
            g = torch.randn((d,), generator=gen, device="cuda")
            bt = torch.randn((d,), generator=gen, device="cuda")
            kx, kr = ((_shifted(torch, x), _shifted(torch, res)) if shift
                      else (x, res))
            for rate in (0.0, DROPOUT):
                drop = (rate, drop_seed() if rate else None)
                case = "N%d D%d rate %g%s %s" % (
                    n, d, rate, ", x and res 4 bytes off 16-byte alignment"
                    if shift else "", name)
                runs = [fl.fused_dropout_add_ln_fwd(
                    kx, kr, g, bt, 1e-5, *drop, save_stats=True)
                    for _ in range(2)]
                serve = fl.fused_dropout_add_ln_fwd(kx, kr, g, bt, 1e-5,
                                                    *drop)
                ref = fl.fused_dropout_add_ln_fwd_plain(x, res, g, bt, 1e-5,
                                                        *drop)
                torch.cuda.synchronize()
                checks.check("fused_dropout_add_ln_fwd", case,
                             max(max_err(runs[0][0], ref[0]),
                                 max_err(serve, ref[0])),
                             _tol(ref[0], units=1))
                for i, what in enumerate(("out", "y", "mean", "rstd")):
                    if i:
                        checks.check("fused_dropout_add_ln_fwd",
                                     "%s, %s" % (what, case),
                                     max_err(runs[0][i], ref[i]),
                                     _tol(ref[i], units=1))
                    _same_bits_check(checks, torch, "fused_dropout_add_ln_fwd",
                                     "%s bit-identical over two runs, %s"
                                     % (what, case), runs[0][i], runs[1][i])
                if rate:  # x = 1, res = 0: y is 0 where dropped
                    ones = torch.ones_like(kx)
                    kept = fl.fused_dropout_add_ln_fwd(
                        ones, ones * 0, g, bt, 1e-5, *drop,
                        save_stats=True)[1] != 0
                    _keep_fraction_check(checks, "fused_dropout_add_ln_fwd",
                                         kept, rate)
            if dtype == torch.bfloat16:
                gb, bb = g.to(dtype), bt.to(dtype)
                drop = (DROPOUT, drop_seed())
                got = fl.fused_dropout_add_ln_fwd(kx, kr, gb, bb, 1e-5,
                                                  *drop, save_stats=True)
                wide = fl.fused_dropout_add_ln_fwd(kx, kr, gb.float(),
                                                   bb.float(), 1e-5, *drop,
                                                   save_stats=True)
                torch.cuda.synchronize()
                for i, what in enumerate(("out", "y", "mean", "rstd")):
                    _same_bits_check(
                        checks, torch, "fused_dropout_add_ln_fwd",
                        "%s with bf16 gamma/beta = widened, N%d D%d rate %g"
                        % (what, n, d, DROPOUT), got[i], wide[i])
            del x, res, kx, kr


def kernel_ln_bwd_edges(checks, torch, fl, gen):
    """The K2 backward's own cases: two runs bit for bit (dx, dres, dgamma,
    dbeta: the partials are summed in a fixed order), D = 4096 over many
    rows (8 warps a row), ragged N, rows that are not whole 16-byte chunks
    (scalar accesses), and dout and y 4 bytes off 16-byte alignment;
    tolerances as kernel_ln's."""
    for dtype in (torch.float32, torch.bfloat16):
        name = _dname(dtype)
        for n, d, shift in ((4096, 768, False), (4096, 768, True),
                            (300, 4096, False), (37, 4096, True),
                            (37, 30, False), (300, 770, False),
                            (37, 2050, True)):
            x, res, dout = (torch.randn((n, d), generator=gen,
                                        device="cuda").to(dtype)
                            for _ in range(3))
            g = torch.randn((d,), generator=gen, device="cuda")
            bt = torch.randn((d,), generator=gen, device="cuda")
            drop = (DROPOUT, drop_seed())
            _, y, mean, rstd = fl.fused_dropout_add_ln_fwd(
                x, res, g, bt, 1e-5, *drop, save_stats=True)
            kd, ky = ((_shifted(torch, dout), _shifted(torch, y)) if shift
                      else (dout, y))
            runs = [fl.fused_dropout_add_ln_bwd(kd, ky, g, mean, rstd, *drop)
                    for _ in range(2)]
            refs = fl.fused_dropout_add_ln_bwd_plain(dout, y, g, mean, rstd,
                                                     *drop)
            torch.cuda.synchronize()
            case = "N%d D%d rate %g%s %s" % (
                n, d, DROPOUT, ", dout and y 4 bytes off 16-byte alignment"
                if shift else "", name)
            for i, what in enumerate(("dx", "dres", "dgamma", "dbeta")):
                checks.check("fused_dropout_add_ln_bwd",
                             "%s, %s" % (what, case),
                             max_err(runs[0][i], refs[i]), _tol(refs[i]))
                _same_bits_check(checks, torch, "fused_dropout_add_ln_bwd",
                                 "%s bit-identical over two runs, %s"
                                 % (what, case), runs[0][i], runs[1][i])
            if dtype == torch.bfloat16:
                # gamma in x's dtype, read as the widened float32 gamma
                gb = g.to(dtype)
                got = fl.fused_dropout_add_ln_bwd(kd, ky, gb, mean, rstd,
                                                  *drop)
                wide = fl.fused_dropout_add_ln_bwd(kd, ky, gb.float(), mean,
                                                   rstd, *drop)
                torch.cuda.synchronize()
                for i, what in enumerate(("dx", "dres", "dgamma", "dbeta")):
                    _same_bits_check(
                        checks, torch, "fused_dropout_add_ln_bwd",
                        "%s with bf16 gamma = widened, %s" % (what, case),
                        got[i], wide[i])


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


def _decode_cases():
    """(sequences, heads, Tmax, Dh, lengths) of ``kernel_decode``: the
    main path's shape with mixed lengths, Dh 128, a short cache; then 64
    sequences x 12 heads of seeded lengths (a launch whose counters, left
    non-zero, would break the smaller launches after it); then lengths on
    the kernels' chunk edges (C - 1, C, C + 1, 2C, Tmax) beside an empty
    row, in a cache whose depth is no multiple of the chunk, at Dh 64
    and 128."""
    from paddle_tpu_torch.ops.cuda.flash_decode import kernel_chunk

    many = tuple((i * 389) % (DECODE_TMAX + 1) for i in range(63)) \
        + (DECODE_TMAX,)
    cases = [(8, 12, DECODE_TMAX, 64, DECODE_KERNEL_LENGTHS),
             (3, 4, 256, 128, (0, 17, 256)),
             (2, 2, 96, 64, (1, 95)),
             (64, 12, DECODE_TMAX, 64, many)]
    for dh in (64, 128):
        c = kernel_chunk(dh)
        cases.append((6, 4, 300, dh, (0, c - 1, c, c + 1, 2 * c, 300)))
    return cases


def _decode_kernel_checks(checks, torch, kernel, case, run, plain, twin,
                          lens):
    """One decode kernel against its plain version and its chunked twin,
    length-0 rows exactly 0, and a rerun bit for bit; returns the error
    against the plain version."""
    got, again = run(), run()
    ref, ref_twin = plain(), twin()
    torch.cuda.synchronize()
    err = checks.check(kernel, case, max_err(got, ref), _decode_tol(ref))
    checks.check(kernel, "vs the chunked twin, " + case,
                 max_err(got, ref_twin), _decode_tol(ref_twin))
    _same_bits_check(checks, torch, kernel, "rerun bit for bit, " + case,
                     got, again)
    if 0 in lens:
        checks.check(kernel, "length-0 rows are 0, " + case,
                     float(got[[i for i, n in enumerate(lens) if n == 0]]
                           .float().abs().max()), 0.0)
    return got, err


def kernel_decode(checks, torch, gen):
    """K5 and K6 against their plain versions and their chunked twins
    (``*_chunked_plain`` at the kernels' chunk), length-0 rows exactly 0,
    each run twice bit for bit, in float32 and bfloat16, at every
    ``_decode_cases`` shape; for K6 shuffled block ids, -1 tails, a pool
    larger than the tables, block_len 16 and 32 (tables ceil(Tmax / BL)
    deep), and the same cache rows through K5."""
    from paddle_tpu_torch.ops.cuda import flash_decode as fd
    from paddle_tpu_torch.ops.cuda import paged_flash_decode as pfd

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = _dname(dtype)
        for b, h, t, dh, lens in _decode_cases():
            q, k, v, ln = _decode_ring_inputs(torch, gen, b, h, t, dh, dtype,
                                              lens)
            case = "B%d H%d Tmax%d Dh%d lengths %s %s" % (
                b, h, t, dh, list(lens) if b <= 8 else "seeded", name)
            _, err = _decode_kernel_checks(
                checks, torch, "flash_decode_fwd", case,
                lambda: fd.flash_decode(q, k, v, ln),
                lambda: fd.flash_decode_plain(q, k, v, ln),
                lambda: fd.flash_decode_chunked_plain(q, k, v, ln,
                                                      fd.kernel_chunk(dh)),
                lens)
            main_shape = dtype == torch.float32 and (b, t) == (8, DECODE_TMAX)
            if main_shape:
                errs["flash_decode_fwd"] = err
            del k, v
            for bl in (16, 32):
                mb = -(-t // bl)
                pool = b * mb + 37
                table = _paged_tables(torch, gen, lens, bl, mb, pool)
                kp, vp = (torch.randn((pool, h, bl, dh), generator=gen,
                                      device="cuda").to(dtype)
                          for _ in range(2))
                pcase = ("S%d H%d BL%d MB%d pool %d shuffled, -1 tails, "
                         "Dh%d lengths %s %s"
                         % (b, h, bl, mb, pool, dh,
                            list(lens) if b <= 8 else "seeded", name))
                got, err = _decode_kernel_checks(
                    checks, torch, "paged_flash_decode_fwd", pcase,
                    lambda: pfd.paged_flash_decode(q, kp, vp, ln, table),
                    lambda: pfd.paged_flash_decode_plain(q, kp, vp, ln,
                                                         table),
                    lambda: pfd.paged_flash_decode_chunked_plain(
                        q, kp, vp, ln, table, fd.kernel_chunk(dh)),
                    lens)
                if main_shape and bl == 16:
                    errs["paged_flash_decode_fwd"] = err
                # the same cache rows through the ring kernel: the same
                # chunks and merge order, so the same bits
                ring = fd.flash_decode(
                    q, pfd.gather_paged_cache(kp, table).contiguous(),
                    pfd.gather_paged_cache(vp, table).contiguous(), ln)
                torch.cuda.synchronize()
                _same_bits_check(checks, torch, "paged_flash_decode_fwd",
                                 "vs the ring kernel on the gathered rows, "
                                 "bit for bit, " + pcase, got, ring)
                del kp, vp, ring
    torch.cuda.empty_cache()
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
    sequences x 12 heads, Dh 64, Tmax 1024) with the mixed lengths of
    the checks, and with every row full, in float32 (the kernels line's
    rows: the mixed lengths) and bfloat16; the bound counts the live
    rows only.  K5's yardstick is one masked
    ``scaled_dot_product_attention``; K6 has no single library call, so
    the gather + SDPA pair (two calls, a yardstick only) is timed beside
    it."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import flash_decode as fd
    from paddle_tpu_torch.ops.cuda import paged_flash_decode as pfd

    src = "paddle_tpu_torch/csrc/flash_decode.cu"
    b, h, t, dh, bl = 8, 12, DECODE_TMAX, 64, 16
    mb = t // bl
    rows, extra = [], []
    # the method's floor: one launch of a kernel that does no work
    floor = time_ms(lambda: torch.cuda._sleep(0), 50)
    for dtype in (torch.float32, torch.bfloat16):
        name, esize = _dname(dtype), dtype.itemsize
        for lens in (DECODE_KERNEL_LENGTHS, (t,) * b):
            main = dtype == torch.float32 and lens == DECODE_KERNEL_LENGTHS
            q, k, v, ln = _decode_ring_inputs(torch, gen, b, h, t, dh,
                                              dtype, lens)
            mask = (torch.arange(t, device="cuda")[None, :] < ln[:, None]
                    )[:, None, None, :]
            q4 = q[:, :, None, :]
            sdpa = time_ms(lambda: F.scaled_dot_product_attention(
                q4, k, v, attn_mask=mask), 50)
            shape = "q [8,12,64], k/v [8,12,1024,64] %s, lengths %s" % (
                name, list(lens))
            r = _row("flash_decode_fwd", src,
                     "paddle_tpu/ops/pallas/flash_decode.py:178",
                     errs.get("flash_decode_fwd"),
                     time_ms(lambda: fd.flash_decode(q, k, v, ln), 50),
                     time_ms(lambda: fd.flash_decode_plain(q, k, v, ln), 50),
                     _decode_bound(lens, h, dh, esize, b * h), sdpa, shape)
            r["ms_clean_l2"] = time_ms(lambda: fd.flash_decode(q, k, v, ln),
                                       50, clean_l2=True)
            r["launch_floor_ms"] = floor
            (rows if main else extra).append(r)
            table = _paged_tables(torch, gen, lens, bl, mb, b * mb)
            kp, vp = (torch.randn((b * mb, h, bl, dh), generator=gen,
                                  device="cuda").to(dtype)
                      for _ in range(2))
            r = _row("paged_flash_decode_fwd", src,
                     "paddle_tpu/ops/pallas/paged_flash_decode.py:185",
                     errs.get("paged_flash_decode_fwd"),
                     time_ms(lambda: pfd.paged_flash_decode(q, kp, vp, ln,
                                                            table), 50),
                     time_ms(lambda: pfd.paged_flash_decode_plain(
                         q, kp, vp, ln, table), 50),
                     _decode_bound(lens, h, dh, esize, b * h,
                                   4 * int((table >= 0).sum())),
                     None, "q [8,12,64], pools [512,12,16,64] %s, shuffled "
                     "tables [8,64], lengths %s" % (name, list(lens)))
            r["gather_sdpa_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(
                    q4, pfd.gather_paged_cache(kp, table),
                    pfd.gather_paged_cache(vp, table), attn_mask=mask), 50)
            r["ms_clean_l2"] = time_ms(lambda: pfd.paged_flash_decode(
                q, kp, vp, ln, table), 50, clean_l2=True)
            r["launch_floor_ms"] = floor
            (rows if main else extra).append(r)
    return rows, extra


def profile_decode_kernels(torch, gen, calls=20):
    """Device us per call of K5 and K6 alone (``torch.profiler``: the
    kernels' own span, without the launch that ``time_ms`` counts), L2
    flushed by a read before every call, f32 at the decode path's shape
    (8 x 12 rows, Dh 64, Tmax 1024, tables of 64 blocks of 16) with the
    kernels line's mixed and full lengths and with the cursors of the
    decode step's profile (``_decode_step_feed``: 102 to 460); and the
    host's us per call of each wrapper (``calls`` calls enqueued back to
    back, nothing waited for), which the host-bound decode step pays 12
    times."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops.cuda import flash_decode as fd
    from paddle_tpu_torch.ops.cuda import paged_flash_decode as pfd

    b, h, t, dh, bl = 8, 12, DECODE_TMAX, 64, 16
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    step = tuple(int(n) for n in np.linspace(t // 10, t * 45 // 100, b)
                 .astype("int32"))
    out = {"phase": "kernels", "decode_kernels_us_per_call": {},
           "host_us_per_call": {},
           "shape": "q [8,12,64] f32, Tmax 1024, pools [512,12,16,64]"}
    for name, lens in (("mixed", DECODE_KERNEL_LENGTHS),
                       ("full", (t,) * b), ("step cursors", step)):
        q, k, v, ln = _decode_ring_inputs(torch, gen, b, h, t, dh,
                                          torch.float32, lens)
        table = _paged_tables(torch, gen, lens, bl, t // bl, b * t // bl)
        kp, vp = (torch.randn((b * t // bl, h, bl, dh), generator=gen,
                              device="cuda") for _ in range(2))
        for kernel, call in (
                ("flash_decode_fwd", lambda: fd.flash_decode(q, k, v, ln)),
                ("paged_flash_decode_fwd",
                 lambda: pfd.paged_flash_decode(q, kp, vp, ln, table))):
            call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                call()
            out["host_us_per_call"]["%s, %s" % (kernel, name)] = \
                (time.perf_counter() - t0) / calls * 1e6
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    flush.sum()
                    call()
                torch.cuda.synchronize()
            us = 0.0
            for ev in prof.key_averages():
                dev_us = getattr(ev, "self_device_time_total", None)
                if dev_us is None:
                    dev_us = getattr(ev, "self_cuda_time_total", 0)
                if "decode_kernel" in ev.key:
                    us += dev_us
            out["decode_kernels_us_per_call"]["%s, %s %s" % (
                kernel, name, list(lens))] = us / calls if us \
                else "not measured"
    return out


def _row(name, source, replaces, err, ms, plain_ms, bound, library_ms,
         shape):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library_ms, "shape": shape}


def _tc_bound_ms(nbytes, flops, f32):
    """The least time of work done on the tensor cores: float32 products
    as 3xTF32 (three TF32 products each, at 495 TFLOP/s), bf16 at 989;
    below the 67 TFLOP/s float32 rate of the CUDA cores, which is no
    bound for a kernel that does not use them."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (3 * flops / TF32_FLOPS if f32
             else flops / PEAK_FLOPS["bfloat16"]) * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def time_flash_bwd(torch, gen, errs, dtype):
    """The dK/dV and dQ kernels' rows at the training path's shape
    ([96, 512, 64], dropout 0.1) in ``dtype``, each bound by the tensor
    cores that the kernels run on (``_tc_bound_ms``).  Plain and library
    ms are of the whole backward (SDPA's backward in the same dtype, its
    kernels' device time, ``_grad_device_ms``)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    b, h, t, dh = 8, 12, SEQ, 64
    bh = b * h
    name = _dname(dtype)
    f32 = dtype == torch.float32
    q, k, v, bias = _flash_inputs(torch, b, h, t, dh, dtype, gen)
    sc = dh ** -0.5
    drop = (DROPOUT, drop_seed())
    o, m, l = fa.flash_attention_fwd(q, k, v, bias, dropout_rate=DROPOUT,
                                     dropout_seed=drop_seed())
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    delta = (do.float() * o.float()).sum(dim=-1)
    plain = time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, bias, o, m, l, do, False, sc, *drop))
    q4, k4, v4 = (x.view(b, h, t, dh) for x in (q, k, v))
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q4, k4, v4))
    lo = F.scaled_dot_product_attention(
        qg, kg, vg, attn_mask=bias.view(b, 1, 1, t).to(dtype),
        dropout_p=DROPOUT)
    lib = _grad_device_ms(torch, lo, (qg, kg, vg), do.view(b, h, t, dh))
    esize = 4 if f32 else 2
    # q, k, v, dO read; m, l, delta (f32) and the bias read
    io = esize * 4 * bh * t * dh + 4 * (3 * bh * t + b * t)
    rows = []
    for kernel, line, outs, flops, fn in (
            ("flash_attention_bwd_dkv", "473", 2, 8 * bh * t * t * dh,
             lambda: fa.flash_attention_bwd_dkv(
                 q, k, v, bias, do, m, l, delta, False, None, *drop)),
            ("flash_attention_bwd_dq", "521", 1, 6 * bh * t * t * dh,
             lambda: fa.flash_attention_bwd_dq(
                 q, k, v, bias, do, m, l, delta, False, None, *drop))):
        r = _row(kernel, "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                 "paddle_tpu/ops/pallas/flash_attention.py:" + line,
                 errs.get(kernel if f32 else kernel + "_bf16"),
                 time_ms(fn), plain,
                 _tc_bound_ms(io + esize * outs * bh * t * dh, flops, f32),
                 lib, "q,k,v,dO [96,512,64] %s, dropout 0.1; plain and "
                 "library ms are of the whole backward (dQ, dK, dV), the "
                 "library's its kernels' device time" % name)
        rows.append(r)
    del q, k, v, o, do, qg, kg, vg, lo
    return rows


def time_flash_fwd(torch, gen, errs):
    """The K1 forward's rows at the training path's shape ([96, 512, 64],
    bias [8, 512]): float32 at rates 0.1 (training) and 0 (serving), and
    bf16 at 0.1, beside SDPA in the same dtype and at the same rate, each
    bound by the tensor cores the kernel runs on (``_tc_bound_ms``).
    ``errs`` gives the rows' errors (``kernel_flash``'s), where known."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    rows = []
    b, h, t, dh = 8, 12, SEQ, 64
    bh = b * h
    sc = dh ** -0.5
    for dtype, rate in ((torch.float32, DROPOUT), (torch.float32, 0.0),
                        (torch.bfloat16, DROPOUT)):
        f32 = dtype == torch.float32
        esize = 4 if f32 else 2
        q, k, v, bias = _flash_inputs(torch, b, h, t, dh, dtype, gen)
        q4, k4, v4 = (x.view(b, h, t, dh) for x in (q, k, v))
        mask4 = bias.view(b, 1, 1, t).to(dtype)
        seed = drop_seed() if rate else None
        ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, bias,
                                                    dropout_rate=rate,
                                                    dropout_seed=seed))
        plain = time_ms(lambda: fa.flash_attention_fwd_plain(
            q, k, v, bias, sm_scale=sc, dropout_rate=rate,
            dropout_seed=seed))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask4, dropout_p=rate))
        # q, k, v read and o written; the bias read, m and l written
        bound = _tc_bound_ms(
            esize * 4 * bh * t * dh + 4 * (b * t + 2 * bh * t),
            4 * bh * t * t * dh, f32)
        rows.append(_row(
            "flash_attention_fwd", "paddle_tpu_torch/csrc/flash_attention.cu",
            "paddle_tpu/ops/pallas/flash_attention.py:266",
            errs.get("flash_attention_fwd" + ("" if f32 else "_bf16")), ms,
            plain, bound, lib, "q,k,v [96,512,64] %s, bias [8,512], dropout "
            "%g" % (_dname(dtype), rate)))
        del q, k, v, q4, k4, v4, mask4
    return rows


def time_ln_bwd(torch, gen, errs):
    """The K2 backward's rows at the training path's shape ([4096, 768],
    dropout 0.1), float32 then bf16, beside ``layer_norm``'s backward in
    the same dtype (gamma and beta in that dtype for the library call,
    float32 for the kernel; its kernels' device time,
    ``_grad_device_ms``), bound by the bytes it moves.  ``errs`` gives
    the rows' errors (``kernel_ln``'s), where known."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import fused_ln as fl

    rows = []
    n, d = 4096, 768
    drop = (DROPOUT, drop_seed())
    g = torch.randn((d,), generator=gen, device="cuda")
    bt = torch.randn((d,), generator=gen, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        esize = 4 if f32 else 2
        x, res, dout = (torch.randn((n, d), generator=gen, device="cuda")
                        .to(dtype) for _ in range(3))
        _, y, mean, rstd = fl.fused_dropout_add_ln_fwd(
            x, res, g, bt, 1e-5, *drop, save_stats=True)
        xr, rr, gr, br = (a.detach().clone().to(dtype).requires_grad_()
                          for a in (x, res, g, bt))
        rows.append(_row(
            "fused_dropout_add_ln_bwd", "paddle_tpu_torch/csrc/fused_ln.cu",
            "paddle_tpu/ops/pallas/fused_ln.py:224",
            errs.get("fused_dropout_add_ln_bwd" + ("" if f32 else "_bf16")),
            time_ms(lambda: fl.fused_dropout_add_ln_bwd(
                dout, y, g, mean, rstd, *drop), 50),
            time_ms(lambda: fl.fused_dropout_add_ln_bwd_plain(
                dout, y, g, mean, rstd, *drop), 50),
            # dout, y read, dx, dres written; gamma read, dgamma and dbeta
            # written (f32); mean and rstd read (f32)
            bound_ms(esize * 4 * n * d + 4 * (3 * d + 2 * n), 12 * n * d,
                     "float32"),
            _grad_device_ms(torch, F.layer_norm(xr + rr, (d,), gr, br,
                                                1e-5), (xr, rr, gr, br),
                            dout),
            "dout,y [4096,768] %s, dropout 0.1; library: layer_norm's "
            "backward, its kernels' device time" % _dname(dtype)))
        del x, res, dout, y, xr, rr
    return rows


def time_ln_fwd(torch, gen, errs, dtype):
    """The K2 forward's rows at the training path's shape ([4096, 768])
    in ``dtype``: dropout 0.1 with y/mean/rstd saved (training), then
    dropout 0 with out only (serving), then the decode step's 8 rows out
    only (its times and the launch floor only), gamma and beta float32,
    beside ``layer_norm(x + res)`` (gamma and beta in x's dtype), bound
    by the bytes moved.  Each row also holds the call's time after a
    read flush (``ms_clean_l2``), replayed from a CUDA graph
    (``ms_graph``), the kernel's own device time (``kernel_us_profiler``,
    ``torch.profiler``, write flush), and two floors under the same
    flushes: a launch that does no work, and ``torch.add(x, res,
    out=o)``, which moves the bytes of the out-only form.  The bf16 rows
    also time the AMP path's call, the op entry with bf16 gamma and beta
    (its whole call, and the kernel's own time).  ``errs`` gives the
    rows' errors (``kernel_ln``'s, ``kernel_amp``'s)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import fused_ln as fl

    n, d = 4096, 768
    name, esize = _dname(dtype), dtype.itemsize
    f32 = dtype == torch.float32
    x, res = (torch.randn((n, d), generator=gen, device="cuda").to(dtype)
              for _ in range(2))
    g = torch.randn((d,), generator=gen, device="cuda")
    bt = torch.randn((d,), generator=gen, device="cuda")
    gl, bl = g.to(dtype), bt.to(dtype)
    lib = time_ms(lambda: F.layer_norm(x + res, (d,), gl, bl, 1e-5), 50)
    o = torch.empty_like(x)
    floors = {}
    for key, fn in (("launch_floor", lambda: torch.cuda._sleep(0)),
                    ("add_floor", lambda: torch.add(x, res, out=o))):
        floors[key + "_ms"] = time_ms(fn, 50)
        floors[key + "_clean_l2_ms"] = time_ms(fn, 50, clean_l2=True)
    rows = []
    for rate, save in ((DROPOUT, True), (0.0, False)):
        drop = (rate, drop_seed() if rate else None)

        def call():
            return fl.fused_dropout_add_ln_fwd(x, res, g, bt, 1e-5, *drop,
                                               save_stats=save)

        err = errs.get("fused_dropout_add_ln_fwd" if f32 else
                       "fused_dropout_add_ln_fwd_bf16_rate%g" % rate)
        # x, res read, out (and y) written; gamma, beta read (f32); mean
        # and rstd written (f32) when saved
        r = _row("fused_dropout_add_ln_fwd",
                 "paddle_tpu_torch/csrc/fused_ln.cu",
                 "paddle_tpu/ops/pallas/fused_ln.py:190", err,
                 time_ms(call, 50),
                 time_ms(lambda: fl.fused_dropout_add_ln_fwd_plain(
                     x, res, g, bt, 1e-5, *drop), 50),
                 bound_ms(esize * (3 + save) * n * d + 4 * 2 * d
                          + (4 * 2 * n if save else 0),
                          (10 if save else 8) * n * d, "float32"),
                 lib, "x,res [4096,768] %s, dropout %g, %s" % (
                     name, rate, "y/mean/rstd saved" if save
                     else "out only (serving)"))
        r["ms_clean_l2"] = time_ms(call, 50, clean_l2=True)
        r["ms_graph"] = time_ms(call, 50, graph=True)
        r["kernel_us_profiler"] = sum(
            k["us_per_call"] for k in _kernel_split(
                torch, call, "add_ln_fwd_kernel", 20).values()) \
            or "not measured"
        r.update(floors)
        if not f32:  # the AMP path's call: the op entry, bf16 gamma/beta
            entry = lambda: fl.fused_dropout_add_ln(  # noqa: E731
                x, res, gl, bl, rate, 1e-5, drop[1])
            r["entry_ms_bf16_params"] = time_ms(entry, 50)
            r["entry_kernel_us_bf16_params"] = sum(
                k["us_per_call"] for k in _kernel_split(
                    torch, entry, "add_ln_fwd_kernel", 20).values()) \
                or "not measured"
        rows.append(r)
    # the decode step's call: 8 rows, out only
    x8, r8 = x[:8].clone(), res[:8].clone()
    r = _row("fused_dropout_add_ln_fwd", "paddle_tpu_torch/csrc/fused_ln.cu",
             "paddle_tpu/ops/pallas/fused_ln.py:190",
             errs.get("fused_dropout_add_ln_fwd" if f32 else
                      "fused_dropout_add_ln_fwd_bf16_rate0"),
             time_ms(lambda: fl.fused_dropout_add_ln_fwd(x8, r8, g, bt), 50),
             time_ms(lambda: fl.fused_dropout_add_ln_fwd_plain(
                 x8, r8, g, bt), 50),
             bound_ms(esize * 3 * 8 * d + 4 * 2 * d, 8 * 8 * d, "float32"),
             time_ms(lambda: F.layer_norm(x8 + r8, (d,), gl, bl, 1e-5), 50),
             "x,res [8,768] %s, dropout 0, out only (decode step)" % name)
    r["launch_floor_ms"] = floors["launch_floor_ms"]
    rows.append(r)
    del x, res, o, x8, r8
    return rows


def _grad_device_ms(torch, out, inputs, grad_out, calls=20):
    """Device ms of a library backward: ``torch.autograd.grad(out,
    inputs, grad_out)``'s kernels summed per call (``torch.profiler``),
    L2 flushed before every call by a negation of L2_FLUSH_BYTES (a
    read and a write, like ``time_ms``'s flush, under a kernel name no
    backward launches), so the autograd engine's host time stays out of
    the number.  A CUDA graph cannot hold SDPA's dropout backward apart
    from its forward: captured alone it reads the forward's host-side
    seed through a device pointer."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    for _ in range(3):
        torch.autograd.grad(out, inputs, grad_out, retain_graph=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.neg_()
            torch.autograd.grad(out, inputs, grad_out, retain_graph=True)
        torch.cuda.synchronize()
    us = 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if str(getattr(ev, "device_type", "")).endswith("CUDA") \
                and "neg_kernel" not in ev.key:
            us += dev_us
    return us / calls / 1e3 if us else None


def time_kernels(torch, gen, errs):
    """Cold-L2 times of every kernel at the training path's shapes and
    rate (K1, K2 at dropout 0.1; the forwards also at rate 0, as serving
    runs them), beside the plain version and one PyTorch library call."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import embedding as emb

    rows, extra = [], []
    fwd = time_flash_fwd(torch, gen, errs)
    rows.append(fwd[0])
    extra.extend(fwd[1:])
    for dtype in (torch.float32, torch.bfloat16):
        (rows if dtype == torch.float32 else extra).extend(
            time_flash_bwd(torch, gen, errs, dtype))

    ln_fwd = time_ln_fwd(torch, gen, errs, torch.float32)
    rows.append(ln_fwd[0])
    extra.extend(ln_fwd[1:])
    ln_bwd = time_ln_bwd(torch, gen, errs)
    rows.append(ln_bwd[0])
    extra.extend(ln_bwd[1:])

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
    return rows, extra


def profile_ln_bwd(torch, gen, calls=20):
    """The K2 backward's call at the training path's shape ([4096, 768]
    f32, dropout 0.1) split between its launches: device us per call of
    each kernel (``torch.profiler``, L2 flushed before every call) beside
    the call's CUDA-event time (``time_ms``), whose excess over the
    kernels' sum is the gap between the launches; and the same split in
    the AMP path's call form (bf16 throughout, through the op entry's
    autograd function)."""
    from paddle_tpu_torch.ops.cuda import fused_ln as fl

    n, d = 4096, 768
    x, res, dout = (torch.randn((n, d), generator=gen, device="cuda")
                    for _ in range(3))
    g = torch.randn((d,), generator=gen, device="cuda")
    bt = torch.randn((d,), generator=gen, device="cuda")
    drop = (DROPOUT, drop_seed())
    _, y, mean, rstd = fl.fused_dropout_add_ln_fwd(x, res, g, bt, 1e-5,
                                                   *drop, save_stats=True)

    def call():
        return fl.fused_dropout_add_ln_bwd(dout, y, g, mean, rstd, *drop)

    event_ms = time_ms(call, 50)
    kernels = _kernel_split(torch, call, "ln_bwd", calls)
    total = sum(k["us_per_call"] for k in kernels.values())
    # the AMP path's form: bf16 activations, gamma and beta through the op
    # entry, the backward's kernels alone out of the autograd call
    leaves = [t.to(torch.bfloat16).requires_grad_() for t in (x, res, g, bt)]
    out = fl.fused_dropout_add_ln(*leaves, dropout_rate=DROPOUT,
                                  seed=drop_seed())
    dout_bf = dout.to(torch.bfloat16)
    amp = _kernel_split(torch, lambda: torch.autograd.grad(
        out, leaves, dout_bf, retain_graph=True), "ln_bwd", calls)
    return {"phase": "kernels", "k2_bwd_split": kernels,
            "kernels_us_per_call": total if kernels else "not measured",
            "event_us_per_call": event_ms * 1e3,
            "shape": "dout,y [4096,768] f32, dropout 0.1",
            "k2_bwd_split_amp_entry": amp,
            "amp_entry_shape": "bf16 x, res, gamma, beta [4096,768] "
                               "through fused_dropout_add_ln, dropout 0.1"}


def _kernel_split(torch, call, needle, calls):
    """Device us per call of each kernel whose name holds ``needle``
    (``torch.profiler``, L2 flushed by a write before every call) and
    its launches per call."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            call()
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us and needle in ev.key:
            name = ev.key.replace("(anonymous namespace)::", "")
            kernels[name.split("(")[0][:80]] = {
                "us_per_call": dev_us / calls,
                "launches_per_call": ev.count / calls}
    return kernels


def profile_gather_bwd(torch, gen, calls=20):
    """K3 backward's call split between its two launches (device us per
    call, ``_kernel_split``) beside the call's CUDA-event
    time, at BERT-base's three tables with the training batch's ids."""
    from paddle_tpu_torch.ops.cuda import embedding as emb

    n = TRAIN_BATCH * SEQ
    dout = torch.randn((n, 768), generator=gen, device="cuda")
    out = {"phase": "kernels", "k3_bwd_split": {}}
    for label, table, layout in GATHER_BWD_CASES:
        ids = _gather_bwd_ids(torch, gen, table, layout)

        def call():
            return emb.embedding_gather_bwd(dout, ids, table)

        out["k3_bwd_split"][label] = {
            "kernels": _kernel_split(torch, call, "embedding_bwd_", calls),
            "event_us_per_call": time_ms(call, 50) * 1e3}
    return out


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


# ---------------------------------------------------------------------------
# K3 backward and the optimizer updates
# ---------------------------------------------------------------------------

# BERT-base's embedding tables and the training batch's ids: word (random
# over the vocabulary), position (each of 512 ids 8 times), token type
# (two ids over 4096 positions)
GATHER_BWD_CASES = (("word V30522", 30522, "random"),
                    ("position V512", 512, "positions"),
                    ("token type V2", 2, "halves"))
# K3 backward's device functions (csrc/embedding.cu): the rows, then the
# long rows; launches of one call at BERT's shapes
K3_BWD_FUNCTIONS = ("embedding_bwd_rows_kernel", "embedding_bwd_long_kernel")
K3_BWD_LAUNCHES = 2
# parameter shapes of the update checks: BERT-base's largest and smallest,
# ResNet-50's largest and smallest
UPDATE_SHAPES = ((30522, 768), (2,), (3, 3, 512, 512), (64,))
OPT_LR = 1e-3


def _gather_bwd_ids(torch, gen, rows, layout, n=TRAIN_BATCH * SEQ):
    if layout == "random":
        return torch.randint(0, rows, (n,), generator=gen, device="cuda")
    if layout == "positions":
        return torch.arange(rows, device="cuda").repeat(n // rows)
    if layout == "halves":
        return (torch.arange(n, device="cuda") >= n // 2).long()
    return torch.full((n,), 7, dtype=torch.int64, device="cuda")


def _device_kernels(torch, fn):
    """{device kernel or copy name: launches} of one call of ``fn()``
    under ``torch.profiler``, after an unrecorded call, between
    PROFILE_MARKERS marker kernels on each side; a profile that lost a
    marker (its edge records) is taken again, PROFILE_TRIES times in
    all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_MARKERS):
                torch.cuda._sleep(MARKER_CYCLES)
            fn()
            for _ in range(PROFILE_MARKERS):
                torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
        seen = {ev.key: ev.count for ev in prof.key_averages()
                if str(getattr(ev, "device_type", "")).endswith("CUDA")}
        markers = sum(n for k, n in seen.items() if MARKER_KERNEL in k)
        if markers == 2 * PROFILE_MARKERS:
            break
    return {k: n for k, n in seen.items() if MARKER_KERNEL not in k}


def kernel_gather_bwd(checks, torch, gen):
    """K3 backward (one pass over the table, then the long rows) against
    ``index_add_`` at a tolerance, against its sorted plain twin bit for
    bit, and run twice on the same inputs bit for bit: BERT-base's three
    tables at the training batch's ids, all 4096 ids alike, 20000 random
    ids (five of the chunks a block scans at once) and a ragged case (D
    100, negative ids, ids >= V, padding_idx, int32 ids), float32 and
    bfloat16.  Then one call at the
    word table under the profiler: K3_BWD_LAUNCHES launches, every one a
    kernel of K3_BWD_FUNCTIONS (no sort, memset or scatter of
    PyTorch's)."""
    from paddle_tpu_torch.ops.cuda import embedding as emb

    kernel = "embedding_gather_bwd"
    main_err = None
    cases = [(label, rows, _gather_bwd_ids(torch, gen, rows, layout), -1,
              768) for label, rows, layout in GATHER_BWD_CASES]
    cases.append(("all 4096 ids alike V30522", 30522,
                  _gather_bwd_ids(torch, gen, 30522, "same"), -1, 768))
    cases.append(("20000 random ids V30522 (five chunks)", 30522,
                  _gather_bwd_ids(torch, gen, 30522, "random", n=20000), -1,
                  768))
    ragged = torch.randint(-2, 1010, (1000,), generator=gen, device="cuda")
    ragged[:40] = 5
    cases.append(("ragged V1000 D100 n1000 int32, negative, >=V, "
                  "padding_idx 9", 1000, ragged.to(torch.int32), 9, 100))
    for dtype in (torch.float32, torch.bfloat16):
        for label, rows, ids, pad, d in cases:
            case = "%s %s" % (label, _dname(dtype))
            dout = torch.randn((ids.shape[0], d), generator=gen,
                               device="cuda").to(dtype)
            got = emb.embedding_gather_bwd(dout, ids, rows, pad)
            again = emb.embedding_gather_bwd(dout, ids, rows, pad)
            ref = emb.embedding_gather_bwd_plain(dout, ids, rows, pad)
            twin = emb.embedding_gather_bwd_sorted_plain(
                dout, emb.scatter_plan(ids, rows, pad), rows)
            torch.cuda.synchronize()
            err = checks.check(kernel, case + " vs index_add_",
                               max_err(got, ref), _tol(ref))
            checks.check(kernel, case + " vs its sorted plain twin, bits "
                         "differing", _bit_mismatches(got, twin), 0)
            checks.check(kernel, case + " twice, bits differing",
                         _bit_mismatches(got, again), 0)
            if dtype == torch.float32 and main_err is None:
                main_err = err
    ids = _gather_bwd_ids(torch, gen, 30522, "random")
    dout = torch.randn((ids.shape[0], 768), generator=gen, device="cuda")
    seen = _device_kernels(
        torch, lambda: emb.embedding_gather_bwd(dout, ids, 30522))
    emit({"phase": "kernels", "kernel": kernel,
          "device_kernels_a_call": seen})
    checks.check(kernel, "launches a call at the word table, off by",
                 abs(sum(seen.values()) - K3_BWD_LAUNCHES), 0)
    checks.check(kernel, "device work a call not of its kernels",
                 sum(n for k, n in seen.items()
                     if not any(f in k for f in K3_BWD_FUNCTIONS)), 0)
    return main_err


def _update_inputs(torch, gen, shape, dtype, step=3):
    """A parameter, its gradient, Adam's moments (m2 >= 0) and beta powers
    at step ``step``, a velocity and the learning rate, on the card."""
    def rnd(scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    powers = [torch.full((1,), b ** step, device="cuda").to(dtype)
              for b in (0.9, 0.999)]
    return {"p": rnd(), "g": rnd(0.1), "m1": rnd(0.01),
            "m2": rnd(1e-3).abs(), "b1p": powers[0], "b2p": powers[1],
            "v": rnd(0.1),
            "lr": torch.full((1,), OPT_LR, dtype=torch.float32,
                             device="cuda")}


def _clone_inputs(x):
    return {k: v.clone() for k, v in x.items()}


def _update_cases():
    """(kernel, label, in-place wrapper call, plain call) of each update:
    the call takes the inputs' dict and returns the updated tensors."""
    from paddle_tpu_torch.ops.cuda import optimizer as opt

    adam_args = ("p", "g", "lr", "m1", "m2", "b1p", "b2p")
    return (
        ("adam_update", "adam",
         lambda x: opt.adam_(*[x[k] for k in adam_args]),
         lambda x: opt.adam_plain(*[x[k] for k in adam_args])),
        ("momentum_update", "momentum",
         lambda x: opt.momentum_(x["p"], x["g"], x["v"], x["lr"], 0.9),
         lambda x: opt.momentum_plain(x["p"], x["g"], x["v"], x["lr"], 0.9)),
        ("momentum_update", "momentum nesterov",
         lambda x: opt.momentum_(x["p"], x["g"], x["v"], x["lr"], 0.9, True),
         lambda x: opt.momentum_plain(x["p"], x["g"], x["v"], x["lr"], 0.9,
                                      True)),
        ("sgd_update", "sgd",
         lambda x: (opt.sgd_(x["p"], x["g"], x["lr"]),),
         lambda x: (opt.sgd_plain(x["p"], x["g"], x["lr"]),)))


def kernel_updates(checks, torch, gen):
    """Each in-place update kernel against its plain twin bit for bit
    (every output: parameter, moments or velocity, beta powers), in
    float32 and bfloat16 at BERT-base's and ResNet-50's largest and
    smallest parameters, each writing into its inputs; then the
    multi-tensor Adam and SGD over BERT-base's parameter list against the
    per-parameter kernels, bit for bit."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in UPDATE_SHAPES:
            x = _update_inputs(torch, gen, shape, dtype)
            for kernel, label, run, plain in _update_cases():
                want = plain(x)
                mine = _clone_inputs(x)
                ptrs = {k: v.data_ptr() for k, v in mine.items()}
                got = run(mine)
                torch.cuda.synchronize()
                case = "%s %s %s" % (label, list(shape), _dname(dtype))
                bad = sum(_bit_mismatches(a, b) for a, b in zip(got, want))
                checks.check(kernel, case + ", bits differing", bad, 0)
                checks.check(kernel, case + ", outputs not in the inputs",
                             sum(t.data_ptr() not in ptrs.values()
                                 for t in got), 0)
                errs.setdefault(kernel, max(max_err(a, b)
                                            for a, b in zip(got, want)))
    errs.update(kernel_multi_updates(checks, torch, gen))
    kernel_sgd_layouts(checks, torch, gen)
    return errs


# lengths of the SGD layout checks: odd, past several blocks' chunks
# (csrc sgd_chunk: 2048 float32 elements), and the word embedding's
SGD_LENGTHS = (1, 7, 4097, 3 * 8192 + 5, 30522 * 768)
# (parameter, gradient) bytes past a 16-byte boundary: both aligned, both
# off (a scalar head and tail), the gradient alone off (all scalar)
SGD_OFFSETS = ((0, 0), (4, 4), (0, 4))


def kernel_sgd_layouts(checks, torch, gen):
    """SGD and the multi-tensor SGD over SGD_LENGTHS, parameter and
    gradient each float32 or bfloat16, at the SGD_OFFSETS views: the
    per-parameter kernel against ``sgd_plain`` bit for bit, and the
    multi-tensor kernel over the lengths against ``sgd_plain`` bit for
    bit, each writing into its views."""
    from paddle_tpu_torch.ops.cuda import optimizer as opt

    lr = torch.full((1,), OPT_LR, device="cuda")

    def view(base, off_bytes):
        return base[off_bytes // base.element_size():]

    for p_dtype in (torch.float32, torch.bfloat16):
        for g_dtype in (torch.float32, torch.bfloat16):
            for p_off, g_off in SGD_OFFSETS:
                case = "p %s +%dB, g %s +%dB" % (
                    _dname(p_dtype), p_off, _dname(g_dtype), g_off)
                bases, grads, wants, singles = [], [], [], []
                for n in SGD_LENGTHS:
                    base = torch.randn((n + 8,), generator=gen,
                                       device="cuda").to(p_dtype)
                    g = view((torch.randn((n + 8,), generator=gen,
                                          device="cuda") * 0.1).to(g_dtype),
                             g_off)[:n]
                    p = view(base, p_off)[:n]
                    wants.append(opt.sgd_plain(p, g, lr))
                    single = view(base.clone(), p_off)[:n]
                    opt.sgd_(single, g, lr)
                    bases.append(base)
                    grads.append(g)
                    singles.append(single)
                multi = [view(b.clone(), p_off)[:n]
                         for b, n in zip(bases, SGD_LENGTHS)]
                opt.multi_sgd_(multi, grads, lr)
                torch.cuda.synchronize()
                for n, want, single, mine in zip(SGD_LENGTHS, wants,
                                                 singles, multi):
                    checks.check("sgd_update", "%s n=%d vs sgd_plain, "
                                 "bits differing" % (case, n),
                                 _bit_mismatches(single, want), 0)
                    checks.check("multi_tensor_sgd", "%s n=%d vs sgd_plain, "
                                 "bits differing" % (case, n),
                                 _bit_mismatches(mine, want), 0)
                del bases, grads, wants, singles, multi
    torch.cuda.empty_cache()


def _bert_base_shapes():
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert

    main, _startup, _loss = _train_program(fluid, bert, bert.BERT_BASE, SEQ)
    return [tuple(p.shape) for p in main.all_parameters() if p.trainable]


def kernel_multi_updates(checks, torch, gen):
    """The multi-tensor kernels over BERT-base's parameters (each member
    at its own step, so each takes its own bias correction) against the
    per-parameter kernels on copies of the same inputs, bit for bit."""
    from paddle_tpu_torch.ops.cuda import optimizer as opt

    shapes = _bert_base_shapes()
    members = [_update_inputs(torch, gen, s, torch.float32, step=1 + i % 5)
               for i, s in enumerate(shapes)]
    lr = members[0]["lr"]
    ref = [_clone_inputs(m) for m in members]
    for m in ref:
        opt.adam_(m["p"], m["g"], lr, m["m1"], m["m2"], m["b1p"], m["b2p"])
        opt.sgd_(m["v"], m["g"], lr)  # the velocity stands in for a param
    got = [_clone_inputs(m) for m in members]

    def col(key):
        return [m[key] for m in got]

    opt.multi_adam_(col("p"), col("g"), lr, col("m1"), col("m2"),
                    col("b1p"), col("b2p"))
    opt.multi_sgd_(col("v"), col("g"), lr)
    torch.cuda.synchronize()
    errs = {}
    for kernel, keys in (("multi_tensor_adam", ("p", "m1", "m2", "b1p",
                                                "b2p")),
                         ("multi_tensor_sgd", ("v",))):
        bad = sum(_bit_mismatches(g[k], r[k]) for g, r in zip(got, ref)
                  for k in keys)
        checks.check(kernel, "BERT-base's %d parameters (%d elements) vs "
                     "the per-parameter kernels, bits differing"
                     % (len(shapes), sum(m["p"].numel() for m in members)),
                     bad, 0)
        errs[kernel] = max(max_err(g[k], r[k]) for g, r in zip(got, ref)
                           for k in keys)
    del members, ref, got
    torch.cuda.empty_cache()
    return errs


def _small_update_overhead(torch, gen, calls=200):
    """The device time of one small Adam update (768 elements: the update
    launch and its beta-power launch) in a replayed CUDA graph of
    ``calls`` of them, as the step runs it, and that time as bytes at
    3.35 TB/s: the CUDA default of the optimizer fusion's gate
    (``fusion._CUDA_OVERHEAD_BYTES``)."""
    from paddle_tpu_torch.ops.cuda import optimizer as opt

    small = _update_inputs(torch, gen, (768,), torch.float32)
    args = [small[k] for k in ("p", "g", "lr", "m1", "m2", "b1p", "b2p")]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            opt.adam_(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            opt.adam_(*args)
    graph.replay()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    us = start.elapsed_time(stop) / calls * 1e3
    del graph
    return {"name": "optimizer_fuse_overhead",
            "adam_update_768_in_a_graph_us": us,
            "as_bytes_at_3.35_TB_s": us * 1e-6 * HBM_BYTES_PER_S}


def time_updates(torch, gen, errs):
    """Rows of K3 backward and the update kernels at the main paths'
    shapes (cold L2): K3 backward at BERT-base's three tables (the word
    table's row in the kernels line, the position and token-type tables'
    as extra lines); Adam at BERT-base's word embedding [30522, 768] (the
    largest parameter); Momentum (Nesterov) at ResNet-50's [3, 3, 512,
    512]; SGD at the word embedding; the multi-tensor kernels over
    BERT-base's parameter list, timed from a captured CUDA graph.  K3
    backward and SGD also with L2 flushed by a read; the SGD rows also at
    views 4 bytes past a 16-byte boundary.  Library calls: ``index_add_`` into zeros for K3
    backward, and beside it the deterministic ``index_put_`` with
    ``accumulate=True``; for Nesterov Momentum
    ``torch._fused_sgd_`` (weight decay 0, dampening 0: the same function,
    checked here against the plain twin), for SGD ``add_`` with alpha
    -lr, for the multi-tensor SGD ``_foreach_add_``; none computes the
    reference's Adam (``torch.optim``'s puts eps elsewhere).  Also the
    launch and ramp of one small update (``_small_update_overhead``)."""
    from paddle_tpu_torch.ops.cuda import embedding as emb
    from paddle_tpu_torch.ops.cuda import optimizer as opt

    rows, extra = [], []
    src = "paddle_tpu_torch/csrc/optimizer.cu"
    ref_file = "paddle_tpu/ops/optimizer_ops.py:"
    n_ids = TRAIN_BATCH * SEQ
    dout = torch.randn((n_ids, 768), generator=gen, device="cuda")
    for label, table, layout in GATHER_BWD_CASES:
        ids = _gather_bwd_ids(torch, gen, table, layout)

        def library():
            return torch.zeros((table, 768), device="cuda").index_put_(
                (ids,), dout, accumulate=True)

        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            deterministic_ms = time_ms(library, 50)
        finally:
            torch.use_deterministic_algorithms(was)
        r = _row(
            "embedding_gather_bwd", "paddle_tpu_torch/csrc/embedding.cu",
            "paddle_tpu/ops/pallas/embedding.py:96 (XLA scatter-add of "
            "_gather_core_bwd)", errs["embedding_gather_bwd"],
            time_ms(lambda: emb.embedding_gather_bwd(dout, ids, table), 50),
            time_ms(lambda: emb.embedding_gather_bwd_plain(dout, ids, table),
                    50),
            bound_ms(4 * (table * 768 + n_ids * 768) + 8 * n_ids,
                     n_ids * 768, "float32"),
            time_ms(lambda: torch.zeros((table, 768), device="cuda")
                    .index_add_(0, ids, dout), 50),
            "%s table: dout [%d,768] f32, ids %s → table grad [%d,768]"
            % (label, n_ids, layout, table))
        r["ms_clean_l2"] = time_ms(
            lambda: emb.embedding_gather_bwd(dout, ids, table), 50,
            clean_l2=True)
        r["library_deterministic_ms"] = deterministic_ms
        r["library_deterministic"] = ("zeros.index_put_((ids,), dout, "
                                      "accumulate=True) under "
                                      "torch.use_deterministic_algorithms")
        (rows if table == GATHER_BWD_CASES[0][1] else extra).append(r)
    del dout

    x = _update_inputs(torch, gen, (30522, 768), torch.float32)
    n = x["p"].numel()
    adam_args = [x[k] for k in ("p", "g", "lr", "m1", "m2", "b1p", "b2p")]
    rows.append(_row(
        "adam_update", src, ref_file + "46 (adam; XLA in the reference)",
        errs["adam_update"], time_ms(lambda: opt.adam_(*adam_args), 20),
        time_ms(lambda: opt.adam_plain(*adam_args), 20),
        bound_ms(28 * n, 14 * n, "float32"), None,
        "[30522,768] f32 (BERT-base word embedding)"))
    sgd_args = (x["p"], x["g"], x["lr"])
    rows.append(_row(
        "sgd_update", src, ref_file + "22 (sgd; XLA in the reference)",
        errs["sgd_update"], time_ms(lambda: opt.sgd_(*sgd_args), 20),
        time_ms(lambda: opt.sgd_plain(*sgd_args), 20),
        bound_ms(12 * n, 2 * n, "float32"),
        time_ms(lambda: x["p"].add_(x["g"], alpha=-OPT_LR), 20),
        "[30522,768] f32"))
    rows[-1]["ms_clean_l2"] = time_ms(lambda: opt.sgd_(*sgd_args), 20,
                                      clean_l2=True)
    rows[-1]["library_ms_clean_l2"] = time_ms(
        lambda: x["p"].add_(x["g"], alpha=-OPT_LR), 20, clean_l2=True)
    # views 4 bytes past a 16-byte boundary: a scalar head and tail
    p_off, g_off = x["p"].view(-1)[1:], x["g"].view(-1)[1:]
    rows[-1]["ms_misaligned"] = time_ms(
        lambda: opt.sgd_(p_off, g_off, x["lr"]), 20)
    rows[-1]["library_ms_misaligned"] = time_ms(
        lambda: p_off.add_(g_off, alpha=-OPT_LR), 20)
    rows[-1]["bound_ms_misaligned"] = bound_ms(12 * (n - 1), 2 * (n - 1),
                                               "float32")[0]
    del x, adam_args, sgd_args, p_off, g_off

    y = _update_inputs(torch, gen, (3, 3, 512, 512), torch.float32)
    n = y["p"].numel()
    fused = getattr(torch, "_fused_sgd_", None)
    lib_ms, lib_note = None, "torch._fused_sgd_ not in this PyTorch"
    if fused is not None:
        def library():
            fused([y["p"]], [y["g"]], [y["v"]], weight_decay=0.0,
                  momentum=0.9, lr=OPT_LR, dampening=0.0, nesterov=True,
                  maximize=False, is_first_step=False)

        z = _clone_inputs(y)
        want = opt.momentum_plain(z["p"], z["g"], z["v"], z["lr"], 0.9, True)
        try:  # a yardstick only: its absence or refusal fails nothing
            fused([z["p"]], [z["g"]], [z["v"]], weight_decay=0.0,
                  momentum=0.9, lr=OPT_LR, dampening=0.0, nesterov=True,
                  maximize=False, is_first_step=False)
            lib_note = ("torch._fused_sgd_ (nesterov, dampening 0): the "
                        "reference's Nesterov update; max |diff| against "
                        "the plain twin %g (param), %g (velocity)"
                        % (max_err(z["p"], want[0]),
                           max_err(z["v"], want[1])))
            lib_ms = time_ms(library, 20)
        except (TypeError, RuntimeError) as e:
            lib_note = "torch._fused_sgd_ refused the call: %s" % e
        del z, want
    rows.append(_row(
        "momentum_update", src,
        ref_file + "28 (momentum; XLA in the reference)",
        errs["momentum_update"],
        time_ms(lambda: opt.momentum_(y["p"], y["g"], y["v"], y["lr"], 0.9,
                                      True), 20),
        time_ms(lambda: opt.momentum_plain(y["p"], y["g"], y["v"], y["lr"],
                                           0.9, True), 20),
        bound_ms(20 * n, 6 * n, "float32"), lib_ms,
        "[3,3,512,512] f32 Nesterov (ResNet-50's largest conv)"))
    rows[-1]["library_note"] = lib_note
    del y

    shapes = _bert_base_shapes()
    members = [_update_inputs(torch, gen, s, torch.float32)
               for s in shapes]
    n = sum(m["p"].numel() for m in members)
    lr = members[0]["lr"]

    def col(key):
        return [m[key] for m in members]

    madam = [col(k) for k in ("p", "g")] + [lr] + [
        col(k) for k in ("m1", "m2", "b1p", "b2p")]
    rows.append(_row(
        "multi_tensor_adam", src, ref_file + "366 (fused_adam)",
        errs["multi_tensor_adam"],
        time_ms(lambda: opt.multi_adam_(*madam), 10, graph=True),
        time_ms(lambda: [opt.adam_plain(*[a[i] if isinstance(a, list)
                                          else a for a in madam])
                         for i in range(len(shapes))], 3),
        bound_ms(28 * n + 16 * len(shapes), 14 * n, "float32"), None,
        "BERT-base's %d parameters, %d elements, f32" % (len(shapes), n)))
    rows.append(_row(
        "multi_tensor_sgd", src, ref_file + "347 (fused_sgd)",
        errs["multi_tensor_sgd"],
        time_ms(lambda: opt.multi_sgd_(col("p"), col("g"), lr), 10,
                graph=True),
        time_ms(lambda: [opt.sgd_plain(p, g, lr) for p, g in
                         zip(col("p"), col("g"))], 3),
        bound_ms(12 * n, 2 * n, "float32"),
        time_ms(lambda: torch._foreach_add_(col("p"), col("g"),
                                            alpha=-OPT_LR), 10, graph=True),
        "BERT-base's %d parameters, %d elements, f32" % (len(shapes), n)))
    p_off = [t.view(-1)[1:] for t in col("p")]
    g_off = [t.view(-1)[1:] for t in col("g")]
    rows[-1]["ms_misaligned"] = time_ms(
        lambda: opt.multi_sgd_(p_off, g_off, lr), 10, graph=True)
    rows[-1]["library_ms_misaligned"] = time_ms(
        lambda: torch._foreach_add_(p_off, g_off, alpha=-OPT_LR), 10,
        graph=True)
    rows[-1]["bound_ms_misaligned"] = bound_ms(
        12 * (n - len(shapes)), 2 * (n - len(shapes)), "float32")[0]
    del members, madam, p_off, g_off

    extra.append(_small_update_overhead(torch, gen))
    torch.cuda.empty_cache()
    return rows, extra


def kernel_graph_masks(checks, torch, gen):
    """The dropping kernels (K1 forward, dK/dV and dQ; K2 forward and
    backward) captured once in a CUDA graph, their seed read from a step
    tensor on the card, and the graph replayed at two steps: at each
    step every output matches its plain twin drawn at that step, and the
    outputs of the two steps differ (each mask moved)."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import fused_ln as fl
    from paddle_tpu_torch.ops.cuda.dropout import StepSeed

    step = torch.zeros((1,), dtype=torch.int64, device="cuda")
    seed = StepSeed(step, DROP_SALT)
    dh = 64
    q, k, v, bias = _flash_inputs(torch, 2, 12, SEQ, dh, torch.float32, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda")
    x, res, dout = (torch.randn((4096, 768), generator=gen, device="cuda")
                    for _ in range(3))
    g = torch.randn((768,), generator=gen, device="cuda")
    bt = torch.randn((768,), generator=gen, device="cuda")

    def launches():
        o, m, l = fa.flash_attention_fwd(q, k, v, bias, dropout_rate=DROPOUT,
                                         dropout_seed=seed)
        delta = (do * o).sum(dim=-1)
        args = (False, None, DROPOUT, seed)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, bias, do, m, l, delta,
                                            *args)
        dq = fa.flash_attention_bwd_dq(q, k, v, bias, do, m, l, delta, *args)
        out, y, mean, rstd = fl.fused_dropout_add_ln_fwd(
            x, res, g, bt, 1e-5, DROPOUT, seed, save_stats=True)
        dx = fl.fused_dropout_add_ln_bwd(dout, y, g, mean, rstd, DROPOUT,
                                         seed)[0]
        return o, m, l, dk, dv, dq, out, y, mean, rstd, dx

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launches()  # first use: the library, outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = launches()
    got = {}
    for s_ in (DROP_STEP, DROP_STEP + 1):
        step.fill_(s_)
        graph.replay()
        torch.cuda.synchronize()
        o, m, l, dk, dv, dq, out, y, mean, rstd, dx = \
            [t.clone() for t in outs]
        got[s_] = {"flash_attention_fwd": o, "flash_attention_bwd_dkv": dv,
                   "flash_attention_bwd_dq": dq,
                   "fused_dropout_add_ln_fwd": out,
                   "fused_dropout_add_ln_bwd": dx}
        po = fa.flash_attention_fwd_plain(q, k, v, bias, False, dh ** -0.5,
                                          DROPOUT, seed)[0]
        pq, pk, pv = fa.flash_attention_bwd_plain(
            q, k, v, bias, o, m, l, do, False, dh ** -0.5, DROPOUT, seed)
        pout = fl.fused_dropout_add_ln_fwd_plain(x, res, g, bt, 1e-5,
                                                 DROPOUT, seed)[0]
        pdx = fl.fused_dropout_add_ln_bwd_plain(dout, y, g, mean, rstd,
                                                DROPOUT, seed)[0]
        torch.cuda.synchronize()
        for kernel, what, a, ref in (
                ("flash_attention_fwd", "o", o, po),
                ("flash_attention_bwd_dkv", "dk", dk, pk),
                ("flash_attention_bwd_dkv", "dv", dv, pv),
                ("flash_attention_bwd_dq", "dq", dq, pq),
                ("fused_dropout_add_ln_fwd", "out", out, pout),
                ("fused_dropout_add_ln_bwd", "dx", dx, pdx)):
            checks.check(kernel, "%s, one launch in a CUDA graph replayed "
                         "at step %d, vs the plain twin at that step"
                         % (what, s_), max_err(a, ref), _tol(ref))
    a, b = got[DROP_STEP], got[DROP_STEP + 1]
    for kernel in a:
        moved = not torch.equal(a[kernel], b[kernel])
        checks.check(kernel, "replays at steps %d and %d differ (the mask "
                     "moved with the device step)"
                     % (DROP_STEP, DROP_STEP + 1), 0.0 if moved else 1.0,
                     0.0)
    del graph, outs, got


def phase_kernels():
    import torch

    gen = _gen(torch)
    checks = Checks()
    fwd = kernel_flash(checks, torch, gen)
    errs = {"flash_attention_fwd": fwd["float32"],
            "flash_attention_fwd_bf16": fwd["bfloat16"]}
    errs.update(kernel_flash_bwd(checks, torch, gen))
    errs["fused_dropout_add_ln_fwd"], errs["fused_dropout_add_ln_bwd"], \
        errs["fused_dropout_add_ln_bwd_bf16"] = kernel_ln(checks, torch, gen)
    errs["embedding_gather_fwd"] = kernel_gather(checks, torch, gen)
    errs["embedding_gather_bwd"] = kernel_gather_bwd(checks, torch, gen)
    errs.update(kernel_updates(checks, torch, gen))
    errs.update(kernel_decode(checks, torch, gen))
    errs.update(kernel_bn_act(checks, torch, gen))
    errs.update(kernel_quant(checks, torch, gen))
    kernel_graph_masks(checks, torch, gen)
    if checks.failed:
        raise AssertionError("kernel checks failed: %s"
                             % "; ".join(checks.failed))
    rows, extra = time_kernels(torch, gen, errs)
    update_rows, update_extra = time_updates(torch, gen, errs)
    emit(profile_ln_bwd(torch, gen))
    emit(profile_gather_bwd(torch, gen))
    decode_rows, decode_extra = time_decode_kernels(torch, gen, errs)
    emit(profile_decode_kernels(torch, gen))
    bn_rows, bn_extra = time_bn_act(torch, gen, errs)
    quant_rows, quant_extra = time_quant(torch, gen, errs)
    rows += update_rows + decode_rows + bn_rows + quant_rows
    for r in rows + extra + update_extra + decode_extra + bn_extra \
            + quant_extra:
        emit(dict({"phase": "kernels", "timing": True}, **r))
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


def _graphs_off(exe):
    """The captured graphs of ``exe`` whose kernel nodes (what a replay
    runs and counts) are not the launches their capture recorded."""
    return [{"captured": e.captured, "kernel_nodes": e.kernel_nodes}
            for e in exe._cache.values()
            if e.graph is not None and e.captured != e.kernel_nodes]


def _op_type_counts(program):
    """Op type → ops in ``program``'s global block."""
    out = {}
    for op in program.global_block().ops:
        out[op.type] = out.get(op.type, 0) + 1
    return out


def phase_main_path(env):
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.executor import Scope, scope_guard
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops.cuda import (KERNELS, launch_counts,
                                           launch_counts_by_source,
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
    finally:  # only the export: .smoke_tmp/ may hold other work
        shutil.rmtree(export_dir, ignore_errors=True)
    setup_s = time.time() - t0
    op_types = _op_type_counts(pred.program)
    emit({"phase": "main_path", "step": "export+load",
          "seconds": setup_s, "analyzed_ops": op_types})

    rng = np.random.RandomState(SEED)
    requests = [_bert_request(rng, r, cfg) for r in REQUEST_ROWS]
    server = serving.PredictorServer(
        {"bert": pred}, buckets=BUCKETS, auto_start=False)
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
        by_source = launch_counts_by_source()
    finally:
        server.close()
    batches = len(server.dispatch_log)
    want = dict.fromkeys(KERNELS, 0)
    want.update({"flash_attention_fwd": 12 * batches,
                 "fused_dropout_add_ln_fwd": 25 * batches,
                 "embedding_gather_fwd": 3 * batches})
    off = _graphs_off(pred._exe)
    emit({"phase": "main_path", "step": "serve", "batches": batches,
          "dispatch_log": server.dispatch_log, "launches": counts,
          "launches_by_source": by_source, "expected_launches": want,
          "graph_count": pred._exe.graph_count,
          "graphs_nodes_not_captured_launches": off})
    if counts != want or off:
        raise AssertionError("launch counts %s != %s per %d batches, or "
                             "graphs %s" % (counts, want, batches, off))
    serve_counts = by_source

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
    return serve_counts, pred, cfg


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


# the update kernels and their beta-power launches (csrc/optimizer.cu)
OPTIMIZER_KERNELS = ("adam_update_kernel", "adam_pow_kernel",
                     "momentum_update_kernel", "sgd_update_kernel",
                     "multi_adam_kernel", "multi_adam_pow_kernel",
                     "multi_sgd_kernel")


def _kernel_group(name):
    """The profile's group of a device kernel, by its name."""
    for group, needles in (
            ("K1 fwd", ("flash_fwd_kernel",)),
            ("K1 bwd", ("flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")),
            ("K2 fwd", ("add_ln_fwd_kernel",)),
            ("K2 bwd", ("add_ln_bwd_kernel", "ln_bwd_reduce_kernel")),
            ("gather", ("::gather_kernel<",)),
            ("K3 bwd", K3_BWD_FUNCTIONS),
            ("optimizer", OPTIMIZER_KERNELS),
            ("K6 paged decode", ("paged_decode_kernel<",)),
            ("K5 decode", ("decode_kernel<",)),
            ("scatter", ("indexFunc", "index_add", "scatter_add",
                         "index_put"))):
        if any(n in name for n in needles):
            return group
    low = name.lower()
    if any(n in low for n in ("gemm", "cutlass", "xmma", "nvjet")):
        return "GEMM"
    if "copy" in low:
        return "copies"
    if "elementwise" in low or "reduce" in low:
        return "elementwise"
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
        # kernel rows only: a CPU op's row repeats its kernels' time, and
        # a scheduled profile's ProfilerStep rows span whole steps
        if not dev_us or not str(getattr(ev, "device_type", "")).endswith(
                "CUDA") or ev.key.startswith("ProfilerStep") \
                or MARKER_KERNEL in ev.key:
            continue
        ms = dev_us / 1e3 / runs
        g = group(ev.key)
        groups[g] = groups.get(g, 0.0) + ms
        top.append((ms, ev.count // runs, ev.key[:90]))
    top.sort(reverse=True)
    return groups, top


def _group_launches(prof, runs, group):
    """Device launches per run by kernel group (``group(name)``)."""
    out = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA") \
                and MARKER_KERNEL not in ev.key:
            g = group(ev.key)
            out[g] = out.get(g, 0) + ev.count / runs
    return out


def _step_profile(exe, main, batch, fetch, group=None, runs=2, top_n=15):
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
        exe.run(main, feed=batch, fetch_list=fetch, return_numpy=False)
        dispatch_ms.append((time.perf_counter() - s0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s0 = time.perf_counter()
        for _ in range(runs):
            exe.run(main, feed=batch, fetch_list=fetch)
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
            "launches_by_group": _group_launches(prof, runs, group),
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


def _mlm_loss(fluid, bert, cfg, seq, max_pred):
    """Under a ``program_guard``: ``build_pretrain``'s masked-LM graph
    (the feeds, the encoder, the gathered head tied to the word
    embedding, the weighted token loss) → the loss."""
    L = fluid.layers
    main = fluid.default_main_program()
    ids = L.data("input_ids", shape=[seq], dtype="int64")
    types = L.data("token_type_ids", shape=[seq], dtype="int64")
    bias = L.data("attn_mask_bias", shape=[1, 1, seq], dtype="float32")
    labels = L.data("mlm_labels", shape=[max_pred], dtype="int64")
    weights = L.data("mlm_weights", shape=[max_pred], dtype="float32")
    mask_pos = L.data("mask_pos", shape=[max_pred], dtype="int64")
    x = bert.encoder(ids, types, bias, cfg, seq)
    row_t = L.fill_constant_batch_size_like(
        weights, shape=[-1, 1], dtype="int64", value=float(seq))
    offs = L.elementwise_sub(L.cumsum(row_t, axis=0), row_t)
    pos = L.reshape(L.elementwise_add(mask_pos, offs), shape=[-1])
    x = L.gather(L.reshape(x, shape=[-1, cfg.hidden]), pos)
    logits = L.matmul(x, main.global_block().var("bert.word_emb"),
                      transpose_y=True)
    tok = L.squeeze(L.softmax_with_cross_entropy(
        logits, L.reshape(labels, shape=[-1, 1])), [1])
    w = L.reshape(weights, shape=[-1])
    return L.elementwise_div(L.reduce_sum(L.elementwise_mul(tok, w)),
                             L.reduce_sum(w))


def recipe_program(fluid, bert, cfg, seq, max_pred=None):
    """The reference's flagship training program (``bench.py:2741-2770``:
    BERT MLM pretraining with the gathered head, ``cfg`` carrying
    ``fused_ln`` and ``fused_qkv``), trained as its users train it: bf16
    AMP through ``contrib.mixed_precision.decorate`` over
    ``LambOptimizer(lamb_weight_decay=0.01)``, the learning rate
    ``linear_lr_warmup(polynomial_decay(...))`` and the gradients clipped
    to a global norm of 1.  Built by the same code in either package
    (``fluid`` and its ``bert`` module).  ``decorate``'s ``minimize`` takes
    no ``grad_clip`` in either package, so the clip is set for the
    program (``set_gradient_clip``), which ``minimize(grad_clip=)`` does
    for the length of its call.  → ``(main, startup, loss, lr)``."""
    import importlib

    amp = importlib.import_module(fluid.__name__
                                  + ".contrib.mixed_precision")
    L = fluid.layers
    if max_pred is None:
        max_pred = bert.default_max_pred(seq)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup):
        loss = _mlm_loss(fluid, bert, cfg, seq, max_pred)
        lr = L.linear_lr_warmup(
            L.polynomial_decay(RECIPE_LR, RECIPE_DECAY_STEPS,
                               end_learning_rate=0.0, power=1.0),
            warmup_steps=RECIPE_WARMUP_STEPS, start_lr=0.0,
            end_lr=RECIPE_LR)
        fluid.clip.set_gradient_clip(
            fluid.clip.GradientClipByGlobalNorm(1.0), program=main)
        amp.decorate(fluid.optimizer.LambOptimizer(
            learning_rate=lr, lamb_weight_decay=0.01)).minimize(loss)
    return main, startup, loss, lr


# the update rules of the optimizers phases: each rule's optimizer class
# and every setting it runs with, the one place they are stated.
# rule_optimizer builds the rule from here in either package (for the
# chip phases and the CPU tests) and rule_step_bound reads its settings
# from here.  adamw is Adam extended by extend_with_decoupled_weight_decay.
RULE_SETTINGS = {
    "adagrad": ("Adagrad", {"epsilon": 1e-6}),
    "decayed_adagrad": ("DecayedAdagrad", {"decay": 0.95, "epsilon": 1e-6}),
    "adamax": ("Adamax", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "adadelta": ("Adadelta", {"epsilon": 1e-6, "rho": 0.95}),
    "rmsprop": ("RMSProp", {"rho": 0.95, "epsilon": 1e-6, "momentum": 0.9,
                            "centered": True}),
    "ftrl": ("Ftrl", {"l1": 0.0, "l2": 0.0, "lr_power": -0.5}),
    # it warns that it runs as plain momentum
    "dgc_momentum": ("DGCMomentumOptimizer", {"momentum": 0.9}),
    "adamw": ("Adam", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
                       "weight_decay": 0.01}),
}
RULES = tuple(RULE_SETTINGS)


def rule_optimizer(fluid, rule, lr):
    """The optimizer of update rule ``rule`` in package ``fluid``, built
    with its RULE_SETTINGS at rate ``lr``."""
    import importlib

    name, settings = RULE_SETTINGS[rule]
    cls = getattr(fluid.optimizer, name)
    settings = dict(settings)
    if rule == "adamw":
        ext = importlib.import_module(fluid.__name__
                                      + ".contrib.extend_optimizer")
        return ext.extend_with_decoupled_weight_decay(cls)(
            settings.pop("weight_decay"), learning_rate=lr, **settings)
    return cls(lr, **settings)


def rule_program(fluid, bert, cfg, seq, rule, lr=TRAIN_LR, max_pred=None):
    """``build_pretrain``'s masked-LM program trained by update rule
    ``rule`` (:func:`rule_optimizer`), built by the same code in either
    package → ``(main, startup, loss)``."""
    import warnings

    if max_pred is None:
        max_pred = bert.default_max_pred(seq)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup):
        loss = _mlm_loss(fluid, bert, cfg, seq, max_pred)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # DGCMomentum's, reported apart
            rule_optimizer(fluid, rule, lr).minimize(loss)
    return main, startup, loss


def _train_program(fluid, bert, cfg, seq):
    main, startup, _feeds, loss = bert.build_pretrain(cfg, seq_len=seq,
                                                      lr=TRAIN_LR)
    main.random_seed = startup.random_seed = SEED
    return main, startup, loss


def _train_launches(prog):
    """The kernel launches of one BERT-base training step of the
    fusion-resolved program ``prog``."""
    want = {"flash_attention_fwd": 12, "flash_attention_bwd_dkv": 12,
            "flash_attention_bwd_dq": 12, "fused_dropout_add_ln_fwd": 25,
            "fused_dropout_add_ln_bwd": 25, "embedding_gather_fwd": 3,
            "embedding_gather_bwd": 3}
    want.update(_update_launches(prog))
    return want


def _grad_names(main):
    """param name → its gradient var, read off the adam ops."""
    return {op.inputs["Param"][0]: op.inputs["Grad"][0]
            for op in main.global_block().ops if op.type == "adam"}


def _copy_backs(exe):
    """Each captured entry's copies of new state values into their
    resident tensors a step (0 when every update is in place)."""
    return [e.copy_backs for e in exe._cache.values() if e.graph is not None]


def copy_back_writers(exe):
    """The state each captured entry of ``exe`` copies back a step, by
    the op type that wrote it through a new value (not in place) →
    ``{op type: count}`` over the entries."""
    from paddle_tpu_torch.ops import registry

    out = {}
    for e in exe._cache.values():
        writer = {}
        for op in e.block.ops:
            if op.type in ("feed", "fetch"):
                continue
            in_place = registry.get_op_def(op.type).in_place
            for slot, names in op.outputs.items():
                for n in names:
                    if op.inputs.get(in_place.get(slot)) != names:
                        writer[n] = op.type
        for n in e.copy_back_names:
            out[writer[n]] = out.get(writer[n], 0) + 1
    return out


def _update_launches(program):
    """The update kernels' launches of one step of ``program`` (its
    fusion-resolved clone): one per per-parameter update op, one per
    chunk of a fused one."""
    from paddle_tpu_torch.ops.cuda import optimizer as opt

    kinds = {"adam": "adam_update", "momentum": "momentum_update",
             "sgd": "sgd_update", "fused_adam": "multi_tensor_adam",
             "fused_sgd": "multi_tensor_sgd"}
    out = {}
    for op in program.global_block().ops:
        k = kinds.get(op.type)
        if k is None:
            continue
        chunk = opt.CHUNK.get(k)
        n = -(-len(op.inputs["Param"]) // chunk) if chunk else 1
        out[k] = out.get(k, 0) + n
    return out


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
                                           launch_counts_by_source,
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
        op_types = _op_type_counts(prog)
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
        counts = launch_counts_by_source()
        peak = torch.cuda.max_memory_allocated()
        mode, graphs = exe.last_run_mode, exe.graph_count
        per_step = {k: c / TRAIN_STEPS for k, c in launch_counts().items()}
        want = dict.fromkeys(KERNELS, 0.0)
        want.update(_train_launches(prog))
        med = statistics.median(step_ms)
        off = _graphs_off(exe)
        copies = _copy_backs(exe)
        emit({"phase": "train", "step": "steps", "card": card_label(env),
              "losses": losses, "step_ms": step_ms, "median_step_ms": med,
              "tokens_per_s": TRAIN_BATCH * SEQ / (med / 1e3),
              "launches_per_step": per_step, "launches_by_source": counts,
              "expected": want, "peak_memory_bytes": peak,
              "last_run_mode": mode, "graph_count": graphs,
              "copy_backs_per_step": copies,
              "graphs_nodes_not_captured_launches": off})
        if copies != [0]:
            raise AssertionError("state copied back a step: %s" % copies)
        # every timed step replays: its launches are the graph's nodes
        if per_step != want or any(counts["wrapper"].values()) or off:
            raise AssertionError("launches per step %s != %s (by source "
                                 "%s, graphs %s)"
                                 % (per_step, want, counts, off))
        if mode != "graph":
            raise AssertionError("the timed steps ran %r, not the captured "
                                 "graph" % mode)
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError("loss not finite and falling: %s" % losses)

        prof = _step_profile(exe, main, batch, [loss])
        emit(dict({"phase": "train", "step": "profile",
                   "card": card_label(env)}, **prof))
        k3 = prof["launches_by_group"].get("K3 bwd", 0)
        if k3 != want["embedding_gather_bwd"] * K3_BWD_LAUNCHES:
            raise AssertionError(
                "K3 backward's kernels launched %s times a step by the "
                "profiler's names, not %d calls x %d" % (
                    k3, want["embedding_gather_bwd"], K3_BWD_LAUNCHES))
        _drift_report(env, "train", exe, replay_ms=med)
    del scope, exe
    torch.cuda.empty_cache()
    return counts


def _parity_calls(fluid, convert, exe, scope, main, place, start, call):
    """PARITY_CALLS calls of ``call()``, each from the persistables
    ``start`` loaded into ``scope`` afresh, so the last one is a single
    step from ``start`` that the card runs from its captured graph →
    (the last call's fetches, each call's run mode)."""
    modes = []
    for _ in range(PARITY_CALLS):
        convert.load_params_into_scope(start, scope, place, program=main)
        out = call()
        modes.append(exe.last_run_mode)
    return out, modes


def phase_train_parity():
    """One dropout-0.1 step of a 2-layer BERT at BERT-base width (B=2,
    T=512) on the card and on the CPU with the plain versions: the seeded
    start is the same on both, and so is every dropout mask (the card
    generator has a plain twin).  The step is the last of PARITY_CALLS
    from the same start on each place, so the card's is a replay of its
    captured graph."""
    import copy

    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models import bert

    cfg = copy.copy(bert.BERT_BASE)
    cfg.layers = 2
    main, startup, loss = _train_program(fluid, bert, cfg, SEQ)
    grads = _grad_names(main)
    names = ["bert.word_emb", "bert.layer0.attn.q.w", "bert.layer0.ln1.scale"]
    fetch = [loss.name] + [grads[n] for n in names]
    batch = bert.make_fake_batch(2, SEQ, cfg, np.random.RandomState(SEED + 3))
    out, modes = {}, {}
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = fluid.Executor(place)
            exe.run(startup)
            start = convert.scope_persistables(main, scope)
            out[place._kind], modes[place._kind] = _parity_calls(
                fluid, convert, exe, scope, main, place, start,
                lambda: exe.run(main, feed=batch, fetch_list=fetch))
        del scope, exe
    gpu, cpu = out["cuda"], out["cpu"]
    result = {"phase": "train_parity", "step": "GPU kernels vs CPU plain "
              "versions, one step, dropout 0.1, the last of %d from one "
              "start" % PARITY_CALLS, "modes": modes,
              "loss": [float(gpu[0][0]), float(cpu[0][0])],
              "loss_rel_err": abs(float(gpu[0][0] - cpu[0][0]))
              / abs(float(cpu[0][0])), "loss_tol": PARITY_LOSS_RTOL}
    ok = result["loss_rel_err"] <= PARITY_LOSS_RTOL \
        and modes["cuda"][-1] == "graph"
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


def _decode_drive(eng, prompts, steps, forced=None, cache=True,
                  modes=None):
    """Run an engine's programs directly, as its scheduler does: prefill
    ``prompts`` into slots 0, 1, ... (paged: each slot owns its own
    blocks in reverse order), then ``steps`` greedy steps of every slot
    (the other slots inactive: token 0, cursor 0, table -1).  Returns the
    logits and tokens of every stage; ``forced`` (another drive's tokens)
    feeds those tokens instead of this drive's own.  ``cache`` is the
    runs' ``use_program_cache``; ``modes`` (a dict) collects each
    program's run modes by its label."""
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
            scope=eng.scope, use_program_cache=cache))[0]
        if modes is not None:
            modes.setdefault("prefill%d" % length, []).append(
                eng._exe.last_run_mode)
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
            scope=eng.scope, use_program_cache=cache))
        if modes is not None:
            modes.setdefault("step", []).append(eng._exe.last_run_mode)
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
    greedy, 64 new tokens each, after two warm-up requests per prompt
    bucket (its prefill's eager warm-up and capture).  Every request must complete with tokens in the vocabulary,
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
    from paddle_tpu_torch.ops.cuda import (launch_counts,
                                           launch_counts_by_source,
                                           reset_launch_counts)
    from paddle_tpu_torch.static_analysis import fusion

    cfg = gpt.GPT2_SMALL_WIDTHS
    rng = np.random.RandomState(SEED + 4)
    lens = rng.randint(DECODE_PROMPT_LENS[0], DECODE_PROMPT_LENS[1] + 1,
                       DECODE_REQUESTS)
    prompts = [rng.randint(1, cfg.vocab - 1, size=n).astype("int32")
               for n in lens]
    tokens, counts, engines, rates = {}, {}, {}, {}
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
        server = serving.PredictorServer({"gpt2": eng})
        try:
            # two per prompt bucket: its prefill's warm-up and capture
            warm = [server.submit("gpt2", p) for p in (
                rng.randint(1, cfg.vocab - 1, b // 2 + 1).astype("int32")
                for b in DECODE_BUCKETS for _ in range(2))]
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
            total = launch_counts()
            counts[mode] = launch_counts_by_source()
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
        rates[mode] = n_tok / wall_s
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
              "graph_count": eng._exe.graph_count,
              "launches": total, "launches_by_source": counts[mode],
              "expected_launches": want,
              "graphs_nodes_not_captured_launches": _graphs_off(eng._exe)})
        if total != want or _graphs_off(eng._exe):
            raise AssertionError("%s: launches %s != %s for %d steps, %d "
                                 "prefills, or graphs %s"
                                 % (mode, total, want, steps, prefills,
                                    _graphs_off(eng._exe)))
        bad = [i for i, t in enumerate(tokens[mode])
               if len(t) != DECODE_NEW_TOKENS
               or not all(0 <= x < cfg.vocab for x in t)]
        if len(outs) != DECODE_REQUESTS or bad:
            raise AssertionError("%s: requests %s incomplete or out of the "
                                 "vocabulary" % (mode, bad))
        _decode_profile(env, eng, mode, rng, cfg.vocab)
        _drift_report(env, "decode", eng._exe, replay_ms=step_ms)
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
    return counts, rates


SERVE_REQUESTS = 400          # the serve phase's BERT load, open loop
SERVE_QPS = 100.0             # ~a quarter of bucket 8's ~387 rows/s
SERVE_BATCHES = 32            # run_batches: bucket-8 batches per depth
SERVE_SYNC_CALLS = 5          # replays checked under sync debug "error"
SERVE_HOST_CALLS = 200        # enqueues timed per side (drained device)
SERVE_CLI_REQUESTS = 64
SERVE_CLI_TIMEOUT = 600


def _spans_by_name(records):
    import statistics

    by = {}
    for r in records:
        if r.get("dur_ms") is not None:
            by.setdefault(r["name"], []).append(r["dur_ms"])
    return {n: {"count": len(v), "median_ms": statistics.median(v)}
            for n, v in sorted(by.items())}


def _serving_series(obs):
    """The exported serving, decode and KV series: counters and gauges
    by value, histograms by count, p50 and p99."""
    out = {}
    for k, m in obs.export_json()["metrics"].items():
        if not k.startswith(("serving_", "decode_", "kv_")):
            continue
        out[k] = (m["value"] if m["type"] != "histogram"
                  else {"count": m["count"], "p50": m["p50"],
                        "p99": m["p99"]})
    return out


def _enqueue_us(torch, obs, call, calls=SERVE_HOST_CALLS):
    """Host µs of ``call()`` (an enqueue that returns handles) with
    telemetry and tracing on and off in turns, call by call, the device
    drained before each call so nothing it does waits on earlier work:
    ``{"on": {"p10", "p50", "p90"}, "off": {...}}``."""
    times = {True: [], False: []}
    try:
        for i in range(2 * calls):
            on = i % 2 == 0
            obs.set_telemetry_enabled(on)
            obs.set_tracing_enabled(on)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            times[on].append((time.perf_counter() - t0) * 1e6)
    finally:
        obs.set_telemetry_enabled(None)
        obs.set_tracing_enabled(None)
    torch.cuda.synchronize()
    return {("on" if on else "off"): _quantiles(v)
            for on, v in times.items()}


def _quantiles(values):
    xs = sorted(values)
    return {q: xs[min(len(xs) - 1, int(round(f * (len(xs) - 1))))]
            for q, f in (("p10", 0.1), ("p50", 0.5), ("p90", 0.9))}


def _hook_us(obs, calls=20000):
    """Host µs, on this host's CPU with no device work, of what one
    served step records: a traced ``executor.step`` with its
    ``executor.dispatch`` child, ``record_jit_cache`` and
    ``record_step`` with a drift key, as the executor calls it (``on``),
    the same without the key (``on_no_drift``) and with telemetry and
    tracing off; the drift monitor's ``observe_step`` alone, and the
    device peak it polls every 16th step."""
    from paddle_tpu_torch.observability import drift, runtime, tracing

    def hooks(key):
        with tracing.span("executor.step", step=1):
            with tracing.span_if_traced("executor.dispatch"):
                pass
        runtime.record_jit_cache(True)
        runtime.record_step("executor", 1, 1.0, dispatch_ms=0.5,
                            drift_key=key)

    def per_call(fn, n=calls):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    out = {}
    obs.reset_telemetry()
    try:
        for label, on, key in (("on", True, "hook"),
                               ("on_no_drift", True, None),
                               ("off", False, "hook")):
            obs.set_telemetry_enabled(on)
            obs.set_tracing_enabled(on)
            drift.monitor().register("hook", predicted_step_ms=1.0)
            with obs.span("serving.dispatch"):  # inside a trace, as served
                out[label] = per_call(lambda k=key: hooks(k))
        obs.set_telemetry_enabled(True)
        m = drift.monitor()
        out["drift_observe_step"] = per_call(
            lambda: m.observe_step(1.0, key="hook"))
        out["drift_device_peak_poll"] = per_call(drift._device_peak_bytes,
                                                 n=2000)
    finally:
        obs.reset_telemetry()
    return out


def _decode_run(obs, server, eng, prompts, telemetry, tracing):
    """Serve ``prompts`` through the decode tenant alone with telemetry
    and tracing as given; its tokens/s and the engine's mean step ms."""
    obs.reset_telemetry()
    obs.set_telemetry_enabled(telemetry)
    obs.set_tracing_enabled(tracing)
    st0 = eng.stats()
    t0 = time.time()
    done = [f.result(timeout=900)
            for f in [server.submit("gpt2", p) for p in prompts]]
    wall = time.time() - t0
    st1 = eng.stats()
    steps = st1["decode_steps"] - st0["decode_steps"]
    return {"telemetry": telemetry, "tracing": tracing,
            "tokens_per_s": sum(len(t) for t, _ in done) / wall,
            "step_ms_mean": (st1["step_ms_mean"] * st1["decode_steps"]
                             - st0["step_ms_mean"] * st0["decode_steps"])
            / steps}


def _in_span(obs, name, call, *args):
    with obs.span(name):
        return call(*args)


def _serve_load(serving, server, eng, bert_sampler, prompts):
    """The serve phase's traffic: the decode prompts submitted first, then
    the BERT requests open loop through the load generator while the
    engine generates.  Returns the load report and the decode numbers."""
    st0 = eng.stats()
    t0 = time.time()
    futs = [server.submit("gpt2", p, request_id="g%d" % i)
            for i, p in enumerate(prompts)]
    report = serving.run_load(server, {"bert": bert_sampler},
                              qps=SERVE_QPS, requests=SERVE_REQUESTS)
    outs = [f.result(timeout=900) for f in futs]
    done_s = max(f.enqueue_ts + f.info["latency_ms"] / 1e3 for f in futs)
    st1 = eng.stats()
    n_tok = sum(len(t) for t, _ in outs)
    steps = st1["decode_steps"] - st0["decode_steps"]
    step_ms = (st1["step_ms_mean"] * st1["decode_steps"]
               - st0["step_ms_mean"] * st0["decode_steps"]) / steps
    return report, {"tokens": n_tok, "tokens_per_s": n_tok / (done_s - t0),
                    "decode_steps": steps, "step_ms_mean": step_ms,
                    "tokens_list": [list(t) for t, _ in outs]}


def phase_serve(env):
    """Serving started as the reference starts it: one ``PredictorServer``
    with default arguments (the scope-overlap proof and the zero-sync
    certificate gate its construction) over BERT-base T=512 and a
    GPT-2-small ring ``DecodeEngine`` (8 slots, prompt buckets 128/512);
    ``SERVE_REQUESTS`` BERT requests at ``SERVE_QPS`` through
    ``serving.run_load`` while 16 seeded prompts decode 64 tokens each,
    with telemetry and tracing on, off, on, off; the host µs of an
    enqueue both ways; ``run_batches(verify=True)`` at depths 1 and 2
    against ``run`` bit for bit; the BERT and greedy-decode replays under
    ``torch.cuda.set_sync_debug_mode("error")``, and a sampled step under
    "warn" (counted); then ``python -m paddle_tpu_torch.tools.serve`` as
    a subprocess, a load and ``--certify-zero-sync``, both exit 0."""
    import warnings

    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.observability as obs
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.executor import Scope, scope_guard
    from paddle_tpu_torch.models import bert, gpt
    from paddle_tpu_torch.ops.cuda import (launch_counts_by_source,
                                           reset_launch_counts)

    cfg = bert.BERT_BASE
    gcfg = gpt.GPT2_SMALL_WIDTHS
    export_dir = os.path.join(HERE, ".smoke_tmp", "serve_bert_export")
    shutil.rmtree(export_dir, ignore_errors=True)
    ring = os.environ.pop("PADDLE_TPU_TRACE_RING", None)
    obs.reset_telemetry()
    server = None
    try:
        t0 = time.time()
        main, startup, hidden = _bert_program(fluid, bert, cfg)
        with scope_guard(Scope()):
            exe = fluid.Executor(fluid.CUDAPlace(0))
            exe.run(startup)
            fluid.io.save_inference_model(
                export_dir, ["input_ids", "token_type_ids",
                             "attn_mask_bias", "pos_ids"], [hidden], exe,
                main_program=main)
        del exe
        pred = fluid.inference.create_paddle_predictor(
            fluid.inference.AnalysisConfig(model_dir=export_dir))
        eng = _decode_engine(gcfg, False, fluid.CUDAPlace(0))
        server = serving.PredictorServer({"bert": pred, "gpt2": eng})
        emit({"phase": "serve", "step": "gates", "seconds": time.time() - t0,
              "placement_diags": len(server.placement_diags),
              "placement": [str(d) for d in server.placement_diags],
              "certificates": {n: c.ok
                               for n, c in server.certificates.items()},
              "buckets": list(server.buckets.sizes)})
        if not all(c.ok for c in server.certificates.values()) \
                or sorted(server.certificates) != ["bert", "gpt2"]:
            raise AssertionError("zero-sync certificates %s"
                                 % server.certificates)
        rng = np.random.RandomState(SEED + 7)
        server.warmup({"bert": _bert_request(rng, 1, cfg)})
        warm = [server.submit("gpt2", rng.randint(
            1, gcfg.vocab - 1, b // 2 + 1).astype("int32"))
            for b in DECODE_BUCKETS for _ in range(2)]
        for f in warm:
            f.result(timeout=600)
        lens = rng.randint(DECODE_PROMPT_LENS[0], DECODE_PROMPT_LENS[1] + 1,
                           DECODE_REQUESTS)
        prompts = [rng.randint(1, gcfg.vocab - 1, size=n).astype("int32")
                   for n in lens]

        def bert_sampler():
            return _bert_request(rng, 1, cfg)

        feed8 = _bert_request(np.random.RandomState(SEED + 8), 8, cfg)
        step_feed = _decode_step_feed(eng, np.random.RandomState(SEED + 9),
                                      gcfg.vocab)

        def step_enqueue():
            with eng._exe_lock:
                return eng._exe.run(eng._step_prog, feed=step_feed,
                                    fetch_list=[eng._step_fetch],
                                    scope=eng.scope, return_numpy=False)

        # an unreported first run warms what the load alone touches
        _serve_load(serving, server, eng, bert_sampler, prompts)
        runs, tokens = [], None
        # run 0 keeps every span (a ring of 65536) for the spans by name;
        # runs 1-4 alternate the defaults on and off for the cost
        for i, on in enumerate((True, True, False, True, False)):
            if i == 0:
                os.environ["PADDLE_TPU_TRACE_RING"] = "65536"
            else:
                os.environ.pop("PADDLE_TPU_TRACE_RING", None)
            obs.reset_telemetry()
            obs.set_telemetry_enabled(on)
            obs.set_tracing_enabled(on)
            if i == 0:
                reset_launch_counts()
            batches0 = len(server.dispatch_log)
            report, dec = _serve_load(serving, server, eng, bert_sampler,
                                      prompts)
            torch.cuda.synchronize()
            if i == 0:
                launches = launch_counts_by_source()
                spans = _spans_by_name(obs.get_tracer().records())
                series = _serving_series(obs)
            toks = dec.pop("tokens_list")
            tokens = toks if tokens is None else tokens
            row = {"phase": "serve", "step": "load", "run": i,
                   "trace_ring": 65536 if i == 0 else "default",
                   "telemetry": on, "tracing": on, "card": card_label(env),
                   "requests": report["requests"],
                   "completed": report["completed"],
                   "shed": report["shed"], "rejected": report["rejected"],
                   "failed": report["failed"],
                   "p50_ms": report["p50_ms"], "p99_ms": report["p99_ms"],
                   "mean_ms": report["mean_ms"], "qps": report["qps"],
                   "offered_qps": SERVE_QPS,
                   "batches": len(server.dispatch_log) - batches0,
                   "decode_requests": len(prompts),
                   "tokens_equal_first_run": toks == tokens}
            row.update(dec)
            emit(row)
            runs.append(row)
            if report["completed"] != SERVE_REQUESTS or report["failed"] \
                    or toks != tokens \
                    or any(len(t) != DECODE_NEW_TOKENS for t in toks):
                raise AssertionError("serve load run %d: %s" % (i, row))
        obs.set_telemetry_enabled(None)
        obs.set_tracing_enabled(None)
        emit({"phase": "serve", "step": "spans", "spans": spans})
        emit({"phase": "serve", "step": "telemetry", "series": series})
        seen = {k: launches["wrapper"][k] + launches["graph_nodes"][k]
                for k in launches["wrapper"]}
        need = ("flash_attention_fwd", "fused_dropout_add_ln_fwd",
                "embedding_gather_fwd", "flash_decode_fwd")
        emit({"phase": "serve", "step": "launches", "launches": seen})
        for name in ("serving.request", "serving.batch", "serving.device",
                     "serving.sync", "serving.prefill",
                     "serving.decode_step", "executor.step"):
            if name not in spans:
                raise AssertionError("no %s span in the serve run" % name)
        if not all(seen[k] for k in need):
            raise AssertionError("a kernel of the serve path never "
                                 "launched: %s" % seen)
        # the decode tenant alone, telemetry and tracing off and on in
        # turns: the engine's host-bound step without the BERT load
        try:
            alone = [_decode_run(obs, server, eng, prompts, on_, on_)
                     for on_ in (False, True, False, True)]
        finally:
            obs.set_telemetry_enabled(None)
            obs.set_tracing_enabled(None)
        on = [r for r in runs[1:] if r["telemetry"]]
        off = [r for r in runs[1:] if not r["telemetry"]]
        # inside the span the server opens around each, so a traced
        # enqueue records its whole subtree as it does when served
        emit({"phase": "serve", "step": "telemetry cost",
              "card": card_label(env),
              "served_batch_enqueue_us": _enqueue_us(
                  torch, obs, lambda: _in_span(obs, "serving.dispatch",
                                               pred.run_async, feed8)),
              "decode_step_enqueue_us": _enqueue_us(
                  torch, obs, lambda: _in_span(obs, "serving.decode_step",
                                               step_enqueue)),
              "step_hooks_us": _hook_us(obs),
              "decode_step_ms_mean": {
                  "on": [r["step_ms_mean"] for r in on],
                  "off": [r["step_ms_mean"] for r in off]},
              "decode_tokens_per_s": {
                  "on": [r["tokens_per_s"] for r in on],
                  "off": [r["tokens_per_s"] for r in off]},
              "p50_ms": {"on": [r["p50_ms"] for r in on],
                         "off": [r["p50_ms"] for r in off]},
              "p99_ms": {"on": [r["p99_ms"] for r in on],
                         "off": [r["p99_ms"] for r in off]},
              "decode_alone": alone})

        brng = np.random.RandomState(SEED + 10)
        batches = [_bert_request(brng, 8, cfg)
                   for _ in range(SERVE_BATCHES)]
        want = [pred.run(b)[0] for b in batches]
        per_depth = {}
        for depth in (1, 2):
            torch.cuda.synchronize()
            t0 = time.time()
            got = [o[0] for o in pred.run_batches(
                batches, max_in_flight=depth, verify=True)]
            wall = time.time() - t0
            same = all(np.array_equal(g, w) for g, w in zip(got, want))
            per_depth[depth] = {"batches_per_s": len(got) / wall,
                                "rows_per_s": 8 * len(got) / wall,
                                "bit_identical_to_run": same}
            if len(got) != SERVE_BATCHES or not same:
                raise AssertionError("run_batches(max_in_flight=%d) != run"
                                     % depth)
        emit({"phase": "serve", "step": "run_batches",
              "card": card_label(env), "batches": SERVE_BATCHES,
              "bucket": 8, "depths": per_depth})

        modes = []
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(SERVE_SYNC_CALLS):
                handles = pred.run_async(feed8)
                modes.append(("bert", pred._exe.last_run_mode))
                step = step_enqueue()
                modes.append(("gpt2 greedy", eng._exe.last_run_mode))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        fluid.pipeline.materialize(handles + step)
        emit({"phase": "serve", "step": "sync debug error", "modes": modes,
              "raised": False})
        if any(m != "graph" for _n, m in modes):
            raise AssertionError("checked dispatches did not replay: %s"
                                 % modes)
        sampled_syncs = _sampled_step_syncs(torch, fluid, serving, gpt,
                                            warnings)
        emit({"phase": "serve", "step": "sampled decode step syncs",
              "syncs_per_step": sampled_syncs,
              "note": "top_k sampling draws its noise on the device "
                      "(ops/decode.py _gumbel): ROADMAP Queue C 1, closed"})
        if sampled_syncs:
            raise AssertionError("a sampled decode step synced %d times"
                                 % sampled_syncs)

        server.close()
        server = None
        del pred, eng
        torch.cuda.empty_cache()
        cli, procs = {}, {}
        try:
            # both at once: each is mostly an interpreter's start-up
            for label, args in (("load", ["--requests",
                                          str(SERVE_CLI_REQUESTS), "--json"]),
                                ("certify", ["--certify-zero-sync"])):
                procs[label] = (time.time(), subprocess.Popen(
                    [sys.executable, "-m", "paddle_tpu_torch.tools.serve",
                     export_dir] + args, cwd=HERE,
                    env=dict(os.environ, PYTHONPATH=HERE),
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True))
            for label, (t0, proc) in procs.items():
                stdout, stderr = proc.communicate(timeout=SERVE_CLI_TIMEOUT)
                out = stdout.strip().splitlines()
                cli[label] = {"rc": proc.returncode,
                              "seconds": time.time() - t0,
                              "stdout_tail": out[-3:],
                              "stderr_tail": stderr.strip().splitlines()[-5:]}
                if label == "load" and proc.returncode == 0:
                    cli[label]["report"] = json.loads(out[-1])
        finally:
            for _t0, proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        emit({"phase": "serve", "step": "cli", "card": card_label(env),
              "runs": cli})
        if any(c["rc"] != 0 for c in cli.values()) \
                or cli["load"]["report"]["completed"] != SERVE_CLI_REQUESTS:
            raise AssertionError("tools.serve: %s" % cli)
    finally:
        if server is not None:
            server.close()
        shutil.rmtree(export_dir, ignore_errors=True)
        if ring is None:
            os.environ.pop("PADDLE_TPU_TRACE_RING", None)
        else:
            os.environ["PADDLE_TPU_TRACE_RING"] = ring
        obs.reset_telemetry()
    torch.cuda.empty_cache()


def profile_telemetry(env, runs=2, top=15):
    """Where telemetry's host time goes in the decode engine's step
    (run alone, not from ``main``): GPT-2-small ring decode, 16 requests
    a run, with telemetry and tracing each on and off (``runs`` rounds
    of the four settings), the cost of the system calls the hooks make
    in a tight loop, and ``cProfile`` of the engine's ``_step`` with both
    on against both off (the functions whose own time differs most)."""
    import cProfile
    import pstats

    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.observability as obs
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models import gpt

    cfg = gpt.GPT2_SMALL_WIDTHS
    rng = np.random.RandomState(SEED + 4)
    prompts = [rng.randint(1, cfg.vocab - 1, size=n).astype("int32")
               for n in rng.randint(DECODE_PROMPT_LENS[0],
                                    DECODE_PROMPT_LENS[1] + 1,
                                    DECODE_REQUESTS)]
    eng = _decode_engine(cfg, False, fluid.CUDAPlace(0))
    server = serving.PredictorServer({"gpt2": eng})
    real_step = eng._step
    prof = {"p": None}

    def step():
        p = prof["p"]
        if p is None:
            return real_step()
        p.enable()
        try:
            return real_step()
        finally:
            p.disable()

    eng._step = step

    def run(tel, trc, profile=False):
        prof["p"] = cProfile.Profile() if profile else None
        row = _decode_run(obs, server, eng, prompts, tel, trc)
        p, prof["p"] = prof["p"], None
        return row, p

    def loop_us(fn, n=20000):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    try:
        for f in [server.submit("gpt2", rng.randint(
                1, cfg.vocab - 1, b // 2 + 1).astype("int32"))
                for b in DECODE_BUCKETS for _ in range(2)]:
            f.result(timeout=600)
        rows = [run(tel, trc)[0] for _ in range(runs)
                for tel, trc in ((False, False), (True, False),
                                 (False, True), (True, True))]
        emit({"phase": "profile_telemetry", "step": "decode alone",
              "card": card_label(env), "runs": rows})
        emit({"phase": "profile_telemetry", "step": "system calls, µs",
              "os.getpid": loop_us(os.getpid),
              "os.urandom(16)": loop_us(lambda: os.urandom(16)),
              "time.time": loop_us(time.time)})
        own = {}
        for on in (True, False):
            row, p = run(on, on, profile=True)
            own[on] = {k: (v[1], v[2]) for k, v in
                       pstats.Stats(p).stats.items()}
            emit({"phase": "profile_telemetry", "step": "profiled run",
                  "row": row})
        diff = []
        for k, (n, tt) in own[True].items():
            n0, tt0 = own[False].get(k, (0, 0.0))
            diff.append((tt - tt0, n - n0, "%s:%d(%s)" % (
                os.path.basename(k[0]), k[1], k[2])))
        emit({"phase": "profile_telemetry", "step": "own time, on - off",
              "top": [{"fn": f, "own_s": t, "calls": n}
                      for t, n, f in sorted(diff, reverse=True)[:top]]})
    finally:
        obs.set_telemetry_enabled(None)
        obs.set_tracing_enabled(None)
        server.close()
    del eng, server
    torch.cuda.empty_cache()


def _sampled_step_syncs(torch, fluid, serving, gpt, warnings):
    """Device syncs of one top-k sampled decode step (1 layer at GPT-2
    width), counted under ``set_sync_debug_mode("warn")``."""
    import numpy as np

    cfg = gpt.GPTConfig(vocab=gpt.GPT2_SMALL_WIDTHS.vocab, hidden=768,
                        layers=1, heads=12, max_len=DECODE_TMAX)
    eng = serving.DecodeEngine(
        gpt.DecodeAdapter(cfg, seed=SEED), slots=DECODE_SLOTS,
        prompt_buckets=DECODE_BUCKETS,
        config=serving.GenerationConfig(strategy="top_k", k=8),
        place=fluid.CUDAPlace(0), name="sampled", paged=False,
        auto_start=False)
    feed = _decode_step_feed(eng, np.random.RandomState(SEED + 11),
                             cfg.vocab)

    def step():
        return eng._exe.run(eng._step_prog, feed=feed,
                            fetch_list=[eng._step_fetch], scope=eng.scope,
                            return_numpy=False)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            handles = step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    fluid.pipeline.materialize(handles)
    return sum(1 for w in caught if "synchroniz" in str(w.message))


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
    if any(n in name for n in OPTIMIZER_KERNELS):
        return "optimizer"
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
            ("GEMM (fc; 1x1 convs cuDNN hands to cuBLAS)",
             ("gemm", "cutlass", "xmma", "nvjet"))):
        if any(n.lower() in low for n in needles):
            return group
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    return "other"


def _resnet_launches(prog):
    """The kernel launches of one ResNet-50 training step of the
    fusion-resolved program ``prog``."""
    want = {"bn_act_epilogue_fwd": RESNET_SITES,
            "bn_act_epilogue_bwd": RESNET_SITES}
    want.update(_update_launches(prog))
    return want


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
    try:  # eagerly: a graph replay calls no op
        exe.run(program, feed=feed, fetch_list=fetch,
                use_program_cache=False)
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
                                           launch_counts_by_source,
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
        op_types = _op_type_counts(prog)
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
        for _ in range(RESNET_WARMUP):  # the timed steps' cache key
            losses.append(float(exe.run(main, feed=batch,
                                        fetch_list=[loss, acc])[0][0]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        step_ms = []
        for _ in range(RESNET_STEPS):
            s0 = time.perf_counter()
            out = exe.run(main, feed=batch, fetch_list=[loss, acc])
            step_ms.append((time.perf_counter() - s0) * 1e3)
            losses.append(float(out[0][0]))
        counts = launch_counts_by_source()
        peak = torch.cuda.max_memory_allocated()
        mode, graphs = exe.last_run_mode, exe.graph_count
        per_step = {k: c / RESNET_STEPS for k, c in launch_counts().items()}
        want = dict.fromkeys(KERNELS, 0.0)
        want.update(_resnet_launches(prog))
        med = statistics.median(step_ms)
        off = _graphs_off(exe)
        copies = _copy_backs(exe)
        emit({"phase": "resnet", "step": "steps", "card": card_label(env),
              "batch": RESNET_BATCH, "image": RESNET_HW, "losses": losses,
              "step_ms": step_ms, "median_step_ms": med,
              "images_per_s": RESNET_BATCH / (med / 1e3),
              "launches_per_step": per_step, "launches_by_source": counts,
              "expected": want, "peak_memory_bytes": peak,
              "last_run_mode": mode, "graph_count": graphs,
              "copy_backs_per_step": copies,
              "graphs_nodes_not_captured_launches": off})
        if copies != [0]:
            raise AssertionError("state copied back a step: %s" % copies)
        if per_step != want or any(counts["wrapper"].values()) or off:
            raise AssertionError("launches per step %s != %s (by source "
                                 "%s, graphs %s)"
                                 % (per_step, want, counts, off))
        if mode != "graph":
            raise AssertionError("the timed steps ran %r, not the captured "
                                 "graph" % mode)
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

        prof = _step_profile(exe, main, batch, [loss, acc], _resnet_group,
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
        _drift_report(env, "resnet", exe, replay_ms=med)
    del scope, exe, batch
    torch.cuda.empty_cache()
    return counts, prof["device_ms_by_group"]


def _resnet_parity_run(fluid, convert, main, startup, fetch, batch, place,
                       start, fuse):
    """One training step → (fetches, persistables before it, after it,
    run modes); ``start`` (a persistables dict) is loaded over the
    startup's values when given.  The step is the last of PARITY_CALLS
    from those values (``_parity_calls``), so the card's replays its
    captured graph.  ``fuse`` False runs it with the fusion pipeline
    off."""
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
            out, modes = _parity_calls(
                fluid, convert, exe, scope, main, place, before,
                lambda: exe.run(main, feed=batch, fetch_list=fetch))
            return out, before, convert.scope_persistables(main, scope), \
                modes
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
    CPU.  The step is the last of PARITY_CALLS from the same start on
    each run (``_resnet_parity_run``), so the card's two runs replay
    their captured graphs."""
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
    cpu, start, cpu_after, _ = _resnet_parity_run(
        fluid, convert, main, startup, fetch, batch, fluid.CPUPlace(), None,
        True)
    runs = {"cpu": (cpu, cpu_after)}
    modes = {}
    for kind, fuse in (("cuda_k4", True), ("cuda_unfused", False)):
        out, _, after, modes[kind] = _resnet_parity_run(
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
               "tol": PARITY_RESNET_RTOL, "modes": modes, "ok": ok},
              **card))
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
    replayed = all(m[-1] == "graph" for m in modes.values())
    if not (ok and ok_site and ok_cpu and replayed):
        raise AssertionError("resnet parity failed")


# ---------------------------------------------------------------------------
# eager against the captured CUDA graph
# ---------------------------------------------------------------------------

def _kernels_seen(prof, runs):
    """Each kernel's launches a call in a profile, by its device
    function's name (``_lib.kernel_of``), the marker kernels seen, and
    the port's kernels the profile holds outside the markers.  With every
    marker seen, only the kernels that start between the markers before
    and after the timed calls count: a record of the profile's
    unrecorded warm-up call can land in the active window (seen on the
    card: 5 Adam updates more over 3 eager BERT steps).  The ones left
    out are returned by kernel, each with its start in µs from the last
    marker before the timed calls (negative) or from the first after them
    (positive), at most OUTSIDE_SHOWN a kernel → (launches a call,
    markers seen, ``{kernel: {"count", "start_us"}}``)."""
    from paddle_tpu_torch.ops.cuda import _lib

    kernels = [ev for ev in prof.events()
               if str(getattr(ev, "device_type", "")).endswith("CUDA")]
    marks = sorted(ev.time_range.start for ev in kernels
                   if MARKER_KERNEL in ev.name)
    outside = {}
    if len(marks) == 2 * PROFILE_MARKERS:
        lo, hi = marks[PROFILE_MARKERS - 1], marks[PROFILE_MARKERS]
        for ev in kernels:
            k, t = _lib.kernel_of(ev.name), ev.time_range.start
            if k is None or lo < t < hi:
                continue
            row = outside.setdefault(k, {"count": 0, "start_us": []})
            row["count"] += 1
            if len(row["start_us"]) < OUTSIDE_SHOWN:
                row["start_us"].append(t - lo if t <= lo else t - hi)
        kernels = [ev for ev in kernels if lo < ev.time_range.start < hi]
    seen = dict.fromkeys(_lib.KERNELS, 0)
    for ev in kernels:
        k = _lib.kernel_of(ev.name)
        if k is not None:
            seen[k] += 1
    return {k: n / runs for k, n in seen.items()}, len(marks), outside


def _profiled_calls(call, runs):
    """``runs`` calls under ``torch.profiler``, after one unrecorded call,
    between PROFILE_MARKERS marker kernels (``torch.cuda._sleep``) on each
    side: a profile that lost its first or last records (seen on the card)
    loses markers, so it is known to be incomplete (``_kernels_seen``
    counts them) → (profile, wall ms a call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=torch.profiler.schedule(
                     wait=0, warmup=1, active=1, repeat=1)) as prof:
        call()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(PROFILE_MARGIN_S)
        for _ in range(PROFILE_MARKERS):
            torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        for _ in range(runs):
            call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - s0) * 1e3 / runs
        for _ in range(PROFILE_MARKERS):
            torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
        prof.step()
    return prof, wall


def _graph_side(exe, call, call_async, group=None):
    """One side of a path, after its compared calls: the host's time to
    enqueue a call (five, each after a sync, nothing waited for), the
    synchronised call (median of five), each kernel's launches a call by
    source (its wrapper's launches that ran at once, the kernel nodes of
    the replayed graphs), and over GRAPH_PROFILE_RUNS profiled calls the
    device time by kernel group, the idle share and each kernel's
    launches a call by the profiler's kernel names.  A profile whose
    markers are not all seen is taken again, up to PROFILE_TRIES times
    (``_graph_verdicts`` holds the first complete one).  Also the peak
    memory since the side began, the memory reserved, the executor's
    graphs and last run mode, and each graph's kernel nodes against the
    launches its capture recorded."""
    import statistics

    import torch

    from paddle_tpu_torch.ops.cuda import (launch_counts_by_source,
                                           reset_launch_counts)

    enq = []
    for _ in range(5):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        call_async()
        enq.append((time.perf_counter() - s0) * 1e3)
    torch.cuda.synchronize()
    step = []
    reset_launch_counts()
    for _ in range(5):
        s0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        step.append((time.perf_counter() - s0) * 1e3)
    by_source = {src: {k: n / 5 for k, n in counts.items()}
                 for src, counts in launch_counts_by_source().items()
                 if src != "captured"}
    runs = GRAPH_PROFILE_RUNS
    tries = []
    for _ in range(PROFILE_TRIES):
        prof, wall = _profiled_calls(call, runs)
        seen, markers, outside = _kernels_seen(prof, runs)
        tries.append({"markers_seen": markers,
                      "complete": markers == 2 * PROFILE_MARKERS,
                      "launches_by_profiler": seen,
                      "outside_markers": outside})
        if tries[-1]["complete"]:
            break
    groups, top = _device_breakdown(prof, runs, group)
    busy = sum(groups.values())
    return {"last_run_mode": exe.last_run_mode,
            "graph_count": exe.graph_count,
            "graphs": [{"captured": e.captured,
                        "kernel_nodes": e.kernel_nodes}
                       for e in exe._cache.values() if e.graph is not None],
            "enqueue_ms": statistics.median(enq), "enqueue_ms_runs": enq,
            "step_ms": statistics.median(step), "step_ms_runs": step,
            "profiled_wall_ms": wall,
            "device_ms": busy if busy else "not measured",
            "idle_share": (1.0 - busy / wall) if busy else "not measured",
            "device_ms_by_group": groups,
            "top_kernels": [{"ms": t, "launches": n, "name": k}
                            for t, n, k in top[:6]],
            "launches_by_wrapper": by_source["wrapper"],
            "launches_by_graph_nodes": by_source["graph_nodes"],
            "profiles": tries,
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
            "reserved_bytes": torch.cuda.memory_reserved()}


def _graph_verdicts(path, eager, graph, same, want):
    """What failed on a path: the graph side not replaying; results not
    bit for bit; launches a call off the expected ``want`` (kernel →
    launches a call) — the eager side's by its wrappers, the graph
    side's by its graphs' kernel nodes, each side's by the kernel names
    of its first complete profile; a launch counted from the other
    source; or a graph whose kernel nodes are not the launches its
    capture recorded."""
    from paddle_tpu_torch.ops.cuda import KERNELS

    failed = []
    if graph["last_run_mode"] != "graph":
        failed.append("%s: the graph side ran %r" % (path,
                                                     graph["last_run_mode"]))
    if not same:
        failed.append("%s: eager and graph results differ" % path)
    full = {k: float(want.get(k, 0)) for k in KERNELS}
    none = dict.fromkeys(KERNELS, 0.0)
    for label, side, counted, other in (
            ("eager", eager, "launches_by_wrapper",
             "launches_by_graph_nodes"),
            ("graph", graph, "launches_by_graph_nodes",
             "launches_by_wrapper")):
        for how, expect in ((counted, full), (other, none)):
            got = {k: float(side[how].get(k, 0)) for k in KERNELS}
            if got != expect:
                failed.append("%s %s: %s %s != %s"
                              % (path, label, how, got, expect))
        done = [t for t in side["profiles"] if t["complete"]]
        if not done:
            failed.append("%s %s: no complete profile in %d (markers seen "
                          "%s)" % (path, label, len(side["profiles"]),
                                   [t["markers_seen"]
                                    for t in side["profiles"]]))
        else:
            got = {k: float(done[0]["launches_by_profiler"].get(k, 0))
                   for k in KERNELS}
            if got != full:
                failed.append("%s %s: launches_by_profiler %s != %s"
                              % (path, label, got, full))
    for g in graph["graphs"]:
        if g["captured"] != g["kernel_nodes"]:
            failed.append("%s: a graph's kernel nodes %s != the launches "
                          "its capture recorded %s"
                          % (path, g["kernel_nodes"], g["captured"]))
    return failed


def _digest(scope, names):
    """sha256 over the bytes of the named scope tensors, in name order."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for n in sorted(names):
        t = scope.get(n)
        if t is not None:
            h.update(n.encode())
            h.update(t.detach().cpu().contiguous().view(-1).view(
                torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _persistable_names(program):
    return [v.name for v in program.global_block().vars.values()
            if v.persistable and not v.is_data]


def phase_graph_serve(env, pred, cfg):
    """The serving path, eager against its CUDA graphs, on the main
    path's predictor: every bucket called three times must end
    replaying; then one 8-row request eagerly (``use_program_cache=
    False``) and through the bucket's graph, bit for bit, with each
    side's numbers (``_graph_side``)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.executor import scope_guard

    rng = np.random.RandomState(SEED + 6)
    modes = {}
    for rows in BUCKETS:
        feed = _bert_request(rng, rows, cfg)
        modes[rows] = []
        for _ in range(3):
            pred.run(feed)
            modes[rows].append(pred._exe.last_run_mode)
    feed = _bert_request(rng, BUCKETS[-1], cfg)
    exe = pred._exe

    def eager(return_numpy=True):
        with scope_guard(pred._scope):
            return exe.run(pred._program, feed=feed,
                           fetch_list=pred._fetch_vars,
                           return_numpy=return_numpy,
                           use_program_cache=False)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want_out = eager()[0]
    e = _graph_side(exe, eager, lambda: eager(False))
    torch.cuda.reset_peak_memory_stats()
    got_out = pred.run(feed)[0]
    g = _graph_side(exe, lambda: pred.run(feed),
                    lambda: pred.run_async(feed))
    same = bool(np.array_equal(want_out, got_out))
    entries = [{"feeds": {n: [list(shape), dtype] for n, shape, dtype
                          in key[3]}, "calls": entry.calls,
                "graph": entry.graph is not None}
               for key, entry in exe._cache.items()]
    emit({"phase": "graph", "path": "serve", "bucket": BUCKETS[-1],
          "card": card_label(env), "modes_by_bucket": modes,
          "cache_entries": entries, "bit_identical": same, "eager": e,
          "graph": g})
    failed = _graph_verdicts("serve", e, g, same, {
        "flash_attention_fwd": 12, "fused_dropout_add_ln_fwd": 25,
        "embedding_gather_fwd": 3})
    failed += ["serve: bucket %d ran %s" % (r, m) for r, m in modes.items()
               if m[-1] != "graph"]
    if failed:
        raise AssertionError("; ".join(failed))


def _train_graph_side(fluid, main, startup, loss, batch, cache, group=None,
                      timed=True):
    """One side of a training path from a fresh scope: GRAPH_STEPS steps;
    returns their losses and modes, a digest of every persistable after
    them and, when ``timed``, the side's numbers (``_graph_side``)."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup)

        def call(return_numpy=True):
            return exe.run(main, feed=batch, fetch_list=[loss],
                           return_numpy=return_numpy,
                           use_program_cache=cache)

        losses, modes = [], []
        for _ in range(GRAPH_STEPS):
            losses.append(np.asarray(call()[0]).copy())
            modes.append(exe.last_run_mode)
        side = _graph_side(exe, call, lambda: call(False), group) \
            if timed else {}
        side["modes"] = modes
        side["copy_backs_per_step"] = _copy_backs(exe)
        digest = _digest(scope, _persistable_names(main))
        del call
    del scope, exe
    torch.cuda.empty_cache()
    return losses, digest, side


def _train_graph_path(env, path, fluid, main, startup, loss, batch, want,
                      group=None, deterministic_flag=False):
    """A training path eager against graph, same program, same start,
    same feeds: the losses of GRAPH_STEPS steps and the digest of every
    persistable after them must be bit for bit eager against graph and
    eager against a second eager side, with the default algorithms or,
    with ``deterministic_flag``, under ``set_flags({
    "FLAGS_cpu_deterministic": True})`` (then also whether eager repeats
    itself without the flag, and a graph side's numbers with the flag);
    each graph side copies no state back.  Then each side's numbers from
    a fresh start with the default flags, as the main path runs."""
    import numpy as np

    def same(a, b):
        return a[1] == b[1] and all(np.array_equal(x, y)
                                    for x, y in zip(a[0], b[0]))

    def side(cache, timed=False):
        return _train_graph_side(fluid, main, startup, loss, batch, cache,
                                 group, timed=timed)

    fluid.set_flags({"FLAGS_cpu_deterministic": deterministic_flag})
    try:
        e_cmp, g_cmp, again = side(False), side(True), side(False)
        flagged = side(True, timed=True)[2] if deterministic_flag else None
    finally:
        fluid.set_flags({"FLAGS_cpu_deterministic": False})
    loose = None
    if deterministic_flag:
        loose = same(side(False), side(False))
    _, _, e = side(False, timed=True)
    _, _, g = side(True, timed=True)
    identical, repeats = same(e_cmp, g_cmp), same(e_cmp, again)
    line = {"phase": "graph", "path": path, "card": card_label(env),
            "flags_of_compared_steps": {
                "FLAGS_cpu_deterministic": deterministic_flag},
            "bit_identical": identical, "eager_repeats_bit_for_bit": repeats,
            "losses_eager": [float(x.reshape(-1)[0]) for x in e_cmp[0]],
            "losses_graph": [float(x.reshape(-1)[0]) for x in g_cmp[0]],
            "modes_graph_compared": g_cmp[2]["modes"],
            "copy_backs_compared_graph": g_cmp[2]["copy_backs_per_step"],
            "eager": e, "graph": g}
    if deterministic_flag:
        line.update({
            "eager_repeats_without_the_flag": loose,
            "graph_with_the_flag": flagged,
            "graph_step_ms_with_and_without_the_flag": [
                flagged["step_ms"], g["step_ms"]]})
    emit(line)
    failed = _graph_verdicts(path, e, g, identical, want)
    if not repeats:
        failed.append("%s: a second eager side differs from the first"
                      % path)
    for label, copies in (("compared", g_cmp[2]["copy_backs_per_step"]),
                          ("timed", g["copy_backs_per_step"])):
        if copies != [0]:
            failed.append("%s %s graph side copied state back: %s"
                          % (path, label, copies))
    return failed


def _decode_graph_path(env, cfg, paged, params):
    """A decode path eager against graph: two engines from one parameter
    dict, each driven through prefills of three prompts per bucket and
    GRAPH_STEPS greedy steps of every slot (``_decode_drive``), eagerly
    and through the cache: logits and tokens bit for bit, and both
    prefill buckets and the step must end replaying; then each side's
    numbers on one all-slots step."""
    import numpy as np
    import torch

    import paddle_tpu_torch as fluid

    mode = "paged" if paged else "ring"
    rng = np.random.RandomState(SEED + 8)
    lens = [n for b in DECODE_BUCKETS for n in (b // 2, b - 9, b - 1)]
    prompts = [rng.randint(1, cfg.vocab - 1, size=n).astype("int32")
               for n in lens]
    out, sides, modes = {}, {}, {}
    for cache in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng = _decode_engine(cfg, paged, fluid.CUDAPlace(0), params,
                             name="graph%d" % cache)
        modes[cache] = {}
        out[cache] = _decode_drive(eng, prompts, GRAPH_STEPS, cache=cache,
                                   modes=modes[cache])
        feed = _decode_step_feed(eng, rng, cfg.vocab)

        def call(return_numpy=True, eng=eng, feed=feed, cache=cache):
            return eng._exe.run(eng._step_prog, feed=feed,
                                fetch_list=[eng._step_fetch],
                                scope=eng.scope, return_numpy=return_numpy,
                                use_program_cache=cache)

        for _ in range(2):  # this fetch list's warm-up and capture
            call()
        sides[cache] = _graph_side(eng._exe, call, lambda c=call: c(False))
        sides[cache]["modes"] = modes[cache]
        del eng, call
        torch.cuda.empty_cache()
    (e_logits, e_toks), (g_logits, g_toks) = out[False], out[True]
    same = all(np.array_equal(a, b) for a, b in zip(e_logits, g_logits)) \
        and all(np.array_equal(a, b) for a, b in zip(e_toks, g_toks))
    emit({"phase": "graph", "path": "decode_" + mode,
          "card": card_label(env), "bit_identical": same,
          "prompt_lens": lens, "eager": sides[False], "graph": sides[True]})
    failed = _graph_verdicts("decode_" + mode, sides[False], sides[True],
                             same, _decode_launches(cfg, paged, 1, 0))
    failed += ["decode_%s: %s ran %s" % (mode, label, m)
               for label, m in modes[True].items() if m[-1] != "graph"]
    return failed


def phase_graph(env):
    """Eager against the captured CUDA graph on the training, decode and
    ResNet paths, at the main paths' configurations: BERT-base MLM
    pretraining (T=512, batch 8, dropout 0.1), GPT-2-small widths decoded
    ring then paged, ResNet-50 NHWC at batch 64; every result bit for
    bit, every graph side replaying, each side's numbers
    (``_graph_side``)."""
    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert, gpt, resnet
    from paddle_tpu_torch.static_analysis import fusion

    failed = []
    cfg = bert.BERT_BASE
    main, startup, loss = _train_program(fluid, bert, cfg, SEQ)
    batch = bert.make_fake_batch(TRAIN_BATCH, SEQ, cfg,
                                 np.random.RandomState(SEED))
    prog, _ = fusion.resolve_fused_program(main, targets=[loss.name])
    failed += _train_graph_path(env, "train", fluid, main, startup, loss,
                                batch, _train_launches(prog))
    del main, startup, batch
    gcfg = gpt.GPT2_SMALL_WIDTHS
    first = _decode_engine(gcfg, False, fluid.CUDAPlace(0))
    params = {p.name: first.scope.get(p.name).cpu().numpy()
              for p in first._step_prog.all_parameters()}
    del first
    torch.cuda.empty_cache()
    for paged in (False, True):
        failed += _decode_graph_path(env, gcfg, paged, params)
    del params
    main, startup, _feeds, loss, _acc = resnet.build(
        dataset="imagenet", depth=50, data_format="NHWC")
    main.random_seed = startup.random_seed = SEED
    batch = {k: torch.from_numpy(v).cuda() for k, v in _resnet_batch(
        np, np.random.RandomState(SEED), RESNET_BATCH, RESNET_HW).items()}
    prog, _ = fusion.resolve_fused_program(main, targets=[loss.name])
    failed += _train_graph_path(env, "resnet", fluid, main, startup, loss,
                                batch, _resnet_launches(prog), _resnet_group,
                                deterministic_flag=True)
    del main, startup, batch
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("graph phase failed: %s" % "; ".join(failed))


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
                            "launches_by_group": _group_launches(
                                pr, 1, _dp_group),
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
    k3 = r0["quant"]["profile"]["launches_by_group"].get("K3 bwd", 0)
    if per_step["embedding_gather_bwd"] != 3 \
            or k3 != 3 * K3_BWD_LAUNCHES:
        failed.append("K3 backward: %s calls a step by its wrapper, %s "
                      "launches in the profiled step by the kernels' names "
                      "(want 3 and %d)" % (per_step["embedding_gather_bwd"],
                                           k3, 3 * K3_BWD_LAUNCHES))
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


# ---------------------------------------------------------------------------
# bf16 AMP: the kernels in the AMP paths' call forms, and the three paths
# ---------------------------------------------------------------------------

AMP_TRAIN_STEPS = 5
# one AMP step of a 2-layer BERT at BERT-base width, card against the
# CPU plain versions: the loss is a bf16 value (one unit is 2^-7
# relative at most; measured equal); the float32 master gradients come
# through bf16 products that round alike on both sides but for values on
# a rounding boundary, which then differ by a unit and carry it on
# (measured up to 9.6e-3, the word embedding's)
PARITY_AMP_LOSS_RTOL = 2 * BF16_UNIT
PARITY_AMP_GRAD_RTOL = 4 * BF16_UNIT   # max |GPU - CPU| over max |CPU|
# the same step in float32: AMP's loss must differ from it by more than
# the float32 parity tolerance (bf16 ran) and less than this bound
PARITY_AMP_VS_F32_MAX = 0.05
# one AMP Momentum step of ResNet-20 (cifar10, NHWC, 21 fused sites with
# the cast sandwich) at batch 8, card against CPU: the float32 loss
# (measured 6.4e-5), the fc gradients (3.7e-3) and the moving statistics
# (9.2e-4, max over max)
PARITY_RESNET_AMP_LOSS_RTOL = 1e-3
PARITY_RESNET_AMP_GRAD_RTOL = 4 * BF16_UNIT   # l2 |GPU - CPU| / l2 |CPU|
# every other gradient's cosine with the CPU's: bf16 relu flips move the
# convolution and batch_norm gradients by tens of percent (bf16 against
# float32 on the CPU: 30-50% l2), so these are held in direction only
PARITY_RESNET_AMP_DEEP_COS = 0.5
RESNET_AMP_PARITY_BATCH = 8
# serving: the reference's bounds on a bf16 predictor's error against
# float32, max |diff| over max |f32| (tests/test_inference.py:317-320)
SERVE_BF16_ERR = (1e-6, 0.05)


# the elementwise copies that convert between float32 and bfloat16
CAST_NEEDLES = ("bfloat16_copy", "float16_copy", "withcast", "_to_copy",
                "casting")


def _with_casts(group):
    """``group`` (a profile's kernel grouping) with the dtype casts a
    group of their own."""
    def grouped(name):
        low = name.lower()
        return "casts" if any(n in low for n in CAST_NEEDLES) \
            else group(name)
    return grouped


def _dtype_nodes(exe):
    """``{"kernel:dtype": nodes}`` over the executor's captured graphs:
    each kernel node of :data:`KERNELS`, with the element type its
    device function was instantiated for (``_lib.kernel_dtype``; the
    gather moves raw words, so it has none)."""
    from paddle_tpu_torch.ops.cuda import _lib

    out = {}
    for e in exe._cache.values():
        if e.graph is None:
            continue
        for fn in _lib.graph_kernel_functions(e.graph):
            k = _lib.kernel_of(fn)
            if k is not None:
                key = "%s:%s" % (k, _lib.kernel_dtype(fn) or "words")
                out[key] = out.get(key, 0) + 1
    return out


def _cast_nodes(exe):
    """The dtype casts (kernel nodes named by ``CAST_NEEDLES``) of each of
    the executor's captured graphs, in the cache's order: one replay of a
    graph runs each of them once."""
    from paddle_tpu_torch.ops.cuda import _lib

    return [sum(any(n in fn.lower() for n in CAST_NEEDLES)
                for fn in _lib.graph_kernel_functions(e.graph))
            for e in exe._cache.values() if e.graph is not None]


def kernel_amp(checks, torch, gen):
    """The kernels in the call forms of the AMP paths, against their
    plain versions on the same inputs: K2 through its op entry with bf16
    gamma and beta (the rewrite casts them; they go up to float32, and
    their gradients come back through the cast), K1 through its entry
    with a bf16 mask bias ([B,1,1,T], -1e4 rounded to bf16), both at
    BERT-base's shapes and dropout 0 and 0.1, and K4 forward and backward
    in bf16 at every ResNet-50 site shape, relu and identity.  Returns
    the bf16 rows' errors."""
    from paddle_tpu_torch.ops.cuda import conv_bn_act as cba
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import fused_ln as fl

    errs = {}
    n, d = TRAIN_BATCH * SEQ, 768
    bf = torch.bfloat16
    for rate in (0.0, DROPOUT):
        seed = drop_seed() if rate else None
        x, res, dout = (torch.randn((n, d), generator=gen, device="cuda")
                        .to(bf) for _ in range(3))
        g = (1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
             ).to(bf)
        b = (0.1 * torch.randn((d,), generator=gen, device="cuda")).to(bf)
        leaves = [t.clone().requires_grad_() for t in (x, res, g, b)]
        out = fl.fused_dropout_add_ln(*leaves, dropout_rate=rate,
                                      eps=1e-12, seed=seed)
        grads = torch.autograd.grad(out, leaves, dout)
        ref, y, mean, rstd = fl.fused_dropout_add_ln_fwd_plain(
            x, res, g.float(), b.float(), 1e-12, rate, seed)
        refs = fl.fused_dropout_add_ln_bwd_plain(dout, y, g.float(), mean,
                                                 rstd, rate, seed)
        refs = refs[:2] + tuple(t.to(bf) for t in refs[2:])
        torch.cuda.synchronize()
        case = "op entry, bf16 x/res/gamma/beta [%d, %d] rate %g" % (
            n, d, rate)
        errs["fused_dropout_add_ln_fwd_bf16_rate%g" % rate] = checks.check(
            "fused_dropout_add_ln_fwd", case, max_err(out, ref),
            _tol(ref, units=1))
        bwd = []
        for what, a, r in zip(("dx", "dres", "dgamma", "dbeta"), grads,
                              refs):
            if a.dtype != r.dtype:
                checks.failed.append("fused_dropout_add_ln_bwd %s: %s is "
                                     "%s, not %s" % (case, what, a.dtype,
                                                     r.dtype))
            bwd.append(checks.check("fused_dropout_add_ln_bwd",
                                    "%s, %s" % (what, case), max_err(a, r),
                                    _tol(r)))
        errs["fused_dropout_add_ln_bwd_bf16_rate%g" % rate] = max(bwd)
        del x, res, dout, out, grads, ref, refs, leaves
    bh, t, dh = TRAIN_BATCH * 12, SEQ, 64
    for rate in (0.0, DROPOUT):
        seed = drop_seed() if rate else None
        q, k, v, bias = _flash_inputs(torch, TRAIN_BATCH, 12, t, dh, bf, gen)
        bias4 = bias.to(bf).reshape(TRAIN_BATCH, 1, 1, t)
        do = torch.randn((bh, t, dh), generator=gen, device="cuda").to(bf)
        leaves = [a.reshape(TRAIN_BATCH, 12, t, dh).clone().requires_grad_()
                  for a in (q, k, v)]
        o = fa.flash_attention(*leaves, bias=bias4, sm_scale=0.125,
                               dropout_rate=rate, dropout_seed=seed)
        grads = torch.autograd.grad(o, leaves, do.reshape(o.shape))
        b32 = bias4.float().reshape(TRAIN_BATCH, t)
        ro, m, l = fa.flash_attention_fwd_plain(q, k, v, b32, False, 0.125,
                                                rate, seed)
        rg = fa.flash_attention_bwd_plain(q, k, v, b32, ro, m, l, do, False,
                                          0.125, rate, seed)
        torch.cuda.synchronize()
        case = "entry, bf16 q/k/v [%d, %d, %d] + bf16 mask bias, rate %g" % (
            bh, t, dh, rate)
        errs["flash_attention_fwd_bf16_rate%g" % rate] = checks.check(
            "flash_attention_fwd", case, max_err(o.reshape(ro.shape), ro),
            _tol(ro))
        for kernel, what, a, r in (
                ("flash_attention_bwd_dq", "dq", grads[0], rg[0]),
                ("flash_attention_bwd_dkv", "dk", grads[1], rg[1]),
                ("flash_attention_bwd_dkv", "dv", grads[2], rg[2])):
            errs["%s_bf16_rate%g" % (kernel, rate)] = max(
                errs.get("%s_bf16_rate%g" % (kernel, rate), 0.0),
                checks.check(kernel, "%s, %s" % (what, case),
                             max_err(a.reshape(r.shape), r), _tol(r)))
        del q, k, v, do, leaves, o, grads, ro, rg
    for r, c in RESNET_SITE_SHAPES:
        y, g, b, mean, rstd, dout = _bn_act_inputs(torch, gen, r, c, bf)
        for act in ("relu", "identity"):
            case = "[%d, %d] %s bfloat16 (a ResNet-50 site)" % (r, c, act)
            got = cba.bn_act_epilogue_fwd(y, g, b, mean, rstd, act)
            ref = cba.bn_act_epilogue_fwd_plain(y, g, b, mean, rstd, act)
            grads = cba.bn_act_epilogue_bwd(dout, y, g, b, mean, rstd, act)
            refs = cba.bn_act_epilogue_bwd_plain(dout, y, g, b, mean, rstd,
                                                 act)
            torch.cuda.synchronize()
            ferr = checks.check("bn_act_epilogue_fwd", case,
                                max_err(got, ref), _tol(ref, units=1))
            berr = max(checks.check(
                "bn_act_epilogue_bwd", "%s, %s" % (what, case),
                max_err(a, rf), _tol(rf))
                for what, a, rf in zip(("dy", "dgamma", "dbeta", "dmean",
                                        "drstd"), grads, refs))
            if (r, c) == K4_TIME_SHAPE and act == "relu":
                errs["bn_act_epilogue_fwd_bf16"] = ferr
                errs["bn_act_epilogue_bwd_bf16"] = berr
        del y, dout, got, ref, grads, refs
    torch.cuda.empty_cache()
    return errs


def time_amp_kernels(torch, gen, errs):
    """Cold-L2 times of the kernels the AMP paths launch in bfloat16 that
    the other rows time in float32 only: K2 forward at [4096, 768] bf16
    (``time_ln_fwd``: rate 0.1 with y/mean/rstd saved, training; rate 0
    out only, serving); K4 forward and backward at [200704, 256] bf16
    relu, beside ``F.batch_norm`` + relu in bf16 and ATen's batch-norm
    backward pass in bf16.  Bounds by the bytes moved at 2 bytes an
    element (gamma, beta and the statistics float32)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import conv_bn_act as cba

    bf = torch.bfloat16
    rows = time_ln_fwd(torch, gen, errs, bf)
    r, c = K4_TIME_SHAPE
    y, g, b, mean, rstd, dout = _bn_act_inputs(torch, gen, r, c, bf)
    side = int(round((r // RESNET_BATCH) ** 0.5))
    y4 = y.view(RESNET_BATCH, side, side, c).permute(0, 3, 1, 2)
    d4 = dout.view(RESNET_BATCH, side, side, c).permute(0, 3, 1, 2)
    var = 1.0 / (rstd * rstd) - 1e-5
    gb, bb = g.to(bf), b.to(bf)
    n_el = r * c
    ksrc = ("paddle_tpu_torch/csrc/conv_bn_act.cu",
            "paddle_tpu/ops/pallas/conv_bn_act.py:")
    shape = "y [%d, %d] bf16 relu (%dx%d x %d channels at batch %d)" % (
        r, c, side, side, c, RESNET_BATCH)
    rows.append(_row(
        "bn_act_epilogue_fwd", ksrc[0], ksrc[1] + "153",
        errs.get("bn_act_epilogue_fwd_bf16"),
        time_ms(lambda: cba.bn_act_epilogue_fwd(y, g, b, mean, rstd,
                                                "relu"), 20),
        time_ms(lambda: cba.bn_act_epilogue_fwd_plain(y, g, b, mean, rstd,
                                                      "relu"), 20),
        bound_ms(2 * 2 * n_el + 4 * 4 * c, 5 * n_el, "float32"),
        time_ms(lambda: F.relu(F.batch_norm(y4, mean, var, gb, bb, False,
                                            0.0, 1e-5)), 20),
        shape + "; library: F.batch_norm + relu, bf16"))
    try:
        lib_bwd = time_ms(lambda: _bn_act_library_bwd(
            torch, y4, d4, g, mean, rstd), 20)
    except (RuntimeError, TypeError) as e:  # a yardstick only
        lib_bwd = None
        emit({"phase": "kernels", "library_bwd_bf16_unavailable": str(e)})
    rows.append(_row(
        "bn_act_epilogue_bwd", ksrc[0], ksrc[1] + "175",
        errs.get("bn_act_epilogue_bwd_bf16"),
        time_ms(lambda: cba.bn_act_epilogue_bwd(dout, y, g, b, mean, rstd,
                                                "relu"), 20),
        time_ms(lambda: cba.bn_act_epilogue_bwd_plain(dout, y, g, b, mean,
                                                      rstd, "relu"), 20),
        bound_ms(2 * 3 * n_el + 4 * (4 * c + 4 * c), 12 * n_el, "float32"),
        lib_bwd, shape + "; library: ATen batch_norm_backward_reduce + "
        "_elemt, bf16"))
    del y, dout, y4, d4
    torch.cuda.empty_cache()
    return rows


def phase_amp_kernels():
    """``kernel_amp``'s checks, then ``time_amp_kernels``' rows, each
    printed as a timing line."""
    import torch

    gen = _gen(torch)
    checks = Checks()
    errs = kernel_amp(checks, torch, gen)
    if checks.failed:
        raise AssertionError("AMP kernel checks failed: %s"
                             % "; ".join(checks.failed))
    for r in time_amp_kernels(torch, gen, errs):
        emit(dict({"phase": "kernels", "timing": True, "amp": True}, **r))
    torch.cuda.empty_cache()


def _amp_train_program(fluid, bert, cfg):
    main, startup, _feeds, loss = bert.build_pretrain(
        cfg, seq_len=SEQ, lr=TRAIN_LR, amp=True)
    main.random_seed = startup.random_seed = SEED
    return main, startup, loss


def _amp_steps(env, phase, exe, main, batch, fetch, want, want_dtype,
               per_item):
    """An AMP path's warm-up (eager, then capture) and AMP_TRAIN_STEPS
    timed replays on one repeated batch: the launches a step by source
    and, from the replayed graphs' kernel nodes, by kernel and element
    type, against ``want`` / ``want_dtype``, and the dtype casts each
    graph holds; peak memory; copy-backs; finite losses (the first
    fetch).  ``per_item`` is (label, items a
    step) for the rate.  Emits the steps line, raises on a failed check
    → the launches by source."""
    import statistics

    import numpy as np
    import torch

    from paddle_tpu_torch.ops.cuda import (KERNELS, launch_counts,
                                           launch_counts_by_source,
                                           reset_launch_counts)

    losses = [float(np.asarray(exe.run(main, feed=batch, fetch_list=fetch)
                               [0]).reshape(-1)[0])
              for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    step_ms = []
    for _ in range(AMP_TRAIN_STEPS):
        s0 = time.perf_counter()
        out = exe.run(main, feed=batch, fetch_list=fetch)
        step_ms.append((time.perf_counter() - s0) * 1e3)
        losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
    counts = launch_counts_by_source()
    per_step = {k: c / AMP_TRAIN_STEPS for k, c in launch_counts().items()}
    full = dict.fromkeys(KERNELS, 0.0)
    full.update(want)
    by_dtype = _dtype_nodes(exe)
    med = statistics.median(step_ms)
    off = _graphs_off(exe)
    copies = _copy_backs(exe)
    emit({"phase": phase, "step": "steps", "card": card_label(env),
          "losses": losses, "step_ms": step_ms, "median_step_ms": med,
          per_item[0]: per_item[1] / (med / 1e3),
          "launches_per_step": per_step, "launches_by_source": counts,
          "expected": full, "graph_nodes_by_kernel_and_dtype": by_dtype,
          "cast_nodes_per_graph": _cast_nodes(exe),
          "expected_by_dtype": want_dtype,
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "last_run_mode": exe.last_run_mode, "copy_backs_per_step": copies,
          "graphs_nodes_not_captured_launches": off})
    failed = []
    if copies != [0]:
        failed.append("state copied back a step: %s" % copies)
    if per_step != full or any(counts["wrapper"].values()) or off:
        failed.append("launches per step %s != %s (by source %s, graphs "
                      "%s)" % (per_step, full, counts, off))
    if by_dtype != want_dtype:
        failed.append("graph nodes by dtype %s != %s"
                      % (by_dtype, want_dtype))
    if exe.last_run_mode != "graph":
        failed.append("the timed steps ran %r" % exe.last_run_mode)
    if not all(np.isfinite(losses)):
        failed.append("loss not finite: %s" % losses)
    if failed:
        raise AssertionError("%s: %s" % (phase, "; ".join(failed)))
    return counts, losses


def phase_train_amp(env):
    """BERT-base MLM pretraining with ``build_pretrain(amp=True)`` (T=512,
    B=8, dropout 0.1, Adam on float32 masters) on the executor's captured
    graph: warm-up, then timed steps with the launches read from the
    replayed graphs' kernel nodes, by kernel and by the element type of
    each node's device function; peak memory; copy-backs; device time by
    group with the casts a group of their own; then eager = graph =
    eager, bit for bit, over GRAPH_STEPS steps from one start."""
    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.static_analysis import fusion

    cfg = bert.BERT_BASE
    t0 = time.time()
    main, startup, loss = _amp_train_program(fluid, bert, cfg)
    batch = bert.make_fake_batch(TRAIN_BATCH, SEQ, cfg,
                                 np.random.RandomState(SEED))
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup)
        prog, report = fusion.resolve_fused_program(main,
                                                    targets=[loss.name])
        op_types = _op_type_counts(prog)
        masters = sorted({str(p.dtype) for p in main.all_parameters()})
        emit({"phase": "train_amp", "step": "build+startup",
              "seconds": time.time() - t0, "fused": report.counts(),
              "op_types": op_types, "parameter_dtypes": masters})
        if masters != ["float32"] or not op_types.get("cast"):
            raise AssertionError("AMP program: parameters %s, %s casts"
                                 % (masters, op_types.get("cast")))
        want = _train_launches(prog)
        want_dtype = {
            "flash_attention_fwd:bfloat16": 12,
            "flash_attention_bwd_dkv:bfloat16": 12,
            "flash_attention_bwd_dq:bfloat16": 12,
            "fused_dropout_add_ln_fwd:bfloat16": 25,
            "fused_dropout_add_ln_bwd:bfloat16": 25,
            "embedding_gather_fwd:words": 3,
            "embedding_gather_bwd:float32": 3,
            "adam_update:float32": want["adam_update"]}
        counts, losses = _amp_steps(
            env, "train_amp", exe, main, batch, [loss], want, want_dtype,
            ("tokens_per_s", TRAIN_BATCH * SEQ))
        if not losses[-1] < losses[0]:
            raise AssertionError("train_amp: loss not falling: %s" % losses)
        prof = _step_profile(exe, main, batch, [loss],
                             _with_casts(_kernel_group))
        emit(dict({"phase": "train_amp", "step": "profile",
                   "card": card_label(env)}, **prof))
    del scope, exe
    torch.cuda.empty_cache()
    # eager = graph = eager over the same steps from the same start
    sides = [_train_graph_side(fluid, main, startup, loss, batch, cache,
                               timed=False)
             for cache in (False, True, False)]
    same = [a[1] == b[1] and all(np.array_equal(x, y)
                                 for x, y in zip(a[0], b[0]))
            for a, b in ((sides[0], sides[1]), (sides[0], sides[2]))]
    graph = sides[1][2]
    emit({"phase": "train_amp", "step": "eager = graph = eager",
          "losses": [[float(x.reshape(-1)[0]) for x in s[0]]
                     for s in sides],
          "modes": [s[2]["modes"] for s in sides], "bit_identical": same,
          "copy_backs_graph_side": graph["copy_backs_per_step"]})
    if not all(same) or graph["modes"][-1] != "graph" \
            or graph["copy_backs_per_step"] != [0]:
        raise AssertionError("train_amp: eager, graph and eager differ or "
                             "the graph side did not replay")
    return counts


def phase_train_amp_parity():
    """One AMP step (dropout 0.1) of a 2-layer BERT at BERT-base width
    (B=2, T=512) on the card and on the CPU with the plain versions, from
    the same start and masks, the card's a replay of its captured graph;
    and the same step in float32 on the card (the same calls, so the same
    masks): AMP's loss must differ from it by more than the float32
    parity tolerance and less than PARITY_AMP_VS_F32_MAX, and the
    gradients' AMP-against-float32 differences are printed."""
    import copy

    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models import bert

    cfg = copy.copy(bert.BERT_BASE)
    cfg.layers = 2
    with fluid.unique_name.guard():  # the f32 twin's names alike
        main, startup, loss = _amp_train_program(fluid, bert, cfg)
    grads = _grad_names(main)
    names = ["bert.word_emb", "bert.layer0.attn.q.w", "bert.layer0.ln1.scale"]
    fetch = [loss.name] + [grads[n] for n in names]
    batch = bert.make_fake_batch(2, SEQ, cfg, np.random.RandomState(SEED + 3))
    out, modes, start = {}, {}, None
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = fluid.Executor(place)
            exe.run(startup)
            if start is None:
                start = convert.scope_persistables(main, scope)
            out[place._kind], modes[place._kind] = _parity_calls(
                fluid, convert, exe, scope, main, place, start,
                lambda: exe.run(main, feed=batch, fetch_list=fetch))
        del scope, exe
    with fluid.unique_name.guard():
        f32main, f32startup, f32loss = _train_program(fluid, bert, cfg, SEQ)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):  # the same calls, so the same masks
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(f32startup)
        f32_out, _ = _parity_calls(
            fluid, convert, exe, scope, f32main, fluid.CUDAPlace(0), start,
            lambda: exe.run(f32main, feed=batch,
                            fetch_list=[f32loss.name] + fetch[1:]))
        f32 = float(f32_out[0][0])
    del scope, exe
    gpu, cpu = out["cuda"], out["cpu"]
    g_loss, c_loss = float(gpu[0][0]), float(cpu[0][0])
    result = {"phase": "train_amp_parity", "step": "GPU kernels vs CPU "
              "plain versions, one AMP step, dropout 0.1, the last of %d "
              "from one start" % PARITY_CALLS, "modes": modes,
              "loss_dtype": str(np.asarray(gpu[0]).dtype),
              "loss": [g_loss, c_loss],
              "loss_rel_err": abs(g_loss - c_loss) / abs(c_loss),
              "loss_tol": PARITY_AMP_LOSS_RTOL, "f32_loss": f32,
              "amp_vs_f32_rel": abs(g_loss - f32) / abs(f32),
              "amp_vs_f32_bounds": [PARITY_LOSS_RTOL,
                                    PARITY_AMP_VS_F32_MAX],
              "amp_vs_f32_grad_rel": {
                  n: float(np.abs(g - f).max()) / max(float(np.abs(f).max()),
                                                      1e-30)
                  for n, g, f in zip(names, gpu[1:], f32_out[1:])}}
    ok = result["loss_rel_err"] <= PARITY_AMP_LOSS_RTOL \
        and modes["cuda"][-1] == "graph" \
        and PARITY_LOSS_RTOL < result["amp_vs_f32_rel"] \
        < PARITY_AMP_VS_F32_MAX
    for name, g, c in zip(names, gpu[1:], cpu[1:]):
        err = float(np.abs(g - c).max()) / max(float(np.abs(c).max()), 1e-30)
        result[name + "@GRAD rel_err"] = err
        result[name + "@GRAD dtype"] = str(g.dtype)
        ok = ok and np.isfinite(g).all() and err <= PARITY_AMP_GRAD_RTOL \
            and g.dtype == np.float32
    result["grad_tol"] = PARITY_AMP_GRAD_RTOL
    emit(result)
    if not ok:
        raise AssertionError("train_amp parity failed: %s" % result)


def phase_resnet_amp(env, f32_groups):
    """ResNet-50 NHWC (``resnet.build(dataset="imagenet", depth=50,
    data_format="NHWC", amp=True)``) at batch 64, Nesterov Momentum, on
    the captured graph: every conv -> batch_norm site fused with its
    cast sandwich and no batch_norm op left; 65 K4 forward and 65 K4
    backward graph nodes a step, all bfloat16; timed steps, images/s,
    peak memory, copy-backs, device time by group (the casts apart); and
    the layout copies' device ms a step against the float32 path's
    (``f32_groups``, phase_resnet's profile in the same run)."""
    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.static_analysis import fusion

    t0 = time.time()
    main, startup, _feeds, loss, acc = resnet.build(
        dataset="imagenet", depth=50, data_format="NHWC", amp=True)
    main.random_seed = startup.random_seed = SEED
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup)
        prog, report = fusion.resolve_fused_program(
            main, targets=[loss.name, acc.name])
        op_types = _op_type_counts(prog)
        notes = [r.note for r in report.applied if r.family == "conv_bn_act"]
        sandwiches = sum("AMP cast sandwich" in n for n in notes)
        emit({"phase": "resnet_amp", "step": "build+startup",
              "seconds": time.time() - t0, "fused": report.counts(),
              "sites_with_cast_sandwich": sandwiches, "op_types": op_types})
        if report.counts() != {"conv_bn_act": RESNET_SITES} \
                or sandwiches != RESNET_SITES or op_types.get("batch_norm"):
            raise AssertionError("resnet_amp fusion: %s, %d sandwiches, %s "
                                 "batch_norm" % (report.counts(), sandwiches,
                                                 op_types.get("batch_norm")))
        batch = {k: torch.from_numpy(v).cuda() for k, v in _resnet_batch(
            np, np.random.RandomState(SEED), RESNET_BATCH,
            RESNET_HW).items()}
        want = _resnet_launches(prog)
        want_dtype = {"bn_act_epilogue_fwd:bfloat16": RESNET_SITES,
                      "bn_act_epilogue_bwd:bfloat16": RESNET_SITES,
                      "momentum_update:float32": want["momentum_update"]}
        counts, _ = _amp_steps(
            env, "resnet_amp", exe, main, batch, [loss, acc], want,
            want_dtype, ("images_per_s", RESNET_BATCH))
        prof = _step_profile(exe, main, batch, [loss, acc],
                             _with_casts(_resnet_group), top_n=25)
        emit(dict({"phase": "resnet_amp", "step": "profile",
                   "card": card_label(env),
                   "layout_copies_ms_bf16_vs_f32": [
                       prof["device_ms_by_group"].get("layout copies", 0.0),
                       f32_groups.get("layout copies", 0.0)],
                   "f32_device_ms_by_group": f32_groups}, **prof))
    del scope, exe, batch
    torch.cuda.empty_cache()
    return counts


def phase_resnet_amp_parity():
    """One AMP Nesterov Momentum step of ResNet-20 (``resnet.build(
    dataset="cifar10", data_format="NHWC", amp=True)``, 21 fused sites
    with the cast sandwich) at batch RESNET_AMP_PARITY_BATCH, on the card
    (the K4 kernels in bf16, the last of PARITY_CALLS from one start, so
    a graph replay) and on the CPU with the plain versions: the loss, the
    fc weight's and bias' float32 gradients and every moving statistic
    after the step within PARITY_RESNET_AMP_GRAD_RTOL; every other
    gradient at least PARITY_RESNET_AMP_DEEP_COS alike in direction (a
    bf16 relu input that rounds across 0 on one side only moves the
    convolution and batch_norm gradients below it by tens of percent,
    as bf16 against float32 does in one package)."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models import resnet

    with fluid.unique_name.guard():
        main, startup, _feeds, loss, _acc = resnet.build(
            dataset="cifar10", data_format="NHWC", amp=True)
    main.random_seed = startup.random_seed = SEED
    grads = {op.inputs["Param"][0]: op.inputs["Grad"][0]
             for op in main.global_block().ops if op.type == "momentum"}
    names = sorted(grads)
    held = [n for n in names if n.startswith("fc")]
    moving = sorted(p.name for p in main.all_parameters()
                    if not p.trainable)
    fetch = [loss.name] + [grads[n] for n in names]
    rng = np.random.RandomState(SEED + 9)
    batch = {"img": rng.randn(RESNET_AMP_PARITY_BATCH, 32, 32, 3).astype(
        "float32"), "label": rng.randint(0, 10, (RESNET_AMP_PARITY_BATCH,
                                                 1)).astype("int64")}
    out, after, modes, start = {}, {}, {}, None
    for place in (fluid.CPUPlace(), fluid.CUDAPlace(0)):
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = fluid.Executor(place)
            exe.run(startup)
            if start is None:
                start = convert.scope_persistables(main, scope)
            out[place._kind], modes[place._kind] = _parity_calls(
                fluid, convert, exe, scope, main, place, start,
                lambda: exe.run(main, feed=batch, fetch_list=fetch))
            after[place._kind] = convert.scope_persistables(main, scope)
        del scope, exe
    gpu, cpu = out["cuda"], out["cpu"]
    g_loss, c_loss = float(gpu[0][0]), float(cpu[0][0])
    res = {"phase": "resnet_amp_parity", "step": "card (K4 bf16) vs CPU "
           "plain versions, one AMP Momentum step, ResNet-20 NHWC 32x32 "
           "batch %d" % RESNET_AMP_PARITY_BATCH, "modes": modes,
           "loss": [g_loss, c_loss],
           "loss_rel_err": abs(g_loss - c_loss) / abs(c_loss),
           "loss_tol": PARITY_RESNET_AMP_LOSS_RTOL,
           "grad_tol": PARITY_RESNET_AMP_GRAD_RTOL,
           "cos_min_tol": PARITY_RESNET_AMP_DEEP_COS}
    ok = res["loss_rel_err"] <= PARITY_RESNET_AMP_LOSS_RTOL \
        and modes["cuda"][-1] == "graph"
    cos = {}
    for name, g, c in zip(names, gpu[1:], cpu[1:]):
        ok = ok and g.dtype == np.float32 and bool(np.isfinite(g).all())
        cos[name] = float(np.dot(g.ravel(), c.ravel()) / max(
            float(np.linalg.norm(g) * np.linalg.norm(c)), 1e-30))
        if name in held:
            err = float(np.linalg.norm(g - c)
                        / max(np.linalg.norm(c), 1e-30))
            res[name + "@GRAD l2_rel_err"] = err
            ok = ok and err <= PARITY_RESNET_AMP_GRAD_RTOL
    res["grad_cos_min"] = min(cos.values())
    res["grad_cos_min_at"] = min(cos, key=cos.get)
    res["grad_cos_median"] = float(np.median(list(cos.values())))
    ok = ok and res["grad_cos_min"] >= PARITY_RESNET_AMP_DEEP_COS
    res["moving_stats_max_rel_err"] = max(
        float(np.abs(after["cuda"][k] - after["cpu"][k]).max())
        / max(float(np.abs(after["cpu"][k]).max()), 1e-30) for k in moving)
    res["moving_stats_moved"] = sum(
        not np.array_equal(after["cuda"][k], start[k]) for k in moving)
    ok = ok and res["moving_stats_max_rel_err"] \
        <= PARITY_RESNET_AMP_GRAD_RTOL \
        and res["moving_stats_moved"] == len(moving)
    res["ok"] = ok
    emit(res)
    if not ok:
        raise AssertionError("resnet_amp parity failed: %s" % res)


def phase_serve_bf16(env, pred_f32, cfg):
    """BERT-base at T=512 served with ``AnalysisConfig.enable_bf16()``:
    the same seeded model exported again and loaded by a bf16 predictor
    on the card; the analysis passes ran before the rewrite (casts
    present, no batch_norm, the float32 predictor's fused op counts);
    requests through ``PredictorServer`` in the existing buckets with the
    launches read per batch, all K1 and K2 graph nodes bfloat16, and
    the dtype casts each bucket's graph holds; a digest of the served
    outputs; per bucket the bf16 and the float32 predictor's latency and
    tokens/s in turns; and the error against float32 within
    SERVE_BF16_ERR."""
    import hashlib

    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.executor import Scope, scope_guard
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops.cuda import (KERNELS, launch_counts,
                                           launch_counts_by_source,
                                           reset_launch_counts)
    from paddle_tpu_torch.static_analysis import fusion

    feeds = ["input_ids", "token_type_ids", "attn_mask_bias", "pos_ids"]
    t0 = time.time()
    main, startup, hidden = _bert_program(fluid, bert, cfg)
    export_dir = os.path.join(HERE, ".smoke_tmp", "bert_base_bf16_export")
    shutil.rmtree(export_dir, ignore_errors=True)
    try:
        scope = Scope()
        with scope_guard(scope):
            exe = fluid.Executor(fluid.CUDAPlace(0))
            exe.run(startup)
            fluid.io.save_inference_model(export_dir, feeds, [hidden], exe,
                                          main_program=main)
        del scope, exe
        bcfg = fluid.inference.AnalysisConfig(model_dir=export_dir)
        bcfg.enable_bf16()
        pred = fluid.inference.create_paddle_predictor(bcfg)
    finally:
        shutil.rmtree(export_dir, ignore_errors=True)

    def fused_counts(p):
        prog, _ = fusion.resolve_fused_program(
            p.program, targets=p.get_output_names())
        return {k: v for k, v in _op_type_counts(prog).items()
                if k.startswith("fused_") or k == "fc"}

    ops = _op_type_counts(pred.program)
    fused_bf16, fused_f32 = fused_counts(pred), fused_counts(pred_f32)
    emit({"phase": "serve_bf16", "step": "export+load",
          "seconds": time.time() - t0, "analyzed_ops": ops,
          "fused_bf16": fused_bf16, "fused_f32": fused_f32})
    if not ops.get("cast") or ops.get("batch_norm") \
            or fused_bf16 != fused_f32:
        raise AssertionError("bf16 predictor: casts %s, fused %s vs f32 %s"
                             % (ops.get("cast"), fused_bf16, fused_f32))
    rng = np.random.RandomState(SEED)
    requests = [_bert_request(rng, r, cfg) for r in REQUEST_ROWS]
    server = serving.PredictorServer(
        {"bert": pred}, buckets=BUCKETS, auto_start=False)
    try:
        warm = _bert_request(np.random.RandomState(SEED + 1), BUCKETS[-1],
                             cfg)
        for _ in range(2):
            pred.run(warm)
        reset_launch_counts()
        futures = [server.submit("bert", feed, request_id=i)
                   for i, feed in enumerate(requests)]
        server.start()
        results = [f.result(timeout=600) for f in futures]
        counts = launch_counts()
        by_source = launch_counts_by_source()
    finally:
        server.close()
    batches = len(server.dispatch_log)
    want = dict.fromkeys(KERNELS, 0)
    want.update({"flash_attention_fwd": 12 * batches,
                 "fused_dropout_add_ln_fwd": 25 * batches,
                 "embedding_gather_fwd": 3 * batches})
    by_dtype = _dtype_nodes(pred._exe)
    bad_dtype = {k: n for k, n in by_dtype.items()
                 if k.split(":")[0] in ("flash_attention_fwd",
                                        "fused_dropout_add_ln_fwd")
                 and not k.endswith(":bfloat16")}
    emit({"phase": "serve_bf16", "step": "serve", "batches": batches,
          "launches": counts, "expected_launches": want,
          "graph_nodes_by_kernel_and_dtype": by_dtype,
          "cast_nodes_per_graph": _cast_nodes(pred._exe)})
    if counts != want or bad_dtype:
        raise AssertionError("serve_bf16 launches %s != %s, or K1/K2 nodes "
                             "not bf16: %s" % (counts, want, bad_dtype))
    errs = []
    for feed, out, rows in zip(requests, results, REQUEST_ROWS):
        got = np.asarray(out[0]).astype("float32")
        if got.shape != (rows, SEQ, cfg.hidden) or not np.isfinite(got).all():
            raise AssertionError("bf16 request: shape %s or non-finite"
                                 % (got.shape,))
        ref = pred_f32.run(feed)[0]
        errs.append(float(np.abs(got - ref).max() / np.abs(ref).max()))
    lat = {}
    rng = np.random.RandomState(SEED + 2)
    for rows in BUCKETS:
        feed = _bert_request(rng, rows, cfg)
        for label, p in (("bf16", pred), ("f32", pred_f32), ("bf16", pred),
                         ("f32", pred_f32)):
            ms = _median_ms(lambda: p.run(feed))
            lat.setdefault(label, {}).setdefault(rows, []).append(ms)
    torch.cuda.synchronize()
    per_bucket = {str(rows): {
        label: {"latency_ms": min(lat[label][rows]),
                "tokens_per_s": rows * SEQ / (min(lat[label][rows]) / 1e3)}
        for label in ("bf16", "f32")} for rows in BUCKETS}
    emit({"phase": "serve_bf16", "step": "latency",
          "card": card_label(env), "per_bucket": per_bucket,
          "request_latency_ms": [f.latency_ms for f in futures],
          "scale_rel_err_vs_f32": errs, "err_bounds": SERVE_BF16_ERR,
          "outputs_sha256": hashlib.sha256(b"".join(
              np.asarray(out[0]).tobytes() for out in results)).hexdigest(),
          "output_dtype": str(np.asarray(results[0][0]).dtype)})
    lo, hi = SERVE_BF16_ERR
    if not all(lo < e < hi for e in errs):
        raise AssertionError("bf16 serving error vs f32 %s outside %s"
                             % (errs, SERVE_BF16_ERR))
    del server, pred
    torch.cuda.empty_cache()
    return by_source

SAMPLED = (("top_k", False, {"k": 8, "temperature": 1.0}),
           ("top_p", True, {"p": 0.9, "temperature": 0.8}))
SAMPLED_STEPS = 6     # all-slot steps compared eager against graph


def _scope_copy(fluid, scope):
    """A new scope holding a copy of every tensor of ``scope``."""
    out = fluid.Scope()
    for name in scope.local_var_names():
        val = scope.get(name)
        out.set(name, val.clone() if hasattr(val, "clone") else val)
    return out


def _sampled_eager_vs_graph(fluid, np, eng, feed):
    """``SAMPLED_STEPS`` all-slot steps of ``eng``'s step program on two
    fresh executors from copies of its scope: one cached (eager warm-up,
    capture, replays), one eager every call; the tokens and run modes of
    each, and the cached side's executor and scope."""
    sides = {}
    for label, cache in (("graph", True), ("eager", False)):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        scope = _scope_copy(fluid, eng.scope)
        toks, modes = [], []
        for i in range(SAMPLED_STEPS):
            out = exe.run(eng._step_prog,
                          feed=dict(feed, step=np.asarray([i + 1], "int32")),
                          fetch_list=[eng._step_fetch], scope=scope,
                          use_program_cache=cache)
            toks.append(np.asarray(out[0]).reshape(-1).tolist())
            modes.append(exe.last_run_mode)
        sides[label] = (toks, modes, exe, scope)
    return sides


KEPT_SET_ROWS, KEPT_SET_STEPS = 256, 32


def _sampled_kept_set(env, torch, vocab):
    """The sampling noise on the card (module docstring, 17): finite at
    the generator's extreme codes, and no top-p draw outside the kept
    set over ``KEPT_SET_ROWS`` x ``KEPT_SET_STEPS`` row-steps."""
    from paddle_tpu_torch.ops import decode as ops_decode
    from paddle_tpu_torch.ops import registry

    codes = torch.cat([torch.arange(1024), 0xFFFFFFFF - torch.arange(1024)])
    u = ops_decode._uniform(codes.to("cuda"))
    finite = bool(((u > 0) & (u < 1)).all()) and bool(
        torch.isfinite(-torch.log(-torch.log(u))).all())
    gen = torch.Generator(device="cpu").manual_seed(SEED + 17)
    logits = (torch.randn(KEPT_SET_ROWS, vocab, generator=gen) * 4.0).cuda()
    p = 0.9
    probs = torch.softmax(logits, -1)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    allowed = torch.zeros_like(logits, dtype=torch.bool).scatter_(
        -1, order, (torch.cumsum(srt, -1) - srt) < p)
    op = registry.get_op_def("top_p_sampling")
    rows = torch.arange(KEPT_SET_ROWS, device="cuda")
    outside = 0
    for step in range(KEPT_SET_STEPS):
        ctx = registry.LoweringContext(
            program_seed=SEED,
            step=torch.tensor([step], dtype=torch.int64, device="cuda"))
        ctx.set_op(1)
        got = op.fn(ctx, {"p": p, "temperature": 1.0, "seed": SEED},
                    X=logits, Step=torch.tensor([step], dtype=torch.int32,
                                                device="cuda"))
        outside += int((~allowed[rows, got.long()]).sum())
    emit({"phase": "sampled_kept_set", "card": card_label(env),
          "row_steps": KEPT_SET_ROWS * KEPT_SET_STEPS, "vocab": vocab,
          "outside_kept_set": outside, "extreme_codes_finite": finite,
          "kept_max": int(allowed.sum(-1).max())})
    if outside or not finite:
        raise AssertionError("sampling noise: %d draws outside the kept "
                             "set, extreme codes finite %s"
                             % (outside, finite))


def phase_sampled(env, greedy_rates):
    """Sampled decode drawn on the device (module docstring, 17)."""
    import warnings

    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.cuda import (launch_counts,
                                           reset_launch_counts)

    cfg = gpt.GPT2_SMALL_WIDTHS
    _sampled_kept_set(env, torch, cfg.vocab)
    rng = np.random.RandomState(SEED + 4)   # the decode phase's prompts
    lens = rng.randint(DECODE_PROMPT_LENS[0], DECODE_PROMPT_LENS[1] + 1,
                       DECODE_REQUESTS)
    prompts = [rng.randint(1, cfg.vocab - 1, size=n).astype("int32")
               for n in lens]
    for strategy, paged, kw in SAMPLED:
        mode = "paged" if paged else "ring"
        eng = serving.DecodeEngine(
            gpt.DecodeAdapter(cfg, seed=SEED), slots=DECODE_SLOTS,
            prompt_buckets=DECODE_BUCKETS,
            config=serving.GenerationConfig(
                strategy=strategy, max_new_tokens=DECODE_NEW_TOKENS,
                seed=SEED, **kw),
            place=fluid.CUDAPlace(0), name="sampled", paged=paged,
            auto_start=False)
        feed = _decode_step_feed(eng, np.random.RandomState(SEED + 11),
                                 cfg.vocab)
        sides = _sampled_eager_vs_graph(fluid, np, eng, feed)
        g_toks, g_modes, exe, scope = sides["graph"]
        e_toks, e_modes = sides["eager"][:2]
        same = g_toks == e_toks
        moves = len({tuple(t) for t in g_toks}) > 1
        in_vocab = all(0 <= t < cfg.vocab for row in g_toks for t in row)
        torch.cuda.synchronize()
        checked, handles = [], []
        torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(SERVE_SYNC_CALLS):
                handles += exe.run(
                    eng._step_prog, feed=dict(
                        feed, step=np.asarray([SAMPLED_STEPS + i + 1],
                                              "int32")),
                    fetch_list=[eng._step_fetch], scope=scope,
                    return_numpy=False)
                checked.append(exe.last_run_mode)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        fluid.pipeline.materialize(handles)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                handles = exe.run(
                    eng._step_prog, feed=dict(feed, step=np.asarray(
                        [100], "int32")),
                    fetch_list=[eng._step_fetch], scope=scope,
                    return_numpy=False)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        fluid.pipeline.materialize(handles)
        syncs = sum(1 for w in caught if "synchroniz" in str(w.message))
        del sides, exe, scope
        server = serving.PredictorServer({"gpt2": eng})
        try:
            warm = [server.submit("gpt2", p) for p in (
                rng.randint(1, cfg.vocab - 1, b // 2 + 1).astype("int32")
                for b in DECODE_BUCKETS for _ in range(2))]
            for f in warm:
                f.result(timeout=600)
            torch.cuda.synchronize()
            st0 = eng.stats()
            reset_launch_counts()
            t0 = time.time()
            futs = [server.submit("gpt2", p, request_id=i)
                    for i, p in enumerate(prompts)]
            outs = [f.result(timeout=900) for f in futs]
            torch.cuda.synchronize()
            wall_s = time.time() - t0
            total = launch_counts()
            st1 = eng.stats()
            step_mode = eng._exe.last_run_mode
        finally:
            server.close()
        steps = st1["decode_steps"] - st0["decode_steps"]
        prefills = st1["prefills"] - st0["prefills"]
        want = _decode_launches(cfg, paged, steps, prefills)
        n_tok = sum(len(t) for t, _ in outs)
        step_ms = (st1["step_ms_mean"] * st1["decode_steps"]
                   - st0["step_ms_mean"] * st0["decode_steps"]) / steps
        emit({"phase": "sampled", "strategy": strategy, "mode": mode,
              "attrs": kw, "card": card_label(env),
              "eager_equals_graph": same, "draws_move_with_step": moves,
              "graph_modes": g_modes, "eager_modes": e_modes,
              "sync_debug_error_modes": checked,
              "syncs_per_replayed_step": syncs,
              "requests": len(outs), "tokens": n_tok, "wall_s": wall_s,
              "tokens_per_s": n_tok / wall_s,
              "greedy_tokens_per_s": greedy_rates.get(mode),
              "step_ms_mean": step_ms, "decode_steps": steps,
              "prefills": prefills, "served_step_mode": step_mode,
              "launches": total, "expected_launches": want,
              "graphs_nodes_not_captured_launches": _graphs_off(eng._exe)})
        bad = [i for i, (t, _) in enumerate(outs)
               if len(t) != DECODE_NEW_TOKENS
               or not all(0 <= x < cfg.vocab for x in t)]
        if not (same and moves and in_vocab) or syncs \
                or g_modes[-1] != "graph" or e_modes != ["eager"] * len(
                    e_modes) or any(m != "graph" for m in checked) \
                or bad or total != want or _graphs_off(eng._exe) \
                or step_mode != "graph":
            raise AssertionError(
                "%s %s: eager = graph %s, draws move %s, syncs %d, modes "
                "%s / %s / %s, served step %s, bad requests %s, launches "
                "%s != %s" % (strategy, mode, same, moves, syncs, g_modes,
                              e_modes, checked, step_mode, bad, total,
                              want))
        eng.close()
        del eng
        torch.cuda.empty_cache()


VERIFY_STEPS = 3


def _findings(diags):
    """``{"check/SEVERITY": count}`` of a battery's diagnostics."""
    out = {}
    for d in diags:
        key = "%s/%s" % (d.check, d.severity.name)
        out[key] = out.get(key, 0) + 1
    return out


def _battery(verifier, rows, label, program, targets, **kw):
    """The whole battery over ``program``, its host ms and findings
    recorded in ``rows`` under ``label``."""
    t0 = time.perf_counter()
    diags = verifier.verify_program(program, targets=targets, **kw)
    rows[label] = {"host_ms": (time.perf_counter() - t0) * 1e3,
                   "ops": len(program.global_block().ops),
                   "findings": _findings(diags)}
    return diags


def _bracketed_resolve(fusion, rows, label, program, targets):
    """The program's fusion resolved under the verifier bracket; its
    host ms and rewrite counts in ``rows[label]``."""
    t0 = time.perf_counter()
    _fused, report = fusion.resolve_fused_program(program, targets=targets)
    rows[label]["bracketed_resolve_ms"] = (time.perf_counter() - t0) * 1e3
    rows[label]["fused"] = report.counts()


def _verify_train(fluid, bert, np, torch, verifier, fusion, rows):
    """BERT-base training steps with and without ``verify=True``: the
    losses and run modes of each."""
    cfg = bert.BERT_BASE
    batch = bert.make_fake_batch(TRAIN_BATCH, SEQ, cfg,
                                 np.random.RandomState(SEED))
    losses, modes = {}, {}
    for verify in (False, True):
        fluid.unique_name.switch()
        main, startup, loss = _train_program(fluid, bert, cfg, SEQ)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup, scope=scope)
        out, run_modes = [], []
        for _ in range(VERIFY_STEPS):
            out.append(np.asarray(exe.run(
                main, feed=batch, fetch_list=[loss], scope=scope,
                verify=verify)[0]).copy())
            run_modes.append(exe.last_run_mode)
        losses[verify], modes[verify] = out, run_modes
        if verify:
            _battery(verifier, rows, "bert_base_train", main, [loss.name])
        del exe, scope
        torch.cuda.empty_cache()
    fluid.unique_name.switch()
    main, startup, _feeds, loss = bert.build_pretrain(
        cfg, seq_len=SEQ, lr=TRAIN_LR, amp=True)
    main.random_seed = startup.random_seed = SEED
    _battery(verifier, rows, "bert_base_train_amp", main, [loss.name])
    _bracketed_resolve(fusion, rows, "bert_base_train_amp", main,
                       [loss.name])
    raised = None
    try:
        fluid.Executor(fluid.CUDAPlace(0)).run(
            main, feed=batch, fetch_list=[loss], scope=fluid.Scope(),
            verify=True)
    except verifier.VerifyError as e:
        raised = str(e)
    return losses, modes, raised


def _analyze_program_runs(fluid, bert, proto, export_dir):
    """``python -m paddle_tpu_torch.tools.analyze_program`` as two
    subprocesses at once, on the BERT-base serving export and on the
    BERT-base training program (``--program-json``, batch 8): exit code,
    host ms (the interpreter's start included, the two sharing the
    host), and the payload's cost."""
    train_json = os.path.join(HERE, ".smoke_tmp", "analyze_train.json")
    main, _startup, _loss = _train_program(fluid, bert, bert.BERT_BASE,
                                           SEQ)
    proto.save_program(main, train_json)
    bench = os.path.join(HERE, ".smoke_tmp", "analyze_bench.json")
    out, runs = {}, {}
    try:
        for label, args in (  # both at once: each is mostly host start-up
                ("bert_base_export", [export_dir, "--json"]),
                ("bert_base_train", ["--program-json", train_json,
                                     "--batch", str(TRAIN_BATCH), "--json",
                                     "--bench-json", bench])):
            runs[label] = (time.perf_counter(), subprocess.Popen(
                [sys.executable, "-m",
                 "paddle_tpu_torch.tools.analyze_program"] + args,
                cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for label, (t0, proc) in runs.items():
            stdout, stderr = proc.communicate(timeout=600)
            row = {"rc": proc.returncode,
                   "host_ms": (time.perf_counter() - t0) * 1e3,
                   "stderr_tail": stderr.strip().splitlines()[-2:]}
            if proc.returncode in (0, 1):
                payload = json.loads(stdout)
                cost = payload["cost"]
                row.update(ok=payload["ok"],
                           findings=len(payload["diagnostics"]),
                           total_flops=cost.get("total_flops"),
                           peak_memory_bytes=cost.get("peak_memory_bytes"))
            out[label] = row
        with open(bench) as f:
            out["bert_base_train"]["bench_metrics"] = len(f.readlines())
    finally:
        for _t0, proc in runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        for path in (train_json, bench):
            if os.path.exists(path):
                os.remove(path)
    return out


def phase_verify(env):
    """The static-analysis battery on the card's programs (module
    docstring, 18)."""
    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import proto
    from paddle_tpu_torch.executor import Scope, scope_guard
    from paddle_tpu_torch.models import bert, gpt, resnet
    from paddle_tpu_torch.static_analysis import fusion, verifier

    rows = {}
    prev = verifier.set_pass_verification(True)
    try:
        losses, modes, amp_raised = _verify_train(
            fluid, bert, np, torch, verifier, fusion, rows)
        same = all(np.array_equal(a, b)
                   for a, b in zip(losses[False], losses[True]))
        emit({"phase": "verify", "step": "train", "card": card_label(env),
              "losses_verify_false": [float(x.reshape(-1)[0])
                                      for x in losses[False]],
              "losses_bit_identical": same, "run_modes": modes[True],
              "run_modes_verify_false": modes[False],
              "amp_verify_raised": (amp_raised or "")[:300]})
        if not same or modes[True] != modes[False] \
                or modes[True][-1] != "graph" or amp_raised is None \
                or "shape-dtype-drift" not in amp_raised:
            raise AssertionError("verify=True: losses %s, modes %s / %s, "
                                 "AMP raised %r" % (same, modes[True],
                                                    modes[False],
                                                    amp_raised))
        main, _startup, test, loss, _acc = _resnet_program(
            fluid, resnet, RESNET_HW)
        for label, prog in (("resnet50_train", main),
                            ("resnet50_eval", test)):
            _battery(verifier, rows, label, prog, [loss.name])
            _bracketed_resolve(fusion, rows, label, prog, [loss.name])
        cfg = gpt.GPT2_SMALL_WIDTHS
        step_json = os.path.join(HERE, ".smoke_tmp", "verify_step.json")
        os.makedirs(os.path.dirname(step_json), exist_ok=True)
        for paged in (False, True):
            eng = _decode_engine(cfg, paged, fluid.CUDAPlace(0),
                                 name="verify")
            mode = "paged" if paged else "ring"
            if not paged:  # linted below: its caches draw INFO findings
                proto.save_program(eng._step_prog, step_json)
            for label, prog, fetch in (
                    [("gpt2_%s_step" % mode, eng._step_prog,
                      eng._step_fetch)]
                    + [("gpt2_%s_prefill%d" % (mode, n), p, f)
                       for n, (p, f) in sorted(eng._prefill.items())]):
                _battery(verifier, rows, label, prog, [fetch])
                _bracketed_resolve(fusion, rows, label, prog, [fetch])
            eng.close()
            del eng
        workers = [_dp_program(fluid, bert, bert.BERT_BASE, rank, False)
                   for rank in range(DP_RANKS)]
        for rank, (prog, _s, wloss) in enumerate(workers):
            label = "dp_rank%d" % rank
            _battery(verifier, rows, label, prog, [wloss.name],
                     workers=[w[0] for w in workers])
            _bracketed_resolve(fusion, rows, label, prog, [wloss.name])
        del workers
        torch.cuda.empty_cache()
        dangling = fluid.Program()
        block = dangling.global_block()
        block.create_var(name="y", shape=[2], dtype="float32")
        block.ops.append(fluid.framework.Operator(
            block, "scale", {"X": ["never_written"]}, {"Out": ["y"]}, {}))
        try:
            verifier.assert_valid(dangling, targets=["y"])
            dangling_raised = None
        except verifier.VerifyError as e:
            dangling_raised = str(e)
    finally:
        verifier.set_pass_verification(prev)

    export_dir = os.path.join(HERE, ".smoke_tmp", "verify_export")
    shutil.rmtree(export_dir, ignore_errors=True)
    env_prev = os.environ.get("PADDLE_TPU_VERIFY_PASSES")
    procs = {}
    try:
        main, startup, hidden = _bert_program(fluid, bert, bert.BERT_BASE)
        scope = Scope()
        with scope_guard(scope):
            exe = fluid.Executor(fluid.CUDAPlace(0))
            exe.run(startup)
            fluid.io.save_inference_model(
                export_dir, ["input_ids", "token_type_ids",
                             "attn_mask_bias", "pos_ids"],
                [hidden], exe, main_program=main)
        del scope, exe
        os.environ["PADDLE_TPU_VERIFY_PASSES"] = "1"
        t0 = time.perf_counter()
        pred = fluid.inference.create_paddle_predictor(
            fluid.inference.AnalysisConfig(model_dir=export_dir))
        load_ms = (time.perf_counter() - t0) * 1e3
        out = pred.run(_bert_request(np.random.RandomState(SEED), 2,
                                     bert.BERT_BASE))[0]
        served_ok = out.shape == (2, SEQ, bert.BERT_BASE.hidden) \
            and bool(np.isfinite(out).all())
        _battery(verifier, rows, "bert_base_serving", pred.program,
                 pred.get_output_names())
        del pred
        lint = {}
        # all four at once, beside analyze_program's two: each is mostly
        # an interpreter's start-up and import on the host
        for label, args in (
                ("default", [export_dir]),
                ("fail_on_info", [export_dir, "--json", "--fail-on",
                                  "INFO"]),
                ("ring_step", ["--program-json", step_json]),
                ("ring_step_fail_on_info", ["--program-json", step_json,
                                            "--json", "--fail-on", "INFO"])):
            procs[label] = (args, subprocess.Popen(
                [sys.executable, "-m", "paddle_tpu_torch.tools.lint_program"]
                + args, cwd=HERE,
                env=dict(os.environ, PYTHONPATH=HERE),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        analyze = _analyze_program_runs(fluid, bert, proto, export_dir)
        for label, (args, proc) in procs.items():
            stdout, _stderr = proc.communicate(timeout=600)
            lint[label] = {"rc": proc.returncode,
                           "stdout_tail": stdout.strip().splitlines()[-3:]}
            if "--json" in args and proc.returncode in (0, 1):
                lint[label]["findings"] = len(
                    json.loads(stdout)["diagnostics"])
    finally:
        for _args, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        if env_prev is None:
            os.environ.pop("PADDLE_TPU_VERIFY_PASSES", None)
        else:
            os.environ["PADDLE_TPU_VERIFY_PASSES"] = env_prev
        shutil.rmtree(export_dir, ignore_errors=True)
        if os.path.exists(step_json):
            os.remove(step_json)
    emit({"phase": "verify", "step": "battery", "card": card_label(env),
          "programs": rows, "serving_load_ms_verify_passes": load_ms,
          "serving_output_ok": served_ok,
          "dangling_read_raised": (dangling_raised or "")[:300],
          "lint_program": lint, "analyze_program": analyze})
    lint_ok = all(lint[k]["rc"] == 0 for k in ("default", "ring_step")) \
        and all(lint[k].get("rc") == (1 if lint[k].get("findings") else 0)
                for k in ("fail_on_info", "ring_step_fail_on_info")) \
        and lint["ring_step_fail_on_info"].get("findings") \
        and all(r["rc"] == 0 and r["ok"] for r in analyze.values())
    errors = {k: v for k, v in rows.items()
              if k != "bert_base_train_amp"
              and any(f.endswith("/ERROR") for f in v["findings"])}
    if errors or not served_ok or dangling_raised is None \
            or "use-before-def" not in dangling_raised or not lint_ok:
        raise AssertionError("verify: ERROR findings %s, served %s, "
                             "dangling read %r, lint %s"
                             % (errors, served_ok, dangling_raised, lint))
    torch.cuda.empty_cache()



# ---------------------------------------------------------------------------
# the measure-and-learn loop: drift, profiler, fusion rewrites, autotune
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _env_var(name, value):
    """``os.environ[name] = value`` for the block (None unsets it)."""
    prev = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


def _drift_report(env, phase, exe, replay_ms=None, min_calls=3):
    """The drift monitor's state of each entry of ``exe`` called at least
    ``min_calls`` times: the cost model's predicted step ms (the port's
    H100 defaults), the measured EMA (over every call of the key, its
    eager warm-up and capture included, as the reference's), each drift
    ratio, and the host ms of the registration that key's first call
    paid (``price_program`` and the collective schedule, timed again on
    a fresh monitor); with ``replay_ms``, the phase's median replayed
    step, over the busiest entry's prediction."""
    import math

    from paddle_tpu_torch.observability import drift
    from paddle_tpu_torch.static_analysis.distributed import \
        extract_collective_schedule

    rows = []
    for entry in exe._cache.values():
        if entry.calls < min_calls:
            continue
        batch = None
        if entry.feeds:
            batch = int(next(iter(entry.feeds.values())).shape[0])
        t0 = time.perf_counter()
        drift.DriftMonitor().register_program(
            entry.program, batch_size=batch, targets=entry.fetch_names)
        extract_collective_schedule(entry.program, batch_size=batch)
        reg_ms = (time.perf_counter() - t0) * 1e3
        st = drift.monitor().get(entry.drift_key) \
            if entry.drift_key is not None else None
        rows.append({
            "key": entry.drift_key, "calls": entry.calls,
            "ops": len(entry.block.ops),
            "predicted_step_ms": st.predicted_step_ms if st else None,
            "measured_ms_ema": st.measured_ms_ema if st else None,
            "measured_steps": st.measured_steps if st else None,
            "drift_ratio": st.ratios() if st else None,
            "registration_host_ms": reg_ms})
    if replay_ms is not None and rows:
        top = max(rows, key=lambda r: r["calls"])
        top["replay_ms"] = replay_ms
        if top["predicted_step_ms"]:
            top["replay_over_predicted"] = \
                replay_ms / top["predicted_step_ms"]
    emit({"phase": phase, "step": "drift", "card": card_label(env),
          "programs": rows})
    bad = [r for r in rows if not r["drift_ratio"] or not all(
        math.isfinite(v) and v > 0 for v in r["drift_ratio"].values())]
    if not rows or bad:
        raise AssertionError("%s: drift ratios missing or not finite: %s"
                             % (phase, bad or rows))
    return rows


PROFILER_TRACE = os.path.join(HERE, ".smoke_tmp", "profile_bert_b8.json")


def phase_profiler(env, pred, cfg):
    """One bucket-8 BERT-base batch served through ``PredictorServer``
    under ``paddle_tpu_torch.profiler`` (device trace on): the merged
    chrome trace must hold the serving spans and the K1, K2 and K3
    kernels' device rows; the top rows of ``device_op_stats``."""
    import numpy as np

    from paddle_tpu_torch import profiler, serving

    feed = _bert_request(np.random.RandomState(SEED + 9), BUCKETS[-1], cfg)
    server = serving.PredictorServer({"bert": pred}, buckets=BUCKETS,
                                     auto_start=False)
    try:
        pred.run(feed)  # the batch's key is warm: the trace is a replay
        os.makedirs(os.path.dirname(PROFILER_TRACE), exist_ok=True)
        profiler.start_profiler(state="All")
        try:
            fut = server.submit("bert", feed)
            server.start()
            out = fut.result(timeout=600)
        finally:
            profiler.stop_profiler(sorted_key="total",
                                   profile_path=PROFILER_TRACE)
    finally:
        server.close()
    with open(PROFILER_TRACE) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted({ev["name"] for ev in events
                    if str(ev.get("pid", "")).startswith("rank")
                    and ev.get("ph") == "X"})
    device = [ev["name"] for ev in events
              if ev.get("pid") == 1 and ev.get("ph") == "X"]
    seen = {k: sum(1 for n in device if needle in n) for k, needle in (
        ("K1 fwd", "flash_fwd_kernel"), ("K2 fwd", "add_ln_fwd_kernel"),
        ("K3", "::gather_kernel<"))}
    stats = sorted(profiler.device_op_stats().items(),
                   key=lambda kv: -kv[1][1])
    emit({"phase": "profiler", "card": card_label(env),
          "trace_events": len(events), "span_names": spans,
          "device_rows": len(device), "kernel_rows": seen,
          "flows": sum(1 for ev in events
                       if ev.get("cat") == "span-device"),
          "host_events": profiler.host_event_stats(),
          "top_device_op_stats": [
              {"name": n, "calls": c, "total_ms": t, "max_ms": mx}
              for n, (c, t, mx, _mn) in stats[:12]]})
    # a profile can lose records at its edges (the graph phase's markers):
    # each kernel must show, its count is printed
    if not np.isfinite(out[0]).all() \
            or not {"serving.request", "serving.batch"} <= set(spans) \
            or not all(seen.values()):
        raise AssertionError("profiler: spans %s, kernel rows %s"
                             % (spans, seen))


FUSION_STEPS = 3
K1_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dkv",
              "flash_attention_bwd_dq")
FUSION_LOSS_RTOL = 1e-5
XENT_BATCH = 256
XENT_FEATURES = 2048
XENT_CLASSES = 1000
XENT_RTOL = 1e-5
DRIFT_FORCED_WRITES = 3


def _bert_cfg(bert, fuse_attn, dropout=None):
    import copy

    cfg = copy.copy(bert.BERT_BASE)
    cfg.fuse_attn = fuse_attn
    if dropout is not None:
        cfg.dropout = cfg.attn_dropout = dropout
    return cfg


def _fusion_side(env, fluid, bert, fusion, label, fuse_attn, min_t, batch,
                 forced_writes=0):
    """BERT-base pretraining at T=512 built with ``fuse_attn``, resolved
    and run with ``PADDLE_TPU_FLASH_MIN_T=min_t`` (None: the default
    resolution): op counts of the resolved program, K1 launches a timed
    step, step ms, device ms; with ``forced_writes`` that many
    calibration writes, each followed by calls of the step, and the
    graphs and memory held after each."""
    import statistics

    import torch

    from paddle_tpu_torch.observability import drift
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    main, startup, loss = _train_program(fluid, bert, _bert_cfg(
        bert, fuse_attn), SEQ)
    out = {"label": label}
    with _env_var("PADDLE_TPU_FLASH_MIN_T", min_t):
        prog, report = fusion.resolve_fused_program(main,
                                                    targets=[loss.name])
        types = _op_type_counts(prog)
        out["fused"] = report.counts()
        out["ops"] = {t: types.get(t, 0) for t in (
            "fused_multihead_attention", "fused_multihead_attention_grad",
            "softmax", "matmul", "dropout")}
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = fluid.Executor(fluid.CUDAPlace(0))
            exe.run(startup)
            for _ in range(TRAIN_WARMUP):
                exe.run(main, feed=batch, fetch_list=[loss])
            torch.cuda.synchronize()
            reset_launch_counts()
            step_ms = []
            for _ in range(FUSION_STEPS):
                s0 = time.perf_counter()
                exe.run(main, feed=batch, fetch_list=[loss])
                step_ms.append((time.perf_counter() - s0) * 1e3)
            counts = launch_counts()
            out["k1_launches_per_step"] = {k: counts[k] / FUSION_STEPS
                                           for k in K1_KERNELS}
            out["run_mode"] = exe.last_run_mode
            out["median_step_ms"] = statistics.median(step_ms)
            prof = _step_profile(exe, main, batch, [loss], runs=1, top_n=8)
            out["device_ms_per_step"] = prof["device_ms_per_step"]
            out["device_ms_by_group"] = prof["device_ms_by_group"]
            if forced_writes:
                held = []
                entry = max(exe._cache.values(), key=lambda e: e.calls)
                for _ in range(forced_writes):
                    st = drift.monitor().get(entry.drift_key)
                    wrote = drift.monitor().record_calibration(st)
                    for _ in range(3):  # warm-up, capture, replay
                        exe.run(main, feed=batch, fetch_list=[loss])
                    torch.cuda.synchronize()
                    held.append({"wrote": wrote,
                                 "graph_count": exe.graph_count,
                                 "cache_entries": len(exe._cache),
                                 "run_mode": exe.last_run_mode,
                                 "memory_reserved_bytes":
                                     torch.cuda.memory_reserved()})
                    entry = max(exe._cache.values(), key=lambda e: e.calls)
                out["forced_writes"] = held
        del scope, exe
        torch.cuda.empty_cache()
    emit(dict({"phase": "fusion", "step": "bert", "card": card_label(env)},
              **out))
    return out


def _bert_loss_parity(fluid, bert, batch):
    """3 steps (eager, capture, replay) of BERT-base built with
    ``fuse_attn=True`` and with ``fuse_attn=False`` (rewritten), dropout
    0 (the two programs' op ids differ, and so would their dropout
    masks), from one start → their losses."""
    import torch

    losses, start = {}, None
    for fuse_attn in (True, False):
        main, startup, loss = _train_program(fluid, bert, _bert_cfg(
            bert, fuse_attn, dropout=0.0), SEQ)
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = fluid.Executor(fluid.CUDAPlace(0))
            exe.run(startup)
            names = [p.name for p in main.all_parameters()]
            if start is None:
                start = {n: scope.get(n).clone() for n in names}
            else:
                for n in names:
                    scope.get(n).copy_(start[n])
            losses[fuse_attn] = [
                float(exe.run(main, feed=batch, fetch_list=[loss])[0][0])
                for _ in range(FUSION_STEPS)]
        del scope, exe
        torch.cuda.empty_cache()
    return losses


def _xent_head(fluid, np, torch):
    """The ImageNet classifier head (fc 2048 → 1000, softmax,
    ``cross_entropy``, batch 256) and one Momentum step, rewritten and
    left unfused (``PADDLE_TPU_FUSION=0``), from one start: the
    rewritten ops, and the loss and gradients' relative differences."""
    from paddle_tpu_torch.static_analysis import fusion

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup):
        feat = fluid.layers.data("feat", shape=[XENT_FEATURES],
                                 dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        p = fluid.layers.softmax(fluid.layers.fc(feat, size=XENT_CLASSES))
        loss = fluid.layers.mean(fluid.layers.cross_entropy(p, label))
        fluid.optimizer.Momentum(learning_rate=0.1,
                                 momentum=0.9).minimize(loss)
    grads = [op.inputs["Grad"][0] for op in main.global_block().ops
             if op.type == "momentum"]
    prog, report = fusion.resolve_fused_program(main, targets=[loss.name])
    types = _op_type_counts(prog)
    rng = np.random.RandomState(SEED + 11)
    feed = {"feat": rng.randn(XENT_BATCH, XENT_FEATURES).astype("float32"),
            "label": rng.randint(0, XENT_CLASSES,
                                 (XENT_BATCH, 1)).astype("int64")}
    outs, start = {}, None
    for fused in (True, False):
        with _env_var("PADDLE_TPU_FUSION", None if fused else "0"):
            scope = fluid.Scope()
            with fluid.scope_guard(scope):
                exe = fluid.Executor(fluid.CUDAPlace(0))
                exe.run(startup)
                names = [v.name for v in main.all_parameters()]
                if start is None:
                    start = {n: scope.get(n).clone() for n in names}
                else:
                    for n in names:
                        scope.get(n).copy_(start[n])
                outs[fused] = exe.run(main, feed=feed,
                                      fetch_list=[loss] + grads)
    rel = [float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
           for a, b in zip(outs[True], outs[False])]
    return {"fused": report.counts(),
            "ops": {t: types.get(t, 0) for t in (
                "softmax_with_cross_entropy",
                "softmax_with_cross_entropy_grad", "softmax",
                "cross_entropy")},
            "loss": float(outs[True][0].reshape(-1)[0]),
            "loss_rel_diff": rel[0], "grad_rel_diffs": rel[1:]}


def phase_fusion(env):
    """The attention and softmax_xent rewrites on the card (module
    docstring, 19), and the executor's held graphs under drift writes."""
    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.static_analysis import fusion

    batch = bert.make_fake_batch(TRAIN_BATCH, SEQ, bert.BERT_BASE,
                                 np.random.RandomState(SEED))
    fused = _fusion_side(env, fluid, bert, fusion, "fuse_attn=True", True,
                         None, batch, forced_writes=DRIFT_FORCED_WRITES)
    rewritten = _fusion_side(env, fluid, bert, fusion,
                             "fuse_attn=False rewritten", False, None, batch)
    unfused = _fusion_side(env, fluid, bert, fusion,
                           "fuse_attn=False, PADDLE_TPU_FLASH_MIN_T=4096",
                           False, "4096", batch)
    losses = _bert_loss_parity(fluid, bert, batch)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses[False],
                                                  losses[True]))
    emit({"phase": "fusion", "step": "bert losses, dropout 0",
          "fuse_attn_true": losses[True],
          "fuse_attn_false_rewritten": losses[False],
          "max_rel_diff": rel, "tol": FUSION_LOSS_RTOL})
    held = fused["forced_writes"]
    emit({"phase": "drift", "step": "forced writes",
          "card": card_label(env), "writes": held})
    xent = _xent_head(fluid, np, torch)
    emit(dict({"phase": "fusion", "step": "softmax_xent",
               "card": card_label(env), "tol": XENT_RTOL}, **xent))
    want_k1 = dict.fromkeys(K1_KERNELS, 12.0)
    bad = []
    if rewritten["ops"]["fused_multihead_attention"] != 12 \
            or rewritten["ops"]["fused_multihead_attention_grad"] != 12 \
            or rewritten["ops"]["softmax"] \
            or rewritten["fused"].get("attention") != 12:
        bad.append("rewritten ops %s" % rewritten["ops"])
    if unfused["ops"]["fused_multihead_attention"] \
            or unfused["ops"]["softmax"] != 12:
        bad.append("unfused ops %s" % unfused["ops"])
    if fused["k1_launches_per_step"] != want_k1 \
            or rewritten["k1_launches_per_step"] != want_k1 \
            or any(unfused["k1_launches_per_step"].values()):
        bad.append("K1 launches %s / %s / %s" % tuple(
            s["k1_launches_per_step"] for s in (fused, rewritten, unfused)))
    if any(s["run_mode"] != "graph" for s in (fused, rewritten, unfused)):
        bad.append("run modes not graph")
    if not rel <= FUSION_LOSS_RTOL:
        bad.append("losses differ by %g" % rel)
    if any(not h["wrote"] or h["graph_count"] != 1
           or h["run_mode"] != "graph" for h in held):
        bad.append("held graphs after forced writes %s" % held)
    if xent["ops"]["softmax_with_cross_entropy"] != 1 \
            or xent["ops"]["softmax"] or xent["ops"]["cross_entropy"] \
            or not max([xent["loss_rel_diff"]] + xent["grad_rel_diffs"]) \
            <= XENT_RTOL:
        bad.append("softmax_xent %s" % xent)
    if bad:
        raise AssertionError("fusion: %s" % "; ".join(bad))


def decode_host_ab(loads=2):
    """The decode tenant's host time, for ``chip_ab.py`` (parent against
    change; only APIs both have): per cache mode, ``loads`` loads of the
    decode phase's 16 requests through ``PredictorServer`` (tokens/s and
    step ms), the host µs of a step enqueue with telemetry on and off
    (``_enqueue_us``), and of one fusion signature, which every executor
    call computes."""
    import timeit

    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.observability as obs
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.static_analysis import fusion

    cfg = gpt.GPT2_SMALL_WIDTHS
    rng = np.random.RandomState(SEED + 4)
    lens = rng.randint(DECODE_PROMPT_LENS[0], DECODE_PROMPT_LENS[1] + 1,
                       DECODE_REQUESTS)
    prompts = [rng.randint(1, cfg.vocab - 1, size=n).astype("int32")
               for n in lens]
    for paged in (False, True):
        eng = _decode_engine(cfg, paged, fluid.CUDAPlace(0))
        server = serving.PredictorServer({"gpt2": eng})
        rates = []
        try:
            warm = [server.submit("gpt2", p) for p in (
                rng.randint(1, cfg.vocab - 1, b // 2 + 1).astype("int32")
                for b in DECODE_BUCKETS for _ in range(2))]
            for f in warm:
                f.result(timeout=600)
            for _ in range(loads):
                st0 = eng.stats()
                t0 = time.time()
                outs = [f.result(timeout=900) for f in
                        [server.submit("gpt2", p) for p in prompts]]
                wall = time.time() - t0
                st1 = eng.stats()
                steps = st1["decode_steps"] - st0["decode_steps"]
                rates.append({
                    "tokens_per_s": sum(len(t) for t, _ in outs) / wall,
                    "step_ms_mean": (
                        st1["step_ms_mean"] * st1["decode_steps"]
                        - st0["step_ms_mean"] * st0["decode_steps"])
                    / steps})
        finally:
            server.close()
        feed = _decode_step_feed(eng, rng, cfg.vocab)

        def step_enqueue():
            with eng._exe_lock:
                return eng._exe.run(eng._step_prog, feed=feed,
                                    fetch_list=[eng._step_fetch],
                                    scope=eng.scope, return_numpy=False)

        for _ in range(3):
            step_enqueue()
        enqueue = _enqueue_us(torch, obs, lambda: _in_span(
            obs, "serving.decode_step", step_enqueue))
        n = 2000
        sig_us = timeit.timeit(
            lambda: fusion.FusionConfig().signature(eng._step_prog),
            number=n) / n * 1e6
        emit({"phase": "decode_host_ab", "paged": paged, "loads": rates,
              "step_enqueue_us": enqueue, "fusion_signature_us": sig_us,
              "package": fluid.__file__})
        eng.close()
        del eng
        torch.cuda.empty_cache()


AUTOTUNE_TS = (128, 256, 512, 1024, 2048)
AUTOTUNE_HEADS = (TRAIN_BATCH, 12, 64)   # BERT-base: batch, heads, dim
AUTOTUNE_RATE = 0.1


def _attention_pair(torch, registry, t, dtype, gen):
    """Forward + backward of attention over BERT-base heads at length
    ``t``, dropout 0.1 (upscale_in_train) and a [B,1,1,T] mask bias, as
    two callables: the port's ``fused_multihead_attention`` op (K1) and
    its unfused chain (``matmul`` with α, ``elementwise_add``,
    ``softmax``, ``dropout``, ``matmul``), each through the op lowerings
    the executor runs, differentiated by autograd as its grad ops do."""
    b, h, dh = AUTOTUNE_HEADS
    dev = torch.device("cuda")

    def leaf():
        return torch.randn(b, h, t, dh, generator=gen, device=dev).to(
            dtype).requires_grad_()

    q, k, v = leaf(), leaf(), leaf()
    bias = torch.zeros(b, 1, 1, t, device=dev)
    bias[..., t - t // 8:] = -1e4  # a padded tail, as BERT's batches
    g = torch.randn(b, h, t, dh, generator=gen, device=dev).to(dtype)
    step = torch.full((1,), DROP_STEP, dtype=torch.int64, device=dev)
    ctx = registry.LoweringContext(mode="train", device=dev,
                                   program_seed=SEED, step=step)
    scale = 1.0 / dh ** 0.5

    def op(name, op_id, ins, attrs, slot="Out"):
        return registry.call_op(registry.get_op_def(name), ctx, ins, attrs,
                                op_id=op_id)[slot][0]

    def fused():
        out = op("fused_multihead_attention", 1,
                 {"Q": [q], "K": [k], "V": [v], "BiasQK": [bias]},
                 {"scale": scale, "dropout_rate": AUTOTUNE_RATE})
        return torch.autograd.grad(out, (q, k, v), g)

    def unfused():
        s = op("matmul", 2, {"X": [q], "Y": [k]},
               {"transpose_Y": True, "alpha": scale})
        s = op("elementwise_add", 3, {"X": [s], "Y": [bias.to(dtype)]},
               {"axis": -1})
        p = op("softmax", 4, {"X": [s]}, {"axis": -1})
        p = op("dropout", 5, {"X": [p]},
               {"dropout_prob": AUTOTUNE_RATE,
                "dropout_implementation": "upscale_in_train"})
        out = op("matmul", 6, {"X": [p], "Y": [v]}, {})
        return torch.autograd.grad(out, (q, k, v), g)

    return fused, unfused


def phase_autotune(env):
    """The H100's own flash engagement threshold (module docstring, 20):
    K1 forward + backward against the port's unfused chain over BERT-base
    heads, T 128 to 2048, dropout 0.1, each side's replays timed by CUDA
    events from a captured graph; ``decide_threshold`` on the float32
    rows, recorded into the run's autotune cache, then read back by
    ``flash_min_t()``, and the env var still overriding it."""
    import torch

    from paddle_tpu_torch import autotune
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.ops.cuda.flash_attention import flash_min_t

    gen = _gen(torch)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        table = {}
        for t in AUTOTUNE_TS:
            fused, unfused = _attention_pair(torch, registry, t, dtype, gen)
            with torch.enable_grad():
                table[t] = (time_ms(fused, iters=10, graph=True),
                            time_ms(unfused, iters=10, graph=True))
            del fused, unfused
            torch.cuda.empty_cache()
            emit({"phase": "autotune", "dtype": _dname(dtype), "T": t,
                  "heads": list(AUTOTUNE_HEADS), "dropout": AUTOTUNE_RATE,
                  "fused_ms": table[t][0], "unfused_ms": table[t][1],
                  "fused_wins": table[t][0] < table[t][1],
                  "card": card_label(env)})
        rows[_dname(dtype)] = table
    decision = autotune.decide_threshold(rows["float32"])
    before = flash_min_t()
    if decision is not None:
        autotune.record_flash_min_t(decision, rows=rows["float32"])
    after = flash_min_t()
    with _env_var("PADDLE_TPU_FLASH_MIN_T", "4096"):
        overridden = flash_min_t()
    emit({"phase": "autotune", "step": "decision", "card": card_label(env),
          "backend": autotune.backend(), "cache": autotune.cache_path(),
          "flash_min_t_decision_float32": decision,
          "bfloat16_decision_not_recorded": autotune.decide_threshold(
              rows["bfloat16"]),
          "flash_min_t_before": before, "flash_min_t_after": after,
          "flash_min_t_with_env_4096": overridden,
          "cached_entry": autotune.lookup(
              autotune.sweep_signature("flash_min_t", {}))})
    want_after = decision if decision is not None else 512
    if before != 512 or after != want_after or overridden != 4096:
        raise AssertionError("flash_min_t: %s before, %s after the "
                             "decision %s, %s under the env var"
                             % (before, after, decision, overridden))


# ---------------------------------------------------------------------------
# The rest of BERT training: the flagship recipe and recompute regions
# ---------------------------------------------------------------------------

RECIPE_TIMED_STEPS = 5
RECIPE_GRAPH_STEPS = 12   # eager = graph over the schedule's first steps
RECIPE_PARITY_BATCH = 4
RECOMPUTE_STEPS = 3       # the bit-for-bit steps of each side
RECOMPUTE_TIMED = 5       # graph replays timed after them
RECOMPUTE_GRADS = ("bert.word_emb", "bert.layer0.attn.q.w",
                   "bert.layer11.ln2.scale")


def _recipe_cfg(bert, layers=None):
    """BERT-base with the flagship's ``fused_ln`` and ``fused_qkv``
    (dropout 0.1, attention dropout 0.1)."""
    import copy

    cfg = copy.copy(bert.BERT_BASE)
    cfg.fused_ln = True
    cfg.fused_qkv = True
    if layers is not None:
        cfg.layers = layers
    return cfg


def _recipe_side(fluid, main, startup, fetch, batch, cache, steps):
    """``steps`` steps of a training program from a fresh scope, cached
    (a capture, then replays) or not (eager) → (each step's fetches,
    run modes, copy-backs, digest of every persistable after them)."""
    import numpy as np
    import torch

    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup)
        rows, modes = [], []
        for _ in range(steps):
            rows.append([np.asarray(v).copy() for v in exe.run(
                main, feed=batch, fetch_list=fetch,
                use_program_cache=cache)])
            modes.append(exe.last_run_mode)
        copies = _copy_backs(exe)
        digest = _digest(scope, _persistable_names(main))
    del scope, exe
    torch.cuda.empty_cache()
    return rows, modes, copies, digest


def time_plain_updates(torch, gen, ops_per_step):
    """The LAMB and LARS updates, plain PyTorch ops on the card (the
    reference's XLA fusions; no hand-written kernel yet), at BERT-base's
    word embedding [30522, 768] f32: device ms of one op (cold L2), its
    bound (each input read once, each output written once), the CUDA
    kernels one op launches (the nodes of a graph captured around it)
    and the ops a step of its path runs."""
    from paddle_tpu_torch.ops import optimizer_ops as ops
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.ops.cuda import _lib

    x = _update_inputs(torch, gen, (30522, 768), torch.float32)
    n = x["p"].numel()
    ctx = registry.LoweringContext(device=torch.device("cuda"))
    cases = {
        "lamb": (lambda: ops.lamb(ctx, {"weight_decay": 0.01}, x["p"],
                                  x["g"], x["lr"], x["m1"], x["m2"],
                                  x["b1p"], x["b2p"]),
                 28 * n, 22 * n,
                 "paddle_tpu/ops/optimizer_ops.py:228 (lamb; XLA)"),
        "lars_momentum": (lambda: ops.lars_momentum(
            ctx, {"mu": 0.9}, x["p"], x["g"], x["v"], x["lr"]),
            20 * n, 12 * n,
            "paddle_tpu/ops/optimizer_ops.py:202 (lars_momentum; XLA)"),
    }
    rows = []
    for name, (call, nbytes, flops, replaces) in cases.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            call()
        graph.instantiate()
        kernels = len(_lib.graph_kernel_functions(graph))
        bound, by = bound_ms(nbytes, flops, "float32")
        rows.append({"name": name, "route": "plain PyTorch",
                     "source": "paddle_tpu_torch/ops/optimizer_ops.py",
                     "replaces": replaces,
                     "shape": "[30522,768] f32 (BERT-base word embedding)",
                     "ms": time_ms(call, 20),
                     "ms_graph": time_ms(graph.replay, 20),
                     "bound_ms": bound, "bound_by": by,
                     "library_ms": None,
                     "cuda_kernels_per_op": kernels,
                     "ops_per_step": ops_per_step.get(name, 0)})
        del graph
    return rows


def _f32_loss_parts(main, loss):
    """The float32 sums whose quotient is the recipe's loss: the AMP
    rewrite makes the quotient itself bf16 (its ``elementwise_div`` is
    white-listed, in both packages), a resolution of 1/32 at a loss of 6
    to 10, so the step-to-step change shows only in the sums."""
    block = main.global_block()
    div = next(op for op in block.ops if loss.name in op.output("Out"))
    parts = []
    for slot in ("X", "Y"):
        name = div.input(slot)[0]
        cast = next((op for op in block.ops if op.type == "cast"
                     and name in op.output("Out")), None)
        parts.append(cast.input("X")[0] if cast is not None else name)
    return parts


def phase_train_recipe(env):
    """The reference's flagship training layout (``bench.py:2741-2770``)
    trained as its users train it (``recipe_program``): BERT-base, T=128,
    batch 64, ``fused_ln`` and ``fused_qkv``, bf16 AMP, LAMB with weight
    decay, the warm-up and decay schedule, the global-norm clip, on the
    card's own flash threshold (recorded by ``phase_autotune``, which
    runs first): warm-up steps, then timed graph replays with the launches
    read from the replayed graphs' kernel nodes (K1 fwd and bwd, K2 fwd
    and bwd in bf16, K3), the learning rate of every step, peak allocated
    and reserved memory, device time by group; eager = graph over
    RECIPE_GRAPH_STEPS steps from one start, bit for bit, the schedule
    warming up then decaying, and whether the loss fell over the warm-up
    (read from its float32 sums: the loss itself is bf16); the LAMB and
    LARS updates' rows."""
    import statistics

    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops.cuda import (KERNELS, launch_counts,
                                           launch_counts_by_source,
                                           reset_launch_counts)
    from paddle_tpu_torch.ops.cuda.flash_attention import flash_min_t
    from paddle_tpu_torch.static_analysis import fusion

    threshold = flash_min_t()
    if threshold > RECIPE_SEQ:
        raise AssertionError("train_recipe: the card's flash threshold is "
                             "%d, above T=%d: K1 would not run"
                             % (threshold, RECIPE_SEQ))
    cfg = _recipe_cfg(bert)
    t0 = time.time()
    with fluid.unique_name.guard():
        main, startup, loss, lr = recipe_program(fluid, bert, cfg,
                                                 RECIPE_SEQ)
    fetch = [loss.name, lr.name] + _f32_loss_parts(main, loss)
    batch = bert.make_fake_batch(RECIPE_BATCH, RECIPE_SEQ, cfg,
                                 np.random.RandomState(SEED))
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup)
        prog, report = fusion.resolve_fused_program(
            main, targets=[loss.name, lr.name])
        op_types = _op_type_counts(prog)
        n_params = len(main.all_parameters())
        emit({"phase": "train_recipe", "step": "build+startup",
              "seconds": time.time() - t0, "flash_min_t": threshold,
              "fused": report.counts(), "op_types": op_types,
              "parameters": n_params})
        if op_types.get("lamb") != n_params \
                or op_types.get("squared_l2_norm") != n_params \
                or op_types.get("slice") != 3 * cfg.layers \
                or op_types.get("fused_multihead_attention") != cfg.layers:
            raise AssertionError("train_recipe: not the flagship program: "
                                 "%s" % op_types)
        want = _train_launches(prog)
        want_dtype = {
            "flash_attention_fwd:bfloat16": 12,
            "flash_attention_bwd_dkv:bfloat16": 12,
            "flash_attention_bwd_dq:bfloat16": 12,
            "fused_dropout_add_ln_fwd:bfloat16": 25,
            "fused_dropout_add_ln_bwd:bfloat16": 25,
            "embedding_gather_fwd:words": 3,
            "embedding_gather_bwd:float32": 3}
        losses, lrs, f32_losses = [], [], []

        def step():
            out = [float(np.asarray(v).reshape(-1)[0])
                   for v in exe.run(main, feed=batch, fetch_list=fetch)]
            losses.append(out[0])
            lrs.append(out[1])
            f32_losses.append(out[2] / out[3])

        for _ in range(TRAIN_WARMUP):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        step_ms = []
        for _ in range(RECIPE_TIMED_STEPS):
            s0 = time.perf_counter()
            step()
            step_ms.append((time.perf_counter() - s0) * 1e3)
        counts = launch_counts_by_source()
        per_step = {k: c / RECIPE_TIMED_STEPS
                    for k, c in launch_counts().items()}
        full = dict.fromkeys(KERNELS, 0.0)
        full.update(want)
        by_dtype = _dtype_nodes(exe)
        med = statistics.median(step_ms)
        off = _graphs_off(exe)
        copies = _copy_backs(exe)
        emit({"phase": "train_recipe", "step": "steps",
              "card": card_label(env), "losses": losses,
              "losses_from_f32_sums": f32_losses, "lr": lrs,
              "step_ms": step_ms, "median_step_ms": med,
              "tokens_per_s": RECIPE_BATCH * RECIPE_SEQ / (med / 1e3),
              "launches_per_step": per_step, "launches_by_source": counts,
              "expected": full, "graph_nodes_by_kernel_and_dtype": by_dtype,
              "expected_by_dtype": want_dtype,
              "cast_nodes_per_graph": _cast_nodes(exe),
              "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
              "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
              "last_run_mode": exe.last_run_mode,
              "copy_backs_per_step": copies,
              "graphs_nodes_not_captured_launches": off})
        failed = []
        if copies != [0]:
            failed.append("state copied back a step: %s" % copies)
        if per_step != full or any(counts["wrapper"].values()) or off:
            failed.append("launches per step %s != %s (by source %s, "
                          "graphs %s)" % (per_step, full, counts, off))
        if by_dtype != want_dtype:
            failed.append("graph nodes by dtype %s != %s"
                          % (by_dtype, want_dtype))
        if exe.last_run_mode != "graph":
            failed.append("the timed steps ran %r" % exe.last_run_mode)
        if not all(np.isfinite(losses)):
            failed.append("loss not finite: %s" % losses)
        if failed:
            raise AssertionError("train_recipe: %s" % "; ".join(failed))
        prof = _step_profile(exe, main, batch, fetch,
                             _with_casts(_kernel_group))
        emit(dict({"phase": "train_recipe", "step": "profile",
                   "card": card_label(env)}, **prof))
        ops_per_step = {"lamb": op_types.get("lamb", 0)}
    del scope, exe
    torch.cuda.empty_cache()
    sides = [_recipe_side(fluid, main, startup, fetch, batch, cache,
                          RECIPE_GRAPH_STEPS) for cache in (False, True)]
    same = sides[0][3] == sides[1][3] and all(
        np.array_equal(a, b) for ra, rb in zip(sides[0][0], sides[1][0])
        for a, b in zip(ra, rb))
    side_losses = [[float(r[0].reshape(-1)[0]) for r in s[0]] for s in sides]
    side_lrs = [[float(r[1].reshape(-1)[0]) for r in s[0]] for s in sides]
    f32 = [float(r[2].reshape(-1)[0] / r[3].reshape(-1)[0])
           for r in sides[1][0]]
    lr_peak = side_lrs[1].index(max(side_lrs[1]))
    # reported, not gated: at warm-up rates of 1e-5..1e-4 LAMB moves each
    # tensor by that fraction of its norm a step, and each step draws
    # new dropout masks, so the loss's change over the warm-up may be
    # below its step-to-step spread
    falling = f32[RECIPE_WARMUP_STEPS - 1] < f32[0]
    emit({"phase": "train_recipe", "step": "eager = graph",
          "losses": side_losses, "losses_from_f32_sums_graph_side": f32,
          "loss_fell_over_the_warm_up": falling, "lr": side_lrs,
          "modes": [s[1] for s in sides], "bit_identical": same,
          "copy_backs_graph_side": sides[1][2], "lr_peak_step": lr_peak + 1})
    failed = []
    if not same or sides[1][1][-1] != "graph" or sides[1][2] != [0]:
        failed.append("eager and graph differ, or the graph side did not "
                      "replay or copied state back")
    warm = side_lrs[1][:RECIPE_WARMUP_STEPS]
    if warm != sorted(warm) or lr_peak != RECIPE_WARMUP_STEPS - 1 \
            or side_lrs[1][lr_peak:] != sorted(side_lrs[1][lr_peak:],
                                               reverse=True):
        failed.append("the schedule did not warm up over %d steps, then "
                      "decay: %s" % (RECIPE_WARMUP_STEPS, side_lrs[1]))
    if not all(np.isfinite(f32 + side_losses[1])):
        failed.append("loss not finite: %s" % f32)
    if failed:
        raise AssertionError("train_recipe: %s" % "; ".join(failed))
    rows = time_plain_updates(torch, _gen(torch), ops_per_step)
    emit({"phase": "train_recipe", "step": "updates",
          "card": card_label(env), "rows": rows})
    return counts


def phase_train_recipe_parity():
    """One step of the flagship recipe at 2 layers of BERT-base width
    (B=4, T=128, dropout 0.1) on the card and on the CPU with the plain
    versions, from one start and the same masks, the card's a replay of
    its captured graph: the loss, the learning rate and the clipped
    gradients LAMB reads, for the word embedding, a fused QKV projection
    and an LN scale."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models import bert

    cfg = _recipe_cfg(bert, layers=2)
    with fluid.unique_name.guard():
        main, startup, loss, lr = recipe_program(fluid, bert, cfg,
                                                 RECIPE_SEQ)
    grads = {op.inputs["Param"][0]: op.inputs["Grad"][0]
             for op in main.global_block().ops if op.type == "lamb"}
    names = ["bert.word_emb", "bert.layer0.attn.qkv.w",
             "bert.layer0.ln1.scale"]
    fetch = [loss.name, lr.name] + [grads[n] for n in names]
    batch = bert.make_fake_batch(RECIPE_PARITY_BATCH, RECIPE_SEQ, cfg,
                                 np.random.RandomState(SEED + 3))
    out, modes, start = {}, {}, None
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = fluid.Executor(place)
            exe.run(startup)
            if start is None:
                start = convert.scope_persistables(main, scope)
            out[place._kind], modes[place._kind] = _parity_calls(
                fluid, convert, exe, scope, main, place, start,
                lambda: exe.run(main, feed=batch, fetch_list=fetch))
        del scope, exe
    gpu, cpu = out["cuda"], out["cpu"]
    g_loss, c_loss = float(gpu[0][0]), float(cpu[0][0])
    result = {"phase": "train_recipe_parity", "step": "GPU kernels vs CPU "
              "plain versions, one recipe step, dropout 0.1, the last of "
              "%d from one start" % PARITY_CALLS, "modes": modes,
              "loss": [g_loss, c_loss],
              "loss_rel_err": abs(g_loss - c_loss) / abs(c_loss),
              "loss_tol": PARITY_AMP_LOSS_RTOL,
              "lr": [float(gpu[1][0]), float(cpu[1][0])]}
    ok = result["loss_rel_err"] <= PARITY_AMP_LOSS_RTOL \
        and modes["cuda"][-1] == "graph" and gpu[1][0] == cpu[1][0]
    for name, g, c in zip(names, gpu[2:], cpu[2:]):
        err = float(np.abs(g - c).max()) / max(float(np.abs(c).max()), 1e-30)
        result[name + "@GRAD (clipped) rel_err"] = err
        ok = ok and np.isfinite(g).all() and err <= PARITY_AMP_GRAD_RTOL \
            and g.dtype == np.float32
    result["grad_tol"] = PARITY_AMP_GRAD_RTOL
    emit(result)
    if not ok:
        raise AssertionError("train_recipe parity failed: %s" % result)


def _recompute_side(fluid, bert, recompute, cache, batch, start):
    """BERT-base T=512 b8 training (float32, dropout 0.1, Adam,
    ``fused_ln``), with every encoder layer in a recompute region or
    not, from the persistables ``start`` (None: the startup's, which are
    returned), RECOMPUTE_STEPS steps eager or cached → the side's
    numbers and each step's fetches (the loss and RECOMPUTE_GRADS'
    gradients).  Peak memory counts from the first step (eager) or from
    the capture (cached, after the warm-up's blocks are released), and a
    cached side then times RECOMPUTE_TIMED replays with their launches."""
    import copy
    import statistics

    import numpy as np
    import torch

    from paddle_tpu_torch import convert
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    cfg = copy.copy(bert.BERT_BASE)
    cfg.fused_ln = True
    cfg.recompute = recompute
    with fluid.unique_name.guard():
        main, startup, loss = _train_program(fluid, bert, cfg, SEQ)
    grads = _grad_names(main)
    fetch = [loss.name] + [grads[n] for n in RECOMPUTE_GRADS]
    scope = fluid.Scope()
    side = {"recompute": recompute,
            "mode": "graph" if cache else "eager",
            "regions": _op_type_counts(main).get("recompute_block", 0)}
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup)
        if start is None:
            start = convert.scope_persistables(main, scope)
        else:
            convert.load_params_into_scope(start, scope,
                                           fluid.CUDAPlace(0), program=main)
        rows, modes, step_ms = [], [], []
        for i in range(RECOMPUTE_STEPS):
            torch.cuda.synchronize()
            if i == (1 if cache else 0):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                reset_launch_counts()
            s0 = time.perf_counter()
            rows.append([np.asarray(v).copy() for v in exe.run(
                main, feed=batch, fetch_list=fetch,
                use_program_cache=cache)])
            step_ms.append((time.perf_counter() - s0) * 1e3)
            modes.append(exe.last_run_mode)
        side["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
        side["peak_reserved_bytes"] = torch.cuda.max_memory_reserved()
        side["modes"] = modes
        if cache:
            reset_launch_counts()
            timed = []
            for _ in range(RECOMPUTE_TIMED):
                s0 = time.perf_counter()
                exe.run(main, feed=batch, fetch_list=fetch)
                timed.append((time.perf_counter() - s0) * 1e3)
            side["launches_per_step"] = {
                k: c / RECOMPUTE_TIMED for k, c in launch_counts().items()
                if c}
            side["step_ms"] = timed
            side["copy_backs_per_step"] = _copy_backs(exe)
        else:
            side["launches_per_step"] = {
                k: c / RECOMPUTE_STEPS for k, c in launch_counts().items()
                if c}
            side["step_ms"] = step_ms[1:]
        side["median_step_ms"] = statistics.median(side["step_ms"])
        side["tokens_per_s"] = TRAIN_BATCH * SEQ / (
            side["median_step_ms"] / 1e3)
    del scope, exe
    torch.cuda.empty_cache()
    return side, rows, start


def phase_recompute(env):
    """BERT-base MLM pretraining at T=512, batch 8, float32, dropout 0.1,
    Adam, with ``BertConfig(recompute=True)`` (every encoder layer one
    region) and without, from one start, eager and from the captured
    graph: RECOMPUTE_STEPS steps whose losses and RECOMPUTE_GRADS'
    gradients must be bit for bit equal on all four sides (a region's
    second run draws its first run's masks); step ms, peak allocated and
    reserved of each side; K1 and K2 forward launches twice the
    forward's with recompute."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert

    batch = bert.make_fake_batch(TRAIN_BATCH, SEQ, bert.BERT_BASE,
                                 np.random.RandomState(SEED + 9))
    sides, start, ref = [], None, None
    for recompute in (False, True):
        for cache in (False, True):
            side, rows, start = _recompute_side(fluid, bert, recompute,
                                                cache, batch, start)
            side["bit_identical_to_first_side"] = ref is None or all(
                np.array_equal(a, b) for ra, rb in zip(ref, rows)
                for a, b in zip(ra, rb))
            side["losses"] = [float(r[0].reshape(-1)[0]) for r in rows]
            ref = rows if ref is None else ref
            emit(dict({"phase": "recompute", "card": card_label(env)},
                      **side))
            sides.append(side)
    failed = [s for s in sides if not s["bit_identical_to_first_side"]]
    want = {False: {"flash_attention_fwd": 12,
                    "fused_dropout_add_ln_fwd": 25},
            True: {"flash_attention_fwd": 24,
                   "fused_dropout_add_ln_fwd": 49}}
    for s in sides:
        got = {k: s["launches_per_step"].get(k, 0)
               for k in want[s["recompute"]]}
        if got != want[s["recompute"]] or \
                s["launches_per_step"].get("flash_attention_bwd_dq") != 12:
            failed.append("launches %s: %s" % (s["mode"], got))
        if s["mode"] == "graph" and (s["modes"][-1] != "graph"
                                     or s["copy_backs_per_step"] != [0]):
            failed.append("the graph side did not replay, or copied state "
                          "back: %s %s" % (s["modes"],
                                           s["copy_backs_per_step"]))
    peak = {(s["recompute"], s["mode"]): s["peak_allocated_bytes"]
            for s in sides}
    emit({"phase": "recompute", "step": "summary", "card": card_label(env),
          "peak_allocated_bytes": {"%s %s" % ("recompute" if k[0] else
                                              "plain", k[1]): v
                                   for k, v in peak.items()},
          "step_ms": {"%s %s" % ("recompute" if s["recompute"] else "plain",
                                 s["mode"]): s["median_step_ms"]
                      for s in sides}})
    if failed:
        raise AssertionError("recompute: %s" % failed)


# ---------------------------------------------------------------------------
# The reference's other optimizers, the averages, and the operator's CLIs
# ---------------------------------------------------------------------------

# the ftrl op adds this to its l1 and to its l2, as the reference's does
FTRL_L_FLOOR = 1e-10
# a relative change δ of an element's gradients changes a step of a rule
# that divides the gradient by a running norm of itself by at most
# PARITY_GRAD_K δ of the rule's step bound (Adagrad's first step,
# lr g / (|g| + eps), by at most lr δ; the later steps' running norms
# and moments add a few δ more)
PARITY_GRAD_K = 4


def rule_step_bound(rule, lr):
    """The largest step rule ``rule`` takes an element in one of its
    first 3 steps at rate ``lr`` from zero accumulators, its settings
    read from RULE_SETTINGS: ``lr`` for Adagrad, Adamax, Adam and Ftrl's
    ``p - lr sign(g)``; ``lr / sqrt(1 - decay)`` for DecayedAdagrad; for
    centered RMSProp ``lr / sqrt(w - w^2)`` (``w = 1 - rho``) a step
    accumulated by its momentum over 3 steps; Adadelta takes no rate, and
    its step grows from ``sqrt(eps / (1 - rho))`` to at most ``sqrt(4 eps
    / (1 - rho))`` by the third; 0 for DGCMomentum, whose step scales
    with the gradient (:func:`rule_parity_tol` bounds it apart)."""
    s = RULE_SETTINGS[rule][1]
    if rule == "decayed_adagrad":
        return lr / (1 - s["decay"]) ** 0.5
    if rule == "adadelta":
        return (4 * s["epsilon"] / (1 - s["rho"])) ** 0.5
    if rule == "rmsprop":
        w, mu = 1 - s["rho"], s["momentum"]
        return lr * (1 + mu + mu ** 2) / (w - w ** 2) ** 0.5
    if rule == "dgc_momentum":
        return 0.0
    return lr


def rule_parity_tol(rule, lr, start, grads_a, grads_b, base):
    """The bound on ``|a - b|`` for each element of a parameter that held
    ``start`` and was updated by rule ``rule`` at rate ``lr`` in two runs
    a and b from that start; ``grads_a`` and ``grads_b`` are each run's
    gradients of the parameter, one numpy array a step.  ``base`` covers
    float32 rounding.  On top of it an element gets what the two runs'
    gradients can explain, and no more:

    - a rule that divides the gradient by a running norm of itself moves
      the element at most B = :func:`rule_step_bound` a step whatever its
      gradient, so with δ the element's largest relative gradient
      difference over the steps (``|a - b| / min(|a|, |b|)``, infinite
      where the signs differ or one is 0: rounding noise) its steps
      differ by at most ``min(2, PARITY_GRAD_K δ) steps B``;
    - DGCMomentum's step is ``lr`` times the gradient accumulated by its
      momentum: ``lr steps sum(mu^k, k < steps) max |a - b|``;
    - Ftrl sets an element to ``p - lr sign(g)`` (the δ term above with
      B = ``lr``) shifted by its l1 and l2 (each plus FTRL_L_FLOOR) by at
      most ``(l1 + l2 (|p| + steps lr)) lr / sqrt(n)`` a step, n the sum
      of the squared gradients, which is at least the first gradient's
      square; 0, where ``|z| <= l1``, lies within that shift too.  Each
      run adds ``steps`` such shifts, and the whole is capped at ``|p| +
      2 steps lr``, the farthest two of its values lie apart.

    The arithmetic is float64 torch on the device of ``start`` when it is
    a tensor (the card in :func:`phase_optimizers_parity`), and on the CPU
    for numpy inputs, element for element the same operations either way.

    → the bound, shaped as ``start``: a float64 tensor for a tensor
    ``start``, else a numpy array."""
    import numpy as np
    import torch

    on_host = not isinstance(start, torch.Tensor)
    dev = torch.device("cpu") if on_host else start.device

    def f64(a):
        return torch.as_tensor(a).to(device=dev, dtype=torch.float64)

    steps = len(grads_a)
    ga = torch.stack([f64(g) for g in grads_a])
    gb = torch.stack([f64(g) for g in grads_b])
    low = torch.minimum(ga.abs(), gb.abs())
    rel = torch.where((torch.sign(ga) == torch.sign(gb)) & (low > 0),
                      (ga - gb).abs() / low,
                      torch.full_like(low, float("inf"))).amax(dim=0)
    s = RULE_SETTINGS[rule][1]
    if rule == "dgc_momentum":
        slack = lr * steps * sum(s["momentum"] ** k for k in range(steps)) \
            * (ga - gb).abs().amax(dim=0)
    else:
        step = rule_step_bound(rule, lr)
        slack = torch.clamp(PARITY_GRAD_K * rel, max=2.0) * steps * step
        if rule == "ftrl":
            p = f64(start).abs()
            l1, l2 = s["l1"] + FTRL_L_FLOOR, s["l2"] + FTRL_L_FLOOR
            shift = sum(steps * (l1 + l2 * (p + steps * lr)) * lr
                        / g[0].abs() for g in (ga, gb))
            slack = torch.minimum(slack + shift, p + 2 * steps * lr)
    bound = base + slack
    return bound.numpy() if on_host else bound


def rule_grads(main):
    """param name → its gradient var, read off the update ops."""
    return {op.inputs["Param"][0]: op.inputs["Grad"][0]
            for op in main.global_block().ops
            if "Param" in op.inputs and "Grad" in op.inputs}


RULE_REPLAYS = 3          # timed graph replays a rule
RULE_PARAMS = ("bert.word_emb", "bert.layer0.attn.q.w",
               "bert.layer11.ln2.scale")
RULE_PARITY_SEQ = 128
RULE_PARITY_BATCH = 2
RULE_PARITY_PARAMS = ("bert.word_emb", "bert.layer0.attn.q.w",
                      "bert.layer0.ln1.scale")
# of the parameter's largest value (8 float32 units of it: one step's
# rounding), plus what the gradients explain (rule_parity_tol)
PARITY_PARAM_RTOL = 1e-6
AVERAGING_GRAPH_STEPS = 6
AVERAGING_EMA_DECAY = 0.999
AVERAGING_WINDOW = (2, 4)  # ModelAverage's min and max window: restarts
AVERAGE_ULPS = 4           # applied value vs plain torch, float32 units
TOOLS_REQUESTS = 32
TOOLS_STEPS = 4
TOOLS_SEQ = 128
HEARTBEAT_S = 0.2
TOOLS_TIMEOUT = 300


def _scope_params(scope, names):
    """Device copies of the named scope tensors."""
    return {n: scope.get(n).detach().clone() for n in names}


def _restore_scope(scope, saved):
    """Write ``saved`` into the scope's current tensors."""
    for n, t in saved.items():
        scope.get(n).copy_(t)


def _rule_run(fluid, bert, cfg, rule, batch):
    """One rule on BERT-base T=512 b8 on the card: the eager step (the
    key's first call), then the start restored and the same executor
    step captured and replayed (compared bit for bit: the loss and
    RULE_PARAMS after the update), then RULE_REPLAYS timed replays with
    their launches → the rule's row."""
    import numpy as np
    import torch

    from paddle_tpu_torch.ops.cuda import (KERNELS, launch_counts,
                                           reset_launch_counts)
    from paddle_tpu_torch.static_analysis import fusion

    t0 = time.time()
    with fluid.unique_name.guard():
        main, startup, loss = rule_program(fluid, bert, cfg, SEQ, rule)
    n_params = len(main.all_parameters())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup)
        prog, _ = fusion.resolve_fused_program(main, targets=[loss.name])
        start = _scope_params(scope, _persistable_names(main))
        step = exe._step
        build_s = time.time() - t0
        runs = []
        for _ in range(2):  # eager, then capture + replay
            _restore_scope(scope, start)
            exe._step = step
            out = float(exe.run(main, feed=batch, fetch_list=[loss])[0][0])
            runs.append((exe.last_run_mode, out,
                         _scope_params(scope, RULE_PARAMS)))
        same = runs[0][1] == runs[1][1] and all(
            torch.equal(runs[0][2][n], runs[1][2][n]) for n in RULE_PARAMS)
        reset_launch_counts()
        step_ms, losses = [], [runs[1][1]]
        for _ in range(RULE_REPLAYS):
            s0 = time.perf_counter()
            losses.append(float(exe.run(main, feed=batch,
                                        fetch_list=[loss])[0][0]))
            step_ms.append((time.perf_counter() - s0) * 1e3)
        per_step = {k: c / RULE_REPLAYS for k, c in launch_counts().items()}
        want = dict.fromkeys(KERNELS, 0.0)
        want.update(_train_launches(prog))
        copies = copy_back_writers(exe)
        row = {"phase": "optimizers", "rule": rule,
               "build+startup_s": build_s,
               "modes": [r[0] for r in runs] + [exe.last_run_mode],
               "eager_equals_graph_bit_for_bit": same,
               "loss_eager_graph": [runs[0][1], runs[1][1]],
               "losses": losses, "loss_finite": bool(np.all(
                   np.isfinite(losses))),
               "graph_step_ms": step_ms,
               "median_graph_step_ms": sorted(step_ms)[len(step_ms) // 2],
               "copy_backs_per_step": _copy_backs(exe),
               "copy_backs_by_writer": copies,
               "launches_per_step": {k: v for k, v in per_step.items() if v},
               "k1_k2_k3_per_step": {k: per_step.get(k, 0) for k in (
                   "flash_attention_fwd", "flash_attention_bwd_dkv",
                   "flash_attention_bwd_dq", "fused_dropout_add_ln_fwd",
                   "fused_dropout_add_ln_bwd", "embedding_gather_fwd",
                   "embedding_gather_bwd")},
               "parameters": n_params}
        expect = {"adamax": {"scale": n_params},
                  "adamw": {"assign": n_params}}.get(rule, {})
        failed = []
        if not same or row["modes"] != ["eager", "capture", "graph"]:
            failed.append("eager and graph differ, or no replay: %s"
                          % row["modes"])
        if not row["loss_finite"]:
            failed.append("loss not finite: %s" % losses)
        if copies != expect:
            failed.append("copy-backs %s, not %s" % (copies, expect))
        if per_step != want:
            failed.append("launches per step %s != %s" % (per_step, want))
        row["failed"] = failed
    del scope, exe
    torch.cuda.empty_cache()
    return row


def phase_optimizers(env):
    """BERT-base MLM pretraining (T=512, batch 8, float32, dropout 0.1;
    K1, K2 and K3 forward and backward) with each of RULES, each program
    built once: the eager step against the captured step from the same
    start bit for bit, RULE_REPLAYS timed replays with their launches,
    the copy-backs a step by the op that wrote each; then the nine new
    update ops alone at [30522, 768] float32."""
    import warnings

    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rule_optimizer(fluid, "dgc_momentum", 0.1)
    emit({"phase": "optimizers", "step": "DGCMomentum's warning",
          "warnings": [str(w.message) for w in caught]})
    batch = bert.make_fake_batch(TRAIN_BATCH, SEQ, bert.BERT_BASE,
                                 np.random.RandomState(SEED))
    failed = []
    for rule in RULES:
        row = _rule_run(fluid, bert, bert.BERT_BASE, rule, batch)
        row["card"] = card_label(env)
        emit(row)
        failed += ["%s: %s" % (rule, f) for f in row["failed"]]
    rows = time_new_updates(torch, _gen(torch))
    emit({"phase": "optimizers", "step": "updates",
          "card": card_label(env), "rows": rows})
    if len(caught) != 1 or "plain momentum" not in str(caught[0].message):
        failed.append("DGCMomentum did not warn: %s" % caught)
    if failed:
        raise AssertionError("optimizers: %s" % failed)


def time_new_updates(torch, gen):
    """The nine update ops of this package's other optimizers, plain
    PyTorch on the card, at BERT-base's word embedding [30522, 768]
    float32: device ms of one op (cold L2), its bound (each input read
    once, each output written once) and the CUDA kernels one op launches
    (the nodes of a graph captured around it)."""
    from paddle_tpu_torch.ops import optimizer_ops as ops
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.ops.cuda import _lib

    shape = (30522, 768)
    n = shape[0] * shape[1]
    x = _update_inputs(torch, gen, shape, torch.float32)
    pos = x["m2"]  # a non-negative accumulator
    pos2 = x["v"].abs()  # another
    pos3 = pos + 1.0  # above the centered RMSProp's squared mean
    counters = [torch.full((1,), c, dtype=torch.int64, device="cuda")
                for c in (3, 2, 9)]
    ctx = registry.LoweringContext(device=torch.device("cuda"))
    ref = "paddle_tpu/ops/optimizer_ops.py:%d (%s; XLA)"
    # name → (call, bytes, operations, the reference's function)
    cases = {
        "adamax": (lambda: ops.adamax(ctx, {}, x["p"], x["g"], x["lr"],
                                      x["m1"], pos2, x["b1p"]),
                   28 * n, 10 * n, ref % (86, "adamax")),
        "adagrad": (lambda: ops.adagrad(ctx, {}, x["p"], x["g"], pos,
                                        x["lr"]), 20 * n, 7 * n,
                    ref % (104, "adagrad")),
        "decayed_adagrad": (lambda: ops.decayed_adagrad(
            ctx, {}, x["p"], x["g"], pos, x["lr"]), 20 * n, 9 * n,
            ref % (117, "decayed_adagrad")),
        "adadelta": (lambda: ops.adadelta(ctx, {}, x["p"], x["g"], pos,
                                          pos2), 28 * n, 15 * n,
                     ref % (131, "adadelta")),
        "rmsprop (centered)": (lambda: ops.rmsprop(
            ctx, {"centered": True, "momentum": 0.9, "decay": 0.95},
            x["p"], x["g"], pos3, x["m1"], x["v"], x["lr"]),
            36 * n, 15 * n, ref % (151, "rmsprop")),
        "ftrl": (lambda: ops.ftrl(ctx, {}, x["p"], pos, x["m1"], x["g"],
                                  x["lr"]), 28 * n, 20 * n,
                 ref % (181, "ftrl")),
        "average_accumulates": (lambda: ops.average_accumulates(
            ctx, {"average_window": 1.0, "min_average_window": 2,
                  "max_average_window": 4}, x["p"], x["m1"], x["m2"],
            x["v"], *counters), 28 * n, 8 * n,
            ref % (274, "average_accumulates")),
        "proximal_gd": (lambda: ops.proximal_gd(
            ctx, {"l1": 1e-4, "l2": 1e-4}, x["p"], x["g"], x["lr"]),
            12 * n, 8 * n, ref % (315, "proximal_gd")),
        "proximal_adagrad": (lambda: ops.proximal_adagrad(
            ctx, {"l1": 1e-4, "l2": 1e-4}, x["p"], pos, x["g"], x["lr"]),
            20 * n, 12 * n, ref % (331, "proximal_adagrad")),
    }
    rows = []
    for name, (call, nbytes, flops, replaces) in cases.items():
        library, note = _library_update(torch, name, x)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            call()
        graph.instantiate()
        kernels = len(_lib.graph_kernel_functions(graph))
        bound, by = bound_ms(nbytes, flops, "float32")
        ms = time_ms(graph.replay, 20)
        rows.append({"name": name, "route": "plain PyTorch",
                     "source": "paddle_tpu_torch/ops/optimizer_ops.py",
                     "replaces": replaces,
                     "shape": "[30522,768] f32 (BERT-base word embedding)",
                     "ms_graph": ms, "bound_ms": bound, "bound_by": by,
                     "bound_share": bound / ms,
                     "cuda_kernels_per_op": kernels,
                     "library_ms": None if library is None
                     else time_ms(library, 20), "library": note})
        del graph
    return rows


# torch.optim's update of the same function as the op, where it has one
# (its defaults' extra options off), else why none; the call steps a
# clone of the op's parameter
TORCH_OPTIM_TWINS = {
    "adamax": ("Adamax", {"lr": 1e-3, "betas": (0.9, 0.999), "eps": 1e-8},
               "u = max(b2 u, |g| + eps), lr / (1 - b1^t) as the op"),
    "adagrad": ("Adagrad", {"lr": 1e-3, "eps": 1e-6},
                "lr_decay 0: m += g^2, eps added to sqrt(m) as the op"),
    "decayed_adagrad": ("RMSprop", {"lr": 1e-3, "alpha": 0.95, "eps": 1e-6},
                        "plain RMSprop (alpha = decay, no momentum) is "
                        "DecayedAdagrad's update"),
    "adadelta": ("Adadelta", {"lr": 1.0, "rho": 0.95, "eps": 1e-6},
                 "lr 1: the op takes no rate"),
}
TORCH_OPTIM_NONE = {
    "rmsprop (centered)": "none: torch's centered RMSprop adds eps outside "
                          "the square root and applies lr after the "
                          "momentum",
    "ftrl": "none: torch.optim has no FTRL",
    "average_accumulates": "none: no torch.optim function keeps "
                           "ModelAverage's windowed sums",
    "proximal_gd": "none: torch.optim has no proximal (l1/l2 shrink) update",
    "proximal_adagrad": "none: torch.optim has no proximal (l1/l2 shrink) "
                        "update",
}


def _library_update(torch, name, x):
    """(a call of the torch.optim update of op ``name``'s function, a
    note), or (None, why there is none)."""
    if name not in TORCH_OPTIM_TWINS:
        return None, TORCH_OPTIM_NONE[name]
    cls, kw, note = TORCH_OPTIM_TWINS[name]
    p = x["p"].detach().clone()
    p.grad = x["g"].detach().clone()
    opt = getattr(torch.optim, cls)([p], foreach=False, **kw)
    return opt.step, "torch.optim.%s(foreach=False).step(): %s" % (cls,
                                                                    note)


def _card64(torch, value):
    """``value`` (a tensor on any device, or a host array) as a float64
    tensor on the card."""
    return torch.as_tensor(value).to(device="cuda", dtype=torch.float64)


def phase_optimizers_parity():
    """Each rule's first step on a 2-layer BERT at BERT-base width (T=128,
    batch 2, dropout 0.1) on the card (a captured step, replayed) and on
    the CPU with the plain versions, from the card's start and at the same
    executor step (so the same masks): the loss within PARITY_LOSS_RTOL
    and RULE_PARITY_PARAMS after the update within PARITY_PARAM_RTOL of
    their scale plus what the two sides' gradients explain
    (:func:`rule_parity_tol`), the card's parameters moved, and the same
    bounds failing the card's update dropped and reversed."""
    import copy
    import warnings

    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models import bert

    cfg = copy.copy(bert.BERT_BASE)
    cfg.layers = 2
    batch = bert.make_fake_batch(RULE_PARITY_BATCH, RULE_PARITY_SEQ, cfg,
                                 np.random.RandomState(SEED + 5))
    failed = []
    for rule in RULES:
        t_rule = time.time()
        with fluid.unique_name.guard():
            main, startup, loss = rule_program(fluid, bert, cfg,
                                               RULE_PARITY_SEQ, rule)
        grads = rule_grads(main)
        fetch = [loss.name] + [grads[n] for n in RULE_PARITY_PARAMS]
        out, start = {}, None
        for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
            scope = fluid.Scope()
            with fluid.scope_guard(scope), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                exe = fluid.Executor(place)
                if start is None:  # the card's start; the CPU loads it
                    exe.run(startup)
                    start = convert.scope_persistables(main, scope)
                    step = exe._step
                calls = 2 if place._kind == "cuda" else 1
                for _ in range(calls):  # the card: warm-up, then capture
                    convert.load_params_into_scope(start, scope, place,
                                                   program=main)
                    exe._step = step
                    vals = exe.run(main, feed=batch, fetch_list=fetch)
                # the comparison runs on the card in float64
                out[place._kind] = (float(vals[0][0]), exe.last_run_mode, {
                    n: _card64(torch, scope.get(n))
                    for n in RULE_PARITY_PARAMS}, {
                        n: _card64(torch, v)
                        for n, v in zip(RULE_PARITY_PARAMS, vals[1:])})
            del scope, exe
        (g_loss, g_mode, g, g_grad), (c_loss, _, c, c_grad) = \
            out["cuda"], out["cpu"]
        row = {"phase": "optimizers_parity", "rule": rule,
               "step": "GPU kernels vs CPU plain versions, one step, "
                       "dropout 0.1, the card's a captured step",
               "mode": g_mode, "loss": [g_loss, c_loss],
               "loss_rel_err": abs(g_loss - c_loss) / abs(c_loss),
               "loss_tol": PARITY_LOSS_RTOL}
        ok = row["loss_rel_err"] <= PARITY_LOSS_RTOL and g_mode == "capture"
        caught = {"dropped": False, "reversed": False}
        for n in RULE_PARITY_PARAMS:
            p0 = _card64(torch, start[n])
            card, cpu = g[n], c[n]
            diff = (card - cpu).abs()
            tol = rule_parity_tol(
                rule, TRAIN_LR, p0, [g_grad[n]], [c_grad[n]],
                PARITY_PARAM_RTOL * float(p0.abs().max()))
            # the check's power: the card's update dropped, or reversed
            miss = {"dropped": (p0 - cpu).abs() > tol,
                    "reversed": (2 * p0 - card - cpu).abs() > tol}
            row[n] = {"max_abs_err": float(diff.max()),
                      "min_tol": float(tol.min()),
                      "median_tol": float(tol.median()),
                      "worst_err_over_tol": float((diff / tol).max()),
                      "cpu_update": float((cpu - p0).abs().max()),
                      "card_update": float((card - p0).abs().max()),
                      "share_tol_over_own_update": float(
                          (tol >= (cpu - p0).abs()).double().mean()),
                      "share_catching": {k: float(m.double().mean())
                                         for k, m in miss.items()}}
            for k, m in miss.items():
                caught[k] = caught[k] or bool(m.any())
            ok = ok and bool(torch.isfinite(card).all()) and bool(
                (diff <= tol).all()) and row[n]["cpu_update"] > 0 \
                and row[n]["card_update"] > 0
        row["update_dropped_or_reversed_would_fail"] = caught
        row["seconds"] = time.time() - t_rule
        ok = ok and all(caught.values())
        emit(row)
        if not ok:
            failed.append(row)
    if failed:
        raise AssertionError("optimizers parity failed: %s" % failed)


def averaging_program(fluid, bert, cfg, seq, lr=TRAIN_LR, max_pred=None):
    """``build_pretrain``'s masked-LM program with Adam, an
    ``ExponentialMovingAverage`` whose decay is scheduled from a step
    counter (``thres_steps``) and a ``ModelAverage`` whose window
    restarts every few steps → ``(main, startup, loss, ema, average)``."""
    if max_pred is None:
        max_pred = bert.default_max_pred(seq)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup):
        loss = _mlm_loss(fluid, bert, cfg, seq, max_pred)
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
        counter = fluid.layers.autoincreased_step_counter(begin=0)
        ema = fluid.optimizer.ExponentialMovingAverage(
            AVERAGING_EMA_DECAY, thres_steps=counter)
        ema.update()
        # ParamAttr's do_model_average is False by default in both
        # packages: the model's parameters opt in here
        for p in main.all_parameters():
            p.do_model_average = True
        average = fluid.optimizer.ModelAverage(
            1.0, min_average_window=AVERAGING_WINDOW[0],
            max_average_window=AVERAGING_WINDOW[1])
    return main, startup, loss, ema, average


def _plain_averages(torch, history):
    """The EMA (bias-corrected as the apply program corrects it) and the
    window average of each parameter, in plain torch where the values
    lie, from its value after each step → ``({name: ema}, {name:
    average})``."""
    names = list(history[0])
    f32 = dict(dtype=torch.float32, device=history[0][names[0]].device)
    emas = {n: torch.zeros_like(history[0][n]) for n in names}
    d = None
    for t, params in enumerate(history):
        tf = torch.full((1,), float(t), **f32)
        d = torch.minimum((tf * 1.0 + 1.0) / (tf * 1.0 + 10.0),
                          torch.full((1,), AVERAGING_EMA_DECAY, **f32))
        one_minus = d * -1.0 + 1.0
        for n in names:
            emas[n] = emas[n] * d + params[n] * one_minus
    denom = torch.maximum(
        1.0 - torch.pow(d, torch.full((1,), float(len(history)), **f32)),
        torch.full((1,), 1e-12, **f32))
    ema_out = {n: emas[n] / denom for n in names}
    lo, hi = AVERAGING_WINDOW
    out = {}
    for n in names:
        s1 = s2 = s3 = torch.zeros_like(history[0][n])
        na = ona = nu = 0
        for params in history:
            nu += 1
            na += 1
            s1 = s1 + params[n]
            if nu % 16384 == 0:
                s2, s1 = s2 + s1, torch.zeros_like(s1)
            if na >= lo and na >= min(hi, nu * 1.0):
                s3 = s1 + s2
                s1, s2 = torch.zeros_like(s1), torch.zeros_like(s2)
                ona, na = na, 0
        cnt = torch.full((1,), float(na + ona), **f32)
        out[n] = (s1 + s2 + s3) / cnt
    return ema_out, out


def _ulps_off(torch, got, want):
    """max |got - want| in float32 units of the largest |want|."""
    err = float((got - want).abs().max())
    unit = float(torch.finfo(torch.float32).eps) * max(
        float(want.abs().max()), 1e-30)
    return err / unit


def phase_averaging(env):
    """BERT-base T=512 b8 (float32, dropout 0.1) with Adam, an EMA whose
    decay is scheduled from a step counter and a ModelAverage whose window
    restarts, AVERAGING_GRAPH_STEPS graph steps after the warm-up; then
    each average applied: the eval program's loss inside ``apply``, every
    parameter held to the plain-torch average of its recorded values
    inside the eager and the captured apply both, and
    after ``restore`` every parameter bit for bit its value before; the
    apply and restore programs' ms (eager, then captured)."""
    import copy

    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert

    cfg = bert.BERT_BASE
    with fluid.unique_name.guard():
        main, startup, loss, ema, average = averaging_program(
            fluid, bert, cfg, SEQ)
    eval_cfg = copy.copy(cfg)
    eval_cfg.dropout = eval_cfg.attn_dropout = 0.0
    eval_main, eval_start = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), \
            fluid.program_guard(eval_main, eval_start):
        eval_loss = _mlm_loss(fluid, bert, eval_cfg, SEQ,
                              bert.default_max_pred(SEQ))
    batch = bert.make_fake_batch(TRAIN_BATCH, SEQ, cfg,
                                 np.random.RandomState(SEED + 7))
    names = [p.name for p in main.all_parameters()]
    failed = []
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup)
        history, modes, losses = [], [], []
        for _ in range(AVERAGING_GRAPH_STEPS + 1):
            losses.append(float(exe.run(main, feed=batch,
                                        fetch_list=[loss])[0][0]))
            modes.append(exe.last_run_mode)
            history.append(_scope_params(scope, names))
        copies = copy_back_writers(exe)
        plain_ema, plain_avg = _plain_averages(torch, history)
        raw_loss = float(exe.run(eval_main, feed=batch,
                                 fetch_list=[eval_loss])[0][0])
        rows = {}
        for label, avg, plain in (("ema", ema, plain_ema),
                                  ("model_average", average, plain_avg)):
            before = _scope_params(scope, names)
            timing, ulps = [], []
            for call in range(2):  # the eager run, then the captured one
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with avg.apply(exe, need_restore=False):
                    torch.cuda.synchronize()
                    t_apply = (time.perf_counter() - t0) * 1e3
                    if call == 0:
                        applied_loss = float(exe.run(
                            eval_main, feed=batch,
                            fetch_list=[eval_loss])[0][0])
                    ulps.append(max(_ulps_off(torch, scope.get(n), plain[n])
                                    for n in names))
                    t1 = time.perf_counter()
                    avg.restore(exe)
                    torch.cuda.synchronize()
                    t_restore = (time.perf_counter() - t1) * 1e3
                timing.append({"apply_ms": t_apply, "restore_ms": t_restore,
                               "mode": exe.last_run_mode})
                restored = all(torch.equal(scope.get(n), before[n])
                               for n in names)
                if not restored:
                    failed.append("%s: restore %d not bit for bit"
                                  % (label, call))
            rows[label] = {"applied_ulps_vs_plain_torch": ulps,
                           "tol_ulps": AVERAGE_ULPS,
                           "eval_loss_applied": applied_loss,
                           "runs": timing}
            if not max(ulps) <= AVERAGE_ULPS or \
                    not np.isfinite(applied_loss):
                failed.append("%s: applied values %s units off plain "
                              "torch (eager, captured), eval loss %s"
                              % (label, ulps, applied_loss))
        state = {n: int(scope.get(n).reshape(-1)[0]) for n in (
            average._get_accumulator(k, main.all_parameters()[0]).name
            for k in ("num_accumulates", "old_num_accumulates",
                      "num_updates"))}
    emit({"phase": "averaging", "card": card_label(env), "losses": losses,
          "modes": modes, "eval_loss_raw": raw_loss,
          "copy_backs_by_writer": copies, "window_state": state,
          "parameters": len(names), **rows})
    if modes[-1] != "graph" or not all(np.isfinite(losses)):
        failed.append("the steps did not replay, or a loss is not finite")
    # the EMA's sum into each average (its scheduled decay is written
    # before it is read: a fresh value a step, no copy-back)
    if copies != {"sum": len(names)}:
        failed.append("copy-backs %s, not the EMA's sum of each parameter"
                      % copies)
    if failed:
        raise AssertionError("averaging: %s" % failed)
    del scope, exe
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Dygraph: the eager tape, the 20 layers and the optimizers' eager paths
# ---------------------------------------------------------------------------

DYGRAPH_WARMUP = 2
DYGRAPH_STEPS = 5
# trainable parameters of the dygraph ResNet-50: 65 conv filters, 65 batch
# norm scales and biases, the fc's weight and bias (a Momentum launch each)
DYGRAPH_PARAMS = 197
# dygraph against the static program on the card, the same ops in another
# order of dispatch (cuDNN may pick other algorithms): the first step's
# loss, relative; every parameter and running statistic after one step and
# the eval loss, of the tensor's largest value
DYGRAPH_LOSS_RTOL = 1e-4
DYGRAPH_PARAM_RTOL = 1e-4
# the card against the CPU (TF32 off), small layers: max |card - CPU| over
# max |CPU| of each output and gradient, and of each parameter after the
# optimizers' 3 steps (Adam's elements held to rule_parity_tol on top)
DYGRAPH_PARITY_RTOL = 1e-4
DYGRAPH_PARITY_STEPS = 3
DYGRAPH_PARITY_LR = 0.05


def _randn(r, *shape):
    return r.randn(*shape).astype("float32")


def np_int64(values):
    import numpy as np

    return np.array(values, "int64")


# (name, make(dg) -> layer, inputs(rng) -> [arrays]) at small widths: the
# CPU tests hold the port to the reference on these and the parity phase
# holds the card to the CPU; float inputs take a gradient
DYGRAPH_LAYER_CASES = [
    ("Linear", lambda dg: dg.Linear(4, 3, act="relu"),
     lambda r: [_randn(r, 5, 4)]),
    ("FC", lambda dg: dg.FC(size=3, input_dim=4, act="tanh"),
     lambda r: [_randn(r, 5, 4)]),
    ("Conv2D", lambda dg: dg.Conv2D(2, 4, 3, padding=1, act="relu"),
     lambda r: [_randn(r, 2, 2, 6, 6)]),
    ("Conv2D_stride_groups",
     lambda dg: dg.Conv2D(4, 6, 3, stride=2, padding=1, groups=2),
     lambda r: [_randn(r, 2, 4, 7, 7)]),
    ("Pool2D_max", lambda dg: dg.Pool2D(2, "max", 2),
     lambda r: [_randn(r, 2, 3, 6, 6)]),
    ("Pool2D_global_avg",
     lambda dg: dg.Pool2D(pool_type="avg", global_pooling=True),
     lambda r: [_randn(r, 2, 3, 5, 5)]),
    ("BatchNorm", lambda dg: dg.BatchNorm(3, act="relu"),
     lambda r: [_randn(r, 4, 3, 5, 5) * 2 + 1]),
    ("Embedding", lambda dg: dg.Embedding([10, 4]),
     lambda r: [r.randint(0, 10, (6, 1)).astype("int64")]),
    ("LayerNorm", lambda dg: dg.LayerNorm(6),
     lambda r: [_randn(r, 3, 4, 6)]),
    ("Dropout_p0", lambda dg: dg.Dropout(0.0),
     lambda r: [_randn(r, 4, 5)]),
    ("Conv3D", lambda dg: dg.Conv3D(2, 3, 3, padding=1, act="relu"),
     lambda r: [_randn(r, 1, 2, 4, 5, 5)]),
    ("Conv2DTranspose",
     lambda dg: dg.Conv2DTranspose(2, 4, 3, stride=2, padding=1),
     lambda r: [_randn(r, 2, 2, 4, 4)]),
    ("Conv2DTranspose_groups",
     lambda dg: dg.Conv2DTranspose(4, 6, 2, stride=2, groups=2),
     lambda r: [_randn(r, 1, 4, 3, 3)]),
    ("Conv3DTranspose", lambda dg: dg.Conv3DTranspose(2, 3, 2, stride=2),
     lambda r: [_randn(r, 1, 2, 2, 3, 3)]),
    ("GRUUnit", lambda dg: dg.GRUUnit(9),
     lambda r: [_randn(r, 4, 9), _randn(r, 4, 3)]),
    ("GRUUnit_origin", lambda dg: dg.GRUUnit(9, origin_mode=True),
     lambda r: [_randn(r, 4, 9), _randn(r, 4, 3)]),
    ("PRelu_all", lambda dg: dg.PRelu("all"),
     lambda r: [_randn(r, 3, 4)]),
    ("PRelu_channel", lambda dg: dg.PRelu("channel", channel=3),
     lambda r: [_randn(r, 2, 3, 4, 4)]),
    ("PRelu_element", lambda dg: dg.PRelu("element", input_shape=[3, 4]),
     lambda r: [_randn(r, 2, 3, 4)]),
    ("BilinearTensorProduct",
     lambda dg: dg.BilinearTensorProduct(3, 4, 5, act="sigmoid"),
     lambda r: [_randn(r, 2, 3), _randn(r, 2, 4)]),
    ("SequenceConv",
     lambda dg: dg.SequenceConv(num_filters=4, filter_size=3, input_dim=3,
                                act="tanh"),
     lambda r: [_randn(r, 2, 6, 3), np_int64([6, 4])]),
    ("RowConv", lambda dg: dg.RowConv(future_ctx_size=2, input_dim=3),
     lambda r: [_randn(r, 2, 6, 3)]),
    ("GroupNorm", lambda dg: dg.GroupNorm(channels=4, groups=2, act="relu"),
     lambda r: [_randn(r, 2, 4, 5, 5)]),
    ("SpectralNorm", lambda dg: dg.SpectralNorm(weight_shape=[6, 4],
                                                power_iters=2),
     lambda r: [_randn(r, 6, 4)]),
    ("SpectralNorm_dim1", lambda dg: dg.SpectralNorm(
        weight_shape=[3, 5, 2], dim=1, power_iters=3),
     lambda r: [_randn(r, 3, 5, 2)]),
    ("TreeConv", lambda dg: dg.TreeConv(feature_size=4, output_size=6),
     lambda r: [_randn(r, 2, 5, 4),
                np_int64([[[0, 1], [1, 2], [1, 3], [0, 0]],
                          [[0, 4], [4, 1], [0, 0], [0, 0]]])]),
]
# the layers that draw on the op: the card against the CPU with the same
# op ids (so the same masks and negatives on both)
DYGRAPH_DRAWING_CASES = [
    ("Dropout_p0.5", lambda dg: dg.Dropout(0.5),
     lambda r: [_randn(r, 16, 32)]),
    ("NCE", lambda dg: dg.NCE(12, dim=8, num_neg_samples=4),
     lambda r: [_randn(r, 6, 8), r.randint(0, 12, (6, 1)).astype("int64")]),
]


def dygraph_layer_grads(dg, guard, layer, inputs, weight):
    """Under ``guard``, ``layer`` (of dygraph module ``dg``, either
    package's) on ``inputs`` (float ones take a gradient), then ``mean(out
    * weight)`` differentiated → (out, {parameter key: gradient}, [float
    inputs' gradients]) as numpy arrays; a parameter no gradient reached
    is left out."""
    import numpy as np

    with guard:
        vs = []
        for a in inputs:
            v = dg.to_variable(a)
            if a.dtype == np.float32:
                v.stop_gradient = False
            vs.append(v)
        out = layer(*vs)
        out = out[0] if isinstance(out, tuple) else out
        loss = dg.varbase.eager_op(
            "mean", {"X": [out * dg.to_variable(weight)]})[0]
        loss.backward()
        grads = {k: p.gradient() for k, p in dygraph_named_params(layer)
                 if p.gradient() is not None}
        return (out.numpy(), grads,
                [v.gradient() for v, a in zip(vs, inputs)
                 if a.dtype == np.float32])


def dygraph_named_params(layer, prefix=""):
    """(state-dict key, VarBase) of every parameter of ``layer``."""
    for name, p in layer._parameters.items():
        yield prefix + name, p
    for lname, sub in layer._sub_layers.items():
        yield from dygraph_named_params(sub, prefix + lname + ".")


def dygraph_resnet(depth=50, class_dim=1000, dg=None):
    """``models/resnet.resnet_imagenet`` (conv7 stem, NCHW) block for
    block as dygraph layers: each conv → batch_norm site a ``Conv2D``
    without bias and a ``BatchNorm`` (relu, or none before a residual
    add), the max and the global average ``Pool2D``, a ``Linear`` head.
    ``_layer_warp`` passes ``ch_in = ch_out`` to a stage's later blocks,
    so each later bottleneck block has a projection shortcut, as in the
    static program (ResNet-50: 65 sites).  Parameters are made in the
    static builder's order, so ``parameters()`` pairs one to one with the
    program's ``all_parameters()`` (:func:`dygraph_to_scope`).  ``dg`` is
    the dygraph module of the package to build it in, the port's by
    default."""
    if dg is None:
        from paddle_tpu_torch import dygraph as dg
    eager_op = dg.varbase.eager_op

    class ConvBN(dg.Layer):
        def __init__(self, ch_in, ch_out, size, stride, padding,
                     act="relu"):
            super().__init__()
            self.conv = dg.Conv2D(ch_in, ch_out, size, stride=stride,
                                  padding=padding, bias_attr=False)
            self.bn = dg.BatchNorm(ch_out, act=act)

        def forward(self, x):
            return self.bn(self.conv(x))

    class Block(dg.Layer):
        def __init__(self, channels, ch_in, ch_out, stride, bottleneck):
            super().__init__()
            width = ch_out * 4 if bottleneck else ch_out
            # the static builder's test, on the ch_in it passes
            self.short = ConvBN(channels, width, 1, stride, 0, act=None) \
                if stride != 1 or ch_in != width else None
            if bottleneck:
                specs = ((channels, ch_out, 1, stride, 0),
                         (ch_out, ch_out, 3, 1, 1),
                         (ch_out, width, 1, 1, 0, None))
            else:
                specs = ((channels, ch_out, 3, stride, 1),
                         (ch_out, ch_out, 3, 1, 1, None))
            self.convs = [self.add_sublayer("conv%d" % i, ConvBN(*s))
                          for i, s in enumerate(specs)]

        def forward(self, x):
            y = x
            for conv in self.convs:
                y = conv(y)
            short = x if self.short is None else self.short(x)
            out = eager_op("elementwise_add", {"X": [short], "Y": [y]},
                           {"axis": -1})[0]
            return eager_op("relu", {"X": [out]})[0]

    stages, bottleneck = {18: ((2, 2, 2, 2), False),
                          34: ((3, 4, 6, 3), False),
                          50: ((3, 4, 6, 3), True),
                          101: ((3, 4, 23, 3), True),
                          152: ((3, 8, 36, 3), True)}[depth]

    class ResNet(dg.Layer):
        def __init__(self):
            super().__init__()
            self.stem = ConvBN(3, 64, 7, 2, 3)
            self.pool1 = dg.Pool2D(3, "max", 2, 1)
            self.blocks = []
            ch_in = channels = 64
            for i, count in enumerate(stages):
                ch_out = 64 * 2 ** i
                for j in range(count):
                    block = Block(channels, ch_in if j == 0 else ch_out,
                                  ch_out, 1 if i == 0 or j else 2,
                                  bottleneck)
                    self.blocks.append(self.add_sublayer(
                        "block%d_%d" % (i, j), block))
                    channels = ch_out * (4 if bottleneck else 1)
                ch_in = channels
            self.pool2 = dg.Pool2D(7, "avg", global_pooling=True)
            self.fc = dg.Linear(channels, class_dim)

        def forward(self, x):
            x = self.pool1(self.stem(x))
            for block in self.blocks:
                x = block(x)
            return self.fc(self.pool2(x))

    return ResNet()


def dygraph_step(model, opt, params, img, label):
    """One dygraph training step, the static program's loss
    (``softmax_with_cross_entropy``, ``mean``): forward, ``backward``,
    ``minimize``, ``clear_gradients`` → the loss VarBase (nothing waited
    for)."""
    from paddle_tpu_torch.dygraph.varbase import eager_op

    logits = model(img)
    loss = eager_op("softmax_with_cross_entropy",
                    {"Logits": [logits], "Label": [label]})[1]
    loss = eager_op("mean", {"X": [loss]})[0]
    loss.backward()
    opt.minimize(loss, parameter_list=params)
    model.clear_gradients()
    return loss


def dygraph_to_scope(values, program, scope):
    """Write ``values`` (a dygraph model's ``parameters()`` values in
    order: arrays or tensors) into ``program``'s ``all_parameters()`` in
    ``scope``, in place, pairing them in order with the shapes checked."""
    import torch

    static = program.all_parameters()
    if len(values) != len(static):
        raise AssertionError("%d dygraph parameters against %d static"
                             % (len(values), len(static)))
    for v, var in zip(values, static):
        dst = scope.get(var.name)
        src = torch.as_tensor(v)
        if tuple(src.shape) != tuple(dst.shape):
            raise AssertionError("%s: dygraph %s, static %s" % (
                var.name, tuple(src.shape), tuple(dst.shape)))
        with torch.no_grad():
            dst.copy_(src)


def _rel_errs(got, want):
    """max |got - want| / max |want| per pair of arrays (0 / 0 is 0)."""
    import numpy as np

    out = []
    for a, b in zip(got, want):
        a, b = np.asarray(a, "float64"), np.asarray(b, "float64")
        scale = float(np.abs(b).max()) if b.size else 0.0
        err = float(np.abs(a - b).max()) if b.size else 0.0
        out.append(err / scale if scale else err)
    return out


def phase_dygraph(env):
    """ResNet-50 of dygraph layers (:func:`dygraph_resnet`, NCHW) trained
    on the card at batch 64, 224x224, float32 with TF32 off, Momentum
    (lr 0.1, 0.9, Nesterov) through the reference's entry points
    (``guard()``, the layers, ``backward``, ``minimize(parameter_list=)``,
    ``clear_gradients``).  The first step against the static
    ``resnet.build(..., data_format="NCHW")`` program run by the executor
    from the same weights on the same batch (the loss, and every
    parameter and running statistic after the step); warm-up steps, then
    timed steps with the launch counts read around them (197 Momentum
    kernels a step, nothing else hand-written); the host's time to
    enqueue a step, the device time by group and the idle share; peak
    memory; the eval forward (running statistics, unchanged by it)
    against the static for-test clone; a ``save_dygraph`` →
    ``load_dygraph`` → ``set_dict`` round trip bit for bit."""
    import statistics

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dygraph as dg
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.ops.cuda import (KERNELS, launch_counts,
                                           launch_counts_by_source,
                                           reset_launch_counts)

    t0 = time.time()
    rng = np.random.RandomState(SEED)
    batch = {"img": _randn(rng, RESNET_BATCH, 3, RESNET_HW, RESNET_HW),
             "label": rng.randint(0, 10, (RESNET_BATCH, 1)).astype("int64")}
    failed = []
    # the static program first: built outside any guard (minimize would
    # take the dygraph branch inside one)
    main, startup, _feeds, s_loss, _acc = resnet.build(
        dataset="imagenet", depth=50, data_format="NCHW")
    test = main.clone(for_test=True)
    # cuDNN's deterministic algorithms for the two first steps: its
    # default weight gradients sum with atomics, in an order that varies
    # from run to run, which is no difference between the two paths
    flags = fluid.get_flags(["FLAGS_cpu_deterministic"])
    fluid.set_flags({"FLAGS_cpu_deterministic": True})
    with dg.guard():
        model = dygraph_resnet(50, 1000)
        params = model.parameters()
        trainable = [p for p in params if not p.stop_gradient]
        sites = sum(isinstance(s, dg.BatchNorm) for s in model.sublayers())
        opt = fluid.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                       use_nesterov=True)
        # the batch lies on the card, as an input pipeline leaves it
        img, label = dg.to_variable(batch["img"]), dg.to_variable(
            batch["label"])
        start = [p.numpy() for p in params]
        emit({"phase": "dygraph", "step": "build", "seconds":
              time.time() - t0, "conv_bn_sites": sites,
              "trainable_parameters": len(trainable),
              "parameters_and_running_statistics": len(params),
              "elements": sum(p.value.numel() for p in trainable),
              "device": str(img.value.device)})
        if len(trainable) != DYGRAPH_PARAMS or sites != RESNET_SITES:
            raise AssertionError("%d trainable parameters, %d sites"
                                 % (len(trainable), sites))
        first = float(dygraph_step(model, opt, params, img,
                                   label).numpy()[0])
        after = [p.numpy() for p in params]

    # the static program from the same start, one step
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup)
        dygraph_to_scope(start, main, scope)
        feed = {k: torch.from_numpy(v).to(exe.device)
                for k, v in batch.items()}
        s_first = float(exe.run(main, feed=feed,
                                fetch_list=[s_loss])[0][0])
        s_after = [scope.get(v.name).detach().cpu().numpy()
                   for v in main.all_parameters()]
    fluid.set_flags(flags)
    errs = _rel_errs(after, s_after)
    row = {"phase": "dygraph", "step": "first step against the static "
           "NCHW program", "loss": [first, s_first],
           "loss_rel_err": abs(first - s_first) / abs(s_first),
           "loss_tol": DYGRAPH_LOSS_RTOL,
           "params_max_err_over_scale": max(errs),
           "params_worst": main.all_parameters()[int(np.argmax(errs))].name,
           "params_tol": DYGRAPH_PARAM_RTOL,
           "params_moved": sum(not np.array_equal(a, b)
                               for a, b in zip(after, start))}
    emit(row)
    if row["loss_rel_err"] > DYGRAPH_LOSS_RTOL \
            or max(errs) > DYGRAPH_PARAM_RTOL or not np.isfinite(first) \
            or row["params_moved"] < DYGRAPH_PARAMS:
        failed.append(row)
    del after, s_after, start

    with dg.guard():
        losses = []
        for _ in range(DYGRAPH_WARMUP - 1):
            losses.append(dygraph_step(model, opt, params, img,
                                       label).value.detach())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        host_ms, step_ms = [], []
        for _ in range(DYGRAPH_STEPS):
            s0 = time.perf_counter()
            losses.append(dygraph_step(model, opt, params, img,
                                       label).value.detach())
            host_ms.append((time.perf_counter() - s0) * 1e3)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - s0) * 1e3)
        counts = launch_counts_by_source()
        per_step = {k: c / DYGRAPH_STEPS for k, c in launch_counts().items()}
        peak = torch.cuda.max_memory_allocated()
        peak_reserved = torch.cuda.max_memory_reserved()
        losses = [first] + [float(v.reshape(-1)[0]) for v in losses]
        want = dict.fromkeys(KERNELS, 0.0)
        want["momentum_update"] = float(DYGRAPH_PARAMS)
        med = statistics.median(step_ms)
        emit({"phase": "dygraph", "step": "steps", "card": card_label(env),
              "batch": RESNET_BATCH, "image": RESNET_HW, "losses": losses,
              "step_ms": step_ms, "median_step_ms": med,
              "host_enqueue_ms": host_ms,
              "median_host_enqueue_ms": statistics.median(host_ms),
              "images_per_s": RESNET_BATCH / (med / 1e3),
              "launches_per_step": per_step, "expected": want,
              "peak_memory_allocated_bytes": peak,
              "peak_memory_reserved_bytes": peak_reserved})
        if per_step != want or not all(np.isfinite(losses)):
            failed.append({"launches_per_step": per_step, "want": want,
                           "losses": losses})

        runs = 2
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            s0 = time.perf_counter()
            for _ in range(runs):
                dygraph_step(model, opt, params, img, label)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - s0) * 1e3 / runs
        groups, top = _device_breakdown(prof, runs, _resnet_group)
        busy = sum(groups.values())
        host = sorted((ev for ev in prof.key_averages()
                       if ev.self_cpu_time_total > 0),
                      key=lambda ev: -ev.self_cpu_time_total)
        emit({"phase": "dygraph", "step": "profile", "card": card_label(env),
              "host_top_ops_under_profiler": [
                  {"ms": ev.self_cpu_time_total / 1e3 / runs,
                   "calls": ev.count // runs, "name": ev.key[:60]}
                  for ev in host[:15]],
              "device_ms_per_step": busy if busy else "not measured",
              # the profiler slows the host: against the unprofiled step
              "device_idle_share_of_median_step": (1.0 - busy / med)
              if busy else "not measured",
              "wall_ms_per_profiled_step": wall,
              "device_ms_by_group": groups,
              "launches_by_group": _group_launches(prof, runs,
                                                   _resnet_group),
              "top_kernels": [{"ms": t, "launches": n, "name": k}
                              for t, n, k in top[:15]]})

        # eval: the running statistics, which it leaves as they are
        stats = [(p, p.value.clone()) for k, p in dygraph_named_params(model)
                 if k.endswith(("_mean", "_variance"))]
        model.eval()
        with dg.no_grad():
            logits = model(img)
            ev_loss = dg.varbase.eager_op("mean", {"X": [dg.varbase.eager_op(
                "softmax_with_cross_entropy",
                {"Logits": [logits], "Label": [label]})[1]]})[0]
        ev_loss = float(ev_loss.numpy()[0])
        kept = all(torch.equal(p.value, v) for p, v in stats)
        model.train()
        now = [p.value for p in params]
    with fluid.scope_guard(scope):
        dygraph_to_scope(now, main, scope)
        s_ev = float(exe.run(test, feed=feed, fetch_list=[s_loss])[0][0])
    row = {"phase": "dygraph", "step": "eval", "loss": [ev_loss, s_ev],
           "loss_rel_err": abs(ev_loss - s_ev) / abs(s_ev),
           "tol": DYGRAPH_LOSS_RTOL, "running_statistics_kept": kept}
    emit(row)
    if not kept or row["loss_rel_err"] > DYGRAPH_LOSS_RTOL:
        failed.append(row)
    del scope, exe, now, stats

    # the checkpoint: save_dygraph → load_dygraph → set_dict
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_dygraph_")
    try:
        with dg.guard():
            state = model.state_dict()
            dg.save_dygraph(state, os.path.join(ckpt, "resnet50"))
            loaded, _ = dg.load_dygraph(os.path.join(ckpt, "resnet50"))
            twin = dygraph_resnet(50, 1000)
            twin.set_dict(loaded)
            back = twin.state_dict()
        same = sorted(loaded) == sorted(state) and all(
            loaded[k].dtype == v.dtype and loaded[k].tobytes()
            == v.tobytes() == back[k].tobytes() for k, v in state.items())
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    emit({"phase": "dygraph", "step": "checkpoint round trip",
          "arrays": len(state), "bit_for_bit": same})
    if not same:
        failed.append("the checkpoint round trip is not bit for bit")
    del model, twin, opt, params, img, label
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("dygraph: %s" % failed)
    return counts, groups


@contextlib.contextmanager
def _fresh_op_ids():
    """Eager op ids from 1 again inside the block (the ids salt dropout's
    masks and key NCE's negatives), so two runs draw alike."""
    import itertools

    from paddle_tpu_torch.dygraph import varbase

    saved = varbase._eager_op_ids
    varbase._eager_op_ids = itertools.count(1)
    try:
        yield
    finally:
        varbase._eager_op_ids = saved


def _dygraph_parity_layers(np, fluid, dg):
    """Each case of DYGRAPH_LAYER_CASES and DYGRAPH_DRAWING_CASES on the
    CPU and on the card from the same weights, inputs and op ids → the
    failing rows."""
    from paddle_tpu_torch import convert

    failed = []
    for name, make, inputs in DYGRAPH_LAYER_CASES + DYGRAPH_DRAWING_CASES:
        rng = np.random.RandomState(SEED + 11)
        xs = inputs(rng)
        with dg.guard(fluid.CPUPlace()):
            cpu_layer, probe = make(dg), make(dg)
            with dg.no_grad():
                out = probe(*[dg.to_variable(a) for a in xs])
        out = out[0] if isinstance(out, tuple) else out
        weight = _randn(rng, *out.shape)
        with dg.guard(fluid.CUDAPlace(0)):
            card_layer = make(dg)
        convert.load_layer_state(card_layer, cpu_layer)
        sides = []
        for place, layer in ((fluid.CPUPlace(), cpu_layer),
                             (fluid.CUDAPlace(0), card_layer)):
            with _fresh_op_ids():
                sides.append(dygraph_layer_grads(dg, dg.guard(place), layer,
                                                 xs, weight))
        c, g = sides
        pairs = [("out", g[0], c[0])] + [
            ("grad " + k, g[1][k], c[1][k]) for k in c[1] if k in g[1]] + [
            ("input grad %d" % i, a, b) for i, (a, b) in enumerate(
                zip(g[2], c[2]))]
        errs = _rel_errs([p[1] for p in pairs], [p[2] for p in pairs])
        row = {"phase": "dygraph_parity", "layer": name,
               "compared": len(pairs), "max_err_over_scale": max(errs),
               "worst": pairs[int(np.argmax(errs))][0],
               "tol": DYGRAPH_PARITY_RTOL,
               "same_gradients": sorted(g[1]) == sorted(c[1])
               and len(g[2]) == len(c[2])}
        emit(row)
        if max(errs) > DYGRAPH_PARITY_RTOL or not row["same_gradients"]:
            failed.append(row)
    return failed


def dygraph_mlp(dg):
    """The optimizers' parity model: 12 → 16 (relu) → 4 Linear layers."""

    class Net(dg.Layer):
        def __init__(self):
            super().__init__()
            self.hidden = dg.Linear(12, 16, act="relu")
            self.out = dg.Linear(16, 4)

        def forward(self, x):
            return self.out(self.hidden(x))

    return Net()


def dygraph_train(dg, guard, model, opt, clip, batches):
    """Under ``guard``, a step of ``model`` (of dygraph module ``dg``,
    either package's) per ``(x, y)`` of ``batches``: the squared error's
    mean, ``backward``, ``minimize`` with ``clip``, ``clear_gradients``
    → (losses, {parameter name: [the gradient each update consumed,
    after the clip and the decay]})."""
    import numpy as np

    consumed = {}
    apply = opt._eager_apply

    def recorded(p):
        g = p._grad
        consumed.setdefault(p.name, []).append(np.array(
            g.detach().cpu() if hasattr(g, "detach") else g))
        apply(p)

    opt._eager_apply = recorded
    losses = []
    try:
        with guard:
            params = model.parameters()
            for x, y in batches:
                d = model(dg.to_variable(x)) - dg.to_variable(y)
                loss = dg.varbase.eager_op("mean", {"X": [d * d]})[0]
                loss.backward()
                opt.minimize(loss, parameter_list=params, grad_clip=clip)
                model.clear_gradients()
                losses.append(float(loss.numpy()[0]))
    finally:
        del opt._eager_apply
    return losses, consumed


DYGRAPH_PARITY_OPTIMIZERS = ("SGD", "Momentum", "Adam")
DYGRAPH_PARITY_CLIPS = ("GradClipByValue", "GradClipByNorm",
                        "GradClipByGlobalNorm")


def dygraph_optimizer(fluid, dg, name):
    """``name`` of DYGRAPH_PARITY_OPTIMIZERS with L2 decay 1e-3 and a
    ``PiecewiseDecay`` at most DYGRAPH_PARITY_LR."""
    lr = dg.PiecewiseDecay([1, 2], [DYGRAPH_PARITY_LR, 0.6 *
                                    DYGRAPH_PARITY_LR,
                                    0.2 * DYGRAPH_PARITY_LR], begin=0)
    reg = fluid.regularizer.L2Decay(1e-3)
    if name == "Momentum":
        return fluid.optimizer.Momentum(lr, 0.9, regularization=reg)
    return getattr(fluid.optimizer, name)(lr, regularization=reg)


def dygraph_clip(fluid, name):
    return {"GradClipByValue": lambda c: c.GradClipByValue(0.05),
            "GradClipByNorm": lambda c: c.GradClipByNorm(0.2),
            "GradClipByGlobalNorm": lambda c: c.GradClipByGlobalNorm(0.3)}[
        name](fluid.dygraph_grad_clip)


def _dygraph_parity_optimizers(np, fluid, dg):
    """DYGRAPH_PARITY_STEPS steps of each optimizer with each clip (L2
    decay, a PiecewiseDecay) on the card and on the CPU from one start →
    the failing rows.  Parameters within DYGRAPH_PARITY_RTOL of their
    scale; Adam's elements also get what the two sides' consumed
    gradients explain (:func:`rule_parity_tol` with adamw's bound, ``lr``
    a step)."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    rng = np.random.RandomState(SEED + 12)
    batches = [(_randn(rng, 8, 12), _randn(rng, 8, 4))
               for _ in range(DYGRAPH_PARITY_STEPS)]
    failed = []
    for name in DYGRAPH_PARITY_OPTIMIZERS:
        for clip in DYGRAPH_PARITY_CLIPS:
            models = {}
            for place in (fluid.CPUPlace(), fluid.CUDAPlace(0)):
                with dg.guard(place):
                    models[place._kind] = (place, dygraph_mlp(dg))
            convert.load_layer_state(models["cuda"][1], models["cpu"][1])
            start = models["cpu"][1].state_dict()
            sides = {}
            for kind, (place, model) in models.items():
                reset_launch_counts()
                losses, consumed = dygraph_train(
                    dg, dg.guard(place), model,
                    dygraph_optimizer(fluid, dg, name), dygraph_clip(
                        fluid, clip), batches)
                launches = {k: v for k, v in launch_counts().items() if v}
                sides[kind] = (model, losses, consumed, launches)
            (cm, c_losses, c_used, _), (gm, g_losses, g_used, launches) = \
                sides["cpu"], sides["cuda"]
            worst, n_params = 0.0, 0
            for (key, gp), (_, cp) in zip(dygraph_named_params(gm),
                                          dygraph_named_params(cm)):
                n_params += 1
                a, b = gp.numpy().astype("float64"), \
                    cp.numpy().astype("float64")
                base = DYGRAPH_PARITY_RTOL * float(np.abs(b).max())
                tol = base
                if name == "Adam":
                    tol = rule_parity_tol(
                        "adamw", DYGRAPH_PARITY_LR, start[key],
                        g_used[gp.name], c_used[cp.name], base)
                worst = max(worst, float(np.max(np.abs(a - b) / tol)))
            want = {"SGD": "sgd_update", "Momentum": "momentum_update",
                    "Adam": "adam_update"}[name]
            row = {"phase": "dygraph_parity", "optimizer": name,
                   "clip": clip, "regularization": "L2Decay(1e-3)",
                   "lr": "PiecewiseDecay", "losses": [g_losses, c_losses],
                   "loss_max_rel_err": max(_rel_errs(g_losses, c_losses)),
                   "params_worst_err_over_tol": worst,
                   "param_rtol": DYGRAPH_PARITY_RTOL,
                   "card_launches": launches}
            emit(row)
            if row["loss_max_rel_err"] > DYGRAPH_PARITY_RTOL or worst > 1.0 \
                    or launches != {want: DYGRAPH_PARITY_STEPS * n_params}:
                failed.append(row)
    return failed


def phase_dygraph_parity():
    """The card against the port's CPU: every one of the 20 dygraph
    layers at small widths (DYGRAPH_LAYER_CASES, the drawing ones with
    the same op ids on both sides), forward and the gradients of its
    parameters and inputs; then SGD, Momentum and Adam, each with each
    of the three dygraph clips, L2 decay and a ``PiecewiseDecay``, 3
    steps of a small MLP, their update kernels counted."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dygraph as dg

    failed = _dygraph_parity_layers(np, fluid, dg)
    failed += _dygraph_parity_optimizers(np, fluid, dg)
    if failed:
        raise AssertionError("dygraph parity failed: %s" % failed)


# ---------------------------------------------------------------------------
# the While loop: single-program generation and control-flow parity
# ---------------------------------------------------------------------------

LOOP_BATCH = 8           # child_decode's batch (bench.py:1166-1168)
LOOP_PROMPT = 32         # its prompt length
LOOP_NEW_TOKENS = 64     # its new tokens
LOOP_WARM_RUNS = 3       # warm generations timed, median
LOOP_PARITY_RTOL = 1e-5  # control-flow programs, card vs CPU, of the scale


def _loop_program(gpt, cfg, naive=False, new_tokens=LOOP_NEW_TOKENS):
    from paddle_tpu_torch import unique_name

    unique_name.switch()
    build = gpt.build_naive_program if naive else gpt.build_program
    main, startup, _feeds, tokens, gen_len = build(
        cfg, LOOP_BATCH, LOOP_PROMPT, new_tokens)
    return main, startup, [tokens, gen_len]


def _loop_launches(cfg, trips):
    """A warm generation's launches: in the prefill a causal K1 per
    layer, K2 for each residual add + LN (two a layer) and K3 for wte and
    wpe, which the fusion pass rewrites onto them; one K5 per layer a
    trip.  The loop body is a sub-block, which the fusion pass (as the
    reference's) leaves alone: its lookups, adds and layer norms stay
    the plain ops."""
    from paddle_tpu_torch.ops.cuda import KERNELS

    want = dict.fromkeys(KERNELS, 0)
    want["flash_attention_fwd"] = cfg.layers
    want["fused_dropout_add_ln_fwd"] = 2 * cfg.layers
    want["embedding_gather_fwd"] = 2
    want["flash_decode_fwd"] = cfg.layers * trips
    return want


def _body_replay_ms(torch, exe, calls=20):
    """Device ms of one replay of the loop body's graph, back to back
    (CUDA events around ``calls`` replays): a trip's device time without
    the host's condition read between trips; and the graph's kernel
    nodes.  The replays move the bound counters; the next run binds its
    own values again."""
    from paddle_tpu_torch import executor
    from paddle_tpu_torch.ops.cuda import _lib

    body = next(e for e in exe._cache.values()
                if isinstance(e, executor._LoopBody) and e.graph is not None)
    body.graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        body.graph.replay()
    end.record()
    end.synchronize()
    return (start.elapsed_time(end) / calls,
            len(_lib.graph_kernel_functions(body.graph)))


def _prefix_logits(fluid, gpt, cfg, ids, place, params):
    """Logits [B, L, V] of every position of ``ids`` [B, L] through the
    whole model at once (``build_naive_program``'s forward), on
    ``place``: where the card's and the CPU's greedy tokens part, the
    logits there say whether the CPU's top two were within
    GREEDY_MARGIN."""
    import numpy as np

    from paddle_tpu_torch import convert, layers, unique_name

    unique_name.switch()
    main, startup = fluid.Program(), fluid.Program()
    b, n = ids.shape
    with fluid.program_guard(main, startup):
        x_ids = layers.data("ids", shape=[b, n], dtype="int32",
                            append_batch_size=False)
        x = gpt._embed(x_ids, cfg, "gpt.wte", cfg.vocab)
        pe = gpt._embed(layers.range(0, n, 1, "int32"), cfg, "gpt.wpe",
                        cfg.max_len)
        x = layers.elementwise_add(x, pe, axis=1)
        for li in range(cfg.layers):
            x = gpt._block_full(x, cfg, "gpt.l%d" % li)
        logits = gpt._logits(gpt._ln(x, "gpt.lnf", 2), cfg, 2)
    scope = fluid.Scope()
    convert.load_params_into_scope(params, scope, device=place,
                                   program=main)
    exe = fluid.Executor(place)
    return np.asarray(exe.run(main, feed={"ids": ids}, fetch_list=[logits],
                              scope=scope, use_program_cache=False)[0])


def _loop_vs_cpu(fluid, gpt, cfg, feed, card_toks, cpu_toks, params):
    """Rows where the card's greedy tokens part from the CPU's: those
    whose CPU top-2 margin at the first parting is above GREEDY_MARGIN
    (failures) and those below it (near-ties; the row's later tokens
    follow other contexts and are not compared)."""
    import numpy as np

    rows = [r for r in range(card_toks.shape[0])
            if not np.array_equal(card_toks[r], cpu_toks[r])]
    if not rows:
        return 0, 0, []
    ids = np.concatenate([feed["prompt_ids"], card_toks], axis=1)
    got = _prefix_logits(fluid, gpt, cfg, ids, fluid.CUDAPlace(0), params)
    ref = _prefix_logits(fluid, gpt, cfg, ids, fluid.CPUPlace(), params)
    miss = near = 0
    parts = []
    for r in rows:
        t = int(np.argmax(card_toks[r] != cpu_toks[r]))
        pos = LOOP_PROMPT - 1 + t
        m, n = _greedy_mismatches(got[r, pos][None], ref[r, pos][None])
        miss, near = miss + m, near + n
        parts.append({"row": r, "token": t, "below_margin": bool(n)})
    return miss, near, parts


def phase_decode_loop(env, ring_rates):
    """``models.gpt.build_program`` at GPT-2-small widths (vocab 50257,
    hidden 768, 12 layers, 12 heads, max_len 1024; f32, TF32 off, random
    weights from SEED), batch 8, prompt 32, 64 new tokens, greedy,
    through ``Executor.run`` on the card: one cold generation (the
    body's warm-up trip and capture), then LOOP_WARM_RUNS warm ones
    (every trip replays the body's graph), timed; the trips, condition
    reads and the syncs of one (``set_sync_debug_mode("warn")``), the
    body's run mode, the host ms that enqueue the ops before the loop,
    peak allocated and reserved, and the kernels' launches a generation
    (``_loop_launches``: K1 12, K2 24 and K3 2 in the prefill, K5 12 a
    trip; any other count fails the run).  TTFT is a warm 1-token
    generation of the same prompts.  ``build_naive_program`` on the same
    weights and prompts must give the same tokens (the reference's
    gate), and the port on the CPU the card's tokens wherever the CPU's
    top-2 margin at the first parting is above GREEDY_MARGIN.  Returns the launches of one
    warm generation by source."""
    import statistics
    import warnings

    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.cuda import (launch_counts,
                                           launch_counts_by_source,
                                           reset_launch_counts)

    cfg = gpt.GPT2_SMALL_WIDTHS
    place = fluid.CUDAPlace(0)
    feed = gpt.make_fake_prompt(LOOP_BATCH, LOOP_PROMPT, cfg,
                                np.random.RandomState(SEED + 21))
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    main, startup, fetch = _loop_program(gpt, cfg)
    startup.random_seed = SEED
    exe.run(startup, scope=scope)
    params = {p.name: scope.get(p.name).cpu().numpy()
              for p in main.all_parameters()}

    def generate(program, outs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = exe.run(program, feed=feed, fetch_list=outs, scope=scope)
        wall = time.perf_counter() - t0
        rec = exe.last_loops[0]
        return got, wall, rec, t0

    t_build = time.time()
    toks, cold_s, cold_rec, _ = generate(main, fetch)
    walls, enqueue_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for k in range(LOOP_WARM_RUNS):
        if k == LOOP_WARM_RUNS - 1:
            reset_launch_counts()
        got, wall, rec, t0 = generate(main, fetch)
        walls.append(wall)
        enqueue_ms.append((rec["start_s"] - t0) * 1000.0)
        if not np.array_equal(got[0], toks[0]):
            raise AssertionError("decode_loop: warm generation %d gave "
                                 "other tokens than the cold one" % k)
    counts = launch_counts_by_source()
    total = launch_counts()
    peak = (torch.cuda.max_memory_allocated(),
            torch.cuda.max_memory_reserved())
    trips = rec["trips"]
    want = _loop_launches(cfg, trips)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum(1 for w in caught if "synchroniz" in str(w.message))
    replay_ms, body_kernels = _body_replay_ms(torch, exe)

    one, _s, one_fetch = _loop_program(gpt, cfg, new_tokens=1)
    generate(one, one_fetch)
    ttft = statistics.median(generate(one, one_fetch)[1]
                             for _ in range(LOOP_WARM_RUNS))
    naive, _s, naive_fetch = _loop_program(gpt, cfg, naive=True)
    naive_toks, naive_cold_s, _r, _t = generate(naive, naive_fetch)
    naive_toks, naive_s, naive_rec, _t = generate(naive, naive_fetch)
    del exe
    torch.cuda.empty_cache()

    cpu = fluid.CPUPlace()
    cpu_scope = fluid.Scope()
    cpu_main, _s, cpu_fetch = _loop_program(gpt, cfg)
    convert.load_params_into_scope(params, cpu_scope, device=cpu,
                                   program=cpu_main)
    t0 = time.perf_counter()
    cpu_toks = fluid.Executor(cpu).run(cpu_main, feed=feed,
                                       fetch_list=cpu_fetch,
                                       scope=cpu_scope)[0]
    cpu_s = time.perf_counter() - t0
    miss, near, parts = _loop_vs_cpu(fluid, gpt, cfg, feed, toks[0],
                                     cpu_toks, params)
    n_tok = LOOP_BATCH * LOOP_NEW_TOKENS
    warm = statistics.median(walls)
    result = {
        "phase": "decode_loop", "card": card_label(env),
        "config": "build_program, GPT-2-small widths, batch %d, prompt "
                  "%d, %d new tokens, greedy, f32"
                  % (LOOP_BATCH, LOOP_PROMPT, LOOP_NEW_TOKENS),
        "tokens_equal_naive": bool(np.array_equal(toks[0], naive_toks[0])),
        "cpu_token_mismatches": miss, "cpu_rows_below_margin": near,
        "cpu_partings": parts, "margin": GREEDY_MARGIN,
        "cold_generation_s": cold_s, "warm_generation_s": walls,
        "ttft_ms_warm_1_token": ttft * 1000.0,
        "tokens_per_s_warm": n_tok / warm,
        "decode_tokens_per_s_warm": LOOP_BATCH * (LOOP_NEW_TOKENS - 1)
        / max(warm - ttft, 1e-9),
        "ring_engine_tokens_per_s": ring_rates.get("ring"),
        "ring_engine_note": "DecodeEngine's ring tenant in the decode "
                            "phase: another program (a step per call), "
                            "16 requests of prompts 32-500 on 8 slots",
        "trips": trips, "condition_reads": rec["cond_reads"],
        "syncs_a_generation": syncs,
        "body_mode": rec["mode"], "body_reason": rec["reason"],
        "cold_trips": {k: cold_rec[k] for k in (
            "eager_trips", "captured_trips", "replayed_trips")},
        "warm_trips": {k: rec[k] for k in (
            "eager_trips", "captured_trips", "replayed_trips")},
        "body_copy_backs": rec["copy_backs"],
        "enqueue_ms_before_loop": enqueue_ms,
        "loop_wall_ms": rec["wall_ms"],
        "trip_wall_ms": rec["wall_ms"] / max(trips, 1),
        "body_replay_device_ms": replay_ms,
        "body_graph_kernel_nodes": body_kernels,
        "peak_allocated_bytes": peak[0], "peak_reserved_bytes": peak[1],
        "launches": total, "expected_launches": want,
        "launches_by_source": counts,
        "naive_cold_s": naive_cold_s, "naive_warm_s": naive_s,
        "naive_tokens_per_s": n_tok / naive_s,
        "naive_trips": naive_rec["trips"], "naive_mode": naive_rec["mode"],
        "cpu_generation_s": cpu_s, "build_and_cold_s": time.time() - t_build}
    emit(result)
    if not result["tokens_equal_naive"]:
        raise AssertionError("decode_loop: KV-cache tokens differ from the "
                             "naive program's")
    if miss:
        raise AssertionError("decode_loop: card tokens part from the CPU's "
                             "above the margin: %s" % parts)
    if total != want or rec["mode"] != "graph" \
            or rec["replayed_trips"] != trips \
            or trips != LOOP_NEW_TOKENS - 1:
        raise AssertionError("decode_loop: launches %s != %s, or the body "
                             "ran %s" % (total, want, rec))
    return counts


def control_flow_cases(fluid):
    """The control-flow programs ``control_flow_parity`` runs (and the
    CPU tests): ``(name, build, feeds)``, ``build() -> (main, startup,
    fetch)``; ``While`` bounded and unbounded with gradients, ``cond``,
    ``Switch``, ``IfElse`` with its gradient, the arrays and a gradient
    through one."""
    import numpy as np

    L = fluid.layers

    def param(name, value):
        return fluid.ParamAttr(
            name=name, initializer=fluid.initializer.Constant(value))

    def pow_loop(max_trip):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = L.data("x", shape=[4, 8], dtype="float32",
                       append_batch_size=False)
            y = L.assign(x)
            i = L.fill_constant([1], "float32", 0.0)
            limit = L.data("limit", shape=[1], dtype="float32",
                           append_batch_size=False)
            cond = L.less_than(i, limit)
            w = L.While(cond, max_trip_count=max_trip)
            with w.block():
                L.assign(L.fc(y, size=8, act="tanh",
                              param_attr=param("cf.w", 0.3),
                              bias_attr=param("cf.b", 0.1)), output=y)
                L.increment(i, in_place=True)
                L.less_than(i, limit, cond=cond)
            loss = L.mean(L.elementwise_mul(y, y))
            pg = fluid.backward.append_backward(loss)
        return main, startup, [loss, y] + [g for _, g in pg]

    def branches():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = L.data("x", shape=[4, 8], dtype="float32",
                       append_batch_size=False, stop_gradient=False)
            s = L.data("s", shape=[1], dtype="float32",
                       append_batch_size=False)
            lr = L.fill_constant([1], "float32", 0.0)
            with L.Switch() as switch:
                with switch.case(L.less_than(
                        s, L.fill_constant([1], "float32", 10.0))):
                    L.assign(L.fill_constant([1], "float32", 0.1),
                             output=lr)
                with switch.default():
                    L.assign(L.fill_constant([1], "float32", 0.01),
                             output=lr)
            pred = L.reduce_any(L.greater_than(
                s, L.fill_constant([1], "float32", 5.0)))
            c = L.cond(pred, lambda: L.scale(
                L.fc(x, size=8, param_attr=param("cf.c", 0.2),
                     bias_attr=False), 2.0),
                lambda: L.scale(x, -1.0))
            h = L.fc(x, size=8, param_attr=param("cf.h", 0.15),
                     bias_attr=param("cf.hb", -0.05))
            row = L.greater_than(L.reduce_sum(x, dim=[1], keep_dim=True),
                                 L.fill_constant([1], "float32", 0.0))
            ie = L.IfElse(row)
            with ie.true_block():
                ie.output(L.scale(ie.input(h), 3.0))
            with ie.false_block():
                ie.output(L.scale(ie.input(h), -2.0))
            (merged,) = ie()
            loss = L.mean(L.elementwise_add(c, merged))
            pg = fluid.backward.append_backward(loss)
        return main, startup, [lr, c, merged, loss] + [g for _, g in pg]

    def arrays():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = L.data("x", shape=[4, 8], dtype="float32",
                       append_batch_size=False)
            i = L.fill_constant([1], "int32", 0)
            limit = L.fill_constant([1], "int32", 5)
            acc = L.scale(x, 0.0)
            arr = L.array_write(x, i, capacity=8)
            cond = L.less_than(i, limit)
            w = L.While(cond, max_trip_count=8)
            with w.block():
                prev = L.reshape(L.array_read(arr, i), [4, 8])
                nxt = L.fc(prev, size=8, act="tanh",
                           param_attr=param("cf.a", 0.25), bias_attr=False)
                L.increment(i, value=1, in_place=True)
                L.array_write(nxt, i, array=arr)
                L.assign(L.elementwise_add(acc, nxt), output=acc)
                L.less_than(i, limit, cond=cond)
            whole, _ = L.tensor_array_to_tensor(arr, axis=0)
            n = L.array_length(arr)
            loss = L.mean(acc)
            pg = fluid.backward.append_backward(loss)
        return main, startup, [whole, n, loss] + [g for _, g in pg]

    rng = np.random.RandomState(SEED + 23)
    x = rng.randn(4, 8).astype("float32")
    return [
        ("while bounded", lambda: pow_loop(6),
         [{"x": x, "limit": np.array([n], "float32")} for n in (3, 5)]),
        ("while unbounded", lambda: pow_loop(None),
         [{"x": x, "limit": np.array([n], "float32")} for n in (4, 0)]),
        ("cond, Switch, IfElse", branches,
         [{"x": x, "s": np.array([v], "float32")} for v in (7.0, 20.0,
                                                          2.0)]),
        ("arrays", arrays, [{"x": x}]),
    ]


def control_flow_run(fluid, place, case, runs=2):
    """One case of :func:`control_flow_cases` on ``place``, each feed run
    ``runs`` times (the loop's warm-up, bind and replays) → the fetches
    as numpy, the body modes seen."""
    import numpy as np

    from paddle_tpu_torch import unique_name

    _name, build, feeds = case
    unique_name.switch()
    main, startup, fetch = build()
    startup.random_seed = SEED
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    outs, modes = [], []
    for feed in feeds:
        for _ in range(runs):
            outs.append([np.asarray(v) for v in exe.run(
                main, feed=feed, fetch_list=fetch, scope=scope)])
            modes += [r["mode"] for r in exe.last_loops]
    return outs, modes


def phase_control_flow_parity(env):
    """Each program of :func:`control_flow_cases` on the card and on the
    CPU: every fetch (values, array lengths, gradients) within
    LOOP_PARITY_RTOL of its scale (integers exactly), and every loop
    body on the card replayed from its graph."""
    import numpy as np

    import paddle_tpu_torch as fluid

    failed = []
    for case in control_flow_cases(fluid):
        card, modes = control_flow_run(fluid, fluid.CUDAPlace(0), case)
        cpu, _ = control_flow_run(fluid, fluid.CPUPlace(), case)
        err = 0.0
        for got, want in zip(card, cpu):
            for g, w in zip(got, want):
                if g.dtype.kind in "biu":
                    err = max(err, float(not np.array_equal(g, w)))
                    continue
                scale = max(1.0, float(np.abs(w).max())) if w.size else 1.0
                err = max(err, float(np.abs(g - w).max()) / scale
                          if w.size else 0.0)
        ok = err <= LOOP_PARITY_RTOL and all(m == "graph" for m in modes)
        emit({"phase": "control_flow_parity", "card": card_label(env),
              "case": case[0], "runs": len(card), "max_rel_err": err,
              "tol": LOOP_PARITY_RTOL, "body_modes": sorted(set(modes)),
              "ok": ok})
        if not ok:
            failed.append(case[0])
    if failed:
        raise AssertionError("control_flow_parity failed: %s" % failed)


# the NMT workload at the upstream benchmark's widths
# (benchmark/fluid/models/machine_translation.py: embedding, encoder and
# decoder 512, a dictionary of 30000, beam 3, at most 250 decoding
# steps), the reference harness's batch (benchmark/fluid_benchmark.py:37)
NMT_VOCAB = 30000
NMT_WIDTH = 512
NMT_LEN = 32
NMT_BATCH = 32
NMT_LENGTHS = (8, 32)     # DynamicRNN's target lengths, inclusive
NMT_STEPS = 5             # eager and graph steps compared a trainer
NMT_BEAM = 3
NMT_MAX_LEN = 250
NMT_INFER_BATCH = 16
NMT_WARM_RUNS = 3
RNN_SYNC_STEPS = 3        # graph steps whose host syncs are counted
# models/stacked_dynamic_lstm.build's defaults (vocabulary 5149, length
# 80, embedding and hidden 512, 3 layers), batch 32
LSTM_BATCH = 32
LSTM_LENGTHS = (8, 80)
LSTM_STEPS = 3
# the three programs at small widths, the card against the port on the
# CPU: float32 with TF32 off, 3 Adam steps through recurrences of 8
# steps (max |diff| over max |CPU| of the losses)
RNN_PARITY_RTOL = 1e-4
RNN_PARITY = {"vocab": 1000, "emb": 32, "hidden": 64, "len": 8,
              "batch": 8, "beam": 3, "max_len": 12, "lstm_len": 16}


def _rnn_group(name):
    """The RNN paths' device groups: the GEMMs, the recurrences' and the
    heads' elementwise work, K3 forward and backward, and Adam."""
    g = _kernel_group(name)
    return {"gather": "K3 fwd", "optimizer": "Adam",
            "copies": "elementwise", "other": "elementwise"}.get(g, g)


def _nmt_train_program(fluid, mt, dynamic, vocab=NMT_VOCAB, width=NMT_WIDTH,
                       length=NMT_LEN):
    from paddle_tpu_torch import unique_name

    unique_name.switch()
    build = mt.build_train_dynamic if dynamic else mt.build_train
    main, startup, _feeds, loss = build(vocab, emb_dim=width,
                                        hidden_dim=width, src_len=length,
                                        tgt_len=length)
    main.random_seed = startup.random_seed = SEED
    return main, startup, loss


def nmt_batch(np, rng, vocab, batch, length, lengths=None):
    """Seeded token ids of an NMT batch, with ``tgt_lens`` drawn from the
    inclusive range ``lengths`` when given (DynamicRNN)."""
    feed = {"src": rng.randint(3, vocab, (batch, length)).astype("int64"),
            "tgt_in": rng.randint(3, vocab, (batch, length)).astype("int64"),
            "tgt_out": rng.randint(3, vocab, (batch, length, 1)).astype(
                "int64")}
    if lengths is not None:
        feed["tgt_lens"] = rng.randint(lengths[0], lengths[1] + 1,
                                       (batch,)).astype("int64")
    return feed


def _lstm_program(fluid, sdl, **kw):
    from paddle_tpu_torch import unique_name

    unique_name.switch()
    main, startup, _feeds, loss, acc = sdl.build(**kw)
    main.random_seed = startup.random_seed = SEED
    return main, startup, loss, acc


def lstm_batch(np, rng, vocab, batch, length, lengths):
    return {"words": rng.randint(0, vocab, (batch, length)).astype("int64"),
            "lens": rng.randint(lengths[0], lengths[1] + 1,
                                (batch,)).astype("int64"),
            "label": rng.randint(0, 2, (batch, 1)).astype("int64")}


def _rnn_launches(prog):
    """The kernels' launches of one step of the fusion-resolved ``prog``:
    K3 forward and backward once per rewritten lookup of the global
    block, and the update kernels (``_update_launches``)."""
    ops = prog.global_block().ops
    want = {"embedding_gather_fwd": sum(
        op.type == "fused_embedding_gather" for op in ops),
        "embedding_gather_bwd": sum(
        op.type == "fused_embedding_gather_grad" for op in ops)}
    want.update(_update_launches(prog))
    return {k: v for k, v in want.items() if v}


def _syncs(torch, call, where=None):
    """The host syncs of one ``call()`` (``set_sync_debug_mode``); with a
    list ``where``, each sync's Python file and line are added to it."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    if where is not None:
        where.extend("%s:%d" % (os.path.relpath(w.filename, HERE), w.lineno)
                     for w in syncs)
    return len(syncs)


def _rnn_train_side(torch, fluid, main, startup, fetch, batch, cache, steps,
                    timed):
    """``steps`` steps of a training program from a fresh scope on the
    card → (the fetches, the run modes, a digest of every persistable
    after them, and with ``timed`` the host syncs of one more step that
    fetches nothing to the host and the side's numbers,
    ``_graph_side``)."""
    import numpy as np

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    scope = fluid.Scope()
    out = {}
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup)

        def call(return_numpy=True):
            return exe.run(main, feed=batch, fetch_list=fetch,
                           return_numpy=return_numpy,
                           use_program_cache=cache)

        fetches, modes = [], []
        for _ in range(steps):
            fetches.append([np.asarray(v).copy() for v in call()])
            modes.append(exe.last_run_mode)
        digest = _digest(scope, _persistable_names(main))
        if timed:
            out = _graph_side(exe, call, lambda: call(False), _rnn_group)
            # the count's own syncs: the first switch to "warn" in a
            # process reports one, with no step in it
            out["host_syncs_of_no_step"] = _syncs(torch, lambda: None)
            where = []
            out["host_syncs_a_step"] = [
                _syncs(torch, lambda: call(False), where)
                for _ in range(RNN_SYNC_STEPS)]
            out["host_sync_sites"] = sorted(set(where))
            out["loop_records"] = len(exe.last_loops)
        del call
    del scope, exe
    torch.cuda.empty_cache()
    return fetches, modes, digest, out


def _rnn_train_path(env, phase, label, fluid, main, startup, fetch, batch,
                    steps, tokens):
    """A training program with a ``recurrent`` (or the LSTM ops) and its
    grads, eager against graph from one start on one batch: the fetches
    of ``steps`` steps and every persistable after them must be bit for
    bit; the graph side replays one CUDA graph a step with no host sync
    beyond the fetch, and its kernels' launches a step (graph nodes and
    profiler names) are ``_rnn_launches`` → (the failures, the graph
    side's launches by source)."""
    import torch

    from paddle_tpu_torch.static_analysis import fusion

    prog, report = fusion.resolve_fused_program(
        main, targets=[v.name for v in fetch])
    want = _rnn_launches(prog)
    e_fetch, e_modes, e_digest, _ = _rnn_train_side(
        torch, fluid, main, startup, fetch, batch, False, steps, False)
    g_fetch, g_modes, g_digest, g = _rnn_train_side(
        torch, fluid, main, startup, fetch, batch, True, steps, True)
    same = e_digest == g_digest and all(
        _same_array(a, b) for fa, fb in zip(e_fetch, g_fetch)
        for a, b in zip(fa, fb))
    step_ms = g["step_ms"]
    line = {"phase": phase, "program": label, "card": card_label(env),
            "fused": report.counts(), "bit_identical": same,
            "losses": [float(f[0].reshape(-1)[0]) for f in g_fetch],
            "modes_eager": e_modes, "modes_graph": g_modes,
            "step_ms": step_ms, "tokens_per_s": tokens / (step_ms / 1e3),
            "host_syncs_a_step": g["host_syncs_a_step"],
            "host_sync_sites": g["host_sync_sites"],
            "host_syncs_of_no_step": g["host_syncs_of_no_step"],
            "loop_records": g["loop_records"],
            "expected_launches": want}
    line.update({k: g[k] for k in (
        "enqueue_ms", "step_ms_runs", "device_ms", "idle_share",
        "device_ms_by_group", "top_kernels", "launches_by_wrapper",
        "launches_by_graph_nodes", "profiles", "peak_allocated_bytes",
        "reserved_bytes", "graphs", "last_run_mode")})
    emit(line)
    failed = []
    if not same:
        failed.append("%s: eager and graph differ" % label)
    if g_modes[:2] != ["eager", "capture"] \
            or set(g_modes[2:]) != {"graph"} or g["last_run_mode"] != "graph":
        failed.append("%s: graph side ran %s" % (label, g_modes))
    if any(g["host_syncs_a_step"]) or g["loop_records"]:
        failed.append("%s: host syncs %s (at %s), %d loop records a step"
                      % (label, g["host_syncs_a_step"],
                         g["host_sync_sites"], g["loop_records"]))
    full = {k: float(want.get(k, 0)) for k in g["launches_by_graph_nodes"]}
    if {k: float(v) for k, v in g["launches_by_graph_nodes"].items()} \
            != full or any(g["launches_by_wrapper"].values()):
        failed.append("%s: launches a step %s, wrapper %s != %s"
                      % (label, g["launches_by_graph_nodes"],
                         g["launches_by_wrapper"], want))
    done = [t for t in g["profiles"] if t["complete"]]
    if not done or {k: float(v) for k, v in
                    done[0]["launches_by_profiler"].items()} != full:
        failed.append("%s: the profiler's launches %s != %s"
                      % (label, done[0]["launches_by_profiler"]
                         if done else None, want))
    for f in g_fetch:
        if not all(_finite(v) for v in f):
            failed.append("%s: a fetch is not finite" % label)
            break
    return failed, {"wrapper": g["launches_by_wrapper"],
                    "graph_nodes": g["launches_by_graph_nodes"]}


def _same_array(a, b):
    import numpy as np

    return a.shape == b.shape and a.dtype == b.dtype \
        and np.array_equal(a, b)


def _finite(a):
    import numpy as np

    return a.dtype.kind not in "fc" or bool(np.isfinite(a).all())


def phase_nmt_train(env):
    """``models.machine_translation.build_train`` (StaticRNN decoder) and
    ``build_train_dynamic`` (DynamicRNN decoder, target lengths
    NMT_LENGTHS from SEED) at the upstream widths (embedding, encoder and
    decoder 512, a dictionary of 30000), source and target length 32,
    batch 32, random float32 weights from SEED, Adam: NMT_STEPS steps
    eager and NMT_STEPS through the executor's cache (warm-up, capture,
    replays) from one start, bit for bit on the fetches and every
    persistable (``_rnn_train_path``).  Returns each program's launches
    a step by source."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import machine_translation as mt

    failed, counts = [], {}
    for dynamic in (False, True):
        label = "build_train_dynamic" if dynamic else "build_train"
        main, startup, loss = _nmt_train_program(fluid, mt, dynamic)
        batch = nmt_batch(np, np.random.RandomState(SEED + 31), NMT_VOCAB,
                          NMT_BATCH, NMT_LEN,
                          NMT_LENGTHS if dynamic else None)
        tokens = int(batch["tgt_lens"].sum()) if dynamic \
            else NMT_BATCH * NMT_LEN
        f, counts[label] = _rnn_train_path(
            env, "nmt_train", label, fluid, main, startup, [loss], batch,
            NMT_STEPS, tokens)
        failed += f
    if failed:
        raise AssertionError("nmt_train: %s" % failed)
    return counts


def phase_lstm(env):
    """``models.stacked_dynamic_lstm.build()`` at its defaults (vocabulary
    5149, length 80, embedding and hidden 512, 3 stacked layers, every
    other one reversed), batch 32, lengths LSTM_LENGTHS from SEED, Adam:
    LSTM_STEPS steps eager against LSTM_STEPS graph steps, as
    ``nmt_train``.  Returns the launches a step by source."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import stacked_dynamic_lstm as sdl

    main, startup, loss, acc = _lstm_program(fluid, sdl)
    batch = lstm_batch(np, np.random.RandomState(SEED + 32), 5149,
                       LSTM_BATCH, 80, LSTM_LENGTHS)
    failed, counts = _rnn_train_path(
        env, "lstm", "stacked_dynamic_lstm", fluid, main, startup,
        [loss, acc], batch, LSTM_STEPS, int(batch["lens"].sum()))
    if failed:
        raise AssertionError("lstm: %s" % failed)
    return counts


def _nmt_infer_program(fluid, mt, vocab=NMT_VOCAB, width=NMT_WIDTH,
                       length=NMT_LEN, batch=NMT_INFER_BATCH, beam=NMT_BEAM,
                       max_len=NMT_MAX_LEN):
    from paddle_tpu_torch import unique_name

    unique_name.switch()
    main, startup, _feeds, ids, scores = mt.build_infer(
        vocab, emb_dim=width, hidden_dim=width, src_len=length,
        batch_size=batch, beam_size=beam, max_len=max_len)
    startup.random_seed = SEED
    return main, startup, [ids, scores]


def phase_nmt_translate(env):
    """``models.machine_translation.build_infer`` at the upstream widths,
    batch 16, beam 3, at most 250 decoding steps, random float32 weights
    from SEED: one cold translation (the loop body's warm-up trip and
    capture), then NMT_WARM_RUNS warm ones, timed; the trips, condition
    reads and host syncs of one, the body's run mode, a trip's wall ms
    against one replay of the body's graph, sentences and tokens a
    second, peak memory, and the kernels' launches a translation (K3
    forward once, for the encoder's lookup; the lookup inside the loop
    body stays the plain op, as the fusion pass leaves sub-blocks
    alone).  The warm translations give the cold one's ids; every
    sentence is [beam, max_len] of ids in the vocabulary and its beams'
    scores are finite and in descending order.  Returns the launches of
    one warm translation by source."""
    import statistics

    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import machine_translation as mt
    from paddle_tpu_torch.ops.cuda import (launch_counts_by_source,
                                           reset_launch_counts)
    from paddle_tpu_torch.static_analysis import fusion

    main, startup, fetch = _nmt_infer_program(fluid, mt)
    prog, _report = fusion.resolve_fused_program(
        main, targets=[v.name for v in fetch])
    want = {"embedding_gather_fwd": sum(
        op.type == "fused_embedding_gather"
        for op in prog.global_block().ops)}
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = {"src": np.random.RandomState(SEED + 33).randint(
        3, NMT_VOCAB, (NMT_INFER_BATCH, NMT_LEN)).astype("int64")}

    def translate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        return got, time.perf_counter() - t0, exe.last_loops[0]

    cold, cold_s, cold_rec = translate()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for k in range(NMT_WARM_RUNS):
        if k == NMT_WARM_RUNS - 1:
            reset_launch_counts()
        got, wall, rec = translate()
        walls.append(wall)
        if not all(np.array_equal(a, b) for a, b in zip(got, cold)):
            raise AssertionError("nmt_translate: a warm translation gave "
                                 "other beams than the cold one")
    counts = launch_counts_by_source()
    peak = (torch.cuda.max_memory_allocated(),
            torch.cuda.max_memory_reserved())
    no_step = _syncs(torch, lambda: None)
    where = []
    syncs = _syncs(torch, lambda: exe.run(main, feed=feed,
                                          fetch_list=fetch, scope=scope),
                   where)
    replay_ms, body_kernels = _body_replay_ms(torch, exe)
    ids, scores = got
    trips = rec["trips"]
    warm = statistics.median(walls)
    launched = {k: counts["wrapper"][k] + counts["graph_nodes"][k]
                for k in counts["wrapper"]}
    line = {"phase": "nmt_translate", "card": card_label(env),
            "config": "build_infer, vocab %d, width %d, src_len %d, batch "
                      "%d, beam %d, max_len %d, f32"
                      % (NMT_VOCAB, NMT_WIDTH, NMT_LEN, NMT_INFER_BATCH,
                         NMT_BEAM, NMT_MAX_LEN),
            "trips": trips, "condition_reads": rec["cond_reads"],
            "host_syncs_a_translation": syncs,
            "host_sync_sites": sorted(set(where)),
            "host_syncs_of_no_call": no_step,
            "body_mode": rec["mode"], "body_reason": rec["reason"],
            "cold_trips": {k: cold_rec[k] for k in (
                "eager_trips", "captured_trips", "replayed_trips")},
            "warm_trips": {k: rec[k] for k in (
                "eager_trips", "captured_trips", "replayed_trips")},
            "cold_s": cold_s, "warm_s": walls,
            "loop_wall_ms": rec["wall_ms"],
            "trip_wall_ms": rec["wall_ms"] / max(trips, 1),
            "body_replay_device_ms": replay_ms,
            "body_graph_kernel_nodes": body_kernels,
            "sentences_per_s": NMT_INFER_BATCH / warm,
            "tokens_per_s": NMT_INFER_BATCH * trips / warm,
            "peak_allocated_bytes": peak[0], "peak_reserved_bytes": peak[1],
            "launches": launched, "expected_launches": want,
            "launches_by_source": counts,
            "ids_shape": list(ids.shape),
            "best_scores": scores[:4, 0].tolist()}
    emit(line)
    failed = []
    if rec["mode"] != "graph" or rec["replayed_trips"] != trips:
        failed.append("the body ran %s" % rec)
    if launched != dict({k: 0 for k in launched}, **want):
        failed.append("launches %s != %s" % (launched, want))
    if list(ids.shape) != [NMT_INFER_BATCH, NMT_BEAM, NMT_MAX_LEN] \
            or ids.min() < 0 or ids.max() >= NMT_VOCAB \
            or not np.isfinite(scores).all() \
            or (np.diff(scores, axis=1) > 0).any():
        failed.append("beams out of shape, range or order: ids %s, scores "
                      "%s" % (ids.shape, scores[:2]))
    del exe, scope
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("nmt_translate: %s" % failed)
    return counts


def rnn_parity_cases(fluid, np):
    """The three programs at RNN_PARITY's widths: ``(name, build, feed,
    steps)``, ``build() -> (main, startup, fetch)``; the trainers take
    ``steps`` Adam steps, the translation runs twice."""
    from paddle_tpu_torch.models import machine_translation as mt
    from paddle_tpu_torch.models import stacked_dynamic_lstm as sdl

    p = RNN_PARITY
    rng = np.random.RandomState(SEED + 34)
    cases = []
    for dynamic in (False, True):
        def build(dynamic=dynamic):
            main, startup, loss = _nmt_train_program(
                fluid, mt, dynamic, p["vocab"], p["emb"], p["len"])
            return main, startup, [loss]

        cases.append(("build_train_dynamic" if dynamic else "build_train",
                      build, nmt_batch(np, rng, p["vocab"], p["batch"],
                                       p["len"], (2, p["len"])
                                       if dynamic else None), 3))

    def lstm():
        main, startup, loss, acc = _lstm_program(
            fluid, sdl, vocab_size=p["vocab"], seq_len=p["lstm_len"],
            emb_dim=p["emb"], hidden_dim=p["hidden"])
        return main, startup, [loss, acc]

    cases.append(("stacked_dynamic_lstm", lstm,
                  lstm_batch(np, rng, p["vocab"], p["batch"], p["lstm_len"],
                             (2, p["lstm_len"])), 3))

    def infer():
        main, startup, fetch = _nmt_infer_program(
            fluid, mt, p["vocab"], p["emb"], p["len"], p["batch"],
            p["beam"], p["max_len"])
        return main, startup, fetch

    cases.append(("build_infer", infer, {"src": rng.randint(
        3, p["vocab"], (p["batch"], p["len"])).astype("int64")}, 2))
    return cases


def rnn_parity_run(fluid, place, case, start=None):
    """One case of :func:`rnn_parity_cases` on ``place``, from the
    persistables ``start`` (the startup's own when None) → (the fetches
    of each call, the start)."""
    import numpy as np

    from paddle_tpu_torch import convert

    _name, build, feed, calls = case
    main, startup, fetch = build()
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    if start is None:
        start = convert.scope_persistables(main, scope)
    else:
        convert.load_params_into_scope(start, scope, place, program=main)
    outs = [[np.asarray(v) for v in exe.run(main, feed=feed,
                                            fetch_list=fetch, scope=scope)]
            for _ in range(calls)]
    return outs, start


def phase_rnn_parity(env):
    """The NMT trainers, the stacked LSTM and the NMT translation at
    RNN_PARITY's widths, on the card (through the executor's cache:
    warm-up, capture, replay) and on the CPU from the card's start:
    losses and accuracies within RNN_PARITY_RTOL of their scale, and the
    translation's beam ids equal (the partings are counted, printed and
    held to 0) and its scores within RNN_PARITY_RTOL."""
    import numpy as np

    import paddle_tpu_torch as fluid

    failed = []
    for case in rnn_parity_cases(fluid, np):
        card, start = rnn_parity_run(fluid, fluid.CUDAPlace(0), case)
        cpu, _ = rnn_parity_run(fluid, fluid.CPUPlace(), case, start)
        err, partings = 0.0, 0
        for got, want in zip(card, cpu):
            for g, w in zip(got, want):
                if g.dtype.kind in "biu":
                    partings += int((g != w).sum())
                    continue
                scale = max(1.0, float(np.abs(w).max()))
                err = max(err, float(np.abs(g - w).max()) / scale)
        ok = err <= RNN_PARITY_RTOL and partings == 0
        emit({"phase": "rnn_parity", "card": card_label(env),
              "program": case[0], "widths": RNN_PARITY, "calls": case[3],
              "card_first": [float(np.asarray(v).reshape(-1)[0])
                             for v in card[0]],
              "max_rel_err": err, "id_partings": partings,
              "tol": RNN_PARITY_RTOL, "ok": ok})
        if not ok:
            failed.append(case[0])
    if failed:
        raise AssertionError("rnn_parity failed: %s" % failed)


def telemetry_run(fluid, pred, requests, train, steps,
                  heartbeat_s=HEARTBEAT_S):
    """Under the telemetry directory the caller set: ``requests`` served
    one by one through a default ``PredictorServer`` over ``pred``, then
    ``train = (main, startup, feed, fetch, place)`` run for its startup
    and ``steps`` steps on a fresh executor while a ``HeartbeatWriter``
    beats for rank 0; the journal, the spans and a metrics snapshot
    flushed → (what ran, the writer, still beating)."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.resilience import HeartbeatWriter

    dirname = obs.journal_dir()
    served_from = pred._exe._step
    # every request queued before the dispatcher starts: the batches do
    # not depend on how fast this thread submits (a started server may
    # take each request alone, and then the predictor's steps, not the
    # training's, are the newest the journal and the heartbeat hold)
    server = serving.PredictorServer({"bert": pred}, auto_start=False)
    futures = [server.submit("bert", r, request_id="req%d" % i)
               for i, r in enumerate(requests)]
    server.start()
    outs = [f.result(timeout=TOOLS_TIMEOUT)[0] for f in futures]
    server.close()
    main, startup, feed, fetch, place = train
    writer = HeartbeatWriter(dirname, rank=0, interval=heartbeat_s).start()
    exe = fluid.Executor(place)
    exe.run(startup)
    losses = [float(exe.run(main, feed=feed, fetch_list=fetch)[0][0])
              for _ in range(steps)]
    writer.beat()  # the newest step in the payload now
    obs.get_journal().flush()
    obs.get_tracer().flush()
    obs.write_metrics_snapshot(os.path.join(
        dirname, "metrics-r0-%d.json" % os.getpid()))
    ran = {"requests": len(outs), "served_calls": pred._exe._step
           - served_from, "train_calls": exe._step, "losses": losses,
           "last_step": max(exe._step, pred._exe._step) - 1,
           "outputs_finite": all(bool((o == o).all()) for o in outs)}
    return ran, writer


def check_tools(status, serving, ran):
    """What the monitor's status and trace's serving view must say of a
    :func:`telemetry_run` → the failures."""
    failed = []
    rank = (status.get("ranks") or {}).get("0") or {}
    steps_journaled = (status.get("event_counts") or {}).get("step")
    if status.get("steps") != ran["last_step"] \
            or steps_journaled != ran["served_calls"] + ran["train_calls"]:
        failed.append("monitor steps %s / %s step events, ran %s"
                      % (status.get("steps"), steps_journaled, ran))
    if not rank.get("alive") or rank.get("wedged"):
        failed.append("rank 0 not alive or wedged: %s" % rank)
    if not serving or serving.get("requests") != ran["requests"]:
        failed.append("trace saw %s requests, sent %d"
                      % ((serving or {}).get("requests"), ran["requests"]))
    phases = (serving or {}).get("phases") or {}
    for name in ("serving.request", "serving.queue_wait", "serving.device"):
        if not all(isinstance(phases.get(name, {}).get(k), float)
                   for k in ("p50_ms", "p99_ms")):
            failed.append("trace has no p50/p99 of %s" % name)
    return failed


def phase_tools(env, pred, cfg):
    """The operator's two CLIs on a served run and a training run of the
    card: TOOLS_REQUESTS one-row BERT-base requests through a default
    ``PredictorServer`` over the main path's predictor and TOOLS_STEPS
    steps of a 2-layer BERT-base-width MLM program (T=128, batch 2, Adam)
    under one temporary ``PADDLE_TPU_TELEMETRY_DIR`` (every step
    journaled), a ``HeartbeatWriter`` beating; then ``tools.monitor
    --once --json``, ``tools.trace --serving --json`` and one alert that
    must trip and one that must not, as subprocesses; the directory is
    deleted afterwards."""
    import copy

    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.models import bert

    rng = np.random.RandomState(SEED + 11)
    requests = [_bert_request(rng, 1, cfg) for _ in range(TOOLS_REQUESTS)]
    tcfg = copy.copy(bert.BERT_BASE)
    tcfg.layers = 2
    with fluid.unique_name.guard():
        main, startup, loss = _train_program(fluid, bert, tcfg, TOOLS_SEQ)
    feed = bert.make_fake_batch(2, TOOLS_SEQ, tcfg, rng)
    dirname = tempfile.mkdtemp(prefix="chip_smoke_telemetry_")
    writer = None
    try:
        with _env_var("PADDLE_TPU_TELEMETRY_DIR", dirname), \
                _env_var("PADDLE_TPU_TELEMETRY_STEP_EVERY", "1"):
            obs.reset_telemetry()
            ran, writer = telemetry_run(
                fluid, pred, requests,
                (main, startup, feed, [loss], fluid.CUDAPlace(0)),
                TOOLS_STEPS)
        py = [sys.executable, "-m"]
        cmds = {"monitor": py + ["paddle_tpu_torch.tools.monitor", dirname,
                                 "--once", "--json"],
                "trace": py + ["paddle_tpu_torch.tools.trace", dirname,
                               "--serving", "--json"],
                "alert_trips": py + ["paddle_tpu_torch.tools.monitor",
                                     dirname, "--once", "--json", "--alert",
                                     "steps>0"],
                "alert_holds": py + ["paddle_tpu_torch.tools.monitor",
                                     dirname, "--once", "--json", "--alert",
                                     "lost_ranks>0"]}
        child_env = dict(os.environ, PYTHONPATH=HERE)
        t0 = time.time()
        procs = {k: subprocess.Popen(c, cwd=HERE, env=child_env,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
                 for k, c in cmds.items()}
        done = {}
        for k, p in procs.items():
            try:
                out, err = p.communicate(timeout=TOOLS_TIMEOUT)
            finally:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            done[k] = (p.returncode, out, err)
        cli_s = time.time() - t0
    finally:
        if writer is not None:
            writer.stop()
        obs.reset_telemetry()
        shutil.rmtree(dirname, ignore_errors=True)
    status = json.loads(done["monitor"][1])
    serving = json.loads(done["trace"][1])
    codes = {k: v[0] for k, v in done.items()}
    failed = check_tools(status, serving, ran)
    if codes != {"monitor": 0, "trace": 0, "alert_trips": 1,
                 "alert_holds": 0}:
        failed.append("exit codes %s" % codes)
    emit({"phase": "tools", "card": card_label(env), "ran": ran,
          "exit_codes": codes, "cli_seconds_parallel": cli_s,
          "monitor": {k: status.get(k) for k in (
              "steps", "step_rate", "p50_step_ms", "p99_step_ms",
              "p50_serving_latency_ms", "p99_serving_latency_ms",
              "serving_requests", "ranks", "alive_ranks", "lost_ranks",
              "skip_rate", "checkpoint_age_s", "quant_error")},
          "trace_serving": serving,
          "stderr": {k: v[2][-400:] for k, v in done.items()}})
    if failed:
        raise AssertionError("tools: %s" % failed)


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
    # a run-local autotune cache, empty at the start: no decision an
    # earlier run recorded routes this one (the main paths run at the
    # hand-set threshold; the autotune phase records the card's own)
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    os.environ["PADDLE_TPU_AUTOTUNE_CACHE"] = os.path.join(
        tune_dir, "autotune.json")
    try:
        return _run_phases(torch)
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)


def _timed(seconds, phase, *args):
    """``phase(*args)``, its wall seconds recorded under its name."""
    t0 = time.time()
    try:
        return phase(*args)
    finally:
        seconds[phase.__name__] = time.time() - t0


def _run_phases(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    seconds = {}
    env = _timed(seconds, phase_environment)
    build = _timed(seconds, phase_build)
    if not build["hmma_per_kernel"] or not all(
            build["hmma_per_kernel"].values()):
        raise AssertionError("no HMMA instruction in a K1 forward kernel: "
                             "%s" % build["hmma_per_kernel"])
    regs = build["registers"]  # a note instead when found built
    spills = [r for r in (regs if isinstance(regs, list) else [])
              if any(n in r["kernel"] for n in NO_SPILL)
              and (r["spill_stores"] or r["spill_loads"])]
    if spills:
        raise AssertionError("K2 or decode kernels spill: %s"
                             % spills)
    rows = _timed(seconds, phase_kernels)
    _timed(seconds, phase_amp_kernels)
    serve_counts, pred, cfg = _timed(seconds, phase_main_path, env)
    _timed(seconds, phase_profile, env, pred, cfg)
    _timed(seconds, phase_profiler, env, pred, cfg)
    _timed(seconds, phase_graph_serve, env, pred, cfg)
    serve_bf16_counts = _timed(seconds, phase_serve_bf16, env, pred, cfg)
    _timed(seconds, phase_tools, env, pred, cfg)
    del pred
    train_counts = _timed(seconds, phase_train, env)
    _timed(seconds, phase_train_parity)
    train_amp_counts = _timed(seconds, phase_train_amp, env)
    _timed(seconds, phase_train_amp_parity)
    decode_counts, decode_rates = _timed(seconds, phase_decode, env)
    _timed(seconds, phase_decode_parity)
    loop_counts = _timed(seconds, phase_decode_loop, env, decode_rates)
    _timed(seconds, phase_control_flow_parity, env)
    nmt_counts = _timed(seconds, phase_nmt_train, env)
    lstm_counts = _timed(seconds, phase_lstm, env)
    translate_counts = _timed(seconds, phase_nmt_translate, env)
    _timed(seconds, phase_rnn_parity, env)
    _timed(seconds, phase_sampled, env, decode_rates)
    _timed(seconds, phase_serve, env)
    resnet_counts, resnet_groups = _timed(seconds, phase_resnet, env)
    _timed(seconds, phase_resnet_parity)
    resnet_amp_counts = _timed(seconds, phase_resnet_amp, env, resnet_groups)
    _timed(seconds, phase_resnet_amp_parity)
    _timed(seconds, phase_graph, env)
    _timed(seconds, phase_quant)
    dp_counts = _timed(seconds, phase_dp, env)
    _timed(seconds, phase_verify, env)
    _timed(seconds, phase_fusion, env)
    _timed(seconds, phase_autotune, env)
    recipe_counts = _timed(seconds, phase_train_recipe, env)
    _timed(seconds, phase_train_recipe_parity)
    _timed(seconds, phase_recompute, env)
    _timed(seconds, phase_optimizers, env)
    _timed(seconds, phase_optimizers_parity)
    _timed(seconds, phase_averaging, env)
    dygraph_counts, _ = _timed(seconds, phase_dygraph, env)
    _timed(seconds, phase_dygraph_parity)
    from paddle_tpu_torch.ops.cuda import KERNELS

    # each path's launches by source: the wrappers' launches that ran at
    # once and the kernel nodes that graph replays ran (the dp ranks run
    # eagerly: a collective is not capturable)
    paths = {"serve": serve_counts, "train": train_counts,
             "decode_ring": decode_counts["ring"],
             "decode_paged": decode_counts["paged"],
             "resnet": resnet_counts,
             "dp": {"wrapper": dp_counts,
                    "graph_nodes": dict.fromkeys(KERNELS, 0)},
             "serve_bf16": serve_bf16_counts, "train_amp": train_amp_counts,
             "resnet_amp": resnet_amp_counts, "train_recipe": recipe_counts,
             "dygraph": dygraph_counts, "decode_loop": loop_counts,
             "nmt_train": nmt_counts["build_train"],
             "nmt_train_dynamic": nmt_counts["build_train_dynamic"],
             "lstm": lstm_counts, "nmt_translate": translate_counts}
    for r in rows:
        # the decode path's launches (ring + paged runs) where it runs the
        # kernel, else the BERT training path's (the backward kernels),
        # else the ResNet training path's (K4), else the dygraph ResNet's
        # (eager Momentum), else the data-parallel path's (K7: rank 0's
        # quant twin); launches_by_path has every path's
        # (the multi-tensor and SGD kernels run on no main path: the
        # optimizer fusion's gate keeps BERT-base's Adam per parameter)
        name = r["name"]
        r["launches_by_path"] = {
            p: c["wrapper"][name] + c["graph_nodes"][name]
            for p, c in sorted(paths.items())}
        for label in ("decode", "train", "resnet", "dygraph", "dp", "none"):
            if label == "none":
                wrapper = nodes = 0
                break
            run = [paths[p] for p in (("decode_ring", "decode_paged")
                                      if label == "decode" else (label,))]
            wrapper = sum(c["wrapper"][name] for c in run)
            nodes = sum(c["graph_nodes"][name] for c in run)
            if wrapper + nodes:
                break
        r["launches"] = wrapper + nodes
        r["launches_by_wrapper"] = wrapper
        r["launches_by_graph_nodes"] = nodes
        r["launches_path"] = label
    emit(dict({"phase": "launches"}, **paths))
    emit({"phase": "seconds", "by_phase": seconds,
          "total": sum(seconds.values())})
    emit({"kernels": [{k: r[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "launches_by_wrapper", "launches_by_graph_nodes", "launches_path",
        "launches_by_path")
        if k in r}
        for r in rows]})
    print(env["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
