"""Data-parallel training of the PyTorch port against the reference: the
collective ops, ``GradAllReduce``, the fusion ``allreduce`` family and
the int8 ``quantized_allreduce``.

The reference runs its collectives under ``shard_map`` on the conftest's
8-device CPU mesh (each worker interprets the transpiled program with
``ctx.collective_axis``, as its own tests and ``bench.py``'s quant arm
do).  The port runs one process per rank, spawned with
``torch.multiprocessing`` over a gloo group whose ``file://`` store lies
in ``tmp_path`` (no ports, so xdist workers cannot collide); each spawn
has its own timeout.  The worker functions at the top import nothing of
JAX or the reference, so a spawned rank loads only torch and the port;
the reference is imported inside the tests.
"""

import collections
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.static_analysis import fusion as tfusion
from paddle_tpu_torch.transpiler import GradAllReduce as TGradAllReduce

SPAWN_TIMEOUT = 240     # seconds, per spawn
# the MLP's twins against the reference's shard_map run: the same ops on
# float32 in another summation order (oneDNN/ATen against XLA)
MLP_RTOL = 1e-5         # max |diff| over max |ref|, losses and params
# quantized_allreduce against the reference's jitted collective: XLA
# fuses its dequant-sum and rounds it its own way
QUANT_OUT_RTOL = 1e-6   # max |diff| over max |ref|
# bert-tiny, dropout 0: two ranks of 2 rows against one process of 4;
# the mean over the batch is taken in two halves, then averaged
BERT_DP_RTOL = 1e-5
# a gradient that is zero in exact arithmetic (the attention key bias:
# softmax ignores a shift shared by every key) is rounding noise; it is
# held relative to this share of the step's largest gradient
NULL_GRAD_FLOOR = 1e-3
QUANT_LOSS_GATE = 1e-3  # the reference's own gate (bench.py:1950-1954)
MLP_STEPS = 3
BERT_STEPS = 2


# ---------------------------------------------------------------------------
# spawned ranks (torch and the port only)
# ---------------------------------------------------------------------------

def _init(rank, nranks, store):
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=nranks)


def _dump(out_dir, rank, obj):
    with open(os.path.join(out_dir, "rank%d.pkl" % rank), "wb") as f:
        pickle.dump(obj, f)


def _collective_worker(rank, nranks, store, cases, out_dir):
    """quantized_allreduce over the 4-rank world and over ranks {0, 1};
    the dense sum over the world."""
    from paddle_tpu_torch.ops import comm
    from paddle_tpu_torch.quant import quantized_allreduce

    _init(rank, nranks, store)
    try:
        pair = dist.new_group([0, 1])
        out = {}
        for key, xs in cases.items():
            n, _numel, dtype = key
            if n == 2 and rank >= 2:
                continue
            x = torch.from_numpy(xs[rank])
            if dtype == "bfloat16":
                x = x.to(torch.bfloat16)
            got = quantized_allreduce(x, pair if n == 2 else None)
            out[key] = (str(got.dtype), got.float().numpy())
        out["dense"] = comm.all_reduce_sum(
            torch.from_numpy(cases[(4, 1000, "float32")][rank]), None
        ).numpy()
        _dump(out_dir, rank, out)
    finally:
        dist.destroy_process_group()


def _mlp_program(fluid, grad_allreduce, rank, nranks, quant):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=32, act="relu")
        logits = fluid.layers.fc(input=h, size=4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    grad_allreduce().transpile(program=main, startup_program=startup,
                               rank=rank, nranks=nranks)
    main._num_trainers = nranks
    if quant:
        main._quant_buckets = {"min_bytes": 1}
    return main, startup, loss


def _grad_names(main):
    """param name → the gradient var its optimizer op reads."""
    return {op.inputs["Param"][0]: op.inputs["Grad"][0]
            for op in main.global_block().ops
            if op.attrs.get("op_role") == "optimize" and op.input("Grad")}


def _train(exe, main, scope, loss, feeds):
    """Steps of ``main`` → (losses, the exchanged gradients and the
    persistables after each step)."""
    grads = sorted(_grad_names(main).items())
    losses, gsteps, states = [], [], []
    for feed in feeds:
        out = exe.run(main, feed=feed,
                      fetch_list=[loss] + [g for _, g in grads])
        losses.append(float(out[0][0]))
        gsteps.append({p: v for (p, _), v in zip(grads, out[1:])})
        states.append(convert.scope_persistables(main, scope))
    return losses, gsteps, states


def _train_twins(rank, build, params, feeds, steps):
    """Run the dense and the quant twin of ``build(quant)`` from
    ``params``; per twin the losses, the exchanged gradients and the
    persistables after each step, and the fused op types."""
    out = {}
    for twin in ("dense", "quant"):
        main, startup, loss = build(twin == "quant")
        scope = tfluid.Scope()
        with tfluid.scope_guard(scope):
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup)
            convert.load_params_into_scope(params, scope, "cpu",
                                           program=main)
            losses, grads, states = _train(
                exe, main, scope, loss, [f[rank] for f in feeds[:steps]])
        fused, _ = tfusion.resolve_fused_program(main, targets=[loss.name])
        out[twin] = {"losses": losses, "grads": grads, "states": states,
                     "ops": [op.type for op in fused.global_block().ops
                             if "allreduce" in op.type]}
    return out


def _mlp_worker(rank, nranks, store, params, feeds, out_dir):
    _init(rank, nranks, store)
    try:
        _dump(out_dir, rank, _train_twins(
            rank,
            lambda quant: _mlp_program(tfluid, TGradAllReduce, rank, nranks,
                                       quant),
            params, feeds, MLP_STEPS))
    finally:
        dist.destroy_process_group()


def _bert_program(rank, nranks, quant, bucket_mb):
    from paddle_tpu_torch.models import bert

    with tfluid.unique_name.guard():
        main, startup, _feeds, loss = bert.build_pretrain(
            _bert_cfg(bert), seq_len=BERT_SEQ, lr=1e-3)
    main.random_seed = startup.random_seed = 5
    if nranks > 1:
        TGradAllReduce().transpile(program=main, startup_program=startup,
                                   rank=rank, nranks=nranks)
        main._num_trainers = nranks
        main._allreduce_bucket_mb = bucket_mb
    if quant:
        main._quant_buckets = {"min_bytes": 1}
    return main, startup, loss


BERT_SEQ = 32
BERT_BATCH = 4
BERT_BUCKET_MB = 0.25   # several buckets out of bert-tiny's ~2.3 MB


def _bert_cfg(bert):
    import copy

    cfg = copy.copy(bert.BERT_TINY)
    cfg.dropout = cfg.attn_dropout = 0.0
    return cfg


def _bert_worker(rank, nranks, store, params, feeds, out_dir):
    _init(rank, nranks, store)
    try:
        _dump(out_dir, rank, _train_twins(
            rank,
            lambda quant: _bert_program(rank, nranks, quant, BERT_BUCKET_MB),
            params, feeds, BERT_STEPS))
    finally:
        dist.destroy_process_group()


def _spawn(fn, nranks, tmp_path, *args):
    """Run ``fn(rank, nranks, store, *args, out_dir)`` in ``nranks``
    spawned processes; → the per-rank results, in rank order."""
    ctx = mp.get_context("spawn")
    store = str(tmp_path / "store")
    out_dir = str(tmp_path)
    procs = [ctx.Process(target=fn, args=(r, nranks, store) + args
                         + (out_dir,)) for r in range(nranks)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(SPAWN_TIMEOUT)
        alive = [p.pid for p in procs if p.is_alive()]
        assert not alive, "ranks still running after %ds: %s" % (
            SPAWN_TIMEOUT, alive)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert [p.exitcode for p in procs] == [0] * nranks, \
        [p.exitcode for p in procs]
    out = []
    for r in range(nranks):
        with open(os.path.join(out_dir, "rank%d.pkl" % r), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# (a) quantized_allreduce against the reference under shard_map
# ---------------------------------------------------------------------------

def _reference_composite(xs, n, dtype):
    """The reference's eager primitives (``block_quantize``,
    ``block_dequantize``, with ``kernel=False`` as its collective pins
    them) composed as ``quantized_allreduce`` prescribes: pad to n·B,
    quantize per rank, dequantize each rank's chunk from every peer and
    add in ascending rank order, requantize, gather, dequantize, trim,
    cast."""
    import jax.numpy as jnp

    from paddle_tpu.quant import block_dequantize, block_quantize
    from paddle_tpu.quant.blockwise import padded_size, quant_block

    b = quant_block()
    numel = xs.shape[1]
    npad = padded_size(numel, n * b)
    chunk = npad // n
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    qs = []
    for r in range(n):
        x = jnp.asarray(xs[r]).astype(jdt).astype(jnp.float32)
        qs.append(block_quantize(jnp.pad(x, (0, npad - numel)), block=b,
                                 kernel=False))
    gathered = []
    for r in range(n):
        part = None
        for q, s in qs:
            d = block_dequantize(q[r * chunk:(r + 1) * chunk],
                                 s[r * chunk // b:(r + 1) * chunk // b],
                                 kernel=False)
            part = d if part is None else part + d
        gathered.append(block_quantize(part, block=b, kernel=False))
    out = jnp.concatenate([block_dequantize(q, s, kernel=False)
                           for q, s in gathered])
    return np.asarray(out[:numel].astype(jdt).astype(jnp.float32))


def test_quantized_allreduce_matches_reference(tmp_path):
    """n = 4 over the world and n = 2 over a subgroup, numel 4096, 1000
    and 7, float32 and bfloat16: every port rank holds the same bits, and
    they are the bits of the reference's own quantize and dequantize
    composed as its collective prescribes; against the reference's
    collective itself (jitted under shard_map, where XLA fuses the
    dequant-sum and rounds it its own way) within 1e-6.  The dtype is
    kept; the dense sum is the exact sum on every rank."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from paddle_tpu.jax_compat import shard_map
    from paddle_tpu.quant import quantized_allreduce as jqar

    rng = np.random.RandomState(0)
    cases = {}
    for n in (4, 2):
        for numel in (4096, 1000, 7):
            cases[(n, numel, "float32")] = rng.randn(4, numel).astype(
                "float32")
    cases[(2, 1000, "bfloat16")] = rng.randn(4, 1000).astype("float32")
    got = _spawn(_collective_worker, 4, tmp_path, cases)

    for (n, numel, dtype), xs in cases.items():
        mesh = Mesh(np.array(jax.devices()[:n]), ("d",))
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        f = jax.jit(shard_map(
            lambda x, _dt=jdt: jqar(x[0].astype(_dt), "d")[None],
            mesh=mesh, in_specs=P("d"), out_specs=P("d")))
        want = np.asarray(f(jnp.asarray(xs[:n])).astype(jnp.float32))
        outs = [got[r][(n, numel, dtype)] for r in range(n)]
        assert all(o[0] == "torch.%s" % dtype for o in outs), outs
        for r in range(1, n):
            assert np.array_equal(outs[r][1], outs[0][1]), (n, numel, r)
        assert np.array_equal(outs[0][1],
                              _reference_composite(xs, n, dtype)), \
            (n, numel, dtype)
        assert _rel(outs[0][1], want[0]) <= QUANT_OUT_RTOL, (n, numel,
                                                             dtype)
    dense = cases[(4, 1000, "float32")].sum(axis=0)
    for r in range(4):
        np.testing.assert_allclose(got[r]["dense"], dense, rtol=1e-6,
                                   atol=1e-6)
    assert all(np.array_equal(got[r]["dense"], got[0]["dense"])
               for r in range(4))


# ---------------------------------------------------------------------------
# (b) the transpile and the fusion family, both packages (build only)
# ---------------------------------------------------------------------------

def _ops(program):
    return [(op.type, {k: v for k, v in op.attrs.items()
                       if not k.startswith("__") and k != "op_namescope"},
             dict(op.inputs), dict(op.outputs))
            for op in program.global_block().ops]


def test_grad_allreduce_transpiles_like_the_reference():
    """The same main and startup programs, op for op with attrs and
    slots: one ``c_allreduce_sum`` (pre_scale 1/nranks) after each
    parameter gradient's producer, one ring's bootstrap pair."""
    import paddle_tpu as jfluid
    from paddle_tpu.transpiler.collective import GradAllReduce

    for nranks in (2, 4):
        j = _mlp_program(jfluid, GradAllReduce, 1, nranks, False)
        t = _mlp_program(tfluid, TGradAllReduce, 1, nranks, False)
        assert _ops(t[0]) == _ops(j[0])
        assert _ops(t[1]) == _ops(j[1])
        ars = [a for typ, a, _, _ in _ops(t[0]) if typ == "c_allreduce_sum"]
        assert len(ars) == 4
        assert all(a["pre_scale"] == 1.0 / nranks and a["ring_id"] == 0
                   for a in ars)
    one = _mlp_program(tfluid, TGradAllReduce, 0, 1, False)[0]
    assert "c_allreduce_sum" not in [op.type
                                     for op in one.global_block().ops]


@pytest.mark.parametrize("env, bucket_mb, mark", [
    ({}, None, None),
    ({"PADDLE_TPU_QUANT_MIN_BYTES": "1"}, None, None),
    ({"PADDLE_TPU_QUANT_MIN_BYTES": "1", "PADDLE_TPU_QUANT": "0"}, None,
     None),
    ({}, None, {"min_bytes": 1}),
    ({}, 0.002, {"min_bytes": 600}),
    ({"PADDLE_TPU_QUANT_BLOCK": "128"}, 0.001, {"min_bytes": 1}),
])
def test_allreduce_family_buckets_like_the_reference(monkeypatch, env,
                                                     bucket_mb, mark):
    """Dense, quant by env or by the program's mark, the kill switch, a
    bucket cap that splits the grads and a threshold that quantizes only
    the big bucket: the same fused ops, members and attrs (the
    reference with its overlap pass off)."""
    import paddle_tpu as jfluid
    from paddle_tpu.static_analysis import fusion as jfusion
    from paddle_tpu.transpiler.collective import GradAllReduce

    for k in ("PADDLE_TPU_QUANT_MIN_BYTES", "PADDLE_TPU_QUANT",
              "PADDLE_TPU_QUANT_BLOCK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    # the reference's overlap pass splits a bucket of a multi-bucket
    # program into c_allreduce_start / _wait (not ported: ROADMAP.md)
    monkeypatch.setenv("PADDLE_TPU_OVERLAP", "0")
    fused = {}
    for fluid, g, fu in ((jfluid, GradAllReduce, jfusion),
                         (tfluid, TGradAllReduce, tfusion)):
        main, _, loss = _mlp_program(fluid, g, 0, 2, False)
        if bucket_mb:
            main._allreduce_bucket_mb = bucket_mb
        if mark:
            main._quant_buckets = mark
        prog, _ = fu.resolve_fused_program(main, targets=[loss.name])
        fused[fluid] = [o for o in _ops(prog) if "allreduce" in o[0]]
        if fluid is tfluid:
            assert prog._num_trainers == 2
            if bucket_mb:
                assert prog._allreduce_bucket_mb == bucket_mb
    assert fused[tfluid] == fused[jfluid]
    types = collections.Counter(o[0] for o in fused[tfluid])
    quant_on = env.get("PADDLE_TPU_QUANT") != "0" and (
        "PADDLE_TPU_QUANT_MIN_BYTES" in env or mark)
    assert bool(types["c_allreduce_quant"]) == bool(quant_on)
    assert "c_allreduce_sum" not in types or bucket_mb


# ---------------------------------------------------------------------------
# (c) binding the ring
# ---------------------------------------------------------------------------

def _mlp_feed(rng, rows):
    return {"x": rng.randn(rows, 16).astype("float32"),
            "label": rng.randint(0, 4, (rows, 1)).astype("int64")}


def test_without_comm_init_the_collectives_are_the_identity():
    """A transpiled program whose startup never bound a ring trains
    exactly as the untranspiled one: ``pre_scale`` is skipped with the
    exchange, in the plain and in the fused (dense and quant) ops."""
    feed = _mlp_feed(np.random.RandomState(1), 8)
    runs = {}
    for name, nranks, quant in (("plain", 1, False), ("dense", 2, False),
                                ("quant", 2, True)):
        main, startup, loss = _mlp_program(tfluid, TGradAllReduce, 0,
                                           nranks, quant)
        startup.global_block().ops = [
            op for op in startup.global_block().ops
            if op.type not in ("c_gen_nccl_id", "c_comm_init")]
        scope = tfluid.Scope()
        with tfluid.scope_guard(scope):
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup)
            runs[name] = [exe.run(main, feed=feed, fetch_list=[loss])[0]
                          for _ in range(2)]
            assert scope.rings == {}
    for name in ("dense", "quant"):
        assert np.array_equal(np.asarray(runs[name]),
                              np.asarray(runs["plain"])), name


def test_comm_init_raises_without_a_group_or_on_a_misbound_one(tmp_path):
    """No process group: c_comm_init raises.  A world-1 group under a
    program transpiled for rank 0 of 2: it raises rather than train
    alone, and binds nothing; under one transpiled for rank 0 of 1 it
    binds ring 0."""
    main, startup, _ = _mlp_program(tfluid, TGradAllReduce, 0, 2, False)
    exe = tfluid.Executor(tfluid.CPUPlace())
    assert not dist.is_initialized()
    with tfluid.scope_guard(tfluid.Scope()):
        with pytest.raises(RuntimeError, match="no torch.distributed"):
            exe.run(startup)
    dist.init_process_group("gloo", init_method="file://%s" % (
        tmp_path / "store"), rank=0, world_size=1)
    try:
        scope = tfluid.Scope()
        with tfluid.scope_guard(scope):
            with pytest.raises(RuntimeError, match="rank 0 of 2"):
                exe.run(startup)
        assert scope.rings == {}
        main1, startup1, _ = _mlp_program(tfluid, TGradAllReduce, 0, 1,
                                          False)
        ok = tfluid.Scope()
        with tfluid.scope_guard(ok):
            exe.run(startup1)
        # rank 0 of 1 is what the world-1 group is: ring 0 binds to it
        assert ok.rings == {0: dist.group.WORLD}
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# (d) training: the MLP against the reference, bert-tiny in the port
# ---------------------------------------------------------------------------

def _reference_mlp_twins(params, feeds, nranks):
    """The reference's transpiled MLP, dense and quant, per worker under
    shard_map with ``ctx.collective_axis`` (bench.py's quant arm)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    import paddle_tpu as jfluid
    from paddle_tpu.executor import _run_ops_into_env
    from paddle_tpu.jax_compat import shard_map
    from paddle_tpu.ops import registry as jreg
    from paddle_tpu.static_analysis import fusion as jfusion
    from paddle_tpu.transpiler.collective import GradAllReduce

    mesh = Mesh(np.array(jax.devices()[:nranks]), ("dp",))
    out = {}
    for twin in ("dense", "quant"):
        main, _, loss = _mlp_program(jfluid, GradAllReduce, 0, nranks,
                                     twin == "quant")
        fused, _ = jfusion.resolve_fused_program(main, targets=[loss.name])
        block = fused.global_block()
        names = sorted(n for n in params if block._find_var_recursive(n)
                       is not None and "tpu_comm_id" not in n)

        def per_worker(pvals, xb, yb, _block=block, _names=names,
                       _loss=loss.name):
            ctx = jreg.LoweringContext(mode="train")
            ctx.collective_axis = "dp"
            env = {n: v[0] for n, v in zip(_names, pvals)}
            env["x"], env["label"] = xb[0], yb[0]
            _run_ops_into_env(_block, env, ctx)
            return [env[n][None] for n in _names], env[_loss].reshape(1)

        step = jax.jit(shard_map(
            per_worker, mesh=mesh,
            in_specs=([P("dp")] * len(names), P("dp"), P("dp")),
            out_specs=([P("dp")] * len(names), P("dp"))))
        vals = [np.tile(params[n][None], (nranks,) + (1,) * params[n].ndim)
                for n in names]
        losses, states = [], []
        for feed in feeds:
            xb = np.stack([feed[r]["x"] for r in range(nranks)])
            yb = np.stack([feed[r]["label"] for r in range(nranks)])
            vals, lv = step([jnp.asarray(v) for v in vals], jnp.asarray(xb),
                            jnp.asarray(yb))
            vals = [np.asarray(v) for v in vals]
            losses.append(np.asarray(lv))
            states.append({n: v for n, v in zip(names, vals)})
        out[twin] = {"losses": losses, "states": states}
    return out


def test_mlp_data_parallel_twins_match_reference(tmp_path):
    """Two ranks, three SGD steps, dense and quant twins from the
    reference's parameters: each rank's loss and every parameter after
    every step against the reference's worker, within 1e-5; the quant
    twin's buckets are ``c_allreduce_quant`` and its parameters are
    bit-identical across ranks."""
    import paddle_tpu as jfluid
    from paddle_tpu.transpiler.collective import GradAllReduce

    nranks = 2
    main, startup, _ = _mlp_program(jfluid, GradAllReduce, 0, nranks, False)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        params = {k: v for k, v in convert.scope_persistables(
            main, jscope).items() if "tpu_comm_id" not in k}
    rng = np.random.RandomState(3)
    feeds = [[_mlp_feed(rng, 4) for _ in range(nranks)]
             for _ in range(MLP_STEPS)]
    want = _reference_mlp_twins(params, feeds, nranks)
    got = _spawn(_mlp_worker, nranks, tmp_path, params, feeds)

    assert got[0]["dense"]["ops"] == ["c_fused_allreduce_sum"]
    assert got[0]["quant"]["ops"] == ["c_allreduce_quant"]
    for twin in ("dense", "quant"):
        for step in range(MLP_STEPS):
            for r in range(nranks):
                g = got[r][twin]["losses"][step]
                w = float(want[twin]["losses"][step][r])
                assert abs(g - w) <= MLP_RTOL * abs(w), (twin, step, r, g, w)
                for n, wv in want[twin]["states"][step].items():
                    assert _rel(got[r][twin]["states"][step][n], wv[r]) \
                        <= MLP_RTOL, (twin, step, r, n)
            if twin == "quant":
                for n, v in got[0][twin]["states"][step].items():
                    assert np.array_equal(v, got[1][twin]["states"][step][n])
    delta = max(abs(a - b) for a, b in zip(got[0]["dense"]["losses"],
                                           got[0]["quant"]["losses"]))
    assert delta <= QUANT_LOSS_GATE


def test_bert_tiny_data_parallel_matches_one_process(tmp_path):
    """bert-tiny MLM pretraining (dropout 0, Adam), two ranks of 2 rows
    with a 0.25 MB bucket cap (several buckets), against one process on
    the 4 rows: the dense twin's mean loss and its exchanged gradients
    match the one process's; the quant twin (every bucket
    ``c_allreduce_quant``) stays within the reference's loss-delta gate;
    both twins' gradients and parameters are bit-identical across the
    ranks.  (Adam's first steps divide each gradient by its own
    magnitude, so the parameters are compared through the gradients.)"""
    from paddle_tpu_torch.models import bert

    nranks = 2
    cfg = _bert_cfg(bert)
    rng = np.random.RandomState(11)
    batches = [bert.make_fake_batch(BERT_BATCH, BERT_SEQ, cfg, rng)
               for _ in range(BERT_STEPS)]
    half = BERT_BATCH // nranks
    feeds = [[{k: v[r * half:(r + 1) * half] for k, v in b.items()}
              for r in range(nranks)] for b in batches]
    main, startup, loss = _bert_program(0, 1, False, None)
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        params = convert.scope_persistables(main, scope)
        one_losses, one_grads, _ = _train(exe, main, scope, loss, batches)
    got = _spawn(_bert_worker, nranks, tmp_path, params, feeds)

    dense_ops = collections.Counter(got[0]["dense"]["ops"])
    quant_ops = collections.Counter(got[0]["quant"]["ops"])
    # a grad above the cap is a bucket of one: left unfused when dense
    assert dense_ops["c_fused_allreduce_sum"] >= 3 and \
        set(dense_ops) <= {"c_fused_allreduce_sum", "c_allreduce_sum"}
    assert set(quant_ops) == {"c_allreduce_quant"} and \
        quant_ops["c_allreduce_quant"] >= 3
    for step in range(BERT_STEPS):
        mean = np.mean([got[r]["dense"]["losses"][step]
                        for r in range(nranks)])
        want = one_losses[step]
        assert abs(mean - want) <= BERT_DP_RTOL * abs(want), (step, mean,
                                                              want)
        top = max(float(np.abs(g).max()) for g in one_grads[step].values())
        for p, g in one_grads[step].items():
            err = float(np.abs(got[0]["dense"]["grads"][step][p] - g).max())
            scale = max(float(np.abs(g).max()), NULL_GRAD_FLOOR * top)
            assert err <= BERT_DP_RTOL * scale, (step, p, err, scale)
        for twin in ("dense", "quant"):
            for key in ("grads", "states"):
                for n, v in got[0][twin][key][step].items():
                    assert np.array_equal(v, got[1][twin][key][step][n]), \
                        (twin, key, step, n)
    for r in range(nranks):
        delta = max(abs(a - b) for a, b in zip(got[r]["dense"]["losses"],
                                               got[r]["quant"]["losses"]))
        assert delta <= QUANT_LOSS_GATE, (r, delta)
