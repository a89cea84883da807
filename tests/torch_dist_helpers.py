"""Spawned ranks of the port's data-parallel tests.

``spawn(job, nranks, tmp_path, *args)`` runs ``job(rank, nranks, *args)``
in ``nranks`` processes (``torch.multiprocessing``, spawn) over a gloo
group whose ``file://`` store lies in ``tmp_path`` (no ports, so xdist
workers cannot collide), each spawn with its own timeout, and returns
the ranks' results in rank order.  This module imports only numpy,
torch and the port, so a spawned rank loads nothing of JAX or the
reference; the tests import the reference themselves.

The model builders take the package (``fluid``) as their first
argument, so the tests build the same program in both packages.
"""

import os
import pickle
import traceback

import numpy as np

SPAWN_TIMEOUT = 240  # seconds, per spawn


def _entry(rank, nranks, store, job, args, out_dir, init):
    import torch.distributed as dist

    if init:
        dist.init_process_group("gloo", init_method="file://" + store,
                                rank=rank, world_size=nranks)
    else:
        args = (store,) + tuple(args)
    try:
        try:
            res = job(rank, nranks, *args)
        except Exception:  # noqa: BLE001 - the test reports it
            res = {"error": traceback.format_exc()}
        with open(os.path.join(out_dir, "rank%d.pkl" % rank), "wb") as f:
            pickle.dump(res, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(job, nranks, tmp_path, *args, timeout=SPAWN_TIMEOUT, init=True):
    """With ``init=False`` the job initialises the group itself and gets
    the store's path after ``nranks``."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out_dir = str(tmp_path)
    store = os.path.join(out_dir, "store")
    procs = [ctx.Process(target=_entry,
                         args=(r, nranks, store, job, args, out_dir, init))
             for r in range(nranks)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
        alive = [p.pid for p in procs if p.is_alive()]
        assert not alive, "ranks still running after %ds: %s" % (timeout,
                                                                  alive)
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
            res = pickle.load(f)
        assert not (isinstance(res, dict) and "error" in res), \
            "rank %d: %s" % (r, res["error"])
        out.append(res)
    return out


def ops_of(program):
    """The global block's ops as (type, attrs, inputs, outputs), numpy
    attrs as lists, the ids and name scopes left out: what two packages'
    builds of one program share."""
    def attr(v):
        return v.tolist() if isinstance(v, np.ndarray) else v

    return [(op.type, {k: attr(v) for k, v in op.attrs.items()
                       if not k.startswith("__") and k != "op_namescope"},
             dict(op.inputs), dict(op.outputs))
            for op in program.global_block().ops]


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()
                 / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# models, built alike in both packages
# ---------------------------------------------------------------------------

def mlp(fluid, opt="adam", seed=5):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=32, act="relu")
        logits = fluid.layers.fc(input=h, size=4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        if opt == "adam":
            fluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
        elif opt == "momentum":
            fluid.optimizer.Momentum(learning_rate=0.05,
                                     momentum=0.9).minimize(loss)
        else:
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def bn_model(fluid, layout="NCHW", filters=8, seed=13):
    """``tests/test_grad_accum_syncbn.py``'s ``_bn_model`` (conv → batch
    norm + relu → avg pool → fc), in ``layout``, with ``filters``
    channels (16 puts the conv-BN pair over the fusion's gate)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        shape = [3, 8, 8] if layout == "NCHW" else [8, 8, 3]
        img = fluid.layers.data("img", shape=shape, dtype="float32")
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        c = fluid.layers.conv2d(img, num_filters=filters, filter_size=3,
                                padding=1, bias_attr=False,
                                data_format=layout)
        c = fluid.layers.batch_norm(c, act="relu", data_layout=layout)
        p = fluid.layers.pool2d(c, pool_size=8, pool_type="avg",
                                data_format=layout)
        logits = fluid.layers.fc(p, size=4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def bert_tiny(fluid, seq=32, seed=5):
    import copy

    if fluid.__name__.startswith("paddle_tpu_torch"):
        from paddle_tpu_torch.models import bert
    else:
        bert = __import__(fluid.__name__ + ".models.bert",
                          fromlist=["bert"])
    cfg = copy.copy(bert.BERT_TINY)
    cfg.dropout = cfg.attn_dropout = 0.0
    with fluid.unique_name.guard():
        main, startup, _feeds, loss = bert.build_pretrain(cfg, seq_len=seq,
                                                          lr=1e-3)
    main.random_seed = startup.random_seed = seed
    return main, startup, loss


MODELS = {"mlp": mlp, "bn": bn_model, "bert_tiny": bert_tiny}


def mlp_feeds(steps, rows, seed=3):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(rows, 16).astype("float32"),
             "y": rng.randint(0, 4, (rows, 1)).astype("int64")}
            for _ in range(steps)]


def bn_feeds(steps, rows, layout="NCHW", seed=2):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        img = rng.randn(rows, 3, 8, 8).astype("float32")
        if layout == "NHWC":
            img = np.ascontiguousarray(img.transpose(0, 2, 3, 1))
        out.append({"img": img,
                    "y": rng.randint(0, 4, (rows, 1)).astype("int64")})
    return out


def rows_of(feed, rank, nranks):
    n = next(iter(feed.values())).shape[0] // nranks
    return {k: v[rank * n:(rank + 1) * n] for k, v in feed.items()}


# ---------------------------------------------------------------------------
# jobs (run in a spawned rank)
# ---------------------------------------------------------------------------

def run_compiled(rank, nranks, model, kwargs, params, feeds, options):
    """``model`` built in the port, ``params`` loaded, trained on this
    rank's rows of ``feeds`` through ``CompiledProgram.with_data_parallel``
    with the ``options`` (``shard``: ZeRO-1, ``fuse_bn``: the conv-BN
    fusion, ``save``: a directory for ``io.save_persistables``) →
    losses, parameters after every step, the ZeRO-1 shards, the resolved
    program's op types and the accumulator bytes held."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert

    main, startup, loss = MODELS[model](fluid, **kwargs)
    scope = fluid.Scope()
    out = {"losses": [], "params": []}
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        if params is not None:
            convert.load_params_into_scope(params, scope, "cpu",
                                           program=main)
        bs = fluid.BuildStrategy()
        bs.shard_optimizer_state = bool(options.get("shard"))
        bs.fuse_bn_act_ops = bool(options.get("fuse_bn", True))
        cp = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, build_strategy=bs)
        for feed in feeds:
            lv = exe.run(cp, feed=rows_of(feed, rank, nranks),
                         fetch_list=[loss])[0]
            out["losses"].append(float(np.asarray(lv).reshape(-1)[0]))
            out["params"].append({p.name: scope.get(p.name).numpy().copy()
                                  for p in main.all_parameters()})
        out["shards"] = {n: (tuple(scope.get(n).shape),) + tuple(v[:2])
                         for n, v in scope.shards.items()}
        out["acc_bytes"] = sum(
            scope.get(v.name).numel() * scope.get(v.name).element_size()
            for v in main.list_vars()
            if getattr(v, "_is_optimizer_state", False)
            and isinstance(scope.get(v.name), torch.Tensor))
        runner = cp._parallel_runner
        clone = runner._dp_program(nranks, rank)[0] if nranks > 1 \
            else main
        from paddle_tpu_torch.static_analysis import fusion

        resolved, _ = fusion.resolve_fused_program(
            clone, config=runner._config(), targets=[loss.name])
        out["ops"] = [op.type for op in resolved.global_block().ops]
        if options.get("save"):
            fluid.io.save_persistables(exe, options["save"], main)
    return out


def run_many(rank, nranks, configs):
    """:func:`run_compiled` for each ``(model, kwargs, params, feeds,
    options)`` of ``configs``, in order, in one rank process."""
    return [run_compiled(rank, nranks, *c) for c in configs]


def _call(op_type, ctx, ins, attrs):
    from paddle_tpu_torch.ops import registry

    res = registry.call_op(registry.get_op_def(op_type), ctx, ins, attrs)
    return {k: [None if v is None else v.clone() for v in vs]
            for k, vs in res.items()}


def collective_ops(rank, nranks, cases):
    """Each ``(name, op_type, ins, attrs)`` of ``cases`` (``ins`` holds a
    numpy array per rank for each slot's value) run through the port's
    registered op with ring 0 bound to the default group → {name: {out
    slot: [numpy]}}; the ``pair`` cases (a fused bucket op against its
    start/wait pair) run both and report both."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.ops import collective, registry

    out = {}
    for name, op_type, ins, attrs in cases:
        ctx = registry.LoweringContext(rings={0: dist.group.WORLD})
        tins = {slot: [torch.from_numpy(np.array(v[rank])) for v in vals]
                for slot, vals in ins.items()}
        if op_type == "start_wait":
            start = dict(attrs, overlap_bucket=7)
            _call("c_allreduce_start", ctx, tins, start)
            assert list(ctx.pending) == [7]
            res = _call("c_allreduce_wait", ctx, tins,
                        {"ring_id": 0, "overlap_bucket": 7})
            assert not ctx.pending
        elif op_type == "hier":
            rs = _call("c_hier_reducescatter", ctx, tins,
                       dict(attrs["rs"], ring_id=5))
            chunk = rs["Out"]
            if attrs.get("quant"):
                mid = _call("c_allreduce_quant", ctx, {"X": chunk},
                            dict(attrs["cross"], ring_id=6))["Out"]
            else:
                mid = _call("c_allreduce_sum", ctx, {"X": chunk},
                            dict(attrs["cross"], ring_id=6))["Out"]
            res = _call("c_hier_allgather", ctx, {"X": mid},
                        dict(attrs["ag"], ring_id=5))
            res["chunk"] = chunk
        else:
            res = _call(op_type, ctx, tins, attrs)
        out[name] = {k: [None if v is None else v.numpy() for v in vs]
                     for k, vs in res.items()}
    # a start whose wait never ran is waited out by the drain
    ctx = registry.LoweringContext(rings={0: dist.group.WORLD})
    _call("c_allreduce_start", ctx,
          {"X": [torch.ones(4) * (rank + 1)]},
          {"ring_id": 0, "overlap_bucket": 1})
    collective.drain_pending(ctx)
    out["drained"] = not ctx.pending
    return out


def mode_program(fluid, mode, rank, nranks):
    """The program of a collective mode, transpiled for ``rank`` of
    ``nranks``: ``local_sgd``, ``geo_sgd`` (``need_push_nums=2``),
    ``async`` / ``async_dc`` on the SGD MLP, ``toy_async`` /
    ``toy_async_dc`` (``build_toy_async_program``) → (main, startup,
    loss)."""
    from importlib import import_module

    coll = import_module(fluid.__name__ + ".transpiler.collective")
    if mode.startswith("toy_async"):
        main, startup, loss, _w0 = coll.build_toy_async_program(
            dc_asgd=mode.endswith("_dc"), nranks=nranks)
        for op in startup.global_block().ops:
            if op.type in ("c_gen_nccl_id", "c_comm_init"):
                op.attrs["rank"] = rank
        return main, startup, loss
    main, startup, loss = mlp(fluid, opt="sgd")
    t = {"local_sgd": lambda: coll.LocalSGD(),
         "geo_sgd": lambda: coll.GeoSGD(need_push_nums=2),
         "async": lambda: coll.AsyncSGD(),
         "async_dc": lambda: coll.AsyncSGD(dc_asgd=True)}[mode]()
    t.transpile(program=main, startup_program=startup, rank=rank,
                nranks=nranks)
    return main, startup, loss


def run_modes(rank, nranks, cases):
    """Each ``(mode, state, feeds)``: the mode's program for this rank,
    its startup run (``c_comm_init`` binds ring 0), ``state`` loaded,
    trained on this rank's feed of each step → {mode: (losses, the
    persistables after each step)}."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert

    out = {}
    for mode, state, feeds in cases:
        main, startup, loss = mode_program(fluid, mode, rank, nranks)
        scope = fluid.Scope()
        losses, states = [], []
        with fluid.scope_guard(scope):
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup)
            assert 0 in scope.rings
            convert.load_params_into_scope(state, scope, "cpu",
                                           program=main)
            for feed in feeds:
                lv = exe.run(main, feed=feed[rank], fetch_list=[loss])[0]
                losses.append(float(np.asarray(lv).reshape(-1)[0]))
                states.append(convert.scope_persistables(main, scope))
        out[mode] = (losses, states)
    return out


def fleet_job(rank, nranks, store, params, feeds):
    """The collective fleet as users start it: ``fleet.init`` with a
    user-defined collective role (it initialises the gloo group over
    ``store``), ``distributed_optimizer(Adam).minimize``, then the
    runner → losses, parameters after each step and the group's world;
    the bounded barrier passes."""
    import torch.distributed as dist

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.incubate.fleet.base import role_maker
    from paddle_tpu_torch.incubate.fleet.collective import (
        DistributedStrategy, fleet)

    fleet.init(role_maker.UserDefinedCollectiveRoleMaker(
        rank, ["127.0.0.1:%d" % (6170 + r) for r in range(nranks)]),
        init_method="file://" + store)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=32, act="relu")
        logits = fluid.layers.fc(input=h, size=4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fleet.distributed_optimizer(
            fluid.optimizer.Adam(learning_rate=1e-2),
            DistributedStrategy()).minimize(loss)
    scope = fluid.Scope()
    out = {"losses": [], "params": [], "world": dist.get_world_size(),
           "marks": (main._num_trainers, main._trainer_id)}
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        convert.load_params_into_scope(params, scope, "cpu", program=main)
        cp = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)
        for feed in feeds:
            lv = exe.run(cp, feed=rows_of(feed, rank, nranks),
                         fetch_list=[loss])[0]
            out["losses"].append(float(np.asarray(lv).reshape(-1)[0]))
            out["params"].append({p.name: scope.get(p.name).numpy().copy()
                                  for p in main.all_parameters()})
    fleet.barrier_worker(timeout=60)
    return out
