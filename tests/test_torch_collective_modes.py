"""The collective modes (``LocalSGD``, ``GeoSGD``, ``AsyncSGD`` with and
without DC-ASGD, ``build_toy_async_program``; the collective
``DistributeTranspiler``; ``layers/collective.py``) of the port against
the reference's.

The transpiled programs are compared op for op (types, attrs, slots)
with the reference's.  The trajectories: two spawned gloo ranks
(``tests/torch_dist_helpers.py``) run each mode's program from the
reference's startup state, each on its own rows, against the
reference's oracle, its program interpreted per worker under
``shard_map`` with ``ctx.collective_axis`` on two of the conftest's CPU
devices (as ``tests/test_local_sgd.py``, ``test_geo_sgd.py`` and
``test_async_sgd.py`` run it).  One spawn serves every mode.

Tolerance ``MODE_RTOL`` 1e-5: each rank's loss (relative) and every
persistable (max |diff| over max |ref|) after every step, float32 in
another summation order.  The modes' invariants: after
a LocalSGD step both ranks hold the same parameters bit for bit, after
a GeoSGD sync step the same up to one rounding (1e-6), off it they
differ; AsyncSGD applies the previous step's mean gradient (1e-6).
"""

import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert

import torch_dist_helpers as H

MODE_RTOL = 1e-5
STEPS = 3
MODES = ("local_sgd", "geo_sgd", "async", "async_dc", "toy_async",
         "toy_async_dc")


def _feeds(mode):
    rng = np.random.RandomState(7)
    if mode.startswith("toy_async"):
        return [[{"x": (rng.randn(4) + 3 * r).astype("float32")}
                 for r in range(2)] for _ in range(STEPS)]
    return [[{"x": rng.randn(4, 16).astype("float32"),
              "y": rng.randint(0, 4, (4, 1)).astype("int64")}
             for r in range(2)] for _ in range(STEPS)]


def _reference_state(mode):
    import paddle_tpu as jfluid

    main, startup, _ = H.mode_program(jfluid, mode, 0, 2)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        return {k: v for k, v in convert.scope_persistables(
            main, scope).items() if "tpu_comm_id" not in k}


def _reference_workers(mode, state, feeds):
    """The reference's program of ``mode`` per worker under
    ``shard_map`` (2 workers) → [(losses per rank, states per rank)]
    a step."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    import paddle_tpu as jfluid
    from paddle_tpu.executor import _run_ops_into_env
    from paddle_tpu.jax_compat import shard_map
    from paddle_tpu.ops import registry as jreg

    main, _, loss = H.mode_program(jfluid, mode, 0, 2)
    block = main.global_block()
    names = sorted(state)
    feed_names = sorted(feeds[0][0])
    mesh = Mesh(np.array(jax.devices()[:2]), ("w",))

    def per_worker(vals, fvals):
        ctx = jreg.LoweringContext(mode="train")
        ctx.collective_axis = "w"
        env = {n: v[0] for n, v in zip(names, vals)}
        env.update({n: v[0] for n, v in zip(feed_names, fvals)})
        _run_ops_into_env(block, env, ctx)
        return ([env[n][None] for n in names],
                jnp.reshape(env[loss.name], (1,)))

    step = jax.jit(shard_map(
        per_worker, mesh=mesh,
        in_specs=([P("w")] * len(names), [P("w")] * len(feed_names)),
        out_specs=([P("w")] * len(names), P("w"))))
    vals = [np.stack([state[n]] * 2) for n in names]
    out = []
    for feed in feeds:
        fvals = [np.stack([feed[r][n] for r in range(2)])
                 for n in feed_names]
        vals, lv = step([jnp.asarray(v) for v in vals],
                        [jnp.asarray(v) for v in fvals])
        vals = [np.asarray(v) for v in vals]
        out.append((np.asarray(lv), {n: v for n, v in zip(names, vals)}))
    return out


@pytest.fixture(scope="module")
def modes(tmp_path_factory):
    cases = [(m, _reference_state(m), _feeds(m)) for m in MODES]
    got = H.spawn(H.run_modes, 2, tmp_path_factory.mktemp("modes"), cases)
    return {m: (state, feeds, [got[r][m] for r in range(2)])
            for m, state, feeds in cases}


@pytest.mark.parametrize("mode", MODES)
def test_transpiled_programs_equal_the_reference(mode):
    import paddle_tpu as jfluid

    for rank in (0, 1):
        j = H.mode_program(jfluid, mode, rank, 2)
        t = H.mode_program(tfluid, mode, rank, 2)
        assert H.ops_of(t[0]) == H.ops_of(j[0])
        assert H.ops_of(t[1]) == H.ops_of(j[1])


@pytest.mark.parametrize("mode", MODES)
def test_two_rank_trajectories_match_the_reference_oracle(modes, mode):
    state, feeds, got = modes[mode]
    want = _reference_workers(mode, state, feeds)
    for s, (wl, wstate) in enumerate(want):
        for r in range(2):
            losses, states = got[r]
            assert abs(losses[s] - wl[r]) <= MODE_RTOL * abs(wl[r]), \
                (mode, s, r, losses[s], wl[r])
            for n, v in wstate.items():
                assert H.rel(states[s][n], v[r]) <= MODE_RTOL, (mode, s, r,
                                                                n)


def _params(state, names):
    return {n: state[n] for n in names}


def test_mode_invariants(modes):
    """LocalSGD: both ranks hold the same parameters after every step.
    GeoSGD (``need_push_nums=2``): apart after the first step, equal up
    to one rounding after the second (the sync).  AsyncSGD on the toy:
    the update of step t applies the mean of the gradients the ranks
    buffered at step t - 1 (zeros at the first)."""
    main, _, _ = H.mlp(tfluid, opt="sgd")
    pnames = [p.name for p in main.all_parameters()]
    _, _, got = modes["local_sgd"]
    for s in range(STEPS):
        a, b = (_params(got[r][1][s], pnames) for r in range(2))
        assert all(np.array_equal(a[n], b[n]) for n in pnames), s
    _, _, got = modes["geo_sgd"]
    apart = [max(H.rel(got[0][1][s][n], got[1][1][s][n]) for n in pnames)
             for s in range(STEPS)]
    # on the sync the ranks hold the synced value up to the rounding of
    # p + (synced - p); off it, their own local steps apart
    assert apart[1] <= 1e-6 and apart[0] > 1e-3 and apart[2] > 1e-3, apart
    state, feeds, got = modes["toy_async"]
    lr = 0.1
    w_prev = state["w"]
    buf_prev = [state["w@GRAD@ASYNC_BUF"]] * 2
    for s in range(STEPS):
        w = got[0][1][s]["w"]
        np.testing.assert_allclose(
            w, w_prev - lr * (buf_prev[0] + buf_prev[1]) / 2,
            rtol=1e-6, atol=1e-6)
        assert np.array_equal(w, got[1][1][s]["w"])
        for r in range(2):
            np.testing.assert_allclose(
                got[r][1][s]["w@GRAD@ASYNC_BUF"],
                (w_prev - feeds[s][r]["x"]) / 2, rtol=1e-6, atol=1e-6)
        w_prev = w
        buf_prev = [got[r][1][s]["w@GRAD@ASYNC_BUF"] for r in range(2)]


# ---------------------------------------------------------------------------
# DistributeTranspiler and the collective layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["nccl2", "grad_allreduce", "collective",
                                  "local_sgd", "geo"])
def test_distribute_transpiler_collective_modes_give_the_reference_programs(
        mode):
    import paddle_tpu as jfluid

    progs = []
    for fluid in (jfluid, tfluid):
        main, startup, _ = H.mlp(fluid, opt="sgd")
        cfg = fluid.DistributeTranspilerConfig()
        if mode == "geo":
            cfg.geo_sgd_mode = True
            cfg.geo_sgd_need_push_nums = 3
        else:
            cfg.mode = mode
        fluid.DistributeTranspiler(cfg).transpile(
            1, program=main, startup_program=startup, trainers=2)
        progs.append((H.ops_of(main), H.ops_of(startup), main._num_trainers,
                      main._trainer_id))
    assert progs[1] == progs[0]
    assert progs[1][2:] == (2, 1)


@pytest.mark.parametrize("what", ["pserver", "async", "auto"])
def test_distribute_transpiler_pserver_and_auto_raise(what):
    main, startup, _ = H.mlp(tfluid, opt="sgd")
    cfg = tfluid.DistributeTranspilerConfig()
    kwargs = {}
    if what == "auto":
        cfg.mode = "auto"
    elif what == "async":
        kwargs["sync_mode"] = False
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        tfluid.DistributeTranspiler(cfg).transpile(
            0, program=main, startup_program=startup, trainers=2, **kwargs)
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        tfluid.DistributeTranspiler(cfg).get_pserver_program("a:1")


def test_collective_layers_build_the_reference_ops():
    import paddle_tpu as jfluid
    from paddle_tpu.layers import collective as jcoll

    from paddle_tpu_torch.layers import collective as tcoll

    progs = []
    for fluid, coll in ((jfluid, jcoll), (tfluid, tcoll)):
        main = fluid.Program()
        with fluid.unique_name.guard(), \
                fluid.program_guard(main, fluid.Program()):
            x = fluid.layers.data("x", shape=[4], dtype="float32")
            coll._allreduce(x, reduce_type="max")
            coll._broadcast(x, root=1, sync_mode=True)
            coll._c_allgather(x, nranks=2)
            coll._c_reducescatter(x, nranks=2, ring_id=3)
        progs.append(H.ops_of(main))
    assert progs[1] == progs[0]
    assert [t for t, *_ in progs[1]] == ["c_allreduce_max", "c_broadcast",
                                         "c_allgather", "c_reducescatter"]


def test_elementwise_mod_and_floordiv_match_the_reference():
    """GeoSGD's gate op: ``jnp.mod``'s sign of the divisor."""
    import jax.numpy as jnp

    from paddle_tpu_torch.ops import registry

    x = np.array([-7.0, -2.5, 0.0, 3.0, 7.5], "float32")
    y = np.array([3.0, 2.0, 4.0, -2.0, 2.5], "float32")
    import torch

    for op, ref in (("elementwise_mod", jnp.mod),
                    ("elementwise_floordiv", jnp.floor_divide)):
        got = registry.call_op(registry.get_op_def(op),
                               registry.LoweringContext(),
                               {"X": [torch.from_numpy(x)],
                                "Y": [torch.from_numpy(y)]}, {})["Out"][0]
        assert np.array_equal(got.numpy(), np.asarray(ref(x, y))), op
