"""The port's data-parallel runner (``CompiledProgram.with_data_parallel``,
``paddle_tpu_torch/parallel/__init__.py``) against the reference's.

The reference runs its runner in one process on the conftest's 8-device
CPU mesh (``places=jax.devices()[:N]``), fed the global batch; the port
runs N spawned gloo ranks (``tests/torch_dist_helpers.py``: ``file://``
store in a temp dir, a timeout per spawn), each fed its rows, from the
reference's initial parameters (``convert``).  Two spawns serve the
file: one of 2 ranks that trains every 2-rank configuration in turn and
one of 4 ranks, each run once per module.

Tolerances (float32, the same ops in another summation order: the
gradient's mean over the batch is taken per rank, then averaged):

- ``RUN_RTOL`` 1e-5: losses (relative) and parameters (max |diff| over
  max |ref| per parameter) after every step, MLP and bert-tiny, against
  the reference's runner; ZeRO-1 against the reference's
  ``shard_optimizer_state`` run and against the port's unsharded run;
- ``ADAM_STEP_ATOL`` 2e-3 (twice bert-tiny's learning rate): bert-tiny's
  parameters.  Adam's first steps divide each gradient by its own
  magnitude, so an element whose gradient is rounding noise (the
  position rows no batch reached, the attention key bias) steps by up
  to the learning rate with either sign; the losses, which the
  parameters after the first step decide, are held to ``RUN_RTOL``;
- ``BN_RTOL`` 1e-5: synchronized batch norm (the conv-BN model of
  ``tests/test_grad_accum_syncbn.py``), two ranks of 8 images against
  the reference's DP run and against one port process on the 16.
"""

import os
import warnings

import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert

import torch_dist_helpers as H

RUN_RTOL = 1e-5
ADAM_STEP_ATOL = 2e-3
BN_RTOL = 1e-5
STEPS = 3
BERT_SEQ = 32


def _reference_params(model, kwargs):
    import paddle_tpu as jfluid

    main, startup, loss = H.MODELS[model](jfluid, **kwargs)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        return {k: v for k, v in
                convert.scope_persistables(main, scope).items()
                if "tpu_comm_id" not in k}


def _reference_run(model, kwargs, params, feeds, nranks, shard=False,
                   fuse_bn=True):
    """The reference's runner over ``nranks`` of the 8 CPU devices, fed
    the global batch: losses and parameters after every step."""
    import jax

    import paddle_tpu as jfluid

    main, startup, loss = H.MODELS[model](jfluid, **kwargs)
    scope = jfluid.Scope()
    out = {"losses": [], "params": []}
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        for n, v in params.items():
            scope.set(n, np.asarray(v))
        bs = jfluid.BuildStrategy()
        bs.shard_optimizer_state = shard
        bs.fuse_bn_act_ops = fuse_bn
        cp = jfluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, build_strategy=bs,
            places=jax.devices()[:nranks])
        for feed in feeds:
            lv = exe.run(cp, feed=feed, fetch_list=[loss])[0]
            out["losses"].append(float(np.asarray(lv).reshape(-1)[0]))
            out["params"].append({p.name: np.asarray(scope.get(p.name))
                                  for p in main.all_parameters()})
    return out


def _one_process(model, kwargs, params, feeds):
    main, startup, loss = H.MODELS[model](tfluid, **kwargs)
    scope = tfluid.Scope()
    out = {"losses": [], "params": []}
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        convert.load_params_into_scope(params, scope, "cpu", program=main)
        for feed in feeds:
            out["losses"].append(float(exe.run(
                main, feed=feed, fetch_list=[loss])[0].reshape(-1)[0]))
            out["params"].append({p.name: scope.get(p.name).numpy().copy()
                                  for p in main.all_parameters()})
    return out


def _assert_close(got, want, tol, what, param_atol=None):
    for s in range(len(want["losses"])):
        g, w = got["losses"][s], want["losses"][s]
        assert abs(g - w) <= tol * abs(w), (what, s, g, w)
        for n, wv in want["params"][s].items():
            if param_atol is None:
                assert H.rel(got["params"][s][n], wv) <= tol, (what, s, n)
            else:
                err = float(np.abs(got["params"][s][n] - wv).max())
                assert err <= param_atol, (what, s, n, err)


def _bert_feeds():
    from paddle_tpu_torch.models import bert

    cfg = bert.BERT_TINY
    rng = np.random.RandomState(11)
    return [bert.make_fake_batch(4, BERT_SEQ, cfg, rng) for _ in range(2)]


# the configurations the 2-rank spawn trains, in order
CONFIGS2 = {
    "mlp": ("mlp", {}, {}),
    "zero1": ("mlp", {}, {"shard": True}),
    "bn": ("bn", {"layout": "NCHW"}, {"fuse_bn": False}),
    "bn_fused": ("bn", {"layout": "NHWC", "filters": 16},
                 {"fuse_bn": True}),
    "bert_tiny": ("bert_tiny", {"seq": BERT_SEQ}, {}),
}


def _feeds_for(name):
    if name in ("mlp", "zero1"):
        return H.mlp_feeds(STEPS, 8)
    if name == "bn":
        return H.bn_feeds(STEPS, 16)
    if name == "bn_fused":
        return H.bn_feeds(STEPS, 16, layout="NHWC")
    return _bert_feeds()


@pytest.fixture(scope="module")
def case_data():
    return {name: _reference_params(model, kwargs)
            for name, (model, kwargs, _) in CONFIGS2.items()}


@pytest.fixture(scope="module")
def two_ranks(case_data, tmp_path_factory):
    save = str(tmp_path_factory.mktemp("zero1_ckpt"))
    configs = []
    for name, (model, kwargs, options) in CONFIGS2.items():
        options = dict(options)
        if name == "zero1":
            options["save"] = save
        configs.append((model, kwargs, case_data[name], _feeds_for(name),
                        options))
    got = H.spawn(H.run_many, 2, tmp_path_factory.mktemp("dp2"), configs)
    return {name: [got[r][i] for r in range(2)]
            for i, name in enumerate(CONFIGS2)}, save


@pytest.mark.parametrize("name", ["mlp", "bert_tiny"])
def test_runner_at_two_ranks_matches_the_reference_runner(two_ranks,
                                                          case_data, name):
    """Losses (the mean over the ranks, the runner's ``loss_name``
    fetch) and parameters after every step against the reference's
    runner on the global batch; every rank holds the same parameters and
    the same loss."""
    model, kwargs, _ = CONFIGS2[name]
    got = two_ranks[0][name]
    want = _reference_run(model, kwargs, case_data[name], _feeds_for(name),
                          2)
    _assert_close(got[0], want, RUN_RTOL, name,
                  ADAM_STEP_ATOL if name == "bert_tiny" else None)
    for s in range(len(want["losses"])):
        assert got[1]["losses"][s] == got[0]["losses"][s]
        for n, v in got[0]["params"][s].items():
            assert np.array_equal(v, got[1]["params"][s][n]), (s, n)
    ops = got[0]["ops"]
    assert "c_allreduce_start" in ops or "c_fused_allreduce_sum" in ops


def test_runner_at_four_ranks_matches_the_reference_runner(tmp_path):
    params = _reference_params("mlp", {"opt": "momentum"})
    feeds = H.mlp_feeds(STEPS, 8, seed=4)
    got = H.spawn(H.run_compiled, 4, tmp_path, "mlp", {"opt": "momentum"},
                  params, feeds, {})
    want = _reference_run("mlp", {"opt": "momentum"}, params, feeds, 4)
    for r in range(4):
        _assert_close(got[r], want, RUN_RTOL, "rank %d" % r)


def test_zero1_matches_the_reference_and_holds_its_rows(two_ranks,
                                                        case_data):
    """ZeRO-1 at two ranks: parameters against the reference's
    ``shard_optimizer_state`` run and against the port's unsharded run;
    every Adam moment of the MLP (dim 0 of 16 and 32 divides by 2) is
    held as this rank's half of the rows, the moments' bytes are half
    the unsharded run's, and ``io.save_persistables`` writes each moment
    whole."""
    results, save = two_ranks
    got, plain = results["zero1"], results["mlp"]
    want = _reference_run("mlp", {}, case_data["zero1"],
                          _feeds_for("zero1"), 2, shard=True)
    _assert_close(got[0], want, RUN_RTOL, "zero1")
    _assert_close(got[0], plain[0], RUN_RTOL, "zero1 vs unsharded")
    main, _, _ = H.mlp(tfluid)
    moments = {v.name: v.shape for v in main.list_vars()
               if getattr(v, "_is_optimizer_state", False)}
    assert moments
    for r in range(2):
        shards = got[r]["shards"]
        assert set(shards) == set(moments), (sorted(shards), moments)
        for n, shape in moments.items():
            held, full, first = shards[n]
            assert full == shape[0] and held[0] == shape[0] // 2
            assert first == r * (shape[0] // 2)
        assert 2 * got[r]["acc_bytes"] == plain[r]["acc_bytes"]
    ops = got[0]["ops"]
    assert ops.count("c_allgather") == 4 and "fused_adam" not in ops
    for n, shape in moments.items():
        saved = np.load(os.path.join(save, n + ".npy"))
        assert saved.shape == tuple(shape), (n, saved.shape)


@pytest.mark.parametrize("name", ["bn", "bn_fused"])
def test_synchronized_batch_norm_matches_reference_and_one_process(
        two_ranks, case_data, name):
    """Two ranks of 8 images under the runner: the batch statistics are
    global (the running mean and variance too), so losses and
    parameters match the reference's DP run and one process on the 16
    images, through ``batch_norm`` (NCHW) and through
    ``fused_conv_bn_act`` (NHWC, the K4 path's op)."""
    model, kwargs, options = CONFIGS2[name]
    got = two_ranks[0][name]
    feeds = _feeds_for(name)
    ops = got[0]["ops"]
    if name == "bn_fused":
        assert "fused_conv_bn_act" in ops and "batch_norm" not in ops
    else:
        assert "batch_norm" in ops
    want = _reference_run(model, kwargs, case_data[name], feeds, 2,
                          fuse_bn=False)
    one = _one_process(model, kwargs, case_data[name], feeds)
    _assert_close(got[0], want, BN_RTOL, name + " vs reference")
    _assert_close(got[1], one, BN_RTOL, name + " vs one process")


def test_sync_batch_norm_op_sums_over_ring0_only_when_bound():
    """``sync_batch_norm`` is registered; with no ring bound it is
    ``batch_norm`` bit for bit."""
    from paddle_tpu_torch.ops import registry

    assert registry.has_op("sync_batch_norm")
    x = np.random.RandomState(0).randn(4, 3, 2, 2).astype("float32")
    outs = {}
    for op_type in ("batch_norm", "sync_batch_norm"):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.unique_name.guard(), \
                tfluid.program_guard(main, startup):
            img = tfluid.layers.data("img", shape=[3, 2, 2],
                                     dtype="float32")
            y = tfluid.layers.batch_norm(img)
        for op in main.global_block().ops:
            if op.type == "batch_norm":
                op.type = op_type
        with tfluid.scope_guard(tfluid.Scope()):
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup)
            outs[op_type] = exe.run(main, feed={"img": x},
                                    fetch_list=[y])[0]
    assert np.array_equal(outs["batch_norm"], outs["sync_batch_norm"])


def test_strategy_knobs_shape_the_runner():
    """``gradient_scale_strategy`` sets the exchange's ``pre_scale``
    (``CoeffNumDevice`` 1/N, ``One`` 1, ``Customized`` warns, 1/N);
    ``tensor_parallel_degree > 1`` and more places than cards raise."""
    from paddle_tpu_torch.parallel import SPMDRunner

    main, _, loss = H.mlp(tfluid)
    G = tfluid.BuildStrategy.GradientScaleStrategy
    for gss, want in ((G.CoeffNumDevice, 0.5), (G.One, 1.0),
                      (G.Customized, 0.5)):
        bs = tfluid.BuildStrategy()
        bs.gradient_scale_strategy = gss
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            clone, _ = SPMDRunner(main, bs)._dp_program(2, 0)
        scales = {op.attrs["pre_scale"] for op in clone.global_block().ops
                  if op.type == "c_allreduce_sum"}
        assert scales == {want}, (gss, scales)
        assert bool(w) == (gss == G.Customized)
        assert clone._sync_batch_stats and clone._num_trainers == 2
    bs = tfluid.BuildStrategy()
    bs.tensor_parallel_degree = 2
    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        SPMDRunner(main, bs)
    with pytest.raises(ValueError, match="CUDA device"):
        SPMDRunner(main, None, places=[tfluid.CUDAPlace(0)] * 64)


def test_parallel_executor_runs_the_runner_at_world_one():
    """``ParallelExecutor`` (the reference's shim) on the CPU: the plain
    executor's losses, bit for bit."""
    feeds = H.mlp_feeds(STEPS, 8)
    outs = []
    for use_pe in (False, True):
        main, startup, loss = H.mlp(tfluid)
        scope = tfluid.Scope()
        with tfluid.scope_guard(scope):
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup)
            if use_pe:
                pe = tfluid.ParallelExecutor(use_cuda=False,
                                             loss_name=loss.name,
                                             main_program=main, scope=scope)
                assert pe.device_count == 1
                outs.append([pe.run([loss], feed=f)[0] for f in feeds])
            else:
                outs.append([exe.run(main, feed=f, fetch_list=[loss])[0]
                             for f in feeds])
    assert np.array_equal(np.asarray(outs[0]), np.asarray(outs[1]))
