"""The collective fleet of the port (``paddle_tpu_torch/incubate/fleet``)
against the reference's: the role makers, ``CollectiveOptimizer.
minimize`` and its strategy knobs, and the fleet route run at two ranks.

``fleet.init`` initialises the ``torch.distributed`` group where the
reference starts JAX's coordination service; the two-rank test gives it
a ``file://`` store in a temp dir (``tests/torch_dist_helpers.py``,
``fleet_job``) and holds the route's losses and parameters to the
reference's runner on the global batch within ``RUN_RTOL`` 1e-5
(float32, another summation order), as ``tests/test_torch_dp_runner.py``
holds the runner's.
"""

import pytest

import paddle_tpu_torch as tfluid

import torch_dist_helpers as H
from test_torch_dp_runner import (RUN_RTOL, _assert_close,
                                  _reference_params, _reference_run)

_ENV = ("TRAINING_ROLE", "PADDLE_TRAINER_ID", "PADDLE_TRAINER_ENDPOINTS",
        "PADDLE_PSERVERS_IP_PORT_LIST", "PADDLE_TRAINERS_NUM",
        "PADDLE_COORDINATOR_ADDRESS")


def _role_view(rm):
    rm.generate_role()
    return (rm.is_worker(), rm.is_server(), rm.is_first_worker(),
            rm.worker_index(), rm.server_index(), rm.worker_num(),
            rm.server_num(), list(rm.get_trainer_endpoints()),
            list(rm.get_pserver_endpoints()))


@pytest.mark.parametrize("env", [
    {},
    {"PADDLE_TRAINER_ID": "1",
     "PADDLE_TRAINER_ENDPOINTS": "10.0.0.1:6170,10.0.0.2:6170"},
    {"TRAINING_ROLE": "PSERVER", "PADDLE_TRAINER_ID": "0",
     "PADDLE_PSERVERS_IP_PORT_LIST": "10.0.0.9:6000",
     "PADDLE_TRAINERS_NUM": "4"},
])
def test_role_makers_read_the_reference_environment(monkeypatch, env):
    from paddle_tpu.incubate.fleet.base import role_maker as jrm

    from paddle_tpu_torch.incubate.fleet.base import role_maker as trm

    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for make in (lambda m: m.PaddleCloudRoleMaker(),
                 lambda m: m.UserDefinedRoleMaker(
                     current_id=1, role=m.Role.SERVER, worker_num=3,
                     server_endpoints=["a:1"]),
                 lambda m: m.UserDefinedCollectiveRoleMaker(
                     current_id=2, worker_endpoints=["a:1", "b:1", "c:1"])):
        assert _role_view(make(trm)) == _role_view(make(jrm))


def _minimized(fluid, strategy_knobs):
    """An MLP minimized through the collective fleet's optimizer with
    ``strategy_knobs`` set on its ``DistributedStrategy``."""
    from importlib import import_module

    fc = import_module(fluid.__name__ + ".incubate.fleet.collective")
    rm = import_module(fluid.__name__ + ".incubate.fleet.base.role_maker")
    fc.fleet.init(rm.UserDefinedCollectiveRoleMaker(0, ["a:1"]))
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=32, act="relu")
        logits = fluid.layers.fc(input=h, size=4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        strategy = fc.DistributedStrategy()
        for k, v in strategy_knobs.items():
            setattr(strategy, k, v(h) if callable(v) else v)
        opt = fc.fleet.distributed_optimizer(
            fluid.optimizer.SGD(learning_rate=0.1), strategy)
        opt.minimize(loss)
    return main, startup


@pytest.mark.parametrize("knobs", [
    {},
    {"use_amp": True},
    {"use_recompute": True, "recompute_checkpoints": lambda h: [h]},
    {"use_recompute": True, "recompute_checkpoints": lambda h: [h],
     "use_amp": True},
], ids=["plain", "amp", "recompute", "recompute_in_amp"])
def test_collective_optimizer_minimize_gives_the_reference_program(knobs):
    import paddle_tpu as jfluid

    progs = [_minimized(fluid, knobs) for fluid in (jfluid, tfluid)]
    for j, t in zip(progs[0], progs[1]):
        assert H.ops_of(t) == H.ops_of(j)
    assert progs[1][0]._num_trainers == 1 and progs[1][0]._trainer_id == 0
    types = [op.type for op in progs[1][0].global_block().ops]
    assert ("recompute_block" in types) == bool(knobs.get("use_recompute"))
    assert ("cast" in types) == bool(knobs.get("use_amp"))


def test_use_local_sgd_gives_the_reference_program():
    """With two workers in the role, ``use_local_sgd`` appends the
    LocalSGD averaging as the reference's minimize does."""
    import paddle_tpu as jfluid

    progs = []
    for fluid in (jfluid, tfluid):
        from importlib import import_module

        fc = import_module(fluid.__name__ + ".incubate.fleet.collective")
        rm = import_module(fluid.__name__
                           + ".incubate.fleet.base.role_maker")
        role = rm.UserDefinedCollectiveRoleMaker(1, ["a:1", "b:1"])
        role.generate_role()
        fc.fleet._role_maker = role  # the role, without a rendezvous
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            loss = fluid.layers.mean(fluid.layers.fc(x, size=2))
            strategy = fc.DistributedStrategy()
            strategy.use_local_sgd = True
            fc.fleet.distributed_optimizer(
                fluid.optimizer.SGD(learning_rate=0.1),
                strategy).minimize(loss)
        progs.append((H.ops_of(main), H.ops_of(startup), main._num_trainers,
                      main._trainer_id))
    assert progs[1] == progs[0]
    assert progs[1][2:] == (2, 1)
    assert any(t == "c_allreduce_sum" for t, *_ in progs[1][0])


def test_auto_and_rendezvous_gaps_raise():
    from paddle_tpu_torch.incubate.fleet.base import role_maker
    from paddle_tpu_torch.incubate.fleet.collective import (
        Collective, DistributedStrategy)

    f = Collective()
    f.init(role_maker.UserDefinedCollectiveRoleMaker(0, ["a:1"]))
    s = DistributedStrategy()
    s.auto = True
    main = tfluid.Program()
    with tfluid.unique_name.guard(), \
            tfluid.program_guard(main, tfluid.Program()):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        loss = tfluid.layers.mean(tfluid.layers.fc(x, size=2))
        with pytest.raises(NotImplementedError, match="Queue A item 9"):
            f.distributed_optimizer(tfluid.optimizer.SGD(0.1),
                                    s).minimize(loss)
    g = Collective()
    with pytest.raises(RuntimeError, match="no rendezvous"):
        g.init(role_maker.UserDefinedRoleMaker(current_id=0, worker_num=2))
    with pytest.raises(NotImplementedError, match="no servers"):
        g.run_server()


def test_fleet_route_at_two_ranks_gives_the_runners_losses(tmp_path):
    params = _reference_params("mlp", {})
    feeds = H.mlp_feeds(3, 8)
    got = H.spawn(H.fleet_job, 2, tmp_path, params, feeds, init=False)
    want = _reference_run("mlp", {}, params, feeds, 2)
    for r in range(2):
        assert got[r]["world"] == 2 and got[r]["marks"] == (2, r)
        _assert_close(got[r], want, RUN_RTOL, "fleet rank %d" % r)
