"""Host-resident embedding tables of the PyTorch port
(``paddle_tpu_torch/host_table.py``, ``layers.host_embedding``, the
executor's prefetch and push): the reference's ``tests/test_host_table.py``
oracles, run against the port, and its losses against the reference's.

1. a DeepFM-style model on ``host_embedding`` trains step for step as
   the same model on a device ``embedding`` started from the same table
   (both sum duplicate ids' gradients before SGD), within 1e-5;
2. no step of the executor reads a [V, D] tensor: only the slab;
3. checkpoints round-trip in the per-shard layout, with a reshard, and
   ``save_persistables`` / ``load_persistables`` carry host tables and
   the Adagrad accumulator;
4. ``models.ctr``'s host path (the plain executor, the
   ``with_data_parallel`` route at world 1 and ``train_from_dataset``)
   gives the reference's losses within 1e-5, the reference's tables and
   the port's starting from the same numbers (crc32 of the name);
5. the refusals: a spec mismatch, ``batch_merge_repeat`` or
   ``num_iteration_per_run`` above 1, a process group of two ranks.
"""

import os

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import host_table as jhost
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.models import ctr as jctr

import paddle_tpu_torch as fluid
from paddle_tpu_torch import host_table
from paddle_tpu_torch.convert import load_params_into_scope, \
    scope_persistables
from paddle_tpu_torch.executor import Scope, scope_guard
from paddle_tpu_torch.models import ctr

V, D, B, F = 50000, 16, 8, 3  # vocab deliberately >> batch rows touched
STEPS = 6
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_tables(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")
    host_table.reset_tables()
    jhost.reset_tables()
    yield
    host_table.reset_tables()
    jhost.reset_tables()


def _batches():
    rng = np.random.RandomState(3)
    ids = rng.randint(0, V, size=(B, F)).astype("int64")
    ids[:, 1] = ids[:, 0]  # duplicate ids in every row
    y = rng.randint(0, 2, size=(B, 1)).astype("float32")
    for _ in range(STEPS):
        yield ids, y


def _deep_part(emb3d):
    flat = fluid.layers.flatten(emb3d, axis=1)
    h = fluid.layers.fc(
        flat, size=8, act="relu",
        param_attr=fluid.ParamAttr(
            name="deep.w",
            initializer=fluid.initializer.NumpyArrayInitializer(
                np.random.RandomState(5).uniform(
                    -0.1, 0.1, (F * D, 8)).astype("float32"))),
        bias_attr=fluid.ParamAttr(
            name="deep.b", initializer=fluid.initializer.Constant(0.0)))
    return fluid.layers.fc(
        h, size=1,
        param_attr=fluid.ParamAttr(
            name="head.w",
            initializer=fluid.initializer.NumpyArrayInitializer(
                np.random.RandomState(6).uniform(
                    -0.1, 0.1, (8, 1)).astype("float32"))),
        bias_attr=fluid.ParamAttr(
            name="head.b", initializer=fluid.initializer.Constant(0.0)))


def _program(emb_fn):
    fluid.unique_name.switch()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data("ids", shape=[B, F], dtype="int64",
                                append_batch_size=False)
        y = fluid.layers.data("y", shape=[B, 1], dtype="float32",
                              append_batch_size=False)
        logit = _deep_part(emb_fn(ids))
        loss = fluid.layers.mean(
            fluid.layers.sigmoid_cross_entropy_with_logits(logit, y))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def _train(main, startup, loss):
    exe = fluid.Executor(fluid.CPUPlace())
    losses = []
    with scope_guard(Scope()):
        exe.run(startup)
        for ids_v, y_v in _batches():
            (lv,) = exe.run(main, feed={"ids": ids_v, "y": y_v},
                            fetch_list=[loss])
            losses.append(float(np.asarray(lv).reshape(())))
    return losses, exe


def _train_host():
    main, startup, loss = _program(
        lambda ids: fluid.layers.host_embedding(
            ids, size=[V, D], name="ctr.tbl", lr=0.1, optimizer="sgd"))
    losses, exe = _train(main, startup, loss)
    host_table.get_table("ctr.tbl").join()
    return losses, main, exe


def test_ctr_loss_parity_host_vs_device():
    host_losses, _, _ = _train_host()
    host_table.reset_tables()
    t = host_table.get_or_create("ctr.tbl", V, D, lr=0.1, optimizer="sgd")
    table0 = t.value.copy()
    main, startup, loss = _program(
        lambda ids: fluid.layers.embedding(
            ids, size=[V, D], param_attr=fluid.ParamAttr(
                name="dev.tbl",
                initializer=fluid.initializer.NumpyArrayInitializer(
                    table0))))
    dev_losses, _ = _train(main, startup, loss)
    np.testing.assert_allclose(host_losses, dev_losses, rtol=LOSS_RTOL)
    assert host_losses[-1] < host_losses[0]


def test_device_never_sees_the_table():
    _, main, exe = _train_host()
    assert exe._cache
    for compiled in exe._cache.values():
        for n in compiled.rw_names + compiled.ro_names:
            v = main.global_block()._find_var_recursive(n)
            assert v is None or list(v.shape or ()) != [V, D], n
        if compiled.reads is not None:  # the bound step's tensors
            assert all(t.numel() < V * D for t in compiled.reads.values())
    assert any(any("@SLAB@" in n for n in c.feed_names)
               for c in exe._cache.values())
    assert exe.last_run_mode == "graph"


def test_tables_start_as_the_reference_tables():
    for opt in ("sgd", "adagrad"):
        a = host_table.get_or_create("same.%s" % opt, 300, 5, optimizer=opt,
                                     seed=4)
        b = jhost.get_or_create("same.%s" % opt, 300, 5, optimizer=opt,
                                seed=4)
        np.testing.assert_array_equal(a.value, b.value)
        ids = np.array([1, 1, 7, 299, 400, -2], "int64")
        g = np.random.RandomState(1).randn(6, 5).astype("float32")
        a.update_async(ids, g)
        b.update_async(ids, g)
        np.testing.assert_array_equal(a.lookup(ids), b.lookup(ids))


def test_checkpoint_roundtrip_and_reshard(tmp_path):
    t = host_table.get_or_create("ck.tbl", 1000, 8, lr=0.1)
    orig = t.value.copy()
    d = str(tmp_path)
    t.save(d, rows_per_shard=128)  # 8 row-range shards
    t.value[:] = 0.0
    t.load(d)
    np.testing.assert_array_equal(t.value, orig)
    t.save(d, rows_per_shard=333)
    t.value[:] = -1.0
    t.load(d)
    np.testing.assert_array_equal(t.value, orig)
    # the reference reads the port's checkpoint, and the reverse
    r = jhost.get_or_create("ck.tbl", 1000, 8, lr=0.1)
    r.value[:] = 0.0
    r.load(d)
    np.testing.assert_array_equal(r.value, orig)
    r.value += 1.0
    r.save(d, rows_per_shard=250)
    t.load(d)
    np.testing.assert_array_equal(t.value, orig + 1.0)
    wrong = host_table.HostTable("ck.tbl", 999, 8)
    with pytest.raises(ValueError, match="shape"):
        wrong.load(d)


def test_deepfm_model_with_host_tables_trains():
    fluid.unique_name.switch()
    main, startup, feeds, loss, prob = ctr.build(
        model="deepfm", num_slots=4, slot_len=3, vocab=100000,
        use_host_table=True, host_lr=0.05)
    rng = np.random.RandomState(9)
    feed = {"slot_%d" % i: rng.randint(0, 100000, (8, 3)).astype("int64")
            for i in range(4)}
    feed["label"] = rng.randint(0, 2, (8, 1)).astype("int64")
    exe = fluid.Executor(fluid.CPUPlace())
    losses = []
    with scope_guard(Scope()):
        exe.run(startup)
        for _ in range(8):
            (lv,) = exe.run(main, feed=feed, fetch_list=[loss])
            losses.append(float(np.asarray(lv).reshape(())))
    assert losses[-1] < losses[0], losses


def _ref_params():
    """The reference host DeepFM's startup parameters (fc weights and
    Adam state): the port's own draws differ."""
    jfluid.unique_name.switch()
    main, startup, _, _, _ = jctr.build(
        model="deepfm", num_slots=4, slot_len=3, vocab=30000,
        use_host_table=True, host_lr=0.05)
    scope = JScope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
    jhost.reset_tables()
    return scope_persistables(main, scope)


@pytest.mark.parametrize("data_parallel", [False, True])
def test_host_deepfm_losses_match_reference(monkeypatch, data_parallel):
    """``run_deepfm_host_table_steps`` in both packages from the same
    parameters: the reference on its plain executor (and its 8-device
    mesh under ``data_parallel``), the port on the executor and through
    ``with_data_parallel`` at world 1."""
    params = _ref_params()
    ref = jctr.run_deepfm_host_table_steps(steps=5, vocab=30000)
    jhost.reset_tables()
    ref_dp = jctr.run_deepfm_host_table_steps(steps=5, vocab=30000,
                                              data_parallel=True)
    np.testing.assert_allclose(ref_dp, ref, rtol=1e-4)

    # the recipe builds and starts its own program: take the reference's
    # parameters right after its startup run
    built, real_build, real_run = [], ctr.build, fluid.Executor.run

    def build(*a, **kw):
        out = real_build(*a, **kw)
        built.append(out)
        return out

    def run(self, program=None, *a, **kw):
        out = real_run(self, program, *a, **kw)
        if built and program is built[-1][1]:
            load_params_into_scope(params, fluid.global_scope(),
                                   program=built[-1][0])
        return out

    monkeypatch.setattr(ctr, "build", build)
    monkeypatch.setattr(fluid.Executor, "run", run)
    got = ctr.run_deepfm_host_table_steps(
        steps=5, vocab=30000, data_parallel=data_parallel,
        place=fluid.CPUPlace())
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    assert got[-1] < got[0]


def test_host_table_with_train_from_dataset(tmp_path):
    rng = np.random.RandomState(11)
    path = str(tmp_path / "part-0")
    with open(path, "w") as f:
        for _ in range(32):
            y = rng.randint(0, 2)
            ids = rng.randint(1, 5000, 3)
            f.write("1 %d 3 %s\n" % (y, " ".join(map(str, ids))))

    fluid.unique_name.switch()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        slot = fluid.layers.data("slot", shape=[3], dtype="int64")
        slab = fluid.layers.host_embedding(slot, size=[5000, 8],
                                           name="ds.tbl", lr=0.1)
        pooled = fluid.layers.reduce_sum(slab, dim=1)
        logit = fluid.layers.fc(pooled, size=1)
        loss = fluid.layers.mean(
            fluid.layers.sigmoid_cross_entropy_with_logits(
                logit, fluid.layers.cast(label, "float32")))
        fluid.optimizer.SGD(0.1).minimize(loss)

    dataset = fluid.DatasetFactory().create_dataset("InMemoryDataset")
    dataset.set_use_var([label, slot])
    dataset.set_batch_size(8)
    dataset.set_filelist([path])
    dataset.load_into_memory()

    t0 = host_table.get_table("ds.tbl").value.copy()
    exe = fluid.Executor(fluid.CPUPlace())
    with scope_guard(Scope()):
        exe.run(startup)
        results = exe.train_from_dataset(
            program=main, dataset=dataset, fetch_list=[loss],
            print_period=100)
    assert len(results) == 4  # 32 / 8
    assert all(np.isfinite(r[0]).all() for r in results)
    t = host_table.get_table("ds.tbl")
    t.join()
    assert (t.value != t0).any()


def test_adagrad_accumulator_survives_checkpoint(tmp_path):
    t = host_table.get_or_create("ada.tbl", 100, 4, lr=0.1,
                                 optimizer="adagrad")
    ids = np.array([1, 1, 7], "int64")
    g = np.ones((3, 4), "float32")
    t.update_async(ids, g)
    t.join()
    acc = t._accum.copy()
    assert acc[1].sum() > 0
    d = str(tmp_path)
    t.save(d)
    t._accum[:] = 0
    t.value[:] = 0
    t.load(d)
    np.testing.assert_array_equal(t._accum, acc)
    assert os.path.exists(os.path.join(d, "ada.tbl.shards", "meta.json"))


def test_get_or_create_rejects_spec_mismatch():
    host_table.get_or_create("m.tbl", 10, 4, lr=0.1)
    with pytest.raises(ValueError, match="already exists"):
        host_table.get_or_create("m.tbl", 20, 4, lr=0.1)
    with pytest.raises(ValueError, match="sgd or adagrad"):
        host_table.HostTable("x", 2, 2, optimizer="adam")


def test_save_load_persistables_includes_host_tables(tmp_path):
    _, main, exe = _train_host()
    t = host_table.get_table("ctr.tbl")
    trained = t.value.copy()
    d = str(tmp_path)
    fluid.io.save_persistables(exe, d, main)
    t.value[:] = 0.0
    fluid.io.load_persistables(exe, d, main)
    np.testing.assert_array_equal(t.value, trained)


def _host_program():
    fluid.unique_name.switch()
    main, startup, feeds, loss, _ = ctr.build(
        model="deepfm", num_slots=2, slot_len=3, vocab=1000,
        use_host_table=True)
    rng = np.random.RandomState(0)
    feed = {"slot_%d" % i: rng.randint(0, 1000, (4, 3)).astype("int64")
            for i in range(2)}
    feed["label"] = np.zeros((4, 1), "int64")
    return main, startup, loss, feed


@pytest.mark.parametrize("knob", ["batch_merge_repeat",
                                  "num_iteration_per_run"])
def test_runner_refuses_host_tables_with_scans(knob):
    main, startup, loss, feed = _host_program()
    bs, es = fluid.BuildStrategy(), fluid.ExecutionStrategy()
    if knob == "batch_merge_repeat":
        bs.batch_merge_repeat = 2
    else:
        es.num_iteration_per_run = 2
    cp = fluid.CompiledProgram(main, bs).with_data_parallel(
        loss_name=loss.name, exec_strategy=es)
    exe = fluid.Executor(fluid.CPUPlace())
    with scope_guard(Scope()):
        exe.run(startup)
        with pytest.raises(RuntimeError, match=knob):
            exe.run(cp, feed=feed, fetch_list=[loss])


def test_host_tables_refuse_a_process_group_of_two(monkeypatch):
    import torch.distributed as dist

    main, startup, loss, feed = _host_program()
    exe = fluid.Executor(fluid.CPUPlace())
    with scope_guard(Scope()):
        exe.run(startup)
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
        with pytest.raises(RuntimeError, match="2 ranks"):
            exe.run(main, feed=feed, fetch_list=[loss])
        monkeypatch.setattr(dist, "get_world_size", lambda *a: 1)
        exe.run(main, feed=feed, fetch_list=[loss])


def test_ids_must_be_fed():
    main, startup, loss, feed = _host_program()
    exe = fluid.Executor(fluid.CPUPlace())
    with scope_guard(Scope()):
        exe.run(startup)
        with pytest.raises(RuntimeError, match="fed directly"):
            exe.run(main, feed={"label": feed["label"]}, fetch_list=[loss])
