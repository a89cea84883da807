"""The port's CTR data path against the reference's: the MultiSlot
parsers (``native``, C++ and its Python twin), ``DatasetFactory`` →
``QueueDataset`` / ``InMemoryDataset`` batches (shuffled and not),
``Executor.train_from_dataset`` (losses and printed lines),
``MultiSlotDataGenerator`` text, the ``TrainerFactory`` / ``DataFeedDesc``
wiring and RecordIO files across the two packages.

Data is MultiSlot text written from seeds, as ``examples/deepfm_ctr.py``
writes it, with ragged slots (shorter and longer than the declared
length) and malformed lines; arrays must be equal, losses within 1e-5
relative (DeepFM at dim 128 on device tables, the reference's K3 in
interpret mode)."""

import contextlib
import io
import os
import re
import unittest.mock as mock

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import native as jnative
from paddle_tpu import recordio_writer as jrio
from paddle_tpu.dataset import DatasetFactory as JDatasetFactory
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.models import ctr as jctr

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import native as tnative
from paddle_tpu_torch import recordio_writer as trio
from paddle_tpu_torch.convert import load_params_into_scope, \
    scope_persistables
from paddle_tpu_torch.executor import Scope
from paddle_tpu_torch.models import ctr as tctr

SLOTS, LEN, VOCAB = 4, 3, 2000
LOSS_RTOL = 1e-5


def write_multislot(path, n_lines, seed, ragged=False, bad=False):
    """``n_lines`` examples of SLOTS id slots and a label slot; with
    ``ragged`` a slot holds 1 to LEN + 2 ids; with ``bad`` every 7th line
    is malformed (a zero count, a short slot or a word)."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for n in range(n_lines):
            if bad and n % 7 == 3:
                f.write(["0 1 2", "3 5 6", "# comment"][n % 3] + "\n")
                continue
            parts, click = [], 0
            for _ in range(SLOTS):
                k = rng.randint(1, LEN + 3) if ragged else LEN
                ids = rng.randint(0, VOCAB, k)
                click ^= int(ids.sum()) & 1
                parts.append("%d %s" % (k, " ".join(str(i) for i in ids)))
            parts.append("1 %d" % click)
            f.write(" ".join(parts) + "\n")
    return path


@pytest.fixture
def files(tmp_path):
    return [write_multislot(str(tmp_path / ("part-%d" % i)), 37, seed=i,
                            ragged=True, bad=True) for i in range(2)]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")


def _python_parse(native, *args, **kw):
    with mock.patch.object(native, "get_lib", return_value=None):
        return native.parse_multislot_file(*args, **kw)


def test_native_library_is_built_and_parsers_agree(files, tmp_path):
    assert tnative.is_native()
    types = ["uint64"] * SLOTS + ["uint64"]
    lens = [LEN] * SLOTS + [1]
    for path in files:
        native = tnative.parse_multislot_file(path, types, lens, threads=3)
        python = _python_parse(tnative, path, types, lens)
        ref = jnative.parse_multislot_file(path, types, lens)
        ref_py = _python_parse(jnative, path, types, lens)
        assert len(native) == len(python) == len(ref) == SLOTS + 1
        for a, b, c, d in zip(native, python, ref, ref_py):
            assert a.dtype == np.int64 and a.shape == c.shape
            for other in (b, c, d):
                np.testing.assert_array_equal(a, other)
    # floats, a uint64 feasign past 2^63 (wraps two's-complement) and
    # clipping of a long slot
    path = str(tmp_path / "mixed")
    with open(path, "w") as f:
        f.write("2 0.5 -1.25 1 18446744073709551615 4 1 2 3 4\n")
        f.write("1 3.5 1 7 1 9\n")
    types, lens = ["float", "uint64", "uint64"], [3, 1, 2]
    got = tnative.parse_multislot_file(path, types, lens)
    for a, b, c in zip(got, _python_parse(tnative, path, types, lens),
                       jnative.parse_multislot_file(path, types, lens)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(got[0], [[0.5, -1.25, 0], [3.5, 0, 0]])
    assert got[1][0, 0] == -1 and got[2].tolist() == [[1, 2], [9, 0]]


def _program(fluid, ctr):
    fluid.unique_name.switch()
    return ctr.build(model="deepfm", num_slots=SLOTS, slot_len=LEN,
                     vocab=VOCAB, embed_dim=128)


def _batches(fluid, factory, ctr, kind, files, shuffle, batch=8):
    _, _, feeds, _, _ = _program(fluid, ctr)
    ds = factory().create_dataset(kind)
    ds.set_batch_size(batch)
    ds.set_use_var(feeds)
    ds.set_filelist(files)
    ds.set_thread(2)
    if kind == "InMemoryDataset":
        ds.load_into_memory()
        if shuffle:
            ds.local_shuffle()
    return list(ds.batch_iterator())


@pytest.mark.parametrize("kind,shuffle", [("QueueDataset", False),
                                          ("InMemoryDataset", False),
                                          ("InMemoryDataset", True)])
def test_dataset_batches_match_reference(files, kind, shuffle):
    got = _batches(tfluid, tfluid.DatasetFactory, tctr, kind, files,
                   shuffle)
    ref = _batches(jfluid, JDatasetFactory, jctr, kind, files, shuffle)
    assert len(got) == len(ref) == 8  # 64 good lines, batches of 8
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for n in g:
            assert g[n].dtype == r[n].dtype and g[n].shape == r[n].shape
            np.testing.assert_array_equal(g[n], r[n])
    if shuffle:
        plain = _batches(tfluid, tfluid.DatasetFactory, tctr, kind, files,
                         False)
        assert any((a["slot_0"] != b["slot_0"]).any()
                   for a, b in zip(got, plain))


def test_dataset_shuffle_refusals_and_memory(files):
    _, _, feeds, _, _ = _program(tfluid, tctr)
    m = tfluid.DatasetFactory().create_dataset("InMemoryDataset")
    m.set_use_var(feeds)
    m.set_filelist(files)
    m.load_into_memory()
    assert m.get_memory_data_size() == m.get_shuffle_data_size() == 64
    m.release_memory()
    assert m.get_memory_data_size() == 0
    assert len(list(m.batch_iterator())) == 64  # streams again, batch 1
    q = tfluid.DatasetFactory().create_dataset("QueueDataset")
    with pytest.raises(NotImplementedError):
        q.local_shuffle()
    m = tfluid.DatasetFactory().create_dataset("InMemoryDataset")
    with pytest.raises(RuntimeError, match="load_into_memory"):
        m.local_shuffle()
    with pytest.raises(ValueError, match="unknown dataset"):
        tfluid.DatasetFactory().create_dataset("BoxDataset")


def _train_from_dataset(fluid, factory, ctr, files, params=None,
                        kind="InMemoryDataset"):
    main, startup, feeds, loss, _ = _program(fluid, ctr)
    ds = factory().create_dataset(kind)
    ds.set_batch_size(8)
    ds.set_use_var(feeds)
    ds.set_filelist(files)
    if kind == "InMemoryDataset":
        ds.load_into_memory()
        ds.local_shuffle()
    exe = fluid.Executor(fluid.CPUPlace())
    scope = JScope() if fluid is jfluid else Scope()
    exe.run(startup, scope=scope)
    if params is not None:
        load_params_into_scope(params, scope, program=main)
    start = scope_persistables(main, scope)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = exe.train_from_dataset(program=main, dataset=ds, scope=scope,
                                     fetch_list=[loss], fetch_info=["loss"],
                                     print_period=3)
    return out, buf.getvalue().splitlines(), start, main


@pytest.mark.parametrize("kind", ["QueueDataset", "InMemoryDataset"])
def test_train_from_dataset_matches_reference(files, kind):
    ref, ref_lines, start, _ = _train_from_dataset(
        jfluid, JDatasetFactory, jctr, files, kind=kind)
    got, lines, _, main = _train_from_dataset(
        tfluid, tfluid.DatasetFactory, tctr, files, params=start, kind=kind)
    assert len(got) == len(ref) == 8
    for g, r in zip(got, ref):
        assert isinstance(g[0], np.ndarray)
        np.testing.assert_allclose(g[0], np.asarray(r[0]), rtol=LOSS_RTOL)
    # the same lines at the same steps: the numbers within the tolerance
    pat = re.compile(r"^\[paddle_tpu\] step (\d+): loss=\[(.*)\]$")
    assert len(lines) == len(ref_lines) == 3
    for a, b in zip(lines, ref_lines):
        ma, mb = pat.match(a), pat.match(b)
        assert ma and mb and ma.group(1) == mb.group(1), (a, b)
        np.testing.assert_allclose(float(ma.group(2)), float(mb.group(2)),
                                   rtol=LOSS_RTOL)
    desc = main._trainer_desc
    assert type(desc).__name__ == "MultiTrainer"
    assert type(desc._device_worker).__name__ == "Hogwild"
    assert desc._print_period == 3 and desc._fetch_info == ["loss"]


def test_train_from_dataset_syncs_once_a_print_window(files):
    from paddle_tpu_torch import pipeline

    pipeline.reset_sync_stats()
    out, lines, _, _ = _train_from_dataset(
        tfluid, tfluid.DatasetFactory, tctr, files)
    # 8 steps, printed at 0, 3, 6: one sync each, then the last window
    # (step 7), then the per-step numpy of already synced handles
    assert pipeline.sync_stats()["syncs"] == 4, pipeline.sync_stats()


def test_infer_from_dataset_leaves_the_parameters(files):
    main, startup, feeds, loss, prob = _program(tfluid, tctr)
    test_prog = main.clone(for_test=True)
    ds = tfluid.DatasetFactory().create_dataset("QueueDataset")
    ds.set_batch_size(16)
    ds.set_use_var(feeds)
    ds.set_filelist(files)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = Scope()
    exe.run(startup, scope=scope)
    before = scope_persistables(main, scope)
    out = exe.infer_from_dataset(program=test_prog, dataset=ds, scope=scope,
                                 fetch_list=[prob], print_period=0)
    assert [o[0].shape for o in out] == [(16, 1)] * 4
    after = scope_persistables(main, scope)
    for n in before:
        np.testing.assert_array_equal(before[n], after[n])
    assert test_prog._trainer_desc._infer


class _Gen:
    """A MultiSlotDataGenerator of three slots, one of them float."""

    @staticmethod
    def make(pkg):
        class Gen(pkg.MultiSlotDataGenerator):
            def generate_sample(self, line):
                def it():
                    rng = np.random.RandomState(5)
                    for i in range(7):
                        ids = [int(x) for x in rng.randint(1, 99, 1 + i % 3)]
                        yield [("ids", ids), ("dense", [0.5 * i, 1.25]),
                               ("label", [i % 2])]
                return it

        return Gen()


def _generated(pkg, batch):
    gen = _Gen.make(pkg)
    gen.set_batch(batch)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        gen.run_from_memory()
    return buf.getvalue(), gen._proto_info


@pytest.mark.parametrize("batch", [1, 3])
def test_data_generator_text_matches_reference(batch):
    from paddle_tpu.incubate import data_generator as jdg

    from paddle_tpu_torch.incubate import data_generator as tdg

    got = _generated(tdg, batch)
    assert got == _generated(jdg, batch)
    assert got[1] == [("ids", "uint64"), ("dense", "float"),
                      ("label", "uint64")]
    string = tdg.MultiSlotStringDataGenerator()
    assert string._gen_str([("a", ["1", "2"]), ("b", ["x"])]) \
        == jdg.MultiSlotStringDataGenerator()._gen_str(
            [("a", ["1", "2"]), ("b", ["x"])])
    with pytest.raises(ValueError, match="empty"):
        tdg.MultiSlotDataGenerator()._gen_str([("a", [])])


def test_data_generator_output_trains_through_the_dataset(tmp_path):
    """Generator text → file → InMemoryDataset batches."""
    from paddle_tpu_torch.incubate import data_generator as tdg

    text, _ = _generated(tdg, 3)
    path = str(tmp_path / "gen.txt")
    with open(path, "w") as f:
        f.write(text)
    tfluid.unique_name.switch()
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        ids = tfluid.layers.data("ids", shape=[3], dtype="int64")
        dense = tfluid.layers.data("dense", shape=[2], dtype="float32")
        label = tfluid.layers.data("label", shape=[1], dtype="int64")
    ds = tfluid.DatasetFactory().create_dataset("InMemoryDataset")
    ds.set_use_var([ids, dense, label])
    ds.set_batch_size(7)
    ds.set_filelist([path])
    ds.load_into_memory()
    (b,) = list(ds.batch_iterator())
    assert b["ids"].shape == (7, 3) and b["dense"].dtype == np.float32
    np.testing.assert_array_equal(b["label"].ravel(), [0, 1] * 3 + [0])


def test_trainer_factory_and_desc_wiring(tmp_path):
    from paddle_tpu import trainer_desc as jtd

    from paddle_tpu_torch import device_worker, trainer_desc

    f = trainer_desc.TrainerFactory()
    for name, worker in (("MultiTrainer", "Hogwild"),
                         ("DistMultiTrainer", "DownpourSGD"),
                         ("PipelineTrainer", "Section")):
        t = f._create_trainer({"trainer": name})
        r = jtd.TrainerFactory()._create_trainer({"trainer": name})
        assert type(t).__name__ == type(r).__name__ == name
        assert type(t._device_worker).__name__ \
            == type(r._device_worker).__name__ == worker
        assert t._device_worker._trainer is t
    t = f._create_trainer({"trainer": "MultiTrainer",
                           "device_worker": "DownpourSGD"})
    assert isinstance(t._device_worker, device_worker.DownpourSGD)
    with pytest.warns(UserWarning, match="unknown trainer"):
        assert type(f._create_trainer({"trainer": "Nope"})).__name__ \
            == "MultiTrainer"
    # DataFeedDesc: parse, tune, serialize as the reference
    proto = str(tmp_path / "feed.proto")
    with open(proto, "w") as fh:
        fh.write('name: "MultiSlotDataFeed"\nbatch_size: 2\n'
                 'multi_slot_desc {\n  slots {\n    name: "words"\n'
                 '    type: "uint64"\n    is_dense: false\n'
                 '    is_used: false\n  }\n  slots {\n    name: "label"\n'
                 '    type: "uint64"\n    is_dense: false\n'
                 '    is_used: false\n  }\n}\n')
    descs = []
    for pkg in (tfluid, jfluid):
        d = pkg.DataFeedDesc(proto)
        d.set_batch_size(128)
        d.set_dense_slots(["words"])
        d.set_use_slots(["words", "label"])
        descs.append(d.desc())
    assert descs[0] == descs[1] and "batch_size: 128" in descs[0]


def test_recordio_files_cross_between_the_packages(tmp_path):
    rng = np.random.RandomState(0)
    samples = [(rng.randn(3, 4).astype("float32"),
                np.array([i], "int64")) for i in range(25)]

    def reader():
        return iter(samples)

    for writer, reader_pkg in ((trio, jrio), (jrio, trio)):
        path = str(tmp_path / ("%s.rio" % writer.__name__.split(".")[0]))
        assert writer.convert_reader_to_recordio_file(
            path, reader, max_num_records=7) == 25
        got = list(reader_pkg.recordio_reader(path)())
        assert len(got) == 25
        for (a, b), (c, d) in zip(got, samples):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    # the Python twin reads what the C++ writer wrote, and the reverse
    path = str(tmp_path / "twin.rio")
    records = [os.urandom(n) for n in (1, 100, 4096)]
    with tnative.RecordIOWriter(path, max_chunk_records=2) as w:
        for r in records:
            w.write(r)
    with mock.patch.object(tnative, "get_lib", return_value=None):
        with tnative.RecordIOScanner(path) as s:
            assert list(s) == records
        path2 = str(tmp_path / "twin2.rio")
        with tnative.RecordIOWriter(path2, max_chunk_records=2) as w:
            for r in records:
                w.write(r)
    with tnative.RecordIOScanner(path2) as s:
        assert list(s) == records
    paths = trio.convert_reader_to_recordio_files(
        str(tmp_path / "multi"), 10, reader)
    assert [len(list(trio.recordio_reader(p)())) for p in paths] \
        == [10, 10, 5]


def test_blocking_queue_native_and_python():
    for native_on in (True, False):
        ctx = (contextlib.nullcontext() if native_on else
               mock.patch.object(tnative, "get_lib", return_value=None))
        with ctx:
            q = tnative.BlockingQueue(capacity=4)
        for i in range(3):
            assert q.push({"i": i, "a": np.arange(i)})
        assert q.size() == 3
        got = [q.pop() for _ in range(3)]
        assert [g["i"] for g in got] == [0, 1, 2]
        q.close()
        assert q.pop() is None and not q.push(1)
