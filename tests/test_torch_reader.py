"""The port's reader path against the reference's: every reader decorator
of ``reader_decorators`` (with ``fluid.batch``) and the creators on
seeded readers, ``PyReader`` / ``DataLoader.from_generator`` batches
(double-buffered and not), the ``layers`` reader names, ``DataFeeder``
feed dicts, ``LoDTensor``, ``datasets.mnist``'s synthetic samples (byte
for byte) and the MNIST MLP's losses through ``fluid.batch`` →
``DataLoader`` (5 steps, within 1e-5 relative, from the reference's
parameters)."""

import random

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import datasets as jdatasets
from paddle_tpu import reader_decorators as jrd
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.models import mnist as jmnist

import paddle_tpu_torch as fluid
from paddle_tpu_torch import datasets
from paddle_tpu_torch import reader_decorators as rd
from paddle_tpu_torch.convert import load_params_into_scope, \
    scope_persistables
from paddle_tpu_torch.executor import Scope
from paddle_tpu_torch.models import mnist

LOSS_RTOL = 1e-5


def _samples(n=23, seed=0):
    def reader():
        rng = np.random.RandomState(seed)
        for i in range(n):
            yield (rng.randn(3).astype("float32"), i)

    return reader


def _nums(n=10):
    def reader():
        return iter(range(n))

    return reader


def _same(a, b):
    """Nested samples equal, arrays by value."""
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], np.asarray(b[k]))
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _square(x):
    return (x[0] * x[0], x[1])


def _pair_sum(a, b):
    return a + b


DECORATED = {
    "batch": lambda m: m.batch(_samples(), 5),
    "batch_drop_last": lambda m: m.batch(_samples(), 5, drop_last=True),
    "cache": lambda m: m.cache(_samples()),
    "map_readers": lambda m: m.map_readers(_pair_sum, _nums(7), _nums(9)),
    "chain": lambda m: m.chain(_nums(3), _samples(4), _nums(2)),
    "compose": lambda m: m.compose(_samples(6), _nums(6)),
    "compose_unchecked": lambda m: m.compose(_samples(6), _nums(4),
                                             check_alignment=False),
    "buffered": lambda m: m.buffered(_samples(), 3),
    "firstn": lambda m: m.firstn(_samples(), 7),
    "xmap_ordered": lambda m: m.xmap_readers(_square, _samples(40), 4, 8,
                                             order=True),
    "np_array": lambda m: m.np_array(np.arange(12).reshape(4, 3)),
    "fake": lambda m: m.Fake()(_samples(), 5),
    "shuffle": lambda m: m.shuffle(_samples(), 7),
    "batch_of_shuffle": lambda m: m.batch(m.shuffle(_samples(), 100), 4),
}


@pytest.mark.parametrize("name", sorted(DECORATED))
def test_decorator_matches_reference(name):
    random.seed(17)
    ref = list(DECORATED[name](jrd)())
    random.seed(17)
    got = list(DECORATED[name](rd)())
    _same(got, ref)
    if name == "cache":  # a second pass replays the first
        r = DECORATED[name](rd)
        assert len(list(r())) == len(list(r())) == 23


def test_unordered_xmap_and_compose_misaligned():
    got = list(rd.xmap_readers(_square, _samples(40), 4, 8)())
    ref = list(jrd.xmap_readers(_square, _samples(40), 4, 8)())
    assert sorted(g[1] for g in got) == sorted(r[1] for r in ref)
    with pytest.raises(rd.ComposeNotAligned):
        list(rd.compose(_nums(3), _nums(4))())

    def boom():
        yield 1
        raise KeyError("reader failed")

    with pytest.raises(KeyError):
        list(rd.buffered(boom, 2)())
    with pytest.raises(KeyError):
        list(rd.xmap_readers(lambda x: x, boom, 2, 2)())


def test_file_creators_match_reference(tmp_path):
    path = str(tmp_path / "lines.txt")
    with open(path, "w") as f:
        f.write("a b\nc\n\nd e f\n")
    assert list(rd.text_file(path)()) == list(jrd.text_file(path)())
    from paddle_tpu_torch import recordio_writer

    rio = str(tmp_path / "s.rio")
    recordio_writer.convert_reader_to_recordio_file(rio, _samples(9))
    _same(list(rd.recordio(rio, buf_size=4)()),
          list(jrd.recordio(rio, buf_size=4)()))
    _same(list(rd.recordio([rio, rio])()), list(jrd.recordio([rio, rio])()))
    got = list(rd.PipeReader("cat %s" % path).get_line())
    assert got == list(jrd.PipeReader("cat %s" % path).get_line())


@pytest.mark.parametrize("use_pipe", [True, False])
def test_multiprocess_reader_matches_reference(use_pipe):
    def r0():
        return iter([[1, 2], [3]])

    def r1():
        return iter([[4], [5, 6]])

    got = list(rd.multiprocess_reader([r0, r1], use_pipe=use_pipe)())
    ref = list(jrd.multiprocess_reader([r0, r1], use_pipe=use_pipe)())
    assert sorted(map(tuple, got)) == sorted(map(tuple, ref)) == [
        (1, 2), (3,), (4,), (5, 6)]


def test_device_buffered_stages_on_the_place():
    got = list(rd.device_buffered(_samples(5), place=fluid.CPUPlace())())
    assert len(got) == 5
    for (x, i), (rx, ri) in zip(got, _samples(5)()):
        assert hasattr(x, "device") and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), rx)
        assert i == ri


def _mlp_program(pkg, model):
    pkg.unique_name.switch()
    return model.build(use_conv=False, lr=1e-3)


def _mnist_reader(pkg_datasets, n):
    return lambda: (s for _, s in zip(range(n), pkg_datasets.mnist.train()()))


@pytest.mark.parametrize("double_buffer", [True, False])
def test_pyreader_batches_match_reference(double_buffer):
    def make(pkg, dsets, model, **kw):
        main, startup, feeds, loss, acc = _mlp_program(pkg, model)
        loader = pkg.DataLoader.from_generator(
            feed_list=feeds, capacity=4, use_double_buffer=double_buffer)
        loader.decorate_sample_list_generator(
            pkg.batch(_mnist_reader(dsets, 70), 16), **kw)
        return [{k: np.asarray(v) if not hasattr(v, "numpy")
                 else v.numpy() for k, v in b.items()} for b in loader]

    got = make(fluid, datasets, mnist, places=fluid.CPUPlace())
    ref = make(jfluid, jdatasets, jmnist)
    assert len(got) == len(ref) == 5  # 70 samples, batches of 16
    for g, r in zip(got, ref):
        _same(g, r)
        assert g["img"].dtype == np.float32 and g["label"].shape[1] == 1


def test_pyreader_batch_generator_and_sample_generator():
    main, startup, feeds, loss, acc = _mlp_program(fluid, mnist)

    def batches():
        for b in fluid.batch(_mnist_reader(datasets, 20), 10)():
            yield (np.stack([s[0] for s in b]),
                   np.array([[s[1]] for s in b], "int64"))

    r = fluid.PyReader(feed_list=feeds, use_double_buffer=False)
    r.decorate_batch_generator(batches)
    got = list(r)
    assert [g["img"].shape for g in got] == [(10, 784)] * 2
    s = fluid.PyReader(feed_list=feeds, use_double_buffer=False)
    s.decorate_sample_generator(_mnist_reader(datasets, 25), 10)
    assert [g["label"].shape for g in s] == [(10, 1)] * 2  # drop_last
    # the layers' reader names
    fluid.unique_name.switch()
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        pr = fluid.layers.py_reader(capacity=4, shapes=[[-1, 3], [-1, 1]],
                                    dtypes=["float32", "int64"])
        x, y = fluid.layers.read_file(pr)
        assert x.shape == (-1, 3) and y.dtype == "int64"
        cr = fluid.layers.create_py_reader_by_data(feed_list=[x])
        assert fluid.layers.read_file(cr) is x
    with pytest.raises(NotImplementedError, match="host pipeline"):
        fluid.layers.open_files(["a"], [[1]], [0], ["float32"])
    gen = fluid.layers.random_data_generator(-1.0, 1.0, [(2, 3), (1,)])
    ref = jfluid.layers.random_data_generator(-1.0, 1.0, [(2, 3), (1,)])
    _same(next(gen()), next(ref()))
    db = fluid.layers.double_buffer(
        fluid.layers.batch(_nums(5), 2), place=fluid.CPUPlace())
    assert list(db()) == [[0, 1], [2, 3], [4]]
    random.seed(3)
    a = list(fluid.layers.shuffle(_nums(9), 4)())
    random.seed(3)
    assert a == list(jfluid.layers.shuffle(_nums(9), 4)())


def test_data_feeder_matches_reference():
    rows = [(np.arange(784, dtype="float32") * i, i % 10) for i in range(6)]
    out = []
    for pkg, model in ((fluid, mnist), (jfluid, jmnist)):
        main, startup, feeds, loss, acc = _mlp_program(pkg, model)
        feeder = pkg.DataFeeder(feed_list=feeds, place=pkg.CPUPlace(),
                                program=main)
        by_name = pkg.DataFeeder(feed_list=["img", "label"], program=main)
        par = list(feeder.feed_parallel([rows], num_places=2))
        dec = list(feeder.decorate_reader(lambda: iter([rows, rows[:5]]),
                                          multi_devices=True,
                                          num_places=2)())
        out.append((feeder.feed(rows), by_name.feed(rows), par, dec))
    _same(out[0], out[1])
    feed = out[0][0]
    assert feed["label"].shape == (6, 1) and feed["label"].dtype == np.int64
    assert len(out[0][3]) == 1  # the odd batch is dropped


def test_lod_tensor_matches_reference():
    seqs = [[1, 2, 3], [4], [5, 6]]
    got = fluid.create_lod_tensor(
        [np.asarray(s).reshape(-1, 1) for s in seqs], [[3, 1, 2]],
        fluid.CPUPlace())
    ref = jfluid.create_lod_tensor(
        [np.asarray(s).reshape(-1, 1) for s in seqs], [[3, 1, 2]],
        jfluid.CPUPlace())
    assert got.lod() == ref.lod() == [[0, 3, 4, 6]]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    for a, b in zip(got.to_padded(), ref.to_padded()):
        np.testing.assert_array_equal(a, b)
    t = fluid.LoDTensor()
    t.set(np.zeros((6, 2), "float32"))
    t.set_lod([[0, 2, 6]])
    assert t.recursive_sequence_lengths() == [[2, 4]] and t.shape() == [6, 2]
    with pytest.raises(ValueError, match="do not sum"):
        fluid.create_lod_tensor(np.zeros((5, 1)), [[3, 1]])
    arr = fluid.LoDTensorArray()
    arr.append(np.ones(3))
    assert isinstance(arr[0], fluid.LoDTensor)
    np.random.seed(2)
    a = fluid.create_random_int_lodtensor([[2, 3]], [4], None, 0, 9)
    np.random.seed(2)
    b = jfluid.create_random_int_lodtensor([[2, 3]], [4], None, 0, 9)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("split", ["train", "test"])
def test_mnist_synthetic_samples_are_the_reference_bytes(split):
    got = getattr(datasets.mnist, split)()()
    ref = getattr(jdatasets.mnist, split)()()
    for _ in range(300):
        (x, y), (rx, ry) = next(got), next(ref)
        assert x.dtype == rx.dtype == np.float32 and x.shape == (784,)
        assert x.tobytes() == rx.tobytes() and y == ry
    with pytest.raises(IOError, match="no download"):
        datasets.common.download("http://x/none.gz", "mnist", None)


def _mnist_losses(pkg, dsets, model, steps, params=None, **kw):
    main, startup, feeds, loss, acc = _mlp_program(pkg, model)
    exe = pkg.Executor(pkg.CPUPlace())
    scope = JScope() if pkg is jfluid else Scope()
    exe.run(startup, scope=scope)
    if params is not None:
        load_params_into_scope(params, scope, program=main)
    start = scope_persistables(main, scope)
    loader = pkg.DataLoader.from_generator(feed_list=feeds, capacity=8)
    loader.decorate_sample_list_generator(
        pkg.batch(_mnist_reader(dsets, 64 * steps), 64), **kw)
    losses = []
    for feed in loader:
        lv, av = exe.run(main, feed=feed, fetch_list=[loss, acc],
                         scope=scope)
        losses.append(float(np.asarray(lv).reshape(())))
    return losses, start


def test_mnist_mlp_through_the_reader_path_matches_reference():
    ref, start = _mnist_losses(jfluid, jdatasets, jmnist, 5)
    got, _ = _mnist_losses(fluid, datasets, mnist, 5, params=start,
                           places=fluid.CPUPlace())
    assert len(got) == 5
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    assert got[-1] < got[0]


def test_mnist_conv_net_builds_and_steps():
    fluid.unique_name.switch()
    main, startup, feeds, loss, acc = mnist.build(use_conv=True)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"img": rng.randn(4, 1, 28, 28).astype("float32"),
            "label": rng.randint(0, 10, (4, 1)).astype("int64")}
    lv, av = exe.run(main, feed=feed, fetch_list=[loss, acc], scope=scope)
    assert np.isfinite(lv).all() and av.shape == (1,)
