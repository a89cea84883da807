"""MNIST readers (mirrors ``paddle_tpu/datasets/mnist.py``, all of it;
the reference's ``python/paddle/dataset/mnist.py``: ``train()`` /
``test()`` yield (784-float32 image in [-1, 1], int label)).

The real IDX files are read from the data home when they are there;
otherwise a deterministic synthetic surrogate is served, byte for byte
the reference's (the same ``RandomState`` draws in the same order): 10
fixed class prototypes plus noise, linearly separable, so training
curves behave."""

import gzip
import os
import struct

import numpy as np

from . import common

__all__ = ["train", "test"]

TRAIN_SIZE = 60000
TEST_SIZE = 10000


def _load_idx(image_path, label_path):
    with gzip.open(image_path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        images = np.frombuffer(f.read(), np.uint8).reshape(n, rows * cols)
    with gzip.open(label_path, "rb") as f:
        struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(), np.uint8)
    # keep uint8 in the cache (4x smaller); normalize per sample in the
    # reader
    return images, labels.astype("int64")


def _real_files(split):
    base = "train" if split == "train" else "t10k"
    ip = common.data_path("mnist", "%s-images-idx3-ubyte.gz" % base)
    lp = common.data_path("mnist", "%s-labels-idx1-ubyte.gz" % base)
    if os.path.exists(ip) and os.path.exists(lp):
        return ip, lp
    return None


def _synthetic(split, size):
    rng = np.random.RandomState(42)
    protos = rng.rand(10, 784).astype("float32") * 2.0 - 1.0
    seed = 0 if split == "train" else 1

    def reader():
        r = np.random.RandomState(seed)
        for _ in range(size):
            y = int(r.randint(10))
            x = np.clip(
                protos[y] + 0.3 * r.randn(784).astype("float32"), -1.0, 1.0
            ).astype("float32")
            yield x, y

    return reader


_CACHE = {}


def _reader(split, size):
    files = _real_files(split)
    if files is None:
        return _synthetic(split, size)
    if split not in _CACHE:
        _CACHE[split] = _load_idx(*files)
    images, labels = _CACHE[split]

    def reader():
        for i in range(images.shape[0]):
            yield (images[i].astype("float32") / 127.5 - 1.0,
                   int(labels[i]))

    return reader


def train():
    return _reader("train", TRAIN_SIZE)


def test():
    return _reader("test", TEST_SIZE)
