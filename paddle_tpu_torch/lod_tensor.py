"""LoDTensor construction helpers (mirrors ``paddle_tpu/lod_tensor.py``,
all of it; the reference's ``python/paddle/fluid/lod_tensor.py``
create_lod_tensor / create_random_int_lodtensor and the pybind
``LoDTensor`` type).

A host-side container of the flat [T, ...] data and its recursive
sequence lengths.  ``np.asarray()`` gives the flat data, so a LoDTensor
feeds ``Executor.run`` directly; models take ragged batches as padded
tensors with a mask or lengths, and ``to_padded()`` converts."""

import numpy as np

__all__ = ["LoDTensor", "LoDTensorArray", "create_lod_tensor",
           "create_random_int_lodtensor"]


class LoDTensor:
    def __init__(self, data=None, recursive_seq_lens=None):
        self._data = None if data is None else np.asarray(data)
        self._seq_lens = [list(l) for l in (recursive_seq_lens or [])]

    def set(self, data, place=None):
        self._data = np.asarray(data)

    def set_recursive_sequence_lengths(self, lens):
        self._seq_lens = [list(l) for l in lens]

    def recursive_sequence_lengths(self):
        return [list(l) for l in self._seq_lens]

    def set_lod(self, lod):
        # offsets -> lengths
        self._seq_lens = [
            [b - a for a, b in zip(level[:-1], level[1:])] for level in lod
        ]

    def lod(self):
        out = []
        for lens in self._seq_lens:
            level = [0]
            for n in lens:
                level.append(level[-1] + n)
            out.append(level)
        return out

    def shape(self):
        return list(self._data.shape) if self._data is not None else []

    def __array__(self, dtype=None):
        a = self._data
        return a.astype(dtype) if dtype is not None else a

    def has_valid_recursive_sequence_lengths(self):
        if not self._seq_lens or self._data is None:
            return True
        total = sum(self._seq_lens[-1])
        return total == self._data.shape[0]

    def to_padded(self, maxlen=None, pad_value=0):
        """[B, L, ...] padded batch + [B] lengths from the finest level."""
        lens = self._seq_lens[-1]
        L = maxlen or (max(lens) if lens else 0)
        b = len(lens)
        out = np.full((b, L) + self._data.shape[1:], pad_value,
                      self._data.dtype)
        off = 0
        for i, n in enumerate(lens):
            out[i, :min(n, L)] = self._data[off:off + min(n, L)]
            off += n
        return out, np.asarray(lens, np.int64)


class LoDTensorArray(list):
    """reference pybind LoDTensorArray: a list of LoDTensors."""

    def append(self, t):
        if not isinstance(t, LoDTensor):
            t = LoDTensor(np.asarray(t))
        super().append(t)


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """reference lod_tensor.py:create_lod_tensor — data is a numpy array
    of flat shape [sum(lens), ...], a list of sequences, or a LoDTensor."""
    if isinstance(data, LoDTensor):
        return create_lod_tensor(np.asarray(data), recursive_seq_lens,
                                 place)
    if isinstance(data, list):
        flat = np.concatenate([np.asarray(s).reshape(len(s), -1)
                               for s in data], axis=0)
        t = LoDTensor(flat, recursive_seq_lens)
    else:
        t = LoDTensor(np.asarray(data), recursive_seq_lens)
    if not t.has_valid_recursive_sequence_lengths():
        raise ValueError(
            "recursive_seq_lens %r do not sum to the data's first dim %d"
            % (recursive_seq_lens, np.asarray(t).shape[0]))
    return t


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place=None,
                                low=0, high=1):
    total = sum(recursive_seq_lens[-1])
    data = np.random.randint(low, high + 1,
                             size=[total] + list(base_shape))
    return create_lod_tensor(data.astype("int64"), recursive_seq_lens,
                             place)
