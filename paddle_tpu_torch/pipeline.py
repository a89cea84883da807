"""Lazy fetch handles and the one batched device→host sync (the subset of
``paddle_tpu/pipeline.py`` the serving path needs: ``FetchHandle``,
``host_values``, ``materialize``).

PyTorch launches CUDA work asynchronously on the current stream, so a
step returns as soon as its kernels are enqueued.  A :class:`FetchHandle`
keeps the step's output tensor and a CUDA event recorded right after the
step; nothing waits until the value is read.  :func:`materialize` reads
many handles with ONE wait: it starts every device→host copy into pinned
memory without blocking, records one event after the copies and waits on
it once.  The device-feed prefetch pipeline (``DeviceFeedPipeline``,
``FeedCache``) comes with a later slice (ROADMAP.md).
"""

import numpy as np
import torch

__all__ = ["FetchHandle", "host_values", "materialize"]


def _is_cuda(v):
    return isinstance(v, torch.Tensor) and v.device.type == "cuda"


def _to_numpy(t):
    """A host tensor as numpy.  bfloat16 becomes ``ml_dtypes.bfloat16``,
    numpy's bf16 and the reference's fetch dtype, where ``ml_dtypes`` is
    installed, else float32 (exact): PyTorch does not depend on it."""
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError:
            return t.float().numpy()
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def host_values(values):
    """Tensors, handles or host values → numpy arrays, in order, with one
    synchronisation for all the CUDA tensors among them."""
    vals = [v.device_value if isinstance(v, FetchHandle) else v
            for v in values]
    out = [None] * len(vals)
    copies = []
    for i, v in enumerate(vals):
        if _is_cuda(v):
            host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host.copy_(v, non_blocking=True)
            copies.append((i, host))
        elif isinstance(v, torch.Tensor):
            out[i] = _to_numpy(v.detach())
        else:
            out[i] = np.asarray(v)
    if copies:
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        for i, host in copies:
            out[i] = _to_numpy(host)
    return out


class FetchHandle:
    """Lazy fetch: a step's output tensor plus the CUDA event recorded
    after the step.  Creating or passing a handle costs no sync; the
    first read (``np.asarray(h)``, ``h.numpy()``) waits and copies once,
    caches the host array and releases the device tensor."""

    __slots__ = ("_dev", "_host", "_event")

    def __init__(self, device_value):
        self._dev = device_value
        self._host = None
        self._event = None
        if _is_cuda(device_value):
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device_value.device))

    @property
    def device_value(self):
        """The device tensor while in flight; the host copy after."""
        return self._host if self._dev is None else self._dev

    @property
    def synced(self):
        return self._host is not None

    def numpy(self):
        if self._host is None:
            self._host = host_values([self._dev])[0]
            self._dev = None
        return self._host

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def is_ready(self):
        return self._host is not None or self._event is None \
            or self._event.query()

    def block_until_ready(self):
        if self._host is None and self._event is not None:
            self._event.synchronize()
        return self

    @property
    def shape(self):
        return tuple(self.device_value.shape)

    @property
    def dtype(self):
        return self.device_value.dtype

    def __repr__(self):
        return "<FetchHandle shape=%s dtype=%s %s>" % (
            self.shape, self.dtype, "synced" if self.synced else "in-flight")


def materialize(fetches):
    """One handle, or a (nested) list/tuple of handles → numpy values in
    the same structure, with ONE batched sync."""
    if isinstance(fetches, FetchHandle):
        return fetches.numpy()
    flat = []

    def collect(x):
        if isinstance(x, (list, tuple)):
            for e in x:
                collect(e)
        else:
            flat.append(x)

    collect(fetches)
    need = [h for h in flat if isinstance(h, FetchHandle) and not h.synced]
    if need:
        for h, a in zip(need, host_values([h.device_value for h in need])):
            h._host = a
            h._dev = None

    def rebuild(x):
        if isinstance(x, (list, tuple)):
            return type(x)(rebuild(e) for e in x)
        return x.numpy() if isinstance(x, FetchHandle) else np.asarray(x)

    return rebuild(fetches)
