"""Core runtime types: places, dtypes, VarType, and the runtime flags.

Mirrors ``paddle_tpu/core.py`` (places at :98-140, flags at :149-197).  A Place resolves to
an explicit ``torch.device``: ``CUDAPlace(i)`` is ``cuda:i`` and
``CPUPlace()`` is ``cpu``.  ``TPUPlace`` is accepted as an alias of
``CUDAPlace`` so user scripts written for the reference package still
run.  Asking for CUDA where it is unavailable raises; nothing silently
continues on the CPU.
"""

import enum

import numpy as np
import torch


class VarDesc:
    """Namespace mirroring the reference's VarDesc proto enums."""

    class VarType(enum.IntEnum):
        BOOL = 0
        INT16 = 1
        INT32 = 2
        INT64 = 3
        FP16 = 4
        FP32 = 5
        FP64 = 6
        SIZE_T = 19
        UINT8 = 20
        INT8 = 21
        BF16 = 22
        LOD_TENSOR = 7
        SELECTED_ROWS = 8
        FEED_MINIBATCH = 9
        FETCH_LIST = 10
        STEP_SCOPES = 11
        LOD_RANK_TABLE = 12
        LOD_TENSOR_ARRAY = 13
        PLACE_LIST = 14
        READER = 15
        RAW = 17
        TUPLE = 18


_DTYPE_TO_VARTYPE = {
    np.dtype("bool"): VarDesc.VarType.BOOL,
    np.dtype("int16"): VarDesc.VarType.INT16,
    np.dtype("int32"): VarDesc.VarType.INT32,
    np.dtype("int64"): VarDesc.VarType.INT64,
    np.dtype("float16"): VarDesc.VarType.FP16,
    np.dtype("float32"): VarDesc.VarType.FP32,
    np.dtype("float64"): VarDesc.VarType.FP64,
    np.dtype("uint8"): VarDesc.VarType.UINT8,
    np.dtype("int8"): VarDesc.VarType.INT8,
}

_VARTYPE_TO_DTYPE = {v: k for k, v in _DTYPE_TO_VARTYPE.items()}

_NAME_TO_TORCH = {
    "bool": torch.bool,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
}
_TORCH_TO_NAME = {v: k for k, v in _NAME_TO_TORCH.items()}


def convert_np_dtype_to_dtype_(dtype):
    """Normalize a user dtype spec (str / np.dtype / VarType /
    torch.dtype) to a canonical string; 'bfloat16' stays a string."""
    if isinstance(dtype, torch.dtype):
        return _TORCH_TO_NAME[dtype]
    if isinstance(dtype, VarDesc.VarType):
        if dtype == VarDesc.VarType.BF16:
            return "bfloat16"
        return _VARTYPE_TO_DTYPE[dtype].name
    if isinstance(dtype, str):
        if dtype in ("bfloat16", "bf16"):
            return "bfloat16"
        return np.dtype(dtype).name
    if getattr(dtype, "__name__", None) == "bfloat16" or str(dtype) == "bfloat16":
        return "bfloat16"
    return np.dtype(dtype).name


def torch_dtype(dtype):
    """Any dtype spec → ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, (int, VarDesc.VarType)) and not isinstance(dtype, bool):
        dtype = VarDesc.VarType(int(dtype))
    return _NAME_TO_TORCH[convert_np_dtype_to_dtype_(dtype)]


class Place:
    """Base device selector."""

    _kind = "base"

    def __init__(self, device_id=0):
        self._device_id = int(device_id)

    def __eq__(self, other):
        return type(self) is type(other) and self._device_id == other._device_id

    def __hash__(self):
        return hash((type(self).__name__, self._device_id))

    def __repr__(self):
        return "%s(%d)" % (type(self).__name__, self._device_id)

    def torch_device(self):
        raise NotImplementedError


class CPUPlace(Place):
    _kind = "cpu"

    def torch_device(self):
        return torch.device("cpu")


class CUDAPlace(Place):
    """The accelerator place of this package: one NVIDIA GPU."""

    _kind = "cuda"

    def torch_device(self):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "%r was asked for but torch.cuda.is_available() is False; "
                "pass CPUPlace() (or AnalysisConfig.disable_gpu()) to run "
                "on the CPU" % (self,))
        n = torch.cuda.device_count()
        if self._device_id >= n:
            raise RuntimeError("%r was asked for but only %d CUDA device(s) "
                               "are visible" % (self, n))
        return torch.device("cuda", self._device_id)


# reference user scripts name the accelerator TPUPlace; here it is the GPU
TPUPlace = CUDAPlace


def as_torch_device(place):
    """Place / torch.device / device string → ``torch.device``.  None
    means the default accelerator, ``CUDAPlace(0)``."""
    if place is None:
        place = CUDAPlace(0)
    if isinstance(place, Place):
        return place.torch_device()
    dev = torch.device(place)
    if dev.type == "cuda":
        return CUDAPlace(dev.index or 0).torch_device()
    return dev


def full_float32_products():
    """Run float32 products in full float32 on CUDA, as on the CPU (TF32
    off for cuBLAS and cuDNN), and accumulate a bf16 product's split-K
    partials in float32 (the reduced-precision reduction, on by default,
    off), as the reference's ``preferred_element_type=float32``: what a
    CUDA place's executor and dygraph guard set."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False


# ---------------------------------------------------------------------------
# Flags (``paddle_tpu/core.py:149-197``): the same three flags with the same
# defaults, ``FLAGS_*`` environment variables read at import, ``KeyError``
# on an unknown name.  What each does on this package's devices:
#
# - ``FLAGS_check_nan_inf``: the executor runs every block eagerly, op by
#   op, and raises ``FloatingPointError`` naming the first op (its type and
#   the output var) whose floating output holds a NaN or an Inf; the
#   reference's ``jax_debug_nans``.  A captured CUDA graph cannot stop at an
#   op, so none is captured or replayed while the flag is set.
# - ``FLAGS_cpu_deterministic``: cuDNN picks deterministic algorithms only
#   (``torch.backends.cudnn.deterministic = True``, ``benchmark = False``);
#   setting it back to False restores the two switches as they were.  The
#   package's own kernels are deterministic without it (the embedding
#   gradient is a sorted segment-sum, the dropout masks come from a
#   counter-based generator), so it does nothing else; the reference's
#   switch of its rng implementation has no counterpart here.
# - ``FLAGS_benchmark``: stored, and does nothing, as in the reference.
#
# ``flags_key()`` is the part of the executor's cache key that the flags
# decide, so a graph captured under one setting is never replayed under
# another.
# ---------------------------------------------------------------------------

_flags = {
    "FLAGS_check_nan_inf": False,
    "FLAGS_cpu_deterministic": False,
    "FLAGS_benchmark": False,
}
_cudnn_before = None


def _set_cudnn_deterministic(on):
    global _cudnn_before
    cudnn = torch.backends.cudnn
    if on:
        if _cudnn_before is None:
            _cudnn_before = (cudnn.deterministic, cudnn.benchmark)
        cudnn.deterministic, cudnn.benchmark = True, False
    elif _cudnn_before is not None:
        cudnn.deterministic, cudnn.benchmark = _cudnn_before
        _cudnn_before = None


def set_flags(flags):
    """Set runtime flags (the reference's ``fluid.set_flags``)."""
    flags = dict(flags)
    unknown = [n for n in flags if n not in _flags]
    if unknown:
        raise KeyError("unknown flag(s) %r (known: %s)"
                       % (unknown, sorted(_flags)))
    for name, value in flags.items():
        _flags[name] = value
        if name == "FLAGS_cpu_deterministic":
            _set_cudnn_deterministic(bool(value))


def get_flags(names):
    if isinstance(names, str):
        return {names: _flags[names]}
    return {n: _flags[n] for n in names}


def flags_key():
    """The flags that change what a step runs, as a hashable tuple."""
    return (bool(_flags["FLAGS_check_nan_inf"]),
            bool(_flags["FLAGS_cpu_deterministic"]))


def _bootstrap_flags():
    """Forward ``FLAGS_*`` environment variables into the flags at import
    (the reference's ``__bootstrap__`` pattern)."""
    import os

    for name in list(_flags):
        raw = os.environ.get(name)
        if raw is None:
            continue
        set_flags({name: raw.lower() in ("1", "true", "yes", "on")})


_bootstrap_flags()
