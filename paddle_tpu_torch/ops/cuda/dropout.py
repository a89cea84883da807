"""Dropout keep masks of the hand-written kernels, and their plain
PyTorch twins (``csrc/dropout.cuh``).

The reference draws its in-kernel masks from the TPU's hardware PRNG
(``paddle_tpu/ops/pallas/flash_attention.py`` ``_keep_mask`` :114,
``fused_ln.py`` ``_row_keep_mask`` :72), whose bits nothing else can
reproduce.  The port uses two generators instead, each a pure function of
(seed, b, row, col) so that a backward kernel redraws its forward's mask
and the plain versions below reproduce the kernels bit for bit, in int64
arithmetic masked to 32 bits:

* the **card generator** (:func:`card_bits`): murmur3's ``fmix32``
  chained over the coordinates;
* the **debug hash** (:func:`debug_bits`): the reference's
  ``_hash_bits``/``debug_keep_mask`` (:100-145), selected by the
  reference's own ``PADDLE_TPU_FLASH_DROPOUT_DEBUG=iota``, so CPU tests
  hold the port's dropout arithmetic against the reference package.

``b`` is the batch·head index for attention and 0 for layer norm.  A cell
is kept iff its bits >= :func:`rate_threshold` and a kept value is
scaled by ``1 / (1 - rate)``, as in the reference.

A kernel takes its seed as a :class:`StepSeed`: the executor's step, a
1-element int64 tensor on the kernel's device, and a per-op ``salt``
(:func:`op_salt`).  It reads the step through a device pointer and
derives the seed in its prologue (:func:`step_seed`, the same 32 bits on
the host, on a tensor and in ``dropout.cuh``), so a step replayed from a
captured CUDA graph draws new masks each time its step tensor is filled
with a new value.  The plain twins also take a host ``int`` seed, used
as it is.
"""

import collections
import os

import torch

DEBUG_ENV = "PADDLE_TPU_FLASH_DROPOUT_DEBUG"
MASK32 = 0xFFFFFFFF

# kernel modes (csrc/dropout.cuh)
MODE_OFF, MODE_CARD, MODE_DEBUG = 0, 1, 2


def debug_hash_enabled():
    return os.environ.get(DEBUG_ENV) == "iota"


def mode(rate):
    """The kernels' generator mode for a dropout rate."""
    if not rate:
        return MODE_OFF
    return MODE_DEBUG if debug_hash_enabled() else MODE_CARD


def rate_threshold(rate):
    """uint32 threshold: keep a cell iff its bits >= it (the reference's
    ``_rate_threshold``)."""
    return min(int(rate * 4294967296.0), 4294967295)


def keep_scale(rate):
    return 1.0 / (1.0 - rate)


def check_rate(rate, seed):
    """The reference's argument checks (``flash_attention`` :720-726)."""
    rate = float(rate or 0.0)
    if not 0.0 <= rate < 1.0:
        raise ValueError("dropout_rate must be in [0, 1), got %r (rate 1 "
                         "would upscale by 1/0)" % rate)
    if rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    return rate


class StepSeed(collections.namedtuple("StepSeed", ["step", "salt"])):
    """A dropout seed drawn on the device: ``step`` is a 1-element int64
    tensor (the executor's step), ``salt`` a host int naming the draw
    (:func:`op_salt`).  The seed is :func:`step_seed` of the two."""

    __slots__ = ()


def step_seed(step, salt):
    """The 32-bit seed of (step, salt): ``fmix32`` of the step's two
    halves, then of that plus ``salt`` times an odd constant.  ``step``
    is an int or an int64 tensor (then so is the result); the kernels'
    ``pt::step_seed`` computes the same bits."""
    lo = step & MASK32
    hi = (step >> 32) & MASK32
    h = _fmix32(lo ^ _mul32(hi, 0x9E3779B9))
    return _fmix32((h + _mul32(int(salt) & MASK32, 0x85EBCA77)) & MASK32)


def op_salt(program_seed, op_id, draw):
    """The 32-bit salt of draw ``draw`` of op ``op_id`` in a program of
    seed ``program_seed``: ``fmix32`` chained over the three, so it does
    not depend on op order or on the step."""
    h = _fmix32((int(program_seed) & MASK32)
                ^ _mul32((int(program_seed) >> 32) & MASK32, 0x9E3779B9))
    h = _fmix32((h + _mul32(int(op_id) & MASK32, 0x7FEB352D)) & MASK32)
    return _fmix32((h + _mul32(int(draw) & MASK32, 0x846CA68B)) & MASK32)


def seed_u32(seed):
    """The seed's 32 bits: an int, or for a :class:`StepSeed` a 0-d int64
    tensor on the step's device."""
    if seed is None:
        return 0
    if isinstance(seed, StepSeed):
        return step_seed(seed.step.reshape(()).to(torch.int64), seed.salt)
    return int(seed) & MASK32


def kernel_args(rate, seed):
    """The dropout arguments every dropping kernel takes: mode, the step's
    device pointer, salt, threshold, keep scale.  A kernel that drops
    takes a :class:`StepSeed` whose step lies on the card."""
    if not rate:
        return (MODE_OFF, None, 0, 0, 1.0)
    if not isinstance(seed, StepSeed):
        raise TypeError("a kernel that drops takes a StepSeed (the step on "
                        "the card and a salt), got %r; an int seed is for "
                        "the plain versions on the CPU" % (seed,))
    step = seed.step
    if step.dtype != torch.int64 or step.numel() != 1 \
            or step.device.type != "cuda":
        raise ValueError("a dropout step must be a 1-element int64 CUDA "
                         "tensor, got %s %s on %s"
                         % (tuple(step.shape), step.dtype, step.device))
    return (mode(rate), step.data_ptr(), int(seed.salt) & MASK32,
            rate_threshold(rate), keep_scale(rate))


def _mul32(a, c):
    """(a * c) mod 2**32 for an int64 tensor ``a`` of uint32 values and a
    uint32 constant, without leaving int64: the high half of ``c`` only
    reaches the low 32 bits through its product's low 16 bits."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _as_u32(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64) & MASK32
    # a fill, not a host-to-device copy: capturable in a CUDA graph
    return torch.full((), int(x) & MASK32, dtype=torch.int64, device=device)


def card_bits(seed, b, rows, cols):
    """The card generator's bits at broadcastable int coordinates."""
    dev = rows.device
    s = _as_u32(seed, dev)
    key = _fmix32(s ^ _mul32(_as_u32(b, dev), 0x9E3779B9))
    key = _fmix32((key + _mul32(_as_u32(rows, dev), 0x7FEB352D)) & MASK32)
    return _fmix32(key ^ _mul32(_as_u32(cols, dev), 0x846CA68B))


def debug_bits(seed, b, rows, cols):
    """The reference's ``_hash_bits(b, r, c, seed)``."""
    dev = rows.device
    h = _mul32(_as_u32(rows, dev), 2654435761) ^ (
        (_mul32(_as_u32(cols, dev), 97559)
         + _mul32(_as_u32(b, dev), 31)) & MASK32)
    h = h ^ _as_u32(seed, dev)
    return _mul32(h, 2246822519)


def keep_mask(seed, rate, b, rows, cols, debug=None):
    """Bool keep mask at broadcastable int64 coordinates."""
    if debug is None:
        debug = debug_hash_enabled()
    bits = (debug_bits if debug else card_bits)(seed_u32(seed), b, rows, cols)
    return bits >= rate_threshold(rate)


def attention_keep_mask(seed, rate, bh, tq, tk, device):
    """[BH, Tq, Tk] keep mask of the flash-attention kernels."""
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    return keep_mask(seed, rate, ar(bh)[:, None, None], ar(tq)[None, :, None],
                     ar(tk)[None, None, :])


def row_keep_mask(seed, rate, shape, device, debug=None):
    """Keep mask over the rows of the last axis (b = 0, the fused LN
    kernel's form, also used by the ``dropout`` op)."""
    d = int(shape[-1]) if len(shape) else 1
    n = 1
    for s in shape[:-1]:
        n *= int(s)
    ar = lambda k: torch.arange(k, dtype=torch.int64, device=device)  # noqa: E731
    return keep_mask(seed, rate, 0, ar(n)[:, None], ar(d)[None, :],
                     debug=debug).reshape(shape)
