"""float32/bfloat16 → int8 block quantization with per-block scales.

Mirrors ``paddle_tpu/quant/blockwise.py``.  The wire format is the
reference's: a tensor is flattened, zero-padded to a multiple of the
block size B (``PADDLE_TPU_QUANT_BLOCK``, default 256), and each block
carries ``q = clip(round(x / s), -127, 127)`` as int8 plus one float32
scale ``s = absmax / 127`` (1 for a block whose absmax is not > 0).
Dequantize is exactly ``q * s``, so the round trip is a pure function of
the input bits.

Error model (the reference's): within a block of absmax ``m`` the step
is ``Δ = m / 127``; rounding gives per-element error ≤ ``Δ / 2`` and, for
values spread across the step, RMS ≈ ``Δ / √12``
(:func:`predicted_rms_error`).

Kernels: the ``[nblocks, B]`` quantize and dequantize are K7
(:mod:`paddle_tpu_torch.ops.cuda.quant`, ``csrc/quant.cu``), launched for
CUDA tensors at any B and block count (the reference's ``block % 128``,
``nblocks % 8`` gate is TPU tiling); CPU tensors take their plain
versions.  ``kernel=False`` pins the plain version on any device, as the
reference's ``kernel=False`` pins its XLA composite: the same bits.
"""

import os

import torch

from ..ops.cuda import quant as _k7

__all__ = ["quant_enabled", "quant_block", "block_quantize",
           "block_dequantize", "predicted_rms_error", "quantization_error"]

_DEFAULT_BLOCK = 256


def quant_enabled():
    """Global kill switch: ``PADDLE_TPU_QUANT=0`` disables quantized
    collectives everywhere (fusion rewrite, runtime)."""
    return os.environ.get("PADDLE_TPU_QUANT", "").strip() != "0"


def quant_block(default=_DEFAULT_BLOCK):
    """Quantization block size: ``PADDLE_TPU_QUANT_BLOCK`` → default."""
    env = os.environ.get("PADDLE_TPU_QUANT_BLOCK", "").strip()
    if env:
        try:
            v = int(env)
            if v > 0:
                return v
        except ValueError:
            pass
    return default


def padded_size(numel, block):
    """numel rounded up to a whole number of blocks."""
    return -(-int(numel) // int(block)) * int(block)


def _pad_flat(x, npad):
    flat = x.reshape(-1).to(torch.float32)
    if npad != flat.numel():
        flat = torch.cat([flat, flat.new_zeros(npad - flat.numel())])
    return flat


def block_quantize(x, block=None, kernel=True):
    """Quantize ``x`` (any shape, float dtype) to int8 blocks.

    Returns ``(q, scales)``: q int8 ``[npad]`` (flat, zero-padded to a
    block multiple), scales float32 ``[npad // block]``.  The pad
    elements quantize to 0 under the tail block's real absmax."""
    b = int(block) if block else quant_block()
    flat = _pad_flat(x, padded_size(x.numel(), b))
    blocks = flat.view(-1, b)
    if kernel:
        q, scales = _k7.block_quantize_blocks(blocks)
    else:
        q, scales = _k7.block_quantize_blocks_plain(blocks)
    return q.reshape(-1), scales


def block_dequantize(q, scales, size=None, shape=None, dtype=torch.float32,
                     kernel=True):
    """Exact dequantize ``q * scale``; trims the pad back to ``size`` (or
    ``shape``'s numel) and reshapes when asked."""
    nblocks = scales.shape[0]
    blocks = q.reshape(nblocks, q.numel() // nblocks)
    if kernel:
        out = _k7.block_dequantize_blocks(blocks, scales, dtype)
    else:
        out = _k7.block_dequantize_blocks_plain(blocks, scales, dtype)
    out = out.reshape(-1)
    if shape is not None:
        size = 1
        for d in shape:
            size *= int(d)
    if size is not None and size != out.numel():
        out = out[:size]
    if shape is not None:
        out = out.reshape(tuple(int(d) for d in shape))
    return out


def predicted_rms_error(scales):
    """The error model's RMS quantization error for a tensor with these
    per-block scales: ``sqrt(mean(s²) / 12)``."""
    s = torch.as_tensor(scales, dtype=torch.float32)
    return torch.sqrt(torch.mean(torch.square(s)) / 12.0)


def quantization_error(x, block=None):
    """Measured against predicted round-trip error: ``{"measured_rms",
    "predicted_rms", "rel_error"}`` (0-d float32 tensors; ``rel_error``
    is the measured RMS over ``x``'s own, 0 for an all-zero input)."""
    xf = torch.as_tensor(x).reshape(-1).to(torch.float32)
    q, scales = block_quantize(xf, block=block)
    back = block_dequantize(q, scales, size=xf.numel())
    measured = torch.sqrt(torch.mean(torch.square(back - xf)))
    x_rms = torch.sqrt(torch.mean(torch.square(xf)))
    rel = torch.where(x_rms > 0.0, measured / x_rms,
                      torch.zeros_like(measured))
    return {"measured_rms": measured,
            "predicted_rms": predicted_rms_error(scales),
            "rel_error": rel}
