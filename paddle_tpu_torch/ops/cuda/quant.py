"""K7, int8 block quantize and dequantize: hand-written CUDA kernels for
Hopper (``csrc/quant.cu``) and their plain PyTorch versions.

Replaces the Pallas TPU kernels of ``paddle_tpu/quant/blockwise.py``:
``_quantize_call`` (:137, ``pallas_call`` at :142, body
``_quant_kernel`` at :115) and ``_dequantize_call`` (:159,
``pallas_call`` at :164, body ``_dequant_kernel`` at :124), whose
composite twin ``_quantize_xla`` (:131) is the plain version here.  Per
row of a ``[nblocks, B]`` view: ``s = absmax / 127`` (1 where ``absmax >
0`` is false: a zero block, or a block holding a NaN, since ``jnp.max``
propagates it), ``q = clip(round_half_even(x / s), -127, 127)`` as int8
with NaN mapped to 0; the dequantize is ``q * s`` in float32, then cast.

:func:`block_quantize_blocks` and :func:`block_dequantize_blocks` launch
the kernels for CUDA tensors (or raise) and run the plain versions for
CPU and meta tensors.  The kernels read and write every bit as the plain
versions do (IEEE division and rounding, no flush-to-zero).
"""

import torch

from . import _lib

QUANTIZE = "block_quantize"
DEQUANTIZE = "block_dequantize"
QMAX = 127.0


def block_quantize_blocks_plain(blocks):
    """blocks [nblocks, B] float32 → (q int8 [nblocks, B], scales float32
    [nblocks]); the reference's ``_quantize_xla``."""
    absmax = blocks.abs().amax(dim=1)
    # amax propagates NaN as jnp.max does, and NaN > 0 is false; the
    # divisor is a tensor because CUDA PyTorch turns a division by a
    # Python scalar into a multiplication by its reciprocal
    scales = torch.where(absmax > 0.0,
                         absmax / torch.full_like(absmax, QMAX),
                         torch.ones_like(absmax))
    v = torch.clamp(torch.round(blocks / scales[:, None]), -QMAX, QMAX)
    # float -> int8 of NaN is not defined in torch; XLA gives 0
    q = torch.where(torch.isnan(v), torch.zeros_like(v), v).to(torch.int8)
    return q, scales


def block_dequantize_blocks_plain(q, scales, dtype=torch.float32):
    """q [nblocks, B] int8, scales [nblocks] → ``q * s`` in float32, cast
    to ``dtype``."""
    return (q.to(torch.float32) * scales[:, None]).to(dtype)


def _check_blocks(t, dtype, what):
    if t.dim() != 2:
        raise ValueError("%s must be [nblocks, B], got %s"
                         % (what, tuple(t.shape)))
    if t.dtype != dtype:
        raise TypeError("%s must be %s, got %s" % (what, dtype, t.dtype))


def block_quantize_blocks(blocks):
    """blocks [nblocks, B] float32 → (q [nblocks, B] int8, scales
    [nblocks] float32).  CUDA tensors launch K7's quantize kernel; CPU
    and meta tensors run the plain version."""
    _check_blocks(blocks, torch.float32, "blocks")
    if blocks.device.type != "cuda":
        return block_quantize_blocks_plain(blocks)
    nblocks, block = blocks.shape
    if nblocks == 0 or block == 0:
        raise ValueError("block quantize kernel takes a non-empty "
                         "[nblocks, B], got %s" % (tuple(blocks.shape),))
    if not blocks.is_contiguous():
        raise ValueError("block quantize kernel needs contiguous blocks")
    q = torch.empty(blocks.shape, dtype=torch.int8, device=blocks.device)
    scales = torch.empty((nblocks,), dtype=torch.float32,
                         device=blocks.device)
    err = _lib.lib().pt_block_quantize(
        blocks.data_ptr(), q.data_ptr(), scales.data_ptr(), nblocks, block,
        _lib.stream_handle(blocks.device))
    _lib.check(err, QUANTIZE)
    _lib.count_launch(QUANTIZE)
    return q, scales


def block_dequantize_blocks(q, scales, dtype=torch.float32):
    """q [nblocks, B] int8, scales [nblocks] float32 → [nblocks, B] of
    ``dtype`` (float32 or bfloat16).  CUDA tensors launch K7's
    dequantize kernel; CPU and meta tensors run the plain version."""
    _check_blocks(q, torch.int8, "q")
    if scales.dim() != 1 or scales.shape[0] != q.shape[0] \
            or scales.dtype != torch.float32:
        raise ValueError("scales must be float32 [%d], got %s %s"
                         % (q.shape[0], scales.dtype, tuple(scales.shape)))
    if q.device != scales.device:
        raise ValueError("q on %s, scales on %s" % (q.device, scales.device))
    if q.device.type != "cuda":
        return block_dequantize_blocks_plain(q, scales, dtype)
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    code = _lib.dtype_code(out, DEQUANTIZE)
    nblocks, block = q.shape
    if nblocks == 0 or block == 0:
        raise ValueError("block dequantize kernel takes a non-empty "
                         "[nblocks, B], got %s" % (tuple(q.shape),))
    if not q.is_contiguous() or not scales.is_contiguous():
        raise ValueError("block dequantize kernel needs contiguous inputs")
    err = _lib.lib().pt_block_dequantize(
        q.data_ptr(), scales.data_ptr(), out.data_ptr(), nblocks, block,
        code, _lib.stream_handle(q.device))
    _lib.check(err, DEQUANTIZE)
    _lib.count_launch(DEQUANTIZE)
    return out
