"""Block-quantized collectives: int8 gradient exchange (mirrors
``paddle_tpu/quant/__init__.py``).

- :mod:`.blockwise`: the quantize/dequantize primitives and the error
  model, on the K7 kernels for CUDA tensors.
- :mod:`.collective`: the ``c_allreduce_quant`` math over a
  ``torch.distributed`` group: quantize → reduce-scatter in int8 →
  dequant-sum-requant → all-gather.

Kill switches as in the reference: ``PADDLE_TPU_QUANT=0`` disables the
subsystem (the fusion rewrite emits plain ``c_fused_allreduce_sum``);
``PADDLE_TPU_QUANT_BLOCK`` sets the block size (default 256);
``PADDLE_TPU_QUANT_MIN_BYTES`` sets the per-bucket engagement threshold
when the program carries no ``_quant_buckets`` mark.
"""

from .blockwise import (block_dequantize, block_quantize, predicted_rms_error,
                        quant_block, quant_enabled, quantization_error)
from .collective import (quant_min_bytes, quantized_allreduce,
                         quantized_wire_bytes)

__all__ = [
    "block_quantize", "block_dequantize", "quant_block", "quant_enabled",
    "predicted_rms_error", "quantization_error", "quantized_allreduce",
    "quantized_wire_bytes", "quant_min_bytes",
]
