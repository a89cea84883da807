"""Data-layer front end (mirrors ``paddle_tpu/layers/io.py`` ``data``)."""

from .. import core
from ..framework import default_main_program, default_startup_program

__all__ = ["data"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         type=core.VarDesc.VarType.LOD_TENSOR, stop_gradient=True):
    """Declare an input variable fed at run time; with
    ``append_batch_size`` a leading -1 batch dim is added."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    var = default_main_program().current_block().create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        stop_gradient=stop_gradient, is_data=True, need_check_feed=True)
    # mirrored into the startup program so either program resolves it
    sb = default_startup_program().current_block()
    if not sb.has_var(name):
        sb.create_var(name=name, shape=shape, dtype=dtype,
                      lod_level=lod_level, stop_gradient=stop_gradient,
                      is_data=True)
    return var
