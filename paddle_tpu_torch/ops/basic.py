"""Creation ops, ``sum``, small tensor ops and feed/fetch markers (mirrors
``paddle_tpu/ops/basic.py`` lines 17-237: ``fill_constant_batch_size_like``
:24, ``assign`` :95, ``cast`` :116, ``sum`` :130, ``increment`` :143,
``range`` :202).

Random draws come from the per-draw ``torch.Generator`` of
:meth:`LoweringContext.rng`, drawn on the CPU and moved to the run's
device, so a seeded startup program initializes identical parameters on
the CPU and on the GPU.
"""

import math

import torch

from .common import resolve_dtype
from .registry import register_op


def _shape(attrs):
    return tuple(int(s) for s in attrs.get("shape", []))


def _generator(ctx, attrs):
    seed = int(attrs.get("seed", 0))
    if seed:
        g = torch.Generator()
        g.manual_seed(seed)
        return g
    return ctx.rng()


def _place(ctx, t, dtype):
    return t.to(device=ctx.device, dtype=dtype)


@register_op("fill_constant", inputs=[], outputs=["Out"], no_grad=True)
def fill_constant(ctx, attrs):
    dtype = resolve_dtype(attrs.get("dtype", "float32"))
    return torch.full(_shape(attrs), attrs.get("value", 0.0), dtype=dtype,
                      device=ctx.device)


@register_op("fill_constant_batch_size_like", inputs=["Input"],
             outputs=["Out"], no_grad=True)
def fill_constant_batch_size_like(ctx, attrs, Input):
    dtype = resolve_dtype(attrs.get("dtype", "float32"))
    shape = [int(s) for s in attrs.get("shape", [])]
    shape[int(attrs.get("output_dim_idx", 0))] = \
        Input.shape[int(attrs.get("input_dim_idx", 0))]
    return torch.full(tuple(shape), attrs.get("value", 0.0), dtype=dtype,
                      device=Input.device)


@register_op("sum", inputs=["X*"], outputs=["Out"])
def sum_op(ctx, attrs, X):
    out = X[0]
    for x in X[1:]:
        out = out + x
    return out


@register_op("assign", inputs=["X"], outputs=["Out"])
def assign(ctx, attrs, X):
    return X


@register_op("cast", inputs=["X"], outputs=["Out"])
def cast(ctx, attrs, X):
    return X.to(resolve_dtype(attrs.get("out_dtype", "float32")))


@register_op("increment", inputs=["X"], outputs=["Out"], no_grad=True)
def increment(ctx, attrs, X):
    return X + torch.tensor(attrs.get("step", 1.0), dtype=X.dtype,
                            device=X.device)


def _infer_range_shape(op, block):
    """The reference's static length (:189-199): known when the bounds
    are attrs, left alone otherwise."""
    out = block._find_var_recursive(op.outputs["Out"][0])
    a = op.attrs
    if out is not None and all(k in a for k in ("start", "end", "step")) \
            and a["step"]:
        out.shape = (max(0, math.ceil((a["end"] - a["start"]) / a["step"])),)


@register_op("range", inputs=["Start", "End", "Step"], outputs=["Out"],
             no_grad=True, infer_shape=_infer_range_shape)
def range_op(ctx, attrs, Start=None, End=None, Step=None):
    """``arange`` with bounds from attrs (python scalars at build time)
    or from one-element input tensors."""
    def bound(t, attr, default=None):
        if attr in attrs:
            return float(attrs[attr])
        if t is None:
            return default
        return float(t.reshape(()).item())

    dtype = resolve_dtype(attrs.get("dtype", "float32"))
    return torch.arange(bound(Start, "start", 0.0), bound(End, "end"),
                        bound(Step, "step", 1.0), device=ctx.device
                        ).to(dtype)


@register_op("gaussian_random", inputs=[], outputs=["Out"], no_grad=True)
def gaussian_random(ctx, attrs):
    dtype = resolve_dtype(attrs.get("dtype", "float32"))
    if ctx.device.type == "meta":
        return torch.empty(_shape(attrs), dtype=dtype, device="meta")
    z = torch.randn(_shape(attrs), generator=_generator(ctx, attrs))
    return _place(ctx, attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z,
                  dtype)


@register_op("uniform_random", inputs=[], outputs=["Out"], no_grad=True)
def uniform_random(ctx, attrs):
    dtype = resolve_dtype(attrs.get("dtype", "float32"))
    if ctx.device.type == "meta":
        return torch.empty(_shape(attrs), dtype=dtype, device="meta")
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    u = torch.rand(_shape(attrs), generator=_generator(ctx, attrs))
    return _place(ctx, lo + (hi - lo) * u, dtype)


@register_op("truncated_gaussian_random", inputs=[], outputs=["Out"],
             no_grad=True)
def truncated_gaussian_random(ctx, attrs):
    """mean + std * N(0,1) truncated to [-2, 2], by inverting the normal
    CDF on a uniform draw (the reference uses
    ``jax.random.truncated_normal(-2, 2)``)."""
    dtype = resolve_dtype(attrs.get("dtype", "float32"))
    if ctx.device.type == "meta":
        return torch.empty(_shape(attrs), dtype=dtype, device="meta")
    u = torch.rand(_shape(attrs), generator=_generator(ctx, attrs),
                   dtype=torch.float64)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
    z = z.clamp(-2.0, 2.0)
    return _place(ctx, attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z,
                  dtype)


@register_op("feed", inputs=["X"], outputs=["Out"], no_grad=True)
def feed(ctx, attrs, X):
    return X


@register_op("fetch", inputs=["X"], outputs=["Out"], no_grad=True)
def fetch(ctx, attrs, X):
    return X
