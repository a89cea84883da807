"""Creation ops, ``sum``, small tensor ops and feed/fetch markers (mirrors
``paddle_tpu/ops/basic.py`` lines 17-237: ``fill_constant_batch_size_like``
:24, ``fill_any_like`` / ``fill_zeros_like`` :35-44, ``assign`` :95, ``assign_value`` :100, ``cast`` :116, ``sum`` :130, ``increment`` :143,
``clip`` / ``clip_by_norm`` / ``squared_l2_norm`` :148-161, ``range``
:202; ``randint`` :84, ``share_data`` :111, ``shape`` :138, ``isfinite``
/ ``isinf`` / ``isnan`` :166-182, ``linspace`` :251).

Random draws come from the per-draw ``torch.Generator`` of
:meth:`LoweringContext.rng`, drawn on the CPU and moved to the run's
device, so a seeded startup program initializes identical parameters on
the CPU and on the GPU; a host draw per run is not capturable in a CUDA
graph, so a program that holds one runs eagerly.  ``randint`` draws on
the device instead (``common.device_bits`` from the run's step seed),
so it stays capturable and a replayed step draws anew; a nonzero
``seed`` attr fixes its draw, as the reference's ``jax.random.key(seed)``
does.  The two packages draw different numbers from the same seed.
"""

import math

import numpy as np
import torch

from .common import device_bits, resolve_dtype
from .cuda import dropout as _drop
from .registry import EMPTY_VAR_NAME, register_op


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


@register_op("fill_any_like", inputs=["X"], outputs=["Out"], no_grad=True)
def fill_any_like(ctx, attrs, X):
    """``value`` in X's shape, in X's dtype unless ``dtype`` names one
    (-1: X's)."""
    dtype = attrs.get("dtype", -1)
    dt = X.dtype if dtype in (-1, None) else resolve_dtype(dtype)
    return torch.full(tuple(X.shape), attrs.get("value", 0.0), dtype=dt,
                      device=X.device)


@register_op("fill_zeros_like", inputs=["X"], outputs=["Out"], no_grad=True)
def fill_zeros_like(ctx, attrs, X):
    return torch.zeros_like(X)


@register_op("sum", inputs=["X*"], outputs=["Out"])
def sum_op(ctx, attrs, X):
    out = X[0]
    for x in X[1:]:
        out = out + x
    return out


@register_op("assign", inputs=["X"], outputs=["Out"])
def assign(ctx, attrs, X):
    """A copy: a later in-place op on the result must not write X."""
    return X.clone()


@register_op("assign_value", inputs=[], outputs=["Out"], no_grad=True,
             capturable=False)
def assign_value(ctx, attrs):
    """A constant from the op's ``values`` attr (``fp32_values`` /
    ``int32_values`` in the reference's spelling), copied from the host
    on every run (so not capturable)."""
    values = attrs.get("values")
    if values is None:
        values = attrs.get("fp32_values", attrs.get("int32_values"))
    arr = np.asarray(values).reshape(_shape(attrs))
    dtype = resolve_dtype(attrs.get("dtype", str(arr.dtype)))
    return torch.as_tensor(arr).to(device=ctx.device, dtype=dtype)


@register_op("cast", inputs=["X"], outputs=["Out"])
def cast(ctx, attrs, X):
    return X.to(resolve_dtype(attrs.get("out_dtype", "float32")))


@register_op("increment", inputs=["X"], outputs=["Out"], no_grad=True,
             in_place={"Out": "X"})
def increment(ctx, attrs, X):
    """``X += step`` in place (the learning-rate schedules' step counter
    and the decode counters); a device add, no host copy: capturable."""
    return X.add_(torch.full((), attrs.get("step", 1.0), dtype=X.dtype,
                             device=X.device))


@register_op("clip", inputs=["X"], outputs=["Out"])
def clip(ctx, attrs, X):
    return torch.clamp(X, attrs.get("min"), attrs.get("max"))


@register_op("clip_by_norm", inputs=["X"], outputs=["Out"])
def clip_by_norm(ctx, attrs, X):
    """``X * max_norm / norm`` where the L2 norm exceeds ``max_norm``,
    else ``X``; the norm stays on the device."""
    max_norm = float(attrs["max_norm"])
    norm = torch.sqrt(torch.sum(torch.square(X)))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp(norm, min=1e-12),
                        torch.ones_like(norm))
    return X * scale.to(X.dtype)


@register_op("squared_l2_norm", inputs=["X"], outputs=["Out"])
def squared_l2_norm(ctx, attrs, X):
    return torch.sum(torch.square(X)).reshape(1)


def _infer_range_shape(op, block):
    """The reference's static length (:189-199): known when the bounds
    are attrs, left alone otherwise."""
    out = block._find_var_recursive(op.outputs["Out"][0])
    a = op.attrs
    if out is not None and all(k in a for k in ("start", "end", "step")) \
            and a["step"]:
        out.shape = (max(0, math.ceil((a["end"] - a["start"]) / a["step"])),)


def _range_bounds_static(attrs, inputs):
    """Every bound an attr or absent: a tensor bound is read on the host
    and sizes the output, so such a ``range`` is not capturable."""
    return all(attr in attrs or not [n for n in inputs.get(slot, ())
                                     if n and n != EMPTY_VAR_NAME]
               for slot, attr in (("Start", "start"), ("End", "end"),
                                  ("Step", "step")))


@register_op("range", inputs=["Start", "End", "Step"], outputs=["Out"],
             no_grad=True, infer_shape=_infer_range_shape,
             capturable=_range_bounds_static)
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


@register_op("gaussian_random", inputs=[], outputs=["Out"], no_grad=True,
             capturable=False)
def gaussian_random(ctx, attrs):
    dtype = resolve_dtype(attrs.get("dtype", "float32"))
    if ctx.device.type == "meta":
        return torch.empty(_shape(attrs), dtype=dtype, device="meta")
    z = torch.randn(_shape(attrs), generator=_generator(ctx, attrs))
    return _place(ctx, attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z,
                  dtype)


@register_op("uniform_random", inputs=[], outputs=["Out"], no_grad=True,
             capturable=False)
def uniform_random(ctx, attrs):
    dtype = resolve_dtype(attrs.get("dtype", "float32"))
    if ctx.device.type == "meta":
        return torch.empty(_shape(attrs), dtype=dtype, device="meta")
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    u = torch.rand(_shape(attrs), generator=_generator(ctx, attrs))
    return _place(ctx, lo + (hi - lo) * u, dtype)


@register_op("truncated_gaussian_random", inputs=[], outputs=["Out"],
             no_grad=True, capturable=False)
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


@register_op("randint", inputs=[], outputs=["Out"], no_grad=True)
def randint(ctx, attrs):
    """Integers uniform in [low, high), drawn on the device."""
    shape = _shape(attrs)
    low, high = int(attrs.get("low", 0)), int(attrs.get("high", 100))
    dtype = resolve_dtype(attrs.get("dtype", "int64"))
    seed = int(attrs.get("seed", 0) or 0)
    bits = device_bits(_drop.op_salt(seed, 0, 0) if seed else ctx.step_seed(),
                       shape, ctx.device)
    return (low + bits % max(high - low, 1)).to(dtype)


@register_op("share_data", inputs=["X"], outputs=["Out"])
def share_data(ctx, attrs, X):
    """Out is X's data itself."""
    return X


@register_op("shape", inputs=["Input"], outputs=["Out"], no_grad=True)
def shape_op(ctx, attrs, Input):
    """Input's static shape as int32, from its metadata: it never reads
    the device, and it is made by fills, not a host-to-device copy, so a
    CUDA graph can capture it."""
    out = torch.empty((Input.dim(),), dtype=torch.int32, device=Input.device)
    for i, d in enumerate(Input.shape):
        out[i].fill_(int(d))
    return out


def _all_of(X, test, reduce, combine, start):
    ok = torch.full((1,), start, dtype=torch.bool, device=X[0].device)
    for x in X:
        ok = combine(ok, reduce(test(x)).reshape(1))
    return ok


@register_op("isfinite", inputs=["X*"], outputs=["Out"], no_grad=True)
def isfinite(ctx, attrs, X):
    """One bool: every element of every input is finite."""
    return _all_of(X, torch.isfinite, torch.all, torch.logical_and, True)


@register_op("isinf", inputs=["X*"], outputs=["Out"], no_grad=True)
def isinf(ctx, attrs, X):
    """One bool: some element of some input is infinite."""
    return _all_of(X, torch.isinf, torch.any, torch.logical_or, False)


@register_op("isnan", inputs=["X*"], outputs=["Out"], no_grad=True)
def isnan(ctx, attrs, X):
    """One bool: some element of some input is NaN."""
    return _all_of(X, torch.isnan, torch.any, torch.logical_or, False)


def _linspace_infer_shape(op, block):
    """``[num]`` when ``num`` is an attr; a ``Num`` input leaves the
    declared shape (its length is known only at run time)."""
    num = op.attr("num")
    if num is not None:
        v = block._find_var_recursive(op.output("Out")[0])
        if v is not None:
            v.shape = (int(num),)


def _linspace_num_static(attrs, inputs):
    """A ``num`` attr is static; a ``Num`` tensor is read on the host."""
    return attrs.get("num") is not None


@register_op("linspace", inputs=["Start", "Stop", "Num"], outputs=["Out"],
             no_grad=True, infer_shape=_linspace_infer_shape,
             capturable=_linspace_num_static)
def linspace(ctx, attrs, Start, Stop, Num=None):
    """``num`` evenly spaced values from Start to Stop (1-element
    tensors), as ``jnp.linspace`` computes them: ``start * (1 - i / d) +
    stop * (i / d)`` for i < d = num - 1, then stop itself, in the
    float type (float32 for an integer dtype, then floored), cast to
    Start's dtype."""
    num = attrs.get("num")
    if num is None:
        if Num is None:
            raise ValueError("linspace needs the num attr or a Num input")
        num = int(Num.reshape(()).item())
    num = int(num)
    dtype = Start.dtype
    calc = dtype if dtype.is_floating_point else torch.float32
    start = Start.reshape(()).to(calc)
    stop = Stop.reshape(()).to(calc)
    if num <= 1:
        out = start.reshape(1)[:num]
    else:
        div = num - 1
        step = torch.arange(div, dtype=calc, device=Start.device) / div
        out = torch.cat([start * (1 - step) + stop * step, stop.reshape(1)])
    if not dtype.is_floating_point:
        out = torch.floor(out)  # jnp.linspace floors for an integer dtype
    return out.to(dtype)


@register_op("feed", inputs=["X"], outputs=["Out"], no_grad=True)
def feed(ctx, attrs, X):
    return X


@register_op("fetch", inputs=["X"], outputs=["Out"], no_grad=True)
def fetch(ctx, attrs, X):
    return X
