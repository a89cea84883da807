"""Shape and indexing ops (mirrors ``paddle_tpu/ops/tensor_manip.py``:
``reshape2`` at :79, ``transpose2`` at :91, ``squeeze2`` :146,
``concat`` :97, ``split`` :102, ``slice`` :119, ``unsqueeze2`` :160,
``gather`` :203, ``expand`` :227, ``pad`` :246; ``flatten`` /
``flatten2`` :169-186, ``stack`` / ``unstack`` :190-199).
``XShape`` is a zero-size placeholder kept for program-structure parity
with serialized reference models.  ``slice`` returns a view, as
``reshape2`` and ``transpose2`` may: a kernel wrapper that needs
contiguous rows makes them so itself."""

import torch

from .registry import register_op


def _resolve_new_shape(shape_attr, in_shape):
    """Fluid reshape semantics: 0 copies the input dim, -1 infers."""
    return tuple(in_shape[i] if s == 0 else int(s)
                 for i, s in enumerate(shape_attr))


def _xshape(x):
    return torch.empty((0,) + tuple(x.shape), dtype=x.dtype, device=x.device)


def _infer_reshape(op, block):
    name = op.inputs.get("X", [None])[0]
    var = block._find_var_recursive(name) if name else None
    out_var = block._find_var_recursive(op.outputs["Out"][0])
    shape_attr = op.attrs.get("shape", [])
    if out_var is None or var is None:
        return
    if var.shape is not None:
        in_shape = var.shape
        new = [in_shape[i] if s == 0 and i < len(in_shape) else int(s)
               for i, s in enumerate(shape_attr)]
        # resolve a single -1 if the other dims are static
        if new.count(-1) == 1 and all(d >= 0 for d in in_shape):
            known = 1
            for d in new:
                if d != -1:
                    known *= d
            total = 1
            for d in in_shape:
                total *= d
            if known > 0 and total % known == 0:
                new[new.index(-1)] = total // known
        out_var.shape = tuple(new)
    else:
        out_var.shape = tuple(int(s) for s in shape_attr)
    out_var.dtype = var.dtype
    if "XShape" in op.outputs:
        xs = block._find_var_recursive(op.outputs["XShape"][0])
        if xs is not None and var.shape is not None:
            xs.shape = (0,) + tuple(var.shape)
            xs.dtype = var.dtype


@register_op("reshape2", inputs=["X", "Shape"], outputs=["Out", "XShape"],
             infer_shape=_infer_reshape, stateful_outputs=("XShape",))
def reshape2(ctx, attrs, X, Shape):
    new_shape = _resolve_new_shape(attrs.get("shape", []), tuple(X.shape))
    return {"Out": torch.reshape(X, new_shape), "XShape": _xshape(X)}


@register_op("transpose2", inputs=["X"], outputs=["Out", "XShape"],
             stateful_outputs=("XShape",))
def transpose2(ctx, attrs, X):
    return {"Out": X.permute(*attrs.get("axis")), "XShape": _xshape(X)}


def _squeeze(X, axes):
    axes = [a % X.dim() for a in axes]
    if not axes:
        return torch.squeeze(X)
    keep = [a for a in axes if X.shape[a] == 1]
    return torch.squeeze(X, dim=tuple(keep)) if keep else X


@register_op("squeeze2", inputs=["X"], outputs=["Out", "XShape"],
             stateful_outputs=("XShape",))
def squeeze2(ctx, attrs, X):
    return {"Out": _squeeze(X, list(attrs.get("axes", []))),
            "XShape": _xshape(X)}


@register_op("unsqueeze2", inputs=["X"], outputs=["Out", "XShape"],
             stateful_outputs=("XShape",))
def unsqueeze2(ctx, attrs, X):
    out = X
    for a in sorted(attrs.get("axes", [])):
        out = torch.unsqueeze(out, a)
    return {"Out": out, "XShape": _xshape(X)}


def _flatten(X, attrs):
    axis = int(attrs.get("axis", 1))
    lead = 1
    for d in X.shape[:axis]:
        lead *= d
    return torch.reshape(X, (lead, -1))


@register_op("flatten", inputs=["X"], outputs=["Out"])
def flatten(ctx, attrs, X):
    """``[d0..d(axis-1), ...]`` → ``[prod(d0..d(axis-1)), rest]``."""
    return _flatten(X, attrs)


@register_op("flatten2", inputs=["X"], outputs=["Out", "XShape"],
             stateful_outputs=("XShape",))
def flatten2(ctx, attrs, X):
    return {"Out": _flatten(X, attrs), "XShape": _xshape(X)}


@register_op("stack", inputs=["X*"], outputs=["Y"])
def stack(ctx, attrs, X):
    return torch.stack(list(X), dim=int(attrs.get("axis", 0)))


@register_op("unstack", inputs=["X"], outputs=["Y*"])
def unstack(ctx, attrs, X):
    """``num`` parts along ``axis`` (all of it by default), each with
    that axis dropped."""
    axis = int(attrs.get("axis", 0))
    num = int(attrs.get("num") or X.shape[axis])
    return {"Y": [torch.squeeze(p, axis)
                  for p in torch.chunk(X, num, dim=axis)]}


@register_op("concat", inputs=["X*"], outputs=["Out"])
def concat(ctx, attrs, X):
    return torch.cat(list(X), dim=int(attrs.get("axis", 0)))


@register_op("split", inputs=["X"], outputs=["Out*"])
def split(ctx, attrs, X):
    """``X`` cut along ``axis`` into ``num`` equal parts, or at the
    running sums of ``sections`` (the last section is what is left)."""
    axis = int(attrs.get("axis", 0))
    sections = [int(s) for s in attrs.get("sections", [])]
    if sections:
        cuts, acc = [], 0
        for s in sections[:-1]:
            acc += s
            cuts.append(acc)
        return {"Out": list(torch.tensor_split(X, cuts, dim=axis))}
    num = int(attrs.get("num", 0))
    return {"Out": list(torch.split(X, X.shape[axis] // num, dim=axis))}


@register_op("slice", inputs=["Input"], outputs=["Out"])
def slice_op(ctx, attrs, Input):
    """``Input[starts:ends]`` along ``axes`` (an end past the dim is
    clipped), then ``decrease_axis`` squeezed."""
    idx = [slice(None)] * Input.dim()
    for ax, st, en in zip(attrs.get("axes", []), attrs.get("starts", []),
                          attrs.get("ends", [])):
        en = int(en)
        idx[ax] = slice(int(st), min(en, Input.shape[ax]) if en >= 0
                        else en)
    out = Input[tuple(idx)]
    decrease = attrs.get("decrease_axis", [])
    if decrease:
        out = torch.squeeze(out, dim=tuple(decrease))
    return out


@register_op("gather", inputs=["X", "Index"], outputs=["Out"])
def gather(ctx, attrs, X, Index):
    """Rows of X at Index along axis 0, with ``jnp.take``'s semantics: a
    negative index counts from the end, and one outside [-n, n) reads NaN
    in a floating X."""
    idx = Index.long()
    if idx.dim() > 1 and idx.shape[-1] == 1:
        idx = idx[..., 0]
    n = X.shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    out = X[idx.clamp(0, n - 1)]
    if out.is_floating_point():
        bad = ((idx < 0) | (idx >= n)).reshape(
            tuple(idx.shape) + (1,) * (X.dim() - 1))
        out = torch.where(bad, torch.full_like(out, float("nan")), out)
    return out


@register_op("expand", inputs=["X"], outputs=["Out"])
def expand(ctx, attrs, X):
    """``X`` tiled ``expand_times`` times along each axis (``jnp.tile``:
    fewer times than axes tile the trailing axes)."""
    times = [int(t) for t in attrs.get("expand_times", [])]
    times = [1] * (X.dim() - len(times)) + times
    return X.repeat(*times)


@register_op("pad", inputs=["X"], outputs=["Out"])
def pad(ctx, attrs, X):
    """Constant padding; ``paddings`` holds (before, after) per dim."""
    p = [int(v) for v in attrs.get("paddings", [])]
    pairs = [(p[2 * i], p[2 * i + 1]) for i in range(X.dim())]
    return torch.nn.functional.pad(
        X, [v for pair in reversed(pairs) for v in pair],
        value=float(attrs.get("pad_value", 0.0)))
