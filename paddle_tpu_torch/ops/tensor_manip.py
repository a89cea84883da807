"""Shape and indexing ops (mirrors ``paddle_tpu/ops/tensor_manip.py``:
``reshape2`` at :79, ``transpose2`` at :91, ``squeeze2`` :146,
``concat`` :97, ``split`` :102, ``slice`` :119, ``unsqueeze2`` :160,
``gather`` :203, ``expand`` :227, ``pad`` :246; ``flatten`` /
``flatten2`` :169-186, ``stack`` / ``unstack`` :190-199; the v1 forms a
program saved with them needs, ``reshape`` :72 (its ``Shape`` input
unread, as there), ``transpose`` :86, ``squeeze`` :137, ``unsqueeze``
:152; ``gather_nd`` :211, ``scatter`` :217, ``expand_as`` :233, ``tile``
:241, ``pad2d`` :253, ``reverse`` :268, ``lod_reset`` :273,
``im2sequence`` :280).  A LoD travels beside a padded batch as its
lengths, not in the tensor, so ``lod_reset`` passes X through, as the
reference's.
``XShape`` is a zero-size placeholder kept for program-structure parity
with serialized reference models.  ``slice`` returns a view, as
``reshape2`` and ``transpose2`` may: a kernel wrapper that needs
contiguous rows makes them so itself."""

import torch
import torch.nn.functional as F

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


@register_op("reshape", inputs=["X", "Shape"], outputs=["Out"],
             infer_shape=_infer_reshape)
def reshape(ctx, attrs, X, Shape):
    return torch.reshape(X, _resolve_new_shape(attrs.get("shape", []),
                                               tuple(X.shape)))


@register_op("reshape2", inputs=["X", "Shape"], outputs=["Out", "XShape"],
             infer_shape=_infer_reshape, stateful_outputs=("XShape",))
def reshape2(ctx, attrs, X, Shape):
    new_shape = _resolve_new_shape(attrs.get("shape", []), tuple(X.shape))
    return {"Out": torch.reshape(X, new_shape), "XShape": _xshape(X)}


@register_op("transpose", inputs=["X"], outputs=["Out"])
def transpose(ctx, attrs, X):
    return X.permute(*attrs.get("axis"))


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


@register_op("squeeze", inputs=["X"], outputs=["Out"])
def squeeze(ctx, attrs, X):
    return _squeeze(X, list(attrs.get("axes", [])))


@register_op("squeeze2", inputs=["X"], outputs=["Out", "XShape"],
             stateful_outputs=("XShape",))
def squeeze2(ctx, attrs, X):
    return {"Out": _squeeze(X, list(attrs.get("axes", []))),
            "XShape": _xshape(X)}


def _unsqueeze(X, axes):
    out = X
    for a in sorted(axes):
        out = torch.unsqueeze(out, a)
    return out


@register_op("unsqueeze", inputs=["X"], outputs=["Out"])
def unsqueeze(ctx, attrs, X):
    return _unsqueeze(X, attrs.get("axes", []))


@register_op("unsqueeze2", inputs=["X"], outputs=["Out", "XShape"],
             stateful_outputs=("XShape",))
def unsqueeze2(ctx, attrs, X):
    return {"Out": _unsqueeze(X, attrs.get("axes", [])),
            "XShape": _xshape(X)}


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


def _in_range(idx, n):
    """jnp indexing's bounds: a negative index counts from the end, then
    every index is clamped into [0, n)."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


@register_op("gather_nd", inputs=["X", "Index"], outputs=["Out"])
def gather_nd(ctx, attrs, X, Index):
    """``X[Index[..., 0], Index[..., 1], ...]``: the last axis of Index
    addresses X's leading axes."""
    idx = Index.long()
    return X[tuple(_in_range(idx[..., k], X.shape[k])
                   for k in range(idx.shape[-1]))]


@register_op("scatter", inputs=["X", "Ids", "Updates"], outputs=["Out"])
def scatter(ctx, attrs, X, Ids, Updates):
    """X with rows ``Ids`` replaced by (``overwrite``, the default) or
    increased by the rows of Updates.  Where an id repeats in overwrite
    mode the last of its rows wins and the others take no gradient, as
    ``X.at[ids].set`` on the reference's CPU: each row's winner is found
    by a max over positions, then the winners are added to X with the
    written rows zeroed, which is exact and the same on any device."""
    ids = Ids.long()
    if ids.dim() > 1 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    ids = ids.reshape(-1)
    upd = Updates.reshape((ids.shape[0],) + tuple(X.shape[1:]))
    if not attrs.get("overwrite", True):
        return X.index_add(0, ids, upd)
    pos = torch.arange(ids.shape[0], device=ids.device)
    last = torch.full((X.shape[0],), -1, dtype=torch.long, device=ids.device)
    last = last.scatter_reduce(0, ids, pos, reduce="amax")
    tail = (1,) * (X.dim() - 1)
    wins = (last[ids] == pos).reshape((-1,) + tail)
    written = (last >= 0).reshape((-1,) + tail)
    base = torch.where(written, torch.zeros_like(X), X)
    return base.index_add(0, ids, torch.where(wins, upd,
                                              torch.zeros_like(upd)))


def _tile(X, times):
    """``jnp.tile``: fewer times than axes tile the trailing axes, more
    add leading axes."""
    times = [int(t) for t in times]
    return X.repeat(*([1] * (X.dim() - len(times)) + times))


@register_op("expand_as", inputs=["X", "target_tensor"], outputs=["Out"])
def expand_as(ctx, attrs, X, target_tensor):
    return _tile(X, [t // s for t, s in zip(target_tensor.shape, X.shape)])


@register_op("tile", inputs=["X"], outputs=["Out"])
def tile(ctx, attrs, X):
    return _tile(X, attrs.get("repeat_times", []))


def _pad_index(n, before, after, mode, device):
    """Source positions of a padded axis: ``reflect`` mirrors about the
    edge elements, ``edge`` repeats them (device arithmetic, no host
    copy)."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    i = torch.abs(i)
    return (n - 1) - torch.abs((n - 1) - i)


@register_op("pad2d", inputs=["X"], outputs=["Out"])
def pad2d(ctx, attrs, X):
    """Pad H and W (``paddings`` [top, bottom, left, right]) of an NCHW
    or NHWC batch: ``constant`` with ``pad_value``, or ``reflect`` /
    ``edge`` as a gather along each axis."""
    p = [int(v) for v in attrs.get("paddings", [0, 0, 0, 0])]
    mode = attrs.get("mode", "constant")
    h_ax, w_ax = (2, 3) if attrs.get("data_format", "NCHW") == "NCHW" \
        else (1, 2)
    if mode == "constant":
        pads = [0, 0] * (X.dim() - 1 - w_ax) + [p[2], p[3], p[0], p[1]]
        return F.pad(X, pads, value=float(attrs.get("pad_value", 0.0)))
    if mode not in ("reflect", "edge"):
        raise ValueError("pad2d mode must be constant, reflect or edge, "
                         "got %r" % mode)
    out = X.index_select(h_ax, _pad_index(X.shape[h_ax], p[0], p[1], mode,
                                          X.device))
    return out.index_select(w_ax, _pad_index(X.shape[w_ax], p[2], p[3],
                                             mode, X.device))


@register_op("reverse", inputs=["X"], outputs=["Out"])
def reverse(ctx, attrs, X):
    axis = attrs.get("axis", [0])
    return torch.flip(X, dims=[axis] if isinstance(axis, int)
                      else list(axis))


@register_op("lod_reset", inputs=["X", "Y"], outputs=["Out"])
def lod_reset(ctx, attrs, X, Y):
    return X


@register_op("im2sequence", inputs=["X"], outputs=["Out"], no_grad=True)
def im2sequence(ctx, attrs, X):
    """Each (kernels) patch of an NCHW batch as one row, channel-major
    within the row, rows in (image, out row, out column) order;
    ``paddings`` are [up, left, down, right]."""
    kh, kw = (int(k) for k in attrs.get("kernels"))
    strides = [int(s) for s in attrs.get("strides", [1, 1])]
    up, left, down, right = (int(v) for v in
                             attrs.get("paddings", [0, 0, 0, 0]))
    x = F.pad(X, [left, right, up, down])
    cols = F.unfold(x, (kh, kw), stride=strides)  # [N, C*kh*kw, L]
    return cols.transpose(1, 2).reshape(-1, cols.shape[1])
