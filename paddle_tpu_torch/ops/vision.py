"""Vision ops (mirrors ``paddle_tpu/ops/vision.py``: ``pixel_shuffle``
:18, ``shuffle_channel`` :28, ``space_to_depth`` :37, ``temporal_shift``
:47, ``affine_channel`` :66, ``crop`` :78, ``pad_constant_like`` :99,
``random_crop`` :108, ``maxout`` :131, ``lrn`` :140, ``fsp`` :158, the
bilinear sampler :170, ``grid_sampler`` :204, ``affine_grid`` :211,
``roi_pool`` :240, ``psroi_pool`` :291, ``unfold`` :337,
``deformable_conv`` :360, ``deformable_psroi_pooling`` :420).

Rearrangements are reshapes and permutes; the samplers and ROI pools are
index gathers and masked reductions with static shapes, as in the
reference, so their gradients come from the generic autograd rule
(``registry._make_generic_grad_def``).  Two ops read a tensor on the host
and so are not capturable in a CUDA graph: ``crop`` given an ``Offsets``
tensor, and ``random_crop``, whose window offsets are drawn on the host
from a ``torch.Generator`` seeded by its ``Seed`` input (the op's own
generator, ``ctx.rng``, without one).  Its draws cannot equal the
reference's ``jax.random`` draws; what matches is the semantics: the
output is a window of the input at the attr's shape."""

import torch
import torch.nn.functional as F

from .registry import register_op


@register_op("pixel_shuffle", inputs=["X"], outputs=["Out"])
def pixel_shuffle(ctx, attrs, X):
    """[N, C·r², H, W] → [N, C, H·r, W·r] (pixel_shuffle_op.cc)."""
    r = int(attrs.get("upscale_factor", 1))
    n, c, h, w = X.shape
    x = X.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (r * r), h * r, w * r)


@register_op("shuffle_channel", inputs=["X"], outputs=["Out"])
def shuffle_channel(ctx, attrs, X):
    """Interleave the channels of ``group`` groups (shuffle_channel_op.cc)."""
    g = int(attrs.get("group", 1))
    n, c, h, w = X.shape
    x = X.reshape(n, g, c // g, h, w).permute(0, 2, 1, 3, 4)
    return x.reshape(n, c, h, w)


@register_op("space_to_depth", inputs=["X"], outputs=["Out"])
def space_to_depth(ctx, attrs, X):
    """[N, C, H, W] → [N, C·b², H/b, W/b] (space_to_depth_op.cc)."""
    b = int(attrs.get("blocksize", 1))
    n, c, h, w = X.shape
    x = X.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register_op("temporal_shift", inputs=["X"], outputs=["Out"])
def temporal_shift(ctx, attrs, X):
    """[N·T, C, H, W]: the first ``shift_ratio`` of the channels moves one
    step back in time, the second forward, the rest stays
    (temporal_shift_op.cc)."""
    t = int(attrs.get("seg_num", 1))
    ratio = float(attrs.get("shift_ratio", 0.25))
    nt, c, h, w = X.shape
    n = nt // t
    c1, c2 = int(c * ratio), int(c * 2 * ratio)
    x = X.reshape(n, t, c, h, w)
    pad = torch.zeros((n, 1, c, h, w), dtype=X.dtype, device=X.device)
    slow = torch.cat([x[:, 1:, :c1], pad[:, :, :c1]], dim=1)
    fast = torch.cat([pad[:, :, c1:c2], x[:, :-1, c1:c2]], dim=1)
    out = torch.cat([slow, fast, x[:, :, c2:]], dim=2)
    return out.reshape(nt, c, h, w)


@register_op("affine_channel", inputs=["X", "Scale", "Bias"],
             outputs=["Out"])
def affine_channel(ctx, attrs, X, Scale, Bias):
    """``x * scale[C] + bias[C]`` per channel, NCHW or NHWC
    (affine_channel_op.cc)."""
    if attrs.get("data_layout", "NCHW") == "NCHW":
        shape = (1, -1) + (1,) * (X.dim() - 2)
    else:
        shape = (1,) * (X.dim() - 1) + (-1,)
    return X * Scale.reshape(shape) + Bias.reshape(shape)


def _crop_capturable(attrs, inputs):
    return not [n for n in inputs.get("Offsets", ()) if n]


@register_op("crop", inputs=["X", "Y", "Offsets"], outputs=["Out"],
             capturable=_crop_capturable)
def crop(ctx, attrs, X, Y, Offsets):
    """A window of ``shape`` (or ``Y``'s shape) at ``offsets`` (crop_op.cc).
    An ``Offsets`` tensor is read on the host and each start clamped into
    range, as the reference's traced ``dynamic_slice`` clamps."""
    shape = [int(s) for s in attrs.get("shape", [])] if Y is None \
        else list(Y.shape)
    if Offsets is not None:
        if Offsets.device.type == "meta":
            starts = [0] * X.dim()
        else:
            starts = [int(o) for o in Offsets.reshape(-1).tolist()]
        offsets = [min(max(o, 0), int(d) - s)
                   for o, d, s in zip(starts, X.shape, shape)]
    else:
        offsets = [int(o) for o in attrs.get("offsets", [0] * X.dim())]
    return X[tuple(slice(o, o + s) for o, s in zip(offsets, shape))]


@register_op("pad_constant_like", inputs=["X", "Y"], outputs=["Out"])
def pad_constant_like(ctx, attrs, X, Y):
    """Pad ``Y`` at the high end of each dim up to ``X``'s shape
    (pad_constant_like_op.cc)."""
    pads = []
    for xs, ys in reversed(list(zip(X.shape, Y.shape))):
        pads += [0, int(xs - ys)]
    return F.pad(Y, pads, value=float(attrs.get("pad_value", 0.0)))


@register_op("random_crop", inputs=["X", "Seed"], outputs=["Out", "SeedOut"],
             no_grad=True, stateful_outputs=("SeedOut",), capturable=False)
def random_crop(ctx, attrs, X, Seed):
    """A window of the trailing dims at ``shape``, each offset uniform in
    range; the leading (batch) dims are kept (random_crop_op.h)."""
    shape = [int(s) for s in attrs["shape"]]
    k = len(shape)
    lead = X.dim() - k
    if X.device.type == "meta":
        starts = [0] * k
    else:
        if Seed is not None:
            gen = torch.Generator()
            gen.manual_seed(int(Seed.reshape(-1)[0].item()))
        else:
            gen = ctx.rng()
        starts = [int(torch.randint(0, int(X.shape[lead + i]) - s + 1, (),
                                    generator=gen))
                  for i, s in enumerate(shape)]
    index = [slice(None)] * lead + [slice(o, o + s)
                                    for o, s in zip(starts, shape)]
    seed_out = Seed if Seed is not None else torch.zeros(
        (1,), dtype=torch.int64, device=X.device)
    return {"Out": X[tuple(index)], "SeedOut": seed_out}


@register_op("maxout", inputs=["X"], outputs=["Out"])
def maxout(ctx, attrs, X):
    """[N, C, H, W] → [N, C/groups, H, W], the max of each channel group
    (math/maxouting.cc)."""
    g = int(attrs.get("groups", 1))
    n, c, h, w = X.shape
    return X.reshape(n, c // g, g, h, w).amax(dim=2)


@register_op("lrn", inputs=["X"], outputs=["Out", "MidOut"],
             stateful_outputs=("MidOut",))
def lrn(ctx, attrs, X):
    """Local response norm across channels (lrn_op.cc):
    ``mid = k + alpha * sum_window x²``, ``out = x * mid^-beta``."""
    n = int(attrs.get("n", 5))
    k = float(attrs.get("k", 2.0))
    alpha = float(attrs.get("alpha", 1e-4))
    beta = float(attrs.get("beta", 0.75))
    half = n // 2
    pad = F.pad(torch.square(X), (0, 0, 0, 0, half, n - 1 - half))
    c = X.shape[1]
    window = pad[:, 0:c]
    for i in range(1, n):
        window = window + pad[:, i:i + c]
    mid = k + alpha * window
    return {"Out": X * torch.pow(mid, -beta), "MidOut": mid}


@register_op("fsp", inputs=["X", "Y"], outputs=["Out"])
def fsp(ctx, attrs, X, Y):
    """The FSP matrix (fsp_op.cc):
    ``out[b, i, j] = mean_hw X[b, i, h, w] * Y[b, j, h, w]``."""
    b, c1, h, w = X.shape
    xf = X.reshape(b, c1, h * w)
    yf = Y.reshape(b, Y.shape[1], h * w)
    return torch.bmm(xf, yf.transpose(1, 2)) / float(h * w)


def _bilinear_sample(x, gx, gy):
    """Sample NCHW ``x`` at grid coordinates ``gx``, ``gy`` in [-1, 1]
    ([N, Ho, Wo]), corners aligned, zeros outside (grid_sampler_op.cc)."""
    n, c, h, w = x.shape
    fx = (gx + 1) * 0.5 * (w - 1)
    fy = (gy + 1) * 0.5 * (h - 1)
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    dx = (fx - x0)[..., None]
    dy = (fy - y0)[..., None]
    xl = x.permute(0, 2, 3, 1)
    batch = torch.arange(n, device=x.device)[:, None, None]

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = torch.clamp(yi, 0, h - 1).long()
        xc = torch.clamp(xi, 0, w - 1).long()
        v = xl[batch, yc, xc]  # [N, Ho, Wo, C]
        return torch.where(valid[..., None], v, torch.zeros_like(v))

    out = (gather(y0, x0) * (1 - dx) * (1 - dy)
           + gather(y0, x0 + 1) * dx * (1 - dy)
           + gather(y0 + 1, x0) * (1 - dx) * dy
           + gather(y0 + 1, x0 + 1) * dx * dy)
    return out.permute(0, 3, 1, 2)


@register_op("grid_sampler", inputs=["X", "Grid"], outputs=["Output"])
def grid_sampler(ctx, attrs, X, Grid):
    """Bilinear samples of X [N, C, H, W] at Grid [N, Ho, Wo, 2] ((x, y)
    in [-1, 1]), zeros outside (grid_sampler_op.cc)."""
    return _bilinear_sample(X, Grid[..., 0], Grid[..., 1])


@register_op("affine_grid", inputs=["Theta"], outputs=["Output"])
def affine_grid(ctx, attrs, Theta):
    """The sampling grid [N, H, W, 2] of 2x3 affine parameters
    (affine_grid_op.cc): the base grid is a linspace over [-1, 1]."""
    n, c, h, w = [int(v) for v in attrs["output_shape"]]
    ys = torch.linspace(-1.0, 1.0, h, dtype=Theta.dtype, device=Theta.device)
    xs = torch.linspace(-1.0, 1.0, w, dtype=Theta.dtype, device=Theta.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # [H, W, 3]
    return torch.einsum("hwk,njk->nhwj", base, Theta)


def _rois(ROIs, lod=None):
    """(batch index [R], boxes [R, 4]): a 5-column ROIs carries the batch
    index first, else ``lod`` (or image 0) does."""
    if ROIs.shape[-1] == 5:
        return ROIs[:, 0].long(), ROIs[:, 1:]
    if lod is None:
        return torch.zeros((ROIs.shape[0],), dtype=torch.long,
                           device=ROIs.device), ROIs
    return lod.long()[:ROIs.shape[0]], ROIs


def _per_bin(extent, bins):
    """``extent / bins``, correctly rounded on every device: CUDA divides
    by a Python scalar as a product with its reciprocal, one unit off at
    times, and the bins' floor and ceil would then move a row."""
    return extent / torch.full_like(extent, float(bins))


def _bin_masks(y1, x1, bin_h, bin_w, ph, pw, h, w, device):
    """[R, ph, H] and [R, pw, W] masks of each bin's rows and columns:
    floor of the bin start to ceil of its end, clipped to the map."""
    ys = torch.arange(h, dtype=torch.float32, device=device)
    xs = torch.arange(w, dtype=torch.float32, device=device)
    iy = torch.arange(ph, dtype=torch.float32, device=device)
    ix = torch.arange(pw, dtype=torch.float32, device=device)
    hstart = torch.clamp(torch.floor(y1[:, None] + iy[None] * bin_h[:, None]),
                         0, h)
    hend = torch.clamp(torch.ceil(y1[:, None] + (iy[None] + 1)
                                  * bin_h[:, None]), 0, h)
    wstart = torch.clamp(torch.floor(x1[:, None] + ix[None] * bin_w[:, None]),
                         0, w)
    wend = torch.clamp(torch.ceil(x1[:, None] + (ix[None] + 1)
                                  * bin_w[:, None]), 0, w)
    hmask = (ys[None, None] >= hstart[:, :, None]) \
        & (ys[None, None] < hend[:, :, None])
    wmask = (xs[None, None] >= wstart[:, :, None]) \
        & (xs[None, None] < wend[:, :, None])
    return hmask, wmask


@register_op("roi_pool", inputs=["X", "ROIs", "RoisLod"],
             outputs=["Out", "Argmax"], stateful_outputs=("Argmax",))
def roi_pool(ctx, attrs, X, ROIs, RoisLod):
    """Max over each ROI bin (roi_pool_op.cc), integer-rounded boxes; an
    empty bin gives 0.  A separable masked max: rows per bin-row, then
    columns per bin-column."""
    scale = float(attrs.get("spatial_scale", 1.0))
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    batch_idx, boxes = _rois(ROIs, RoisLod)
    n, c, h, w = X.shape
    x1 = torch.round(boxes[:, 0] * scale)
    y1 = torch.round(boxes[:, 1] * scale)
    x2 = torch.round(boxes[:, 2] * scale)
    y2 = torch.round(boxes[:, 3] * scale)
    bin_h = _per_bin(torch.clamp(y2 - y1 + 1, min=1.0), ph)
    bin_w = _per_bin(torch.clamp(x2 - x1 + 1, min=1.0), pw)
    hmask, wmask = _bin_masks(y1, x1, bin_h, bin_w, ph, pw, h, w, X.device)
    feats = X[batch_idx]  # [R, C, H, W]
    neg = torch.full((), -3.4e38, dtype=X.dtype, device=X.device)
    hred = torch.stack([
        torch.where(hmask[:, i, None, :, None], feats, neg).amax(dim=2)
        for i in range(ph)], dim=2)                      # [R, C, ph, W]
    out = torch.stack([
        torch.where(wmask[:, j, None, None, :], hred, neg).amax(dim=-1)
        for j in range(pw)], dim=3)                      # [R, C, ph, pw]
    empty = (hmask.sum(2)[:, None, :, None]
             * wmask.sum(2)[:, None, None, :]) == 0
    out = torch.where(empty, torch.zeros_like(out), out)
    return {"Out": out,
            "Argmax": torch.zeros(out.shape, dtype=torch.int64,
                                  device=X.device)}


@register_op("psroi_pool", inputs=["X", "ROIs"], outputs=["Out"])
def psroi_pool(ctx, attrs, X, ROIs):
    """Position-sensitive ROI average pool (psroi_pool_op.cc): bin (i, j)
    of output channel k averages input channel ``k·ph·pw + i·pw + j``
    over the bin."""
    scale = float(attrs.get("spatial_scale", 1.0))
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    out_c = int(attrs.get("output_channels"))
    batch_idx, boxes = _rois(ROIs)
    n, c, h, w = X.shape
    r = boxes.shape[0]
    x1 = boxes[:, 0] * scale
    y1 = boxes[:, 1] * scale
    bin_h = _per_bin(torch.clamp(boxes[:, 3] * scale - y1, min=0.1), ph)
    bin_w = _per_bin(torch.clamp(boxes[:, 2] * scale - x1, min=0.1), pw)
    hmask, wmask = _bin_masks(y1, x1, bin_h, bin_w, ph, pw, h, w, X.device)
    hmask, wmask = hmask.to(X.dtype), wmask.to(X.dtype)
    feats = X[batch_idx].reshape(r, out_c, ph, pw, h, w)
    s = torch.einsum("rkijhw,rih,rjw->rkij", feats, hmask, wmask)
    area = torch.clamp(hmask.sum(2)[:, None, :, None]
                       * wmask.sum(2)[:, None, None, :], min=1.0)
    return s / area


@register_op("unfold", inputs=["X"], outputs=["Y"])
def unfold(ctx, attrs, X):
    """im2col (unfold_op.cc): [N, C, H, W] → [N, C·kh·kw, L]."""
    kh, kw = [int(v) for v in attrs["kernel_sizes"]]
    sh, sw = [int(v) for v in attrs.get("strides", [1, 1])]
    pads = [int(v) for v in attrs.get("paddings", [0, 0, 0, 0])]
    dh, dw = [int(v) for v in attrs.get("dilations", [1, 1])]
    n, c = X.shape[0], X.shape[1]
    x = F.pad(X, (pads[1], pads[3], pads[0], pads[2]))
    oh = (x.shape[2] - (dh * (kh - 1) + 1)) // sh + 1
    ow = (x.shape[3] - (dw * (kw - 1) + 1)) // sw + 1
    patches = [x[:, :, i * dh:i * dh + oh * sh:sh, j * dw:j * dw + ow * sw:sw]
               for i in range(kh) for j in range(kw)]
    return torch.stack(patches, dim=2).reshape(n, c * kh * kw, oh * ow)


@register_op("deformable_conv", inputs=["Input", "Offset", "Mask", "Filter"],
             outputs=["Output"])
def deformable_conv(ctx, attrs, Input, Offset, Mask, Filter):
    """Modulated deformable convolution v2 (deformable_conv_op.cu): each
    kernel tap samples the input bilinearly at its place plus the learned
    offset (channel ``2t`` y, ``2t + 1`` x of the offset map), scaled by
    the mask, then the taps and channels contract with the filter."""
    strides = [int(s) for s in attrs.get("strides", [1, 1])]
    pads = [int(p) for p in attrs.get("paddings", [0, 0])]
    dil = [int(d) for d in attrs.get("dilations", [1, 1])]
    groups = int(attrs.get("groups", 1) or 1)
    dg = int(attrs.get("deformable_groups", 1) or 1)
    n, c, h, w = Input.shape
    m, c_g, kh, kw = Filter.shape
    oh = (h + 2 * pads[0] - (dil[0] * (kh - 1) + 1)) // strides[0] + 1
    ow = (w + 2 * pads[1] - (dil[1] * (kw - 1) + 1)) // strides[1] + 1
    off = Offset.reshape(n, dg, kh * kw, 2, oh, ow)
    msk = Mask.reshape(n, dg, kh * kw, oh, ow) if Mask is not None else None
    dev = Input.device
    base_y = (torch.arange(oh, device=dev) * strides[0] - pads[0])[None, :,
                                                                   None]
    base_x = (torch.arange(ow, device=dev) * strides[1] - pads[1])[None,
                                                                   None, :]
    cpg = c // dg
    taps = []
    for t in range(kh * kw):
        ki, kj = t // kw, t % kw
        group_feats = []
        for g in range(dg):
            py = (base_y + ki * dil[0] + off[:, g, t, 0]).float()
            px = (base_x + kj * dil[1] + off[:, g, t, 1]).float()
            gx = 2.0 * px / max(w - 1, 1) - 1.0
            gy = 2.0 * py / max(h - 1, 1) - 1.0
            v = _bilinear_sample(Input[:, g * cpg:(g + 1) * cpg], gx, gy)
            if msk is not None:
                v = v * msk[:, g, t][:, None]
            group_feats.append(v)
        taps.append(torch.cat(group_feats, dim=1))   # [N, C, OH, OW]
    col = torch.stack(taps, dim=2)                   # [N, C, kh·kw, OH, OW]
    if groups == 1:
        return torch.einsum("nckhw,mck->nmhw", col,
                            Filter.reshape(m, c, kh * kw))
    cg, mg = c // groups, m // groups
    return torch.cat(
        [torch.einsum("nckhw,mck->nmhw", col[:, gi * cg:(gi + 1) * cg],
                      Filter[gi * mg:(gi + 1) * mg].reshape(mg, cg, kh * kw))
         for gi in range(groups)], dim=1)


@register_op("deformable_psroi_pooling",
             inputs=["Input", "ROIs", "Trans"],
             outputs=["Output", "TopCount"], stateful_outputs=("TopCount",))
def deformable_psroi_pooling(ctx, attrs, Input, ROIs, Trans):
    """Deformable position-sensitive ROI pooling
    (deformable_psroi_pooling_op.cu): each bin's window moves by a
    learned offset (``Trans`` [R, 2, ph, pw]) times ``trans_std`` and the
    ROI's extent, and averages ``sample_per_part``² bilinear samples of
    the bin's channel group (or all channels when the input has
    ``output_dim`` of them)."""
    scale = float(attrs.get("spatial_scale", 1.0))
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    out_c = int(attrs.get("output_dim"))
    trans_std = float(attrs.get("trans_std", 0.1))
    sp = int(attrs.get("sample_per_part", 4))
    no_trans = bool(attrs.get("no_trans", False))
    batch_idx, boxes = _rois(ROIs)
    n, c, h, w = Input.shape
    r = boxes.shape[0]
    dev = Input.device
    x1 = boxes[:, 0] * scale - 0.5
    y1 = boxes[:, 1] * scale - 0.5
    rw = torch.clamp((boxes[:, 2] + 1.0) * scale - 0.5 - x1, min=0.1)
    rh = torch.clamp((boxes[:, 3] + 1.0) * scale - 0.5 - y1, min=0.1)
    bin_w = _per_bin(rw, pw)
    bin_h = _per_bin(rh, ph)
    if c == out_c * ph * pw:
        feats = Input[batch_idx].reshape(r, out_c, ph, pw, h, w)
    elif c == out_c:
        feats = Input[batch_idx][:, :, None, None].expand(
            r, out_c, ph, pw, h, w)
    else:
        raise ValueError(
            "deformable_psroi_pooling: channels %d fit neither the "
            "position-sensitive (out_c*ph*pw=%d) nor plain (out_c=%d) "
            "layout" % (c, out_c * ph * pw, out_c))
    if Trans is not None and not no_trans:
        tr = Trans.reshape(r, 2, ph, pw) * trans_std
        dy = tr[:, 0] * rh[:, None, None]
        dx = tr[:, 1] * rw[:, None, None]
    else:
        dy = torch.zeros((r, ph, pw), device=dev)
        dx = torch.zeros((r, ph, pw), device=dev)
    iy = torch.arange(ph, dtype=torch.float32, device=dev)
    ix = torch.arange(pw, dtype=torch.float32, device=dev)
    sub = (torch.arange(sp, dtype=torch.float32, device=dev) + 0.5) / sp
    ys = (y1[:, None, None, None] + iy[None, :, None, None]
          * bin_h[:, None, None, None]
          + sub[None, None, None, :] * bin_h[:, None, None, None]
          + dy[:, :, :, None])                           # [R, ph, pw, S]
    xs = (x1[:, None, None, None] + ix[None, None, :, None]
          * bin_w[:, None, None, None]
          + sub[None, None, None, :] * bin_w[:, None, None, None]
          + dx[:, :, :, None])
    acc = [[torch.zeros((r, out_c), device=dev) for _ in range(pw)]
           for _ in range(ph)]
    for sy in range(sp):
        for sx in range(sp):
            gy = 2.0 * ys[..., sy] / max(h - 1, 1) - 1.0
            gx = 2.0 * xs[..., sx] / max(w - 1, 1) - 1.0
            for i in range(ph):
                for j in range(pw):
                    v = _bilinear_sample(feats[:, :, i, j],
                                         gx[:, i, j][:, None, None],
                                         gy[:, i, j][:, None, None])
                    acc[i][j] = acc[i][j] + v[:, :, 0, 0]
    out = torch.stack([torch.stack(row, dim=-1) for row in acc], dim=2)
    return {"Output": out / float(sp * sp),
            "TopCount": torch.ones((r, out_c, ph, pw), dtype=torch.float32,
                                   device=dev)}
