"""The vision ops and their ``fluid.layers`` front ends of the PyTorch port
against the reference: the 17 op types of ``ops/vision.py``
(``pixel_shuffle`` … ``deformable_psroi_pooling``), ``pool3d``, the
image resizes (``bilinear_interp``, ``nearest_interp``), the layers of
the ops the dygraph layers registered (``conv2d_transpose``,
``group_norm``, ``conv3d``, ``conv3d_transpose``), ``sequence_pool``
and ``auc``.

Each case builds the same layer in both packages on seeded numpy feeds,
copies the reference's parameters into the port by name, and fetches
the output and the gradients of ``sum(out * cot)`` (``cot`` a seeded
cotangent) with respect to the differentiable feeds and the parameters.
Forward within 1e-5 and gradients within 1e-4 (relative to the largest
magnitude), every case.  ``roi_pool``'s bins and the deformable ops'
bilinear corners are discontinuous in the boxes and offsets (a floor
picks a cell); the seeded boxes and offsets here lie away from cell
edges, so the same tolerances hold, and the port computes the bins'
quotients correctly rounded on every device (``ops/vision.py``
``_per_bin``).
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.executor import Scope as JScope

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.convert import load_params_into_scope
from paddle_tpu_torch.executor import Scope

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if not got.size:
        return
    err = float(np.abs(got - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), (what, err)


def _run(fluid, build, feeds, grad_feeds, params=None, seed=0):
    """Build ``build(fluid, vars)`` on ``feeds``, run it once and return
    (output, {name: gradient}, parameters)."""
    fluid.unique_name.switch()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup):
        ins = {}
        for name, val in feeds.items():
            ins[name] = fluid.layers.data(
                name, shape=list(val.shape), dtype=str(val.dtype),
                append_batch_size=False,
                stop_gradient=name not in grad_feeds)
        out = build(fluid, ins)
        wrt = [ins[n] for n in grad_feeds] + [
            p for p in main.all_parameters() if p.trainable]
        loss = None
        if wrt:
            cot = fluid.layers.data("cot", shape=list(out.shape),
                                    dtype="float32", append_batch_size=False)
            loss = fluid.layers.reduce_sum(
                fluid.layers.elementwise_mul(out, cot))
            fluid.backward.append_backward(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = JScope() if fluid is jfluid else Scope()
    exe.run(startup, scope=scope)
    if params is not None:
        load_params_into_scope(params, scope, program=main)
    own = {p.name: np.asarray(scope.get(p.name))
           for p in main.all_parameters()}
    feed = dict(feeds)
    fetch = [out]
    names = []
    if wrt:
        feed["cot"] = np.random.RandomState(7).randn(
            *out.shape).astype("float32")
        names = [v.name for v in wrt]
        fetch += [n + "@GRAD" for n in names]
    res = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    return (np.asarray(res[0]),
            {n: np.asarray(g) for n, g in zip(names, res[1:])}, own)


def _compare(build, feeds, grad_feeds=(), fwd_tol=FWD_TOL,
             grad_tol=GRAD_TOL):
    ref_out, ref_grads, params = _run(jfluid, build, feeds, grad_feeds)
    out, grads, _ = _run(tfluid, build, feeds, grad_feeds, params=params)
    _close(out, ref_out, fwd_tol, "forward")
    assert set(grads) == set(ref_grads)
    for name in grads:
        _close(grads[name], ref_grads[name], grad_tol, name + "@GRAD")
    return out


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _rois(n_img, r, hw, seed=3, batch_col=True):
    rng = np.random.RandomState(seed)
    x1 = rng.uniform(0, hw * 0.5, r)
    y1 = rng.uniform(0, hw * 0.5, r)
    x2 = x1 + rng.uniform(1.5, hw * 0.5, r)
    y2 = y1 + rng.uniform(1.5, hw * 0.5, r)
    boxes = np.stack([x1, y1, x2, y2], 1)
    if batch_col:
        boxes = np.concatenate(
            [rng.randint(0, n_img, (r, 1)).astype("float64"), boxes], 1)
    return boxes.astype("float32")


def _offset_conv(fluid, x, taps):
    """The offset map of a deformable conv: a conv of its input (a
    parameter of its own) at the deformable conv's window, as detection
    models build it."""
    return fluid.layers.conv2d(x, num_filters=2 * taps, filter_size=2)


CASES = {
    "pixel_shuffle": (
        lambda f, v: f.layers.pixel_shuffle(v["x"], 2),
        {"x": _x(2, 8, 3, 5)}, ["x"]),
    "shuffle_channel": (
        lambda f, v: f.layers.shuffle_channel(v["x"], group=3),
        {"x": _x(2, 6, 4, 4)}, ["x"]),
    "space_to_depth": (
        lambda f, v: f.layers.space_to_depth(v["x"], 2),
        {"x": _x(2, 3, 4, 6)}, ["x"]),
    "temporal_shift": (
        lambda f, v: f.layers.temporal_shift(v["x"], seg_num=3,
                                             shift_ratio=0.25),
        {"x": _x(6, 8, 3, 3)}, ["x"]),
    "affine_channel_nchw": (
        lambda f, v: f.layers.affine_channel(v["x"], v["s"], v["b"]),
        {"x": _x(2, 4, 3, 3), "s": _x(4, seed=1), "b": _x(4, seed=2)},
        ["x", "s", "b"]),
    "affine_channel_nhwc": (
        lambda f, v: f.layers.affine_channel(v["x"], v["s"], v["b"],
                                             data_layout="NHWC"),
        {"x": _x(2, 3, 3, 4), "s": _x(4, seed=1), "b": _x(4, seed=2)},
        ["x", "s", "b"]),
    "crop_static": (
        lambda f, v: f.layers.crop(v["x"], shape=[2, 3, 4, 3],
                                   offsets=[0, 1, 2, 1]),
        {"x": _x(2, 5, 7, 6)}, ["x"]),
    "crop_like_y": (
        lambda f, v: f.layers.crop(v["x"], shape=v["y"],
                                   offsets=[0, 0, 1, 2]),
        {"x": _x(2, 3, 6, 6), "y": _x(2, 3, 4, 3, seed=1)}, ["x"]),
    "crop_offsets_tensor": (
        lambda f, v: f.layers.crop(v["x"], shape=[1, 2, 3, 3],
                                   offsets=v["o"]),
        {"x": _x(2, 3, 6, 6), "o": np.asarray([1, 1, 2, 3], "int32")},
        ["x"]),
    "pad_constant_like": (
        lambda f, v: f.layers.pad_constant_like(v["x"], v["y"],
                                                pad_value=1.5),
        {"x": _x(3, 4, 5), "y": _x(2, 3, 5, seed=1)}, ["y"]),
    "maxout": (
        lambda f, v: f.layers.maxout(v["x"], groups=3),
        {"x": _x(2, 6, 4, 4)}, ["x"]),
    "lrn": (
        lambda f, v: f.layers.lrn(v["x"], n=5, k=1.0, alpha=1e-2,
                                  beta=0.75),
        {"x": _x(2, 7, 3, 3)}, ["x"]),
    "fsp_matrix": (
        lambda f, v: f.layers.fsp_matrix(v["x"], v["y"]),
        {"x": _x(2, 3, 4, 5), "y": _x(2, 6, 4, 5, seed=1)}, ["x", "y"]),
    "grid_sampler": (
        lambda f, v: f.layers.grid_sampler(v["x"], v["g"]),
        {"x": _x(2, 3, 6, 7),
         "g": np.random.RandomState(4).uniform(
             -1.1, 1.1, (2, 4, 5, 2)).astype("float32")}, ["x", "g"]),
    "affine_grid": (
        lambda f, v: f.layers.affine_grid(v["t"], [2, 3, 5, 6]),
        {"t": _x(2, 2, 3)}, ["t"]),
    "roi_pool": (
        lambda f, v: f.layers.roi_pool(v["x"], v["r"], pooled_height=2,
                                       pooled_width=3, spatial_scale=0.5),
        {"x": _x(2, 3, 12, 12), "r": _rois(2, 5, 20)}, ["x"]),
    "roi_pool_lod": (
        lambda f, v: f.layers.roi_pool(v["x"], v["r"], pooled_height=2,
                                       pooled_width=2, rois_lod=v["l"]),
        {"x": _x(2, 3, 10, 10), "r": _rois(2, 4, 10, batch_col=False),
         "l": np.asarray([0, 1, 1, 0], "int32")}, ["x"]),
    "psroi_pool": (
        lambda f, v: f.layers.psroi_pool(v["x"], v["r"], output_channels=2,
                                         spatial_scale=0.5, pooled_height=2,
                                         pooled_width=2),
        {"x": _x(2, 8, 10, 10), "r": _rois(2, 4, 20)}, ["x"]),
    "unfold": (
        lambda f, v: f.layers.unfold(v["x"], [3, 2], strides=[2, 1],
                                     paddings=[1, 0, 1, 1],
                                     dilations=[1, 2]),
        {"x": _x(2, 3, 7, 6)}, ["x"]),
    "deformable_conv": (
        lambda f, v: f.layers.deformable_conv(
            v["x"], _offset_conv(f, v["x"], 4), v["m"], num_filters=3,
            filter_size=2),
        {"x": _x(1, 4, 5, 5), "m": np.random.RandomState(5).uniform(
            0, 1, (1, 4, 4, 4)).astype("float32")}, ["x", "m"]),
    "deformable_conv_groups": (
        lambda f, v: f.layers.deformable_conv(
            v["x"], v["o"], None, num_filters=4, filter_size=[2, 2],
            stride=2, padding=1, groups=2, deformable_groups=2,
            modulated=False),
        {"x": _x(1, 4, 5, 5), "o": np.random.RandomState(6).uniform(
            -1.3, 1.3, (1, 16, 3, 3)).astype("float32")}, ["x", "o"]),
    "deformable_roi_pooling": (
        lambda f, v: f.layers.deformable_roi_pooling(
            v["x"], v["r"], v["t"], spatial_scale=0.5, pooled_height=1,
            pooled_width=2, sample_per_part=2, trans_std=0.1),
        {"x": _x(2, 12, 9, 9), "r": _rois(2, 3, 16),
         "t": _x(3, 2, 1, 2, seed=8)}, ["x", "t"]),
    "deformable_roi_pooling_plain": (
        lambda f, v: f.layers.deformable_roi_pooling(
            v["x"], v["r"], None, no_trans=True, pooled_height=2,
            pooled_width=1, sample_per_part=1, position_sensitive=False),
        {"x": _x(1, 3, 8, 8), "r": _rois(1, 2, 8)}, ["x"]),
    "pool3d_max": (
        lambda f, v: f.layers.pool3d(v["x"], pool_size=2, pool_stride=2),
        {"x": _x(2, 3, 4, 6, 6)}, ["x"]),
    "pool3d_avg_padded": (
        lambda f, v: f.layers.pool3d(v["x"], pool_size=3, pool_type="avg",
                                     pool_stride=2, pool_padding=1),
        {"x": _x(2, 3, 5, 6, 5)}, ["x"]),
    "pool3d_global": (
        lambda f, v: f.layers.pool3d(v["x"], pool_type="avg",
                                     global_pooling=True),
        {"x": _x(2, 3, 3, 4, 4)}, ["x"]),
    "conv2d_transpose": (
        lambda f, v: f.layers.conv2d_transpose(
            v["x"], num_filters=6, filter_size=3, stride=2, padding=1,
            groups=2, act="relu"),
        {"x": _x(2, 4, 5, 5)}, ["x"]),
    "conv3d": (
        lambda f, v: f.layers.conv3d(v["x"], num_filters=4, filter_size=3,
                                     padding=1, groups=2),
        {"x": _x(1, 4, 4, 5, 5)}, ["x"]),
    "conv3d_transpose": (
        lambda f, v: f.layers.conv3d_transpose(v["x"], num_filters=3,
                                               filter_size=2, stride=2),
        {"x": _x(1, 2, 3, 3, 3)}, ["x"]),
    "group_norm": (
        lambda f, v: f.layers.group_norm(v["x"], groups=2, act="relu"),
        {"x": _x(2, 6, 4, 4)}, ["x"]),
    "resize_bilinear_aligned": (
        lambda f, v: f.layers.resize_bilinear(v["x"], out_shape=[9, 7]),
        {"x": _x(2, 3, 5, 4)}, ["x"]),
    "resize_bilinear_half_pixel": (
        lambda f, v: f.layers.resize_bilinear(
            v["x"], out_shape=[3, 8], align_corners=False, align_mode=0),
        {"x": _x(2, 3, 5, 4)}, ["x"]),
    "resize_bilinear_scale": (
        lambda f, v: f.layers.image_resize(v["x"], scale=1.5,
                                           align_corners=False),
        {"x": _x(1, 2, 4, 6)}, ["x"]),
    "resize_nearest": (
        lambda f, v: f.layers.resize_nearest(v["x"], out_shape=[7, 3]),
        {"x": _x(2, 3, 5, 4)}, ["x"]),
    "resize_nearest_unaligned": (
        lambda f, v: f.layers.resize_nearest(v["x"], out_shape=[8, 9],
                                             align_corners=False),
        {"x": _x(2, 3, 5, 4)}, ["x"]),
    "image_resize_short": (
        lambda f, v: f.layers.image_resize_short(v["x"], 6),
        {"x": _x(1, 3, 4, 7)}, ["x"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_reference(case):
    build, feeds, grads = CASES[case]
    _compare(build, feeds, grads)


@pytest.mark.parametrize("ptype", ["sum", "average", "sqrt", "max", "last",
                                   "first"])
@pytest.mark.parametrize("with_len", [True, False], ids=["len", "full"])
def test_sequence_pool_matches_reference(ptype, with_len):
    feeds = {"x": _x(3, 5, 4)}
    if with_len:
        feeds["n"] = np.asarray([5, 2, 1], "int64")

    def build(f, v):
        return f.layers.sequence_pool(v["x"], ptype,
                                      seq_len=v.get("n"))
    _compare(build, feeds, ["x"])


def test_random_crop_takes_a_window_of_the_attr_shape():
    x = _x(3, 2, 8, 9)
    outs = []
    for fluid in (jfluid, tfluid):
        out, _g, _p = _run(fluid, lambda f, v: f.layers.random_crop(
            v["x"], [5, 6]), {"x": x}, [])
        outs.append(out)
    for out in outs:
        assert out.shape == (3, 2, 5, 6)
        hits = [(i, j) for i in range(4) for j in range(4)
                if np.array_equal(out, x[:, :, i:i + 5, j:j + 6])]
        assert len(hits) == 1


def test_random_crop_draws_from_its_seed_input():
    import torch
    from paddle_tpu_torch.ops import registry

    op = registry.get_op_def("random_crop")
    ctx = registry.LoweringContext()
    x = torch.arange(400, dtype=torch.float32).reshape(1, 20, 20)
    draws = []
    for seed in (1, 1, 2):
        res = registry.call_op(op, ctx, {"X": [x], "Seed": [
            torch.tensor([seed])]}, {"shape": [4, 4]})
        draws.append(res["Out"][0][0, 0, 0].item())
    assert draws[0] == draws[1]
    assert not op.is_capturable({"shape": [4, 4]}, {"X": ["x"]})


def test_auc_matches_reference():
    rng = np.random.RandomState(0)
    batches = [(rng.uniform(0, 1, (16, 1)).astype("float32"),
                rng.randint(0, 2, (16, 1)).astype("int64"))
               for _ in range(3)]
    results = []
    for fluid in (jfluid, tfluid):
        fluid.unique_name.switch()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            p = fluid.layers.data("p", shape=[1], dtype="float32")
            y = fluid.layers.data("y", shape=[1], dtype="int64")
            prob = fluid.layers.concat(
                [fluid.layers.scale(p, scale=-1.0, bias=1.0), p], axis=1)
            g, b, stats = fluid.layers.auc(prob, y, num_thresholds=63,
                                           slide_steps=2)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = JScope() if fluid is jfluid else Scope()
        exe.run(startup, scope=scope)
        run = [exe.run(main, feed={"p": pv, "y": yv},
                       fetch_list=[g, b] + stats, scope=scope)
               for pv, yv in batches]
        results.append(run)
    for ref_step, step in zip(*results):
        for ref, got in zip(ref_step, step):
            _close(got, ref, FWD_TOL, "auc")
