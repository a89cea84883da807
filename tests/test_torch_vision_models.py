"""The rest of the vision stack of the PyTorch port against the reference:
SE-ResNeXt and VGG-16 training, VGG's layouts and fusion report, the
ResNet serving path (the NHWC conv + batch_norm fold through the
predictor) and the export round trips of the layer layouts this slice
adds.

* Compact SE-ResNeXt (the builder's defaults at 32x32) and VGG-16 at
  cifar10 size take one step in both packages from the reference's
  parameters: the loss and every persistable after the step (parameters,
  batch_norm's running statistics, the optimizer's accumulators) within
  1e-5 of the largest magnitude, but where Adam's first step takes the
  sign of a gradient within rounding of 0 (the test's docstring says
  what is held there instead).  Both builders drop out (0.2 and 0.5);
  the packages draw different masks, so the test sets each dropout op's
  rate to 0 in both programs.
* VGG-16 in NCHW and NHWC gives the same loss (the reference's
  ``test_vgg_nhwc_layout_parity``), and both packages' fusion passes
  give the same report: ``img_conv_group`` gives every conv a bias, so
  no conv → batch_norm site fuses in either.
* ``resnet_cifar10`` depth 8, NHWC, exported by the reference and served
  by the port's predictor: no batch_norm is left after the fold, and the
  output equals the reference predictor's within 1e-4 (the reference's
  own tolerance for the fold); a group-norm + resize net exported by the
  port reloads and reproduces its outputs, and the reference's.
* Grouped, 3-D, transposed and deformable layers' filters cross from
  the reference's export to the port and back (``convert``).
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import scope_guard as j_scope_guard
from paddle_tpu.inference import AnalysisConfig as JAnalysisConfig
from paddle_tpu.inference import create_paddle_predictor as j_create
from paddle_tpu.models import resnet as j_resnet
from paddle_tpu.models import se_resnext as j_se_resnext
from paddle_tpu.models import vgg as j_vgg
from paddle_tpu.static_analysis import fusion as j_fusion

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.convert import (load_params_into_scope,
                                      read_exported_params,
                                      scope_persistables)
from paddle_tpu_torch.executor import Scope, scope_guard
from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
from paddle_tpu_torch.models import se_resnext as t_se_resnext
from paddle_tpu_torch.models import vgg as t_vgg
from paddle_tpu_torch.static_analysis import fusion as t_fusion

TOL = 1e-5
GRAD_TOL = 1e-4


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if not got.size:
        return
    err = float(np.abs(got - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), (what, err)


def _no_dropout(program):
    for op in program.global_block().ops:
        if op.type in ("dropout", "dropout_grad"):
            op.attrs["dropout_prob"] = 0.0


def _model(pkg, name):
    return {("ref", "se_resnext"): j_se_resnext,
            ("port", "se_resnext"): t_se_resnext,
            ("ref", "vgg"): j_vgg, ("port", "vgg"): t_vgg}[(pkg, name)]


def _one_step(pkg, name, feed, state=None, **kw):
    fluid = jfluid if pkg == "ref" else tfluid
    fluid.unique_name.switch()
    main, startup, _feeds, loss, _acc = _model(pkg, name).build(**kw)
    _no_dropout(main)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = JScope() if pkg == "ref" else Scope()
    exe.run(startup, scope=scope)
    if state is not None:
        load_params_into_scope(state, scope, program=main)
    before = scope_persistables(main, scope)
    (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    return float(np.asarray(lv).reshape(())), before, \
        scope_persistables(main, scope)


def _image_batch(n, shape, classes, seed=0):
    rng = np.random.RandomState(seed)
    return {"img": rng.randn(n, *shape).astype("float32"),
            "label": rng.randint(0, classes, (n, 1)).astype("int64")}


def _pre_bn_biases(program):
    """The parameters added by an ``elementwise_add`` whose output only a
    batch_norm reads (forward ops)."""
    ops = [op for op in program.global_block().ops
           if not op.type.endswith("_grad")]
    readers = {}
    for op in ops:
        for n in op.input_arg_names:
            readers.setdefault(n, []).append(op)
    out = set()
    for p in program.all_parameters():
        for op in readers.get(p.name, []):
            nxt = readers.get(op.output("Out")[0], []) \
                if op.type == "elementwise_add" else []
            if nxt and all(o.type == "batch_norm" for o in nxt):
                out.add(p.name)
    return out


@pytest.mark.parametrize("name,kw,shape,lr", [
    ("se_resnext", {}, (3, 32, 32), 1e-2),
    ("vgg", {"dataset": "cifar10"}, (3, 32, 32), 1e-3),
])
def test_first_step_matches_reference(name, kw, shape, lr):
    """One step from the same state: the loss within 1e-5, and every
    persistable after the step within 1e-5 (SE-ResNeXt, Momentum).

    VGG trains with Adam, whose first step is ``lr * g / (|g| + eps)``:
    the sign of the gradient, however small.  Its moments are functions
    of the gradient (``0.1 g``, ``0.001 g²``) and are held to the
    gradients' 1e-4; a parameter element steps as the reference's within
    1e-5 where its gradient exceeds 1e-4 of the parameter's largest (its
    sign is then the same in both packages), else by at most ``lr``.
    The conv and fc biases before a batch_norm have a gradient of 0 in
    exact arithmetic (the normalisation removes the mean): their
    gradients must be below 1e-5 and their steps at most ``lr``."""
    feed = _image_batch(4, shape, 10)
    ref_loss, ref_before, ref_after = _one_step("ref", name, feed, **kw)
    loss, before, after = _one_step("port", name, feed, state=ref_before,
                                    **kw)
    assert np.isfinite(loss)
    _close(loss, ref_loss, TOL, "loss")
    assert set(after) == set(ref_after)
    tfluid.unique_name.switch()
    zero_grad = _pre_bn_biases(_model("port", name).build(**kw)[0])
    assert bool(zero_grad) == (name == "vgg")

    def steps_within_lr(var, mask):
        for side, start in ((after, before), (ref_after, ref_before)):
            step = np.abs(side[var] - start[var])[mask]
            assert not step.size or step.max() <= lr * (1 + 1e-6), var

    moved = 0
    for var in after:
        moved += not np.array_equal(after[var], before[var])
        if "_adam_moment" in var:
            _close(after[var], ref_after[var], GRAD_TOL, var)
            continue
        got, ref = after[var], ref_after[var]
        m1 = var + "_adam_moment1_0"
        if m1 in ref_after:
            g_ref = ref_after[m1] / 0.1
            if var in zero_grad:
                for g in (g_ref, after[m1] / 0.1):
                    assert np.abs(g).max() <= 1e-5, var
                steps_within_lr(var, np.ones(g_ref.shape, bool))
                continue
            sure = np.abs(g_ref) >= GRAD_TOL * np.abs(g_ref).max()
            steps_within_lr(var, ~sure)
            got, ref = got[sure], ref[sure]
        _close(got, ref, TOL, var)
    assert moved > len(after) // 2


def _test_loss(pkg, data_format, feed, params=None):
    fluid = jfluid if pkg == "ref" else tfluid
    fluid.unique_name.switch()
    main, startup, _f, loss, _a = _model(pkg, "vgg").build(
        dataset="cifar10", data_format=data_format)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = JScope() if pkg == "ref" else Scope()
    exe.run(startup, scope=scope)
    if params is not None:
        load_params_into_scope(params, scope, program=main)
    test = main.clone(for_test=True)
    (lv,) = exe.run(test, feed=feed, fetch_list=[loss], scope=scope)
    return float(np.asarray(lv).reshape(())), \
        {p.name: np.asarray(scope.get(p.name))
         for p in main.all_parameters()}


def test_vgg_nhwc_layout_parity():
    """The same parameters on the transposed input give the same loss:
    after five pool-by-2 stages the head flattens a [*, 1, 1, 512]
    tensor, so the fc weights read the same order in both layouts."""
    feed = _image_batch(4, (3, 32, 32), 10)
    nchw, params = _test_loss("port", "NCHW", feed)
    nhwc, _ = _test_loss("port", "NHWC", {
        "img": feed["img"].transpose(0, 2, 3, 1), "label": feed["label"]},
        params=params)
    np.testing.assert_allclose(nhwc, nchw, rtol=1e-4, atol=1e-5)


def _fusion_summary(report):
    return (sorted(report.counts().items()),
            sorted((s.family, s.op_idx, s.op_type) for s in report.skipped))


@pytest.mark.parametrize("name,kw", [
    ("vgg", {"dataset": "cifar10", "data_format": "NHWC"}),
    ("vgg", {"dataset": "cifar10"}),
    ("se_resnext", {}),
])
def test_fusion_reports_match_reference(name, kw):
    reports, left = [], []
    for pkg, fluid, fusion in (("ref", jfluid, j_fusion),
                               ("port", tfluid, t_fusion)):
        fluid.unique_name.switch()
        main, _s, _f, loss, acc = _model(pkg, name).build(**kw)
        resolved, report = fusion.resolve_fused_program(
            main, targets=[loss.name, acc.name])
        reports.append(report)
        left.append([op.type for op in resolved.global_block().ops
                     ].count("batch_norm"))
    assert _fusion_summary(reports[1]) == _fusion_summary(reports[0])
    assert left[1] == left[0]
    conv_bn = reports[1].counts().get("conv_bn_act", 0)
    if name == "vgg":
        # each conv has a bias: batch_norm is not its output's only
        # reader, so every batch_norm stays (13 conv sites and the head's)
        assert conv_bn == 0 and left[1] == 14
    else:
        assert conv_bn > 0 and left[1] == 0


def _export_resnet(d):
    jfluid.unique_name.switch()
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        img = jfluid.layers.data("img", shape=[32, 32, 3], dtype="float32")
        logits = j_resnet.resnet_cifar10(img, 10, 8, is_test=True,
                                         data_format="NHWC")
    exe = jfluid.Executor(jfluid.CPUPlace())
    with j_scope_guard(JScope()):
        exe.run(startup)
        # non-trivial running statistics, so the fold has work to do
        scope = jfluid.global_scope()
        rng = np.random.RandomState(1)
        for v in main.list_vars():
            if v.persistable and ("w_1" in v.name or "w_2" in v.name):
                arr = np.asarray(scope.get(v.name))
                scope.set(v.name, (rng.uniform(0.5, 1.5, arr.shape)
                                   if "w_2" in v.name else
                                   rng.randn(*arr.shape) * 0.1
                                   ).astype("float32"))
        jfluid.io.save_inference_model(d, ["img"], [logits], exe,
                                       main_program=main)


def test_nhwc_conv_bn_fold_serves_like_the_reference(tmp_path):
    d = str(tmp_path / "resnet8")
    _export_resnet(d)
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype("float32")
    jpred = j_create(JAnalysisConfig(d))
    (ref,) = jpred.run([x])
    cfg = AnalysisConfig(d)
    cfg.disable_gpu()
    pred = create_paddle_predictor(cfg)
    ops = [op.type for op in pred.program.global_block().ops]
    ref_ops = [op.type for op in jpred.program.global_block().ops]
    assert ops.count("batch_norm") == 0, "NHWC fold did not fire"
    assert ops == ref_ops
    (got,) = pred.run([x])
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-5)
    # the unfolded program on the port agrees too
    exe = tfluid.Executor(tfluid.CPUPlace())
    with scope_guard(Scope()):
        prog, feeds, fetches = tfluid.io.load_inference_model(d, exe)
        (direct,) = exe.run(prog, feed={feeds[0]: x}, fetch_list=fetches)
    np.testing.assert_allclose(got, direct, rtol=1e-4, atol=1e-5)


def _gn_resize_net(fluid):
    fluid.unique_name.switch()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[3, 8, 8], dtype="float32")
        up = fluid.layers.resize_bilinear(img, out_shape=[16, 16])
        conv = fluid.layers.conv2d(up, 4, 3, padding=1)
        gn = fluid.layers.group_norm(conv, groups=2, act="relu")
        pool = fluid.layers.pool2d(gn, 2, global_pooling=True)
        out = fluid.layers.fc(pool, size=3)
    return main, startup, out


def test_gn_resize_model_inference_roundtrip(tmp_path):
    xv = np.random.RandomState(0).randn(2, 3, 8, 8).astype("float32")
    main, startup, out = _gn_resize_net(jfluid)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with j_scope_guard(JScope()):
        jexe.run(startup)
        (ref,) = jexe.run(main, feed={"img": xv}, fetch_list=[out])
        params = {p.name: np.asarray(jfluid.global_scope().get(p.name))
                  for p in main.all_parameters()}
    main, startup, out = _gn_resize_net(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    d = str(tmp_path / "gn_model")
    scope = Scope()
    with scope_guard(scope):
        exe.run(startup)
        load_params_into_scope(params, scope, program=main)
        (direct,) = exe.run(main, feed={"img": xv}, fetch_list=[out])
        tfluid.io.save_inference_model(d, ["img"], [out], exe,
                                       main_program=main)
    _close(direct, ref, TOL, "direct")
    with scope_guard(Scope()):
        prog, feeds, fetches = tfluid.io.load_inference_model(d, exe)
        (loaded,) = exe.run(prog, feed={feeds[0]: xv}, fetch_list=fetches)
    np.testing.assert_allclose(loaded, direct, rtol=1e-5)
    cfg = AnalysisConfig(d)
    cfg.disable_gpu()
    (pred_out,) = create_paddle_predictor(cfg).run({"img": xv})
    np.testing.assert_allclose(np.asarray(pred_out), direct, rtol=1e-4,
                               atol=1e-5)
    # the reference serves the port's export
    (jout,) = j_create(JAnalysisConfig(d)).run({"img": xv})
    np.testing.assert_allclose(np.asarray(jout), direct, rtol=1e-4,
                               atol=1e-5)


LAYOUTS = {
    "grouped_conv2d": (
        [4, 6, 6], lambda f, x: f.layers.conv2d(x, 6, 3, padding=1,
                                                groups=2)),
    "conv3d": (
        [2, 3, 4, 4], lambda f, x: f.layers.conv3d(x, 3, [2, 3, 3],
                                                   padding=1)),
    "conv2d_transpose": (
        [4, 5, 5], lambda f, x: f.layers.conv2d_transpose(
            x, 6, filter_size=3, stride=2, groups=2)),
    "conv3d_transpose": (
        [2, 3, 3, 3], lambda f, x: f.layers.conv3d_transpose(
            x, 3, filter_size=[2, 2, 3], stride=2)),
    "deformable_conv": (
        [3, 5, 5], lambda f, x: f.layers.deformable_conv(
            x, f.layers.conv2d(x, 2 * 9, 3, padding=1),
            f.layers.sigmoid(f.layers.conv2d(x, 9, 3, padding=1)),
            num_filters=4, filter_size=3, padding=1)),
}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_layer_filters_cross_between_the_packages(case, tmp_path):
    """The reference exports the layer; the port reads its parameter
    files (``convert.read_exported_params``), loads the program and
    reproduces the output; the port's re-export serves in the
    reference."""
    shape, build = LAYOUTS[case]
    x = np.random.RandomState(2).randn(2, *shape).astype("float32")
    progs = {}
    for fluid in (jfluid, tfluid):
        fluid.unique_name.switch()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            inp = fluid.layers.data("x", shape=shape, dtype="float32")
            progs[fluid] = (main, startup, build(fluid, inp))
    jmain, jstart, jout = progs[jfluid]
    d_ref = str(tmp_path / "ref")
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with j_scope_guard(JScope()):
        jexe.run(jstart)
        (ref,) = jexe.run(jmain, feed={"x": x}, fetch_list=[jout])
        jfluid.io.save_inference_model(d_ref, ["x"], [jout], jexe,
                                       main_program=jmain)
    params = read_exported_params(d_ref)
    tmain = progs[tfluid][0]
    assert set(params) == {p.name for p in tmain.all_parameters()}
    for p in tmain.all_parameters():
        assert params[p.name].shape == tuple(p.shape), p.name
    exe = tfluid.Executor(tfluid.CPUPlace())
    d_port = str(tmp_path / "port")
    with scope_guard(Scope()):
        prog, feeds, fetches = tfluid.io.load_inference_model(d_ref, exe)
        (got,) = exe.run(prog, feed={feeds[0]: x}, fetch_list=fetches)
        tfluid.io.save_inference_model(d_port, feeds, fetches, exe,
                                       main_program=prog)
    _close(got, ref, TOL, case)
    with j_scope_guard(JScope()):
        prog, feeds, fetches = jfluid.io.load_inference_model(d_port, jexe)
        (back,) = jexe.run(prog, feed={feeds[0]: x}, fetch_list=fetches)
    _close(back, ref, TOL, case + " back")
    for name, arr in read_exported_params(d_port).items():
        np.testing.assert_array_equal(arr, params[name])
