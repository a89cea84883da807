"""The dygraph mode of the PyTorch port against the reference package on
the CPU: the tape's semantics, guards and devices, the optimizers' eager
paths with decay, clips and the eight learning-rate schedules,
``Optimizer.load``, checkpoints across the packages, and a ResNet-18 of
dygraph layers against the port's static NCHW program.

Each scenario runs the same code in both packages (the reference under
``dygraph.guard()``, the port under ``guard(CPUPlace())``) from the same
weights, carried over with ``convert.load_layer_state``.  Tolerance:
float32 through a small MLP and 3 updates, ``RTOL`` 1e-5 / ``ATOL`` 1e-6
(the gradients' rounding differs by the order of a few sums); the
ResNet-18 against the static program, the same ops on the same device,
``RESNET_RTOL`` 1e-5 of each tensor's largest value; checkpoints bit for
bit."""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.dygraph.varbase import eager_op as j_eager_op

import chip_smoke
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.dygraph.varbase import eager_op as t_eager_op

RTOL, ATOL = 1e-5, 1e-6
RESNET_RTOL = 1e-5
STEPS = 3


def _guard(fluid):
    if fluid is tfluid:
        return tfluid.dygraph.guard(tfluid.CPUPlace())
    return jfluid.dygraph.guard()


def _eager(fluid):
    return t_eager_op if fluid is tfluid else j_eager_op


def _both(fn):
    """``fn(fluid, eager_op)`` under each package's guard → (reference's,
    port's)."""
    out = []
    for fluid in (jfluid, tfluid):
        with _guard(fluid):
            out.append(fn(fluid, _eager(fluid)))
    return out


# ---- the tape ----

def _x(fluid, value=None):
    v = fluid.dygraph.to_variable(
        np.array([[1.0, -2.0], [3.0, 0.5]], "float32")
        if value is None else value)
    v.stop_gradient = False
    return v


def test_intermediate_gradients_match_the_reference():
    def run(fluid, eager):
        x = _x(fluid)
        y = x * x
        z = y * 3.0 + x
        loss = eager("mean", {"X": [z]})[0]
        loss.backward()
        return [v.gradient() for v in (x, y, z, loss)]

    ref, port = _both(run)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_gradients_add_up_until_cleared_and_retain_graph():
    """``retain_graph`` keeps the tape for a second backward (gradients
    add up); without it the tape is cleared, and a second backward
    reaches only the root; ``clear_gradient`` drops a gradient."""
    def run(fluid, eager):
        x = _x(fluid)
        loss = eager("mean", {"X": [x * x]})[0]
        loss.backward(retain_graph=True)
        once = x.gradient()
        loss.backward()
        twice = x.gradient()
        loss.backward()  # the tape is empty: only the root moves
        out = [once, twice, x.gradient(), loss.gradient()]
        x.clear_gradient()
        out.append(x.gradient())
        return out

    ref, port = _both(run)
    np.testing.assert_allclose(port[1], 2 * port[0], rtol=RTOL)
    np.testing.assert_allclose(port[2], port[1], rtol=RTOL)
    np.testing.assert_allclose(port[3], [3.0])
    assert port[4] is None and ref[4] is None
    for a, b in zip(port[:4], ref[:4]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_no_grad_stops_recording_while_ops_run():
    def run(fluid, eager):
        x = _x(fluid)
        with fluid.dygraph.no_grad():
            y = x * 3.0
        z = y * 2.0 + x
        loss = eager("mean", {"X": [z]})[0]
        loss.backward()
        return [y.numpy(), x.gradient(), y.gradient()]

    ref, port = _both(run)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port[1], 0.25)  # only through z's "+ x"


def test_stop_gradient_defaults_and_effect():
    """``to_variable`` gives ``stop_gradient=True``, op outputs False; an
    input left stopping takes no gradient, and a parameter does."""
    def run(fluid, eager):
        a = fluid.dygraph.to_variable(np.ones((2, 3), "float32"))
        lin = fluid.dygraph.Linear(3, 2)
        out = lin(a)
        loss = eager("mean", {"X": [out]})[0]
        loss.backward()
        return [a.stop_gradient, out.stop_gradient, a.gradient() is None,
                lin.weight.gradient() is not None]

    ref, port = _both(run)
    assert port == ref == [True, False, True, True]


def test_backward_outside_a_guard_raises():
    with tfluid.dygraph.guard(tfluid.CPUPlace()):
        x = _x(tfluid)
        loss = t_eager_op("mean", {"X": [x]})[0]
    with pytest.raises(RuntimeError, match="guard"):
        loss.backward()


# ---- guards and devices ----

@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_guard_defaults_to_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="CUDAPlace"):
        with tfluid.dygraph.guard():
            pass
    assert not tfluid.in_dygraph_mode()
    with pytest.raises(RuntimeError, match="CUDAPlace"):
        tfluid.dygraph.Linear(2, 2)  # outside any guard: the card
    with tfluid.dygraph.guard(tfluid.CPUPlace()):
        lin = tfluid.dygraph.Linear(2, 2)
        assert lin.weight.value.device.type == "cpu"


def test_nested_guards_compose():
    assert not tfluid.in_dygraph_mode()
    with tfluid.dygraph.guard(tfluid.CPUPlace()):
        outer = tfluid.framework._dygraph_tracer()
        with tfluid.dygraph.guard(tfluid.CPUPlace()):
            assert tfluid.framework._dygraph_tracer() is not outer
            assert tfluid.dygraph.enabled()
        assert tfluid.framework._dygraph_tracer() is outer
    assert not tfluid.in_dygraph_mode()
    with pytest.raises(RuntimeError, match="dygraph mode"):
        tfluid.dygraph.to_variable(np.ones(2, "float32"))


def test_layer_api_matches_the_reference():
    """``add_parameter``'s ``TypeError``, ``Layer.backward``'s
    ``ValueError``, ``state_dict`` keys (batch norm's running statistics
    included) and parameter names from ``unique_name``."""
    def run(fluid, eager):
        dg = fluid.dygraph
        layer = dg.Layer()
        with pytest.raises(TypeError):
            layer.add_parameter("w", dg.to_variable(np.ones(2, "float32")))
        with pytest.raises(ValueError):
            layer.backward()
        layer.add_sublayer("bn", dg.BatchNorm(3))
        layer.add_sublayer("fc", dg.Linear(3, 2))
        with fluid.unique_name.guard():
            names = [dg.Linear(2, 2).weight.name for _ in range(2)]
        return list(layer.state_dict()), len(layer.parameters()), names

    ref, port = _both(run)
    assert port == ref
    assert port[0] == ["bn.weight", "bn.bias", "bn._mean", "bn._variance",
                       "fc.weight", "fc.bias"]


# ---- the optimizers' eager paths ----

def _net(fluid):
    """12 → 16 (relu) → 4, in package ``fluid``."""
    return chip_smoke.dygraph_mlp(fluid.dygraph)


def _batches():
    rng = np.random.RandomState(3)
    return [(chip_smoke._randn(rng, 8, 12), chip_smoke._randn(rng, 8, 4))
            for _ in range(STEPS)]


SCHEDULES = {
    "float": lambda dg: 0.05,
    "PiecewiseDecay": lambda dg: dg.PiecewiseDecay([1, 2],
                                                   [0.05, 0.03, 0.01], 0),
    "NaturalExpDecay": lambda dg: dg.NaturalExpDecay(0.05, 2, 0.5, True),
    "ExponentialDecay": lambda dg: dg.ExponentialDecay(0.05, 2, 0.5),
    "InverseTimeDecay": lambda dg: dg.InverseTimeDecay(0.05, 1, 0.5),
    "PolynomialDecay": lambda dg: dg.PolynomialDecay(
        0.05, 2, end_learning_rate=0.01, power=2.0, cycle=True),
    "CosineDecay": lambda dg: dg.CosineDecay(0.05, 1, 4),
    "NoamDecay": lambda dg: dg.NoamDecay(16, 2),
}
OPTIMIZERS = {
    "SGD": lambda f, lr, reg: f.optimizer.SGD(lr, regularization=reg),
    "Momentum": lambda f, lr, reg: f.optimizer.Momentum(
        lr, 0.9, use_nesterov=True, regularization=reg),
    "Adam": lambda f, lr, reg: f.optimizer.Adam(lr, regularization=reg),
    # the reference's Lamb and DGCMomentum take Adam's and Momentum's
    # eager updates (their subclasses' dygraph paths)
    "Lamb": lambda f, lr, reg: f.optimizer.Lamb(lr, regularization=reg),
    "DGCMomentum": lambda f, lr, reg: f.optimizer.DGCMomentumOptimizer(
        lr, 0.9, regularization=reg),
}
REGS = {None: lambda f: None,
        "L1": lambda f: f.regularizer.L1Decay(1e-2),
        "L2": lambda f: f.regularizer.L2Decay(1e-2)}
CLIPS = {None: lambda f: None,
         "value": lambda f: f.dygraph_grad_clip.GradClipByValue(0.05),
         "norm": lambda f: f.dygraph_grad_clip.GradClipByNorm(0.2),
         "global_norm": lambda f: f.clip.GradientClipByGlobalNorm(0.3)}


def _train(fluid, opt_name, schedule, reg, clip, net=None, batches=None,
           opt=None):
    """``chip_smoke.dygraph_train`` over ``batches`` (default: all of
    ``_batches()``) → (losses, state dict, eager optimizer state by
    parameter position, model, optimizer, the gradients each parameter's
    updates consumed)."""
    import warnings

    dg = fluid.dygraph
    with _guard(fluid):
        model = net if net is not None else _net(fluid)
        if opt is None:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # DGCMomentum's
                opt = OPTIMIZERS[opt_name](fluid, SCHEDULES[schedule](dg),
                                           REGS[reg](fluid))
        params = model.parameters()
    losses, consumed = chip_smoke.dygraph_train(
        dg, _guard(fluid), model, opt, CLIPS[clip](fluid),
        _batches() if batches is None else batches)
    st = getattr(opt, "_eager_state", {})
    accs = [{k: np.array(v.detach().cpu() if isinstance(v, torch.Tensor)
                         else v) for k, v in st.get(p.name, {}).items()}
            for p in params]
    return (losses, model.state_dict(), accs, model, opt,
            [consumed.get(p.name, []) for p in params])


def _pair(opt_name, schedule="float", reg=None, clip=None):
    with jfluid.dygraph.guard():
        ref_net = _net(jfluid)
    with tfluid.dygraph.guard(tfluid.CPUPlace()):
        port_net = _net(tfluid)
    convert.load_layer_state(port_net, ref_net)
    start = port_net.state_dict()
    return (start, _train(jfluid, opt_name, schedule, reg, clip, ref_net),
            _train(tfluid, opt_name, schedule, reg, clip, port_net))


# Adam's step divides the gradient by a running norm of itself, so an
# element whose gradient is rounding noise may step differently in the
# two packages: its parameters also get what the two sides' consumed
# gradients explain (chip_smoke.rule_parity_tol with Adam's bound, one
# learning rate a step, at most the schedules' 0.05)
NORMALIZING = ("Adam", "Lamb")


def _assert_same(ref, port, start=None, opt_name=None):
    np.testing.assert_allclose(port[0], ref[0], rtol=RTOL, atol=ATOL)
    assert list(port[1]) == list(ref[1])
    for i, k in enumerate(ref[1]):
        a, b = port[1][k].astype("float64"), ref[1][k].astype("float64")
        bound = ATOL + RTOL * np.abs(b)
        if opt_name in NORMALIZING:
            bound = bound + chip_smoke.rule_parity_tol(
                "adamw", 0.05, start[k], port[5][i], ref[5][i], 0.0)
        assert np.all(np.abs(a - b) <= bound), (k, float(np.max(
            np.abs(a - b) - bound)))
    for a, b in zip(port[2], ref[2]):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_allclose(a[k].reshape(b[k].shape), b[k],
                                       rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("reg,clip", [(None, None), ("L1", None),
                                      ("L2", None), ("L2", "value"),
                                      ("L2", "norm"), ("L1", "global_norm")])
@pytest.mark.parametrize("opt_name", ["SGD", "Momentum", "Adam"])
def test_three_steps_with_decay_and_clips_match_the_reference(opt_name, reg,
                                                              clip):
    start, ref, port = _pair(opt_name, reg=reg, clip=clip)
    _assert_same(ref, port, start, opt_name)
    assert port[0][-1] != port[0][0]


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("opt_name", ["SGD", "Momentum", "Adam"])
def test_three_steps_under_each_schedule_match_the_reference(opt_name,
                                                             schedule):
    start, ref, port = _pair(opt_name, schedule=schedule, reg="L2")
    _assert_same(ref, port, start, opt_name)


@pytest.mark.parametrize("opt_name", ["Lamb", "DGCMomentum"])
def test_subclasses_take_their_bases_eager_update_as_the_reference(
        opt_name):
    start, ref, port = _pair(opt_name, schedule="ExponentialDecay")
    _assert_same(ref, port, start, opt_name)


def test_the_schedule_steps_once_a_minimize():
    """Every parameter of a step sees that step's rate, and the schedule
    moves once a ``minimize`` (not once a parameter)."""
    dec = tfluid.dygraph.ExponentialDecay(0.1, decay_steps=1,
                                          decay_rate=0.5)
    with tfluid.dygraph.guard(tfluid.CPUPlace()):
        model = tfluid.dygraph.Linear(3, 1)
        opt = tfluid.optimizer.SGD(learning_rate=dec)
        for want_lr in (0.1, 0.05):
            x = tfluid.dygraph.to_variable(np.ones((2, 3), "float32"))
            loss = t_eager_op("mean", {"X": [model(x)]})[0]
            loss.backward()
            before = [p.numpy() for p in model.parameters()]
            grads = [p.gradient() for p in model.parameters()]
            opt.minimize(loss, parameter_list=model.parameters())
            for b, g, p in zip(before, grads, model.parameters()):
                np.testing.assert_allclose(b - p.numpy(), want_lr * g,
                                           rtol=1e-6)
            model.clear_gradients()
    assert dec.step_num == 2


def test_updates_write_the_parameters_in_place():
    with tfluid.dygraph.guard(tfluid.CPUPlace()):
        model = _net(tfluid)
        tensors = [p.value for p in model.parameters()]
        ptrs = [t.data_ptr() for t in tensors]
    _train(tfluid, "Momentum", "float", "L2", "value", model)
    assert all(p.value is t and t.data_ptr() == q for p, t, q in zip(
        model.parameters(), tensors, ptrs))


@pytest.mark.parametrize("name", ["Adagrad", "DecayedAdagrad", "Adamax",
                                  "Adadelta", "RMSProp", "Ftrl",
                                  "LarsMomentum"])
def test_other_optimizers_raise_as_the_reference(name):
    def run(fluid, eager):
        model = fluid.dygraph.Linear(3, 1)
        cls = getattr(fluid.optimizer, name)
        opt = cls(0.1, 0.9) if name == "LarsMomentum" else cls(0.1)
        x = fluid.dygraph.to_variable(np.ones((2, 3), "float32"))
        loss = eager("mean", {"X": [model(x)]})[0]
        with pytest.raises(NotImplementedError, match="no dygraph update"):
            opt.minimize(loss, parameter_list=model.parameters())
        return True

    assert _both(run) == [True, True]


def test_minimize_without_parameter_list_raises():
    def run(fluid, eager):
        model = fluid.dygraph.Linear(3, 1)
        x = fluid.dygraph.to_variable(np.ones((2, 3), "float32"))
        loss = eager("mean", {"X": [model(x)]})[0]
        with pytest.raises(ValueError, match="parameter_list"):
            fluid.optimizer.SGD(0.1).minimize(loss)
        return True

    assert _both(run) == [True, True]


def test_a_decay_object_on_the_static_path_raises():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[3], dtype="float32")
        loss = tfluid.layers.mean(tfluid.layers.fc(x, size=1))
        with pytest.raises(TypeError, match="dygraph-only"):
            tfluid.optimizer.SGD(tfluid.dygraph.ExponentialDecay(
                0.1, 1, 0.5)).minimize(loss)


def _resumed_adam(fluid):
    """Adam with L2 decay and the PiecewiseDecay schedule begun at step 2
    (a schedule's step is not optimizer state: a resumed run says where
    it starts, as in the reference)."""
    dg = fluid.dygraph
    return fluid.optimizer.Adam(
        dg.PiecewiseDecay([1, 2], [0.05, 0.03, 0.01], begin=2),
        regularization=fluid.regularizer.L2Decay(1e-2))


def test_optimizer_load_restores_a_rebuilt_model(tmp_path):
    """Two steps, a checkpoint of the model (``save_dygraph``) and the
    optimizer's eager state, a model rebuilt in the same order in a fresh
    name scope (so its parameters have the same names) and loaded, one
    more step: bit for bit the uninterrupted run's."""
    path = str(tmp_path / "net")
    batches = _batches()
    with tfluid.unique_name.guard():
        with tfluid.dygraph.guard(tfluid.CPUPlace()):
            net = _net(tfluid)
            init = net.state_dict()
        whole = _train(tfluid, "Adam", "PiecewiseDecay", "L2", None, net)
    with tfluid.unique_name.guard():
        with tfluid.dygraph.guard(tfluid.CPUPlace()):
            net = _net(tfluid)
            net.set_dict(init)
        first = _train(tfluid, "Adam", "PiecewiseDecay", "L2", None, net,
                       batches[:2])
        tfluid.dygraph.save_dygraph(first[1], path)
        saved = {n: {k: v.numpy() for k, v in st.items()}
                 for n, st in first[4]._eager_state.items()}
    with tfluid.unique_name.guard():
        with tfluid.dygraph.guard(tfluid.CPUPlace()):
            rebuilt = _net(tfluid)
            rebuilt.set_dict(tfluid.dygraph.load_dygraph(path)[0])
            opt = _resumed_adam(tfluid)
            opt.load(saved)
        resumed = _train(tfluid, "Adam", None, "L2", None, rebuilt,
                         batches[2:], opt)
    for k, v in whole[1].items():
        np.testing.assert_array_equal(resumed[1][k], v, err_msg=k)
    assert resumed[0] == whole[0][2:]
    with pytest.raises(TypeError):
        opt.load([1])


def test_reference_state_carries_into_the_port():
    """The reference's model and Adam state after two steps, carried by
    ``convert.load_layer_state`` and ``convert.load_optimizer_state``:
    the third step in each package agrees within RTOL."""
    batches = _batches()
    ref = _train(jfluid, "Adam", "PiecewiseDecay", "L2", None,
                 batches=batches[:2])
    start = {k: v.copy() for k, v in ref[1].items()}
    with tfluid.dygraph.guard(tfluid.CPUPlace()):
        net = _net(tfluid)
        convert.load_layer_state(net, ref[3])
        opt = _resumed_adam(tfluid)
        convert.load_optimizer_state(opt, ref[4], ref[3].parameters(),
                                     net.parameters())
    with jfluid.dygraph.guard():
        ref_opt = _resumed_adam(jfluid)
        ref_opt.load(ref[4]._eager_state)
    want = _train(jfluid, "Adam", None, "L2", None, ref[3], batches[2:],
                  ref_opt)
    got = _train(tfluid, "Adam", None, "L2", None, net, batches[2:], opt)
    _assert_same(want, got, start, "Adam")


# ---- checkpoints across the packages ----

def test_checkpoints_load_across_the_packages_bit_for_bit(tmp_path):
    """A ``.pdparams.npz`` saved by either package loads in the other:
    the same keys, dtypes and bits, into a layer of the other package."""
    def make(fluid):
        with _guard(fluid):
            return chip_smoke.dygraph_resnet(18, 10, fluid.dygraph)

    ref, port = make(jfluid), make(tfluid)
    for src, dst, name in ((port, ref, "port"), (ref, port, "ref")):
        saver = tfluid if src is port else jfluid
        loader = jfluid if src is port else tfluid
        path = str(tmp_path / name)
        with _guard(saver):
            state = src.state_dict()
            saver.dygraph.save_dygraph(state, path)
        assert os.path.exists(path + ".pdparams.npz")
        with _guard(loader):
            loaded, opt_state = loader.dygraph.load_dygraph(path)
            assert opt_state is None
            dst.set_dict(loaded)
            back = dst.state_dict()
        assert list(loaded) == list(state) == list(back)
        for k, v in state.items():
            assert loaded[k].dtype == v.dtype == back[k].dtype, k
            assert loaded[k].tobytes() == v.tobytes() == back[k].tobytes(), k


# ---- a ResNet-18 of dygraph layers against the static program ----

def _static_resnet(fluid, depth, hw, class_dim):
    """``models/resnet.resnet_imagenet`` NCHW at ``hw`` x ``hw`` with
    ``build``'s loss and optimizer (Momentum 0.1, 0.9, Nesterov), and the
    for-test clone."""
    from paddle_tpu_torch.models import resnet

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[3, hw, hw], dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        logits = resnet.resnet_imagenet(img, class_dim, depth, False,
                                        "NCHW")
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        test = main.clone(for_test=True)
        fluid.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                 use_nesterov=True).minimize(loss)
    return main, startup, test, loss


def test_resnet18_dygraph_matches_the_static_program():
    """The first two steps' losses and every parameter and running
    statistic after them, then the eval forward (running statistics)
    against the for-test clone, within RESNET_RTOL."""
    rng = np.random.RandomState(0)
    batch = {"img": chip_smoke._randn(rng, 4, 3, 32, 32),
             "label": rng.randint(0, 10, (4, 1)).astype("int64")}
    with tfluid.dygraph.guard(tfluid.CPUPlace()):
        model = chip_smoke.dygraph_resnet(18, 10)
        params = model.parameters()
        opt = tfluid.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                        use_nesterov=True)
        start = [p.numpy() for p in params]
        img = tfluid.dygraph.to_variable(batch["img"])
        label = tfluid.dygraph.to_variable(batch["label"])
        losses = [float(chip_smoke.dygraph_step(
            model, opt, params, img, label).numpy()[0]) for _ in range(2)]
        model.eval()
        with tfluid.dygraph.no_grad():
            ev = t_eager_op("mean", {"X": [t_eager_op(
                "softmax_with_cross_entropy",
                {"Logits": [model(img)], "Label": [label]})[1]]})[0]
        after = [p.numpy() for p in params]
    assert len([p for p in params if not p.stop_gradient]) == 62
    main, startup, test, loss = _static_resnet(tfluid, 18, 32, 10)
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        chip_smoke.dygraph_to_scope(start, main, scope)
        s_losses = [float(exe.run(main, feed=batch,
                                  fetch_list=[loss])[0][0])
                    for _ in range(2)]
        s_after = [scope.get(v.name).numpy() for v in main.all_parameters()]
        s_ev = float(exe.run(test, feed=batch, fetch_list=[loss])[0][0])
    np.testing.assert_allclose(losses, s_losses, rtol=RESNET_RTOL)
    errs = chip_smoke._rel_errs(after, s_after)
    assert max(errs) <= RESNET_RTOL, max(errs)
    assert sum(not np.array_equal(a, b) for a, b in zip(after, start)) \
        == len(start)
    np.testing.assert_allclose(float(ev.numpy()[0]), s_ev, rtol=RESNET_RTOL)


# ---- data parallel and the package's other exports ----

def test_parallel_env_and_data_parallel_match_the_reference(monkeypatch,
                                                            tmp_path):
    """``ParallelEnv`` reads the same ``PADDLE_*`` variables;
    ``DataParallel`` is transparent at one rank (``scale_loss`` the
    identity, ``apply_collective_grads`` nothing) and raises at two, as
    the reference's; ``prepare_context`` starts no group without
    endpoints; the exports ``BackwardStrategy``, ``Tracer`` and the
    ``save_persistables`` / ``load_persistables`` pair work."""
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", "a:1,b:2")
    monkeypatch.setenv("PADDLE_CURRENT_ENDPOINT", "b:2")

    def run(fluid, eager):
        dg = fluid.dygraph
        env = dg.ParallelEnv()
        seen = [env.nranks, env.local_rank, env.dev_id,
                env.trainer_endpoints, env.current_endpoint]
        assert dg.prepare_context("s") == "s"  # one rank: no group
        model = dg.DataParallel(dg.Linear(3, 2))
        x = dg.to_variable(np.ones((2, 3), "float32"))
        loss = eager("mean", {"X": [model(x)]})[0]
        assert model.scale_loss(loss) is loss
        model.apply_collective_grads()
        seen.append(sorted(model.state_dict()))
        seen.append(dg.BackwardStrategy().sort_sum_gradient)
        assert dg.Tracer is not None
        path = str(tmp_path / fluid.__name__)
        # the package's names alias save_dygraph / load_dygraph, as the
        # reference's dygraph/__init__.py has them
        dg.save_persistables(model.state_dict(), path)
        back, opt_state = dg.load_persistables(path)
        seen.append((sorted(back), opt_state))
        return seen

    ref, port = _both(run)
    assert port == ref
    assert port[:5] == [1, 1, 1, ["a:1", "b:2"], "b:2"]
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    with tfluid.dygraph.guard(tfluid.CPUPlace()):
        model = tfluid.dygraph.DataParallel(tfluid.dygraph.Linear(3, 2))
        x = tfluid.dygraph.to_variable(np.ones((2, 3), "float32"))
        loss = t_eager_op("mean", {"X": [model(x)]})[0]
        np.testing.assert_allclose(model.scale_loss(loss).numpy(),
                                   loss.numpy() / 2, rtol=1e-6)
        with pytest.raises(NotImplementedError):
            model.apply_collective_grads()
