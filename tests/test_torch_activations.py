"""The activation ops of the PyTorch port and their ``fluid.layers``
front ends against the reference (``paddle_tpu/ops/activations.py``,
``paddle_tpu/layers/ops.py``): every unary op, forward and the gradient
of ``sum(out * cot)``, floats within 1e-6 of max(1, |ref|), each with
the reference's default attrs and with attrs set; ``fluid.layers.fc``
with each activation the fusion's ``bias_act`` family takes, unfused
and through ``fused_bias_act``; and the two new activations of the AMP
white list in bf16, forward and gradient, within one bf16 unit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import registry as j_registry

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.ops import registry as t_registry
from paddle_tpu_torch.static_analysis import fusion as tfusion

from torch_parity_helpers import run_layers, run_pair, x

BF16_ULP = 2.0 ** -7


def _wide():
    return x(4, 6, scale=3.0)


def _unit():
    return np.random.RandomState(3).uniform(-0.9, 0.9, (4, 6)).astype(
        "float32")


def _positive():
    return np.abs(x(4, 6, seed=2)) + 0.5


UNARY = ["abs", "acos", "asin", "atan", "erf", "sin", "round", "rsqrt",
         "reciprocal", "logsigmoid", "softsign", "tanh_shrink", "relu6",
         "softplus", "elu", "stanh", "hard_sigmoid", "hard_swish", "swish",
         "brelu", "soft_relu", "thresholded_relu", "hard_shrink",
         "softshrink", "leaky_relu"]

FEED = {"acos": _unit, "asin": _unit, "rsqrt": _positive,
        "reciprocal": _positive}

ATTRS = {
    "leaky_relu": {"alpha": 0.1},
    "elu": {"alpha": 0.5},
    "stanh": {"scale_a": 0.5, "scale_b": 2.0},
    "hard_sigmoid": {"slope": 0.3, "offset": 0.4},
    "hard_swish": {"threshold": 5.0, "scale": 4.0, "offset": 2.0},
    "swish": {"beta": 1.5},
    "brelu": {"t_min": -1.0, "t_max": 2.0},
    "soft_relu": {"threshold": 2.0},
    "thresholded_relu": {"threshold": 0.5},
    "hard_shrink": {"threshold": 1.0},
    "softshrink": {"lambda": 0.7},
}

CASES = [(name, {}) for name in UNARY] + sorted(ATTRS.items())


@pytest.mark.parametrize("name, attrs", CASES,
                         ids=["%s%s" % (n, "-attrs" if a else "")
                              for n, a in CASES])
def test_activation_layer_matches_reference(name, attrs):
    feed = FEED.get(name, _wide)()

    def build(fluid, v):
        return getattr(fluid.layers, name)(v["x"], **attrs)

    run_pair(build, {"x": feed}, ["x"], what=name)


def test_every_activation_is_registered_with_its_grad():
    for name in UNARY + ["selu"]:
        assert t_registry.has_op(name) and t_registry.has_op(
            name + "_grad"), name
        assert not t_registry.get_op_def(name).no_grad, name


def test_round_is_half_to_even():
    feed = np.array([[-2.5, -1.5, -0.5, 0.5, 1.5, 2.5]], "float32")
    got, ref = run_pair(lambda f, v: f.layers.round(v["x"]), {"x": feed},
                        [], what="round")
    np.testing.assert_array_equal(got[0], [[-2, -2, -0, 0, 2, 2]])


def _fc(act):
    def build(fluid, v):
        return fluid.layers.fc(v["x"], size=4, act=act)
    return build


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("act", tfusion._ACT_TYPES)
def test_fc_with_each_fusable_activation(act, fused, monkeypatch):
    """``fc(act=A)`` runs on the CPU for every activation of the fusion's
    ``_ACT_TYPES``, with the fusion off and on (then the bias add and the
    activation are one ``fused_bias_act``), equal to the reference."""
    monkeypatch.setenv("PADDLE_TPU_FUSION", "1" if fused else "0")
    run_pair(_fc(act), {"x": x(3, 5)}, ["x"], what=act)
    if fused:
        _, (main, _) = run_layers(tfluid, _fc(act), {"x": x(3, 5)}, ["x"])
        fused_prog, report = tfusion.resolve_fused_program(main)
        types = [op.type for op in fused_prog.global_block().ops]
        assert "fused_bias_act" in types and act not in types, types
        assert "fused_bias_act_grad" in types, types


@pytest.mark.parametrize("op, attrs", [("swish", {"beta": 1.5}),
                                       ("leaky_relu", {"alpha": 0.1})])
def test_amp_white_list_activation_in_bf16(op, attrs):
    """The AMP rewrite runs these two in bf16 (both packages' white
    list): output and gradient in bf16, within one bf16 unit of the
    reference's, the scalar attr rounded to bf16 first in both."""
    assert op in tfluid.contrib.mixed_precision.fp16_lists.white_list
    a = x(6, 32, seed=5, scale=2.0)
    cot = x(6, 32, seed=6)
    jdef = j_registry.get_op_def(op)
    jctx = j_registry.LoweringContext(mode="train")
    jx = jnp.asarray(a).astype(jnp.bfloat16)
    jout, vjp = jax.vjp(lambda v: j_registry.call_op(
        jdef, jctx, {"X": [v]}, dict(attrs))["Out"][0], jx)
    (jgrad,) = vjp(jnp.asarray(cot).astype(jnp.bfloat16))
    tx = torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
    tout = t_registry.call_op(t_registry.get_op_def(op),
                              t_registry.LoweringContext(), {"X": [tx]},
                              dict(attrs))["Out"][0]
    (tgrad,) = torch.autograd.grad(
        tout, [tx], torch.from_numpy(cot).to(torch.bfloat16))
    for got, want in ((tout, jout), (tgrad, jgrad)):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        g = got.detach().float().numpy()
        w = np.asarray(want.astype(jnp.float32))
        assert np.abs(g - w).max() <= BF16_ULP * np.abs(w).max(), (
            op, np.abs(g - w).max())
