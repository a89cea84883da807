"""The everyday slice's two paths in small against the reference: the
label-smoothing head of PaddleCV's image_classification recipe on a
ResNet (``one_hot`` → ``label_smooth`` → soft-label
``softmax_with_cross_entropy``, ``chip_smoke.resnet_label_smooth_program``
in both packages) on ResNet-18 at 64x64, batch 4 (``test_torch_resnet.py``'s
slice size), trained two Momentum steps, and a DeepFM whose
lookups are emitted as ``lookup_table_v2`` (``chip_smoke.as_lookup_v2``):
the fusion takes the dim-128 ones onto ``fused_embedding_gather`` (K3)
as it does ``lookup_table``'s, the program trains bit for bit as the
``lookup_table`` program does, and as the reference's v2 program does.

The reference runs its Pallas kernels in interpret mode; the port takes
its parameters through ``convert``.  Tolerances: ResNet's first loss is
the forward alone (1e-5 relative); its second depends on the
gradients, where a relu input within rounding of 0 can take the
gradient in one package and not the other (``test_torch_resnet.py``),
so 2e-4 at lr 1e-4; DeepFM's losses 1e-5 as ``test_torch_ctr.py``'s.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.models import ctr as jctr
from paddle_tpu.models import resnet as jres

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.convert import load_params_into_scope, \
    scope_persistables
from paddle_tpu_torch.executor import Scope
from paddle_tpu_torch.models import ctr as tctr
from paddle_tpu_torch.models import resnet as tres
from paddle_tpu_torch.static_analysis import fusion as tfusion

import chip_smoke

FIRST_LOSS_RTOL = 1e-5
LOSS_RTOL = 2e-4
CTR_LOSS_RTOL = 1e-5
RESNET = {"depth": 18, "hw": 64, "batch": 4, "steps": 2, "lr": 1e-4}
CTR = {"num_slots": 2, "slot_len": 3, "vocab": 64, "embed_dim": 128,
       "batch": 8, "steps": 3}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")


def _train(fluid, main, startup, loss, feeds, params=None):
    exe = fluid.Executor(fluid.CPUPlace())
    scope = JScope() if fluid is jfluid else Scope()
    exe.run(startup, scope=scope)
    if params is not None:
        load_params_into_scope(params, scope, program=main)
    start = scope_persistables(main, scope)
    losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                       scope=scope)[0]).reshape(()))
              for f in feeds]
    return losses, start, scope


def test_resnet_label_smoothing_head_trains_like_reference():
    r = RESNET
    rng = np.random.RandomState(3)
    feeds = [{"img": rng.randn(r["batch"], r["hw"], r["hw"], 3).astype(
        "float32"), "label": rng.randint(0, 1000, (r["batch"], 1)).astype(
        "int64")} for _ in range(r["steps"])]
    runs = {}
    for fluid, resnet in ((jfluid, jres), (tfluid, tres)):
        main, startup, loss = chip_smoke.resnet_label_smooth_program(
            fluid, resnet, r["hw"], depth=r["depth"], lr=r["lr"])
        ops = [op.type for op in main.global_block().ops]
        assert ops.count("label_smooth") == 1 and "one_hot" in ops
        params = runs[jfluid][1] if fluid is tfluid else None
        runs[fluid] = _train(fluid, main, startup, loss, feeds, params)
    want, got = runs[jfluid][0], runs[tfluid][0]
    assert abs(got[0] - want[0]) <= FIRST_LOSS_RTOL * abs(want[0])
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def _deepfm(fluid, ctr, v2):
    fluid.unique_name.switch()
    c = CTR
    main, startup, _, loss, _ = ctr.build(
        model="deepfm", num_slots=c["num_slots"], slot_len=c["slot_len"],
        vocab=c["vocab"], embed_dim=c["embed_dim"])
    if v2:
        chip_smoke.as_lookup_v2(main)
    return main, startup, loss


def _ctr_feeds():
    c, rng = CTR, np.random.RandomState(8)
    out = []
    for _ in range(c["steps"]):
        f = {"slot_%d" % i: rng.randint(0, c["vocab"], (c["batch"],
                                                        c["slot_len"]))
             .astype("int64") for i in range(c["num_slots"])}
        f["label"] = rng.randint(0, 2, (c["batch"], 1)).astype("int64")
        out.append(f)
    return out


def test_lookup_table_v2_fuses_onto_k3_and_trains_as_lookup_table():
    c = CTR
    v2, v2_start, v2_loss = _deepfm(tfluid, tctr, True)
    types = [op.type for op in v2.global_block().ops]
    assert "lookup_table" not in types
    assert types.count("lookup_table_v2") == 2 * c["num_slots"]
    fused, report = tfusion.resolve_fused_program(v2, targets=[v2_loss.name])
    ftypes = [op.type for op in fused.global_block().ops]
    assert report.counts().get("embedding_gather") == c["num_slots"]
    assert ftypes.count("fused_embedding_gather") == c["num_slots"]
    assert ftypes.count("fused_embedding_gather_grad") == c["num_slots"]
    # the dim-1 fm_first_* tables stay plain v2 lookups
    assert ftypes.count("lookup_table_v2") == c["num_slots"]
    feeds = _ctr_feeds()
    ref_losses, start, jscope = _train(
        jfluid, *_deepfm(jfluid, jctr, True), feeds)
    v2_losses, _, v2_scope = _train(tfluid, v2, v2_start, v2_loss, feeds,
                                    start)
    v1, v1_start, v1_loss = _deepfm(tfluid, tctr, False)
    v1_losses, _, v1_scope = _train(tfluid, v1, v1_start, v1_loss, feeds,
                                    start)
    assert v2_losses == v1_losses
    for p in v1.all_parameters():
        assert np.array_equal(v1_scope.get(p.name).numpy(),
                              v2_scope.get(p.name).numpy()), p.name
    np.testing.assert_allclose(v2_losses, ref_losses, rtol=CTR_LOSS_RTOL)
