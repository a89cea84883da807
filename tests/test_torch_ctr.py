"""The CTR models of the PyTorch port (``paddle_tpu_torch/models/ctr.py``)
against the reference's (``paddle_tpu/models/ctr.py``) on device tables:
DeepFM at dim 128 (its 4 ``fm_emb_*`` lookups become
``fused_embedding_gather``, K3 forward and backward; the reference runs
its Pallas gather with ``PADDLE_TPU_PALLAS=interpret``) and Wide&Deep at
its default dim 16 (plain lookups in both), at 4 slots x 3 ids,
vocabulary 2000, batch 16.

Both packages build the same program and the port takes the reference's
startup parameters (``convert``).  Over 5 Adam steps on seeded batches
(ids drawn from [0, V), so padding id 0 appears) the losses agree within
1e-5 relative, the probabilities within 1e-6; the fusion's
``embedding_gather`` sites and skips are the reference's, op for op.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.models import ctr as jctr

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.convert import load_params_into_scope, \
    scope_persistables
from paddle_tpu_torch.executor import Scope
from paddle_tpu_torch.models import ctr as tctr

SLOTS, LEN, VOCAB, BATCH, STEPS = 4, 3, 2000, 16, 5
LOSS_RTOL = 1e-5
PROB_ATOL = 1e-6
MODELS = {"deepfm": {"model": "deepfm", "embed_dim": 128},
          "wide_deep": {"model": "wide_deep"}}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")


def _batches(model):
    rng = np.random.RandomState(21)
    out = []
    for _ in range(STEPS):
        feed = {"slot_%d" % i: rng.randint(0, VOCAB, (BATCH, LEN))
                .astype("int64") for i in range(SLOTS)}
        feed["label"] = rng.randint(0, 2, (BATCH, 1)).astype("int64")
        if model == "wide_deep":
            feed["dense"] = rng.randn(BATCH, 13).astype("float32")
        out.append(feed)
    return out


def _train(fluid, ctr, kw, params=None, **build_kw):
    fluid.unique_name.switch()
    main, startup, feeds, loss, prob = ctr.build(
        num_slots=SLOTS, slot_len=LEN, vocab=VOCAB, **dict(kw, **build_kw))
    exe = fluid.Executor(fluid.CPUPlace())
    scope = JScope() if fluid is jfluid else Scope()
    exe.run(startup, scope=scope)
    if params is not None:
        load_params_into_scope(params, scope, program=main)
    start = scope_persistables(main, scope)
    losses, probs = [], []
    for feed in _batches(kw["model"]):
        lv, pv = exe.run(main, feed=feed, fetch_list=[loss, prob],
                         scope=scope)
        losses.append(float(np.asarray(lv).reshape(())))
        probs.append(np.asarray(pv))
    return losses, probs, start, main, loss


@pytest.mark.parametrize("model", sorted(MODELS))
def test_ctr_training_matches_reference(model):
    kw = MODELS[model]
    ref_losses, ref_probs, start, _, _ = _train(jfluid, jctr, kw)
    losses, probs, _, _, _ = _train(tfluid, tctr, kw, params=start)
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    for got, want in zip(probs, ref_probs):
        np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)
    assert np.isfinite(losses).all()


def _gather_report(fluid, ctr, kw):
    from_pkg = (jfluid.static_analysis.fusion if fluid is jfluid
                else tfluid.static_analysis.fusion)
    fluid.unique_name.switch()
    main, _, _, loss, _ = ctr.build(num_slots=SLOTS, slot_len=LEN,
                                    vocab=VOCAB, **kw)
    _, report = from_pkg.resolve_fused_program(main, targets=[loss.name])
    sites = sorted((r.fused_op_type, r.op_idxs) for r in report.applied
                   if r.family == "embedding_gather")
    skips = sorted((s.op_idx, s.op_type) for s in report.skipped
                   if s.family == "embedding_gather")
    return sites, skips


@pytest.mark.parametrize("model", sorted(MODELS))
def test_fusion_embedding_gather_sites_match_reference(model):
    kw = MODELS[model]
    ref = _gather_report(jfluid, jctr, kw)
    got = _gather_report(tfluid, tctr, kw)
    assert got == ref
    sites, skips = got
    if model == "deepfm":
        # the dim-128 fm_emb_* tables fuse, the dim-1 fm_first_* do not
        assert len(sites) == SLOTS and len(skips) == SLOTS
    else:
        assert not sites and len(skips) == 2 * SLOTS


def test_is_distributed_changes_nothing_on_one_card():
    kw = MODELS["deepfm"]
    losses, _, start, main, _ = _train(tfluid, tctr, kw)
    dist_losses, _, _, dmain, _ = _train(tfluid, tctr, kw, params=start,
                                         is_distributed=True)
    assert dist_losses == losses
    assert [op.type for op in dmain.global_block().ops] \
        == [op.type for op in main.global_block().ops]


def test_device_table_recipe_runs_the_gather_kernels_and_learns():
    losses, report = tctr.run_deepfm_device_table_steps(
        steps=4, vocab=VOCAB, place=tfluid.CPUPlace())
    assert report.counts().get("embedding_gather") == SLOTS
    assert losses[-1] < losses[0], losses


def test_wide_deep_refuses_host_tables():
    with pytest.raises(ValueError, match="deepfm"):
        tctr.build(model="wide_deep", use_host_table=True)
