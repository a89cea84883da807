"""The serving slice of the PyTorch port against the reference package.

A narrow BERT (vocab 1024, hidden 128, 2 layers, 2 heads, ffn 512) at
T=128 goes export → AnalysisPredictor → PredictorServer in both
packages on the CPU, where the port's kernel wrappers run their plain
PyTorch versions.  Inputs come from seeded numpy; the two packages'
random initialisers draw different numbers, so the port is held to the
reference's weights through ``paddle_tpu_torch.convert``.
"""

import collections
import copy

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.models import bert as jbert
from paddle_tpu.static_analysis import fusion as jfusion

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.static_analysis import fusion as tfusion

T = 128
FEEDS = ["input_ids", "token_type_ids", "attn_mask_bias", "pos_ids"]
# float32 both sides, sums in another order through 2 layers
PORT_VS_REF_ATOL = 1e-4
# the same predictor, served rows vs a direct run
SERVE_ATOL = 1e-5


def _cfg(bert, fuse_attn, dropout):
    cfg = copy.copy(bert.BERT_TINY)
    cfg.fuse_attn = fuse_attn
    cfg.dropout = dropout
    cfg.attn_dropout = dropout
    return cfg


def _build(fluid, bert, cfg, for_test):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data("input_ids", shape=[T], dtype="int64")
        tt = fluid.layers.data("token_type_ids", shape=[T], dtype="int64")
        mask = fluid.layers.data("attn_mask_bias", shape=[1, 1, T],
                                 dtype="float32")
        hidden = bert.encoder(ids, tt, mask, cfg, T)
    if for_test:
        main = main.clone(for_test=True)
    return main, startup, hidden


def _feed(seed, rows):
    rng = np.random.RandomState(seed)
    mask = np.zeros((rows, 1, 1, T), "float32")
    for r in range(rows):
        mask[r, 0, 0, T - rng.randint(0, T // 2):] = -1e4
    return {"input_ids": rng.randint(0, 1024, (rows, T)).astype("int64"),
            "token_type_ids": rng.randint(0, 2, (rows, T)).astype("int64"),
            "attn_mask_bias": mask,
            "pos_ids": np.tile(np.arange(T, dtype="int64"), (rows, 1))}


# (fuse_attn, dropout): the fused attention op at T=128 (the path BERT
# takes at T=512), and the unfused matmul/softmax chain with dropout ops
# that the inference clone turns off
CASES = [(True, 0.0), ("auto", 0.1)]


@pytest.fixture(scope="module", params=CASES, ids=["fused", "unfused"])
def exported(request, tmp_path_factory):
    """The reference exports the model; both packages load the dir."""
    fuse_attn, dropout = request.param
    d = str(tmp_path_factory.mktemp("bert_export"))
    cfg = _cfg(jbert, fuse_attn, dropout)
    main, startup, hidden = _build(jfluid, jbert, cfg, for_test=False)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        jfluid.io.save_inference_model(d, FEEDS, [hidden], exe,
                                       main_program=main)
    params = {p.name: np.asarray(scope.get(p.name))
              for p in main.all_parameters()}
    jpred = jfluid.inference.create_paddle_predictor(
        jfluid.inference.AnalysisConfig(model_dir=d))
    cfg_t = tfluid.inference.AnalysisConfig(model_dir=d)
    cfg_t.disable_gpu()
    tpred = tfluid.inference.create_paddle_predictor(cfg_t)
    feed = _feed(0, 3)
    want = np.asarray(jpred.run(feed)[0])
    return {"dir": d, "params": params, "jpred": jpred, "tpred": tpred,
            "feed": feed, "want": want, "fuse_attn": fuse_attn,
            "dropout": dropout}


def test_reference_export_loads_in_port_predictor(exported):
    got = exported["tpred"].run(exported["feed"])[0]
    assert got.shape == (3, T, 128) and np.isfinite(got).all()
    np.testing.assert_allclose(got, exported["want"], atol=PORT_VS_REF_ATOL,
                               rtol=0)


def test_port_built_program_with_converted_params(exported):
    cfg = _cfg(tbert, exported["fuse_attn"], exported["dropout"])
    main, _startup, hidden = _build(tfluid, tbert, cfg, for_test=True)
    scope = tfluid.Scope()
    convert.load_params_into_scope(exported["params"], scope, "cpu",
                                   program=main)
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        got = exe.run(main, feed=exported["feed"], fetch_list=[hidden])[0]
    np.testing.assert_allclose(got, exported["want"], atol=PORT_VS_REF_ATOL,
                               rtol=0)


def test_exported_params_read_back_through_convert(exported):
    read = convert.read_exported_params(exported["dir"])
    assert set(read) == set(exported["params"])
    for name, arr in read.items():
        np.testing.assert_array_equal(arr, exported["params"][name])


def _op_counts(program):
    return collections.Counter(op.type for op in
                               program.global_block().ops)


def test_port_fuses_like_the_reference(exported):
    jpred, tpred = exported["jpred"], exported["tpred"]
    jprog, _ = jfusion.resolve_fused_program(
        jpred.program, targets=jpred.get_output_names())
    tprog, report = tfusion.resolve_fused_program(
        tpred.program, targets=tpred.get_output_names())
    assert _op_counts(tprog) == _op_counts(jprog)
    # 2 per layer + the embedding LN; one gather per table
    assert report.counts() == {"dropout_add_ln": 5, "embedding_gather": 3}


def test_fusion_kill_switch(exported, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FUSION", "0")
    tpred = exported["tpred"]
    prog, report = tfusion.resolve_fused_program(
        tpred.program, targets=tpred.get_output_names())
    assert prog is tpred.program and not report.applied
    got = tpred.run(exported["feed"])[0]
    np.testing.assert_allclose(got, exported["want"], atol=PORT_VS_REF_ATOL,
                               rtol=0)


def test_predictor_server_matches_direct_runs(exported):
    tpred = exported["tpred"]
    feeds = [_feed(10 + i, rows) for i, rows in enumerate((1, 2, 3, 1, 2))]
    server = tfluid.serving.PredictorServer(
        {"bert": tpred}, verify=False, buckets=(1, 2, 4, 8),
        auto_start=False)
    try:
        reqs = [server.submit("bert", f, request_id=i)
                for i, f in enumerate(feeds)]
        server.start()
        outs = [r.result(timeout=120) for r in reqs]
    finally:
        server.close()
    assert sum(rows for _t, _b, rows in server.dispatch_log) == 9
    for f, out in zip(feeds, outs):
        direct = tpred.run(f)[0]
        assert out[0].shape == direct.shape
        np.testing.assert_allclose(out[0], direct, atol=SERVE_ATOL, rtol=0)
    assert server.stats()["completed"] == 5


def test_predictor_server_rejects_bad_feed_by_request_id(exported):
    server = tfluid.serving.PredictorServer(exported["tpred"], verify=False,
                                            auto_start=False)
    bad = _feed(1, 1)
    bad["input_ids"] = bad["input_ids"][:, :T - 1]
    with pytest.raises(ValueError, match="request 'r7'"):
        server.submit("default", bad, request_id="r7")
    server.close()


def test_run_async_returns_lazy_handles(exported):
    tpred = exported["tpred"]
    handles = tpred.run_async(exported["feed"])
    assert not handles[0].synced
    got = tfluid.pipeline.materialize(handles)[0]
    np.testing.assert_allclose(got, exported["want"], atol=PORT_VS_REF_ATOL,
                               rtol=0)
