"""The port's compiled step against the reference's analysis and the
port's own eager executor.

``paddle_tpu_torch.executor`` keeps one cache entry per (program, scope,
feeds, fetches) and, on a CUDA place, replays a captured CUDA graph of
the step from the second call on.  On the CPU there is no graph: the
entry's step runs directly on its static inputs through the same
bookkeeping (static feeds, resident state written back in place, cloned
fetches), which is what these tests hold against ``use_program_cache=
False``, bit for bit, at small sizes: a 2-layer BERT pretraining step at
dropout 0.1, a small NHWC ResNet with Momentum and batch-norm
statistics, and a narrow GPT decoded through ring and paged KV caches.
The block analysis is held against the reference's ``_analyze_block``
on the same programs built by both packages.  Inputs come from seeded
numpy.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import executor as j_executor
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.serving import DecodeEngine as JDecodeEngine
from paddle_tpu.static_analysis import fusion as jfusion

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import executor as t_executor
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.ops import registry as t_registry
from paddle_tpu_torch.ops.cuda import dropout as t_drop
from paddle_tpu_torch.serving import DecodeEngine
from paddle_tpu_torch.static_analysis import fusion as tfusion

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import gpt_small  # noqa: E402

T = 64
STEPS = 3
SEED = 7
DECODE_BUCKETS = (8, 16)
DECODE_PROMPTS = (5, 12)
MAX_LEN = 32
BLOCK_LEN = 8


def _bert_cfg(bert, dropout=0.1):
    cfg = copy.copy(bert.BERT_TINY)
    cfg.fuse_attn = True
    cfg.dropout = dropout
    cfg.attn_dropout = dropout
    return cfg


def _bert_pretrain(fluid, bert):
    with fluid.unique_name.guard():
        main, startup, _feeds, loss = bert.build_pretrain(_bert_cfg(bert),
                                                          seq_len=T)
    main.random_seed = startup.random_seed = SEED
    return main, startup, loss


def _resnet(fluid, resnet):
    with fluid.unique_name.guard():
        main, startup, _feeds, loss, acc = resnet.build(
            "cifar10", depth=8, data_format="NHWC")
    main.random_seed = startup.random_seed = SEED
    return main, startup, loss, acc


def _gpt_cfg(module):
    return module.GPTConfig(vocab=64, hidden=32, layers=2, heads=2,
                            max_len=MAX_LEN)


def _fused(fusion, program, fetches):
    return fusion.resolve_fused_program(program, targets=fetches)[0]


def _bert_batch():
    return tbert.make_fake_batch(2, T, _bert_cfg(tbert),
                                 np.random.RandomState(SEED))


def _resnet_batch(seed):
    rng = np.random.RandomState(seed)
    return {"img": rng.randn(2, 32, 32, 3).astype("float32"),
            "label": rng.randint(0, 10, (2, 1)).astype("int64")}


def _data_names(program):
    return [v.name for v in program.global_block().vars.values()
            if getattr(v, "is_data", False)]


def _reference_lists(program, feeds, fetches):
    ext, _written, persist = j_executor._analyze_block(
        program.global_block(), feeds, fetches)
    rw = [n for n in ext if n in persist]
    return rw, [n for n in ext if n not in persist], \
        [n for n in persist if n not in rw]


# ---------------------------------------------------------------------------
# the block analysis against the reference's
# ---------------------------------------------------------------------------


def _analysis_bert():
    out = []
    for fluid, bert, fusion in ((jfluid, jbert, jfusion),
                                (tfluid, tbert, tfusion)):
        main, _startup, loss = _bert_pretrain(fluid, bert)
        out.append((_fused(fusion, main, [loss.name]), [loss.name]))
    return out


def _analysis_resnet():
    out = []
    for fluid, resnet, fusion in ((jfluid, jresnet, jfusion),
                                  (tfluid, tresnet, tfusion)):
        main, _startup, loss, acc = _resnet(fluid, resnet)
        fetch = [loss.name, acc.name]
        out.append((_fused(fusion, main, fetch), fetch))
    return out


def _analysis_decode(paged, which):
    """The step or the 16-token prefill of a decode engine, ring or
    paged, from each package."""
    out = []
    for fluid, engine, adapter in (
            (jfluid, JDecodeEngine, gpt_small.DecodeAdapter(
                _gpt_cfg(gpt_small), seed=SEED)),
            (tfluid, DecodeEngine, tgpt.DecodeAdapter(_gpt_cfg(tgpt),
                                                      seed=SEED))):
        fluid.unique_name.switch()
        eng = engine(adapter, slots=2, prompt_buckets=DECODE_BUCKETS,
                     place=fluid.CPUPlace(), name="gen", auto_start=False,
                     paged=paged, block_len=BLOCK_LEN)
        if which == "step":
            prog, fetch = eng._step_prog, [eng._step_fetch]
        else:
            prog, fetch = eng._prefill[DECODE_BUCKETS[-1]]
            fetch = [fetch]
        out.append((prog, fetch))
    return out


def _analysis_serving(tmp_path):
    """The reference's inference export of a narrow BERT encoder, loaded
    by each package."""
    cfg = _bert_cfg(jbert, dropout=0.0)
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        ids = jfluid.layers.data("input_ids", shape=[T], dtype="int64")
        tt = jfluid.layers.data("token_type_ids", shape=[T], dtype="int64")
        mask = jfluid.layers.data("attn_mask_bias", shape=[1, 1, T],
                                  dtype="float32")
        hidden = jbert.encoder(ids, tt, mask, cfg, T)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        jfluid.io.save_inference_model(
            str(tmp_path), ["input_ids", "token_type_ids", "attn_mask_bias",
                            "pos_ids"], [hidden], exe, main_program=main)
    out = []
    for fluid in (jfluid, tfluid):
        with fluid.scope_guard(fluid.Scope()):
            exe = fluid.Executor(fluid.CPUPlace())
            prog, _feeds, fetch = fluid.io.load_inference_model(
                str(tmp_path), exe)
        out.append((prog, [v.name for v in fetch]))
    return out


@pytest.mark.parametrize("case", [
    "bert_pretrain", "resnet_nhwc", "decode_step_ring", "decode_step_paged",
    "decode_prefill_ring", "decode_prefill_paged", "serving_export"])
def test_analyze_block_matches_reference(case, tmp_path):
    """The read-write, read-only and fresh persistable lists of the
    port's cache entry are the reference's, in order, for the same
    program built by both packages."""
    if case == "bert_pretrain":
        pair = _analysis_bert()
    elif case == "resnet_nhwc":
        pair = _analysis_resnet()
    elif case == "serving_export":
        pair = _analysis_serving(tmp_path)
    else:
        _, which, mode = case.split("_")
        pair = _analysis_decode(mode == "paged", which)
    (jprog, jfetch), (tprog, tfetch) = pair
    assert jfetch == tfetch
    feeds = _data_names(tprog)
    assert sorted(feeds) == sorted(_data_names(jprog))
    want = _reference_lists(jprog, feeds, jfetch)
    entry = t_executor._CompiledBlock(tprog, feeds, tfetch)
    assert (entry.rw_names, entry.ro_names, entry.fresh_persist) == want
    assert want[0] or case == "serving_export"
    assert entry.eager_reason is None


# ---------------------------------------------------------------------------
# the compiled step against the eager executor, bit for bit
# ---------------------------------------------------------------------------


def _state(scope, names):
    return {n: np.array(scope.get(n).numpy()) for n in names}


def _persistables(program):
    return sorted(v.name for v in program.global_block().vars.values()
                  if v.persistable and not getattr(v, "is_data", False))


def _train_runs(build, batches, cache):
    main, startup, fetch = build()
    scope = tfluid.Scope()
    modes, outs = [], []
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        for batch in batches:
            outs.append(exe.run(main, feed=batch, fetch_list=fetch,
                                use_program_cache=cache))
            modes.append(exe.last_run_mode)
    names = [n for n in _persistables(main) if scope.has(n)]
    return outs, _state(scope, names), modes


def _build_bert():
    main, startup, loss = _bert_pretrain(tfluid, tbert)
    grads = {op.inputs["Param"][0]: op.inputs["Grad"][0]
             for op in main.global_block().ops if op.type == "adam"}
    return main, startup, [loss.name, grads["bert.word_emb"]]


def _build_resnet():
    main, startup, loss, acc = _resnet(tfluid, tresnet)
    return main, startup, [loss.name, acc.name]


@pytest.mark.parametrize("model", ["bert_dropout", "resnet_nhwc"])
def test_compiled_training_matches_eager_bit_for_bit(model):
    """Three steps through the cache entry (warm-up, capture, replay) give
    the fetches and every persistable (parameters, Adam moments and
    beta powers, batch-norm statistics, Momentum velocities) of three
    eager steps exactly; at dropout 0.1 the masks move with the step."""
    if model == "bert_dropout":
        build, batches = _build_bert, [_bert_batch()] * STEPS
    else:
        build = _build_resnet
        batches = [_resnet_batch(s) for s in range(STEPS)]
    got, got_state, modes = _train_runs(build, batches, True)
    want, want_state, eager = _train_runs(build, batches, False)
    assert modes == ["eager", "capture", "graph"]
    assert eager == ["eager"] * STEPS
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert set(got_state) == set(want_state)
    assert any("moment" in n or "velocity" in n for n in got_state)
    for n in want_state:
        np.testing.assert_array_equal(got_state[n], want_state[n],
                                      err_msg=n)
    if model == "bert_dropout":  # the masks moved: so did the gradient
        assert not np.array_equal(got[1][1], got[2][1])


def _engine(paged):
    tfluid.unique_name.switch()
    return DecodeEngine(tgpt.DecodeAdapter(_gpt_cfg(tgpt), seed=SEED),
                        slots=2, prompt_buckets=DECODE_BUCKETS,
                        place=tfluid.CPUPlace(), name="gen",
                        auto_start=False, paged=paged, block_len=BLOCK_LEN)


def _decode_drive(eng, cache, steps=STEPS):
    """Prefill two prompts (one per bucket) into slots 0 and 1, then
    ``steps`` greedy steps of both, each program called as the engine
    calls it; returns the fetches, the executor's modes and the caches."""
    rng = np.random.RandomState(SEED)
    mb = eng.max_blocks
    tables = np.full((eng.slots, max(mb, 1)), -1, "int32")
    cur = np.zeros(eng.slots, "int32")
    cursors = np.zeros(eng.slots, "int32")
    outs, modes = [], []
    for slot, n in enumerate(DECODE_PROMPTS):
        prompt = rng.randint(1, 63, n).astype("int32")
        length = eng.buckets.bucket_for_seq(n)
        main, fetch = eng._prefill[length]
        padded = np.zeros((1, length), "int32")
        padded[0, :n] = prompt
        feed = {"prompt_ids": padded, "prompt_len": np.asarray([n], "int32")}
        if eng.paged:
            tables[slot] = np.arange(slot * mb, (slot + 1) * mb)
            feed["block_table"] = tables[slot:slot + 1]
        else:
            feed["slot"] = np.asarray([slot], "int32")
        for _ in range(2):  # a prefill program twice: warm-up and capture
            outs.append(eng._exe.run(main, feed=feed, fetch_list=[fetch],
                                     scope=eng.scope,
                                     use_program_cache=cache))
            modes.append(eng._exe.last_run_mode)
        cur[slot] = outs[-1][0].reshape(-1)[0]
        cursors[slot] = n
    for i in range(steps):
        feed = {"cur_ids": cur.copy(), "cursors": cursors.copy(),
                "step": np.asarray([i + 1], "int32")}
        if eng.paged:
            feed["block_tables"] = tables
        out = eng._exe.run(eng._step_prog, feed=feed,
                           fetch_list=[eng._step_fetch], scope=eng.scope,
                           use_program_cache=cache)
        outs.append(out)
        modes.append(eng._exe.last_run_mode)
        cur = out[0].reshape(-1).astype("int32")
        cursors += 1
    caches = {n: eng.scope.get(n).numpy().copy()
              for pair in eng._cache_names for n in pair}
    return outs, modes, caches


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_compiled_decode_matches_eager_bit_for_bit(paged):
    """Both prefill buckets and the greedy step through the cache: the
    tokens and every KV cache equal the eager executor's, and the cache
    writes stay in the resident cache tensors."""
    got_eng, want_eng = _engine(paged), _engine(paged)
    resident = {n: got_eng.scope.get(n) for pair in got_eng._cache_names
                for n in pair}
    got, modes, got_caches = _decode_drive(got_eng, True)
    want, _, want_caches = _decode_drive(want_eng, False)
    assert modes == ["eager", "capture"] * 2 + ["eager", "capture"] \
        + ["graph"] * (STEPS - 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
    for n in want_caches:
        np.testing.assert_array_equal(got_caches[n], want_caches[n],
                                      err_msg=n)
        assert got_eng.scope.get(n) is resident[n]
    assert np.abs(got_caches[got_eng._cache_names[0][0]]).sum() > 0


# ---------------------------------------------------------------------------
# the cache and the scope
# ---------------------------------------------------------------------------


def _small_program(train=True):
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = SEED
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4], dtype="float32")
        h = tfluid.layers.fc(x, size=3, param_attr="w", bias_attr="b")
        loss = tfluid.layers.mean(h)
        if train:
            tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, h, loss


def _x(rows, seed=0):
    return np.random.RandomState(seed).randn(rows, 4).astype("float32")


def test_program_cache_keys():
    """A repeat hits its entry; a version bump, a new feed shape, another
    fetch list and another scope each make a new one."""
    main, startup, h, loss = _small_program()
    scope, other = tfluid.Scope(), tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    for s in (scope, other):
        exe.run(startup, scope=s)
    start = len(exe._cache)

    def run(x, fetch, s=scope):
        exe.run(main, feed={"x": x}, fetch_list=fetch, scope=s)
        return len(exe._cache) - start

    assert run(_x(2), [loss]) == 1
    assert run(_x(2, seed=1), [loss]) == 1      # a repeat hits
    assert run(_x(3), [loss]) == 2              # a new feed shape
    assert run(_x(3), [loss, h]) == 3           # another fetch list
    assert run(_x(3), [loss, h], other) == 4    # another scope
    assert run(_x(3), [loss, h], other) == 4
    main._bump_version()                        # the program changed
    assert run(_x(3), [loss, h], other) == 5


def test_replaced_scope_tensor_is_picked_up():
    """A parameter replaced in the scope after the capture is what the
    next replay reads: one of the same shape is copied into the captured
    tensor, one of another shape drops the entry."""
    infer, startup, h, _loss = _small_program(train=False)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    x = _x(2)
    for _ in range(3):
        exe.run(infer, feed={"x": x}, fetch_list=[h], scope=scope)
    assert exe.last_run_mode == "graph"
    captured = scope.get("w")
    w = np.full((4, 3), 0.5, "float32")
    scope.set("w", torch.from_numpy(w.copy()))
    got = exe.run(infer, feed={"x": x}, fetch_list=[h], scope=scope)[0]
    b = scope.get("b").numpy()
    np.testing.assert_allclose(got, x @ w + b, rtol=1e-6)
    assert exe.last_run_mode == "graph" and scope.get("w") is captured
    np.testing.assert_array_equal(captured.numpy(), w)
    # a value of another shape cannot live in the captured tensor
    scope.set("b", np.ones((1, 3), "float32"))
    got = exe.run(infer, feed={"x": x}, fetch_list=[h], scope=scope)[0]
    assert exe.last_run_mode == "eager"  # the entry was dropped
    np.testing.assert_allclose(got, x @ w + 1.0, rtol=1e-6)


def test_compiled_steps_never_write_into_loaded_arrays():
    """Parameters loaded from a numpy dict (``convert``) or set in the
    scope as numpy arrays are trained in place by the compiled step's
    resident state, never in the caller's arrays: reloading the same
    dict before each call restarts every call from it."""
    from paddle_tpu_torch import convert

    main, startup, _h, loss = _small_program()
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    start = convert.scope_persistables(main, scope)
    kept = {k: v.copy() for k, v in start.items()}
    x = _x(2)
    losses = []
    for _ in range(3):
        convert.load_params_into_scope(start, scope, tfluid.CPUPlace(),
                                       program=main)
        losses.append(exe.run(main, feed={"x": x}, fetch_list=[loss],
                              scope=scope)[0])
    assert exe.last_run_mode == "graph"
    for k in kept:
        np.testing.assert_array_equal(start[k], kept[k])
    np.testing.assert_array_equal(losses[0], losses[2])
    w = kept["w"].copy()
    scope.set("w", w)
    exe.run(main, feed={"x": x}, fetch_list=[loss], scope=scope)
    np.testing.assert_array_equal(w, kept["w"])
    assert not np.array_equal(scope.get("w").numpy(), w)


def test_fetch_handles_keep_their_values_across_replays():
    """A lazy fetch of a parameter and of an activation, taken from a
    replay, keeps its value through later replays that update the
    parameter in place."""
    main, startup, h, loss = _small_program()
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    handles, values = [], []
    for i in range(4):
        out = exe.run(main, feed={"x": _x(2, seed=i)},
                      fetch_list=["w", h], scope=scope, return_numpy=False)
        handles.append(out)
        values.append([np.array(o.device_value.numpy()) for o in out])
    for out, want in zip(handles, values):
        for o, w in zip(out, want):
            np.testing.assert_array_equal(np.asarray(o), w)
    assert not np.array_equal(values[1][0], values[3][0])


def _collective_program():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4], dtype="float32")
        out = main.global_block().create_var(name="y", shape=[-1, 4],
                                             dtype="float32")
        main.global_block().append_op(
            type="c_allreduce_sum", inputs={"X": [x]},
            outputs={"Out": [out]}, attrs={"ring_id": 0})
    return main, out, {"x": _x(2)}


def _sampling_program():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4], dtype="float32")
        step = tfluid.layers.data("step", shape=[1], dtype="int32",
                                  append_batch_size=False)
        out = tfluid.layers.sampling(x, strategy="top_k", k=3,
                                     temperature=1.0, seed=1, step=step)
    return main, out, {"x": _x(2), "step": np.asarray([1], "int32")}


def _range_program():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        end = tfluid.layers.data("end", shape=[1], dtype="float32",
                                 append_batch_size=False)
        out = main.global_block().create_var(name="r", dtype="float32")
        main.global_block().append_op(
            type="range", inputs={"End": [end]}, outputs={"Out": [out]},
            attrs={"start": 0.0, "step": 1.0, "dtype": "float32"})
    return main, out, {"end": np.asarray([5.0], "float32")}


@pytest.mark.parametrize("build, op", [
    (_collective_program, "c_allreduce_sum"),
    (_sampling_program, "top_k_sampling"),
    (_range_program, "range")], ids=["collective", "sampling", "range"])
def test_programs_with_host_ops_run_eagerly(build, op):
    """A program holding an op that is not capturable runs eagerly on
    every call, with the op named as the reason, and gives the eager
    executor's result."""
    main, out, feed = build()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    want = exe.run(main, feed=feed, fetch_list=[out], scope=scope,
                   use_program_cache=False)[0]
    for _ in range(3):
        got = exe.run(main, feed=feed, fetch_list=[out], scope=scope)[0]
        assert exe.last_run_mode == "eager"
        assert repr(op) in exe.last_run_reason
    assert got.shape == want.shape
    if op != "top_k_sampling":  # a sample moves with the step
        np.testing.assert_array_equal(got, want)


def test_greedy_sampling_and_static_range_are_capturable():
    for attrs, ok in (({"k": 1}, True), ({"k": 4, "temperature": 0.0}, True),
                      ({"k": 4, "temperature": 1.0}, False)):
        assert t_registry.get_op_def("top_k_sampling").is_capturable(
            attrs, {"X": ["x"]}) == ok
    rng = t_registry.get_op_def("range")
    assert rng.is_capturable({"start": 0, "end": 4, "step": 1}, {})
    assert not rng.is_capturable({"start": 0, "step": 1}, {"End": ["e"]})


# ---------------------------------------------------------------------------
# the device-side seed
# ---------------------------------------------------------------------------


def _np_fmix32(h):
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def _np_step_seed(step, salt):
    """The kernels' ``pt::step_seed`` in numpy uint32 arithmetic."""
    s = step.astype(np.uint64)
    lo = (s & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (s >> np.uint64(32)).astype(np.uint32)
    with np.errstate(over="ignore"):
        h = _np_fmix32(lo ^ (hi * np.uint32(0x9E3779B9)))
        return _np_fmix32(h + salt * np.uint32(0x85EBCA77))


def test_step_seed_same_bits_on_host_tensor_and_kernel_arithmetic():
    """``step_seed(step, salt)`` gives the same 32 bits as a host int, as an
    int64 tensor and in the kernels' uint32 arithmetic, over 4096 seeded
    (step, salt) pairs including steps past 2**32; ``op_salt`` is a pure
    function of its arguments."""
    rng = np.random.RandomState(0)
    steps = np.concatenate([np.arange(64), rng.randint(0, 2 ** 62, 4032,
                                                       dtype=np.int64)])
    salts = rng.randint(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    want = _np_step_seed(steps, salts)
    for i in range(0, 4096, 97):
        assert t_drop.step_seed(int(steps[i]), int(salts[i])) == want[i]
    for salt in np.unique(salts[:8]):
        got = t_drop.step_seed(torch.from_numpy(steps), int(salt))
        mask = salts == salt
        np.testing.assert_array_equal(got.numpy()[mask].astype(np.uint32),
                                      want[mask])
    assert t_drop.op_salt(5, 12, 0) == t_drop.op_salt(5, 12, 0)
    assert len({t_drop.op_salt(5, i, d) for i in range(50)
                for d in range(3)}) == 150


def test_step_seed_masks_match_int_seed_masks():
    """A mask drawn from a step tensor and a salt is the mask of the
    integer seed ``step_seed(step, salt)``, in the row and the attention
    forms, and the plain flash attention draws it too."""
    step = torch.tensor([12345], dtype=torch.int64)
    salt = 0xDEADBEEF
    as_int = t_drop.step_seed(12345, salt)
    ss = t_drop.StepSeed(step, salt)
    np.testing.assert_array_equal(
        t_drop.row_keep_mask(ss, 0.3, (6, 40), step.device),
        t_drop.row_keep_mask(as_int, 0.3, (6, 40), step.device))
    np.testing.assert_array_equal(
        t_drop.attention_keep_mask(ss, 0.3, 3, 5, 7, step.device),
        t_drop.attention_keep_mask(as_int, 0.3, 3, 5, 7, step.device))
    from paddle_tpu_torch.ops.cuda import flash_attention as t_fa

    q = torch.from_numpy(np.random.RandomState(1).randn(2, 8, 16)
                         .astype("float32"))
    a = t_fa.flash_attention_fwd(q, q, q, dropout_rate=0.2, dropout_seed=ss)
    b = t_fa.flash_attention_fwd(q, q, q, dropout_rate=0.2,
                                 dropout_seed=as_int)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_drop.kernel_args(0.1, ss)
    with pytest.raises(TypeError, match="StepSeed"):
        t_drop.kernel_args(0.1, as_int)


@pytest.mark.parametrize("name, kernel", [
    ("void (anonymous namespace)::flash_fwd_kernel<float, 64>(float "
     "const*, float const*)", "flash_attention_fwd"),
    ("_ZN12_GLOBAL__N_120flash_bwd_dkv_kernelIfLi64EEEvPKT_",
     "flash_attention_bwd_dkv"),
    ("_ZN41_GLOBAL__N__c7f1a7a0_7_quant_cu_0c9b5a0b15quantize_kernelEPKfPaPfi",
     "block_quantize"),
    ("_ZN12_GLOBAL__N_117dequantize_kernelIfEEvPKaPKfPT_xi",
     "block_dequantize"),
    ("void (anonymous namespace)::paged_decode_kernel<float, 64>(float "
     "const*)", "paged_flash_decode_fwd"),
    ("_ZN12_GLOBAL__N_113decode_kernelIfLi64EEEvPKT_", "flash_decode_fwd"),
    # the partials' sums are not counted, nor another library's kernel of
    # a same name
    ("void (anonymous namespace)::bn_act_bwd_reduce_kernel(float const*)",
     None),
    ("_ZN2at6native13gather_kernelEv", None),
    ("void at::native::vectorized_elementwise_kernel<4>(int)", None),
])
def test_kernel_of_names_mangled_and_demangled(name, kernel):
    """A captured graph's kernel nodes (mangled names, from libcuda)
    and a profile's kernels (demangled) map to the launch counters'
    kernels by the same table."""
    from paddle_tpu_torch.ops.cuda import _lib

    assert _lib.kernel_of(name) == kernel


def test_launch_counts_by_source(monkeypatch):
    """A wrapper's launch outside a capture counts as run at once, one
    inside a capture as captured, a graph's replay counts its kernel
    nodes, ``launch_counts`` is the sum of what ran and a reset clears
    all three sources (the stream's capture state is stubbed: a CPU
    build of torch has none)."""
    from paddle_tpu_torch.ops.cuda import _lib

    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    _lib.reset_launch_counts()
    try:
        _lib.count_launch("block_quantize")
        capturing[0] = True
        _lib.count_launch("block_dequantize")
        _lib.count_replay({"block_quantize": 2, "block_dequantize": 1})
        _lib.count_replay({"block_quantize": 2, "block_dequantize": 1})
        by = _lib.launch_counts_by_source()
        assert by["wrapper"]["block_quantize"] == 1
        assert by["graph_nodes"] == dict(dict.fromkeys(_lib.KERNELS, 0),
                                         block_quantize=4,
                                         block_dequantize=2)
        assert by["captured"] == dict(dict.fromkeys(_lib.KERNELS, 0),
                                      block_dequantize=1)
        assert _lib.launch_counts()["block_quantize"] == 5
        assert _lib.launch_counts()["block_dequantize"] == 2
    finally:
        _lib.reset_launch_counts()
    assert set(_lib.launch_counts().values()) == {0}
