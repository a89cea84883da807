"""The PyTorch port stands alone: it imports neither ``jax`` nor
``paddle_tpu``, its entry points run on the GPU unless the caller asks
for the CPU, and the static-analysis gates it has not ported yet raise
rather than being skipped silently."""

import os
import re
import subprocess
import sys

import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import analysis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKER = r"""
import sys


class _Block:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "paddle_tpu"):
            raise ImportError("blocked import of %r" % name)
        return None


sys.meta_path.insert(0, _Block())
import numpy as np
import paddle_tpu_torch as fluid
from paddle_tpu_torch.models import bert  # noqa: F401
import paddle_tpu_torch.serving  # noqa: F401

main, startup = fluid.Program(), fluid.Program()
with fluid.program_guard(main, startup):
    x = fluid.layers.data("x", shape=[4], dtype="float32")
    y = fluid.layers.fc(x, size=3, act="gelu")
    loss = fluid.layers.reduce_sum(y)
    fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
scope = fluid.Scope()
with fluid.scope_guard(scope):
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    out, l0 = exe.run(main, feed={"x": np.ones((2, 4), "float32")},
                      fetch_list=[y, loss])
    l1 = exe.run(main, feed={"x": np.ones((2, 4), "float32")},
                 fetch_list=[loss])[0]
assert out.shape == (2, 3), out.shape
assert l1[0] < l0[0], (l0, l1)
assert not any(m.split(".")[0] in ("jax", "paddle_tpu")
               for m in sys.modules), sorted(sys.modules)
print("ISOLATED-OK")
"""


def test_port_imports_and_runs_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _BLOCKER], cwd=REPO,
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, timeout=300)
    assert res.returncode == 0 and "ISOLATED-OK" in res.stdout, res.stdout


def _sources():
    root = os.path.join(REPO, "paddle_tpu_torch")
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_source_imports_jax_or_the_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|paddle_tpu)\b")
    hits = []
    for path in _sources():
        with open(path) as f:
            for n, line in enumerate(f, 1):
                if pat.match(line):
                    hits.append("%s:%d: %s" % (path, n, line.strip()))
    assert not hits, "\n".join(hits)
    assert len(list(_sources())) > 20


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_executor_defaults_to_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="CUDAPlace"):
        fluid.Executor()
    with pytest.raises(RuntimeError, match="CUDAPlace"):
        fluid.Executor(fluid.TPUPlace())
    assert fluid.Executor(fluid.CPUPlace()).device.type == "cpu"


def _export_tiny(tmp_path):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        y = fluid.layers.fc(x, size=3)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        fluid.io.save_inference_model(str(tmp_path), ["x"], [y], exe,
                                      main_program=main)
    return str(tmp_path)


def test_predictor_defaults_to_cuda_and_raises_without_it(no_cuda,
                                                          tmp_path):
    d = _export_tiny(tmp_path)
    cfg = fluid.inference.AnalysisConfig(model_dir=d)
    assert cfg.use_gpu()
    with pytest.raises(RuntimeError, match="disable_gpu"):
        fluid.inference.create_paddle_predictor(cfg)
    cfg.disable_gpu()
    pred = fluid.inference.create_paddle_predictor(cfg)
    assert pred.place == fluid.CPUPlace()
    assert pred.run({"x": __import__("numpy").ones((1, 4), "float32")}
                    )[0].shape == (1, 3)


def test_unported_gates_raise(tmp_path):
    d = _export_tiny(tmp_path)
    cfg = fluid.inference.AnalysisConfig(model_dir=d)
    cfg.disable_gpu()
    pred = fluid.inference.create_paddle_predictor(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fluid.serving.PredictorServer(pred)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        analysis.Analyzer().run(pred.program, verify=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fluid.Executor(fluid.CPUPlace()).run(pred.program, verify=True)
    with pytest.raises(NotImplementedError, match="AMP"):
        cfg.enable_bf16()


def test_unported_training_options_raise():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        loss = fluid.layers.reduce_sum(fluid.layers.fc(x, size=3))
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            fluid.optimizer.Adam(0.01, regularization=object()).minimize(loss)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        loss = fluid.layers.reduce_sum(fluid.layers.fc(x, size=3))
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            fluid.optimizer.SGD(0.01).minimize(loss, grad_clip=object())
    from paddle_tpu_torch.models import bert
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        bert.build_pretrain(bert.BERT_TINY, seq_len=16, amp=True)
