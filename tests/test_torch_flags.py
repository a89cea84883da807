"""``set_flags`` / ``get_flags`` of the port against the reference's.

The reference's flags (``paddle_tpu/core.py:149-197``): three names with
their defaults, ``KeyError`` on an unknown one, ``FLAGS_*`` environment
variables read at import, and ``FLAGS_check_nan_inf`` raising on the op
that makes a NaN (``tests/test_flags_debug.py``).  The port keeps the
same surface; on its devices ``FLAGS_check_nan_inf`` runs the block
eagerly and checks every op's floating outputs, and
``FLAGS_cpu_deterministic`` switches cuDNN to deterministic algorithms.
A flag that changes what runs is part of the executor's cache key.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import core as j_core

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import core as t_core

FLAGS = ("FLAGS_check_nan_inf", "FLAGS_cpu_deterministic", "FLAGS_benchmark")


@pytest.fixture
def restore_flags():
    before = (dict(t_core._flags), dict(j_core._flags),
              torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    yield
    tfluid.set_flags(before[0])
    jfluid.set_flags(before[1])
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        before[2:]


@pytest.mark.parametrize("fluid", [jfluid, tfluid], ids=["reference", "port"])
def test_flags_surface(fluid, restore_flags):
    """The same names and defaults; one name or a list; ``KeyError``
    naming an unknown flag, with nothing set."""
    assert fluid.get_flags(list(FLAGS)) == dict.fromkeys(FLAGS, False)
    assert fluid.get_flags("FLAGS_benchmark") == {"FLAGS_benchmark": False}
    with pytest.raises(KeyError, match="FLAGS_not_a_flag"):
        fluid.set_flags({"FLAGS_benchmark": True, "FLAGS_not_a_flag": 1})
    assert fluid.get_flags("FLAGS_benchmark") == {"FLAGS_benchmark": False}
    with pytest.raises(KeyError):
        fluid.get_flags("FLAGS_not_a_flag")
    fluid.set_flags({"FLAGS_benchmark": True})
    assert fluid.get_flags(["FLAGS_benchmark"]) == {"FLAGS_benchmark": True}


@pytest.mark.parametrize("raw, value", [("1", True), ("true", True),
                                        ("ON", True), ("0", False),
                                        ("no", False)])
def test_environment_bootstraps_flags_like_the_reference(raw, value,
                                                         monkeypatch,
                                                         restore_flags):
    """``FLAGS_*`` environment variables are read as the reference reads
    them, into the same values."""
    monkeypatch.setenv("FLAGS_benchmark", raw)
    for core in (j_core, t_core):
        core._bootstrap_flags()
    assert tfluid.get_flags("FLAGS_benchmark") \
        == jfluid.get_flags("FLAGS_benchmark") == {"FLAGS_benchmark": value}


def test_cpu_deterministic_switches_cudnn_and_back(restore_flags):
    """The flag sets cuDNN's deterministic switch and turns its
    benchmark off; clearing it restores both as they were."""
    cudnn = torch.backends.cudnn
    cudnn.deterministic, cudnn.benchmark = False, True
    tfluid.set_flags({"FLAGS_cpu_deterministic": True})
    assert (cudnn.deterministic, cudnn.benchmark) == (True, False)
    tfluid.set_flags({"FLAGS_cpu_deterministic": True})  # twice: one undo
    tfluid.set_flags({"FLAGS_cpu_deterministic": False})
    assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
    assert t_core.flags_key() == (False, False)


def _div_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[2], dtype="float32")
        y = fluid.layers.data("y", shape=[2], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.elementwise_div(x, y))
    return main, loss


# 0 / 0 is NaN
_NAN_FEED = {"x": np.array([[0.0, 1.0]], "float32"),
             "y": np.array([[0.0, 2.0]], "float32")}


@pytest.mark.parametrize("cache", [True, False], ids=["cached", "eager"])
def test_check_nan_inf_names_the_op_like_the_reference(cache,
                                                       restore_flags):
    """With the flag set both packages raise on ``0 / 0``, the port
    naming the op type and its output var; with it cleared the NaN runs
    through."""
    jmain, jloss = _div_program(jfluid)
    tmain, tloss = _div_program(tfluid)
    div_out = next(op for op in tmain.global_block().ops
                   if op.type == "elementwise_div").outputs["Out"][0]
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    for fluid in (jfluid, tfluid):
        fluid.set_flags({"FLAGS_check_nan_inf": True})
    with jfluid.scope_guard(jfluid.Scope()):
        with pytest.raises(Exception, match="[Nn]a[Nn]"):
            jexe.run(jmain, feed=_NAN_FEED, fetch_list=[jloss])
    with pytest.raises(FloatingPointError,
                       match=r"op elementwise_div .*NaN or Inf into %r"
                       % div_out):
        texe.run(tmain, feed=_NAN_FEED, fetch_list=[tloss],
                 scope=tfluid.Scope(), use_program_cache=cache)
    for fluid in (jfluid, tfluid):
        fluid.set_flags({"FLAGS_check_nan_inf": False})
    got = texe.run(tmain, feed=_NAN_FEED, fetch_list=[tloss],
                   scope=tfluid.Scope(), use_program_cache=cache)[0]
    assert np.isnan(got).all()


def test_check_nan_inf_runs_eagerly_and_flags_key_the_cache(restore_flags):
    """While ``FLAGS_check_nan_inf`` is set every call runs eagerly, with
    the flag as the reason, and a finite step gives the compiled step's
    result; ``FLAGS_cpu_deterministic`` is part of the cache key, so a
    step captured without it is not replayed with it."""
    main, loss = _div_program(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    feed = {"x": np.array([[1.5, 2.0]], "float32"),
            "y": np.array([[3.0, 0.5]], "float32")}

    def run():
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
        return out, exe.last_run_mode

    assert [run()[1] for _ in range(3)] == ["eager", "capture", "graph"]
    want = run()[0]
    tfluid.set_flags({"FLAGS_check_nan_inf": True})
    got, mode = run()
    assert mode == "eager" and "FLAGS_check_nan_inf" in exe.last_run_reason
    np.testing.assert_array_equal(got, want)
    tfluid.set_flags({"FLAGS_check_nan_inf": False})
    assert run()[1] == "graph"
    tfluid.set_flags({"FLAGS_cpu_deterministic": True})
    assert [run()[1] for _ in range(3)] == ["eager", "capture", "graph"]
    tfluid.set_flags({"FLAGS_cpu_deterministic": False})
    assert run()[1] == "graph"
