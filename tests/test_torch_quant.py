"""K7 and the port's ``quant`` package against the reference.

On the CPU the port's K7 wrappers run their plain PyTorch versions; the
reference runs its XLA composite (``PADDLE_TPU_PALLAS=off``) and, at a
kernel-eligible shape (B % 128 == 0, nblocks % 8 == 0), its Pallas K7 in
interpret mode.  The int8 values and the scales are compared bit for
bit, and so are the dequantized float32 and bfloat16 outputs.  The
collective and the training path are in ``test_torch_dp.py``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import quant as jquant
from paddle_tpu.quant import blockwise as jblockwise

from paddle_tpu_torch import quant as tquant
from paddle_tpu_torch.ops.cuda import _lib
from paddle_tpu_torch.ops.cuda import quant as k7
from paddle_tpu_torch.quant.blockwise import padded_size

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ERR_RTOL = 1e-6   # quantization_error / predicted_rms_error (f32 means)

_NAN, _INF = float("nan"), float("inf")


def _block(vals, b=256, fill=0.0):
    out = np.full(b, fill, "float32")
    out[:len(vals)] = vals
    return out


def _special_blocks():
    """Eight blocks of 256: the cases whose bits are easy to get wrong."""
    rng = np.random.RandomState(0)
    return np.concatenate([
        rng.randn(256).astype("float32"),
        np.zeros(256, "float32"),                        # scale 1, q 0
        _block([1, _NAN, -2, 0.5]),                      # NaN: scale 1
        _block([1, _INF, -2, 0.5]),                      # inf: scale inf
        _block([1, _INF, _NAN, -_INF]),                  # NaN wins
        _block([63.5, 2.5, -0.5, 127, 1.5, -2.5, 0.5, -126.5]),  # ties
        (rng.randn(256) * 10.0 ** rng.uniform(-20, 20, 256)).astype(
            "float32"),                                  # wide range
        _block([-3.25], fill=1e-3),                      # negative absmax
    ])


CASES = {
    "randn_1000_odd_tail": lambda: np.random.RandomState(1).randn(1000),
    "tail_257": lambda: np.random.RandomState(2).randn(257),
    "tail_255": lambda: np.random.RandomState(3).randn(255),
    "tail_129": lambda: np.random.RandomState(4).randn(129),
    "single_element": lambda: np.array([3.25]),
    "zeros": lambda: np.zeros(512),
    "zero_block_among_live": lambda: np.concatenate(
        [np.zeros(256), np.linspace(-1, 1, 256)]),
    "special_blocks": _special_blocks,
    "shape_12x33": lambda: np.random.RandomState(5).randn(12, 33),
}


@pytest.fixture
def xla(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "off")


def _ref(x, dtype, block=None):
    """The reference's (q, scales, dequant f32, dequant bf16) as numpy."""
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16"
                               else jnp.float32)
    q, s = jquant.block_quantize(jx, block=block)
    back = jquant.block_dequantize(q, s)
    back16 = jquant.block_dequantize(q, s, dtype=jnp.bfloat16)
    return (np.asarray(q), np.asarray(s), np.asarray(back),
            np.asarray(back16.astype(jnp.float32)))


def _port(x, dtype, block=None, kernel=True):
    tx = torch.from_numpy(np.asarray(x, "float32"))
    if dtype == "bfloat16":
        tx = tx.to(torch.bfloat16)
    q, s = tquant.block_quantize(tx, block=block, kernel=kernel)
    back = tquant.block_dequantize(q, s, kernel=kernel)
    back16 = tquant.block_dequantize(q, s, dtype=torch.bfloat16,
                                     kernel=kernel)
    return (q.numpy(), s.numpy(), back.numpy(), back16.float().numpy())


def _assert_same_bits(got, want):
    """Bit for bit, but any NaN for a NaN: a NaN's sign and payload are
    the backend's (0 · inf dequantizes an inf block to NaN)."""
    for name, g, w in zip(("q", "scales", "dequant f32", "dequant bf16"),
                          got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (name, g.dtype,
                                                           w.dtype)
        nan = np.isnan(w) if w.dtype.kind == "f" else np.zeros(w.shape, bool)
        if nan.any():
            assert np.array_equal(np.isnan(g), nan), name
        assert np.array_equal(g[~nan].view(np.uint8),
                              w[~nan].view(np.uint8)), name


# ---------------------------------------------------------------------------
# (a) K7 against the reference, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_blockwise_matches_xla_composite(xla, case, dtype):
    """q, scales and both dequantized types, bit for bit, against the
    reference's composite: odd tails, zero, NaN, inf and tie blocks,
    bfloat16 inputs; ``kernel=False`` gives the same bits."""
    x = CASES[case]().astype("float32")
    want = _ref(x, dtype)
    _assert_same_bits(_port(x, dtype), want)
    _assert_same_bits(_port(x, dtype, kernel=False), want)


@pytest.mark.parametrize("block", ["128", "100", "7"])
def test_block_from_env_matches_xla_composite(xla, monkeypatch, block):
    """``PADDLE_TPU_QUANT_BLOCK`` sets B in both packages, the odd B
    included (the port's kernel takes any B > 0)."""
    monkeypatch.setenv("PADDLE_TPU_QUANT_BLOCK", block)
    assert tquant.quant_block() == jquant.quant_block() == int(block)
    x = _special_blocks()[:1500]
    _assert_same_bits(_port(x, "float32"), _ref(x, "float32"))


def test_blockwise_matches_pallas_kernel_in_interpret_mode(monkeypatch):
    """At a kernel-eligible shape (8 blocks of 256) the reference runs
    its Pallas K7 (``_quant_kernel``, ``_dequant_kernel``) in interpret
    mode.  The int8 values are the port's everywhere.  Its scales are the
    port's too, except that XLA compiles the kernel body's ``absmax /
    127`` into ``absmax * (1/127)``, one ulp off the division in a few
    blocks; the port divides, as the reference's composite does (and
    matches it bit for bit above).  Where the scales agree, so do the
    dequantized values."""
    from paddle_tpu.ops.pallas.flash_attention import pallas_supported

    if not pallas_supported():
        pytest.skip("pallas unavailable in this jax build")
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")
    rng = np.random.RandomState(9)
    inputs = [_special_blocks()] + [
        (rng.randn(2048) * 10.0 ** rng.uniform(-3, 3, 2048)).astype(
            "float32") for _ in range(4)]
    assert jblockwise._eligible(8, 256)
    recip_blocks = 0
    for x in inputs:
        absmax = np.abs(x.reshape(8, 256)).max(axis=1)
        for dtype in ("float32", "bfloat16"):
            q, s, back, back16 = _port(x, dtype)
            jq, js, jback, jback16 = _ref(x, dtype)
            assert np.array_equal(q, jq)
            same = (s == js) | (np.isnan(s) & np.isnan(js))
            div = absmax / np.float32(127)
            off = ~same
            assert np.array_equal(s[off], div[off])
            assert np.array_equal(js[off], absmax[off] * np.float32(1 / 127))
            recip_blocks += int(off.sum())
            rows = np.repeat(same, 256)
            _assert_same_bits((q, s[same], back[rows], back16[rows]),
                              (jq, js[same], jback[rows], jback16[rows]))
    assert recip_blocks < len(inputs) * 8   # a few blocks, not most


def test_subnormal_block_keeps_ieee_scale(xla):
    """K7 runs without flush-to-zero: a block of subnormals gets the
    subnormal scale absmax / 127 and round-trips within half a step.
    The reference on XLA:CPU reads subnormal inputs as zero (its
    backend flushes them), so its answer there is the port's answer for
    a zero block."""
    x = np.full(256, 1e-41, "float32")
    q, s, back, _ = _port(x, "float32")
    assert s[0] == np.float32(1e-41) / np.float32(127) and 0 < s[0]
    assert (q == 127).all()
    assert np.abs(back - x).max() <= s[0] / 2
    _assert_same_bits(_port(np.zeros(256, "float32"), "float32"),
                      _ref(x, "float32"))


def test_error_model_matches_reference(xla):
    """``quantization_error`` and ``predicted_rms_error`` within 1e-6,
    for gaussian data, a zero input and a wide-range input."""
    rng = np.random.RandomState(5)
    for x in (rng.randn(4096).astype("float32"), np.zeros(512, "float32"),
              _special_blocks()[1536:1792]):
        got = tquant.quantization_error(torch.from_numpy(x))
        want = jquant.quantization_error(x)
        for k in ("measured_rms", "predicted_rms", "rel_error"):
            g, w = float(got[k]), float(want[k])
            assert abs(g - w) <= ERR_RTOL * max(abs(w), 1e-30), (k, g, w)
    s = np.array([0.5, 0.1, 3e-3], "float32")
    assert abs(float(tquant.predicted_rms_error(torch.from_numpy(s)))
               - float(jquant.predicted_rms_error(s))) <= ERR_RTOL * float(
                   jquant.predicted_rms_error(s))


def test_wire_bytes_and_min_bytes_match_reference(monkeypatch):
    for args in ((1 << 20, 8, 256, 2), (1 << 20, 8, 256, 4),
                 (64, 8, 256, 2), (1000, 2, None, 4), (7, 4, 100, 2)):
        assert tquant.quantized_wire_bytes(*args) == \
            jquant.quantized_wire_bytes(*args)

    class Prog:
        pass

    p = Prog()
    for env, mark in (({}, None), ({"PADDLE_TPU_QUANT_MIN_BYTES": "64"},
                                   None),
                      ({"PADDLE_TPU_QUANT_MIN_BYTES": "bad"}, None),
                      ({"PADDLE_TPU_QUANT_MIN_BYTES": "64"},
                       {"min_bytes": 8}),
                      ({"PADDLE_TPU_QUANT": "0"}, {"min_bytes": 8}),
                      ({}, {"min_bytes": "x"})):
        for k in ("PADDLE_TPU_QUANT", "PADDLE_TPU_QUANT_MIN_BYTES"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        p._quant_buckets = mark
        assert tquant.quant_min_bytes(p) == jquant.quant_min_bytes(p)
        assert tquant.quant_min_bytes() == jquant.quant_min_bytes()


# ---------------------------------------------------------------------------
# (b) the reference's own blockwise cases, on the port
# ---------------------------------------------------------------------------

def _roundtrip(x, block=None):
    q, s = tquant.block_quantize(torch.from_numpy(np.asarray(x)),
                                 block=block)
    back = tquant.block_dequantize(q, s, size=np.asarray(x).size)
    return q.numpy(), s.numpy(), back.numpy()


def test_wire_format_and_odd_tails():
    rng = np.random.RandomState(1)
    q, s, back = _roundtrip(rng.randn(1000).astype("float32"), block=256)
    assert q.dtype == np.int8 and s.dtype == np.float32
    assert q.size == padded_size(1000, 256) == 1024 and s.size == 4
    assert back.size == 1000
    for numel in (1000, 257, 255, 129):
        x = rng.randn(numel).astype("float32")
        q, s, back = _roundtrip(x, block=256)
        assert np.max(np.abs(back - x)) <= s.max() / 2 + 1e-7
        assert not q[numel:].any()
    q, s, back = _roundtrip(np.array([3.25], "float32"))
    assert back[0] == np.float32(3.25) and q[0] == 127


def test_shape_dtype_and_error_bound():
    rng = np.random.RandomState(4)
    x = rng.randn(2048).astype("float32")
    q, s, back = _roundtrip(x, block=256)
    err = np.abs(back - x).reshape(-1, 256)
    assert (err <= (s / 2.0)[:, None] + 1e-7).all()
    t = torch.from_numpy(rng.randn(12, 33).astype("float32"))
    qq, ss = tquant.block_quantize(t)
    assert tquant.block_dequantize(qq, ss, shape=(12, 33)).shape == (12, 33)
    xb = t.reshape(-1)[:256].to(torch.bfloat16)
    qb, sb = tquant.block_quantize(xb, block=256)
    back16 = tquant.block_dequantize(qb, sb, dtype=torch.bfloat16)
    assert back16.dtype == torch.bfloat16
    assert float((back16.float() - xb.float()).abs().max()) <= float(
        sb.max())
    d = tquant.quantization_error(torch.from_numpy(x))
    assert 0.5 <= float(d["measured_rms"]) / float(d["predicted_rms"]) <= 2


def test_knobs_and_replay(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_QUANT_BLOCK", "128")
    assert tquant.quant_block() == 128
    _, s = tquant.block_quantize(torch.zeros(200))
    assert s.numel() == padded_size(200, 128) // 128
    monkeypatch.setenv("PADDLE_TPU_QUANT_BLOCK", "not-a-number")
    assert tquant.quant_block() == 256
    monkeypatch.delenv("PADDLE_TPU_QUANT", raising=False)
    assert tquant.quant_enabled()
    monkeypatch.setenv("PADDLE_TPU_QUANT", "0")
    assert not tquant.quant_enabled()
    x = torch.from_numpy(np.random.RandomState(6).randn(1024)
                         .astype("float32"))
    q1, s1 = tquant.block_quantize(x)
    q2, s2 = tquant.block_quantize(x)
    assert torch.equal(q1, q2) and torch.equal(s1, s2)


# ---------------------------------------------------------------------------
# (c) the wrappers
# ---------------------------------------------------------------------------

def test_wrappers_check_inputs_and_count_no_cpu_launch():
    _lib.reset_launch_counts()
    blocks = torch.zeros(4, 256)
    with pytest.raises(TypeError, match="float32"):
        k7.block_quantize_blocks(blocks.double())
    with pytest.raises(ValueError, match=r"\[nblocks, B\]"):
        k7.block_quantize_blocks(blocks.reshape(-1))
    q, s = k7.block_quantize_blocks(blocks)
    with pytest.raises(TypeError, match="int8"):
        k7.block_dequantize_blocks(q.int(), s)
    with pytest.raises(ValueError, match="scales"):
        k7.block_dequantize_blocks(q, s[:3])
    k7.block_dequantize_blocks(q, s, torch.bfloat16)
    mq, ms = k7.block_quantize_blocks(torch.empty(3, 100, device="meta"))
    assert mq.shape == (3, 100) and mq.dtype == torch.int8
    assert ms.shape == (3,) and ms.dtype == torch.float32
    out = k7.block_dequantize_blocks(mq, ms, torch.bfloat16)
    assert out.shape == (3, 100) and out.dtype == torch.bfloat16
    counts = _lib.launch_counts()
    assert counts["block_quantize"] == counts["block_dequantize"] == 0


_BUILDER = r"""
import os, sys, time
from paddle_tpu_torch.ops.cuda import _lib

out, log, go = sys.argv[1:4]
while not os.path.exists(go):
    time.sleep(0.01)


def make(work):
    with open(log, "a") as f:
        f.write("%d\n" % os.getpid())
    time.sleep(0.5)
    path = os.path.join(work, "lib.so")
    with open(path, "wb") as f:
        f.write(b"x" * 65536)
    return path


print(_lib.build_once(out, make))
"""


def test_build_is_safe_when_two_processes_load_at_once(tmp_path):
    """Two processes reach the build at once: one builds (the other
    waits on the file lock), both get the finished library, and no
    temporary directory is left behind.  The build step is a stand-in:
    the lock and the rename are what is under test."""
    out = tmp_path / "build" / "abc" / "lib.so"
    log, go = tmp_path / "makes.log", tmp_path / "go"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILDER, str(out), str(log), str(go)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for _ in range(2)]
    go.write_text("")
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert [o.strip().splitlines()[-1] for o in outs] == [str(out)] * 2
    assert len(log.read_text().split()) == 1
    assert out.read_bytes() == b"x" * 65536
    assert sorted(os.listdir(tmp_path / "build")) == ["abc", "abc.lock"]
