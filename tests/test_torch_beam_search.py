"""Beam search in the PyTorch port against the reference, on the CPU:
``beam_search`` with deliberate ties (``jax.lax.top_k`` puts the lower
index first among equal values; the port's choice must too), finished
beams (one ``end_id`` candidate at an unchanged score), the first step's
``[0, -1e9, ...]`` convention, accumulated and per-step scores, a token
table, and ``beam_search_decode``'s backtrace through the parents with
its ``end_id`` padding.  The ops are called through both registries on
the same seeded numpy inputs; ids and parents must be equal (the
reference's are int32, as the port's), scores within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.ops import beam_search as tbeam
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.ops.control_flow import TensorArray

END = 2


def _search(pre_ids, pre_scores, scores, ids=None, beam_size=3,
            is_accumulated=False):
    attrs = {"beam_size": beam_size, "end_id": END,
             "is_accumulated": is_accumulated}
    want = jreg.get_op_def("beam_search").fn(
        None, dict(attrs), jnp.asarray(pre_ids), jnp.asarray(pre_scores),
        None if ids is None else jnp.asarray(ids), jnp.asarray(scores))
    got = treg.get_op_def("beam_search").fn(
        None, dict(attrs), torch.from_numpy(pre_ids),
        torch.from_numpy(pre_scores),
        None if ids is None else torch.from_numpy(ids),
        torch.from_numpy(scores))
    want = [np.asarray(w) for w in want]
    got = [g.numpy() for g in got]
    for name, g, w in zip(("ids", "scores", "parents"), got, want):
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        if name == "scores":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    return got


def test_ties_take_the_lower_index_first():
    """Every candidate of every beam scores the same: the K chosen are
    the first K of the flattened [K * V] row, beam 0's tokens 0, 1, 2."""
    b, k, v = 2, 3, 7
    ids, scores, parents = _search(
        np.full((b, k), 5, "int32"), np.zeros((b, k), "float32"),
        np.zeros((b, k, v), "float32"), is_accumulated=True)
    np.testing.assert_array_equal(ids, [[0, 1, 2]] * b)
    np.testing.assert_array_equal(parents, [[0, 0, 0]] * b)


@pytest.mark.parametrize("seed", range(4))
def test_seeded_ties(seed):
    """Scores drawn from a few values, so most candidates tie with
    others, across beams and within one."""
    rng = np.random.RandomState(seed)
    b, k, v = 4, 3, 11
    scores = rng.randint(-3, 1, (b, k, v)).astype("float32")
    pre = rng.randint(-2, 1, (b, k)).astype("float32")
    pre_ids = rng.randint(0, v, (b, k)).astype("int32")
    _search(pre_ids, pre, scores)
    _search(pre_ids, pre, scores, is_accumulated=True)
    _search(pre_ids, pre, scores, beam_size=2)


def test_torch_topk_lower_index_first_on_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 1.0]])
    vals, idx = tbeam.top_k_lower_index_first(x, 4)
    wvals, widx = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(wvals))
    assert idx.tolist() == [[1, 2, 4, 3]]


def test_finished_beams_keep_one_end_candidate_at_their_score():
    """Beam 1 emitted END: its only candidate is END at its own score,
    however high the step's scores of its other tokens; the others
    grow."""
    rng = np.random.RandomState(3)
    b, k, v = 2, 3, 6
    pre_ids = np.array([[4, END, 5], [1, 1, END]], "int32")
    pre_scores = np.array([[-1.0, -0.5, -2.0], [-0.1, -3.0, -0.2]],
                          "float32")
    scores = np.log(rng.dirichlet(np.ones(v), (b, k))).astype("float32")
    scores[0, 1, :] = 0.0  # the finished beam's step scores are ignored
    ids, sel, parents = _search(pre_ids, pre_scores, scores)
    for r in range(b):
        fin = int(np.where(pre_ids[r] == END)[0][0])
        picked = [j for j in range(k) if parents[r, j] == fin]
        assert len(picked) <= 1
        for j in picked:
            assert ids[r, j] == END and sel[r, j] == pre_scores[r, fin]


def test_first_step_collapses_onto_beam_0():
    """pre_scores [0, -1e9, -1e9]: every choice comes from beam 0, the K
    best tokens of its row."""
    rng = np.random.RandomState(4)
    b, k, v = 3, 3, 9
    scores = np.log(rng.dirichlet(np.ones(v), (b, k))).astype("float32")
    pre = np.tile(np.array([0.0, -1e9, -1e9], "float32"), (b, 1))
    ids, sel, parents = _search(np.full((b, k), 1, "int32"), pre, scores)
    assert (parents == 0).all()
    np.testing.assert_array_equal(
        ids, np.argsort(-scores[:, 0], axis=1, kind="stable")[:, :k])


def test_a_token_table_and_a_finished_parent_emit_end():
    rng = np.random.RandomState(5)
    b, k, v = 2, 3, 5
    table = rng.randint(10, 100, (b, k, v)).astype("int64")
    pre_ids = np.array([[3, END, 4], [END, 0, 1]], "int32")
    pre = rng.randn(b, k).astype("float32")
    scores = np.log(rng.dirichlet(np.ones(v), (b, k))).astype("float32")
    ids, _s, parents = _search(pre_ids, pre, scores, ids=table)
    fin = pre_ids == END
    for r in range(b):
        for j in range(k):
            if fin[r, parents[r, j]]:
                assert ids[r, j] == END


def _arrays(steps, b, k, v, length, seed):
    """Tensor arrays as a decode loop of ``length`` trips leaves them in
    buffers of ``steps`` rows: ids, totals, parents → (the reference's
    dicts, the port's arrays)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, v, (steps, b, k)).astype("int32")
    ids[rng.rand(steps, b, k) < 0.15] = END
    scores = np.cumsum(-rng.rand(steps, b, k), axis=0).astype("float32")
    parents = rng.randint(0, k, (steps, b, k)).astype("int32")
    ids[length:] = parents[length:] = 0
    scores[length:] = 0.0
    ref = [{"buffer": jnp.asarray(a), "length": jnp.asarray(length,
                                                            jnp.int32)}
           for a in (ids, scores, parents)]
    port = [TensorArray(torch.from_numpy(a),
                        torch.tensor(length, dtype=torch.int32))
            for a in (ids, scores, parents)]
    return ref, port, (ids, scores, parents)


def _plain_backtrace(ids, parents, length, k):
    steps, b, _ = ids.shape
    sent = np.full((b, k, steps), END, "int32")
    for r in range(b):
        for j in range(k):
            cur = j
            for t in range(length - 1, -1, -1):
                sent[r, j, t] = ids[t, r, cur]
                cur = parents[t, r, cur]
            seen = np.where(sent[r, j] == END)[0]
            if seen.size:
                sent[r, j, seen[0]:] = END
    return sent


@pytest.mark.parametrize("length", [1, 4, 7])
def test_beam_search_decode_backtrace(length):
    steps, b, k, v = 7, 3, 3, 20
    ref, port, (ids, scores, parents) = _arrays(steps, b, k, v, length,
                                                length)
    attrs = {"beam_size": k, "end_id": END}
    want = [np.asarray(w) for w in jreg.get_op_def(
        "beam_search_decode").fn(None, dict(attrs), *ref)]
    got = [g.numpy() for g in treg.get_op_def("beam_search_decode").fn(
        None, dict(attrs), *port)]
    assert got[0].dtype == want[0].dtype == np.int32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], _plain_backtrace(ids, parents,
                                                           length, k))
    np.testing.assert_array_equal(got[1], scores[length - 1])
