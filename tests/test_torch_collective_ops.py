"""The port's collective ops (``paddle_tpu_torch/ops/collective.py``)
against the reference's under ``shard_map``, and the fusion resolve's
overlap and hierarchy passes against the reference's.

The reference runs each op per worker under ``shard_map`` on the
conftest's 8-device CPU mesh with ``ctx.collective_axis``; the port runs
the same op in N spawned gloo ranks (``tests/torch_dist_helpers.py``)
with ring 0 bound to the default group.  One spawn of 2 ranks and one
of 4 serve every op case.

Tolerances: max, min, the gathers, broadcasts and permutations are
exact (``np.array_equal``); the sums, products and the hierarchical
triple's sums against the reference within ``SUM_RTOL`` 1e-6 (float32,
another association of the ranks' terms and of the ``pre_scale``:
XLA may fold the scale after its reduction, the port scales first); the
quantized hierarchical hop against the flat exchange within ``QUANT_RTOL`` 2e-2
of the bucket's largest value (one int8 block step, 1/127, per pass).
``c_allreduce_start`` / ``c_allreduce_wait`` give the fused op's bits,
dense and quant.
"""

import json

import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.static_analysis import fusion as tfusion
from paddle_tpu_torch.static_analysis import verifier as tverifier
from paddle_tpu_torch.transpiler import GradAllReduce as TGradAllReduce

import torch_dist_helpers as H

SUM_RTOL = 1e-6
QUANT_RTOL = 2e-2


def _cases(n, rng):
    def per_rank(shape, positive=False):
        vals = [rng.randn(*shape).astype("float32") for _ in range(n)]
        if positive:
            vals = [np.abs(v) + 0.5 for v in vals]
        return vals

    cases = [
        ("sum", "c_allreduce_sum", {"X": [per_rank((3, 4))]},
         {"ring_id": 0, "pre_scale": 0.5}),
        ("max", "c_allreduce_max", {"X": [per_rank((5,))]}, {"ring_id": 0}),
        ("min", "c_allreduce_min", {"X": [per_rank((5,))]}, {"ring_id": 0}),
        ("prod", "c_allreduce_prod", {"X": [per_rank((5,), True)]},
         {"ring_id": 0}),
        ("allreduce", "allreduce", {"X": [per_rank((4,))]}, {"ring_id": 0}),
        ("broadcast", "c_broadcast", {"X": [per_rank((2, 3))]},
         {"ring_id": 0, "root": 1}),
        ("broadcast_alias", "broadcast", {"X": [per_rank((2, 3))]},
         {"ring_id": 0, "root": 0}),
        ("allgather", "c_allgather", {"X": [per_rank((3, 2))]},
         {"ring_id": 0, "nranks": n}),
        ("reducescatter", "c_reducescatter", {"X": [per_rank((2 * n, 3))]},
         {"ring_id": 0, "nranks": n}),
        ("all_to_all", "all_to_all", {"X": [per_rank((2 * n, 3))]},
         {"ring_id": 0, "split_axis": 0, "concat_axis": 1}),
        ("ppermute", "ppermute", {"X": [per_rank((3,))]}, {"ring_id": 0}),
        ("ppermute_pair", "ppermute", {"X": [per_rank((3,))]},
         {"ring_id": 0, "perm": [[0, 1]]}),
        ("sync_calc", "c_sync_calc_stream", {"X": [per_rank((3,))]},
         {"ring_id": 0}),
        ("sync_comm", "c_sync_comm_stream", {"X": [per_rank((3,))]},
         {"ring_id": 0}),
    ]
    bucket = {"X": [per_rank((5, 3)), per_rank((7,)), per_rank((300,))]}
    cases += [
        ("fused", "c_fused_allreduce_sum", bucket,
         {"ring_id": 0, "pre_scale": 1.0 / n}),
        ("pair", "start_wait", bucket, {"ring_id": 0, "pre_scale": 1.0 / n}),
        ("fused_quant", "c_allreduce_quant", bucket,
         {"ring_id": 0, "pre_scale": 1.0 / n}),
        ("pair_quant", "start_wait", bucket,
         {"ring_id": 0, "pre_scale": 1.0 / n, "quant": True}),
    ]
    if n == 4:
        total = 15 + 7 + 300
        shapes = [[5, 3], [7], [300]]
        for quant in (False, True):
            cases.append((
                "hier_quant" if quant else "hier", "hier", bucket,
                {"quant": quant,
                 "rs": {"hier_chips": 2, "hier_slices": 2, "comm_nranks": 2,
                        "hier_total": total, "pre_scale": 0.25},
                 "cross": {"hier_chips": 2, "hier_slices": 2,
                           "comm_nranks": 2, "hier_groups": "cross"},
                 "ag": {"hier_chips": 2, "hier_slices": 2, "comm_nranks": 2,
                        "hier_total": total, "member_shapes": shapes}}))
    return cases


def _reference(n, op_type, ins, attrs):
    """The reference's op per worker under ``shard_map`` over ``n`` of
    the CPU devices → {slot: [array [n, ...]]}."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from paddle_tpu.jax_compat import shard_map
    from paddle_tpu.ops import registry as jreg

    mesh = Mesh(np.array(jax.devices()[:n]), ("d",))
    slots = sorted(ins)

    def call(t, ctx, vals, a):
        res = jreg.call_op(jreg.get_op_def(t), ctx, vals, a)
        return {k: list(v) for k, v in res.items()}

    def per_worker(*arrays):
        ctx = jreg.LoweringContext(mode="train")
        ctx.collective_axis = "d"
        it = iter(arrays)
        vals = {s: [next(it)[0] for _ in ins[s]] for s in slots}
        if op_type == "start_wait":
            res = call("c_allreduce_start", ctx, vals,
                       dict(attrs, overlap_bucket=7))
            res = call("c_allreduce_wait", ctx, {"X": res["Out"]},
                       {"ring_id": 0, "overlap_bucket": 7})
        elif op_type == "hier":
            rs = call("c_hier_reducescatter", ctx, vals, attrs["rs"])
            mid = call("c_allreduce_quant" if attrs["quant"]
                       else "c_allreduce_sum", ctx, {"X": rs["Out"]},
                       attrs["cross"])
            res = call("c_hier_allgather", ctx, {"X": mid["Out"]},
                       attrs["ag"])
        else:
            res = call(op_type, ctx, vals, attrs)
        return {k: [v[None] for v in vs] for k, vs in res.items()}

    flat = [jnp.asarray(np.stack(v)) for s in slots for v in ins[s]]
    f = jax.jit(shard_map(per_worker, mesh=mesh,
                          in_specs=tuple(P("d") for _ in flat),
                          out_specs=P("d")))
    return {k: [np.asarray(v) for v in vs] for k, vs in f(*flat).items()}


_SPAWNED = {}


def _spawned(n, tmp_path_factory):
    """The ``n``-rank spawn's cases and results, run once a module."""
    if n not in _SPAWNED:
        cases = _cases(n, np.random.RandomState(n))
        _SPAWNED[n] = (n, cases, H.spawn(
            H.collective_ops, n, tmp_path_factory.mktemp("ops%d" % n),
            cases))
    return _SPAWNED[n]


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    return _spawned(request.param, tmp_path_factory)


_EXACT = ("max", "min", "broadcast", "broadcast_alias", "allgather",
          "all_to_all", "ppermute", "ppermute_pair", "sync_calc",
          "sync_comm")


def test_collective_ops_match_the_reference_under_shard_map(ranks):
    """Every op of ``paddle_tpu/ops/collective.py`` against the
    reference's per worker: the extrema, gathers, broadcasts and
    permutations exactly, the sums and products within ``SUM_RTOL``."""
    n, cases, got = ranks
    for name, op_type, ins, attrs in cases:
        if op_type in ("start_wait", "hier", "c_allreduce_quant"):
            continue
        want = _reference(n, op_type, ins, attrs)
        for slot, vals in want.items():
            for i, w in enumerate(vals):
                for r in range(n):
                    g = got[r][name][slot][i]
                    assert g.shape == w[r].shape, (name, r, g.shape)
                    if name in _EXACT:
                        assert np.array_equal(g, w[r]), (name, r)
                    else:
                        assert H.rel(g, w[r]) <= SUM_RTOL, (name, r)


def test_start_wait_gives_the_fused_ops_bits(ranks):
    """``c_allreduce_start`` + ``c_allreduce_wait`` of a bucket equal the
    fused op bit for bit, dense and quant, on every rank; the dense pair
    equals the reference's pair exactly; a start whose wait never ran is
    drained."""
    n, cases, got = ranks
    byname = {c[0]: c for c in cases}
    for pair, fused in (("pair", "fused"), ("pair_quant", "fused_quant")):
        for r in range(n):
            for a, b in zip(got[r][pair]["Out"], got[r][fused]["Out"]):
                assert np.array_equal(a, b), (pair, r)
            for a, b in zip(got[r][pair]["Out"], got[0][pair]["Out"]):
                assert np.array_equal(a, b), (pair, r)
    want = _reference(n, "start_wait", *byname["pair"][2:])
    for i, w in enumerate(want["Out"]):
        for r in range(n):
            assert H.rel(got[r]["pair"]["Out"][i], w[r]) <= SUM_RTOL
    assert all(got[r]["drained"] for r in range(n))


def test_hierarchical_triple_matches_flat_and_reference(tmp_path_factory):
    """4 ranks as 2 slices of 2: reduce-scatter within the slice, the
    cross-slice sum, the gather back: the flat fused sum within
    ``SUM_RTOL`` and the reference's triple within ``SUM_RTOL``; the
    quantized cross hop within ``QUANT_RTOL`` of the dense sum."""
    n, cases, got = _spawned(4, tmp_path_factory)
    byname = {c[0]: c for c in cases}
    want = _reference(n, "hier", *byname["hier"][2:])
    for r in range(n):
        for i, (h, f) in enumerate(zip(got[r]["hier"]["Out"],
                                       got[r]["fused"]["Out"])):
            assert h.shape == f.shape
            assert H.rel(h, f) <= SUM_RTOL, (r, i)
            assert H.rel(h, want["Out"][i][r]) <= SUM_RTOL, (r, i)
            assert np.array_equal(h, got[0]["hier"]["Out"][i])
            q = got[r]["hier_quant"]["Out"][i]
            assert float(np.abs(q - f).max()) <= QUANT_RTOL * float(
                np.abs(f).max()), (r, i)


# ---------------------------------------------------------------------------
# the resolve: overlap and hierarchy passes, both packages
# ---------------------------------------------------------------------------

HW = {"peak_tflops": 100.0, "hbm_gbps": 1200.0, "ici_gbps": 100.0,
      "launch_us": 5.0}


def _dp_program(fluid, grad_allreduce, nranks):
    """The MLP of ``tests/test_torch_dp_runner.py`` transpiled for
    ``nranks`` ranks as 2 slices, with a bucket cap that makes three
    buckets."""
    main, startup, loss = H.mlp(fluid)
    grad_allreduce().transpile(program=main, startup_program=startup,
                               rank=0, nranks=nranks)
    main._num_trainers = nranks
    main._allreduce_bucket_mb = 0.0005
    main._cluster_spec = json.dumps(dict(HW, chips=nranks, slices=2,
                                         hbm_gb=16.0))
    return main, [loss.name]


@pytest.mark.parametrize("overlap", ["1", "0"])
@pytest.mark.parametrize("hierarchy", ["1", "0"])
def test_resolve_runs_hierarchy_then_overlap_like_the_reference(
        monkeypatch, overlap, hierarchy):
    """An MLP transpiled for 4 ranks as 2 slices of 2 with a bucket cap
    of three buckets: the resolved program has the reference's op types in the
    reference's order, with each pass on and off, and the verifier
    gives both the same findings (all but the planner comparison)."""
    import paddle_tpu as jfluid
    from paddle_tpu.static_analysis import fusion as jfusion
    from paddle_tpu.static_analysis import verifier as jverifier
    from paddle_tpu.transpiler.collective import GradAllReduce

    from test_torch_verifier import _as_port, _dicts

    monkeypatch.setenv("PADDLE_TPU_OVERLAP", overlap)
    monkeypatch.setenv("PADDLE_TPU_HIERARCHY", hierarchy)
    out = []
    for fluid, gar, fu, ver in (
            (jfluid, GradAllReduce, jfusion, jverifier),
            (tfluid, TGradAllReduce, tfusion, tverifier)):
        main, targets = _dp_program(fluid, gar, 4)
        fused, _ = fu.resolve_fused_program(main, targets=targets)
        # (the planner comparison needs the planner's search, which
        # the port raises on: ROADMAP.md, Queue A item 9)
        dicts = _dicts(ver.verify_program(
            fused, targets=targets, exclude=["manual-plan-suboptimal"]))
        for d in dicts:
            d.pop("op_id")  # ids the passes draw from a process counter
        out.append(([op.type for op in fused.global_block().ops],
                    _as_port(dicts) if fluid is jfluid else dicts))
    assert out[1][0] == out[0][0]
    assert out[1][1] == out[0][1]
    types = out[1][0]
    assert ("c_hier_reducescatter" in types) == (hierarchy == "1")
    if overlap == "0":
        assert "c_allreduce_start" not in types
