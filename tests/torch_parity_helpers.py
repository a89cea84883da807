"""Shared helpers of the port's parity tests of single layers and ops
against the reference (``test_torch_activations.py``,
``test_torch_everyday_ops.py``, ``test_torch_nn_losses.py``,
``test_torch_layer_front_ends.py``).

:func:`run_layers` builds the same layers in one package on seeded
numpy feeds and fetches every output and, where the outputs are
floating, the gradients of ``sum(out_i * cot_i)`` (seeded cotangents)
with respect to the differentiable feeds; :func:`close` holds integers
and bools exact and floats within ``tol`` of the larger of 1 and the
reference's largest magnitude.  :func:`op_pair` runs one op's lowering
in both packages directly (the reference's gradient by ``jax.vjp``, the
port's by autograd)."""

import numpy as np

import paddle_tpu as jfluid
from paddle_tpu.executor import Scope as JScope

from paddle_tpu_torch.executor import Scope

TOL = 1e-6


def close(got, ref, what, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if np.issubdtype(ref.dtype, np.integer) or ref.dtype == np.bool_:
        np.testing.assert_array_equal(got, ref, err_msg=what)
        return
    got, ref = got.astype(np.float64), ref.astype(np.float64)
    if not got.size:
        return
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref),
                                  err_msg=what)
    ok = ~np.isnan(ref)
    if not ok.any():
        return
    err = float(np.abs(got[ok] - ref[ok]).max())
    assert err <= tol * max(1.0, float(np.abs(ref[ok]).max())), (what, err)


def x(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        "float32")


def ints(low, high, shape, seed=0, dtype="int64"):
    return np.random.RandomState(seed).randint(low, high, shape).astype(
        dtype)


def run_layers(fluid, build, feeds, grad_feeds, params=None):
    """``build(fluid, vars)`` under a fresh program pair; ``params``, the
    reference's ``(program, scope)``, puts its persistables into the
    port's scope after the startup (:mod:`paddle_tpu_torch.convert`).
    Returns ``(fetched arrays, (program, scope))``."""
    fluid.unique_name.switch()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ins = {n: fluid.layers.data(n, shape=list(v.shape),
                                    dtype=str(v.dtype),
                                    append_batch_size=False,
                                    stop_gradient=n not in grad_feeds)
               for n, v in feeds.items()}
        outs = build(fluid, ins)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        floats = [o for o in outs if o.dtype in ("float32", "float64")]
        cots = {}
        if grad_feeds and floats:
            terms = []
            for i, o in enumerate(floats):
                c = fluid.layers.data("cot%d" % i, shape=list(o.shape),
                                      dtype="float32",
                                      append_batch_size=False)
                cots[c.name] = np.asarray(np.random.RandomState(
                    10 + i).randn(*o.shape), "float32")
                terms.append(fluid.layers.reduce_sum(
                    fluid.layers.elementwise_mul(o, c)))
            loss = fluid.layers.sums(terms) if len(terms) > 1 else terms[0]
            fluid.backward.append_backward(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = JScope() if fluid is jfluid else Scope()
    exe.run(startup, scope=scope)
    if params is not None:
        from paddle_tpu_torch import convert

        convert.load_params_into_scope(
            convert.scope_persistables(*params), scope, program=main)
    fetch = outs + [n + "@GRAD" for n in grad_feeds] if cots else outs
    res = exe.run(main, feed=dict(feeds, **cots), fetch_list=fetch,
                  scope=scope)
    return [np.asarray(r) for r in res], (main, scope)


def run_pair(build, feeds, grad_feeds, tol=TOL, what=""):
    """The same layers through both packages (the port on the
    reference's parameters), every fetch compared."""
    import paddle_tpu_torch as tfluid

    ref, jstate = run_layers(jfluid, build, feeds, grad_feeds)
    got, _ = run_layers(tfluid, build, feeds, grad_feeds, params=jstate)
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        close(g, r, "%s fetch %d" % (what, i), tol)
    return got, ref


def append(fluid, op_type, inputs, attrs=None, outs=("Out",), dtype=None):
    """One ``op_type`` op on ``inputs`` (slot → var or list of vars), a
    new var per slot of ``outs`` (typed ``dtype``, default the first
    input's) → one var or a tuple, in ``outs`` order."""
    helper = fluid.layer_helper.LayerHelper(op_type)
    first = next(iter(inputs.values()), None)
    if isinstance(first, (list, tuple)):
        first = first[0]
    dtype = dtype or (first.dtype if first is not None else "float32")
    made = [helper.create_variable_for_type_inference(dtype) for _ in outs]
    helper.append_op(
        type=op_type,
        inputs={k: list(v) if isinstance(v, (list, tuple)) else [v]
                for k, v in inputs.items()},
        outputs={s: [v] for s, v in zip(outs, made)}, attrs=attrs or {})
    return made[0] if len(made) == 1 else tuple(made)
