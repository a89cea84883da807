"""Autoregressive decoding layers: ring and paged KV caches, flash-decode
attention, sampling and the single-program generation loop (mirrors
``paddle_tpu/layers/decode.py`` :33-305).

Each layer appends the same op types, slots and attrs as the reference.
The cache writes are ``in_place`` by default: the op's output is the
cache var itself, and its lowering updates the resident tensor
(``ops/decode.py``).  ``decode_loop`` (:229) is one ``While`` whose body
is one decode step; the executor drives its trips from the host and
replays the body from a CUDA graph (``ops/control_flow.py``,
``executor._LoopBody``).
"""

from ..layer_helper import LayerHelper
from . import tensor as tensor_layers

__all__ = [
    "create_kv_cache", "kv_cache_write", "kv_cache_prefill",
    "flash_decode", "create_paged_kv_cache", "paged_kv_cache_write",
    "paged_kv_cache_prefill", "paged_flash_decode", "top_k_sampling",
    "top_p_sampling", "greedy_sampling", "sampling", "decode_loop",
]


def create_kv_cache(batch, heads, max_len, head_dim, dtype="float32",
                    name=None):
    """A zero ring cache var [batch, heads, max_len, head_dim]; the batch
    must be static (the serving bucket)."""
    if batch == -1:
        raise ValueError(
            "create_kv_cache needs a static batch (the serving bucket "
            "size); got -1")
    return tensor_layers.fill_constant([batch, heads, max_len, head_dim],
                                       dtype, 0.0)


def _cache_out(helper, cache, in_place):
    return cache if in_place else \
        helper.create_variable_for_type_inference(cache.dtype)


def kv_cache_write(cache, x, cursor, per_row=False, in_place=True,
                   name=None):
    """Write this step's K (or V) [B, H, D] into ``cache`` at ``cursor``
    (ring semantics)."""
    helper = LayerHelper("kv_cache_write", **locals())
    out = _cache_out(helper, cache, in_place)
    helper.append_op(
        type="kv_cache_write",
        inputs={"Cache": [cache], "X": [x], "Cursor": [cursor]},
        outputs={"Out": [out]}, attrs={"per_row": bool(per_row)})
    return out


def kv_cache_prefill(cache, x, slot=None, in_place=True, name=None):
    """Bulk-write a prompt's K/V [B, H, L, D] into cache rows [0, L);
    ``slot`` ([1] int32 var) routes a batch-1 prefill into that row."""
    helper = LayerHelper("kv_cache_prefill", **locals())
    out = _cache_out(helper, cache, in_place)
    inputs = {"Cache": [cache], "X": [x]}
    if slot is not None:
        inputs["Slot"] = [slot]
    helper.append_op(type="kv_cache_prefill", inputs=inputs,
                     outputs={"Out": [out]}, attrs={})
    return out


def _decode_attention(op_type, helper, q, inputs, sm_scale, per_row):
    out = helper.create_variable_for_type_inference(q.dtype)
    attrs = {"per_row": bool(per_row)}
    if sm_scale is not None:
        attrs["sm_scale"] = float(sm_scale)
    helper.append_op(type=op_type, inputs=inputs, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def flash_decode(q, k_cache, v_cache, cursor, sm_scale=None,
                 per_row=False, name=None):
    """Single-query attention [B, H, D] against the ring cache, masked to
    ``cursor`` valid entries (the flash-decode kernel on the GPU)."""
    helper = LayerHelper("flash_decode", **locals())
    return _decode_attention(
        "flash_decode_attention", helper, q,
        {"Q": [q], "KCache": [k_cache], "VCache": [v_cache],
         "Cursor": [cursor]}, sm_scale, per_row)


def create_paged_kv_cache(num_blocks, heads, block_len, head_dim,
                          dtype="float32", name=None):
    """A zero paged KV pool [num_blocks, heads, block_len, head_dim]."""
    return tensor_layers.fill_constant(
        [num_blocks, heads, block_len, head_dim], dtype, 0.0)


def paged_kv_cache_write(cache, x, cursor, table, per_row=True,
                         in_place=True, name=None):
    """Write this step's K (or V) [S, H, D] into the paged pool at each
    stream's cursor through its block-table row (``-1`` drops it)."""
    helper = LayerHelper("paged_kv_cache_write", **locals())
    out = _cache_out(helper, cache, in_place)
    helper.append_op(
        type="paged_kv_cache_write",
        inputs={"Cache": [cache], "X": [x], "Cursor": [cursor],
                "BlockTable": [table]},
        outputs={"Out": [out]}, attrs={"per_row": bool(per_row)})
    return out


def paged_kv_cache_prefill(cache, x, length, table, in_place=True,
                           name=None):
    """Bulk-write a prompt's K/V [1, H, L, D] into the blocks its table
    owns; padded positions ``>= length`` are dropped."""
    helper = LayerHelper("paged_kv_cache_prefill", **locals())
    out = _cache_out(helper, cache, in_place)
    helper.append_op(
        type="paged_kv_cache_prefill",
        inputs={"Cache": [cache], "X": [x], "Len": [length],
                "BlockTable": [table]},
        outputs={"Out": [out]}, attrs={})
    return out


def paged_flash_decode(q, k_cache, v_cache, cursor, table, sm_scale=None,
                       per_row=True, name=None):
    """Single-query attention [S, H, D] through the block table, masked
    to ``cursor`` valid entries per stream (the paged flash-decode kernel
    on the GPU)."""
    helper = LayerHelper("paged_flash_decode", **locals())
    return _decode_attention(
        "paged_flash_decode_attention", helper, q,
        {"Q": [q], "KCache": [k_cache], "VCache": [v_cache],
         "Cursor": [cursor], "BlockTable": [table]}, sm_scale, per_row)


def _sampling_op(op_type, logits, attrs, step, name):
    helper = LayerHelper(op_type, logits=logits, name=name)
    out = helper.create_variable_for_type_inference("int32")
    inputs = {"X": [logits]}
    if step is not None:
        inputs["Step"] = [step]
    helper.append_op(type=op_type, inputs=inputs, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def top_k_sampling(logits, k=1, temperature=1.0, seed=0, step=None,
                   name=None):
    """Token ids [B] sampled from the top-k of logits [B, V]; ``k=1`` or
    ``temperature<=0`` is greedy argmax.  ``step`` draws fresh noise per
    decode step."""
    return _sampling_op(
        "top_k_sampling", logits,
        {"k": int(k), "temperature": float(temperature), "seed": int(seed)},
        step, name)


def top_p_sampling(logits, p=0.9, temperature=1.0, seed=0, step=None,
                   name=None):
    """Nucleus sampling over logits [B, V]: the smallest descending-softmax
    prefix reaching mass ``p`` (the head token always kept)."""
    return _sampling_op(
        "top_p_sampling", logits,
        {"p": float(p), "temperature": float(temperature), "seed": int(seed)},
        step, name)


def greedy_sampling(logits, name=None):
    """Argmax token ids [B]."""
    return top_k_sampling(logits, k=1, temperature=0.0, name=name)


def sampling(logits, strategy="greedy", k=8, p=0.9, temperature=1.0,
             seed=0, step=None, name=None):
    """Greedy, top-k or top-p by name (the serving tenant's knob)."""
    if strategy == "greedy":
        return greedy_sampling(logits, name=name)
    if strategy == "top_k":
        return top_k_sampling(logits, k=k, temperature=temperature,
                              seed=seed, step=step, name=name)
    if strategy == "top_p":
        return top_p_sampling(logits, p=p, temperature=temperature,
                              seed=seed, step=step, name=name)
    raise ValueError("unknown sampling strategy %r (greedy|top_k|top_p)"
                     % (strategy,))


def decode_loop(step_fn, first_ids, prompt_len, max_new_tokens,
                eos_id=None, strategy="greedy", k=8, p=0.9,
                temperature=1.0, seed=0, name=None):
    """The generation loop in one program.

    ``step_fn(cur_ids, cursor, step) -> logits`` builds ONE decode step:
    embed ``cur_ids`` [B] at position ``cursor`` [1], write K/V through
    :func:`kv_cache_write`, attend with :func:`flash_decode`, and return
    next-token logits [B, V].  ``first_ids`` [B] is the first generated
    token (sampled from the prefill's last-position logits);
    ``prompt_len`` [1] int32 is the cursor start.

    Returns ``(tokens, gen_len)``: tokens [B, max_new_tokens] int32,
    gen_len [B] int32.  A row that hits eos keeps emitting eos until
    every row is done; positions past the loop's early exit keep the
    initial zero fill (slice each row with ``gen_len``).  The body
    carries only static-shape state (the ring caches through in-place
    writes, the [1] counters, the fixed-capacity token array), so one
    cache entry serves every generation; with ``eos_id`` the loop stops
    once every row has finished.
    """
    from . import control_flow as cf
    from . import nn
    from . import ops

    max_new_tokens = int(max_new_tokens)
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")

    i = tensor_layers.fill_constant([1], "int32", 1)
    limit = tensor_layers.fill_constant([1], "int32", max_new_tokens)
    cursor = tensor_layers.assign(prompt_len)  # don't mutate the feed var
    cur = tensor_layers.assign(first_ids)
    ones = tensor_layers.cast(cf.equal(cur, cur), "int32")  # [B] of 1
    gen_len = tensor_layers.assign(ones)
    arr = cf.array_write(nn.unsqueeze(cur, [1]),
                         tensor_layers.fill_constant([1], "int32", 0),
                         capacity=max_new_tokens)

    if eos_id is not None:
        eos_c = tensor_layers.fill_constant([1], "int32", int(eos_id))
        finished = cf.equal(cur, eos_c)
        running = ops.logical_not(nn.reduce_all(finished))
        cond = ops.logical_and(cf.less_than(i, limit), running)
    else:
        finished = None
        cond = cf.less_than(i, limit)

    w = cf.While(cond, max_trip_count=max_new_tokens)
    with w.block():
        logits = step_fn(cur, cursor, i)
        nxt = sampling(logits, strategy=strategy, k=k, p=p,
                       temperature=temperature, seed=seed, step=i)
        if eos_id is not None:
            # rows already finished keep emitting eos; live rows count
            # this token
            nxt = nn.where(finished, nn.elementwise_mul(ones, eos_c), nxt)
            live = tensor_layers.cast(ops.logical_not(finished), "int32")
            tensor_layers.assign(nn.elementwise_add(gen_len, live),
                                 output=gen_len)
            tensor_layers.assign(
                ops.logical_or(finished, cf.equal(nxt, eos_c)),
                output=finished)
        cf.array_write(nn.unsqueeze(nxt, [1]), i, array=arr)
        tensor_layers.assign(nxt, output=cur)
        cf.increment(i, value=1, in_place=True)
        cf.increment(cursor, value=1, in_place=True)
        if eos_id is not None:
            running = ops.logical_not(nn.reduce_all(finished))
            tensor_layers.assign(
                ops.logical_and(cf.less_than(i, limit), running),
                output=cond)
        else:
            cf.less_than(i, limit, cond=cond)

    tokens, _ = tensor_layers.tensor_array_to_tensor(arr, axis=1)
    return tokens, gen_len
