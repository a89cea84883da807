"""Autoregressive decoding layers: ring and paged KV caches, flash-decode
attention and sampling (mirrors ``paddle_tpu/layers/decode.py`` :33-226).

Each layer appends the same op types, slots and attrs as the reference.
The cache writes are ``in_place`` by default: the op's output is the
cache var itself, and its lowering updates the resident tensor
(``ops/decode.py``).  ``decode_loop`` (:229) needs the ``While`` op and
the tensor arrays, which are not ported yet: it raises.
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
    """The reference's single-program generation loop needs ``While`` and
    the tensor arrays: not ported yet.  Serve decode through
    ``serving.DecodeEngine``, whose scheduler runs one step program per
    token from the host."""
    raise NotImplementedError(
        "decode_loop needs the While op and tensor arrays, which are not "
        "ported yet (ROADMAP.md, Queue A item 5: decode); serve decode "
        "through serving.DecodeEngine")
