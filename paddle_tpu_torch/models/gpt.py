"""A decoder-only transformer for ``serving.DecodeEngine`` (mirrors
``examples/gpt_small.py``: ``GPTConfig`` :33, ``GPT_TINY`` :47,
``DecodeAdapter`` :306-455) with the same parameter names, so the
reference's weights load into the port by name.

``GPT2_SMALL_WIDTHS`` gives the published widths of GPT-2 small (Radford
et al. 2019, the 124M model: 12 layers, 12 heads, width 768, context
1024, vocabulary 50257); only the widths are GPT-2's.  The blocks stay
post-LN and the head untied, as ``gpt_small.py`` builds them, and the
weights are random from a seed.

The step builders attend to ``cursors`` cache rows, as the reference
adapter does (:418-422, :449-453): the K/V row written at the cursor in
the same step is not among them.

``build_program`` (:177-219) is the whole generation in one program: the
prefill fills a ring KV cache per layer, then ``layers.decode_loop`` runs
one ``While`` whose body is a one-token step (flash-decode attention
over the cache, sampling), attending to the rows up to and including the
one it writes.  ``build_naive_program`` (:222-300) is its A/B baseline
without a cache: every trip re-runs the whole ``[B, max_len]`` token
buffer through the model.  ``run_generate`` (:465-487) runs one of them
twice on the same prompts (the first run's wall time is the TTFT, the
second gives the rate); it runs on ``CUDAPlace(0)`` unless given a place.
"""

import math
import time

import numpy as np

from .. import core
from .. import layers
from .. import unique_name
from ..executor import Executor, Scope, scope_guard
from ..framework import Program, program_guard
from ..param_attr import ParamAttr

__all__ = ["GPTConfig", "GPT_TINY", "GPT2_SMALL_WIDTHS", "DecodeAdapter",
           "build_program", "build_naive_program", "make_fake_prompt",
           "run_generate"]


class GPTConfig:
    def __init__(self, vocab=128, hidden=64, layers=2, heads=4,
                 max_len=512, ffn=None, eos_id=None):
        self.vocab = vocab
        self.hidden = hidden
        self.layers = layers
        self.heads = heads
        self.max_len = max_len
        self.ffn = ffn or 4 * hidden
        # eos outside the sampled range by default: a fixed number of
        # tokens is decoded unless the caller wires a real eos
        self.eos_id = eos_id if eos_id is not None else vocab - 1


GPT_TINY = GPTConfig()
GPT2_SMALL_WIDTHS = GPTConfig(vocab=50257, hidden=768, layers=12, heads=12,
                              max_len=1024)


def _attr(name):
    return ParamAttr(name=name)


def _proj(x, size, name, flatten_dims):
    return layers.fc(x, size=size, num_flatten_dims=flatten_dims,
                     param_attr=_attr(name + ".w"),
                     bias_attr=_attr(name + ".b"))


def _ln(x, name, axis):
    return layers.layer_norm(x, begin_norm_axis=axis,
                             param_attr=_attr(name + ".scale"),
                             bias_attr=_attr(name + ".bias"))


def _embed(ids, cfg, table, rows):
    return layers.embedding(ids, size=[rows, cfg.hidden],
                            param_attr=_attr(table))


def _logits(x, cfg, flatten_dims=1):
    return _proj(x, cfg.vocab, "gpt.head", flatten_dims)


def _split_heads(x, cfg):
    """[B, L, E] → [B, H, L, Dh]."""
    dh = cfg.hidden // cfg.heads
    x = layers.reshape(x, [0, 0, cfg.heads, dh])
    return layers.transpose(x, [0, 2, 1, 3])


def _block_full(x, cfg, prefix, store=None):
    """One causal transformer block over [B, L, E]; ``store(k, v)``
    receives the block's K/V [B, H, L, Dh] (the prefill's cache write)."""
    d = cfg.hidden
    dh = d // cfg.heads
    q = _split_heads(_proj(x, d, prefix + ".q", 2), cfg)
    k = _split_heads(_proj(x, d, prefix + ".k", 2), cfg)
    v = _split_heads(_proj(x, d, prefix + ".v", 2), cfg)
    if store is not None:
        store(k, v)
    ctxv = layers.fused_multihead_attention(q, k, v, causal=True,
                                            scale=1.0 / math.sqrt(dh))
    ctxv = layers.reshape(layers.transpose(ctxv, [0, 2, 1, 3]), [0, 0, d])
    x = _ln(layers.elementwise_add(x, _proj(ctxv, d, prefix + ".o", 2)),
            prefix + ".ln1", 2)
    m = layers.gelu(_proj(x, cfg.ffn, prefix + ".fc1", 2))
    return _ln(layers.elementwise_add(x, _proj(m, d, prefix + ".fc2", 2)),
               prefix + ".ln2", 2)


def _block_decode(x, cfg, prefix, kc, vc, cursor, lens):
    """The same block over one token [B, E]: K/V written into the ring
    caches at ``cursor``, flash-decode over ``lens`` rows."""
    d, h = cfg.hidden, cfg.heads
    dh = d // h
    q = layers.reshape(_proj(x, d, prefix + ".q", 1), [0, h, dh])
    k = layers.reshape(_proj(x, d, prefix + ".k", 1), [0, h, dh])
    v = layers.reshape(_proj(x, d, prefix + ".v", 1), [0, h, dh])
    layers.kv_cache_write(kc, k, cursor, per_row=False)
    layers.kv_cache_write(vc, v, cursor, per_row=False)
    ctxv = layers.flash_decode(q, kc, vc, lens, sm_scale=1.0 / math.sqrt(dh),
                               per_row=False)
    ctxv = layers.reshape(ctxv, [0, d])
    x = _ln(layers.elementwise_add(x, _proj(ctxv, d, prefix + ".o", 1)),
            prefix + ".ln1", 1)
    m = layers.gelu(_proj(x, cfg.ffn, prefix + ".fc1", 1))
    return _ln(layers.elementwise_add(x, _proj(m, d, prefix + ".fc2", 1)),
               prefix + ".ln2", 1)


def _select_row(x, pos, length):
    """``x[:, pos, :]`` of [B, L, E] as a one-hot [1, L] product."""
    sel = layers.cast(layers.one_hot(pos, length), x.dtype)
    return layers.squeeze(layers.matmul(sel, x), [1])


def _prefill_trunk(prompt, plen, cfg, caches, prompt_len):
    """Embed the [B, L] prompt and run every block, filling the caches;
    the hidden state [B, E] at the last real position (``plen`` - 1)."""
    x = _embed(prompt, cfg, "gpt.wte", cfg.vocab)
    pe = _embed(layers.range(0, prompt_len, 1, "int32"), cfg, "gpt.wpe",
                cfg.max_len)
    x = layers.elementwise_add(x, pe, axis=1)
    for li in range(cfg.layers):
        kc, vc = caches[li]

        def store(k, v, kc=kc, vc=vc):
            layers.kv_cache_prefill(kc, k)
            layers.kv_cache_prefill(vc, v)

        x = _block_full(x, cfg, "gpt.l%d" % li, store)
    x = _ln(x, "gpt.lnf", 2)
    last = layers.increment(layers.assign(plen), value=-1, in_place=True)
    return _select_row(x, last, prompt_len)


def _decode_step(cur, cursor, cfg, caches, lens):
    x = _embed(cur, cfg, "gpt.wte", cfg.vocab)
    pe = _embed(cursor, cfg, "gpt.wpe", cfg.max_len)
    x = layers.elementwise_add(x, pe)
    for li in range(cfg.layers):
        kc, vc = caches[li]
        x = _block_decode(x, cfg, "gpt.l%d" % li, kc, vc, cursor, lens)
    return _logits(_ln(x, "gpt.lnf", 1), cfg)


def _prompt_feeds(batch, prompt_len):
    prompt = layers.data("prompt_ids", shape=[batch, prompt_len],
                         dtype="int32", append_batch_size=False)
    plen = layers.data("prompt_len", shape=[1], dtype="int32",
                       append_batch_size=False)
    return prompt, plen


def build_program(cfg=GPT_TINY, batch=2, prompt_len=8, max_new_tokens=8,
                  strategy="greedy", temperature=1.0, top_k=8, top_p=0.9,
                  seed=0, eos_id=None):
    """The whole generation: the prefill, then ``decode_loop``.  Returns
    ``(main, startup, feeds, tokens, gen_len)``; ``feeds`` are
    ``["prompt_ids", "prompt_len"]`` (ids [B, L] int32, len [1] int32
    <= L) and ``tokens`` is [B, max_new_tokens] int32."""
    main, startup = Program(), Program()
    dh = cfg.hidden // cfg.heads
    with program_guard(main, startup):
        prompt, plen = _prompt_feeds(batch, prompt_len)
        caches = [(layers.create_kv_cache(batch, cfg.heads, cfg.max_len, dh),
                   layers.create_kv_cache(batch, cfg.heads, cfg.max_len, dh))
                  for _ in range(cfg.layers)]
        last_h = _prefill_trunk(prompt, plen, cfg, caches, prompt_len)
        first = layers.sampling(_logits(last_h, cfg), strategy=strategy,
                                k=top_k, p=top_p, temperature=temperature,
                                seed=seed)

        def step(cur, cursor, i):
            lens = layers.increment(layers.assign(cursor), value=1,
                                    in_place=True)
            return _decode_step(cur, cursor, cfg, caches, lens)

        tokens, gen_len = layers.decode_loop(
            step, first, plen, max_new_tokens, eos_id=eos_id,
            strategy=strategy, k=top_k, p=top_p, temperature=temperature,
            seed=seed)
    return main, startup, ["prompt_ids", "prompt_len"], tokens, gen_len


def build_naive_program(cfg=GPT_TINY, batch=2, prompt_len=8,
                        max_new_tokens=8):
    """The A/B baseline without a KV cache: every trip writes its token
    into the [B, max_len] buffer and runs every block over all of it
    (causal), then reads the logits at the cursor.  Greedy."""
    main, startup = Program(), Program()
    t = cfg.max_len
    with program_guard(main, startup):
        prompt, plen = _prompt_feeds(batch, prompt_len)
        pad = layers.fill_constant([batch, t - prompt_len], "int32", 0)
        buf = layers.concat([prompt, pad], axis=1)

        def full_forward(token_buf, pos):
            x = _embed(token_buf, cfg, "gpt.wte", cfg.vocab)
            pe = _embed(layers.range(0, t, 1, "int32"), cfg, "gpt.wpe",
                        cfg.max_len)
            x = layers.elementwise_add(x, pe, axis=1)
            for li in range(cfg.layers):
                x = _block_full(x, cfg, "gpt.l%d" % li)
            x = _ln(x, "gpt.lnf", 2)
            return _logits(_select_row(x, pos, t), cfg)

        last = layers.increment(layers.assign(plen), value=-1, in_place=True)
        first = layers.sampling(full_forward(buf, last), strategy="greedy")

        def step(cur, cursor, i):
            # this token into the buffer at the cursor column, then
            # everything again
            onehot = layers.one_hot(cursor, t)  # [1, T] f32
            keep = layers.cast(layers.scale(onehot, scale=-1.0, bias=1.0),
                               "int32")
            add = layers.cast(onehot, "int32")
            upd = layers.elementwise_add(
                layers.elementwise_mul(buf, keep),
                layers.elementwise_mul(add, layers.unsqueeze(cur, [1])))
            layers.assign(upd, output=buf)
            return full_forward(buf, cursor)

        tokens, gen_len = layers.decode_loop(step, first, plen,
                                             max_new_tokens,
                                             strategy="greedy")
    return main, startup, ["prompt_ids", "prompt_len"], tokens, gen_len


def make_fake_prompt(batch, prompt_len, cfg, rng):
    ids = rng.randint(1, cfg.vocab - 1,
                      size=(batch, prompt_len)).astype("int32")
    return {"prompt_ids": ids,
            "prompt_len": np.array([prompt_len], "int32")}


def run_generate(build, cfg, batch, prompt_len, max_new_tokens, seed=0,
                 place=None):
    """Build with ``build()`` and run one generation twice on the same
    seeded prompts → ``(tokens, gen_len, ttft_s, tokens_per_s)``: TTFT
    is the first run's wall time, the rate the second's.  The startup
    runs with ``random_seed = seed``.  ``place`` defaults to
    ``CUDAPlace(0)``."""
    place = core.CUDAPlace(0) if place is None else place
    unique_name.switch()
    main, startup, _feeds, tokens, gen_len = build()
    startup.random_seed = seed
    exe = Executor(place)
    feed = make_fake_prompt(batch, prompt_len, cfg,
                            np.random.RandomState(seed))
    scope = Scope()
    with scope_guard(scope):
        exe.run(startup)
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[tokens, gen_len])
        ttft = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[tokens, gen_len])
        dt = time.perf_counter() - t0
    total = int(np.sum(out[1]))
    return out[0], out[1], ttft, (total / dt if dt > 0 else 0.0)


class DecodeAdapter:
    """The decoder as a ``serving.DecodeEngine`` model: the ring and
    paged builders share every parameter by ParamAttr name.

    ``init_params`` runs the startup program on a fresh executor with
    ``random_seed = seed``, so every engine built from the same adapter
    (ring, paged, after ``resize``) holds the same weights; then, if a
    ``{name: ndarray}`` dict is given (here or to the constructor), it
    loads those arrays over them with ``convert.load_params_into_scope``
    — how the reference's weights are carried into the port."""

    def __init__(self, cfg=GPT_TINY, max_len=None, seed=0, params=None):
        self.cfg = cfg
        self.max_len = int(max_len or cfg.max_len)
        self.seed = int(seed)
        self.params = params

    def cache_spec(self):
        cfg = self.cfg
        return (cfg.layers, cfg.heads, self.max_len,
                cfg.hidden // cfg.heads)

    def init_params(self, program, startup, exe, scope, params=None):
        from ..convert import load_params_into_scope

        params = self.params if params is None else params
        names = {p.name for p in program.all_parameters()}
        if not params or not names <= set(params):
            startup.random_seed = self.seed
            Executor(exe.place).run(startup, scope=scope)
        if params:
            load_params_into_scope(params, scope, device=exe.place,
                                   program=program)

    # --- shared trunks -------------------------------------------------

    def _trunk_prefill(self, prompt, plen, store):
        cfg = self.cfg
        length = prompt.shape[1]
        d, h = cfg.hidden, cfg.heads
        dh = d // h
        x = _embed(prompt, cfg, "gpt.wte", cfg.vocab)      # [1, L, E]
        pos = layers.range(0, length, 1, "int32")
        pe = _embed(pos, cfg, "gpt.wpe", cfg.max_len)
        x = layers.elementwise_add(x, pe, axis=1)

        def split_heads(t):
            t = layers.reshape(t, [0, 0, h, dh])
            return layers.transpose(t, [0, 2, 1, 3])

        for li in range(cfg.layers):
            prefix = "gpt.l%d" % li
            q = split_heads(_proj(x, d, prefix + ".q", 2))
            k = split_heads(_proj(x, d, prefix + ".k", 2))
            v = split_heads(_proj(x, d, prefix + ".v", 2))
            store(li, k, v)
            ctxv = layers.fused_multihead_attention(
                q, k, v, causal=True, scale=1.0 / math.sqrt(dh))
            ctxv = layers.transpose(ctxv, [0, 2, 1, 3])
            ctxv = layers.reshape(ctxv, [0, 0, d])
            x = _ln(layers.elementwise_add(
                x, _proj(ctxv, d, prefix + ".o", 2)), prefix + ".ln1", 2)
            m = layers.gelu(_proj(x, cfg.ffn, prefix + ".fc1", 2))
            x = _ln(layers.elementwise_add(
                x, _proj(m, d, prefix + ".fc2", 2)), prefix + ".ln2", 2)
        x = _ln(x, "gpt.lnf", 2)
        last = layers.increment(layers.assign(plen), value=-1,
                                in_place=True)
        sel = layers.cast(layers.one_hot(last, length), x.dtype)
        return _logits(layers.squeeze(layers.matmul(sel, x), [1]), cfg)

    def _trunk_step(self, cur, cursors, write, attend):
        cfg = self.cfg
        d, h = cfg.hidden, cfg.heads
        dh = d // h
        x = _embed(cur, cfg, "gpt.wte", cfg.vocab)         # [S, E]
        pe = _embed(cursors, cfg, "gpt.wpe", cfg.max_len)  # [S, E]
        x = layers.elementwise_add(x, pe)

        for li in range(cfg.layers):
            prefix = "gpt.l%d" % li
            q = layers.reshape(_proj(x, d, prefix + ".q", 1), [0, h, dh])
            k = layers.reshape(_proj(x, d, prefix + ".k", 1), [0, h, dh])
            v = layers.reshape(_proj(x, d, prefix + ".v", 1), [0, h, dh])
            write(li, k, v)
            ctxv = layers.reshape(attend(li, q), [0, d])
            x = _ln(layers.elementwise_add(
                x, _proj(ctxv, d, prefix + ".o", 1)), prefix + ".ln1", 1)
            m = layers.gelu(_proj(x, cfg.ffn, prefix + ".fc1", 1))
            x = _ln(layers.elementwise_add(
                x, _proj(m, d, prefix + ".fc2", 1)), prefix + ".ln2", 1)
        x = _ln(x, "gpt.lnf", 1)
        return _logits(x, cfg)

    # --- slot-ring builders -------------------------------------------

    def build_prefill(self, prompt, plen, slot, caches):
        def store(li, k, v):
            kc, vc = caches[li]
            layers.kv_cache_prefill(kc, k, slot=slot)
            layers.kv_cache_prefill(vc, v, slot=slot)

        return self._trunk_prefill(prompt, plen, store)

    def build_step(self, cur, cursors, caches):
        dh = self.cfg.hidden // self.cfg.heads

        def write(li, k, v):
            kc, vc = caches[li]
            layers.kv_cache_write(kc, k, cursors, per_row=True)
            layers.kv_cache_write(vc, v, cursors, per_row=True)

        def attend(li, q):
            kc, vc = caches[li]
            return layers.flash_decode(q, kc, vc, cursors,
                                       sm_scale=1.0 / math.sqrt(dh),
                                       per_row=True)

        return self._trunk_step(cur, cursors, write, attend)

    # --- paged-pool builders ------------------------------------------

    def build_prefill_paged(self, prompt, plen, table, caches):
        def store(li, k, v):
            kc, vc = caches[li]
            layers.paged_kv_cache_prefill(kc, k, plen, table)
            layers.paged_kv_cache_prefill(vc, v, plen, table)

        return self._trunk_prefill(prompt, plen, store)

    def build_step_paged(self, cur, cursors, tables, caches):
        dh = self.cfg.hidden // self.cfg.heads

        def write(li, k, v):
            kc, vc = caches[li]
            layers.paged_kv_cache_write(kc, k, cursors, tables,
                                        per_row=True)
            layers.paged_kv_cache_write(vc, v, cursors, tables,
                                        per_row=True)

        def attend(li, q):
            kc, vc = caches[li]
            return layers.paged_flash_decode(
                q, kc, vc, cursors, tables, sm_scale=1.0 / math.sqrt(dh),
                per_row=True)

        return self._trunk_step(cur, cursors, write, attend)
