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
the same step is not among them.  ``build_program`` and
``build_naive_program`` (the single-program generation loop) need the
``While`` op and raise until it is ported.
"""

import math

from .. import layers
from ..executor import Executor
from ..param_attr import ParamAttr

__all__ = ["GPTConfig", "GPT_TINY", "GPT2_SMALL_WIDTHS", "DecodeAdapter",
           "build_program", "build_naive_program"]


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


def _needs_while(what):
    raise NotImplementedError(
        "%s builds the single-program generation loop, which needs the "
        "While op (ROADMAP.md, Queue A item 5: decode); serve the model "
        "through serving.DecodeEngine with DecodeAdapter" % what)


def build_program(*args, **kwargs):
    """The reference's prefill + ``decode_loop`` program: not ported."""
    _needs_while("build_program")


def build_naive_program(*args, **kwargs):
    """The reference's no-cache A/B program: not ported."""
    _needs_while("build_naive_program")


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
