"""Speculative decoding over the paged serving tier (mirrors
``paddle_tpu/serving/speculative.py``: ``ngram_draft`` :45,
``_ModelDraft`` :60, ``SpeculativeDecoder`` :140).

The target model's paged step program already is a verifier: it takes
``k+1`` independent rows, writes every row's K/V through the block table
before the attention reads, and masks row ``i`` to its own cursor.  So
feeding ``[last_emitted, d_1 .. d_k]`` with cursors ``c, c+1 .. c+k``
and the same block table on every row scores the whole draft window in
one step: row ``i``'s greedy output ``g_i`` is the token the target
would have produced after ``prefix + d_1 .. d_{i-1}``.  On the card that
step is one K6 paged flash-decode launch per layer at ``k+1`` rows
(``ops/cuda/paged_flash_decode.py``).

Acceptance is exact prefix-match greedy: keep ``d_i`` while
``d_i == g_i``, then emit the target's own correction ``g_{a+1}`` as the
bonus token, so the emitted stream equals plain greedy decoding whatever
the draft proposes; the draft only moves the speed.  A rejected tail
needs no cache surgery: the cursor resets and the stale positions are
masked until the next round overwrites them in place.

Drafts:

* ``draft="ngram"``: prompt lookup on the host, the continuation of the
  most recent earlier occurrence of the current last token.
* ``draft=<paged model>``: a draft-model tenant with its own
  :class:`DecodeEngine` (``slots=1``), scope and KV pool; confirmed
  tokens are streamed into its cache and proposals come from its own
  greedy chain ``k`` steps ahead, rolled back by resetting the cursor.
* ``draft=<callable>``: ``f(context_tokens, k) -> [k] ints``.

Telemetry: the ``spec_tokens_proposed_total`` /
``spec_tokens_accepted_total`` counters and the ``spec_acceptance_rate``
gauge (``observability.runtime.record_spec_round``).  ``place`` defaults
to ``CUDAPlace(0)``, as the engine's; pass ``CPUPlace()`` for the CPU.
"""

import numpy as np

from ..observability import runtime as _obs
from .decode import DecodeEngine, GenerationConfig
from .paging import blocks_needed, build_block_table

__all__ = ["SpeculativeDecoder", "ngram_draft"]


def ngram_draft(context, k):
    """Prompt-lookup draft: continuation of the most recent earlier
    occurrence of the last token; padded by repeating the tail."""
    context = [int(t) for t in context]
    last = context[-1] if context else 0
    prop = []
    for i in range(len(context) - 2, -1, -1):
        if context[i] == last:
            prop = context[i + 1:i + 1 + k]
            break
    while len(prop) < k:
        prop.append(prop[-1] if prop else last)
    return prop[:k]


class _ModelDraft:
    """The draft-model tenant: slots=1 paged engine driven manually.

    ``propose(confirmed)`` first streams the not-yet-ingested
    confirmed tokens through the draft's step program (each run writes
    that token's K/V and returns the draft's greedy next token), then
    rolls its own chain ``k`` ahead; the chain's writes are
    speculative and undone by resetting the cursor — the next
    confirmed ingestion overwrites the same positions."""

    def __init__(self, engine, k):
        self.eng = engine
        self.k = k
        self.blocks = None
        self.table = None
        self.cursor = 0
        self.ingested = 0
        self.pred = None
        self._steps = 0

    def start(self, prompt, max_new):
        eng = self.eng
        n = int(prompt.size)
        rows = min(n + max_new + self.k + 1, eng.max_len)
        self.blocks = eng._pool.allocate(
            blocks_needed(rows, eng.block_len))
        self.table = build_block_table(self.blocks, eng.max_blocks)
        L = eng.buckets.bucket_for_seq(n)
        if L is None:
            raise ValueError(
                "prompt of %d tokens exceeds the draft model's largest "
                "prompt bucket (%d)" % (n, eng.buckets.seq_sizes[-1]))
        padded = np.zeros((1, L), dtype="int32")
        padded[0, :n] = prompt
        main, fetch = eng._prefill[L]
        out = eng._exe.run(
            main,
            feed={"prompt_ids": padded,
                  "prompt_len": np.asarray([n], "int32"),
                  "block_table": self.table.reshape(1, -1)},
            fetch_list=[fetch], scope=eng.scope)
        self.pred = int(np.asarray(out[0]).reshape(-1)[0])
        self.cursor = n
        self.ingested = 0
        self._prompt_len = n

    def _step(self, token):
        eng = self.eng
        self._steps += 1
        out = eng._exe.run(
            eng._step_prog,
            feed={"cur_ids": np.asarray([token], "int32"),
                  "cursors": np.asarray([self.cursor], "int32"),
                  "block_tables": self.table.reshape(1, -1),
                  "step": np.asarray([self._steps], "int32")},
            fetch_list=[eng._step_fetch], scope=eng.scope)
        self.cursor += 1
        return int(np.asarray(out[0]).reshape(-1)[0])

    def propose(self, context, k):
        confirmed = context[self._prompt_len:]
        for t in confirmed[self.ingested:]:
            if self.cursor >= self.eng.max_len - 1:
                break
            self.pred = self._step(int(t))
            self.ingested += 1
        drafts, cur = [], self.pred
        save = self.cursor
        for i in range(k):
            drafts.append(cur)
            if i + 1 < k and self.cursor < self.eng.max_len - 1:
                cur = self._step(cur)
        self.cursor = save  # roll back the speculative chain
        return drafts

    def finish(self):
        if self.blocks:
            self.eng._pool.free(self.blocks)
            self.blocks = None


class SpeculativeDecoder:
    """Single-stream speculative greedy generation over a paged model.

    Wraps a :class:`DecodeEngine` built with ``slots = k+1`` (never
    started — the decoder drives the programs directly): the engine's
    paged step program doubles as the multi-query-row verifier.
    ``generate`` returns ``(tokens, info)`` with the emitted stream
    bit-identical to plain greedy decoding of the same model."""

    def __init__(self, model, draft="ngram", k=4, prompt_buckets=(32,),
                 config=None, place=None, name="spec", block_len=None,
                 num_blocks=None):
        self.k = int(k)
        if self.k < 1:
            raise ValueError("k must be >= 1, got %d" % k)
        self.name = name
        self.config = config or GenerationConfig()
        if self.config.strategy != "greedy":
            raise ValueError(
                "speculative decoding is exact for greedy sampling "
                "only; got strategy=%r" % (self.config.strategy,))
        self._eng = DecodeEngine(
            model, slots=self.k + 1, prompt_buckets=prompt_buckets,
            config=self.config, place=place, name=name,
            auto_start=False, paged=True, block_len=block_len,
            num_blocks=num_blocks)
        self._draft_fn = None
        self._draft = None
        if callable(draft):
            self._draft_fn = draft
        elif draft == "ngram":
            self._draft_fn = ngram_draft
        else:
            deng = DecodeEngine(
                draft, slots=1, prompt_buckets=prompt_buckets,
                config=self.config, place=place,
                name="%s.draft" % name, auto_start=False, paged=True)
            self._draft = _ModelDraft(deng, self.k)

    @property
    def engine(self):
        return self._eng

    def coresident_programs(self):
        """Target + draft-tenant program families for the co-residency
        proof (the draft engine has its own scope and cache names, so
        the proof shows NO overlap — they could share a chip)."""
        progs = list(self._eng.coresident_programs())
        if self._draft is not None:
            progs.extend(self._draft.eng.coresident_programs())
        return progs

    def close(self):
        self._eng.close()
        if self._draft is not None:
            self._draft.eng.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def generate(self, prompt, max_new_tokens=None):
        eng = self._eng
        k = self.k
        prompt = np.asarray(prompt, dtype="int32").reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.config.max_new_tokens)
        L = eng.buckets.bucket_for_seq(prompt.size)
        if L is None:
            raise ValueError(
                "prompt of %d tokens exceeds the largest prompt "
                "bucket (%d)" % (prompt.size, eng.buckets.seq_sizes[-1]))
        rows = int(prompt.size) + max_new + k
        if rows > eng.max_len:
            raise ValueError(
                "prompt (%d) + generation budget (%d) + draft window "
                "(%d) exceeds the cache depth %d — shrink k or "
                "max_new_tokens" % (prompt.size, max_new, k,
                                    eng.max_len))
        blocks = eng._pool.allocate(blocks_needed(rows, eng.block_len))
        if self._draft is not None:
            self._draft.start(prompt, max_new)
        try:
            return self._generate(prompt, max_new, L, blocks)
        finally:
            eng._pool.free(blocks)
            if self._draft is not None:
                self._draft.finish()

    def _propose(self, context):
        if self._draft is not None:
            return self._draft.propose(context, self.k)
        return list(self._draft_fn(context, self.k))[:self.k]

    def _generate(self, prompt, max_new, L, blocks):
        eng, k = self._eng, self.k
        table = build_block_table(blocks, eng.max_blocks)
        padded = np.zeros((1, L), dtype="int32")
        padded[0, :prompt.size] = prompt
        main, fetch = eng._prefill[L]
        out = eng._exe.run(
            main,
            feed={"prompt_ids": padded,
                  "prompt_len": np.asarray([prompt.size], "int32"),
                  "block_table": table.reshape(1, -1)},
            fetch_list=[fetch], scope=eng.scope)
        first = int(np.asarray(out[0]).reshape(-1)[0])
        tokens = [first]
        cursor = int(prompt.size)
        context = [int(t) for t in prompt]
        eos = self.config.eos_id
        done = eos is not None and first == eos
        tables = np.repeat(table.reshape(1, -1), k + 1, axis=0)
        rounds = proposed = accepted = 0
        while not done and len(tokens) < max_new:
            drafts = self._propose(context + tokens)
            if len(drafts) != k:
                raise ValueError("draft proposed %d tokens, expected "
                                 "%d" % (len(drafts), k))
            cur = np.empty((k + 1,), dtype="int32")
            cur[0] = tokens[-1]
            cur[1:] = drafts
            cursors = (cursor
                       + np.arange(k + 1, dtype="int32"))
            rounds += 1
            out = eng._exe.run(
                eng._step_prog,
                feed={"cur_ids": cur, "cursors": cursors,
                      "block_tables": tables,
                      "step": np.asarray([rounds], "int32")},
                fetch_list=[eng._step_fetch], scope=eng.scope)
            g = np.asarray(out[0]).reshape(-1)
            a = 0
            while a < k and int(drafts[a]) == int(g[a]):
                a += 1
            proposed += k
            accepted += a
            _obs.record_spec_round(self.name, k, a)
            for i in range(a + 1):
                tokens.append(int(g[i]))
                cursor += 1
                if eos is not None and tokens[-1] == eos:
                    done = True
                    break
                if len(tokens) >= max_new:
                    break
        info = {"generated_len": len(tokens), "rounds": rounds,
                "proposed": proposed, "accepted": accepted,
                "acceptance_rate":
                    accepted / float(proposed) if proposed else 0.0}
        return tokens, info
