"""Continuous-batching autoregressive decode engine (mirrors
``paddle_tpu/serving/decode.py``: ``GenerationConfig`` :73,
``DecodeRequest`` :90, ``DecodeEngine`` :157).

One resident KV cache per layer, ``[slots, H, Tmax, Dh]`` with a
per-slot cursor (``per_row=True`` writes and reads), is carved into
``slots`` independent cache rows.  Two program families share the caches
by (persistable) var name in the engine's private Scope:

* **prefill**, one program per prompt-length bucket: one request's
  padded ``[1, L]`` prompt and its slot; writes K/V rows ``[0, plen)``
  into that slot and returns the first sampled token.  It runs whenever
  a slot is free and a request is queued, between decode steps.
* **decode step**, one program for all slots: the current token and
  cursor of each slot; writes K/V at each slot's depth, attends masked
  to each slot's cursor, samples the next token per slot.

The scheduler thread interleaves them: step the active slots, retire
finished requests, admit queued ones into the freed rows, repeat; the
sampled ``[slots]`` token vector is the one host read per step.  The
cache writes update the resident tensors in place (``ops/decode.py``).

**Paged mode.**  When the model also supplies ``build_prefill_paged`` /
``build_step_paged`` (and ``PADDLE_TPU_PAGED_KV`` is not ``0``), the
cache is a pool ``[num_blocks, H, block_len, Dh]`` with a free-list
(:mod:`.paging`): a stream owns ``ceil(rows / block_len)`` blocks named
by its block table, admission allocates all-or-nothing, and a short pool
queues a request instead of truncating it.  ``block_len`` defaults to
the reference's hand-set 16 (halved until it divides the cache depth);
the reference's autotuned value is not ported.

**Disaggregated prefill** (``disaggregate=True``, paged only): prefill
runs on its own worker thread; a finished prefill hands its request to
the decode scheduler by transferring the block-table entries, the K/V
rows never move.  One executor lock serialises the two threads' device
work.

Not ported yet (ROADMAP.md, Queue A item 3): the reference's telemetry
and tracing spans, and what only its static-analysis gates read (the
co-residency proof's handoff declaration, ``coresident_programs`` and
the tenant-introspection names).
:meth:`DecodeEngine.stats` adds the mean host wall time of a decode step
and of a prefill (run and token read).
"""

import threading
import time

import numpy as np

from .. import core
from .buckets import ShapeBuckets
from .paging import (BlockAllocator, blocks_needed, build_block_table,
                     paged_kv_enabled)

__all__ = ["DecodeEngine", "DecodeRequest", "GenerationConfig"]

DEFAULT_BLOCK_LEN = 16


class GenerationConfig:
    """Sampling knobs a decode tenant applies to every request."""

    __slots__ = ("strategy", "k", "p", "temperature", "seed",
                 "max_new_tokens", "eos_id")

    def __init__(self, strategy="greedy", k=8, p=0.9, temperature=1.0,
                 seed=0, max_new_tokens=64, eos_id=None):
        self.strategy = strategy
        self.k = int(k)
        self.p = float(p)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id


class DecodeRequest:
    """One generation request: a future resolving to ``(tokens, info)``
    — the generated ids (eos included when hit) and
    ``{"generated_len", "ttft_ms", "latency_ms"}``."""

    __slots__ = ("id", "prompt", "enqueue_ts", "_event", "_tokens",
                 "_error", "info", "first_token_ts")

    def __init__(self, rid, prompt):
        self.id = rid
        self.prompt = prompt
        self.enqueue_ts = time.time()
        self._event = threading.Event()
        self._tokens = None
        self._error = None
        self.info = {}
        self.first_token_ts = None

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError("decode request %r not completed within "
                               "%ss" % (self.id, timeout))
        if self._error is not None:
            raise self._error
        return self._tokens, self.info

    def _complete(self, tokens):
        self._tokens = list(tokens)
        self.info["generated_len"] = len(self._tokens)
        self.info["latency_ms"] = (time.time() - self.enqueue_ts) * 1000.0
        if self.first_token_ts is not None:
            self.info["ttft_ms"] = (self.first_token_ts
                                    - self.enqueue_ts) * 1000.0
        self._event.set()

    def _fail(self, exc):
        self._error = exc
        self._event.set()


class _Slot:
    __slots__ = ("request", "cursor", "tokens", "finished", "blocks",
                 "table")

    def __init__(self):
        self.request = None   # None == free cache row
        self.cursor = 0
        self.tokens = []
        self.finished = False
        self.blocks = []      # paged mode: owned KV-pool block ids
        self.table = None     # paged mode: [max_blocks] int32, -1 pad


class DecodeEngine:
    """The decode tenant a :class:`PredictorServer` serves.

    ``model`` supplies the graph builders (sharing parameters by
    ParamAttr name): ``build_prefill(prompt, plen, slot, caches)`` →
    the last real position's logits ``[1, V]`` (writing the prompt's K/V
    into cache row ``slot``); ``build_step(cur, cursors, caches)`` →
    logits ``[slots, V]``; ``cache_spec()`` → ``(layers, heads, max_len,
    head_dim)``; optionally ``init_params(program, startup, exe, scope)``.
    A model that also supplies ``build_prefill_paged(prompt, plen, table,
    caches)`` and ``build_step_paged(cur, cursors, tables, caches)`` runs
    paged unless ``paged=False`` or ``PADDLE_TPU_PAGED_KV=0``.

    ``place`` defaults to ``CUDAPlace(0)`` and raises without CUDA; pass
    ``CPUPlace()`` for the CPU.  The paged pool defaults to ``slots *
    max_len / block_len`` blocks, the rows the ring would hold.
    """

    def __init__(self, model, slots=2, prompt_buckets=(32,),
                 config=None, place=None, name="decode",
                 auto_start=True, paged=None, block_len=None,
                 num_blocks=None, disaggregate=False):
        from ..executor import Executor, Scope

        self.name = name
        self.model = model
        self.slots = int(slots)
        self.config = config or GenerationConfig()
        self.buckets = ShapeBuckets((1,), seq_sizes=prompt_buckets)
        self.scope = Scope()
        self.place = place if place is not None else core.CUDAPlace(0)
        self._exe = Executor(self.place)
        self._layers, self._heads, self.max_len, self._head_dim = \
            model.cache_spec()
        self._cache_names = []
        for li in range(self._layers):
            self._cache_names.append(("%s.kcache.%d" % (name, li),
                                      "%s.vcache.%d" % (name, li)))
        model_paged = (hasattr(model, "build_prefill_paged")
                       and hasattr(model, "build_step_paged"))
        if paged is None:
            paged = paged_kv_enabled() and model_paged
        self.paged = bool(paged)
        if self.paged and not model_paged:
            raise ValueError(
                "paged=True but model %r lacks build_prefill_paged/"
                "build_step_paged" % (type(model).__name__,))
        if self.paged:
            bl = int(block_len) if block_len \
                else _default_block_len(self.max_len)
            if self.max_len % bl != 0:
                raise ValueError(
                    "block_len %d must divide the cache depth %d (the "
                    "full-depth block table is what keeps paged greedy "
                    "bit-identical to the slot ring)" % (bl, self.max_len))
            self.block_len = bl
            self.max_blocks = self.max_len // bl
            self._explicit_blocks = num_blocks is not None
            self.num_blocks = int(num_blocks) if num_blocks \
                else self.slots * self.max_blocks
            self._pool = BlockAllocator(self.num_blocks, self.block_len)
        else:
            self.block_len = None
            self.max_blocks = 0
            self.num_blocks = 0
            self._explicit_blocks = False
            self._pool = None
        self.disaggregate = bool(disaggregate)
        if self.disaggregate and not self.paged:
            raise ValueError("disaggregate=True requires paged KV mode "
                             "(the handoff transfers block-table "
                             "entries, not cache rows)")
        self._handoff = []       # (req, blocks, table, first token)
        self._exe_lock = threading.Lock()
        self._slots = [_Slot() for _ in range(self.slots)]
        self._queue = []
        self._cond = threading.Condition()
        self._running = False
        self._closed = False
        self._resizing = False
        self._admitting = 0
        self._step_count = 0
        self.stats_lock = threading.Lock()
        self._counts = {"submitted": 0, "completed": 0, "failed": 0,
                        "tokens": 0, "prefills": 0}
        self._timing = {"step_s": 0.0, "prefill_s": 0.0}
        self._build_programs()
        if auto_start:
            self.start()

    # ------------------------------------------------------------------
    # graph construction
    # ------------------------------------------------------------------

    def _cache_shape(self):
        if self.paged:
            return [self.num_blocks, self._heads, self.block_len,
                    self._head_dim]
        return [self.slots, self._heads, self.max_len, self._head_dim]

    @property
    def cache_bytes(self):
        """Resident KV bytes (K and V, every layer, float32)."""
        rows = 1
        for d in self._cache_shape():
            rows *= d
        return rows * 4 * 2 * self._layers

    def _declare_caches(self, block):
        """The persistable resident caches, declared in ``block``'s
        program: every program family names the same vars, so they alias
        one tensor in the engine scope."""
        caches = []
        shape = self._cache_shape()
        for kn, vn in self._cache_names:
            k = block.create_var(name=kn, shape=shape, dtype="float32",
                                 persistable=True)
            v = block.create_var(name=vn, shape=shape, dtype="float32",
                                 persistable=True)
            caches.append((k, v))
        return caches

    def _build_programs(self):
        from .. import framework, unique_name

        unique_name.switch()
        init, startup = framework.Program(), framework.Program()
        with framework.program_guard(init, startup):
            for k, v in self._declare_caches(init.global_block()):
                for var in (k, v):
                    _layers().fill_constant(self._cache_shape(), "float32",
                                            0.0, out=var)
        self._init, self._startup = init, startup
        self._prefill = {}
        for length in self.buckets.seq_sizes:
            main = framework.Program()
            with framework.program_guard(main, startup):
                first = self._build_prefill(main.global_block(), length)
            self._prefill[length] = (main, first.name)
        main = framework.Program()
        with framework.program_guard(main, startup):
            nxt = self._build_step(main.global_block())
        self._step_prog, self._step_fetch = main, nxt.name
        #: the program PredictorServer treats as the tenant's hot loop
        self.program = main
        self._exe.run(self._startup, scope=self.scope)
        self._exe.run(self._init, scope=self.scope)
        init_params = getattr(self.model, "init_params", None)
        if init_params is not None:
            init_params(self._step_prog, self._startup, self._exe,
                        self.scope)

    def _sample(self, logits, step=None):
        cfg = self.config
        return _layers().sampling(
            logits, strategy=cfg.strategy, k=cfg.k, p=cfg.p,
            temperature=cfg.temperature, seed=cfg.seed, step=step)

    def _build_prefill(self, block, length):
        layers = _layers()
        prompt = layers.data("prompt_ids", shape=[1, length], dtype="int32",
                             append_batch_size=False)
        plen = layers.data("prompt_len", shape=[1], dtype="int32",
                           append_batch_size=False)
        if self.paged:
            table = layers.data("block_table", shape=[1, self.max_blocks],
                                dtype="int32", append_batch_size=False)
            caches = self._declare_caches(block)
            logits = self.model.build_prefill_paged(prompt, plen, table,
                                                    caches)
        else:
            slot = layers.data("slot", shape=[1], dtype="int32",
                               append_batch_size=False)
            caches = self._declare_caches(block)
            logits = self.model.build_prefill(prompt, plen, slot, caches)
        return self._sample(logits)

    def _build_step(self, block):
        layers = _layers()
        cur = layers.data("cur_ids", shape=[self.slots], dtype="int32",
                          append_batch_size=False)
        cursors = layers.data("cursors", shape=[self.slots], dtype="int32",
                              append_batch_size=False)
        if self.paged:
            tables = layers.data("block_tables",
                                 shape=[self.slots, self.max_blocks],
                                 dtype="int32", append_batch_size=False)
        step = layers.data("step", shape=[1], dtype="int32",
                           append_batch_size=False)
        caches = self._declare_caches(block)
        if self.paged:
            logits = self.model.build_step_paged(cur, cursors, tables,
                                                 caches)
        else:
            logits = self.model.build_step(cur, cursors, caches)
        return self._sample(logits, step)

    # ------------------------------------------------------------------
    # client side
    # ------------------------------------------------------------------

    def submit(self, prompt, request_id=None):
        """Enqueue one prompt (1-D int array); returns the
        :class:`DecodeRequest` future."""
        prompt = np.asarray(prompt, dtype="int32").reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.size > self.max_len - 1:
            raise ValueError("prompt of %d tokens exceeds the cache depth %d"
                             % (prompt.size, self.max_len))
        if self.buckets.bucket_for_seq(prompt.size) is None:
            raise ValueError("prompt of %d tokens exceeds the largest prompt "
                             "bucket (%d)" % (prompt.size,
                                              self.buckets.seq_sizes[-1]))
        if self.paged:
            need = self._blocks_for_len(prompt.size)
            if need > self.num_blocks:
                raise ValueError(
                    "prompt + generation budget needs %d KV blocks but the "
                    "pool holds %d (block_len=%d) — it could never be "
                    "admitted" % (need, self.num_blocks, self.block_len))
        with self._cond:
            if self._closed:
                raise RuntimeError("decode engine is closed")
            rid = request_id if request_id is not None \
                else len(self._queue) + self._counts["submitted"]
            req = DecodeRequest(rid, prompt)
            self._queue.append(req)
            self._count("submitted")
            self._cond.notify()
        return req

    # ------------------------------------------------------------------
    # scheduler
    # ------------------------------------------------------------------

    def start(self):
        with self._cond:
            if self._closed:
                raise RuntimeError("decode engine is closed")
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="paddle_tpu_torch-decode-%s" % self.name)
        self._thread.start()
        if self.disaggregate:
            self._prefill_thread = threading.Thread(
                target=self._prefill_loop, daemon=True,
                name="paddle_tpu_torch-prefill-%s" % self.name)
            self._prefill_thread.start()
        return self

    def close(self, timeout=60.0):
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        for attr in ("_thread", "_prefill_thread"):
            t = getattr(self, attr, None)
            if t is not None:
                t.join(timeout)
                setattr(self, attr, None)

    def resize(self, slots, timeout=60.0):
        """Change the slot count: hold admissions, let in-flight
        generations finish, then rebuild the caches and both program
        families at the new count and resume.  Only free slots exist at
        the rebuild, so no per-slot state moves."""
        slots = int(slots)
        if slots < 1:
            raise ValueError("slots must be >= 1, got %d" % slots)
        if slots == self.slots:
            return self.slots
        with self._cond:
            if self._closed:
                raise RuntimeError("decode engine is closed")
            if self._resizing:
                raise RuntimeError("a resize is already in progress")
            self._resizing = True
        try:
            deadline = time.time() + timeout
            while True:
                with self._cond:
                    if (not self._active() and self._admitting == 0
                            and not self._handoff):
                        break
                if time.time() > deadline:
                    raise TimeoutError(
                        "decode engine %r did not drain to idle within "
                        "%.1fs for resize" % (self.name, timeout))
                time.sleep(0.01)
            self.slots = slots
            self._slots = [_Slot() for _ in range(slots)]
            if self.paged:
                if not self._explicit_blocks:
                    self.num_blocks = slots * self.max_blocks
                self._pool = BlockAllocator(self.num_blocks, self.block_len)
            self._build_programs()
        finally:
            with self._cond:
                self._resizing = False
                self._cond.notify_all()
        return self.slots

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _active(self):
        return [s for s in self._slots if s.request is not None]

    def _work_ready(self):
        if self.disaggregate:
            # queued requests belong to the prefill worker
            return bool(self._handoff) or bool(self._active())
        return bool(self._queue) or bool(self._active())

    def _drained(self):
        return (not self._queue and not self._handoff
                and self._admitting == 0 and not self._active())

    def _blocks_for_len(self, prompt_len):
        """Blocks to reserve at admission: the whole prompt plus the full
        generation budget, all-or-nothing."""
        rows = min(int(prompt_len) + self.config.max_new_tokens,
                   self.max_len)
        return blocks_needed(rows, self.block_len)

    def _fail_all(self, exc):
        with self._cond:  # fail everything pending; never strand a caller
            self._closed = True
            pending = self._queue
            self._queue = []
            pending.extend(rec[0] for rec in self._handoff)
            self._handoff = []
            self._cond.notify_all()
        for s in self._slots:
            if s.request is not None:
                pending.append(s.request)
                s.request = None
        for r in pending:
            if not r.done():
                r._fail(exc)
                self._count("failed")

    def _loop(self):
        try:
            while True:
                with self._cond:
                    while not self._work_ready():
                        if self._closed and self._drained():
                            return
                        self._cond.wait(0.05)
                self._admit()
                if self._active():
                    self._step()
                elif self._resizing:
                    time.sleep(0.005)
        except Exception as exc:  # noqa: BLE001
            self._fail_all(exc)

    def _run_prefill(self, req, table=None, slot=None):
        """The bucketed prefill program for ``req``; returns the first
        sampled token.  Ring mode feeds the slot, paged mode the table."""
        length = self.buckets.bucket_for_seq(req.prompt.size)
        padded = np.zeros((1, length), dtype="int32")
        padded[0, :req.prompt.size] = req.prompt
        main, fetch = self._prefill[length]
        feed = {"prompt_ids": padded,
                "prompt_len": np.asarray([req.prompt.size], "int32")}
        if self.paged:
            feed["block_table"] = table.reshape(1, self.max_blocks)
        else:
            feed["slot"] = np.asarray([slot], "int32")
        t0 = time.perf_counter()
        with self._exe_lock:
            out = self._exe.run(main, feed=feed, fetch_list=[fetch],
                                scope=self.scope)
        self._time("prefill_s", time.perf_counter() - t0, "prefills")
        return int(np.asarray(out[0]).reshape(-1)[0])

    def _activate(self, free, req, first, blocks, table):
        with self._cond:
            slot = self._slots[free]
            slot.request = req
            slot.cursor = int(req.prompt.size)
            slot.tokens = [first]
            slot.finished = (self.config.eos_id is not None
                             and first == self.config.eos_id)
            slot.blocks = blocks
            slot.table = table
            self._cond.notify_all()

    def _admit(self):
        """Fill free cache rows from the queue, one prefill per
        admission, between decode steps; disaggregated mode instead
        activates the prefill worker's finished handoffs."""
        if self.disaggregate:
            self._drain_handoffs()
            return
        while True:
            free = next((i for i, s in enumerate(self._slots)
                         if s.request is None), None)
            with self._cond:
                if self._resizing or free is None or not self._queue:
                    return
                if self.paged:
                    need = self._blocks_for_len(self._queue[0].prompt.size)
                    if not self._pool.can_allocate(need):
                        return  # backpressure: wait for a retirement
                    blocks = self._pool.allocate(need)
                else:
                    blocks = []
                req = self._queue.pop(0)
                self._admitting += 1
            table = build_block_table(blocks, self.max_blocks) \
                if self.paged else None
            first = self._run_prefill(req, table=table, slot=free)
            req.first_token_ts = time.time()
            self._activate(free, req, first, blocks, table)
            with self._cond:
                self._admitting -= 1
                self._cond.notify_all()

    def _drain_handoffs(self):
        """Activate finished prefills: the KV-pool blocks change owner
        from the prefill worker to a decode slot; the rows stay put."""
        while True:
            free = next((i for i, s in enumerate(self._slots)
                         if s.request is None), None)
            with self._cond:
                if free is None or not self._handoff:
                    return
                req, blocks, table, first = self._handoff.pop(0)
            self._activate(free, req, first, blocks, table)

    def _prefill_loop(self):
        """Disaggregated-prefill worker: allocates the request's blocks,
        prefills through the table, then posts the handoff."""
        try:
            while True:
                with self._cond:
                    while True:
                        if self._closed and not self._queue:
                            return
                        if (self._queue and not self._resizing
                                and self._pool.can_allocate(
                                    self._blocks_for_len(
                                        self._queue[0].prompt.size))):
                            break
                        self._cond.wait(0.05)
                    req = self._queue.pop(0)
                    blocks = self._pool.allocate(
                        self._blocks_for_len(req.prompt.size))
                    self._admitting += 1
                table = build_block_table(blocks, self.max_blocks)
                first = self._run_prefill(req, table=table)
                req.first_token_ts = time.time()
                with self._cond:
                    self._handoff.append((req, blocks, table, first))
                    self._admitting -= 1
                    self._cond.notify_all()
        except Exception as exc:  # noqa: BLE001
            self._fail_all(exc)

    def _step(self):
        """One decode step for every active slot, then retire finished
        requests so their cache rows free up."""
        cur = np.zeros((self.slots,), dtype="int32")
        cursors = np.zeros((self.slots,), dtype="int32")
        active = []
        for i, s in enumerate(self._slots):
            if s.request is not None and not s.finished:
                cur[i] = s.tokens[-1]
                cursors[i] = s.cursor
                active.append(i)
        if active:
            feed = {"cur_ids": cur, "cursors": cursors}
            if self.paged:
                tables = np.full((self.slots, self.max_blocks), -1,
                                 dtype="int32")
                for i in active:
                    tables[i] = self._slots[i].table
                feed["block_tables"] = tables
            self._step_count += 1
            feed["step"] = np.asarray([self._step_count], "int32")
            t0 = time.perf_counter()
            with self._exe_lock:
                out = self._exe.run(self._step_prog, feed=feed,
                                    fetch_list=[self._step_fetch],
                                    scope=self.scope)
            self._time("step_s", time.perf_counter() - t0)
            nxt = np.asarray(out[0]).reshape(-1)
            self._count("tokens", len(active))
            for i in active:
                s = self._slots[i]
                tok = int(nxt[i])
                s.tokens.append(tok)
                s.cursor += 1
                if self.config.eos_id is not None \
                        and tok == self.config.eos_id:
                    s.finished = True
        # retire: eos, generation budget, or cache depth exhausted
        for s in self._slots:
            if s.request is None:
                continue
            full = (len(s.tokens) >= self.config.max_new_tokens
                    or s.cursor >= self.max_len - 1)
            if s.finished or full:
                req = s.request
                s.request = None
                if self.paged and s.blocks:
                    with self._cond:
                        self._pool.free(s.blocks)
                        self._cond.notify_all()  # wake admission
                    s.blocks = []
                    s.table = None
                req._complete(s.tokens)
                self._count("completed")

    def _count(self, key, n=1):
        with self.stats_lock:
            self._counts[key] += n

    def _time(self, key, seconds, count=None):
        with self.stats_lock:
            self._timing[key] += seconds
            if count is not None:
                self._counts[count] += 1

    def stats(self):
        with self.stats_lock:
            counts = dict(self._counts)
            timing = dict(self._timing)
        with self._cond:
            counts["queue_depth"] = len(self._queue)
            counts["handoff_depth"] = len(self._handoff)
            free = self._pool.num_free if self.paged else 0
        counts["active_slots"] = len(self._active())
        counts["slots"] = self.slots
        counts["prompt_buckets"] = list(self.buckets.seq_sizes)
        counts["decode_steps"] = self._step_count
        counts["paged"] = self.paged
        counts["disaggregated"] = self.disaggregate
        counts["kv_cache_bytes"] = self.cache_bytes
        counts["step_ms_mean"] = (timing["step_s"] * 1e3 / self._step_count
                                  if self._step_count else None)
        counts["prefill_ms_mean"] = (timing["prefill_s"] * 1e3
                                     / counts["prefills"]
                                     if counts["prefills"] else None)
        if self.paged:
            counts["block_len"] = self.block_len
            counts["kv_blocks_total"] = self._pool.num_blocks
            counts["kv_blocks_free"] = free
            counts["kv_pool_occupancy"] = \
                1.0 - free / float(self._pool.num_blocks)
        return counts


def _default_block_len(max_len):
    """The reference's hand-set block length, halved until it divides
    the cache depth (``paged_block_len`` without the autotune cache)."""
    bl = min(DEFAULT_BLOCK_LEN, int(max_len))
    while int(max_len) % bl:
        bl //= 2
    return max(bl, 1)


def _layers():
    from .. import layers

    return layers

