"""Serving engine: continuous batching over contiguous or paged KV (the
decoder-only part of ``repro.runtime.engine``).

A fixed decode batch of ``n_slots``; each slot holds one request and its
own position, and one batched decode step advances every slot.  Two
cache backends behind one interface:

* **contiguous** (the default): each slot owns a ``max_seq``-slot ring
  region in every layer (``models.layers`` ring caches).
* **paged**: all slots share one pool of fixed-size KV pages addressed
  through per-request block tables
  (``repro_torch.runtime.paged_cache``); when the pool runs dry the
  scheduler preempts a victim and re-queues it, and the resumed request
  re-prefills its context and continues with identical greedy tokens.

Prefill, on either backend by default, is **whole-prompt**: a request's
context is left-padded to the smallest of ``prefill_buckets`` that
holds it (position -1 on the padding) and prefilled in one pass, whose
caches are spliced into the slot's ring row or scattered into its
pages.  With ``chunked_prefill=True`` (paged only) admission instead
reserves the prompt's pages and sets a *chunk frontier*; each tick
advances at most ``prefill_chunks_per_tick`` chunks of
``prefill_chunk`` tokens — one fused scatter+attend kernel call per
layer — and then decodes the slots that are decoding (mid-prefill slots
masked out: block-table rows -1, context lengths 0).

With ``prefix_sharing=True`` (paged only) requests whose context starts
with pages another request has already filled attach those pages
copy-on-write instead of allocating and writing their own
(``runtime.paged_cache.PrefixCache``).  Under chunked prefill the
chunks those pages cover are skipped outright, including pages a
cohort peer registers while this request is mid-prefill;
``prefix_retain_pages`` keeps up to that many freed prefix pages in an
LRU so a later same-prefix request still hits after its cohort drained.

:meth:`Engine.tick` publishes typed events (``repro_torch.runtime.events``)
as they happen (:meth:`Engine.subscribe`, :meth:`Engine.event_queue`);
:meth:`Engine.run` drives ticks until the work drains;
:meth:`Engine.cancel` aborts a request wherever it is.

A recurrent block (rglru, mlstm, slstm) keeps its state per decode slot
on either backend: a whole-prompt prefill splices it into the slot, and
a preempted request rebuilds it by prefilling its whole context again.
Chunked prefill does not carry recurrent state across chunks, so the
constructor refuses it for such models with the reference's
``ValueError``.  A paged model with recurrent blocks alone (xLSTM) has
no page pool on the device, yet its requests hold pages in the block
tables and are admitted, preempted and freed by them, as in the
reference.  A vision model (llava) is served on text alone, as the
reference's engine serves it: no request carries ``vision_embeds``.  An
encoder-decoder model is refused with ``NotImplementedError``
(``refuse_enc_dec``): the reference's engine cannot serve it either.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import index
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.runtime.events import (EventBus, ExpireEvent, FinishEvent,
                                        PreemptEvent, TokenEvent)
from repro_torch.runtime.metrics import EngineMetrics
from repro_torch.runtime.paged_cache import (BlockTables, PagePool,
                                             PrefixCache, pages_for_tokens)
from repro_torch.runtime.scheduler import DEFAULT_CLASS, Scheduler

Tree = Any


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (S,) int32
    max_new: int = 32
    temperature: float = 0.0
    priority: str = DEFAULT_CLASS
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    expired: bool = False               # deadline passed while queued
    cancelled: bool = False             # aborted via Engine.cancel
    preemptions: int = 0
    deadline_t: Optional[float] = None  # absolute (scheduler clock)
    admit_seq: int = 0                  # set by the scheduler on admit
    prompt_cap: Optional[int] = None    # engine's max prefill length

    def n_prompt_tokens(self) -> int:
        """Tokens a (re-)prefill must cover: the prompt plus any tokens
        already generated before a preemption (minus the pending one)."""
        n = len(self.prompt) + max(0, len(self.out_tokens) - 1)
        return min(n, self.prompt_cap) if self.prompt_cap is not None else n


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for the CPU.  A CUDA request without a card raises; nothing falls
    back to the CPU on its own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available; pass device='cpu' to run on the CPU")
    return device


class _ContiguousBackend:
    """Per-slot ring regions of ``max_seq`` slots in every layer (bf16,
    as the reference's)."""

    name = "contiguous"
    page_size = 1                       # no page budget: see free_pages
    prefix = None                       # sharing lives in the page pool

    def __init__(self, eng: "Engine"):
        self.eng = eng
        self.caches = M.init_caches(eng.cfg, eng.n_slots, eng.max_seq,
                                    device=eng.device)

    def check_request(self, n_tokens: int) -> None:
        """Every request fits: its slot's region covers max_seq."""

    def free_pages(self) -> Optional[int]:
        return None                     # slots reserve max_seq up front

    def page_util(self) -> Optional[float]:
        return None

    def splice(self, slot: int, cache1, n_tokens: int,
               seq: Optional[np.ndarray] = None,
               shared: Optional[list] = None) -> None:
        self.caches = M.splice_prefill(self.eng.cfg, self.caches, cache1,
                                       slot)

    def ensure_capacity(self, slot: int, pos: int) -> bool:
        return True                     # the region covers max_seq

    def release(self, slot: int) -> int:
        return 0                        # the next splice overwrites it

    def decode(self, params, toks: np.ndarray, pos: np.ndarray,
               active: Optional[np.ndarray] = None) -> torch.Tensor:
        """One decode step over every slot, empty ones included (their
        rows are rewritten whole by the next splice).  ``active`` is
        always None here: only chunked prefill, which is paged, leaves
        slots mid-prefill."""
        dev = self.eng.device
        logits, self.caches = M.decode_step(
            self.eng.cfg, params, torch.from_numpy(toks).to(dev),
            torch.from_numpy(pos).to(dev), self.caches, self.eng.max_seq)
        return logits


class _PagedBackend:
    """Shared page pool + per-slot block tables (see paged_cache.py)."""

    name = "paged"

    def __init__(self, eng: "Engine", page_size: int, pool_pages: int,
                 cache_dtype, prefix_sharing: bool = False,
                 prefix_retain_pages: int = 0):
        self.eng = eng
        self.pool = PagePool(pool_pages, page_size)
        self.tables = BlockTables(self.pool, eng.n_slots,
                                  pages_for_tokens(eng.max_seq, page_size))
        self.prefix = (PrefixCache(self.pool,
                                   retain_pages=prefix_retain_pages)
                       if prefix_sharing else None)
        # admission-hint memo: rid -> matched pages, valid for one
        # (registry writes, pool frees) version — a blocked head is
        # hashed once, not once per tick, and splice reuses the pages
        self._hint_cache: Dict[int, list] = {}
        self._hint_ver = None
        self.caches = M.init_paged_caches(eng.cfg, pool_pages, page_size,
                                          dtype=cache_dtype,
                                          device=eng.device,
                                          n_slots=eng.n_slots)
        self.prefill_chunk_calls = 0
        self.prefill_kv_read_bytes = 0

    @property
    def page_size(self) -> int:
        return self.pool.page_size

    def check_request(self, n_tokens: int) -> None:
        """Refuse a request whose ``n_tokens`` (prompt plus new tokens,
        capped at max_seq) need more pages than the whole pool."""
        need = pages_for_tokens(n_tokens, self.page_size)
        if need > self.pool.num_pages:
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self.pool.num_pages}; grow --pool-pages")

    def free_pages(self) -> int:
        """Admission headroom: the free list plus whatever the prefix
        retention LRU could evict on demand (the pool's pressure hook
        reclaims those inside ``alloc`` when the free list falls
        short)."""
        free = self.pool.free_pages
        if self.prefix is not None and self.prefix.retain_pages > 0:
            free += self.prefix.evictable()
        return free

    def page_util(self) -> float:
        return self.pool.pages_in_use / self.pool.num_pages

    def shared_page_hint(self, rid: int, seq: np.ndarray) -> int:
        """Pages a prefix-cache attach would save for ``seq`` right now
        (admission accounting: the scheduler subtracts them from the
        head's page need).  Registry state cannot change between this
        hint and the attach in ``splice`` / ``_start_chunked`` — both
        happen inside the same host-side admission pass — so the matched
        pages are memoized by rid and the attach reuses them instead of
        re-hashing the prompt.  The memo survives across ticks until any
        registry write or page free (only those can change a match), so
        a queued head blocked on free pages is hashed once.

        With retention on, matched pages whose ONLY holder is the
        retention LRU are not discounted: :meth:`free_pages` already
        counts them as evictable headroom, and the attach pins them
        (refcount 2), so discounting them too would count them twice
        and admit a head whose remaining pages cannot be allocated.
        Refcounts are re-read on every call (they move without a free
        event)."""
        if self.prefix is None:
            return 0
        ver = (self.prefix.writes, self.pool.free_events)
        if ver != self._hint_ver:
            self._hint_cache.clear()
            self._hint_ver = ver
        if rid not in self._hint_cache:
            self._hint_cache[rid] = self.prefix.match(seq)
        pages = self._hint_cache[rid]
        if self.prefix.retain_pages > 0:
            return len(pages) - sum(1 for p in pages
                                    if self.pool.refcount(p) == 1)
        return len(pages)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.eng.device)

    def _apply_cow(self) -> None:
        pairs = self.tables.drain_copies()
        if pairs:
            src = self._dev(np.asarray([s for s, _ in pairs]))
            dst = self._dev(np.asarray([d for _, d in pairs]))
            self.caches = M.copy_pages(self.eng.cfg, self.caches, src, dst)

    def splice(self, slot: int, cache1, n_tokens: int,
               seq: Optional[np.ndarray] = None,
               shared: Optional[list] = None) -> None:
        """Scatter a whole-prompt prefill cache into ``slot``'s pages
        (reserved here for its ``n_tokens``).  Under prefix sharing the
        pages of ``shared`` (the admission hint; matched here when there
        is none) are attached first, and ``slot``'s full pages are
        registered after the write."""
        if self.prefix is not None and seq is not None:
            if shared is None:          # no admission hint: match here
                shared = self.prefix.match(seq)
            self.prefix.count_attach(len(shared))
            if shared:
                self.tables.fork(slot, shared)
        if not self.tables.ensure_blocks(
                slot, pages_for_tokens(n_tokens, self.page_size)):
            raise RuntimeError("admission must reserve prompt pages first")
        self._apply_cow()
        # shared (forked) blocks are -1 in the writable row: the scatter
        # drops those writes — the pages already hold these tokens' K/V
        bt_row = self._dev(self.tables.writable_row(slot))
        self.caches = M.splice_prefill_paged(self.eng.cfg, self.caches,
                                             cache1, slot, bt_row)
        if self.prefix is not None and seq is not None:
            self.prefix.register(seq, self.tables.owned(slot))

    def ensure_capacity(self, slot: int, pos: int) -> bool:
        return self.tables.ensure_for_position(slot, pos)

    def release(self, slot: int) -> int:
        return self.tables.release(slot)

    def decode(self, params, toks: np.ndarray, pos: np.ndarray,
               active: Optional[np.ndarray] = None) -> torch.Tensor:
        """One batched decode step.  ``active`` (bool (n_slots,) or None)
        masks slots that must not decode this tick — mid-prefill slots:
        their block-table rows go to -1 (the page write lands on the
        dump page) and their context lengths to 0 (zero output)."""
        self._apply_cow()
        bt = self.tables.as_array()
        lens = self.tables.context_lens()
        if active is not None:
            bt = np.where(active[:, None], bt, -1)
            lens = np.where(active, lens, 0)
        logits, self.caches = M.decode_step_paged(
            self.eng.cfg, params, self._dev(toks), self._dev(pos),
            self.caches, self._dev(bt), self._dev(lens))
        return logits

    def prefill_chunk(self, params, toks: np.ndarray, slot: int, start: int,
                      length: int) -> torch.Tensor:
        """Advance ``slot``'s prefill by one chunk; returns the logits
        (1, V) at the chunk's last live row."""
        self._apply_cow()
        bt_read = self._dev(self.tables.as_array()[slot])
        bt_write = self._dev(self.tables.writable_row(slot))
        logits, self.caches = M.prefill_step_paged(
            self.eng.cfg, params, self._dev(toks), self.caches, bt_read,
            bt_write, start, length)
        self.prefill_chunk_calls += 1
        cfg = self.eng.cfg
        self.prefill_kv_read_bytes += cfg.n_layers * \
            index.paged_prefill_read_bytes(start, length, self.page_size,
                                           cfg.n_kv_heads, cfg.head_dim_)
        return logits


def refuse_enc_dec(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for an encoder-decoder model.  The
    reference's engine cannot serve one either: its contiguous prefill
    carries no ``frames`` (KeyError) and its paged caches raise."""
    if cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not served; the "
            "reference's engine cannot serve them either (its requests "
            "carry no frames, and paged serving does not support enc-dec)")


class Engine:
    def __init__(self, cfg: ArchConfig, params: Tree, *, n_slots: int = 4,
                 max_seq: int = 512, prefill_buckets=(64, 256),
                 seed: int = 0, paged: bool = False, page_size: int = 16,
                 pool_pages: Optional[int] = None,
                 prefix_sharing: bool = False,
                 prefix_retain_pages: int = 0,
                 chunked_prefill: bool = False, prefill_chunk: int = 64,
                 prefill_chunks_per_tick: int = 1, cache_dtype=None,
                 scheduler: Optional[Scheduler] = None,
                 metrics: Optional[EngineMetrics] = None,
                 fuse_projections: bool = False, attn_chunk: int = 1024,
                 device="cuda"):
        """``cache_dtype`` sets the page pools' dtype (bf16 by default);
        the contiguous rings are bf16, as the reference's, and recurrent
        state keeps its own dtypes on both backends.
        ``attn_chunk`` is the key chunk of whole-prompt prefill attention
        (the reference's ``Parallel.attn_chunk``)."""
        refuse_enc_dec(cfg)
        kinds = {k for s in cfg.stages for k in s.pattern}
        if chunked_prefill:
            if not paged:
                raise ValueError("chunked_prefill requires paged=True "
                                 "(chunks scatter into pool pages)")
            if not kinds <= set(T.ATTN_KINDS):
                raise ValueError(
                    f"chunked_prefill supports attention-only stages, "
                    f"got kinds {sorted(kinds)} — recurrent cells carry "
                    f"sequential state across chunks; serve this arch "
                    f"with the whole-prompt path")
            if prefill_chunk <= 0 or prefill_chunk % page_size:
                raise ValueError(
                    f"prefill_chunk={prefill_chunk} must be a positive "
                    f"multiple of page_size={page_size} (chunks must "
                    f"tile into pages)")
            if prefill_chunks_per_tick <= 0:
                raise ValueError("prefill_chunks_per_tick must be >= 1")
        if prefix_sharing and not paged:
            raise ValueError("prefix_sharing requires paged=True "
                             "(sharing lives in the page allocator)")
        if prefix_retain_pages and not prefix_sharing:
            raise ValueError("prefix_retain_pages requires "
                             "prefix_sharing=True (retention extends the "
                             "prefix cache's hit window)")
        if paged and page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.device = resolve_device(device)
        if fuse_projections:
            params = T.fuse_params_for_decode(params)
        self.cfg, self.params = cfg, params
        self.n_slots, self.max_seq = n_slots, max_seq
        self.buckets = tuple(sorted(b for b in prefill_buckets
                                    if b <= max_seq)) or (max_seq,)
        self.chunked_prefill = chunked_prefill
        self.prefill_chunk = prefill_chunk
        self.prefill_chunks_per_tick = prefill_chunks_per_tick
        self.attn_chunk = attn_chunk
        # a prefill of max_seq tokens would put the first decode write at
        # position max_seq — cap prompts one short; whole-prompt prefill
        # also caps them at the largest bucket
        self.max_prompt = (max_seq - 1 if chunked_prefill
                           else min(self.buckets[-1], max_seq - 1))
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.scheduler = scheduler or Scheduler()
        self.metrics = metrics or EngineMetrics()
        self.events = EventBus()

        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.pos = np.zeros((n_slots,), np.int32)
        self.cur_tok = np.zeros((n_slots,), np.int32)
        self.temps = np.zeros((n_slots,), np.float32)
        if paged:
            if pool_pages is None:
                pool_pages = n_slots * pages_for_tokens(max_seq, page_size)
            self.backend = _PagedBackend(
                self, page_size, pool_pages, cache_dtype or torch.bfloat16,
                prefix_sharing=prefix_sharing,
                prefix_retain_pages=prefix_retain_pages)
        else:
            self.backend = _ContiguousBackend(self)
        # chunked prefill: slot -> in-progress prefill state ({"seq",
        # "frontier", "resumed"}); a slot present here holds a request
        # but does not decode yet
        self._prefill_state: Dict[int, Dict[str, Any]] = {}
        self._rid = 0
        self._requests: Dict[int, Request] = {}
        self._tick_no = 0
        self._in_tick = False
        self._pending_cancels: List[int] = []
        # per-phase timing: each shape's first call includes the kernel
        # build and is recorded under "<phase>_compile"
        self._warm_shapes: set = set()

    def _timed(self, phase: str, shape_key, fn):
        """Run fn() and record its wall time under ``phase`` (or
        ``phase_compile`` for the first call at ``shape_key``), after
        the device has finished the work."""
        t0 = time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        if (phase, shape_key) in self._warm_shapes:
            self.metrics.on_phase_time(phase, dt, shape_key)
        else:
            self._warm_shapes.add((phase, shape_key))
            self.metrics.on_phase_time(phase + "_compile", dt, shape_key)
            self.metrics.on_stall()
        return out

    # -- event API ------------------------------------------------------
    def subscribe(self, cb):
        """Register a callback for every engine event.  Callbacks run
        inside ``tick()``; ``Engine.cancel`` called from one is deferred
        to the end of the current tick."""
        return self.events.subscribe(cb)

    def event_queue(self, maxlen: Optional[int] = None):
        """A drainable event queue (``collections.deque``): the
        streaming consumer drains it with ``popleft()`` between ticks."""
        return self.events.queue(maxlen)

    def _emit(self, ev) -> None:
        self.events.publish(ev)

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int = 32,
               temperature: float = 0.0,
               deadline_s: Optional[float] = None,
               priority: str = DEFAULT_CLASS) -> Request:
        prompt = np.asarray(prompt, np.int32)
        # prompts longer than the largest prefill bucket (or the decode
        # ceiling) keep their most recent tokens
        if len(prompt) > self.max_prompt:
            prompt = prompt[-self.max_prompt:]
        if not self.scheduler.has_class(priority):
            raise ValueError(f"unknown priority class {priority!r}")
        self._rid += 1
        deadline_t = (self.scheduler.clock() + deadline_s
                      if deadline_s is not None else None)
        r = Request(self._rid, prompt, max_new, temperature,
                    priority=priority, deadline_t=deadline_t,
                    prompt_cap=self.max_seq - 1)
        if max_new <= 0:
            r.done = True
            self.metrics.on_submit(r.rid, priority)
            self.metrics.on_finish(r.rid)
            self._emit(FinishEvent(r.rid, "empty", 0, 0, self._tick_no))
            return r
        self.backend.check_request(min(len(prompt) + max_new,
                                       self.max_seq))
        self._requests[r.rid] = r
        self.scheduler.enqueue(r)
        self.metrics.on_submit(r.rid, priority)
        return r

    def _bucket(self, s: int) -> int:
        for b in self.buckets:
            if s <= b:
                return b
        # fresh prompts are cut to max_prompt <= buckets[-1], so only a
        # preemption resume lands here: it keeps its whole context in
        # one extra shape, max_seq
        return self.max_seq

    def _context_seq(self, r: Request) -> np.ndarray:
        """The tokens a (re-)prefill of ``r`` covers: the prompt, plus
        for a preemption resume the generated tokens minus the pending
        one (re-fed as the next decode input)."""
        if r.out_tokens:
            return np.concatenate([r.prompt,
                                   np.asarray(r.out_tokens[:-1], np.int32)])
        return r.prompt

    def _finish_at_prefill(self, r: Request, tok: int, slot: int) -> bool:
        """Record the token sampled from the prefill logits; when it is
        the request's last (max_new = 1), finish the request, give back
        ``slot``'s storage and return True."""
        r.out_tokens.append(tok)
        self.metrics.on_token(r.rid)
        self._emit(TokenEvent(r.rid, tok, len(r.out_tokens) - 1,
                              self._tick_no))
        if len(r.out_tokens) < r.max_new:
            return False
        r.done = True
        self.metrics.on_finish(r.rid)
        self._requests.pop(r.rid, None)
        freed = self.backend.release(slot)
        self.slot_req[slot] = None
        self._emit(FinishEvent(r.rid, "max_new", len(r.out_tokens), freed,
                               self._tick_no))
        return True

    def _start(self, slot: int, r: Request) -> None:
        """(Re-)prefill ``r`` in one pass and occupy ``slot``.

        A fresh request samples its first token from the prefill logits;
        a preempted one prefills its prompt plus the tokens it had
        generated, minus the pending one, which is re-fed as the next
        decode input."""
        if self.chunked_prefill:
            return self._start_chunked(slot, r)
        resumed = bool(r.out_tokens)
        seq = self._context_seq(r)
        s = len(seq)
        if s > self.max_seq - 1:
            raise RuntimeError(f"context of {s} tokens exceeds "
                               f"max_seq-1={self.max_seq - 1}")
        b = self._bucket(s)
        toks = np.zeros((1, b), np.int32)
        toks[0, b - s:] = seq                   # left-pad
        # padding positions are -1: never attended, never cached
        idx = np.arange(b, dtype=np.int32)
        positions = np.where(idx >= b - s, idx - (b - s), -1)[None]
        batch = {"tokens": torch.from_numpy(toks).to(self.device),
                 "positions": torch.from_numpy(positions).to(self.device)}
        logits, cache1 = self._timed(
            "prefill", b, lambda: M.prefill(self.cfg, self.params, batch,
                                            self.max_seq, self.attn_chunk))
        be = self.backend
        # the admission pass just matched this request's prefix; no free
        # or registration can have happened since — reuse it
        shared = (be._hint_cache.pop(r.rid, None)
                  if be.prefix is not None else None)
        be.splice(slot, cache1, s, seq, shared)
        # this slot decodes at position s in this tick, after the growth
        # pass: admission reserved that page (prompt + 1)
        if not self.backend.ensure_capacity(slot, s):
            raise RuntimeError("admission must reserve the first decode "
                               "page")
        if resumed:
            tok = r.out_tokens[-1]
        else:
            tok = int(_sample_batched(logits[:, -1],
                                      np.asarray([r.temperature],
                                                 np.float32), self.gen)[0])
            if self._finish_at_prefill(r, tok, slot):
                return
        self.slot_req[slot] = r
        self.pos[slot] = s
        self.cur_tok[slot] = tok
        self.temps[slot] = r.temperature

    def _start_chunked(self, slot: int, r: Request) -> None:
        """Occupy ``slot`` for chunked prefill: attach any shared prefix
        pages, reserve the prompt's pages and set the chunk frontier;
        the compute happens chunk by chunk in :meth:`_advance_prefill`
        over the following ticks.  Chunks that prefix-cache pages cover
        whole are skipped outright: the frontier starts at the
        shared-page boundary, capped one page short of the prompt end
        so the final chunk always runs (its last-row logits seed the
        first sampled token)."""
        be = self.backend
        seq = self._context_seq(r)
        s = len(seq)
        if s > self.max_seq - 1:
            raise RuntimeError(f"context of {s} tokens exceeds "
                               f"max_seq-1={self.max_seq - 1}")
        ps = be.page_size
        shared: list = []
        if be.prefix is not None:
            hinted = be._hint_cache.pop(r.rid, None)
            shared = hinted if hinted is not None else be.prefix.match(seq)
            be.prefix.count_attach(len(shared))
            if shared:
                be.tables.fork(slot, shared)
        if not be.tables.ensure_blocks(slot, pages_for_tokens(s, ps)):
            raise RuntimeError("admission must reserve prompt pages first")
        skip = min(len(shared) * ps, ((s - 1) // ps) * ps)
        if skip:
            self.metrics.on_prefill_skip(skip)
        self.slot_req[slot] = r
        self.temps[slot] = r.temperature
        st: Dict[str, Any] = {"seq": seq, "frontier": skip,
                              "resumed": bool(r.out_tokens)}
        if be.prefix is not None:
            # the admission match is current as of this version: the
            # catch-up in _advance_prefill re-matches only once a peer
            # has registered (or the pool freed) since
            st["match_ver"] = (be.prefix.writes, be.pool.free_events)
        self._prefill_state[slot] = st

    def _advance_prefill(self, slot: int) -> int:
        """Run one chunk of ``slot``'s prefill; at the prompt end,
        graduate the slot to decoding (sample the first token from the
        final chunk's logits, or re-feed the pending token on a resume).
        Returns the live tokens processed."""
        st = self._prefill_state[slot]
        r = self.slot_req[slot]
        be = self.backend
        seq = st["seq"]
        s = len(seq)
        ps = be.page_size
        # ---- mid-prefill prefix catch-up: a cohort peer (admitted with
        # us, ahead of us in chunk order) may have registered pages for
        # chunks we have not computed yet — adopt its pages and move the
        # frontier past them, skipping those chunks' kernel calls.  Keyed
        # on the registry/pool version, so an unchanged registry costs
        # no re-hash.  Host-only: nothing is read from the device.
        if be.prefix is not None:
            ver = (be.prefix.writes, be.pool.free_events)
            if st.get("match_ver") != ver:
                st["match_ver"] = ver
                matched = be.prefix.match(seq)
                skip_to = min(len(matched) * ps, ((s - 1) // ps) * ps)
                if skip_to > st["frontier"]:
                    for blk in range(st["frontier"] // ps, skip_to // ps):
                        be.tables.adopt_shared(slot, blk, matched[blk])
                    be.prefix.count_attach(
                        skip_to // ps - st["frontier"] // ps)
                    self.metrics.on_prefill_skip(skip_to - st["frontier"])
                    st["frontier"] = skip_to
        start = st["frontier"]
        c = self.prefill_chunk
        length = min(c, s - start)
        toks = np.zeros((1, c), np.int32)
        toks[0, :length] = seq[start:start + length]
        logits = self._timed(
            "prefill_chunk", c,
            lambda: be.prefill_chunk(self.params, toks, slot, start, length))
        st["frontier"] = start + length
        self.metrics.on_prefill_chunk(length)
        # register the full pages as they complete, so cohort peers can
        # catch up mid-prefill; the chain state makes each call O(chunk)
        if be.prefix is not None:
            st["reg_state"], _ = be.prefix.register_prefix(
                seq[:st["frontier"]], be.tables.owned(slot),
                st.get("reg_state"))
            st["match_ver"] = (be.prefix.writes, be.pool.free_events)
        if st["frontier"] < s:
            return length
        # ---- prompt complete: graduate to decoding -------------------
        del self._prefill_state[slot]
        # the first decode page: other slots may have grown into it
        # since admission — preempt on shortfall (possibly this request)
        while self.slot_req[slot] is r and not be.ensure_capacity(slot, s):
            if not self._preempt_for(slot):
                raise RuntimeError(
                    "page pool exhausted with no preemption victim; "
                    "grow --pool-pages")
        if self.slot_req[slot] is not r:
            return length               # evicted ourselves: re-queued
        if st["resumed"]:
            tok = r.out_tokens[-1]
        else:
            tok = int(_sample_batched(logits, np.asarray([r.temperature],
                                                         np.float32),
                                      self.gen)[0])
            if self._finish_at_prefill(r, tok, slot):
                return length
        self.pos[slot] = s
        self.cur_tok[slot] = tok
        return length

    def _admit(self) -> None:
        for r in self.scheduler.expire():
            r.expired = True
            r.done = True
            self.metrics.on_expire(r.rid)
            self._requests.pop(r.rid, None)
            self._emit(ExpireEvent(r.rid, self._tick_no))
        be = self.backend
        shared_hint = None
        if be.prefix is not None:
            shared_hint = (lambda req: be.shared_page_hint(
                req.rid, self._context_seq(req)))
        for slot in range(self.n_slots):
            # while, not if: a max_new = 1 request finishes at its
            # whole-prompt prefill and leaves the slot free
            while self.slot_req[slot] is None:
                r = self.scheduler.next_admissible(
                    be.free_pages(), be.page_size, shared_pages=shared_hint)
                if r is None:
                    return
                self.metrics.on_admit(r.rid)
                self._start(slot, r)

    # ------------------------------------------------------------------
    def _preempt_for(self, slot: int) -> bool:
        """Free pages by evicting a victim so ``slot`` can grow.  Returns
        False when no victim exists."""
        running = {s: r for s, r in enumerate(self.slot_req)
                   if r is not None}
        victim = self.scheduler.choose_victim(running, exclude=slot)
        if victim is None:
            return False
        r = self.slot_req[victim]
        r.preemptions += 1
        self.metrics.on_preempt(r.rid)
        freed = self.backend.release(victim)
        self.slot_req[victim] = None
        # a mid-prefill victim abandons its frontier: the resume
        # re-prefills the same context from the top
        self._prefill_state.pop(victim, None)
        self._emit(PreemptEvent(r.rid, victim, freed, self._tick_no))
        self.scheduler.enqueue(r, front=True)
        return True

    def _grow_caches(self) -> None:
        """Before a decode tick every decoding slot needs a page for the
        token it writes at ``pos``; on exhaustion, preempt and retry."""
        for slot in range(self.n_slots):
            while self.slot_req[slot] is not None and \
                    slot not in self._prefill_state and \
                    not self.backend.ensure_capacity(slot,
                                                     int(self.pos[slot])):
                if not self._preempt_for(slot):
                    raise RuntimeError(
                        "page pool exhausted with no preemption victim; "
                        "grow --pool-pages")

    # ------------------------------------------------------------------
    def cancel(self, rid: int) -> bool:
        """Abort a request: queued requests leave the scheduler, in-flight
        requests give back their slot and pages (at the end of the tick
        when called from an event callback).  Emits
        ``FinishEvent(reason="cancelled")``."""
        r = self._requests.get(rid)
        if r is None or r.done:
            return False
        if self._in_tick:
            self._pending_cancels.append(rid)
            return True
        return self._do_cancel(rid)

    def _do_cancel(self, rid: int) -> bool:
        r = self._requests.get(rid)
        if r is None or r.done:
            return False
        freed = 0
        if self.scheduler.remove(rid) is None:
            for slot, rr in enumerate(self.slot_req):
                if rr is not None and rr.rid == rid:
                    freed = self.backend.release(slot)
                    self.slot_req[slot] = None
                    self._prefill_state.pop(slot, None)
                    break
        r.done = True
        r.cancelled = True
        self.metrics.on_cancel(rid)
        self._requests.pop(rid, None)
        self._emit(FinishEvent(rid, "cancelled", len(r.out_tokens), freed,
                               self._tick_no))
        return True

    def running(self) -> List[Tuple[int, Request]]:
        """Active (slot, request) pairs, in slot order."""
        return [(s, r) for s, r in enumerate(self.slot_req)
                if r is not None]

    @property
    def has_work(self) -> bool:
        return bool(len(self.scheduler)
                    or any(r is not None for r in self.slot_req))

    def prefix_stats(self) -> Optional[Dict[str, int]]:
        """Prefix-cache counters (None unless prefix sharing is on):
        lookups and hits, pages attached instead of allocated, tokens
        covered, live entries, retained pages and evictions, plus the
        tables' copy-on-write copies and forked pages."""
        be = self.backend
        if be.prefix is None:
            return None
        st = be.prefix.stats()
        return {"lookups": st.lookups, "hits": st.hits,
                "pages_attached": st.pages_attached,
                "tokens_shared": st.tokens_shared,
                "entries": st.entries,
                "retained": st.retained,
                "evictions": st.evictions,
                "cow_copies": be.tables.cow_copies,
                "forked_pages": be.tables.forked_pages}

    # ------------------------------------------------------------------
    def tick(self) -> bool:
        """One tick: growth (with preemption), admission (whole-prompt
        prefills run here), a bounded slice of chunked prefill, then one
        batched decode step.  Returns False when nothing was running or
        admissible."""
        self._tick_no += 1
        self._in_tick = True
        try:
            return self._tick_body()
        finally:
            self._in_tick = False
            pending, self._pending_cancels = self._pending_cancels, []
            for rid in pending:
                self._do_cancel(rid)

    def _tick_body(self) -> bool:
        self._grow_caches()
        self._admit()
        if all(r is None for r in self.slot_req):
            return False
        self.metrics.on_tick(self.scheduler.queue_depth,
                             sum(r is not None for r in self.slot_req),
                             self.backend.page_util())
        for _ in range(self.prefill_chunks_per_tick):
            if not self._prefill_state:
                break
            sl = self.scheduler.next_prefill_slot(
                {s: self.slot_req[s] for s in self._prefill_state})
            self._advance_prefill(sl)
        decoding = [s for s, r in enumerate(self.slot_req)
                    if r is not None and s not in self._prefill_state]
        if not decoding:
            return True                 # pure-prefill tick
        active = None
        if self._prefill_state:
            active = np.zeros((self.n_slots,), bool)
            active[decoding] = True
        logits = self._timed(
            "decode", self.backend.name,
            lambda: self.backend.decode(self.params, self.cur_tok, self.pos,
                                        active))
        next_toks = _sample_batched(logits, self.temps, self.gen)
        for slot, r in enumerate(self.slot_req):
            if r is None or slot in self._prefill_state:
                continue
            tok = int(next_toks[slot])
            r.out_tokens.append(tok)
            self.metrics.on_token(r.rid)
            self.pos[slot] += 1
            self.cur_tok[slot] = tok
            self._emit(TokenEvent(r.rid, tok, len(r.out_tokens) - 1,
                                  self._tick_no))
            if len(r.out_tokens) >= r.max_new or \
                    self.pos[slot] >= self.max_seq - 1:
                reason = ("max_new" if len(r.out_tokens) >= r.max_new
                          else "max_seq")
                r.done = True
                self.metrics.on_finish(r.rid)
                self._requests.pop(r.rid, None)
                freed = self.backend.release(slot)
                self.slot_req[slot] = None
                self._emit(FinishEvent(r.rid, reason, len(r.out_tokens),
                                       freed, self._tick_no))
        return True

    def run(self, max_ticks: int = 10_000, on_tick=None) -> None:
        """Drive ticks until the queue and slots drain; ``on_tick`` runs
        after every tick."""
        ticks = 0
        while self.has_work and ticks < max_ticks:
            if not self.tick():
                if not any(r is not None for r in self.slot_req) and \
                        len(self.scheduler):
                    raise RuntimeError(
                        "queued request can never be admitted "
                        "(pool too small for its prompt)")
            if on_tick is not None:
                on_tick()
            ticks += 1


def _sample_batched(logits: torch.Tensor, temps: np.ndarray,
                    gen: torch.Generator) -> np.ndarray:
    """Sample one token per row.  logits (B, V); temps (B,): <= 0 means
    greedy (argmax, first maximum on ties); other rows draw from
    softmax(logits / temperature) with ``gen``.  Returns int32 (B,)."""
    logits = logits.to(torch.float32)
    out = torch.argmax(logits, dim=-1)
    hot = temps > 0
    if hot.any():
        t = torch.from_numpy(np.maximum(temps, 1e-6)).to(logits.device)
        probs = torch.softmax(logits / t[:, None], dim=-1)
        drawn = torch.multinomial(probs, 1, generator=gen)[:, 0]
        out = torch.where(torch.from_numpy(hot).to(logits.device), drawn,
                          out)
    return out.to(torch.int32).cpu().numpy()
