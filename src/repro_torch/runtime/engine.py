"""Serving engine: the paged backend with chunked prefill (the main-path
subset of ``repro.runtime.engine``).

Continuous batching over a fixed decode batch of ``n_slots``.  All slots
share one pool of fixed-size KV pages addressed through per-request
block tables (``repro_torch.runtime.paged_cache``).  Admission reserves
a prompt's pages and sets a *chunk frontier*; each tick advances at most
``prefill_chunks_per_tick`` chunks of ``prefill_chunk`` prompt tokens —
one fused scatter+attend kernel call per layer that writes the chunk's
K/V straight into the slot's pages — and then runs one batched decode
step over the slots that are decoding (mid-prefill slots are masked
out: block-table rows -1, context lengths 0).  When the pool runs dry
the scheduler preempts a victim and re-queues it; a resumed request
re-prefills its context and continues with identical greedy tokens.

:meth:`Engine.tick` publishes typed events (``repro_torch.runtime.events``)
on ``Engine.events`` as they happen; :meth:`Engine.run` drives ticks until the work drains;
:meth:`Engine.cancel` aborts a request wherever it is.

Not ported yet, and refused by the constructor: the contiguous backend,
whole-prompt prefill, and prefix sharing / retention.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.runtime.events import (EventBus, ExpireEvent, FinishEvent,
                                        PreemptEvent, TokenEvent)
from repro_torch.runtime.metrics import EngineMetrics
from repro_torch.runtime.paged_cache import (BlockTables, PagePool,
                                             pages_for_tokens)
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


class _PagedBackend:
    """Shared page pool + per-slot block tables (see paged_cache.py)."""

    name = "paged"

    def __init__(self, eng: "Engine", page_size: int, pool_pages: int,
                 cache_dtype):
        self.eng = eng
        self.pool = PagePool(pool_pages, page_size)
        self.tables = BlockTables(self.pool, eng.n_slots,
                                  pages_for_tokens(eng.max_seq, page_size))
        self.caches = M.init_paged_caches(eng.cfg, pool_pages, page_size,
                                          dtype=cache_dtype,
                                          device=eng.device)

    @property
    def page_size(self) -> int:
        return self.pool.page_size

    def free_pages(self) -> int:
        return self.pool.free_pages

    def page_util(self) -> float:
        return self.pool.pages_in_use / self.pool.num_pages

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.eng.device)

    def _apply_cow(self) -> None:
        pairs = self.tables.drain_copies()
        if pairs:
            src = self._dev(np.asarray([s for s, _ in pairs]))
            dst = self._dev(np.asarray([d for _, d in pairs]))
            self.caches = M.copy_pages(self.eng.cfg, self.caches, src, dst)

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
        return logits


class Engine:
    def __init__(self, cfg: ArchConfig, params: Tree, *, n_slots: int = 4,
                 max_seq: int = 512, seed: int = 0, paged: bool = True,
                 page_size: int = 16, pool_pages: Optional[int] = None,
                 prefix_sharing: bool = False,
                 prefix_retain_pages: int = 0,
                 chunked_prefill: bool = True, prefill_chunk: int = 64,
                 prefill_chunks_per_tick: int = 1, cache_dtype=None,
                 scheduler: Optional[Scheduler] = None,
                 metrics: Optional[EngineMetrics] = None,
                 fuse_projections: bool = False, device="cuda"):
        if not paged:
            raise NotImplementedError(
                "the contiguous cache backend is not ported yet; use "
                "paged=True")
        if not chunked_prefill:
            raise NotImplementedError(
                "whole-prompt prefill is not ported yet; use "
                "chunked_prefill=True")
        if prefix_sharing or prefix_retain_pages:
            raise NotImplementedError(
                "prefix sharing and retention are not ported yet")
        kinds = {k for s in cfg.stages for k in s.pattern}
        if not kinds <= set(T.KINDS):
            raise NotImplementedError(
                f"block kinds {sorted(kinds - set(T.KINDS))} are not "
                f"ported yet")
        if page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        if prefill_chunk <= 0 or prefill_chunk % page_size:
            raise ValueError(
                f"prefill_chunk={prefill_chunk} must be a positive "
                f"multiple of page_size={page_size} (chunks must tile "
                f"into pages)")
        if prefill_chunks_per_tick <= 0:
            raise ValueError("prefill_chunks_per_tick must be >= 1")
        self.device = resolve_device(device)
        if fuse_projections:
            params = T.fuse_params_for_decode(params)
        self.cfg, self.params = cfg, params
        self.n_slots, self.max_seq = n_slots, max_seq
        self.prefill_chunk = prefill_chunk
        self.prefill_chunks_per_tick = prefill_chunks_per_tick
        # a prompt of max_seq tokens would put the first decode write at
        # position max_seq — cap prompts one short
        self.max_prompt = max_seq - 1
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.scheduler = scheduler or Scheduler()
        self.metrics = metrics or EngineMetrics()
        self.events = EventBus()

        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.pos = np.zeros((n_slots,), np.int32)
        self.cur_tok = np.zeros((n_slots,), np.int32)
        self.temps = np.zeros((n_slots,), np.float32)
        if pool_pages is None:
            pool_pages = n_slots * pages_for_tokens(max_seq, page_size)
        self.backend = _PagedBackend(self, page_size, pool_pages,
                                     cache_dtype or torch.bfloat16)
        # slot -> in-progress prefill state ({"seq", "frontier",
        # "resumed"}); a slot present here holds a request but does not
        # decode yet
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
            self.metrics.on_phase_time(phase, dt)
        else:
            self._warm_shapes.add((phase, shape_key))
            self.metrics.on_phase_time(phase + "_compile", dt)
            self.metrics.on_stall()
        return out

    def _emit(self, ev) -> None:
        self.events.publish(ev)

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int = 32,
               temperature: float = 0.0,
               deadline_s: Optional[float] = None,
               priority: str = DEFAULT_CLASS) -> Request:
        prompt = np.asarray(prompt, np.int32)
        # prompts longer than the decode ceiling keep their most recent
        # tokens
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
        need = pages_for_tokens(min(len(prompt) + max_new, self.max_seq),
                                self.backend.page_size)
        if need > self.backend.pool.num_pages:
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self.backend.pool.num_pages}; grow --pool-pages")
        self._requests[r.rid] = r
        self.scheduler.enqueue(r)
        self.metrics.on_submit(r.rid, priority)
        return r

    def _context_seq(self, r: Request) -> np.ndarray:
        """The tokens a (re-)prefill of ``r`` covers: the prompt, plus
        for a preemption resume the generated tokens minus the pending
        one (re-fed as the next decode input)."""
        if r.out_tokens:
            return np.concatenate([r.prompt,
                                   np.asarray(r.out_tokens[:-1], np.int32)])
        return r.prompt

    def _start(self, slot: int, r: Request) -> None:
        """Occupy ``slot``: reserve the prompt's pages and set the chunk
        frontier; the compute happens chunk by chunk in
        :meth:`_advance_prefill` over the following ticks."""
        be = self.backend
        seq = self._context_seq(r)
        if len(seq) > self.max_seq - 1:
            raise RuntimeError(f"context of {len(seq)} tokens exceeds "
                               f"max_seq-1={self.max_seq - 1}")
        ok = be.tables.ensure_blocks(slot, pages_for_tokens(len(seq),
                                                            be.page_size))
        if not ok:
            raise RuntimeError("admission must reserve prompt pages first")
        self.slot_req[slot] = r
        self.temps[slot] = r.temperature
        self._prefill_state[slot] = {"seq": seq, "frontier": 0,
                                     "resumed": bool(r.out_tokens)}

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
            r.out_tokens.append(tok)
            self.metrics.on_token(r.rid)
            self._emit(TokenEvent(r.rid, tok, len(r.out_tokens) - 1,
                                  self._tick_no))
            if len(r.out_tokens) >= r.max_new:
                r.done = True
                self.metrics.on_finish(r.rid)
                self._requests.pop(r.rid, None)
                freed = be.release(slot)
                self.slot_req[slot] = None
                self._emit(FinishEvent(r.rid, "max_new", len(r.out_tokens),
                                       freed, self._tick_no))
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
        for slot in range(self.n_slots):
            if self.slot_req[slot] is None:
                r = self.scheduler.next_admissible(
                    self.backend.free_pages(), self.backend.page_size)
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

    # ------------------------------------------------------------------
    def tick(self) -> bool:
        """One tick: growth (with preemption), admission, a bounded slice
        of chunked prefill, then one batched decode step.  Returns False
        when nothing was running or admissible."""
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
