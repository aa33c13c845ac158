"""Request scheduler: weighted priority classes, preemption, deadlines.

The scheduler owns the waiting queues and the *policy* decisions; the
engine owns the slots, caches and device steps and asks the scheduler:

  * ``next_admissible(...)`` — which queued request (if any) may start
    now, given free pages.  Admission picks across per-class FCFS
    queues by **weighted deficit round robin with an aging term**:
    every admission round each backlogged class accrues credit equal to
    its weight, the served class is charged the round's total, and the
    class whose (deficit + aging · head-wait) score is highest admits
    its head.  Long-run service shares are proportional to the weights,
    while the aging term bounds any class's wait under sustained
    higher-priority load — a low-weight head's score grows without
    bound until it wins a round (the anti-starvation guarantee the
    starvation test pins).  Within a class admission is strict FCFS
    (no reordering past the class head).  Across classes admission is
    work-conserving: the round walks classes in score order and admits
    the first head that fits — a top-scored head that does not fit is
    skipped WITHOUT being charged, so it keeps first claim on pages
    the moment they free while lower-scored classes fill the gap.
    Deficits are clamped to ±2× the round total, so a class blocked
    for a long stretch cannot wind up unbounded credit and burst past
    its weight share once capacity frees.
  * ``choose_victim(...)`` — which running request to preempt when the
    page pool is exhausted mid-decode.  Victim selection is
    class-aware: candidates are narrowed to the *lowest-weight* class
    present, then the configured policy picks within it — ``"newest"``
    (most recently admitted — least completed work lost, vLLM-style,
    the default) or ``"oldest"``.  The victim's pages are freed and the
    request is re-queued at the *front of its class queue* (it becomes
    that class's longest-waiting request and is re-admitted first, so
    preemption cannot starve it).
  * ``expire(...)`` — drop queued requests whose deadline passed while
    waiting.  Running requests are never killed by a deadline; only
    admission is gated (a request that started is cheapest to finish).

Requests are duck-typed: anything with ``rid`` / ``deadline_t`` /
``admit_seq`` attributes (see ``repro_torch.runtime.engine.Request``); an
optional ``priority`` attribute names the class (default
``"standard"``).  The scheduler stamps ``enqueue_t`` (its clock) on
every enqueue — the aging term reads it off the class head.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional

from repro_torch.runtime.paged_cache import pages_for_tokens

PREEMPT_POLICIES = ("newest", "oldest")
DEFAULT_CLASS = "standard"
DEFAULT_CLASS_WEIGHTS: Mapping[str, float] = {
    "realtime": 8.0, "standard": 4.0, "batch": 1.0}


@dataclass(frozen=True)
class SchedulerConfig:
    preempt_policy: str = "newest"
    # weighted-deficit admission across per-class FCFS queues; weights
    # are service shares (realtime gets 8/13 of admissions under full
    # backlog), aging_rate converts head wait seconds into score so no
    # class waits forever (score units per second)
    class_weights: Mapping[str, float] = field(
        default_factory=lambda: dict(DEFAULT_CLASS_WEIGHTS))
    aging_rate: float = 1.0

    def __post_init__(self):
        if self.preempt_policy not in PREEMPT_POLICIES:
            raise ValueError(f"preempt_policy {self.preempt_policy!r} not in "
                             f"{PREEMPT_POLICIES}")
        if DEFAULT_CLASS not in self.class_weights:
            raise ValueError(f"class_weights must include the default "
                             f"class {DEFAULT_CLASS!r}")
        if any(w <= 0 for w in self.class_weights.values()):
            raise ValueError("class weights must be positive")


class Scheduler:
    def __init__(self, cfg: SchedulerConfig = SchedulerConfig(),
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.clock = clock
        # per-class FCFS queues + deficit counters, iterated in the
        # (deterministic) class_weights declaration order
        self._queues: Dict[str, List] = {c: [] for c in cfg.class_weights}
        self._deficit: Dict[str, float] = {c: 0.0 for c in cfg.class_weights}
        self._admit_seq = 0

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @property
    def queue_depth(self) -> int:
        return len(self)

    def has_class(self, name: str) -> bool:
        return name in self._queues

    def weight_of(self, req) -> float:
        return self.cfg.class_weights.get(
            getattr(req, "priority", DEFAULT_CLASS),
            self.cfg.class_weights[DEFAULT_CLASS])

    def _class_of(self, req) -> str:
        cls = getattr(req, "priority", DEFAULT_CLASS)
        if cls not in self._queues:
            raise ValueError(f"unknown priority class {cls!r}; configured: "
                             f"{sorted(self._queues)}")
        return cls

    def enqueue(self, req, front: bool = False) -> None:
        cls = self._class_of(req)
        # front re-enqueues are preemption victims: they KEEP their
        # original stamp so the aging term accumulates across
        # admit→preempt cycles instead of resetting each round
        if not (front and getattr(req, "enqueue_t", None) is not None):
            try:
                req.enqueue_t = self.clock()
            except AttributeError:  # read-only duck types: aging treats
                pass                # a missing stamp as zero wait
        if front:
            self._queues[cls].insert(0, req)
        else:
            self._queues[cls].append(req)

    def remove(self, rid: int):
        """Remove and return a queued request by rid (cancellation), or
        None when it is not queued."""
        for q in self._queues.values():
            for i, r in enumerate(q):
                if r.rid == rid:
                    return q.pop(i)
        return None

    def expire(self) -> List:
        """Remove and return queued requests whose deadline has passed.

        Only never-admitted requests (admit_seq == 0) expire: a
        preempted request waiting for re-admission has already been paid
        for (see the running-requests rule above) and keeps its place."""
        now = self.clock()
        dead = []
        for cls, q in self._queues.items():
            gone = [r for r in q
                    if getattr(r, "deadline_t", None) is not None
                    and r.deadline_t <= now
                    and getattr(r, "admit_seq", 0) == 0]
            if gone:
                ids = {id(r) for r in gone}
                self._queues[cls] = [r for r in q if id(r) not in ids]
                dead.extend(gone)
        return dead

    # ------------------------------------------------------------------
    def _score(self, cls: str, now: float) -> float:
        head = self._queues[cls][0]
        wait = max(0.0, now - getattr(head, "enqueue_t", now))
        return self._deficit[cls] + self.cfg.aging_rate * wait

    def next_admissible(self, free_pages: Optional[int], page_size: int,
                        shared_pages: Optional[Callable[[object], int]]
                        = None) -> Optional[object]:
        """Pop and return the winning class's FCFS head if it fits, else
        None.

        ``free_pages=None`` means the backend has no page budget
        (contiguous slots reserve ``max_seq`` up front) — the head always
        fits.  For the paged backend the head needs pages for its whole
        prompt *plus the first decode token* (the engine writes it in the
        same tick the request is admitted, after the growth pass already
        ran) minus any pages ``shared_pages(head)`` says a prefix-cache
        attach will cover; later decode pages are allocated lazily,
        block by block.  The round walks classes in score order and
        admits the FIRST head that fits (work-conserving): a blocked
        top-scored head is skipped uncharged — its score keeps leading,
        so it claims pages the moment they free, and the deficit clamp
        plus its unbounded aging term mean it is delayed, never starved
        and never owed an unbounded service burst.
        """
        backlogged = [c for c in self._queues if self._queues[c]]
        if not backlogged:
            return None
        now = self.clock()
        # DRR credit accrual, clamped against windup; empty classes
        # carry no credit (a class must not burst after an idle stretch)
        total = sum(self.cfg.class_weights[c] for c in backlogged)
        cap = 2.0 * sum(self.cfg.class_weights.values())
        for c in self._queues:
            if self._queues[c]:
                self._deficit[c] = min(
                    self._deficit[c] + self.cfg.class_weights[c], cap)
            else:
                self._deficit[c] = 0.0
        ranked = sorted(backlogged,
                        key=lambda c: (self._score(c, now),
                                       self.cfg.class_weights[c], c),
                        reverse=True)
        for best in ranked:
            head = self._queues[best][0]
            if free_pages is not None:
                need = pages_for_tokens(head.n_prompt_tokens() + 1,
                                        page_size)
                if shared_pages is not None:
                    need = max(1, need - int(shared_pages(head)))
                if need > free_pages:
                    continue            # skipped, not charged: keeps
                                        # first claim on freed pages
            self._queues[best].pop(0)
            self._deficit[best] = max(self._deficit[best] - total, -cap)
            self._admit_seq += 1
            head.admit_seq = self._admit_seq
            return head
        return None

    # ------------------------------------------------------------------
    def next_prefill_slot(self, prefilling: Dict[int, object]
                          ) -> Optional[int]:
        """Which in-progress chunked prefill advances this tick.

        ``prefilling`` maps slot -> request for every slot whose prompt
        is still being written chunk-by-chunk.  The pick mirrors the
        admission policy's spirit at chunk granularity: the
        highest-weight priority class present goes first (a realtime
        prompt's time-to-first-token is not held behind a batch
        prompt's), FCFS (admission order) within a class — so under a
        chunk budget of one per tick, concurrent prefills drain in
        class-then-arrival order rather than round-robin thrash."""
        cands = [(s, r) for s, r in prefilling.items() if r is not None]
        if not cands:
            return None
        slot, _ = min(cands, key=lambda sr: (-self.weight_of(sr[1]),
                                             getattr(sr[1], "admit_seq", 0),
                                             sr[0]))
        return slot

    # ------------------------------------------------------------------
    def choose_victim(self, running: Dict[int, object],
                      exclude: Optional[int] = None) -> Optional[int]:
        """Pick the slot to preempt when the pool is exhausted.

        ``running`` maps slot -> request; ``exclude`` protects the slot
        whose allocation triggered the preemption when other victims
        exist (preempting yourself frees no net capacity for you).
        Candidates narrow to the lowest-weight priority class present —
        batch work is evicted before realtime — then the configured
        newest/oldest policy picks within that class."""
        cands = [(s, r) for s, r in running.items() if r is not None]
        if exclude is not None and len(cands) > 1:
            cands = [(s, r) for s, r in cands if s != exclude]
        if not cands:
            return None
        wmin = min(self.weight_of(r) for _, r in cands)
        cands = [(s, r) for s, r in cands if self.weight_of(r) == wmin]
        newest = self.cfg.preempt_policy == "newest"
        key = lambda sr: sr[1].admit_seq
        slot, _ = (max if newest else min)(cands, key=key)
        return slot
