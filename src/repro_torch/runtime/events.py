"""Typed engine events and the subscriber/queue bus.

The serving engine's ``tick()`` is reentrant: instead of buffering whole
requests inside ``run()``, every observable state change is published as
a typed event the moment it happens on the host —

  * :class:`TokenEvent` — one generated token (prefill's first sample or
    a decode-tick sample), before the request is anywhere near done.
    This is what makes streaming output and inter-token latency (TBT)
    measurable per tick.
  * :class:`FinishEvent` — terminal state for a request that produced
    output: ``reason`` is ``"max_new"`` (hit its token budget),
    ``"max_seq"`` (hit the context ceiling), ``"cancelled"``
    (:meth:`Engine.cancel`), or ``"empty"`` (``max_new<=0`` degenerate).
    Carries how many pool pages the release returned — cancellation
    frees pages in the same tick, and the event is the receipt.
  * :class:`PreemptEvent` — a running request was evicted to free pages;
    it is re-queued (front of its class queue) and will resume.
  * :class:`ExpireEvent` — a queued request's deadline passed before it
    was ever admitted; it is dropped without output.

Consumers attach either a callback (``subscribe``) or a drainable queue
(``queue()``) — the queue form is what ``launch/serve.py --stream`` uses
(drain between ticks, print tokens as they land).  Publishing happens
inside ``tick()`` on the engine's thread; callbacks must not re-enter
mutating engine APIs (``Engine.cancel`` called from a callback is
deferred to the end of the current tick for exactly this reason).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, List, Optional, Union

FINISH_REASONS = ("max_new", "max_seq", "cancelled", "empty")


@dataclass(frozen=True)
class TokenEvent:
    rid: int
    token: int
    index: int          # position in the request's output stream (0-based)
    tick: int


@dataclass(frozen=True)
class FinishEvent:
    rid: int
    reason: str         # one of FINISH_REASONS
    n_tokens: int
    freed_pages: int
    tick: int


@dataclass(frozen=True)
class PreemptEvent:
    rid: int
    slot: int
    freed_pages: int
    tick: int


@dataclass(frozen=True)
class ExpireEvent:
    rid: int
    tick: int


Event = Union[TokenEvent, FinishEvent, PreemptEvent, ExpireEvent]


class EventBus:
    """Fan-out of engine events to callbacks and drainable queues."""

    def __init__(self):
        self._subs: List[Callable[[Event], None]] = []

    def subscribe(self, cb: Callable[[Event], None]) -> Callable:
        self._subs.append(cb)
        return cb

    def unsubscribe(self, cb: Callable) -> None:
        # equality, not identity: a deque's bound `q.append` is a fresh
        # object per attribute access, but compares equal — so
        # unsubscribe(q.append) really detaches a queue() subscriber
        self._subs = [s for s in self._subs if s != cb]

    def queue(self, maxlen: Optional[int] = None) -> Deque[Event]:
        """A new subscriber queue: every published event is appended.
        Drain with ``popleft()`` between ticks; a ``maxlen`` bounds
        memory for slow consumers (oldest events drop first)."""
        q: Deque[Event] = deque(maxlen=maxlen)
        self.subscribe(q.append)
        return q

    def publish(self, ev: Event) -> None:
        for cb in self._subs:
            cb(ev)
