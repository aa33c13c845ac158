"""Engine metrics: latency, throughput and occupancy counters.

One :class:`EngineMetrics` instance rides along with an ``Engine``.  The
engine reports lifecycle events (submit / admit / first token / finish /
preempt / expire / cancel) and one gauge sample per decode tick;
``snapshot()`` reduces them to the serving numbers that matter — tokens/s,
time-to-first-token, inter-token latency (TBT), queue depth, page
utilization — and ``to_json()`` exports them for the benchmark harness
(``benchmarks/serving_bench.py``).

Now that the engine emits every token through the event bus the tick it
is sampled, **inter-token latency is observable per request**: every
``on_token`` after the first records the gap since the request's
previous token, and ``snapshot()`` reduces the gaps to p50/p95 both
overall and **per priority class** (``on_submit`` carries the class) —
the per-class TTFT/TBT split is what makes the weighted-deficit
scheduler's service shares visible in ``serving_bench``'s
mixed-priority rows.

The clock is injectable so tests can drive deterministic time.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


def _percentile(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    ys = sorted(xs)
    i = min(len(ys) - 1, int(q * (len(ys) - 1) + 0.5))
    return ys[i]


@dataclass
class _ReqTimes:
    submit_t: float
    priority: str = "standard"
    admit_t: Optional[float] = None
    first_tok_t: Optional[float] = None
    last_tok_t: Optional[float] = None
    finish_t: Optional[float] = None
    tokens: int = 0
    tbt: List[float] = field(default_factory=list)  # inter-token gaps
    stall_seen: int = 0         # on_stall() count at the last token


class EngineMetrics:
    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self._req: Dict[int, _ReqTimes] = {}
        self._expired: set = set()
        self._cancelled: set = set()
        self._stalls = 0
        self.preemptions = 0
        self.expirations = 0
        self.cancellations = 0
        self.ticks = 0
        self.prefills = 0
        # chunked prefill: chunk calls / live tokens processed / tokens
        # skipped outright on prefix-cache hits (zero kernel calls)
        self.prefill_chunks = 0
        self.prefill_chunk_tokens = 0
        self.prefill_tokens_skipped = 0
        self._start_t: Optional[float] = None
        self._last_t: Optional[float] = None
        # per-tick gauge samples
        self.queue_depth: List[int] = []
        self.active_slots: List[int] = []
        self.page_util: List[float] = []
        # per-phase device-step wall times (engine reports blocked-on
        # -result durations around each prefill / decode call), and the
        # same times per "<phase>@<shape>" (prefill bucket, decode
        # backend) when the engine names the step's shape
        self.phase_times: Dict[str, List[float]] = {}
        self.shape_times: Dict[str, List[float]] = {}

    # -- lifecycle events ----------------------------------------------
    def on_submit(self, rid: int, priority: str = "standard") -> None:
        now = self.clock()
        if self._start_t is None:
            self._start_t = now
        self._req[rid] = _ReqTimes(submit_t=now, priority=priority)

    def on_admit(self, rid: int) -> None:
        t = self._req[rid]
        if t.admit_t is None:          # keep the first admit (preemptions re-admit)
            t.admit_t = self.clock()
        self.prefills += 1

    def on_token(self, rid: int, n: int = 1) -> None:
        now = self.clock()
        self._last_t = now
        t = self._req[rid]
        if t.first_tok_t is None:
            t.first_tok_t = now
        elif t.last_tok_t is not None and t.stall_seen == self._stalls:
            # a gap spanning an on_stall() (first-call build) is a one-time
            # warmup artifact, not inter-token latency — drop it so
            # tbt_p95 describes steady-state decode (TTFT still carries
            # the first compile, as it should)
            t.tbt.append(now - t.last_tok_t)
        t.last_tok_t = now
        t.stall_seen = self._stalls
        t.tokens += n

    def on_stall(self) -> None:
        """A one-time wall-clock stall (first-call build) happened: the next
        inter-token gap of every in-flight request is not decode
        latency and must not enter the TBT series."""
        self._stalls += 1

    def on_finish(self, rid: int) -> None:
        self._req[rid].finish_t = self.clock()

    def on_preempt(self, rid: int) -> None:
        self.preemptions += 1

    def on_expire(self, rid: int) -> None:
        self.expirations += 1
        self._expired.add(rid)      # never served: kept out of completed
                                    # counts and latency percentiles

    def on_cancel(self, rid: int) -> None:
        self.cancellations += 1
        self._cancelled.add(rid)    # partially served: tokens/TBT count,
                                    # completion/latency do not

    def on_prefill_chunk(self, n_tokens: int) -> None:
        """One chunked-prefill step processed ``n_tokens`` live prompt
        tokens (interleaved with decode in the same tick)."""
        self.prefill_chunks += 1
        self.prefill_chunk_tokens += n_tokens

    def on_prefill_skip(self, n_tokens: int) -> None:
        """``n_tokens`` of prompt were covered by prefix-cache pages and
        skipped the prefill compute entirely."""
        self.prefill_tokens_skipped += n_tokens

    def on_phase_time(self, phase: str, seconds: float,
                      shape=None) -> None:
        """Record one step's wall time for ``phase``, and under
        "<phase>@<shape>" when ``shape`` is given.  Decode runs
        at M=n_slots while prefill runs at the bucket length, so the two
        must be reported separately for the fused-projection /
        autotuned-kernel win to be visible.  The engine routes each
        compiled shape's first call to "<phase>_compile", keeping the
        base series pure steady-state."""
        self.phase_times.setdefault(phase, []).append(seconds)
        if shape is not None:
            self.shape_times.setdefault(f"{phase}@{shape}", []).append(
                seconds)

    def on_tick(self, queue_depth: int, active_slots: int,
                page_util: Optional[float] = None) -> None:
        self.ticks += 1
        self._last_t = self.clock()
        self.queue_depth.append(queue_depth)
        self.active_slots.append(active_slots)
        if page_util is not None:
            self.page_util.append(page_util)

    # -- reduction ------------------------------------------------------
    @staticmethod
    def _latency_block(times: List["_ReqTimes"]) -> Dict:
        ttft = [t.first_tok_t - t.submit_t for t in times
                if t.first_tok_t is not None]
        tbt = [g for t in times for g in t.tbt]
        mean = lambda xs: sum(xs) / len(xs) if xs else 0.0
        return {
            "ttft_mean_s": mean(ttft),
            "ttft_p50_s": _percentile(ttft, 0.50),
            "ttft_p95_s": _percentile(ttft, 0.95),
            "tbt_mean_s": mean(tbt),
            "tbt_p50_s": _percentile(tbt, 0.50),
            "tbt_p95_s": _percentile(tbt, 0.95),
        }

    def snapshot(self) -> Dict:
        served = {rid: t for rid, t in self._req.items()
                  if rid not in self._expired}
        lat = [t.finish_t - t.submit_t for rid, t in served.items()
               if t.finish_t is not None and rid not in self._cancelled]
        tokens = sum(t.tokens for t in self._req.values())
        wall = ((self._last_t - self._start_t)
                if self._start_t is not None and self._last_t is not None
                else 0.0)
        mean = lambda xs: sum(xs) / len(xs) if xs else 0.0

        def steps(series: Dict[str, List[float]]) -> Dict:
            return {key: {"count": len(ts), "total_s": sum(ts),
                          "mean_s": mean(ts),
                          "p50_s": _percentile(ts, 0.50),
                          "p95_s": _percentile(ts, 0.95)}
                    for key, ts in sorted(series.items())}
        by_class: Dict[str, List[_ReqTimes]] = {}
        for rid, t in served.items():
            by_class.setdefault(t.priority, []).append(t)
        per_class = {
            cls: dict(
                requests=len(ts),
                completed=sum(1 for t in ts if t.finish_t is not None),
                generated_tokens=sum(t.tokens for t in ts),
                **self._latency_block(ts),
            ) for cls, ts in sorted(by_class.items())
        }
        return {
            "requests": len(self._req),
            "completed": sum(1 for rid, t in served.items()
                             if t.finish_t is not None
                             and rid not in self._cancelled),
            "generated_tokens": tokens,
            "wall_s": wall,
            "tokens_per_s": tokens / max(wall, 1e-9),
            **self._latency_block(list(served.values())),
            "latency_mean_s": mean(lat),
            "latency_p95_s": _percentile(lat, 0.95),
            "ticks": self.ticks,
            "prefills": self.prefills,
            "prefill_chunks": self.prefill_chunks,
            "prefill_chunk_tokens": self.prefill_chunk_tokens,
            "prefill_tokens_skipped": self.prefill_tokens_skipped,
            "preemptions": self.preemptions,
            "expirations": self.expirations,
            "cancellations": self.cancellations,
            "queue_depth_mean": mean(self.queue_depth),
            "queue_depth_max": max(self.queue_depth, default=0),
            "active_slots_mean": mean(self.active_slots),
            "page_util_mean": mean(self.page_util),
            "page_util_max": max(self.page_util, default=0.0),
            "per_class": per_class,
            "phase_step_s": steps(self.phase_times),
            "shape_step_s": steps(self.shape_times),
        }

    def to_json(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.snapshot(), indent=2, default=float)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s
