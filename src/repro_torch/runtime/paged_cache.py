"""Paged KV-cache block-pool allocator (host side), ref-counted + COW.

vLLM-style paging for the serving engine: the device KV cache is one
shared pool of fixed-size pages ``(num_pages, page_size, heads, head_dim)``
per attention layer stack, and each request owns a *block table* mapping
its token blocks ``t // page_size`` to pool pages.  Memory then scales
with the tokens actually resident instead of ``n_slots × max_seq``.

The layout is position-aligned: token ``t`` of a request always lives at
``(block_table[t // page_size], t % page_size)``, so the attention mask
can be derived from implied positions (``block·page_size + slot``) and no
per-slot position array has to be stored or cleared — a freed page can be
handed to the next request without touching device memory, because stale
slots are masked out by the new owner's shorter context.

Position alignment is also what makes **prefix sharing** a pure
allocator-layer feature: two requests whose prompts agree on the first
``k`` page-aligned chunks can point their first ``k`` block-table entries
at the *same* pool pages — the decode step and the flash-decode
kernel are oblivious, they just follow the tables.  Three pieces
cooperate:

  * :class:`PagePool` pages carry a **refcount** — ``alloc`` returns
    pages at refcount 1, :meth:`PagePool.incref` adds holders,
    :meth:`PagePool.free` decrements and only returns a page to the free
    list when the count reaches zero (bumping its *generation* so stale
    registry entries can detect reuse).
  * :meth:`BlockTables.fork` attaches an existing page run to a slot's
    table **copy-on-write**: the pages are increfed and marked shared;
    prefill splices skip writing them (:meth:`BlockTables.writable_row`
    masks shared blocks to ``-1`` → the device scatter drops those
    writes), and any write landing in a shared block first triggers a
    COW copy (:meth:`BlockTables.ensure_for_position` allocates a
    private page and records a ``(src, dst)`` device copy the engine
    backend applies before the next decode).  In the prefix-sharing
    flow the copy NEVER fires by construction — only full pages
    strictly below the sharer's write frontier are attached, so
    ``cow_copies`` staying 0 is the invariant (serving_bench prints
    it) and the copy path is the enforced safety net.  Its real
    consumer is whole-sequence forks (parallel sampling / beam search,
    see ROADMAP), where a mid-generation attach puts the write
    frontier INSIDE a shared page.
  * :class:`PrefixCache` is the hash-keyed registry: page-aligned prompt
    chunks are keyed by a chained digest (chunk tokens folded into the
    parent chunk's key, so a match is always a *prefix* match) and map
    to the live pool page holding them.  Entries are validated against
    the pool's refcount/generation at lookup — a page freed and reused
    invalidates its entry lazily.  Only *full* pages strictly below the
    registrant's prompt length are registered: those pages are never
    written again by their owner (decode writes start at the prompt
    boundary), so sharers can attend them without a copy.

This module is pure host bookkeeping (free list + per-slot tables);
the device-side gather/scatter lives in ``repro_torch.models.layers``
(:func:`attention_decode_paged`) and ``repro_torch.models.transformer``
(``stage_copy_pages`` applies the COW page copies).
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def pages_for_tokens(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` position-aligned tokens."""
    return max(0, -(-int(n_tokens) // int(page_size)))


@dataclass
class PoolStats:
    num_pages: int
    pages_in_use: int
    peak_in_use: int
    allocs: int
    alloc_failures: int
    shared_pages: int = 0       # pages currently held by >1 table

    @property
    def utilization(self) -> float:
        return self.pages_in_use / max(1, self.num_pages)


class PagePool:
    """Fixed-size page allocator with refcounts and free-list reuse.

    Page ids are ``[0, num_pages)``; id ``num_pages`` is reserved as the
    out-of-range sentinel the device scatter uses to drop a write.
    ``alloc`` hands out pages at refcount 1; ``incref`` adds holders
    (prefix sharing / fork); ``free`` *decrements* and only returns the
    page to the free list when the last holder lets go, bumping the
    page's generation counter so :class:`PrefixCache` entries pointing
    at it go stale.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError(f"bad pool geometry {num_pages}x{page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # allocation-pressure callback: invoked with the page shortfall
        # when the free list can't cover an alloc, BEFORE the alloc
        # fails — the prefix retention cache hooks in here to evict its
        # least-recently-used retained pages on demand
        self.pressure_hook: Optional[Callable[[int], int]] = None
        # LIFO free list: recently freed pages are reused first (their
        # pool lines are more likely to still be resident in HBM caches).
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._ref = [0] * num_pages          # 0 = free
        self._gen = [0] * num_pages          # bumped on each real free
        self.free_events = 0                 # total pages ever freed —
                                             # cheap liveness version for
                                             # prefix-match memoization
        self._allocs = 0
        self._failures = 0
        self._peak = 0

    # ------------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def can_alloc(self, n: int) -> bool:
        return len(self._free) >= n

    def refcount(self, page: int) -> int:
        return self._ref[page]

    def generation(self, page: int) -> int:
        return self._gen[page]

    def alloc(self, n: int = 1) -> Optional[List[int]]:
        """Allocate ``n`` pages at refcount 1, or None (and no change)
        if unavailable.  On a free-list shortfall the pressure hook (if
        set) gets one chance to reclaim retained pages first."""
        if n > len(self._free) and self.pressure_hook is not None:
            self.pressure_hook(n - len(self._free))
        if n > len(self._free):
            self._failures += 1
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._ref[p] = 1
        self._allocs += n
        self._peak = max(self._peak, self.pages_in_use)
        return out

    def incref(self, pages: Sequence[int]) -> None:
        """Add a holder to live pages (COW attach / fork)."""
        for p in pages:
            if not (0 <= p < self.num_pages) or self._ref[p] <= 0:
                raise ValueError(f"incref of non-live page {p}")
            self._ref[p] += 1

    def free(self, pages: Sequence[int]) -> int:
        """Drop one reference per page; pages reaching refcount 0 return
        to the free list (generation bumped).  Returns how many pages
        were actually freed (refcounts never go negative — a drop past
        zero raises, it is a double free)."""
        freed = 0
        for p in pages:
            if not (0 <= p < self.num_pages):
                raise ValueError(f"freeing invalid page {p}")
            if self._ref[p] <= 0:
                raise ValueError(f"double free of page {p}")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._gen[p] += 1
                self._free.append(p)
                freed += 1
        self.free_events += freed
        return freed

    def stats(self) -> PoolStats:
        return PoolStats(self.num_pages, self.pages_in_use, self._peak,
                         self._allocs, self._failures,
                         sum(1 for r in self._ref if r > 1))


class BlockTables:
    """Per-slot block tables over a shared :class:`PagePool`.

    ``table(slot)`` is an ``(max_blocks,)`` int32 row; unassigned blocks
    are ``-1``.  The stacked ``(n_slots, max_blocks)`` array is what the
    decode step consumes each tick.

    Copy-on-write: blocks attached through :meth:`fork` (prefix sharing)
    are *shared* — this slot may read them but never write.  Prefill
    splices consume :meth:`writable_row`, which masks shared blocks (and
    any block whose page has other holders) to ``-1`` so the device
    scatter drops those writes; a decode write landing in a shared block
    goes through :meth:`ensure_for_position`'s COW step first: allocate
    a private page, queue a ``(src, dst)`` device page copy (drained by
    the engine backend via :meth:`drain_copies`), drop the shared
    reference, repoint the table.
    """

    def __init__(self, pool: PagePool, n_slots: int, max_blocks: int):
        self.pool = pool
        self.n_slots = int(n_slots)
        self.max_blocks = int(max_blocks)
        self._tables = np.full((n_slots, max_blocks), -1, np.int32)
        self._owned: Dict[int, List[int]] = {s: [] for s in range(n_slots)}
        self._shared: Dict[int, set] = {s: set() for s in range(n_slots)}
        # live context length per slot (tokens the next decode step may
        # attend, incl. the one it writes); 0 = inactive.  Maintained by
        # ensure_for_position/release and consumed by the flash-decode
        # kernels' block-table operands every tick.
        self._lens = np.zeros((n_slots,), np.int32)
        self._pending_copies: List[Tuple[int, int]] = []
        self.cow_copies = 0
        self.forked_pages = 0

    # ------------------------------------------------------------------
    def as_array(self) -> np.ndarray:
        return self._tables

    def context_lens(self) -> np.ndarray:
        return self._lens

    def owned(self, slot: int) -> List[int]:
        return list(self._owned[slot])

    def n_blocks(self, slot: int) -> int:
        return len(self._owned[slot])

    def shared_blocks(self, slot: int) -> set:
        return set(self._shared[slot])

    def writable_row(self, slot: int) -> np.ndarray:
        """The slot's table row with every non-writable block masked to
        -1: blocks attached via :meth:`fork`, plus any block whose page
        has other holders (a preemption-resume re-splice must not
        rewrite pages a sharer is attending — the values are identical
        only up to the prefill bucket's rounding)."""
        row = self._tables[slot].copy()
        for i, page in enumerate(self._owned[slot]):
            if i in self._shared[slot] or self.pool.refcount(page) > 1:
                row[i] = -1
        return row

    def fork(self, slot: int, pages: Sequence[int]) -> None:
        """Attach ``pages`` as this slot's first blocks, copy-on-write.

        The pages must be live (held by their current owner(s)); they
        are increfed and marked shared — reads are free, writes go
        through the COW step in :meth:`ensure_for_position`.  The slot's
        table must be empty (the engine always releases a slot before
        reusing it)."""
        if self._owned[slot]:
            raise ValueError(f"fork into non-empty slot {slot}")
        if len(pages) > self.max_blocks:
            raise ValueError(f"fork of {len(pages)} blocks > max_blocks")
        self.pool.incref(pages)
        self._owned[slot] = list(pages)
        self._tables[slot, :len(pages)] = pages
        self._shared[slot] = set(range(len(pages)))
        self.forked_pages += len(pages)

    def adopt_shared(self, slot: int, blk: int, page: int) -> None:
        """Swap an owned, NOT-YET-WRITTEN block for a shared page
        (mid-prefill prefix catch-up: a cohort peer registered this
        chunk's page after we were admitted).  The old page goes back to
        the pool; the adopted page is increfed and marked shared exactly
        like a :meth:`fork` attach, so splices/chunk writes skip it."""
        if blk in self._shared[slot]:
            raise ValueError(f"block {blk} of slot {slot} already shared")
        old = self._owned[slot][blk]
        self.pool.incref([page])
        self.pool.free([old])
        self._owned[slot][blk] = page
        self._tables[slot, blk] = page
        self._shared[slot].add(blk)
        self.forked_pages += 1

    def ensure_blocks(self, slot: int, n_blocks: int) -> bool:
        """Grow ``slot``'s table to ``n_blocks`` blocks.  Returns False —
        with no partial allocation — when the pool can't supply them."""
        if n_blocks > self.max_blocks:
            raise ValueError(
                f"request needs {n_blocks} blocks > max_blocks={self.max_blocks}")
        need = n_blocks - len(self._owned[slot])
        if need <= 0:
            return True
        pages = self.pool.alloc(need)
        if pages is None:
            return False
        start = len(self._owned[slot])
        self._owned[slot].extend(pages)
        self._tables[slot, start:start + len(pages)] = pages
        return True

    def ensure_for_position(self, slot: int, pos: int) -> bool:
        """Make sure the page holding token position ``pos`` exists AND
        is writable by this slot, and record the slot's live context
        length (``pos + 1``: the engine calls this for the position the
        next decode step writes, which is also the last position that
        step attends).

        If the target block is a shared attach (fork / prefix sharing),
        this is the copy-on-write point: allocate a private page, queue
        the device page copy, release the shared reference.  Returns
        False (no state change beyond any earlier whole-block growth)
        when the pool cannot supply the page — the engine preempts a
        victim and retries."""
        blk = pos // self.pool.page_size
        if not self.ensure_blocks(slot, blk + 1):
            return False
        if blk in self._shared[slot]:
            if not self._cow(slot, blk):
                return False
        self._lens[slot] = pos + 1
        return True

    def _cow(self, slot: int, blk: int) -> bool:
        src = self._owned[slot][blk]
        new = self.pool.alloc(1)
        if new is None:
            return False
        dst = new[0]
        self._pending_copies.append((src, dst))
        self.pool.free([src])               # drop the shared reference
        self._owned[slot][blk] = dst
        self._tables[slot, blk] = dst
        self._shared[slot].discard(blk)
        self.cow_copies += 1
        return True

    def drain_copies(self) -> List[Tuple[int, int]]:
        """The (src, dst) device page copies queued by COW since the
        last drain.  The engine backend applies them (pool[dst] =
        pool[src] for every KV layer stack) before the next device step
        that could read or write those pages."""
        out = self._pending_copies
        self._pending_copies = []
        return out

    def release(self, slot: int) -> int:
        """Drop every page reference held by ``slot``; returns how many
        pages actually returned to the free list (shared pages survive
        with their remaining holders)."""
        pages = self._owned[slot]
        freed = self.pool.free(pages) if pages else 0
        self._owned[slot] = []
        self._shared[slot] = set()
        self._tables[slot, :] = -1
        self._lens[slot] = 0
        return freed


# ---------------------------------------------------------------------------
# Prefix registry: hash-keyed page-aligned prompt chunks -> live pool pages
# ---------------------------------------------------------------------------
@dataclass
class _PrefixEntry:
    page: int
    gen: int
    tokens: np.ndarray          # the chunk's tokens, for exact validation


@dataclass
class PrefixStats:
    lookups: int
    hits: int                   # lookups that attached >= 1 page
    pages_attached: int         # total pages attached instead of allocated
    tokens_shared: int
    entries: int
    retained: int = 0           # pages currently held by the retention LRU
    evictions: int = 0          # retained pages released under pressure


class PrefixCache:
    """Hash-keyed registry of page-aligned prompt chunks.

    Keys chain: ``key_i = H(key_{i-1} || tokens_i)``, so looking up a
    prompt walks its chunks left to right and stops at the first miss —
    a match is always a *prefix* match, and two prompts sharing chunk
    contents at different positions never collide.  Values are pool page
    ids validated lazily against the pool's refcount (page still live)
    and generation (page not freed+reused) plus an exact token compare
    (hash collisions can't corrupt a cache hit).

    Only full pages strictly below the registrant's prompt length are
    registered: their contents are immutable for the registrant's
    lifetime (decode writes start at the prompt boundary; resume
    re-splices are masked off shared pages by
    :meth:`BlockTables.writable_row`), which is what makes attaching
    them read-only safe.

    **Retention** (``retain_pages > 0``): without it, registered pages
    die with their last holder — a straggler admitted after its cohort
    finished re-prefills from scratch.  The retention LRU takes one
    extra reference on every registered page, so the page (and its
    registry entry) outlives the cohort; under allocation pressure the
    pool's pressure hook calls :meth:`evict_for` and retained pages
    with no other holder are released (generation bump lazily
    invalidates their entries).

    Eviction is **group-aware and deepest-first**: pages are grouped by
    their prefix *root* (the chain key of chunk 0), groups form the LRU
    (matches and re-registrations refresh a group), and within the
    least-recently-used group the DEEPEST chunks evict first.  Evicting
    the chain head would make the whole prefix unmatchable while its
    deeper pages stayed pinned; tail-first eviction instead degrades a
    cold prefix to a shorter — still useful — one.
    """

    def __init__(self, pool: PagePool, retain_pages: int = 0):
        self.pool = pool
        self.page_size = pool.page_size
        self._entries: Dict[bytes, _PrefixEntry] = {}
        self.writes = 0         # registry mutation version (register /
                                # prune) — with pool.free_events it keys
                                # the engine's admission-hint memo
        self._lookups = 0
        self._hits = 0
        self._pages_attached = 0
        self._tokens_shared = 0
        self.retain_pages = int(retain_pages)
        # page -> (generation, prefix root, chunk depth); roots form the
        # LRU (OrderedDict order = least... most recently used)
        self._retained: Dict[int, Tuple[int, bytes, int]] = {}
        self._groups: "OrderedDict[bytes, None]" = OrderedDict()
        self._evictions = 0
        if self.retain_pages > 0:
            pool.pressure_hook = self.evict_for

    # ------------------------------------------------------------------
    @staticmethod
    def _chain(parent: bytes, chunk: np.ndarray) -> bytes:
        h = hashlib.blake2b(digest_size=16)
        h.update(parent)
        h.update(np.ascontiguousarray(chunk, np.int32).tobytes())
        return h.digest()

    def _chunks(self, tokens: np.ndarray):
        ps = self.page_size
        tokens = np.asarray(tokens, np.int32)
        for i in range(len(tokens) // ps):
            yield i, tokens[i * ps:(i + 1) * ps]

    def _live(self, e: _PrefixEntry) -> bool:
        return (self.pool.refcount(e.page) > 0
                and self.pool.generation(e.page) == e.gen)

    # ------------------------------------------------------------------
    def match(self, tokens: np.ndarray) -> List[int]:
        """Pool pages holding this prompt's longest registered full-page
        prefix (possibly empty).  Stale entries met on the walk are
        pruned.  Pure lookup — attaching (incref) is the caller's move
        via :meth:`BlockTables.fork`, recorded via
        :meth:`count_attach` (so the admission hint and the splice can
        share ONE match walk without double-counting stats)."""
        key = b""
        root: Optional[bytes] = None
        pages: List[int] = []
        for _, chunk in self._chunks(tokens):
            key = self._chain(key, chunk)
            if root is None:
                root = key
            e = self._entries.get(key)
            if e is None:
                break
            if not self._live(e):
                del self._entries[key]      # freed+reused page: prune
                self.writes += 1
                break
            if not np.array_equal(e.tokens, chunk):
                break                       # hash collision: live entry,
                                            # different chunk — keep it
            pages.append(e.page)
        if pages and root in self._groups:  # hit refreshes the group LRU
            self._groups.move_to_end(root)
        return pages

    # -- retention LRU (group-aware, deepest-first eviction) -------------
    def _retain(self, page: int, root: bytes, depth: int) -> None:
        if self.retain_pages <= 0:
            return
        if page not in self._retained:
            self.pool.incref([page])
            self._retained[page] = (self.pool.generation(page), root,
                                    depth)
        self._groups[root] = None
        self._groups.move_to_end(root)
        # cap: shed pages nobody else holds (in-use pages may ride over
        # the cap — retaining them costs no free-list capacity, and they
        # fall out on the first pressure call after their cohort)
        excess = len(self._retained) - self.retain_pages
        if excess > 0:
            self.evict_for(excess)

    def evictable(self) -> int:
        """Retained pages an eviction pass could return to the free list
        right now (no holder besides the retention reference) — what the
        engine adds to its admission free-page headroom."""
        return sum(1 for p in self._retained
                   if self.pool.refcount(p) == 1)

    def evict_for(self, n: int) -> int:
        """Release up to ``n`` retained pages that have no other holder:
        least-recently-used prefix GROUP first, deepest chunks within a
        group first — a cold prefix shrinks from its tail (shorter
        matches keep working) instead of losing its chain head (which
        would orphan every deeper page while they stayed pinned).
        Returns how many pages actually reached the free list.  Pages
        still held by live requests keep their retention (dropping it
        would free nothing)."""
        freed = 0
        for root in list(self._groups):
            if freed >= n:
                break
            members = sorted(
                (p for p, (_, r, _d) in self._retained.items()
                 if r == root),
                key=lambda p: -self._retained[p][2])      # deepest first
            for page in members:
                if freed >= n:
                    break
                if self.pool.refcount(page) == 1:
                    del self._retained[page]
                    freed += self.pool.free([page])
                    self._evictions += 1
            if not any(r == root
                       for (_, r, _d) in self._retained.values()):
                self._groups.pop(root, None)
        return freed

    def count_attach(self, n_pages: int) -> None:
        """Record one attach decision (called once per splice)."""
        self._lookups += 1
        if n_pages:
            self._hits += 1
            self._pages_attached += n_pages
            self._tokens_shared += n_pages * self.page_size

    def _sweep(self) -> None:
        """Drop every entry whose page died (freed or freed+reused).
        Live entries are bounded by the pool size — each references a
        live page at its current generation — so sweeping whenever the
        table outgrows a pool-sized bound keeps the registry O(pool)
        instead of O(total requests ever served)."""
        n = len(self._entries)
        self._entries = {k: e for k, e in self._entries.items()
                         if self._live(e)}
        self.writes += n - len(self._entries)

    def register(self, tokens: np.ndarray, block_pages: Sequence[int]
                 ) -> int:
        """Register the full-page chunks of ``tokens`` (all positions
        strictly below ``len(tokens)``) against the slot's block pages.
        Existing live entries are kept (first registrant wins — its page
        is the one sharers already hold); stale ones are replaced.
        Returns the number of entries written."""
        _, wrote = self.register_prefix(tokens, block_pages)
        return wrote

    def register_prefix(self, tokens: np.ndarray,
                        block_pages: Sequence[int],
                        state: Optional[Tuple] = None
                        ) -> Tuple[Tuple, int]:
        """Incremental :meth:`register` for chunked prefill: resume the
        chain from ``state`` (the opaque value a previous call returned
        for a strict prefix of the same ``tokens``) so each chunk of a
        long prompt registers its new full pages in O(chunk) instead of
        re-hashing the whole prefix.  Returns ``(state, wrote)``."""
        if len(self._entries) > max(64, 2 * self.pool.num_pages):
            self._sweep()
        ps = self.page_size
        tokens = np.asarray(tokens, np.int32)
        key, i, root = state if state is not None else (b"", 0, None)
        wrote = 0
        n = min(len(tokens) // ps, len(block_pages))
        while i < n:
            chunk = tokens[i * ps:(i + 1) * ps]
            key = self._chain(key, chunk)
            if root is None:
                root = key                   # prefix family = chunk-0 key
            e = self._entries.get(key)
            if e is not None and self._live(e) and \
                    np.array_equal(e.tokens, chunk):
                self._retain(e.page, root, i)
            else:
                page = int(block_pages[i])
                self._entries[key] = _PrefixEntry(
                    page, self.pool.generation(page), chunk.copy())
                self._retain(page, root, i)
                wrote += 1
            i += 1
        self.writes += wrote
        return (key, i, root), wrote

    def stats(self) -> PrefixStats:
        return PrefixStats(self._lookups, self._hits, self._pages_attached,
                           self._tokens_shared, len(self._entries),
                           len(self._retained), self._evictions)
