"""Index math shared by the CUDA kernels and their plain versions.

* ``kv_block_index`` and ``ctx_block_index``: twins of
  ``repro.kernels.paged_attention.kv_block_index`` and
  ``repro.kernels.paged_prefill.ctx_block_index``, the page the TPU
  kernels' K/V BlockSpecs address at each grid step.  The plain
  versions in ``ref.py`` gather their pages through them, and the CUDA
  kernels' key loops visit exactly the positions of the pages they
  leave unclamped.  Each works on Python ints and on broadcastable int
  tensors alike.
* ``packed_matmul_plan``: the launch plan of ``csrc/mixed_matmul.cu``
  (row tile, column tiles, the split of K across blocks, workspace
  size).  The launch code passes it to the kernel unchanged.
* ``paged_attention_plan`` and ``paged_prefill_plan``: the split of the
  key positions across blocks of ``csrc/paged_attention.cu`` and of the
  bf16 kernel of ``csrc/paged_prefill.cu``; ``attention_split_keys`` and
  ``prefill_split_keys`` give the live keys a block of a split visits,
  as the kernels compute them.
* ``paged_kv_bytes_per_token`` and ``paged_prefill_read_bytes``: the
  modeled K/V bytes of one prefill chunk call, as
  ``repro.kernels.autotune`` counts them (the engine's
  ``prefill_kv_read_bytes``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

# Channels per mma k-step; splits fall on k-step boundaries of each span,
# which are packed-byte boundaries (even in the int4 span, multiples of 8
# in the binary span).
PACKED_KSTEP = 16
# Most splits of K (the kernel's split table size): each adds an (M, N)
# f32 partial sum that the fold reads back.
PACKED_MAX_SPLITS = 16
# Fewest k-steps a split of K is given.
PACKED_MIN_STEPS = 4
# Output columns per block (4 warps of two 16-column mma tiles).
PACKED_BN = 128


def packed_nt(m: int) -> int:
    """8-row mma tiles per block for M rows: the least of 1, 2, 4, 8
    that holds M (one block covers at most 64 rows)."""
    return 1 if m <= 8 else 2 if m <= 16 else 4 if m <= 32 else 8


class PackedPlan(NamedTuple):
    """Launch plan of the packed matmul.

    ``nt``: 8-row mma tiles per block, so a block covers ``8*nt`` rows;
    ``row_groups``: blocks along M; ``col_tiles``: blocks along N;
    ``n4``/``nb``: k-steps of the int4 and binary spans (each span's last
    k-step zero-padded); ``bounds``: the splits of K, as cuts of the
    k-step sequence int4 then binary (``bounds[i]:bounds[i+1]`` is split
    i); ``ws_floats``: f32 workspace of the partial sums (0 for one
    split of one span), laid out (split, part, M, N) with part 0 the
    int4 sum and part 1 the binary sum; ``tiles``: output tiles
    (``col_tiles * row_groups``); ``xg_elems``: bf16 workspace of x gathered
    salient-first, (M, 16 * (n4 + nb))."""
    nt: int
    row_groups: int
    col_tiles: int
    n4: int
    nb: int
    bounds: Tuple[int, ...]
    ws_floats: int
    tiles: int
    xg_elems: int

    @property
    def splits(self) -> int:
        return len(self.bounds) - 1

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    def spans(self, i: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        """Channel ranges ``((a4, e4), (ab, eb))`` of split ``i`` within
        the int4 and binary spans, before clipping at the span's end."""
        lo, hi = self.bounds[i], self.bounds[i + 1]
        s = PACKED_KSTEP
        return ((min(lo, self.n4) * s, min(hi, self.n4) * s),
                (max(lo - self.n4, 0) * s, max(hi - self.n4, 0) * s))


def packed_matmul_plan(m: int, n: int, k: int, k_s: int, sms: int,
                       per_sm: int) -> PackedPlan:
    """Plan one launch of the packed matmul on a card with ``sms`` SMs,
    each of which holds ``per_sm`` blocks of the kernel at this M's row
    tile (``packed_nt(m)``) at once; the launch code asks the CUDA
    runtime for that number.

    Rows: one block covers up to 64 rows (``nt`` 8-row tiles, the least
    that holds M), so every weight is unpacked once per block; M > 64
    takes more row groups.  Columns: ``PACKED_BN`` per block.  K:
    split across blocks so that a launch fills one wave of resident
    blocks without exceeding it, each split at least ``PACKED_MIN_STEPS``
    k-steps, at most ``PACKED_MAX_SPLITS``.
    The cuts balance a cost per k-step: its packed bytes per column (8
    int4, 2 binary) plus the activation bytes it stages and the mma
    work, both of which grow with the rows."""
    if not (0 <= k_s <= k and k_s % 2 == 0 and (k - k_s) % 8 == 0):
        raise ValueError(f"packed_matmul_plan: k_s={k_s}, K={k} is not "
                         "a packable split (k_s even, k_b a multiple of 8)")
    nt = packed_nt(m)
    rows = 8 * nt
    row_groups = max(1, math.ceil(m / rows))
    col_tiles = max(1, math.ceil(n / PACKED_BN))
    n4 = math.ceil(k_s / PACKED_KSTEP)
    nb = math.ceil((k - k_s) / PACKED_KSTEP)
    total = n4 + nb
    tiles = col_tiles * row_groups
    slots = sms * per_sm
    splits = max(1, min(slots // tiles, PACKED_MAX_SPLITS,
                        total // PACKED_MIN_STEPS))
    extra = rows // 4 + rows // 8
    c4, cb = 8 + extra, 2 + extra
    cost4 = n4 * c4
    cost = cost4 + nb * cb
    bounds = [0]
    for i in range(1, splits):
        target = cost * i / splits
        if target <= cost4:
            j = math.ceil(target / c4)
        else:
            j = n4 + math.ceil((target - cost4) / cb)
        bounds.append(min(max(j, bounds[-1] + 1), total - (splits - i)))
    bounds.append(total)
    ws = splits * 2 * m * n if splits > 1 or (n4 and nb) else 0
    return PackedPlan(nt, row_groups, col_tiles, n4, nb, tuple(bounds), ws,
                      tiles, m * PACKED_KSTEP * total)


def kv_block_index(bi, j, bt_flat, lens, *, ps: int, nblk: int,
                   window: Optional[int]):
    """Pool page read at decode step ``(bi, j)``: steps past the last
    live page, before the sliding-window start, or on inactive rows
    clamp onto a live page; unassigned entries (-1) read page 0."""
    if isinstance(bi, torch.Tensor) or isinstance(j, torch.Tensor):
        length = torch.as_tensor(lens)[bi]
        last = torch.clamp_min(torch.div(length - 1, ps,
                                         rounding_mode="floor"), 0)
        if window is None:
            first = torch.zeros_like(last)
        else:
            first = torch.minimum(
                torch.div(torch.clamp_min(length - window, 0), ps,
                          rounding_mode="floor"), last)
        jj = torch.minimum(torch.maximum(torch.as_tensor(j), first), last)
        return torch.clamp_min(torch.as_tensor(bt_flat)[bi * nblk + jj], 0)
    length = int(lens[bi])
    last = max((length - 1) // ps, 0)
    first = 0 if window is None else min(max(length - window, 0) // ps, last)
    jj = min(max(j, first), last)
    return max(int(bt_flat[bi * nblk + jj]), 0)


def ctx_block_index(j, bt_read, start, *, ps: int, nblk: int,
                    window: Optional[int]):
    """Context page read at prefill step ``j``: steps past the last
    context page (``j*ps >= start``), before the sliding-window start, or
    on dead entries clamp onto a fetched page; -1 entries read page 0."""
    if isinstance(j, torch.Tensor):
        start = torch.as_tensor(start, device=j.device)
        last = torch.clamp_min(torch.div(start, ps, rounding_mode="floor")
                               - 1, 0)
        if window is None:
            first = torch.zeros_like(last)
        else:
            first = torch.minimum(
                torch.div(torch.clamp_min(start + 1 - window, 0), ps,
                          rounding_mode="floor"), last)
        jj = torch.minimum(torch.maximum(j, first), last)
        return torch.clamp_min(torch.as_tensor(bt_read)[jj], 0)
    start = int(start)
    last = max(start // ps - 1, 0)
    first = 0 if window is None else min(max(start + 1 - window, 0) // ps,
                                         last)
    jj = min(max(j, first), last)
    return max(int(bt_read[jj]), 0)


# Key positions per tile of the decode kernel (kKT in paged_attention.cu).
ATT_KT = 32
# The decode plan asks for this many waves of resident blocks over B x hkv
# x splits: a batch's contexts rarely fill the table, and the splits past
# a slot's length exit at once.
ATT_WAVES = 2
# Fewest key tiles a decode split covers: each split adds a partial that
# the combine reads back.
ATT_MIN_TILES = 2
# Query rows (chunk row x head in the GQA group, flattened) per block of
# the bf16 prefill kernel: 4 warps of one 16-row mma tile each.
PREFILL_ROWS = 64
# Waves of resident blocks the prefill plan asks for.
PREFILL_WAVES = 1


def prefill_key_tile(dh: int) -> int:
    """Key positions per tile of the bf16 prefill kernel: 64, or 32 when
    the head dim pads to 256 (the f32 output tile then fills the
    registers)."""
    return 64 if dh <= 128 else 32


class SplitPlan(NamedTuple):
    """Launch plan of a split attention kernel.

    ``splits``: blocks along the key positions per (row tile, kv head);
    split i covers positions ``[i*span, (i+1)*span)``; ``span``: a
    multiple of ``tile`` key positions; ``row_tiles``: query-row tiles
    per kv head (1 for decode); ``tile``: key positions per tile;
    ``blocks``: the grid's size.  Each split writes an f32 partial
    (m, l, acc) per query row, which a second kernel combines in split
    order; one split writes the output itself."""
    splits: int
    span: int
    row_tiles: int
    tile: int
    blocks: int

    def keys(self, i: int) -> Tuple[int, int]:
        return i * self.span, (i + 1) * self.span

    def ws_floats(self, rows: int, dh: int) -> int:
        """f32 workspace of the partials for ``rows`` query rows: (m, l)
        (splits, rows, 2) padded to 16 bytes, then acc (splits, rows,
        dh); none for one split."""
        if self.splits == 1:
            return 0
        return -(-self.splits * rows * 2 // 4) * 4 + self.splits * rows * dh


def _split(positions: int, tile: int, groups: int, slots: int,
           waves: int, min_tiles: int) -> Tuple[int, int]:
    tiles = max(1, math.ceil(positions / tile))
    want = max(1, math.ceil(waves * slots / groups))
    span_tiles = min(max(tiles // want, min_tiles, 1), tiles)
    return math.ceil(tiles / span_tiles), span_tiles * tile


def paged_attention_plan(b: int, hkv: int, nblk: int, ps: int, sms: int,
                         per_sm: int) -> SplitPlan:
    """Plan one decode launch over B slots of ``nblk`` pages of ``ps``
    keys on a card with ``sms`` SMs, each holding ``per_sm`` blocks of
    the kernel (the launch code asks the CUDA runtime).  The table's
    ``nblk * ps`` positions are cut into spans of whole ``ATT_KT`` tiles,
    at least ``ATT_MIN_TILES`` each, so that ``B * hkv * splits`` reaches
    ``ATT_WAVES`` waves of resident blocks where the table allows."""
    splits, span = _split(nblk * ps, ATT_KT, b * hkv, sms * per_sm,
                          ATT_WAVES, ATT_MIN_TILES)
    return SplitPlan(splits, span, 1, ATT_KT, b * hkv * splits)


def paged_prefill_plan(c: int, hq: int, hkv: int, dh: int, nblk: int,
                       ps: int, sms: int, per_sm: int) -> SplitPlan:
    """Plan one launch of the bf16 prefill kernel for a chunk of ``c``
    tokens.  A kv head's ``c * hq/hkv`` query rows go in tiles of
    ``PREFILL_ROWS``; the key positions ``[0, nblk*ps + c)`` (context and
    chunk) in spans of whole tiles, as few tiles a span as fill
    ``PREFILL_WAVES`` waves of ``sms * per_sm`` resident blocks.  Nothing here reads ``start``:
    the splits past a chunk's last key exit at once."""
    row_tiles = math.ceil(c * (hq // hkv) / PREFILL_ROWS)
    tile = prefill_key_tile(dh)
    splits, span = _split(nblk * ps + c, tile, hkv * row_tiles,
                          sms * per_sm, PREFILL_WAVES, 1)
    return SplitPlan(splits, span, row_tiles, tile,
                     hkv * row_tiles * splits)


def attention_split_keys(plan: SplitPlan, i: int, length: int,
                         window: Optional[int]) -> Tuple[int, int]:
    """Key positions ``[lo, hi)`` that split ``i`` of a decode slot of
    ``length`` live keys visits (empty when ``lo >= hi``: the split
    writes a neutral partial).  Pages of -1 inside are masked."""
    first = max(length - window, 0) if window else 0
    a, e = plan.keys(i)
    return max(a, first), min(e, length)


def prefill_split_keys(plan: SplitPlan, i: int, rt: int, c: int, rep: int,
                       start: int, length: int,
                       window: Optional[int]) -> Tuple[int, int]:
    """Key positions ``[lo, hi)`` that split ``i`` of query-row tile
    ``rt`` visits for a chunk of ``c`` rows at ``start`` with ``length``
    live tokens: the tile's chunk rows ``c_lo..c_hi`` see context from
    ``start + c_lo + 1 - window`` (or 0) up to the chunk's key
    ``start + min(c_hi + 1, length)``.  Per-row causality, the window and
    pages of -1 are masked inside."""
    r_lo = rt * PREFILL_ROWS
    c_lo = r_lo // rep
    c_hi = min((r_lo + PREFILL_ROWS - 1) // rep, c - 1)
    first = max(start + c_lo + 1 - window, 0) if window else 0
    a, e = plan.keys(i)
    return max(a, first), min(e, start + min(c_hi + 1, length))


def paged_kv_bytes_per_token(hkv: int, dh: int, itemsize: int = 2) -> int:
    """K+V bytes per live token over all kv heads."""
    return 2 * hkv * dh * itemsize


def paged_prefill_read_bytes(start: int, length: int, ps: int, hkv: int,
                             dh: int, itemsize: int = 2) -> int:
    """Modeled K/V bytes one chunk call at ``start`` with ``length`` live
    tokens moves: the context pages read once and the chunk's pages
    written once, whole pages (at most one page of slack each)."""
    ctx_pages = -(-max(int(start), 0) // ps)
    chunk_pages = -(-max(int(length), 0) // ps)
    return ((ctx_pages + chunk_pages) * ps
            * paged_kv_bytes_per_token(hkv, dh, itemsize))
