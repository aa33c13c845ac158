"""The launch plan of the packed matmul (``index.packed_matmul_plan``).

The CUDA kernel (``csrc/mixed_matmul.cu``) takes the plan unchanged, so
these checks of its arithmetic run on the CPU: every channel of both
spans is covered exactly once, splits fall on packed-byte boundaries,
a decode launch fills one wave of resident blocks when K allows, and
summing the per-split partials in plan order (``_planned`` below, the
kernel's order of sums) gives the plain version's result to f32
rounding (rtol = atol = 1e-5; one wrong nibble or sign moves an output
by about 0.1).
"""
import ast
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import pack  # noqa: E402
from repro_torch.core.qlinear import QuantConfig, quantize_linear  # noqa: E402
from repro_torch.kernels import index as tidx  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

H100_SMS = 132
# resident blocks per SM by row tiles (nt), as the CUDA runtime reports
# them for the H100 build (chip_smoke.py prints them); the plan takes
# them as an argument, and its properties below hold for any values
H100_PER_SM = {1: 5, 2: 4, 4: 4, 8: 3}


def _plan(m, n, k, k_s, sms=H100_SMS):
    return tidx.packed_matmul_plan(m, n, k, k_s, sms,
                                   H100_PER_SM[tidx.packed_nt(m)])

# (K, N, k_s) of the main path's packed projections (LLaMA-7B, ratio 0.2,
# multiple 16): fused wqkv and wgu, wo (= wq = wk = wv unfused), wg = wu
# unfused, wd; then ragged shapes the packing allows.
MAIN = [(4096, 12288, 816), (4096, 22016, 816), (4096, 4096, 816),
        (4096, 11008, 816), (11008, 4096, 2208)]
RAGGED = [(1032, 130, 208), (1032, 96, 200), (256, 200, 48), (128, 40, 24),
          (64, 32, 0), (64, 32, 64), (8, 16, 0), (2, 16, 2), (3286, 130, 6)]


def _covered(plan, k, k_s):
    """Channels of the int4 and binary spans each split covers, clipped
    at the spans' ends, in split order."""
    k_b = k - k_s
    four, binary = [], []
    for i in range(plan.splits):
        (a4, e4), (ab, eb) = plan.spans(i)
        four.append((a4, min(e4, k_s)))
        binary.append((ab, min(eb, k_b)))
    return four, binary


@pytest.mark.parametrize("m", [1, 8, 64])
@pytest.mark.parametrize("k,n,k_s", MAIN + RAGGED)
def test_plan_covers_every_channel_once_on_byte_boundaries(m, k, n, k_s):
    plan = _plan(m, n, k, k_s)
    k_b = k - k_s
    assert plan.n4 == math.ceil(k_s / 16) and plan.nb == math.ceil(k_b / 16)
    assert plan.bounds[0] == 0 and plan.bounds[-1] == plan.n4 + plan.nb
    assert all(a < b for a, b in zip(plan.bounds, plan.bounds[1:])) \
        or plan.n4 + plan.nb == 0
    assert 1 <= plan.splits <= tidx.PACKED_MAX_SPLITS
    four, binary = _covered(plan, k, k_s)
    for spans, end, per in ((four, k_s, 2), (binary, k_b, 8)):
        seen = np.zeros(end, np.int64)
        for a, e in spans:
            if e > a:
                seen[a:e] += 1
                # a split starts and ends on a packed byte of its span
                assert a % per == 0 and (e % per == 0 or e == end)
        assert np.all(seen == 1)
    # one block owns both spans where a split straddles them
    straddle = [i for i in range(plan.splits)
                if four[i][1] > four[i][0] and binary[i][1] > binary[i][0]]
    assert len(straddle) <= 1
    rows = 8 * plan.nt
    assert rows >= min(m, 64) and plan.row_groups * rows >= m
    assert plan.col_tiles * tidx.PACKED_BN >= n
    assert plan.xg_elems == m * 16 * (plan.n4 + plan.nb)
    need_ws = plan.splits > 1 or (plan.n4 and plan.nb)
    assert plan.ws_floats == (plan.splits * 2 * m * n if need_ws else 0)


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("k,n,k_s", MAIN)
def test_decode_plan_fills_one_wave(m, k, n, k_s):
    """At M <= 8 a launch has as many blocks as fit the card at once
    without a second wave, unless K or the split cap stops it."""
    plan = _plan(m, n, k, k_s)
    slots = H100_SMS * H100_PER_SM[plan.nt]
    assert plan.blocks <= slots
    capped = plan.splits in (
        tidx.PACKED_MAX_SPLITS,
        (plan.n4 + plan.nb) // tidx.PACKED_MIN_STEPS)
    assert capped or plan.blocks + plan.tiles > slots
    assert plan.blocks >= H100_SMS            # every SM has work


def test_plan_refuses_unpackable_splits():
    for k, k_s in ((64, 3), (64, 66), (70, 4)):     # odd k_s, k_s > K, k_b % 8
        with pytest.raises(ValueError):
            _plan(8, 32, k, k_s)


def _planned(x, w4, s4, z4, bits, alpha_s, alpha_r1, alpha_r2, plan,
             perm=None):
    """``ref.mixed_matmul_ref`` summed in the order of ``plan``: one f32
    partial sum per split and span, summed in split order, the binary
    sum scaled once at the end; (M, N) f32."""
    if perm is not None:
        x = x[:, perm.long()]
    xf = x.to(torch.bfloat16).float()
    k_s = w4.shape[-2] * 2
    q = pack.unpack_nibbles(w4, axis=-2, dtype=torch.float32)
    w = ((q - z4[:, None]) * s4[:, None]).to(torch.bfloat16).float()
    xb = (xf[:, k_s:] * alpha_r2[None, :]).to(torch.bfloat16).float()
    sign = pack.unpack_bits(bits, axis=-2, dtype=torch.float32)
    n = bits.shape[1] if bits.numel() else w4.shape[1]
    y4 = torch.zeros((x.shape[0], n))
    yb = torch.zeros_like(y4)
    for i in range(plan.splits):
        (a4, e4), (ab, eb) = plan.spans(i)
        e4, eb = min(e4, k_s), min(eb, xb.shape[1])
        if e4 > a4:
            y4 = y4 + xf[:, a4:e4] @ w[a4:e4]
        if eb > ab:
            yb = yb + xb[:, ab:eb] @ sign[ab:eb]
    return y4 + yb * (alpha_s * alpha_r1)[None, :]


def _operands(rng, k, n, k_s):
    """Random packed operands (numpy-made) with k_s int4 channels."""
    k_b = k - k_s
    f32 = np.float32
    return {key: torch.from_numpy(np.ascontiguousarray(v)) for key, v in dict(
        w4=rng.integers(0, 256, (k_s // 2, n), dtype=np.uint8),
        s4=(0.001 + 0.01 * rng.random(k_s)).astype(f32),
        z4=rng.integers(0, 16, k_s).astype(f32),
        bits=rng.integers(0, 256, (k_b // 8, n), dtype=np.uint8),
        alpha_s=(0.01 + rng.random(n)).astype(f32),
        alpha_r1=(0.5 + rng.random(n)).astype(f32),
        alpha_r2=(0.5 + rng.random(k_b)).astype(f32),
        perm=rng.permutation(k).astype(np.int32)).items()}


@pytest.mark.parametrize("m", [1, 8, 64])
@pytest.mark.parametrize("k,n,k_s,sms", [
    (1032, 130, 208, H100_SMS), (256, 96, 48, H100_SMS), (1032, 650, 208, 1),
    (64, 32, 0, H100_SMS), (64, 32, 64, H100_SMS), (2200, 64, 440, 8)])
def test_plan_order_sum_matches_plain_version(m, k, n, k_s, sms):
    rng = np.random.default_rng(1000 * m + k_s)
    ops = _operands(rng, k, n, k_s)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(
        torch.bfloat16).float()
    plan = _plan(m, n, k, k_s, sms)
    if sms == 1:
        assert plan.splits == 1                 # one block owns both spans
    y = _planned(x, plan=plan, **ops)
    y_ref = tref.mixed_matmul_ref(x, **ops)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)


def test_plan_order_sum_at_a_main_path_shape():
    """wo's shape (K = N = 4096) quantized as the main path does; the
    decode plan splits K 16 ways."""
    g = torch.Generator().manual_seed(0)
    w = (torch.randn(4096, 4096, generator=g) / 64).to(torch.bfloat16)
    q = quantize_linear(w, None, QuantConfig(ratio=0.2, multiple=16))
    x = torch.randn(8, 4096, generator=g).to(torch.bfloat16).float()
    plan = _plan(8, q.n, q.k, q.k_s)
    assert plan.splits > 1
    args = (x, q.w4, q.s4, q.z4, q.bits, q.alpha_s, q.alpha_r1, q.alpha_r2)
    torch.testing.assert_close(
        _planned(*args, plan=plan, perm=q.perm),
        tref.mixed_matmul_ref(*args, perm=q.perm), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The split plans of the attention kernels (paged_attention_plan,
# paged_prefill_plan).  ``_planned_attention`` and ``_planned_prefill``
# compute each split's f32 partial (m, l, acc) over the keys the kernel
# visits (``attention_split_keys`` / ``prefill_split_keys``) and combine
# them in split order, as combine_splits_kernel does; with f32 inputs they
# match the plain versions to f32 rounding (1e-5) and the JAX functions at
# the parity tolerance of tests/test_torch_kernels.py (atol 1e-5).
# ---------------------------------------------------------------------------
NEG = -1e30


def _combine(parts):
    """Partials (m, l, acc) combined in split order; rows with every
    split empty are zeros."""
    big = torch.full_like(parts[0][0], NEG)
    for m, l, _ in parts:
        big = torch.where(l > 0, torch.maximum(big, m), big)
    den = torch.zeros_like(parts[0][1])
    num = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.where(l > 0, torch.exp(m - big), 0.0)
        den = den + w * l
        num = num + w * acc
    return torch.where(den > 0, num / torch.clamp_min(den, 1e-30), 0.0)


def _partial(s, mask, v, vdtype):
    """One split's (m, l, acc): scores s (..., K), keys mask (..., K),
    values v (..., K, dh) in f32; probabilities rounded to ``vdtype``
    for the PV product."""
    s = torch.where(mask, s, NEG)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    return m, l, p.to(vdtype).float() @ v


def _planned_attention(q, kp, vp, bt, lens, plan, window=None, softcap=None):
    b, hq, dh = q.shape
    _, ps, hkv, _ = kp.shape
    nblk = bt.shape[1]
    rep = hq // hkv
    pages = bt.clamp_min(0).long()
    k = kp[pages].reshape(b, nblk * ps, hkv, dh).float().permute(0, 2, 1, 3)
    v = vp[pages].reshape(b, nblk * ps, hkv, dh).float().permute(0, 2, 1, 3)
    s = q.reshape(b, hkv, rep, dh).float() @ k.transpose(-1, -2) / math.sqrt(dh)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(nblk * ps)
    live = (bt >= 0).repeat_interleave(ps, dim=1)
    parts = []
    for i in range(plan.splits):
        lo, hi = zip(*(tidx.attention_split_keys(plan, i, int(n), window)
                       for n in lens))
        mask = live & (pos >= torch.tensor(lo)[:, None]) & (
            pos < torch.tensor(hi)[:, None])
        parts.append(_partial(s, mask[:, None, None, :], v,
                              vp.dtype))
    return _combine(parts).reshape(b, hq, dh)


def _planned_prefill(q, kn, vn, kp, bt, start, length, plan, layer,
                     vp, window=None, softcap=None):
    """The chunk's attention output (the pool writes are the plain
    version's, checked elsewhere); context keys from the pool, chunk keys
    from kn / vn, at positions 0 .. nblk*ps + C."""
    c, hq, dh = q.shape
    _, _, ps, hkv, _ = kp.shape
    nblk = bt.shape[0]
    rep = hq // hkv
    npos = nblk * ps + c
    pos = torch.arange(npos)
    k = torch.zeros(npos, hkv, dh)
    v = torch.zeros(npos, hkv, dh)
    ok = torch.zeros(npos, dtype=torch.bool)
    for t in range(start):
        page = int(bt[t // ps])
        if page >= 0:
            k[t], v[t], ok[t] = kp[layer, page, t % ps], vp[layer, page, t % ps], True
    k[start:start + c], v[start:start + c] = kn.float(), vn.float()
    ok[start:start + length] = True
    qh = q.reshape(c, hkv, rep, dh).permute(1, 2, 0, 3).float()
    s = qh @ k.permute(1, 2, 0)[:, None] / math.sqrt(dh)     # (hkv, rep, c, K)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qp = start + torch.arange(c)[:, None]
    vis = ok & (pos <= qp)
    if window is not None:
        vis = vis & (qp - pos < window)
    rt = (torch.arange(c)[:, None] * rep + torch.arange(rep)) // 64  # (c, rep)
    parts = []
    for i in range(plan.splits):
        bounds = [tidx.prefill_split_keys(plan, i, r, c, rep, start, length,
                                          window)
                  for r in range(plan.row_tiles)]
        lo = torch.tensor([a for a, _ in bounds])[rt].T[..., None]  # (rep, c, 1)
        hi = torch.tensor([e for _, e in bounds])[rt].T[..., None]
        mask = vis[None] & (pos >= lo) & (pos < hi)
        parts.append(_partial(s, mask[None], v.permute(1, 0, 2)[:, None],
                              vp.dtype))
    o = _combine(parts)                                       # (hkv, rep, c, dh)
    return o.permute(2, 0, 1, 3).reshape(c, hq, dh)


def _attention_arrays(rng, *, b, hkv, rep, dh, ps, lens, freed=(), extra=2):
    nblk = max(-(-n // ps) for n in lens) + extra
    need = sum(-(-n // ps) for n in lens)
    pages = rng.permutation(need + 3)
    bt = np.full((b, nblk), -1, np.int32)
    used = 0
    for i, n in enumerate(lens):
        k = -(-n // ps)
        bt[i, :k] = pages[used:used + k]
        used += k
    for (i, j) in freed:
        bt[i, j] = -1
    shape = (need + 3, ps, hkv, dh)
    return (2 * rng.normal(size=(b, hkv * rep, dh)).astype(np.float32),
            rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32), bt,
            np.asarray(lens, np.int32))


ATT_CASES = [   # (rep, lens, freed, window, softcap, sms)
    (1, [200, 37, 0, 130, 64], ((0, 20),), None, None, 132),
    (2, [200, 5, 0, 129, 64], (), 45, 30.0, 132),
    (4, [150, 150, 1, 0, 99], ((1, 3), (4, 0)), None, None, 4),
    (1, [0, 0, 0, 0, 0], (), None, None, 132),
    # recurrentgemma's group of 10 (three passes of 4 rows in the kernel)
    # with a window that cuts keys off
    (10, [300, 70, 0, 129, 64], ((0, 20),), 45, None, 132),
]


@pytest.mark.parametrize("rep,lens,freed,window,softcap,sms", ATT_CASES)
def test_attention_splits_cover_every_live_key_once(rep, lens, freed, window,
                                                    softcap, sms):
    ps = 4
    nblk = max(-(-n // ps) for n in lens) + 2
    plan = tidx.paged_attention_plan(len(lens), 2, nblk, ps, sms, 1)
    assert plan.span % tidx.ATT_KT == 0
    assert plan.splits * plan.span >= nblk * ps > (plan.splits - 1) * plan.span
    assert plan.blocks == len(lens) * 2 * plan.splits
    for n in lens:
        first = max(n - window, 0) if window else 0
        seen = np.zeros(nblk * ps, np.int64)
        for i in range(plan.splits):
            lo, hi = tidx.attention_split_keys(plan, i, n, window)
            if hi > lo:
                seen[lo:hi] += 1
        want = np.zeros(nblk * ps, np.int64)
        want[first:n] = 1
        np.testing.assert_array_equal(seen, want)


@pytest.mark.parametrize("rep,lens,freed,window,softcap,sms", ATT_CASES)
def test_attention_plan_order_matches_plain_and_repro(rep, lens, freed,
                                                      window, softcap, sms):
    rng = np.random.default_rng(7 * rep + len(freed))
    arrs = _attention_arrays(rng, b=len(lens), hkv=2, rep=rep, dh=16, ps=4,
                             lens=lens, freed=freed)
    q, kp, vp, bt, ln = (torch.from_numpy(a) for a in arrs)
    plan = tidx.paged_attention_plan(len(lens), 2, bt.shape[1], 4, sms, 1)
    if sms < 2 * len(lens):
        assert plan.splits == 1              # the blocks write the output
    elif max(lens) > 128:
        assert plan.splits > 1
    o = _planned_attention(q, kp, vp, bt, lens, plan, window, softcap)
    assert not torch.isnan(o).any()
    o_ref = tref.paged_attention_ref(q, kp, vp, bt, ln, window=window,
                                     softcap=softcap)
    torch.testing.assert_close(o, o_ref, rtol=1e-5, atol=1e-5)
    jax = pytest.importorskip("jax")
    from repro.kernels.paged_attention import paged_attention as r_pa
    o_r = np.asarray(r_pa(*(jax.numpy.asarray(a) for a in arrs),
                          window=window, softcap=softcap, interpret=True))
    active = ln.numpy() > 0
    np.testing.assert_allclose(o.numpy()[active], o_r[active], rtol=0,
                               atol=1e-5)
    assert np.all(o.numpy()[~active] == 0.0)


def test_attention_plan_fills_a_wave_at_the_serving_shapes():
    """B = 8, hkv = 32, ps = 16: the serving table (nblk = 32) and
    chip_smoke's (nblk = 64) give at least one wave of resident blocks
    for any residency, where the table allows it."""
    for nblk in (32, 64):
        for per_sm in (1, 2, 4, 6, 8):
            plan = tidx.paged_attention_plan(8, 32, nblk, 16, H100_SMS,
                                             per_sm)
            tiles = nblk * 16 // tidx.ATT_KT
            assert plan.blocks >= H100_SMS * per_sm
            assert plan.span // tidx.ATT_KT >= min(tidx.ATT_MIN_TILES, tiles)


def test_attention_plan_at_the_hybrid_decode_shape():
    """recurrentgemma-2b's decode: B = 8, one KV head (hq 10, dh 256),
    pages of 16, tables of 32 pages (max_seq 512) and 256 (max_seq
    4096).  Only 8 (slot, head) pairs: the plan splits the keys as far
    as the shortest span (``ATT_MIN_TILES`` tiles) allows, which fills a
    wave of resident blocks on the long table and cannot on the short
    one (16 tiles, at most 8 splits, 64 blocks)."""
    for nblk in (32, 256):
        tiles = nblk * 16 // tidx.ATT_KT
        most = 8 * (tiles // tidx.ATT_MIN_TILES)
        for per_sm in (1, 2, 4):
            plan = tidx.paged_attention_plan(8, 1, nblk, 16, H100_SMS,
                                             per_sm)
            assert plan.span % tidx.ATT_KT == 0
            assert plan.span // tidx.ATT_KT >= tidx.ATT_MIN_TILES
            assert plan.splits * plan.span >= nblk * 16
            assert plan.blocks == 8 * plan.splits
            assert plan.blocks >= min(H100_SMS * per_sm, most)
    assert tidx.paged_attention_plan(8, 1, 32, 16, H100_SMS, 2).splits == 8
    # a window of 2048 keys over the long table: the splits before the
    # window's start write neutral partials
    plan = tidx.paged_attention_plan(8, 1, 256, 16, H100_SMS, 2)
    live = [i for i in range(plan.splits)
            if np.subtract(*tidx.attention_split_keys(plan, i, 3000,
                                                      2048)[::-1]) > 0]
    assert sum(np.subtract(*tidx.attention_split_keys(plan, i, 3000,
                                                      2048)[::-1])
               for i in live) == 2048
    assert live[0] > 0


PREFILL_CASES = [   # (rep, start, length, window, softcap, freed, dh)
    (1, 96, 16, None, None, (), 16),        # keys over several splits
    (2, 104, 11, None, None, (3,), 16),     # ragged, a freed context page
    (4, 40, 16, 20, 30.0, (), 16),          # GQA 4, window + softcap
    (2, 0, 16, None, None, (), 16),         # first chunk, no context
    (1, 136, 16, None, None, (), 200),      # dh > 128: 32-key tiles
    (4, 8, 5, None, None, (0,), 16),        # chunk straddling pages
]


def _prefill_plan(rep, dh, sms=H100_SMS, per_sm=2):
    return tidx.paged_prefill_plan(16, 2 * rep, 2, dh, 24, 8, sms, per_sm)


@pytest.mark.parametrize("rep,start,length,window,softcap,freed,dh",
                         PREFILL_CASES)
def test_prefill_splits_cover_every_visible_key_once(rep, start, length,
                                                     window, softcap, freed,
                                                     dh):
    c, ps, nblk = 16, 8, 24
    plan = _prefill_plan(rep, dh)
    assert plan.row_tiles == -(-c * rep // tidx.PREFILL_ROWS)
    assert plan.tile == tidx.prefill_key_tile(dh)
    assert plan.span % plan.tile == 0
    assert plan.splits * plan.span >= nblk * ps + c
    assert plan.blocks == 2 * plan.row_tiles * plan.splits
    for rt in range(plan.row_tiles):
        ranges = [tidx.prefill_split_keys(plan, i, rt, c, rep, start, length,
                                          window)
                  for i in range(plan.splits)]
        for gi in range(rt * 64, min(rt * 64 + 64, c * rep)):
            qp = start + gi // rep
            visible = [t for t in range(start + length)
                       if t <= qp and (window is None or qp - t < window)]
            for t in visible:
                assert sum(lo <= t < hi for lo, hi in ranges) == 1, (gi, t)


@pytest.mark.parametrize("rep,start,length,window,softcap,freed,dh",
                         PREFILL_CASES)
def test_prefill_plan_order_matches_plain_and_repro(rep, start, length,
                                                    window, softcap, freed,
                                                    dh):
    c, ps, nblk, pool_pages, hkv = 16, 8, 24, 30, 2
    rng = np.random.default_rng(start + length + rep)
    kp = rng.normal(size=(2, pool_pages + 1, ps, hkv, dh)).astype(np.float32)
    vp = rng.normal(size=kp.shape).astype(np.float32)
    n_pages = -(-(start + length) // ps)
    bt = np.full((nblk,), -1, np.int32)
    bt[:n_pages] = rng.permutation(pool_pages)[:n_pages]
    for j in freed:
        bt[j] = -1
    btw = bt.copy()
    q = rng.normal(size=(c, hkv * rep, dh)).astype(np.float32)
    kn = rng.normal(size=(c, hkv, dh)).astype(np.float32)
    vn = rng.normal(size=(c, hkv, dh)).astype(np.float32)
    plan = _prefill_plan(rep, dh)
    if start >= 96:
        assert plan.splits > 1 and plan.span <= start
    t = {k: torch.from_numpy(v) for k, v in dict(
        q=q, kn=kn, vn=vn, bt=bt, btw=btw).items()}
    kr, vr = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    o_ref = tref.paged_prefill_ref(t["q"], t["kn"], t["vn"], kr, vr, t["bt"],
                                   t["btw"], start, length, layer=1,
                                   window=window, softcap=softcap)
    o = _planned_prefill(t["q"], t["kn"], t["vn"], torch.from_numpy(kp),
                         t["bt"], start, length, plan, 1,
                         torch.from_numpy(vp), window, softcap)
    torch.testing.assert_close(o[:length], o_ref[:length], rtol=1e-5,
                               atol=1e-5)
    jax = pytest.importorskip("jax")
    from repro.kernels.paged_prefill import paged_prefill_xla
    o_r = paged_prefill_xla(*(jax.numpy.asarray(a) for a in (
        q, kn, vn, kp, vp, bt, btw)), start, length, layer=1, window=window,
        softcap=softcap)[0]
    np.testing.assert_allclose(o.numpy()[:length], np.asarray(o_r)[:length],
                               rtol=0, atol=1e-5)


def test_prefill_plan_fills_a_wave_at_the_serving_shape():
    """C = 64, LLaMA-7B (hq = hkv = 32, dh = 128), nblk = 32, ps = 16: at
    the two blocks an SM holds of the dh-128 kernel (87.5 KB of shared
    memory each), the grid holds one wave on 132 SMs; at any residency it
    splits as finely as the key tile allows or fills the wave."""
    for per_sm in (1, 2, 3, 4):
        plan = tidx.paged_prefill_plan(64, 32, 32, 128, 32, 16, H100_SMS,
                                       per_sm)
        tiles = -(-(32 * 16 + 64) // plan.tile)
        assert plan.row_tiles == 1
        assert plan.blocks >= H100_SMS * per_sm or plan.splits == tiles
    assert tidx.paged_prefill_plan(64, 32, 32, 128, 32, 16, H100_SMS,
                                   2).blocks >= 2 * H100_SMS


@pytest.mark.parametrize("module", ["paged_attention", "paged_prefill"])
def test_attention_wrappers_read_nothing_back_from_the_device(module):
    """Both attention wrappers take their plans from host-known shapes:
    no ``.item()``, ``.tolist()``, ``.cpu()`` or ``.numpy()`` anywhere in
    the module (the CPU route is ``ref.py``), so a CUDA call never
    waits for the card and can be captured in a CUDA graph."""
    path = (Path(tidx.__file__).parent / f"{module}.py")
    calls = {node.func.attr for node in ast.walk(ast.parse(path.read_text()))
             if isinstance(node, ast.Call)
             and isinstance(node.func, ast.Attribute)}
    assert not calls & {"item", "tolist", "cpu", "numpy"}, calls
