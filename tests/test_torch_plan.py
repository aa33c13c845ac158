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
import math

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
