"""Port parity: the kernels' plain PyTorch versions against the ``repro``
Pallas kernels (run in interpret mode on the CPU, as ``repro``'s own
tests run them), and the shared index maps.  The CUDA kernels themselves
are held against the plain versions in ``tests/test_torch_cuda.py``.

Tolerances:
  * mixed_matmul, binary_matmul, int4_matmul: rtol = atol = 1e-5 on the
    f32 accumulators.  Both sides round the operands to bf16 the same
    way and accumulate in f32; only the order of the sums differs, while
    one wrong nibble or sign bit moves an output by about 0.1.
  * paged attention / prefill: f32 throughout, atol 1e-5 (the page-tile
    online softmax against the dense softmax differs by f32 rounding).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import pack as rpack  # noqa: E402
from repro.core import qlinear as rql  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.kernels.binary_matmul import binary_matmul as r_binary  # noqa: E402
from repro.kernels.int4_matmul import int4_matmul as r_int4  # noqa: E402
from repro.kernels import autotune as rautotune  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels.mixed_matmul import mixed_matmul as r_mixed  # noqa: E402
from repro.kernels.paged_attention import kv_block_index as r_kv_index  # noqa: E402
from repro.kernels.paged_prefill import ctx_block_index as r_ctx_index  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import binary_matmul as tbm  # noqa: E402
from repro_torch.kernels import index as tidx  # noqa: E402
from repro_torch.kernels import int4_matmul as tim  # noqa: E402
from repro_torch.kernels import mixed_matmul as tmm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import paged_prefill as tpf  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

MM_RTOL = MM_ATOL = 1e-5
ATTN_ATOL = 1e-5


def _t(a):
    return bridge.to_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# mixed_matmul
# ---------------------------------------------------------------------------
def _qlinear_pair(k, n, ratio, seed):
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.normal(size=(k, n)) / np.sqrt(k), jnp.bfloat16)
    rq = rql.quantize_linear(w, None, rql.QuantConfig(
        ratio=ratio, multiple=16, use_kernel=True))
    return rq, bridge.convert(jax.tree.map(np.asarray, rq))


@pytest.mark.parametrize("m", [1, 5, 16])
@pytest.mark.parametrize("gather", [True, False])
def test_mixed_matmul_plain_matches_repro_kernel(m, gather):
    """k_s = 48, k_b = 208: a split no common 128 tile fits.  The Pallas
    kernel is called directly (``ops.mixed_matmul`` would route N=96 to
    the XLA dequant path), on f32 activations that hold bf16 values, so
    that both sides return their f32 accumulators."""
    k, n = 256, 96
    rq, tq = _qlinear_pair(k, n, 0.1875, seed=m)
    assert (tq.k_s, tq.k_b) == (48, 208)
    x = np.array(jnp.asarray(
        np.random.default_rng(m + 100).normal(size=(m, k)), jnp.bfloat16
    ).astype(jnp.float32))
    xr = x if gather else x[:, np.asarray(rq.perm)]
    y_r = r_mixed(jnp.asarray(xr), rq.w4, rq.s4, rq.z4, rq.bits,
                  (rq.alpha_s * rq.alpha_r1).astype(jnp.float32),
                  rq.alpha_r2.astype(jnp.float32),
                  perm=rq.perm if gather else None, bm=m, bn=n,
                  bk=rautotune.common_bk(tq.k_s, tq.k_b), interpret=True)
    perm = tq.perm if gather else None
    y_t = tref.mixed_matmul_ref(torch.from_numpy(xr), tq.w4, tq.s4, tq.z4,
                                tq.bits, tq.alpha_s, tq.alpha_r1,
                                tq.alpha_r2, perm=perm)
    assert y_t.dtype == torch.float32 and y_r.dtype == jnp.float32
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r),
                               rtol=MM_RTOL, atol=MM_ATOL)
    # the CPU wrapper returns the plain version rounded once to bf16
    xt = torch.from_numpy(xr).to(torch.bfloat16)
    y_w = (tops.mixed_matmul(xt, tq) if gather else tmm.mixed_matmul(
        xt, tq.w4, tq.s4, tq.z4, tq.bits, tq.alpha_s, tq.alpha_r1,
        tq.alpha_r2))
    assert torch.equal(y_w, y_t.to(torch.bfloat16))


def test_mixed_matmul_plain_matches_dequant_oracle():
    """The plain version equals dequantize-then-matmul on bf16-rounded
    operands (exact roundings, f32 accumulation)."""
    _, tq = _qlinear_pair(128, 40, 0.25, seed=4)
    x = torch.randn(3, 128, generator=torch.Generator().manual_seed(0))
    y = tref.mixed_matmul_ref(x, tq.w4, tq.s4, tq.z4, tq.bits, tq.alpha_s,
                              tq.alpha_r1, tq.alpha_r2, perm=tq.perm)
    xp = x.to(torch.bfloat16).float()[:, tq.perm.long()]
    y4 = xp[:, :tq.k_s] @ tq.dequant_salient(torch.bfloat16).float()
    xb = (xp[:, tq.k_s:] * tq.alpha_r2).to(torch.bfloat16).float()
    from repro_torch.core import pack
    yb = (xb @ pack.unpack_bits(tq.bits, dtype=torch.float32)) * (
        tq.alpha_s * tq.alpha_r1)
    torch.testing.assert_close(y, y4 + yb, rtol=1e-5, atol=1e-5)


def test_mixed_matmul_cpu_tensor_takes_plain_version():
    _, tq = _qlinear_pair(64, 32, 0.25, seed=5)
    before = tmm.KERNEL.launches
    y = tops.mixed_matmul(torch.randn(2, 64), tq)
    assert y.shape == (2, 32) and y.dtype == torch.float32
    assert tmm.KERNEL.launches == before


# ---------------------------------------------------------------------------
# binary_matmul and int4_matmul
# ---------------------------------------------------------------------------
def _bf16_values(rng, shape):
    """f32 array holding bf16 values: both sides then return their f32
    accumulators."""
    return np.array(jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
                    .astype(jnp.float32))


def _binary_case(rng, k, n, pow2):
    signs = rng.choice([-1.0, 1.0], size=(k, n)).astype(np.float32)
    bits = np.array(rpack.pack_bits(jnp.asarray(signs), axis=-2))
    if pow2:
        a_in = 2.0 ** rng.integers(-2, 3, k)
    else:
        a_in = rng.uniform(0.5, 2.0, k)
    a_out = rng.uniform(0.5, 2.0, n)
    return bits, a_out.astype(np.float32), a_in.astype(np.float32)


def _int4_case(rng, k, n, pow2):
    q = rng.integers(0, 16, size=(k, n)).astype(np.uint8)
    w4 = np.array(rpack.pack_nibbles(jnp.asarray(q), axis=-2))
    if pow2:
        s4 = 2.0 ** rng.integers(-7, -3, k)
    else:
        s4 = rng.uniform(0.01, 0.1, k)
    z4 = rng.integers(0, 16, k).astype(np.float32)
    return w4, s4.astype(np.float32), z4


SPAN_SHAPES = [(1, 64, 32), (5, 128, 48), (16, 256, 96)]


@pytest.mark.parametrize("m,k,n", SPAN_SHAPES)
def test_binary_matmul_plain_matches_repro_kernel(m, k, n):
    rng = np.random.default_rng(m * 1000 + k)
    x = _bf16_values(rng, (m, k))
    bits, a_out, a_in = _binary_case(rng, k, n, pow2=False)
    y_r = r_binary(jnp.asarray(x), jnp.asarray(bits), jnp.asarray(a_out),
                   jnp.asarray(a_in), bm=m, bn=n, bk=k, interpret=True)
    y_t = tbm.binary_matmul(*map(torch.from_numpy, (x, bits, a_out, a_in)))
    assert y_t.dtype == torch.float32 and y_r.dtype == jnp.float32
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), rtol=MM_RTOL,
                               atol=MM_ATOL)
    # bf16 in, bf16 out: the accumulator rounded once
    y_b = tbm.binary_matmul(torch.from_numpy(x).to(torch.bfloat16),
                            *map(torch.from_numpy, (bits, a_out, a_in)))
    assert torch.equal(y_b, y_t.to(torch.bfloat16))


@pytest.mark.parametrize("m,k,n", SPAN_SHAPES)
def test_int4_matmul_plain_matches_repro_kernel(m, k, n):
    rng = np.random.default_rng(m * 1000 + k + 1)
    x = _bf16_values(rng, (m, k))
    w4, s4, z4 = _int4_case(rng, k, n, pow2=False)
    y_r = r_int4(jnp.asarray(x), jnp.asarray(w4), jnp.asarray(s4),
                 jnp.asarray(z4), bm=m, bn=n, bk=k, interpret=True)
    y_t = tim.int4_matmul(*map(torch.from_numpy, (x, w4, s4, z4)))
    assert y_t.dtype == torch.float32 and y_r.dtype == jnp.float32
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), rtol=MM_RTOL,
                               atol=MM_ATOL)
    y_b = tim.int4_matmul(torch.from_numpy(x).to(torch.bfloat16),
                          *map(torch.from_numpy, (w4, s4, z4)))
    assert torch.equal(y_b, y_t.to(torch.bfloat16))


@pytest.mark.parametrize("m,k,n", SPAN_SHAPES)
def test_span_plain_versions_match_repro_refs(m, k, n):
    """``repro``'s refs skip the kernels' bf16 rounding of x·α_in and of
    (q−z)·s.  With power-of-two α_in and s those products are exact in
    bf16, so the two agree to summation order."""
    rng = np.random.default_rng(m * 1000 + k + 2)
    x = _bf16_values(rng, (m, k))
    bits, a_out, a_in = _binary_case(rng, k, n, pow2=True)
    np.testing.assert_allclose(
        tref.binary_matmul_ref(*map(torch.from_numpy,
                                    (x, bits, a_out, a_in))).numpy(),
        np.asarray(rref.binary_matmul_ref(*map(jnp.asarray,
                                               (x, bits, a_out, a_in)))),
        rtol=MM_RTOL, atol=MM_ATOL)
    w4, s4, z4 = _int4_case(rng, k, n, pow2=True)
    np.testing.assert_allclose(
        tref.int4_matmul_ref(*map(torch.from_numpy, (x, w4, s4, z4))).numpy(),
        np.asarray(rref.int4_matmul_ref(*map(jnp.asarray, (x, w4, s4, z4)))),
        rtol=MM_RTOL, atol=MM_ATOL)


def test_span_kernels_are_ops_exports_and_cpu_takes_plain_version():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(_bf16_values(rng, (3, 64)))
    bits, a_out, a_in = map(torch.from_numpy, _binary_case(rng, 64, 16,
                                                           False))
    w4, s4, z4 = map(torch.from_numpy, _int4_case(rng, 64, 16, False))
    before = (tbm.KERNEL.launches, tim.KERNEL.launches)
    assert torch.equal(tops.binary_matmul(x, bits, a_out, a_in),
                       tref.binary_matmul_ref(x, bits, a_out, a_in))
    assert torch.equal(tops.int4_matmul(x, w4, s4, z4),
                       tref.int4_matmul_ref(x, w4, s4, z4))
    assert (tbm.KERNEL.launches, tim.KERNEL.launches) == before
    assert {"binary_matmul", "int4_matmul"} <= set(tops.__all__)


def test_span_plain_versions_are_mixed_with_one_span_empty():
    """binary_matmul and int4_matmul run the packed-matmul body with one
    span empty: their plain versions equal mixed_matmul's with k_s = 0
    (output scale α_s·α_r1, input scale α_r2) and with k_b = 0."""
    rng = np.random.default_rng(7)
    m, k, n = 5, 96, 40
    x = torch.from_numpy(_bf16_values(rng, (m, k)))
    perm = torch.from_numpy(rng.permutation(k).astype(np.int32))
    xp = x[:, perm.long()]
    bits, a_s, a_in = map(torch.from_numpy, _binary_case(rng, k, n, False))
    a_r1 = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
    none = (torch.zeros((0, n), dtype=torch.uint8), torch.zeros(0),
            torch.zeros(0))
    torch.testing.assert_close(
        tref.mixed_matmul_ref(x, *none, bits, a_s, a_r1, a_in, perm=perm),
        tref.binary_matmul_ref(xp, bits, a_s * a_r1, a_in), rtol=0, atol=0)
    w4, s4, z4 = map(torch.from_numpy, _int4_case(rng, k, n, False))
    torch.testing.assert_close(
        tref.mixed_matmul_ref(x, w4, s4, z4, torch.zeros((0, n),
                                                         dtype=torch.uint8),
                              a_s, a_r1, torch.zeros(0), perm=perm),
        tref.int4_matmul_ref(xp, w4, s4, z4), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------
def _paged_attention_case(rng, *, b, hkv, rep, dh, ps, lens, freed=()):
    nblk = max(-(-n // ps) for n in lens) + 2
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
    pp = need + 3
    kp = rng.normal(size=(pp, ps, hkv, dh)).astype(np.float32)
    vp = rng.normal(size=(pp, ps, hkv, dh)).astype(np.float32)
    q = (2 * rng.normal(size=(b, hkv * rep, dh))).astype(np.float32)
    return q, kp, vp, bt, np.asarray(lens, np.int32)


@pytest.mark.parametrize("rep,window,softcap,freed", [
    (1, None, None, ()),
    (2, None, None, ()),
    (1, None, None, ((0, 2),)),          # a freed page mid-table
    (2, 9, 30.0, ()),                    # sliding window + softcap
])
def test_paged_attention_plain_matches_repro_kernel(rep, window, softcap,
                                                    freed):
    rng = np.random.default_rng(rep * 10 + (window or 0))
    lens = [37, 5, 16, 0, 23]
    q, kp, vp, bt, ln = _paged_attention_case(
        rng, b=5, hkv=2, rep=rep, dh=16, ps=4, lens=lens, freed=freed)
    o_r = np.asarray(rops.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(ln), window=window, softcap=softcap))
    o_t = tpa.paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                              torch.from_numpy(vp), torch.from_numpy(bt),
                              torch.from_numpy(ln), window=window,
                              softcap=softcap)
    active = ln > 0
    np.testing.assert_allclose(o_t.numpy()[active], o_r[active], rtol=0,
                               atol=ATTN_ATOL)
    assert np.all(o_t.numpy()[~active] == 0.0), \
        "rows of length 0 are zeros, as the kernel writes them"


# ---------------------------------------------------------------------------
# paged prefill
# ---------------------------------------------------------------------------
def _prefill_case(rng, *, start, length, hkv=2, rep=2, dh=16, ps=4, c=8,
                  nblk=8, pool_pages=12, mask_first_chunk_page=False):
    hq = hkv * rep
    pp = pool_pages + 1
    kp = rng.normal(size=(2, pp, ps, hkv, dh)).astype(np.float32)
    vp = rng.normal(size=(2, pp, ps, hkv, dh)).astype(np.float32)
    q = rng.normal(size=(c, hq, dh)).astype(np.float32)
    kn = rng.normal(size=(c, hkv, dh)).astype(np.float32)
    vn = rng.normal(size=(c, hkv, dh)).astype(np.float32)
    n_pages = -(-(start + length) // ps)
    bt = np.full((nblk,), -1, np.int32)
    bt[:n_pages] = rng.permutation(pool_pages)[:n_pages]
    btw = bt.copy()
    if mask_first_chunk_page:
        btw[start // ps] = -1
    return q, kn, vn, kp, vp, bt, btw


@pytest.mark.parametrize("start,length,window,softcap,masked,rep", [
    (8, 8, None, None, False, 2),        # full chunk over page-straddling ctx
    (0, 8, None, None, False, 2),        # first chunk, no context
    (16, 3, None, None, False, 2),       # ragged final chunk
    (8, 8, None, None, True, 2),         # masked shared page
    (16, 7, 6, 30.0, False, 2),          # window + softcap + ragged
    (8, 5, None, None, False, 1),        # GQA rep 1
])
def test_paged_prefill_plain_matches_repro_kernel(start, length, window,
                                                  softcap, masked, rep):
    rng = np.random.default_rng(start * 100 + length + rep)
    q, kn, vn, kp, vp, bt, btw = _prefill_case(
        rng, start=start, length=length, rep=rep,
        mask_first_chunk_page=masked)
    o_r, kr, vr = rops.paged_prefill(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(bt), jnp.asarray(btw), start, length,
        layer=1, window=window, softcap=softcap)
    kt, vt = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    o_t = tpf.paged_prefill(torch.from_numpy(q), torch.from_numpy(kn),
                            torch.from_numpy(vn), kt, vt,
                            torch.from_numpy(bt), torch.from_numpy(btw),
                            start, length, layer=1, window=window,
                            softcap=softcap)
    np.testing.assert_allclose(o_t.numpy()[:length],
                               np.asarray(o_r)[:length], rtol=0,
                               atol=ATTN_ATOL)
    P = kp.shape[1] - 1                  # the dump page is a don't-care
    np.testing.assert_array_equal(kt.numpy()[:, :P], np.asarray(kr)[:, :P])
    np.testing.assert_array_equal(vt.numpy()[:, :P], np.asarray(vr)[:, :P])
    if masked:
        page = bt[start // 4]
        np.testing.assert_array_equal(kt.numpy()[:, page], kp[:, page])


# ---------------------------------------------------------------------------
# shared index maps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [None, 3, 9])
def test_kv_block_index_matches_repro(window):
    rng = np.random.default_rng(0 if window is None else window)
    b, nblk, ps = 4, 6, 4
    bt = rng.integers(-1, 20, size=(b, nblk)).astype(np.int32)
    lens = np.array([0, 1, 9, 24], np.int32)
    flat = bt.reshape(-1)
    grid = np.array([[int(r_kv_index(bi, j, jnp.asarray(flat),
                                     jnp.asarray(lens), ps=ps, nblk=nblk,
                                     window=window))
                      for j in range(nblk)] for bi in range(b)])
    ints = np.array([[tidx.kv_block_index(bi, j, flat, lens, ps=ps,
                                         nblk=nblk, window=window)
                      for j in range(nblk)] for bi in range(b)])
    tens = tidx.kv_block_index(torch.arange(b)[:, None],
                              torch.arange(nblk)[None, :],
                              torch.from_numpy(flat), torch.from_numpy(lens),
                              ps=ps, nblk=nblk, window=window).numpy()
    np.testing.assert_array_equal(ints, grid)
    np.testing.assert_array_equal(tens, grid)


@pytest.mark.parametrize("start,window", [(0, None), (4, None), (13, None),
                                          (24, None), (24, 5), (16, 30)])
def test_ctx_block_index_matches_repro(start, window):
    rng = np.random.default_rng(start)
    nblk, ps = 8, 4
    bt = rng.integers(-1, 30, size=(nblk,)).astype(np.int32)
    grid = [int(r_ctx_index(j, jnp.asarray(bt), start, ps=ps, nblk=nblk,
                            window=window)) for j in range(nblk + 2)]
    ints = [tidx.ctx_block_index(j, bt, start, ps=ps, nblk=nblk,
                                window=window) for j in range(nblk + 2)]
    tens = tidx.ctx_block_index(torch.arange(nblk + 2), torch.from_numpy(bt),
                               start, ps=ps, nblk=nblk, window=window)
    assert ints == grid
    assert tens.tolist() == grid
