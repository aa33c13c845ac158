"""Port parity: packing and data-free PTQ1.61 quantization.

The same weights, made from a numpy seed, go through ``repro`` and
``repro_torch``.  Packed bytes (``perm``, ``w4``, ``bits``) must be
identical; the f32 scales agree to f32 rounding (their means are summed
in another order), checked with rtol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.core import bits as rbits  # noqa: E402
from repro.core import pack as rpack  # noqa: E402
from repro.core import qlinear as rql  # noqa: E402
from repro.core.pipeline import quantize_params_data_free as r_qdf  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.common import Parallel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import bits as tbits  # noqa: E402
from repro_torch.core import pack as tpack  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
from repro_torch.core.pipeline import quantize_params_data_free as t_qdf  # noqa: E402
from repro_torch.core.select import map_tree  # noqa: E402

SCALE_RTOL = 1e-6
PACKED = ("perm", "w4", "bits")
SCALES = ("s4", "z4", "alpha_s", "alpha_r1", "alpha_r2")


def _bf16_weight(rng, k, n):
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    wj = jnp.asarray(w, jnp.bfloat16)
    return wj, bridge.to_tensor(np.asarray(wj))


def _assert_same_qlinear(tq, rq):
    rq = bridge.convert(jax.tree.map(np.asarray, rq))
    assert (tq.k_s, tq.k, tq.n) == (rq.k_s, rq.k, rq.n)
    for f in PACKED:
        assert torch.equal(getattr(tq, f), getattr(rq, f)), f
    for f in SCALES:
        torch.testing.assert_close(getattr(tq, f), getattr(rq, f),
                                   rtol=SCALE_RTOL, atol=0.0)


@pytest.mark.parametrize("shape", [(16, 8), (64, 24), (3, 40, 7)])
def test_pack_bits_bytes_match(shape):
    rng = np.random.default_rng(sum(shape))
    signs = np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(np.float32)
    rb = np.asarray(rpack.pack_bits(jnp.asarray(signs), axis=-2))
    tb = tpack.pack_bits(torch.from_numpy(signs), axis=-2)
    np.testing.assert_array_equal(tb.numpy(), rb)
    back = tpack.unpack_bits(tb, axis=-2, dtype=torch.float32).numpy()
    np.testing.assert_array_equal(back, signs)


@pytest.mark.parametrize("shape", [(4, 8), (64, 24), (2, 10, 5)])
def test_pack_nibbles_bytes_match(shape):
    rng = np.random.default_rng(sum(shape) + 1)
    q = rng.integers(0, 16, size=shape).astype(np.uint8)
    rb = np.asarray(rpack.pack_nibbles(jnp.asarray(q), axis=-2))
    tb = tpack.pack_nibbles(torch.from_numpy(q), axis=-2)
    np.testing.assert_array_equal(tb.numpy(), rb)
    back = tpack.unpack_nibbles(tb, axis=-2, dtype=torch.float32).numpy()
    np.testing.assert_array_equal(back, q.astype(np.float32))


@pytest.mark.parametrize("k,n,ratio", [(64, 48, 0.2), (256, 96, 0.1875),
                                       (128, 40, 0.3)])
def test_quantize_linear_matches(k, n, ratio):
    rng = np.random.default_rng(k + n)
    wj, wt = _bf16_weight(rng, k, n)
    rq = rql.quantize_linear(wj, None, rql.QuantConfig(ratio=ratio,
                                                      multiple=16))
    tq = tql.quantize_linear(wt, None, tql.QuantConfig(ratio=ratio,
                                                      multiple=16))
    _assert_same_qlinear(tq, rq)
    # dequantized matrices agree too
    np.testing.assert_allclose(
        tq.to_dense(torch.float32).numpy(),
        np.asarray(rq.to_dense(jnp.float32)), rtol=1e-6, atol=1e-7)


def test_quantize_linear_group_matches():
    rng = np.random.default_rng(7)
    ws = [_bf16_weight(rng, 64, n) for n in (64, 32, 32)]
    qc = dict(ratio=0.25, multiple=16)
    rg = rql.quantize_linear_group([w for w, _ in ws], None,
                                   rql.QuantConfig(**qc))
    tg = tql.quantize_linear_group([w for _, w in ws], None,
                                   tql.QuantConfig(**qc))
    assert tg.splits == rg.splits == (64, 32, 32)
    _assert_same_qlinear(tg.inner, rg.inner)
    x = rng.normal(size=(3, 64)).astype(np.float32)
    yt = [m.__matmul_permuted__(torch.from_numpy(x)[:, m.perm.long()])
          for m in tg.members()]
    yr = [np.asarray(m.__matmul_permuted__(jnp.asarray(x)[:, m.perm]))
          for m in rg.members()]
    for a, b in zip(yt, yr):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5)


def test_quantize_params_data_free_fused_tiny_lm():
    """The whole tiny-lm: every fused / unfused packed layout identical."""
    cfg = registry.get("tiny-lm")
    par = Parallel(tp=1, dp=1, remat=False)
    params = RM.init_params(cfg, par, jax.random.PRNGKey(0))
    qc = dict(ratio=0.2, multiple=16)
    rq = r_qdf(params, rql.QuantConfig(**qc), min_dim=32, fuse=True)
    tq = t_qdf(bridge.params_from_repro(jax.tree.map(np.asarray, params)),
               tql.QuantConfig(**qc), min_dim=32, fuse=True)
    rq_t = bridge.params_from_repro(jax.tree.map(np.asarray, rq))
    seen = []

    def compare(path, leaf):
        other = rq_t
        for k in path:
            other = other[k]
        if isinstance(leaf, tql.QLinearGroup):
            assert leaf.splits == other.splits
            leaf, other = leaf.inner, other.inner
        if isinstance(leaf, tql.QLinear):
            for f in PACKED:
                assert torch.equal(getattr(leaf, f), getattr(other, f)), \
                    (path, f)
            for f in SCALES:
                torch.testing.assert_close(getattr(leaf, f),
                                           getattr(other, f),
                                           rtol=SCALE_RTOL, atol=0.0)
            seen.append(path)
        else:
            assert torch.equal(leaf, other), path
        return leaf

    map_tree(tq, compare)
    assert len(seen) == cfg.n_layers * 4        # wqkv, wo, wgu, wd
    rb, tb = rbits.model_bits(rq), tbits.model_bits(tq)
    assert tb["quantized_weights"] == rb["quantized_weights"]
    assert tb["exempt_params"] == rb["exempt_params"]
    assert tb["avg_bits_per_quantized_weight"] == pytest.approx(
        rb["avg_bits_per_quantized_weight"], rel=1e-12)


def test_structured_mask_breaks_ties_like_top_k():
    from repro.core import saliency as rsal
    from repro_torch.core import saliency as tsal
    s = np.array([1, 3, 3, 2, 3, 0, 3, 1] * 4, np.float32)
    rm, rp, rk = rsal.structured_mask(jnp.asarray(s), 0.25, 8)
    tm, tp, tk = tsal.structured_mask(torch.from_numpy(s), 0.25, 8)
    assert rk == tk
    np.testing.assert_array_equal(tm.numpy(), np.asarray(rm))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))


def test_bridge_bf16_crosses_exactly():
    rng = np.random.default_rng(3)
    a = jnp.asarray(rng.normal(size=(5, 7)), jnp.bfloat16)
    t = bridge.to_tensor(np.asarray(a))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a.astype(jnp.float32)))
