"""Port parity at model level: the paged chunked-prefill step and the
paged decode step of ``repro_torch`` against ``repro`` on the same
weights (built in ``repro``, carried across by the bridge), in f32.

Packed projections run through ``repro``'s mixed_matmul kernel (interpret
mode) on every shape: its TPU tiling gate would send N % 128 != 0 to the
f32 dequant path, while the port's kernel takes every shape, so the
fixture lifts the gate for the test.  Both sides then round matmul
operands to bf16 the same way.

Tolerance: logits within 2e-4 absolute for fp params (f32 throughout,
summation order only) and 2e-3 absolute for packed params, where a tiny
f32 difference can move one activation across a bf16 rounding boundary.
Logit scale is about 1 here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.core.pipeline import quantize_params_data_free as r_qdf  # noqa: E402
from repro.core.qlinear import QuantConfig as RQC  # noqa: E402
from repro.kernels import autotune, ops as rops  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.common import Parallel  # noqa: E402
from repro.models.param import materialize  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime.paged_cache import (BlockTables, PagePool,  # noqa: E402
                                             pages_for_tokens)

PAR = Parallel(tp=1, dp=1, remat=False, attn_chunk=32)
ATOL = {"fp": 2e-4, "quant": 2e-3, "fused": 2e-3}


@pytest.fixture
def repro_kernel_everywhere(monkeypatch):
    """Route every repro QLinear through its Pallas mixed_matmul."""
    def choice(m, k_s, k_b, n):
        if k_s <= 0 or k_b <= 0:
            return None
        return autotune.BlockChoice(bm=m, bn=n,
                                    bk=autotune.common_bk(k_s, k_b),
                                    vmem_bytes=0, hbm_bytes=0, time_s=0.0)
    monkeypatch.setattr(rops, "_kernel_choice", choice)


def _f32(tree):
    return jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if isinstance(a, jax.Array) and a.dtype == jnp.bfloat16 else a, tree)


def _params(arch, mode):
    cfg = registry.get(arch).reduced()
    p = _f32(RM.init_params(cfg, PAR, jax.random.PRNGKey(0)))
    if mode != "fp":
        p = r_qdf(p, RQC(ratio=0.25, multiple=16, use_kernel=True),
                  min_dim=32, fuse=(mode == "fused"))
    return cfg, p


@pytest.mark.parametrize("arch", ["tiny-lm", "llama-7b"])
@pytest.mark.parametrize("mode", ["fp", "quant", "fused"])
def test_chunked_prefill_then_decode_logits_match(arch, mode,
                                                  repro_kernel_everywhere):
    cfg, rp = _params(arch, mode)
    tcfg = t_registry.get(arch).reduced()
    assert tcfg.name == cfg.name and tcfg.d_model == cfg.d_model
    tp = bridge.params_from_repro(jax.tree.map(np.asarray, rp))
    ps, chunk, plen, steps = 4, 8, 19, 3
    rng = np.random.default_rng(len(arch) + len(mode))
    seq = rng.integers(1, cfg.vocab, size=plen + steps).astype(np.int32)

    pool = PagePool(12, ps)
    tables = BlockTables(pool, 2, pages_for_tokens(64, ps))
    assert tables.ensure_blocks(1, pages_for_tokens(plen + steps, ps))
    bt_all = tables.as_array()
    rc = materialize(RM.init_paged_caches(cfg, PAR, 2, 12, ps,
                                          dtype=jnp.float32),
                     jax.random.PRNGKey(0))
    tc = TM.init_paged_caches(tcfg, 12, ps, dtype=torch.float32)
    bt = bt_all[1]
    for start in range(0, plen, chunk):
        length = min(chunk, plen - start)
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :length] = seq[start:start + length]
        lr, rc = RM.prefill_step_paged(cfg, PAR, rp, jnp.asarray(toks), rc,
                                       jnp.asarray(bt), jnp.asarray(bt),
                                       start, length, max_seq=64)
        lt, tc = TM.prefill_step_paged(tcfg, tp, torch.from_numpy(toks), tc,
                                       torch.from_numpy(bt),
                                       torch.from_numpy(bt), start, length)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lr), rtol=0,
                                   atol=ATOL[mode])
    # decode: slot 1 is live, slot 0 is an inactive row (table -1, len 0)
    for pos in range(plen, plen + steps):
        tables.ensure_for_position(1, pos)
        bt2 = tables.as_array()
        lens = np.array([0, pos + 1], np.int32)
        tok = np.array([0, seq[pos - 1]], np.int32)
        p2 = np.array([0, pos], np.int32)
        lr, rc = RM.decode_step_paged(cfg, PAR, rp, jnp.asarray(tok),
                                      jnp.asarray(p2), rc, jnp.asarray(bt2),
                                      jnp.asarray(lens), max_seq=64)
        lt, tc = TM.decode_step_paged(tcfg, tp, torch.from_numpy(tok),
                                      torch.from_numpy(p2), tc,
                                      torch.from_numpy(bt2),
                                      torch.from_numpy(lens))
        np.testing.assert_allclose(lt.numpy()[1], np.asarray(lr)[1], rtol=0,
                                   atol=ATOL[mode])
    # the pools agree too (live pages; the dump page is a don't-care)
    rk = np.asarray(rc[0][0]["k"])[:, :-1]
    tk = tc[0][0]["k"].numpy()[:, :-1]
    np.testing.assert_allclose(tk, rk, rtol=0, atol=ATOL[mode])


def test_decode_step_with_no_live_row_is_a_no_op():
    cfg = t_registry.get("tiny-lm").reduced()
    tp = TM.init_params(cfg, 0, "cpu")
    tc = TM.init_paged_caches(cfg, 4, 4, dtype=torch.float32)
    before = tc[0][0]["k"].clone()
    bt = torch.full((2, 3), -1, dtype=torch.int32)
    TM.decode_step_paged(cfg, tp, torch.zeros(2, dtype=torch.int32),
                         torch.zeros(2, dtype=torch.int32), tc, bt,
                         torch.zeros(2, dtype=torch.int32))
    assert torch.equal(tc[0][0]["k"], before)


def test_init_params_is_deterministic_and_device_explicit():
    cfg = t_registry.get("tiny-lm").reduced()
    a = TM.init_params(cfg, 3, "cpu")
    b = TM.init_params(cfg, 3, "cpu")
    c = TM.init_params(cfg, 4, "cpu")
    wa = a["stages"][0][0][0]["attn"]["wq"]
    assert wa.device.type == "cpu" and wa.dtype == torch.bfloat16
    assert torch.equal(wa, b["stages"][0][0][0]["attn"]["wq"])
    assert not torch.equal(wa, c["stages"][0][0][0]["attn"]["wq"])


def test_paged_key_positions_match_repro():
    from repro.models.layers import paged_key_positions as r_kp
    from repro_torch.models.layers import paged_key_positions as t_kp
    bt = np.array([[3, -1, 0, 7], [-1, -1, 2, 5]], np.int32)
    for ps in (1, 4, 16):
        np.testing.assert_array_equal(
            t_kp(torch.from_numpy(bt), ps).numpy(),
            np.asarray(r_kp(jnp.asarray(bt), ps)))


def test_copy_pages_matches_repro():
    cfg = registry.get("tiny-lm").reduced()
    rng = np.random.default_rng(5)
    shape = (cfg.n_layers, 7, 4, cfg.n_kv_heads, cfg.head_dim_)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    src, dst = np.array([1, 4], np.int32), np.array([5, 0], np.int32)
    rc = ({"k": jnp.asarray(k), "v": jnp.asarray(v)},),
    rc = RM.copy_pages(cfg, rc, jnp.asarray(src), jnp.asarray(dst))
    tc = ({"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())},),
    tc = TM.copy_pages(t_registry.get("tiny-lm").reduced(), tc,
                       torch.from_numpy(src), torch.from_numpy(dst))
    for name in ("k", "v"):
        np.testing.assert_array_equal(tc[0][0][name].numpy(),
                                      np.asarray(rc[0][0][name]))
