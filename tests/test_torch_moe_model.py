"""Port parity of the MoE block kind through the model and the engine:
``block_full`` with the auxiliary loss, ``forward_loss`` with its
0.01·aux term, ``model_bits`` over stacked expert leaves, the bridge of
a stacked ``QLinearGroup``, and greedy tokens of the paged
chunked-prefill engine and the contiguous whole-prompt engine, against
``repro`` on granite-moe-1b-a400m reduced to 2 layers in f32, weights
built in ``repro`` (dense, and data-free quantized with fused QKV and
fused expert gate+up) and carried across by the bridge.  Attention
projections run through ``repro``'s mixed_matmul kernel in interpret
mode on every shape (``repro_kernel_everywhere``), so both sides round
their operands alike; the expert products are the reference's einsum
over dequantized weights on both sides.

Tolerances, each with its reason:
  * block outputs: rtol 1e-5, atol 2e-5 for dense weights (f32 matmuls
    summed in another order); for packed ones rtol 2^-7, atol 2e-3: the
    packed product rounds its operands and output to bf16 on both
    sides, and where the two f32 accumulators straddle a rounding
    boundary the output moves by one bf16 ulp (up to 2^-7 of its
    value), as ``tests/test_torch_model.py`` allows for logits.  The
    auxiliary loss rtol 1e-6.
  * the loss rtol 1e-5, as ``tests/test_torch_whole_prompt.py``.
  * bits, weight counts, packed bytes: exact.
  * greedy tokens: identical (f32 params and page pools; the contiguous
    rings are bf16 on both sides, as the reference has them).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.configs.base import Stage as RStage  # noqa: E402
from repro.core.bits import model_bits as r_bits  # noqa: E402
from repro.core.pipeline import quantize_params_data_free as r_qdf  # noqa: E402
from repro.core.qlinear import QuantConfig as RQC  # noqa: E402
from repro.kernels import autotune, ops as rops  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.common import Parallel  # noqa: E402
from repro.runtime.engine import Engine as REngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.configs.base import Stage as TStage  # noqa: E402
from repro_torch.core.bits import model_bits as t_bits  # noqa: E402
from repro_torch.core.pipeline import quantize_params_data_free as t_qdf  # noqa: E402
from repro_torch.core.qlinear import QLinear, QLinearGroup  # noqa: E402
from repro_torch.core.qlinear import QuantConfig as TQC  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime.engine import Engine as TEngine  # noqa: E402

ARCH = "granite-moe-1b-a400m"
PAR = Parallel(tp=1, dp=1, remat=False, attn_chunk=32)
N_LAYERS = 2
TOL = {"fp": (1e-5, 2e-5), "fused": (2.0 ** -7, 2e-3)}


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


def _cfgs():
    r = dataclasses.replace(registry.get(ARCH).reduced(),
                            stages=(RStage(("moe",), N_LAYERS),))
    t = dataclasses.replace(t_registry.get(ARCH).reduced(),
                            stages=(TStage(("moe",), N_LAYERS),))
    return r, t


@pytest.fixture(scope="module")
def subject():
    """{mode: (repro params, port params)} over one f32 two-layer model;
    "fused" is data-free PTQ1.61 with fused QKV and expert gate+up."""
    rcfg, tcfg = _cfgs()
    p = RM.init_params(rcfg, PAR, jax.random.PRNGKey(0))
    p = jax.tree.map(lambda a: a.astype(jnp.float32)
                     if a.dtype == jnp.bfloat16 else a, p)
    qp = r_qdf(p, RQC(ratio=0.25, multiple=16, use_kernel=True), min_dim=32,
               fuse=True)
    params = {mode: (rp, bridge.params_from_repro(jax.tree.map(np.asarray,
                                                              rp)))
              for mode, rp in (("fp", p), ("fused", qp))}
    return rcfg, tcfg, params


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, size=int(n)).astype(np.int32) for n in lens]


def test_bridge_carries_stacked_expert_leaves(subject):
    """The reference's (L, E, ...) expert leaves become per-layer
    (E, ...) leaves, a stacked ``QLinearGroup`` inner included, and the
    port's own data-free quantization gives the same bytes."""
    rcfg, tcfg, params = subject
    rp, tp = params["fused"]
    fp_t = params["fp"][1]
    mine = t_qdf(fp_t, TQC(ratio=0.25, multiple=16), min_dim=32, fuse=True)
    e, d, f = rcfg.moe.n_experts, rcfg.d_model, rcfg.d_ff
    for layer in range(N_LAYERS):
        mlp = tp["stages"][0][layer][0]["mlp"]
        assert tuple(mlp["router"].shape) == (d, e)
        assert mlp["router"].dtype == torch.float32
        wgu, wd = mlp["wgu"], mlp["wd"]
        assert isinstance(wgu, QLinearGroup) and wgu.splits == (f, f)
        assert isinstance(wgu.inner, QLinear) and isinstance(wd, QLinear)
        assert tuple(wgu.inner.perm.shape) == (e, d)
        assert tuple(wd.bits.shape) == (e, (f - wd.k_s) // 8, d)
        ref = rp["stages"][0][0]["mlp"]["wgu"].inner
        np.testing.assert_array_equal(wgu.inner.w4.numpy(),
                                      np.asarray(ref.w4[layer]))
        ours = mine["stages"][0][layer][0]["mlp"]
        for got, want in ((ours["wgu"].inner, wgu.inner), (ours["wd"], wd)):
            for fld in ("perm", "w4", "bits"):
                assert torch.equal(getattr(got, fld), getattr(want, fld))


@pytest.mark.parametrize("mode", ["fp", "fused"])
def test_block_full_with_aux_matches_repro(subject, mode,
                                           repro_kernel_everywhere):
    rcfg, tcfg, params = subject
    rp, tp = params[mode]
    rng = np.random.default_rng(31)
    x = rng.normal(size=(2, 24, rcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    rblock = jax.tree.map(lambda a: a[1], rp["stages"][0][0])
    y_r, aux_r = RT.block_full(rcfg, PAR, "moe", rblock, jnp.asarray(x),
                               jnp.asarray(pos), causal=True,
                               aux=jnp.zeros((), jnp.float32))
    aux_t = []
    y_t = TT.block_full(tcfg, "moe", tp["stages"][0][1][0],
                        torch.from_numpy(x), torch.from_numpy(pos),
                        causal=True, attn_chunk=PAR.attn_chunk, aux=aux_t)
    rtol, atol = TOL[mode]
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), rtol=rtol,
                               atol=atol)
    assert len(aux_t) == 1 and float(aux_r) > 0
    np.testing.assert_allclose(float(aux_t[0]), float(aux_r), rtol=1e-6)


@pytest.mark.parametrize("mode", ["fp", "fused"])
def test_forward_loss_with_aux_matches_repro(subject, mode,
                                             repro_kernel_everywhere):
    """The loss with its 0.01·aux term; the aux term is what separates
    it from the bare cross entropy."""
    rcfg, tcfg, params = subject
    rp, tp = params[mode]
    rng = np.random.default_rng(17)
    toks = rng.integers(1, rcfg.vocab, size=(2, 32)).astype(np.int32)
    tgts = rng.integers(0, rcfg.vocab, size=(2, 32)).astype(np.int32)
    tgts[0, :5] = -1
    lr = RM.forward_loss(rcfg, PAR, rp, {"tokens": jnp.asarray(toks),
                                         "targets": jnp.asarray(tgts)})
    batch = {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(tgts)}
    lt = TM.forward_loss(tcfg, tp, batch, attn_chunk=PAR.attn_chunk)
    assert lt.dim() == 0 and torch.isfinite(lt)
    np.testing.assert_allclose(float(lt), float(lr), rtol=1e-5)
    x, positions = TM._backbone_inputs(tcfg, tp, batch)
    x, aux = TT.stage_full(tcfg, tcfg.stages[0], tp["stages"][0], x,
                           positions, attn_chunk=PAR.attn_chunk)
    xent = TM.softmax_xent_chunked(tcfg, tp, x, batch["targets"])
    assert float(aux) > 0
    np.testing.assert_allclose(float(lt), float(xent + 0.01 * aux),
                               rtol=1e-7)


def test_model_bits_matches_repro(subject):
    """Stacked expert leaves count each slice's mask and scales (the
    reference's ``lead`` factor): every number exact."""
    _, _, params = subject
    rp, tp = params["fused"]
    b_r, b_t = r_bits(rp), t_bits(tp)
    for k in ("avg_bits_per_quantized_weight", "quantized_weights",
              "exempt_params", "exempt_fraction", "checkpoint_gbytes"):
        assert b_t[k] == b_r[k], k
    # per leaf: the reference's (L, E) leaves against the port's (E,)
    rows_r = sorted((r.n_weights, r.total_bits) for r in b_r["per_layer"])
    rows_t = {}
    for r in b_t["per_layer"]:
        rows_t[(r.total_bits,)] = rows_t.get((r.total_bits,), 0) + \
            r.n_weights
    assert sorted(rows_t.items()) == sorted(((t,), n) for n, t in rows_r)


def _serve(eng, prompts, max_new):
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.run()
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs]


ENGINE_MODES = {
    "paged-chunked": dict(paged=True, chunked_prefill=True, page_size=8,
                          prefill_chunk=16),
    "contiguous-whole": dict(prefill_buckets=(16, 64)),
    "paged-whole": dict(paged=True, page_size=8, prefill_buckets=(16, 64)),
}


@pytest.mark.parametrize("mode", sorted(ENGINE_MODES))
def test_engine_greedy_tokens_match_repro(subject, mode,
                                          repro_kernel_everywhere):
    """Identical greedy tokens on the fused data-free weights, 3 slots
    and 5 prompts: inactive decode rows, left-padded buckets and the
    zero rows past a short chunk are all routed, as in the reference."""
    rcfg, tcfg, params = subject
    rp, tp = params["fused"]
    kw = dict(n_slots=3, max_seq=128, **ENGINE_MODES[mode])
    re = REngine(rcfg, PAR, rp, cache_dtype=jnp.float32, **kw)
    te = TEngine(tcfg, tp, cache_dtype=torch.float32, device="cpu",
                 attn_chunk=PAR.attn_chunk, **kw)
    prompts = _prompts(9, (5, 17, 31, 48, 60))
    r, t = (_serve(e, prompts, max_new=8) for e in (re, te))
    assert t == r
    assert te.backend.name == ("paged" if kw.get("paged") else "contiguous")


def test_serve_granite_reduced_on_cpu():
    """``launch.serve --arch granite-moe-1b-a400m`` no longer raises:
    reduced, fused data-free, on the paged chunked-prefill engine and
    on the contiguous whole-prompt one; what is not served (an
    encoder-decoder model, seamless-m4t-medium) still raises."""
    common = ["--arch", ARCH, "--reduced", "--fused", "--requests", "3",
              "--slots", "2", "--max-seq", "64", "--max-new", "3",
              "--device", "cpu"]
    for extra, backend in ((["--paged", "--chunked-prefill",
                             "--prefill-chunk", "16"], "paged"),
                           ([], "contiguous")):
        out = serve.run(serve.parse_args(common + extra))
        assert out["all_done"] and out["cache_backend"] == backend
        assert 1.5 < out["bits_per_weight"] < 3.0
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        serve.run(serve.parse_args(["--arch", "seamless-m4t-medium",
                                    "--reduced", "--device", "cpu"]))
