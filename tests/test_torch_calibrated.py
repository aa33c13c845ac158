"""Port parity: calibrated PTQ1.61 — calibration statistics, block-wise
scale learning, the whole pipeline, and serving its result — against
``repro`` on tiny-lm reduced to 2 layers, in f32 (the parity ground
rule: in bf16, near-tied channel statistics can flip the mask between
the two frameworks).

Tolerances, each with its reason:
  * perm, w4, bits: exact (bytes compare exactly).
  * s4, z4: rtol 1e-6, as in ``tests/test_torch_quant.py`` (f32 min/max
    arithmetic on the same weights).
  * learned α's: rtol 1e-5, atol 1e-7.  Four AdamW steps (2 epochs × 2
    segments) each move an α by about lr = 5e-4; the two sides differ
    only in f32 summation order (about 1 ulp measured), while one
    missed or extra step moves an α_s (about 0.1) by 5e-3 relative.
  * statistics, losses and gradients: rtol 1e-5, atol 1e-6 (f32,
    summation order).
  * block outputs: rtol 1e-5, atol 1e-5.  Values of order 1 after five
    f32 matmuls of depth up to 128 and a softmax, summed in another
    order (measured at most 1.5e-6 apart).
The JAX side of the whole-pipeline comparison runs once per module
(``calibrated``), so the file stays inside the tier-1 time.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.configs.base import Stage as RStage  # noqa: E402
from repro.core import blockwise as rbw  # noqa: E402
from repro.core import calibrate as rcal  # noqa: E402
from repro.core import qlinear as rql  # noqa: E402
from repro.core import pipeline as rpipe  # noqa: E402
from repro.core.select import map_quantizable as r_map_quantizable  # noqa: E402
from repro.kernels import autotune, ops as rops  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.common import Parallel  # noqa: E402
from repro.optim.adamw import AdamW as RAdamW  # noqa: E402
from repro.runtime.engine import Engine as REngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.configs.base import Stage as TStage  # noqa: E402
from repro_torch.core import blockwise as tbw  # noqa: E402
from repro_torch.core import calibrate as tcal  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
from repro_torch.core.select import map_tree  # noqa: E402
from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus  # noqa: E402
from repro_torch.kernels import mixed_matmul as tmm  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim.adamw import AdamW as TAdamW  # noqa: E402
from repro_torch.runtime.engine import Engine as TEngine  # noqa: E402

N_LAYERS, SEGMENTS, SEQ, STEPS = 2, 2, 32, 2
ALPHA_RTOL, ALPHA_ATOL = 1e-5, 1e-7
SCALE_RTOL = 1e-6
F32_RTOL, F32_ATOL = 1e-5, 1e-6
BLOCK_ATOL = 1e-5
ALPHAS = ("alpha_s", "alpha_r1", "alpha_r2")
PAR = Parallel(tp=1, dp=1, remat=False, attn_chunk=1024)


def _cfgs(**kw):
    r = dataclasses.replace(registry.get("tiny-lm").reduced(),
                            stages=(RStage(("dense",), N_LAYERS),), **kw)
    t = dataclasses.replace(t_registry.get("tiny-lm").reduced(),
                            stages=(TStage(("dense",), N_LAYERS),), **kw)
    return r, t


def _qcfgs(**kw):
    kw = {"ratio": 0.2, "multiple": 16, "steps": STEPS, **kw}
    return rql.QuantConfig(**kw), tql.QuantConfig(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _keystr(path):
    return "".join(f"[{k!r}]" for k in path)


def _qlinears(tree):
    out = {}
    map_tree(tree, lambda p, x: out.__setitem__(p, x)
             if isinstance(x, tql.QLinear) else x)
    return out


@pytest.fixture(scope="module")
def subject():
    """repro's f32 tiny-lm (2 layers), its port twin through the bridge,
    and the calibration segments."""
    rcfg, tcfg = _cfgs()
    p = RM.init_params(rcfg, PAR, jax.random.PRNGKey(0))
    p = jax.tree.map(lambda a: a.astype(jnp.float32)
                     if a.dtype == jnp.bfloat16 else a, p)
    corpus = SyntheticCorpus(CorpusConfig(vocab=rcfg.vocab, seed=0))
    toks = [t for t, _ in corpus.batches(1, SEQ, SEGMENTS, split="calib")]
    return rcfg, tcfg, p, bridge.params_from_repro(_np(p)), toks


@pytest.fixture(scope="module")
def calibrated(subject):
    """The whole calibrated pipeline on both sides."""
    rcfg, tcfg, rp, tp, toks = subject
    rq_cfg, tq_cfg = _qcfgs()
    rq = rpipe.quantize_model_ptq161(
        rcfg, PAR, rp, [{"tokens": jnp.asarray(t)} for t in toks], rq_cfg,
        min_dim=32)
    losses = []
    tq = tpipe.quantize_model_ptq161(
        tcfg, tp, [{"tokens": torch.from_numpy(t)} for t in toks], tq_cfg,
        min_dim=32, block_losses=losses)
    return rq, tq, losses


def _block_case(subject, layer=0):
    """Layer ``layer``'s fp block on both sides and two input streams:
    the embedded segments and a perturbed copy (so the two loss
    branches differ)."""
    rcfg, tcfg, rp, tp, toks = subject
    rblock = rpipe.tree_slice(rp["stages"][0][0], layer)
    tblock = tp["stages"][0][layer][0]
    rng = np.random.default_rng(layer)
    x_fp = [np.array(RM.embed_tokens(rcfg, rp, jnp.asarray(t)))
            for t in toks]
    x_q = [x + 0.01 * rng.normal(size=x.shape).astype(np.float32)
           for x in x_fp]
    return rblock, tblock, x_fp, x_q


# ---------------------------------------------------------------------------
# Eq. 5-6 distances and the optimizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cosine", [True, False])
def test_nlc_and_metric_match_repro(cosine):
    rng = np.random.default_rng(1)
    f1 = rng.normal(size=(2, 5, 16)).astype(np.float32)
    f2 = (f1 + 0.5 * rng.normal(size=f1.shape)).astype(np.float32)
    f2[0, 0] = -f1[0, 0]                    # cosine -1: clamped to 1e-3
    r = float(rbw.metric(jnp.asarray(f1), jnp.asarray(f2), cosine))
    t = float(tbw.metric(torch.from_numpy(f1), torch.from_numpy(f2), cosine))
    np.testing.assert_allclose(t, r, rtol=F32_RTOL)
    np.testing.assert_allclose(
        float(tbw.nlc(torch.from_numpy(f1), torch.from_numpy(f2))),
        float(rbw.nlc(jnp.asarray(f1), jnp.asarray(f2))), rtol=F32_RTOL)


def test_nlc_gradient_matches_repro_and_is_zero_where_clamped():
    rng = np.random.default_rng(2)
    f1 = rng.normal(size=(4, 16)).astype(np.float32)
    f2 = (f1 + 0.5 * rng.normal(size=f1.shape)).astype(np.float32)
    f2[1] = -f1[1]
    g_r = np.asarray(jax.grad(lambda a: rbw.nlc(a, jnp.asarray(f2)))(
        jnp.asarray(f1)))
    a = torch.from_numpy(f1).requires_grad_(True)
    tbw.nlc(a, torch.from_numpy(f2)).backward()
    np.testing.assert_allclose(a.grad.numpy(), g_r, rtol=F32_RTOL,
                               atol=F32_ATOL)
    assert np.all(a.grad.numpy()[1] == 0.0)
    assert np.all(np.abs(a.grad.numpy()[0]) > 0)


def _scale_tree(rng, shapes):
    return {k: {f: rng.normal(size=s).astype(np.float32)
                for f, s in zip(ALPHAS, shp)} for k, shp in shapes.items()}


def _scaled_grads(g, r_gain):
    return {k: {"alpha_s": v["alpha_s"], "alpha_r1": v["alpha_r1"] * r_gain,
                "alpha_r2": v["alpha_r2"] * r_gain} for k, v in g.items()}


def test_adamw_steps_with_r_gain_match_repro():
    """Two AdamW steps (bias corrections at t = 1 and 2) on
    gradients whose angular-factor parts are scaled by r_gain, as
    ``optimize_block_scales`` feeds them."""
    rng = np.random.default_rng(3)
    shapes = {"a": ((8,), (8,), (12,)), "b": ((4,), (4,), (6,))}
    params = _scale_tree(rng, shapes)
    grads = [_scale_tree(rng, shapes) for _ in range(2)]
    r_gain = 1e-3 / 5e-4
    ropt, topt = RAdamW(lr=5e-4), TAdamW(lr=5e-4)
    rp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, params)
    rs, ts = ropt.init(rp), topt.init(tp)
    for g in grads:
        g = _scaled_grads(g, r_gain)
        rp, rs = ropt.update(jax.tree.map(jnp.asarray, g), rs, rp)
        tp, ts = topt.update(jax.tree.map(torch.from_numpy, g), ts, tp)
    assert ts.step == int(rs.step) == 2
    for k in shapes:
        for f in ALPHAS:
            np.testing.assert_allclose(tp[k][f].numpy(), np.asarray(rp[k][f]),
                                       rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(ts.nu[k][f].numpy(),
                                       np.asarray(rs.nu[k][f]), rtol=1e-6)


def test_r_gain_scaling_is_cancelled_by_adam_as_in_repro():
    """Reference fault kept for parity: the paper's two learning rates
    are implemented by scaling gradients, which Adam's update ignores
    (apart from eps), so α_r1 / α_r2 train at lr, not lr_r, on both
    sides."""
    rng = np.random.default_rng(4)
    shapes = {"a": ((8,), (8,), (12,))}
    params = _scale_tree(rng, shapes)
    grad = _scale_tree(rng, shapes)
    for opt, conv in ((RAdamW(lr=5e-4), jnp.asarray),
                      (TAdamW(lr=5e-4), torch.from_numpy)):
        p = jax.tree.map(conv, params)
        outs = []
        for gain in (1.0, 2.0):
            new, _ = opt.update(jax.tree.map(conv, _scaled_grads(grad, gain)),
                                opt.init(p), p)
            outs.append(np.asarray(new["a"]["alpha_r2"]))
        step_1 = outs[0] - params["a"]["alpha_r2"]
        step_2 = outs[1] - params["a"]["alpha_r2"]
        np.testing.assert_allclose(step_2, step_1, rtol=1e-3, atol=1e-9)
        np.testing.assert_allclose(np.abs(step_1), 5e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# Statistics and the full-sequence block forward
# ---------------------------------------------------------------------------
def test_collect_stats_absmeans_match_repro(subject):
    rcfg, tcfg = subject[0], subject[1]
    rblock, tblock, x_fp, _ = _block_case(subject)
    r = rcal.collect_stats(rpipe._block_forward(rcfg, PAR, "dense"), rblock,
                           [jnp.asarray(x) for x in x_fp], min_dim=32)
    t = tcal.collect_stats(tpipe._block_forward(tcfg, "dense"), tblock,
                           [torch.from_numpy(x) for x in x_fp], min_dim=32)
    assert len(t) == 7 and {_keystr(k) for k in t} == set(r)
    for k, v in t.items():
        np.testing.assert_allclose(v.numpy(), r[_keystr(k)], rtol=F32_RTOL,
                                   atol=F32_ATOL)


@pytest.mark.parametrize("attn_chunk,window,softcap", [
    (1024, None, None),          # one dense softmax
    (8, None, None),             # streaming over key chunks of 8
    (1024, 5, 30.0),             # sliding window + logit softcap
    (8, 5, 30.0),
])
def test_block_full_matches_repro(subject, attn_chunk, window, softcap):
    rcfg, tcfg = _cfgs(attn_window=window, logit_softcap=softcap)
    rblock, tblock, x_fp, _ = _block_case(subject)
    x = np.concatenate(x_fp)                            # (2, SEQ, D)
    pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32), x.shape[:2])
    y_r, _ = RT.block_full(rcfg, dataclasses.replace(PAR,
                                                     attn_chunk=attn_chunk),
                           "dense", rblock, jnp.asarray(x),
                           jnp.asarray(pos), causal=True)
    y_t = TT.block_full(tcfg, "dense", tblock, torch.from_numpy(x),
                        torch.from_numpy(pos.copy()), causal=True,
                        attn_chunk=attn_chunk)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), rtol=F32_RTOL,
                               atol=BLOCK_ATOL)


def test_block_full_refuses_other_kinds(subject):
    """Every block kind of the reference is ported; an unknown kind
    raises the reference's ``ValueError(kind)``."""
    _, tcfg, _, tp, _ = subject
    x = torch.zeros(1, 4, tcfg.d_model)
    with pytest.raises(ValueError, match="^conv$"):
        TT.block_full(tcfg, "conv", tp["stages"][0][0][0], x,
                      torch.zeros(1, 4, dtype=torch.int32))
    assert set(TT.KINDS) == {"dense", "moe", "local", "rglru", "mlstm",
                             "slstm"}


# ---------------------------------------------------------------------------
# Scale learning
# ---------------------------------------------------------------------------
def _initial_qblock(rblock, rq_cfg):
    rqb = r_map_quantizable(rblock, lambda _, w: rql.quantize_linear(
        w, None, rq_cfg), min_dim=32)
    return rqb, bridge.convert(_np(rqb))


def test_optimize_block_scales_matches_repro(subject):
    rcfg, tcfg = subject[0], subject[1]
    rblock, tblock, x_fp, x_q = _block_case(subject)
    rq_cfg, tq_cfg = _qcfgs()
    rqb, tqb = _initial_qblock(rblock, rq_cfg)
    r = rbw.optimize_block_scales(
        rpipe._block_forward(rcfg, PAR, "dense"), rblock, rqb,
        [jnp.asarray(x) for x in x_fp], [jnp.asarray(x) for x in x_q],
        rq_cfg)
    t = tbw.optimize_block_scales(
        tpipe._block_forward(tcfg, "dense"), tblock,
        tbw.dequant_views(tqb, torch.float32),
        [torch.from_numpy(x) for x in x_fp],
        [torch.from_numpy(x) for x in x_q], tq_cfg)
    t = tbw.inject_scales(tqb, tbw.extract_scales(t))
    r, tq0 = bridge.convert(_np(r)), _qlinears(tqb)
    tq, rq = _qlinears(t), _qlinears(r)
    assert len(tq) == 7 and tq.keys() == rq.keys()
    for k in tq:
        for f in ALPHAS:
            torch.testing.assert_close(getattr(tq[k], f), getattr(rq[k], f),
                                       rtol=ALPHA_RTOL, atol=ALPHA_ATOL)
        assert not torch.equal(tq[k].alpha_s, tq0[k].alpha_s), "learned"
        for f in ("perm", "w4", "bits", "s4", "z4"):
            assert torch.equal(getattr(tq[k], f), getattr(tq0[k], f)), f


def test_scale_gradients_are_nonzero_and_match_finite_differences(subject):
    """The loss goes through the differentiable views: every α of every
    projection gets a gradient, and it matches central differences."""
    tcfg = subject[1]
    rblock, tblock, x_fp, x_q = _block_case(subject)
    _, tqb = _initial_qblock(rblock, _qcfgs()[0])
    views = tbw.dequant_views(tqb, torch.float32)
    fwd = tpipe._block_forward(tcfg, "dense")
    xf, xq = torch.from_numpy(x_fp[0]), torch.from_numpy(x_q[0])
    with torch.no_grad():
        y1, y2 = fwd(tblock, xf), fwd(tblock, xq)

    def loss(scales):
        yq = fwd(tbw.inject_scales(views, scales), xq)
        return tbw.metric(y1, yq) + tbw.metric(y2, yq)

    scales = {k: {f: t.clone().requires_grad_(True) for f, t in g.items()}
              for k, g in tbw.extract_scales(views).items()}
    loss(scales).backward()
    assert len(scales) == 7
    rng = np.random.default_rng(5)
    for k, g in scales.items():
        for f, t in g.items():
            assert t.grad.abs().max() > 0, (k, f)
            for i in rng.choice(t.numel(), 2, replace=False):
                h = 1e-2 * abs(float(t.detach()[i]))
                plus = {kk: {ff: tt.detach().clone() for ff, tt in gg.items()}
                        for kk, gg in scales.items()}
                minus = {kk: {ff: tt.detach().clone() for ff, tt in gg.items()}
                         for kk, gg in scales.items()}
                plus[k][f][i] += h
                minus[k][f][i] -= h
                with torch.no_grad():
                    fd = (float(loss(plus)) - float(loss(minus))) / (2 * h)
                # f32 loss of order 1, step 1% of the α: rounding about
                # 1e-6 / h, curvature O(h^2)
                assert abs(fd - float(t.grad[i])) <= \
                    2e-2 * abs(fd) + 3e-4, (k, f, i, fd, float(t.grad[i]))


def _force_repro_kernel(monkeypatch):
    """Route every repro QLinear with use_kernel through its Pallas
    mixed_matmul, whatever the shape."""
    def choice(m, k_s, k_b, n):
        if k_s <= 0 or k_b <= 0:
            return None
        return autotune.BlockChoice(bm=m, bn=n,
                                    bk=autotune.common_bk(k_s, k_b),
                                    vmem_bytes=0, hbm_bytes=0, time_s=0.0)
    monkeypatch.setattr(rops, "_kernel_choice", choice)


def test_scale_learning_runs_on_the_dequant_path_as_repro(subject,
                                                          monkeypatch):
    """Reference fault kept for parity: ``repro`` cannot take gradients
    through its Pallas kernel (``pallas_call`` has no transpose rule), so
    its working path learns through ``QLinear.__matmul_permuted__``.  The
    port learns through the same product (its DequantView) and never
    calls the packed kernel while learning."""
    tcfg = subject[1]
    rblock, tblock, x_fp, x_q = _block_case(subject)
    rq_cfg, tq_cfg = _qcfgs(steps=1)
    rqb, tqb = _initial_qblock(rblock, rq_cfg)
    rng = np.random.default_rng(6)
    for path, tq in _qlinears(tqb).items():
        rq = rqb
        for key in path:
            rq = rq[key]
        x = rng.normal(size=(5, tq.k)).astype(np.float32)
        y_r = np.asarray(rq.__matmul_x__(jnp.asarray(x)))
        y_t = tq.dequant_view(torch.float32).__matmul_x__(torch.from_numpy(x))
        np.testing.assert_allclose(y_t.numpy(), y_r, rtol=F32_RTOL,
                                   atol=F32_ATOL)

    from repro_torch.kernels import ops as tops

    def no_kernel(*a, **k):
        raise AssertionError("scale learning reached the packed kernel")
    monkeypatch.setattr(tops, "mixed_matmul", no_kernel)
    launches = tmm.KERNEL.launches
    fwd = tpipe._block_forward(tcfg, "dense")
    xs_fp = [torch.from_numpy(a) for a in x_fp]
    xs_q = [torch.from_numpy(a) for a in x_q]
    tbw.optimize_block_scales(fwd, tblock,
                              tbw.dequant_views(tqb, torch.float32),
                              xs_fp, xs_q, tq_cfg)
    assert tmm.KERNEL.launches == launches
    with pytest.raises(TypeError, match="DequantViews"):
        tbw.optimize_block_scales(fwd, tblock, tqb, xs_fp, xs_q, tq_cfg)

    _force_repro_kernel(monkeypatch)
    rq = dataclasses.replace(rqb["attn"]["wq"], use_kernel=True)

    x = jnp.asarray(rng.normal(size=(5, rq.k)), jnp.float32)

    def loss(s):
        return jnp.sum(rql.with_scales(rq, s).__matmul_x__(x) ** 2)
    with pytest.raises(NotImplementedError):
        jax.grad(loss)(rql.scale_params(rq))


# ---------------------------------------------------------------------------
# The whole pipeline and serving its result
# ---------------------------------------------------------------------------
def test_quantize_model_ptq161_matches_repro(calibrated):
    rq, tq, losses = calibrated
    a = _qlinears(tq)
    b = _qlinears(bridge.params_from_repro(_np(rq)))
    assert len(a) == 7 * N_LAYERS and a.keys() == b.keys()
    for k in a:
        assert (a[k].k_s, a[k].k, a[k].n) == (b[k].k_s, b[k].k, b[k].n)
        for f in ("perm", "w4", "bits"):
            assert torch.equal(getattr(a[k], f), getattr(b[k], f)), (k, f)
        for f in ("s4", "z4"):
            torch.testing.assert_close(getattr(a[k], f), getattr(b[k], f),
                                       rtol=SCALE_RTOL, atol=0.0)
        for f in ALPHAS:
            torch.testing.assert_close(getattr(a[k], f), getattr(b[k], f),
                                       rtol=ALPHA_RTOL, atol=ALPHA_ATOL)
    assert len(losses) == N_LAYERS
    assert all(after <= before for before, after in losses), losses


def test_dequant_view_and_packed_product_differ_only_by_rounding():
    """Scale learning runs through ``DequantView`` (f32 activations) and
    serving through the packed product (``mixed_matmul``: x_b·α_r2
    rounded to bf16).  With the int4 weights dequantized to bf16 on both
    sides, they differ only by that rounding: at most 2^-9·|x_b·α_r2|
    per term times |α_s·α_r1|, plus f32 summation order."""
    rng = np.random.default_rng(11)
    from repro_torch.kernels import ref as tref
    k, n, m = 256, 48, 4
    w = torch.from_numpy((rng.normal(size=(k, n)) / 16).astype(np.float32))
    stat = torch.from_numpy(rng.random(k).astype(np.float32))
    q = tql.quantize_linear(w.to(torch.bfloat16), stat,
                            tql.QuantConfig(ratio=0.2, multiple=16))
    # learned scales are arbitrary f32 values (a fresh α_r2 is all ones)
    q = dataclasses.replace(q, alpha_r2=torch.from_numpy(
        rng.uniform(0.5, 1.5, q.k_b).astype(np.float32)))
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(
        torch.bfloat16).float()
    view = q.dequant_view(torch.bfloat16).__matmul_x__(x)
    packed = tref.mixed_matmul_ref(x, q.w4, q.s4, q.z4, q.bits, q.alpha_s,
                                   q.alpha_r1, q.alpha_r2, perm=q.perm)
    xb = x[:, q.perm.long()][:, q.k_s:] * q.alpha_r2
    a = (q.alpha_s * q.alpha_r1).abs()
    bound = 2.0 ** -9 * xb.abs().sum(-1, keepdim=True) * a + 1e-5
    assert torch.all((view - packed).abs() <= bound)
    assert not torch.equal(view, packed)       # the rounding does show


def test_calibrated_mask_follows_activations(calibrated, subject):
    """The calibrated mask comes from the quantized stream's statistics,
    not from |w|: at least one projection's perm differs from the
    data-free one."""
    _, tq, _ = calibrated
    tp = subject[3]
    df = _qlinears(tpipe.quantize_params_data_free(
        tp, tql.QuantConfig(ratio=0.2, multiple=16), min_dim=32))
    cal = _qlinears(tq)
    assert any(not torch.equal(cal[k].perm, df[k].perm) for k in cal)


def test_engine_greedy_tokens_match_repro_on_calibrated_weights(
        calibrated, subject, monkeypatch):
    """repro's calibrated weights, bridged: both engines serve the same
    packed weights through their mixed_matmul (repro's Pallas kernel in
    interpret mode, the port's plain version), f32 params and pools."""
    rq, _, _ = calibrated
    rcfg, tcfg = subject[0], subject[1]
    _force_repro_kernel(monkeypatch)
    rqk = jax.tree.map(
        lambda q: dataclasses.replace(q, use_kernel=True)
        if isinstance(q, rql.QLinear) else q, rq,
        is_leaf=lambda q: isinstance(q, rql.QLinear))
    tq = bridge.params_from_repro(_np(rq))
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 512, size=n).astype(np.int32)
               for n in (5, 19, 40)]
    common = dict(n_slots=2, max_seq=64, paged=True, chunked_prefill=True,
                  page_size=8, prefill_chunk=16)
    outs = []
    for eng in (REngine(rcfg, PAR, rqk, cache_dtype=jnp.float32, **common),
                TEngine(tcfg, tq, cache_dtype=torch.float32, device="cpu",
                        **common)):
        reqs = [eng.submit(p, max_new=6) for p in prompts]
        eng.run()
        assert all(r.done for r in reqs)
        outs.append([r.out_tokens for r in reqs])
    assert outs[1] == outs[0]


def test_serve_calibrated_cpu_end_to_end(capsys):
    out = serve.run(serve.parse_args([
        "--arch", "tiny-lm", "--reduced", "--quantize", "calibrated",
        "--fused", "--opt-steps", "1", "--calib-segments", "2",
        "--calib-seq", "16", "--paged", "--chunked-prefill",
        "--prefill-chunk", "16", "--page-size", "8", "--requests", "3",
        "--slots", "2", "--max-seq", "64", "--max-new", "4",
        "--device", "cpu"]))
    assert "--fused ignored" in capsys.readouterr().out
    assert out["all_done"] and out["generated_tokens"] == 12
    assert out["quantize_mode"] == "calibrated"
    assert 1.4 < out["bits_per_weight"] < 2.6
    assert out["engine_metrics"]["prefill_chunks"] > 0


def test_serve_defaults_match_repro():
    from repro.launch import serve as rserve
    r = rserve.parse_args([])
    t = serve.parse_args([])
    for name in ("ratio", "multiple", "min_dim", "opt_steps",
                 "calib_segments", "calib_seq", "attn_chunk"):
        assert getattr(t, name) == getattr(r, name), name
    assert t.device == "cuda"
