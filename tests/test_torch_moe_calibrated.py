"""Port parity of the calibrated paths on MoE blocks: ``StatsWeight``'s
per-expert statistics, calibrated PTQ1.61 (``quantize_model_ptq161``:
per-expert masks, stacked initial quantization, Eq.-7 learning over
stacked ``DequantView``s) and the baselines' per-expert branch
(``quantize_model_baseline``), against ``repro`` on
granite-moe-1b-a400m reduced to 2 layers in f32, weights built in
``repro`` and carried across by the bridge.

The port keeps three quirks of the reference for stacked expert leaves
(ROADMAP queue 3): the Hessian is merged over every expert's capacity
rows and divided by the capacity rows alone; AWQ's row sample is the
first rows of that merged stream, mostly expert 0's; GPTQ takes the
identity in place of a per-expert Hessian.

Tolerances, as ``tests/test_torch_calibrated.py`` and
``tests/test_torch_baselines_driver.py`` set them for dense blocks:
  * perm, w4, bits, counts, shapes: exact.
  * s4, z4: rtol 1e-6; learned α's: rtol 1e-5, atol 1e-7.
  * statistics: rtol 1e-5, atol 1e-6; sampled rows rtol 1e-5, atol
    1e-5 (the block's activations round alike to about 1e-6; the expert
    down projection's input, silu(g)·u, rounds in each framework its
    own way); the Hessian to 1e-5 relative (Frobenius).
  * baselines: rtn leaves identical; pbllm, billm and awq leaves
    |Δ| ≤ 1e-6 · max|ŵ|; gptq's expert leaves (identity Hessian)
    identical; ``forward_loss`` to 1e-4 relative, gptq's to 1e-2 (its
    attention leaves take the merged Hessian, and the dense driver test
    measures 7.7e-3 there).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.configs.base import Stage as RStage  # noqa: E402
from repro.core import calibrate as rcal  # noqa: E402
from repro.core import pipeline as rpipe  # noqa: E402
from repro.core import qlinear as rql  # noqa: E402
from repro.core.baselines import driver as rdrv  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.common import Parallel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.configs.base import Stage as TStage  # noqa: E402
from repro_torch.core import calibrate as tcal  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
from repro_torch.core.baselines import driver as tdrv  # noqa: E402
from repro_torch.core.baselines import rtn as trtn  # noqa: E402
from repro_torch.core.select import map_tree  # noqa: E402
from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ARCH = "granite-moe-1b-a400m"
N_LAYERS, SEGMENTS, SEQ, STEPS = 2, 2, 32, 2
ALPHA_RTOL, ALPHA_ATOL = 1e-5, 1e-7
SCALE_RTOL = 1e-6
F32_RTOL, F32_ATOL = 1e-5, 1e-6
HESS_RTOL = 1e-5
SAMPLE_TOL = 1e-5
SUM_TOL = 1e-6
LOSS_RTOL, GPTQ_LOSS_RTOL = 1e-4, 1e-2
ALPHAS = ("alpha_s", "alpha_r1", "alpha_r2")
PAR = Parallel(tp=1, dp=1, remat=False, attn_chunk=1024)


def _keystr(path):
    return "".join(f"[{k!r}]" for k in path)


@pytest.fixture(scope="module")
def subject():
    """repro's f32 reduced granite (2 layers), its port twin, the
    calibration segments and a validation batch."""
    rcfg = dataclasses.replace(registry.get(ARCH).reduced(),
                               stages=(RStage(("moe",), N_LAYERS),))
    tcfg = dataclasses.replace(t_registry.get(ARCH).reduced(),
                               stages=(TStage(("moe",), N_LAYERS),))
    p = RM.init_params(rcfg, PAR, jax.random.PRNGKey(0))
    p = jax.tree.map(lambda a: a.astype(jnp.float32)
                     if a.dtype == jnp.bfloat16 else a, p)
    corpus = SyntheticCorpus(CorpusConfig(vocab=rcfg.vocab, seed=0))
    toks = [t for t, _ in corpus.batches(1, SEQ, SEGMENTS, split="calib")]
    valid = next(corpus.batches(2, SEQ, 1, split="valid"))
    return (rcfg, tcfg, p,
            bridge.params_from_repro(jax.tree.map(np.asarray, p)), toks,
            valid)


def test_collect_wrappers_per_expert_match_repro(subject):
    """Expert leaves: Σ|x| and Σx² per expert (E, K) over the capacity
    rows, ``count`` counting those rows; the Hessian and the row sample
    over every expert's rows at once.  Attention leaves as before."""
    rcfg, tcfg, rp, tp, toks, _ = subject
    x = [np.array(RM.embed_tokens(rcfg, rp, jnp.asarray(t))) for t in toks]
    r = rcal.collect_wrappers(
        rpipe._block_forward(rcfg, PAR, "moe"),
        rpipe.tree_slice(rp["stages"][0][0], 0), [jnp.asarray(a) for a in x],
        min_dim=32, collect_hessian=True, sample_rows=48)
    t = tcal.collect_wrappers(
        tpipe._block_forward(tcfg, "moe"), tp["stages"][0][0][0],
        [torch.from_numpy(a) for a in x], min_dim=32, collect_hessian=True,
        sample_rows=48)
    assert len(t) == 7 and {_keystr(k) for k in t} == set(r)
    e = rcfg.moe.n_experts
    for k, sw in t.items():
        rw = r[_keystr(k)]
        assert sw.count == rw.count, k
        for name in ("absmean", "sqmean"):
            got, want = getattr(sw, name).numpy(), np.asarray(getattr(rw,
                                                                      name))
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=F32_RTOL,
                                       atol=F32_ATOL, err_msg=str(k))
        h_t, h_r = sw.hessian.numpy(), rw.hessian
        assert np.linalg.norm(h_t - h_r) <= HESS_RTOL * np.linalg.norm(h_r)
        assert sw.x_sample.shape == rw.x_sample.shape
        np.testing.assert_allclose(sw.x_sample.numpy(), rw.x_sample,
                                   rtol=SAMPLE_TOL, atol=SAMPLE_TOL)
        if k[0] == "mlp":
            assert sw.absmean.shape == (e, sw.w.shape[-2])
            assert sw.count == SEGMENTS * TL.moe_capacity(tcfg, SEQ)


def _qlinears(tree):
    out = {}
    map_tree(tree, lambda p, x: out.__setitem__(p, x)
             if isinstance(x, tql.QLinear) else x)
    return out


def test_quantize_model_ptq161_on_moe_blocks_matches_repro(subject):
    """Packed bytes identical per expert, scales and learned α's within
    the dense test's tolerances, and learning never raises a block's
    Eq.-7 loss."""
    rcfg, tcfg, rp, tp, toks, _ = subject
    kw = dict(ratio=0.2, multiple=16, steps=STEPS)
    rq = rpipe.quantize_model_ptq161(
        rcfg, PAR, rp, [{"tokens": jnp.asarray(t)} for t in toks],
        rql.QuantConfig(**kw), min_dim=32)
    losses = []
    tq = tpipe.quantize_model_ptq161(
        tcfg, tp, [{"tokens": torch.from_numpy(t)} for t in toks],
        tql.QuantConfig(**kw), min_dim=32, block_losses=losses)
    a = _qlinears(tq)
    b = _qlinears(bridge.params_from_repro(jax.tree.map(np.asarray, rq)))
    assert len(a) == 7 * N_LAYERS and a.keys() == b.keys()
    experts = [k for k in a if k[-2] == "mlp"]
    assert len(experts) == 3 * N_LAYERS
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
    for k in experts:                       # learned, one mask per expert
        assert a[k].perm.shape[0] == rcfg.moe.n_experts
        assert not torch.equal(a[k].alpha_r1, torch.ones_like(a[k].alpha_r1))
    assert len(losses) == N_LAYERS
    assert all(after <= before for before, after in losses), losses


def _stage_leaves(tree):
    out = {}
    map_tree(tree, lambda p, x: out.__setitem__(p, x)
             if p[0] == "stages" and isinstance(x, torch.Tensor)
             and x.ndim >= 2 and p[-1] != "router" else x)
    return out


def _sum_gap(t, r) -> float:
    return float(np.abs(np.asarray(t) - np.asarray(r)).max()
                 / np.abs(np.asarray(r)).max())


@pytest.mark.parametrize("method", ["rtn-2", "gptq-2", "awq-2", "pbllm",
                                    "billm"])
def test_quantize_model_baseline_on_moe_blocks_matches_repro(subject,
                                                             method):
    rcfg, tcfg, rp, tp, toks, (vt, vg) = subject
    rq = rdrv.quantize_model_baseline(
        rcfg, PAR, rp, [{"tokens": jnp.asarray(t)} for t in toks], method,
        min_dim=32)
    choices = {}
    tq = tdrv.quantize_model_baseline(
        tcfg, tp, [{"tokens": torch.from_numpy(t)} for t in toks], method,
        min_dim=32, choices=choices)
    a = _stage_leaves(tq)
    b = _stage_leaves(bridge.params_from_repro(jax.tree.map(np.asarray,
                                                            rq)))
    fp = _stage_leaves(tp)
    assert a.keys() == b.keys() and len(a) == 7 * N_LAYERS
    for k in a:
        assert a[k].dtype == fp[k].dtype and a[k].shape == fp[k].shape
    experts = [k for k in a if a[k].ndim == 3]
    assert len(experts) == 3 * N_LAYERS
    if method == "gptq-2":
        # no per-expert Hessian: both sides run the column loop on the
        # damped identity, which gives the same bits
        for k in experts:
            assert not torch.equal(a[k], fp[k])
            assert torch.equal(a[k], b[k]), k
    elif method == "rtn-2":
        assert all(torch.equal(a[k], b[k]) for k in a)
        for k in experts:
            for e in range(a[k].shape[0]):
                assert torch.equal(a[k][e], trtn.rtn_quantize(fp[k][e], 2))
    else:
        for k in a:
            assert _sum_gap(a[k], b[k]) <= SUM_TOL, k
    if method in ("awq-2", "billm"):
        picks = [v for key, v in choices.items() if key[-1] in ("wgu", "wg",
                                                                 "wu", "wd")]
        assert picks and all(len(v) == rcfg.moe.n_experts for v in picks)
    batch_r = {"tokens": jnp.asarray(vt), "targets": jnp.asarray(vg)}
    batch_t = {"tokens": torch.from_numpy(vt), "targets": torch.from_numpy(vg)}
    l_r = float(RM.forward_loss(rcfg, PAR, rq, batch_r))
    l_t = float(TM.forward_loss(tcfg, tq, batch_t))
    print(f"{method}: loss {l_t:.7g} (repro {l_r:.7g})")
    rtol = GPTQ_LOSS_RTOL if method == "gptq-2" else LOSS_RTOL
    assert abs(l_t - l_r) <= rtol * l_r
