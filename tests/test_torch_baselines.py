"""Port parity: the paper's baseline quantizers RTN, PB-LLM, BiLLM and
AWQ, one weight at a time, against ``repro.core.baselines`` on the CPU
(GPTQ: ``test_torch_baselines_gptq.py``; statistics and bit accounting:
``test_torch_baselines_stats.py``; the driver:
``test_torch_baselines_driver.py``).  Inputs come from numpy generators
of this file's own.

Tolerances, each with its reason:
  * ``rtn_quantize``: identical (min/max, one tensor division, round
    half to even, clamp: every operation rounds alike).
  * ``pbllm_quantize``: mask, 8-bit salient values and signs identical;
    the binary α is a column sum, which the port adds in a fixed
    pairwise order (the same on the card and the CPU) and XLA in an
    order of its own, so |Δ| ≤ 1e-6 · max|ŵ| (measured 3.5e-8).  On a
    dyadic weight grid where every partial sum is exact, identical.
  * ``billm_quantize``: the reference's salient rows and split index
    (recomputed with its own jnp operations), identical signs, |Δ| ≤
    1e-6 · max|ŵ| (α's are column sums as in PB-LLM; measured 6.5e-7
    where the two residual passes nearly cancel).
  * ``awq_quantize``: the reference's α index (its grid errors
    recomputed with jnp), and ‖X(W−Ŵ)‖² to 1e-5 relative (``pow`` and
    the mean differ in their last bit between the two libraries).
Each test prints how far the chosen split or α is from a tie.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.baselines import awq as rawq  # noqa: E402
from repro.core.baselines import billm as rbillm  # noqa: E402
from repro.core.baselines import pbllm as rpbllm  # noqa: E402
from repro.core.baselines import rtn as rrtn  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.baselines import awq, billm, pbllm, rtn  # noqa: E402

SUM_TOL = 1e-6            # |Δ| / max|ŵ| where α's are column sums
AWQ_RTOL = 1e-5


def _weights(seed, k=256, n=64):
    return (np.random.default_rng(seed).normal(size=(k, n)) * 0.02
            ).astype(np.float32)

def _activations(seed, k=256, rows=512):
    x = np.random.default_rng(seed).normal(size=(rows, k)).astype(np.float32)
    x[:, :32] *= 8.0                       # activation outlier channels
    return x

def _sum_gap(t, r) -> float:
    return float(np.abs(np.asarray(t) - np.asarray(r)).max()
                 / np.abs(np.asarray(r)).max())

def _objective(x, w, wq) -> float:
    return float(np.sum((x.astype(np.float64)
                         @ (w - np.asarray(wq)).astype(np.float64)) ** 2))


# ---------------------------------------------------------------------------
# The quantizers, one weight at a time
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_rtn_matches_repro(bits):
    w = _weights(1)
    r = np.asarray(rrtn.rtn_quantize(jnp.asarray(w), bits))
    assert np.array_equal(rtn.rtn_quantize(torch.from_numpy(w), bits).numpy(),
                          r)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    rb = rrtn.rtn_quantize(jnp.asarray(w, jnp.bfloat16), bits)
    assert torch.equal(rtn.rtn_quantize(wb, bits),
                       bridge.to_tensor(np.asarray(rb)))

def _pbllm_mask(w):
    n_sal = int(round(0.1 * w.size))
    return np.abs(w) >= np.sort(np.abs(w).ravel())[-n_sal]

@pytest.mark.parametrize("grid", [False, True])
def test_pbllm_matches_repro(grid):
    w = _weights(2)
    if grid:                   # dyadic values: every partial sum is exact
        w = np.round(w * 2 ** 10).astype(np.float32) / 2 ** 10
    r = np.asarray(rpbllm.pbllm_quantize(jnp.asarray(w)))
    t = pbllm.pbllm_quantize(torch.from_numpy(w)).numpy()
    mask = _pbllm_mask(w)
    assert 0.09 < mask.mean() < 0.11
    assert np.array_equal(t[mask], r[mask])
    assert np.array_equal(np.sign(t), np.sign(r))
    if grid:
        assert np.array_equal(t, r)
    else:
        assert _sum_gap(t, r) <= SUM_TOL

def _repro_billm_choices(w, hd):
    """The reference's salient rows and split index, recomputed with its
    own jnp operations (``repro/core/baselines/billm.py:34-64``), and
    the gap between its best and second-best split errors."""
    wf = jnp.asarray(w)
    k = w.shape[0]
    sens = jnp.mean(jnp.square(wf), axis=1)
    if hd is not None:
        sens = jnp.asarray(hd) * sens
    _, idx = jax.lax.top_k(sens, max(1, int(round(0.1 * k))))
    sal = jnp.zeros((k,), bool).at[idx].set(True)[:, None]
    nonsal = ~sal & jnp.ones_like(wf, bool)
    absw = jnp.abs(jnp.where(nonsal, wf, jnp.nan))
    lo, hi = jnp.nanmin(absw), jnp.nanmax(absw)
    errs = []
    for i in range(1, 16):
        t = lo + (hi - lo) * i / 16
        g_hi = nonsal & (jnp.abs(wf) >= t)
        g_lo = nonsal & (jnp.abs(wf) < t)
        rec = jnp.where(g_hi, rbillm._binarize(wf, g_hi),
                        rbillm._binarize(wf, g_lo))
        errs.append(float(jnp.sum(jnp.where(nonsal, (rec - wf) ** 2, 0.0))))
    best = min(range(15), key=lambda j: (errs[j], j))
    second = sorted(errs)[1]
    return set(np.asarray(idx).tolist()), best + 1, (second - errs[best]
                                                     ) / errs[best]

@pytest.mark.parametrize("hessian", [False, True])
def test_billm_matches_repro(hessian):
    w = _weights(3)
    x = _activations(4)
    hd = (np.diag(2.0 * x.T @ x / x.shape[0]).astype(np.float32)
          if hessian else None)
    r = np.asarray(rbillm.billm_quantize(jnp.asarray(w), hd))
    t, rows, split = billm.billm_search(
        torch.from_numpy(w), None if hd is None else torch.from_numpy(hd))
    rows_r, split_r, margin = _repro_billm_choices(w, hd)
    print(f"billm hessian={hessian}: split {split_r}, best split error "
          f"{margin:.2e} below the next")
    assert set(rows.tolist()) == rows_r
    assert split == split_r
    t = t.numpy()
    assert np.array_equal(np.sign(t), np.sign(r))
    assert _sum_gap(t, r) <= SUM_TOL
    # better than one analytic binarization, as tests/test_baselines.py
    one = np.where(w >= 0, 1.0, -1.0) * np.abs(w).mean(0, keepdims=True)
    assert np.mean((t - w) ** 2) < np.mean((one - w) ** 2)

def test_awq_matches_repro():
    rng = np.random.default_rng(5)
    w = _weights(6)
    stat = np.abs(rng.normal(size=(256,)).astype(np.float32)) * 10 + 0.1
    x = (rng.normal(size=(64, 256)) * stat).astype(np.float32)
    r = np.asarray(rawq.awq_quantize(jnp.asarray(w), stat, 2, x_sample=x))
    t, g = awq.awq_search(torch.from_numpy(w), torch.from_numpy(stat), 2,
                          torch.from_numpy(x))
    # the reference's grid errors (awq.py:25-44) with its own operations
    s0 = jnp.asarray(stat) / (jnp.mean(jnp.asarray(stat)) + 1e-8) + 1e-4
    errs = []
    for i in range(20):
        s = jnp.power(s0, i / 20)[:, None]
        wq = rrtn.rtn_quantize(jnp.asarray(w) * s, 2) / s
        errs.append(float(jnp.mean(jnp.square(jnp.asarray(x) @ wq
                                              - jnp.asarray(x) @ w))))
    g_r = min(range(20), key=lambda j: (errs[j], j))
    print(f"awq: alpha index {g_r}, best grid error "
          f"{(sorted(errs)[1] - errs[g_r]) / errs[g_r]:.2e} below the next")
    assert g == g_r
    e_t, e_r = _objective(x, w, t), _objective(x, w, r)
    assert abs(e_t - e_r) <= AWQ_RTOL * e_r, (e_t, e_r)
    assert e_t <= _objective(x, w, rrtn.rtn_quantize(jnp.asarray(w), 2))
    # no statistics: plain RTN, index -1
    t0, g0 = awq.awq_search(torch.from_numpy(w), None, 2)
    assert g0 == -1 and torch.equal(t0, rtn.rtn_quantize(
        torch.from_numpy(w), 2))
