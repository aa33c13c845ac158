"""Port parity: GPTQ (``repro_torch.core.baselines.gptq``) against
``repro.core.baselines.gptq`` on the CPU.  Inputs come from numpy
generators of this file's own.

Tolerances, each with its reason:
  * the column loop given the reference's H⁻¹ factor: identical (the
    loop is elementwise; XLA contracts nothing into an FMA, measured);
    the port's own factor to rtol 1e-5, atol 1e-6 (another LAPACK).
  * ``gptq_quantize`` whole: ‖X(W−Ŵ)‖² to 1e-3 relative and below
    RTN's.  The two H⁻¹ factors come from different LAPACKs and differ
    in their last bits (2.7e-7 relative, measured); a flipped code moves
    the compensated error into every later column of its row, so the
    function is held by its objective, not by bytes.  Without a Hessian
    (an identity H): identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.baselines import gptq as rgptq  # noqa: E402
from repro_torch.core.baselines import gptq, rtn  # noqa: E402

GPTQ_RTOL = 1e-3


def _weights(seed, k=256, n=64):
    return (np.random.default_rng(seed).normal(size=(k, n)) * 0.02
            ).astype(np.float32)

def _activations(seed, k=256, rows=512):
    x = np.random.default_rng(seed).normal(size=(rows, k)).astype(np.float32)
    x[:, :32] *= 8.0                       # activation outlier channels
    return x

def _objective(x, w, wq) -> float:
    return float(np.sum((x.astype(np.float64)
                         @ (w - np.asarray(wq)).astype(np.float64)) ** 2))

def _repro_hinv(h, percdamp=0.01):
    """The reference's H⁻¹ factor, by its own operations
    (``repro/core/baselines/gptq.py:45-54``)."""
    h = jnp.asarray(h, jnp.float32)
    diag = jnp.diag(h)
    dead = diag <= 0
    h = h + jnp.diag(jnp.where(dead, 1.0, 0.0))
    damp = percdamp * jnp.mean(jnp.where(dead, 0.0, diag))
    h = h + damp * jnp.eye(h.shape[0], dtype=jnp.float32)
    return np.array(jnp.linalg.cholesky(jnp.linalg.inv(h), upper=True))

def _hessian(x, dead=()):
    h = (2.0 * x.T @ x / x.shape[0]).astype(np.float32)
    for i in dead:                       # a channel that never fires
        h[i, :] = 0.0
        h[:, i] = 0.0
    return h

@pytest.mark.parametrize("bits,dead", [(2, ()), (3, (5, 77))])
def test_gptq_column_loop_given_repro_hinv_is_identical(bits, dead):
    w = _weights(7)
    h = _hessian(_activations(8), dead)
    r = np.asarray(rgptq.gptq_quantize(jnp.asarray(w), h, bits))
    wt = torch.from_numpy(w)
    scale, zero, qmax = gptq._grid(wt, bits)
    t = gptq.gptq_columns(wt, torch.from_numpy(_repro_hinv(h)), scale, zero,
                          qmax)
    assert np.array_equal(t.numpy(), r)
    # the port's own factor agrees with the reference's to float rounding
    np.testing.assert_allclose(
        gptq.inverse_hessian_factor(torch.from_numpy(h)).numpy(),
        _repro_hinv(h), rtol=1e-5, atol=1e-6)

@pytest.mark.parametrize("bits", [2, 3])
def test_gptq_objective_matches_repro_and_beats_rtn(bits):
    w = _weights(9)
    x = _activations(10)
    h = _hessian(x)
    r = np.asarray(rgptq.gptq_quantize(jnp.asarray(w), h, bits))
    t = gptq.gptq_quantize(torch.from_numpy(w), torch.from_numpy(h),
                           bits).numpy()
    e_t, e_r = _objective(x, w, t), _objective(x, w, r)
    print(f"gptq-{bits}: {np.mean(t != r):.4%} of elements differ from the "
          f"reference; objective {e_t:.6g} vs {e_r:.6g}")
    assert abs(e_t - e_r) <= GPTQ_RTOL * e_r
    assert e_t < _objective(x, w, rtn.rtn_quantize(torch.from_numpy(w),
                                                   bits).numpy())
    # without a Hessian: an identity H, the reference's fallback
    r0 = np.asarray(rgptq.gptq_quantize(jnp.asarray(w), None, bits))
    t0 = gptq.gptq_quantize(torch.from_numpy(w), None, bits).numpy()
    assert np.array_equal(t0, r0)

def test_gptq_refuses_an_indefinite_hessian():
    h = -np.eye(8, dtype=np.float32)
    h[0, 0] = 1.0
    with pytest.raises(RuntimeError):
        gptq.inverse_hessian_factor(torch.from_numpy(h) - 4.0)
