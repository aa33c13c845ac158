"""Port parity: the calibration statistics the baselines take
(``StatsWeight``'s Hessian and input sample) and the bit accounting
(``parse_method``, ``method_bits``, ``paper_closed_form``,
``BitsReport.row``), against ``repro`` on the CPU.

Tolerances, each with its reason:
  * ``StatsWeight`` on the same inputs: the Hessian to 1e-5 relative
    (Frobenius; the Gram matrix is a BLAS product on both sides, summed
    in another order), ``x_sample`` identical (copied rows), outputs
    and absmean to 1e-5.
  * bit accounting: exactly equal (the same Python arithmetic).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import bits as rbits  # noqa: E402
from repro.core import calibrate as rcal  # noqa: E402
from repro.core.baselines import driver as rdrv  # noqa: E402
from repro_torch.core import bits as tbits  # noqa: E402
from repro_torch.core import calibrate as tcal  # noqa: E402
from repro_torch.core.baselines import driver as tdrv  # noqa: E402

HESS_RTOL = 1e-5


def test_stats_weight_hessian_and_sample_match_repro():
    """Three calls of 32, 32 and 48 rows with a cap of 40: the first two
    are appended whole (fewer than 40 held before each), the third is
    not."""
    rng = np.random.default_rng(11)
    w = rng.normal(size=(48, 24)).astype(np.float32)
    xs = [rng.normal(size=s).astype(np.float32)
          for s in ((2, 16, 48), (32, 48), (3, 16, 48))]
    r = rcal.StatsWeight(jnp.asarray(w), collect_hessian=True,
                         sample_rows=40)
    t = tcal.StatsWeight(torch.from_numpy(w), collect_hessian=True,
                         sample_rows=40)
    for x in xs:
        y_r = r.__matmul_x__(jnp.asarray(x))
        y_t = t.__matmul_x__(torch.from_numpy(x))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), rtol=1e-5,
                                   atol=1e-5)
    assert t.count == r.count == 112
    assert np.array_equal(t.x_sample.numpy(), r.x_sample)
    assert t.x_sample.shape == (64, 48)
    h_t, h_r = t.hessian.numpy(), r.hessian
    assert np.linalg.norm(h_t - h_r) <= HESS_RTOL * np.linalg.norm(h_r)
    np.testing.assert_allclose(t.absmean.numpy(), r.absmean, rtol=1e-5)
    plain = tcal.StatsWeight(torch.from_numpy(w))
    plain.__matmul_x__(torch.from_numpy(xs[0]))
    assert plain.h is None and plain.x_sample is None


# ---------------------------------------------------------------------------
# Bit accounting
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", ["rtn-2", "rtn-8", "gptq-2", "gptq-4",
                                    "awq-2", "pbllm", "billm"])
def test_method_bits_match_repro(method):
    assert tdrv.parse_method(method) == rdrv.parse_method(method)
    for k, n in ((4096, 4096), (11008, 4096), (64, 128)):
        assert tdrv.method_bits(method, k, n) == rdrv.method_bits(method, k,
                                                                  n)

def test_parse_method_refuses_as_repro():
    for bad in ("foo-2", "rtn", "awq-x", "billm-2"):
        with pytest.raises(ValueError):
            rdrv.parse_method(bad)
        with pytest.raises(ValueError):
            tdrv.parse_method(bad)

def test_paper_closed_form_and_row_match_repro():
    for args in ((), (4096, 11008, 0.2), (64, 128, 0.25)):
        t, r = tbits.paper_closed_form(*args), rbits.paper_closed_form(*args)
        assert dataclasses.astuple(t) == dataclasses.astuple(r)
        assert t.row() == r.row()
    ours = tbits.paper_closed_form().total_bits
    assert ours < tdrv.method_bits("billm") < tdrv.method_bits("pbllm")
    assert tdrv.method_bits("gptq-2") < 2.1
