"""Port parity: the GPipe schedule (``repro_torch.distributed.pipeline.
pipeline_apply``) against the reference's ``pipeline_apply`` and the
sequential oracle.

One stage runs in this process over a one-rank gloo group, on the
inputs of the reference's ``test_pipeline_single_stage_oracle``,
beside the reference's own ``pipeline_apply`` on a one-device mesh.
Two and four stages run on four gloo ranks of
``tests/torch_dist_worker.py`` (the reference's multi-stage test skips
without several devices): a ("stage",) mesh of four stages and a
("stage", "data") mesh of two stages by two replicas, with the stage
leaves as DTensors sharded over "stage" and as whole tensors.  Every
tick applies the same block to the same microbatch as the oracle does,
so the outputs are the oracle's bits.
"""
import datetime

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

import torch_dist_worker as W  # noqa: E402

from repro.distributed.pipeline import pipeline_apply as r_pipeline  # noqa: E402
from repro.launch.mesh import compat_make_mesh  # noqa: E402
from repro_torch.distributed.pipeline import pipeline_apply  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402


def _oracle(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    outs = []
    for i in range(x.shape[0]):
        h = x[i]
        for s in range(w.shape[0]):
            h = torch.tanh(h @ w[s])
        outs.append(h)
    return torch.stack(outs)


def test_single_stage_matches_reference_and_oracle(tmp_path):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(1, 8, 8)).astype(np.float32)
    x = rng.normal(size=(3, 4, 8)).astype(np.float32)
    ref = r_pipeline(lambda p, h: jnp.tanh(h @ p), jnp.asarray(w),
                     jnp.asarray(x), compat_make_mesh((1,), ("stage",)),
                     axis="stage")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh((1,), ("stage",), "cpu")
        tw, tx = torch.from_numpy(w), torch.from_numpy(x)
        out = pipeline_apply(lambda p, h: torch.tanh(h @ p), tw, tx, mesh)
    finally:
        dist.destroy_process_group()
    assert torch.equal(out, _oracle(tw, tx))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def multi_stage(tmp_path_factory):
    g = torch.Generator().manual_seed(0)
    case = {"task": "pipeline", "x": torch.randn(5, 4, 8, generator=g),
            "w4": torch.randn(4, 8, 8, generator=g) / 3,
            "w2x2": torch.randn(2, 8, 8, generator=g) / 3}
    ranks = W.launch({"pipe": case}, tmp_path_factory.mktemp("pipeline"))
    return case, [r["pipe"] for r in ranks]


@pytest.mark.parametrize("mesh", ["4", "2x2"])
def test_stages_across_ranks_match_sequential(multi_stage, mesh):
    case, ranks = multi_stage
    want = _oracle(case["w" + mesh], case["x"])
    for r in ranks:
        assert torch.equal(r[mesh], want)
        assert torch.equal(r[mesh + "_whole"], want)
