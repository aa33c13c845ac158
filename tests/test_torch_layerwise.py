"""The layer-at-a-time build of ``chip_smoke.py`` and the two widest
models' serving path, on the CPU at the reference's ``reduced()`` sizes
(f32 where tokens are compared):

  * ``chip_smoke.build_layerwise`` on command-r-35b and mixtral-8x22b
    reduced to 2 layers gives, leaf for leaf and bit for bit, the tree
    of ``quantize_params_data_free(init_params(...))`` at the same
    settings (ratio 0.2, multiple 16, min dim 32, fused), and the bytes
    a decode step reads plus the vectors fusion shares equal
    ``launch.qdeclare``'s declaration (``chip_smoke.declared_bytes``);
  * the port's paged chunked-prefill engine (pages of 8, chunks of 16,
    3 slots, prompts of 5-60 tokens, 8 new) gives the reference's
    greedy tokens and chunk calls on the reduced configs, the weights
    built in ``repro``, every norm scale and bias randomized, carried
    across by the bridge and quantized data-free fused.  On mixtral
    (window 32) the chunks past the window run the windowed prefill
    kernel's plain version against the reference's Pallas kernel in
    interpret mode;
  * at full size, the declaration on meta tensors equal, in packed,
    floating-point and head bytes and in quantized weights, to
    ``repro.launch.qdeclare``'s on abstract shapes; the packed bytes
    within 1% of 0.2 bytes a quantized weight as sized for one H100
    (mixtral-8x22b 28.2 GB of 140.2 B weights, command-r-35b 5.7 GB of
    28.2 B), and the resident model plus one layer in bf16 (what the
    build holds at its peak, transients aside) under 80 GB.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.core import pipeline as rpipe  # noqa: E402
from repro.core import qlinear as rql  # noqa: E402
from repro.kernels import autotune, ops as rops  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.common import Parallel  # noqa: E402
from repro.runtime.engine import Engine as REngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.configs.base import Stage  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.qlinear import (FIELDS, QLinear, QLinearGroup,  # noqa: E402
                                      QuantConfig)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime.engine import Engine as TEngine  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

ARCHS = ("command-r-35b", "mixtral-8x22b")
PAR = Parallel(tp=1, dp=1, remat=False, attn_chunk=32)
CHUNKED = dict(paged=True, page_size=8, chunked_prefill=True,
               prefill_chunk=16)
# packed GB and quantized weights (billions) at full size: 0.2 bytes a
# weight, the sizing the two models are built to on one card
SIZED = {"mixtral-8x22b": (28.2, 140.2), "command-r-35b": (5.7, 28.2)}


def _same_tree(a, b, path="params"):
    """Every leaf of ``a`` bit-identical to ``b``'s: packed fields, the
    packed sizes and a group's splits, floating tensors."""
    if isinstance(b, QLinearGroup):
        assert isinstance(a, QLinearGroup) and a.splits == b.splits, path
        _same_tree(a.inner, b.inner, path + ".inner")
    elif isinstance(b, QLinear):
        assert isinstance(a, QLinear), path
        assert (a.k_s, a.k, a.n) == (b.k_s, b.k, b.n), path
        for f in FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), (path, f)
    elif isinstance(b, dict):
        assert a.keys() == b.keys(), path
        for k in b:
            _same_tree(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}[{i}]")
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), path


@pytest.mark.parametrize("arch", ARCHS)
def test_layerwise_build_equals_whole_quantization(arch):
    cfg = t_registry.get(arch).reduced()
    cfg = dataclasses.replace(cfg, stages=(Stage(cfg.stages[0].pattern,
                                                 2),))
    built, seconds, peak = chip_smoke.build_layerwise(torch, cfg, 2, "cpu")
    whole = tpipe.quantize_params_data_free(
        TM.init_params(cfg, 0, "cpu"), QuantConfig(ratio=0.2, multiple=16),
        min_dim=32, fuse=True)
    assert seconds > 0 and peak is None
    assert len(built["stages"][0]) == 2
    _same_tree(built, whole)
    layer = built["stages"][0][0][0]
    assert isinstance(layer["attn"]["wqkv"], QLinearGroup)
    assert isinstance(layer["mlp"]["wgu"], QLinearGroup)
    if arch == "mixtral-8x22b":
        assert layer["mlp"]["wgu"].inner.w4.ndim == 3   # stacked experts
    decl = chip_smoke.declared_bytes(torch, cfg)
    shared = chip_smoke._fusion_shared_bytes(built)
    assert shared > 0
    assert chip_smoke._weight_bytes(built) + shared == \
        decl["packed"] + decl["head"]


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


def _randomized(p, seed: int):
    """Every norm scale and bias of a repro tree set to seeded random
    values, so a dropped or misplaced one shows."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = getattr(path[-1], "key", None)
        if name == "scale":
            return jnp.asarray(1.0 + 0.3 * rng.normal(size=a.shape), a.dtype)
        if name == "bias":
            return jnp.asarray(0.3 * rng.normal(size=a.shape), a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(leaf, p)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_engine_matches_repro(arch, repro_kernel_everywhere):
    rcfg = registry.get(arch).reduced()
    tcfg = t_registry.get(arch).reduced()
    p = RM.init_params(rcfg, PAR, jax.random.PRNGKey(3))
    p = jax.tree.map(lambda a: a.astype(jnp.float32)
                     if a.dtype == jnp.bfloat16 else a, p)
    p = _randomized(p, 30)
    rp = rpipe.quantize_params_data_free(
        p, rql.QuantConfig(ratio=0.2, multiple=16, use_kernel=True),
        min_dim=32, fuse=True)
    tp = bridge.params_from_repro(jax.tree.map(np.asarray, rp))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, rcfg.vocab, size=n).astype(np.int32)
               for n in (5, 17, 31, 48, 60)]
    got = []
    for eng in (REngine(rcfg, PAR, rp, cache_dtype=jnp.float32, n_slots=3,
                        max_seq=128, **CHUNKED),
                TEngine(tcfg, tp, cache_dtype=torch.float32, device="cpu",
                        attn_chunk=PAR.attn_chunk, n_slots=3, max_seq=128,
                        **CHUNKED)):
        reqs = [eng.submit(x, max_new=8) for x in prompts]
        eng.run()
        assert all(r.done for r in reqs)
        got.append(([r.out_tokens for r in reqs],
                    eng.backend.prefill_chunk_calls))
    assert got[1] == got[0]
    # 1 + 2 + 2 + 3 + 4 chunks of 16; on mixtral those at 48 start past
    # the window of 32
    assert got[1][1] == 12
    if rcfg.attn_window is not None:
        assert rcfg.attn_window == tcfg.attn_window == 32


def _repro_declared(arch):
    """What ``repro.launch.qdeclare.declare_quantized`` declares for the
    full-size ``arch`` (``jax.ShapeDtypeStruct`` leaves, no memory) at
    ``chip_smoke.declared_bytes``'s settings, counted as it counts."""
    from repro.distributed.sharding import Rules
    from repro.launch.qdeclare import declare_quantized
    abstract, _ = declare_quantized(registry.get(arch), Parallel(),
                                    rql.QuantConfig(ratio=0.2, multiple=16),
                                    Rules(), min_dim=32)
    nbytes = lambda x: int(np.prod(x.shape)) * x.dtype.itemsize  # noqa: E731
    out = {"packed": 0, "floats": 0, "weights": 0}
    for leaf in jax.tree_util.tree_leaves(
            abstract, is_leaf=lambda x: isinstance(x, rql.QLinear)):
        if isinstance(leaf, rql.QLinear):
            out["packed"] += sum(nbytes(getattr(leaf, f))
                                 for f in rql.QLinear._FIELDS)
            out["weights"] += int(np.prod(leaf.perm.shape[:-1])) \
                * leaf.k * leaf.n
        else:
            out["floats"] += nbytes(leaf)
    out["head"] = nbytes(abstract.get("lm_head", abstract["embed"]))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_declaration_fits_one_card(arch):
    cfg = t_registry.get(arch)
    decl = chip_smoke.declared_bytes(torch, cfg)
    # the port's declaration is the reference's, to the byte
    want = _repro_declared(arch)
    assert {k: decl[k] for k in want} == want
    packed_gb, weights_b = SIZED[arch]
    assert decl["packed"] / 1e9 == pytest.approx(packed_gb, rel=1e-2)
    assert decl["weights"] / 1e9 == pytest.approx(weights_b, rel=1e-2)
    assert decl["resident"] + decl["layer_bf16"] < 80e9
    # the packed fields are about 0.2 bytes a quantized weight
    assert 0.19 < decl["packed"] / decl["weights"] < 0.21
