"""Port parity of the attention-family options no other test builds,
each at the reference's ``reduced()`` config (d 64, one layer, f32):

  * ``qkv_bias`` (qwen2.5-3b): the q/k/v biases, added after the fused
    ``wqkv`` product on the packed path;
  * ``qk_norm`` (qwen3-4b): RMS norms of q and k per head before RoPE;
  * ``norm="layernorm"`` with a bias (command-r-35b, untied head);
  * ``attn_window`` on ``moe`` blocks (mixtral-8x22b: 4 experts, top-2,
    window 32), into the ring caches and the paged decode kernel.

Weights are built in ``repro`` and carried across by the bridge, with
every bias and norm scale set to seeded random values first, so a
dropped or misplaced one shows.  For each config: ``forward_loss`` on
the dense and the fused packed weights, the data-free fused bytes, and
greedy tokens of the whole-prompt engine on both backends, against
``repro``.  Packed projections run through ``repro``'s mixed_matmul
kernel in interpret mode on every shape (``repro_kernel_everywhere``).

Tolerances: the loss 1e-5 relative on dense and packed weights (f32
sums in two libraries; measured at most 3.1e-7); packed bytes and
``perm`` exact, scales 1e-6 relative (f32 means summed in another
order); greedy tokens identical (f32 params and page pools; the
contiguous rings are bf16 on both sides).
"""
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
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
from repro_torch.core.select import map_tree  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime.engine import Engine as TEngine  # noqa: E402

PAR = Parallel(tp=1, dp=1, remat=False, attn_chunk=32)
ARCHS = ("qwen2.5-3b", "qwen3-4b", "command-r-35b", "mixtral-8x22b")
LOSS_REL = 1e-5
SCALE_RTOL = 1e-6


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


def randomize_scales_and_biases(p, seed: int):
    """Every norm scale, norm bias and projection bias of a repro tree ->
    seeded random values (scales around 1, biases around 0)."""
    rng = np.random.default_rng(seed)
    seen = []

    def leaf(path, a):
        name = getattr(path[-1], "key", None)
        if name in ("scale", "q_norm", "k_norm"):
            seen.append(name)
            return jnp.asarray(1.0 + 0.3 * rng.normal(size=a.shape), a.dtype)
        if name in ("bias", "bq", "bk", "bv"):
            seen.append(name)
            return jnp.asarray(0.3 * rng.normal(size=a.shape), a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(leaf, p), set(seen)


# the option each config carries, as the leaves that must be randomized
OPTION_LEAVES = {"qwen2.5-3b": {"bq", "bk", "bv"},
                 "qwen3-4b": {"q_norm", "k_norm"},
                 "command-r-35b": {"bias"},
                 "mixtral-8x22b": {"scale"}}


# the options themselves, kept by both packages' reduced configs
OPTIONS = {"qwen2.5-3b": dict(qkv_bias=True),
           "qwen3-4b": dict(qk_norm=True),
           "command-r-35b": dict(norm="layernorm", tied_embeddings=False),
           "mixtral-8x22b": dict(attn_window=32)}


@pytest.fixture(scope="module")
def subjects():
    """{arch: (rcfg, tcfg, {mode: (repro params, port params)})}; "fused"
    is data-free PTQ1.61 with fused QKV and gate+up."""
    out = {}
    for i, arch in enumerate(ARCHS):
        rcfg = registry.get(arch).reduced()
        tcfg = t_registry.get(arch).reduced()
        p = RM.init_params(rcfg, PAR, jax.random.PRNGKey(i))
        p = jax.tree.map(lambda a: a.astype(jnp.float32)
                         if a.dtype == jnp.bfloat16 else a, p)
        p, seen = randomize_scales_and_biases(p, 10 + i)
        assert OPTION_LEAVES[arch] <= seen, (arch, seen)
        for k, v in OPTIONS[arch].items():
            assert getattr(rcfg, k) == v and getattr(tcfg, k) == v, (arch, k)
        qp = rpipe.quantize_params_data_free(
            p, rql.QuantConfig(ratio=0.25, multiple=16, use_kernel=True),
            min_dim=32, fuse=True)
        out[arch] = (rcfg, tcfg, {
            mode: (rp, bridge.params_from_repro(jax.tree.map(np.asarray,
                                                             rp)))
            for mode, rp in (("fp", p), ("fused", qp))})
    return out


def _qlinears(tree):
    """{path: QLinear}, a fused group's inner under its group's path."""
    out = {}

    def visit(p, x):
        q = x.inner if isinstance(x, tql.QLinearGroup) else x
        if isinstance(q, tql.QLinear):
            out[p] = q
        return x
    map_tree(tree, visit)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_matches_repro(subjects, arch, repro_kernel_everywhere):
    """The causal-LM loss (plus 0.01 · the load-balancing loss on
    mixtral) on 2 × 64 tokens, dense and fused packed weights."""
    rcfg, tcfg, params = subjects[arch]
    rng = np.random.default_rng(17)
    toks = rng.integers(1, rcfg.vocab, size=(2, 64)).astype(np.int32)
    tgts = rng.integers(0, rcfg.vocab, size=(2, 64)).astype(np.int32)
    tgts[0, :5] = -1
    for mode, (rp, tp) in params.items():
        lr = RM.forward_loss(rcfg, PAR, rp, {"tokens": jnp.asarray(toks),
                                             "targets": jnp.asarray(tgts)})
        lt = TM.forward_loss(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                        "targets": torch.from_numpy(tgts)},
                             attn_chunk=PAR.attn_chunk)
        assert torch.isfinite(lt)
        np.testing.assert_allclose(float(lt), float(lr),
                                   rtol=LOSS_REL, err_msg=mode)


@pytest.mark.parametrize("arch", ARCHS)
def test_datafree_fused_bytes_match_repro(subjects, arch):
    """The port's data-free fused quantization of the bridged dense tree
    gives the reference's packed bytes; the biases and norm scales stay
    fp leaves beside the fused groups."""
    rcfg, tcfg, params = subjects[arch]
    mine = tpipe.quantize_params_data_free(
        params["fp"][1], tql.QuantConfig(ratio=0.25, multiple=16),
        min_dim=32, fuse=True)
    theirs = params["fused"][1]
    a, b = _qlinears(mine), _qlinears(theirs)
    assert a.keys() == b.keys() and a
    for k in a:
        for f in ("perm", "w4", "bits"):
            assert torch.equal(getattr(a[k], f), getattr(b[k], f)), (k, f)
        for f in ("s4", "z4", "alpha_s", "alpha_r1", "alpha_r2"):
            torch.testing.assert_close(getattr(a[k], f), getattr(b[k], f),
                                       rtol=SCALE_RTOL, atol=0.0)
    attn = mine["stages"][0][0][0]["attn"]
    assert "wqkv" in attn
    for name in OPTION_LEAVES[arch] - {"scale", "bias"}:
        assert torch.equal(attn[name], theirs["stages"][0][0][0]["attn"][name])
    if arch == "command-r-35b":
        assert mine["final_norm"]["bias"].abs().max() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_repro(subjects, arch, repro_kernel_everywhere):
    """Greedy tokens of the contiguous and the paged whole-prompt engine
    on the fused packed weights: 3 slots, 5 prompts of 5-60 tokens at
    buckets 16 / 64, 8 new tokens (past mixtral's window of 32)."""
    rcfg, tcfg, params = subjects[arch]
    rp, tp = params["fused"]
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 512, size=n).astype(np.int32)
               for n in (5, 17, 31, 48, 60)]
    for kw in (dict(), dict(paged=True, page_size=8)):
        toks = []
        for eng in (REngine(rcfg, PAR, rp, cache_dtype=jnp.float32,
                            n_slots=3, max_seq=128, prefill_buckets=(16, 64),
                            **kw),
                    TEngine(tcfg, tp, cache_dtype=torch.float32,
                            device="cpu", attn_chunk=PAR.attn_chunk,
                            n_slots=3, max_seq=128, prefill_buckets=(16, 64),
                            **kw)):
            reqs = [eng.submit(p, max_new=8) for p in prompts]
            eng.run()
            assert all(r.done for r in reqs)
            toks.append([r.out_tokens for r in reqs])
        assert toks[1] == toks[0], kw
