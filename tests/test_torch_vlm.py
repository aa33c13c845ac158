"""Port parity of the vision-prefix model (llava-next-34b reduced: d 64,
GQA 4/2, one dense layer, 8 frontend tokens; f32) against ``repro`` on
the same weights (built in ``repro``, carried across by the bridge),
with tokens and vision embeddings made by numpy from a seed:

  * ``forward_loss`` and ``prefill`` with ``vision_embeds`` spliced over
    the first 8 token embeddings, and the decode steps after it, on the
    dense and the data-free fused packed weights;
  * the data-free fused bytes;
  * greedy tokens of the engine on text prompts (the reference's engine
    serves no vision embeddings) on the contiguous, the whole-prompt
    paged and the chunked paged backends: identical to the reference's;
  * ``launch.serve --arch llava-next-34b --reduced`` on the CPU.

Packed projections run through ``repro``'s mixed_matmul kernel in
interpret mode on every shape (``repro_kernel_everywhere``).
Tolerances are ``tests/test_torch_model.py``'s: 2e-4 absolute on dense
f32 weights, 2e-3 on packed weights; the loss is held to the same
absolute bounds.  Packed bytes and ``perm`` exact, tokens identical
(f32 params and page pools; the contiguous rings are bf16 on both
sides).
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
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime.engine import Engine as TEngine  # noqa: E402

ARCH = "llava-next-34b"
PAR = Parallel(tp=1, dp=1, remat=False, attn_chunk=32)
ATOL = {"fp": 2e-4, "fused": 2e-3}
SUM_TOL = 1e-6
B, S, MAX_SEQ, FT = 2, 24, 48, 8


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


@pytest.fixture(scope="module")
def subject():
    """(rcfg, tcfg, {mode: (repro params, port params)}); "fused" is
    data-free PTQ1.61 with QKV and gate+up fused."""
    rcfg = registry.get(ARCH).reduced()
    tcfg = t_registry.get(ARCH).reduced()
    assert rcfg.frontend == tcfg.frontend == "vision"
    assert tcfg.frontend_tokens == FT
    p = RM.init_params(rcfg, PAR, jax.random.PRNGKey(0))
    p = jax.tree.map(lambda a: a.astype(jnp.float32)
                     if a.dtype == jnp.bfloat16 else a, p)
    qp = rpipe.quantize_params_data_free(
        p, rql.QuantConfig(ratio=0.25, multiple=16, use_kernel=True),
        min_dim=32, fuse=True)
    return rcfg, tcfg, {
        mode: (rp, bridge.params_from_repro(jax.tree.map(np.asarray, rp)))
        for mode, rp in (("fp", p), ("fused", qp))}


def _inputs(seed: int):
    """Tokens (B, S + 4) and vision embeddings (B, 8, 64) at the scale
    of the token embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, 512, size=(B, S + 4)).astype(np.int32)
    ve = (0.02 * rng.normal(size=(B, FT, 64))).astype(np.float32)
    return toks, ve


def _close(t, r, atol, msg=""):
    np.testing.assert_allclose(np.asarray(t.detach().float()),
                               np.asarray(r, np.float32), rtol=0, atol=atol,
                               err_msg=msg)


@pytest.mark.parametrize("mode", ["fp", "fused"])
def test_forward_loss_with_vision_embeds_matches_repro(
        subject, mode, repro_kernel_everywhere):
    """The loss with the vision prefix matches, and the prefix moves it
    (the splice is not a no-op)."""
    rcfg, tcfg, params = subject
    rp, tp = params[mode]
    toks, ve = _inputs(1)
    tgts = np.roll(toks, -1, axis=1)
    tgts[:, :FT] = -1
    lr = RM.forward_loss(rcfg, PAR, rp, {
        "tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts),
        "vision_embeds": jnp.asarray(ve)})
    batch = {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(tgts)}
    lt = TM.forward_loss(tcfg, tp, dict(batch,
                                        vision_embeds=torch.from_numpy(ve)),
                         attn_chunk=PAR.attn_chunk)
    assert torch.isfinite(lt)
    assert abs(float(lt) - float(lr)) <= ATOL[mode]
    text = TM.forward_loss(tcfg, tp, batch, attn_chunk=PAR.attn_chunk)
    assert abs(float(text) - float(lt)) > 10 * ATOL[mode]


@pytest.mark.parametrize("mode", ["fp", "fused"])
def test_prefill_with_vision_embeds_then_decode_matches_repro(
        subject, mode, repro_kernel_everywhere):
    """Prefill of 8 vision positions and 16 text tokens: last-token
    logits and the ring cache; then 4 decode steps over it."""
    rcfg, tcfg, params = subject
    rp, tp = params[mode]
    toks, ve = _inputs(2)
    rl, rc = RM.prefill(rcfg, PAR, rp, {"tokens": jnp.asarray(toks[:, :S]),
                                        "vision_embeds": jnp.asarray(ve)},
                        MAX_SEQ)
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :S]),
                                   "vision_embeds": torch.from_numpy(ve)},
                        MAX_SEQ, attn_chunk=PAR.attn_chunk)
    _close(tl, rl, ATOL[mode])
    _close(tc[0][0]["k"], rc[0][0]["k"], ATOL[mode], "k")
    _close(tc[0][0]["v"], rc[0][0]["v"], ATOL[mode], "v")
    for pos in range(S, S + 4):
        tok, p = toks[:, pos], np.full((B,), pos, np.int32)
        rl, rc = RM.decode_step(rcfg, PAR, rp, jnp.asarray(tok),
                                jnp.asarray(p), rc, MAX_SEQ)
        tl, tc = TM.decode_step(tcfg, tp, torch.from_numpy(tok),
                                torch.from_numpy(p), tc, MAX_SEQ)
        _close(tl, rl, ATOL[mode], f"pos {pos}")


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


def test_datafree_fused_bytes_match_repro(subject):
    rcfg, tcfg, params = subject
    mine = tpipe.quantize_params_data_free(
        params["fp"][1], tql.QuantConfig(ratio=0.25, multiple=16),
        min_dim=32, fuse=True)
    a, b = _qlinears(mine), _qlinears(params["fused"][1])
    assert a.keys() == b.keys() and len(a) == 4
    for k in a:
        for f in ("perm", "w4", "bits"):
            assert torch.equal(getattr(a[k], f), getattr(b[k], f)), (k, f)
        for f in ("s4", "z4", "alpha_s", "alpha_r1", "alpha_r2"):
            torch.testing.assert_close(getattr(a[k], f), getattr(b[k], f),
                                       rtol=SUM_TOL, atol=0.0)


ENGINES = {"contiguous": dict(),
           "whole-paged": dict(paged=True, page_size=8),
           "chunked": dict(paged=True, page_size=8, chunked_prefill=True,
                           prefill_chunk=16)}


@pytest.mark.parametrize("backend", list(ENGINES))
def test_engine_tokens_match_repro(subject, backend, repro_kernel_everywhere):
    """Greedy tokens on the fused packed weights: 3 slots, 5 text
    prompts of 5-60 tokens at buckets 16 / 64, 8 new tokens each."""
    rcfg, tcfg, params = subject
    rp, tp = params["fused"]
    kw = ENGINES[backend]
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 512, size=n).astype(np.int32)
               for n in (5, 17, 31, 48, 60)]
    toks = []
    for eng in (REngine(rcfg, PAR, rp, cache_dtype=jnp.float32, n_slots=3,
                        max_seq=128, prefill_buckets=(16, 64), **kw),
                TEngine(tcfg, tp, cache_dtype=torch.float32, device="cpu",
                        attn_chunk=PAR.attn_chunk, n_slots=3, max_seq=128,
                        prefill_buckets=(16, 64), **kw)):
        reqs = [eng.submit(p, max_new=8) for p in prompts]
        eng.run()
        assert all(r.done for r in reqs)
        toks.append([r.out_tokens for r in reqs])
    assert toks[1] == toks[0]


def test_serve_llava_reduced_on_cpu():
    """``launch.serve --arch llava-next-34b`` serves text prompts on the
    contiguous whole-prompt engine and the paged chunked one."""
    common = ["--arch", ARCH, "--reduced", "--fused", "--requests", "3",
              "--slots", "2", "--max-seq", "64", "--max-new", "3",
              "--device", "cpu"]
    for extra, backend in ((["--paged", "--chunked-prefill",
                             "--prefill-chunk", "16"], "paged"),
                           ([], "contiguous")):
        out = serve.run(serve.parse_args(common + extra))
        assert out["all_done"] and out["cache_backend"] == backend
        assert 1.5 < out["bits_per_weight"] < 3.0
