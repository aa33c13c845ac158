"""Port parity of whole-prompt prefill, the contiguous ring-cache backend,
the splice of a whole-prompt prefill into pages, and the causal-LM loss.

The subject is tiny-lm reduced with two layers, in f32, with weights
built in ``repro`` and carried across by the bridge: dense, and
data-free quantized with fused QKV / gate+up.  Packed projections run
through ``repro``'s mixed_matmul kernel in interpret mode on every
shape (``repro_kernel_everywhere``, as in ``tests/test_torch_model.py``),
so both sides round matmul operands to bf16 the same way.

Tolerances: logits 2e-4 absolute for dense weights and 2e-3 for packed
ones (``tests/test_torch_model.py``: a tiny f32 difference can move one
activation across a bf16 rounding boundary); prefill K/V 1e-5; ring
positions, pool bytes and page ids exact; the loss 1e-5 relative.
Greedy tokens are compared in f32 params and f32 page pools; the
contiguous rings are bf16 on both sides, as the reference has them.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.configs.base import Stage as RStage  # noqa: E402
from repro.core.pipeline import quantize_params_data_free as r_qdf  # noqa: E402
from repro.core.qlinear import QuantConfig as RQC  # noqa: E402
from repro.kernels import autotune, ops as rops  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.common import Parallel  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.param import materialize  # noqa: E402
from repro.runtime.engine import Engine as REngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.configs.base import Stage as TStage  # noqa: E402
from repro_torch.core.qlinear import QLinear  # noqa: E402
from repro_torch.core.select import map_tree  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime.engine import Engine as TEngine  # noqa: E402
from repro_torch.runtime.events import TokenEvent  # noqa: E402

PAR = Parallel(tp=1, dp=1, remat=False, attn_chunk=32)
ATOL = {"fp": 2e-4, "fused": 2e-3}
N_LAYERS = 2


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
    r = dataclasses.replace(registry.get("tiny-lm").reduced(),
                            stages=(RStage(("dense",), N_LAYERS),))
    t = dataclasses.replace(t_registry.get("tiny-lm").reduced(),
                            stages=(TStage(("dense",), N_LAYERS),))
    return r, t


@pytest.fixture(scope="module")
def subject():
    """{mode: (repro params, port params)} over one f32 two-layer model."""
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


def _left_padded(seqs, b):
    """Left-pad each sequence to ``b`` as the engine does: tokens 0 and
    positions -1 on the padding."""
    toks = np.zeros((len(seqs), b), np.int32)
    pos = np.full((len(seqs), b), -1, np.int32)
    for i, s in enumerate(seqs):
        toks[i, b - len(s):] = s
        pos[i, b - len(s):] = np.arange(len(s))
    return toks, pos


# ---------------------------------------------------------------------------
# Model level
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["fp", "fused"])
@pytest.mark.parametrize("lens,b,max_seq", [
    ((5,), 16, 64),            # padded bucket, ring wider than the bucket
    ((16,), 16, 16),           # full bucket, ring exactly the bucket
    ((23, 9), 32, 32),         # two rows, ring = bucket = max_seq
    ((40,), 64, 128),          # bucket > attn_chunk: streamed attention
])
def test_prefill_logits_and_caches_match_repro(subject, mode, lens, b,
                                               max_seq,
                                               repro_kernel_everywhere):
    rcfg, tcfg, params = subject
    rp, tp = params[mode]
    toks, pos = _left_padded(_prompts(b + len(lens), lens), b)
    lr, cr = RM.prefill(rcfg, PAR, rp, {"tokens": jnp.asarray(toks),
                                        "positions": jnp.asarray(pos)},
                        max_seq)
    lt, ct = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                   "positions": torch.from_numpy(pos)},
                        max_seq, attn_chunk=PAR.attn_chunk)
    assert lt.shape == lr.shape
    np.testing.assert_allclose(lt.numpy(), np.asarray(lr), rtol=0,
                               atol=ATOL[mode])
    rc, tc = cr[0][0], ct[0][0]
    assert tc["k"].shape == (N_LAYERS, len(lens), max_seq, tcfg.n_kv_heads,
                             tcfg.head_dim_)
    np.testing.assert_array_equal(tc["p"].numpy(), np.asarray(rc["p"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(rc[name]),
                                   rtol=0, atol=1e-5 if mode == "fp"
                                   else ATOL[mode])


@pytest.mark.parametrize("mode", ["fp", "fused"])
def test_splice_then_decode_steps_match_repro(subject, mode,
                                              repro_kernel_everywhere):
    """A prompt prefilled and spliced into decode row 1 of 3-row rings
    (rows 0 and 2 never filled), then 4 decode steps of every row: the
    logits of every row and the rings agree (f32 rings on both sides)."""
    rcfg, tcfg, params = subject
    rp, tp = params[mode]
    max_seq, plen, steps = 32, 11, 4
    seq = _prompts(5, (plen + steps,))[0]
    toks, pos = _left_padded([seq[:plen]], 16)
    _, c1r = RM.prefill(rcfg, PAR, rp, {"tokens": jnp.asarray(toks),
                                        "positions": jnp.asarray(pos)},
                        max_seq)
    _, c1t = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                   "positions": torch.from_numpy(pos)},
                        max_seq, attn_chunk=PAR.attn_chunk)
    rc = jax.tree.map(lambda a: a.astype(jnp.float32)
                      if a.dtype == jnp.bfloat16 else a,
                      materialize(RM.init_caches(rcfg, PAR, 3, max_seq),
                                  jax.random.PRNGKey(0)))
    tc = TM.init_caches(tcfg, 3, max_seq, dtype=torch.float32)
    np.testing.assert_array_equal(tc[0][0]["p"].numpy(),
                                  np.asarray(rc[0][0]["p"]))
    rc = RM.splice_prefill(rcfg, rc, c1r, jnp.int32(1))
    tc = TM.splice_prefill(tcfg, tc, c1t, 1)
    for t in range(plen, plen + steps):
        tok = np.array([0, seq[t - 1], 7], np.int32)
        p = np.array([t - plen, t, 3], np.int32)
        lr, rc = RM.decode_step(rcfg, PAR, rp, jnp.asarray(tok),
                                jnp.asarray(p), rc, max_seq)
        lt, tc = TM.decode_step(tcfg, tp, torch.from_numpy(tok),
                                torch.from_numpy(p), tc, max_seq)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lr), rtol=0,
                                   atol=ATOL[mode])
    np.testing.assert_array_equal(tc[0][0]["p"].numpy(),
                                  np.asarray(rc[0][0]["p"]))
    np.testing.assert_allclose(tc[0][0]["k"].numpy(),
                               np.asarray(rc[0][0]["k"]), rtol=0,
                               atol=ATOL[mode])


def test_ring_cache_orders_padding_stably_as_repro():
    """Slots sort by position % W; the padding (-1 -> W-1) keeps its
    order, so the bytes equal the reference's, truncation included."""
    rng = np.random.default_rng(3)
    for s, w in ((6, 10), (12, 8), (9, 9)):
        k = rng.normal(size=(2, s, 2, 4)).astype(np.float32)
        v = rng.normal(size=(2, s, 2, 4)).astype(np.float32)
        pos = np.stack([np.where(np.arange(s) >= s - n,
                                 np.arange(s) - (s - n), -1)
                        for n in (s, s // 2)]).astype(np.int32)
        r = RL.ring_cache_from_kv(jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(pos), w)
        t = TL.ring_cache_from_kv(torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(pos), w)
        for name in ("k", "v", "p"):
            np.testing.assert_array_equal(t[name].numpy(),
                                          np.asarray(r[name]))


def test_scatter_pages_bytes_match_repro():
    """Prefill K/V scattered into the pool: padding rows (-1) and rows of
    an unassigned block are dropped, the dump page is untouched, and the
    pool's bytes equal the reference's."""
    rng = np.random.default_rng(11)
    nl, pool_pages, ps, hkv, dh, s = 2, 9, 4, 2, 8, 24
    pool = rng.normal(size=(nl, pool_pages + 1, ps, hkv, dh)).astype(
        np.float32)
    k = rng.normal(size=(nl, s, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(nl, s, hkv, dh)).astype(np.float32)
    positions = np.where(np.arange(s) >= 5, np.arange(s) - 5, -1).astype(
        np.int32)                                # 5 padding rows, 19 live
    bt = np.array([6, 2, -1, 0, 8, 3, -1, -1], np.int32)   # block 2 unset
    r = RL.scatter_pages({"k": jnp.asarray(pool), "v": jnp.asarray(pool)},
                         jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(positions), jnp.asarray(bt))
    tp = {"k": torch.from_numpy(pool.copy()), "v": torch.from_numpy(
        pool.copy())}
    out = TL.scatter_pages(tp, torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(positions), torch.from_numpy(bt))
    assert out is tp
    for name in ("k", "v"):
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(r[name]))
        np.testing.assert_array_equal(tp[name].numpy()[:, pool_pages],
                                      pool[:, pool_pages])
        np.testing.assert_array_equal(tp[name].numpy()[:, [1, 4, 5, 7]],
                                      pool[:, [1, 4, 5, 7]])
    # positions 8..11 sit in the unassigned block: none of them landed
    assert not np.isin(k[:, 13:17], tp["k"].numpy()).any()


@pytest.mark.parametrize("mode", ["fp", "fused"])
def test_forward_loss_matches_repro(subject, mode, repro_kernel_everywhere):
    rcfg, tcfg, params = subject
    rp, tp = params[mode]
    rng = np.random.default_rng(17)
    toks = rng.integers(1, rcfg.vocab, size=(2, 32)).astype(np.int32)
    tgts = rng.integers(0, rcfg.vocab, size=(2, 32)).astype(np.int32)
    tgts[0, :5] = -1                              # masked targets
    lr = RM.forward_loss(rcfg, PAR, rp, {"tokens": jnp.asarray(toks),
                                         "targets": jnp.asarray(tgts)})
    lt = TM.forward_loss(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                    "targets": torch.from_numpy(tgts)},
                         attn_chunk=PAR.attn_chunk)
    assert lt.dim() == 0 and torch.isfinite(lt)
    np.testing.assert_allclose(float(lt), float(lr), rtol=1e-5)


def _leaves(tree):
    """{path: tensor or int} over a parameter tree, QLinear fields
    spelled out."""
    out = {}

    def visit(path, leaf):
        if isinstance(leaf, QLinear):
            for f in dataclasses.fields(leaf):
                out[path + (f.name,)] = getattr(leaf, f.name)
        else:
            out[path] = leaf
        return leaf
    map_tree(tree, visit)
    return out


@pytest.mark.parametrize("mode", ["fp", "fused"])
def test_unfused_oracle_matches_repro_and_the_fused_loss(
        subject, mode, repro_kernel_everywhere):
    """``unfuse_params_for_oracle`` gives the reference's unfused views
    leaf for leaf, exactly, and the same loss as the fused parameters it
    views (rtol 1e-6: one matmul over the fused width against one per
    member)."""
    rcfg, tcfg, params = subject
    rp, tp = params[mode]
    if mode == "fp":
        rp, tp = RT.fuse_params_for_decode(rp), TT.fuse_params_for_decode(tp)
    want = _leaves(bridge.params_from_repro(jax.tree.map(
        np.asarray, RT.unfuse_params_for_oracle(rp))))
    oracle = TT.unfuse_params_for_oracle(tp)
    got = _leaves(oracle)
    assert got.keys() == want.keys()
    assert any("wq" in path for path in got)
    assert not any("wqkv" in path or "wgu" in path for path in got)
    for path, v in got.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, want[path]), path
        else:
            assert v == want[path], path
    rng = np.random.default_rng(23)
    batch = {"tokens": torch.from_numpy(
                 rng.integers(1, rcfg.vocab, size=(2, 32)).astype(np.int32)),
             "targets": torch.from_numpy(
                 rng.integers(0, rcfg.vocab, size=(2, 32)).astype(np.int32))}
    lf = TM.forward_loss(tcfg, tp, batch, attn_chunk=PAR.attn_chunk)
    lu = TM.forward_loss(tcfg, oracle, batch, attn_chunk=PAR.attn_chunk)
    assert torch.isfinite(lf)
    np.testing.assert_allclose(float(lu), float(lf), rtol=1e-6)


@pytest.mark.parametrize("chunk", [8, 16, 48])
def test_softmax_xent_chunked_matches_repro_over_chunks(subject, chunk):
    """Chunks of 8 and 16 positions tile 48; 48 is one chunk.  All three
    give the reference's loss, and the gradient to x flows through the
    recomputed chunks."""
    rcfg, tcfg, params = subject
    rp, tp = params["fp"]
    rng = np.random.default_rng(chunk)
    x = rng.normal(size=(2, 48, rcfg.d_model)).astype(np.float32)
    tgts = rng.integers(-1, rcfg.vocab, size=(2, 48)).astype(np.int32)
    lr = RM.softmax_xent_chunked(rcfg, rp, jnp.asarray(x),
                                 jnp.asarray(tgts), chunk=chunk)
    xt = torch.from_numpy(x).requires_grad_(True)
    lt = TM.softmax_xent_chunked(tcfg, tp, xt, torch.from_numpy(tgts),
                                 chunk=chunk)
    np.testing.assert_allclose(lt.item(), float(lr), rtol=1e-5)
    lt.backward()
    gr = jax.grad(lambda a: RM.softmax_xent_chunked(
        rcfg, rp, a, jnp.asarray(tgts), chunk=chunk))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gr), rtol=1e-4,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Engine level
# ---------------------------------------------------------------------------
def _serve(eng, prompts, max_new):
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.run()
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs], [r.preemptions for r in reqs]


def _engines(subject, mode, paged, **kw):
    rcfg, tcfg, params = subject
    rp, tp = params[mode]
    if paged:
        kw = dict(kw, paged=True)
    re = REngine(rcfg, PAR, rp, cache_dtype=jnp.float32, **kw)
    te = TEngine(tcfg, tp, cache_dtype=torch.float32, device="cpu",
                 attn_chunk=PAR.attn_chunk, **kw)
    return re, te


@pytest.mark.parametrize("mode", ["fp", "fused"])
@pytest.mark.parametrize("paged", [False, True])
def test_whole_prompt_engine_greedy_tokens_match_repro(
        subject, mode, paged, repro_kernel_everywhere):
    re, te = _engines(subject, mode, paged, n_slots=3, max_seq=128,
                      prefill_buckets=(16, 64), page_size=8)
    prompts = _prompts(9, (5, 17, 31, 48, 64, 70))   # 70: cut to 64
    r, t = (_serve(e, prompts, max_new=8) for e in (re, te))
    assert t == r
    assert te.backend.name == ("paged" if paged else "contiguous")
    snap = te.metrics.snapshot()
    assert "prefill" in snap["phase_step_s"]
    assert "prefill_chunk" not in snap["phase_step_s"]
    assert {k for ph, k in te._warm_shapes if ph == "prefill"} == {16, 64}


def test_paged_whole_prompt_preemption_resumes_through_the_top_bucket(
        subject, repro_kernel_everywhere):
    """A pool of 10 pages of 8 cannot hold three growing requests: the
    scheduler preempts, and a resume whose context (prompt plus tokens
    generated) outgrows the top bucket, 32, prefills at max_seq = 64.
    Greedy tokens equal repro's through it all."""
    re, te = _engines(subject, "fused", True, n_slots=3, max_seq=64,
                      prefill_buckets=(16, 32), page_size=8, pool_pages=10)
    prompts = _prompts(21, (31, 30, 29, 28))
    r, t = (_serve(e, prompts, max_new=24) for e in (re, te))
    assert sum(t[1]) > 0, "the pool must be tight enough to preempt"
    assert t == r
    assert ("prefill", 64) in te._warm_shapes
    assert te.backend.pool.pages_in_use == 0


def test_contiguous_slot_reuse_never_attends_a_stale_ring(subject):
    """Four requests through one slot: each new occupant's splice
    rewrites the whole ring row (every position past its prompt back to
    -1, though longer requests held them before), and its tokens equal
    those it gets alone on a fresh engine."""
    _, tcfg, params = subject
    _, tp = params["fp"]
    prompts = _prompts(4, (40, 30, 6, 9))
    kw = dict(n_slots=1, max_seq=64, prefill_buckets=(16, 64),
              device="cpu")
    eng = TEngine(tcfg, tp, **kw)
    rows = {}

    def on_event(ev):
        # the first token is sampled right after the splice
        if isinstance(ev, TokenEvent) and ev.index == 0:
            rows[ev.rid] = eng.backend.caches[0][0]["p"][:, 0].clone()

    eng.subscribe(on_event)
    together, _ = _serve(eng, prompts, max_new=12)
    for rid, plen in zip((3, 4), (6, 9)):
        want = torch.full_like(rows[rid], -1)
        want[:, :plen] = torch.arange(plen, dtype=want.dtype)
        assert torch.equal(rows[rid], want)
    alone = [_serve(TEngine(tcfg, tp, **kw), [p], max_new=12)[0][0]
             for p in prompts]
    assert together == alone


@pytest.mark.parametrize("mode", ["fp", "fused"])
def test_whole_and_chunked_prefill_give_the_same_tokens(subject, mode):
    """Mirrors ``tests/test_chunked_prefill.py``'s whole-vs-chunked
    engine test in the port: f32 pools, ragged prompts."""
    _, tcfg, params = subject
    _, tp = params[mode]
    prompts = _prompts(9, (5, 17, 31, 48, 64, 97))

    def run(**kw):
        eng = TEngine(tcfg, tp, n_slots=3, max_seq=128,
                      prefill_buckets=(16, 64, 128), paged=True,
                      page_size=8, cache_dtype=torch.float32, device="cpu",
                      **kw)
        return _serve(eng, prompts, max_new=8)[0], eng

    whole, _ = run()
    chunked, eng = run(chunked_prefill=True, prefill_chunk=32)
    assert whole == chunked
    snap = eng.metrics.snapshot()
    assert snap["prefill_chunks"] > 0
    assert "prefill" not in snap["phase_step_s"]
