"""Port parity of serving the xLSTM block kinds (``mlstm``, ``slstm``):
greedy tokens of the contiguous and paged whole-prompt engines (with
the block tables and the pool's free pages after every tick, across a
preemption, with prefix sharing), the refusal of chunked prefill, the
paged walk's skip of a tick with no live row, the whole-prompt
prefill's left padding running through the cells, and
``launch.serve``, against ``repro`` on xlstm-1.3b reduced (d 64, 4
heads, layernorm, 7 × mlstm then slstm) in f32, weights built in
``repro`` (data-free quantized with ``fuse=True``, which leaves the
xLSTM projections unfused; dense where a workload meets a near-tie) and
carried across by the bridge.  Packed projections run through
``repro``'s mixed_matmul kernel in interpret mode on every shape
(``repro_kernel_everywhere``).

Near-ties on the packed weights: the packed product rounds its input to
bf16, and a carried state 1e-7 apart (the two sides' f32 sums) can
straddle a rounding boundary of w_out's input.  Spliced from the port's
own prefill, the first decode step of the 5-token prompt of the
greedy-token workload gives logits 1.2e-2 apart where the reference's
top two are 1.0e-2 apart (from the reference's spliced state the step
is bit-identical, block by block).  That workload, the preemption one
and the two state comparisons run on the dense f32 weights; the prefix-
sharing and serve workloads run on the packed ones.

An xLSTM model has no attention block, so its paged backend holds no
page pool on the device; its requests still take, grow, share and free
pages in the block tables, which must move exactly as the reference's.

Tolerances: greedy tokens, block tables, free pages and every engine
counter identical (f32 params; every recurrent state is f32 on both
sides); the logits of one prefill or decode step 1e-5 relative to the
reference's largest magnitude, each recurrent state entry 1e-5 of its
own largest magnitude.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.core.pipeline import quantize_params_data_free as r_qdf  # noqa: E402
from repro.core.qlinear import QuantConfig as RQC  # noqa: E402
from repro.kernels import autotune, ops as rops  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.common import Parallel  # noqa: E402
from repro.models.param import materialize  # noqa: E402
from repro.runtime.engine import Engine as REngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime.engine import Engine as TEngine  # noqa: E402

ARCH = "xlstm-1.3b"
PAR = Parallel(tp=1, dp=1, remat=False, attn_chunk=32)
REL = 1e-5


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
    rcfg = registry.get(ARCH).reduced()
    tcfg = t_registry.get(ARCH).reduced()
    p = RM.init_params(rcfg, PAR, jax.random.PRNGKey(0))
    p = jax.tree.map(lambda a: a.astype(jnp.float32)
                     if a.dtype == jnp.bfloat16 else a, p)
    qp = r_qdf(p, RQC(ratio=0.25, multiple=16, use_kernel=True), min_dim=32,
               fuse=True)
    dense = (p, bridge.params_from_repro(jax.tree.map(np.asarray, p)))
    return (rcfg, tcfg, qp,
            bridge.params_from_repro(jax.tree.map(np.asarray, qp)), dense)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, size=int(n)).astype(np.int32) for n in lens]


def _run_both(subject, prompts, max_new, dense=False, **kw):
    """Serve ``prompts`` on both engines built alike, on the packed
    weights (or the dense ones), tick by tick; returns the greedy tokens,
    the preemptions per request, what a paged backend's tables and pool
    hold after every tick, and the engines."""
    rcfg, tcfg, rp, tp, fp = subject
    if dense:
        rp, tp = fp
    re = REngine(rcfg, PAR, rp, cache_dtype=jnp.float32, **kw)
    te = TEngine(tcfg, tp, cache_dtype=torch.float32, device="cpu", **kw)
    outs = []
    for eng in (re, te):
        reqs = [eng.submit(p, max_new=max_new) for p in prompts]
        trace = []
        while eng.tick():
            if kw.get("paged"):
                be = eng.backend
                trace.append((be.tables.as_array().tolist(),
                              be.pool.free_pages))
        assert all(r.done for r in reqs)
        outs.append(([r.out_tokens for r in reqs],
                     [r.preemptions for r in reqs], trace))
    return outs, re, te


BACKENDS = {"contiguous": dict(), "paged": dict(paged=True, page_size=8)}


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_engine_greedy_tokens_match_repro(subject, backend):
    """3 slots, 5 prompts of 5-60 tokens left-padded to buckets 16 / 64,
    on the dense f32 weights (the near-tie above); empty decode rows
    step their state too and are rewritten whole by the next splice.
    Paged: the block tables and the free pages after every tick are the
    reference's."""
    prompts = _prompts(9, (5, 17, 31, 48, 60))
    (r, t), re, te = _run_both(subject, prompts, max_new=8, dense=True,
                               n_slots=3, max_seq=128,
                               prefill_buckets=(16, 64), **BACKENDS[backend])
    assert t == r
    assert te.backend.name == backend
    assert te.metrics.snapshot()["completed"] == 5
    if backend == "paged":
        assert len(t[2]) > 5 and any(row >= 0 for bt, _ in t[2]
                                     for rows in bt for row in rows)
        assert all("k" not in c for cs in te.backend.caches for c in cs)


def test_paged_preemption_matches_repro(subject):
    """A pool of 12 pages of 8 cannot hold three growing requests: the
    scheduler preempts, the resumed request prefills its whole context
    again (rebuilding its mLSTM and sLSTM state) and continues with the
    same greedy tokens, block tables and free pages as repro's engine
    (dense f32 weights)."""
    prompts = _prompts(21, (30, 25, 20, 12))
    (r, t), _, _ = _run_both(subject, prompts, max_new=20, dense=True,
                             n_slots=3,
                             max_seq=128, prefill_buckets=(16, 64),
                             paged=True, page_size=8, pool_pages=12)
    assert sum(r[1]) > 0, "the pool must be tight enough to preempt"
    assert t == r


def test_prefix_sharing_on_xlstm_matches_repro(subject,
                                               repro_kernel_everywhere):
    """Whole-prompt prefill with prefix sharing: every request still
    prefills its whole prompt (the cells need it); the pages of the
    common prefix are attached in the tables instead of allocated.
    Tokens, tables and every prefix counter as in the reference."""
    common = _prompts(3, (32,))[0]
    prompts = [np.concatenate([common, x]) for x in _prompts(4, (5, 9, 14))]
    (r, t), re, te = _run_both(subject, prompts, max_new=6, n_slots=2,
                               max_seq=128, prefill_buckets=(64, 96),
                               paged=True, page_size=8, prefix_sharing=True)
    assert t == r
    assert te.prefix_stats() == re.prefix_stats()
    assert te.prefix_stats()["hits"] > 0


def test_chunked_prefill_is_refused_as_in_repro(subject):
    """Chunked prefill on xLSTM raises the reference's ValueError, word
    for word; without it both backends build."""
    rcfg, tcfg, rp, tp, _ = subject
    kw = dict(paged=True, chunked_prefill=True, page_size=8,
              prefill_chunk=16)
    with pytest.raises(ValueError) as want:
        REngine(rcfg, PAR, rp, **kw)
    with pytest.raises(ValueError) as got:
        TEngine(tcfg, tp, device="cpu", **kw)
    assert str(got.value) == str(want.value)
    assert "['mlstm', 'slstm']" in str(got.value)
    for extra in (dict(), dict(paged=True)):
        assert TEngine(tcfg, tp, device="cpu", **extra).cfg is tcfg


def _random_state(rng, name, shape):
    """A state entry of a plausible range: normalizers positive."""
    if name == "n":
        return rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
    return (0.5 * rng.normal(size=shape)).astype(np.float32)


def test_paged_walk_skips_a_tick_with_no_live_row_as_repro(subject):
    """``decode_step_paged`` with every block-table row -1: the
    reference's ``lax.cond`` skips the layer walk, so the state passes
    through untouched and the logits are the head of the embedding; the
    port's walk does the same.  With one live row, every slot's state
    moves on both sides (dense f32 weights, random states)."""
    rcfg, tcfg, _, _, (rp, tp) = subject
    ps, n = 8, 2
    rng = np.random.default_rng(11)
    rc = materialize(RM.init_paged_caches(rcfg, PAR, n, 16, ps,
                                          dtype=jnp.float32),
                     jax.random.PRNGKey(0))
    rc = tuple(tuple({k: jnp.asarray(_random_state(rng, k, v.shape))
                      for k, v in c.items()} for c in cs) for cs in rc)
    tc = TM.init_paged_caches(tcfg, 16, ps, dtype=torch.float32, n_slots=n)
    for cs_t, cs_r in zip(tc, rc):
        for c_t, c_r in zip(cs_t, cs_r):
            for k in c_t:
                c_t[k].copy_(bridge.to_tensor(np.asarray(c_r[k])))
    before = [[{k: v.clone() for k, v in c.items()} for c in cs] for cs in tc]
    tok = np.asarray([3, 4], np.int32)
    pos = np.asarray([5, 9], np.int32)
    for live in (False, True):
        bt = np.full((n, 16), -1, np.int32)
        lens = np.zeros((n,), np.int32)
        if live:
            bt[1, :2], lens[1] = (0, 1), 10
        lr, rc = RM.decode_step_paged(
            rcfg, PAR, rp, jnp.asarray(tok), jnp.asarray(pos), rc,
            jnp.asarray(bt), jnp.asarray(lens), 128, use_kernel=False)
        lt, tc = TM.decode_step_paged(
            tcfg, tp, torch.from_numpy(tok), torch.from_numpy(pos), tc,
            torch.from_numpy(bt), torch.from_numpy(lens))
        lr = np.asarray(lr)
        assert np.abs(lt.numpy() - lr).max() / np.abs(lr).max() <= REL
        moved = [not torch.equal(v, before[si][pi][k])
                 for si, cs in enumerate(tc) for pi, c in enumerate(cs)
                 for k, v in c.items()]
        assert (all(moved) if live else not any(moved)), live
        for cs_t, cs_r in zip(tc, rc):
            for c_t, c_r in zip(cs_t, cs_r):
                for k in c_t:
                    want = np.asarray(c_r[k])
                    gap = np.abs(c_t[k].numpy() - want).max()
                    assert gap <= REL * np.abs(want).max(), (k, gap)


def test_prefill_bucket_moves_the_state_as_in_repro(subject):
    """Whole-prompt prefill left-pads with token 0 at position -1, and
    the mLSTM and sLSTM run over the padding as the RG-LRU does, so the
    same 3-token prompt prefilled at buckets 16 and 32 leaves other
    state and other next-token logits, in the reference as in the port
    (a fault of the reference, kept for parity: ROADMAP queue 3).  At
    each bucket the port matches the reference (dense f32 weights)."""
    rcfg, tcfg, _, _, (rp, tp) = subject
    seq = _prompts(7, (3,))[0]
    out = {}
    for b in (16, 32):
        toks = np.zeros((1, b), np.int32)
        toks[0, b - len(seq):] = seq
        pos = np.where(np.arange(b) >= b - len(seq),
                       np.arange(b) - (b - len(seq)), -1)[None].astype(
                           np.int32)
        lr, cr = RM.prefill(rcfg, PAR, rp, {"tokens": jnp.asarray(toks),
                                            "positions": jnp.asarray(pos)},
                            64)
        lt, ct = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                       "positions": torch.from_numpy(pos)},
                            64)
        lr = np.asarray(lr)
        gap = np.abs(lt.numpy() - lr).max() / np.abs(lr).max()
        assert gap <= REL, (b, gap)
        # layer 0's mLSTM memory and the sLSTM's cell state
        st_r = (np.asarray(cr[0][0]["c"]), np.asarray(cr[0][7]["c"]))
        st_t = (ct[0][0]["c"].numpy(), ct[0][7]["c"].numpy())
        for a, w in zip(st_t, st_r):
            assert np.abs(a - w).max() / np.abs(w).max() <= REL, b
        out[b] = {"repro": (lr,) + st_r, "port": (lt.numpy(),) + st_t}
    moved = {side: [np.abs(out[16][side][i] - out[32][side][i]).max()
                    / np.abs(out[32][side][i]).max() for i in range(3)]
             for side in ("repro", "port")}
    print("bucket 16 against 32, relative max gap of the logits, of layer "
          "0's mLSTM memory and of the sLSTM's cell state:", moved)
    # measured: 12.5%, 0.059% and 26.6%, far above the 1e-5 of parity
    assert min(moved["repro"]) > 1e-4 and min(moved["port"]) > 1e-4
    np.testing.assert_allclose(moved["port"], moved["repro"], rtol=1e-3)


def test_serve_xlstm_reduced_on_cpu():
    """``launch.serve --arch xlstm-1.3b`` on both backends, data-free
    fused and calibrated; ``--chunked-prefill`` raises the reference's
    ValueError."""
    common = ["--arch", ARCH, "--reduced", "--requests", "3", "--slots",
              "2", "--max-seq", "64", "--max-new", "3", "--device", "cpu"]
    for extra, backend in ((["--fused", "--paged"], "paged"),
                           (["--fused"], "contiguous"),
                           (["--quantize", "calibrated", "--opt-steps", "1",
                             "--calib-segments", "2", "--calib-seq", "32"],
                            "contiguous")):
        out = serve.run(serve.parse_args(common + extra))
        assert out["all_done"] and out["cache_backend"] == backend
        assert 1.5 < out["bits_per_weight"] < 3.0
    with pytest.raises(ValueError, match="attention-only stages"):
        serve.run(serve.parse_args(common + ["--paged", "--chunked-prefill",
                                             "--prefill-chunk", "16"]))
