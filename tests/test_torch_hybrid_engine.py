"""Port parity of serving the hybrid block kinds (``rglru`` and windowed
``local``): greedy tokens of the contiguous and paged whole-prompt
engines (across a preemption, past the window, with prefix sharing),
the refusal of chunked prefill, the whole-prompt prefill's left padding
running through the recurrence, and ``launch.serve``, against
``repro`` on recurrentgemma-2b reduced (d 64, rnn width 64, 4 query
heads and 1 KV head of 16, window 32, 4 layers) in f32, weights built in
``repro`` (data-free quantized, QKV and gate+up fused; dense for the
preemption test) and carried across by the bridge.  Packed projections run through ``repro``'s
mixed_matmul kernel in interpret mode on every shape
(``repro_kernel_everywhere``).

Tolerances: greedy tokens and every engine counter identical (f32
params and page pools; the contiguous rings are bf16 on both sides, and
recurrent state keeps the reference's dtypes: ``h`` f32, the conv window
bf16 until the contiguous decode's first step); the logits of one
prefill 1e-5 relative to the reference's largest magnitude.
"""
import dataclasses

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
from repro.models import transformer as RT  # noqa: E402
from repro.models.common import Parallel  # noqa: E402
from repro.runtime.engine import Engine as REngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime.engine import Engine as TEngine  # noqa: E402

ARCH = "recurrentgemma-2b"
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
    """Serve ``prompts`` on both engines built alike, on the fused packed
    weights (or the dense ones); returns the greedy tokens, the
    preemptions per request and the engines."""
    rcfg, tcfg, rp, tp, fp = subject
    if dense:
        rp, tp = fp
    re = REngine(rcfg, PAR, rp, cache_dtype=jnp.float32, **kw)
    te = TEngine(tcfg, tp, cache_dtype=torch.float32, device="cpu",
                 attn_chunk=PAR.attn_chunk, **kw)
    outs = []
    for eng in (re, te):
        reqs = [eng.submit(p, max_new=max_new) for p in prompts]
        eng.run()
        assert all(r.done for r in reqs)
        outs.append(([r.out_tokens for r in reqs],
                     [r.preemptions for r in reqs]))
    return outs, re, te


BACKENDS = {"contiguous": dict(), "paged": dict(paged=True, page_size=8)}


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_engine_greedy_tokens_match_repro(subject, backend,
                                          repro_kernel_everywhere):
    """3 slots, 5 prompts of 5-60 tokens (three past the window of 32),
    left-padded to buckets 16 / 64; empty decode rows step their state
    too and are rewritten whole by the next splice."""
    prompts = _prompts(9, (5, 17, 31, 48, 60))
    (r, t), re, te = _run_both(subject, prompts, max_new=8, n_slots=3,
                               max_seq=128, prefill_buckets=(16, 64),
                               **BACKENDS[backend])
    assert t[0] == r[0]
    assert te.backend.name == backend
    assert te.metrics.snapshot()["completed"] == 5


def test_paged_preemption_matches_repro(subject):
    """A pool of 12 pages of 8 cannot hold three growing requests: the
    scheduler preempts, the resumed request prefills its whole context
    again (rebuilding its recurrent state) and continues with the same
    greedy tokens as repro's engine.  On the dense f32 weights: on the
    packed ones the two sides' logits differ by up to 3e-3 (operands
    and outputs rounded to bf16 where f32 sums straddle a rounding
    boundary, as ``tests/test_torch_whole_prompt.py`` allows 2e-3), and
    this workload's resumed request meets a top-2 gap of 1.6e-3."""
    prompts = _prompts(21, (30, 25, 20, 12))
    (r, t), _, _ = _run_both(subject, prompts, max_new=20, dense=True,
                             n_slots=3, max_seq=128, prefill_buckets=(16, 64),
                             paged=True, page_size=8, pool_pages=12)
    assert sum(r[1]) > 0, "the pool must be tight enough to preempt"
    assert t == r


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_contexts_past_the_window_match_repro(subject, backend,
                                              repro_kernel_everywhere):
    """As ``tests/test_paged_serving.py`` drives the reference: contexts
    grow to 44 tokens against the local window of 32, so the window
    cuts keys off (and the paged walk skips pages below it) while the
    recurrent blocks carry their state; 37 tokens truncate to the
    32-token bucket."""
    prompts = _prompts(0, (30, 11, 37))
    (r, t), _, te = _run_both(subject, prompts, max_new=12, n_slots=2,
                              max_seq=64, prefill_buckets=(16, 32),
                              **BACKENDS[backend])
    assert t[0] == r[0]
    assert max(len(p) for p in prompts[:2]) + 12 > te.cfg.local_window


def test_prefix_sharing_on_a_hybrid_matches_repro(subject,
                                                  repro_kernel_everywhere):
    """Whole-prompt prefill with prefix sharing: every request still
    prefills its whole prompt (the recurrent state needs it); the
    attention pages of the common prefix are attached instead of
    written.  Tokens and every prefix counter as in the reference."""
    common = _prompts(3, (32,))[0]
    prompts = [np.concatenate([common, x]) for x in _prompts(4, (5, 9, 14))]
    (r, t), re, te = _run_both(subject, prompts, max_new=6, n_slots=2,
                               max_seq=128, prefill_buckets=(64, 96),
                               paged=True, page_size=8, prefix_sharing=True)
    assert t[0] == r[0]
    assert te.prefix_stats() == re.prefix_stats()
    assert te.prefix_stats()["hits"] > 0


def test_chunked_prefill_and_unported_kinds_are_refused(subject):
    """Chunked prefill on a hybrid raises the reference's ValueError,
    word for word; so it does on xlstm, whose mlstm / slstm kinds are
    ported: without chunked prefill its engine builds on both
    backends."""
    rcfg, tcfg, rp, tp, _ = subject
    kw = dict(paged=True, chunked_prefill=True, page_size=8,
              prefill_chunk=16)
    with pytest.raises(ValueError) as want:
        REngine(rcfg, PAR, rp, **kw)
    with pytest.raises(ValueError) as got:
        TEngine(tcfg, tp, device="cpu", **kw)
    assert str(got.value) == str(want.value)
    assert "recurrent cells carry sequential state" in str(got.value)
    xl_r = registry.get("xlstm-1.3b").reduced()
    xl = t_registry.get("xlstm-1.3b").reduced()
    xl_p = TM.init_params(xl, 0)
    with pytest.raises(ValueError) as want:
        REngine(xl_r, PAR, None, **kw)
    with pytest.raises(ValueError) as got:
        TEngine(xl, xl_p, device="cpu", **kw)
    assert str(got.value) == str(want.value)
    for extra in (dict(), dict(paged=True)):
        assert TEngine(xl, xl_p, device="cpu", **extra).cfg is xl


def test_prefill_bucket_moves_the_state_as_in_repro(subject,
                                                    repro_kernel_everywhere):
    """Whole-prompt prefill left-pads with token 0 at position -1;
    attention masks the padding, but the conv and the RG-LRU run over
    it, so the same 3-token prompt prefilled at buckets 16 and 32 leaves
    other state and other next-token logits, in the reference as in the
    port (a fault of the reference, kept for parity: ROADMAP queue 3).
    At each bucket the port matches the reference."""
    rcfg, tcfg, rp, tp, _ = subject
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
                            64, attn_chunk=PAR.attn_chunk)
        lr = np.asarray(lr)
        gap = np.abs(lt.numpy() - lr).max() / np.abs(lr).max()
        assert gap <= REL, (b, gap)
        out[b] = {"repro": (lr, np.asarray(cr[0][0]["h"])),
                  "port": (lt.numpy(), ct[0][0]["h"].numpy())}
    moved = {side: [np.abs(out[16][side][i] - out[32][side][i]).max()
                    / np.abs(out[32][side][i]).max() for i in (0, 1)]
             for side in ("repro", "port")}
    print("bucket 16 against 32, relative max gap of the logits and of "
          "layer 0's state:", moved)
    assert min(moved["repro"]) > 1e-3 and min(moved["port"]) > 1e-3
    np.testing.assert_allclose(moved["port"], moved["repro"], rtol=1e-3)


def test_serve_recurrentgemma_reduced_on_cpu():
    """``launch.serve --arch recurrentgemma-2b`` on both backends,
    data-free fused and calibrated; ``--chunked-prefill`` raises the
    reference's ValueError."""
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


def test_kind_windows_follow_the_reference():
    """``_kind_window`` and ``_cache_window``: local -> local_window
    (capped at max_seq for the ring), rglru none; dense and moe keep
    ``attn_window``."""
    rcfg = registry.get(ARCH)
    tcfg = t_registry.get(ARCH)
    for kind in ("local", "rglru", "dense"):
        for max_seq in (512, 4096):
            assert TT._kind_window(tcfg, kind) == \
                RT._kind_window(rcfg, kind, max_seq)
            if kind != "rglru":
                assert TT._cache_window(tcfg, kind, max_seq) == \
                    RT._cache_window(rcfg, kind, max_seq)
    assert TT._cache_window(tcfg, "local", 4096) == 2048
    mix = dataclasses.replace(tcfg, attn_window=7)
    assert TT._kind_window(mix, "dense") == 7
    assert TT._kind_window(mix, "local") == 2048
