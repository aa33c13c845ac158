"""Port parity of copy-on-write prefix sharing and prefix retention in
the engine (serve's ``--share-prefix`` / ``--prefix-retain`` are in
``tests/test_torch_prefix_serve.py``).

The subject is the one of ``tests/test_torch_engine.py``: tiny-lm
reduced in f32, data-free quantized with fused QKV / gate+up in
``repro`` and carried across by the bridge, with every ``repro`` packed
projection on its Pallas mixed_matmul (``repro_kernel_everywhere``).
Page pools are f32, so greedy tokens are compared exactly (ROADMAP
ground rules).  Each case runs the same prompts through ``repro``'s
engine and the port's and compares what the reference's tests assert
on: greedy tokens, every ``prefix_stats()`` counter, prefill chunk
calls and their modeled K/V bytes, skipped prefill tokens, preemptions
and peak pool pages — all exactly.
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
from repro.runtime import engine as r_engine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.runtime import engine as t_engine  # noqa: E402

PAR = Parallel(tp=1, dp=1, remat=False, attn_chunk=32)
VOCAB = 512


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
    cfg = registry.get("tiny-lm").reduced()
    p = RM.init_params(cfg, PAR, jax.random.PRNGKey(0))
    p = jax.tree.map(lambda a: a.astype(jnp.float32)
                     if a.dtype == jnp.bfloat16 else a, p)
    qp = r_qdf(p, RQC(ratio=0.25, multiple=16, use_kernel=True), min_dim=32,
               fuse=True)
    return cfg, qp, bridge.params_from_repro(jax.tree.map(np.asarray, qp))


def _engines(subject, **kw):
    """(repro engine, port engine) with the same settings, f32 pools."""
    cfg, rp, tp = subject
    re = r_engine.Engine(cfg, PAR, rp, cache_dtype=jnp.float32, **kw)
    te = t_engine.Engine(t_registry.get("tiny-lm").reduced(), tp,
                         cache_dtype=torch.float32, device="cpu",
                         attn_chunk=PAR.attn_chunk, **kw)
    return re, te


def _record(eng, reqs) -> dict:
    """What the parity compares, read off one engine."""
    be = eng.backend
    return {"tokens": [list(r.out_tokens) for r in reqs],
            "done": [r.done for r in reqs],
            "preemptions": [r.preemptions for r in reqs],
            "prefix_stats": eng.prefix_stats(),
            "chunk_calls": getattr(be, "prefill_chunk_calls", None),
            "kv_read_bytes": getattr(be, "prefill_kv_read_bytes", None),
            "skipped": eng.metrics.prefill_tokens_skipped,
            "peak_pages": be.pool.stats().peak_in_use,
            "pages_in_use": be.pool.pages_in_use}


def _both(subject, scenario, **kw):
    """Run ``scenario(engine) -> record`` on repro's engine and the
    port's; the two records must be equal.  Returns the port's."""
    re, te = _engines(subject, **kw)
    r, t = scenario(re), scenario(te)
    assert t == r
    return t


def _common_prefix_prompts(seed, common_len, tails):
    rng = np.random.default_rng(seed)
    common = rng.integers(1, VOCAB, size=common_len).astype(np.int32)
    return [np.concatenate([common, rng.integers(1, VOCAB, size=n)
                            .astype(np.int32)]) for n in tails]


MODES = {"chunked": dict(chunked_prefill=True, prefill_chunk=16),
         "whole": dict(prefill_buckets=(32, 64))}


@pytest.mark.parametrize("retain", [0, 6])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_prefix_sharing_matches_repro(subject, mode, retain,
                                      repro_kernel_everywhere):
    """Four prompts with a common 32-token (4-page) prefix, then a second
    wave with the same prefix after the first drained: tokens, every
    prefix counter, chunk calls, skipped tokens and peak pages equal
    repro's; with sharing off the port gives the same tokens."""
    prompts = _common_prefix_prompts(3, 32, (5, 11, 20, 3))
    wave2 = _common_prefix_prompts(3, 32, (9, 14))
    kw = dict(n_slots=3, max_seq=128, paged=True, page_size=8,
              **MODES[mode])

    def scenario(eng):
        reqs = [eng.submit(x, max_new=6) for x in prompts]
        eng.run()
        reqs += [eng.submit(x, max_new=6) for x in wave2]
        eng.run()
        return _record(eng, reqs)

    shared = _both(subject, scenario, prefix_sharing=True,
                   prefix_retain_pages=retain, **kw)
    assert all(shared["done"]) and shared["prefix_stats"]["hits"] > 0
    assert shared["prefix_stats"]["cow_copies"] == 0
    if mode == "chunked":
        assert shared["skipped"] > 0
    _, te = _engines(subject, **kw)
    assert te.prefix_stats() is None
    unshared = scenario(te)
    assert unshared["tokens"] == shared["tokens"]
    assert unshared["peak_pages"] > shared["peak_pages"]


# ---------------------------------------------------------------------------
# Mirrors of the reference's prefix tests (test_chunked_prefill.py,
# test_event_serving.py), each held to repro's counters
# ---------------------------------------------------------------------------
def test_fully_shared_chunks_skip_kernel_calls(subject,
                                               repro_kernel_everywhere):
    rng = np.random.default_rng(31)
    common = rng.integers(1, VOCAB, size=48).astype(np.int32)
    tail_a = rng.integers(1, VOCAB, size=6).astype(np.int32)
    tail_b = rng.integers(1, VOCAB, size=3).astype(np.int32)

    def scenario(eng):
        ra = eng.submit(np.concatenate([common, tail_a]), max_new=4)
        eng.run()
        calls_a = eng.backend.prefill_chunk_calls
        rb = eng.submit(np.concatenate([common, tail_b]), max_new=4)
        eng.run()
        return dict(_record(eng, [ra, rb]), calls_a=calls_a)

    t = _both(subject, scenario, n_slots=1, max_seq=128, paged=True,
              page_size=8, chunked_prefill=True, prefill_chunk=16,
              prefix_sharing=True, prefix_retain_pages=8)
    assert t["calls_a"] == 4 and t["chunk_calls"] - t["calls_a"] == 1
    assert t["skipped"] == 48
    assert t["prefix_stats"]["hits"] >= 1
    assert t["prefix_stats"]["cow_copies"] == 0


def test_cohort_catches_up_mid_prefill(subject, repro_kernel_everywhere):
    prompts = _common_prefix_prompts(33, 48, (5, 5, 5))
    kw = dict(n_slots=3, max_seq=128, paged=True, page_size=8,
              chunked_prefill=True, prefill_chunk=16)

    def scenario(eng):
        reqs = [eng.submit(p, max_new=5) for p in prompts]
        eng.run()
        return _record(eng, reqs)

    base = _both(subject, scenario, **kw)
    shared = _both(subject, scenario, prefix_sharing=True, **kw)
    assert base["tokens"] == shared["tokens"]
    assert shared["chunk_calls"] < base["chunk_calls"]
    assert shared["skipped"] > 0


def test_retention_survives_cohort_and_evicts_under_pressure(
        subject, repro_kernel_everywhere):
    rng = np.random.default_rng(41)
    common = rng.integers(1, VOCAB, size=32).astype(np.int32)
    first = np.concatenate([common, rng.integers(1, VOCAB, size=3)
                            .astype(np.int32)])
    second = np.concatenate([common, rng.integers(1, VOCAB, size=2)
                             .astype(np.int32)])
    big = [rng.integers(1, VOCAB, size=60).astype(np.int32)
           for _ in range(3)]

    def scenario(eng):
        steps = []
        r1 = eng.submit(first, max_new=4)
        eng.run()
        steps.append(_record(eng, [r1]))
        r2 = eng.submit(second, max_new=4)
        eng.run()
        steps.append(_record(eng, [r1, r2]))
        reqs = [eng.submit(p, max_new=4) for p in big]
        eng.run()
        steps.append(_record(eng, [r1, r2] + reqs))
        return steps

    s1, s2, s3 = _both(subject, scenario, n_slots=2, max_seq=64, paged=True,
                       page_size=8, pool_pages=16, chunked_prefill=True,
                       prefill_chunk=16, prefix_sharing=True,
                       prefix_retain_pages=4)
    assert s1["prefix_stats"]["retained"] == 4
    assert s1["pages_in_use"] == 4
    assert s2["prefix_stats"]["hits"] >= 1
    assert s2["chunk_calls"] - s1["chunk_calls"] == 1
    assert all(s3["done"]) and s3["prefix_stats"]["evictions"] > 0


def test_retention_admission_accounting_no_double_count(
        subject, repro_kernel_everywhere):
    """The shared-page hint discounts only matched pages a live request
    still holds; a head that matches retained pages but needs more than
    the pool can give waits instead of crashing admission."""
    rng = np.random.default_rng(55)
    common = rng.integers(1, VOCAB, size=16).astype(np.int32)
    b_prompt = rng.integers(1, VOCAB, size=13).astype(np.int32)
    c_prompt = np.concatenate([common, rng.integers(1, VOCAB, size=8)
                               .astype(np.int32)])

    def scenario(eng):
        a = eng.submit(common, max_new=2)
        eng.run()
        retained = eng.prefix_stats()["retained"]
        b = eng.submit(b_prompt, max_new=12)
        c = eng.submit(c_prompt, max_new=2)
        eng.run()
        return dict(_record(eng, [a, b, c]), retained_after_a=retained)

    t = _both(subject, scenario, n_slots=2, max_seq=64, paged=True,
              page_size=4, pool_pages=8, chunked_prefill=True,
              prefill_chunk=8, prefix_sharing=True, prefix_retain_pages=8)
    assert t["retained_after_a"] == 4 and all(t["done"])


def test_shared_prefix_survives_donor_finish(subject,
                                             repro_kernel_everywhere):
    prompts = _common_prefix_prompts(5, 16, (3, 4))

    def scenario(eng):
        short = eng.submit(prompts[0], max_new=2)     # donor finishes first
        long = eng.submit(prompts[1], max_new=20)
        eng.run()
        return _record(eng, [short, long])

    t = _both(subject, scenario, n_slots=2, max_seq=64,
              prefill_buckets=(16, 32), paged=True, page_size=8,
              prefix_sharing=True)
    assert all(t["done"]) and len(t["tokens"][1]) == 20
    assert t["prefix_stats"]["pages_attached"] == 2
    assert t["pages_in_use"] == 0


def test_shared_prefix_with_preemption_completes(subject,
                                                 repro_kernel_everywhere):
    prompts = _common_prefix_prompts(9, 16, (4, 5, 6))

    def scenario(eng):
        reqs = [eng.submit(p, max_new=16) for p in prompts]
        eng.run()
        return _record(eng, reqs)

    t = _both(subject, scenario, n_slots=2, max_seq=64,
              prefill_buckets=(16, 32), paged=True, page_size=8,
              prefix_sharing=True, pool_pages=7)
    assert all(t["done"]) and all(len(x) == 16 for x in t["tokens"])
    assert sum(t["preemptions"]) >= 1 and t["pages_in_use"] == 0

