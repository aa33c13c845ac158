"""Port parity at engine level, the serve entry point, and the import
boundary of the port.

Greedy token identity is checked in f32 (params and page pools), as
``tests/test_chunked_prefill.py`` does: on an untrained subject bf16
top-2 logit gaps sit at the rounding of the path.  Packed projections
run through ``repro``'s mixed_matmul kernel on every shape (see
``tests/test_torch_model.py``).
"""
import ast
from pathlib import Path

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
from repro.runtime.engine import Engine as REngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.runtime.engine import Engine as TEngine  # noqa: E402

PAR = Parallel(tp=1, dp=1, remat=False, attn_chunk=32)
ROOT = Path(__file__).resolve().parents[1]


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


def _run_both(subject, prompts, max_new, **kw):
    cfg, rp, tp = subject
    common = dict(n_slots=3, max_seq=128, page_size=8, prefill_chunk=16,
                  **kw)
    re = REngine(cfg, PAR, rp, paged=True, chunked_prefill=True,
                 cache_dtype=jnp.float32, **common)
    te = TEngine(t_registry.get("tiny-lm").reduced(), tp,
                 cache_dtype=torch.float32, device="cpu", **common)
    outs = []
    for eng in (re, te):
        reqs = [eng.submit(p, max_new=max_new) for p in prompts]
        eng.run()
        assert all(r.done for r in reqs)
        outs.append(([r.out_tokens for r in reqs],
                     [r.preemptions for r in reqs]))
    return outs, re, te


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, size=int(n)).astype(np.int32) for n in lens]


def test_engine_greedy_tokens_match_repro(subject, repro_kernel_everywhere):
    prompts = _prompts(9, (5, 17, 31, 48, 64))
    (r, t), re, te = _run_both(subject, prompts, max_new=8)
    assert t[0] == r[0]
    assert te.metrics.prefill_chunks == re.metrics.prefill_chunks > 0
    assert "prefill" not in te.metrics.snapshot()["phase_step_s"]


def test_engine_greedy_tokens_match_repro_across_preemption(
        subject, repro_kernel_everywhere):
    """A pool of 12 pages cannot hold three growing requests: the
    scheduler preempts, and the resumed requests continue with the same
    greedy tokens as repro's engine."""
    prompts = _prompts(21, (30, 25, 20, 12))
    (r, t), _, _ = _run_both(subject, prompts, max_new=20, pool_pages=12)
    assert sum(r[1]) > 0, "the pool must be tight enough to preempt"
    assert t == r


def test_engine_refuses_what_is_not_ported(subject):
    _, _, tp = subject
    cfg = t_registry.get("tiny-lm").reduced()
    for kw in (dict(paged=False), dict(chunked_prefill=False),
               dict(prefix_sharing=True)):
        with pytest.raises(NotImplementedError):
            TEngine(cfg, tp, device="cpu", **kw)


def test_engine_defaults_to_cuda_and_never_falls_back(subject):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    _, _, tp = subject
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(t_registry.get("tiny-lm").reduced(), tp)


def test_serve_device_defaults_to_cuda_and_raises_without_it():
    args = serve.parse_args(["--paged", "--chunked-prefill"])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run(args)


def test_serve_requires_paged_chunked_prefill():
    for argv in ([], ["--paged"], ["--chunked-prefill"]):
        with pytest.raises(SystemExit):
            serve.run(serve.parse_args(argv + ["--device", "cpu"]))


def test_serve_cpu_end_to_end(tmp_path):
    out = serve.run(serve.parse_args([
        "--arch", "llama-7b", "--reduced", "--quantize", "datafree",
        "--fused", "--paged", "--chunked-prefill", "--prefill-chunk", "16",
        "--page-size", "8", "--requests", "3", "--slots", "2",
        "--max-seq", "64", "--max-new", "4", "--device", "cpu",
        "--json-out", str(tmp_path / "o.json")]))
    assert out["all_done"] and out["generated_tokens"] == 12
    assert 1.4 < out["bits_per_weight"] < 2.5
    m = out["engine_metrics"]
    assert m["prefill_chunks"] > 0 and "decode" in m["phase_step_s"]
    assert (tmp_path / "o.json").exists()


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module


def test_port_imports_no_jax_and_no_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax", "optax"), \
                f"{f.relative_to(ROOT)} imports {mod}"


def test_cancel_frees_pages_and_emits_event(subject):
    _, _, tp = subject
    eng = TEngine(t_registry.get("tiny-lm").reduced(), tp, n_slots=1,
                  max_seq=64, page_size=8, prefill_chunk=16,
                  cache_dtype=torch.float32, device="cpu")
    seen = []
    eng.events.subscribe(seen.append)
    a = eng.submit(_prompts(3, (20,))[0], max_new=10)
    b = eng.submit(_prompts(4, (9,))[0], max_new=10)   # queued behind a
    eng.tick()
    assert eng.running()[0][1] is a
    assert eng.cancel(b.rid) and b.cancelled        # queued: leaves at once
    in_use = eng.backend.pool.pages_in_use
    assert in_use > 0
    assert eng.cancel(a.rid) and a.cancelled        # in flight: pages back
    assert eng.backend.pool.pages_in_use == 0 and not eng.running()
    fins = [e for e in seen if getattr(e, "reason", None) == "cancelled"]
    assert [e.rid for e in fins] == [b.rid, a.rid]
    assert fins[1].freed_pages == in_use
    assert not eng.cancel(a.rid)
