"""Port parity of the encoder-decoder model (seamless-m4t-medium reduced:
d 64, 2 encoder layers and 1 decoder layer with cross-attention,
layernorm, gated gelu; f32) against ``repro`` on the same weights (built
in ``repro``, carried across by the bridge), with frames and tokens made
by numpy from a seed:

  * ``encode``, ``forward_loss`` with frames, ``prefill`` (its logits,
    the self-attention ring and the cross K/V ``xk``/``xv``) and 4
    ``decode_step``s over those caches, on the dense and the data-free
    fused packed weights; the encoder attends 64 frames (key chunks of
    32) in the loss and 24 (one dense block) in prefill, so both
    branches of the cross-attention run;
  * the data-free fused bytes: the decoder's QKV and gate+up fused, the
    encoder's and the cross-attention's projections one by one;
  * ``quantize_model_baseline`` on the decoder alone, the encoder left as
    it was and each decoder block's cross-attention calibrated on the
    block's own stream, as the reference does;
  * what both refuse: calibrated PTQ1.61 (AssertionError), restorative
    LoRA on batches without frames (KeyError), the engine and serve
    (NotImplementedError; the reference's engine cannot serve the model
    either).

Packed projections run through ``repro``'s mixed_matmul kernel in
interpret mode on every shape (``repro_kernel_everywhere``).
Tolerances are ``tests/test_torch_model.py``'s: 2e-4 absolute on dense
f32 weights (summation order only), 2e-3 on packed weights (a tiny f32
gap can move an operand across a bf16 rounding boundary); the loss is
held to the same absolute bounds.  Packed bytes and ``perm`` exact.

The dense weights are held end to end.  The packed encoder is not: the
two libraries' f32 sums (layernorm, softmax) part by about 1e-7, and a
packed product that rounds its operands and its output to bf16 then
meets a rounding boundary somewhere in the encoder's 2 x 7 products in
most inputs.  Measured on this file's subject, 24 frames: the encoder
output parted by one bf16 ulp (3.2e-3 to 1.2e-2) in 7 of 9 seeds, and
the prefill logits by 1.4e-2.  So on packed weights the decoder's
prefill runs from the reference's encoder output, and each decode step
from the reference's caches of that step (``bridge.convert``);
from the same inputs a one-block near-tie still showed once in 100
comparisons (20 seeds, prefill and 4 steps).  The loss averages its
positions: on packed weights it parted by at most 9.3e-4 end to end
over 10 seeds of 64 frames.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.core import pipeline as rpipe  # noqa: E402
from repro.core import preprocess as rpre  # noqa: E402
from repro.core import qlinear as rql  # noqa: E402
from repro.core.baselines import driver as rdrv  # noqa: E402
from repro.kernels import autotune, ops as rops  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.common import Parallel  # noqa: E402
from repro.runtime.engine import Engine as REngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import preprocess as tpre  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
from repro_torch.core.baselines import driver as tdrv  # noqa: E402
from repro_torch.core.select import map_tree  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime.engine import Engine as TEngine  # noqa: E402

ARCH = "seamless-m4t-medium"
PAR = Parallel(tp=1, dp=1, remat=False, attn_chunk=32)
ATOL = {"fp": 2e-4, "fused": 2e-3}
SUM_TOL = 1e-6
B, S, MAX_SEQ = 2, 16, 32


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
    data-free PTQ1.61 with the decoder's QKV and gate+up fused."""
    rcfg = registry.get(ARCH).reduced()
    tcfg = t_registry.get(ARCH).reduced()
    assert rcfg.enc_dec and tcfg.enc_dec and tcfg.n_enc_layers == 2
    p = RM.init_params(rcfg, PAR, jax.random.PRNGKey(0))
    p = jax.tree.map(lambda a: a.astype(jnp.float32)
                     if a.dtype == jnp.bfloat16 else a, p)
    qp = rpipe.quantize_params_data_free(
        p, rql.QuantConfig(ratio=0.25, multiple=16, use_kernel=True),
        min_dim=32, fuse=True)
    return rcfg, tcfg, {
        mode: (rp, bridge.params_from_repro(jax.tree.map(np.asarray, rp)))
        for mode, rp in (("fp", p), ("fused", qp))}


def _inputs(seed: int, s_enc: int):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, 512, size=(B, S + 4)).astype(np.int32)
    frames = rng.normal(size=(B, s_enc, 64)).astype(np.float32)
    return toks, frames


def _close(t, r, atol, msg=""):
    np.testing.assert_allclose(np.asarray(t.detach().float()),
                               np.asarray(r, np.float32), rtol=0, atol=atol,
                               err_msg=msg)


def test_encode_matches_repro(subject):
    """The encoder on the dense weights (64 frames: key chunks of 32)."""
    rcfg, tcfg, params = subject
    rp, tp = params["fp"]
    _, frames = _inputs(1, 64)
    r_out, r_pos = RM.encode(rcfg, PAR, rp, jnp.asarray(frames))
    t_out, t_pos = TM.encode(tcfg, tp, torch.from_numpy(frames),
                             attn_chunk=PAR.attn_chunk)
    assert t_out.shape == (B, 64, 64)
    assert np.array_equal(t_pos.numpy(), np.asarray(r_pos))
    _close(t_out, r_out, ATOL["fp"])


@pytest.mark.parametrize("mode", ["fp", "fused"])
def test_forward_loss_with_frames_matches_repro(subject, mode,
                                                repro_kernel_everywhere):
    rcfg, tcfg, params = subject
    rp, tp = params[mode]
    toks, frames = _inputs(2, 64)
    tgts = np.roll(toks, -1, axis=1)
    tgts[0, :3] = -1
    lr = RM.forward_loss(rcfg, PAR, rp, {
        "tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts),
        "frames": jnp.asarray(frames)})
    lt = TM.forward_loss(tcfg, tp, {
        "tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tgts),
        "frames": torch.from_numpy(frames)}, attn_chunk=PAR.attn_chunk)
    assert torch.isfinite(lt)
    assert abs(float(lt) - float(lr)) <= ATOL[mode]


def _prefill_both(rcfg, tcfg, rp, tp, toks, frames, monkeypatch=None):
    """Both packages' ``prefill``; with ``monkeypatch``, the port's runs
    from the reference's encoder output (see the module docstring)."""
    rl, rc = RM.prefill(rcfg, PAR, rp, {"tokens": jnp.asarray(toks[:, :S]),
                                        "frames": jnp.asarray(frames)},
                        MAX_SEQ)
    if monkeypatch is not None:
        enc = [torch.from_numpy(np.array(a)) for a in
               RM.encode(rcfg, PAR, rp, jnp.asarray(frames))]
        monkeypatch.setattr(TM, "encode", lambda *a, **k: tuple(enc))
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :S]),
                                   "frames": torch.from_numpy(frames)},
                        MAX_SEQ, attn_chunk=PAR.attn_chunk)
    return rl, rc, tl, tc


@pytest.mark.parametrize("mode", ["fp", "fused"])
def test_prefill_logits_and_caches_match_repro(subject, mode,
                                               repro_kernel_everywhere,
                                               monkeypatch):
    """Last-token logits; the ring cache under "self" (k, v and its
    positions exact) and the cross K/V, every layer."""
    rcfg, tcfg, params = subject
    rp, tp = params[mode]
    toks, frames = _inputs(3, 24)
    rl, rc, tl, tc = _prefill_both(rcfg, tcfg, rp, tp, toks, frames,
                                   monkeypatch if mode == "fused" else None)
    assert tl.shape == (B, 1, tcfg.vocab_padded)
    _close(tl, rl, ATOL[mode])
    r, t = rc[0][0], tc[0][0]
    assert set(t) == {"self", "xk", "xv"} == set(r)
    assert t["xk"].shape == (1, B, 24, 2, 16)
    for name in ("xk", "xv"):
        _close(t[name], r[name], ATOL[mode], name)
    _close(t["self"]["k"], r["self"]["k"], ATOL[mode], "k")
    _close(t["self"]["v"], r["self"]["v"], ATOL[mode], "v")
    assert np.array_equal(t["self"]["p"].numpy(), np.asarray(r["self"]["p"]))


@pytest.mark.parametrize("mode", ["fp", "fused"])
def test_decode_steps_match_repro(subject, mode, repro_kernel_everywhere):
    """4 decode steps: on dense weights over each side's own prefill
    caches, on packed weights each step from the reference's caches of
    that step.  The self-attention ring grows (its new slot as the
    reference's), the cross K/V stay as cached."""
    rcfg, tcfg, params = subject
    rp, tp = params[mode]
    toks, frames = _inputs(4, 24)
    _, rc, _, tc = _prefill_both(rcfg, tcfg, rp, tp, toks, frames)
    for pos in range(S, S + 4):
        if mode == "fused":
            tc = bridge.convert(jax.tree.map(np.asarray, rc))
        xk0 = tc[0][0]["xk"].clone()
        tok, p = toks[:, pos], np.full((B,), pos, np.int32)
        rl, rc = RM.decode_step(rcfg, PAR, rp, jnp.asarray(tok),
                                jnp.asarray(p), rc, MAX_SEQ)
        tl, tc = TM.decode_step(tcfg, tp, torch.from_numpy(tok),
                                torch.from_numpy(p), tc, MAX_SEQ)
        _close(tl, rl, ATOL[mode], f"pos {pos}")
        assert torch.equal(tc[0][0]["xk"], xk0)
        _close(tc[0][0]["self"]["k"], rc[0][0]["self"]["k"], ATOL[mode])
        assert np.array_equal(tc[0][0]["self"]["p"].numpy(),
                              np.asarray(rc[0][0]["self"]["p"]))


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


def test_datafree_fused_bytes_and_logits_match_repro(subject,
                                                     repro_kernel_everywhere,
                                                     monkeypatch):
    """The port's data-free fused quantization of the bridged dense
    tree gives the reference's bytes: 2 fused groups in the decoder
    block, its cross-attention's 4 projections and the encoder's 7 a
    layer one by one; its prefill logits (from the reference's encoder
    output) are the reference's."""
    rcfg, tcfg, params = subject
    mine = tpipe.quantize_params_data_free(
        params["fp"][1], tql.QuantConfig(ratio=0.25, multiple=16),
        min_dim=32, fuse=True)
    a, b = _qlinears(mine), _qlinears(params["fused"][1])
    assert a.keys() == b.keys() and len(a) == 2 + 1 + 1 + 4 + 2 * 7
    assert ("stages", 0, 0, 0, "attn", "wqkv") in a
    assert ("stages", 0, 0, 0, "xattn", "wk") in a
    assert ("enc", "stages", 0, 1, 0, "mlp", "wg") in a
    for k in a:
        for f in ("perm", "w4", "bits"):
            assert torch.equal(getattr(a[k], f), getattr(b[k], f)), (k, f)
        for f in ("s4", "z4", "alpha_s", "alpha_r1", "alpha_r2"):
            torch.testing.assert_close(getattr(a[k], f), getattr(b[k], f),
                                       rtol=SUM_TOL, atol=0.0)
    toks, frames = _inputs(5, 24)
    rl, _, tl, _ = _prefill_both(rcfg, tcfg, params["fused"][0], mine, toks,
                                 frames, monkeypatch)
    _close(tl, rl, ATOL["fused"])


def _leaves(tree, top):
    out = {}
    map_tree(tree, lambda p, x: out.__setitem__(p, x)
             if p[0] == top and isinstance(x, torch.Tensor)
             and x.ndim == 2 else x)
    return out


@pytest.mark.parametrize("method", ["rtn-2", "awq-2"])
def test_baselines_quantize_the_decoder_alone_as_repro(subject, method):
    """``quantize_model_baseline`` fake-quantizes the decoder block's 11
    projections (cross-attention included, its AWQ rows taken from the
    block's own stream) and leaves the encoder as it was, in both
    packages: rtn leaves identical, awq's within 1e-6 of their largest
    magnitude; the loss with frames within the fp tolerance."""
    rcfg, tcfg, params = subject
    rp, tp = params["fp"]
    rng = np.random.default_rng(6)
    toks = [rng.integers(1, 512, size=(1, 32)).astype(np.int32)
            for _ in range(2)]
    rq = rdrv.quantize_model_baseline(
        rcfg, PAR, rp, [{"tokens": jnp.asarray(t)} for t in toks], method,
        min_dim=32)
    tq = tdrv.quantize_model_baseline(
        tcfg, tp, [{"tokens": torch.from_numpy(t)} for t in toks], method,
        min_dim=32, attn_chunk=PAR.attn_chunk)
    rq_t = bridge.params_from_repro(jax.tree.map(np.asarray, rq))
    a, b, fp = (_leaves(t, "stages") for t in (tq, rq_t, tp))
    assert a.keys() == b.keys() and len(a) == 11
    for k in a:
        assert not torch.equal(a[k], fp[k]), k
        gap = (a[k] - b[k]).abs().max() / b[k].abs().max()
        assert gap == 0 if method == "rtn-2" else gap <= SUM_TOL, k
    enc_t, enc_r, enc_fp = (_leaves(t["enc"], "stages")
                            for t in (tq, rq_t, tp))
    assert len(enc_fp) == 14
    for k in enc_fp:
        assert torch.equal(enc_t[k], enc_fp[k])
        assert torch.equal(enc_r[k], enc_fp[k])
    toks2, frames = _inputs(7, 24)
    tgts = np.roll(toks2, -1, axis=1)
    lr = RM.forward_loss(rcfg, PAR, rq, {
        "tokens": jnp.asarray(toks2), "targets": jnp.asarray(tgts),
        "frames": jnp.asarray(frames)})
    lt = TM.forward_loss(tcfg, tq, {
        "tokens": torch.from_numpy(toks2), "targets": torch.from_numpy(tgts),
        "frames": torch.from_numpy(frames)}, attn_chunk=PAR.attn_chunk)
    assert abs(float(lt) - float(lr)) <= ATOL["fp"]


def test_calibrated_and_preprocess_refuse_as_repro(subject):
    """Calibrated PTQ1.61 raises the reference's AssertionError on an
    encoder-decoder model; restorative LoRA on batches without frames
    raises the reference's KeyError at its first loss."""
    rcfg, tcfg, params = subject
    rp, tp = params["fp"]
    toks = np.ones((1, 16), np.int32)
    with pytest.raises(AssertionError) as r_err:
        rpipe.quantize_model_ptq161(rcfg, PAR, rp,
                                    [{"tokens": jnp.asarray(toks)}],
                                    rql.QuantConfig())
    with pytest.raises(AssertionError) as t_err:
        tpipe.quantize_model_ptq161(tcfg, tp,
                                    [{"tokens": torch.from_numpy(toks)}],
                                    tql.QuantConfig())
    assert str(t_err.value) == str(r_err.value)
    batch = {"tokens": toks, "targets": toks}
    with pytest.raises(KeyError, match="frames"):
        rpre.restorative_lora(rcfg, PAR, rp,
                              [{k: jnp.asarray(v) for k, v in batch.items()}],
                              rql.QuantConfig(ratio=0.25, multiple=16),
                              rpre.PreprocessConfig(rank=4, steps=1),
                              min_dim=32)
    with pytest.raises(KeyError, match="frames"):
        tpre.restorative_lora(tcfg, tp,
                              [{k: torch.from_numpy(v)
                                for k, v in batch.items()}],
                              tql.QuantConfig(ratio=0.25, multiple=16),
                              tpre.PreprocessConfig(rank=4, steps=1),
                              min_dim=32)


def test_engine_and_serve_refuse_as_repro(subject):
    """The reference's engine cannot serve the model: its contiguous
    prefill has no frames (KeyError), its paged caches raise
    NotImplementedError.  The port's engine raises NotImplementedError
    in its constructor on both backends, serve before it builds
    weights, and the paged model functions as the reference's."""
    rcfg, tcfg, params = subject
    rp, tp = params["fp"]
    reng = REngine(rcfg, PAR, rp, n_slots=2, max_seq=64)
    reng.submit(np.arange(1, 9, dtype=np.int32), max_new=2)
    with pytest.raises(KeyError, match="frames"):
        reng.run()
    with pytest.raises(NotImplementedError, match="enc-dec"):
        REngine(rcfg, PAR, rp, n_slots=2, max_seq=64, paged=True)
    for kw in (dict(), dict(paged=True), dict(paged=True,
                                              chunked_prefill=True)):
        with pytest.raises(NotImplementedError, match="encoder-decoder"):
            TEngine(tcfg, tp, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        serve.run(serve.parse_args(["--arch", ARCH, "--reduced",
                                    "--device", "cpu"]))
    with pytest.raises(NotImplementedError, match="enc-dec"):
        TM.init_paged_caches(tcfg, 4, 8)
    with pytest.raises(NotImplementedError, match="enc-dec"):
        TM.prefill_step_paged(tcfg, tp, torch.zeros((1, 8), dtype=torch.int32),
                              (), torch.zeros(4, dtype=torch.int32),
                              torch.zeros(4, dtype=torch.int32), 0, 8)
