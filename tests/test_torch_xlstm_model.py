"""Port parity of the xLSTM block kinds (``mlstm`` and ``slstm``) through
the model: the bridge of their leaves, the blocks' full-sequence
forward, whole-prompt prefill with its recurrent state, decode on both
cache backends, ``forward_loss``, ``model_bits``, data-free and
calibrated PTQ1.61 and the rtn-2 baseline, against ``repro`` on
xlstm-1.3b reduced (d 64, 4 heads, layernorm; the pattern 7 × mlstm then
slstm, 8 layers, untied head) in f32, weights built in ``repro`` (dense,
and data-free quantized with ``fuse=True``, which leaves the xLSTM
projections unfused, as in the reference) and carried across by the
bridge.  Every norm scale and bias and ``b_gates`` is set to seeded
random values first, so a dropped one shows.  Packed projections run
through ``repro``'s mixed_matmul kernel in interpret mode on every shape
(``repro_kernel_everywhere``), so both sides round their operands
alike.

Tolerances, each with its reason:
  * block outputs: rtol 1e-5 for dense weights (f32 einsums and the
    cells' exp / log-sigmoid in two libraries), atol 1e-4: the mLSTM's
    gate projection x @ w_if (N = 2H = 8) is summed in another order by
    XLA's CPU dot than by torch (1-2 ulp, measured 1.2e-6 at |gates| ≈
    4), and the exponential gates carry that into the output: typically
    4e-6 on outputs of magnitude 5, and in two of about fifteen runs of
    this file the reference's output on the same inputs moved the gap
    to 8.3e-5 (the port's output is the same in every run).  For packed
    weights rtol 2^-7, atol 2e-3: the packed product rounds its operands
    and output to bf16 on both sides, and where the two f32 accumulators
    straddle a rounding boundary the output moves by one bf16 ulp, as
    ``tests/test_torch_hybrid_model.py`` allows.
  * logits of prefill and decode, and the loss, relative to the
    reference's largest magnitude: 1e-4.  Each of the 8 blocks adds
    about 1e-6 of that gate-projection noise to the residual stream
    (measured block by block from the same inputs), so the logits of a
    45-token prefill part by 3.2e-5 (dense) and the loss on packed
    weights by 4.3e-5; the hybrid's 4 layers stay within 1e-5.  Each
    recurrent state entry after a prefill and after the decode steps:
    1e-4 of its own largest magnitude, for the same reason (f32).
  * bits, weight counts, packed bytes: exact.  Calibrated scales as
    ``tests/test_torch_hybrid_model.py``; the learned α's of the first
    block (the same embedding stream on both sides) at its tolerance,
    rtol 1e-5, atol 1e-7, and of every block at rtol 1e-4, atol 1e-6:
    the calibration streams part by the noise above block by block, and
    the α gap grows with depth (measured 2.7e-7 at block 0, 1.6e-5 at
    block 6, 3.2e-5 on the sLSTM's w_gates at block 7).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.core import pipeline as rpipe  # noqa: E402
from repro.core import qlinear as rql  # noqa: E402
from repro.core.baselines import driver as rdrv  # noqa: E402
from repro.core.bits import model_bits as r_bits  # noqa: E402
from repro.kernels import autotune, ops as rops  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.common import Parallel  # noqa: E402
from repro.models.param import materialize  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
from repro_torch.core.baselines import driver as tdrv  # noqa: E402
from repro_torch.core.bits import model_bits as t_bits  # noqa: E402
from repro_torch.core.select import map_tree  # noqa: E402
from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime.paged_cache import (BlockTables, PagePool,  # noqa: E402
                                             pages_for_tokens)

ARCH = "xlstm-1.3b"
PAR = Parallel(tp=1, dp=1, remat=False, attn_chunk=32)
TOL = {"fp": (1e-5, 1e-4), "fused": (2.0 ** -7, 2e-3)}
REL = 1e-4
ALPHA_RTOL, ALPHA_ATOL = 1e-5, 1e-7           # the first block's
DEEP_ALPHA_RTOL, DEEP_ALPHA_ATOL = 1e-4, 1e-6  # every block's
SCALE_RTOL = 1e-6
N_PROJ = 7 * 5 + 4        # w_q, w_k, w_v, w_gate, w_out; w_gates, w_up, ...


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
    """Every norm scale, norm bias and gate bias of a repro tree ->
    seeded random values (scales around 1, biases around 0)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = getattr(path[-1], "key", None)
        if name in ("scale", "q_norm", "k_norm"):
            return jnp.asarray(1.0 + 0.3 * rng.normal(size=a.shape), a.dtype)
        if name in ("bias", "b_gates", "bq", "bk", "bv"):
            return jnp.asarray(0.3 * rng.normal(size=a.shape), a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(leaf, p)


@pytest.fixture(scope="module")
def subject():
    """{mode: (repro params, port params)} over one f32 reduced model;
    "fused" is data-free PTQ1.61 with ``fuse=True``."""
    rcfg = registry.get(ARCH).reduced()
    tcfg = t_registry.get(ARCH).reduced()
    p = RM.init_params(rcfg, PAR, jax.random.PRNGKey(0))
    p = jax.tree.map(lambda a: a.astype(jnp.float32)
                     if a.dtype == jnp.bfloat16 else a, p)
    p = randomize_scales_and_biases(p, 1)
    qp = rpipe.quantize_params_data_free(
        p, rql.QuantConfig(ratio=0.25, multiple=16, use_kernel=True),
        min_dim=32, fuse=True)
    params = {mode: (rp, bridge.params_from_repro(jax.tree.map(np.asarray,
                                                              rp)))
              for mode, rp in (("fp", p), ("fused", qp))}
    return rcfg, tcfg, params


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


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


def test_bridge_carries_xlstm_leaves(subject):
    """The reference's stacked (L, ...) xLSTM leaves become per-layer
    leaves: ``r_gates`` stays 4-D (4, H, hd, hd), ``w_if`` and
    ``b_gates`` f32; the nine projections are packed leaves, none fused,
    and the port's own data-free quantization with ``fuse=True`` gives
    the same bytes (scales to 1e-6: f32 means summed in another order)."""
    rcfg, tcfg, params = subject
    rp, tp = params["fused"]
    mine = tpipe.quantize_params_data_free(
        params["fp"][1], tql.QuantConfig(ratio=0.25, multiple=16),
        min_dim=32, fuse=True)
    d, h = rcfg.d_model, rcfg.n_heads
    assert [len(s) for s in tp["stages"]] == [1]
    assert [tuple(sorted(b)) for b in tp["stages"][0][0]] == \
        [("cell", "ln1")] * 8
    ml, sl = tp["stages"][0][0][0]["cell"], tp["stages"][0][0][7]["cell"]
    assert tuple(sl["r_gates"].shape) == (4, h, d // h, d // h)
    assert sl["b_gates"].dtype == torch.float32
    assert ml["w_if"].dtype == torch.float32
    assert tuple(ml["w_if"].shape) == (d, 2 * h)
    assert torch.equal(sl["b_gates"], bridge.to_tensor(
        np.asarray(rp["stages"][0][7]["cell"]["b_gates"][0])))
    for name in ("w_q", "w_k", "w_v", "w_gate", "w_out"):
        assert isinstance(ml[name], tql.QLinear), name
    for name in ("w_gates", "w_up", "w_gate", "w_down"):
        assert isinstance(sl[name], tql.QLinear), name
    assert tp["stages"][0][0][0]["ln1"]["bias"].abs().max() > 0
    a, b = _qlinears(mine), _qlinears(tp)
    assert a.keys() == b.keys() and len(a) == N_PROJ
    for k in a:
        for f in ("perm", "w4", "bits"):
            assert torch.equal(getattr(a[k], f), getattr(b[k], f)), (k, f)
        for f in ("s4", "z4", "alpha_s", "alpha_r1", "alpha_r2"):
            torch.testing.assert_close(getattr(a[k], f), getattr(b[k], f),
                                       rtol=SCALE_RTOL, atol=0.0)


@pytest.mark.parametrize("mode", ["fp", "fused"])
@pytest.mark.parametrize("kind,pi", [("mlstm", 0), ("slstm", 7)])
def test_block_full_matches_repro(subject, mode, kind, pi,
                                  repro_kernel_everywhere):
    """One block over 64 positions (the mLSTM in one chunk of 64)."""
    rcfg, tcfg, params = subject
    rp, tp = params[mode]
    rng = np.random.default_rng(31)
    x = rng.normal(size=(2, 64, rcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(64, dtype=np.int32), (2, 64)).copy()
    rblock = jax.tree.map(lambda a: a[0], rp["stages"][0][pi])
    y_r, _ = RT.block_full(rcfg, PAR, kind, rblock, jnp.asarray(x),
                           jnp.asarray(pos), causal=True)
    y_t = TT.block_full(tcfg, kind, tp["stages"][0][0][pi],
                        torch.from_numpy(x), torch.from_numpy(pos),
                        causal=True)
    rtol, atol = TOL[mode]
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), rtol=rtol,
                               atol=atol)


def _left_padded(seqs, b):
    toks = np.zeros((len(seqs), b), np.int32)
    pos = np.full((len(seqs), b), -1, np.int32)
    for i, s in enumerate(seqs):
        toks[i, b - len(s):] = s
        pos[i, b - len(s):] = np.arange(len(s))
    return toks, pos


def _states_close(tc, rc):
    for cs_t, cs_r in zip(tc, rc):
        for c_t, c_r in zip(cs_t, cs_r):
            assert sorted(c_t) == sorted(c_r)
            for name, t in c_t.items():
                want = np.asarray(c_r[name])
                assert t.dtype == torch.float32 and want.dtype == np.float32
                assert tuple(t.shape) == want.shape, name
                assert _rel(t.numpy(), want) <= REL, name


@pytest.mark.parametrize("backend", ["contiguous", "paged"])
def test_prefill_then_decode_matches_repro(subject, backend):
    """A 45-token prompt left-padded to 64, prefilled, spliced into slot
    1 of 2, then 5 decode steps: the prefill logits and state, the
    spliced state, and every step's logits, against the reference's.
    Slot 0 is empty (it decodes as well, as in the reference's engine);
    the mLSTM's matrix memory is stepped in place."""
    rcfg, tcfg, params = subject
    rp, tp = params["fp"]
    rng = np.random.default_rng(41)
    seq = rng.integers(1, rcfg.vocab, size=50).astype(np.int32)
    plen, b, max_seq, ps, slot = 45, 64, 128, 8, 1
    toks, pos = _left_padded([seq[:plen]], b)
    lr, c1r = RM.prefill(rcfg, PAR, rp, {"tokens": jnp.asarray(toks),
                                         "positions": jnp.asarray(pos)},
                         max_seq)
    lt, c1t = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                    "positions": torch.from_numpy(pos)},
                         max_seq)
    assert _rel(lt.numpy(), lr) <= REL
    _states_close(c1t, c1r)
    if backend == "contiguous":
        rc = materialize(RM.init_caches(rcfg, PAR, 2, max_seq),
                         jax.random.PRNGKey(0))
        rc = RM.splice_prefill(rcfg, rc, c1r, jnp.int32(slot))
        tc = TM.init_caches(tcfg, 2, max_seq)
        tc = TM.splice_prefill(tcfg, tc, c1t, slot)
    else:
        pool = PagePool(16, ps)
        tables = BlockTables(pool, 2, pages_for_tokens(max_seq, ps))
        tables.ensure_blocks(slot, pages_for_tokens(50, ps))
        bt = tables.as_array()
        rc = materialize(RM.init_paged_caches(rcfg, PAR, 2, 16, ps,
                                              dtype=jnp.float32),
                         jax.random.PRNGKey(0))
        rc = RM.splice_prefill_paged(rcfg, rc, c1r, jnp.int32(slot),
                                     jnp.asarray(bt[slot]))
        tc = TM.init_paged_caches(tcfg, 16, ps, dtype=torch.float32,
                                  n_slots=2)
        tc = TM.splice_prefill_paged(tcfg, tc, c1t, slot,
                                     torch.from_numpy(bt[slot]))
    _states_close(tc, rc)
    c_buf = tc[0][0]["c"]
    for p in range(plen, plen + 5):
        tok = np.asarray([0, seq[p - 1]], np.int32)
        ps_ = np.asarray([0, p], np.int32)
        if backend == "contiguous":
            lr, rc = RM.decode_step(rcfg, PAR, rp, jnp.asarray(tok),
                                    jnp.asarray(ps_), rc, max_seq)
            lt, tc = TM.decode_step(tcfg, tp, torch.from_numpy(tok),
                                    torch.from_numpy(ps_), tc, max_seq)
        else:
            lens = np.asarray([0, p + 1], np.int32)
            btd = np.where(np.arange(2)[:, None] == slot, bt, -1)
            lr, rc = RM.decode_step_paged(
                rcfg, PAR, rp, jnp.asarray(tok), jnp.asarray(ps_), rc,
                jnp.asarray(btd), jnp.asarray(lens), max_seq,
                use_kernel=False)
            lt, tc = TM.decode_step_paged(
                tcfg, tp, torch.from_numpy(tok), torch.from_numpy(ps_), tc,
                torch.from_numpy(btd), torch.from_numpy(lens))
        assert _rel(lt[slot].numpy(), lr[slot]) <= REL, p
        assert tc[0][0]["c"] is c_buf
    _states_close(tc, rc)


@pytest.mark.parametrize("mode", ["fp", "fused"])
def test_forward_loss_matches_repro(subject, mode, repro_kernel_everywhere):
    rcfg, tcfg, params = subject
    rp, tp = params[mode]
    rng = np.random.default_rng(17)
    toks = rng.integers(1, rcfg.vocab, size=(2, 64)).astype(np.int32)
    tgts = rng.integers(0, rcfg.vocab, size=(2, 64)).astype(np.int32)
    tgts[0, :5] = -1
    lr = RM.forward_loss(rcfg, PAR, rp, {"tokens": jnp.asarray(toks),
                                         "targets": jnp.asarray(tgts)})
    lt = TM.forward_loss(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                    "targets": torch.from_numpy(tgts)})
    assert lt.dim() == 0 and torch.isfinite(lt)
    np.testing.assert_allclose(float(lt), float(lr), rtol=REL)


def test_model_bits_matches_repro(subject):
    """``r_gates``, ``b_gates``, ``w_if`` and the norms count as fp
    parameters, as in the reference: every number exact."""
    _, _, params = subject
    rp, tp = params["fused"]
    b_r, b_t = r_bits(rp), t_bits(tp)
    for k in ("avg_bits_per_quantized_weight", "quantized_weights",
              "exempt_params", "exempt_fraction", "checkpoint_gbytes"):
        assert b_t[k] == b_r[k], k


def _calib():
    corpus = SyntheticCorpus(CorpusConfig(vocab=512, seed=0))
    return [t for t, _ in corpus.batches(1, 32, 2, split="calib")]


def test_calibrated_ptq161_matches_repro(subject):
    """Calibrated PTQ1.61 over the xLSTM blocks (the Eq.-7 learning takes
    its gradients through the chunkwise mLSTM and the sLSTM scan's
    Function): packed bytes identical, scales and learned α's within
    tolerance, no block's loss raised."""
    rcfg, tcfg, params = subject
    rp, tp = params["fp"]
    toks = _calib()
    kw = dict(ratio=0.2, multiple=16, steps=2)
    rq = rpipe.quantize_model_ptq161(
        rcfg, PAR, rp, [{"tokens": jnp.asarray(t)} for t in toks],
        rql.QuantConfig(**kw), min_dim=32)
    losses = []
    tq = tpipe.quantize_model_ptq161(
        tcfg, tp, [{"tokens": torch.from_numpy(t)} for t in toks],
        tql.QuantConfig(**kw), min_dim=32, block_losses=losses)
    a = _qlinears(tq)
    b = _qlinears(bridge.params_from_repro(jax.tree.map(np.asarray, rq)))
    assert a.keys() == b.keys() and len(a) == N_PROJ
    for k in a:
        for f in ("perm", "w4", "bits"):
            assert torch.equal(getattr(a[k], f), getattr(b[k], f)), (k, f)
        for f in ("s4", "z4"):
            torch.testing.assert_close(getattr(a[k], f), getattr(b[k], f),
                                       rtol=SCALE_RTOL, atol=0.0)
        first = k[:4] == ("stages", 0, 0, 0)
        for f in ("alpha_s", "alpha_r1", "alpha_r2"):
            torch.testing.assert_close(
                getattr(a[k], f), getattr(b[k], f),
                rtol=ALPHA_RTOL if first else DEEP_ALPHA_RTOL,
                atol=ALPHA_ATOL if first else DEEP_ALPHA_ATOL)
    gates = [k for k in a if k[-1] == "w_gates"]
    assert len(gates) == 1
    assert not torch.equal(a[gates[0]].alpha_r1,
                           torch.ones_like(a[gates[0]].alpha_r1))
    assert len(losses) == 8
    assert all(after <= before for before, after in losses), losses


def test_rtn_baseline_matches_repro(subject):
    """rtn-2 through the baselines' driver over the xLSTM blocks (the
    same ``block_full``): every fake-quantized leaf identical, the loss
    within 1e-5."""
    rcfg, tcfg, params = subject
    rp, tp = params["fp"]
    toks = _calib()
    rq = rdrv.quantize_model_baseline(
        rcfg, PAR, rp, [{"tokens": jnp.asarray(t)} for t in toks], "rtn-2",
        min_dim=32)
    tq = tdrv.quantize_model_baseline(
        tcfg, tp, [{"tokens": torch.from_numpy(t)} for t in toks], "rtn-2",
        min_dim=32)
    rb = bridge.params_from_repro(jax.tree.map(np.asarray, rq))
    leaves_t, leaves_r = {}, {}
    map_tree(tq, lambda p, x: leaves_t.__setitem__(p, x))
    map_tree(rb, lambda p, x: leaves_r.__setitem__(p, x))
    assert leaves_t.keys() == leaves_r.keys()
    changed = 0
    for k, t in leaves_t.items():
        assert torch.equal(t, leaves_r[k]), k
        fp = tp
        for part in k:
            fp = fp[part]
        changed += not torch.equal(t, fp)
    assert changed == N_PROJ
    rng = np.random.default_rng(5)
    vt = rng.integers(1, 512, size=(2, 32)).astype(np.int32)
    vg = rng.integers(0, 512, size=(2, 32)).astype(np.int32)
    l_r = float(RM.forward_loss(rcfg, PAR, rq, {"tokens": jnp.asarray(vt),
                                                "targets": jnp.asarray(vg)}))
    l_t = float(TM.forward_loss(tcfg, tq, {"tokens": torch.from_numpy(vt),
                                           "targets": torch.from_numpy(vg)}))
    np.testing.assert_allclose(l_t, l_r, rtol=REL)
