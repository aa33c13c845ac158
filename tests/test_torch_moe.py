"""Port parity of the MoE layer and of stacked-expert quantization:
``layers.moe_capacity``, the token-choice dispatch, ``apply_moe``,
``moe_aux_loss``, ``quantize_linear`` on (E, K, N) weights and the
per-expert products of ``QLinear`` / ``QLinearGroup`` / ``DequantView``,
against ``repro`` on granite-moe-1b-a400m reduced (d 64, 4 experts,
top-2, expert d_ff 128), weights built in ``repro`` and carried across
by the bridge.

Tolerances, each with its reason:
  * capacity, dispatch (``gate_e``, ``dest_e``, ``dest_c``, ``keep``),
    perm, w4, bits, k_s: exact.  The dispatch is compared on router
    logits that are exact in f32 on both sides (small integers), ties
    included, so top-k's tie order is held too.
  * ``gate_w``: 1e-6 (f32 softmax, exp in two libraries).
  * ``apply_moe`` and the expert products in f32: rtol 1e-5, atol 1e-5
    (matmuls of depth up to 128 summed in another order).
  * s4, z4 and the α's of a stacked quantization: rtol 1e-6 (f32 means
    and min/max of the same slices).
  * fusion: exact, as ``tests/test_perf_paths.py`` holds the reference.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.configs.base import MoEConfig as RMoE  # noqa: E402
from repro.core import qlinear as rql  # noqa: E402
from repro.core.pipeline import quantize_params_data_free as r_qdf  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.common import Parallel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.configs.base import MoEConfig as TMoE  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
from repro_torch.core.pipeline import quantize_params_data_free as t_qdf  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.linear import expert_dense  # noqa: E402

ARCH = "granite-moe-1b-a400m"
PAR = Parallel(tp=1, dp=1, remat=False, attn_chunk=32)
F32_RTOL, F32_ATOL = 1e-5, 1e-5
SCALE_RTOL = 1e-6


def _cfgs(capacity_factor=None):
    r, t = registry.get(ARCH).reduced(), t_registry.get(ARCH).reduced()
    if capacity_factor is not None:
        r = dataclasses.replace(r, moe=RMoE(
            r.moe.n_experts, r.moe.top_k, capacity_factor))
        t = dataclasses.replace(t, moe=TMoE(
            t.moe.n_experts, t.moe.top_k, capacity_factor))
    return r, t


@pytest.fixture(scope="module")
def subject():
    """repro's reduced granite in f32 and its port twin; the first
    layer's MoE parameters on both sides."""
    rcfg, _ = _cfgs()
    p = RM.init_params(rcfg, PAR, jax.random.PRNGKey(0))
    p = jax.tree.map(lambda a: a.astype(jnp.float32)
                     if a.dtype == jnp.bfloat16 else a, p)
    tp = bridge.params_from_repro(jax.tree.map(np.asarray, p))
    rmlp = jax.tree.map(lambda a: a[0], p["stages"][0][0]["mlp"])
    return p, tp, rmlp, tp["stages"][0][0][0]["mlp"]


def test_moe_capacity_matches_repro():
    cfgs = [_cfgs(), _cfgs(0.25), (registry.get(ARCH), t_registry.get(ARCH))]
    for rcfg, tcfg in cfgs:
        for t in (1, 3, 8, 17, 63, 64, 100, 512, 1024, 4097):
            assert TL.moe_capacity(tcfg, t) == RL.moe_capacity(rcfg, t), t


def _integer_routing_case(cf, seed):
    """Tokens and a router of small integers: the f32 logits are exact
    on both sides and tie often."""
    rcfg, tcfg = _cfgs(cf)
    rng = np.random.default_rng(seed)
    xt = rng.integers(-2, 3, size=(96, rcfg.d_model)).astype(np.float32)
    router = rng.integers(-1, 2, size=(rcfg.d_model, rcfg.moe.n_experts)
                          ).astype(np.float32)
    return rcfg, tcfg, xt, router


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_dispatch_matches_repro_exactly(cf):
    """gate_e, dest_e, dest_c and keep identical to the reference's
    intermediates on the same logits (cf 0.25 overflows most experts);
    ties break toward the lower expert index on both sides."""
    rcfg, tcfg, xt, router = _integer_routing_case(cf, seed=int(cf * 100))
    logits = xt @ router
    assert (np.sort(logits, -1)[:, -1] == np.sort(logits, -1)[:, -2]).any()
    _, _, r_de, r_dc, r_keep, r_gw = RL._moe_dispatch_local(
        rcfg, jnp.asarray(router), jnp.asarray(xt))
    _, r_ge = jax.lax.top_k(jnp.asarray(logits), rcfg.moe.top_k)
    t = TL.moe_dispatch(tcfg, torch.from_numpy(router), torch.from_numpy(xt))
    assert t["cap"] == RL.moe_capacity(rcfg, xt.shape[0])
    np.testing.assert_array_equal(t["gate_e"].numpy(), np.asarray(r_ge))
    np.testing.assert_array_equal(t["dest_e"].numpy(), np.asarray(r_de))
    np.testing.assert_array_equal(t["dest_c"].numpy(), np.asarray(r_dc))
    np.testing.assert_array_equal(t["keep"].numpy(), np.asarray(r_keep))
    np.testing.assert_allclose(t["gate_w"].numpy(), np.asarray(r_gw),
                               rtol=1e-6, atol=1e-6)
    if cf < 1:
        assert not t["keep"].all()


@pytest.mark.parametrize("cf", [4.0, 0.25])
def test_apply_moe_matches_repro(subject, cf):
    """f32, with no drop (cf 4: the capacity holds every token) and with
    overflow (cf 0.25: the capacity floor of 8 rows, most slots drop)."""
    _, _, rmlp, tmlp = subject
    rcfg, tcfg = _cfgs(cf)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 40, rcfg.d_model)).astype(np.float32)
    y_r = np.asarray(RL.apply_moe(rcfg, rmlp, jnp.asarray(x)))
    y_t = TL.apply_moe(tcfg, tmlp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y_t, y_r, rtol=F32_RTOL, atol=F32_ATOL)
    keep = TL.moe_dispatch(tcfg, tmlp["router"],
                           torch.from_numpy(x.reshape(80, -1)))["keep"]
    assert bool(keep.all()) == (cf > 1)


def test_moe_aux_loss_matches_repro(subject):
    _, _, rmlp, tmlp = subject
    rcfg, tcfg = _cfgs()
    x = np.random.default_rng(7).normal(size=(2, 24, rcfg.d_model)
                                        ).astype(np.float32)
    a_r = float(RL.moe_aux_loss(rcfg, jnp.asarray(x), rmlp["router"]))
    a_t = float(TL.moe_aux_loss(tcfg, torch.from_numpy(x), tmlp["router"]))
    np.testing.assert_allclose(a_t, a_r, rtol=1e-6)


def _stacked_weights(seed):
    """Three experts' (128, 48) f32 weights and per-expert statistics."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(3, 128, 48)).astype(np.float32)
    stat = np.abs(rng.normal(size=(3, 128))).astype(np.float32)
    return w, stat


@pytest.mark.parametrize("stat_kind", ["data-free", "per-expert", "shared"])
def test_stacked_quantize_linear_matches_repro(stat_kind):
    """One mask per (K, N) slice: perm, w4 and bits identical per
    expert, k_s equal, scales within 1e-6; the fields keep the leading
    expert axis."""
    w, stat = _stacked_weights(11)
    s = {"data-free": None, "per-expert": stat, "shared": stat[0]}[stat_kind]
    rq = rql.quantize_linear(jnp.asarray(w), None if s is None
                             else jnp.asarray(s),
                             rql.QuantConfig(ratio=0.2, multiple=16))
    tq = tql.quantize_linear(torch.from_numpy(w), None if s is None
                             else torch.from_numpy(s),
                             tql.QuantConfig(ratio=0.2, multiple=16))
    b = bridge.convert(jax.tree.map(np.asarray, rq))
    assert (tq.k_s, tq.k, tq.n) == (b.k_s, b.k, b.n)
    for f in tql.FIELDS:
        assert getattr(tq, f).shape == getattr(b, f).shape, f
        assert getattr(tq, f).shape[0] == 3, f
    for f in ("perm", "w4", "bits"):
        assert torch.equal(getattr(tq, f), getattr(b, f)), f
    for f in ("s4", "z4", "alpha_s", "alpha_r1", "alpha_r2"):
        torch.testing.assert_close(getattr(tq, f), getattr(b, f),
                                   rtol=SCALE_RTOL, atol=0.0)
    if stat_kind != "shared":       # each expert its own mask
        assert not torch.equal(tq.perm[0], tq.perm[1])


@pytest.mark.parametrize("group", [False, True])
def test_expert_matmul_matches_repro(group):
    """``QLinear.__expert_matmul__`` (and a fused ``QLinearGroup`` over a
    stacked inner) against the reference's einsum, f32.  Scale
    learning's per-expert product over a ``DequantView`` is the packed
    weight's own, and gives the α's gradients of their shapes."""
    w, _ = _stacked_weights(13)
    qc = dict(ratio=0.25, multiple=16)
    if group:
        ws = [w[..., :16], w[..., 16:]]
        rq = rql.quantize_linear_group([jnp.asarray(a) for a in ws], None,
                                       rql.QuantConfig(**qc))
        tq = tql.quantize_linear_group([torch.from_numpy(a.copy())
                                        for a in ws], None,
                                       tql.QuantConfig(**qc))
    else:
        rq = rql.quantize_linear(jnp.asarray(w), None, rql.QuantConfig(**qc))
        tq = tql.quantize_linear(torch.from_numpy(w), None,
                                 tql.QuantConfig(**qc))
    x = np.random.default_rng(3).normal(size=(3, 8, 128)).astype(np.float32)
    y_r = np.asarray(rq.__expert_matmul__(jnp.asarray(x)))
    y_t = expert_dense(torch.from_numpy(x), tq).numpy()
    np.testing.assert_allclose(y_t, y_r, rtol=F32_RTOL, atol=F32_ATOL)
    # the bridged reference weight gives the same product in the port
    b = bridge.convert(jax.tree.map(np.asarray, rq))
    np.testing.assert_allclose(expert_dense(torch.from_numpy(x), b).numpy(),
                               y_t, rtol=F32_RTOL, atol=F32_ATOL)
    q = tq.inner if group else tq
    xt = torch.from_numpy(x)
    view = q.dequant_view(torch.float32)
    assert torch.equal(view.__expert_matmul__(xt), q.__expert_matmul__(xt))
    a = {f: getattr(view, f).clone().requires_grad_(True)
         for f in ("alpha_s", "alpha_r1", "alpha_r2")}
    torch.sum(tql.with_scales(view, a).__expert_matmul__(xt) ** 2).backward()
    for f, t in a.items():
        assert t.grad.shape == getattr(q, f).shape
        assert torch.count_nonzero(t.grad) > 0, f


def test_fused_expert_gate_up_matches_its_members(subject):
    """Mirror of ``tests/test_perf_paths.py::
    test_moe_expert_fusion_matches_unfused``: fp fusion of the stacked
    wg/wu is exact, and the data-free fused packed layout gives exactly
    its unfused member views' loss; the fused group's bytes are the
    reference's."""
    rp, tp, _, _ = subject
    _, tcfg = _cfgs()
    batch = {"tokens": torch.ones((2, 16), dtype=torch.int32),
             "targets": torch.ones((2, 16), dtype=torch.int32)}
    base = TM.forward_loss(tcfg, tp, batch, attn_chunk=32)
    fused = TT.fuse_params_for_decode(tp)
    assert all("wgu" in lp[0]["mlp"] and "router" in lp[0]["mlp"]
               for lp in fused["stages"][0])
    lf = TM.forward_loss(tcfg, fused, batch, attn_chunk=32)
    lu = TM.forward_loss(tcfg, TT.unfuse_params_for_oracle(fused), batch,
                         attn_chunk=32)
    assert float(base) == float(lf) == float(lu)

    qc = dict(ratio=0.25, multiple=16)
    qp = t_qdf(tp, tql.QuantConfig(**qc), min_dim=32, fuse=True)
    lq = TM.forward_loss(tcfg, qp, batch, attn_chunk=32)
    lqu = TM.forward_loss(tcfg, TT.unfuse_params_for_oracle(qp), batch,
                          attn_chunk=32)
    assert np.isfinite(float(lq)) and float(lq) == float(lqu)
    rq = bridge.params_from_repro(jax.tree.map(np.asarray, r_qdf(
        rp, rql.QuantConfig(**qc), min_dim=32, fuse=True)))
    a = qp["stages"][0][0][0]["mlp"]["wgu"]
    b = rq["stages"][0][0][0]["mlp"]["wgu"]
    assert a.splits == b.splits == (128, 128)
    assert a.inner.w4.shape[0] == 4
    for ma, mb in zip(a.members(), b.members()):
        for f in ("perm", "w4", "bits"):
            assert torch.equal(getattr(ma, f), getattr(mb, f)), f
