"""Port parity of the xLSTM cells (``repro_torch.models.recurrent``:
``mlstm_seq`` / ``mlstm_step``, ``slstm_seq`` / ``slstm_step`` and the
sLSTM scan's autograd Function) against ``repro.models.recurrent`` on
xlstm-1.3b reduced (d 64, 4 heads: mLSTM dk 16, dv 32; sLSTM hd 16, FFN
128), weights built in ``repro`` and carried across by the bridge,
inputs from each test's own numpy generator.

Tolerances, each with its reason:
  * cells, blocks and chains of steps: f32 rtol 1e-5, atol 1e-6 (f32
    einsums, exp and log-sigmoid in two libraries, summed in other
    orders; a decode step against the chunkwise form is the recurrence
    against its closed form).
  * the sLSTM scan's forward and its four gradients (r_gates, b_gates,
    zx, the state entering the scan) against ``jax.grad`` of both the
    reference's custom-VJP scan and its autodiff oracle: 1e-5 of each
    cotangent's largest magnitude (the reference's own test holds its
    two scans at 1e-4: ``tests/test_perf_paths.py``).
  * the mLSTM's gradients at S = L = 64, where the reference's are
    finite: 1e-5 of the largest magnitude.
  * shapes and dtypes of the parameters and the decode state: exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.models import recurrent as RR  # noqa: E402
from repro.models.param import materialize  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.models import recurrent as TR  # noqa: E402
from repro_torch.models.param import materialize as t_materialize  # noqa: E402

ARCH = "xlstm-1.3b"
F32_RTOL, F32_ATOL = 1e-5, 1e-6
GRAD_REL = 1e-5
STATE = ("h", "c", "n", "m")


@pytest.fixture(scope="module")
def subject():
    """The reduced configs and one f32 mLSTM and one f32 sLSTM block on
    both sides; b_gates away from its zeros init, so a dropped bias
    shows."""
    rcfg = registry.get(ARCH).reduced()
    tcfg = t_registry.get(ARCH).reduced()
    out = {"cfg": (rcfg, tcfg)}
    for kind, init, key in (("mlstm", RR.init_mlstm, 3),
                            ("slstm", RR.init_slstm, 4)):
        p = materialize(init(rcfg), jax.random.PRNGKey(key))
        p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
        if kind == "slstm":
            p["b_gates"] = jnp.asarray(np.random.default_rng(5).normal(
                size=p["b_gates"].shape) * 0.5, jnp.float32)
        out[kind] = (p, bridge.convert(jax.tree.map(np.asarray, p)))
    return out


def _close(got, want, rtol=F32_RTOL, atol=F32_ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _x(seed, b, s, d, scale=0.5):
    rng = np.random.default_rng(seed)
    return (scale * rng.normal(size=(b, s, d))).astype(np.float32)


def test_declarations_match_repro():
    """Both cells' parameters and the decode states: the names, shapes
    and dtypes the reference declares (``w_if`` and ``b_gates`` f32,
    ``r_gates`` 4-D; every state f32), at the reduced and the full
    widths (the sLSTM FFN round(8/3 · d / 128) · 128 = 5504 at d 2048)."""
    for arch in (ARCH,):
        for rcfg, tcfg in ((registry.get(arch).reduced(),
                            t_registry.get(arch).reduced()),
                           (registry.get(arch), t_registry.get(arch))):
            for kind, r_init, t_init in (("mlstm", RR.init_mlstm,
                                          TR.init_mlstm),
                                         ("slstm", RR.init_slstm,
                                          TR.init_slstm)):
                r_decl, t_decl = r_init(rcfg), t_init(tcfg)
                assert list(r_decl) == list(t_decl)
                for name, pr in r_decl.items():
                    pt = t_decl[name]
                    assert tuple(pt.shape) == tuple(pr.shape), (kind, name)
                    assert str(pt.dtype).split(".")[-1] == \
                        jnp.dtype(pr.dtype).name, (kind, name)
                st = TR.init_recurrent_state(tcfg, kind, 3, 2, "meta")
                r_st = RR.init_recurrent_state(rcfg, kind, 3)
                assert list(st) == list(r_st)
                for name, pr in r_st.items():
                    assert tuple(st[name].shape) == (2,) + tuple(pr.shape)
                    assert st[name].dtype == torch.float32
    full = t_registry.get(ARCH)
    assert TR.init_slstm(full)["w_up"].shape == (2048, 5504)
    assert TR.init_mlstm(full)["w_out"].shape == (4096, 2048)
    tp = t_materialize(TR.init_slstm(t_registry.get(ARCH).reduced()), 0)
    assert tp["r_gates"].dtype == torch.bfloat16 and tp["r_gates"].ndim == 4
    st = TR.init_recurrent_state(t_registry.get(ARCH).reduced(), "mlstm", 2,
                                 1)
    assert not st["c"].any() and not st["n"].any()


@pytest.mark.parametrize("chunk,carry", [(4, True), (256, False)])
def test_mlstm_seq_matches_repro(subject, chunk, carry):
    """The chunkwise form at chunk 4 (five chunks, a carried state) and
    256 (one chunk of the whole sequence): output and final state."""
    rcfg, tcfg = subject["cfg"]
    rp, tp = subject["mlstm"]
    x = _x(21 + chunk, 2, 20 if chunk == 4 else 48, rcfg.d_model)
    st = None
    if carry:
        rng = np.random.default_rng(7)
        h, dk = rcfg.n_heads, rcfg.d_model // rcfg.n_heads
        st = {"c": rng.normal(size=(2, h, dk, 2 * dk)).astype(np.float32),
              "n": rng.normal(size=(2, h, dk)).astype(np.float32)}
    y_r, s_r = RR.mlstm_seq(rcfg, rp, jnp.asarray(x),
                            None if st is None else
                            jax.tree.map(jnp.asarray, st), chunk=chunk)
    y_t, s_t = TR.mlstm_seq(tcfg, tp, torch.from_numpy(x),
                            None if st is None else
                            {k: torch.from_numpy(v) for k, v in st.items()},
                            chunk=chunk)
    _close(y_t, y_r)
    for k in ("c", "n"):
        assert s_t[k].dtype == torch.float32
        _close(s_t[k], s_r[k])
    with pytest.raises(AssertionError):
        TR.mlstm_seq(tcfg, tp, torch.from_numpy(x[:, :6]), chunk=4)


def test_mlstm_steps_equal_seq(subject):
    """A chain of decode steps from zero state equals the sequence form
    (the decode contract of ``tests/test_runtime.py``), each step equals
    the reference's, and the in-place step leaves the state where it
    lies and equal to ``mlstm_step``'s."""
    rcfg, tcfg = subject["cfg"]
    rp, tp = subject["mlstm"]
    b, s = 2, 8
    x = _x(31, b, s, rcfg.d_model, 0.3)
    y_seq, st_seq = TR.mlstm_seq(tcfg, tp, torch.from_numpy(x), chunk=4)
    st_t = {k: v[0] for k, v in
            TR.init_recurrent_state(tcfg, "mlstm", b, 1).items()}
    c_buf, n_buf = st_t["c"].clone(), st_t["n"].clone()
    st_r = RR.init_recurrent_state(rcfg, "mlstm", b)
    st_r = {k: jnp.zeros(v.shape, v.dtype) for k, v in st_r.items()}
    outs = []
    for t in range(s):
        xt = x[:, t:t + 1]
        o, st_t = TR.mlstm_step(tcfg, tp, torch.from_numpy(xt), st_t)
        o_r, st_r = RR.mlstm_step(rcfg, rp, jnp.asarray(xt), st_r)
        o_in = TR.mlstm_step_(tcfg, tp, torch.from_numpy(xt), c_buf, n_buf)
        _close(o, o_r)
        _close(st_t["c"], st_r["c"])
        assert torch.equal(o_in, o)
        assert torch.equal(c_buf, st_t["c"]) and torch.equal(n_buf,
                                                             st_t["n"])
        outs.append(o)
    _close(torch.cat(outs, 1), y_seq.numpy())
    for k in ("c", "n"):
        _close(st_t[k], st_seq[k].numpy())


def _slstm_state(seed, b, d, zero=False):
    rng = np.random.default_rng(seed)
    if zero:
        z = np.zeros((b, d), np.float32)
        return {"h": z, "c": z, "n": z + np.float32(1e-6), "m": z}
    return {"h": rng.normal(size=(b, d)).astype(np.float32) * 0.5,
            "c": rng.normal(size=(b, d)).astype(np.float32),
            "n": rng.uniform(0.5, 2.0, size=(b, d)).astype(np.float32),
            "m": rng.normal(size=(b, d)).astype(np.float32) * 0.3}


@pytest.mark.parametrize("carry", [False, True])
def test_slstm_seq_matches_repro(subject, carry):
    """The block over 13 positions (scan, then the gated FFN), from the
    reference's initial state and from a carried one: output and every
    state entry."""
    rcfg, tcfg = subject["cfg"]
    rp, tp = subject["slstm"]
    x = _x(41 + carry, 2, 13, rcfg.d_model)
    st = _slstm_state(9, 2, rcfg.d_model) if carry else None
    y_r, s_r = RR.slstm_seq(rcfg, rp, jnp.asarray(x),
                            None if st is None else
                            jax.tree.map(jnp.asarray, st))
    y_t, s_t = TR.slstm_seq(tcfg, tp, torch.from_numpy(x),
                            None if st is None else
                            {k: torch.from_numpy(v) for k, v in st.items()})
    _close(y_t, y_r)
    for k in STATE:
        _close(s_t[k], s_r[k])


def test_slstm_steps_equal_seq(subject):
    """A chain of ``slstm_step`` calls from the sequence form's initial
    state equals ``slstm_seq``, and each step equals the reference's."""
    rcfg, tcfg = subject["cfg"]
    rp, tp = subject["slstm"]
    b, s = 2, 8
    x = _x(51, b, s, rcfg.d_model, 0.3)
    y_seq, st_seq = TR.slstm_seq(tcfg, tp, torch.from_numpy(x))
    st0 = _slstm_state(0, b, rcfg.d_model, zero=True)
    st_t = {k: torch.from_numpy(v) for k, v in st0.items()}
    st_r = jax.tree.map(jnp.asarray, st0)
    outs = []
    for t in range(s):
        o, st_t = TR.slstm_step(tcfg, tp, torch.from_numpy(x[:, t:t + 1]),
                                st_t)
        o_r, st_r = RR.slstm_step(rcfg, rp, jnp.asarray(x[:, t:t + 1]), st_r)
        _close(o, o_r)
        for k in STATE:
            _close(st_t[k], st_r[k])
        outs.append(o)
    _close(torch.cat(outs, 1), y_seq.numpy())
    for k in STATE:
        _close(st_t[k], st_seq[k].numpy())


@pytest.mark.parametrize("oracle", ["_slstm_scan", "_slstm_scan_ref"])
def test_slstm_scan_function_matches_jax_grad(subject, oracle):
    """The port's scan Function against ``jax.grad`` of the reference's
    custom-VJP scan and of its autodiff oracle: the loss, and the
    gradients of r_gates, b_gates, zx and every entry of the state that
    enters the scan; the port's plain-autograd oracle gives the same.
    bf16 r_gates and zx: the gradients come back in those dtypes."""
    rcfg, tcfg = subject["cfg"]
    rp, _ = subject["slstm"]
    rng = np.random.default_rng(61)
    b, t, d = 2, 9, rcfg.d_model
    zx = (rng.normal(size=(b, t, 4 * d)) * 0.4).astype(np.float32)
    st = _slstm_state(62, b, d)
    w_h = rng.normal(size=(b, t, d)).astype(np.float32)
    w_c = rng.normal(size=(b, d)).astype(np.float32)
    p_rec = {"r_gates": np.array(rp["r_gates"]),
             "b_gates": np.array(rp["b_gates"])}

    def loss_r(pr, zx_, st_):
        stN, hs = getattr(RR, oracle)(rcfg, pr, zx_, st_)
        return (jnp.sum(hs * w_h) + jnp.sum(stN["c"] * w_c)
                + 0.1 * jnp.sum(stN["h"]) + 0.2 * jnp.sum(stN["n"])
                + 0.3 * jnp.sum(stN["m"]))

    args_r = (jax.tree.map(jnp.asarray, p_rec), jnp.asarray(zx),
              jax.tree.map(jnp.asarray, st))
    l_r = loss_r(*args_r)
    g_pr, g_zx, g_st = jax.grad(loss_r, argnums=(0, 1, 2))(*args_r)
    want = {"r_gates": g_pr["r_gates"], "b_gates": g_pr["b_gates"],
            "zx": g_zx, **{f"state.{k}": g_st[k] for k in STATE}}

    def port(scan):
        leaves = {"r_gates": torch.from_numpy(p_rec["r_gates"]),
                  "b_gates": torch.from_numpy(p_rec["b_gates"]),
                  "zx": torch.from_numpy(zx),
                  **{f"state.{k}": torch.from_numpy(v)
                     for k, v in st.items()}}
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in leaves.items()}
        stN, hs = scan(tcfg, {"r_gates": leaves["r_gates"],
                              "b_gates": leaves["b_gates"]}, leaves["zx"],
                       {k: leaves[f"state.{k}"] for k in STATE})
        loss = (torch.sum(hs * torch.from_numpy(w_h))
                + torch.sum(stN["c"] * torch.from_numpy(w_c))
                + 0.1 * torch.sum(stN["h"]) + 0.2 * torch.sum(stN["n"])
                + 0.3 * torch.sum(stN["m"]))
        loss.backward()
        return loss, {k: v.grad for k, v in leaves.items()}

    for scan in (TR._slstm_scan, TR._slstm_scan_ref):
        l_t, got = port(scan)
        np.testing.assert_allclose(float(l_t.detach()), float(l_r),
                                   rtol=F32_RTOL)
        for k, g in want.items():
            assert _rel(got[k].numpy(), g) <= GRAD_REL, (scan.__name__, k)
    # the storage dtypes of the cotangents follow the inputs'
    rg = torch.from_numpy(p_rec["r_gates"]).to(torch.bfloat16)
    zb = torch.from_numpy(zx).to(torch.bfloat16).requires_grad_(True)
    rg.requires_grad_(True)
    state = {k: torch.from_numpy(v) for k, v in st.items()}
    stN, hs = TR._slstm_scan(tcfg, {"r_gates": rg, "b_gates":
                                    torch.from_numpy(p_rec["b_gates"])},
                             zb, state)
    assert hs.dtype == torch.float32
    hs.sum().backward()
    assert rg.grad.dtype == torch.bfloat16 and zb.grad.dtype == torch.bfloat16


def _mlstm_loss_r(rcfg, rp, w):
    def loss(p, x):
        y, st = RR.mlstm_seq(rcfg, p, x)
        return jnp.sum(y * w) + 0.1 * jnp.sum(st["c"])
    return loss


def _mlstm_grads_t(tcfg, tp, x, w):
    p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, st = TR.mlstm_seq(tcfg, p, xt)
    (torch.sum(y * torch.from_numpy(w)) + 0.1 * torch.sum(st["c"])).backward()
    return xt.grad, {k: v.grad for k, v in p.items()}


def test_mlstm_gradient_matches_jax_grad_in_one_chunk(subject):
    """At S = L = 64 the reference's gradient is finite: the port's
    gradients of the input and of every weight (``w_if`` included, the
    path through the log gates and the decay matrix) against
    ``jax.grad``."""
    rcfg, tcfg = subject["cfg"]
    rp, tp = subject["mlstm"]
    x = _x(71, 1, 64, rcfg.d_model)
    w = np.random.default_rng(72).normal(size=x.shape).astype(np.float32)
    g_p, g_x = jax.grad(_mlstm_loss_r(rcfg, rp, w), argnums=(0, 1))(
        rp, jnp.asarray(x))
    gx_t, gp_t = _mlstm_grads_t(tcfg, tp, x, w)
    assert np.isfinite(np.asarray(g_x)).all()
    assert _rel(gx_t.numpy(), g_x) <= GRAD_REL
    for k in gp_t:
        assert _rel(gp_t[k].numpy(), g_p[k]) <= GRAD_REL, k


def test_mlstm_intra_chunk_gradient_is_finite_where_repro_is_nan(subject):
    """A fault of the reference (ROADMAP queue 3): ``mlstm_seq``
    exponentiates the whole intra-chunk decay matrix and masks it
    afterwards, so above the diagonal the sums of up to L-1 log forget
    gates overflow to inf and a gradient through them is 0 · inf = NaN.
    At S = 256 (one chunk of 256) the reference's input gradient is NaN;
    the port masks to -inf before ``exp``: its forward equals the
    reference's and its gradient is finite."""
    rcfg, tcfg = subject["cfg"]
    rp, tp = subject["mlstm"]
    x = _x(81, 1, 256, rcfg.d_model)
    w = np.random.default_rng(82).normal(size=x.shape).astype(np.float32)
    y_r, _ = RR.mlstm_seq(rcfg, rp, jnp.asarray(x))
    y_t, _ = TR.mlstm_seq(tcfg, tp, torch.from_numpy(x))
    _close(y_t, y_r)
    g_x = jax.grad(_mlstm_loss_r(rcfg, rp, w), argnums=1)(rp, jnp.asarray(x))
    assert np.isnan(np.asarray(g_x)).any()
    gx_t, gp_t = _mlstm_grads_t(tcfg, tp, x, w)
    assert torch.isfinite(gx_t).all()
    assert all(torch.isfinite(g).all() for g in gp_t.values())
    assert float(gp_t["w_if"].abs().max()) > 0.0


def test_log_sigmoid_stays_exact_where_softplus_turns_linear():
    """log sigmoid as -logaddexp(-x, 0), as ``jax.nn.softplus``: torch's
    ``softplus`` returns its input above 20, which drops the exp(-x) a
    forget gate of x = -25 .. 25 contributes."""
    x = np.linspace(-40.0, 40.0, 81).astype(np.float32)
    want = np.asarray(-jax.nn.softplus(-jnp.asarray(x)))
    _close(TR._log_sigmoid(torch.from_numpy(x)), want, rtol=1e-6, atol=0.0)
