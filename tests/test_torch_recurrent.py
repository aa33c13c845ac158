"""Port parity of the RG-LRU block (``repro_torch.models.recurrent``)
against ``repro.models.recurrent`` on recurrentgemma-2b reduced (d 64,
rnn width 64, 8 gate heads of 8), weights built in ``repro`` and carried
across by the bridge, inputs from each test's own numpy generator.

Tolerances, each with its reason:
  * ``_causal_conv``, ``_rg_gates``, ``_rg_decay``: rtol 1e-6, atol 1e-6
    (f32 products, sigmoid and exp in two libraries).
  * ``rglru_seq`` and the doubling scan: f32 rtol 1e-5, atol 1e-6.  The
    port's Hillis-Steele scan composes the elements in another order
    than XLA's ``associative_scan``, so the sums round differently.
  * a chain of ``rglru_step`` calls against ``rglru_seq``: rtol 1e-5,
    atol 1e-6 in f32 (the scan against the sequential recurrence, and
    per-step projections against one over the sequence).
  * shapes and dtypes of the parameters and the decode state: exact.
"""
import dataclasses

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

ARCH = "recurrentgemma-2b"
SMALL_RTOL, SMALL_ATOL = 1e-6, 1e-6
F32_RTOL, F32_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def subject():
    """The reduced configs and one f32 RG-LRU block on both sides."""
    rcfg = registry.get(ARCH).reduced()
    tcfg = t_registry.get(ARCH).reduced()
    p = materialize(RR.init_rglru(rcfg), jax.random.PRNGKey(3))
    p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    # lam away from its "ones" init, so the decay spans (0, 1)
    p["lam"] = jnp.asarray(np.random.default_rng(2).normal(
        size=p["lam"].shape) * 2.0, jnp.float32)
    return rcfg, tcfg, p, bridge.convert(jax.tree.map(np.asarray, p))


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_repro(subject, with_state):
    rcfg, _, rp, tp = subject
    rng = np.random.default_rng(11)
    r = rcfg.rnn_width
    x = rng.normal(size=(2, 7, r)).astype(np.float32)
    st = (rng.normal(size=(2, rcfg.conv_width - 1, r)).astype(np.float32)
          if with_state else None)
    y_r, s_r = RR._causal_conv(rp, jnp.asarray(x),
                               None if st is None else jnp.asarray(st))
    y_t, s_t = TR._causal_conv(tp, torch.from_numpy(x),
                               None if st is None else torch.from_numpy(st))
    _close(y_t, y_r, SMALL_RTOL, SMALL_ATOL)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_r))


def test_rg_gates_and_decay_match_repro(subject):
    rcfg, _, rp, tp = subject
    rng = np.random.default_rng(12)
    x = rng.normal(size=(3, 5, rcfg.rnn_width)).astype(np.float32)
    i_r, r_r = RR._rg_gates(rp, jnp.asarray(x))
    i_t, r_t = TR._rg_gates(tp, torch.from_numpy(x))
    _close(i_t, i_r, SMALL_RTOL, SMALL_ATOL)
    _close(r_t, r_r, SMALL_RTOL, SMALL_ATOL)
    a_r = RR._rg_decay(rp, r_r)
    a_t = TR._rg_decay(tp, torch.from_numpy(np.array(r_r)))
    _close(a_t, a_r, SMALL_RTOL, SMALL_ATOL)
    assert float(a_t.min()) > 0.0 and float(a_t.max()) < 1.0


@pytest.mark.parametrize("carry", [False, True])
def test_rglru_seq_matches_repro(subject, carry):
    """The whole block, with and without a carried ``h0`` / conv state:
    output, final state and conv window."""
    rcfg, tcfg, rp, tp = subject
    rng = np.random.default_rng(13 + carry)
    r = rcfg.rnn_width
    x = (0.5 * rng.normal(size=(2, 19, rcfg.d_model))).astype(np.float32)
    h0 = rng.normal(size=(2, r)).astype(np.float32) if carry else None
    c0 = (rng.normal(size=(2, rcfg.conv_width - 1, r)).astype(np.float32)
          if carry else None)
    y_r, h_r, c_r = RR.rglru_seq(
        rcfg, rp, jnp.asarray(x), None if h0 is None else jnp.asarray(h0),
        None if c0 is None else jnp.asarray(c0))
    y_t, h_t, c_t = TR.rglru_seq(
        tcfg, tp, torch.from_numpy(x),
        None if h0 is None else torch.from_numpy(h0),
        None if c0 is None else torch.from_numpy(c0))
    _close(y_t, y_r, F32_RTOL, F32_ATOL)
    _close(h_t, h_r, F32_RTOL, F32_ATOL)
    assert h_t.dtype == torch.float32
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_r))


@pytest.mark.parametrize("s", [1, 5, 33])
def test_doubling_scan_matches_associative_scan(s):
    """``linear_scan`` against the reference's combine under
    ``jax.lax.associative_scan``, and against the sequential recurrence,
    at lengths below, at and past powers of two."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.05, 0.999, size=(2, s, 8)).astype(np.float32)
    b = rng.normal(size=(2, s, 8)).astype(np.float32)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    _, h_r = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                jnp.asarray(b)), axis=1)
    h_t = TR.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    _close(h_t, h_r, F32_RTOL, F32_ATOL)
    h = np.zeros((2, 8), np.float64)
    seq = []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        seq.append(h)
    _close(h_t, np.stack(seq, 1), F32_RTOL, F32_ATOL)


def test_scan_gradient_matches_repro():
    """The scan is differentiable (the Eq.-7 learning takes gradients
    through it): d(sum(h * w))/d(a, b) against ``jax.grad`` of the
    reference's ``associative_scan``."""
    rng = np.random.default_rng(21)
    a = rng.uniform(0.1, 0.99, size=(1, 11, 4)).astype(np.float32)
    b = rng.normal(size=(1, 11, 4)).astype(np.float32)
    w = rng.normal(size=(1, 11, 4)).astype(np.float32)

    def loss(a_, b_):
        _, h = jax.lax.associative_scan(
            lambda c1, c2: (c1[0] * c2[0], c2[0] * c1[1] + c2[1]),
            (a_, b_), axis=1)
        return jnp.sum(h * w)

    ga_r, gb_r = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a),
                                                 jnp.asarray(b))
    at = torch.from_numpy(a).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    torch.sum(TR.linear_scan(at, bt) * torch.from_numpy(w)).backward()
    _close(at.grad, ga_r, F32_RTOL, F32_ATOL)
    _close(bt.grad, gb_r, F32_RTOL, F32_ATOL)


def test_rglru_steps_equal_seq(subject):
    """A chain of single decode steps from zero state equals the
    sequence form (the decode contract, as ``tests/test_runtime.py``
    holds the reference to it), and each step equals the reference's."""
    rcfg, tcfg, rp, tp = subject
    rng = np.random.default_rng(14)
    b, s, r = 2, 8, rcfg.rnn_width
    x = (0.3 * rng.normal(size=(b, s, rcfg.d_model))).astype(np.float32)
    y_seq, h_seq, c_seq = TR.rglru_seq(tcfg, tp, torch.from_numpy(x))
    h = torch.zeros((b, r))
    conv = torch.zeros((b, rcfg.conv_width - 1, r))
    h_r = jnp.zeros((b, r), jnp.float32)
    conv_r = jnp.zeros((b, rcfg.conv_width - 1, r), jnp.float32)
    outs = []
    for t in range(s):
        o, h, conv = TR.rglru_step(tcfg, tp, torch.from_numpy(x[:, t:t + 1]),
                                   h, conv)
        o_r, h_r, conv_r = RR.rglru_step(rcfg, rp, jnp.asarray(x[:, t:t + 1]),
                                         h_r, conv_r)
        _close(o, o_r, F32_RTOL, F32_ATOL)
        _close(h, h_r, F32_RTOL, F32_ATOL)
        outs.append(o)
    _close(torch.cat(outs, 1), y_seq.numpy(), F32_RTOL, F32_ATOL)
    _close(h, h_seq.numpy(), F32_RTOL, F32_ATOL)
    # the conv window holds x @ w_x, a (B, 1) product per step against
    # one (B, S) product: equal to rounding
    _close(conv, c_seq.numpy(), F32_RTOL, F32_ATOL)


def test_declarations_match_repro():
    """The block's parameters and the decode state: the same names,
    shapes and dtypes as the reference declares (``lam`` and ``h`` f32,
    the rest, the conv state included, at the default bf16)."""
    rcfg = registry.get(ARCH).reduced()
    tcfg = t_registry.get(ARCH).reduced()
    r_decl = RR.init_rglru(rcfg)
    t_decl = TR.init_rglru(tcfg)
    assert sorted(r_decl) == sorted(t_decl)
    tp = t_materialize(t_decl, 0)
    for name, pr in r_decl.items():
        assert tuple(tp[name].shape) == tuple(pr.shape), name
        assert str(tp[name].dtype).split(".")[-1] == \
            jnp.dtype(pr.dtype).name, name
    st = TR.init_rglru_state(tcfg, batch=3, n_layers=2)
    for name, pr in RR.init_recurrent_state(rcfg, "rglru", 3).items():
        assert tuple(st[name].shape) == (2,) + tuple(pr.shape), name
        assert str(st[name].dtype).split(".")[-1] == \
            jnp.dtype(pr.dtype).name, name
        assert not st[name].any()
    full = dataclasses.replace(tcfg, d_model=2560, rnn_width=2560)
    assert TR.init_rglru(full)["w_inp"].shape == (TR.RG_HEADS, 320, 320)
