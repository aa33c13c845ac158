"""Port parity: the training path's optimizer, compressor and fault
tolerance (``repro_torch.optim.adamw``, ``repro_torch.distributed``)
against ``repro``.

The trees have the reference's stage layout on its side (a stage leaf
stacked over 3 layers) and the port's on the other (one tensor per
layer): the clipping norm, the int8 absmax, the top-k threshold and
``wire_bytes`` are taken per stacked leaf in the reference, which a
one-layer stage could not tell from per layer.

Tolerances, each with its reason:
  * compression and ``wire_bytes``: exact.  The same f32 inputs give
    the same absmax, threshold, rounding and residual.
  * AdamW with weight decay, clipping and the cosine schedule over 6
    steps (warm-up 3: steps 1, warmup, warmup + 1 and total among
    them): moments rtol 2e-6 and 4 ulp of their largest element (a
    moment near 0 is the difference of two terms that size), and the bf16
    parameters at most one bf16
    ulp apart (2**-7 relative) in at most 1% of elements.  The clipping
    norm sums the same squares in another order inside a stacked leaf
    (about 1e-7 relative on the scale), and ``cos`` may round one ulp
    apart in XLA and in torch; an f32 value one ulp off can round to the
    other bf16 neighbour.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.distributed import compression as rcomp  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro_torch import bridge, pytree  # noqa: E402
from repro_torch.distributed import compression as tcomp  # noqa: E402
from repro_torch.distributed.fault import (FailureInjector,  # noqa: E402
                                           InjectedFailure,
                                           StragglerWatchdog, Supervisor)
from repro_torch.optim import adamw as tadamw  # noqa: E402

N_LAYERS = 3
B1, B2 = 0.9, 0.999


def _stacked(rng, dtype=np.float32):
    """A params-shaped tree in the reference's layout (numpy)."""
    def a(*shape):
        return (rng.normal(size=shape) * 0.5).astype(dtype)
    return {"embed": a(16, 8),
            "stages": [({"w": a(N_LAYERS, 8, 12), "b": a(N_LAYERS, 12)},
                        {"v": a(N_LAYERS, 12, 8)})],
            "final_norm": {"scale": a(8)}}


def _both(tree, dtype=None):
    """(reference jnp tree, port per-layer torch tree) of one numpy tree."""
    r = jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)
    t = bridge.params_from_repro(jax.tree.map(np.asarray, r))
    return r, t


def _ref_of(t):
    return [x.float().numpy() for x in
            pytree.leaves(bridge.params_to_repro(t))]


def test_adamw_with_decay_clip_and_schedule_matches_repro():
    rng = np.random.default_rng(10)
    warmup, total = 3, 6
    ropt = radamw.AdamW(lr=3e-2, weight_decay=0.01, clip_norm=1.0,
                        schedule=radamw.cosine_schedule(warmup, total))
    topt = tadamw.AdamW(lr=3e-2, weight_decay=0.01, clip_norm=1.0,
                        schedule=tadamw.cosine_schedule(warmup, total))
    rp, tp = _both(_stacked(rng), jnp.bfloat16)
    rs, ts = ropt.init(rp), topt.init(tp)
    assert ts.step.dtype == torch.int32 and ts.step.ndim == 0
    for s in range(1, total + 1):
        rg, tg = _both(_stacked(rng), jnp.bfloat16)
        rp, rs = ropt.update(rg, rs, rp)
        tp, ts = topt.update(tg, ts, tp)
        assert int(ts.step) == int(rs.step) == s
        sched_t = float(tadamw.cosine_schedule(warmup, total)(ts.step))
        sched_r = float(radamw.cosine_schedule(warmup, total)(rs.step))
        assert sched_t == pytest.approx(sched_r, rel=2e-7, abs=0), s
        for name in ("mu", "nu"):
            for a, b in zip(_ref_of(getattr(ts, name)),
                            jax.tree.leaves(getattr(rs, name))):
                b = np.asarray(b)
                np.testing.assert_allclose(
                    a, b, rtol=2e-6, atol=4 * np.spacing(np.abs(b).max()),
                    err_msg=f"{name} {s}")
        for a, b in zip(_ref_of(tp), jax.tree.leaves(rp)):
            b = np.asarray(b, np.float32)
            off = np.abs(a - b) > 0
            assert off.mean() <= 0.01, s
            np.testing.assert_allclose(a, b, rtol=2 ** -7, atol=0)


def test_clipping_promotes_bf16_gradients_to_f32():
    """With clipping the update scales each bf16 gradient in f32, as
    JAX's ``g * scale`` (a strong f32 scale) does: the first moment is
    (1 - b1)·(f32(g)·scale), not bf16(g·scale)."""
    g = {"w": torch.tensor([3.0, -1.7, 0.3, 2.2], dtype=torch.bfloat16)}
    p = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    opt = tadamw.AdamW(lr=1e-3, clip_norm=1.0)
    _, st = opt.update(g, opt.init(p), p)
    gnorm = torch.sqrt(torch.sum(torch.square(g["w"].float())))
    scale = torch.tensor(1.0) / (gnorm + 1e-9)
    assert torch.equal(st.mu["w"], (1 - B1) * (g["w"].float() * scale))
    assert not torch.equal(st.mu["w"],
                           (1 - B1) * (g["w"] * scale.to(torch.bfloat16))
                           .float())
    ropt = radamw.AdamW(lr=1e-3, clip_norm=1.0)
    rg = {"w": jnp.asarray(g["w"].float().numpy(), jnp.bfloat16)}
    rp = {"w": jnp.zeros(4, jnp.bfloat16)}
    _, rs = ropt.update(rg, ropt.init(rp), rp)
    np.testing.assert_array_equal(st.mu["w"].numpy(), np.asarray(rs.mu["w"]))


def _previous_update(lr, grads, step, mu, nu, params):
    """The port's AdamW update before the trainer's options (defaults
    only; Python-int step, bias corrections by an integer power)."""
    c1 = float(1 - torch.tensor(B1, dtype=torch.float32) ** step)
    c2 = float(1 - torch.tensor(B2, dtype=torch.float32) ** step)
    out = {}
    for k in grads:
        gf = grads[k].to(torch.float32)
        m = B1 * mu[k] + (1 - B1) * gf
        v = B2 * nu[k] + (1 - B2) * (gf * gf)
        delta = (m / c1) / (torch.sqrt(v / c2) + 1e-8)
        out[k] = ((params[k].to(torch.float32) - lr * delta)
                  .to(params[k].dtype), m, v)
    return ({k: o[0] for k, o in out.items()},
            {k: o[1] for k, o in out.items()},
            {k: o[2] for k, o in out.items()})


def test_defaults_compute_the_previous_port_update():
    """At the defaults (block-wise scale learning, preprocessing) the
    update is the previous port's, bit for bit, in place or not, while
    b^t agrees between its integer power and XLA's f32 pow (t = 1, 2).
    At t = 3 the integer power ``0.999 ** 3`` is one ulp from XLA's f32
    pow; the new pow of two 0-d f32 tensors is XLA's on the CPU for b2
    at every t up to 3000 and for b1 until b1^t is subnormal."""
    rng = np.random.default_rng(11)
    params = {k: torch.from_numpy(rng.normal(size=(6, 5)).astype(np.float32))
              for k in ("a", "b")}
    opt = tadamw.AdamW(lr=5e-4)
    st = opt.init(params)
    p_in = {k: v.clone() for k, v in params.items()}
    st_in = opt.init(p_in)
    prev = (params, st.mu, st.nu)
    for step in (1, 2):
        grads = {k: torch.from_numpy(rng.normal(size=(6, 5))
                                     .astype(np.float32)) for k in params}
        params, st = opt.update(grads, st, params)
        p_in, st_in = opt.update_(grads, st_in, p_in)
        prev = _previous_update(5e-4, grads, step, prev[1], prev[2], prev[0])
        for k in params:
            assert torch.equal(params[k], prev[0][k])
            assert torch.equal(p_in[k], prev[0][k])
            assert torch.equal(st.nu[k], prev[2][k])
            assert torch.equal(st_in.mu[k], prev[1][k])
    t = np.arange(1, 3001)
    for b, t_max in ((B2, 3000), (B1, 828)):
        xla = np.asarray(b ** jnp.asarray(t[:t_max]).astype(jnp.float32))
        new = [float(torch.pow(torch.tensor(b), torch.tensor(float(x))))
               for x in t[:t_max]]
        np.testing.assert_array_equal(np.float32(new), xla)
    old3 = float(torch.tensor(B2, dtype=torch.float32) ** 3)
    assert np.float32(old3) != np.asarray(B2 ** jnp.float32(3))


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_error_feedback_on_a_stacked_stage_matches_repro(kind):
    """30 rounds of compress with error feedback, bf16 and f32 leaves,
    on the same inputs in both packages: the sent gradients, their sum
    and the residual equal the reference's exactly."""
    rng = np.random.default_rng(12)
    ccfg_r = rcomp.CompressionConfig(kind=kind, topk_frac=0.3)
    ccfg_t = tcomp.CompressionConfig(kind=kind, topk_frac=0.3)
    tree = _stacked(rng)
    rg, _ = _both(tree)
    rg = dict(rg, embed=rg["embed"].astype(jnp.bfloat16))
    rres = rcomp.init_residual(rg)
    tres = tcomp.init_residual(bridge.params_from_repro(
        jax.tree.map(np.asarray, rg)))
    r_sum = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), rg)
    for _ in range(30):
        sent_r, rres = rcomp.compress(rg, rres, ccfg_r)
        sent_t, tres = tcomp.compress(
            bridge.params_from_repro(jax.tree.map(np.asarray, rg)), tres,
            ccfg_t)
        r_sum = jax.tree.map(lambda a, b: a + b.astype(jnp.float32), r_sum,
                             sent_r)
        for a, b in zip(pytree.leaves(bridge.params_to_repro(sent_t)),
                        jax.tree.leaves(sent_r)):
            assert a.dtype == (torch.bfloat16 if b.dtype == jnp.bfloat16
                               else torch.float32)
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))
    for a, b in zip(pytree.leaves(bridge.params_to_repro(tres)),
                    jax.tree.leaves(rres)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # a layer's absmax alone would give another scale: the stage is joint
    if kind == "int8":
        lone = tcomp._int8_scale([bridge.params_from_repro(
            jax.tree.map(np.asarray, rg))["stages"][0][0][0]["w"]])
        joint = jnp.max(jnp.abs(rg["stages"][0][0]["w"])) / 127.0 + 1e-12
        assert float(lone) != float(joint)


def test_wire_bytes_and_noop_match_repro():
    rg, tg = _both(_stacked(np.random.default_rng(13)))
    for kind in (None, "int8", "topk"):
        assert tcomp.wire_bytes(tg, tcomp.CompressionConfig(kind=kind)) == \
            rcomp.wire_bytes(rg, rcomp.CompressionConfig(kind=kind))
    # the int8 "+4" is per stacked leaf: 5 leaves, not 2 + 3·3
    assert tcomp.wire_bytes(tg, tcomp.CompressionConfig(kind="int8")) == \
        sum(x.numel() for x in pytree.leaves(tg)) + 4 * 5
    res = torch.zeros(())
    out, r2 = tcomp.compress(tg, res, tcomp.CompressionConfig(kind=None))
    assert out is tg and r2 is res
    # tuple nodes (a stage's pattern positions) survive, in the port's
    # per-layer layout
    tuples = {"stages": [[(torch.ones(4), torch.ones(2))] * 2],
              "x": torch.ones(3)}
    out, _ = tcomp.compress(tuples, tcomp.init_residual(tuples),
                            tcomp.CompressionConfig(kind="int8"))
    assert isinstance(out["stages"][0][1], tuple)


def test_supervisor_restart_path():
    calls = []
    state = {"v": 0}
    inj = FailureInjector(fail_at_steps=(3,))

    def restore():
        state["v"] = 2           # checkpointed value at step 2
        return 2

    def step(i):
        inj.maybe_fail(i)
        state["v"] = i + 1
        calls.append(i)

    sup = Supervisor(restore, max_restarts=2, log=lambda *_: None)
    end = sup.run(step, 0, 6)
    assert end == 6
    assert sup.restarts == 1
    assert calls == [0, 1, 2, 2, 3, 4, 5]
    assert state["v"] == 6


def test_supervisor_gives_up():
    def step(i):
        if i == 1:
            raise InjectedFailure("always")

    sup = Supervisor(lambda: 1, max_restarts=2, log=lambda *_: None)
    with pytest.raises(InjectedFailure):
        sup.run(step, 0, 4)
    assert sup.restarts == 3


def test_straggler_watchdog():
    wd = StragglerWatchdog(threshold=3.0)
    logs = []
    for i in range(20):
        wd.observe(i, 0.01, log=logs.append)
    wd.observe(20, 0.5, log=logs.append)
    assert wd.slow_steps == [20]
    assert len(logs) == 1
