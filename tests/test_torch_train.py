"""Port parity: the training path (``repro_torch.launch.train``) against
``repro.launch.train``.

Every multi-layer case runs a stage of at least 2 layers: the reference
stacks a stage's layers into one leaf, and its int8 absmax, top-k
threshold, ``wire_bytes`` and the clipping norm are taken per stacked
leaf, which a one-layer reduced stage would not tell from per layer.

Tolerances, each with its reason:
  * ``make_train_step`` over 3 steps (reduced tiny-lm with one stage of
    3 dense layers, f32-cast parameters, lr 1e-2 with the cosine
    schedule, weight decay and clipping): the losses within 2e-5
    (about 3e-6 relative; measured at most 1.05e-5, after two updates
    of the int8 case).  The parameters: every element within 2e-4 (2%
    of one lr step; measured at most 9.5e-5) but for "flips", at most
    1 in 5000 elements: an int8 code rounded at a .5 boundary, or a
    top-k threshold tie, on gradients one ulp apart sends Adam another
    way (measured: up to 10 of 176,576 elements, 1.9e-3 apart, in the
    int8 cases, none otherwise); and each leaf's update p3 − p0 within
    2e-3 relative in norm.  The two sides sum the same f32 products in
    other orders (XLA's fused dots and reductions against torch's); the
    clipping norm's leaf order is the reference's.
  * restart: the final loss within 1e-5 of the uninterrupted run's, the
    reference's own bound (``tests/test_fault_tolerance.py``).
  * both packages trained in bf16 from one checkpoint (tiny-lm, lr
    3e-3 after a one-step warm-up): per-step losses within 2e-2 (bf16
    has 8 bits of mantissa; the two frameworks round different
    intermediates: measured 1.5e-3 at the first step, before any
    update, and at most 8.8e-3 over 6 steps), while the loss itself
    moves by 0.49 with the first update (6.365 to 6.858) and spans
    6.36-6.94 over the window, so a frozen or miswired update parts the
    two by far more than the bound (the port run without its cosine
    schedule parts the last loss by 9.0e-2); each parameter leaf of the two
    final checkpoints within 0.25 of the leaf's update ``p6 - p0`` in
    norm (measured at most 0.135, a norm scale; a frozen update gives
    1); ``wire_bytes`` equal.
"""
import contextlib
import dataclasses
import io
import re
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as rstore  # noqa: E402
from repro.configs import registry as r_registry  # noqa: E402
from repro.configs.base import Stage as RStage  # noqa: E402
from repro.distributed.compression import CompressionConfig as RCC  # noqa: E402
from repro.distributed.compression import init_residual as r_init_residual  # noqa: E402
from repro.launch import train as rtrain  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.common import Parallel  # noqa: E402
from repro.optim.adamw import AdamW as RAdamW  # noqa: E402
from repro.optim.adamw import cosine_schedule as r_cosine  # noqa: E402
from repro_torch import bridge, pytree  # noqa: E402
from repro_torch.checkpoint import store as tstore  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.configs.base import Stage as TStage  # noqa: E402
from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus  # noqa: E402
from repro_torch.distributed.compression import CompressionConfig as TCC  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim.adamw import AdamW as TAdamW  # noqa: E402
from repro_torch.optim.adamw import cosine_schedule as t_cosine  # noqa: E402

N_LAYERS, BATCH, SEQ, STEPS, LR = 3, 4, 32, 3, 1e-2
LOSS_ATOL, P_ATOL, FLIP_FRAC, DELTA_RTOL = 2e-5, 2e-4, 2e-4, 2e-3
RESTART_ATOL, BF16_LOSS_ATOL, BF16_PARAM_RTOL = 1e-5, 2e-2, 0.25


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny models on one intra-op thread: under the suite's parallel
    workers, torch's thread pool on ops this small runs tens of times
    slower than one thread (measured: the restart test 3 s alone, 122 s
    beside six busy processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _cfgs():
    rcfg = dataclasses.replace(r_registry.get("tiny-lm").reduced(),
                               stages=(RStage(("dense",), N_LAYERS),))
    tcfg = dataclasses.replace(t_registry.get("tiny-lm").reduced(),
                               stages=(TStage(("dense",), N_LAYERS),))
    return rcfg, tcfg


@pytest.fixture(scope="module")
def f32_params():
    """Reference parameters (3-layer stage) cast to f32, numpy leaves."""
    rcfg, _ = _cfgs()
    p = RM.init_params(rcfg, Parallel(), jax.random.PRNGKey(0))
    return jax.tree.map(lambda x: np.asarray(x, np.float32), p)


def _batches():
    corpus = SyntheticCorpus(CorpusConfig(vocab=512, seed=0))
    return [next(corpus.batches(BATCH, SEQ, 1, host=s, n_hosts=1 << 30))
            for s in range(STEPS)]


@pytest.mark.parametrize("mb,remat", [(1, False), (2, True)],
                         ids=["mb1", "mb2-remat"])
@pytest.mark.parametrize("kind", [None, "int8", "topk"])
def test_train_step_matches_repro(f32_params, kind, mb, remat):
    rcfg, tcfg = _cfgs()
    ropt = RAdamW(lr=LR, weight_decay=0.01, clip_norm=1.0,
                  schedule=r_cosine(1, STEPS))
    topt = TAdamW(lr=LR, weight_decay=0.01, clip_norm=1.0,
                  schedule=t_cosine(1, STEPS))
    par = Parallel(microbatches=mb, remat=remat, sp=False)
    rp = jax.tree.map(jnp.asarray, f32_params)
    rstate = {"params": rp, "opt": ropt.init(rp),
              "residual": (r_init_residual(rp) if kind
                           else jnp.zeros((), jnp.float32))}
    tstate = ttrain.state_from_repro(jax.tree.map(np.asarray, rstate), "cpu")
    rstep = jax.jit(rtrain.make_train_step(rcfg, par, ropt,
                                           RCC(kind=kind, topk_frac=0.1)))
    tstep = ttrain.make_train_step(tcfg, topt, TCC(kind=kind, topk_frac=0.1),
                                   microbatches=mb, remat=remat)
    for s, (tok, tgt) in enumerate(_batches()):
        rstate, rm = rstep(rstate, {"tokens": jnp.asarray(tok),
                                    "targets": jnp.asarray(tgt)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(tok),
                                    "targets": torch.from_numpy(tgt)})
        assert abs(float(tm["loss"]) - float(rm["loss"])) <= LOSS_ATOL, s
    assert int(tstate["opt"].step) == int(rstate["opt"].step) == STEPS

    got = ttrain.state_to_repro(tstate)["params"]
    flips = total = 0
    for (key, t), r, p0 in zip(pytree.leaves_with_path(got),
                               jax.tree.leaves(rstate["params"]),
                               jax.tree.leaves(f32_params)):
        t, r = t.numpy(), np.asarray(r)
        assert t.shape == r.shape, key
        diff = np.abs(t - r)
        flips += int((diff > P_ATOL).sum())
        total += diff.size
        upd = np.linalg.norm(r - p0)
        assert np.linalg.norm(t - r) <= DELTA_RTOL * upd + 1e-12, key
    assert flips <= FLIP_FRAC * total, f"{flips} of {total} elements flipped"


def test_remat_keeps_the_loss_and_gradients(f32_params):
    """``forward_loss(remat=True)`` recomputes each superblock in the
    backward pass: the loss and every gradient are the same bits."""
    _, tcfg = _cfgs()
    tok, tgt = _batches()[0]
    batch = {"tokens": torch.from_numpy(tok), "targets": torch.from_numpy(tgt)}
    out = []
    for remat in (False, True):
        params = bridge.params_from_repro(f32_params)
        leaves = [p.requires_grad_(True) for p in pytree.leaves(params)]
        loss = TM.forward_loss(tcfg, params, batch, remat=remat)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def _args(*extra):
    return ttrain.parse_args(["--arch", "tiny-lm", "--steps", "12",
                              "--batch", "2", "--seq", "32",
                              "--log-every", "100", "--save-every", "4",
                              "--device", "cpu", *extra])


def test_restart_matches_uninterrupted_run(tmp_path):
    """tiny-lm unreduced (a 4-layer stage): a failure at step 9 restores
    the step-8 checkpoint and ends on the uninterrupted run's loss."""
    r1 = ttrain.run(_args("--ckpt-dir", str(tmp_path / "a")))
    r2 = ttrain.run(_args("--ckpt-dir", str(tmp_path / "b"),
                          "--fail-at-step", "9"))
    assert r1["restarts"] == 0 and r2["restarts"] == 1
    assert abs(r1["final_loss"] - r2["final_loss"]) <= RESTART_ATOL
    assert r1["first_loss"] == r2["first_loss"]


CROSS = ["--arch", "tiny-lm", "--steps", "6", "--batch", "2", "--seq", "32",
         "--compression", "int8", "--microbatches", "2", "--remat",
         "--warmup", "1", "--log-every", "1", "--save-every", "100",
         "--restore", "auto"]


@pytest.fixture(scope="module")
def cross_runs(tmp_path_factory):
    """Both packages' ``run`` from one step-0 checkpoint that ``repro``
    wrote (tiny-lm unreduced, int8 compression, 2 microbatches, remat):
    their summaries, per-step losses and checkpoint directories, and the
    step-0 parameters under ``"p0"``."""
    root = tmp_path_factory.mktemp("cross")
    rcfg = r_registry.get("tiny-lm")
    par = Parallel(microbatches=2, remat=True, sp=False)
    ropt = RAdamW(lr=3e-3, weight_decay=0.01, clip_norm=1.0,
                  schedule=r_cosine(1, 6))
    state0 = rtrain.init_state(rcfg, par, ropt, RCC(kind="int8"), seed=0)
    rstore.save_checkpoint(str(root / "r"), 0, state0)
    shutil.copytree(root / "r", root / "t")
    out = {"p0": jax.tree.leaves(state0["params"])}
    for name, mod, extra in (("r", rtrain, []), ("t", ttrain,
                                                  ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = mod.run(mod.parse_args(CROSS + ["--ckpt-dir",
                                                  str(root / name)] + extra))
        losses = [float(x) for x in re.findall(r"loss (\S+)", buf.getvalue())]
        out[name] = (res, losses, root / name)
    return out


def _final_params(ckpt_dir):
    template = rtrain.init_state(r_registry.get("tiny-lm"),
                                 Parallel(microbatches=2, remat=True,
                                          sp=False),
                                 RAdamW(), RCC(kind="int8"))
    state, step = rstore.restore_checkpoint(str(ckpt_dir), template)
    assert step == 6
    return jax.tree_util.tree_leaves_with_path(state["params"])


def test_both_packages_train_alike_from_one_checkpoint(cross_runs):
    (rres, rl, rdir), (tres, tl, tdir) = cross_runs["r"], cross_runs["t"]
    assert len(rl) == len(tl) == 6
    np.testing.assert_allclose(tl, rl, rtol=0, atol=BF16_LOSS_ATOL)
    assert tres["wire_bytes"] == rres["wire_bytes"]
    assert tres["restarts"] == rres["restarts"] == 0
    for (key, t), (_, r), p0 in zip(_final_params(tdir), _final_params(rdir),
                                    cross_runs["p0"]):
        t, r, p0 = (np.asarray(x, np.float32) for x in (t, r, p0))
        assert np.linalg.norm(t - r) <= (
            BF16_PARAM_RTOL * np.linalg.norm(r - p0)), \
            jax.tree_util.keystr(key)


def test_port_checkpoint_restores_into_repro_template(cross_runs):
    """The port's final checkpoint has the reference's paths, shapes and
    dtypes: it restores into ``repro.launch.train.init_state``'s
    template, bit-identical to what the port's store reads."""
    _, _, tdir = cross_runs["t"]
    _, _, rdir = cross_runs["r"]
    assert rstore.latest_step(str(tdir)) == 6
    rcfg = r_registry.get("tiny-lm")
    par = Parallel(microbatches=2, remat=True, sp=False)
    template = rtrain.init_state(rcfg, par, RAdamW(), RCC(kind="int8"))
    restored, step = rstore.restore_checkpoint(str(tdir), template)
    assert step == 6
    ref_final, _ = rstore.restore_checkpoint(str(rdir), template)
    tmeta = ttrain.state_to_repro(
        ttrain.init_state(t_registry.get("tiny-lm"), TAdamW(),
                          TCC(kind="int8")))
    ours, _ = tstore.restore_checkpoint(str(tdir), tmeta)
    for (key, a), b, c in zip(jax.tree_util.tree_leaves_with_path(restored),
                              pytree.leaves(ours), jax.tree.leaves(ref_final)):
        assert a.dtype == c.dtype, key
        a = np.asarray(a)
        b = b.view(torch.int16).numpy().view(np.uint16) \
            if b.dtype == torch.bfloat16 else b.numpy()
        np.testing.assert_array_equal(
            a.view(np.uint16) if a.dtype.name == "bfloat16" else a, b,
            err_msg=jax.tree_util.keystr(key))


def test_pod_mesh_and_missing_card_raise():
    """A production mesh needs its ranks (torchrun's WORLD_SIZE): one
    process raises, naming the count, and trains nothing on one device
    in silence."""
    with pytest.raises(ValueError, match="256 ranks"):
        ttrain.run(ttrain.parse_args(["--mesh", "pod", "--device", "cpu"]))
    with pytest.raises(ValueError, match="512 ranks"):
        ttrain.run(ttrain.parse_args(["--mesh", "multipod", "--device",
                                      "cpu"]))
    assert ttrain.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrain.run(ttrain.parse_args(["--reduced", "--steps", "1"]))
