"""Port parity: the sharded train step (``repro_torch.launch.train``
under a ``DeviceMesh``) against the port's one-device step, on four
gloo ranks of this machine's CPU.

The ranks are processes of ``tests/torch_dist_worker.py`` (torch and
the port only); this file holds the reference's side: it builds the
weights with ``repro`` and carries them across with the bridge, runs
the one-device step, and compares.  That one-device step equals the
reference's jitted step (``tests/test_torch_train.py``), so the sharded
step is held to the reference through it.  One launch of four ranks
runs every case, with a file rendezvous under the test's
``tmp_path``, a 60 s process-group timeout and a 240 s deadline after
which the ranks are killed.

The model is reduced qwen2.5-3b (d 64, 4 query / 2 KV heads of 16,
tied, qkv bias, vocab 512) with one stage of 3 dense layers, in f32,
lr 1e-2 with the cosine schedule (warm-up 1), weight decay and
clipping, 3 steps of 8 x 32 tokens, remat on.  Meshes (data, model):
(4, 1) and (2, 2) with FSDP, and (1, 4), where tp 4 > 2 KV heads
replicates them at run time; int8 compression with 2 microbatches on
(2, 2) and top-k (10%) on (4, 1), whose threshold over a leaf sharded
on data is the bisection of ``distributed/compression.py``.  A variant
(q/k norms, an untied head, vocab 500 padded to 512, so the last
vocabulary shard holds padding) runs 3 steps on (2, 2) and (1, 4).
Tolerances are those of ``tests/test_torch_train.py``, whose reasons
hold here: the only difference is the order of f32 sums across ranks.
Losses within 2e-5; every parameter element within 2e-4 but for at
most 1 in 5000 "flips"; each leaf's update p3 - p0 within 2e-3
relative in norm.  The first step's gradients, gathered, within 1e-5
relative in norm per leaf.  Measured (``python
tests/test_torch_dist_train.py`` prints every case's gaps): losses
within 9.5e-7, gradients 2.1e-6, parameters 8.5e-5 but 3.4e-4 in the
int8 case and 2.6e-4 in the variant on (2, 2) (one element beyond
2e-4 in 144,192 and in 177,056), updates within 3.0e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_dist_worker as W  # noqa: E402

from repro.checkpoint import store as rstore  # noqa: E402
from repro.configs import registry as r_registry  # noqa: E402
from repro.configs.base import Stage as RStage  # noqa: E402
from repro.distributed.compression import CompressionConfig as RCC  # noqa: E402
from repro.launch import train as rtrain  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.common import Parallel  # noqa: E402
from repro.optim.adamw import AdamW as RAdamW  # noqa: E402
from repro_torch import bridge, pytree  # noqa: E402
from repro_torch.checkpoint import store as tstore  # noqa: E402
from repro_torch.distributed.compression import CompressionConfig as TCC  # noqa: E402
from repro_torch.distributed.compression import wire_bytes  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

N_LAYERS, BATCH, SEQ, STEPS, LR = 3, 8, 32, 3, 1e-2
LOSS_ATOL, P_ATOL, FLIP_FRAC, DELTA_RTOL = 2e-5, 2e-4, 2e-4, 2e-3
GRAD_RTOL = 1e-5
VARIANT = {"qk_norm": True, "tied_embeddings": False, "vocab": 500}
CASES = {
    "m41_fsdp": {"mesh": (4, 1), "fsdp": True, "mb": 1, "kind": None},
    "m22_fsdp": {"mesh": (2, 2), "fsdp": True, "mb": 1, "kind": None},
    "m14": {"mesh": (1, 4), "fsdp": False, "mb": 1, "kind": None},
    "m22_mb2_int8": {"mesh": (2, 2), "fsdp": True, "mb": 2, "kind": "int8"},
    "m41_fsdp_topk": {"mesh": (4, 1), "fsdp": True, "mb": 1, "kind": "topk"},
    "var_m22_fsdp": {"mesh": (2, 2), "fsdp": True, "mb": 1, "kind": None,
                     "cfg": VARIANT},
    "var_m14": {"mesh": (1, 4), "fsdp": False, "mb": 1, "kind": None,
                "cfg": VARIANT},
}
CKPT_ARGV = ["--arch", "qwen2.5-3b", "--reduced", "--steps", "2",
             "--batch", "8", "--seq", "32", "--fsdp", "--device", "cpu",
             "--save-every", "100", "--warmup", "1", "--log-every", "100",
             "--lr", "3e-3"]


def _repro_cfg(over):
    cfg = dataclasses.replace(r_registry.get("qwen2.5-3b").reduced(),
                              stages=(RStage(("dense",), N_LAYERS),))
    return dataclasses.replace(cfg, **over)


def _port_params(over):
    """The reference's parameters for the case's config, f32, as the
    port's tree."""
    p = RM.init_params(_repro_cfg(over), Parallel(), jax.random.PRNGKey(0))
    return bridge.params_from_repro(
        jax.tree.map(lambda x: np.asarray(x, np.float32), p))


def _one_device(case, params):
    """The port's one-device step from ``params``: first-step loss and
    gradients, per-step losses, final params."""
    cfg = W.qwen_cfg(**case.get("cfg", {}))
    data = W.batches(cfg.vocab, BATCH, SEQ, STEPS)
    loss0, grads = ttrain._loss_and_grads(cfg, params, data[0], 1024, True)
    ccfg = TCC(kind=case["kind"])
    opt = W.optimizer(STEPS, LR)
    state = W._state(pytree.tree_map(torch.clone, params), opt, ccfg)
    step = ttrain.make_train_step(cfg, opt, ccfg, case["mb"], True, 1024)
    losses = []
    for b in data:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return {"loss0": float(loss0), "grads": grads, "losses": losses,
            "params": state["params"]}


def collect(tmp):
    """Every case on four gloo ranks in one launch, and the one-device
    results to hold them against."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        params = {}
        cases = {}
        for name, c in CASES.items():
            key = tuple(sorted(c.get("cfg", {}).items()))
            if key not in params:
                params[key] = _port_params(c.get("cfg", {}))
            cases[name] = dict(c, task="train", cfg=c.get("cfg", {}),
                               params=params[key], steps=STEPS, lr=LR,
                               batch=BATCH, seq=SEQ)
        cases["ckpt"] = {"task": "ckpt", "dir": str(tmp / "ckpt"),
                         "argv": CKPT_ARGV + ["--ckpt-dir",
                                              str(tmp / "ckpt")]}
        cases["refusals"] = {"task": "refusals"}
        cases["hints"] = {"task": "hints", "x": torch.arange(
            2 * 4 * 6, dtype=torch.float32).reshape(2, 4, 6)}
        ranks = W.launch(cases, tmp)
        single = {name: _one_device(
            c, params[tuple(sorted(c.get("cfg", {}).items()))])
            for name, c in CASES.items()}
    finally:
        torch.set_num_threads(n)
    return {"ranks": ranks, "single": single, "params": params,
            "tmp": tmp}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return collect(tmp_path_factory.mktemp("dist_train"))


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t))


def gaps(runs, name: str) -> dict:
    """The sharded case's gaps to the one-device step: the first loss,
    the largest per-leaf relative gradient gap, the per-step losses,
    the largest parameter element gap, the elements past ``P_ATOL``
    (of how many), and the largest leaf gap over its update's norm."""
    got, want = runs["ranks"][0][name], runs["single"][name]
    p0 = runs["params"][tuple(sorted(CASES[name].get("cfg", {}).items()))]
    out = {"loss0": abs(got["loss0"] - want["loss0"]), "grad_rel": 0.0,
           "losses": max(abs(a - b) for a, b in zip(got["losses"],
                                                   want["losses"])),
           "param": 0.0, "flips": 0, "elements": 0, "update_ratio": 0.0}
    for g, w in zip(pytree.leaves(got["grads"]), pytree.leaves(want["grads"])):
        assert g.shape == w.shape
        out["grad_rel"] = max(out["grad_rel"],
                              _norm(g - w) / max(_norm(w), 1e-30))
    for t, r, a in zip(pytree.leaves(got["params"]),
                       pytree.leaves(want["params"]), pytree.leaves(p0)):
        diff = (t - r).abs()
        out["param"] = max(out["param"], float(diff.max()))
        out["flips"] += int((diff > P_ATOL).sum())
        out["elements"] += diff.numel()
        out["update_ratio"] = max(out["update_ratio"],
                                  _norm(t - r) / max(_norm(r - a), 1e-30))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_one_device(runs, name):
    got = runs["ranks"][0][name]
    assert len(got["losses"]) == STEPS
    g = gaps(runs, name)
    assert g["loss0"] <= LOSS_ATOL and g["losses"] <= LOSS_ATOL, g
    assert g["grad_rel"] <= GRAD_RTOL, g
    assert g["update_ratio"] <= DELTA_RTOL, g
    assert g["flips"] <= FLIP_FRAC * g["elements"], g
    for r in runs["ranks"][1:]:                  # every rank saw one loss
        assert r[name]["losses"] == got["losses"]


def test_replicated_parts_are_equal_on_every_rank(runs):
    """A part that two ranks both hold (a leaf, or a shard, replicated
    over some mesh dim) has the same bits on both, in the first step's
    gradient and after the last step."""
    for name in CASES:
        per_rank = [r[name] for r in runs["ranks"]]
        for field in ("grad_locals", "locals"):
            for i, (key, _, places) in enumerate(per_rank[0][field]):
                groups = {}
                for r in per_rank:
                    k2, t, p2 = r[field][i]
                    assert (k2, p2) == (key, places)
                    coord = tuple(c for c, pl in zip(r["coords"],
                                                     places.split(","))
                                  if "Shard" in pl)
                    groups.setdefault(coord, []).append(t)
                for parts in groups.values():
                    for t in parts[1:]:
                        assert torch.equal(t, parts[0]), (name, field, key)


def test_checkpoint_of_a_mesh_run_loads_in_both_packages(runs):
    """``run`` on (2, 2) with FSDP wrote its state once, gathered: it
    restores into the one-device port and through the reference's
    ``restore_checkpoint`` with the same bytes, and the port writes it
    back byte for byte."""
    ckpt = runs["tmp"] / "ckpt"
    res = runs["ranks"][0]["ckpt"]["run"]
    assert np.isfinite(res["final_loss"]) and res["restarts"] == 0
    assert tstore.latest_step(str(ckpt)) == 2
    tcfg = dataclasses.replace(W.qwen_cfg(1), vocab=512)
    template = ttrain.init_state(tcfg, W.optimizer(2, 3e-3), TCC())
    assert res["wire_bytes"] == wire_bytes(template["params"], TCC())
    ours, step = ttrain.restore_state(str(ckpt), template)
    assert step == 2
    rcfg = dataclasses.replace(r_registry.get("qwen2.5-3b").reduced(),
                               vocab=512)
    rtpl = rtrain.init_state(rcfg, Parallel(), RAdamW(), RCC())
    theirs, rstep = rstore.restore_checkpoint(str(ckpt), rtpl)
    assert rstep == 2
    mine = ttrain.state_to_repro(ours)
    for (key, a), b in zip(jax.tree_util.tree_leaves_with_path(theirs),
                           pytree.leaves(mine)):
        a = np.asarray(a)
        b = b.view(torch.int16).numpy().view(np.uint16) \
            if b.dtype == torch.bfloat16 else b.numpy()
        np.testing.assert_array_equal(
            a.view(np.uint16) if a.dtype.name == "bfloat16" else a, b,
            err_msg=jax.tree_util.keystr(key))
    again = runs["tmp"] / "again"
    ttrain.save_state(str(again), 2, ours)
    for f in sorted((ckpt / "step_00000002").iterdir()):
        assert f.read_bytes() == (again / "step_00000002" /
                                  f.name).read_bytes(), f.name


def test_checkpoint_restores_into_another_mesh(runs):
    """The (2, 2) checkpoint restored into a (1, 4) state holds the
    one-device restore's bits."""
    ckpt = runs["tmp"] / "ckpt"
    tcfg = dataclasses.replace(W.qwen_cfg(1), vocab=512)
    ours, _ = ttrain.restore_state(
        str(ckpt), ttrain.init_state(tcfg, W.optimizer(2, 3e-3), TCC()))
    got = runs["ranks"][0]["ckpt"]
    assert got["step"] == 2
    for a, (key, b) in zip(got["restored"], pytree.leaves_with_path(ours)):
        assert a.dtype == b.dtype and torch.equal(a, b), key


def test_mesh_runs_refuse_what_they_cannot_run(runs):
    """Nothing falls back to one device or an unsharded step: a mesh
    of the wrong size or device type, packed (QLinear) parameters, a
    d_ff that does not split over tp, and a missing card raise.  Head
    counts that tp does not divide (recurrentgemma's 10 query heads at
    tp 4, 6 heads over 2 KV heads) are accepted: each rank computes its
    whole heads (``Shards.heads``)."""
    assert runs["ranks"][0]["refusals"] == {
        "world": "ValueError", "device": "ValueError",
        "packed": "NotImplementedError", "rg_heads": None,
        "uneven": None, "d_ff": "ValueError",
        "device_arg": ("RuntimeError" if not torch.cuda.is_available()
                       else "ValueError")}


def test_hints_on_a_mesh(runs):
    """Under ``use_mesh`` of (2, 2), ``hint_act`` puts a DTensor's batch
    over data and, with sequence parallelism, its sequence over
    "model"; a local tensor, and anything off the mesh, stays as it
    is."""
    for r in runs["ranks"]:
        h = r["hints"]
        assert h["off"] and h["local"] and h["full"]
        assert h["act"] == ("(Shard(dim=0), Shard(dim=1))", (1, 2, 6))
        assert h["batch_spec"] == ("data", None)


if __name__ == "__main__":
    # the measured gaps of every case: python tests/test_torch_dist_train.py
    import json
    import tempfile
    from pathlib import Path
    with tempfile.TemporaryDirectory() as d:
        measured = collect(Path(d))
        print(json.dumps({n: gaps(measured, n) for n in CASES}, indent=1))
