"""Port parity: the sharded train step for every block kind and the
encoder-decoder model, on four gloo ranks of the CPU.

The ranks are processes of ``tests/torch_dist_worker.py`` (torch and
the port only), one launch for every case (a file rendezvous under the
test's ``tmp_path``, a 60 s process-group timeout and a 240 s deadline).
This file builds the weights with ``repro`` (``PRNGKey(0)``, f32) and
carries them across with the bridge.  The models are the reduced
configs, in f32, remat on, lr ``LR`` with the cosine schedule (warm-up
1), weight decay and clipping, batches of 8 x 32 tokens:

* granite-moe-1b-a400m (one moe layer, 4 experts, top-2).  On (1, 4)
  with EP (the experts over "model", resharded to their ffn parts at
  use) the MoE routes the whole batch, as one device does.  On (2, 2)
  each data rank routes its own rows with the capacity of their count,
  the reference's group-local ``_apply_moe_shard_map``: the first
  step, with EP and FSDP and with ``ep=False``, against the
  reference under the same mesh, whose loss itself parts from the
  whole-batch one-device loss by more than 1e-3.  Where the reference
  keeps the whole-batch MoE under a mesh (rows of one token), so does
  the port: (2, 2) with EP and FSDP at 256 x 1 tokens against the
  one-device step (enough tokens that the capacity of a data rank's
  half drops other slots than the whole batch's does).
* recurrentgemma-2b (rglru, rglru, local, then rglru; rnn 64, 8 gate
  heads, 4 query heads over 1 KV head), xlstm-1.3b (7 mlstm and 1
  slstm, 4 heads) and seamless-m4t-medium (2 encoder layers and 1
  decoder layer, frames 8 x 16 made by numpy from a seed), each on
  (2, 2) with FSDP and on (1, 4).

Every case of ``CASES`` holds its first step's loss and gradients
against the reference's ``jax.value_and_grad(forward_loss)`` under the
same mesh of four host CPU devices (``tests/jax_mesh_ref.py``, a
process per arch started beside the ranks), and then 3 steps against
the port's one-device step.  Bounds are those of
``tests/test_torch_dist_train.py``, whose reasons hold here: the first
loss within 2e-5 and the first step's gradients within 1e-5 relative
in norm per leaf; over the steps, losses within 2e-5, every parameter
element within 2e-4 but for at most 1 in 5000, and each leaf's update
p3 - p0 within 2e-3 relative in norm.  The xLSTM's gradients are held
within 5e-5 and its updates within 1e-2: its 8 blocks amplify the
order of f32 sums (ROADMAP ground rules; the reference itself parts by
1.3e-5 between a mesh and one device on this model, and the port's
one-device f32 step parts from the same step in f64 by 1.8e-5 in its
gradients and 2.3e-3 in its updates).  The learning rate is 1e-2 but
1e-3 for seamless and 1e-4 for the xLSTM: at 1e-2 Adam's first step
turns the sign of a gradient element at rounding into a whole step of
lr, and after 3 steps their one-device f32 losses part from f64 by
2.7e-4 and 3.6e-3; at these rates by 4.8e-7 and 1.4e-6.  Measured
(``python tests/test_torch_dist_kinds.py`` prints every gap): against
the reference, losses within 1.4e-6 and gradients within 2.2e-6, the
xLSTM's 2.0e-5; against one device after 3 steps, losses within 1.4e-6,
at most 3 elements past 2e-4, updates within 6.7e-4, the xLSTM's
2.1e-3.  The group-local MoE parts from the reference under the (2, 2)
mesh by 4.8e-7 in its loss and 1.0e-6 in its gradients, and both
packages' mesh losses part from the whole-batch one by 2.0e-3; at
256 x 1 tokens the sharded step parts from one device by 4.8e-7 (loss)
and 5.7e-7 (gradients).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax_mesh_ref as JR  # noqa: E402
import torch_dist_worker as W  # noqa: E402

from repro_torch import bridge, pytree  # noqa: E402
from repro_torch.distributed.compression import CompressionConfig  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

BATCH, SEQ, STEPS, ENC_FRAMES = 8, 32, 3, 16
LOSS_ATOL, P_ATOL, FLIP_FRAC, DELTA_RTOL = 2e-5, 2e-4, 2e-4, 2e-3
GRAD_RTOL = 1e-5
XL_GRAD_RTOL, XL_DELTA_RTOL = 5e-5, 1e-2
GROUP_GAP = 1e-3
MOE = "granite-moe-1b-a400m"
ARCHS = {"moe": MOE, "rg": "recurrentgemma-2b", "xl": "xlstm-1.3b",
         "s2t": "seamless-m4t-medium"}
# per arch, the largest of 1e-2, 1e-3, 1e-4 at which the one-device f32
# step stays within LOSS_ATOL of the same step in f64 over STEPS steps
LR = {"moe": 1e-2, "rg": 1e-2, "s2t": 1e-3, "xl": 1e-4}
# the first step against the reference under the same mesh, then STEPS
# steps against the port's one-device step
CASES = {
    "moe_m14_ep": {"arch": "moe", "mesh": (1, 4), "fsdp": False, "ep": True},
    "rg_m22_fsdp": {"arch": "rg", "mesh": (2, 2), "fsdp": True},
    "rg_m14": {"arch": "rg", "mesh": (1, 4), "fsdp": False},
    "xl_m22_fsdp": {"arch": "xl", "mesh": (2, 2), "fsdp": True},
    "xl_m14": {"arch": "xl", "mesh": (1, 4), "fsdp": False},
    "s2t_m22_fsdp": {"arch": "s2t", "mesh": (2, 2), "fsdp": True},
    "s2t_m14": {"arch": "s2t", "mesh": (1, 4), "fsdp": False},
}
# the group-local MoE, held against the reference under the same mesh
REF_CASES = {
    "moe_m22_ep_fsdp": {"arch": "moe", "mesh": (2, 2), "fsdp": True,
                        "ep": True},
    "moe_m22": {"arch": "moe", "mesh": (2, 2), "fsdp": False, "ep": False},
}
# rows of one token: the whole-batch MoE under a mesh, as in the reference
WHOLE_CASES = {
    "moe_m22_s1": {"mesh": (2, 2), "fsdp": True, "ep": True, "batch": 256,
                   "seq": 1},
}


def grad_rtol(arch_key: str) -> float:
    """The first step's per-leaf gradient bound: GRAD_RTOL, but for the
    xLSTM, whose 8 blocks amplify the order of f32 sums (the reference
    itself parts by 1.3e-5 between a (2, 2) mesh and one device)."""
    return XL_GRAD_RTOL if arch_key == "xl" else GRAD_RTOL


def delta_rtol(arch_key: str) -> float:
    """The bound on a leaf's gap over its update's norm after STEPS
    steps: DELTA_RTOL, but for the xLSTM, where Adam's first step turns
    an element whose gradient is at that rounding into a whole step of
    lr either way (the one-device f32 step parts so from f64 by
    2.3e-3)."""
    return XL_DELTA_RTOL if arch_key == "xl" else DELTA_RTOL


def _frames(arch: str, d_model: int):
    """Per step, the encoder's stub frames (B, ENC_FRAMES, D), or None."""
    if arch != "s2t":
        return None
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.standard_normal(
        (STEPS, BATCH, ENC_FRAMES, d_model)).astype(np.float32))


def _worker_case(c, params, steps):
    key = c["arch"]
    arch = ARCHS[key]
    return {"task": "train", "arch": arch, "mesh": c["mesh"],
            "fsdp": c["fsdp"], "ep": c.get("ep", False), "mb": 1,
            "kind": None, "params": params, "steps": steps, "lr": LR[key],
            "batch": c.get("batch", BATCH), "seq": c.get("seq", SEQ),
            "frames": _frames(key, W.arch_cfg(arch).d_model)}


def _one_device(arch_key, params):
    """The port's one-device f32 step from ``params``: first-step loss
    and gradients, per-step losses, final params."""
    arch = ARCHS[arch_key]
    cfg = W.arch_cfg(arch)
    case = {"batch": BATCH, "seq": SEQ, "steps": STEPS,
            "frames": _frames(arch_key, cfg.d_model)}
    data = W.case_batches(cfg, case)
    loss0, grads = ttrain._loss_and_grads(cfg, params, data[0], 1024, True)
    ccfg = CompressionConfig(kind=None)
    opt = W.optimizer(STEPS, LR[arch_key])
    state = W._state(pytree.tree_map(torch.clone, params), opt, ccfg)
    step = ttrain.make_train_step(cfg, opt, ccfg, 1, True, 1024)
    losses = []
    for b in data:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return {"loss0": float(loss0), "grads": grads, "losses": losses,
            "params": state["params"]}


def _ref_runs():
    """{name: case} of every run of the reference under a mesh."""
    return {**{n: dict(c, ep=c.get("ep", False)) for n, c in CASES.items()},
            **REF_CASES}


def _reference(tmp, rparams):
    """The reference's (loss, gradients as the port's tree) of each run
    of :func:`_ref_runs`, read from the files of ``jax_mesh_ref``."""
    out = {}
    for name, c in _ref_runs().items():
        treedef = jax.tree.structure(rparams[c["arch"]])
        z = np.load(tmp / f"{name}.npz")
        leaves = [z[f"g{i}"] for i in range(treedef.num_leaves)]
        out[name] = (float(z["loss"]), bridge.params_from_repro(
            jax.tree.unflatten(treedef, leaves)))
    return out


def collect(tmp):
    """Every case on four gloo ranks in one launch, beside the
    reference's mesh runs (a process of four host devices per arch);
    then the one-device results."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    refs = []
    try:
        for key, arch in ARCHS.items():
            frames = _frames(key, W.arch_cfg(arch).d_model)
            refs.append(JR.start(
                tmp, arch, BATCH, SEQ,
                [(name, *c["mesh"], c["fsdp"], c["ep"])
                 for name, c in _ref_runs().items() if c["arch"] == key],
                None if frames is None else frames[0].numpy()))
        rparams = {k: JR.params_f32(JR.reduced(a)) for k, a in ARCHS.items()}
        params = {k: bridge.params_from_repro(p) for k, p in rparams.items()}
        cases = {name: _worker_case(c, params[c["arch"]], STEPS)
                 for name, c in CASES.items()}
        cases.update({name: _worker_case(c, params["moe"], 0)
                      for name, c in REF_CASES.items()})
        cases.update({name: _worker_case(dict(c, arch="moe"), params["moe"],
                                         0)
                      for name, c in WHOLE_CASES.items()})
        ranks = W.launch(cases, tmp)
        single = {k: _one_device(k, params[k]) for k in ARCHS}
        cfg = W.arch_cfg(MOE)
        whole = {}
        for name, c in WHOLE_CASES.items():
            b = W.case_batches(cfg, {"batch": c["batch"], "seq": c["seq"],
                                     "steps": 0})[0]
            whole[name] = ttrain._loss_and_grads(cfg, params["moe"], b, 1024,
                                                 True)
        for ref in refs:
            JR.finish(ref, 150.0)
    finally:
        for proc, _ in refs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        torch.set_num_threads(n)
    return {"ranks": ranks, "single": single, "params": params,
            "whole": whole, "reference": _reference(tmp, rparams)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return collect(tmp_path_factory.mktemp("dist_kinds"))


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t))


def grad_gap(got, want) -> float:
    """The largest per-leaf relative gap of two gradient trees."""
    worst = 0.0
    for g, w in zip(pytree.leaves(got), pytree.leaves(want)):
        assert g.shape == w.shape
        worst = max(worst, _norm(g - w) / max(_norm(w), 1e-30))
    return worst


def gaps(runs, name: str) -> dict:
    """A CASES case's gaps to the one-device step: the first loss, the
    largest per-leaf relative gradient gap, the per-step losses, the
    largest parameter element gap, the elements past ``P_ATOL`` (of how
    many), and the largest leaf gap over its update's norm."""
    key = CASES[name]["arch"]
    got, want = runs["ranks"][0][name], runs["single"][key]
    out = {"loss0": abs(got["loss0"] - want["loss0"]),
           "grad_rel": grad_gap(got["grads"], want["grads"]),
           "losses": max(abs(a - b) for a, b in zip(got["losses"],
                                                   want["losses"])),
           "param": 0.0, "flips": 0, "elements": 0, "update_ratio": 0.0}
    for t, r, a in zip(pytree.leaves(got["params"]),
                       pytree.leaves(want["params"]),
                       pytree.leaves(runs["params"][key])):
        diff = (t - r).abs()
        out["param"] = max(out["param"], float(diff.max()))
        out["flips"] += int((diff > P_ATOL).sum())
        out["elements"] += diff.numel()
        out["update_ratio"] = max(out["update_ratio"],
                                  _norm(t - r) / max(_norm(r - a), 1e-30))
    return out


def ref_gaps(runs, name: str) -> dict:
    """A run's first-step gaps to the reference under the same mesh, and
    both losses' gaps to the whole-batch one-device loss."""
    got = runs["ranks"][0][name]
    loss, grads = runs["reference"][name]
    whole = runs["single"][_ref_runs()[name]["arch"]]["loss0"]
    return {"loss0": abs(got["loss0"] - loss),
            "grad_rel": grad_gap(got["grads"], grads),
            "ref_vs_whole": abs(loss - whole),
            "port_vs_whole": abs(got["loss0"] - whole)}


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_kind_matches_one_device(runs, name):
    """The first step's loss and every gradient leaf are the reference's
    under the same mesh; over STEPS steps the losses and parameters are
    the port's one-device step's (test_torch_dist_train.py's bounds)."""
    key = CASES[name]["arch"]
    r = ref_gaps(runs, name)
    assert r["loss0"] <= LOSS_ATOL, r
    assert r["grad_rel"] <= grad_rtol(key), r
    got = runs["ranks"][0][name]
    assert len(got["losses"]) == STEPS
    g = gaps(runs, name)
    assert g["loss0"] <= LOSS_ATOL, g
    assert g["grad_rel"] <= grad_rtol(key), g
    assert g["losses"] <= LOSS_ATOL, g
    assert g["update_ratio"] <= delta_rtol(key), g
    assert g["flips"] <= FLIP_FRAC * g["elements"], g
    for rk in runs["ranks"][1:]:                 # every rank saw one loss
        assert rk[name]["losses"] == got["losses"]


@pytest.mark.parametrize("name", list(REF_CASES))
def test_group_local_moe_matches_the_reference_under_a_mesh(runs, name):
    """With data 2 the first step's loss and every gradient leaf are the
    reference's under the same (2, 2) mesh, EP or not."""
    g = ref_gaps(runs, name)
    assert g["loss0"] <= LOSS_ATOL, g
    assert g["grad_rel"] <= GRAD_RTOL, g


def whole_gaps(runs, name: str) -> dict:
    """A WHOLE_CASES case's gaps to the one-device step on its batch."""
    got = runs["ranks"][0][name]
    loss, grads = runs["whole"][name]
    return {"loss0": abs(got["loss0"] - float(loss)),
            "grad_rel": grad_gap(got["grads"], grads)}


def test_moe_is_group_local_where_the_reference_is(runs):
    """The mesh loss of the MoE parts from the whole-batch one-device
    loss, in both packages: the test above holds the group-local
    function, not the one-device one.  With rows of one token the
    reference keeps the whole-batch function under the mesh, and the
    port's sharded step equals the one-device step."""
    for name in REF_CASES:
        g = ref_gaps(runs, name)
        assert g["ref_vs_whole"] > GROUP_GAP, g
        assert g["port_vs_whole"] > GROUP_GAP, g
    for name in WHOLE_CASES:
        g = whole_gaps(runs, name)
        assert g["loss0"] <= LOSS_ATOL and g["grad_rel"] <= GRAD_RTOL, g


def test_moe_routing_is_equal_across_model_ranks(runs):
    """Every model rank of a data rank routes its rows alike: the same
    ``keep`` and ``dest_e`` bits in every dispatch of the first step
    (forward and its recomputation)."""
    for name in ("moe_m14_ep",) + tuple(REF_CASES):
        by_data = {}
        for r in runs["ranks"]:
            res = r[name]
            assert res["routes"], name
            by_data.setdefault(res["coords"][0], []).append(res["routes"])
        assert len(by_data) == _ref_runs()[name]["mesh"][0]
        for per_rank in by_data.values():
            for other in per_rank[1:]:
                assert len(other) == len(per_rank[0])
                for (k0, e0), (k1, e1) in zip(per_rank[0], other):
                    assert torch.equal(k0, k1) and torch.equal(e0, e1), name


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


if __name__ == "__main__":
    # the measured gaps of every case: python tests/test_torch_dist_kinds.py
    import json
    import tempfile
    import time
    from pathlib import Path
    with tempfile.TemporaryDirectory() as d:
        t0 = time.monotonic()
        measured = collect(Path(d))
        print(json.dumps({"seconds": time.monotonic() - t0,
                          **{n: gaps(measured, n) for n in CASES},
                          **{"ref_" + n: ref_gaps(measured, n)
                             for n in _ref_runs()},
                          **{n: whole_gaps(measured, n)
                             for n in WHOLE_CASES}},
                         indent=1))
