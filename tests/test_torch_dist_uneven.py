"""Port parity: tensor parallelism over head counts that tp does not
divide, in the sharded train step and in sharded serving, on four gloo
ranks of this machine's CPU at (1, 4), against the reference under the
same (1, 4) mesh of host devices (``tests/jax_mesh_ref.py``).

Three reduced configs reproduce the cuts of the production
architectures at tp 16 (``models.model.check_shardable`` refused them
before) at tp 4:

* ``phi``: phi4-mini-3.8b with 6 query heads over 2 KV heads.  The
  run-time KV heads stay 2 (``kv_heads_run(2, 6)`` at tp 4), so the
  decode caches take the "ctx" layout (each rank every KV head over
  12 of the 48 slots); ranks 0-2 hold 2 query heads, rank 3 none (as
  phi4-mini's 24 over 16: 2 on ranks 0-11, none on 12-15).
* ``rg``: recurrentgemma-2b with 6 query heads (run-time KV 3, "ctx"
  local caches of 8 of the 32 window slots) and ``RG_HEADS`` 2 (each
  gate head of 32 channels cut in two by the ranks' 16, as 8 heads of
  320 over 16 ranks of 160).  ``RG_HEADS`` is a module attribute of
  both packages, set at run time in every process that builds or runs
  the model (``torch_dist_worker.rg_heads``, ``jax_mesh_ref.rg_heads``)
  and restored after; no file of ``src/repro`` changes.
* ``xl``: xlstm-1.3b with 2 heads: ranks 2-3 hold no mLSTM head (as 4
  over 16).

Weights are the reference's (``PRNGKey(0)``, f32), carried across by
the bridge; the packed ones are its data-free PTQ1.61, unfused (ratio
0.2, multiple 8, min_dim 32; ``jax_mesh_ref.serve_params``).  Every
case runs in one launch of four ranks (a file rendezvous under the
test's ``tmp_path``, a 60 s process-group timeout, a 240 s deadline),
beside one process of the reference per config.

Tolerances, as ``tests/test_torch_dist_kinds.py`` and
``tests/test_torch_dist_serve_kinds.py`` derive them:

* The first train step (8 x 32 tokens): the loss within 2e-5 and each
  gradient leaf within 1e-5 relative in norm (the xLSTM's 5e-5: its 8
  blocks amplify the order of f32 sums, and the reference itself parts
  by 1.3e-5 between a mesh and one device).
* Serving (four left-padded prompts of up to 32 tokens, ring caches of
  48, 4 greedy steps): on the f32 weights within 1e-4 of the
  reference's largest logit; on the packed weights within 2e-3 of the
  port's own one-device gap to the same reference run (a rank's heads
  sum in another order than one device's, and a packed product's
  output can straddle a bf16 rounding, as on one device against the
  reference).  Greedy tokens equal, or a near-tie shown: where they
  part, the reference's top-2 gap at that step lies within the
  tolerance.

Each rank's caches after the prefill and after every step have the
local shapes of ``launch.inputs.decode_inputs``' specs, and a part that
two ranks hold alike has the same bits on both; a rank that holds no
head has packed query views of no column, and the views' columns of a
leaf add up to its N.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax_mesh_ref as JR  # noqa: E402
import torch_dist_worker as W  # noqa: E402

from repro_torch import bridge, pytree  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.core.select import map_tree  # noqa: E402
from repro_torch.distributed.sharding import Rules, at  # noqa: E402
from repro_torch.launch import inputs as TI  # noqa: E402
from repro_torch.models.common import Parallel  # noqa: E402

MESH = (1, 4)
BATCH, SEQ = 8, 32
LOSS_ATOL, GRAD_RTOL, XL_GRAD_RTOL = 2e-5, 1e-5, 5e-5
ATOL, DENSE_RTOL = 2e-3, 1e-4
# config: (architecture, overridden fields, RG_HEADS or None)
CONFIGS = {"phi": ("phi4-mini-3.8b", {"n_heads": 6, "n_kv_heads": 2}, None),
           "rg": ("recurrentgemma-2b", {"n_heads": 6}, 2),
           "xl": ("xlstm-1.3b", {"n_heads": 2}, None)}
LENS, BUCKET, MAX_SEQ, STEPS, CHUNK = (32, 21, 9, 27), 32, 48, 4, 1024
QCFG = dict(ratio=JR.SERVE_QUANT[0], multiple=JR.SERVE_QUANT[1])


def spec(key: str) -> str:
    """The reference's ARCH argument of a config."""
    arch, over, rg = CONFIGS[key]
    return JR.arch_spec(arch, dict(over, **({"rg_heads": rg} if rg else {})))


def port_cfg(key: str):
    arch, over, _ = CONFIGS[key]
    return W.kind_cfg({"arch": arch, "over": over})


def _prompts():
    rng = np.random.default_rng(7)
    toks = np.zeros((len(LENS), BUCKET), np.int32)
    pos = np.full((len(LENS), BUCKET), -1, np.int32)
    for i, n in enumerate(LENS):
        toks[i, BUCKET - n:] = rng.integers(1, 500, size=n)
        pos[i, BUCKET - n:] = np.arange(n)
    return toks, pos


def _cases(params, packed):
    """The worker's cases: per config its first train step and its
    sharded serving on the f32 and the packed weights."""
    toks, pos = _prompts()
    cases = {}
    for key, (arch, over, rg) in CONFIGS.items():
        common = {"arch": arch, "over": over, "rg_heads": rg, "mesh": MESH}
        cases[key + "_train"] = dict(
            common, task="train", fsdp=False, ep=False, mb=1, kind=None,
            params=params[key], steps=0, lr=1e-3, batch=BATCH, seq=SEQ,
            frames=None)
        serve = dict(common, task="serve_kinds", ep=False, shard_batch=True,
                     qcfg=QCFG, min_dim=JR.SERVE_QUANT[2], max_seq=MAX_SEQ,
                     steps=STEPS, attn_chunk=CHUNK,
                     tokens=torch.from_numpy(toks),
                     positions=torch.from_numpy(pos))
        cases[key + "_dense"] = dict(serve, packed=False,
                                     params=W.pack_tree(params[key]))
        cases[key + "_packed"] = dict(serve, packed=True,
                                      params=W.pack_tree(packed[key]))
    return cases


def collect(tmp):
    """Every case on four gloo ranks in one launch, beside the
    reference's runs (per config a process of four host devices for the
    train step and one for serving); meanwhile the port's one-device
    serving here."""
    toks, pos = _prompts()
    procs = []
    ranks_h = None
    mp = pytest.MonkeyPatch()
    JR.kernel_route(mp.setattr)
    n = torch.get_num_threads()
    try:
        for key in CONFIGS:
            procs.append(JR.start(tmp, spec(key), BATCH, SEQ,
                                  [(key, *MESH, False, False)]))
            procs.append(JR.start_serve(
                tmp, key, {"tokens": toks, "positions": pos,
                           "max_seq": MAX_SEQ, "steps": STEPS,
                           "attn_chunk": CHUNK},
                [(key + "_dense", spec(key), 0, *MESH, False, False),
                 (key + "_packed", spec(key), 0, *MESH, False, True)]))
        rparams, params, packed = {}, {}, {}
        for key in CONFIGS:
            with JR.rg_heads(spec(key)):
                cfg = JR.reduced(spec(key))
                rparams[key] = JR.params_f32(cfg)
                params[key] = bridge.params_from_repro(rparams[key])
                packed[key] = bridge.params_from_repro(jax.tree.map(
                    np.asarray, JR.serve_params(cfg)))
        torch.set_num_threads(1)
        ranks_h = W.start(_cases(params, packed), tmp)
        torch.set_num_threads(n)
        batch = {"tokens": torch.from_numpy(toks),
                 "positions": torch.from_numpy(pos)}
        single = {}
        for key, (_, _, rg) in CONFIGS.items():
            with W.rg_heads(rg):
                single[key + "_packed"] = W.serve_tokens(
                    port_cfg(key), packed[key], batch, MAX_SEQ, STEPS, CHUNK)
        ranks = W.finish(ranks_h)
        ranks_h = None
        for proc in procs:
            JR.finish(proc, 200.0)
    finally:
        mp.undo()
        torch.set_num_threads(n)
        if ranks_h is not None:
            for p in ranks_h[0]:
                p.kill()
                p.wait()
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ref = {}
    for key in CONFIGS:
        treedef = jax.tree.structure(rparams[key])
        z = np.load(tmp / f"{key}.npz")
        ref[key + "_train"] = (float(z["loss"]), bridge.params_from_repro(
            jax.tree.unflatten(treedef, [z[f"g{i}"] for i in
                                         range(treedef.num_leaves)])))
        for kind in ("dense", "packed"):
            ref[f"{key}_{kind}"] = JR.read_serve(tmp / f"{key}_{kind}.npz")
    full = {key: {p: (n, k) for p, n, k in W.packed_widths(packed[key])}
            for key in CONFIGS}
    return {"ranks": ranks, "single": single, "ref": ref,
            "full_widths": full}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return collect(tmp_path_factory.mktemp("dist_uneven"))


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t))


def train_gaps(runs, key: str) -> dict:
    """The first step's loss gap and largest per-leaf relative gradient
    gap to the reference under the same mesh."""
    got = runs["ranks"][0][key + "_train"]
    loss, grads = runs["ref"][key + "_train"]
    worst = 0.0
    for g, w in zip(pytree.leaves(got["grads"]), pytree.leaves(grads)):
        assert g.shape == w.shape
        worst = max(worst, _norm(g - w) / max(_norm(w), 1e-30))
    return {"loss0": abs(got["loss0"] - loss), "grad_rel": worst}


def _as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def gaps(got, want) -> dict:
    """Largest logit gaps of the prefill and of each decode step (a row
    compared while its greedy tokens agree), the near-ties where the
    tokens part ((step, row, want's top-2 gap)), and want's largest
    logit."""
    out = {"prefill": float(np.abs(_as_np(got["prefill"])
                                   - _as_np(want["prefill"])).max()),
           "steps": [], "ties": [],
           "scale": float(max(np.abs(_as_np(w)).max() for w in
                              [want["prefill"]] + list(want["steps"])))}
    live = np.ones(_as_np(got["prefill"]).shape[0], bool)
    for i in range(STEPS):
        gt, wt = _as_np(got["tokens"][i]), _as_np(want["tokens"][i])
        for row in np.nonzero(live & (gt != wt))[0]:
            prev = _as_np(want["prefill"] if i == 0 else
                          want["steps"][i - 1])[row]
            top = np.sort(prev)[-2:]
            out["ties"].append((i, int(row), float(top[1] - top[0])))
        live &= gt == wt
        d = np.abs(_as_np(got["steps"][i]) - _as_np(want["steps"][i]))
        out["steps"].append(float(d[live].max()) if live.any() else 0.0)
    return out


def _worst(g) -> float:
    return max([g["prefill"]] + g["steps"])


def _hold(g, atol):
    assert _worst(g) <= atol, g
    assert all(gap <= atol for _, _, gap in g["ties"]), g


def _sharded(runs, name):
    """A serving case's run, the same bits on every rank (one data
    rank: every rank serves every row)."""
    first = runs["ranks"][0][name]
    for rk in runs["ranks"][1:]:
        assert torch.equal(rk[name]["prefill"], first["prefill"]), name
        assert all(torch.equal(a, b) for a, b in zip(rk[name]["steps"],
                                                     first["steps"])), name
    return first


def serve_gaps(runs, key: str) -> dict:
    """The sharded runs' gaps to the reference under the same mesh (f32
    and packed weights), and the port's one-device gap to it (packed)."""
    ref = runs["ref"]
    return {"dense": gaps(_sharded(runs, key + "_dense"), ref[key + "_dense"]),
            "packed": gaps(_sharded(runs, key + "_packed"),
                           ref[key + "_packed"]),
            "one_device_packed": gaps(runs["single"][key + "_packed"],
                                      ref[key + "_packed"])}


@pytest.mark.parametrize("key", list(CONFIGS))
def test_first_train_step_matches_the_reference_under_the_mesh(runs, key):
    """The first step's loss within LOSS_ATOL and every gradient leaf
    within GRAD_RTOL (the xLSTM's XL_GRAD_RTOL) relative of the
    reference's ``value_and_grad`` under the same (1, 4) mesh."""
    g = train_gaps(runs, key)
    assert g["loss0"] <= LOSS_ATOL, g
    assert g["grad_rel"] <= (XL_GRAD_RTOL if key == "xl" else GRAD_RTOL), g


@pytest.mark.parametrize("key", list(CONFIGS))
def test_sharded_serving_matches_the_reference_under_the_mesh(runs, key):
    """Prefill and 4 greedy steps, which read the context-sharded
    caches: on the f32 weights within DENSE_RTOL of the largest logit,
    on the packed ones within ATOL of the port's own one-device gap to
    the same reference run."""
    g = serve_gaps(runs, key)
    _hold(g["dense"], DENSE_RTOL * g["dense"]["scale"])
    own = g["one_device_packed"]
    assert all(gap <= ATOL for _, _, gap in own["ties"]), own
    _hold(g["packed"], _worst(own) + ATOL)


def _local_shape(shape, entries):
    sizes = dict(zip(("data", "model"), MESH))
    out = []
    for size, entry in zip(shape, entries):
        names = (entry,) if isinstance(entry, str) else tuple(entry or ())
        n = 1
        for name in names:
            n *= sizes[name]
        assert size % n == 0, (shape, entries)
        out.append(size // n)
    return tuple(out)


def declared(key: str):
    """The config's decode caches of ``launch.inputs.decode_inputs`` at
    the serving cases' batch and window, each leaf's shape and spec."""
    _, _, rg = CONFIGS[key]
    with W.rg_heads(rg):
        (_, _, caches), (_, _, specs) = TI.decode_inputs(
            port_cfg(key), ShapeCell("serve", MAX_SEQ, len(LENS), "decode"),
            Parallel(tp=MESH[1], dp=MESH[0]), Rules())
    return map_tree(caches, lambda path, t: SimpleNamespace(
        shape=tuple(t.shape), spec=tuple(at(specs, path))))


def test_caches_have_the_declared_local_shapes(runs):
    """After the prefill and after each step, each rank's caches have
    the local shapes of ``decode_inputs``' specs (the attention caches
    every run-time KV head over a quarter of the window, "ctx"), and a
    part that two ranks both hold has the same bits on both."""
    for key in CONFIGS:
        want = pytree.leaves_with_path(declared(key))
        ctx = [w for _, w in want if "model" in w.spec and len(w.shape) == 5]
        assert ctx or key == "xl", key
        for kind in ("dense", "packed"):
            name = f"{key}_{kind}"
            snaps = runs["ranks"][0][name]["caches"]
            assert len(snaps) == STEPS + 1, name
            for i in range(STEPS + 1):
                held = {}
                for rk in runs["ranks"]:
                    r = rk[name]
                    got = pytree.leaves_with_path(r["caches"][i])
                    assert [k for k, _ in got] == [k for k, _ in want], name
                    for (path, t), (_, w) in zip(got, want):
                        assert tuple(t.shape) == _local_shape(w.shape,
                                                              w.spec), \
                            (name, path, tuple(t.shape), w)
                        over = "model" in w.spec
                        coord = r["coords"][1] if over else None
                        held.setdefault((path, coord), []).append(t)
                for (path, _), parts in held.items():
                    for t in parts[1:]:
                        assert torch.equal(t, parts[0]), (name, path, i)


def test_headless_ranks_hold_no_query_columns(runs):
    """The packed query views of a rank are its whole heads: phi's wq
    32 columns (2 heads of 16) on ranks 0-2 and none on rank 3, the
    xLSTM's w_q 32 columns (1 head) on ranks 0-1 and none on 2-3.
    Every packed leaf's views add up to the leaf over the ranks: its
    columns (a column view), its input channels (a row view), or the
    whole leaf on every rank."""
    want = {"phi": ("/attn/wq", [32, 32, 32, 0]),
            "xl": ("/cell/w_q", [32, 32, 0, 0])}
    for key in CONFIGS:
        name = key + "_packed"
        per_rank = [{p: (n, k) for p, n, k in rk[name]["widths"]}
                    for rk in runs["ranks"]]
        if key in want:
            suffix, cols = want[key]
            path = next(p for p in per_rank[0] if p.endswith(suffix))
            assert [r[path][0] for r in per_rank] == cols, key
        full = runs["full_widths"][key]
        assert set(full) == set(per_rank[0]), key
        for path, (n, k) in full.items():
            ns = [r[path][0] for r in per_rank]
            ks = [r[path][1] for r in per_rank]
            column = sum(ns) == n and ks == [k] * len(ks)
            row = ns == [n] * len(ns) and sum(ks) == k
            whole = ns == [n] * len(ns) and ks == [k] * len(ks)
            assert column or row or whole, (key, path, ns, ks, n, k)


if __name__ == "__main__":
    # the measured gaps: python tests/test_torch_dist_uneven.py
    import json
    import tempfile
    import time
    from pathlib import Path
    with tempfile.TemporaryDirectory() as d:
        t0 = time.monotonic()
        r = collect(Path(d))
        out = {"seconds": time.monotonic() - t0}
        for key in CONFIGS:
            out[key] = {"train": train_gaps(r, key),
                        "serve": serve_gaps(r, key)}
        print(json.dumps(out, indent=1))
