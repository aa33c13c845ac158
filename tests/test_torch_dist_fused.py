"""Port parity: sharded serving of fused ``QLinearGroup`` leaves (``wqkv``,
``wgu``) and of an encoder-decoder model's context-sharded cross K/V,
on four gloo ranks of this machine's CPU, against the port's one-device
fused serving and against the reference.

Every case runs in one launch of four ranks of
``tests/torch_dist_worker.py`` (its ``serve_kinds`` task: a file
rendezvous under the test's ``tmp_path``, a 60 s process-group timeout,
a 240 s deadline), beside six processes of ``tests/jax_mesh_ref.py
serve`` (``REF_PROCS``: one a model, seamless's two cases one each,
and the refusals; each case under its mesh of four host devices).  All
start at once and wait for what they need, and each model's cases go
out as soon as its weights are made.  Weights are the reduced configs'
(vocabulary 512, f32) from ``repro`` (``PRNGKey(0)``), quantized
data-free with ``fuse=True`` by the reference (ratio 0.2, multiple 8,
min_dim 32; ``jax_mesh_ref.serve_params``) once: seamless's here, the
others' by the reference's process that serves them, which hands them
here (``--export``).  The bridge carries them to the port, and every
process serves the same bytes.  The ranks place each
group's members by ``launch.qdeclare.declare_quantized``'s specs of the
unfused leaves; the reference places the group leaves replicated,
which changes no value of a jitted function.

* ``qwen3``: reduced qwen2.5-3b, 2 layers, qk norms, 8 query / 2 KV
  heads of 16, on (1, 4) (the run-time KV heads replicated to 4, so a
  rank's KV columns are gathered over "model"; the prefill projects
  them on its chunk of the sequence-parallel stream, the members as
  two products) and on (2, 2) (each rank's KV heads its own: one
  product);
* ``moe``: granite-moe-1b-a400m, 2 moe layers, EP on (1, 4): the fused
  ``wgu`` (E, K, 2F) served as its members, as the reference's
  shard-map path serves it;
* ``phi``: phi4-mini-3.8b with 6 query / 2 KV heads at tp 4 (ranks 0-2
  hold 2 query heads, rank 3 none; every KV head on every rank), the
  sequence-parallel prefill projecting KV on the chunk; also on its f32
  weights fused (``phi_f32``: floating-point groups, the query member
  cut to whole heads at placement), against the reference's f32
  weights unfused (fusing floating-point weights is an exact
  concatenation);
* ``s2t_ctx`` / ``s2t_rep``: seamless-m4t-medium with 6 query / 2 KV
  heads at tp 4, 16 stub frames a row (tp divides them: each rank's
  cross K/V every KV head over 4 of the 16 encoder positions, the
  "ctx" layout, whose parts combine over "model") and 18 (it does
  not: every position on every rank).  The decoder runs from the
  port's one-device encoder output on every side (given to the
  reference's prefill, ``jax_mesh_ref.given_encoder``): a packed
  encoder's outputs straddle bf16 roundings between the two packages
  (``tests/test_torch_dist_serve_kinds.py``).

Four rows of 32 tokens, left-padded, 32, 21, 9 and 27 live; ring caches
of 48; 4 greedy decode steps.

Tolerances, those of ``tests/test_torch_dist_serve.py``: ``ATOL`` 2e-3
on the logits against the port's one-device fused run (the sharded
products sum their f32 partials in another order, so a packed output
may straddle one bf16 rounding), ``REF_ATOL`` 4e-3 against the
reference (two straddled roundings), the f32 weights within
``DENSE_RTOL`` 1e-4 of the reference's largest logit.  Where the port
on one device already parts from the reference by more than
``REF_ATOL`` (a straddle between the packages: seamless at 18 frames,
6.98e-3 at one decode step, its logits about 3.9), the sharded run is
held within ``ATOL`` of that gap, as ``tests/test_torch_dist_uneven.py``
holds its packed runs.  Measured (``python
tests/test_torch_dist_fused.py`` prints every gap): against one device
at most 1.7e-5 (phi), exactly 0 in four of the six packed cases;
against the reference at most 2.6e-3 (qwen3), the f32 run 5.7e-7.
Greedy tokens equal, or a near-tie shown: where they part, the compared
side's top-2 gap at that step lies within the tolerance.  Also: a rank's
fused view has exactly the bytes of its members' views (from the same
placement of the unfused leaves) concatenated along N; a mutant that places a group
by an even cut of its fused N parts from one device by more than 10x
the tolerance; the cross caches have the declared local shapes; and an
uneven stored split (d_ff = 4k + 2 at tp 4) is refused by the
reference's placement (``jit``'s ``in_shardings``) and by
``check_shardable`` alike.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax_mesh_ref as JR  # noqa: E402
import torch_dist_worker as W  # noqa: E402

from repro_torch import bridge, pytree  # noqa: E402
from repro_torch.core.select import map_tree  # noqa: E402
from repro_torch.distributed.sharding import Rules  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import Parallel  # noqa: E402

ATOL = 2e-3           # against the port on one device
REF_ATOL = 4e-3       # against the reference: two straddled roundings
DENSE_RTOL = 1e-4     # f32 weights against the reference, of max|logit|
MUTANT_MIN = 10 * ATOL
QWEN3 = {"n_heads": 8, "n_kv_heads": 2, "qk_norm": True, "qkv_bias": False}
UNEVEN = {"n_heads": 6, "n_kv_heads": 2}
# model: (architecture, overridden fields, repeats)
MODELS = {"qwen3": ("qwen2.5-3b", QWEN3, 2),
          "moe": ("granite-moe-1b-a400m", {}, 2),
          "phi": ("phi4-mini-3.8b", UNEVEN, 0),
          "s2t": ("seamless-m4t-medium", UNEVEN, 0)}
# case: (model, mesh, EP, packed, frames a row)
CASES = {"qwen3_m14": ("qwen3", (1, 4), False, True, 0),
         "qwen3_m22": ("qwen3", (2, 2), False, True, 0),
         "moe_m14": ("moe", (1, 4), True, True, 0),
         "phi_m14": ("phi", (1, 4), False, True, 0),
         "phi_f32": ("phi", (1, 4), False, False, 0),
         "s2t_ctx": ("s2t", (1, 4), False, True, 16),
         "s2t_rep": ("s2t", (1, 4), False, True, 18)}
# the cases whose ranks hold their fused views against their members'
GROUP_BYTES = ("qwen3_m14", "moe_m14", "phi_m14")
REFUSE = {"refuse_odd": 130, "refuse_even": 128}   # d_ff at tp 4
LENS, BUCKET, MAX_SEQ, STEPS, CHUNK = (32, 21, 9, 27), 32, 48, 4, 1024
QCFG = dict(ratio=JR.SERVE_QUANT[0], multiple=JR.SERVE_QUANT[1])


def ref_arch(model: str, **more) -> str:
    """The reference's ARCH argument of a model (booleans as 0 / 1)."""
    arch, over, _ = MODELS[model]
    return JR.arch_spec(arch, {**over, **more})


def _prompts():
    rng = np.random.default_rng(7)
    toks = np.zeros((len(LENS), BUCKET), np.int32)
    pos = np.full((len(LENS), BUCKET), -1, np.int32)
    for i, n in enumerate(LENS):
        toks[i, BUCKET - n:] = rng.integers(1, 500, size=n)
        pos[i, BUCKET - n:] = np.arange(n)
    return toks, pos


def _frames(n: int, d: int) -> np.ndarray:
    return np.random.default_rng(n).standard_normal(
        (len(LENS), n, d)).astype(np.float32)


# the reference's processes: their cases, and those whose weights they
# make and hand to this process; seamless's weights are made here first
# (its decoder waits for the port's encoder output), and its two cases
# run side by side
REF_PROCS = {"qwen3": (("qwen3_m14", "qwen3_m22"), ("qwen3_m14",)),
             "phi": (("phi_m14", "phi_f32"), ("phi_m14", "phi_f32")),
             "moe": (("moe_m14",), ("moe_m14",)),
             "s2t_ctx": (("s2t_ctx",), ()),
             "s2t_rep": (("s2t_rep",), ()),
             "refuse": (tuple(REFUSE), ())}


def _ref_spec(name):
    """The reference's serve spec of a case of CASES or REFUSE."""
    if name in REFUSE:
        return (name, ref_arch("qwen3", d_ff=REFUSE[name]), 0, 1, 4, False,
                True, "refuse")
    m, mesh, ep, packed, _ = CASES[name]
    return (name, ref_arch(m), MODELS[m][2], *mesh, ep, packed, int(packed))


def collect(tmp):
    """Every case on four gloo ranks in one launch, beside the
    reference's runs in the processes of REF_PROCS, which make the
    weights; meanwhile the port's one-device fused runs here."""
    toks, pos = _prompts()
    common = {"max_seq": MAX_SEQ, "steps": STEPS, "attn_chunk": CHUNK}
    d = JR.reduced(ref_arch("s2t")).d_model
    frames = {name: _frames(c[4], d) for name, c in CASES.items() if c[4]}
    inputs = {"tokens": toks, "positions": pos, **common,
              **{f"frames_{k}": v for k, v in frames.items()},
              "frames": next(iter(frames.values()))}
    mp = pytest.MonkeyPatch()
    JR.kernel_route(mp.setattr)
    # every process starts at once: the reference's make the weights
    # (``--export``) while the ranks start, and each model's cases go out
    # as soon as its weights are here
    ranks_h, procs = None, {}
    try:
        ranks_h = W.start(None, tmp)
        for tag, (names, made) in REF_PROCS.items():
            procs[tag] = JR.start_serve(
                tmp, tag, None if tag.startswith("s2t") else inputs,
                [_ref_spec(c) for c in names], export=made)
        rcfgs, params, cfgs, enc = {}, {}, {}, {}
        for m, (arch, over, repeats) in MODELS.items():
            rcfgs[m] = JR.reduced(ref_arch(m), repeats)
            cfgs[m] = W.kind_cfg({"arch": arch, "over": over, "stages": [
                (tuple(s.pattern), s.repeats) for s in rcfgs[m].stages]})
        order = ("s2t", "qwen3", "phi", "moe")
        for m in order:
            if m == "s2t":
                rp = jax.tree.map(np.asarray, JR.serve_params(rcfgs[m],
                                                              fuse=True))
            else:
                rp = JR.made_weights(tmp, REF_PROCS[m][1][0], procs[m])
            params[m] = bridge.params_from_repro(rp)
            if m == "phi":
                params["phi_f32"] = TT.fuse_params_for_decode(
                    bridge.params_from_repro(
                        JR.made_weights(tmp, "phi_f32", procs[m])))
            if m == "s2t":
                # the port's one-device encoder output of each frames
                # set, from which every side's seamless decoder runs
                with torch.no_grad():
                    enc = {name: TM.encode(cfgs[m], params[m],
                                           torch.from_numpy(f), CHUNK)[0]
                           for name, f in frames.items()}
                inputs.update({f"enc_out_{k}": v.numpy()
                               for k, v in enc.items()})
                for name in ("s2t_ctx", "s2t_rep"):
                    JR.give_serve(tmp, name, inputs, {name: rp})
            names = [name for name, c in CASES.items() if c[0] == m]
            cases = {name: _rank_case(name, cfgs[m], params[name if name
                                                            == "phi_f32"
                                                            else m],
                                      frames, enc, toks, pos, common)
                     for name in names}
            if m == "qwen3":
                cases["mutant"] = dict(cases["qwen3_m14"],
                                       mutant="even_group",
                                       group_bytes=False)
            W.give(ranks_h, cases, more=m != order[-1])
        batch = {"tokens": torch.from_numpy(toks),
                 "positions": torch.from_numpy(pos)}
        single = {m: W.serve_tokens(cfgs[m], params[m], batch, MAX_SEQ,
                                    STEPS, CHUNK)
                  for m in ("qwen3", "moe", "phi")}
        for name, f in frames.items():
            with W.encoder_output([], enc[name]):
                single[name] = W.serve_tokens(
                    cfgs["s2t"], params["s2t"],
                    dict(batch, frames=torch.from_numpy(f)), MAX_SEQ,
                    STEPS, CHUNK)
        ranks = W.finish(ranks_h)
        ranks_h = None
        for proc in procs.values():
            JR.finish(proc, 150.0)
    finally:
        mp.undo()
        if ranks_h is not None:
            for p in ranks_h[0]:
                p.kill()
                p.wait()
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ref = {name: JR.read_serve(tmp / f"{name}.npz") for name in CASES}
    refused = {name: (tmp / f"{name}.txt").read_text() for name in REFUSE}
    return {"ranks": ranks, "single": single, "ref": ref, "cfgs": cfgs,
            "refused": refused}


def _rank_case(name, cfg, params, frames, enc, toks, pos, common):
    """The ranks' serve_kinds case ``name`` of CASES."""
    m, mesh, ep, packed, f = CASES[name]
    arch, over, _ = MODELS[m]
    case = {"task": "serve_kinds", "arch": arch, "over": over,
            "stages": [(tuple(s.pattern), s.repeats) for s in cfg.stages],
            "params": W.pack_tree(params), "mesh": mesh, "ep": ep,
            "shard_batch": True, "packed": packed, "qcfg": QCFG,
            "min_dim": JR.SERVE_QUANT[2], **common,
            "tokens": torch.from_numpy(toks),
            "positions": torch.from_numpy(pos),
            "group_bytes": name in GROUP_BYTES}
    if f:
        case.update(frames=torch.from_numpy(frames[name]),
                    enc_out=enc[name])
    return case


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return collect(tmp_path_factory.mktemp("dist_fused"))


def _joined(runs, name, key=None):
    """A case's results joined over its data ranks (``key`` a sub-run,
    ``fixed``): every rank that holds the same rows returns the same
    bits (asserted), and the data ranks' rows are concatenated."""
    by_rows = {}
    for rk in runs["ranks"]:
        r = rk[name] if key is None else rk[name][key]
        k = tuple(rk[name]["rows"])
        if k in by_rows:
            a = by_rows[k]
            assert torch.equal(a["prefill"], r["prefill"]), name
            assert all(torch.equal(x, y) for x, y in zip(a["steps"],
                                                         r["steps"])), name
        else:
            by_rows[k] = r
    parts = [by_rows[k] for k in sorted(by_rows)]
    return {"prefill": torch.cat([p["prefill"] for p in parts]),
            "steps": [torch.cat([p["steps"][i] for p in parts])
                      for i in range(STEPS)],
            "tokens": [torch.cat([p["tokens"][i] for p in parts])
                       for i in range(STEPS)]}


def _as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def gaps(got, want):
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


def _decoder(runs, name):
    """What a case is held by: seamless's decoder from the reference's
    encoder output (``fixed``), else the case's own run."""
    return _joined(runs, name, "fixed" if CASES[name][4] else None)


def _single(runs, name):
    """The port's one-device fused run a case is held against."""
    return runs["single"][name if CASES[name][4] else CASES[name][0]]


def one_device_gaps(runs, name):
    return gaps(_decoder(runs, name), _single(runs, name))


def reference_gaps(runs, name):
    return gaps(_decoder(runs, name), runs["ref"][name])


def _local_shape(shape, spec, mesh):
    sizes = dict(zip(("data", "model"), mesh))
    out = []
    for size, entry in zip(shape, spec):
        names = (entry,) if isinstance(entry, str) else tuple(entry or ())
        k = 1
        for name in names:
            k *= sizes[name]
        assert size % k == 0, (shape, spec, mesh)
        out.append(size // k)
    return tuple(out)


def _cache_shapes_hold(runs, name):
    """After the prefill and each step, every rank's caches have the
    local shapes of ``model.declare_caches``' specs (the cross K/V over
    "ctx" or whole), and the parts two ranks hold alike are the same
    bits."""
    m, mesh, ep, _, frames = CASES[name]
    dp, tp = mesh
    decl = TM.declare_caches(runs["cfgs"][m], Parallel(tp=tp, dp=dp),
                             len(LENS), MAX_SEQ, enc_len=frames)
    rules = Rules(ep=ep)
    want = pytree.leaves_with_path(map_tree(decl, lambda _, p: SimpleNamespace(
        shape=tuple(p.shape), spec=tuple(rules.spec(p.axes)))))
    for i in range(STEPS + 1):
        held = {}
        for rk in runs["ranks"]:
            got = pytree.leaves_with_path(rk[name]["caches"][i])
            assert [k for k, _ in got] == [k for k, _ in want], name
            for (key, t), (_, w) in zip(got, want):
                assert tuple(t.shape) == _local_shape(w.shape, w.spec,
                                                      mesh), (name, key, w)
                over = "model" in w.spec
                held.setdefault((key, rk[name]["coords"][1] if over
                                 else None), []).append(t)
        for (key, _), parts in held.items():
            assert all(torch.equal(t, parts[0]) for t in parts[1:]), \
                (name, key, i)


@pytest.mark.parametrize("name", [n for n in CASES if n != "phi_f32"])
def test_fused_sharded_serving_matches_one_device_and_reference(runs, name):
    """The case's prefill logits and 4 greedy steps within ATOL of the
    port's one-device fused run, and against the reference under the
    same mesh within REF_ATOL, or
    where the port's one device already parts from it by more (a
    straddled rounding between the packages), within ATOL of that gap;
    seamless's caches in the declared layout."""
    _hold(one_device_gaps(runs, name), ATOL)
    own = gaps(_single(runs, name), runs["ref"][name])
    assert not own["ties"], own
    _hold(reference_gaps(runs, name), max(REF_ATOL, _worst(own) + ATOL))
    if CASES[name][4]:
        _cache_shapes_hold(runs, name)


def test_f32_fused_groups_match_the_reference(runs):
    """phi's f32 weights fused (floating-point groups, the query member
    cut to each rank's whole heads at placement) within DENSE_RTOL of
    the reference's largest logit under the same mesh."""
    g = reference_gaps(runs, "phi_f32")
    _hold(g, DENSE_RTOL * g["scale"])


def test_fused_views_are_their_members_views(runs):
    """Every rank's fused view (wqkv and wgu of every layer; granite's
    stacked wgu; phi's uneven query heads) has exactly the bytes and
    scales of its members' views in the same placement of the unfused
    leaves, concatenated along N, and their widths as splits, and of
    ``sharding.group_view`` of the whole group (the twin the card's
    split check runs); the query member of phi's rank 3 has no
    column."""
    for name in ("qwen3_m14", "moe_m14", "phi_m14"):
        for rk in runs["ranks"]:
            seen = rk[name]["group_bytes"]
            assert seen and all(same for _, same in seen), (name, seen)
    q = [next(n for p, n, _ in rk["phi_m14"]["widths"]
              if p.endswith("/attn/wqkv:0")) for rk in runs["ranks"]]
    assert q == [32, 32, 32, 0], q


def test_even_cut_of_the_fused_group_fails(runs):
    """A group placed by an even cut of its fused N (rank 0 all wq
    columns) parts from one device by more than 10x ATOL."""
    g = gaps(_joined(runs, "mutant"), runs["single"]["qwen3"])
    assert g["prefill"] > MUTANT_MIN, g


def test_uneven_stored_split_is_refused_by_both(runs):
    """A d_ff of 4k + 2 at tp 4: the reference's placement (``jit``'s
    ``in_shardings`` of ``declare_quantized``'s specs) raises its
    "divisible" ValueError naming the 130 columns, and
    ``check_shardable`` a ValueError naming the d_ff; at d_ff 128 (the
    control) neither refuses."""
    text = runs["refused"]["refuse_odd"]
    assert "divisible" in text and "130" in text, text
    assert runs["refused"]["refuse_even"] == ""
    cfg = W.kind_cfg({"arch": "qwen2.5-3b", "over": dict(QWEN3, d_ff=130)})
    with pytest.raises(ValueError, match="d_ff"):
        TM.check_shardable(cfg, Parallel(tp=4), serving=True)
    TM.check_shardable(dataclasses.replace(cfg, d_ff=128), Parallel(tp=4),
                       serving=True)


if __name__ == "__main__":
    # the measured gaps: python tests/test_torch_dist_fused.py
    import json
    import tempfile
    import time
    from pathlib import Path
    with tempfile.TemporaryDirectory() as d:
        t0 = time.monotonic()
        r = collect(Path(d))
        out = {"seconds": time.monotonic() - t0}
        for name in CASES:
            out[name] = {"reference": reference_gaps(r, name)}
            if name != "phi_f32":
                out[name]["one_device"] = one_device_gaps(r, name)
                out[name]["one_device_vs_reference"] = gaps(
                    _single(r, name), r["ref"][name])
        out["mutant"] = gaps(_joined(r, "mutant"), r["single"]["qwen3"])
        out["refused"] = r["refused"]
        print(json.dumps(out, indent=1))
