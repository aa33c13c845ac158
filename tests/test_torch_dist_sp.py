"""Port parity: the sequence-parallel residual stream (``Parallel.sp``)
in the sharded train step and in sharded prefill, on four gloo ranks of
this machine's CPU at (1, 4) and (2, 2), against the reference under
the same mesh of host devices (``tests/jax_mesh_ref.py``, whose
``Parallel`` sets ``sp`` wherever tp > 1, as its presets do).

With ``sp`` and tp > 1 each model rank holds its chunk of the stream's
sequence between blocks (``sharding.chunk_range``: ceil(S / tp) a rank,
the trailing ranks short or empty), and each tensor-parallel sublayer
gathers its input along the sequence and reduce-scatters its output;
without, the stream is replicated and each output is all-reduced.  The
values are the reference's either way.

Six reduced configs, one per block kind and input: qwen3-4b (dense,
q/k norms), granite-moe-1b-a400m (the group-local MoE and its aux loss
on the gathered rows), recurrentgemma-2b (rglru and local),
xlstm-1.3b (7 mlstm and 1 slstm), seamless-m4t-medium (the encoder's
stream sequence-parallel too, its output gathered once for every cross
K/V; frames 8 x 16) and llava-next-34b (8 vision embeddings spliced
into each rank's chunk).  Weights are the reference's (``PRNGKey(0)``,
f32, carried across by the bridge); packed ones its data-free
PTQ1.61, unfused (``jax_mesh_ref.serve_params``).  Every case runs in
one launch of four ranks (a file rendezvous under ``tmp_path``, a 60 s
process-group timeout, a 240 s deadline), beside one process of the
reference per train config and two for serving.

Tolerances are those of ``tests/test_torch_dist_uneven.py``: the first
train step (8 x 32 tokens) within 2e-5 in its loss and 1e-5 relative in
norm per gradient leaf (the xLSTM's 5e-5); serving (four left-padded
prompts in a bucket of 30, ring caches of 48, 4 greedy steps) on packed
weights within 2e-3 of the port's own one-device gap to the same
reference run, on f32 weights within 1e-4 of the largest logit, greedy
tokens equal or a near-tie within the tolerance.  30 positions at tp 4
are chunks of 8, 8, 8 and 6; 3 are chunks of 1, 1, 1 and none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax_mesh_ref as JR  # noqa: E402
import torch_dist_worker as W  # noqa: E402

from repro_torch import bridge, pytree  # noqa: E402
from repro_torch.distributed.sharding import chunk_range  # noqa: E402

KEYS = {"dense": "qwen3-4b", "moe": "granite-moe-1b-a400m",
        "rg": "recurrentgemma-2b", "xl": "xlstm-1.3b",
        "s2t": "seamless-m4t-medium", "vlm": "llava-next-34b"}
MESHES = {"14": (1, 4), "22": (2, 2)}
BATCH, SEQ, ODD = 8, 32, (30, 3)
FRAMES = {"s2t": 16, "vlm": 8}      # encoder frames / vision embeddings
LOSS_ATOL, GRAD_RTOL, XL_GRAD_RTOL = 2e-5, 1e-5, 5e-5
ATOL, DENSE_RTOL = 2e-3, 1e-4
SERVED = ("dense", "vlm")
LENS, LENS3, MAX_SEQ, STEPS, CHUNK = (30, 21, 9, 27), (3, 2, 3, 1), 48, 4, 1024
QCFG = dict(ratio=JR.SERVE_QUANT[0], multiple=JR.SERVE_QUANT[1])


def _frames(key: str, rows: int, d: int, seed: int):
    """The stub frames or vision embeddings (rows, F, d) of a config, or
    None."""
    if key not in FRAMES:
        return None
    rng = np.random.default_rng(seed)
    return rng.standard_normal((rows, FRAMES[key], d)).astype(np.float32)


def _prompts(lens):
    rng = np.random.default_rng(7)
    bucket = max(lens)
    toks = np.zeros((len(lens), bucket), np.int32)
    pos = np.full((len(lens), bucket), -1, np.int32)
    for i, n in enumerate(lens):
        toks[i, bucket - n:] = rng.integers(1, 500, size=n)
        pos[i, bucket - n:] = np.arange(n)
    return toks, pos


def _train(key, params, mesh, frames, **over):
    case = {"task": "train", "arch": KEYS[key], "mesh": mesh, "fsdp": False,
            "ep": False, "mb": 1, "kind": None, "params": params, "steps": 0,
            "lr": 1e-3, "batch": BATCH, "seq": SEQ,
            "frames": None if frames is None else [torch.from_numpy(frames)]}
    return dict(case, **over)


def _cases(params, packed, d):
    cases = {}
    for key in KEYS:
        fr = _frames(key, BATCH, d, 0)
        for m, mesh in MESHES.items():
            cases[f"{key}_{m}"] = _train(key, params[key], mesh, fr,
                                         record=m == "14")
        cases[f"{key}_14_off"] = _train(key, params[key], (1, 4), fr,
                                        sp=False, record=True)
    for s in ODD:
        cases[f"dense_s{s}"] = _train("dense", params["dense"], (1, 4), None,
                                      seq=s, record=True)
    toks, pos = _prompts(LENS)
    serve = {"task": "serve_kinds", "ep": False, "shard_batch": True,
             "qcfg": QCFG, "min_dim": JR.SERVE_QUANT[2], "max_seq": MAX_SEQ,
             "steps": STEPS, "attn_chunk": CHUNK, "record": True,
             "tokens": torch.from_numpy(toks),
             "positions": torch.from_numpy(pos)}
    for key in SERVED:
        fr = _frames(key, len(LENS), d, 1)
        for m, mesh in MESHES.items():
            cases[f"{key}_{m}_packed"] = dict(
                serve, arch=KEYS[key], mesh=mesh, packed=True,
                params=W.pack_tree(packed[key]),
                **({} if fr is None else
                   {"vision_embeds": torch.from_numpy(fr)}))
    toks3, pos3 = _prompts(LENS3)
    cases["dense_s3_serve"] = dict(
        serve, arch=KEYS["dense"], mesh=(1, 4), packed=False,
        params=W.pack_tree(params["dense"]), tokens=torch.from_numpy(toks3),
        positions=torch.from_numpy(pos3))
    return cases


def collect(tmp):
    """Every case on four gloo ranks in one launch, beside the
    reference's runs; meanwhile the port's one-device serving of the
    packed weights here."""
    d = W.arch_cfg(KEYS["dense"]).d_model
    procs, ranks_h = [], None
    mp = pytest.MonkeyPatch()
    JR.kernel_route(mp.setattr)
    n = torch.get_num_threads()
    toks, pos = _prompts(LENS)
    toks3, pos3 = _prompts(LENS3)
    try:
        for key, arch in KEYS.items():
            runs = [(f"{key}_{m}", *mesh, False, False)
                    for m, mesh in MESHES.items()]
            if key == "dense":
                runs += [(f"dense_s{s}", 1, 4, False, False, s) for s in ODD]
            procs.append(JR.start(tmp, arch, BATCH, SEQ, runs,
                                  _frames(key, BATCH, d, 0)))
        inputs = {"tokens": toks, "positions": pos, "max_seq": MAX_SEQ,
                  "steps": STEPS, "attn_chunk": CHUNK,
                  "vision_embeds": _frames("vlm", len(LENS), d, 1)}
        procs.append(JR.start_serve(
            tmp, "sp", inputs,
            [(f"{key}_{m}_packed", KEYS[key], 0, *mesh, False, True)
             for key in SERVED for m, mesh in MESHES.items()]))
        procs.append(JR.start_serve(
            tmp, "sp3", {"tokens": toks3, "positions": pos3,
                         "max_seq": MAX_SEQ, "steps": STEPS,
                         "attn_chunk": CHUNK},
            [("dense_s3_serve", KEYS["dense"], 0, 1, 4, False, False)]))
        rparams, params, packed = {}, {}, {}
        for key, arch in KEYS.items():
            cfg = JR.reduced(arch)
            rparams[key] = JR.params_f32(cfg)
            params[key] = bridge.params_from_repro(rparams[key])
            if key in SERVED:
                packed[key] = bridge.params_from_repro(jax.tree.map(
                    np.asarray, JR.serve_params(cfg)))
        torch.set_num_threads(1)
        ranks_h = W.start(_cases(params, packed, d), tmp)
        torch.set_num_threads(n)
        single = {}
        for key in SERVED:
            batch = {"tokens": torch.from_numpy(toks),
                     "positions": torch.from_numpy(pos)}
            fr = _frames(key, len(LENS), d, 1)
            if fr is not None:
                batch["vision_embeds"] = torch.from_numpy(fr)
            single[key] = W.serve_tokens(W.arch_cfg(KEYS[key]), packed[key],
                                         batch, MAX_SEQ, STEPS, CHUNK)
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
    for key in KEYS:
        treedef = jax.tree.structure(rparams[key])
        names = [f"{key}_{m}" for m in MESHES]
        names += [f"dense_s{s}" for s in ODD] if key == "dense" else []
        for name in names:
            z = np.load(tmp / f"{name}.npz")
            ref[name] = (float(z["loss"]), bridge.params_from_repro(
                jax.tree.unflatten(treedef, [z[f"g{i}"] for i in
                                             range(treedef.num_leaves)])))
    for name in [f"{k}_{m}_packed" for k in SERVED for m in MESHES] + [
            "dense_s3_serve"]:
        ref[name] = JR.read_serve(tmp / f"{name}.npz")
    return {"ranks": ranks, "single": single, "ref": ref}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return collect(tmp_path_factory.mktemp("dist_sp"))


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t))


def train_gaps(runs, name: str, ref_name: str) -> dict:
    """A case's first-step loss gap and largest per-leaf relative
    gradient gap to the reference run ``ref_name``."""
    got = runs["ranks"][0][name]
    loss, grads = runs["ref"][ref_name]
    worst = 0.0
    for g, w in zip(pytree.leaves(got["grads"]), pytree.leaves(grads)):
        assert g.shape == w.shape
        worst = max(worst, _norm(g - w) / max(_norm(w), 1e-30))
    return {"loss0": abs(got["loss0"] - loss), "grad_rel": worst}


def _hold_train(runs, name, ref_name, key):
    g = train_gaps(runs, name, ref_name)
    assert g["loss0"] <= LOSS_ATOL, (name, g)
    assert g["grad_rel"] <= (XL_GRAD_RTOL if key == "xl" else GRAD_RTOL), \
        (name, g)
    # the loss is replicated over "model": every rank reports the same
    assert len({rk[name]["loss0"] for rk in runs["ranks"]
                if rk[name]["coords"][0] == 0}) == 1, name


@pytest.mark.parametrize("key", list(KEYS))
def test_sp_train_step_matches_the_reference_under_the_mesh(runs, key):
    """The first sp step at (1, 4) and (2, 2), and the ``sp=False``
    step at (1, 4) (today's replicated route), each within the bounds
    of the reference's ``value_and_grad`` under the same mesh."""
    for m in MESHES:
        _hold_train(runs, f"{key}_{m}", f"{key}_{m}", key)
    _hold_train(runs, f"{key}_14_off", f"{key}_14", key)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def gaps(got, want) -> dict:
    """Largest logit gaps of the prefill and of each decode step (a row
    compared while its greedy tokens agree), the near-ties where the
    tokens part ((step, row, want's top-2 gap)), and want's largest
    logit."""
    out = {"prefill": float(np.abs(_np(got["prefill"])
                                   - _np(want["prefill"])).max()),
           "steps": [], "ties": [],
           "scale": float(max(np.abs(_np(w)).max() for w in
                              [want["prefill"]] + list(want["steps"])))}
    live = np.ones(_np(got["prefill"]).shape[0], bool)
    for i in range(len(want["steps"])):
        gt, wt = _np(got["tokens"][i]), _np(want["tokens"][i])
        for row in np.nonzero(live & (gt != wt))[0]:
            prev = _np(want["prefill"] if i == 0 else want["steps"][i - 1])
            top = np.sort(prev[row])[-2:]
            out["ties"].append((i, int(row), float(top[1] - top[0])))
        live &= gt == wt
        diff = np.abs(_np(got["steps"][i]) - _np(want["steps"][i]))
        out["steps"].append(float(diff[live].max()) if live.any() else 0.0)
    return out


def _worst(g) -> float:
    return max([g["prefill"]] + g["steps"])


def _hold(g, atol):
    assert _worst(g) <= atol, g
    assert all(gap <= atol for _, _, gap in g["ties"]), g


def _joined(runs, name):
    """A serving case's rows joined over the data ranks (model rank 0),
    after checking every model rank of a data rank has the same bits."""
    parts = {}
    for rk in runs["ranks"]:
        r = rk[name]
        first = parts.setdefault(r["rows"], r)
        assert torch.equal(first["prefill"], r["prefill"]), name
        assert all(torch.equal(a, b) for a, b in zip(first["steps"],
                                                     r["steps"])), name
    rows = [parts[k] for k in sorted(parts)]
    return {"prefill": torch.cat([r["prefill"] for r in rows]),
            "steps": [torch.cat(s) for s in zip(*[r["steps"] for r in rows])],
            "tokens": [torch.cat(s) for s in zip(*[r["tokens"]
                                                    for r in rows])]}


@pytest.mark.parametrize("key", SERVED)
def test_sp_prefill_and_decode_match_the_reference(runs, key):
    """Sharded prefill (its stream sequence-parallel, the vision
    embeddings spliced into each rank's chunk for llava) and 4 decode
    steps on packed weights at (1, 4) and (2, 2): within ATOL of the
    port's own one-device gap to the reference's run under the mesh."""
    for m in MESHES:
        name = f"{key}_{m}_packed"
        want = runs["ref"][name]
        own = gaps(runs["single"][key], want)
        assert all(gap <= ATOL for _, _, gap in own["ties"]), own
        _hold(gaps(_joined(runs, name), want), _worst(own) + ATOL)


def _enc_len(key):
    return FRAMES[key] if key == "s2t" else None


def _chunk_len(s: int, tp: int, r: int) -> int:
    lo, hi = chunk_range(s, tp, r)
    return hi - lo


def test_stream_and_checkpoints_hold_the_rank_chunk(runs):
    """At (1, 4) the stream entering every block (the remat
    recomputation's too, and the encoder's) is (B, chunk, D) with the
    rank's chunk of the sequence, and each superblock checkpoint keeps
    an input of that chunk: 1/tp of what the ``sp=False`` run keeps,
    rounded to the chunk (8 of 32; 8, 8, 8, 6 of 30; 1, 1, 1, 0 of 3).
    The prefill's stream is the rank's chunk of the prompt bucket."""
    d = W.arch_cfg(KEYS["dense"]).d_model
    names = [(k, f"{k}_14", SEQ) for k in KEYS] + [
        ("dense", f"dense_s{s}", s) for s in ODD]
    for key, name, s in names:
        enc = _enc_len(key)
        for r, rk in enumerate(runs["ranks"]):
            lay = rk[name]["layout"]
            want = {(BATCH, _chunk_len(s, 4, r), d)}
            if enc:
                want.add((BATCH, _chunk_len(enc, 4, r), d))
            assert lay["blocks"] and set(lay["blocks"]) <= want, \
                (name, r, set(lay["blocks"]))
            off = rk[f"{key}_14_off"]["layout"] if name == f"{key}_14" \
                else None
            if off is not None:
                assert set(off["blocks"]) <= {(BATCH, SEQ, d),
                                              (BATCH, enc, d)}, name
                assert len(off["saved"]) == len(lay["saved"]) > 0, name
            for i, saved in enumerate(lay["saved"]):
                big = [t for t in saved if len(t) == 3]
                assert big == [(BATCH, _chunk_len(s, 4, r), d)], \
                    (name, r, saved)
                if off is not None:
                    whole = [t for t in off["saved"][i] if len(t) == 3]
                    assert whole == [(BATCH, SEQ, d)], (name, off["saved"])
    for key in SERVED:
        for m, (dp, tp) in MESHES.items():
            for r, rk in enumerate(runs["ranks"]):
                blocks = set(rk[f"{key}_{m}_packed"]["layout"]["blocks"])
                c = _chunk_len(max(LENS), tp, r % tp)
                assert blocks == {(len(LENS) // dp, c, d)}, (key, m, blocks)


def _sublayers(key) -> tuple:
    """(decoder, encoder) tensor-parallel sublayers of a reduced config:
    attention, cross-attention, MLP or MoE, RG-LRU, mLSTM cell, sLSTM
    cell with its FFN (one entry and one exit)."""
    cfg = W.arch_cfg(KEYS[key])
    per = {"dense": 2, "moe": 2, "local": 2, "rglru": 2, "mlstm": 1,
           "slstm": 1}
    dec = sum(per[k] * st.repeats for st in cfg.stages for k in st.pattern)
    if cfg.enc_dec:
        dec += cfg.n_layers
        return dec, 2 * cfg.n_enc_layers
    return dec, 0


def test_one_gather_and_one_scatter_per_sublayer(runs):
    """One forward at (1, 4): with sp, one all-gather and one
    reduce-scatter of the stream per tensor-parallel sublayer (the loss
    head's gather and the embedding's scatter besides; the encoder's
    output gathered once), and no all-reduce of a (B, S, D) stream;
    without, one all-reduce per sublayer and the embedding, and no
    stream gather or scatter."""
    d = W.arch_cfg(KEYS["dense"]).d_model
    for key in KEYS:
        dec, enc = _sublayers(key)
        lengths = {SEQ: dec} | ({FRAMES[key]: enc} if enc else {})
        for rk in runs["ranks"]:
            ops = rk[f"{key}_14"]["layout"]["collectives"]
            off = rk[f"{key}_14_off"]["layout"]["collectives"]
            for s, n in lengths.items():
                c = -(-s // 4)
                ends = 0 if s != SEQ else 1
                assert ops.count(("all_gather", (4 * c, BATCH, d))) == \
                    n + 1, (key, s, ops)
                assert ops.count(("reduce_scatter", (4 * c, BATCH, d))) == \
                    n + ends, (key, s, ops)
                assert ("all_reduce", (BATCH, s, d)) not in ops, (key, ops)
                assert off.count(("all_reduce", (BATCH, s, d))) == \
                    n + ends, (key, s, off)
                assert not any(op != "all_reduce" and shape[1:] == (BATCH, d)
                               for op, shape in off), (key, off)


@pytest.mark.parametrize("seq", ODD)
def test_uneven_and_empty_chunks_match_the_reference(runs, seq):
    """At tp 4, 30 positions (chunks 8, 8, 8, 6) and 3 (chunks 1, 1, 1
    and none): the sp train step within the reference's bounds, and at
    3 the f32 prefill and 4 decode steps within DENSE_RTOL of the
    reference's largest logit, the last position taken from rank 2."""
    _hold_train(runs, f"dense_s{seq}", f"dense_s{seq}", "dense")
    if seq == 3:
        got = _joined(runs, "dense_s3_serve")
        g = gaps(got, runs["ref"]["dense_s3_serve"])
        _hold(g, DENSE_RTOL * g["scale"])


if __name__ == "__main__":
    # the measured gaps: python tests/test_torch_dist_sp.py
    import json
    import tempfile
    import time
    from pathlib import Path
    with tempfile.TemporaryDirectory() as tmpd:
        t0 = time.monotonic()
        r = collect(Path(tmpd))
        out = {"seconds": time.monotonic() - t0}
        for key in KEYS:
            out[key] = {n: train_gaps(r, f"{key}_{n}", f"{key}_{n[:2]}")
                        for n in list(MESHES) + ["14_off"]}
        for s in ODD:
            out[f"dense_s{s}"] = train_gaps(r, f"dense_s{s}", f"dense_s{s}")
        for key in SERVED:
            for m in MESHES:
                name = f"{key}_{m}_packed"
                out[name] = {"sharded": gaps(_joined(r, name), r["ref"][name]),
                             "one_device": gaps(r["single"][key],
                                                r["ref"][name])}
        out["dense_s3_serve"] = gaps(_joined(r, "dense_s3_serve"),
                                     r["ref"]["dense_s3_serve"])
        print(json.dumps(out, indent=1))
