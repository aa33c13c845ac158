"""Port parity: sharded serving of every block kind and of the
encoder-decoder model (``model.shard_for_serving``, then
``model.prefill`` and ``model.decode_step`` with ``shards``) on four
gloo ranks of this machine's CPU, against the port's one-device prefill
and decode and against the reference's ``M.prefill`` /
``M.decode_step``.

The ranks are processes of ``tests/torch_dist_worker.py`` (torch and
the port only), every case in one launch (a file rendezvous under the
test's ``tmp_path``, a 60 s process-group timeout, a 240 s deadline).
Weights are the reduced configs' (vocabulary 512, f32) from ``repro``
(``PRNGKey(0)``), quantized data-free unfused (ratio 0.2, multiple 8,
min_dim 32; ``tests/jax_mesh_ref.serve_params``) and placed by
``launch.qdeclare.declare_quantized``'s specs, or the f32 weights
themselves (the ``dense`` cases) placed by ``specs_for_tree``'s, each
carried across by the bridge:

* granite-moe-1b-a400m with 2 moe layers (4 experts, top-2, d_ff 128)
  on (1, 4) with EP (its experts stored over "model") and on (2, 2)
  without (their ffn over "model").  Either way the packed experts
  serve in the reference's layout: wg / wu over ffn, g·u gathered over
  "model", wd whole.  At data 2 each data rank routes its own rows in
  prefill (the reference's group-local ``_apply_moe_shard_map``), so
  that case is held against the reference's jitted prefill and decode
  under the same (2, 2) mesh of four host devices
  (``tests/jax_mesh_ref.py serve``) and against the port on one device
  prefilling each data rank's rows alone; decode (rows of one token)
  routes the whole batch in both packages.  A mutant that routes the
  whole batch in prefill too must part from the mesh reference by more
  than 10x its tolerance.
* recurrentgemma-2b (rglru, rglru, local, then rglru; 4 query heads
  over 1 KV head, rnn 64), xlstm-1.3b (7 mlstm, 1 slstm; 4 heads) and
  seamless-m4t-medium (2 encoder layers, 1 decoder layer; 4 / 2 heads,
  16 stub frames a row made by numpy from a seed), each on (1, 4) and
  (2, 2); recurrentgemma and xlstm also on their f32 weights.
* recurrentgemma and xlstm at batch 1 on (2, 2) with ``shard_batch``
  off (the reference's ``long_500k`` layout): both data ranks serve the
  one row (the first prompt).

Four rows of 32 tokens, left-padded, 32, 21, 9 and 27 live; ring caches
of 48 (recurrentgemma's local window of 32 turns over in decode); 4
greedy decode steps.  Each rank's caches after the prefill and after
every step have the local shapes of ``model.declare_caches``' specs
under the case's rules (the recurrent state of an rglru block over
"model", the xLSTM state whole on every model rank), and every part
that two ranks hold alike has the same bits on both.

Tolerances.
* Against the port on one device, ``ATOL`` = 2e-3 on the logits (about
  0.5 in granite and recurrentgemma, 4 in xlstm and seamless), as
  ``tests/test_torch_dist_serve.py`` derives it: the sharded products
  differ only in the order of f32 sums (a row product sums its ranks'
  f32 partials before its one rounding), so a packed output is the one
  device's or one bf16 ulp apart where a sum straddles a rounding
  boundary, and the model carries that to the logits.  Measured (``python
  tests/test_torch_dist_serve_kinds.py`` prints every gap): at most
  3.2e-4 (recurrentgemma at tp 4, one straddle in the first step), the
  xLSTM's exactly 0.
* seamless's encoder is held apart: through its 14 packed products such
  a straddle is met in most inputs (``tests/test_torch_encdec.py``
  measured the same between the two packages), and the decoder carries
  it to the logits: its cross K/V are packed outputs of the encoder's,
  and an encoder output 2.0e-4 apart (measured) moves some of them by a
  bf16 ulp, the logits by 1.4e-2.  So the sharded encoder's output is
  held to the one device's within ``ATOL`` (a straddled product output
  moves the stream by one bf16 ulp of that output, 2^-8 of it), and
  the decoder's prefill and steps run from the reference's encoder
  output on every side (``worker.encoder_output``), as
  ``tests/test_torch_encdec.py`` runs them, also at ``ATOL``.
* Against the reference, ``REF_ATOL`` = 4e-3 where the port on one
  device meets the reference's roundings (granite, seamless's decoder),
  ``tests/test_torch_dist_serve.py``'s bound (two straddled roundings).
  On the packed recurrentgemma and xlstm the port on one device already
  parts from the reference by the open gaps of ROADMAP queue 3 (the
  doubling scan; the xLSTM amplifying summation order through its 8
  blocks, ground rules): 4.7e-3 and 4.2e-2 measured.  There the
  sharded run must lie within ``ATOL`` of the one device's own gap, and
  on the f32 weights, where nothing is rounded to bf16, within
  ``DENSE_RTOL`` = 1e-4 of the reference's largest logit, the bound of
  ``tests/test_torch_xlstm_model.py`` (measured below 1e-5).
* Greedy tokens equal to both, or a near-tie shown: where they part,
  the compared side's top-2 gap at that step lies within the tolerance.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import jax_mesh_ref as JR  # noqa: E402
import torch_dist_worker as W  # noqa: E402

from repro.models import model as RM  # noqa: E402
from repro.models.common import Parallel as RParallel  # noqa: E402
from repro_torch import bridge, pytree  # noqa: E402
from repro_torch.core.select import map_tree  # noqa: E402
from repro_torch.distributed.sharding import Rules  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.common import Parallel  # noqa: E402

ATOL = 2e-3           # against the port on one device (see above)
REF_ATOL = 4e-3       # against the reference: two straddled roundings
DENSE_RTOL = 1e-4     # f32 weights against the reference, of max|logit|
MUTANT_MIN = 10 * REF_ATOL
ARCHS = {"moe": ("granite-moe-1b-a400m", 2), "rg": ("recurrentgemma-2b", 0),
         "xl": ("xlstm-1.3b", 0), "s2t": ("seamless-m4t-medium", 0)}
MESHES = {"m14": (1, 4), "m22": (2, 2)}


def _case(model, mesh, ep=False, shard_batch=True, packed=True):
    return {"model": model, "mesh": mesh, "ep": ep,
            "shard_batch": shard_batch, "packed": packed}


CASES = {"moe_m14_ep": _case("moe", "m14", ep=True),
         "moe_m22": _case("moe", "m22"),
         **{f"{m}_{k}": _case(m, k) for m in ("rg", "xl", "s2t")
            for k in MESHES},
         **{f"{m}_b1": _case(m, "m22", shard_batch=False)
            for m in ("rg", "xl")},
         **{f"{m}_dense_{k}": _case(m, k, packed=False)
            for m in ("rg", "xl") for k in MESHES}}
LENS, BUCKET, MAX_SEQ, STEPS, CHUNK, FRAMES = (32, 21, 9, 27), 32, 48, 4, \
    1024, 16
QCFG = dict(ratio=JR.SERVE_QUANT[0], multiple=JR.SERVE_QUANT[1])


def _prompts():
    rng = np.random.default_rng(7)
    toks = np.zeros((len(LENS), BUCKET), np.int32)
    pos = np.full((len(LENS), BUCKET), -1, np.int32)
    for i, n in enumerate(LENS):
        toks[i, BUCKET - n:] = rng.integers(1, 500, size=n)
        pos[i, BUCKET - n:] = np.arange(n)
    return toks, pos


def _inputs(cfg, rows=slice(None)) -> dict:
    """The prompts (numpy), with ``frames`` for an encoder-decoder
    model."""
    toks, pos = _prompts()
    out = {"tokens": toks[rows], "positions": pos[rows]}
    if cfg.enc_dec:
        rng = np.random.default_rng(0)
        out["frames"] = rng.standard_normal(
            (len(LENS), FRAMES, cfg.d_model)).astype(np.float32)[rows]
    return out


def _batch(cfg, rows=slice(None)) -> dict:
    return {k: torch.from_numpy(v) for k, v in _inputs(cfg, rows).items()}


def _ref_key(name: str) -> str:
    """The reference run a case is held against."""
    c = CASES[name]
    if name == "moe_m22":
        return name
    return c["model"] + ("" if c["packed"] else "_dense")


def one_device(name: str) -> str:
    """The key of ``runs["single"]`` a case is held against."""
    c = CASES[name]
    if name == "moe_m22":
        return "moe_grouped"
    if not c["shard_batch"]:
        return name
    return c["model"] + ("" if c["packed"] else "_dense")


def _rows(name: str):
    return slice(None) if CASES[name]["shard_batch"] else slice(0, 1)


def _cat_caches(parts):
    """Caches of row groups joined along the batch (dim 1)."""
    if isinstance(parts[0], dict):
        return {k: _cat_caches([p[k] for p in parts]) for k in parts[0]}
    if isinstance(parts[0], (list, tuple)):
        return type(parts[0])(_cat_caches(list(c)) for c in zip(*parts))
    return torch.cat(parts, dim=1)


def _grouped(cfg, params, batch, groups: int):
    """The port on one device computing the group-local function of
    ``groups`` data ranks: each group of rows prefilled alone (its MoE
    routes its rows with their capacity), then the whole batch
    decoded."""
    n = batch["tokens"].shape[0] // groups
    outs = []
    with torch.no_grad():
        for g in range(groups):
            part = {k: v[g * n:(g + 1) * n] for k, v in batch.items()}
            outs.append(TM.prefill(cfg, params, part, MAX_SEQ, CHUNK))
        logits = torch.cat([o[0] for o in outs])
        caches = _cat_caches([o[1] for o in outs])
        out = {"prefill": logits[:, 0].clone(), "steps": [], "tokens": []}
        tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        pos = batch["positions"][:, -1] + 1
        for _ in range(STEPS):
            out["tokens"].append(tok.clone())
            logits, caches = TM.decode_step(cfg, params, tok, pos, caches,
                                            MAX_SEQ)
            out["steps"].append(logits.clone())
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            pos = pos + 1
    return out


def _stages(cfg):
    return [(tuple(s.pattern), s.repeats) for s in cfg.stages]


def collect(tmp):
    """Every case on four gloo ranks in one launch, beside the
    reference's runs (its (2, 2) mesh run of granite and its one-device
    recurrentgemma and xlstm, each in a process of its own); meanwhile
    the reference's one-device granite and seamless and the port's
    one-device runs here."""
    toks, pos = _prompts()
    common = {"max_seq": MAX_SEQ, "steps": STEPS, "attn_chunk": CHUNK}
    procs = [JR.start_serve(tmp, "moe", {"tokens": toks, "positions": pos,
                                         **common},
                            [("moe_m22", *ARCHS["moe"], 2, 2, False, True)])]
    for m in ("rg", "xl"):
        procs.append(JR.start_serve(
            tmp, m, {"tokens": toks, "positions": pos, **common},
            [(m, *ARCHS[m], 1, 1, False, True),
             (m + "_dense", *ARCHS[m], 1, 1, False, False)]))
    ranks_h = None
    mp = pytest.MonkeyPatch()
    JR.kernel_route(mp.setattr)
    n = torch.get_num_threads()
    try:
        rcfgs, rparams, params, cfgs = {}, {}, {}, {}
        for m, (arch, repeats) in ARCHS.items():
            rcfgs[m] = JR.reduced(arch, repeats)
            rparams[m] = JR.serve_params(rcfgs[m])
            params[m] = bridge.params_from_repro(jax.tree.map(np.asarray,
                                                              rparams[m]))
            cfgs[m] = W.kind_cfg({"arch": arch,
                                  "stages": _stages(rcfgs[m])})
        for m in ("rg", "xl"):
            params[m + "_dense"] = bridge.params_from_repro(
                JR.params_f32(rcfgs[m]))
        # the reference's encoder output, from which every side's
        # seamless decoder runs (see the module docstring)
        renc = RM.encode(rcfgs["s2t"], RParallel(attn_chunk=CHUNK),
                         rparams["s2t"],
                         jnp.asarray(_inputs(cfgs["s2t"])["frames"]))[0]
        enc_out = torch.from_numpy(np.array(renc))
        cases = {}
        for name, c in CASES.items():
            m = c["model"]
            p = params[m if c["packed"] else m + "_dense"]
            cases[name] = {
                "task": "serve_kinds", "arch": ARCHS[m][0],
                "stages": _stages(cfgs[m]), "params": W.pack_tree(p),
                "mesh": MESHES[c["mesh"]], "ep": c["ep"],
                "shard_batch": c["shard_batch"], "packed": c["packed"],
                "qcfg": QCFG, "min_dim": JR.SERVE_QUANT[2], **common,
                **_batch(cfgs[m], _rows(name))}
            if m == "s2t":
                cases[name]["enc_out"] = enc_out
        cases["mutant"] = dict(cases["moe_m22"], mutant=True)
        torch.set_num_threads(1)
        ranks_h = W.start(cases, tmp)
        torch.set_num_threads(n)
        ref = {m: JR.serve_eager(rcfgs[m], rparams[m], _inputs(cfgs[m]),
                                 MAX_SEQ, STEPS, CHUNK)
               for m in ("moe", "s2t")}
        single = {}
        for m in ARCHS:
            single[m] = W.serve_tokens(cfgs[m], params[m], _batch(cfgs[m]),
                                       MAX_SEQ, STEPS, CHUNK)
        for m in ("rg", "xl"):
            single[m + "_dense"] = W.serve_tokens(
                cfgs[m], params[m + "_dense"], _batch(cfgs[m]), MAX_SEQ,
                STEPS, CHUNK)
            single[m + "_b1"] = W.serve_tokens(
                cfgs[m], params[m], _batch(cfgs[m], slice(0, 1)), MAX_SEQ,
                STEPS, CHUNK)
        single["moe_grouped"] = _grouped(cfgs["moe"], params["moe"],
                                         _batch(cfgs["moe"]), 2)
        with W.encoder_output([], enc_out):
            single["s2t_fixed"] = W.serve_tokens(
                cfgs["s2t"], params["s2t"], _batch(cfgs["s2t"]), MAX_SEQ,
                STEPS, CHUNK)
        with torch.no_grad():
            single["s2t_enc"] = TM.encode(
                cfgs["s2t"], params["s2t"], _batch(cfgs["s2t"])["frames"],
                CHUNK)[0]
        ranks = W.finish(ranks_h)
        ranks_h = None
        for proc in procs:
            JR.finish(proc, 150.0)
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
    for name in ("moe_m22", "rg", "rg_dense", "xl", "xl_dense"):
        ref[name] = JR.read_serve(tmp / f"{name}.npz")
    ref["moe"], ref["s2t"] = _as_run(ref["moe"]), _as_run(ref["s2t"])
    return {"ranks": ranks, "single": single, "ref": ref, "cfgs": cfgs}


def _as_run(res: dict) -> dict:
    """``serve_eager``'s arrays as {"prefill", "steps", "tokens"}."""
    return {"prefill": res["prefill"],
            "steps": [res[f"step{i}"] for i in range(STEPS)],
            "tokens": [res[f"token{i}"] for i in range(STEPS)]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return collect(tmp_path_factory.mktemp("dist_serve_kinds"))


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
    out = {"prefill": torch.cat([p["prefill"] for p in parts]),
           "steps": [torch.cat([p["steps"][i] for p in parts])
                     for i in range(STEPS)],
           "tokens": [torch.cat([p["tokens"][i] for p in parts])
                      for i in range(STEPS)]}
    if "enc_out" in parts[0]:
        out["enc_out"] = torch.cat([p["enc_out"] for p in parts])
    return out


def _as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def gaps(got, want, rows=slice(None)):
    """Largest logit gaps of the prefill and of each decode step (a row
    compared while its greedy tokens agree), the near-ties where the
    tokens part ((step, row, want's top-2 gap)), and want's largest
    logit; ``rows`` picks want's rows (the batch-1 cases)."""
    pick = lambda a: _as_np(a)[rows]  # noqa: E731
    out = {"prefill": float(np.abs(_as_np(got["prefill"])
                                   - pick(want["prefill"])).max()),
           "steps": [], "ties": [],
           "scale": float(max(np.abs(pick(w)).max() for w in
                              [want["prefill"]] + list(want["steps"])))}
    live = np.ones(_as_np(got["prefill"]).shape[0], bool)
    for i in range(STEPS):
        gt, wt = _as_np(got["tokens"][i]), pick(want["tokens"][i])
        for row in np.nonzero(live & (gt != wt))[0]:
            prev = pick(want["prefill"] if i == 0 else
                        want["steps"][i - 1])[row]
            top = np.sort(prev)[-2:]
            out["ties"].append((i, int(row), float(top[1] - top[0])))
        live &= gt == wt
        d = np.abs(_as_np(got["steps"][i]) - pick(want["steps"][i]))
        out["steps"].append(float(d[live].max()) if live.any() else 0.0)
    return out


def _worst(g) -> float:
    return max([g["prefill"]] + g["steps"])


def _hold(g, atol):
    assert _worst(g) <= atol, g
    assert all(gap <= atol for _, _, gap in g["ties"]), g


def _decoder(runs, name):
    """What a case is held by: seamless's decoder from the given encoder
    output (``fixed``), else the case's own run."""
    if CASES[name]["model"] == "s2t":
        return _joined(runs, name, "fixed")
    return _joined(runs, name)


def one_device_gaps(runs, name):
    single = runs["single"]
    key = "s2t_fixed" if CASES[name]["model"] == "s2t" else one_device(name)
    return gaps(_decoder(runs, name), single[key])


def reference_gaps(runs, name):
    return gaps(_decoder(runs, name), runs["ref"][_ref_key(name)],
                _rows(name))


def _model_cases(model):
    return [n for n, c in CASES.items() if c["model"] == model]


@pytest.mark.parametrize("model", list(ARCHS))
def test_sharded_serving_matches_one_device(runs, model):
    """Every case of the model against the port on one device: the
    prefill logits and 4 greedy steps within ATOL; seamless's decoder
    from the reference's encoder output, and its sharded encoder output
    within ATOL of the one device's."""
    for name in _model_cases(model):
        _hold(one_device_gaps(runs, name), ATOL)
        if model == "s2t":
            enc = _joined(runs, name)["enc_out"]
            gap = float((enc - runs["single"]["s2t_enc"]).abs().max())
            assert gap <= ATOL, (name, gap)


@pytest.mark.parametrize("model", list(ARCHS))
def test_sharded_serving_matches_reference(runs, model):
    """Every case of the model against the reference (granite at data 2
    against the reference under the same mesh): REF_ATOL, but on the
    packed recurrentgemma and xlstm, the one device's own gap plus ATOL,
    and on their f32 weights DENSE_RTOL of the largest logit."""
    for name in _model_cases(model):
        c = CASES[name]
        g = reference_gaps(runs, name)
        if not c["packed"]:
            _hold(g, DENSE_RTOL * g["scale"])
        elif model in ("rg", "xl"):
            own = gaps(runs["single"][model], runs["ref"][model])
            assert not own["ties"], own
            _hold(g, _worst(own) + ATOL)
        else:
            _hold(g, REF_ATOL)


def _local_shape(shape, spec, mesh):
    sizes = dict(zip(("data", "model"), mesh))
    out = []
    for size, entry in zip(shape, spec):
        names = (entry,) if isinstance(entry, str) else tuple(entry or ())
        n = 1
        for name in names:
            n *= sizes[name]
        assert size % n == 0, (shape, spec, mesh)
        out.append(size // n)
    return tuple(out)


def cache_specs(name, cfg):
    """The case's decode caches as declared (``model.declare_caches``),
    each leaf's Spec under the case's rules (the batch dim, after the
    stacked layers, off the data dims when the batch is not sharded, as
    ``launch.inputs.decode_inputs`` takes it)."""
    c = CASES[name]
    dp, tp = MESHES[c["mesh"]]
    par = Parallel(tp=tp, dp=dp, shard_batch=c["shard_batch"])
    rules = Rules(ep=c["ep"])
    b = len(LENS) if c["shard_batch"] else 1
    decl = TM.declare_caches(cfg, par, b, MAX_SEQ,
                             enc_len=FRAMES if cfg.enc_dec else 0)

    def spec(_, p):
        s = tuple(rules.spec(p.axes))
        if not c["shard_batch"]:
            s = tuple(None if i == 1 else a for i, a in enumerate(s))
        return SimpleNamespace(shape=tuple(p.shape), spec=s)
    return map_tree(decl, spec)


def test_caches_have_the_declared_local_shapes(runs):
    """After the prefill and after each step, each rank's caches have
    the local shapes of the declared specs, and a part that two ranks
    both hold (their coordinates equal on the mesh dims the leaf is
    split over) has the same bits on both."""
    for name, c in CASES.items():
        mesh = MESHES[c["mesh"]]
        want = pytree.leaves_with_path(cache_specs(
            name, runs["cfgs"][c["model"]]))
        snaps = len(runs["ranks"][0][name]["caches"])
        assert snaps == STEPS + 1, (name, snaps)
        for i in range(snaps):
            held = {}
            for rk in runs["ranks"]:
                r = rk[name]
                got = pytree.leaves_with_path(r["caches"][i])
                assert [k for k, _ in got] == [k for k, _ in want], name
                for (key, t), (_, w) in zip(got, want):
                    assert tuple(t.shape) == _local_shape(w.shape, w.spec,
                                                          mesh), \
                        (name, key, tuple(t.shape), w.shape, w.spec)
                    over = {n for e in w.spec for n in
                            ((e,) if isinstance(e, str) else (e or ()))}
                    coord = tuple(x for d, x in zip(("data", "model"),
                                                    r["coords"])
                                  if d in over)
                    held.setdefault((key, coord), []).append(t)
            for (key, _), parts in held.items():
                for t in parts[1:]:
                    assert torch.equal(t, parts[0]), (name, key, i)


def test_whole_batch_routing_parts_from_the_mesh_reference(runs):
    """Granite at data 2 with every data rank routing the whole batch in
    prefill (``worker.whole_batch_moe``) parts from the reference under
    the mesh by more than 10x REF_ATOL, as the port on one device does
    with the whole batch: the test above holds the group-local
    function."""
    g = gaps(_joined(runs, "mutant"), runs["ref"]["moe_m22"])
    assert g["prefill"] > MUTANT_MIN, g
    g = gaps(runs["single"]["moe"], runs["ref"]["moe_m22"])
    assert g["prefill"] > MUTANT_MIN, g


if __name__ == "__main__":
    # the measured gaps: python tests/test_torch_dist_serve_kinds.py
    import json
    import tempfile
    import time
    from pathlib import Path
    with tempfile.TemporaryDirectory() as d:
        t0 = time.monotonic()
        r = collect(Path(d))
        out = {"seconds": time.monotonic() - t0}
        for name in CASES:
            out[name] = {"one_device": one_device_gaps(r, name),
                         "reference": reference_gaps(r, name)}
            if CASES[name]["model"] == "s2t":
                out[name]["encoder"] = float(
                    (_joined(r, name)["enc_out"]
                     - r["single"]["s2t_enc"]).abs().max())
        out["one_device_vs_reference"] = {
            m: gaps(r["single"][m], r["ref"][m])
            for m in ("moe", "rg", "xl", "rg_dense", "xl_dense")}
        out["mutant"] = gaps(_joined(r, "mutant"), r["ref"]["moe_m22"])
        print(json.dumps(out, indent=1))
