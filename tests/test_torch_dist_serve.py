"""Port parity: sharded serving of packed PTQ1.61 weights
(``model.shard_for_serving``, then ``model.prefill`` and
``model.decode_step`` with ``shards``) on four gloo ranks of this
machine's CPU, against the port's one-device prefill and decode and
against the reference's ``M.prefill`` / ``M.decode_step``.

The ranks are processes of ``tests/torch_dist_worker.py`` (torch and
the port only), all cases in one launch (a file rendezvous under the
test's ``tmp_path``, a 60 s process-group timeout, a 240 s deadline).
Weights are built in ``repro``, cast to f32, quantized data-free
unfused (ratio 0.2, multiple 8) and carried across by the bridge.  Two
models of two dense layers (d 64, d_ff 128): "dense", reduced
qwen2.5-3b with 4 KV heads (each rank projects its own), qkv bias, an
untied head and vocab 500 padded to 512 (the last vocabulary shard
holds padding); "qwen3", qk norms, 8 query / 2 KV heads of 16, tied,
so tp 4 replicates the KV heads at run time (``_kv_replicated``
gathers the packed wk / wv along N).  Meshes (data, model): (1, 4) and
(2, 2).  The row-parallel leaves' byte rows split unevenly over the
"model" ranks at tp 4 (wo: 6 sign rows, or 13; wd: 13; asserted).  Four rows
of 16 tokens, left-padded to 16, 5 to 16 live; ring caches of 32; 4
greedy decode steps.

Tolerances.
* Against the port on one device: the sharded product differs only in
  the order of f32 sums: the row-parallel product sums its f32 partials
  over the ranks (gloo's order) before its one rounding, and the
  column and attention products sum over fewer columns per call.  So a
  packed product's bf16 output is the one device's or one bf16 ulp
  (2^-8 of the output) apart where an f32 sum straddles a rounding
  boundary; a flip moves the stream by that much, and the two layers
  and the head carry it to the logits.  Logits within 2e-3 absolute
  (logits are about 1; the cross-package bound of
  ``tests/test_torch_model.py``, whose cause is the same), measured
  below it in every case (``python tests/test_torch_dist_serve.py``
  prints the gaps).
* Against the reference: the reference's packed products run on its
  kernel path (``repro_kernel_everywhere``), as in
  ``tests/test_torch_model.py``, whose bound for packed weights is 2e-3
  for the same cause.  Here the port on one device already parts from
  the reference by such roundings: in "qwen3" layer 0's K/V agree
  within 1e-5, but a packed product of layer 0 rounds an output the
  other way (its f32 input 1e-7 apart), and layer 1's V then parts in
  39 of 4096 elements, each by a whole number of bf16 ulps (one to
  ten: small values); the logits part by up to 2.05e-3 (measured),
  above 2e-3.  The test shows the cause (layer 0's V equal, every gap
  of V beyond 1e-5 a whole number of bf16 ulps) and holds the logits at
  4e-3; the sharded path adds at most 1e-6 to the one device's gap
  (the first bound).
* Greedy tokens equal to both, or a near-tie shown: where they part,
  the one device's top-2 gap at that step lies within the tolerance.
A mutant (each rank gathers its channels by the spec's own chunk of
``perm``, not by the perm of its byte rows) must part from one device
by more than 10x the tolerance.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import jax_mesh_ref as JR  # noqa: E402
import torch_dist_worker as W  # noqa: E402

from repro.configs import registry as r_registry  # noqa: E402
from repro.configs.base import Stage as RStage  # noqa: E402
from repro.core.pipeline import quantize_params_data_free as r_qdf  # noqa: E402
from repro.core.qlinear import QuantConfig as RQC  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.common import Parallel as RParallel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.core.pipeline import quantize_params_data_free  # noqa: E402
from repro_torch.core.qlinear import QLinear  # noqa: E402
from repro_torch.core.qlinear import QuantConfig as TQC  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.common import Parallel  # noqa: E402

ATOL = 2e-3           # against the port on one device (see above)
REF_ATOL = 4e-3       # against the reference: two straddled roundings
MUTANT_MIN = 10 * ATOL
MODELS = {"dense": {"n_kv_heads": 4, "tied_embeddings": False,
                    "vocab": 500},
          "qwen3": {"n_heads": 8, "n_kv_heads": 2, "qk_norm": True,
                    "qkv_bias": False}}
MESHES = {"m14": (1, 4), "m22": (2, 2)}
CASES = [(m, k) for m in MODELS for k in MESHES]
LENS, BUCKET, MAX_SEQ, STEPS, CHUNK = (16, 11, 5, 13), 16, 32, 4, 1024
QCFG = dict(ratio=0.2, multiple=8)


def _rcfg(over):
    over = dict(over)
    cfg = r_registry.get("qwen2.5-3b").reduced()
    return dataclasses.replace(cfg, stages=(RStage(("dense",), 2),), **over)


def _prompts():
    rng = np.random.default_rng(7)
    toks = np.zeros((len(LENS), BUCKET), np.int32)
    pos = np.full((len(LENS), BUCKET), -1, np.int32)
    for i, n in enumerate(LENS):
        toks[i, BUCKET - n:] = rng.integers(1, 500, size=n)
        pos[i, BUCKET - n:] = np.arange(n)
    return toks, pos


def _reference(rcfg, rp, toks, pos):
    """The reference's prefill (its caches too) and greedy decode steps
    (its packed products through its Pallas kernel in interpret
    mode)."""
    par = RParallel(attn_chunk=CHUNK)
    logits, caches = RM.prefill(rcfg, par, rp, {
        "tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)}, MAX_SEQ)
    out = {"prefill": np.asarray(logits[:, 0]), "steps": [], "tokens": [],
           "kv": [np.asarray(caches[0][0][k]) for k in ("k", "v")]}
    tok = jnp.argmax(logits[:, 0], axis=-1).astype(jnp.int32)
    p = jnp.asarray(pos[:, -1] + 1)
    for _ in range(STEPS):
        out["tokens"].append(np.asarray(tok))
        logits, caches = RM.decode_step(rcfg, par, rp, tok, p, caches,
                                        MAX_SEQ)
        out["steps"].append(np.asarray(logits))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        p = p + 1
    return out


def collect(tmp):
    toks, pos = _prompts()
    params, ref = {}, {}
    mp = pytest.MonkeyPatch()
    JR.kernel_route(mp.setattr)
    try:
        for name, over in MODELS.items():
            rcfg = _rcfg(over)
            p = RM.init_params(rcfg, RParallel(), jax.random.PRNGKey(1))
            p = jax.tree.map(lambda a: a.astype(jnp.float32)
                             if a.dtype == jnp.bfloat16 else a, p)
            rp = r_qdf(p, RQC(use_kernel=True, **QCFG), min_dim=32,
                       fuse=False)
            params[name] = bridge.params_from_repro(jax.tree.map(np.asarray,
                                                                 rp))
            ref[name] = _reference(rcfg, rp, toks, pos)
    finally:
        mp.undo()
    batch = {"tokens": torch.from_numpy(toks),
             "positions": torch.from_numpy(pos)}
    cases = {f"{m}_{k}": {"task": "serve", "cfg": MODELS[m],
                          "params": W.pack_tree(params[m]),
                          "mesh": MESHES[k], "tokens": batch["tokens"],
                          "positions": batch["positions"],
                          "max_seq": MAX_SEQ, "steps": STEPS,
                          "attn_chunk": CHUNK} for m, k in CASES}
    cases["mutant"] = dict(cases["qwen3_m14"], mutant=True)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ranks = W.launch(cases, tmp)
        single = {m: W.serve_tokens(W.serve_cfg(MODELS[m]), params[m],
                                    batch, MAX_SEQ, STEPS, CHUNK)
                  for m in MODELS}
        for m in MODELS:
            with torch.no_grad():
                _, c = TM.prefill(W.serve_cfg(MODELS[m]), params[m], batch,
                                  MAX_SEQ, CHUNK)
            single[m]["kv"] = [c[0][0][k].numpy() for k in ("k", "v")]
    finally:
        torch.set_num_threads(n)
    return {"ranks": ranks, "single": single, "ref": ref}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return collect(tmp_path_factory.mktemp("dist_serve"))


def _sharded(runs, name):
    """The case's rows joined over the data ranks (from model rank 0 of
    each; every model rank returns the same bits, asserted)."""
    got = [r[name] for r in runs["ranks"]]
    by_rows = {}
    for r in got:
        key = tuple(r["rows"])
        if key in by_rows:
            a = by_rows[key]
            assert torch.equal(a["prefill"], r["prefill"]), name
            assert all(torch.equal(x, y) for x, y in zip(a["steps"],
                                                         r["steps"])), name
        else:
            by_rows[key] = r
    parts = [by_rows[k] for k in sorted(by_rows)]
    return {"prefill": torch.cat([p["prefill"] for p in parts]),
            "steps": [torch.cat([p["steps"][i] for p in parts])
                      for i in range(STEPS)],
            "tokens": [torch.cat([p["tokens"][i] for p in parts])
                       for i in range(STEPS)],
            "views": [r["views"] for r in got]}


def _as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def gaps(got, want):
    """Largest logit gaps of the prefill and of each decode step (a row
    compared while its greedy tokens agree), and the near-ties where the
    tokens part: (step, row, want's top-2 gap)."""
    out = {"prefill": float(np.abs(_as_np(got["prefill"])
                                   - _as_np(want["prefill"])).max()),
           "steps": [], "ties": []}
    live = np.ones(len(LENS), bool)
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


def _hold(g, atol=ATOL):
    assert g["prefill"] <= atol, g
    assert max(g["steps"]) <= atol, g
    assert all(gap <= atol for _, _, gap in g["ties"]), g


@pytest.mark.parametrize("model,mesh", CASES)
def test_sharded_serving_matches_one_device(runs, model, mesh):
    got = _sharded(runs, f"{model}_{mesh}")
    _hold(gaps(got, runs["single"][model]))


def _straddles(got, want):
    """Per layer, the elements where the port's prefill V (a packed
    product's output, bf16 on both sides) parts from the reference's by
    more than 1e-5; each gap must be a whole number of bf16 ulps of the
    value (roundings that went the other way, not a different sum)."""
    d = np.abs(got[1] - want[1])
    far = d > 1e-5
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want[1][far]),
                                              1e-30))) - 7)
    steps = d[far] / ulp
    assert np.allclose(steps, np.round(steps), atol=1e-3), steps
    return far.reshape(far.shape[0], -1).sum(1).tolist()


@pytest.mark.parametrize("model", list(MODELS))
def test_sharded_serving_matches_reference(runs, model):
    flips = _straddles(runs["single"][model]["kv"], runs["ref"][model]["kv"])
    assert flips[0] == 0, flips                 # layer 0's V agrees
    for mesh in MESHES:
        _hold(gaps(_sharded(runs, f"{model}_{mesh}"), runs["ref"][model]),
              REF_ATOL)
    _hold(gaps(runs["single"][model], runs["ref"][model]), REF_ATOL)


def test_row_views_split_unevenly(runs):
    """Every row-parallel leaf's byte rows split unevenly over 4 model
    ranks (wd's also over 2), so the views differ in their channel
    counts."""
    for m, k in CASES:
        views = _sharded(runs, f"{m}_{k}")["views"]
        for leaf in (("wo", "wd") if k == "m14" else ("wd",)):
            ks = {tuple(v[leaf]) for v in views}
            assert len(ks) > 1, (m, k, leaf, ks)


def test_spec_perm_mutant_fails(runs):
    g = gaps(_sharded(runs, "mutant"), runs["single"]["qwen3"])
    assert g["prefill"] > MUTANT_MIN, g


def test_check_shardable_refuses_what_sharded_serving_does_not_run():
    """Sharded serving admits every block kind and the encoder-decoder
    model on unfused packed leaves; it refuses fused ``QLinearGroup``
    leaves (``NotImplementedError``, naming the roadmap item) and stored
    splits that do not divide tp (``ValueError``: here the d_ff); head
    counts that tp does not divide pass (each rank computes its whole
    heads); the train step still refuses packed leaves."""
    par = Parallel(tp=2)
    qc = TQC(**QCFG)
    dense = W.serve_cfg(MODELS["qwen3"])
    fp = TM.init_params(dense)
    TM.check_shardable(dense, par, quantize_params_data_free(
        fp, qc, min_dim=32), serving=True)
    with pytest.raises(NotImplementedError, match="queue 1"):
        TM.check_shardable(dense, par, quantize_params_data_free(
            fp, qc, min_dim=32, fuse=True), serving=True)
    with pytest.raises(NotImplementedError):     # training stays refused
        TM.check_shardable(dense, par, quantize_params_data_free(
            fp, qc, min_dim=32))
    for arch in ("granite-moe-1b-a400m", "recurrentgemma-2b", "xlstm-1.3b",
                 "seamless-m4t-medium"):
        cfg = t_registry.get(arch).reduced()
        packed = quantize_params_data_free(TM.init_params(cfg), qc,
                                           min_dim=32)
        for tp in (1, 2, 4):
            TM.check_shardable(cfg, Parallel(tp=tp), packed, serving=True)
        if arch != "xlstm-1.3b":       # the xLSTM projections never fuse
            with pytest.raises(NotImplementedError, match="queue 1"):
                TM.check_shardable(cfg, par, quantize_params_data_free(
                    TM.init_params(cfg), qc, min_dim=32, fuse=True),
                    serving=True)
    local = dataclasses.replace(dense, stages=(
        W.Stage(("dense", "local"), 1),))
    TM.check_shardable(local, par, serving=True)
    with pytest.raises(ValueError):               # an uneven d_ff stays
        TM.check_shardable(dataclasses.replace(dense, d_ff=136),
                           Parallel(tp=16), serving=True)
    for arch, tp in (("recurrentgemma-2b", 4), ("xlstm-1.3b", 16)):
        # 10 and 4 heads: each rank computes its whole heads
        TM.check_shardable(t_registry.get(arch), Parallel(tp=tp),
                           serving=True)
    assert isinstance(quantize_params_data_free(
        fp, qc, min_dim=32)["stages"][0][0][0]["attn"]["wo"], QLinear)

if __name__ == "__main__":
    import tempfile
    from pathlib import Path
    with tempfile.TemporaryDirectory() as d:
        r = collect(Path(d))
        for m, k in CASES:
            got = _sharded(r, f"{m}_{k}")
            print(m, k, "one device", gaps(got, r["single"][m]),
                  "reference", gaps(got, r["ref"][m]))
        print("one device vs reference",
              {m: gaps(r["single"][m], r["ref"][m]) for m in MODELS},
              "K/V straddles", {m: _straddles(r["single"][m]["kv"],
                                              r["ref"][m]["kv"])
                                for m in MODELS})
        print("mutant", gaps(_sharded(r, "mutant"), r["single"]["qwen3"]))
