"""The head layout of tensor parallelism over head counts that tp does
not divide, without ranks: every assigned architecture at full size,
at tp 4 and 16, on the production meshes ("pod": (16, tp) over ("data",
"model"); "multipod": (2, 16, tp) over ("pod", "data", "model")), with
each cell's preset (``launch.presets.make_preset``).

A rank's heads are ``Shards.heads``: ``distributed.sharding.
chunk_range``'s ceil layout (``torch.chunk``'s, DTensor's ``Shard`` and
GSPMD's padding), the trailing ranks short or empty.  The checks:

* each rank's query heads, and the KV head each of them reads
  (``layers.kv_index``) is the true head of its run-time KV head
  (``Parallel.kv_heads_run``, consecutive replicas);
* recurrentgemma-2b's RG-LRU: each rank's channels and the gate heads
  they cut, and their gates (``recurrent._rg_gates_cut`` on a rank's
  channels, the whole input handed in as the gather over "model"
  would give it) equal to the whole block-diagonal product's;
* every packed leaf of ``launch.qdeclare.declare_quantized`` (meta
  tensors): its rank views (``sharding.head_view`` for a query
  projection whose heads tp does not divide, else
  ``sharding.local_view``) add up to the leaf, columns or input
  channels;
* the decode caches a rank's prefill builds where the run-time KV heads
  do not divide tp (``layers._ctx_cache``, on meta tensors) have the
  local shapes of ``launch.inputs.decode_inputs``' specs, and the
  ranks' softmax partials over their chunks of such a cache combine to
  one device's decode attention (``layers.attend_split``);
* ``models.model.check_shardable`` accepts all ten, training and
  serving, and still refuses a fused leaf and an uneven d_ff.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import SHAPE_CELLS, cell_applicable  # noqa: E402
from repro_torch.core.pipeline import quantize_params_data_free  # noqa: E402
from repro_torch.core.qlinear import QLinear, QuantConfig  # noqa: E402
from repro_torch.core.select import map_tree  # noqa: E402
from repro_torch.distributed.sharding import (at, chunk_range,  # noqa: E402
                                              head_view, local_view,
                                              qlinear_role)
from repro_torch.launch import inputs as TI  # noqa: E402
from repro_torch.launch.presets import make_preset  # noqa: E402
from repro_torch.launch.qdeclare import declare_quantized  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import recurrent as R  # noqa: E402
from repro_torch.models.common import Parallel, Shards  # noqa: E402

ARCHS = list(registry.ASSIGNED)
TPS = (4, 16)
# the cuts of the production architectures at tp 16 (query heads per rank)
AT_16 = {"phi4-mini-3.8b": [2] * 12 + [0] * 4,
         "llava-next-34b": [4] * 14 + [0] * 2,
         "recurrentgemma-2b": [1] * 10 + [0] * 6,
         "xlstm-1.3b": [1] * 4 + [0] * 12}


class _Devices:
    def __init__(self, n):
        self.size = n


class _Mesh:
    """A mesh-shaped stub (the presets read dim sizes only)."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = names
        self.devices = _Devices(int(np.prod(shape)))


def meshes(tp):
    return {"pod": _Mesh((16, tp), ("data", "model")),
            "multipod": _Mesh((2, 16, tp), ("pod", "data", "model"))}


class _Rank(Shards):
    """Rank ``r`` of ``tp`` on the "model" dim, without a process group:
    the head layout of ``Shards``; ``gather_model`` hands back
    ``whole``, what the gather over "model" would give."""

    def __init__(self, tp, r, par, whole=None):
        self.tp, self.tp_rank, self.par, self.whole = tp, r, par, whole

    def gather_model(self, t, dim):
        return self.whole


def _presets(arch, tp, kind):
    cfg = registry.get(arch)
    for mname, mesh in meshes(tp).items():
        for cell in SHAPE_CELLS:
            if cell.kind == kind and cell_applicable(cfg, cell)[0]:
                yield mname, cell, make_preset(cfg, cell, mesh)


@pytest.mark.parametrize("tp", TPS)
def test_query_heads_and_the_kv_head_each_reads(tp):
    """The ranks' heads cover every query head once, in order, ceil(n /
    tp) a rank and the trailing ranks short or empty (AT_16 at tp 16);
    each local query head reads the KV head of its GQA group, the true
    head of its run-time KV head."""
    for arch in ARCHS:
        cfg = registry.get(arch)
        hq, hkv = cfg.n_heads, cfg.n_kv_heads
        for mname, cell, pre in _presets(arch, tp, "decode"):
            par = pre.par
            assert par.tp == tp
            run = par.kv_heads_run(hkv, hq)
            counts, seen = [], []
            for r in range(tp):
                lo, hi = _Rank(tp, r, par).heads(hq)
                assert (lo, hi) == chunk_range(hq, tp, r)
                counts.append(hi - lo)
                seen += range(lo, hi)
                kv = L.kv_index(hq, hkv, lo, hi).tolist()
                for j, h in zip(range(lo, hi), kv):
                    assert h == (j // (hq // run)) // (run // hkv), \
                        (arch, mname, r, j)
                    assert L.kv_index(hq, run, j, j + 1).item() // (
                        run // hkv) == h
            assert seen == list(range(hq)), (arch, mname)
            c = -(-hq // tp)
            assert counts == sorted(counts, reverse=True) and max(counts) == c
            if tp == 16 and arch in AT_16:
                assert counts == AT_16[arch], (arch, counts)


@pytest.mark.parametrize("tp", TPS)
def test_rglru_channels_and_the_gate_heads_they_cut(tp):
    """recurrentgemma-2b's 2560 rnn channels over tp ranks: a rank's
    R / tp channels lie in the gate heads of 320 that ``_rg_gates_cut``
    runs (at tp 16, half of head r // 2), and their gates equal the
    whole block-diagonal product's at those channels."""
    cfg = registry.get("recurrentgemma-2b")
    r_width = cfg.rnn_width
    hd = r_width // R.RG_HEADS
    gen = torch.Generator().manual_seed(0)
    p = {"w_inp": torch.randn((R.RG_HEADS, hd, hd), generator=gen) / hd,
         "w_rec": torch.randn((R.RG_HEADS, hd, hd), generator=gen) / hd}
    x = torch.randn((1, 2, r_width), generator=gen)
    gi, gr = R._rg_gates(p, x)
    per = r_width // tp
    for rank in range(tp):
        lo, hi = rank * per, (rank + 1) * per
        heads = list(range(lo // hd, -(-hi // hd)))
        if tp == 16:
            assert heads == [rank // 2] and per == hd // 2
        else:
            assert heads == [2 * rank, 2 * rank + 1]
        sh = _Rank(tp, rank, Parallel(tp=tp), whole=x)
        ci, cr = R._rg_gates_cut(p, x[..., lo:hi], sh)
        assert torch.allclose(ci, gi[..., lo:hi], rtol=1e-6, atol=1e-7)
        assert torch.allclose(cr, gr[..., lo:hi], rtol=1e-6, atol=1e-7)


def _views(q, role, heads, tp):
    if role == "column" and heads is not None and heads % tp:
        return [head_view(q, heads, r, tp) for r in range(tp)]
    return [local_view(q, role, r, tp) for r in range(tp)]


@pytest.mark.parametrize("tp", TPS)
def test_packed_views_add_up_to_the_leaf(tp):
    """Every packed leaf of every architecture's quantized declaration
    (serving cells): a column view's widths add up to N (a query
    projection's are its ranks' whole heads), a row view's channels to
    K, a replicated leaf is whole on every rank."""
    qcfg = QuantConfig(ratio=0.2, multiple=16)
    for arch in ARCHS:
        cfg = registry.get(arch)
        for mname, cell, pre in _presets(arch, tp, "decode"):
            abstract, specs = declare_quantized(cfg, pre.par, qcfg,
                                                pre.rules)
            declared = M.declare_params(cfg, pre.par)
            checked = []

            def leaf(path, q):
                if not isinstance(q, QLinear) or q.w4.ndim == 3:
                    return q
                role = qlinear_role(at(specs, path))
                heads = M.head_count(cfg, declared, path)
                views = _views(q, role, heads, tp)
                ns, ks = [v.n for v in views], [v.k for v in views]
                if role == "column":
                    assert sum(ns) == q.n and ks == [q.k] * tp, path
                    if heads is not None:
                        w = q.n // heads
                        assert ns == [w * (hi - lo) for lo, hi in (
                            chunk_range(heads, tp, r) for r in range(tp))]
                elif role == "row":
                    assert ns == [q.n] * tp and sum(ks) == q.k, path
                else:
                    assert ns == [q.n] * tp and ks == [q.k] * tp, path
                checked.append(path)
                return q
            map_tree(abstract, leaf)
            assert checked, (arch, mname)


@pytest.mark.parametrize("tp", TPS)
def test_ctx_caches_have_the_declared_local_shapes(tp):
    """Where the run-time KV heads do not divide tp, a rank's prefill
    builds caches of every run-time KV head over its chunk of the
    window (``layers._ctx_cache``, on meta tensors) whose shapes are the
    local shapes of ``decode_inputs``' specs, rank by rank."""
    seen = 0
    for arch in ARCHS:
        cfg = registry.get(arch)
        for mname, cell, pre in _presets(arch, tp, "decode"):
            par = pre.par
            (_, _, caches), (_, _, cspecs) = TI.decode_inputs(
                cfg, cell, par, pre.rules)
            sizes = dict(meshes(tp)[mname].shape)
            for si, stage in enumerate(cfg.stages):
                for pi, kind in enumerate(stage.pattern):
                    if kind not in ("dense", "moe", "local") or (
                            par.kv_heads_run(cfg.n_kv_heads, cfg.n_heads)
                            % tp == 0):
                        continue
                    decl = caches[si][pi]
                    decl = decl.get("self", decl)
                    spec = cspecs[si][pi]
                    spec = spec.get("self", spec) if isinstance(spec, dict) \
                        else spec
                    want = {}
                    for name in ("k", "v", "p"):
                        shape = decl[name].shape[1:]
                        ent = tuple(spec[name])[1:]
                        want[name] = tuple(
                            s // int(np.prod([sizes[n] for n in (
                                (e,) if isinstance(e, str) else e or ())]))
                            for s, e in zip(shape, ent))
                    b, w = want["p"]
                    meta = dict(device="meta")
                    k = torch.empty((b, w, cfg.n_kv_heads, cfg.head_dim_),
                                    **meta)
                    pos = torch.empty((b, w), dtype=torch.int32, **meta)
                    for r in range(tp):
                        got = L._ctx_cache(cfg, k, k, pos, w,
                                           _Rank(tp, r, par))
                        for name in ("k", "v", "p"):
                            assert tuple(got[name].shape) == want[name], (
                                arch, mname, cell.name, kind, name, r)
                    seen += 1
    if tp == 16:
        assert seen, "no context-sharded cache at tp 16"


@pytest.mark.parametrize("tp", TPS)
def test_check_shardable_accepts_the_production_head_counts(tp):
    """All ten assigned architectures pass ``check_shardable`` at tp in
    training and in serving; a fused packed leaf and a d_ff that does
    not split still raise."""
    for arch in ARCHS:
        cfg = registry.get(arch)
        M.check_shardable(cfg, Parallel(tp=tp))
        M.check_shardable(cfg, Parallel(tp=tp), serving=True)
    small = dataclasses.replace(registry.get("phi4-mini-3.8b").reduced(),
                                n_heads=6, n_kv_heads=2)
    fused = quantize_params_data_free(M.init_params(small),
                                      QuantConfig(ratio=0.25, multiple=16),
                                      min_dim=32, fuse=True)
    with pytest.raises(NotImplementedError, match="queue 1"):
        M.check_shardable(small, Parallel(tp=tp), fused, serving=True)
    with pytest.raises(ValueError, match="d_ff"):
        M.check_shardable(dataclasses.replace(small, d_ff=tp * 8 + 2),
                          Parallel(tp=tp))


@pytest.mark.parametrize("tp", TPS)
def test_ctx_decode_combine_matches_one_device(tp):
    """The context-sharded decode: each of tp chunks of an f32 ring's
    slots attends every head (``layers.attend_split``) and the parts'
    maxima, sums and accumulators combine as the all-reduces over
    "model" do (``layers.drive_split``); every part ends with the same
    output, one device's decode attention (``layers._attend``) over the
    whole ring within 1e-5 of its largest value: rows of one key, of a
    ring that has turned over, and of none (spread evenly on both
    sides)."""
    gen = torch.Generator().manual_seed(tp)
    b, w, hkv, hq, dh = 4, 8 * tp, 2, 6, 16
    k = torch.randn((b, w, hkv, dh), generator=gen)
    v = torch.randn((b, w, hkv, dh), generator=gen)
    q = torch.randn((b, 1, hq, dh), generator=gen)
    lens = torch.tensor([w + 5, w // 2, 1, 0])
    last = lens[:, None] - 1
    kp = last - torch.remainder(last - torch.arange(w), w)
    kp = torch.where((kp >= 0) & (lens[:, None] > 0), kp, -1)
    mask = ((kp <= last.clamp_min(0)) & (kp >= 0))[:, None, :]
    want = L._attend(q, k, v, mask, None)
    wc = w // tp
    outs = L.drive_split([L.attend_split(
        q, k[:, c * wc:(c + 1) * wc], v[:, c * wc:(c + 1) * wc],
        mask[..., c * wc:(c + 1) * wc], None) for c in range(tp)])
    assert len(outs) == tp
    assert all(torch.equal(o, outs[0]) for o in outs)
    scale = float(want.abs().max())
    assert float((outs[0] - want).abs().max()) <= 1e-5 * scale
