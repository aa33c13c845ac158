"""Port parity: the abstract serving declarations (``repro_torch.launch.
qdeclare`` and ``launch.inputs``) against the reference's, and a rank's
view of a packed leaf (``distributed.sharding.local_view``, the
arithmetic of ``qlinear_local``) against the whole leaf.

Declarations: every assigned architecture plus llama-7b, at full size,
under the presets of stub (16, 16) and (2, 16, 16) meshes
(``make_preset`` of each package) for every applicable shape cell.
Meta tensors and ``ShapeDtypeStruct``s hold no memory, so this runs in
seconds.  The port keeps a stage's layers as a list; its per-layer
entries are held against the reference's stacked leaf: shape and spec
with the leading ``layers`` dim dropped (the reference's spec has None
there).

Views: a packed leaf built by the reference's quantizer and carried
across by the bridge, split over tp = 2, 3, 4 and 16 ranks, row- and
column-wise.  The byte rows of a row view are ``torch.chunk``'s chunks
(uneven at these shapes, asserted), so its per-channel vectors are cut
to match them, not to the spec's own chunks.  Exact: the views' bytes
and vectors put back together equal the reference's, and their
dequantized rows scattered by their perms equal the whole leaf's
``to_dense`` bit for bit.  Tolerance: the plain version's f32 partial
sums of the row views, summed in rank order, against the whole leaf's
f32 accumulator at 1e-5 relative (summation order only: both round the
same operands to bf16).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as PS  # noqa: E402

from repro.configs import registry as r_registry  # noqa: E402
from repro.configs.base import SHAPE_CELLS, cell_applicable  # noqa: E402
from repro.core.qlinear import QLinear as RQ  # noqa: E402
from repro.core.qlinear import QuantConfig as RQC  # noqa: E402
from repro.core.qlinear import quantize_linear as r_quantize  # noqa: E402
from repro.launch import inputs as RI  # noqa: E402
from repro.launch.presets import make_preset as r_preset  # noqa: E402
from repro.launch.qdeclare import declare_quantized as r_declare  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.param import is_leaf as r_is_p  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.configs.base import SHAPE_CELLS as T_CELLS  # noqa: E402
from repro_torch.core.qlinear import FIELDS, QLinear  # noqa: E402
from repro_torch.core.qlinear import QuantConfig as TQC  # noqa: E402
from repro_torch.distributed.sharding import (Spec, chunk_range,  # noqa: E402
                                              local_view)
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.mixed_matmul import mixed_matmul  # noqa: E402
from repro_torch.launch import inputs as TI  # noqa: E402
from repro_torch.launch.presets import make_preset as t_preset  # noqa: E402
from repro_torch.launch.qdeclare import declare_quantized as t_declare  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.common import Parallel  # noqa: E402

ARCHS = list(r_registry.ASSIGNED) + ["llama-7b"]
QCFGS = (RQC(), RQC(ratio=0.2, multiple=16))
TPS = (2, 3, 4, 16)
PARTIAL_RTOL = 1e-5


class _Devices:
    def __init__(self, n):
        self.size = n


class _Mesh:
    """A mesh-shaped stub (the presets read dim sizes only)."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = names
        self.devices = _Devices(int(np.prod(shape)))


MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _cells(arch):
    for rc, tc in zip(SHAPE_CELLS, T_CELLS):
        if cell_applicable(r_registry.get(arch), rc)[0]:
            yield rc, tc


class _Layers(list):
    """A stage leaf's per-layer entries, held as one leaf."""


class _Box:
    """A Spec held as one leaf while trees are walked."""

    def __init__(self, spec):
        self.spec = spec


def _norm(entries):
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _boxed(tree):
    if isinstance(tree, Spec):
        return _Box(tree)
    if isinstance(tree, QLinear):
        return dataclasses.replace(tree, **{f: _boxed(getattr(tree, f))
                                            for f in FIELDS})
    if isinstance(tree, dict):
        return {k: _boxed(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_boxed(v) for v in tree)
    return tree


def _stack(layers):
    """Per-layer entries of one stage position -> one node whose leaves
    are lists over the layers (the reference's stacked layout)."""
    first = layers[0]
    if isinstance(first, QLinear):
        assert all((q.k_s, q.k, q.n) == (first.k_s, first.k, first.n)
                   for q in layers)
        return dataclasses.replace(first, **{
            f: _Layers(getattr(q, f) for q in layers) for f in FIELDS})
    if isinstance(first, dict):
        return {k: _stack([x[k] for x in layers]) for k in first}
    return _Layers(layers)


def _ref_layout(tree):
    tree = dict(_boxed(tree))
    tree["stages"] = [tuple(_stack([layer[pos] for layer in st])
                            for pos in range(len(st[0])))
                      for st in tree["stages"]]
    if "enc" in tree:
        enc = dict(tree["enc"])
        enc["stages"] = [tuple(_stack([layer[pos] for layer in st])
                               for pos in range(len(st[0])))
                         for st in enc["stages"]]
        tree["enc"] = enc
    return tree


def _walk(node, path=""):
    """(keystr, leaf) in the reference's flatten order; a QLinear is
    listed (with its fields after it) so that its k_s, k, n compare."""
    if isinstance(node, QLinear):
        yield path, node
        for i, f in enumerate(FIELDS):
            yield from _walk(getattr(node, f), f"{path}[<flat index {i}>]")
    elif isinstance(node, dict):
        for k in sorted(node):
            yield from _walk(node[k], f"{path}[{k!r}]")
    elif isinstance(node, (list, tuple)) and not isinstance(node, _Layers):
        for i, v in enumerate(node):
            yield from _walk(v, f"{path}[{i}]")
    else:
        yield path, node


def _ref_walk(tree):
    out = []
    for p, x in jax.tree_util.tree_leaves_with_path(
            tree, is_leaf=lambda n: isinstance(n, (RQ, PS))):
        key = jax.tree_util.keystr(p)
        if isinstance(x, RQ):
            out.append((key, x))
            for i, f in enumerate(FIELDS):
                out.append((f"{key}[<flat index {i}>]", getattr(x, f)))
        else:
            out.append((key, x))
    return out


def _dtype(d) -> str:
    return str(d).split(".")[-1]


def _hold_leaf(where, t, r):
    """One port leaf (a meta tensor, a Spec box, a QLinear, or a list of
    them over a stage's layers) against the reference's."""
    if isinstance(t, _Layers):
        for x in t:
            if isinstance(x, _Box):
                assert tuple(r)[0] is None, where
                assert x.spec == _norm(tuple(r)[1:]), (where, x.spec, r)
            else:
                assert tuple(x.shape) == tuple(r.shape)[1:], where
                assert _dtype(x.dtype) == jnp.dtype(r.dtype).name, where
        assert len(t) == (r.shape[0] if not isinstance(r, PS) else len(t))
    elif isinstance(t, QLinear):
        assert isinstance(r, RQ), where
        assert (t.k_s, t.k, t.n) == (r.k_s, r.k, r.n), where
    elif isinstance(t, _Box):
        assert t.spec == _norm(tuple(r)), (where, t.spec, r)
    else:
        assert tuple(t.shape) == tuple(r.shape), where
        assert _dtype(t.dtype) == jnp.dtype(r.dtype).name, where


def _hold_tree(tag, port, ref_tree):
    tl, rl = list(_walk(port)), _ref_walk(ref_tree)
    assert [k for k, _ in tl] == [k for k, _ in rl], tag
    for (k, t), (_, r) in zip(tl, rl):
        _hold_leaf(f"{tag} {k}", t, r)
    return len(tl)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_declare_quantized_matches_reference(mesh):
    n = 0
    for arch in ARCHS:
        for rc, tc in _cells(arch):
            rp = r_preset(r_registry.get(arch), rc, _Mesh(*MESHES[mesh]))
            tp = t_preset(t_registry.get(arch), tc, _Mesh(*MESHES[mesh]))
            for qc in QCFGS:
                ra, rs = r_declare(r_registry.get(arch), rp.par, qc,
                                   rp.rules)
                ta, ts = t_declare(t_registry.get(arch), tp.par,
                                   TQC(ratio=qc.ratio, multiple=qc.multiple),
                                   tp.rules)
                tag = f"{arch} {rc.name} {qc.multiple}"
                n += _hold_tree(tag + " abstract", _ref_layout(ta), ra)
                _hold_tree(tag + " specs", _ref_layout(ts), rs)
                assert sum(isinstance(x, QLinear)
                           for _, x in _walk(_ref_layout(ta))) > 0, tag
    assert n > 1000


def _inputs_port(fn, arch, tc, tp):
    return fn(t_registry.get(arch), tc, tp.par, tp.rules)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_inputs_match_reference(mesh):
    kinds = set()
    for arch in ARCHS:
        for rc, tc in _cells(arch):
            rp = r_preset(r_registry.get(arch), rc, _Mesh(*MESHES[mesh]))
            tp = t_preset(t_registry.get(arch), tc, _Mesh(*MESHES[mesh]))
            for rfn, tfn in ((RI.train_inputs, TI.train_inputs),
                             (RI.prefill_inputs, TI.prefill_inputs),
                             (RI.decode_inputs, TI.decode_inputs)):
                ri, rs = rfn(r_registry.get(arch), rc, rp.par, rp.rules)
                ti, ts = tfn(t_registry.get(arch), tc, tp.par, tp.rules)
                tag = f"{arch} {rc.name} {tfn.__name__}"
                _hold_tree(tag, _boxed(ti), ri)
                _hold_tree(tag + " specs", _boxed(ts), rs)
                kinds.add(tfn.__name__)
    assert kinds == {"train_inputs", "prefill_inputs", "decode_inputs"}
    assert TI.ENC_FRAMES == RI.ENC_FRAMES


def _cache_specs(arch, cell_name, mesh):
    tc = next(c for c in T_CELLS if c.name == cell_name)
    tp = t_preset(t_registry.get(arch), tc, _Mesh(*MESHES[mesh]))
    (_, _, caches), (tspec, _, cspec) = TI.decode_inputs(
        t_registry.get(arch), tc, tp.par, tp.rules)
    return tp, caches, tspec, [s for _, s in _walk(_boxed(cspec))]


def test_ctx_fallback_and_debatched_caches():
    """Where the run-time KV heads do not divide tp 16 the window goes
    over "ctx" (phi4-mini 24 heads, llava 56, recurrentgemma 10: 1 KV
    head at every tp); long_500k's batch of 1 is not sharded, and its
    caches' batch dim (dim 1) is taken off the data dims."""
    for arch in ("phi4-mini-3.8b", "llava-next-34b", "recurrentgemma-2b"):
        for mesh in MESHES:
            _, _, _, specs = _cache_specs(arch, "decode_32k", mesh)
            ctx = [b.spec for b in specs if "model" == b.spec[2]]
            assert ctx, (arch, mesh)
    for arch in ("recurrentgemma-2b", "xlstm-1.3b"):
        for mesh in MESHES:
            tp, caches, tspec, specs = _cache_specs(arch, "long_500k", mesh)
            assert not tp.par.shard_batch and tspec == (None,)
            assert all(b.spec[1] is None for b in specs), arch
    tp, _, tspec, specs = _cache_specs("qwen3-4b", "decode_32k", "multipod")
    assert tspec == (("pod", "data"),)
    assert all(b.spec[1] == ("pod", "data") for b in specs)


def test_declared_caches_match_reference():
    """``model.declare_caches`` against the reference's ``init_caches``
    in axes and init, and ``init_caches``' tensors in shape and dtype,
    for every architecture at tp 1 and 16 (encoder-decoder with its
    cross K/V)."""
    for arch in ARCHS:
        for tp in (1, 16):
            enc = 24 if r_registry.get(arch).enc_dec else 0
            from repro.models.common import Parallel as RP
            r = RM.init_caches(r_registry.get(arch), RP(tp=tp), 2, 64,
                               enc_len=enc)
            t = TM.declare_caches(t_registry.get(arch), Parallel(tp=tp), 2,
                                  64, enc_len=enc)
            rl = jax.tree_util.tree_leaves_with_path(r, is_leaf=r_is_p)
            tl = list(_walk(t))
            assert [k for k, _ in tl] == [jax.tree_util.keystr(k)
                                          for k, _ in rl], arch
            for (k, tp_), (_, rp_) in zip(tl, rl):
                assert (tp_.shape, tp_.axes, tp_.init) == (
                    tuple(rp_.shape), tuple(rp_.axes), rp_.init), (arch, k)
                assert _dtype(tp_.dtype) == jnp.dtype(rp_.dtype).name
            if tp == 1:
                built = TM.init_caches(t_registry.get(arch), 2, 64,
                                       enc_len=enc)
                for (k, p), (_, x) in zip(tl, _walk(built)):
                    assert tuple(x.shape) == p.shape, (arch, k)
                    assert x.dtype == p.dtype, (arch, k)


# ---------------------------------------------------------------------------
# A rank's view of a packed leaf
# ---------------------------------------------------------------------------
LEAVES = {"ragged": (250, 24, RQC(ratio=0.2, multiple=2)),
          "wo": (4096, 32, RQC(ratio=0.2, multiple=16))}


def _leaf(name):
    k, n, qc = LEAVES[name]
    w = jax.random.normal(jax.random.PRNGKey(k), (k, n), jnp.float32)
    r = r_quantize(w, None, qc)
    return r, bridge.convert(jax.tree.map(np.asarray, r))


def _uneven(q, tp) -> bool:
    return bool((q.w4.shape[0] % tp) or (q.bits.shape[0] % tp))


def _rebuild(q, views):
    """The views' dequantized rows scattered by their perms into (K, N),
    every channel once."""
    dense = torch.full((q.k, q.n), float("nan"))
    seen = torch.zeros(q.k, dtype=torch.int64)
    for v in views:
        rows = torch.cat([v.dequant_salient(torch.float32),
                          v.dequant_binary(torch.float32)], dim=-2)
        dense[v.perm.long()] = rows
        seen[v.perm.long()] += 1
    assert torch.equal(seen, torch.ones_like(seen))
    return dense


@pytest.mark.parametrize("tp", TPS)
def test_qlinear_views_rebuild_the_leaf(tp):
    assert _uneven(_leaf("ragged")[1], tp)
    for name in LEAVES:
        r, q = _leaf(name)
        rows = [local_view(q, "row", i, tp) for i in range(tp)]
        cols = [local_view(q, "column", i, tp) for i in range(tp)]
        # bytes and vectors put back together are the reference's
        cat = lambda vs, f, d: torch.cat([getattr(v, f) for v in vs], d)
        for f in ("w4", "bits"):
            assert np.array_equal(cat(rows, f, 0).numpy(),
                                  np.asarray(getattr(r, f)))
            assert np.array_equal(cat(cols, f, 1).numpy(),
                                  np.asarray(getattr(r, f)))
        sal = torch.cat([v.perm[:v.k_s] for v in rows])
        binr = torch.cat([v.perm[v.k_s:] for v in rows])
        assert np.array_equal(torch.cat([sal, binr]).numpy(),
                              np.asarray(r.perm))
        for f in ("s4", "z4", "alpha_r2"):
            assert np.array_equal(cat(rows, f, 0).numpy(),
                                  np.asarray(getattr(r, f)))
        for f in ("alpha_s", "alpha_r1"):
            assert np.array_equal(cat(cols, f, 0).numpy(),
                                  np.asarray(getattr(r, f)))
        for i, v in enumerate(rows):
            a, e = chunk_range(q.w4.shape[0], tp, i)
            b, f = chunk_range(q.bits.shape[0], tp, i)
            assert (v.k_s, v.k, v.n) == (2 * (e - a),
                                         2 * (e - a) + 8 * (f - b), q.n)
        # unpacked, scattered by their perms: the whole leaf, bit for bit
        whole = q.to_dense(torch.float32)
        assert torch.equal(_rebuild(q, rows), whole)
        assert torch.equal(torch.cat([v.to_dense(torch.float32)
                                      for v in cols], 1), whole)


def test_row_partials_sum_to_the_leaf_and_the_f32_output():
    """The plain version's f32 partials of the row views (their perms
    gather from the whole x) sum, in rank order, to the whole leaf's
    f32 accumulator within 1e-5 relative; the wrapper's f32 output is
    that accumulator and its bf16 output the accumulator rounded once;
    a column view's product is its columns of the whole, within the same
    1e-5 (the CPU's matmul sums in an order of its own per width)."""
    gen = torch.Generator().manual_seed(0)
    for name in LEAVES:
        _, q = _leaf(name)
        for m in (1, 8):
            x = torch.randn((m, q.k), generator=gen).to(torch.bfloat16)
            args = lambda v: (v.w4, v.s4, v.z4, v.bits, v.alpha_s,
                              v.alpha_r1, v.alpha_r2)
            acc = ref.mixed_matmul_ref(x, *args(q), perm=q.perm)
            f32 = mixed_matmul(x, *args(q), perm=q.perm,
                               out_dtype=torch.float32)
            assert f32.dtype == torch.float32 and torch.equal(f32, acc)
            assert torch.equal(mixed_matmul(x, *args(q), perm=q.perm),
                               acc.to(torch.bfloat16))
            for tp in TPS:
                if name == "ragged":
                    assert _uneven(q, tp)
                total = torch.zeros_like(acc)
                for i in range(tp):
                    v = local_view(q, "row", i, tp)
                    total += mixed_matmul(x, *args(v), perm=v.perm,
                                          out_dtype=torch.float32)
                gap = float((total - acc).abs().max()
                            / acc.abs().max().clamp_min(1e-30))
                assert gap <= PARTIAL_RTOL, (name, m, tp, gap)
                cols = torch.cat([mixed_matmul(
                    x, *args(local_view(q, "column", i, tp)), perm=q.perm,
                    out_dtype=torch.float32) for i in range(tp)], 1)
                gap = float((cols - acc).abs().max()
                            / acc.abs().max().clamp_min(1e-30))
                assert gap <= PARTIAL_RTOL, (name, m, tp, gap)
