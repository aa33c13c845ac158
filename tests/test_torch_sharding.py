"""Port parity: the logical axes, sharding rules, specs, KV-head
replication and presets of the port against ``repro``'s, with no
process group (pure functions of configs and mesh shapes).

The port keeps a stage's layers as a list, so its per-layer leaf is
compared with the reference's stacked leaf through ``bridge.
params_to_repro``, stacking P declarations: shape ``(L,) + shape`` and
axes ``("layers",) + axes``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as r_registry  # noqa: E402
from repro.configs.base import SHAPE_CELLS, cell_applicable  # noqa: E402
from repro.distributed import sharding as RS  # noqa: E402
from repro.launch.presets import make_preset as r_make_preset  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.common import Parallel as RParallel  # noqa: E402
from repro.models.param import is_leaf as r_is_p  # noqa: E402
from repro_torch import bridge, pytree  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.configs.base import SHAPE_CELLS as T_CELLS  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.launch.presets import make_preset as t_make_preset  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.param import P  # noqa: E402

ARCHS = sorted(r_registry._REGISTRY)
PARS = {"one": {}, "tp16_dp16": {"tp": 16, "dp": 16}}
RULES = {"default": {}, "fsdp": {"fsdp": True}, "ep": {"ep": True},
         "ep_fsdp": {"ep": True, "fsdp": True},
         "multipod_fsdp": {"dp_axes": ("pod", "data"), "fsdp": True}}


def _stack(ps):
    p = ps[0]
    return P((len(ps),) + p.shape, ("layers",) + p.axes, p.init, p.dtype)


def _port_leaves(cfg, par):
    tree = bridge.params_to_repro(TM.declare_params(cfg, par), _stack)
    return pytree.leaves_with_path(tree)


def _ref_leaves(cfg, par):
    return jax.tree_util.tree_leaves_with_path(RM.declare_params(cfg, par),
                                               is_leaf=r_is_p)


def _axes_in_use():
    """Every axes tuple the reference declares, stacked, over every
    arch, plus cache axes with "batch" and "ctx"."""
    out = {("batch", None), ("batch", "embed"), ("layers", "batch", None),
           ("layers", "batch", "ctx", "kv_heads", None)}
    for a in ARCHS:
        for _, p in _ref_leaves(r_registry.get(a), RParallel()):
            out.add(tuple(p.axes))
    return sorted(out, key=str)


@pytest.mark.parametrize("par", list(PARS))
def test_declared_leaves_match_reference(par):
    for arch in ARCHS:
        rl = _ref_leaves(r_registry.get(arch), RParallel(**PARS[par]))
        tl = _port_leaves(t_registry.get(arch), common.Parallel(**PARS[par]))
        assert len(tl) == len(rl), arch
        for (tk, t), (rk, r) in zip(tl, rl):
            assert tk == jax.tree_util.keystr(rk), (arch, tk)
            assert t.shape == tuple(r.shape), (arch, tk)
            assert t.axes == tuple(r.axes), (arch, tk)
            assert t.init == r.init, (arch, tk)
            assert str(t.dtype).split(".")[-1] == jnp.dtype(r.dtype).name
        assert TM.n_params(t_registry.get(arch)) == \
            RM.n_params(r_registry.get(arch)), arch


@pytest.mark.parametrize("rules", list(RULES))
def test_rules_spec_matches_reference(rules):
    r, t = RS.Rules(**RULES[rules]), TS.Rules(**RULES[rules])
    for axes in _axes_in_use():
        assert tuple(t.spec(axes)) == tuple(r.spec(axes)), axes


def test_reference_rule_cases():
    """``tests/test_distributed.py``'s own cases (a tuple of one mesh
    dim is that dim, as in ``PartitionSpec``)."""
    r = TS.Rules()
    assert r.spec(("embed", "heads")) == (None, "model")
    assert r.spec(("batch", None, None)) == ("data", None, None)
    assert r.spec(("layers", "embed", "ffn")) == (None, None, "model")
    assert TS.Rules(ep=True).spec(("experts", "embed", "ffn")) == \
        ("model", None, None)
    assert TS.Rules(ep=False).spec(("experts", "embed", "ffn")) == \
        (None, None, "model")
    # EP with FSDP: the experts over "model", the embed dim over data
    assert TS.Rules(ep=True, fsdp=True).spec(
        ("experts", "embed", "ffn")) == ("model", "data", None)
    assert TS.Rules(ep=True, fsdp=True).spec(
        ("experts", "ffn", "embed")) == ("model", None, "data")
    r = TS.Rules(dp_axes=("pod", "data"), fsdp=True)
    assert r.spec(("embed", "heads")) == (("pod", "data"), "model")
    assert r.spec(("batch", None)) == (("pod", "data"), None)
    assert r.spec(("batch", "embed")) == (("pod", "data"), None)


def test_qlinear_specs_match_reference():
    for rules in RULES.values():
        for axes in (("embed", "heads"), ("heads", "embed"),
                     ("layers", "embed", "ffn"),
                     ("layers", "experts", "embed", "ffn")):
            r = RS.qlinear_specs(axes, 128, 1024, 256, RS.Rules(**rules))
            t = TS.qlinear_specs(axes, 128, 1024, 256, TS.Rules(**rules))
            for f in r._FIELDS:
                assert tuple(getattr(t, f)) == tuple(getattr(r, f)), (axes, f)
            assert (t.k_s, t.k, t.n) == (r.k_s, r.k, r.n)


def test_kv_heads_run_matches_reference():
    for arch in ARCHS:
        cfg = r_registry.get(arch)
        for tp in range(1, 17):
            for n_q in (cfg.n_heads, None):
                assert common.Parallel(tp=tp).kv_heads_run(
                    cfg.n_kv_heads, n_q) == RParallel(tp=tp).kv_heads_run(
                        cfg.n_kv_heads, n_q), (arch, tp, n_q)


class _StubDevices:
    size = 256


class _StubMesh:
    """The mesh-shaped stub of ``tests/test_launch_specs.py``."""
    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")
    devices = _StubDevices()


def test_presets_match_reference():
    fields = [f.name for f in dataclasses.fields(RParallel)]
    assert fields == [f.name for f in dataclasses.fields(common.Parallel)]
    assert dataclasses.asdict(common.Parallel()) == \
        dataclasses.asdict(RParallel())
    assert [c.name for c in T_CELLS] == [c.name for c in SHAPE_CELLS]
    n = 0
    for arch in r_registry.ASSIGNED:
        for rc, tc in zip(SHAPE_CELLS, T_CELLS):
            if not cell_applicable(r_registry.get(arch), rc)[0]:
                continue
            r = r_make_preset(r_registry.get(arch), rc, _StubMesh())
            t = t_make_preset(t_registry.get(arch), tc, _StubMesh())
            assert dataclasses.asdict(t.par) == dataclasses.asdict(r.par)
            assert dataclasses.asdict(t.rules) == dataclasses.asdict(r.rules)
            assert t.quantized_serving == r.quantized_serving
            n += 1
    assert n >= 30


class _NamedMesh:
    mesh_dim_names = ("pod", "data", "model")


def test_placements_follow_the_spec():
    """One placement per mesh dim: Shard(i) where tensor dim i lies over
    it (both mesh dims of a ("pod", "data") dim), else Replicate."""
    S, R = TS.Shard, TS.Replicate
    m = _NamedMesh()
    assert TS.placements(TS.Spec((("pod", "data"), "model")), m) == \
        (S(0), S(0), S(1))
    assert TS.placements(TS.Spec((None, "model")), m) == (R(), R(), S(1))
    assert TS.placements(TS.Spec((None,)), m) == (R(), R(), R())
    assert TS.placements(("model", ("data",)), m) == (R(), S(1), S(0))
    rules = TS.rules_for_mesh(m, fsdp=True)
    assert rules.dp_axes == ("pod", "data")
    spec = TS.specs_for_tree(TM.declare_params(
        t_registry.get("qwen2.5-3b").reduced()), rules)
    assert TS.placements(spec["embed"], m) == (S(1), S(1), S(0))


def test_helpers_off_mesh_return_their_input():
    x = torch.ones(2, 3, 4)
    assert common.current_mesh() is None and not common.in_mesh()
    assert common.hint(x, "data", None, None) is x
    assert common.hint_act(x, common.Parallel()) is x
    assert common.batch_spec(None) == ("data", None)
    with common.use_mesh(_NamedMesh()):
        assert common.batch_spec() == (("pod", "data"),)
    assert common.current_mesh() is None
