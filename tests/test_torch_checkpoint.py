"""Port parity: the checkpoint store (``repro_torch.checkpoint``) against
``repro.checkpoint.store``.

Everything here is exact: bytes compare exactly.  A checkpoint either
package writes restores bit for bit in the other; for the same tree the
two write the same files byte for byte (``leaf_<i>.npy`` in the same
leaf order, the manifest's msgpack bytes), and the port's msgpack codec
gives ``msgpack.packb``'s bytes and reads them back.
"""
import dataclasses
import os
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
msgpack = pytest.importorskip("msgpack")
hypothesis = pytest.importorskip("hypothesis")
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.checkpoint import store as rstore  # noqa: E402
from repro.configs import registry as r_registry  # noqa: E402
from repro.configs.base import Stage as RStage  # noqa: E402
from repro.core import qlinear as rql  # noqa: E402
from repro.distributed.compression import CompressionConfig as RCC  # noqa: E402
from repro.launch import train as rtrain  # noqa: E402
from repro.models.common import Parallel  # noqa: E402
from repro.optim.adamw import AdamW as RAdamW  # noqa: E402
from repro_torch import bridge, pytree  # noqa: E402
from repro_torch.checkpoint import codec  # noqa: E402
from repro_torch.checkpoint import store as tstore  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402


class Pair(NamedTuple):
    a: object
    b: object


def _bits(x) -> np.ndarray:
    """A tensor's or array's raw bits (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16).numpy().view(np.uint16)
                if x.dtype == torch.bfloat16 else x.numpy())
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _tree(seed: int):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(4, 4, generator=g).to(torch.bfloat16),
            "stages": [(torch.arange(6, dtype=torch.int32).reshape(2, 3),
                        torch.randn(5, generator=g))],
            "opt": Pair(torch.tensor(7, dtype=torch.int32),
                        torch.tensor(2.5, dtype=torch.bfloat16)),
            "none": None}


def test_roundtrip_keeps_dtypes_and_bits(tmp_path):
    tree = _tree(0)
    tstore.save_checkpoint(str(tmp_path), 10, tree)
    assert tstore.latest_step(str(tmp_path)) == 10
    restored, step = tstore.restore_checkpoint(str(tmp_path), _tree(1))
    assert step == 10 and restored["none"] is None
    assert isinstance(restored["opt"], Pair)
    assert isinstance(restored["stages"][0], tuple)
    for a, b in zip(pytree.leaves(restored), pytree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_stale_tmp_never_shadows_a_published_step(tmp_path):
    tree = {"x": torch.ones(2)}
    tstore.save_checkpoint(str(tmp_path), 1, tree)
    os.makedirs(os.path.join(str(tmp_path), "step_00000002.tmp"))
    assert tstore.latest_step(str(tmp_path)) == 1
    _, step = tstore.restore_checkpoint(str(tmp_path), tree)
    assert step == 1


def test_wrong_shape_and_missing_leaf_raise(tmp_path):
    tstore.save_checkpoint(str(tmp_path), 5, {"w": torch.zeros(8, 8)})
    meta = {"w": torch.empty(8, 8, device="meta")}
    restored, _ = tstore.restore_checkpoint(str(tmp_path), meta)
    assert restored["w"].device.type == "cpu"
    with pytest.raises(ValueError, match="shape mismatch"):
        tstore.restore_checkpoint(str(tmp_path), {"w": torch.zeros(4, 4)})
    with pytest.raises(KeyError, match=r"\['v'\]"):
        tstore.restore_checkpoint(str(tmp_path), {"v": torch.zeros(8, 8)})


@pytest.fixture(scope="module")
def ref_qlinears():
    rng = np.random.default_rng(1)
    w = jnp.asarray(rng.normal(size=(128, 32)) * 0.02, jnp.float32)
    cfg = rql.QuantConfig(ratio=0.25, multiple=16)
    q = rql.quantize_linear(w, None, cfg)
    grp = rql.quantize_linear_group([w, w[:, :16]], None, cfg)
    return {"lin": q, "grp": grp}


def test_qlinear_roundtrip_and_keystr(tmp_path, ref_qlinears):
    """A QLinear and a QLinearGroup are stored field by field under the
    keys their pytree registration gives in JAX."""
    ref = ref_qlinears
    port = bridge.convert(jax.tree.map(np.asarray, ref))
    assert [k for k, _ in pytree.leaves_with_path(port)] == [
        jax.tree_util.keystr(p)
        for p, _ in jax.tree_util.tree_leaves_with_path(ref)]
    tstore.save_checkpoint(str(tmp_path), 3, port)
    restored, _ = tstore.restore_checkpoint(str(tmp_path), port)
    assert isinstance(restored["lin"], tql.QLinear)
    assert restored["grp"].splits == port["grp"].splits
    torch.testing.assert_close(restored["lin"].to_dense(torch.float32),
                               port["lin"].to_dense(torch.float32),
                               rtol=0, atol=0)
    for a, b in zip(pytree.leaves(restored), pytree.leaves(port)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.fixture(scope="module")
def ref_state(ref_qlinears):
    """A reference train state with a 2-layer stage (bf16 params, f32
    moments, int32 step, f32 residual), stepped once so no leaf is all
    zeros, plus quantized leaves."""
    cfg = dataclasses.replace(r_registry.get("tiny-lm").reduced(),
                              stages=(RStage(("dense",), 2),))
    par = Parallel(remat=False, sp=False)
    opt = RAdamW(lr=1e-2, clip_norm=1.0)
    state = rtrain.init_state(cfg, par, opt, RCC(kind="int8"))
    step = jax.jit(rtrain.make_train_step(cfg, par, opt, RCC(kind="int8")))
    tok = jnp.asarray(np.random.default_rng(2).integers(0, 512, (2, 16)),
                      jnp.int32)
    state, _ = step(state, {"tokens": tok, "targets": tok})
    return dict(state, quant=ref_qlinears)


def _port_state(ref):
    np_ref = jax.tree.map(np.asarray, ref)
    out = ttrain.state_from_repro(np_ref, "cpu")
    out["quant"] = bridge.convert(np_ref["quant"])
    return out


def _to_repro(port):
    return dict(ttrain.state_to_repro(port), quant=port["quant"])


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def test_repro_writes_port_restores_bit_identical(tmp_path, ref_state):
    ref = ref_state
    rstore.save_checkpoint(str(tmp_path), 4, ref)
    template = _to_repro(_port_state(ref))
    restored, step = tstore.restore_checkpoint(str(tmp_path), template)
    assert step == 4
    assert isinstance(restored["opt"], type(template["opt"]))
    for a, b in zip(pytree.leaves(restored), jax.tree.leaves(ref)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert restored["params"]["embed"].dtype == torch.bfloat16
    assert restored["opt"].step.dtype == torch.int32
    assert restored["opt"].step.ndim == 0


def test_port_writes_repro_restores_bit_identical_same_files(tmp_path,
                                                            ref_state):
    """The port's checkpoint of the converted state restores in the
    reference, and its files are the reference's byte for byte."""
    ref = ref_state
    tstore.save_checkpoint(str(tmp_path / "t"), 4, _to_repro(_port_state(ref)))
    rstore.save_checkpoint(str(tmp_path / "r"), 4, ref)
    restored, step = rstore.restore_checkpoint(str(tmp_path / "t"), ref)
    assert step == 4
    for (key, a), b in zip(jax.tree_util.tree_leaves_with_path(restored),
                           jax.tree.leaves(ref)):
        assert a.dtype == b.dtype, jax.tree_util.keystr(key)
        np.testing.assert_array_equal(_bits(a), _bits(b))
    t_files = _files(tmp_path / "t" / "step_00000004")
    r_files = _files(tmp_path / "r" / "step_00000004")
    assert sorted(t_files) == sorted(r_files)
    assert t_files == r_files
    assert open(tmp_path / "t" / "LATEST").read() == "4"


def test_manifest_bytes_equal_msgpack_packb(tmp_path, ref_state):
    ref = ref_state
    tstore.save_checkpoint(str(tmp_path), 12, _to_repro(_port_state(ref)),
                           extra={"note": "x", "lr": 0.5, "ok": True})
    raw = open(tmp_path / "step_00000012" / "manifest.msgpack", "rb").read()
    manifest = msgpack.unpackb(raw)
    assert msgpack.packb(manifest) == raw == codec.packb(manifest)
    assert codec.unpackb(raw) == manifest
    assert manifest["leaves"][0]["path"] == "['opt'].step"
    assert len(manifest["leaves"]) == len(jax.tree.leaves(ref))


_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-(1 << 63), max_value=(1 << 64) - 1)
            | st.floats(allow_nan=False) | st.text(max_size=300)
            | st.binary(max_size=300))
_leaf_entry = st.fixed_dictionaries({
    "path": st.text(max_size=80),
    "file": st.text(max_size=20),
    "shape": st.lists(st.integers(min_value=0, max_value=1 << 40),
                      max_size=5),
    "dtype": st.sampled_from(["bfloat16", "float32", "int32", "uint8",
                              "float8_e4m3fn"])})
_manifests = st.fixed_dictionaries({
    "step": st.integers(min_value=0, max_value=1 << 40),
    "extra": st.dictionaries(st.text(max_size=40),
                             st.recursive(_scalars,
                                          lambda c: st.lists(c, max_size=20)
                                          | st.dictionaries(st.text(), c,
                                                            max_size=20),
                                          max_leaves=40),
                             max_size=20),
    "leaves": st.lists(_leaf_entry, max_size=40)})


@settings(max_examples=150, deadline=None)
@given(_manifests)
def test_codec_matches_msgpack_on_drawn_manifests(manifest):
    raw = msgpack.packb(manifest)
    assert codec.packb(manifest) == raw
    assert codec.unpackb(raw) == msgpack.unpackb(raw)
