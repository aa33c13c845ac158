"""Port parity: the dry-run (``repro_torch.launch.dryrun`` and
``launch.step_analysis``, the twins of ``repro.launch.dryrun`` and
``repro.launch.hlo_analysis``) on a fake (4, 4) mesh against the
reference's dry-run of the same reduced cells on 16 host devices.

Both sides start at once, each in processes of its own: the
reference's (``tests/jax_mesh_ref.py dryrun``, two processes, each of
which imports ``repro.launch.dryrun`` first for its 512 host devices
and lowers, compiles and analyzes half of the reduced cells on a (4, 4)
mesh of its first 16) and the port's, this file run as a script (its
process group is the "fake" backend's, 16 ranks, one at a time; no
process group is ever started in the pytest worker): one process for
the FLOP cases and the CLI, and two each (half the architectures a
process) tracing every reduced architecture's live cells as rank 0 and
as rank 15.

Held:
(a) the per-device FLOPs of the port's trace (``FlopCounterMode`` plus
    the packed op's 2·M·K·N) equal the reference's trip-count-aware
    count of ``dot`` work for the same reduced cell, mesh and preset:
    reduced qwen2.5-3b's train (8 x 64, 2 microbatches, remat), prefill
    (8 x 64) and decode (8 rows, 128) to 1e-9 relative, and the prefill
    of every other kind to 1e-6.  seamless-m4t-medium's reference
    prefill projects each decoder layer's cross K/V twice (once for
    attention, once for the decode cache, ``repro.models.transformer``
    block_prefill; XLA keeps both), the port's once: the port's count
    plus that second projection equals the reference's.
(b) every reduced architecture's live cells of ``SHAPE_CELLS`` trace
    with status ok through ``run_cell`` and ``main`` (the registry's
    configs reduced and the production mesh (4, 4) in that process),
    with the reference's record keys less ``lower_s`` / ``compile_s``
    (one ``trace_s``) and ``xla_flops_raw`` / ``xla_bytes_raw``; at
    ranks 0 and 15 each rank's bytes of its placed state equal the
    sizes its specs give (``sharding.chunk_range``).
(c) ``step_analysis._derive_bytes`` and ``roofline_terms`` given the
    reference's constants equal ``repro.launch.hlo_analysis``'s for
    every kind and group sizes 1, 4 and 16.
(d) the collectives of reduced qwen2.5-3b's sequence-parallel prefill
    at tp 4 (bf16 weights, 62 positions: chunks of 16) include, per
    tensor-parallel sublayer, one all-gather and one reduce-scatter of
    (B_local, ceil(S / 4), D) chunks over "model" with their ring wire
    bytes (and the embedding's one reduce-scatter into the stream).
(e) the packed matmul's shape route: 2·M·K·N FLOPs, the packed
    operands' bytes, no build and no launch; real CPU tensors take the
    plain version, bit for bit, and never the registered op.
(f) the CLI: a ``skipped`` record for ``long_500k`` on a full-attention
    architecture; exit 1 and an ``error`` record with its traceback for
    a cell made to fail; ``fake_group`` refuses to start in a process
    that holds a process group.

Packed weights: data-free PTQ1.61 shapes of ratio 0.2, multiple 32 and
min_dim 32 (``jax_mesh_ref.DRYRUN_QUANT``; every packed byte row then
divides the mesh, which the reference's lowering needs).

    python tests/test_torch_dryrun.py     # prints each FLOP gap
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_mesh_ref as JR  # noqa: E402

MESH, AXES = (4, 4), ("data", "model")
RATIO, MULTIPLE, MIN_DIM = JR.DRYRUN_QUANT
# (name, arch, kind, batch, seq)
FLOP_CASES = (("qwen-train", "qwen2.5-3b", "train", 8, 64),
              ("qwen-prefill", "qwen2.5-3b", "prefill", 8, 64),
              ("qwen-decode", "qwen2.5-3b", "decode", 8, 128),
              ("granite", "granite-moe-1b-a400m", "prefill", 8, 64),
              ("rg", "recurrentgemma-2b", "prefill", 8, 64),
              ("xl", "xlstm-1.3b", "prefill", 8, 64),
              ("s2t", "seamless-m4t-medium", "prefill", 8, 64),
              ("vlm", "llava-next-34b", "prefill", 8, 64))
QWEN_RTOL, KIND_RTOL = 1e-9, 1e-6
SP_BATCH, SP_SEQ = 8, 62
# (b) runs SHAPE_CELLS at these sequence lengths (their batches and kinds
# kept): the xLSTM's sLSTM scans its sequence one step at a time
SHORT_SEQ = {"train_4k": 16, "prefill_32k": 32, "decode_32k": 64,
             "long_500k": 256}
RANKS = (0, 15)
PARTS = 2           # processes a rank's cells are split over
DEADLINE_S = 240
DROPPED = {"lower_s", "compile_s", "xla_flops_raw", "xla_bytes_raw"}
REF_KEYS = {"arch", "cell", "mesh", "status", "quantized_serving", "preset",
            "lower_s", "compile_s", "flops_per_device",
            "bytes_accessed_per_device", "top", "xla_flops_raw",
            "xla_bytes_raw", "transcendentals", "collectives", "memory",
            "roofline", "model_flops", "model_flops_per_device",
            "useful_flops_ratio", "devices"}


# ---------------------------------------------------------------------------
# The port's side, run as a script in processes of its own
# ---------------------------------------------------------------------------
def _shrink(cfg):
    """The reduced same-family config, vocabulary at most 512."""
    cfg = cfg.reduced()
    return dataclasses.replace(cfg, vocab=min(cfg.vocab, 512))


def _reduced(arch):
    from repro_torch.configs import registry
    return _shrink(registry.get(arch))


def _short_cells():
    from repro_torch.configs.base import SHAPE_CELLS
    return tuple(dataclasses.replace(c, seq_len=SHORT_SEQ[c.name])
                 for c in SHAPE_CELLS)


def _qcfg():
    from repro_torch.core.qlinear import QuantConfig
    return QuantConfig(ratio=RATIO, multiple=MULTIPLE)


def port_flops(out: Path) -> None:
    """(a), (d) and (f): the FLOP cases, the sp prefill's collectives,
    the CLI and the refusal, each a JSON under ``out``."""
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import fake_group
    for name, arch, kind, b, s in FLOP_CASES:
        rec = D.cell_record(_reduced(arch), ShapeCell(name, s, b, kind),
                            MESH, AXES, qcfg=_qcfg(), min_dim=MIN_DIM)
        (out / f"{name}.json").write_text(json.dumps(rec))
    rec = D.cell_record(_reduced("qwen2.5-3b"),
                        ShapeCell("sp", SP_SEQ, SP_BATCH, "prefill"), MESH,
                        AXES, quantized_serving=False, log=True)
    (out / "sp.json").write_text(json.dumps(rec))
    cli = {}
    cli["skip_rc"] = D.main(["--arch", "qwen3-4b", "--cell", "long_500k",
                             "--out", str(out / "cli")])
    plain = D.trace_cell

    def fail(*args, **kwargs):
        raise RuntimeError("a cell made to fail")
    kept = out / "cli" / "pod" / "qwen2.5-3b__prefill_32k.json"
    argv = ["--arch", "qwen2.5-3b", "--cell", "prefill_32k",
            "--out", str(out / "cli")]
    D.trace_cell = fail
    try:
        # an ok record of this code is reused; one of other code is not
        ok = {"status": "ok", "rank": 0, "quantized_serving": True,
              "roofline": {"dominant": "compute",
                           "step_time_lower_bound_s": 1.0,
                           "compute_fraction": 1.0},
              "memory": {"peak_bytes": 1}}
        kept.write_text(json.dumps({**ok, "code": D.code_hash()}))
        cli["reuse_rc"] = D.main(argv)
        kept.write_text(json.dumps({**ok, "code": "other code"}))
        cli["error_rc"] = D.main(argv)
    finally:
        D.trace_cell = plain
    cli["group_left"] = dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{out / 'rdv'}",
                            rank=0, world_size=1)
    try:
        fake_group(16)
        cli["refused"] = ""
    except RuntimeError as e:
        cli["refused"] = str(e)
    finally:
        dist.destroy_process_group()
    cli["code"] = D.code_hash()
    (out / "cli.json").write_text(json.dumps(cli))


def port_cells(out: Path, rank: int, part: int) -> None:
    """(b): every live cell of the assigned architectures of ``part``
    (every other one, from ``part``) through ``run_cell`` as ``rank``
    (``main --all`` for rank 0), the registry's configs reduced, the
    cells at ``SHORT_SEQ`` and the production mesh (4, 4) in this
    process."""
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun as D
    get = registry.get
    registry.get = lambda arch: _shrink(get(arch))
    registry.ASSIGNED = registry.ASSIGNED[part::PARTS]
    cells = _short_cells()
    D.SHAPE_CELLS = cells
    D.cell_by_name = lambda name: next(c for c in cells if c.name == name)
    D.production_shape = lambda multi_pod=False: (MESH, AXES)
    D.cell_record = functools.partial(D.cell_record, qcfg=_qcfg(),
                                      min_dim=MIN_DIM)
    if rank == 0:
        rc = D.main(["--all", "--out", str(out)])
        (out / f"main{part}.json").write_text(json.dumps({"rc": rc}))
        return
    for arch in registry.ASSIGNED:
        for cell in cells:
            D.run_cell(arch, cell.name, "pod", out_dir=str(out), rank=rank)


def _port_main(argv) -> int:
    torch.set_num_threads(1)
    out = Path(argv[1])
    out.mkdir(parents=True, exist_ok=True)
    if argv[0] == "flops":
        port_flops(out)
    else:
        port_cells(out, int(argv[2]), int(argv[3]))
    return 0


# ---------------------------------------------------------------------------
# The parent: both sides at once
# ---------------------------------------------------------------------------
def _spawn(args, log: Path):
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(root / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, __file__] + args, stdout=f,
                                stderr=subprocess.STDOUT, env=env)
    return proc, log


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _run_both(tmp_path_factory.mktemp("dryrun"))


def _run_both(tmp: Path) -> Path:
    """Both sides at once under ``tmp``: the reference's FLOP cases
    (``tmp/<name>.json``), the port's (``tmp/port``) and its cells at
    each of RANKS (``tmp/r<rank>``)."""
    cases = [(n, a, k, b, s) + MESH for n, a, k, b, s in FLOP_CASES]
    refs = [JR.start_dryrun(tmp, str(i), cases[i::2]) for i in range(2)]
    port = [_spawn(["flops", str(tmp / "port")], tmp / "port.log")]
    port += [_spawn(["cells", str(tmp / f"r{r}"), str(r), str(part)],
                    tmp / f"cells{r}.{part}.log")
             for r in RANKS for part in range(PARTS)]
    end = time.monotonic() + DEADLINE_S
    for handle in port + refs:
        JR.finish(handle, max(1.0, end - time.monotonic()))
    return tmp


def _load(path: Path):
    return json.loads(path.read_text())


def _gap(port: float, ref: float) -> float:
    return abs(port - ref) / abs(ref)


def _cross_kv_flops(cfg, rec) -> float:
    """The FLOPs of the cross K/V projection that the reference's
    prefill runs a second time: per decoder layer, wk and wv on this
    rank's columns of the encoder's whole output (rows x D x hkv·dh /
    tp), as the port runs them once."""
    tp, dp = rec["preset"]["tp"], rec["preset"]["dp"]
    rows = 8 // dp * 1024                 # launch.inputs.ENC_FRAMES
    layers = sum(s.repeats * len(s.pattern) for s in cfg.stages)
    n = cfg.n_kv_heads * cfg.head_dim_ // tp
    return layers * 2 * 2 * rows * cfg.d_model * n


def test_flops_qwen_equal_reference(runs):
    """(a) reduced qwen2.5-3b's train, prefill and decode."""
    for name in ("qwen-train", "qwen-prefill", "qwen-decode"):
        port, ref = (_load(runs / d / f"{name}.json") for d in ("port", ""))
        assert port["preset"] == ref["preset"], name
        assert _gap(port["flops_per_device"],
                    ref["flops_per_device"]) <= QWEN_RTOL, \
            (name, port["flops_per_device"], ref["flops_per_device"])


def test_flops_kinds_equal_reference(runs):
    """(a) the prefill of every other kind; seamless's second cross K/V
    projection added to the port's count."""
    for name, arch, *_ in FLOP_CASES[3:]:
        port, ref = (_load(runs / d / f"{name}.json") for d in ("port", ""))
        assert port["preset"] == ref["preset"], name
        flops = port["flops_per_device"]
        if name == "s2t":
            flops += _cross_kv_flops(_reduced(arch), port)
        assert _gap(flops, ref["flops_per_device"]) <= KIND_RTOL, \
            (name, flops, ref["flops_per_device"])


def _cell_records(root: Path, archs=None):
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPE_CELLS, cell_applicable
    out = {}
    for arch in archs or registry.ASSIGNED:
        for cell in SHAPE_CELLS:
            rec = _load(root / "pod" / f"{arch}__{cell.name}.json")
            live = cell_applicable(registry.get(arch), cell)[0]
            out[arch, cell.name] = (live, rec)
    return out


def test_every_cell_traces_with_reference_keys(runs):
    """(b) ``main --all`` at rank 0 and ``run_cell`` at rank 15: status
    ok for every live cell, skipped for the rest, the reference's keys."""
    from repro_torch.configs import registry
    from repro_torch.launch.dryrun import code_hash
    code = code_hash()
    for part in range(PARTS):
        assert _load(runs / "r0" / f"main{part}.json")["rc"] == 0
        recs = _cell_records(runs / "r0",
                             registry.ASSIGNED[part::PARTS])
        live = sum(1 for ok, _ in recs.values() if ok)
        assert f"ok={live} skipped={len(recs) - live} error=0" in \
            (runs / f"cells0.{part}.log").read_text()
    for rank in RANKS:
        recs = _cell_records(runs / f"r{rank}")
        for (arch, cell), (ok, rec) in recs.items():
            if not ok:
                assert rec["status"] == "skipped" and rec["reason"]
                continue
            assert rec["status"] == "ok", (arch, cell, rec.get("error"),
                                           rec.get("traceback"))
            assert rec["rank"] == rank and rec["code"] == code
            missing = (REF_KEYS - DROPPED) - set(rec)
            assert not missing and "trace_s" in rec, (arch, cell, missing)
            assert set(rec["memory"]) >= {"argument_bytes", "output_bytes",
                                          "temp_bytes", "alias_bytes",
                                          "peak_bytes"}
            assert set(rec["top"]) == {"by_flops", "by_bytes", "by_coll"}
            assert rec["flops_per_device"] > 0 and rec["devices"] == 16
            assert rec["memory"]["peak_bytes"] >= \
                rec["memory"]["argument_bytes"] > 0


def _stub_mesh():
    return types.SimpleNamespace(shape=dict(zip(AXES, MESH)),
                                 axis_names=AXES,
                                 devices=types.SimpleNamespace(size=16))


def _local_bytes(shape, dtype, spec, coords) -> int:
    """Bytes of the part at mesh ``coords`` of a leaf placed by
    ``spec``: mesh dims in order, each cutting its tensor dim into
    ``chunk_range`` parts."""
    from repro_torch.distributed.sharding import chunk_range
    dims = list(shape)
    for axis, size in zip(AXES, MESH):
        for i, entry in enumerate(spec):
            names = (entry,) if isinstance(entry, str) else tuple(entry or ())
            if axis in names:
                lo, hi = chunk_range(dims[i], size, coords[axis])
                dims[i] = hi - lo
    n = 1
    for d in dims:
        n *= d
    return n * torch.empty((), dtype=dtype).element_size()


def _expected_state_bytes(arch, cell_name, rank) -> int:
    from repro_torch.core.qlinear import QLinear
    from repro_torch.core.select import map_tree
    from repro_torch.distributed.sharding import at, specs_for_tree
    from repro_torch.launch import inputs, presets, qdeclare
    from repro_torch.models import model as M
    cfg = _reduced(arch)
    cell = next(c for c in _short_cells() if c.name == cell_name)
    preset = presets.make_preset(cfg, cell, _stub_mesh())
    par, rules = preset.par, preset.rules
    coords = dict(zip(AXES, divmod(rank, MESH[1])))
    total = []
    if cell.kind == "train":
        decl = M.declare_params(cfg, par)
        specs = specs_for_tree(decl, rules)
        map_tree(decl, lambda path, p: total.append(
            _local_bytes(p.shape, p.dtype, at(specs, path), coords)
            + 2 * _local_bytes(p.shape, torch.float32, at(specs, path),
                               coords)))
        return sum(total) + 8           # AdamW's step, the residual
    abstract, specs = qdeclare.declare_quantized(cfg, par, _qcfg(), rules,
                                                 min_dim=MIN_DIM)

    def leaf(path, t):
        spec = at(specs, path)
        if isinstance(t, QLinear):
            for f, v in vars(t).items():
                if isinstance(v, torch.Tensor):
                    total.append(_local_bytes(v.shape, v.dtype,
                                              getattr(spec, f), coords))
        else:
            total.append(_local_bytes(t.shape, t.dtype, spec, coords))
    map_tree(abstract, leaf)
    if cell.kind == "decode":
        (_, _, caches), (_, _, cspec) = inputs.decode_inputs(cfg, cell, par,
                                                             rules)
        map_tree(caches, lambda path, t: total.append(
            _local_bytes(t.shape, t.dtype, at(cspec, path), coords)))
    return sum(total)


def test_state_bytes_follow_specs(runs):
    """(b) ranks 0 and 15: the placed state's bytes each rank holds."""
    for rank in RANKS:
        for (arch, cell), (ok, rec) in _cell_records(
                runs / f"r{rank}").items():
            if ok:
                assert rec["local_state_bytes"] == _expected_state_bytes(
                    arch, cell, rank), (rank, arch, cell)


def test_derive_bytes_and_roofline_equal_reference():
    """(c) the ring arithmetic and the roofline, given the reference's
    constants, equal ``repro.launch.hlo_analysis``'s."""
    from repro.launch import hlo_analysis as H
    from repro_torch.launch import step_analysis as S
    for kind in H.COLLECTIVE_KINDS + ("broadcast",):
        for g in (1, 4, 16):
            for rb in (0, 4096, 12345 * 16, 3 * 2 ** 30):
                assert S._derive_bytes(kind, rb, g) == \
                    H._derive_bytes(kind, rb, g), (kind, g, rb)
    assert S.COLLECTIVE_KINDS == H.COLLECTIVE_KINDS
    for f, b, c in ((1e15, 2e12, 3e9), (1e9, 4e12, 0.0), (5e12, 1e9, 7e11),
                    (0.0, 0.0, 0.0)):
        assert S.roofline_terms(f, b, c, peak=H.PEAK_FLOPS, hbm=H.HBM_BW,
                                ici=H.ICI_BW) == H.roofline_terms(f, b, c)
    h100 = S.roofline_terms(989e12, 3.35e12, 50e9)
    assert h100["compute_s"] == h100["memory_s"] == \
        h100["collective_s"] == 1.0


def test_sp_prefill_collectives_equal_arithmetic(runs):
    """(d) one all-gather and one reduce-scatter of (B_local, ceil(S /
    4), D) chunks over "model" per tensor-parallel sublayer."""
    from repro.launch import hlo_analysis as H
    rec = _load(runs / "port" / "sp.json")
    cfg = _reduced("qwen2.5-3b")
    tp, dp = rec["preset"]["tp"], rec["preset"]["dp"]
    b, c, d = SP_BATCH // dp, -(-SP_SEQ // tp), cfg.d_model
    sublayers = 2 * sum(s.repeats * len(s.pattern) for s in cfg.stages)
    chunk = b * c * d * 2                        # bf16
    log = [x for x in rec["collective_log"]
           if x["axis"] == "model" and x["group_size"] == tp]
    gathers = [x for x in log if x["kind"] == "all-gather"
               and x["result_bytes"] == tp * chunk]
    scatters = [x for x in log if x["kind"] == "reduce-scatter"
                and x["result_bytes"] == chunk]
    assert len(gathers) == sublayers, [x for x in log]
    # and one more reduce-scatter: the vocab-parallel embedding's sum
    # leaves into the stream
    assert len(scatters) == sublayers + 1, [x for x in log]
    for x in gathers + scatters:
        assert (x["operand_bytes"], x["wire_bytes"]) == H._derive_bytes(
            x["kind"], x["result_bytes"], tp)
    assert gathers[0]["wire_bytes"] == (tp - 1) * chunk
    assert scatters[0]["wire_bytes"] == (tp - 1) * chunk
    summary = rec["collectives"]
    assert summary["n_collectives"] == len(rec["collective_log"])
    assert summary["wire_bytes"] == sum(x["wire_bytes"]
                                        for x in rec["collective_log"])


def _packed(gen, k, n, k_s):
    from repro_torch.core.qlinear import QLinear
    k_b = k - k_s
    return QLinear(
        perm=torch.randperm(k, generator=gen).to(torch.int32),
        w4=torch.randint(0, 256, (k_s // 2, n), generator=gen,
                         dtype=torch.uint8),
        s4=torch.rand(k_s, generator=gen) + 0.5,
        z4=torch.rand(k_s, generator=gen) * 15,
        bits=torch.randint(0, 256, (k_b // 8, n), generator=gen,
                           dtype=torch.uint8),
        alpha_s=torch.rand(n, generator=gen) + 0.5,
        alpha_r1=torch.rand(n, generator=gen) + 0.5,
        alpha_r2=torch.rand(k_b, generator=gen) + 0.5,
        k_s=k_s, k=k, n=n)


def test_packed_shape_route(monkeypatch):
    """(e) tensors without data: the registered op, 2·M·K·N, the packed
    bytes; nothing built or launched."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import build, mixed_matmul as MM, ops
    from repro_torch.launch.dryrun import _fake
    from repro_torch.launch.step_analysis import StepAnalysis

    def refuse(*a, **k):
        raise AssertionError("the shape route built or launched a kernel")
    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build.CudaKernel, "launch", refuse)
    monkeypatch.setattr(MM, "launch_packed", refuse)
    m, k, n, k_s = 12, 256, 96, 64
    q = _packed(torch.Generator().manual_seed(0), k, n, k_s)
    fields = [q.perm, q.w4, q.s4, q.z4, q.bits, q.alpha_s, q.alpha_r1,
              q.alpha_r2]
    launches = dict(MM.KERNEL.shapes)
    with FakeTensorMode():
        for device in ("cpu", "meta"):
            fq = _fake(q, device)
            x = torch.empty((3, 4, k), dtype=torch.float32, device=device)
            with StepAnalysis() as sa:
                y = ops.mixed_matmul(x, fq, out_dtype=torch.float32)
            assert y.shape == (3, 4, n) and y.dtype == torch.float32
            assert sa.flops() == 2 * m * k * n
            row = sa.counter.ops["repro_torch.packed_matmul"]
            assert row["count"] == 1
            assert row["bytes"] == (m * k * 2 + sum(f.nbytes for f in fields)
                                    + m * n * 4)
            assert sa.op_flops() == {"repro_torch.packed_matmul":
                                     2 * m * k * n}
    assert dict(MM.KERNEL.shapes) == launches


def test_real_tensors_take_the_plain_route():
    """(e) on real CPU tensors ``ops.mixed_matmul`` is the plain version
    bit for bit, and the registered op is never dispatched."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(1)
    q = _packed(gen, 256, 96, 64)
    x = torch.randn((5, 256), generator=gen).to(torch.bfloat16)
    names = []

    class Names(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            names.append(str(func))
            return func(*args, **(kwargs or {}))
    with Names():
        y = ops.mixed_matmul(x, q)
    want = ref.mixed_matmul_ref(x, q.w4, q.s4, q.z4, q.bits, q.alpha_s,
                                q.alpha_r1, q.alpha_r2, q.perm).to(
        torch.bfloat16)
    assert torch.equal(y.view(torch.int16), want.view(torch.int16))
    assert names and not any("packed_matmul" in s for s in names)


def test_cli_skip_error_and_refusal(runs):
    """(f) the skipped record, the error record and exit 1, the group
    ended after the failure, ``fake_group``'s refusal, and an ok record
    reused only where its ``code`` is this code's."""
    cli = _load(runs / "port" / "cli.json")
    assert cli["skip_rc"] == 0 and cli["reuse_rc"] == 0
    assert cli["error_rc"] == 1
    assert cli["group_left"] is False
    assert "already holds a gloo group" in cli["refused"]
    skip = _load(runs / "port" / "cli" / "pod" / "qwen3-4b__long_500k.json")
    assert skip["status"] == "skipped"
    assert "full-attention" in skip["reason"]
    err = _load(runs / "port" / "cli" / "pod" / "qwen2.5-3b__prefill_32k.json")
    assert err["status"] == "error"
    assert "a cell made to fail" in err["error"]
    assert "Traceback" in err["traceback"]


if __name__ == "__main__":
    if sys.argv[1:2] in (["flops"], ["cells"]):
        sys.exit(_port_main(sys.argv[1:]))
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        root = _run_both(Path(d))
        for name, arch, *_ in FLOP_CASES:
            port, refr = (_load(root / x / f"{name}.json")
                          for x in ("port", ""))
            gap = _gap(port["flops_per_device"], refr["flops_per_device"])
            print(f"{name:14s} port {port['flops_per_device']:.6e} "
                  f"reference {refr['flops_per_device']:.6e} gap {gap:.3e}")
