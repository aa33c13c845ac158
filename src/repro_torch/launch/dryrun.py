"""Multi-pod dry-run of the port (twin of ``repro.launch.dryrun``).

For every (architecture × shape cell) and mesh, rank 0 of the
production mesh runs the cell's step at full width and depth on tensors
that hold no data (``FakeTensorMode``), over a process group of the
"fake" backend (``launch.mesh.fake_group``: 256 ranks for ``pod``, 512
for ``multipod``, every collective returning at once), inside
``launch.step_analysis.StepAnalysis``; one JSON per cell goes under
``results/dryrun_torch/<mesh>/<arch>__<cell>[__tag].json``.  It needs
no card and allocates no tensor memory.

Step kinds per cell (``configs.base.SHAPE_CELLS``):
    train_4k     -> ``launch.train.make_train_step`` under ``make_shards``
                    (fwd + remat + bwd + AdamW, the microbatches summed),
                    on the state placed by ``distribute_tree``
    prefill_32k  -> ``declare_quantized`` -> ``model.shard_for_serving``
                    -> ``model.prefill``, packed PTQ1.61 weights
    decode_32k   -> the same params, the caches of
                    ``launch.inputs.decode_inputs`` placed by their
                    specs -> ``model.decode_step``
    long_500k    -> decode at 500k context (sub-quadratic archs only)

``--serve-fp`` serves the bf16 declaration instead.

Rank 0 holds the ceil chunk of every uneven split
(``distributed.sharding.chunk_range``: heads, the sequence-parallel
stream, packed byte rows), so its numbers are the per-device maxima.
:func:`run_cell` takes another ``rank`` for the tests; the CLI records
rank 0.  The step runs on fake tensors of the card's device type,
"cuda", where this PyTorch is built with CUDA (no card is needed); a
CPU-only build cannot hold a fake CUDA tensor through every method
(``copy_``, ``contiguous`` and indexed assignment open a CUDA device
guard in the Python binding), and there the step runs on fake "cpu"
tensors: the port's model code takes the same ops on either device
(only the kernel wrappers look at it, and a tensor without data takes
the packed op's shape route on both).  The record names the device.

The records keep the reference's keys and meanings where the quantity
exists (``launch.step_analysis`` says how each is counted).  Two
differences: the reference's ``lower_s`` and ``compile_s`` are one
``trace_s`` here (eager PyTorch has no compile), and its
``xla_flops_raw`` / ``xla_bytes_raw`` (XLA's own cost analysis, which
counts a scan body once) have no counterpart and are left out.

Usage:
    python -m repro_torch.launch.dryrun --all                 # every cell, 16x16
    python -m repro_torch.launch.dryrun --all --mesh multipod # 2x16x16
    python -m repro_torch.launch.dryrun --arch qwen3-4b --cell decode_32k
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Sequence, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import registry
from repro_torch.configs.base import (ArchConfig, SHAPE_CELLS, ShapeCell,
                                      cell_applicable, cell_by_name)
from repro_torch.core.qlinear import QLinear, QuantConfig
from repro_torch.core.select import map_tree
from repro_torch.distributed.compression import CompressionConfig
from repro_torch.distributed.sharding import (distribute_tree, local,
                                              specs_for_tree)
from repro_torch.launch.inputs import (decode_inputs, prefill_inputs,
                                       train_inputs)
from repro_torch.launch.mesh import fake_group, make_mesh, production_shape
from repro_torch.launch.presets import Preset, make_preset
from repro_torch.launch.qdeclare import declare_quantized
from repro_torch.launch.step_analysis import StepAnalysis, storage_bytes
from repro_torch.launch.train import make_shards, make_train_step
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamW, AdamWState

Tree = Any
RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = torch.float32


def code_hash() -> str:
    """sha256 (16 hex digits) of the port's Python sources, every
    ``.py`` under the package by relative path.  Each record carries it
    as ``code``; :func:`run_cell` reuses an ok record only where it
    matches, so a record traced by other code is traced again."""
    paths = sorted(os.path.relpath(os.path.join(d, f), PACKAGE_DIR)
                   for d, _, files in os.walk(PACKAGE_DIR)
                   for f in files if f.endswith(".py"))
    h = hashlib.sha256()
    for rel in paths:
        h.update(rel.encode() + b"\0")
        with open(os.path.join(PACKAGE_DIR, rel), "rb") as f:
            h.update(f.read() + b"\0")
    return h.hexdigest()[:16]


def trace_device() -> str:
    """"cuda" where this PyTorch is built with CUDA, else "cpu" (see the
    module docstring)."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _fake(tree: Tree, device: str) -> Tree:
    """Every tensor of ``tree`` (meta, or fake already) as a tensor of its
    shape and dtype on ``device``, under the caller's FakeTensorMode; a
    QLinear field by field."""
    def leaf(_, t):
        if isinstance(t, QLinear):
            return QLinear(**{f: (torch.empty(v.shape, dtype=v.dtype,
                                              device=device)
                                  if isinstance(v, torch.Tensor) else v)
                              for f, v in vars(t).items()})
        return torch.empty(t.shape, dtype=t.dtype, device=device)
    return map_tree(tree, leaf)


# ---------------------------------------------------------------------------
# Abstract state builders
# ---------------------------------------------------------------------------
def abstract_train_state(cfg: ArchConfig, par, device: str) -> Tree:
    """The whole train state as tensors without data: the declared
    params, AdamW's step and its f32 μ and ν, the residual scalar."""
    decl = M.declare_params(cfg, par)
    params = map_tree(decl, lambda _, p: torch.empty(p.shape, dtype=p.dtype,
                                                     device=device))
    f32 = lambda _, p: torch.empty(p.shape, dtype=F32, device=device)
    return {"params": params,
            "opt": AdamWState(torch.empty((), dtype=torch.int32,
                                          device=device),
                              map_tree(decl, f32), map_tree(decl, f32)),
            "residual": torch.empty((), dtype=F32, device=device)}


def serving_params(cfg: ArchConfig, par, rules, quantized: bool,
                   qcfg: QuantConfig, min_dim: int) -> Tuple[Tree, Tree]:
    """(abstract params, Spec tree) for prefill / decode cells: packed
    ``QLinear``s of ``declare_quantized``, or the bf16 declaration."""
    if quantized:
        return declare_quantized(cfg, par, qcfg, rules, min_dim=min_dim)
    decl = M.declare_params(cfg, par)
    return (map_tree(decl, lambda _, p: torch.empty(
        p.shape, dtype=p.dtype, device="meta")), specs_for_tree(decl, rules))


# ---------------------------------------------------------------------------
# Trace one cell
# ---------------------------------------------------------------------------
def trace_cell(cfg: ArchConfig, cell: ShapeCell, mesh, preset: Preset, *,
               quantized_serving: bool = True,
               qcfg: QuantConfig = QuantConfig(), min_dim: int = 256
               ) -> Tuple[StepAnalysis, Dict]:
    """Run this rank's step of ``cell`` once inside a ``StepAnalysis``,
    on fake tensors of the mesh's device type.  The caller holds a
    FakeTensorMode and a fake process group under ``mesh``.  Returns (the analysis, {trace_s, place_s,
    local_state_bytes}): the last the bytes this rank holds of the state
    placed by its specs (train: params, μ, ν, step and residual;
    serving: the placed params, before their local views, and a decode
    cell's caches)."""
    device = mesh.device_type
    par, rules = preset.par, preset.rules
    sa = StepAnalysis(mesh)
    t0 = time.time()
    if cell.kind == "train":
        shards = make_shards(cfg, par, mesh, rules)
        whole = abstract_train_state(cfg, par, device)
        place = lambda tree: distribute_tree(tree, shards.specs, mesh)
        opt_w = whole["opt"]
        state = {"params": place(whole["params"]),
                 "opt": AdamWState(opt_w.step, place(opt_w.mu),
                                   place(opt_w.nu)),
                 "residual": whole["residual"]}
        del whole, opt_w
        inp, _ = train_inputs(cfg, cell, par, rules)
        batch = _fake(inp, device)
        step = make_train_step(cfg, AdamW(lr=1e-4), CompressionConfig(),
                               par.microbatches, par.remat, par.attn_chunk,
                               shards)
        args: Tuple = (state, batch)
        run = lambda: step(state, batch)
        held = storage_bytes(state)
    else:
        p_abs, pspec = serving_params(cfg, par, rules, quantized_serving,
                                      qcfg, min_dim)
        params = _fake(p_abs, device)
        held = storage_bytes(distribute_tree(params, pspec, mesh))
        shards, lp = M.shard_for_serving(cfg, par, params, pspec, mesh)
        del p_abs, params
        if cell.kind == "prefill":
            inp, _ = prefill_inputs(cfg, cell, par, rules)
            rows = shards.rows(cell.global_batch)
            batch = {k: v[rows] for k, v in _fake(inp, device).items()}
            args = (lp, batch)
            run = lambda: M.prefill(cfg, lp, batch, cell.seq_len,
                                    par.attn_chunk, shards=shards)
        else:
            (tok, pos, caches), (_, _, cspec) = decode_inputs(
                cfg, cell, par, rules)
            rows = shards.rows(cell.global_batch)
            tok, pos = (_fake(t, device)[rows] for t in (tok, pos))
            placed = distribute_tree(_fake(caches, device), cspec, mesh)
            held += storage_bytes(placed)
            caches = map_tree(placed, lambda _, t: local(t))
            del placed
            args = (lp, tok, pos, caches)
            run = lambda: M.decode_step(cfg, lp, tok, pos, caches,
                                        cell.seq_len, shards=shards)
    place_s = time.time() - t0
    t0 = time.time()
    with sa:
        sa.arguments(args)
        out = run()
        sa.outputs(out)
    return sa, {"trace_s": time.time() - t0, "place_s": place_s,
                "local_state_bytes": held}


def analyze(sa: StepAnalysis, mesh_devices: int, cfg: ArchConfig,
            cell: ShapeCell) -> Dict:
    """The record's analysis keys (the reference's ``analyze``)."""
    rec = sa.result()
    flops = rec["flops_per_device"]
    n_active = cfg.active_params()
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    mult = 6 if cell.kind == "train" else 2
    model_flops = mult * n_active * tokens
    per_dev = model_flops / mesh_devices
    rec.update(model_flops=model_flops, model_flops_per_device=per_dev,
               useful_flops_ratio=(per_dev / flops) if flops else 0.0,
               devices=mesh_devices)
    return rec


def cell_record(cfg: ArchConfig, cell: ShapeCell, shape: Sequence[int],
                axes: Sequence[str], *, rank: int = 0,
                quantized_serving: bool = True,
                qcfg: QuantConfig = QuantConfig(), min_dim: int = 256,
                log: bool = False) -> Dict:
    """Trace ``cell`` of ``cfg`` as ``rank`` of a fake mesh of ``shape``
    (dims ``axes``) in this process: start the fake group, make the
    mesh and the preset, trace under a FakeTensorMode, end the group.
    Returns the record's preset and analysis keys; with ``log``, also
    every collective as it was counted (``collective_log``)."""
    world = math.prod(shape)
    fake_group(world, rank)
    try:
        mesh = make_mesh(shape, axes, trace_device())
        preset = make_preset(cfg, cell, mesh)
        with FakeTensorMode(allow_non_fake_inputs=True):
            sa, times = trace_cell(cfg, cell, mesh, preset,
                                   quantized_serving=quantized_serving,
                                   qcfg=qcfg, min_dim=min_dim)
            rec = analyze(sa, world, cfg, cell)
        if log:
            rec["collective_log"] = sa.counter.collectives
        par = preset.par
        return {
            "quantized_serving": bool(quantized_serving
                                      and cell.kind != "train"),
            "preset": {"tp": par.tp, "dp": par.dp, "fsdp": par.fsdp,
                       "sp": par.sp, "microbatches": par.microbatches,
                       "remat": par.remat, "shard_batch": par.shard_batch,
                       "ep": preset.rules.ep},
            "rank": rank, "device_type": mesh.device_type, **times, **rec}
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, cell_name: str, mesh_kind: str, *,
             quantized_serving: bool = True, out_dir: str = RESULTS_DIR,
             force: bool = False, tag: str = "", rank: int = 0) -> Dict:
    cfg = registry.get(arch)
    cell = cell_by_name(cell_name)
    ok, why = cell_applicable(cfg, cell)
    base = f"{arch}__{cell_name}{('__' + tag) if tag else ''}"
    mesh_dir = os.path.join(out_dir, mesh_kind)
    os.makedirs(mesh_dir, exist_ok=True)
    path = os.path.join(mesh_dir, base + ".json")

    if not ok:
        rec = {"arch": arch, "cell": cell_name, "mesh": mesh_kind,
               "status": "skipped", "reason": why}
        with open(path, "w") as f:
            json.dump(rec, f, indent=2)
        return rec

    if os.path.exists(path) and not force:
        with open(path) as f:
            rec = json.load(f)
        if (rec.get("status") == "ok" and rec.get("rank") == rank
                and rec.get("code") == code_hash()
                and rec.get("quantized_serving") == bool(
                    quantized_serving and cell.kind != "train")):
            return rec

    shape, axes = production_shape(multi_pod=(mesh_kind == "multipod"))
    try:
        rec = {"arch": arch, "cell": cell_name, "mesh": mesh_kind,
               "status": "ok", "code": code_hash(),
               **cell_record(cfg, cell, shape, axes, rank=rank,
                             quantized_serving=quantized_serving)}
    except Exception as e:  # a failing cell is a bug: record it loudly
        rec = {"arch": arch, "cell": cell_name, "mesh": mesh_kind,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="multi-pod dry-run of the port")
    p.add_argument("--arch", default=None)
    p.add_argument("--cell", default=None)
    p.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    p.add_argument("--all", action="store_true",
                   help="all assigned archs × all applicable cells")
    p.add_argument("--serve-fp", action="store_true",
                   help="bf16 weights for serving cells (baseline variant)")
    p.add_argument("--tag", default="",
                   help="suffix for the result filename (perf variants)")
    p.add_argument("--force", action="store_true")
    p.add_argument("--out", default=RESULTS_DIR)
    args = p.parse_args(argv)

    if args.all:
        archs = registry.ASSIGNED
        cells = [c.name for c in SHAPE_CELLS]
    else:
        archs = [args.arch or "qwen3-4b"]
        cells = [args.cell or "train_4k"]

    n_ok = n_skip = n_err = 0
    for arch in archs:
        for cell in cells:
            t0 = time.time()
            rec = run_cell(arch, cell, args.mesh,
                           quantized_serving=not args.serve_fp,
                           out_dir=args.out, force=args.force,
                           tag=args.tag)
            dt = time.time() - t0
            st = rec["status"]
            n_ok += st == "ok"
            n_skip += st == "skipped"
            n_err += st == "error"
            extra = ""
            if st == "ok":
                r = rec["roofline"]
                extra = (f"dominant={r['dominant']} "
                         f"bound={r['step_time_lower_bound_s']*1e3:.2f}ms "
                         f"compute_frac={r['compute_fraction']:.3f} "
                         f"peak={rec['memory']['peak_bytes']/1e9:.2f}GB")
            elif st == "error":
                extra = rec["error"][:120]
            print(f"[{st:7s}] {arch:22s} {cell:12s} mesh={args.mesh:8s} "
                  f"({dt:5.1f}s) {extra}", flush=True)
    print(f"\nok={n_ok} skipped={n_skip} error={n_err}")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
