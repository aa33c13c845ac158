"""The reference's first-step loss and gradients, and its sharded
serving of packed weights, under a mesh of host CPU devices, for the
port's sharded-step and sharded-serving tests.  Not a test module: the
tests start it as a subprocess (:func:`start`, :func:`start_serve`),
because the count of host devices is fixed when JAX starts
(``XLA_FLAGS=--xla_force_host_platform_device_count``).

    python tests/jax_mesh_ref.py OUT_DIR ARCH BATCH SEQ FRAMES \
        NAME:DATA:MODEL:FSDP:EP[:SEQ] ...

ARCH is an architecture, or one with config fields overridden:
``ARCH+FIELD=INT,...`` (:func:`arch_spec`; the field ``rg_heads`` sets
the reference's ``models.recurrent.RG_HEADS`` for the run, a module
attribute, :func:`rg_heads`).  For each case,
``jax.value_and_grad(forward_loss)`` of the reduced ``ARCH`` (f32
weights from ``PRNGKey(0)``, the reference's synthetic
batch of step 0 (of the case's own SEQ where it gives one), with the
``.npy`` file FRAMES unless it is ``-`` as the encoder's ``frames``,
or a vision model's ``vision_embeds``) runs jitted under a (DATA, MODEL) mesh
of ("data", "model"), the parameters placed by ``rules_for_mesh(mesh,
fsdp, ep)`` and the batch over "data", as the reference's ``run``
places them.  It writes ``OUT_DIR/NAME.npz``: ``loss`` and the
gradients ``g0``, ``g1``, ... in the order of ``jax.tree.leaves`` of
the parameters.

    python tests/jax_mesh_ref.py serve OUT_DIR INPUTS \
        NAME:ARCH:REPEATS:DATA:MODEL:EP:PACKED ...

For each case, the reference's ``M.prefill`` of the prompts of the
``.npz`` file INPUTS (``tokens``, ``positions``, ``frames`` for an
encoder-decoder ARCH; ``max_seq``, ``steps``, ``attn_chunk``), then
``steps`` greedy ``M.decode_step``s (the prefill given INPUTS'
``vision_embeds`` too, for a vision ARCH), on the reduced ``ARCH`` (its
stages' repeats set to REPEATS unless 0): its packed weights of
:func:`serve_params` with PACKED (the packed products on the
reference's kernel route, its Pallas kernel in interpret mode at every
shape, as the one-device tests run it), else its f32 weights of
:func:`params_f32`.  DATA x MODEL = 1: the one-device functions, run
eagerly as the one-device tests run them; else each jitted under a
(DATA, MODEL) mesh of ("data", "model"), the weights placed by
``launch.qdeclare.declare_quantized``'s specs (EP with EP) and the
batch over "data".  It writes ``OUT_DIR/NAME.npz``: ``prefill`` (B, V),
``step<i>`` (B, V) and ``token<i>`` (B,).

    python tests/jax_mesh_ref.py dryrun OUT_DIR \
        NAME:ARCH:KIND:BATCH:SEQ:DATA:MODEL ...

For each case, the reference's dry-run (``repro.launch.dryrun``,
imported first, so that its 512 host devices exist) of the reduced
``ARCH`` (vocabulary at most 512) on a ``ShapeCell`` of KIND ("train",
"prefill" or "decode"), BATCH rows and SEQ positions, under a (DATA,
MODEL) mesh of ("data", "model") over its first DATA x MODEL devices,
with the preset ``make_preset`` gives it: ``lower_cell`` (the serving
cells on packed weights of ``DRYRUN_QUANT``, declared with its
``min_dim``), the compile, and ``analyze``.  It writes
``OUT_DIR/NAME.json``: the record of ``analyze`` beside the preset.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_DEVICES = 4


def _case(spec: str):
    name, data, model, fsdp, ep, *seq = spec.split(":")
    return (name, int(data), int(model), fsdp == "1", ep == "1",
            int(seq[0]) if seq else None)


def params_f32(cfg):
    """The reduced model's parameters from ``PRNGKey(0)``, in f32."""
    import jax
    from repro.models import model as RM
    from repro.models.common import Parallel
    p = RM.init_params(cfg, Parallel(), jax.random.PRNGKey(0))
    return jax.tree.map(lambda x: np.asarray(x, np.float32), p)


def arch_spec(arch: str, over=None) -> str:
    """The ARCH argument of ``arch`` with the config fields ``over``
    ({field: int}; ``rg_heads`` among them) overridden."""
    if not over:
        return arch
    return arch + "+" + ",".join(f"{k}={int(v)}" for k, v in
                                 sorted(over.items()))


def parse_arch(spec: str):
    """:func:`arch_spec`'s inverse: (arch, {field: int})."""
    arch, _, rest = spec.partition("+")
    over = {}
    for item in filter(None, rest.split(",")):
        k, v = item.split("=")
        over[k] = int(v)
    return arch, over


@contextlib.contextmanager
def rg_heads(spec: str):
    """The reference's ``models.recurrent.RG_HEADS`` set to the
    ``rg_heads`` field of the ARCH ``spec`` in the body (read at every
    call), or left as it is."""
    from repro.models import recurrent as RR
    n = parse_arch(spec)[1].get("rg_heads")
    plain = RR.RG_HEADS
    if n is not None:
        RR.RG_HEADS = n
    try:
        yield
    finally:
        RR.RG_HEADS = plain


def reduced(arch: str, repeats: int = 0):
    """The reduced ``arch`` (an ARCH argument: its config fields
    overridden), its vocabulary at most 512, its stages' repeats set to
    ``repeats`` unless 0."""
    from repro.configs import registry
    from repro.configs.base import Stage
    name, over = parse_arch(arch)
    over.pop("rg_heads", None)
    cfg = registry.get(name).reduced()
    cfg = dataclasses.replace(cfg, vocab=min(cfg.vocab, 512), **over)
    if repeats:
        cfg = dataclasses.replace(cfg, stages=tuple(
            Stage(s.pattern, repeats) for s in cfg.stages))
    return cfg


# data-free PTQ1.61 of the serving tests: ratio, multiple, min_dim
SERVE_QUANT = (0.2, 8, 32)


def serve_qcfg():
    from repro.core.qlinear import QuantConfig
    ratio, multiple, _ = SERVE_QUANT
    return QuantConfig(use_kernel=True, ratio=ratio, multiple=multiple)


def serve_params(cfg):
    """:func:`params_f32` of ``cfg`` quantized data-free, unfused, with
    the reference's kernel route (``SERVE_QUANT``)."""
    import jax
    import jax.numpy as jnp
    from repro.core.pipeline import quantize_params_data_free
    p = jax.tree.map(jnp.asarray, params_f32(cfg))
    return quantize_params_data_free(p, serve_qcfg(), min_dim=SERVE_QUANT[2],
                                     fuse=False)


def kernel_route(patch) -> None:
    """The reference's packed products on its Pallas kernel (interpret
    mode on the CPU) at every shape with both spans: ``patch(module,
    name, value)`` replaces ``ops._kernel_choice`` (``setattr``, or a
    pytest ``MonkeyPatch``'s)."""
    from repro.kernels import autotune, ops as rops

    def choice(m, k_s, k_b, n):
        if k_s <= 0 or k_b <= 0:
            return None
        return autotune.BlockChoice(bm=m, bn=n,
                                    bk=autotune.common_bk(k_s, k_b),
                                    vmem_bytes=0, hbm_bytes=0, time_s=0.0)
    patch(rops, "_kernel_choice", choice)


def placeable(mesh, tree, shardings):
    """``shardings`` with each leaf whose spec cuts a dim that its mesh
    dims do not divide (a packed leaf's byte rows) replicated instead:
    JAX places only even shards, and a jitted function's values do not
    depend on where its inputs lie."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as PS

    def one(a, sh):
        for size, entry in zip(a.shape, sh.spec):
            names = (entry,) if isinstance(entry, str) else tuple(entry or ())
            n = 1
            for name in names:
                n *= mesh.shape[name]
            if size % n:
                return NamedSharding(mesh, PS())
        return sh
    return jax.tree.map(one, tree, shardings)


def serve_eager(cfg, params, batch, max_seq: int, steps: int, chunk: int
                ) -> dict:
    """The reference's one-device prefill of ``batch`` (numpy arrays)
    and ``steps`` greedy decode steps, eagerly: the ``.npz`` arrays of
    the serve mode."""
    import jax.numpy as jnp
    from repro.models import model as RM
    from repro.models.common import Parallel
    par = Parallel(attn_chunk=chunk)
    logits, caches = RM.prefill(cfg, par, params, {
        k: jnp.asarray(v) for k, v in batch.items()}, max_seq)
    res = {"prefill": np.asarray(logits[:, 0])}
    tok = jnp.argmax(logits[:, 0], axis=-1).astype(jnp.int32)
    pos = jnp.asarray(batch["positions"][:, -1] + 1)
    for i in range(steps):
        res[f"token{i}"] = np.asarray(tok)
        logits, caches = RM.decode_step(cfg, par, params, tok, pos, caches,
                                        max_seq)
        res[f"step{i}"] = np.asarray(logits)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        pos = pos + 1
    return res


def read_serve(path) -> dict:
    """A serve-mode ``.npz`` as {"prefill", "steps": [...], "tokens":
    [...]}."""
    z = np.load(path)
    n = sum(1 for k in z.files if k.startswith("step"))
    return {"prefill": z["prefill"],
            "steps": [z[f"step{i}"] for i in range(n)],
            "tokens": [z[f"token{i}"] for i in range(n)]}


def serve_main(argv) -> int:
    out, inp = Path(argv[0]), np.load(argv[1])
    kernel_route(setattr)
    for spec in argv[2:]:
        name, arch, repeats, dp, tp, ep, packed = spec.split(":")
        with rg_heads(arch):
            _serve_case(out, inp, name, arch, int(repeats), int(dp), int(tp),
                        ep, packed)
    return 0


def _serve_case(out, inp, name, arch, repeats, dp, tp, ep, packed) -> None:
    """One case of the serve mode (its spec's fields)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as PS
    from repro.distributed.sharding import (named_shardings, rules_for_mesh,
                                            specs_for_tree)
    from repro.launch.mesh import compat_make_mesh
    from repro.launch.qdeclare import declare_quantized
    from repro.models import model as RM
    from repro.models.common import Parallel
    max_seq, steps, chunk = (int(inp[k]) for k in ("max_seq", "steps",
                                                   "attn_chunk"))
    cfg = reduced(arch, repeats)
    weights = (serve_params(cfg) if packed == "1" else
               jax.tree.map(jnp.asarray, params_f32(cfg)))
    names = ("tokens", "positions") + (("frames",) if cfg.enc_dec
                                       else ()) + tuple(
        k for k in ("vision_embeds",)
        if k in inp.files and cfg.frontend == "vision")
    if dp * tp == 1:
        res = serve_eager(cfg, weights, {k: inp[k] for k in names},
                          max_seq, steps, chunk)
        np.savez(out / f"{name}.npz", **res)
        return
    mesh = compat_make_mesh((dp, tp), ("data", "model"))
    par = Parallel(tp=tp, dp=dp, sp=tp > 1, remat=False,
                   attn_chunk=chunk)
    rules = rules_for_mesh(mesh, ep=ep == "1")
    pspec = (declare_quantized(cfg, par, serve_qcfg(), rules,
                               min_dim=SERVE_QUANT[2])[1]
             if packed == "1" else
             specs_for_tree(RM.declare_params(cfg, par), rules))
    rows = NamedSharding(mesh, PS("data" if dp > 1 else None))
    res = {}
    with mesh:
        params = jax.device_put(weights, placeable(
            mesh, weights, named_shardings(mesh, pspec)))
        batch = {k: jax.device_put(jnp.asarray(inp[k]), rows)
                 for k in names}
        prefill = jax.jit(lambda p, b: RM.prefill(cfg, par, p, b,
                                                  max_seq))
        step = jax.jit(lambda p, t, q, c: RM.decode_step(
            cfg, par, p, t, q, c, max_seq))
        logits, caches = prefill(params, batch)
        res["prefill"] = np.asarray(logits[:, 0])
        tok = jnp.argmax(logits[:, 0], axis=-1).astype(jnp.int32)
        pos = jnp.asarray(inp["positions"][:, -1] + 1)
        for i in range(steps):
            res[f"token{i}"] = np.asarray(tok)
            logits, caches = step(params, jax.device_put(tok, rows),
                                  jax.device_put(pos, rows), caches)
            res[f"step{i}"] = np.asarray(logits)
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            pos = pos + 1
    np.savez(out / f"{name}.npz", **res)


# packed weights of the dry-run's serving cells: ratio, multiple, min_dim
DRYRUN_QUANT = (0.2, 32, 32)


def dryrun_main(argv) -> int:
    import functools
    import json
    from repro.launch import dryrun as RD   # first: its XLA_FLAGS
    import jax
    from jax.sharding import Mesh
    from repro.configs.base import ShapeCell
    from repro.core.qlinear import QuantConfig
    from repro.launch.presets import make_preset
    out = Path(argv[0])
    ratio, multiple, min_dim = DRYRUN_QUANT
    RD.declare_quantized = functools.partial(RD.declare_quantized,
                                             min_dim=min_dim)
    for spec in argv[1:]:
        name, arch, kind, batch, seq, dp, tp = spec.split(":")
        cfg = reduced(arch)
        cell = ShapeCell(name, int(seq), int(batch), kind)
        n = int(dp) * int(tp)
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(int(dp), int(tp)),
                    ("data", "model"))
        preset = make_preset(cfg, cell, mesh)
        compiled = RD.lower_cell(
            cfg, cell, mesh, preset,
            qcfg=QuantConfig(ratio=ratio, multiple=multiple)).compile()
        rec = RD.analyze(compiled, mesh, cfg, cell)
        par = preset.par
        rec["preset"] = {"tp": par.tp, "dp": par.dp, "fsdp": par.fsdp,
                         "sp": par.sp, "microbatches": par.microbatches,
                         "remat": par.remat, "shard_batch": par.shard_batch,
                         "ep": preset.rules.ep}
        (out / f"{name}.json").write_text(json.dumps(rec))
    return 0


def start_dryrun(out_dir: Path, tag: str, cases) -> tuple:
    """Start the ``dryrun`` mode on ``cases`` ((name, arch, kind, batch,
    seq, data, model), ...) in a process of its own; returns (process,
    log path) for :func:`finish`."""
    return _spawn(["dryrun", str(out_dir)]
                  + [":".join(str(v) for v in c) for c in cases],
                  Path(out_dir) / f"jax_mesh_ref.dryrun.{tag}.log")


def main(argv) -> int:
    with rg_heads(argv[1]):
        return _train_main(argv)


def _train_main(argv) -> int:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS
    from repro.data.synthetic import CorpusConfig, SyntheticCorpus
    from repro.distributed.sharding import (named_shardings, rules_for_mesh,
                                            specs_for_tree)
    from repro.launch.mesh import compat_make_mesh
    from repro.models import model as RM
    from repro.models.common import Parallel

    out, arch, batch, seq = Path(argv[0]), argv[1], int(argv[2]), int(argv[3])
    cfg = reduced(arch)
    params = params_f32(cfg)
    extra = {}
    if argv[4] != "-":
        key = "vision_embeds" if cfg.frontend == "vision" else "frames"
        extra[key] = jnp.asarray(np.load(argv[4]))
    for spec in argv[5:]:
        name, dp, tp, fsdp, ep, case_seq = _case(spec)
        corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=0))
        tok, tgt = next(corpus.batches(batch, case_seq or seq, 1, host=0,
                                       n_hosts=1 << 30))
        data = {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt),
                **extra}
        mesh = compat_make_mesh((dp, tp), ("data", "model"))
        par = Parallel(tp=tp, dp=dp, fsdp=fsdp, remat=True, sp=tp > 1)
        rules = rules_for_mesh(mesh, fsdp=fsdp, ep=ep)
        pspec = specs_for_tree(RM.declare_params(cfg, par), rules)
        bspec = {k: PS("data" if dp > 1 else None) for k in data}
        fn = jax.value_and_grad(lambda p, b: RM.forward_loss(cfg, par, p, b))
        with mesh:
            jfn = jax.jit(fn, in_shardings=(named_shardings(mesh, pspec),
                                            named_shardings(mesh, bspec)))
            loss, grads = jfn(params, data)
        arrays = {f"g{i}": np.asarray(g)
                  for i, g in enumerate(jax.tree.leaves(grads))}
        np.savez(out / f"{name}.npz", loss=np.asarray(loss), **arrays)
    return 0


def _env():
    root = Path(__file__).resolve().parents[1]
    return dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                           f" --xla_force_host_platform_device_count="
                           f"{N_DEVICES}").strip(),
                PYTHONPATH=os.pathsep.join(
                    [str(root / "src")] +
                    [p for p in [os.environ.get("PYTHONPATH")] if p]))


def _spawn(args, log: Path) -> tuple:
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, __file__] + args, stdout=f,
                                stderr=subprocess.STDOUT, env=_env())
    return proc, log


def start_serve(out_dir: Path, tag: str, inputs: dict, cases) -> tuple:
    """Start the ``serve`` mode on ``cases`` ((name, arch, repeats,
    data, model, ep, packed), ...) in a process of its own with four
    host devices; ``inputs`` are the arrays and ints of the INPUTS file
    (``OUT_DIR/<tag>.serve_inputs.npz``).  Returns (process, log path)
    for :func:`finish`."""
    path = Path(out_dir) / f"{tag}.serve_inputs.npz"
    np.savez(path, **inputs)
    return _spawn(["serve", str(out_dir), str(path)]
                  + [":".join(str(int(v) if isinstance(v, bool) else v)
                              for v in c) for c in cases],
                  Path(out_dir) / f"jax_mesh_ref.serve.{tag}.log")


def start(out_dir: Path, arch: str, batch: int, seq: int, cases,
          frames=None) -> tuple:
    """Start the script on ``cases`` ((name, data, model, fsdp, ep[,
    seq]), ...) of ``arch`` in a process of its own with four host
    devices, the batch carrying ``frames`` (a numpy array (batch, S_enc,
    D); a vision model's ``vision_embeds`` (batch, F, D)) when given;
    returns (process, log path) for :func:`finish`."""
    specs = [":".join([n] + [str(int(v)) for v in rest])
             for n, *rest in cases]
    frames_arg = "-"
    if frames is not None:
        frames_arg = str(Path(out_dir) / f"{arch}.frames.npy")
        np.save(frames_arg, frames)
    return _spawn([str(out_dir), arch, str(batch), str(seq), frames_arg]
                  + specs, Path(out_dir) / f"jax_mesh_ref.{arch}.log")


def finish(handle, deadline_s: float) -> None:
    """Wait for the process of :func:`start` until ``deadline_s`` from
    now; past it the process is killed.  Fails with its log's end if it
    was late or failed."""
    proc, log = handle
    end = time.monotonic() + deadline_s
    try:
        proc.wait(timeout=max(0.1, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"the reference's mesh run passed its "
                             f"deadline of {deadline_s:.0f} s\n"
                             + log.read_text()[-3000:])
    if proc.returncode:
        raise AssertionError(f"the reference's mesh run failed (rc "
                             f"{proc.returncode})\n"
                             + log.read_text()[-3000:])


if __name__ == "__main__":
    MODES = {"serve": serve_main, "dryrun": dryrun_main}
    mode = MODES.get(sys.argv[1] if len(sys.argv) > 1 else "")
    sys.exit(mode(sys.argv[2:]) if mode else main(sys.argv[1:]))
