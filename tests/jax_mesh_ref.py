"""The reference's first-step loss and gradients under a mesh of host
CPU devices, for the port's sharded-step tests.  Not a test module: the
tests start it as a subprocess (:func:`start`), because the count of
host devices is fixed when JAX starts
(``XLA_FLAGS=--xla_force_host_platform_device_count``).

    python tests/jax_mesh_ref.py OUT_DIR ARCH BATCH SEQ FRAMES \
        NAME:DATA:MODEL:FSDP:EP ...

For each case, ``jax.value_and_grad(forward_loss)`` of the reduced
``ARCH`` (f32 weights from ``PRNGKey(0)``, the reference's synthetic
batch of step 0, with the encoder's ``frames`` read from the ``.npy``
file FRAMES unless it is ``-``) runs jitted under a (DATA, MODEL) mesh
of ("data", "model"), the parameters placed by ``rules_for_mesh(mesh,
fsdp, ep)`` and the batch over "data", as the reference's ``run``
places them.  It writes ``OUT_DIR/NAME.npz``: ``loss`` and the
gradients ``g0``, ``g1``, ... in the order of ``jax.tree.leaves`` of
the parameters.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_DEVICES = 4


def _case(spec: str):
    name, data, model, fsdp, ep = spec.split(":")
    return name, int(data), int(model), fsdp == "1", ep == "1"


def params_f32(cfg):
    """The reduced model's parameters from ``PRNGKey(0)``, in f32."""
    import jax
    from repro.models import model as RM
    from repro.models.common import Parallel
    p = RM.init_params(cfg, Parallel(), jax.random.PRNGKey(0))
    return jax.tree.map(lambda x: np.asarray(x, np.float32), p)


def reduced(arch: str):
    from repro.configs import registry
    cfg = registry.get(arch).reduced()
    return dataclasses.replace(cfg, vocab=min(cfg.vocab, 512))


def main(argv) -> int:
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
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=0))
    tok, tgt = next(corpus.batches(batch, seq, 1, host=0, n_hosts=1 << 30))
    data = {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt)}
    if argv[4] != "-":
        data["frames"] = jnp.asarray(np.load(argv[4]))
    for spec in argv[5:]:
        name, dp, tp, fsdp, ep = _case(spec)
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


def start(out_dir: Path, arch: str, batch: int, seq: int, cases,
          frames=None) -> tuple:
    """Start the script on ``cases`` ((name, data, model, fsdp, ep), ...)
    of ``arch`` in a process of its own with four host devices, the
    batch carrying ``frames`` (a numpy array (batch, S_enc, D)) when
    given; returns (process, log path) for :func:`finish`."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          f" --xla_force_host_platform_device_count="
                          f"{N_DEVICES}").strip(),
               PYTHONPATH=os.pathsep.join(
                   [str(root / "src")] +
                   [p for p in [os.environ.get("PYTHONPATH")] if p]))
    specs = [f"{n}:{d}:{m}:{int(f)}:{int(e)}" for n, d, m, f, e in cases]
    frames_arg = "-"
    if frames is not None:
        frames_arg = str(Path(out_dir) / f"{arch}.frames.npy")
        np.save(frames_arg, frames)
    log = Path(out_dir) / f"jax_mesh_ref.{arch}.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, __file__, str(out_dir), arch, str(batch),
             str(seq), frames_arg] + specs, stdout=f,
            stderr=subprocess.STDOUT, env=env)
    return proc, log


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
    sys.exit(main(sys.argv[1:]))
