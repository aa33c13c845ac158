"""Training launcher of the port (twin of ``repro.launch.train``): the
train step with gradient accumulation and activation checkpointing,
AdamW with weight decay, clipping and the cosine schedule, optional
error-feedback gradient compression, checkpoint/restart in the
reference's on-disk layout, failure injection and the straggler
watchdog.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --steps 30 --batch 8 --seq 512 --lr 3e-4 --warmup 5 --remat
    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny-lm \\
        --reduced --steps 20 --device cpu
    # restart path: a failure at step 9, restored from the step-8
    # checkpoint, the final loss that of an uninterrupted run
    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny-lm \\
        --steps 12 --batch 2 --seq 32 --save-every 4 --fail-at-step 9 \\
        --ckpt-dir /tmp/ckpt --device cpu

Runs on the GPU (``--device cuda``, the default) and raises when CUDA is
absent; ``--device cpu`` runs the same path on the CPU.  ``--mesh
host`` (the default) trains on one device, where ``--fsdp`` changes
nothing, as in the reference.

Across devices, the step of every architecture runs under a ("data",
"model") or ("pod", "data", "model") ``DeviceMesh``: the train state
is held as DTensors placed by the reference's rules
(``distributed.sharding``: heads, kv_heads, ffn, rnn and vocab over
"model", the experts too under EP (``parallel_for(..., ep=True)``);
with ``--fsdp`` the embed dim over the data dims too, ZeRO-3; mu, nu,
the residual and the microbatch accumulator sharded as the params,
ZeRO-2), each rank runs the model on its local shards and its rows of
the batch (``models.common.Shards``; an MoE routes its data rank's
rows alone, the reference's group-local dispatch), and the optimizer
and the compressor take the reference's whole-leaf norms and
statistics.  ``run`` makes no ``frames``, as the reference's does not:
an encoder-decoder model trains through :func:`make_train_step` with
a batch that carries them.
``--mesh pod`` (256 ranks) and ``--mesh multipod`` (512) build the
production mesh over NCCL under ``torchrun`` (one process per card;
``WORLD_SIZE`` must be 256 or 512, or ``run`` raises ``ValueError``
naming it)::

    torchrun --nnodes 16 --nproc-per-node 16 ... \
        -m repro_torch.launch.train --mesh pod --fsdp --arch qwen2.5-3b

``run(args, mesh=...)`` takes a mesh the caller built with
``launch.mesh.make_mesh`` (the tests' (4, 1), (2, 2) and (1, 4) gloo
meshes on the CPU, ``chip_smoke.py``'s (1, 1) NCCL mesh on one card);
it adds no flag, as the reference's CLI has no such mesh either.

The state is ``{"params", "opt", "residual"}`` with the port's
per-layer parameter trees.  A checkpoint holds it in the reference's
layout (``bridge.params_to_repro`` on params, mu, nu and residual:
stage leaves stacked over layers), so either package restores what the
other wrote; with ``--restore auto`` a run starts from the newest
checkpoint in ``--ckpt-dir``, whichever package wrote it.  Batches are
a pure function of the step (``host=step, n_hosts=1 << 30``), so a
restart replays no batch and skips none.  Checkpoint labels count the
steps completed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import pytree
from repro_torch.bridge import params_from_repro, params_to_repro, to_tensor
from repro_torch.checkpoint.store import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.configs import registry
from repro_torch.configs.base import ArchConfig
from repro_torch.core.select import map_tree
from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
from repro_torch.distributed.compression import (CompressionConfig, compress,
                                                 init_residual, wire_bytes)
from repro_torch.distributed.fault import (FailureInjector, StragglerWatchdog,
                                           Supervisor)
from repro_torch.distributed.sharding import (at, distribute, is_dtensor,
                                              like, local, local_part,
                                              mesh_axis_names, rules_for_mesh,
                                              specs_for_tree)
from repro_torch.launch.mesh import make_production_mesh, production_shape
from repro_torch.models import model as M
from repro_torch.models.common import Parallel, Shards
from repro_torch.models.param import materialize
from repro_torch.optim.adamw import AdamW, AdamWState, cosine_schedule
from repro_torch.runtime.engine import resolve_device

Tree = Any
F32 = torch.float32


# ---------------------------------------------------------------------------
# Train state & step
# ---------------------------------------------------------------------------
def _loss_and_grads(cfg: ArchConfig, params: Tree, batch, attn_chunk: int,
                    remat: bool, shards: Optional[Shards] = None):
    """(loss, grads): the gradients in the parameters' dtypes, zeros for
    a parameter the loss does not reach (as ``jax.grad`` gives).  With
    ``shards``, of this rank's local shards (reduced over the ranks)
    and its share of the loss."""
    ps = pytree.leaves(params)
    req = [p.detach().requires_grad_(True) for p in ps]
    loss = M.forward_loss(cfg, pytree.unflatten(params, req), batch,
                          attn_chunk, remat=remat, shards=shards)
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    return loss.detach(), pytree.unflatten(params, [
        torch.zeros_like(p) if g is None else g for p, g in zip(ps, grads)])


def make_train_step(cfg: ArchConfig, opt: AdamW, ccfg: CompressionConfig,
                    microbatches: int = 1, remat: bool = False,
                    attn_chunk: int = 1024,
                    shards: Optional[Shards] = None) -> Callable:
    """(state, batch) -> (state, metrics).  With ``microbatches`` > 1 the
    batch is split on its first axis and the gradients summed in f32
    (the reference's scan carry), then divided; the compressor runs on
    the averaged gradient (EF equivalence, ``distributed/compression``).
    The state is updated in place (the reference donates it).

    With ``shards`` (:func:`make_shards`; the reference's
    ``param_spec``) the state's leaves are DTensors and ``batch`` is the
    global batch on every rank: microbatch i is rows [i*b/mb,
    (i+1)*b/mb) of it, split over the data ranks, as the reference
    groups it; each rank runs its rows on its local shards, the f32
    accumulator is sharded as the params (ZeRO-2), and the reported
    loss is summed over the data ranks.  Its first call refuses a state
    whose params ``model.check_shardable`` refuses (packed leaves)."""
    rows = (lambda n: slice(None)) if shards is None else shards.rows
    checked = shards is None

    def train_step(state: Tree, batch: Dict[str, torch.Tensor]):
        nonlocal checked
        params, opt_state, residual = (state["params"], state["opt"],
                                       state["residual"])
        if not checked:
            M.check_shardable(cfg, shards.par, params)
            checked = True
        lparams = pytree.tree_map(local, params)
        mb = microbatches
        b = batch["tokens"].shape[0]
        if mb > 1:
            assert b % mb == 0, (b, mb)
            split = {k: v.reshape((mb, b // mb) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            dev = batch["tokens"].device
            loss = torch.zeros((), dtype=F32, device=dev)
            grads = pytree.tree_map(
                lambda p: torch.zeros(p.shape, dtype=F32, device=p.device),
                lparams)
            acc = pytree.leaves(grads)
            for i in range(mb):
                l_i, g_i = _loss_and_grads(
                    cfg, lparams,
                    {k: v[i][rows(b // mb)] for k, v in split.items()},
                    attn_chunk, remat, shards)
                loss = loss + l_i
                for a, g in zip(acc, pytree.leaves(g_i)):
                    a.add_(g)
                del g_i
            div = torch.tensor(mb, dtype=F32, device=dev)
            loss = loss / div
            for a in acc:
                a.div_(div)
        else:
            loss, grads = _loss_and_grads(
                cfg, lparams, {k: v[rows(b)] for k, v in batch.items()},
                attn_chunk, remat, shards)
        if shards is not None:
            loss = shards.data_sum(loss)
            grads = pytree.tree_map(like, params, grads)

        if ccfg.kind is not None:
            grads, residual = compress(grads, residual, ccfg)
        params, opt_state = opt.update_(grads, opt_state, params)
        return ({"params": params, "opt": opt_state, "residual": residual},
                {"loss": loss})

    return train_step


def init_state(cfg: ArchConfig, opt: AdamW, ccfg: CompressionConfig,
               seed: int = 0, device="cpu") -> Tree:
    params = M.init_params(cfg, seed, device)
    opt_state = opt.init(params)
    residual = (init_residual(params) if ccfg.kind is not None
                else torch.zeros((), dtype=F32, device=device))
    return {"params": params, "opt": opt_state, "residual": residual}


def parallel_for(mesh, microbatches: int = 1, remat: bool = False,
                 attn_chunk: int = 1024, fsdp: bool = False,
                 ep: bool = False):
    """(Parallel, Rules) of a run under ``mesh``, as the reference's
    ``run`` builds them: tp the "model" dim, dp the other devices,
    sequence parallelism on when tp > 1 (the residual stream between
    blocks is then each model rank's chunk of every microbatch's
    sequence, ``Shards.along``; the microbatches split the rows, never
    the sequence); ``ep`` shards the experts over
    "model" (``launch.presets`` chooses it; ``run`` does not, as the
    reference's does not)."""
    names = mesh_axis_names(mesh)
    tp = mesh.size(names.index("model"))
    par = Parallel(tp=tp, dp=mesh.size() // tp, fsdp=fsdp,
                   microbatches=microbatches, remat=remat,
                   attn_chunk=attn_chunk, sp=tp > 1)
    return par, rules_for_mesh(mesh, fsdp=fsdp, ep=ep)


def make_shards(cfg: ArchConfig, par: Parallel, mesh, rules) -> Shards:
    """This rank's :class:`Shards` for ``cfg``'s parameters under
    ``rules``; refuses what the sharded step does not run
    (``model.check_shardable``)."""
    M.check_shardable(cfg, par, ep=rules.ep)
    return Shards(mesh, par, specs_for_tree(M.declare_params(cfg, par),
                                            rules))


def init_sharded_state(cfg: ArchConfig, opt: AdamW, ccfg: CompressionConfig,
                       shards: Shards, seed: int = 0) -> Tree:
    """:func:`init_state`'s values as DTensors on the mesh's device: each
    leaf is made whole (the same on every rank), cut to this rank's
    part and freed, one leaf at a time."""
    mesh = shards.mesh
    device = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")

    def leaf(path, p):
        return distribute(materialize(p, seed, device, prefix=path),
                          at(shards.specs, path), mesh)

    params = map_tree(M.declare_params(cfg, shards.par), leaf)
    opt_state = opt.init(params)
    residual = (init_residual(params) if ccfg.kind is not None
                else torch.zeros((), dtype=F32, device=device))
    return {"params": params, "opt": opt_state, "residual": residual}


def state_to_repro(state: Tree, stack: Callable = torch.stack) -> Tree:
    """The state in the reference's layout: params, mu, nu and residual
    stacked over each stage's layers by ``stack``."""
    opt = state["opt"]
    return {"params": params_to_repro(state["params"], stack),
            "opt": AdamWState(opt.step, params_to_repro(opt.mu, stack),
                              params_to_repro(opt.nu, stack)),
            "residual": params_to_repro(state["residual"], stack)}


def state_from_repro(tree: Tree, device) -> Tree:
    """The inverse of :func:`state_to_repro`, on ``device``."""
    opt = tree["opt"]
    return {"params": params_from_repro(tree["params"], device),
            "opt": AdamWState(to_tensor(opt.step, device),
                              params_from_repro(opt.mu, device),
                              params_from_repro(opt.nu, device)),
            "residual": params_from_repro(tree["residual"], device)}


def _stack_to_cpu(ts) -> torch.Tensor:
    return torch.stack([t.detach().cpu() for t in ts])


def _stack_meta(ts) -> torch.Tensor:
    return torch.empty((len(ts),) + tuple(ts[0].shape), dtype=ts[0].dtype,
                       device="meta")


def _lead() -> bool:
    """True on global rank 0, or without a process group."""
    return not (dist.is_available() and dist.is_initialized()) or \
        dist.get_rank() == 0


def _gathered(state: Tree) -> Tree:
    """``state`` with each DTensor leaf whole on the host of global rank
    0 (a meta tensor on the other ranks), leaf by leaf in the tree's
    order, so every rank takes part in the same gathers."""
    lead = _lead()

    def leaf(t):
        if not is_dtensor(t):
            return t
        whole = t.full_tensor()
        return whole.cpu() if lead else torch.empty_like(whole,
                                                         device="meta")
    return pytree.tree_map(leaf, state)


def save_state(ckpt_dir: str, step: int, state: Tree) -> Optional[str]:
    """Write ``state`` at ``step`` in the reference's layout; stage leaves
    are stacked on the host, so the device holds no second copy.  A
    sharded state is gathered leaf by leaf and written once, by global
    rank 0 (the others return None after it has written): the bytes of
    the same state held on one device."""
    sharded = any(is_dtensor(t) for t in pytree.leaves(state))
    if sharded:
        state = _gathered(state)
    path = None
    if _lead():
        path = save_checkpoint(ckpt_dir, step,
                               state_to_repro(state, _stack_to_cpu))
    if sharded:
        dist.barrier()
    return path


def restore_state(ckpt_dir: str, state: Tree):
    """(state, step): the newest checkpoint in ``ckpt_dir`` read into
    ``state``'s tensors in place (``state`` is the template of its paths
    and shapes; the device holds no second copy).  A DTensor leaf takes
    its part of the whole leaf, so a checkpoint restores into any
    mesh."""
    tree, step = restore_checkpoint(ckpt_dir, state_to_repro(state,
                                                             _stack_meta),
                                    device="cpu")
    with torch.no_grad():
        for key_dst, src in zip(pytree.leaves_with_path(state),
                                pytree.leaves(state_from_repro(tree, "cpu"))):
            key, dst = key_dst
            if src.dtype != dst.dtype:
                raise ValueError(f"dtype mismatch at {key}: checkpoint "
                                 f"{src.dtype} vs state {dst.dtype}")
            if is_dtensor(dst):
                src = local_part(src, dst.device_mesh, dst.placements)
            local(dst).copy_(src)
    return state, step


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------
def build_mesh(kind: str, device: torch.device):
    """None for ``--mesh host`` (one device, no process group); else the
    production mesh over NCCL, one rank per card under ``torchrun``,
    whose ``WORLD_SIZE`` must be the mesh's device count."""
    if kind == "host":
        return None
    need = math.prod(production_shape(multi_pod=(kind == "multipod"))[0])
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != need:
        raise ValueError(f"--mesh {kind} trains on {need} ranks, one per "
                         f"card, under torchrun (WORLD_SIZE={need}); this "
                         f"process is one of {world}")
    if device.type != "cuda":
        raise ValueError(f"--mesh {kind} runs over NCCL: pass --device cuda")
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        dist.init_process_group("nccl")
    return make_production_mesh(multi_pod=(kind == "multipod"))


def run(args, mesh=None) -> Dict[str, Any]:
    """Train as ``args`` say; under ``mesh`` (a ``DeviceMesh`` from
    ``launch.mesh.make_mesh``, or the one ``--mesh pod|multipod``
    builds) with the sharded step, else on one device."""
    device = resolve_device(args.device)
    if mesh is None:
        mesh = build_mesh(args.mesh, device)
    elif args.mesh != "host":
        raise ValueError(f"run(mesh=...) takes --mesh host, not {args.mesh}")
    if mesh is not None and mesh.device_type != device.type:
        raise ValueError(f"a {mesh.device_type!r} mesh cannot train with "
                         f"--device {args.device}")
    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
        cfg = dataclasses.replace(cfg, vocab=min(cfg.vocab, 512))
    ccfg = CompressionConfig(kind=args.compression,
                             topk_frac=args.topk_frac)
    opt = AdamW(lr=args.lr, weight_decay=0.01, clip_norm=1.0,
                schedule=cosine_schedule(warmup=args.warmup,
                                         total=args.steps))
    shards = None
    if mesh is not None:
        par, rules = parallel_for(mesh, args.microbatches, args.remat,
                                  args.attn_chunk, args.fsdp)
        shards = make_shards(cfg, par, mesh, rules)
    step_fn = make_train_step(cfg, opt, ccfg, args.microbatches, args.remat,
                              args.attn_chunk, shards)
    lead = _lead()

    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=args.seed))

    def batch_at(step: int) -> Dict[str, torch.Tensor]:
        tok, tgt = next(corpus.batches(args.batch, args.seq, 1,
                                       split="train", host=step,
                                       n_hosts=1 << 30))
        return {"tokens": torch.from_numpy(tok).to(device),
                "targets": torch.from_numpy(tgt).to(device)}

    state = (init_state(cfg, opt, ccfg, seed=args.seed, device=device)
             if shards is None else
             init_sharded_state(cfg, opt, ccfg, shards, seed=args.seed))
    start = 0
    if args.restore == "auto" and args.ckpt_dir and \
            latest_step(args.ckpt_dir) is not None:
        state, start = restore_state(args.ckpt_dir, state)
        if lead:
            print(f"[restore] resumed from step {start}")

    injector = FailureInjector(tuple(args.fail_at_step or ()))
    watchdog = StragglerWatchdog()
    losses = []

    def restore() -> int:
        nonlocal state
        state, s = restore_state(args.ckpt_dir, state)
        return s

    def one_step(step: int):
        nonlocal state
        injector.maybe_fail(step)
        t0 = time.time()
        state, metrics = step_fn(state, batch_at(step))
        loss = float(metrics["loss"])
        losses.append(loss)
        watchdog.observe(step, time.time() - t0)
        if lead and step % args.log_every == 0:
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"({(time.time()-t0)*1e3:.0f} ms)")
        # checkpoint label = steps COMPLETED, so restore resumes at the
        # next step (no double-applied update after a restart)
        if args.ckpt_dir and (step + 1) % args.save_every == 0:
            save_state(args.ckpt_dir, step + 1, state)

    sup = Supervisor(restore, max_restarts=args.max_restarts)
    sup.run(one_step, start, args.steps)

    if args.ckpt_dir:
        save_state(args.ckpt_dir, args.steps, state)

    out = {"final_loss": losses[-1] if losses else None,
           "first_loss": losses[0] if losses else None,
           "restarts": sup.restarts,
           "straggler_steps": watchdog.slow_steps,
           "wire_bytes": wire_bytes(state["params"], ccfg)}
    if args.json_out and lead:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=2)
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="repro_torch training launcher")
    p.add_argument("--arch", default="tiny-lm")
    p.add_argument("--reduced", action="store_true",
                   help="train the reduced same-family config (CPU scale)")
    p.add_argument("--mesh", default="host",
                   choices=["host", "pod", "multipod"],
                   help="host: one device; pod (16 x 16) and multipod "
                        "(2 x 16 x 16): the production mesh over NCCL, "
                        "one rank per card under torchrun")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--attn-chunk", type=int, default=1024)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--fsdp", action="store_true",
                   help="shard parameters' embed dim over the data axes "
                        "(ZeRO-3); on the one device of --mesh host it "
                        "changes nothing, as in the reference")
    p.add_argument("--compression", default=None,
                   choices=[None, "int8", "topk"])
    p.add_argument("--topk-frac", type=float, default=0.1)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--save-every", type=int, default=50)
    p.add_argument("--restore", default="none", choices=["none", "auto"])
    p.add_argument("--fail-at-step", type=int, nargs="*", default=None)
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json-out", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


if __name__ == "__main__":
    run(parse_args())
