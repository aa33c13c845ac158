"""One gloo rank of the port's sharded training, serving and pipeline
checks.

Started by ``tests/test_torch_dist_train.py``,
``tests/test_torch_dist_kinds.py``, ``tests/test_torch_dist_serve.py``,
``tests/test_torch_dist_serve_kinds.py``,
``tests/test_torch_dist_uneven.py``, ``tests/test_torch_dist_sp.py``,
``tests/test_torch_dist_fused.py`` and ``tests/test_torch_pipeline.py``,
one process per rank, with its rank,
the world size, a rendezvous file under the test's ``tmp_path``, the
case file's path and an output directory.  The parent writes the cases
in parts, ``CASE_FILE.0``, ``CASE_FILE.1``, ... (:func:`give`); a rank
waits for each part in turn, runs its cases, and stops after the part
that says no more follow.  It imports torch
and the port only (never JAX): the parent holds the reference's side
and compares.  Each rank runs on one intra-op thread, and its process
group times out after 60 s, so a lost rank fails the test instead of
hanging it.

    python tests/torch_dist_worker.py RANK WORLD RDV_FILE CASE_FILE OUT_DIR

:func:`launch` is the parent's side: it starts the ranks, waits for
them with a deadline, kills them when it passes, and returns each
rank's results.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import pytree
from repro_torch.configs import registry
from repro_torch.configs.base import Stage
from repro_torch.core.pipeline import quantize_params_data_free
from repro_torch.core.qlinear import (FIELDS, QLinear, QLinearGroup,
                                      QuantConfig)
from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
from repro_torch.distributed.compression import (CompressionConfig,
                                                 init_residual)
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding
from repro_torch.distributed.pipeline import pipeline_apply
from repro_torch.distributed.sharding import (distribute, distribute_tree,
                                              full, is_dtensor, like, local)
from repro_torch.launch import qdeclare, train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import common
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models import recurrent
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW, cosine_schedule


def qwen_cfg(n_layers: int = 3, **over):
    """Reduced qwen2.5-3b with one stage of ``n_layers`` dense layers."""
    cfg = registry.get("qwen2.5-3b").reduced()
    return dataclasses.replace(cfg, stages=(Stage(("dense",), n_layers),),
                               **over)


def arch_cfg(arch: str, **over):
    """The reduced config of ``arch``, its vocabulary at most 512 (as
    ``train.run --reduced`` makes it), with the fields ``over``."""
    cfg = registry.get(arch).reduced()
    return dataclasses.replace(cfg, vocab=min(cfg.vocab, 512), **over)


def case_cfg(case):
    """A case's config: the reduced ``arch`` with the case's ``over``
    fields, or reduced qwen2.5-3b with the case's overrides."""
    if "arch" in case:
        return arch_cfg(case["arch"], **case.get("over", {}))
    return qwen_cfg(**case["cfg"])


@contextlib.contextmanager
def rg_heads(n=None):
    """``models.recurrent.RG_HEADS`` set to ``n`` in the body (a module
    attribute, read at every call), or left as it is."""
    plain = recurrent.RG_HEADS
    if n is not None:
        recurrent.RG_HEADS = n
    try:
        yield
    finally:
        recurrent.RG_HEADS = plain


def case_batches(cfg, case):
    """The case's batches, each with its step's ``frames`` when the case
    carries them: an encoder-decoder model's, or a vision model's
    ``vision_embeds``."""
    data = batches(cfg.vocab, case["batch"], case["seq"], case["steps"] or 1)
    frames = case.get("frames")
    if frames is None:
        return data
    key = "vision_embeds" if cfg.frontend == "vision" else "frames"
    return [dict(b, **{key: f}) for b, f in zip(data, frames)]


@contextlib.contextmanager
def stream_log(record: dict):
    """In the body: the shape of the stream entering each block
    (``record["blocks"]``: ``transformer.block_full`` and
    ``block_prefill``, the remat recomputation included), and per
    superblock checkpoint the shapes of the tensors it saves for the
    backward pass (``record["saved"]``, through
    ``torch.autograd.graph.saved_tensors_hooks`` around the
    checkpoint: its inputs; what runs inside it saves to the
    checkpoint's own hooks)."""
    plain = {n: getattr(T, n) for n in ("block_full", "block_prefill",
                                        "checkpoint")}
    record.update(blocks=[], saved=[])

    def block(name):
        def run(cfg, kind, p, x, *a, **k):
            record["blocks"].append(tuple(x.shape))
            return plain[name](cfg, kind, p, x, *a, **k)
        return run

    def checkpoint(fn, *args, **kw):
        saved = []

        def pack(t):
            saved.append(tuple(t.shape))
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = plain["checkpoint"](fn, *args, **kw)
        record["saved"].append(saved)
        return out
    T.block_full, T.block_prefill = block("block_full"), block("block_prefill")
    T.checkpoint = checkpoint
    try:
        yield record
    finally:
        for n, f in plain.items():
            setattr(T, n, f)


@contextlib.contextmanager
def collective_log(record: list):
    """Append (op, shape) of every all-gather, reduce-scatter and
    all-reduce in the body to ``record``: the gathered output and the
    reduce-scattered input (each laid out with the gathered dim first,
    as ``distributed.collectives`` moves it), the all-reduced tensor."""
    plain = (collectives._gather_into, collectives._scatter_from,
             dist.all_reduce)

    def gather(out, inp, *a, **k):
        record.append(("all_gather", tuple(out.shape)))
        return plain[0](out, inp, *a, **k)

    def scatter(out, inp, *a, **k):
        record.append(("reduce_scatter", tuple(inp.shape)))
        return plain[1](out, inp, *a, **k)

    def all_reduce(t, *a, **k):
        record.append(("all_reduce", tuple(t.shape)))
        return plain[2](t, *a, **k)
    collectives._gather_into, collectives._scatter_from = gather, scatter
    dist.all_reduce = all_reduce
    try:
        yield record
    finally:
        collectives._gather_into, collectives._scatter_from = plain[:2]
        dist.all_reduce = plain[2]


@contextlib.contextmanager
def routes(record: list):
    """Append (keep, dest_e) of every ``layers.moe_dispatch`` call in the
    body to ``record``."""
    plain = layers.moe_dispatch

    def dispatch(cfg, router, xt):
        r = plain(cfg, router, xt)
        record.append((r["keep"].clone(), r["dest_e"].clone()))
        return r
    layers.moe_dispatch = dispatch
    try:
        yield
    finally:
        layers.moe_dispatch = plain


def batches(vocab: int, batch: int, seq: int, steps: int):
    corpus = SyntheticCorpus(CorpusConfig(vocab=vocab, seed=0))
    out = []
    for s in range(steps):
        tok, tgt = next(corpus.batches(batch, seq, 1, host=s,
                                       n_hosts=1 << 30))
        out.append({"tokens": torch.from_numpy(tok),
                    "targets": torch.from_numpy(tgt)})
    return out


def optimizer(steps: int, lr: float) -> AdamW:
    return AdamW(lr=lr, weight_decay=0.01, clip_norm=1.0,
                 schedule=cosine_schedule(warmup=1, total=steps))


def _state(params, opt, ccfg):
    return {"params": params, "opt": opt.init(params),
            "residual": (init_residual(params) if ccfg.kind is not None
                         else torch.zeros((), dtype=torch.float32))}


def _locals(tree):
    """Per leaf: (path, local part, placements as text) of a DTensor."""
    return [(k, local(t).clone(), str(t.placements))
            for k, t in pytree.leaves_with_path(tree) if is_dtensor(t)]


def train_case(case, rank):
    """The sharded step from the case's params on its mesh (EP with the
    case's ``ep``): per-step losses (``steps`` of them, possibly none),
    the gathered final params, every rank's local parts, the gathered
    and local gradients of the first step, and the MoE routing of its
    forward (``routes``).  ``sp`` (when the case gives it) sets
    ``Parallel.sp``; with ``record`` the first step's stream and
    checkpoint shapes (:func:`stream_log`) and the collectives of one
    forward without gradient (:func:`collective_log`) come back under
    ``layout``."""
    cfg = case_cfg(case)
    mesh = make_mesh(case["mesh"], ("data", "model"), "cpu")
    par, rules = train.parallel_for(mesh, case["mb"], True, 1024,
                                    case["fsdp"], case.get("ep", False))
    if "sp" in case:
        par = dataclasses.replace(par, sp=case["sp"])
    shards = train.make_shards(cfg, par, mesh, rules)
    ccfg = CompressionConfig(kind=case["kind"])
    opt = optimizer(max(case["steps"], 1), case["lr"])
    params = distribute_tree(case["params"], shards.specs, mesh)
    lp = pytree.tree_map(local, params)
    data = case_batches(cfg, case)
    rows = shards.rows(case["batch"])
    record, layout = [], {}
    first = {k: v[rows] for k, v in data[0].items()}
    with routes(record), (stream_log(layout) if case.get("record")
                          else contextlib.nullcontext()):
        loss0, grads = train._loss_and_grads(cfg, lp, first, 1024, True,
                                             shards)
    if case.get("record"):
        with torch.no_grad(), collective_log([]) as ops:
            M.forward_loss(cfg, lp, first, 1024, True, shards)
        layout["collectives"] = ops
    grads = pytree.tree_map(like, params, grads)
    out = {"loss0_share": float(loss0),
           "loss0": float(shards.data_sum(loss0)),
           "grads": pytree.tree_map(lambda t: full(t).clone(), grads),
           "grad_locals": _locals(grads), "routes": record,
           "layout": layout}
    step = train.make_train_step(cfg, opt, ccfg, case["mb"], True, 1024,
                                 shards)
    state = _state(params, opt, ccfg)
    losses = []
    for b in data[:case["steps"]]:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    out["losses"] = losses
    out["params"] = pytree.tree_map(lambda t: full(t).clone(),
                                    state["params"])
    out["locals"] = _locals(state["params"])
    out["coords"] = mesh.get_coordinate()
    return out


def ckpt_case(case, rank):
    """``train.run`` on a (2, 2) mesh writes a checkpoint; it is then
    restored into a state on a (1, 4) mesh and gathered."""
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    res = train.run(train.parse_args(case["argv"]), mesh=mesh)
    other = make_mesh((1, 4), ("data", "model"), "cpu")
    cfg = dataclasses.replace(registry.get("qwen2.5-3b").reduced(),
                              vocab=512)
    par, rules = train.parallel_for(other, 1, False, 1024, False)
    shards = train.make_shards(cfg, par, other, rules)
    ccfg = CompressionConfig(kind=None)
    state = train.init_sharded_state(cfg, optimizer(2, 3e-3), ccfg, shards)
    state, step = train.restore_state(case["dir"], state)
    return {"run": res, "step": step,
            "restored": [full(t).clone() for t in pytree.leaves(state)]}


def refusals(case, rank):
    """What a mesh run refuses, each as the exception's type name."""
    out = {}

    def catch(name, fn):
        try:
            fn()
            out[name] = None
        except Exception as e:                  # noqa: BLE001 (reported)
            out[name] = type(e).__name__
    catch("world", lambda: make_mesh((2, 1), ("data", "model"), "cpu"))
    catch("device", lambda: make_mesh((2, 2), ("data", "model"), "cuda"))
    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    par, rules = train.parallel_for(mesh)
    cfg = qwen_cfg(1)
    shards = train.make_shards(cfg, par, mesh, rules)
    packed = quantize_params_data_free(M.init_params(cfg),
                                       QuantConfig(ratio=0.25, multiple=16),
                                       min_dim=32)
    batch = batches(cfg.vocab, 2, 8, 1)[0]
    step = train.make_train_step(cfg, optimizer(1, 3e-3),
                                 CompressionConfig(kind=None), shards=shards)
    catch("packed", lambda: step({"params": packed, "opt": None,
                                  "residual": None}, batch))
    rg = registry.get("recurrentgemma-2b")
    catch("rg_heads", lambda: train.make_shards(rg, par, mesh, rules))
    odd = qwen_cfg(n_heads=6, n_kv_heads=2)
    catch("uneven", lambda: train.make_shards(odd, par, mesh, rules))
    ffn = qwen_cfg(d_ff=130)
    catch("d_ff", lambda: train.make_shards(ffn, par, mesh, rules))
    catch("device_arg", lambda: train.run(train.parse_args(
        ["--reduced", "--steps", "1", "--device", "cuda"]), mesh=mesh))
    return out


def hints(case, rank):
    """The reference's hints under ``use_mesh``: a DTensor takes the
    placements of the spec, a local tensor and one off the mesh stay
    as they are."""
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    x = distribute(case["x"], (None, None, None), mesh)
    out = {"off": common.hint(x, "data", None, None) is x}
    with common.use_mesh(mesh):
        h = common.hint_act(x, common.Parallel(tp=2, dp=2))
        out["act"] = (str(h.placements), tuple(h.to_local().shape))
        out["local"] = common.hint(case["x"], "data") is case["x"]
        out["batch_spec"] = common.batch_spec(None)
        out["full"] = torch.equal(h.full_tensor(), case["x"])
    return out


def pipeline_case(case, rank):
    """``pipeline_apply`` on a ("stage",) mesh of all ranks and on a
    ("stage", "data") mesh of two stages by two replicas."""
    def block(p, h):
        return torch.tanh(h @ p)
    out = {}
    for name, shape, axes in (("4", (4,), ("stage",)),
                              ("2x2", (2, 2), ("stage", "data"))):
        mesh = make_mesh(shape, axes, "cpu")
        w = case["w" + name]
        sharded = distribute(w, ("stage",) + (None,) * (w.ndim - 1), mesh)
        out[name] = pipeline_apply(block, sharded, case["x"], mesh)
        out[name + "_whole"] = pipeline_apply(block, w, case["x"], mesh)
    return out


def pack_tree(tree):
    """A tree with packed ``QLinear`` leaves and fused ``QLinearGroup``
    ones -> plain dicts, lists and tensors (the case file is loaded with
    ``weights_only``)."""
    if isinstance(tree, QLinear):
        return {"__qlinear__": [getattr(tree, f) for f in FIELDS],
                "ksn": [tree.k_s, tree.k, tree.n]}
    if isinstance(tree, QLinearGroup):
        return {"__group__": pack_tree(tree.inner),
                "splits": list(tree.splits)}
    if isinstance(tree, dict):
        return {k: pack_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(pack_tree(v) for v in tree)
    return tree


def unpack_tree(tree):
    if isinstance(tree, dict) and "__qlinear__" in tree:
        k_s, k, n = tree["ksn"]
        return QLinear(*tree["__qlinear__"], k_s=k_s, k=k, n=n)
    if isinstance(tree, dict) and "__group__" in tree:
        return QLinearGroup(unpack_tree(tree["__group__"]),
                            tuple(tree["splits"]))
    if isinstance(tree, dict):
        return {k: unpack_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(unpack_tree(v) for v in tree)
    return tree


def serve_cfg(over):
    """Reduced qwen2.5-3b (dense, GQA, tied) with the case's overrides
    (its own stages among them)."""
    cfg = registry.get("qwen2.5-3b").reduced()
    over = dict(over)
    n_layers = over.pop("n_layers", 2)
    return dataclasses.replace(cfg, stages=(Stage(("dense",), n_layers),),
                               **over)


@contextlib.contextmanager
def spec_perm_mutant():
    """A faulty row view: the rank gathers its channels by the spec's
    own chunk of ``perm`` (from its offset, as long as the view), not by
    the perm of the byte rows it holds."""
    plain = sharding.qlinear_local

    def mutant(q, spec, shards, heads=None):
        v = plain(q, spec, shards, heads)
        if sharding.qlinear_role(spec) != "row" or shards.tp == 1:
            return v
        whole = collectives.gather_chunks(local(q.perm), q.k,
                                          shards.group("model"))
        lo = sharding.chunk_range(q.k, shards.tp, shards.tp_rank)[0]
        idx = (torch.arange(v.k) + lo) % q.k
        return dataclasses.replace(v, perm=whole[idx].contiguous())
    sharding.qlinear_local = mutant
    try:
        yield
    finally:
        sharding.qlinear_local = plain


def clone_tree(tree):
    """A copy of a tree of tensors (the caches, which decode updates in
    place)."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree.clone()


def serve_tokens(cfg, params, batch, max_seq: int, steps: int,
                 attn_chunk: int, shards=None, keep_caches: bool = False):
    """Whole-prompt prefill of ``batch``, then ``steps`` greedy decode
    steps over the ring caches: the prefill's last logits and each
    step's logits (B, V) and tokens (B,); with ``keep_caches``, the
    caches after the prefill and after each step.  A batch with
    ``frames`` decodes with their length as ``enc_len``."""
    enc_len = batch["frames"].shape[1] if "frames" in batch else None
    with torch.no_grad():
        logits, caches = M.prefill(cfg, params, batch, max_seq, attn_chunk,
                                   shards=shards)
        out = {"prefill": logits[:, 0].clone(), "steps": [], "tokens": [],
               "caches": []}
        tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        pos = batch["positions"][:, -1] + 1
        for _ in range(steps):
            if keep_caches:
                out["caches"].append(clone_tree(caches))
            out["tokens"].append(tok.clone())
            logits, caches = M.decode_step(cfg, params, tok, pos, caches,
                                           max_seq, shards=shards,
                                           enc_len=enc_len)
            out["steps"].append(logits.clone())
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            pos = pos + 1
        if keep_caches:
            out["caches"].append(clone_tree(caches))
    return out


def serve_case(case, rank):
    """Sharded serving of the case's packed params on its mesh
    (``model.shard_for_serving`` under ``specs_for_tree(...,
    params=...)``): this data rank's rows through ``serve_tokens``, and
    each row-parallel view's (k_s, k) at layer 0."""
    cfg = serve_cfg(case["cfg"])
    params = unpack_tree(case["params"])
    mesh = make_mesh(case["mesh"], ("data", "model"), "cpu")
    par, rules = train.parallel_for(mesh)
    specs = sharding.specs_for_tree(M.declare_params(cfg, par), rules,
                                    params=params)
    with (spec_perm_mutant() if case.get("mutant")
          else contextlib.nullcontext()):
        shards, lp = M.shard_for_serving(cfg, par, params, specs, mesh)
    rows = shards.rows(case["tokens"].shape[0])
    batch = {"tokens": case["tokens"][rows],
             "positions": case["positions"][rows]}
    out = serve_tokens(cfg, lp, batch, case["max_seq"], case["steps"],
                       case["attn_chunk"], shards)
    blk = lp["stages"][0][0][0]
    out["views"] = {name: (w.k_s, w.k) for name, w in
                    (("wo", blk["attn"]["wo"]), ("wd", blk["mlp"]["wd"]))}
    out["rows"] = (rows.start, rows.stop)
    out["coords"] = mesh.get_coordinate()
    return out


def kind_cfg(case):
    """The reduced ``arch`` (vocabulary at most 512) with the case's
    ``over`` fields and ``stages``, a list of (pattern, repeats), when it
    gives them."""
    cfg = arch_cfg(case["arch"], **case.get("over", {}))
    if "stages" in case:
        cfg = dataclasses.replace(cfg, stages=tuple(
            Stage(tuple(pat), n) for pat, n in case["stages"]))
    return cfg


@contextlib.contextmanager
def whole_batch_moe():
    """A faulty MoE under a mesh: every data rank routes the whole batch
    (the rows of every data rank gathered) and keeps its own rows, in
    prefill too, where the reference routes each data rank's rows
    alone."""
    plain = layers.apply_moe

    def moe(cfg, p, x, shards=None):
        if shards is None or not shards.par.shard_batch:
            return plain(cfg, p, x, shards)
        rows = shards.rows(x.shape[0] * shards.dp)
        return layers._moe(cfg, p, shards.data_gather(x), shards)[rows]
    layers.apply_moe = moe
    try:
        yield
    finally:
        layers.apply_moe = plain


@contextlib.contextmanager
def encoder_output(record: list, given=None):
    """``model.encode`` in the body: each output appended to
    ``record``; with ``given`` (B, S_enc, D), that output returned in
    its place (the decoder run from a given encoder output)."""
    plain = M.encode

    def encode(cfg, params, frames, attn_chunk=1024, shards=None):
        if given is not None:
            b, s = given.shape[:2]
            return given, torch.arange(s, dtype=torch.int32).expand(b, s)
        out = plain(cfg, params, frames, attn_chunk, shards)
        record.append(out[0].clone())
        return out
    M.encode = encode
    try:
        yield record
    finally:
        M.encode = plain


@contextlib.contextmanager
def even_group_mutant():
    """A faulty fused view: each rank takes an even cut of the fused
    group's N (rank 0 the first N / tp columns, all of them wq's), not
    its members' columns, under the true view's splits."""
    plain = sharding.group_local

    def mutant(g, specs, shards, heads=None, names=()):
        view = plain(g, specs, shards, heads, names)
        whole = QLinearGroup.fuse([m.map(full) for m in g.members]).inner
        lo, hi = sharding.chunk_range(whole.n, shards.tp, shards.tp_rank)
        cut = lambda t: t[..., lo:hi].contiguous()  # noqa: E731
        return QLinearGroup(dataclasses.replace(
            whole, w4=cut(whole.w4), bits=cut(whole.bits),
            alpha_s=cut(whole.alpha_s), alpha_r1=cut(whole.alpha_r1),
            n=hi - lo), view.splits)
    sharding.group_local = mutant
    try:
        yield
    finally:
        sharding.group_local = plain


def group_bytes(fused, unfused, whole, shards, n_heads: int) -> list:
    """(path, equal) of every fused group view of a rank's tree
    ``fused``: its bytes and scales against the views of its members in
    the same rank's tree of the unfused leaves ``unfused``, those of
    ``w4``, ``bits``, ``alpha_s`` and ``alpha_r1`` concatenated along N,
    the shared vectors the first member's, and the splits the members'
    widths; and against ``sharding.group_view`` of the whole group in
    ``whole`` (``n_heads`` the query member's heads)."""
    out = []

    def same(a, b):
        return a.splits == b.splits and all(
            torch.equal(getattr(a.inner, x), getattr(b.inner, x))
            for x in FIELDS)

    def walk(f, u, w, path):
        if isinstance(f, dict):
            for k, v in f.items():
                if isinstance(v, QLinearGroup):
                    names = sharding.GROUP_MEMBERS[k]
                    view = sharding.group_view(
                        w[k], shards.tp_rank, shards.tp,
                        (n_heads,) if k == "wqkv" else ())
                    out.append((f"{path}/{k}", same(QLinearGroup.fuse(
                        [u[n] for n in names]), v) and same(view, v)))
                else:
                    walk(v, u[k], w[k], f"{path}/{k}")
        elif isinstance(f, (list, tuple)):
            for i, (a, b, c) in enumerate(zip(f, u, w)):
                walk(a, b, c, f"{path}/{i}")
    walk(fused, unfused, whole, "")
    return out


def packed_widths(tree, path: str = "") -> list:
    """(path, n, k) of every packed leaf of a rank's tree, and of every
    member (``path:i``) of a packed fused group: the widths of its
    views."""
    if isinstance(tree, QLinear):
        return [(path, tree.n, tree.k)]
    if isinstance(tree, QLinearGroup) and isinstance(tree.inner, QLinear):
        return [(f"{path}:{i}", m.n, m.k)
                for i, m in enumerate(tree.members())]
    if isinstance(tree, dict):
        return [w for k, v in tree.items()
                for w in packed_widths(v, f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [w for i, v in enumerate(tree)
                for w in packed_widths(v, f"{path}/{i}")]
    return []


def serve_kinds_case(case, rank):
    """Sharded serving of the case's params (any kind) on its mesh:
    packed ones placed by ``launch.qdeclare.declare_quantized``'s specs,
    f32 ones (``packed`` False) by ``specs_for_tree``'s (EP with the
    case's ``ep``; the batch over data unless ``shard_batch`` is off).
    This data rank's rows (every row with ``shard_batch`` off) through
    ``serve_tokens``, with its caches after the prefill and after each
    step and an encoder-decoder model's encoder output (``enc_out``);
    given the case's ``enc_out``, the same again with the decoder run
    from it (``fixed``); the widths of its packed views
    (:func:`packed_widths`); with ``group_bytes``, its fused views held
    against its views of the unfused members (:func:`group_bytes`).
    ``mutant``: True for :func:`whole_batch_moe`, "even_group" for
    :func:`even_group_mutant`.
    ``sp`` (when the case gives it) sets ``Parallel.sp``; with
    ``record`` the shapes of the stream entering each block of the
    prefill come back under ``layout`` (:func:`stream_log`); the
    batch carries the case's ``frames`` or ``vision_embeds``."""
    cfg = kind_cfg(case)
    params = unpack_tree(case["params"])
    mesh = make_mesh(case["mesh"], ("data", "model"), "cpu")
    par, _ = train.parallel_for(mesh)
    par = dataclasses.replace(par, shard_batch=case["shard_batch"],
                              sp=case.get("sp", par.sp))
    rules = sharding.rules_for_mesh(mesh, ep=case["ep"])
    if case.get("packed", True):
        _, specs = qdeclare.declare_quantized(
            cfg, par, QuantConfig(**case["qcfg"]), rules,
            min_dim=case["min_dim"])
    else:
        specs = sharding.specs_for_tree(M.declare_params(cfg, par), rules)
    with (even_group_mutant() if case.get("mutant") == "even_group"
          else contextlib.nullcontext()):
        shards, lp = M.shard_for_serving(cfg, par, params, specs, mesh)
    rows = shards.rows(case["tokens"].shape[0])
    batch = {k: case[k][rows] for k in ("tokens", "positions", "frames",
                                        "vision_embeds") if k in case}
    args = (cfg, lp, batch, case["max_seq"], case["steps"],
            case["attn_chunk"], shards)
    layout = {}
    with (whole_batch_moe() if case.get("mutant") is True
          else contextlib.nullcontext()), encoder_output([]) as enc, \
            (stream_log(layout) if case.get("record")
             else contextlib.nullcontext()):
        out = serve_tokens(*args, keep_caches=True)
    out["layout"] = layout
    if enc:
        out["enc_out"] = enc[0]
    if "enc_out" in case:
        with encoder_output([], case["enc_out"][rows]):
            out["fixed"] = serve_tokens(*args)
    out["widths"] = packed_widths(lp)
    if case.get("group_bytes"):
        _, members = M.shard_for_serving(
            cfg, par, T.unfuse_params_for_oracle(params), specs, mesh)
        out["group_bytes"] = group_bytes(lp, members, params, shards,
                                         cfg.n_heads)
    out["rows"] = (rows.start, rows.stop)
    out["coords"] = mesh.get_coordinate()
    return out


TASKS = {"train": train_case, "ckpt": ckpt_case, "refusals": refusals,
         "hints": hints, "pipeline": pipeline_case, "serve": serve_case,
         "serve_kinds": serve_kinds_case}


def main(argv) -> int:
    rank, world, rdv, case_file, out_dir = (int(argv[0]), int(argv[1]),
                                            argv[2], argv[3], argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        results, more, k = {}, True, 0
        while more:            # the parts of the cases, in order (give)
            part = f"{case_file}.{k}"
            while not os.path.exists(part):
                time.sleep(0.02)
            given = torch.load(part, weights_only=True)
            cases, more, k = given["cases"], given["more"], k + 1
            for name, case in cases.items():
                with rg_heads(case.get("rg_heads")):
                    results[name] = TASKS[case["task"]](case, rank)
                dist.barrier()
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()
    return 0


def launch(cases: dict, tmp: Path, world: int = 4,
           deadline_s: float = 240.0) -> list:
    """Run ``cases`` ({name: case}) on ``world`` ranks of this script;
    returns each rank's {name: result}.  Every rank's output goes to
    ``tmp / rank<r>.log``; past the deadline the ranks are killed and
    the call fails with the logs' ends."""
    return finish(start(cases, tmp, world), deadline_s)


def start(cases: Optional[dict], tmp: Path, world: int = 4) -> tuple:
    """Start :func:`launch`'s ranks and return at once; :func:`finish`
    waits for them.  With ``cases`` None the ranks start (import, join
    the process group) and wait for :func:`give` to hand them the
    cases."""
    tmp = Path(tmp)
    case_file, out = tmp / "cases.pt", tmp / "out"
    out.mkdir()
    handle = [], [], tmp, out
    if cases is not None:
        give(handle, cases)
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(world)]
    handle[0].extend(subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(tmp / "rdv"),
         str(case_file), str(out)], stdout=logs[r],
        stderr=subprocess.STDOUT, env=env) for r in range(world))
    handle[1].extend(logs)
    return handle


def give(handle, cases: dict, more: bool = False) -> None:
    """Hand ``cases`` to the ranks of :func:`start`, which run them
    after those given before; with ``more`` they then wait for the next
    part.  A part's file appears whole (written aside, then renamed)."""
    tmp = handle[2]
    k = sum(1 for _ in tmp.glob("cases.pt.[0-9]*"))
    torch.save({"cases": cases, "more": more}, tmp / "cases.pt.next")
    os.replace(tmp / "cases.pt.next", tmp / f"cases.pt.{k}")


def finish(handle, deadline_s: float = 240.0) -> list:
    """Wait for the ranks of :func:`start` until ``deadline_s`` from
    now, kill them past it, and return each rank's {name: result} or
    fail with the logs' ends."""
    procs, logs, tmp, out = handle
    end = time.monotonic() + deadline_s
    late = False
    try:
        for p in procs:
            p.wait(timeout=max(0.1, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        late = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if late or any(p.returncode for p in procs):
        tails = "\n".join(f"--- rank {r} (rc {p.returncode}) ---\n"
                          + (tmp / f"rank{r}.log").read_text()[-3000:]
                          for r, p in enumerate(procs))
        raise AssertionError(("deadline of %.0f s passed\n" % deadline_s
                              if late else "a rank failed\n") + tails)
    return [torch.load(out / f"rank{r}.pt", weights_only=True)
            for r in range(len(procs))]


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
