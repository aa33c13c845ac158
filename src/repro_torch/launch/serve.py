"""Serving launcher of the port: quantize a model with PTQ1.61 and serve
a stream of requests through the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-7b \\
        --quantize datafree --fused
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-7b \\
        --quantize calibrated --paged --chunked-prefill
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch granite-moe-1b-a400m --fused --paged --chunked-prefill
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-2b --quantize datafree --fused --paged
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch xlstm-1.3b --quantize datafree --fused --paged
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch llava-next-34b --fused --paged --chunked-prefill

``--quantize datafree`` ranks channels by |w| with analytic scales;
``--quantize calibrated`` runs the paper's method on
``--calib-segments`` synthetic segments of ``--calib-seq`` tokens
(activation-driven mask, ``--opt-steps`` epochs of block-wise scale
learning) and serves one unfused packed projection per weight;
``--fused`` is ignored for it, as in ``repro.launch.serve``.  Dense, MoE,
hybrid and xLSTM architectures are served (granite-moe-1b-a400m: the
experts' gate and up projections fuse like the MLP's; recurrentgemma-2b:
RG-LRU and windowed local blocks; xlstm-1.3b: mLSTM and sLSTM blocks,
whose projections ``--fused`` leaves unfused, as the reference does).
Models with recurrent blocks take whole-prompt prefill only, so
``--chunked-prefill`` raises the reference's ``ValueError`` for them.
llava-next-34b is served on text prompts alone, as the reference
serves it (no request carries vision embeddings); an encoder-decoder
model (seamless-m4t-medium) raises ``NotImplementedError`` before its
weights are built, as the engine refuses it.

By default, as in ``repro.launch.serve``, requests are served from the
contiguous ring caches with whole-prompt prefill, prompts left-padded to
the buckets ``(max_seq // 8, max_seq // 2)``.  ``--paged`` serves from
the shared page pool (``--page-size`` tokens a page, ``--pool-pages`` in
all); ``--chunked-prefill`` (paged only) advances prefills
``--prefill-chunk`` tokens per tick, interleaved with decode.

Event-loop options (the engine's typed event API):

* ``--stream`` prints every token the tick it is emitted;
* ``--cancel-after-s N`` cancels the longest-running in-flight request
  once N seconds of serving have passed; the JSON output records the
  cancelled rids and the pages each cancellation freed;
* ``--priority a,b,c`` cycles the listed priority classes over the
  requests (realtime / standard / batch); per-class TTFT and TBT land in
  the engine metrics;
* ``--deadline-s`` sets each request's admission deadline;
* ``--share-prefix`` (paged only) turns on copy-on-write prefix sharing
  and gives every request a common page-aligned document prefix of
  ``(max_seq // 8) // page_size * page_size`` tokens before its own
  tail, so the common pages are allocated once; ``--prefix-retain N``
  keeps up to N freed prefix pages for later same-prefix requests.  The
  JSON output carries the prefix-cache counters (``prefix_sharing``).

Runs on the GPU (``--device cuda``, the default) and raises when CUDA is
absent; ``--device cpu`` runs the same path with the kernels' plain
PyTorch versions.  There is no kernel switch: on the card every packed
projection, paged decode attention and prefill chunk goes through its
CUDA kernel.

The JSON output carries the same engine metrics as ``repro.launch.serve``
(tokens/s, TTFT, TBT p50/p95 overall and per class, queue depth, page
utilization, per-phase step times).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.bits import model_bits
from repro_torch.core.pipeline import (quantize_model_ptq161,
                                       quantize_params_data_free)
from repro_torch.core.qlinear import QuantConfig
from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
from repro_torch.models import model as M
from repro_torch.runtime.engine import Engine, refuse_enc_dec, resolve_device
from repro_torch.runtime.events import FinishEvent, TokenEvent


def _drive(engine: Engine, *, stream: bool, cancel_after_s=None):
    """Event-API consumer over ``Engine.run(on_tick=...)``: drain the
    queue after every tick, print tokens when streaming, and fire the
    cancellation once its time has come.  Returns the cancellation
    receipts."""
    q = engine.event_queue()
    cancelled = []
    state = {"did_cancel": False, "t0": time.time()}

    def after_tick():
        if cancel_after_s is not None and not state["did_cancel"] and \
                time.time() - state["t0"] >= cancel_after_s:
            active = engine.running()
            if active:
                # longest-running = earliest submitted still in a slot
                _, victim = min(active, key=lambda sr: sr[1].rid)
                engine.cancel(victim.rid)
                state["did_cancel"] = True
        while q:
            ev = q.popleft()
            if isinstance(ev, TokenEvent) and stream:
                print(f"[stream] rid={ev.rid} idx={ev.index} "
                      f"tok={ev.token}", flush=True)
            elif isinstance(ev, FinishEvent) and ev.reason == "cancelled":
                cancelled.append({"rid": ev.rid, "tick": ev.tick,
                                  "tokens_before_cancel": ev.n_tokens,
                                  "freed_pages": ev.freed_pages})
                if stream:
                    print(f"[cancel] rid={ev.rid} freed_pages="
                          f"{ev.freed_pages}", flush=True)

    engine.run(on_tick=after_tick)
    after_tick()        # events of the final tick's teardown
    return cancelled


def run(args) -> dict:
    if args.share_prefix and not args.paged:
        raise SystemExit("--share-prefix requires --paged "
                         "(sharing lives in the page allocator)")
    if args.chunked_prefill and not args.paged:
        raise SystemExit("--chunked-prefill requires --paged "
                         "(chunks scatter into pool pages)")
    if args.prefix_retain and not args.share_prefix:
        raise SystemExit("--prefix-retain requires --share-prefix "
                         "(retention extends the prefix cache)")
    classes = [c.strip() for c in args.priority.split(",") if c.strip()]
    if not classes:
        raise SystemExit("--priority needs at least one class name "
                         "(e.g. --priority realtime,batch)")
    device = resolve_device(args.device)
    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    refuse_enc_dec(cfg)
    params = M.init_params(cfg, args.seed, device)
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=args.seed))

    qcfg = QuantConfig(ratio=args.ratio, multiple=args.multiple,
                       steps=args.opt_steps)
    t0 = time.time()
    if args.quantize == "none":
        qparams = params
    elif args.quantize == "calibrated":
        if args.fused:
            print("[warn] --fused ignored for calibrated quantization "
                  "(per-projection QLinears cannot be fused post-hoc)")
        calib = [{"tokens": torch.from_numpy(t).to(device)} for t, _ in
                 corpus.batches(1, args.calib_seq, args.calib_segments,
                                split="calib")]
        qparams = quantize_model_ptq161(cfg, params, calib, qcfg,
                                        min_dim=args.min_dim,
                                        attn_chunk=args.attn_chunk)
        del params
    else:
        qparams = quantize_params_data_free(params, qcfg,
                                            min_dim=args.min_dim,
                                            fuse=args.fused)
        del params
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_quant = time.time() - t0
    bits = None
    if args.quantize != "none":
        rep = model_bits(qparams)
        bits = rep["avg_bits_per_quantized_weight"]
        print(f"[quant] {args.quantize} in {t_quant:.1f}s — {bits:.3f} "
              f"bits/weight over {rep['quantized_weights']:,} weights")

    engine = Engine(cfg, qparams, n_slots=args.slots, max_seq=args.max_seq,
                    prefill_buckets=(args.max_seq // 8, args.max_seq // 2),
                    seed=args.seed, paged=args.paged,
                    page_size=args.page_size, pool_pages=args.pool_pages,
                    prefix_sharing=args.share_prefix,
                    prefix_retain_pages=args.prefix_retain,
                    chunked_prefill=args.chunked_prefill,
                    prefill_chunk=args.prefill_chunk,
                    fuse_projections=args.fused and args.quantize == "none",
                    attn_chunk=args.attn_chunk, device=device)
    for c in classes:
        if not engine.scheduler.has_class(c):
            raise SystemExit(f"unknown priority class {c!r}; configured: "
                             f"{sorted(engine.scheduler.cfg.class_weights)}")
    rng = np.random.default_rng(args.seed)
    # --share-prefix: a page-aligned common document prefix before each
    # request's own tail, the sharing workload of repro.launch.serve
    common = np.zeros((0,), np.int32)
    if args.share_prefix:
        common_len = (args.max_seq // 8) // args.page_size * args.page_size
        common = corpus.document(9_999, max(common_len, args.page_size))
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(4, args.max_seq // 4))
        tail = corpus.document(10_000 + i, plen)
        reqs.append(engine.submit(np.concatenate([common, tail]),
                                  max_new=args.max_new,
                                  temperature=args.temperature,
                                  deadline_s=args.deadline_s,
                                  priority=classes[i % len(classes)]))
    t0 = time.time()
    if args.stream or args.cancel_after_s is not None:
        cancelled = _drive(engine, stream=args.stream,
                           cancel_after_s=args.cancel_after_s)
    else:
        engine.run()
        cancelled = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    toks = sum(len(r.out_tokens) for r in reqs)
    out = {
        "requests": len(reqs),
        "generated_tokens": toks,
        "wall_s": dt,
        "tokens_per_s": toks / max(dt, 1e-9),
        "all_done": all(r.done for r in reqs),
        "cancelled": cancelled,
        "priority_classes": classes,
        "quantize_mode": args.quantize,
        "quantize_s": t_quant,
        "bits_per_weight": bits,
        "cache_backend": engine.backend.name,
        "device": str(device),
        "prefix_sharing": engine.prefix_stats(),
        "engine_metrics": engine.metrics.snapshot(),
    }
    print(json.dumps(out, indent=2))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=2)
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="repro_torch serving launcher")
    p.add_argument("--arch", default="tiny-lm")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--quantize", default="datafree",
                   choices=["none", "datafree", "calibrated"])
    p.add_argument("--fused", action="store_true",
                   help="N-fuse QKV / gate+up projections: fused packed "
                        "layouts for data-free quantization, fp concat "
                        "fusion for --quantize none (ignored for "
                        "calibrated)")
    p.add_argument("--ratio", type=float, default=0.2,
                   help="salient input-channel fraction")
    p.add_argument("--multiple", type=int, default=16,
                   help="salient channel count rounding")
    p.add_argument("--min-dim", type=int, default=32,
                   help="smallest input dim that is quantized")
    p.add_argument("--opt-steps", type=int, default=3,
                   help="block-wise scale learning epochs (calibrated)")
    p.add_argument("--calib-segments", type=int, default=4)
    p.add_argument("--calib-seq", type=int, default=64)
    p.add_argument("--attn-chunk", type=int, default=1024,
                   help="key chunk of whole-sequence attention (the "
                        "calibration forward, whole-prompt prefill)")
    p.add_argument("--paged", action="store_true",
                   help="paged KV cache (block tables + shared page pool)")
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--pool-pages", type=int, default=None,
                   help="total pages in the pool (default: slots * "
                        "max_seq / page size)")
    p.add_argument("--chunked-prefill", action="store_true",
                   help="advance prefills a chunk per tick, interleaved "
                        "with decode (paged mode only)")
    p.add_argument("--prefill-chunk", type=int, default=64,
                   help="prompt tokens per chunk (multiple of --page-size)")
    p.add_argument("--share-prefix", action="store_true",
                   help="copy-on-write prefix sharing and a common page-"
                        "aligned prompt prefix across requests (paged "
                        "mode only)")
    p.add_argument("--prefix-retain", type=int, default=0,
                   help="keep up to N freed prefix pages in an LRU so "
                        "later same-prefix requests still hit (needs "
                        "--share-prefix)")
    p.add_argument("--stream", action="store_true",
                   help="print every token the tick it is emitted")
    p.add_argument("--cancel-after-s", type=float, default=None,
                   help="after N seconds of serving, cancel the longest-"
                        "running in-flight request")
    p.add_argument("--priority", default="standard",
                   help="comma list of priority classes cycled across "
                        "requests (realtime/standard/batch)")
    p.add_argument("--deadline-s", type=float, default=None,
                   help="per-request admission deadline in seconds")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-seq", type=int, default=128)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json-out", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


if __name__ == "__main__":
    run(parse_args())
