"""Serving launcher of the port: quantize a model with data-free PTQ1.61
and serve a stream of requests through the paged, chunked-prefill
engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-7b \\
        --quantize datafree --fused --paged --chunked-prefill

Runs on the GPU (``--device cuda``, the default) and raises when CUDA is
absent; ``--device cpu`` runs the same path with the kernels' plain
PyTorch versions.  There is no kernel switch: on the card every packed
projection, decode attention and prefill chunk goes through its CUDA
kernel.  ``--paged`` and ``--chunked-prefill`` are required: the port
has no contiguous backend and no whole-prompt prefill yet.

The JSON output carries the same engine metrics as ``repro.launch.serve``
(tokens/s, TTFT, TBT p50/p95, queue depth, page utilization, per-phase
step times).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.bits import model_bits
from repro_torch.core.pipeline import quantize_params_data_free
from repro_torch.core.qlinear import QuantConfig
from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
from repro_torch.models import model as M
from repro_torch.runtime.engine import Engine, resolve_device


def run(args) -> dict:
    if not (args.paged and args.chunked_prefill):
        raise SystemExit("repro_torch serves with --paged --chunked-prefill "
                         "only: the contiguous backend and whole-prompt "
                         "prefill are not ported yet")
    device = resolve_device(args.device)
    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = M.init_params(cfg, args.seed, device)
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=args.seed))

    t0 = time.time()
    if args.quantize == "none":
        qparams = params
    else:
        qparams = quantize_params_data_free(
            params, QuantConfig(ratio=0.2, multiple=16), min_dim=32,
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
                    seed=args.seed, page_size=args.page_size,
                    pool_pages=args.pool_pages,
                    prefill_chunk=args.prefill_chunk,
                    fuse_projections=args.fused and args.quantize == "none",
                    device=device)
    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(4, args.max_seq // 4))
        reqs.append(engine.submit(corpus.document(10_000 + i, plen),
                                  max_new=args.max_new,
                                  temperature=args.temperature))
    t0 = time.time()
    engine.run()
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
        "quantize_mode": args.quantize,
        "quantize_s": t_quant,
        "bits_per_weight": bits,
        "cache_backend": engine.backend.name,
        "device": str(device),
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
                   choices=["none", "datafree"])
    p.add_argument("--fused", action="store_true",
                   help="N-fuse QKV / gate+up projections: fused packed "
                        "layouts for data-free quantization, fp concat "
                        "fusion for --quantize none")
    p.add_argument("--paged", action="store_true",
                   help="paged KV cache (required)")
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--pool-pages", type=int, default=None,
                   help="total pages in the pool (default: slots * "
                        "max_seq / page size)")
    p.add_argument("--chunked-prefill", action="store_true",
                   help="advance prefills a chunk per tick (required)")
    p.add_argument("--prefill-chunk", type=int, default=64,
                   help="prompt tokens per chunk (multiple of --page-size)")
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
