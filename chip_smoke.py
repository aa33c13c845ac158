#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py            # what the check runs: needs one card

Phases, each of which raises on failure:

1. print the card's name and power limit (``nvidia-smi``);
2. build the three CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) and print the build seconds;
3. hold each kernel against its plain PyTorch version on the card at
   LLaMA-7B shapes, with the tolerances stated below, and time it beside
   its plain version, a yardstick PyTorch call and its bound;
4. agreement on a small input: the reduced LLaMA config served on the
   card (kernels) and on the CPU (plain versions) from the same weights
   gives the same logits within tolerance;
5. the main path: LLaMA-7B at full width and full depth (32 layers),
   data-free PTQ1.61 with fused QKV / gate+up, served through the paged
   chunked-prefill engine; every request must finish and every kernel's
   launch count in that run must be above zero;
6. print the ``kernels`` JSON line, then the result line.

It exits non-zero without CUDA, and when run outside a checkout of the
repository.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Data-sheet peaks (dense, no sparsity) by card; the SXM part is the
# default.  (bytes/s, bf16 FLOP/s)
PEAKS = {"H100 PCIe": (2.0e12, 756e12), "H100 NVL": (3.9e12, 835e12),
         "H100": (3.35e12, 989e12)}

# Tolerances, kernel against plain version on the same inputs:
#  * mixed_matmul: both round the operands the same way and accumulate
#    in f32; the kernel rounds its output once to bf16 (at most 2^-9
#    relative), so rtol 2^-7 with atol 1e-3 leaves 4x margin while a
#    single wrong packed bit or nibble (about 2|x_k w_k|) shows.
#  * attention kernels: the kernel rounds unnormalised online-softmax
#    probabilities to bf16 per key tile, the plain version rounds the
#    normalised weights once; both errors are about 2^-9 of |v|.
MM_RTOL, MM_ATOL = 2.0 ** -7, 1e-3
ATT_RTOL, ATT_ATOL = 1e-2, 1e-2
# small-input agreement, card (kernels) against CPU (plain), f32 model:
# logits within 1e-2 of the reference's largest magnitude
REF_RTOL = 1e-2


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def peaks_for(name: str):
    for key in ("H100 PCIe", "H100 NVL", "H100"):
        if key in name:
            return key, PEAKS[key]
    return "H100", PEAKS["H100"]


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------
class Timer:
    """Per-launch CUDA-event timing with the L2 cache flushed before
    each launch (the main path finds its weights and pages cold)."""

    def __init__(self, torch, iters: int = 20):
        self.torch = torch
        self.iters = iters
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        total = 0.0
        for _ in range(self.iters):
            self.flush.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            total += e0.elapsed_time(e1)
        return total / self.iters


def bound_ms(nbytes: float, flops: float, peaks):
    bw, fl = peaks
    t_bytes, t_ops = nbytes / bw, flops / fl
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions at LLaMA-7B shapes
# ---------------------------------------------------------------------------
def check_mixed_matmul(torch, cfg, timer, peaks, gen):
    from repro_torch.core.qlinear import (QuantConfig, quantize_linear,
                                          quantize_linear_group)
    from repro_torch.kernels import ref
    from repro_torch.kernels.mixed_matmul import mixed_matmul
    qcfg = QuantConfig(ratio=0.2, multiple=16)
    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.n_heads * cfg.head_dim_
    kvd = cfg.n_kv_heads * cfg.head_dim_

    def w(k, n):
        return (torch.randn((k, n), generator=gen, device="cuda")
                / math.sqrt(k)).to(torch.bfloat16)

    projs = {
        "wqkv": quantize_linear_group([w(d, hd), w(d, kvd), w(d, kvd)],
                                      None, qcfg).inner,
        "wgu": quantize_linear_group([w(d, f), w(d, f)], None, qcfg).inner,
        "wo": quantize_linear(w(hd, d), None, qcfg),
        "wd": quantize_linear(w(f, d), None, qcfg),
    }
    rows = []
    for m in (1, 8, 64):
        for name, q in projs.items():
            x = torch.randn((m, q.k), generator=gen, device="cuda").to(
                torch.bfloat16)
            args = (x, q.w4, q.s4, q.z4, q.bits, q.alpha_s, q.alpha_r1,
                    q.alpha_r2)
            y = mixed_matmul(*args, perm=q.perm)
            y_ref = ref.mixed_matmul_ref(*args, perm=q.perm)
            torch.cuda.synchronize()
            err = (y.float() - y_ref).abs().max().item()
            ok = torch.allclose(y.float(), y_ref, rtol=MM_RTOL, atol=MM_ATOL)
            row = {"proj": name, "M": m, "K": q.k, "N": q.n, "k_s": q.k_s,
                   "max_abs_err": err, "ok": bool(ok)}
            if not ok:
                _fail(f"mixed_matmul {row}")
            dense = q.to_dense(torch.bfloat16)
            nbytes = (x.numel() * 2 + q.perm.numel() * 4
                      + q.w4.numel() + q.bits.numel()
                      + (q.s4.numel() + q.z4.numel()) * 4
                      + (q.alpha_s.numel() + q.alpha_r1.numel()
                         + q.alpha_r2.numel()) * 4 + m * q.n * 2)
            b, by = bound_ms(nbytes, 2.0 * m * q.k * q.n, peaks)
            row.update(
                ms=timer.ms(lambda: mixed_matmul(*args, perm=q.perm)),
                plain_ms=timer.ms(
                    lambda: ref.mixed_matmul_ref(*args, perm=q.perm)),
                library_ms=timer.ms(lambda: torch.matmul(x, dense)),
                bound_ms=b, bound_by=by, bytes=nbytes)
            del dense
            rows.append(row)
    return rows


def _paged_case(torch, gen, b, hkv, rep, dh, ps, lens, dtype):
    """Random pools and block tables for ragged ``lens``: each row's
    pages are distinct pool pages."""
    nblk = max(-(-n // ps) for n in lens) + 1
    need = sum(-(-n // ps) for n in lens)
    pages = torch.randperm(need + 4, generator=gen, device="cuda")
    bt = torch.full((b, nblk), -1, dtype=torch.int32, device="cuda")
    used = 0
    for i, n in enumerate(lens):
        k = -(-n // ps)
        bt[i, :k] = pages[used:used + k].to(torch.int32)
        used += k
    pool_pages = need + 5
    shape = (pool_pages, ps, hkv, dh)
    kp = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q = (3.0 * torch.randn((b, hkv * rep, dh), generator=gen,
                           device="cuda")).to(dtype)
    return q, kp, vp, bt


def check_paged_attention(torch, cfg, timer, peaks, gen):
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention
    b, ps, dh = 8, 16, cfg.head_dim_
    hkv, rep = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    lens = [1000, 777, 513, 300, 129, 64, 17, 0]
    q, kp, vp, bt = _paged_case(torch, gen, b, hkv, rep, dh, ps, lens,
                                torch.bfloat16)
    bt[0, 20] = -1                                  # freed page mid-table
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    o = paged_attention(q, kp, vp, bt, lens_t)
    o_ref = ref.paged_attention_ref(q, kp, vp, bt, lens_t)
    torch.cuda.synchronize()
    err = (o - o_ref).abs().max().item()
    if not torch.allclose(o, o_ref, rtol=ATT_RTOL, atol=ATT_ATOL):
        _fail(f"paged_attention max_abs_err={err}")
    if o[7].abs().max().item() != 0.0:
        _fail("paged_attention: a row of length 0 must be zeros")
    live = sum(n for n in lens) - ps            # minus the freed page
    hq = hkv * rep
    nbytes = (q.numel() * 2 + live * hkv * dh * 2 * 2 + bt.numel() * 4
              + b * 4 + b * hq * dh * 4)
    bnd, by = bound_ms(nbytes, 4.0 * hq * dh * live, peaks)
    # yardstick: SDPA over the gathered context (gather not timed)
    s = bt.shape[1] * ps
    kc = kp[bt.clamp_min(0).long()].reshape(b, s, hkv, dh).transpose(1, 2)
    vc = vp[bt.clamp_min(0).long()].reshape(b, s, hkv, dh).transpose(1, 2)
    pos = torch.arange(s, device="cuda")
    mask = (pos[None, :] < lens_t[:, None]) & (
        bt >= 0).repeat_interleave(ps, dim=1)
    mask[7, 0] = True                               # SDPA needs a key
    qs = q.reshape(b, hq, 1, dh)
    return {"B": b, "hq": hq, "hkv": hkv, "dh": dh, "ps": ps,
            "lens": lens, "max_abs_err": err,
            "ms": timer.ms(lambda: paged_attention(q, kp, vp, bt, lens_t)),
            "plain_ms": timer.ms(
                lambda: ref.paged_attention_ref(q, kp, vp, bt, lens_t)),
            "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                qs, kc, vc, attn_mask=mask[:, None, None, :],
                enable_gqa=rep > 1)),
            "bound_ms": bnd, "bound_by": by, "bytes": nbytes}


def check_paged_prefill(torch, cfg, timer, peaks, gen):
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_prefill import paged_prefill
    c, ps, dh = 64, 16, cfg.head_dim_
    hkv, rep = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    hq = hkv * rep
    nlayers, nblk, pool_pages = 2, 32, 40
    results = []
    # (start, length, masked chunk page): a context over 12 pages with a
    # full chunk whose second page is shared (writable row -1), and a
    # ragged final chunk over 16 context pages
    for start, length, masked in ((192, 64, 1), (256, 37, None)):
        shape = (nlayers, pool_pages + 1, ps, hkv, dh)
        kp = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        vp = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        n_pages = -(-(start + length) // ps)
        bt = torch.full((nblk,), -1, dtype=torch.int32, device="cuda")
        bt[:n_pages] = torch.randperm(pool_pages, generator=gen,
                                      device="cuda")[:n_pages].to(torch.int32)
        btw = bt.clone()
        if masked is not None:
            btw[start // ps + masked] = -1
        q = (3.0 * torch.randn((c, hq, dh), generator=gen,
                               device="cuda")).to(torch.bfloat16)
        kn = torch.randn((c, hkv, dh), generator=gen, device="cuda").to(
            torch.bfloat16)
        vn = torch.randn((c, hkv, dh), generator=gen, device="cuda").to(
            torch.bfloat16)
        kk, vk = kp.clone(), vp.clone()
        kr, vr = kp.clone(), vp.clone()
        o = paged_prefill(q, kn, vn, kk, vk, bt, btw, start, length, layer=1)
        o_ref = ref.paged_prefill_ref(q, kn, vn, kr, vr, bt, btw, start,
                                      length, layer=1)
        torch.cuda.synchronize()
        err = (o[:length] - o_ref[:length]).abs().max().item()
        if not torch.allclose(o[:length], o_ref[:length], rtol=ATT_RTOL,
                              atol=ATT_ATOL):
            _fail(f"paged_prefill o max_abs_err={err} (start={start})")
        P = pool_pages                            # dump page excluded
        if not (torch.equal(kk[:, :P], kr[:, :P])
                and torch.equal(vk[:, :P], vr[:, :P])):
            _fail(f"paged_prefill pool bytes differ (start={start})")
        if masked is not None and not torch.equal(
                kk[:, int(bt[start // ps + masked])],
                kp[:, int(bt[start // ps + masked])]):
            _fail("paged_prefill rewrote a shared page")
        live_pages = sum(1 for cp in range(c // ps)
                         if cp * ps < length and int(btw[start // ps + cp]) >= 0)
        nbytes = (q.numel() * 2 + 2 * kn.numel() * 2
                  + start * hkv * dh * 2 * 2 + live_pages * ps * hkv * dh * 4
                  + 2 * nblk * 4 + c * hq * dh * 4)
        pairs = length * start + length * (length + 1) // 2
        bnd, by = bound_ms(nbytes, 4.0 * hq * dh * pairs, peaks)
        s = start + c
        kc = torch.cat([kp[1][bt[:start // ps].long()].reshape(start, hkv, dh),
                        kn]).transpose(0, 1)[None]
        vc = torch.cat([vp[1][bt[:start // ps].long()].reshape(start, hkv, dh),
                        vn]).transpose(0, 1)[None]
        qi = torch.arange(c, device="cuda")[:, None] + start
        mask = (torch.arange(s, device="cuda")[None, :] <= qi)[None, None]
        qs = q.transpose(0, 1)[None]
        results.append({
            "C": c, "start": start, "length": length, "hq": hq, "hkv": hkv,
            "dh": dh, "ps": ps, "max_abs_err": err,
            "ms": timer.ms(lambda: paged_prefill(q, kn, vn, kk, vk, bt, btw,
                                                 start, length, layer=1)),
            "plain_ms": timer.ms(lambda: ref.paged_prefill_ref(
                q, kn, vn, kr, vr, bt, btw, start, length, layer=1)),
            "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                qs, kc, vc, attn_mask=mask, enable_gqa=rep > 1)),
            "bound_ms": bnd, "bound_by": by, "bytes": nbytes})
    return results


# ---------------------------------------------------------------------------
# Phase 4: small-input agreement, card against CPU
# ---------------------------------------------------------------------------
def check_small_reference(torch, registry):
    from repro_torch.core.pipeline import quantize_params_data_free
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.models import model as M
    from repro_torch.models.param import tree_to
    from repro_torch.runtime.paged_cache import (BlockTables, PagePool,
                                                 pages_for_tokens)
    cfg = registry.get("llama-7b").reduced()
    p = tree_to(M.init_params(cfg, 0, "cpu"), float_dtype=torch.float32)
    p = quantize_params_data_free(p, QuantConfig(ratio=0.25, multiple=16),
                                  min_dim=32, fuse=True)
    ps, chunk, plen, steps = 8, 16, 45, 4
    g = torch.Generator().manual_seed(1)
    seq = torch.randint(1, cfg.vocab, (plen + steps,), generator=g,
                        dtype=torch.int32)
    pool = PagePool(16, ps)
    tables = BlockTables(pool, 1, pages_for_tokens(128, ps))
    tables.ensure_blocks(0, pages_for_tokens(plen + steps, ps))
    outs = {}
    for dev in ("cpu", "cuda"):
        pd = tree_to(p, dev)
        caches = M.init_paged_caches(cfg, 16, ps, dtype=torch.float32,
                                     device=dev)
        bt = torch.from_numpy(tables.as_array()).to(dev)
        logits = []
        for start in range(0, plen, chunk):
            length = min(chunk, plen - start)
            toks = torch.zeros((1, chunk), dtype=torch.int32)
            toks[0, :length] = seq[start:start + length]
            lg, caches = M.prefill_step_paged(cfg, pd, toks.to(dev), caches,
                                              bt[0], bt[0], start, length)
            logits.append(lg)
        for pos in range(plen, plen + steps):
            lg, caches = M.decode_step_paged(
                cfg, pd, seq[pos - 1:pos].to(dev),
                torch.tensor([pos], dtype=torch.int32, device=dev), caches,
                bt, torch.tensor([pos + 1], dtype=torch.int32, device=dev))
            logits.append(lg)
        outs[dev] = [t.float().cpu() for t in logits]
    worst = 0.0
    for a, r in zip(outs["cuda"], outs["cpu"]):
        if not torch.isfinite(a).all():
            _fail("non-finite logits on the card")
        worst = max(worst, (a - r).abs().max().item()
                    / max(1.0, r.abs().max().item()))
    if worst > REF_RTOL:
        _fail(f"card vs CPU logits differ by {worst} (relative)")
    return worst


# ---------------------------------------------------------------------------
# Phase 5: the main path
# ---------------------------------------------------------------------------
def run_main_path(torch, registry, kernels, max_new: int = 32):
    import numpy as np
    from repro_torch.core.bits import model_bits
    from repro_torch.core.pipeline import quantize_params_data_free
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
    from repro_torch.models import model as M
    from repro_torch.runtime.engine import Engine

    cfg = registry.get("llama-7b")
    print(f"[main] llama-7b d_model={cfg.d_model} heads={cfg.n_heads} "
          f"kv_heads={cfg.n_kv_heads} head_dim={cfg.head_dim_} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab} layers={cfg.n_layers}",
          flush=True)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    qparams = quantize_params_data_free(
        params, QuantConfig(ratio=0.2, multiple=16), min_dim=32, fuse=True)
    del params
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    rep = model_bits(qparams)
    bits = rep["avg_bits_per_quantized_weight"]
    print(f"[main] init {t_init:.1f}s, data-free fused quantization "
          f"{t_quant:.1f}s: {bits:.4f} bits/weight over "
          f"{rep['quantized_weights']:,} weights", flush=True)
    if not 1.5 < bits < 1.75:
        _fail(f"bits/weight {bits} outside (1.5, 1.75)")

    engine = Engine(cfg, qparams, n_slots=8, max_seq=512, seed=0,
                    page_size=16, prefill_chunk=64, device="cuda")
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=0))
    rng = np.random.default_rng(0)
    prompts = [corpus.document(10_000 + i, int(rng.integers(200, 400)))
               for i in range(8)]
    for k in kernels.values():
        k.launches = 0
    reqs = [engine.submit(p, max_new=max_new) for p in prompts]
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    if not all(r.done for r in reqs):
        _fail("not every request finished")
    if any(len(r.out_tokens) != max_new for r in reqs):
        _fail("a request stopped short of max_new")
    if any(not (0 <= t < cfg.vocab) for r in reqs for t in r.out_tokens):
        _fail("a generated token lies outside the vocabulary")
    for name, n in launches.items():
        if n <= 0:
            _fail(f"kernel {name} was not launched on the main path")
    snap = engine.metrics.snapshot()
    steps = snap["phase_step_s"]
    toks = sum(len(r.out_tokens) for r in reqs)
    summary = {
        "layers": cfg.n_layers, "requests": len(reqs),
        "prompt_tokens": int(sum(len(p) for p in prompts)),
        "generated_tokens": toks, "wall_s": wall,
        "tokens_per_s": toks / wall,
        "ttft_mean_s": snap.get("ttft_mean_s"),
        "ttft_p95_s": snap.get("ttft_p95_s"),
        "tbt_p50_s": snap.get("tbt_p50_s"), "tbt_p95_s": snap.get("tbt_p95_s"),
        "decode_step_ms": 1e3 * steps["decode"]["mean_s"],
        "decode_steps": steps["decode"]["count"],
        "prefill_chunk_ms": 1e3 * steps["prefill_chunk"]["mean_s"],
        "prefill_chunks": steps["prefill_chunk"]["count"],
        "preemptions": snap["preemptions"],
        "bits_per_weight": bits, "quantize_s": t_quant,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
    }
    print("[engine_metrics] " + json.dumps(snap), flush=True)
    return summary


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. the card ----------------------------------------------------
    smi = nvidia_smi()
    print(smi, flush=True)
    peak_name, peaks = peaks_for(smi)
    print(f"[card] {torch.cuda.get_device_name(0)}; bounds use the "
          f"{peak_name} data sheet: {peaks[0] / 1e12:.2f} TB/s, "
          f"{peaks[1] / 1e12:.0f} TFLOP/s bf16", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__}"
          f" cuda {torch.version.cuda}", flush=True)

    # -- 2. build -------------------------------------------------------
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    t_build = time.perf_counter() - t0
    print(f"[build] {len(logs)} kernel sources built in {t_build:.1f}s",
          flush=True)
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {src}: {line.strip()}", flush=True)

    from repro_torch.configs import registry
    from repro_torch.kernels import mixed_matmul, paged_attention, \
        paged_prefill
    kernels = {"mixed_matmul": mixed_matmul.KERNEL,
               "paged_attention": paged_attention.KERNEL,
               "paged_prefill": paged_prefill.KERNEL}

    # -- 3. kernels against their plain versions --------------------------
    cfg = registry.get("llama-7b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer(torch)
    mm = check_mixed_matmul(torch, cfg, timer, peaks, gen)
    print("[mixed_matmul] " + json.dumps(mm), flush=True)
    pa = check_paged_attention(torch, cfg, timer, peaks, gen)
    print("[paged_attention] " + json.dumps(pa), flush=True)
    pf = check_paged_prefill(torch, cfg, timer, peaks, gen)
    print("[paged_prefill] " + json.dumps(pf), flush=True)

    # -- 4. small-input agreement, card against CPU -----------------------
    worst = check_small_reference(torch, registry)
    print(f"[reference] reduced llama-7b, f32: card vs CPU logits agree "
          f"to {worst:.2e} (relative, limit {REF_RTOL})", flush=True)

    # -- 5. the main path --------------------------------------------------
    summary = run_main_path(torch, registry, kernels)
    print("[main] " + json.dumps(summary), flush=True)
    launches = summary["launches"]

    # -- 6. the kernels line and the result --------------------------------
    decode_mm = [r for r in mm if r["M"] == 8]
    entries = [
        {"name": "mixed_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mixed_matmul.cu",
         "replaces": "src/repro/kernels/mixed_matmul.py:158",
         "launches": launches["mixed_matmul"],
         "max_abs_err": max(r["max_abs_err"] for r in mm),
         "ms": sum(r["ms"] for r in decode_mm),
         "plain_ms": sum(r["plain_ms"] for r in decode_mm),
         "bound_ms": sum(r["bound_ms"] for r in decode_mm),
         "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                    for r in decode_mm) else "operations",
         "library_ms": sum(r["library_ms"] for r in decode_mm),
         "shape": "one decode layer at M=8: wqkv+wgu+wo+wd"},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:245",
         "launches": launches["paged_attention"],
         "max_abs_err": pa["max_abs_err"], "ms": pa["ms"],
         "plain_ms": pa["plain_ms"], "bound_ms": pa["bound_ms"],
         "bound_by": pa["bound_by"], "library_ms": pa["library_ms"],
         "shape": "B=8 hkv=32 dh=128 ps=16, lens up to 1000"},
        {"name": "paged_prefill", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_prefill.cu",
         "replaces": "src/repro/kernels/paged_prefill.py:258",
         "launches": launches["paged_prefill"],
         "max_abs_err": max(r["max_abs_err"] for r in pf),
         "ms": pf[0]["ms"], "plain_ms": pf[0]["plain_ms"],
         "bound_ms": pf[0]["bound_ms"], "bound_by": pf[0]["bound_by"],
         "library_ms": pf[0]["library_ms"],
         "shape": "C=64 over 192 context tokens, hkv=32 dh=128"},
    ]
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
