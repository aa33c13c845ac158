#!/usr/bin/env python3
"""Time one source tree's kernels with ``chip_smoke.py``'s timer, so
that two trees (this one and an earlier commit) compare on one card.

    python3 ab_kernels.py --src src                 # this tree
    git archive <commit> | tar -x -C build/parent   # an earlier tree
    python3 ab_kernels.py --src build/parent/src --tag parent

``--src`` is a directory holding a ``repro_torch`` package; its CUDA
kernels are built from its own sources (into ``build/`` beside it).
Run the trees alternately in one job on one card (a, b, b, a), and
compare only numbers from the same job.  Prints one JSON line: the card and its power limit; for
``mixed_matmul`` at the 12 fused LLaMA-7B shapes (wqkv, wgu, wo, wd at
M = 1, 8, 64) and at the unfused projections of the calibrated path
(wq = wk = wv = wo, wg = wu, wd at M = 8, 64): the kernel's, the plain
version's and dense bf16 ``torch.matmul``'s ms; ``paged_attention``,
``paged_prefill``, ``binary_matmul`` and ``int4_matmul`` at
``chip_smoke.py``'s shapes; the host µs of one ``mixed_matmul`` call
beside ``torch.matmul``'s; and the device µs of each CUDA kernel one
packed-matmul call launches.  Every kernel call is also held against its
plain version (``chip_smoke.py``'s checks and tolerances); the attention
kernels' entries also carry the host µs of one call, the device µs of
each kernel a call launches (the split kernel apart from the combine)
and whether a repeated call gave the same bits.  ``--sweep-attention``
times this tree's attention kernels under other split-plan knobs.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import chip_smoke as cs


def unfused_projections(torch, cfg, gen):
    """The 7 unfused packed projections of one LLaMA-7B layer (the
    calibrated path's shapes), quantized data-free."""
    from repro_torch.core.qlinear import QuantConfig, quantize_linear
    qcfg = QuantConfig(ratio=0.2, multiple=16)
    d, f = cfg.d_model, cfg.d_ff

    def q(k, n):
        w = (torch.randn((k, n), generator=gen, device="cuda")
             / math.sqrt(k)).to(torch.bfloat16)
        return quantize_linear(w, None, qcfg)

    return {"wq": q(d, d), "wk": q(d, d), "wv": q(d, d), "wo": q(d, d),
            "wg": q(d, f), "wu": q(d, f), "wd": q(f, d)}


def sweep_splits(torch, projs, timer, gen, caps=(1, 2, 3, 4, 6, 8, 12, 16)):
    """The packed matmul at M = 8 and 64 with the plan's split count
    capped at each of ``caps`` (``index.PACKED_MAX_SPLITS`` set for the
    sweep): the call's ms (timer)."""
    from repro_torch.kernels import index
    from repro_torch.kernels import mixed_matmul as mm
    rows = []
    cap0 = index.PACKED_MAX_SPLITS
    try:
        for cap in caps:
            index.PACKED_MAX_SPLITS = min(cap, cap0)
            mm._PLANS.clear()
            for m in (8, 64):
                for name, q in projs.items():
                    x = torch.randn((m, q.k), generator=gen,
                                    device="cuda").to(torch.bfloat16)
                    plan = mm.launch_plan(m, q.n, q.k, q.k_s, 0)[0]
                    ms = timer.ms(lambda: mm.mixed_matmul(
                        x, q.w4, q.s4, q.z4, q.bits, q.alpha_s, q.alpha_r1,
                        q.alpha_r2, perm=q.perm))
                    rows.append({"proj": name, "M": m, "cap": cap,
                                 "splits": plan.splits, "ms": ms})
    finally:
        index.PACKED_MAX_SPLITS = cap0
        mm._PLANS.clear()
    return rows


def sweep_row_tiles(torch, projs, timer, gen, caps=(8, 4, 2)):
    """The packed matmul at M = 64 with a block's row tiles capped at
    each of ``caps`` (so 64 rows take 64 / (8 * cap) row groups): the
    call's ms (timer)."""
    from repro_torch.kernels import index
    from repro_torch.kernels import mixed_matmul as mm
    rows = []
    nt_fn = index.packed_nt
    try:
        for cap in caps:
            index.packed_nt = mm.packed_nt = (
                lambda m, cap=cap: min(nt_fn(m), cap))
            mm._PLANS.clear()
            for name, q in projs.items():
                x = torch.randn((64, q.k), generator=gen, device="cuda").to(
                    torch.bfloat16)
                plan = mm.launch_plan(64, q.n, q.k, q.k_s, 0)[0]
                ms = timer.ms(lambda: mm.mixed_matmul(
                    x, q.w4, q.s4, q.z4, q.bits, q.alpha_s, q.alpha_r1,
                    q.alpha_r2, perm=q.perm))
                rows.append({"proj": name, "M": 64, "nt_cap": cap,
                             "splits": plan.splits, "blocks": plan.blocks,
                             "ms": ms})
    finally:
        index.packed_nt = mm.packed_nt = nt_fn
        mm._PLANS.clear()
    return rows


def sweep_attention(torch, cfg, timer, peaks,
                    knobs=((1, 1, 1), (2, 2, 1), (2, 1, 1), (4, 1, 1),
                           (1, 4, 1), (2, 2, 2), (2, 2, 4))):
    """The attention kernels of this tree under other plan knobs
    (``index.ATT_WAVES``, ``index.ATT_MIN_TILES``,
    ``index.PREFILL_WAVES``): each call held against its plain version
    and timed (``chip_smoke.check_paged_attention`` / ``_prefill``)."""
    from repro_torch.kernels import index
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_prefill as pf
    saved = (index.ATT_WAVES, index.ATT_MIN_TILES, index.PREFILL_WAVES)
    rows = []
    try:
        for waves, min_tiles, pwaves in knobs:
            index.ATT_WAVES, index.ATT_MIN_TILES = waves, min_tiles
            index.PREFILL_WAVES = pwaves
            pa._PLANS.clear()
            pf._PLANS.clear()
            gen = torch.Generator(device="cuda").manual_seed(0)
            a = cs.check_paged_attention(torch, cfg, timer, peaks, gen)
            p = cs.check_paged_prefill(torch, cfg, timer, peaks, gen)
            rows.append({"att_waves": waves, "att_min_tiles": min_tiles,
                         "prefill_waves": pwaves,
                         "attention_plan": pa.launch_plan(
                             8, 32, 1, 128, 64, 16, True, 0)._asdict(),
                         "prefill_plan": pf.launch_plan(
                             64, 32, 32, 128, 32, 16, 0)._asdict(),
                         "attention_ms": a["ms"],
                         "attention_us": a["device_us"],
                         "prefill_ms": [r["ms"] for r in p],
                         "prefill_us": [r["device_us"] for r in p]})
    finally:
        index.ATT_WAVES, index.ATT_MIN_TILES, index.PREFILL_WAVES = saved
        pa._PLANS.clear()
        pf._PLANS.clear()
    return rows


def host_breakdown(torch, projs, gen):
    """Host µs of each step of one mixed_matmul call (wqkv, M = 8),
    each repeated alone (``chip_smoke.host_call_us``)."""
    from repro_torch.kernels import mixed_matmul as mm
    q = projs["wqkv"]
    x = torch.randn((8, q.k), generator=gen, device="cuda").to(
        torch.bfloat16)
    k_s, n, k_b = q.w4.shape[0] * 2, q.bits.shape[1], q.bits.shape[0] * 8
    plan, words = mm.launch_plan(8, n, q.k, k_s, 0)
    stream = torch._C._cuda_getCurrentRawStream(0)
    ws, xg = mm._scratch(plan, 0, stream)
    y = x.new_empty((8, n))
    ptrs = [x.data_ptr(), q.perm.data_ptr(), q.w4.data_ptr(),
            q.s4.data_ptr(), q.z4.data_ptr(), q.bits.data_ptr(),
            q.alpha_s.data_ptr(), q.alpha_r1.data_ptr(),
            q.alpha_r2.data_ptr(), y.data_ptr(), ws.data_ptr(),
            xg.data_ptr(), stream]
    arg = mm._HEAD.pack(*ptrs) + words
    steps = {
        "check_packed": lambda: mm.check_packed(
            "mixed_matmul", x, k_s + k_b, n, (q.w4, q.bits),
            ((q.s4, k_s), (q.z4, k_s), (q.alpha_s, n), (q.alpha_r1, n),
             (q.alpha_r2, k_b))),
        "launch_plan": lambda: mm.launch_plan(8, n, q.k, k_s, 0),
        "new_empty": lambda: x.new_empty((8, n)),
        "stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "scratch": lambda: mm._scratch(plan, 0, stream),
        "data_ptrs": lambda: [x.data_ptr(), q.perm.data_ptr(),
                              q.w4.data_ptr(), q.s4.data_ptr(),
                              q.z4.data_ptr(), q.bits.data_ptr(),
                              q.alpha_s.data_ptr(), q.alpha_r1.data_ptr(),
                              q.alpha_r2.data_ptr(), y.data_ptr()],
        "pack": lambda: mm._HEAD.pack(*ptrs) + words,
        "c_launch": lambda: mm.KERNEL.launch(arg),
        "whole_call": lambda: mm.mixed_matmul(
            x, q.w4, q.s4, q.z4, q.bits, q.alpha_s, q.alpha_r1, q.alpha_r2,
            perm=q.perm),
    }
    return {name: cs.host_call_us(torch, fn) for name, fn in steps.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True,
                    help="directory holding the repro_torch package")
    ap.add_argument("--tag", default="",
                    help="label printed with the result")
    ap.add_argument("--sweep", action="store_true",
                    help="instead: time the packed matmul of this tree "
                         "under split caps and row-tile caps, and its "
                         "host steps")
    ap.add_argument("--sweep-attention", action="store_true",
                    help="instead: time this tree's attention kernels "
                         "under other split-plan knobs")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ab_kernels: CUDA is not available", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[1] != src:
        print(f"ab_kernels: repro_torch came from {repro_torch.__file__}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import registry
    from repro_torch.kernels import build
    for source, log in build.build_all().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {source}: {line.strip()}", file=sys.stderr)
    smi = cs.nvidia_smi()
    _, peaks = cs.peaks_for(smi)
    cfg = registry.get("llama-7b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = cs.Timer(torch)
    if args.sweep_attention:
        print(json.dumps({"tag": args.tag, "card": smi,
                          "sweep_attention": sweep_attention(
                              torch, cfg, timer, peaks)}), flush=True)
        return 0
    projs = cs.llama_projections(torch, cfg, gen)
    if args.sweep:
        print(json.dumps({"tag": args.tag, "card": smi,
                          "sweep": sweep_splits(torch, projs, timer, gen),
                          "row_tiles": sweep_row_tiles(torch, projs, timer,
                                                       gen),
                          "host_steps_us": host_breakdown(torch, projs,
                                                          gen)}), flush=True)
        return 0
    out = {"tag": args.tag, "src": str(src), "card": smi,
           "mixed_matmul": cs.check_mixed_matmul(torch, projs, timer, peaks,
                                                 gen)}
    out["paged_attention"] = cs.check_paged_attention(torch, cfg, timer,
                                                      peaks, gen)
    out["paged_prefill"] = cs.check_paged_prefill(torch, cfg, timer, peaks,
                                                  gen)
    out.update(cs.check_spans(torch, projs, timer, peaks,
                              torch.Generator(device="cuda").manual_seed(1)))
    out["host"] = cs.host_us(torch, projs,
                             torch.Generator(device="cuda").manual_seed(4))
    out["split_us"] = cs.kernel_split_us(
        torch, projs, torch.Generator(device="cuda").manual_seed(5))
    del projs
    layer = unfused_projections(torch, cfg,
                                torch.Generator(device="cuda").manual_seed(6))
    out["unfused"] = [r for r in cs.check_mixed_matmul(
        torch, layer, timer, peaks,
        torch.Generator(device="cuda").manual_seed(2)) if r["M"] != 1]
    decode = [r for r in out["mixed_matmul"] if r["M"] == 8]
    out["decode_layer_us"] = {
        "fused": sum(r["ms"] for r in decode) * 1e3,
        "fused_torch_matmul": sum(r["library_ms"] for r in decode) * 1e3,
        "unfused": sum(r["ms"] for r in out["unfused"] if r["M"] == 8) * 1e3,
        "unfused_torch_matmul": sum(r["library_ms"] for r in out["unfused"]
                                    if r["M"] == 8) * 1e3}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
