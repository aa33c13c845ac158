#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths on one GPU and check them.

    python3 chip_smoke.py            # what the check runs: needs one card
    python3 chip_smoke.py --tp4      # sharded serving over four cards

Phases, each of which raises on failure:

1. print the card's name and power limit (``nvidia-smi``);
2. build the five CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) and print the build seconds;
3. hold each kernel against its plain PyTorch version on the card at
   LLaMA-7B shapes, with the tolerances stated below, and time it beside
   its plain version, a yardstick PyTorch call and its bound
   (``binary_matmul`` and ``int4_matmul`` at the binary and int4 spans
   of the fused QKV and of the down projection); hold the packed matmul
   at ragged and one-sided shapes too, check that a repeated call gives
   the same bits, print the host time of one call beside
   ``torch.matmul``'s and the device time of each kernel a call
   launches (gather, matmul, fold), and time the gather by ``perm`` at
   decode beside ``x[:, perm]`` and ``torch.index_select`` (``[gather]``,
   the TPU kernel's ``perm`` path); for the two attention kernels, check
   that a repeated bf16 call gives the same bits and print the host time
   of one call and the device time of the kernel apart from its combine
   of split partials; the ``[plan]`` line prints the attention kernels'
   split plans at the serving shapes.  The packed matmul is also held
   and timed at the other row counts the paths give it (``PATH_ROWS``:
   4-slot decode, whole-prompt buckets, the loss's 1024 rows;
   ``[mixed_matmul M=...]``).  The same checks at granite-moe-1b-a400m's
   shapes: its fused QKV (K 1024, N 2048) and output projection (1024 x
   1024) at ``MOE_ROWS`` (``[moe mixed_matmul M=...]``) and both
   attention kernels at GQA group 2, head dim 64 (``[moe
   paged_attention]``, ``[moe paged_prefill]``, ``[moe plan]``); and at
   recurrentgemma-2b's: its seven packed projections (wqkv K 2560 → N
   3072, wo, w_x, w_gate, w_out 2560 × 2560, wgu 2560 → 15360, wd 7680
   → 2560) at ``RG_ROWS`` (``[rg mixed_matmul M=...]``, with the host
   time of a call, as the LLaMA and granite row counts have too) and the
   decode kernel at MQA group 10, head dim 256, a 2048-key window over
   contexts of 0-3000 keys, bf16 and f32 (``[rg paged_attention]``,
   ``[rg plan]``); and at xlstm-1.3b's: its nine packed projections
   (w_q, w_k 2048 x 2048, w_v, w_gate 2048 → 4096, w_out 4096 → 2048,
   w_gates 2048 → 8192, the sLSTM FFN's w_up, w_gate 2048 → 5504 and
   w_down 5504 → 2048: K and N of 43 x 128) at ``XL_ROWS`` (``[xl
   mixed_matmul M=...]``); at seamless-m4t-medium's: its five packed
   shapes (K 1024 with N 1024, 3072, 4096 and 8192; 4096 → 1024) at
   ``S2T_ROWS``, the encoder's 8 x 1024 frame rows included (``[s2t
   mixed_matmul M=...]``); and at llava-next-34b's: its fused layer
   (wqkv 7168 → 9216, wgu 7168 → 40960, wo 7168², wd 20480 → 7168) at
   ``VLM_ROWS`` (``[vlm mixed_matmul M=...]``) and both attention
   kernels at GQA group 7, head dim 128 (``[vlm paged_attention]``,
   ``[vlm paged_prefill]``, ``[vlm plan]``);
4. agreement on a small input: the reduced LLaMA config served on the
   card (kernels) and on the CPU (plain versions) from the same weights
   gives the same logits within tolerance; the calibrated pipeline run
   on the card and on the CPU gives the same masks and packed bytes and
   learned scales within tolerance; the contiguous whole-prompt engine
   gives the same greedy tokens on the card and the CPU, and on the card
   whole-prompt and chunked prefill give the same tokens; the paged
   engine with prefix sharing gives the same greedy tokens on the card
   and the CPU, with chunked and with whole-prompt prefill; the paper's
   five 2-bit comparison methods quantize the same weights on the card
   and on the CPU (RTN, PB-LLM and BiLLM identical, AWQ's and BiLLM's
   choices equal, GPTQ's objective within tolerance); then all of this
   phase again on reduced granite, which runs the MoE dispatch (sort,
   cumsum, index_put) on the card (``[moe reference]``); and on reduced
   recurrentgemma (``[rg reference]``: logits after a whole-prompt
   prefill, greedy tokens of the contiguous, paged and shared-prefix
   whole-prompt engines, calibrated bytes, each card = CPU); and on
   reduced xlstm (``[xl reference]``, the same checks); then reduced
   seamless (``[s2t reference]``: the prefill logits over 40 encoder
   frames, the cross K/V and 4 decode steps, each step on the card from
   the CPU's caches) and reduced llava (``[vlm reference]``: the same
   with 8 vision embeddings, and the greedy tokens of its engines), and
   ``launch.serve.run --arch llava-next-34b --reduced`` through the
   paged chunked-prefill engine (``[vlm serve]``);
5. the data-free main path: LLaMA-7B at full width and full depth (32
   layers), data-free PTQ1.61 with fused QKV / gate+up, served through
   the paged chunked-prefill engine; every request must finish and every
   kernel of the path must have launched in that run; then a few more
   decode steps under ``torch.profiler``, whose kernel time over wall
   time is the device-busy share of a decode step.  The same weights are
   then served with whole-prompt prefill on the contiguous backend
   (``[whole]``) and on the paged one (``[whole-paged]``), and their
   ``forward_loss`` on 2 x 512 tokens must be finite (``[loss]``).
   Then prefix sharing on the same weights: 8 prompts with a common
   256-token prefix served with sharing off and on through chunked
   prefill (``[shared-prefix]``: same bf16 tokens, fewer chunk calls, no
   copy-on-write copy, 16 skipped tokens per attached page), a second
   wave on the same engine that hits the retained prefix
   (``[shared-prefix retain]``: only the tails run), and the first wave
   with whole-prompt prefill (``[shared-prefix whole-paged]``: 112 pages
   attached, 112 fewer pages at the peak).  Then restorative-LoRA
   preprocessing of the bf16 weights, cut to 20 steps, quantized
   data-free and its loss beside the quantized original's
   (``[preprocess]``).  Then the paper's Table-1 comparison: the bf16
   weights fake-quantized by each of rtn-2, gptq-2, awq-2, pbllm and
   billm through the baselines' driver at full width and 16 of the 32
   layers (``BASELINE_LAYERS``), beside data-free PTQ1.61 at phase 5's
   settings on the same 16 layers, each
   with its quantize seconds, peak memory, bits and finite loss, and
   GPTQ's objective below RTN's on every leaf of layer 0
   (``[baselines]``);
6. the calibrated path: the same model quantized with calibrated
   PTQ1.61 at ``repro_torch.launch.serve``'s defaults (Eq.-7 block loss
   before and after learning, which must not rise), its first layer's 7
   unfused projections held against the plain version and timed beside
   the fused layer, then served the same way;
7. ``repro_torch.launch.serve.run`` at the reference's defaults (the
   contiguous backend, whole-prompt prefill) on LLaMA-7B
   (``[serve-default]``): every request must finish; then with the
   paged chunked-prefill engine, ``--share-prefix --prefix-retain 16``
   (``[serve-share-prefix]``): the prefix cache must hit;
8. the MoE block kind: granite-moe-1b-a400m at full width and full
   depth (24 layers, 32 experts, top-8), random bf16 weights of seed 0.
   Data-free fused PTQ1.61 (bits per weight from ``model_bits``, which
   must equal the paper's App.-A form over granite's shapes) served
   through the paged chunked-prefill engine on the prompts of phase 5
   (``[moe]``: tokens/s, TTFT, decode step, busy share, the device time
   of the expert dequantization and of ``apply_moe`` in a decode step,
   launches, peak memory); the same weights on the contiguous
   whole-prompt engine (``[moe whole]``) and their ``forward_loss`` with
   the load-balancing term (``[moe loss]``); calibrated PTQ1.61 at the
   serve defaults, every block's Eq.-7 loss before and after learning,
   none may rise, then served (``[moe calibrated]``); rtn-2 and pbllm at
   full size (``[moe baselines]``).  The expert products are plain
   ``torch.matmul`` over dequantized weights, as the reference's einsum;
   only attention runs the port's kernels;
9. the hybrid block kinds: recurrentgemma-2b at full width and depth
   (26 layers: 18 rglru and 8 local, window 2048; vocab 256000, tied
   head), random bf16 weights of seed 0, data-free fused PTQ1.61 served
   with whole-prompt prefill on the paged pool (``[rg]``) and on the
   contiguous rings (``[rg contiguous]``) on the prompts of phase 5,
   then 4 prompts of 2100-3000 tokens at max_seq 4096 on both backends
   (``[rg long]``: the window cuts keys off; pages a slot holds against
   the pages its window reads), ``forward_loss`` (``[rg loss]``),
   ``launch.serve.run --arch recurrentgemma-2b --fused --paged`` (``[rg
   serve]``), chunked prefill refused with the reference's ValueError,
   and calibrated PTQ1.61 at the serve defaults (``[rg calibrated]``:
   no block's Eq.-7 loss may rise; its unfused projections held
   against the plain version; served as ``[rg]``);
10. the xLSTM block kinds: xlstm-1.3b at full width and 16 of its 48
   layers (2 of its 6 superblocks: 14 mlstm, 2 slstm;
   ``[xl serve]`` builds all 48; layernorm, vocab 50304, untied head),
   random bf16 weights of seed 0, data-free PTQ1.61 (its projections
   stay unfused, as in the reference) served with whole-prompt prefill
   on the paged tables (``[xl]``; the model has no attention block, so
   no page pool on the card and no attention kernel) and on the
   contiguous backend (``[xl contiguous]``) on the prompts of phase 5;
   the device time of the mLSTM state update of an 8-slot decode step
   beside its bound, and of the sLSTM scans of a 512-token prefill
   (``[xl cells]``); 4 prompts of 2100-3000 tokens at max_seq 4096 on 4
   paged slots (``[xl long]``); ``forward_loss`` (``[xl loss]``);
   chunked prefill refused with the reference's ValueError; ``[xl
   serve]`` (``launch.serve.run --arch xlstm-1.3b --fused --paged``);
   calibrated PTQ1.61 at the serve defaults (``[xl calibrated]``: no
   block's Eq.-7 loss may rise; the first mlstm and slstm layers'
   projections held against the plain version; served as ``[xl]``);
   rtn-2 and pbllm at full size (``[xl baselines]``).  The mLSTM and
   sLSTM cells are plain PyTorch, as the reference leaves them to XLA;
11. the encoder-decoder inputs: seamless-m4t-medium at full width and
   depth (12 encoder and 12 decoder layers, d 1024, vocab 256206),
   random bf16 weights of seed 0, data-free fused PTQ1.61 (bits in
   (1.5, 1.75)); the encoder over 1024 stub frames for 8 rows, prefill
   of 8 prompts of 64 tokens, 32 greedy decode steps over the rings and
   the cached cross K/V, the busy share of a decode step (``[s2t]``),
   and ``forward_loss`` with frames (``[s2t loss]``); the engine
   refuses the model, as the reference's cannot serve it;
12. the vision-prefix inputs: llava-next-34b at full width and all 60
   layers, built and quantized one layer at a time (data-free fused),
   the model-level prefill of 8 rows of 576 stub vision embeddings and
   64 text tokens and 16 decode steps beside the step's weight-read
   bound (``[vlm model]``), then the engine on text prompts through
   paged chunked prefill with all three kernels, as phase 5 (``[vlm]``);
13. training: ``launch.train.run`` of qwen2.5-3b at full width and
   depth (36 layers, 3.086 B parameters, bf16 weights, f32 AdamW
   moments) for 30 steps of 8 x 512 tokens with remat (``[train]``:
   finite losses whose last five average below the first; then the
   same step timed on its state, tokens/s, the model FLOP share of 989
   TFLOP/s, peak memory, the busy share and the device ms by kernel of
   a step); 6 steps with 2 microbatches and int8 gradient compression
   (``[train mb2 int8]``); the trained params tree (6.17 GB) saved in
   the reference's checkpoint layout and restored bit for bit, with
   each way's GB/s (``[train ckpt]``); the reference's restart test on
   tiny-lm, a failure at step 9 ending within 1e-5 of the uninterrupted
   run (``[train restart]``); 3 steps of a reduced 3-layer model on the
   card and on the CPU from one state (``[train reference]``).  The
   training path reaches no kernel of the port (every launch count
   reads 0), as the reference's reaches no Pallas kernel;
14. training across devices on the one card: qwen2.5-3b at full width
   and depth, 3 steps of 8 x 512 tokens, first on one device, then the
   sharded step (``launch.train.run(args, mesh=...)``) from the same
   seed on one NCCL rank, a (1, 1) ("data", "model") mesh with FSDP,
   the state as DTensors (``[dist train]``: both runs' losses and step
   ms, the sharded run's peak memory, the largest parameter gap; the
   same bits are expected, since every collective of one rank is an
   identity); ``pipeline_apply`` with one stage on the card against
   plain application (``[dist pipeline]``).  No kernel of the port is
   launched (every launch count reads 0).  A step across several cards
   waits for a machine with them (ROADMAP);
15. the sharded step of the other block kinds on one NCCL rank of a
   (1, 1) mesh with FSDP, each against the one-device step from the
   same seed (``[dist kinds moe|rg|xl|s2t]``, the same bits expected):
   granite-moe-1b-a400m at full width and depth, 3 steps of 8 x 512
   tokens, one device through ``launch.train.run`` and the sharded step
   with EP, whose group-local MoE path must run (its calls counted);
   recurrentgemma-2b (rglru, rglru, local, then rglru), xlstm-1.3b (7
   mlstm and 1 slstm) and seamless-m4t-medium (2 encoder and 2 decoder
   layers over 4 x 1024 stub frames) at full width, 2 steps of 4 x 512
   tokens.  Step ms and peak GB of each side.  No kernel of the port is
   launched;
16. sharded serving of packed weights on one NCCL rank (``[dist
   serve]``): qwen3-4b at full width, quantized data-free unfused, its
   prefill of 8 x 256 tokens and 32 greedy decode steps through
   ``model.shard_for_serving`` bit-identical to one device, with the
   same mixed_matmul launches; then the tp 4 / 16 split arithmetic of
   its column and row views on the card (``[dist serve split]``);
17. sharded serving of the other block kinds the same way (``[dist
   serve kinds moe|rg|xl|s2t]``): granite-moe-1b-a400m at full width
   and depth (EP), recurrentgemma-2b, xlstm-1.3b and
   seamless-m4t-medium (8 x 1024 stub frames, prompts of 64) at full
   width and one superblock, prefill of 8 x 256 tokens and 16 greedy
   steps, bit-identical to one device with equal mixed_matmul launches
   and no paged launch; every packed-matmul shape new to the phase held
   against its plain version; the tp-4 split of granite layer 0's
   experts (column views of wg / wu, g·u joined, the whole wd) against
   the whole leaves;
18. uneven tensor-parallel head splits (``[dist uneven]``):
   phi4-mini-3.8b (24 query heads over 8 KV heads) at full width and
   depth, quantized data-free unfused, its prefill of 8 x 256 tokens
   and 16 greedy steps through ``model.shard_for_serving`` as one NCCL
   rank bit-identical to one device with equal mixed_matmul launches
   and no paged launch, and its sharded train step at full width and 4
   of its 32 layers (2 steps of 4 x 512 tokens) bit-identical to one
   device with no launch; then the tp-16 split arithmetic rank after
   rank (``[dist uneven split ...]``): phi4-mini's and llava-next-34b's
   layer 0 attention (query head views with empty ranks, every KV head,
   wo's row partials), recurrentgemma-2b's first rglru layer (each gate
   head cut in two) and first local layer (10 run-time KV heads),
   xlstm-1.3b's first mLSTM layer (4 heads over 16), and the
   context-sharded decode combine of phi4-mini (8 slots, 16 chunks of
   2048) and of recurrentgemma's local window (16 chunks of 128), each
   against the whole on one device in f32;
19. the sequence-parallel residual stream (``[dist sp]``): qwen2.5-3b's
   sharded train step at full width and 4 of its 36 layers (2 steps of
   4 x 512 tokens) and its sharded serving at full depth (data-free
   unfused, prefill of 8 x 256 tokens and 16 greedy steps) as one NCCL
   rank with ``Parallel.sp`` on and off, each bit-identical to one
   device (the stream's entry and exit are identities at one rank;
   their calls are counted); then the split arithmetic of tp 4 and 16
   rank after rank on one full-width block of qwen2.5-3b and one of
   phi4-mini-3.8b over 2 x 4096 positions (``[dist sp split ...]``):
   each rank's chunk of the norms and residual adds bit-identical to
   the whole's rows, the row products (plain f32 and the packed row
   views) summed and cut to the chunks within 1e-5 of max|y| of one
   device's, the empty chunks of a stream of 8 positions launching
   nothing; the peak GB of the sp train step beside the saved
   superblock inputs per rank of the tp-16 pod preset (``[dist sp
   memory]``);
20. the dry-run (``[dryrun]``, ``launch/dryrun.py``) in processes of
   its own: qwen3-4b's decode_32k as rank 0 of the 256-rank pod at full
   width and depth on fake cuda tensors (FLOPs, eager bytes,
   collectives, peak GB against 80, roofline bound and dominant term,
   trace seconds); then its prediction of three steps on a (1, 1) mesh
   held against the same steps run here as one NCCL rank: qwen3-4b
   served at full depth (prefill of 8 x 256, one decode step) and
   qwen2.5-3b's train step at 4 of 36 layers (4 x 512): FLOPs
   (``FlopCounterMode`` plus 2·M·K·N per packed launch) and packed
   launches by shape equal, the card's peak within 15% of the
   predicted, the step's wall ms beside the roofline bound;
21. check that every (M, K, N) the packed matmul launched at in phases
   5-20 was held against its plain version in phase 3, 6, 8, 9, 10, 16,
   17, 18 or 19, then print the ``kernels`` JSON line (six entries, one per TPU
   kernel: the five wrappers and the perm gather of ``mixed_matmul``)
   and the result line.  Each phase's wall seconds print as it ends
   (``[phase]``).

It exits non-zero without CUDA, and when run outside a checkout of the
repository.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
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
# calibrated pipeline, card against CPU, f32: masks and packed bytes
# exact.  Learned scales within 1e-4 relative: the card and the CPU sum
# the gradients in another order, and the gap measured on an H100 was
# 1.1e-6, about 90 times below; a run that did not learn stays about
# lr·updates/|α| (above 1e-2) from the learned α's, and the check runs
# that control and fails unless it exceeds the tolerance.  The block
# losses, which average over every α, within 1e-3 relative.
CAL_ALPHA_RTOL = 1e-4
CAL_LOSS_RTOL = 1e-3
# The paper's 2-bit comparison methods (Table 1).  Card against CPU on a
# small input: RTN, PB-LLM and BiLLM identical (elementwise arithmetic and
# column sums in a fixed order), AWQ's and BiLLM's choices equal, and
# GPTQ's objective within 1e-3 relative (H⁻¹ from cuSOLVER and from the
# CPU's LAPACK differ in their last bits, and a flipped code moves its
# error into every later column of its row).
BASELINES = ("rtn-2", "gptq-2", "awq-2", "pbllm", "billm")
BASE_GPTQ_RTOL = 1e-3
# ``[baselines]`` quantizes 16 of LLaMA-7B's 32 layers at full width, and
# PTQ1.61 beside them on the same 16: gptq-2's column loop took 279.5 s
# at 32 layers in a run of 1013.3 s (NVIDIA H100 80GB HBM3, 700.00 W);
# the per-layer work and the bits per weight do not depend on the depth
BASELINE_LAYERS = 16
# Row counts of the packed matmul on the driven paths besides the
# M = 1, 8, 64 of the kernel check: 4-slot decode and bucket-16 prefill
# of serve's defaults, whole-prompt buckets 256 and 512, and the 2 x 512
# tokens of the loss.  Each is held against the plain version, and the
# shapes the paths launch must all have been checked.
PATH_ROWS = (4, 16, 256, 512, 1024)
# The MoE phases' model, the packed-matmul rows they launch (single
# rows, 8-slot decode, the 64-token chunk, whole-prompt buckets 256 and
# 512, the loss's 2 x 512) and the comparison methods they run at full
# size (GPTQ at this size waits for a faster column loop).
MOE_ARCH = "granite-moe-1b-a400m"
MOE_ROWS = (1, 8, 64, 256, 512, 1024)
MOE_BASELINES = ("rtn-2", "pbllm")
# The hybrid phases' model and the packed-matmul rows they launch besides
# M = 1, 8, 64 and 512: 4-slot decode and bucket 16 of ``[rg long]`` and
# ``[rg serve]``, whole-prompt buckets 256 and 4096, the loss's 2 x 512.
RG_ARCH = "recurrentgemma-2b"
RG_ROWS = (1, 4, 8, 16, 64, 256, 512, 1024, 4096)
# recurrentgemma's decode attention: 8 slots of up to 3000 keys (some
# past the 2048-key window, one empty), a freed page inside slot 0's
# window.
RG_ATT_LENS = (3000, 2600, 2049, 2048, 1500, 700, 64, 0)
# The xLSTM phases' model and the packed-matmul rows its paths launch:
# 4-slot decode of ``[xl long]`` and ``[xl serve]`` (whose buckets are 16
# and 64), 8-slot decode, whole-prompt buckets 256 and 512 (and 4096 of
# ``[xl long]``), the loss's 2 x 512; M = 1 besides.
XL_ARCH = "xlstm-1.3b"
XL_ROWS = (1, 4, 8, 16, 64, 256, 512, 1024, 4096)
# The encoder-decoder phase's model and what it runs: 8 rows of
# ``models.model.ENC_FRAMES`` (1024) stub frames, prompts of S2T_PROMPT
# tokens and S2T_STEPS decode steps; the packed matmul's rows: 8-row
# decode, the 8 prompts (prefill and the loss) and the encoder's 8 x
# 1024 frames (the encoder and the cross-attention's K/V).
S2T_ARCH = "seamless-m4t-medium"
S2T_PROMPT, S2T_STEPS = 64, 32
S2T_ROWS = (8, 512, 8192)
# The vision-prefix phase's model and what it runs: all 60 layers, 8
# rows of VLM_VISION stub vision embeddings and VLM_TEXT text tokens,
# VLM_STEPS decode steps; the packed matmul's rows: 8-slot decode, the
# engine's 64-token chunks and the 8 x 640 rows of the model's prefill.
VLM_ARCH = "llava-next-34b"
VLM_DEPTH, VLM_VISION, VLM_TEXT, VLM_STEPS = 60, 576, 64, 16
VLM_ROWS = (8, 64, 5120)
# packed projections per block kind (an attention block's 7)
KIND_PROJECTIONS = {"rglru": 6, "mlstm": 5, "slstm": 4}
# Sharded serving (phase 16, ``[dist serve]``): qwen3-4b at full width
# and DIST_SERVE_DEPTH of its 36 layers, quantized data-free unfused at
# the serving defaults, as one NCCL rank on a (1, 1) mesh against one
# device: 8 prompts of 256 tokens (ring caches of 512), 32 greedy decode
# steps.  The packed matmul's rows there: 8-row decode and the 8 x 256
# prompt tokens (QWEN3_ROWS, held in phase 3).  Then the split
# arithmetic: each rank's view of wq (column), wo and wd (row) at tp 4
# and 16, at M = 8 and 256, launched one after another with the f32
# output and summed in rank order, against the whole leaf's f32
# accumulator: relative gap at most SPLIT_RTOL (summation order only),
# and after the one rounding each output within one bf16 ulp of the
# whole leaf's rounded output beyond the f32 gap.
DIST_SERVE_ARCH = "qwen3-4b"
DIST_SERVE_DEPTH = 36
DIST_SERVE_ROWS, DIST_SERVE_PROMPT = 8, 256
DIST_SERVE_MAX_SEQ, DIST_SERVE_STEPS = 512, 32
DIST_SERVE_MIN_DIM = 256      # launch.qdeclare's default
QWEN3_ROWS = (8, 2048)
SPLIT_TPS, SPLIT_ROWS, SPLIT_LEAVES = (4, 16), (8, 256), ("wq", "wo", "wd")
SPLIT_RTOL = 1e-5
# Fused QLinearGroup leaves in sharded serving (``[dist serve fused]``,
# in phase 16): the same qwen3-4b bf16 weights quantized data-free with
# fuse=True (wqkv, wgu), a prefill of DIST_SERVE_ROWS x DIST_SERVE_PROMPT
# and FUSED_STEPS greedy steps on one device and through
# ``shard_for_serving`` as one NCCL rank: the same bits and launches,
# fewer packed products a layer than the unfused run's 7.  Then the
# split arithmetic of the fused views (``sharding.group_view``) of layer
# 0's wqkv and wgu at SPLIT_TPS and SPLIT_ROWS, and phi4-mini-3.8b's
# fused wqkv at tp UNEVEN_TP (whole query heads, none on ranks 12-15);
# and the context-sharded cross K/V: seamless-m4t-medium's layer-0
# cross-attention decode of DIST_SERVE_ROWS rows over
# SERVE_KIND_FRAMES stub frames cut into CTX_CROSS_CHUNKS chunks
# (``layers._cross_ctx``), combined as the all-reduces over "model" do,
# against the whole (f32, within SPLIT_RTOL of its largest value).
FUSED_STEPS, CTX_CROSS_CHUNKS = 16, 16
# Sharded serving of the other kinds (phase 17, ``[dist serve kinds]``):
# granite-moe-1b-a400m at full width and depth, then recurrentgemma-2b,
# xlstm-1.3b and seamless-m4t-medium (SERVE_KIND_FRAMES stub frames a
# row) at full width and one superblock (``_kind_dist_cases``'
# configs), each quantized data-free unfused at the serving defaults
# and served as one NCCL rank on a (1, 1) mesh against one device: 8
# prompts of SERVE_KIND_PROMPT tokens (seamless's of S2T_PROMPT), ring
# caches of DIST_SERVE_MAX_SEQ, SERVE_KIND_STEPS greedy decode steps.
# Every packed-matmul shape the phase launches that phase 3 did not
# hold is held here against its plain version on a leaf of that shape.
# Then the tp-4 split of granite layer 0's experts at EXPERT_SPLIT_ROWS
# capacity rows (a decode step's 8, a 8 x 256 prefill's 640): the
# column views of wg / wu, g·u joined, through the whole wd, against
# the whole leaves (f32 products within SPLIT_RTOL of max|y|).
SERVE_KIND_PROMPT, SERVE_KIND_STEPS, SERVE_KIND_FRAMES = 256, 16, 1024
EXPERT_SPLIT_TP, EXPERT_SPLIT_ROWS = 4, (8, 640)


# Uneven head splits (phase 18, ``[dist uneven]``): phi4-mini-3.8b at
# full width and depth, quantized data-free unfused at the serving
# defaults, served as one NCCL rank on a (1, 1) mesh against one device
# (8 prompts of DIST_SERVE_PROMPT tokens, UNEVEN_STEPS greedy steps), and
# its sharded train step at full width and UNEVEN_TRAIN_DEPTH of its 32
# layers (KIND_DIST_STEPS steps of KIND_DIST_ROWS x KIND_DIST_SEQ
# tokens) against one device.  Then the split arithmetic of tp UNEVEN_TP
# rank after rank (whole heads per rank, ``Shards.heads``) at
# UNEVEN_SPLIT_ROWS rows of the packed products and UNEVEN_ATT_SHAPE
# (rows, positions) of attention and the mLSTM, and the context-sharded
# decode combine at CTX_SLOTS slots; f32 gaps within SPLIT_RTOL of
# max|y| (the same sums in another order).
UNEVEN_ARCH = "phi4-mini-3.8b"
UNEVEN_STEPS, UNEVEN_TRAIN_DEPTH, UNEVEN_TP = 16, 4, 16
UNEVEN_SPLIT_ROWS, UNEVEN_ATT_SHAPE, CTX_SLOTS = (8, 256), (2, 128), 8
# The sequence-parallel stream (phase 19, ``[dist sp]``): qwen2.5-3b as
# one NCCL rank with ``Parallel.sp`` on and off, each against one
# device: its sharded train step at full width and SP_TRAIN_DEPTH of its
# 36 layers (KIND_DIST_STEPS steps of KIND_DIST_ROWS x KIND_DIST_SEQ
# tokens) and its sharded serving at full depth, quantized data-free
# unfused (a prefill of DIST_SERVE_ROWS x DIST_SERVE_PROMPT tokens,
# UNEVEN_STEPS greedy steps).  Then the split arithmetic of tp SP_TPS
# rank after rank, one full-width block of qwen2.5-3b and one of
# phi4-mini-3.8b on a stream of SP_SHAPE (rows, positions): each rank's
# chunk of the norms and residual adds bit-identical to the whole's
# rows, the row products (plain f32 and the packed row views' f32
# output) summed in rank order and cut to the chunks within SPLIT_RTOL
# of max|y| of one device's (the same partials that the replicated
# route all-reduces: cuBLAS's f32 product of qwen2.5-3b's wo over 4
# parts of K parted from the whole by 1.29e-6 of max|y| on an H100,
# NVIDIA H100 80GB HBM3, 700.00 W, above the 1e-6 first aimed at), and
# a stream of SP_EMPTY positions, whose trailing ranks hold no
# position, launching nothing there.
SP_TRAIN_DEPTH, SP_TPS, SP_SHAPE, SP_EMPTY = 4, (4, 16), (2, 4096), 8


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _launches(kernels) -> dict:
    """Each wrapper's launch count, by kernel name."""
    return {name: k.launches for name, k in kernels.items()}


def _reset(kernels) -> None:
    """Set every wrapper's launch count to 0."""
    for k in kernels.values():
        k.launches = 0


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
    each launch (the main path finds its weights and pages cold); the
    median of ``iters`` launches.  The flush writes 512 MB, which keeps
    the card busy for longer than the host takes to enqueue the timed
    call, so the events time the card's work and not the host's."""

    def __init__(self, torch, iters: int = 20):
        self.torch = torch
        self.iters = iters
        self.flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(self.iters):
            self.flush.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        times.sort()
        return 0.5 * (times[(self.iters - 1) // 2] + times[self.iters // 2])


def bound_ms(nbytes: float, flops: float, peaks):
    bw, fl = peaks
    t_bytes, t_ops = nbytes / bw, flops / fl
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions at LLaMA-7B shapes
# ---------------------------------------------------------------------------
def llama_projections(torch, cfg, gen):
    """The four packed projections of one LLaMA-7B layer as the main path
    quantizes them (data-free, QKV and gate+up fused)."""
    from repro_torch.core.qlinear import (QuantConfig, quantize_linear,
                                          quantize_linear_group)
    qcfg = QuantConfig(ratio=0.2, multiple=16)
    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.n_heads * cfg.head_dim_
    kvd = cfg.n_kv_heads * cfg.head_dim_

    def w(k, n):
        return (torch.randn((k, n), generator=gen, device="cuda")
                / math.sqrt(k)).to(torch.bfloat16)

    return {
        "wqkv": quantize_linear_group([w(d, hd), w(d, kvd), w(d, kvd)],
                                      None, qcfg).inner,
        "wgu": quantize_linear_group([w(d, f), w(d, f)], None, qcfg).inner,
        "wo": quantize_linear(w(hd, d), None, qcfg),
        "wd": quantize_linear(w(f, d), None, qcfg),
    }


def check_mixed_matmul(torch, projs, timer, peaks, gen, ms=(1, 8, 64),
                       host: bool = False):
    """Each projection of ``projs`` at each row count of ``ms`` against
    the plain version, timed beside it, dense ``torch.matmul`` and the
    bound; with ``host``, also the host µs of one call (``host_us``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.mixed_matmul import mixed_matmul
    rows = []
    for m in ms:
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
            if host:
                row["host_us"] = host_call_us(
                    torch, lambda: mixed_matmul(*args, perm=q.perm),
                    calls=10, batches=5)
            del dense
            rows.append(row)
    return rows


def qwen3_projections(torch, cfg, gen):
    """The five distinct packed shapes of one unfused qwen3-4b layer as
    data-free PTQ1.61 quantizes them (wk and wv share one shape, wg and
    wu another)."""
    from repro_torch.core.qlinear import QuantConfig, quantize_linear
    qcfg = QuantConfig(ratio=0.2, multiple=16)
    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.n_heads * cfg.head_dim_
    kvd = cfg.n_kv_heads * cfg.head_dim_

    def w(k, n):
        return (torch.randn((k, n), generator=gen, device="cuda")
                / math.sqrt(k)).to(torch.bfloat16)

    return {name: quantize_linear(w(k, n), None, qcfg)
            for name, k, n in (("wq", d, hd), ("wk", d, kvd), ("wo", hd, d),
                               ("wg", d, f), ("wd", f, d))}


def print_rows(tag: str, what: str, rows, ms) -> None:
    """One ``[tag M=m]`` line per row count of ``ms``: the summed kernel,
    dense ``torch.matmul`` and bound times of ``what``, then the rows."""
    for m in ms:
        at = [r for r in rows if r["M"] == m]
        print(f"[{tag} M={m}] (tolerance rtol {MM_RTOL}, atol {MM_ATOL}) "
              f"{what}: kernel {sum(r['ms'] for r in at) * 1e3:.1f} us, "
              f"dense bf16 torch.matmul "
              f"{sum(r['library_ms'] for r in at) * 1e3:.1f} us, bound "
              f"{sum(r['bound_ms'] for r in at) * 1e3:.1f} us; "
              + json.dumps(at), flush=True)


# Ragged and one-sided shapes the packing allows: (K, N, k_s) with k_s
# even and k_b a multiple of 8, spans not multiples of the 16-channel
# k-step, N not a multiple of 16, and empty spans.
RAGGED = [(1032, 130, 208), (256, 96, 48), (4096, 200, 816), (128, 40, 24),
          (64, 32, 0), (64, 32, 64), (8, 16, 0), (2, 16, 2), (3286, 130, 6)]


def _packed_operands(torch, gen, k, n, k_s):
    """Random packed operands of a (K, N) projection with k_s int4
    channels (either span may be empty), and a permutation."""
    k_b = k - k_s
    u8 = dict(dtype=torch.uint8, device="cuda", generator=gen)
    return dict(
        w4=torch.randint(0, 256, (k_s // 2, n), **u8),
        s4=0.001 + 0.01 * torch.rand(k_s, device="cuda", generator=gen),
        z4=torch.randint(0, 16, (k_s,), device="cuda",
                         generator=gen).float(),
        bits=torch.randint(0, 256, (k_b // 8, n), **u8),
        alpha_s=0.01 + torch.rand(n, device="cuda", generator=gen),
        alpha_r1=0.5 + torch.rand(n, device="cuda", generator=gen),
        alpha_r2=0.5 + torch.rand(k_b, device="cuda", generator=gen),
        perm=torch.randperm(k, device="cuda", generator=gen).to(torch.int32))


def check_ragged(torch, projs, gen):
    """The packed matmul against its plain version at RAGGED shapes and
    M = 3, 17, 100 (M = 100 takes two 64-row groups); binary_matmul and
    int4_matmul at one-sided spans; two calls on the same inputs give the
    same bits (split-K shapes of the main path)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.binary_matmul import binary_matmul
    from repro_torch.kernels.int4_matmul import int4_matmul
    from repro_torch.kernels.mixed_matmul import mixed_matmul
    worst = 0.0
    cases = 0
    for k, n, k_s in RAGGED:
        ops = _packed_operands(torch, gen, k, n, k_s)
        for m in (3, 17, 100):
            x = torch.randn((m, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            y = mixed_matmul(x, **ops)
            y_ref = ref.mixed_matmul_ref(x, **ops)
            torch.cuda.synchronize()
            err = (y.float() - y_ref).abs().max().item()
            if not torch.allclose(y.float(), y_ref, rtol=MM_RTOL,
                                  atol=MM_ATOL):
                _fail(f"mixed_matmul ragged K={k} N={n} k_s={k_s} M={m}: "
                      f"max_abs_err {err}")
            worst, cases = max(worst, err), cases + 1
            xs = x[:, :k_s].contiguous()
            xb = x[:, k_s:].contiguous()
            a_out = (ops["alpha_s"] * ops["alpha_r1"]).contiguous()
            spans = []
            if k_s:
                spans.append((int4_matmul(xs, ops["w4"], ops["s4"],
                                          ops["z4"]),
                              ref.int4_matmul_ref(xs.float(), ops["w4"],
                                                  ops["s4"], ops["z4"])))
            if k - k_s:
                spans.append((binary_matmul(xb, ops["bits"], a_out,
                                            ops["alpha_r2"]),
                              ref.binary_matmul_ref(xb.float(), ops["bits"],
                                                    a_out, ops["alpha_r2"])))
            for got, want in spans:
                err = (got.float() - want).abs().max().item()
                if not torch.allclose(got.float(), want, rtol=MM_RTOL,
                                      atol=MM_ATOL):
                    _fail(f"span kernel ragged K={k} N={n} k_s={k_s} M={m}:"
                          f" max_abs_err {err}")
                worst, cases = max(worst, err), cases + 1
    repeats = {}
    for name, m in (("wo", 8), ("wd", 1), ("wqkv", 64)):
        q = projs[name]
        x = torch.randn((m, q.k), generator=gen, device="cuda").to(
            torch.bfloat16)
        args = (x, q.w4, q.s4, q.z4, q.bits, q.alpha_s, q.alpha_r1,
                q.alpha_r2)
        same = torch.equal(mixed_matmul(*args, perm=q.perm),
                           mixed_matmul(*args, perm=q.perm))
        if not same:
            _fail(f"mixed_matmul {name} M={m}: a repeated call gave other "
                  "bits")
        repeats[f"{name}/M={m}"] = same
    return {"cases": cases, "max_abs_err": worst, "bit_identical": repeats,
            "shapes": RAGGED, "M": [3, 17, 100]}


def host_call_us(torch, fn, calls: int = 50, batches: int = 20) -> float:
    """Host µs of one call, enqueue only: the median over ``batches`` of
    ``calls`` calls each, the card synchronized between batches, so the
    launch queue never fills and the host never waits for the card."""
    for _ in range(10):
        fn()
    times = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    times.sort()
    return 0.5 * (times[(batches - 1) // 2] + times[batches // 2])


def host_us(torch, projs, gen):
    """Host time of one call for mixed_matmul and for torch.matmul of the
    same shape (wqkv, M = 8)."""
    from repro_torch.kernels.mixed_matmul import mixed_matmul
    q = projs["wqkv"]
    x = torch.randn((8, q.k), generator=gen, device="cuda").to(torch.bfloat16)
    dense = q.to_dense(torch.bfloat16)
    fns = {"mixed_matmul": lambda: mixed_matmul(
               x, q.w4, q.s4, q.z4, q.bits, q.alpha_s, q.alpha_r1,
               q.alpha_r2, perm=q.perm),
           "torch.matmul": lambda: torch.matmul(x, dense)}
    return {"shape": f"wqkv M=8 K={q.k} N={q.n}",
            "us_per_call": {name: host_call_us(torch, fn)
                            for name, fn in fns.items()}}


# CUDA kernel names -> the short names a split of device time reports
KERNEL_PARTS = (("gather_kernel", "gather"), ("packed_matmul_kernel", "matmul"),
                ("fold_kernel", "fold"), ("combine_splits_kernel", "combine"),
                ("paged_attention_kernel", "attention"),
                ("paged_prefill", "prefill"))


def device_us(torch, fn, calls: int = 10) -> dict:
    """Device µs per call of each CUDA kernel that one call of ``fn``
    launches, by short name (``KERNEL_PARTS``), from ``torch.profiler``
    over ``calls`` calls, each after the timer's L2 flush (whose kernel
    is left out)."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")

    def kernel_events(f, n):
        f()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                flush.zero_()
                f()
            torch.cuda.synchronize()
        return [e for e in prof.events() if e.device_type.name == "CUDA"]

    skip = {e.name for e in kernel_events(lambda: None, 2)}
    per = {}
    for e in kernel_events(fn, calls):
        if e.name in skip:
            continue
        key = next((v for k, v in KERNEL_PARTS if k in e.name),
                   e.name.split("(")[0])
        per[key] = per.get(key, 0.0) + (e.time_range.end
                                        - e.time_range.start)
    return {k: v / calls for k, v in per.items()}


def kernel_split_us(torch, projs, gen, calls: int = 10):
    """Device µs per call of each CUDA kernel that one packed-matmul call
    launches (the gather by perm, the matmul, the fold of split-K
    partial sums), at the 12 fused shapes (``device_us``)."""
    from repro_torch.kernels.mixed_matmul import mixed_matmul
    rows = []
    for m in (1, 8, 64):
        for name, q in projs.items():
            x = torch.randn((m, q.k), generator=gen, device="cuda").to(
                torch.bfloat16)
            rows.append({"proj": name, "M": m, "us": device_us(
                torch, lambda: mixed_matmul(
                    x, q.w4, q.s4, q.z4, q.bits, q.alpha_s, q.alpha_r1,
                    q.alpha_r2, perm=q.perm), calls)})
    return rows


def check_gather(torch, projs, split, timer, peaks, gen) -> list:
    """The salient-first gather of a packed-matmul call (the TPU
    kernel's ``perm`` path) at decode, M = 8, per fused projection: its
    device time (``gather`` of ``kernel_split_us``), the plain gather
    ``x[:, perm]`` and ``torch.index_select`` timed on the same inputs,
    and its bound (x and perm read once, the gathered x written once).
    Its output is held through the product in ``check_mixed_matmul``."""
    rows = []
    for name, q in projs.items():
        x = torch.randn((8, q.k), generator=gen, device="cuda").to(
            torch.bfloat16)
        perm = q.perm.long()
        kernel_us = next(r["us"]["gather"] for r in split
                         if r["proj"] == name and r["M"] == 8)
        b, by = bound_ms(2 * x.numel() * 2 + q.perm.numel() * 4, 0.0, peaks)
        rows.append({"proj": name, "M": 8, "K": q.k, "ms": kernel_us / 1e3,
                     "plain_ms": timer.ms(lambda: x[:, perm]),
                     "library_ms": timer.ms(
                         lambda: torch.index_select(x, 1, perm)),
                     "bound_ms": b, "bound_by": by})
    return rows


def call_profile(torch, fn) -> dict:
    """Host µs of one call, the device µs of each kernel it launches,
    and whether a second call gives the same bits."""
    torch.cuda.synchronize()
    same = torch.equal(fn(), fn())
    return {"host_us": host_call_us(torch, fn), "device_us": device_us(
        torch, fn), "bit_identical": same}


def attention_plans(torch, cfg) -> dict:
    """The split plans of the attention kernels at the serving shapes
    (8 slots, max_seq 512, pages of 16, prefill chunk 64) and at the
    shapes ``check_paged_attention`` and ``check_paged_prefill`` use,
    with the blocks an SM holds (CUDA occupancy query)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_prefill as pf
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    rep = hq // hkv
    return {
        "resident_blocks_per_sm": {
            "paged_attention_bf16": pa.resident_blocks(0, True, rep, dh),
            "paged_prefill_bf16": pf.resident_blocks(0, dh)},
        "paged_attention": {
            f"B=8 nblk={n}": pa.launch_plan(8, hkv, rep, dh, n, 16, True,
                                            0)._asdict() for n in (32, 64)},
        "paged_prefill": {
            "C=64 nblk=32": pf.launch_plan(64, hq, hkv, dh, 32, 16,
                                           0)._asdict()}}


def check_spans(torch, projs, timer, peaks, gen):
    """binary_matmul and int4_matmul on the binary and int4 spans of the
    main path's wqkv and wd, at M = 1, 8 and 64."""
    from repro_torch.core import pack
    from repro_torch.kernels import ref
    from repro_torch.kernels.binary_matmul import binary_matmul
    from repro_torch.kernels.int4_matmul import int4_matmul
    rows = {"binary_matmul": [], "int4_matmul": []}
    for m in (1, 8, 64):
        for name in ("wqkv", "wd"):
            q = projs[name]
            a_out = (q.alpha_s * q.alpha_r1).contiguous()
            cases = {
                "binary_matmul": (
                    binary_matmul, ref.binary_matmul_ref, q.k_b,
                    (q.bits, a_out, q.alpha_r2),
                    lambda: pack.unpack_bits(q.bits, axis=-2,
                                             dtype=torch.bfloat16),
                    q.bits.numel() + (q.n + q.k_b) * 4),
                "int4_matmul": (
                    int4_matmul, ref.int4_matmul_ref, q.k_s,
                    (q.w4, q.s4, q.z4),
                    lambda: q.dequant_salient(torch.bfloat16),
                    q.w4.numel() + 2 * q.k_s * 4),
            }
            for kname, (fn, plain, k, wargs, dense_fn, wbytes) in \
                    cases.items():
                x = torch.randn((m, k), generator=gen, device="cuda").to(
                    torch.bfloat16)
                y = fn(x, *wargs)
                y_ref = plain(x.float(), *wargs)
                torch.cuda.synchronize()
                err = (y.float() - y_ref).abs().max().item()
                ok = torch.allclose(y.float(), y_ref, rtol=MM_RTOL,
                                    atol=MM_ATOL)
                row = {"proj": name, "M": m, "K": k, "N": q.n,
                       "max_abs_err": err, "ok": bool(ok)}
                if not ok:
                    _fail(f"{kname} {row}")
                dense = dense_fn()
                nbytes = m * k * 2 + wbytes + m * q.n * 2
                b, by = bound_ms(nbytes, 2.0 * m * k * q.n, peaks)
                row.update(
                    ms=timer.ms(lambda: fn(x, *wargs)),
                    plain_ms=timer.ms(lambda: plain(x, *wargs)),
                    library_ms=timer.ms(lambda: torch.matmul(x, dense)),
                    bound_ms=b, bound_by=by, bytes=nbytes)
                del dense
                rows[kname].append(row)
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


def check_paged_attention(torch, cfg, timer, peaks, gen,
                          lens=(1000, 777, 513, 300, 129, 64, 17, 0),
                          window=None, freed=(0, 20), f32: bool = False):
    """The decode kernel at ``cfg``'s heads over 8 slots of ``lens``
    keys (pages of 16; page ``freed`` (slot, block) of the table set to
    -1) with ``window``, against its plain version in bf16 (and with
    ``f32`` in f32 too), timed beside the plain version and SDPA over
    the gathered context under the same mask."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention
    lens = list(lens)
    b, ps, dh = len(lens), 16, cfg.head_dim_
    hkv, rep = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    q, kp, vp, bt = _paged_case(torch, gen, b, hkv, rep, dh, ps, lens,
                                torch.bfloat16)
    bt[freed] = -1                                  # freed page mid-table
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    errs = {}
    for dtype in (torch.bfloat16,) + ((torch.float32,) if f32 else ()):
        args = (q.to(dtype), kp.to(dtype), vp.to(dtype), bt, lens_t)
        o = paged_attention(*args, window=window)
        o_ref = ref.paged_attention_ref(*args, window=window)
        torch.cuda.synchronize()
        err = errs[str(dtype).split(".")[-1]] = (o - o_ref).abs().max().item()
        if not torch.allclose(o, o_ref, rtol=ATT_RTOL, atol=ATT_ATOL):
            _fail(f"paged_attention ({dtype}, rep {rep}, dh {dh}) "
                  f"max_abs_err={err}")
        for i, n in enumerate(lens):
            if n == 0 and o[i].abs().max().item() != 0.0:
                _fail("paged_attention: a row of length 0 must be zeros")
    # live keys: those inside each slot's window, minus the freed page's
    first = [max(n - window, 0) if window else 0 for n in lens]
    live = sum(n - f for n, f in zip(lens, first))
    fi, fj = freed
    live -= max(0, min((fj + 1) * ps, lens[fi]) - max(fj * ps, first[fi]))
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
    if window:
        mask &= pos[None, :] >= lens_t[:, None] - window
    for i, n in enumerate(lens):
        if n == 0:
            mask[i, 0] = True                       # SDPA needs a key
    qs = q.reshape(b, hq, 1, dh)
    call = (lambda: paged_attention(q, kp, vp, bt, lens_t, window=window))
    prof = call_profile(torch, call)
    if not prof["bit_identical"]:
        _fail("paged_attention: a repeated call gave other bits")
    return {"B": b, "hq": hq, "hkv": hkv, "dh": dh, "ps": ps,
            "lens": lens, "window": window, "freed": list(freed),
            "max_abs_err": max(errs.values()), "max_abs_err_by_dtype": errs,
            **prof, "ms": timer.ms(call),
            "plain_ms": timer.ms(
                lambda: ref.paged_attention_ref(q, kp, vp, bt, lens_t,
                                                window=window)),
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
        prof = call_profile(torch, lambda: paged_prefill(
            q, kn, vn, kk, vk, bt, btw, start, length, layer=1))
        if not prof["bit_identical"]:
            _fail(f"paged_prefill: a repeated call gave other bits "
                  f"(start={start})")
        results.append({
            "C": c, "start": start, "length": length, "hq": hq, "hkv": hkv,
            "dh": dh, "ps": ps, "max_abs_err": err, **prof,
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
def _has_recurrence(cfg) -> bool:
    return any(k in KIND_PROJECTIONS for s in cfg.stages for k in s.pattern)


def check_small_reference(torch, registry, arch="llama-7b"):
    """Paged prefill and decode of ``arch`` reduced (f32, data-free
    fused) on the card (kernels) and on the CPU (plain versions) from the
    same weights: the largest logit gap relative to the CPU's magnitude.
    Prefill is chunked, or for a model with recurrent blocks (which
    chunked prefill does not serve) one whole-prompt prefill left-padded
    to 64 and spliced into the pages and slot 0.  An xLSTM model decodes
    each step on the card from the CPU's state of that step: its carried
    state turns an f32 gap of 1e-7 that straddles a bf16 rounding of a
    packed product's input into logits about 1e-2 apart within a few
    steps (measured on the CPU against the JAX package), which says
    nothing of the kernels; from the same state each step compares
    them."""
    from repro_torch.core.pipeline import quantize_params_data_free
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.core.select import map_tree
    from repro_torch.models import model as M
    from repro_torch.models.param import tree_to
    from repro_torch.runtime.paged_cache import (BlockTables, PagePool,
                                                 pages_for_tokens)
    cfg = registry.get(arch).reduced()
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
    xlstm = any(k in ("mlstm", "slstm") for s in cfg.stages
                for k in s.pattern)
    cpu_states = []
    outs = {}
    for dev in ("cpu", "cuda"):
        pd = tree_to(p, dev)
        caches = M.init_paged_caches(cfg, 16, ps, dtype=torch.float32,
                                     device=dev)
        bt = torch.from_numpy(tables.as_array()).to(dev)
        logits = []
        if _has_recurrence(cfg):
            b = 64
            toks = torch.zeros((1, b), dtype=torch.int32)
            toks[0, b - plen:] = seq[:plen]
            pos = torch.arange(b, dtype=torch.int32) - (b - plen)
            pos = torch.where(pos >= 0, pos, -1)[None]
            lg, c1 = M.prefill(cfg, pd, {"tokens": toks.to(dev),
                                         "positions": pos.to(dev)}, 128)
            caches = M.splice_prefill_paged(cfg, caches, c1, 0, bt[0])
            logits.append(lg[:, 0])
        else:
            for start in range(0, plen, chunk):
                length = min(chunk, plen - start)
                toks = torch.zeros((1, chunk), dtype=torch.int32)
                toks[0, :length] = seq[start:start + length]
                lg, caches = M.prefill_step_paged(
                    cfg, pd, toks.to(dev), caches, bt[0], bt[0], start,
                    length)
                logits.append(lg)
        for pos in range(plen, plen + steps):
            if xlstm and dev == "cpu":
                cpu_states.append(map_tree(caches, lambda _, t: t.clone()))
            elif xlstm:
                caches = tree_to(cpu_states[pos - plen], dev)
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


# Engine modes of the small agreement: the contiguous whole-prompt engine
# on the CPU and on the card, and whole-prompt against chunked prefill
# on the card (paged, f32 pools); for a MoE model, whole-prompt and
# chunked paged prefill each on the CPU and on the card.
# The runs with prefix sharing serve prompts with a common 32-token
# (4-page) prefix, on the CPU and on the card, both prefill modes.
SMALL_WHOLE = dict(prefill_buckets=(16, 64))
SMALL_CHUNKED = dict(paged=True, page_size=8, chunked_prefill=True,
                     prefill_chunk=16)
SMALL_SHARED_WHOLE = dict(prefill_buckets=(64, 96), paged=True, page_size=8,
                          prefix_sharing=True)
SMALL_SHARED_CHUNKED = dict(SMALL_CHUNKED, prefix_sharing=True,
                            prefix_retain_pages=8)
SMALL_ENGINE_RUNS = {
    "contiguous/cpu": ("cpu", SMALL_WHOLE),
    "contiguous/cuda": ("cuda", SMALL_WHOLE),
    "paged-whole/cuda": ("cuda", dict(SMALL_WHOLE, paged=True,
                                      page_size=8)),
    "paged-chunked/cuda": ("cuda", SMALL_CHUNKED),
    "paged-whole/cpu": ("cpu", dict(SMALL_WHOLE, paged=True, page_size=8)),
    "paged-chunked/cpu": ("cpu", SMALL_CHUNKED),
    "shared-whole/cpu": ("cpu", SMALL_SHARED_WHOLE),
    "shared-whole/cuda": ("cuda", SMALL_SHARED_WHOLE),
    "shared-chunked/cpu": ("cpu", SMALL_SHARED_CHUNKED),
    "shared-chunked/cuda": ("cuda", SMALL_SHARED_CHUNKED),
}


def small_engine_tokens(torch, names, arch="llama-7b") -> dict:
    """Greedy tokens of ``arch`` reduced in f32, data-free fused,
    served by the engine in each mode ``names`` of SMALL_ENGINE_RUNS: 6
    prompts of 7-60 tokens (with prefix sharing, each after a common
    32-token prefix), 8 new tokens each, 3 slots, max_seq 128.  Every
    request must finish, and with prefix sharing the cache must hit."""
    import numpy as np
    from repro_torch.configs import registry
    from repro_torch.core.pipeline import quantize_params_data_free
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.models import model as M
    from repro_torch.models.param import tree_to
    from repro_torch.runtime.engine import Engine
    cfg = registry.get(arch).reduced()
    p = quantize_params_data_free(
        tree_to(M.init_params(cfg, 0, "cpu"), float_dtype=torch.float32),
        QuantConfig(ratio=0.25, multiple=16), min_dim=32, fuse=True)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32)
               for n in (7, 16, 33, 60, 12, 45)]
    common = rng.integers(1, cfg.vocab, size=32).astype(np.int32)
    toks = {}
    for name in names:
        dev, kw = SMALL_ENGINE_RUNS[name]
        eng = Engine(cfg, tree_to(p, dev), n_slots=3, max_seq=128,
                     cache_dtype=torch.float32, device=dev, **kw)
        sharing = kw.get("prefix_sharing", False)
        reqs = [eng.submit(np.concatenate([common, x]) if sharing else x,
                           max_new=8) for x in prompts]
        eng.run()
        if not all(r.done for r in reqs):
            _fail(f"small engines: {name} left a request unfinished")
        if sharing and eng.prefix_stats()["hits"] == 0:
            _fail(f"small engines: {name} never hit the prefix cache")
        toks[name] = [r.out_tokens for r in reqs]
    return toks


def check_small_engines(torch, arch="llama-7b") -> dict:
    """The contiguous whole-prompt engine gives the same greedy tokens on
    the card and on the CPU, on the card whole-prompt and chunked
    prefill give the same tokens, and the paged engine with prefix
    sharing gives the same tokens on the card and the CPU in both
    prefill modes (``small_engine_tokens``).  A model with recurrent
    blocks runs the whole-prompt modes only, each card against CPU.  A MoE model routes every
    token of a call under a capacity that follows the call's tokens, so
    a whole left-padded bucket and a 16-token chunk drop other slots
    (as in the reference): there, each paged prefill mode is held card
    against CPU instead of whole against chunked."""
    from repro_torch.configs import registry
    cfg = registry.get(arch)
    if _has_recurrence(cfg):
        # whole-prompt modes only (chunked prefill is refused), each held
        # card against CPU
        names = [n for n in SMALL_ENGINE_RUNS if "chunked" not in n]
        toks = small_engine_tokens(torch, names, arch=arch)
        for mode in ("contiguous", "paged-whole", "shared-whole"):
            if toks[f"{mode}/cuda"] != toks[f"{mode}/cpu"]:
                _fail(f"small engines: {mode} greedy tokens differ between "
                      f"the card and the CPU: {toks}")
        return {"requests": len(toks["contiguous/cpu"]), "max_new": 8,
                "tokens": toks}
    moe = cfg.moe is not None
    names = [n for n in SMALL_ENGINE_RUNS
             if moe or n not in ("paged-whole/cpu", "paged-chunked/cpu")]
    toks = small_engine_tokens(torch, names, arch=arch)
    if toks["contiguous/cuda"] != toks["contiguous/cpu"]:
        _fail("small engines: contiguous whole-prompt greedy tokens differ "
              f"between the card and the CPU: {toks}")
    if moe:
        for mode in ("paged-whole", "paged-chunked"):
            if toks[f"{mode}/cuda"] != toks[f"{mode}/cpu"]:
                _fail(f"small engines: {mode} greedy tokens differ between "
                      f"the card and the CPU: {toks}")
    elif toks["paged-chunked/cuda"] != toks["paged-whole/cuda"]:
        _fail("small engines: whole-prompt and chunked prefill give other "
              f"greedy tokens on the card: {toks}")
    for mode in ("shared-whole", "shared-chunked"):
        if toks[f"{mode}/cuda"] != toks[f"{mode}/cpu"]:
            _fail(f"small engines: {mode} greedy tokens differ between the "
                  f"card and the CPU: {toks}")
    return {"requests": len(toks["contiguous/cpu"]), "max_new": 8,
            "tokens": toks}


# The block pattern ``check_small_calibrated`` runs twice, where it is
# not the config's own: xlstm's 8-block pattern twice amplifies a
# one-ulp change of one gate weight to α's 1.3e-2 apart by the 14th block
# (the learning meets ever other streams; measured on the CPU), so the
# card-vs-CPU check calibrates (mlstm, slstm) twice, where the same
# change stays within 5.6e-6.
SMALL_CAL_PATTERN = {XL_ARCH: ("mlstm", "slstm")}


def check_small_calibrated(torch, registry, arch="llama-7b"):
    """Calibrated PTQ1.61 of ``arch`` reduced (its first stage's pattern,
    or ``SMALL_CAL_PATTERN``, twice, f32) on the card and on the CPU from
    the same weights and segments."""
    import dataclasses
    from repro_torch.configs.base import Stage
    from repro_torch.core.pipeline import quantize_model_ptq161
    from repro_torch.core.qlinear import QLinear, QuantConfig
    from repro_torch.core.select import map_tree
    from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
    from repro_torch.models import model as M
    from repro_torch.models.param import tree_to
    cfg = registry.get(arch).reduced()
    pattern = SMALL_CAL_PATTERN.get(arch, cfg.stages[0].pattern)
    cfg = dataclasses.replace(cfg, stages=(Stage(pattern, 2),))
    n_proj = 2 * sum(KIND_PROJECTIONS.get(k, 7) for k in pattern)
    qcfg = QuantConfig(ratio=0.2, multiple=16, steps=3)
    p = tree_to(M.init_params(cfg, 0, "cpu"), float_dtype=torch.float32)
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=0))
    toks = [torch.from_numpy(t) for t, _ in
            corpus.batches(1, 64, 4, split="calib")]
    n_updates = qcfg.steps * len(toks)
    outs = {}
    for name, dev, qc in (("cpu", "cpu", qcfg), ("cuda", "cuda", qcfg),
                          ("unlearned", "cpu", dataclasses.replace(
                              qcfg, learn_scales=False))):
        losses = []
        q = quantize_model_ptq161(cfg, tree_to(p, dev),
                                  [{"tokens": t.to(dev)} for t in toks],
                                  qc, min_dim=32, block_losses=losses)
        leaves = {}
        map_tree(q, lambda path, x: leaves.__setitem__(path, x.map(
            lambda t: t.cpu())) if isinstance(x, QLinear) else x)
        outs[name] = (leaves, losses)
    (a, la), (b, lb) = outs["cuda"], outs["cpu"]
    c = outs["unlearned"][0]
    if a.keys() != b.keys() or len(a) != n_proj:
        _fail("calibrated: card and CPU quantized different projections")
    for k in a:
        if not torch.equal(a[k].perm, b[k].perm):
            _fail(f"calibrated: perm differs at {k}")
        for f in ("w4", "bits"):
            if not torch.equal(getattr(a[k], f), getattr(b[k], f)):
                _fail(f"calibrated: {f} differs at {k}")

    def alpha_gap(u, v):
        """Largest |u − v| / |v| over every learned α."""
        return max((((getattr(u[k], f) - getattr(v[k], f)).abs()
                     / getattr(v[k], f).abs()).max().item())
                   for k in v for f in ("alpha_s", "alpha_r1", "alpha_r2"))
    worst_rel, control_rel = alpha_gap(a, b), alpha_gap(c, b)
    if not worst_rel <= CAL_ALPHA_RTOL:          # NaN fails too
        _fail(f"calibrated: learned scales differ by {worst_rel} "
              f"(relative) > {CAL_ALPHA_RTOL}")
    if control_rel <= CAL_ALPHA_RTOL:
        _fail(f"calibrated: unlearned scales are within {control_rel} of "
              f"the learned ones; the α check cannot tell them apart")
    for (ba, aa), (bb, ab) in zip(la, lb):
        for x, y in ((ba, bb), (aa, ab)):
            if abs(x - y) > CAL_LOSS_RTOL * abs(y):
                _fail(f"calibrated: block loss {x} on the card vs {y}")
    return {"projections": len(a), "updates": n_updates,
            "alpha_max_rel_diff": worst_rel, "alpha_rtol": CAL_ALPHA_RTOL,
            "unlearned_alpha_rel_diff": control_rel,
            "block_losses_card": la, "block_losses_cpu": lb}


def _baseline_layers(torch, q) -> dict:
    """{(layer, block, name): fake-quant weight on the CPU} of a baseline
    driver's result (stacked expert weights included, the router not)."""
    return {(li, blk, name): x.cpu()
            for li, lp in enumerate(q["stages"][0])
            for blk, leaves in lp[0].items() if isinstance(leaves, dict)
            for name, x in leaves.items() if x.ndim >= 2
            and name != "router"}


def _objective(torch, w, wq, h) -> float:
    """GPTQ's calibration objective tr((W − Ŵ)ᵀ H (W − Ŵ)) in f64 (H
    None: the identity)."""
    d = (w.double() - wq.double())
    hd = d if h is None else h.double() @ d
    return float(torch.sum(hd * d))


def _choice(v):
    """A search's pick in comparable form: AWQ's α index, BiLLM's
    (sorted salient rows, split index); a list of them per expert."""
    if isinstance(v, list):
        return [_choice(x) for x in v]
    return v if isinstance(v, int) else (sorted(v[0].tolist()), v[1])


def _choice_row(v):
    """What the report prints of a pick: AWQ's α index, BiLLM's split."""
    if isinstance(v, list):
        return [_choice_row(x) for x in v]
    return v if isinstance(v, int) else v[1]


def check_small_baselines(torch, registry, arch="llama-7b") -> dict:
    """The paper's five 2-bit comparison methods on ``arch`` reduced (2
    layers, f32) on the card and on the CPU from the same weights and
    calibration segments (4 x 64 tokens, min dim 32): RTN, PB-LLM and
    BiLLM leaves identical; BiLLM's salient rows and split and AWQ's α
    index the same (per expert on stacked expert weights); GPTQ's
    objective tr(ΔᵀHΔ) on layer 0, whose input is the same embedding
    gather on both, within BASE_GPTQ_RTOL of the CPU's for every leaf
    (for each expert slice, which GPTQ quantizes under the identity as
    the reference does, tr(ΔᵀΔ))."""
    import dataclasses
    from repro_torch.configs.base import Stage
    from repro_torch.core.baselines.driver import quantize_model_baseline
    from repro_torch.core.calibrate import collect_wrappers
    from repro_torch.core.pipeline import _block_forward
    from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
    from repro_torch.models import model as M
    from repro_torch.models.param import tree_to
    cfg = registry.get(arch).reduced()
    kind = cfg.stages[0].pattern[0]
    cfg = dataclasses.replace(cfg, stages=(Stage((kind,), 2),))
    p = tree_to(M.init_params(cfg, 0, "cpu"), float_dtype=torch.float32)
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=0))
    toks = [torch.from_numpy(t) for t, _ in
            corpus.batches(1, 64, 4, split="calib")]
    block0 = p["stages"][0][0][0]
    hess = {(0,) + k: sw.hessian for k, sw in collect_wrappers(
        _block_forward(cfg, kind), block0,
        [M.embed_tokens(cfg, p, t) for t in toks], min_dim=32,
        collect_hessian=True).items()}
    out = {}
    for method in BASELINES:
        runs = {}
        for dev in ("cpu", "cuda"):
            picked = {}
            q = quantize_model_baseline(
                cfg, tree_to(p, dev), [{"tokens": t.to(dev)} for t in toks],
                method, min_dim=32, choices=picked)
            runs[dev] = (_baseline_layers(torch, q), {
                (k[1],) + k[3:]: _choice(v) for k, v in picked.items()})
        (a, ca), (b, cb) = runs["cuda"], runs["cpu"]
        if a.keys() != b.keys() or len(a) != 14:
            _fail(f"baselines: {method} quantized other leaves on the card")
        differ = sum(int((a[k] != b[k]).sum()) for k in a)
        row = {"leaves": len(a), "elements_differing": differ,
               "elements": sum(a[k].numel() for k in a)}
        if method in ("rtn-2", "pbllm", "billm") and differ:
            _fail(f"baselines: {method} on the card differs from the CPU in "
                  f"{differ} elements")
        if method in ("awq-2", "billm"):
            if ca != cb:
                _fail(f"baselines: {method} chose differently on the card: "
                      f"{ca} vs {cb}")
            row["choices"] = {"/".join(map(str, k)): _choice_row(v)
                              for k, v in cb.items()}
        if method == "gptq-2":
            gaps = {}
            for k, h in hess.items():
                fp_w = block0[k[1]][k[2]]
                if fp_w.ndim == 3:              # experts: the identity
                    for e in range(fp_w.shape[0]):
                        e_a, e_b = (_objective(torch, fp_w[e], x[k][e], None)
                                    for x in (a, b))
                        gaps["/".join(k[1:]) + f"/{e}"] = (e_a - e_b) / e_b
                    continue
                e_a, e_b = (_objective(torch, fp_w, x[k], h) for x in (a, b))
                gaps["/".join(k[1:])] = (e_a - e_b) / e_b
            worst = max(abs(g) for g in gaps.values())
            if not worst <= BASE_GPTQ_RTOL:
                _fail(f"baselines: gptq-2's layer-0 objective on the card is "
                      f"{worst} (relative) from the CPU's: {gaps}")
            row.update(layer0_objective_rel_gap=gaps,
                       objective_rtol=BASE_GPTQ_RTOL)
        out[method] = row
    return out


# ---------------------------------------------------------------------------
# Phases 5 and 6: the data-free main path and the calibrated path
# ---------------------------------------------------------------------------
def llama_7b(registry):
    cfg = registry.get("llama-7b")
    print(f"[main] llama-7b d_model={cfg.d_model} heads={cfg.n_heads} "
          f"kv_heads={cfg.n_kv_heads} head_dim={cfg.head_dim_} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab} layers={cfg.n_layers}",
          flush=True)
    return cfg


def check_bits(qparams, tag: str) -> float:
    from repro_torch.core.bits import model_bits
    rep = model_bits(qparams)
    bits = rep["avg_bits_per_quantized_weight"]
    print(f"[{tag}] {bits:.4f} bits/weight over "
          f"{rep['quantized_weights']:,} weights", flush=True)
    if not 1.5 < bits < 1.75:
        _fail(f"{tag}: bits/weight {bits} outside (1.5, 1.75)")
    return bits


# Engine modes of the serving phases: the main path (paged, chunked
# prefill), and whole-prompt prefill on the contiguous and the paged
# backend, with buckets that hold every prompt of ``serve_prompts``.
CHUNKED = dict(paged=True, chunked_prefill=True, page_size=16,
               prefill_chunk=64)
WHOLE = dict(paged=False, chunked_prefill=False,
             prefill_buckets=(64, 256, 512))
WHOLE_PAGED = dict(WHOLE, paged=True, page_size=16)


def serve_wave(torch, cfg, engine, prompts, kernels, path_kernels, tag: str,
               max_new: int = 32):
    """Serve ``prompts`` on ``engine`` until they drain, with fresh engine
    metrics and every launch count set to 0 just before the run and read
    just after.  Every request must finish with ``max_new`` tokens of
    the vocabulary, and each kernel of ``path_kernels`` must have
    launched.  Returns (the greedy tokens, a summary); on the paged
    backend the summary has this wave's chunk calls and skipped tokens,
    and the engine's prefix counters and peak pages so far."""
    from repro_torch.runtime.metrics import EngineMetrics
    be = engine.backend
    engine.metrics = EngineMetrics()
    calls0 = getattr(be, "prefill_chunk_calls", 0)
    _reset(kernels)
    reqs = [engine.submit(p, max_new=max_new) for p in prompts]
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(kernels)
    if not all(r.done for r in reqs):
        _fail(f"{tag}: not every request finished")
    if any(len(r.out_tokens) != max_new for r in reqs):
        _fail(f"{tag}: a request stopped short of max_new")
    if any(not (0 <= t < cfg.vocab) for r in reqs for t in r.out_tokens):
        _fail(f"{tag}: a generated token lies outside the vocabulary")
    for name in path_kernels:
        if launches[name] <= 0:
            _fail(f"{tag}: kernel {name} was not launched on the path")
    snap = engine.metrics.snapshot()
    steps = snap["phase_step_s"]
    toks = sum(len(r.out_tokens) for r in reqs)
    summary = {
        "requests": len(reqs),
        "prompt_tokens": int(sum(len(p) for p in prompts)),
        "generated_tokens": toks, "wall_s": wall,
        "tokens_per_s": toks / wall,
        "ttft_mean_s": snap.get("ttft_mean_s"),
        "ttft_p95_s": snap.get("ttft_p95_s"),
        "tbt_p50_s": snap.get("tbt_p50_s"), "tbt_p95_s": snap.get("tbt_p95_s"),
        "decode_step_ms": 1e3 * steps["decode"]["mean_s"],
        "decode_steps": steps["decode"]["count"],
        "launches": launches,
    }
    if "prefill_chunk" in steps:
        summary.update(
            prefill_chunk_ms=1e3 * steps["prefill_chunk"]["mean_s"],
            prefill_chunks=steps["prefill_chunk"]["count"])
    if be.name == "paged":
        summary.update(chunk_calls=be.prefill_chunk_calls - calls0,
                       skipped_tokens=snap["prefill_tokens_skipped"],
                       prefix_stats=engine.prefix_stats(),
                       peak_pages=be.pool.stats().peak_in_use)
    return [r.out_tokens for r in reqs], summary


def serve_prompts(torch, cfg, qparams, kernels, path_kernels, tag: str,
                  engine_kw, max_new: int = 32) -> dict:
    """Serve 8 synthetic prompts of 200-400 tokens, 32 new tokens each,
    at 8 slots and max_seq 512, through the engine in the mode
    ``engine_kw`` (``serve_wave``)."""
    import numpy as np
    from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
    from repro_torch.runtime.engine import Engine

    engine = Engine(cfg, qparams, n_slots=8, max_seq=512, seed=0,
                    device="cuda", **engine_kw)
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=0))
    rng = np.random.default_rng(0)
    prompts = [corpus.document(10_000 + i, int(rng.integers(200, 400)))
               for i in range(8)]
    _, run = serve_wave(torch, cfg, engine, prompts, kernels, path_kernels,
                        tag, max_new)
    snap = engine.metrics.snapshot()
    print(f"[{tag} engine_metrics] " + json.dumps(snap), flush=True)
    summary = {
        "layers": cfg.n_layers, "backend": engine.backend.name,
        **{k: run[k] for k in (
            "requests", "prompt_tokens", "generated_tokens", "wall_s",
            "tokens_per_s", "ttft_mean_s", "ttft_p95_s", "tbt_p50_s",
            "tbt_p95_s", "decode_step_ms", "decode_steps", "prefill_chunk_ms",
            "prefill_chunks") if k in run},
        "preemptions": snap["preemptions"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": run["launches"],
    }
    if "prefill_chunk_ms" not in run:
        # the engine times each bucket's first call apart from the rest
        # (it builds nothing: the kernels were built in phase 2)
        shapes = snap["shape_step_s"]
        buckets = sorted({int(key.split("@")[1]) for key in shapes
                          if key.startswith("prefill")})
        summary["prefill_ms_by_bucket"] = {
            b: {"first_ms": 1e3 * shapes[f"prefill_compile@{b}"]["mean_s"],
                "count": 1 + shapes.get(f"prefill@{b}", {}).get("count", 0),
                "mean_ms_after_first": (1e3 * shapes[f"prefill@{b}"]
                                        ["mean_s"] if f"prefill@{b}"
                                        in shapes else None)}
            for b in buckets}
    return engine, summary


def _union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for st, en in sorted(intervals):
        if cur_e is None or st > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = st, en
        else:
            cur_e = max(cur_e, en)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def _kernel_time(prof):
    """Kernel intervals of a ``torch.profiler`` run: the length of their
    union (µs), µs by kind, and the number of kernels."""
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    by_kind = {}
    for e in kernels:
        kind = ("mixed_matmul" if any(k in e.name for k in (
                    "packed_matmul", "gather_kernel", "fold_kernel"))
                else "paged_attention" if any(k in e.name for k in (
                    "paged_attention", "combine_splits"))
                else "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + (e.time_range.end
                                                  - e.time_range.start)
    busy = _union_us([(e.time_range.start, e.time_range.end)
                      for e in kernels])
    return busy, by_kind, len(kernels)


def step_busy_share(torch, step, steps: int = 4) -> dict:
    """Device-busy share of ``steps`` calls of ``step`` (one decode step
    each): timed on the host's clock, then again under torch.profiler
    for the CUDA kernels' intervals; kernel union over wall time, per
    step, with the card synchronized."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    busy_us, by_kind, n = _kernel_time(prof)
    return {"steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
            "kernel_ms_per_step": busy_us / steps / 1e3,
            "device_busy_share": busy_us / wall_us if n else None,
            "kernel_ms_per_step_by_kind": {k: v / steps / 1e3
                                           for k, v in by_kind.items()},
            "kernels_per_step": n / steps}


def decode_busy_share(torch, cfg, engine, steps: int = 4) -> dict:
    """Device-busy share of a data-free decode step at 8 slots: 8 prompts
    of 256 tokens are admitted and prefilled; then ``steps`` engine ticks
    (one batched decode step each) run twice, once timed on the host's
    clock and once under torch.profiler for the CUDA kernels' intervals
    (the profiler slows the host).  The share is the union of the kernel
    intervals over the unprofiled wall time, both per step with the card
    synchronized."""
    from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=1))
    reqs = [engine.submit(corpus.document(20_000 + i, 256),
                          max_new=2 * steps + 4) for i in range(8)]
    while not all(r.out_tokens for r in reqs):
        engine.tick()
    busy = step_busy_share(torch, engine.tick, steps)
    engine.run()
    return {"slots": 8, "context_tokens": 256, **busy}


def prefill_busy_share(torch, cfg, qparams, buckets=(256, 512),
                       calls: int = 3) -> dict:
    """Device-busy share of one whole-prompt prefill (``model.prefill``,
    batch 1, a full bucket of tokens, max_seq 512) per bucket: ``calls``
    prefills timed on the host's clock, each ending synchronized, then
    ``calls`` more under torch.profiler; kernel union over wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as M
    out = {}
    for b in buckets:
        gen = torch.Generator(device="cuda").manual_seed(b)
        batch = {"tokens": torch.randint(1, cfg.vocab, (1, b), generator=gen,
                                         device="cuda", dtype=torch.int32)}

        def fn():
            M.prefill(cfg, qparams, batch, 512)
            torch.cuda.synchronize()

        fn()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        wall_us = (time.perf_counter() - t0) * 1e6
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
        busy_us, by_kind, n = _kernel_time(prof)
        out[b] = {"wall_ms": wall_us / calls / 1e3,
                  "kernel_ms": busy_us / calls / 1e3,
                  "device_busy_share": busy_us / wall_us,
                  "kernel_ms_by_kind": {k: v / calls / 1e3
                                        for k, v in by_kind.items()},
                  "kernels": n / calls}
    return out


def run_main_path(torch, registry, kernels, path_kernels) -> dict:
    from repro_torch.core.pipeline import quantize_params_data_free
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.models import model as M

    cfg = llama_7b(registry)
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
    print(f"[main] init {t_init:.1f}s, data-free fused quantization "
          f"{t_quant:.1f}s", flush=True)
    bits = check_bits(qparams, "main")
    engine, summary = serve_prompts(torch, cfg, qparams, kernels,
                                    path_kernels, "main", CHUNKED)
    summary.update(bits_per_weight=bits, quantize_s=t_quant)
    busy = decode_busy_share(torch, cfg, engine)
    print(f"[main decode busy] {cfg.n_layers} layers: device-busy share "
          f"{busy['device_busy_share']} of a decode step; "
          + json.dumps(busy), flush=True)
    summary["decode_busy"] = busy
    return summary, cfg, qparams


def run_whole_prompt_paths(torch, cfg, qparams, kernels) -> dict:
    """The main phase's data-free model served again with whole-prompt
    prefill, on the contiguous backend and on the paged one."""
    out = {}
    for tag, kw, path in (("whole", WHOLE, ("mixed_matmul",)),
                          ("whole-paged", WHOLE_PAGED,
                           ("mixed_matmul", "paged_attention"))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        engine, out[tag] = serve_prompts(torch, cfg, qparams, kernels, path,
                                         tag, kw)
        out[tag]["decode_busy"] = decode_busy_share(torch, cfg, engine)
        print(f"[{tag}] " + json.dumps(out[tag]), flush=True)
        del engine
    busy = prefill_busy_share(torch, cfg, qparams)
    print("[whole prefill busy] device-busy share of one whole-prompt "
          "prefill by bucket: " + json.dumps(busy), flush=True)
    out["prefill_busy"] = busy
    return out


def run_loss(torch, cfg, qparams) -> dict:
    """``forward_loss`` of the quantized model on 2 x 512 tokens of the
    synthetic corpus (validation split); the loss must be finite."""
    from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
    from repro_torch.models import model as M
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=0))
    toks, tgts = next(corpus.batches(2, 512, 1, split="valid"))
    batch = {"tokens": torch.from_numpy(toks).to("cuda"),
             "targets": torch.from_numpy(tgts).to("cuda")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        loss = float(M.forward_loss(cfg, qparams, batch))
    dt = time.perf_counter() - t0
    if not math.isfinite(loss):
        _fail(f"loss: forward_loss gave {loss}")
    return {"tokens": list(toks.shape), "loss": loss,
            "ln_vocab": math.log(cfg.vocab), "wall_s": dt}


# Prefix sharing on the data-free weights: 8 requests with a common
# 256-token document prefix (16 full pages of 16, 4 chunks of 64) and a
# unique tail of 32-128 tokens.  Retention keeps 96 pages: the 16 common
# pages and at most 8 tail pages of each first-wave request.
SHARED_COMMON = 256
SHARED_RETAIN = 96


def shared_prefix_prompts(cfg, wave: int) -> list:
    """Wave ``wave``'s 8 prompts: ``corpus.document(9_999, 256)`` and a
    tail ``corpus.document(10_000 + 8 * wave + i, 32-128 tokens)``."""
    import numpy as np
    from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=0))
    common = corpus.document(9_999, SHARED_COMMON)
    rng = np.random.default_rng(100 + wave)
    return [np.concatenate([common, corpus.document(
        10_000 + 8 * wave + i, int(rng.integers(32, 129)))])
        for i in range(8)]




def run_shared_prefix(torch, cfg, qparams, kernels) -> dict:
    """``[shared-prefix]``, ``[shared-prefix retain]`` and
    ``[shared-prefix whole-paged]`` on the data-free LLaMA-7B weights."""
    from repro_torch.runtime.engine import Engine
    wave1 = shared_prefix_prompts(cfg, 0)
    wave2 = shared_prefix_prompts(cfg, 1)
    chunk_path = ("mixed_matmul", "paged_attention", "paged_prefill")
    whole_path = ("mixed_matmul", "paged_attention")
    out = {}

    def wave(tag, eng, prompts, path):
        toks, run = serve_wave(torch, cfg, eng, prompts, kernels, path, tag)
        print(f"[{tag}] " + json.dumps(run), flush=True)
        return toks, run

    def engine(kw, **share):
        torch.cuda.empty_cache()
        return Engine(cfg, qparams, n_slots=8, max_seq=512, seed=0,
                      device="cuda", **kw, **share)

    # -- chunked prefill, sharing off then on (with retention) ----------
    toks_off, off = wave("shared-prefix off", engine(CHUNKED), wave1,
                         chunk_path)
    eng = engine(CHUNKED, prefix_sharing=True,
                 prefix_retain_pages=SHARED_RETAIN)
    toks_on, on = wave("shared-prefix", eng, wave1, chunk_path)
    st = on["prefix_stats"]
    same = sum(a == b for a, b in zip(toks_on, toks_off))
    if st["cow_copies"] != 0:
        _fail(f"shared-prefix: {st['cow_copies']} copy-on-write copies")
    if on["skipped_tokens"] != 16 * st["pages_attached"]:
        _fail(f"shared-prefix: {on['skipped_tokens']} tokens skipped for "
              f"{st['pages_attached']} pages attached")
    if not on["chunk_calls"] < off["chunk_calls"]:
        _fail(f"shared-prefix: {on['chunk_calls']} chunk calls, "
              f"{off['chunk_calls']} without sharing")
    if same != len(wave1):
        _fail(f"shared-prefix: bf16 greedy tokens differ from the unshared "
              f"run in {len(wave1) - same} of {len(wave1)} requests")
    out["shared-prefix"] = dict(on, off=off, identical_requests=same)

    # -- a second wave after the first drained: the retained prefix ------
    hits0 = st["hits"]
    _, ret = wave("shared-prefix retain", eng, wave2, chunk_path)
    tails_only = sum(-(-(len(p) - SHARED_COMMON) // 64) for p in wave2)
    if ret["prefix_stats"]["hits"] - hits0 < len(wave2):
        _fail(f"shared-prefix retain: hits rose by "
              f"{ret['prefix_stats']['hits'] - hits0} < {len(wave2)}")
    if ret["chunk_calls"] != tails_only:
        _fail(f"shared-prefix retain: {ret['chunk_calls']} chunk calls, "
              f"the tails alone need {tails_only}")
    if ret["prefix_stats"]["cow_copies"] != 0:
        _fail("shared-prefix retain: copy-on-write copies")
    out["shared-prefix retain"] = dict(ret, tails_only_calls=tails_only,
                                       hits_before=hits0)
    del eng

    # -- whole-prompt prefill on the paged backend -----------------------
    toks_off, off = wave("shared-prefix whole-paged off",
                         engine(WHOLE_PAGED), wave1, whole_path)
    toks_on, on = wave("shared-prefix whole-paged",
                       engine(WHOLE_PAGED, prefix_sharing=True), wave1,
                       whole_path)
    attached = on["prefix_stats"]["pages_attached"]
    want = (len(wave1) - 1) * SHARED_COMMON // 16
    if attached != want:
        _fail(f"shared-prefix whole-paged: {attached} pages attached, "
              f"not {want}")
    if off["peak_pages"] - on["peak_pages"] != want:
        _fail(f"shared-prefix whole-paged: peak pages {on['peak_pages']} "
              f"against {off['peak_pages']} unshared")
    same = sum(a == b for a, b in zip(toks_on, toks_off))
    print(f"[shared-prefix whole-paged] {same} of {len(wave1)} requests "
          "give the same bf16 greedy tokens as the unshared run (not "
          "required: each follower computes its own prompt, at another "
          "left padding than the donor's pages were written at)",
          flush=True)
    out["shared-prefix whole-paged"] = dict(on, off=off,
                                            identical_requests=same)
    return out


PREPROCESS_STEPS = 20


def run_preprocess(torch, cfg, qparams, kernels) -> dict:
    """Restorative-LoRA preprocessing of the bf16 LLaMA-7B weights of
    phase 5 (seed 0) at ``benchmarks/common.py``'s settings (rank 16, lr
    3e-4, 4 x 128-token calib batches, min dim 64) with the steps cut
    from 150 to ``PREPROCESS_STEPS``; W' is quantized data-free with
    fused projections as in phase 5, and its ``forward_loss`` on 2 x 512
    validation tokens is printed beside that of phase 5's quantized
    weights.  The step losses must be finite and the mean of the last 5
    not above the first; both models' bits per weight must lie in
    (1.5, 1.75) and both losses must be finite."""
    from repro_torch.core.pipeline import quantize_params_data_free
    from repro_torch.core.preprocess import (PreprocessConfig,
                                             restorative_lora)
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
    from repro_torch.models import model as M
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=0))
    batches = [{"tokens": torch.from_numpy(t).to("cuda"),
                "targets": torch.from_numpy(g).to("cuda")}
               for t, g in corpus.batches(4, 128, 8, split="calib")]
    pcfg = PreprocessConfig(rank=16, steps=PREPROCESS_STEPS, lr=3e-4)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset(kernels)
    params = M.init_params(cfg, seed=0, device="cuda")
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preprocessed = restorative_lora(
        cfg, params, batches, QuantConfig(ratio=0.2, multiple=16, steps=16),
        pcfg, min_dim=64, losses=losses)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params
    print(f"[preprocess] restorative LoRA, rank {pcfg.rank}, lr {pcfg.lr}, "
          f"{len(batches)} batches of 4 x 128 tokens: {PREPROCESS_STEPS} "
          f"steps (cut from benchmarks/common.py's 150) in {t_pre:.1f}s, "
          f"peak device memory {peak_gb:.1f} GB; step losses "
          + json.dumps(losses), flush=True)
    if not all(math.isfinite(x) for x in losses):
        _fail(f"preprocess: a step loss is not finite: {losses}")
    last = sum(losses[-5:]) / 5
    if not last <= losses[0]:
        _fail(f"preprocess: the mean loss of the last 5 steps {last} is "
              f"above the first step's {losses[0]}")
    qpre = quantize_params_data_free(
        preprocessed, QuantConfig(ratio=0.2, multiple=16), min_dim=32,
        fuse=True)
    del preprocessed
    bits_pre = check_bits(qpre, "preprocess")
    bits_orig = check_bits(qparams, "preprocess original")
    loss_pre = run_loss(torch, cfg, qpre)
    loss_orig = run_loss(torch, cfg, qparams)
    launches = _launches(kernels)
    if launches["mixed_matmul"] <= 0:
        _fail("preprocess: kernel mixed_matmul was not launched")
    del qpre
    return {"steps": PREPROCESS_STEPS, "rank": pcfg.rank, "lr": pcfg.lr,
            "batches": [len(batches), 4, 128],
            "reduced": "steps cut from 150 (benchmarks/common.py) to "
                       f"{PREPROCESS_STEPS}; the paper trains 10K steps on "
                       "RedPajama, here the synthetic corpus",
            "step_losses": losses, "first_loss": losses[0],
            "last5_mean_loss": last, "wall_s": t_pre,
            "peak_mem_gb": peak_gb,
            "bits_preprocessed": bits_pre, "bits_original": bits_orig,
            "loss_preprocessed": loss_pre["loss"],
            "loss_original": loss_orig["loss"],
            "loss_tokens": loss_pre["tokens"], "launches": launches}


def run_baselines(torch, cfg, kernels) -> dict:
    """The paper's Table-1 comparison on LLaMA-7B at full width and
    ``BASELINE_LAYERS`` of its layers: data-free PTQ1.61 at phase 5's
    settings (its bits and loss), then each of BASELINES, quantize the
    bf16 weights of seed 0 of that cut, the baselines through
    ``quantize_model_baseline`` at ``benchmarks/common.py``'s calibration
    settings (32 x 256 synthetic calib tokens, min dim 64), one method's
    tree at a time.  Prints quantize seconds, peak device memory, bits
    per weight and the loss on the ``[loss]`` tokens beside the fp loss
    and the PTQ1.61 loss of the same cut; every loss must be finite.
    On layer 0 (the same embedded stream for every method) GPTQ's
    objective tr(ΔᵀHΔ) must lie below RTN's on every leaf.  The PTQ1.61
    loss runs the packed matmul at ``[loss]``'s shapes before the counts
    start; the fake-quant models run dense matmuls: no kernel of the
    port is launched."""
    from repro_torch.core.baselines.driver import (method_bits,
                                                   quantize_model_baseline)
    from repro_torch.core.calibrate import collect_wrappers
    from repro_torch.core.pipeline import (_block_forward,
                                           quantize_params_data_free)
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
    from repro_torch.models import model as M
    cfg = dataclasses.replace(cfg, stages=tuple(
        dataclasses.replace(s, repeats=BASELINE_LAYERS) for s in cfg.stages))
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=0))
    calib = [{"tokens": torch.from_numpy(t).to("cuda")} for t, _ in
             corpus.batches(1, 256, 32, split="calib")]
    params = M.init_params(cfg, seed=0, device="cuda")
    fp_loss = run_loss(torch, cfg, params)["loss"]
    q = quantize_params_data_free(params, QuantConfig(ratio=0.2, multiple=16),
                                  min_dim=32, fuse=True)
    ptq_bits = check_bits(q, "baselines ptq1.61")
    ptq_loss = run_loss(torch, cfg, q)["loss"]
    del q
    shapes = [tuple(x.shape) for lp in params["stages"][0]
              for leaves in lp[0].values() if isinstance(leaves, dict)
              for x in leaves.values() if x.ndim == 2]
    n_w = sum(k * n for k, n in shapes)
    _reset(kernels)
    rows, layer0 = {}, {}
    for method in BASELINES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q = quantize_model_baseline(cfg, params, calib, method, min_dim=64)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        loss = run_loss(torch, cfg, q)["loss"]
        if method in ("rtn-2", "gptq-2"):
            layer0[method] = q["stages"][0][0][0]
        del q
        rows[method] = {
            "quantize_s": dt, "peak_mem_gb": peak, "loss": loss,
            "bits_4096x4096": method_bits(method),
            "bits_llama_7b": sum(method_bits(method, k, n) * k * n
                                 for k, n in shapes) / n_w}
        print(f"[baselines] {method}: quantized in {dt:.1f}s, peak device "
              f"memory {peak:.1f} GB, {rows[method]['bits_llama_7b']:.4f} "
              f"bits/weight, loss {loss:.4f}", flush=True)
        if not math.isfinite(loss):
            _fail(f"baselines: {method}'s loss is {loss}")
    launches = _launches(kernels)
    if any(launches.values()):
        _fail(f"baselines: fake-quant models launched packed kernels: "
              f"{launches}")
    block0 = params["stages"][0][0][0]
    embedded = [M.embed_tokens(cfg, params, b["tokens"]) for b in calib]
    wrappers = collect_wrappers(_block_forward(cfg, "dense"), block0,
                                embedded, min_dim=64, collect_hessian=True)
    objective = {}
    for (blk, name), sw in wrappers.items():
        e = {m: _objective(torch, block0[blk][name], layer0[m][blk][name],
                           sw.hessian) for m in layer0}
        objective[f"{blk}/{name}"] = e
        if not e["gptq-2"] < e["rtn-2"]:
            _fail(f"baselines: gptq-2's layer-0 objective on {blk}/{name} "
                  f"is not below rtn-2's: {e}")
    del params, layer0, wrappers, embedded
    return {"methods": rows, "layers": cfg.n_layers, "fp_loss": fp_loss,
            "ptq161_datafree_loss": ptq_loss,
            "ptq161_datafree_bits": ptq_bits,
            "calibration": {"segments": 32, "seq": 256, "min_dim": 64},
            "layer0_objective": objective, "launches": launches}


def run_serve_default(torch, kernels) -> dict:
    """``repro_torch.launch.serve.run`` at the reference's defaults (the
    contiguous backend, whole-prompt prefill, buckets (16, 64) at
    max_seq 128): LLaMA-7B data-free with fused projections, 8 new
    tokens per request; it builds and quantizes its own weights."""
    from repro_torch.launch.serve import parse_args, run
    _reset(kernels)
    out = run(parse_args(["--arch", "llama-7b", "--quantize", "datafree",
                          "--fused", "--max-new", "8"]))
    launches = _launches(kernels)
    if not out["all_done"]:
        _fail("serve-default: not every request finished")
    if out["cache_backend"] != "contiguous":
        _fail(f"serve-default: backend {out['cache_backend']}")
    if launches["mixed_matmul"] <= 0:
        _fail("serve-default: kernel mixed_matmul was not launched")
    m = out["engine_metrics"]
    return {"requests": out["requests"],
            "generated_tokens": out["generated_tokens"],
            "tokens_per_s": out["tokens_per_s"],
            "bits_per_weight": out["bits_per_weight"],
            "cache_backend": out["cache_backend"],
            "ttft_mean_s": m["ttft_mean_s"], "tbt_p50_s": m["tbt_p50_s"],
            "phase_step_s": m["phase_step_s"], "launches": launches}


def run_serve_share_prefix(torch, kernels) -> dict:
    """``repro_torch.launch.serve.run`` with the paged chunked-prefill
    engine and ``--share-prefix --prefix-retain 16`` at max_seq 512 (a
    64-token common prefix by the reference's rule): every request must
    finish, the prefix cache must hit, and no page is copied."""
    from repro_torch.launch.serve import parse_args, run
    _reset(kernels)
    out = run(parse_args(["--arch", "llama-7b", "--quantize", "datafree",
                          "--fused", "--paged", "--chunked-prefill",
                          "--share-prefix", "--prefix-retain", "16",
                          "--max-seq", "512", "--max-new", "8"]))
    launches = _launches(kernels)
    st = out["prefix_sharing"]
    if not out["all_done"]:
        _fail("serve-share-prefix: not every request finished")
    if not st or st["hits"] <= 0 or st["cow_copies"] != 0:
        _fail(f"serve-share-prefix: prefix counters {st}")
    for name in ("mixed_matmul", "paged_attention", "paged_prefill"):
        if launches[name] <= 0:
            _fail(f"serve-share-prefix: kernel {name} was not launched")
    m = out["engine_metrics"]
    return {"requests": out["requests"],
            "generated_tokens": out["generated_tokens"],
            "tokens_per_s": out["tokens_per_s"],
            "bits_per_weight": out["bits_per_weight"],
            "prefix_sharing": st,
            "prefill_tokens_skipped": m["prefill_tokens_skipped"],
            "prefill_chunks": m["prefill_chunks"],
            "ttft_mean_s": m["ttft_mean_s"], "tbt_p50_s": m["tbt_p50_s"],
            "launches": launches}


def run_calibrated_path(torch, registry, kernels, path_kernels, peaks
                        ) -> dict:
    """LLaMA-7B quantized with calibrated PTQ1.61 at the serve defaults
    of ``repro_torch.launch.serve`` (4 segments of 64 tokens, 3 epochs,
    ratio 0.2, multiple 16, min dim 32); its first layer's 7 packed
    projections held against the plain version and timed; then served."""
    from repro_torch.core.pipeline import quantize_model_ptq161
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
    from repro_torch.launch.serve import parse_args
    from repro_torch.models import model as M

    d = parse_args([])
    qcfg = QuantConfig(ratio=d.ratio, multiple=d.multiple, steps=d.opt_steps)
    cfg = llama_7b(registry)
    params = M.init_params(cfg, seed=0, device="cuda")
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=0))
    calib = [{"tokens": torch.from_numpy(t).to("cuda")} for t, _ in
             corpus.batches(1, d.calib_seq, d.calib_segments,
                            split="calib")]
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = quantize_model_ptq161(cfg, params, calib, qcfg,
                                    min_dim=d.min_dim,
                                    attn_chunk=d.attn_chunk,
                                    block_losses=losses)
    del params
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    print(f"[calibrated] {len(losses)} blocks quantized in {t_quant:.1f}s "
          f"(block losses computed before and after learning included); "
          f"Eq.-7 loss first block {losses[0][0]:.6f} -> "
          f"{losses[0][1]:.6f}, last block {losses[-1][0]:.6f} -> "
          f"{losses[-1][1]:.6f}", flush=True)
    for name, (before, after) in (("first", losses[0]),
                                  ("last", losses[-1])):
        if not after <= before:
            _fail(f"calibrated: learning raised the {name} block's loss "
                  f"({before} -> {after})")
    bits = check_bits(qparams, "calibrated")
    layer = {name: qparams["stages"][0][0][0][blk][name]
             for blk, names in (("attn", ("wq", "wk", "wv", "wo")),
                                ("mlp", ("wg", "wu", "wd")))
             for name in names}
    timer = Timer(torch)
    cal_mm = check_mixed_matmul(torch, layer, timer, peaks,
                                torch.Generator(device="cuda").manual_seed(2))
    del timer
    print("[calibrated mixed_matmul] " + json.dumps(cal_mm), flush=True)
    _, summary = serve_prompts(torch, cfg, qparams, kernels, path_kernels,
                               "calibrated", CHUNKED)
    summary["layer0_mixed_matmul"] = cal_mm
    summary.update(
        bits_per_weight=bits, quantize_s=t_quant,
        calibration={"segments": d.calib_segments, "seq": d.calib_seq,
                     "steps": d.opt_steps, "ratio": d.ratio,
                     "multiple": d.multiple,
                     "reduced": "4 synthetic segments x 64 tokens, 3 "
                                "epochs (the paper: 128 x 2048 WikiText2 "
                                "tokens, 20 epochs)"},
        block_loss_first=losses[0], block_loss_last=losses[-1],
        blocks_improved=sum(a <= b for b, a in losses),
        blocks=len(losses))
    return summary


# ---------------------------------------------------------------------------
# Phase 8: the MoE block kind at full width and depth
# ---------------------------------------------------------------------------


def granite(registry):
    cfg = registry.get(MOE_ARCH)
    m = cfg.moe
    print(f"[moe] {MOE_ARCH} d_model={cfg.d_model} heads={cfg.n_heads} "
          f"kv_heads={cfg.n_kv_heads} head_dim={cfg.head_dim_} "
          f"experts={m.n_experts} top_k={m.top_k} expert d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab} layers={cfg.n_layers}", flush=True)
    return cfg


def _packed_shapes(qparams) -> list:
    """(slices, K, N) of every packed weight of a model: a stacked expert
    weight counts its E slices."""
    from repro_torch.core.qlinear import QLinear, QLinearGroup
    from repro_torch.core.select import map_tree
    shapes = []

    def visit(_, x):
        q = x.inner if isinstance(x, QLinearGroup) else x
        if isinstance(q, QLinear):
            shapes.append((math.prod(q.bits.shape[:-2]), q.k, q.n))
        return x
    map_tree(qparams, visit)
    return shapes


def check_moe_bits(qparams, ratio: float, multiple: int, tag: str) -> dict:
    """``model_bits`` against the paper's App.-A form written out over
    the model's packed shapes, with the salient count the structured
    mask rounds to (``saliency.round_salient``): they must agree.  The
    App.-A worked form (``bits.paper_closed_form``, k_s = ⌊ratio·K⌋)
    over the same shapes is printed beside them."""
    from repro_torch.core.bits import SCALE_BITS, paper_closed_form
    from repro_torch.core.saliency import round_salient

    def form(k, n, k_s):
        return ((k - k_s) + 4 * k_s) / k + 1 / n + \
            (2 * n + (k - k_s) + 2 * k_s) * SCALE_BITS / (k * n)

    shapes = _packed_shapes(qparams)
    n_w = sum(e * k * n for e, k, n in shapes)
    mask_form = sum(e * k * n * form(k, n, round_salient(k, ratio, multiple))
                    for e, k, n in shapes) / n_w
    paper = sum(e * k * n * paper_closed_form(k, n, ratio).total_bits
                for e, k, n in shapes) / n_w
    bits = check_bits(qparams, tag)
    if abs(bits - mask_form) > 1e-9 * mask_form:
        _fail(f"{tag}: model_bits {bits} differs from the App.-A form "
              f"over the model's shapes, {mask_form}")
    print(f"[{tag} bits] model_bits {bits:.6f} = App.-A form with the "
          f"mask's k_s {mask_form:.6f}; App.-A with k_s = floor({ratio}K) "
          f"{paper:.6f}; shapes (slices, K, N): "
          + json.dumps(sorted(set(shapes))), flush=True)
    return {"bits_per_weight": bits, "app_a_mask_k_s": mask_form,
            "app_a_floor_k_s": paper}


def expert_costs(torch, cfg, qparams, peaks) -> dict:
    """Device time of the expert feed-forward of one 8-slot decode step:
    the dequantization that every call of layer 0's stacked experts
    runs (wgu and wd into ``DequantView``s: the int4 matrix and the
    signs in bf16), and the whole ``apply_moe`` of 8 tokens, each from
    ``device_us`` (L2 flushed), times the layers.  The dequant's bound:
    the packed expert bytes read once and the bf16 weights written
    once."""
    from repro_torch.models import layers as L
    mlp = qparams["stages"][0][0][0]["mlp"]
    qs = (mlp["wgu"].inner, mlp["wd"])
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn((8, 1, cfg.d_model), generator=gen, device="cuda").to(
        torch.bfloat16)
    dq = device_us(torch, lambda: [q.dequant_view(torch.bfloat16)
                                   for q in qs])
    moe = device_us(torch, lambda: L.apply_moe(cfg, mlp, x))
    weights = sum(q.w4.shape[0] * q.k * q.n for q in qs)
    packed = sum(sum(getattr(q, f).numel() * getattr(q, f).element_size()
                     for f in ("perm", "w4", "s4", "z4", "bits", "alpha_s",
                               "alpha_r1", "alpha_r2")) for q in qs)
    b, by = bound_ms(packed + 2 * weights, 0.0, peaks)
    n = cfg.n_layers
    dq_ms, moe_ms = sum(dq.values()) / 1e3, sum(moe.values()) / 1e3
    return {"expert_weights_per_layer": weights,
            "packed_bytes_per_layer": packed,
            "dequant_ms_per_layer": dq_ms, "dequant_ms_per_step": n * dq_ms,
            "dequant_bound_ms_per_step": n * b, "dequant_bound_by": by,
            "dequant_kernels_per_layer": len(dq),
            "apply_moe_ms_per_layer": moe_ms,
            "apply_moe_ms_per_step": n * moe_ms,
            "apply_moe_kernels_per_layer": len(moe)}


def run_moe_path(torch, registry, kernels, path_kernels, peaks):
    """granite-moe-1b-a400m at full width and depth (24 layers, 32
    experts, top-8), random bf16 weights of seed 0, data-free PTQ1.61
    with fused QKV and fused expert gate+up, served through the paged
    chunked-prefill engine (``[moe]``), then with whole-prompt prefill on
    the contiguous backend (``[moe whole]``), and its loss on 2 x 512
    tokens (``[moe loss]``)."""
    from repro_torch.core.pipeline import quantize_params_data_free
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.models import model as M

    cfg = granite(registry)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = quantize_params_data_free(
        params, QuantConfig(ratio=0.2, multiple=16), min_dim=32, fuse=True)
    del params
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    print(f"[moe] data-free fused quantization {t_quant:.2f}s", flush=True)
    bits = check_moe_bits(qparams, 0.2, 16, "moe")
    out = {}
    engine, out["moe"] = serve_prompts(torch, cfg, qparams, kernels,
                                       path_kernels, "moe", CHUNKED)
    out["moe"].update(quantize_s=t_quant, **bits)
    out["moe"]["decode_busy"] = decode_busy_share(torch, cfg, engine)
    del engine
    out["moe"]["expert"] = expert_costs(torch, cfg, qparams, peaks)
    print("[moe] " + json.dumps(out["moe"]), flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine, out["moe whole"] = serve_prompts(
        torch, cfg, qparams, kernels, ("mixed_matmul",), "moe whole", WHOLE)
    out["moe whole"]["decode_busy"] = decode_busy_share(torch, cfg, engine)
    del engine
    print("[moe whole] " + json.dumps(out["moe whole"]), flush=True)
    _reset(kernels)
    out["moe loss"] = run_loss(torch, cfg, qparams)
    out["moe loss"]["launches"] = _launches(kernels)
    if out["moe loss"]["launches"]["mixed_matmul"] <= 0:
        _fail("moe loss: kernel mixed_matmul was not launched")
    print("[moe loss] forward_loss of the data-free granite (with 0.01 x "
          "the load-balancing loss): " + json.dumps(out["moe loss"]),
          flush=True)
    return out, cfg


def run_moe_calibrated(torch, cfg, kernels, path_kernels, peaks) -> dict:
    """granite quantized with calibrated PTQ1.61 at the serve defaults of
    ``repro_torch.launch.serve`` (4 segments of 64 tokens, 3 epochs,
    ratio 0.2, multiple 16, min dim 32); the Eq.-7 loss of every block
    before and after learning (learning must not raise any); its first
    layer's 4 packed attention projections held against the plain
    version and timed; then served through the paged chunked-prefill
    engine."""
    from repro_torch.core.pipeline import quantize_model_ptq161
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
    from repro_torch.launch.serve import parse_args
    from repro_torch.models import model as M

    d = parse_args([])
    qcfg = QuantConfig(ratio=d.ratio, multiple=d.multiple, steps=d.opt_steps)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, seed=0, device="cuda")
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=0))
    calib = [{"tokens": torch.from_numpy(t).to("cuda")} for t, _ in
             corpus.batches(1, d.calib_seq, d.calib_segments,
                            split="calib")]
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = quantize_model_ptq161(cfg, params, calib, qcfg,
                                    min_dim=d.min_dim,
                                    attn_chunk=d.attn_chunk,
                                    block_losses=losses)
    del params
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[moe calibrated] {len(losses)} blocks quantized in "
          f"{t_quant:.1f}s, peak {peak:.2f} GB; Eq.-7 loss before -> after "
          "per block: " + json.dumps(losses), flush=True)
    raised = [i for i, (b, a) in enumerate(losses) if not a <= b]
    if raised:
        _fail(f"moe calibrated: learning raised the loss of blocks {raised}")
    bits = check_moe_bits(qparams, d.ratio, d.multiple, "moe calibrated")
    layer = {name: qparams["stages"][0][0][0]["attn"][name]
             for name in ("wq", "wk", "wv", "wo")}
    timer = Timer(torch)
    cal_mm = check_mixed_matmul(torch, layer, timer, peaks,
                                torch.Generator(device="cuda").manual_seed(9))
    del timer
    print("[moe calibrated mixed_matmul] " + json.dumps(cal_mm), flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, summary = serve_prompts(torch, cfg, qparams, kernels, path_kernels,
                               "moe calibrated", CHUNKED)
    summary.update(
        quantize_s=t_quant, quantize_peak_gb=peak, block_losses=losses,
        blocks=len(losses), layer0_mixed_matmul=cal_mm, **bits,
        calibration={"segments": d.calib_segments, "seq": d.calib_seq,
                     "steps": d.opt_steps, "ratio": d.ratio,
                     "multiple": d.multiple})
    return summary


def run_model_baselines(torch, cfg, kernels, ptq_bits: float,
                        ptq_loss: float, tag: str,
                        methods=MOE_BASELINES) -> dict:
    """``methods`` on ``cfg``'s bf16 weights of seed 0 at full width and
    depth through ``quantize_model_baseline`` (per expert on stacked
    expert weights) at ``run_baselines``' calibration settings: quantize
    seconds, peak device memory, bits per weight over the model's
    quantizable leaves (each expert slice a (K, N) matrix) and the loss
    on the tokens of ``run_loss`` beside the fp loss and the data-free
    PTQ1.61 loss; every loss finite and no packed kernel launched."""
    from repro_torch.core.baselines.driver import (method_bits,
                                                   quantize_model_baseline)
    from repro_torch.core.select import is_quantizable, map_tree
    from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
    from repro_torch.models import model as M
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=0))
    calib = [{"tokens": torch.from_numpy(t).to("cuda")} for t, _ in
             corpus.batches(1, 256, 32, split="calib")]
    params = M.init_params(cfg, seed=0, device="cuda")
    fp_loss = run_loss(torch, cfg, params)["loss"]
    shapes = []
    map_tree(params["stages"], lambda path, x: shapes.append(
        (math.prod(x.shape[:-2]), x.shape[-2], x.shape[-1]))
        if is_quantizable(path, x, 64) else None)
    n_w = sum(e * k * n for e, k, n in shapes)
    _reset(kernels)
    rows = {}
    for method in methods:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q = quantize_model_baseline(cfg, params, calib, method, min_dim=64)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        loss = run_loss(torch, cfg, q)["loss"]
        del q
        rows[method] = {
            "quantize_s": dt, "peak_mem_gb": peak, "loss": loss,
            "bits_per_weight": sum(method_bits(method, k, n) * e * k * n
                                   for e, k, n in shapes) / n_w}
        print(f"[{tag} baselines] {method}: quantized in {dt:.1f}s, peak "
              f"device memory {peak:.2f} GB, "
              f"{rows[method]['bits_per_weight']:.4f} bits/weight, loss "
              f"{loss:.4f}", flush=True)
        if not math.isfinite(loss):
            _fail(f"{tag} baselines: {method}'s loss is {loss}")
    launches = _launches(kernels)
    if any(launches.values()):
        _fail(f"{tag} baselines: fake-quant models launched packed "
              f"kernels: {launches}")
    del params
    return {"methods": rows, "fp_loss": fp_loss, "ptq161_datafree_loss":
            ptq_loss, "ptq161_datafree_bits": ptq_bits,
            "quantized_weights": n_w,
            "calibration": {"segments": 32, "seq": 256, "min_dim": 64},
            "launches": launches}


# ---------------------------------------------------------------------------
# Phase 9: the hybrid block kinds (rglru and windowed local) at full width
# and depth
# ---------------------------------------------------------------------------
def recurrentgemma(registry):
    cfg = registry.get(RG_ARCH)
    kinds = [k for s in cfg.stages for _ in range(s.repeats)
             for k in s.pattern]
    print(f"[rg] {RG_ARCH} d_model={cfg.d_model} heads={cfg.n_heads} "
          f"kv_heads={cfg.n_kv_heads} head_dim={cfg.head_dim_} "
          f"d_ff={cfg.d_ff} ({cfg.act}) rnn_width={cfg.rnn_width} "
          f"vocab={cfg.vocab} tied={cfg.tied_embeddings} "
          f"layers={cfg.n_layers} ({kinds.count('rglru')} rglru, "
          f"{kinds.count('local')} local, window {cfg.local_window})",
          flush=True)
    return cfg


def rg_projections(torch, cfg, gen):
    """The seven packed projections of recurrentgemma-2b as the data-free
    fused path quantizes them: a local block's wqkv (K 2560, N 3072) and
    wo, an rglru block's w_x, w_gate and w_out (2560 x 2560 each, never
    fused, as in the reference), and every block's wgu (2560 -> 15360)
    and wd (7680 -> 2560)."""
    from repro_torch.core.qlinear import (QuantConfig, quantize_linear,
                                          quantize_linear_group)
    qcfg = QuantConfig(ratio=0.2, multiple=16)
    d, f, r = cfg.d_model, cfg.d_ff, cfg.rnn_width
    hd = cfg.n_heads * cfg.head_dim_
    kvd = cfg.n_kv_heads * cfg.head_dim_

    def w(k, n):
        return (torch.randn((k, n), generator=gen, device="cuda")
                / math.sqrt(k)).to(torch.bfloat16)

    return {
        "wqkv": quantize_linear_group([w(d, hd), w(d, kvd), w(d, kvd)],
                                      None, qcfg).inner,
        "wo": quantize_linear(w(hd, d), None, qcfg),
        "w_x": quantize_linear(w(d, r), None, qcfg),
        "w_gate": quantize_linear(w(d, r), None, qcfg),
        "w_out": quantize_linear(w(r, d), None, qcfg),
        "wgu": quantize_linear_group([w(d, f), w(d, f)], None, qcfg).inner,
        "wd": quantize_linear(w(f, d), None, qcfg),
    }


def window_pages(n: int, window: int, ps: int = 16):
    """(pages a slot of ``n`` live tokens holds, pages its window of
    ``window`` keys reads) on pages of ``ps``."""
    first = max(n - window, 0) // ps
    return -(-n // ps), (n - 1) // ps - first + 1


def run_rg_path(torch, registry, kernels, peaks):
    """recurrentgemma-2b at full width and depth (26 layers: 18 rglru, 8
    local with a 2048-key window; 2.69 B parameters), random bf16
    weights of seed 0, data-free PTQ1.61 with fused QKV and gate+up:
    served with whole-prompt prefill on the paged pool (``[rg]``, the
    decode attention of the local blocks through ``paged_attention``)
    and on the contiguous rings (``[rg contiguous]``), the prompts of
    phase 5; then ``[rg long]``: 4 prompts of 2100-3000 tokens at
    max_seq 4096, where the window cuts keys off, on both backends;
    ``[rg loss]`` on 2 x 512 tokens; ``[rg serve]``,
    ``launch.serve.run --arch recurrentgemma-2b --quantize datafree
    --fused --paged``; and chunked prefill refused with the reference's
    ValueError."""
    import numpy as np
    from repro_torch.core.pipeline import quantize_params_data_free
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
    from repro_torch.launch.serve import parse_args, run
    from repro_torch.models import model as M
    from repro_torch.runtime.engine import Engine

    cfg = recurrentgemma(registry)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = quantize_params_data_free(
        params, QuantConfig(ratio=0.2, multiple=16), min_dim=32, fuse=True)
    del params
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    print(f"[rg] data-free fused quantization {t_quant:.2f}s", flush=True)
    bits = check_moe_bits(qparams, 0.2, 16, "rg")
    quantized = sum(e * k * n for e, k, n in _packed_shapes(qparams))
    out = {}
    for tag, kw, path in (("rg", WHOLE_PAGED,
                           ("mixed_matmul", "paged_attention")),
                          ("rg contiguous", WHOLE, ("mixed_matmul",))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        engine, out[tag] = serve_prompts(torch, cfg, qparams, kernels, path,
                                         tag, kw)
        out[tag]["decode_busy"] = decode_busy_share(torch, cfg, engine)
        del engine
        print(f"[{tag}] " + json.dumps(out[tag]), flush=True)
    out["rg"].update(quantize_s=t_quant, quantized_weights=quantized,
                     **bits)

    # the window bites: contexts past 2048 keys
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=2))
    rng = np.random.default_rng(2)
    prompts = [corpus.document(30_000 + i, int(rng.integers(2100, 3000)))
               for i in range(4)]
    for tag, kw, path in (
            ("rg long", dict(paged=True, page_size=16),
             ("mixed_matmul", "paged_attention")),
            ("rg long contiguous", dict(paged=False), ("mixed_matmul",))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        engine = Engine(cfg, qparams, n_slots=4, max_seq=4096, seed=0,
                        prefill_buckets=(2048, 4096), device="cuda", **kw)
        _, wave = serve_wave(torch, cfg, engine, prompts, kernels, path, tag)
        snap = engine.metrics.snapshot()
        shapes = snap["shape_step_s"]
        last = [len(p) + 31 for p in prompts]        # live keys, last step
        out[tag] = {
            "backend": engine.backend.name, "max_seq": 4096,
            "prompt_tokens": [len(p) for p in prompts],
            **{k: wave[k] for k in ("tokens_per_s", "ttft_mean_s",
                                    "ttft_p95_s", "decode_step_ms",
                                    "decode_steps", "launches")},
            "prefill_ms_4096": {
                "first_ms": 1e3 * shapes["prefill_compile@4096"]["mean_s"],
                "mean_ms_after_first": 1e3 * shapes["prefill@4096"]["mean_s"]
                if "prefill@4096" in shapes else None},
            "pages_held_vs_window_read": [window_pages(n, cfg.local_window)
                                          for n in last],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        if engine.backend.name == "paged":
            out[tag]["peak_pages"] = wave["peak_pages"]
        del engine
        print(f"[{tag}] " + json.dumps(out[tag]), flush=True)

    _reset(kernels)
    out["rg loss"] = run_loss(torch, cfg, qparams)
    out["rg loss"]["launches"] = _launches(kernels)
    if out["rg loss"]["launches"]["mixed_matmul"] <= 0:
        _fail("rg loss: kernel mixed_matmul was not launched")
    print("[rg loss] forward_loss of the data-free recurrentgemma-2b: "
          + json.dumps(out["rg loss"]), flush=True)
    try:
        Engine(cfg, qparams, paged=True, chunked_prefill=True, device="cuda")
    except ValueError as e:
        if "recurrent cells carry sequential state" not in str(e):
            _fail(f"rg: chunked prefill refused with another message: {e}")
    else:
        _fail("rg: the engine took chunked prefill on a recurrent model")
    del qparams
    torch.cuda.empty_cache()
    _reset(kernels)
    served = run(parse_args(["--arch", RG_ARCH, "--quantize", "datafree",
                             "--fused", "--paged", "--max-new", "8"]))
    launches = _launches(kernels)
    if not served["all_done"] or served["cache_backend"] != "paged":
        _fail("rg serve: not every request finished on the paged backend")
    for name in ("mixed_matmul", "paged_attention"):
        if launches[name] <= 0:
            _fail(f"rg serve: kernel {name} was not launched")
    m = served["engine_metrics"]
    out["rg serve"] = {k: served[k] for k in (
        "requests", "generated_tokens", "tokens_per_s", "bits_per_weight",
        "cache_backend", "quantize_s")}
    out["rg serve"].update(ttft_mean_s=m["ttft_mean_s"],
                           tbt_p50_s=m["tbt_p50_s"], launches=launches)
    print("[rg serve] " + json.dumps(out["rg serve"]), flush=True)
    return out, cfg


def run_rg_calibrated(torch, cfg, kernels, peaks) -> dict:
    """recurrentgemma-2b quantized with calibrated PTQ1.61 at the serve
    defaults (the Eq.-7 learning takes its gradients through the RG-LRU
    scan); every block's loss before and after learning (none may rise);
    the unfused projections of its first rglru and first local layer
    held against the plain version at the rows the served path gives
    them (8-slot decode, buckets 256 and 512); then served on the paged
    pool with whole-prompt prefill, as ``[rg]``."""
    from repro_torch.core.pipeline import quantize_model_ptq161
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
    from repro_torch.launch.serve import parse_args
    from repro_torch.models import model as M

    d = parse_args([])
    qcfg = QuantConfig(ratio=d.ratio, multiple=d.multiple, steps=d.opt_steps)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, seed=0, device="cuda")
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=0))
    calib = [{"tokens": torch.from_numpy(t).to("cuda")} for t, _ in
             corpus.batches(1, d.calib_seq, d.calib_segments,
                            split="calib")]
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = quantize_model_ptq161(cfg, params, calib, qcfg,
                                    min_dim=d.min_dim,
                                    attn_chunk=d.attn_chunk,
                                    block_losses=losses)
    del params
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[rg calibrated] {len(losses)} blocks quantized in "
          f"{t_quant:.1f}s, peak {peak:.2f} GB; Eq.-7 loss before -> after "
          "per block: " + json.dumps(losses), flush=True)
    raised = [i for i, (b, a) in enumerate(losses) if not a <= b]
    if raised:
        _fail(f"rg calibrated: learning raised the loss of blocks {raised}")
    bits = check_moe_bits(qparams, d.ratio, d.multiple, "rg calibrated")
    layer0 = qparams["stages"][0][0]
    projs = {f"{kind}.{name}": w for kind, blk in (("rglru", layer0[0]),
                                                   ("local", layer0[2]))
             for part in ("rec", "attn", "mlp") if part in blk
             for name, w in blk[part].items() if hasattr(w, "w4")}
    timer = Timer(torch)
    cal_mm = check_mixed_matmul(torch, projs, timer, peaks,
                                torch.Generator(device="cuda").manual_seed(12),
                                ms=(8, 256, 512))
    del timer
    print("[rg calibrated mixed_matmul] " + json.dumps(cal_mm), flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, summary = serve_prompts(torch, cfg, qparams, kernels,
                               ("mixed_matmul", "paged_attention"),
                               "rg calibrated", WHOLE_PAGED)
    summary.update(
        quantize_s=t_quant, quantize_peak_gb=peak, block_losses=losses,
        blocks=len(losses), layer0_mixed_matmul=cal_mm, **bits,
        calibration={"segments": d.calib_segments, "seq": d.calib_seq,
                     "steps": d.opt_steps, "ratio": d.ratio,
                     "multiple": d.multiple})
    return summary


# ---------------------------------------------------------------------------
# Phase 10: the xLSTM block kinds (mlstm and slstm) at full width and depth
# ---------------------------------------------------------------------------
# phase 10 runs XL_REPEATS of xlstm-1.3b's 6 superblocks (7 mlstm and 1
# slstm each): 16 of its 48 layers, at full width, so that the whole run
# stays well inside its limit with the training phases (976 s with all
# 48 layers, 1075.2 s with 24, NVIDIA H100 80GB HBM3, 700.00 W);
# `[xl serve]` runs launch.serve's own full-depth model
XL_REPEATS = 2


def xlstm(registry):
    full = registry.get(XL_ARCH)
    cfg = dataclasses.replace(full, stages=tuple(
        dataclasses.replace(s, repeats=XL_REPEATS) for s in full.stages))
    kinds = [k for s in cfg.stages for _ in range(s.repeats)
             for k in s.pattern]
    print(f"[xl] {XL_ARCH} d_model={cfg.d_model} heads={cfg.n_heads} "
          f"mlstm_proj_factor={cfg.mlstm_proj_factor} "
          f"slstm_ff={int(round(cfg.slstm_ff_factor * cfg.d_model / 128)) * 128}"
          f" norm={cfg.norm} vocab={cfg.vocab} tied={cfg.tied_embeddings} "
          f"layers={cfg.n_layers} of {full.n_layers} "
          f"({kinds.count('mlstm')} mlstm, {kinds.count('slstm')} slstm)",
          flush=True)
    return cfg


def xl_projections(torch, cfg, gen):
    """The nine packed projections of xlstm-1.3b as data-free PTQ1.61
    quantizes them (none fused, as in the reference): an mlstm block's
    w_q, w_k (2048 x 2048), w_v, w_gate (2048 -> 4096) and w_out (4096 ->
    2048); an slstm block's w_gates (2048 -> 8192), w_up, w_gate (2048 ->
    5504) and w_down (5504 -> 2048)."""
    from repro_torch.core.qlinear import QuantConfig, quantize_linear
    from repro_torch.models.recurrent import init_mlstm, init_slstm
    qcfg = QuantConfig(ratio=0.2, multiple=16)
    out = {}
    for kind, decl in (("mlstm", init_mlstm(cfg)), ("slstm", init_slstm(cfg))):
        for name, p in decl.items():
            if name in ("w_if", "r_gates", "b_gates"):
                continue
            k, n = p.shape
            w = (torch.randn((k, n), generator=gen, device="cuda")
                 / math.sqrt(k)).to(torch.bfloat16)
            out[f"{kind}.{name}"] = quantize_linear(w, None, qcfg)
    return out


def xlstm_costs(torch, cfg, qparams, peaks, slots: int = 8,
                seq: int = 512) -> dict:
    """Device time of the xLSTM cells' plain PyTorch parts: the mLSTM
    state update of one decode step at ``slots`` slots
    (``recurrent.mlstm_state_step_`` on a (B, H, dk, dv) f32 memory; the
    ``Timer``'s CUDA events, L2 flushed, and its kernels by ``device_us``
    without the flush's fill), times the mlstm layers, beside its bound:
    the memory and the normalizer read and written once; and one sLSTM
    scan over a ``seq``-token prefill (``recurrent._slstm_scan`` of the
    first slstm layer at batch 1: kernel time under ``torch.profiler``,
    kernels and the host's wall time), times the slstm layers of one
    prefill."""
    from repro_torch.models import recurrent as R
    kinds = [k for s in cfg.stages for _ in range(s.repeats)
             for k in s.pattern]
    n_m, n_s = kinds.count("mlstm"), kinds.count("slstm")
    gen = torch.Generator(device="cuda").manual_seed(15)
    st = R.init_recurrent_state(cfg, "mlstm", slots, 1, "cuda")
    c, n = st["c"][0], st["n"][0]
    b, h, dk, dv = c.shape
    q, k = (torch.randn((b, h, dk), generator=gen, device="cuda")
            for _ in range(2))
    v = torch.randn((b, h, dv), generator=gen, device="cuda")
    li, lf = (torch.randn((b, h), generator=gen, device="cuda") - 2.0
              for _ in range(2))
    upd_ms = Timer(torch).ms(
        lambda: R.mlstm_state_step_(c, n, q, k, v, li, lf))
    upd = {name: us for name, us in device_us(
        torch, lambda: R.mlstm_state_step_(c, n, q, k, v, li, lf)).items()
        if "FillFunctor<unsigned char>" not in name}
    nbytes = 2 * (c.numel() + n.numel()) * 4
    b_ms, by = bound_ms(nbytes, 0.0, peaks)
    scan_p = next(lp[i]["cell"] for lp in qparams["stages"][0]
                  for i, kd in enumerate(cfg.stages[0].pattern)
                  if kd == "slstm")
    zx = torch.randn((1, seq, 4 * cfg.d_model), generator=gen,
                     device="cuda")
    z = torch.zeros((1, cfg.d_model), device="cuda")
    state = {"h": z, "c": z, "n": z + 1e-6, "m": z}

    def scan():
        R._slstm_scan(cfg, {"r_gates": scan_p["r_gates"],
                            "b_gates": scan_p["b_gates"]}, zx, state)
    scan()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scan()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        scan()
        torch.cuda.synchronize()
    busy_us, _, n_k = _kernel_time(prof)
    return {"mlstm_state_update": {
                "slots": slots, "state_bytes_per_layer": c.numel() * 4,
                "ms_per_layer": upd_ms, "ms_per_step": n_m * upd_ms,
                "bound_ms_per_step": n_m * b_ms, "bound_by": by,
                "kernel_names": len(upd), "us_by_kernel": upd},
            "slstm_scan": {
                "tokens": seq, "kernel_ms": busy_us / 1e3,
                "kernels": n_k, "wall_ms": wall_ms,
                "wall_ms_per_prefill": n_s * wall_ms,
                "kernel_ms_per_prefill": n_s * busy_us / 1e3}}


def _no_attention(tag, launches):
    """An xLSTM path runs no attention kernel: their launches read 0."""
    for name in ("paged_attention", "paged_prefill"):
        if launches[name]:
            _fail(f"{tag}: {name} launched on a model without attention")


def run_xl_path(torch, registry, kernels, peaks):
    """xlstm-1.3b at full width and 16 of its 48 layers (``XL_REPEATS``:
    14 mlstm, 2 slstm; layernorm, vocab 50304, untied head; ``[xl
    serve]`` at all 48), random bf16 weights of seed 0,
    data-free PTQ1.61 (``fuse=True``, which leaves the xLSTM projections
    unfused as in the reference), served with whole-prompt prefill on
    the paged tables (``[xl]``) and on the contiguous backend (``[xl
    contiguous]``) on the prompts of phase 5; the device time of the
    mLSTM state update and of the sLSTM scan (``[xl cells]``); ``[xl
    long]``: 4 prompts of 2100-3000 tokens at max_seq 4096 on 4 paged
    slots; ``[xl loss]`` on 2 x 512 tokens; chunked prefill refused with
    the reference's ValueError; ``[xl serve]``, ``launch.serve.run
    --arch xlstm-1.3b --quantize datafree --fused --paged``.  No path
    launches an attention kernel."""
    import numpy as np
    from repro_torch.core.pipeline import quantize_params_data_free
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
    from repro_torch.launch.serve import parse_args, run
    from repro_torch.models import model as M
    from repro_torch.runtime.engine import Engine

    cfg = xlstm(registry)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = quantize_params_data_free(
        params, QuantConfig(ratio=0.2, multiple=16), min_dim=32, fuse=True)
    del params
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    print(f"[xl] data-free quantization {t_quant:.2f}s", flush=True)
    bits = check_moe_bits(qparams, 0.2, 16, "xl")
    quantized = sum(e * k * n for e, k, n in _packed_shapes(qparams))
    out = {}
    for tag, kw in (("xl", WHOLE_PAGED), ("xl contiguous", WHOLE)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        engine, out[tag] = serve_prompts(torch, cfg, qparams, kernels,
                                         ("mixed_matmul",), tag, kw)
        _no_attention(tag, out[tag]["launches"])
        out[tag]["decode_busy"] = decode_busy_share(torch, cfg, engine)
        del engine
        print(f"[{tag}] " + json.dumps(out[tag]), flush=True)
    out["xl"].update(quantize_s=t_quant, quantized_weights=quantized,
                     **bits)
    cells = xlstm_costs(torch, cfg, qparams, peaks)
    out["xl"]["cells"] = cells
    print("[xl cells] device time of the mLSTM state update of an 8-slot "
          "decode step and of the sLSTM scans of a 512-token prefill: "
          + json.dumps(cells), flush=True)

    # long prompts at a constant state
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=2))
    rng = np.random.default_rng(2)
    prompts = [corpus.document(30_000 + i, int(rng.integers(2100, 3000)))
               for i in range(4)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine = Engine(cfg, qparams, n_slots=4, max_seq=4096, seed=0,
                    prefill_buckets=(2048, 4096), device="cuda", paged=True,
                    page_size=16)
    _, wave = serve_wave(torch, cfg, engine, prompts, kernels,
                         ("mixed_matmul",), "xl long")
    _no_attention("xl long", wave["launches"])
    shapes = engine.metrics.snapshot()["shape_step_s"]
    out["xl long"] = {
        "backend": engine.backend.name, "max_seq": 4096,
        "prompt_tokens": [len(p) for p in prompts],
        **{k: wave[k] for k in ("tokens_per_s", "ttft_mean_s", "ttft_p95_s",
                                "decode_step_ms", "decode_steps",
                                "launches", "peak_pages")},
        "prefill_ms_4096": {
            "first_ms": 1e3 * shapes["prefill_compile@4096"]["mean_s"],
            "mean_ms_after_first": 1e3 * shapes["prefill@4096"]["mean_s"]
            if "prefill@4096" in shapes else None},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del engine
    print("[xl long] " + json.dumps(out["xl long"]), flush=True)

    _reset(kernels)
    out["xl loss"] = run_loss(torch, cfg, qparams)
    out["xl loss"]["launches"] = _launches(kernels)
    if out["xl loss"]["launches"]["mixed_matmul"] <= 0:
        _fail("xl loss: kernel mixed_matmul was not launched")
    print("[xl loss] forward_loss of the data-free xlstm-1.3b: "
          + json.dumps(out["xl loss"]), flush=True)
    try:
        Engine(cfg, qparams, paged=True, chunked_prefill=True, device="cuda")
    except ValueError as e:
        if "recurrent cells carry sequential state" not in str(e):
            _fail(f"xl: chunked prefill refused with another message: {e}")
        print(f"[xl chunked] refused: {e}", flush=True)
    else:
        _fail("xl: the engine took chunked prefill on an xLSTM model")
    del qparams
    torch.cuda.empty_cache()
    _reset(kernels)
    served = run(parse_args(["--arch", XL_ARCH, "--quantize", "datafree",
                             "--fused", "--paged", "--max-new", "8"]))
    launches = _launches(kernels)
    if not served["all_done"] or served["cache_backend"] != "paged":
        _fail("xl serve: not every request finished on the paged backend")
    if launches["mixed_matmul"] <= 0:
        _fail("xl serve: kernel mixed_matmul was not launched")
    _no_attention("xl serve", launches)
    m = served["engine_metrics"]
    out["xl serve"] = {k: served[k] for k in (
        "requests", "generated_tokens", "tokens_per_s", "bits_per_weight",
        "cache_backend", "quantize_s")}
    out["xl serve"].update(ttft_mean_s=m["ttft_mean_s"],
                           tbt_p50_s=m["tbt_p50_s"], launches=launches)
    print("[xl serve] " + json.dumps(out["xl serve"]), flush=True)
    return out, cfg


def run_xl_calibrated(torch, cfg, kernels, peaks) -> dict:
    """xlstm-1.3b quantized with calibrated PTQ1.61 at the serve defaults
    (4 segments of 64 tokens, 3 epochs; the Eq.-7 learning takes its
    gradients through the chunkwise mLSTM and the sLSTM scan's autograd
    Function); every block's loss before and after learning (none may
    rise); the projections of its first mlstm and first slstm layer held
    against the plain version at the rows the served path gives them
    (8-slot decode, buckets 256 and 512); then served on the paged
    tables with whole-prompt prefill, as ``[xl]``."""
    from repro_torch.core.pipeline import quantize_model_ptq161
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
    from repro_torch.launch.serve import parse_args
    from repro_torch.models import model as M

    d = parse_args([])
    qcfg = QuantConfig(ratio=d.ratio, multiple=d.multiple, steps=d.opt_steps)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, seed=0, device="cuda")
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=0))
    calib = [{"tokens": torch.from_numpy(t).to("cuda")} for t, _ in
             corpus.batches(1, d.calib_seq, d.calib_segments,
                            split="calib")]
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = quantize_model_ptq161(cfg, params, calib, qcfg,
                                    min_dim=d.min_dim,
                                    attn_chunk=d.attn_chunk,
                                    block_losses=losses)
    del params
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[xl calibrated] {len(losses)} blocks quantized in "
          f"{t_quant:.1f}s, peak {peak:.2f} GB; Eq.-7 loss before -> after "
          "per block: " + json.dumps(losses), flush=True)
    raised = [i for i, (b, a) in enumerate(losses) if not a <= b]
    if raised:
        _fail(f"xl calibrated: learning raised the loss of blocks {raised}")
    bits = check_moe_bits(qparams, d.ratio, d.multiple, "xl calibrated")
    layer0 = qparams["stages"][0][0]
    pattern = cfg.stages[0].pattern
    projs = {f"{kind}.{name}": w
             for kind in ("mlstm", "slstm")
             for name, w in layer0[pattern.index(kind)]["cell"].items()
             if hasattr(w, "w4")}
    timer = Timer(torch)
    cal_mm = check_mixed_matmul(torch, projs, timer, peaks,
                                torch.Generator(device="cuda").manual_seed(16),
                                ms=(8, 256, 512))
    del timer
    print("[xl calibrated mixed_matmul] " + json.dumps(cal_mm), flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, summary = serve_prompts(torch, cfg, qparams, kernels,
                               ("mixed_matmul",), "xl calibrated",
                               WHOLE_PAGED)
    _no_attention("xl calibrated", summary["launches"])
    summary.update(
        quantize_s=t_quant, quantize_peak_gb=peak, block_losses=losses,
        blocks=len(losses), layer0_mixed_matmul=cal_mm, **bits,
        calibration={"segments": d.calib_segments, "seq": d.calib_seq,
                     "steps": d.opt_steps, "ratio": d.ratio,
                     "multiple": d.multiple})
    return summary


# ---------------------------------------------------------------------------
# Phases 11 and 12: the encoder-decoder and vision-prefix inputs
# ---------------------------------------------------------------------------
def _synced(torch, fn):
    """(fn's result, its wall ms with the card synchronized)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _rel_gap(torch, a, r) -> float:
    """Largest gap of ``a`` (card) from ``r`` (CPU) over the CPU's
    largest magnitude (at least 1)."""
    a, r = a.float().cpu(), r.float().cpu()
    if not torch.isfinite(a).all():
        _fail("non-finite values on the card")
    return (a - r).abs().max().item() / max(1.0, r.abs().max().item())


def check_small_prefix_model(torch, registry, arch: str) -> dict:
    """``arch`` reduced (f32, data-free fused) on the card and on the
    CPU from the same weights: the logits of a whole-prompt ``prefill``
    of 2 rows with its stub input (seamless: 40 frames for its encoder;
    llava: 8 vision embeddings over the first token positions), the
    cross K/V it caches (seamless), and the logits of 4 ``decode_step``s
    over the contiguous rings, each step on the card from the CPU's
    caches of that step (a packed product that rounds its operands to
    bf16 turns an f32 gap of 1e-7 at a rounding boundary into one bf16
    ulp, which the carried caches would keep; from the same caches each
    step compares the kernels).  Every gap relative to the CPU's largest
    magnitude, within ``REF_RTOL``."""
    from repro_torch.core.pipeline import quantize_params_data_free
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.core.select import map_tree
    from repro_torch.models import model as M
    from repro_torch.models.param import tree_to
    cfg = registry.get(arch).reduced()
    p = tree_to(M.init_params(cfg, 0, "cpu"), float_dtype=torch.float32)
    p = quantize_params_data_free(p, QuantConfig(ratio=0.25, multiple=16),
                                  min_dim=32, fuse=True)
    g = torch.Generator().manual_seed(2)
    b, s, steps, max_seq = 2, 45, 4, 64
    seq = torch.randint(1, cfg.vocab, (b, s + steps), generator=g,
                        dtype=torch.int32)
    extra = ({"frames": torch.randn((b, 40, cfg.d_model), generator=g)}
             if cfg.enc_dec else
             {"vision_embeds": 0.02 * torch.randn(
                 (b, cfg.frontend_tokens, cfg.d_model), generator=g)})
    out = {}
    cpu_caches = []
    for dev in ("cpu", "cuda"):
        pd = tree_to(p, dev)
        batch = {"tokens": seq[:, :s].to(dev),
                 **{k: v.to(dev) for k, v in extra.items()}}
        logits, caches = M.prefill(cfg, pd, batch, max_seq)
        res = {"prefill": logits[:, 0]}
        if cfg.enc_dec:
            res.update(xk=caches[0][0]["xk"], xv=caches[0][0]["xv"])
        for i, pos in enumerate(range(s, s + steps)):
            if dev == "cpu":
                cpu_caches.append(map_tree(caches, lambda _, t: t.clone()))
            else:
                caches = tree_to(cpu_caches[i], dev)
            pos_t = torch.full((b,), pos, dtype=torch.int32, device=dev)
            res[f"step{i}"], caches = M.decode_step(
                cfg, pd, seq[:, pos].to(dev), pos_t, caches, max_seq)
        out[dev] = res
    gaps = {k: _rel_gap(torch, out["cuda"][k], out["cpu"][k])
            for k in out["cpu"]}
    if max(gaps.values()) > REF_RTOL:
        _fail(f"{arch} reduced: card vs CPU differ (relative): {gaps}")
    return gaps


def s2t_projections(torch, cfg, gen):
    """seamless-m4t-medium's packed projections as data-free fused
    PTQ1.61 quantizes them: the decoder's fused wqkv (1024 -> 3072) and
    wgu (1024 -> 8192), wo and the cross-attention's four (1024 x 1024),
    wd (4096 -> 1024); the encoder's unfused wq, wk, wv, wo (1024 x
    1024), wg, wu (1024 -> 4096) and wd."""
    from repro_torch.core.qlinear import QuantConfig, quantize_linear
    projs = llama_projections(torch, cfg, gen)
    w = (torch.randn((cfg.d_model, cfg.d_ff), generator=gen, device="cuda")
         / math.sqrt(cfg.d_model)).to(torch.bfloat16)
    projs["enc.wg"] = quantize_linear(w, None, QuantConfig(ratio=0.2,
                                                           multiple=16))
    return projs


def run_s2t_path(torch, registry, kernels, peaks) -> dict:
    """seamless-m4t-medium at full width and depth (12 encoder and 12
    decoder layers with cross-attention; d 1024, 16 heads of 64, gated
    gelu 4096, layernorm, vocab 256206 padded to 256256, untied head),
    random bf16 weights of seed 0, data-free fused PTQ1.61 (the
    decoder's QKV and gate+up fused; the encoder's and the
    cross-attention's projections one by one, as the reference): the
    encoder over ``model.ENC_FRAMES`` stub frames (from the seed) for 8
    rows, ``prefill`` of 8 prompts of ``S2T_PROMPT`` tokens with those frames,
    ``S2T_STEPS`` greedy ``decode_step``s over the rings and the cached
    cross K/V, the device-busy share of 4 more steps, and
    ``forward_loss`` with the frames.  The engine refuses the model, as
    the reference's cannot serve it; every product runs the packed
    matmul, attention is plain PyTorch (ring decode, as the reference's
    XLA)."""
    import numpy as np
    from repro_torch.core.pipeline import quantize_params_data_free
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
    from repro_torch.models import model as M
    from repro_torch.runtime.engine import Engine
    cfg = registry.get(S2T_ARCH)
    print(f"[s2t] {S2T_ARCH} d_model={cfg.d_model} heads={cfg.n_heads} "
          f"kv_heads={cfg.n_kv_heads} head_dim={cfg.head_dim_} "
          f"d_ff={cfg.d_ff} ({cfg.act}) norm={cfg.norm} vocab={cfg.vocab} "
          f"(padded {cfg.vocab_padded}) encoder layers={cfg.n_enc_layers} "
          f"decoder layers={cfg.n_layers}", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, seed=0, device="cuda")
    n_params = _n_params(torch, params)
    qparams, t_quant = _synced(torch, lambda: quantize_params_data_free(
        params, QuantConfig(ratio=0.2, multiple=16), min_dim=32, fuse=True))
    del params
    print(f"[s2t] {n_params:,} parameters; data-free fused quantization "
          f"{t_quant / 1e3:.2f}s", flush=True)
    bits = check_moe_bits(qparams, 0.2, 16, "s2t")
    b, s, steps, n_enc = 8, S2T_PROMPT, S2T_STEPS, M.ENC_FRAMES
    max_seq = s + steps + 8
    gen = torch.Generator(device="cuda").manual_seed(21)
    frames = torch.randn((b, n_enc, cfg.d_model), generator=gen,
                         device="cuda").to(torch.bfloat16)
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=0))
    toks = torch.from_numpy(np.stack([corpus.document(40_000 + i, s)
                                      for i in range(b)])).to("cuda")
    _reset(kernels)
    with torch.no_grad():
        (enc_out, _), enc_ms = _synced(
            torch, lambda: M.encode(cfg, qparams, frames))
        _, enc_ms2 = _synced(torch, lambda: M.encode(cfg, qparams, frames))
        (logits, caches), pre_ms = _synced(torch, lambda: M.prefill(
            cfg, qparams, {"tokens": toks, "frames": frames}, max_seq))
        xk = caches[0][0]["xk"]
        if tuple(xk.shape) != (cfg.n_layers, b, n_enc, cfg.n_kv_heads,
                               cfg.head_dim_):
            _fail(f"s2t: cross K cache of shape {tuple(xk.shape)}")
        tok = logits[:, 0].argmax(-1).to(torch.int32)
        out_toks, step_ms = [], []
        for i in range(steps):
            pos = torch.full((b,), s + i, dtype=torch.int32, device="cuda")
            (lg, caches), ms = _synced(torch, lambda: M.decode_step(
                cfg, qparams, tok, pos, caches, max_seq))
            if not torch.isfinite(lg).all():
                _fail(f"s2t: non-finite logits at decode step {i}")
            tok = lg.argmax(-1).to(torch.int32)
            out_toks.append(tok.cpu())
            step_ms.append(ms)
        launches = _launches(kernels)
        pos = torch.full((b,), s + steps, dtype=torch.int32, device="cuda")
        busy = step_busy_share(torch, lambda: M.decode_step(
            cfg, qparams, tok, pos, caches, max_seq))
        tgts = torch.roll(toks, -1, dims=1)
        tgts[:, -1] = -1
        _reset(kernels)
        loss, loss_ms = _synced(torch, lambda: float(M.forward_loss(
            cfg, qparams, {"tokens": toks, "targets": tgts,
                           "frames": frames})))
        loss_launches = _launches(kernels)
    if any(not (0 <= int(t) < cfg.vocab) for x in out_toks for t in x):
        _fail("s2t: a generated token lies outside the vocabulary")
    if not math.isfinite(loss):
        _fail(f"s2t: forward_loss gave {loss}")
    for tag, n in (("s2t", launches), ("s2t loss", loss_launches)):
        if n["mixed_matmul"] <= 0:
            _fail(f"{tag}: kernel mixed_matmul was not launched")
        if n["paged_attention"] or n["paged_prefill"]:
            _fail(f"{tag}: a paged attention kernel launched off the "
                  "paged path")
    for kw in (dict(), dict(paged=True)):
        try:
            Engine(cfg, qparams, device="cuda", **kw)
        except NotImplementedError as e:
            refused = str(e)
        else:
            _fail(f"s2t: the engine took an encoder-decoder model ({kw})")
    decode_ms = sum(step_ms) / steps
    summary = {
        "layers": {"encoder": cfg.n_enc_layers, "decoder": cfg.n_layers},
        "parameters": n_params, "quantize_s": t_quant / 1e3, **bits,
        "rows": b, "frames": n_enc, "prompt_tokens": s,
        "generated_tokens": b * steps,
        "encode_ms": enc_ms, "encode_ms_second": enc_ms2,
        "prefill_ms": pre_ms, "decode_step_ms": decode_ms,
        "decode_step_ms_first": step_ms[0],
        "tokens_per_s": b * steps / ((pre_ms + sum(step_ms)) / 1e3),
        "decode_tokens_per_s": b * 1e3 / decode_ms,
        "cross_kv_gb": 2 * xk.numel() * xk.element_size() / 1e9,
        "decode_busy": busy, "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "engine_refused": refused}
    print("[s2t] " + json.dumps(summary), flush=True)
    loss_out = {"rows": b, "tokens": s, "frames": n_enc, "loss": loss,
                "ln_vocab": math.log(cfg.vocab), "wall_ms": loss_ms,
                "launches": loss_launches}
    print("[s2t loss] forward_loss of the data-free seamless-m4t-medium "
          "with frames: " + json.dumps(loss_out), flush=True)
    return {"s2t": summary, "s2t loss": loss_out}


def _n_params(torch, tree) -> int:
    from repro_torch.core.select import map_tree
    n = [0]

    def visit(_, x):
        if isinstance(x, torch.Tensor):
            n[0] += x.numel()
        return x
    map_tree(tree, visit)
    return n[0]


def _weight_bytes(qparams) -> int:
    """Bytes a decode step reads of the weights: every packed field of
    every quantized projection, and the head."""
    from repro_torch.core.qlinear import FIELDS, QLinear, QLinearGroup
    from repro_torch.core.select import map_tree
    total = [0]

    def visit(_, x):
        q = x.inner if isinstance(x, QLinearGroup) else x
        if isinstance(q, QLinear):
            total[0] += sum(getattr(q, f).numel() * getattr(q, f)
                            .element_size() for f in FIELDS)
        return x
    map_tree(qparams["stages"], visit)
    head = qparams.get("lm_head", qparams["embed"])
    return total[0] + head.numel() * head.element_size()


def build_vlm(torch, cfg, depth: int):
    """llava-next-34b's data-free fused PTQ1.61 model built one layer at
    a time on the card: each layer's bf16 weights are materialized
    (``materialize`` with the layer's path, so they are those of a
    whole ``init_params``), quantized with QKV and gate+up fused, and
    freed.  Returns (qparams, seconds)."""
    from repro_torch.core.pipeline import quantize_params_data_free
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.models import model as M
    from repro_torch.models.param import materialize
    qcfg = QuantConfig(ratio=0.2, multiple=16)
    decl = M.declare_params(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = materialize({k: v for k, v in decl.items() if k != "stages"},
                          0, "cuda")
    layers = []
    for i, lp in enumerate(decl["stages"][0][:depth]):
        block = materialize(lp, 0, "cuda", prefix=("stages", 0, i))
        layers.append(quantize_params_data_free(
            {"stages": [[block]]}, qcfg, min_dim=32,
            fuse=True)["stages"][0][0])
        del block
    qparams["stages"] = [layers]
    torch.cuda.synchronize()
    return qparams, time.perf_counter() - t0


def run_vlm_path(torch, registry, kernels, path_kernels, peaks) -> dict:
    """llava-next-34b at full width (d 7168, 56/8 heads of 128, d_ff
    20480, vocab 64000, untied head) and ``VLM_DEPTH`` of its 60
    layers, random bf16 weights of seed 0 built and quantized layer by
    layer (``build_vlm``): the model-level ``prefill`` of 8 rows of
    ``VLM_VISION`` stub vision embeddings (from the seed) and
    ``VLM_TEXT`` text tokens, ``VLM_STEPS`` greedy ``decode_step``s
    beside the decode step's weight-read bound, then the engine on text
    prompts (the reference's engine serves no vision embeddings) through
    paged chunked prefill with all three kernels, as phase 5, and its
    decode busy share."""
    import numpy as np
    from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
    from repro_torch.models import model as M
    cfg = registry.get(VLM_ARCH)
    print(f"[vlm] {VLM_ARCH} d_model={cfg.d_model} heads={cfg.n_heads} "
          f"kv_heads={cfg.n_kv_heads} head_dim={cfg.head_dim_} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab} layers={VLM_DEPTH} of "
          f"{cfg.n_layers} (frontend stub: {cfg.frontend_tokens} vision "
          "embeddings)", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    qparams, t_build = build_vlm(torch, cfg, VLM_DEPTH)
    build_peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[vlm] {VLM_DEPTH} layers built and quantized one at a time in "
          f"{t_build:.1f}s, peak {build_peak:.2f} GB", flush=True)
    bits = check_moe_bits(qparams, 0.2, 16, "vlm")
    nbytes = _weight_bytes(qparams)
    bound, _ = bound_ms(nbytes, 0.0, peaks)
    b, ft, s, steps = 8, VLM_VISION, VLM_VISION + VLM_TEXT, VLM_STEPS
    max_seq = s + steps
    gen = torch.Generator(device="cuda").manual_seed(22)
    ve = (0.02 * torch.randn((b, ft, cfg.d_model), generator=gen,
                             device="cuda")).to(torch.bfloat16)
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=0))
    toks = torch.zeros((b, s), dtype=torch.int32)
    toks[:, ft:] = torch.from_numpy(np.stack(
        [corpus.document(50_000 + i, VLM_TEXT) for i in range(b)]))
    toks = toks.to("cuda")
    torch.cuda.reset_peak_memory_stats()
    _reset(kernels)
    with torch.no_grad():
        (logits, caches), pre_ms = _synced(torch, lambda: M.prefill(
            cfg, qparams, {"tokens": toks, "vision_embeds": ve}, max_seq))
        (text_logits, _), _ = _synced(torch, lambda: M.prefill(
            cfg, qparams, {"tokens": toks}, max_seq))
        if torch.equal(logits, text_logits):
            _fail("vlm: the vision embeddings did not reach the logits")
        del text_logits
        tok = logits[:, 0].argmax(-1).to(torch.int32)
        step_ms = []
        for i in range(steps):
            pos = torch.full((b,), s + i, dtype=torch.int32, device="cuda")
            (lg, caches), ms = _synced(torch, lambda: M.decode_step(
                cfg, qparams, tok, pos, caches, max_seq))
            if not torch.isfinite(lg).all():
                _fail(f"vlm: non-finite logits at decode step {i}")
            tok = lg.argmax(-1).to(torch.int32)
            step_ms.append(ms)
    model_launches = _launches(kernels)
    if model_launches["mixed_matmul"] <= 0:
        _fail("vlm model: kernel mixed_matmul was not launched")
    del caches
    model = {"rows": b, "vision_tokens": ft, "text_tokens": VLM_TEXT,
             "prefill_ms": pre_ms, "decode_steps": steps,
             "decode_step_ms": sum(step_ms) / steps,
             "decode_step_ms_first": step_ms[0],
             "weight_bytes_per_step": nbytes,
             "decode_bound_ms": bound,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches": model_launches}
    print(f"[vlm model] prefill of {b} x ({ft} vision + {VLM_TEXT} text) "
          f"in {pre_ms:.1f} ms; decode step {model['decode_step_ms']:.1f} "
          f"ms beside its weight-read bound {bound:.2f} ms "
          f"({nbytes / 1e9:.2f} GB at {peaks[0] / 1e12:.2f} TB/s); "
          + json.dumps(model), flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine, summary = serve_prompts(torch, cfg, qparams, kernels,
                                    path_kernels, "vlm", CHUNKED)
    summary["decode_busy"] = decode_busy_share(torch, cfg, engine)
    summary.update(layers=VLM_DEPTH, build_s=t_build,
                   build_peak_gb=build_peak, decode_bound_ms=bound, **bits)
    print("[vlm] " + json.dumps(summary), flush=True)
    return {"vlm model": model, "vlm": summary}


def run_vlm_serve(torch, kernels) -> dict:
    """``repro_torch.launch.serve.run --arch llava-next-34b --reduced``
    on the card (serve materializes a whole tree: the reduced config),
    fused data-free weights through the paged chunked-prefill engine."""
    from repro_torch.launch.serve import parse_args, run
    _reset(kernels)
    out = run(parse_args(["--arch", VLM_ARCH, "--reduced", "--fused",
                          "--paged", "--chunked-prefill", "--prefill-chunk",
                          "16", "--max-new", "8"]))
    launches = _launches(kernels)
    if not out["all_done"] or out["cache_backend"] != "paged":
        _fail("vlm serve: not every request finished on the paged backend")
    for name in ("mixed_matmul", "paged_attention", "paged_prefill"):
        if launches[name] <= 0:
            _fail(f"vlm serve: kernel {name} was not launched")
    return {k: out[k] for k in ("requests", "generated_tokens",
                                "tokens_per_s", "bits_per_weight",
                                "cache_backend")} | {"launches": launches}


# ---------------------------------------------------------------------------
# Phase 13: training — qwen2.5-3b at full width and depth
# ---------------------------------------------------------------------------
TRAIN_ARCH = "qwen2.5-3b"
TRAIN_ARGS = ["--arch", TRAIN_ARCH, "--steps", "30", "--batch", "8",
              "--seq", "512", "--lr", "3e-4", "--warmup", "5", "--remat",
              "--log-every", "1"]
TRAIN_MB2_ARGS = ["--arch", TRAIN_ARCH, "--steps", "6", "--batch", "8",
                  "--seq", "512", "--lr", "3e-4", "--warmup", "5",
                  "--microbatches", "2", "--compression", "int8", "--remat",
                  "--log-every", "1"]
# [train topk]: top-k compression with one microbatch, so the bf16
# gradients are compressed and written back in place
TRAIN_TOPK_ARGS = ["--arch", TRAIN_ARCH, "--steps", "3", "--batch", "8",
                   "--seq", "512", "--lr", "3e-4", "--warmup", "5",
                   "--compression", "topk", "--remat", "--log-every", "1"]
RESTART_ARGS = ["--arch", "tiny-lm", "--steps", "12", "--batch", "2",
                "--seq", "32", "--log-every", "100", "--save-every", "4"]
# [train restart]: the reference's own bound on the final loss
RESTART_ATOL = 1e-5
# [train reference], card vs CPU over 3 steps of reduced tiny-lm (a
# 3-layer stage, f32; int8 compression with 2 microbatches, and top-k
# with one): losses within 2e-5 and each leaf's update p3 - p0 within
# 2e-3 relative in norm, the bounds tests/test_torch_train.py holds the
# port to the JAX package with (the two devices sum the same f32
# products in other orders).  Parameters: a code flip is an element
# whose compressed gradient parts the card from the CPU at some step by
# more than f32 rounding can, by over half an int8 code step (the
# stacked leaf's largest |value| / 254) or kept by top-k on one side
# and dropped on the other.  On gradients one ulp apart a flip changes
# that element's Adam moments, so its parameter parts by a share of an
# Adam step: each flipped element within 1e-2 (one step at the peak
# lr), at most 1 in 500 elements flipped; every other element within
# 2e-6 (a few f32 ulps at 1).  Measured on an NVIDIA H100 80GB HBM3 at
# 700 W: int8 143 code flips in 176,576 elements (8.1e-4), their gaps
# 2.1e-4 at most, the rest within 2.4e-7; top-k none, all within 6e-8.
TRAIN_LOSS_ATOL, TRAIN_DELTA_RTOL = 2e-5, 2e-3
TRAIN_P_ATOL, TRAIN_FLIP_ATOL, TRAIN_FLIP_FRAC = 2e-6, 1e-2, 2e-3
TRAIN_REF_CASES = (("int8", 2), ("topk", 1))


def _run_train(torch, train, argv, mesh=None) -> tuple:
    """``train.run`` of ``argv`` on the card (under ``mesh`` when given):
    (its result, its per-step losses as the step returned them, the
    step function it built, its state after the last step).  The run's
    log is captured and printed."""
    seen = {}
    orig = train.make_train_step

    def capture(*a, **k):
        fn = orig(*a, **k)

        def step(state, batch):
            out = fn(state, batch)
            seen["fn"], seen["state"] = fn, out[0]
            seen.setdefault("losses", []).append(float(out[1]["loss"]))
            return out
        return step

    buf = io.StringIO()
    train.make_train_step = capture
    try:
        with contextlib.redirect_stdout(buf):
            res = train.run(train.parse_args(argv), mesh=mesh)
    finally:
        train.make_train_step = orig
    sys.stdout.write(buf.getvalue())
    return res, seen["losses"], seen["fn"], seen["state"]


def _batch_on(torch, cfg, args, step: int, device):
    from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=args.seed))
    tok, tgt = next(corpus.batches(args.batch, args.seq, 1, host=step,
                                   n_hosts=1 << 30))
    return {"tokens": torch.from_numpy(tok).to(device),
            "targets": torch.from_numpy(tgt).to(device)}


def _step_ms(torch, fn, state, batch, warm: int, steps: int) -> float:
    """Mean wall ms of ``steps`` train steps after ``warm``, the card
    synchronized (each step reads its loss back, as ``run`` does)."""
    for _ in range(warm):
        state, m = fn(state, batch)
        float(m["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = fn(state, batch)
        float(m["loss"])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


# cuBLAS and CUTLASS kernel names (nvjet: cuBLAS's Hopper GEMMs)
GEMM_NAMES = ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "sm80_",
              "ampere_")


def step_kernel_groups(torch, step, top: int = 8) -> dict:
    """Device ms of one call of ``step`` by kernel: the library GEMMs
    together (cuBLAS / CUTLASS names), then the ``top`` other kernel
    names by time, each with its count."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    gemm = [0.0, 0]
    other = {}
    for e in prof.events():
        if e.device_type.name != "CUDA":
            continue
        us = e.time_range.end - e.time_range.start
        if any(k in e.name.lower() for k in GEMM_NAMES):
            gemm[0] += us
            gemm[1] += 1
        else:
            acc = other.setdefault(e.name[:80], [0.0, 0])
            acc[0] += us
            acc[1] += 1
    ranked = sorted(other.items(), key=lambda kv: -kv[1][0])
    return {"gemm_ms": gemm[0] / 1e3, "gemm_kernels": gemm[1],
            "other_ms": sum(v[0] for v in other.values()) / 1e3,
            "other_kernels": sum(v[1] for v in other.values()),
            "top_other": [{"name": k, "ms": v[0] / 1e3, "count": v[1]}
                          for k, v in ranked[:top]]}


def _no_launches(tag, kernels):
    """The training path reaches no kernel of the port (the reference's
    reaches no Pallas kernel): every launch count reads 0."""
    for name, n in _launches(kernels).items():
        if n:
            _fail(f"{tag}: {name} launched {n} times on the training path")


def run_train(torch, kernels, smi: str) -> dict:
    """``[train]``: ``launch.train.run`` of qwen2.5-3b at full width and
    depth, 30 steps of 8 x 512 tokens with remat; then the same step
    timed on its state, its busy share, and ``[train mb2 int8]``."""
    from repro_torch import pytree
    from repro_torch.configs import registry
    from repro_torch.launch import train
    from repro_torch.models import model as M
    out = {}
    cfg = registry.get(TRAIN_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 1e9
    _reset(kernels)
    t0 = time.perf_counter()
    res, losses, fn, state = _run_train(torch, train, TRAIN_ARGS)
    run_s = time.perf_counter() - t0
    _no_launches("[train]", kernels)
    peak = torch.cuda.max_memory_allocated() / 1e9
    n = sum(t.numel() for t in pytree.leaves(state["params"]))
    declared = sum(math.prod(p.shape) for p in pytree.leaves(
        M.declare_params(cfg)))
    if n != declared:
        _fail(f"[train] {n} parameters trained, {declared} declared")
    if len(losses) != 30 or not all(math.isfinite(x) for x in losses):
        _fail(f"[train] losses not 30 finite values: {losses}")
    if not sum(losses[-5:]) / 5 < losses[0]:
        _fail(f"[train] the last 5 losses' mean is not below the first: "
              f"{losses}")
    args = train.parse_args(TRAIN_ARGS)
    batch = _batch_on(torch, cfg, args, 0, "cuda")
    _reset(kernels)
    ms = _step_ms(torch, fn, state, batch, warm=2, steps=5)
    busy = step_busy_share(torch, lambda: fn(state, batch)[1]["loss"],
                           steps=3)
    groups = step_kernel_groups(torch, lambda: fn(state, batch))
    _no_launches("[train] timing", kernels)
    tokens = args.batch * args.seq
    flops = 6.0 * cfg.n_params() * tokens
    out["train"] = {
        "arch": TRAIN_ARCH, "params": n, "config_params": cfg.n_params(),
        "steps": 30,
        "batch": args.batch, "seq": args.seq, "losses": losses,
        "first_loss": res["first_loss"], "final_loss": res["final_loss"],
        "run_s": run_s, "step_ms": ms, "tokens_per_s": tokens / ms * 1e3,
        "model_tflops": flops / ms / 1e9,
        "model_flop_share_of_989": flops / (ms / 1e3) / 989e12,
        "peak_mem_gb": peak, "allocated_before_gb": before,
        "step_busy_share": busy,
        "step_kernels": groups, "straggler_steps": res["straggler_steps"],
        "launches": _launches(kernels)}
    print(f"[train] {smi}; model FLOPs 6 * config_params * tokens a step "
          "(recomputation not counted) over 989 TFLOP/s: "
          + json.dumps(out["train"]), flush=True)
    del fn, state, batch
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 1e9
    _reset(kernels)
    res, losses, fn, state = _run_train(torch, train, TRAIN_MB2_ARGS)
    _no_launches("[train mb2 int8]", kernels)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if len(losses) != 6 or not all(math.isfinite(x) for x in losses):
        _fail(f"[train mb2 int8] losses not 6 finite values: {losses}")
    args = train.parse_args(TRAIN_MB2_ARGS)
    ms = _step_ms(torch, fn, state, _batch_on(torch, cfg, args, 0, "cuda"),
                  warm=1, steps=3)
    _no_launches("[train mb2 int8] timing", kernels)
    out["train mb2 int8"] = {
        "losses": losses, "step_ms": ms,
        "tokens_per_s": args.batch * args.seq / ms * 1e3,
        "peak_mem_gb": peak, "allocated_before_gb": before,
        "wire_bytes": res["wire_bytes"],
        "uncompressed_wire_bytes": 4 * n, "launches": _launches(kernels)}
    print(f"[train mb2 int8] {smi}: " + json.dumps(out["train mb2 int8"]),
          flush=True)
    params = state["params"]
    del fn, state
    torch.cuda.empty_cache()
    out["train ckpt"] = run_train_ckpt(torch, params)
    print(f"[train ckpt] {smi}: " + json.dumps(out["train ckpt"]),
          flush=True)
    del params
    torch.cuda.empty_cache()
    out["train topk"] = run_train_topk(torch, kernels, cfg)
    print(f"[train topk] {smi}: " + json.dumps(out["train topk"]),
          flush=True)
    return out


def run_train_topk(torch, kernels, cfg) -> dict:
    """``[train topk]``: 3 steps of qwen2.5-3b with top-k compression
    and one microbatch (the bf16 gradients compressed in place), its
    step timed over 2 after 1 of warm-up; and the threshold of the
    largest stacked leaf alone (the embedding, one ``topk`` over vocab
    x d elements) timed on random values."""
    from repro_torch.distributed import compression
    from repro_torch.launch import train
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 1e9
    _reset(kernels)
    res, losses, fn, state = _run_train(torch, train, TRAIN_TOPK_ARGS)
    _no_launches("[train topk]", kernels)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if len(losses) != 3 or not all(math.isfinite(x) for x in losses):
        _fail(f"[train topk] losses not 3 finite values: {losses}")
    args = train.parse_args(TRAIN_TOPK_ARGS)
    ms = _step_ms(torch, fn, state, _batch_on(torch, cfg, args, 0, "cuda"),
                  warm=1, steps=2)
    _no_launches("[train topk] timing", kernels)
    del fn, state
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(0)
    emb = torch.randn(cfg.vocab, cfg.d_model, generator=g, device="cuda")
    thresh = Timer(torch, iters=3).ms(
        lambda: compression._topk_thresh([emb], 0.1))
    del emb
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": ms,
            "tokens_per_s": args.batch * args.seq / ms * 1e3,
            "peak_mem_gb": peak, "allocated_before_gb": before,
            "wire_bytes": res["wire_bytes"],
            "embed_thresh_ms": thresh,
            "embed_elements": cfg.vocab * cfg.d_model,
            "launches": _launches(kernels)}


def run_train_ckpt(torch, params) -> dict:
    """``[train ckpt]``: the full params tree saved by the port's store
    in the reference's layout (stage leaves stacked on the host), then
    restored into a template (meta tensors) onto the card; every leaf
    bit-identical.  In a directory under ``build/`` removed after."""
    import shutil
    import tempfile
    from repro_torch import pytree
    from repro_torch.bridge import params_from_repro, params_to_repro
    from repro_torch.checkpoint.store import (restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.launch.train import _stack_meta, _stack_to_cpu
    (ROOT / "build").mkdir(exist_ok=True)
    d = tempfile.mkdtemp(prefix="train_ckpt_", dir=ROOT / "build")
    try:
        nbytes = sum(t.numel() * t.element_size()
                     for t in pytree.leaves(params))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(d, 30, params_to_repro(params, _stack_to_cpu))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tree, step = restore_checkpoint(d, params_to_repro(params,
                                                           _stack_meta),
                                        device="cuda")
        back = params_from_repro(tree, "cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        files = len(list(Path(d, "step_00000030").glob("leaf_*.npy")))
        for (key, a), b in zip(pytree.leaves_with_path(params),
                               pytree.leaves(back)):
            if a.dtype != b.dtype or not torch.equal(
                    a.view(torch.int16), b.view(torch.int16)):
                _fail(f"[train ckpt] {key} not bit-identical after restore")
        if step != 30:
            _fail(f"[train ckpt] restored step {step}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return {"gb": nbytes / 1e9, "leaf_files": files, "save_s": save_s,
            "save_gb_per_s": nbytes / 1e9 / save_s, "restore_s": load_s,
            "restore_gb_per_s": nbytes / 1e9 / load_s,
            "bit_identical": True}


def run_train_restart(torch, kernels) -> dict:
    """``[train restart]``: the reference's restart test on the card,
    tiny-lm unreduced (a 4-layer stage): 12 steps saving every 4, plain
    and with a failure at step 9; one restart, the final losses within
    the reference's 1e-5."""
    import shutil
    import tempfile
    from repro_torch.launch import train
    (ROOT / "build").mkdir(exist_ok=True)
    d = Path(tempfile.mkdtemp(prefix="train_restart_", dir=ROOT / "build"))
    _reset(kernels)
    try:
        r1 = train.run(train.parse_args(RESTART_ARGS + [
            "--ckpt-dir", str(d / "a")]))
        r2 = train.run(train.parse_args(RESTART_ARGS + [
            "--ckpt-dir", str(d / "b"), "--fail-at-step", "9"]))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    _no_launches("[train restart]", kernels)
    if r1["restarts"] != 0 or r2["restarts"] != 1:
        _fail(f"[train restart] restarts {r1['restarts']}, {r2['restarts']}")
    gap = abs(r1["final_loss"] - r2["final_loss"])
    if not gap <= RESTART_ATOL:
        _fail(f"[train restart] final losses {r1['final_loss']} and "
              f"{r2['final_loss']} part by {gap} > {RESTART_ATOL}")
    return {"final_loss": r1["final_loss"],
            "final_loss_restarted": r2["final_loss"], "gap": gap,
            "bit_identical": r1["final_loss"] == r2["final_loss"],
            "restarts": r2["restarts"]}


def _code_flips(torch, kind: str, card, cpu) -> list:
    """Per parameter, in ``pytree.leaves`` order, the elements whose
    compressed gradient (card tree against CPU tree, both in the port's
    layout) parts by a code flip (see ``TRAIN_P_ATOL``'s comment)."""
    from repro_torch import pytree
    from repro_torch.bridge import layer_groups
    masks = {}
    for ga, gb in zip(layer_groups(card), layer_groups(cpu)):
        pa = list(ga) if isinstance(ga, pytree.Layers) else [ga]
        pb = list(gb) if isinstance(gb, pytree.Layers) else [gb]
        amax = max(float(b.abs().max()) for b in pb)
        for a, b in zip(pa, pb):
            a = a.cpu()
            masks[id(b)] = ((a - b).abs() > amax / 254 if kind == "int8"
                            else (a == 0) != (b == 0))
    return [masks[id(b)] for b in pytree.leaves(cpu)]


def check_train_reference(torch, kind: str = "int8",
                          microbatches: int = 2) -> dict:
    """``[train reference]``: 3 train steps of reduced tiny-lm with a
    3-layer stage in f32 (``kind`` compression, ``microbatches``, remat,
    lr 1e-2, weight decay, clipping, the cosine schedule) on the card
    and on the CPU from the same state: the losses, each leaf's update
    and the parameters within ``TRAIN_*`` (above).  Returns the code
    flips, the gaps of their elements, the largest gap of the rest and
    the largest leaf's update ratio."""
    import dataclasses
    from repro_torch import pytree
    from repro_torch.configs import registry
    from repro_torch.configs.base import Stage
    from repro_torch.distributed.compression import CompressionConfig
    from repro_torch.launch import train
    from repro_torch.models.param import tree_to
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    cfg = dataclasses.replace(registry.get("tiny-lm").reduced(),
                              stages=(Stage(("dense",), 3),))
    opt = AdamW(lr=1e-2, weight_decay=0.01, clip_norm=1.0,
                schedule=cosine_schedule(1, 3))
    ccfg = CompressionConfig(kind=kind)
    cpu = train.init_state(cfg, opt, ccfg, seed=0, device="cpu")
    cpu["params"] = tree_to(cpu["params"], float_dtype=torch.float32)
    p0 = [t.clone() for t in pytree.leaves(cpu["params"])]
    dev = pytree.tree_map(lambda t: t.to("cuda", copy=True), cpu)
    step = train.make_train_step(cfg, opt, ccfg, microbatches=microbatches,
                                 remat=True)
    args = train.parse_args(["--batch", "4", "--seq", "32"])
    sent = []                       # compressed gradients, card then CPU
    orig = train.compress

    def compress(grads, residual, c):
        out = orig(grads, residual, c)
        sent.append(pytree.tree_map(torch.clone, out[0]))
        return out

    gaps = []
    flipped = None
    train.compress = compress
    try:
        for s in range(3):
            b = _batch_on(torch, cfg, args, s, "cpu")
            dev, md = step(dev, {k: v.to("cuda") for k, v in b.items()})
            cpu, mc = step(cpu, b)
            gaps.append(abs(float(md["loss"]) - float(mc["loss"])))
            f = _code_flips(torch, kind, *sent)
            flipped = f if flipped is None else [
                x | y for x, y in zip(flipped, f)]
            sent.clear()
    finally:
        train.compress = orig
    flip_gaps, total, worst, ratio, ratio_key = [], 0, 0.0, 0.0, ""
    for (key, a), b, b0, f in zip(pytree.leaves_with_path(dev["params"]),
                                  pytree.leaves(cpu["params"]), p0, flipped):
        diff = (a.cpu() - b).abs()
        flip_gaps += diff[f].tolist()
        total += diff.numel()
        if (~f).any():
            worst = max(worst, float(diff[~f].max()))
        r = float(torch.linalg.vector_norm(a.cpu() - b)
                  / torch.linalg.vector_norm(b - b0))
        if r > ratio:
            ratio, ratio_key = r, key
    out = {"compression": kind, "microbatches": microbatches,
           "loss_gaps": gaps, "code_flips": len(flip_gaps),
           "elements": total, "flip_gaps": sorted(flip_gaps, reverse=True),
           "max_gap_unflipped": worst, "max_update_ratio": ratio,
           "max_update_ratio_leaf": ratio_key,
           "steps": int(dev["opt"].step)}
    if max(gaps) > TRAIN_LOSS_ATOL:
        _fail(f"[train reference {kind}] card vs CPU losses: {out}")
    if ratio > TRAIN_DELTA_RTOL:
        _fail(f"[train reference {kind}] a leaf's update: {out}")
    if worst > TRAIN_P_ATOL:
        _fail(f"[train reference {kind}] an element without a code flip "
              f"parts by more than {TRAIN_P_ATOL}: {out}")
    if len(flip_gaps) > TRAIN_FLIP_FRAC * total:
        _fail(f"[train reference {kind}] too many code flips: {out}")
    if flip_gaps and max(flip_gaps) > TRAIN_FLIP_ATOL:
        _fail(f"[train reference {kind}] a flipped element parts by more "
              f"than {TRAIN_FLIP_ATOL}: {out}")
    return out


# ---------------------------------------------------------------------------
# Phase 14: training across devices — the sharded step on one NCCL rank
# ---------------------------------------------------------------------------
DIST_ARGS = ["--arch", TRAIN_ARCH, "--steps", "3", "--batch", "8",
             "--seq", "512", "--lr", "3e-4", "--warmup", "1", "--remat",
             "--log-every", "1"]


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _bits_equal(torch, a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def run_dist_train(torch, kernels, smi: str) -> dict:
    """``[dist train]``: qwen2.5-3b at full width and depth, 3 steps of
    8 x 512 tokens from seed 0 (lr 3e-4, warm-up 1, remat), first on one
    device (``launch.train.run`` as ``[train]``), its losses and a host
    copy of its final bf16 params kept and its state freed; then the
    sharded step from the same seed through ``run(args, mesh=...)`` on
    one NCCL rank: a (1, 1) ("data", "model") mesh, ``--fsdp``
    (``Parallel(tp=1, dp=1, fsdp=True, remat=True)``), the state held as
    DTensors.  At one rank every collective is an identity and the local
    products are the one device's, so the losses and params must be the
    same bits; if they part, the losses must lie within 2e-5 and each
    leaf within 2e-3 of its update's norm (the CPU tests' bounds) and
    the line says where.  Both steps are timed on their final states."""
    import torch.distributed as dist
    from repro_torch import pytree
    from repro_torch.configs import registry
    from repro_torch.distributed.sharding import is_dtensor, local
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    cfg = registry.get(TRAIN_ARCH)
    args = train.parse_args(DIST_ARGS)
    batch = _batch_on(torch, cfg, args, 0, "cuda")
    out = {"arch": TRAIN_ARCH, "steps": args.steps, "batch": args.batch,
           "seq": args.seq}

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset(kernels)
    _, losses, fn, state = _run_train(torch, train, DIST_ARGS)
    _no_launches("[dist train] one device", kernels)
    out["one_device"] = {"losses": losses,
                         "peak_mem_gb": torch.cuda.max_memory_allocated()
                         / 1e9}
    ref = [t.detach().to("cpu", copy=True)
           for t in pytree.leaves(state["params"])]
    out["one_device"]["step_ms"] = _step_ms(torch, fn, state, batch,
                                            warm=1, steps=3)
    del fn, state
    torch.cuda.empty_cache()

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        torch.cuda.reset_peak_memory_stats()
        _reset(kernels)
        t0 = time.perf_counter()
        _, dlosses, fn, state = _run_train(torch, train,
                                           DIST_ARGS + ["--fsdp"], mesh=mesh)
        run_s = time.perf_counter() - t0
        launches = _launches(kernels)
        _no_launches("[dist train] sharded", kernels)
        leaves = pytree.leaves(state["params"])
        if not all(is_dtensor(t) for t in leaves):
            _fail("[dist train] the sharded state holds a plain tensor")
        parted = [key for (key, t), r in zip(
            pytree.leaves_with_path(state["params"]), ref)
            if not _bits_equal(torch, local(t), r.to("cuda"))]
        gap = max(float((local(t).float() - r.to("cuda").float()).abs()
                        .max()) for t, r in zip(leaves, ref))
        out["sharded"] = {
            "mesh": [1, 1], "backend": dist.get_backend(), "fsdp": True,
            "losses": dlosses, "run_s": run_s,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches}
        out.update(bit_identical=not parted and dlosses == losses,
                   leaves_parted=len(parted), first_parted=parted[:5],
                   max_param_gap=gap,
                   loss_gaps=[abs(a - b) for a, b in zip(dlosses, losses)])
        if not out["bit_identical"]:
            out["update_ratio"] = _dist_update_ratio(torch, cfg, leaves,
                                                     ref)
        out["sharded"]["step_ms"] = _step_ms(torch, fn, state, batch,
                                             warm=1, steps=3)
        del fn, state, leaves
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    if len(dlosses) != 3 or not all(math.isfinite(x) for x in dlosses):
        _fail(f"[dist train] losses not 3 finite values: {dlosses}")
    if not out["bit_identical"] and (
            max(out["loss_gaps"]) > TRAIN_LOSS_ATOL
            or out["update_ratio"] > TRAIN_DELTA_RTOL):
        _fail(f"[dist train] the sharded step parts from the one device's "
              f"beyond the CPU tests' bounds (losses {TRAIN_LOSS_ATOL}, "
              f"updates {TRAIN_DELTA_RTOL}): {out}")
    return out


def _dist_update_ratio(torch, cfg, leaves, ref) -> float:
    """The largest ||sharded - one device|| / ||one device - initial||
    over the leaves, the initial params made again from seed 0."""
    from repro_torch import pytree
    from repro_torch.distributed.sharding import local
    from repro_torch.models import model as M
    p0 = pytree.leaves(M.init_params(cfg, seed=0, device="cuda"))
    worst = 0.0
    for t, r, a in zip(leaves, ref, p0):
        r = r.to("cuda").float()
        upd = float(torch.linalg.vector_norm(r - a.float()))
        gap = float(torch.linalg.vector_norm(local(t).float() - r))
        worst = max(worst, gap / max(upd, 1e-30))
    return worst


def run_dist_pipeline(torch, kernels) -> dict:
    """``[dist pipeline]``: ``pipeline_apply`` with one stage on the card
    (a one-rank NCCL group, a (1,) "stage" mesh) on the inputs of the
    reference's ``test_pipeline_single_stage_oracle``, against plain
    application: the same bits."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(1, 8, 8)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(3, 4, 8)).astype(np.float32))
    w, x = w.to("cuda"), x.to("cuda")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1,), ("stage",), "cuda")
        _reset(kernels)
        got = pipeline_apply(lambda p, h: torch.tanh(h @ p), w, x, mesh)
        torch.cuda.synchronize()
        launches = _launches(kernels)
        _no_launches("[dist pipeline]", kernels)
    finally:
        dist.destroy_process_group()
    want = torch.stack([torch.tanh(x[i] @ w[0]) for i in range(3)])
    if not torch.equal(got, want):
        _fail(f"[dist pipeline] parts from plain application by "
              f"{float((got - want).abs().max())}")
    return {"stages": 1, "n_micro": 3, "equal": True, "launches": launches}


# ---------------------------------------------------------------------------
# Phase 15: the sharded step of every block kind on one NCCL rank
# ---------------------------------------------------------------------------
# granite at full width and depth through ``run``, 3 steps of 8 x 512
MOE_DIST_ARGS = ["--arch", MOE_ARCH, "--steps", "3", "--batch", "8",
                 "--seq", "512", "--lr", "3e-4", "--warmup", "1", "--remat",
                 "--log-every", "1"]
# the other kinds at full width and one superblock (with seamless, two
# encoder and two decoder layers over stub frames): (tag, arch, config
# overrides, frames per row); 2 steps of 4 x 512 tokens each
KIND_DIST_ROWS, KIND_DIST_SEQ, KIND_DIST_STEPS, KIND_DIST_FRAMES = \
    4, 512, 2, 1024


def _kind_dist_cases():
    from repro_torch.configs.base import Stage
    return (("rg", RG_ARCH, {"stages": (Stage(("rglru", "rglru", "local"),
                                              1), Stage(("rglru",), 1))}, 0),
            ("xl", XL_ARCH, {"stages": (Stage(("mlstm",) * 7 + ("slstm",),
                                              1),)}, 0),
            ("s2t", S2T_ARCH, {"stages": (Stage(("dense",), 2),),
                               "n_enc_layers": 2}, KIND_DIST_FRAMES))


def _kind_batches(torch, cfg, rows, seq, steps, frames):
    """The synthetic corpus's batches of steps 0.. on the card, each with
    ``frames`` bf16 stub frames per row (from a seed) when > 0."""
    from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=0))
    gen = torch.Generator(device="cuda").manual_seed(31)
    out = []
    for s in range(steps):
        tok, tgt = next(corpus.batches(rows, seq, 1, host=s,
                                       n_hosts=1 << 30))
        b = {"tokens": torch.from_numpy(tok).to("cuda"),
             "targets": torch.from_numpy(tgt).to("cuda")}
        if frames:
            b["frames"] = torch.randn((rows, frames, cfg.d_model),
                                      generator=gen, device="cuda").to(
                                          torch.bfloat16)
        out.append(b)
    return out


def _kind_steps(torch, train, cfg, batches, shards=None):
    """``make_train_step`` from seed 0 (lr 3e-4, warm-up 1, remat) over
    ``batches``, on one device or, with ``shards``, from the sharded
    state: (losses, the last step's wall ms, the step, its state)."""
    from repro_torch.distributed.compression import CompressionConfig
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    opt = AdamW(lr=3e-4, weight_decay=0.01, clip_norm=1.0,
                schedule=cosine_schedule(warmup=1, total=len(batches)))
    ccfg = CompressionConfig(kind=None)
    state = (train.init_state(cfg, opt, ccfg, seed=0, device="cuda")
             if shards is None else
             train.init_sharded_state(cfg, opt, ccfg, shards, seed=0))
    fn = train.make_train_step(cfg, opt, ccfg, 1, True, 1024, shards)
    losses, ms = [], 0.0
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = fn(state, b)
        losses.append(float(m["loss"]))
        ms = (time.perf_counter() - t0) * 1e3
    return losses, ms, fn, state


def _held(torch, tag, cfg, losses, dlosses, ref, state) -> dict:
    """The sharded run against the one-device run: the same bits
    expected; where they part, the losses within 2e-5 and each leaf
    within 2e-3 of its update's norm (the CPU tests' bounds), and the
    leaves where they part named."""
    from repro_torch import pytree
    from repro_torch.distributed.sharding import is_dtensor, local
    leaves = pytree.leaves(state["params"])
    if not all(is_dtensor(t) for t in leaves):
        _fail(f"[dist kinds {tag}] the sharded state holds a plain tensor")
    parted = [key for (key, t), r in zip(
        pytree.leaves_with_path(state["params"]), ref)
        if not _bits_equal(torch, local(t), r)]
    out = {"bit_identical": not parted and dlosses == losses,
           "leaves_parted": len(parted), "first_parted": parted[:5],
           "max_param_gap": max(float((local(t).float() - r.float()).abs()
                                      .max()) for t, r in zip(leaves, ref)),
           "loss_gaps": [abs(a - b) for a, b in zip(dlosses, losses)]}
    if len(dlosses) != len(losses) or not all(math.isfinite(x)
                                              for x in dlosses):
        _fail(f"[dist kinds {tag}] losses not finite: {dlosses}")
    if not out["bit_identical"]:
        out["update_ratio"] = _dist_update_ratio(torch, cfg, leaves, ref)
        if max(out["loss_gaps"]) > TRAIN_LOSS_ATOL or \
                out["update_ratio"] > TRAIN_DELTA_RTOL:
            _fail(f"[dist kinds {tag}] the sharded step parts from the one "
                  f"device's beyond the CPU tests' bounds (losses "
                  f"{TRAIN_LOSS_ATOL}, updates {TRAIN_DELTA_RTOL}): {out}")
    return out


@contextlib.contextmanager
def _count_sharded_moe(counts: dict):
    """Count ``layers._moe`` calls with ``shards`` (the group-local MoE
    path of the sharded step) in ``counts["calls"]``."""
    from repro_torch.models import layers as L
    plain = L._moe

    def moe(cfg, p, x, shards=None):
        if shards is not None:
            counts["calls"] += 1
        return plain(cfg, p, x, shards)
    L._moe = moe
    try:
        yield counts
    finally:
        L._moe = plain


def run_dist_kinds(torch, kernels, smi: str) -> dict:
    """``[dist kinds]``: the sharded step of every other block kind as
    one NCCL rank on a (1, 1) ("data", "model") mesh with FSDP, against
    the one-device step from the same seed.  granite-moe-1b-a400m at
    full width and depth: 3 steps of 8 x 512 tokens through
    ``launch.train.run`` (remat), then the sharded step with EP (the
    experts' storage over "model"), whose MoE takes the group-local path
    of ``layers.apply_moe`` (its calls counted, at least one).  Then
    recurrentgemma-2b, xlstm-1.3b and seamless-m4t-medium at full width
    and cut depth (``_kind_dist_cases``): 2 steps of 4 x 512 tokens each
    way.  The same bits are expected (at one rank every collective is an
    identity), else ``_held``'s bounds.  Every launch count reads 0."""
    import torch.distributed as dist
    from repro_torch import pytree
    from repro_torch.configs import registry
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    out = {}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        # granite: one device through run, then the sharded step with EP
        cfg = registry.get(MOE_ARCH)
        args = train.parse_args(MOE_DIST_ARGS)
        batches = [_batch_on(torch, cfg, args, s, "cuda")
                   for s in range(args.steps)]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset(kernels)
        with _count_sharded_moe({"calls": 0}) as counted:
            _, losses, fn, state = _run_train(torch, train, MOE_DIST_ARGS)
        one = {"losses": losses, "moe_sharded_calls": counted["calls"],
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": _launches(kernels)}
        _no_launches("[dist kinds moe] one device", kernels)
        ref = [t.detach().clone() for t in pytree.leaves(state["params"])]
        one["step_ms"] = _step_ms(torch, fn, state, batches[0], warm=1,
                                  steps=3)
        del fn, state
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        par, rules = train.parallel_for(mesh, 1, True, 1024, fsdp=True,
                                        ep=True)
        shards = train.make_shards(cfg, par, mesh, rules)
        _reset(kernels)
        with _count_sharded_moe({"calls": 0}) as counted:
            dlosses, _, fn, state = _kind_steps(torch, train, cfg, batches,
                                                shards)
        calls = counted["calls"]
        sharded = {"losses": dlosses, "moe_sharded_calls": calls,
                   "ep": rules.ep, "fsdp": rules.fsdp,
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "launches": _launches(kernels)}
        _no_launches("[dist kinds moe] sharded", kernels)
        if one["moe_sharded_calls"] or not calls:
            _fail(f"[dist kinds moe] the sharded MoE ran {calls} times in "
                  f"the sharded step and {one['moe_sharded_calls']} on one "
                  "device")
        held = _held(torch, "moe", cfg, losses, dlosses, ref, state)
        sharded["step_ms"] = _step_ms(torch, fn, state, batches[0], warm=1,
                                      steps=3)
        out["moe"] = {"arch": MOE_ARCH, "layers": cfg.n_layers,
                      "rows": args.batch, "seq": args.seq,
                      "one_device": one, "sharded": sharded, **held}
        print(f"[dist kinds moe] {smi}: " + json.dumps(out["moe"]),
              flush=True)
        del fn, state, ref, batches
        torch.cuda.empty_cache()
        # the other kinds at full width, cut depth
        for tag, arch, over, frames in _kind_dist_cases():
            cfg = dataclasses.replace(registry.get(arch), **over)
            batches = _kind_batches(torch, cfg, KIND_DIST_ROWS,
                                    KIND_DIST_SEQ, KIND_DIST_STEPS, frames)
            torch.cuda.reset_peak_memory_stats()
            _reset(kernels)
            losses, ms, fn, state = _kind_steps(torch, train, cfg, batches)
            one = {"losses": losses, "step_ms": ms,
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
            _no_launches(f"[dist kinds {tag}] one device", kernels)
            ref = [t.detach().clone() for t in pytree.leaves(state["params"])]
            del fn, state
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            par, rules = train.parallel_for(mesh, 1, True, 1024, fsdp=True)
            shards = train.make_shards(cfg, par, mesh, rules)
            _reset(kernels)
            dlosses, dms, fn, state = _kind_steps(torch, train, cfg, batches,
                                                  shards)
            sharded = {"losses": dlosses, "step_ms": dms,
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "launches": _launches(kernels)}
            _no_launches(f"[dist kinds {tag}] sharded", kernels)
            held = _held(torch, tag, cfg, losses, dlosses, ref, state)
            out[tag] = {"arch": arch, "layers": cfg.n_layers,
                        "enc_layers": cfg.n_enc_layers, "frames": frames,
                        "rows": KIND_DIST_ROWS, "seq": KIND_DIST_SEQ,
                        "one_device": one, "sharded": sharded, **held}
            print(f"[dist kinds {tag}] {smi}: " + json.dumps(out[tag]),
                  flush=True)
            del fn, state, ref, batches
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


def _serve_greedy(torch, M, cfg, params, batch, shards=None,
                  steps: int = DIST_SERVE_STEPS) -> dict:
    """Whole-prompt prefill of ``batch``, then ``steps`` greedy decode
    steps over the ring caches: logits, tokens, wall ms of each call
    (card synchronized; the prefill timed after one untimed call, whose
    first use of each shape would otherwise count)."""
    with torch.no_grad():
        M.prefill(cfg, params, batch, DIST_SERVE_MAX_SEQ, shards=shards)
        (logits, caches), pre_ms = _synced(torch, lambda: M.prefill(
            cfg, params, batch, DIST_SERVE_MAX_SEQ, shards=shards))
        out = {"logits": [logits[:, 0]], "tokens": [], "prefill_ms": pre_ms,
               "step_ms": []}
        tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        pos = batch["positions"][:, -1] + 1
        for _ in range(steps):
            out["tokens"].append(tok)
            (logits, caches), ms = _synced(torch, lambda: M.decode_step(
                cfg, params, tok, pos, caches, DIST_SERVE_MAX_SEQ,
                shards=shards))
            out["logits"].append(logits)
            out["step_ms"].append(ms)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            pos = pos + 1
    return out


def _same_declaration(qparams, abstract) -> int:
    """Every leaf of the quantized tree has the declared shape and dtype
    (a packed leaf's fields and k_s, k, n too); returns the leaves
    compared."""
    from repro_torch.core.qlinear import FIELDS, QLinear
    n = 0

    def walk(got, want, path):
        nonlocal n
        if isinstance(want, QLinear):
            if not isinstance(got, QLinear) or (got.k_s, got.k, got.n) != (
                    want.k_s, want.k, want.n):
                _fail(f"[dist serve] {path}: {got} is not the declared "
                      f"packed leaf {want.k_s, want.k, want.n}")
            for f in FIELDS:
                walk(getattr(got, f), getattr(want, f), f"{path}.{f}")
        elif isinstance(want, dict):
            if set(got) != set(want):
                _fail(f"[dist serve] {path}: keys {sorted(got)} against "
                      f"{sorted(want)}")
            for k in want:
                walk(got[k], want[k], f"{path}[{k!r}]")
        elif isinstance(want, (list, tuple)):
            if len(got) != len(want):
                _fail(f"[dist serve] {path}: {len(got)} entries against "
                      f"{len(want)}")
            for i, (g, w) in enumerate(zip(got, want)):
                walk(g, w, f"{path}[{i}]")
        else:
            if tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
                _fail(f"[dist serve] {path}: {tuple(got.shape)} {got.dtype} "
                      f"against the declared {tuple(want.shape)} "
                      f"{want.dtype}")
            n += 1

    walk(qparams, abstract, "params")
    return n


def _bf16_steps_apart(torch, a, b):
    """Per element, how many bf16 values lie between a and b (0 equal,
    1 adjacent), by their bit patterns in the order of the values."""
    def key(t):
        u = t.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
        mag = u & 0x7FFF
        return torch.where(u >= 0x8000, -mag, mag)
    return (key(a) - key(b)).abs()


def check_split_arithmetic(torch, layer, timer, peaks, gen) -> list:
    """Step 3 of ``[dist serve]``: the split arithmetic of sharded
    serving, on the card, rank after rank.  For each leaf of
    SPLIT_LEAVES (a layer of the quantized qwen3-4b) and tp of
    SPLIT_TPS, every rank's ``distributed.sharding.local_view``: a
    column view of wq (its N/tp columns), a row view of wo and wd (its
    chunks of byte rows, uneven, with the perm and vectors of their
    channels, gathering from the whole x).  At each M of SPLIT_ROWS
    each view's product is launched with the f32 output (``out_dtype``)
    and held against its plain version; the row views' partials are
    summed in rank order and the column views' joined, against the
    whole leaf's f32 accumulator (itself held against its plain
    version).

    The bound: the two sides add the same f32 products in another
    grouping, so |gap| <= 2 gamma_K sum_k |x_k w_k| (gamma_K = K u / (1 -
    K u), u = 2^-24), computed per row over max|y| and printed as
    ``derived_rel_bound``; independent roundings add as a random walk,
    far below that worst case, and the check holds SPLIT_RTOL = 1e-5 of
    max|y|.  After the
    one rounding to bf16: |r(a) - r(b)| <= (ulp(r(a)) + ulp(r(b))) / 2 +
    |a - b|, so each output lies within one bf16 ulp of the whole
    leaf's, beyond the f32 gap; the rows report how many outputs differ
    at all and the most bf16 steps apart among outputs above 2^-8 of
    max|y|."""
    from repro_torch.distributed.sharding import local_view
    from repro_torch.kernels import ref
    from repro_torch.kernels.mixed_matmul import mixed_matmul
    out = []

    def f32(x, v, perm):
        return mixed_matmul(x, v.w4, v.s4, v.z4, v.bits, v.alpha_s,
                            v.alpha_r1, v.alpha_r2, perm=perm,
                            out_dtype=torch.float32)

    def plain(x, v, perm):
        return ref.mixed_matmul_ref(x, v.w4, v.s4, v.z4, v.bits, v.alpha_s,
                                    v.alpha_r1, v.alpha_r2, perm=perm)

    def held(got, want, what):
        gap = float((got - want).abs().max()
                    / want.abs().max().clamp_min(1e-30))
        if not gap <= SPLIT_RTOL:
            _fail(f"[dist serve split] {what}: f32 gap {gap} of max|y| "
                  f"above {SPLIT_RTOL}")
        return gap

    for name in SPLIT_LEAVES:
        q = layer["attn" if name in ("wq", "wo") else "mlp"][name]
        role = "column" if name == "wq" else "row"
        for m in SPLIT_ROWS:
            x = torch.randn((m, q.k), generator=gen, device="cuda").to(
                torch.bfloat16)
            whole = f32(x, q, q.perm)
            plain_gap = held(whole, plain(x, q, q.perm), f"{name} M={m} whole")
            # the rigorous bound of a reordered f32 sum, over max|y|
            gamma = q.k * 2.0 ** -24 / (1 - q.k * 2.0 ** -24)
            derived = float(2 * gamma * (x.float().abs() @ q.to_dense(
                torch.float32).abs()).max() / whole.abs().max())
            for tp in SPLIT_TPS:
                views = [local_view(q, role, r, tp) for r in range(tp)]
                parts, per_rank = [], []
                for r, v in enumerate(views):
                    y = f32(x, v, v.perm)
                    held(y, plain(x, v, v.perm), f"{name} tp={tp} rank {r}")
                    parts.append(y)
                    nbytes = (m * v.k * 2 + v.perm.numel() * 4 + v.w4.numel()
                              + v.bits.numel() + (2 * v.k_s + v.k - v.k_s
                                                  + 2 * v.n) * 4
                              + m * v.n * 4)
                    b, by = bound_ms(nbytes, 2.0 * m * v.k * v.n, peaks)
                    xl = torch.randn((m, v.k), generator=gen,
                                     device="cuda").to(torch.bfloat16)
                    dense = torch.randn((v.k, v.n), generator=gen,
                                        device="cuda").to(torch.bfloat16)
                    per_rank.append({
                        "k_s": v.k_s, "k_b": v.k - v.k_s, "n": v.n,
                        "kernel_us": 1e3 * timer.ms(lambda: f32(x, v, v.perm)),
                        "bound_us": 1e3 * b, "bound_by": by,
                        "plain_us": 1e3 * timer.ms(lambda: plain(x, v, v.perm)),
                        "matmul_us": 1e3 * timer.ms(
                            lambda: torch.matmul(xl, dense))})
                    del xl, dense
                if role == "row":
                    total = torch.zeros_like(whole)
                    for y in parts:
                        total += y
                else:
                    total = torch.cat(parts, dim=1)
                gap = held(total, whole, f"{name} M={m} tp={tp}")
                rw, rt = whole.to(torch.bfloat16), total.to(torch.bfloat16)
                ulp = lambda t: torch.exp2(torch.floor(torch.log2(
                    t.float().abs().clamp_min(1e-30))) - 7)
                slack = (ulp(rw) + ulp(rt)) / 2 + (total - whole).abs()
                if bool(((rt.float() - rw.float()).abs() > slack).any()):
                    _fail(f"[dist serve split] {name} M={m} tp={tp}: a "
                          "rounded output beyond one bf16 ulp of the f32 gap")
                big = whole.abs() >= whole.abs().max() * 2.0 ** -8
                steps = _bf16_steps_apart(torch, rt, rw)
                uneven = len({(r["k_s"], r["k_b"]) for r in per_rank}) > 1
                out.append({
                    "leaf": name, "role": role, "M": m, "K": q.k, "N": q.n,
                    "tp": tp, "uneven": uneven, "f32_rel_gap": gap,
                    "derived_rel_bound": derived,
                    "whole_vs_plain_rel_gap": plain_gap,
                    "rounded_outputs_differing": int((steps > 0).sum()),
                    "outputs": steps.numel(),
                    "max_bf16_steps_above_2^-8_max": int(steps[big].max()),
                    "ranks": per_rank,
                    "kernel_us": sum(r["kernel_us"] for r in per_rank),
                    "matmul_us": sum(r["matmul_us"] for r in per_rank),
                    "bound_us": sum(r["bound_us"] for r in per_rank),
                    "shapes": sorted({(m, r["k_s"] + r["k_b"], r["n"])
                                      for r in per_rank})})
    return out


def run_dist_serve(torch, kernels, smi: str, peaks, checked) -> dict:
    """``[dist serve]``: sharded serving of packed weights as one NCCL
    rank.  qwen3-4b at full width (DIST_SERVE_DEPTH layers) from seed 0,
    quantized data-free unfused (ratio 0.2, multiple 16); its packed
    shapes and dtypes must equal ``launch.qdeclare.declare_quantized``'s
    under the preset of the (1, 1) mesh (the prefill cell's).  Then the
    one-device ``model.prefill`` of 8 x 256 tokens and 32 greedy
    ``decode_step``s, and the same through ``model.shard_for_serving``
    (the tree placed as DTensors by the declared specs, each packed leaf
    its ``qlinear_local`` view) with ``shards``: the logits and tokens
    must be the same bits, and both runs must launch mixed_matmul the
    same number of times (more than 0) and no paged attention kernel.
    ``[dist serve fused]``: the same bf16 weights quantized with
    ``fuse=True`` and served the same way (FUSED_STEPS steps; each fused
    group placed by its members' declared specs,
    ``sharding.group_local``): the same bits and launches on both sides,
    fewer packed products a layer than the unfused run's; the packed
    shapes it launched that ``checked`` lacks are held against their
    plain version.  Then ``check_split_arithmetic`` on layer 0's leaves,
    ``check_fused_split`` on its fused groups (and phi4-mini's fused
    wqkv) and ``check_ctx_cross``.  Returns the results, with
    ``fused.held`` the rows held here."""
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPE_CELLS, Stage
    from repro_torch.core.pipeline import quantize_params_data_free
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.presets import make_preset
    from repro_torch.launch.qdeclare import declare_quantized
    from repro_torch.models import model as M
    cfg = registry.get(DIST_SERVE_ARCH)
    cfg = dataclasses.replace(cfg, stages=(Stage(("dense",),
                                                 DIST_SERVE_DEPTH),))
    from repro_torch.kernels.mixed_matmul import KERNEL
    qcfg = QuantConfig(ratio=0.2, multiple=16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    weights, init_ms = _synced(torch, lambda: M.init_params(cfg, 0, "cuda"))
    (qparams, quant_ms) = _synced(torch, lambda: quantize_params_data_free(
        weights, qcfg, min_dim=DIST_SERVE_MIN_DIM))
    bits = check_bits(qparams, "dist serve")
    gen = torch.Generator(device="cuda").manual_seed(31)
    b, s = DIST_SERVE_ROWS, DIST_SERVE_PROMPT
    batch = {"tokens": torch.randint(1, cfg.vocab, (b, s), generator=gen,
                                     device="cuda", dtype=torch.int32),
             "positions": torch.arange(s, dtype=torch.int32,
                                       device="cuda").expand(b, s)}
    out = {"arch": DIST_SERVE_ARCH, "layers": DIST_SERVE_DEPTH,
           "of_layers": registry.get(DIST_SERVE_ARCH).n_layers,
           "rows": b, "prompt": s, "max_seq": DIST_SERVE_MAX_SEQ,
           "steps": DIST_SERVE_STEPS, "bits_per_weight": bits,
           "init_s": init_ms / 1e3, "quantize_s": quant_ms / 1e3}
    _reset(kernels)
    one = _serve_greedy(torch, M, cfg, qparams, batch)
    one_launches = _launches(kernels)
    one_peak = torch.cuda.max_memory_allocated() / 1e9
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        cell = next(c for c in SHAPE_CELLS if c.kind == "prefill")
        preset = make_preset(cfg, cell, mesh)
        abstract, specs = declare_quantized(cfg, preset.par, qcfg,
                                            preset.rules,
                                            min_dim=DIST_SERVE_MIN_DIM)
        out["declared_leaves_equal"] = _same_declaration(qparams, abstract)
        torch.cuda.reset_peak_memory_stats()
        (shards, lp), place_ms = _synced(torch, lambda: M.shard_for_serving(
            cfg, preset.par, qparams, specs, mesh))
        _reset(kernels)
        sh = _serve_greedy(torch, M, cfg, lp, batch, shards)
        sh_launches = _launches(kernels)
        sh_peak = torch.cuda.max_memory_allocated() / 1e9
        del lp, shards
        fused, fq_ms = _synced(torch, lambda: quantize_params_data_free(
            weights, qcfg, min_dim=DIST_SERVE_MIN_DIM, fuse=True))
        del weights
        before = dict(KERNEL.shapes)
        _reset(kernels)
        fone = _serve_greedy(torch, M, cfg, fused, batch, steps=FUSED_STEPS)
        fone_launches = _launches(kernels)
        torch.cuda.reset_peak_memory_stats()
        (fshards, flp), fplace_ms = _synced(
            torch, lambda: M.shard_for_serving(cfg, preset.par, fused, specs,
                                               mesh))
        _reset(kernels)
        fsh = _serve_greedy(torch, M, cfg, flp, batch, fshards,
                            steps=FUSED_STEPS)
        fsh_launches = _launches(kernels)
        fsh_peak = torch.cuda.max_memory_allocated() / 1e9
        del flp, fshards
    finally:
        dist.destroy_process_group()
    same = all(_bits_equal(torch, a, c) for a, c in zip(one["logits"],
                                                        sh["logits"]))
    same_tokens = all(torch.equal(a, c) for a, c in zip(one["tokens"],
                                                        sh["tokens"]))
    gap = max(float((a.float() - c.float()).abs().max())
              for a, c in zip(one["logits"], sh["logits"]))
    toks = b * DIST_SERVE_STEPS

    def side(r, launches, peak):
        return {"prefill_ms": r["prefill_ms"],
                "decode_step_ms": sum(r["step_ms"]) / len(r["step_ms"]),
                "decode_step_ms_first": r["step_ms"][0],
                "tokens_per_s": toks / ((r["prefill_ms"] + sum(r["step_ms"]))
                                        / 1e3),
                "decode_tokens_per_s": toks * 1e3 / sum(r["step_ms"]),
                "peak_mem_gb": peak, "launches": launches}

    out.update(one_device=side(one, one_launches, one_peak),
               sharded=dict(side(sh, sh_launches, sh_peak),
                            mesh=[1, 1], place_ms=place_ms),
               bit_identical=same and same_tokens, max_logit_gap=gap)
    print(f"[dist serve] {smi}: " + json.dumps(out), flush=True)
    if not (same and same_tokens):
        _fail(f"[dist serve] the sharded prefill and decode part from one "
              f"device's (largest logit gap {gap})")
    for tag, n in (("one device", one_launches), ("sharded", sh_launches)):
        if n["mixed_matmul"] <= 0:
            _fail(f"[dist serve] {tag}: kernel mixed_matmul was not launched")
        if n["paged_attention"] or n["paged_prefill"]:
            _fail(f"[dist serve] {tag}: a paged attention kernel launched "
                  "on the contiguous path")
    if one_launches["mixed_matmul"] != sh_launches["mixed_matmul"]:
        _fail(f"[dist serve] mixed_matmul launched {sh_launches} times "
              f"sharded against {one_launches} on one device")
    del one, sh
    # forward calls of a run: the untimed and the timed prefill, the steps
    calls = {"unfused": 2 + DIST_SERVE_STEPS, "fused": 2 + FUSED_STEPS}
    per_layer = {
        "unfused": sh_launches["mixed_matmul"]
        / (calls["unfused"] * DIST_SERVE_DEPTH),
        "fused": fsh_launches["mixed_matmul"]
        / (calls["fused"] * DIST_SERVE_DEPTH)}
    fsame = all(_bits_equal(torch, a, c) for a, c in zip(
        fone["logits"], fsh["logits"])) and all(
        torch.equal(a, c) for a, c in zip(fone["tokens"], fsh["tokens"]))
    fgap = max(float((a.float() - c.float()).abs().max())
               for a, c in zip(fone["logits"], fsh["logits"]))
    ftoks = b * FUSED_STEPS

    def fside(r, launches, peak=None):
        return {"prefill_ms": r["prefill_ms"],
                "decode_step_ms": sum(r["step_ms"]) / len(r["step_ms"]),
                "decode_tokens_per_s": ftoks * 1e3 / sum(r["step_ms"]),
                "peak_mem_gb": peak, "launches": launches}

    fout = {"steps": FUSED_STEPS, "quantize_s": fq_ms / 1e3,
            "one_device": fside(fone, fone_launches),
            "sharded": dict(fside(fsh, fsh_launches, fsh_peak), mesh=[1, 1],
                            place_ms=fplace_ms),
            "unfused_sharded_launches": sh_launches["mixed_matmul"],
            "forward_calls": calls,
            "products_per_layer": per_layer,
            "bit_identical": fsame, "max_logit_gap": fgap}
    print(f"[dist serve fused] {smi}: " + json.dumps(fout), flush=True)
    if not fsame:
        _fail(f"[dist serve fused] the sharded prefill and decode part from "
              f"one device's (largest logit gap {fgap})")
    if fone_launches["mixed_matmul"] != fsh_launches["mixed_matmul"]:
        _fail(f"[dist serve fused] mixed_matmul launched {fsh_launches} "
              f"times sharded against {fone_launches} on one device")
    if not 0 < per_layer["fused"] < per_layer["unfused"]:
        _fail(f"[dist serve fused] {per_layer} packed products a layer, "
              "fused against unfused")
    if fsh_launches["paged_attention"] or fsh_launches["paged_prefill"]:
        _fail("[dist serve fused] a paged attention kernel launched on the "
              "contiguous path")
    del fone, fsh
    timer = Timer(torch)
    new = [shape for shape, c in KERNEL.shapes.items()
           if c > before.get(shape, 0)]
    held = hold_new_shapes(torch, fused, new, checked, timer, peaks, gen,
                           "fused")
    if held:
        print_rows("dist serve fused mixed_matmul",
                   "the fused shapes new to the run", held,
                   sorted({r["M"] for r in held}))
    fout["held"] = held
    split = check_split_arithmetic(torch, qparams["stages"][0][0][0], timer,
                                   peaks, gen)
    for row in split:
        print(f"[dist serve split {row['leaf']} M={row['M']} tp={row['tp']}] "
              f"(f32 gap limit {SPLIT_RTOL} of max|y|) " + json.dumps(row),
              flush=True)
    out["split"] = split
    del qparams
    fout["split"] = check_fused_split(torch, fused["stages"][0][0][0], timer,
                                      peaks, gen)
    for row in fout["split"]:
        print(f"[dist serve fused split {row['leaf']} M={row['M']} "
              f"tp={row['tp']}] (f32 gap limit {SPLIT_RTOL} of max|y|) "
              + json.dumps(row), flush=True)
    del fused
    fout["ctx_cross"] = check_ctx_cross(torch, gen)
    print(f"[dist serve ctx cross] (f32 gap limit {SPLIT_RTOL} of max|o|) "
          + json.dumps(fout["ctx_cross"]), flush=True)
    out["fused"] = fout
    del timer
    torch.cuda.empty_cache()
    return out


def _group_columns(torch, g, r: int, tp: int, heads=()):
    """The columns of the whole fused group ``g`` that rank ``r`` of
    ``tp`` holds in its view (``sharding.group_view``), in the view's
    order: per member, its N / tp columns, or those of the rank's whole
    heads of ``heads[i]`` heads that tp does not divide."""
    from repro_torch.distributed.sharding import chunk_range
    heads = tuple(heads) + (None,) * (len(g.splits) - len(heads))
    cols, off = [], 0
    for n, h in zip(g.splits, heads):
        if h is not None and h % tp:
            lo, hi = chunk_range(h, tp, r)
            lo, hi = lo * (n // h), hi * (n // h)
        else:
            lo, hi = chunk_range(n, tp, r)
        cols.append(torch.arange(off + lo, off + hi))
        off += n
    return torch.cat(cols)


def check_fused_split(torch, layer, timer, peaks, gen) -> list:
    """``[dist serve fused split]``: every rank's view of a fused group
    (``sharding.group_view``, what ``group_local`` makes on that rank),
    launched rank after rank with the f32 output, each held against its
    plain version and, joined, against the same columns of the whole
    fused leaf's f32 product (``_split_product`` over the whole leaf's
    columns in the ranks' order) within SPLIT_RTOL of max|y|: layer 0's
    ``wqkv`` and ``wgu`` of qwen3-4b at SPLIT_TPS and SPLIT_ROWS, and
    phi4-mini-3.8b's layer-0 ``wqkv`` (its bf16 weights from seed 0,
    fused and quantized data-free) at UNEVEN_TP, whose query member
    holds the rank's whole heads of 24: 2 on ranks 0-11, none on
    12-15.  Each ``wqkv`` view's query member (``members()``, the
    product a rank runs alone where it projects KV on its chunk of the
    sequence-parallel stream) is held the same way against the whole
    query member."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.core.qlinear import QuantConfig, quantize_linear_group
    from repro_torch.distributed.sharding import chunk_range, group_view
    from repro_torch.models import layers as L
    from repro_torch.models.param import materialize
    groups = [("qwen3-4b " + name, layer["attn" if name == "wqkv" else "mlp"]
               [name], SPLIT_TPS, (registry.get(DIST_SERVE_ARCH).n_heads,)
               if name == "wqkv" else ()) for name in ("wqkv", "wgu")]
    pcfg = registry.get(UNEVEN_ARCH)
    attn = materialize(L.init_attention(pcfg), 0, "cuda")
    groups.append(("phi4-mini wqkv", quantize_linear_group(
        [attn[k] for k in ("wq", "wk", "wv")], None,
        QuantConfig(ratio=0.2, multiple=16)), (UNEVEN_TP,),
        (pcfg.n_heads,)))
    del attn
    rows = []
    for what, g, tps, heads in groups:
        q = g.inner
        for tp in tps:
            views = [group_view(g, r, tp, heads) for r in range(tp)]
            order = torch.cat([_group_columns(torch, g, r, tp, heads)
                               for r in range(tp)]).to(q.w4.device)
            cut = lambda t: t.index_select(-1, order).contiguous()  # noqa
            ordered = dataclasses.replace(
                q, w4=cut(q.w4), bits=cut(q.bits), alpha_s=cut(q.alpha_s),
                alpha_r1=cut(q.alpha_r1))
            for m in SPLIT_ROWS:
                x = torch.randn((m, q.k), generator=gen, device="cuda").to(
                    torch.bfloat16)
                row = _split_product(torch, f"{what} tp={tp}", ordered,
                                     [v.inner for v in views], "column", x,
                                     timer, peaks)
                row.update(leaf=what, splits=[list(v.splits) for v in views])
                rows.append(row)
                if heads:
                    # the query member alone, as a rank runs it where
                    # its KV is projected on the sequence-parallel chunk
                    row = _split_product(
                        torch, f"{what} query member tp={tp}",
                        g.members()[0], [v.members()[0] for v in views],
                        "column", x, timer, peaks)
                    row.update(leaf=f"{what} query member",
                               splits=[[v.splits[0]] for v in views])
                    rows.append(row)
    # phi4-mini's ranks of no head (12-15 of 16) hold no query column
    headless = [r for r in range(UNEVEN_TP)
                if len(range(*chunk_range(pcfg.n_heads, UNEVEN_TP, r))) == 0]
    for row in rows:
        if row["leaf"] == "phi4-mini wqkv" and headless != [
                r for r, sp in enumerate(row["splits"]) if sp[0] == 0]:
            _fail(f"[dist serve fused split] phi4-mini's query columns by "
                  f"rank {row['splits']}, ranks {headless} hold no head")
    return rows


def check_ctx_cross(torch, gen) -> dict:
    """``[dist serve ctx cross]``: the context-sharded cross K/V of a
    decode step.  seamless-m4t-medium's layer-0 cross-attention (its
    bf16 weights from seed 0, wq / wk / wv quantized data-free): K/V
    over DIST_SERVE_ROWS x SERVE_KIND_FRAMES stub frames, the query of
    one decode row each, cast to f32 (with bf16 K/V the weights round
    to bf16 after the division by the sum, and a sum in another order
    flips some of them by an ulp: 1.30e-5 of max|o| on the card); each
    of CTX_CROSS_CHUNKS ranks' cache is
    ``layers._cross_ctx``'s chunk of the positions, attended for every
    head (``layers.attend_split``) and combined as the all-reduces over
    "model" combine them (``layers.drive_split``).  Every part must end
    with the same output, within SPLIT_RTOL of the largest value of one
    device's attention over every position (``layers._attend``, f32)."""
    from repro_torch.configs import registry
    from repro_torch.core.qlinear import QuantConfig, quantize_linear
    from repro_torch.models import layers as L
    from repro_torch.models.common import Parallel
    from repro_torch.models.linear import dense
    from repro_torch.models.param import materialize
    cfg = registry.get(S2T_ARCH)
    qcfg = QuantConfig(ratio=0.2, multiple=16)
    p = materialize(L.init_attention(cfg, cross=True), 0, "cuda")
    w = {k: quantize_linear(p[k], None, qcfg) for k in ("wq", "wk", "wv")}
    del p
    b, s, tp, dh = DIST_SERVE_ROWS, SERVE_KIND_FRAMES, CTX_CROSS_CHUNKS, \
        cfg.head_dim_
    frames = torch.randn((b, s, cfg.d_model), generator=gen,
                         device="cuda").to(torch.bfloat16)
    x = torch.randn((b, 1, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    # in f32: the softmax weights then round to no narrower type, and the
    # parts' sums differ from the whole's in their order alone
    q = dense(x, w["wq"]).reshape(b, 1, -1, dh).float()
    k = dense(frames, w["wk"]).reshape(b, s, -1, dh).float()
    v = dense(frames, w["wv"]).reshape(b, s, -1, dh).float()
    mask = torch.ones((b, 1, s), dtype=torch.bool, device="cuda")
    whole = L._attend(q, k, v, mask, cfg.logit_softcap)
    par = Parallel(tp=tp)
    chunks = [L._cross_ctx(cfg, k, v, _rank_shards(par, r))
              for r in range(tp)]
    parts = L.drive_split([L.attend_split(
        q, kc, vc, mask[..., :kc.shape[1]], cfg.logit_softcap)
        for kc, vc in chunks])
    same = all(torch.equal(o, parts[0]) for o in parts)
    gap = float((parts[0] - whole).abs().max() / whole.abs().max())
    out = {"rows": b, "frames": s, "heads": cfg.n_heads,
           "kv_heads": cfg.n_kv_heads, "chunks": tp,
           "chunk_positions": [kc.shape[1] for kc, _ in chunks],
           "parts_equal": same, "f32_rel_gap": gap}
    if not same or not gap <= SPLIT_RTOL:
        _fail(f"[dist serve ctx cross] {out}")
    return out


def _serve_kind_cases(registry):
    """(tag, config, prompt tokens, stub frames per row) of
    ``[dist serve kinds]``: granite whole, the other kinds at
    ``_kind_dist_cases``' cut depth."""
    out = [("moe", registry.get(MOE_ARCH), SERVE_KIND_PROMPT, 0)]
    for tag, arch, over, frames in _kind_dist_cases():
        out.append((tag, dataclasses.replace(registry.get(arch), **over),
                     S2T_PROMPT if frames else SERVE_KIND_PROMPT,
                     SERVE_KIND_FRAMES if frames else 0))
    return out


def _leaf_of(qparams, k: int, n: int):
    """A packed 2-D leaf of ``qparams`` (a fused group's whole leaf
    among them) of input K and output N, or None."""
    from repro_torch.core.qlinear import QLinear, QLinearGroup
    found = []

    def walk(t):
        if isinstance(t, QLinearGroup):
            walk(t.inner)
        elif isinstance(t, QLinear):
            if t.w4.ndim == 2 and (t.k, t.n) == (k, n) and not found:
                found.append(t)
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
    walk(qparams)
    return found[0] if found else None


def hold_new_shapes(torch, qparams, shapes, checked, timer, peaks, gen,
                    tag: str) -> list:
    """Each (M, K, N) of ``shapes`` outside ``checked``, held against
    the plain version on a leaf of ``qparams`` of that shape at that M
    (``check_mixed_matmul``'s rows)."""
    rows = []
    for m, k, n in sorted(set(shapes) - set(checked)):
        q = _leaf_of(qparams, k, n)
        if q is None:
            _fail(f"[dist serve kinds {tag}] mixed_matmul launched at "
                  f"K={k}, N={n}, which no packed leaf of the model has")
        rows += check_mixed_matmul(torch, {f"{k}x{n}": q}, timer, peaks, gen,
                                   ms=(m,))
    return rows


def check_expert_split(torch, mlp, cfg, timer, peaks, gen) -> list:
    """The packed MoE's split arithmetic of sharded serving at tp
    EXPERT_SPLIT_TP, rank after rank on the card: the column views of
    ``wg`` / ``wu`` (``distributed.sharding.local_view``, each rank's
    ffn/tp columns of all E experts), g·u joined along ffn (the gather
    over "model"), then the whole ``wd`` at full K, against the whole
    leaves; at each capacity of EXPERT_SPLIT_ROWS.  The expert products
    are the dequant path (``QLinear.__expert_matmul__``), as the
    reference's einsum; run in f32 (TF32 off), each rank's columns and
    the output through wd are held within SPLIT_RTOL of max|y| (the
    same sums in another order); in bf16, as the model runs them, the
    rows report how many outputs of the joined g·u and of y differ from
    the whole's and the most bf16 steps apart among outputs above 2^-8
    of max|y|.  Each view's time beside its bound."""
    from repro_torch.distributed.sharding import local_view
    from repro_torch.models.layers import _act
    from repro_torch.models.linear import expert_dense
    out = []
    tp, e = EXPERT_SPLIT_TP, cfg.moe.n_experts
    views = {n: [local_view(mlp[n], "column", r, tp) for r in range(tp)]
             for n in ("wg", "wu")}

    def gu(x, wg, wu):
        return _act(cfg.act, expert_dense(x, wg)) * expert_dense(x, wu)

    def held(got, want, what):
        gap = float((got - want).abs().max()
                    / want.abs().max().clamp_min(1e-30))
        if not gap <= SPLIT_RTOL:
            _fail(f"[dist serve kinds split] {what}: f32 gap {gap} of "
                  f"max|y| above {SPLIT_RTOL}")
        return gap

    for cap in EXPERT_SPLIT_ROWS:
        x = torch.randn((e, cap, cfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
        row = {"E": e, "capacity": cap, "d_model": cfg.d_model,
               "d_ff": cfg.d_ff, "tp": tp}
        # f32: the same sums in another order
        xf = x.float()
        whole = gu(xf, mlp["wg"], mlp["wu"])
        parts = [gu(xf, g, u) for g, u in zip(views["wg"], views["wu"])]
        row["gu_f32_rel_gap"] = held(torch.cat(parts, dim=2), whole,
                                     f"g·u cap={cap}")
        row["y_f32_rel_gap"] = held(
            expert_dense(torch.cat(parts, dim=2), mlp["wd"]),
            expert_dense(whole, mlp["wd"]), f"y cap={cap}")
        # bf16, as the model runs it
        whole = gu(x, mlp["wg"], mlp["wu"])
        joined = torch.cat([gu(x, g, u) for g, u in zip(views["wg"],
                                                        views["wu"])], dim=2)
        y_w, y_j = (expert_dense(t, mlp["wd"]) for t in (whole, joined))
        for name, a, b in (("gu", joined, whole), ("y", y_j, y_w)):
            steps = _bf16_steps_apart(torch, a, b)
            big = b.abs() >= b.abs().max() * 2.0 ** -8
            row[f"{name}_bf16_outputs_differing"] = int((steps > 0).sum())
            row[f"{name}_outputs"] = steps.numel()
            row[f"{name}_max_bf16_steps_above_2^-8_max"] = int(
                steps[big].max())
        # each rank's view against the whole leaf, and the bounds
        for name in ("wg", "wu"):
            q, v = mlp[name], views[name][0]
            vbytes = sum(getattr(v, f).numel() * getattr(v, f).element_size()
                         for f in ("perm", "w4", "s4", "z4", "bits",
                                   "alpha_s", "alpha_r1", "alpha_r2"))
            b, by = bound_ms(x.numel() * 2 + vbytes + e * cap * v.n * 2,
                             2.0 * e * cap * q.k * v.n, peaks)
            row[f"{name}_view_us"] = 1e3 * timer.ms(
                lambda: expert_dense(x, v))
            row[f"{name}_whole_us"] = 1e3 * timer.ms(
                lambda: expert_dense(x, q))
            row[f"{name}_view_bound_us"], row["bound_by"] = 1e3 * b, by
        row["wd_whole_us"] = 1e3 * timer.ms(lambda: expert_dense(
            joined, mlp["wd"]))
        out.append(row)
    return out


def run_dist_serve_kinds(torch, kernels, smi: str, peaks, checked) -> dict:
    """``[dist serve kinds]``: sharded serving of every other block kind
    and the encoder-decoder model as one NCCL rank on a (1, 1) mesh
    (``_serve_kind_cases``).  Each model from seed 0, quantized
    data-free unfused (ratio 0.2, multiple 16; its packed shapes and
    dtypes equal ``launch.qdeclare.declare_quantized``'s under the
    preset of the prefill cell: EP for granite), served on one device
    and through ``model.shard_for_serving`` with ``shards``: the logits
    and tokens must be the same bits, both runs must launch mixed_matmul
    the same number of times (more than 0) and no paged attention
    kernel.  Every new packed-matmul shape is held
    (``hold_new_shapes``; ``checked``: the shapes held before), then
    ``check_expert_split`` on granite's layer 0.  Returns the results
    with ``held``, the rows held here."""
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPE_CELLS
    from repro_torch.core.pipeline import quantize_params_data_free
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.kernels.mixed_matmul import KERNEL
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.presets import make_preset
    from repro_torch.launch.qdeclare import declare_quantized
    from repro_torch.models import model as M
    qcfg = QuantConfig(ratio=0.2, multiple=16)
    gen = torch.Generator(device="cuda").manual_seed(37)
    timer = Timer(torch)
    out, held = {}, []
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        cell = next(c for c in SHAPE_CELLS if c.kind == "prefill")
        for tag, cfg, prompt, frames in _serve_kind_cases(registry):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = dict(KERNEL.shapes)
            qparams, quant_ms = _synced(
                torch, lambda: quantize_params_data_free(
                    M.init_params(cfg, 0, "cuda"), qcfg,
                    min_dim=DIST_SERVE_MIN_DIM))
            b = DIST_SERVE_ROWS
            batch = {"tokens": torch.randint(1, cfg.vocab, (b, prompt),
                                             generator=gen, device="cuda",
                                             dtype=torch.int32),
                     "positions": torch.arange(
                         prompt, dtype=torch.int32,
                         device="cuda").expand(b, prompt)}
            if frames:
                batch["frames"] = torch.randn(
                    (b, frames, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
            res = {"arch": cfg.name, "layers": cfg.n_layers,
                   "enc_layers": cfg.n_enc_layers, "frames": frames,
                   "rows": b, "prompt": prompt, "steps": SERVE_KIND_STEPS,
                   "quantize_s": quant_ms / 1e3}
            _reset(kernels)
            one = _serve_greedy(torch, M, cfg, qparams, batch,
                                steps=SERVE_KIND_STEPS)
            one_launches = _launches(kernels)
            one_peak = torch.cuda.max_memory_allocated() / 1e9
            preset = make_preset(cfg, cell, mesh)
            abstract, specs = declare_quantized(cfg, preset.par, qcfg,
                                                preset.rules,
                                                min_dim=DIST_SERVE_MIN_DIM)
            res["declared_leaves_equal"] = _same_declaration(qparams,
                                                             abstract)
            res["ep"] = preset.rules.ep
            torch.cuda.reset_peak_memory_stats()
            (shards, lp), place_ms = _synced(
                torch, lambda: M.shard_for_serving(cfg, preset.par, qparams,
                                                   specs, mesh))
            _reset(kernels)
            sh = _serve_greedy(torch, M, cfg, lp, batch, shards,
                               steps=SERVE_KIND_STEPS)
            sh_launches = _launches(kernels)
            sh_peak = torch.cuda.max_memory_allocated() / 1e9
            del lp, shards
            same = all(_bits_equal(torch, a, c)
                       for a, c in zip(one["logits"], sh["logits"])) and all(
                torch.equal(a, c) for a, c in zip(one["tokens"],
                                                  sh["tokens"]))
            gap = max(float((a.float() - c.float()).abs().max())
                      for a, c in zip(one["logits"], sh["logits"]))
            toks = b * SERVE_KIND_STEPS

            def side(r, launches, peak):
                return {"prefill_ms": r["prefill_ms"],
                        "decode_step_ms": sum(r["step_ms"])
                        / len(r["step_ms"]),
                        "decode_tokens_per_s": toks * 1e3 / sum(r["step_ms"]),
                        "peak_mem_gb": peak, "launches": launches}

            res.update(one_device=side(one, one_launches, one_peak),
                       sharded=dict(side(sh, sh_launches, sh_peak),
                                    mesh=[1, 1], place_ms=place_ms),
                       bit_identical=same, max_logit_gap=gap)
            if not same:
                _fail(f"[dist serve kinds {tag}] the sharded prefill and "
                      f"decode part from one device's (largest logit gap "
                      f"{gap})")
            for what, n in (("one device", one_launches),
                            ("sharded", sh_launches)):
                if n["mixed_matmul"] <= 0:
                    _fail(f"[dist serve kinds {tag}] {what}: kernel "
                          "mixed_matmul was not launched")
                if n["paged_attention"] or n["paged_prefill"]:
                    _fail(f"[dist serve kinds {tag}] {what}: a paged "
                          "attention kernel launched on the contiguous path")
            if one_launches["mixed_matmul"] != sh_launches["mixed_matmul"]:
                _fail(f"[dist serve kinds {tag}] mixed_matmul launched "
                      f"{sh_launches} times sharded against {one_launches} "
                      "on one device")
            del one, sh
            new = [s for s, c in KERNEL.shapes.items()
                   if c > before.get(s, 0)]
            rows = hold_new_shapes(torch, qparams, new, checked, timer, peaks,
                                   gen, tag)
            if rows:
                print_rows(f"dist serve kinds {tag} mixed_matmul",
                           "the shapes new to the phase", rows,
                           sorted({r["M"] for r in rows}))
            held += rows
            checked = set(checked) | {(r["M"], r["K"], r["N"]) for r in rows}
            res["shapes_held_here"] = [[r["M"], r["K"], r["N"]] for r in rows]
            if tag == "moe":
                res["expert_split"] = check_expert_split(
                    torch, qparams["stages"][0][0][0]["mlp"], cfg, timer,
                    peaks, gen)
            out[tag] = res
            print(f"[dist serve kinds {tag}] {smi}: " + json.dumps(res),
                  flush=True)
            del qparams, batch
    finally:
        dist.destroy_process_group()
    del timer
    torch.cuda.empty_cache()
    out["held"] = held
    return out


# ---------------------------------------------------------------------------
# Phase 18: uneven tensor-parallel head splits
# ---------------------------------------------------------------------------
def _rank_shards(par, r: int, whole=None):
    """Rank ``r`` of ``par.tp`` on the "model" dim without a process
    group (one card runs the ranks one after another): ``Shards``' head
    layout (``heads``, ``head_part``, ``part``); ``gather_model`` hands
    back ``whole``, what the gather over "model" would give, or its
    input (a leaf given whole), and ``enter`` is the identity."""
    from repro_torch.models.common import Shards

    class _Rank(Shards):
        def __init__(self):
            self.tp, self.tp_rank, self.par = par.tp, r, par

        def gather_model(self, t, dim):
            return t if whole is None else whole

        def enter(self, x):
            return x
    return _Rank()


def _held_split(got, want, what: str) -> float:
    gap = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
    if not gap <= SPLIT_RTOL:
        _fail(f"[dist uneven split] {what}: f32 gap {gap} of max|y| above "
              f"{SPLIT_RTOL}")
    return gap


def _split_product(torch, what: str, q, views, role: str, x, timer,
                   peaks) -> dict:
    """The packed matmul of ``x`` by each rank's view of the leaf ``q``
    (``role`` "column": joined along N; "row": f32 partials summed in
    rank order), each held against its plain version, the join against
    the whole leaf's f32 accumulator within SPLIT_RTOL of max|y|, and
    after the one rounding each output within one bf16 ulp of the whole
    leaf's beyond the f32 gap.  A view of no column launches nothing.
    The time of each distinct view shape beside its bound and
    ``torch.matmul`` at the same local shape (bf16)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.mixed_matmul import KERNEL, mixed_matmul

    def f32(v):
        return mixed_matmul(x, v.w4, v.s4, v.z4, v.bits, v.alpha_s,
                            v.alpha_r1, v.alpha_r2, perm=v.perm,
                            out_dtype=torch.float32)

    def plain(v):
        return ref.mixed_matmul_ref(x, v.w4, v.s4, v.z4, v.bits, v.alpha_s,
                                    v.alpha_r1, v.alpha_r2, perm=v.perm)

    m = x.shape[0]
    whole = f32(q)
    plain_gap = _held_split(whole, plain(q), f"{what} M={m} whole")
    parts, timed, empty = [], {}, 0
    for r, v in enumerate(views):
        before = KERNEL.launches
        y = f32(v)
        launched = KERNEL.launches - before
        if v.n == 0 or v.k == 0:
            empty += 1
            if launched:
                _fail(f"[dist uneven split] {what} rank {r}: a view of no "
                      f"column or row launched {launched} times")
        else:
            _held_split(y, plain(v), f"{what} M={m} rank {r}")
            shape = (m, v.k, v.n)
            if shape not in timed:
                nbytes = (m * x.shape[1] * 2 + v.perm.numel() * 4
                          + v.w4.numel() + v.bits.numel()
                          + (2 * v.k_s + v.k - v.k_s + 2 * v.n) * 4
                          + m * v.n * 4)
                b, by = bound_ms(nbytes, 2.0 * m * v.k * v.n, peaks)
                xl = torch.randn((m, v.k), device="cuda").to(torch.bfloat16)
                dense = torch.randn((v.k, v.n), device="cuda").to(
                    torch.bfloat16)
                timed[shape] = {
                    "kernel_us": 1e3 * timer.ms(lambda: f32(v)),
                    "plain_us": 1e3 * timer.ms(lambda: plain(v)),
                    "bound_us": 1e3 * b, "bound_by": by,
                    "matmul_us": 1e3 * timer.ms(
                        lambda: torch.matmul(xl, dense))}
                del xl, dense
        parts.append(y)
    if role == "row":
        total = torch.zeros_like(whole)
        for y in parts:
            total += y
    else:
        total = torch.cat(parts, dim=1)
    gap = _held_split(total, whole, f"{what} M={m}")
    rw, rt = whole.to(torch.bfloat16), total.to(torch.bfloat16)
    ulp = lambda t: torch.exp2(torch.floor(torch.log2(  # noqa: E731
        t.float().abs().clamp_min(1e-30))) - 7)
    slack = (ulp(rw) + ulp(rt)) / 2 + (total - whole).abs()
    if bool(((rt.float() - rw.float()).abs() > slack).any()):
        _fail(f"[dist uneven split] {what} M={m}: a rounded output beyond "
              "one bf16 ulp of the f32 gap")
    steps = _bf16_steps_apart(torch, rt, rw)
    return {"leaf": what, "role": role, "M": m, "K": q.k, "N": q.n,
            "tp": len(views), "widths": [v.n if role == "column" else v.k
                                         for v in views],
            "empty_ranks": empty, "f32_rel_gap": gap,
            "whole_vs_plain_rel_gap": plain_gap,
            "rounded_outputs_differing": int((steps > 0).sum()),
            "outputs": steps.numel(),
            "views": {f"{a}x{b}x{c}": t for (a, b, c), t in timed.items()},
            "shapes": sorted(set(timed) | {(m, q.k, q.n)})}


def _view_products(torch, what, leaves, role, timer, peaks, gen,
                   heads=None) -> list:
    """``_split_product`` of each leaf of ``leaves`` ({name: QLinear})
    over its UNEVEN_TP views, at each M of UNEVEN_SPLIT_ROWS: the views
    of its ``heads`` heads' columns (``sharding.head_view``) when given,
    else ``sharding.local_view``'s (N / tp columns, or chunks of byte
    rows)."""
    from repro_torch.distributed.sharding import head_view, local_view
    rows = []
    for name, q in leaves.items():
        views = [head_view(q, heads, r, UNEVEN_TP) if heads else
                 local_view(q, role, r, UNEVEN_TP) for r in range(UNEVEN_TP)]
        for m in UNEVEN_SPLIT_ROWS:
            x = torch.randn((m, q.k), generator=gen, device="cuda").to(
                torch.bfloat16)
            rows.append(_split_product(torch, f"{what} {name}", q, views,
                                       role, x, timer, peaks))
    return rows


def check_attention_split(torch, tag, cfg, attn, window, timer, peaks,
                          gen) -> dict:
    """An attention block's split at tp UNEVEN_TP, rank after rank:
    ``wq``'s head views (``sharding.head_view``: each rank's whole
    heads, none on the trailing ranks) against the whole leaf; each
    rank's heads attended over every KV head (``layers._per_head_kv``,
    a rank's query heads may straddle two KV groups) from the whole
    layer's q, k and v, joined against the whole attention (f32); the
    rank's own projection through the port's uneven path
    (``layers._project_qkv`` with the rank's ``Shards``: its head view
    of ``wq``, ``wk`` / ``wv`` whole, their products held at these rows
    too), its K / V the whole layer's bits and its q's rounded outputs
    counted against the whole's; ``wo``'s row views over the whole
    output."""
    from repro_torch.distributed.sharding import head_view, local_view
    from repro_torch.models import layers as L
    from repro_torch.models.common import Parallel
    par = Parallel(tp=UNEVEN_TP)
    hq, dh = cfg.n_heads, cfg.head_dim_
    ranks = [_rank_shards(par, r) for r in range(UNEVEN_TP)]
    out = {"arch": cfg.name, "heads": hq, "kv_heads": cfg.n_kv_heads,
           "run_kv_heads": par.kv_heads_run(cfg.n_kv_heads, hq),
           "heads_per_rank": [hi - lo for lo, hi in
                              (sh.heads(hq) for sh in ranks)]}
    out["wq"] = _view_products(torch, tag, {"wq": attn["wq"]}, "column",
                               timer, peaks, gen, hq)
    b, s = UNEVEN_ATT_SHAPE
    x = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda").to(
        torch.bfloat16)
    pos = torch.arange(s, dtype=torch.int32, device="cuda").expand(b, s)
    with torch.no_grad():
        q, k, v = L._project_qkv(cfg, attn, x, pos)
        qp, kp = pos[:, :, None], pos[:, None, :]
        mask = (kp <= qp) & (kp >= 0)
        if window is not None:
            mask = mask & (qp - kp < window)
        whole = L._attend(q, k, v, mask, cfg.logit_softcap)
        parts, q_diff, kv_equal = [], 0, True
        for r, sh in enumerate(ranks):
            lo, hi = sh.heads(hq)
            ka, va = L._per_head_kv(cfg, k, v, sh)
            parts.append(L._attend(q[:, :, lo:hi], ka, va, mask,
                                   cfg.logit_softcap))
            own = dict(attn, wq=head_view(attn["wq"], hq, r, UNEVEN_TP))
            qr, kr, vr = L._project_qkv(cfg, own, x, pos, shards=sh)
            q_diff += int((_bf16_steps_apart(torch, qr, q[:, :, lo:hi])
                           > 0).sum())
            kv_equal &= _bits_equal(torch, kr, k) and _bits_equal(
                torch, vr, v)
        out["attention_f32_rel_gap"] = _held_split(
            torch.cat(parts, dim=2), whole, f"{tag} attention")
        if not kv_equal:
            _fail(f"[dist uneven split] {tag}: a rank's K / V of every KV "
                  "head part from the whole layer's")
        out["own_q_rounded_outputs_differing"] = q_diff
        out["q_outputs"] = q.numel()
        o = whole.to(torch.bfloat16).reshape(b * s, hq * dh)
    # the whole K / V leaves at the attention's rows, as projected above
    out["kv"] = [dict(r, shapes=[[r["M"], r["K"], r["N"]]])
                 for r in check_mixed_matmul(
                     torch, {n: attn[n] for n in ("wk", "wv")
                             if hasattr(attn[n], "w4")},
                     timer, peaks, gen, ms=(b * s,))]
    out["wo"] = _view_products(torch, tag, {"wo": attn["wo"]}, "row", timer,
                               peaks, gen)
    out["wo"].append(_split_product(
        torch, f"{tag} wo (attention output)", attn["wo"],
        [local_view(attn["wo"], "row", r, UNEVEN_TP)
         for r in range(UNEVEN_TP)], "row", o, timer, peaks))
    return out


def check_rglru_split(torch, cfg, rec, timer, peaks, gen) -> dict:
    """An rglru block's split at tp UNEVEN_TP (each rank's R / tp
    channels cut a gate head in two at recurrentgemma's 8 heads of 320):
    ``w_x`` / ``w_gate``'s column views (N / tp columns) and ``w_out``'s
    row views; the gates of each rank's channels
    (``recurrent._rg_gates_cut``, the whole input handed in as the
    gather over "model" gives it) joined against the whole
    block-diagonal product (f32)."""
    from repro_torch.models import recurrent as R
    from repro_torch.models.common import Parallel
    par = Parallel(tp=UNEVEN_TP)
    r_width = rec["w_x"].n
    per = r_width // UNEVEN_TP
    hd = rec["w_inp"].shape[1]
    out = {"rnn": r_width, "gate_heads": rec["w_inp"].shape[0],
           "channels_per_rank": per,
           "gate_heads_per_rank": [list(range(r * per // hd,
                                              -(-(r + 1) * per // hd)))
                                   for r in range(UNEVEN_TP)]}
    out["columns"] = _view_products(
        torch, "rg", {n: rec[n] for n in ("w_x", "w_gate")}, "column", timer,
        peaks, gen)
    b, s = UNEVEN_ATT_SHAPE
    u = torch.randn((b, s, r_width), generator=gen, device="cuda").to(
        torch.bfloat16)
    with torch.no_grad():
        gi, gr = R._rg_gates(rec, u)
        parts_i, parts_r = [], []
        for r in range(UNEVEN_TP):
            sh = _rank_shards(par, r, whole=u)
            ci, cr = R._rg_gates_cut(rec, u[..., r * per:(r + 1) * per], sh)
            parts_i.append(ci)
            parts_r.append(cr)
    out["input_gate_f32_rel_gap"] = _held_split(torch.cat(parts_i, -1), gi,
                                                "rg input gate")
    out["recurrence_gate_f32_rel_gap"] = _held_split(
        torch.cat(parts_r, -1), gr, "rg recurrence gate")
    out["w_out"] = _view_products(torch, "rg", {"w_out": rec["w_out"]},
                                  "row", timer, peaks, gen)
    return out


def check_mlstm_split(torch, cfg, cell, timer, peaks, gen) -> dict:
    """An mLSTM block's split at tp UNEVEN_TP (xlstm-1.3b's 4 heads: one
    on ranks 0-3, none on 4-15): the head views of ``w_q``, ``w_k``,
    ``w_v`` and ``w_gate``; each rank's heads through the chunkwise
    recurrence (``recurrent.mlstm_chunks``) from the whole block's q,
    k, v and gates, joined against the whole (f32); the rank's own
    projections (``recurrent._mlstm_qkvg`` with its ``Shards``: its head
    views and its heads' columns of ``w_if``), their rounded outputs
    counted against the whole's and its log gates held (f32);
    ``w_out``'s row views."""
    from repro_torch.distributed.sharding import head_view, local_view
    from repro_torch.models import recurrent as R
    from repro_torch.models.common import Parallel
    par = Parallel(tp=UNEVEN_TP)
    h = cfg.n_heads
    ranks = [_rank_shards(par, r) for r in range(UNEVEN_TP)]
    names = ("w_q", "w_k", "w_v", "w_gate")
    out = {"heads": h, "heads_per_rank": [hi - lo for lo, hi in
                                          (sh.heads(h) for sh in ranks)]}
    out["columns"] = _view_products(torch, "xl", {n: cell[n] for n in names},
                                    "column", timer, peaks, gen, h)
    b, s = UNEVEN_ATT_SHAPE
    x = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda").to(
        torch.bfloat16)
    with torch.no_grad():
        q, k, v, g, li, lf = R._mlstm_qkvg(cfg, cell, x)
        whole, _ = R.mlstm_chunks(q, k, v, li, lf)
        parts, diff, gates = [], 0, []
        for r, sh in enumerate(ranks):
            lo, hi = sh.heads(h)
            parts.append(R.mlstm_chunks(q[:, :, lo:hi], k[:, :, lo:hi],
                                        v[:, :, lo:hi], li[..., lo:hi],
                                        lf[..., lo:hi])[0])
            own = dict(cell, **{n: head_view(cell[n], h, r, UNEVEN_TP)
                                for n in names})
            qr, kr, vr, gr_, lir, lfr = R._mlstm_qkvg(cfg, own, x, sh)
            for a, w in ((qr, q[:, :, lo:hi]), (kr, k[:, :, lo:hi]),
                         (vr, v[:, :, lo:hi])):
                diff += int((a != w).sum())
            gates.append((torch.cat([lir, lfr], -1),
                          torch.cat([li[..., lo:hi], lf[..., lo:hi]], -1)))
        out["recurrence_f32_rel_gap"] = _held_split(
            torch.cat(parts, dim=2), whole, "xl mLSTM recurrence")
        out["log_gates_f32_rel_gap"] = _held_split(
            torch.cat([a for a, _ in gates], -1),
            torch.cat([w for _, w in gates], -1), "xl log gates")
        out["own_qkv_outputs_differing"] = diff
        o = (whole.reshape(b, s, -1).to(torch.bfloat16) * g).reshape(b * s, -1)
    out["w_out"] = _view_products(torch, "xl", {"w_out": cell["w_out"]},
                                  "row", timer, peaks, gen)
    out["w_out"].append(_split_product(
        torch, "xl w_out (the read-out)", cell["w_out"],
        [local_view(cell["w_out"], "row", r, UNEVEN_TP)
         for r in range(UNEVEN_TP)], "row", o, timer, peaks))
    return out


def check_ctx_combine(torch, tag, b, w, hkv, hq, dh, window, softcap, timer,
                      gen) -> dict:
    """The context-sharded decode (the "ctx" cache layout where the
    run-time KV heads do not divide tp): ``b`` slots of a ``w``-slot
    ring of every run-time KV head cut into UNEVEN_TP chunks, each
    rank's (max, sum, accumulator) of ``layers.attend_split`` combined
    as the all-reduces over "model" combine them
    (``layers.drive_split``), against one device's decode attention
    (``layers._attend``) over the whole ring.  Slots of lengths from
    one key to a ring that has turned over, and an empty one (no live
    key: spread evenly, as one device's).  f32 caches are held within
    SPLIT_RTOL of max|y| (the same sums in another order); on bf16
    caches the weights are rounded to bf16 from sums in another order,
    so the gap is reported."""
    from repro_torch.models import layers as L
    wc = w // UNEVEN_TP
    lens = torch.tensor([w + 37, w, w // 2 + 5, 3 * wc, wc + 1, 17, 1, 0],
                        device="cuda")[:b]
    slot = torch.arange(w, device="cuda")
    # slot s holds the latest position p < len with p % w == s
    last = lens[:, None] - 1
    kp = last - torch.remainder(last - slot, w)
    kp = torch.where((kp >= 0) & (lens[:, None] > 0), kp, -1)
    qp = last.clamp_min(0)[:, :, None]
    kq = kp[:, None, :]
    mask = (kq <= qp) & (kq >= 0)
    if window is not None:
        mask = mask & (qp - kq < window)
    out = {"slots": b, "window_slots": w, "chunks": UNEVEN_TP,
           "chunk_slots": wc, "kv_heads": hkv, "heads": hq, "head_dim": dh,
           "lens": lens.tolist()}
    for dtype in (torch.float32, torch.bfloat16):
        k = torch.randn((b, w, hkv, dh), generator=gen, device="cuda").to(
            dtype)
        v = torch.randn((b, w, hkv, dh), generator=gen, device="cuda").to(
            dtype)
        q = torch.randn((b, 1, hq, dh), generator=gen, device="cuda").to(
            dtype)

        def one():
            return L._attend(q, k, v, mask, softcap)

        def split():
            return L.drive_split([L.attend_split(
                q, k[:, c * wc:(c + 1) * wc], v[:, c * wc:(c + 1) * wc],
                mask[..., c * wc:(c + 1) * wc], softcap)
                for c in range(UNEVEN_TP)])

        with torch.no_grad():
            want = one()
            outs = split()
        if not all(torch.equal(o, outs[0]) for o in outs[1:]):
            _fail(f"[dist uneven ctx] {tag}: the ranks' combined outputs "
                  "differ")
        name = "f32" if dtype == torch.float32 else "bf16"
        gap = float((outs[0] - want).abs().max()
                    / want.abs().max().clamp_min(1e-30))
        if dtype == torch.float32:
            gap = _held_split(outs[0], want, f"{tag} ctx combine f32")
        with torch.no_grad():
            out[name] = {"rel_gap": gap, "one_device_ms": timer.ms(one),
                         "sixteen_chunks_ms": timer.ms(split)}
        del k, v, q
    return out


def _layer0(torch, cfg, pos: int, qcfg):
    """Layer 0's block at pattern position ``pos`` of ``cfg``'s first
    stage, alone: its bf16 weights materialized as a whole
    ``init_params`` would (seed 0) and quantized data-free unfused."""
    from repro_torch.core.pipeline import quantize_params_data_free
    from repro_torch.models import model as M
    from repro_torch.models.param import materialize
    decl = M.declare_params(cfg)["stages"][0][0][pos]
    block = materialize(decl, 0, "cuda", prefix=("stages", 0, 0, pos))
    return quantize_params_data_free({"stages": [[(block,)]]}, qcfg,
                                     min_dim=DIST_SERVE_MIN_DIM,
                                     fuse=False)["stages"][0][0][0]


def run_dist_uneven(torch, kernels, smi: str, peaks, checked) -> dict:
    """``[dist uneven]``: step 1, phi4-mini-3.8b (24 query heads over 8
    KV heads, never built on the card before) at full width and depth
    from seed 0, quantized data-free unfused (its packed shapes and
    dtypes equal ``declare_quantized``'s under the prefill cell's
    preset): a prefill of 8 x DIST_SERVE_PROMPT tokens and UNEVEN_STEPS
    greedy steps on one device and through ``model.shard_for_serving``
    as one NCCL rank, the same bits, equal mixed_matmul launches and no
    paged launch, every new packed shape held; its sharded train step
    at full width and UNEVEN_TRAIN_DEPTH layers, KIND_DIST_STEPS steps
    of KIND_DIST_ROWS x KIND_DIST_SEQ tokens, against one device (the
    same bits, no launch).  Step 2, the split arithmetic of tp
    UNEVEN_TP rank after rank, which one NCCL rank (tp 1) cannot run:
    phi4-mini's and llava-next-34b's layer 0 attention
    (``check_attention_split``), recurrentgemma-2b's first rglru and
    first local layer, xlstm-1.3b's first mLSTM layer, and the
    context-sharded decode combine of phi4-mini at the decode_32k
    window and of recurrentgemma's local window
    (``check_ctx_combine``).  Returns the results with ``held``, the
    packed-matmul rows held here."""
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPE_CELLS, Stage
    from repro_torch.core.pipeline import quantize_params_data_free
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.kernels.mixed_matmul import KERNEL
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.presets import make_preset
    from repro_torch.launch.qdeclare import declare_quantized
    from repro_torch.models import model as M
    from repro_torch import pytree
    cfg = registry.get(UNEVEN_ARCH)
    qcfg = QuantConfig(ratio=0.2, multiple=16)
    gen = torch.Generator(device="cuda").manual_seed(41)
    timer = Timer(torch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = dict(KERNEL.shapes)
    qparams, quant_ms = _synced(torch, lambda: quantize_params_data_free(
        M.init_params(cfg, 0, "cuda"), qcfg, min_dim=DIST_SERVE_MIN_DIM))
    b, s = DIST_SERVE_ROWS, DIST_SERVE_PROMPT
    batch = {"tokens": torch.randint(1, cfg.vocab, (b, s), generator=gen,
                                     device="cuda", dtype=torch.int32),
             "positions": torch.arange(s, dtype=torch.int32,
                                       device="cuda").expand(b, s)}
    serve = {"arch": cfg.name, "layers": cfg.n_layers, "rows": b,
             "prompt": s, "steps": UNEVEN_STEPS,
             "bits_per_weight": check_bits(qparams, "dist uneven"),
             "quantize_s": quant_ms / 1e3}
    _reset(kernels)
    one = _serve_greedy(torch, M, cfg, qparams, batch, steps=UNEVEN_STEPS)
    one_launches = _launches(kernels)
    one_peak = torch.cuda.max_memory_allocated() / 1e9
    out = {}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        cell = next(c for c in SHAPE_CELLS if c.kind == "prefill")
        preset = make_preset(cfg, cell, mesh)
        abstract, specs = declare_quantized(cfg, preset.par, qcfg,
                                            preset.rules,
                                            min_dim=DIST_SERVE_MIN_DIM)
        serve["declared_leaves_equal"] = _same_declaration(qparams, abstract)
        torch.cuda.reset_peak_memory_stats()
        (shards, lp), place_ms = _synced(torch, lambda: M.shard_for_serving(
            cfg, preset.par, qparams, specs, mesh))
        _reset(kernels)
        sh = _serve_greedy(torch, M, cfg, lp, batch, shards,
                           steps=UNEVEN_STEPS)
        sh_launches = _launches(kernels)
        sh_peak = torch.cuda.max_memory_allocated() / 1e9
        del lp, shards
        same = all(_bits_equal(torch, a, c) for a, c in zip(
            one["logits"], sh["logits"])) and all(
            torch.equal(a, c) for a, c in zip(one["tokens"], sh["tokens"]))
        gap = max(float((a.float() - c.float()).abs().max())
                  for a, c in zip(one["logits"], sh["logits"]))
        toks = b * UNEVEN_STEPS

        def side(r, launches, peak):
            return {"prefill_ms": r["prefill_ms"],
                    "decode_step_ms": sum(r["step_ms"]) / len(r["step_ms"]),
                    "decode_tokens_per_s": toks * 1e3 / sum(r["step_ms"]),
                    "peak_mem_gb": peak, "launches": launches}

        serve.update(one_device=side(one, one_launches, one_peak),
                     sharded=dict(side(sh, sh_launches, sh_peak),
                                  mesh=[1, 1], place_ms=place_ms),
                     bit_identical=same, max_logit_gap=gap)
        print(f"[dist uneven phi4 serve] {smi}: " + json.dumps(serve),
              flush=True)
        if not same:
            _fail(f"[dist uneven phi4 serve] the sharded prefill and decode "
                  f"part from one device's (largest logit gap {gap})")
        for what, n in (("one device", one_launches),
                        ("sharded", sh_launches)):
            if n["mixed_matmul"] <= 0:
                _fail(f"[dist uneven phi4 serve] {what}: kernel "
                      "mixed_matmul was not launched")
            if n["paged_attention"] or n["paged_prefill"]:
                _fail(f"[dist uneven phi4 serve] {what}: a paged attention "
                      "kernel launched on the contiguous path")
        if one_launches["mixed_matmul"] != sh_launches["mixed_matmul"]:
            _fail(f"[dist uneven phi4 serve] mixed_matmul launched "
                  f"{sh_launches} times sharded against {one_launches} on "
                  "one device")
        del one, sh, batch
        out["phi4 serve"] = serve
        # the sharded train step at full width, cut depth
        tcfg = dataclasses.replace(cfg, stages=(Stage(
            ("dense",), UNEVEN_TRAIN_DEPTH),))
        batches = _kind_batches(torch, tcfg, KIND_DIST_ROWS, KIND_DIST_SEQ,
                                KIND_DIST_STEPS, 0)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset(kernels)
        losses, ms, fn, state = _kind_steps(torch, train, tcfg, batches)
        t_one = {"losses": losses, "step_ms": ms,
                 "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        _no_launches("[dist uneven phi4 train] one device", kernels)
        ref = [t.detach().clone() for t in pytree.leaves(state["params"])]
        del fn, state
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        par, rules = train.parallel_for(mesh, 1, True, 1024, fsdp=True)
        tshards = train.make_shards(tcfg, par, mesh, rules)
        _reset(kernels)
        dlosses, dms, fn, state = _kind_steps(torch, train, tcfg, batches,
                                              tshards)
        t_sh = {"losses": dlosses, "step_ms": dms,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": _launches(kernels)}
        _no_launches("[dist uneven phi4 train] sharded", kernels)
        held_t = _held(torch, "uneven phi4", tcfg, losses, dlosses, ref,
                       state)
        if not held_t["bit_identical"]:
            _fail("[dist uneven phi4 train] the sharded step parts from the "
                  f"one device's: {held_t}")
        out["phi4 train"] = {"arch": cfg.name, "layers": tcfg.n_layers,
                             "of_layers": cfg.n_layers,
                             "rows": KIND_DIST_ROWS, "seq": KIND_DIST_SEQ,
                             "one_device": t_one, "sharded": t_sh, **held_t}
        print(f"[dist uneven phi4 train] {smi}: "
              + json.dumps(out["phi4 train"]), flush=True)
        del fn, state, ref, batches
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    new = [sh_ for sh_, c in KERNEL.shapes.items() if c > before.get(sh_, 0)]
    held = hold_new_shapes(torch, qparams, new, checked, timer, peaks, gen,
                           "phi4")
    if held:
        print_rows("dist uneven phi4 mixed_matmul",
                   "the shapes new to the phase", held,
                   sorted({r["M"] for r in held}))
    out["phi4 serve"]["shapes_held_here"] = [[r["M"], r["K"], r["N"]]
                                             for r in held]
    # step 2: the tp-16 split arithmetic, rank after rank
    split = {"phi4 attention": check_attention_split(
        torch, "phi4", cfg, qparams["stages"][0][0][0]["attn"], None, timer,
        peaks, gen)}
    del qparams
    torch.cuda.empty_cache()
    vcfg = registry.get(VLM_ARCH)
    split["llava attention"] = check_attention_split(
        torch, "llava", vcfg, _layer0(torch, vcfg, 0, qcfg)["attn"], None,
        timer, peaks, gen)
    rcfg = registry.get(RG_ARCH)
    split["rg rglru"] = check_rglru_split(
        torch, rcfg, _layer0(torch, rcfg, 0, qcfg)["rec"], timer, peaks, gen)
    local_pos = rcfg.stages[0].pattern.index("local")
    split["rg local attention"] = check_attention_split(
        torch, "rg local", rcfg,
        _layer0(torch, rcfg, local_pos, qcfg)["attn"], rcfg.local_window,
        timer, peaks, gen)
    xcfg = registry.get(XL_ARCH)
    split["xl mlstm"] = check_mlstm_split(
        torch, xcfg, _layer0(torch, xcfg, 0, qcfg)["cell"], timer, peaks, gen)
    torch.cuda.empty_cache()
    decode = next(c for c in SHAPE_CELLS if c.name == "decode_32k")
    from repro_torch.models.common import Parallel
    par16 = Parallel(tp=UNEVEN_TP)
    split["phi4 ctx combine"] = check_ctx_combine(
        torch, "phi4", CTX_SLOTS, decode.seq_len,
        par16.kv_heads_run(cfg.n_kv_heads, cfg.n_heads), cfg.n_heads,
        cfg.head_dim_, None, cfg.logit_softcap, timer, gen)
    split["rg local ctx combine"] = check_ctx_combine(
        torch, "rg local", CTX_SLOTS, rcfg.local_window,
        par16.kv_heads_run(rcfg.n_kv_heads, rcfg.n_heads), rcfg.n_heads,
        rcfg.head_dim_, rcfg.local_window, rcfg.logit_softcap, timer, gen)
    for name, row in split.items():
        print(f"[dist uneven split {name}] {smi} (tp {UNEVEN_TP}, f32 gap "
              f"limit {SPLIT_RTOL} of max|y|): " + json.dumps(row),
              flush=True)
        for rows in row.values():
            if isinstance(rows, list) and rows and isinstance(rows[0], dict):
                for r in rows:
                    if "shapes" in r:
                        checked = set(checked) | {tuple(t) for t in
                                                  r["shapes"]}
    out["split"] = split
    out["held"] = held
    out["checked"] = checked
    del timer
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 19: the sequence-parallel residual stream
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _count_stream(counts: dict):
    """Count the calls of ``Shards``' stream entry and exit methods in
    ``counts`` (name -> calls): the route a run takes through them."""
    from repro_torch.models.common import Shards
    names = ("along", "stream_in", "stream_out", "stream_rep",
             "stream_leaf", "stream_last")
    plain = {n: getattr(Shards, n) for n in names}

    def counted(n):
        def call(self, *a, **k):
            counts[n] = counts.get(n, 0) + 1
            return plain[n](self, *a, **k)
        return call
    for n in names:
        setattr(Shards, n, counted(n))
    try:
        yield counts
    finally:
        for n, f in plain.items():
            setattr(Shards, n, f)


def _sp_block(torch, arch: str, qcfg):
    """Layer 0's dense block of ``arch`` at full width, bf16 from seed
    0 as a whole ``init_params`` would make it, and the same quantized
    data-free unfused (``_layer0``)."""
    from repro_torch.models import model as M
    from repro_torch.models.param import materialize
    from repro_torch.configs import registry
    cfg = registry.get(arch)
    decl = M.declare_params(cfg)["stages"][0][0][0]
    dense = materialize(decl, 0, "cuda", prefix=("stages", 0, 0, 0))
    return cfg, dense, _layer0(torch, cfg, 0, qcfg)


def check_sp_split(torch, tag, cfg, dense, packed, timer, peaks, gen,
                   kernels) -> dict:
    """The sequence-parallel split arithmetic of one block, rank after
    rank at each tp of SP_TPS on a stream of SP_SHAPE: each rank's
    chunk (``sharding.chunk_range``) of ln1, of the residual add and of
    ln2 (``transformer._norm`` on the chunk) bit-identical to the
    whole's rows; the row products of ``wo`` (the rank's whole heads)
    and ``wd`` (its ffn rows), plain in f32 and packed (the row views of
    ``sharding.local_view`` through ``_split_product``: each held
    against its plain version), the f32 partials summed in rank order
    and held within SPLIT_RTOL of max|y| of one device's f32 output
    (the reduce-scatter cuts that sum into the ranks' chunks of
    positions, which cover every row once), the plain gap printed
    beside a reordered f32 sum's rigorous bound (2 gamma_K sum_k
    |x_k w_k| over max|y|, as ``check_split_arithmetic`` derives it);
    and on a stream of SP_EMPTY positions
    the ranks whose chunk is empty run the chunk's work on no position,
    launching nothing."""
    from repro_torch.distributed.sharding import chunk_range, local_view
    from repro_torch.models import transformer as T
    b, s = SP_SHAPE
    d = cfg.d_model
    x = torch.randn((b, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    h = torch.randn((b, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    z1 = T._norm(cfg, dense["ln1"], x)
    x2 = x + h
    z2 = T._norm(cfg, dense["ln2"], x2)
    out = {"arch": cfg.name, "stream": [b, s, d], "tps": list(SP_TPS),
           "chunks": {}, "norm_rows_bit_identical": True, "products": []}
    for tp in SP_TPS:
        lens = []
        for r in range(tp):
            lo, hi = chunk_range(s, tp, r)
            lens.append(hi - lo)
            xr = x[:, lo:hi]
            x2r = xr + h[:, lo:hi]
            same = (_bits_equal(torch, T._norm(cfg, dense["ln1"], xr),
                                z1[:, lo:hi])
                    and _bits_equal(torch, x2r, x2[:, lo:hi])
                    and _bits_equal(torch, T._norm(cfg, dense["ln2"], x2r),
                                    z2[:, lo:hi]))
            if not same:
                _fail(f"[dist sp split {tag}] tp {tp} rank {r}: the chunk's "
                      "norm or residual rows part from the whole's")
        out["chunks"][str(tp)] = sorted(set(lens))
    dh, hq = cfg.head_dim_, cfg.n_heads
    for name, sub in (("wo", "attn"), ("wd", "mlp")):
        w = dense[sub][name]
        k = w.shape[0]
        xin = torch.randn((b * s, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        whole = xin.float() @ w.float()
        gamma = k * 2.0 ** -24 / (1 - k * 2.0 ** -24)
        derived = float(2 * gamma * (xin.float().abs() @ w.float().abs())
                        .max() / whole.abs().max())
        for tp in SP_TPS:
            total = torch.zeros_like(whole)
            for r in range(tp):
                lo, hi = (chunk_range(hq, tp, r) if name == "wo"
                          else chunk_range(k, tp, r))
                if name == "wo":
                    lo, hi = lo * dh, hi * dh
                total += xin[:, lo:hi].float() @ w[lo:hi].float()
            gap = _held_split(total, whole, f"sp {tag} plain {name} tp={tp}")
            out["products"].append({"leaf": name, "kind": "plain f32",
                                    "tp": tp, "K": k, "N": w.shape[1],
                                    "f32_rel_gap": gap,
                                    "derived_rel_bound": derived})
        q = packed[sub][name]
        for tp in SP_TPS:
            views = [local_view(q, "row", r, tp) for r in range(tp)]
            row = _split_product(torch, f"sp {tag} {name} tp={tp}", q, views,
                                 "row", xin, timer, peaks)
            out["products"].append(dict(row, kind="packed row views"))
        del xin, whole
    # an empty chunk: the trailing ranks of a stream shorter than tp
    xe = x[:, :SP_EMPTY]
    empty = 0
    for tp in SP_TPS:
        for r in range(tp):
            lo, hi = chunk_range(SP_EMPTY, tp, r)
            if hi > lo:
                continue
            _reset(kernels)
            xr = xe[:, lo:hi]
            z = T._norm(cfg, dense["ln1"], xr + h[:, lo:hi])
            launched = sum(_launches(kernels).values())
            if launched or tuple(z.shape) != (b, 0, d):
                _fail(f"[dist sp split {tag}] tp {tp} rank {r}: an empty "
                      f"chunk gave {tuple(z.shape)} and launched {launched} "
                      "kernels")
            empty += 1
    out["empty_chunks_checked"] = empty
    return out


def _saved_inputs_gb(cfg, par, rows: int, seq: int) -> dict:
    """Bytes the superblock checkpoints of one microbatch keep on a rank
    (one bf16 stream input a layer): the whole sequence, and the rank's
    chunk of it with ``sp``."""
    from repro_torch.distributed.sharding import chunk_range
    per_pos = rows * cfg.d_model * 2 * cfg.n_layers
    lo, hi = chunk_range(seq, par.tp, 0)
    return {"replicated_gb": per_pos * seq / 1e9,
            "sp_gb": per_pos * (hi - lo) / 1e9}


def run_dist_sp(torch, kernels, smi: str, peaks, checked) -> dict:
    """``[dist sp]``: the sequence-parallel stream.  (a) qwen2.5-3b as
    one NCCL rank on a (1, 1) mesh: its sharded train step at full width
    and SP_TRAIN_DEPTH layers with ``Parallel.sp`` on and off, each the
    same bits as one device's with no launch, and its sharded serving at
    full depth (data-free unfused, prefill and UNEVEN_STEPS greedy
    steps) with ``sp`` on and off, each the same bits as one device's
    with equal mixed_matmul launches and no paged launch; at one rank
    the stream's entry and exit are identities, and their calls are
    counted to show the route goes through them.  (b) The split
    arithmetic of tp 4 and 16 (``check_sp_split``) on one block of
    qwen2.5-3b and one of phi4-mini-3.8b.  (c) The peak GB of the sp
    train step at one rank, beside the saved superblock inputs per rank
    of the tp-16 pod preset for train_4k, replicated and with ``sp``
    (arithmetic).  Returns the results with ``held`` (the packed-matmul
    rows held here) and ``checked``."""
    import types
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPE_CELLS, Stage
    from repro_torch.core.pipeline import quantize_params_data_free
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.kernels.mixed_matmul import KERNEL
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.presets import make_preset
    from repro_torch.launch.qdeclare import declare_quantized
    from repro_torch.models import model as M
    from repro_torch import pytree
    cfg = registry.get(TRAIN_ARCH)
    qcfg = QuantConfig(ratio=0.2, multiple=16)
    gen = torch.Generator(device="cuda").manual_seed(43)
    timer = Timer(torch)
    torch.cuda.empty_cache()
    before = dict(KERNEL.shapes)
    out = {}
    # (a) training: one device, then sp on and off as one NCCL rank
    tcfg = dataclasses.replace(cfg, stages=(Stage(("dense",),
                                                  SP_TRAIN_DEPTH),))
    batches = _kind_batches(torch, tcfg, KIND_DIST_ROWS, KIND_DIST_SEQ,
                            KIND_DIST_STEPS, 0)
    torch.cuda.reset_peak_memory_stats()
    _reset(kernels)
    losses, ms, fn, state = _kind_steps(torch, train, tcfg, batches)
    _no_launches("[dist sp train] one device", kernels)
    t_one = {"losses": losses, "step_ms": ms,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    ref = [t.detach().clone() for t in pytree.leaves(state["params"])]
    del fn, state
    serve_cfg = cfg
    qparams = quantize_params_data_free(M.init_params(serve_cfg, 0, "cuda"),
                                        qcfg, min_dim=DIST_SERVE_MIN_DIM)
    bs, s = DIST_SERVE_ROWS, DIST_SERVE_PROMPT
    batch = {"tokens": torch.randint(1, cfg.vocab, (bs, s), generator=gen,
                                     device="cuda", dtype=torch.int32),
             "positions": torch.arange(s, dtype=torch.int32,
                                       device="cuda").expand(bs, s)}
    _reset(kernels)
    one = _serve_greedy(torch, M, serve_cfg, qparams, batch,
                        steps=UNEVEN_STEPS)
    one_launches = _launches(kernels)
    train_runs, serve_runs = {}, {}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        for sp in (True, False):
            tag = "sp" if sp else "replicated"
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            par, rules = train.parallel_for(mesh, 1, True, 1024, fsdp=True)
            par = dataclasses.replace(par, sp=sp)
            tshards = train.make_shards(tcfg, par, mesh, rules)
            _reset(kernels)
            with _count_stream({}) as calls:
                dlosses, dms, fn, state = _kind_steps(torch, train, tcfg,
                                                      batches, tshards)
            launches = _launches(kernels)
            _no_launches(f"[dist sp train] {tag}", kernels)
            held_t = _held(torch, f"sp train {tag}", tcfg, losses, dlosses,
                           ref, state)
            train_runs[tag] = {
                "losses": dlosses, "step_ms": dms,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": launches, "stream_calls": calls, **held_t}
            del fn, state
            if not held_t["bit_identical"]:
                _fail(f"[dist sp train] {tag}: the sharded step parts from "
                      f"one device's: {held_t}")
            if not calls.get("stream_in") or not calls.get("stream_out"):
                _fail(f"[dist sp train] {tag}: the step did not go through "
                      f"the stream's entry and exit: {calls}")
        cell = next(c for c in SHAPE_CELLS if c.kind == "prefill")
        for sp in (True, False):
            tag = "sp" if sp else "replicated"
            preset = make_preset(serve_cfg, cell, mesh)
            par = dataclasses.replace(preset.par, sp=sp)
            _, specs = declare_quantized(serve_cfg, par, qcfg, preset.rules,
                                         min_dim=DIST_SERVE_MIN_DIM)
            shards, lp = M.shard_for_serving(serve_cfg, par, qparams, specs,
                                             mesh)
            _reset(kernels)
            with _count_stream({}) as calls:
                sh = _serve_greedy(torch, M, serve_cfg, lp, batch, shards,
                                   steps=UNEVEN_STEPS)
            launches = _launches(kernels)
            del lp, shards
            same = all(_bits_equal(torch, a, c) for a, c in zip(
                one["logits"], sh["logits"])) and all(
                torch.equal(a, c) for a, c in zip(one["tokens"],
                                                  sh["tokens"]))
            serve_runs[tag] = {
                "prefill_ms": sh["prefill_ms"],
                "decode_step_ms": sum(sh["step_ms"]) / len(sh["step_ms"]),
                "launches": launches, "stream_calls": calls,
                "bit_identical": same}
            if not same:
                _fail(f"[dist sp serve] {tag}: sharded prefill and decode "
                      "part from one device's")
            if launches["mixed_matmul"] != one_launches["mixed_matmul"] or \
                    launches["paged_attention"] or launches["paged_prefill"]:
                _fail(f"[dist sp serve] {tag}: launches {launches} against "
                      f"one device's {one_launches}")
            if not calls.get("stream_last"):
                _fail(f"[dist sp serve] {tag}: the prefill did not take its "
                      f"last position through the stream: {calls}")
    finally:
        dist.destroy_process_group()
    out["train"] = {"arch": cfg.name, "layers": SP_TRAIN_DEPTH,
                    "of_layers": cfg.n_layers, "rows": KIND_DIST_ROWS,
                    "seq": KIND_DIST_SEQ, "one_device": t_one, **train_runs}
    out["serve"] = {"arch": cfg.name, "layers": cfg.n_layers, "rows": bs,
                    "prompt": s, "steps": UNEVEN_STEPS,
                    "one_device": {"prefill_ms": one["prefill_ms"],
                                   "decode_step_ms": sum(one["step_ms"])
                                   / len(one["step_ms"]),
                                   "launches": one_launches}, **serve_runs}
    print(f"[dist sp train] {smi}: " + json.dumps(out["train"]), flush=True)
    print(f"[dist sp serve] {smi}: " + json.dumps(out["serve"]), flush=True)
    del one, batch, ref
    torch.cuda.empty_cache()
    new = [sh_ for sh_, c in KERNEL.shapes.items() if c > before.get(sh_, 0)]
    held = hold_new_shapes(torch, qparams, new, checked, timer, peaks, gen,
                           "sp")
    if held:
        print_rows("dist sp mixed_matmul", "the shapes new to the phase",
                   held, sorted({r["M"] for r in held}))
    del qparams
    torch.cuda.empty_cache()
    # (b) the split arithmetic of tp 4 and 16, rank after rank
    split = {}
    checked = set(checked) | {(r["M"], r["K"], r["N"]) for r in held}
    for tag, arch in (("qwen2.5", TRAIN_ARCH), ("phi4", UNEVEN_ARCH)):
        bcfg, dense, packed = _sp_block(torch, arch, qcfg)
        split[tag] = check_sp_split(torch, tag, bcfg, dense, packed, timer,
                                    peaks, gen, kernels)
        for r in split[tag]["products"]:
            checked |= {tuple(t) for t in r.get("shapes", [])}
        print(f"[dist sp split {tag}] {smi} (f32 gap limit {SPLIT_RTOL} "
              f"of max|y|): " + json.dumps(split[tag]), flush=True)
        del dense, packed
        torch.cuda.empty_cache()
    out["split"] = split
    # (c) peak memory, and the pod preset's saved inputs per rank
    cell = next(c for c in SHAPE_CELLS if c.name == "train_4k")
    pod = types.SimpleNamespace(shape={"data": 16, "model": 16},
                                axis_names=("data", "model"),
                                devices=types.SimpleNamespace(size=256))
    ppar = make_preset(cfg, cell, pod).par
    rows = cell.global_batch // ppar.dp // ppar.microbatches
    out["memory"] = {
        "sp_train_peak_gb_one_rank": train_runs["sp"]["peak_mem_gb"],
        "replicated_train_peak_gb_one_rank":
            train_runs["replicated"]["peak_mem_gb"],
        "pod_preset": {"cell": cell.name, "tp": ppar.tp, "dp": ppar.dp,
                       "microbatches": ppar.microbatches,
                       "rows_per_microbatch": rows, "seq": cell.seq_len,
                       "layers": cfg.n_layers,
                       **_saved_inputs_gb(cfg, ppar, rows, cell.seq_len)}}
    print(f"[dist sp memory] {smi}: " + json.dumps(out["memory"]),
          flush=True)
    out["held"] = held
    out["checked"] = checked
    del timer
    torch.cuda.empty_cache()
    return out


# phase 20: the dry-run's cells beside the card's runs of them
DRYRUN_CELL = ("qwen3-4b", "decode_32k", "pod")
DRYRUN_MEM_RTOL = 0.15
DRYRUN_PREDICT = r"""
import dataclasses, json, sys
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeCell, Stage
from repro_torch.core.qlinear import QuantConfig
from repro_torch.launch import dryrun
from repro_torch.launch.dryrun import cell_record
kind = sys.argv[2]
mesh = ((1, 1), ("data", "model"))
if kind == "cpu":
    from repro_torch.configs.base import cell_by_name
    from repro_torch.launch.mesh import production_shape
    arch, cell, mesh_kind = json.loads(sys.argv[3])
    dryrun.trace_device = lambda: "cpu"
    rec = cell_record(registry.get(arch), cell_by_name(cell),
                      *production_shape(multi_pod=mesh_kind == "multipod"))
    with open(sys.argv[1], "w") as f:
        json.dump(rec, f)
    sys.exit(0)
serve, rows, prompt, min_dim, train, depth, t_rows, t_seq = json.loads(
    sys.argv[3])
if kind == "train":
    cfg = dataclasses.replace(registry.get(train),
                              stages=(Stage(("dense",), depth),))
    rec = cell_record(cfg, ShapeCell(kind, t_seq, t_rows, kind), *mesh)
else:
    rec = cell_record(registry.get(serve), ShapeCell(kind, prompt, rows, kind),
                      *mesh, qcfg=QuantConfig(ratio=0.2, multiple=16),
                      min_dim=min_dim)
with open(sys.argv[1], "w") as f:
    json.dump(rec, f)
"""


def _dryrun_env() -> dict:
    import os
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def _packed_flops(shapes: dict) -> int:
    """2·M·K·N summed over packed-matmul launches {(M, K, N): count}."""
    return sum(2 * m * k * n * c for (m, k, n), c in shapes.items())


def _scratch_bytes() -> int:
    """Bytes of the packed matmul's workspaces (split-K partials, the
    gathered x), kept per device and stream and grown at a shape's first
    launch."""
    from repro_torch.kernels import mixed_matmul
    return sum(t.numel() * t.element_size()
               for pair in mixed_matmul._SCRATCH.values() for t in pair
               if t is not None)


def _dryrun_counts(rec: dict) -> dict:
    """A dry-run record's counts: FLOPs, eager bytes, transcendentals,
    collectives, memory and packed calls."""
    coll, mem = rec["collectives"], rec["memory"]
    return {"flops_per_device": rec["flops_per_device"],
            "bytes_accessed_per_device": rec["bytes_accessed_per_device"],
            "transcendentals": rec["transcendentals"],
            "packed_calls": rec["packed_calls"],
            **{k: coll[k] for k in ("operand_bytes", "wire_bytes",
                                    "n_collectives")},
            **{k: mem[k] for k in ("argument_bytes", "output_bytes",
                                   "peak_bytes", "alias_bytes")}}


def _launched_since(before: dict, now: dict) -> dict:
    return {sh: c - before.get(sh, 0) for sh, c in now.items()
            if c > before.get(sh, 0)}


def run_dryrun(torch, kernels, smi: str) -> dict:
    """``[dryrun]``: the port's dry-run (``launch/dryrun.py``) on the
    card's machine, in processes of its own (this one holds NCCL
    groups; the dry-run starts a "fake" one).  (a) ``python -m
    repro_torch.launch.dryrun --arch qwen3-4b --cell decode_32k --mesh
    pod``: rank 0 of the 256-rank pod at full width and depth on fake
    cuda tensors; its FLOPs, eager bytes, collectives, peak GB against
    80, roofline bound and ``trace_s``; the same cell traced on fake
    "cpu" tensors in another process (the route of the CPU sweep in
    PERF.md) must count the same to the digit.  (b) The dry-run's
    ``cell_record``
    of three cells on a (1, 1) fake mesh beside the same steps run on
    the card as one NCCL rank, with the same presets: qwen3-4b at full
    depth served data-free unfused (ratio 0.2, multiple 16), a prefill
    of DIST_SERVE_ROWS x DIST_SERVE_PROMPT tokens then one decode step
    over its caches, and qwen2.5-3b's train step at SP_TRAIN_DEPTH of
    its layers on KIND_DIST_ROWS x KIND_DIST_SEQ tokens.  On each real
    step: ``FlopCounterMode`` plus 2·M·K·N per packed launch must equal
    the dry-run's FLOPs exactly, the packed launches by (M, K, N) the
    dry-run's packed calls, and the peak of ``max_memory_allocated``
    above what the device held before the phase (peak stats reset at
    each step) lie within DRYRUN_MEM_RTOL of the predicted peak.  The
    step's wall ms (card synchronized, a second run outside the
    counters) prints beside the roofline bound, without a check."""
    import tempfile
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeCell, Stage
    from repro_torch.core.pipeline import quantize_params_data_free
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.distributed.compression import CompressionConfig
    from repro_torch.kernels.mixed_matmul import KERNEL
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.presets import make_preset
    from repro_torch.launch.qdeclare import declare_quantized
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamW
    tmp = tempfile.TemporaryDirectory()
    arch, cell_name, mesh_kind = DRYRUN_CELL
    procs = {"cli": subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--cell", cell_name, "--mesh", mesh_kind, "--out", tmp.name],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_dryrun_env(), cwd=str(ROOT))}
    sizes = json.dumps([DIST_SERVE_ARCH, DIST_SERVE_ROWS, DIST_SERVE_PROMPT,
                        DIST_SERVE_MIN_DIM, TRAIN_ARCH, SP_TRAIN_DEPTH,
                        KIND_DIST_ROWS, KIND_DIST_SEQ])
    for kind in ("prefill", "decode", "train", "cpu"):
        procs[kind] = subprocess.Popen(
            [sys.executable, "-c", DRYRUN_PREDICT,
             str(Path(tmp.name) / f"{kind}.json"), kind,
             json.dumps(DRYRUN_CELL) if kind == "cpu" else sizes],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=_dryrun_env(), cwd=str(ROOT))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    scratch0 = _scratch_bytes()
    real = {}
    t0 = time.perf_counter()
    spent = {}

    def counted(tag, fn):
        """One call of ``fn`` under FlopCounterMode, recording its
        FLOPs, launches by shape and peak above ``base`` under ``tag``."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = dict(KERNEL.shapes)
        _reset(kernels)
        with FlopCounterMode(display=False) as fc:
            out = fn()
        torch.cuda.synchronize()
        shapes = _launched_since(before, dict(KERNEL.shapes))
        real[tag] = {"aten_flops": int(fc.get_total_flops()),
                     "packed": shapes, "launches": _launches(kernels),
                     "flops": int(fc.get_total_flops())
                     + _packed_flops(shapes),
                     "max_allocated": torch.cuda.max_memory_allocated(),
                     "peak_bytes": torch.cuda.max_memory_allocated() - base}
        return out

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        cfg = registry.get(DIST_SERVE_ARCH)
        qcfg = QuantConfig(ratio=0.2, multiple=16)
        rows, prompt = DIST_SERVE_ROWS, DIST_SERVE_PROMPT
        pcell = ShapeCell("prefill", prompt, rows, "prefill")
        preset = make_preset(cfg, pcell, mesh)
        _, specs = declare_quantized(cfg, preset.par, qcfg, preset.rules,
                                     min_dim=DIST_SERVE_MIN_DIM)
        qparams = quantize_params_data_free(M.init_params(cfg, 0, "cuda"),
                                            qcfg, min_dim=DIST_SERVE_MIN_DIM)
        shards, lp = M.shard_for_serving(cfg, preset.par, qparams, specs,
                                         mesh)
        del qparams
        spent["quantize_place_s"] = time.perf_counter() - t0
        gen = torch.Generator(device="cuda").manual_seed(47)
        batch = {"tokens": torch.randint(1, cfg.vocab, (rows, prompt),
                                         generator=gen, device="cuda",
                                         dtype=torch.int32)}
        with torch.no_grad():
            # one untimed call first: a shape's first launch grows the
            # packed matmul's workspaces, which the dry-run does not hold
            M.prefill(cfg, lp, batch, prompt, preset.par.attn_chunk,
                      shards=shards)
            logits, caches = counted("prefill", lambda: M.prefill(
                cfg, lp, batch, prompt, preset.par.attn_chunk,
                shards=shards))
            real["prefill"]["ms"] = _synced(torch, lambda: M.prefill(
                cfg, lp, batch, prompt, preset.par.attn_chunk,
                shards=shards))[1]
            tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
            pos = torch.full((rows,), prompt, dtype=torch.int32,
                             device="cuda")
            del logits
            counted("decode", lambda: M.decode_step(
                cfg, lp, tok, pos, caches, prompt, shards=shards))
            real["decode"]["ms"] = _synced(torch, lambda: M.decode_step(
                cfg, lp, tok, pos, caches, prompt, shards=shards))[1]
        del lp, shards, caches, batch, tok, pos
        torch.cuda.empty_cache()
        spent["serve_s"] = (time.perf_counter() - t0
                            - spent["quantize_place_s"])
        tcfg = dataclasses.replace(registry.get(TRAIN_ARCH), stages=(
            Stage(("dense",), SP_TRAIN_DEPTH),))
        tcell = ShapeCell("train", KIND_DIST_SEQ, KIND_DIST_ROWS, "train")
        tpre = make_preset(tcfg, tcell, mesh)
        tshards = train.make_shards(tcfg, tpre.par, mesh, tpre.rules)
        opt, ccfg = AdamW(lr=1e-4), CompressionConfig()
        state = train.init_sharded_state(tcfg, opt, ccfg, tshards, seed=0)
        step = train.make_train_step(tcfg, opt, ccfg, tpre.par.microbatches,
                                     tpre.par.remat, tpre.par.attn_chunk,
                                     tshards)
        tb = {k: torch.randint(1, tcfg.vocab, (KIND_DIST_ROWS, KIND_DIST_SEQ),
                               generator=gen, device="cuda",
                               dtype=torch.int32)
              for k in ("tokens", "targets")}
        state, _ = counted("train", lambda: step(state, tb))
        (state, _), real["train"]["ms"] = _synced(torch,
                                                  lambda: step(state, tb))
        del state, step, tshards, tb
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    spent["real_s"] = time.perf_counter() - t0
    scratch = _scratch_bytes() - scratch0
    logs = {k: p.communicate(timeout=600)[0] for k, p in procs.items()}
    spent["wait_s"] = time.perf_counter() - t0 - spent["real_s"]
    for k, p in procs.items():
        if p.returncode:
            _fail(f"[dryrun] the {k} process exited {p.returncode}:\n"
                  + logs[k][-3000:])
    rec = json.loads((Path(tmp.name) / mesh_kind /
                      f"{arch}__{cell_name}.json").read_text())
    pred = {kind: json.loads((Path(tmp.name) / f"{kind}.json").read_text())
            for kind in ("prefill", "decode", "train", "cpu")}
    tmp.cleanup()
    if rec["status"] != "ok":
        _fail(f"[dryrun] {arch} {cell_name}: {rec.get('error')}")
    # the CPU sweep of PERF.md traces fake "cpu" tensors (a CPU-only
    # torch holds no fake cuda one): the same cell on fake "cpu" here
    # must count what the CLI counted on fake "cuda", to the digit
    on_cpu = pred.pop("cpu")
    same = {k: (_dryrun_counts(rec)[k], _dryrun_counts(on_cpu)[k])
            for k in _dryrun_counts(rec)}
    print(f"[dryrun {arch} {cell_name} {mesh_kind} cuda vs cpu] "
          + json.dumps(same), flush=True)
    if (rec["device_type"], on_cpu["device_type"]) != ("cuda", "cpu"):
        _fail(f"[dryrun] traced on {rec['device_type']} and "
              f"{on_cpu['device_type']}, not cuda and cpu")
    for k, (cuda, cpu) in same.items():
        if cuda != cpu:
            _fail(f"[dryrun] {arch} {cell_name}: {k} is {cuda} on fake "
                  f"cuda tensors and {cpu} on fake cpu ones")
    roof = rec["roofline"]
    cli = {"arch": arch, "cell": cell_name, "mesh": mesh_kind,
           "device_type": rec["device_type"], "preset": rec["preset"],
           "flops_per_device": rec["flops_per_device"],
           "eager_bytes_per_device": rec["bytes_accessed_per_device"],
           "collectives": {k: rec["collectives"][k] for k in
                           ("per_kind", "wire_bytes", "n_collectives")},
           "peak_gb": rec["memory"]["peak_bytes"] / 1e9, "of_gb": 80,
           "bound_ms": roof["step_time_lower_bound_s"] * 1e3,
           "dominant": roof["dominant"], "trace_s": rec["trace_s"],
           "place_s": rec["place_s"],
           "arithmetic": "H100 SXM5 data-sheet rates, not measured"}
    print(f"[dryrun timing] {json.dumps(spent)}; the packed matmul's "
          f"workspaces grew by {scratch / 1e9:.3f} GB in the phase "
          "(held in every step's peak below, not in the dry-run's)",
          flush=True)
    print(f"[dryrun {arch} {cell_name} {mesh_kind}] " + json.dumps(cli),
          flush=True)
    out = {"cli": cli, "cuda_vs_cpu": same, "timing": spent,
           "workspace_growth_gb": scratch / 1e9}
    for tag in ("prefill", "decode", "train"):
        p, r = pred[tag], real[tag]
        want_packed = {tuple(int(v) for v in k.split("x")): c
                       for k, c in p.get("packed_calls", {}).items()}
        row = {"flops_dryrun": p["flops_per_device"],
               "flops_card": r["flops"], "aten_flops_card": r["aten_flops"],
               "packed_card": {f"{m}x{k}x{n}": c for (m, k, n), c in
                               sorted(r["packed"].items())},
               "packed_dryrun": p.get("packed_calls", {}),
               "peak_gb_predicted": p["memory"]["peak_bytes"] / 1e9,
               "peak_gb_card": r["peak_bytes"] / 1e9,
               "max_memory_allocated_gb": r["max_allocated"] / 1e9,
               "held_before_gb": base / 1e9,
               "peak_ratio": r["peak_bytes"] / p["memory"]["peak_bytes"],
               "argument_gb_predicted": p["memory"]["argument_bytes"] / 1e9,
               "step_ms_card": r["ms"],
               "bound_ms": p["roofline"]["step_time_lower_bound_s"] * 1e3,
               "dominant": p["roofline"]["dominant"],
               "trace_s": p["trace_s"], "launches": r["launches"]}
        out[tag] = row
        print(f"[dryrun {tag} one rank] {smi}: " + json.dumps(row),
              flush=True)
        if r["flops"] != int(p["flops_per_device"]):
            _fail(f"[dryrun] {tag}: the card's FLOPs {r['flops']} are not "
                  f"the dry-run's {p['flops_per_device']}")
        if r["packed"] != want_packed:
            _fail(f"[dryrun] {tag}: packed launches {r['packed']} against "
                  f"the dry-run's {want_packed}")
        if abs(row["peak_ratio"] - 1) > DRYRUN_MEM_RTOL:
            _fail(f"[dryrun] {tag}: peak {row['peak_gb_card']:.3f} GB on "
                  f"the card against {row['peak_gb_predicted']:.3f} GB "
                  "predicted")
    if not real["prefill"]["packed"] or not real["decode"]["packed"]:
        _fail("[dryrun] the served steps launched no packed matmul")
    return out


# --tp4: sharded serving over four cards, a run of its own (chip_smoke
# with no arguments needs one card).  Each case at full width, cut to
# TP4_DEPTH layers: qwen3-4b (GQA 32 / 8: every rank's KV heads its
# own, tp 4 dividing them) and phi4-mini-3.8b with 2 KV heads (tp 4
# does not divide them: a rank's KV columns are gathered over "model",
# and the sequence-parallel prefill projects them on the rank's chunk)
TP4_WORLD = 4
TP4_CASES = (("qwen3-4b", {}), ("phi4-mini-3.8b", {"n_kv_heads": 2}))
TP4_DEPTH = 4
TP4_STEPS = 8
TP4_RTOL = 2e-2     # logit gap to one device, of its largest |logit|


def _broadcast_tree(torch, dist, tree) -> None:
    """Every tensor of ``tree`` (packed leaves' fields too) set to rank
    0's, in place."""
    from repro_torch.core.qlinear import FIELDS, QLinear, QLinearGroup
    if isinstance(tree, QLinearGroup):
        _broadcast_tree(torch, dist, tree.inner)
    elif isinstance(tree, QLinear):
        for f in FIELDS:
            dist.broadcast(getattr(tree, f), 0)
    elif isinstance(tree, dict):
        for v in tree.values():
            _broadcast_tree(torch, dist, v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _broadcast_tree(torch, dist, v)
    elif isinstance(tree, torch.Tensor):
        dist.broadcast(tree, 0)


def _held_greedy(torch, got, want, rtol: float, vocab: int) -> dict:
    """The largest logit gap of ``got`` to ``want`` (``_serve_greedy``
    runs) over the rows whose greedy tokens still agree, against
    ``rtol`` of want's largest |logit|, both over the ``vocab`` true
    entries (the padded ones hold the f32 minimum); where a row's
    tokens part, the step and want's top-2 gap there, which must lie
    within the same bound (a near tie)."""
    scale = max(float(w[:, :vocab].float().abs().max())
                for w in want["logits"])
    live = torch.ones(want["logits"][0].shape[0], dtype=torch.bool,
                      device=want["logits"][0].device)
    gap, ties = 0.0, []
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        g, w = g[:, :vocab], w[:, :vocab]
        d = (g.float() - w.float()).abs().amax(dim=-1)
        if live.any():
            gap = max(gap, float(d[live].max()))
        if i < len(want["tokens"]):
            parted = live & (got["tokens"][i] != want["tokens"][i])
            for row in parted.nonzero().flatten().tolist():
                top = torch.topk(w[row].float(), 2).values
                ties.append((i, row, float(top[0] - top[1])))
            live &= ~parted
    return {"max_logit_gap": gap, "scale": scale,
            "limit": rtol * scale, "ties": ties,
            "held": gap <= rtol * scale and all(
                t <= rtol * scale for _, _, t in ties)}


def tp4_rank(rank: int, world: int, port: int, out_path: str) -> int:
    """One rank of ``--tp4``: each case of TP4_CASES quantized data-free
    (ratio 0.2, multiple 16) unfused and with ``fuse=True`` (rank 0's
    bytes on every rank), placed by ``launch.qdeclare``'s specs under
    the prefill cell's preset of the (1, world) mesh (sequence-parallel
    at tp > 1) through ``model.shard_for_serving``, and served: a prefill
    of DIST_SERVE_ROWS x DIST_SERVE_PROMPT tokens and TP4_STEPS greedy
    steps.  Rank 0 also serves the same tree on its card alone and
    holds the sharded run against it (``_held_greedy``, TP4_RTOL).  Each
    rank's mixed_matmul launches of the sharded run; rank 0 writes the
    results to ``out_path``."""
    import dataclasses
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPE_CELLS, Stage
    from repro_torch.core.pipeline import quantize_params_data_free
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.kernels import mixed_matmul
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.presets import make_preset
    from repro_torch.launch.qdeclare import declare_quantized
    from repro_torch.models import model as M
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    kernel = mixed_matmul.KERNEL
    qcfg = QuantConfig(ratio=0.2, multiple=16)
    cell = next(c for c in SHAPE_CELLS if c.kind == "prefill")
    rows = []
    try:
        mesh = make_mesh((1, world), ("data", "model"), "cuda")
        b, s = DIST_SERVE_ROWS, DIST_SERVE_PROMPT
        for arch, over in TP4_CASES:
            cfg = dataclasses.replace(
                registry.get(arch), stages=(Stage(("dense",), TP4_DEPTH),),
                **over)
            preset = make_preset(cfg, cell, mesh)
            weights = M.init_params(cfg, 0, "cuda")
            gen = torch.Generator(device="cuda").manual_seed(43)
            batch = {"tokens": torch.randint(
                1, cfg.vocab, (b, s), generator=gen, device="cuda",
                dtype=torch.int32), "positions": torch.arange(
                s, dtype=torch.int32, device="cuda").expand(b, s)}
            dist.broadcast(batch["tokens"], 0)
            for fuse in (False, True):
                q = quantize_params_data_free(weights, qcfg,
                                              min_dim=DIST_SERVE_MIN_DIM,
                                              fuse=fuse)
                _broadcast_tree(torch, dist, q)
                _, specs = declare_quantized(cfg, preset.par, qcfg,
                                             preset.rules,
                                             min_dim=DIST_SERVE_MIN_DIM)
                shards, lp = M.shard_for_serving(cfg, preset.par, q, specs,
                                                 mesh)
                before = kernel.launches
                sh = _serve_greedy(torch, M, cfg, lp, batch, shards,
                                   steps=TP4_STEPS)
                launched = torch.tensor([kernel.launches - before],
                                        device="cuda")
                per_rank = [torch.zeros_like(launched) for _ in range(world)]
                dist.all_gather(per_rank, launched)
                del lp, shards
                row = {"arch": arch, "over": over, "fused": fuse,
                       "tp": world, "sp": preset.par.sp,
                       "layers": TP4_DEPTH, "rows": b, "prompt": s,
                       "steps": TP4_STEPS,
                       "sharded_launches": [int(t) for t in per_rank],
                       "sharded_prefill_ms": sh["prefill_ms"],
                       "sharded_decode_step_ms":
                           sum(sh["step_ms"]) / len(sh["step_ms"])}
                if rank == 0:
                    before = kernel.launches
                    one = _serve_greedy(torch, M, cfg, q, batch,
                                        steps=TP4_STEPS)
                    row.update(one_device_launches=kernel.launches - before,
                               one_device_prefill_ms=one["prefill_ms"],
                               one_device_decode_step_ms=sum(
                                   one["step_ms"]) / len(one["step_ms"]),
                               **_held_greedy(torch, sh, one, TP4_RTOL,
                                              cfg.vocab))
                    del one
                rows.append(row)
                del q, sh
                torch.cuda.empty_cache()
            del weights
        dist.barrier(device_ids=[rank])
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(rows, f)
    return 0


def main_tp4() -> int:
    """``python3 chip_smoke.py --tp4``: build the kernels, then
    TP4_WORLD ranks of :func:`tp4_rank` over NCCL, one card each;
    prints ``[tp4 ...]`` lines and fails unless every run was held and
    every rank launched the packed matmul."""
    import tempfile
    import torch
    if torch.cuda.device_count() < TP4_WORLD:
        print(f"chip_smoke --tp4: needs {TP4_WORLD} cards, has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    smi = nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"[tp4 build] {time.perf_counter() - t0:.1f}s", flush=True)
    port = _free_port()
    with tempfile.TemporaryDirectory() as d:
        out = Path(d) / "tp4.json"
        procs = [subprocess.Popen([sys.executable, str(Path(__file__)),
                                   "--tp4-rank", str(r), str(TP4_WORLD),
                                   str(port), str(out)])
                 for r in range(TP4_WORLD)]
        try:
            codes = [p.wait(timeout=1500) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(codes):
            _fail(f"[tp4] ranks exited with {codes}")
        rows = json.loads(out.read_text())
    for row in rows:
        print(f"[tp4 {row['arch']} {'fused' if row['fused'] else 'unfused'}]"
              f" {smi}: " + json.dumps(row), flush=True)
        if not row["held"]:
            _fail(f"[tp4] {row['arch']} fused={row['fused']}: the sharded "
                  f"run parts from one device: {row}")
        if min(row["sharded_launches"]) <= 0:
            _fail(f"[tp4] a rank launched no packed matmul: {row}")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "tp4": len(rows), "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


class Laps:
    """Wall seconds of each phase, printed as it ends (``[phase]``)."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()

    def __call__(self, phase: str) -> None:
        now = time.perf_counter()
        print(f"[phase] {phase}: {now - self.last:.1f}s (run "
              f"{now - self.t0:.1f}s)", flush=True)
        self.last = now


def _entry(name, replaces, checked, rows, launches, shape, source=None):
    """One kernel's entry of the ``kernels`` line: max error over every
    shape ``checked``, times summed over ``rows``, launches per path."""
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source or name}.cu",
            "replaces": replaces,
            "launches": sum(n[name] for n in launches.values()),
            "launches_by_path": {p: n[name] for p, n in launches.items()},
            "max_abs_err": max(r["max_abs_err"] for r in checked),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in rows) else "operations",
            "library_ms": sum(r["library_ms"] for r in rows),
            "shape": shape}


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
    if sys.argv[1:2] == ["--tp4-rank"]:
        return tp4_rank(*(int(a) for a in sys.argv[2:5]), sys.argv[5])
    if sys.argv[1:] == ["--tp4"]:
        return main_tp4()
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    laps = Laps()
    # -- 1. the card ----------------------------------------------------
    smi = nvidia_smi()
    print(smi, flush=True)
    peak_name, peaks = peaks_for(smi)
    print(f"[card] {torch.cuda.get_device_name(0)}; bounds use the "
          f"{peak_name} data sheet: {peaks[0] / 1e12:.2f} TB/s, "
          f"{peaks[1] / 1e12:.0f} TFLOP/s bf16", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__}"
          f" cuda {torch.version.cuda}", flush=True)

    laps("1")
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
    from repro_torch.kernels import (binary_matmul, int4_matmul,
                                     mixed_matmul, paged_attention,
                                     paged_prefill)
    kernels = {"mixed_matmul": mixed_matmul.KERNEL,
               "paged_attention": paged_attention.KERNEL,
               "paged_prefill": paged_prefill.KERNEL,
               "binary_matmul": binary_matmul.KERNEL,
               "int4_matmul": int4_matmul.KERNEL}
    # the serving path's kernels; binary_matmul and int4_matmul are ops
    # exports that no path of the system calls (as in the JAX package)
    path_kernels = ("mixed_matmul", "paged_attention", "paged_prefill")

    cfg = registry.get("llama-7b")
    print("[plan] resident packed-matmul blocks per SM by row tiles "
          "(CUDA occupancy query): " + json.dumps(
              {nt: mixed_matmul.resident_blocks(0, nt)
               for nt in (1, 2, 4, 8)})
          + "; attention split plans: "
          + json.dumps(attention_plans(torch, cfg)), flush=True)

    laps("2")
    # -- 3. kernels against their plain versions --------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer(torch)
    projs = llama_projections(torch, cfg, gen)
    mm = check_mixed_matmul(torch, projs, timer, peaks, gen)
    print("[mixed_matmul] " + json.dumps(mm), flush=True)
    # the other row counts the driven paths give the packed matmul
    mm_rows = check_mixed_matmul(
        torch, projs, timer, peaks,
        torch.Generator(device="cuda").manual_seed(6), ms=PATH_ROWS,
        host=True)
    print_rows("mixed_matmul", "one fused layer", mm_rows, PATH_ROWS)
    pa = check_paged_attention(torch, cfg, timer, peaks, gen)
    print("[paged_attention] " + json.dumps(pa), flush=True)
    pf = check_paged_prefill(torch, cfg, timer, peaks, gen)
    print("[paged_prefill] " + json.dumps(pf), flush=True)
    # granite's attention (GQA group 2, dh 64) and packed projections
    gcfg = registry.get(MOE_ARCH)
    print("[moe plan] attention split plans at granite's heads: "
          + json.dumps(attention_plans(torch, gcfg)), flush=True)
    gprojs = {k: v for k, v in llama_projections(
        torch, gcfg, torch.Generator(device="cuda").manual_seed(10)).items()
        if k in ("wqkv", "wo")}
    moe_mm = check_mixed_matmul(
        torch, gprojs, timer, peaks,
        torch.Generator(device="cuda").manual_seed(11), ms=MOE_ROWS,
        host=True)
    print_rows("moe mixed_matmul", "granite wqkv+wo", moe_mm, MOE_ROWS)
    moe_pa = check_paged_attention(torch, gcfg, timer, peaks, gen)
    print("[moe paged_attention] " + json.dumps(moe_pa), flush=True)
    moe_pf = check_paged_prefill(torch, gcfg, timer, peaks, gen)
    print("[moe paged_prefill] " + json.dumps(moe_pf), flush=True)
    del gprojs
    # recurrentgemma's seven packed projections and its decode attention
    # (MQA, group 10, dh 256, a 2048-key window)
    rcfg = registry.get(RG_ARCH)
    print("[rg plan] decode split plans at recurrentgemma's heads (hkv 1, "
          "rep 10, dh 256, bf16; resident blocks per SM "
          f"{paged_attention.resident_blocks(0, True, 10, 256)}): "
          + json.dumps({f"B={b} nblk={n}": paged_attention.launch_plan(
              b, 1, 10, 256, n, 16, True, 0)._asdict()
              for b, n in ((8, 32), (8, 189), (4, 256))}), flush=True)
    rprojs = rg_projections(torch, rcfg,
                            torch.Generator(device="cuda").manual_seed(13))
    rg_mm = check_mixed_matmul(
        torch, rprojs, timer, peaks,
        torch.Generator(device="cuda").manual_seed(14), ms=RG_ROWS,
        host=True)
    print_rows("rg mixed_matmul", "the 7 projections", rg_mm, RG_ROWS)
    del rprojs
    rg_pa = check_paged_attention(torch, rcfg, timer, peaks, gen,
                                  lens=RG_ATT_LENS, window=rcfg.local_window,
                                  freed=(0, 150), f32=True)
    print(f"[rg paged_attention] (tolerance rtol {ATT_RTOL}, atol "
          f"{ATT_ATOL}, bf16 and f32) " + json.dumps(rg_pa), flush=True)
    # xlstm's nine packed projections: K and N of 5504 = 43 x 128
    xprojs = xl_projections(torch, registry.get(XL_ARCH),
                            torch.Generator(device="cuda").manual_seed(17))
    xl_mm = check_mixed_matmul(
        torch, xprojs, timer, peaks,
        torch.Generator(device="cuda").manual_seed(18), ms=XL_ROWS,
        host=True)
    print_rows("xl mixed_matmul", "the 9 projections", xl_mm, XL_ROWS)
    del xprojs
    # seamless's packed projections, the encoder's 8 x 1024 frame rows too
    s2t_mm = check_mixed_matmul(
        torch, s2t_projections(torch, registry.get(S2T_ARCH),
                               torch.Generator(device="cuda").manual_seed(19)),
        timer, peaks, torch.Generator(device="cuda").manual_seed(20),
        ms=S2T_ROWS, host=True)
    print_rows("s2t mixed_matmul", "the 5 projection shapes", s2t_mm,
               S2T_ROWS)
    # llava's four fused projections and both attention kernels at its
    # GQA group of 7 (56 / 8 heads, dh 128)
    vcfg = registry.get(VLM_ARCH)
    print("[vlm plan] attention split plans at llava's heads: "
          + json.dumps(attention_plans(torch, vcfg)), flush=True)
    vlm_mm = check_mixed_matmul(
        torch, llama_projections(
            torch, vcfg, torch.Generator(device="cuda").manual_seed(23)),
        timer, peaks, torch.Generator(device="cuda").manual_seed(24),
        ms=VLM_ROWS, host=True)
    print_rows("vlm mixed_matmul", "one fused layer", vlm_mm, VLM_ROWS)
    vgen = torch.Generator(device="cuda").manual_seed(25)
    vlm_pa = check_paged_attention(torch, vcfg, timer, peaks, vgen)
    print(f"[vlm paged_attention] (tolerance rtol {ATT_RTOL}, atol "
          f"{ATT_ATOL}) " + json.dumps(vlm_pa), flush=True)
    vlm_pf = check_paged_prefill(torch, vcfg, timer, peaks, vgen)
    print(f"[vlm paged_prefill] (tolerance rtol {ATT_RTOL}, atol "
          f"{ATT_ATOL}) " + json.dumps(vlm_pf), flush=True)
    # qwen3-4b's unfused packed shapes at the rows of [dist serve]
    q3_mm = check_mixed_matmul(
        torch, qwen3_projections(torch, registry.get(DIST_SERVE_ARCH),
                                 torch.Generator(device="cuda").manual_seed(29)),
        timer, peaks, torch.Generator(device="cuda").manual_seed(30),
        ms=QWEN3_ROWS, host=True)
    print_rows("qwen3 mixed_matmul", "the 5 unfused projection shapes",
               q3_mm, QWEN3_ROWS)
    spans = check_spans(torch, projs, timer, peaks,
                        torch.Generator(device="cuda").manual_seed(1))
    for name, rows in spans.items():
        print(f"[{name}] (tolerance rtol {MM_RTOL}, atol {MM_ATOL}) "
              + json.dumps(rows), flush=True)
    ragged = check_ragged(torch, projs,
                          torch.Generator(device="cuda").manual_seed(3))
    print(f"[ragged] packed matmuls at ragged and one-sided shapes "
          f"(tolerance rtol {MM_RTOL}, atol {MM_ATOL}), repeated calls "
          "bit-identical: " + json.dumps(ragged), flush=True)
    host = host_us(torch, projs, torch.Generator(device="cuda").manual_seed(4))
    print("[host] " + json.dumps(host), flush=True)
    split = kernel_split_us(torch, projs,
                            torch.Generator(device="cuda").manual_seed(5))
    for row in split:
        q = projs[row["proj"]]
        plan = mixed_matmul.launch_plan(row["M"], q.n, q.k, q.k_s, 0)[0]
        row.update(splits=plan.splits, blocks=plan.blocks)
    print("[split] device us per call of each kernel of a packed-matmul "
          "call (profiler, L2 flushed): " + json.dumps(split), flush=True)
    gather = check_gather(torch, projs, split, timer, peaks,
                          torch.Generator(device="cuda").manual_seed(7))
    print("[gather] the perm gather of a decode call, M=8: "
          + json.dumps(gather), flush=True)
    del projs, timer

    laps("3")
    # -- 4. small-input agreement, card against CPU -----------------------
    worst = check_small_reference(torch, registry)
    print(f"[reference] reduced llama-7b, f32: card vs CPU logits agree "
          f"to {worst:.2e} (relative, limit {REF_RTOL})", flush=True)
    cal = check_small_calibrated(torch, registry)
    print("[reference] reduced llama-7b (2 layers), f32, calibrated on the "
          "card and on the CPU: perm and packed bytes equal; "
          + json.dumps(cal), flush=True)
    eng_small = check_small_engines(torch)
    print("[reference] reduced llama-7b, f32, greedy tokens: contiguous "
          "whole-prompt engine equal on the card and the CPU, whole-prompt "
          "equal to chunked prefill on the card, prefix sharing (whole and "
          "chunked) equal on the card and the CPU; "
          + json.dumps(eng_small), flush=True)
    base_small = check_small_baselines(torch, registry)
    print("[reference] reduced llama-7b (2 layers), f32, baselines on the "
          "card and on the CPU: rtn-2, pbllm, billm identical, awq-2 and "
          "billm choices equal, gptq-2 layer-0 objectives within "
          f"{BASE_GPTQ_RTOL}; " + json.dumps(base_small), flush=True)
    # the same on reduced granite: the MoE dispatch (sort, cumsum,
    # index_put) on the card against the CPU
    worst = check_small_reference(torch, registry, MOE_ARCH)
    print(f"[moe reference] reduced granite, f32: card vs CPU logits agree "
          f"to {worst:.2e} (relative, limit {REF_RTOL})", flush=True)
    print("[moe reference] reduced granite, f32, greedy tokens: "
          + json.dumps(check_small_engines(torch, MOE_ARCH)), flush=True)
    print("[moe reference] reduced granite (2 layers), f32, calibrated on "
          "the card and on the CPU: perm and packed bytes equal; "
          + json.dumps(check_small_calibrated(torch, registry, MOE_ARCH)),
          flush=True)
    print("[moe reference] reduced granite (2 layers), f32, baselines on "
          "the card and on the CPU: "
          + json.dumps(check_small_baselines(torch, registry, MOE_ARCH)),
          flush=True)
    # and on reduced recurrentgemma: the RG-LRU's plain ops and the
    # decode kernel at a group of 4 with a window, whole-prompt prefill
    worst = check_small_reference(torch, registry, RG_ARCH)
    print(f"[rg reference] reduced recurrentgemma, f32: card vs CPU logits "
          f"agree to {worst:.2e} (relative, limit {REF_RTOL})", flush=True)
    print("[rg reference] reduced recurrentgemma, f32, greedy tokens of the "
          "contiguous, paged and shared-prefix whole-prompt engines, card = "
          "CPU: " + json.dumps(check_small_engines(torch, RG_ARCH)),
          flush=True)
    print("[rg reference] reduced recurrentgemma (its pattern twice), f32, "
          "calibrated on the card and on the CPU: perm and packed bytes "
          "equal; " + json.dumps(check_small_calibrated(torch, registry,
                                                        RG_ARCH)),
          flush=True)
    # and on reduced xlstm: the mLSTM's chunkwise form and in-place step,
    # the sLSTM's loop and its autograd Function (calibration)
    worst = check_small_reference(torch, registry, XL_ARCH)
    print(f"[xl reference] reduced xlstm, f32: card vs CPU logits agree to "
          f"{worst:.2e} (relative, limit {REF_RTOL})", flush=True)
    print("[xl reference] reduced xlstm, f32, greedy tokens of the "
          "contiguous, paged and shared-prefix whole-prompt engines, card = "
          "CPU: " + json.dumps(check_small_engines(torch, XL_ARCH)),
          flush=True)
    print("[xl reference] reduced xlstm (its pattern twice), f32, calibrated "
          "on the card and on the CPU: perm and packed bytes equal; "
          + json.dumps(check_small_calibrated(torch, registry, XL_ARCH)),
          flush=True)
    # and on reduced seamless (the encoder, cross-attention and its cached
    # K/V) and reduced llava (the vision splice, its engines, its serve)
    print("[s2t reference] reduced seamless, f32, card vs CPU (relative, "
          f"limit {REF_RTOL}): prefill logits, cross K/V, 4 decode steps "
          "each from the CPU's caches: " + json.dumps(
              check_small_prefix_model(torch, registry, S2T_ARCH)),
          flush=True)
    print("[vlm reference] reduced llava, f32, card vs CPU (relative, "
          f"limit {REF_RTOL}): prefill logits with vision embeddings, 4 "
          "decode steps each from the CPU's caches: " + json.dumps(
              check_small_prefix_model(torch, registry, VLM_ARCH)),
          flush=True)
    print("[vlm reference] reduced llava, f32, greedy tokens: "
          + json.dumps(check_small_engines(torch, VLM_ARCH)), flush=True)
    vlm_serve = run_vlm_serve(torch, kernels)
    print("[vlm serve] " + json.dumps(vlm_serve), flush=True)

    laps("4")
    # -- 5. the data-free main path, then whole-prompt prefill -------------
    # from here on the packed matmul counts its launches by (M, K, N)
    mixed_matmul.KERNEL.shapes.clear()
    summary, cfg, qparams = run_main_path(torch, registry, kernels,
                                          path_kernels)
    print("[main] " + json.dumps(summary), flush=True)
    whole = run_whole_prompt_paths(torch, cfg, qparams, kernels)
    loss = run_loss(torch, cfg, qparams)
    print("[loss] forward_loss of the data-free LLaMA-7B: "
          + json.dumps(loss), flush=True)
    shared = run_shared_prefix(torch, cfg, qparams, kernels)
    preprocess = run_preprocess(torch, cfg, qparams, kernels)
    print("[preprocess] " + json.dumps(preprocess), flush=True)
    del qparams
    torch.cuda.empty_cache()
    baselines = run_baselines(torch, cfg, kernels)
    print("[baselines] " + json.dumps(baselines), flush=True)

    laps("5")
    # -- 6. the calibrated path ---------------------------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cal_summary = run_calibrated_path(torch, registry, kernels, path_kernels,
                                      peaks)
    print("[calibrated] " + json.dumps(cal_summary), flush=True)

    laps("6")
    # -- 7. the serve entry point at the reference's defaults ---------------
    torch.cuda.empty_cache()
    serve_default = run_serve_default(torch, kernels)
    print("[serve-default] " + json.dumps(serve_default), flush=True)
    torch.cuda.empty_cache()
    serve_share = run_serve_share_prefix(torch, kernels)
    print("[serve-share-prefix] " + json.dumps(serve_share), flush=True)
    unfused = [r for r in cal_summary["layer0_mixed_matmul"] if r["M"] == 8]
    print(f"[decode layer, M=8] mixed_matmul: fused (4 projections) "
          f"{sum(r['ms'] for r in mm if r['M'] == 8) * 1e3:.1f} us, "
          f"calibrated unfused (7 projections) "
          f"{sum(r['ms'] for r in unfused) * 1e3:.1f} us; dense bf16 "
          f"torch.matmul {sum(r['library_ms'] for r in mm if r['M'] == 8) * 1e3:.1f}"
          f" / {sum(r['library_ms'] for r in unfused) * 1e3:.1f} us",
          flush=True)

    laps("7")
    # -- 8. the MoE block kind: granite at full width and depth ------------
    moe, gcfg = run_moe_path(torch, registry, kernels, path_kernels, peaks)
    moe_cal = run_moe_calibrated(torch, gcfg, kernels, path_kernels, peaks)
    print("[moe calibrated] " + json.dumps(moe_cal), flush=True)
    torch.cuda.empty_cache()
    moe_base = run_model_baselines(torch, gcfg, kernels,
                                   moe["moe"]["bits_per_weight"],
                                   moe["moe loss"]["loss"], "moe")
    print("[moe baselines] " + json.dumps(moe_base), flush=True)

    laps("8")
    # -- 9. the hybrid kinds: recurrentgemma-2b at full width and depth ----
    torch.cuda.empty_cache()
    rg, rcfg = run_rg_path(torch, registry, kernels, peaks)
    rg_cal = run_rg_calibrated(torch, rcfg, kernels, peaks)
    print("[rg calibrated] " + json.dumps(rg_cal), flush=True)

    laps("9")
    # -- 10. the xLSTM kinds: xlstm-1.3b at full width, 16 of 48 layers --
    torch.cuda.empty_cache()
    xl, xcfg = run_xl_path(torch, registry, kernels, peaks)
    xl_cal = run_xl_calibrated(torch, xcfg, kernels, peaks)
    print("[xl calibrated] " + json.dumps(xl_cal), flush=True)
    torch.cuda.empty_cache()
    xl_base = run_model_baselines(torch, xcfg, kernels,
                                  xl["xl"]["bits_per_weight"],
                                  xl["xl loss"]["loss"], "xl")
    print("[xl baselines] " + json.dumps(xl_base), flush=True)

    laps("10")
    # -- 11. the encoder-decoder inputs: seamless-m4t-medium ----------------
    torch.cuda.empty_cache()
    s2t = run_s2t_path(torch, registry, kernels, peaks)

    laps("11")
    # -- 12. the vision-prefix inputs: llava-next-34b at full width ---------
    torch.cuda.empty_cache()
    vlm = run_vlm_path(torch, registry, kernels, path_kernels, peaks)

    laps("12")
    # -- 13. training: qwen2.5-3b at full width and depth -----------------
    torch.cuda.empty_cache()
    run_train(torch, kernels, smi)
    print("[train restart] tiny-lm (4 layers), 12 steps, a failure at step "
          f"9 (limit {RESTART_ATOL}): "
          + json.dumps(run_train_restart(torch, kernels)), flush=True)
    for kind, mb in TRAIN_REF_CASES:
        print(f"[train reference] reduced tiny-lm (3 layers), f32, 3 steps "
              f"with {kind} and {mb} microbatch(es), card vs CPU (losses "
              f"within {TRAIN_LOSS_ATOL}, each leaf within "
              f"{TRAIN_DELTA_RTOL} of its update's norm, parameters within "
              f"{TRAIN_P_ATOL} but for code flips, at most "
              f"{TRAIN_FLIP_FRAC} of them, each within "
              f"{TRAIN_FLIP_ATOL}): "
              + json.dumps(check_train_reference(torch, kind, mb)),
              flush=True)

    laps("13")
    # -- 14. training across devices: the sharded step on one NCCL rank --
    dist_train = run_dist_train(torch, kernels, smi)
    print(f"[dist train] {smi}; qwen2.5-3b (36 layers), one NCCL rank on a "
          "(1, 1) mesh with FSDP, the state as DTensors, against the "
          "one-device step from the same seed: " + json.dumps(dist_train),
          flush=True)
    dist_pipe = run_dist_pipeline(torch, kernels)
    print("[dist pipeline] one stage on the card against plain application: "
          + json.dumps(dist_pipe), flush=True)

    laps("14")
    # -- 15. the sharded step of every other block kind on one NCCL rank --
    dist_kinds = run_dist_kinds(torch, kernels, smi)
    print(f"[dist kinds] {smi}; one NCCL rank on a (1, 1) mesh with FSDP "
          "(EP for granite) against the one-device step from the same seed: "
          + json.dumps({tag: {k: r[k] for k in (
              "bit_identical", "leaves_parted", "max_param_gap")}
              | {"step_ms": [r["one_device"]["step_ms"],
                             r["sharded"]["step_ms"]]}
              for tag, r in dist_kinds.items()}
              | {"moe_sharded_calls":
                 dist_kinds["moe"]["sharded"]["moe_sharded_calls"]}),
          flush=True)

    laps("15")
    # -- 16. sharded serving of packed weights on one NCCL rank, unfused
    # and fused ------------------------------------------------------------
    checked = {(r["M"], r["K"], r["N"]) for r in
               mm + mm_rows + cal_summary["layer0_mixed_matmul"] + moe_mm
               + moe_cal["layer0_mixed_matmul"] + rg_mm
               + rg_cal["layer0_mixed_matmul"] + xl_mm
               + xl_cal["layer0_mixed_matmul"] + s2t_mm + vlm_mm + q3_mm}
    dist_serve = run_dist_serve(torch, kernels, smi, peaks, checked)

    laps("16")
    checked |= {(m, k, n) for r in dist_serve["split"]
                + dist_serve["fused"]["split"]
                for (m, k, n) in r["shapes"] + [(r["M"], r["K"], r["N"])]}
    checked |= {(r["M"], r["K"], r["N"]) for r in dist_serve["fused"]["held"]}
    # -- 17. sharded serving of the other kinds on one NCCL rank ----------
    serve_kinds = run_dist_serve_kinds(torch, kernels, smi, peaks, checked)
    checked |= {(r["M"], r["K"], r["N"]) for r in serve_kinds["held"]}

    laps("17")
    # -- 18. uneven head splits: phi4-mini served and trained as one NCCL
    # rank, and the tp-16 split arithmetic rank after rank ---------------
    uneven = run_dist_uneven(torch, kernels, smi, peaks, checked)
    checked = set(uneven["checked"]) | {(r["M"], r["K"], r["N"])
                                        for r in uneven["held"]}

    laps("18")
    # -- 19. the sequence-parallel stream: qwen2.5-3b trained and served as
    # one NCCL rank with sp on and off, the tp 4 / 16 split arithmetic ----
    sp_run = run_dist_sp(torch, kernels, smi, peaks, checked)
    checked = set(sp_run["checked"])

    laps("19")
    # -- 20. the dry-run: rank 0 of the pod on fake tensors, and its
    # prediction of three steps run here as one NCCL rank ----------------
    dryrun = run_dryrun(torch, kernels, smi)

    laps("20")
    # -- 21. every packed-matmul shape of the paths was checked; the kernels
    # line and the result ---------------------------------------------------
    launched = dict(mixed_matmul.KERNEL.shapes)
    unchecked = sorted(set(launched) - checked)
    if unchecked:
        _fail("mixed_matmul launched on the paths at (M, K, N) never held "
              f"against its plain version: {unchecked}")
    by_shape = {f"{m}x{k}x{n}": c for (m, k, n), c in sorted(
        launched.items())}
    print("[mixed_matmul shapes] every (M, K, N) the packed matmul launched "
          "at in phases 5-20 was held against its plain version in phase 3, "
          "6, 8, 9, 10, 16, 17, 18 or 19; launches by shape: "
          + json.dumps(by_shape), flush=True)
    launches = {"datafree": summary["launches"],
                "calibrated": cal_summary["launches"],
                "whole": whole["whole"]["launches"],
                "whole-paged": whole["whole-paged"]["launches"],
                "serve-default": serve_default["launches"],
                "shared-prefix": shared["shared-prefix"]["launches"],
                "shared-prefix retain":
                    shared["shared-prefix retain"]["launches"],
                "shared-prefix whole-paged":
                    shared["shared-prefix whole-paged"]["launches"],
                "serve-share-prefix": serve_share["launches"],
                "preprocess": preprocess["launches"],
                "baselines": baselines["launches"],
                "moe": moe["moe"]["launches"],
                "moe whole": moe["moe whole"]["launches"],
                "moe loss": moe["moe loss"]["launches"],
                "moe calibrated": moe_cal["launches"],
                "moe baselines": moe_base["launches"],
                "rg": rg["rg"]["launches"],
                "rg contiguous": rg["rg contiguous"]["launches"],
                "rg long": rg["rg long"]["launches"],
                "rg long contiguous": rg["rg long contiguous"]["launches"],
                "rg loss": rg["rg loss"]["launches"],
                "rg serve": rg["rg serve"]["launches"],
                "rg calibrated": rg_cal["launches"],
                "xl": xl["xl"]["launches"],
                "xl contiguous": xl["xl contiguous"]["launches"],
                "xl long": xl["xl long"]["launches"],
                "xl loss": xl["xl loss"]["launches"],
                "xl serve": xl["xl serve"]["launches"],
                "xl calibrated": xl_cal["launches"],
                "xl baselines": xl_base["launches"],
                "vlm serve": vlm_serve["launches"],
                "s2t": s2t["s2t"]["launches"],
                "s2t loss": s2t["s2t loss"]["launches"],
                "vlm model": vlm["vlm model"]["launches"],
                "vlm": vlm["vlm"]["launches"],
                "dist train": dist_train["sharded"]["launches"],
                "dist pipeline": dist_pipe["launches"],
                "dist serve one device":
                    dist_serve["one_device"]["launches"],
                "dist serve": dist_serve["sharded"]["launches"],
                "dist serve fused one device":
                    dist_serve["fused"]["one_device"]["launches"],
                "dist serve fused": dist_serve["fused"]["sharded"]["launches"],
                **{f"dist serve kinds {tag} one device":
                   serve_kinds[tag]["one_device"]["launches"]
                   for tag in ("moe", "rg", "xl", "s2t")},
                **{f"dist serve kinds {tag}":
                   serve_kinds[tag]["sharded"]["launches"]
                   for tag in ("moe", "rg", "xl", "s2t")},
                "dist uneven phi4 one device":
                    uneven["phi4 serve"]["one_device"]["launches"],
                "dist uneven phi4": uneven["phi4 serve"]["sharded"]["launches"],
                "dist uneven phi4 train":
                    uneven["phi4 train"]["sharded"]["launches"],
                "dist sp train": sp_run["train"]["sp"]["launches"],
                "dist sp serve": sp_run["serve"]["sp"]["launches"],
                "dist sp serve replicated":
                    sp_run["serve"]["replicated"]["launches"],
                "dryrun prefill": dryrun["prefill"]["launches"],
                "dryrun decode": dryrun["decode"]["launches"],
                "dryrun train": dryrun["train"]["launches"]}
    decode_mm = [r for r in mm if r["M"] == 8]
    bm = spans["binary_matmul"]
    im = spans["int4_matmul"]
    entries = [
        _entry("mixed_matmul", "src/repro/kernels/mixed_matmul.py:158",
               mm + mm_rows + cal_summary["layer0_mixed_matmul"] + moe_mm
               + moe_cal["layer0_mixed_matmul"] + rg_mm
               + rg_cal["layer0_mixed_matmul"] + xl_mm
               + xl_cal["layer0_mixed_matmul"] + s2t_mm + vlm_mm + q3_mm
               + [{"max_abs_err": ragged["max_abs_err"]}], decode_mm,
               launches, "one decode layer at M=8: wqkv+wgu+wo+wd"),
        dict(_entry("mixed_matmul", "src/repro/kernels/mixed_matmul.py:166",
                    mm + mm_rows + moe_mm + rg_mm + xl_mm + s2t_mm + vlm_mm
                    + q3_mm, gather, launches,
                    "the perm gather (gather_kernel) of a decode call at "
                    "M=8, wqkv+wgu+wo+wd; one per mixed_matmul launch, "
                    "held through the product"),
             name="mixed_matmul(perm)"),
        _entry("paged_attention", "src/repro/kernels/paged_attention.py:245",
               [pa, moe_pa, rg_pa, vlm_pa], [pa], launches,
               "B=8 hkv=32 dh=128 ps=16, lens up to 1000"),
        _entry("paged_prefill", "src/repro/kernels/paged_prefill.py:258",
               pf + moe_pf + vlm_pf, pf[:1], launches,
               "C=64 over 192 context tokens, hkv=32 dh=128"),
        _entry("binary_matmul", "src/repro/kernels/binary_matmul.py:75",
               bm, [r for r in bm if r["M"] == 8], launches,
               "M=8: binary spans of wqkv (K=3280, N=12288) + wd "
               "(K=8800, N=4096); off the serving path; the packed-matmul "
               "body with the int4 span empty", source="mixed_matmul"),
        _entry("int4_matmul", "src/repro/kernels/int4_matmul.py:61",
               im, [r for r in im if r["M"] == 8], launches,
               "M=8: int4 spans of wqkv (K=816, N=12288) + wd "
               "(K=2208, N=4096); off the serving path; the packed-matmul "
               "body with the binary span empty", source="mixed_matmul"),
    ]
    laps("21")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
