"""The port's CUDA kernels against their plain PyTorch versions.

Needs a CUDA device (the kernels have no CPU mode): every test skips
without one.  This file imports no JAX, so it runs on a GPU machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: mixed_matmul, binary_matmul and int4_matmul rtol 2^-7,
atol 1e-3 (both sides round the operands alike and accumulate in f32;
the kernel rounds its output once to bf16).  Attention in f32 pools: 1e-4 (online softmax over key tiles
against the dense softmax); pool bytes exact except the dump page.
Attention in bf16: rtol = atol = 1e-2, chip_smoke's ATT_RTOL/ATT_ATOL
(the kernels round probabilities to bf16 per key tile and split,
relative to the split's running max; the plain version per page tile or
once); two calls on the same inputs give the same bits.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.qlinear import QuantConfig, quantize_linear  # noqa: E402
from repro_torch.kernels import binary_matmul as tbm  # noqa: E402
from repro_torch.kernels import int4_matmul as tim  # noqa: E402
from repro_torch.kernels import mixed_matmul as tmm  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import paged_prefill as tpf  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _qlinear(k, n, ratio, seed, device, multiple=16):
    g = torch.Generator().manual_seed(seed)
    w = (torch.randn(k, n, generator=g) / k ** 0.5).to(torch.bfloat16)
    q = quantize_linear(w, None, QuantConfig(ratio=ratio, multiple=multiple))
    return q.map(lambda t: t.to(device))


@pytest.mark.parametrize("k,n,ratio,multiple", [
    (256, 96, 0.1875, 16), (4096, 200, 0.2, 16), (11008, 64, 0.2, 16),
    (1032, 130, 0.2, 8),           # k_s = 208, k_b = 824: a ragged k-step
    (128, 40, 0.1875, 8),          # k_s = 24: int4 span not 16-aligned
    (4096, 4096, 0.2, 16)])        # wo's shape: split K across blocks
def test_mixed_matmul_matches_plain(cuda, k, n, ratio, multiple):
    q = _qlinear(k, n, ratio, seed=k, device=cuda, multiple=multiple)
    for m in (1, 3, 8, 17, 20, 64, 100):
        x = torch.randn(m, k, device=cuda).to(torch.bfloat16)
        args = (x, q.w4, q.s4, q.z4, q.bits, q.alpha_s, q.alpha_r1,
                q.alpha_r2)
        before = tmm.KERNEL.launches
        y = tmm.mixed_matmul(*args, perm=q.perm)
        assert tmm.KERNEL.launches == before + 1
        torch.testing.assert_close(
            y.float(), ref.mixed_matmul_ref(*args, perm=q.perm),
            rtol=2 ** -7, atol=1e-3)
        # pre-permuted activations, no perm
        xp = x[:, q.perm.long()].contiguous()
        torch.testing.assert_close(
            tmm.mixed_matmul(xp, *args[1:]).float(),
            ref.mixed_matmul_ref(xp, *args[1:]), rtol=2 ** -7, atol=1e-3)


@pytest.mark.parametrize("k,n", [(64, 32), (3280, 200), (8800, 64),
                                 (1000, 130), (8, 16)])
def test_binary_matmul_matches_plain(cuda, k, n):
    g = torch.Generator().manual_seed(k + n)
    bits = torch.randint(0, 256, (k // 8, n), generator=g,
                         dtype=torch.uint8).to(cuda)
    a_out = (0.01 + torch.rand(n, generator=g)).to(cuda)
    a_in = (0.5 + torch.rand(k, generator=g)).to(cuda)
    for m in (1, 3, 8, 20, 64):
        x = torch.randn(m, k, generator=g).to(torch.bfloat16).to(cuda)
        before = tbm.KERNEL.launches
        y = tbm.binary_matmul(x, bits, a_out, a_in)
        assert tbm.KERNEL.launches == before + 1
        assert y.dtype == torch.bfloat16 and y.shape == (m, n)
        torch.testing.assert_close(
            y.float(), ref.binary_matmul_ref(x.float(), bits, a_out, a_in),
            rtol=2 ** -7, atol=1e-3)


@pytest.mark.parametrize("k,n", [(64, 32), (816, 200), (2208, 64),
                                 (1002, 130), (2, 16)])
def test_int4_matmul_matches_plain(cuda, k, n):
    g = torch.Generator().manual_seed(k + n)
    w4 = torch.randint(0, 256, (k // 2, n), generator=g,
                       dtype=torch.uint8).to(cuda)
    s4 = (0.001 + 0.01 * torch.rand(k, generator=g)).to(cuda)
    z4 = torch.randint(0, 16, (k,), generator=g).float().to(cuda)
    for m in (1, 3, 8, 20, 64):
        x = torch.randn(m, k, generator=g).to(torch.bfloat16).to(cuda)
        before = tim.KERNEL.launches
        y = tim.int4_matmul(x, w4, s4, z4)
        assert tim.KERNEL.launches == before + 1
        assert y.dtype == torch.bfloat16 and y.shape == (m, n)
        torch.testing.assert_close(
            y.float(), ref.int4_matmul_ref(x.float(), w4, s4, z4),
            rtol=2 ** -7, atol=1e-3)


def _random_packed(g, k_s, k_b, n, device):
    """Random operands of the packed matmul with the given spans (either
    may be empty)."""
    return dict(
        w4=torch.randint(0, 256, (k_s // 2, n), generator=g,
                         dtype=torch.uint8).to(device),
        s4=(0.001 + 0.01 * torch.rand(k_s, generator=g)).to(device),
        z4=torch.randint(0, 16, (k_s,), generator=g).float().to(device),
        bits=torch.randint(0, 256, (k_b // 8, n), generator=g,
                           dtype=torch.uint8).to(device),
        alpha_s=(0.01 + torch.rand(n, generator=g)).to(device),
        alpha_r1=(0.5 + torch.rand(n, generator=g)).to(device),
        alpha_r2=(0.5 + torch.rand(k_b, generator=g)).to(device))


@pytest.mark.parametrize("k_s,k_b,n", [
    (0, 64, 32), (64, 0, 32), (0, 8, 16), (2, 0, 16), (2, 8, 16),
    (0, 4096, 4096), (4096, 0, 4096), (6, 3280, 130)])
def test_mixed_matmul_one_sided_and_tiny_spans(cuda, k_s, k_b, n):
    g = torch.Generator().manual_seed(k_s + 7 * k_b + n)
    ops_ = _random_packed(g, k_s, k_b, n, cuda)
    perm = torch.randperm(k_s + k_b, generator=g).to(torch.int32).to(cuda)
    for m in (1, 8, 64):
        x = torch.randn(m, k_s + k_b, generator=g).to(torch.bfloat16).to(cuda)
        y = tmm.mixed_matmul(x, **ops_, perm=perm)
        torch.testing.assert_close(
            y.float(), ref.mixed_matmul_ref(x, **ops_, perm=perm),
            rtol=2 ** -7, atol=1e-3)


@pytest.mark.parametrize("m", [1, 8, 64])
def test_packed_matmuls_give_the_same_bits_twice(cuda, m):
    """The split-K reduction sums the partials in split order: two calls
    on the same inputs give identical bits."""
    q = _qlinear(4096, 4096, 0.2, seed=5, device=cuda)
    x = torch.randn(m, 4096, device=cuda).to(torch.bfloat16)
    args = (x, q.w4, q.s4, q.z4, q.bits, q.alpha_s, q.alpha_r1, q.alpha_r2)
    y1 = tmm.mixed_matmul(*args, perm=q.perm)
    y2 = tmm.mixed_matmul(*args, perm=q.perm)
    assert torch.equal(y1, y2)
    xb = x[:, :q.k_b].contiguous()
    a_out = (q.alpha_s * q.alpha_r1).contiguous()
    assert torch.equal(tbm.binary_matmul(xb, q.bits, a_out, q.alpha_r2),
                       tbm.binary_matmul(xb, q.bits, a_out, q.alpha_r2))


def test_span_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    bits = torch.zeros(8, 16, dtype=torch.uint8, device=cuda)
    vec = torch.ones(64, device=cuda)
    with pytest.raises(ValueError):        # f32 x: the kernel takes bf16
        tbm.binary_matmul(torch.randn(2, 64, device=cuda), bits,
                          torch.ones(16, device=cuda), vec)
    with pytest.raises(ValueError):        # K of x does not match bits
        tbm.binary_matmul(torch.randn(2, 72, device=cuda).to(torch.bfloat16),
                          bits, torch.ones(16, device=cuda),
                          torch.ones(72, device=cuda))
    w4 = torch.zeros(32, 16, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):        # f64 scales
        tim.int4_matmul(torch.randn(2, 64, device=cuda).to(torch.bfloat16),
                        w4, vec.double(), vec)


def test_quantization_bytes_on_the_card_match_the_cpu(cuda):
    """The int4 codes and scales come out of the same f32 arithmetic on
    the card as on the CPU (true divisions, no reciprocal)."""
    g = torch.Generator().manual_seed(11)
    w = (torch.randn(2048, 384, generator=g) / 45).to(torch.bfloat16)
    stat = torch.rand(2048, generator=g)
    qcfg = QuantConfig(ratio=0.2, multiple=16)
    a = quantize_linear(w, stat, qcfg)
    b = quantize_linear(w.to(cuda), stat.to(cuda), qcfg)
    for f in ("perm", "w4", "bits", "s4", "z4"):
        assert torch.equal(getattr(a, f), getattr(b, f).cpu()), f


def _attention_case(rng, *, b, hkv, rep, dh, ps, lens, freed=()):
    nblk = max(-(-n // ps) for n in lens) + 2
    need = sum(-(-n // ps) for n in lens)
    pages = rng.permutation(need + 3)
    bt = np.full((b, nblk), -1, np.int32)
    used = 0
    for i, n in enumerate(lens):
        k = -(-n // ps)
        bt[i, :k] = pages[used:used + k]
        used += k
    for (i, j) in freed:
        bt[i, j] = -1
    shape = (need + 3, ps, hkv, dh)
    return (2 * rng.normal(size=(b, hkv * rep, dh)).astype(np.float32),
            rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32), bt,
            np.asarray(lens, np.int32))


@pytest.mark.parametrize("rep,window,softcap,dh", [
    (1, None, None, 128), (2, None, None, 16), (2, 9, 30.0, 16),
    (4, None, None, 64),
    (2, None, None, 40),           # dh not a multiple of 16: 16-byte rows
    (1, 9, None, 20),              # nor of 8: element loads, padded rows
    (8, None, None, 64),           # two passes of 4 GQA rows
    (1, None, None, 320)])         # 2 (bf16) / 3 (f32) chunks a lane
def test_paged_attention_matches_plain(cuda, rep, window, softcap, dh):
    rng = np.random.default_rng(rep * 7 + dh)
    arrs = _attention_case(rng, b=5, hkv=2, rep=rep, dh=dh, ps=4,
                           lens=[37, 5, 16, 0, 23], freed=((0, 2),))
    args = [torch.from_numpy(a).to(cuda) for a in arrs]
    o = tpa.paged_attention(*args, window=window, softcap=softcap)
    o_ref = ref.paged_attention_ref(*args, window=window, softcap=softcap)
    torch.testing.assert_close(o, o_ref, rtol=1e-4, atol=1e-4)
    assert torch.all(o[3] == 0)
    # bf16 pools: probabilities rounded per key tile vs once
    b16 = [a.to(torch.bfloat16) if a.is_floating_point() else a
           for a in args]
    torch.testing.assert_close(
        tpa.paged_attention(*b16, window=window, softcap=softcap),
        ref.paged_attention_ref(*b16, window=window, softcap=softcap),
        rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("start,length,masked,rep,window", [
    (16, 7, True, 2, None), (0, 8, False, 2, None), (8, 8, False, 1, None),
    (16, 7, False, 2, 6), (32, 3, False, 4, None)])
def test_paged_prefill_matches_plain(cuda, start, length, masked, rep,
                                     window):
    rng = np.random.default_rng(start + length + rep)
    hkv, dh, ps, c, nblk, pool_pages = 2, 16, 4, 8, 12, 16
    hq = hkv * rep
    kp = rng.normal(size=(2, pool_pages + 1, ps, hkv, dh)).astype(np.float32)
    vp = rng.normal(size=kp.shape).astype(np.float32)
    n_pages = -(-(start + length) // ps)
    bt = np.full((nblk,), -1, np.int32)
    bt[:n_pages] = rng.permutation(pool_pages)[:n_pages]
    btw = bt.copy()
    if masked:
        btw[start // ps] = -1
    q = rng.normal(size=(c, hq, dh)).astype(np.float32)
    kn = rng.normal(size=(c, hkv, dh)).astype(np.float32)
    vn = rng.normal(size=(c, hkv, dh)).astype(np.float32)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in dict(
        q=q, kn=kn, vn=vn, bt=bt, btw=btw).items()}
    kk, vk = torch.from_numpy(kp).to(cuda), torch.from_numpy(vp).to(cuda)
    kr, vr = kk.clone(), vk.clone()
    before = tpf.KERNEL.launches
    o = tpf.paged_prefill(t["q"], t["kn"], t["vn"], kk, vk, t["bt"],
                          t["btw"], start, length, layer=1, window=window)
    assert tpf.KERNEL.launches == before + 1
    o_ref = ref.paged_prefill_ref(t["q"], t["kn"], t["vn"], kr, vr, t["bt"],
                                  t["btw"], start, length, layer=1,
                                  window=window)
    torch.testing.assert_close(o[:length], o_ref[:length], rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(kk[:, :-1], kr[:, :-1])
    assert torch.equal(vk[:, :-1], vr[:, :-1])
    # start / length as device scalars: the same result, no host sync
    kk2, vk2 = torch.from_numpy(kp).to(cuda), torch.from_numpy(vp).to(cuda)
    o2 = tpf.paged_prefill(
        t["q"], t["kn"], t["vn"], kk2, vk2, t["bt"], t["btw"],
        torch.tensor(start, dtype=torch.int32, device=cuda),
        torch.tensor(length, dtype=torch.int32, device=cuda), layer=1,
        window=window)
    assert torch.equal(o2[:length], o[:length])
    assert torch.equal(kk2[:, :-1], kk[:, :-1])


@pytest.mark.parametrize("lens,freed,window", [
    ([1000, 300, 0, 77], ((0, 20),), None),     # LLaMA-shaped, many splits
    ([1000, 300, 0, 77], (), 200),              # a window over many splits
    ([0, 0, 0, 640], (), None)])                # rows whose splits are empty
def test_paged_attention_llama_shape_over_splits(cuda, lens, freed, window):
    """rep 1, dh 128, ps 16 as LLaMA-7B decodes, with contexts over many
    of the plan's splits: f32 to 1e-4, bf16 to 1e-2 with the same bits
    on a second call, zeros (no NaN) for rows of length 0."""
    from repro_torch.kernels import paged_attention as mod
    rng = np.random.default_rng(len(freed) + (window or 0))
    arrs = _attention_case(rng, b=4, hkv=4, rep=1, dh=128, ps=16, lens=lens,
                           freed=freed)
    args = [torch.from_numpy(a).to(cuda) for a in arrs]
    plan = mod.launch_plan(4, 4, 1, 128, args[3].shape[1], 16, False, 0)
    assert plan.splits > 1 and plan.span < max(lens)
    o = tpa.paged_attention(*args, window=window)
    torch.testing.assert_close(
        o, ref.paged_attention_ref(*args, window=window), rtol=1e-4,
        atol=1e-4)
    b16 = [a.to(torch.bfloat16) if a.is_floating_point() else a
           for a in args]
    o16 = tpa.paged_attention(*b16, window=window)
    torch.testing.assert_close(
        o16, ref.paged_attention_ref(*b16, window=window), rtol=1e-2,
        atol=1e-2)
    assert torch.equal(o16, tpa.paged_attention(*b16, window=window))
    for i, n in enumerate(lens):
        if n == 0:
            assert torch.all(o[i] == 0) and torch.all(o16[i] == 0)
    assert not torch.isnan(o16).any()


def _prefill_arrays(rng, *, c, hkv, rep, dh, ps, nblk, pool_pages, start,
                    length, masked):
    """numpy operands of one prefill chunk; chunk page ``masked`` (or
    None) is a shared block (writable row -1)."""
    kp = rng.normal(size=(2, pool_pages + 1, ps, hkv, dh)).astype(np.float32)
    vp = rng.normal(size=kp.shape).astype(np.float32)
    n_pages = -(-(start + length) // ps)
    bt = np.full((nblk,), -1, np.int32)
    bt[:n_pages] = rng.permutation(pool_pages)[:n_pages]
    btw = bt.copy()
    if masked is not None:
        btw[start // ps + masked] = -1
    return dict(q=3 * rng.normal(size=(c, hkv * rep, dh)).astype(np.float32),
                kn=rng.normal(size=(c, hkv, dh)).astype(np.float32),
                vn=rng.normal(size=(c, hkv, dh)).astype(np.float32),
                kp=kp, vp=vp, bt=bt, btw=btw)


@pytest.mark.parametrize("c,hkv,rep,dh,ps,start,length,masked,window", [
    (64, 4, 1, 128, 16, 192, 64, 1, None),   # LLaMA-shaped, keys over splits
    (64, 4, 1, 128, 16, 208, 37, None, None),  # a key tile straddles start
    (64, 4, 1, 128, 16, 0, 64, None, 48),    # first chunk, window
    (32, 2, 4, 64, 8, 96, 25, 0, None),      # GQA: rows (token, head)
    (16, 2, 8, 64, 4, 40, 16, None, 30),     # rep 8, softcap below
    (32, 2, 2, 40, 8, 64, 32, None, None),   # dh 40: padded to 64
    (16, 2, 1, 20, 4, 12, 9, None, None),    # dh 20: element loads
    (32, 2, 2, 256, 8, 48, 30, None, None)]) # dh 256: 32-key tiles
def test_paged_prefill_bf16_tensor_core_tiles(cuda, c, hkv, rep, dh, ps,
                                              start, length, masked, window):
    """The bf16 kernel (tensor-core tiles, keys split across blocks)
    against the plain version: outputs to 1e-2, pool bytes exact, the
    shared page untouched; the same bits on a second call and with
    start / length as device scalars."""
    from repro_torch.kernels import paged_prefill as mod
    rng = np.random.default_rng(c + dh + start)
    nblk, pool_pages = (start + c) // ps + 4, (start + c) // ps + 6
    a = _prefill_arrays(rng, c=c, hkv=hkv, rep=rep, dh=dh, ps=ps, nblk=nblk,
                        pool_pages=pool_pages, start=start, length=length,
                        masked=masked)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in a.items()}
    for k in ("q", "kn", "vn", "kp", "vp"):
        t[k] = t[k].to(torch.bfloat16)
    softcap = 20.0 if rep == 8 else None
    kw = dict(layer=1, window=window, softcap=softcap)
    plan = mod.launch_plan(c, hkv * rep, hkv, dh, nblk, ps, 0)
    kk, vk = t["kp"].clone(), t["vp"].clone()
    kr, vr = t["kp"].clone(), t["vp"].clone()
    o = tpf.paged_prefill(t["q"], t["kn"], t["vn"], kk, vk, t["bt"],
                          t["btw"], start, length, **kw)
    o_ref = ref.paged_prefill_ref(t["q"], t["kn"], t["vn"], kr, vr, t["bt"],
                                  t["btw"], start, length, **kw)
    torch.testing.assert_close(o[:length], o_ref[:length], rtol=1e-2,
                               atol=1e-2)
    assert not torch.isnan(o).any()
    assert torch.equal(kk[:, :-1], kr[:, :-1])
    assert torch.equal(vk[:, :-1], vr[:, :-1])
    if masked is not None:
        page = int(a["bt"][start // ps + masked])
        assert torch.equal(kk[:, page], t["kp"][:, page])
    o2 = tpf.paged_prefill(t["q"], t["kn"], t["vn"], kk, vk, t["bt"],
                           t["btw"], start, length, **kw)
    assert torch.equal(o2, o)
    o3 = tpf.paged_prefill(
        t["q"], t["kn"], t["vn"], kk, vk, t["bt"], t["btw"],
        torch.tensor(start, dtype=torch.int32, device=cuda),
        torch.tensor(length, dtype=torch.int32, device=cuda), **kw)
    assert torch.equal(o3[:length], o[:length])
    if c == 64 and dh == 128:
        assert plan.splits > 1


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = _qlinear(64, 32, 0.25, seed=3, device=cuda)
    args = (q.w4, q.s4, q.z4, q.bits, q.alpha_s, q.alpha_r1, q.alpha_r2)
    with pytest.raises(ValueError):        # f32 x: the kernel takes bf16
        tmm.mixed_matmul(torch.randn(2, 64, device=cuda), *args, perm=q.perm)
    with pytest.raises(ValueError):        # K of x does not match
        tmm.mixed_matmul(torch.randn(2, 48, device=cuda).to(torch.bfloat16),
                         *args)
    pool = torch.zeros(4, 4, 2, 16, device=cuda)
    with pytest.raises(ValueError):        # int64 block tables
        tpa.paged_attention(torch.zeros(1, 2, 16, device=cuda), pool, pool,
                            torch.zeros(1, 2, dtype=torch.int64, device=cuda),
                            torch.ones(1, dtype=torch.int32, device=cuda))


def test_contiguous_whole_prompt_engine_tokens_match_the_cpu(cuda):
    """The reduced LLaMA config in f32, data-free quantized with fused
    projections, served by the contiguous engine with whole-prompt
    prefill on the card (kernels) and on the CPU (plain versions): the
    same greedy tokens.  The runs are chip_smoke's
    (``chip_smoke.small_engine_tokens``)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    toks = chip_smoke.small_engine_tokens(
        torch, ("contiguous/cpu", "contiguous/cuda"))
    assert toks["contiguous/cuda"] == toks["contiguous/cpu"]


@pytest.mark.parametrize("mode", ["shared-whole", "shared-chunked"])
def test_shared_prefix_engine_tokens_match_the_cpu(cuda, mode):
    """The paged engine with prefix sharing, whole-prompt or chunked
    prefill, on the card and on the CPU (the reduced LLaMA config in
    f32, prompts after a common 32-token prefix): the same greedy
    tokens (``chip_smoke.small_engine_tokens``)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    toks = chip_smoke.small_engine_tokens(torch, (f"{mode}/cpu",
                                                  f"{mode}/cuda"))
    assert toks[f"{mode}/cuda"] == toks[f"{mode}/cpu"]


def test_restorative_lora_runs_on_the_card(cuda):
    """Two steps of restorative-LoRA preprocessing of the reduced LLaMA
    config on the card: finite losses, and W' finite, on the card, in
    the weights' dtype."""
    from repro_torch.configs import registry
    from repro_torch.core.preprocess import (PreprocessConfig,
                                             restorative_lora)
    from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
    from repro_torch.models import model as M
    cfg = registry.get("llama-7b").reduced()
    params = M.init_params(cfg, 0, cuda)
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=0))
    batches = [{"tokens": torch.from_numpy(t).to(cuda),
                "targets": torch.from_numpy(g).to(cuda)}
               for t, g in corpus.batches(2, 64, 2, split="calib")]
    losses = []
    out = restorative_lora(cfg, params, batches,
                           QuantConfig(ratio=0.2, multiple=16),
                           PreprocessConfig(rank=8, steps=2, lr=3e-4),
                           min_dim=32, losses=losses)
    assert len(losses) == 2 and all(np.isfinite(losses))
    w = out["stages"][0][0][0]["attn"]["wq"]
    assert w.device.type == "cuda" and w.dtype == torch.bfloat16
    assert torch.isfinite(w.float()).all()
    assert not torch.equal(w, params["stages"][0][0][0]["attn"]["wq"])


def test_moe_dispatch_and_combine_on_the_card_match_the_cpu(cuda):
    """The MoE dispatch (stable sort for top-k, cumsum, index_put) on
    the card: on router logits that are exact in f32 (small integers,
    ties included) the routes are identical to the CPU's, and
    ``apply_moe`` in bf16 gives the same bits on two calls (the combine
    is a fixed-order sum, no atomics) and agrees with the CPU within
    bf16 rounding (rtol = atol = 2^-6: a few roundings of values of
    order 1)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models.param import tree_to
    cfg = registry.get("granite-moe-1b-a400m").reduced()
    g = torch.Generator().manual_seed(0)
    xt = torch.randint(-2, 3, (96, cfg.d_model), generator=g).float()
    router = torch.randint(-1, 2, (cfg.d_model, cfg.moe.n_experts),
                           generator=g).float()
    for cf in (1.25, 0.25):
        c = dataclasses.replace(cfg, moe=MoEConfig(
            cfg.moe.n_experts, cfg.moe.top_k, cf))
        a = L.moe_dispatch(c, router, xt)
        b = L.moe_dispatch(c, router.to(cuda), xt.to(cuda))
        for k in ("gate_e", "dest_e", "dest_c", "keep"):
            assert torch.equal(a[k], b[k].cpu()), (cf, k)
    mlp = M.init_params(cfg, 0, "cpu")["stages"][0][0][0]["mlp"]
    x = torch.randn(2, 40, cfg.d_model, generator=g).to(torch.bfloat16)
    y_cpu = L.apply_moe(cfg, mlp, x)
    mlp_c = tree_to(mlp, cuda)
    y1 = L.apply_moe(cfg, mlp_c, x.to(cuda))
    y2 = L.apply_moe(cfg, mlp_c, x.to(cuda))
    assert torch.equal(y1, y2)
    torch.testing.assert_close(y1.cpu().float(), y_cpu.float(),
                               rtol=2 ** -6, atol=2 ** -6)


@pytest.mark.parametrize("mode", ["contiguous", "paged-whole",
                                  "paged-chunked"])
def test_moe_engine_tokens_match_the_cpu(cuda, mode):
    """Reduced granite-moe-1b-a400m in f32, data-free with fused QKV and
    expert gate+up, served on the card (kernels) and on the CPU (plain
    versions): the same greedy tokens in each engine mode
    (``chip_smoke.small_engine_tokens``)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    toks = chip_smoke.small_engine_tokens(
        torch, (f"{mode}/cpu", f"{mode}/cuda"), arch=chip_smoke.MOE_ARCH)
    assert toks[f"{mode}/cuda"] == toks[f"{mode}/cpu"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_at_the_hybrid_shape(cuda, dtype):
    """recurrentgemma-2b's decode attention: B 8, hq 10 on one KV head
    (rep 10: three passes of 4 rows, the last with two), dh 256, pages
    of 16, a 2048-key window, contexts 0-3000 (some past the window) and
    a freed page inside slot 0's window; f32 to 1e-4, bf16 to 1e-2 with
    the same bits on a second call."""
    from repro_torch.kernels import paged_attention as mod
    lens = [3000, 2600, 2049, 2048, 1500, 700, 64, 0]
    rng = np.random.default_rng(15)
    arrs = _attention_case(rng, b=8, hkv=1, rep=10, dh=256, ps=16,
                           lens=lens, freed=((0, 150),))
    args = [torch.from_numpy(a).to(cuda) for a in arrs]
    if dtype == "bfloat16":
        args = [a.to(torch.bfloat16) if a.is_floating_point() else a
                for a in args]
    tol = 1e-4 if dtype == "float32" else 1e-2
    plan = mod.launch_plan(8, 1, 10, 256, args[3].shape[1], 16,
                           dtype == "bfloat16", 0)
    assert plan.splits > 1
    o = tpa.paged_attention(*args, window=2048)
    torch.testing.assert_close(
        o, ref.paged_attention_ref(*args, window=2048), rtol=tol, atol=tol)
    assert torch.equal(o, tpa.paged_attention(*args, window=2048))
    assert torch.all(o[7] == 0) and not torch.isnan(o).any()


@pytest.mark.parametrize("mode", ["contiguous", "paged-whole",
                                  "shared-whole"])
def test_hybrid_engine_tokens_match_the_cpu(cuda, mode):
    """Reduced recurrentgemma-2b (rglru and windowed local blocks) in
    f32, data-free with fused QKV and gate+up, served on the card
    (kernels) and on the CPU (plain versions): the same greedy tokens in
    each whole-prompt engine mode (``chip_smoke.small_engine_tokens``)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    toks = chip_smoke.small_engine_tokens(
        torch, (f"{mode}/cpu", f"{mode}/cuda"), arch=chip_smoke.RG_ARCH)
    assert toks[f"{mode}/cuda"] == toks[f"{mode}/cpu"]


@pytest.mark.parametrize("mode", ["contiguous", "paged-whole",
                                  "shared-whole"])
def test_xlstm_engine_tokens_match_the_cpu(cuda, mode):
    """Reduced xlstm-1.3b (mlstm and slstm blocks) in f32, data-free
    quantized, served on the card (kernels) and on the CPU (plain
    versions): the same greedy tokens in each whole-prompt engine mode
    (``chip_smoke.small_engine_tokens``)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    toks = chip_smoke.small_engine_tokens(
        torch, (f"{mode}/cpu", f"{mode}/cuda"), arch=chip_smoke.XL_ARCH)
    assert toks[f"{mode}/cuda"] == toks[f"{mode}/cpu"]


@pytest.mark.parametrize("k,n", [(5504, 2048), (2048, 5504)])
def test_mixed_matmul_at_a_span_of_43_tiles(cuda, k, n):
    """xlstm-1.3b's sLSTM FFN: K or N of 5504 = 43 x 128 (at K 5504 and
    ratio 0.2, k_s 1104 and k_b 4400), at the row counts its paths give
    the kernel."""
    q = _qlinear(k, n, 0.2, seed=k + 1, device=cuda)
    assert q.k_s == {5504: 1104, 2048: 416}[k]
    for m in (1, 4, 8, 64, 512):
        x = torch.randn(m, k, device=cuda).to(torch.bfloat16)
        args = (x, q.w4, q.s4, q.z4, q.bits, q.alpha_s, q.alpha_r1,
                q.alpha_r2)
        torch.testing.assert_close(
            tmm.mixed_matmul(*args, perm=q.perm).float(),
            ref.mixed_matmul_ref(*args, perm=q.perm), rtol=2 ** -7,
            atol=1e-3)


def test_train_steps_on_the_card_match_the_cpu(cuda):
    """Three train steps of reduced tiny-lm with a 3-layer stage in f32
    (int8 compression with 2 microbatches, top-k with one; remat) on the
    card and on the CPU from the same state, within chip_smoke's
    ``TRAIN_*`` bounds (``chip_smoke.check_train_reference``, which also
    holds each leaf's update)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    for kind, mb in chip_smoke.TRAIN_REF_CASES:
        out = chip_smoke.check_train_reference(torch, kind, mb)
        assert max(out["loss_gaps"]) <= chip_smoke.TRAIN_LOSS_ATOL
        assert out["code_flips"] <= (chip_smoke.TRAIN_FLIP_FRAC
                                     * out["elements"])
        assert out["max_gap_unflipped"] <= chip_smoke.TRAIN_P_ATOL
        assert (max(out["flip_gaps"], default=0)
                <= chip_smoke.TRAIN_FLIP_ATOL)
        assert out["max_update_ratio"] <= chip_smoke.TRAIN_DELTA_RTOL
        assert out["steps"] == 3


def test_checkpoint_roundtrip_of_card_tensors(cuda, tmp_path):
    """bf16 and f32 tensors on the card through the port's store: the
    same bits back, restored onto the card (the template's device)."""
    from repro_torch.checkpoint import store
    g = torch.Generator(device=cuda).manual_seed(0)
    tree = {"w": torch.randn(64, 48, generator=g, device=cuda)
            .to(torch.bfloat16),
            "stages": [(torch.randn(3, 5, generator=g, device=cuda),
                        torch.tensor(2.5, dtype=torch.bfloat16,
                                     device=cuda))],
            "step": torch.tensor(7, dtype=torch.int32, device=cuda)}
    store.save_checkpoint(str(tmp_path), 3, tree)
    back, step = store.restore_checkpoint(str(tmp_path), tree)
    assert step == 3
    for a, b in ((back["w"], tree["w"]),
                 (back["stages"][0][0], tree["stages"][0][0]),
                 (back["stages"][0][1], tree["stages"][0][1]),
                 (back["step"], tree["step"])):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert a.shape == b.shape
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b)


@pytest.mark.parametrize("k,n,ratio,multiple", [
    (4096, 4096, 0.2, 16),         # split K, both spans: the fold
    (1032, 130, 0.2, 8),           # ragged spans, N not a multiple of 4
    (64, 32, 0.25, 16)])           # one split of both spans: the epilogue
def test_mixed_matmul_f32_output_is_the_accumulator_rounded_once(
        cuda, k, n, ratio, multiple):
    """``out_dtype=torch.float32`` returns the f32 accumulator whose one
    rounding is the bf16 output, bit for bit, and that the plain
    version's f32 accumulator matches at 1e-5 of its largest value."""
    q = _qlinear(k, n, ratio, seed=k + 7, device=cuda, multiple=multiple)
    for m in (1, 8, 64, 256):
        x = torch.randn(m, k, device=cuda).to(torch.bfloat16)
        args = (x, q.w4, q.s4, q.z4, q.bits, q.alpha_s, q.alpha_r1,
                q.alpha_r2)
        y = tmm.mixed_matmul(*args, perm=q.perm)
        acc = tmm.mixed_matmul(*args, perm=q.perm, out_dtype=torch.float32)
        assert acc.dtype == torch.float32
        assert torch.equal(acc.to(torch.bfloat16).view(torch.int16),
                           y.view(torch.int16)), (k, n, m)
        want = ref.mixed_matmul_ref(*args, perm=q.perm)
        assert float((acc - want).abs().max()) <= \
            1e-5 * float(want.abs().max())


@pytest.mark.parametrize("tp", [3, 4, 16])
def test_mixed_matmul_row_views_gather_from_the_whole_input(cuda, tp):
    """Row-parallel views (``distributed.sharding.local_view``): a perm
    narrower than x gathers the view's channels from the whole x; the
    views' f32 partials, summed in rank order, are the whole leaf's
    accumulator within 1e-5 of its largest value, and each matches its
    plain version; a view that holds no byte row returns zeros."""
    from repro_torch.distributed.sharding import local_view
    q = _qlinear(4096, 256, 0.2, seed=5, device=cuda)
    for m in (1, 8, 256):
        x = torch.randn(m, q.k, device=cuda).to(torch.bfloat16)
        whole = tmm.mixed_matmul(x, q.w4, q.s4, q.z4, q.bits, q.alpha_s,
                                 q.alpha_r1, q.alpha_r2, perm=q.perm,
                                 out_dtype=torch.float32)
        total = torch.zeros_like(whole)
        for r in range(tp):
            v = local_view(q, "row", r, tp)
            args = (x, v.w4, v.s4, v.z4, v.bits, v.alpha_s, v.alpha_r1,
                    v.alpha_r2)
            part = tmm.mixed_matmul(*args, perm=v.perm,
                                    out_dtype=torch.float32)
            want = ref.mixed_matmul_ref(*args, perm=v.perm)
            assert float((part - want).abs().max()) <= \
                1e-5 * max(float(want.abs().max()), 1e-30)
            total += part
        assert float((total - whole).abs().max()) <= \
            1e-5 * float(whole.abs().max())
    empty = _no_rows(q)
    x = torch.randn(4, q.k, device=cuda).to(torch.bfloat16)
    y = tmm.mixed_matmul(x, empty.w4, empty.s4, empty.z4, empty.bits,
                         empty.alpha_s, empty.alpha_r1, empty.alpha_r2,
                         perm=empty.perm, out_dtype=torch.float32)
    assert y.shape == (4, q.n) and not bool(y.any())


def _no_rows(q):
    """A row view of ``q`` that holds no byte row (k = 0)."""
    import dataclasses
    return dataclasses.replace(
        q, perm=q.perm[:0].contiguous(), w4=q.w4[:0].contiguous(),
        s4=q.s4[:0].contiguous(), z4=q.z4[:0].contiguous(),
        bits=q.bits[:0].contiguous(), alpha_r2=q.alpha_r2[:0].contiguous(),
        k_s=0, k=0)


def test_head_views_launch_only_on_ranks_that_hold_heads(cuda):
    """Column views of whole heads (``distributed.sharding.head_view``:
    phi4-mini's 24 query heads of 128 at tp 16, 256 columns on ranks
    0-11): each view's product matches its plain version and the whole
    leaf's columns of those heads, f32 accumulators within 1e-5 of the
    largest value; ranks 12-15 hold no column and launch nothing."""
    from repro_torch.distributed.sharding import head_view
    q = _qlinear(3072, 3072, 0.2, seed=9, device=cuda)
    for m in (8, 256):
        x = torch.randn(m, q.k, device=cuda).to(torch.bfloat16)
        whole = tmm.mixed_matmul(x, q.w4, q.s4, q.z4, q.bits, q.alpha_s,
                                 q.alpha_r1, q.alpha_r2, perm=q.perm,
                                 out_dtype=torch.float32)
        for r in range(16):
            v = head_view(q, 24, r, 16)
            assert v.n == (256 if r < 12 else 0)
            args = (x, v.w4, v.s4, v.z4, v.bits, v.alpha_s, v.alpha_r1,
                    v.alpha_r2)
            before = tmm.KERNEL.launches
            part = tmm.mixed_matmul(*args, perm=v.perm,
                                    out_dtype=torch.float32)
            assert tmm.KERNEL.launches - before == (1 if v.n else 0)
            assert part.shape == (m, v.n)
            if not v.n:
                continue
            want = ref.mixed_matmul_ref(*args, perm=v.perm)
            scale = max(float(want.abs().max()), 1e-30)
            assert float((part - want).abs().max()) <= 1e-5 * scale
            cols = whole[:, 256 * r:256 * (r + 1)]
            assert float((part - cols).abs().max()) <= \
                1e-5 * float(whole.abs().max())
