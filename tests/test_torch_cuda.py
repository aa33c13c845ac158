"""The port's CUDA kernels against their plain PyTorch versions.

Needs a CUDA device (the kernels have no CPU mode): every test skips
without one.  This file imports no JAX, so it runs on a GPU machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: mixed_matmul rtol 2^-7, atol 1e-3 (both sides round the
operands alike and accumulate in f32; the kernel rounds its output once
to bf16).  Attention in f32 pools: 1e-4 (online softmax over key tiles
against the dense softmax); pool bytes exact except the dump page.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.qlinear import QuantConfig, quantize_linear  # noqa: E402
from repro_torch.kernels import mixed_matmul as tmm  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import paged_prefill as tpf  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _qlinear(k, n, ratio, seed, device):
    g = torch.Generator().manual_seed(seed)
    w = (torch.randn(k, n, generator=g) / k ** 0.5).to(torch.bfloat16)
    q = quantize_linear(w, None, QuantConfig(ratio=ratio, multiple=16))
    return q.map(lambda t: t.to(device))


@pytest.mark.parametrize("k,n,ratio", [(256, 96, 0.1875), (4096, 200, 0.2),
                                       (11008, 64, 0.2)])
def test_mixed_matmul_matches_plain(cuda, k, n, ratio):
    q = _qlinear(k, n, ratio, seed=k, device=cuda)
    for m in (1, 3, 8, 20, 64):
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
    (4, None, None, 64)])
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

