"""Port parity of restorative-LoRA preprocessing (``core/preprocess.py``)
against ``repro.core.preprocess``.

The subject is tiny-lm reduced in f32, weights built in ``repro`` and
carried across by the bridge; LoRA factors are drawn by the reference's
``init_lora`` and carried across as numpy.  ``repro`` stacks each
stage's layers on a leading axis and keys one LoRA pair per stacked leaf
(``['stages'][s][pos]['attn']['wq']``); the port keys one pair per layer
(``['stages'][s][layer][pos]['attn']['wq']``): ``_ref_key`` maps one to
the other.

Tolerances (both sides compute in f32 and differ in summation order):
- the loss 1e-5 relative;
- the one-step gradients 1e-4 relative (Frobenius, per factor): the
  fake-quant weights are bf16, as the reference's ``to_dense`` makes
  them, so each side rounds dL/dW to bf16 on the way back to the f32
  factors, and an f32 difference in summation order can move an
  element across a bf16 rounding boundary;
- ``merge_lora`` 1e-6 absolute;
- five steps of ``restorative_lora``: the loss trajectory 1e-4 relative
  (against the reference's logged losses, printed to 4 decimals, about
  1.5e-5 relative at these losses), and W' − W 1e-3 relative (Frobenius,
  per leaf).  Adam's first steps move each element by about lr whatever
  the size of its gradient, so an element whose gradient is near zero
  may step with the other sign on the two sides; W' − W is the sum of
  such steps, so it is held per leaf in norm, not per element.
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.core import preprocess as RP  # noqa: E402
from repro.core.pipeline import quantize_params_data_free as r_qdf  # noqa: E402
from repro.core.qlinear import QLinear as RQLinear  # noqa: E402
from repro.core.qlinear import QuantConfig as RQC  # noqa: E402
from repro.data.synthetic import CorpusConfig, SyntheticCorpus  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.common import Parallel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.core import preprocess as TP  # noqa: E402
from repro_torch.core.qlinear import QuantConfig as TQC  # noqa: E402
from repro_torch.core.select import map_quantizable  # noqa: E402

PAR = Parallel(tp=1, dp=1, remat=False, attn_chunk=32)
MIN_DIM = 32
QKW = dict(ratio=0.2, multiple=16, steps=16)
PKW = dict(rank=8, steps=5, lr=3e-4)


@pytest.fixture(scope="module")
def subject():
    cfg = registry.get("tiny-lm").reduced()
    p = RM.init_params(cfg, PAR, jax.random.PRNGKey(0))
    p = jax.tree.map(lambda a: a.astype(jnp.float32)
                     if a.dtype == jnp.bfloat16 else a, p)
    tp = bridge.params_from_repro(jax.tree.map(np.asarray, p))
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=0))
    batches = list(corpus.batches(2, 32, 2, split="calib"))
    return cfg, t_registry.get("tiny-lm").reduced(), p, tp, batches


def _ref_key(key: str):
    """Port LoRA key -> (the reference's key, layer index)."""
    m = re.fullmatch(r"\['stages'\]\[(\d+)\]\[(\d+)\]\[(\d+)\](.*)", key)
    return f"['stages'][{m[1]}][{m[3]}]{m[4]}", int(m[2])


def _carry(port_lora, ref_lora):
    """The reference's LoRA factors in the port's layout."""
    out = {}
    for k, ab in port_lora.items():
        rk, layer = _ref_key(k)
        out[k] = {f: torch.from_numpy(np.array(ref_lora[rk][f][layer]))
                  for f in ab}
    return out


def _frob(a, b) -> float:
    """||a − b|| / ||b|| (0 when both are zero)."""
    num = float(np.linalg.norm(np.asarray(a) - np.asarray(b)))
    den = float(np.linalg.norm(np.asarray(b)))
    return num / den if den else num


def test_init_lora_has_the_reference_shapes_with_b_zero(subject):
    cfg, tcfg, p, tp, _ = subject
    rl = RP.init_lora(p, RP.PreprocessConfig(**PKW), min_dim=MIN_DIM)
    tl = TP.init_lora(tp, TP.PreprocessConfig(**PKW), min_dim=MIN_DIM)
    assert len(tl) == cfg.n_layers * len(rl) and len(rl) == 7
    for k, ab in tl.items():
        rk, _ = _ref_key(k)
        assert tuple(ab["a"].shape) == rl[rk]["a"].shape[1:]
        assert tuple(ab["b"].shape) == rl[rk]["b"].shape[1:]
        assert ab["a"].dtype == ab["b"].dtype == torch.float32
        assert not ab["b"].any() and ab["a"].abs().max() < 0.1
    # the generator is seeded: the same draw twice, another with a new seed
    again = TP.init_lora(tp, TP.PreprocessConfig(**PKW), min_dim=MIN_DIM)
    other = TP.init_lora(tp, TP.PreprocessConfig(**PKW, seed=8),
                         min_dim=MIN_DIM)
    k0 = next(iter(tl))
    assert torch.equal(tl[k0]["a"], again[k0]["a"])
    assert not torch.equal(tl[k0]["a"], other[k0]["a"])


def test_one_step_loss_and_gradients_match_repro(subject):
    cfg, tcfg, p, tp, batches = subject
    pcfg = RP.PreprocessConfig(**PKW)
    scale = pcfg.lora_alpha / pcfg.rank
    rl = RP.init_lora(p, pcfg, min_dim=MIN_DIM)
    tl = _carry(TP.init_lora(tp, TP.PreprocessConfig(**PKW),
                             min_dim=MIN_DIM), rl)
    toks, tgts = batches[0]

    # the reference's training loss, as restorative_lora builds it
    q0 = r_qdf(p, dataclasses.replace(RQC(**QKW), learn_scales=False),
               min_dim=MIN_DIM)
    q0d = jax.tree.map(lambda x: x.to_dense() if isinstance(x, RQLinear)
                       else x, q0, is_leaf=lambda x: isinstance(x, RQLinear))

    def rloss(lora):
        return RM.forward_loss(cfg, PAR, RP.merge_lora(q0d, lora, scale,
                                                       min_dim=MIN_DIM),
                               {"tokens": jnp.asarray(toks),
                                "targets": jnp.asarray(tgts)})
    r_loss, r_grads = jax.jit(jax.value_and_grad(rloss))(rl)

    tq0d = TP.initial_dense(tp, TQC(**QKW), MIN_DIM)
    leaves = [t.requires_grad_(True) for ab in tl.values()
              for t in ab.values()]
    t_loss = TP.lora_loss(tcfg, tq0d, tl, scale,
                          {"tokens": torch.from_numpy(toks),
                           "targets": torch.from_numpy(tgts)},
                          MIN_DIM, attn_chunk=32)
    grads = iter(torch.autograd.grad(t_loss, leaves))
    t_loss = t_loss.detach()
    assert abs(float(t_loss) - float(r_loss)) <= 1e-5 * abs(float(r_loss))
    worst = 0.0
    for k, ab in tl.items():
        rk, layer = _ref_key(k)
        for f in ab:
            g = next(grads)
            ref = np.array(r_grads[rk][f][layer])
            worst = max(worst, _frob(g.numpy(), ref))
            if f == "b":
                assert np.linalg.norm(ref) > 0, "B must get a gradient"
    assert worst <= 1e-4, worst


def test_merge_lora_matches_repro(subject):
    _, _, p, tp, _ = subject
    pcfg = RP.PreprocessConfig(**PKW)
    rng = np.random.default_rng(11)
    rl = {k: {"a": ab["a"],
              "b": jnp.asarray(0.05 * rng.standard_normal(ab["b"].shape),
                               jnp.float32)}
          for k, ab in RP.init_lora(p, pcfg, min_dim=MIN_DIM).items()}
    tl = _carry(TP.init_lora(tp, TP.PreprocessConfig(**PKW),
                             min_dim=MIN_DIM), rl)
    scale = pcfg.lora_alpha / pcfg.rank
    rm = RP.merge_lora(p, rl, scale, min_dim=MIN_DIM)
    tm = TP.merge_lora(tp, tl, scale, min_dim=MIN_DIM)
    n = 0

    def visit(path, w):
        nonlocal n
        stage, layer, pos, blk, name = path[1:]
        ref = np.asarray(rm["stages"][stage][pos][blk][name][layer])
        assert np.abs(w.numpy() - ref).max() <= 1e-6
        n += 1
        return w
    map_quantizable(tm, visit, min_dim=MIN_DIM)
    assert n == 7


def test_restorative_lora_five_steps_match_repro(subject, monkeypatch):
    cfg, tcfg, p, tp, batches = subject
    pcfg = RP.PreprocessConfig(**PKW)
    # the port draws A from torch's generator: give it the reference's
    # draw instead, so both start from the same factors
    ref_init = RP.init_lora(p, pcfg, min_dim=MIN_DIM)
    port_init = TP.init_lora
    monkeypatch.setattr(TP, "init_lora", lambda params, pc, min_dim: _carry(
        port_init(params, pc, min_dim), ref_init))
    logs = []
    rw = RP.restorative_lora(
        cfg, PAR, p, [{"tokens": jnp.asarray(t), "targets": jnp.asarray(g)}
                      for t, g in batches],
        RQC(**QKW), pcfg, min_dim=MIN_DIM, log=logs.append)
    losses = []
    tw = TP.restorative_lora(
        tcfg, tp, [{"tokens": torch.from_numpy(t),
                    "targets": torch.from_numpy(g)} for t, g in batches],
        TQC(**QKW), TP.PreprocessConfig(**PKW), min_dim=MIN_DIM,
        attn_chunk=32, losses=losses)
    ref_losses = [float(line.rsplit(" ", 1)[1]) for line in logs]
    assert len(ref_losses) == len(losses) == PKW["steps"]
    for a, b in zip(losses, ref_losses):
        assert abs(a - b) <= 1e-4 * abs(b), (losses, ref_losses)
    n = 0

    def visit(path, w):
        nonlocal n
        stage, layer, pos, blk, name = path[1:]
        ref = np.asarray(rw["stages"][stage][pos][blk][name][layer])
        base = np.asarray(p["stages"][stage][pos][blk][name][layer])
        moved = ref - base
        assert np.linalg.norm(moved) > 0, "preprocessing must move W"
        assert _frob(w.numpy() - tp_leaf(path), moved) <= 1e-3
        n += 1
        return w

    def tp_leaf(path):
        x = tp
        for k in path:
            x = x[k]
        return x.numpy()
    map_quantizable(tw, visit, min_dim=MIN_DIM)
    assert n == 7
    # embeddings, norms and the head are not touched
    assert torch.equal(tw["embed"], tp["embed"])
