"""The paper's comparison quantizers (twin of ``repro.core.baselines``):
RTN, GPTQ, AWQ, PB-LLM and BiLLM, each a fake-quant function of one
(K, N) weight, and ``driver.quantize_model_baseline`` that runs them
block by block on calibration statistics."""
import torch


def column_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over dim 0 (keepdim) in a fixed pairwise order made of
    elementwise adds, so the card and the CPU round alike (a library
    reduction sums in an order of its own on each device)."""
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.zeros_like(x[:1])])
        h = x.shape[0] // 2
        x = x[:h] + x[h:]
    return x
