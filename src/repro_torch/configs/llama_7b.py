"""llama-7b — exact assignment configuration.

source: arXiv:2302.13971 (paper's Table 1 subject)
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, Stage

CONFIG = ArchConfig(
    name="llama-7b", family="dense",
    d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=11008, vocab=32000,
    stages=(Stage(("dense",), 32),),
    act="silu",
    source="arXiv:2302.13971 (paper's Table 1 subject)")
