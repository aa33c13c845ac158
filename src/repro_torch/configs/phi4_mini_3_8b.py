"""phi4-mini-3.8b — exact assignment configuration.

source: arXiv:2412.08905; hf
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, Stage

CONFIG = ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=200064,
    stages=(Stage(("dense",), 32),),
    act="silu", tied_embeddings=True,
    source="arXiv:2412.08905; hf")
