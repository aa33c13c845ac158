"""seamless-m4t-medium — exact assignment configuration.

source: arXiv:2308.11596; hf
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, Stage

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio",
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab=256206,
    stages=(Stage(("dense",), 12),),      # decoder stack
    act="gelu", norm="layernorm",
    enc_dec=True, n_enc_layers=12, frontend="audio",
    source="arXiv:2308.11596; hf")
