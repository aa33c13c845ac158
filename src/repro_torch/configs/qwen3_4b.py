"""qwen3-4b — exact assignment configuration.

source: hf:Qwen/Qwen3-8B; hf
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, Stage

CONFIG = ArchConfig(
    name="qwen3-4b", family="dense",
    d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=9728, vocab=151936,
    stages=(Stage(("dense",), 36),),
    act="silu", qk_norm=True, tied_embeddings=True,
    source="hf:Qwen/Qwen3-8B; hf")
