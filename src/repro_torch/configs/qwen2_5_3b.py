"""qwen2.5-3b — exact assignment configuration.

source: hf:Qwen/Qwen2.5-0.5B; hf
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, Stage

CONFIG = ArchConfig(
    name="qwen2.5-3b", family="dense",
    d_model=2048, n_heads=16, n_kv_heads=2, head_dim=128,
    d_ff=11008, vocab=151936,
    stages=(Stage(("dense",), 36),),
    act="silu", qkv_bias=True, tied_embeddings=True,
    source="hf:Qwen/Qwen2.5-0.5B; hf")
