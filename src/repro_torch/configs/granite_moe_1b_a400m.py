"""granite-moe-1b-a400m — exact assignment configuration.

source: hf:ibm-granite/granite-3.0-1b-a400m-base; hf
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, Stage

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155,
    stages=(Stage(("moe",), 24),),
    act="silu", tied_embeddings=True,
    moe=MoEConfig(n_experts=32, top_k=8),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf")
