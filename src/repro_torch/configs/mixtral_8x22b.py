"""mixtral-8x22b — exact assignment configuration.

source: arXiv:2401.04088; hf
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, Stage

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=32768,
    stages=(Stage(("moe",), 56),),
    act="silu", attn_window=4096,   # SWA per assignment
    moe=MoEConfig(n_experts=8, top_k=2),
    source="arXiv:2401.04088; hf")
