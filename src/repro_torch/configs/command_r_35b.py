"""command-r-35b — exact assignment configuration.

source: hf:CohereForAI/c4ai-command-r-v01; unverified
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, Stage

CONFIG = ArchConfig(
    name="command-r-35b", family="dense",
    d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22528, vocab=256000,
    stages=(Stage(("dense",), 40),),
    act="silu", norm="layernorm", qkv_bias=False,
    source="hf:CohereForAI/c4ai-command-r-v01; unverified")
