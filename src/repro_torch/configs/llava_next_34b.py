"""llava-next-34b — exact assignment configuration.

source: hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, Stage

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm",
    d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab=64000,
    stages=(Stage(("dense",), 60),),
    act="silu", frontend="vision", frontend_tokens=576,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified")
