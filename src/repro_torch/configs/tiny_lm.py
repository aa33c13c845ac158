"""tiny-lm — exact assignment configuration.

source: in-repo tiny subject for end-to-end PTQ experiments
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, Stage

CONFIG = ArchConfig(
    name="tiny-lm", family="dense",
    d_model=256, n_heads=8, n_kv_heads=4, head_dim=32,
    d_ff=704, vocab=512,
    stages=(Stage(("dense",), 4),),
    act="silu",
    source="in-repo tiny subject for end-to-end PTQ experiments")
