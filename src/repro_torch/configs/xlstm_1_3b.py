"""xlstm-1.3b — exact assignment configuration.

source: arXiv:2405.04517; unverified
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, Stage

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    d_model=2048, n_heads=4, n_kv_heads=4, head_dim=512,
    d_ff=0, vocab=50304,
    stages=(Stage(("mlstm",) * 7 + ("slstm",), 6),),
    norm="layernorm", mlstm_proj_factor=2.0,
    source="arXiv:2405.04517; unverified")
