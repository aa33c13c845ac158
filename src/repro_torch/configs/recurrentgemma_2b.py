"""recurrentgemma-2b — exact assignment configuration.

source: arXiv:2402.19427; hf
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, Stage

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab=256000,
    stages=(Stage(("rglru", "rglru", "local"), 8),
            Stage(("rglru",), 2)),
    act="gelu", local_window=2048, rnn_width=2560, tied_embeddings=True,
    source="arXiv:2402.19427; hf")
