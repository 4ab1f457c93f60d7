"""olmo-1b [dense] — non-parametric LayerNorm. [arXiv:2402.00838; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50_304,
    parametric_norm=False,
    norm_type="layernorm",
    tie_embeddings=True,
    source="arXiv:2402.00838",
))
