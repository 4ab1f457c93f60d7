"""qwen3-32b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-32B; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-32B",
))
