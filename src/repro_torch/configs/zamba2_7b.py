"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention block applied
every 6th layer (weights shared across sites). [arXiv:2411.15242; unverified]"""
from repro_torch.configs.base import ArchConfig, MambaConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32_000,
    mamba=MambaConfig(d_state=64, head_dim=64, expand=2, n_groups=1),
    hybrid_attn_every=6,
    source="arXiv:2411.15242",
))
