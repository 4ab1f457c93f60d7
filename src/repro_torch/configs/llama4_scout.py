"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared expert, early
fusion (frontend stubbed). [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    rope_theta=5e5,
    moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192,
                  n_shared_experts=1, d_ff_shared=8192),
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
))
