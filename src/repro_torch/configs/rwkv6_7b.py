"""rwkv6-7b [ssm] — Finch, data-dependent decay, attn-free. [arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ArchConfig, RWKVConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,           # d_model / rwkv.head_dim
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65_536,
    rwkv=RWKVConfig(head_dim=64),
    source="arXiv:2404.05892",
))
