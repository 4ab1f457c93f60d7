"""mistral-nemo-12b [dense] — GQA, 128k ctx. [hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131_072,
    rope_theta=1e6,   # long-context base
    source="hf:mistralai/Mistral-Nemo-Base-2407",
))
