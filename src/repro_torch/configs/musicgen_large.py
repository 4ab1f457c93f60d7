"""musicgen-large [audio] — decoder-only over EnCodec tokens, 4 codebooks
(delay pattern / EnCodec frontend stubbed: inputs are (B, S, K) code ids).
[arXiv:2306.05284; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    n_codebooks=4,
    norm_type="layernorm",
    source="arXiv:2306.05284",
))
