"""llama-3.2-vision-11b [vlm] — cross-attn image layers every 5th layer;
vision frontend stubbed (input_specs provides patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128_256,
    rope_theta=5e5,
    cross_attn_every=5,
    vision_dim=1280,
    n_vision_tokens=1601,   # 1 tile x (40x40+1) patches
    source="hf:meta-llama/Llama-3.2-11B-Vision",
))
