"""Architecture config system (the port's own copy of ``repro/configs/base.py``).

Every assigned architecture is a frozen ``ArchConfig``; reduced smoke-test
variants are derived with ``.reduced()``. Configs are registered by id and
selectable everywhere via ``--arch <id>``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

_REGISTRY: dict[str, "ArchConfig"] = {}


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # every k-th layer is MoE (1 = all layers)
    moe_every: int = 1
    # independent routing groups (aligned with data shards so dispatch
    # scatter/gather stays device-local); capacity is per group
    n_dispatch_groups: int = 16
    # compute the shared expert INSIDE the EP shard_map on its model-axis
    # ff slice so its partial sums ride the EP psum (one collective
    # instead of two) — §Perf cell B
    fuse_shared: bool = False


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    lora_shift: int = 32
    lora_decay: int = 64
    chunk: int = 256


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    qk_norm: bool = False
    parametric_norm: bool = True            # False => OLMo non-parametric LN
    norm_type: str = "rmsnorm"              # rmsnorm | layernorm
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # hybrid (zamba2): one shared attention block applied every k layers
    hybrid_attn_every: int = 0
    # vlm (llama-3.2-vision): a cross-attention layer every k layers
    cross_attn_every: int = 0
    vision_dim: int = 0
    n_vision_tokens: int = 0
    # audio (musicgen): number of codebooks (input (B,S,K), K lm heads)
    n_codebooks: int = 0
    norm_eps: float = 1e-5
    source: str = ""

    # ---- derived -----------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """True if the arch can run the long_500k decode shape."""
        return self.family in ("ssm", "hybrid")

    def layer_kinds(self) -> list[str]:
        """Per-layer block kinds; drives the group layout in transformer.py."""
        kinds = []
        for i in range(self.n_layers):
            if self.family == "ssm":
                kinds.append("rwkv")
            elif self.family == "hybrid":
                # every hybrid_attn_every-th layer is the shared attn block
                if self.hybrid_attn_every and (i % self.hybrid_attn_every
                                               == self.hybrid_attn_every - 1):
                    kinds.append("shared_attn")
                else:
                    kinds.append("mamba")
            elif self.family == "vlm" and self.cross_attn_every and (
                    i % self.cross_attn_every == self.cross_attn_every - 1):
                kinds.append("cross_attn")
            elif self.moe is not None and (i % self.moe.moe_every
                                           == self.moe.moe_every - 1):
                kinds.append("moe")
            else:
                kinds.append("dense")
        return kinds

    def n_params(self) -> int:
        """Total parameter count (embedding included)."""
        d, hd = self.d_model, self.resolved_head_dim
        total = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            if self.n_codebooks:
                total += self.n_codebooks * self.vocab_size * d
            else:
                total += self.vocab_size * d
        for kind in self.layer_kinds():
            total += self._block_params(kind)
        total += d  # final norm
        return total

    def n_active_params(self) -> int:
        """Active-per-token params (differs from n_params for MoE)."""
        d = self.d_model
        total = self.vocab_size * d
        if not self.tie_embeddings:
            total += (self.n_codebooks or 1) * self.vocab_size * d
        for kind in self.layer_kinds():
            if kind == "moe":
                m = self.moe
                act = self._attn_params() + 2 * d
                act += m.top_k * 3 * d * m.d_ff_expert
                act += m.n_shared_experts * 3 * d * m.d_ff_shared
                act += d * m.n_experts  # router
                total += act
            else:
                total += self._block_params(kind)
        return total + d

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        p = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        if self.qk_norm:
            p += 2 * hd
        return p

    def _block_params(self, kind: str) -> int:
        d = self.d_model
        if kind == "dense":
            return self._attn_params() + 3 * d * self.d_ff + 2 * d
        if kind == "moe":
            m = self.moe
            p = self._attn_params() + 2 * d + d * m.n_experts
            p += m.n_experts * 3 * d * m.d_ff_expert
            p += m.n_shared_experts * 3 * d * m.d_ff_shared
            return p
        if kind == "rwkv":
            r = self.rwkv
            hd = r.head_dim
            # time-mix: 5 projections d*d (r,k,v,g,o) + loras + channel mix
            p = 5 * d * d + 5 * (d * r.lora_shift + r.lora_shift * d) \
                + d * r.lora_decay + r.lora_decay * d + 2 * d
            p += 2 * d * self.d_ff + d * d  # channel mix (w_k, w_v, w_r)
            return p + 2 * d
        if kind == "mamba":
            mc = self.mamba
            di = mc.d_inner(d)
            nh = mc.n_heads(d)
            p = d * (2 * di + 2 * mc.n_groups * mc.d_state + nh)  # in_proj
            p += (di + 2 * mc.n_groups * mc.d_state) * mc.d_conv  # conv
            p += 3 * nh + di  # A_log, D, dt_bias, gate norm
            p += di * d + d  # out_proj + pre-norm
            return p
        if kind == "shared_attn":
            # weights shared across sites: counted once at layout build time
            return 0
        if kind == "cross_attn":
            d_src = self.vision_dim or d
            hd = self.resolved_head_dim
            p = d * self.n_heads * hd + 2 * d_src * self.n_kv_heads * hd \
                + self.n_heads * hd * d + 2 * d
            p += 3 * d * self.d_ff + d  # its own MLP
            return p
        raise ValueError(kind)

    def shared_block_params(self) -> int:
        if self.family != "hybrid":
            return 0
        return self._attn_params() + 3 * self.d_model * self.d_ff \
            + 2 * self.d_model

    # ---- reduced smoke-test variant ----------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        hd = 16
        n_heads = max(2, min(4, self.n_heads))
        n_kv = max(1, min(n_heads, self.n_kv_heads * n_heads
                          // max(self.n_heads, 1)) or 1)
        kw = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4 if self.family not in
                         ("hybrid", "vlm") else 6),
            d_model=64,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=hd,
            d_ff=128,
            vocab_size=256,
        )
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2),
                d_ff_expert=64, n_dispatch_groups=1,
                d_ff_shared=64 if self.moe.n_shared_experts else 0)
        if self.mamba:
            kw["mamba"] = dataclasses.replace(
                self.mamba, d_state=16, head_dim=16, chunk=16)
        if self.rwkv:
            kw["rwkv"] = dataclasses.replace(
                self.rwkv, head_dim=16, lora_shift=8, lora_decay=8, chunk=16)
        if self.family == "hybrid":
            kw["hybrid_attn_every"] = 3
        if self.family == "vlm":
            kw["cross_attn_every"] = 3
            kw["vision_dim"] = 48
            kw["n_vision_tokens"] = 8
        return dataclasses.replace(self, **kw)


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    from repro_torch.configs import (  # noqa: F401
        qwen3_32b, qwen3_8b, mistral_nemo_12b, olmo_1b, olmoe_1b_7b,
        llama4_scout, rwkv6_7b, llama32_vision_11b, zamba2_7b,
        musicgen_large)
