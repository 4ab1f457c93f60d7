"""Data pipeline (a copy of ``repro/data/pipeline.py``): a deterministic
sharded synthetic token stream and its registration as a data-lake fileset.

Every shard is reproducible from (dataset_seed, host_index, step), so
training can restart anywhere without replaying the stream. The code is
numpy only and gives the reference's arrays byte for byte; ``register``
takes any project object with ``upload`` and ``create_file_set`` (the
reference's ``AcaiProject``), so nothing of the control plane is imported.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 256
    seq_len: int = 128
    global_batch: int = 8
    n_hosts: int = 1
    host_index: int = 0
    # markov-chain order-1 synthetic language (learnable structure)
    markov_temp: float = 1.5


class TokenPipeline:
    """Order-1 Markov synthetic LM data (it has learnable statistics, so the
    loss falls measurably in a few steps). The transition matrix is
    vocab_size², in fp64: keep the data vocabulary small."""

    def __init__(self, cfg: DataConfig, arch: Optional[ArchConfig] = None):
        self.cfg = cfg
        self.arch = arch
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        logits = rng.normal(0, cfg.markov_temp, (v, v))
        self.trans = np.exp(logits - logits.max(1, keepdims=True))
        self.trans /= self.trans.sum(1, keepdims=True)
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {cfg.n_hosts} hosts")
        self.local_batch = cfg.global_batch // cfg.n_hosts

    def _sample_rows(self, rng, n, s):
        v = self.cfg.vocab_size
        rows = np.empty((n, s + 1), np.int32)
        rows[:, 0] = rng.integers(0, v, n)
        # vectorized markov walk via inverse-CDF sampling
        cdf = np.cumsum(self.trans, axis=1)
        for t in range(s):
            u = rng.random(n)
            rows[:, t + 1] = (cdf[rows[:, t]] < u[:, None]).sum(1)
        return rows

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for (host, step): restart-safe."""
        c = self.cfg
        rng = np.random.default_rng(
            (c.seed, c.host_index, step, 0xACA1))
        rows = self._sample_rows(rng, self.local_batch, c.seq_len)
        batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
        if self.arch is not None and self.arch.n_codebooks:
            k = self.arch.n_codebooks
            rng2 = np.random.default_rng((c.seed, c.host_index, step, 1))
            toks = rng2.integers(0, c.vocab_size,
                                 (self.local_batch, c.seq_len, k),
                                 dtype=np.int32)
            batch = {"tokens": toks,
                     "labels": np.roll(toks, -1, axis=1)}
        if self.arch is not None and self.arch.family == "vlm":
            rng3 = np.random.default_rng((c.seed, c.host_index, step, 2))
            batch["vision"] = rng3.normal(
                0, 1, (self.local_batch, self.arch.n_vision_tokens,
                       self.arch.vision_dim)).astype(np.float32)
        return batch

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    # -- datalake registration ------------------------------------------
    def register(self, project, name: str, creator: str = "") -> str:
        """Upload the dataset's identity (its ``DataConfig``) and register it
        as fileset ``name``; returns the fileset's reference."""
        spec = dataclasses.asdict(self.cfg)
        project.upload(f"/datasets/{name}.json", json.dumps(spec).encode(),
                       creator)
        return project.create_file_set(name, [f"/datasets/{name}.json"],
                                       creator)
