"""Serve a model with batched requests (the port of
``examples/serve_batch.py``): the prompt goes token by token through the
decode path, then greedy generation with the KV-cache and SSM-state
machinery, through ``serve.decode.greedy_generate``: the same serve step
that the decode dry-run cells count. On the card each tick of an
attention model runs the decode attention kernel once a layer that
attends (zamba2-7b's shared block included); WKV6 and SSD run on no tick
(the recurrent decode steps are plain torch, as in the reference).

    PYTHONPATH=src python -m repro_torch.examples.serve_batch --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_batch \\
        [--arch rwkv6-7b] [--full]

It runs on the card unless ``--device cpu`` is given, and raises without
one. The config is ``.reduced()`` as in the reference, or with ``--full``
the published width and depth. Weights are random, from a seeded
``torch.Generator``; prompts (and the VLM's vision states) from numpy
seeds.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_arch, list_archs
from repro_torch.models import model as M
from repro_torch.serve.decode import greedy_generate

WEIGHT_SEED, PROMPT_SEED, VISION_SEED = 0, 42, 7


def config(arch: str, full: bool = False):
    cfg = get_arch(arch)
    return cfg if full else cfg.reduced()


def inputs(cfg, batch: int, prompt_len: int):
    """(prompt, vision): prompt (B, S), or (B, S, K) with codebooks, int64
    token ids; vision (B, Nv, d_src) fp32 states for the VLM, else None.
    From numpy seeds (PROMPT_SEED and VISION_SEED, as the reference's
    keys 42 and 7), on the CPU."""
    books = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    prompt = torch.from_numpy(np.random.default_rng(PROMPT_SEED).integers(
        0, cfg.vocab_size, (batch, prompt_len, *books)))
    vision = torch.from_numpy(
        np.random.default_rng(VISION_SEED).standard_normal(
            (batch, cfg.n_vision_tokens, cfg.vision_dim)).astype(np.float32)) \
        if cfg.family == "vlm" else None
    return prompt, vision


def run(arch: str = "olmo-1b", batch: int = 4, prompt_len: int = 8,
        max_new: int = 12, *, full: bool = False, device="cuda",
        params=None, prompt=None, vision=None,
        compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The generated tokens of ``config(arch, full)``, (B, max_new) or
    (B, max_new, K). ``params`` default to ``init_params`` at WEIGHT_SEED
    on the device (cast once to the compute dtype where it is not fp32:
    the values of the blocks' per-call casts), ``prompt`` and ``vision``
    to ``inputs``' numpy-seeded ones."""
    dev = resolve_device(device)
    cfg = config(arch, full)
    if params is None:
        params = M.init_params(cfg, WEIGHT_SEED, device=dev)
        if compute_dtype != torch.float32:
            params = M.cast_params(params, compute_dtype)
    if prompt is None:
        prompt, vision = inputs(cfg, batch, prompt_len)
    return greedy_generate(cfg, params, prompt, max_new, vision=vision,
                           compute_dtype=compute_dtype, device=dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--full", action="store_true",
                    help="the published width and depth, not .reduced()")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = config(args.arch, args.full)
    prompt, vision = inputs(cfg, args.batch, args.prompt_len)
    print(f"serving {args.arch} ({'full' if args.full else 'reduced'}), "
          f"batch={args.batch}")
    out = run(args.arch, args.batch, args.prompt_len, args.max_new,
              full=args.full, device=dev, prompt=prompt, vision=vision)
    print("prompt :", prompt[0].tolist())
    print("output :", out[0].tolist())
    assert out.shape[1] == args.max_new
    print("ok — generated", tuple(out.shape), "tokens")
    return out


if __name__ == "__main__":
    main()
