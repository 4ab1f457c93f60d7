#!/usr/bin/env python3
"""Smoke run of the port's VLM and audio families on one NVIDIA H100:
llama-3.2-vision-11b and musicgen-large, beside ``chip_smoke.py``, which
checks their kernels at these models' shapes (its phase 3) and leaves
their model paths to this script to stay inside its own time limit.

    python3 chip_smoke_media.py

It reuses chip_smoke.py's helpers, so it runs from a checkout that holds
both. Phases, in order (each logged with the script's elapsed seconds);
any failure raises, and the script then exits non-zero without printing a
result:

1. card: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: nvcc builds every kernel in src/repro_torch/csrc/ into build/;
3. reference: reduced llama-3.2-vision-11b (its gates seeded, see
   chip_smoke._enliven) and musicgen-large on the card (kernels) against
   the CPU (plain versions), fp32, prefill and decode logits; then both at
   full width and reduced depth (the VLM at 1 period: 4 dense layers and a
   cross-attention layer; musicgen-large at 2 layers), fp32, prefill
   against serving (the decode path, fed token by token as
   ``greedy_generate`` feeds it) on the card, within 1e-3 of the logits'
   range. The VLM's prefill logits must move when its vision states
   change (check_vision_counts), reduced and at full width;
4. slices, each model at full width and depth from seeded random weights
   (bf16 compute), freed before the next: llama-3.2-vision-11b (40 layers:
   8 periods of 4 dense layers and a cross-attention layer; 9.95 B
   weights, 19.9 GB in bf16) and musicgen-large (48 layers, 4 codebooks),
   which the serving driver refuses as the reference's does (their
   requests carry vision states or frames of codes). Each runs the
   prefill step on 4 prompts of 2048 (the VLM with 4 seeded images of
   (1601, 1280)), three calls, the first a warm-up; ``greedy_generate`` on
   4 prompts of 256 tokens (musicgen: frames of 4 codes) and 32 new ones
   (287 ticks); the same prompts through the serve step alone
   (served_logits), whose logits at the last prompt token must match the
   prefill step's within check_parity's rule. Every attention layer
   launches flash once a prefill call and decode once a tick (32 and 48;
   the VLM's 8 cross-attention layers are plain torch, as the reference's
   einsums are), and no other kernel runs. A profiled window of 20 ticks
   follows (run_media_slice);
5. train (plain torch and autograd; no kernel launches): both at full
   width, fp32, one step on the card against the CPU at 2x256 (the VLM
   with 5 layers, vision states in the batch; musicgen-large with 2), remat
   none, full and dots giving equal gradients at 1x1536; then the VLM at 5
   of its 40 layers (1 period: 2 periods do not fit AdamW's fp32 state in
   70 GB) and musicgen-large at all 48, bf16 compute, 4x2048 tokens a
   step: 6 steps and a profiled one, with ms a step, train_mfu and peak
   memory (chip_smoke.run_train_family).

The last three lines are the main path's kernel launches as JSON, the
card's name and power limit, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time

import chip_smoke as S
from chip_smoke import PREFILL_BATCH, PREFILL_LEN, log, phase

# the models served: prompts, prompt length (musicgen: frames of 4 codes),
# new tokens each
MEDIA_SLICES = {"llama-3.2-vision-11b": (4, 256, 32),
                "musicgen-large": (4, 256, 32)}
# as chip_smoke.TRAIN_FAMILIES: layers of the timed run (fp32 params,
# grads and AdamW moments: 37.6 and 52 GB), layers and sequence length of
# the fp32 parity step, its gradient gate, no scan
MEDIA_TRAIN = {"llama-3.2-vision-11b": (5, 5, 256, 1e-4, None),
               "musicgen-large": (48, 2, 256, 1e-4, None)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke_media: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(S.ROOT / "src"))
    import numpy as np

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    from repro_torch.serve import decode as D

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    phase("1. card")
    card = S.card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    phase("2. build")
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"build: {len(logs)} kernel source(s) in "
        f"{time.perf_counter() - t0:.2f} s")

    phase("3. reference")
    log("reference: reduced configs, card against CPU, fp32")
    for arch in MEDIA_SLICES:
        cfg = get_arch(arch).reduced()
        S.check_reduced(cfg, dev)
        if cfg.family == "vlm":
            params = S.weights(cfg, dev)
            check_vision_counts(cfg, params, S.model_batch(
                cfg, np.random.default_rng(1), 2, 37))
            del params
    log("reference: full width at reduced depth, fp32, prefill against "
        "serving on the card")
    for arch, layers in (("llama-3.2-vision-11b", 5), ("musicgen-large", 2)):
        cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
        params = S.weights(cfg, dev)
        rng = np.random.default_rng(2)
        pre = D.make_prefill_step(cfg, compute_dtype=torch.float32)
        for n in (100, 37):
            batch = S.model_batch(cfg, rng, 1, n)
            want = pre(params, batch)[0].cpu()
            got = served_logits(cfg, params, batch, 1,
                                compute_dtype=torch.float32)[0]
            err = (got - want).abs().max().item()
            limit = 1e-3 * want.abs().max().item()
            log(f"  {arch}, {layers} layers, prompt of {n}: "
                f"max_abs_err={err:.3e} (limit {limit:.3e})")
            if not err <= limit:
                raise AssertionError(f"{arch}: fp32 prefill and serving "
                                     f"disagree at full width")
        if cfg.family == "vlm":
            check_vision_counts(cfg, params, batch)
        del params
        S.free()

    counters = S.launch_counters()
    totals = dict.fromkeys(counters, 0)
    for arch, shape in MEDIA_SLICES.items():
        phase(f"4. slice {arch}")
        cfg = get_arch(arch)
        t0 = time.perf_counter()
        params = M.cast_params(S.weights(cfg, dev), torch.bfloat16)
        S.free()
        media = f"a cross-attention layer every {cfg.cross_attn_every}, " \
            f"vision ({cfg.n_vision_tokens}, {cfg.vision_dim})" \
            if cfg.family == "vlm" else f"{cfg.n_codebooks} codebooks"
        log(f"slice: {cfg.name} {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.resolved_head_dim} "
            f"on {cfg.n_kv_heads} kv heads, d_ff {cfg.d_ff}, vocab "
            f"{cfg.vocab_size}, {media}; weights in "
            f"{time.perf_counter() - t0:.2f} s, "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
        counts, batch, pre16, served16 = run_media_slice(cfg, params, card,
                                                         counters, shape)
        for name, n in counts.items():
            totals[name] += n
        del params
        S.free()
        params = S.weights(cfg, dev)       # fp32, after the counts are read
        log("parity: " + json.dumps(S.check_parity(
            cfg, params, [batch], pre16, served16, card)))
        del params
        S.free()

    phase("5. train")
    S.check_family_train_parity(card, dev, MEDIA_TRAIN)
    S.free()
    for arch in MEDIA_TRAIN:
        log("train: " + json.dumps(S.run_train_family(
            card, counters, dev, arch, MEDIA_TRAIN)))
        S.free()

    phase("end")
    print(json.dumps({"kernels": [{"name": k, "launches": n}
                                  for k, n in totals.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def check_vision_counts(cfg, params, batch) -> None:
    """The VLM's fp32 prefill logits move when the vision states change
    (other seeded states, the same tokens) by more than 1e-3 of their
    range: with the gates at the reference's zero they would not move."""
    import numpy as np
    import torch

    from repro_torch.serve import decode as D
    pre = D.make_prefill_step(cfg, compute_dtype=torch.float32,
                              device=params["embed"].device)
    other = {**batch, "vision": S.model_batch(
        cfg, np.random.default_rng(7), *batch["tokens"].shape[:2])["vision"]}
    a, b = pre(params, batch).cpu(), pre(params, other).cpu()
    moved, limit = (a - b).abs().max().item(), 1e-3 * a.abs().max().item()
    log(f"  {cfg.name}, {cfg.n_layers} layers: other vision states move the "
        f"logits by {moved:.3e} (gate > {limit:.3e})")
    if not moved > limit:
        raise AssertionError(f"{cfg.name}: the logits ignore the vision")


def served_logits(cfg, params, batch, max_new: int, compute_dtype=None):
    """The serve step's logits at the last prompt token: the batch's
    prompts (and vision states) fed token by token through the decode
    path in a buffer of prompt + ``max_new``, as ``greedy_generate`` feeds
    them. Returns (B, V), or (B, K, V) with codebooks, fp32 on the host."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.serve import decode as D
    dev = params["embed"].device
    cd = compute_dtype or torch.bfloat16
    toks = batch["tokens"].to(dev)
    b, s = toks.shape[:2]
    vision = batch.get("vision")
    vision = None if vision is None else vision.to(dev)
    states = T.init_decode_state(cfg, b, s + max_new, dtype=cd, device=dev,
                                 vision=vision, params=params)
    step = D.make_serve_step(cfg, s + max_new, compute_dtype=cd, device=dev)
    lens = torch.zeros((b,), dtype=torch.int32, device=dev)
    for t in range(s):
        feed = {"tokens": toks[:, t:t + 1], "cache_len": lens}
        if vision is not None:
            feed["vision"] = vision
        logits, states, _ = step(params, states, feed)
        lens = lens + 1
    return logits[:, -1].float().cpu()


def run_media_slice(cfg, params, card, counters, shape):
    """The main path of a model the serving driver refuses, in bf16: the
    prefill step on PREFILL_BATCH prompts of PREFILL_LEN (the VLM with as
    many seeded images), three calls, the first a warm-up;
    ``greedy_generate`` on a batch of prompts, each fed token by token and
    then extended by new tokens; the same prompts through the serve step
    alone (served_logits) and through the prefill step. The launch
    counters are zeroed before and checked after each part. Returns the
    launch counts, the prompt batch, and each prompt's prefill and served
    logits at its last token."""
    import numpy as np
    import torch

    from repro_torch.serve import decode as D

    rows, prompt_len, max_new = shape
    per_call, per_tick = S.launches_per_call(cfg)

    def check(what, calls, ticks):
        got = {k: c.launches for k, c in counters.items()}
        want = {k: calls * per_call.get(k, 0) + ticks * per_tick.get(k, 0)
                for k in counters}
        if got != want:
            raise AssertionError(f"{cfg.name} {what}: launches {got}, "
                                 f"expected {want}")
        return got

    rng = np.random.default_rng(0)
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0

    prefill = D.make_prefill_step(cfg)
    long = {k: v.to(params["embed"].device) for k, v in S.model_batch(
        cfg, rng, PREFILL_BATCH, PREFILL_LEN).items()}
    prefill_s = []
    for _ in range(3):                    # the first call warms up
        t0 = time.perf_counter()
        out = prefill(params, long)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    books = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    if tuple(out.shape) != (PREFILL_BATCH, *books, cfg.vocab_size) or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError(f"prefill gave {tuple(out.shape)} or non-finite")
    check("prefill", 3, 0)

    batch = S.model_batch(cfg, rng, rows, prompt_len)
    ticks = prompt_len + max_new - 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = D.greedy_generate(cfg, params, batch["tokens"], max_new,
                             vision=batch.get("vision"),
                             device=params["embed"].device)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    check(f"greedy_generate ({ticks} ticks)", 3, ticks)
    if tuple(toks.shape) != (rows, max_new, *books) or \
            int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"generated {tuple(toks.shape)} tokens, or out "
                             f"of range")
    served = served_logits(cfg, params, batch, max_new)
    pre16 = prefill(params, batch).float().cpu()
    torch.cuda.synchronize()
    launches = check("main path", 4, ticks + prompt_len)
    if not (bool(torch.isfinite(pre16).all())
            and bool(torch.isfinite(served).all())):
        raise AssertionError(f"{cfg.name}: non-finite prefill or served "
                             "logits")

    numbers = {
        "arch": cfg.name, "card": card,
        "prefill_ms": 1e3 * sum(prefill_s[1:]) / len(prefill_s[1:]),
        "prefill_shape": [PREFILL_BATCH, PREFILL_LEN, *books],
        "prompts": rows, "prompt_len": prompt_len, "max_new": max_new,
        "decode_ticks": ticks, "ms_per_tick": 1e3 * serve_s / ticks,
        # a musicgen token is a frame of K codes
        "generated_tokens_per_s": rows * max_new / serve_s,
        "fed_tokens_per_s": rows * ticks / serve_s, "serve_s": serve_s,
        # the served logits' argmax is greedy_generate's first new token
        "first_token_agrees": int(torch.equal(served.argmax(-1),
                                              toks[:, 0].cpu())),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
    }
    log("slice: " + json.dumps(numbers))
    log("profile: " + json.dumps(S.profile_ticks(
        cfg, params, card, rows, prompt_len + max_new,
        vision=batch.get("vision"))))
    return launches, batch, list(pre16), list(served)


if __name__ == "__main__":
    sys.exit(main())
