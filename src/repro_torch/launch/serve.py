"""Batched serving driver (the port of ``repro/launch/serve.py``): a
continuous-batching loop over the one-token serve step.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --requests 6
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

``main()`` serves a reduced config, as the reference does; ``serve()`` is
the loop itself and runs any token-only config (both refuse the VLM and the
codebook archs, as the reference's driver does).
"""
from __future__ import annotations

import argparse
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, get_arch, list_archs
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.serve import decode as D
from repro_torch.serve.decode import make_serve_step


@dataclass
class ServeResult:
    outputs: list[list[int]]          # generated tokens, per request
    first_logits: list[torch.Tensor]  # fp32 logits at each prompt's last token
    ticks: int                        # decode steps taken
    seconds: float                    # host wall time of the loop


def serve(cfg: ArchConfig, params, prompts: list[list[int]], *, slots: int,
          buf: int, max_new: int, compute_dtype=torch.bfloat16,
          device="cuda", mesh=None, layout: str = "fsdp") -> ServeResult:
    """Serve ``prompts`` through ``slots`` decode slots with caches of
    ``buf`` positions. Slots hold independent requests; a finished slot is
    refilled from the queue without stalling the others. A prompt is fed
    one token per tick through the decode step, then ``max_new`` tokens are
    generated greedily. Token-only archs: the reference's driver refuses
    the VLM and codebook archs, whose requests carry vision states or code
    frames (serve them with ``serve.decode.greedy_generate``). With
    ``mesh`` (a ``DeviceMesh`` of any (D, M) shape; every rank calls
    ``serve`` with the same prompts), params are DTensors under
    ``train_step.sharded_specs``' of the serving ``layout`` ("fsdp", or
    "resident": ``fsdp=False``, the batch replicated) and the loop runs the
    sharded serve step at any slot count (every token-only layout; a KV
    cache's sequence shards where the spec puts it on the mesh; the
    recurrent families reset a slot's state on the ranks that hold it);
    every rank gets the results."""
    dev = resolve_device(device)
    if not token_only(cfg):
        raise ValueError(f"{cfg.name}: the serving driver supports "
                         "token-only archs")
    if not prompts or min(len(p) for p in prompts) == 0:
        raise ValueError("every request needs a non-empty prompt")
    longest = max(len(p) for p in prompts)
    if buf < longest + max_new:
        raise ValueError(f"buf {buf} < longest prompt {longest} + max_new "
                         f"{max_new}: positions would run past the cache")
    if mesh is None:
        states = T.init_decode_state(cfg, slots, buf, dtype=compute_dtype,
                                     device=dev)
        step = make_serve_step(cfg, buf, compute_dtype=compute_dtype,
                               device=dev)
    else:
        states = D.init_sharded_decode_state(cfg, mesh, slots, buf,
                                             dtype=compute_dtype, device=dev,
                                             layout=layout)
        step = D.make_sharded_serve_step(cfg, mesh, buf,
                                         compute_dtype=compute_dtype,
                                         device=dev, layout=layout)

    cache_len = np.zeros((slots,), np.int32)
    cur = np.zeros((slots, 1), np.int64)
    slot_req = [-1] * slots
    slot_prompt = [deque() for _ in range(slots)]
    outputs: list[list[int]] = [[] for _ in prompts]
    first_logits: list = [None] * len(prompts)
    next_req = 0
    done = 0

    def refill(s):
        nonlocal next_req
        if next_req < len(prompts):
            slot_req[s] = next_req
            slot_prompt[s] = deque(prompts[next_req])
            cur[s, 0] = slot_prompt[s].popleft()
            next_req += 1
        else:
            slot_req[s] = -1

    for s in range(slots):
        refill(s)

    ticks = 0
    t0 = time.perf_counter()
    while done < len(prompts):
        ticks += 1
        batch = {"tokens": torch.from_numpy(cur),
                 "cache_len": torch.from_numpy(cache_len)}
        logits, states, nxt = step(params, states, batch)
        nxt = nxt.cpu().numpy()
        cache_len += 1
        for s in range(slots):
            r = slot_req[s]
            if r < 0:
                # idle slot: its output is discarded; holding it at
                # position 0 keeps it inside the cache and the RoPE table
                cache_len[s] = 0
                continue
            if slot_prompt[s]:                      # still feeding the prompt
                cur[s, 0] = slot_prompt[s].popleft()
                continue
            if not outputs[r]:
                first_logits[r] = logits[s, -1].float().cpu()
            outputs[r].append(int(nxt[s]))
            cur[s, 0] = nxt[s]
            if len(outputs[r]) >= max_new:
                done += 1
                cache_len[s] = 0                    # reset the slot's cache
                if mesh is None:                    # and recurrent state
                    T.reset_slot(states, s)
                else:
                    D.reset_sharded_slot(states, s, mesh, slots)
                refill(s)
    return ServeResult(outputs, first_logits, ticks, time.perf_counter() - t0)


def token_only(cfg: ArchConfig) -> bool:
    return cfg.family != "vlm" and not cfg.n_codebooks


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=list_archs())
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_arch(args.arch).reduced()
    if not token_only(cfg):
        raise SystemExit("demo driver supports token-only archs")
    params = M.init_params(cfg, 0, device=args.device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(3, 8)).tolist()
               for _ in range(args.requests)]
    res = serve(cfg, params, prompts, slots=args.slots, buf=32,
                max_new=args.max_new, device=args.device)
    for r, toks in enumerate(res.outputs):
        print(f"request {r}: prompt={prompts[r]} -> {toks}")
    print(f"served {len(prompts)}/{len(prompts)} requests in {res.ticks} "
          f"decode ticks ({args.slots} slots)")


if __name__ == "__main__":
    main()
