#!/usr/bin/env python3
"""Time the port's attention kernels and its bf16 recurrence kernels (Mamba-2
SSD and WKV6) of one or more checkouts, in turns, on one card.

    python3 tools/attention_ab.py [--only NAME,...] [ROOT ...]

Each ROOT is a checkout of this repository (default: this one). Every root
runs in a subprocess of its own (the checkouts share module names), in the
order given, so ``A B B A`` compares two versions on one card in turns. For
each it times, in bf16, flash attention at olmo-1b's prefill shape (4, 2048,
16 heads of 128, causal) and at zamba2-7b's (4, 2048, 32 heads of 112),
decode attention at olmo-1b's serving shape (4 slots, a buffer of 1024, 16
heads of 128, seeded cache lengths), each beside SDPA on the same inputs,
the decode kernel alone with every slot at a cache length of 1, 128, 512
and 1024, and the SSD scan at zamba2-7b's prefill shape (B=4, S=2048, 112
heads of 64, G=1, N=64) on the model's views (B and C the two halves of one
projection), one CUDA kernel per call, and WKV6 at rwkv6-7b's prefill
shape (B=4, S=2048, 64 heads of 64) on the model's views (r, k and v each
a (B, S, H, K) view of its own projection, fp32 logw), one CUDA kernel per
call. ``--only`` keeps the lines whose names start with one of the given
prefixes (flash, decode, ssd, wkv6). Every time comes from this checkout's
``repro_torch/kernels/timing.py`` ``flushed_ms`` (the kernels' device time
per call from torch.profiler, the L2 cache flushed before each call), the
one timing of the repo, loaded from its file so that each root's
``repro_torch`` is the one imported. Prints one JSON line per root, then
the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


REPO = Path(__file__).resolve().parents[1]


def measure(root: Path, only: list[str]) -> dict:
    import importlib.util
    sys.path[:0] = [str(root / "src")]
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    spec = importlib.util.spec_from_file_location(
        "timing", REPO / "src" / "repro_torch" / "kernels" / "timing.py")
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    flushed_ms = timing.flushed_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = timing.l2_flush_buffer(dev)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def time_ms(fn, iters):
        return flushed_ms(fn, iters, flush)

    def flash():
        for name, h, d in (("flash_olmo-1b", 16, 128),
                           ("flash_zamba2-7b", 32, 112)):
            q, k, v = (randn((4, 2048, h, d)) for _ in range(3))
            qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
            out[name] = {
                "ms": time_ms(lambda: ops.flash_attention(q, k, v), 10),
                "sdpa_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=True), 10)}
            del q, k, v, qh, kh, vh

    def decode():
        q = randn((4, 1, 16, 128))
        kc, vc = randn((4, 1024, 16, 128)), randn((4, 1024, 16, 128))
        lens = torch.randint(1, 1025, (4,), generator=gen, device=dev,
                             dtype=torch.int32)
        qh, kh, vh = q.permute(0, 2, 1, 3), kc.permute(0, 2, 1, 3), \
            vc.permute(0, 2, 1, 3)
        mask = (torch.arange(1024, device=dev)[None, :] < lens[:, None].long()
                )[:, None, None, :]
        out["decode_olmo-1b"] = {
            "cache_len": lens.tolist(),
            "ms": time_ms(lambda: ops.decode_attention(q, kc, vc, lens), 50),
            "sdpa_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask), 50)}
        # the same shape with every slot at one cache length: what a call
        # costs with almost no data (1), within one split (128) and at the
        # full buffer
        out["decode_by_cache_len_ms"] = {
            n: time_ms(lambda: ops.decode_attention(
                q, kc, vc, torch.full((4,), n, dtype=torch.int32,
                                      device=dev)), 50)
            for n in (1, 128, 512, 1024)}

    def ssd():
        b, s, h, p, n = 4, 2048, 112, 64, 64
        x = randn((b, s, h, p)) * 0.5
        dt = F.softplus(torch.randn((b, s, h), generator=gen, device=dev) - 1.0)
        A = -torch.exp(0.3 * torch.randn((h,), generator=gen, device=dev))
        bc = randn((b, s, 2 * n)) * 0.5
        Bm = bc[..., :n].unflatten(-1, (1, n))
        Cm = bc[..., n:].unflatten(-1, (1, n))
        D = torch.ones(h, device=dev)
        out["ssd_zamba2-7b"] = {"ms": flushed_ms(
            lambda: ops.mamba2_ssd(x, dt, A, Bm, Cm, D), 10, flush,
            per_call=1)}

    def wkv6():
        b, s, h, k = 4, 2048, 64, 64
        r, kk, v = (randn((b, s, h * k)).view(b, s, h, k) * 0.5
                    for _ in range(3))
        logw = -torch.exp(-7.0 + 6.3 * torch.rand((b, s, h, k), generator=gen,
                                                  device=dev))
        u = 0.3 * torch.randn((h, k), generator=gen, device=dev)
        out["wkv6_rwkv6-7b"] = {"ms": flushed_ms(
            lambda: ops.wkv6(r, kk, v, logw, u), 10, flush, per_call=1)}

    out = {"root": str(root)}
    for name, fn in (("flash", flash), ("decode", decode), ("ssd", ssd),
                     ("wkv6", wkv6)):
        if not only or any(name.startswith(o) for o in only):
            fn()
    return out


def main() -> int:
    args = sys.argv[1:]
    only = []
    if args[:1] == ["--only"]:
        only, args = args[1].split(","), args[2:]
    if args[:1] == ["--one"]:
        print(json.dumps(measure(Path(args[1]).resolve(), only)), flush=True)
        return 0
    for root in args or [str(REPO)]:
        subprocess.run([sys.executable, __file__, "--only", ",".join(only),
                        "--one", root], check=True, timeout=900)
    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
