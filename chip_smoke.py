#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure raises, and the script then exits non-zero
without printing a result:

1. card: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: nvcc builds every kernel in src/repro_torch/csrc/ into build/;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the shape sets of tests/test_kernels.py and at the serving path's
   shapes, with the tolerances of tests/test_kernels.py; the times of the
   kernel, its plain version and one library call (SDPA, which the port
   never calls) at the serving path's shapes, beside the card's bound;
4. reference: reduced olmo-1b and qwen3-8b on the card (kernels) against the
   CPU (plain versions), fp32, prefill and decode logits;
5. slice: olmo-1b at full width from seeded random weights (bf16 compute):
   the prefill step on 4 prompts of 2048 tokens, then the continuous-
   batching driver serving 8 requests (4 slots, buffer 1024, prompts of
   128-512 tokens, 32 new tokens each), then each request's prompt through
   the prefill step, whose last logits must match the served ones. The
   launch counters are zeroed before this phase and must show 16 flash
   launches per prefill call and 16 decode launches per tick.

The last three lines are the kernel table as JSON, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data sheet: dense bf16 tensor-core rate, fp32 rate outside the
# tensor cores, HBM3 bandwidth (all at the full 700 W power limit)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
TOL = {"bfloat16": (2e-2, 2e-2), "float32": (2e-5, 2e-5)}   # tests/test_kernels.py

FLASH_CASES = [  # (b, s, h, kv, d, causal, dtype)
    *[(*shape, True, dt)
      for shape in [(1, 256, 4, 4, 64), (2, 256, 4, 2, 32), (1, 512, 8, 2, 64),
                    (1, 128, 2, 1, 128)]
      for dt in ("float32", "bfloat16")],
    (1, 256, 2, 2, 64, False, "float32"),
    *[(*shape, causal, "float32")
      for shape in [(1, 192, 2, 2, 80), (2, 320, 4, 2, 96), (1, 100, 2, 1, 64)]
      for causal in (True, False)],
]
DECODE_CASES = [  # (b, s, h, kv, d, dtype)
    *[(*shape, dt) for shape in [(2, 512, 4, 2, 64), (1, 1024, 8, 8, 32)]
      for dt in ("float32", "bfloat16")],
    (3, 300, 4, 2, 128, "float32"),
]
PREFILL_BATCH, PREFILL_LEN = 4, 2048
SLOTS, BUF, REQUESTS, MAX_NEW = 4, 1024, 8, 32
PROMPT_LENS = (128, 512)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as L
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.serve import decode as D

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    # -- 1. card ------------------------------------------------------------
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build(verbose=True)
    log(f"build: {len(logs)} kernel source(s) in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    # -- 3. kernels against their plain versions ----------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB > L2

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def compare(name, got, want, dtype):
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        err = (got - want).abs().max().item()
        rtol, atol = TOL[dtype]
        ok = bool(torch.isfinite(got).all()) and \
            torch.allclose(got, want, rtol=rtol, atol=atol)
        log(f"  {name}: max_abs_err={err:.3e} (rtol=atol={atol}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        return err

    def time_ms(fn, iters):
        """Mean device time of fn's kernels per call, each call after
        flushing the L2 cache (the serving path finds its inputs cold).
        Kernel durations come from the profiler, less the flush's own, so
        the host's time to enqueue a short kernel is not counted."""
        fn()
        torch.cuda.synchronize()
        flushed_us = kernel_us(lambda: (flush.zero_(), fn()), iters)
        return (flushed_us - kernel_us(flush.zero_, iters)) / iters / 1e3

    def bound(flops, nbytes, dtype):
        t_ops = flops / PEAK_FLOPS[dtype]
        t_bytes = nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, \
            "operations" if t_ops >= t_bytes else "bytes"

    def bshd_to_bhsd(*ts):
        return [t.permute(0, 2, 1, 3) for t in ts]

    log("kernels: flash attention against its plain version")
    for b, s, h, kv, d, causal, dt in FLASH_CASES + [
            (PREFILL_BATCH, PREFILL_LEN, 16, 16, 128, True, "bfloat16")]:
        q = randn((b, s, h, d), dtypes[dt])
        k, v = randn((b, s, kv, d), dtypes[dt]), randn((b, s, kv, d), dtypes[dt])
        got = ops.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_plain(*bshd_to_bhsd(q, k, v), causal=causal)
        flash_err = compare(f"b={b} s={s} h={h} kv={kv} d={d} causal={causal} "
                            f"{dt}", got, want.permute(0, 2, 1, 3), dt)
    # the last case is the slice's prefill shape: time it there
    qh, kh, vh = bshd_to_bhsd(q, k, v)
    flash_row = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:31",
        "max_abs_err": flash_err, "tol": TOL["bfloat16"][1],
        "ms": time_ms(lambda: ops.flash_attention(q, k, v), 10),
        "plain_ms": time_ms(lambda: fa.flash_attention_plain(qh, kh, vh), 10),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True), 10),
    }
    # causal: query i sees i + 1 keys; q, k, v read once and o written once
    flash_row["bound_ms"], flash_row["bound_by"] = bound(
        4 * d * b * h * (s * (s + 1) // 2),
        (2 * b * s * h * d + 2 * b * s * kv * d) * q.element_size(), dt)

    log("kernels: decode attention against its plain version")
    for b, s, h, kv, d, dt in DECODE_CASES + [
            (SLOTS, BUF, 16, 16, 128, "bfloat16")]:
        q = randn((b, 1, h, d), dtypes[dt])
        kc, vc = randn((b, s, kv, d), dtypes[dt]), randn((b, s, kv, d), dtypes[dt])
        lens = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                             dtype=torch.int32)
        got = ops.decode_attention(q, kc, vc, lens)
        want = dec.decode_attention_plain(q[:, 0], *bshd_to_bhsd(kc, vc), lens)
        decode_err = compare(f"b={b} s={s} h={h} kv={kv} d={d} {dt} "
                             f"cache_len={lens.tolist()}", got[:, 0], want, dt)
    kh, vh = bshd_to_bhsd(kc, vc)
    qh = q.permute(0, 2, 1, 3)                                  # (B, H, 1, D)
    mask = (torch.arange(s, device=dev)[None, :] < lens[:, None].long()
            )[:, None, None, :]
    valid = int(lens.clamp(max=s).sum())      # cache positions this run reads
    decode_row = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:24",
        "max_abs_err": decode_err, "tol": TOL["bfloat16"][1],
        "ms": time_ms(lambda: ops.decode_attention(q, kc, vc, lens), 50),
        "plain_ms": time_ms(lambda: dec.decode_attention_plain(
            q[:, 0], kh, vh, lens), 50),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask), 50),
    }
    # each valid position's k and v read once per kv head; q, o, cache_len
    decode_row["bound_ms"], decode_row["bound_by"] = bound(
        4 * h * d * valid,
        (2 * valid * kv * d + 2 * q.numel()) * q.element_size()
        + 4 * lens.numel(), dt)
    for row in (flash_row, decode_row):
        log(f"  {row['name']}: {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
            f"ms, SDPA {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f}"
            f" ms ({row['bound_by']}) [{card}]")
    del q, k, v, kc, vc, qh, kh, vh, got, want, flush
    torch.cuda.empty_cache()

    # -- 4. small reference: the card's kernels against the CPU's plain path
    log("reference: reduced configs, card against CPU, fp32")
    for arch in ("olmo-1b", "qwen3-8b"):
        cfg = get_arch(arch).reduced()
        cpu_params = M.init_params(cfg, 0, device="cpu")
        card_params = _to(cpu_params, dev)
        toks = torch.from_numpy(
            np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 37)))
        errs = []
        for params, where in ((cpu_params, torch.device("cpu")),
                              (card_params, dev)):
            pre = D.make_prefill_step(cfg, compute_dtype=torch.float32,
                                      device=where)
            errs.append(pre(params, {"tokens": toks}).cpu())
            step = D.make_serve_step(cfg, 40, compute_dtype=torch.float32,
                                     device=where)
            states = T.init_decode_state(cfg, 2, 40, dtype=torch.float32,
                                         device=where)
            for t in range(6):
                logits, states, _ = step(params, states, {
                    "tokens": toks[:, t:t + 1],
                    "cache_len": torch.full((2,), t, dtype=torch.int32)})
            errs.append(logits.cpu())
        pre_err = (errs[0] - errs[2]).abs().max().item()
        dec_err = (errs[1] - errs[3]).abs().max().item()
        log(f"  {arch}: prefill logits max_abs_err={pre_err:.3e}, decode "
            f"logits max_abs_err={dec_err:.3e} (tol 1e-4)")
        if not max(pre_err, dec_err) <= 1e-4:
            raise AssertionError(f"{arch}: card disagrees with the CPU")

    # -- 5. the slice: olmo-1b at full width --------------------------------
    cfg = get_arch("olmo-1b")
    t0 = time.perf_counter()
    params = M.cast_params(M.init_params(cfg, 0, device=dev), torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"slice: {cfg.name} {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}; weights in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_bhsd.launches = 0
    dec.decode_attention_bhd.launches = 0

    prefill = D.make_prefill_step(cfg)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN)))
    prefill_s = []
    for _ in range(3):                    # the first call warms up
        t0 = time.perf_counter()
        out = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    if out.shape != (PREFILL_BATCH, cfg.vocab_size) or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError(f"prefill gave {tuple(out.shape)} or non-finite")
    counts = (fa.flash_attention_bhsd.launches, dec.decode_attention_bhd.launches)
    if counts != (3 * cfg.n_layers, 0):
        raise AssertionError(f"prefill launches (flash, decode) = {counts}")

    prompts = [rng.integers(0, cfg.vocab_size,
                            rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1)
                            ).tolist() for _ in range(REQUESTS)]
    res = L.serve(cfg, params, prompts, slots=SLOTS, buf=BUF, max_new=MAX_NEW)
    counts = (fa.flash_attention_bhsd.launches, dec.decode_attention_bhd.launches)
    if counts != (3 * cfg.n_layers, res.ticks * cfg.n_layers):
        raise AssertionError(f"serve launches (flash, decode) = {counts}, "
                             f"{res.ticks} ticks")
    if any(len(o) != MAX_NEW or min(o) < 0 or max(o) >= cfg.vocab_size
           for o in res.outputs):
        raise AssertionError("served outputs of the wrong length or range")

    # parity: each prompt's prefill (flash kernel) against the logits the
    # driver produced at the prompt's last token (decode kernel, token by
    # token). Both are bf16 through 16 layers; as in the CPU tests the bound
    # is 5e-2 of the logits' range.
    parity = []
    for r, prompt in enumerate(prompts):
        want = prefill(params, {"tokens": torch.tensor([prompt])})[0].float().cpu()
        got = res.first_logits[r]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"request {r}: non-finite served logits")
        err = (got - want).abs().max().item()
        limit = 5e-2 * want.abs().max().item()
        parity.append((err, limit, int(got.argmax() == want.argmax())))
        if err > limit:
            raise AssertionError(f"request {r}: prefill and serve logits differ "
                                 f"by {err:.3e} > {limit:.3e}")
    torch.cuda.synchronize()
    launches = (fa.flash_attention_bhsd.launches,
                dec.decode_attention_bhd.launches)
    if launches != ((3 + REQUESTS) * cfg.n_layers, res.ticks * cfg.n_layers):
        raise AssertionError(f"main path launches (flash, decode) = {launches}")
    flash_row["launches"], decode_row["launches"] = launches

    fed = sum(len(p) + MAX_NEW - 1 for p in prompts)
    slice_numbers = {
        "card": card,
        "prefill_ms": 1e3 * sum(prefill_s[1:]) / len(prefill_s[1:]),
        "prefill_shape": [PREFILL_BATCH, PREFILL_LEN],
        "decode_ticks": res.ticks,
        "ms_per_tick": 1e3 * res.seconds / res.ticks,
        "generated_tokens_per_s": REQUESTS * MAX_NEW / res.seconds,
        "fed_tokens_per_s": fed / res.seconds,
        "serve_s": res.seconds,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "parity_max_abs_err": max(p[0] for p in parity),
        "parity_min_limit": min(p[1] for p in parity),
        "parity_argmax_agree": sum(p[2] for p in parity),
        "launches": {"flash_attention": launches[0],
                     "decode_attention": launches[1]},
    }
    log("slice: " + json.dumps(slice_numbers))
    log("profile: " + json.dumps(profile_ticks(cfg, params, card)))

    keys =("name", "route", "source", "replaces", "launches", "max_abs_err",
            "tol", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in (flash_row, decode_row)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _kernel_rows(prof, calls: int) -> list:
    """(device us, launches, name) per call of each CUDA kernel in a
    profile, largest first. CPU-op rows are left out: their device time is
    their child kernels', which have rows of their own."""
    from torch.autograd import DeviceType
    rows = [(e.self_device_time_total / calls, e.count / calls, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sorted(rows, reverse=True)


def kernel_us(fn, iters: int) -> float:
    """Summed device time (us) of the kernels that iters calls of fn run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(r[0] for r in _kernel_rows(prof, 1))


def profile_ticks(cfg, params, card, ticks: int = 20) -> dict:
    """Where a decode tick's time goes, at the slice's shape (4 slots at
    position 512 of 1024): host wall per tick without the profiler, device
    kernel time per tick and kernels per tick under torch.profiler, and the
    kernels that take the most device time. Runs after the launch counts
    are read; it gates nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as T
    from repro_torch.serve import decode as D

    step = D.make_serve_step(cfg, BUF)
    states = T.init_decode_state(cfg, SLOTS, BUF,
                                 device=params["embed"].device)
    batch = {"tokens": torch.zeros((SLOTS, 1), dtype=torch.long),
             "cache_len": torch.full((SLOTS,), BUF // 2, dtype=torch.int32)}

    def run():
        for _ in range(ticks):
            _, _, nxt = step(params, states, batch)
            nxt.cpu()                      # the driver reads every tick

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    wall_ms = 1e3 * (time.perf_counter() - t0) / ticks
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    rows = _kernel_rows(prof, ticks)
    device_ms = sum(r[0] for r in rows) / 1e3
    return {
        "card": card, "ticks": ticks, "wall_ms_per_tick": wall_ms,
        "device_ms_per_tick": device_ms if rows else "not measured",
        "device_busy_share": device_ms / wall_ms if rows else "not measured",
        "kernels_per_tick": sum(r[1] for r in rows),
        "top": [{"kernel": k[:60], "us_per_tick": us, "per_tick": n}
                for us, n, k in rows[:8]],
    }


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


if __name__ == "__main__":
    sys.exit(main())
