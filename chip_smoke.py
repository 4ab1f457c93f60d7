#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order (each logged with the script's elapsed seconds); any
failure raises, and the script then exits non-zero without printing a
result (the VLM and audio families' model paths run in
chip_smoke_media.py, beside this script; their kernels are checked at
their shapes here, in phase 3):

1. card: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: nvcc builds every kernel in src/repro_torch/csrc/ into build/,
   one process per source, all started together;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the shape sets of tests/test_kernels.py and at the serving paths'
   shapes, with the tolerances of tests/test_kernels.py; the bf16 flash
   kernel also at ragged S, head dims 16, 80 and 112, GQA 4:1, non-causal
   and on views of one fused (B, S, 3, H, D) buffer, and decode attention
   at cache_len 1, 0 and the whole buffer; WKV6 and SSD also at strong
   decays against the sequential oracles of kernels/ref.py (each in fp32,
   which takes its scalar kernel, and in bf16, which takes its chunked
   tensor-core kernel; flash and decode attention also at llama4-scout's
   GQA of 40 query heads on 8 kv heads, head dim 128, in fp32 and bf16,
   flash also at its 4x2048 prefill shape; flash at musicgen-large's
   4x2048 prefill shape (32 heads on 32 of 64) in fp32 and bf16 and at
   llama-3.2-vision-11b's (32 on 8 of 128), decode attention at their
   serving shapes;
   bf16 SSD also at S of 1, 63, 64, 65 and 601, P of
   16, 32 and 128, N of 8 and 64, two groups; bf16 WKV6 also at S of 1, 63,
   64, 65 and 601 and K of 16, 32 and 64 on strided views of one
   projection, and a misaligned view must raise); that one decode attention
   call, one bf16 SSD call and one bf16 WKV6 call each run one CUDA kernel;
   the times of each
   kernel, its plain version and, where one PyTorch call computes the same
   function (SDPA for the attention kernels, which the port never calls;
   none for WKV6 or SSD), that call, at the serving paths' shapes (flash
   also at zamba2-7b's, llama4-scout's, musicgen-large's and
   llama-3.2-vision-11b's prefill shapes), beside the card's bound (the
   bounds' arithmetic is the autotuner's ``KernelSpec.cost``); then the
   autotuner's knobs (5–20 s): each bf16 chunked WKV6 and SSD
   instance's registers, spills, shared memory and CTAs per SM; every rung
   of each kernel's knob (flash's ``group``, decode's ``split``, WKV6's
   ``value_tile``, SSD's ``state_tile``) at its first serving shape, timed
   as the tuner times a candidate and held against the fp32 plain version
   within tests/test_kernels.py's bf16 tolerance, flash's every group
   bit-equal to its default; then
   ``autotune_all`` at ``SERVING_SHAPES`` (core/provision/autotune.py),
   the cache written to build/autotune_cache.json, one ``autotune:`` JSON
   line an entry (default and tuned config and us, speedup, roofline
   ceiling and fraction, max_err against tol, candidates, the card). The
   step's launches are taken off the counters again: the kernel table's
   launches are the main paths' alone;
4. reference: reduced olmo-1b, qwen3-8b, rwkv6-7b, zamba2-7b, olmoe-1b-7b
   and llama4-scout on the card (kernels) against the CPU (plain versions),
   fp32, prefill and decode logits; then olmo-1b, rwkv6-7b, zamba2-7b and
   olmoe-1b-7b at full width but reduced depth, fp32, prefill (the prefill
   kernels) against serving (the decode path) on the card, within 1e-3 of
   the logits' range (olmoe at the no-drop capacity, see no_drop);
5. slices, one per model at full width from seeded random weights (bf16
   compute), freed before the next: olmo-1b (flash and decode attention),
   rwkv6-7b (WKV6), zamba2-7b (Mamba-2 SSD, and flash and decode attention
   at head dim 112 in the shared block), olmoe-1b-7b (64 experts, top-8,
   all 16 layers; flash and decode attention) and llama4-scout at 2 of its
   48 layers (16 experts, top-1 and a shared expert; flash and decode
   attention at GQA 40:8). Each runs the prefill step on 4
   prompts of 2048 tokens (three calls, the first a warm-up), then the
   continuous-batching driver serving 8 requests (4 slots), then each
   request's prompt through the prefill step, whose last logits must match
   the served ones within 5e-2 of their range, or within twice the model's
   own bf16 rounding error where that is larger (see check_parity); an MoE
   model's per-request prefills and the gate's fp32 prefills run at the
   no-drop capacity, since a prefill at the real capacity drops choices
   that serving keeps, while its timed prefills and serving run the real
   config. The launch counters are
   zeroed before each slice and must show each kernel of the model launched
   once per layer that runs it, per prefill call or per decode tick, and
   the other kernels not at all. A profiled window of decode ticks follows,
   and for an MoE model a profiled prefill call; both report the MoE
   blocks' device ms, split into the expert products (``aten::bmm``) and
   the rest of the block.
6. train (the dense training path, fp32 params, AdamW; it runs no kernel,
   since no kernel has a backward): olmo-1b at full width and 2 layers,
   fp32, one train step on the card against the same step on the CPU at
   2x256 (full attention) and 1x1536 (chunked attention); olmo-1b and
   qwen3-8b at full width and 2 layers on the card, remat none, full and
   dots giving equal gradients, and the chunked attention's gradients
   against the full attention's at S = 1536; then olmo-1b at full width
   and depth, bf16 compute, remat "full", 4x2048 tokens of the synthetic
   pipeline: 6 steps (the first a warm-up), one step with 2 microbatches
   and one profiled step, with the launch counters at 0 throughout. It
   prints ms per step, tokens/s, peak memory and train_mfu, and the
   profiled step broken down into matmuls, attention einsums and the rest.
   Then the other families (the recurrent ones' train mode runs the
   differentiable scans ``wkv6_chunked`` and ``ssd_chunked``, the MoE's its
   plain block; no kernel), their zero-init leaves seeded: rwkv6-7b at full
   width and 1 layer, zamba2-7b at full width and 7 layers (one period and
   one trailing layer) and olmoe-1b-7b at full width and 1 layer, fp32,
   one train step on the card against the CPU at 2x200 (2x256 for olmoe,
   where choices drop at capacity, aux included), and remat none, full and
   dots giving equal gradients on the card at 1x1536; then rwkv6-7b at 8
   of its 32 layers, zamba2-7b at 21 of its 81 (3 periods and 3 trailing
   layers) and olmoe-1b-7b at 6 of its 16, each at full width, bf16
   compute, remat "full", 4x2048 tokens: 6 steps (the first a warm-up) and
   one profiled step, freed before the next, with the launch counters at
   0. Each prints a ``train:`` line like olmo-1b's (olmoe's model FLOPs
   count the active experts only), its profiled step split into
   ``aten::mm``, the scan (the ops under the scan's record_function, its
   forward and remat recompute, and the backward nodes of those ops),
   ``aten::bmm`` (for olmoe the expert products) and the rest.
7. checkpoints (ACAI's training jobs must survive preemption; no kernel
   launches): olmo-1b as in the train phase at 8 of its 16 layers (the
   script's time limit), under ``TrainSupervisor`` saving a 7.7 GB
   checkpoint (fp32 params, AdamW's mu and nu) to a data lake under build/
   every 2 steps, with a failure injected once at step 3: steps 0 and 1, a
   save at 2, step 2, the failure, a restore of step 2, steps 2 and 3
   again, a save at 4. It raises with less than 18 GB free there, and
   deletes the lake at the end. Gates: the report (1 restart, 2
   checkpoints, 5 steps run, final step 4), the lake's latest step and its
   two checkpoint entries with finite losses, the latest checkpoint
   restored into a fresh template on the card bit-equal to the live state,
   step 2's loss after the restore within 1e-6 relative of its loss before,
   and the launch counters at 0. It prints a ``checkpoint:`` line with the
   time and rate of each save and restore, ms per step, peak device memory
   and peak host RSS.
8. the platform (the paper's workflow as jobs through the port's
   ``AcaiPlatform`` with ``runner="thread"`` and one worker, so that jobs
   run one at a time on an engine thread), at olmo-1b's full width and
   depth in a data lake under build/ that it deletes at the end (it raises
   with less than 12 GB free there), as one pipeline: a data job that
   uploads the data description and makes fileset ``TrainData``; two
   training jobs after it (lr 3e-3 and 1e-4, 8 steps each as in the train
   phase), each saving its params
   (4.7 GB) with its job's provenance and printing its final loss as
   ``[[acai:final_loss=...]]``; then an eval job after both, which
   restores the run the metadata's ``find_min("final_loss")`` names, casts
   it to bf16, prefills each of phase 5's 8 olmo-1b requests (flash
   attention) and serves them (decode attention), printing its tokens/s.
   Gates: all four jobs FINISHED and one at a time; ``find_min`` names the
   job with the smaller final loss; both checkpoints lead back to
   ``TrainData:1``; the restored params' SHA-256 equals the saved ones';
   each train job's engine runtime at least the sum of its synchronized
   steps (a consistency check: a train job syncs after each step and its
   save copies to the host, so it leaves no work queued, and this gate
   would hold without the runner's wait for the card; the evidence for
   that wait is ``tests/test_torch_card.py::
   test_thread_runner_runtime_covers_queued_device_work``), and no kernel
   launched by them or the data job; the eval job's
   launches exactly 16 flash per prefill call and 16 decode per tick;
   device memory after
   each job (at its terminal event, after the runner's commit) within
   0.5 GB of its value when the job started. It prints an ``engine:`` line
   with each job's state, engine runtime beside its own step or serve
   time, save and restore seconds, device memory before, at peak and
   after, launches, and the eval job's tokens/s. The eval job's launches
   count in the kernel table's main-path launches.
9. durable (the control plane's journal, crash recovery and the subprocess
   runner, whose detached worker process runs the jobs and outlives the
   engine): ``AcaiPlatform(root, runner="subprocess", durable=True)`` over
   a root under build/ that it deletes at the end, with the jobs of
   ``repro_torch/examples/card_jobs.py`` (a job that crosses the process
   boundary must be importable). A probe job starts the worker, initialises
   CUDA there and finds the kernel libraries of phase 2 built. Then four
   steps:
   (1) two olmo-1b training jobs at full width and 4 of 16 layers (lr 3e-3
   and 1e-4, 6 steps of 4x2048, each printing ``[[acai:final_loss=...]]``)
   and a serve job (olmo-1b in bf16 at full width and depth, 4 of phase 5's
   requests) go in at once and run on three threads and three streams of
   the worker. Gates: all FINISHED; their runs overlap; three streams, none
   the default stream; each log holds only its own lines; ``find_min``
   names the train job with the smaller final loss; each train job's
   runtime at least the sum of its synchronized steps; the serve job's own
   launch counters exactly 16 flash launches per prefill call and 16
   decode launches per tick (they count in the kernel table's main-path
   launches). (2) A 12-step training job writes a progress file after each
   step; after step 2 the engine dies (store closed, socket dropped, no
   shutdown), and a new platform over the root recovers it: adopted 1,
   requeued 0; the job settles once, at epoch 0, and its marker file has
   one line. (3) The same job again; after step 2 the worker (the pid in
   ``worker.json``) is killed with SIGKILL and the engine dies. Gates:
   within 10 s the card's ``memory.used`` is back within 0.5 GB of its
   value before the phase (nvidia-smi's per-process list does not name
   the worker's pid on the card's machine; this process holds still
   through the phase, so the card's memory above that value is the
   worker's); a new platform recovers with requeued 1 and a new worker
   runs epoch 1 to FINISHED; the re-run's first loss equals the first
   loss of (2)'s run within 1e-6 relative. (4) Shutdown: every worker pid exits within 30 s,
   and the card's ``memory.used`` is back within 0.5 GB of its value
   before the phase. It prints a ``durable:`` JSON line: the worker's
   spawn-to-ready seconds, each job's engine runtime beside its own
   synchronized time, each recovery's seconds and report, the time from
   the SIGKILL to the card freeing the worker's memory, and the worker's
   memory (the card's ``memory.used`` above its value before the phase)
   once CUDA is ready, at its peak, between jobs and before the
   shutdown.

The last three lines are the kernel table as JSON, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import re
import subprocess
import sys
import threading
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the kernels' device time (the kernel table's, tools/attention_ab.py's and
# the autotuner's); kernel_rows also splits the profiles of ticks and steps,
# and tests/test_torch_timing.py reads launches_of here
from repro_torch.kernels.timing import (  # noqa: E402
    flushed_ms, kernel_count, kernel_rows as _kernel_rows, launches_of,
    l2_flush_buffer)

# H100 SXM data sheet: dense bf16 tensor-core rate, fp32 rate outside the
# tensor cores, HBM3 bandwidth (all at the full 700 W power limit)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
TOL = {"bfloat16": (2e-2, 2e-2), "float32": (2e-5, 2e-5)}   # tests/test_kernels.py
# tests/test_kernels.py's fp32 tolerances for the recurrences
TOL_WKV6 = {"bfloat16": (2e-2, 2e-2), "float32": (2e-4, 2e-4)}
TOL_SSD = {"bfloat16": (2e-2, 2e-2), "float32": (5e-4, 5e-4)}

PREFILL_BATCH, PREFILL_LEN = 4, 2048
FLASH_CASES = [  # (b, s, h, kv, d, causal, dtype)
    *[(*shape, True, dt)
      for shape in [(1, 256, 4, 4, 64), (2, 256, 4, 2, 32), (1, 512, 8, 2, 64),
                    (1, 128, 2, 1, 128)]
      for dt in ("float32", "bfloat16")],
    (1, 256, 2, 2, 64, False, "float32"),
    *[(*shape, causal, "float32")
      for shape in [(1, 192, 2, 2, 80), (2, 320, 4, 2, 96), (1, 100, 2, 1, 64)]
      for causal in (True, False)],
    # the bf16 kernel's edges: ragged S, head dims 16, 80 and 112 below its
    # 64/112/128 tile widths, GQA 4:1, causal and not
    *[(*shape, causal, "bfloat16")
      for shape in [(1, 100, 2, 1, 64), (2, 601, 8, 2, 80), (1, 601, 4, 1, 16),
                    (2, 300, 8, 2, 112)]
      for causal in (True, False)],
    # zamba2-7b's shared attention block: head dim 112, and its prefill shape
    (2, 200, 4, 4, 112, True, "float32"), (1, 256, 4, 4, 112, True, "bfloat16"),
    (4, 2048, 32, 32, 112, True, "bfloat16"),
    # llama4-scout's GQA: 40 query heads on 8 kv heads (5:1), head dim 128,
    # and its prefill shape
    (1, 256, 40, 8, 128, True, "float32"),
    (PREFILL_BATCH, PREFILL_LEN, 40, 8, 128, True, "bfloat16"),
    # musicgen-large's prefill shape (32 heads on 32 of 64: the bf16
    # kernel's 64-wide tile) in both dtypes; llama-3.2-vision-11b's (32 on
    # 8 of 128)
    *[(PREFILL_BATCH, PREFILL_LEN, 32, 32, 64, True, dt)
      for dt in ("float32", "bfloat16")],
    (PREFILL_BATCH, PREFILL_LEN, 32, 8, 128, True, "bfloat16"),
]
DECODE_CASES = [  # (b, s, h, kv, d, dtype), seeded random cache_len
    *[(*shape, dt) for shape in [(2, 512, 4, 2, 64), (1, 1024, 8, 8, 32)]
      for dt in ("float32", "bfloat16")],
    (3, 300, 4, 2, 128, "float32"),
    (2, 300, 4, 4, 112, "float32"), (4, 512, 32, 32, 112, "bfloat16"),
    # llama4-scout's GQA 40:8 at head dim 128
    (2, 300, 40, 8, 128, "float32"), (4, 256, 40, 8, 128, "bfloat16"),
    # musicgen-large's serving shape (32 heads on 32 of 64, a buffer of
    # 256 + 32) in both dtypes; llama-3.2-vision-11b's (32 on 8 of 128)
    *[(4, 288, 32, 32, 64, dt) for dt in ("float32", "bfloat16")],
    (4, 288, 32, 8, 128, "bfloat16"),
]
# cache_len 1, the whole buffer, 0 (zeros) and s // 2 + 3; GQA 4:1, D = 112
DECODE_EDGE_CASES = [(*shape, dt) for shape in [
    (4, 1024, 16, 16, 128), (3, 512, 8, 2, 128), (3, 300, 16, 4, 112)]
    for dt in ("float32", "bfloat16")]
WKV6_CASES = [  # (b, s, h, k, dtype of r, k, v); logw and u are fp32
    (b, s, h, k, dt) for b, s, h, k in [(1, 128, 2, 32), (2, 256, 4, 64),
                                        (1, 64, 1, 16), (1, 601, 2, 64)]
    for dt in ("float32", "bfloat16")]
# the bf16 chunked kernel's edges, on strided views of one projection: S
# around its 64-token chunk and a ragged tail, K below and at its tile
WKV6_EDGE_CASES = [(2, s, 4, k) for s in (1, 63, 64, 65, 601)
                   for k in (16, 32, 64)]
SSD_CASES = [  # (b, s, h, p, g, n, dtype of x, B, C); dt, A and D are fp32
    *[(*shape, dt) for shape in [(1, 128, 2, 32, 1, 16), (2, 256, 4, 64, 2, 32),
                                 (1, 64, 2, 16, 1, 8), (1, 601, 4, 64, 1, 64)]
      for dt in ("float32", "bfloat16")],
    # the bf16 chunked kernel's edges: S around its 64-token chunk and a
    # ragged tail, P below, at and above its 64-column tile, N of 8 and 64
    *[(2, s, 4, p, 2, n, "bfloat16") for s in (1, 63, 64, 65, 601)
      for p, n in ((16, 8), (32, 64), (128, 64), (128, 8))],
]
# the full-width train phase: olmo-1b, 4x2048 tokens a step, timed steps
TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS = 4, 2048, 6
# the families trained at full width and reduced depth: layers of the timed
# run (fp32 params, grads and AdamW moments take 16 bytes a param: 36.7,
# 29.4 and 43.6 GB), layers and sequence length of the fp32 parity step
# (batch 2), its gradient gate (of each leaf's largest entry), and the
# scan's record_function (None: no scan); the train steps' peak may not
# pass TRAIN_PEAK_BYTES (zamba2-7b at 27 layers, 35.7 GB, peaked at
# 73.9 GB on an H100: its shared block's sites keep their activations
# outside remat)
TRAIN_FAMILIES = {"rwkv6-7b": (8, 1, 200, 2e-4, "wkv6_chunked"),
                  "zamba2-7b": (21, 7, 200, 1e-4, "ssd_chunked"),
                  "olmoe-1b-7b": (6, 1, 256, 1e-4, None)}
TRAIN_PEAK_BYTES = 70e9
# the checkpoint phase: olmo-1b's layers (8 of 16: at 16 the phase took
# 2.2-2.4 minutes on an H100), supervised steps, a save every 2, a
# failure at step 3; the lake needs two checkpoints of 7.7 GB and room
CKPT_LAYERS, CKPT_STEPS, CKPT_SAVE_EVERY, CKPT_FAIL_AT = 8, 4, 2, 3
CKPT_MIN_FREE = 18e9
# the platform phase: two training jobs (one per learning rate) of this
# many steps, the free disk it needs under build/ (two 4.7 GB saves), and
# how far device memory may stay above its value before a job
PLATFORM_LRS, PLATFORM_STEPS, PLATFORM_MIN_FREE = (3e-3, 1e-4), 8, 12e9
MEMORY_RETURN_BYTES = 0.5e9
# the durable phase: olmo-1b's layers in its training jobs, the steps of the
# two overlapping jobs and of the job that outlives its engine and worker,
# and the number of phase 5's olmo-1b requests its serve job serves
DURABLE_LAYERS, DURABLE_STEPS, DURABLE_RECOVER_STEPS = 4, 6, 12
DURABLE_REQUESTS = 4
# per model: slots, cache buffer, requests, new tokens each, prompt lengths;
# SLICE_LAYERS cuts a model's depth (llama4-scout's 48 layers take 215 GB
# in bf16; 2 layers, 6.47 B params, take 12.9 GB)
SLICES = {"olmo-1b": (4, 1024, 8, 32, (128, 512)),
          "rwkv6-7b": (4, 512, 8, 16, (64, 256)),
          "zamba2-7b": (4, 512, 8, 16, (64, 256)),
          "olmoe-1b-7b": (4, 1024, 8, 32, (128, 512)),
          "llama4-scout-17b-a16e": (4, 256, 4, 16, (64, 128))}
SLICE_LAYERS = {"llama4-scout-17b-a16e": 2}


T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str) -> None:
    """Mark a phase's start with the script's elapsed seconds."""
    log(f"== {name} at {time.perf_counter() - T0:.1f} s")


def no_drop(cfg):
    """An MoE config at capacity_factor E / k, where capacity is the call's
    T tokens and no choice drops; other configs as they are. A prefill of
    S tokens at the real capacity (1.25 k S / E slots an expert) drops
    choices that serving, 4 tokens a tick at capacity 4, keeps, so the two
    compute the same function only at this capacity (tests/test_torch_moe.py
    holds both)."""
    if cfg.moe is None:
        return cfg
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))


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
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs.base import get_arch
    from repro_torch.core.provision import autotune as AT
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import wkv6 as wkv
    from repro_torch.launch import serve as L
    from repro_torch.models import model as M
    from repro_torch.serve import decode as D

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    # -- 1. card ------------------------------------------------------------
    phase("1. card")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    # -- 2. build -----------------------------------------------------------
    phase("2. build")
    t0 = time.perf_counter()
    logs = _build.build(verbose=True)
    log(f"build: {len(logs)} kernel source(s) in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        entry = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:   # the kernel and its template
                found = re.search(r"([A-Za-z_]+_kernel)(I\w+?E)?E", line)
                entry = found.group(1) + (found.group(2) or "") if found else ""
            elif "registers" in line or "spill" in line or "error" in line:
                log(f"  {name} {entry}: {line.strip()}")

    # -- 3. kernels against their plain versions ----------------------------
    phase("3. kernels")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = l2_flush_buffer(dev)

    def time_ms(fn, iters, per_call=None):
        return flushed_ms(fn, iters, flush, per_call)

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    def compare(name, got, want, dtype, tol=TOL):
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        err = (got - want).abs().max().item()
        rtol, atol = tol[dtype]
        ok = bool(torch.isfinite(got).all()) and \
            torch.allclose(got, want, rtol=rtol, atol=atol)
        log(f"  {name}: max_abs_err={err:.3e} (rtol=atol={atol}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        return err

    def bound(flops, nbytes, dtype):
        t_ops = flops / PEAK_FLOPS[dtype]
        t_bytes = nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, \
            "operations" if t_ops >= t_bytes else "bytes"

    dtype_name = {v: k for k, v in dtypes.items()}

    def bshd_to_bhsd(*ts):
        return [t.permute(0, 2, 1, 3) for t in ts]

    def flash_times(q, k, v):
        """The kernel, its plain version and SDPA on (B, S, H, D) inputs,
        causal, beside the bound: query i sees i + 1 keys; q, k, v read
        once and o written once."""
        (b, s, h, d), kv = q.shape, k.shape[2]
        qh, kh, vh = bshd_to_bhsd(q, k, v)
        row = {
            "ms": time_ms(lambda: ops.flash_attention(q, k, v), 10),
            "plain_ms": time_ms(lambda: fa.flash_attention_plain(qh, kh, vh),
                                10),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=h != kv), 10),
        }
        row["bound_ms"], row["bound_by"] = bound(
            *AT.KERNELS["flash_attention"].cost(
                {"b": b, "s": s, "h": h, "kv": kv, "d": d,
                 "dtype": dtype_name[q.dtype]}), "bfloat16")
        return row

    log("kernels: flash attention against its plain version")
    for b, s, h, kv, d, causal, dt in FLASH_CASES + [
            (PREFILL_BATCH, PREFILL_LEN, 16, 16, 128, True, "bfloat16")]:
        q = randn((b, s, h, d), dtypes[dt])
        k, v = randn((b, s, kv, d), dtypes[dt]), randn((b, s, kv, d), dtypes[dt])
        got = ops.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_plain(*bshd_to_bhsd(q, k, v), causal=causal)
        flash_err = compare(f"b={b} s={s} h={h} kv={kv} d={d} causal={causal} "
                            f"{dt}", got, want.permute(0, 2, 1, 3), dt)
        if (b, s, h, d) == (PREFILL_BATCH, PREFILL_LEN, 32, 112):
            zamba_flash = flash_times(q, k, v)        # zamba2-7b's prefill shape
        if (b, s, h, kv) == (PREFILL_BATCH, PREFILL_LEN, 40, 8):
            llama4_flash = flash_times(q, k, v)    # llama4-scout's prefill shape
        if (b, s, h, d, dt) == (PREFILL_BATCH, PREFILL_LEN, 32, 64,
                                "bfloat16"):
            musicgen_flash = flash_times(q, k, v)  # musicgen-large's
        if (b, s, h, kv) == (PREFILL_BATCH, PREFILL_LEN, 32, 8):
            vision_flash = flash_times(q, k, v)    # llama-3.2-vision-11b's
        del got, want
    for causal in (True, False):      # views of one (B, S, 3, H, D) buffer
        fused = randn((2, 300, 3, 4, 64), torch.bfloat16).unbind(2)
        want = fa.flash_attention_plain(
            *bshd_to_bhsd(*(t.contiguous() for t in fused)), causal=causal)
        compare(f"fused (B, S, 3, H, D) views b=2 s=300 h=4 d=64 "
                f"causal={causal} bfloat16",
                ops.flash_attention(*fused, causal=causal),
                want.permute(0, 2, 1, 3), "bfloat16")
    # the last case is olmo-1b's prefill shape: time it there
    flash_row = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:31",
        "max_abs_err": flash_err, "tol": TOL["bfloat16"][1],
        **flash_times(q, k, v),
        "at_zamba2_7b": {"shape": [PREFILL_BATCH, PREFILL_LEN, 32, 32, 112],
                         **zamba_flash},
        "at_llama4_scout": {"shape": [PREFILL_BATCH, PREFILL_LEN, 40, 8, 128],
                            **llama4_flash},
        "at_musicgen_large": {"shape": [PREFILL_BATCH, PREFILL_LEN, 32, 32,
                                        64], **musicgen_flash},
        "at_llama_3_2_vision_11b": {
            "shape": [PREFILL_BATCH, PREFILL_LEN, 32, 8, 128], **vision_flash},
    }

    log("kernels: decode attention against its plain version")
    for b, s, h, kv, d, dt in DECODE_EDGE_CASES:
        q = randn((b, 1, h, d), dtypes[dt])
        kc, vc = randn((b, s, kv, d), dtypes[dt]), randn((b, s, kv, d), dtypes[dt])
        lens = torch.tensor([1, s, 0, s // 2 + 3][:b], dtype=torch.int32,
                            device=dev)
        compare(f"b={b} s={s} h={h} kv={kv} d={d} {dt} "
                f"cache_len={lens.tolist()}",
                ops.decode_attention(q, kc, vc, lens)[:, 0],
                dec.decode_attention_plain(q[:, 0], *bshd_to_bhsd(kc, vc),
                                           lens), dt)
    for b, s, h, kv, d, dt in DECODE_CASES + [
            (*SLICES["olmo-1b"][:2], 16, 16, 128, "bfloat16")]:
        q = randn((b, 1, h, d), dtypes[dt])
        kc, vc = randn((b, s, kv, d), dtypes[dt]), randn((b, s, kv, d), dtypes[dt])
        lens = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                             dtype=torch.int32)
        got = ops.decode_attention(q, kc, vc, lens)
        want = dec.decode_attention_plain(q[:, 0], *bshd_to_bhsd(kc, vc), lens)
        decode_err = compare(f"b={b} s={s} h={h} kv={kv} d={d} {dt} "
                             f"cache_len={lens.tolist()}", got[:, 0], want, dt)
    # the last case is olmo-1b's serving shape: one call is one kernel
    if kernel_count(lambda: ops.decode_attention(q, kc, vc, lens)) != 1:
        raise AssertionError("a decode attention call ran more than one "
                             "CUDA kernel")
    log("  one decode attention call: one CUDA kernel (profiler)")
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
    decode_row["bound_ms"], decode_row["bound_by"] = bound(
        *AT.KERNELS["decode_attention"].cost(
            {"b": b, "s": s, "h": h, "kv": kv, "d": d, "dtype": dt},
            valid=valid), dt)
    del q, k, v, kc, vc, qh, kh, vh, got, want

    def wkv6_inputs(b, s, h, k, dt, logw_lo=-7.0, logw_hi=-0.7, views=False):
        """tests/test_kernels.py's draws: r, k, v ~ 0.5 N(0, 1), logw =
        -exp(U(lo, hi)), u ~ 0.3 N(0, 1); logw and u fp32, as in the model.
        With ``views``, r, k and v are (B, S, H, K) views of one wider
        projection and logw a view of a wider buffer."""
        if views:
            wide = randn((b, s, 3 * h * k + 64), dtypes[dt], 0.5)
            r, kk, v = (wide[..., i * h * k:(i + 1) * h * k].unflatten(
                -1, (h, k)) for i in range(3))
            logw = -torch.exp(uniform((b, s, h * k + 8), logw_lo, logw_hi))
            logw = logw[..., :h * k].unflatten(-1, (h, k))
        else:
            r, kk, v = (randn((b, s, h, k), dtypes[dt], 0.5) for _ in range(3))
            logw = -torch.exp(uniform((b, s, h, k), logw_lo, logw_hi))
        return r, kk, v, logw, randn((h, k), torch.float32, 0.3)

    def bhsk(*ts):
        return [t.permute(0, 2, 1, 3) for t in ts]

    def wkv6_plain_bshk(r, kk, v, logw, u):
        return wkv.wkv6_plain(*bhsk(r, kk, v, logw), u).permute(0, 2, 1, 3)

    log("kernels: WKV6 against its plain version")
    rwkv = get_arch("rwkv6-7b")
    wkv_shape = (PREFILL_BATCH, PREFILL_LEN, rwkv.n_heads, rwkv.rwkv.head_dim)
    for b, s, h, k in WKV6_EDGE_CASES:
        args = wkv6_inputs(b, s, h, k, "bfloat16", views=True)
        compare(f"views b={b} s={s} h={h} k={k} bfloat16", ops.wkv6(*args),
                wkv6_plain_bshk(*args), "bfloat16", TOL_WKV6)
    args = wkv6_inputs(1, 64, 2, 64, "bfloat16")
    shifted = torch.zeros((1, 64, 2, 72), dtype=torch.bfloat16,
                          device=dev)[..., 1:65]      # base 2 bytes off 16
    try:
        ops.wkv6(shifted, *args[1:])
    except ValueError as err:
        log(f"  a misaligned bf16 view raises: {err}")
    else:
        raise AssertionError("the bf16 WKV6 kernel took a misaligned view")
    for b, s, h, k, dt in WKV6_CASES + [(*wkv_shape, "bfloat16")]:
        r, kk, v, logw, u = wkv6_inputs(b, s, h, k, dt)
        got = ops.wkv6(r, kk, v, logw, u)
        wkv_err = compare(f"b={b} s={s} h={h} k={k} {dt}", got,
                          wkv6_plain_bshk(r, kk, v, logw, u), dt, TOL_WKV6)
        del got
    rh, kh, vh, wh = bhsk(r, kk, v, logw)
    wkv_row = {
        "name": "wkv6", "route": "cuda", "source": "src/repro_torch/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/rwkv6.py:24",
        "max_abs_err": wkv_err, "tol": TOL_WKV6["bfloat16"][1],
        "ms": time_ms(lambda: ops.wkv6(r, kk, v, logw, u), 10, per_call=1),
        "plain_ms": time_ms(lambda: wkv.wkv6_plain(rh, kh, vh, wh, u), 3),
        "library_ms": None,     # no single PyTorch call computes WKV6
    }
    log("  one bf16 WKV6 call: one CUDA kernel (profiler, in its timing)")
    wkv_row["bound_ms"], wkv_row["bound_by"] = bound(
        *AT.KERNELS["rwkv6"].cost(
            {"b": b, "s": s, "h": h, "k": k, "dtype": dt}), dt)
    for dt in ("float32", "bfloat16"):       # the scalar and chunked kernels
        r, kk, v, logw, u = wkv6_inputs(1, 512, 2, 64, dt,
                                        float(np.log(0.3)), float(np.log(3.0)))
        compare(f"strong decay, logw in (-3, -0.3), b=1 s=512 h=2 k=64 {dt}, "
                f"against the sequential wkv6_ref", ops.wkv6(r, kk, v, logw, u),
                ref.wkv6_ref(r, kk, v, logw, u), dt, TOL_WKV6)
    del r, kk, v, logw, u, rh, kh, vh, wh, args, shifted

    def ssd_inputs(b, s, h, p, g, n, dt, strong=False):
        """tests/test_kernels.py's draws (dt = softplus(N(0,1) - 1), A =
        -exp(0.3 N(0,1))), or with ``strong`` dt in (0.1, 0.5) and A in
        (-16, -1), so that dt A reaches -8 per token."""
        x = randn((b, s, h, p), dtypes[dt], 0.5)
        if strong:
            dtv = uniform((b, s, h), 0.1, 0.5)
            A = -uniform((h,), 1.0, 16.0)
        else:
            dtv = F.softplus(randn((b, s, h), torch.float32) - 1.0)
            A = -torch.exp(randn((h,), torch.float32, 0.3))
        Bm = randn((b, s, g, n), dtypes[dt], 0.5)
        Cm = randn((b, s, g, n), dtypes[dt], 0.5)
        return x, dtv, A, Bm, Cm, torch.ones(h, device=dev)

    def ssd_plain_bshd(x, dtv, A, Bm, Cm, Dv):
        return ssd.ssd_plain(x.permute(0, 2, 1, 3), dtv.permute(0, 2, 1), A,
                             Bm.permute(0, 2, 1, 3), Cm.permute(0, 2, 1, 3),
                             Dv).permute(0, 2, 1, 3)

    log("kernels: Mamba-2 SSD against its plain version")
    zamba = get_arch("zamba2-7b")
    mc = zamba.mamba
    ssd_shape = (PREFILL_BATCH, PREFILL_LEN, mc.n_heads(zamba.d_model),
                 mc.head_dim, mc.n_groups, mc.d_state)
    for b, s, h, p, g, n, dt in SSD_CASES + [(*ssd_shape, "bfloat16")]:
        args = ssd_inputs(b, s, h, p, g, n, dt)
        ssd_err = compare(f"b={b} s={s} h={h} p={p} g={g} n={n} {dt}",
                          ops.mamba2_ssd(*args), ssd_plain_bshd(*args), dt,
                          TOL_SSD)
    x, dtv, A, Bm, Cm, Dv = args
    ssd_row = {
        "name": "mamba2_ssd", "route": "cuda",
        "source": "src/repro_torch/csrc/mamba2_ssd.cu",
        "replaces": "src/repro/kernels/mamba2_ssd.py:24",
        "max_abs_err": ssd_err, "tol": TOL_SSD["bfloat16"][1],
        "ms": time_ms(lambda: ops.mamba2_ssd(*args), 10, per_call=1),
        "plain_ms": time_ms(lambda: ssd_plain_bshd(*args), 3),
        "library_ms": None,     # no single PyTorch call computes the SSD scan
    }
    log("  one bf16 SSD call: one CUDA kernel (profiler, in its timing)")
    ssd_row["bound_ms"], ssd_row["bound_by"] = bound(
        *AT.KERNELS["mamba2_ssd"].cost(
            {"b": b, "s": s, "h": h, "p": p, "n": n, "g": g, "dtype": dt}), dt)
    for dt in ("float32", "bfloat16"):       # the scalar and chunked kernels
        args = ssd_inputs(1, 512, 4, 64, 1, 64, dt, strong=True)
        compare(f"strong decay, dt A in (-8, -0.1), b=1 s=512 h=4 p=64 n=64 "
                f"{dt}, against the sequential ssd_ref",
                ops.mamba2_ssd(*args), ref.ssd_ref(*args), dt, TOL_SSD)
    del x, dtv, A, Bm, Cm, Dv, args
    rows = (flash_row, decode_row, wkv_row, ssd_row)
    for name, row in [(r["name"], r) for r in rows] + [
            ("flash_attention at zamba2-7b's shape", zamba_flash),
            ("flash_attention at llama4-scout's shape", llama4_flash),
            ("flash_attention at musicgen-large's shape", musicgen_flash),
            ("flash_attention at llama-3.2-vision-11b's shape",
             vision_flash)]:
        lib = "null" if row["library_ms"] is None \
            else f"{row['library_ms']:.4f} ms"
        log(f"  {name}: {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {lib}, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}) [{card}]")
    del flush
    torch.cuda.empty_cache()
    phase("3. kernels: autotune")
    run_autotune(card, dev)
    free()

    # -- 4. small reference: the card's kernels against the CPU's plain path
    phase("4. reference")
    log("reference: reduced configs, card against CPU, fp32")
    for arch in ("olmo-1b", "qwen3-8b", "rwkv6-7b", "zamba2-7b",
                 "olmoe-1b-7b", "llama4-scout-17b-a16e"):
        check_reduced(get_arch(arch).reduced(), dev)

    log("reference: full width at reduced depth, fp32, prefill against "
        "serving on the card (MoE at the no-drop capacity)")
    for arch, layers in (("olmo-1b", 2), ("rwkv6-7b", 2), ("zamba2-7b", 7),
                         ("olmoe-1b-7b", 2)):
        cfg = no_drop(dataclasses.replace(get_arch(arch), n_layers=layers))
        params = weights(cfg, dev)
        rng = np.random.default_rng(2)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (100, 37)]
        pre = D.make_prefill_step(cfg, compute_dtype=torch.float32)
        served = L.serve(cfg, params, prompts, slots=2, buf=128, max_new=1,
                         compute_dtype=torch.float32).first_logits
        for prompt, got in zip(prompts, served):
            want = pre(params, {"tokens": torch.tensor([prompt])})[0].cpu()
            err = (got - want).abs().max().item()
            limit = 1e-3 * want.abs().max().item()
            log(f"  {arch}, {layers} layers, prompt of {len(prompt)}: "
                f"max_abs_err={err:.3e} (limit {limit:.3e})")
            if not err <= limit:
                raise AssertionError(f"{arch}: fp32 prefill and serving "
                                     f"disagree at full width")
        del params
        free()

    # -- 5. the slices at full width -----------------------------------------
    counters = launch_counters()
    totals = dict.fromkeys(counters, 0)
    for arch, shape in SLICES.items():
        phase(f"5. slice {arch}")
        full = get_arch(arch)
        cfg = dataclasses.replace(full, n_layers=SLICE_LAYERS.get(
            arch, full.n_layers))
        t0 = time.perf_counter()
        params = M.cast_params(weights(cfg, dev), torch.bfloat16)
        free()
        moe = "" if cfg.moe is None else (
            f"; {cfg.moe.n_experts} experts of {cfg.moe.d_ff_expert}, top "
            f"{cfg.moe.top_k}, {cfg.moe.n_shared_experts} shared")
        log(f"slice: {cfg.name} {cfg.n_layers} of {full.n_layers} layers, "
            f"d_model {cfg.d_model}, {cfg.n_heads} heads of "
            f"{cfg.resolved_head_dim} on {cfg.n_kv_heads} kv heads, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}{moe}; weights in "
            f"{time.perf_counter() - t0:.2f} s")
        counts, batches, pre16, served16 = run_slice(cfg, params, card,
                                                     counters, shape)
        for name, n in counts.items():
            totals[name] += n
        del params
        free()
        params = weights(cfg, dev)         # fp32, after the counts are read
        log("parity: " + json.dumps(check_parity(
            no_drop(cfg), params, batches, pre16, served16, card)))
        del params
        free()

    # -- 6. training -----------------------------------------------------------
    phase("6. train")
    check_train_parity(card, dev)
    log("train: " + json.dumps(run_train(card, counters, dev)))
    free()
    check_family_train_parity(card, dev)
    free()
    for arch in TRAIN_FAMILIES:
        log("train: " + json.dumps(run_train_family(card, counters, dev,
                                                    arch)))
        free()

    # -- 7. checkpoints and supervision ----------------------------------------
    phase("7. checkpoints")
    log("checkpoint: " + json.dumps(run_checkpoints(card, counters, dev)))
    free()

    # -- 8. the platform on the card -------------------------------------------
    phase("8. platform")
    engine = run_platform(card, counters, dev)
    for name, n in engine["launches"].items():
        totals[name] += n
    log("engine: " + json.dumps(engine))
    free()

    # -- 9. the durable control plane and the subprocess runner ----------------
    phase("9. durable")
    durable = run_durable(card)
    for name, n in durable["launches"].items():
        totals[name] += n
    log("durable: " + json.dumps(durable))

    for row in rows:
        row["launches"] = totals[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "tol", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    phase("end")
    print(json.dumps({"kernels": [
        {k: row[k] for k in keys + tuple(sorted(set(row) - set(keys)))}
        for row in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_autotune(card, dev) -> None:
    """Phase 3's autotune step (see the module docstring): each bf16
    chunked instance's registers, spills, shared memory and CTAs per SM;
    every rung of each kernel's knob at its first serving shape against
    the fp32 plain version, flash's group bit-equal to its default; then
    ``autotune_all`` at the serving shapes into a cache under build/, one
    ``autotune:`` line an entry. Its launches are put back on the
    counters, so no main-path count holds them."""
    import torch

    from repro_torch.core.provision import autotune as AT
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import wkv6 as wkv
    t0 = time.perf_counter()
    counters = launch_counters()
    before = {name: fn.launches for name, fn in counters.items()}
    for name, info in (("rwkv6 value_tile", wkv.chunk_kernel_info),
                       ("mamba2_ssd state_tile", ssd.chunk_kernel_info)):
        for tile in (32, 64):
            log(f"autotune: {name} {tile}: "
                f"{json.dumps(info(tile, dev))} [{card}]")
    for kernel, shapes in AT.SERVING_SHAPES.items():
        spec, shape = AT.KERNELS[kernel], shapes[0]
        args, want = spec.build(shape, 0, dev)
        (knob, ladder), = AT.ladders_of(spec, shape).items()
        default = AT.seed_config(spec, shape)
        base = spec.call(default, *args)
        measure = AT.default_measure(spec, args, dev)
        for value in ladder:
            got = spec.call({knob: value}, *args)
            torch.cuda.synchronize()
            err = AT.output_err(got, want)
            same = _bits_equal(got, base)
            diff = (got.float() - base.float()).abs().max().item()
            us = measure({knob: value}) * 1e6
            log(f"  {kernel} {AT.shape_key(shape)} {knob}={value}: "
                f"{us:.2f} us, max_err={err:.3e} (tol {spec.tol}), "
                f"bit-equal to {knob}={default[knob]}: {same} (max |diff| "
                f"{diff:.3e})")
            if not err <= spec.tol:
                raise AssertionError(f"{kernel} at {knob}={value} disagrees "
                                     f"with its plain version")
            if kernel == "flash_attention" and not same:
                raise AssertionError(f"flash attention's group {value} "
                                     f"changed the output's bits")
            del got
        del args, want, base, measure
        free()
    cache = AT.TuningCache(str(ROOT / "build" / "autotune_cache.json"))
    for entry in AT.autotune_all(device=dev, shapes=AT.SERVING_SHAPES,
                                 cache=cache):
        log("autotune: " + json.dumps({**entry, "card": card}))
    cache.save()
    launched = {}
    for name, fn in counters.items():
        launched[name] = fn.launches - before[name]
        fn.launches = before[name]
    log(f"autotune: {time.perf_counter() - t0:.1f} s, launches (not the "
        f"main path's) {json.dumps(launched)}; cache {cache.path}")


def launch_counters() -> dict:
    """The kernels' wrappers by name: each counts its launches in
    ``launches``."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import wkv6 as wkv
    return {"flash_attention": fa.flash_attention_bhsd,
            "decode_attention": dec.decode_attention_bhd,
            "wkv6": wkv.wkv6_bhsk, "mamba2_ssd": ssd.ssd_bhsp}


def weights(cfg, dev):
    """fp32 weights from seed 0 on the card (the same values each call);
    RWKV's zero-init leaves and the VLM's gates seeded (_enliven)."""
    import torch

    from repro_torch.models import model as M
    params = M.init_params(cfg, 0, device=dev)
    if cfg.family in ("ssm", "vlm"):
        _enliven(cfg, params, torch.Generator(device=dev).manual_seed(1))
    return params


def free() -> None:
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def check_reduced(cfg, dev) -> None:
    """A reduced config (its zero-init leaves seeded where the card's gates
    need them, see _enliven) on the card (kernels) against the CPU (plain
    versions), fp32: prefill logits on 2 rows of 37 tokens, and decode
    logits after 6 tokens, within 1e-4."""
    import numpy as np
    import torch

    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.serve import decode as D
    cpu_params = M.init_params(cfg, 0, device="cpu")
    if cfg.family == "vlm":        # gates at zero would ignore vision
        _enliven(cfg, cpu_params, torch.Generator().manual_seed(1))
    card_params = _to(cpu_params, dev)
    batch = model_batch(cfg, np.random.default_rng(1), 2, 37)
    toks = batch["tokens"]
    errs = []
    for params, where in ((cpu_params, torch.device("cpu")),
                          (card_params, dev)):
        pre = D.make_prefill_step(cfg, compute_dtype=torch.float32,
                                  device=where)
        errs.append(pre(params, batch).cpu())
        step = D.make_serve_step(cfg, 40, compute_dtype=torch.float32,
                                 device=where)
        states = T.init_decode_state(cfg, 2, 40, dtype=torch.float32,
                                     device=where, vision=batch.get("vision"),
                                     params=params)
        for t in range(6):
            logits, states, _ = step(params, states, {
                "tokens": toks[:, t:t + 1],
                "cache_len": torch.full((2,), t, dtype=torch.int32)})
        errs.append(logits.cpu())
    pre_err = (errs[0] - errs[2]).abs().max().item()
    dec_err = (errs[1] - errs[3]).abs().max().item()
    log(f"  {cfg.name}: prefill logits max_abs_err={pre_err:.3e}, decode "
        f"logits max_abs_err={dec_err:.3e} (tol 1e-4)")
    if not max(pre_err, dec_err) <= 1e-4:
        raise AssertionError(f"{cfg.name}: card disagrees with the CPU")


def _enliven_rwkv(cfg, params, gen) -> None:
    """Give the leaves the reference initialises to zero (bonus u, the
    shift and decay LoRAs' second factors) small seeded values, and the
    decay base RWKV-6's own initial spread over channels n and layers l,
    -6 + 5 (n / (D - 1)) ** (0.7 + 1.3 l / (L - 1)) (l / (L - 1) = 0 for
    one layer), so that u and the data-dependent decay take part in the
    run."""
    import torch
    tm = params["layers"]["tm"]
    for key, scale in (("bonus_u", 0.1), ("shift_lora_b", 0.01),
                       ("decay_lora_b", 0.01)):
        tm[key] = scale * torch.randn(tm[key].shape, generator=gen,
                                      device=gen.device)
    d, n_l = cfg.d_model, cfg.n_layers
    ch = torch.arange(d, device=gen.device) / (d - 1)
    layer = torch.arange(n_l, device=gen.device)[:, None] / max(n_l - 1, 1)
    tm["decay_base"] = -6.0 + 5.0 * ch[None, :] ** (0.7 + 1.3 * layer)


def _enliven(cfg, params, gen) -> None:
    """Seed every leaf the reference initialises to zero: RWKV's as
    _enliven_rwkv does, the hybrid's Mamba-2 conv biases (0.1 N(0, 1)), the
    VLM's cross-attention gates (uniform in [0.5, 1.5]: at zero every
    cross-attention layer adds nothing, and the logits ignore the vision
    states). The dense, MoE and audio families have none."""
    import torch
    if cfg.family == "ssm":
        _enliven_rwkv(cfg, params, gen)
        return
    if cfg.family == "vlm":
        single = params["layers"]["single"]
        for key in ("gate_attn", "gate_mlp"):
            single[key] = 0.5 + torch.rand(single[key].shape, generator=gen,
                                           device=gen.device)
        return
    if cfg.family != "hybrid":
        return
    for part in ("inner", "trailing"):
        m = params["layers"][part]["m"]
        for key in ("conv_b_x", "conv_b_BC"):
            m[key] = 0.1 * torch.randn(m[key].shape, generator=gen,
                                       device=gen.device)


def _moe_drops(cfg, params, tokens) -> int:
    """Choices that the first layer's MoE block drops at capacity in a
    forward of ``tokens`` (fp32, on the params' device): the layer's input
    to the block (embedding, attention, the two norms, as
    ``transformer.layer_fwd`` runs them), then each expert's choices by the
    block's own routing (``top_k_lower_first`` on the router's softmax)
    less its capacity (``moe_capacity`` over all B * S tokens)."""
    import torch

    from repro_torch.models import blocks as B
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import tree_map
    lp = tree_map(lambda a: a[0], params["layers"])
    ctx = M.make_ctx(cfg, tokens.shape[1], "prefill",
                     compute_dtype=torch.float32, device=tokens.device)
    with torch.no_grad():
        x = M.embed_tokens(params, tokens, cfg, torch.float32)
        x = x + B.attention_block(lp["attn"], B.apply_norm(lp["ln1"], x, cfg),
                                  cfg, rope=ctx["rope"])[0]
        h = B.apply_norm(lp["ln2"], x, cfg).reshape(-1, cfg.d_model)
        probs = torch.softmax(h @ lp["moe"]["router"], -1)
        idx = B.top_k_lower_first(probs, cfg.moe.top_k)[1]
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.moe.n_experts)
    cap = B.moe_capacity(cfg, h.shape[0])
    return int((counts - cap).clamp_min(0).sum())


def model_batch(cfg, rng, b: int, s: int) -> dict:
    """A request batch on the host: tokens (B, S), or (B, S, K) frames of
    codes with codebooks, from ``rng``, and the VLM's vision states (B, Nv,
    d_src) ~ N(0, 1) in fp32, as the data pipeline draws them."""
    import torch
    shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     shape))}
    if cfg.family == "vlm":
        batch["vision"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.vision_dim)).astype("float32"))
    return batch


def launches_per_call(cfg) -> tuple[dict, dict]:
    """Kernel launches of one prefill call and of one decode tick, from the
    model's layout: every layer runs its block's kernel once (the VLM's
    cross-attention layers run none: their attention is plain torch)."""
    from repro_torch.models import transformer as T
    lay = T.build_layout(cfg)
    if lay["kind"] == "uniform" and lay["block"] in ("dense", "moe"):
        return {"flash_attention": lay["n"]}, {"decode_attention": lay["n"]}
    if lay["kind"] == "uniform" and lay["block"] == "rwkv":
        return {"wkv6": lay["n"]}, {}
    inner = lay["periods"] * lay["inner_n"] + lay["trailing"]
    if lay["single_block"] == "cross_attn":
        return {"flash_attention": inner}, {"decode_attention": inner}
    return ({"mamba2_ssd": inner, "flash_attention": lay["periods"]},
            {"decode_attention": lay["periods"]})


def run_slice(cfg, params, card, counters, shape):
    """One model's main path in bf16: prefill, serving, and each request's
    prompt through the prefill step, with the launch counters zeroed before
    and checked after. Returns the launch counts, each request's prompt as
    a batch of one row, and each request's prefill and served logits at
    its last prompt token. The
    timed prefills and the serving run the config as it is; an MoE
    config's per-request prefills run at the no-drop capacity (no_drop),
    the function serving computes, for the parity gate. An MoE slice also
    profiles one prefill call and reports its MoE blocks' device time."""
    import numpy as np
    import torch

    from repro_torch.launch import serve as L
    from repro_torch.serve import decode as D

    slots, buf, requests, max_new, prompt_lens = shape
    per_call, per_tick = launches_per_call(cfg)

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
    check("prefill", 3, 0)

    prompts = [rng.integers(0, cfg.vocab_size,
                            rng.integers(prompt_lens[0], prompt_lens[1] + 1)
                            ).tolist() for _ in range(requests)]
    res = L.serve(cfg, params, prompts, slots=slots, buf=buf, max_new=max_new)
    check(f"serve ({res.ticks} ticks)", 3, res.ticks)
    if any(len(o) != max_new or min(o) < 0 or max(o) >= cfg.vocab_size
           for o in res.outputs):
        raise AssertionError("served outputs of the wrong length or range")

    parity_prefill = D.make_prefill_step(no_drop(cfg))
    pre16 = [parity_prefill(params, {"tokens": torch.tensor([p])})[0]
             .float().cpu() for p in prompts]
    torch.cuda.synchronize()
    launches = check("main path", 3 + requests, res.ticks)
    if not all(bool(torch.isfinite(t).all()) for t in pre16 + res.first_logits):
        raise AssertionError(f"{cfg.name}: non-finite prefill or served "
                             "logits")

    fed = sum(len(p) + max_new - 1 for p in prompts)
    numbers = {
        "arch": cfg.name, "card": card,
        "prefill_ms": 1e3 * sum(prefill_s[1:]) / len(prefill_s[1:]),
        "prefill_shape": [PREFILL_BATCH, PREFILL_LEN],
        "slots": slots, "buffer": buf, "requests": requests,
        "max_new": max_new, "decode_ticks": res.ticks,
        "ms_per_tick": 1e3 * res.seconds / res.ticks,
        "generated_tokens_per_s": requests * max_new / res.seconds,
        "fed_tokens_per_s": fed / res.seconds,
        "serve_s": res.seconds,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
    }
    log("slice: " + json.dumps(numbers))
    log("profile: " + json.dumps(profile_ticks(cfg, params, card, slots, buf)))
    if cfg.moe is not None:
        log("profile: " + json.dumps(profile_prefill(
            cfg, params, card, lambda: prefill(params, {"tokens": tokens}))))
    return launches, [{"tokens": torch.tensor([p])} for p in prompts], \
        pre16, res.first_logits


def check_parity(cfg, params, batches, pre16, served16, card) -> dict:
    """bf16 prefill (the prefill kernels) against bf16 serving (the decode
    path, token by token) at each request's last prompt token; ``batches``
    hold the requests' prompts (and vision states), row by row in the
    order of pre16 and served16.

    ``params`` are the fp32 weights (their embeddings are changed in place
    at the end): each prompt's fp32 prefill measures the
    model's own bf16 rounding error, the largest distance of a bf16 prefill
    from its fp32 prefill over the requests. Two bf16 runs that round at
    different places agree only as well as that error lets them, so the
    bound is 5e-2 of the logits' range, as in the CPU tests, or twice the
    rounding error where that is larger. At random init a deep model can
    amplify rounding; to show how much, the fp32 prefill is run again with
    the embeddings scaled by 1 + 1e-6 N(0, 1), and the largest change of the
    logits is reported (not gated). That the two paths compute the same
    function is held in fp32, at full width and reduced depth, in the
    reference phase."""
    import torch

    from repro_torch.serve import decode as D

    start = time.perf_counter()
    pre = D.make_prefill_step(cfg, compute_dtype=torch.float32)

    def fp32_rows():
        return [row for b in batches for row in pre(params, b).float().cpu()]

    pre32 = fp32_rows()
    rounding = [(p16 - p32).abs().max().item()
                for p16, p32 in zip(pre16, pre32)]
    gen = torch.Generator(device=params["embed"].device).manual_seed(3)
    params["embed"].mul_(1 + 1e-6 * torch.randn(
        params["embed"].shape, generator=gen, device=gen.device))
    moved = [(p - p32).abs().max().item()
             for p, p32 in zip(fp32_rows(), pre32)]
    out = {"arch": cfg.name, "card": card,
           "bf16_rounding_error": max(rounding),
           "fp32_change_for_1e-6_embedding_change": max(moved),
           "requests": [],
           "fields": ["bf16_max_abs_err", "limit",
                      "bf16_prefill_vs_fp32_prefill", "argmax_agree"]}
    for r in range(len(pre32)):
        err = (pre16[r] - served16[r]).abs().max().item()
        limit = max(5e-2 * pre16[r].abs().max().item(), 2 * max(rounding))
        out["requests"].append([err, limit, rounding[r], int(torch.equal(
            pre16[r].argmax(-1), served16[r].argmax(-1)))])
        if not err <= limit:
            raise AssertionError(f"{cfg.name} request {r}: bf16 prefill and "
                                 f"serve logits differ by {err:.3e} > "
                                 f"{limit:.3e}")
    out["seconds"] = time.perf_counter() - start
    return out


def _worst(got, want) -> float:
    """Largest over leaves of max|got - want| / max|want| (nested dicts)."""
    from repro_torch import convert
    got, want = convert.flatten(got), convert.flatten(want)
    return max(((got[k].float().cpu() - w.float().cpu()).abs().max()
                / w.abs().max().clamp_min(1e-30)).item()
               for k, w in want.items() if w.numel())


def check_train_parity(card, dev) -> None:
    """The train path at full width and reduced depth, fp32 (TF32 off).

    olmo-1b with 2 layers: one train step (its gradients, then the AdamW
    update) on the card against the same step on the CPU, at 2x256 (full
    attention) and 1x1536 (chunked). Gates: loss within 1e-4 relative;
    every gradient leaf within 1e-4 of its largest entry (fp32 sums in other
    orders); params within 2 lr (AdamW's first step is about lr * sign(g),
    and a gradient near zero may change sign). Then, on the card alone,
    olmo-1b and qwen3-8b with 2 layers at 1x1536: remat none, full and dots
    give gradients within 1e-6 of each leaf's largest entry, and the
    chunked attention's output and gradients (q, k, v before the GQA
    expansion) match the full attention's within 1e-4 of their largest
    entry at S = 1536."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import blocks as B
    from repro_torch.models import model as M
    from repro_torch.train import train_step as T
    from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                             leaves)

    tc = T.TrainConfig(remat="full", compute_dtype="float32")
    oc = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    cfg = dataclasses.replace(get_arch("olmo-1b"), n_layers=2)
    init = M.init_params(cfg, 0, device="cpu")
    log(f"train: {cfg.name} at full width, 2 layers, fp32: one step on the "
        f"card against the CPU [{card}]")
    for b, s in ((2, 256), (1, 1536)):
        batch = TokenPipeline(DataConfig(vocab_size=64, seq_len=s,
                                         global_batch=b), cfg).batch_at(0)
        out = []
        for where in (torch.device("cpu"), dev):
            params = _to(init, where)
            t0 = time.perf_counter()
            loss, _, grads = T.make_grad_fn(cfg, tc, device=where)(
                params, {k: torch.as_tensor(v, device=where)
                         for k, v in batch.items()})
            adamw_update(oc, params, grads, T.make_opt_state(params, tc))
            loss = float(loss)
            out.append((loss, grads, params, time.perf_counter() - t0))
        (cl, cg, cp, cs), (gl, gg, gp, gs) = out
        loss_err, grad_err = abs(gl - cl) / abs(cl), _worst(gg, cg)
        param_err = max((a.cpu() - b).abs().max().item()
                        for a, b in zip(leaves(gp), leaves(cp)) if b.numel())
        log(f"  {b}x{s}: loss {gl:.6f} (CPU {cl:.6f}, rel err {loss_err:.2e},"
            f" gate 1e-4), grads worst {grad_err:.2e} of the leaf max (gate "
            f"1e-4), params max_abs_err {param_err:.2e} (gate {2 * oc.lr:g}); "
            f"CPU {cs:.1f} s")
        if not (loss_err <= 1e-4 and grad_err <= 1e-4
                and param_err <= 2 * oc.lr):
            raise AssertionError(f"train step {b}x{s}: card and CPU disagree")
        del out, gg, cg, gp, cp

    rng = np.random.default_rng(5)
    for arch in ("olmo-1b", "qwen3-8b"):
        cfg = dataclasses.replace(get_arch(arch), n_layers=2)
        params = M.init_params(cfg, 0, device=dev)
        batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 1536)),
                                    device=dev) for k in ("tokens", "labels")}
        check_remat(cfg, params, batch, tc, dev)
        del params
        h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        gen = torch.Generator(device=dev).manual_seed(6)
        q, k, v = (torch.randn((1, 1536, n, d), generator=gen, device=dev)
                   .requires_grad_() for n in (h, kv, kv))
        ct = torch.randn((1, 1536, h, d), generator=gen, device=dev)
        res = []
        for attn in (B.chunked_causal_attention, B.full_causal_attention):
            o = attn(q, B._gqa_expand(k, h), B._gqa_expand(v, h))
            res.append({"o": o.detach(), **dict(zip("qkv", torch.autograd.grad(
                o, (q, k, v), ct)))})
        err = _worst(*res)
        log(f"  {arch} heads {h}:{kv} of {d}, S = 1536: chunked against full "
            f"attention, output and grads worst {err:.2e} of the max (gate "
            "1e-4)")
        if not err <= 1e-4:
            raise AssertionError(f"{arch}: chunked and full attention differ")
        del q, k, v, ct, res
        gc.collect()
        torch.cuda.empty_cache()


def run_train(card, counters, dev) -> dict:
    """olmo-1b at full width and depth: fp32 params, bf16 compute, remat
    "full", AdamW (lr 1e-3, warmup 2), 4x2048 tokens a step from the
    synthetic pipeline (data vocabulary 64). Six steps, the first a warm-up,
    then one step with 2 microbatches, with the launch counters zeroed
    before and read after: no kernel may launch (flash and decode attention
    have no backward). Gates: every loss finite; the first within 0.5 of a
    random model's, ln V plus half the logits' variance (V = 50304, and the
    tied head's logits have variance d * 0.02² = 0.82 under the
    non-parametric final norm); the last below the first. Then one profiled
    step, broken down by the ops that launched its kernels: ``aten::mm``
    (the weight matmuls and the head), ``aten::bmm`` (the attention
    einsums) and the rest (elementwise work, reductions, copies), and one
    AdamW update profiled alone."""
    import math

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import model as M
    from repro_torch.train import train_step as T
    from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                             leaves)

    cfg = get_arch("olmo-1b")
    b, s, steps = TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS
    tc = T.TrainConfig(remat="full")
    oc = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    params = M.init_params(cfg, 0, device=dev)
    opt = T.make_opt_state(params, tc)
    pipe = TokenPipeline(DataConfig(vocab_size=64, seq_len=s, global_batch=b,
                                    markov_temp=2.5), cfg)
    batches = [pipe.batch_at(i) for i in range(steps + 2)]
    n_params = sum(p.numel() for p in leaves(params))
    flops = train_flops(cfg, params, b, s)
    log(f"train: {cfg.name} {cfg.n_layers} layers, {n_params} params, "
        f"{b}x{s} tokens a step, bf16 compute, remat full [{card}]")

    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step = T.make_train_step(cfg, tc, oc, device=dev)
    step_mb2 = T.make_train_step(cfg, dataclasses.replace(tc, microbatches=2),
                                 oc, device=dev)
    losses, secs = [], []
    for i in range(steps + 1):
        t0 = time.perf_counter()
        params, opt, metrics = (step_mb2 if i == steps else step)(
            params, opt, batches[i])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        log(f"  step {i}{' (2 microbatches)' if i == steps else ''}: loss "
            f"{losses[-1]:.4f}, grad_norm {float(metrics['grad_norm']):.4f}, "
            f"{1e3 * secs[-1]:.1f} ms")
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    first_want = math.log(cfg.vocab_size) + cfg.d_model * 0.02 ** 2 / 2
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not abs(losses[0] - first_want) <= 0.5:
        raise AssertionError(f"first loss {losses[0]:.4f} is not within 0.5 "
                             f"of a random model's {first_want:.4f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if any(launches.values()):
        raise AssertionError(f"the train path launched kernels: {launches}")

    step_s = sorted(secs[1:steps])[(steps - 1) // 2]
    numbers = {
        "arch": cfg.name, "card": card, "params": n_params,
        "tokens_per_step": b * s, "remat": "full", "compute": "bfloat16",
        "losses": losses, "first_loss_want": first_want,
        "ms_per_step": 1e3 * step_s, "ms_per_step_all": [1e3 * x for x in secs],
        "tokens_per_s": b * s / step_s, "peak_gb": peak / 1e9,
        "model_flops": flops, "bound_ms": 1e3 * flops / PEAK_FLOPS["bfloat16"],
        "train_mfu": flops / step_s / PEAK_FLOPS["bfloat16"],
        "launches": launches,
    }
    numbers["profile"] = profile_train_step(
        lambda: step(params, opt, batches[steps + 1]), step_s)
    # the AdamW update's share of "other": one update alone, profiled
    grads = T.make_grad_fn(cfg, tc, device=dev)(params, {
        k: torch.as_tensor(v, device=dev) for k, v in batches[0].items()})[2]
    numbers["profile"]["adamw_ms"] = profile_train_step(
        lambda: adamw_update(oc, params, grads, opt), step_s)["device_ms"]
    return numbers


def check_remat(cfg, params, batch, tc, dev) -> None:
    """remat none, full and dots on one batch: gradients within 1e-6 of
    each leaf's largest entry."""
    from repro_torch.train import train_step as T

    want = None
    for remat in ("none", "full", "dots"):
        grads = T.make_grad_fn(cfg, dataclasses.replace(tc, remat=remat),
                               device=dev)(params, batch)[2]
        if want is None:
            want = grads
            continue
        err = _worst(grads, want)
        log(f"  {cfg.name}, {cfg.n_layers} layers, 1x1536: remat {remat} "
            f"against none, grads worst {err:.2e} of the leaf max (gate 1e-6)")
        if not err <= 1e-6:
            raise AssertionError(f"{cfg.name}: remat {remat} changes grads")


def check_family_train_parity(card, dev, families=None) -> None:
    """The other families' train paths at full width and reduced depth,
    fp32 (TF32 off), the zero-init leaves seeded (_enliven): rwkv6-7b with
    1 layer, zamba2-7b with 7 (one period of 5 Mamba-2 layers and the
    shared attention block, then one trailing layer) and olmoe-1b-7b with
    1 (its aux loss in the loss). One train step (its gradients, then the
    AdamW update) on the card against the same step on the CPU, at 2x200
    (the scans: three chunks of 64 and a ragged tail of 8) or 2x256
    (olmoe: capacity 80 against a mean load of 64 choices an expert, so
    choices drop and the gate holds the routing too; _moe_drops counts
    them on the CPU, and none fails the phase). Gates: loss within 1e-4 relative; every gradient leaf within
    TRAIN_FAMILIES' gate of its largest entry: 1e-4 for zamba2-7b and
    olmoe-1b-7b, as olmo-1b; 2e-4 for
    rwkv6-7b, as tests/test_torch_train_recurrent.py holds it, since its
    per-head group norm divides by small standard deviations and so
    enlarges the fp32 rounding of the scan (on the CPU at reduced width two
    correct fp32 scans give gradients 4.4e-5 of the leaf max apart);
    params within 2 lr.
    Then, on the card alone at 1x1536, remat none, full and dots give
    gradients within 1e-6 of each leaf's largest entry. ``families``
    (TRAIN_FAMILIES by default) maps each arch to its entries as
    TRAIN_FAMILIES does (chip_smoke_media.py passes the VLM and audio
    families: the VLM's batch carries vision states)."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import model as M
    from repro_torch.train import train_step as T
    from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                             leaves)


    tc = T.TrainConfig(remat="full", compute_dtype="float32")
    oc = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    cpu = torch.device("cpu")
    for arch, (_, layers, seq, gate, _) in (families
                                            or TRAIN_FAMILIES).items():
        cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
        # drawn on the card, then copied to the host
        init = M.init_params(cfg, 0, device=dev)
        _enliven(cfg, init, torch.Generator(device=dev).manual_seed(1))
        init = _to(init, cpu)
        batch = TokenPipeline(DataConfig(vocab_size=64, seq_len=seq,
                                         global_batch=2), cfg).batch_at(0)
        log(f"train: {cfg.name} at full width, {layers} layers, fp32: one "
            f"step on the card against the CPU at 2x{seq} [{card}]")
        out = []
        for where in (cpu, dev):
            params = _to(init, where)
            t0 = time.perf_counter()
            loss, _, grads = T.make_grad_fn(cfg, tc, device=where)(
                params, {k: torch.as_tensor(v, device=where)
                         for k, v in batch.items()})
            adamw_update(oc, params, grads, T.make_opt_state(params, tc))
            out.append((float(loss), grads, params,
                        time.perf_counter() - t0))
        if cfg.moe is not None:
            drops = _moe_drops(cfg, init, torch.as_tensor(batch["tokens"]))
            log(f"  choices dropped at capacity in the first layer (CPU): "
                f"{drops} of {2 * seq * cfg.moe.top_k}")
            if not drops:
                raise AssertionError(f"{arch}: no choice dropped, so the "
                                     "gate would not hold the capacity")
        (cl, cg, cp, cs), (gl, gg, gp, _) = out
        loss_err, grad_err = abs(gl - cl) / abs(cl), _worst(gg, cg)
        param_err = max((a.cpu() - b).abs().max().item()
                        for a, b in zip(leaves(gp), leaves(cp)) if b.numel())
        log(f"  loss {gl:.6f} (CPU {cl:.6f}, rel err {loss_err:.2e}, gate "
            f"1e-4), grads worst {grad_err:.2e} of the leaf max (gate "
            f"{gate:g}), params max_abs_err {param_err:.2e} (gate "
            f"{2 * oc.lr:g}); CPU {cs:.1f} s")
        if not (loss_err <= 1e-4 and grad_err <= gate
                and param_err <= 2 * oc.lr):
            raise AssertionError(f"{arch} train step: card and CPU disagree")
        del out, gg, cg, gp, cp, init

        params = M.init_params(cfg, 0, device=dev)
        _enliven(cfg, params, torch.Generator(device=dev).manual_seed(1))
        rng = np.random.default_rng(5)
        batch = {k: v.to(dev) for k, v in model_batch(cfg, rng, 1,
                                                      1536).items()}
        batch["labels"] = torch.as_tensor(rng.integers(
            0, cfg.vocab_size, batch["tokens"].shape), device=dev)
        check_remat(cfg, params, batch, tc, dev)
        del params
        gc.collect()
        torch.cuda.empty_cache()


def train_flops(cfg, params, b: int, s: int) -> int:
    """Model FLOPs of one train step (forward and backward, remat's
    recompute not counted): 6 per weight that multiplies a token (the
    input embedding is a lookup, and is left out unless tied to the head;
    the hybrid's shared block counts once per site; of an MoE layer's
    routed experts only the top k of E count, as ``n_active_params``
    counts them, and the capacity's empty slots are not model FLOPs),
    plus, per layer, the
    sequential recurrence's 4 K V (WKV6) or 4 N P (SSD) per token and head,
    causal attention's 2 S D per query and head (half the pairs, QK^T
    and PV) and the VLM's cross-attention's 4 Nv D (every query sees all
    Nv vision states), each three times (forward, and backward at twice
    the forward). The VLM's wk and wv multiply the B Nv vision states, and
    musicgen's head has K V outputs, as its weights count them.
    """
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import leaves
    weights = sum(p.numel() for p in leaves(params))
    if not cfg.tie_embeddings:
        weights -= params["embed"].numel()
    lay, t = T.build_layout(cfg), b * s
    hd = cfg.resolved_head_dim
    if lay["kind"] == "periodic" and lay["single_block"] == "cross_attn":
        # the VLM: the cross-attention layers' wk and wv multiply the B Nv
        # vision states, not the tokens; the placeholder trailing layer
        # (trailing 0) never runs; each query attends to all Nv vision
        # states, 4 Nv D per query and head (QK^T and PV, no mask)
        attn, nv = params["layers"]["single"]["attn"], cfg.n_vision_tokens
        src = attn["wk"].numel() + attn["wv"].numel()
        if not lay["trailing"]:
            weights -= sum(p.numel()
                           for p in leaves(params["layers"]["trailing"]))
        dense = lay["periods"] * lay["inner_n"] + lay["trailing"]
        return (6 * (weights - src) * t + 6 * src * b * nv
                + 6 * dense * t * cfg.n_heads * s * hd
                + 12 * lay["periods"] * t * cfg.n_heads * nv * hd)
    if lay["kind"] == "uniform" and lay["block"] == "moe":
        m, moe = cfg.moe, params["layers"]["moe"]
        weights -= sum(moe[k].numel() for k in ("w_gate", "w_up", "w_down")
                       ) * (m.n_experts - m.top_k) // m.n_experts
    if lay["kind"] == "uniform" and lay["block"] in ("dense", "moe"):
        return 6 * weights * t + 6 * lay["n"] * t * cfg.n_heads * s * \
            cfg.resolved_head_dim
    if lay["kind"] == "uniform":
        k = cfg.rwkv.head_dim
        return 6 * weights * t + 12 * lay["n"] * t * cfg.d_model * k
    mc, sites = cfg.mamba, lay["periods"]
    shared = sum(p.numel() for p in leaves(params["shared_block"]))
    mamba_layers = sites * lay["inner_n"] + lay["trailing"]
    return (6 * (weights + (sites - 1) * shared) * t
            + 12 * mamba_layers * t * mc.n_heads(cfg.d_model) * mc.d_state
            * mc.head_dim
            + 6 * sites * t * cfg.n_heads * s * cfg.resolved_head_dim)


def run_train_family(card, counters, dev, arch, families=None) -> dict:
    """rwkv6-7b, zamba2-7b or olmoe-1b-7b (or another arch of ``families``,
    TRAIN_FAMILIES by default) at full width and its depth there: fp32 params (the zero-init leaves seeded), bf16 compute, remat
    "full", AdamW (lr 1e-3, warmup 2), 4x2048 tokens a step from the
    synthetic pipeline (data vocabulary 64). Six steps, the first a
    warm-up, then one profiled step, with the launch counters zeroed before
    and read after: no kernel may launch (the scans and the MoE run in
    plain torch). Gates: every loss finite; the last below the first; the
    steps' peak device memory at most TRAIN_PEAK_BYTES. The profiled step
    is split by the op that launched each kernel: the scan (``wkv6_chunked``
    or ``ssd_chunked``: the ops under its record_function and the backward
    nodes of those ops; none for olmoe), ``aten::mm`` (the weight matmuls,
    the MoE router and the head), ``aten::bmm`` (the expert products and
    the attention einsums) and the rest."""
    import math

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import model as M
    from repro_torch.train import train_step as T
    from repro_torch.train.optimizer import OptimizerConfig, leaves

    layers, _, _, _, scan = (families or TRAIN_FAMILIES)[arch]
    full = get_arch(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    b, s, steps = TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS
    tc = T.TrainConfig(remat="full")
    oc = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    params = M.init_params(cfg, 0, device=dev)
    _enliven(cfg, params, torch.Generator(device=dev).manual_seed(1))
    opt = T.make_opt_state(params, tc)
    pipe = TokenPipeline(DataConfig(vocab_size=64, seq_len=s, global_batch=b,
                                    markov_temp=2.5), cfg)
    batches = [pipe.batch_at(i) for i in range(steps + 1)]
    n_params = sum(p.numel() for p in leaves(params))
    flops = train_flops(cfg, params, b, s)
    log(f"train: {cfg.name} {layers} of {full.n_layers} layers, {n_params} "
        f"params, {b}x{s} tokens a step, bf16 compute, remat full [{card}]")

    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step = T.make_train_step(cfg, tc, oc, device=dev)
    losses, secs = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batches[i])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        log(f"  step {i}: loss {losses[-1]:.4f}, grad_norm "
            f"{float(metrics['grad_norm']):.4f}, {1e3 * secs[-1]:.1f} ms")
    peak = torch.cuda.max_memory_allocated()
    step_s = sorted(secs[1:])[(steps - 1) // 2]
    profile = profile_train_step(
        lambda: step(params, opt, batches[steps]), step_s, scan=scan)
    launches = {k: c.launches for k, c in counters.items()}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{arch}: non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{arch}: the loss did not fall: {losses}")
    if any(launches.values()):
        raise AssertionError(f"{arch}: the train path launched kernels: "
                             f"{launches}")
    if not peak <= TRAIN_PEAK_BYTES:
        raise AssertionError(f"{arch}: peak {peak / 1e9:.1f} GB passes "
                             f"{TRAIN_PEAK_BYTES / 1e9:g} GB; cut its depth")
    return {
        "arch": cfg.name, "card": card, "layers": layers,
        "layers_of": full.n_layers, "params": n_params,
        "tokens_per_step": b * s, "remat": "full", "compute": "bfloat16",
        "losses": losses, "ms_per_step": 1e3 * step_s,
        "ms_per_step_all": [1e3 * x for x in secs],
        "tokens_per_s": b * s / step_s, "peak_gb": peak / 1e9,
        "model_flops": flops, "bound_ms": 1e3 * flops / PEAK_FLOPS["bfloat16"],
        "train_mfu": flops / step_s / PEAK_FLOPS["bfloat16"],
        "launches": launches, "profile": profile,
    }


def run_checkpoints(card, counters, dev) -> dict:
    """olmo-1b at full width and CKPT_LAYERS layers, otherwise as in
    run_train (fp32 params, bf16 compute, remat "full", AdamW lr 1e-3 with
    warmup 2, 4x2048 tokens of the synthetic pipeline) under
    ``TrainSupervisor``: CKPT_STEPS steps, a
    checkpoint every CKPT_SAVE_EVERY, a non-external ``JobPreempted`` once
    at step CKPT_FAIL_AT, in a temporary ``AcaiProject`` under build/ that
    is deleted at the end. Gates and numbers: see the module docstring."""
    import math
    import resource
    import shutil
    import tempfile

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.convert import flatten
    from repro_torch.core.acai import AcaiProject
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import model as M
    from repro_torch.train import train_step as T
    from repro_torch.train.checkpoints import CheckpointManager
    from repro_torch.train.fault import JobPreempted, TrainSupervisor
    from repro_torch.train.optimizer import OptimizerConfig, leaves, tree_map

    cfg = dataclasses.replace(get_arch("olmo-1b"), n_layers=CKPT_LAYERS)
    tc = T.TrainConfig(remat="full")
    oc = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    step = T.make_train_step(cfg, tc, oc, device=dev)
    pipe = TokenPipeline(DataConfig(vocab_size=64, seq_len=TRAIN_LEN,
                                    global_batch=TRAIN_BATCH,
                                    markov_temp=2.5), cfg)
    times = {"save_ms": [], "restore_ms": []}

    class TimedCheckpoints(CheckpointManager):
        def save(self, *args, **kw):
            t0 = time.perf_counter()
            ref = super().save(*args, **kw)
            times["save_ms"].append(1e3 * (time.perf_counter() - t0))
            log(f"  save {ref}: {times['save_ms'][-1]:.1f} ms")
            return ref

        def restore(self, *args, **kw):
            t0 = time.perf_counter()
            out = super().restore(*args, **kw)
            torch.cuda.synchronize()
            times["restore_ms"].append(1e3 * (time.perf_counter() - t0))
            log(f"  restore of step {out[1]}: "
                f"{times['restore_ms'][-1]:.1f} ms")
            return out

    losses, stamps, current = [], [], {}

    def batch_fn(i):
        current["step"] = i
        return pipe.batch_at(i)

    def step_fn(params, opt, batch):
        params, opt, metrics = step(params, opt, batch)
        losses.append((current["step"], float(metrics["loss"])))
        log(f"  step {current['step']}: loss {losses[-1][1]:.6f}")
        return params, opt, metrics

    def clock():
        stamps.append(time.perf_counter())
        return stamps[-1]

    pending = {CKPT_FAIL_AT}

    def failure_hook(i):
        if i in pending:
            pending.discard(i)
            log(f"  injected failure at step {i}")
            raise JobPreempted(f"injected failure at step {i}")

    rss = RssSampler()
    params = M.init_params(cfg, 0, device=dev)
    # a one-item list, popped into the run: nothing here keeps the state,
    # so the restore frees the state it replaces
    start = [{"params": params, "opt": T.make_opt_state(params, tc),
              "step": 0}]
    n_params = sum(p.numel() for p in leaves(params))
    state_bytes = sum(t.numel() * t.element_size()
                      for t in leaves(start[0]["opt"]) + leaves(params))
    del params
    workdir = Path(tempfile.mkdtemp(prefix="acai-ckpt-", dir=ROOT / "build"))
    rss.start()
    try:
        disk_free = shutil.disk_usage(workdir).free
        log(f"checkpoints: {cfg.name}, {n_params} params, {state_bytes} "
            f"bytes of state; {disk_free / 1e9:.2f} GB free under "
            f"{workdir}, {2 * state_bytes / 1e9:.2f} GB planned (2 saves) "
            f"[{card}]")
        if disk_free < CKPT_MIN_FREE:
            raise AssertionError(f"{disk_free / 1e9:.2f} GB free under "
                                 f"{workdir}; the phase needs "
                                 f"{CKPT_MIN_FREE / 1e9:.0f} GB")
        project = AcaiProject("smoke", workdir)
        data_ref = pipe.register(project, "olmo-1b-data", creator="trainer")
        ckpt = TimedCheckpoints(project, "olmo-1b-run")
        sup = TrainSupervisor(ckpt, save_every=CKPT_SAVE_EVERY)
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, report = sup.run(step_fn, start.pop(), CKPT_STEPS,
                                batch_fn, failure_hook=failure_hook,
                                time_fn=clock)
        launches = {k: c.launches for k, c in counters.items()}
        want = {"restarts": 1, "checkpoints": 2, "steps_run": 5,
                "final_step": CKPT_STEPS}
        got = {k: getattr(report, k) for k in want}
        if got != want:
            raise AssertionError(f"supervisor report {got}, wanted {want}")
        if ckpt.latest_step() != CKPT_STEPS:
            raise AssertionError(f"latest step {ckpt.latest_step()}")
        metas = [project.metadata.get(a) for a in project.metadata.find(
            kind="checkpoint", run="olmo-1b-run")]
        if sorted(m["step"] for m in metas) != [2, 4] or not all(
                math.isfinite(m["loss"]) for m in metas):
            raise AssertionError(f"checkpoint metadata {metas}")

        live = {"params": state["params"], "opt": state["opt"]}
        restored, at = ckpt.restore(tree_map(torch.empty_like, live))
        live_flat = flatten(live)
        mismatched = [key for key, leaf in flatten(restored).items()
                      if not _bits_equal(leaf, live_flat[key])]
        if at != CKPT_STEPS or mismatched:
            raise AssertionError(f"restored step {at}; leaves that differ "
                                 f"from the live state: {mismatched}")
        del restored
        before, after = [loss for i, loss in losses if i == CKPT_FAIL_AT - 1]
        log(f"  step {CKPT_FAIL_AT - 1}'s loss {before!r} before the restore, "
            f"{after!r} after: bit-equal {before == after}")
        if not abs(after - before) <= 1e-6 * abs(before):
            raise AssertionError(f"step {CKPT_FAIL_AT - 1}'s loss {after} "
                                 f"after the restore, {before} before")
        if any(launches.values()):
            raise AssertionError(f"the checkpoint phase launched kernels: "
                                 f"{launches}")
        npz = project.storage.resolve("/olmo-1b-run-ckpt/state.npz").size
        step_ms = [1e3 * (b - a) for a, b in zip(stamps[::2], stamps[1::2])]
        peak_host = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        # the host's hash rates, which bound a save and a restore: SHA-256
        # names the blob, CRC-32 guards each zip entry (written and read)
        sample = live["params"]["embed"].cpu().numpy()
        t0 = time.perf_counter()
        hashlib.sha256(sample).digest()
        t1 = time.perf_counter()
        zlib.crc32(sample)
        t2 = time.perf_counter()
        sample_bytes = sample.nbytes
        del sample
        return {
            "arch": cfg.name, "card": card, "layers": cfg.n_layers,
            "params": n_params,
            "tokens_per_step": TRAIN_BATCH * TRAIN_LEN, "data": data_ref,
            "report": dataclasses.asdict(report), "losses": losses,
            "step2_loss_before": before, "step2_loss_after": after,
            "step2_bit_equal": before == after,
            "restored_bit_equal": True, "launches": launches,
            "state_bytes": state_bytes, "npz_bytes": npz,
            "disk_free_gb": disk_free / 1e9,
            "save_ms": times["save_ms"], "restore_ms": times["restore_ms"],
            "save_gb_per_s": [npz / ms / 1e6 for ms in times["save_ms"]],
            "restore_gb_per_s": [npz / ms / 1e6
                                 for ms in times["restore_ms"]],
            "ms_per_step": step_ms, "straggler_steps": report.straggler_steps,
            "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
            "peak_host_rss_gb": peak_host / 1e9,
            "phase_host_rss_gb": {"start": rss.first / 1e9,
                                  "peak": rss.peak / 1e9},
            "host_sha256_gb_per_s": sample_bytes / (t1 - t0) / 1e9,
            "host_crc32_gb_per_s": sample_bytes / (t2 - t1) / 1e9,
        }
    finally:
        rss.stop.set()
        rss.join(timeout=10)
        shutil.rmtree(workdir, ignore_errors=True)


def run_platform(card, counters, dev) -> dict:
    """The paper's workflow as jobs through the port's ``AcaiPlatform``
    (``runner="thread"``, one worker, so the two full-width training jobs
    run one at a time and do not time each other), in a lake under build/
    that is deleted at the end: a pipeline of a data job, which uploads
    the data description and makes fileset ``TrainData``, two olmo-1b
    training jobs after it at full
    width and depth (lr 3e-3 and 1e-4, PLATFORM_STEPS steps of 4x2048
    tokens, bf16 compute, remat "full", warmup 2), each saving its params
    with its job's provenance and printing ``[[acai:final_loss=...]]``;
    then an eval job after both that restores the run ``find_min`` names,
    casts it to bf16, prefills each request's prompt (flash attention) and
    serves phase 5's olmo-1b workload (decode attention), printing its
    tokens/s. Gates and numbers: see the module docstring."""
    import hashlib
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.convert import flatten
    from repro_torch.core.acai import AcaiPlatform
    from repro_torch.core.engine.events import (TOPIC_CONTAINER_STATUS,
                                                TOPIC_JOB_PROGRESS)
    from repro_torch.core.engine.lifecycle import TERMINAL_STATUS_VALUES
    from repro_torch.core.engine.registry import JobSpec
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import serve as L
    from repro_torch.models import model as M
    from repro_torch.serve import decode as D
    from repro_torch.train import train_step as T
    from repro_torch.train.checkpoints import CheckpointManager
    from repro_torch.train.optimizer import OptimizerConfig

    cfg = get_arch("olmo-1b")
    tc = T.TrainConfig(remat="full")
    slots, buf, requests, max_new, prompt_lens = SLICES["olmo-1b"]
    per_call, per_tick = launches_per_call(cfg)
    pipe = TokenPipeline(DataConfig(vocab_size=64, seq_len=TRAIN_LEN,
                                    global_batch=TRAIN_BATCH,
                                    markov_temp=2.5), cfg)
    batches = [pipe.batch_at(i) for i in range(PLATFORM_STEPS)]

    def digest(params) -> str:
        """SHA-256 over every leaf's key, dtype, shape and bytes, in key
        order."""
        h = hashlib.sha256()
        for key, leaf in sorted(flatten(params).items()):
            h.update(f"{key} {leaf.dtype} {tuple(leaf.shape)}".encode())
            if leaf.numel():
                h.update(leaf.detach().contiguous().cpu().reshape(-1)
                         .view(torch.uint8).numpy())
        return h.hexdigest()

    def launched():
        return {k: c.launches for k, c in counters.items()}

    # the engine's own events, stamped with the host clock and the card's
    # memory: a job starts at its "running" progress event and ends at
    # its terminal status, which its worker publishes after the runner's
    # wait for the card and the commit of its outputs
    marks = {}

    def memory():
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    def on_progress(msg):
        if msg.get("stage") == "running":
            before = memory()
            torch.cuda.reset_peak_memory_stats()
            marks[msg["job_id"]] = {"start": time.perf_counter(),
                                    "before": before,
                                    "launches_before": launched()}

    def on_status(msg):
        mark = marks.get(msg["job_id"])
        if msg.get("status") in TERMINAL_STATUS_VALUES and mark is not None:
            mark.update(end=time.perf_counter(), after=memory(),
                        peak=torch.cuda.max_memory_allocated(),
                        launches={k: n - mark["launches_before"][k]
                                  for k, n in launched().items()})

    workdir = Path(tempfile.mkdtemp(prefix="acai-platform-",
                                    dir=ROOT / "build"))
    eng = None
    try:
        disk_free = shutil.disk_usage(workdir).free
        log(f"platform: {cfg.name} through AcaiPlatform(runner='thread', "
            f"max_workers=1), lake under {workdir} with "
            f"{disk_free / 1e9:.2f} GB free [{card}]")
        if disk_free < PLATFORM_MIN_FREE:
            raise AssertionError(f"{disk_free / 1e9:.2f} GB free under "
                                 f"{workdir}; the phase needs "
                                 f"{PLATFORM_MIN_FREE / 1e9:.0f} GB")
        plat = AcaiPlatform(workdir, runner="thread", max_workers=1)
        admin = plat.create_project(plat.admin_token, "smoke")
        proj = plat.project(admin)
        eng = plat.engine(admin)
        eng.bus.subscribe(TOPIC_JOB_PROGRESS, on_progress)
        eng.bus.subscribe(TOPIC_CONTAINER_STATUS, on_status)

        def data_job(workdir, job):
            print(proj.upload(
                "/data/dataset.json",
                json.dumps(dataclasses.asdict(pipe.cfg)).encode(),
                creator=job.spec.user))
            print(proj.create_file_set("TrainData", ["/data/dataset.json"],
                                       creator=job.spec.user))

        def train_job(workdir, job):
            lr = job.spec.args["lr"]
            step = T.make_train_step(cfg, tc, OptimizerConfig(
                lr=lr, warmup_steps=2, total_steps=100), device=dev)
            params = M.init_params(cfg, 0, device=dev)
            opt = T.make_opt_state(params, tc)
            losses, step_s = [], []
            for i, batch in enumerate(batches):
                t0 = time.perf_counter()
                params, opt, metrics = step(params, opt, batch)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                losses.append(float(metrics["loss"]))
                print(f"  step {i}: loss {losses[-1]:.4f}, "
                      f"{1e3 * step_s[-1]:.1f} ms")
            del opt
            t0 = time.perf_counter()
            ref = CheckpointManager(proj, f"run-lr{lr}").save(
                PLATFORM_STEPS, params, extra={"final_loss": losses[-1]},
                job_id=job.job_id, input_fileset="TrainData")
            save_s = time.perf_counter() - t0
            print(f"[[acai:final_loss={losses[-1]}]]")
            return {"losses": losses, "step_s": step_s, "save_s": save_s,
                    "checkpoint": ref, "params_sha256": digest(params)}

        def eval_job(workdir, job):
            best = proj.metadata.find_min("final_loss", kind="job")
            trained = eng.registry.get(best)
            run = f"run-lr{trained.spec.args['lr']}"
            t0 = time.perf_counter()
            state, at = CheckpointManager(proj, run).restore(
                {"params": M.init_params(cfg, 0, device=dev)})
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            bit_equal = digest(state["params"]) == \
                trained.outputs["params_sha256"]
            params = M.cast_params(state["params"], torch.bfloat16)
            del state
            rng = np.random.default_rng(0)
            prompts = [rng.integers(0, cfg.vocab_size, rng.integers(
                prompt_lens[0], prompt_lens[1] + 1)).tolist()
                for _ in range(requests)]
            before = launched()
            prefill = D.make_prefill_step(cfg, device=dev)
            pre = [prefill(params, {"tokens": torch.tensor([p])})[0]
                   .float().cpu() for p in prompts]
            res = L.serve(cfg, params, prompts, slots=slots, buf=buf,
                          max_new=max_new, device=dev)
            launches = {k: n - before[k] for k, n in launched().items()}
            tokens_per_s = requests * max_new / res.seconds
            ok = all(bool(torch.isfinite(t).all())
                     for t in pre + res.first_logits) and all(
                len(o) == max_new and 0 <= min(o) and
                max(o) < cfg.vocab_size for o in res.outputs)
            print(f"[[acai:tokens_per_s={tokens_per_s},ticks={res.ticks}]]")
            return {"best": best, "run": run, "restored_step": at,
                    "restore_s": restore_s, "bit_equal": bit_equal,
                    "serve_s": res.seconds, "ticks": res.ticks,
                    "tokens_per_s": tokens_per_s, "outputs_ok": ok,
                    "launches": launches, "prefill_calls": len(prompts)}

        sweep = plat.pipeline(admin, "sweep")
        data = sweep.stage(JobSpec(name="data", project="", user="",
                                   fn=data_job))
        runs = [sweep.stage(JobSpec(
            name=f"train-lr{lr}", project="", user="", fn=train_job,
            input_fileset="TrainData", args={"lr": lr},
            resources={"vcpu": 8, "mem_mb": 8192}), after=data)
            for lr in PLATFORM_LRS]
        sweep.stage(JobSpec(name="eval", project="", user="", fn=eval_job,
                            resources={"vcpu": 8, "mem_mb": 8192}),
                    after=runs)
        for c in counters.values():
            c.launches = 0
        handles = sweep.run()
        states = sweep.wait(timeout=1200)
        # the handles resolve at the engine's monitor; this phase's own
        # handlers on the same events have run once the workers are idle
        eng.scheduler.run_to_completion()
        launches = launched()
        # what stays after the jobs: torch keeps a cuBLAS workspace per
        # (handle, stream), and each thread has its own handle
        retained = memory()
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            clear()
        after_clear = memory()
        jobs = [h.job for h in handles]
        for job, state in zip(jobs, states):
            if state.value != "FINISHED":
                raise AssertionError(f"{job.job_id} ({job.spec.name}) ended "
                                     f"{state.value}: {job.error}")
        data_j, *trains, ev = jobs
        out = ev.outputs

        # gates
        spans = sorted((marks[j.job_id]["start"], marks[j.job_id]["end"])
                       for j in jobs)
        one_at_a_time = all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        log(f"  the {len(jobs)} jobs ran one at a time: {one_at_a_time}")
        if not one_at_a_time:
            raise AssertionError(f"jobs overlapped: {spans}")
        losses = {j.job_id: j.outputs["losses"][-1] for j in trains}
        if not all(math.isfinite(x) for j in trains
                   for x in j.outputs["losses"]):
            raise AssertionError(f"non-finite training loss: {losses}")
        if out["best"] != min(losses, key=losses.get):
            raise AssertionError(f"find_min named {out['best']}, final "
                                 f"losses {losses}")
        for j in trains:
            back = proj.provenance.backward(
                f"run-lr{j.spec.args['lr']}-ckpt:1")
            if not any(src == "TrainData:1" for src, _ in back):
                raise AssertionError(f"{j.job_id}'s checkpoint does not "
                                     f"lead back to TrainData:1: {back}")
            # consistency only: the job returns with nothing queued (see
            # the module docstring), so this holds with or without the
            # runner's device wait
            if not j.runtime >= sum(j.outputs["step_s"]):
                raise AssertionError(
                    f"{j.job_id}: engine runtime {j.runtime} s < its "
                    f"synchronized steps' {sum(j.outputs['step_s'])} s")
        for j in (data_j, *trains):
            if any(marks[j.job_id]["launches"].values()):
                raise AssertionError(f"{j.job_id} launched kernels: "
                                     f"{marks[j.job_id]['launches']}")
        if not (out["bit_equal"] and out["restored_step"] == PLATFORM_STEPS):
            raise AssertionError(f"restore of {out['run']}: step "
                                 f"{out['restored_step']}, bit-equal "
                                 f"{out['bit_equal']}")
        if not out["outputs_ok"]:
            raise AssertionError("the eval job's logits or outputs are "
                                 "non-finite or out of range")
        want = {k: out["prefill_calls"] * per_call.get(k, 0)
                + out["ticks"] * per_tick.get(k, 0) for k in counters}
        if out["launches"] != want or launches != want or \
                marks[ev.job_id]["launches"] != want:
            raise AssertionError(f"eval launches {out['launches']} (phase "
                                 f"{launches}), expected {want}")
        for j in jobs:
            m = marks[j.job_id]
            log(f"  {j.job_id} {j.spec.name}: device memory "
                f"{m['before'] / 1e9:.3f} GB before, {m['peak'] / 1e9:.3f} "
                f"GB peak, {m['after'] / 1e9:.3f} GB after")
            if not m["after"] - m["before"] <= MEMORY_RETURN_BYTES:
                raise AssertionError(
                    f"{j.job_id} left {(m['after'] - m['before']) / 1e9:.3f}"
                    f" GB on the card")

        def row(j):
            m = marks[j.job_id]
            own = sum(j.outputs["step_s"]) if "step_s" in j.outputs \
                else j.outputs.get("serve_s")
            return {"name": j.spec.name, "state": j.state.value,
                    "runtime_s": j.runtime, "own_s": own,
                    "save_s": j.outputs.get("save_s"),
                    "restore_s": j.outputs.get("restore_s"),
                    "cpu_pricing_cost": j.cost,
                    "before_gb": m["before"] / 1e9,
                    "peak_gb": m["peak"] / 1e9, "after_gb": m["after"] / 1e9,
                    "launches": m["launches"]}

        numbers = {
            "arch": cfg.name, "card": card, "runner": "thread",
            "max_workers": 1, "one_at_a_time": one_at_a_time,
            "jobs": {j.job_id: row(j) for j in jobs},
            "final_losses": losses, "best": out["best"],
            "best_lr": eng.registry.get(out["best"]).spec.args["lr"],
            "step_ms": {j.job_id: [1e3 * x for x in j.outputs["step_s"]]
                        for j in trains},
            "restored_bit_equal": out["bit_equal"],
            "eval_ticks": out["ticks"], "eval_serve_s": out["serve_s"],
            "eval_tokens_per_s": out["tokens_per_s"],
            "eval_metadata_tokens_per_s":
                proj.metadata.get(ev.job_id)["tokens_per_s"],
            "launches": launches, "retained_gb": retained / 1e9,
            "retained_gb_after_clearing_cublas_workspaces":
                after_clear / 1e9 if clear is not None else None,
        }
        log(f"  best run {out['run']} ({out['best']}); the eval job served "
            f"{requests} requests in {out['ticks']} ticks, "
            f"{out['tokens_per_s']:.2f} tokens/s")
        return numbers
    finally:
        if eng is not None:
            eng.launcher.shutdown()
        shutil.rmtree(workdir, ignore_errors=True)


def slice_prompts(cfg, shape) -> list:
    """Phase 5's requests of ``cfg`` at ``shape`` (run_slice draws them
    from seed 0 after its 4x2048 prefill batch)."""
    import numpy as np
    _, _, requests, _, prompt_lens = shape
    rng = np.random.default_rng(0)
    rng.integers(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN))
    return [rng.integers(0, cfg.vocab_size,
                         rng.integers(prompt_lens[0], prompt_lens[1] + 1)
                         ).tolist() for _ in range(requests)]


def gpu_memory_used() -> int:
    """The card's ``memory.used`` from nvidia-smi, in MiB."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return int(out.strip().splitlines()[0])


def _reap(pid: int, timeout: float) -> bool:
    """Wait up to ``timeout`` s for the child ``pid`` to exit (and reap
    it); True once it has."""
    import os
    deadline = time.perf_counter() + timeout
    while True:
        try:
            if os.waitpid(pid, os.WNOHANG)[0] == pid:
                return True
        except ChildProcessError:
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                return True             # not our child, and gone
        if time.perf_counter() > deadline:
            return False
        time.sleep(0.05)


class MemorySampler(threading.Thread):
    """The card's largest ``memory.used`` (nvidia-smi, MiB), read every
    0.25 s while it runs."""

    def __init__(self):
        super().__init__(daemon=True)
        self.stop = threading.Event()
        self.peak = gpu_memory_used()

    def run(self):
        while not self.stop.wait(0.25):
            self.peak = max(self.peak, gpu_memory_used())


def run_durable(card) -> dict:
    """Phase 9 (see the module docstring): the durable control plane and
    the subprocess runner on the card, through
    ``AcaiPlatform(root, runner="subprocess", durable=True)`` under build/:
    overlapping jobs in one worker, the engine's death, the worker's death
    and a shutdown. Its jobs are ``repro_torch/examples/card_jobs.py``'s,
    since a job that crosses the process boundary must be importable."""
    import math
    import os
    import shutil
    import signal
    import tempfile

    from repro_torch.configs.base import get_arch
    from repro_torch.core.acai import AcaiPlatform
    from repro_torch.core.engine.handle import JobHandle
    from repro_torch.core.engine.registry import JobSpec
    from repro_torch.examples import card_jobs as CJ

    cfg = get_arch("olmo-1b")
    slots, buf, _, max_new, _ = SLICES["olmo-1b"]
    per_call, per_tick = launches_per_call(cfg)
    prompts = slice_prompts(cfg, SLICES["olmo-1b"])[:DURABLE_REQUESTS]
    workdir = Path(tempfile.mkdtemp(prefix="acai-durable-",
                                    dir=ROOT / "build"))
    train = {"arch": cfg.name, "layers": DURABLE_LAYERS, "batch": TRAIN_BATCH,
             "seq": TRAIN_LEN}
    live = []               # the platforms whose engines still run
    pids = set()
    sampler = None

    def platform():
        plat = AcaiPlatform(workdir, runner="subprocess", durable=True,
                            quota_k=4)
        t0 = time.perf_counter()
        admin = plat.create_project(plat.admin_token, "smoke")
        eng = plat.engine(admin)
        live.append(eng)
        return plat, admin, eng, time.perf_counter() - t0

    def spec(name, fn, **args):
        return JobSpec(name=name, project="", user="", fn=fn, args=args,
                       resources={"vcpu": 8, "mem_mb": 8192})

    def finished(h, timeout=300):
        state = h.wait(timeout=timeout)
        if state.value != "FINISHED":
            raise AssertionError(f"{h.job_id} ({h.job.spec.name}) ended "
                                 f"{state.value}: {h.job.error}")
        return h.job

    def die(eng):
        """The engine's process dies: its store closes and its socket
        drops, and nothing is shut down."""
        eng.store.close()
        eng.launcher._disconnect()
        live.remove(eng)

    def after_step(path, step, timeout=180):
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            if path.exists() and len(path.read_text().splitlines()) > step:
                return
            time.sleep(0.05)
        raise AssertionError(f"{path} never reached step {step}")

    def own_lines(job):
        lines = job.outputs["log"].splitlines()
        tagged = [ln for ln in lines if ln.startswith("job-")]
        return tagged, all(ln.startswith(f"{job.job_id} ") for ln in tagged)

    # nvidia-smi's per-process list (--query-compute-apps) did not name the
    # worker's pid on the card's machine (it listed one process, pid 1), so
    # the worker's memory is read off the card's memory.used, beside which
    # this process holds still through the phase
    mem_before = gpu_memory_used()

    def worker_mib():
        return gpu_memory_used() - mem_before

    numbers = {"card": card, "arch": cfg.name, "train_layers": DURABLE_LAYERS,
               "requests": len(prompts), "memory_used_before_mib": mem_before}
    try:
        # -- 1. overlapping jobs in one worker ---------------------------
        t0 = time.perf_counter()
        plat, admin, eng, _ = platform()
        proj = plat.project(admin)
        probe = plat.submit_job(admin, spec("probe", CJ.probe_job))
        up_s = time.perf_counter() - t0         # the launch waited for it
        probe = finished(probe, timeout=120)
        ready_s = time.perf_counter() - t0
        pid = probe.outputs["pid"]
        pids.add(pid)
        log(f"durable: worker {pid} up in {up_s:.2f} s, CUDA and the kernel "
            f"libraries ready in {ready_s:.2f} s ({probe.outputs['device']})")
        ready_mib = worker_mib()
        if not ready_mib >= 256:
            raise AssertionError(f"the card's memory.used moved {ready_mib} "
                                 f"MiB with the worker's CUDA context")
        sampler = MemorySampler()
        sampler.start()
        handles = [plat.submit_job(admin, spec(
            f"train-lr{lr}", CJ.train_job, lr=lr, steps=DURABLE_STEPS,
            **train)) for lr in PLATFORM_LRS]
        handles.append(plat.submit_job(admin, spec(
            "serve", CJ.serve_job, arch=cfg.name, prompts=prompts,
            slots=slots, buf=buf, max_new=max_new)))
        jobs = [finished(h) for h in handles]
        *trains, serve = jobs
        between = worker_mib()
        outs = [j.outputs for j in jobs]
        if not max(o["started"] for o in outs) < \
                min(o["ended"] for o in outs):
            raise AssertionError("the three jobs did not overlap: " + str(
                [(o["started"], o["ended"]) for o in outs]))
        streams = [o["stream"] for o in outs]
        if len(set(streams)) != 3 or outs[0]["default_stream"] in streams:
            raise AssertionError(f"the jobs' streams {streams} are not three "
                                 f"of their own")
        for j in jobs:
            tagged, own = own_lines(j)
            want = DURABLE_STEPS if j in trains else 1
            if not own or len(tagged) != want:
                raise AssertionError(f"{j.job_id}'s log holds other lines: "
                                     f"{tagged}")
        losses = {j.job_id: j.outputs["losses"][-1] for j in trains}
        if not all(math.isfinite(x) for j in trains
                   for x in j.outputs["losses"]):
            raise AssertionError(f"non-finite training loss: {losses}")
        best = proj.metadata.find_min("final_loss", kind="job")
        if best != min(losses, key=losses.get):
            raise AssertionError(f"find_min named {best}, final losses "
                                 f"{losses}")
        for j in trains:
            if not j.runtime >= sum(j.outputs["step_s"]):
                raise AssertionError(
                    f"{j.job_id}: engine runtime {j.runtime} s < its "
                    f"synchronized steps' {sum(j.outputs['step_s'])} s")
        out = serve.outputs
        want = {k: out["prefill_calls"] * per_call.get(k, 0)
                + out["ticks"] * per_tick.get(k, 0) for k in launch_counters()}
        if out["launches"] != want or not out["outputs_ok"]:
            raise AssertionError(f"serve job: launches {out['launches']}, "
                                 f"expected {want}; outputs ok "
                                 f"{out['outputs_ok']}")
        numbers.update({
            "worker_up_s": up_s, "spawn_to_ready_s": ready_s,
            "jobs": {j.job_id: {
                "name": j.spec.name, "runtime_s": j.runtime,
                "own_s": sum(j.outputs["step_s"]) if j in trains
                else j.outputs["serve_s"], "cpu_pricing_cost": j.cost}
                for j in jobs},
            "step_ms": {j.job_id: [1e3 * s for s in j.outputs["step_s"]]
                        for j in trains},
            "final_losses": losses, "best": best,
            "serve_ticks": out["ticks"], "serve_tokens_per_s":
                out["tokens_per_s"], "launches": out["launches"]})

        # -- 2. the engine dies, the worker runs on ----------------------
        marker = workdir / "marker-engine.txt"
        progress = workdir / "progress-engine.txt"
        h = plat.submit_job(admin, spec(
            "train-engine-death", CJ.train_job, lr=PLATFORM_LRS[0],
            steps=DURABLE_RECOVER_STEPS, progress=str(progress),
            marker=str(marker), **train))
        jid = h.job_id
        after_step(progress, 2)
        die(eng)
        del plat, eng
        plat2, admin2, eng2, recover_s = platform()
        rep2 = eng2.recovery
        if (rep2.adopted, rep2.requeued) != (1, 0):
            raise AssertionError(f"after the engine's death: {rep2}")
        job = finished(JobHandle(eng2.registry.get(jid), eng2))
        if job.epoch != 0 or marker.read_text().splitlines() != \
                [f"{jid} 0"]:
            raise AssertionError(f"{jid} settled at epoch {job.epoch}, "
                                 f"marker {marker.read_text()!r}")
        first_loss = job.outputs["losses"][0]
        numbers["engine_death"] = {
            "recovery_s": recover_s, "report": dataclasses.asdict(rep2),
            "runtime_s": job.runtime, "own_s": sum(job.outputs["step_s"]),
            "step_ms": [1e3 * s for s in job.outputs["step_s"]]}

        # -- 3. the worker dies too ---------------------------------------
        marker = workdir / "marker-worker.txt"
        progress = workdir / "progress-worker.txt"
        h = plat2.submit_job(admin2, spec(
            "train-worker-death", CJ.train_job, lr=PLATFORM_LRS[0],
            steps=DURABLE_RECOVER_STEPS, progress=str(progress),
            marker=str(marker), **train))
        jid = h.job_id
        after_step(progress, 2)
        victim = json.loads((eng2.launcher.dir / "worker.json")
                            .read_text())["pid"]
        held = worker_mib()
        os.kill(victim, signal.SIGKILL)
        t_kill = time.perf_counter()
        die(eng2)
        del plat2, eng2
        while worker_mib() > MEMORY_RETURN_BYTES / 2**20:
            if time.perf_counter() - t_kill > 10:
                raise AssertionError(f"the card still holds {worker_mib()} "
                                     f"MiB of the killed worker {victim} "
                                     f"after 10 s ({held} MiB before)")
            time.sleep(0.1)
        freed_s = time.perf_counter() - t_kill
        _reap(victim, 10)
        plat3, admin3, eng3, recover3_s = platform()
        rep3 = eng3.recovery
        if (rep3.requeued, rep3.adopted) != (1, 0):
            raise AssertionError(f"after the worker's death: {rep3}")
        job = finished(JobHandle(eng3.registry.get(jid), eng3))
        if job.epoch != 1 or marker.read_text().splitlines() != \
                [f"{jid} 1"]:
            raise AssertionError(f"{jid} settled at epoch {job.epoch}, "
                                 f"marker {marker.read_text()!r}")
        rerun_loss = job.outputs["losses"][0]
        if not abs(rerun_loss - first_loss) <= 1e-6 * abs(first_loss):
            raise AssertionError(f"the re-run's first loss {rerun_loss} is "
                                 f"not step 2's {first_loss}")
        pid3 = job.outputs["pid"]
        pids.update((victim, pid3))
        before_shutdown = worker_mib()
        numbers["worker_death"] = {
            "killed_pid": victim, "killed_held_mib": held,
            "kill_to_free_s": freed_s, "recovery_s": recover3_s,
            "report": dataclasses.asdict(rep3), "runtime_s": job.runtime,
            "own_s": sum(job.outputs["step_s"]),
            "step_ms": [1e3 * s for s in job.outputs["step_s"]],
            "first_loss": first_loss, "rerun_first_loss": rerun_loss}

        # -- 4. shutdown --------------------------------------------------
        t0 = time.perf_counter()
        eng3.launcher.shutdown()
        live.remove(eng3)
        gone = {p: _reap(p, 30) for p in pids}
        if not all(gone.values()):
            raise AssertionError(f"workers still alive 30 s after the "
                                 f"shutdown: {gone}")
        shutdown_s = time.perf_counter() - t0
        mem_after = gpu_memory_used()
        if not mem_after - mem_before <= MEMORY_RETURN_BYTES / 2**20:
            raise AssertionError(f"the card's memory.used is {mem_after} MiB "
                                 f"after the phase, {mem_before} MiB before")
        numbers.update({
            "worker_used_mib": {"ready": ready_mib,
                                "peak": sampler.peak - mem_before,
                                "between_jobs": between,
                                "before_shutdown": before_shutdown},
            "shutdown_s": shutdown_s, "memory_used_after_mib": mem_after,
            "worker_pids": sorted(pids)})
        return numbers
    finally:
        if sampler is not None:
            sampler.stop.set()
        for eng in live:
            eng.launcher.shutdown()
        shutil.rmtree(workdir, ignore_errors=True)


class RssSampler(threading.Thread):
    """The process's resident set size (``VmRSS``) every 50 ms while it
    runs: the first reading and the largest."""

    def __init__(self):
        super().__init__(daemon=True)
        self.stop = threading.Event()
        self.first = self.peak = self.read()

    @staticmethod
    def read() -> int:
        for line in Path("/proc/self/status").read_text().splitlines():
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
        raise RuntimeError("no VmRSS line in /proc/self/status")

    def run(self):
        while not self.stop.wait(0.05):
            self.peak = max(self.peak, self.read())


def _bits_equal(a, b) -> bool:
    """Same dtype, shape and bits (NaN and -0.0 included)."""
    import torch
    if (a.dtype, a.shape) != (b.dtype, b.shape):
        return False
    if not a.numel():
        return True
    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


def profile_train_step(fn, wall_s, scan=None) -> dict:
    """One call of fn under torch.profiler: device time by the op that
    launched each kernel (``aten::mm``, ``aten::bmm``, the rest), kernels
    per step and the kernels that take the most time. With ``scan``, the
    name of a record_function in the model, the kernels of the ops under it
    (the scan's forward and its remat recompute) and of the backward nodes
    of those ops count as ``scan_ms`` and under no other op."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = _kernel_rows(prof, 1)
    if not kernels:
        return {"device_ms": "not measured"}
    total = sum(us for us, _, _ in kernels) / 1e3
    split = _device_ms_by_op(prof, scan)
    out = {
        "device_ms": total, "wall_ms_unprofiled": 1e3 * wall_s,
        "device_busy_share": total / (1e3 * wall_s),
        "matmul_ms": split["mm"], "attention_einsum_ms": split["bmm"],
        "other_ms": total - split["mm"] - split["bmm"] - split["scan"],
        "kernels": sum(n for _, n, _ in kernels),
        "top": [{"kernel": k[:60], "ms": us / 1e3, "count": n}
                for us, n, k in kernels[:8]],
    }
    if scan:
        out["scan"], out["scan_ms"] = scan, split["scan"]
    return out


def _device_ms_by_op(prof, scan=None) -> dict:
    """Device ms of a profile's kernels by the CPU op that launched them:
    "scan" (under the record_function ``scan``, or under the backward node
    of an op that ran under it, matched by sequence number and forward
    thread), else "mm" under ``aten::mm``, "bmm" under ``aten::bmm``, and
    "rest"."""
    from torch.autograd import DeviceType

    def chain(e):
        while e is not None:
            yield e
            e = e.cpu_parent

    events = prof.events()
    seqs = {(e.sequence_nr, e.thread) for e in events
            if scan and e.sequence_nr >= 0
            and any(a.name == scan for a in chain(e))}
    out = dict.fromkeys(("scan", "mm", "bmm", "rest"), 0.0)
    for e in events:     # an annotation's own "kernel" is its device span
        if e.device_type != DeviceType.CPU or not e.kernels \
                or e.is_user_annotation:
            continue
        names = [a.name for a in chain(e)]
        node = next((a for a in chain(e) if a.scope == 1), None)  # backward
        if scan and (scan in names or node is not None and (
                node.sequence_nr, node.fwd_thread) in seqs):
            key = "scan"
        elif "aten::mm" in names:
            key = "mm"
        elif "aten::bmm" in names:
            key = "bmm"
        else:
            key = "rest"
        out[key] += sum(k.duration for k in e.kernels) / 1e3
    return out


def profile_ticks(cfg, params, card, slots, buf, ticks: int = 20,
                  vision=None) -> dict:
    """Where a decode tick's time goes, at the slice's shape (all slots at
    position buf / 2; the VLM's vision K/V from ``vision``): host wall per
    tick without the profiler, device kernel time per tick and kernels per
    tick under torch.profiler, and the kernels that take the most device
    time; ``profile_s``, the seconds the whole function took. Runs after
    the launch counts are read; it gates nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as T
    from repro_torch.serve import decode as D

    start = time.perf_counter()
    step = D.make_serve_step(cfg, buf)
    states = T.init_decode_state(cfg, slots, buf,
                                 device=params["embed"].device,
                                 vision=vision, params=params)
    books = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    batch = {"tokens": torch.zeros((slots, 1, *books), dtype=torch.long),
             "cache_len": torch.full((slots,), buf // 2, dtype=torch.int32)}

    def run():
        for _ in range(ticks):
            _, _, nxt = step(params, states, batch)
            nxt.cpu()                      # the driver reads every tick

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    wall_ms = 1e3 * (time.perf_counter() - t0) / ticks
    # CPU ops are recorded only where _moe_ms reads them: with them a
    # window of 8 ticks took 8-22 s of an H100 host's time
    with profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if cfg.moe is not None else [])) as prof:
        run()
    rows = _kernel_rows(prof, ticks)
    device_ms = sum(r[0] for r in rows) / 1e3
    out = {
        "arch": cfg.name, "card": card, "ticks": ticks,
        "wall_ms_per_tick": wall_ms,
        "device_ms_per_tick": device_ms if rows else "not measured",
        "device_busy_share": device_ms / wall_ms if rows else "not measured",
        "kernels_per_tick": sum(r[1] for r in rows),
        "top": [{"kernel": k[:60], "us_per_tick": us, "per_tick": n}
                for us, n, k in rows[:8]],
    }
    if cfg.moe is not None:
        out["moe_block_per_tick"] = _moe_ms(prof, ticks) if rows \
            else "not measured"
    out["profile_s"] = time.perf_counter() - start
    return out


def profile_prefill(cfg, params, card, fn) -> dict:
    """One prefill call of an MoE model under torch.profiler: its device
    ms, kernels, and its MoE blocks' device ms split as _moe_ms does. Runs
    after the launch counts are read; it gates nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = _kernel_rows(prof, 1)
    if not rows:
        return {"arch": cfg.name, "prefill": "not measured"}
    return {"arch": cfg.name, "card": card,
            "prefill_shape": [PREFILL_BATCH, PREFILL_LEN],
            "device_ms_per_prefill": sum(r[0] for r in rows) / 1e3,
            "kernels_per_prefill": sum(r[1] for r in rows),
            "moe_block_per_prefill": _moe_ms(prof, 1),
            "top": [{"kernel": k[:60], "ms": us / 1e3, "count": n}
                    for us, n, k in rows[:8]]}


def _moe_ms(prof, calls: int) -> dict:
    """Device ms per call of the kernels launched under the model's
    ``moe_block`` record_function: the expert products (``aten::bmm``),
    the rest of the block (routing, dispatch, combine, the aux loss, the
    router and shared-expert matmuls), and the block's kernels per call.
    The record_function's own device span is left out."""
    from torch.autograd import DeviceType

    def chain(e):
        while e is not None:
            yield e
            e = e.cpu_parent

    out = {"bmm_ms": 0.0, "rest_ms": 0.0, "kernels": 0}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels \
                or e.is_user_annotation:
            continue
        names = [a.name for a in chain(e)]
        if "moe_block" not in names:
            continue
        key = "bmm_ms" if "aten::bmm" in names else "rest_ms"
        out[key] += sum(k.duration for k in e.kernels) / 1e3 / calls
        out["kernels"] += len(e.kernels) / calls
    out["block_ms"] = out["bmm_ms"] + out["rest_ms"]
    return out


def _to(tree, device):
    """A copy of a nested dict of tensors on ``device``."""
    return {k: _to(v, device) if isinstance(v, dict)
            else v.to(device, copy=True) for k, v in tree.items()}


if __name__ == "__main__":
    sys.exit(main())
