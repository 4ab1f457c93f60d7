"""Job payloads that run on the card through the subprocess runner.

``SubprocessRunner`` sends a job's fn to its worker process as an importable
``module:qualname`` reference, so a job that runs in the worker cannot be a
closure: these are module-level fns in the engine's contract
``fn(workdir, job) -> dict``. A job in the worker has no handle on the
caller's project; it gets what it needs through ``job.spec.args``, and its
outputs cross back as JSON (floats and lists, no tensors).

Each imports torch inside the call, so importing this module loads nothing,
and each raises when the worker finds no CUDA device: nothing carries on on
the CPU. ``chip_smoke.py`` (phase 9) and ``tests/test_torch_card.py`` run
them.
"""
from __future__ import annotations

import os
import time
from pathlib import Path


def _card():
    """torch, with CUDA initialised in this process; raises without a card."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(f"the job worker (pid {os.getpid()}) finds no "
                           "CUDA device")
    torch.cuda.init()
    return torch


def _where(torch) -> dict:
    """This process's pid, and the CUDA stream the job runs on beside the
    default stream."""
    return {"pid": os.getpid(),
            "stream": torch.cuda.current_stream().cuda_stream,
            "default_stream": torch.cuda.default_stream().cuda_stream}


def probe_job(workdir: Path, job) -> dict:
    """Initialise CUDA in the worker and check that every kernel library
    is built already (``kernels._build``), so that no job of this worker
    compiles; raises when one is missing. A worker whose CUDA is
    initialised gives each later job a stream of its own."""
    torch = _card()
    from repro_torch.kernels import _build
    missing = [str(_build.library_path(name)) for name in _build.SOURCES
               if not _build.library_path(name).exists()]
    if missing:
        raise RuntimeError(f"kernel libraries missing in the worker: "
                           f"{missing}")
    return {"pid": os.getpid(), "device": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "libraries": len(_build.SOURCES)}


def cuda_sleep_job(workdir: Path, job) -> dict:
    """Enqueue a spin of ``args['cycles']`` clock cycles on the card and
    return without waiting for it; reports the host time of the enqueue."""
    torch = _card()
    t0 = time.perf_counter()
    torch.cuda._sleep(int(job.spec.args["cycles"]))
    return {"enqueue_ms": 1e3 * (time.perf_counter() - t0),
            **_where(torch)}


def train_job(workdir: Path, job) -> dict:
    """Train a model of ``args['arch']`` at full width and ``args['layers']``
    layers from seed 0 on the card: fp32 params, bf16 compute, remat
    "full", AdamW (``args['lr']``, warmup 2), ``args['steps']`` steps of
    ``args['batch']`` x ``args['seq']`` tokens from the synthetic pipeline
    (data vocabulary 64), each step synchronized and timed. Each step's
    line in the log starts with the job id; the last loss is printed as
    ``[[acai:final_loss=...]]``. With ``args['progress']`` each finished
    step appends ``<step> <loss>`` to that file; with ``args['marker']``
    the job appends ``<job id> <epoch>`` to that file once, at its end.
    Like ``serve_job`` it reports the wall-clock times of its start and
    end, its pid and the CUDA stream it ran on."""
    import dataclasses

    torch = _card()
    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import model as M
    from repro_torch.train import train_step as T
    from repro_torch.train.optimizer import OptimizerConfig

    started = time.time()
    a = job.spec.args
    dev = torch.device("cuda")
    cfg = get_arch(a["arch"])
    cfg = dataclasses.replace(cfg, n_layers=int(a.get("layers",
                                                      cfg.n_layers)))
    tc = T.TrainConfig(remat="full")
    step = T.make_train_step(cfg, tc, OptimizerConfig(
        lr=float(a["lr"]), warmup_steps=2, total_steps=100), device=dev)
    params = M.init_params(cfg, 0, device=dev)
    opt = T.make_opt_state(params, tc)
    pipe = TokenPipeline(DataConfig(vocab_size=64, seq_len=int(a["seq"]),
                                    global_batch=int(a["batch"]),
                                    markov_temp=2.5), cfg)
    progress = Path(a["progress"]) if a.get("progress") else None
    losses, step_s = [], []
    for i in range(int(a["steps"])):
        batch = pipe.batch_at(i)
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        print(f"{job.job_id} step {i}: loss {losses[-1]:.6f}, "
              f"{1e3 * step_s[-1]:.1f} ms")
        if progress is not None:
            with progress.open("a") as fh:
                fh.write(f"{i} {losses[-1]!r}\n")
    print(f"[[acai:final_loss={losses[-1]}]]")
    if a.get("marker"):
        with Path(a["marker"]).open("a") as fh:
            fh.write(f"{job.job_id} {job.epoch}\n")
    return {"losses": losses, "step_s": step_s, "layers": cfg.n_layers,
            "started": started, "ended": time.time(), **_where(torch)}


def serve_job(workdir: Path, job) -> dict:
    """Serve ``args['prompts']`` with a model of ``args['arch']`` at full
    width and depth in bf16 (weights from seed 0): each prompt through the
    prefill step (flash attention), then all of them through the serving
    loop (decode attention) with ``args['slots']`` slots, a buffer of
    ``args['buf']`` and ``args['max_new']`` new tokens each. Returns the
    kernels' launches over the job (this process's counters), the prefill
    calls and ticks, the serve time and whether every logit is finite and
    every token in range."""
    torch = _card()
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import wkv6 as wkv
    from repro_torch.launch import serve as L
    from repro_torch.models import model as M
    from repro_torch.serve import decode as D

    started = time.time()
    a = job.spec.args
    dev = torch.device("cuda")
    cfg = get_arch(a["arch"])
    counters = {"flash_attention": fa.flash_attention_bhsd,
                "decode_attention": dec.decode_attention_bhd,
                "wkv6": wkv.wkv6_bhsk, "mamba2_ssd": ssd.ssd_bhsp}
    params = M.cast_params(M.init_params(cfg, 0, device=dev), torch.bfloat16)
    torch.cuda.empty_cache()
    prompts = [list(map(int, p)) for p in a["prompts"]]
    before = {k: c.launches for k, c in counters.items()}
    prefill = D.make_prefill_step(cfg, device=dev)
    pre = [prefill(params, {"tokens": torch.tensor([p])})[0].float().cpu()
           for p in prompts]
    res = L.serve(cfg, params, prompts, slots=int(a["slots"]),
                  buf=int(a["buf"]), max_new=int(a["max_new"]), device=dev)
    launches = {k: c.launches - before[k] for k, c in counters.items()}
    ok = all(bool(torch.isfinite(t).all()) for t in pre + res.first_logits) \
        and all(len(o) == int(a["max_new"]) and 0 <= min(o)
                and max(o) < cfg.vocab_size for o in res.outputs)
    tokens_per_s = len(prompts) * int(a["max_new"]) / res.seconds
    print(f"{job.job_id} served {len(prompts)} requests in {res.ticks} "
          f"ticks")
    print(f"[[acai:tokens_per_s={tokens_per_s}]]")
    return {"launches": launches, "prefill_calls": len(prompts),
            "ticks": res.ticks, "serve_s": res.seconds, "outputs_ok": ok,
            "tokens_per_s": tokens_per_s, "started": started,
            "ended": time.time(), **_where(torch)}
