"""Rank bodies of the port's mesh tests (imports no JAX, so the card's
machine runs it too). Each rank is a process of its own:

    python tests/torch_mesh_ranks.py GROUP RANK WORLD STORE OUTDIR [REF]

GROUP is ``four`` (4 ranks: compressed_psum, GPipe, the sharded train step
of reduced olmo-1b and qwen3-8b on (2, 2), the MoE's expert-parallel
branch on (2, 2) and (1, 4), a save of the trained state), ``two`` (2
ranks: the MoE on (1, 2), sharded prefill and serving on (1, 2), restore
of ``four``'s save onto 2 ranks, a supervised run with a failure on (2, 1)),
``card`` (2 ranks sharing the card on gloo: the kernels at the local
heads), ``fam4`` (4 ranks: the sharded train step of the recurrent,
hybrid, VLM and audio layouts on (2, 2), zamba2-7b and qwen3-8b at 10 heads
on (1, 4), their prefill and decode there), ``fam2`` (2 ranks: the four
families' sharded prefill, the VLM's and musicgen-large's decode, on
(1, 2)), or ``kv4`` and ``kv2`` (4 and 2 ranks: the ``kvseq`` cases of
``jax_mesh_reference.KVSEQ_CASES`` on their meshes, decode states whose KV
sequence shards), ``pod4`` and ``pod8`` (4 and 8 ranks: the ``pod`` cases
of ``jax_mesh_reference.POD_CASES`` and ``POD_SERVE_CASES``, meshes with a
"pod" axis and microbatches on a mesh, and the per-layer FSDP gathers of a
(2, 2) train step and serve tick), ``card_pod`` (2 ranks sharing the
card: the per-layer FSDP step on (2, 1), a tick on (2, 1, 1)), or
``loss4`` and ``loss2`` (4 and 2 ranks: the ``loss`` cases of
``jax_mesh_reference.LOSS_CASES`` on their meshes, the loss over vocab
shards), or ``card_loss`` (2 ranks sharing the card: the loss over vocab
shards on (1, 2) against the gathered path and one device). ``two`` and
``four`` also run the serving driver at
slot counts whose caches shard their sequence (olmo-1b on (2, 1) at 4
and 1 slots, zamba2-7b on (2, 2) at 1). Ranks meet through a FileStore at
STORE; REF is the npz of ``tests/jax_mesh_reference.py``. Rank 0 writes
OUTDIR/GROUP.npz and OUTDIR/GROUP.json, which the tests read.
"""
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import jax_mesh_reference as JR   # numpy only at import: the seeds, sizes

from repro_torch import convert
from repro_torch.configs.base import get_arch
from repro_torch.core.acai import AcaiProject
from repro_torch.core.engine.lifecycle import JobPreempted
from repro_torch.launch import mesh as LM
from repro_torch.launch import serve as L
from repro_torch.models import blocks as B
from repro_torch.models import model as M
from repro_torch.serve import decode as D
from repro_torch.sharding import rules as SR
from repro_torch.sharding import spmd as S
from repro_torch.train import compression as C
from repro_torch.train import pipeline as PP
from repro_torch.train import train_step as TS
from repro_torch.train.checkpoints import CheckpointManager
from repro_torch.train.fault import TrainSupervisor
from repro_torch.train.optimizer import OptimizerConfig

TCFG = TS.TrainConfig(remat="none", compute_dtype="float32")
OCFG = OptimizerConfig(lr=1e-3, warmup_steps=2)
GPIPE = (4, 8, 16, 12)          # stages, microbatches, batch, width
PSUM_SHAPE = (5, 7)


def spawn(group: str, world: int, outdir: Path, ref_path=None,
          timeout: float = 300) -> tuple:
    """Run ``world`` ranks of ``group`` as processes of this script, each
    logging to OUTDIR/GROUP.RANK.log, within ``timeout`` s (then killed);
    (npz, meta) of rank 0. Raises with the logs' tails if a rank failed."""
    here = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(here.parent / "src"))
    env.setdefault("OMP_NUM_THREADS", "1")
    store = outdir / f"{group}.store"
    logs = [open(outdir / f"{group}.{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(here / "torch_mesh_ranks.py"), group, str(r),
         str(world), str(store), str(outdir)]
        + ([str(ref_path)] if ref_path else []),
        env=env, stdout=log, stderr=subprocess.STDOUT)
        for r, log in enumerate(logs)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if any(p.returncode for p in procs):
        raise AssertionError("\n".join(
            (outdir / f"{group}.{r}.log").read_text()[-3000:]
            for r in range(world)))
    return (np.load(outdir / f"{group}.npz"),
            json.loads((outdir / f"{group}.json").read_text()))


def unflatten(flat: dict) -> dict:
    out = {}
    for key, val in flat.items():
        node = out
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = val
    return out


def ref_tree(ref, prefix: str) -> dict:
    n = len(prefix) + 1
    return unflatten({k[n:]: ref[k] for k in ref.files
                      if k.startswith(prefix + "/")})


def full_np(t) -> np.ndarray:
    return S.full_tensor(t).detach().cpu().float().numpy()


def shapes_of(tree) -> dict:
    return {k: list(v.to_local().shape) if hasattr(v, "to_local")
            else list(v.shape) for k, v in convert.flatten(tree).items()}


def gathered(obj):
    """Every rank's ``obj``, in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def project(rank: int, root: Path):
    """The lake at root, rank 0's (the others keep none)."""
    return AcaiProject("mesh", root) if rank == 0 else None


def moe_case(ref, case, mesh, shape, out, meta):
    """The MoE block on ``mesh`` (None: the no-mesh branch) from the
    reference's weights and x; the global y and aux to ``out``."""
    cfg = JR.moe_config(case)
    p = convert.from_numpy(ref_tree(ref, f"moe/{case}/params"))
    x = torch.from_numpy(JR.moe_x(cfg))
    key = f"moe/{case}/{'none' if mesh is None else f'{shape[0]}x{shape[1]}'}"
    if mesh is None:
        y, aux = B.moe_block(p, x, cfg)
    else:
        rules = SR.AxisRules.for_mesh(mesh)
        tp = "model"
        specs = SR._walk(p, lambda path, t: SR._leaf_spec(
            ("moe", *path), t.dim(), cfg, tp))
        local = S.map_tree(lambda t, s: S.shard_of(t, s, mesh), p, specs)
        mc = S.MeshCtx(mesh, SR.batch_axis(rules, x.shape[0]) is not None)
        y, aux = B.moe_block(local, S.dp_rows(x, mc), cfg, mesh=mc)
        if mc.shards_batch:
            y = S.all_gather(y, mc.data_group, 0)
        meta.setdefault("moe_ep", {})[key] = bool(
            mc.tp > 1 and cfg.moe.n_experts % mc.tp == 0)
    out[f"{key}/y"] = y.detach().numpy()
    out[f"{key}/aux"] = aux.detach().numpy()


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------

FULL_SPECS = {"rows_data_model": (("data", "model"), None),
              "cols_data_model": (None, ("data", "model")),
              "rows_data_cols_model": ("data", "model")}


def group_four(rank, world, dev, ref, outdir, out, meta):
    mesh22 = LM.make_mesh((2, 2), ("data", "model"), device_type="cpu")
    mesh14 = LM.make_mesh((1, 4), ("data", "model"), device_type="cpu")

    # compressed_psum: every rank's result, for the tests
    x = np.random.default_rng(rank).standard_normal(PSUM_SHAPE).astype(
        np.float32) * (rank + 1)
    for kind in ("bf16", "int8"):
        y = C.compressed_psum(torch.from_numpy(x), dist.group.WORLD, kind)
        out[f"psum/{kind}"] = S.all_gather(y[None], dist.group.WORLD,
                                           0).numpy()

    # GPipe: 4 stages, this rank's stage of the stacked params
    n_st, n_mb, b, w = GPIPE
    rng = np.random.default_rng(11)
    stacked = {"w": torch.from_numpy((rng.standard_normal(
        (n_st, w, w)) / np.sqrt(w)).astype(np.float32)),
        "b": torch.from_numpy(rng.standard_normal((n_st, w)).astype(
            np.float32))}
    xb = torch.from_numpy(rng.standard_normal((b, w)).astype(np.float32))
    mine = {k: v[rank:rank + 1] for k, v in stacked.items()}
    y = PP.pipeline_apply(lambda p, a: torch.tanh(a @ p["w"] + p["b"]),
                          mine, xb, group=dist.group.WORLD,
                          n_microbatches=n_mb)
    out["gpipe/y"] = S.all_gather(y[None], dist.group.WORLD, 0).numpy()

    # a global tensor under specs that shard one dim over both axes: this
    # rank's shard, full_tensor's gather and DTensor's own
    full = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    for name, spec in FULL_SPECS.items():
        dt = S.distribute({"x": full}, {"x": spec}, mesh22)["x"]
        for key, t in (("local", dt.to_local()), ("ours", S.full_tensor(dt)),
                       ("dtensor", dt.full_tensor())):
            out[f"full/{name}/{key}"] = S.all_gather(
                t[None], dist.group.WORLD, 0).numpy()

    # the sharded train step on (2, 2)
    for arch in JR.TRAIN_ARCHS:
        cfg = get_arch(arch).reduced()
        params = convert.from_numpy(ref_tree(ref, f"train/{arch}/params"))
        batches = JR.train_batches(cfg)
        _, pspecs, ospecs = TS.sharded_specs(cfg, mesh22)
        dp, opt = TS.shard_train_state(params, TCFG, pspecs, ospecs, mesh22)
        metrics, grads, _ = TS.make_sharded_grad_fn(
            cfg, TCFG, mesh22, device="cpu")(dp, batches[0])
        out[f"train/{arch}/loss"] = metrics["loss"].numpy()
        flat_p, flat_s = convert.flatten(params), convert.flatten(pspecs)
        for k, g in convert.flatten(grads).items():
            out[f"train/{arch}/grad/{k}"] = full_np(
                S.from_local(g, flat_s[k], mesh22, flat_p[k].shape))
        meta.setdefault("shapes", {})[arch] = gathered(
            {"params": shapes_of(dp), "mu": shapes_of(opt["mu"]),
             "coord": mesh22.get_coordinate()})
        step = TS.make_sharded_train_step(cfg, TCFG, OCFG, mesh22,
                                          device="cpu")
        losses = []
        for batch in batches:
            dp, opt, m = step(dp, opt, batch)
            losses.append(float(m["loss"]))
        out[f"train/{arch}/steps"] = np.asarray(losses)
        if rank == 0:       # the port's own one-device step
            _, m1, g1 = TS.make_grad_fn(cfg, TCFG, device="cpu")(
                params, {k: torch.as_tensor(v) for k, v in
                         batches[0].items()})
            out[f"one/{arch}/loss"] = m1["loss"].numpy()
            for k, g in convert.flatten(g1).items():
                out[f"one/{arch}/grad/{k}"] = g.numpy()
            step1 = TS.make_train_step(cfg, TCFG, OCFG, device="cpu")
            p1 = convert.from_numpy(ref_tree(ref, f"train/{arch}/params"))
            o1 = TS.make_opt_state(p1, TCFG)
            losses1 = []
            for batch in batches:
                p1, o1, m = step1(p1, o1, batch)
                losses1.append(float(m["loss"]))
            out[f"one/{arch}/steps"] = np.asarray(losses1)
        if arch == "olmo-1b":   # saved on 4 ranks, restored by ``two``
            ckpt = CheckpointManager(project(rank, outdir / "lake"), "mesh",
                                     mesh=mesh22)
            ckpt.save(3, dp, opt)
            for k, t in convert.flatten({"params": dp, "opt": opt}).items():
                out[f"saved/{k}"] = full_np(t)

    for case in JR.MOE_CASES:
        for shape, mesh in (((2, 2), mesh22), ((1, 4), mesh14)):
            moe_case(ref, case, mesh, shape, out, meta)
        if rank == 0:
            moe_case(ref, case, None, None, out, meta)
    for key, (arch, shape, slots, layout) in DRIVER_CASES.items():
        if shape == (2, 2):
            driver_case(key, arch, mesh22, slots, layout, dev, out)


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

SERVE_ARCHS = ("olmo-1b", "olmoe-1b-7b", "rwkv6-7b", "zamba2-7b")
SERVE_B, SERVE_S, SERVE_BUF = 2, 24, 32


def driver_case(key, arch, mesh, slots, layout, dev, out):
    """The serving driver on ``mesh`` with ``slots`` slots under the
    serving ``layout`` (fp32), and the one-device port's on rank 0: its
    tokens to ``out`` under ``serve/KEY/{mesh,one}/tokens``."""
    cfg = get_arch(arch).reduced()
    params = M.init_params(cfg, 0, device=dev)
    dparams = S.distribute(params, TS.sharded_specs(
        cfg, mesh, fsdp=layout == "fsdp")[1], mesh)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, 12).tolist()
    prompts = [toks[:9], toks[2:7], toks[4:11]]
    f32 = torch.float32
    runs = {"mesh": (dparams, mesh)}
    if dist.get_rank() == 0:
        runs["one"] = (params, None)
    for name, (p, m) in runs.items():
        res = L.serve(cfg, p, prompts, slots=slots, buf=SERVE_BUF,
                      max_new=4, compute_dtype=f32, device=dev, mesh=m,
                      layout=layout)
        out[f"serve/{key}/{name}/tokens"] = np.asarray(res.outputs)


# the driver at slot counts whose caches shard their sequence: key ->
# (arch, mesh, slots, serving layout); ``two`` runs the (2, 1) ones,
# ``four`` the (2, 2)
DRIVER_CASES = {"olmo-1b@2x1/4": ("olmo-1b", (2, 1), 4, "fsdp"),
                "olmo-1b@2x1/1": ("olmo-1b", (2, 1), 1, "fsdp"),
                "olmo-1b@2x1/4/resident": ("olmo-1b", (2, 1), 4, "resident"),
                "zamba2-7b@2x2/1": ("zamba2-7b", (2, 2), 1, "fsdp")}


def serve_case(arch, mesh, dev, out):
    """Sharded prefill, teacher-forced decode and the serving driver on
    ``mesh`` (fp32), and the one-device port's on rank 0."""
    cfg = get_arch(arch).reduced()
    params = M.init_params(cfg, 0, device=dev)
    _, pspecs, _ = TS.sharded_specs(cfg, mesh)
    dparams = S.distribute(params, pspecs, mesh)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_S)))
    f32 = torch.float32
    runs = {"mesh": (D.make_sharded_prefill_step(
        cfg, mesh, compute_dtype=f32, device=dev), D.make_sharded_serve_step(
        cfg, mesh, SERVE_BUF, compute_dtype=f32, device=dev),
        D.init_sharded_decode_state(cfg, mesh, SERVE_B, SERVE_BUF,
                                    dtype=f32, device=dev), dparams)}
    if dist.get_rank() == 0:
        from repro_torch.models import transformer as T
        runs["one"] = (D.make_prefill_step(cfg, compute_dtype=f32,
                                           device=dev),
                       D.make_serve_step(cfg, SERVE_BUF, compute_dtype=f32,
                                         device=dev),
                       T.init_decode_state(cfg, SERVE_B, SERVE_BUF,
                                           dtype=f32, device=dev), params)
    prompts = [toks[0, :9].tolist(), toks[1, :5].tolist(),
               toks[0, 3:10].tolist()]
    for name, (pre, step, states, p) in runs.items():
        out[f"serve/{arch}/{name}/prefill"] = pre(p, {"tokens": toks}).numpy()
        got = []
        for i in range(SERVE_S):
            cl = torch.full((SERVE_B,), i, dtype=torch.int32)
            logits, states, _ = step(p, states, {"tokens": toks[:, i:i + 1],
                                                 "cache_len": cl})
            got.append(logits[:, 0])
        out[f"serve/{arch}/{name}/decode"] = torch.stack(got, 1).numpy()
        res = L.serve(cfg, p, prompts, slots=2, buf=SERVE_BUF, max_new=4,
                      compute_dtype=f32, device=dev,
                      mesh=mesh if name == "mesh" else None)
        out[f"serve/{arch}/{name}/tokens"] = np.asarray(res.outputs)


def group_two(rank, world, dev, ref, outdir, out, meta):
    mesh12 = LM.make_mesh((1, 2), ("data", "model"), device_type="cpu")
    mesh21 = LM.make_mesh((2, 1), ("data", "model"), device_type="cpu")
    for case in JR.MOE_CASES:
        moe_case(ref, case, mesh12, (1, 2), out, meta)
    for arch in SERVE_ARCHS:
        serve_case(arch, mesh12, dev, out)
    for key, (arch, shape, slots, layout) in DRIVER_CASES.items():
        if shape == (2, 1):
            driver_case(key, arch, mesh21, slots, layout, dev, out)

    # four's save (olmo-1b after 3 steps on (2, 2)) onto 2 ranks
    cfg = get_arch("olmo-1b").reduced()
    _, pspecs, ospecs = TS.sharded_specs(cfg, mesh12)
    template = {"params": M.init_params(cfg, 0, device="cpu")}
    template["opt"] = TS.make_opt_state(template["params"], TCFG)
    ckpt = CheckpointManager(project(rank, outdir / "lake"), "mesh",
                             mesh=mesh12)
    state, step = ckpt.restore(template, mesh=mesh12,
                               specs={"params": pspecs, "opt": ospecs})
    specs = convert.flatten({"params": pspecs, "opt": ospecs})
    local = {}
    for k, t in convert.flatten(state).items():
        local[k] = t.to_local() if hasattr(t, "to_local") else t
        out[f"restored/{rank}/{k}"] = local[k].numpy()
    meta["restored"] = gathered({
        "step": step, "coord": mesh12.get_coordinate(),
        "specs": {k: list(specs.get(k, ())) for k in local},
        "shapes": {k: list(v.shape) for k, v in local.items()}})
    for r in range(1, world):       # every rank's shards, to rank 0's file
        for k in local:
            got = S.broadcast(local[k], r, dist.group.WORLD)
            if rank == 0:
                out[f"restored/{r}/{k}"] = got.numpy()

    # the step's options on (2, 1): int8 gradient compression with error
    # feedback (residuals under the param specs), and bf16 params with fp32
    # masters (under the moments' specs), against one device
    for name, tc in (("int8", TS.TrainConfig(remat="none", compute_dtype=
                                             "float32",
                                             grad_compression="int8")),
                     ("master", TS.TrainConfig(remat="none",
                                               master_weights=True))):
        full = M.init_params(cfg, 0, device="cpu")
        if tc.master_weights:
            full = M.cast_params(full, torch.bfloat16)
        _, pspecs, ospecs = TS.sharded_specs(cfg, mesh21)
        dp, opt = TS.shard_train_state(full, tc, pspecs, ospecs, mesh21)
        step = TS.make_sharded_train_step(cfg, tc, OCFG, mesh21,
                                          device="cpu")
        one = TS.make_train_step(cfg, tc, OCFG, device="cpu")
        p1 = M.init_params(cfg, 0, device="cpu")
        if tc.master_weights:
            p1 = M.cast_params(p1, torch.bfloat16)
        o1 = TS.make_opt_state(p1, tc)
        got, want = [], []
        for batch in JR.train_batches(cfg):
            dp, opt, m = step(dp, opt, batch)
            got.append(float(m["loss"]))
            p1, o1, m = one(p1, o1, batch)
            want.append(float(m["loss"]))
        out[f"options/{name}/mesh"] = np.asarray(got)
        out[f"options/{name}/one"] = np.asarray(want)

    # a supervised run on (2, 1) with a failure at step 3, and an unbroken one
    pipe_batches = [JR.train_batches(cfg, 5)[i] for i in range(5)]
    lake = project(rank, outdir / "sup")
    for run, fail_at in (("broken", 3), ("unbroken", None)):
        _, pspecs, ospecs = TS.sharded_specs(cfg, mesh21)
        dp, opt = TS.shard_train_state(M.init_params(cfg, 0, device="cpu"),
                                       TCFG, pspecs, ospecs, mesh21)
        step_fn = TS.make_sharded_train_step(cfg, TCFG, OCFG, mesh21,
                                             device="cpu")
        fired = []

        def hook(i, fail_at=fail_at, fired=fired):
            if i == fail_at and not fired:
                fired.append(i)
                raise JobPreempted(f"injected at step {i}")

        sup = TrainSupervisor(CheckpointManager(lake, run, mesh=mesh21),
                              save_every=2)
        state, report = sup.run(step_fn, {"params": dp, "opt": opt,
                                          "step": 0}, 5,
                                lambda i: pipe_batches[i], failure_hook=hook)
        meta.setdefault("supervised", {})[run] = {
            "restarts": report.restarts, "steps_run": report.steps_run,
            "final_step": report.final_step}
        for k, t in convert.flatten(state["params"]).items():
            out[f"sup/{run}/{k}"] = full_np(t)


# ---------------------------------------------------------------------------
# two ranks sharing the card
# ---------------------------------------------------------------------------

def group_card(rank, world, dev, ref, outdir, out, meta):
    import dataclasses

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    heads = {"flash": [], "decode": []}
    for name, op in (("flash", "flash_attention"),
                     ("decode", "decode_attention")):
        orig = getattr(ops, op)

        def seen(q, *a, orig=orig, name=name, **kw):
            heads[name].append(int(q.shape[2]))     # q: (B, S, H, D)
            return orig(q, *a, **kw)
        setattr(ops, op, seen)
    kernels = {"flash": fa.flash_attention_bhsd,
               "decode": dec.decode_attention_bhd}
    mesh = LM.make_mesh((1, 2), ("data", "model"), device_type="cuda")
    cfg = dataclasses.replace(get_arch("olmo-1b"), n_layers=2)
    params = M.init_params(cfg, 0, device="cpu")
    _, pspecs, _ = TS.sharded_specs(cfg, mesh)
    dparams = S.distribute(convert.from_numpy(convert.to_numpy(params),
                                              device=dev), pspecs, mesh)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 128)))
    f32 = torch.float32
    pre = D.make_sharded_prefill_step(cfg, mesh, compute_dtype=f32,
                                      device=dev)
    counts = {name: k.launches for name, k in kernels.items()}
    out["card/prefill"] = pre(dparams, {"tokens": toks}).cpu().numpy()
    step = D.make_sharded_serve_step(cfg, mesh, 16, compute_dtype=f32,
                                     device=dev)
    states = D.init_sharded_decode_state(cfg, mesh, 2, 16, dtype=f32,
                                         device=dev)
    got = []
    for i in range(8):
        logits, states, _ = step(dparams, states, {
            "tokens": toks[:, i:i + 1],
            "cache_len": torch.full((2,), i, dtype=torch.int32)})
        got.append(logits[:, 0].cpu())
    out["card/decode"] = torch.stack(got, 1).numpy()
    launches = {n: k.launches - counts[n] for n, k in kernels.items()}
    meta["card"] = gathered({"launches": launches,
                             "heads": {n: sorted(set(heads[n]))
                                       for n in ("flash", "decode")}})
    if rank == 0:       # the plain versions: the one-device port on the CPU
        cpu = torch.device("cpu")
        out["card/prefill_plain"] = D.make_prefill_step(
            cfg, compute_dtype=f32, device=cpu)(params,
                                                {"tokens": toks}).numpy()
        from repro_torch.models import transformer as T
        st1 = T.init_decode_state(cfg, 2, 16, dtype=f32, device=cpu)
        step1 = D.make_serve_step(cfg, 16, compute_dtype=f32, device=cpu)
        plain = []
        for i in range(8):
            logits, st1, _ = step1(params, st1, {
                "tokens": toks[:, i:i + 1],
                "cache_len": torch.full((2,), i, dtype=torch.int32)})
            plain.append(logits[:, 0])
        out["card/decode_plain"] = torch.stack(plain, 1).numpy()


CARD_KV_BUF, CARD_KV_TICKS = 64, 40


def group_card_kv(rank, world, dev, ref, outdir, out, meta):
    """Two ranks on the card, (1, 2), fp32: reduced qwen3-8b (2 layers)
    has one kv head, which a model axis of 2 does not divide, so its KV
    sequence shards over model and each rank gathers q to every head
    (``blocks._all_q``). CARD_KV_TICKS teacher-forced ticks from an empty
    cache, whose writes cross the ranks' edge at half the buffer; each
    decode launch's heads, positions and ``return_lse``; rank 0 also the
    one-device plain version on the CPU."""
    import dataclasses

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ops
    seen = []
    orig = ops.decode_attention

    def watch(q, kc, *a, **kw):
        seen.append([int(q.shape[2]), int(kc.shape[1]),
                     bool(kw.get("return_lse"))])
        return orig(q, kc, *a, **kw)
    ops.decode_attention = watch
    mesh = LM.make_mesh((1, 2), ("data", "model"), device_type="cuda")
    cfg = dataclasses.replace(get_arch("qwen3-8b").reduced(), n_layers=2)
    params = M.init_params(cfg, 0, device="cpu")
    dparams = S.distribute(convert.from_numpy(convert.to_numpy(params),
                                              device=dev),
                           TS.sharded_specs(cfg, mesh)[1], mesh)
    b, f32 = 4, torch.float32
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (b, CARD_KV_TICKS)))
    step = D.make_sharded_serve_step(cfg, mesh, CARD_KV_BUF,
                                     compute_dtype=f32, device=dev)
    states = D.init_sharded_decode_state(cfg, mesh, b, CARD_KV_BUF,
                                         dtype=f32, device=dev)
    before = dec.decode_attention_bhd.launches
    got = []
    for i in range(CARD_KV_TICKS):
        logits, states, _ = step(dparams, states, {
            "tokens": toks[:, i:i + 1],
            "cache_len": torch.full((b,), i, dtype=torch.int32)})
        got.append(logits[:, 0].cpu())
    ops.decode_attention = orig
    out["card_kv/decode"] = torch.stack(got, 1).numpy()
    meta["card_kv"] = gathered({
        "launches": dec.decode_attention_bhd.launches - before,
        "calls": sorted({tuple(c) for c in seen}),
        "kv_spec": list(S.spec_of(states["layers"][0])),
        "n_heads": cfg.n_heads, "layers": cfg.n_layers})
    if rank == 0:       # the plain version: the one-device port on the CPU
        from repro_torch.models import transformer as T
        cpu = torch.device("cpu")
        st1 = T.init_decode_state(cfg, b, CARD_KV_BUF, dtype=f32, device=cpu)
        step1 = D.make_serve_step(cfg, CARD_KV_BUF, compute_dtype=f32,
                                  device=cpu)
        plain = []
        for i in range(CARD_KV_TICKS):
            logits, st1, _ = step1(params, st1, {
                "tokens": toks[:, i:i + 1],
                "cache_len": torch.full((b,), i, dtype=torch.int32)})
            plain.append(logits[:, 0])
        out["card_kv/decode_plain"] = torch.stack(plain, 1).numpy()


# ---------------------------------------------------------------------------
# the recurrent, hybrid, VLM and audio layouts (tests/test_torch_mesh_families)
# ---------------------------------------------------------------------------

def family_train(case, mesh, dev, ref, out, meta):
    """The sharded loss and gradients of a ``FAMILY_CASES`` case from the
    reference's params and batch, on ``mesh``; for the four families also
    3 steps and every rank's local shapes."""
    cfg = JR.family_config(case, get_arch)
    params = convert.from_numpy(ref_tree(ref, f"fam/{case}/params"))
    batches = JR.family_batches(cfg)
    _, pspecs, ospecs = TS.sharded_specs(cfg, mesh)
    dp, opt = TS.shard_train_state(params, TCFG, pspecs, ospecs, mesh)
    metrics, grads, _ = TS.make_sharded_grad_fn(cfg, TCFG, mesh,
                                                device=dev)(dp, batches[0])
    out[f"fam/{case}/loss"] = metrics["loss"].numpy()
    flat_p, flat_s = convert.flatten(params), convert.flatten(pspecs)
    for k, g in convert.flatten(grads).items():
        out[f"fam/{case}/grad/{k}"] = full_np(
            S.from_local(g, flat_s[k], mesh, flat_p[k].shape))
    if case not in JR.FAMILY_ARCHS:
        return
    meta.setdefault("shapes", {})[case] = gathered(
        {"params": shapes_of(dp), "mu": shapes_of(opt["mu"]),
         "coord": mesh.get_coordinate()})
    step = TS.make_sharded_train_step(cfg, TCFG, OCFG, mesh, device=dev)
    losses = []
    for batch in batches:
        dp, opt, m = step(dp, opt, batch)
        losses.append(float(m["loss"]))
    out[f"fam/{case}/steps"] = np.asarray(losses)


DECODE_B, DECODE_S = 2, 12


@contextlib.contextmanager
def heads_seen():
    """{kernel wrapper: the sorted head counts its calls saw}, filled while
    the block runs (the wrappers' plain versions on the CPU)."""
    from repro_torch.kernels import ops
    seen, origs = {}, {}
    for name in ("flash_attention", "decode_attention", "wkv6",
                 "mamba2_ssd"):
        orig = origs[name] = getattr(ops, name)

        def wrapped(q, *a, orig=orig, name=name, **kw):
            heads = int(q.shape[2])                    # (B, S, H, D)
            if heads not in seen.setdefault(name, []):
                seen[name] = sorted(seen[name] + [heads])
            return orig(q, *a, **kw)
        setattr(ops, name, wrapped)
    try:
        yield seen
    finally:
        for name, orig in origs.items():
            setattr(ops, name, orig)


def family_serving(key, cfg, params, mesh, dev, out, meta, decode=True):
    """A sharded fp32 prefill of DECODE_B x DECODE_S tokens (with the VLM's
    vision states, musicgen-large's (B, S, K) frames) and, with ``decode``,
    teacher-forced decode over every position, on ``mesh``; the one-device
    port's on rank 0. The kernels' launches (their plain versions on the CPU) report the
    heads each call saw."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    rng = np.random.default_rng(8)
    books = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (DECODE_B, DECODE_S, *books)))
    vision = None
    if cfg.family == "vlm":
        vision = torch.from_numpy(rng.standard_normal(
            (DECODE_B, cfg.n_vision_tokens, cfg.vision_dim)).astype(
            np.float32))
    inp = {"tokens": toks} if vision is None else {"tokens": toks,
                                                   "vision": vision}
    f32 = torch.float32
    _, pspecs, _ = TS.sharded_specs(cfg, mesh)
    dparams = S.distribute(params, pspecs, mesh)
    runs = {"mesh": (D.make_sharded_prefill_step(
        cfg, mesh, compute_dtype=f32, device=dev),
        D.make_sharded_serve_step(cfg, mesh, DECODE_S, compute_dtype=f32,
                                  device=dev),
        lambda: D.init_sharded_decode_state(
            cfg, mesh, DECODE_B, DECODE_S, dtype=f32, device=dev,
            vision=vision, params=dparams), dparams)}
    if dist.get_rank() == 0:
        runs["one"] = (D.make_prefill_step(cfg, compute_dtype=f32,
                                           device=dev),
                       D.make_serve_step(cfg, DECODE_S, compute_dtype=f32,
                                         device=dev),
                       lambda: T.init_decode_state(
                           cfg, DECODE_B, DECODE_S, dtype=f32, device=dev,
                           vision=vision, params=params), params)
    for name, (pre, step, init, p) in runs.items():
        with heads_seen() as heads:
            out[f"serve/{key}/{name}/prefill"] = pre(p, inp).numpy()
            if decode:
                states, got = init(), []
                for i in range(DECODE_S):
                    cl = torch.full((DECODE_B,), i, dtype=torch.int32)
                    logits, states, _ = step(p, states, {
                        **inp, "tokens": toks[:, i:i + 1], "cache_len": cl})
                    got.append(logits[:, 0])
                out[f"serve/{key}/{name}/decode"] = torch.stack(
                    got, 1).numpy()
        if name == "mesh":
            meta.setdefault("heads", {})[key] = heads


def group_fam4(rank, world, dev, ref, outdir, out, meta):
    meshes = {(2, 2): LM.make_mesh((2, 2), ("data", "model"),
                                   device_type="cpu"),
              (1, 4): LM.make_mesh((1, 4), ("data", "model"),
                                   device_type="cpu")}
    for case, (_, shape, _) in JR.FAMILY_CASES.items():
        family_train(case, meshes[shape], dev, ref, out, meta)
    # the fp32 prefill where a rank's query columns split a head (its
    # decode state shards the KV sequence, ROADMAP A11b.2), and zamba2-7b's
    # prefill and decode with conv state shards of 40 channels against 32 x
    # columns a rank, both on (1, 4) against the one-device port
    for case in ("qwen3-8b-10h@1x4", "zamba2-7b@1x4"):
        cfg = JR.family_config(case, get_arch)
        family_serving(case, cfg, convert.from_numpy(ref_tree(
            ref, f"fam/{case}/params")), meshes[(1, 4)], dev, out, meta,
            decode=case.startswith("zamba"))


def group_fam2(rank, world, dev, ref, outdir, out, meta):
    import dataclasses
    mesh = LM.make_mesh((1, 2), ("data", "model"), device_type="cpu")
    for case in JR.FAMILY_ARCHS:
        cfg = JR.family_config(case, get_arch)
        params = convert.from_numpy(ref_tree(ref, f"fam/{case}/params"))
        inp = {k: torch.from_numpy(v)
               for k, v in JR.family_batches(cfg, 1)[0].items()
               if k != "labels"}
        dparams = S.distribute(params, TS.sharded_specs(cfg, mesh)[1], mesh)
        with heads_seen() as heads:
            out[f"fam/{case}/prefill"] = D.make_sharded_prefill_step(
                cfg, mesh, compute_dtype=torch.float32, device=dev)(
                dparams, inp).numpy()
        meta.setdefault("heads", {})[f"prefill/{case}"] = heads
    # teacher-forced decode of the VLM and the audio model; the VLM at 2
    # kv heads, since its reduced config's one kv head on a model axis of
    # 2 shards the KV sequence (ROADMAP A11b.2)
    for key, cfg in (
            ("llama-3.2-vision-11b", dataclasses.replace(
                JR.family_config("llama-3.2-vision-11b", get_arch),
                n_kv_heads=2)),
            ("musicgen-large", JR.family_config("musicgen-large",
                                                get_arch))):
        params = M.init_params(cfg, 0, device=dev)
        params = convert.from_numpy(JR.seeded(convert.to_numpy(params),
                                              np.random.default_rng(3)))
        family_serving(key, cfg, params, mesh, dev, out, meta)


# ---------------------------------------------------------------------------
# decode states whose KV sequence shards (tests/test_torch_mesh_kvseq.py)
# ---------------------------------------------------------------------------

def kvseq_case(case, mesh, dev, ref, out, meta):
    """The sharded serve step of a ``SERVE_CASES`` case from the
    reference's params and seeded states: each tick's logits, the states
    after the ticks (``full_tensor``), each rank's local cache shapes, the
    largest collective of a tick against one layer's cache shard (bytes,
    ``spmd.watch_collectives``), what the watch saw of a cache gathered by
    ``spmd.full_tensor`` and by DTensor's own ``full_tensor``, and the
    decode launches' cache lengths."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    cfg = JR.kvseq_config(case, get_arch)
    _, _, b, layout, _ = JR.SERVE_CASES[case]
    params = convert.from_numpy(ref_tree(ref, f"kv/{case}/params"))
    if layout == "resident":               # bf16 values: exact in bf16
        params = M.cast_params(params, torch.bfloat16)
    inp = JR.kvseq_inputs(cfg, case)
    vision = inp.get("vision")
    vision = None if vision is None else torch.from_numpy(vision)
    dparams = S.distribute(params, TS.sharded_specs(
        cfg, mesh, fsdp=layout == "fsdp")[1], mesh)
    f32 = torch.float32
    states = D.init_sharded_decode_state(cfg, mesh, b, JR.KV_BUF, dtype=f32,
                                         device=dev, vision=vision,
                                         params=dparams, layout=layout)
    specs = SR.decode_state_specs(cfg, b, SR.AxisRules.for_mesh(mesh),
                                  layout=layout)
    seeded = ref_tree(ref, f"kv/{case}/state0")
    for key, part in seeded.items():
        for i, full in part.items():
            local = states[key][int(i)].to_local()
            local.copy_(S.shard_of(torch.from_numpy(full),
                                   specs[key][int(i)], mesh))
    step = D.make_sharded_serve_step(cfg, mesh, JR.KV_BUF, compute_dtype=f32,
                                     device=dev, layout=layout)
    lens = []
    orig = ops.decode_attention

    def seen(q, kc, *a, **kw):
        lens.append(int(kc.shape[1]))                  # (B, S, KV, D)
        return orig(q, kc, *a, **kw)
    ops.decode_attention = seen
    got, moved = [], []
    try:
        for t in range(JR.KV_TICKS):
            batch = {"tokens": torch.from_numpy(inp["tokens"][:, t:t + 1]),
                     "cache_len": torch.from_numpy(inp["cache_len"] + t)}
            if vision is not None:
                batch["vision"] = vision
            with S.watch_collectives() as sizes:
                logits, states, _ = step(dparams, states, batch)
            moved.append(max(sizes, default=0))
            got.append(logits[:, 0])
    finally:
        ops.decode_attention = orig
    out[f"kv/{case}/logits"] = torch.stack(got).numpy()
    keys = T.kv_cache_keys(cfg)
    for key in keys:
        for i, t in enumerate(states[key]):
            out[f"kv/{case}/state/{key}/{i}"] = full_np(t)
    first = states[keys[0]][0]
    shard = first.to_local().shape[-4:]                  # (B, S, KV, D)
    with S.watch_collectives() as by_spmd:
        S.full_tensor(first)
    with S.watch_collectives() as by_dtensor:
        first.full_tensor()
    meta.setdefault("kvseq", {})[case] = gathered({
        "coord": mesh.get_coordinate(),
        "local": {f"{key}/{i}": list(t.to_local().shape) for key in keys
                  for i, t in enumerate(states[key])},
        "layer_shard": int(np.prod(shard)) * first.element_size(),
        "most_moved": max(moved), "cache_lens": sorted(set(lens)),
        "gathers_seen": [max(by_spmd, default=0),
                         max(by_dtensor, default=0)]})


def group_kv(rank, world, dev, ref, outdir, out, meta):
    meshes = {}
    for case, (_, shape, _, _, _) in JR.KVSEQ_CASES.items():
        if shape[0] * shape[1] != world:
            continue
        if shape not in meshes:
            meshes[shape] = LM.make_mesh(shape, ("data", "model"),
                                         device_type="cpu")
        kvseq_case(case, meshes[shape], dev, ref, out, meta)


# ---------------------------------------------------------------------------
# meshes with a "pod" axis, microbatches on a mesh, FSDP's per-layer gather
# (tests/test_torch_mesh_pod.py)
# ---------------------------------------------------------------------------

def _mesh_of(shape, device_type="cpu"):
    return LM.make_mesh(shape, JR.mesh_axes(shape), device_type=device_type)


def _full_grads(grads, params, pspecs, mesh) -> dict:
    flat_p, flat_s = convert.flatten(params), convert.flatten(pspecs)
    return {k: full_np(S.from_local(g, flat_s[k], mesh, flat_p[k].shape))
            for k, g in convert.flatten(grads).items()}


def pod_train_case(case, mesh, ref, out, meta):
    """A ``POD_CASES`` case from the reference's params and POD_BATCH-row
    batches: with microbatches 1 the loss and every gradient of the first
    batch; 3 steps' losses; with microbatches k > 1 also the first
    batch's sharded gradients beside the one-device port's (rank 0), at
    the config's own capacity for olmo-1b and, for olmoe-1b-7b, at the
    no-drop capacity without the aux loss, where the expert-parallel
    branch and one device compute the same function."""
    import dataclasses
    arch, _, k = JR.POD_CASES[case]
    tcfg = dataclasses.replace(TCFG, microbatches=k)
    cfg = get_arch(arch).reduced()
    params = convert.from_numpy(ref_tree(ref, f"pod/{case}/params"))
    batches = JR.train_batches(cfg, batch=JR.POD_BATCH)
    _, pspecs, ospecs = TS.sharded_specs(cfg, mesh)
    dp, opt = TS.shard_train_state(params, tcfg, pspecs, ospecs, mesh)
    if k == 1:
        metrics, grads, _ = TS.make_sharded_grad_fn(
            cfg, tcfg, mesh, device="cpu")(dp, batches[0])
        out[f"pod/{case}/loss"] = metrics["loss"].numpy()
        for key, g in _full_grads(grads, params, pspecs, mesh).items():
            out[f"pod/{case}/grad/{key}"] = g
    else:
        same = cfg if cfg.moe is None else dataclasses.replace(
            cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k,
                router_aux_coef=0.0))
        metrics, grads, _ = TS.make_sharded_grad_fn(
            same, tcfg, mesh, device="cpu")(dp, batches[0])
        out[f"pod/{case}/mb_loss"] = metrics["loss"].numpy()
        for key, g in _full_grads(grads, params, pspecs, mesh).items():
            out[f"pod/{case}/mb_grad/{key}"] = g
        if dist.get_rank() == 0:
            _, m1, g1 = TS.make_grad_fn(same, tcfg, device="cpu")(
                params, {n: torch.as_tensor(v)
                         for n, v in batches[0].items()})
            out[f"pod/{case}/one_loss"] = m1["loss"].numpy()
            for key, g in convert.flatten(g1).items():
                out[f"pod/{case}/one_grad/{key}"] = g.numpy()
    step = TS.make_sharded_train_step(cfg, tcfg, OCFG, mesh, device="cpu")
    losses = []
    for batch in batches:
        dp, opt, m = step(dp, opt, batch)
        losses.append(float(m["loss"]))
    out[f"pod/{case}/steps"] = np.asarray(losses)
    meta.setdefault("pod_shapes", {})[case] = gathered(
        {"params": shapes_of(dp), "mu": shapes_of(opt["mu"]),
         "coord": mesh.get_coordinate()})


@contextlib.contextmanager
def param_gathers():
    """A list that gets, for each FSDP gather while the block runs, the
    gathered leaf's shape and whether autograd records it."""
    seen, orig = [], S.fsdp_gather

    def watch(x, dim, mc):
        y = orig(x, dim, mc)
        seen.append([list(y.shape), torch.is_grad_enabled()])
        return y
    S.fsdp_gather = watch
    try:
        yield seen
    finally:
        S.fsdp_gather = orig


GATHER_SERVE = (4, 16)          # slots, buffer of the gather test's tick


def gather_case(mesh, dev, out, meta):
    """Reduced olmo-1b on (2, 2): the FSDP gathers of one train step under
    each remat policy and of one serve tick, with the param shapes."""
    import dataclasses
    cfg = get_arch("olmo-1b").reduced()
    params = M.init_params(cfg, 0, device=dev)
    _, pspecs, ospecs = TS.sharded_specs(cfg, mesh)
    batch = JR.train_batches(cfg, 1, batch=JR.POD_BATCH)[0]
    res = {"shapes": {k: list(v.shape) for k, v in
                      convert.flatten(params).items()},
           "specs": {k: list(v) for k, v in
                     convert.flatten(pspecs).items()},
           "layers": cfg.n_layers}
    for remat in ("none", "full", "dots"):
        tcfg = dataclasses.replace(TCFG, remat=remat)
        dp, _ = TS.shard_train_state(params, tcfg, pspecs, ospecs, mesh)
        with param_gathers() as seen:
            TS.make_sharded_grad_fn(cfg, tcfg, mesh, device=dev)(dp, batch)
        res[f"train/{remat}"] = seen
    dp = S.distribute(params, pspecs, mesh)
    b, buf = GATHER_SERVE
    states = D.init_sharded_decode_state(cfg, mesh, b, buf,
                                         dtype=torch.float32, device=dev)
    step = D.make_sharded_serve_step(cfg, mesh, buf,
                                     compute_dtype=torch.float32, device=dev)
    with param_gathers() as seen:
        step(dp, states, {"tokens": torch.zeros((b, 1), dtype=torch.long),
                          "cache_len": torch.zeros((b,), dtype=torch.int32)})
    res["serve"] = seen
    meta["gathers"] = gathered(res)


def groups_made(fn) -> int:
    """How many process groups fn() makes on this rank."""
    made, orig = [], dist.new_group

    def count(*a, **kw):
        made.append(1)
        return orig(*a, **kw)
    dist.new_group = count
    try:
        fn()
    finally:
        dist.new_group = orig
    return len(made)


def group_pod(rank, world, dev, ref, outdir, out, meta):
    meshes = {}
    for case, (_, shape, _) in JR.POD_CASES.items():
        if int(np.prod(shape)) == world:
            mesh = meshes.setdefault(shape, _mesh_of(shape))
            pod_train_case(case, mesh, ref, out, meta)
    if world == 8:      # a new (2, 2, 2) mesh's groups, made once
        fresh = _mesh_of((2, 2, 2))
        seq = ("pod", "data", "model")
        first = groups_made(lambda: S.MeshCtx(fresh, kv_seq=seq))
        again = groups_made(lambda: [S.MeshCtx(fresh, kv_seq=kv) for kv in
                                     (seq, ("pod", "data"),
                                      ("data", "model"))])
        mc = S.MeshCtx(fresh)
        meta["groups"] = gathered({
            "first": first, "again": again, "batch_rank": mc.batch_rank,
            "batch_ranks": dist.get_process_group_ranks(mc.batch_group)})
        return
    for case, (_, shape, _, _, _) in JR.POD_SERVE_CASES.items():
        mesh = meshes.setdefault(shape, _mesh_of(shape))
        kvseq_case(case, mesh, dev, ref, out, meta)
    gather_case(meshes.setdefault((2, 2), _mesh_of((2, 2))), dev, out, meta)
    # olmo-1b's sharded prefill on (2, 2, 1), the batch over pod x data,
    # and the one-device port's on rank 0
    cfg = get_arch("olmo-1b").reduced()
    params = M.init_params(cfg, 0, device=dev)
    mesh = meshes[(2, 2, 1)]
    dparams = S.distribute(params, TS.sharded_specs(cfg, mesh)[1], mesh)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (4, SERVE_S)))
    f32 = torch.float32
    out["pod/prefill/mesh"] = D.make_sharded_prefill_step(
        cfg, mesh, compute_dtype=f32, device=dev)(dparams,
                                                   {"tokens": toks}).numpy()
    if rank == 0:
        out["pod/prefill/one"] = D.make_prefill_step(
            cfg, compute_dtype=f32, device=dev)(params,
                                                {"tokens": toks}).numpy()


CARD_POD_TICKS = 8


def group_card_pod(rank, world, dev, ref, outdir, out, meta):
    """Two ranks on the card, fp32, reduced olmo-1b: the sharded grad of a
    (2, 1) mesh (FSDP gathers one layer at a time, remat full) and the
    teacher-forced ticks of a (2, 1, 1) mesh (the batch over "pod"), and
    the one-device port's on the card on rank 0 (the launches counted per
    rank)."""
    from repro_torch.kernels import decode_attention as dec
    cfg = get_arch("olmo-1b").reduced()
    params = M.init_params(cfg, 0, device=dev)
    tcfg = TS.TrainConfig(remat="full", compute_dtype="float32")
    batch = JR.train_batches(cfg, 1, batch=JR.POD_BATCH)[0]
    mesh = _mesh_of((2, 1), "cuda")
    _, pspecs, ospecs = TS.sharded_specs(cfg, mesh)
    dp, _ = TS.shard_train_state(params, tcfg, pspecs, ospecs, mesh)
    metrics, grads, _ = TS.make_sharded_grad_fn(cfg, tcfg, mesh,
                                                device=dev)(dp, batch)
    out["card_pod/loss"] = metrics["loss"].cpu().numpy()
    for key, g in _full_grads(grads, params, pspecs, mesh).items():
        out[f"card_pod/grad/{key}"] = g
    pod = _mesh_of((2, 1, 1), "cuda")
    b, f32 = 4, torch.float32
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (b, CARD_POD_TICKS)))
    dparams = S.distribute(params, TS.sharded_specs(cfg, pod)[1], pod)
    step = D.make_sharded_serve_step(cfg, pod, CARD_POD_TICKS,
                                     compute_dtype=f32, device=dev)
    states = D.init_sharded_decode_state(cfg, pod, b, CARD_POD_TICKS,
                                         dtype=f32, device=dev)
    before = dec.decode_attention_bhd.launches
    got = []
    for i in range(CARD_POD_TICKS):
        logits, states, _ = step(dparams, states, {
            "tokens": toks[:, i:i + 1],
            "cache_len": torch.full((b,), i, dtype=torch.int32)})
        got.append(logits[:, 0].cpu())
    out["card_pod/decode"] = torch.stack(got, 1).numpy()
    meta["card_pod"] = gathered({
        "launches": dec.decode_attention_bhd.launches - before,
        "local_batch": list(S.to_local(states)["layers"][0].shape),
        "layers": cfg.n_layers})
    if rank == 0:       # the one-device port on the card
        _, m1, g1 = TS.make_grad_fn(cfg, tcfg, device=dev)(
            params, {n: torch.as_tensor(v, device=dev)
                     for n, v in batch.items()})
        out["card_pod/one_loss"] = m1["loss"].cpu().numpy()
        for key, g in convert.flatten(g1).items():
            out[f"card_pod/one_grad/{key}"] = g.cpu().numpy()
        from repro_torch.models import transformer as T
        st1 = T.init_decode_state(cfg, b, CARD_POD_TICKS, dtype=f32,
                                  device=dev)
        step1 = D.make_serve_step(cfg, CARD_POD_TICKS, compute_dtype=f32,
                                  device=dev)
        plain = []
        for i in range(CARD_POD_TICKS):
            logits, st1, _ = step1(params, st1, {
                "tokens": toks[:, i:i + 1],
                "cache_len": torch.full((b,), i, dtype=torch.int32)})
            plain.append(logits[:, 0].cpu())
        out["card_pod/decode_one"] = torch.stack(plain, 1).numpy()


# ---------------------------------------------------------------------------
# the loss over vocab shards (tests/test_torch_loss_vocab.py)
# ---------------------------------------------------------------------------

def group_loss(rank, world, dev, ref, outdir, out, meta):
    """Every ``LOSS_CASES`` case whose mesh has ``world`` ranks: the loss
    and every gradient from the reference's params and batch, as
    ``family_train``'s; and each case's largest tensor on this rank whose
    last dim is the head's whole K V (none: the logits stay sharded),
    DTensors and flat buffers left out."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Widest(TorchDispatchMode):
        def __init__(self, cols):
            super().__init__()
            self.cols, self.most = cols, 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            got = func(*args, **(kwargs or {}))
            for t in (got if isinstance(got, (tuple, list)) else (got,)):
                # plain tensors (a DTensor's shape is the global one) of
                # 2 dims or more (not a flat buffer of a collective)
                if type(t) is torch.Tensor and t.dim() > 1 \
                        and t.shape[-1] == self.cols:
                    self.most = max(self.most, t.numel() // self.cols)
            return got

    meshes = {}
    for case, (key, shape) in JR.LOSS_CASES.items():
        if int(np.prod(shape)) != world:
            continue
        mesh = meshes.get(shape) or meshes.setdefault(shape, _mesh_of(shape))
        cfg = JR.loss_config(key, get_arch)
        params = convert.from_numpy(ref_tree(ref, f"loss/{key}/params"))
        _, pspecs, ospecs = TS.sharded_specs(cfg, mesh)
        dp, _ = TS.shard_train_state(params, TCFG, pspecs, ospecs, mesh)
        batch = {k: torch.from_numpy(v)
                 for k, v in JR.loss_batch(cfg).items()}
        with Widest((cfg.n_codebooks or 1) * cfg.vocab_size) as widest:
            metrics, grads, _ = TS.make_sharded_grad_fn(
                cfg, TCFG, mesh, device=dev)(dp, batch)
        out[f"loss/{case}/loss"] = metrics["loss"].numpy()
        for k, g in _full_grads(grads, params, pspecs, mesh).items():
            out[f"loss/{case}/grad/{k}"] = g
        meta.setdefault("widest_rows", {})[case] = gathered(widest.most)


def group_card_loss(rank, world, dev, ref, outdir, out, meta):
    """Two ranks on the card, (1, 2), fp32, the ``LOSS_CONFIGS`` configs
    from ``init_params`` on the card: the sharded grad's loss over vocab
    shards and its gradients, and the gathered path's value on each rank
    (the rank's logits gathered whole over "model", then the whole
    softmax), and the one-device port's loss and gradients on rank 0."""
    mesh = _mesh_of((1, 2), "cuda")
    mc = S.MeshCtx(mesh, batch_sharded=False)
    for key in JR.LOSS_CONFIGS:
        cfg = JR.loss_config(key, get_arch)
        params = M.init_params(cfg, 0, device=dev)
        batch = {n: torch.from_numpy(v).to(dev)
                 for n, v in JR.loss_batch(cfg).items()}
        _, pspecs, ospecs = TS.sharded_specs(cfg, mesh)
        dp, _ = TS.shard_train_state(params, TCFG, pspecs, ospecs, mesh)
        metrics, grads, _ = TS.make_sharded_grad_fn(cfg, TCFG, mesh,
                                                    device=dev)(dp, batch)
        out[f"card_loss/{key}/loss"] = metrics["loss"].cpu().numpy()
        for k, g in _full_grads(grads, params, pspecs, mesh).items():
            out[f"card_loss/{key}/grad/{k}"] = g
        with torch.no_grad():
            ctx = M.make_ctx(cfg, JR.SEQ, "train", remat="none",
                             compute_dtype=torch.float32, device=dev,
                             mesh=mc)
            logits = M.forward(S.to_local(dp), batch["tokens"], cfg,
                               ctx)[0].float()
            labels = batch["labels"]
            valid = labels >= 0
            safe = torch.where(valid, labels, 0).long()
            nll = (torch.logsumexp(logits, -1) - logits.gather(
                -1, safe[..., None])[..., 0]) * valid
        meta.setdefault("card_loss", {})[key] = gathered(
            {"gathered": float(nll.sum() / valid.sum()),
             "logits_shape": list(logits.shape)})
        if rank == 0:
            _, m1, g1 = TS.make_grad_fn(cfg, TCFG, device=dev)(params, batch)
            out[f"card_loss/{key}/one_loss"] = m1["loss"].cpu().numpy()
            for k, g in convert.flatten(g1).items():
                out[f"card_loss/{key}/one_grad/{k}"] = g.cpu().numpy()


GROUPS = {"four": group_four, "two": group_two, "card": group_card,
          "card_kv": group_card_kv,
          "fam4": group_fam4, "fam2": group_fam2, "kv4": group_kv,
          "kv2": group_kv, "pod4": group_pod, "pod8": group_pod,
          "card_pod": group_card_pod, "loss4": group_loss,
          "loss2": group_loss, "card_loss": group_card_loss}


def main(argv):
    group, rank, world, store, outdir = argv[:5]
    rank, world, outdir = int(rank), int(world), Path(outdir)
    ref = np.load(argv[5]) if len(argv) > 5 else None
    torch.set_num_threads(1)
    dev = LM.init_rank(rank, world, backend="gloo",
                       device="cuda" if group.startswith("card")
                       else "cpu",
                       init_method=f"file://{store}", timeout_s=240)
    out, meta = {}, {"world": world}
    try:
        GROUPS[group](rank, world, dev, ref, outdir, out, meta)
        if rank == 0:
            np.savez(outdir / f"{group}.npz", **out)
            (outdir / f"{group}.json").write_text(json.dumps(meta))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
