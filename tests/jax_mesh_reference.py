"""The reference's mesh results for ``tests/test_torch_mesh*.py``, in one JAX
process on 4 forced host devices (run as a script; it writes an npz):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/jax_mesh_reference.py out.npz \
            [train|moe|families|kvseq|pod|loss|dryrun ...]

(the ``pod`` part's 8-rank case, ``pod=qwen3-8b@2x2x2``, with 8 forced
devices).

Meshes are built with ``AxisType.Auto`` axes: on JAX 0.9 the default
Explicit axes make ``with_sharding_constraint`` refuse the reference's
specs (ROADMAP, reference caveats). Weights come from the reference's own
init, inputs from numpy seeds; the ranks of the port read both.

- ``train``: reduced olmo-1b and qwen3-8b (fp32, remat none) on a (2, 2)
  mesh: the loss and every gradient of ``build_sharded_train``'s specs
  (``jax.value_and_grad`` jitted with them), and the losses of 3 steps of
  ``build_sharded_train``'s step.
- ``moe``: ``moe_block`` of reduced olmoe-1b-7b, llama4-scout and
  llama4-scout with ``fuse_shared`` on (2, 2), (1, 2) and (1, 4) meshes
  (the expert-parallel branch) and with no rules (the no-mesh branch).
- ``families``: the recurrent, hybrid, VLM and audio layouts, reduced
  rwkv6-7b, zamba2-7b, llama-3.2-vision-11b and musicgen-large (fp32,
  remat none, the zero-init leaves seeded), on (2, 2), with zamba2-7b
  also on (1, 4) and qwen3-8b at 10 heads of 16 on (1, 4) (40 query
  columns a rank: a rank's columns split a head): the loss and every
  gradient, and the losses of 3 steps, as ``train``; and the four
  families' fp32 prefill jitted with ``build_cell``'s specs on (1, 2).
- ``kvseq``: decode states whose KV sequence shards over the mesh
  (``KVSEQ_CASES``): the reference's serve step jitted with
  ``decode_state_specs`` and ``batch_specs`` (and the layout's param
  specs) as ``in_shardings``, fp32, from seeded states of a KV_BUF-long
  buffer, KV_TICKS teacher-forced ticks whose writes cross a shard's
  edge; each tick's logits and the states after the ticks.
- ``pod``: meshes with a "pod" axis, ("pod", "data", "model"), and
  microbatches on a mesh (``POD_CASES``), on a POD_BATCH-row batch: the
  loss and every gradient and 3 steps' losses of ``build_sharded_train``
  as ``train`` for reduced olmo-1b and olmoe-1b-7b on (2, 2, 1) and (2, 1,
  2) and qwen3-8b on (2, 2, 2) (8 devices); 3 steps' losses at
  ``microbatches`` 2 on (2, 2) and (2, 1, 2); and the ``kvseq`` serve step
  of ``POD_SERVE_CASES`` (the KV sequence over ("pod", "data", "model"),
  the batch over ("pod", "data")).
- ``loss``: the loss over vocab shards (``LOSS_CASES``): reduced olmo-1b
  (a tied table), qwen3-8b (an untied head) and musicgen-large's
  codebook-major head at 4 codebooks (2 whole ones a rank of a model axis
  of 2) and at 3 (a rank's 384 columns split a codebook), fp32, remat
  none, on (1, 2), (2, 2) and (2, 1, 2), with ignored labels: the loss
  and every gradient, as ``train``.
- ``dryrun``: the reference's dry-run (``repro/launch/dryrun.py``) of
  ``DRYRUN_CASES`` on a (2, 2) mesh: ``build_cell``'s jitted step,
  ``.lower().compile()``, then ``roofline.analysis.analyze`` (the HLO cost
  model): per device FLOPs (and the dots' alone), fused and all-op
  bytes, collective bytes and counts by kind, and the compiled module's
  ``memory_analysis().temp_size_in_bytes``, at the small
  ``DRYRUN_SHAPES``; and the temp bytes alone of ``DRYRUN_PEAK_CASES``.
"""
import dataclasses
import sys

import numpy as np

TRAIN_ARCHS = ("olmo-1b", "qwen3-8b")
TRAIN_MESH = (2, 2)
TRAIN_STEPS = 3
BATCH, SEQ = 4, 32
MOE_CASES = ("olmoe-1b-7b", "llama4-scout-17b-a16e", "llama4-fused")
MOE_MESHES = ((2, 2), (1, 2), (1, 4))
MOE_X = (4, 16)
FAMILY_ARCHS = ("rwkv6-7b", "zamba2-7b", "llama-3.2-vision-11b",
                "musicgen-large")
# case -> (arch, mesh, config fields replaced in the reduced config)
FAMILY_CASES = {**{arch: (arch, (2, 2), {}) for arch in FAMILY_ARCHS},
                "zamba2-7b@1x4": ("zamba2-7b", (1, 4), {}),
                "qwen3-8b-10h@1x4": ("qwen3-8b", (1, 4),
                                     {"n_heads": 10, "n_kv_heads": 2})}
PREFILL_MESH = (1, 2)
# the leaves the reference initialises to zero, seeded at these scales (as
# tests/test_torch_train_recurrent.py seeds them), so that every leaf's
# gradient is non-zero; the VLM's tanh gates uniform in [0.5, 1.5]
SEEDED = {"bonus_u": 0.1, "shift_lora_b": 0.01, "decay_lora_b": 0.01,
          "conv_b_x": 0.1, "conv_b_BC": 0.1}
GATES = ("gate_attn", "gate_mlp")
# kvseq: case -> (arch, mesh, batch, serving layout, config fields). The
# KV cache's sequence shards over model (qwen3-8b's 1 kv head, the VLM's,
# qwen3-8b at 10 heads on 2 kv heads, whose 2.5 heads a rank split a head),
# over data (olmo-1b and zamba2-7b's shared block at batch 1, their heads
# over model) and over data x model (qwen3-8b at batch 1, and "resident",
# whose batch is replicated); olmo-1b on (2, 1) at batch 4 puts it on a
# model axis of 1, which splits nothing.
KVSEQ_CASES = {
    "qwen3-8b@2x2/4": ("qwen3-8b", (2, 2), 4, "fsdp", {}),
    "qwen3-8b@2x2/1": ("qwen3-8b", (2, 2), 1, "fsdp", {}),
    "olmo-1b@2x2/1": ("olmo-1b", (2, 2), 1, "fsdp", {}),
    "olmo-1b@2x1/4": ("olmo-1b", (2, 1), 4, "fsdp", {}),
    "zamba2-7b@2x2/1": ("zamba2-7b", (2, 2), 1, "fsdp", {}),
    "qwen3-8b-10h@1x4/4": ("qwen3-8b", (1, 4), 4, "fsdp",
                           {"n_heads": 10, "n_kv_heads": 2}),
    "llama-3.2-vision-11b@1x2/4": ("llama-3.2-vision-11b", (1, 2), 4,
                                   "fsdp", {}),
    "qwen3-8b-resident@2x2/4": ("qwen3-8b", (2, 2), 4, "resident", {}),
}
KV_BUF, KV_TICKS = 64, 3
# each row's cache_len at the first tick: the ticks' writes cross the edges
# of 4 shards of 16 positions (and of 2 of 32)
KV_STARTS = {4: (15, 31, 47, 61), 1: (31,)}


# pod: case -> (arch, mesh, microbatches). The batch shards over "pod" x
# "data": (2, 2, 1) holds the MoE's no-mesh branch (model 1), (2, 1, 2)
# its expert-parallel branch with capacity per pod shard, (2, 2, 2) a
# batch group that is neither one axis nor the world; the microbatch cases
# split the global batch's rows
POD_BATCH = 8
POD_CASES = {
    "olmo-1b@2x2x1": ("olmo-1b", (2, 2, 1), 1),
    "olmo-1b@2x1x2": ("olmo-1b", (2, 1, 2), 1),
    "olmoe-1b-7b@2x2x1": ("olmoe-1b-7b", (2, 2, 1), 1),
    "olmoe-1b-7b@2x1x2": ("olmoe-1b-7b", (2, 1, 2), 1),
    "qwen3-8b@2x2x2": ("qwen3-8b", (2, 2, 2), 1),
    "olmo-1b@2x2/mb2": ("olmo-1b", (2, 2), 2),
    "olmo-1b@2x1x2/mb2": ("olmo-1b", (2, 1, 2), 2),
    "olmoe-1b-7b@2x2/mb2": ("olmoe-1b-7b", (2, 2), 2),
    "olmoe-1b-7b@2x1x2/mb2": ("olmoe-1b-7b", (2, 1, 2), 2),
}
# the serve step on pod meshes, as KVSEQ_CASES: the KV sequence over
# ("pod", "data", "model") at batch 1 and under "resident", the batch over
# ("pod", "data")
POD_SERVE_CASES = {
    "qwen3-8b@2x1x2/1": ("qwen3-8b", (2, 1, 2), 1, "fsdp", {}),
    "olmo-1b@2x2x1/4": ("olmo-1b", (2, 2, 1), 4, "fsdp", {}),
    "qwen3-8b-resident@2x1x2/4": ("qwen3-8b", (2, 1, 2), 4, "resident",
                                  {}),
    "zamba2-7b@2x2x1/1": ("zamba2-7b", (2, 2, 1), 1, "fsdp", {}),
}
SERVE_CASES = {**KVSEQ_CASES, **POD_SERVE_CASES}


# loss: case -> (arch, mesh, config fields). Each config's params are the
# same on every mesh (saved once, under ``loss/ARCH_KEY/params``)
LOSS_CONFIGS = {"olmo-1b": ("olmo-1b", {}), "qwen3-8b": ("qwen3-8b", {}),
                "musicgen-large": ("musicgen-large", {}),
                "musicgen-large-3books": ("musicgen-large",
                                          {"n_codebooks": 3})}
LOSS_MESHES = ((1, 2), (2, 2), (2, 1, 2))
LOSS_CASES = {f"{key}@{'x'.join(map(str, shape))}": (key, shape)
              for key in LOSS_CONFIGS for shape in LOSS_MESHES}


def loss_config(key, get_arch):
    """The reduced config of a ``LOSS_CONFIGS`` key from ``get_arch``."""
    arch, fields = LOSS_CONFIGS[key]
    return dataclasses.replace(get_arch(arch).reduced(), **fields)


def loss_batch(cfg):
    """A seeded BATCH x SEQ batch (tokens and labels, (B, S, K) with
    codebooks) with some labels ignored (-100): a run of row 0 and, with
    codebooks, one codebook of row 1."""
    rng = np.random.default_rng(400)
    books = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    toks = rng.integers(0, cfg.vocab_size,
                        (BATCH, SEQ + 1, *books)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, 3:11] = -100
    if books:
        labels[1, :, 1] = -100
    return {"tokens": toks[:, :-1].copy(), "labels": labels}


def train_batches(cfg, steps=TRAIN_STEPS, batch=BATCH):
    """Seeded token batches (tokens, labels) of ``batch`` x SEQ."""
    out = []
    for i in range(steps):
        toks = np.random.default_rng(100 + i).integers(
            0, cfg.vocab_size, (batch, SEQ + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def family_config(case, get_arch):
    """The reduced config of a ``FAMILY_CASES`` case from ``get_arch`` (the
    reference's or the port's registry)."""
    arch, _, fields = FAMILY_CASES[case]
    return dataclasses.replace(get_arch(arch).reduced(), **fields)


def family_batches(cfg, steps=TRAIN_STEPS):
    """Seeded batches of BATCH x SEQ: tokens and labels, (B, S, K) with
    codebooks, and the VLM's vision states (B, Nv, d_src)."""
    out = []
    for i in range(steps):
        rng = np.random.default_rng(200 + i)
        books = (cfg.n_codebooks,) if cfg.n_codebooks else ()
        toks = rng.integers(0, cfg.vocab_size,
                            (BATCH, SEQ + 1, *books)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "vlm":
            batch["vision"] = rng.standard_normal(
                (BATCH, cfg.n_vision_tokens, cfg.vision_dim)).astype(
                np.float32)
        out.append(batch)
    return out


def seeded(tree, rng):
    """numpy params with the zero-init leaves of SEEDED and GATES seeded."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = seeded(val, rng)
        elif key in SEEDED:
            out[key] = (SEEDED[key] * rng.standard_normal(val.shape)).astype(
                np.float32)
        elif key in GATES:
            out[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
        else:
            out[key] = np.asarray(val)
    return out


def kvseq_config(case, get_arch):
    """The reduced config of a ``SERVE_CASES`` case from ``get_arch``."""
    arch, _, _, _, fields = SERVE_CASES[case]
    return dataclasses.replace(get_arch(arch).reduced(), **fields)


def kvseq_inputs(cfg, case):
    """Seeded tokens (B, KV_TICKS), the first tick's cache_len (B,) and,
    for the VLM, vision states (B, Nv, d_src)."""
    b = SERVE_CASES[case][2]
    rng = np.random.default_rng(300)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (b, KV_TICKS)).astype(np.int32),
           "cache_len": np.asarray(KV_STARTS[b], np.int32)}
    if cfg.family == "vlm":
        out["vision"] = rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.vision_dim)).astype(np.float32)
    return out


def bf16_rounded(tree):
    """A numpy param tree with every value rounded to bf16 (kept fp32)."""
    import jax.numpy as jnp
    return {k: bf16_rounded(v) if isinstance(v, dict) else np.asarray(
        jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))
        for k, v in tree.items()}


def moe_config(case):
    from repro.configs.base import get_arch
    if case == "llama4-fused":
        cfg = get_arch("llama4-scout-17b-a16e").reduced()
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, fuse_shared=True))
    return get_arch(case).reduced()


def moe_x(cfg):
    return np.random.default_rng(7).standard_normal(
        (*MOE_X, cfg.d_model)).astype(np.float32)


def _flat(tree, prefix):
    from repro.train.checkpoints import _flatten
    return {f"{prefix}/{k}": np.asarray(v) for k, v in _flatten(tree).items()}


def mesh_axes(shape) -> tuple:
    """("data",), ("data", "model"), or ("pod", "data", "model") for a
    3-tuple."""
    return ("pod", "data", "model") if len(shape) == 3 \
        else ("data", "model")[:len(shape)]


def _mesh(shape):
    import jax
    from jax.sharding import AxisType
    n = int(np.prod(shape))
    return jax.make_mesh(shape, mesh_axes(shape),
                         axis_types=(AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:n])


def run_train(out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs.base import get_arch
    from repro.launch.train import build_sharded_train
    from repro.models import model as M
    from repro.sharding import rules as SR
    from repro.train.optimizer import OptimizerConfig
    from repro.train.train_step import (TrainConfig, make_loss_fn,
                                        make_opt_state)

    mesh = _mesh(TRAIN_MESH)
    tcfg = TrainConfig(remat="none", compute_dtype="float32")
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=2)
    named = lambda t: jax.tree.map(lambda sp: NamedSharding(mesh, sp), t,
                                   is_leaf=lambda x: isinstance(x, P))
    for arch in TRAIN_ARCHS:
        cfg = get_arch(arch).reduced()
        params = M.init_params(cfg, jax.random.PRNGKey(0))
        out.update(_flat(params, f"train/{arch}/params"))
        batches = train_batches(cfg)
        step, pspecs = build_sharded_train(cfg, tcfg, ocfg, mesh)
        rules = SR.current_rules()
        bspecs = SR.batch_specs(cfg, "train", BATCH, rules)
        grad = jax.jit(jax.value_and_grad(make_loss_fn(cfg, tcfg),
                                          has_aux=True),
                       in_shardings=(named(pspecs), named(bspecs)))
        (_, metrics), grads = grad(
            jax.device_put(params, named(pspecs)),
            jax.device_put(jax.tree.map(jnp.asarray, batches[0]),
                           named(bspecs)))
        out[f"train/{arch}/loss"] = np.asarray(metrics["loss"])
        out.update(_flat(grads, f"train/{arch}/grad"))
        p = jax.device_put(params, named(pspecs))
        opt = make_opt_state(params, tcfg)
        losses = []
        for b in batches:
            p, opt, m = step(p, opt, jax.tree.map(jnp.asarray, b))
            losses.append(float(m["loss"]))
        out[f"train/{arch}/steps"] = np.asarray(losses, np.float64)
        SR.set_rules(None)


def run_moe(out):
    import jax
    import jax.numpy as jnp

    from repro.models import blocks as B
    from repro.sharding import rules as SR

    for case in MOE_CASES:
        cfg = moe_config(case)
        p = B.init_moe(cfg, jax.random.PRNGKey(3))
        out.update(_flat(p, f"moe/{case}/params"))
        x = jnp.asarray(moe_x(cfg))
        fn = jax.jit(lambda p, x, cfg=cfg: B.moe_block(p, x, cfg))
        SR.set_rules(None)
        y, aux = fn(p, x)
        out[f"moe/{case}/none/y"] = np.asarray(y)
        out[f"moe/{case}/none/aux"] = np.asarray(aux)
        for shape in MOE_MESHES:
            SR.set_rules(SR.AxisRules.for_mesh(_mesh(shape)))
            fn = jax.jit(lambda p, x, cfg=cfg: B.moe_block(p, x, cfg))
            y, aux = fn(p, x)
            key = f"moe/{case}/{shape[0]}x{shape[1]}"
            out[f"{key}/y"] = np.asarray(y)
            out[f"{key}/aux"] = np.asarray(aux)
        SR.set_rules(None)


def run_families(out, cases=None):
    """The ``families`` part for ``cases`` (FAMILY_CASES' keys; all of them
    by default)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs.base import get_arch
    from repro.launch.train import build_sharded_train
    from repro.models import model as M
    from repro.serve.decode import make_prefill_step
    from repro.sharding import rules as SR
    from repro.train.optimizer import OptimizerConfig
    from repro.train.train_step import (TrainConfig, make_loss_fn,
                                        make_opt_state)

    tcfg = TrainConfig(remat="none", compute_dtype="float32")
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=2)
    for case in cases or FAMILY_CASES:
        mesh = _mesh(FAMILY_CASES[case][1])
        named = lambda t, mesh=mesh: jax.tree.map(
            lambda sp: NamedSharding(mesh, sp), t,
            is_leaf=lambda x: isinstance(x, P))
        cfg = family_config(case, get_arch)
        # jitted: op by op, the init of a reduced hybrid took 16 s here
        init = jax.jit(M.init_params, static_argnums=0)
        params = seeded(jax.tree.map(np.asarray, init(
            cfg, jax.random.PRNGKey(0))), np.random.default_rng(1))
        out.update(_flat(params, f"fam/{case}/params"))
        batches = family_batches(cfg)
        step, pspecs = build_sharded_train(cfg, tcfg, ocfg, mesh)
        rules = SR.current_rules()
        bspecs = SR.batch_specs(cfg, "train", BATCH, rules)
        grad = jax.jit(jax.value_and_grad(make_loss_fn(cfg, tcfg),
                                          has_aux=True),
                       in_shardings=(named(pspecs), named(bspecs)))
        (_, metrics), grads = grad(
            jax.device_put(params, named(pspecs)),
            jax.device_put(jax.tree.map(jnp.asarray, batches[0]),
                           named(bspecs)))
        out[f"fam/{case}/loss"] = np.asarray(metrics["loss"])
        out.update(_flat(grads, f"fam/{case}/grad"))
        if case in FAMILY_ARCHS:
            p = jax.device_put(params, named(pspecs))
            opt = make_opt_state(jax.tree.map(jnp.asarray, params), tcfg)
            losses = []
            for b in batches:
                p, opt, m = step(p, opt, jax.tree.map(jnp.asarray, b))
                losses.append(float(m["loss"]))
            out[f"fam/{case}/steps"] = np.asarray(losses, np.float64)

            # the fp32 prefill on (1, 2), jitted with build_cell's specs
            pmesh = _mesh(PREFILL_MESH)
            rules = SR.AxisRules.for_mesh(pmesh)
            SR.set_rules(rules)
            pspecs = SR.param_specs(cfg, rules, fsdp=True)
            inp = {k: v for k, v in batches[0].items() if k != "labels"}
            bspecs = SR.batch_specs(cfg, "prefill", BATCH, rules)
            fn = jax.jit(make_prefill_step(cfg, compute_dtype=jnp.float32),
                         in_shardings=(named(pspecs, pmesh),
                                       named(bspecs, pmesh)))
            out[f"fam/{case}/prefill"] = np.asarray(fn(
                jax.device_put(params, named(pspecs, pmesh)),
                jax.device_put(jax.tree.map(jnp.asarray, inp),
                               named(bspecs, pmesh))))
        SR.set_rules(None)


def run_kvseq(out, cases=None):
    """The ``kvseq`` part for ``cases`` (KVSEQ_CASES' keys; all by
    default): params (bf16-rounded for "resident"), the seeded initial
    states (every leaf but the VLM's vision K/V, which the state builds
    from params and vision), each tick's logits and the states after the
    ticks, under ``kv/CASE/``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs.base import get_arch
    from repro.models import model as M
    from repro.models import transformer as RT
    from repro.serve.decode import make_serve_step
    from repro.sharding import rules as SR

    for case in cases or KVSEQ_CASES:
        _, shape, b, layout, _ = SERVE_CASES[case]
        mesh = _mesh(shape)
        named = lambda t, mesh=mesh: jax.tree.map(
            lambda sp: NamedSharding(mesh, sp), t,
            is_leaf=lambda x: isinstance(x, P))
        cfg = kvseq_config(case, get_arch)
        init = jax.jit(M.init_params, static_argnums=0)
        params = seeded(jax.tree.map(np.asarray, init(
            cfg, jax.random.PRNGKey(0))), np.random.default_rng(1))
        if layout == "resident":
            params = bf16_rounded(params)
        out.update(_flat(params, f"kv/{case}/params"))
        inp = kvseq_inputs(cfg, case)
        vision = inp.get("vision")
        states = RT.init_decode_state(
            cfg, b, KV_BUF, dtype=jnp.float32,
            vision=None if vision is None else jnp.asarray(vision),
            params=jax.tree.map(jnp.asarray, params))
        rng = np.random.default_rng(301)
        states = {key: tuple(np.asarray(t) if key == "single"
                             and cfg.family == "vlm"
                             else rng.standard_normal(t.shape).astype(
                                 np.float32) for t in part)
                  for key, part in states.items()}
        for key, part in states.items():
            for i, t in enumerate(part):
                out[f"kv/{case}/state0/{key}/{i}"] = t
        rules = SR.AxisRules.for_mesh(mesh)
        SR.set_rules(rules)
        pspecs = SR.param_specs(cfg, rules, fsdp=layout == "fsdp")
        sspecs = SR.decode_state_specs(cfg, b, rules, layout=layout)
        bspecs = SR.batch_specs(cfg, "decode", b, rules, layout=layout)
        fn = jax.jit(make_serve_step(cfg, KV_BUF,
                                     compute_dtype=jnp.float32),
                     in_shardings=(named(pspecs), named(sspecs),
                                   named(bspecs)))
        p = jax.device_put(jax.tree.map(jnp.asarray, params),
                           named(pspecs))
        logits = []
        for t in range(KV_TICKS):
            batch = {"tokens": inp["tokens"][:, t:t + 1],
                     "cache_len": inp["cache_len"] + t}
            if vision is not None:
                batch["vision"] = vision
            lg, states, _ = fn(p, jax.device_put(states, named(sspecs)),
                               jax.device_put(jax.tree.map(jnp.asarray,
                                                           batch),
                                              named(bspecs)))
            logits.append(np.asarray(lg[:, 0]))
        out[f"kv/{case}/logits"] = np.stack(logits)
        for key, part in states.items():
            for i, t in enumerate(part):
                out[f"kv/{case}/state/{key}/{i}"] = np.asarray(t)
        SR.set_rules(None)


def run_pod(out, cases=None):
    """The ``pod`` part for ``cases`` (keys of POD_CASES and
    POD_SERVE_CASES; by default all that fit the forced devices): under
    ``pod/CASE/`` the loss and every gradient (microbatches 1) and 3
    steps' losses; the serve cases as ``run_kvseq``'s, under ``kv/``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs.base import get_arch
    from repro.launch.train import build_sharded_train
    from repro.models import model as M
    from repro.sharding import rules as SR
    from repro.train.optimizer import OptimizerConfig
    from repro.train.train_step import (TrainConfig, make_loss_fn,
                                        make_opt_state)

    if cases is None:
        n = len(jax.devices())
        cases = [c for c, v in {**POD_CASES, **POD_SERVE_CASES}.items()
                 if int(np.prod(v[1])) <= n]
    run_kvseq(out, [c for c in cases if c in POD_SERVE_CASES])
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=2)
    for case in (c for c in cases if c in POD_CASES):
        arch, shape, k = POD_CASES[case]
        mesh = _mesh(shape)
        named = lambda t, mesh=mesh: jax.tree.map(
            lambda sp: NamedSharding(mesh, sp), t,
            is_leaf=lambda x: isinstance(x, P))
        tcfg = TrainConfig(remat="none", compute_dtype="float32",
                           microbatches=k)
        cfg = get_arch(arch).reduced()
        params = M.init_params(cfg, jax.random.PRNGKey(0))
        out.update(_flat(params, f"pod/{case}/params"))
        batches = train_batches(cfg, batch=POD_BATCH)
        step, pspecs = build_sharded_train(cfg, tcfg, ocfg, mesh)
        if k == 1:
            rules = SR.current_rules()
            bspecs = SR.batch_specs(cfg, "train", POD_BATCH, rules)
            grad = jax.jit(jax.value_and_grad(make_loss_fn(cfg, tcfg),
                                              has_aux=True),
                           in_shardings=(named(pspecs), named(bspecs)))
            (_, metrics), grads = grad(
                jax.device_put(params, named(pspecs)),
                jax.device_put(jax.tree.map(jnp.asarray, batches[0]),
                               named(bspecs)))
            out[f"pod/{case}/loss"] = np.asarray(metrics["loss"])
            out.update(_flat(grads, f"pod/{case}/grad"))
        p = jax.device_put(params, named(pspecs))
        opt = make_opt_state(params, tcfg)
        losses = []
        for b in batches:
            p, opt, m = step(p, opt, jax.tree.map(jnp.asarray, b))
            losses.append(float(m["loss"]))
        out[f"pod/{case}/steps"] = np.asarray(losses, np.float64)
        SR.set_rules(None)


def run_loss(out, cases=None):
    """The ``loss`` part for ``cases`` (LOSS_CASES' keys; all of them by
    default): under ``loss/CASE/`` the loss and every gradient of
    ``build_sharded_train``'s specs, as ``run_train``'s."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs.base import get_arch
    from repro.launch.train import build_sharded_train
    from repro.models import model as M
    from repro.sharding import rules as SR
    from repro.train.optimizer import OptimizerConfig
    from repro.train.train_step import TrainConfig, make_loss_fn

    tcfg = TrainConfig(remat="none", compute_dtype="float32")
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=2)
    init = jax.jit(M.init_params, static_argnums=0)
    for case in cases or LOSS_CASES:
        key, shape = LOSS_CASES[case]
        mesh = _mesh(shape)
        named = lambda t, mesh=mesh: jax.tree.map(
            lambda sp: NamedSharding(mesh, sp), t,
            is_leaf=lambda x: isinstance(x, P))
        cfg = loss_config(key, get_arch)
        params = jax.tree.map(np.asarray, init(cfg, jax.random.PRNGKey(0)))
        if f"loss/{key}/params/embed" not in out:
            out.update(_flat(params, f"loss/{key}/params"))
        _, pspecs = build_sharded_train(cfg, tcfg, ocfg, mesh)
        rules = SR.current_rules()
        bspecs = SR.batch_specs(cfg, "train", BATCH, rules)
        grad = jax.jit(jax.value_and_grad(make_loss_fn(cfg, tcfg),
                                          has_aux=True),
                       in_shardings=(named(pspecs), named(bspecs)))
        (_, metrics), grads = grad(
            jax.device_put(params, named(pspecs)),
            jax.device_put(jax.tree.map(jnp.asarray, loss_batch(cfg)),
                           named(bspecs)))
        out[f"loss/{case}/loss"] = np.asarray(metrics["loss"])
        out.update(_flat(grads, f"loss/{case}/grad"))
        SR.set_rules(None)


# dryrun: case -> (arch, DRYRUN_SHAPES key); reduced configs, (2, 2)
DRYRUN_SHAPES = {"train": (128, 8, "train"), "prefill": (128, 8, "prefill"),
                 "decode": (128, 8, "decode"), "train512": (512, 8, "train")}
DRYRUN_CASES = {"olmo-1b/train": ("olmo-1b", "train"),
                "olmo-1b/prefill": ("olmo-1b", "prefill"),
                "olmo-1b/decode": ("olmo-1b", "decode"),
                "zamba2-7b/train": ("zamba2-7b", "train")}
# cells whose compiled temp bytes alone are kept: zamba2-7b's train step
# at 512 tokens, where the shared attention block's saved activations make
# the peak (tests/test_torch_dryrun_reference.py)
DRYRUN_PEAK_CASES = {"zamba2-7b/train512": ("zamba2-7b", "train512")}
DRYRUN_MESH = (2, 2)
COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")


def dryrun_shape(name, shape_config):
    """The ``ShapeConfig`` (of either package) of a DRYRUN_SHAPES key."""
    seq_len, batch, kind = DRYRUN_SHAPES[name]
    return shape_config(f"{name}_small", seq_len, batch, kind)


def hlo_dot_flops(hlo_text):
    """The module's dot FLOPs alone, as ``hlo_cost`` counts each (2 |result|
    K), every while body times its trip count, fusions and calls walked."""
    import re

    from repro.roofline import hlo_cost as H
    comps = H.parse_module(hlo_text)

    def walk(comp, mult):
        total = 0.0
        for ins in comp.instrs:
            if ins.op == "dot":
                total += H._dot_flops(ins, comp) * mult
                continue
            m = H._TRIP_RE.search(ins.line) if ins.op == "while" else None
            body = (H._BODY_RE.search(ins.line) if ins.op == "while" else
                    H._CALLS_RE.search(ins.line) if ins.op == "fusion" else
                    re.search(r"to_apply=%?([\w.\-]+)", ins.line)
                    if ins.op == "call" else None)
            if body and body.group(1) in comps:
                total += walk(comps[body.group(1)],
                              mult * (int(m.group(1)) if m else 1))
        return total

    entry = next(line for line in hlo_text.splitlines()
                 if line.startswith("ENTRY"))
    return walk(comps[H._COMP_START_RE.match(entry.strip()).group(1)], 1)


def run_dryrun(out, cases=None):
    """The ``dryrun`` part for ``cases`` (DRYRUN_CASES' keys; all of them
    by default)."""
    import os
    # the reference's dryrun module asks for 512 host devices as it is
    # imported; this process keeps the 4 it started with
    os.environ["REPRO_DRYRUN_DEVICES"] = str(int(np.prod(DRYRUN_MESH)))
    from repro.configs.base import get_arch
    from repro.configs.shapes import ShapeConfig
    from repro.launch.dryrun import build_cell
    from repro.roofline import analysis as RA
    from repro.sharding import rules as SR
    from repro.train.train_step import TrainConfig

    mesh = _mesh(DRYRUN_MESH)
    for case in cases or DRYRUN_CASES:
        arch, shape_name = DRYRUN_CASES[case]
        cfg = get_arch(arch).reduced()
        shape = dryrun_shape(shape_name, ShapeConfig)
        fn, args = build_cell(cfg, shape, mesh, tcfg=TrainConfig())
        compiled = fn.lower(*args).compile()
        text = compiled.as_text()
        roof = RA.analyze(compiled, cfg, shape, int(np.prod(DRYRUN_MESH)),
                          hlo_text=text)
        SR.set_rules(None)
        key = f"dryrun/{case}"
        out[f"{key}/flops"] = np.float64(roof.flops_per_device)
        out[f"{key}/bytes_fused"] = np.float64(roof.bytes_per_device)
        out[f"{key}/bytes"] = np.float64(
            roof.xla_cost_analysis["bytes_all_ops_upper_bound"])
        out[f"{key}/coll_bytes"] = np.asarray(
            [roof.collectives.bytes_by_kind.get(k, 0) for k in COLL_KINDS],
            np.float64)
        out[f"{key}/coll_count"] = np.asarray(
            [roof.collectives.count_by_kind.get(k, 0) for k in COLL_KINDS],
            np.float64)
        out[f"{key}/model_flops"] = np.float64(roof.model_flops)
        out[f"{key}/dot_flops"] = np.float64(hlo_dot_flops(text))
        out[f"{key}/temp_bytes"] = np.float64(
            compiled.memory_analysis().temp_size_in_bytes)
    for case, (arch, shape_name) in DRYRUN_PEAK_CASES.items():
        fn, args = build_cell(get_arch(arch).reduced(),
                              dryrun_shape(shape_name, ShapeConfig), mesh,
                              tcfg=TrainConfig())
        out[f"dryrun/{case}/temp_bytes"] = np.float64(
            fn.lower(*args).compile().memory_analysis().temp_size_in_bytes)
        SR.set_rules(None)


def main(path, parts):
    """Each part by name; ``families=CASE,CASE`` (and ``kvseq=...``,
    ``pod=...``, ``loss=...``) runs those cases only."""
    out = {}
    for part in parts:
        name, _, cases = part.partition("=")
        if name in ("families", "kvseq", "pod", "loss", "dryrun"):
            {"families": run_families, "kvseq": run_kvseq, "pod": run_pod,
             "loss": run_loss, "dryrun": run_dryrun}[name](
                out, cases.split(",") if cases else None)
        else:
            {"train": run_train, "moe": run_moe}[name](out)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:] or ["train", "moe"])
