"""The reference's mesh results for ``tests/test_torch_mesh*.py``, in one JAX
process on 4 forced host devices (run as a script; it writes an npz):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/jax_mesh_reference.py out.npz [train|moe|families ...]

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


def train_batches(cfg, steps=TRAIN_STEPS):
    """Seeded token batches (tokens, labels) of BATCH x SEQ."""
    out = []
    for i in range(steps):
        toks = np.random.default_rng(100 + i).integers(
            0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
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


def _mesh(shape):
    import jax
    from jax.sharding import AxisType
    n = int(np.prod(shape))
    return jax.make_mesh(shape, ("data", "model")[:len(shape)],
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


def main(path, parts):
    """Each part by name; ``families=CASE,CASE`` runs those cases only."""
    out = {}
    for part in parts:
        name, _, cases = part.partition("=")
        if name == "families":
            run_families(out, cases.split(",") if cases else None)
        else:
            {"train": run_train, "moe": run_moe}[name](out)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:] or ["train", "moe"])
