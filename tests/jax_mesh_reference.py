"""The reference's mesh results for ``tests/test_torch_mesh*.py``, in one JAX
process on 4 forced host devices (run as a script; it writes an npz):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/jax_mesh_reference.py out.npz [train|moe ...]

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


def train_batches(cfg, steps=TRAIN_STEPS):
    """Seeded token batches (tokens, labels) of BATCH x SEQ."""
    out = []
    for i in range(steps):
        toks = np.random.default_rng(100 + i).integers(
            0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
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


def main(path, parts):
    out = {}
    for part in parts:
        {"train": run_train, "moe": run_moe}[part](out)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:] or ["train", "moe"])
